"""LDBC SNB's Person-knows graph under Dgraph's `@recurse` with a var on
its predicate, on the CPU: the port's serving Node against the benchmark's
plain reference.

graphbench's generator (datagen/ldbc_knows.py) makes a seeded knows graph
at 2,000 Persons and a mean degree of 5 (at the mean-degree law's 21.6
three hops reach every Person, and the counts would not tell levels
apart), graphbench's loader puts it into a `Node(device="cpu")`, and each

    { var(func: uid(S)) @recurse(depth: d, loop: false) { R as knows }
      q(func: uid(R)) { count(uid) } }

answer, and the uids R binds, are compared with the plain reference
(graphbench/reference/recurse.py: Dgraph's level-synchronous expansion,
each edge traversed once). R binds the union of every level's dest uids,
on every recurse path of query/recurse.py, each forced here and seen to
run: the fused path (plain K1/K2), the stepped path (a child filter that
keeps every uid), the host mirror, the mesh's fused program and the
per-task expand (a mesh Node with a second, empty predicate).

The JAX package binds only the block's var, so its count is 0: a pinned,
deliberate difference.
"""

import time

import numpy as np
import pytest

from dgraph_tpu.api.server import Node as JNode

from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.obs import otrace
from dgraph_tpu_torch.query import recurse

from graphbench import run, spec
from graphbench.ingest import packed
from graphbench.reference import recurse as ref_recurse
from graphbench.reference.dataset import Reference

CELL = "ldbc100.recurse3-person"
SEED = 2**31 + 22
PERSONS = 2000
STARTS = 3
KIND = spec.plugin("requests", "recurse_count")
COUNTERS = ("dgraph_recurse_levels_ns_total", "dgraph_recurse_bind_ns_total",
            "dgraph_recurse_levels_total", "dgraph_recurse_bound_uids_total")
# path: (recurse.KERNEL_MIN_EDGES, child filter, Node options, extra
# predicate, the function the path runs)
PATHS = {
    "fused": (0, "", {}, "", "_recurse_fused_path"),
    "stepped": (0, " @filter(has(knows))", {}, "", "_seeds_mask"),
    "host": (None, "", {}, "", "_expand_dedup"),
    "mesh": (None, "", {"mesh_devices": 4, "mesh_min_edges": 1}, "",
             "_mesh_recurse_path"),
    "task": (None, "", {"mesh_devices": 4, "mesh_min_edges": 1}, " other",
             "_dedup_task_edges"),
}


MEAN_DEGREE = 5


def _data(persons: int, seed: int = SEED) -> dict:
    gen = spec.plugin("datagen", "ldbc_knows")
    cfg = spec.cell(CELL).config
    cfg.update(persons=persons, knows=persons * MEAN_DEGREE // 2)
    return run.host_data(gen.generate(cfg, seed, "cpu"))


_LOADED: dict = {}


def _loaded(persons: int = PERSONS):
    """(data, reference, start Persons), made once per process."""
    if persons not in _LOADED:
        data = _data(persons)
        rng = np.random.default_rng(SEED)
        starts = rng.choice(data["pools"]["knows"], STARTS, replace=False)
        _LOADED[persons] = (data, Reference(data),
                            [int(s) for s in starts])
    return _LOADED[persons]


def _node(data, **opts) -> Node:
    node = Node(device="cpu", **opts)
    packed.install(node, data)
    node.task_cache = node.result_cache = None
    return node


def _text(s: int, depth: int, filt: str = "", extra: str = "",
          select: str = "count(uid)") -> str:
    return ("{ var(func: uid(%s)) @recurse(depth: %d, loop: false) "
            "{ R as knows%s%s } q(func: uid(R)) { %s } }"
            % (hex(s), depth, filt, extra, select))


def _want(ref, s: int, depth: int) -> list[int]:
    adj = ref.adj["knows"]
    levels, _ = ref_recurse.recurse(adj, [s], depth)
    return ref_recurse.union(levels, adj.n).tolist()


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_var_binds_every_level_on_each_path(monkeypatch, path, depth):
    kmin, filt, opts, extra, runs = PATHS[path]
    monkeypatch.setattr(recurse, "KERNEL_MIN_EDGES", kmin)
    calls = [0]
    inner = getattr(recurse, runs)

    def spy(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(recurse, runs, spy)
    data, ref, starts = _loaded()
    node = _node(data, **opts)
    if extra:
        node.alter("other: [uid] .")
    try:
        for s in starts:
            want = _want(ref, s, depth)
            got = node.query(_text(s, depth, filt, extra),
                             edge_limit=1 << 31)[0]
            assert got == {"q": [{"count": len(want)}]}
            rows = node.query(_text(s, depth, filt, extra, "uid"),
                              edge_limit=1 << 31)[0]["q"]
            assert [int(r["uid"], 16) for r in rows] == want
    finally:
        node.close()
    assert calls[0] > 0


def test_the_request_kind_answers_as_the_node():
    """requests/recurse_count.py's text, answered by the Node on the fused
    path, is judged right by its own judge."""
    data, ref, _ = _loaded()
    node = _node(data)
    rng = np.random.default_rng(5)
    try:
        for _ in range(STARTS):
            req = KIND.make(rng, data, {"predicate": "knows", "depth": 3,
                                        "seeds": 1}, 0.0)
            resp = node.query(req["text"], edge_limit=1 << 31)[0]
            ok, edges = KIND.judge(ref, req, resp)
            assert ok and edges > 0
    finally:
        node.close()


def test_reference_binds_nothing_inside_recurse():
    """The JAX package records only the recurse block's own var, so R is
    unbound there and its count is 0; the port binds every level's dests
    and answers the plain reference's count."""
    data, ref, starts = _loaded(300)
    src, dst = data["edges"]["knows"]
    nquads = "\n".join(f"<{hex(a)}> <knows> <{hex(b)}> ."
                       for a, b in zip(src.tolist(), dst.tolist()))
    answers = {}
    for name, node in (("jax", JNode()), ("port", Node(device="cpu"))):
        try:
            node.alter("knows: [uid] .")
            node.mutate(set_nquads=nquads, commit_now=True)
            answers[name] = [node.query(_text(s, 2), edge_limit=1 << 31)[0]
                             for s in starts]
        finally:
            node.close()
    assert answers["jax"] == [{"q": [{"count": 0}]}] * len(starts)
    assert answers["port"] == [{"q": [{"count": len(_want(ref, s, 2))}]}
                               for s in starts]


def test_var_only_shape_fetches_no_fresh_flags(monkeypatch):
    """The cell's shape on the fused path reads the level masks alone: the
    `pb.fresh_flags` fetch is never entered, no level's uidMatrix is built,
    and the four counters and both spans are booked."""
    monkeypatch.setattr(recurse, "KERNEL_MIN_EDGES", 0)

    def refuse(*a, **kw):
        raise AssertionError("fresh flags fetched")

    monkeypatch.setattr(recurse.FreshFlags, "level", refuse)
    monkeypatch.setattr(recurse.LazyRecurseMatrix, "_materialize", refuse)
    data, ref, starts = _loaded()
    node = _node(data)
    try:
        before = {k: node.metrics.counters[k].value for k in COUNTERS}
        a = time.perf_counter()
        got = node.query(_text(starts[0], 3), edge_limit=1 << 31)[0]
        b = time.perf_counter()
        moved = {k: node.metrics.counters[k].value - before[k]
                 for k in COUNTERS}
    finally:
        node.close()
    want = _want(ref, starts[0], 3)
    assert got == {"q": [{"count": len(want)}]}
    assert moved["dgraph_recurse_levels_total"] == 3
    assert moved["dgraph_recurse_bound_uids_total"] == len(want)
    assert moved["dgraph_recurse_levels_ns_total"] > 0
    assert moved["dgraph_recurse_bind_ns_total"] > 0
    entries = otrace.span_log(a, b)
    by_name = {e[1]: e for e in entries}
    levels, bind = by_name["recurse_levels"], by_name["recurse_bind"]
    assert levels[0] == bind[0] == "traversal"
    assert levels[4] <= bind[3]              # the binding follows the run
    outer = by_name["recurse"]
    assert outer[3] <= levels[3] and bind[4] <= outer[4]
    assert [e for e in entries if e[1] == "device_kernel"
            and levels[3] <= e[3] and e[4] <= levels[4]]


def test_a_block_var_keeps_its_meaning(monkeypatch):
    """The recurse block's own var still binds its roots."""
    monkeypatch.setattr(recurse, "KERNEL_MIN_EDGES", 0)
    data, _, starts = _loaded()
    node = _node(data)
    try:
        got = node.query(
            "{ B as var(func: uid(%s)) @recurse(depth: 2, loop: false) "
            "{ R as knows } q(func: uid(B)) { uid } }"
            % ", ".join(hex(s) for s in starts), edge_limit=1 << 31)[0]
    finally:
        node.close()
    assert [int(r["uid"], 16) for r in got["q"]] == sorted(starts)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_recurse_union_equals_the_khop_union(depth):
    """Edge dedup drops an edge, never a uid a walk reaches: the union of
    the recurse's levels is the k-hop union (reference/graph.py)."""
    _, ref, starts = _loaded()
    adj = ref.adj["knows"]
    for s in starts:
        khop, _ = adj.khop_union([s], depth)
        assert _want(ref, s, depth) == khop.tolist()



def test_var_only_shape_unpacks_no_level_on_the_host(monkeypatch):
    """On the fused path the cell's shape unpacks no level's mask on the
    host: the var's union is the OR of the levels' masks, mapped to uids
    on the device (recurse.LevelMasks.union); a query that renders the
    levels still gets each level's uids."""
    monkeypatch.setattr(recurse, "KERNEL_MIN_EDGES", 0)
    calls = [0]
    inner = recurse.pb.unpack_words

    def spy(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(recurse.pb, "unpack_words", spy)
    data, ref, starts = _loaded()
    node = _node(data)
    try:
        got = node.query(_text(starts[0], 3), edge_limit=1 << 31)[0]
        unpacks = calls[0]
        tree = node.query("{ q(func: uid(%s)) @recurse(depth: 2, loop: false)"
                          " { uid knows } }" % hex(starts[0]),
                          edge_limit=1 << 31)[0]
    finally:
        node.close()
    assert got == {"q": [{"count": len(_want(ref, starts[0], 3))}]}
    assert unpacks == 0
    adj = ref.adj["knows"]
    levels, _ = ref_recurse.recurse(adj, [starts[0]], 2)
    first = sorted(int(r["uid"], 16) for r in tree["q"][0]["knows"])
    assert first == levels[0].tolist()


def test_level_masks_answer_as_their_levels():
    """recurse.LevelMasks: each level's uids and count from its mask, the
    union of any levels equal to the union of their uids; a FusedLevel
    reads its src and dest there until either is set."""
    from dgraph_tpu_torch.ops import pull_bfs as pb
    import torch

    class G:
        host_in_subjects = np.arange(3, 3 + 3 * 5000, 3, dtype=np.int64)
        in_subjects = torch.from_numpy(host_in_subjects.astype(np.int32))

    nd = len(G.host_in_subjects)
    rng = np.random.default_rng(9)
    bits = rng.random((3, nd)) < np.array([[0.001], [0.3], [0.9]])
    masks = pb.pack_words(torch.from_numpy(bits), pb.pack_chunks(nd))
    seeds = np.array([6, 12], np.int64)
    lm = recurse.LevelMasks(G, seeds, masks.numpy(), masks, "knows")
    dests = [G.host_in_subjects[np.flatnonzero(b)] for b in bits]
    assert lm.dest(-1) is seeds and lm.count(-1) == 2
    for lvl in range(3):
        assert np.array_equal(lm.dest(lvl), dests[lvl])
        assert lm.count(lvl) == len(dests[lvl])
    for lvls in ([0], [1, 2], [0, 1, 2]):
        assert np.array_equal(lm.union(lvls),
                              np.unique(np.concatenate([dests[i]
                                                        for i in lvls])))
    from dgraph_tpu_torch.query import dql

    gq = dql.GraphQuery(attr="knows")
    lv = recurse.FusedLevel(gq, lm, 1)
    assert np.array_equal(lv.src_uids, dests[0])
    assert np.array_equal(lv.dest_uids, dests[1])
    assert lv.bound_union() == (lm, 1)
    lv.dest_uids = seeds
    assert lv.dest_uids is seeds and lv.bound_union() is None
    assert np.array_equal(recurse._dest_union([lv, recurse.FusedLevel(
        gq, lm, 0)]), np.union1d(seeds, dests[0]))
