"""Grouped value vars (Dgraph's fillGroupedVars) on the CPU: a block that
groups by one uid predicate binds `x as <agg>` to each key uid's
aggregate, and the readers of such a var (the uid(x) root, ordering by
val(x), val(x) in rows, root aggregates) read it as columns.

graphbench's generator (datagen/graph500.py) makes the
`graph500-s20-groupby` configuration's graph (graph500-s20's) at scale 10,
graphbench's loader puts it into a `Node(device="cpu")`, and the whole
answer of requests/groupby_top.py's

    { var(func: uid(S)) { friend { B as friend } }
      var(func: uid(B)) @groupby(friend) { c as count(uid) }
      q(func: uid(c), orderdesc: val(c), first: 10) { uid n: val(c) }
      g(func: uid(c)) { count(uid) }
      t() { s: sum(val(c)) } }

is compared with the plain reference (graphbench/reference/groupby.py), on
the host route and on the device route (torch ops on CPU tensors: the
member expand's targets stay where the gather made them and are counted
there). A small hand-made graph holds the rest: rendered blocks, the other
aggregates, the keys that bind nothing, the tie rule of the ordering with
and without pagination, and the columns against their dict view and the
value sort. The JAX package binds no grouped var: a pinned, deliberate
difference.
"""

import numpy as np
import pytest

from dgraph_tpu.api.server import Node as JNode

from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.ops import segments
from dgraph_tpu_torch.query import engine, groupby, task

from graphbench import run, spec
from graphbench.ingest import packed
from graphbench.reference import groupby as ref_groupby
from graphbench.reference.dataset import Reference

CELL = "g500s20.groupby"
SEED = 2**31 + 24
KIND = spec.plugin("requests", "groupby_top")
PARAMS = {"predicate": "friend", "seeds": 128, "hops": 2, "first": 10}
COUNTERS = ("dgraph_groupby_ns_total", "dgraph_order_ns_total",
            "dgraph_groupby_groups_total", "dgraph_groupby_pairs_total",
            "dgraph_groupby_on_device_total", "dgraph_grouped_var_keys_total",
            "dgraph_expand_targets_on_device_total",
            "dgraph_expand_targets_fetched_total")

_LOADED: dict = {}


def _loaded():
    """(data, reference), made once per process."""
    if not _LOADED:
        cfg = spec.cell(CELL).config
        cfg["scale"] = 10
        data = run.host_data(spec.plugin("datagen", cfg["generator"])
                             .generate(cfg, SEED, "cpu"))
        _LOADED["g"] = (data, Reference(data))
    return _LOADED["g"]


def _node(data, **opts) -> Node:
    node = Node(device="cpu", **opts)
    packed.install(node, data)
    node.task_cache = node.result_cache = None
    return node


def _counters(node) -> dict:
    return {k: node.metrics.counters[k].value for k in COUNTERS}


@pytest.mark.parametrize("route", ["host", "device"])
def test_request_equals_the_reference(monkeypatch, route):
    if route == "device":
        monkeypatch.setattr(task, "HOST_EXPAND_MAX", 0)
        monkeypatch.setattr(groupby, "_HOST_AGG_MAX", 0)
        monkeypatch.setattr(segments, "_RANK_DEVICE_MIN", 0)
    data, ref = _loaded()
    node = _node(data)
    rng = np.random.default_rng(SEED)
    try:
        for _ in range(3):
            req = KIND.make(rng, data, PARAMS, 0.0)
            before = _counters(node)
            got = node.query(req["text"], edge_limit=1 << 31)[0]
            moved = {k: v - before[k] for k, v in _counters(node).items()}
            want, edges = KIND.answer(ref, req)
            assert got == want
            assert len(got["q"]) == 10 and edges > 0
            keys, counts, _ = ref_groupby.grouped_counts(
                ref.adj["friend"], req["seeds"], 2)
            assert moved["dgraph_groupby_groups_total"] == keys.numel()
            assert moved["dgraph_groupby_pairs_total"] == int(counts.sum())
            assert moved["dgraph_grouped_var_keys_total"] == keys.numel()
            assert moved["dgraph_groupby_ns_total"] > 0
            assert moved["dgraph_order_ns_total"] > 0
            on_card = 1 if route == "device" else 0
            assert moved["dgraph_groupby_on_device_total"] == on_card
            assert moved["dgraph_expand_targets_fetched_total"] == 0
            if route == "device":
                assert moved["dgraph_expand_targets_on_device_total"] >= 1
    finally:
        node.close()


def test_the_request_kind_judges_the_node():
    data, ref = _loaded()
    node = _node(data)
    try:
        req = KIND.make(np.random.default_rng(3), data,
                        dict(PARAMS, first=100), 0.0)
        resp = node.query(req["text"], edge_limit=1 << 31)[0]
    finally:
        node.close()
    ok, edges = KIND.judge(ref, req, resp)
    assert ok and edges > 0
    resp["q"][0]["n"] += 1
    assert KIND.judge(ref, req, resp)[0] is False


# ---------------------------------------------------------------------------
# a small hand-made graph
# ---------------------------------------------------------------------------

SCHEMA = "friend: [uid] .\nv: int .\nf: float .\ncity: string ."
# member -> keys: 0x3 and 0x5 are reached by 3 members, 0x4 and 0x6 by 2,
# 0x7 by 1; values on the members for the aggregates
EDGES = {1: [3, 4, 5], 2: [3, 5, 6], 8: [3, 4, 5, 6, 7], 9: []}
VALS = {1: 5, 2: -7, 8: 11, 9: 4}
FLOATS = {1: 0.25, 2: 1.5, 8: -3.125}
CITIES = {1: "x", 2: "y", 8: "x"}
MEMBERS = "uid(0x1, 0x2, 0x8, 0x9)"


@pytest.fixture(scope="module")
def small():
    quads = [f"<{hex(s)}> <friend> <{hex(t)}> ." for s, ts in EDGES.items()
             for t in ts]
    quads += [f'<{hex(u)}> <v> "{x}" .' for u, x in VALS.items()]
    quads += [f'<{hex(u)}> <f> "{x}"^^<xs:float> .'
              for u, x in FLOATS.items()]
    quads += [f'<{hex(u)}> <city> "{x}" .' for u, x in CITIES.items()]
    node = Node(device="cpu")
    node.alter(SCHEMA)
    node.mutate(set_nquads="\n".join(quads), commit_now=True)
    node.task_cache = node.result_cache = None
    yield node
    node.close()


def _groups(op=None, values=VALS):
    """The literal per-group computation: key -> members, or key -> the
    aggregate of the members' values."""
    members: dict[int, list[int]] = {}
    for s, ts in EDGES.items():
        for t in ts:
            members.setdefault(t, []).append(s)
    if op is None:
        return {k: len(m) for k, m in members.items()}
    out = {}
    for k, ms in members.items():
        xs = [values[m] for m in ms if m in values]
        if xs:
            out[k] = {"sum": sum(xs), "max": max(xs), "min": min(xs)}[op]
    return out


def _rows(small, text):
    return small.query(text)[0]


def test_rendered_block_keeps_its_rows_and_binds(small):
    plain = _rows(small, "{ r(func: %s) @groupby(friend) { count(uid) } }"
                  % MEMBERS)
    got = _rows(small, "{ r(func: %s) @groupby(friend) { c as count(uid) } "
                "q(func: uid(c)) { uid n: val(c) } }" % MEMBERS)
    assert got["r"] == plain["r"]
    assert got["r"][0]["@groupby"] == [
        {"friend": hex(k), "count": n} for k, n in
        sorted(_groups().items(), key=lambda kv: hex(kv[0]))]
    assert got["q"] == [{"uid": hex(k), "n": n}
                        for k, n in sorted(_groups().items())]


@pytest.mark.parametrize("block", ["var", "r"])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_value_aggregate_vars_equal_the_literal_groups(small, block, op):
    text = ("{ var(func: %s) { x as v } %s(func: %s) @groupby(friend) "
            "{ a as n: %s(val(x)) } q(func: uid(a)) { uid n: val(a) } }"
            % (MEMBERS, block, MEMBERS, op))
    got = _rows(small, text)
    assert got["q"] == [{"uid": hex(k), "n": n}
                        for k, n in sorted(_groups(op).items())]


def test_float_aggregate_var_is_a_float_column(small):
    """avg over ints and sum over floats bind FLOAT columns."""
    got = _rows(small, "{ var(func: %s) { x as v y as f } var(func: %s) "
                "@groupby(friend) { a as m: avg(val(x)) b as s: sum(val(y)) } "
                "q(func: uid(a)) { uid a: val(a) b: val(b) } }"
                % (MEMBERS, MEMBERS))
    members = {k: [s for s, ts in EDGES.items() if k in ts]
               for k in _groups()}
    assert got["q"] == [
        {"uid": hex(k),
         "a": sum(VALS[m] for m in ms) / len(ms),
         "b": sum(FLOATS[m] for m in ms if m in FLOATS)}
        for k, ms in sorted(members.items())]


@pytest.mark.parametrize("keys", ["@groupby(city)", "@groupby(friend, city)",
                                  "@groupby(city, friend)"])
@pytest.mark.parametrize("block", ["var", "r"])
def test_value_and_multi_keys_bind_nothing(small, keys, block):
    got = _rows(small, "{ %s(func: %s) %s { c as count(uid) } "
                "q(func: uid(c)) { uid } }" % (block, MEMBERS, keys))
    assert "q" not in got
    if block == "r":
        assert got["r"] == _rows(small, "{ r(func: %s) %s { count(uid) } }"
                                 % (MEMBERS, keys))["r"]


# count 3: 0x3, 0x5; count 2: 0x4, 0x6; count 1: 0x7
ORDERS = [
    ("orderdesc", "", ["0x3", "0x5", "0x4", "0x6", "0x7"]),
    ("orderasc", "", ["0x7", "0x4", "0x6", "0x3", "0x5"]),
    ("orderdesc", ", first: 3", ["0x3", "0x5", "0x4"]),
    ("orderdesc", ", first: 2, offset: 1", ["0x5", "0x4"]),
    ("orderasc", ", first: 2, offset: 2", ["0x6", "0x3"]),
    ("orderasc", ", first: 1", ["0x7"]),
    ("orderdesc", ", first: 9", ["0x3", "0x5", "0x4", "0x6", "0x7"]),
    ("orderdesc", ", offset: 3", ["0x6", "0x7"]),
    ("orderdesc", ", first: -2", ["0x6", "0x7"]),
    ("orderdesc", ", first: 2, after: 0x3", ["0x5", "0x4"]),
]


@pytest.mark.parametrize("direction,page,want", ORDERS)
def test_ties_order_by_ascending_uid(small, direction, page, want):
    got = _rows(small, "{ var(func: %s) @groupby(friend) { c as count(uid) }"
                " q(func: uid(c), %s: val(c)%s) { uid } }"
                % (MEMBERS, direction, page))
    assert [r["uid"] for r in got["q"]] == want


def test_uids_without_a_value_go_last(small):
    """uid(c, 0x1): 0x1 holds no count and comes after every key, in
    either direction."""
    for direction in ("orderasc", "orderdesc"):
        got = _rows(small, "{ var(func: %s) @groupby(friend) "
                    "{ c as count(uid) } q(func: uid(c, 0x1), %s: val(c)) "
                    "{ uid } }" % (MEMBERS, direction))
        assert got["q"][-1] == {"uid": "0x1"}


QUERIES = [
    "{ var(func: %s) @groupby(friend) { c as count(uid) } "
    "q(func: uid(c), %s: val(c)%s) { uid n: val(c) } "
    "t() { s: sum(val(c)) m: max(val(c)) l: min(val(c)) a: avg(val(c)) } }",
    "{ var(func: %s) { x as f } var(func: %s) @groupby(friend) "
    "{ c as s: sum(val(x)) } q(func: uid(c), %s: val(c)%s) { uid n: val(c) } "
    "t() { s: sum(val(c)) m: max(val(c)) l: min(val(c)) a: avg(val(c)) } }",
]


@pytest.mark.parametrize("qi", range(len(QUERIES)))
@pytest.mark.parametrize("direction,page,_want", ORDERS)
def test_columns_answer_as_the_dict_view(small, monkeypatch, qi, direction,
                                         page, _want):
    """The columnar order and root aggregates give what the value sort and
    the aggregator give over the dict view."""
    q = QUERIES[qi]
    text = q % ((MEMBERS, direction, page) if qi == 0
                else (MEMBERS, MEMBERS, direction, page))
    got = _rows(small, text)
    monkeypatch.setattr(engine.ValueColumns, "order",
                        lambda self, uids, desc, need: None)
    monkeypatch.setattr(engine.ValueColumns, "aggregate",
                        lambda self, op, uids: NotImplemented)
    assert _rows(small, text) == got
    assert got["t"]


def test_dict_view_equals_the_columns():
    cols = engine.ValueColumns(np.asarray([2, 5, 9], np.int64),
                               np.asarray([7, 1, 7], np.int32),
                               engine.TypeID.INT)
    vv = engine.VarValue(is_uid=False, cols=cols)
    assert vv.vals == {2: engine.Val(engine.TypeID.INT, 7),
                       5: engine.Val(engine.TypeID.INT, 1),
                       9: engine.Val(engine.TypeID.INT, 7)}
    assert all(type(v.value) is int for v in vv.vals.values())
    assert vv.vals is vv.vals
    assert cols.vals_of(np.asarray([9, 3, 2])) == [vv.vals[9], None,
                                                   vv.vals[2]]


@pytest.mark.parametrize("seed", range(4))
def test_columnar_order_equals_the_value_sort(seed):
    """Random INT and FLOAT columns with many ties, every direction and
    need: the same uids as the stable value sort over the dict view."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 400, 120)).astype(np.int64)
    for tid, values in ((engine.TypeID.INT, rng.integers(-3, 4, len(keys))),
                        (engine.TypeID.FLOAT,
                         rng.integers(-3, 4, len(keys)) / 4.0 + 0.5)):
        cols = engine.ValueColumns(keys, values, tid)
        vals = cols.as_dict()
        mixed = np.unique(np.concatenate([keys[::2],
                                          rng.integers(1, 400, 30)]))
        # the keys array itself is uid(x)'s root: no lookup is made
        for uids, desc in ((u, d) for u in (mixed, keys)
                           for d in (False, True)):
            have = sorted((u for u in uids.tolist() if u in vals),
                          key=lambda u: vals[u].value, reverse=desc)
            want = have + [u for u in uids.tolist() if u not in vals]
            for need in (None, 1, 7, len(want), len(want) + 5):
                got = cols.order(uids, desc, need)
                assert got.tolist() == (want if need is None
                                        else want[:need])


def test_jax_package_binds_no_grouped_var():
    """The JAX package binds no grouped var, so uid(c) is empty there and
    the block renders nothing; the port answers the counts."""
    answers = {}
    for name, node in (("jax", JNode()), ("port", Node(device="cpu"))):
        try:
            node.alter("p: [uid] .")
            node.mutate(set_nquads=KIND.EDGES, commit_now=True)
            answers[name] = node.query(KIND.ASK)[0]
        finally:
            node.close()
    assert answers["jax"] == {}
    assert answers["port"] == KIND.WANT
