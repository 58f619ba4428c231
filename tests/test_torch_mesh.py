"""The port's mesh against the JAX package's, on the CPU.

The JAX side runs the 8 forced host-platform devices of tests/conftest.py;
the port's side runs make_mesh(S, devices=[cpu] * S), the same shard count
wherever a test picks one. The same seeded numpy inputs go through both:

  * parallel/dist: the sharded CSR layout (per-shard arrays byte for byte),
    the staged per-task expand, dist_k_hop and their program caches;
  * parallel/mesh_exec: run_plan (filters, pagination, the groupby
    terminal), run_recurse, run_bfs and vector_topk at 2, 4 and 8 shards —
    every mask, level, distance and edge total exact; f32 agg candidates
    exact on small integers; vector candidate rows exact and their scores
    within 2 ulps of the largest, as in test_torch_vector.py;
  * placement: identity caches, the sharded/replicated gauges, the
    residency deferral;
  * the serving Node: Node(device="cpu", mesh_devices=8, mesh_min_edges=1)
    answers the golden battery as expected.json and as the JAX mesh Node,
    with the same fused/unfused counts, fallback labels, dispatch counts and
    /debug/metrics mesh section; the JAX mesh tests' chain batteries and
    the per-task mesh expand (queries at 2, 4 and 8 shards).

Every JSON comparison is exact.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.ops import uidset as jus
from dgraph_tpu.parallel import dist as jdist
from dgraph_tpu.parallel.dist import DistPredCSR as JDist
from dgraph_tpu.parallel.mesh import make_mesh as jmake_mesh
from dgraph_tpu.parallel.mesh_exec import MeshExecutor as JME
from dgraph_tpu.query import dql as jdql
from dgraph_tpu.query import task as jtask
from dgraph_tpu.query.engine import Executor as JExecutor
from tests.test_dist import build_host_csr

from dgraph_tpu_torch.api import http as thttp
from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.parallel import dist as tdist
from dgraph_tpu_torch.parallel.dist import DistPredCSR as TDist
from dgraph_tpu_torch.parallel.mesh import Mesh, make_mesh
from dgraph_tpu_torch.parallel.mesh_exec import MeshExecutor as TME
from dgraph_tpu_torch.query import dql as tdql
from dgraph_tpu_torch.query import engine as teng
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.query.engine import Executor as TExecutor

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _load("golden_battery_mesh", REPO / "tests" / "test_golden.py")
EXPECTED = json.loads((REPO / "tests" / "golden" / "expected.json")
                      .read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tmesh(S: int) -> Mesh:
    return make_mesh(S, devices=[CPU] * S)


def _toy_csr():
    # 5 subject rows over 8 shards: shards 5-7 are pure padding
    subjects = np.asarray([2, 5, 7, 11, 13], dtype=np.int32)
    indptr = np.asarray([0, 2, 3, 6, 6, 8], dtype=np.int32)
    indices = np.asarray([5, 7, 2, 1, 5, 9, 2, 7], dtype=np.int32)
    return subjects, indptr, indices


def _np(parts):
    return np.stack([p.cpu().numpy() for p in parts])


# ---------------------------------------------------------------------------
# parallel/mesh and parallel/dist
# ---------------------------------------------------------------------------

def test_make_mesh_shape_and_too_many_devices():
    m = make_mesh(8, devices=[CPU] * 8)
    assert m.shape["shard"] == 8 and len(m.devices) == 8
    assert make_mesh(devices=[CPU] * 3).shape == {"shard": 3}
    with pytest.raises(ValueError) as te:
        make_mesh(9, devices=[CPU] * 8)
    with pytest.raises(ValueError) as je:
        jmake_mesh(9)
    assert str(te.value) == str(je.value)


def test_collectives_fold_onto_the_leader():
    m = tmesh(4)
    parts = [torch.tensor([s, 10 - s], dtype=torch.int32) for s in range(4)]
    assert m.psum(parts)[2].tolist() == [6, 34]
    assert m.pmin(parts)[0].tolist() == [0, 7]
    assert m.pmax(parts)[3].tolist() == [3, 10]
    assert m.all_gather(parts)[1].tolist() == [[0, 10], [1, 9], [2, 8],
                                               [3, 7]]
    # a repeated device holds one replica, read-only by contract
    rep = m.psum(parts)
    assert all(r is rep[0] for r in rep)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_shard_csr_layout_equals_jax(S):
    rng = np.random.default_rng(5 + S)
    subjects, indptr, indices = build_host_csr(rng, 200, 1500)
    for arrays in (_toy_csr(), (subjects, indptr, indices)):
        j = jdist.shard_csr(*arrays, jmake_mesh(S))
        t = tdist.shard_csr(*arrays, tmesh(S))
        assert t.n_shards == S
        for jj, tt in zip(j, t):
            np.testing.assert_array_equal(np.asarray(jj), _np(tt))


def test_expand_matrix_equals_jax_and_stages_frontier():
    arrays = _toy_csr()
    jc = JDist(*arrays, jmake_mesh(8))
    tc = TDist(*arrays, tmesh(8))
    uids = np.asarray([2, 7, 11, 99], dtype=np.int64)
    jm, jt = jc.expand_matrix(uids)
    tm, tt = tc.expand_matrix(uids)
    assert jt == tt == 5
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jc._staged[0], tc._staged[0])
    # replaying the staged merged frontier reuses the staged tensors
    staged = tc._staged[0]
    jm2, _ = jc.expand_matrix(staged)
    tm2, _ = tc.expand_matrix(staged)
    for a, b in zip(jm2, tm2):
        np.testing.assert_array_equal(a, b)
    assert tc.shard_edges == [2, 1, 3, 0, 2, 0, 0, 0]


def test_expand_program_cached_across_calls():
    tc = TDist(*_toy_csr(), tmesh(8))
    tc.expand_matrix(np.asarray([2, 5], dtype=np.int64))
    before = tdist._expand_program.cache_info()
    for _ in range(3):
        tc.expand_matrix(np.asarray([2, 5], dtype=np.int64))
    after = tdist._expand_program.cache_info()
    assert after.misses == before.misses and after.hits > before.hits


@pytest.mark.parametrize("S,n,m,hops,seeds", [
    (8, 500, 4000, 3, [0, 3, 7]),
    (2, 100, 400, 2, [0]),
    (4, 100, 400, 2, [0]),
])
def test_dist_k_hop_equals_jax(S, n, m, hops, seeds):
    rng = np.random.default_rng(42)
    arrays = build_host_csr(rng, n, m)
    jm, tm = jmake_mesh(S), tmesh(S)
    cap = 8 if len(seeds) > 1 else 4
    jf, jv, jtr = jdist.dist_k_hop(
        jdist.shard_csr(*arrays, jm), jus.make_set(seeds, capacity=cap), jm,
        hops=hops, frontier_cap=512, num_nodes=n)
    tseeds = torch.tensor(
        list(seeds) + [int(tdist.SNT)] * (cap - len(seeds)),
        dtype=torch.int32)
    tf, tv, ttr = tdist.dist_k_hop(
        tdist.shard_csr(*arrays, tm), tseeds, tm,
        hops=hops, frontier_cap=512, num_nodes=n)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    assert int(jtr) == int(ttr)


def test_dist_k_hop_program_cached():
    arrays = build_host_csr(np.random.default_rng(5), 200, 1500)
    m = tmesh(8)
    sh = tdist.shard_csr(*arrays, m)
    seeds = torch.tensor([0, 3] + [int(tdist.SNT)] * 6, dtype=torch.int32)
    r1 = tdist.dist_k_hop(sh, seeds, m, hops=2, frontier_cap=512,
                          num_nodes=200)
    before = tdist._k_hop_program.cache_info()
    r2 = tdist.dist_k_hop(sh, seeds, m, hops=2, frontier_cap=512,
                          num_nodes=200)
    assert tdist._k_hop_program.cache_info().misses == before.misses
    np.testing.assert_array_equal(r1[1].numpy(), r2[1].numpy())


# ---------------------------------------------------------------------------
# parallel/mesh_exec programs against the JAX programs
# ---------------------------------------------------------------------------

def _exec_pair(S, arrays):
    j = JME(n_devices=S)
    t = TME(mesh=tmesh(S))
    return j, t, JDist(*arrays, j.mesh), TDist(*arrays, t.mesh)


def _plan_hops(csr, allow):
    return [(csr, ("leaf", 0), [allow], 2, 1),
            (csr, ("not", ("leaf", 0)), [allow], 0, 0),
            (csr, None, [], -2, 0),
            (csr, ("or", ("leaf", 0), ("leaf", 1)), [allow, allow[:5]],
             0, 1)]


@pytest.mark.parametrize("S", [2, 4, 8])
def test_run_plan_equals_jax(S):
    rng = np.random.default_rng(3)
    arrays = build_host_csr(rng, 300, 2500)
    j, t, jc, tc = _exec_pair(S, arrays)
    allow = np.unique(rng.integers(0, 300, 120)).astype(np.int64)
    seeds = np.asarray([0, 3, 7, 50], dtype=np.int64)
    lj = j.run_plan(_plan_hops(jc, allow), seeds)
    lt = t.run_plan(_plan_hops(tc, allow), seeds)
    assert len(lj) == len(lt) == 4
    for (fa, ta, na), (fb, tb, nb) in zip(lj, lt):
        np.testing.assert_array_equal(fa, fb)
        assert ta == tb
        np.testing.assert_array_equal(na, nb)
    for k in ("dgraph_mesh_dispatches_total", "dgraph_mesh_fused_hops_total",
              "dgraph_mesh_traversed_edges_total",
              "dgraph_mesh_program_builds_total"):
        assert j.metrics.counter(k).value == t.metrics.counter(k).value, k


@pytest.mark.parametrize("S", [2, 4, 8])
def test_run_plan_terminal_equals_jax(S):
    """The groupby terminal: per-rank member counts and the f32 (candidate,
    valid-count) pairs of sum/min/max/avg, exact on small integers (NaN =
    no value; empty groups keep the ±inf fills)."""
    rng = np.random.default_rng(9)
    arrays = build_host_csr(rng, 300, 2500)
    j, t, jc, tc = _exec_pair(S, arrays)
    planes = [np.where(rng.random((S, jc.rows_per)) < 0.6,
                       rng.integers(-9, 9, (S, jc.rows_per)),
                       np.nan).astype(np.float32) for _ in range(4)]
    ops = ("sum", "min", "max", "avg")
    seeds = np.asarray([1, 4, 9, 77], dtype=np.int64)
    allow = np.unique(rng.integers(0, 300, 150)).astype(np.int64)
    lj, tj = j.run_plan([(jc, ("leaf", 0), [allow], 0, 0)], seeds,
                        terminal=(jc, ops, planes))
    lt, tt = t.run_plan([(tc, ("leaf", 0), [allow], 0, 0)], seeds,
                        terminal=(tc, ops, planes))
    np.testing.assert_array_equal(lj[0][2], lt[0][2])
    np.testing.assert_array_equal(tj["table"], tt["table"])
    np.testing.assert_array_equal(tj["counts"], tt["counts"])
    assert tj["traversed"] == tt["traversed"]
    assert tj["counts"].sum() > 0
    for (ca, va), (cb, vb) in zip(tj["aggs"], tt["aggs"]):
        np.testing.assert_array_equal(np.asarray(ca), cb)
        np.testing.assert_array_equal(np.asarray(va), vb)


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("allow_loop", [False, True])
def test_run_recurse_equals_jax(S, allow_loop):
    rng = np.random.default_rng(4)
    arrays = build_host_csr(rng, 300, 2500)
    j, t, jc, tc = _exec_pair(S, arrays)
    allow = np.unique(rng.integers(0, 300, 200)).astype(np.int64)
    seeds = np.asarray([0, 3, 7, 50], dtype=np.int64)
    for formula, sets in ((None, None), (("not", ("leaf", 0)), [allow]),
                          (("leaf", 0), [allow])):
        lj = j.run_recurse(jc, seeds, 5, allow_loop, formula, sets)
        lt = t.run_recurse(tc, seeds, 5, allow_loop, formula, sets)
        for (fa, ta), (fb, tb) in zip(lj, lt):
            np.testing.assert_array_equal(fa, fb)
            assert ta == tb


@pytest.mark.parametrize("S", [2, 4, 8])
def test_run_bfs_equals_jax(S):
    """Distances, levels and the loop's edge total (the padded edge slots,
    as the JAX program counts them: ROADMAP queue 3), single and
    multi-predicate, exhaustive and stopping at a target."""
    rng = np.random.default_rng(6)
    a1 = build_host_csr(rng, 300, 1200)
    a2 = build_host_csr(rng, 300, 500)
    j, t, jc, tc = _exec_pair(S, a1)
    jc2, tc2 = JDist(*a2, j.mesh), TDist(*a2, t.mesh)
    for preds in (([jc], [tc]), ([jc, jc2], [tc, tc2])):
        for stop in (None, 77, 5, 10**6):
            for budget in (10**7, 2 * S * tc.ecap):
                bj = j.run_bfs(preds[0], 3, 10, budget, stop_at=stop)
                bt = t.run_bfs(preds[1], 3, 10, budget, stop_at=stop)
                np.testing.assert_array_equal(bj[0], bt[0])
                assert bj[1:] == bt[1:]
    assert t.loop_reads["bfs"] > 0


def test_run_bfs_edge_total_counts_padded_slots():
    """Reference quirk kept for equality: the BFS loop's edge total is the
    shards' padded edge slots once a level, not the frontier's edges."""
    j, t, jc, tc = _exec_pair(4, _toy_csr())
    bj = j.run_bfs([jc], 2, 10, 1000)
    bt = t.run_bfs([tc], 2, 10, 1000)
    assert bj[1:] == bt[1:] == (3, 3 * 4 * tc.ecap)


def _vec_twins(S, n, dim, seed, metric):
    from dgraph_tpu.storage import vecindex as jvx
    from dgraph_tpu.utils.schema import VectorSpec as JSpec
    from dgraph_tpu_torch.storage import vecindex as tvx
    from dgraph_tpu_torch.utils.schema import VectorSpec as TSpec

    rng = np.random.default_rng(seed)
    # small integers over few distinct rows: equal rows score equal in
    # both packages, so only the tie rule decides the candidates
    base = rng.integers(-3, 4, size=(6, dim)).astype(np.float32)
    base[np.all(base == 0, axis=1)] = 1.0
    vecs = base[rng.integers(0, 6, n)]
    subs = np.arange(1, n + 1, dtype=np.int64) * 3
    jv = jvx.VectorIndex("emb", JSpec(dim=dim, metric=metric), subs, vecs)
    tv = tvx.VectorIndex("emb", TSpec(dim=dim, metric=metric), subs, vecs,
                         device="cpu")
    j = JME(n_devices=S, shard_min_edges=1)
    t = TME(mesh=tmesh(S), shard_min_edges=1)
    return j, t, j._place_vec(jv), t._place_vec(tv), rng


@pytest.mark.parametrize("S", [2, 3, 4, 8])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_vector_topk_equals_jax(S, metric):
    j, t, jv, tv, rng = _vec_twins(S, 700, 8, 11, metric)
    assert jv._mesh is j and tv._mesh is t
    q = tv.vecs[rng.integers(0, 700)].copy()
    dead = np.asarray([4, 17, 600], dtype=np.int64)
    rj = j.vector_topk(jv, q, 32, dead)
    rt = t.vector_topk(tv, q, 32, dead)
    np.testing.assert_array_equal(np.asarray(rj), rt)
    assert t.metrics.counter(
        "dgraph_vector_mesh_dispatches_total").value == 1


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _carried_pair(S, min_edges=1):
    """The same snapshot in both packages (carry.snapshot_from_numpy)."""
    from dgraph_tpu.storage.csr_build import (GraphSnapshot, PredCSR,
                                              PredData)
    from dgraph_tpu.utils.types import TypeID
    from dgraph_tpu_torch import carry

    rng = np.random.default_rng(8)
    big = build_host_csr(rng, 200, 1600)
    small = build_host_csr(rng, 40, 30)
    preds = {"big": big, "small": small}
    jsnap = GraphSnapshot(1)
    for attr, (s, p, i) in preds.items():
        jsnap.preds[attr] = PredData(attr, TypeID.UID,
                                     csr=PredCSR(s, p, i))
    tsnap = carry.snapshot_from_numpy(
        {a: (int(TypeID.UID), *v) for a, v in preds.items()}, 1,
        device="cpu")
    j = JME(n_devices=S, shard_min_edges=min_edges)
    t = TME(mesh=tmesh(S), shard_min_edges=min_edges)
    return j, t, jsnap, tsnap


def test_place_snapshot_identity_caches_and_gauges():
    j, t, jsnap, tsnap = _carried_pair(4, min_edges=100)
    jp, tp = j.place_snapshot(jsnap), t.place_snapshot(tsnap)
    assert t.place_snapshot(tsnap) is tp
    assert t.owns(tp.preds["big"].csr) and not t.owns(tp.preds["small"].csr)
    assert tp.preds["small"] is tsnap.preds["small"]
    for k in ("dgraph_mesh_sharded_tablets", "dgraph_mesh_replicated_tablets",
              "dgraph_mesh_devices"):
        assert j.metrics.counter(k).value == t.metrics.counter(k).value, k
    # a new snapshot sharing the PredData keeps its placed identity
    from dgraph_tpu_torch.storage.csr_build import GraphSnapshot

    snap2 = GraphSnapshot(2, device="cpu")
    snap2.preds.update(tsnap.preds)
    assert t.place_snapshot(snap2).preds["big"] is tp.preds["big"]
    assert jp.preds["big"].csr.rows_per == tp.preds["big"].csr.rows_per


def test_placement_defers_to_residency_budget():
    """A tablet whose per-device row-shard would not fit the budget stays
    on the host path, marked for the reason=budget label."""
    from dgraph_tpu.parallel.mesh_exec import MeshExecutor as JMEx
    from dgraph_tpu.storage.residency import ResidencyManager as JRM
    from dgraph_tpu.storage.csr_build import PredCSR as JPC
    from dgraph_tpu.utils.metrics import Registry as JReg
    from dgraph_tpu_torch.storage.csr_build import PredCSR as TPC
    from dgraph_tpu_torch.storage.residency import ResidencyManager as TRM
    from dgraph_tpu_torch.utils.metrics import Registry as TReg

    subjects = np.arange(1, 65, dtype=np.int32)
    indptr = np.arange(0, 65 * 4, 4, dtype=np.int32)
    indices = np.tile(np.arange(1, 5, dtype=np.int32), 64)
    outs = []
    for ME, RM, Reg, PC, kw in (
            (JMEx, JRM, JReg, JPC, {"n_devices": 4}),
            (TME, TRM, TReg, TPC, {"mesh": tmesh(4)})):
        reg = Reg()
        mex = ME(metrics=reg, shard_min_edges=16,
                 residency=RM(budget_bytes=64, metrics=reg), **kw)
        csr = (PC(subjects, indptr, indices) if PC is JPC else
               PC(subjects, indptr, indices, device="cpu"))
        got = mex._place_csr(csr)
        outs.append((got is csr, getattr(got, "_mesh_deferred", False),
                     reg.counter(
                         "dgraph_mesh_residency_deferred_total").value))
    assert outs[0] == outs[1] == (True, True, 1)


# ---------------------------------------------------------------------------
# the serving Node: golden battery, chain batteries, coverage accounting
# ---------------------------------------------------------------------------

@pytest.fixture
def nodes():
    made = []

    def make(cls, *a, **kw):
        if cls is TNode:
            kw.setdefault("device", "cpu")
        n = cls(*a, **kw)
        made.append(n)
        return n

    yield make
    for n in made:
        n.close()


MESH_KEYS = ("dgraph_mesh_fused_queries_total",
             "dgraph_mesh_unfused_queries_total",
             "dgraph_mesh_dispatches_total", "dgraph_mesh_fused_hops_total",
             "dgraph_mesh_traversed_edges_total",
             "dgraph_mesh_program_builds_total",
             "dgraph_mesh_sharded_tablets", "dgraph_mesh_replicated_tablets",
             "dgraph_mesh_devices")


def _fallbacks(node):
    return node.metrics.keyed("dgraph_mesh_fallbacks_total",
                              labels=("reason",)).snapshot()


def _mesh_state(node):
    return ({k: node.metrics.counter(k).value for k in MESH_KEYS},
            _fallbacks(node))


def test_golden_battery_on_mesh_node_equals_expected_and_jax(nodes):
    from dgraph_tpu.api.http import _serving_metrics as jserving

    j = nodes(JNode, mesh_devices=8, mesh_min_edges=1)
    t = nodes(TNode, mesh_devices=8, mesh_min_edges=1)
    for n in (j, t):
        n.alter(schema_text=GOLDEN.SCHEMA)
        n.mutate(set_nquads=GOLDEN._dataset(), commit_now=True)
    for name, q in GOLDEN.QUERIES:
        a = json.loads(json.dumps(j.query(q)[0], default=str))
        b = json.loads(json.dumps(t.query(q)[0], default=str))
        assert b == EXPECTED[name] == a, name
    assert _mesh_state(t) == _mesh_state(j)
    assert t.metrics.counter("dgraph_mesh_sharded_tablets").value > 0
    fused = t.metrics.counter("dgraph_mesh_fused_queries_total").value
    unfused = t.metrics.counter("dgraph_mesh_unfused_queries_total").value
    assert fused / (fused + unfused) >= 0.9
    jm, tm = jserving(j)["mesh"], thttp._serving_metrics(t)["mesh"]
    assert tm == jm and tm["enabled"] and tm["devices"] == 8


CHAIN_SCHEMA = """
name: string @index(exact) .
p0: [uid] .
p1: [uid] .
p2: [uid] @reverse .
follows: [uid] .
"""


def _chain_quads():
    rng = np.random.default_rng(11)
    quads = [f'_:n{i} <name> "node{i}" .' for i in range(80)]
    for i in range(80):
        for attr, mul, off in (("p0", 3, 1), ("p1", 5, 2), ("p2", 7, 3)):
            for k in range(3):
                quads.append(
                    f"_:n{i} <{attr}> _:n{(i * mul + off + k) % 80} .")
        for j in sorted(rng.choice(80, size=3, replace=False)):
            if j != i:
                quads.append(f"_:n{i} <follows> _:n{j} .")
    return "\n".join(quads)


@pytest.fixture(scope="module")
def chain_quad():
    """(JAX plain, JAX mesh, port plain, port mesh) over tests/
    test_mesh_exec.py's chain graph, caches off so every query reaches
    the dispatch seam."""
    made = []
    for cls, mesh in ((JNode, 0), (JNode, 8), (TNode, 0), (TNode, 8)):
        kw = {"device": "cpu"} if cls is TNode else {}
        n = cls(mesh_devices=mesh, mesh_min_edges=1, **kw)
        n.alter(schema_text=CHAIN_SCHEMA)
        n.mutate(set_nquads=_chain_quads(), commit_now=True)
        n.plan_cache = n.task_cache = n.result_cache = None
        made.append(n)
    yield made
    for n in made:
        n.close()


CHAIN_BATTERY = [
    '{ q(func: eq(name, "node3")) { p0 { p1 { p2 } } } }',
    '{ q(func: eq(name, "node3")) { p0 { p1 { p2 { name } } } } }',
    '{ q(func: uid(0x1, 0x2)) { p0 { p0 { p0 } } } }',
    '{ q(func: eq(name, "node5")) { p2 { ~p2 } } }',
    '{ q(func: eq(name, "node1")) @recurse(depth: 3) { follows } }',
    '{ q(func: eq(name, "node1")) @recurse(depth: 4, loop: true) { p0 } }',
    '{ p as shortest(from: 0x1, to: 0x30) { follows } '
    'r(func: uid(p)) { uid } }',
    '{ p as shortest(from: 0x1, to: 0x30, numpaths: 2) { follows } '
    'r(func: uid(p)) { uid } }',
    '{ q(func: eq(name, "node3")) { p0 @filter(uid(0x1, 0x2, 0x3)) '
    '{ p1 } } }',
    '{ q(func: eq(name, "node3")) { p0 (first: 2) { p1 } } }',
    '{ q(func: eq(name, "node1")) @recurse(depth: 2) { follows p0 } }',
]


@pytest.mark.parametrize("qi", range(len(CHAIN_BATTERY)))
def test_chain_battery_equals_jax_dispatch_for_dispatch(chain_quad, qi):
    jp, jm, tp, tm = chain_quad
    q = CHAIN_BATTERY[qi]
    before = [_mesh_state(n) for n in (jm, tm)]
    outs = [json.dumps(n.query(q)[0], sort_keys=True, default=str)
            for n in (jp, jm, tp, tm)]
    assert len(set(outs)) == 1, q
    after = [_mesh_state(n) for n in (jm, tm)]
    dj = {k: after[0][0][k] - before[0][0][k] for k in MESH_KEYS}
    dt = {k: after[1][0][k] - before[1][0][k] for k in MESH_KEYS}
    assert dt == dj, q
    assert after[1][1] == after[0][1]


def test_chain_is_one_dispatch_vs_hops_on_per_task_path(chain_quad):
    """A 3-hop chain over mesh tablets is ONE mesh program; forced
    through the per-task seam (HOST_EXPAND_MAX = 0) it is one dispatch
    per hop, in both packages."""
    _jp, jm, _tp, tm = chain_quad
    q = '{ q(func: eq(name, "node3")) { p0 { p1 { p2 } } } }'
    for node, E, dqlm, taskm in ((jm, JExecutor, jdql, jtask),
                                 (tm, TExecutor, tdql, ttask)):
        c = node.metrics.counter("dgraph_mesh_dispatches_total")
        before = c.value
        out, _ = node.query(q)
        assert c.value - before == 1
        snap = node.snapshot()
        before = c.value
        old = taskm.HOST_EXPAND_MAX
        taskm.HOST_EXPAND_MAX = 0
        try:
            out2 = E(snap, node.store.schema, mesh=None).execute(
                dqlm.parse(q))
        finally:
            taskm.HOST_EXPAND_MAX = old
        assert c.value - before == 3
        assert json.dumps(out, sort_keys=True) == \
            json.dumps(out2, sort_keys=True)


def test_per_task_mesh_expand_is_size_adaptive(chain_quad):
    _jp, _jm, _tp, tm = chain_quad
    c = tm.metrics.counter("dgraph_mesh_dispatches_total")
    before = c.value
    TExecutor(tm.snapshot(), tm.store.schema, mesh=None).execute(
        tdql.parse('{ q(func: uid(0x1)) { p0 { uid } } }'))
    assert c.value == before, "tiny frontier must take the host mirror"


def test_mesh_recurse_edge_budget_raises_as_jax(chain_quad):
    from dgraph_tpu.query import engine as jeng

    _jp, jm, _tp, tm = chain_quad
    q = '{ q(func: eq(name, "node1")) @recurse(depth: 3) { follows } }'
    old_j, old_t = jeng.MAX_QUERY_EDGES, teng.MAX_QUERY_EDGES
    jeng.set_query_edge_limit(3)
    teng.set_query_edge_limit(3)
    try:
        with pytest.raises(Exception, match="ErrTooBig") as je:
            jm.query(q)
        with pytest.raises(Exception, match="ErrTooBig") as te:
            tm.query(q)
        assert str(te.value) == str(je.value)
    finally:
        jeng.MAX_QUERY_EDGES, teng.MAX_QUERY_EDGES = old_j, old_t


MESH_RECURSE = [
    '{ q(func: eq(name, "node1")) @recurse(depth: 3) { follows } }',
    '{ q(func: eq(name, "node1")) @recurse(depth: 4, loop: true) { p0 } }',
    '{ q(func: uid(0x1, 0x2, 0x5)) @recurse(depth: 5) { follows } }',
    '{ q(func: eq(name, "node1")) @recurse(depth: 4) '
    '{ follows @filter(has(p0) and not uid(0x3, 0x9)) } }',
    '{ q(func: eq(name, "node2")) @recurse(depth: 4) '
    '{ p0 @filter(not uid(0x1, 0x2, 0x3) or eq(name, "node40")) } }',
]


@pytest.mark.parametrize("qi", range(len(MESH_RECURSE)))
def test_mesh_recurse_device_frontiers_equal_host_replay(chain_quad, qi):
    """The recurse answer replays from the host mirrors; the device
    program's frontiers only feed dgraph_mesh_replay_divergence_total. So
    the counter must stay 0 while the query runs as one mesh program, and
    the answer equal the unsharded port's and the JAX mesh Node's (exact
    JSON)."""
    _jp, jm, tp, tm = chain_quad
    q = MESH_RECURSE[qi]
    div = tm.metrics.counter("dgraph_mesh_replay_divergence_total")
    disp = tm.metrics.counter("dgraph_mesh_dispatches_total")
    d0, n0 = div.value, disp.value
    got = json.dumps(tm.query(q)[0], sort_keys=True, default=str)
    assert disp.value - n0 == 1, q
    assert div.value == d0, q
    assert got == json.dumps(tp.query(q)[0], sort_keys=True, default=str)
    assert got == json.dumps(jm.query(q)[0], sort_keys=True, default=str)
    assert len(got) > 40


def test_mesh_write_then_read_fresh(nodes):
    """A commit lands as a delta overlay (host path, reason=overlay) and
    is visible at once, in both packages."""
    outs = []
    for cls in (JNode, TNode):
        n = nodes(cls, mesh_devices=8, mesh_min_edges=1)
        n.alter(schema_text=CHAIN_SCHEMA)
        n.mutate(set_nquads=_chain_quads(), commit_now=True)
        n.task_cache = n.result_cache = None
        q = '{ q(func: uid(0x1)) { p0 { uid p1 { uid } } } }'
        n.query(q)
        n.mutate(set_nquads="<0x1> <p0> <0x4f> .", commit_now=True)
        out, _ = n.query(q)
        assert "0x4f" in {x["uid"] for x in out["q"][0]["p0"]}
        outs.append((json.dumps(out, sort_keys=True), _fallbacks(n)))
    assert outs[0] == outs[1]
    assert outs[1][1].get("overlay", 0) >= 1


def test_fallback_total_sums_the_reasons_as_jax(nodes):
    """MeshExecutor.fallback_total() is the sum of
    dgraph_mesh_fallbacks_total over its reasons, in both packages, after
    a forced fallback (a multi-predicate @recurse and an overlay)."""
    totals = []
    for cls in (JNode, TNode):
        n = nodes(cls, mesh_devices=8, mesh_min_edges=1)
        n.alter(schema_text=CHAIN_SCHEMA)
        n.mutate(set_nquads=_chain_quads(), commit_now=True)
        n.task_cache = n.result_cache = None
        assert n.mesh_exec.fallback_total() == 0
        n.query('{ q(func: eq(name, "node1")) @recurse(depth: 2) '
                '{ follows p0 } }')
        n.mutate(set_nquads="<0x1> <p0> <0x4f> .", commit_now=True)
        n.query('{ q(func: uid(0x1)) { p0 { uid p1 { uid } } } }')
        by_reason = _fallbacks(n)
        assert len(by_reason) >= 2
        assert n.mesh_exec.fallback_total() == sum(by_reason.values())
        totals.append((n.mesh_exec.fallback_total(), by_reason))
    assert totals[1] == totals[0]


# ---------------------------------------------------------------------------
# the per-task path over sharded tablets (tests/test_dist_query.py's
# queries), at 2, 4 and 8 shards
# ---------------------------------------------------------------------------

DIST_SCHEMA = """
    name: string @index(exact, term) .
    age: int @index(int) .
    follows: [uid] @reverse @count .
    likes: [uid] .
"""

DIST_QUERIES = [
    '{ q(func: eq(name, "person3")) { name follows @filter(ge(age, 25)) '
    '{ name follows { name age } } } }',
    '{ q(func: ge(age, 55)) @filter(has(likes)) { name count(follows) } }',
    '{ q(func: eq(name, "person5")) { name ~follows { name } } }',
    '{ q(func: has(follows), orderasc: age, first: 7, offset: 3) '
    '{ name age } }',
    '{ q(func: eq(name, "person1")) @recurse(depth: 3) { name follows } }',
    '{ a as var(func: eq(name, "person2")) { f as follows }\n'
    '  q(func: uid(f)) @filter(NOT uid(a)) { name } }',
]


@pytest.fixture(scope="module")
def dist_node():
    n = TNode(device="cpu", planner=False)
    n.alter(schema_text=DIST_SCHEMA)
    rng = np.random.default_rng(7)
    people = [f'_:p{i} <name> "person{i}" .\n'
              f'_:p{i} <age> "{20 + i % 40}"^^<xs:int> .'
              for i in range(60)]
    edges = []
    for i in range(60):
        for j in sorted(rng.choice(60, size=4, replace=False)):
            if i != j:
                edges.append(f"_:p{i} <follows> _:p{j} .")
        if i % 3 == 0:
            edges.append(f"_:p{i} <likes> _:p{(i * 7 + 1) % 60} .")
    n.mutate(set_nquads="\n".join(people + edges), commit_now=True)
    yield n
    n.close()


@pytest.mark.parametrize("n_devices", [2, 4, 8])
@pytest.mark.parametrize("qi", range(len(DIST_QUERIES)))
def test_dist_query_matches_single_device(dist_node, n_devices, qi,
                                          monkeypatch):
    """Every uid tablet sharded, every expand through the mesh
    (HOST_EXPAND_MAX = 0): the JSON equals the single-device Node's."""
    q = DIST_QUERIES[qi]
    single, _ = dist_node.query(q)
    mex = TME(mesh=tmesh(n_devices), shard_min_edges=1)
    dsnap = mex.place_snapshot(dist_node.snapshot())
    assert any(mex.owns(pd.csr) for pd in dsnap.preds.values())
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    out = TExecutor(dsnap, dist_node.store.schema).execute(tdql.parse(q))
    assert out == single
    if qi in (0, 2):
        assert mex.metrics.counter(
            "dgraph_mesh_dispatches_total").value >= 1


# ---------------------------------------------------------------------------
# the mesh cases of the residency, lazy-fold, devprof and vector suites
# ---------------------------------------------------------------------------

def test_mesh_placement_survives_evict_cycle(nodes, monkeypatch):
    """Mesh placement is identity-keyed on PredData: an evict/re-admit
    cycle neither rotates the placement nor changes results."""
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    n = nodes(TNode, mesh_devices=4, mesh_min_edges=64, planner=False,
              device_budget_mb=512)
    n.alter(schema_text=CHAIN_SCHEMA)
    n.mutate(set_nquads=_chain_quads(), commit_now=True)
    n.task_cache = n.result_cache = None
    qs = CHAIN_BATTERY[:4]
    want = [n.query(q)[0] for q in qs]
    placed0 = n.snapshot().preds["p0"].csr
    assert n.mesh_exec.owns(placed0)
    n.residency.evict_to(0)
    assert n.snapshot().preds["p0"].csr is placed0
    assert [n.query(q)[0] for q in qs] == want


def test_lazy_snapshot_places_on_first_read(tmp_path, nodes):
    """A reopened Node's lazy base places pending tablets as they fold
    (DelegateThunk), and the 3-hop answers equal the host and JAX mesh
    Nodes over the same directory."""
    d = tmp_path / "p"
    seed = nodes(TNode, dirpath=str(d))
    seed.alter(schema_text=CHAIN_SCHEMA)
    seed.mutate(set_nquads=_chain_quads(), commit_now=True)
    seed.store.checkpoint(seed.zero.oracle.read_ts())
    seed.close()
    q = '{ q(func: eq(name, "node3")) { p0 { p1 { p2 { uid } } } } }'
    host = nodes(TNode, dirpath=str(d))
    mesh = nodes(TNode, dirpath=str(d), mesh_devices=8, mesh_min_edges=1)
    jmesh = nodes(JNode, dirpath=str(d), mesh_devices=8, mesh_min_edges=1)
    snap = mesh.snapshot()
    assert snap.preds.pending_attrs(), "the world was folded eagerly"
    outs = [json.dumps(n.query(q)[0], sort_keys=True)
            for n in (host, mesh, jmesh)]
    assert len(set(outs)) == 1
    assert mesh.metrics.counter("dgraph_mesh_sharded_tablets").value >= 3


def test_devprof_mesh_program_builds_and_cache_probe(nodes):
    """The observatory sees mesh program builds under the JAX family
    names, and its mesh.programs probe counts the executor's cache."""
    j = nodes(JNode, mesh_devices=8, mesh_min_edges=1)
    t = nodes(TNode, mesh_devices=8, mesh_min_edges=1)
    for n in (j, t):
        n.alter(schema_text=CHAIN_SCHEMA)
        n.mutate(set_nquads=_chain_quads(), commit_now=True)
        n.query('{ q(func: eq(name, "node3")) { p0 { p1 { p2 } } } }')
        n.query('{ q(func: eq(name, "node1")) @recurse(depth: 3) '
                '{ follows } }')
    assert t.mesh_exec._prof is t.devprof
    fams = [set(k for k in n.devprof.compiles_snapshot()["families"]
                if k.startswith("mesh.")) for n in (j, t)]
    assert fams[0] == fams[1] == {"mesh.plan", "mesh.recurse"}
    probes = t.devprof.compiles_snapshot()["cache_sizes"]
    assert probes["mesh.programs"] == len(t.mesh_exec._progs) == 2
    assert probes["mesh.programs"] == \
        j.devprof.compiles_snapshot()["cache_sizes"]["mesh.programs"]
    t.set_devprof(False)
    assert t.mesh_exec._prof is None


@pytest.mark.parametrize("nd", [3, 6, 8])
def test_vector_mesh_placement_equals_jax(nodes, monkeypatch, nd):
    """similar_to over a mesh-placed index: the JSON equals the JAX mesh
    Node's and the unplaced port Node's; the sharded scan wins over IVF
    (no IVF probe) at a non-pow2 device count too."""
    from dgraph_tpu.storage import vecindex as jvx
    from dgraph_tpu_torch.storage import vecindex as tvx

    for m in (jvx, tvx):
        monkeypatch.setattr(m, "HOST_SCAN_MAX", 0)
        monkeypatch.setattr(m, "IVF_MIN_ROWS", 16)
        monkeypatch.setattr(m, "VECTOR_NPROBE", 64)
    vec = _load("torch_vector_mesh", REPO / "tests" / "test_torch_vector.py")
    q = ('{ q(func: similar_to(emb, "[0.3, -1.0, 0.2, 0.5, 0.0, 1.1, '
         '-0.4, 0.9]", 7), orderasc: val(vector_distance)) '
         '{ uid d : val(vector_distance) } }')
    outs = []
    for cls, kw in ((TNode, {}), (JNode, {"mesh_devices": nd}),
                    (TNode, {"mesh_devices": nd})):
        n = nodes(cls, mesh_min_edges=1, **kw)
        n.alter(schema_text=vec._schema(8, "l2"))
        n.mutate(set_nquads=vec._quads(8, 90, 5)[0], commit_now=True)
        if n.mesh_exec is not None:
            n.mesh_exec.SHARD_MIN_EDGES = 1
        outs.append(json.dumps(n.query(q)[0], sort_keys=True))
        if kw:
            assert n.metrics.counter(
                "dgraph_vector_mesh_dispatches_total").value >= 1
            assert n.metrics.counter(
                "dgraph_vector_ivf_probes_total").value == 0
    assert len(set(outs)) == 1
