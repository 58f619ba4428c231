"""Whole-graph analytics of the port against the JAX package's, on the CPU.

The mesh programs (parallel/mesh_exec.run_pagerank / run_cc /
run_triangles) run at 2, 4 and 8 shards on seeded graphs, beside the JAX
programs on the 8 forced host-platform devices:

  * CC labels and iteration counts: exact, equal to the JAX program's and
    to the union-find oracle (and NetworkX);
  * triangle counts: exact, equal to the JAX program's and the host oracle
    on every seeded input — and on K_700, where the JAX program's float32
    sum is one short of C(700, 3) (a reference fault, ROADMAP queue 3), the
    port's float64 sum is exact;
  * PageRank: float32 with atomic adds, so not bitwise — every score within
    1e-6 of the float64 power iteration (query/analytics.pagerank_host),
    the top-5 uids equal, and at the default tolerance the iteration count
    within one of JAX's (a 1e-9 stop sits below the float32 noise floor).

Then Node.analytics and POST /analytics on a port mesh Node beside a JAX
mesh Node: cc and triangles bodies byte for byte, pagerank within 1e-6 with
the same top-5; the host fallbacks (no mesh, a delta overlay, a residency-
deferred tablet) and the typed errors as in the JAX package.
"""

import importlib.util
import json
from math import comb
from pathlib import Path

import numpy as np
import pytest
import torch

from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.parallel.mesh_exec import MeshExecutor as JME
from dgraph_tpu.query import analytics as jan

from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.parallel.mesh import make_mesh
from dgraph_tpu_torch.parallel.mesh_exec import MeshExecutor as TME
from dgraph_tpu_torch.query import analytics as tan

REPO = Path(__file__).resolve().parents[1]
PR_TOL = 1e-6          # PageRank scores against the float64 oracle


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tme(S):
    return TME(mesh=make_mesh(S, devices=[torch.device("cpu")] * S))


@pytest.fixture(scope="module")
def jmesh():
    return JME()


def _random_digraph(n, m, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2))
    e = np.unique(e[e[:, 0] != e[:, 1]], axis=0)
    return e[:, 0].astype(np.int32), e[:, 1].astype(np.int32)


def _top5(r):
    return np.argsort(-np.asarray(r, np.float64), kind="stable")[:5].tolist()


# ---------------------------------------------------------------------------
# the mesh programs against the JAX programs and the host oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("n,m,seed", [(500, 3000, 7), (350, 2200, 17)])
def test_pagerank_within_oracle_and_jax(jmesh, S, n, m, seed):
    esrc, edst = _random_digraph(n, m, seed)
    r_t, it_t = tme(S).run_pagerank(esrc, edst, n, tol=1e-9, max_iters=200)
    r_j, it_j = jmesh.run_pagerank(esrc, edst, n, tol=1e-9, max_iters=200)
    r_h, _ = tan.pagerank_host(esrc, edst, n, tol=1e-9, max_iters=200)
    assert r_t.dtype == np.float32 and r_t.shape == (n,)
    assert np.abs(r_t.astype(np.float64) - r_h).max() < PR_TOL
    assert np.abs(r_t.astype(np.float64) - r_j).max() < PR_TOL
    assert _top5(r_t) == _top5(r_h) == _top5(r_j)
    assert 0 < it_t < 200 and 0 < it_j < 200
    assert abs(float(np.sum(r_t)) - 1.0) < 1e-4
    # at the default tolerance (far above the float32 noise floor, where a
    # 1e-9 stop is not) the loops stop together, or one apart at the edge
    _, it_t = tme(S).run_pagerank(esrc, edst, n)
    _, it_j = jmesh.run_pagerank(esrc, edst, n)
    assert abs(it_t - it_j) <= 1


def test_pagerank_dangling_mass_conserved(jmesh):
    esrc = np.asarray([0, 1, 2], np.int32)
    edst = np.asarray([1, 2, 3], np.int32)
    r_t, _ = tme(4).run_pagerank(esrc, edst, 4, tol=1e-12, max_iters=300)
    r_h, _ = tan.pagerank_host(esrc, edst, 4, tol=1e-12, max_iters=300)
    assert np.abs(r_t.astype(np.float64) - r_h).max() < PR_TOL


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("n,m,seed", [(400, 260, 11), (350, 2200, 17)])
def test_cc_exact_equals_jax_and_oracle(jmesh, S, n, m, seed):
    esrc, edst = _random_digraph(n, m, seed)
    t = tme(S)
    lab_t, it_t = t.run_cc(esrc, edst, n)
    lab_j, it_j = jmesh.run_cc(esrc, edst, n)
    assert lab_t.dtype == np.int32
    np.testing.assert_array_equal(lab_t, np.asarray(lab_j))
    np.testing.assert_array_equal(lab_t, tan.cc_host(esrc, edst, n))
    assert it_t == it_j >= 1
    assert t.loop_reads["cc"] == it_t


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("n,m,seed", [(300, 4000, 13), (350, 2200, 17)])
def test_triangles_exact_equals_jax_and_oracle(jmesh, S, n, m, seed):
    esrc, edst = _random_digraph(n, m, seed)
    got = tme(S).run_triangles(esrc, edst, n)
    assert got == jmesh.run_triangles(esrc, edst, n) == \
        tan.triangles_host(esrc, edst, n) > 0


def test_triangles_exact_where_the_jax_f32_sum_is_not(jmesh):
    """Reference fault: the JAX program sums trace(A^3) in float32 and
    loses the count past 2**24; the port's float64 sum stays exact."""
    n = 700
    iu = np.triu_indices(n, 1)
    esrc, edst = iu[0].astype(np.int32), iu[1].astype(np.int32)
    exact = comb(n, 3)
    assert jmesh.run_triangles(esrc, edst, n) == exact - 1
    for S in (2, 4, 8):
        assert tme(S).run_triangles(esrc, edst, n) == exact


def test_triangles_refuse_tf32(monkeypatch):
    from dgraph_tpu_torch.ops import vector as tvops

    calls = []
    monkeypatch.setattr(tvops, "_check_fp32",
                        lambda t: calls.append(t.dtype))
    esrc, edst = _random_digraph(40, 200, 3)
    tme(2).run_triangles(esrc, edst, 40)
    assert calls == [torch.float32] * 2


def test_host_oracles_equal_jax():
    esrc, edst = _random_digraph(300, 2000, 5)
    r_t, it_t = tan.pagerank_host(esrc, edst, 300, tol=1e-9)
    r_j, it_j = jan.pagerank_host(esrc, edst, 300, tol=1e-9)
    np.testing.assert_array_equal(r_t, r_j)
    assert it_t == it_j
    np.testing.assert_array_equal(tan.cc_host(esrc, edst, 300),
                                  jan.cc_host(esrc, edst, 300))
    assert tan.triangles_host(esrc, edst, 300) == \
        jan.triangles_host(esrc, edst, 300)
    assert tan.KINDS == jan.KINDS and tan.TRI_DENSE_MAX == jan.TRI_DENSE_MAX


def test_empty_and_single_node_graphs(jmesh):
    t = tme(4)
    e = np.zeros(0, np.int32)
    r, _ = t.run_pagerank(e, e, 1, tol=1e-9, max_iters=50)
    assert len(r) == 1 and abs(float(r[0]) - 1.0) < 1e-6
    lab, _ = t.run_cc(e, e, 3)
    assert lab.tolist() == [0, 1, 2] == np.asarray(jmesh.run_cc(e, e, 3)[0]
                                                   ).tolist()
    assert tan.pagerank_host(e, e, 0)[0].shape == (0,)
    assert tan.triangles_host(e, e, 0) == 0


def test_networkx_oracles_agree():
    nx = pytest.importorskip("networkx")
    n = 300
    esrc, edst = _random_digraph(n, 1800, 21)
    t = tme(8)
    g = nx.DiGraph()
    g.add_nodes_from(range(n))
    g.add_edges_from(zip(esrc.tolist(), edst.tolist()))
    r, _ = t.run_pagerank(esrc, edst, n, tol=1e-9, max_iters=200)
    want = nx.pagerank(g, alpha=0.85, tol=1e-12, max_iter=500)
    assert np.abs(r - np.asarray([want[i] for i in range(n)])).max() < PR_TOL
    ug = g.to_undirected()
    assert t.run_triangles(esrc, edst, n) == \
        sum(nx.triangles(ug).values()) // 3
    lab, _ = t.run_cc(esrc, edst, n)
    assert len(set(lab.tolist())) == nx.number_connected_components(ug)


# ---------------------------------------------------------------------------
# Node.analytics + POST /analytics
# ---------------------------------------------------------------------------

SCHEMA = """
name: string @index(exact) .
follows: [uid] @reverse .
"""


def _social_quads(n=60, seed=3):
    rng = np.random.default_rng(seed)
    quads = [f'<0x{i:x}> <name> "u{i}" .' for i in range(1, n + 1)]
    for i in range(1, n + 1):
        for j in sorted(set(int(x) for x in rng.integers(1, n + 1, 4))):
            if j != i:
                quads.append(f"<0x{i:x}> <follows> <0x{j:x}> .")
    return "\n".join(quads)


@pytest.fixture(scope="module")
def social():
    """{(package, mesh devices): Node} over one social graph."""
    made = {}
    for pkg, cls in (("jax", JNode), ("torch", TNode)):
        for dev in (0, 8):
            kw = {"device": "cpu"} if cls is TNode else {}
            node = cls(mesh_devices=dev, mesh_min_edges=1, **kw)
            node.alter(schema_text=SCHEMA)
            node.mutate(set_nquads=_social_quads(), commit_now=True)
            made[(pkg, dev)] = node
    yield made
    for n in made.values():
        n.close()


@pytest.mark.parametrize("dev", [0, 8])
@pytest.mark.parametrize("kind,pred", [("cc", "follows"),
                                       ("triangles", "follows"),
                                       ("cc", "~follows")])
def test_node_analytics_exact_kinds_equal_jax(social, dev, kind, pred):
    a = social[("jax", dev)].analytics(kind, pred)
    b = social[("torch", dev)].analytics(kind, pred)
    assert json.dumps(b, sort_keys=True) == json.dumps(a, sort_keys=True)
    assert b["device"] is bool(dev)


@pytest.mark.parametrize("dev", [0, 8])
@pytest.mark.parametrize("pred", ["follows", "~follows"])
def test_node_analytics_pagerank_within_tolerance_of_jax(social, dev, pred):
    a = social[("jax", dev)].analytics("pagerank", pred, tol=1e-10,
                                       max_iters=300)
    b = social[("torch", dev)].analytics("pagerank", pred, tol=1e-10,
                                         max_iters=300)
    assert b["device"] is a["device"] is bool(dev)
    assert [r["uid"] for r in b["top"][:5]] == \
        [r["uid"] for r in a["top"][:5]]
    for ra, rb in zip(a["top"], b["top"]):
        assert abs(ra["score"] - rb["score"]) < PR_TOL
    for k in ("kind", "nodes", "edges", "pred"):
        assert a[k] == b[k]
    a = social[("jax", dev)].analytics("pagerank", pred)
    b = social[("torch", dev)].analytics("pagerank", pred)
    assert abs(a["iterations"] - b["iterations"]) <= 1


def test_node_analytics_metrics_and_errors_as_jax(social):
    host, dev = social[("torch", 0)], social[("torch", 8)]
    c_runs = dev.metrics.counter("dgraph_analytics_runs_total")
    c_host = host.metrics.counter("dgraph_analytics_host_fallbacks_total")
    r0, h0 = c_runs.value, c_host.value
    dev.analytics("cc", "follows")
    host.analytics("cc", "follows")
    assert c_runs.value > r0 and c_host.value > h0
    assert dev.metrics.counter("dgraph_mesh_dispatches_total").value >= 1
    for args in (("betweenness", "follows"), ("pagerank", "name")):
        with pytest.raises(ValueError) as je:
            social[("jax", 8)].analytics(*args)
        with pytest.raises(ValueError) as te:
            dev.analytics(*args)
        assert str(te.value) == str(je.value)


def test_overlay_and_deferred_tablets_fall_back_to_host(nodes_factory):
    outs = []
    for cls in (JNode, TNode):
        n = nodes_factory(cls, mesh_devices=8, mesh_min_edges=1)
        n.alter(schema_text=SCHEMA)
        n.mutate(set_nquads=_social_quads(), commit_now=True)
        n.analytics("cc", "follows")
        n.mutate(set_nquads="<0x1> <follows> <0x2> .", commit_now=True)
        outs.append(n.analytics("cc", "follows"))
    assert outs[0] == outs[1] and outs[1]["device"] is False
    # the residency gate: a deferred or overlaid tablet stays on the host
    from dgraph_tpu_torch.storage.csr_build import PredCSR

    csr = PredCSR(np.asarray([1], np.int32), np.asarray([0, 1], np.int32),
                  np.asarray([2], np.int32), device="cpu")
    mex = tme(2)
    assert tan._device_eligible(mex, csr)
    csr._mesh_deferred = True
    assert not tan._device_eligible(mex, csr)
    assert not tan._device_eligible(None, csr)


@pytest.fixture
def nodes_factory():
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


@pytest.fixture(scope="module")
def http_pair():
    hp = _load("torch_http_analytics", REPO / "tests" / "test_torch_http.py")
    pair = hp.Pair(mesh_devices=8, mesh_min_edges=1)
    pair.same("POST", "/alter", SCHEMA)
    pair.same("POST", "/mutate?commitNow=true",
              "{ set { " + _social_quads() + " } }")
    try:
        yield pair
    finally:
        pair.close()


@pytest.mark.parametrize("body", [
    {"kind": "cc", "pred": "follows"},
    {"kind": "triangles", "pred": "follows"},
    {"kind": "cc", "pred": "~follows", "maxIters": 50},
], ids=["cc", "triangles", "cc_reverse"])
def test_http_analytics_exact_bodies_equal_jax(http_pair, body):
    out = http_pair.same("POST", "/analytics", body)["data"]["analytics"]
    assert out["device"] is True and out["kind"] == body["kind"]


def test_http_analytics_pagerank_and_errors(http_pair):
    (sj, _, bj), (st, _, bt) = http_pair.both(
        "POST", "/analytics", {"kind": "pagerank", "pred": "follows",
                               "maxIters": 200, "top": 5, "tol": 1e-10})
    assert sj == st == 200
    a = json.loads(bj)["data"]["analytics"]
    b = json.loads(bt)["data"]["analytics"]
    assert [r["uid"] for r in a["top"]] == [r["uid"] for r in b["top"]]
    assert len(b["top"]) == 5
    for ra, rb in zip(a["top"], b["top"]):
        assert abs(ra["score"] - rb["score"]) < PR_TOL
    for bad in ({"kind": "pagerank"}, {"kind": "nope", "pred": "follows"},
                {"kind": "cc", "pred": "name"}):
        http_pair.same("POST", "/analytics", bad, status=400)
