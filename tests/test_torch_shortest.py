"""The port's shortest-path slice against the JAX package, on the CPU.

The same numpy CSRs (and edge facets) go to both packages, the port's
through dgraph_tpu_torch/carry.py. Each of the three `shortest` tiers is
forced through the module globals of both packages' query/shortest.py: the
kernel tier (Pallas in interpret mode on the JAX side, the plain PyTorch
kernels on the port's), the Bellman-Ford tier (ops/traversal.sssp) and the
host tier (level adjacency, then Dijkstra or k-shortest). Equality is exact
throughout: uids, counts, float32 distances and byte-identical JSON.
"""

import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dgraph_tpu.models.rmat import rmat_csr
from dgraph_tpu.ops import pallas_bfs as jpb
from dgraph_tpu.ops import traversal as jtr
from dgraph_tpu.query import dql as jdql
from dgraph_tpu.query import engine as jeng
from dgraph_tpu.query import shortest as jsh
from dgraph_tpu.query import task as jtask
from dgraph_tpu.storage import csr_build as jcb
from dgraph_tpu.utils import schema as jschema
from dgraph_tpu.utils.types import TypeID as JTypeID
from dgraph_tpu.utils.types import Val as JVal

from dgraph_tpu_torch import carry
from dgraph_tpu_torch.ops import pull_bfs as tpb
from dgraph_tpu_torch.ops import traversal as ttr
from dgraph_tpu_torch.query import dql as tdql
from dgraph_tpu_torch.query import engine as teng
from dgraph_tpu_torch.query import shortest as tsh
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.utils import schema as tschema
from dgraph_tpu_torch.utils.types import TypeID, Val

from test_torch_slice import SCHEMA, _csr, _graph

N = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_port_edge_limit():
    old = teng.MAX_QUERY_EDGES
    yield
    teng.set_query_edge_limit(old)


def _both(arrays, facets=None, schema=SCHEMA):
    """(JAX executor, port executor) over the same arrays and facets
    ({attr: {(s, o): ((name, JAX Val), ...)}})."""
    jsnap = jcb.GraphSnapshot(1)
    for attr, (s, p, x) in arrays.items():
        if attr.startswith("~"):
            jsnap.preds[attr[1:]].rev_csr = jcb.PredCSR(s, p, x)
        else:
            jsnap.preds[attr] = jcb.PredData(attr, JTypeID.UID,
                                             csr=jcb.PredCSR(s, p, x))
    for attr, f in (facets or {}).items():
        jsnap.preds[attr].facets = dict(f)
    tsnap = carry.snapshot_from_numpy(
        {attr: (int(JTypeID.UID), s, p, x)
         for attr, (s, p, x) in arrays.items()}, 1, device="cpu",
        facets=facets)
    js, ts = jschema.SchemaState(), tschema.SchemaState()
    for e in jschema.parse_schema(schema):
        js.set(e)
    for e in tschema.parse_schema(schema):
        ts.set(e)
    return jeng.Executor(jsnap, js), teng.Executor(tsnap, ts)


def _outcome(ex, parse, q):
    """The JSON of a request, or the ErrTooBig it raised."""
    try:
        return json.dumps(ex.execute(parse(q)))
    except (jeng.QueryError, teng.QueryError) as e:
        return f"raised: {e}"


def _run_both(arrays, q, facets=None, schema=SCHEMA):
    jex, tex = _both(arrays, facets, schema)
    return _outcome(jex, jdql.parse, q), _outcome(tex, tdql.parse, q)


TIERS = ("kernel", "sssp", "host")


@pytest.fixture(params=TIERS)
def tier(request, monkeypatch):
    """Force one shortest tier in both packages."""
    for mod in (jsh, tsh):
        monkeypatch.setattr(mod, "DEVICE_SSSP_MIN_EDGES",
                            1 << 62 if request.param == "host" else 0)
        monkeypatch.setattr(mod, "SSSP_KERNEL_MIN",
                            0 if request.param == "kernel" else None)
    return request.param


def _host_dist(subjects, indptr, indices, src, n):
    """Plain BFS hop counts from src (-1 = unreached)."""
    dist = np.full(n + 2, -1)
    dist[src] = 0
    frontier, d = [src], 0
    rows = {int(u): indices[indptr[i]:indptr[i + 1]]
            for i, u in enumerate(subjects)}
    while frontier:
        d += 1
        nxt = sorted({int(t) for u in frontier for t in rows.get(u, ())
                      if dist[int(t)] < 0})
        for t in nxt:
            dist[t] = d
        frontier = nxt
    return dist


def _endpoints(arrays):
    """(src, far dst, its distance, uid without in-edges) on `follow`: the
    first src that reaches some uid 3 or more hops away."""
    s, p, x = arrays["follow"]
    for src in s:
        dist = _host_dist(s, p, x, int(src), N)
        if dist.max() >= 3:
            far = int(np.flatnonzero(dist == dist.max())[0])
            break
    no_in = sorted(set(range(1, N + 1)) - set(x.tolist()))
    return int(src), far, int(dist[far]), (no_in[0] if no_in else N + 5)


# ---------------------------------------------------------------------------
# ops/traversal.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights,max_iters", [
    (None, 64), ("positive", 64), (None, 2), ("positive", 3), ("signed", 5)])
def test_sssp_matches_jax(weights, max_iters):
    s, p, x = _graph(11, N)["follow"]
    rng = np.random.default_rng(4)
    # integral weights make ties, the fractional ones break some; signed
    # ones (negative cycles, cut by max_iters) reach the negative keys of
    # the port's integer segment-min
    w = None if weights is None else (
        rng.integers(1, 4, len(x)) + 0.25 * rng.integers(0, 3, len(x))
        - (2.5 if weights == "signed" else 0)).astype(np.float32)
    src = int(s[0])
    want = jtr.sssp(jnp.asarray(s), jnp.asarray(p), jnp.asarray(x),
                    None if w is None else jnp.asarray(w), jnp.int32(src),
                    num_nodes=64, max_iters=max_iters)
    got = ttr.sssp(torch.from_numpy(s), torch.from_numpy(p),
                   torch.from_numpy(x),
                   None if w is None else torch.from_numpy(w), src,
                   num_nodes=64, max_iters=max_iters)
    assert got.dist.dtype == torch.float32 and got.parent.dtype == torch.int32
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    np.testing.assert_array_equal(got.parent.numpy(), np.asarray(want.parent))
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("frontier_cap,edge_cap,hops", [
    (64, None, 3),       # no truncation
    (8, 256, 3),         # frontier_cap truncates the fresh set
    (16, 20, 2),         # edge_cap truncates a level's gather
    (2, 64, 2)])         # more seeds than frontier_cap: sorted, cut
def test_k_hop_matches_jax(frontier_cap, edge_cap, hops):
    s, p, x = _graph(5, N)["follow"]
    seeds = np.asarray([int(s[0]), int(s[3]), 2**31 - 1], dtype=np.int32)
    kw = dict(hops=hops, frontier_cap=frontier_cap, num_nodes=64,
              edge_cap=edge_cap)
    want = jtr.k_hop(jnp.asarray(s), jnp.asarray(p), jnp.asarray(x),
                     jnp.asarray(seeds), **kw)
    got = ttr.k_hop(torch.from_numpy(s), torch.from_numpy(p),
                    torch.from_numpy(x), torch.from_numpy(seeds), **kw)
    for name in ("visited", "frontier", "frontier_sizes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.traversed) == int(want.traversed)


@pytest.mark.parametrize("hops", [1, 3])
def test_dense_and_pull_k_hop_match_jax(hops):
    s, p, x = _graph(6, N)["follow"]
    rows_j = jtr.edge_src_rows(jnp.asarray(p))
    rows_t = ttr.edge_src_rows(torch.from_numpy(p))
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    rev_j, rev_t = jtr.reverse_csr(s, p, x), ttr.reverse_csr(s, p, x)
    for a, b in zip(rev_t, rev_j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    mask = np.zeros(64, dtype=bool)
    mask[[int(s[0]), int(s[7])]] = True
    want = jtr.k_hop_dense(jnp.asarray(s), jnp.asarray(p), jnp.asarray(x),
                           rows_j, jnp.asarray(mask), hops=hops,
                           num_nodes=64)
    got = ttr.k_hop_dense(torch.from_numpy(s), torch.from_numpy(p),
                          torch.from_numpy(x), rows_t,
                          torch.from_numpy(mask), hops=hops, num_nodes=64)
    want_p = jtr.k_hop_pull(jnp.asarray(s), jnp.asarray(p),
                            *map(jnp.asarray, rev_j), jnp.asarray(mask),
                            hops=hops, num_nodes=64)
    got_p = ttr.k_hop_pull(torch.from_numpy(s), torch.from_numpy(p),
                           *map(torch.from_numpy, rev_t),
                           torch.from_numpy(mask), hops=hops, num_nodes=64)
    for w, g in ((want, got), (want_p, got_p)):
        np.testing.assert_array_equal(g.visited.numpy(), np.asarray(w.visited))
        np.testing.assert_array_equal(g.frontier.numpy(),
                                      np.asarray(w.frontier))
        assert int(g.traversed) == int(w.traversed)
    # the two dense forms are one BFS
    np.testing.assert_array_equal(got.visited.numpy(), got_p.visited.numpy())


# ---------------------------------------------------------------------------
# ops/pull_bfs.py: bfs_dist and shortest_bfs
# ---------------------------------------------------------------------------

def _jax_dist(planes, nd):
    planes = np.asarray(planes)
    dist = np.zeros(nd, dtype=np.int32)
    for b in range(planes.shape[0]):
        dist |= jpb.unpack_words(planes[b], nd).astype(np.int32) << b
    return dist


@pytest.mark.parametrize("sparse_max", [tpb.SPARSE_MAX, 4])
@pytest.mark.parametrize("case", ["far", "cut", "unreached", "seeds"])
def test_bfs_dist_matches_jax(case, sparse_max, monkeypatch):
    """Distances, found and hops run, on an R-MAT graph; sparse_max = 4
    sends the port's wide hops to K1 (JAX keeps K2: the same prefix)."""
    monkeypatch.setattr(tpb, "SPARSE_MAX", sparse_max)
    s, p, x = rmat_csr(10, 8, seed=3)
    n = int(max(s.max(), x.max())) + 1
    jg = jpb.prep_pull(s, p, x, n, with_host_arrays=True)
    tg = tpb.prep_pull(s, p, x, n, with_host_arrays=True, device="cpu")
    src = int(s[0])
    dist = _host_dist(s, p, x, src, n)
    mask = np.zeros(n, dtype=bool)
    mask[src] = True
    far = int(np.flatnonzero(dist == dist.max())[0])
    dst, max_hops = {"far": (far, 64), "cut": (far, int(dist.max()) - 1),
                     "unreached": (int(np.flatnonzero(
                         (dist[:n] < 0) & np.isin(np.arange(n), x))[0]), 64),
                     "seeds": (far, 64)}[case]
    if case == "seeds":
        mask[s[1:4]] = True
    dr = int(np.searchsorted(tg.host_in_subjects, dst))
    planes, found, h = jpb.bfs_dist(
        jg.in_src_pad, jg.in_src_pad_d, jg.in_iptr_rank, jg.subjects,
        jg.in_subjects, jnp.asarray(mask), jnp.int32(dr),
        jnp.int32(max_hops), chunks=jg.chunks, chunks_d=jg.chunks_d)
    tdist, tfound, th = tpb.bfs_dist(
        tg.in_src_pad, tg.in_src_pad_d, tg.in_iptr_rank, tg.subjects,
        tg.in_subjects, torch.from_numpy(mask), dr, max_hops,
        chunks=tg.chunks, chunks_d=tg.chunks_d)
    nd = len(tg.host_in_subjects)
    np.testing.assert_array_equal(tdist.numpy().astype(np.int32),
                                  _jax_dist(planes, nd))
    assert bool(tfound) == bool(found) == (case in ("far", "seeds"))
    assert th == int(h)


def test_shortest_bfs_all_pairs_match_jax(monkeypatch):
    """Every (src, dst) of a 60-node graph, uids 0 and past num_nodes
    included, at the default depth and under a 2-hop cut. The port runs
    every hop through plain K1 here (SPARSE_MAX = -1), 4x cheaper on the
    CPU than plain K2 and the same prefix (test_bfs_dist_matches_jax runs
    both)."""
    monkeypatch.setattr(tpb, "SPARSE_MAX", -1)
    s, p, x = _graph(42, N)["follow"]
    n = int(max(s.max(), x.max())) + 1
    jg = jpb.prep_pull(s, p, x, n, with_host_arrays=True)
    tg = tpb.prep_pull(s, p, x, n, with_host_arrays=True, device="cpu")
    found = 0
    for src in range(n + 2):
        for dst in range(n + 2):
            for max_hops in ((64, 2) if src < 5 else (64,)):
                want = jpb.shortest_bfs(jg, src, dst, max_hops)
                got = tpb.shortest_bfs(tg, src, dst, max_hops)
                assert got == want, (src, dst, max_hops)
                found += want is not None
    assert found > n * n // 2
    assert tpb.shortest_bfs(tg, int(s[0]), int(s[0]) + 10**6, 64) is None


# ---------------------------------------------------------------------------
# the slice end to end: Executor.execute JSON, tier by tier
# ---------------------------------------------------------------------------

def _shapes(src, far, d, no_in):
    # the filter drops every fifth uid but keeps the endpoints
    kept = ", ".join(hex(u) for u in range(1, N + 1)
                     if u % 5 or u in (src, far))
    one = "{ p as shortest(from: %s, to: %s%s) { %s } r(func: uid(p)) " \
          "{ uid } }"
    return {
        "single": one % (src, far, "", "follow"),
        "numpaths2": one % (src, far, ", numpaths: 2", "follow"),
        "numpaths3": one % (src, far, ", numpaths: 3", "follow"),
        "depth": one % (src, far, f", depth: {d}", "follow"),
        "depth_cut": one % (src, far, f", depth: {d - 1}", "follow"),
        "weight_band": one % (src, far, f", numpaths: 3, minweight: {d}, "
                              f"maxweight: {d + 1}", "follow"),
        "unreachable": one % (src, no_in, "", "follow"),
        "from_is_to": one % (src, src, "", "follow"),
        "reverse": one % (far, src, "", "~follow"),
        "two_predicates": one % (src, far, "", "follow knows"),
        "child_filter": one % (src, far, "", f"follow @filter(uid({kept}))"),
        "var_endpoint": "{ a as var(func: uid(%s)) p as shortest(from: "
                        "uid(a), to: %s) { follow } r(func: uid(p)) { uid } }"
                        % (src, far),
    }


SHAPES = list(_shapes(1, 2, 3, 4))


@pytest.mark.parametrize("shape", SHAPES)
def test_execute_shortest_json_byte_identical(shape, tier):
    arrays = _graph(42, N)
    q = _shapes(*_endpoints(arrays))[shape]
    want, got = _run_both(arrays, q)
    assert got == want
    out = json.loads(got)
    if shape in ("unreachable", "depth_cut"):
        assert "_path_" not in out
    else:
        assert out["_path_"] and out["r"]


def test_tiers_take_their_path(monkeypatch):
    """Each forcing reaches its tier in the port: one shortest_bfs call for
    the kernel tier, one sssp call for Bellman-Ford, neither for the host;
    the three agree on the weight."""
    arrays = _graph(42, N)
    q = _shapes(*_endpoints(arrays))["single"]
    calls = {"bfs": 0, "sssp": 0}
    real_bfs, real_sssp = tpb.shortest_bfs, ttr.sssp

    def count(name, fn):
        return lambda *a, **k: (calls.__setitem__(name, calls[name] + 1)
                                or fn(*a, **k))

    monkeypatch.setattr(tpb, "shortest_bfs", count("bfs", real_bfs))
    monkeypatch.setattr(ttr, "sssp", count("sssp", real_sssp))
    weights = set()
    for name, dmin, kmin, want in (("kernel", 0, 0, {"bfs": 1, "sssp": 0}),
                                   ("sssp", 0, None, {"bfs": 0, "sssp": 1}),
                                   ("host", 1 << 62, None,
                                    {"bfs": 0, "sssp": 0})):
        monkeypatch.setattr(tsh, "DEVICE_SSSP_MIN_EDGES", dmin)
        monkeypatch.setattr(tsh, "SSSP_KERNEL_MIN", kmin)
        calls.update(bfs=0, sssp=0)
        out = _both(arrays)[1].execute(tdql.parse(q))
        assert calls == want, name
        weights.add(out["_path_"][0]["_weight_"])
    assert len(weights) == 1


def test_tie_rule_per_tier(monkeypatch):
    """On a diamond 1->{2,3}->4 the kernel tier and Dijkstra take the
    minimum-uid predecessor (via 0x2), Bellman-Ford the maximum (via 0x3):
    the JAX package's rules, each kept by its tier."""
    arrays = {"follow": _csr(np.array([1, 1, 2, 3]), np.array([2, 3, 4, 4]))}
    q = "{ shortest(from: 0x1, to: 0x4) { follow } }"
    via = {}
    for name, dmin, kmin in (("kernel", 0, 0), ("sssp", 0, None),
                             ("host", 1 << 62, None)):
        for mod in (jsh, tsh):
            monkeypatch.setattr(mod, "DEVICE_SSSP_MIN_EDGES", dmin)
            monkeypatch.setattr(mod, "SSSP_KERNEL_MIN", kmin)
        want, got = _run_both(arrays, q)
        assert got == want
        via[name] = json.loads(got)["_path_"][0]["follow"][0]["uid"]
    assert via == {"kernel": "0x2", "sssp": "0x3", "host": "0x2"}


def test_shortest_edge_budget(tier):
    """Under a query edge limit of 2 the host expansion raises ErrTooBig in
    both packages; the device tiers are bounded by E and answer."""
    arrays = _graph(42, N)
    shapes = _shapes(*_endpoints(arrays))
    jeng.set_query_edge_limit(2)
    teng.set_query_edge_limit(2)
    for shape in ("single", "numpaths2"):
        want, got = _run_both(arrays, shapes[shape])
        assert got == want
        raised = got.startswith("raised:")
        assert raised == (tier == "host" or shape == "numpaths2")
        if raised:
            assert "ErrTooBig" in got


# ---------------------------------------------------------------------------
# facets on uid edges: costs and the plain expand
# ---------------------------------------------------------------------------

ROAD = "road: [uid] ."


def _road():
    arrays = {"road": _csr(np.array([1, 2, 1]), np.array([2, 3, 3]))}
    facets = {"road": {(1, 2): (("w", JVal(JTypeID.INT, 1)),),
                       (2, 3): (("w", JVal(JTypeID.INT, 1)),),
                       (1, 3): (("w", JVal(JTypeID.INT, 9)),)}}
    return arrays, facets


def test_road_facet_cost(tier):
    """The weighted 2-hop w=1+1 path beats the direct w=9 edge (the JAX
    package's tests/test_device_traversal.py road graph); facet costs keep
    the host tier whatever the forcing."""
    arrays, facets = _road()
    q = ("{ p as shortest(from: 0x1, to: 0x3) { road @facets(w) } "
         "  q(func: uid(p)) { uid } }")
    want, got = _run_both(arrays, q, facets, ROAD)
    assert got == want
    out = json.loads(got)
    assert out["_path_"][0]["_weight_"] == 2.0
    assert [x["uid"] for x in out["q"]] == ["0x1", "0x2", "0x3"]


def _facet_graph():
    """_graph(42) with facets on follow: a float `w` on most edges, a
    string `w` on some (cost falls back to 1.0), none on a few, and a
    second facet `since` sorting before `w`."""
    arrays = _graph(42, N)
    s, p, x = arrays["follow"]
    rng = np.random.default_rng(8)
    edges = {}
    for i, u in enumerate(s):
        for o in x[p[i]:p[i + 1]]:
            r = rng.random()
            if r < 0.1:
                continue
            w = (JVal(JTypeID.STRING, "far") if r < 0.2 else
                 JVal(JTypeID.FLOAT, float(rng.integers(1, 9)) / 2))
            edges[(int(u), int(o))] = (
                ("since", JVal(JTypeID.INT, int(rng.integers(1990, 2030)))),
                ("w", w))
    return arrays, {"follow": edges}


@pytest.mark.parametrize("numpaths", [1, 3])
def test_weighted_k_shortest_byte_identical(numpaths, tier):
    arrays, facets = _facet_graph()
    src, far, _d, _ = _endpoints(arrays)
    q = ("{ p as shortest(from: %s, to: %s, numpaths: %d) "
         "{ follow @facets(w) } r(func: uid(p)) { uid } }"
         % (src, far, numpaths))
    want, got = _run_both(arrays, q, facets)
    assert got == want
    paths = json.loads(got)["_path_"]
    assert len(paths) == numpaths
    weights = [pth["_weight_"] for pth in paths]
    assert weights == sorted(weights)


FACET_QUERIES = [
    "{ q(func: uid(0x1, 0x2, 0x3)) { follow @facets(w) { uid } } }",
    "{ q(func: uid(0x1, 0x2, 0x3)) { follow @facets { uid } } }",
    "{ q(func: uid(0x1, 0x2, 0x3)) { follow @facets(weight: w, since) } }",
    "{ q(func: uid(0x1, 0x2, 0x3, 0x4)) { follow (first: 2) @facets(w) "
    "@filter(uid(%s)) { uid } } }" % ", ".join(hex(u) for u in range(3, 61, 3)),
    "{ q(func: uid(0x5, 0x6)) { ~follow @facets(w) { uid } } }",
]


@pytest.mark.parametrize("gather", ["host", "device"])
@pytest.mark.parametrize("qidx", range(len(FACET_QUERIES)))
def test_facet_expand_byte_identical(qidx, gather, monkeypatch):
    if gather == "device":
        monkeypatch.setattr(jtask, "HOST_EXPAND_MAX", 0)
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays, facets = _facet_graph()
    want, got = _run_both(arrays, FACET_QUERIES[qidx], facets)
    assert got == want
    if qidx < 4:
        assert "follow|" in got


def test_facets_cross_carry_intact():
    arrays, facets = _facet_graph()
    _, tex = _both(arrays, facets)
    got = tex.snap.pred("follow").facets
    want = facets["follow"]
    assert list(got) == list(want)
    for key, fs in want.items():
        assert [n for n, _ in got[key]] == [n for n, _ in fs]
        for (_, gv), (_, wv) in zip(got[key], fs):
            assert isinstance(gv, Val) and gv.tid == TypeID(int(wv.tid))
            assert type(gv.value) is type(wv.value) and gv.value == wv.value
    with pytest.raises(ValueError, match="no CSR"):
        carry.snapshot_from_numpy({}, 1, device="cpu",
                                  facets={"follow": {}})


@pytest.mark.parametrize("q", [
    "{ q(func: uid(0x1)) { follow @facets(eq(w, 1)) { uid } } }",
    "{ q(func: uid(0x1)) { follow @facets(x as w) { uid } } }"])
def test_facet_filters_and_vars_raise(q):
    """Facet filters and facet variables were the value slice's; they now
    run, byte-identical to the JAX package."""
    arrays, facets = _facet_graph()
    want, got = _run_both(arrays, q, facets)
    assert got == want
    assert '"follow"' in got
