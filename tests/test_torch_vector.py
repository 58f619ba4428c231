"""The port's vector index (ops/vector.py, storage/vecindex.py and the
similar_to paths of the engine) against the JAX package's, on the CPU.

Every case feeds the same seeded numpy inputs to the JAX function and to its
counterpart in the port (device="cpu": torch ops on CPU tensors):

  * ops/vector: the float32 candidate stage per metric, with tied rows
    (small-integer vectors: equal rows score equal in either package and
    distinct distances stay apart, so the tie rule alone decides),
    overlay-dead rows, k >= n, the stacked batch equal to solo, the IVF
    fine stage's tie order (the position in the candidate list) and the
    fused ANN -> expand program. Rows, uids and expansions must match
    exactly; the float32 scores agree to 2 ulps of the largest score (XLA
    may fuse a multiply-add that torch rounds twice).
  * storage/vecindex: search on the host-scan, device, IVF and overlay
    paths (uids and float64 distances equal), IVF centroids and lists
    identical to the JAX package's (both are host numpy: bit for bit), the
    stamped overlay against a from-scratch fold.
  * the Node: the golden DQL forms of tests/test_vector.py, the fused
    pipeline against the classic path, `vector_distance`, typed mutation
    errors, per-Node knobs, the `vec` residency counters and the batcher's
    vector family — JSON byte-identical to a JAX Node.

The mesh cases of tests/test_vector.py (sharded row scans) wait for the
mesh slice of the port.
"""

import json
import threading

import numpy as np
import pytest
import torch

from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.ops import vector as jvops
from dgraph_tpu.storage import vecindex as jvx
from dgraph_tpu.utils.schema import VectorSpec as JSpec

from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.ops import vector as tvops
from dgraph_tpu_torch.query.batch import DeviceBatcher
from dgraph_tpu_torch.storage import vecindex as tvx
from dgraph_tpu_torch.utils.schema import VectorSpec as TSpec

import jax.numpy as jnp

METRICS = ("cosine", "l2", "dot")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def host_scan_max(monkeypatch):
    """Set HOST_SCAN_MAX in both packages (0 forces the device class)."""
    def set_(v):
        monkeypatch.setattr(jvx, "HOST_SCAN_MAX", v)
        monkeypatch.setattr(tvx, "HOST_SCAN_MAX", v)
    return set_


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


def _vec_str(v) -> str:
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def _quads(dim, n, seed):
    """The dataset of tests/test_vector.py's _mk_node."""
    rng = np.random.default_rng(seed)
    quads = []
    for i in range(1, n + 1):
        quads.append(
            f'<0x{i:x}> <emb> "{_vec_str(rng.normal(size=dim))}"'
            f'^^<xs:float32vector> .')
        quads.append(f'<0x{i:x}> <name> "p{i}" .')
        for k in range(2):
            t = (i * 7 + k) % n + 1
            if t != i:
                quads.append(f'<0x{i:x}> <friend> <0x{t:x}> .')
    return "\n".join(quads), rng


def _schema(dim, metric):
    return (f"emb: float32vector @index(vector(dim: {dim}, "
            f"metric: {metric})) .\nfriend: [uid] @reverse .\n"
            f"name: string @index(exact) .")


def _pair(nodes, dim=8, n=60, metric="l2", seed=3, **kw):
    """A JAX Node and a port Node holding the same vector graph."""
    out = []
    for cls in (JNode, TNode):
        node = nodes(cls, **kw)
        node.alter(schema_text=_schema(dim, metric))
        quads, rng = _quads(dim, n, seed)
        node.mutate(set_nquads=quads, commit_now=True)
        out.append(node)
    return out[0], out[1], rng


def _same(j, t, q, **kw):
    a, _ = j.query(q, **kw)
    b, _ = t.query(q, **kw)
    sa, sb = json.dumps(a), json.dumps(b)
    assert sa == sb, (q, sa, sb)
    return a


def _int_matrix(rng, n, dim, distinct=6):
    """Small-integer rows drawn from a few distinct vectors: many exact ties
    and every distance exact in float32."""
    base = rng.integers(-3, 4, size=(distinct, dim)).astype(np.float32)
    base[np.all(base == 0, axis=1)] = 1.0
    return base[rng.integers(0, distinct, size=n)]


def _close(t, j):
    """float32 scores: the same formula in both packages, but XLA may fuse
    a multiply-add where torch rounds twice, so they agree to 2 ulps of
    the largest score (rtol 2.4e-7 of max |score|), not bit for bit;
    -inf padding slots must match exactly."""
    assert np.array_equal(np.isneginf(t), np.isneginf(j))
    fin = np.isfinite(j)
    scale = max(float(np.abs(j[fin]).max()) if fin.any() else 1.0, 1.0)
    assert np.allclose(t[fin], j[fin], rtol=0, atol=2.4e-7 * scale), (t, j)


def _padded(vecs):
    R = jvops.row_capacity(len(vecs))
    mat = np.zeros((R, vecs.shape[1]), np.float32)
    mat[: len(vecs)] = vecs
    norms = np.ones(R, np.float32)
    norms[: len(vecs)] = np.linalg.norm(vecs, axis=1)
    return mat, norms


def _jax_topk(mat, norms, q, n, dead, k, metric):
    R = mat.shape[0]
    block = min(R, max(jvops.BLOCK_ROWS, k))
    dr = np.full(8 + len(dead), R, np.int32)
    dr[: len(dead)] = dead
    nd, rows = jvops.topk_candidates(
        jnp.asarray(mat), jnp.asarray(norms), jnp.asarray(q), jnp.int32(n),
        jnp.asarray(dr), k=k, metric=metric, block=block)
    return np.asarray(nd), np.asarray(rows)


def _torch_topk(mat, norms, q, n, dead, k, metric):
    nd, rows = tvops.topk_candidates(
        torch.from_numpy(mat), torch.from_numpy(norms), torch.from_numpy(q),
        n, torch.from_numpy(np.asarray(dead, np.int32)), k=k, metric=metric)
    return nd.numpy(), rows.numpy()


# ---------------------------------------------------------------------------
# ops/vector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n,k,dead", [
    (60, 16, []),                 # k' < the tied groups: the tie rule cuts
    (60, 32, [3, 7, 11, 59]),     # overlay-dead rows masked
    (10, 16, []),                 # k >= n: (-inf, R) padding slots
    (5, 8, [0, 4]),
], ids=["ties", "dead", "k_ge_n", "k_ge_n_dead"])
def test_topk_candidates_equal_jax(metric, n, k, dead):
    rng = np.random.default_rng(100 + n + k)
    vecs = _int_matrix(rng, n, 8)
    mat, norms = _padded(vecs)
    q = vecs[rng.integers(0, n)].copy()
    k = min(k, mat.shape[0])
    jnd, jrows = _jax_topk(mat, norms, q, n, dead, k, metric)
    tnd, trows = _torch_topk(mat, norms, q, n, dead, k, metric)
    assert np.array_equal(trows, jrows), (trows, jrows)
    _close(tnd, jnd)


def test_stable_topk_breaks_ties_to_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, 3.0, float("-inf"), 2.0]])
    vals, ix = tvops._stable_topk(x, 7)
    # -0.0 and +0.0 are one score: the lower index comes first
    assert ix.tolist() == [[1, 2, 5, 7, 0, 3, 4]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0, 1.0, 0.0, 0.0]]


@pytest.mark.parametrize("metric", METRICS)
def test_topk_batch_equals_solo_and_jax(metric):
    rng = np.random.default_rng(7)
    n, dim, k = 50, 8, 16
    vecs = _int_matrix(rng, n, dim, distinct=9)
    mat, norms = _padded(vecs)
    Q = np.stack([vecs[i] for i in rng.integers(0, n, size=5)])
    tnd, trows = tvops.topk_candidates_batch(
        torch.from_numpy(mat), torch.from_numpy(norms), torch.from_numpy(Q),
        n, torch.zeros(0, dtype=torch.int32), k=k, metric=metric)
    jnd, jrows = jvops.topk_candidates_batch(
        jnp.asarray(mat), jnp.asarray(norms), jnp.asarray(Q), jnp.int32(n),
        jnp.full((8,), mat.shape[0], jnp.int32), k=k, metric=metric,
        block=mat.shape[0])
    assert np.array_equal(trows.numpy(), np.asarray(jrows))
    _close(tnd.numpy(), np.asarray(jnd))
    for b in range(len(Q)):
        snd, srows = _torch_topk(mat, norms, Q[b], n, [], k, metric)
        assert np.array_equal(trows[b].numpy(), srows)
        assert np.array_equal(tnd[b].numpy(), snd)


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_topk_tie_order_is_list_position(metric):
    rng = np.random.default_rng(9)
    n, dim = 40, 8
    vecs = _int_matrix(rng, n, dim, distinct=3)
    mat, norms = _padded(vecs)
    R = mat.shape[0]
    cand = rng.permutation(n)[:30].astype(np.int32)   # list order, unsorted
    cr = np.full(32, R, np.int32)
    cr[: len(cand)] = cand
    q = vecs[int(cand[5])].copy()
    for k in (8, 16, 40):
        jnd, jrows = jvops.ivf_topk(jnp.asarray(mat), jnp.asarray(norms),
                                    jnp.asarray(q), jnp.asarray(cr), k=k,
                                    metric=metric)
        tnd, trows = tvops.ivf_topk(torch.from_numpy(mat),
                                    torch.from_numpy(norms),
                                    torch.from_numpy(q),
                                    torch.from_numpy(cr), k=k, metric=metric)
        assert np.array_equal(trows.numpy(), np.asarray(jrows)), k
        _close(tnd.numpy(), np.asarray(jnd))


@pytest.mark.parametrize("metric", METRICS)
def test_ann_expand_equals_jax(metric):
    rng = np.random.default_rng(13)
    n, dim, k = 60, 8, 16
    vecs = _int_matrix(rng, n, dim, distinct=7)
    mat, norms = _padded(vecs)
    R = mat.shape[0]
    vsubs = np.zeros(R, np.int32)
    vsubs[:n] = np.arange(1, n + 1) * 3
    # a CSR over every other vector subject (a candidate without a row
    # expands to nothing)
    csubs = vsubs[:n:2].copy()
    deg = rng.integers(0, 5, size=len(csubs))
    ptr = np.zeros(len(csubs) + 1, np.int32)
    np.cumsum(deg, out=ptr[1:])
    idx = rng.integers(1, 500, size=int(ptr[-1])).astype(np.int32)
    q = vecs[3].copy()
    ecap = 128
    jnd, juids, jres = jvops.ann_expand(
        jnp.asarray(mat), jnp.asarray(norms), jnp.asarray(q), jnp.int32(n),
        jnp.full((8,), R, jnp.int32), jnp.asarray(vsubs), jnp.asarray(csubs),
        jnp.asarray(ptr), jnp.asarray(idx), k=k, metric=metric, block=R,
        ecap=ecap)
    tnd, tuids, tres = tvops.ann_expand(
        torch.from_numpy(mat), torch.from_numpy(norms), torch.from_numpy(q),
        n, torch.zeros(0, dtype=torch.int32), torch.from_numpy(vsubs),
        torch.from_numpy(csubs), torch.from_numpy(ptr), torch.from_numpy(idx),
        k=k, metric=metric, ecap=ecap)
    _close(tnd.numpy(), np.asarray(jnd))
    assert np.array_equal(tuids.numpy(), np.asarray(juids))
    for f in ("targets", "seg", "counts", "total"):
        assert np.array_equal(getattr(tres, f).numpy(),
                              np.asarray(getattr(jres, f))), f


def test_capacity_classes_and_host_distances_equal_jax():
    for n in (0, 1, 7, 8, 1000, 1 << 20, (1 << 20) - 1):
        assert tvops.row_capacity(n) == jvops.row_capacity(n)
    for k in (1, 5, 10, 16, 100):
        for cap in (8, 64, 1 << 20):
            assert tvops.k_capacity(k, cap) == jvops.k_capacity(k, cap)
    rng = np.random.default_rng(2)
    x, q = rng.normal(size=(20, 6)), rng.normal(size=6)
    for m in METRICS:
        assert np.array_equal(tvops.host_distances(x, q, m),
                              jvops.host_distances(x, q, m))


def test_jit_program_families_are_the_jax_names():
    assert sorted(tvops.JIT_PROGRAMS) == sorted(jvops.JIT_PROGRAMS)


def test_tf32_is_off_and_checked():
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu = torch.zeros(2)
    tvops._check_fp32(cpu)           # CPU tensors have no TF32 path


# ---------------------------------------------------------------------------
# storage/vecindex
# ---------------------------------------------------------------------------

def _twin_index(vecs, metric, ivf=False, nprobe=0):
    subs = np.arange(1, len(vecs) + 1, dtype=np.int64) * 5
    jivf = jvx._build_ivf(vecs, metric) if ivf else None
    tivf = tvx._build_ivf(vecs, metric) if ivf else None
    j = jvx.VectorIndex("emb", JSpec(dim=vecs.shape[1], metric=metric), subs,
                        vecs, jivf, nprobe=nprobe)
    t = tvx.VectorIndex("emb", TSpec(dim=vecs.shape[1], metric=metric), subs,
                        vecs, tivf, nprobe=nprobe, device="cpu")
    return j, t


def _clustered(rng, n, dim, n_clusters=64, noise=0.15):
    centers = rng.normal(size=(n_clusters, dim))
    assign = rng.integers(0, n_clusters, size=n)
    return (centers[assign] +
            noise * rng.normal(size=(n, dim))).astype(np.float32), centers


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_ivf_lists_identical_to_jax(metric):
    rng = np.random.default_rng(21)
    vecs, _ = _clustered(rng, 3000, 16)
    j = jvx._build_ivf(vecs, metric)
    t = tvx._build_ivf(vecs, metric)
    assert np.array_equal(t.centroids, j.centroids)
    assert np.array_equal(t.list_indptr, j.list_indptr)
    assert np.array_equal(t.list_rows, j.list_rows)
    for c in (8, 40):
        assert np.array_equal(tvx._build_ivf(vecs, metric, c).list_rows,
                              jvx._build_ivf(vecs, metric, c).list_rows)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("path", ["host", "device", "ivf", "ivf_device"])
def test_search_equals_jax(metric, path, host_scan_max):
    rng = np.random.default_rng(31)
    vecs, centers = _clustered(rng, 900, 16, n_clusters=16)
    vecs[100:140] = vecs[7]             # 41 identical rows: ties past k'
    if path in ("device", "ivf_device"):
        host_scan_max(0)
    j, t = _twin_index(vecs, metric, ivf=path.startswith("ivf"))
    queries = [centers[i] + 0.1 * rng.normal(size=16) for i in range(6)]
    queries.append(vecs[7].astype(np.float64))
    for q in queries:
        for k in (1, 10, 45):
            ju, jd = jvx.search(j, q, k)
            tu, td = tvx.search(t, q, k)
            assert np.array_equal(tu, ju), (k, tu, ju)
            assert np.array_equal(td, jd)
    if path == "device" and metric != "dot":
        assert t._dev is not None
        assert tvx.search(t, vecs[7], 10)[0].tolist() == \
            [5 * r for r in (8, *range(101, 110))]


def test_ivf_recall_at_10():
    """The gate of tests/test_vector.py::test_ivf_recall_at_10 on the port:
    exact and IVF answers through vecindex.search."""
    rng = np.random.default_rng(21)
    vecs, centers = _clustered(rng, 5000, 16)
    _j, t = _twin_index(vecs, "l2", ivf=True)
    hits = total = 0
    for i in range(20):
        q = centers[i] + 0.15 * rng.normal(size=16)
        exact, _ = tvx.search(t, q, 10, exact=True)
        approx, _ = tvx.search(t, q, 10, exact=False)
        hits += len(set(exact.tolist()) & set(approx.tolist()))
        total += 10
    assert hits / total >= 0.95


@pytest.mark.parametrize("metric", METRICS)
def test_overlay_search_equals_jax_and_masks_dead_rows(metric,
                                                       host_scan_max):
    host_scan_max(0)
    rng = np.random.default_rng(41)
    vecs, centers = _clustered(rng, 400, 8, n_clusters=8)
    j, t = _twin_index(vecs, metric)
    from dgraph_tpu.utils.types import TypeID as JT, Val as JV
    from dgraph_tpu_torch.utils.types import TypeID as TT, Val as TV
    touched = np.asarray([5, 10, 15, 2005, 2010], np.int64)
    newv = rng.normal(size=(3, 8)).astype(np.float32)
    jhv = {5: JV(JT.VECTOR, tuple(newv[0].tolist())),
           2005: JV(JT.VECTOR, tuple(newv[1].tolist())),
           2010: JV(JT.VECTOR, tuple(newv[2].tolist()))}
    thv = {u: TV(TT.VECTOR, v.value) for u, v in jhv.items()}
    jo = jvx.stamp_vecindex(j, "emb", JSpec(dim=8, metric=metric), touched,
                            jhv)
    to = tvx.stamp_vecindex(t, "emb", TSpec(dim=8, metric=metric), touched,
                            thv)
    assert to.is_overlay and np.array_equal(to.dead_rows, jo.dead_rows)
    assert to.n == jo.n == 400 - 3 + 3
    for q in [centers[i] for i in range(4)] + [newv[1], vecs[1]]:
        for k in (5, 30):
            ju, jd = jvx.search(jo, q, k)
            tu, td = tvx.search(to, q, k)
            assert np.array_equal(tu, ju) and np.array_equal(td, jd)
            assert 10 not in tu.tolist() and 15 not in tu.tolist()


def test_kmeans_identical_to_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 12)).astype(np.float32)
    x[:50] = x[0]                        # empties re-seed from far points
    for k in (8, 33):
        assert np.array_equal(tvx._kmeans(x, k, 8, 7),
                              jvx._kmeans(x, k, 8, 7))


def test_fold_rejects_out_of_range_uid():
    from dgraph_tpu_torch.utils.types import TypeID, Val

    vals = {1: Val(TypeID.VECTOR, (0.5, 0.5)),
            2**31: Val(TypeID.VECTOR, (1.0, 0.0))}
    with pytest.raises(ValueError, match="device uid space"):
        tvx.build_vecindex("emb", TSpec(dim=2, metric="l2"), vals,
                           device="cpu")


def test_device_footprint_and_owner_protocol():
    rng = np.random.default_rng(1)
    _j, t = _twin_index(rng.normal(size=(100, 8)).astype(np.float32), "l2")
    R = tvx.vops.row_capacity(100)
    assert t.device_nbytes() == R * 8 * 4 + R * 4 + R * 4
    assert not t.device_resident() and t._res_kind == "vec"
    mat, norms, subs = t.device()
    assert mat.shape == (R, 8) and mat.dtype == torch.float32
    assert norms.shape == (R,) and subs.dtype == torch.int32
    assert t.device_resident()
    t.drop_device()
    assert not t.device_resident() and t._mesh is None


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tvx.VectorIndex("emb", TSpec(dim=2, metric="l2"),
                        np.ones(1, np.int64), np.ones((1, 2), np.float32))


# ---------------------------------------------------------------------------
# the Node: DQL, mutations, fusion, knobs, residency, batching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_max", [1 << 16, 0], ids=["host", "device"])
@pytest.mark.parametrize("metric", METRICS)
def test_golden_dql_forms_equal_jax(nodes, metric, scan_max, host_scan_max):
    host_scan_max(scan_max)
    j, t, _ = _pair(nodes, dim=4, n=30, metric=metric, seed=13)
    qv = _vec_str([0.5, -0.5, 1.0, 0.0])
    a = _same(j, t, f'{{ q(func: similar_to(emb, "{qv}", 5), '
                    f'orderasc: val(vector_distance)) '
                    f'{{ uid d : val(vector_distance) name }} }}')
    assert len(a["q"]) == 5
    _same(j, t, f'{{ q(func: similar_to(emb, "{qv}", 10), first: 3) '
                f'@filter(has(name)) {{ uid }} }}')
    _same(j, t, f'{{ q(func: similar_to(emb, 3, [0.5, -0.5, 1.0, 0.0])) '
                f'{{ uid }} }}')
    _same(j, t, f'{{ q(func: has(emb)) @filter(similar_to(emb, "{qv}", 5)) '
                f'{{ uid d : val(vector_distance) }} }}')
    _same(j, t, f'{{ a(func: uid(0x1)) {{ name }} '
                f'  r(func: has(name)) @filter(similar_to(emb, "{qv}", 2)) '
                f'{{ uid d : val(vector_distance) }} }}')
    _same(j, t, 'query q($v: string) { q(func: similar_to(emb, $v, 2)) '
                '{ uid name } }', variables={"$v": "[0.5, 0.5, 0.5, 0.5]"})
    _same(j, t, f'{{ q(func: similar_to(emb, "{qv}", 4)) '
                f'@filter(has(friend)) @recurse(depth: 2) '
                f'{{ name friend }} }}')
    _same(j, t, f'{{ q(func: similar_to(emb, "{qv}", 5)) {{ uid }} }}',
          explain=True)


def test_similar_to_typed_errors_equal_jax(nodes):
    from dgraph_tpu.query.task import TaskError as JErr
    from dgraph_tpu_torch.query.task import TaskError as TErr

    j, t, _ = _pair(nodes, dim=4, n=10, seed=2)
    for q in ('{ q(func: similar_to(emb, "[1, 2]", 3)) { uid } }',
              '{ q(func: similar_to(emb, "[1, 2, 3, 4]", 0)) { uid } }',
              '{ q(func: similar_to(name, "[1, 2, 3, 4]", 2)) { uid } }',
              '{ q(func: similar_to(emb, "[1, 2, 3, 4]")) { uid } }'):
        with pytest.raises(JErr) as je:
            j.query(q)
        with pytest.raises(TErr) as te:
            t.query(q)
        assert str(te.value) == str(je.value), q


def test_empty_vector_tablet_answers_nothing(nodes):
    for cls in (JNode, TNode):
        n = nodes(cls)
        n.alter(schema_text="emb: float32vector @index(vector(dim: 4)) .\n"
                            "name: string @index(exact) .")
        n.mutate(set_nquads='<0x1> <name> "a" .', commit_now=True)
        out, _ = n.query('{ q(func: similar_to(emb, "[1,2,3,4]", 5)) '
                         '{ uid } }', explain=True)
        assert out.get("q", []) == []
        assert n.metrics.counter(
            "dgraph_planner_fallbacks_total").value == 0


@pytest.mark.parametrize("metric", METRICS)
def test_fused_pipeline_equals_classic_and_jax(nodes, metric,
                                               host_scan_max):
    host_scan_max(0)
    j, t, rng = _pair(nodes, dim=8, n=60, metric=metric, seed=17,
                      span_sample=1.0)
    qv = _vec_str(rng.normal(size=8))
    q = (f'{{ q(func: similar_to(emb, "{qv}", 6)) '
         f'{{ uid friend {{ name }} }} }}')
    out = _same(j, t, q)
    assert t.metrics.counter(
        "dgraph_vector_fused_pipelines_total").value == 1
    idx = t.tracer.sink.index()
    rec = t.tracer.sink.get(
        next(r["trace_id"] for r in idx if r["root"] == "query"))
    kernels = [s["attrs"].get("kernel") for s in rec["spans"]
               if s["name"] == "device_kernel"]
    assert kernels == ["vector.ann_expand"], kernels
    # the classic stepped path (a root order only reorders) gives the same
    # uids and the same friends
    t.task_cache = t.result_cache = None
    out2, _ = t.query(f'{{ q(func: similar_to(emb, "{qv}", 6), '
                      f'orderasc: val(vector_distance)) '
                      f'{{ uid friend {{ name }} }} }}')
    assert sorted(e["uid"] for e in out2["q"]) == \
        sorted(e["uid"] for e in out["q"])
    fr = {e["uid"]: e.get("friend") for e in out["q"]}
    assert all(e.get("friend") == fr[e["uid"]] for e in out2["q"])


def test_fused_declines_on_ivf_and_below_cutover(nodes, host_scan_max):
    j, t, rng = _pair(nodes, dim=8, n=60, seed=17)
    qv = _vec_str(rng.normal(size=8))
    q = (f'{{ q(func: similar_to(emb, "{qv}", 6)) '
         f'{{ uid friend {{ name }} }} }}')
    _same(j, t, q)                           # 480 cells: host scan
    assert t.metrics.counter(
        "dgraph_vector_fused_pipelines_total").value == 0
    host_scan_max(0)
    j2, t2, _ = _pair(nodes, dim=8, n=60, seed=17, vector_ivf_min_rows=16)
    assert t2.snapshot().pred("emb").vecindex.ivf is not None
    _same(j2, t2, q)
    assert t2.metrics.counter(
        "dgraph_vector_fused_pipelines_total").value == 0
    assert t2.metrics.counter("dgraph_vector_ivf_probes_total").value >= 1


def test_vector_knobs_scoped_per_node(nodes):
    _j, a, _ = _pair(nodes, dim=4, n=40, seed=41, vector_ivf_min_rows=16,
                     vector_nprobe=2, vector_centroids=5)
    vi = a.snapshot().pred("emb").vecindex
    assert vi.ivf is not None and vi.ivf.n_lists == 5 and vi.nprobe == 2
    assert tvx.IVF_MIN_ROWS == 4096
    _j2, b, _ = _pair(nodes, dim=4, n=40, seed=41)
    assert b.snapshot().pred("emb").vecindex.ivf is None


@pytest.mark.parametrize("knobs", [
    dict(vector_nprobe=4), dict(vector_centroids=16),
    dict(vector_ivf_min_rows=10),
    dict(vector_ivf_min_rows=10, vector_centroids=4, vector_nprobe=1),
], ids=["nprobe", "centroids", "ivf_min_rows", "all"])
def test_knobs_answer_as_jax(nodes, knobs, host_scan_max):
    host_scan_max(0)
    j, t, rng = _pair(nodes, dim=8, n=80, seed=19, **knobs)
    for _ in range(3):
        qv = _vec_str(rng.normal(size=8))
        _same(j, t, f'{{ q(func: similar_to(emb, "{qv}", 7)) '
                    f'{{ uid d : val(vector_distance) }} }}')


def test_stamp_then_compaction_equal_fold_and_jax(nodes, host_scan_max):
    from dgraph_tpu_torch.storage.csr_build import build_pred

    host_scan_max(0)
    j, t, rng = _pair(nodes, dim=8, n=50, metric="cosine", seed=9)
    j.snapshot().pred("emb")
    t.snapshot().pred("emb")
    nv = rng.normal(size=8)
    q = _vec_str(rng.normal(size=8))
    stamps0 = t.metrics.counter("dgraph_overlay_stamps_total").value
    for node in (j, t):
        node.mutate(set_nquads=f'<0x999> <emb> "{_vec_str(nv)}" .\n'
                               f'<0x3> <emb> "{_vec_str(-nv)}" .',
                    commit_now=True)
    snap = t.snapshot()
    vi = snap.pred("emb").vecindex
    assert vi.is_overlay and len(vi.dead_rows) == 1
    assert t.metrics.counter("dgraph_overlay_stamps_total").value > stamps0
    fresh = build_pred(t.store, "emb", snap.read_ts, device="cpu").vecindex
    assert not fresh.is_overlay and fresh.n == vi.n == 51
    for k in (1, 12, 60):
        u1, d1 = tvx.search(vi, nv, k)
        u2, d2 = tvx.search(fresh, nv, k)
        assert np.array_equal(u1, u2) and np.array_equal(d1, d2)
    qq = (f'{{ q(func: similar_to(emb, "{q}", 12)) '
          f'{{ uid d : val(vector_distance) }} }}')
    _same(j, t, qq)
    for node in (j, t):
        node.mutate(del_nquads='<0x999> <emb> * .', commit_now=True)
    _same(j, t, qq)
    t._assembler.compact(t._lock, force=True)
    assert not t.snapshot().pred("emb").vecindex.is_overlay
    _same(j, t, qq)


def test_mutation_typed_errors_equal_jax(nodes):
    from dgraph_tpu.query.mutation import MutationError as JErr
    from dgraph_tpu_torch.query.mutation import MutationError as TErr

    ns = []
    for cls in (JNode, TNode):
        n = nodes(cls)
        n.alter(schema_text="emb: float32vector @index(vector(dim: 4)) .")
        n.mutate(set_nquads='<0x1> <emb> "[1, 2, 3, 4]" .', commit_now=True)
        ns.append(n)
    for kw in (dict(set_nquads='<0x2> <emb> "[1, 2]" .'),
               dict(set_json={"uid": "0x3",
                              "emb": [1.0, float("nan"), 2.0, 3.0]}),
               dict(set_json={"uid": "0x3", "emb": [1.0, 2.0]}),
               dict(set_nquads='<0x2> <emb> "[1, 2, x, 4]" .')):
        errs = []
        for n, E in zip(ns, (JErr, ValueError)):
            with pytest.raises(E) as ex:
                n.mutate(commit_now=True, **kw)
            errs.append((type(ex.value).__name__, str(ex.value)))
        assert errs[0] == errs[1], errs
    assert isinstance(TErr("x"), ValueError)
    for n in ns:
        n.mutate(set_json={"uid": "0x4", "emb": [4.0, 3.0, 2.0, 1.0]},
                 commit_now=True)
        n.mutate(set_nquads='<0x5> <emb> "[0.5, 1.5, -2, 1e-3]"'
                            '^^<xs:float32vector> .', commit_now=True)
    for q in ('{ q(func: uid(0x4, 0x5)) { emb } }',
              '{ q(func: has(emb)) { uid emb } }'):
        assert json.dumps(ns[0].query(q)[0]) == json.dumps(ns[1].query(q)[0])


def test_vector_values_over_the_wire_json(nodes):
    """A float32vector written through JSON reads back as one list, as a
    JAX Node writes it, and exports as the same RDF."""
    import tempfile
    from pathlib import Path

    from dgraph_tpu.loader.export import export_rdf as jexp
    from dgraph_tpu_torch.loader.export import export_rdf as texp

    outs = []
    for cls, exp in ((JNode, jexp), (TNode, texp)):
        n = nodes(cls)
        n.alter(schema_text="emb: float32vector @index(vector(dim: 3)) .")
        n.mutate(set_json=[{"uid": "0x1", "emb": [0.5, 1.5, -2.0]},
                           {"uid": "0x2", "emb": "[1, 2, 3]"}],
                 commit_now=True)
        with tempfile.TemporaryDirectory() as d:
            p = Path(d) / "out.rdf"
            exp(n.store, str(p))
            outs.append((n.query('{ q(func: has(emb)) { uid emb } }')[0],
                         p.read_text()))
    assert json.dumps(outs[0][0]) == json.dumps(outs[1][0])
    assert outs[0][1] == outs[1][1]


def test_stats_vector_entry_equal_jax(nodes):
    from dgraph_tpu.storage import stats as jst
    from dgraph_tpu_torch.storage import stats as tst

    j, t, _ = _pair(nodes, dim=4, n=10, seed=1)
    a = jst.pred_stats(j.snapshot().pred("emb")).to_dict()
    b = tst.pred_stats(t.snapshot().pred("emb")).to_dict()
    assert a == b and b["vector"] == {"rows": 10, "dim": 4}


def test_subscribe_similar_to_equals_jax(nodes):
    j, t, _ = _pair(nodes, dim=4, n=12, seed=5)
    q = '{ q(func: similar_to(emb, "[1, 0, 0, 0]", 3)) { uid } }'
    outs = []
    for n in (j, t):
        sub = n.subscribe(q)
        ev = sub.next(10)
        assert ev["type"] == "init"
        outs.append(json.dumps(ev["result"]))
        n.mutate(set_nquads='<0x99> <emb> "[1, 0, 0, 0]" .', commit_now=True)
        ev = sub.next(10)
        assert ev["type"] == "diff"
        outs.append(json.dumps({k: v for k, v in ev.items() if k != "sub"}))
        sub.cancel()
    assert outs[:2] == outs[2:]


def test_vec_residency_evict_readmit_and_cold(nodes, host_scan_max):
    """tests/test_residency.py::test_vector_evict_readmit_rank_identical on
    a port Node, its answers equal to a JAX Node's."""
    host_scan_max(1)
    ns = []
    for cls in (JNode, TNode):
        n = nodes(cls, device_budget_mb=512, task_cache_mb=0,
                  result_cache_mb=0)
        n.alter(schema_text="emb: float32vector @index(vector(dim: 8)) .")
        rng = np.random.default_rng(5)
        quads = []
        for i in range(1, 200):
            v = ", ".join(f"{x:.4f}" for x in rng.normal(size=8))
            quads.append(f'<{i:#x}> <emb> "[{v}]" .')
        n.mutate(set_nquads="\n".join(quads), commit_now=True)
        ns.append(n)
    j, t = ns
    qv = "[" + ", ".join(["0.1"] * 8) + "]"
    q = f'{{ q(func: similar_to(emb, "{qv}", 5)) {{ uid }} }}'
    want = _same(j, t, q)
    vi = t.snapshot().preds["emb"].vecindex
    assert vi._dev is not None and vi._res is t.residency
    adm = t.metrics.counter("dgraph_residency_admissions_total").value
    assert adm >= 1
    t.residency.evict_to(0)
    assert vi._dev is None
    assert t.metrics.counter("dgraph_residency_evictions_total").value >= 1
    assert t.query(q)[0] == want
    t.residency.budget = 64
    t.residency.evict_to(64)
    cold0 = t.metrics.counter("dgraph_residency_cold_serves_total").value
    assert t.query(q)[0] == want and vi._dev is None
    assert t.metrics.counter(
        "dgraph_residency_cold_serves_total").value == cold0 + 1


def test_vector_heavy_snapshot_counts_toward_enforce_memory(nodes):
    n = nodes(TNode)
    n.alter(schema_text="emb: float32vector @index(vector(dim: 64)) .")
    rng = np.random.default_rng(9)
    quads = []
    for i in range(1, 400):
        v = ", ".join(f"{x:.3f}" for x in rng.normal(size=64))
        quads.append(f'<{i:#x}> <emb> "[{v}]" .')
    n.mutate(set_nquads="\n".join(quads), commit_now=True)
    n.snapshot().pred("emb")
    vec_bytes = 399 * 64 * 4
    report = n.enforce_memory(
        budget_bytes=n.store.memory_stats()["bytes"] + vec_bytes // 4)
    assert report["fold_bytes"] >= vec_bytes
    assert report["dropped_caches"] > 0


def test_upload_fault_serves_the_host_scan(nodes, host_scan_max):
    from dgraph_tpu_torch.utils import faults

    host_scan_max(0)
    j, t, rng = _pair(nodes, dim=8, n=60, seed=4, task_cache_mb=0,
                      result_cache_mb=0)
    qs = [f'{{ q(func: similar_to(emb, "{_vec_str(rng.normal(size=8))}", 5)) '
          f'{{ uid friend {{ uid }} }} }}' for _ in range(2)]
    want = [t.query(q)[0] for q in qs]
    t.snapshot().pred("emb").vecindex.drop_device()
    faults.GLOBAL.install("residency.h2d_upload", mode="error", p=1.0)
    try:
        got = [t.query(q)[0] for q in qs]
    finally:
        faults.GLOBAL.clear()
    assert got == want
    for q, w in zip(qs, want):
        assert json.dumps(j.query(q)[0]) == json.dumps(w)


def _force_batcher(node, max_batch):
    node.batcher = DeviceBatcher(node.dispatch_gate, node.metrics,
                                 window_ms=1500, max_batch=max_batch,
                                 idle_fire=False)


def _concurrent(node, queries):
    outs = [None] * len(queries)
    errs = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def run(i):
        barrier.wait(timeout=30)
        try:
            outs[i] = node.query(queries[i])[0]
        except BaseException as e:     # noqa: BLE001 — surfaced to assert
            errs[i] = e

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(queries))]
    for th in ts:
        th.start()
    for th in ts:
        th.join(60)
    return outs, errs


@pytest.mark.parametrize("k", [5, 20], ids=["k5", "k20"])
def test_vector_topk_batches_byte_identical(nodes, k, host_scan_max,
                                            monkeypatch):
    """tests/test_batch.py::test_vector_topk_batches_byte_identical on a
    port Node: one batch.vector_topk dispatch of exactly the members, each
    answer equal to solo and to a JAX Node's."""
    host_scan_max(1)
    j = nodes(JNode, planner=False, task_cache_mb=0, result_cache_mb=0)
    t = nodes(TNode, planner=False, task_cache_mb=0, result_cache_mb=0)
    rng = np.random.default_rng(7)
    quads = []
    for i in range(1, 80):
        v = rng.normal(size=8).round(3).tolist()
        quads.append(f'<0x{i:x}> <emb> "{v}"^^<xs:float32vector> .')
    for n in (j, t):
        n.alter(schema_text="emb: float32vector @index(vector(dim: 8)) .")
        n.mutate(set_nquads="\n".join(quads), commit_now=True)
    queries = ['{ q(func: similar_to(emb, "%s", %d)) { uid } }'
               % (rng.normal(size=8).round(3).tolist(), k) for _ in range(3)]
    t.batcher = None
    solo = [t.query(q)[0] for q in queries]
    assert [json.dumps(s) for s in solo] == \
        [json.dumps(j.query(q)[0]) for q in queries]
    shapes = []
    real = tvops.topk_candidates_batch
    monkeypatch.setattr(tvops, "topk_candidates_batch",
                        lambda *a, **kw: shapes.append(tuple(a[2].shape))
                        or real(*a, **kw))
    _force_batcher(t, max_batch=3)
    outs, errs = _concurrent(t, queries)
    assert not any(errs), errs
    assert outs == solo
    assert shapes == [(3, 8)]          # no power-of-two padding
    occ = t.metrics.histogram("dgraph_batch_occupancy").snapshot()
    assert occ["max"] == 3, occ


@pytest.mark.parametrize("case,reason", [
    ("ivf", "vector_variant"), ("overlay", "vector_variant"),
    ("host", "host_path"), ("cold", "vector_cold"),
])
def test_batch_vector_classification_equals_jax(nodes, case, reason,
                                                host_scan_max):
    from dgraph_tpu.query import batch as jbatch
    from dgraph_tpu.query.task import TaskQuery as JTQ
    from dgraph_tpu_torch.query import batch as tbatch
    from dgraph_tpu_torch.query.task import TaskQuery as TTQ

    host_scan_max(1 << 16 if case == "host" else 1)
    kw = dict(vector_ivf_min_rows=16) if case == "ivf" else {}
    if case == "cold":
        kw = dict(device_budget_mb=1)
    j, t, rng = _pair(nodes, dim=8, n=60, seed=8, **kw)
    if case == "overlay":
        for n in (j, t):
            n.snapshot().pred("emb")
            n.mutate(set_nquads='<0x2> <emb> "[1,1,1,1,1,1,1,1]" .',
                     commit_now=True)
    if case == "cold":
        for n in (j, t):
            n.snapshot().pred("emb")
            n.residency.budget = 64
    args = [_vec_str(rng.normal(size=8)), 5]
    got = []
    for n, mod, TQ in ((j, jbatch, JTQ), (t, tbatch, TTQ)):
        key, kind, _ = mod.classify(n.snapshot(), n.store.schema,
                                    TQ("emb", func=("similar_to", args)))
        got.append((key is None, kind))
    assert got[0] == got[1] == (True, reason)
    assert tbatch.classify(t.snapshot(), t.store.schema, TTQ(
        "emb", func=("similar_to", ["[1, 2]", 5])))[1] == "vector_solo"


def test_vector_counters_reach_metrics_as_in_jax(nodes, host_scan_max):
    """dgraph_vector_* counters move on the Node's registry and render on
    /metrics (prom text) and /debug/vars, as the JAX server's do."""
    from dgraph_tpu.obs import prom as jprom
    from dgraph_tpu_torch.obs import prom as tprom

    host_scan_max(0)
    j, t, rng = _pair(nodes, dim=8, n=60, seed=12, vector_ivf_min_rows=16)
    qv = _vec_str(rng.normal(size=8))
    _same(j, t, f'{{ q(func: similar_to(emb, "{qv}", 4)) {{ uid }} }}')
    got = []
    for n, prom in ((j, jprom), (t, tprom)):
        series = prom.parse(prom.render(n.metrics))
        got.append({name: series[name][0][1] for name in (
            "dgraph_vector_searches_total", "dgraph_vector_ivf_probes_total",
            "dgraph_vector_fused_pipelines_total")})
        assert n.metrics.to_dict()["dgraph_vector_searches_total"] == 1
    assert got[0] == got[1]
    assert got[1]["dgraph_vector_searches_total"] == 1
    assert got[1]["dgraph_vector_ivf_probes_total"] == 1
