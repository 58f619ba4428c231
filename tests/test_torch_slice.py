"""The port's uid-traversal slice against the JAX package, on the CPU.

The same numpy CSRs go to both packages (the port's through
dgraph_tpu_torch/carry.py), with KERNEL_MIN_EDGES = 0 on both sides so
@recurse runs the kernel path (Pallas interpret mode on the JAX side, the
plain PyTorch kernels on the port's). Results must be equal exactly: uid
sets, traversed-edge counts, per-edge fresh flags, and byte-identical JSON.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dgraph_tpu.models.rmat import rmat_csr
from dgraph_tpu.ops import csr as jcsr
from dgraph_tpu.ops import pallas_bfs as jpb
from dgraph_tpu.ops import uidset as jus
from dgraph_tpu.query import dql as jdql
from dgraph_tpu.query import engine as jeng
from dgraph_tpu.query import recurse as jrec
from dgraph_tpu.query import task as jtask
from dgraph_tpu.storage import csr_build as jcb
from dgraph_tpu.utils import schema as jschema
from dgraph_tpu.utils.types import TypeID as JTypeID

from dgraph_tpu_torch import carry
from dgraph_tpu_torch.ops import csr as tcsr
from dgraph_tpu_torch.ops import pull_bfs as tpb
from dgraph_tpu_torch.ops import uidset as tus
from dgraph_tpu_torch.query import dql as tdql
from dgraph_tpu_torch.query import engine as teng
from dgraph_tpu_torch.query import recurse as trec
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.storage import csr_build as tcb
from dgraph_tpu_torch.utils import schema as tschema

REPO = Path(__file__).resolve().parents[1]
SCHEMA = "follow: [uid] @reverse .\nknows: [uid] ."


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's intra-op pool, and the tier-1
    run shares the cores with timing-sensitive tests in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _csr(src, dst):
    """Sorted-unique (src, dst) pairs -> int32 (subjects, indptr, indices)."""
    pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
    subjects, counts = np.unique(pairs[:, 0], return_counts=True)
    indptr = np.zeros(len(subjects) + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return (subjects.astype(np.int32), indptr, pairs[:, 1].astype(np.int32))


def _graph(seed=42, n=48):
    """follow/knows edges among uids 1..n (the shape of
    tests/test_recurse_kernel.py's graph), with follow's reverse CSR."""
    rng = np.random.default_rng(seed)
    out = {}
    for attr, m in (("follow", n * 3), ("knows", n * 2)):
        a = rng.integers(1, n + 1, m)
        b = rng.integers(1, n + 1, m)
        keep = a != b
        out[attr] = _csr(a[keep], b[keep])
        if attr == "follow":
            out["~follow"] = _csr(b[keep], a[keep])
    return out


def _both(arrays):
    """(JAX snapshot, port snapshot on the CPU) over the same arrays."""
    jsnap = jcb.GraphSnapshot(1)
    for attr, (s, p, x) in arrays.items():
        if attr.startswith("~"):
            jsnap.preds[attr[1:]].rev_csr = jcb.PredCSR(s, p, x)
        else:
            jsnap.preds[attr] = jcb.PredData(attr, JTypeID.UID,
                                             csr=jcb.PredCSR(s, p, x))
    preds = {attr: (int(JTypeID.UID), s, p, x)
             for attr, (s, p, x) in arrays.items()}
    tsnap = carry.snapshot_from_numpy(preds, 1, device="cpu")
    return jsnap, tsnap


def _schemas():
    js, ts = jschema.SchemaState(), tschema.SchemaState()
    for e in jschema.parse_schema(SCHEMA):
        js.set(e)
    for e in tschema.parse_schema(SCHEMA):
        ts.set(e)
    return js, ts


@pytest.fixture
def kernels_on(monkeypatch):
    monkeypatch.setattr(jrec, "KERNEL_MIN_EDGES", 0)
    monkeypatch.setattr(trec, "KERNEL_MIN_EDGES", 0)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_prep_pull_and_carry_match_jax():
    s, p, x = rmat_csr(10, 8, seed=3)
    n = int(max(s.max(), x.max())) + 1
    jg = jpb.prep_pull(s, p, x, n, with_host_arrays=True)
    tg = tpb.prep_pull(s, p, x, n, with_host_arrays=True, device="cpu")
    cg = carry.pull_graph_from_numpy(
        {k: (None if v is None else np.asarray(v))
         for k, v in jg._asdict().items()}, device="cpu")
    for name, want in jg._asdict().items():
        for got in (getattr(tg, name), getattr(cg, name)):
            if isinstance(got, torch.Tensor):
                assert got.dtype == torch.int32, name
                got = got.numpy()
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=name)


@pytest.mark.parametrize("n_seeds,hops,explicit", [
    (16, 3, True), (16, 3, False), (1500, 2, True), (1500, 2, False),
    (0, 2, True), (16, 0, False)])
def test_k_hop_matches_jax(n_seeds, hops, explicit):
    """Push, sparse and dense hops: visited, frontier and traversed equal."""
    s, p, x = rmat_csr(12, 8, seed=5)
    n = int(max(s.max(), x.max())) + 2
    rng = np.random.default_rng(n_seeds)
    seeds = np.unique(rng.choice(s, size=n_seeds, replace=False)) \
        if n_seeds else np.zeros(0, np.int64)
    mask = np.zeros(n, dtype=bool)
    mask[seeds] = True
    jg = jpb.prep_pull(s, p, x, n)
    tg = carry.pull_graph_from_numpy(
        {k: (None if v is None else np.asarray(v))
         for k, v in jg._asdict().items()}, device="cpu")
    kw = {"seed_uids": seeds} if explicit else {}
    want = jpb.k_hop_pull_pallas(jg, jnp.asarray(mask), hops=hops, **kw)
    got = tpb.k_hop_pull_pallas(tg, torch.from_numpy(mask), hops=hops, **kw)
    np.testing.assert_array_equal(got.visited.numpy(),
                                  np.asarray(want.visited))
    np.testing.assert_array_equal(got.frontier.numpy(),
                                  np.asarray(want.frontier))
    assert int(got.traversed) == int(want.traversed)


@pytest.mark.parametrize("allow_loop", [False, True])
def test_recurse_fused_and_step_match_jax(allow_loop):
    s, p, x = rmat_csr(11, 8, seed=9)
    n = int(max(s.max(), x.max())) + 1
    jg = jpb.prep_pull(s, p, x, n, with_host_arrays=True)
    tg = tpb.prep_pull(s, p, x, n, with_host_arrays=True, device="cpu")
    rng = np.random.default_rng(1)
    mask = np.zeros(n, dtype=bool)
    mask[rng.choice(s, 24, replace=False)] = True
    want = jpb.recurse_fused(
        jg.in_src_pad, jg.in_src_pad_d, jg.in_iptr_rank, jg.subjects,
        jg.in_subjects, jnp.asarray(mask), depth=3, chunks=jg.chunks,
        chunks_d=jg.chunks_d, allow_loop=allow_loop)
    got = tpb.recurse_fused(
        tg.in_src_pad, tg.in_src_pad_d, tg.in_iptr_rank, tg.subjects,
        tg.in_subjects, torch.from_numpy(mask), depth=3, chunks=tg.chunks,
        chunks_d=tg.chunks_d, allow_loop=allow_loop)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    seen = rng.random(len(tg.in_src_pad)) < 0.2
    fmask = rng.random(n) < 0.01
    want = jpb.recurse_step(
        jg.in_src_pad, jg.in_iptr_rank, jg.subjects, jg.in_subjects,
        jnp.asarray(fmask), jnp.asarray(seen), chunks=jg.chunks,
        num_nodes=n, allow_loop=allow_loop)
    got = tpb.recurse_step(
        tg.in_src_pad, tg.in_iptr_rank, tg.subjects, tg.in_subjects,
        torch.from_numpy(fmask), torch.from_numpy(seen), chunks=tg.chunks,
        num_nodes=n, allow_loop=allow_loop)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("out_cap", [16, 4096])
def test_csr_expand_and_degrees_match_jax(out_cap):
    s, p, x = rmat_csr(9, 8, seed=2)
    rng = np.random.default_rng(out_cap)
    rows = rng.integers(0, len(s), 40).astype(np.int32)
    rows[::7] = np.iinfo(np.int32).max           # sentinel slots
    want = jcsr.expand(jnp.asarray(p), jnp.asarray(x), jnp.asarray(rows),
                       out_cap)
    got = tcsr.expand(torch.from_numpy(p), torch.from_numpy(x),
                      torch.from_numpy(rows), out_cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tcsr.degrees(torch.from_numpy(p), torch.from_numpy(rows)).numpy(),
        np.asarray(jcsr.degrees(jnp.asarray(p), jnp.asarray(rows))))


def test_uidset_algebra_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 400, 150)
    b = rng.integers(0, 400, 220)
    ja, jb = jus.make_set(a, 256), jus.make_set(b, 256)
    ta = tus.make_set(a, 256, device="cpu")
    tb = tus.make_set(b, 256, device="cpu")
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for jf, tf in ((jus.intersect, tus.intersect),
                   (jus.difference, tus.difference),
                   (jus.merge, tus.merge)):
        np.testing.assert_array_equal(tf(ta, tb).numpy(),
                                      np.asarray(jf(ja, jb)))
    np.testing.assert_array_equal(tus.to_numpy(tus.merge(ta, tb)),
                                  jus.to_numpy(jus.merge(ja, jb)))
    assert int(tus.size(ta)) == int(jus.size(ja))
    for jf, tf in ((jus.intersect_host, tus.intersect_host),
                   (jus.union_host, tus.union_host),
                   (jus.difference_host, tus.difference_host)):
        np.testing.assert_array_equal(tf(a, b, "cpu"), jf(a, b))


def test_transpose_csr_matches_reverse_fold():
    arrays = _graph(7)
    got = tcb.transpose_csr(*arrays["follow"])
    for g, w in zip(got, arrays["~follow"]):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the slice end to end: Executor.execute JSON
# ---------------------------------------------------------------------------

QUERIES = [
    # fused shape: single uid child, no filter
    "{ q(func: uid(0x1, 0x2)) @recurse(depth: 3) { follow } }",
    "{ q(func: uid(0x1)) @recurse(depth: 4, loop: true) { follow } }",
    # stepped: two uid children
    "{ q(func: uid(0x1, 0x3)) @recurse(depth: 3) { follow knows } }",
    # filter on the uid child
    "{ q(func: uid(0x1)) @recurse(depth: 3) { follow @filter(uid(%s)) } }"
    % ", ".join(hex(u) for u in range(2, 49, 2)),
    # reverse edge
    "{ q(func: uid(0x5)) @recurse(depth: 2) { ~follow } }",
    # until exhaustion (stepped: depth cap 64 exceeds FUSED_MAX_DEPTH); the
    # JAX engine renders a recurse that runs out of fresh edges as {}, and
    # the port keeps that answer
    "{ q(func: uid(0x1)) @recurse { follow } }",
    # plain uid expands, counts, pagination, vars, not-filter, cascade
    "{ q(func: uid(0x1, 0x2, 0x3)) { uid follow { uid knows { uid } } } }",
    "{ q(func: uid(0x1, 0x2)) { count(follow) follow (first: 2) { uid } } }",
    "{ a as var(func: uid(0x1)) { f as follow } "
    "  q(func: uid(f)) @filter(not uid(0x3)) { uid ~follow { uid } } }",
    "{ q(func: uid(0x1, 0x2, 0x9), first: 2) @cascade { uid knows { uid } } }",
    "{ q(func: uid(0x4)) { expand(_all_) { uid } } }",
    "{ q(func: uid(0x1, 0x2, 0x3)) @filter(uid_in(follow, 0x14, 0x27)) "
    "{ uid } }",
]


EXHAUSTED = 5


def _run_both(arrays, q):
    jsnap, tsnap = _both(arrays)
    js, ts = _schemas()
    want = json.dumps(jeng.Executor(jsnap, js).execute(jdql.parse(q)))
    got = json.dumps(teng.Executor(tsnap, ts).execute(tdql.parse(q)))
    return want, got


@pytest.mark.parametrize("qidx", range(len(QUERIES)))
@pytest.mark.parametrize("path", ["kernel", "host"])
def test_execute_json_byte_identical(qidx, path, monkeypatch):
    if path == "kernel":
        monkeypatch.setattr(jrec, "KERNEL_MIN_EDGES", 0)
        monkeypatch.setattr(trec, "KERNEL_MIN_EDGES", 0)
        monkeypatch.setattr(jtask, "HOST_EXPAND_MAX", 0)
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    want, got = _run_both(_graph(), QUERIES[qidx])
    assert got == want
    if qidx != EXHAUSTED:
        assert len(json.loads(got).get("q", [])) > 0


def test_execute_rmat_recurse_byte_identical(kernels_on):
    """The bench shape at a small scale: 16 R-MAT seeds, depth 3."""
    s, p, x = rmat_csr(10, 8, seed=7)
    seeds = np.unique(np.random.default_rng(3).choice(s, 16, replace=False))
    q = "{ q(func: uid(%s)) @recurse(depth: 3) { friend } }" % \
        ", ".join(hex(int(u)) for u in seeds)
    arrays = {"friend": (s, p, x)}
    jsnap, tsnap = _both(arrays)
    js, ts = jschema.SchemaState(), tschema.SchemaState()
    js.set(jschema.parse_schema("friend: [uid] .")[0])
    ts.set(tschema.parse_schema("friend: [uid] .")[0])
    want = json.dumps(jeng.Executor(jsnap, js).execute(jdql.parse(q)))
    got = json.dumps(teng.Executor(tsnap, ts).execute(tdql.parse(q)))
    assert got == want


def test_edge_budget_error(kernels_on):
    old = teng.MAX_QUERY_EDGES
    teng.set_query_edge_limit(5)
    jeng.set_query_edge_limit(5)
    try:
        jsnap, tsnap = _both(_graph())
        js, ts = _schemas()
        q = "{ q(func: uid(0x1, 0x2)) @recurse(depth: 3) { follow } }"
        with pytest.raises(jeng.QueryError, match="ErrTooBig"):
            jeng.Executor(jsnap, js).execute(jdql.parse(q))
        with pytest.raises(teng.QueryError, match="ErrTooBig"):
            teng.Executor(tsnap, ts).execute(tdql.parse(q))
    finally:
        teng.set_query_edge_limit(old)


def test_fused_path_one_call(kernels_on, monkeypatch):
    """The single-child no-filter shape makes ONE recurse_fused call."""
    calls = {"fused": 0, "step": 0}
    real_fused, real_step = tpb.recurse_fused, tpb.recurse_step
    monkeypatch.setattr(tpb, "recurse_fused", lambda *a, **k: (
        calls.__setitem__("fused", calls["fused"] + 1) or real_fused(*a, **k)))
    monkeypatch.setattr(tpb, "recurse_step", lambda *a, **k: (
        calls.__setitem__("step", calls["step"] + 1) or real_step(*a, **k)))
    _, tsnap = _both(_graph())
    _, ts = _schemas()
    ex = lambda q: teng.Executor(tsnap, ts).execute(tdql.parse(q))
    ex("{ q(func: uid(0x1, 0x2)) @recurse(depth: 3) { follow } }")
    assert calls == {"fused": 1, "step": 0}
    ex("{ q(func: uid(0x1)) @recurse(depth: 3) { follow knows } }")
    assert calls["fused"] == 1 and calls["step"] > 0


def test_unported_branches_raise():
    """Every branch of this slice's engine is ported: similar_to, at the
    root or in a filter, over a predicate with no vector index raises the
    JAX package's typed error, not NotImplementedError."""
    from dgraph_tpu.query.task import TaskError as JTaskError
    from dgraph_tpu_torch.query.task import TaskError as TTaskError

    jsnap, tsnap = _both(_graph())
    js, ts = _schemas()
    for q in ('{ q(func: similar_to(follow, "[1, 2]", 2)) { uid } }',
              '{ q(func: uid(0x1, 0x2)) @filter(similar_to(follow, '
              '"[1, 2]", 2)) { uid } }'):
        with pytest.raises(TTaskError) as te:
            teng.Executor(tsnap, ts).execute(tdql.parse(q))
        with pytest.raises(JTaskError) as je:
            jeng.Executor(jsnap, js).execute(jdql.parse(q))
        assert str(te.value) == str(je.value)
        assert "vector" in str(te.value)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = _graph()
    preds = {a: (int(JTypeID.UID), *v) for a, v in arrays.items()}
    with pytest.raises(RuntimeError, match="cuda"):
        carry.snapshot_from_numpy(preds, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        tpb.prep_pull(*arrays["follow"], 64)
    with pytest.raises(RuntimeError, match="cuda"):
        tcb.PredCSR(*arrays["follow"])


# ---------------------------------------------------------------------------
# the port never loads jax or the JAX package
# ---------------------------------------------------------------------------

_GUARD = r"""
import json, sys
before = set(sys.modules)
from dgraph_tpu_torch import carry
from dgraph_tpu_torch.models.rmat import rmat_csr
from dgraph_tpu_torch.ops import traversal
from dgraph_tpu_torch.query import dql, recurse, shortest
from dgraph_tpu_torch.query.engine import Executor
from dgraph_tpu_torch.utils.schema import SchemaState, parse_schema
s, p, x = rmat_csr(8, 4, seed=1)
snap = carry.snapshot_from_numpy({"friend": (8, s, p, x)}, 1, device="cpu")
schema = SchemaState()
schema.set(parse_schema("friend: [uid] .")[0])
recurse.KERNEL_MIN_EDGES = 0
q = "{ q(func: uid(%s)) @recurse(depth: 3) { friend } }" % hex(int(s[0]))
out = Executor(snap, schema).execute(dql.parse(q))
shortest.DEVICE_SSSP_MIN_EDGES = shortest.SSSP_KERNEL_MIN = 0
q = "{ shortest(from: %s, to: %s) { friend } }" % (hex(int(s[0])),
                                                   hex(int(x[-1])))
out["path"] = Executor(snap, schema).execute(dql.parse(q))
from dgraph_tpu_torch.storage.csr_build import build_value_pred
from dgraph_tpu_torch.utils.types import TypeID, Val
schema.set(parse_schema("age: int @index(int) .")[0])
snap.preds["age"] = build_value_pred(
    "age", schema.get("age"),
    [(int(u), Val(TypeID.INT, int(u) % 7), "", ()) for u in s], device="cpu")
q = ("{ var(func: ge(age, 3)) { a as age m as math(a * 2) } "
     "q(func: uid(m), orderdesc: val(m), first: 3) { uid age val(m) "
     "friend @filter(lt(age, 4)) { uid } } s() { n: sum(val(a)) } }")
out["values"] = Executor(snap, schema).execute(dql.parse(q))
from dgraph_tpu_torch.query import mutation, rdf
from dgraph_tpu_torch.storage import delta, native
from dgraph_tpu_torch.storage.csr_build import SnapshotAssembler
from dgraph_tpu_torch.storage.postings import Op
from dgraph_tpu_torch.storage.store import Store
store = Store()
for e in parse_schema("friend: [uid] @reverse .\nage: int @index(int) ."):
    store.set_schema(e)
asm = SnapshotAssembler(store, device="cpu")
for ts, nq in ((2, '<0x1> <friend> <0x2> .\n<0x1> <age> "5"^^<xs:int> .'),
               (4, '<0x1> <friend> <0x3> .')):
    edges = mutation.to_edges(rdf.parse(nq), {}, Op.SET)
    touched, _, _ = mutation.apply_mutations(store, edges, ts - 1)
    store.commit(ts - 1, ts, touched)
    asm.snapshot(ts).pred("friend")
q = "{ q(func: uid(0x1)) { age friend { uid } } }"
out["store"] = Executor(asm.snapshot(4), schema).execute(dql.parse(q))
overlaid = isinstance(asm.snapshot(4).pred("friend").csr, delta.OverlayCSR)
nat = native.available()
from dgraph_tpu_torch.storage import vecindex
vschema = SchemaState()
vschema.set(parse_schema(
    "emb: float32vector @index(vector(dim: 2, metric: l2)) .")[0])
vstore = Store()
vstore.set_schema(vschema.get("emb"))
vasm = SnapshotAssembler(vstore, device="cpu")
nq = "\n".join('<%s> <emb> "[%d, %d]" .' % (hex(i), i, -i)
               for i in range(1, 30))
touched, _, _ = mutation.apply_mutations(
    vstore, mutation.to_edges(rdf.parse(nq), {}, Op.SET), 1)
vstore.commit(1, 2, touched)
vecindex.HOST_SCAN_MAX = 0
q = ('{ q(func: similar_to(emb, "[3, -3]", 2)) '
     '{ uid d : val(vector_distance) } }')
out["vector"] = Executor(vasm.snapshot(2), vschema).execute(dql.parse(q))
import os, tempfile
from concurrent.futures import ProcessPoolExecutor
import multiprocessing as mp
from dgraph_tpu_torch.loader import bulk
from dgraph_tpu_torch.ops import packed_decode
tmp = tempfile.mkdtemp()
with open(os.path.join(tmp, "g.rdf"), "w") as f:
    f.write("\n".join("<_:n%d> <friend> <_:n%d> ." % (i, (i * 7) % 50)
                      for i in range(200)))
bst = bulk.bulk_load(os.path.join(tmp, "g.rdf"), "friend: [uid] .",
                     os.path.join(tmp, "p"), workers=2)
Store(os.path.join(tmp, "p")).close()          # the output opens
with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
    list(ex.map(bulk._parse_chunk, [b"<_:a> <p> <_:b> ."]))
    worker_torch = ex.submit(eval, "'torch' in __import__('sys').modules"
                             ).result()
import numpy as np
from dgraph_tpu_torch.storage import packed
dec = packed_decode.unpack_device(packed_decode.to_device(
    packed.pack(np.arange(3, 900, 7, dtype=np.uint64)), device="cpu"))
out["packed"] = int((dec != 2**31 - 1).sum())
from dgraph_tpu_torch.api.server import Node
mn = Node(device="cpu", mesh_devices=4, mesh_min_edges=1, planner=False)
mn.alter(schema_text="friend: [uid] .")
mn.mutate(set_nquads="\n".join("<%s> <friend> <%s> ." % (hex(int(a)), hex(int(b)))
                               for a, b in zip(np.repeat(s, np.diff(p)), x)),
          commit_now=True)
mq = "{ q(func: uid(%s)) { friend { friend { uid } } } }" % hex(int(s[0]))
mesh_out = mn.query(mq)[0] == Executor(snap, schema).execute(dql.parse(mq))
mesh_out = (mesh_out, mn.metrics.counter(
    "dgraph_mesh_fused_queries_total").value,
    mn.analytics("cc", "friend")["device"])
mn.close()
from dgraph_tpu_torch.coord.cluster import Cluster
from dgraph_tpu_torch.coord.replication import ReplicaGroup
from dgraph_tpu_torch.coord.zero import Zero
from dgraph_tpu_torch.coord.zero_service import serve_zero
from dgraph_tpu_torch.parallel.client import ClusterClient
from dgraph_tpu_torch.parallel.remote import serve_worker
from dgraph_tpu_torch.parallel.mesh import make_mesh
from dgraph_tpu_torch.parallel.worker import distribute_snapshot
from dgraph_tpu_torch.protos import internal_pb2
wz = Zero(2)
wz.move_tablet("friend", 0)
wz.move_tablet("age", 1)
zsrv, zport, _ = serve_zero(wz, "localhost:0")
wsrv = []
for g in range(2):
    ws = Store()
    for e in parse_schema("friend: [uid] .\nage: int ."):
        ws.set_schema(e)
    wsrv.append(serve_worker(ws, "localhost:0", device="cpu"))
cc = ClusterClient("localhost:%d" % zport,
                   {g: ["localhost:%d" % wsrv[g][1]] for g in range(2)})
cc.mutate(set_nquads='<0x1> <friend> <0x2> .\n<0x2> <age> "7"^^<xs:int> .')
out["wire"] = cc.query("{ q(func: uid(0x1)) { friend { age } } }")
cc.close()
for w, _p in wsrv:
    w.stop(0)
zsrv.stop(0)
cl = Cluster(2, device="cpu")
cl.alter("friend: [uid] .")
cl.mutate(set_nquads="<0x1> <friend> <0x2> .")
out["cluster"] = cl.query("{ q(func: uid(0x1)) { friend { uid } } }")
rg = ReplicaGroup(tempfile.mkdtemp(), n=3, serve_reads=True, device="cpu")
rg.close()
dsnap = distribute_snapshot(snap, make_mesh(2, devices=["cpu"] * 2))
libs = [ln.split()[-1] for ln in open("/proc/self/maps") if "libdgt" in ln]
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib")
             or m == "dgraph_tpu" or m.startswith("dgraph_tpu."))
print(json.dumps({"bad": bad, "levels": len(json.dumps(out)),
                  "store": out["store"], "overlaid": overlaid,
                  "native": nat, "libs": sorted(set(libs)),
                  "vector": out["vector"], "bulk_edges": bst.uid_edges,
                  "worker_torch": worker_torch, "packed": out["packed"],
                  "mesh": mesh_out, "wire": out["wire"],
                  "cluster": out["cluster"],
                  "pb": internal_pb2.TaskRequest.DESCRIPTOR.full_name}))
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["levels"] > 20
    # the write path: store, commit, an overlay stamp, a read of both writes
    assert res["store"] == {"q": [{"age": 5, "friend": [{"uid": "0x2"},
                                                       {"uid": "0x3"}]}]}
    assert res["overlaid"]
    # similar_to through the device-class scan (torch ops on the CPU)
    assert res["vector"] == {"q": [{"uid": "0x2", "d": 2.0},
                                   {"uid": "0x3", "d": 0.0}]}
    # bulk_load with two spawned parse workers, which never load torch
    assert res["bulk_edges"] == 200 and res["worker_torch"] is False
    assert res["packed"] == len(range(3, 900, 7))
    # a mesh Node: the fused chain's JSON equals the unsharded Executor's,
    # and analytics runs on the mesh
    assert res["mesh"] == [True, 1, True]
    # the wire cluster: a port Zero, two port workers and a ClusterClient
    # over loopback gRPC; the embedded Cluster; the wire's package name
    assert res["wire"] == {"q": [{"friend": [{"age": 7}]}]}
    assert res["cluster"] == {"q": [{"friend": [{"uid": "0x2"}]}]}
    assert res["pb"] == "dgraph_tpu.internal.TaskRequest"
    # the port's own codec build, never the JAX package's native/libdgt.so
    assert res["native"] and res["libs"]
    for lib in res["libs"]:
        assert Path(lib).parent == REPO / "build" / "dgraph_tpu_torch", lib


def test_port_sources_import_no_jax():
    bad = []
    scripts = [REPO / "chip_smoke.py", *REPO.glob("bench_torch_*.py")]
    for path in sorted((REPO / "dgraph_tpu_torch").rglob("*.py")) + scripts:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "dgraph_tpu"):
                    bad.append(f"{path.relative_to(REPO)}: {name}")
    assert bad == []
    scanned = {p.relative_to(REPO / "dgraph_tpu_torch").as_posix()
               for p in (REPO / "dgraph_tpu_torch").rglob("*.py")}
    assert {"query/engine.py", "ops/vector.py", "storage/vecindex.py",
            "ops/packed_decode.py", "ingest/spill.py", "loader/bulk.py",
            "loader/live.py", "loader/xidmap.py", "loader/convert.py",
            "models/ldbc.py", "models/film.py", "parallel/mesh.py",
            "parallel/dist.py", "parallel/mesh_exec.py",
            "query/fusedplan.py", "query/analytics.py",
            "coord/placement.py", "protos/internal_pb2.py",
            "parallel/remote.py", "parallel/client.py", "parallel/worker.py",
            "coord/zero_service.py", "coord/cluster.py",
            "coord/replication.py", "utils/ballot.py"} <= scanned


@pytest.mark.parametrize("scale,ef,seed", [(6, 4, 1), (10, 16, 7), (12, 8, 9),
                                           (14, 16, 3)])
def test_rmat_matches_jax(scale, ef, seed):
    """The port's generator (a packed 1-D dedup) gives the JAX package's
    edges and CSR exactly."""
    from dgraph_tpu.models import rmat as jrmat
    from dgraph_tpu_torch.models import rmat as trmat

    assert np.array_equal(trmat.rmat_edges(scale, ef, seed=seed),
                          jrmat.rmat_edges(scale, ef, seed=seed))
    assert np.array_equal(trmat.rmat_edges(scale, ef, seed=seed, dedup=False),
                          jrmat.rmat_edges(scale, ef, seed=seed, dedup=False))
    for got, want in zip(trmat.rmat_csr(scale, ef, seed=seed),
                         jrmat.rmat_csr(scale, ef, seed=seed)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n,hi", [(0, 1), (1, 1), (50, 10), (1000, 800),
                                  (1000, 1000), (1000, 8000), (1000, 1 << 40)])
def test_unique_uids_equals_np_unique(n, hi):
    """engine._unique_union of one array (a bitmap where the uids are
    dense) is np.unique, on both sides of its density rule."""
    rng = np.random.default_rng(n + hi)
    uids = rng.integers(0, hi, n).astype(np.int64)
    got = teng._unique_union([uids])
    assert got.dtype == np.int64 and np.array_equal(got, np.unique(uids))


@pytest.mark.parametrize("sizes,hi", [((), 1), ((0, 5), 10), ((3,), 4),
                                      ((50, 40, 1), 60), ((500, 700), 900),
                                      ((10, 20), 1 << 40)])
def test_unique_union_equals_np_unique_of_the_concatenation(sizes, hi):
    """engine._unique_union of several arrays is np.unique of their
    concatenation, dense (one bitmap) or not."""
    rng = np.random.default_rng(sum(sizes) + hi)
    parts = [rng.integers(0, hi, n).astype(np.int64) for n in sizes]
    got = teng._unique_union(parts)
    want = np.unique(np.concatenate(parts)) if parts else np.zeros(0)
    assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("n,present_n,hi", [(1, 1, 5), (1, 1000, 3000),
                                            (40, 1000, 3000), (0, 10, 20),
                                            (200, 50, 100), (30, 3, 2)])
def test_in_sorted_equals_isin(n, present_n, hi):
    """engine._in_sorted (a binary search each) keeps what np.isin keeps,
    in the same order, also past either end of `present`."""
    rng = np.random.default_rng(n * 7 + present_n)
    want = np.unique(rng.integers(0, hi + 10, n).astype(np.int64))
    present = np.unique(rng.integers(5, hi + 5, present_n).astype(np.int64))
    assert np.array_equal(teng._in_sorted(want, present),
                          want[np.isin(want, present)])


def test_sorted_keeps_a_sorted_array_and_sorts_others():
    """engine._sorted hands back an ascending array itself (no sort, no
    copy) and a sorted copy of any other."""
    up = np.array([1, 2, 2, 9], np.int64)
    assert teng._sorted(up) is up
    one = np.array([4], np.int64)
    assert teng._sorted(one) is one
    down = np.array([3, 1, 2], np.int64)
    got = teng._sorted(down)
    assert got.tolist() == [1, 2, 3] and down.tolist() == [3, 1, 2]
