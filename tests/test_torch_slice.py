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
        np.testing.assert_array_equal(tf(a, b), jf(a, b))


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
    _, tsnap = _both(_graph())
    _, ts = _schemas()
    for q in ('{ q(func: has(follow)) { uid } }',
              '{ q(func: uid(0x1)) { name } }',
              '{ p as shortest(from: 0x1, to: 0x2) { follow } }',
              '{ q(func: uid(0x1)) @groupby(follow) { count(uid) } }'):
        with pytest.raises(NotImplementedError, match="slice"):
            teng.Executor(tsnap, ts).execute(tdql.parse(q))


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
from dgraph_tpu_torch.query import dql, recurse
from dgraph_tpu_torch.query.engine import Executor
from dgraph_tpu_torch.utils.schema import SchemaState, parse_schema
s, p, x = rmat_csr(8, 4, seed=1)
snap = carry.snapshot_from_numpy({"friend": (8, s, p, x)}, 1, device="cpu")
schema = SchemaState()
schema.set(parse_schema("friend: [uid] .")[0])
recurse.KERNEL_MIN_EDGES = 0
q = "{ q(func: uid(%s)) @recurse(depth: 3) { friend } }" % hex(int(s[0]))
out = Executor(snap, schema).execute(dql.parse(q))
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib")
             or m == "dgraph_tpu" or m.startswith("dgraph_tpu."))
print(json.dumps({"bad": bad, "levels": len(json.dumps(out))}))
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["levels"] > 20


def test_port_sources_import_no_jax():
    bad = []
    for path in sorted((REPO / "dgraph_tpu_torch").rglob("*.py")):
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
    assert (REPO / "dgraph_tpu_torch" / "query" / "engine.py").exists()
