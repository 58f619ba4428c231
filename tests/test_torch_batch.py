"""The port's device batcher (query/batch.py) and multi-source recurse
against the JAX package, on the CPU.

`recurse_fused_multi` takes the same numpy pull graph and seed masks in
both packages (Pallas in interpret mode on the JAX side, the plain PyTorch
kernels on the port's): every output of slice b must equal the JAX batch's
slice b and a solo `recurse_fused` call exactly, for B in {1, 2, 3, 16}
and both loop rules, with K2 routing at the default SPARSE_MAX and with
SPARSE_MAX lowered so that wider frontiers route to K1.

The Node cases are those of tests/test_batch.py (the vector one is in
tests/test_torch_vector.py) on a port Node(device="cpu"): batched
JSON must equal the port's solo JSON and a JAX Node's, byte for byte.
Every expand is forced into the device class with HOST_EXPAND_MAX = 0 in
both packages, as the JAX tests do.
"""

import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.models.rmat import rmat_csr
from dgraph_tpu.ops import pallas_bfs as jpb
from dgraph_tpu.query import recurse as jrec
from dgraph_tpu.query import task as jtask

from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.obs import prom
from dgraph_tpu_torch.ops import pull_bfs as tpb
from dgraph_tpu_torch.query import recurse as trec
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.query.batch import DeviceBatcher, classify, kernel_klass
from dgraph_tpu_torch.query.qcache import DispatchGate
from dgraph_tpu_torch.query.task import TaskQuery
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils.deadline import DeadlineExceeded, ResourceExhausted

REPO = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _load("golden_battery_batch", REPO / "tests" / "test_golden.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def device_expand(monkeypatch):
    """Tiny graphs never cross the 64k host/device cutover: force every
    expand into the device class in both packages."""
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    monkeypatch.setattr(jtask, "HOST_EXPAND_MAX", 0)


@pytest.fixture
def nodes():
    made = []

    def make(cls, **kw):
        kw.setdefault("planner", False)     # keep the static cutover
        kw.setdefault("task_cache_mb", 0)
        kw.setdefault("result_cache_mb", 0)
        if cls is TNode:
            kw["device"] = "cpu"
        n = cls(**kw)
        made.append(n)
        return n

    yield make
    for n in made:
        n.close()


def _load_graph(node):
    node.alter(schema_text="name: string @index(exact) .\n"
                           "follows: [uid] .")
    quads = []
    for i in range(1, 160):
        quads.append(f'<0x{i:x}> <name> "p{i}" .')
        for j in range(1, 6):
            quads.append(f'<0x{i:x}> <follows> <0x{(i * j) % 159 + 1:x}> .')
    node.mutate(set_nquads="\n".join(quads), commit_now=True)
    return node


def _graph_pair(nodes, **kw):
    """(port Node, JAX Node) over the same graph; the JAX one unbatched."""
    return (_load_graph(nodes(TNode, **kw)),
            _load_graph(nodes(JNode, batching=False, devprof=False, **kw)))


def _force_batcher(node, max_batch=8, window_ms=1500) -> DeviceBatcher:
    """No idle fire and a long window: a barrier-released wave lands in one
    batch (which fires early once it holds max_batch)."""
    node.batcher = DeviceBatcher(node.dispatch_gate, node.metrics,
                                 window_ms=window_ms, max_batch=max_batch,
                                 idle_fire=False)
    return node.batcher


def _concurrent(node, queries, timeout=60):
    outs = [None] * len(queries)
    errs = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def run(i):
        barrier.wait(timeout=30)
        try:
            outs[i] = node.query(queries[i])[0]
        except BaseException as e:     # noqa: BLE001 — surfaced to assert
            errs[i] = e

    ts = [threading.Thread(target=run, args=(i,))
          for i in range(len(queries))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    return outs, errs


def _bytes(out):
    return json.dumps(out, default=str).encode()


# ---------------------------------------------------------------------------
# recurse_fused_multi against the JAX function and against solo calls
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pull_pair():
    s, p, x = rmat_csr(10, 8, seed=9)
    n = int(max(s.max(), x.max())) + 1
    jg = jpb.prep_pull(s, p, x, n, with_host_arrays=True)
    tg = tpb.prep_pull(s, p, x, n, with_host_arrays=True, device="cpu")
    return s, n, jg, tg


def _seed_masks(s, n, nb, seed):
    """nb seed masks: one-uid seeds (K2 from the first level), and every
    third mask a wide seed set."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((nb, n), dtype=bool)
    for b in range(nb):
        k = 1 if b % 3 else 64
        masks[b, rng.choice(s, k, replace=False)] = True
    return masks


@pytest.mark.parametrize("allow_loop", [False, True])
@pytest.mark.parametrize("nb", [1, 2, 3, 16])
def test_recurse_fused_multi_matches_jax_and_solo(pull_pair, nb, allow_loop,
                                                   monkeypatch):
    s, n, jg, tg = pull_pair
    masks = _seed_masks(s, n, nb, seed=nb)
    kw = dict(depth=3, chunks=tg.chunks, chunks_d=tg.chunks_d,
              allow_loop=allow_loop)
    want = jpb.recurse_fused_multi(
        jg.in_src_pad, jg.in_src_pad_d, jg.in_iptr_rank, jg.subjects,
        jg.in_subjects, jnp.asarray(masks), **kw)
    args = (tg.in_src_pad, tg.in_src_pad_d, tg.in_iptr_rank, tg.subjects,
            tg.in_subjects)
    for sparse_max in (tpb.SPARSE_MAX, 8):
        # 8 sends every frontier wider than 8 ranks to K1: the route
        # changes, the bits must not
        monkeypatch.setattr(tpb, "SPARSE_MAX", sparse_max)
        got = tpb.recurse_fused_multi(*args, torch.from_numpy(masks), **kw)
        assert [tuple(g.shape[:2]) for g in got] == [(nb, 3)] * 3
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for b in range(nb):
            solo = tpb.recurse_fused(*args, torch.from_numpy(masks[b]),
                                     **kw)
            for one, g in zip(solo, got):
                assert torch.equal(one, g[b])


def test_recurse_fused_multi_reads_once_per_level(pull_pair, monkeypatch):
    """Level-major: every per-slice prefix gets its popcount from the
    level's one stacked read, never reading its own (B x depth prefixes,
    depth reads)."""
    s, n, _jg, tg = pull_pair
    masks = _seed_masks(s, n, 5, seed=3)
    seen = []
    real = tpb._prefix_for

    def spy(bits, stream, n_chunks, fcount=None):
        seen.append(fcount)
        return real(bits, stream, n_chunks, fcount)

    monkeypatch.setattr(tpb, "_prefix_for", spy)
    tpb.recurse_fused_multi(
        tg.in_src_pad, tg.in_src_pad_d, tg.in_iptr_rank, tg.subjects,
        tg.in_subjects, torch.from_numpy(masks), depth=3, chunks=tg.chunks,
        chunks_d=tg.chunks_d, allow_loop=False)
    assert len(seen) == 15 and None not in seen


# ---------------------------------------------------------------------------
# byte-identity through the Node
# ---------------------------------------------------------------------------

def test_concurrent_distinct_queries_batch_byte_identical(device_expand,
                                                           nodes):
    node, jnode = _graph_pair(nodes)
    queries = [f'{{ q(func: uid(0x{3 * i + 1:x}, 0x{3 * i + 2:x}, '
               f'0x{3 * i + 3:x})) {{ follows {{ uid }} }} }}'
               for i in range(8)]
    node.batcher = None
    solo = [node.query(q)[0] for q in queries]
    assert [_bytes(o) for o in solo] == \
        [_bytes(jnode.query(q)[0]) for q in queries]
    _force_batcher(node, max_batch=8)
    outs, errs = _concurrent(node, queries)
    assert not any(errs), errs
    assert [_bytes(o) for o in outs] == [_bytes(o) for o in solo]
    m = node.metrics
    assert m.counter("dgraph_batch_tasks_total").value == 8
    occ = m.histogram("dgraph_batch_occupancy").snapshot()
    assert occ["max"] > 1, occ


def test_golden_corpus_byte_identical_under_forced_batching(device_expand,
                                                            nodes):
    """The golden battery in concurrent waves with batching forced: every
    output equals the solo run and expected.json-backed JAX answers."""
    node = nodes(TNode)
    node.alter(schema_text=GOLDEN.SCHEMA)
    node.mutate(set_nquads=GOLDEN._dataset(), commit_now=True)
    jnode = nodes(JNode, batching=False, devprof=False)
    jnode.alter(schema_text=GOLDEN.SCHEMA)
    jnode.mutate(set_nquads=GOLDEN._dataset(), commit_now=True)
    queries = [q for _name, q in GOLDEN.QUERIES]
    node.batcher = None
    solo = [node.query(q)[0] for q in queries]
    assert [_bytes(o) for o in solo] == \
        [_bytes(jnode.query(q)[0]) for q in queries]
    _force_batcher(node, max_batch=8, window_ms=150)
    outs = []
    for lo in range(0, len(queries), 8):
        got, errs = _concurrent(node, queries[lo: lo + 8])
        assert not any(errs), errs
        outs.extend(got)
    assert [_bytes(o) for o in outs] == [_bytes(o) for o in solo]
    assert node.metrics.counter("dgraph_batch_formed_total").value > 0


def test_recurse_fused_batches_byte_identical(device_expand, nodes,
                                              monkeypatch):
    monkeypatch.setattr(trec, "KERNEL_MIN_EDGES", 0)
    monkeypatch.setattr(jrec, "KERNEL_MIN_EDGES", 0)
    node, jnode = _graph_pair(nodes)
    queries = [f'{{ q(func: uid(0x{i + 1:x})) @recurse(depth: 3) '
               '{ follows } }' for i in range(4)]
    node.batcher = None
    solo = [node.query(q)[0] for q in queries]
    assert [_bytes(o) for o in solo] == \
        [_bytes(jnode.query(q)[0]) for q in queries]
    _force_batcher(node, max_batch=4)
    calls = []
    real = tpb.recurse_fused_multi
    monkeypatch.setattr(tpb, "recurse_fused_multi",
                        lambda *a, **k: calls.append(a[5].shape[0])
                        or real(*a, **k))
    outs, errs = _concurrent(node, queries)
    assert not any(errs), errs
    assert [_bytes(o) for o in outs] == [_bytes(o) for o in solo]
    occ = node.metrics.histogram("dgraph_batch_occupancy").snapshot()
    assert occ["max"] == 4, occ
    assert calls == [4]             # one multi-source run, no padded slots


def test_similar_to_stays_solo_and_names_its_slice(nodes):
    """similar_to over a predicate with no vector index classifies as
    vector_solo and runs solo, which raises the typed error naming the
    missing index, as the JAX Node does."""
    from dgraph_tpu.query.task import TaskError as JTaskError
    from dgraph_tpu_torch.query.task import TaskError as TTaskError

    q = '{ q(func: similar_to(emb, "[1.0, 1.0]", 2)) { uid } }'
    node = nodes(TNode)
    _force_batcher(node, max_batch=2, window_ms=10)
    with pytest.raises(TTaskError, match="vector") as te:
        node.query(q)
    reasons = node.metrics.keyed("dgraph_batch_incompatible").snapshot()
    assert reasons.get("vector_solo", 0) == 1, reasons
    jn = nodes(JNode, planner=False, devprof=False)
    with pytest.raises(JTaskError) as je:
        jn.query(q)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# composition with singleflight
# ---------------------------------------------------------------------------

def test_singleflight_dedupes_identical_batcher_packs_distinct(device_expand,
                                                               nodes):
    node = _load_graph(nodes(TNode, task_cache_mb=16))
    same = '{ q(func: uid(0x1, 0x2)) { follows { uid } } }'
    diff = '{ q(func: uid(0x5, 0x6)) { follows { uid } } }'
    node.batcher = None
    want_same = node.query(same)[0]
    want_diff = node.query(diff)[0]
    node.task_cache.clear()
    # room for three, so the leader and the distinct task wait out the
    # window: the identical follower reaches the singleflight while the
    # leader is still in flight, however slowly the threads start
    _force_batcher(node, max_batch=3)
    outs, errs = _concurrent(node, [same, same, diff])
    assert not any(errs), errs
    assert outs == [want_same, want_same, want_diff]
    m = node.metrics
    assert m.counter("dgraph_task_cache_inflight_waits_total").value >= 1
    assert m.counter("dgraph_batch_tasks_total").value == 2
    occ = m.histogram("dgraph_batch_occupancy").snapshot()
    assert occ["max"] == 2, occ


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def test_deadline_constrained_task_bypasses_window(device_expand, nodes):
    node = _load_graph(nodes(TNode))
    batcher = DeviceBatcher(node.dispatch_gate, node.metrics,
                            window_ms=500, max_batch=8, idle_fire=False)
    snap = node.snapshot()
    q = TaskQuery("follows", frontier=np.asarray([1, 2], dtype=np.int64))
    ran = []

    def solo(tq, klass=None):
        ran.append(tq)
        return ttask.process_task(snap, tq, node.store.schema)

    t0 = time.monotonic()
    with dl.scope(0.05):
        res = batcher.dispatch(snap, node.store.schema, q, solo)
    assert time.monotonic() - t0 < 0.4
    assert ran, "bypass must run the solo path"
    assert len(res.uid_matrix) == 2
    assert node.metrics.counter(
        "dgraph_batch_deadline_bypass_total").value == 1


def test_batch_runs_under_most_permissive_member_deadline():
    from dgraph_tpu_torch.utils.metrics import Registry

    seen = []

    def runner(entries):
        seen.append(dl.remaining())
        for e in entries:
            e.result = "ok"

    def pair(budget_a, budget_b):
        b = DeviceBatcher(None, Registry(), window_ms=2000, max_batch=2,
                          idle_fire=False)
        outs = {}
        barrier = threading.Barrier(2)

        def run(name, budget):
            barrier.wait(timeout=10)
            with dl.scope(budget):
                outs[name] = b._submit(("k",), "expand", None, runner,
                                       solo=lambda: "solo")

        ts = [threading.Thread(target=run, args=("a", budget_a)),
              threading.Thread(target=run, args=("b", budget_b))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert outs == {"a": "ok", "b": "ok"}

    pair(5.0, None)
    assert seen.pop() is None
    pair(0.5, 30.0)
    assert seen.pop() > 10.0


def test_host_fallbacks_feed_host_ewma_class_not_expand(nodes):
    node = _load_graph(nodes(TNode))      # default cutover: host class
    _force_batcher(node, max_batch=4, window_ms=10)
    node.query('{ q(func: uid(0x1, 0x2)) { name follows { uid } } }')
    g = node.dispatch_gate
    assert "host" in g._class_ewma, g._class_ewma
    assert "expand" not in g._class_ewma, g._class_ewma


# ---------------------------------------------------------------------------
# mid-batch per-task failure
# ---------------------------------------------------------------------------

def test_poisoned_task_fails_typed_rest_of_batch_succeeds(device_expand,
                                                          nodes):
    node = _load_graph(nodes(TNode))
    batcher = DeviceBatcher(node.dispatch_gate, node.metrics,
                            window_ms=2000, max_batch=2, idle_fire=False)
    snap = node.snapshot()
    schema = node.store.schema
    good = TaskQuery("follows", frontier=np.asarray([1, 2], dtype=np.int64))
    bad = TaskQuery("follows", frontier=np.asarray([3, 4], dtype=np.int64),
                    func=("uid_in", ["not-a-uid"]))
    with pytest.raises(ValueError):
        ttask.process_task(snap, bad, schema)
    want = ttask.process_task(snap, good, schema)

    results, errors = {}, {}
    barrier = threading.Barrier(2)

    def run(name, q):
        barrier.wait(timeout=10)
        try:
            results[name] = batcher.dispatch(
                snap, schema, q,
                lambda tq, klass=None: ttask.process_task(snap, tq, schema))
        except BaseException as e:             # noqa: BLE001
            errors[name] = e

    ts = [threading.Thread(target=run, args=("good", good)),
          threading.Thread(target=run, args=("bad", bad))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert isinstance(errors.get("bad"), ValueError)
    got = results["good"]
    assert [m.tolist() for m in got.uid_matrix] == \
        [m.tolist() for m in want.uid_matrix]
    assert got.dest_uids.tolist() == want.dest_uids.tolist()
    occ = node.metrics.histogram("dgraph_batch_occupancy").snapshot()
    assert occ["max"] == 2, occ


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_batched_kernel_span_carries_batch_size(device_expand, nodes):
    node = _load_graph(nodes(TNode, span_sample=1.0))
    queries = [f'{{ q(func: uid(0x{2 * i + 1:x}, 0x{2 * i + 2:x})) '
               '{ follows { uid } } }' for i in range(3)]
    _force_batcher(node, max_batch=3)
    _outs, errs = _concurrent(node, queries)
    assert not any(errs), errs
    spans = [s for r in node.tracer.sink.index()
             for s in node.tracer.sink.get(r["trace_id"])["spans"]]
    kernels = [s for s in spans if s["name"] == "device_kernel"
               and s["attrs"].get("kernel") == "batch.expand"]
    assert kernels, "no batched device_kernel span"
    assert any(k["attrs"].get("batch", 0) >= 2 for k in kernels)
    joins = [e for s in spans for e in s.get("events", ())
             if e["name"] == "batched" and e["attrs"].get("size", 0) >= 2]
    assert joins, "no batched events on member traces"


def test_batch_metrics_on_prometheus_surface(device_expand, nodes):
    node = _load_graph(nodes(TNode))
    _force_batcher(node, max_batch=2)
    _outs, errs = _concurrent(
        node, ['{ q(func: uid(0x1, 0x2)) { follows { uid } } }',
               '{ q(func: uid(0x3, 0x4)) { follows { uid } } }'])
    assert not any(errs), errs
    parsed = prom.parse(prom.render(node.metrics))
    for name in ("dgraph_batch_formed_total", "dgraph_batch_tasks_total",
                 "dgraph_batch_window_waits_total"):
        assert name in parsed, f"{name} missing from /metrics"


def test_classification_reasons_counted_as_jax(nodes):
    """The per-reason incompatibility counts equal the JAX batcher's for
    the same request (default cutover: everything is host-class)."""
    node, jnode = _graph_pair(nodes)
    from dgraph_tpu.query.batch import DeviceBatcher as JBatcher

    _force_batcher(node, max_batch=4, window_ms=10)
    jnode.batcher = JBatcher(jnode.dispatch_gate, jnode.metrics,
                             window_ms=10, max_batch=4, idle_fire=False)
    q = '{ q(func: uid(0x1, 0x2)) { name follows { uid } } }'
    assert _bytes(node.query(q)[0]) == _bytes(jnode.query(q)[0])
    reasons = node.metrics.keyed("dgraph_batch_incompatible").snapshot()
    assert reasons == jnode.metrics.keyed(
        "dgraph_batch_incompatible").snapshot()
    assert reasons.get("host_path", 0) >= 1, reasons
    assert reasons.get("value_pred", 0) >= 1, reasons
    assert node.metrics.counter("dgraph_batch_formed_total").value == 0


# ---------------------------------------------------------------------------
# gate: per-kernel-class EWMA
# ---------------------------------------------------------------------------

def test_gate_keeps_per_class_step_estimates():
    g = DispatchGate(2)
    g.run(lambda: time.sleep(0.05), klass="vector")
    g.run(lambda: None, klass="expand")
    assert g.expected_step("vector") >= 0.05
    assert g.expected_step("expand") < g.expected_step("vector")
    assert g.expected_step("mesh") == g.expected_step_s
    assert g.expected_step() == g.expected_step_s


def test_gate_shed_uses_class_estimate_not_global():
    g = DispatchGate(1)
    g._step_ewma = 5.0
    g._class_ewma["vector"] = 5.0
    g._class_ewma["expand"] = 0.001
    ev = threading.Event()
    t = threading.Thread(target=lambda: g.run(lambda: ev.wait(2.0)))
    t.start()
    time.sleep(0.05)
    try:
        with dl.scope(0.2):
            with pytest.raises(ResourceExhausted):
                g.run(lambda: 1, klass="vector")
        with dl.scope(0.2):
            with pytest.raises(DeadlineExceeded):
                g.run(lambda: 1, klass="expand")
    finally:
        ev.set()
        t.join()


def test_kernel_klass_labels():
    assert kernel_klass(TaskQuery("follows",
                                  frontier=np.zeros(1, np.int64))) == \
        "expand"
    assert kernel_klass(TaskQuery("emb",
                                  func=("similar_to", ["[1]", 1]))) == \
        "vector"
    assert kernel_klass(TaskQuery("name", func=("eq", ["x"]))) == "root"


def test_classify_rejects_unbatchable_shapes(device_expand, nodes):
    node = _load_graph(nodes(TNode))
    snap = node.snapshot()
    schema = node.store.schema
    key, reason, _ = classify(snap, schema,
                              TaskQuery("name",
                                        frontier=np.asarray([1, 2])))
    assert key is None and reason == "value_pred"
    key, reason, _ = classify(snap, schema,
                              TaskQuery("name", func=("eq", ["p1"])))
    assert key is None and reason == "root_func"
    key, kind, work = classify(
        snap, schema, TaskQuery("follows",
                                frontier=np.asarray([1, 2], np.int64)))
    assert kind == "expand" and key[1] == id(work.csr)
    node.mutate(set_nquads="<0x1> <follows> <0x9> .", commit_now=True)
    snap2 = node.snapshot()
    key2, reason2, _ = classify(
        snap2, schema, TaskQuery("follows",
                                 frontier=np.asarray([1, 2], np.int64)))
    assert key2 is None and reason2 == "overlay"
    node._assembler.compact(node._lock, force=True)
    snap3 = node.snapshot()
    key3, kind3, work3 = classify(
        snap3, schema, TaskQuery("follows",
                                 frontier=np.asarray([1, 2], np.int64)))
    assert kind3 == "expand" and key3 != key and work3.csr is not work.csr
