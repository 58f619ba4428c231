"""The port's HBM working-set manager (storage/residency.py) against the
JAX package's, on the CPU.

Unit level: the cases of tests/test_residency.py run the same owner
sequence, under the same fake clock, through a JAX ResidencyManager and a
port one; every counter, every owner's drop count and the tier byte totals
must be equal, and the JAX test's own assertions hold on the port.

Node level: the JAX cases on a port Node(device="cpu") — tiered serving
under a budget ten times smaller than the graph, cold tablets served by
the host gather, identity across an evict → re-admit cycle, prefetch
accounting, the injected upload fault, the metrics surfaces, the
batcher's cold-tier classification — with JSON byte-identical to an
unbudgeted port Node and to a JAX Node. The mesh cases wait for the mesh
slice; the vector cases are in tests/test_torch_vector.py.
"""

import gc
import json

import numpy as np
import pytest
import torch

from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.storage import residency as jres
from dgraph_tpu.utils.metrics import Registry as JRegistry

from dgraph_tpu_torch.api.http import _serving_metrics
from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.obs import prom
from dgraph_tpu_torch.query import batch as batchmod
from dgraph_tpu_torch.query import qcache
from dgraph_tpu_torch.query import task as taskmod
from dgraph_tpu_torch.query.task import TaskQuery
from dgraph_tpu_torch.storage import csr_build as tcb
from dgraph_tpu_torch.storage import delta as tdelta
from dgraph_tpu_torch.storage import residency as resmod
from dgraph_tpu_torch.storage.residency import ResidencyManager
from dgraph_tpu_torch.utils import faults
from dgraph_tpu_torch.utils.metrics import Registry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# unit level: one owner sequence through both managers
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _stub_class(mod):
    class _StubOwner:
        """Minimal residency owner: a named device-buffer group."""

        _res = None
        _res_attr = ""
        _res_kind = "csr"

        def __init__(self, mgr, attr, nbytes):
            self._res = mgr
            self._res_attr = attr
            self.nbytes = nbytes
            self._dev = None
            self.drops = 0

        def device_nbytes(self):
            return self.nbytes

        def device_resident(self):
            return self._dev is not None

        def drop_device(self):
            self._dev = None
            self.drops += 1

        def upload(self, prefetch=False):
            return mod.ensure_device(self, "_dev", lambda: ("dev",),
                                     prefetch=prefetch)

    return _StubOwner


class Side:
    """One package's manager, stub owners and fake clock."""

    def __init__(self, mod, registry, budget, **kw):
        kw.setdefault("min_resident_s", 0.0)
        self.mod = mod
        self.clock = _Clock()
        self.mgr = mod.ResidencyManager(budget_bytes=budget,
                                        metrics=registry(),
                                        clock=self.clock, **kw)
        self.stub = _stub_class(mod)
        self.owners = {}

    def owner(self, attr, nbytes):
        o = self.owners[attr] = self.stub(self.mgr, attr, nbytes)
        return o

    def state(self):
        c = lambda n: self.mgr.metrics.counter(n).value
        names = ("admissions", "evictions", "prefetch_hits",
                 "prefetch_wasted", "thrash", "cold_serves",
                 "upload_failures", "budget_overruns")
        u = self.mgr.usage()
        return {"counters": {n: c(f"dgraph_residency_{n}_total")
                             for n in names},
                "drops": {a: o.drops for a, o in self.owners.items()},
                "resident": {a: o._dev is not None
                             for a, o in self.owners.items()},
                "hbm": u["hbm_bytes"], "entries": u["entries"]}


def _both(budget, seq, **kw):
    """Run seq(side) on a JAX side and a port side; their states must be
    equal. Returns the port side."""
    sides = [Side(jres, JRegistry, budget, **kw),
             Side(resmod, Registry, budget, **kw)]
    for s in sides:
        seq(s)
    assert sides[0].state() == sides[1].state()
    return sides[1]


def test_admission_under_budget_and_eviction():
    def seq(s):
        s.owner("a", 400).upload()
        s.owner("b", 400).upload()
        assert s.mgr.usage()["hbm_bytes"] == 800
        s.mgr.touch("b")
        s.owner("c", 400).upload()

    p = _both(1000, seq)
    a, b, c = (p.owners[k] for k in "abc")
    assert a.drops == 1 and b.drops == 0
    assert a._dev is None and b._dev is not None and c._dev is not None
    assert p.mgr.usage()["hbm_bytes"] == 800
    st = p.state()["counters"]
    assert st["admissions"] == 3 and st["evictions"] == 1


def test_eviction_order_is_lru_of_score():
    def seq(s):
        for n in ("x", "y", "z"):
            s.owner(n, 400).upload()
        for _ in range(10):
            s.mgr.touch("x")
        s.mgr.touch("z")
        s.owner("w", 400).upload()

    p = _both(1200, seq)
    assert p.owners["y"].drops == 1
    assert p.owners["x"].drops == 0 and p.owners["z"].drops == 0


def test_pin_floor_never_evicts():
    def seq(s):
        s.owner("keep", 400).upload()
        s.owner("other", 400).upload()
        for _ in range(20):
            s.mgr.touch("other")
        s.owner("c", 400).upload()

    p = _both(800, seq, pins=("keep",))
    assert p.owners["keep"].drops == 0 and p.owners["other"].drops == 1


def test_hysteresis_skips_young_entries_when_possible():
    def seq(s):
        s.owner("old", 400).upload()
        s.clock.t += 10.0
        s.owner("young", 400).upload()
        s.clock.t += 1.0
        s.owner("c", 400).upload()

    p = _both(800, seq, min_resident_s=5.0)
    assert p.owners["old"].drops == 1 and p.owners["young"].drops == 0


def test_thrash_counter_on_fast_readmit():
    def seq(s):
        a = s.owner("a", 400)
        a.upload()
        s.clock.t += 1.0
        s.owner("b", 400).upload()
        s.clock.t += 1.0
        a.upload()

    p = _both(400, seq, thrash_window_s=10.0)
    assert p.state()["counters"]["thrash"] >= 1


def test_cold_tablet_never_admits():
    def seq(s):
        big = s.owner("big", 400)
        assert not s.mgr.allows_device(big.device_nbytes())
        assert s.mod.prefer_host(big)          # a pure consult
        assert s.mgr.metrics.counter(
            "dgraph_residency_cold_serves_total").value == 0
        s.mgr.note_cold_serve()
        assert s.mgr.tier_of("big", 400) == s.mod.TIER_COLD
        assert s.mgr.tier_of("big", 50) == s.mod.TIER_WARM

    p = _both(100, seq)
    assert p.state()["counters"]["cold_serves"] == 1


def test_evict_to_and_weakref_unregister():
    def seq(s):
        s.owner("a", 300).upload()
        s.owner("b", 300).upload()
        assert s.mgr.evict_to(300) == 1
        assert s.mgr.usage()["hbm_bytes"] == 300

    p = _both(1000, seq)
    p.owners.clear()
    gc.collect()
    assert p.mgr.usage()["hbm_bytes"] == 0


def test_prefetch_and_upload_fault_accounting_equal_jax():
    """Prefetched uploads touched before eviction count hits, untouched
    ones wasted; an injected upload fault counts a failure and leaves the
    owner warm — equal counts in both packages."""
    from dgraph_tpu.utils import faults as jfaults

    def seq(s):
        s.owner("a", 300).upload(prefetch=True)
        s.owner("b", 300).upload(prefetch=True)
        s.mgr.touch("a")
        s.mgr.evict_to(0)
        fmod = jfaults if s.mod is jres else faults
        fmod.GLOBAL.reseed(3)
        fmod.GLOBAL.install("residency.h2d_upload", "error", p=1.0)
        try:
            with pytest.raises(fmod.FaultError):
                s.owner("c", 300).upload()
        finally:
            fmod.GLOBAL.clear()

    p = _both(1000, seq)
    st = p.state()["counters"]
    assert st["prefetch_hits"] == 1 and st["prefetch_wasted"] == 1
    assert st["upload_failures"] == 1
    assert not p.owners["c"].device_resident()


# ---------------------------------------------------------------------------
# owners: the port's PredCSR, TokenIndex and overlays keep the protocol
# ---------------------------------------------------------------------------

def test_owner_protocol_on_port_columns():
    mgr = ResidencyManager(budget_bytes=1 << 20, metrics=Registry())
    csr = tcb.PredCSR(np.asarray([1, 4], np.int32),
                      np.asarray([0, 2, 3], np.int32),
                      np.asarray([2, 3, 1], np.int32), device="cpu")
    ti = tcb.TokenIndex([b"a", b"b"], np.asarray([0, 1, 3], np.int32),
                        np.asarray([1, 1, 4], np.int32), device="cpu")
    for owner, kind in ((csr, "csr"), (ti, "index:exact")):
        mgr._adopt(owner, "p", kind)
        assert owner.device_nbytes() == 4 * sum(
            len(a) for a in (owner.host_arrays() if owner is csr else
                             (owner._indptr_h, owner._uids_h)))
        assert not owner.device_resident() and not owner.prefer_host()
        first = owner.device_arrays()
        assert owner.device_resident()
        assert all(t.dtype == torch.int32 for t in first)
        owner.drop_device()
        assert not owner.device_resident()
        again = owner.device_arrays()
        assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert csr.max_degree() == 2
    assert csr.host_nbytes() == csr.device_nbytes() == 4 * 8
    c = lambda n: mgr.metrics.counter(n).value
    assert c("dgraph_residency_admissions_total") == 4
    assert c("dgraph_residency_evictions_total") == 0
    assert mgr.evict_to(0) == 2
    mgr.budget = 8                         # both owners are cold now
    assert csr.prefer_host() and ti.prefer_host()


# ---------------------------------------------------------------------------
# node level: tiers through the real query path
# ---------------------------------------------------------------------------

N_PREDS = 16
N_SUBJ = 48
FANOUT = 8
PREDS = [f"p{i:02d}" for i in range(N_PREDS)]


def _fill(n):
    schema = ["name: string @index(exact) ."]
    schema += [f"{p}: [uid] ." for p in PREDS]
    n.alter(schema_text="\n".join(schema))
    rng = np.random.default_rng(11)
    quads = []
    for i in range(1, N_SUBJ + 1):
        quads.append(f'<{i:#x}> <name> "s{i}" .')
    for p in PREDS:
        for i in range(1, N_SUBJ + 1):
            for t in rng.choice(N_SUBJ, FANOUT, replace=False) + 1:
                quads.append(f"<{i:#x}> <{p}> <{int(t):#x}> .")
    n.mutate(set_nquads="\n".join(quads), commit_now=True)
    return n


@pytest.fixture
def nodes():
    made = []

    def make(cls=Node, **kw):
        kw.setdefault("task_cache_mb", 0)
        kw.setdefault("result_cache_mb", 0)
        # planner off: its estimated cutover would route these small
        # expands host-side regardless of the shrunken HOST_EXPAND_MAX
        kw.setdefault("planner", False)
        if cls is Node:
            kw["device"] = "cpu"
        else:
            kw.update(batching=False, devprof=False)
        n = _fill(cls(**kw))
        made.append(n)
        return n

    yield make
    for n in made:
        n.close()


QUERIES = [f"{{ q(func: has({p})) {{ {p} {{ uid }} }} }}" for p in PREDS]


def _run_all(node, queries=QUERIES):
    return [json.dumps(node.query(q)[0], default=str) for q in queries]


@pytest.fixture
def force_device(monkeypatch):
    """Every multi-row expand takes the device path in both packages."""
    from dgraph_tpu.query import task as jtask

    monkeypatch.setattr(taskmod, "HOST_EXPAND_MAX", 8)
    monkeypatch.setattr(jtask, "HOST_EXPAND_MAX", 8)


def _graph_device_bytes(node) -> int:
    snap = node.snapshot()
    return sum(resmod.pred_host_nbytes(pd) for pd in snap.preds.values())


def test_tiered_serving_byte_identical_10x_budget(force_device, nodes):
    want = _run_all(nodes())
    assert want == _run_all(nodes(JNode))
    tiered = nodes(device_budget_mb=1)
    total = _graph_device_bytes(tiered)
    tiered.residency.budget = total // 10
    tiered.residency.evict_to(tiered.residency.budget)
    assert _run_all(tiered) == want
    m = tiered.residency.metrics
    assert m.counter("dgraph_residency_admissions_total").value > 0
    assert m.counter("dgraph_residency_evictions_total").value > 0
    assert tiered.residency.usage()["hbm_bytes"] <= tiered.residency.budget


def test_cold_tablet_serves_host_path(force_device, nodes):
    want = _run_all(nodes())
    node = nodes(device_budget_mb=1)
    node.residency.budget = 64          # smaller than any tablet here
    assert _run_all(node) == want
    snap = node.snapshot()
    assert snap.preds["p00"].csr._dev is None      # never uploaded
    assert node.residency.metrics.counter(
        "dgraph_residency_cold_serves_total").value > 0
    assert node.residency.usage()["hbm_bytes"] == 0


def test_evict_readmit_identity_rotation(force_device, nodes):
    node = nodes(device_budget_mb=512)
    q0 = QUERIES[0]
    want = node.query(q0)[0]
    snap = node.snapshot()
    pd = snap.preds["p00"]
    csr = pd.csr
    assert csr._dev is not None
    tq = TaskQuery("p00", frontier=np.arange(1, 33, dtype=np.int64))
    tok0 = qcache.task_token(snap, tq)
    key0, kind0, _w = batchmod.classify(snap, node.store.schema, tq)
    assert kind0 == "expand" and key0 == ("expand", id(csr))
    assert node.residency.evict_to(0) > 0
    assert csr._dev is None
    snap2 = node.snapshot()
    assert snap2.preds["p00"] is pd
    assert qcache.task_token(snap2, tq) == tok0
    assert node.query(q0)[0] == want
    assert csr._dev is not None
    key1, kind1, _w = batchmod.classify(node.snapshot(),
                                        node.store.schema, tq)
    assert kind1 == "expand" and key1 == key0
    node.mutate(set_nquads=f"<{1:#x}> <p00> <{47:#x}> .", commit_now=True)
    assert qcache.task_token(node.snapshot(), tq) != tok0


def test_prefetch_hits_and_wasted(force_device, nodes):
    node = nodes(device_budget_mb=512)
    snap = node.snapshot()
    assert node.residency.prefetch(["p00"], snap, sync=True) >= 1
    csr = snap.preds["p00"].csr
    assert csr._dev is not None
    node.query(QUERIES[0])
    m = node.residency.metrics
    assert m.counter("dgraph_residency_prefetch_hits_total").value >= 1
    assert node.residency.prefetch(["p01"], snap, sync=True) >= 1
    node.residency.evict_to(0)
    assert m.counter("dgraph_residency_prefetch_wasted_total").value >= 1


def test_upload_fault_serves_host_byte_identical(force_device, nodes):
    want = _run_all(nodes(), QUERIES[:4])
    node = nodes(device_budget_mb=512)
    try:
        faults.GLOBAL.reseed(7)
        faults.GLOBAL.install("residency.h2d_upload", "error", p=1.0)
        assert _run_all(node, QUERIES[:4]) == want
        m = node.residency.metrics
        assert m.counter("dgraph_residency_upload_failures_total").value > 0
        assert m.counter("dgraph_residency_host_fallbacks_total").value > 0
        assert node.snapshot().preds["p00"].csr._dev is None
        faults.GLOBAL.clear()
        assert _run_all(node, QUERIES[:4]) == want
        assert node.snapshot().preds["p00"].csr._dev is not None
    finally:
        faults.GLOBAL.clear()


def test_upload_error_that_is_not_injected_raises(force_device, nodes,
                                                  monkeypatch):
    """No fallback hides the device: only the injected FaultError is served
    by the host gather; any other upload error reaches the caller."""
    node = nodes(device_budget_mb=512)
    node.residency.evict_to(0)

    def boom(self, *a, **k):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(ResidencyManager, "before_upload", boom)
    with pytest.raises(RuntimeError, match="out of memory"):
        node.query(QUERIES[0])


def test_enforce_memory_reports_as_jax(nodes):
    """enforce_memory on equal stores under the same budget: the same
    levers fire (the host byte counts differ by design: the port's
    PredData keeps int64/float64 host mirrors where the JAX one keeps
    int32/float32 device columns)."""
    t, j = nodes(), nodes(JNode)
    for n in (t, j):
        for q in QUERIES[:3]:
            n.query(q)
    budget = t.store.memory_stats()["bytes"] + 1024
    rt, rj = t.enforce_memory(budget), j.enforce_memory(budget)
    assert sorted(rt) == sorted(rj)
    for k in ("bytes", "lists", "layers", "rolled_up", "dropped_caches",
              "task_cache_evicted", "overlays_compacted",
              "residency_evicted"):
        assert rt[k] == rj[k], k
    assert rt["fold_bytes"] > 0 and rt["dropped_caches"] > 0
    assert set(rt["residency"]) == set(rj["residency"])


def test_residency_metrics_on_surfaces(force_device, nodes):
    node = nodes(device_budget_mb=512)
    _run_all(node, QUERIES[:4])
    node.residency.usage()
    parsed = prom.parse(prom.render(node.metrics))
    for name in ("dgraph_residency_admissions_total",
                 "dgraph_residency_evictions_total",
                 "dgraph_residency_prefetch_hits_total",
                 "dgraph_residency_prefetch_wasted_total",
                 "dgraph_residency_thrash_total",
                 "dgraph_residency_hbm_bytes",
                 "dgraph_residency_host_bytes"):
        assert name in parsed, name
    tiers = {lbl.get("tier") for lbl, _v in
             parsed.get("dgraph_residency_tier_bytes", [])}
    assert "hbm" in tiers
    section = _serving_metrics(node)["residency"]
    assert section["enabled"] is True
    assert section["admissions"] > 0
    assert set(section["tiers"]) == {"hbm", "warm", "cold"}
    assert isinstance(section["resident"], dict)
    jsec = jres.ResidencyManager(budget_bytes=1).debug_snapshot()
    assert list(section) == list(jsec)


def test_unbounded_budget_is_accounting_only(force_device, nodes):
    node = nodes()
    _run_all(node, QUERIES[:4])
    assert not node.residency.enabled
    m = node.residency.metrics
    assert m.counter("dgraph_residency_evictions_total").value == 0
    assert m.counter("dgraph_residency_cold_serves_total").value == 0
    assert m.counter("dgraph_residency_admissions_total").value > 0
    assert node.snapshot().preds["p00"].csr._dev is not None


def test_tier_transition_span_events(force_device, nodes):
    node = nodes(device_budget_mb=512, span_sample=1.0)
    snap = node.snapshot()
    node.residency.evict_to(0)
    with node.tracer.root("probe", force=True):
        taskmod.process_task(
            snap, TaskQuery("p00", frontier=np.arange(1, 33,
                                                      dtype=np.int64)),
            node.store.schema)
    evs = []
    for rec in node.tracer.sink.index():
        full = node.tracer.sink.get(rec["trace_id"])
        for sp in full["spans"]:
            for ev in sp.get("events", []):
                if ev["name"] == "residency_tier":
                    evs.append(ev["attrs"])
    assert any(e.get("transition") == "warm->hbm" for e in evs)


def test_batcher_classifies_cold_tablet_out(force_device, nodes):
    node = nodes(device_budget_mb=1)
    node.residency.budget = 64
    snap = node.snapshot()
    tq = TaskQuery("p00", frontier=np.arange(1, 33, dtype=np.int64))
    key, kind, _work = batchmod.classify(snap, node.store.schema, tq)
    assert key is None and kind == "cold_tier"
    node.residency.budget = 512 << 20
    key, kind, _w = batchmod.classify(snap, node.store.schema, tq)
    assert kind == "expand" and key is not None


def test_batched_expand_upload_fault_host_fallback(force_device, nodes):
    from dgraph_tpu_torch.query.batch import DeviceBatcher, _Entry

    node = nodes(device_budget_mb=512)
    snap = node.snapshot()
    frontiers = [np.arange(1, 25, dtype=np.int64),
                 np.arange(9, 41, dtype=np.int64)]
    want = [taskmod.process_task(
        snap, TaskQuery("p01", frontier=f), node.store.schema)
        for f in frontiers]
    node.residency.evict_to(0)
    batcher = DeviceBatcher(metrics=Registry(), idle_fire=False)
    entries = []
    for f in frontiers:
        _key, kind, work = batchmod.classify(
            snap, node.store.schema, TaskQuery("p01", frontier=f))
        assert kind == "expand"
        entries.append(_Entry(work))
    try:
        faults.GLOBAL.reseed(1)
        faults.GLOBAL.install("residency.h2d_upload", "error", p=1.0)
        batcher._run_expand(entries)
        for e, w in zip(entries, want):
            assert e.error is None
            assert [m.tolist() for m in e.result.uid_matrix] == \
                [m.tolist() for m in w.uid_matrix]
            assert e.result.dest_uids.tolist() == w.dest_uids.tolist()
    finally:
        faults.GLOBAL.clear()


def test_overlay_and_merged_index_adopt(nodes):
    """A stamped overlay's merged views adopt with the JAX kinds, and the
    base keeps its own entry (the no-re-upload contract)."""
    node = nodes()
    snap = node.snapshot()
    snap.pred("p00")
    snap.pred("name")
    node.mutate(set_nquads='<0x1> <p00> <0x30> .\n<0x2> <name> "zz" .',
                commit_now=True)
    pd = node.snapshot().pred("p00")
    assert isinstance(pd.csr, tdelta.OverlayCSR)
    assert pd.csr._res is node.residency
    assert pd.csr._res_kind == "csr:merged"
    assert pd.csr.base._res is node.residency
    assert pd.csr.base._res_kind == "csr"
    assert pd.csr.device_nbytes() == pd.csr.approx_nbytes()
    ti = node.snapshot().pred("name").indexes["exact"]
    assert isinstance(ti, tdelta.LazyTokenIndex)
    assert ti._res is node.residency and ti._res_kind == "index:exact"
