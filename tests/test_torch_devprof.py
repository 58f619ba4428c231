"""The port's device observatory (obs/devprof.py) against the JAX
package's, on the CPU.

The ring, the Chrome trace JSON, the retrace-storm detector (fed through
the module fan-out `note_build`), the HBM pressure latch and the disarm
contract take the same inputs in both packages and must give equal
records, counters and families. Torch meanings are pinned where they
differ: builds report through `note_compile` (there is no jax.monitoring
listener), /debug/compiles lists the port's program families, and the
residency spine reports the managed HBM tier and host folds on the CPU
(the JAX spine passes `usage()`'s dict to int() and reports nothing).
The CUDA-event device intervals of the timeline run on the card only
(chip_smoke.py phase 11).
"""

import json
import random
import threading
import urllib.request

import pytest
import torch

from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.obs import devprof as jdevprof
from dgraph_tpu.utils import metrics as jmetrics

from dgraph_tpu_torch.api.http import make_server
from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.obs import costs
from dgraph_tpu_torch.obs import devprof as devprof_mod
from dgraph_tpu_torch.obs.devprof import DevProfiler
from dgraph_tpu_torch.utils import metrics as metrics_mod

SCHEMA = """
    name: string @index(exact) .
    age: int @index(int) .
    follows: [uid] @reverse .
"""
DATA = """
    _:a <name> "ann" .
    _:b <name> "bob" .
    _:c <name> "cid" .
    _:a <age> "30" .
    _:a <follows> _:b .
    _:a <follows> _:c .
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def node():
    n = Node(span_sample=1.0, trace_rng=random.Random(11), device="cpu")
    n.alter(schema_text=SCHEMA)
    n.mutate(set_nquads=DATA, commit_now=True)
    yield n
    n.close()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        assert r.status == 200
        return json.loads(r.read())


class _RecordingLog:
    def __init__(self):
        self.entries = []

    def record(self, entry):
        self.entries.append(entry)


def _profs(**kw):
    """(JAX profiler, port profiler) with the same arguments."""
    return (jdevprof.DevProfiler(jmetrics.Registry(), **kw),
            DevProfiler(metrics_mod.Registry(), **kw))


def _families(prof):
    return {k: {f: v[f] for f in ("builds", "compiles", "storms",
                                  "last_shape", "recent_shapes")}
            for k, v in prof.compiles_snapshot()["families"].items()}


# ---------------------------------------------------------------------------
# profiler unit behavior, both packages on the same inputs
# ---------------------------------------------------------------------------

def test_retrace_storm_through_note_build_equals_jax(monkeypatch):
    """The seeded storm fixture, driven through each package's module
    fan-out: one family rebuilt under >= 3 distinct keys within the window
    flags exactly once; a second family has its own window."""
    logs = (_RecordingLog(), _RecordingLog())
    jp = jdevprof.DevProfiler(jmetrics.Registry(), slow_log=logs[0])
    tp = DevProfiler(metrics_mod.Registry(), slow_log=logs[1])
    monkeypatch.setattr(jdevprof, "_PROFILERS", (jp,))
    monkeypatch.setattr(devprof_mod, "_PROFILERS", (tp,))
    for mod in (jdevprof, devprof_mod):
        mod.note_build("pb.recurse_fused", ("recurse", 64))
        mod.note_build("pb.recurse_fused", ("recurse", 128))
    assert tp._m.counter("dgraph_xla_retrace_storms_total").value == 0
    for mod in (jdevprof, devprof_mod):
        for cap in (256, 512, 1024, 2048, 4096, 8192):
            mod.note_build("pb.recurse_fused", ("recurse", cap))
        for cap in (1, 2, 3, 4):
            mod.note_build("pb.bfs_dist", ("bfs", cap))
    for p, log in ((jp, logs[0]), (tp, logs[1])):
        assert p._m.counter("dgraph_xla_retrace_storms_total").value == 2
        assert [e["family"] for e in log.entries] == ["pb.recurse_fused",
                                                      "pb.bfs_dist"]
        assert log.entries[0]["root"] == "retrace_storm"
    assert _families(jp) == _families(tp)
    snap = tp.compiles_snapshot()
    assert snap["families"]["pb.recurse_fused"]["builds"] == 8
    assert snap["retrace_storms"] == 2
    strip = lambda e: {k: v for k, v in e.items() if k != "ts"}
    assert [strip(e) for e in logs[0].entries] == \
        [strip(e) for e in logs[1].entries]


def test_note_compile_attributes_family_and_books_ledger(monkeypatch):
    """A kernel library build: a compile of its family on every armed
    profiler (as the JAX listener books one XLA compile) and compile_ms on
    the current ledger, kept apart from device_ms."""
    jp, tp = _profs()
    monkeypatch.setattr(devprof_mod, "_PROFILERS", (tp,))
    lg = costs.CostLedger(endpoint="query", shape="{ q }")
    with costs.scope(lg):
        devprof_mod.note_compile("pb.active_prefix", 25.0)
    jdevprof.push_family("pb.active_prefix")
    try:
        jp.on_compile(jdevprof.current_family(), 25.0)
    finally:
        jdevprof.pop_family()
    f = tp.compiles_snapshot()["families"]["pb.active_prefix"]
    assert f["compiles"] == 1 and f["compile_ms"] == pytest.approx(25.0)
    assert lg.compile_ms == pytest.approx(25.0) and lg.device_ms == 0.0
    assert jp.compiles_snapshot()["families"] == \
        tp.compiles_snapshot()["families"]
    assert tp._m.counter("dgraph_xla_compiles_total").value == 1


def test_note_compile_is_noop_when_disarmed(monkeypatch):
    monkeypatch.setattr(devprof_mod, "_PROFILERS", ())
    lg = costs.CostLedger(endpoint="query")
    with costs.scope(lg):
        devprof_mod.note_compile("pb.active_prefix", 500.0)
    assert lg.compile_ms == 0.0


def test_hbm_pressure_latches_against_budget():
    """The latch and the high-water marks, on a residency stub read the
    way each package reads it (the port takes usage()['hbm_bytes'])."""

    class _Residency:
        bytes_live = 0

        def __init__(self, as_dict):
            self.as_dict = as_dict

        def usage(self):
            return {"hbm_bytes": self.bytes_live} if self.as_dict \
                else self.bytes_live

        def host_bytes(self):
            return 0

    res = (_Residency(False), _Residency(True))
    profs = (jdevprof.DevProfiler(jmetrics.Registry(), budget_bytes=1000,
                                  residency=res[0]),
             DevProfiler(metrics_mod.Registry(), budget_bytes=1000,
                         residency=res[1]))
    for live in (500, 950, 950, 100, 980):
        for r, p in zip(res, profs):
            r.bytes_live = live
            p.record_dispatch("expand", 0.0, 0.0, 0.001)
    for p in profs:
        assert p._m.counter("dgraph_devprof_hbm_pressure_total").value == 2
    assert profs[0].hbm_snapshot() == profs[1].hbm_snapshot()
    assert profs[1].hbm_snapshot()["high_water"]["hbm"] == 980


def test_hbm_spine_reports_on_cpu(node):
    """The residency spine on a CPU Node: the managed HBM tier (device
    columns of the CPU snapshot, accounted as they upload) and the host
    folds. The JAX profiler's spine stays empty over a real manager."""
    node.query('{ q(func: eq(name, "ann")) { name follows { name } } }')
    hw = node.devprof.hbm_snapshot()
    assert hw["capable"] is False          # no CUDA allocator on the CPU
    assert hw["high_water"]["host"] > 0
    assert "hbm" in hw["high_water"] and "device" not in hw["high_water"]
    j = JNode(batching=False)
    try:
        j.alter(schema_text=SCHEMA)
        j.mutate(set_nquads=DATA, commit_now=True)
        j.query('{ q(func: eq(name, "ann")) { name follows { name } } }')
        assert "hbm" not in j.devprof.hbm_snapshot()["high_water"]
    finally:
        j.close()


def test_timeline_ring_and_chrome_trace_shape(monkeypatch):
    jp, tp = _profs()
    for mod, p in ((jdevprof, jp), (devprof_mod, tp)):
        p.record_dispatch("host", 1.0, 1.002, 1.010, bytes_moved=64)
        monkeypatch.setattr(mod, "_PROFILERS", (p,))
        mod.push_family("pb.recurse_fused")
        try:
            p.record_dispatch("recurse", 2.0, 2.001, 2.005)
        finally:
            mod.pop_family()
    strip = lambda recs: [{k: v for k, v in r.items() if k != "ts"}
                          for r in recs]
    recs = tp.timeline_snapshot()
    assert strip(recs) == strip(jp.timeline_snapshot())
    assert [r["seq"] for r in recs] == [1, 2]
    assert recs[0]["family"] == "host" and recs[0]["bytes"] == 64
    assert recs[0]["queue_ms"] == pytest.approx(2.0)
    assert recs[0]["run_ms"] == pytest.approx(8.0)
    assert recs[1]["family"] == "pb.recurse_fused"
    assert "device_ms" not in recs[0]        # no CUDA events on the CPU
    ct = tp.timeline_chrome()
    jct = jp.timeline_chrome()
    assert ct["displayTimeUnit"] == "ms"
    assert [(e["name"], e["ph"], e.get("tid")) for e in ct["traceEvents"]] \
        == [(e["name"], e["ph"], e.get("tid")) for e in jct["traceEvents"]]
    names = [e["name"] for e in ct["traceEvents"]]
    assert "host (queued)" in names and "pb.recurse_fused" in names
    assert all(e["dur"] > 0 for e in ct["traceEvents"] if e["ph"] == "X")
    assert ct["otherData"] == jct["otherData"]
    assert tp.dispatch_in_flight_share() is None


def test_device_busy_share_merges_intervals():
    """The dispatch-in-flight share: the union of resolved device
    intervals over their span, in [0, 1] (overlapping dispatches count
    once). It is reported under that name, not as device busy time: each
    interval spans its dispatch's host work too."""
    tp = DevProfiler(metrics_mod.Registry())
    for i, iv in enumerate([(0.0, 2.0), (1.0, 2.0), (6.0, 1.0),
                            (8.0, 2.0)]):
        tp.record_dispatch("expand", 0.0, 0.0, 0.001,
                           device=[None, None, iv])
    # busy [0, 3] + [6, 7] + [8, 10] = 6 of a 10 ms span
    assert tp.dispatch_in_flight_share() == pytest.approx(0.6)
    recs = tp.timeline_snapshot()
    assert [r["device_ms"] for r in recs] == [2.0, 2.0, 1.0, 2.0]
    other = tp.timeline_chrome()["otherData"]
    assert other["dispatch_in_flight_share"] == pytest.approx(0.6)
    assert "device_busy_share" not in other


class _Event:
    """A stand-in CUDA event: elapsed_time reads the two stamps."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_interval_is_not_clamped():
    """Events resolved out of order give a negative interval, reported as
    it is, so a reader's non-negative check can fail."""
    tp = DevProfiler(metrics_mod.Registry())
    tp._origin = _Event(10.0)
    tp.record_dispatch("expand", 0.0, 0.0, 0.001,
                       device=[_Event(12.0), _Event(15.5), None])
    tp.record_dispatch("expand", 0.0, 0.0, 0.001,
                       device=[_Event(9.0), _Event(8.75), None])
    recs = tp.timeline_snapshot()
    assert [(r["device_start_ms"], r["device_ms"]) for r in recs] == \
        [(2.0, 3.5), (-1.0, -0.25)]


def test_tiers_sampled_at_the_refresh_cadence_on_cuda():
    """A CUDA profiler reads the allocator and the residency spine (which
    walks every live PredData) every UTIL_REFRESH dispatches and when the
    HBM snapshot is taken, not per dispatch. A CPU profiler, which has no
    allocator, reads the spine on every dispatch."""

    class _Residency:
        def __init__(self):
            self.usage_calls = self.host_calls = 0

        def usage(self):
            self.usage_calls += 1
            return {"hbm_bytes": 100 * self.usage_calls}

        def host_bytes(self):
            self.host_calls += 1
            return 7

    res = _Residency()
    tp = DevProfiler(metrics_mod.Registry(), residency=res)
    tp._cuda = tp._hbm_capable = True
    reads = []
    tp._device_bytes = lambda: reads.append(1) or (500, 900)
    n = 3 * DevProfiler.UTIL_REFRESH + 5
    for _ in range(n):
        tp.record_dispatch("expand", 0.0, 0.0, 0.001)
    assert len(reads) == 3
    assert (res.usage_calls, res.host_calls) == (3, 3)
    hw = tp.hbm_snapshot()["high_water"]
    assert len(reads) == 4
    assert (res.usage_calls, res.host_calls) == (4, 4)
    assert hw == {"device": 900, "hbm": 400, "host": 7}

    cpu_res = _Residency()
    cp = DevProfiler(metrics_mod.Registry(), residency=cpu_res)
    for _ in range(5):
        cp.record_dispatch("expand", 0.0, 0.0, 0.001)
    assert (cpu_res.usage_calls, cpu_res.host_calls) == (5, 5)


# ---------------------------------------------------------------------------
# node integration: every dispatch exactly once
# ---------------------------------------------------------------------------

def test_every_gated_dispatch_lands_exactly_once(node):
    for _ in range(4):
        node.query('{ q(func: eq(name, "ann")) { name follows { name } } }')
    disp = node.metrics.counter("dgraph_devprof_dispatches_total").value
    assert disp > 0
    recs = node.devprof.timeline_snapshot(n=4096)
    assert len(recs) == disp
    assert [r["seq"] for r in recs] == list(range(1, disp + 1))
    assert all(r["family"] for r in recs)
    assert all(r["run_ms"] >= 0.0 and r["queue_ms"] >= 0.0 for r in recs)


def test_shed_and_failed_dispatches_do_not_record(node):
    before = node.metrics.counter("dgraph_devprof_dispatches_total").value

    def boom():
        raise RuntimeError("kernel exploded")

    with pytest.raises(RuntimeError):
        node.dispatch_gate.run(boom, klass="host")
    after = node.metrics.counter("dgraph_devprof_dispatches_total").value
    assert after == before + 1
    assert len(node.devprof.timeline_snapshot(n=4096)) == after


def test_node_defaults_match_the_jax_node():
    """Planner, batcher and observatory on, a manager always present, as
    the JAX Node has them; the same /debug/metrics keys for each seam."""
    from dgraph_tpu.api.http import _serving_metrics as jsm

    from dgraph_tpu_torch.api.http import _serving_metrics as tsm

    t, j = Node(device="cpu"), JNode()
    try:
        for n in (t, j):
            n.alter(schema_text=SCHEMA)
            n.mutate(set_nquads=DATA, commit_now=True)
            n.query('{ q(func: has(name)) { name follows { name } } }')
        assert t.planner_enabled is j.planner_enabled is True
        assert t.batcher is not None and j.batcher is not None
        assert t.devprof is not None and j.devprof is not None
        assert t.dispatch_gate.profiler is t.devprof
        assert t.residency is not None and not t.residency.enabled
        assert t.store.residency is t.residency
        ts, js = tsm(t), jsm(j)
        for sec in ("batching", "planner", "devprof", "residency"):
            assert list(ts[sec]) == list(js[sec]), sec
        assert ts["batching"]["enabled"] is js["batching"]["enabled"]
        assert ts["planner"]["plans_built"] == js["planner"]["plans_built"]
    finally:
        t.close()
        j.close()


# ---------------------------------------------------------------------------
# disarm contract
# ---------------------------------------------------------------------------

def test_no_devprof_disarms_every_seam():
    n = Node(devprof=False, device="cpu")
    try:
        n.alter(schema_text=SCHEMA)
        n.mutate(set_nquads='_:a <name> "ann" .', commit_now=True)
        assert n.devprof is None and n.dispatch_gate.profiler is None
        r, _ = n.query('{ q(func: eq(name, "ann")) { name } }')
        assert r["q"] == [{"name": "ann"}]
        assert n.metrics.counter(
            "dgraph_devprof_dispatches_total").value == 0
        n.set_devprof(True)
        prof = n.devprof
        assert prof is not None and n.dispatch_gate.profiler is prof
        assert prof in devprof_mod._PROFILERS
        n.query('{ q(func: has(name)) { name } }')
        assert n.metrics.counter(
            "dgraph_devprof_dispatches_total").value > 0
        n.set_devprof(False)
        assert n.devprof is None and n.dispatch_gate.profiler is None
        assert prof not in devprof_mod._PROFILERS
    finally:
        n.close()


def test_close_unregisters_from_module_fanout(node):
    prof = node.devprof
    assert prof in devprof_mod._PROFILERS
    node.close()
    assert prof not in devprof_mod._PROFILERS


# ---------------------------------------------------------------------------
# /debug surfaces
# ---------------------------------------------------------------------------

def test_debug_compiles_and_timeline_endpoints(node):
    srv = make_server(node, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        node.query('{ q(func: eq(name, "ann")) { name follows { name } } }')
        node.devprof.on_build("pb.recurse_fused", ("recurse", 64))
        c = _get(base, "/debug/compiles")
        assert c["enabled"] is True
        assert c["families"]["pb.recurse_fused"]["builds"] == 1
        assert "(" in c["families"]["pb.recurse_fused"]["last_shape"]
        # the port's families, under the JAX names; torch ops hold no
        # per-shape programs
        import dgraph_tpu_torch.ops.pull_bfs  # noqa: F401
        import dgraph_tpu_torch.ops.segments  # noqa: F401

        c = _get(base, "/debug/compiles")
        sizes = c["cache_sizes"]
        for fam in ("pb.active_prefix", "pb.active_prefix_sparse",
                    "pb.recurse_fused", "pb.recurse_fused_multi",
                    "segments.reduce", "segments.rank_kernel"):
            assert fam in sizes, fam
        assert sizes["pb.recurse_fused_multi"] == 0
        assert sizes["pb.active_prefix"] in (0, 1)
        t = _get(base, "/debug/timeline")
        assert t["displayTimeUnit"] == "ms"
        assert t["otherData"]["records"] > 0
        assert any(e["ph"] == "X" for e in t["traceEvents"])
        raw = _get(base, "/debug/timeline?view=raw&n=8")
        assert isinstance(raw, list) and len(raw) <= 8
        assert all("family" in r for r in raw)
        idx = _get(base, "/debug")["endpoints"]
        assert "/debug/compiles" in idx and "/debug/timeline" in idx
        dm = _get(base, "/debug/metrics")
        assert dm["devprof"]["enabled"] is True
        assert dm["devprof"]["dispatches"] > 0
    finally:
        srv.shutdown()


def test_debug_surfaces_honest_when_disarmed():
    n = Node(devprof=False, device="cpu")
    srv = make_server(n, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert _get(base, "/debug/compiles") == {"enabled": False}
        assert _get(base, "/debug/timeline") == {"enabled": False}
        assert _get(base, "/debug/metrics")["devprof"] == {
            "enabled": False}
    finally:
        srv.shutdown()
        n.close()


def test_subscription_costs_group_by_sub(node):
    sub = node.subscribe('{ q(func: has(name)) { name } }')
    try:
        ev = sub.next(5)
        assert ev["type"] == "init"
        top = node.cost_book.top(group="sub", endpoint="live")
        keys = [row["key"] for row in top["top"]]
        assert sub.id in keys, top
        row = top["top"][keys.index(sub.id)]
        assert row["records"] >= 1 and row["wall_ms"] > 0
        node.mutate(set_nquads='_:z <name> "zed" .', commit_now=True)
        assert sub.next(5)["type"] == "diff"
        top2 = node.cost_book.top(group="sub", endpoint="live")
        row2 = [r for r in top2["top"] if r["key"] == sub.id][0]
        assert row2["records"] >= row["records"]
    finally:
        sub.cancel()
