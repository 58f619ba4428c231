"""Device-runtime observatory: build tracking, device-memory telemetry,
and a dispatch-timeline utilization profiler.

Port of dgraph_tpu/obs/devprof.py. Three surfaces, with their torch
meanings:

  * compile observatory — nothing in the port compiles per request or per
    shape: its torch ops run eagerly and its two hand kernels build once
    per process. The builds that do happen — the nvcc build of
    ops/csrc/active_prefix.cu (ops/prefix._load, family
    "pb.active_prefix") and the g++ build of the posting codec
    (storage/native.py, family "storage.native") — report through
    `note_compile(family, ms)`: each counts as a compile of its family
    with its wall ms, and the request that triggered it gets that time as
    its ledger's compile_ms. `note_build(family, key)` is the fan-out for
    process-global build sites, kept for the retrace-storm detector: a
    family building >= STORM_MIN_BUILDS programs from >= STORM_MIN_SHAPES
    distinct keys inside STORM_WINDOW_S is flagged into the slow-query log
    (root="retrace_storm") and counted on dgraph_xla_retrace_storms_total.
    There is no jax.monitoring listener. GET /debug/compiles serves the
    per-family counts plus the program-cache probes, which report what is
    true of a torch function: the programs it holds built (the one K1/K2
    library once loaded, 0 for torch-op functions).
  * device-memory telemetry — live/peak device bytes from
    torch.cuda.memory_stats ("allocated_bytes.all.current" / ".peak",
    never the allocator's reserved bytes) on a CUDA profiler, and the
    ResidencyManager's tier accounting as the spine everywhere (the CPU
    included). Both reads cost tens of microseconds or more (memory_stats
    flattens the allocator's whole table; the spine walks every live
    PredData), so a CUDA profiler samples them every UTIL_REFRESH
    dispatches and when /debug/metrics is read: the allocator's peak is
    cumulative, so the high-water mark loses nothing. A CPU profiler has
    only the spine and samples it on every dispatch, as the JAX profiler
    does. High-water marks per tier land on
    dgraph_devprof_hbm_highwater_bytes{tier=...}; a peak crossing the
    --device_budget_mb headroom raises a pressure flag.
  * dispatch timeline — a bounded ring of (program family, queue-entry,
    launch, fence, bytes moved) records fed from DispatchGate.run, the one
    chokepoint every device dispatch passes. The gate returns when `fn`
    returns, and CUDA work may still be queued then, so on a CUDA profiler
    the gate also records a pair of CUDA events around `fn`; they are
    resolved into the record's device interval (device_start_ms,
    device_ms) only when the ring is read — the gate never synchronizes.
    The interval runs from the device reaching the event before `fn` to
    the device reaching the one after it, so it spans `fn`'s host work and
    enqueue gaps as well as its kernels: it bounds the dispatch's device
    time from above and is not device busy time (a torch.profiler trace
    gives that).
    Exported as Chrome trace-event JSON at /debug/timeline, plus the
    dgraph_device_utilization / queue-gap / dispatch-ms meters.

Disarm contract (--no_devprof): the gate checks one attribute (None) and
the kernel timer one module tuple (empty).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils import locks

# -- global registration seam ------------------------------------------------
#
# Per-node profilers attach directly where a node owns the seam
# (DispatchGate.profiler). Process-global build sites (the kernel library
# builds of ops/prefix.py and storage/native.py) fan out through this
# copy-on-write tuple instead: reads are one load of an (almost always
# empty) tuple, writes swap the whole tuple under the lock.

_PROFILERS: tuple = ()
_reg_lock = threading.Lock()

# thread-local program-family stack: costs._KernelTimer pushes its kernel
# name here while any profiler is armed, so compile events and timeline
# records pick up the fine-grained family ("pb.recurse_fused")
# instead of the coarse gate class
_tls = threading.local()


def armed() -> bool:
    return bool(_PROFILERS)


def push_family(name: str) -> None:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    st.append(name)


def pop_family() -> None:
    st = getattr(_tls, "stack", None)
    if st:
        st.pop()


def current_family(default: str | None = None) -> str | None:
    st = getattr(_tls, "stack", None)
    return st[-1] if st else default


def note_build(family: str, key=None) -> None:
    """A process-global build site constructed one program. One tuple load
    when nothing is armed."""
    for p in _PROFILERS:
        p.on_build(family, key)


def note_compile(family: str, ms: float) -> None:
    """One build of a kernel library finished after `ms` of wall time (the
    nvcc build of ops/csrc/active_prefix.cu, the g++ build of the posting
    codec): a compile of `family` on every armed profiler, and compile_ms
    on the cost ledger of the request that triggered it."""
    profs = _PROFILERS
    if not profs:
        return
    for p in profs:
        p.on_compile(family, ms)
    from . import costs

    lg = costs.current()
    if lg is not None:
        lg.add_compile(ms)


def register(p: "DevProfiler") -> None:
    global _PROFILERS
    with _reg_lock:
        if p not in _PROFILERS:
            _PROFILERS = _PROFILERS + (p,)


def unregister(p: "DevProfiler") -> None:
    global _PROFILERS
    with _reg_lock:
        _PROFILERS = tuple(x for x in _PROFILERS if x is not p)


def _sig(key) -> str:
    """Compact shape signature of one build trigger."""
    if key is None:
        return ""
    s = repr(key)
    return s if len(s) <= 200 else s[:197] + "..."


class DevProfiler:
    """One node's device-runtime observatory (all three surfaces).

    Constructed by Node when devprof is on, attached as
    DispatchGate.profiler and registered on the module fan-out; never
    constructed under --no_devprof. `device` is the node's: a CUDA device
    arms the torch.cuda.memory_stats telemetry and the CUDA-event device
    intervals of the timeline.
    """

    # retrace-storm detection: >= STORM_MIN_BUILDS compile/build events
    # of ONE family with >= STORM_MIN_SHAPES distinct trigger signatures
    # inside STORM_WINDOW_S, flagged at most once per window per family.
    # (A fresh program cache warming N distinct keys is normal; churn
    # past these floors means shapes are NOT converging to the cache.)
    STORM_WINDOW_S = 30.0
    STORM_MIN_BUILDS = 4
    STORM_MIN_SHAPES = 3
    # HBM pressure: peak over this fraction of the device budget
    PRESSURE_HEADROOM = 0.9
    # utilization gauge refresh cadence (dispatches)
    UTIL_REFRESH = 32

    def __init__(self, metrics, slow_log=None, budget_bytes: int = 0,
                 residency=None, ring_size: int = 2048,
                 device=None) -> None:
        import torch

        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._cuda = self.device.type == "cuda"
        self._origin = None              # (CUDA event, perf_counter) pair
        self._m = metrics
        self._slow_log = slow_log
        self._residency = residency
        self.budget_bytes = int(budget_bytes)
        self._lock = locks.Lock("devprof.DevProfiler._lock")
        # family -> {"builds", "compiles", "compile_ms", "storms",
        #            "shapes": deque[(mono_ts, sig)], "last": str,
        #            "storm_at": float}
        self._fams: dict[str, dict] = {}
        # timeline ring: (seq, mono_ts, family, klass, queue_ms, run_ms,
        #                 bytes_moved, device) — device is None, or a
        #                 [start event, end event, resolved interval] list
        self._ring: deque = deque(maxlen=max(int(ring_size), 16))
        self._seq = 0
        self._busy_ms = 0.0              # cumulative fenced run ms
        self._born = time.monotonic()
        self._cache_probes: list[tuple[str, object]] = []
        self._hbm_capable: bool | None = None
        self._high_water: dict[str, int] = {}
        self._pressure_latched = False
        # metric objects cached once — record_dispatch is the hot path
        self._c_compiles = metrics.counter("dgraph_xla_compiles_total")
        self._c_storms = metrics.counter(
            "dgraph_xla_retrace_storms_total")
        self._c_disp = metrics.counter("dgraph_devprof_dispatches_total")
        self._c_pressure = metrics.counter(
            "dgraph_devprof_hbm_pressure_total")
        self._g_util = metrics.counter("dgraph_device_utilization")
        self._g_budget = metrics.counter("dgraph_devprof_hbm_budget_bytes")
        self._k_hbm = metrics.keyed("dgraph_devprof_hbm_highwater_bytes",
                                    labels=("tier",))
        self._h_compile = metrics.histogram("dgraph_xla_compile_ms")
        self._h_gap = metrics.histogram("dgraph_device_queue_gap_ms")
        self._h_disp = metrics.histogram("dgraph_device_dispatch_ms")
        self._g_budget.set(self.budget_bytes)

    # -- compile observatory -------------------------------------------------

    def _fam_locked(self, family: str) -> dict:
        f = self._fams.get(family)
        if f is None:
            f = self._fams[family] = {
                "builds": 0, "compiles": 0, "compile_ms": 0.0,
                "storms": 0, "shapes": deque(maxlen=64), "last": "",
                "storm_at": 0.0}
        return f

    def on_build(self, family: str, key=None) -> None:
        """One build site built a new program — the shape signature is the
        key that missed."""
        self._note_event(family, _sig(key), compile_ms=None)

    def on_compile(self, family: str, ms: float) -> None:
        """One kernel library build completed (note_compile). The trigger
        signature is synthetic — each compile of an already-seen family is
        a fresh signature by definition."""
        self._c_compiles.inc()
        self._h_compile.observe(ms)
        self._note_event(family, None, compile_ms=ms)

    def _note_event(self, family: str, sig: str | None,
                    compile_ms: float | None) -> None:
        now = time.monotonic()
        storm = None
        with self._lock:
            f = self._fam_locked(family)
            if compile_ms is None:
                f["builds"] += 1
            else:
                f["compiles"] += 1
                f["compile_ms"] += compile_ms
                sig = f"compile#{f['compiles']}"
            if sig:
                f["last"] = sig
            f["shapes"].append((now, sig or ""))
            recent = [s for t, s in f["shapes"]
                      if now - t <= self.STORM_WINDOW_S]
            if (len(recent) >= self.STORM_MIN_BUILDS
                    and len(set(recent)) >= self.STORM_MIN_SHAPES
                    and now - f["storm_at"] > self.STORM_WINDOW_S):
                f["storm_at"] = now
                f["storms"] += 1
                storm = {"family": family, "builds_in_window": len(recent),
                         "distinct_shapes": len(set(recent)),
                         "window_s": self.STORM_WINDOW_S,
                         "last_shape": f["last"]}
        if storm is not None:
            self._c_storms.inc()
            if self._slow_log is not None:
                self._slow_log.record({
                    "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                        time.gmtime()),
                    "root": "retrace_storm",
                    "reason": "retrace_storm",
                    "elapsed_ms": 0.0,
                    **storm})

    def add_cache_probe(self, name: str, fn) -> None:
        """Register a live program-cache size callable for
        /debug/compiles (the ops modules' JIT_PROGRAMS registries). Probes
        must be cheap; exceptions are handled here."""
        with self._lock:
            self._cache_probes.append((name, fn))

    def compiles_snapshot(self) -> dict:
        """GET /debug/compiles payload."""
        with self._lock:
            fams = {
                name: {"builds": f["builds"], "compiles": f["compiles"],
                       "compile_ms": round(f["compile_ms"], 3),
                       "storms": f["storms"], "last_shape": f["last"],
                       "recent_shapes": [s for _t, s in f["shapes"]][-8:]}
                for name, f in sorted(self._fams.items())}
            probes = list(self._cache_probes)
        caches = {}
        for name, fn in probes:
            try:
                v = fn()
            except Exception:
                caches[name] = -1
                continue
            if isinstance(v, dict):
                # one probe may report a whole group of caches (the ops
                # modules' JIT_PROGRAMS registries, keyed by family)
                for k, x in v.items():
                    caches[str(k)] = int(x)
            else:
                caches[name] = int(v)
        return {
            "enabled": True,
            "families": fams,
            "cache_sizes": caches,
            "compiles": self._c_compiles.value,
            "compile_ms_total": round(sum(
                f["compile_ms"] for f in fams.values()), 3),
            "retrace_storms": self._c_storms.value,
        }

    # -- HBM telemetry -------------------------------------------------------

    def _probe_hbm_locked(self) -> None:
        """One-time capability probe: the CUDA caching allocator reports
        device bytes; a CPU profiler has only the residency spine."""
        self._hbm_capable = self._cuda

    def _device_bytes(self) -> tuple[int, int]:
        """(live, peak) device bytes from the caching allocator's
        allocated (not reserved) counters, 0s on the CPU."""
        if not self._hbm_capable:
            return 0, 0
        import torch

        st = torch.cuda.memory_stats(self.device)
        return (int(st.get("allocated_bytes.all.current", 0)),
                int(st.get("allocated_bytes.all.peak", 0)))

    def _sample_hbm_locked(self) -> dict | None:
        """Tier sample: returns a pressure event dict when peak newly
        crosses the budget headroom, else None. The keyed high-water
        gauge is only touched on a new high-water mark."""
        if self._hbm_capable is None:
            self._probe_hbm_locked()
        tiers: dict[str, int] = {}
        live, peak = self._device_bytes()
        if live or peak:
            tiers["device"] = peak or live
        r = self._residency
        if r is not None:
            # the JAX version passes usage()'s dict to int() and its
            # except swallows the TypeError, so its spine never reports;
            # here the managed HBM tier and the host folds are read
            tiers["hbm"] = int(r.usage()["hbm_bytes"])
            tiers["host"] = int(r.host_bytes())
        hw_peak = 0
        for tier, v in tiers.items():
            if v > self._high_water.get(tier, -1):
                self._high_water[tier] = v
                self._k_hbm.set(tier, v)
        hw_peak = max(tiers.get("device", 0), tiers.get("hbm", 0))
        if not self.budget_bytes:
            return None
        threshold = self.PRESSURE_HEADROOM * self.budget_bytes
        if hw_peak > threshold:
            if not self._pressure_latched:
                self._pressure_latched = True
                return {"peak_bytes": hw_peak,
                        "budget_bytes": self.budget_bytes,
                        "headroom": self.PRESSURE_HEADROOM}
        elif hw_peak < 0.8 * self.budget_bytes:
            self._pressure_latched = False   # re-arm after back-off
        return None

    def hbm_snapshot(self) -> dict:
        with self._lock:
            pressure = self._sample_hbm_locked()
        if pressure is not None:
            self._note_pressure("hbm_snapshot", pressure)
        with self._lock:
            return {"capable": bool(self._hbm_capable),
                    "budget_bytes": self.budget_bytes,
                    "high_water": dict(self._high_water),
                    "pressure_events": self._c_pressure.value}

    # -- dispatch timeline ---------------------------------------------------

    def begin_device(self):
        """A CUDA event recorded on the current stream just before a gated
        `fn` runs, or None on a CPU profiler. Never synchronizes."""
        if not self._cuda:
            return None
        import torch

        if self._origin is None:
            origin = torch.cuda.Event(enable_timing=True)
            origin.record()
            with self._lock:
                if self._origin is None:
                    self._origin = origin
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def end_device(self, start):
        """The matching end event (recorded once `fn` has returned and its
        work is enqueued), as the record's unresolved device interval."""
        if start is None:
            return None
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record()
        return [start, end, None]

    def _resolve(self, dev) -> tuple[float, float] | None:
        """(device_start_ms since the profiler's origin event, device_ms)
        of one record; waits for the end event, so it runs only where the
        ring is read, never in the gate. Unclamped: a negative value means
        the events were recorded out of order."""
        if dev is None:
            return None
        if dev[2] is None:
            start, end = dev[0], dev[1]
            end.synchronize()
            dev[2] = (self._origin.elapsed_time(start),
                      start.elapsed_time(end))
        return dev[2]

    def record_dispatch(self, klass: str | None, t_queue: float,
                        t_launch: float, t_fence: float,
                        bytes_moved: int = 0, device=None) -> None:
        """One gated device dispatch completed (called from
        DispatchGate.run's finally — every solo task and batch leader
        passes exactly once). Timestamps are perf_counter values from the
        gate itself; `device` is end_device's unresolved interval."""
        family = current_family(None) or (klass or "device")
        queue_ms = max((t_launch - t_queue) * 1e3, 0.0)
        run_ms = max((t_fence - t_launch) * 1e3, 0.0)
        pressure = None
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._ring.append((seq, time.monotonic(), family,
                               klass or "", queue_ms, run_ms,
                               int(bytes_moved), device))
            self._busy_ms += run_ms
            refresh = seq % self.UTIL_REFRESH == 0
            pressure = self._sample_hbm_locked() \
                if refresh or not self._cuda else None
        self._c_disp.inc()
        self._h_gap.observe(queue_ms)
        self._h_disp.observe(run_ms)
        if refresh:
            self._refresh_utilization()
        if pressure is not None:
            self._note_pressure(family, pressure)

    def _note_pressure(self, family: str, pressure: dict) -> None:
        self._c_pressure.inc()
        from . import otrace

        otrace.event("hbm_pressure", family=family, **pressure)

    def _refresh_utilization(self) -> None:
        """Derived occupancy gauge: fenced device-busy ms over the
        trailing ring window, as a 0-100 percentage (can exceed 100 on a
        gate wider than 1 — concurrent dispatches overlap)."""
        with self._lock:
            if not self._ring:
                self._g_util.set(0.0)
                return
            oldest = self._ring[0][1]
            busy = sum(r[5] for r in self._ring)
        wall_ms = max((time.monotonic() - oldest) * 1e3, 1e-3)
        self._g_util.set(round(min(busy / wall_ms, 10.0) * 100.0, 2))

    def timeline_snapshot(self, n: int = 256) -> list[dict]:
        """The newest n records; on a CUDA profiler each carries its
        resolved device interval (device_start_ms, device_ms)."""
        with self._lock:
            recs = list(self._ring)[-max(int(n), 1):]
        out = []
        for s, ts, fam, kl, qm, rm, b, dev in recs:
            r = {"seq": s, "ts": ts, "family": fam, "klass": kl,
                 "queue_ms": round(qm, 3), "run_ms": round(rm, 3),
                 "bytes": b}
            iv = self._resolve(dev)
            if iv is not None:
                r["device_start_ms"] = round(iv[0], 4)
                r["device_ms"] = round(iv[1], 4)
            out.append(r)
        return out

    def dispatch_in_flight_share(self) -> float | None:
        """The share of the device clock, over the ring's span of device
        intervals, in which at least one recorded dispatch was between its
        two CUDA events (the union of the intervals): in [0, 1]. Each
        interval spans its dispatch's host work too, so this bounds the
        device's busy share from above and is not that share. None on a
        CPU profiler or an empty ring."""
        with self._lock:
            devs = [r[7] for r in self._ring if r[7] is not None]
        ivs = sorted(self._resolve(d) for d in devs)
        if not ivs:
            return None
        busy, cur_s, cur_e = 0.0, ivs[0][0], ivs[0][0] + ivs[0][1]
        for st, dur in ivs[1:]:
            if st > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = st, st + dur
            else:
                cur_e = max(cur_e, st + dur)
        busy += cur_e - cur_s
        span = cur_e - ivs[0][0]        # the last merged run ends last
        return busy / span if span > 0 else 1.0

    def timeline_chrome(self) -> dict:
        """The /debug/timeline payload: Chrome trace-event JSON in the
        same envelope as /debug/traces/<id> (obs/otrace.chrome_trace),
        so it drops into the existing Perfetto workflow. Two tracks per
        record: queue wait and fenced execution."""
        with self._lock:
            recs = list(self._ring)
            busy = self._busy_ms
        events: list[dict] = [
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
             "args": {"name": "device.queue"}},
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": 2,
             "args": {"name": "device.run"}},
        ]
        if recs:
            t0 = recs[0][1]
            for seq, ts, fam, kl, qm, rm, b, _dev in recs:
                # ts is the FENCE time (appended at completion): rebase
                # launch = fence - run, queue-entry = launch - queue
                fence_us = (ts - t0) * 1e6
                launch_us = fence_us - rm * 1e3
                queue_us = launch_us - qm * 1e3
                args = {"seq": seq, "family": fam, "klass": kl,
                        "bytes": b}
                if qm > 0:
                    events.append({"name": f"{fam} (queued)", "ph": "X",
                                   "pid": 1, "tid": 1,
                                   "ts": round(queue_us, 1),
                                   "dur": round(qm * 1e3, 1),
                                   "cat": "queue", "args": args})
                events.append({"name": fam, "ph": "X", "pid": 1,
                               "tid": 2, "ts": round(launch_us, 1),
                               "dur": round(max(rm, 1e-3) * 1e3, 1),
                               "cat": "dispatch", "args": args})
        other = {"records": len(recs), "dispatches": self._c_disp.value,
                 "busy_ms_total": round(busy, 3),
                 "utilization": self._g_util.value}
        share = self.dispatch_in_flight_share()
        if share is not None:
            other["dispatch_in_flight_share"] = share
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": other}

    # -- roll-up -------------------------------------------------------------

    def summary(self) -> dict:
        """The /debug/metrics `devprof` section."""
        self._refresh_utilization()
        with self._lock:
            n_fams = len(self._fams)
            storms = sum(f["storms"] for f in self._fams.values())
            compile_ms = sum(f["compile_ms"] for f in self._fams.values())
            ring = len(self._ring)
        return {
            "enabled": True,
            "dispatches": self._c_disp.value,
            "ring_records": ring,
            "utilization_pct": self._g_util.value,
            "queue_gap_ms": self._m.histogram(
                "dgraph_device_queue_gap_ms").snapshot(),
            "dispatch_ms": self._m.histogram(
                "dgraph_device_dispatch_ms").snapshot(),
            "compiles": self._c_compiles.value,
            "compile_ms_total": round(compile_ms, 3),
            "program_families": n_fams,
            "retrace_storms": storms,
            "hbm": self.hbm_snapshot(),
        }
