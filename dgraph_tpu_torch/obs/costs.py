"""Per-request resource cost ledger + the /debug/top sliding-window profiler.

Copy of dgraph_tpu/obs/costs.py for the PyTorch port. One difference: the
port compiles nothing per request (its torch ops run eagerly and its
kernels build once per process), so `compile_ms` books the kernel library
builds a request triggers (obs/devprof.note_compile), where the JAX ledger
books XLA compiles from a jax.monitoring listener.

The observability gap: device time, transfer bytes, and
traversed edges existed only as GLOBAL counters (utils/metrics.py) and
per-span annotations (obs/otrace.py, sampled). Neither answers "what did
THIS query cost" or "which plan shape is burning the device" — the
questions the SF100 scale gate and multi-tenant QoS both need.

Model (Dapper-style, like otrace): a request entry point (Node.query,
ClusterClient.query, worker serve_task) mints a CostLedger and installs
it on a contextvar; every execution seam below — Executor._traced_dispatch
(per-task attribution), the device-kernel sites in query/task.py,
DeviceBatcher (batched kernel cost apportioned to members by slot size),
MeshExecutor fused programs, ResidencyManager uploads, DispatchGate waits
and sheds — charges the current ledger. Workers ship their ledger BACK to
the querying node in gRPC trailing metadata (WIRE_KEY, next to the span
payload), so the root assembles ONE cluster-wide cost record with
per-group sub-records; there is no out-of-band collector.

The unarmed fast path is one contextvar read returning None: a node
started with --no_cost_ledger books no ledger. The armed ledger runs in
every request `graphbench` drives, so its cost shows in the benchmark's
end-to-end metrics.

`kernel()` is the one device seam: it opens the `device_kernel` span
(obs/otrace.py, layer `device`) around the ledger's timer, and its bytes
feed the ledger, the sampled span's attrs and the tracer's
dgraph_transfer_{h2d,d2h}_bytes_total counters alike.

Completed records land in a CostBook: a bounded sliding window that
powers GET /debug/top (rank plan shapes / predicates / endpoints by
device ms, bytes, edges over the trailing window) and keeps a per-shape
EWMA baseline of device cost — a record whose device_ms exceeds
k x baseline is flagged as a cost regression into the slow-query ring
even when the query finishes under --slow_query_ms.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import threading
import time
from collections import deque

from . import devprof, otrace

# gRPC trailing-metadata key for the shipped record (-bin carries bytes)
WIRE_KEY = "dgt-cost-bin"

_current: contextvars.ContextVar["CostLedger | None"] = \
    contextvars.ContextVar("dgt_cost_ledger", default=None)


def current() -> "CostLedger | None":
    """The active ledger on this execution context, or None (unarmed)."""
    return _current.get()


class scope:
    """Install a ledger (or None) for the dynamic extent of a request.
    Re-entrant and thread-correct: the contextvar token restores whatever
    the enclosing frame had, so a batch leader can suppress gate-level
    attribution with scope(None) while apportioning manually."""

    __slots__ = ("_lg", "_token")

    def __init__(self, lg: "CostLedger | None") -> None:
        self._lg = lg

    def __enter__(self):
        self._token = _current.set(self._lg)
        return self._lg

    def __exit__(self, *a):
        _current.reset(self._token)
        return False


class _TaskScope:
    """Attributes nested kernel charges to one predicate (a stack: the
    fused ANN pipeline dispatches a filter task inside a root task)."""

    __slots__ = ("_lg", "_attr")

    def __init__(self, lg: "CostLedger", attr: str) -> None:
        self._lg = lg
        self._attr = attr

    def __enter__(self):
        self._lg._push_attr(self._attr)
        return self

    def __exit__(self, *a):
        self._lg._pop_attr()
        return False


class CostLedger:
    """One request's resource cost accumulator.

    All mutators take the ledger's own lock: hedged RPCs and batch
    leaders charge a ledger from threads other than the request's own
    (contextvars are copied into the hedge pool; batch runners hold
    explicit references captured at submit time)."""

    __slots__ = ("_lock", "endpoint", "shape", "tenant", "t0", "wall_ms",
                 "device_ms", "h2d_bytes", "d2h_bytes", "upload_bytes",
                 "edges", "rows", "tasks", "gate_wait_ms", "compile_ms",
                 "subs", "outcomes", "per_pred", "kernels", "groups",
                 "_attrs", "_kernel_depth")

    def __init__(self, endpoint: str = "", shape: str = "",
                 tenant: str = "") -> None:
        self._lock = threading.Lock()
        self.endpoint = endpoint
        self.shape = shape
        self.tenant = tenant          # requesting namespace ("" = default)
        self.t0 = time.perf_counter()
        self.wall_ms = 0.0
        self.device_ms = 0.0          # device-kernel wall ms (fenced sites)
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.upload_bytes = 0         # residency warm->HBM uploads at serve
        self.edges = 0                # traversed edges
        self.rows = 0                 # value/index rows scanned host-side
        self.tasks = 0                # dispatched tasks
        self.gate_wait_ms = 0.0       # dispatch-gate queueing
        self.compile_ms = 0.0         # kernel builds this request triggered
        self.subs: tuple = ()         # subscription ids (endpoint="live")
        self.outcomes: dict[str, int] = {}
        # attr -> [device_ms, edges, bytes, tasks]
        self.per_pred: dict[str, list] = {}
        self.kernels: dict[str, float] = {}   # kernel name -> device ms
        # worker addr -> merged remote record dict (the shipped payload)
        self.groups: dict[str, dict] = {}
        self._attrs: list[str] = []
        self._kernel_depth = 0       # open _KernelTimer windows

    # ---------------------------------------------------------------- scopes

    def task(self, attr: str) -> _TaskScope:
        return _TaskScope(self, attr)

    def _push_attr(self, attr: str) -> None:
        with self._lock:
            self._attrs.append(attr)

    def _pop_attr(self) -> None:
        with self._lock:
            if self._attrs:
                self._attrs.pop()

    def _pred_locked(self, attr: str) -> list:
        row = self.per_pred.get(attr)
        if row is None:
            row = self.per_pred[attr] = [0.0, 0, 0, 0]
        return row

    # -------------------------------------------------------------- charging

    def add_kernel(self, kernel: str, ms: float, h2d: int = 0,
                   d2h: int = 0, attr: str | None = None) -> None:
        """One device-kernel execution: fenced wall ms + transfer bytes,
        attributed to the current task's predicate (or `attr`)."""
        with self._lock:
            self.device_ms += ms
            self.h2d_bytes += int(h2d)
            self.d2h_bytes += int(d2h)
            self.kernels[kernel] = self.kernels.get(kernel, 0.0) + ms
            a = attr if attr is not None else \
                (self._attrs[-1] if self._attrs else "")
            if a.startswith("~"):
                a = a[1:]            # reverse reads charge the tablet
            if a:
                row = self._pred_locked(a)
                row[0] += ms
                row[2] += int(h2d) + int(d2h)

    def add_task(self, attr: str, edges: int) -> None:
        """One dispatched task completed (cache tiers + gate inside)."""
        with self._lock:
            self.tasks += 1
            self.edges += int(edges)
            row = self._pred_locked(attr)
            row[1] += int(edges)
            row[3] += 1

    def add_rows(self, n: int) -> None:
        with self._lock:
            self.rows += int(n)

    def attribute_pred_ms(self, attr: str, ms: float) -> None:
        """Re-attribute already-counted device ms to a predicate row
        WITHOUT touching the totals — for fused multi-predicate programs
        (mesh.plan) whose one launch is apportioned across hops after
        the per-hop edge counts are known."""
        if attr.startswith("~"):
            attr = attr[1:]
        if not attr or ms <= 0:
            return
        with self._lock:
            self._pred_locked(attr)[0] += ms

    def add_gate_wait(self, ms: float) -> None:
        with self._lock:
            self.gate_wait_ms += ms

    def add_compile(self, ms: float) -> None:
        """Kernel-build wall ms this request triggered (devprof.note_compile
        books it) — kept SEPARATE from device_ms
        so a first-touch compile doesn't poison the shape's EWMA
        regression baseline, while /debug/top?by=compile_ms still ranks
        the shapes paying for retraces."""
        with self._lock:
            self.compile_ms += ms

    def in_kernel(self) -> bool:
        """True while a kernel-timing window is open on this ledger — the
        dispatch gate consults it so injected device-latency faults are
        not charged a second time inside an enclosing kernel timer."""
        return self._kernel_depth > 0

    @contextlib.contextmanager
    def kernel_window(self):
        """Open a bare kernel-timing window (no charge of its own): the
        batcher's _timed_gate_run uses it so the gate's injected-fault
        charges are suppressed while the batched dt — which already
        contains them and is apportioned to every member — is measured."""
        with self._lock:
            self._kernel_depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._kernel_depth -= 1

    def add_upload(self, nbytes: int) -> None:
        with self._lock:
            self.upload_bytes += int(nbytes)
            self.h2d_bytes += int(nbytes)

    def note(self, outcome: str, n: int = 1) -> None:
        """Count one cache/batch/shed/retry outcome."""
        with self._lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + n

    # ---------------------------------------------------- remote assembly

    def merge_remote(self, addr: str, rec: dict) -> None:
        """Graft a callee's shipped record under this ledger (one entry
        per worker address; repeated RPCs to the same worker sum)."""
        if not rec:
            return
        with self._lock:
            g = self.groups.get(addr)
            if g is None:
                self.groups[addr] = dict(rec)
                # per-addr sub-dicts must be owned, not aliased
                for k in ("out", "pred", "kern"):
                    if k in rec:
                        self.groups[addr][k] = {
                            a: (list(v) if isinstance(v, list) else v)
                            for a, v in rec[k].items()}
                return
            for k in ("device_ms", "wall_ms", "gate_wait_ms",
                      "compile_ms"):
                g[k] = g.get(k, 0.0) + rec.get(k, 0.0)
            for k in ("h2d", "d2h", "upload", "edges", "rows", "tasks"):
                g[k] = g.get(k, 0) + rec.get(k, 0)
            for o, n in rec.get("out", {}).items():
                g.setdefault("out", {})
                g["out"][o] = g["out"].get(o, 0) + n
            for a, row in rec.get("pred", {}).items():
                g.setdefault("pred", {})
                cur = g["pred"].get(a)
                if cur is None:
                    g["pred"][a] = list(row)
                else:
                    for i in range(4):
                        cur[i] += row[i]
            for kn, ms in rec.get("kern", {}).items():
                g.setdefault("kern", {})
                g["kern"][kn] = g["kern"].get(kn, 0.0) + ms

    # ------------------------------------------------------------- totals

    def finish(self) -> None:
        self.wall_ms = (time.perf_counter() - self.t0) * 1e3

    def _local_locked(self) -> dict:
        return {"wall_ms": round(self.wall_ms, 3),
                "device_ms": round(self.device_ms, 3),
                "gate_wait_ms": round(self.gate_wait_ms, 3),
                "compile_ms": round(self.compile_ms, 3),
                "h2d": self.h2d_bytes, "d2h": self.d2h_bytes,
                "upload": self.upload_bytes,
                "edges": self.edges, "rows": self.rows,
                "tasks": self.tasks,
                "out": dict(self.outcomes),
                "pred": {a: [round(r[0], 3), r[1], r[2], r[3]]
                         for a, r in self.per_pred.items()},
                "kern": {k: round(v, 3) for k, v in self.kernels.items()}}

    def to_wire(self) -> bytes:
        """Compact shipped payload (a worker's local record only — the
        caller grafts it under its own groups map)."""
        with self._lock:
            return json.dumps(self._local_locked(),
                              separators=(",", ":")).encode()

    @staticmethod
    def from_wire(raw: bytes) -> dict:
        try:
            out = json.loads(raw.decode())
            return out if isinstance(out, dict) else {}
        except (ValueError, UnicodeDecodeError):
            return {}

    def to_dict(self) -> dict:
        """The assembled cluster-wide record: this node's local charges
        plus every shipped per-group record, with rolled-up totals.

        Physical costs (device ms, bytes, gate waits) SUM across local +
        groups — nobody else paid them. Logical counts (edges, tasks)
        take max(local, sum of groups): the querying node already
        attributes every dispatched task — including remote ones, whose
        traversed_edges ride the TaskResponse — so adding the workers'
        counts on top would double-book the same edges."""
        with self._lock:
            local = self._local_locked()
            groups = {a: dict(g) for a, g in self.groups.items()}
        total = dict(local)
        pred = {a: list(r) for a, r in local["pred"].items()}
        out = dict(local["out"])
        kern = dict(local["kern"])
        gsum = {k: 0 for k in ("edges", "tasks")}
        gpred: dict[str, list] = {}
        for g in groups.values():
            total["device_ms"] = round(
                total["device_ms"] + g.get("device_ms", 0.0), 3)
            total["gate_wait_ms"] = round(
                total["gate_wait_ms"] + g.get("gate_wait_ms", 0.0), 3)
            total["compile_ms"] = round(
                total["compile_ms"] + g.get("compile_ms", 0.0), 3)
            for k in ("h2d", "d2h", "upload", "rows"):
                total[k] += g.get(k, 0)
            for k in gsum:
                gsum[k] += g.get(k, 0)
            for o, n in g.get("out", {}).items():
                out[o] = out.get(o, 0) + n
            for a, row in g.get("pred", {}).items():
                cur = gpred.get(a)
                if cur is None:
                    gpred[a] = list(row)
                else:
                    for i in range(4):
                        cur[i] += row[i]
            for kn, ms in g.get("kern", {}).items():
                kern[kn] = round(kern.get(kn, 0.0) + ms, 3)
        for k in gsum:
            total[k] = max(total[k], gsum[k])
        for a, row in gpred.items():
            cur = pred.get(a)
            if cur is None:
                pred[a] = list(row)
            else:
                cur[0] += row[0]                 # device ms: physical
                cur[2] += row[2]                 # bytes: physical
                cur[1] = max(cur[1], row[1])     # edges: logical
                cur[3] = max(cur[3], row[3])     # tasks: logical
        total["pred"] = {a: [round(r[0], 3), r[1], r[2], r[3]]
                         for a, r in pred.items()}
        total["out"] = out
        total["kern"] = kern
        out2 = {"endpoint": self.endpoint, "shape": self.shape,
                "total": total, "local": local, "groups": groups}
        if self.tenant:
            out2["tenant"] = self.tenant
        if self.subs:
            out2["subs"] = list(self.subs)
        return out2


class _KernelTimer:
    """`with costs.kernel("csr.expand", need=n) as ck:` — the one device
    seam. It opens the `device_kernel` span (extra keywords become a
    sampled span's attrs, beside kernel=<name>) and times the enclosed
    device execution against the current ledger. Bytes attach via
    ck.set(h2d=, d2h=): the ledger, the span's transfer_* attrs and the
    tracer's byte counters all take them; ck.annotate(**kw) adds attrs to
    a sampled span. With no ledger armed the timer charges nothing; with
    charge=False it never charges the ledger (the batcher apportions one
    launch to its members itself). Exceptions still charge the elapsed
    time (a faulted upload consumed the wall clock it consumed).

    Several sites wrap a GATED call (the timer must bracket the lazy
    device value's host materialization, which happens after the gate
    releases), so dispatch-gate QUEUE time can fall inside the window.
    That wait is already booked as gate_wait_ms — counting it as device
    ms too would make every shape on a contended node look regressed —
    so the timer subtracts whatever gate wait the same ledger accrued
    during its window (same-thread nesting makes the delta exact;
    clamped at zero against concurrent hedge-thread waits)."""

    __slots__ = ("_lg", "_kernel", "_attr", "_t0", "_gw0", "h2d", "d2h",
                 "ms", "_pushed", "_sp")

    def __init__(self, kernel: str, attr: str | None, charge: bool,
                 attrs: dict) -> None:
        self._lg = _current.get() if charge else None
        self._kernel = kernel
        self._attr = attr
        self.h2d = 0
        self.d2h = 0
        self.ms = 0.0          # charged wall ms, readable after exit
        self._pushed = False
        self._sp = otrace.span(KERNEL_SPAN, kernel=kernel, **attrs)

    def __enter__(self):
        self._sp.__enter__()
        lg = self._lg
        if lg is not None:
            with lg._lock:
                lg._kernel_depth += 1
                self._gw0 = lg.gate_wait_ms
            # devprof armed: the kernel name IS the program family — the
            # thread-local stack lets the dispatch timeline and the build
            # observatory attribute their records to "pb.recurse_fused" /
            # "csr.expand" instead of the coarse gate class. One empty-
            # tuple truthiness check when the observatory is off.
            if devprof._PROFILERS:
                devprof.push_family(self._kernel)
                self._pushed = True
            self._t0 = time.perf_counter()
        return self

    def set(self, h2d: int = 0, d2h: int = 0) -> None:
        h2d, d2h = int(h2d), int(d2h)
        self.h2d += h2d
        self.d2h += d2h
        self._sp.transfer(h2d, d2h)

    @property
    def sampled(self) -> bool:
        """True when the span keeps attrs (a sampled request)."""
        return bool(self._sp)

    def annotate(self, **kw) -> None:
        if self._sp:
            self._sp.set(**kw)

    def __exit__(self, et, ev, tb):
        lg = self._lg
        if lg is not None:
            dt = (time.perf_counter() - self._t0) * 1e3
            if self._pushed:
                devprof.pop_family()
            with lg._lock:
                lg._kernel_depth -= 1
                waited = lg.gate_wait_ms - self._gw0
            self.ms = max(dt - waited, 0.0)
            lg.add_kernel(self._kernel, self.ms,
                          h2d=self.h2d, d2h=self.d2h, attr=self._attr)
        self._sp.__exit__(et, ev, tb)
        return False


# the span every device seam opens (obs/otrace.SPAN_LAYERS: "device")
KERNEL_SPAN = "device_kernel"


def kernel(name: str, attr: str | None = None, charge: bool = True,
           **attrs) -> _KernelTimer:
    return _KernelTimer(name, attr, charge, attrs)


def transfer(h2d: int = 0, d2h: int = 0) -> None:
    """Bytes a copy moved inside an enclosing kernel() seam that the copy's
    own code cannot reach (parallel/mesh_exec.py's programs): the current
    ledger's totals and the current span's counters."""
    lg = _current.get()
    if lg is not None:
        with lg._lock:
            lg.h2d_bytes += int(h2d)
            lg.d2h_bytes += int(d2h)
    otrace.transfer(int(h2d), int(d2h))


def note(outcome: str, n: int = 1) -> None:
    """Charge one outcome to the current ledger, if armed (the helper for
    modules that shouldn't know about ledgers: qcache, retry, gate)."""
    lg = _current.get()
    if lg is not None:
        lg.note(outcome, n)


def add_rows(n: int) -> None:
    lg = _current.get()
    if lg is not None:
        lg.add_rows(n)


def add_upload(nbytes: int) -> None:
    lg = _current.get()
    if lg is not None:
        lg.add_upload(nbytes)
    otrace.transfer(h2d=int(nbytes))


def add_gate_wait(ms: float) -> None:
    lg = _current.get()
    if lg is not None:
        lg.add_gate_wait(ms)


# ---------------------------------------------------------------------------
# the /debug/top sliding-window profiler
# ---------------------------------------------------------------------------

class CostBook:
    """Bounded window of completed cost records + per-shape EWMA
    baselines.

    record() returns a regression flag dict when the record's device_ms
    exceeds `regression_factor` x the shape's warmed baseline — the
    caller (Node.query) routes it into the slow-query ring, which is how
    a shape that regressed from 2ms to 40ms surfaces even under a 500ms
    --slow_query_ms threshold. Baselines need `MIN_SAMPLES` observations
    before they flag (a cold shape's first compile is not a regression).
    """

    MIN_SAMPLES = 8
    EWMA_ALPHA = 0.2
    # baseline floor (ms): a pure-host shape's baseline is ~0, and 4 x ~0
    # would flag the first microsecond of device work — regressions are
    # only meaningful above this much device time
    BASELINE_FLOOR_MS = 0.05

    def __init__(self, keep: int = 4096,
                 regression_factor: float = 4.0) -> None:
        from collections import OrderedDict

        self._lock = threading.Lock()
        self._ring: deque[tuple[float, str, str, str, dict]] = \
            deque(maxlen=keep)
        # shape -> [ewma_device_ms, samples]; LRU-bounded — shapes are
        # raw DQL text, and clients that inline literals instead of
        # variables mint a new shape per request, so an unbounded map
        # would grow RSS forever on a long-running node
        self._baseline: "OrderedDict[str, list]" = OrderedDict()
        self._baseline_cap = max(int(keep), 16)
        self.regression_factor = float(regression_factor)
        self.flagged = 0

    def record(self, shape: str, endpoint: str, trace_id: str,
               rec: dict) -> dict | None:
        """Admit one assembled record (rec = CostLedger.to_dict()).
        Returns the regression-flag entry or None."""
        total = rec.get("total", {})
        dms = float(total.get("device_ms", 0.0))
        now = time.monotonic()
        flag = None
        with self._lock:
            self._ring.append((now, shape, endpoint, trace_id, rec))
            b = self._baseline.get(shape)
            if b is None:
                self._baseline[shape] = [dms, 1]
                while len(self._baseline) > self._baseline_cap:
                    self._baseline.popitem(last=False)
            else:
                self._baseline.move_to_end(shape)
                if b[1] >= self.MIN_SAMPLES and \
                        dms > self.regression_factor * \
                        max(b[0], self.BASELINE_FLOOR_MS):
                    self.flagged += 1
                    flag = {"reason": "cost_regression",
                            "shape": shape[:200],
                            "endpoint": endpoint,
                            "trace_id": trace_id,
                            "device_ms": round(dms, 3),
                            "baseline_ms": round(b[0], 3),
                            "factor": round(dms / max(b[0], 1e-3), 1),
                            "edges": total.get("edges", 0),
                            "bytes": total.get("h2d", 0)
                            + total.get("d2h", 0)}
                # the EWMA keeps learning (a real shift becomes the new
                # baseline instead of flagging forever)
                b[0] = (1 - self.EWMA_ALPHA) * b[0] \
                    + self.EWMA_ALPHA * dms
                b[1] += 1
        return flag

    def baseline(self, shape: str) -> tuple[float, int]:
        with self._lock:
            b = self._baseline.get(shape)
            return (b[0], b[1]) if b is not None else (0.0, 0)

    def last(self) -> dict | None:
        """The newest assembled record, per-group sub-records included."""
        with self._lock:
            if not self._ring:
                return None
            _ts, shape, ep, tid, rec = self._ring[-1]
            return {"shape": shape, "endpoint": ep, "trace_id": tid,
                    **rec}

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def top(self, window_s: float = 60.0, by: str = "device_ms",
            group: str = "shape", n: int = 20,
            endpoint: str | None = None) -> dict:
        """Rank shapes/predicates/endpoints by summed cost over the
        trailing window. The /debug/top payload. `endpoint` restricts the
        window to records from that endpoint first (?endpoint=live ranks
        standing-subscription re-evals by shape, next to — but separable
        from — foreground query load)."""
        cutoff = time.monotonic() - max(window_s, 0.0)
        agg: dict[str, dict] = {}
        seen = 0
        with self._lock:
            entries = [e for e in self._ring
                       if e[0] >= cutoff
                       and (endpoint is None or e[2] == endpoint)]
            baselines = {s: (b[0], b[1])
                         for s, b in self._baseline.items()}
        for _ts, shape, ep, tid, rec in entries:
            total = rec.get("total", {})
            seen += 1
            if group == "sub":
                # per-subscription attribution: a live re-eval record
                # carries the
                # ids of every subscription its coalesced group served —
                # the shared eval's cost apportions equally among them,
                # so 10k standing copies of one feed don't multiply the
                # booked device time
                sids = rec.get("subs") or ()
                if not sids:
                    continue
                share = 1.0 / len(sids)
                for sid in sids:
                    a = agg.setdefault(sid, {
                        "device_ms": 0.0, "wall_ms": 0.0,
                        "compile_ms": 0.0, "edges": 0.0, "bytes": 0.0,
                        "records": 0, "shape": ""})
                    a["device_ms"] = round(
                        a["device_ms"]
                        + float(total.get("device_ms", 0.0)) * share, 3)
                    a["wall_ms"] = round(
                        a["wall_ms"]
                        + float(total.get("wall_ms", 0.0)) * share, 3)
                    a["compile_ms"] = round(
                        a["compile_ms"]
                        + float(total.get("compile_ms", 0.0)) * share, 3)
                    a["edges"] = round(
                        a["edges"]
                        + int(total.get("edges", 0)) * share, 1)
                    a["bytes"] = round(
                        a["bytes"] + (int(total.get("h2d", 0))
                                      + int(total.get("d2h", 0)))
                        * share, 1)
                    a["records"] += 1
                    a["shape"] = shape[:200]
                continue
            if group == "pred":
                for attr, row in total.get("pred", {}).items():
                    a = agg.setdefault(attr, {
                        "device_ms": 0.0, "edges": 0, "bytes": 0,
                        "tasks": 0, "records": 0})
                    a["device_ms"] = round(a["device_ms"] + row[0], 3)
                    a["edges"] += row[1]
                    a["bytes"] += row[2]
                    a["tasks"] += row[3]
                    a["records"] += 1
                continue
            if group == "tenant":
                # /debug/top?group=tenant — per-namespace attribution:
                # every record is stamped with its minting
                # tenant; unstamped records are the default namespace
                gkey = rec.get("tenant") or "default"
            else:
                gkey = ep if group == "endpoint" else shape
            a = agg.setdefault(gkey, {
                "device_ms": 0.0, "wall_ms": 0.0, "compile_ms": 0.0,
                "edges": 0, "bytes": 0, "records": 0, "trace_id": ""})
            a["device_ms"] = round(
                a["device_ms"] + float(total.get("device_ms", 0.0)), 3)
            a["wall_ms"] = round(
                a["wall_ms"] + float(total.get("wall_ms", 0.0)), 3)
            a["compile_ms"] = round(
                a["compile_ms"] + float(total.get("compile_ms", 0.0)), 3)
            a["edges"] += int(total.get("edges", 0))
            a["bytes"] += int(total.get("h2d", 0)) + \
                int(total.get("d2h", 0))
            a["records"] += 1
            if tid:
                a["trace_id"] = tid      # newest sampled exemplar wins
        rank_key = {"device_ms": "device_ms", "edges": "edges",
                    "bytes": "bytes", "wall_ms": "wall_ms",
                    "compile_ms": "compile_ms"}.get(by, "device_ms")
        if group == "pred" and rank_key in ("wall_ms", "compile_ms"):
            rank_key = "device_ms"     # pred rows carry neither
        ranked = sorted(agg.items(), key=lambda kv: kv[1].get(rank_key, 0),
                        reverse=True)[: max(n, 1)]
        out = []
        for k, v in ranked:
            row = {"key": k[:200], **v}
            if group == "shape":
                bl = baselines.get(k)
                if bl is not None:
                    row["baseline_device_ms"] = round(bl[0], 3)
                    row["baseline_samples"] = bl[1]
                    mean = v["device_ms"] / max(v["records"], 1)
                    row["regressed"] = bool(
                        bl[1] >= self.MIN_SAMPLES
                        and mean > self.regression_factor
                        * max(bl[0], self.BASELINE_FLOOR_MS))
            out.append(row)
        return {"window_s": window_s, "by": by, "group": group,
                "endpoint": endpoint,
                "records_in_window": seen, "flagged_total": self.flagged,
                "top": out}
