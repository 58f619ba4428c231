"""Span-based distributed tracing + device profiling (Dapper-style).

Copy of dgraph_tpu/obs/otrace.py for the PyTorch port.

Model: a sampled request mints a trace_id at its root span; every unit of
work below it is a span carrying (span_id, parent_id). Within a process
the active span rides a contextvar, so instrumentation points
(`otrace.span(...)`) need no plumbing; across processes the context rides
gRPC invocation metadata (`WIRE_KEY`, "trace_id:parent_span_id") and the
callee ships its collected spans BACK in trailing metadata (`SPANS_KEY`),
so the caller assembles one tree server-side — there is no out-of-band
collector to deploy.

The not-sampled fast path is one contextvar read returning NULL_SPAN
(falsy, no-op everywhere): tracing at 0% must cost nothing measurable
(bench.py `trace` gates <2% QPS overhead at 1% sampling).

Completed traces land in a bounded TraceSink ring and export as Chrome
trace-event JSON (loadable in Perfetto / chrome://tracing) at
/debug/traces/<id>.
"""

from __future__ import annotations

import contextvars
import json
import random
import threading
import time
from collections import deque

# gRPC metadata keys (lowercase per the gRPC spec; -bin carries bytes)
WIRE_KEY = "dgt-trace"
SPANS_KEY = "dgt-spans-bin"

# a join()ed trace whose spans are never take()n (caller died mid-RPC)
# must not pin the buffer map forever
_MAX_ACTIVE = 256

_current: contextvars.ContextVar["Span | None"] = \
    contextvars.ContextVar("dgt_current_span", default=None)


class _NullSpan:
    """Unsampled requests get this: falsy, allocation-free no-ops."""

    __slots__ = ()
    trace_id = ""
    span_id = ""

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set(self, **kw) -> None:
        pass

    def event(self, name: str, **attrs) -> None:
        pass

    def finish(self, error: str = "") -> None:
        pass


NULL_SPAN = _NullSpan()


def current() -> "Span | None":
    """The innermost active span on this execution context, or None."""
    return _current.get()


def span(name: str, **attrs):
    """Child span of the current one; NULL_SPAN when nothing is sampled.
    The instrumentation-point helper: modules that shouldn't know about
    tracers (query/task.py device dispatch) call this unconditionally."""
    parent = _current.get()
    if parent is None:
        return NULL_SPAN
    return parent.tracer.start(name, parent=parent, attrs=attrs)


def event(name: str, **attrs) -> None:
    """Zero-duration annotation on the current span (breadcrumb analog)."""
    sp = _current.get()
    if sp is not None:
        sp.event(name, **attrs)


def wire_context() -> str | None:
    """Serialized context for an outgoing RPC, or None when unsampled."""
    sp = _current.get()
    if sp is None:
        return None
    return f"{sp.trace_id}:{sp.span_id}"


class Span:
    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "kind", "proc", "wall0", "t0", "dur", "attrs", "events_",
                 "error", "_token", "_finished")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: str, name: str, kind: str, proc: str,
                 attrs: dict) -> None:
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.proc = proc
        self.wall0 = time.time()
        self.t0 = time.perf_counter()
        self.dur = 0.0
        self.attrs = attrs
        self.events_: list[tuple[float, str, dict]] = []
        self.error = ""
        self._token = None
        self._finished = False

    def __bool__(self) -> bool:
        return True

    def set(self, **kw) -> None:
        self.attrs.update(kw)

    def event(self, name: str, **attrs) -> None:
        self.events_.append((time.perf_counter() - self.t0, name, attrs))

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, et, ev, tb):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self.finish(error="" if ev is None else f"{type(ev).__name__}: {ev}")
        return False

    def finish(self, error: str = "") -> None:
        if self._finished:
            return
        self._finished = True
        self.dur = time.perf_counter() - self.t0
        if error:
            self.error = error
        self.tracer._record(self)

    def to_dict(self) -> dict:
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "name": self.name,
             "kind": self.kind, "proc": self.proc,
             "start": self.wall0, "dur": round(self.dur, 9),
             "attrs": self.attrs}
        if self.error:
            d["error"] = self.error
        if self.events_:
            d["events"] = [{"t": round(t, 9), "name": n, "attrs": a}
                           for t, n, a in self.events_]
        return d


class TraceSink:
    """Completed traces, newest-first bounded ring, addressable by id."""

    def __init__(self, keep: int = 64) -> None:
        self._lock = threading.Lock()
        self._order: deque[str] = deque()
        self._by_id: dict[str, dict] = {}
        self.keep = keep

    def add(self, root: dict, spans: list[dict]) -> None:
        rec = {"trace_id": root["trace_id"], "root": root["name"],
               "proc": root["proc"], "start": root["start"],
               "elapsed_s": root["dur"], "error": root.get("error", ""),
               "nspans": len(spans), "spans": spans}
        with self._lock:
            if rec["trace_id"] in self._by_id:
                self._order.remove(rec["trace_id"])
            self._by_id[rec["trace_id"]] = rec
            self._order.appendleft(rec["trace_id"])
            while len(self._order) > self.keep:
                self._by_id.pop(self._order.pop(), None)

    def index(self, n: int = 32) -> list[dict]:
        with self._lock:
            ids = list(self._order)[:n]
            return [{k: v for k, v in self._by_id[t].items()
                     if k != "spans"} for t in ids]

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            return self._by_id.get(trace_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)


class Tracer:
    """Per-process span factory + per-trace assembly buffer.

    Sampling happens ONCE, at root(): a joined trace (propagated over the
    wire) is always recorded because the root already paid the coin flip.
    The rng is injectable so tests sample deterministically."""

    def __init__(self, fraction: float = 0.0, proc: str = "node",
                 keep: int = 64, rng=None, slowlog=None) -> None:
        self.fraction = fraction
        self.proc = proc
        self.rng = rng if rng is not None else random
        self.sink = TraceSink(keep)
        self.slowlog = slowlog
        self._lock = threading.Lock()
        self._active: dict[str, list[dict]] = {}
        self._joined: set[str] = set()

    def _new_id(self) -> str:
        return f"{self.rng.getrandbits(64):016x}"

    # -- span creation -------------------------------------------------------

    def root(self, name: str, kind: str = "server",
             attrs: dict | None = None, force: bool = False) -> "Span":
        """Start a NEW trace; the sampling decision lives here."""
        if not force and (self.fraction <= 0
                          or self.rng.random() >= self.fraction):
            return NULL_SPAN
        tid = self._new_id()
        with self._lock:
            self._evict_locked()
            self._active[tid] = []
        return Span(self, tid, self._new_id(), "", name, kind, self.proc,
                    dict(attrs) if attrs else {})

    def start(self, name: str, parent: "Span | None" = None,
              kind: str = "internal", attrs: dict | None = None) -> "Span":
        parent = parent if parent is not None else _current.get()
        if parent is None or not parent:
            return NULL_SPAN
        return Span(self, parent.trace_id, self._new_id(), parent.span_id,
                    name, kind, self.proc, dict(attrs) if attrs else {})

    def join(self, wire: str, name: str, kind: str = "server",
             attrs: dict | None = None) -> "Span":
        """Continue a trace whose context arrived over the wire. The
        returned span's subtree is buffered locally; the RPC handler ships
        it back to the caller with take() after the span finishes."""
        tid, _, parent_id = wire.partition(":")
        if not tid:
            return NULL_SPAN
        with self._lock:
            self._evict_locked()
            self._active.setdefault(tid, [])
            self._joined.add(tid)
        return Span(self, tid, self._new_id(), parent_id, name, kind,
                    self.proc, dict(attrs) if attrs else {})

    def _evict_locked(self) -> None:
        while len(self._active) >= _MAX_ACTIVE:
            stale = next(iter(self._active))
            self._active.pop(stale, None)
            self._joined.discard(stale)

    # -- assembly ------------------------------------------------------------

    def take(self, trace_id: str) -> list[dict]:
        """Drain a joined trace's buffered spans (RPC handler exit)."""
        with self._lock:
            self._joined.discard(trace_id)
            return self._active.pop(trace_id, [])

    def add_remote(self, spans: list[dict]) -> None:
        """Merge spans shipped back by a callee into their live trace
        (silently dropped when the trace already assembled — a hedged
        RPC's straggler response must not resurrect a finished trace)."""
        if not spans:
            return
        tid = spans[0].get("trace_id", "")
        with self._lock:
            buf = self._active.get(tid)
            if buf is not None:
                buf.extend(spans)

    def _record(self, sp: Span) -> None:
        d = sp.to_dict()
        done = None
        with self._lock:
            buf = self._active.get(sp.trace_id)
            if buf is None:
                return                     # trace already assembled/evicted
            buf.append(d)
            if not sp.parent_id and sp.trace_id not in self._joined:
                # local root finished: assemble NOW, even if remote spans
                # never arrived (failed fan-out must not leak the buffer)
                done = self._active.pop(sp.trace_id)
        if done is not None:
            self.sink.add(d, done)
            if self.slowlog is not None:
                self.slowlog.observe(d, done)

    def active_traces(self) -> int:
        with self._lock:
            return len(self._active)


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

def chrome_trace(rec: dict) -> dict:
    """One assembled trace -> the Chrome trace-event JSON object format:
    complete ("X") events per span, instant ("i") events per span event,
    one tid per process label with thread_name metadata. Timestamps are
    rebased to the trace start, in microseconds (the format's unit)."""
    spans = rec.get("spans", [])
    t0 = min((s["start"] for s in spans), default=0.0)
    tids: dict[str, int] = {}
    events: list[dict] = []
    for s in spans:
        tids.setdefault(s.get("proc") or "?", len(tids) + 1)
    for proc, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": proc}})
    for s in spans:
        tid = tids[s.get("proc") or "?"]
        args = {"span_id": s["span_id"], "parent_id": s["parent_id"]}
        args.update(s.get("attrs", {}))
        if s.get("error"):
            args["error"] = s["error"]
        ts = (s["start"] - t0) * 1e6
        events.append({"name": s["name"], "cat": s.get("kind", "internal"),
                       "ph": "X", "ts": round(ts, 3),
                       "dur": round(max(s["dur"] * 1e6, 0.001), 3),
                       "pid": 1, "tid": tid, "args": args})
        for ev in s.get("events", ()):
            events.append({"name": ev["name"], "ph": "i", "s": "t",
                           "ts": round(ts + ev["t"] * 1e6, 3),
                           "pid": 1, "tid": tid, "args": ev.get("attrs", {})})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": rec.get("trace_id", ""),
                          "root": rec.get("root", ""),
                          "error": rec.get("error", "")}}


def span_tree(rec: dict) -> dict:
    """Nested parent->child view of one assembled trace (the slow-query
    log's payload; also a structural sanity check for tests)."""
    spans = rec.get("spans", [])
    by_parent: dict[str, list[dict]] = {}
    by_id = {s["span_id"]: s for s in spans}
    roots = []
    for s in spans:
        if s["parent_id"] and s["parent_id"] in by_id:
            by_parent.setdefault(s["parent_id"], []).append(s)
        else:
            roots.append(s)

    def node(s: dict) -> dict:
        kids = sorted(by_parent.get(s["span_id"], ()),
                      key=lambda x: x["start"])
        out = {"name": s["name"], "proc": s["proc"], "kind": s["kind"],
               "dur_ms": round(s["dur"] * 1e3, 3), "attrs": s.get("attrs", {})}
        if s.get("error"):
            out["error"] = s["error"]
        if kids:
            out["children"] = [node(k) for k in kids]
        return out

    roots.sort(key=lambda s: s["start"])
    return {"trace_id": rec.get("trace_id", ""),
            "tree": [node(s) for s in roots]}


# wire payload ceiling for shipped span lists: stays comfortably under the
# raised grpc.max_metadata_size (4 MB) even after base64-ish inflation
_MAX_SHIP_BYTES = 1 << 20


def encode_spans(spans: list[dict]) -> bytes:
    out = json.dumps(spans, separators=(",", ":"), default=str).encode()
    while len(out) > _MAX_SHIP_BYTES and len(spans) > 1:
        # pathological trace: keep the longest spans (the ones that answer
        # "where did the time go") and note the truncation on the last
        spans = sorted(spans, key=lambda s: s.get("dur", 0.0),
                       reverse=True)[: max(len(spans) // 2, 1)]
        spans[-1] = dict(spans[-1])
        spans[-1].setdefault("attrs", {})
        spans[-1]["attrs"] = dict(spans[-1]["attrs"], truncated=True)
        out = json.dumps(spans, separators=(",", ":"), default=str).encode()
    return out


def decode_spans(raw: bytes) -> list[dict]:
    try:
        out = json.loads(raw.decode())
        return out if isinstance(out, list) else []
    except (ValueError, UnicodeDecodeError):
        return []
