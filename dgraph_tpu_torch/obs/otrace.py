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

Every request records its layer-boundary spans; sampling decides only
what is kept. An unsampled request gets a LeanSpan at its root and below:
falsy like NULL_SPAN (so `if sp:` attribute work is skipped), with no ids,
attrs or events, never on the wire. On exit a span of either kind books
its self time (its duration less what its child spans on the same thread
cover) to its layer's counter, `dgraph_span_self_ns_<layer>_total` in the
tracer's registry (through its request's root, which adds them up and
books them when it closes), and appends (layer, name, thread id, t_start,
t_end) to the process-wide span ring, stamped on `time.perf_counter()`:
the clock a device trace is mapped onto, so a reader puts each
device-idle interval down to the span open on the host (`span_log`).
SPAN_LAYERS is the one table from span name to layer. Outside any request
(no root on the context) a span is NULL_SPAN and records nothing.

A lean span costs a few microseconds of host time, enter and exit (PERF.md
§6 has the measured figure); `graphbench`'s untraced runs carry it, so its
cost shows in the benchmark's end-to-end metrics.

Completed sampled traces land in a bounded TraceSink ring and export as
Chrome trace-event JSON (loadable in Perfetto / chrome://tracing) at
/debug/traces/<id>.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import random
import threading
import time
from collections import deque

from dgraph_tpu_torch.utils.metrics import Counter

# gRPC metadata keys (lowercase per the gRPC spec; -bin carries bytes)
WIRE_KEY = "dgt-trace"
SPANS_KEY = "dgt-spans-bin"

# a join()ed trace whose spans are never take()n (caller died mid-RPC)
# must not pin the buffer map forever
_MAX_ACTIVE = 256

_current: contextvars.ContextVar["Span | LeanSpan | None"] = \
    contextvars.ContextVar("dgt_current_span", default=None)

# The layer of each span name (PERF.md §3 names the layers and their
# modules). A name not listed whole takes the layer of its prefix up to and
# including ":" ("task:<attr>", "zero:<rpc>"); wire, cluster and write
# spans whose module §3 gives no layer are node's, and so is a name in
# neither form.
LAYERS = ("node", "engine", "traversal", "device")
SPAN_LAYERS = {
    # node: the serving Node's request entries and its steps before the
    # executor, and the calls it makes over the wire
    "query": "node", "mutate": "node", "commit": "node", "upsert": "node",
    "alter": "node", "analytics": "node", "parse": "node",
    "result_cache": "node", "plan": "node", "prefetch": "node",
    "serve_task": "node", "zero:": "node", "rpc:": "node", "store:": "node",
    # engine: the executor, its tasks and its host work on their results,
    # a level's @groupby (its member expand and var binding included) and
    # a root's ordering
    "execute": "engine", "block": "engine", "task:": "engine",
    "merge": "engine", "encode": "engine", "groupby": "engine",
    "order": "engine",
    # traversal: @recurse and shortest-path; inside @recurse the fused
    # path's device levels and the var binding, inside the shortest
    # kernel tier its device BFS loop and its host predecessor walk
    "recurse": "traversal", "shortest": "traversal",
    "recurse_levels": "traversal", "recurse_bind": "traversal",
    "shortest_bfs": "traversal", "shortest_walk": "traversal",
    # device: the host waiting on the card (launches, syncs, copies), the
    # span obs/costs.kernel opens at every device site
    "device_kernel": "device",
}


def layer_of(name: str) -> str:
    lay = SPAN_LAYERS.get(name)
    if lay is None:
        head, sep, _ = name.partition(":")
        lay = SPAN_LAYERS.get(head + sep, "node") if sep else "node"
    return lay


class _SpanRing:
    """Bounded, process-wide: the newest `size` closed spans as (layer,
    name, thread id, t_start, t_end), perf_counter seconds. Lock-free: the
    slot index comes from one itertools.count step."""

    def __init__(self, size: int) -> None:
        self.size = size
        self._slots: list = [None] * size
        self._seq = itertools.count()

    def add(self, entry: tuple) -> bool:
        """Store one entry; True when it overwrote an older one."""
        i = next(self._seq)
        self._slots[i % self.size] = entry
        return i >= self.size

    def entries(self) -> list[tuple]:
        return [e for e in list(self._slots) if e is not None]


RING_SIZE = 1 << 16
_RING = _SpanRing(RING_SIZE)


def span_log(t_from: float, t_to: float) -> list[tuple]:
    """The ring's spans that overlap [t_from, t_to] (perf_counter seconds),
    by start: (layer, name, thread id, t_start, t_end). Spans the ring
    overwrote are gone; `dgraph_span_ring_dropped_total` counts them."""
    return sorted((e for e in _RING.entries()
                   if e[4] >= t_from and e[3] <= t_to),
                  key=lambda e: e[3])


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

    def transfer(self, h2d: int = 0, d2h: int = 0) -> None:
        pass


NULL_SPAN = _NullSpan()


def current() -> "Span | LeanSpan | None":
    """The innermost active span on this execution context, or None
    outside a request. Falsy (a LeanSpan) when the request is not
    sampled."""
    return _current.get()


def span(name: str, **attrs):
    """Child span of the current one: a Span in a sampled request, a
    LeanSpan in an unsampled one, NULL_SPAN outside a request. The
    instrumentation-point helper: modules that shouldn't know about tracers
    (query/task.py) call this unconditionally."""
    parent = _current.get()
    if parent is None:
        return NULL_SPAN
    if parent.__class__ is LeanSpan:
        return LeanSpan(parent.tracer, parent, name)
    return parent.tracer.start(name, parent=parent, attrs=attrs)


def event(name: str, **attrs) -> None:
    """Zero-duration annotation on the current sampled span (breadcrumb
    analog)."""
    sp = _current.get()
    if sp:
        sp.event(name, **attrs)


def transfer(h2d: int = 0, d2h: int = 0) -> None:
    """Book host-to-device / device-to-host bytes on the current span's
    tracer counters (and, sampled, on the span's attrs)."""
    sp = _current.get()
    if sp is not None:
        sp.transfer(h2d, d2h)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the registry the current request's
    tracer serves (a Node's); nothing outside a request, or where the
    tracer serves no registry."""
    sp = _current.get()
    if sp is not None:
        sp.tracer.count(name, n)


def wire_context() -> str | None:
    """Serialized context for an outgoing RPC, or None when unsampled."""
    sp = _current.get()
    if not sp:
        return None
    return f"{sp.trace_id}:{sp.span_id}"


class _Timed:
    """What both span kinds keep to book their self time: the parent span
    object (None at a root or under a remote parent), the local root, the
    layer, the thread, and the time child spans on that thread covered.

    Self time gathers per layer on the local root (`acc`) and reaches the
    counters when the root closes, one increment a layer a request; a span
    on another thread than its root's books its own at once."""

    __slots__ = ("tracer", "parent", "root", "name", "layer", "tid", "t0",
                 "child", "acc", "_token", "_finished")

    def _init(self, tracer: "Tracer", parent, name: str) -> None:
        self.tracer = tracer
        self.parent = parent
        self.name = name
        self.layer = layer_of(name)
        self.tid = threading.get_ident()
        self.child = 0.0
        self._token = None
        self._finished = False
        if parent is None:
            self.root = self
            self.acc = dict.fromkeys(LAYERS, 0.0)
        else:
            self.root = parent.root
        self.t0 = time.perf_counter()

    def __enter__(self):
        self._token = _current.set(self)
        return self

    def _close(self) -> float:
        """Book the span; returns its duration."""
        t1 = time.perf_counter()
        dur = t1 - self.t0
        tid = self.tid
        p = self.parent
        if p is not None and p.tid == tid:
            p.child += dur
        self_s = dur - self.child
        root = self.root
        if root is self:
            self.acc[self.layer] += self_s
            self.tracer._book_self(self.acc)
        elif root.tid == tid and not root._finished:
            root.acc[self.layer] += self_s
        else:
            self.tracer._book_self({self.layer: self_s})
        if _RING.add((self.layer, self.name, tid, self.t0, t1)):
            self.tracer._dropped.inc()
        return dur

    def transfer(self, h2d: int = 0, d2h: int = 0) -> None:
        self.tracer._transfer(h2d, d2h)


class LeanSpan(_Timed):
    """An unsampled request's span: falsy, no ids, attrs or events; it books
    its self time and its ring entry on exit, and nothing else."""

    __slots__ = ()
    trace_id = ""
    span_id = ""

    def __init__(self, tracer: "Tracer", parent: "LeanSpan | None",
                 name: str) -> None:
        self._init(tracer, parent, name)

    def __bool__(self) -> bool:
        return False

    def set(self, **kw) -> None:
        pass

    def event(self, name: str, **attrs) -> None:
        pass

    def __exit__(self, et, ev, tb):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self.finish()
        return False

    def finish(self, error: str = "") -> None:
        if not self._finished:
            self._finished = True
            self._close()


class Span(_Timed):
    __slots__ = ("trace_id", "span_id", "parent_id", "kind", "proc",
                 "wall0", "dur", "attrs", "events_", "error")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: str, name: str, kind: str, proc: str,
                 attrs: dict, parent: "Span | None" = None) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.kind = kind
        self.proc = proc
        self.wall0 = time.time()
        self.dur = 0.0
        self.attrs = attrs
        self.events_: list[tuple[float, str, dict]] = []
        self.error = ""
        self._init(tracer, parent, name)

    def __bool__(self) -> bool:
        return True

    def set(self, **kw) -> None:
        self.attrs.update(kw)

    def event(self, name: str, **attrs) -> None:
        self.events_.append((time.perf_counter() - self.t0, name, attrs))

    def transfer(self, h2d: int = 0, d2h: int = 0) -> None:
        self.tracer._transfer(h2d, d2h)
        a = self.attrs
        if h2d:
            a["transfer_h2d_bytes"] = a.get("transfer_h2d_bytes", 0) + h2d
        if d2h:
            a["transfer_d2h_bytes"] = a.get("transfer_d2h_bytes", 0) + d2h

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
        self.dur = self._close()
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
                 keep: int = 64, rng=None, slowlog=None,
                 metrics=None) -> None:
        self.fraction = fraction
        self.proc = proc
        self.rng = rng if rng is not None else random
        self.sink = TraceSink(keep)
        self.slowlog = slowlog
        self._lock = threading.Lock()
        self._active: dict[str, list[dict]] = {}
        self._joined: set[str] = set()
        # what every span of this tracer books: the registry's counters
        # (utils/metrics.Registry pre-registers them), or counters of its
        # own for a tracer that serves no registry
        self._metrics = metrics
        if metrics is not None:
            c = metrics.counter
            self._self_ns = {
                "node": c("dgraph_span_self_ns_node_total"),
                "engine": c("dgraph_span_self_ns_engine_total"),
                "traversal": c("dgraph_span_self_ns_traversal_total"),
                "device": c("dgraph_span_self_ns_device_total")}
            self._h2d = c("dgraph_transfer_h2d_bytes_total")
            self._d2h = c("dgraph_transfer_d2h_bytes_total")
            self._dropped = c("dgraph_span_ring_dropped_total")
        else:
            self._self_ns = {lay: Counter() for lay in LAYERS}
            self._h2d, self._d2h, self._dropped = \
                Counter(), Counter(), Counter()

    def _book_self(self, by_layer: dict) -> None:
        for lay, s in by_layer.items():
            if s:
                self._self_ns[lay].inc(round(s * 1e9))

    def count(self, name: str, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.counter(name).inc(n)

    def _transfer(self, h2d: int, d2h: int) -> None:
        if h2d:
            self._h2d.inc(int(h2d))
        if d2h:
            self._d2h.inc(int(d2h))

    def _new_id(self) -> str:
        return f"{self.rng.getrandbits(64):016x}"

    # -- span creation -------------------------------------------------------

    def root(self, name: str, kind: str = "server",
             attrs: dict | None = None, force: bool = False) -> "Span":
        """Start a NEW trace; the sampling decision lives here. Unsampled,
        the root is a LeanSpan."""
        if not force and (self.fraction <= 0
                          or self.rng.random() >= self.fraction):
            return LeanSpan(self, None, name)
        tid = self._new_id()
        with self._lock:
            self._evict_locked()
            self._active[tid] = []
        return Span(self, tid, self._new_id(), "", name, kind, self.proc,
                    dict(attrs) if attrs else {})

    def start(self, name: str, parent: "Span | LeanSpan | None" = None,
              kind: str = "internal", attrs: dict | None = None):
        parent = parent if parent is not None else _current.get()
        if parent is None or parent is NULL_SPAN:
            return NULL_SPAN
        if not parent:
            return LeanSpan(self, parent, name)
        return Span(self, parent.trace_id, self._new_id(), parent.span_id,
                    name, kind, self.proc, dict(attrs) if attrs else {},
                    parent=parent)

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
