"""Concurrent query-serving caches: plan cache, snapshot-keyed task-result
LRU with singleflight coalescing, and the bounded device-dispatch gate.

Copy of dgraph_tpu/query/qcache.py for the PyTorch port.

Reference semantics: the reference survives concurrent load through its
posting-list LRU (posting/lists.go:123, caching decoded lists across
queries) and per-goroutine task reuse; repeated traffic mostly re-reads
memory. This port re-parsed every DQL string and re-executed every
process_task per query. The three tiers here convert the single-query
kernel wins (PERF.md rounds 1-5) into QPS:

  * PlanCache — parsed ASTs keyed on (DQL text, variables signature). The
    parsed tree is read-only during execution (the executor only ever
    builds NEW GraphQuery nodes, engine._effective_children), so one parse
    serves every replay of a hot query shape.
  * TaskResultCache — TaskResult LRU at the Executor._dispatch seam keyed
    on (snapshot token, canonical TaskQuery key). Snapshots are immutable
    and replaced-never-mutated (SnapshotAssembler._assemble builds a fresh
    object on any visible change), so a per-object token IS the data
    version: commits, alters, and drops all surface as a new snapshot
    object -> new token -> stale entries can never be served. Uncommitted
    txn overlays get explicit ("txn", start_ts, version) tokens so the
    per-mutate version bump invalidates them. Eviction is byte-size-aware
    (LRU by result footprint) and participates in Node.enforce_memory.
  * Singleflight — concurrent identical in-flight tasks share ONE
    underlying dispatch: the first thread computes, the rest wait on the
    flight and receive the same result (groupcache's singleflight shape).
  * DispatchGate — a small semaphore bounding simultaneous device
    dispatches so N concurrent heavy queries pipeline through the chip
    instead of thrashing it.

Every tier exports hit/miss/inflight/evicted counters through the owning
Registry (utils/metrics.py); /debug/metrics surfaces them over HTTP.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from dgraph_tpu_torch.obs import costs, otrace
from dgraph_tpu_torch.query.task import TaskQuery, TaskResult
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils import faults, locks
from dgraph_tpu_torch.utils.deadline import DeadlineExceeded, ResourceExhausted

# ---------------------------------------------------------------------------
# snapshot tokens
# ---------------------------------------------------------------------------

_token_seq = itertools.count(1)
_token_lock = threading.Lock()


def snapshot_token(snap):
    """Stable per-snapshot-object cache version. Snapshot objects are
    immutable and replaced on any visible data change, so object identity
    is exactly the invalidation granularity the task cache needs. Overlay
    snapshots carry an explicit token set by the server (keyed on the txn's
    per-mutate version bump) — this helper never overwrites one."""
    tok = getattr(snap, "cache_token", None)
    if tok is None:
        with _token_lock:
            tok = getattr(snap, "cache_token", None)
            if tok is None:
                tok = next(_token_seq)
                snap.cache_token = tok
    return tok


def task_token(snap, q) -> object:
    """PER-PREDICATE cache version for one task: the token of the PredData
    OBJECT serving q.attr. The assembler reuses PredData identity for clean
    predicates and replaces it on any visible change (fold, delta-overlay
    stamp, txn overlay), so a commit to predicate P rotates ONLY P's task
    keys — every other predicate's cache heat survives the write. A task
    reads exactly its own predicate's PredData (process_task), which makes
    this sound."""
    attr = q.attr[1:] if q.attr.startswith("~") else q.attr
    pd = snap.preds.get(attr)
    if pd is None:
        # absent predicate: fall back to the snapshot object (predicate
        # creation replaces the snapshot, so stale "empty" results die)
        return ("miss", snapshot_token(snap), attr)
    return snapshot_token(pd)     # same counter machinery, per-object


def plan_attrs(req) -> list[str] | None:
    """Predicates a parsed request can read, statically derived from the
    plan; None = not derivable (explicit uids validate against the known-uid
    set of EVERY predicate; expand()/shortest read dynamically), in which
    case the caller must key on the whole snapshot."""
    out: set[str] = set()

    def add_attr(attr: str) -> None:
        if attr:
            out.add(attr[1:] if attr.startswith("~") else attr)

    def walk_filter(ft) -> bool:
        if ft is None:
            return True
        if ft.func is not None:
            add_attr(ft.func.attr)
            return True
        return all(walk_filter(c) for c in ft.children)

    def walk(gq) -> bool:
        if gq.uids or gq.shortest is not None or gq.expand:
            return False
        if gq.func is not None:
            add_attr(gq.func.attr)
        if not walk_filter(gq.filter):
            return False
        for o in gq.order:
            if not o.is_val:
                add_attr(o.attr)
        if gq.groupby is not None:
            for _alias, attr, _lang in gq.groupby.attrs:
                add_attr(attr)
        for c in gq.children:
            if c.is_uid_node or c.attr in ("val", "math") or \
                    c.attr.startswith("__agg_"):
                if not walk_filter(c.filter):
                    return False
                continue
            add_attr(c.attr)
            if not walk(c):
                return False
        return True

    for gq in req.queries:
        if not walk(gq):
            return None
    return sorted(out)


def subscription_attrs(req) -> frozenset | None:
    """The live-query touch test: the predicate set whose
    commits can change this request's result, or None when not statically
    derivable (the subscription then wakes on EVERY commit window —
    over-notification is correct, a stale feed is not). This is exactly
    plan_attrs — the same read-set derivation the per-predicate result-
    cache tokens key on — so cache invalidation and notification can
    never disagree about what a commit touched."""
    attrs = plan_attrs(req)
    return None if attrs is None else frozenset(attrs)


def result_token(req, snap) -> object:
    """Whole-query cache version: the per-predicate token tuple of the
    plan's read set when statically known, else the snapshot object token.
    A commit to predicate P then rotates only the keys of plans that read P
    — unrelated replays keep their result-cache heat across writes."""
    attrs = plan_attrs(req)
    if attrs is None:
        return ("snap", snapshot_token(snap))
    toks = []
    for attr in attrs:
        pd = snap.preds.get(attr)
        toks.append(("miss", attr) if pd is None else snapshot_token(pd))
    return tuple(toks)


# ---------------------------------------------------------------------------
# canonical task keys
# ---------------------------------------------------------------------------

def _freeze(x):
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return x


def task_key(q: TaskQuery):
    """Hashable canonical key for one task; None = uncacheable shape."""
    try:
        key = (q.attr,
               None if q.frontier is None
               else np.ascontiguousarray(
                   np.asarray(q.frontier, dtype=np.int64)).tobytes(),
               None if q.func is None else (q.func[0], _freeze(q.func[1])),
               q.reverse, q.lang, tuple(q.facet_keys), q.first)
        hash(key)
    except TypeError:
        return None          # exotic func arg (unhashable): skip the cache
    return key


def copy_result(res: TaskResult) -> TaskResult:
    """Fresh outer containers, shared immutable rows. Callers replace
    matrix rows and reassign attributes (checkpwd, facet filters, child
    pagination) but never mutate a row in place, so sharing the inner
    numpy arrays / Val rows is safe while the outer lists must be owned
    by the caller."""
    return TaskResult(
        uid_matrix=list(res.uid_matrix),
        value_matrix=[list(r) for r in res.value_matrix],
        facet_matrix=[list(r) for r in res.facet_matrix],
        counts=list(res.counts),
        dest_uids=res.dest_uids,
        traversed_edges=res.traversed_edges)


def _nbytes(x) -> int:
    """Bytes of one cached array: a tensor at numel * element_size, a numpy
    array at nbytes, anything else at 8 bytes per entry."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(getattr(x, "nbytes", 8 * len(x)))


def result_nbytes(res: TaskResult) -> int:
    """Byte-footprint estimate for size-aware eviction."""
    n = 256 + 8 * len(res.counts) + _nbytes(res.dest_uids)
    for r in res.uid_matrix:
        n += _nbytes(r) + 16
    for row in res.value_matrix:
        n += 72 * len(row) + 16
    for row in res.facet_matrix:
        n += 120 * len(row) + 16
    return n


# ---------------------------------------------------------------------------
# task-result LRU + singleflight
# ---------------------------------------------------------------------------

class _Flight:
    __slots__ = ("event", "result", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.result: TaskResult | None = None
        self.error: BaseException | None = None


class _ByteLRU:
    """Shared byte-budget LRU core: OrderedDict entries of
    key -> (value, nbytes), admit-if-under-capacity, tail eviction, and
    the evicted/bytes counters. Subclasses add their value-specific
    hit/copy semantics. Callers of _store_locked/_get_locked hold _lock."""

    def __init__(self, capacity_bytes: int, metrics, prefix: str) -> None:
        from dgraph_tpu_torch.utils.metrics import Registry

        self.capacity = int(capacity_bytes)
        self.metrics = metrics if metrics is not None else Registry()
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._bytes = 0
        m = self.metrics
        self._hits = m.counter(f"dgraph_{prefix}_cache_hits_total")
        self._misses = m.counter(f"dgraph_{prefix}_cache_misses_total")
        self._evicted = m.counter(f"dgraph_{prefix}_cache_evicted_total")
        self._gauge = m.counter(f"dgraph_{prefix}_cache_bytes")

    @property
    def bytes(self) -> int:
        return self._bytes

    def _get_locked(self, key):
        """LRU-touch + hit accounting; returns the raw value or None.
        Misses are counted by the caller (a coalesced follower is not a
        real miss — only the flight leader's compute is)."""
        ent = self._entries.get(key)
        if ent is None:
            return None
        self._entries.move_to_end(key)
        self._hits.inc()
        return ent[0]

    def _store_locked(self, key, value, nbytes: int) -> None:
        """Admit (values wider than the whole budget are never admitted —
        they'd evict everything for one entry), then evict the LRU tail."""
        if nbytes > self.capacity:
            return
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= old[1]
        self._entries[key] = (value, nbytes)
        self._bytes += nbytes
        while self._bytes > self.capacity and self._entries:
            _, (_v, onb) = self._entries.popitem(last=False)
            self._bytes -= onb
            self._evicted.inc()
        self._gauge.set(self._bytes)

    def evict_to(self, budget_bytes: int) -> int:
        """Shrink to at most budget_bytes (enforce_memory lever). Returns
        the number of entries evicted."""
        n = 0
        with self._lock:
            while self._bytes > max(0, int(budget_bytes)) and self._entries:
                _, (_v, onb) = self._entries.popitem(last=False)
                self._bytes -= onb
                n += 1
            if n:
                self._evicted.inc(n)
            self._gauge.set(self._bytes)
        return n

    def clear(self) -> int:
        return self.evict_to(0)

    def __len__(self) -> int:
        return len(self._entries)


class TaskResultCache(_ByteLRU):
    """Byte-budget LRU over TaskResults with in-flight coalescing."""

    def __init__(self, capacity_bytes: int = 64 << 20, metrics=None) -> None:
        super().__init__(capacity_bytes, metrics, "task")
        self._coalesced = self.metrics.counter(
            "dgraph_task_cache_inflight_waits_total")
        self._flights: dict[tuple, _Flight] = {}

    def dispatch(self, token, q: TaskQuery, compute) -> TaskResult:
        """Serve q from the cache, join an identical in-flight compute, or
        run compute once and publish the result to every waiter."""
        key = task_key(q)
        if key is None or self.capacity <= 0:
            return compute(q)
        fk = (token, key)
        while True:
            with self._lock:
                res = self._get_locked(fk)
                if res is not None:
                    otrace.event("task_cache", outcome="hit")
                    costs.note("task_cache_hit")
                    return copy_result(res)
                fl = self._flights.get(fk)
                if fl is None:
                    fl = self._flights[fk] = _Flight()
                    self._misses.inc()
                    otrace.event("task_cache", outcome="miss")
                    costs.note("task_cache_miss")
                    break                       # we are the flight leader
            # follower: wait for the leader's result outside the lock
            self._coalesced.inc()
            otrace.event("task_cache", outcome="coalesced")
            costs.note("task_cache_coalesced")
            # clamped to the follower's own budget: a budgeted request
            # must never hang behind a wedged flight leader (the leader
            # still publishes for any unbudgeted waiters)
            if not fl.event.wait(dl.clamp(None)):
                dl.check("task singleflight follower")
                raise DeadlineExceeded(
                    "task singleflight follower timed out")
            if fl.error is not None:
                raise fl.error
            if fl.result is not None:
                return copy_result(fl.result)
            # leader was cancelled without result/error (shouldn't happen);
            # loop and try again as a fresh flight
        try:
            res = compute(q)
        except BaseException as e:
            fl.error = e                        # identical queries fail alike
            with self._lock:
                self._flights.pop(fk, None)
            fl.event.set()
            raise
        fl.result = res
        with self._lock:
            self._flights.pop(fk, None)
            if isinstance(res.uid_matrix, list):  # lazy matrix: skip
                self._store_locked(fk, res, result_nbytes(res))
        fl.event.set()
        return copy_result(res)


# ---------------------------------------------------------------------------
# bounded device-dispatch gate
# ---------------------------------------------------------------------------

class DispatchGate:
    """Bounds simultaneous device dispatches. A query's host orchestration
    runs unbounded; only the device-step critical sections funnel through
    the gate, so N concurrent traversals pipeline (one on device, the rest
    preparing/encoding) instead of thrashing dispatch.

    Robustness layer: when the caller carries a deadline
    (utils/deadline contextvar), the gate becomes a deadline-aware bounded
    queue — acquisition waits at most the remaining budget (typed
    DeadlineExceeded instead of an unbounded semaphore block), and work is
    SHED up front (typed ResourceExhausted) when the remaining budget
    cannot cover the expected device step (EWMA of recent step wall times)
    or when the waiter queue is already `max_queue` deep. Unbudgeted
    callers keep the exact pre-existing blocking behavior — zero overhead
    on the warm path."""

    # EWMA smoothing for the expected-device-step estimate
    _EWMA_ALPHA = 0.2

    def __init__(self, width: int = 4, metrics=None,
                 max_queue: int | None = None) -> None:
        from dgraph_tpu_torch.utils.metrics import Registry

        self.width = max(1, int(width))
        self.max_queue = self.width * 16 if max_queue is None \
            else int(max_queue)
        self.metrics = metrics if metrics is not None else Registry()
        self._sem = threading.BoundedSemaphore(self.width)
        self._inflight = self.metrics.counter("dgraph_dispatch_inflight")
        self._waits = self.metrics.counter("dgraph_dispatch_waits_total")
        self._shed = self.metrics.counter("dgraph_shed_total")
        self._wlock = locks.Lock(
            "qcache.DispatchGate._wlock")  # guards the _waiting count
        self._waiting = 0                  # queued acquirers
        # device-runtime observatory (obs/devprof.py): the node
        # attaches its DevProfiler here — run() is the ONE chokepoint
        # every device dispatch (solo task, batch leader, analytics,
        # mesh program) passes, so the timeline sees each exactly once.
        # None (--no_devprof) costs a single attribute load per dispatch.
        self.profiler = None
        # weighted-fair tenant scheduling (tenancy/sched.py):
        # the node arms `fair` (a FairScheduler) + `tenant_fn` (the
        # tenancy contextvar reader) when QoS is on. Contended
        # acquisitions then admit lowest-virtual-time tenant first, and
        # every measured dispatch charges its wall-ms to the submitting
        # tenant's clock. None (--no_qos / no tenants) costs one
        # attribute load on the contended path only — the uncontended
        # fast acquire above it is untouched.
        self.fair = None
        self.tenant_fn = None
        self._step_ewma = 0.0              # expected device-step seconds
        # per-kernel-class EWMAs: one global estimate spans ~1ms
        # host-cutover expands and ~100ms mesh/vector steps, making shed
        # decisions wrong for both tails — callers that know their kernel
        # class (the same classification query/batch.py uses) pass it to
        # run() and shed checks consult the class estimate first
        self._class_ewma: dict[str, float] = {}

    @property
    def expected_step_s(self) -> float:
        return self._step_ewma

    def expected_step(self, klass: str | None = None) -> float:
        """Expected device-step seconds for one kernel class; the global
        EWMA is the fallback until the class has its own samples."""
        if klass is not None:
            v = self._class_ewma.get(klass)
            if v:
                return v
        return self._step_ewma

    def busy(self) -> bool:
        """True when any dispatch is running or queued — the batcher's
        fire-immediately-when-idle check."""
        return self._inflight.value > 0 or self._waiting > 0

    def _acquire(self, klass: str | None = None) -> None:
        """Budget-aware semaphore acquisition. Raises typed errors instead
        of waiting past the caller's deadline."""
        fair = self.fair
        if fair is not None and self.tenant_fn is not None:
            # tenant-fair admission SUBSUMES the non-blocking fast path:
            # a hot thread re-grabbing the slot it just released barges
            # past waiters parked inside the semaphore (they are invisible
            # to any queue), and under saturation that hands one tenant
            # the whole device. Armed gates therefore always contend in
            # virtual-time order (sched.py), with the cheap typed sheds
            # still applied up front for budgeted callers.
            rem = dl.remaining()
            if rem is not None:
                if rem <= 0:
                    raise DeadlineExceeded(
                        "dispatch gate: budget exhausted")
                est = self.expected_step(klass)
                if est and rem < est:
                    self._shed.inc()
                    otrace.event("shed", where="dispatch_gate",
                                 klass=klass or "",
                                 remaining_ms=round(rem * 1000, 1),
                                 expected_step_ms=round(est * 1000, 1))
                    costs.note("shed")
                    raise ResourceExhausted(
                        f"shed: remaining budget {rem * 1000:.0f}ms < "
                        f"expected {klass or 'device'} step "
                        f"{est * 1000:.0f}ms")
                if fair.depth() >= self.max_queue:
                    self._shed.inc()
                    otrace.event("shed", where="dispatch_gate",
                                 queue=fair.depth())
                    costs.note("shed")
                    raise ResourceExhausted(
                        f"shed: tenant fair queue full "
                        f"({self.max_queue} waiting)")
            t0 = time.perf_counter()
            # deadline-safe: acquire() parks in dl.clamp(0.05) slices and
            # raises a typed DeadlineExceeded once the budget expires, so
            # a budgeted request can never hang in the fair queue
            if fair.acquire(self.tenant_fn(), self._sem):
                self._waits.inc()
                costs.add_gate_wait((time.perf_counter() - t0) * 1e3)
            return
        if self._sem.acquire(blocking=False):
            return
        self._waits.inc()
        rem = dl.remaining()
        if rem is None:
            t0 = time.perf_counter()
            self._sem.acquire()
            costs.add_gate_wait((time.perf_counter() - t0) * 1e3)
            return
        # shed before queueing: a request whose remaining budget cannot
        # cover even one expected device step would only occupy a queue
        # slot and time out — reject it while it is still cheap. (The
        # dgraph_deadline_exceeded_total counter is owned by the REQUEST
        # entry points — counting here too would double-book overruns.)
        if rem <= 0:
            raise DeadlineExceeded("dispatch gate: budget exhausted")
        est = self.expected_step(klass)
        if est and rem < est:
            self._shed.inc()
            otrace.event("shed", where="dispatch_gate", klass=klass or "",
                         remaining_ms=round(rem * 1000, 1),
                         expected_step_ms=round(est * 1000, 1))
            costs.note("shed")
            raise ResourceExhausted(
                f"shed: remaining budget {rem * 1000:.0f}ms < expected "
                f"{klass or 'device'} step {est * 1000:.0f}ms")
        with self._wlock:
            if self._waiting >= self.max_queue:
                queued = self._waiting
            else:
                queued = None
                self._waiting += 1
        if queued is not None:
            self._shed.inc()
            otrace.event("shed", where="dispatch_gate", queue=queued)
            costs.note("shed")
            raise ResourceExhausted(
                f"shed: dispatch queue full ({queued} waiting)")
        t0 = time.perf_counter()
        try:
            ok = self._sem.acquire(timeout=rem)
        finally:
            with self._wlock:
                self._waiting -= 1
            costs.add_gate_wait((time.perf_counter() - t0) * 1e3)
        if not ok:
            otrace.event("deadline", where="dispatch_gate")
            raise DeadlineExceeded(
                f"dispatch gate: no slot within {rem * 1000:.0f}ms budget")

    def run(self, fn, klass: str | None = None):
        tf = time.perf_counter()
        prof = self.profiler
        blg = costs.current() if prof is not None else None
        b0 = (blg.h2d_bytes + blg.d2h_bytes) if blg is not None else 0
        faults.fire("device.dispatch", m=self.metrics)
        df = time.perf_counter() - tf
        if df > 1e-4:
            # an injected submission-latency fault IS device cost the
            # request paid: charge it to the ledger so /debug/top's
            # per-shape EWMA baseline flags the regressed shape even when
            # the query stays under --slow_query_ms. Skipped
            # inside an open kernel-timer window (recurse/mesh/shortest
            # sites bracket this call) — the timer already counts it.
            lg = costs.current()
            if lg is not None and not lg.in_kernel():
                lg.add_kernel("device.dispatch", df * 1e3)
        self._acquire(klass)
        self._inflight.inc()
        t0 = time.perf_counter()
        # device interval of this dispatch: CUDA events around fn on a
        # CUDA profiler, resolved when the timeline is read (never here)
        dev0 = prof.begin_device() if prof is not None else None
        try:
            # device.step fires while HOLDING the slot: a slow device
            # program (or the distributed configs' fixed relay sync),
            # serialized by the gate exactly like real device occupancy —
            # device.dispatch above models pre-gate submission latency
            faults.fire("device.step", m=self.metrics)
            ds = time.perf_counter() - t0
            if ds > 1e-4:
                lg = costs.current()
                if lg is not None and not lg.in_kernel():
                    lg.add_kernel("device.step", ds * 1e3)
            return fn()
        finally:
            dt = time.perf_counter() - t0
            dev = prof.end_device(dev0) if prof is not None else None
            self._step_ewma = dt if not self._step_ewma else (
                (1 - self._EWMA_ALPHA) * self._step_ewma
                + self._EWMA_ALPHA * dt)
            if klass is not None:
                cur = self._class_ewma.get(klass, 0.0)
                self._class_ewma[klass] = dt if not cur else (
                    (1 - self._EWMA_ALPHA) * cur + self._EWMA_ALPHA * dt)
            self._inflight.dec()
            self._sem.release()
            fair = self.fair
            if fair is not None and self.tenant_fn is not None:
                # the measured dispatch is the deficit signal: charge its
                # wall-ms / weight to the submitting tenant's clock
                fair.charge(self.tenant_fn(), dt * 1e3)
            if prof is not None:
                # timeline record: queue-entry (run() start) -> launch
                # (slot acquired) -> fence (fn returned/raised). Bytes
                # moved = the ledger's transfer delta across the window
                # (0 when the kernel timer books after the gate exits —
                # the batch runners book inside, so batched dispatches
                # carry theirs).
                b1 = (blg.h2d_bytes + blg.d2h_bytes) \
                    if blg is not None else 0
                prof.record_dispatch(klass, tf, t0, t0 + dt,
                                     bytes_moved=max(b1 - b0, 0),
                                     device=dev)


# ---------------------------------------------------------------------------
# parsed-plan cache
# ---------------------------------------------------------------------------

def plan_key(q: str, variables: dict | None, ns: str = ""):
    """(DQL text, variables signature[, namespace]) — None when the
    variables are not canonicalizable (never the case for the JSON-shaped
    GraphQL vars the HTTP surface accepts).

    ns is the caller's tenant namespace: two tenants issuing
    byte-identical DQL over same-named predicates read DIFFERENT storage
    tablets, so every cache keyed on this — plan tier, physical-plan
    tier, whole-query result tier — must separate them. The default
    namespace keeps the exact pre-tenancy 2-tuple, so single-tenant
    deployments key (and hit) byte-identically."""
    if not variables:
        return (q, None) if not ns else (q, None, ns)
    try:
        sig = tuple(sorted(
            (str(k), json.dumps(v, sort_keys=True, default=str))
            for k, v in variables.items()))
    except Exception:
        return None
    return (q, sig) if not ns else (q, sig, ns)


class ResultCache(_ByteLRU):
    """Whole-query result cache: the plan tier's natural extension. Keyed
    on (plan key, snapshot token, edge budget) — the same invalidation
    rules as the task tier (any commit/alter/drop/overlay-version bump
    rotates the snapshot token), but it also absorbs the host-side work
    the task tier can't: result encoding, groupby assembly, device SSSP.
    Values are stored as JSON text (query outputs are JSON-shaped by
    construction — the HTTP surface dumps them verbatim), so hits hand
    every caller an independent deep copy via one C-speed json.loads and
    byte-identical output is guaranteed by design."""

    def __init__(self, capacity_bytes: int = 32 << 20, metrics=None) -> None:
        super().__init__(capacity_bytes, metrics, "result")

    def get(self, key) -> dict | None:
        with self._lock:
            text = self._get_locked(key)
            if text is None:
                self._misses.inc()
                return None
        return json.loads(text)

    def put(self, key, out: dict) -> None:
        try:
            text = json.dumps(out)
        except (TypeError, ValueError):
            return                       # non-JSON output shape: skip
        with self._lock:
            self._store_locked(key, text, len(text) + 128)


class PlanCache:
    """Entry-count LRU over parsed DQL requests. Parsed trees are
    read-only during execution, so one AST serves every replay.

    A second tier caches the OPTIMIZED physical plan alongside the AST
    (query/planner.py): keyed on (plan key, the per-predicate token tuple
    of the request's read set), so a commit to predicate P — which may
    change P's cardinality stats — invalidates only plans that read P,
    exactly the task/result-tier invalidation rule."""

    def __init__(self, size: int = 256, metrics=None) -> None:
        from dgraph_tpu_torch.utils.metrics import Registry

        self.size = int(size)
        self.metrics = metrics if metrics is not None else Registry()
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, object] = OrderedDict()
        self._hits = self.metrics.counter("dgraph_plan_cache_hits_total")
        self._misses = self.metrics.counter("dgraph_plan_cache_misses_total")
        self._plans: OrderedDict[tuple, object] = OrderedDict()
        self._plan_hits = self.metrics.counter(
            "dgraph_planner_cache_hits_total")
        self._plan_misses = self.metrics.counter(
            "dgraph_planner_cache_misses_total")

    def parse(self, q: str, variables: dict | None = None, ns: str = ""):
        # ns separates tenants' ASTs too: the trees are name-identical
        # across tenants today, but plans key on AST node object ids —
        # sharing one AST would let tenant B's plan hit tenant A's tier
        from dgraph_tpu_torch.query import dql

        key = plan_key(q, variables, ns)
        if key is None or self.size <= 0:
            return dql.parse(q, variables)
        with self._lock:
            req = self._entries.get(key)
            if req is not None:
                self._entries.move_to_end(key)
                self._hits.inc()
                return req
        req = dql.parse(q, variables)
        with self._lock:
            self._misses.inc()
            self._entries[key] = req
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)
        return req

    def plan(self, q: str, variables: dict | None, req, snap, build,
             ns: str = ""):
        """Optimized-plan tier: serve the cached physical plan for this
        (query shape, stats version), else build one. Plans key on AST
        node object ids, so a hit must also match the cached AST object
        (`plan.req is req`) — an AST-tier eviction re-parse mints new
        node ids and the stale plan is rebuilt."""
        key = plan_key(q, variables, ns)
        if key is None or self.size <= 0:
            return build()
        pk = (key, result_token(req, snap))
        with self._lock:
            p = self._plans.get(pk)
            if p is not None and p.req is req:
                self._plans.move_to_end(pk)
                self._plan_hits.inc()
                return p
        p = build()
        with self._lock:
            self._plan_misses.inc()
            self._plans[pk] = p
            while len(self._plans) > self.size:
                self._plans.popitem(last=False)
        return p

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._plans.clear()

    def __len__(self) -> int:
        return len(self._entries)
