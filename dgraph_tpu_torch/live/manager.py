"""Live queries: standing subscriptions with O(Δ) re-evaluation.

Copy of dgraph_tpu/live/manager.py for the PyTorch port. The Node hands
over its device batcher: the notifier hints a burst before re-evaluating a
coalesced commit window, so compatible re-evaluations pack into one
batched run; a re-evaluation that reaches K1/K2 launches them from a pool
thread (or the batch leader's), on the default stream.

The reference streams its commit log to consumers; here the analogous seam
is the per-predicate delta journal + the commit window. A subscription is
a registered DQL read evaluated ONCE at registration, then re-derived only
when a commit window actually touches its read set:

  * the touch test IS qcache.plan_attrs — the same static read-set
    derivation the per-predicate result-cache tokens key on. A commit
    batch carrying predicates P wakes only subscriptions whose attr set
    intersects P; plans whose read set is not statically derivable
    (explicit uids, expand(), shortest) wake on every window, exactly as
    they key on the whole snapshot in the result cache.
  * wakes are COALESCED per commit window: the notifier drains every
    pending commit event in one sweep, dedupes woken subscriptions by
    (query, variables) so 10k standing copies of one feed cost ONE
    re-execution, and evaluates the distinct shapes concurrently so the
    DeviceBatcher packs their device steps like foreground reads.
  * freshness is exact, never best-effort: every notification carries the
    commit watermark `at` it reflects, and its `result` is byte-identical
    (diff.canon) to re-running the query read-only at that watermark —
    the tested correctness gate.
  * clients receive JSON diffs (added/removed/changed per block) against
    the last delivered result, with a typed full-result `resync` event
    whenever the diff chain cannot be trusted end-to-end: delta-journal
    overflow on a subscribed predicate, slow-consumer shedding, reconnect
    with a stale cursor, or a re-evaluation error after retry.

Flow control: per-subscription bounded queues. A full queue sheds by
REPLACING the queued backlog with one resync event (bounded memory, and
the client converges from any gap); a queue that stays blocked past the
idle timeout expires the subscription so a vanished consumer cannot pin
its cursor — and therefore the journal retention floor — forever.

The manager is engine-agnostic: Node and the embedded multi-group Cluster
both drive it through three callables (eval at a watermark, current
watermark, parse) plus their store list for journal pinning.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

from ..utils import locks
from ..utils.deadline import ResourceExhausted
from ..utils.errors import FailedPrecondition
from .diff import canon, result_diff

_BACKOFF_MIN_S = 0.05
_BACKOFF_MAX_S = 1.0


def _loads_memo(c: str, memo: dict | None):
    """json.loads with a per-window cache: one parse per distinct canon
    string no matter how many subscribers share it (str hashes are cached
    by the interpreter, so repeat lookups are cheap)."""
    if memo is None:
        return json.loads(c)
    obj = memo.get(c)
    if obj is None:
        obj = memo[c] = json.loads(c)
    return obj


class Subscription:
    """One standing query: registration state + the client event queue.

    Iterate it (`for ev in sub:`) or poll `next(timeout)`; events are
    dicts with a `type` of init / ack / diff / resync / expire. `cancel()`
    tears it down from the client side."""

    def __init__(self, mgr: "LiveManager", sid: str, q: str,
                 variables: dict | None, attrs: frozenset | None,
                 queue_max: int, tenant: str = "") -> None:
        self.id = sid
        self.q = q
        self.variables = dict(variables) if variables else None
        self.attrs = attrs               # None = wake on every window
        self.tenant = tenant             # registering namespace
        self.queue_max = max(int(queue_max), 1)
        self.queue: deque = deque()
        self._mgr = mgr
        self.cv = threading.Condition(mgr._lock)
        self.last_canon: str | None = None
        self.cursor = 0                  # watermark of the last delivery
        self.ready = False               # initial evaluation done
        self.pending_wake = False
        self.needs_resync: str | None = None
        self.closed = False
        self.blocked_since: float | None = None   # queue-full monotonic
        self.waiting = 0                 # threads blocked in next()
        self.delivered = 0
        self.sheds = 0
        self.resyncs = 0

    # -- client surface ------------------------------------------------------

    def next(self, timeout: float | None = None) -> dict | None:
        """Block for the next event; None on timeout (the SSE heartbeat
        pacing); StopIteration once cancelled/expired and drained."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        with self.cv:
            while not self.queue:
                if self.closed:
                    raise StopIteration
                rem = None if deadline is None \
                    else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return None
                self.waiting += 1
                try:
                    self.cv.wait(rem)
                finally:
                    self.waiting -= 1
            ev = self.queue.popleft()
            self.blocked_since = None
            self.delivered += 1
            return ev

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        ev = self.next(None)
        if ev is None:                   # unreachable without timeout
            raise StopIteration
        return ev

    def cancel(self) -> bool:
        return self._mgr.cancel(self.id)

    def snapshot(self) -> dict:
        out = {"id": self.id, "attrs": sorted(self.attrs)
               if self.attrs is not None else None,
               "cursor": self.cursor, "queued": len(self.queue),
               "delivered": self.delivered, "sheds": self.sheds,
               "resyncs": self.resyncs, "closed": self.closed}
        if self.tenant:
            out["tenant"] = self.tenant
        return out


class LiveManager:
    """Registry + notifier for standing subscriptions.

    eval_fn(q, variables, at_ts) -> result dict at exactly `at_ts`
    watermark_fn() -> the newest committed watermark
    parse_fn(q, variables) -> dql.ParsedRequest (for the touch test)
    stores -> journal pinning + cursor provability (delta_since)
    """

    def __init__(self, *, eval_fn, watermark_fn, parse_fn, stores,
                 metrics=None, queue_max: int = 256,
                 idle_timeout_s: float = 300.0, heartbeat_s: float = 15.0,
                 batcher=None, eval_workers: int = 4) -> None:
        self._eval = eval_fn
        # per-subscription cost attribution: an eval_fn that
        # accepts a 4th `subs` argument (Node's does) gets the ids of
        # every subscription the evaluation serves, so the cost ledger
        # can rank standing load in /debug/top?group=sub. Detected once
        # here — 3-arg engines (older embedders) keep working unchanged.
        import inspect

        try:
            params = inspect.signature(eval_fn).parameters
            self._eval_takes_subs = len(params) >= 4 or \
                "subs" in params
        except (TypeError, ValueError):
            self._eval_takes_subs = False
        self._watermark = watermark_fn
        self._parse = parse_fn
        self._stores = list(stores)
        self._m = metrics
        self.queue_max = int(queue_max)
        self.idle_timeout_s = float(idle_timeout_s)
        self.heartbeat_s = float(heartbeat_s)
        self._batcher = batcher
        # multi-tenant QoS: Node injects its TenantRegistry so
        # subscribe() can enforce per-tenant standing-subscription caps
        # (typed ResourceExhausted at the edge) and clamp notify-queue
        # bounds. None (the default, and --no_qos) = uncapped.
        self.registry = None
        self._eval_workers = max(int(eval_workers), 1)
        self._lock = locks.Lock("live.LiveManager._lock")
        self._cv = threading.Condition(self._lock)
        self._subs: dict[str, Subscription] = {}
        self._by_attr: dict[str, set[str]] = {}
        self._wildcard: set[str] = set()
        self._dirty: set[str] = set()
        # commit events: (commit_ts, preds tuple, arrival perf_counter).
        # Guarded by _lock; the overflow feed is a lock-free deque because
        # the store calls it from INSIDE its commit critical section — an
        # edge store._lock -> live lock there would cycle against the
        # notifier's eval path (live -> snapshot -> store._lock).
        self._events: deque = deque()
        self._overflow: deque = deque()
        self._seq = 1
        self._thread: threading.Thread | None = None
        self._stop = False
        self._closed = False
        self._pool = None
        self._backoff = 0.0
        self._retry_at = 0.0
        self._last_pin: int | None = None
        self._pin_raise_at = 0.0         # next amortised min-scan allowed
        self.windows = 0                 # processed commit windows
        self.registered = 0
        # the fan-out hot path runs once per subscriber per window: cache
        # the two metric objects instead of a registry name-lookup each
        self._c_notifs = None if metrics is None else \
            metrics.counter("dgraph_subs_notifications_total")
        self._h_latency = None if metrics is None else \
            metrics.histogram("dgraph_subs_notify_latency_s")

    def _eval_at(self, q, variables, ts, subs: tuple = ()):
        if self._eval_takes_subs:
            return self._eval(q, variables, ts, subs)
        return self._eval(q, variables, ts)

    # -- metrics plumbing ----------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        if self._m is not None:
            self._m.counter(name).inc(n)

    def _gauge(self, name: str, v: int) -> None:
        if self._m is not None:
            self._m.counter(name).set(v)

    # -- registration --------------------------------------------------------

    def subscription_attrs(self, q: str,
                           variables: dict | None = None) -> frozenset | None:
        """The touch-test read set for one query text (None = wake on
        every window). Exposed for tests and the wire surfaces."""
        from ..query import qcache

        return qcache.subscription_attrs(self._parse(q, variables))

    def subscribe(self, q: str, variables: dict | None = None, *,
                  cursor: int | None = None,
                  queue_max: int | None = None) -> Subscription:
        """Register a standing read: validates the query, evaluates it
        once at the current watermark, and returns the Subscription whose
        first queued event is `init` (fresh), `ack` (reconnect cursor and
        the journal PROVES nothing it reads changed since), or a typed
        `resync` (reconnect cursor, change possible)."""
        req = self._parse(q, variables)
        if getattr(req, "mutations", None) or \
                getattr(req, "upsert", None) is not None:
            raise ValueError("subscriptions must be read-only queries")
        if getattr(req, "schema_request", None) is not None:
            raise ValueError("schema requests are not subscribable")
        from ..query import qcache

        attrs = qcache.subscription_attrs(req)
        from .. import tenancy

        tenant = tenancy.current()
        if tenant and attrs is not None:
            # the touch test compares against COMMITTED storage attrs,
            # which carry the namespace prefix — translate the read set
            # once at registration, not per window
            attrs = tenancy.prefix_attrs(tenant, attrs)
        reg = self.registry
        qmax = queue_max or self.queue_max
        if reg is not None:
            cap_q = reg.sub_queue_max(tenant)
            if cap_q is not None:
                qmax = min(qmax, max(int(cap_q), 1))
        with self._cv:
            if self._closed:
                raise FailedPrecondition("live manager is closed")
            cap = reg.max_subs(tenant) if reg is not None else None
            if cap is not None and sum(
                    1 for s in self._subs.values()
                    if s.tenant == tenant) >= cap:
                reg.note_shed(tenant)
                raise ResourceExhausted(
                    f"tenant {tenant or 'default'!r} at max standing "
                    f"subscriptions ({cap})")
            sid = f"s{self._seq}"
            self._seq += 1
            sub = Subscription(self, sid, q, variables, attrs,
                               qmax, tenant)
            self._subs[sid] = sub
            if attrs is None:
                self._wildcard.add(sid)
            else:
                for a in attrs:
                    self._by_attr.setdefault(a, set()).add(sid)
            self.registered += 1
            self._count("dgraph_subs_registered_total")
            self._count("dgraph_subs_active")
            self._ensure_thread_locked()
        try:
            w0 = self._watermark()
            c = canon(self._eval_at(q, variables, w0, (sid,)))
        except BaseException:
            self.cancel(sid)
            raise
        first = "init"
        if cursor is not None:
            first = "ack" if self._cursor_unchanged(attrs, int(cursor)) \
                else "cursor"
        with self._cv:
            sub.last_canon = c
            sub.cursor = w0
            sub.ready = True
            if first == "ack":
                ev = {"type": "ack", "sub": sid, "at": w0}
            elif first == "cursor":
                sub.resyncs += 1
                self._count("dgraph_subs_resyncs_total")
                ev = {"type": "resync", "reason": "cursor", "sub": sid,
                      "at": w0, "result": json.loads(c)}
            else:
                ev = {"type": "init", "sub": sid, "at": w0,
                      "result": json.loads(c)}
            self._enqueue_locked(sub, ev)
            if self._c_notifs is not None:
                self._c_notifs.inc()
            if sub.pending_wake:
                self._cv.notify()        # commits landed during the eval
            # a new cursor sits at the watermark: it can only lower the
            # pin when it's the first one (or a cursor raced below the
            # floor) — the O(subs) min-scan on every subscribe turned 10k
            # registrations into an O(n^2) stall otherwise
            if self._last_pin is None or sub.cursor < self._last_pin:
                self._update_pin_locked()
        return sub

    def _cursor_unchanged(self, attrs: frozenset | None,
                          cursor: int) -> bool:
        """True only when the delta journal PROVES no subscribed predicate
        changed after `cursor` (floor at/below it AND no newer entries) —
        the cheap-ack reconnect path. None attrs can never prove."""
        if attrs is None:
            return False
        for st in self._stores:
            for a in attrs:
                if st.delta_since(a, cursor) != {}:
                    return False
        return True

    def cancel(self, sid: str) -> bool:
        with self._cv:
            return self._close_sub_locked(sid, None)

    def reap(self, sid: str) -> bool:
        """A dead wire client (write failed / socket gone): same teardown
        as cancel, counted separately — it unpins the cursor a vanished
        subscriber would otherwise hold forever."""
        ok = self.cancel(sid)
        if ok:
            self._count("dgraph_subs_reaped_total")
        return ok

    def _close_sub_locked(self, sid: str, final_ev: dict | None) -> bool:
        sub = self._subs.pop(sid, None)
        if sub is None:
            return False
        self._wildcard.discard(sid)
        if sub.attrs is not None:
            for a in sub.attrs:
                peers = self._by_attr.get(a)
                if peers is not None:
                    peers.discard(sid)
                    if not peers:
                        del self._by_attr[a]
        self._dirty.discard(sid)
        if final_ev is not None:
            sub.queue.clear()
            sub.queue.append(final_ev)
        sub.closed = True
        sub.cv.notify_all()
        self._count("dgraph_subs_active", -1)
        # removing a sub can only RAISE the floor, and only when it was
        # the one holding it — skip the min-scan otherwise (and amortise
        # it even then: a mass-cancel of same-cursor subs would turn an
        # immediate rescan into O(n^2))
        if self._last_pin is not None and sub.cursor <= self._last_pin:
            self._maybe_raise_pin_locked()
        return True

    # -- commit feed ---------------------------------------------------------

    @property
    def active(self) -> bool:
        return bool(self._subs)

    def notify_commit(self, commit_ts: int, preds) -> None:
        """Called by the engine right after a commit window applies.
        Cheap when nobody subscribes (one truthiness check)."""
        if not self._subs:
            return
        with self._cv:
            self._events.append((int(commit_ts), tuple(preds),
                                 time.perf_counter()))
            self._cv.notify()

    def on_journal_overflow(self, attr: str) -> None:
        """Store callback from INSIDE the commit critical section: the
        journal dropped completeness for `attr`, so affected diff chains
        must resync. Lock-free append only (see _overflow above)."""
        self._overflow.append(attr)

    # -- notifier ------------------------------------------------------------

    def _ensure_thread_locked(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        # dgraph: allow(ctxvar-copy) detached notifier loop — deadlines
        # and cost ledgers are minted per re-evaluation, not inherited
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="live-notifier")
        self._thread.start()

    def _ensure_pool(self):
        if self._pool is None and self._eval_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self._eval_workers,
                thread_name_prefix="live-eval")
        return self._pool

    def _runnable_locked(self) -> bool:
        if self._stop or self._events or self._overflow:
            return True
        return bool(self._dirty) and (
            not self._retry_at or time.monotonic() >= self._retry_at)

    def _run(self) -> None:
        while True:
            with self._cv:
                if not self._runnable_locked():
                    self._cv.wait(0.5)
                if self._stop:
                    return
                window = self._collect_locked()
            if window is not None:
                self._process(window)

    def _collect_locked(self):
        """Drain every pending commit event + overflow mark into ONE
        coalesced window; returns (watermark, first-arrival, groups) or
        None. Also the expiry sweep (a blocked queue past the idle
        timeout = a vanished client)."""
        now_m = time.monotonic()
        for sid in [s.id for s in self._subs.values()
                    if s.blocked_since is not None
                    and now_m - s.blocked_since > self.idle_timeout_s]:
            if self._close_sub_locked(sid, {"type": "expire", "sub": sid,
                                            "reason": "idle"}):
                self._count("dgraph_subs_expired_total")
        while self._overflow:
            attr = self._overflow.popleft()
            for sid in set(self._by_attr.get(attr, ())) | self._wildcard:
                sub = self._subs.get(sid)
                if sub is not None:
                    sub.needs_resync = sub.needs_resync or "overflow"
                    self._mark_locked(sub)
        w = 0
        t_first = None
        preds: set[str] = set()
        had_events = bool(self._events)
        while self._events:
            ts, ps, t = self._events.popleft()
            w = max(w, ts)
            preds.update(ps)
            t_first = t if t_first is None else min(t_first, t)
        for attr in preds:
            for sid in self._by_attr.get(attr, ()):
                sub = self._subs.get(sid)
                if sub is not None:
                    self._mark_locked(sub)
        if had_events:
            for sid in list(self._wildcard):
                sub = self._subs.get(sid)
                if sub is not None:
                    self._mark_locked(sub)
        if self._retry_at and time.monotonic() < self._retry_at \
                and not had_events:
            return None
        ready = [self._subs[sid] for sid in self._dirty
                 if sid in self._subs and self._subs[sid].ready]
        if not ready:
            return None
        groups: dict[tuple, tuple] = {}
        for sub in ready:
            # the tenant is part of the coalescing identity: two tenants'
            # byte-identical DQL reads DIFFERENT tablets, so sharing one
            # re-evaluation would leak namespace A's result into B
            key = (sub.q, canon(sub.variables or {}), sub.tenant)
            if key in groups:
                groups[key][1].append(sub)
            else:
                groups[key] = (sub.variables, [sub])
        if w == 0:
            w = self._watermark()
        if t_first is None:
            t_first = time.perf_counter()
        return (w, t_first, groups)

    def _mark_locked(self, sub: Subscription) -> None:
        if not sub.pending_wake:
            sub.pending_wake = True
            self._dirty.add(sub.id)

    def _process(self, window) -> None:
        """Re-execute each distinct woken (query, variables) ONCE at the
        window watermark — concurrently, so the DeviceBatcher packs the
        device steps — then fan the per-subscription diffs out."""
        w, t_first, groups = window
        items = list(groups.items())
        self.windows += 1
        self._count("dgraph_subs_windows_total")
        self._count("dgraph_subs_wakeups_total",
                    sum(len(subs) for _v, subs in groups.values()))
        self._count("dgraph_subs_evals_total", len(items))
        if self._batcher is not None and len(items) > 1:
            hint = getattr(self._batcher, "hint_burst", None)
            if hint is not None:
                hint()

        def run_one(q, variables, sub_ids, tenant):
            from .. import tenancy

            try:
                # the notifier thread carries no request context: install
                # the group's tenant so the engine resolves its namespace
                with tenancy.scope(tenant):
                    return (True, canon(
                        self._eval_at(q, variables, w, sub_ids)))
            except Exception as e:       # retried with backoff, then resync
                return (False, f"{type(e).__name__}: {e}")

        results: dict[tuple, tuple] = {}
        pool = self._ensure_pool() if len(items) > 1 else None
        if pool is not None:
            # dgraph: allow(ctxvar-copy) re-evals mint their own ledgers/
            # deadlines; nothing context-bound crosses into the pool
            futs = {key: pool.submit(run_one, key[0], variables,
                                     tuple(s.id for s in subs), key[2])
                    for key, (variables, subs) in items}
            for key, fut in futs.items():
                results[key] = fut.result()
        else:
            for key, (variables, subs) in items:
                results[key] = run_one(key[0], variables,
                                       tuple(s.id for s in subs), key[2])
        now_p = time.perf_counter()
        latency_s = max(now_p - t_first, 0.0)
        with self._cv:
            any_fail = False
            memo: dict = {}              # per-window parse/diff sharing
            for key, (_variables, subs) in items:
                ok, val = results[key]
                delivered = 0
                done: list[str] = []
                for sub in subs:
                    if sub.closed or sub.id not in self._subs:
                        continue
                    if not ok:
                        any_fail = True
                        sub.needs_resync = sub.needs_resync or "error"
                        continue         # stays dirty; retried next round
                    sub.pending_wake = False
                    done.append(sub.id)
                    if self._deliver_locked(sub, val, w, memo):
                        delivered += 1
                # fan-out bookkeeping is batched per GROUP, not per
                # subscriber: one dirty-set update, one counter add, and
                # one latency observation (every subscriber of the group
                # shares the window's single latency value) — at 10k
                # standing subs the per-sub variants dominated the
                # notifier's CPU and taxed foreground readers
                self._dirty.difference_update(done)
                if delivered:
                    if self._c_notifs is not None:
                        self._c_notifs.inc(delivered)
                    if self._h_latency is not None:
                        self._h_latency.observe(latency_s)
            if any_fail:
                self._backoff = min(max(self._backoff * 2, _BACKOFF_MIN_S),
                                    _BACKOFF_MAX_S)
                self._retry_at = time.monotonic() + self._backoff
            else:
                self._backoff = 0.0
                self._retry_at = 0.0
            self._maybe_raise_pin_locked()

    def _deliver_locked(self, sub: Subscription, c: str, w: int,
                        memo: dict | None = None) -> bool:
        """One subscription's outcome for one window: a typed resync when
        the diff chain broke, a diff when the result changed, or a silent
        cursor advance when the wake was a false positive (the commit
        touched the read set without changing this result).

        `memo` shares parsed results, diffs, AND whole event objects
        across the window's subscribers: every sub of a coalesced group
        carries the same (old, new) canon pair, so the O(result-size)
        work — and the event dict itself — happens once per GROUP, not
        once per subscription. Window events (diff, window resync) are
        therefore STREAM-SCOPED: they carry no `sub` field (the
        subscription is implied by the channel that delivers them —
        one SSE connection / one iterator per subscription) and must be
        treated as read-only shared objects (the SSE path serializes
        them immediately; embedded consumers get the same contract).
        Registration replies (init/ack/cursor resync) and expire keep
        their `sub` field: they answer a specific registration."""
        if sub.needs_resync:
            ev = {"type": "resync", "reason": sub.needs_resync,
                  "at": w, "result": _loads_memo(c, memo)}
            sub.needs_resync = None
            sub.resyncs += 1
            self._count("dgraph_subs_resyncs_total")
        elif c != sub.last_canon:
            if memo is not None and ("ev", sub.last_canon, c) in memo:
                ev = memo[("ev", sub.last_canon, c)]
            else:
                d = result_diff(json.loads(sub.last_canon)
                                if sub.last_canon is not None else None,
                                _loads_memo(c, memo))
                ev = {"type": "diff", "at": w, "diff": d,
                      "result": _loads_memo(c, memo)}
                if memo is not None:
                    memo[("ev", sub.last_canon, c)] = ev
        else:
            sub.cursor = w
            sub.last_canon = c
            return False
        sub.last_canon = c
        sub.cursor = w
        self._enqueue_locked(sub, ev)
        return True

    def _enqueue_locked(self, sub: Subscription, ev: dict) -> None:
        """Bounded enqueue with slow-consumer shedding: a full queue is
        REPLACED by one resync carrying the current result — the client
        converges from any number of missed diffs, and memory stays
        bounded no matter how far behind it is."""
        if len(sub.queue) >= sub.queue_max:
            sub.queue.clear()
            sub.sheds += 1
            self._count("dgraph_subs_sheds_total")
            if ev.get("type") != "resync" and "result" in ev:
                ev = {"type": "resync", "reason": "shed",
                      "at": ev["at"], "result": ev["result"]}
                sub.resyncs += 1
                self._count("dgraph_subs_resyncs_total")
            if sub.blocked_since is None:
                sub.blocked_since = time.monotonic()
        # the notifications counter is the CALLER's job: _process batches
        # one add per group, subscribe counts its single reply event
        sub.queue.append(ev)
        if sub.waiting:                  # skip the wakeup scan when no
            sub.cv.notify_all()          # consumer is parked (the common
                                         # standing-subscription case)

    # -- journal retention ---------------------------------------------------

    _PIN_RAISE_S = 1.0

    def _maybe_raise_pin_locked(self) -> None:
        """Amortised pin maintenance for the hot paths (per window, per
        cancel). RAISING the floor is a retention optimisation, never a
        correctness edge: cursors only advance, and a floor that lags the
        true minimum merely retains a sliver of extra journal — so the
        O(subs) min-scan runs at most once per _PIN_RAISE_S. Lowering
        (first subscriber) and releasing (last one gone) stay immediate
        at their call sites."""
        now = time.monotonic()
        if self._subs and now < self._pin_raise_at:
            return
        self._pin_raise_at = now + self._PIN_RAISE_S
        self._update_pin_locked()

    def _update_pin_locked(self) -> None:
        """Pin every store's delta-journal floor at the oldest active
        cursor, so a reconnect-with-cursor stays provable (cheap ack) as
        long as retention allows; no subscribers = no pin."""
        cur = min((s.cursor for s in self._subs.values() if s.ready),
                  default=None)
        if cur == self._last_pin:
            return
        self._last_pin = cur
        for st in self._stores:
            st.pin_delta_floor(cur)

    # -- introspection / lifecycle ------------------------------------------

    def stats(self) -> dict:
        with self._cv:
            out = {
                "active": len(self._subs),
                "registered": self.registered,
                "windows": self.windows,
                "wildcard": len(self._wildcard),
                "attrs_indexed": len(self._by_attr),
                "queued": sum(len(s.queue) for s in self._subs.values()),
                "pinned_cursor": self._last_pin,
                "pending": len(self._dirty),
            }
            by_tenant: dict[str, int] = {}
            for s in self._subs.values():
                if s.tenant:
                    by_tenant[s.tenant] = by_tenant.get(s.tenant, 0) + 1
            if by_tenant:
                out["tenants"] = by_tenant
            return out

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._stop = True
            for sid in list(self._subs):
                self._close_sub_locked(sid, None)
            self._cv.notify_all()
        th = self._thread
        if th is not None:
            th.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
