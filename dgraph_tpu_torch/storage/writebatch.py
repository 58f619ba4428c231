"""Group-commit write batching: one fsync per commit window.

Copy of dgraph_tpu/storage/writebatch.py for the PyTorch port.

Fifteen rounds scaled reads while every commit still paid its own oracle
conflict pass, its own fsync'd WAL append, and its own per-predicate
watermark advance. This module is the write-side sibling of
query/batch.py's DeviceBatcher — the same short-window collector shape
(window / early-fire / idle-bypass / per-member demux), applied to the
badger-style group commit the reference's write path uses (SURVEY
§storage):

  * WriteBatcher — committing txns that arrive within a ~2ms window form
    ONE group: one Oracle.commit_batch conflict pass under one oracle
    lock hold, one contiguous WAL append with ONE os.fsync
    (Store.commit_group), and one store-lock hold advancing every
    member's watermarks — so the delta journal accumulates the window's
    UNION delta and the next read stamps each touched predicate once
    instead of once per commit.
  * Per-member outcomes demux exactly like solo commits: a conflicting
    member gets its typed TxnConflict (and its buffered layers abort)
    while the rest of the window commits; an unknown txn gets
    TxnNotFound. Acks release only AFTER the window's apply lands, so a
    committer's next read observes its own write (read-your-writes is
    preserved through the watermark the apply advanced).
  * A WAL append failure AFTER the oracle assigned commit timestamps is
    typed CommitAmbiguous for every surviving member: the decision
    cannot be re-run (retrying could double-apply), and whether the
    record reached the log/quorum is unknowable from here — the exact
    contract utils/retry refuses to retry.
  * Idle-fire: when no group append is in flight the leader skips the
    window entirely — unloaded writers pay zero added latency. Deadline
    bypass: a committer whose remaining budget cannot cover the window
    plus the expected append runs the solo per-commit path instead.
  * A batch of ONE runs its solo closure — the exact per-commit path
    (per-commit WAL record, per-commit fsync), so unaccompanied traffic
    produces byte-identical logs to the pre-16 write path.

Observability: dgraph_write_batch_* counters + occupancy histogram on
/metrics and the /debug/metrics "writes" section; group appends note
"group_commit" on member cost ledgers with the append wall-ms
apportioned across the window.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from dgraph_tpu_torch.coord.zero import TxnConflict
from dgraph_tpu_torch.obs import costs, otrace
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils import locks
from dgraph_tpu_torch.utils.retry import CommitAmbiguous


class _Entry:
    __slots__ = ("start_ts", "keys", "solo", "dl", "lg", "tenant",
                 "event", "result", "error", "batch_size")

    def __init__(self, start_ts: int, keys, solo: Callable,
                 tenant: str = "") -> None:
        self.start_ts = start_ts
        self.keys = keys
        self.solo = solo          # zero-arg exact per-commit path
        self.dl = dl.current()    # the committing caller's deadline
        self.lg = costs.current()  # ... and cost ledger (apportioned)
        self.tenant = tenant      # committing namespace (slot caps)
        self.event = threading.Event()
        self.result: Any = None   # commit_ts on success
        self.error: BaseException | None = None
        self.batch_size = 0


class _Batch:
    __slots__ = ("entries", "full", "closed")

    def __init__(self, entry: _Entry) -> None:
        self.entries = [entry]
        self.full = threading.Event()
        self.closed = False


# follower safety net: a leader always sets every entry's event in its
# finally block, so this only fires on catastrophic leader death
_FOLLOWER_WAIT_S = 120.0


class WriteBatcher:
    """Short-window collector of concurrent committing transactions.

    All commits are mutually compatible (they share the oracle and the
    journal), so there is a single open batch at a time — no
    classification key. `oracle` is the Zero txn oracle, `store` the
    posting store whose WAL the window appends to."""

    def __init__(self, oracle, store, metrics=None, window_ms: float = 2.0,
                 max_batch: int = 64, idle_fire: bool = True) -> None:
        from dgraph_tpu_torch.utils.metrics import Registry

        self.oracle = oracle
        self.store = store
        self.metrics = metrics if metrics is not None else Registry()
        self.window_s = max(float(window_ms), 0.0) / 1000.0
        self.max_batch = max(int(max_batch), 1)
        # fire-immediately when the journal is idle: a batch leader skips
        # the window when no group append is in flight, so concurrency-1
        # writers pay ZERO added latency. Tests disable it to force
        # deterministic full windows.
        self.idle_fire = idle_fire
        self._lock = locks.Lock("writebatch.WriteBatcher._lock")
        self._open: _Batch | None = None
        self._own_inflight = 0
        # EWMA of one group append+apply (seconds) — the deadline-bypass
        # estimate of what joining the window costs beyond the window
        self._step_s = 0.001
        m = self.metrics
        self._formed = m.counter("dgraph_write_batch_formed_total")
        self._commits = m.counter("dgraph_write_batch_commits_total")
        self._fsyncs = m.counter("dgraph_write_batch_fsyncs_total")
        self._occupancy = m.histogram("dgraph_write_batch_occupancy")
        self._window_waits = m.counter(
            "dgraph_write_batch_window_waits_total")
        self._bypass = m.counter(
            "dgraph_write_batch_deadline_bypass_total")
        self._conflicts = m.counter(
            "dgraph_write_batch_conflict_aborts_total")
        self._tenant_solo = m.counter(
            "dgraph_write_batch_tenant_solo_total")
        # multi-tenant QoS (dgraph_tpu/tenancy/): when armed,
        # Node injects tenant_fn (tenancy.current) and tenant_cap_fn
        # (tenant -> max window slots, None = uncapped). An over-cap
        # tenant's commit runs the exact solo per-commit path — still
        # correct, still durable, but it pays its OWN fsync instead of
        # crowding lighter tenants out of the shared window. Disarmed
        # (--no_qos / unconfigured): both stay None, zero overhead.
        self.tenant_fn = None
        self.tenant_cap_fn = None

    def _busy(self) -> bool:
        return self._own_inflight > 0

    def _deadline_bypasses(self) -> bool:
        """True when the caller's remaining budget cannot cover the
        window plus the expected group append — it commits solo instead,
        where the per-commit path's own deadline machinery applies."""
        rem = dl.remaining()
        if rem is None:
            return False
        if rem < self.window_s + self._step_s:
            self._bypass.inc()
            otrace.event("write_batch_bypass",
                         remaining_ms=round(rem * 1000, 1))
            costs.note("write_batch_bypass")
            return True
        return False

    def submit(self, start_ts: int, keys, solo: Callable) -> int:
        """Commit one txn through the window. Returns commit_ts; raises
        the same typed errors the solo path would (TxnConflict after the
        member's layers abort, TxnNotFound, CommitAmbiguous when the
        group append failed after the oracle decided). `solo` is the
        exact per-commit path, run for deadline bypasses and windows of
        one."""
        if self._deadline_bypasses():
            return solo()
        tenant = self.tenant_fn() if self.tenant_fn is not None else ""
        cap = self.tenant_cap_fn(tenant) \
            if self.tenant_cap_fn is not None else None
        entry = _Entry(start_ts, keys, solo, tenant)
        over_cap = False
        with self._lock:
            b = self._open
            if b is not None and not b.closed and \
                    len(b.entries) < self.max_batch:
                if cap is not None and sum(
                        1 for en in b.entries
                        if en.tenant == tenant) >= cap:
                    # this tenant already holds its share of the window:
                    # commit solo (own fsync) rather than crowding the
                    # group — leading a FRESH window stays allowed, so a
                    # lone heavy writer on an idle node still batches
                    over_cap = True
                else:
                    b.entries.append(entry)
                    if len(b.entries) >= self.max_batch:
                        b.full.set()
                    leader = False
            else:
                b = _Batch(entry)
                self._open = b
                leader = True
        if over_cap:
            self._tenant_solo.inc()
            costs.note("write_batch_tenant_cap")
            otrace.event("write_batch_tenant_cap", tenant=tenant)
            return solo()
        if not leader:
            rem = dl.remaining()
            wait_s = _FOLLOWER_WAIT_S if rem is None else \
                min(_FOLLOWER_WAIT_S, max(rem, 0.0) + 0.1)
            if not entry.event.wait(wait_s):
                # own budget gone while the window still runs: typed
                # DeadlineExceeded (never a hang past the budget) — the
                # window's outcome for this txn is discarded
                dl.check("group commit window")
                raise RuntimeError("group commit leader never completed")
            otrace.event("group_commit", size=entry.batch_size)
            if entry.error is not None:
                raise entry.error
            return entry.result
        try:
            if self.window_s > 0 and \
                    not (self.idle_fire and not self._busy()):
                self._window_waits.inc()
                t0 = time.perf_counter()
                # dgraph: allow(deadline-wait) leader window wait is
                # bounded by the ~2ms collection window constant; tight
                # budgets bypassed the window entirely upstream
                b.full.wait(self.window_s)
                # continuous collection: while a group append is already
                # in flight this window could only queue behind it, so
                # keep collecting until the journal frees up (bounded by
                # one window + one expected append)
                cap = self.window_s + self._step_s
                while (not b.full.is_set()) and self._busy() and \
                        time.perf_counter() - t0 < cap:
                    # dgraph: allow(deadline-wait) bounded by `cap` (one
                    # window + one expected append) in the loop condition
                    b.full.wait(self.window_s)
        finally:
            with self._lock:
                b.closed = True
                if self._open is b:
                    self._open = None
                self._own_inflight += 1
        entries = b.entries
        try:
            if len(entries) == 1:
                entries[0].result = entries[0].solo()
                self._fsyncs.inc()   # solo path pays its own fsync
                self._commits.inc()
            else:
                # the window acts for SEVERAL committers: run under the
                # most permissive member's deadline (unbudgeted if any
                # member is) so a tight-budget leader cannot shed the
                # append the other members had ample time for
                dls = [en.dl for en in entries]
                batch_dl = None if any(d is None for d in dls) else \
                    max(dls, key=lambda d: d.expires)
                with dl.adopt(batch_dl):
                    self._run_group(entries)
        except BaseException as e:
            # a failure of the WINDOW fails every member without a
            # per-member outcome yet; per-member conflicts/aborts were
            # assigned individually inside the runner
            for en in entries:
                if en.result is None and en.error is None:
                    en.error = e
        finally:
            with self._lock:
                self._own_inflight -= 1
            n = len(entries)
            self._formed.inc()
            self._occupancy.observe(float(n))
            for en in entries:
                en.batch_size = n
                en.event.set()
        otrace.event("group_commit", size=entry.batch_size)
        if entry.error is not None:
            raise entry.error
        return entry.result

    def _run_group(self, entries: list[_Entry]) -> None:
        """One window: batched oracle decision, then ONE WAL append +
        fsync + in-memory apply for every committing member."""
        t0 = time.perf_counter()
        with otrace.span("zero:commit_batch", size=len(entries)):
            decisions = self.oracle.commit_batch(
                [en.start_ts for en in entries])
        members: list[tuple[_Entry, int]] = []
        for en, res in zip(entries, decisions):
            if isinstance(res, BaseException):
                if isinstance(res, TxnConflict):
                    self._conflicts.inc()
                    try:
                        self.store.abort(en.start_ts, list(en.keys))
                    except (ConnectionError, OSError):
                        # the abort record is advisory (an unreplayed
                        # abort only leaves uncommitted layers rollup
                        # discards); the member's outcome stays the
                        # typed TxnConflict
                        pass
                en.error = res
            else:
                members.append((en, res))
        if not members:
            return
        try:
            with otrace.span("store:group_commit", size=len(members)):
                self.store.commit_group(
                    [(en.start_ts, ts, list(en.keys))
                     for en, ts in members])
        except BaseException as e:
            # commit timestamps are already assigned and conflict-
            # tracked: the decision cannot be re-run, and whether the
            # record reached the log (or a replication quorum) before
            # the failure is unknowable here — ambiguous, typed, never
            # retried (utils/retry's contract)
            for en, _ts in members:
                amb = CommitAmbiguous(
                    f"group commit append failed mid-window: {e!r}")
                amb.__cause__ = e
                en.error = amb
            return
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._step_s = 0.8 * self._step_s + 0.2 * (dt_ms / 1e3)
        self._fsyncs.inc()           # ONE fsync covered len(members)
        self._commits.inc(len(members))
        frac = dt_ms / len(members)
        for en, ts in members:
            if en.lg is not None:
                # apportion the window's append+apply wall ms across the
                # member commits it acted for
                en.lg.add_kernel("group_commit", frac)
                en.lg.note("group_commit")
            en.result = ts
