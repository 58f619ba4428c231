"""Unified retry policy + per-endpoint circuit breaking.

Copy of dgraph_tpu/utils/retry.py for the PyTorch port.

Reference semantics: the reference client retries aborted txns and failed
RPCs with backoff (x/x.go RetryUntilSuccess-shape loops, conn/pool.go
reconnect backoff) and routes around unhealthy peers via Echo health
state. This module replaces the repo's ad-hoc loops (parallel/client.py
mutate's bare `except Exception` + fixed 0.1s sleep, coord/zero_service
ZeroClient._rpc's fixed 0.2s rotation sleep) with one policy:

  * RetryPolicy — exponential backoff with FULL jitter (AWS-style:
    sleep = uniform(0, min(cap, base * 2^attempt))), a per-request retry
    budget, deadline awareness (never sleeps past the active deadline,
    never retries DeadlineExceeded), and an explicit retryable-error
    contract: by default only transport-shaped failures retry — a
    programming error propagates on the first throw.
  * CircuitBreaker — closed / open / half-open per endpoint, fed by the
    same error/latency signals the hedger sees. A flapping replica trips
    open after `fail_threshold` consecutive transport failures; while
    open, routing skips it instead of paying its timeout per request;
    after `open_s` one half-open probe is admitted and its outcome closes
    or re-opens the breaker.
  * CommitAmbiguous — a txn whose commit decision cannot be known (the
    commit RPC timed out in flight, or the Decide fan-out failed after a
    successful commit). NEVER retried: re-running the txn could apply it
    twice (blank nodes would mint fresh uids).
"""

from __future__ import annotations

import random
import threading
import time

from .deadline import DeadlineExceeded
from . import deadline as dl_mod


class CommitAmbiguous(Exception):
    """The commit decision's outcome is unknown (in-flight timeout) or a
    committed txn's Decide fan-out failed. Not retryable by design."""

    code = "COMMIT_AMBIGUOUS"


def transport_errors() -> tuple:
    """The transport-shaped error classes a retry may assume were not a
    programming error: connection loss, RPC failure, and the replication
    layer's quorum loss. RuntimeError is included for the repo's
    'no live leader' / 'no connection to group' routing errors."""
    from ..parallel.remote import NoQuorum

    errs: list[type] = [ConnectionError, OSError, TimeoutError,
                        NoQuorum, RuntimeError]
    try:
        import grpc

        errs.append(grpc.RpcError)
    except ImportError:                       # pragma: no cover
        pass
    return tuple(errs)


def backoff_s(attempt: int, base_s: float = 0.05, cap_s: float = 1.0,
              rng=None) -> float:
    """Full-jitter exponential backoff for the given 0-based attempt."""
    ceiling = min(cap_s, base_s * (2 ** attempt))
    return (rng or random).uniform(0, ceiling)


class RetryPolicy:
    """One request's retry discipline. Stateless across calls (safe to
    share); the per-request budget is tracked inside run()."""

    def __init__(self, max_attempts: int = 4, base_s: float = 0.05,
                 cap_s: float = 1.0, budget_s: float | None = None,
                 rng=None, metrics=None, name: str = "") -> None:
        self.max_attempts = max(1, int(max_attempts))
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.budget_s = budget_s          # total sleep budget across retries
        self.rng = rng or random
        self.metrics = metrics
        self.name = name

    def run(self, fn, retryable: tuple | None = None,
            abort_on: tuple = (), on_retry=None):
        """Call fn() with retries. `retryable` errors (default: transport
        shapes) back off and retry; `abort_on` errors — and DeadlineExceeded
        / CommitAmbiguous, always — propagate immediately. on_retry(exc) is
        invoked before each re-attempt (cache invalidation hooks)."""
        if retryable is None:
            retryable = transport_errors()
        never = (DeadlineExceeded, CommitAmbiguous) + tuple(abort_on)
        slept = 0.0
        last: BaseException | None = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except never:
                raise
            except retryable as e:
                last = e
                if attempt == self.max_attempts - 1:
                    raise
                pause = backoff_s(attempt, self.base_s, self.cap_s, self.rng)
                if self.budget_s is not None and \
                        slept + pause > self.budget_s:
                    raise
                rem = dl_mod.remaining()
                if rem is not None and pause >= rem:
                    # sleeping would blow the deadline: surface the cause
                    raise
                if self.metrics is not None:
                    self.metrics.counter("dgraph_retry_total").inc()
                from ..obs import costs, otrace

                costs.note("retries")
                otrace.event("retry", op=self.name or "call",
                             attempt=attempt + 1,
                             error=type(e).__name__, backoff_ms=
                             round(pause * 1000.0, 1))
                if on_retry is not None:
                    on_retry(e)
                time.sleep(pause)
                slept += pause
        raise last if last else RuntimeError("retry exhausted")


class CircuitBreaker:
    """Per-endpoint closed/open/half-open breaker.

    State values match the dgraph_breaker_state gauge: 0 = closed,
    1 = half-open, 2 = open. Latency feeds in as a soft failure when
    `latency_threshold_s` is set (the hedger's slow-replica signal);
    transport errors are hard failures. Thread-safe; `clock` is
    injectable for tests."""

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2

    def __init__(self, fail_threshold: int = 5, open_s: float = 5.0,
                 latency_threshold_s: float | None = None,
                 clock=time.monotonic) -> None:
        self.fail_threshold = max(1, int(fail_threshold))
        self.open_s = float(open_s)
        self.latency_threshold_s = latency_threshold_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._fails = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_at = 0.0

    @property
    def state(self) -> int:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _maybe_half_open_locked(self) -> None:
        if self._state == self.OPEN and \
                self._clock() - self._opened_at >= self.open_s:
            self._state = self.HALF_OPEN
            self._probing = False

    def allow(self) -> bool:
        """May a request be routed to this endpoint right now? Open:
        no. Half-open: exactly one in-flight probe — granting consumes
        the probe token; record() (either outcome) releases it, and a
        token whose request never reported back expires after open_s so
        a dropped probe cannot wedge the breaker half-open forever."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return True
            if self._state != self.HALF_OPEN:
                return False
            if self._probing and \
                    self._clock() - self._probe_at >= self.open_s:
                self._probing = False       # stale probe: token expired
            if not self._probing:
                self._probing = True
                self._probe_at = self._clock()
                return True
            return False

    def record(self, ok: bool, latency_s: float | None = None) -> None:
        """Feed one outcome. A success that was slower than the latency
        threshold counts as a (soft) failure — a consistently slow replica
        trips the breaker the same way a failing one does."""
        if ok and latency_s is not None and \
                self.latency_threshold_s is not None and \
                latency_s > self.latency_threshold_s:
            ok = False
        with self._lock:
            if ok:
                self._state = self.CLOSED
                self._fails = 0
                self._probing = False
                return
            self._fails += 1
            self._probing = False
            if self._state == self.HALF_OPEN or \
                    self._fails >= self.fail_threshold:
                self._state = self.OPEN
                self._opened_at = self._clock()
