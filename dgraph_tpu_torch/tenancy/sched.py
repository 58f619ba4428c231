"""Weighted-fair device scheduling: tenant-ordered DispatchGate admission.

Copy of dgraph_tpu/tenancy/sched.py for the PyTorch port.

Start-time fair queueing over per-tenant virtual time: every measured
device dispatch charges its wall-ms / weight to the submitting tenant's
virtual clock, and when the gate is CONTENDED (the non-blocking acquire
failed), waiters are admitted lowest-virtual-time-first across tenants —
deficit-weighted round-robin in the limit, since a tenant that just ran
has the highest clock and a starved tenant the lowest. One tenant at
100x fair share therefore queues behind every lighter tenant's next
dispatch instead of monopolizing the device, while the uncontended path
(and the whole scheduler when disarmed) costs exactly one attribute
load at the gate.

The scheduler also keeps the per-tenant device-ms EWMA — the deficit
signal of the design — surfaced in snapshot() for /debug/metrics and
used by the WriteBatcher's per-tenant window slot caps.
"""

from __future__ import annotations

import threading

from dgraph_tpu_torch.utils import deadline as dl

_EWMA_ALPHA = 0.2
# renormalize virtual clocks when the floor passes this (keeps floats
# bounded over weeks of uptime without changing any ordering)
_VTIME_NORM = 1e9


class FairScheduler:
    """Per-tenant fair admission for the DispatchGate (+ the EWMA/weight
    oracle for the write window). weight_fn maps tenant -> fair-share
    weight (TenantRegistry.weight)."""

    def __init__(self, weight_fn=None, metrics=None) -> None:
        self._weight_fn = weight_fn or (lambda _t: 1.0)
        self.metrics = metrics
        self._cv = threading.Condition()
        self._waiting: dict[str, int] = {}
        self._vtime: dict[str, float] = {}
        self._ewma_ms: dict[str, float] = {}

    # -- admission (called by DispatchGate._acquire on contention) ------------

    def _floor_locked(self) -> float:
        return min(self._vtime.values(), default=0.0)

    def _turn_locked(self) -> str | None:
        floor = self._floor_locked()
        best, bv = None, None
        for t in self._waiting:
            v = self._vtime.get(t, floor)
            if bv is None or v < bv or (v == bv and t < best):
                best, bv = t, v
        return best

    def admit(self, tenant: str) -> None:
        """Block until it is this tenant's turn to contend for a slot.
        Budgeted callers wait at most their remaining deadline (typed
        DeadlineExceeded past it) — the fair queue must never out-hang
        the lifeline contract."""
        with self._cv:
            # a long-idle tenant re-enters at the current floor: history
            # neither punishes it nor banks an unbounded burst credit
            self._vtime[tenant] = max(self._vtime.get(tenant, 0.0),
                                      self._floor_locked())
            self._waiting[tenant] = self._waiting.get(tenant, 0) + 1
            try:
                while self._turn_locked() != tenant:
                    if not self._cv.wait(dl.clamp(None)):
                        dl.check("tenant fair queue")
            finally:
                n = self._waiting[tenant] - 1
                if n:
                    self._waiting[tenant] = n
                else:
                    del self._waiting[tenant]
                self._cv.notify_all()

    def acquire(self, tenant: str, sem) -> bool:
        """Admission and slot acquisition in ONE wait: block until this
        tenant holds the lowest virtual clock among waiters AND the gate
        semaphore yields a slot, then take the slot before returning.

        Folding the two waits closes the barging window admit() alone
        leaves open: a hot thread that just released the slot re-grabs it
        through a non-blocking fast path before any parked waiter wakes,
        and under saturation that hands one tenant the whole device (the
        waiters sit invisible inside the semaphore, so the fair queue
        never even sees contention). Waiters instead park HERE, and every
        release (charge() notifies under the same condition) re-opens the
        contest in virtual-time order. Budgeted callers wait at most
        their remaining deadline (typed DeadlineExceeded past it); the
        bounded re-poll covers a scheduler disarmed mid-wait (--no_qos
        hot toggle), after which charges stop notifying.

        Returns True when it had to wait for the slot."""
        waited = False
        with self._cv:
            self._vtime[tenant] = max(self._vtime.get(tenant, 0.0),
                                      self._floor_locked())
            self._waiting[tenant] = self._waiting.get(tenant, 0) + 1
            try:
                while not (self._turn_locked() == tenant
                           and sem.acquire(blocking=False)):
                    waited = True
                    if not self._cv.wait(dl.clamp(0.05)):
                        dl.check("tenant fair queue")
                return waited
            finally:
                n = self._waiting[tenant] - 1
                if n:
                    self._waiting[tenant] = n
                else:
                    del self._waiting[tenant]
                self._cv.notify_all()

    def depth(self) -> int:
        """Waiters currently parked in the fair queue (the armed gate's
        max_queue shed input)."""
        with self._cv:
            return sum(self._waiting.values())

    # -- charging (DispatchGate.run, after the measured dispatch) -------------

    def charge(self, tenant: str, ms: float) -> None:
        if ms < 0:
            return
        w = self._weight_fn(tenant)
        w = w if w and w > 0 else 1.0
        with self._cv:
            prev = self._ewma_ms.get(tenant, 0.0)
            self._ewma_ms[tenant] = ms if not prev else (
                (1 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * ms)
            self._vtime[tenant] = self._vtime.get(
                tenant, self._floor_locked()) + ms / w
            if self._vtime and min(self._vtime.values()) > _VTIME_NORM:
                base = min(self._vtime.values())
                for t in self._vtime:
                    self._vtime[t] -= base
            self._cv.notify_all()

    def ewma_ms(self, tenant: str) -> float:
        with self._cv:
            return self._ewma_ms.get(tenant, 0.0)

    def snapshot(self) -> dict:
        with self._cv:
            return {"waiting": dict(self._waiting),
                    "vtime_ms": {t: round(v, 3)
                                 for t, v in self._vtime.items()},
                    "ewma_ms": {t: round(v, 3)
                                for t, v in self._ewma_ms.items()}}
