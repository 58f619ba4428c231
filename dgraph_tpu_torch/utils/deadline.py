"""End-to-end request deadlines (the request-lifeline contract).

Copy of dgraph_tpu/utils/deadline.py for the PyTorch port.

Reference semantics: every gRPC call in the reference carries a
context.Context deadline — ProcessTaskOverNetwork, Zero oracle calls, and
the applied-watermark waits all give up when the caller's budget runs out
(x/x.go timeouts, worker/task.go ctx plumbing). Python has no ambient
context, so the budget rides a contextvar in-process and a gRPC invocation
metadata key (`WIRE_KEY`, milliseconds remaining) across process
boundaries — exactly like obs/otrace span propagation.

Contract: a request that exceeds its budget returns a typed
DeadlineExceeded (or the gRPC DEADLINE_EXCEEDED status over the wire),
never a hang. Every wait point — dispatch-gate acquisition, hedged-replica
grace, RPC timeouts, applied-watermark waits, Zero failover backoff —
clamps to the remaining budget via `clamp()`/`check()`.

Overload shedding raises the sibling ResourceExhausted: the request was
rejected *before* consuming device time because its remaining budget could
not cover the expected step (query/qcache.DispatchGate).
"""

from __future__ import annotations

import contextvars
import time


class DeadlineExceeded(Exception):
    """The request's end-to-end budget ran out. Typed — callers must not
    blind-retry it (the budget is gone) and the retry layer never does."""

    code = "DEADLINE_EXCEEDED"


class ResourceExhausted(Exception):
    """Shed under overload: the remaining budget cannot cover the expected
    work (or the queue is full), so the request is rejected up front
    instead of wasting device time it cannot finish in."""

    code = "RESOURCE_EXHAUSTED"


# gRPC invocation metadata key: remaining budget in ms at send time (keys
# must be lowercase ASCII; -bin suffix is reserved for binary values)
WIRE_KEY = "dgt-deadline-ms"


class Deadline:
    """One request's absolute expiry on the monotonic clock."""

    __slots__ = ("expires", "budget_s")

    def __init__(self, budget_s: float) -> None:
        self.budget_s = float(budget_s)
        self.expires = time.monotonic() + self.budget_s

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(float(ms) / 1000.0)

    def remaining(self) -> float:
        """Seconds left (may be <= 0)."""
        return self.expires - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "") -> None:
        rem = self.remaining()
        if rem <= 0:
            raise DeadlineExceeded(
                f"deadline exceeded{f' at {what}' if what else ''} "
                f"(budget {self.budget_s * 1000:.0f}ms, "
                f"over by {-rem * 1000:.0f}ms)")

    def clamp(self, timeout: float | None) -> float:
        """min(timeout, remaining), floored at 0 — the per-wait timeout a
        budgeted request may spend at one wait point."""
        rem = max(self.remaining(), 0.0)
        if timeout is None:
            return rem
        return min(float(timeout), rem)


_current: contextvars.ContextVar[Deadline | None] = \
    contextvars.ContextVar("dgt_deadline", default=None)


def current() -> Deadline | None:
    return _current.get()


def remaining() -> float | None:
    """Seconds left on the active deadline, or None when unbudgeted."""
    dl = _current.get()
    return None if dl is None else dl.remaining()


def clamp(timeout: float | None) -> float | None:
    """Clamp a wait to the active budget; identity when unbudgeted."""
    dl = _current.get()
    return timeout if dl is None else dl.clamp(timeout)


def check(what: str = "") -> None:
    """Raise DeadlineExceeded when the active budget has run out; no-op
    when unbudgeted. Cheap enough for per-task seams."""
    dl = _current.get()
    if dl is not None:
        dl.check(what)


class _NullScope:
    """Shared no-op scope for unbudgeted requests (stateless, reusable).
    Keeps the disabled path at one isinstance check + two no-op calls."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *_exc):
        return False


_NULL_SCOPE = _NullScope()


class _Scope:
    """Class-based scope (a contextlib generator costs ~5µs per
    enter/exit — measurable against a ~200µs cached query; this is
    ~1µs)."""

    __slots__ = ("dl", "_tok")

    def __init__(self, dl: Deadline) -> None:
        self.dl = dl

    def __enter__(self) -> Deadline:
        dl = self.dl
        outer = _current.get()
        if outer is not None and outer.expires < dl.expires:
            dl = self.dl = outer
        self._tok = _current.set(dl)
        return dl

    def __exit__(self, *_exc):
        _current.reset(self._tok)
        return False


def scope(budget: "Deadline | float | int | None"):
    """Install a deadline for the dynamic extent of a request. Accepts a
    Deadline, a budget in SECONDS, or None (no-op). A nested scope never
    EXTENDS an enclosing deadline — the tighter bound wins, so a callee's
    default budget cannot outlive its caller's."""
    if budget is None:
        return _NULL_SCOPE
    return _Scope(budget if isinstance(budget, Deadline)
                  else Deadline(float(budget)))


class _AdoptScope:
    __slots__ = ("dl", "_tok")

    def __init__(self, dl: Deadline | None) -> None:
        self.dl = dl

    def __enter__(self) -> Deadline | None:
        self._tok = _current.set(self.dl)
        return self.dl

    def __exit__(self, *_exc):
        _current.reset(self._tok)
        return False


def adopt(dl: "Deadline | None"):
    """Install EXACTLY `dl` for the dynamic extent — None clears the
    ambient deadline; unlike scope(), an enclosing tighter deadline does
    NOT win. For an agent executing pooled work on behalf of SEVERAL
    callers (the batched-dispatch leader, query/batch.py): the pool's
    budget is the most permissive member's, not whichever member happened
    to lead, so one tight-budget leader cannot shed work that other
    members had ample time for."""
    return _AdoptScope(dl)


# -- wire propagation (gRPC invocation metadata) ----------------------------

def to_metadata() -> tuple | None:
    """(WIRE_KEY, remaining-ms) for the active deadline, or None. Send-side
    clamping: the callee receives what is left NOW, so queueing on the
    caller's side has already been charged."""
    dl = _current.get()
    if dl is None:
        return None
    return (WIRE_KEY, f"{max(dl.remaining(), 0.0) * 1000.0:.1f}")


def from_metadata(md) -> Deadline | None:
    """Parse a propagated deadline out of invocation metadata pairs."""
    for k, v in md or ():
        if k == WIRE_KEY:
            try:
                return Deadline.after_ms(float(v))
            except (TypeError, ValueError):
                return None
    return None
