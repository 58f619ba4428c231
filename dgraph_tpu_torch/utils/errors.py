"""Typed error taxonomy for RPC/dispatch boundaries.

Copy of dgraph_tpu/utils/errors.py for the PyTorch port.

The lifeline layer made deadline/overload failures typed
(utils/deadline.DeadlineExceeded / ResourceExhausted, each carrying a
`code` that maps onto a gRPC status); the remaining seam failures were
still bare `RuntimeError("...")` strings — un-matchable by retry policy,
breaker classification, or HTTP status mapping. These classes close that
gap. They deliberately SUBCLASS RuntimeError: every existing
`except RuntimeError` catch keeps working, the analyzer's
rpc-error-taxonomy rule is satisfied, and new code can match on type or
on `code`.

Taxonomy (mirrors the reference's gRPC status usage, SURVEY §API):

  Unavailable        nobody can serve this right now (no live leader, no
                     connection to the owning group, quorum lost, listener
                     bind failure) — retriable against another replica.
  FailedPrecondition the request is well-formed but the system state
                     refuses it (tablet mid-move, standby zero asked to
                     lead) — retry AFTER refreshing routing/leadership.

DeadlineExceeded / ResourceExhausted stay in utils/deadline (they are
budget semantics, not wire semantics); FaultError stays in utils/faults
(transport-shaped by design).
"""

from __future__ import annotations


class WireError(RuntimeError):
    """Base for typed seam failures; `code` is the gRPC status name."""

    code = "UNKNOWN"


class Unavailable(WireError):
    """No live peer can serve the request (dead leader, unreachable
    group, lost quorum, un-bindable listener)."""

    code = "UNAVAILABLE"


class FailedPrecondition(WireError):
    """System state refuses the request until the caller refreshes its
    view (predicate mid-move fence, non-leader zero)."""

    code = "FAILED_PRECONDITION"
