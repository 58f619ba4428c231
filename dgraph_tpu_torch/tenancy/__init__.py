"""Multi-tenant QoS: namespaces, cost-metered quotas, and
weighted-fair device scheduling.

Copy of dgraph_tpu/tenancy/__init__.py for the PyTorch port.

Reference semantics: the reference's namespace seam (edgraph/ access
checks, SURVEY §API) scopes every predicate to the caller's namespace by
prefixing attr names at the server boundary — the tenant's own DQL never
sees the prefix. This port does the same at the snapshot/schema seam
(namespace.py): tenant attrs are DISTINCT storage attrs
("<tenant>/<attr>"), so MVCC, the delta journal, qcache per-predicate
tokens, and DeviceBatcher same-CSR batching are all tenant-isolated by
construction, and the default tenant ("") takes no wrapper at all —
byte-identical to the pre-tenancy server.

Quotas (quota.py) meter in cost-ledger units — device-ms, traversed
edges, transfer bytes per refill window with a burst allowance — debited
from each request's CostLedger record and enforced at the API edge via
the shed path: an over-quota tenant gets typed ResourceExhausted
before any device work, never a queue slot.

Fair scheduling (sched.py) orders contended DispatchGate admissions by
per-tenant weighted virtual time fed by the gate's measured device-ms,
so one tenant at 100x fair share cannot monopolize the device.

The tenant rides a contextvar: the HTTP handler (X-Dgraph-Tenant
header) and the gRPC worker (dgt-tenant metadata) install it at the
edge; Node.query/mutate/alter/subscribe read it.
"""

from __future__ import annotations

import contextvars
import re
from contextlib import contextmanager

from dgraph_tpu_torch.tenancy.namespace import (SEP, NamespacedPreds,
                                          NamespacedSchema,
                                          NamespacedSnapshot,
                                          NamespaceError, prefix,
                                          prefix_attrs, split, strip)
from dgraph_tpu_torch.tenancy.quota import TenantRegistry, TenantSpec
from dgraph_tpu_torch.tenancy.sched import FairScheduler

__all__ = [
    "SEP", "DEFAULT", "HTTP_HEADER", "WIRE_KEY",
    "NamespaceError", "NamespacedPreds", "NamespacedSchema",
    "NamespacedSnapshot", "prefix", "prefix_attrs", "split", "strip",
    "TenantRegistry", "TenantSpec", "FairScheduler",
    "current", "scope", "validate",
]

# the default (admin) namespace: no prefixing, no wrapping — the
# pre-tenancy single-tenant server, byte for byte
DEFAULT = ""

# request-context carriers: HTTP header at the api/http.py edge, metadata
# key on the gRPC wire (parallel/remote.py — same pattern as the cost
# ledger's dgt-cost-bin sidecar)
HTTP_HEADER = "X-Dgraph-Tenant"
WIRE_KEY = "dgt-tenant"

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")

_current: contextvars.ContextVar[str] = contextvars.ContextVar(
    "dgt-tenant", default=DEFAULT)


def validate(tenant: str) -> str:
    """Tenant names are path-safe identifiers; the namespace separator is
    structurally impossible in one, so a prefixed storage attr always
    splits unambiguously."""
    if tenant == DEFAULT:
        return tenant
    if not isinstance(tenant, str) or not _NAME_RE.match(tenant):
        raise NamespaceError(
            f"invalid tenant name {tenant!r} (want [A-Za-z0-9][A-Za-z0-9"
            f"_.-]{{0,63}})")
    return tenant


def current() -> str:
    """The requesting tenant ("" = default namespace)."""
    return _current.get()


@contextmanager
def scope(tenant: str):
    """Install the tenant for one request's dynamic extent."""
    tok = _current.set(validate(tenant))
    try:
        yield
    finally:
        _current.reset(tok)
