"""Namespace views: tenant-scoped predicates at the snapshot/schema seam.

Copy of dgraph_tpu/tenancy/namespace.py for the PyTorch port.

A tenant's predicate "name" lives in storage as "<tenant>/name" — a
distinct attr with its own posting lists, PredData/CSR identity, journal
rows, and schema entry. Queries execute against a NamespacedSnapshot that
translates attr names both ways, so the executor, planner, caches, and
batcher all run unmodified on the tenant's unprefixed vocabulary while
reading only the tenant's tablets. The translation is name-level only:
PredData objects pass through untouched, so qcache per-predicate tokens
(object identity) and DeviceBatcher same-CSR-object compatibility keys
stay exactly as sound as in the single-tenant server.

Cross-namespace references are structurally impossible — any attr
containing the separator raises the typed NamespaceError before touching
storage.
"""

from __future__ import annotations

from dataclasses import replace

SEP = "/"


class NamespaceError(ValueError):
    """Typed cross-namespace access / invalid tenant reference."""


def _check(attr: str) -> str:
    if SEP in attr:
        raise NamespaceError(
            f"cross-namespace predicate reference {attr!r}: the "
            f"namespace separator {SEP!r} is reserved")
    return attr


def prefix(tenant: str, attr: str) -> str:
    """Tenant attr -> storage attr. Handles the reverse marker; '*' (the
    wildcard delete / expand-all token) passes through — callers decide
    its scope."""
    if not tenant or not attr or attr == "*":
        return attr
    if attr.startswith("~"):
        return "~" + tenant + SEP + _check(attr[1:])
    return tenant + SEP + _check(attr)


def strip(tenant: str, attr: str) -> str:
    """Storage attr -> tenant attr (inverse of prefix; attr must belong)."""
    if not tenant:
        return attr
    if attr.startswith("~"):
        return "~" + strip(tenant, attr[1:])
    pre = tenant + SEP
    return attr[len(pre):] if attr.startswith(pre) else attr


def owns(tenant: str, attr: str) -> bool:
    a = attr[1:] if attr.startswith("~") else attr
    if not tenant:
        return SEP not in a
    return a.startswith(tenant + SEP)


def split(attr: str) -> tuple[str, str]:
    """Storage attr -> (tenant, bare attr); default-namespace attrs map to
    ("", attr). The per-tenant journal/overlay accounting groups on this."""
    a = attr[1:] if attr.startswith("~") else attr
    if SEP not in a:
        return "", attr
    tenant, _, bare = a.partition(SEP)
    return tenant, ("~" + bare if attr.startswith("~") else bare)


def prefix_attrs(tenant: str, attrs) -> frozenset:
    return frozenset(prefix(tenant, a) for a in attrs)


class NamespacedPreds:
    """Read-only dict-protocol view over a snapshot's preds map (plain
    dict or LazyPreds), translating tenant attrs <-> storage attrs.
    Iteration surfaces ONLY the tenant's predicates, stripped — so
    expand(_all_), known-uid validation, and planner stats see exactly
    the tenant's universe. Lazy-fold views (is_pending / resolve /
    materialize_all / pending hints) delegate per-attr so the demand-
    driven fold seam works identically through the view."""

    __slots__ = ("_base", "_tenant", "_pre")

    def __init__(self, base, tenant: str) -> None:
        self._base = base
        self._tenant = tenant
        self._pre = tenant + SEP

    # -- name translation -----------------------------------------------------

    def _s(self, attr: str) -> str:          # tenant -> storage
        return prefix(self._tenant, attr)

    def _mine(self, attr: str) -> bool:
        return attr.startswith(self._pre)

    def _keys(self) -> list[str]:
        n = len(self._pre)
        return sorted(a[n:] for a in self._base.keys() if self._mine(a))

    # -- mapping protocol -----------------------------------------------------

    def get(self, attr, default=None):
        return self._base.get(self._s(attr), default)

    def __getitem__(self, attr):
        try:
            return self._base[self._s(attr)]
        except KeyError:
            raise KeyError(attr) from None

    def __contains__(self, attr) -> bool:
        return self._s(attr) in self._base

    def __len__(self) -> int:
        return len(self._keys())

    def __iter__(self):
        return iter(self._keys())

    def keys(self):
        return self._keys()

    def values(self):
        return [self._base[self._s(a)] for a in self._keys()]

    def items(self):
        return [(a, self._base[self._s(a)]) for a in self._keys()]

    # -- lazy-aware views (planner / stats / residency / prefetch) ------------

    def folded_get(self, attr, default=None):
        fg = getattr(self._base, "folded_get", None)
        if fg is None:
            return self._base.get(self._s(attr), default)
        return fg(self._s(attr), default)

    def folded_items(self):
        fi = getattr(self._base, "folded_items", None)
        items = fi() if fi is not None else self._base.items()
        n = len(self._pre)
        return [(a[n:], pd) for a, pd in items if self._mine(a)]

    def folded_values(self):
        return [pd for _a, pd in self.folded_items()]

    def pending_attrs(self) -> list[str]:
        pa = getattr(self._base, "pending_attrs", None)
        if pa is None:
            return []
        n = len(self._pre)
        return [a[n:] for a in pa() if self._mine(a)]

    def is_pending(self, attr: str) -> bool:
        ip = getattr(self._base, "is_pending", None)
        return bool(ip is not None and ip(self._s(attr)))

    def pending_card(self, attr: str) -> int:
        pc = getattr(self._base, "pending_card", None)
        return int(pc(self._s(attr))) if pc is not None else 0

    def resolve(self, attr: str, trigger: str = "lazy"):
        rs = getattr(self._base, "resolve", None)
        if rs is None:
            return self._base.get(self._s(attr))
        return rs(self._s(attr), trigger)

    def materialize_all(self, trigger: str = "eager") -> int:
        # fold only THIS tenant's pending tablets, not the whole world
        n = 0
        for a in self.pending_attrs():
            if self.resolve(a, trigger) is not None:
                n += 1
        return n

    @property
    def hint_fn(self):
        fn = getattr(self._base, "hint_fn", None)
        if fn is None:
            return None
        return lambda attr: fn(self._s(attr))


class NamespacedSnapshot:
    """Tenant view of one GraphSnapshot. PredData objects pass through by
    identity (qcache tokens stay per-storage-tablet); only names
    translate. The cache token derives from the base snapshot's token
    plus the tenant, so every view of one base snapshot — this request's
    or the next's — keys caches identically, and a new base snapshot
    (commit/alter/drop) rotates every tenant's keys at once."""

    # _known_uids_cache: the engine's known-uid set for uid(...) roots,
    # cached on the view like on a GraphSnapshot (the JAX view has no slot
    # for it, so a tenant's uid(...) root raises AttributeError there)
    __slots__ = ("_base", "tenant", "preds", "metrics", "_known_uids_cache")

    def __init__(self, base, tenant: str) -> None:
        self._base = base
        self.tenant = tenant
        self.preds = NamespacedPreds(base.preds, tenant)
        self.metrics = getattr(base, "metrics", None)

    @property
    def base(self):
        return self._base

    @property
    def read_ts(self) -> int:
        return self._base.read_ts

    @property
    def device(self):
        return self._base.device

    @property
    def cache_token(self):
        from dgraph_tpu_torch.query import qcache

        return ("ns", self.tenant, qcache.snapshot_token(self._base))

    def pred(self, attr: str):
        return self.preds.get(attr)


class NamespacedSchema:
    """Tenant view of the store's SchemaState: lookups prefix, listings
    filter + strip. Returned SchemaEntry objects are copies carrying the
    tenant's unprefixed predicate name (schema{} responses and error
    messages must never leak the storage prefix)."""

    __slots__ = ("_base", "_tenant", "_pre")

    def __init__(self, base, tenant: str) -> None:
        self._base = base
        self._tenant = tenant
        self._pre = tenant + SEP

    def _s(self, pred: str) -> str:
        return prefix(self._tenant, pred)

    def _out(self, e):
        if e is None:
            return None
        return replace(e, predicate=strip(self._tenant, e.predicate),
                       tokenizers=list(e.tokenizers))

    def set(self, e) -> None:
        self._base.set(replace(e, predicate=self._s(e.predicate),
                               tokenizers=list(e.tokenizers)))

    def get(self, pred: str):
        return self._out(self._base.get(self._s(pred)))

    def ensure(self, pred: str, tid, is_list: bool = False):
        return self._out(self._base.ensure(self._s(pred), tid,
                                           is_list=is_list))

    def delete(self, pred: str) -> None:
        self._base.delete(self._s(pred))

    def predicates(self) -> list[str]:
        n = len(self._pre)
        return sorted(p[n:] for p in self._base.predicates()
                      if p.startswith(self._pre))

    def entries(self) -> list:
        return [self.get(p) for p in self.predicates()]

    def type_of(self, pred: str):
        return self._base.type_of(self._s(pred))

    def is_indexed(self, pred: str) -> bool:
        return self._base.is_indexed(self._s(pred))

    def is_reversed(self, pred: str) -> bool:
        return self._base.is_reversed(self._s(pred))

    def has_count(self, pred: str) -> bool:
        return self._base.has_count(self._s(pred))

    def is_list(self, pred: str) -> bool:
        return self._base.is_list(self._s(pred))

    def tokenizer_names(self, pred: str) -> list[str]:
        return self._base.tokenizer_names(self._s(pred))

    def vector_spec(self, pred: str):
        return self._base.vector_spec(self._s(pred))

    def to_text(self) -> str:
        return "\n".join(str(e) for e in self.entries())
