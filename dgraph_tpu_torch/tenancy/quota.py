"""Per-tenant cost-metered quotas: token buckets in cost-ledger units.

Copy of dgraph_tpu/tenancy/quota.py for the PyTorch port.

Each tenant carries up to three buckets — device-ms, traversed edges,
and transfer bytes per second — refilled continuously with a burst
allowance of `burst_s` seconds of rate. Costs are only known AFTER a
request runs (the CostLedger record), so buckets debit post-execution
and may go into debt (floored at one extra burst window); admission at
the API edge then sheds the tenant typed — the typed ResourceExhausted
shape, never a queue slot — until refill clears the debt. That is the
standard cost-metered quota discipline: a burst is served, the debt is
repaid in shed time.

The registry also owns the per-tenant attribution surface: exact float
totals for /debug/metrics and the dgraph_tenant_{device_ms,edges,bytes,
shed}_total{tenant=} labeled gauges (integer floors of the floats).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from dgraph_tpu_torch.utils.deadline import ResourceExhausted

# spec key applying to any tenant without its own entry
DEFAULT_SPEC_KEY = "*"


@dataclass
class TenantSpec:
    """One tenant's QoS contract. None = unlimited for that unit."""

    name: str
    weight: float = 1.0                  # fair-share weight (sched.py)
    device_ms_per_s: float | None = None
    edges_per_s: float | None = None
    bytes_per_s: float | None = None
    burst_s: float = 5.0                 # burst allowance, seconds of rate
    max_subs: int | None = None          # standing live subscriptions
    sub_queue_max: int | None = None     # per-subscription notify bound

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "TenantSpec":
        known = {"weight", "device_ms_per_s", "edges_per_s", "bytes_per_s",
                 "burst_s", "max_subs", "sub_queue_max"}
        bad = set(d) - known
        if bad:
            raise ValueError(
                f"tenant {name!r}: unknown quota keys {sorted(bad)}")
        kw = {}
        for k in known & set(d):
            v = d[k]
            kw[k] = None if v is None else (
                int(v) if k in ("max_subs", "sub_queue_max") else float(v))
        return cls(name=name, **kw)

    def to_dict(self) -> dict:
        return {"weight": self.weight,
                "device_ms_per_s": self.device_ms_per_s,
                "edges_per_s": self.edges_per_s,
                "bytes_per_s": self.bytes_per_s,
                "burst_s": self.burst_s,
                "max_subs": self.max_subs,
                "sub_queue_max": self.sub_queue_max}


@dataclass
class _Bucket:
    """Continuous-refill token bucket with bounded debt."""

    rate: float                  # units per second
    burst: float                 # capacity (units)
    level: float = 0.0
    last: float = field(default_factory=time.monotonic)

    def __post_init__(self) -> None:
        self.level = self.burst

    def _refill(self, now: float) -> None:
        self.level = min(self.burst,
                         self.level + (now - self.last) * self.rate)
        self.last = now

    def debit(self, cost: float, now: float) -> None:
        self._refill(now)
        # debt floored at one extra burst window: a single runaway query
        # costs at most 2*burst_s of shed time, not unbounded lockout
        self.level = max(-self.burst, self.level - cost)

    def ok(self, now: float) -> bool:
        self._refill(now)
        return self.level > 0.0


class TenantRegistry:
    """Tenant table: specs (hot-reloadable), quota buckets, and the exact
    per-tenant cost accumulators behind the labeled gauge series."""

    _UNITS = ("device_ms", "edges", "bytes")
    _GAUGES = {"device_ms": "dgraph_tenant_device_ms_total",
               "edges": "dgraph_tenant_edges_total",
               "bytes": "dgraph_tenant_bytes_total"}

    def __init__(self, metrics=None) -> None:
        self.metrics = metrics
        self._lock = threading.Lock()
        self._specs: dict[str, TenantSpec] = {}
        self._buckets: dict[str, dict[str, _Bucket]] = {}
        self._totals: dict[str, dict[str, float]] = {}
        self._sheds: dict[str, int] = {}

    # -- configuration (serve flag + POST /admin/tenant hot reload) -----------

    def configure(self, cfg: dict, replace: bool = False) -> dict:
        """Install/merge tenant specs from {"tenants": {name: {...}}} (or
        the bare name->spec map). Returns the resulting table. Reconfig
        resets only the reconfigured tenants' buckets — a hot reload must
        not hand every tenant a fresh burst."""
        tenants = cfg.get("tenants", cfg)
        if not isinstance(tenants, dict):
            raise ValueError("tenants config must be a JSON object")
        specs = {}
        for name, d in tenants.items():
            if name != DEFAULT_SPEC_KEY:
                from dgraph_tpu_torch import tenancy

                tenancy.validate(name)
            specs[name] = TenantSpec.from_dict(name, dict(d or {}))
        with self._lock:
            if replace:
                self._specs = specs
                self._buckets.clear()
            else:
                self._specs.update(specs)
                for name in specs:
                    self._buckets.pop(name, None)
        return self.table()

    @property
    def configured(self) -> bool:
        return bool(self._specs)

    def spec(self, tenant: str) -> TenantSpec | None:
        with self._lock:
            return self._specs.get(tenant) or \
                self._specs.get(DEFAULT_SPEC_KEY)

    def weight(self, tenant: str) -> float:
        sp = self.spec(tenant)
        return sp.weight if sp is not None and sp.weight > 0 else 1.0

    def window_share(self, tenant: str, slots: int) -> int:
        """Weight-proportional share of `slots` group-window slots (floor
        1): the WriteBatcher's per-tenant cap, so one heavy writer cannot
        fill the shared commit window."""
        with self._lock:
            total = sum(max(sp.weight, 0.0)
                        for name, sp in self._specs.items()
                        if name != DEFAULT_SPEC_KEY)
        w = self.weight(tenant)
        return max(1, int(slots * w / max(total, w, 1.0)))

    # -- quota enforcement ----------------------------------------------------

    def _buckets_for(self, tenant: str, sp: TenantSpec) -> dict:
        b = self._buckets.get(tenant)
        if b is None:
            b = {}
            for unit, rate in (("device_ms", sp.device_ms_per_s),
                               ("edges", sp.edges_per_s),
                               ("bytes", sp.bytes_per_s)):
                if rate is not None and rate > 0:
                    b[unit] = _Bucket(rate=rate,
                                      burst=rate * max(sp.burst_s, 0.001))
            self._buckets[tenant] = b
        return b

    def note_shed(self, tenant: str) -> None:
        """Book one per-tenant shed (quota debt, subscription cap, ...)
        into the shed counter + the labeled tenant series."""
        with self._lock:
            self._sheds[tenant] = self._sheds.get(tenant, 0) + 1
        if self.metrics is not None:
            self.metrics.counter("dgraph_shed_total").inc()
            self.metrics.keyed("dgraph_tenant_shed_total",
                               labels=("tenant",)).inc(tenant or "default")

    def admit(self, tenant: str) -> None:
        """Shed typed when any of the tenant's buckets is in debt. Never
        queues — over-quota work is rejected while it is still cheap."""
        sp = self.spec(tenant)
        if sp is None:
            return
        now = time.monotonic()
        with self._lock:
            for unit, b in self._buckets_for(tenant, sp).items():
                if not b.ok(now):
                    deficit = -b.level
                    break
            else:
                return
        self.note_shed(tenant)
        raise ResourceExhausted(
            f"tenant {tenant or 'default'!r} over {unit} quota "
            f"({deficit:.0f} {unit} in debt; refills at "
            f"{getattr(sp, unit + '_per_s', 0)}/s)")

    def debit(self, tenant: str, device_ms: float = 0.0,
              edges: float = 0.0, bytes_: float = 0.0) -> None:
        """Attribute one request's ledger totals: debit quota buckets and
        advance the exact accumulators + labeled gauges."""
        sp = self.spec(tenant)
        now = time.monotonic()
        vals = {"device_ms": float(device_ms), "edges": float(edges),
                "bytes": float(bytes_)}
        with self._lock:
            if sp is not None:
                for unit, b in self._buckets_for(tenant, sp).items():
                    b.debit(vals[unit], now)
            tot = self._totals.setdefault(
                tenant, dict.fromkeys(self._UNITS, 0.0))
            for unit in self._UNITS:
                tot[unit] += vals[unit]
            snap = dict(tot)
        if self.metrics is not None:
            key = tenant or "default"
            self.metrics.keyed("dgraph_tenant_device_ms_total",
                               labels=("tenant",)).set(
                                   key, int(snap["device_ms"]))
            self.metrics.keyed("dgraph_tenant_edges_total",
                               labels=("tenant",)).set(
                                   key, int(snap["edges"]))
            self.metrics.keyed("dgraph_tenant_bytes_total",
                               labels=("tenant",)).set(
                                   key, int(snap["bytes"]))

    # -- live-query caps ------------------------------------------------------

    def max_subs(self, tenant: str) -> int | None:
        sp = self.spec(tenant)
        return sp.max_subs if sp is not None else None

    def sub_queue_max(self, tenant: str) -> int | None:
        sp = self.spec(tenant)
        return sp.sub_queue_max if sp is not None else None

    # -- inspection (Zero state / /admin/tenant / /debug/metrics) -------------

    def table(self) -> dict:
        with self._lock:
            now = time.monotonic()
            out = {}
            names = set(self._specs) | set(self._totals)
            for name in sorted(names):
                sp = self._specs.get(name)
                row = {"spec": sp.to_dict() if sp is not None else None,
                       "totals": dict(self._totals.get(
                           name, dict.fromkeys(self._UNITS, 0.0))),
                       "sheds": self._sheds.get(name, 0)}
                b = self._buckets.get(name)
                if b:
                    row["buckets"] = {
                        u: {"level": round(bk.level, 3),
                            "rate": bk.rate, "burst": bk.burst,
                            "ok": bk.ok(now)}
                        for u, bk in b.items()}
                out[name] = row
            return out
