"""Self-driving shard placement: a Zero-resident controller that scores
tablets by live load and heals skew with moves + hot-tablet read replicas.

Port of dgraph_tpu/coord/placement.py, whole: host code only. The Node
feeds its TabletLoadBook (reads at the task seam, writes at mutate); a
wire worker feeds its own and reports it on Status. `python -m
dgraph_tpu_torch zero --rebalance_interval_s N` runs the
PlacementController over `wire_collect` and a ZeroOpsExecutor
(coord/zero_service.ZeroOps), as the JAX zero does.

The reference's Zero rebalances by SIZE alone (dgraph/cmd/zero/tablet.go:
60-74); under the Zipfian traffic the north star assumes, one hot
predicate pins one group while the others idle and sizes say nothing is
wrong. This controller closes the loop with the signals the system
already produces:

  inputs   per-tablet load reports — reads / writes / result bytes /
           serve seconds, counted at each worker's serve seam and shipped
           on the Status probe (tablet_load_json) — plus the same
           tablet_sizes the size-based rebalancer used.
  score    rate x log2(size): work per second weighted by how expensive
           the tablet is to serve (a hot 1 GB tablet outranks a hot 1 KB
           one; a cold tablet of any size scores ~0).
  actions  (a) tablet MOVES through the existing chunked resumable move
           path, to equalize group utilization;
           (b) read-only tablet REPLICAS on other groups for
           skew-dominant read-heavy tablets — moving those only moves
           the hotspot — kept fresh by shipping the owner's O(Δ)
           journal deltas (storage/store.delta_since); the query
           router spreads reads across holders and collapses to the
           primary for anything a replica cannot prove fresh (the
           FAILED_PRECONDITION machinery).
  guards   hysteresis (imbalance must persist `persist_ticks` polls),
           per-tablet cooldown, one action per tick, and a minimum
           cluster rate below which only demotions run — the controller
           must never thrash.

The decision core (`plan_action`) is pure: sizes + rates + maps in,
proposal out — unit-testable with no cluster at all. The controller
wraps it with collection, hysteresis state, the decision log, metrics,
and an executor adapter (wire mode: coord/zero_service.ZeroOps; embedded
mode: coord/cluster.Cluster).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass

from ..utils import faults, locks

WRITE_WEIGHT = 2.0     # a write costs ~2 reads (apply + invalidation)


@dataclass
class TabletRate:
    """One tablet's measured load on one group, per second."""

    reads: float = 0.0
    writes: float = 0.0
    bytes: float = 0.0
    serve_s: float = 0.0

    def rate(self) -> float:
        return self.reads + WRITE_WEIGHT * self.writes

    def read_heavy(self, factor: float) -> bool:
        return self.reads >= factor * max(self.writes, 1e-9)


@dataclass
class PlacementConfig:
    threshold: float = 0.35      # act when utilization spread exceeds this
    persist_ticks: int = 2       # imbalance must hold this many polls
    cooldown_s: float = 30.0     # per-tablet quiet period after an action
    max_replicas: int = 2        # read-replica holders per tablet
    read_dominant: float = 3.0   # reads >= 3x writes => replica-eligible
    skew_frac: float = 0.5       # tablet >= 50% of its group => skew-dominant
    min_rate: float = 0.5        # below this cluster req/s, only demotions
    idle_drop_rate: float = 0.05  # tablet req/s under which replicas demote


@dataclass
class Action:
    kind: str                    # "move" | "add_replica" | "drop_replica"
    attr: str
    src: int                     # source / owner group
    dst: int                     # destination / holder group
    reason: str
    spread: float = 0.0


def tablet_score(size_bytes: float, rate: float) -> float:
    """size x measured load: work per second, weighted by how expensive
    the tablet is to serve. Pure rate would move a hot 1 KB tablet before
    a warm 1 GB one; pure size is the reference's blind spot."""
    return rate * max(1.0, math.log2(2.0 + max(float(size_bytes), 0.0)))


def utilization(sizes: dict[int, dict[str, float]],
                rates: dict[int, dict[str, TabletRate]]) -> tuple[
                    float, dict[int, float], dict[int, dict[str, float]]]:
    """(spread, per-group utilization, per-group per-tablet scores).
    Spread = (max - min) / max over group utilizations; 0 when idle."""
    groups = set(sizes) | set(rates)
    # a tablet's size is a property of the TABLET, not of each report:
    # replica holders serve the same data, and a holder whose (TTL-cached)
    # size report hasn't caught up yet must not score the same traffic
    # 14x lower than the owner
    attr_size: dict[str, float] = {}
    for g in groups:
        for attr, sz in sizes.get(g, {}).items():
            attr_size[attr] = max(attr_size.get(attr, 0.0), float(sz))
    per_tablet: dict[int, dict[str, float]] = {}
    per_group: dict[int, float] = {}
    for g in groups:
        grates = rates.get(g, {})
        scores = {attr: tablet_score(attr_size.get(attr, 0.0), tr.rate())
                  for attr, tr in grates.items()}
        per_tablet[g] = scores
        per_group[g] = sum(scores.values())
    if not per_group:
        return 0.0, {}, {}
    hi = max(per_group.values())
    lo = min(per_group.values())
    spread = (hi - lo) / hi if hi > 0 else 0.0
    return spread, per_group, per_tablet


def plan_action(sizes: dict[int, dict[str, float]],
                rates: dict[int, dict[str, TabletRate]],
                tablets: dict[str, int],
                replicas: dict[str, dict[int, int]],
                cfg: PlacementConfig,
                blocked: set[str] = frozenset()) -> tuple[
                    Action | None, dict]:
    """The pure decision: one proposed action (or None) + diagnostics.

    Healing order for an over-threshold spread, hottest group vs coldest:
      1. the hottest tablet is skew-DOMINANT and read-heavy -> replicate
         it onto the coldest group (moving it would only move the pin);
      2. otherwise move the largest-scoring tablet that fits half the
         utilization gap (the anti-ping-pong rule, load-weighted);
      3. a read-heavy hot tablet too big for the gap -> replicate anyway.
    Below threshold (or idle): demote replicas whose tablet went cold.
    """
    spread, per_group, per_tablet = utilization(sizes, rates)
    diag = {"spread": round(spread, 4),
            "utilization": {g: round(v, 3) for g, v in per_group.items()}}
    if len(per_group) < 2:
        return None, diag

    # tablet totals across every serving group (owner + replica holders)
    tablet_rate: dict[str, float] = {}
    for g, grates in rates.items():
        for attr, tr in grates.items():
            tablet_rate[attr] = tablet_rate.get(attr, 0.0) + tr.rate()
    total_rate = sum(tablet_rate.values())
    diag["total_rate"] = round(total_rate, 3)

    def demotion() -> Action | None:
        for attr in sorted(replicas):
            holders = replicas[attr]
            if not holders or attr in blocked:
                continue
            if tablet_rate.get(attr, 0.0) < cfg.idle_drop_rate:
                # relieve the busiest holder first
                dst = max(holders, key=lambda g: per_group.get(g, 0.0))
                return Action("drop_replica", attr, tablets.get(attr, -1),
                              dst, reason="tablet went cold", spread=spread)
        return None

    if total_rate < cfg.min_rate or spread <= cfg.threshold:
        return demotion(), diag

    hot = max(per_group, key=lambda g: per_group[g])
    cold = min(per_group, key=lambda g: per_group[g])
    if hot == cold:
        return None, diag
    gap = (per_group[hot] - per_group[cold]) / 2.0
    hot_tablets = sorted(per_tablet.get(hot, {}).items(),
                         key=lambda kv: -kv[1])
    hot_tablets = [(a, s) for a, s in hot_tablets
                   if a not in blocked and s > 0]
    if not hot_tablets:
        return None, diag
    top_attr, top_score = hot_tablets[0]
    top_tr = rates.get(hot, {}).get(top_attr, TabletRate())

    def replica_ok(attr: str) -> bool:
        h = replicas.get(attr, {})
        return (len(h) < cfg.max_replicas and cold not in h
                and tablets.get(attr) != cold)

    # the top tablet serving FROM a replica holder has no move story —
    # only owners move; holders shed load by demotion elsewhere
    top_owned_here = tablets.get(top_attr) == hot

    if (top_owned_here and top_score >= cfg.skew_frac * per_group[hot]
            and top_tr.read_heavy(cfg.read_dominant)
            and replica_ok(top_attr)):
        return Action("add_replica", top_attr, hot, cold,
                      reason=f"skew-dominant read-heavy tablet "
                             f"({top_score:.1f} of {per_group[hot]:.1f})",
                      spread=spread), diag
    for attr, sc in hot_tablets:
        if sc <= gap and tablets.get(attr) == hot:
            return Action("move", attr, hot, cold,
                          reason=f"fits half the gap "
                                 f"({sc:.1f} <= {gap:.1f})",
                          spread=spread), diag
    if (top_owned_here and top_tr.read_heavy(cfg.read_dominant)
            and replica_ok(top_attr)):
        return Action("add_replica", top_attr, hot, cold,
                      reason="hot tablet exceeds the move gap; "
                             "read-heavy -> replicate",
                      spread=spread), diag
    return None, diag


def diff_rates(prev: dict, cur: dict, dt: float) -> dict[str, TabletRate]:
    """Per-second rates from two cumulative {attr: {"r","w","b","d"}}
    polls. A counter that went backwards (worker restart) restarts from
    its current value instead of producing a negative rate."""
    out: dict[str, TabletRate] = {}
    dt = max(dt, 1e-6)
    for attr, c in cur.items():
        p = prev.get(attr, {})

        def d(k: str) -> float:
            dv = float(c.get(k, 0.0)) - float(p.get(k, 0.0))
            return (dv if dv >= 0 else float(c.get(k, 0.0))) / dt
        out[attr] = TabletRate(reads=d("r"), writes=d("w"),
                               bytes=d("b"), serve_s=d("d"))
    return out


class TabletLoadBook:
    """Cumulative per-tablet load counters with a labeled-gauge mirror:
    dgraph_tablet_load{pred,group,stat} on /metrics, the same {attr:
    {"r","w","b","d"}} snapshot shape workers ship on Status — so the
    controller's inputs are inspectable independently of its decisions."""

    def __init__(self, metrics=None, group: int = 0) -> None:
        self._lock = locks.Lock("placement.TabletLoadBook._lock")
        self._rows: dict[str, list[float]] = {}
        self.group = int(group)
        self._gauge = (metrics.keyed("dgraph_tablet_load",
                                     labels=("pred", "group", "stat"))
                       if metrics is not None else None)

    def _bump(self, attr: str, i: int, v: float) -> None:
        with self._lock:
            row = self._rows.get(attr)
            if row is None:
                row = self._rows[attr] = [0.0, 0.0, 0.0, 0.0]
            row[i] += v
            if self._gauge is not None:
                stat = ("reads", "writes", "bytes", "serve_ms")[i]
                scale = 1000.0 if i == 3 else 1.0
                self._gauge.set(f"{attr}|{self.group}|{stat}",
                                int(row[i] * scale))

    def record_read(self, attr: str, out_bytes: float = 0.0,
                    serve_s: float = 0.0) -> None:
        self._bump(attr, 0, 1.0)
        if out_bytes:
            self._bump(attr, 2, float(out_bytes))
        if serve_s:
            self._bump(attr, 3, float(serve_s))

    def record_write(self, attr: str, n: float = 1.0) -> None:
        self._bump(attr, 1, float(n))

    def snapshot(self) -> dict:
        with self._lock:
            return {a: {"r": r[0], "w": r[1], "b": r[2],
                        "d": round(r[3], 6)}
                    for a, r in self._rows.items()}


class PlacementController:
    """The Zero-resident control loop: poll load reports, keep replicas
    fresh, score, and heal — one guarded action per tick, every decision
    journaled.

    `collect` returns {group: (sizes {attr: bytes}, cumulative loads
    {attr: {"r","w","b","d"}})}. `executor` provides move(attr, dst),
    add_replica(attr, dst), drop_replica(attr, group) and optionally
    ship_deltas() for wire-mode freshness. `zero` is the tablet/replica
    map authority (coord/zero.Zero or a client with the same surface).
    """

    DECISION_LOG = 128

    def __init__(self, zero, collect, executor,
                 cfg: PlacementConfig | None = None,
                 metrics=None, logger=None,
                 clock=time.monotonic) -> None:
        from ..utils import metrics as metrics_mod

        self.zero = zero
        self.collect = collect
        self.executor = executor
        self.cfg = cfg or PlacementConfig()
        self.metrics = metrics if metrics is not None \
            else metrics_mod.Registry()
        self.log = logger
        self.clock = clock
        self._lock = locks.Lock("placement.PlacementController._lock")
        # journal lock is separate and tiny: GET /placement must stay
        # readable WHILE a tick streams a multi-second move under _lock —
        # the decision log matters most exactly then
        self._jlock = locks.Lock("placement.PlacementController._jlock")
        self._prev: dict[int, tuple[float, dict]] = {}  # g -> (t, cum loads)
        self._rates: dict[int, dict[str, TabletRate]] = {}
        self._streak = 0                    # consecutive over-threshold polls
        self._primed = False                # first poll only baselines
        self._last_action: dict[str, float] = {}        # attr -> clock()
        self._decisions: deque[dict] = deque(maxlen=self.DECISION_LOG)
        self._gauge = self.metrics.keyed(
            "dgraph_tablet_load", labels=("pred", "group", "stat"))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_diag: dict = {}

    # -- collection ----------------------------------------------------------

    def _poll(self) -> tuple[dict, dict]:
        """One report round: (sizes, per-second rates) per group."""
        now = self.clock()
        reports = self.collect()
        sizes: dict[int, dict[str, float]] = {}
        rates: dict[int, dict[str, TabletRate]] = {}
        for g, (gsizes, cum) in reports.items():
            sizes[g] = dict(gsizes)
            pt, prev = self._prev.get(g, (now, {}))
            rates[g] = diff_rates(prev, cum, now - pt) if prev \
                else {a: TabletRate() for a in cum}
            self._prev[g] = (now, dict(cum))
            for attr, tr in rates[g].items():
                self._gauge.set(f"{attr}|{g}|reads",
                                int(cum.get(attr, {}).get("r", 0)))
                self._gauge.set(f"{attr}|{g}|writes",
                                int(cum.get(attr, {}).get("w", 0)))
                self._gauge.set(f"{attr}|{g}|bytes",
                                int(cum.get(attr, {}).get("b", 0)))
        self._rates = rates
        return sizes, rates

    # -- the tick ------------------------------------------------------------

    def tick(self) -> Action | None:
        """One controller pass. Returns the EXECUTED action, if any."""
        m = self.metrics
        m.counter("dgraph_placement_ticks_total").inc()
        with self._lock:
            # freshness first: replicas pull the owner's journal deltas
            # before any decision reads the cluster state
            ship = getattr(self.executor, "ship_deltas", None)
            if ship is not None:
                try:
                    shipped = ship()
                    if shipped:
                        m.counter(
                            "dgraph_placement_delta_ships_total").inc(
                                shipped)
                except Exception as e:
                    m.counter("dgraph_placement_errors_total").inc()
                    self._journal({"event": "delta_ship_error",
                                   "error": str(e)})
            try:
                faults.fire("zero.rebalance_decide", m=m)
                sizes, rates = self._poll()
            except Exception as e:
                m.counter("dgraph_placement_errors_total").inc()
                self._journal({"event": "collect_error", "error": str(e)})
                return None
            if not self._primed:
                # the first poll only baselines the cumulative counters —
                # acting on an all-zero rate window would demote every
                # replica the moment a restarted controller comes up
                self._primed = True
                self._journal({"event": "baseline"})
                return None
            proposal, diag = plan_action(
                sizes, rates, self.zero.tablets(), self.zero.replicas(),
                self.cfg, blocked=set(self.zero.moving_tablets()))
            self.last_diag = diag
            # hysteresis: imbalance must persist before a heal action;
            # demotions are the healthy-state path and skip the streak
            if diag.get("spread", 0.0) > self.cfg.threshold:
                self._streak += 1
            else:
                self._streak = 0
            if proposal is None:
                return None
            if proposal.kind != "drop_replica" \
                    and self._streak < self.cfg.persist_ticks:
                self._journal({"event": "defer", "streak": self._streak,
                               **self._act_dict(proposal)})
                return None
            last = self._last_action.get(proposal.attr)
            if last is not None and \
                    self.clock() - last < self.cfg.cooldown_s:
                m.counter("dgraph_placement_cooldown_skips_total").inc()
                self._journal({"event": "cooldown",
                               **self._act_dict(proposal)})
                return None
            return self._execute(proposal)

    def _execute(self, a: Action) -> Action | None:
        m = self.metrics
        try:
            if a.kind == "move":
                out = self.executor.move(a.attr, a.dst)
                m.counter("dgraph_placement_moves_total").inc()
            elif a.kind == "add_replica":
                out = self.executor.add_replica(a.attr, a.dst)
                m.counter("dgraph_placement_replicas_added_total").inc()
            else:
                out = self.executor.drop_replica(a.attr, a.dst)
                m.counter("dgraph_placement_replicas_dropped_total").inc()
        except Exception as e:
            m.counter("dgraph_placement_errors_total").inc()
            self._journal({"event": "action_error", "error": str(e),
                           **self._act_dict(a)})
            # errors still start the cooldown: retrying a failing move
            # every tick IS thrash
            self._last_action[a.attr] = self.clock()
            return None
        self._last_action[a.attr] = self.clock()
        self._streak = 0
        self._journal({"event": "action", "result": self._safe(out),
                       **self._act_dict(a)})
        if self.log is not None:
            self.log.info("placement action", kind=a.kind, tablet=a.attr,
                          src=a.src, dst=a.dst, reason=a.reason,
                          spread=round(a.spread, 3))
        return a

    @staticmethod
    def _safe(out):
        try:
            import json as _json

            _json.dumps(out)
            return out
        except (TypeError, ValueError):
            return str(out)

    @staticmethod
    def _act_dict(a: Action) -> dict:
        return {"kind": a.kind, "tablet": a.attr, "src": a.src,
                "dst": a.dst, "reason": a.reason,
                "spread": round(a.spread, 4)}

    def _journal(self, entry: dict) -> None:
        entry = {"at": round(time.time(), 3), **entry}
        with self._jlock:
            self._decisions.appendleft(entry)

    # -- surfaces ------------------------------------------------------------

    def decisions(self, n: int = 32) -> list[dict]:
        with self._jlock:
            return [d for i, d in enumerate(self._decisions) if i < n]

    def snapshot(self) -> dict:
        """The /placement payload: config, live diagnostics, maps, log.
        Deliberately does NOT take the tick lock — it must answer while a
        tick is mid-move; _rates/last_diag are replaced wholesale per
        poll, so a concurrent read sees a consistent previous view."""
        cfg = self.cfg
        rates = {str(g): {a: {"reads_s": round(tr.reads, 3),
                              "writes_s": round(tr.writes, 3),
                              "rate": round(tr.rate(), 3)}
                          for a, tr in gr.items()}
                 for g, gr in self._rates.items()}
        return {
            "enabled": True,
            "config": {"threshold": cfg.threshold,
                       "persist_ticks": cfg.persist_ticks,
                       "cooldown_s": cfg.cooldown_s,
                       "max_replicas": cfg.max_replicas,
                       "read_dominant": cfg.read_dominant,
                       "skew_frac": cfg.skew_frac,
                       "min_rate": cfg.min_rate},
            "diag": self.last_diag,
            "rates": rates,
            "tabletMap": self.zero.tablets(),
            "replicaMap": {a: {str(g): wm for g, wm in gs.items()}
                           for a, gs in self.zero.replicas().items()},
            "decisions": self.decisions(),
        }

    # -- background loop -----------------------------------------------------

    def start(self, interval_s: float) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:
                    self.metrics.counter(
                        "dgraph_placement_errors_total").inc()

        # dgraph: allow(ctxvar-copy) detached controller bg loop
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="dgt-placement")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()


class ZeroOpsExecutor:
    """Wire-mode executor adapter over coord/zero_service.ZeroOps."""

    def __init__(self, ops) -> None:
        self.ops = ops

    def move(self, attr: str, dst: int):
        return self.ops.move_tablet(attr, dst)

    def add_replica(self, attr: str, dst: int):
        return self.ops.install_replica(attr, dst)

    def drop_replica(self, attr: str, group: int):
        return self.ops.drop_replica(attr, group)

    def ship_deltas(self) -> int:
        """Pull owner journal deltas to every holder whose watermark is
        behind the oracle's per-tablet floor. Returns ships performed."""
        zero = self.ops.zero
        shipped = 0
        for attr, holders in sorted(zero.replicas().items()):
            floor = zero.oracle.pred_commit.get(attr, 0)
            for g, wm in sorted(holders.items()):
                if floor > wm:
                    self.ops.ship_replica_delta(attr, g)
                    shipped += 1
        return shipped


def wire_collect(ops):
    """collect() for wire mode: each group leader's Status probe carries
    tablet_sizes_json + tablet_load_json."""
    import json as _json

    def collect() -> dict:
        out: dict = {}
        with ops.svc._lock:
            groups = list(ops.svc._members)
        for g in groups:
            try:
                rw = ops._leader_of(g)
            except Exception:
                continue
            try:
                st = rw.status()
                out[g] = (
                    {a: float(s) for a, s in _json.loads(
                        st.tablet_sizes_json or "{}").items()},
                    _json.loads(st.tablet_load_json or "{}"))
            except Exception:
                continue
            finally:
                rw.close()
        return out
    return collect
