"""HBM working-set manager: tiered device residency (device ↔ host).

Port of dgraph_tpu/storage/residency.py. The tiers map onto CUDA memory:

  HBM (hot)   device tensors resident — CSR columns, token-index
              columns and vector matrices, allocated through torch's
              caching allocator. Identity-stable: eviction drops ONLY the
              owner's device tensors (the allocator gets their blocks
              back), never the owning PredCSR / TokenIndex / VectorIndex
              object, so qcache per-predicate
              tokens and the DeviceBatcher's same-CSR-object rule survive
              an evict → re-admit cycle.
  warm        host-RAM folded arrays only (the fold every tablet keeps
              anyway). Upload-on-demand through the normal device paths;
              demoted here by LRU-of-score eviction when the budget binds.
  cold        tablets whose device footprint exceeds the WHOLE budget.
              They can never be admitted, so the query layer consults
              `prefer_host()` and serves them through the host-cutover
              machinery (task._expand_csr host gather, the index host
              union, the vecindex host float64 scan) — byte-identical by
              the size-adaptive-strategy contract. A cold serve is a
              decision made from the budget, counted on
              dgraph_residency_cold_serves_total; it is not a fallback.

Admission/eviction is scored with the placement controller's rate ×
log2(size) signal (coord/placement.tablet_score), fed by the
executor's on_task hook (Node._count_task calls `touch`). Guards:

  * pin floors — `--residency_pin a,b` tablets are never evicted;
  * hysteresis — entries younger than `min_resident_s` are only evicted
    when nothing older can free enough bytes;
  * thrash accounting — a re-admission within `thrash_window_s` of the
    same tablet's eviction counts dgraph_residency_thrash_total.

Prefetch is plan-driven: Node.query hands the plan's read set
(qcache.plan_attrs) to `prefetch()` before dispatch; warm-tier uploads
run on a small pool. Every upload is `torch.from_numpy(...).to(device)`
on the calling thread's current stream, which for every thread of this
package is the device's default stream: a kernel launched on the query
thread and an upload made on a prefetch thread are ordered by that one
stream, and a buffer dropped by an eviction goes back to the caching
allocator on the stream that used it, so no kernel still in flight can
see its memory handed to another tensor.

Owner protocol (duck-typed; PredCSR, TokenIndex, LazyTokenIndex,
OverlayCSR and VectorIndex implement it):

    owner._res        the manager (None = unmanaged, e.g. bare build_pred)
    owner._res_attr   tablet attr for scoring/pinning
    owner._res_kind   "csr" | "rev" | "index:<tok>" | "vec" | "<kind>:merged"
    owner.device_nbytes()   device footprint if/when uploaded
    owner.device_resident() device tensors currently held?
    owner.drop_device()     drop the device tensors (host fold survives)
    owner.prefer_host()     True when the manager says serve host-side

The upload seam fires the `residency.h2d_upload` fault point
(utils/faults.py); the query paths catch exactly the injected FaultError
and serve the byte-identical host gather. A real CUDA error or an
out-of-memory on upload raises.

The pull-BFS layout a recurse caches on a CSR (`_pull_graph`,
ops/pull_bfs.pull_graph_for) is outside this accounting, as the JAX
package's is.
"""

from __future__ import annotations

import time
import weakref

from dgraph_tpu_torch.coord.placement import tablet_score
from dgraph_tpu_torch.obs import otrace
from dgraph_tpu_torch.utils import faults, locks

TIER_HBM = "hbm"
TIER_WARM = "warm"
TIER_COLD = "cold"

# rate decay half-life: a tablet idle for one half-life scores half its
# peak load. Long enough to ride out bursty plans, short enough that a
# cooled-off tablet loses its slot to the new working set.
RATE_HALFLIFE_S = 30.0


class _Entry:
    """One resident device-buffer group (one owner object)."""

    __slots__ = ("ref", "attr", "kind", "nbytes", "admitted_at",
                 "last_touch", "prefetched", "touched")

    def __init__(self, ref, attr: str, kind: str, nbytes: int,
                 now: float) -> None:
        self.ref = ref                   # weakref to the owner
        self.attr = attr
        self.kind = kind
        self.nbytes = int(nbytes)
        self.admitted_at = now
        self.last_touch = now
        self.prefetched = False          # uploaded by the prefetcher
        self.touched = False             # used by a task since admission


def pred_host_nbytes(pd) -> int:
    """Host bytes held by one folded PredData — CSR columns, value
    tables, token indexes, AND vector matrices (the bytes
    Node.enforce_memory undercounted before this module)."""
    n = 0
    for csr in (pd.csr, pd.rev_csr):
        if csr is None:
            continue
        est = getattr(csr, "approx_nbytes", None)
        if est is not None:              # overlay: don't force a merge
            n += est()
            continue
        hn = getattr(csr, "host_nbytes", None)
        if hn is not None:
            n += hn()
    for fld in (pd.value_subjects_host, pd.num_values_host):
        if fld is not None:
            n += int(getattr(fld, "nbytes", 0))
    for ti in pd.indexes.values():
        hn = getattr(ti, "host_nbytes", None)
        if hn is not None:
            n += hn()
    if pd.vecindex is not None:
        n += pd.vecindex.nbytes()
    return n


class ResidencyManager:
    """Per-node device-byte budget + tier bookkeeping. budget_bytes <= 0
    means unbounded (accounting and metrics still run, nothing is ever
    denied or evicted for space)."""

    def __init__(self, budget_bytes: int = 0, metrics=None,
                 pins: tuple[str, ...] = (),
                 min_resident_s: float = 2.0,
                 thrash_window_s: float = 10.0,
                 rate_halflife_s: float = RATE_HALFLIFE_S,
                 prefetch_workers: int = 2,
                 clock=None) -> None:
        from dgraph_tpu_torch.utils.metrics import Registry

        self.budget = int(budget_bytes)
        self.metrics = metrics if metrics is not None else Registry()
        self.pins = {p for p in pins if p}
        self.min_resident_s = float(min_resident_s)
        self.thrash_window_s = float(thrash_window_s)
        self.rate_halflife_s = float(rate_halflife_s)
        self.clock = clock if clock is not None else time.monotonic
        # serializes managed uploads PER OWNER (striped by identity): two
        # threads racing the same tablet's first device access must
        # produce ONE buffer set, but a prefetch of tablet A must not
        # block a foreground query's first access to tablet B
        # ONE lockdep class for the whole stripe family: stripe choice is
        # hash-derived (id % 16), so any nesting of two stripes is a
        # latent ABBA — the shared name makes lockdep's
        # same-class-nesting check catch it from a single observation
        self._upload_locks = tuple(
            locks.RLock("residency.upload") for _ in range(16))
        self._lock = locks.RLock("residency.ResidencyManager._lock")
        self._entries: dict[int, _Entry] = {}
        # attr -> resident entry keys: touch() runs per TASK and must not
        # scan every resident buffer group on the node
        self._attr_keys: dict[str, set[int]] = {}
        self._bytes = 0
        # attr -> (decayed use count, last decay ts): the executor
        # on_task hook feeds this; score = rate × log2(size)
        self._rates: dict[str, tuple[float, float]] = {}
        self._evicted_at: dict[str, float] = {}   # attr -> last eviction ts
        # id(pd) -> PredData (weak): PredData has value-equality
        # semantics (dataclass), so a WeakSet would need hashing — key on
        # identity instead; entries vanish as folds are collected
        self._preds: weakref.WeakValueDictionary = \
            weakref.WeakValueDictionary()
        self._pool = None
        self._pool_workers = max(1, int(prefetch_workers))
        m = self.metrics
        self._c_admit = m.counter("dgraph_residency_admissions_total")
        self._c_evict = m.counter("dgraph_residency_evictions_total")
        self._c_pf_hit = m.counter("dgraph_residency_prefetch_hits_total")
        self._c_pf_waste = m.counter(
            "dgraph_residency_prefetch_wasted_total")
        self._c_thrash = m.counter("dgraph_residency_thrash_total")
        self._c_cold = m.counter("dgraph_residency_cold_serves_total")
        self._c_upfail = m.counter(
            "dgraph_residency_upload_failures_total")
        self._c_overrun = m.counter(
            "dgraph_residency_budget_overruns_total")
        self._g_hbm = m.counter("dgraph_residency_hbm_bytes")
        self._g_host = m.counter("dgraph_residency_host_bytes")
        self._tier_gauge = m.keyed("dgraph_residency_tier_bytes",
                                   labels=("tier",))

    # -- config ---------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        """True when a finite budget is configured (eviction can happen)."""
        return self.budget > 0

    def upload_lock_for(self, owner):
        return self._upload_locks[id(owner) % len(self._upload_locks)]

    def pin(self, attr: str) -> None:
        with self._lock:
            self.pins.add(attr)

    def unpin(self, attr: str) -> None:
        with self._lock:
            self.pins.discard(attr)

    # -- load signals (executor on_task hook) ---------------------------------

    def touch(self, attr: str, n: float = 1.0) -> None:
        """One task read against attr: bump the decayed rate and resolve
        prefetch-hit accounting for its resident buffers."""
        now = self.clock()
        with self._lock:
            cnt, ts = self._rates.get(attr, (0.0, now))
            if now > ts:
                cnt *= 0.5 ** ((now - ts) / self.rate_halflife_s)
            self._rates[attr] = (cnt + float(n), now)
            for key in self._attr_keys.get(attr, ()):
                e = self._entries.get(key)
                if e is None:
                    continue
                e.last_touch = now
                if e.prefetched and not e.touched:
                    self._c_pf_hit.inc()
                e.touched = True

    def _rate(self, attr: str, now: float) -> float:
        cnt, ts = self._rates.get(attr, (0.0, now))
        if now > ts:
            cnt *= 0.5 ** ((now - ts) / self.rate_halflife_s)
        return cnt

    def _score(self, e: _Entry, now: float) -> float:
        return tablet_score(e.nbytes, self._rate(e.attr, now))

    # -- admission / eviction -------------------------------------------------

    def allows_device(self, nbytes: int) -> bool:
        """False only for COLD tablets: a device footprint larger than the
        whole budget can never be admitted — serve it host-side."""
        return self.budget <= 0 or int(nbytes) <= self.budget

    def note_cold_serve(self) -> None:
        from dgraph_tpu_torch.obs import costs

        costs.note("cold_serve")
        self._c_cold.inc()

    def before_upload(self, owner) -> None:
        """Called by an owner immediately before its H2D upload (the
        caller holds upload_lock). Fires the chaos fault point, then
        evicts colder tablets until the new buffers fit."""
        faults.fire("residency.h2d_upload", m=self.metrics)
        need = int(owner.device_nbytes())
        if self.budget <= 0:
            return
        with self._lock:
            if need > self.budget:
                # cold tablet forced onto the device by a path that never
                # consulted prefer_host (belt-and-braces: never fail the
                # read, but make the overrun visible)
                self._c_overrun.inc()
                return
            self._evict_for_locked(need)

    def _evict_for_locked(self, need: int) -> None:
        now = self.clock()
        for honor_hysteresis in (True, False):
            if self._bytes + need <= self.budget:
                return
            cands = [e for e in self._entries.values()
                     if e.attr not in self.pins]
            if honor_hysteresis:
                cands = [e for e in cands
                         if now - e.admitted_at >= self.min_resident_s]
            cands.sort(key=lambda e: (self._score(e, now), e.last_touch))
            for e in cands:
                if self._bytes + need <= self.budget:
                    return
                self._evict_entry_locked(e, now, reason="budget")

    def _evict_entry_locked(self, e: _Entry, now: float,
                            reason: str) -> None:
        owner = e.ref()
        key = None
        for k, v in list(self._entries.items()):
            if v is e:
                key = k
                break
        if key is None:
            return                 # weakref callback already reaped it
        self._entries.pop(key, None)
        self._attr_keys.get(e.attr, set()).discard(key)
        self._bytes -= e.nbytes
        self._c_evict.inc()
        if e.prefetched and not e.touched:
            self._c_pf_waste.inc()
        # thrash counts ONCE per cycle, at re-admission (after_upload) —
        # the documented "re-admitted within thrash_window_s of its
        # eviction" semantics
        self._evicted_at[e.attr] = now
        if len(self._evicted_at) > 4096:
            self._evicted_at.pop(next(iter(self._evicted_at)))
        self._g_hbm.set(self._bytes)
        self._tier_gauge.set(TIER_HBM, self._bytes)
        otrace.event("residency_tier", attr=e.attr, kind=e.kind,
                     transition="hbm->warm", reason=reason,
                     nbytes=e.nbytes)
        if owner is not None:
            owner.drop_device()

    def after_upload(self, owner, prefetch: bool = False) -> None:
        """Register freshly-uploaded device buffers (caller holds
        upload_lock)."""
        now = self.clock()
        attr = getattr(owner, "_res_attr", "")
        kind = getattr(owner, "_res_kind", "")
        nbytes = int(owner.device_nbytes())
        with self._lock:
            key = id(owner)
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes

            def _gone(_ref, _key=key):
                with self._lock:
                    ent = self._entries.pop(_key, None)
                    if ent is not None:
                        self._attr_keys.get(ent.attr, set()).discard(_key)
                        self._bytes -= ent.nbytes
                        self._g_hbm.set(self._bytes)

            e = _Entry(weakref.ref(owner, _gone), attr, kind, nbytes, now)
            e.prefetched = bool(prefetch)
            self._entries[key] = e
            self._attr_keys.setdefault(attr, set()).add(key)
            self._bytes += nbytes
            self._c_admit.inc()
            ev = self._evicted_at.get(attr)
            if ev is not None and now - ev <= self.thrash_window_s:
                self._c_thrash.inc()
            self._g_hbm.set(self._bytes)
            # the hbm tier series stays live on /metrics without a
            # usage() walk; warm/cold refresh on usage()/debug reads
            self._tier_gauge.set(TIER_HBM, self._bytes)
        otrace.event("residency_tier", attr=attr, kind=kind,
                     transition="warm->hbm",
                     prefetch=bool(prefetch), nbytes=nbytes)

    def evict_to(self, budget_bytes: int) -> int:
        """Shrink resident device bytes to at most budget_bytes, ignoring
        hysteresis (enforce_memory / tests). Pinned tablets survive unless
        the target is 0. Returns the number of buffer groups evicted."""
        n = 0
        target = max(0, int(budget_bytes))
        with self._lock:
            now = self.clock()
            cands = sorted(self._entries.values(),
                           key=lambda e: (e.attr in self.pins,
                                          self._score(e, now),
                                          e.last_touch))
            for e in cands:
                if self._bytes <= target:
                    break
                if target > 0 and e.attr in self.pins:
                    continue
                self._evict_entry_locked(e, now, reason="enforce")
                n += 1
        return n

    # -- tier queries ---------------------------------------------------------

    def tier_of(self, attr: str, nbytes: int | None = None) -> str:
        with self._lock:
            if self._attr_keys.get(attr):
                return TIER_HBM
        if nbytes is not None and not self.allows_device(nbytes):
            return TIER_COLD
        return TIER_WARM

    # -- host-side accounting (enforce_memory) --------------------------------

    def track_pred(self, pd) -> None:
        # WeakValueDictionary is not thread-safe; folds can land from the
        # fold pool while a /debug reader walks host_bytes()
        with self._lock:
            self._preds[id(pd)] = pd

    def host_bytes(self) -> int:
        """Host bytes pinned by live folded PredData objects — including
        vector embedding matrices (the enforce_memory undercount fix)."""
        total = 0
        with self._lock:
            live = list(self._preds.values())
        for pd in live:
            try:
                total += pred_host_nbytes(pd)
            except Exception:
                continue
        self._g_host.set(total)
        return total

    # -- owner adoption (fold/stamp seam) -------------------------------------

    def adopt_pred(self, pd) -> None:
        """Attach this manager to every device-buffer owner of one folded
        or stamped PredData (csr_build.build_pred / delta.stamp_pred
        tails) and start host-byte tracking for it."""
        attr = pd.attr
        self._adopt(pd.csr, attr, "csr")
        self._adopt(pd.rev_csr, attr, "rev")
        for name, ti in pd.indexes.items():
            self._adopt(ti, attr, f"index:{name}")
        vi = pd.vecindex
        if vi is not None:
            if getattr(vi, "is_overlay", False):
                self._adopt(getattr(vi, "base", None), attr, "vec")
            else:
                self._adopt(vi, attr, "vec")
        self.track_pred(pd)

    def _adopt(self, owner, attr: str, kind: str) -> None:
        if owner is None:
            return
        base = getattr(owner, "base", None)
        if base is not None and hasattr(owner, "delta"):
            # OverlayCSR: manage the base AND the overlay's merged view
            self._adopt(base, attr, kind)
            kind = f"{kind}:merged"
        if not (hasattr(owner, "drop_device")
                and hasattr(owner, "device_nbytes")):
            return
        if getattr(owner, "_res", None) is self:
            return
        owner._res = self
        owner._res_attr = attr
        owner._res_kind = kind

    # -- plan-driven prefetch -------------------------------------------------

    def prefetch(self, attrs, snap, sync: bool = False) -> int:
        """Plan-driven prefetch, two legs issued BEFORE dispatch:

        * lazy FOLDS — attrs still registered as fold-thunks
          (storage/csr_build.LazyPreds) resolve on the shared fold pool,
          overlapping the fold with the request's preceding host work;
          the request's own first read then JOINS the in-flight fold via
          the thunk's singleflight. Folding is host-side cost, so this
          leg runs regardless of the device budget.
        * warm→HBM UPLOADS — folded, admissible,
          not-yet-resident buffer groups upload on the async pool, only
          with a finite budget (`enabled`), exactly as before. A
          prefetched fold chains into its own upload when admissible.

        Returns the number of fold+upload actions scheduled. sync=True
        runs everything inline (tests / deterministic benches)."""
        if not attrs:
            return 0
        preds = snap.preds
        is_pending = getattr(preds, "is_pending", None)
        scheduled = 0
        folded_attrs = []
        for attr in attrs:
            if is_pending is not None and is_pending(attr):
                scheduled += 1
                if sync:
                    self._prefetch_fold(preds, attr, sync=True)
                else:
                    from dgraph_tpu_torch.storage.csr_build import _fold_pool

                    # dgraph: allow(ctxvar-copy) prefetched folds build
                    # SHARED snapshot state cached across requests — they
                    # must not inherit any one request's deadline/trace
                    _fold_pool().submit(self._prefetch_fold, preds, attr)
            else:
                folded_attrs.append(attr)
        if not self.enabled:
            return scheduled
        todo = []
        for attr in folded_attrs:
            pd = preds.get(attr)
            if pd is None:
                continue
            todo.extend(self._upload_candidates(pd))
        for owner in todo:
            if sync:
                self._prefetch_one(owner)
            else:
                # dgraph: allow(ctxvar-copy) prefetch outlives the
                # admitting request by design (the uploaded buffers are
                # shared) — inheriting its deadline would cancel uploads
                # the NEXT query needs
                self._prefetch_pool().submit(self._prefetch_one, owner)
        return scheduled + len(todo)

    def _upload_candidates(self, pd) -> list:
        """Managed, admissible, not-yet-resident buffer groups of one
        folded PredData."""
        out = []
        for owner in (pd.csr, pd.rev_csr, pd.vecindex):
            if owner is None or getattr(owner, "_res", None) is not self:
                continue
            try:
                if owner.device_resident() or \
                        not self.allows_device(owner.device_nbytes()):
                    continue
            except Exception:
                continue
            out.append(owner)
        return out

    def _prefetch_fold(self, preds, attr: str, sync: bool = False) -> None:
        """Resolve one pending fold-thunk (trigger=prefetch), then chain
        its warm→HBM uploads when a finite budget is configured. The
        uploads route through the dedicated prefetch pool — a blocking
        H2D transfer must not occupy a fold-pool slot other queries'
        lazy folds are waiting on (sync=True runs them inline)."""
        try:
            pd = preds.resolve(attr, "prefetch")
        except Exception:
            # racing drops / injected faults: the on-demand read path
            # retries; a failed prefetch must never surface anywhere
            return
        if pd is None or not self.enabled:
            return
        for owner in self._upload_candidates(pd):
            if sync:
                self._prefetch_one(owner)
            else:
                # dgraph: allow(ctxvar-copy) prefetch uploads are shared
                # node work detached from any request's deadline/trace
                self._prefetch_pool().submit(self._prefetch_one, owner)

    def _prefetch_pool(self):
        with self._lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=self._pool_workers,
                    thread_name_prefix="dgt-prefetch")
            return self._pool

    def _prefetch_one(self, owner) -> None:
        if getattr(owner, "delta", None) is not None:
            # an overlay's merged view builds at its first device read
            # only (the JAX OverlayCSR has no prefetchable upload either)
            return
        try:
            fn = getattr(owner, "device_arrays", None) or \
                getattr(owner, "device", None)
            if fn is None:
                return
            fn(prefetch=True)
        except Exception:
            # injected upload faults / racing drops: the on-demand path
            # retries; a failed prefetch must never surface anywhere
            pass

    # -- readouts -------------------------------------------------------------

    def usage(self) -> dict:
        """Tier byte totals + counters; refreshes the /metrics gauges."""
        hbm = warm = cold = 0
        with self._lock:
            hbm = self._bytes
            resident_ids = {id(e.ref()) for e in self._entries.values()
                            if e.ref() is not None}
            live = list(self._preds.values())
        for pd in live:
            owners = [pd.csr, pd.rev_csr, pd.vecindex] + \
                list(pd.indexes.values())
            for owner in owners:
                if owner is None or \
                        not hasattr(owner, "device_nbytes"):
                    continue
                if id(owner) in resident_ids:
                    continue
                try:
                    nb = int(owner.device_nbytes())
                except Exception:
                    continue
                if not self.allows_device(nb):
                    cold += nb
                else:
                    warm += nb
        self._tier_gauge.set(TIER_HBM, hbm)
        self._tier_gauge.set(TIER_WARM, warm)
        self._tier_gauge.set(TIER_COLD, cold)
        self._g_hbm.set(hbm)
        return {"budget_bytes": self.budget, "hbm_bytes": hbm,
                "warm_bytes": warm, "cold_bytes": cold,
                "entries": len(self._entries)}

    def debug_snapshot(self) -> dict:
        """The /debug/metrics "residency" section payload."""
        u = self.usage()
        c = lambda n: self.metrics.counter(n).value
        with self._lock:
            resident = {}
            for e in self._entries.values():
                resident[f"{e.attr}/{e.kind}"] = e.nbytes
        return {
            "budget_mb": round(self.budget / (1 << 20), 2),
            "enabled": self.enabled,
            "tiers": {TIER_HBM: u["hbm_bytes"], TIER_WARM: u["warm_bytes"],
                      TIER_COLD: u["cold_bytes"]},
            "host_bytes": self.host_bytes(),
            "admissions": c("dgraph_residency_admissions_total"),
            "evictions": c("dgraph_residency_evictions_total"),
            "prefetch_hits": c("dgraph_residency_prefetch_hits_total"),
            "prefetch_wasted":
                c("dgraph_residency_prefetch_wasted_total"),
            "thrash": c("dgraph_residency_thrash_total"),
            "cold_serves": c("dgraph_residency_cold_serves_total"),
            "upload_failures":
                c("dgraph_residency_upload_failures_total"),
            "budget_overruns":
                c("dgraph_residency_budget_overruns_total"),
            "pinned": sorted(self.pins),
            "resident": resident,
        }

    def close(self) -> None:
        pool = self._pool
        if pool is not None:
            pool.shutdown(wait=False)


def ensure_device(owner, cache_attr: str, build, prefetch: bool = False):
    """The shared upload seam for every owner's lazy device property:
    unmanaged owners upload directly (exactly the pre-residency
    behavior); managed ones serialize through the manager's upload lock
    (two threads racing the same tablet's first access must mint ONE
    buffer set), fire the `residency.h2d_upload` fault point, evict for
    space, and register with the manager. `build` returns the device
    buffer tuple, cached on the owner under `cache_attr`."""
    dev = getattr(owner, cache_attr)
    if dev is not None:
        return dev
    mgr = getattr(owner, "_res", None)
    if mgr is None:
        dev = build()
        setattr(owner, cache_attr, dev)
        return dev
    with mgr.upload_lock_for(owner):
        dev = getattr(owner, cache_attr)
        if dev is None:
            try:
                mgr.before_upload(owner)
            except faults.FaultError:
                mgr._c_upfail.inc()
                raise
            dev = build()
            setattr(owner, cache_attr, dev)
            mgr.after_upload(owner, prefetch=prefetch)
            if not prefetch:
                # warm->HBM upload at SERVE time: the querying request
                # paid the transfer — charge its cost ledger (prefetch
                # uploads are the node's background work, not the
                # query's)
                from dgraph_tpu_torch.obs import costs

                try:
                    costs.add_upload(int(owner.device_nbytes()))
                    costs.note("residency_upload")
                except Exception:
                    pass       # accounting must never fail an upload
    return dev


def prefer_host(owner) -> bool:
    """True when the owner's manager classifies it COLD (device footprint
    larger than the whole budget) and it is not already resident — the
    query layer serves it through the existing host-cutover machinery.
    Unmanaged owners never prefer host (pre-residency behavior).

    Pure consult: callers that actually SERVE the read host-side count
    dgraph_residency_cold_serves_total themselves (note_cold_serve) — a
    query may consult several owners (fused-shape checks) but serves each
    read once."""
    mgr = getattr(owner, "_res", None)
    if mgr is None or owner.device_resident():
        return False
    return not mgr.allows_device(owner.device_nbytes())
