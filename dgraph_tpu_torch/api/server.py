"""The embedded server node: Query / Mutate / Alter / CommitOrAbort.

Reference semantics: edgraph/server.go — Query (:373), Mutate (:267), Alter
(:213), CommitOrAbort (:462); parseMutationObject (:528). The reference runs
this behind gRPC with a separate Zero process; here the node embeds its Zero
(coord/zero.py) in-process — the same embedded single-process cluster mode
the reference's own tests use (query/query_test.go TestMain, SURVEY.md §4).

Read path: a query leases a read_ts from the oracle and executes against an
immutable GraphSnapshot (storage/csr_build.py) — the TPU-first stance: the
device only ever sees committed snapshot CSRs; MVCC stays host-side.
Snapshots are cached per effective read_ts (bounded LRU), so repeated reads
between commits reuse the same device arrays.

Write path: Mutate buffers edges under start_ts (uncommitted posting layers
+ index/reverse/count maintenance), the oracle tracks conflict-key
fingerprints, and commit runs the SSI check, assigns commit_ts, and promotes
the layers — first-committer-wins snapshot isolation
(dgraph/cmd/zero/oracle.go:71-83).

Port of dgraph_tpu/api/server.py. The port's Node adds one argument,
`device` (default "cuda", which raises without CUDA): every snapshot it
assembles lives there. It serves with the JAX Node's defaults: the
cost-based planner (`planner=True`, query/planner.py), the device batcher
(`batching=True`, query/batch.py), the device observatory (`devprof=True`,
obs/devprof.py) and an HBM working-set manager that is always present
(storage/residency.py; `device_budget_mb=0` means accounting only). The
answers are the same with any of them off: the planner and the batcher
change order and dispatch, never output, and a cold-tier tablet serves
through the host-mirror path.

The vector-index knobs (`vector_nprobe`, `vector_centroids`,
`vector_ivf_min_rows`) ride this Node's Store into the fold.

`mesh_devices` (as in the JAX Node: 0 = off, -1 = every device, N = N
shards) places large tablets across a parallel/mesh_exec.MeshExecutor at
snapshot assembly, and `analytics` runs PageRank / CC / triangles over one
uid tablet on it (the host oracles without a mesh). On the card the mesh's
devices are the visible cards; on the CPU it repeats the CPU device N times
(-1 = one shard), as the JAX tests force host-platform devices. The
per-tablet load book (coord/placement.TabletLoadBook) counts reads at the
task seam and writes at mutate.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.coord.zero import TxnConflict, Zero
from dgraph_tpu_torch.obs import costs, otrace
from dgraph_tpu_torch.obs.slowlog import SlowQueryLog
from dgraph_tpu_torch.query import dql, rdf
from dgraph_tpu_torch.query import mutation as mut
from dgraph_tpu_torch.query import qcache
from dgraph_tpu_torch.query import upsert as ups
from dgraph_tpu_torch.query.engine import Executor
from dgraph_tpu_torch.storage import index as idx
from dgraph_tpu_torch.storage import keys as K
from dgraph_tpu_torch.storage.csr_build import (GraphSnapshot,
                                                SnapshotAssembler,
                                                build_pred)
from dgraph_tpu_torch.storage.postings import Op
from dgraph_tpu_torch.storage.store import Store
from dgraph_tpu_torch.parallel.scheduler import Scheduler
from dgraph_tpu_torch import tenancy as tnc
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils import metrics
from dgraph_tpu_torch.utils.schema import parse_schema

# the program families whose one build is the K1/K2 library
# (ops/prefix.py): the /debug/compiles probe reports it for them
_KERNEL_FAMILIES = frozenset({"pb.active_prefix", "pb.active_prefix_sparse"})


@dataclass
class TxnContext:
    """Reference: api.TxnContext (start/commit ts + conflict keys)."""

    start_ts: int
    commit_ts: int = 0
    aborted: bool = False
    keys: list[bytes] = field(default_factory=list)       # all touched
    conflict_keys: list[bytes] = field(default_factory=list)
    preds: set[str] = field(default_factory=set)
    version: int = 0                       # bumped per mutate (overlay cache)
    overlay: tuple[int, dict] | None = None  # (version, {attr: PredData})
    inflight: int = 0          # mutations mid-apply; commit/abort wait on 0
    finishing: bool = False    # commit/abort started: reject new mutations
    last_active: float = field(default_factory=time.monotonic)


@dataclass
class MutationResult:
    uids: dict[str, int]          # blank-node name -> assigned uid
    context: TxnContext


class Node:
    """One embedded server (store + zero + snapshot cache)."""

    def __init__(self, dirpath: str | None = None, n_groups: int = 1,
                 trace_fraction: float = 1.0,
                 memory_mb: int | None = None,
                 plan_cache_size: int = 256,
                 task_cache_mb: int = 64,
                 result_cache_mb: int = 32,
                 dispatch_width: int = 4,
                 overlay: bool = True,
                 overlay_max_keys: int | None = None,
                 overlay_max_age_s: float | None = None,
                 background_rollup: bool = True,
                 fold_workers: int | None = None,
                 planner: bool = True,
                 stats_top_k: int = 8,
                 span_sample: float = 0.01,
                 trace_rng=None,
                 slow_query_ms: float = 0.0,
                 slow_query_log: str | None = None,
                 mesh_devices: int = 0,
                 mesh_min_edges: int | None = None,
                 default_timeout_ms: float = 0.0,
                 vector_nprobe: int = 0,
                 vector_centroids: int = -1,
                 vector_ivf_min_rows: int = 0,
                 batching: bool = True,
                 batch_window_ms: float = 2.0,
                 batch_max: int = 16,
                 write_batch: bool = True,
                 write_window_ms: float = 2.0,
                 write_batch_max: int = 64,
                 device_budget_mb: int = 0,
                 residency_pin: str = "",
                 cost_ledger: bool = True,
                 cost_regression_factor: float = 4.0,
                 lazy_folds: bool = True,
                 delta_journal_max_keys: int | None = None,
                 live_queue_max: int = 256,
                 live_idle_timeout_s: float = 300.0,
                 live_heartbeat_s: float = 15.0,
                 devprof: bool = True,
                 qos: bool = True,
                 tenants=None,
                 device: str = "cuda") -> None:
        self.device = resolve_device(device)
        # memory_mb enables the PAGED store: snapshot mmap'd, lists
        # materialize lazily, clean entries evict under the budget
        self.store = Store(dirpath,
                           memory_budget=(memory_mb * (1 << 20))
                           if memory_mb else None,
                           max_delta_keys=delta_journal_max_keys)
        # vector-index IVF knobs (--vector_nprobe / --vector_centroids /
        # --vector_ivf_min_rows): per-node — they ride this node's Store
        # into the fold (storage/vecindex.py), so embedding a second Node
        # in the same process never inherits them
        if vector_nprobe or vector_centroids >= 0 or vector_ivf_min_rows:
            from dgraph_tpu_torch.storage.vecindex import VectorKnobs

            self.store.vector_knobs = VectorKnobs(
                nprobe=vector_nprobe,
                centroids=vector_centroids,
                ivf_min_rows=vector_ivf_min_rows)
        self.zero = Zero(n_groups)
        self.metrics = metrics.Registry()
        # checkpoint/ingest gauges (peak transient bytes etc.) land in this
        # node's registry — they show on /metrics next to the query tiers
        self.store.metrics = self.metrics
        # HBM working-set manager (storage/residency.py): owns the node's
        # device-byte budget and the HBM ↔ host tiers. Folded tablets
        # attach at build_pred/stamp_pred (store.residency), device uploads
        # admit against the budget (evicting colder tablets by the
        # placement controller's rate×log2(size) score), and COLD tablets
        # (footprint > budget) serve through the host-cutover machinery.
        # budget 0 = unbounded: accounting only.
        from dgraph_tpu_torch.storage.residency import ResidencyManager

        pins = residency_pin
        if isinstance(pins, str):
            pins = tuple(p.strip() for p in pins.split(",") if p.strip())
        self.residency = ResidencyManager(
            budget_bytes=int(device_budget_mb) << 20,
            metrics=self.metrics, pins=tuple(pins))
        self.store.residency = self.residency
        self.mesh_exec = None
        if mesh_devices:
            from dgraph_tpu_torch.parallel.mesh import make_mesh
            from dgraph_tpu_torch.parallel.mesh_exec import MeshExecutor

            n = None if mesh_devices < 0 else int(mesh_devices)
            if self.device.type == "cuda":
                # the visible cards, led by the Node's own card, so the
                # sharded tablets share a leader with the snapshot
                import torch

                count = torch.cuda.device_count()
                lead = self.device.index
                if lead is None:
                    lead = torch.cuda.current_device()
                mesh = make_mesh(n, devices=[
                    torch.device("cuda", (lead + i) % count)
                    for i in range(count)])
            else:
                mesh = make_mesh(n or 1, devices=[self.device] * (n or 1))
            self.mesh_exec = MeshExecutor(
                mesh=mesh, metrics=self.metrics,
                shard_min_edges=mesh_min_edges, residency=self.residency)
        # per-tablet load counters (coord/placement.py TabletLoadBook):
        # every dispatched task and applied edge counts toward the
        # dgraph_tablet_load{pred,group,stat} series on /metrics and the
        # /debug/metrics tablet_load section — the placement controller's
        # scoring inputs, inspectable on the embedded node too
        from dgraph_tpu_torch.coord.placement import TabletLoadBook

        self.tablet_book = TabletLoadBook(self.metrics, group=0)
        self.traces = metrics.TraceStore(fraction=trace_fraction,
                                         rng=trace_rng)
        # span tracing + device profiling (obs/otrace.py): root spans start
        # at query/mutate/alter, children attach via contextvar down to the
        # device kernels; completed traces export as Chrome trace JSON at
        # /debug/traces/<id>. slow_query_ms > 0 arms the slow-query log.
        self.slow_log = SlowQueryLog(slow_query_ms, path=slow_query_log)
        self.tracer = otrace.Tracer(fraction=span_sample, proc="node",
                                    rng=trace_rng, slowlog=self.slow_log,
                                    metrics=self.metrics)
        # serving tier: parsed-plan cache, snapshot-keyed task
        # result LRU (+ singleflight), bounded device-dispatch gate.
        # Size 0 disables a tier (bench.py's cold-cache mode).
        self.plan_cache = (qcache.PlanCache(plan_cache_size, self.metrics)
                           if plan_cache_size > 0 else None)
        self.task_cache = (qcache.TaskResultCache(task_cache_mb << 20,
                                                  self.metrics)
                           if task_cache_mb > 0 else None)
        self.result_cache = (qcache.ResultCache(result_cache_mb << 20,
                                                self.metrics)
                             if result_cache_mb > 0 else None)
        self.dispatch_gate = qcache.DispatchGate(dispatch_width,
                                                 self.metrics)
        # device-dispatch batcher (query/batch.py): concurrent compatible
        # device-class tasks — same predicate CSR object (which pins the
        # snapshot), same kernel class — pack into ONE batched launch,
        # amortizing the fixed dispatch+sync that otherwise serializes
        # through the gate. --no_batch / batching=False restores exact
        # per-task dispatch.
        self.batcher = None
        if batching and batch_max > 1:
            from dgraph_tpu_torch.query.batch import DeviceBatcher

            self.batcher = DeviceBatcher(self.dispatch_gate, self.metrics,
                                         window_ms=batch_window_ms,
                                         max_batch=batch_max)
        # group-commit write window (storage/writebatch.py):
        # concurrent committing txns form ONE batched oracle conflict
        # pass, ONE contiguous WAL append with ONE fsync, and ONE
        # store-lock apply advancing the window's union watermarks.
        # --no_write_batch / write_batch=False restores the exact
        # per-commit path.
        self.write_batcher = None
        if write_batch and write_batch_max > 1:
            from dgraph_tpu_torch.storage.writebatch import WriteBatcher

            self.write_batcher = WriteBatcher(
                self.zero.oracle, self.store, self.metrics,
                window_ms=write_window_ms, max_batch=write_batch_max)
        # cost-based planner (query/planner.py) over the live cardinality
        # stats (storage/stats.py). Order decisions only — disabling it
        # (--no_planner) restores exact parse-order execution.
        self.planner_enabled = planner
        self.stats_top_k = int(stats_top_k)
        # request lifelines: a per-request deadline budget
        # (query/mutate timeout_ms arg, HTTP ?timeoutMs=, --default_
        # timeout_ms flag) consumed at the dispatch gate + task seams;
        # overruns are typed DeadlineExceeded, overload sheds typed
        # ResourceExhausted — never a hang. 0 = unbudgeted.
        self.default_timeout_ms = float(default_timeout_ms)
        self._txns: dict[int, TxnContext] = {}
        self._lock = threading.RLock()       # commit/read linearization
        self._inflight_cv = threading.Condition(self._lock)
        self._sched = Scheduler()            # conflict-keyed mutation apply
        # incremental per-predicate snapshot reuse (shared with the worker
        # wire service and follower readers): a commit touching one
        # predicate STAMPS a delta overlay on one predicate (storage/
        # delta.py) — or re-folds it when the journal can't prove the delta
        self._assembler = SnapshotAssembler(
            self.store,
            on_pred_build=lambda attr: self.metrics.counter(
                "dgraph_posting_reads_total").inc(
                    len(self.store.by_pred.get(
                        (int(K.KeyKind.DATA), attr), ()))),
            metrics=self.metrics,
            overlay_enabled=overlay,
            overlay_max_keys=overlay_max_keys,
            overlay_max_age_s=overlay_max_age_s,
            fold_workers=fold_workers,
            lazy_folds=lazy_folds,
            device=self.device)
        # cold-open / first-query gauges: wall from node birth
        # to the first completed query — the number lazy folds move
        self._birth = time.perf_counter()
        self._first_query_done = False
        # background rollup: overlays past the size/age threshold fold back
        # into fresh bases OFF the query path (posting-list rollups one
        # level up); started lazily on the first stamped overlay
        self.background_rollup = background_rollup
        self._rollup_stop = threading.Event()
        self._rollup_started = False
        if self.store.max_seen_commit_ts:
            # recover the ts sequence past everything the WAL replayed
            self.zero.oracle.timestamps(self.store.max_seen_commit_ts)
        maxuid = self._max_uid_in_store()
        if maxuid:
            self.zero.uids.assign(maxuid)
        self.memory_budget = 0          # 0 = unbounded
        self._enforcer_started = False
        # per-request cost ledger + /debug/top profiler
        # (obs/costs.py): every query assembles one resource cost record
        # (device-kernel ms, transfer bytes, traversed edges, cache/batch/
        # shed outcomes, per-predicate breakdown) which feeds the
        # aggregatable dgraph_query_cost_* histograms (with trace
        # exemplars) and the CostBook's sliding /debug/top window with
        # per-shape EWMA regression baselines. --no_cost_ledger restores
        # the unmeasured path (bench `obs` gates the armed overhead <2%).
        self.cost_ledger = bool(cost_ledger)
        self.cost_book = costs.CostBook(
            regression_factor=cost_regression_factor)
        # live queries (live/): standing subscriptions re-derived O(Δ) per
        # commit window. Re-evals run read-only at the window's watermark
        # through the normal query path — same caches — ranked under
        # endpoint="live" in /debug/top.
        from dgraph_tpu_torch.live import LiveManager

        # (the batcher is handed over: a live notifier re-evaluating a
        # coalesced commit window hints a burst, so its re-evals pack)
        self.live = LiveManager(
            eval_fn=lambda q, v, ts, subs=(): self.query(
                q, v, start_ts=ts, read_only=True,
                _cost_endpoint="live", _cost_subs=subs)[0],
            watermark_fn=lambda: self.store.max_seen_commit_ts,
            parse_fn=self._parse,
            stores=[self.store],
            metrics=self.metrics,
            queue_max=live_queue_max,
            idle_timeout_s=live_idle_timeout_s,
            heartbeat_s=live_heartbeat_s,
            batcher=self.batcher)
        self.store.on_delta_overflow = self.live.on_journal_overflow
        # multi-tenant QoS (dgraph_tpu/tenancy/): namespaces are
        # ALWAYS active for a non-default tenant (they are correctness —
        # every request resolves predicates in its caller's namespace via
        # NamespacedSnapshot/NamespacedSchema views); quota admission and
        # weighted-fair device scheduling arm only when qos=True AND a
        # tenants config is installed (serve --tenants / POST
        # /admin/tenant). --no_qos keeps every serving seam reading one
        # None attribute — single-tenant deployments stay byte-identical.
        self.qos_enabled = bool(qos)
        self.tenancy = tnc.TenantRegistry(self.metrics)
        from collections import OrderedDict

        # tenant snapshot views, cached per (tenant, base snapshot token)
        # so engine-side attrs cached ON the snapshot object (known-uid
        # sets) survive across requests within one base snapshot
        self._ns_views: OrderedDict = OrderedDict()
        self._ns_lock = threading.Lock()
        self.zero.tenants = self.tenancy
        if tenants:
            self.configure_tenants(tenants)
        # device-runtime observatory (obs/devprof.py): kernel-build
        # tracking, device-memory telemetry and the dispatch timeline,
        # attached at the gate seam plus the module fan-out for
        # process-global build sites. --no_devprof never constructs it —
        # the seams read one None attribute / one empty tuple.
        self._device_budget_bytes = int(device_budget_mb) << 20
        self.devprof = None
        if devprof:
            self._arm_devprof()

    def _arm_devprof(self) -> None:
        from dgraph_tpu_torch.obs import devprof as devprof_mod
        from dgraph_tpu_torch.obs.devprof import DevProfiler

        prof = DevProfiler(self.metrics, slow_log=self.slow_log,
                           budget_bytes=self._device_budget_bytes,
                           residency=self.residency, device=self.device)
        prof.add_cache_probe("mesh.programs",
                             lambda: len(self.mesh_exec._progs)
                             if self.mesh_exec is not None else 0)

        def dist_caches():
            import sys

            d = sys.modules.get("dgraph_tpu_torch.parallel.dist")
            if d is None:
                return {}
            return {"dist.expand":
                    d._expand_program.cache_info().currsize,
                    "dist.k_hop":
                    d._k_hop_program.cache_info().currsize}

        def ops_programs():
            # only modules ALREADY imported by an executed path — the
            # probe must not import kernels on a scrape. A torch function
            # holds no per-shape programs; the kernel families hold the
            # one K1/K2 library once it is loaded (ops/prefix.py).
            import sys

            built = getattr(sys.modules.get("dgraph_tpu_torch.ops.prefix"),
                            "programs_built", lambda: 0)()
            out = {}
            for name in ("segments", "vector", "pull_bfs", "traversal"):
                m = sys.modules.get(f"dgraph_tpu_torch.ops.{name}")
                for fam in getattr(m, "JIT_PROGRAMS", {}):
                    out[fam] = built if fam in _KERNEL_FAMILIES else 0
            return out

        prof.add_cache_probe("dist", dist_caches)
        prof.add_cache_probe("ops.jit", ops_programs)
        self.devprof = prof
        self.dispatch_gate.profiler = prof
        if self.mesh_exec is not None:
            self.mesh_exec._prof = prof
        devprof_mod.register(prof)

    def set_devprof(self, on: bool) -> None:
        """Arm/disarm the device-runtime observatory live (A/B runs toggle
        this between battery passes)."""
        from dgraph_tpu_torch.obs import devprof as devprof_mod

        if on and self.devprof is None:
            self._arm_devprof()
        elif not on and self.devprof is not None:
            devprof_mod.unregister(self.devprof)
            self.dispatch_gate.profiler = None
            if self.mesh_exec is not None:
                self.mesh_exec._prof = None
            self.devprof = None

    # -- multi-tenant QoS -----------------------------------------

    _NS_VIEW_CAP = 32

    def configure_tenants(self, cfg, replace: bool = False) -> dict:
        """Install/merge the tenant table (serve --tenants flag and the
        POST /admin/tenant hot reload). `cfg` is a {"tenants": {...}} (or
        bare name->spec) dict, a JSON string, or a path to a JSON file.
        Arms quota admission + fair scheduling when qos is enabled."""
        if isinstance(cfg, str):
            import json as _json
            import os

            if os.path.exists(cfg):
                with open(cfg, encoding="utf-8") as f:
                    cfg = _json.load(f)
            else:
                cfg = _json.loads(cfg)
        table = self.tenancy.configure(cfg, replace=replace)
        self._arm_qos()
        return table

    def _arm_qos(self) -> None:
        """Attach the fair scheduler + write-window caps + live-query caps
        once qos is on and a tenant table exists. Idempotent; reconfigs
        keep the armed scheduler's virtual clocks (weights re-read live
        through weight_fn)."""
        if not (self.qos_enabled and self.tenancy.configured):
            return
        gate = self.dispatch_gate
        if gate.fair is None:
            gate.fair = tnc.FairScheduler(weight_fn=self.tenancy.weight,
                                          metrics=self.metrics)
            gate.tenant_fn = tnc.current
        wb = self.write_batcher
        if wb is not None and wb.tenant_fn is None:
            wb.tenant_fn = tnc.current
            wb.tenant_cap_fn = lambda t: self.tenancy.window_share(
                t, wb.max_batch)
        self.live.registry = self.tenancy

    def _ns_view(self, snap, tenant: str):
        """The tenant's view of one snapshot, cached per (tenant, base
        cache token): token equality implies identical committed content,
        so one view object can serve every request of that (tenant,
        snapshot) pair — and attrs the engine caches on the snapshot
        object (known-uid sets) stay warm across them."""
        key = (tenant, qcache.snapshot_token(snap))
        with self._ns_lock:
            v = self._ns_views.get(key)
            if v is not None:
                self._ns_views.move_to_end(key)
                return v
        v = tnc.NamespacedSnapshot(snap, tenant)
        with self._ns_lock:
            self._ns_views[key] = v
            self._ns_views.move_to_end(key)
            while len(self._ns_views) > self._NS_VIEW_CAP:
                self._ns_views.popitem(last=False)
        return v

    def _schema_view(self):
        """The caller's schema: the raw SchemaState for the default
        namespace, a translating NamespacedSchema view for a tenant."""
        t = tnc.current()
        if t:
            return tnc.NamespacedSchema(self.store.schema, t)
        return self.store.schema

    def _admit_tenant(self, tenant: str) -> None:
        """API-edge quota admission (the shed discipline): over-quota
        tenants get typed ResourceExhausted before any device work —
        never a queue slot. Disarmed = one boolean check."""
        if self.qos_enabled and self.tenancy.configured:
            self.tenancy.admit(tenant)

    def set_memory_budget(self, budget_bytes: int) -> None:
        """Install/retarget the memory budget and ensure the background
        enforcement loop is running (admin.go live memory_mb reconfig —
        the loop re-reads the budget each tick, so later changes stick)."""
        self.memory_budget = int(budget_bytes)
        if self._enforcer_started or budget_bytes <= 0:
            return
        self._enforcer_started = True

        def loop():
            while True:
                time.sleep(10)
                try:
                    if self.memory_budget > 0:
                        self.enforce_memory(self.memory_budget)
                # dgraph: allow(except-seam) bg maintenance tick: next
                # tick retries; a dead enforcer must not kill the loop
                except Exception:
                    pass
        # dgraph: allow(ctxvar-copy) detached memory-enforcer bg loop
        threading.Thread(target=loop, daemon=True).start()

    # value-posting slots (lang/value fingerprints) carry the 1<<60 / 1<<61
    # tag bits (storage/postings.py lang_uid/value_fingerprint) and must never
    # be mistaken for uids when recovering the lease
    _SLOT_BITS = 1 << 60

    def _max_uid_in_store(self) -> int:
        ts = self.store.max_seen_commit_ts
        m = 0
        if self.store.paged:
            # segment-backed keys never enter by_pred: recover their max
            # from packed metadata without materializing any list
            def _uid_typed(attr):
                e = self.store.schema.get(attr)
                return e is None or e.type_id.name in ("UID", "DEFAULT")

            m = self.store.segment_max_uid(_uid_typed, self._SLOT_BITS)
        for (kind, attr), keys in self.store.by_pred.items():
            if kind not in (int(K.KeyKind.DATA), int(K.KeyKind.REVERSE)):
                continue
            entry = self.store.schema.get(attr)
            uid_typed = entry is None or entry.type_id.name == "UID" or \
                entry.type_id.name == "DEFAULT"
            for kb in keys:
                m = max(m, K.uid_of(kb))
                pl = self.store.lists.get(kb)
                if pl is None or kind != int(K.KeyKind.DATA) or not uid_typed:
                    continue
                bp = pl.base_packed
                if not pl.layers and not pl.uncommitted:
                    # packed metadata already carries the max object uid —
                    # decoding every list made cold-open O(edges). Slot-tagged
                    # values (>= _SLOT_BITS) force the slow path: the max
                    # REAL uid hides below them.
                    if not bp.nblocks:
                        continue
                    last = int(bp.block_last[-1])
                    if last < self._SLOT_BITS:
                        m = max(m, last)
                        continue
                u = pl.uids(max(ts, pl.base_ts))
                u = u[u < self._SLOT_BITS]
                if len(u):
                    m = max(m, int(u[-1]))
        return m

    # -- transactions --------------------------------------------------------

    # abandoned query-only txns (opened lazily by the gRPC surface, never
    # committed/discarded) are reaped once this many accumulate, else they
    # pin the oracle's conflict-GC watermark forever
    MAX_IDLE_TXNS = 1024
    # a pristine txn younger than this is never reaped: a slow-but-live
    # client that opened via a query and mutates later must not get
    # "unknown txn" just because 1024 other txns arrived in between
    IDLE_TXN_GRACE_S = 60.0

    def new_txn(self) -> TxnContext:
        st = self.zero.oracle.new_txn()
        ctx = TxnContext(start_ts=st.start_ts)
        with self._lock:
            self._txns[st.start_ts] = ctx
            if len(self._txns) > self.MAX_IDLE_TXNS:
                # pristine txns (no buffered writes) past the grace period
                # abort harmlessly, oldest-activity first: a later commit on
                # one returns "unknown txn", same as the reference's
                # expired-txn behavior
                cutoff = time.monotonic() - self.IDLE_TXN_GRACE_S
                pristine = sorted(
                    (ts for ts, c in self._txns.items()
                     if not c.keys and not c.inflight and ts != st.start_ts),
                    key=lambda ts: self._txns[ts].last_active)
                idle = [ts for ts in pristine
                        if self._txns[ts].last_active < cutoff]
                if not idle and len(self._txns) > 4 * self.MAX_IDLE_TXNS:
                    # burst pressure: >4x the soft bound opened inside one
                    # grace window — the bound (it protects the oracle's
                    # conflict-GC watermark) beats the grace period
                    idle = pristine
                for ts in idle[: max(len(idle) // 2, 1)]:
                    del self._txns[ts]
                    self.zero.oracle.abort(ts)
        return ctx

    def _drain_inflight(self, ctx, clamped: bool = True) -> None:
        """Wait out this txn's in-flight mutation applies, clamped to the
        caller's deadline — the lifeline contract: a budgeted commit or
        read never hangs behind a wedged apply (unbudgeted callers keep
        the exact old blocking wait). abort() drains UNclamped: it is the
        cleanup that unpins the oracle's conflict-GC watermark, and
        bailing on an expired budget would leak the keyed txn forever
        (the janitor only reaps pristine txns). Caller holds self._lock;
        the condition releases it while waiting."""
        while ctx.inflight:
            if not self._inflight_cv.wait(
                    dl.clamp(None) if clamped else None):
                dl.check("txn inflight drain")

    def commit(self, start_ts: int) -> int:
        """CommitOrAbort (edgraph/server.go:462). Returns commit_ts; raises
        TxnConflict after aborting the txn's buffered layers on conflict."""
        t0 = time.perf_counter()
        with self._span("commit", start_ts=int(start_ts)):
            with self._lock:
                ctx = self._txns.get(start_ts)
                if ctx is None:
                    raise mut.MutationError(f"unknown txn {start_ts}")
                # cut off new mutations first, then drain in-flight applies
                # — otherwise a steady write stream could starve this wait
                # and late mutations would silently ride the commit
                ctx.finishing = True
                self._drain_inflight(ctx)
                if self._txns.pop(start_ts, None) is None:
                    # a concurrent commit/abort won the race while we waited
                    raise mut.MutationError(f"unknown txn {start_ts}")
            # node lock RELEASED before the write window: the group-commit
            # batcher parks followers on events, and a follower parked
            # while holding the node lock would stall every other
            # committer's prep (defeating the window) and every reader.
            # Visibility stays exact: an in-flight commit is invisible
            # until the group apply advances the store watermarks, and
            # the ack below returns only after that apply — so a
            # committer's next read always observes its own write.
            try:
                wb = self.write_batcher
                if wb is None:
                    with self._lock:   # exact pre-window path
                        commit_ts = self._commit_solo(start_ts, ctx)
                else:
                    # dgraph: allow(ctxvar-copy) synchronous same-thread
                    # call (the window batcher, not an executor) — the
                    # caller's deadline/ledger ride into the entry itself
                    commit_ts = wb.submit(
                        start_ts, ctx.keys,
                        solo=lambda: self._commit_solo(start_ts, ctx))
            except TxnConflict:
                ctx.aborted = True
                self.metrics.counter("dgraph_num_aborts_total").inc()
                raise
            ctx.commit_ts = commit_ts
            # live-query wake: outside every lock, after the apply is
            # visible. One truthiness check when nobody subscribes.
            live = self.live
            if live is not None and live.active:
                live.notify_commit(commit_ts, ctx.preds)
            self.metrics.counter("dgraph_num_commits_total").inc()
            self.metrics.histogram("dgraph_commit_latency_s").observe(
                time.perf_counter() - t0)
            return commit_ts

    def _commit_solo(self, start_ts: int, ctx) -> int:
        """The exact per-commit path: one oracle decision, one per-commit
        WAL record with its own fsync. Runs for --no_write_batch, deadline
        bypasses, and write windows of one — unaccompanied traffic
        produces byte-identical logs to the pre-16 write path."""
        try:
            with otrace.span("zero:commit"):
                commit_ts = self.zero.oracle.commit(start_ts)
        except TxnConflict:
            self.store.abort(start_ts, ctx.keys)
            raise
        self.store.commit(start_ts, commit_ts, ctx.keys)
        return commit_ts

    def abort(self, start_ts: int) -> None:
        with self._lock:
            ctx = self._txns.get(start_ts)
            if ctx is not None:
                ctx.finishing = True
                self._drain_inflight(ctx, clamped=False)
            ctx = self._txns.pop(start_ts, None)
            self.zero.oracle.abort(start_ts)
            if ctx is not None:
                self.store.abort(start_ts, ctx.keys)

    # -- snapshots ----------------------------------------------------------

    def snapshot(self, read_ts: int | None = None) -> GraphSnapshot:
        with self._lock:
            if read_ts is None:
                read_ts = self.zero.oracle.read_ts()
            snap = self._assembler.snapshot(read_ts)
            if self.background_rollup and not self._rollup_started and \
                    self._assembler._overlays:
                self._start_rollup_loop()
            if self.mesh_exec is not None:
                # mesh placement at snapshot assembly — identity-cached at
                # the snapshot AND PredData level, so repeated reads keep
                # their qcache tokens and delta-overlay predicates keep
                # serving host-side until compaction folds a fresh base
                snap = self.mesh_exec.place_snapshot(snap)
            return snap

    # overlays older than this many seconds (or deeper than the stamp
    # ceiling) compact on the next tick
    ROLLUP_TICK_S = 1.0

    def _start_rollup_loop(self) -> None:
        self._rollup_started = True

        def loop():
            while not self._rollup_stop.wait(self.ROLLUP_TICK_S):
                try:
                    if self._assembler.compact_candidates():
                        self._assembler.compact(self._lock)
                # dgraph: allow(except-seam) next tick retries; queries
                # are unaffected by a failed compaction attempt
                except Exception:
                    pass
        # dgraph: allow(ctxvar-copy) detached compaction bg loop
        threading.Thread(target=loop, daemon=True,
                         name="dgt-rollup").start()

    def _invalidate_snapshots(self) -> None:
        with self._lock:
            self._assembler.invalidate()
        # schema/drop changes don't always mint a new read_ts, but they DO
        # mint new snapshot objects (fresh cache tokens), so stale task
        # results can never be served — clearing just releases the bytes
        if self.task_cache is not None:
            self.task_cache.clear()
        if self.result_cache is not None:
            self.result_cache.clear()

    # -- parsing --------------------------------------------------------------

    def _span(self, name: str, **attrs):
        """Root span when nothing is active on this execution context
        (direct API / HTTP entry — the sampling decision happens here);
        child span when nested (upsert inside query, commit inside
        mutate). An armed slow-query log force-samples every root: a slow
        query can only be identified AFTER it ran, so the threshold can
        never be honored from a 1% sample."""
        cur = otrace.current()
        if cur is not None:
            return self.tracer.start(name, parent=cur, attrs=attrs)
        return self.tracer.root(name, attrs=attrs,
                                force=self.slow_log.enabled)

    def _parse(self, q: str, variables: dict | None = None) -> dql.ParsedRequest:
        """Parse through the plan cache: hot query shapes skip the lexer +
        recursive-descent parser entirely. Parsed trees are read-only
        during execution (engine only builds NEW GraphQuery nodes), so one
        AST serves every replay."""
        with otrace.span("parse"):
            if self.plan_cache is not None:
                return self.plan_cache.parse(q, variables,
                                             ns=tnc.current())
            return dql.parse(q, variables)

    # -- Query ---------------------------------------------------------------

    def _read_view(self, start_ts: int | None) -> tuple[int, GraphSnapshot]:
        """Snapshot for a read: committed state at read_ts, with an open
        txn's own uncommitted layers overlaid when start_ts names one
        (posting/list.go:528 — StartTs == readTs visibility)."""
        if start_ts is not None:
            read_ts = start_ts
        else:
            with otrace.span("zero:read_ts"):
                read_ts = self.zero.oracle.read_ts()
        with self._lock:
            # only an EXPLICIT startTs continues an open txn: a fresh read's
            # ts may numerically equal a pending txn's start_ts and must not
            # see its uncommitted writes
            ctx = self._txns.get(start_ts) if start_ts is not None else None
            if ctx is not None:
                ctx.last_active = time.monotonic()
                # drain this txn's in-flight applies: the overlay build reads
                # the uncommitted layer dicts a concurrent apply mutates
                self._drain_inflight(ctx)
            if ctx is not None and ctx.preds:
                base = self.snapshot(read_ts)
                snap = GraphSnapshot(read_ts, device=self.device)
                # lazy base: share the pending fold-thunks —
                # dict(base.preds) would drop them via the CPython dict
                # fast path and untouched predicates would read as absent
                copier = getattr(base.preds, "lazy_copy", None)
                snap.preds = copier() if copier is not None \
                    else dict(base.preds)
                snap.metrics = getattr(base, "metrics", None)
                if ctx.overlay is not None and ctx.overlay[0] == ctx.version:
                    snap.preds.update(ctx.overlay[1])
                else:
                    built = {attr: build_pred(self.store, attr, read_ts,
                                              own_start_ts=read_ts,
                                              device=self.device)
                             for attr in sorted(ctx.preds)}
                    ctx.overlay = (ctx.version, built)
                    snap.preds.update(built)
                # overlay views are cacheable WITHIN one txn version: the
                # per-mutate version bump rotates the token, so a buffered
                # write can never be served from a pre-write cache entry
                snap.cache_token = ("txn", ctx.start_ts, ctx.version,
                                    qcache.snapshot_token(base))
            else:
                snap = self.snapshot(read_ts)
        return read_ts, snap

    def _deadline_scope(self, timeout_ms: float | None):
        """Deadline scope for one request: explicit timeout_ms beats the
        node default; 0/None = unbudgeted (a no-op scope)."""
        from dgraph_tpu_torch.utils import deadline as dl

        ms = self.default_timeout_ms if timeout_ms is None \
            else float(timeout_ms)
        return dl.scope(ms / 1000.0 if ms and ms > 0 else None)

    def _count_task(self, tq, res, dt: float) -> None:
        """Executor on_task hook: per-tablet read accounting — feeds BOTH
        the placement controller's load book and the residency manager's
        admission/eviction scores (the same rate×log2(size) signal)."""
        attr = tq.attr[1:] if tq.attr.startswith("~") else tq.attr
        # tablet accounting keys on STORAGE attrs: a tenant's task carries
        # its bare name, so translate before the load book / residency
        # touch (no-op for the default namespace)
        attr = tnc.prefix(tnc.current(), attr)
        out_bytes = 0.0
        if getattr(res, "dest_uids", None) is not None:
            out_bytes = 8.0 * len(res.dest_uids)
        self.tablet_book.record_read(attr, out_bytes=out_bytes, serve_s=dt)
        self.residency.touch(attr)

    def query(self, q: str, variables: dict | None = None,
              start_ts: int | None = None,
              read_only: bool = False,
              edge_limit: int | None = None,
              explain: bool = False,
              timeout_ms: float | None = None,
              _cost_endpoint: str = "query",
              _cost_subs: tuple = ()) -> tuple[dict, TxnContext]:
        """Parse + execute a DQL request (edgraph/server.go:373).

        read_only treats start_ts purely as a snapshot timestamp: it never
        joins an open txn's uncommitted overlay even if some pending txn
        happens to carry the same start_ts (read ts values come from the same
        oracle counter, so numeric collision is possible).

        edge_limit overrides the process-default traversed-edge budget for
        THIS request only (the --query_edge_limit flag, now per-request).

        explain=True adds an "explain" key to the returned dict: the
        physical plan tree with estimated vs actual cardinality per step
        (the ?explain=true HTTP surface). Explain requests bypass the
        whole-query result cache so the actuals are real."""
        # the root span covers the whole call, the bookkeeping in _query's
        # `finally` included: its duration is the call's wall time
        with self._span("query") as sp:
            return self._query(sp, q, variables, start_ts, read_only,
                               edge_limit, explain, timeout_ms,
                               _cost_endpoint, _cost_subs)

    def _query(self, sp, q, variables, start_ts, read_only, edge_limit,
               explain, timeout_ms, _cost_endpoint,
               _cost_subs) -> tuple[dict, TxnContext]:
        qtitle = q.strip().splitlines()[0][:120] if q.strip() else ""
        if sp:
            sp.set(query=qtitle)
        tr = self.traces.start("query", qtitle)
        m = self.metrics
        m.counter("dgraph_num_queries_total").inc()
        m.counter("dgraph_pending_queries_total").inc()
        m.meter("query").mark()
        t0 = time.perf_counter()
        err = ""
        # per-request cost ledger: the plan-shape key is the DQL text —
        # exactly what qcache.plan_key keys on — so /debug/top aggregates
        # replays of one shape across variable bindings
        # _cost_endpoint="live" tags standing-subscription re-evals so
        # /debug/top?endpoint=live ranks them next to foreground shapes
        tenant = tnc.current()
        lg = costs.CostLedger(endpoint=_cost_endpoint, shape=q,
                              tenant=tenant) \
            if self.cost_ledger else None
        if lg is not None and _cost_subs:
            # per-subscription attribution: the live manager
            # passes the ids of every subscription a coalesced re-eval
            # serves; /debug/top?group=sub apportions the record's cost
            # equally among them
            lg.subs = tuple(_cost_subs)
        try:
          with self._deadline_scope(timeout_ms), costs.scope(lg):
            self._admit_tenant(tenant)
            req = self._parse(q, variables)
            tr.printf("parsed: %d query blocks", len(req.queries))
            if req.upsert is not None:
                # implicit txn commits; an explicit one stays open for the
                # client's own commit/abort
                out, _uids, ctx = self.upsert(
                    req.upsert["query"], req.upsert["mutations"],
                    start_ts=start_ts, commit_now=start_ts is None)
                return out, ctx
            if req.schema_request is not None:
                return {"schema": self._schema_json(req.schema_request)}, \
                    TxnContext(start_ts=0)
            if read_only and start_ts is not None:
                read_ts, snap = start_ts, self.snapshot(start_ts)
            else:
                read_ts, snap = self._read_view(start_ts)
            if tenant:
                # namespace seam: the executor, planner, caches, and
                # batcher all run on the tenant's unprefixed vocabulary
                # while reading only the tenant's storage tablets
                snap = self._ns_view(snap, tenant)
            schema = self._schema_view()
            sp.set(read_ts=int(read_ts))
            tr.printf("snapshot at ts %d (%d preds)", read_ts, len(snap.preds))
            pf_attrs = None
            if not req.mutations:
                # plan-driven FOLD prefetch: pending lazy folds of the
                # plan's read set resolve on the shared fold pool BEFORE
                # the result-token computation, so the cache-key walk below
                # JOINS in-flight folds instead of folding serially. Issued
                # only when something is actually pending — a warm result
                # cache hit must stay free of prefetch work (the upload leg
                # runs after the cache miss, below)
                pf_attrs = qcache.plan_attrs(req)
                is_pending = getattr(snap.preds, "is_pending", None)
                if pf_attrs and is_pending is not None:
                    # ONLY the pending attrs: the early call must not run
                    # the upload leg for folded tablets a cache hit never
                    # needs (and the miss-path call below would re-submit)
                    pend = [a for a in pf_attrs if is_pending(a)]
                    if pend:
                        with otrace.span("prefetch"):
                            self.residency.prefetch(pend, snap)
            # whole-query result tier: keyed on (plan key, per-predicate
            # token tuple of the plan's read set, edge budget). A commit to
            # predicate P rotates only P's PredData token, so replays that
            # never read P keep their cache heat; plans whose read set
            # isn't statically derivable (explicit uids, expand, shortest)
            # key on the snapshot object and rotate on every commit /
            # alter / drop / txn-overlay version bump as before
            rkey = None
            if self.result_cache is not None and not req.mutations \
                    and not explain:
                with otrace.span("result_cache"):
                    pk = qcache.plan_key(q, variables, tenant)
                    if pk is not None:
                        # the EFFECTIVE budget is part of the key: a
                        # shrunk budget (per-request or via
                        # set_query_edge_limit) must re-execute, not serve
                        # a result computed under a larger one (and vice
                        # versa)
                        from dgraph_tpu_torch.query import engine as _eng

                        eff = edge_limit if edge_limit is not None \
                            else _eng.MAX_QUERY_EDGES
                        rkey = (pk, qcache.result_token(req, snap), eff)
                        cached = self.result_cache.get(rkey)
                        if cached is not None:
                            tr.printf("result cache hit")
                            sp.set(result_cache="hit")
                            costs.note("result_cache_hit")
                            return cached, TxnContext(start_ts=read_ts)
            # cost-based plan (order decisions only): cached alongside the
            # AST, keyed on the per-predicate stats tokens of the plan's
            # read set — a commit to P rebuilds only plans that read P
            plan = None
            recorder = {} if explain else None
            if self.planner_enabled and not req.mutations:
                from dgraph_tpu_torch.query import planner as plmod

                def build():
                    return plmod.build_plan(req, snap, schema,
                                            metrics=self.metrics,
                                            top_k=self.stats_top_k,
                                            trace=tr)
                try:
                    with otrace.span("plan"):
                        plan = (self.plan_cache.plan(q, variables, req,
                                                     snap, build, ns=tenant)
                                if self.plan_cache is not None else build())
                except Exception:
                    # stats/planner trouble must never fail a query —
                    # parse-order execution is always available
                    self.metrics.counter(
                        "dgraph_planner_fallbacks_total").inc()
                    plan = None
                if plan is not None and sp:
                    # compact decision summary for the slow-query log;
                    # per-step est-vs-actual rides Plan.record span events
                    sp.set(plan={
                        "root_swaps": len(plan.root_swap),
                        "filter_reorders": len(plan.and_order),
                        "sibling_reorders": len(plan.child_order),
                        "cutover_overrides": len(plan.cutover)})
            if self.residency.enabled and pf_attrs:
                # warm→HBM UPLOAD prefetch: after the result cache missed,
                # start async uploads for the read set so the transfer
                # overlaps the preceding host work / device step
                with otrace.span("prefetch"):
                    self.residency.prefetch(pf_attrs, snap)
            out = Executor(snap, schema,
                           cache=self.task_cache, gate=self.dispatch_gate,
                           edge_limit=edge_limit, plan=plan,
                           explain=recorder,
                           mesh=self.mesh_exec,
                           batcher=self.batcher,
                           on_task=self._count_task).execute(req)
            tr.printf("executed")
            if rkey is not None:
                self.result_cache.put(rkey, out)
            if explain:
                from dgraph_tpu_torch.query import planner as plmod

                out = dict(out)
                out["explain"] = (plmod.render_explain(plan, recorder)
                                  if plan is not None
                                  else {"planner": "off"})
            return out, TxnContext(start_ts=read_ts)
        except BaseException as e:
            # EVERY failure shape finishes the breadcrumb trace with its
            # error, exactly once, via the finally below — including
            # TxnConflict from the upsert path and non-Exception bases
            err = str(e) or type(e).__name__
            from dgraph_tpu_torch.utils.deadline import DeadlineExceeded

            if isinstance(e, DeadlineExceeded):
                m.counter("dgraph_deadline_exceeded_total").inc()
            raise
        finally:
            m.counter("dgraph_pending_queries_total").dec()
            m.histogram("dgraph_query_latency_s").observe(
                time.perf_counter() - t0,
                exemplar=sp.trace_id or None)
            if not self._first_query_done and not err:
                self._first_query_done = True
                m.counter("dgraph_first_query_ms").set(
                    (time.perf_counter() - self._birth) * 1e3)
            self._finish_cost(lg, sp)
            self.traces.finish(tr, error=err)

    def _finish_cost(self, lg, sp) -> None:
        """Close one request's cost ledger: observe the aggregatable
        dgraph_query_cost_* histograms (exemplar = the request's sampled
        trace id, resolvable at /debug/traces/<id>), admit the record to
        the /debug/top window, and route a flagged cost regression into
        the slow-query ring — even when the query finished UNDER
        --slow_query_ms (that is the point: a shape that regressed from
        2ms to 40ms never crosses a 500ms threshold)."""
        if lg is None:
            return
        m = self.metrics
        if not lg.tasks and lg.device_ms == 0.0 and not lg.groups:
            # trivial record (whole-result cache hit, schema request,
            # parse error): nothing executed — skip record assembly and
            # the cost observations entirely. This keeps the armed warm
            # path within the <2% bench `obs` gate AND keeps zero-cost
            # replays from diluting the cost distributions and the
            # per-shape EWMA baselines into flagging every real
            # execution as a regression.
            return
        # counted AFTER the trivial skip: the counter means "records
        # admitted to the cost surfaces", matching /debug/metrics
        m.counter("dgraph_cost_records_total").inc()
        lg.finish()
        rec = lg.to_dict()
        total = rec["total"]
        # per-tenant attribution + quota debit: every admitted
        # record's ledger units debit its tenant's buckets and advance
        # the dgraph_tenant_* labeled series. Cache hits are trivial
        # records (skipped above): they consumed no device resources, so
        # they cost nothing — admission still gated them.
        if lg.tenant or self.tenancy.configured:
            self.tenancy.debit(
                lg.tenant,
                device_ms=float(total["device_ms"]),
                edges=float(total["edges"]),
                bytes_=float(total["h2d"] + total["d2h"]))
        tid = sp.trace_id if sp else ""
        ex = tid or None
        m.histogram("dgraph_query_cost_device_ms").observe(
            float(total["device_ms"]), exemplar=ex)
        m.histogram("dgraph_query_cost_edges").observe(
            float(total["edges"]), exemplar=ex)
        m.histogram("dgraph_query_cost_bytes").observe(
            float(total["h2d"] + total["d2h"]), exemplar=ex)
        flag = self.cost_book.record(lg.shape, lg.endpoint, tid, rec)
        if flag is not None:
            m.counter("dgraph_cost_regressions_total").inc()
            self.slow_log.record({
                "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
                "root": "cost_regression",
                "trace_id": tid,
                "query": lg.shape[:2000],
                "elapsed_ms": total["wall_ms"],
                **flag})

    def analytics(self, kind: str, pred: str, *, damping: float = 0.85,
                  tol: float = 1e-6, max_iters: int = 100, top: int = 20,
                  timeout_ms: float | None = None,
                  start_ts: int | None = None) -> dict:
        """Whole-graph analytics over one uid predicate's tablet
        (query/analytics.py): PageRank / connected components / triangle
        count as device-resident loops on the mesh, host
        oracle fallback when the tablet is overlay/residency-deferred or
        the node runs without a mesh. Same request discipline as query():
        span + deadline scope + cost ledger + DispatchGate."""
        from dgraph_tpu_torch.query import analytics as an

        sp = self._span("analytics", kind=kind, pred=pred)
        m = self.metrics
        m.meter("analytics").mark()
        t0 = time.perf_counter()
        tenant = tnc.current()
        lg = costs.CostLedger(endpoint="analytics",
                              shape=f"analytics:{kind}:{pred}",
                              tenant=tenant) \
            if self.cost_ledger else None
        try:
            with sp, self._deadline_scope(timeout_ms), costs.scope(lg):
                self._admit_tenant(tenant)
                read_ts, snap = self._read_view(start_ts)
                if tenant:
                    snap = self._ns_view(snap, tenant)
                sp.set(read_ts=int(read_ts))
                rev = pred.startswith("~")
                pd = snap.pred(pred[1:] if rev else pred)
                csr = (pd.rev_csr if rev else pd.csr) \
                    if pd is not None else None
                if csr is None:
                    raise ValueError(
                        f"analytics: predicate {pred!r} has no uid "
                        f"edges")
                if self.residency.enabled:
                    self.residency.prefetch(
                        [pred[1:] if rev else pred], snap)
                lga = costs.current()
                if lga is not None:
                    lga.add_task(pred[1:] if rev else pred, 0)
                out = an.run(kind, csr, mesh=self.mesh_exec,
                             gate=self.dispatch_gate, metrics=m,
                             damping=damping, tol=tol,
                             max_iters=max_iters, top=top)
                out["pred"] = pred
                sp.set(device=out["device"], nodes=out["nodes"],
                       edges=out["edges"])
                return out
        finally:
            m.histogram("dgraph_analytics_latency_s").observe(
                time.perf_counter() - t0,
                exemplar=sp.trace_id or None)
            self._finish_cost(lg, sp)

    def upsert(self, q: str, mutations: list[dict],
               variables: dict | None = None, start_ts: int | None = None,
               commit_now: bool = False) -> tuple[dict, dict, TxnContext]:
        """Query-then-conditionally-mutate in one txn (edgraph/server.go
        doQueryInUpsert + gql/upsert.go). `mutations` entries carry any of
        cond / set / delete / set_json / delete_json (text cond is the inside
        of @if(...)). Returns (query json, assigned uids, ctx)."""
        self.metrics.counter("dgraph_num_upserts_total").inc()
        own_txn = start_ts is None
        with self._lock:
            if own_txn:
                ctx = self.new_txn()
            else:
                ctx = self._txns.get(start_ts)
                if ctx is None:
                    raise mut.MutationError(f"unknown txn {start_ts}")
        with self._span("upsert", mutations=len(mutations)):
            try:
                out: dict = {}
                vars_map: dict = {}
                if q.strip():
                    _, snap = self._read_view(ctx.start_ts)
                    tenant = tnc.current()
                    if tenant:
                        snap = self._ns_view(snap, tenant)
                    ex = Executor(snap, self._schema_view(),
                                  cache=self.task_cache,
                                  gate=self.dispatch_gate,
                                  mesh=self.mesh_exec,
                                  batcher=self.batcher,
                                  on_task=self._count_task)
                    out = ex.execute(self._parse(q, variables))
                    vars_map = ex.vars
                uid_map: dict = {}
                for m in mutations:
                    cond = m.get("cond", "")
                    if cond and not ups.eval_cond(cond, vars_map):
                        continue
                    nq_set = ups.expand(rdf.parse(m.get("set", "")), vars_map)
                    nq_del = ups.expand(rdf.parse(m.get("delete", "")),
                                        vars_map)
                    if m.get("set_json") is not None:
                        nq_set += mut.nquads_from_json(
                            m["set_json"], Op.SET,
                            schema=self._schema_view())
                    if m.get("delete_json") is not None:
                        nq_del += mut.nquads_from_json(
                            m["delete_json"], Op.DEL,
                            schema=self._schema_view())
                    if not nq_set and not nq_del:
                        continue   # cond met but every quad's var was empty
                    res = self.mutate_quads(nq_set, nq_del, commit_now=False,
                                            start_ts=ctx.start_ts)
                    uid_map.update(res.uids)
            except BaseException:
                if own_txn:
                    # don't leak the implicit txn (it would pin the oracle's
                    # conflict-GC watermark); an explicit txn stays open for
                    # the client to retry or abort
                    self.abort(ctx.start_ts)
                raise
            if commit_now:
                self.commit(ctx.start_ts)
            return out, uid_map, ctx

    def _schema_json(self, preds: list[str]) -> list[dict]:
        from dgraph_tpu_torch.utils.schema import schema_json

        # the tenant's schema view lists + strips its own entries, so a
        # schema{} response never leaks another namespace (or the prefix)
        return schema_json(self._schema_view(), preds)

    # -- Mutate --------------------------------------------------------------

    def mutate(self, set_nquads: str = "", del_nquads: str = "",
               set_json=None, delete_json=None, commit_now: bool = False,
               start_ts: int | None = None,
               timeout_ms: float | None = None) -> MutationResult:
        """Buffer (and optionally commit) one mutation (server.go:267)."""
        nquads_set = rdf.parse(set_nquads) if set_nquads else []
        nquads_del = rdf.parse(del_nquads) if del_nquads else []
        if set_json is not None:
            nquads_set += mut.nquads_from_json(set_json, Op.SET,
                                               schema=self._schema_view())
        if delete_json is not None:
            nquads_del += mut.nquads_from_json(delete_json, Op.DEL,
                                               schema=self._schema_view())
        return self.mutate_quads(nquads_set, nquads_del,
                                 commit_now=commit_now, start_ts=start_ts,
                                 timeout_ms=timeout_ms)

    def mutate_quads(self, nquads_set, nquads_del=(), *,
                     commit_now: bool = False,
                     start_ts: int | None = None,
                     timeout_ms: float | None = None) -> MutationResult:
        """Mutate with pre-parsed NQuads (the loaders' entry — skips text
        parsing; dgraph/cmd/live/batch.go feeds api.Mutation.Set directly)."""
        nquads_set = list(nquads_set)
        nquads_del = list(nquads_del)
        if not nquads_set and not nquads_del:
            raise mut.MutationError("empty mutation")
        tenant = tnc.current()
        if tenant:
            # namespace seam for writes: the tenant's quads land on its
            # own storage attrs. "S * *" wildcard deletion reads the
            # store to learn its footprint — a tenant must not discover
            # (or delete) predicates outside its namespace, so it gets
            # the typed error instead.
            self._admit_tenant(tenant)
            for nq in nquads_set + nquads_del:
                if nq.predicate == "*":
                    raise tnc.NamespaceError(
                        "wildcard predicate deletion (S * *) is not "
                        "available inside a tenant namespace")
                nq.predicate = tnc.prefix(tenant, nq.predicate)
        tr = self.traces.start(
            "mutate", f"{len(nquads_set)} set / {len(nquads_del)} del")
        sp = self._span("mutate", set=len(nquads_set),
                        delete=len(nquads_del))
        m = self.metrics
        m.counter("dgraph_num_mutations_total").inc()
        m.counter("dgraph_active_mutations_total").inc()
        m.meter("mutate").mark()
        t0 = time.perf_counter()
        err = ""
        try:
          with sp, self._deadline_scope(timeout_ms):
            with self._lock:
                if start_ts is None:
                    ctx = self.new_txn()
                else:
                    ctx = self._txns.get(start_ts)
                    if ctx is None or ctx.finishing:
                        raise mut.MutationError(f"unknown txn {start_ts}")
                # inflight pins the txn: commit/abort of this start_ts wait
                # until apply completes, so they can't interleave mid-apply
                # and orphan uncommitted layers (an invariant kept
                # WITHOUT serializing all mutations behind one lock)
                ctx.inflight += 1
                ctx.last_active = time.monotonic()
            applied = False
            try:
                uid_map = mut.assign_uids(nquads_set + nquads_del,
                                          self.zero.uids)
                edges = mut.to_edges(nquads_set, uid_map, Op.SET) + \
                    mut.to_edges(nquads_del, uid_map, Op.DEL)
                # conflict-keyed parallel apply (worker/scheduler.go:34-95):
                # disjoint (attr, uid) footprints run concurrently; shared
                # footprints serialize in arrival order. Objects of uid edges
                # are in the footprint too (reverse/count maintenance does
                # read-modify-write on the object side). `S * *` deletes
                # only learn their footprint by reading the store at apply
                # time, so they take the scheduler exclusively.
                exclusive = any(e.attr == "*" for e in edges)
                skeys: set[int] = set()
                if not exclusive:
                    for e in edges:
                        skeys.add(hash((e.attr, e.subject)))
                        if e.object_uid:
                            skeys.add(hash((e.attr, e.object_uid)))
                touched, conflict, preds = self._sched.run(
                    skeys, lambda: mut.apply_mutations(
                        self.store, edges, ctx.start_ts),
                    exclusive=exclusive)
                applied = True
            finally:
                with self._lock:
                    try:
                        if applied:
                            ctx.keys += touched
                            ctx.conflict_keys += conflict
                            ctx.preds |= preds
                            ctx.version += 1
                            self.zero.oracle.track(ctx.start_ts, conflict,
                                                   sorted(preds))
                            m.counter("dgraph_posting_writes_total").inc(
                                len(touched))
                    finally:
                        # unconditional: a parked commit/abort must wake even
                        # if oracle bookkeeping above raised
                        ctx.inflight -= 1
                        self._inflight_cv.notify_all()
            from collections import Counter

            edge_counts = Counter(e.attr for e in edges)
            for p in preds:
                self.zero.should_serve(p)
                self.tablet_book.record_write(p, n=edge_counts[p] or 1)
            res = MutationResult(uids=uid_map, context=ctx)
            if commit_now:
                self.commit(ctx.start_ts)
            return res
        except BaseException as e:
            err = str(e) or type(e).__name__
            raise
        finally:
            m.counter("dgraph_active_mutations_total").dec()
            m.histogram("dgraph_mutation_latency_s").observe(
                time.perf_counter() - t0,
                exemplar=sp.trace_id or None)
            self.traces.finish(tr, error=err)

    def run_request(self, q: str, variables: dict | None = None,
                    commit_now: bool = True) -> tuple[dict, MutationResult | None]:
        """One combined DQL request: query blocks and/or mutation blocks
        through the same entry (the `{set {...}}` surface)."""
        req = self._parse(q, variables)
        mres = None
        if req.mutations:
            sets, dels = [], []
            for m in req.mutations:
                (sets if m["op"] == "set" else dels).append(m["rdf"])
            mres = self.mutate(set_nquads="\n".join(sets),
                               del_nquads="\n".join(dels),
                               commit_now=commit_now)
        out = {}
        if req.queries:
            out, _ = self.query(q, variables)
        return out, mres

    # -- Alter ---------------------------------------------------------------

    def alter(self, schema_text: str = "", drop_attr: str = "",
              drop_all: bool = False) -> None:
        """Schema mutations + drops (server.go:213), with the reindex
        pipeline (worker/mutation.go:97 runSchemaMutation)."""
        self.metrics.counter("dgraph_num_alters_total").inc()
        title = ("drop_all" if drop_all else
                 f"drop {drop_attr}" if drop_attr else
                 (schema_text.strip().splitlines() or [""])[0][:120])
        tr = self.traces.start("alter", title)
        err = ""
        try:
          with self._span("alter", op=title):
            self._alter_locked(schema_text, drop_attr, drop_all)
        except BaseException as e:
            err = str(e) or type(e).__name__
            raise
        finally:
            self.traces.finish(tr, error=err)

    def _alter_locked(self, schema_text: str, drop_attr: str,
                      drop_all: bool) -> None:
        tenant = tnc.current()
        with self._lock:
            if drop_all:
                attrs = set(self.store.predicates()) | \
                    set(self.store.schema.predicates())
                if tenant:
                    # a tenant's drop_all empties ITS namespace only; the
                    # default (admin) namespace keeps the whole-store drop
                    attrs = {a for a in attrs
                             if tnc.split(a)[0] == tenant}
                for attr in attrs:
                    self.store.delete_predicate(attr)
                self._invalidate_snapshots()
                return
            if drop_attr:
                self.store.delete_predicate(tnc.prefix(tenant, drop_attr))
                self._invalidate_snapshots()
                return
            for e in parse_schema(schema_text):
                if tenant:
                    e.predicate = tnc.prefix(tenant, e.predicate)
                old = self.store.schema.get(e.predicate)
                self.store.set_schema(e)
                if idx.needs_reindex(old, e):
                    read_ts = self.zero.oracle.read_ts()
                    commit_ts = self.zero.oracle.timestamps(1)
                    idx.rebuild_index(self.store, e.predicate, read_ts, commit_ts)
                    idx.rebuild_reverse(self.store, e.predicate, read_ts, commit_ts)
                    idx.rebuild_count(self.store, e.predicate, read_ts, commit_ts)
            self._invalidate_snapshots()

    # -- memory management ---------------------------------------------------

    def enforce_memory(self, budget_bytes: int) -> dict:
        """Bring host posting-list memory under budget (the --memory_mb
        contract; reference posting/lists.go:123-180 periodic commit +
        LRU eviction under AllottedMemory).

        Levers, cheapest first:
        1. roll up the layer-heaviest lists below the min-pending watermark
           (folds Python layer dicts into the packed numpy base — the same
           compaction the reference's periodic commit achieves);
        2. drop task-result cache entries (pure recompute cost, no
           correctness state);
        3. drop cached device snapshots and the predicate build cache
           (rebuilt read-through on the next query).
        Never touches uncommitted layers or layers a live txn could read.
        """
        stats = self.store.memory_stats()
        rolled = 0
        if stats["bytes"] > budget_bytes and stats["layers"]:
            pend = self.zero.oracle.min_pending()
            upto = self.store.max_seen_commit_ts if pend is None \
                else min(pend - 1, self.store.max_seen_commit_ts)
            if upto > 0:
                with self.store._lock:
                    pls = list(self.store.lists.values())
                pls.sort(key=lambda p: p.layer_count(), reverse=True)
                for pl in pls:
                    if pl.layer_count() == 0:
                        break
                    pl.rollup(upto)
                    rolled += 1
                    if rolled % 256 == 0 and \
                            self.store.memory_stats()["bytes"] <= budget_bytes:
                        break
                stats = self.store.memory_stats()
        cache_evicted = 0
        cache_bytes = (self.task_cache.bytes if self.task_cache else 0) + \
            (self.result_cache.bytes if self.result_cache else 0)
        if cache_bytes and stats["bytes"] + cache_bytes > budget_bytes:
            over = stats["bytes"] + cache_bytes - budget_bytes
            if self.result_cache is not None:
                cache_evicted += self.result_cache.evict_to(
                    max(0, self.result_cache.bytes - over))
                over = stats["bytes"] + \
                    (self.task_cache.bytes if self.task_cache else 0) - \
                    budget_bytes
            if self.task_cache is not None and over > 0:
                cache_evicted += self.task_cache.evict_to(
                    max(0, self.task_cache.bytes - over))
        # overlay rows are pure acceleration state: force-compact them back
        # into folded bases before the invalidate hammer (keeps cache heat)
        compacted = 0
        overlay_bytes = self._assembler.overlay_bytes()
        if overlay_bytes and stats["bytes"] + overlay_bytes > budget_bytes:
            compacted = self._assembler.compact(self._lock, force=True)
            overlay_bytes = self._assembler.overlay_bytes()
        # device-byte accounting routes through the ResidencyManager:
        # fold_bytes is the HOST footprint of every live folded PredData —
        # CSR columns, value tables, token indexes and vector embedding
        # matrices. The manager also re-enforces its own device budget
        # here.
        fold_bytes = self.residency.host_bytes()
        res_evicted = 0
        if self.residency.enabled:
            res_evicted = self.residency.evict_to(self.residency.budget)
        dropped_snaps = 0
        if stats["bytes"] + fold_bytes > budget_bytes:
            with self._lock:
                dropped_snaps = self._assembler.invalidate()
            # dropped PredData frees its device buffers too (weakref
            # entries unregister as the folds are collected); make any
            # survivors' device bytes visible immediately. fold_bytes
            # stays the MEASURED value — the number that triggered the
            # drop, not the post-drop remainder.
            self.residency.usage()
        self.metrics.counter("dgraph_memory_bytes").set(stats["bytes"])
        return {"bytes": stats["bytes"], "lists": stats["lists"],
                "layers": stats["layers"], "rolled_up": rolled,
                "dropped_caches": dropped_snaps,
                "task_cache_evicted": cache_evicted,
                "overlay_bytes": overlay_bytes,
                "overlays_compacted": compacted,
                "fold_bytes": fold_bytes,
                "residency_evicted": res_evicted,
                "residency": self.residency.usage()}

    # -- live queries --------------------------------------------------------

    def subscribe(self, q: str, variables: dict | None = None, *,
                  cursor: int | None = None, queue_max: int | None = None):
        """Register a standing query (the gRPC/embedded surface): returns a
        live.Subscription iterator whose first event is init (full result
        at its watermark), ack (reconnect cursor proven unchanged by the
        delta journal), or a typed resync; subsequent events are diffs at
        the commit watermark they reflect."""
        return self.live.subscribe(q, variables, cursor=cursor,
                                   queue_max=queue_max)

    # -- ops -----------------------------------------------------------------

    def health(self) -> dict:
        return {"status": "healthy", "version": "dgraph-tpu",
                "maxAssigned": self.zero.oracle.max_assigned}

    def state(self) -> dict:
        return self.zero.state()

    def close(self) -> None:
        live = getattr(self, "live", None)
        if live is not None:
            live.close()
        if getattr(self, "devprof", None) is not None:
            from dgraph_tpu_torch.obs import devprof as devprof_mod

            devprof_mod.unregister(self.devprof)
        self._rollup_stop.set()
        self.slow_log.close()
        self.residency.close()
        self.store.close()
