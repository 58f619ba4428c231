"""Metrics + request tracing (reference: x/metrics.go expvar counters at
/debug/vars, golang.org/x/net/trace request traces at /debug/requests with
sampled LazyPrintf breadcrumbs, edgraph/server.go:289,388).

Copy of dgraph_tpu/utils/metrics.py for the PyTorch port.

Design: one Registry per server Node (tests run many embedded nodes — a
process-global expvar table like the reference's would bleed counts between
them). Counters take the GIL-side lock only on read-modify-write; histograms
keep a bounded ring of recent samples and compute percentiles on demand
rather than maintaining buckets (the /debug surface is low-QPS)."""

from __future__ import annotations

import bisect
import random
import threading
import time
from collections import deque


class Counter:
    __slots__ = ("_v", "_lock")

    def __init__(self) -> None:
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: int = 1) -> None:
        self.inc(-n)

    def set(self, v: int) -> None:
        """Gauge-style overwrite (dgraph_memory_bytes etc.)."""
        with self._lock:
            self._v = v

    @property
    def value(self) -> int:
        return self._v


def exp_buckets(start: float, factor: float, count: int) -> tuple:
    """Exponential bucket upper bounds: start * factor**i, i in [0, count).
    FIXED bounds are the whole point: histograms with identical
    bounds merge EXACTLY across nodes and over time — sum the per-bucket
    counts, _sum, and _count — which ring-sample quantiles never can."""
    out = []
    v = float(start)
    for _ in range(max(int(count), 1)):
        out.append(v)
        v *= factor
    return tuple(out)


# shared default bucket schemes, picked by metric-name suffix so every
# node exposes the same bounds for the same metric (merge exactness)
BUCKETS_SECONDS = exp_buckets(0.0005, 2.0, 16)       # 0.5ms .. ~16s
BUCKETS_MS = exp_buckets(0.05, 2.0, 18)              # 0.05ms .. ~6.5s
BUCKETS_BYTES = exp_buckets(256, 4.0, 14)            # 256B .. ~17GB
BUCKETS_COUNT = exp_buckets(1, 4.0, 16)              # 1 .. ~1e9


def default_buckets(name: str) -> tuple:
    if name.endswith("_s"):
        return BUCKETS_SECONDS
    if name.endswith("_ms"):
        return BUCKETS_MS
    if name.endswith("_bytes"):
        return BUCKETS_BYTES
    return BUCKETS_COUNT


class Histogram:
    """Fixed-bucket cumulative histogram + a bounded ring of recent
    samples.

    The buckets (`le` upper bounds, +Inf implicit) are the Prometheus
    exposition and the fleet-merge unit: identical bounds merge exactly
    across nodes (obs/prom.py renders them, Registry.export ships them).
    The ring keeps the /debug/metrics percentile readout (quantiles are
    NOT on /metrics anymore — they cannot be aggregated).

    Each bucket keeps at most one trace EXEMPLAR — the most recent
    observation that carried a sampled trace id — rendered in OpenMetrics
    `# {trace_id="..."} value ts` syntax so an operator can jump from a
    latency bucket straight to the trace that landed in it."""

    __slots__ = ("_ring", "_lock", "count", "total", "bounds",
                 "bucket_counts", "exemplars")

    def __init__(self, cap: int = 2048, buckets: tuple | None = None) -> None:
        self._ring: deque[float] = deque(maxlen=cap)
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.bounds: tuple = tuple(buckets) if buckets else BUCKETS_COUNT
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        # per-bucket (trace_id, value, unix_ts) — newest sampled wins
        self.exemplars: list[tuple | None] = [None] * (len(self.bounds) + 1)

    def _bucket_of(self, v: float) -> int:
        return bisect.bisect_left(self.bounds, v)

    def observe(self, v: float, exemplar: str | None = None) -> None:
        b = self._bucket_of(v)
        with self._lock:
            self._ring.append(v)
            self.count += 1
            self.total += v
            self.bucket_counts[b] += 1
            if exemplar:
                self.exemplars[b] = (exemplar, v, time.time())

    def snapshot(self) -> dict:
        """count is lifetime; mean and percentiles all describe the same
        recent window (the ring) so the distribution is self-consistent."""
        with self._lock:
            vals = sorted(self._ring)
            count = self.count
        if not vals:
            return {"count": count, "mean": 0.0}
        pick = lambda q: vals[min(len(vals) - 1, int(q * len(vals)))]
        return {"count": count,
                "mean": round(sum(vals) / len(vals), 6),
                "p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99),
                "max": vals[-1]}

    def export(self) -> dict:
        """Mergeable state: bounds + per-bucket counts + sum/count (+ the
        exemplars, which a merge keeps newest-first per bucket)."""
        with self._lock:
            return {"bounds": list(self.bounds),
                    "counts": list(self.bucket_counts),
                    "sum": self.total, "count": self.count,
                    "exemplars": [list(e) if e else None
                                  for e in self.exemplars]}


class Meter:
    """Sliding-window event rate (per-endpoint QPS for /debug/metrics).
    Marks keep a bounded timestamp ring; rate() PRUNES timestamps older
    than the retention window from the left (they can never count again)
    instead of rescanning the full ring per call — O(expired + recent),
    not O(cap). The ring bounds memory, so a sustained burst beyond `cap`
    events/window under-reports — `dropped` counts every mark that
    evicted a STILL-LIVE timestamp (one inside the retention window), so
    the QPS readout says when it is lying (snapshot())."""

    __slots__ = ("_ring", "_lock", "window", "dropped")

    def __init__(self, window: float = 10.0, cap: int = 8192) -> None:
        self.window = window
        self._ring: deque[float] = deque(maxlen=cap)
        self._lock = threading.Lock()
        self.dropped = 0

    def mark(self) -> None:
        now = time.monotonic()
        with self._lock:
            ring = self._ring
            if len(ring) == ring.maxlen and ring[0] >= now - self.window:
                # the append below evicts a mark the window still needs:
                # the rate is about to under-report
                self.dropped += 1
            ring.append(now)

    def snapshot(self) -> dict:
        """Rate plus its honesty bit: dropped > 0 means the window
        overflowed the ring and the qps number is a floor, not a rate."""
        return {"qps": self.rate(), "dropped": self.dropped}

    def rate(self, window: float | None = None) -> float:
        """Events/sec over the trailing `window` seconds, clamped to the
        meter's retention window: pruning discards marks older than
        self.window, so a wider request would silently undercount — it
        gets the full-retention rate instead."""
        w = min(window or self.window, self.window)
        now = time.monotonic()
        with self._lock:
            ring = self._ring
            # retention is the DEFAULT window: a narrower custom window
            # must not discard marks the next default-window call needs
            retain = now - self.window
            while ring and ring[0] < retain:
                ring.popleft()
            if w >= self.window:
                n = len(ring)
            else:
                cut = now - w
                n = 0
                for t in reversed(ring):   # recent marks sit at the right
                    if t < cut:
                        break
                    n += 1
        return round(n / w, 3)


class KeyedGauge:
    """Per-key integer gauges under one metric name (Prometheus labeled
    gauge shape) — per-predicate overlay depth, per-tablet sizes. Zero
    values drop their key so an idle predicate doesn't grow the map.

    `labels` names multi-dimensional keys: when set, keys are the label
    VALUES joined with '|' (e.g. labels=("pred", "group"), key
    "follows|2") and obs/prom.py renders them as separate Prometheus
    labels instead of the default key="..."."""

    __slots__ = ("_vals", "_lock", "labels")

    def __init__(self, labels: tuple[str, ...] | None = None) -> None:
        self._vals: dict[str, int] = {}
        self._lock = threading.Lock()
        self.labels = labels

    def set(self, key: str, v: int) -> None:
        with self._lock:
            if v:
                self._vals[key] = v
            else:
                self._vals.pop(key, None)

    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            v = self._vals.get(key, 0) + n
            if v:
                self._vals[key] = v
            else:
                self._vals.pop(key, None)

    def get(self, key: str) -> int:
        # dict reads race dict writes in free-threaded builds, and even on
        # the GIL a concurrent resize can surface torn iteration states —
        # reads take the same lock the writers do
        with self._lock:
            return self._vals.get(key, 0)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._vals)


class Registry:
    """Named metrics with the reference's dgraph_* vocabulary pre-registered
    (x/metrics.go:27-76), plus the serving-layer counters (plan /
    task caches, singleflight, dispatch gate)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, Counter] = {}
        self.histograms: dict[str, Histogram] = {}
        self.meters: dict[str, Meter] = {}
        self.keyed_gauges: dict[str, KeyedGauge] = {}
        for name in ("dgraph_num_queries_total", "dgraph_num_mutations_total",
                     "dgraph_num_commits_total", "dgraph_num_aborts_total",
                     "dgraph_posting_reads_total",
                     "dgraph_posting_writes_total",
                     "dgraph_pending_queries_total",
                     "dgraph_active_mutations_total",
                     "dgraph_num_upserts_total", "dgraph_num_alters_total",
                     "dgraph_plan_cache_hits_total",
                     "dgraph_plan_cache_misses_total",
                     "dgraph_task_cache_hits_total",
                     "dgraph_task_cache_misses_total",
                     "dgraph_task_cache_evicted_total",
                     "dgraph_task_cache_inflight_waits_total",
                     "dgraph_task_cache_bytes",
                     "dgraph_result_cache_hits_total",
                     "dgraph_result_cache_misses_total",
                     "dgraph_result_cache_evicted_total",
                     "dgraph_result_cache_bytes",
                     "dgraph_dispatch_inflight",
                     "dgraph_dispatch_waits_total",
                     "dgraph_dispatch_wait_ns_total",
                     # delta-overlay maintenance tier (storage/delta.py)
                     "dgraph_overlay_stamps_total",
                     "dgraph_overlay_fold_fallbacks_total",
                     "dgraph_compactions_total",
                     "dgraph_cache_invalidations_avoided_total",
                     "dgraph_parallel_folds_total",
                     "dgraph_fold_pool_width",
                     # cost-based planner (query/planner.py) + live
                     # cardinality stats (storage/stats.py)
                     "dgraph_planner_plans_total",
                     "dgraph_planner_root_swaps_total",
                     "dgraph_planner_filter_reorders_total",
                     "dgraph_planner_child_reorders_total",
                     "dgraph_planner_host_expands_total",
                     "dgraph_planner_device_expands_total",
                     "dgraph_planner_cache_hits_total",
                     "dgraph_planner_cache_misses_total",
                     "dgraph_planner_fallbacks_total",
                     "dgraph_stats_builds_total",
                     "dgraph_stats_delta_updates_total",
                     # out-of-core ingest tier (ingest/, loader/)
                     "dgraph_ingest_spill_bytes_total",
                     "dgraph_ingest_spill_runs_total",
                     "dgraph_ingest_merge_fanin",
                     "dgraph_xidmap_lookups_total",
                     "dgraph_xidmap_shard_loads_total",
                     "dgraph_xidmap_evictions_total",
                     "dgraph_checkpoint_peak_transient_bytes",
                     # request lifelines (utils/deadline, utils/retry,
                     # utils/faults): retries, overload sheds,
                     # budget overruns, hedges, breaker trips, degraded
                     # reads, injected faults
                     "dgraph_retry_total",
                     "dgraph_shed_total",
                     "dgraph_deadline_exceeded_total",
                     "dgraph_hedge_fired_total",
                     "dgraph_breaker_open_total",
                     "dgraph_degraded_reads_total",
                     "dgraph_fault_injected_total",
                     # vector similarity index (storage/vecindex.py,
                     # ops/vector.py)
                     "dgraph_vector_searches_total",
                     "dgraph_vector_ivf_probes_total",
                     "dgraph_vector_fused_pipelines_total",
                     "dgraph_vector_mesh_dispatches_total",
                     # self-driving shard placement (coord/placement.py):
                     # controller ticks, actions, replica
                     # freshness ships, and the replica read/fallback
                     # counters on the query router
                     "dgraph_placement_ticks_total",
                     "dgraph_placement_moves_total",
                     "dgraph_placement_replicas_added_total",
                     "dgraph_placement_replicas_dropped_total",
                     "dgraph_placement_delta_ships_total",
                     "dgraph_placement_resyncs_total",
                     "dgraph_placement_cooldown_skips_total",
                     "dgraph_placement_errors_total",
                     "dgraph_replica_reads_total",
                     "dgraph_replica_fallbacks_total",
                     # batched multi-query dispatch (query/batch.py)
                     # — counters created by the batcher too,
                     # but a node with batching OFF must still expose
                     # them at 0 (the pre-registration invariant the
                     # audit test enforces mechanically)
                     "dgraph_batch_formed_total",
                     "dgraph_batch_tasks_total",
                     "dgraph_batch_window_waits_total",
                     "dgraph_batch_deadline_bypass_total",
                     # group-commit write window (storage/writebatch.py)
                     # — created by the WriteBatcher too, but a
                     # node with write batching OFF must still expose
                     # them at 0 (the same pre-registration invariant)
                     "dgraph_write_batch_formed_total",
                     "dgraph_write_batch_commits_total",
                     "dgraph_write_batch_fsyncs_total",
                     "dgraph_write_batch_window_waits_total",
                     "dgraph_write_batch_deadline_bypass_total",
                     "dgraph_write_batch_conflict_aborts_total",
                     # per-tenant window slot cap: commits a
                     # window-hogging tenant ran solo instead of batching
                     "dgraph_write_batch_tenant_solo_total",
                     # mesh deployment mode (parallel/mesh_exec.py)
                     "dgraph_mesh_dispatches_total",
                     "dgraph_mesh_fused_hops_total",
                     "dgraph_mesh_traversed_edges_total",
                     "dgraph_mesh_program_builds_total",
                     "dgraph_mesh_devices",
                     "dgraph_mesh_sharded_tablets",
                     "dgraph_mesh_replicated_tablets",
                     "dgraph_mesh_residency_deferred_total",
                     "dgraph_mesh_fused_queries_total",
                     "dgraph_mesh_unfused_queries_total",
                     "dgraph_mesh_replay_divergence_total",
                     # HBM working-set manager (storage/residency.py)
                     "dgraph_residency_hbm_bytes",
                     "dgraph_residency_host_bytes",
                     "dgraph_residency_admissions_total",
                     "dgraph_residency_evictions_total",
                     "dgraph_residency_prefetch_hits_total",
                     "dgraph_residency_prefetch_wasted_total",
                     "dgraph_residency_thrash_total",
                     "dgraph_residency_cold_serves_total",
                     "dgraph_residency_upload_failures_total",
                     "dgraph_residency_host_fallbacks_total",
                     "dgraph_residency_budget_overruns_total",
                     # host posting-list memory (Node.enforce_memory)
                     "dgraph_memory_bytes",
                     # layer spans (obs/otrace.py): each layer's span
                     # self time, the bytes the device seams moved, and
                     # the span-ring entries overwritten
                     "dgraph_span_self_ns_node_total",
                     "dgraph_span_self_ns_engine_total",
                     "dgraph_span_self_ns_traversal_total",
                     "dgraph_span_self_ns_device_total",
                     "dgraph_transfer_h2d_bytes_total",
                     "dgraph_transfer_d2h_bytes_total",
                     "dgraph_span_ring_dropped_total",
                     # per-uid host work the engine skipped
                     # (query/outputnode.py, query/task.py): blocks
                     # encoded without the per-uid walk, and uid levels
                     # whose dest set came off the card, and frontiers
                     # mapped to CSR rows on the card, and gathered
                     # levels whose targets stayed on the card, and those
                     # a reader then copied back, and uid(...) unions run
                     # on the card (ops/uidset.union_parts) with the parts
                     # that went up for them
                     "dgraph_encode_walks_skipped_total",
                     "dgraph_expand_dest_on_device_total",
                     "dgraph_expand_rows_on_device_total",
                     "dgraph_expand_targets_on_device_total",
                     "dgraph_expand_targets_fetched_total",
                     "dgraph_var_union_on_device_total",
                     "dgraph_var_union_parts_uploaded_total",
                     # @groupby and ordering (query/groupby.py,
                     # engine._apply_order): the time in each, the groups
                     # formed and the member-key pairs reduced, the
                     # groupbys counted on the card, the keys bound to
                     # grouped vars
                     "dgraph_groupby_ns_total",
                     "dgraph_order_ns_total",
                     "dgraph_groupby_groups_total",
                     "dgraph_groupby_pairs_total",
                     "dgraph_groupby_on_device_total",
                     "dgraph_grouped_var_keys_total",
                     # the shortest kernel tier (ops/pull_bfs.py): the
                     # time in its device BFS loop and in its host walk,
                     # and the hops the loop ran
                     "dgraph_shortest_bfs_ns_total",
                     "dgraph_shortest_walk_ns_total",
                     "dgraph_shortest_bfs_hops_total",
                     # @recurse (query/recurse.py): the time in the fused
                     # path's device levels and in the var binding, the
                     # levels run, and the uids bound to recurse vars
                     "dgraph_recurse_levels_ns_total",
                     "dgraph_recurse_bind_ns_total",
                     "dgraph_recurse_levels_total",
                     "dgraph_recurse_bound_uids_total",
                     # the active-prefix kernels (ops/prefix.py), inside
                     # a request: K1/K2 runs and what each streamed (edge
                     # slots with padding, frontier words)
                     "dgraph_prefix_k1_launches_total",
                     "dgraph_prefix_k1_edge_slots_total",
                     "dgraph_prefix_k1_bitmap_words_total",
                     "dgraph_prefix_k2_launches_total",
                     "dgraph_prefix_k2_edge_slots_total",
                     "dgraph_prefix_k2_table_entries_total",
                     # query cost ledger (obs/costs.py)
                     "dgraph_cost_records_total",
                     "dgraph_cost_regressions_total",
                     "dgraph_cost_ship_failures_total",
                     # lazy on-demand snapshot folds (storage/csr_build
                     # LazyPreds/_FoldThunk): per-trigger fold
                     # counters plus the cold-open / first-query gauges
                     # the scale runbook reads
                     "dgraph_fold_lazy_total",
                     "dgraph_fold_eager_total",
                     "dgraph_fold_prefetch_total",
                     "dgraph_fold_inline_total",
                     "dgraph_fold_pending_tablets",
                     "dgraph_cold_open_ms",
                     "dgraph_first_query_ms",
                     # device aggregation + whole-graph analytics
                     # (ops/segments.py, query/groupby.py,
                     # query/analytics.py)
                     "dgraph_agg_device_reduces_total",
                     "dgraph_agg_host_reduces_total",
                     "dgraph_agg_terminal_ops_total",
                     "dgraph_analytics_runs_total",
                     "dgraph_analytics_host_fallbacks_total",
                     "dgraph_analytics_iterations_total",
                     "dgraph_analytics_edges_total",
                     # delta-journal retention (storage/store.py):
                     # keys/pinned_floor are gauges refreshed on scrape
                     "dgraph_delta_journal_keys",
                     "dgraph_delta_journal_overflows",
                     "dgraph_delta_journal_pinned_floor",
                     # live queries (live/manager.py, api/http.py)
                     "dgraph_subs_active",
                     "dgraph_subs_registered_total",
                     "dgraph_subs_notifications_total",
                     "dgraph_subs_wakeups_total",
                     "dgraph_subs_evals_total",
                     "dgraph_subs_windows_total",
                     "dgraph_subs_sheds_total",
                     "dgraph_subs_resyncs_total",
                     "dgraph_subs_expired_total",
                     "dgraph_subs_reaped_total",
                     "dgraph_subs_heartbeats_total",
                     # device-runtime observatory (obs/devprof.py)
                     # — created by the profiler too, but a
                     # node with --no_devprof must still expose them at
                     # 0 (the pre-registration invariant)
                     "dgraph_xla_compiles_total",
                     "dgraph_xla_retrace_storms_total",
                     "dgraph_devprof_dispatches_total",
                     "dgraph_devprof_hbm_pressure_total",
                     "dgraph_device_utilization",
                     "dgraph_devprof_hbm_budget_bytes"):
            self.counters[name] = Counter()
        # per-endpoint breaker state (0 closed / 1 half-open / 2 open)
        self.keyed_gauges["dgraph_breaker_state"] = KeyedGauge()
        # per-tablet live load counters (the placement controller's
        # inputs): key "<pred>|<group>|<stat>" renders as labeled series
        # dgraph_tablet_load{pred=,group=,stat=} with stat one of
        # reads/writes/bytes/serve_ms
        self.keyed_gauges["dgraph_tablet_load"] = KeyedGauge(
            labels=("pred", "group", "stat"))
        self.keyed_gauges["dgraph_mesh_fallbacks_total"] = KeyedGauge(
            labels=("reason",))
        self.keyed_gauges["dgraph_batch_incompatible"] = KeyedGauge()
        self.keyed_gauges["dgraph_overlay_depth"] = KeyedGauge()
        self.keyed_gauges["dgraph_residency_tier_bytes"] = KeyedGauge(
            labels=("tier",))
        self.keyed_gauges["dgraph_devprof_hbm_highwater_bytes"] = \
            KeyedGauge(labels=("tier",))
        # the hand kernels' launches in this process (ops/prefix.py's
        # LAUNCHES), copied in at scrape time by api/http.py's /metrics
        self.keyed_gauges["dgraph_kernel_launches"] = KeyedGauge(
            labels=("kernel",))
        # multi-tenant QoS (dgraph_tpu/tenancy/): per-tenant
        # cost attribution in cost-ledger units plus the shed counter —
        # labeled series so one Grafana row ranks tenants. Values are
        # integer floors of the registry's float accumulators (KeyedGauge
        # is integer; TenantRegistry keeps the exact floats).
        self.keyed_gauges["dgraph_tenant_device_ms_total"] = KeyedGauge(
            labels=("tenant",))
        self.keyed_gauges["dgraph_tenant_edges_total"] = KeyedGauge(
            labels=("tenant",))
        self.keyed_gauges["dgraph_tenant_bytes_total"] = KeyedGauge(
            labels=("tenant",))
        self.keyed_gauges["dgraph_tenant_shed_total"] = KeyedGauge(
            labels=("tenant",))
        for name in ("dgraph_query_latency_s", "dgraph_mutation_latency_s",
                     "dgraph_commit_latency_s", "dgraph_compaction_s",
                     "dgraph_planner_est_error_log2",
                     "dgraph_batch_occupancy",
                     "dgraph_write_batch_occupancy",
                     # per-request cost distributions off the ledger
                     # (obs/costs.py): aggregatable le-bucket histograms
                     # with trace exemplars, NOT ring quantiles
                     "dgraph_query_cost_device_ms",
                     "dgraph_query_cost_edges",
                     "dgraph_query_cost_bytes",
                     # per-tablet fold wall time (lazy/eager/prefetch/
                     # inline triggers alike)
                     "dgraph_fold_ms",
                     # per-endpoint HTTP latency (api/http.py observes
                     # these; pre-registered so a fresh node scrapes 0s)
                     "dgraph_http_query_latency_s",
                     "dgraph_http_mutate_latency_s",
                     "dgraph_http_commit_latency_s",
                     "dgraph_http_abort_latency_s",
                     "dgraph_http_alter_latency_s",
                     "dgraph_analytics_latency_s",
                     "dgraph_http_analytics_latency_s",
                     # live queries: commit-to-notify latency +
                     # subscribe registration time (SSE setup to first ack)
                     "dgraph_subs_notify_latency_s",
                     "dgraph_http_subscribe_latency_s",
                     # device-runtime observatory (obs/devprof.py)
                     #: real XLA compile wall ms, gate
                     # queue-entry-to-launch gap, fenced dispatch ms
                     "dgraph_xla_compile_ms",
                     "dgraph_device_queue_gap_ms",
                     "dgraph_device_dispatch_ms"):
            self.histograms[name] = Histogram(
                buckets=default_buckets(name))

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self.counters.setdefault(name, Counter())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(
                    buckets=default_buckets(name))
            return h

    def meter(self, name: str) -> Meter:
        with self._lock:
            return self.meters.setdefault(name, Meter())

    def keyed(self, name: str,
              labels: tuple[str, ...] | None = None) -> KeyedGauge:
        with self._lock:
            return self.keyed_gauges.setdefault(name, KeyedGauge(labels))

    def to_dict(self) -> dict:
        """expvar-style dump for /debug/vars."""
        out: dict = {c: m.value for c, m in sorted(self.counters.items())}
        out.update({h: m.snapshot() for h, m in sorted(self.histograms.items())})
        out.update({f"{n}_qps": m.rate() for n, m in sorted(self.meters.items())})
        out.update({f"{n}_meter_dropped": m.dropped
                    for n, m in sorted(self.meters.items()) if m.dropped})
        out.update({n: g.snapshot()
                    for n, g in sorted(self.keyed_gauges.items())})
        return out

    def export(self) -> dict:
        """Compact mergeable snapshot of the whole registry — the payload
        workers ship on the Status/load-report path (StatusResponse.
        metrics_json) and Zero's fleet aggregator merges. Counters and
        keyed gauges sum; fixed-bucket histograms merge EXACTLY because
        every node uses the same bounds per metric name."""
        with self._lock:
            counters = dict(self.counters)
            histograms = dict(self.histograms)
            keyed = dict(self.keyed_gauges)
        return {"counters": {n: c.value for n, c in counters.items()},
                "histograms": {n: h.export()
                               for n, h in histograms.items()},
                "keyed": {n: {"labels": list(g.labels) if g.labels else
                              None, "vals": g.snapshot()}
                          for n, g in keyed.items()}}


def merge_exports(snaps: list[dict]) -> dict:
    """Sum/merge per-node Registry.export() snapshots into one fleet
    view: counters and keyed-gauge values sum; histograms merge
    bucket-by-bucket (bounds must match — a mismatch drops the straggler
    series rather than producing a silently-wrong merge); exemplars keep
    the newest per bucket."""
    out = {"counters": {}, "histograms": {}, "keyed": {}}
    for snap in snaps:
        for n, v in snap.get("counters", {}).items():
            out["counters"][n] = out["counters"].get(n, 0) + int(v)
        for n, h in snap.get("histograms", {}).items():
            cur = out["histograms"].get(n)
            if cur is None:
                out["histograms"][n] = {
                    "bounds": list(h.get("bounds", [])),
                    "counts": list(h.get("counts", [])),
                    "sum": float(h.get("sum", 0.0)),
                    "count": int(h.get("count", 0)),
                    "exemplars": [list(e) if e else None
                                  for e in h.get("exemplars", [])]}
                continue
            if cur["bounds"] != list(h.get("bounds", [])):
                continue             # never merge mismatched bucket schemes
            cur["counts"] = [a + b for a, b in
                             zip(cur["counts"], h.get("counts", []))]
            cur["sum"] += float(h.get("sum", 0.0))
            cur["count"] += int(h.get("count", 0))
            for i, e in enumerate(h.get("exemplars", [])):
                if e and (i >= len(cur["exemplars"])
                          or cur["exemplars"][i] is None
                          or e[2] > cur["exemplars"][i][2]):
                    if i < len(cur["exemplars"]):
                        cur["exemplars"][i] = list(e)
        for n, g in snap.get("keyed", {}).items():
            cur = out["keyed"].setdefault(
                n, {"labels": g.get("labels"), "vals": {}})
            for k, v in g.get("vals", {}).items():
                cur["vals"][k] = cur["vals"].get(k, 0) + int(v)
    return out


class Trace:
    """One request's breadcrumb trail (net/trace analog)."""

    __slots__ = ("kind", "title", "t0", "events", "error", "elapsed")

    def __init__(self, kind: str, title: str) -> None:
        self.kind = kind
        self.title = title
        self.t0 = time.perf_counter()
        self.events: list[tuple[float, str]] = []
        self.error = ""
        self.elapsed = 0.0            # frozen by TraceStore.finish

    def printf(self, msg: str, *args) -> None:
        self.events.append((time.perf_counter() - self.t0,
                            msg % args if args else msg))

    def to_dict(self) -> dict:
        return {"kind": self.kind, "title": self.title,
                "elapsed_s": round(self.elapsed, 6),
                "error": self.error,
                "events": [{"t": round(t, 6), "msg": m}
                           for t, m in self.events]}


class _NullTrace:
    """Unsampled requests get a no-op trace — zero overhead breadcrumbs."""

    def printf(self, msg: str, *args) -> None:
        pass

    error = ""


NULL_TRACE = _NullTrace()


class TraceStore:
    """Sampled request traces, newest-first ring (reference: --trace fraction
    gating tr.New, /debug/requests rendering).

    rng is injectable (anything with .random()) so tests drive the
    sampling decision deterministically instead of flaking on the global
    unseeded generator."""

    def __init__(self, fraction: float = 1.0, keep: int = 64,
                 rng=None) -> None:
        self.fraction = fraction
        self.rng = rng if rng is not None else random
        self._ring: deque[Trace] = deque(maxlen=keep)
        self._lock = threading.Lock()

    def start(self, kind: str, title: str):
        if self.fraction <= 0 or \
                (self.fraction < 1.0 and self.rng.random() >= self.fraction):
            return NULL_TRACE
        return Trace(kind, title)

    def finish(self, tr, error: str = "") -> None:
        if tr is NULL_TRACE:
            return
        tr.error = error
        tr.elapsed = time.perf_counter() - tr.t0
        with self._lock:
            self._ring.appendleft(tr)

    def recent(self, n: int = 32) -> list[dict]:
        with self._lock:
            return [t.to_dict() for i, t in enumerate(self._ring) if i < n]
