"""HTTP API: /query /mutate /commit /abort /alter /health /state.

Reference semantics: dgraph/cmd/server/run.go:246-261 registers these same
paths as HTTP mirrors of the gRPC api.Dgraph service; responses use the
{"data": ..., "extensions": {...}} / {"errors": [...]} envelope the
reference's queryHandler writes (dgraph/cmd/server/http.go).

Built on http.server.ThreadingHTTPServer (stdlib) — the wire format, not the
server framework, is the compatibility surface.

Request formats:
  POST /query    body = DQL text, or JSON {"query": ..., "variables": {...}}
  POST /mutate   body = DQL mutation ({set {...}} / {delete {...}}), or JSON
                 {"set": [...], "delete": [...]}; ?commitNow=true or the
                 X-Dgraph-CommitNow: true header commits immediately;
                 ?startTs=N continues an open txn.
  POST /commit/?startTs=N   body = ignored (keys travel server-side)
  POST /abort/?startTs=N
  POST /alter    body = schema text, or {"drop_all": true} / {"drop_attr": p}
  GET  /health, GET /state
  POST /admin/export[?dest=dir]      RDF+schema export (admin.go)
  POST /admin/shutdown               graceful stop
  POST /admin/config/memory_mb       body = MB; live budget reconfig
  POST /admin/tenant                 tenant QoS table hot-reload
                                     (?replace=true swaps the table)

The X-Dgraph-Tenant header scopes a request to its tenant's namespace:
predicates resolve as "<tenant>/<attr>" storage attrs, the
tenant's DQL never sees the prefix, and namespace violations surface as
403 ErrorNamespace. No header = the default (admin) namespace.

Copy of dgraph_tpu/api/http.py for the PyTorch port, in front of the port's
Node: the same routes, envelopes and status mapping, POST /analytics and
every /debug/metrics section of the JAX server included. /metrics adds one
port-only series, `dgraph_kernel_launches{kernel=...}`: the K1/K2 launches
this process has made.
"""

from __future__ import annotations

import json
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from dgraph_tpu_torch import tenancy as tnc
from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.coord.zero import TxnConflict
from dgraph_tpu_torch.utils import faults
from dgraph_tpu_torch.utils.deadline import DeadlineExceeded, ResourceExhausted


def _envelope_ok(data: dict, extensions: dict | None = None) -> bytes:
    out = {"data": data}
    if extensions:
        out["extensions"] = extensions
    return json.dumps(out).encode()


_DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>dgraph-tpu console</title>
<style>
 body{font:14px/1.4 system-ui,sans-serif;margin:0;display:flex;
      flex-direction:column;height:100vh;background:#0f1115;color:#d8dee9}
 header{padding:10px 16px;background:#171a21;display:flex;gap:12px;
        align-items:center}
 header b{color:#8fbcbb} header span{color:#616e88;font-size:12px}
 main{flex:1;display:flex;min-height:0}
 .col{flex:1;display:flex;flex-direction:column;min-width:0;padding:10px}
 textarea{flex:1;background:#11141a;color:#d8dee9;border:1px solid #2e3440;
          border-radius:6px;padding:10px;font:13px/1.45 monospace;
          resize:none;outline:none}
 pre{flex:1;overflow:auto;background:#11141a;border:1px solid #2e3440;
     border-radius:6px;padding:10px;font:12px/1.4 monospace;margin:0}
 .bar{display:flex;gap:8px;padding:8px 0}
 button{background:#5e81ac;border:0;color:#fff;border-radius:5px;
        padding:6px 14px;cursor:pointer}
 button.alt{background:#3b4252}
 .lat{color:#616e88;font-size:12px;align-self:center}
</style></head><body>
<header><b>dgraph-tpu</b><span>query console — POST /query /mutate /alter;
GET /state /health /metrics /debug (index: vars, metrics, traces,
slow)</span></header>
<main>
 <div class="col">
  <textarea id="q">{
  # expand(_all_) shows whatever this server holds
  q(func: has(name), first: 10) { uid expand(_all_) }
}</textarea>
  <div class="bar">
   <button onclick="run('/query')">Run query</button>
   <button class="alt" onclick="run('/mutate?commitNow=true')">Mutate</button>
   <button class="alt" onclick="run('/alter')">Alter</button>
   <button class="alt" onclick="get('/state')">State</button>
   <button class="alt" onclick="get('/health')">Health</button>
   <span class="lat" id="lat"></span>
  </div>
 </div>
 <div class="col"><pre id="out">// results appear here</pre></div>
</main>
<script>
async function show(r, t0){
  const txt = await r.text();
  let lat = (performance.now()-t0).toFixed(0)+' ms';
  try{           // serving-layer readout: QPS, hit rate, overlay state
    const m = await (await fetch('/debug/metrics')).json();
    lat += ' · ' + m.endpoints.query.qps + ' qps · hit ' +
        (100*m.caches.task.hit_rate).toFixed(0) + '%';
    const ov = m.overlay || {};
    const depth = Object.values(ov.depth||{}).reduce((a,b)=>a+b,0);
    if (ov.stamps) lat += ' · Δ' + depth + ' (' + ov.stamps + ' stamps, ' +
        (ov.compactions||0) + ' rollups)';
    const ba = m.batching || {};
    if (ba.formed) lat += ' · batch ' +
        (ba.occupancy.mean||0).toFixed(1) + 'x/' + ba.formed;
    const wr = m.writes || {};
    if (wr.commits) lat += ' · gc ' + wr.commits + 'c/' +
        wr.fsyncs + 'f (' + (wr.fsync_amortization||1).toFixed(1) + 'x)';
    const tl = Object.entries(m.tablet_load || {})
        .sort((a,b)=>(b[1].r||0)-(a[1].r||0))[0];
    if (tl) lat += ' · hot ' + tl[0] + ' (' + (tl[1].r||0) + 'r/' +
        (tl[1].w||0) + 'w)';
  }catch(e){}
  document.getElementById('lat').textContent = lat;
  try{document.getElementById('out').textContent =
      JSON.stringify(JSON.parse(txt),null,2);}
  catch(e){document.getElementById('out').textContent = txt;}
}
async function run(path){
  const t0 = performance.now();
  try{
    const r = await fetch(path,{method:'POST',
      headers:{'Content-Type':'application/graphql+-'},
      body:document.getElementById('q').value});
    await show(r, t0);
  }catch(e){document.getElementById('out').textContent = 'error: '+e.message;}
}
async function get(path){
  const t0 = performance.now();
  try{await show(await fetch(path), t0);}
  catch(e){document.getElementById('out').textContent = 'error: '+e.message;}
}
</script></body></html>""".encode("utf-8")


def _envelope_err(code: str, message: str) -> bytes:
    return json.dumps(
        {"errors": [{"code": code, "message": message}]}).encode()


def _hit_rate(hits: int, misses: int) -> float:
    total = hits + misses
    return round(hits / total, 4) if total else 0.0


def _mesh_metrics(node: Node) -> dict:
    m = node.metrics
    c = lambda n: m.counter(n).value
    fused = c("dgraph_mesh_fused_queries_total")
    unfused = c("dgraph_mesh_unfused_queries_total")
    return {
        "enabled": node.mesh_exec is not None,
        "devices": c("dgraph_mesh_devices"),
        "dispatches": c("dgraph_mesh_dispatches_total"),
        "fused_hops": c("dgraph_mesh_fused_hops_total"),
        "traversed_edges": c("dgraph_mesh_traversed_edges_total"),
        "program_builds": c("dgraph_mesh_program_builds_total"),
        "sharded_tablets": c("dgraph_mesh_sharded_tablets"),
        "replicated_tablets": c("dgraph_mesh_replicated_tablets"),
        "residency_deferred": c("dgraph_mesh_residency_deferred_total"),
        "fallbacks": m.keyed("dgraph_mesh_fallbacks_total",
                             labels=("reason",)).snapshot(),
        "fused_queries": fused,
        "unfused_queries": unfused,
        "fused_coverage_ratio": round(fused / (fused + unfused), 4)
        if fused + unfused else None,
    }


def _tenancy_metrics(node: Node) -> dict:
    """Per-tenant QoS readout: the registry table (specs, bucket levels,
    exact cost totals, sheds), the fair scheduler's vtime/EWMA state, and
    storage accounting grouped by namespace prefix — tenant attrs are
    distinct storage attrs, so overlay depth, journal keys, and predicate
    counts attribute by tnc.split()."""
    per: dict = {}

    def row(tenant: str) -> dict:
        return per.setdefault(tenant or "default", {
            "preds": 0, "overlay_depth": 0, "journal_keys": 0})

    for attr in node.store.predicates():
        row(tnc.split(attr)[0])["preds"] += 1
    for attr, depth in node._assembler.overlay_stats().items():
        row(tnc.split(attr)[0])["overlay_depth"] += depth
    for attr, keys in node.store.delta_log_by_attr().items():
        row(tnc.split(attr)[0])["journal_keys"] += keys
    fair = node.dispatch_gate.fair
    return {
        "qos": node.qos_enabled,
        "configured": node.tenancy.configured,
        "tenants": node.tenancy.table(),
        "fair": fair.snapshot() if fair is not None else None,
        "storage": per,
    }


def _serving_metrics(node: Node) -> dict:
    """The /debug/metrics payload: cache tiers, dispatch gate, and
    per-endpoint QPS + latency (the serving-layer readout)."""
    m = node.metrics
    c = lambda n: m.counter(n).value
    out = {
        "caches": {
            "plan": {
                "hits": c("dgraph_plan_cache_hits_total"),
                "misses": c("dgraph_plan_cache_misses_total"),
                "hit_rate": _hit_rate(c("dgraph_plan_cache_hits_total"),
                                      c("dgraph_plan_cache_misses_total")),
                "entries": len(node.plan_cache)
                if node.plan_cache is not None else 0,
            },
            "task": {
                "hits": c("dgraph_task_cache_hits_total"),
                "misses": c("dgraph_task_cache_misses_total"),
                "hit_rate": _hit_rate(c("dgraph_task_cache_hits_total"),
                                      c("dgraph_task_cache_misses_total")),
                "evicted": c("dgraph_task_cache_evicted_total"),
                "inflight_waits":
                    c("dgraph_task_cache_inflight_waits_total"),
                "bytes": c("dgraph_task_cache_bytes"),
            },
            "result": {
                "hits": c("dgraph_result_cache_hits_total"),
                "misses": c("dgraph_result_cache_misses_total"),
                "hit_rate": _hit_rate(c("dgraph_result_cache_hits_total"),
                                      c("dgraph_result_cache_misses_total")),
                "evicted": c("dgraph_result_cache_evicted_total"),
                "bytes": c("dgraph_result_cache_bytes"),
            },
        },
        "dispatch": {
            "width": node.dispatch_gate.width,
            "in_flight": c("dgraph_dispatch_inflight"),
            "waits": c("dgraph_dispatch_waits_total"),
        },
        # batched multi-query device execution: formed batches,
        # occupancy distribution, window waits, deadline bypasses, and the
        # per-reason solo-fallback breakdown (query/batch.py)
        "batching": {
            "enabled": node.batcher is not None,
            "window_ms": (node.batcher.window_s * 1000.0
                          if node.batcher is not None else 0.0),
            "max_batch": (node.batcher.max_batch
                          if node.batcher is not None else 0),
            "formed": c("dgraph_batch_formed_total"),
            "batched_tasks": c("dgraph_batch_tasks_total"),
            "occupancy": m.histogram("dgraph_batch_occupancy").snapshot(),
            "window_waits": c("dgraph_batch_window_waits_total"),
            "deadline_bypass": c("dgraph_batch_deadline_bypass_total"),
            "incompatible": m.keyed("dgraph_batch_incompatible").snapshot(),
        },
        # group-commit write window (storage/writebatch.py):
        # formed windows, member commits vs fsyncs (the amortization
        # ratio), occupancy distribution, window waits, deadline
        # bypasses, and intra-window conflict aborts
        "writes": {
            "enabled": node.write_batcher is not None,
            "window_ms": (node.write_batcher.window_s * 1000.0
                          if node.write_batcher is not None else 0.0),
            "max_batch": (node.write_batcher.max_batch
                          if node.write_batcher is not None else 0),
            "formed": c("dgraph_write_batch_formed_total"),
            "commits": c("dgraph_write_batch_commits_total"),
            "fsyncs": c("dgraph_write_batch_fsyncs_total"),
            "fsync_amortization": round(
                c("dgraph_write_batch_commits_total") /
                c("dgraph_write_batch_fsyncs_total"), 2)
            if c("dgraph_write_batch_fsyncs_total") else None,
            "occupancy":
                m.histogram("dgraph_write_batch_occupancy").snapshot(),
            "window_waits": c("dgraph_write_batch_window_waits_total"),
            "deadline_bypass":
                c("dgraph_write_batch_deadline_bypass_total"),
            "conflict_aborts":
                c("dgraph_write_batch_conflict_aborts_total"),
        },
        # delta-overlay maintenance tier: O(Δ) commit-to-visible stamping,
        # background compaction, parallel cold folds, and the task/result
        # cache invalidations the per-predicate tokens avoided
        "overlay": {
            "stamps": c("dgraph_overlay_stamps_total"),
            "fold_fallbacks": c("dgraph_overlay_fold_fallbacks_total"),
            "depth": node._assembler.overlay_stats(),
            "bytes": node._assembler.overlay_bytes(),
            "journal": node.store.delta_log_stats(),
            "compactions": c("dgraph_compactions_total"),
            "compaction_s": m.histogram("dgraph_compaction_s").snapshot(),
            "invalidations_avoided":
                c("dgraph_cache_invalidations_avoided_total"),
            "parallel_folds": c("dgraph_parallel_folds_total"),
            "fold_pool_width": c("dgraph_fold_pool_width"),
        },
        # lazy on-demand snapshot folds: per-trigger fold
        # counters (lazy = first read, prefetch = plan-driven, inline =
        # overlay-forced compaction, eager = assembly/materialize-all),
        # the fold wall-time distribution, currently-pending fold thunks,
        # and the cold-open / first-query gauges the scale runbook reads
        "folds": {
            "lazy_enabled": node._assembler.lazy_folds,
            "lazy": c("dgraph_fold_lazy_total"),
            "eager": c("dgraph_fold_eager_total"),
            "prefetch": c("dgraph_fold_prefetch_total"),
            "inline": c("dgraph_fold_inline_total"),
            "fold_ms": m.histogram("dgraph_fold_ms").snapshot(),
            "pending_tablets": c("dgraph_fold_pending_tablets"),
            "cold_open_ms": c("dgraph_cold_open_ms"),
            "first_query_ms": c("dgraph_first_query_ms"),
        },
        # cost-based planner tier: decision counters, plan-cache hit
        # rates, and the estimation-error histogram (|log2(actual/est)|
        # per executed planned step — 0 is a perfect estimate)
        "planner": {
            "enabled": node.planner_enabled,
            "plans_built": c("dgraph_planner_plans_total"),
            "root_swaps": c("dgraph_planner_root_swaps_total"),
            "filter_reorders": c("dgraph_planner_filter_reorders_total"),
            "sibling_reorders": c("dgraph_planner_child_reorders_total"),
            "host_expands": c("dgraph_planner_host_expands_total"),
            "device_expands": c("dgraph_planner_device_expands_total"),
            "fallbacks": c("dgraph_planner_fallbacks_total"),
            "plan_cache": {
                "hits": c("dgraph_planner_cache_hits_total"),
                "misses": c("dgraph_planner_cache_misses_total"),
                "hit_rate": _hit_rate(
                    c("dgraph_planner_cache_hits_total"),
                    c("dgraph_planner_cache_misses_total")),
            },
            "est_error_log2": m.histogram(
                "dgraph_planner_est_error_log2").snapshot(),
            "stats": {
                "builds": c("dgraph_stats_builds_total"),
                "delta_updates": c("dgraph_stats_delta_updates_total"),
            },
        },
        # request lifelines: retries / sheds / deadline
        # overruns / hedges / breaker trips / degraded reads / injected
        # faults — the failure-mode readout the runbook points at
        "lifelines": {
            "retries": c("dgraph_retry_total"),
            "sheds": c("dgraph_shed_total"),
            "deadline_exceeded": c("dgraph_deadline_exceeded_total"),
            "hedges": c("dgraph_hedge_fired_total"),
            "breaker_opens": c("dgraph_breaker_open_total"),
            "breaker_state": m.keyed("dgraph_breaker_state").snapshot(),
            "degraded_reads": c("dgraph_degraded_reads_total"),
            "faults_injected": c("dgraph_fault_injected_total"),
        },
        # mesh deployment mode (parallel/mesh_exec.py): fused
        # whole-plan dispatches, per-reason fallback breakdown, and the
        # fused-coverage ratio — queries that touched mesh-owned tablets
        # and ran their traversals fully fused vs ones that recorded at
        # least one labeled fallback
        "mesh": _mesh_metrics(node),
        # HBM working-set manager (storage/residency.py): tier byte totals
        # (hbm/warm/cold), admission/eviction/prefetch/thrash counters,
        # pinned tablets, and the currently-resident buffer groups — the
        # device-memory runbook's readout
        "residency": node.residency.debug_snapshot(),
        # per-tablet load counters (coord/placement.py TabletLoadBook):
        # the placement controller's scoring inputs — reads/writes/result
        # bytes/serve seconds per predicate — inspectable here and as the
        # dgraph_tablet_load{pred,group,stat} series on /metrics
        "tablet_load": node.tablet_book.snapshot(),
        # query cost ledger (obs/costs.py): records admitted to
        # the /debug/top window, regressions flagged against the
        # per-shape EWMA baselines, and the quantile view of the cost
        # distributions (the ring percentiles live HERE — /metrics
        # carries the aggregatable le-bucket histograms instead)
        "costs": {
            "enabled": node.cost_ledger,
            "records": c("dgraph_cost_records_total"),
            "in_window": len(node.cost_book),
            "regressions_flagged": c("dgraph_cost_regressions_total"),
            "regression_factor": node.cost_book.regression_factor,
            "device_ms": m.histogram(
                "dgraph_query_cost_device_ms").snapshot(),
            "edges": m.histogram("dgraph_query_cost_edges").snapshot(),
            "bytes": m.histogram("dgraph_query_cost_bytes").snapshot(),
        },
        # delta-journal retention: the completeness window live
        # subscriptions and O(Δ) stamping both depend on — keys held,
        # per-attr bound, overflow count, and the subscription pin
        "journal": node.store.delta_log_stats(),
        # live queries (live/): standing subscription
        # registry + the notifier's window/wake/eval/delivery counters —
        # the coalescing ratio is wakeups/evals, the health signal is
        # sheds/resyncs staying near zero
        "subscriptions": {
            **node.live.stats(),
            "notifications": c("dgraph_subs_notifications_total"),
            "wakeups": c("dgraph_subs_wakeups_total"),
            "evals": c("dgraph_subs_evals_total"),
            "sheds": c("dgraph_subs_sheds_total"),
            "resyncs": c("dgraph_subs_resyncs_total"),
            "expired": c("dgraph_subs_expired_total"),
            "reaped": c("dgraph_subs_reaped_total"),
            "heartbeats": c("dgraph_subs_heartbeats_total"),
            "notify_latency_s": m.histogram(
                "dgraph_subs_notify_latency_s").snapshot(),
        },
        # multi-tenant QoS (tenancy/): tenant table
        # with bucket levels + exact cost totals, fair-scheduler vtimes,
        # and per-namespace storage accounting
        "tenancy": _tenancy_metrics(node),
        # device-runtime observatory (obs/devprof.py): kernel-build
        # compile/retrace tracking, HBM high-water marks, and the
        # dispatch-timeline utilization meters — the full per-family
        # breakdown lives on /debug/compiles and /debug/timeline
        "devprof": (node.devprof.summary() if node.devprof is not None
                    else {"enabled": False}),
        "endpoints": {
            ep: {"qps": m.meter(f"http_{ep}").rate(),
                 "meter_dropped": m.meter(f"http_{ep}").dropped,
                 "latency": m.histogram(
                     f"dgraph_http_{ep}_latency_s").snapshot()}
            for ep in ("query", "mutate", "commit", "abort", "alter",
                       "analytics")
        },
        "node_qps": {"query": m.meter("query").rate(),
                     "mutate": m.meter("mutate").rate()},
        "vars": m.to_dict(),
    }
    return out


class _Handler(BaseHTTPRequestHandler):
    node: Node = None  # set by make_server

    # -- plumbing ------------------------------------------------------------

    def log_message(self, *a):  # quiet
        pass

    def _read_body(self) -> str:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n).decode("utf-8") if n else ""

    def _send(self, status: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _qs(self) -> dict:
        return {k: v[0] for k, v in
                parse_qs(urlparse(self.path).query).items()}

    # -- routes --------------------------------------------------------------

    def _tenant(self) -> str:
        return self.headers.get(tnc.HTTP_HEADER, "").strip()

    def do_GET(self):
        try:
            with tnc.scope(self._tenant()):
                self._do_get()
        except tnc.NamespaceError as e:
            self._send(403, _envelope_err("ErrorNamespace", str(e)))
        except Exception as e:
            self._send(400, _envelope_err("ErrorInvalidRequest", str(e)))

    # the /debug index: one place that names every diagnostic endpoint
    _DEBUG_INDEX = {
        "/debug/vars": "expvar-style dgraph_* counters/histograms",
        "/debug/requests": "sampled request breadcrumb traces (?n=32)",
        "/debug/metrics": "serving-layer readout: caches, overlay, folds, "
                          "planner, mesh, residency",
        "/debug/traces": "distributed span traces index (?n=32)",
        "/debug/traces/<trace_id>": "one trace as Chrome trace-event JSON "
                                    "(load in Perfetto / chrome://tracing)",
        "/debug/slow": "slow-query log ring (?n=32; cost regressions "
                       "flagged by the ledger land here too)",
        "/debug/top": "live cost profiler: rank plan shapes / predicates "
                      "/ endpoints by device ms, bytes, or edges over a "
                      "sliding window (?window=60&by=device_ms&"
                      "group=shape&n=20; &endpoint=live isolates "
                      "standing-subscription load)",
        "/debug/faults": "fault-injection registry (GET snapshot; POST "
                         '{"install": {...}} / {"spec": "..."} / '
                         '{"clear": true} / {"seed": N} — chaos tests)',
        "/debug/compiles": "XLA compile observatory: per-program-family "
                           "build/compile counts, cumulative compile ms, "
                           "live jit-cache sizes, last-trigger shapes, "
                           "retrace-storm flags",
        "/debug/timeline": "device dispatch timeline ring as Chrome "
                           "trace-event JSON (load in Perfetto; ?view=raw "
                           "for the record list, ?n=256 bounds it)",
        "/metrics": "Prometheus text exposition of the metrics registry",
    }

    def _do_get(self):
        path = urlparse(self.path).path.rstrip("/")
        if path == "/health":
            self._send(200, json.dumps(self.node.health()).encode())
        elif path == "/state":
            self._send(200, json.dumps(self.node.state()).encode())
        elif path == "/metrics":
            # Prometheus exposition of the whole Registry. Trace
            # exemplars are only legal in OpenMetrics — classic
            # text-format parsers reject the '# {...}' suffix and would
            # drop the whole scrape — so they render only when the
            # scraper negotiates via Accept (Prometheus does when
            # exemplar scraping is on; so do Grafana agents)
            from dgraph_tpu_torch.obs import prom

            # the hand kernels' launches in this process (ops/prefix.py's
            # LAUNCHES), copied at scrape time into a port-only labeled
            # series, so a client of the server can see that a request ran
            # K1/K2 (nothing is copied before the kernels' module loads)
            px = sys.modules.get("dgraph_tpu_torch.ops.prefix")
            if px is not None:
                g = self.node.metrics.keyed("dgraph_kernel_launches",
                                            labels=("kernel",))
                for name, n in px.LAUNCHES.items():
                    g.set(name, n)
            body, ctype = prom.negotiated(
                self.headers.get("Accept"),
                lambda ex: prom.render(self.node.metrics, exemplars=ex))
            self._send(200, body, ctype=ctype)
        elif path == "/debug":
            self._send(200, json.dumps(
                {"endpoints": self._DEBUG_INDEX}).encode())
        elif path == "/debug/vars":
            # expvar-style metrics dump (reference x/metrics.go /debug/vars)
            self._send(200, json.dumps(self.node.metrics.to_dict()).encode())
        elif path == "/debug/requests":
            # recent sampled request traces (net/trace /debug/requests)
            n = int(self._qs().get("n", "32"))
            self._send(200, json.dumps(self.node.traces.recent(n)).encode())
        elif path == "/debug/metrics":
            # serving-layer readout: cache hit rates, dispatch gate,
            # per-endpoint QPS + latency histograms 
            self._send(200, json.dumps(_serving_metrics(self.node)).encode())
        elif path == "/debug/traces":
            n = int(self._qs().get("n", "32"))
            self._send(200, json.dumps(self.node.tracer.sink.index(n),
                                       default=str).encode())
        elif path.startswith("/debug/traces/"):
            from dgraph_tpu_torch.obs import otrace

            rec = self.node.tracer.sink.get(path.rsplit("/", 1)[1])
            if rec is None:
                self._send(404, _envelope_err("ErrorInvalidRequest",
                                              "no such trace"))
            elif self._qs().get("view") == "tree":
                self._send(200, json.dumps(otrace.span_tree(rec),
                                           default=str).encode())
            else:
                self._send(200, json.dumps(otrace.chrome_trace(rec),
                                           default=str).encode())
        elif path == "/debug/slow":
            n = int(self._qs().get("n", "32"))
            self._send(200, json.dumps(self.node.slow_log.recent(n),
                                       default=str).encode())
        elif path == "/debug/top":
            qs = self._qs()
            self._send(200, json.dumps(self.node.cost_book.top(
                window_s=float(qs.get("window", "60")),
                by=qs.get("by", "device_ms"),
                group=qs.get("group", "shape"),
                n=int(qs.get("n", "20")),
                endpoint=qs.get("endpoint")), default=str).encode())
        elif path == "/debug/compiles":
            prof = self.node.devprof
            body = (prof.compiles_snapshot() if prof is not None
                    else {"enabled": False})
            self._send(200, json.dumps(body, default=str).encode())
        elif path == "/debug/timeline":
            prof = self.node.devprof
            if prof is None:
                self._send(200, json.dumps({"enabled": False}).encode())
            elif self._qs().get("view") == "raw":
                n = int(self._qs().get("n", "256"))
                self._send(200, json.dumps(
                    prof.timeline_snapshot(n), default=str).encode())
            else:
                self._send(200, json.dumps(
                    prof.timeline_chrome(), default=str).encode())
        elif path == "/debug/faults":
            self._send(200, json.dumps(faults.GLOBAL.snapshot()).encode())
        elif path in ("", "/ui"):
            # embedded query console (reference: the static dashboard
            # served by dgraph/cmd/server/dashboard.go)
            self._send(200, _DASHBOARD_HTML, ctype="text/html")
        else:
            self._send(404, _envelope_err("ErrorInvalidRequest", "no such path"))

    # endpoints that feed the per-endpoint QPS meters + latency histograms
    _OBSERVED = {"/query": "query", "/mutate": "mutate", "/commit": "commit",
                 "/abort": "abort", "/alter": "alter",
                 "/analytics": "analytics"}

    def do_POST(self):
        path = urlparse(self.path).path.rstrip("/")
        ep = self._OBSERVED.get(path)
        t0 = time.perf_counter()
        try:
            # the X-Dgraph-Tenant header scopes the whole request: every
            # predicate the body names resolves inside that namespace
            with tnc.scope(self._tenant()):
                if path == "/query":
                    self._query()
                elif path == "/subscribe":
                    self._subscribe()
                elif path == "/mutate":
                    self._mutate()
                elif path == "/commit":
                    self._commit()
                elif path == "/abort":
                    self._abort()
                elif path == "/alter":
                    self._alter()
                elif path == "/analytics":
                    self._analytics()
                elif path == "/admin/export":
                    self._admin_export()
                elif path == "/admin/shutdown":
                    self._admin_shutdown()
                elif path == "/admin/config/memory_mb":
                    self._admin_memory()
                elif path == "/admin/tenant":
                    self._admin_tenant()
                elif path == "/debug/faults":
                    self._debug_faults()
                else:
                    self._send(404, _envelope_err("ErrorInvalidRequest",
                                                  "no such path"))
        except TxnConflict as e:
            self._send(409, _envelope_err("ErrorAborted", str(e)))
        except DeadlineExceeded as e:
            # the request's ?timeoutMs= / --default_timeout_ms budget ran
            # out — typed, bounded, never a hang (504 Gateway Timeout)
            self._send(504, _envelope_err("ErrorDeadlineExceeded", str(e)))
        except ResourceExhausted as e:
            # shed under overload before consuming device time (429)
            self._send(429, _envelope_err("ErrorResourceExhausted", str(e)))
        except tnc.NamespaceError as e:
            # cross-namespace access / bad tenant name — typed, 403
            self._send(403, _envelope_err("ErrorNamespace", str(e)))
        except Exception as e:  # surface parse/exec errors in the envelope
            self._send(400, _envelope_err("ErrorInvalidRequest", str(e)))
        finally:
            if ep is not None:
                m = self.node.metrics
                m.meter(f"http_{ep}").mark()
                m.histogram(f"dgraph_http_{ep}_latency_s").observe(
                    time.perf_counter() - t0)

    # -- admin (reference dgraph/cmd/server/admin.go) -------------------------

    def _admin_export(self):
        """Export the served graph to RDF (admin.go export handler; the
        reference writes export/dgraph.r{ts} dirs next to the postings)."""
        import os
        import time as _time

        from dgraph_tpu_torch.loader.export import export_rdf

        qs = self._qs()
        base = qs.get("dest") or (
            os.path.join(self.node.store.dir, "export")
            if self.node.store.dir else "export")
        os.makedirs(base, exist_ok=True)
        # name and CONTENT use the same ts (the newest applied commit);
        # oracle.read_ts() may run ahead of it via assigned-not-committed
        # txns and would over-claim what the file contains
        ts = self.node.store.max_seen_commit_ts
        out = os.path.join(base, f"dgraph.r{ts}.rdf.gz")
        schema_out = os.path.join(base, f"dgraph.r{ts}.schema")
        t0 = _time.perf_counter()
        stats = export_rdf(self.node.store, out, read_ts=ts,
                           schema_path=schema_out)
        self._send(200, json.dumps(
            {"code": "Success", "message": "export completed",
             "file": out, "schema": schema_out, "quads": stats.quads,
             "predicates": stats.predicates,
             "seconds": round(_time.perf_counter() - t0, 2)}).encode())

    def _admin_shutdown(self):
        """Graceful stop (admin.go shutdown handler)."""
        import threading

        self._send(200, json.dumps(
            {"code": "Success", "message": "Server is shutting down"}).encode())
        # dgraph: allow(ctxvar-copy) one-shot shutdown helper thread
        threading.Thread(target=self.server.shutdown, daemon=True).start()

    def _debug_faults(self):
        """Drive the process-global fault-injection registry over HTTP
        (utils/faults.py; the chaos harness' live-process lever). Body:
        {"seed": N} reseeds the deterministic PRNG, {"spec": "name:mode:
        p[:delay_s][:count],..."} or {"install": {"name":..., "mode":...,
        "p":..., "delay_s":..., "count":...}} arms points, {"clear": true
        | "name"} disarms."""
        j = json.loads(self._read_body() or "{}")
        if "seed" in j:
            faults.GLOBAL.reseed(int(j["seed"]))
        if j.get("spec"):
            faults.GLOBAL.configure(j["spec"])
        if j.get("install"):
            ins = dict(j["install"])
            faults.GLOBAL.install(
                ins["name"], ins.get("mode", "error"),
                p=float(ins.get("p", 1.0)),
                delay_s=float(ins.get("delay_s", 0.0)),
                count=ins.get("count"))
        clear = j.get("clear")
        if clear:
            faults.GLOBAL.clear(None if clear is True else str(clear))
        self._send(200, json.dumps(faults.GLOBAL.snapshot()).encode())

    def _admin_memory(self):
        """Live memory budget reconfig + enforcement pass (the reference's
        POST /admin/config/memory_mb, admin.go)."""
        mb = int(self._read_body().strip() or 0)
        if mb <= 0:
            raise ValueError("body must be a positive memory_mb integer")
        # install budget + ensure the enforcement loop runs (it re-reads
        # the budget each tick, even when serve started without one), then
        # run one pass immediately
        self.node.set_memory_budget(mb * (1 << 20))
        stats = self.node.enforce_memory(mb * (1 << 20))
        self._send(200, json.dumps({"code": "Success", **stats}).encode())

    def _admin_tenant(self):
        """POST /admin/tenant — hot-reload the tenant QoS table. Body:
        {"tenants": {name: {weight, device_ms_per_s, edges_per_s,
        bytes_per_s, burst_s, max_subs, sub_queue_max}}} (or the bare
        name->spec map; "*" is the any-tenant default). ?replace=true
        swaps the whole table; otherwise specs merge and only the
        reconfigured tenants' buckets reset. Empty body = read back the
        current table."""
        body = self._read_body().strip()
        cfg = json.loads(body) if body else {}
        replace = self._qs().get("replace", "").lower() == "true"
        table = self.node.configure_tenants(cfg, replace=replace) \
            if cfg or replace else self.node.tenancy.table()
        self._send(200, json.dumps(
            {"code": "Success", "qos": self.node.qos_enabled,
             "tenants": table}).encode())

    def _analytics(self):
        """POST /analytics — whole-graph OLAP over one predicate's tablet
        (docs/ops.md "Analytics"). Body: {"kind": "pagerank"|"cc"|
        "triangles", "pred": "<predicate>", ...knobs}; ?timeoutMs= rides
        the query string like every other endpoint."""
        j = json.loads(self._read_body() or "{}")
        kind = str(j.get("kind", ""))
        pred = str(j.get("pred", ""))
        if not kind or not pred:
            raise ValueError('body must carry "kind" and "pred"')
        qs = self._qs()
        timeout_ms = qs.get("timeoutMs")
        t0 = time.perf_counter_ns()
        out = self.node.analytics(
            kind, pred,
            damping=float(j.get("damping", 0.85)),
            tol=float(j.get("tol", 1e-6)),
            max_iters=int(j.get("maxIters", j.get("max_iters", 100))),
            top=int(j.get("top", 20)),
            timeout_ms=float(timeout_ms) if timeout_ms else None,
            start_ts=int(j["startTs"]) if j.get("startTs") else None)
        ext = {"server_latency": {"total_ns": time.perf_counter_ns() - t0}}
        self._send(200, _envelope_ok({"analytics": out}, ext))

    def _query(self):
        body = self._read_body()
        variables = None
        q = body
        if self.headers.get("Content-Type", "").startswith("application/json"):
            j = json.loads(body)
            q = j.get("query", "")
            variables = j.get("variables")
        qs = self._qs()
        start_ts = qs.get("startTs")
        ro = qs.get("ro", qs.get("readOnly", "")).lower() == "true"
        edge_limit = qs.get("edgeLimit")   # per-request edge budget override
        explain = qs.get("explain", "").lower() == "true"
        timeout_ms = qs.get("timeoutMs")   # per-request deadline budget
        t0 = time.perf_counter_ns()
        out, ctx = self.node.query(
            q, variables, int(start_ts) if start_ts else None, read_only=ro,
            edge_limit=int(edge_limit) if edge_limit else None,
            explain=explain,
            timeout_ms=float(timeout_ms) if timeout_ms else None)
        ext = {"txn": {"start_ts": ctx.start_ts},
               "server_latency": {"total_ns": time.perf_counter_ns() - t0}}
        if explain:
            # the plan tree (est vs actual per step) rides the envelope's
            # extensions, keeping "data" byte-identical to a plain query
            ext["explain"] = out.pop("explain", None)
        self._send(200, _envelope_ok(out, ext))

    def _subscribe(self):
        """POST /subscribe — live query over Server-Sent Events. Body:
        {"query": "...", "vars": {...}, "cursor": ts, "heartbeat_s": s}.
        Each frame is `event: <init|ack|diff|resync|expire>` + `data:
        <canonical JSON>`; every data payload carries
        the commit watermark `at` it reflects. Comment-only heartbeat
        frames (`: hb`) flow after heartbeat_s of silence — the
        keep-alive a long-lived response otherwise lacks — and a failed
        write REAPS the subscription so a vanished client cannot pin its
        queue, cursor, or the journal retention floor forever."""
        from dgraph_tpu_torch.live.diff import canon

        body = self._read_body()
        j = json.loads(body) if body.strip() else {}
        if not isinstance(j, dict):
            raise ValueError("subscribe body must be a JSON object")
        q = j.get("query", "")
        variables = j.get("vars") or j.get("variables")
        cursor = j.get("cursor")
        hb = float(j.get("heartbeat_s") or self.node.live.heartbeat_s)
        m = self.node.metrics
        t0 = time.perf_counter()
        # registration (parse/validate/initial eval) errors surface as the
        # normal JSON error envelope — the stream only starts on success
        sub = self.node.subscribe(
            q, variables, cursor=int(cursor) if cursor is not None else None)
        m.meter("http_subscribe").mark()
        m.histogram("dgraph_http_subscribe_latency_s").observe(
            time.perf_counter() - t0)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Accel-Buffering", "no")
        self.end_headers()
        self.close_connection = True   # SSE has no Content-Length
        try:
            while True:
                try:
                    ev = sub.next(hb)
                except StopIteration:
                    break
                if ev is None:
                    self.wfile.write(b": hb\n\n")
                    self.wfile.flush()
                    m.counter("dgraph_subs_heartbeats_total").inc()
                    continue
                self.wfile.write(
                    f"event: {ev['type']}\ndata: {canon(ev)}\n\n".encode())
                self.wfile.flush()
        except (OSError, ConnectionError):
            self.node.live.reap(sub.id)
        finally:
            sub.cancel()

    def _mutate(self):
        body = self._read_body()
        qs = self._qs()
        commit_now = (qs.get("commitNow", "").lower() == "true"
                      or self.headers.get("X-Dgraph-CommitNow", "").lower()
                      == "true")
        start_ts = int(qs["startTs"]) if "startTs" in qs else None
        timeout_ms = (float(qs["timeoutMs"])
                      if qs.get("timeoutMs") else None)
        if self.headers.get("Content-Type", "").startswith("application/json"):
            j = json.loads(body)
            res = self.node.mutate(
                set_json=j.get("set"), delete_json=j.get("delete"),
                commit_now=commit_now, start_ts=start_ts,
                timeout_ms=timeout_ms)
            uids, ctx = res.uids, res.context
        elif body.lstrip().startswith("upsert"):
            # DQL upsert block through /mutate (dgraph/cmd/server/http.go
            # mutationHandler's upsert path)
            from dgraph_tpu_torch.query import dql
            req = dql.parse(body)
            _out, uids, ctx = self.node.upsert(
                req.upsert["query"], req.upsert["mutations"],
                start_ts=start_ts, commit_now=commit_now)
        else:
            sets, dels = _split_mutation_blocks(body)
            res = self.node.mutate(set_nquads=sets, del_nquads=dels,
                                   commit_now=commit_now, start_ts=start_ts,
                                   timeout_ms=timeout_ms)
            uids, ctx = res.uids, res.context
        self._send(200, _envelope_ok(
            {"code": "Success", "message": "Done",
             "uids": {k[2:]: hex(v) for k, v in uids.items()
                      if str(k).startswith("_:")}},
            {"txn": {"start_ts": ctx.start_ts,
                     "commit_ts": ctx.commit_ts,
                     "aborted": ctx.aborted}}))

    def _commit(self):
        start_ts = int(self._qs()["startTs"])
        commit_ts = self.node.commit(start_ts)
        self._send(200, _envelope_ok(
            {"code": "Success", "message": "Done"},
            {"txn": {"start_ts": start_ts, "commit_ts": commit_ts}}))

    def _abort(self):
        start_ts = int(self._qs()["startTs"])
        self.node.abort(start_ts)
        self._send(200, _envelope_ok({"code": "Success", "message": "Done"}))

    def _alter(self):
        body = self._read_body().strip()
        if body.startswith("{"):
            j = json.loads(body)
            if j.get("drop_all"):
                self.node.alter(drop_all=True)
            elif j.get("drop_attr"):
                self.node.alter(drop_attr=j["drop_attr"])
            else:
                raise ValueError("bad alter payload")
        else:
            self.node.alter(schema_text=body)
        self._send(200, _envelope_ok({"code": "Success", "message": "Done"}))


_SET_RE = re.compile(r"\bset\s*\{", re.S)
_DEL_RE = re.compile(r"\bdelete\s*\{", re.S)


def _split_mutation_blocks(body: str) -> tuple[str, str]:
    """Extract `set {...}` / `delete {...}` RDF payloads from a mutation body
    (the `{ set { <nquads> } }` HTTP format, dgraph/cmd/server/http.go)."""

    def grab(m: re.Match) -> str:
        depth, i = 1, m.end()
        while i < len(body) and depth:
            if body[i] == "{":
                depth += 1
            elif body[i] == "}":
                depth -= 1
            i += 1
        return body[m.end(): i - 1]

    sets = "\n".join(grab(m) for m in _SET_RE.finditer(body))
    dels = "\n".join(grab(m) for m in _DEL_RE.finditer(body))
    return sets, dels


def make_server(node: Node, host: str = "127.0.0.1", port: int = 8080,
                tls_cert: str | None = None,
                tls_key: str | None = None) -> ThreadingHTTPServer:
    """HTTP (or HTTPS when a cert+key pair is given — the reference's
    x/tls_helper.go server-side TLS surface)."""
    handler = type("BoundHandler", (_Handler,), {"node": node})
    srv = ThreadingHTTPServer((host, port), handler)
    if tls_cert and tls_key:
        import ssl
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(tls_cert, tls_key)
        srv.socket = ctx.wrap_socket(srv.socket, server_side=True)
    return srv


def serve_forever(node: Node, host: str = "127.0.0.1", port: int = 8080):
    srv = make_server(node, host, port)
    # dgraph: allow(ctxvar-copy) server accept loop: each request gets
    # its own fresh context at the handler
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
