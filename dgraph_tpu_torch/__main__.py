"""CLI of the PyTorch port: `python -m dgraph_tpu_torch <subcommand>`.

Port of dgraph_tpu/__main__.py's `serve`, `version`, `export`, `bulk`,
`live`, `worker`, `zero`, `ldbc_gen` and `convert`. `serve`
starts the port's Node behind the HTTP API (api/http.py) and the gRPC
api.Dgraph service (api/grpc_server.py), on the card by default: `--device`
is "cuda" unless given, and raises without CUDA (`--device cpu` runs the
plain PyTorch versions on the host). The flags are the JAX server's and
DGRAPH_TPU_<FLAG> environment variables set their defaults, as there.

As the JAX server, it serves with batching, the planner and the device
observatory on (`--no_batch`, `--no_planner` and `--no_devprof` turn each
off), an HBM working-set manager under `--device_budget_mb` (0 =
accounting only) with `--residency_pin` floors, and the `--memory_mb`
enforcement loop, the `--vector_*` IVF knobs, and the mesh: `--mesh`,
`--mesh_devices` and `--mesh_min_edges` reach the Node's MeshExecutor
(parallel/mesh_exec.py; on `--device cpu` the mesh repeats the CPU device).
`zero` runs the cluster coordinator (host only: timestamps, the oracle,
the tablet map, the placement controller under `--rebalance_interval_s`),
and `worker` serves one group's tablets over the internal gRPC protocol on
`--device` (cuda unless given); `parallel/client.ClusterClient` fans a
query's tasks out to the owning groups. Both print the JAX CLI's
`... serving ... on host:port` banners.

The loader chain users run: `ldbc_gen` writes an LDBC-SNB-shaped CSV dump,
`convert --ldbc` maps it to N-Quads plus a schema, `bulk` writes a posting
directory that `serve -p` answers from. `bulk`, `ldbc_gen` and `convert`
are host work; `live` loads through a Node on `--device` (cuda unless
given, like `serve`).
"""

from __future__ import annotations

import argparse
import sys

from dgraph_tpu_torch.utils import log

VERSION = "dgraph-tpu 0.2.0 (dgraph_tpu_torch)"


def cmd_serve(args) -> int:
    from dgraph_tpu_torch.api.http import make_server
    from dgraph_tpu_torch.api.server import Node

    lg = log.get_logger("serve")
    node = Node(dirpath=args.postings, trace_fraction=args.trace,
                memory_mb=args.memory_mb or None,
                plan_cache_size=args.plan_cache,
                task_cache_mb=args.task_cache_mb,
                result_cache_mb=args.result_cache_mb,
                dispatch_width=args.dispatch_width,
                batching=not args.no_batch,
                batch_window_ms=args.batch_window_ms,
                batch_max=args.batch_max,
                write_batch=not args.no_write_batch,
                write_window_ms=args.write_window_ms,
                write_batch_max=args.write_batch_max,
                overlay=not args.no_overlay,
                overlay_max_keys=args.overlay_max_keys,
                overlay_max_age_s=args.overlay_max_age_s,
                background_rollup=not args.no_background_rollup,
                fold_workers=args.fold_workers or None,
                planner=not args.no_planner,
                stats_top_k=args.stats_top_k,
                span_sample=args.span_sample,
                slow_query_ms=args.slow_query_ms,
                slow_query_log=args.slow_query_log,
                mesh_devices=(args.mesh_devices or (-1 if args.mesh else 0)),
                mesh_min_edges=args.mesh_min_edges or None,
                default_timeout_ms=args.default_timeout_ms,
                vector_nprobe=args.vector_nprobe,
                vector_centroids=args.vector_centroids,
                vector_ivf_min_rows=args.vector_ivf_min_rows,
                device_budget_mb=args.device_budget_mb,
                residency_pin=args.residency_pin,
                cost_ledger=not args.no_cost_ledger,
                cost_regression_factor=args.cost_regression_factor,
                lazy_folds=not args.no_lazy_folds,
                delta_journal_max_keys=args.delta_journal_max_keys or None,
                devprof=not args.no_devprof,
                qos=not args.no_qos,
                tenants=args.tenants or None,
                device=args.device)
    grpc_srv = None
    try:
        if args.faults or args.faults_seed is not None:
            from dgraph_tpu_torch.utils import faults as faults_mod

            if args.faults_seed is not None:    # 0 is a valid seed
                faults_mod.GLOBAL.reseed(args.faults_seed)
            if args.faults:
                faults_mod.GLOBAL.configure(args.faults)
            lg.info("fault injection armed", points=args.faults or "",
                    seed=args.faults_seed)
        if args.memory_mb:
            node.set_memory_budget(args.memory_mb * (1 << 20))
        if args.schema:
            with open(args.schema) as f:
                node.alter(schema_text=f.read())
        if args.grpc_port:
            from dgraph_tpu_torch.api.grpc_server import serve_grpc
            grpc_srv, gport = serve_grpc(node,
                                         f"{args.host}:{args.grpc_port}",
                                         tls_cert=args.tls_cert,
                                         tls_key=args.tls_key)
            # startup banners keep the "<role> serving ... on host:port"
            # shape: tests and scripts parse the bound port out of text mode
            lg.info(f"serving gRPC on {args.host}:{gport}",
                    tls=bool(args.tls_cert))
        srv = make_server(node, args.host, args.port,
                          tls_cert=args.tls_cert, tls_key=args.tls_key)
        lg.info(f"serving HTTP{'S' if args.tls_cert else ''} on "
                f"{args.host}:{srv.server_address[1]}",
                postings=args.postings or "<memory>", device=node.device)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
    finally:
        if grpc_srv is not None:
            grpc_srv.stop(0)
        node.close()
    return 0


def cmd_version(_args) -> int:
    log.get_logger("version").info(VERSION)
    return 0


def cmd_export(args) -> int:
    from dgraph_tpu_torch.loader.export import export_rdf
    from dgraph_tpu_torch.storage.store import Store

    store = Store(args.postings)
    try:
        stats = export_rdf(store, args.out, schema_path=args.out_schema)
    finally:
        store.close()
    log.get_logger("export").info("export done", quads=stats.quads,
                                  predicates=stats.predicates, out=args.out)
    return 0


def cmd_bulk(args) -> int:
    from dgraph_tpu_torch.loader.bulk import bulk_load

    lg = log.get_logger("bulk")
    schema = ""
    if args.schema:
        with open(args.schema) as f:
            schema = f.read()
    stats = bulk_load(args.files, schema, args.out, workers=args.workers,
                      spill_mb=args.spill_mb or None,
                      xidmap_cache=_xidmap_entries(args.xidmap_cache_mb),
                      progress=lambda n: lg.info("parsing", quads=n))
    fields = dict(postings=stats.edges, uid_edges=stats.uid_edges,
                  values=stats.values, nodes=stats.nodes,
                  predicates=stats.predicates,
                  seconds=round(stats.seconds, 1), out=args.out)
    if args.spill_mb:
        fields.update(spill_runs=stats.spill_runs,
                      spill_mb=round(stats.spill_bytes / (1 << 20), 1),
                      merge_fanin=stats.merge_fanin,
                      xidmap_hit_rate=round(stats.xidmap_hit_rate, 4))
    lg.info("bulk load done", **fields)
    return 0


def _xidmap_entries(cache_mb) -> int | None:
    """--xidmap_cache_mb → resident-entry bound (~96B per mapping: short
    key string + dict slot + uid)."""
    if not cache_mb:
        return None
    return max(1, int(cache_mb * (1 << 20)) // 96)


def cmd_live(args) -> int:
    from dgraph_tpu_torch.api.server import Node
    from dgraph_tpu_torch.loader.live import live_load

    lg = log.get_logger("live")
    node = Node(dirpath=args.postings, device=args.device)
    if args.schema:
        with open(args.schema) as f:
            node.alter(schema_text=f.read())
    try:
        stats = live_load(node, args.files, batch=args.batch,
                          xidmap_path=args.xidmap,
                          xidmap_cache=_xidmap_entries(args.xidmap_cache_mb),
                          progress=lambda n: lg.info("loading", quads=n))
    finally:
        node.close()
    lg.info("live load done", quads=stats.quads, txns=stats.txns,
            retried_aborts=stats.aborts, postings=args.postings)
    return 0


def cmd_worker(args) -> int:
    """Serve one group's tablets over the internal wire protocol
    (the reference's worker gRPC on port 7080). With --zero it registers
    with the cluster coordinator (worker/groups.go:62 StartRaftNodes's
    connect step); replication roles arrive via the Promote RPC. The
    worker's expands run on --device (cuda unless given; it fails
    without a card)."""
    import time

    from dgraph_tpu_torch.parallel.remote import serve_worker
    from dgraph_tpu_torch.storage.store import Store
    from dgraph_tpu_torch.utils.schema import parse_schema

    lg = log.get_logger("worker")
    store = Store(args.postings,
                  max_delta_keys=args.delta_journal_max_keys or None)
    if args.schema:
        with open(args.schema) as f:
            for e in parse_schema(f.read()):
                store.set_schema(e)
    server, port = serve_worker(store, f"{args.host}:{args.port}",
                                elections=True,
                                advertise_host=args.advertise_host,
                                batching=not args.no_batch,
                                batch_window_ms=args.batch_window_ms,
                                batch_max=args.batch_max,
                                cost_ledger=not args.no_cost_ledger,
                                lazy_folds=not args.no_lazy_folds,
                                device=args.device)
    if args.zero:
        import threading

        from dgraph_tpu_torch.coord.zero_service import ZeroClient

        zc = ZeroClient(args.zero)
        svc = server.dgt_svc
        my_addr = svc.advertise_addr
        # a worker booting while the zeros are still electing (multi-zero
        # bootstrap) must wait for a leader, not die: retry the initial
        # registration against transient transport / not-leader rejections
        deadline = time.monotonic() + 60
        while True:
            try:
                group, rid = zc.connect(my_addr, args.group)
                break
            except Exception as e:      # noqa: BLE001 — startup retry
                if time.monotonic() >= deadline:
                    raise
                lg.info("zero not ready; retrying connect",
                        error=type(e).__name__)
                time.sleep(0.5)
        lg.info("worker joined group", group=group, replica=rid)

        def _learn_members():
            # seed the wire-election membership from Zero's registry so a
            # replica set can self-elect even when the control plane later
            # dies (the members list keeps working from cache)
            st = zc.state()
            members = st.get("groups", {}).get(str(group), {}) \
                        .get("members", [])
            if members:
                svc.group_members = sorted(set(members) | {my_addr})

        try:
            _learn_members()
        except Exception:
            pass

        def membership_loop():
            # periodic re-registration (worker/groups.go:454
            # periodicMembershipUpdate): survives a zero restart and keeps
            # the registry a liveness signal, not a one-shot record
            while True:
                time.sleep(args.membership_interval)
                try:
                    zc.connect(my_addr, group)
                    _learn_members()
                except Exception:
                    pass                   # zero down: next tick retries

        if args.membership_interval > 0:
            # dgraph: allow(ctxvar-copy) detached membership bg loop
            threading.Thread(target=membership_loop, daemon=True).start()
    lg.info(f"worker serving {len(store.predicates())} tablets on "
            f"{args.host}:{port} device={server.dgt_svc.device}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop(0)
        store.close()
    return 0


def cmd_zero(args) -> int:
    """Run the cluster coordinator as its own process (reference
    `dgraph zero`, dgraph/cmd/zero/run.go:58): timestamp/uid leases, the
    SSI oracle, and the tablet map over the internal protocol."""
    import threading
    import time

    from dgraph_tpu_torch.coord.zero import Zero
    from dgraph_tpu_torch.coord.zero_service import (ZeroOps, serve_zero,
                                                     serve_zero_http)

    lg = log.get_logger("zero")
    zero = Zero(n_groups=args.groups, dirpath=args.wal)
    from dgraph_tpu_torch.coord.zero_service import ZeroReplica, ZeroService

    svc = ZeroService(zero)
    replica = None
    if args.peers:
        if not args.wal:
            raise SystemExit("--peers (multi-zero) requires --wal")
        members = [a.strip() for a in args.peers.split(",") if a.strip()]
        advertise = members[args.idx]
        replica = ZeroReplica(svc, args.wal, advertise, members,
                              bootstrap_leader=args.idx == 0)
    server, port, svc = serve_zero(zero, f"{args.host}:{args.port}", svc=svc)
    if replica is not None:
        replica.start()
        lg.info("zero replica up", idx=args.idx,
                members=len(replica.members), leader=replica.is_leader)
    ops = ZeroOps(svc)
    controller = None
    if args.rebalance_interval_s > 0 and not args.no_rebalance:
        # load-aware placement controller (coord/placement.py): scores
        # tablets by size x measured load from the workers' Status
        # reports and heals skew with moves + hot-tablet read replicas
        from dgraph_tpu_torch.coord.placement import (PlacementConfig,
                                                      PlacementController,
                                                      ZeroOpsExecutor,
                                                      wire_collect)

        class _DynamicZero:
            # multi-zero promotion swaps svc.zero; always read through ops
            def tablets(self):
                return ops.zero.tablets()

            def replicas(self):
                return ops.zero.replicas()

            def moving_tablets(self):
                return ops.zero.moving_tablets()

        cfg = PlacementConfig(threshold=args.rebalance_threshold,
                              max_replicas=args.max_replicas)
        controller = PlacementController(
            _DynamicZero(), wire_collect(ops), ZeroOpsExecutor(ops),
            cfg=cfg, logger=lg)
        controller.start(args.rebalance_interval_s)
        lg.info("placement controller up",
                interval_s=args.rebalance_interval_s,
                threshold=args.rebalance_threshold,
                max_replicas=args.max_replicas)
    httpd, hport = serve_zero_http(svc, ops, args.host, args.http_port,
                                   controller=controller)
    lg.info(f"zero ops HTTP on {args.host}:{hport}")
    if args.rebalance_interval > 0 and not args.no_rebalance:
        def loop():
            while True:
                time.sleep(args.rebalance_interval)
                try:
                    out = ops.rebalance_once()
                    if out:
                        lg.info("rebalanced", **out)
                except Exception as e:       # noqa: BLE001 — next tick retries
                    lg.error("rebalance error", error=str(e))
        # dgraph: allow(ctxvar-copy) detached console-stats bg loop
        threading.Thread(target=loop, daemon=True).start()
    lg.info(f"zero serving {args.groups} groups on {args.host}:{port}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        server.stop(0)
    return 0


def cmd_ldbc_gen(args) -> int:
    """Deterministic LDBC-SNB-shaped synthetic CSV dump:
    `ldbc_gen --sf 1 --out dump/` then `convert --ldbc dump/` then
    `bulk -f` is the scale battery's zero-dependency ingest path."""
    from dgraph_tpu_torch.models.ldbc import generate_ldbc

    lg = log.get_logger("ldbc_gen")
    st = generate_ldbc(args.out, sf=args.sf, seed=args.seed)
    lg.info("ldbc_gen done", sf=st.sf, persons=st.persons, knows=st.knows,
            posts=st.posts, comments=st.comments, edges=st.edges,
            out=args.out)
    return 0


def cmd_convert(args) -> int:
    lg = log.get_logger("convert")
    if args.ldbc:
        from dgraph_tpu_torch.loader.convert import convert_ldbc

        stats = convert_ldbc(args.ldbc, args.out)
        lg.info("ldbc convert done", persons=stats.persons,
                knows=stats.knows, posts=stats.posts,
                triples=stats.triples, out=args.out)
        return 0
    if not args.geo:
        raise SystemExit("convert needs --geo <file> or --ldbc <dir>")
    from dgraph_tpu_torch.loader.convert import convert_geojson

    stats = convert_geojson(args.geo, args.out, geopred=args.geopred)
    lg.info("convert done", features=stats.features,
            triples=stats.triples, out=args.out)
    return 0


def _apply_env_defaults(sp: argparse.ArgumentParser) -> None:
    """DGRAPH_TPU_<FLAG> environment variables override flag defaults
    (the reference's viper env binding: every cobra flag doubles as an env
    key). Explicit command-line values still win."""
    import os

    for action in sp._actions:
        if not action.option_strings or action.dest == "help":
            continue
        env = os.environ.get(f"DGRAPH_TPU_{action.dest.upper()}")
        if env is None:
            continue
        if action.type is int:
            action.default = int(env)
        elif action.type is float:
            action.default = float(env)
        elif isinstance(action, argparse._StoreTrueAction):
            action.default = env.lower() in ("1", "true", "yes")
        elif action.nargs in ("+", "*"):
            action.default = env.split(",")
        else:
            action.default = env
        action.required = False


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dgraph_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve", help="run the embedded server (HTTP API)")
    sp.add_argument("--device", default="cuda",
                    help="torch device the Node's snapshots live on "
                         "(default cuda, which fails without CUDA; cpu "
                         "runs the plain PyTorch versions on the host)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--grpc_port", type=int, default=9080,
                    help="gRPC api.Dgraph port (0 disables)")
    sp.add_argument("-p", "--postings", default=None,
                    help="durable posting dir (default: in-memory)")
    sp.add_argument("--schema", default=None, help="schema file to apply")
    sp.add_argument("--trace", type=float, default=1.0,
                    help="fraction of requests to trace (/debug/requests)")
    sp.add_argument("--span_sample", type=float, default=0.01,
                    help="fraction of requests getting a full span trace "
                         "(/debug/traces; Chrome trace JSON per trace; "
                         "set 1.0 when debugging a specific query)")
    sp.add_argument("--slow_query_ms", type=float, default=0.0,
                    help="log queries slower than this to /debug/slow "
                         "(plan + span tree; 0 disables)")
    sp.add_argument("--slow_query_log", default=None,
                    help="also append slow-query entries to this JSONL file")
    sp.add_argument("--no_cost_ledger", action="store_true",
                    help="disable the per-request cost ledger (/debug/top "
                         "profiler, dgraph_query_cost_* histograms, "
                         "regression flags; <2%% overhead armed)")
    sp.add_argument("--cost_regression_factor", type=float, default=4.0,
                    help="flag a query into /debug/slow when its device "
                         "cost exceeds this multiple of its plan-shape's "
                         "EWMA baseline (needs 8 warmup samples)")
    sp.add_argument("--no_devprof", action="store_true",
                    help="disable the device-runtime observatory (kernel "
                         "build tracking, HBM telemetry, "
                         "/debug/compiles + /debug/timeline; zero overhead "
                         "when off)")
    sp.add_argument("--plan_cache", type=int, default=256,
                    help="parsed-plan cache entries (0 disables)")
    sp.add_argument("--task_cache_mb", type=int, default=64,
                    help="task-result cache budget in MB (0 disables)")
    sp.add_argument("--result_cache_mb", type=int, default=32,
                    help="query-result cache budget in MB (0 disables)")
    sp.add_argument("--batch_window_ms", type=float, default=2.0,
                    help="batched-dispatch collect window in ms; a batch "
                         "fires immediately when the device is idle")
    sp.add_argument("--batch_max", type=int, default=16,
                    help="max tasks packed into one batched device kernel")
    sp.add_argument("--no_batch", action="store_true",
                    help="disable batched multi-query device execution "
                         "(exact per-task dispatch)")
    sp.add_argument("--write_window_ms", type=float, default=2.0,
                    help="group-commit collect window in ms; a window "
                         "fires immediately when the journal is idle")
    sp.add_argument("--write_batch_max", type=int, default=64,
                    help="max txns committed per group-commit window "
                         "(one WAL append + one fsync per window)")
    sp.add_argument("--no_write_batch", action="store_true",
                    help="disable group-commit write batching (exact "
                         "per-commit WAL append + fsync)")
    sp.add_argument("--dispatch_width", type=int, default=4,
                    help="max simultaneous device dispatches")
    sp.add_argument("--no_overlay", action="store_true",
                    help="disable delta-overlay stamping (commits re-fold "
                         "their whole tablet)")
    sp.add_argument("--overlay_max_keys", type=int, default=None,
                    help="overlay depth ceiling before inline compaction "
                         "(default 512)")
    sp.add_argument("--overlay_max_age_s", type=float, default=None,
                    help="overlay age before background rollup (default 30)")
    sp.add_argument("--no_background_rollup", action="store_true",
                    help="disable the background overlay compaction loop")
    sp.add_argument("--delta_journal_max_keys", type=int, default=0,
                    help="per-predicate delta-journal key bound (0 = "
                         "default 8192); size to the working set a live "
                         "subscriber may fall behind by — overflow forces "
                         "affected subscriptions through a full resync")
    sp.add_argument("--fold_workers", type=int, default=0,
                    help="parallel tablet-fold threads (0 = auto)")
    sp.add_argument("--no_lazy_folds", action="store_true",
                    help="fold every tablet eagerly at snapshot assembly "
                         "instead of "
                         "on-demand at first read")
    sp.add_argument("--no_planner", action="store_true",
                    help="disable the cost-based query planner "
                         "(restores parse-order execution)")
    sp.add_argument("--stats_top_k", type=int, default=8,
                    help="top-K term-frequency sketch size per index "
                         "tokenizer (EXPLAIN / stats readout)")
    sp.add_argument("--mesh", action="store_true",
                    help="mesh deployment mode: shard large tablets across "
                         "every visible device and fuse multi-hop "
                         "traversals")
    sp.add_argument("--mesh_devices", type=int, default=0,
                    help="shard over the first N devices instead of all "
                         "(implies --mesh; 0 = follow --mesh; on --device "
                         "cpu, N repeats of the CPU device)")
    sp.add_argument("--mesh_min_edges", type=int, default=0,
                    help="tablets below this edge count stay replicated on "
                         "the classic path (0 = default 65536)")
    sp.add_argument("--vector_nprobe", type=int, default=0,
                    help="IVF coarse lists scanned per similar_to probe "
                         "(0 = default 8; higher = recall, lower = speed)")
    sp.add_argument("--vector_centroids", type=int, default=-1,
                    help="IVF centroid count built at snapshot fold "
                         "(-1 = auto ~sqrt(rows), clamped to [8, 1024])")
    sp.add_argument("--vector_ivf_min_rows", type=int, default=0,
                    help="embedding tablets below this row count stay "
                         "brute-force exact (0 = default 4096)")
    sp.add_argument("--device_budget_mb", type=int, default=0,
                    help="device (HBM) byte budget for the working-set "
                         "manager; tablets admit/evict by load score and "
                         "graphs larger than the budget serve through the "
                         "host tiers (0 = unbounded)")
    sp.add_argument("--residency_pin", default="",
                    help="comma-separated predicates pinned in the HBM "
                         "tier (never evicted by the working-set manager)")
    sp.add_argument("--memory_mb", type=int, default=0,
                    help="posting-list memory budget; periodic rollup + "
                         "cache drop keeps usage under it (0 = unbounded)")
    sp.add_argument("--default_timeout_ms", type=float, default=0,
                    help="end-to-end deadline budget for requests without "
                         "an explicit ?timeoutMs= — consumed at every wait "
                         "point, typed DeadlineExceeded on overrun, never "
                         "a hang (0 = unbudgeted)")
    sp.add_argument("--tenants", default=None,
                    help="tenant QoS table: a JSON file path or inline "
                         'JSON {"tenants": {name: {weight, '
                         "device_ms_per_s, edges_per_s, bytes_per_s, "
                         "burst_s, max_subs, sub_queue_max}}}; hot-"
                         "reloadable via POST /admin/tenant")
    sp.add_argument("--no_qos", action="store_true",
                    help="disarm quota admission + weighted-fair device "
                         "scheduling (namespaces stay active; a single-"
                         "tenant deployment is byte-identical either way)")
    sp.add_argument("--faults", default=None,
                    help="arm fault injection: 'name:mode:p[:delay_s]"
                         "[:count],...' over the points in docs/ops.md "
                         "(modes error/delay/drop; chaos testing only)")
    sp.add_argument("--faults_seed", type=int, default=None,
                    help="deterministic PRNG seed for --faults schedules "
                         "(same seed replays the same fault sequence; "
                         "0 is a valid seed)")
    sp.add_argument("--tls_cert", default=None,
                    help="PEM certificate: serve HTTP and gRPC over TLS")
    sp.add_argument("--tls_key", default=None, help="PEM private key")
    sp.set_defaults(fn=cmd_serve)

    vp = sub.add_parser("version", help="print version")
    vp.set_defaults(fn=cmd_version)

    bp = sub.add_parser("bulk", help="offline bulk load RDF(.gz) -> snapshot")
    bp.add_argument("-f", "--files", nargs="+", required=True)
    bp.add_argument("-s", "--schema", default=None)
    bp.add_argument("-o", "--out", required=True, help="output posting dir")
    bp.add_argument("-j", "--workers", type=int, default=None)
    bp.add_argument("--spill_mb", type=float, default=0,
                    help="out-of-core map buffer budget in MB: mapped edges "
                         "spill as sorted runs and the reduce streams a "
                         "k-way merge — peak RAM stops scaling with graph "
                         "size, output byte-identical (0 = all in RAM)")
    bp.add_argument("--xidmap_cache_mb", type=float, default=0,
                    help="resident bound for the sharded xid→uid map; "
                         "cold shards page to disk (0 = unbounded)")
    bp.set_defaults(fn=cmd_bulk)

    ep = sub.add_parser("export", help="export a posting dir to RDF(.gz)")
    ep.add_argument("-p", "--postings", required=True)
    ep.add_argument("-o", "--out", required=True)
    ep.add_argument("--out-schema", default=None)
    ep.set_defaults(fn=cmd_export)

    lp = sub.add_parser("live", help="online load RDF through transactions")
    lp.add_argument("-f", "--files", nargs="+", required=True)
    lp.add_argument("-s", "--schema", default=None)
    lp.add_argument("-p", "--postings", required=True,
                    help="durable posting dir (an in-memory load would be "
                         "discarded at exit)")
    lp.add_argument("--batch", type=int, default=1000)
    lp.add_argument("--xidmap", default=None,
                    help="crash-resumable identity log: re-running an "
                         "interrupted load reuses already-assigned uids")
    lp.add_argument("--xidmap_cache_mb", type=float, default=0,
                    help="resident bound for the sharded xid→uid map "
                         "(needs --xidmap; cold shards page to "
                         "<xidmap>.shards/; 0 = unbounded)")
    lp.add_argument("--device", default="cuda",
                    help="torch device the loading Node's snapshots live "
                         "on (default cuda, which fails without CUDA)")
    lp.set_defaults(fn=cmd_live)

    wp = sub.add_parser("worker", help="serve one group's tablets over the "
                                       "internal worker protocol")
    wp.add_argument("--host", default="127.0.0.1")
    wp.add_argument("--port", type=int, default=7080)
    wp.add_argument("-p", "--postings", required=True)
    wp.add_argument("--schema", default=None, help="schema file to apply")
    wp.add_argument("--zero", default=None,
                    help="zero address to register with (host:port)")
    wp.add_argument("--group", type=int, default=-1,
                    help="group to join (-1 = let zero assign)")
    wp.add_argument("--advertise_host", default=None,
                    help="host peers should dial back (needed when binding "
                         "0.0.0.0, e.g. in containers)")
    wp.add_argument("--membership_interval", type=float, default=30,
                    help="seconds between membership re-registrations with "
                         "zero (0 = register once)")
    wp.add_argument("--batch_window_ms", type=float, default=2.0,
                    help="batched-dispatch collect window in ms; a batch "
                         "fires immediately when the device is idle")
    wp.add_argument("--batch_max", type=int, default=16,
                    help="max tasks packed into one batched device kernel")
    wp.add_argument("--no_batch", action="store_true",
                    help="disable batched multi-query device execution "
                         "(exact per-task dispatch)")
    wp.add_argument("--no_cost_ledger", action="store_true",
                    help="disable per-RPC cost accounting + the cost "
                         "record shipped back in ServeTask trailing "
                         "metadata")
    wp.add_argument("--no_lazy_folds", action="store_true",
                    help="fold every tablet eagerly at snapshot assembly "
                         "instead of on-demand at first read")
    wp.add_argument("--delta_journal_max_keys", type=int, default=0,
                    help="per-predicate delta-journal key bound (0 = "
                         "default 8192)")
    wp.add_argument("--device", default="cuda",
                    help="torch device the worker's snapshots and expands "
                         "run on (default cuda, which fails without CUDA; "
                         "cpu runs the plain PyTorch versions on the host)")
    wp.set_defaults(fn=cmd_worker)

    zp = sub.add_parser("zero", help="run the cluster coordinator process")
    zp.add_argument("--host", default="127.0.0.1")
    zp.add_argument("--port", type=int, default=5080)
    zp.add_argument("--http_port", type=int, default=0,
                    help="ops HTTP port: /state /moveTablet /removeNode "
                         "(0 = ephemeral)")
    zp.add_argument("--groups", type=int, default=1,
                    help="number of server groups to balance tablets over")
    zp.add_argument("-w", "--wal", default=None,
                    help="durable state dir: lease ceilings + tablet map "
                         "survive restarts (a crash skips at most one "
                         "10k lease block, assign.go semantics)")
    zp.add_argument("--rebalance_interval", type=float, default=0,
                    help="seconds between LEGACY size-based rebalance ticks "
                         "(tablet.go:60-74; 0 = off)")
    zp.add_argument("--rebalance_interval_s", type=float, default=0,
                    help="seconds between load-aware placement controller "
                         "ticks (coord/placement.py: scores tablets by "
                         "size x measured load, heals skew with moves + "
                         "hot-tablet read replicas; 0 = off)")
    zp.add_argument("--rebalance_threshold", type=float, default=0.35,
                    help="group utilization spread (max-min)/max above "
                         "which the controller acts")
    zp.add_argument("--max_replicas", type=int, default=2,
                    help="read-replica holders per tablet (0 disables "
                         "replication; moves still run)")
    zp.add_argument("--no_rebalance", action="store_true",
                    help="disable ALL automatic placement (both the "
                         "size-based tick and the load controller): "
                         "placement stays exactly as manual moves left it")
    zp.add_argument("--peers", default="",
                    help="multi-zero: comma-separated addresses of ALL "
                         "zeros (incl. this one); state replicates to a "
                         "quorum and standbys elect on leader failure "
                         "(reference --peer, dgraph/cmd/zero/run.go)")
    zp.add_argument("--idx", type=int, default=0,
                    help="this zero's position in --peers (0 bootstraps "
                         "as leader)")
    zp.set_defaults(fn=cmd_zero)

    gp = sub.add_parser("ldbc_gen",
                        help="deterministic LDBC-SNB-shaped synthetic "
                             "CSV dump (feed to `convert --ldbc`)")
    gp.add_argument("--sf", type=float, default=0.1,
                    help="scale factor (persons ~ 10000*sf^0.85)")
    gp.add_argument("--out", required=True, help="output CSV dump dir")
    gp.add_argument("--seed", type=int, default=20260804,
                    help="generator seed (same sf+seed => same bytes)")
    gp.set_defaults(fn=cmd_ldbc_gen)

    cp = sub.add_parser("convert",
                        help="GeoJSON or LDBC-SNB CSV -> RDF (.rdf.gz)")
    cp.add_argument("--geo", default=None,
                    help="GeoJSON file (optionally .gz)")
    cp.add_argument("--ldbc", default=None,
                    help="LDBC-SNB interactive CSV dump dir (persons/"
                         "knows/posts subset mapped to N-Quads)")
    cp.add_argument("--out", default="output.rdf.gz")
    cp.add_argument("--geopred", default="loc",
                    help="predicate for geometries")
    cp.set_defaults(fn=cmd_convert)

    for sp_ in (sp, bp, ep, lp, cp, wp, zp):
        sp_.add_argument("--log_json", action="store_true",
                         help="structured single-line JSON logs instead of "
                              "text (log shippers ingest these directly)")
        _apply_env_defaults(sp_)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "log_json", False):
        log.configure(json_mode=True)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
