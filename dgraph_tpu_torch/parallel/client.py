"""Cluster client: DQL + mutations against a multi-PROCESS cluster.

Port of dgraph_tpu/parallel/client.py. The client assembles no tablets:
its snapshot is empty and host-only, every tablet's task runs on the
owning worker's device.

Reference semantics: a dgo/api.Dgraph client talks to any server, which
coordinates with Zero (timestamps, uid leases, commit decisions) and fans
sub-queries/mutation slices to the owning groups over the internal
protocol (edgraph/server.go + worker/*OverNetwork). Here the coordinator
role runs client-side: every coordination hop — Zero lease/oracle RPCs,
ServeTask/Mutate/Decide/Sort/Schema to group leaders — crosses a process
boundary, none of it shared memory.
"""

from __future__ import annotations

import time

from .. import tenancy as tnc
from ..coord.zero import TxnConflict
from ..coord.zero_service import ZeroClient
from ..obs import costs, otrace
from ..query import dql
from ..query import mutation as mut
from ..query import rdf
from ..query.engine import Executor
from ..storage.csr_build import GraphSnapshot
from ..storage.postings import Op
from ..utils import deadline as dl
from ..utils.deadline import DeadlineExceeded
from ..utils.errors import Unavailable
from ..utils.retry import CommitAmbiguous, RetryPolicy, transport_errors
from ..utils.schema import SchemaState, parse_schema
from .remote import NetworkDispatcher, RemoteWorker


class _LeaseAdapter:
    """assign_uids() expects the UidLease surface; lease blocks over RPC."""

    def __init__(self, zero: ZeroClient) -> None:
        self.zero = zero
        self._hwm = 0

    def assign(self, n: int) -> tuple[int, int]:
        first = self.zero.assign_uids(n)
        return first, first + n - 1

    def bump_to(self, uid: int) -> None:
        # explicit client uids: lease past them so blank nodes can't collide
        if uid > self._hwm:
            self.zero.assign_uids(max(uid - self._hwm, 1))
            self._hwm = uid


class _CachedZero:
    """ZeroClient wrapper with a TTL'd tablet map: the dispatcher consults
    tablets() per task, and a State RPC per task would make every k-hop
    query pay k full-membership round trips."""

    TTL = 1.0

    def __init__(self, zero: ZeroClient) -> None:
        self._zero = zero
        self._tablets: dict | None = None
        self._at = 0.0

    def tablets(self) -> dict[str, int]:
        now = time.monotonic()
        if self._tablets is None or now - self._at > self.TTL:
            self._tablets = self._zero.tablets()
            self._at = now
        return self._tablets

    def invalidate(self) -> None:
        self._tablets = None

    def __getattr__(self, name):
        return getattr(self._zero, name)


class _FrozenZero:
    """Degraded-mode tablet routing: the last tablet map this client saw,
    frozen. Only the read fan-out consults it (NetworkDispatcher.tablets);
    anything that would need the LIVE coordinator raises."""

    def __init__(self, tablet_map: dict) -> None:
        self._tablets = {a: int(g) for a, g in (tablet_map or {}).items()}

    def tablets(self) -> dict[str, int]:
        return self._tablets


class ClusterClient:
    """Client of one Zero process + N group replica sets."""

    # leader/schema caches: failover re-discovers on the mutate retry path
    CACHE_TTL = 1.0

    def __init__(self, zero_addr: str,
                 groups: dict[int, list[str]],
                 span_sample: float = 0.0, trace_rng=None,
                 default_timeout_ms: float = 0.0,
                 degraded_reads: bool = True,
                 retry_rng=None,
                 cost_ledger: bool = True) -> None:
        """groups: group id -> replica worker addresses (leader discovered
        via Status polling, re-discovered on failover). Each group is a
        HedgedReplicas set: reads hedge to a second replica after a grace
        period, a background echo loop feeds routing (worker/task.go:75,
        conn/pool.go:153).

        default_timeout_ms > 0 gives every query/mutate without an
        explicit timeout_ms an end-to-end deadline (utils/deadline) —
        propagated over every RPC, consumed at every wait point, typed
        DeadlineExceeded on overrun. degraded_reads keeps queries serving
        from the last known Zero state (read-only, stale snapshot,
        annotated via `last_degraded`) when Zero stops answering, instead
        of erroring outright."""
        from .remote import HedgedReplicas
        from ..query.qcache import DispatchGate, TaskResultCache
        from ..utils import metrics as metrics_mod

        self.metrics = metrics_mod.Registry()
        self.zero = _CachedZero(ZeroClient(zero_addr))
        self.replicas = {g: HedgedReplicas(addrs, metrics=self.metrics)
                         for g, addrs in groups.items()}
        self.groups = {g: hr.workers for g, hr in self.replicas.items()}
        self._leases = _LeaseAdapter(self.zero)
        self._schema: tuple[float, SchemaState] | None = None
        # client-side serving tier: replayed task shapes skip the wire,
        # concurrent identical tasks share one RPC, and the gate bounds
        # simultaneous fan-out RPCs per client
        self.task_cache = TaskResultCache(32 << 20, self.metrics)
        self.dispatch_gate = DispatchGate(8, self.metrics)
        # request lifelines
        self.default_timeout_ms = float(default_timeout_ms)
        self.degraded_reads = degraded_reads
        # replica-spread cursor shared across requests (each request
        # builds its own NetworkDispatcher; the rotation must survive it)
        import itertools

        self._replica_rr = itertools.count()
        self.last_degraded: dict | None = None   # set per degraded query
        self._last_zstate: tuple[float, dict] | None = None
        self._retry_rng = retry_rng      # injectable backoff jitter source
        # distributed tracing: a sampled query roots its trace here and
        # assembles the full cross-process tree (worker + zero spans ride
        # back over RPC trailing metadata) in tracer.sink
        self.tracer = otrace.Tracer(fraction=span_sample, proc="client",
                                    rng=trace_rng, metrics=self.metrics)
        # cost ledger: the querying CLIENT is the root that
        # assembles ONE cluster-wide cost record per query — each
        # worker's charges ship back in ServeTask trailing metadata and
        # graft under the record's per-group map. The client's CostBook
        # powers the same /debug/top-style ranking client-side.
        self.cost_ledger = bool(cost_ledger)
        self.cost_book = costs.CostBook()

    def _scope(self, timeout_ms: float | None):
        """Deadline scope for one request: explicit timeout_ms beats the
        client default; 0/None = unbudgeted."""
        ms = self.default_timeout_ms if timeout_ms is None \
            else float(timeout_ms)
        return dl.scope(ms / 1000.0 if ms and ms > 0 else None)

    def _invalidate(self) -> None:
        for hr in self.replicas.values():
            hr.mark_stale()       # force leader re-discovery
        self._schema = None
        self.zero.invalidate()
        # conservative: read_ts-keyed entries stay valid under MVCC, but a
        # failover/tablet-move window is exactly when we want no reuse
        self.task_cache.clear()

    # -- leadership ----------------------------------------------------------

    def leader_of(self, g: int) -> RemoteWorker:
        """Current leader of a group — delegated to the HedgedReplicas
        echo state (one discovery mechanism; the mutate retry path calls
        _invalidate to force a re-poll)."""
        try:
            return self.replicas[g].leader_worker()
        except RuntimeError:
            raise Unavailable(f"group {g} has no live leader")

    # -- schema --------------------------------------------------------------

    def schema(self) -> SchemaState:
        """Cluster schema via the Schema RPC from every group
        (worker/schema.go:160 GetSchemaOverNetwork); cached briefly."""
        now = time.monotonic()
        if self._schema is not None and now - self._schema[0] <= self.CACHE_TTL:
            return self._schema[1]
        merged = SchemaState()
        for g in self.groups:
            try:
                text = self.leader_of(g).schema()
            # dgraph: allow(except-seam) schema merge is best-effort per
            # group; an unreachable group contributes nothing
            except Exception:
                continue
            for e in parse_schema(text):
                merged.set(e)
        self._schema = (now, merged)
        return merged

    # -- writes --------------------------------------------------------------

    def mutate(self, set_nquads: str = "", del_nquads: str = "",
               retries: int = 5,
               timeout_ms: float | None = None) -> dict[str, int]:
        """One txn over the wire: Zero NewTxn → per-group Mutate → Zero
        CommitOrAbort → per-group Decide. Leader failures retry after
        re-discovery through the unified RetryPolicy (jittered exponential
        backoff); ONLY transport-shaped failures and NoQuorum retry — a
        programming error surfaces on the first throw, and the retrying
        STOPS the moment the commit decision becomes ambiguous
        (CommitAmbiguous: re-running the txn could apply it twice)."""
        nq_set = rdf.parse(set_nquads) if set_nquads else []
        nq_del = rdf.parse(del_nquads) if del_nquads else []
        tenant = tnc.current()
        if tenant:
            # tenant-scoped writes: predicates become the
            # tenant's storage attrs before any edge leaves this client,
            # so grouping, conflict keys, and journal rows are all scoped
            for nq in nq_set + nq_del:
                if nq.predicate == "*":
                    raise tnc.NamespaceError(
                        "wildcard predicate deletion (S * *) is not "
                        "available inside a tenant namespace")
                nq.predicate = tnc.prefix(tenant, nq.predicate)
        with self._scope(timeout_ms), \
                self.tracer.root("mutate",
                                 attrs={"set": len(nq_set),
                                        "delete": len(nq_del)}):
            policy = RetryPolicy(max_attempts=max(1, int(retries)),
                                 base_s=0.05, cap_s=1.0,
                                 metrics=self.metrics,
                                 rng=self._retry_rng, name="mutate")
            try:
                return policy.run(
                    lambda: self._mutate_once(nq_set, nq_del),
                    retryable=transport_errors(),
                    abort_on=(TxnConflict,),
                    # re-discover leaders + tablet map before re-attempting
                    on_retry=lambda _e: self._invalidate())
            except DeadlineExceeded:
                self.metrics.counter("dgraph_deadline_exceeded_total").inc()
                raise

    def _mutate_once(self, nq_set, nq_del) -> dict[str, int]:
        import grpc as _grpc

        start_ts = self.zero.new_txn()
        uid_map = mut.assign_uids(nq_set + nq_del, self._leases)
        edges = mut.to_edges(nq_set, uid_map, Op.SET) + \
            mut.to_edges(nq_del, uid_map, Op.DEL)
        by_group = mut.split_edges_by_group(
            edges, len(self.groups), self.zero.should_serve)
        keys_by_group: dict[int, list[bytes]] = {}
        conflicts: list[bytes] = []
        preds: set[str] = set()
        try:
            for g, ge in sorted(by_group.items()):
                resp = self.leader_of(g).mutate(start_ts, ge)
                keys_by_group[g] = list(resp.keys)
                conflicts += list(resp.conflict_keys)
                preds |= set(resp.preds)
            try:
                commit_ts = self.zero.commit(start_ts, conflicts, preds)
            except DeadlineExceeded as e:
                # ZeroClient translates a wire DEADLINE_EXCEEDED into the
                # typed error with the RpcError as __cause__; a PRE-SEND
                # budget check raises it bare. Only the in-flight shape is
                # ambiguous — the oracle may or may not have decided, so
                # neither aborting nor retrying is safe.
                if isinstance(e.__cause__, _grpc.RpcError):
                    raise CommitAmbiguous(
                        f"txn {start_ts}: commit outcome unknown "
                        f"(in-flight timeout)") from e
                raise       # nothing was sent: the abort path below is safe
            except _grpc.RpcError as e:
                if e.code() == _grpc.StatusCode.DEADLINE_EXCEEDED:
                    raise CommitAmbiguous(
                        f"txn {start_ts}: commit outcome unknown "
                        f"(in-flight timeout)") from e
                raise
        except TxnConflict:
            self._decide_all(start_ts, 0, keys_by_group)
            raise
        except CommitAmbiguous:
            raise                # no abort: the commit may have landed
        except BaseException:
            self._decide_all(start_ts, 0, keys_by_group)
            try:
                self.zero.abort(start_ts)
            # dgraph: allow(except-seam) best-effort abort on the unwind
            # path; the raise below carries the real failure
            except Exception:
                pass
            raise
        self._decide_all(start_ts, commit_ts, keys_by_group)
        self._invalidate()    # new tablets / inferred schema become visible
        return uid_map

    def _decide_all(self, start_ts: int, commit_ts: int,
                    keys_by_group: dict) -> None:
        for g, keys in sorted(keys_by_group.items()):
            try:
                self.leader_of(g).decide(start_ts, commit_ts, keys)
            except Exception as e:
                if commit_ts:
                    # the txn COMMITTED at the oracle but this group never
                    # heard the decision: surface it typed and
                    # non-retryable (a retried mutate would re-apply the
                    # txn under fresh uids). Reads self-heal via the
                    # hedger's lost-Decide fallback.
                    raise CommitAmbiguous(
                        f"txn {start_ts} committed at ts {commit_ts} but "
                        f"the Decide fan-out to group {g} failed") from e
                # lost aborts are safe: layers stay buffered until reaped

    # -- reads ---------------------------------------------------------------

    def query(self, q: str, variables: dict | None = None,
              timeout_ms: float | None = None) -> dict:
        """DQL with every uid/value task dispatched over ServeTask — the
        client holds NO local tablet (all-remote NetworkDispatcher). A
        transport failure (e.g. cached leader died) invalidates the
        leader/tablet caches and retries once against fresh discovery.

        With a deadline armed (timeout_ms / default_timeout_ms) the whole
        request — fan-out, hedges, watermark waits, gate acquisition — is
        bounded by one budget; overrunning it raises the typed
        DeadlineExceeded (a worker-side DEADLINE_EXCEEDED status is
        translated to the same type), never a hang."""
        import grpc as _grpc

        # ONE transport-failure policy, shared with the mutate retry path
        # (utils/retry.transport_errors: RpcError, ConnectionError,
        # OSError, TimeoutError, NoQuorum, RuntimeError-as-routing-error)
        transport = transport_errors()
        qtitle = q.strip().splitlines()[0][:120] if q.strip() else ""
        self.last_degraded = None
        lg = costs.CostLedger(endpoint="query", shape=q,
                              tenant=tnc.current()) \
            if self.cost_ledger else None
        with self._scope(timeout_ms), \
                self.tracer.root("query", kind="client",
                                 attrs={"query": qtitle}) as sp, \
                costs.scope(lg):
            try:
                for attempt in (0, 1):
                    try:
                        out = self._query_once(q, variables)
                        if lg is not None and (
                                lg.tasks or lg.device_ms > 0
                                or lg.groups):
                            # trivial (all-cache) replays skip record
                            # assembly — same fast path as Node.query
                            lg.finish()
                            self.cost_book.record(
                                q, "query",
                                sp.trace_id if sp else "",
                                lg.to_dict())
                        return out
                    except DeadlineExceeded:
                        raise
                    except transport as e:
                        # parse/semantic errors propagate directly — only
                        # transport failures warrant cache invalidation +
                        # a second fan-out; a wire DEADLINE_EXCEEDED is
                        # the budget talking, not the transport: typed,
                        # and never worth a second full fan-out
                        if isinstance(e, _grpc.RpcError) and e.code() == \
                                _grpc.StatusCode.DEADLINE_EXCEEDED:
                            raise DeadlineExceeded(str(e)) from e
                        if attempt:
                            raise
                        self._invalidate()
            except DeadlineExceeded:
                self.metrics.counter("dgraph_deadline_exceeded_total").inc()
                raise

    def _zero_view(self) -> tuple[dict, dict | None]:
        """Zero's state for one read — live when possible, else (degraded
        mode) the last state this client saw. Degraded reads are read-only
        snapshot serving: results may be stale by `staleness_s` but every
        floor/ts they use was once true, so they are never WRONG — and the
        staleness is annotated (returned per-request, mirrored on
        `last_degraded` for observability) rather than erroring outright
        while the coordinator recovers quorum. Returns (zstate,
        degraded-info-or-None)."""
        import grpc as _grpc

        try:
            zstate = self.zero.state()
            self._last_zstate = (time.monotonic(), zstate)
            return zstate, None
        except (_grpc.RpcError, ConnectionError, OSError) as e:
            if isinstance(e, _grpc.RpcError) and e.code() == \
                    _grpc.StatusCode.DEADLINE_EXCEEDED:
                raise DeadlineExceeded(str(e)) from e
            if not self.degraded_reads or self._last_zstate is None:
                raise
            at, zstate = self._last_zstate
            staleness = time.monotonic() - at
            info = {"degraded": True,
                    "staleness_s": round(staleness, 3),
                    "reason": type(e).__name__}
            self.metrics.counter("dgraph_degraded_reads_total").inc()
            otrace.event("degraded_read",
                         staleness_s=round(staleness, 3))
            return zstate, info

    def _query_once(self, q: str, variables: dict | None) -> dict:
        parsed = dql.parse(q, variables)
        if parsed.schema_request is not None:
            # schema{} over the cluster: the merged GetSchemaOverNetwork
            # view, same JSON shape as the embedded server
            from ..utils.schema import schema_json

            return {"schema": schema_json(self._read_schema(),
                                          parsed.schema_request)}
        return self.read_executor().execute(parsed)

    def _read_schema(self):
        schema = self.schema()
        tenant = tnc.current()
        if tenant:
            # tenant view: the executor plans and validates on
            # the tenant's unprefixed vocabulary; every task crossing the
            # wire below carries the storage attr
            schema = tnc.NamespacedSchema(schema, tenant)
        return schema

    def read_executor(self) -> Executor:
        """The Executor one read runs on (query() executes on it): an
        empty host snapshot at Zero's read ts, every uid/value task
        dispatched over ServeTask to the group that owns its predicate."""
        schema = self._read_schema()
        tenant = tnc.current()
        zstate, degraded = self._zero_view()
        read_ts = int(zstate.get("maxTxnTs", 0))
        floors = {k: int(v)
                  for k, v in zstate.get("predCommit", {}).items()}
        # read-replica holders (coord/placement.py): reads spread across
        # owner + holders; NOT in degraded mode — a frozen map cannot
        # prove which holders are still fresh, so only primaries serve
        replica_map = {a: [int(g) for g in gs]
                       for a, gs in zstate.get("replicaMap", {}).items()}
        zero = self.zero
        if degraded is not None:
            # Zero is unreachable: route from the last known tablet map
            # instead of asking a dead coordinator per task. The local
            # `degraded` drives routing (last_degraded is a shared
            # observability mirror that concurrent requests may reset)
            self.last_degraded = degraded
            zero = _FrozenZero(zstate.get("tabletMap", {}))
            replica_map = {}
        dispatcher = NetworkDispatcher(
            zero, local_group=-1,
            local_snap_fn=lambda ts: GraphSnapshot(ts, device="cpu"),
            remotes=dict(self.replicas),
            schema=schema, pred_floors=floors,
            cache=self.task_cache, gate=self.dispatch_gate,
            tablet_replicas=replica_map, metrics=self.metrics,
            rr_counter=self._replica_rr)
        snap = GraphSnapshot(read_ts, device="cpu")

        def dispatch(tq):
            if tenant:
                # translate at the wire seam: routing (zero tablet map),
                # the client task cache, and the worker all key on the
                # tenant's storage attr
                from dataclasses import replace as _replace

                tq = _replace(tq, attr=tnc.prefix(tenant, tq.attr))
            return dispatcher.process_task(tq, read_ts)

        return Executor(snap, schema, dispatch=dispatch)

    def close(self) -> None:
        for hr in self.replicas.values():
            hr.close()
        self.zero.close()
