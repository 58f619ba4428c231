"""Cross-process task execution: the Worker gRPC service + client.

Port of dgraph_tpu/parallel/remote.py. The wire is the JAX package's
(protos/internal_pb2, package dgraph_tpu.internal), so a port worker
answers a JAX client and the reverse. A WorkerService takes `device`
("cuda" unless given): its SnapshotAssembler folds onto it, so its
process_task expands above task.HOST_EXPAND_MAX and its DeviceBatcher's
packed launches run there. Fault points and metric names are the JAX
package's.

Reference semantics: worker/task.go:137 ProcessTaskOverNetwork — a
per-predicate task routes to the group serving that tablet; remote groups
answer over the internal wire protocol (protos/internal.proto ServeTask),
local ones short-circuit to the in-process call. worker/groups.go:292
BelongsTo is the routing decision; here the caller's tablet map makes it.

Serialization: uid arrays as raw int64-LE bytes (numpy buffer in/out, no
per-element parse); typed values/facets as the store's JSON value encoding.
"""

from __future__ import annotations

import contextvars
import json
import threading
import time
from concurrent import futures

import numpy as np

try:
    import grpc
except ImportError:              # pragma: no cover
    grpc = None

from .. import tenancy as tnc
from ..obs import costs, otrace
from ..protos import internal_pb2 as ipb
from ..utils import deadline as dl
from ..utils import faults
from ..utils.ballot import tally as _tally
from ..utils.retry import CircuitBreaker
from ..utils.errors import FailedPrecondition, Unavailable
from ..query.task import TaskQuery, TaskResult, UidMatrix, process_task
from ..storage.csr_build import STRUCTURAL_RECORDS
from ..storage.store import _key_bytes, decode_record
from ..storage.postings import DirectedEdge, Op, Posting
from ..storage.store import _val_from_json, _val_to_json
from ..utils.types import TypeID

SERVICE = "dgraph_tpu.internal.Worker"

# tablet payloads (snapshot streams) far exceed gRPC's 4 MB default. The
# reference uses 4 GB (x/x.go:56 GrpcMaxSize); predicate moves chunk at
# MOVE_CHUNK_BYTES so no single message approaches this cap.
# max_metadata_size: traced RPCs ship their span subtree back in trailing
# metadata (obs/otrace.py) — the 8 KB default would reject deep traces.
GRPC_OPTIONS = [("grpc.max_send_message_length", 1 << 30),
                ("grpc.max_receive_message_length", 1 << 30),
                ("grpc.max_metadata_size", 4 << 20)]

# per-chunk budget for predicate moves (reference: <=32MB Raft-proposal
# batches, worker/predicate_move.go:187)
MOVE_CHUNK_BYTES = 32 << 20


def _uids_to_bytes(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a, dtype="<i8")).tobytes()


def _uids_from_bytes(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype="<i8").astype(np.int64)


def _vals_json(rows) -> str:
    # an int value's encoding is memoized: a value task over a large
    # frontier repeats few distinct ints (floats are not: 0.0 == -0.0)
    memo: dict = {}

    def enc(v):
        if v is None or v.tid != TypeID.INT:
            return _val_to_json(v)
        j = memo.get(v.value)
        if j is None:
            j = memo[v.value] = _val_to_json(v)
        return j

    return json.dumps([[enc(v) for v in row] for row in rows])


def _vals_from_json(s: str):
    # one decode per distinct encoding (a value is a pure function of its
    # bytes, and Val is immutable)
    memo: dict = {}

    def dec(j):
        if j is None:
            return None
        key = (j["t"], j["b"])
        v = memo.get(key)
        if v is None:
            v = memo[key] = _val_from_json(j)
        return v

    return [[dec(j) for j in row] for row in json.loads(s)]


def _facets_json(rows) -> str:
    return json.dumps([[[[k, _val_to_json(v)] for k, v in fac]
                        for fac in row] for row in rows])


def _facets_from_json(s: str):
    return [[tuple((k, _val_from_json(j)) for k, j in fac)
             for fac in row] for row in json.loads(s)]


def encode_result(res: TaskResult) -> ipb.TaskResponse:
    m = res.uid_matrix          # columnar: the wire's own layout
    return ipb.TaskResponse(
        matrix_flat=m.flat.astype("<i8", copy=False).tobytes(),
        matrix_offsets=m.offsets.astype("<i8", copy=False).tobytes(),
        dest_uids=_uids_to_bytes(res.dest_uids),
        counts=list(res.counts),
        value_matrix_json=_vals_json(res.value_matrix)
        if res.value_matrix else "",
        facet_matrix_json=_facets_json(res.facet_matrix)
        if res.facet_matrix else "",
        traversed_edges=res.traversed_edges)


def decode_result(msg: ipb.TaskResponse) -> TaskResult:
    res = TaskResult()
    offs = np.frombuffer(msg.matrix_offsets, dtype="<i8")
    if len(offs):
        res.uid_matrix = UidMatrix(_uids_from_bytes(msg.matrix_flat),
                                   offs.astype(np.int64))
    res.dest_uids = _uids_from_bytes(msg.dest_uids)
    res.counts = list(msg.counts)
    if msg.value_matrix_json:
        res.value_matrix = _vals_from_json(msg.value_matrix_json)
    if msg.facet_matrix_json:
        res.facet_matrix = _facets_from_json(msg.facet_matrix_json)
    res.traversed_edges = msg.traversed_edges
    return res


def encode_task(q: TaskQuery, read_ts: int,
                min_applied: int = 0,
                replica_read: bool = False) -> ipb.TaskRequest:
    return ipb.TaskRequest(
        attr=q.attr, has_frontier=q.frontier is not None,
        frontier=_uids_to_bytes(q.frontier) if q.frontier is not None else b"",
        func_name=q.func[0] if q.func else "",
        func_args_json=json.dumps(q.func[1]) if q.func else "",
        lang=q.lang, facet_keys=list(q.facet_keys), first=q.first,
        reverse=q.reverse, read_ts=read_ts, min_applied=min_applied,
        replica_read=replica_read)


def decode_task(msg: ipb.TaskRequest) -> tuple[TaskQuery, int]:
    func = (msg.func_name, json.loads(msg.func_args_json)) \
        if msg.func_name else None
    return TaskQuery(
        attr=("~" if msg.reverse else "") + msg.attr,
        frontier=_uids_from_bytes(msg.frontier) if msg.has_frontier else None,
        func=func, lang=msg.lang, facet_keys=list(msg.facet_keys),
        first=msg.first), msg.read_ts


def encode_edge(e: DirectedEdge) -> ipb.Edge:
    return ipb.Edge(
        subject=e.subject, attr=e.attr, object_uid=e.object_uid,
        value_json=json.dumps(_val_to_json(e.value))
        if e.value is not None else "",
        op=int(e.op), lang=e.lang,
        facets_json=json.dumps([[k, _val_to_json(v)] for k, v in e.facets])
        if e.facets else "")


def decode_edge(m: ipb.Edge) -> DirectedEdge:
    return DirectedEdge(
        subject=m.subject, attr=m.attr, object_uid=m.object_uid,
        value=_val_from_json(json.loads(m.value_json))
        if m.value_json else None,
        op=Op(m.op), lang=m.lang,
        facets=tuple((k, _val_from_json(j))
                     for k, j in json.loads(m.facets_json))
        if m.facets_json else ())


class StaleLeader(Exception):
    """A deposed leader tried to ship records (term fencing)."""


class NoQuorum(Exception):
    """Not enough live replicas acked an append."""


class WorkerService:
    """One group's task server: answers ServeTask against its own store's
    snapshot at the requested read_ts.

    Replication role (worker/draft.go + conn/node.go, process form): a
    worker starts as a bare store; `Promote(term, peers)` makes it the
    group leader — every WAL record its store writes is shipped to the
    peers' Append RPC and acked by a quorum before the local append
    proceeds (proposeAndWait). Shipping uses a PER-TERM session sequence
    (not file record counts, which local checkpoint compaction rewrites):
    followers accept records in session order, a lagging peer is re-fed
    from a bounded in-memory buffer (Raft's per-peer nextIndex), and a
    leader that cannot reach a quorum steps down — it must not keep
    minting indexes its group never accepted. Election is
    control-plane-driven (Zero/systest promotes the live replica with the
    highest (max_commit_ts, log_len) — Raft's up-to-date rule)."""

    SHIP_BUFFER = 4096       # catch-up window (records) for lagging peers

    def __init__(self, store, batching: bool = True,
                 batch_window_ms: float = 2.0, batch_max: int = 16,
                 cost_ledger: bool = True,
                 lazy_folds: bool = True,
                 device: str = "cuda") -> None:
        import collections
        import os
        import threading

        from .. import resolve_device
        from ..storage.csr_build import SnapshotAssembler

        from ..query.qcache import TaskResultCache
        from ..utils import metrics as metrics_mod

        self.store = store
        # the worker's device path: its snapshot's device columns, its
        # expands above task.HOST_EXPAND_MAX and its DeviceBatcher's packed
        # launches all run here. "cuda" raises without a card; no fallback
        # moves a worker's expands to the host.
        self.device = resolve_device(device)
        self.metrics = metrics_mod.Registry()
        # per-RPC cost ledger shipping: off = serve_task
        # measures nothing and ships nothing (worker --no_cost_ledger)
        self.cost_ledger = bool(cost_ledger)
        # joins traces propagated over ServeTask metadata; collected spans
        # ship BACK to the caller in trailing metadata (obs/otrace.py), so
        # the query node assembles one tree — proc is refined to the bound
        # address by serve_worker.
        self.tracer = otrace.Tracer(proc="worker")
        self.lazy_folds = bool(lazy_folds)
        self._assembler = SnapshotAssembler(store, metrics=self.metrics,
                                            lazy_folds=self.lazy_folds,
                                            device=self.device)
        self._lock = threading.Lock()
        # server-side task-result cache: repeated/fanned-out ServeTask
        # calls for the same (snapshot, task) answer from memory, and
        # concurrent identical tasks coalesce onto one execution. Keyed
        # per predicate — the assembler replaces (never mutates) a
        # PredData on any visible commit/overlay-stamp/replay/drop.
        self.task_cache = TaskResultCache(32 << 20, self.metrics)
        # device-dispatch batcher: the wire path is where the
        # fixed per-dispatch relay sync dominates (PERF.md configs 4-5),
        # so concurrent fanned-in ServeTask calls that classify as the
        # same device-class kernel pack into ONE launch exactly like the
        # embedded node's. No DispatchGate on the worker: the batcher runs
        # the kernel directly and idle-fires off its own in-flight count.
        # Same knob surface as the embedded Node (worker CLI
        # --no_batch/--batch_window_ms/--batch_max).
        self.batcher = None
        if batching and batch_max > 1:
            from ..query.batch import DeviceBatcher

            self.batcher = DeviceBatcher(gate=None, metrics=self.metrics,
                                         window_ms=batch_window_ms,
                                         max_batch=batch_max)
        # replica-read gate concurrency cap (see serve_task convoy guard)
        self._gate_slots = threading.BoundedSemaphore(2)
        # per-tablet load counters since process start — reads/writes/
        # result-bytes/serve-seconds per attr, reported on Status as
        # tablet_load_json: the placement controller's scoring input
        # (coord/placement.py diffs successive polls). The book also
        # mirrors the dgraph_tablet_load gauge into this worker's
        # registry; group is unknown until Connect, so it stays 0 here.
        from ..coord.placement import TabletLoadBook

        self.tablet_book = TabletLoadBook(self.metrics)
        # move fences (coord/placement.py systest gate: no wrong results
        # during moves). A worker that DELETED a tablet after moving it
        # away must refuse its reads typed — a client with a stale (TTL'd)
        # tablet map would otherwise get silently-empty answers; and a
        # worker that INGESTED a tablet refuses reads below the install
        # commit ts — the streamed copy has no history under it. Both
        # refusals are FAILED_PRECONDITION: the client invalidates its
        # caches and retries against fresh routing + a fresh read_ts.
        self._moved_away: set[str] = set()
        self._ingest_floor: dict[str, int] = {}
        self._move_keys_cache = None
        # replication role. _rlock guards follower-side state ONLY; the
        # leader-side _ship path deliberately takes no service lock (it runs
        # under the store lock — taking _rlock there would ABBA-deadlock
        # against append(), which takes _rlock then the store lock).
        self._rlock = threading.RLock()
        self.is_leader = False
        self.peers: list["RemoteWorker"] = []
        self._peer_seq: dict[int, int] = {}      # peer idx -> acked seq
        self._peer_fails: dict[int, int] = {}    # consecutive ship failures
        self._session_seq = 0                    # this term's shipped count
        self._last_seq = 0                       # follower: applied seq
        self._buffer = collections.deque(maxlen=self.SHIP_BUFFER)
        self._pool = None                        # ship executor
        self._ship_lock = threading.Lock()       # _ship <-> promote only
        self._syncing = False                    # FetchState catch-up active
        self._term_path = (os.path.join(store.dir, "term")
                           if store.dir else None)
        self.term = 0
        if self._term_path and os.path.exists(self._term_path):
            with open(self._term_path) as f:
                self.term = int(f.read().strip() or 0)
        # wire election state (conn/node.go ballot, redesigned): membership
        # learned from heartbeats, one vote per term, randomized timeout
        self.group_members: list[str] = []
        self._leader_contact = 0.0
        self._election_stop = threading.Event()
        self._election_thread = None   # utils.ballot.BallotLoop | None

    def _set_term(self, term: int) -> None:
        self.term = term
        if self._term_path:
            with open(self._term_path, "w") as f:
                f.write(str(term))

    def _step_down(self) -> None:
        self.is_leader = False
        self.store.wal_sink = None

    def _snapshot(self, read_ts: int):
        # incremental: a commit touching one predicate re-folds exactly that
        # predicate (SnapshotAssembler reuses PredData identity for clean
        # ones); the lock keeps the 8-thread gRPC pool from racing assembly
        with self._lock:
            return self._assembler.snapshot(read_ts)

    # replica-read gate: how long a follower waits for its applied
    # per-tablet watermark to reach the task's min_applied before telling
    # the caller to go elsewhere (WaitForMinProposal analog)
    APPLIED_WAIT = 2.0

    def serve_task(self, msg: ipb.TaskRequest, context) -> ipb.TaskResponse:
        """ServeTask with trace continuation: a caller-propagated span
        context (invocation metadata) makes this group's work — gate
        waits, cache hits, device kernels — part of the caller's trace;
        the collected spans return in trailing metadata. An aborted RPC
        (gate timeout) cannot carry trailing metadata: the spans drop but
        the buffer drains either way (no leak on mid-fan-out failures).

        Deadline continuation rides the same metadata channel: the
        caller's remaining budget (utils/deadline WIRE_KEY) installs a
        server-side deadline scope so every wait this handler performs —
        the applied-watermark gate above all — is bounded by it.

        Cost continuation rides it too: this group's resource
        charges for the task — device-kernel ms, transfer bytes, edges,
        cache/batch outcomes — accumulate on a per-RPC CostLedger and
        ship back in trailing metadata (obs/costs.WIRE_KEY) next to the
        spans, so the querying node assembles ONE cluster-wide cost
        record with per-group sub-records."""
        wire = None
        budget = None
        tenant = ""
        if context is not None:
            md = context.invocation_metadata() or ()
            for k, v in md:
                if k == otrace.WIRE_KEY:
                    wire = v
                elif k == tnc.WIRE_KEY:
                    # tenant continuation: attrs on the wire
                    # are already storage-prefixed by the querying node;
                    # the tenant rides along for cost attribution and the
                    # batcher's tenant-scoped compatibility keys
                    tenant = v
            budget = dl.from_metadata(md)
        lg = costs.CostLedger(endpoint="serve_task", tenant=tenant) \
            if self.cost_ledger else None
        if not wire:
            try:
                with tnc.scope(tenant), dl.scope(budget), costs.scope(lg):
                    return self._serve_task_inner(msg, context)
            finally:
                self._ship_trailing(context, None, lg)
        sp = self.tracer.join(wire, "serve_task",
                              attrs={"attr": msg.attr,
                                     "addr": self.advertise_addr})
        try:
            with sp, tnc.scope(tenant), dl.scope(budget), costs.scope(lg):
                return self._serve_task_inner(msg, context)
        finally:
            self._ship_trailing(context, sp, lg)

    def _ship_trailing(self, context, sp, lg) -> None:
        """Attach the collected spans + the cost record as trailing
        metadata. An aborted RPC cannot carry trailing metadata: the
        payloads drop but the span buffer drains either way (no leak)."""
        md = []
        if sp is not None:
            spans = self.tracer.take(sp.trace_id)
            if spans:
                md.append((otrace.SPANS_KEY, otrace.encode_spans(spans)))
        if lg is not None:
            lg.finish()
            md.append((costs.WIRE_KEY, lg.to_wire()))
        if context is None or not md:
            return
        try:
            context.set_trailing_metadata(tuple(md))
        except Exception:
            # context already terminated (abort path)
            self.metrics.counter("dgraph_cost_ship_failures_total").inc()

    def tablet_load_snapshot(self) -> dict:
        return self.tablet_book.snapshot()

    def _serve_task_inner(self, msg: ipb.TaskRequest,
                          context) -> ipb.TaskResponse:
        faults.fire("worker.serve_task", m=self.metrics)
        q, read_ts = decode_task(msg)
        attr = q.attr[1:] if q.attr.startswith("~") else q.attr
        if msg.replica_read:
            # tablet-replica serving (coord/placement.py): this store holds
            # a read-only COPY whose per-tablet watermark is the owner
            # commit ts the last install/delta ship covered. Both bounds
            # refuse with FAILED_PRECONDITION so the router falls back to
            # the primary instead of serving a wrong cut:
            #   behind — a commit the read's floor requires has not been
            #            shipped (no wait: ships are controller-paced, the
            #            primary can answer now);
            #   ahead  — a delta rewrite landed ABOVE this read's snapshot
            #            ts; rewrites replace whole keys, so per-key
            #            history below the rewrite is not point-in-time
            #            faithful for this older read.
            wm = self.store.pred_commit_ts.get(attr, 0)
            if msg.min_applied and wm < msg.min_applied:
                context.abort(
                    grpc.StatusCode.FAILED_PRECONDITION,
                    f"tablet replica behind on {attr!r}: covered {wm} "
                    f"< {msg.min_applied}")
            if wm > read_ts:
                context.abort(
                    grpc.StatusCode.FAILED_PRECONDITION,
                    f"tablet replica ahead on {attr!r}: covered {wm} "
                    f"> read_ts {read_ts}")
        else:
            if attr in self._moved_away \
                    and attr not in self.store.predicates():
                context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                              f"tablet {attr!r} moved away from this group")
            floor = self._ingest_floor.get(attr, 0)
            if floor and read_ts < floor:
                context.abort(
                    grpc.StatusCode.FAILED_PRECONDITION,
                    f"tablet {attr!r} was installed here at ts {floor}; "
                    f"read_ts {read_ts} predates its history")
        if not msg.replica_read and msg.min_applied:
            if self.store.pred_commit_ts.get(attr, 0) < msg.min_applied:
                # bounded waiters: gated reads must not occupy the whole
                # server pool and starve the Append/Decide RPCs that would
                # advance the watermark (convoy guard)
                if not self._gate_slots.acquire(blocking=False):
                    context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                  f"replica busy catching up on {attr!r}")
                try:
                    # the wait is the per-predicate applied WaterMark
                    # (utils/watermark.py): woken the instant the commit
                    # applies instead of a 10ms poll loop, and bounded by
                    # min(APPLIED_WAIT, the caller's remaining budget) so
                    # a propagated deadline is honored server-side
                    wait = dl.clamp(self.APPLIED_WAIT)
                    caught_up = wait > 0 and \
                        self.store.applied_mark(attr).wait_for_mark(
                            int(msg.min_applied), timeout=wait)
                    if not caught_up:
                        rem = dl.remaining()
                        if rem is not None and rem <= 0:
                            self.metrics.counter(
                                "dgraph_deadline_exceeded_total").inc()
                            context.abort(
                                grpc.StatusCode.DEADLINE_EXCEEDED,
                                f"deadline exceeded waiting for {attr!r} "
                                f"to apply {msg.min_applied}")
                        context.abort(
                            grpc.StatusCode.FAILED_PRECONDITION,
                            f"replica behind on {attr!r}: applied "
                            f"{self.store.pred_commit_ts.get(attr, 0)}"
                            f" < {msg.min_applied}")
                finally:
                    self._gate_slots.release()
        from ..query.qcache import task_token

        t0 = time.monotonic()
        snap = self._snapshot(read_ts)
        solo = lambda tq, klass=None: process_task(     # noqa: E731
            snap, tq, self.store.schema)
        run = solo if self.batcher is None else (
            lambda tq: self.batcher.dispatch(
                snap, self.store.schema, tq, solo))
        lg = costs.current()
        if lg is None:
            res = self.task_cache.dispatch(task_token(snap, q), q, run)
        else:
            # the per-RPC ledger (serve_task): kernel charges below
            # attribute to this task's predicate; the task's traversed
            # edges land on its per-predicate row
            with lg.task(attr):
                res = self.task_cache.dispatch(task_token(snap, q), q,
                                               run)
            lg.add_task(attr, int(res.traversed_edges))
        if msg.replica_read and attr not in self.store.predicates():
            # the controller dropped this replica mid-request: the answer
            # may have been computed over an already-deleted tablet — a
            # snapshot assembled BEFORE the delete is still a valid cut
            # (refusing it merely costs a fallback), one assembled after
            # would serve empty. Refuse either way; the primary serves.
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"tablet replica of {attr!r} was dropped")
        out = encode_result(res)
        self.tablet_book.record_read(attr,
                                     out_bytes=float(out.ByteSize()),
                                     serve_s=time.monotonic() - t0)
        return out

    def membership(self, _msg: ipb.MembershipRequest,
                   context) -> ipb.MembershipResponse:
        return ipb.MembershipResponse(
            tablets=self.store.predicates(),
            max_commit_ts=self.store.max_seen_commit_ts,
            pred_commit_json=json.dumps(dict(self.store.pred_commit_ts)))

    def mutate(self, msg: ipb.MutateRequest, context) -> ipb.MutateResponse:
        """Apply one txn's slice of edges on this group (MutateOverNetwork's
        receiving side, worker/mutation.go:424) — buffered under start_ts,
        decided later by Decide."""
        from ..query import mutation as mut

        faults.fire("worker.mutate", m=self.metrics)
        if self.term > 0 and not self.is_leader:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"not leader (term {self.term})")
        edges = [decode_edge(e) for e in msg.edges]
        touched, conflict, preds = mut.apply_mutations(
            self.store, edges, msg.start_ts)
        for e in edges:
            self.tablet_book.record_write(e.attr)
        return ipb.MutateResponse(keys=touched, conflict_keys=conflict,
                                  preds=sorted(preds))

    def decide(self, msg: ipb.DecisionRequest,
               context) -> ipb.DecisionResponse:
        """Commit (commit_ts > 0) or abort this group's buffered layers
        (CommitOverNetwork fan-out)."""
        if self.term > 0 and not self.is_leader:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"not leader (term {self.term})")
        keys = list(msg.keys)
        if msg.commit_ts:
            self.store.commit(msg.start_ts, msg.commit_ts, keys)
            # no explicit invalidation: the commit bumped pred_commit_ts,
            # which the assembler's per-predicate reuse keys on
        else:
            self.store.abort(msg.start_ts, keys)
        return ipb.DecisionResponse()

    # -- replication (leader ship / follower append) --------------------------

    def promote(self, msg: ipb.PromoteRequest, context) -> ipb.PromoteResponse:
        """Become this group's leader at `term`, shipping to `peers`.

        The term must STRICTLY increase: followers key their session
        sequence on the term, so a same-term re-promote would restart the
        leader's sequence at 1 while followers are at N — every shipped
        record up to N would be acked as a "duplicate" without being
        applied, and a later failover would lose acked writes."""
        with self._rlock:
            if msg.term <= self.term:
                return ipb.PromoteResponse(ok=False, term=self.term)
            self._become_leader(int(msg.term), list(msg.peers))
            return ipb.PromoteResponse(ok=True, term=self.term)

    def _become_leader(self, term: int, peer_addrs: list[str]) -> None:
        """Install leadership at `term` (caller holds _rlock and has
        verified the term transition: strictly-greater for the Promote RPC;
        equal-after-self-vote for a won wire election)."""
        from concurrent import futures as _futures

        # serialize against an in-flight _ship before touching the pool,
        # peers, or sequence state it is using
        with self._ship_lock:
            self._set_term(int(term))
            for p in self.peers:
                p.close()
            self.peers = [RemoteWorker(a) for a in peer_addrs]
            self._peer_seq = {i: 0 for i in range(len(self.peers))}
            self._session_seq = 0
            # an in-memory leader has no durable files for FetchState —
            # its ship buffer IS the full history, so it must not evict
            import collections as _c

            self._buffer = _c.deque(
                maxlen=None if self.store.dir is None
                else self.SHIP_BUFFER)
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool = _futures.ThreadPoolExecutor(
                max_workers=max(len(peer_addrs), 1))
            self.is_leader = True
            self.store.wal_sink = self._ship
        if self.advertise_addr:
            self.group_members = sorted(
                set(peer_addrs) | {self.advertise_addr})

    advertise_addr = ""     # set by serve_worker; followers call back here

    def _ship_to_peer(self, i: int, p: "RemoteWorker",
                      records: list[tuple[int, bytes]]) -> bool:
        """Bring one peer up to the latest seq: re-feed anything it is
        missing from the buffer, then the new record. Returns True when the
        peer acked through the final seq; StaleLeader propagates."""
        for seq, data in records:
            if seq <= self._peer_seq.get(i, 0):
                continue
            try:
                r = p.append(self.term, seq, data, self.advertise_addr)
            except Exception:
                self._peer_fails[i] = self._peer_fails.get(i, 0) + 1
                return False            # dead peer
            if not r.ok:
                if r.term > self.term:
                    raise StaleLeader(
                        f"peer at term {r.term} > {self.term}")
                # genuine gap beyond the buffer window: the peer kicks off
                # its own FetchState catch-up (it got our callback addr);
                # after it syncs, its appends ack as duplicates and the
                # fast-forward below adopts its position
                self._peer_fails[i] = self._peer_fails.get(i, 0) + 1
                return False
            # duplicate acks (peer already held seq) fast-forward too
            self._peer_seq[i] = max(seq, int(r.log_len))
        ok = self._peer_seq.get(i, 0) >= records[-1][0]
        self._peer_fails[i] = 0 if ok else self._peer_fails.get(i, 0) + 1
        return ok

    def _ship(self, data: bytes, sync: bool) -> None:
        """Deliver one WAL record to all peers concurrently; quorum counts
        the leader itself. Runs under the store lock (records reach
        followers in exactly the leader's order) but takes NO service lock
        (_rlock) — see __init__. The dedicated _ship_lock (a leaf shared
        only with promote()) keeps a concurrent Promote from swapping the
        pool/peers/sequence state mid-ship. A leader that cannot assemble a
        quorum steps down before raising: continuing to mint sequence
        numbers its group never accepted would fork the log."""
        with self._ship_lock:
            self._session_seq += 1
            seq = self._session_seq
            self._buffer.append((seq, data))
            # slice only the tail the slowest DUE peer still needs: an
            # unbounded in-memory-leader buffer must not make every write
            # O(history). A peer that keeps failing backs off to every
            # 64th ship, so a dead replica cannot force the full-history
            # copy per write either (it still resyncs on its due ticks,
            # and FetchState covers disk-backed leaders).
            peers = list(self.peers)
            due = [i for i in range(len(peers))
                   if self._peer_fails.get(i, 0) < 3 or seq % 64 == 0]
            min_acked = min((self._peer_seq.get(i, 0) for i in due),
                            default=seq - 1)
            lag = seq - min_acked
            if lag >= len(self._buffer):
                records = list(self._buffer)
            else:
                import itertools as _it

                # O(lag): deque iteration from the right end
                records = list(_it.islice(reversed(self._buffer),
                                          lag))[::-1]
            # dgraph: allow(ctxvar-copy) quorum append fan-out is
            # deliberately detached: a ship must run to completion even
            # if the triggering request's budget lapses mid-flight —
            # aborting half an ack round would corrupt quorum accounting
            futs = [self._pool.submit(self._ship_to_peer, i, peers[i],
                                      records) for i in due]
            acks, stale = 1, None
            for f in futs:
                try:
                    if f.result():
                        acks += 1
                except StaleLeader as e:
                    stale = e
            if stale is not None:
                self._step_down()
                raise stale
            quorum = (len(peers) + 1) // 2 + 1
            if acks < quorum:
                self._step_down()
                raise NoQuorum(
                    f"{acks}/{len(peers) + 1} acks < quorum {quorum}")

    def append(self, msg: ipb.AppendRequest, context) -> ipb.AppendResponse:
        """Follower side: fence term, enforce session order, make the
        record durable and live (store.append_replica_record)."""
        with self._rlock:
            if msg.term < self.term:
                return ipb.AppendResponse(ok=False, term=self.term,
                                          log_len=self._last_seq)
            if msg.term > self.term:
                self._set_term(int(msg.term))
                self._step_down()
                self._last_seq = 0      # new leader, new session sequence
            if msg.index != self._last_seq + 1:
                if msg.index <= self._last_seq:
                    # duplicate re-feed (leader catch-up overlap): ack it
                    return ipb.AppendResponse(ok=True, term=self.term,
                                              log_len=self._last_seq)
                # fell beyond the leader's buffer window: pull the leader's
                # full durable state in the background (retrieveSnapshot,
                # worker/draft.go:452) and resume appends from its seq
                if msg.leader_addr and not self._syncing:
                    self._syncing = True
                    import threading as _t

                    # dgraph: allow(ctxvar-copy) detached catch-up sync
                    _t.Thread(target=self._state_sync,
                              args=(msg.leader_addr,),
                              daemon=True).start()
                return ipb.AppendResponse(ok=False, term=self.term,
                                          log_len=self._last_seq)
            data = bytes(msg.data)
            rec = decode_record(data)    # parsed once, applied below as-is
            self.store.append_replica_record(data, rec=rec)
            self._last_seq = int(msg.index)
            if rec.get("t") in STRUCTURAL_RECORDS:
                with self._lock:
                    self._assembler.invalidate()
            return ipb.AppendResponse(ok=True, term=self.term,
                                      log_len=self._last_seq)

    # -- wire leader election (conn/node.go:47-105 ballot, redesigned) ------

    HEARTBEAT_S = 0.5            # leader ping period
    ELECTION_TIMEOUT_S = (1.5, 3.0)   # randomized per-campaign window

    def vote(self, msg: ipb.VoteRequest, context) -> ipb.VoteResponse:
        """Grant iff the candidate's term is newer, we have not voted this
        term, and the candidate is at least as up to date on
        (max_commit_ts, log_len) — Raft's up-to-date rule."""
        with self._rlock:
            if msg.term <= self.term:
                return ipb.VoteResponse(granted=False, term=self.term)
            self._set_term(int(msg.term))
            self._step_down()
            self._last_seq = 0        # new term => new session sequence
            # one vote per term falls out of the strict term check above:
            # a second candidate at the same term is rejected there
            mine = (self.store.max_seen_commit_ts,
                    self.store.wal_record_count)
            theirs = (int(msg.max_commit_ts), int(msg.log_len))
            if theirs >= mine:
                self._leader_contact = time.monotonic()  # grace for winner
                return ipb.VoteResponse(granted=True, term=self.term)
            return ipb.VoteResponse(granted=False, term=self.term)

    def heartbeat(self, msg: ipb.HeartbeatRequest,
                  context) -> ipb.HeartbeatResponse:
        with self._rlock:
            if msg.term < self.term:
                return ipb.HeartbeatResponse(term=self.term, ok=False)
            if msg.term > self.term:
                self._set_term(int(msg.term))
                self._step_down()
                self._last_seq = 0
            self._leader_contact = time.monotonic()
            if msg.members:
                self.group_members = list(msg.members)
            return ipb.HeartbeatResponse(term=self.term, ok=True)

    def enable_elections(self) -> None:
        """Start the failure detector / heartbeat loop (the shared
        BallotLoop: leaders ping, followers campaign on silence).
        Requires advertise_addr."""
        from ..utils.ballot import BallotLoop

        if self._election_thread is not None:
            return
        self._leader_contact = time.monotonic()

        def touch():
            self._leader_contact = time.monotonic()

        self._election_thread = BallotLoop(
            is_leader=lambda: self.is_leader,
            send_pings=self._send_heartbeats,
            campaign=self._maybe_campaign,
            leader_contact=lambda: self._leader_contact,
            touch_contact=touch,
            ping_s=self.HEARTBEAT_S,
            timeout_range=self.ELECTION_TIMEOUT_S,
            stop_event=self._election_stop)
        self._election_thread.start()

    def stop_elections(self) -> None:
        self._election_stop.set()

    def _maybe_campaign(self) -> None:
        others = [a for a in self.group_members
                  if a != self.advertise_addr]
        if others:     # no known peers: never campaign
            self._campaign(others)

    def _send_heartbeats(self) -> None:
        members = sorted(set(self.group_members) | {self.advertise_addr})
        # adopt members that joined after the election (e.g. learned from
        # Zero's registry): add them to the ship set — their first append
        # gap triggers FetchState catch-up — so a joiner hears heartbeats
        # instead of endlessly campaigning against a healthy leader
        with self._ship_lock:
            known = {p.addr for p in self.peers}
            for a in members:
                if a != self.advertise_addr and a not in known:
                    self.peers.append(RemoteWorker(a))
                    self._peer_seq[len(self.peers) - 1] = 0
        for p in list(self.peers):
            try:
                p.heartbeat(self.term, self.advertise_addr, members)
            # dgraph: allow(except-seam) heartbeat fan-out: dead peers
            # are the expected case; liveness is judged by the receiver
            except Exception:
                pass

    def _campaign(self, others: list[str]) -> None:
        """One ballot round: term+1, self-vote, request votes; majority of
        the full member set wins and self-promotes."""
        with self._rlock:
            t = self.term + 1
            self._set_term(t)
            my_key = (self.store.max_seen_commit_ts,
                      self.store.wal_record_count)
        votes = 1
        for a in others:
            rw = None
            try:
                rw = RemoteWorker(a)
                r = rw.vote(t, my_key[0], my_key[1], self.advertise_addr,
                            timeout=1.0)
                if r.granted:
                    votes += 1
                elif r.term > t:
                    with self._rlock:
                        if r.term > self.term:
                            self._set_term(int(r.term))
                    return
            # dgraph: allow(except-seam) vote fan-out: unreachable
            # voters are abstentions; the tally decides
            except Exception:
                pass
            finally:
                if rw is not None:
                    rw.close()
        if not _tally(votes, len(others) + 1):
            return
        with self._rlock:
            if self.term != t:
                return           # a newer term appeared mid-ballot
            self._become_leader(t, others)
        self._send_heartbeats()

    _SIZES_TTL = 5.0   # Status doubles as the hot leader-discovery probe;
                       # the O(all keys) size walk refreshes on this cadence

    def fetch_state(self, _msg: ipb.FetchStateRequest,
                    context) -> ipb.FetchStateResponse:
        """Serve this store's durable files for a follower's catch-up
        (retrieveSnapshot / populateShard). Snapshot+WAL are copied under
        the store lock, so no half-shipped commit can tear the image."""
        import os
        import shutil
        import tempfile

        if self.store.dir is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "in-memory store has no durable state to serve "
                          "(in-memory leaders keep an unbounded ship buffer "
                          "instead)")
        tmp = tempfile.mkdtemp(prefix="dgt-fetch-")
        try:
            # seq <-> file consistency WITHOUT _ship_lock (taking it here
            # would invert _wal_write's store-lock -> ship-lock order and
            # deadlock the leader): ship + local append happen under one
            # store-lock critical section, so if the session seq is equal
            # before and after the clone, the cloned files correspond to
            # exactly that seq. Retry on movement.
            for _ in range(8):
                seq = self._session_seq
                self.store.clone_to(tmp)
                if self._session_seq == seq:
                    break
            else:
                context.abort(grpc.StatusCode.ABORTED,
                              "state kept moving during clone; retry")
            snap_p = os.path.join(tmp, "snapshot.bin")
            wal_p = os.path.join(tmp, "wal.log")
            snap = open(snap_p, "rb").read() if os.path.exists(snap_p) else b""
            wal = open(wal_p, "rb").read() if os.path.exists(wal_p) else b""
            return ipb.FetchStateResponse(snapshot=snap, wal=wal,
                                          session_seq=seq, term=self.term)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _state_sync(self, leader_addr: str) -> None:
        """Background full-state catch-up from the leader; on success this
        replica's store is rebuilt from the fetched files and appends
        resume at the leader's session seq."""
        import os

        try:
            rw = RemoteWorker(leader_addr)
            try:
                resp = rw.fetch_state()
            finally:
                rw.close()
            from ..storage.csr_build import SnapshotAssembler
            from ..storage.store import Store

            with self._rlock:
                if resp.term < self.term:
                    return             # a newer leader appeared meanwhile
                # adopt the SERVING leader's term with its state: seq and
                # term pair up (append() resets _last_seq on term changes,
                # which would re-feed records the synced store already has)
                if resp.term > self.term:
                    self._set_term(int(resp.term))
                d = self.store.dir
                self.store.close()
                detach = d is None
                if detach:
                    import tempfile as _tf

                    d = _tf.mkdtemp(prefix="dgt-sync-")
                # crash-consistent install order: stage both files, DELETE
                # the old wal first (old-snapshot + no-wal and new-snapshot
                # + no-wal are both valid states; new-snapshot + OLD-wal —
                # replaying a different log history over an unrelated base
                # — is not), then swap snapshot, then wal.
                snap_p = os.path.join(d, "snapshot.bin")
                wal_p = os.path.join(d, "wal.log")
                with open(snap_p + ".tmp", "wb") as f:
                    f.write(resp.snapshot)
                with open(wal_p + ".tmp", "wb") as f:
                    f.write(resp.wal)
                if os.path.exists(wal_p):
                    os.remove(wal_p)
                if resp.snapshot:
                    os.replace(snap_p + ".tmp", snap_p)
                else:
                    os.remove(snap_p + ".tmp")
                    if os.path.exists(snap_p):
                        os.remove(snap_p)
                os.replace(wal_p + ".tmp", wal_p)
                self.store = Store(d)
                if detach:   # in-memory replica: files were only a vehicle
                    if self.store._wal is not None:
                        self.store._wal.close()
                        self.store._wal = None
                    self.store.dir = None
                    import shutil as _sh

                    _sh.rmtree(d, ignore_errors=True)
                with self._lock:
                    self._assembler = SnapshotAssembler(
                        self.store, metrics=self.metrics,
                        lazy_folds=self.lazy_folds, device=self.device)
                self._last_seq = int(resp.session_seq)
        # dgraph: allow(except-seam) next gap retries the state sync;
        # the follower keeps serving its last applied state meanwhile
        except Exception:
            pass
        finally:
            self._syncing = False

    def status(self, _msg: ipb.StatusRequest, context) -> ipb.StatusResponse:
        import os
        import time

        now = time.monotonic()
        cached = getattr(self, "_sizes_cache", None)
        if cached is None or now - cached[0] > self._SIZES_TTL:
            size = 0
            if self.store.dir:
                wal = os.path.join(self.store.dir, "wal.log")
                snap = os.path.join(self.store.dir, "snapshot.bin")
                size = sum(os.path.getsize(p) for p in (wal, snap)
                           if os.path.exists(p))
            cached = (now, size,
                      json.dumps(self.store.tablet_sizes()))
            self._sizes_cache = cached
        return ipb.StatusResponse(
            term=self.term, log_len=self.store.wal_record_count,
            leader=self.is_leader,
            max_commit_ts=self.store.max_seen_commit_ts,
            tablets=self.store.predicates(), tablet_bytes=cached[1],
            tablet_sizes_json=cached[2],
            # live, not TTL-cached: load moves far faster than sizes and
            # the snapshot is one locked dict copy
            tablet_load_json=json.dumps(self.tablet_load_snapshot()),
            # compact mergeable metric snapshot on the existing
            # Status/load-report path: Zero's fleet
            # aggregator sums counters and merges the fixed-bucket
            # histograms EXACTLY across the cluster (/metrics/fleet).
            # TTL-cached: Status doubles as the 2s-per-client health
            # echo and leader probe — a full registry export + JSON
            # encode per echo is pure waste on that hot path (the fleet
            # scrape cadence is 15s; 1s staleness is invisible to it)
            metrics_json=self._metrics_export_json(now))

    _METRICS_TTL = 1.0

    def _metrics_export_json(self, now: float) -> str:
        cached = getattr(self, "_metrics_cache", None)
        if cached is None or now - cached[0] > self._METRICS_TTL:
            cached = (now, json.dumps(self.metrics.export()))
            self._metrics_cache = cached
        return cached[1]

    # -- distributed sort + schema (worker/sort.go:50, worker/schema.go:160) --

    def sort(self, msg: ipb.SortRequest, context) -> ipb.SortResponse:
        """Order the candidate uids by this tablet's value order — the
        owner-side of SortOverNetwork (index walk when a sortable index
        exists, value sort otherwise)."""
        from ..query import dql
        from ..query.engine import Executor

        snap = self._snapshot(msg.read_ts)
        ex = Executor(snap, self.store.schema)
        o = dql.Order(attr=msg.attr, desc=msg.desc, lang=msg.lang)
        uids = _uids_from_bytes(msg.uids)
        got = None
        if not msg.lang and msg.need:
            got = ex._sort_with_index(o, uids, int(msg.need))
        if got is None:
            present = [(ex._order_key(o, int(u)), int(u)) for u in uids]
            have = [(k, u) for k, u in present if k is not None]
            missing = [u for k, u in present if k is None]
            have.sort(key=lambda t: t[0], reverse=msg.desc)
            got = np.asarray([u for _, u in have] + missing, dtype=np.int64)
        return ipb.SortResponse(uids=_uids_to_bytes(got))

    def schema(self, msg: ipb.SchemaRequest, context) -> ipb.SchemaResponse:
        """Served tablets' schema entries as schema text lines (the
        GetSchemaOverNetwork payload; text round-trips parse_schema)."""
        want = set(msg.preds)
        lines = [str(e) for e in self.store.schema.entries()
                 if not want or e.predicate in want]
        return ipb.SchemaResponse(schema_json=json.dumps(lines))

    # -- predicate move (worker/predicate_move.go) ----------------------------

    def predicate_data(self, msg: ipb.PredicateDataRequest,
                       context) -> ipb.PredicateDataResponse:
        """Source side: stream the predicate's keys at read_ts as WAL 'm'
        records under the move txn, in resumable <=max_bytes chunks
        (movePredicateHelper :86-177; the reference batches <=32MB per Raft
        proposal, predicate_move.go:187). Cursor = 1 kind byte + key bytes
        of the last key sent; the snapshot read_ts makes every chunk read
        from the same immutable cut, so resumption is exact."""
        from ..storage import keys as K
        from ..storage.store import encode_record

        import bisect

        budget = int(msg.max_bytes) or MOVE_CHUNK_BYTES
        kinds = (K.KeyKind.DATA, K.KeyKind.REVERSE,
                 K.KeyKind.INDEX, K.KeyKind.COUNT)
        # sorted key list cached per (attr, read_ts): writes are blocked for
        # the whole move, so the set is stable; without this, each chunk's
        # rescan would make a C-chunk move O(C * K log K)
        ck = (msg.attr, int(msg.read_ts))
        cached = getattr(self, "_move_keys_cache", None)
        if cached is None or cached[0] != ck:
            per_kind = [sorted(self.store.keys_of(kind, msg.attr))
                        for kind in kinds]
            self._move_keys_cache = cached = (ck, per_kind)
        per_kind = cached[1]
        resume_kind, resume_key = -1, b""
        if msg.after:
            resume_kind, resume_key = msg.after[0], bytes(msg.after[1:])
        records, keys = [], []
        sent = 0
        last_kind, last_key = resume_kind, resume_key
        more = False
        for ki in range(max(resume_kind, 0), len(kinds)):
            klist = per_kind[ki]
            start = bisect.bisect_right(klist, resume_key) \
                if ki == resume_kind else 0
            for kb in klist[start:]:
                if sent >= budget:
                    more = True
                    break
                pl = self.store.lists.get(kb)
                if pl is None:
                    continue
                for p in pl.postings(msg.read_ts):
                    rec = encode_record(
                        {"t": "m", "s": int(msg.start_ts), "k": kb, "p": p})
                    records.append(rec)
                    sent += len(rec)
                keys.append(kb)
                last_kind, last_key = ki, kb
            if more:
                break
        if not more:
            entry = self.store.schema.get(msg.attr)
            if entry is not None:
                records.append(json.dumps({"t": "s", "line": str(entry)},
                                          separators=(",", ":")).encode())
            next_cursor = b""
            self._move_keys_cache = None   # release the sorted key lists
        else:
            next_cursor = bytes([max(last_kind, 0)]) + last_key
        return ipb.PredicateDataResponse(records=records, keys=keys,
                                         next=next_cursor, done=not more)

    def tablet_delta(self, msg: ipb.TabletDeltaRequest,
                     context) -> ipb.TabletDeltaResponse:
        """Source side of a replica freshness ship (coord/placement.py):
        every key of the tablet committed after since_ts — from the O(Δ)
        delta journal (storage/store.delta_since) — emitted as a
        DEL_ALL rewrite plus the key's effective postings at read_ts.
        The holder applies the records and commits them at `watermark`
        (the applied per-tablet ts this enumeration provably covers), so
        its replica-read gate stays exact. The watermark is read BEFORE
        the journal: a commit racing in between ships extra data but is
        never claimed as covered (understating is the safe direction).
        full_resync=true when the journal cannot prove completeness
        (overflow / bulk install / pre-journal base) — the controller
        re-installs from a full PredicateData stream instead."""
        from ..storage.store import encode_record

        attr = msg.attr
        watermark = self.store.pred_commit_ts.get(attr, 0)
        delta = self.store.delta_since(attr, int(msg.since_ts))
        if delta is None:
            return ipb.TabletDeltaResponse(full_resync=True,
                                           watermark=watermark)
        records: list[bytes] = []
        keys: list[bytes] = []
        start_ts = int(msg.start_ts)
        for kb in sorted(delta):
            pl = self.store.lists.get(kb)
            if pl is None:
                continue
            # DEL_ALL first: add_mutation folds it into the same txn
            # layer, clearing prior postings, so the rewrite REPLACES the
            # holder's copy of this key instead of unioning with it
            records.append(encode_record(
                {"t": "m", "s": start_ts, "k": kb,
                 "p": Posting(0, Op.DEL_ALL)}))
            # the read cut is the CLAIMED watermark, not the caller's
            # read_ts: a commit applied between the watermark read and
            # this key's read must not leak into a rewrite stamped at the
            # watermark (the holder would serve it to reads below its
            # commit ts — fresher than the snapshot asked for). A rollup
            # that folded past the watermark is equivalent at base_ts:
            # this tablet has no committed layer in (watermark, base_ts]
            # (watermark IS its max applied), so the folded base is the
            # same cut.
            try:
                effective = pl.postings(watermark)
            except ValueError:
                effective = pl.postings(pl.base_ts)
            for p in effective:
                records.append(encode_record(
                    {"t": "m", "s": start_ts, "k": kb, "p": p}))
            keys.append(kb)
        return ipb.TabletDeltaResponse(records=records, keys=keys,
                                       watermark=watermark)

    def ingest_records(self, msg: ipb.IngestRequest,
                       context) -> ipb.IngestResponse:
        """Destination side (ReceivePredicate): records flow through the
        WAL path, so a replicated leader ships them to its own quorum.
        Returns the applied count (the move's count handshake)."""
        if self.term > 0 and not self.is_leader:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"not leader (term {self.term})")
        from ..storage import keys as K

        structural = False
        n = 0
        for data in msg.records:
            rec = decode_record(bytes(data))
            structural |= rec.get("t") in STRUCTURAL_RECORDS
            t = rec.get("t")
            if t == "m":
                # a re-ingested tablet serves again (move-back); record
                # arrival BEFORE apply so a racing read can't observe the
                # data while the moved-away fence still refuses it
                self._moved_away.discard(
                    K.kind_attr_of(_key_bytes(rec["k"]))[1])
            elif t == "c":
                # install floor: the streamed copy has no history below
                # its commit — reads under it must go elsewhere (typed)
                for kraw in rec.get("k", ()):
                    a = K.kind_attr_of(_key_bytes(kraw))[1]
                    if int(rec["ts"]) > self._ingest_floor.get(a, 0):
                        self._ingest_floor[a] = int(rec["ts"])
            self.store.ingest_record(rec)
            n += 1
        if structural:
            with self._lock:
                self._assembler.invalidate()
        return ipb.IngestResponse(ingested=n)

    def delete_predicate(self, msg: ipb.DeletePredicateRequest,
                         context) -> ipb.DeletePredicateResponse:
        """Source cleanup after the map flip (the move's step 5; WAL-logged
        so this leader's replicas follow)."""
        if self.term > 0 and not self.is_leader:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"not leader (term {self.term})")
        # fence BEFORE the delete: a stale-routed read arriving mid-delete
        # must refuse (typed) rather than serve the half-deleted tablet
        self._moved_away.add(msg.attr)
        self.store.delete_predicate(msg.attr)
        with self._lock:
            self._assembler.invalidate()
        return ipb.DeletePredicateResponse()

    def handler(self):
        def u(fn, req_cls, resp_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)
        return grpc.method_handlers_generic_handler(SERVICE, {
            "ServeTask": u(self.serve_task, ipb.TaskRequest,
                           ipb.TaskResponse),
            "Membership": u(self.membership, ipb.MembershipRequest,
                            ipb.MembershipResponse),
            "Mutate": u(self.mutate, ipb.MutateRequest, ipb.MutateResponse),
            "Decide": u(self.decide, ipb.DecisionRequest,
                        ipb.DecisionResponse),
            "Append": u(self.append, ipb.AppendRequest, ipb.AppendResponse),
            "FetchState": u(self.fetch_state, ipb.FetchStateRequest,
                            ipb.FetchStateResponse),
            "Promote": u(self.promote, ipb.PromoteRequest,
                         ipb.PromoteResponse),
            "Vote": u(self.vote, ipb.VoteRequest, ipb.VoteResponse),
            "Heartbeat": u(self.heartbeat, ipb.HeartbeatRequest,
                           ipb.HeartbeatResponse),
            "Status": u(self.status, ipb.StatusRequest, ipb.StatusResponse),
            "Sort": u(self.sort, ipb.SortRequest, ipb.SortResponse),
            "Schema": u(self.schema, ipb.SchemaRequest, ipb.SchemaResponse),
            "PredicateData": u(self.predicate_data, ipb.PredicateDataRequest,
                               ipb.PredicateDataResponse),
            "IngestRecords": u(self.ingest_records, ipb.IngestRequest,
                               ipb.IngestResponse),
            "DeletePredicate": u(self.delete_predicate,
                                 ipb.DeletePredicateRequest,
                                 ipb.DeletePredicateResponse),
            "TabletDelta": u(self.tablet_delta, ipb.TabletDeltaRequest,
                             ipb.TabletDeltaResponse),
        })


def serve_worker(store, addr: str = "localhost:0",
                 max_workers: int = 8, advertise_host: str | None = None,
                 elections: bool = False, batching: bool = True,
                 batch_window_ms: float = 2.0, batch_max: int = 16,
                 cost_ledger: bool = True, lazy_folds: bool = True,
                 device: str = "cuda"):
    """Start a Worker gRPC server for one group's store; returns
    (server, bound_port). advertise_host overrides the callback host
    followers use for FetchState — required when binding a wildcard
    (0.0.0.0), which is unroutable from a peer. elections=True starts the
    wire-ballot failure detector (self-healing leader election without the
    control plane). batching/batch_window_ms/batch_max mirror the embedded
    Node's batched-dispatch knobs for the worker's own device path, which
    runs on `device` ("cuda" unless given; raises without a card)."""
    svc = WorkerService(store, batching=batching,
                        batch_window_ms=batch_window_ms,
                        batch_max=batch_max, cost_ledger=cost_ledger,
                        lazy_folds=lazy_folds, device=device)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         options=GRPC_OPTIONS)
    server.add_generic_rpc_handlers((svc.handler(),))
    port = server.add_insecure_port(addr)
    if port == 0:
        raise Unavailable(f"could not bind worker listener on {addr}")
    host = advertise_host or addr.rsplit(":", 1)[0] or "localhost"
    if host in ("0.0.0.0", "[::]", ""):
        import socket

        host = socket.gethostname()
    svc.advertise_addr = f"{host}:{port}"
    svc.tracer.proc = f"worker:{svc.advertise_addr}"
    if elections:
        svc.enable_elections()
    server.start()
    server.dgt_svc = svc     # CLI/tests reach the service behind the server
    return server, port


class RemoteWorker:
    """Client stub for one remote group (the conn/pool analog)."""

    def __init__(self, addr: str) -> None:
        self.addr = addr
        self.channel = grpc.insecure_channel(addr, options=GRPC_OPTIONS)
        self._serve = self.channel.unary_unary(
            f"/{SERVICE}/ServeTask",
            request_serializer=ipb.TaskRequest.SerializeToString,
            response_deserializer=ipb.TaskResponse.FromString)
        self._membership = self.channel.unary_unary(
            f"/{SERVICE}/Membership",
            request_serializer=ipb.MembershipRequest.SerializeToString,
            response_deserializer=ipb.MembershipResponse.FromString)
        self._mutate = self.channel.unary_unary(
            f"/{SERVICE}/Mutate",
            request_serializer=ipb.MutateRequest.SerializeToString,
            response_deserializer=ipb.MutateResponse.FromString)
        self._decide = self.channel.unary_unary(
            f"/{SERVICE}/Decide",
            request_serializer=ipb.DecisionRequest.SerializeToString,
            response_deserializer=ipb.DecisionResponse.FromString)
        self._append = self.channel.unary_unary(
            f"/{SERVICE}/Append",
            request_serializer=ipb.AppendRequest.SerializeToString,
            response_deserializer=ipb.AppendResponse.FromString)
        self._promote = self.channel.unary_unary(
            f"/{SERVICE}/Promote",
            request_serializer=ipb.PromoteRequest.SerializeToString,
            response_deserializer=ipb.PromoteResponse.FromString)
        self._vote = self.channel.unary_unary(
            f"/{SERVICE}/Vote",
            request_serializer=ipb.VoteRequest.SerializeToString,
            response_deserializer=ipb.VoteResponse.FromString)
        self._heartbeat = self.channel.unary_unary(
            f"/{SERVICE}/Heartbeat",
            request_serializer=ipb.HeartbeatRequest.SerializeToString,
            response_deserializer=ipb.HeartbeatResponse.FromString)
        self._fetch_state = self.channel.unary_unary(
            f"/{SERVICE}/FetchState",
            request_serializer=ipb.FetchStateRequest.SerializeToString,
            response_deserializer=ipb.FetchStateResponse.FromString)
        self._status = self.channel.unary_unary(
            f"/{SERVICE}/Status",
            request_serializer=ipb.StatusRequest.SerializeToString,
            response_deserializer=ipb.StatusResponse.FromString)
        self._sort = self.channel.unary_unary(
            f"/{SERVICE}/Sort",
            request_serializer=ipb.SortRequest.SerializeToString,
            response_deserializer=ipb.SortResponse.FromString)
        self._schema = self.channel.unary_unary(
            f"/{SERVICE}/Schema",
            request_serializer=ipb.SchemaRequest.SerializeToString,
            response_deserializer=ipb.SchemaResponse.FromString)
        self._predicate_data = self.channel.unary_unary(
            f"/{SERVICE}/PredicateData",
            request_serializer=ipb.PredicateDataRequest.SerializeToString,
            response_deserializer=ipb.PredicateDataResponse.FromString)
        self._ingest = self.channel.unary_unary(
            f"/{SERVICE}/IngestRecords",
            request_serializer=ipb.IngestRequest.SerializeToString,
            response_deserializer=ipb.IngestResponse.FromString)
        self._delete_pred = self.channel.unary_unary(
            f"/{SERVICE}/DeletePredicate",
            request_serializer=ipb.DeletePredicateRequest.SerializeToString,
            response_deserializer=ipb.DeletePredicateResponse.FromString)
        self._tablet_delta = self.channel.unary_unary(
            f"/{SERVICE}/TabletDelta",
            request_serializer=ipb.TabletDeltaRequest.SerializeToString,
            response_deserializer=ipb.TabletDeltaResponse.FromString)

    def append(self, term: int, index: int, data: bytes,
               leader_addr: str = "",
               timeout: float = 5.0) -> ipb.AppendResponse:
        return self._append(ipb.AppendRequest(
            term=term, index=index, data=data, leader_addr=leader_addr),
            timeout=timeout)

    def fetch_state(self, timeout: float = 60.0) -> "ipb.FetchStateResponse":
        return self._fetch_state(ipb.FetchStateRequest(), timeout=timeout)

    def promote(self, term: int, peers: list[str]) -> ipb.PromoteResponse:
        return self._promote(ipb.PromoteRequest(term=term, peers=peers))

    def vote(self, term: int, max_commit_ts: int, log_len: int,
             candidate: str, timeout: float = 2.0) -> ipb.VoteResponse:
        return self._vote(ipb.VoteRequest(
            term=term, max_commit_ts=max_commit_ts, log_len=log_len,
            candidate=candidate), timeout=timeout)

    def heartbeat(self, term: int, leader_addr: str, members: list[str],
                  timeout: float = 2.0) -> ipb.HeartbeatResponse:
        return self._heartbeat(ipb.HeartbeatRequest(
            term=term, leader_addr=leader_addr, members=members),
            timeout=timeout)

    def status(self, timeout: float = 3.0) -> ipb.StatusResponse:
        return self._status(ipb.StatusRequest(), timeout=timeout)

    def sort(self, attr: str, uids, desc: bool, lang: str, read_ts: int,
             need: int = 0) -> np.ndarray:
        r = self._sort(ipb.SortRequest(
            attr=attr, uids=_uids_to_bytes(uids), desc=desc, lang=lang,
            read_ts=read_ts, need=need))
        return _uids_from_bytes(r.uids)

    def schema(self, preds=()) -> str:
        """Schema text of the served tablets (parse with parse_schema)."""
        lines = json.loads(
            self._schema(ipb.SchemaRequest(preds=list(preds))).schema_json)
        return "\n".join(lines)

    def predicate_data(self, attr: str, read_ts: int, start_ts: int,
                       after: bytes = b"", max_bytes: int = 0,
                       ) -> "ipb.PredicateDataResponse":
        return self._predicate_data(ipb.PredicateDataRequest(
            attr=attr, read_ts=read_ts, start_ts=start_ts, after=after,
            max_bytes=max_bytes))

    def ingest_records(self, records) -> int:
        return int(self._ingest(
            ipb.IngestRequest(records=list(records))).ingested)

    def delete_predicate(self, attr: str) -> None:
        self._delete_pred(ipb.DeletePredicateRequest(attr=attr))

    def tablet_delta(self, attr: str, since_ts: int, read_ts: int,
                     start_ts: int) -> "ipb.TabletDeltaResponse":
        return self._tablet_delta(ipb.TabletDeltaRequest(
            attr=attr, since_ts=since_ts, read_ts=read_ts,
            start_ts=start_ts))

    def process_task(self, q: TaskQuery, read_ts: int,
                     min_applied: int = 0,
                     replica_read: bool = False) -> TaskResult:
        """ServeTask with span AND deadline propagation: the caller's
        remaining budget ships as invocation metadata (the server bounds
        its own waits by it) and doubles as the gRPC per-call timeout, so
        a blackholed peer costs exactly the remaining budget, never an
        unbounded wait."""
        faults.fire("rpc.send")
        msg = encode_task(q, read_ts, min_applied,
                          replica_read=replica_read)
        md = []
        timeout = None
        ddl = dl.to_metadata()
        if ddl is not None:
            dl.check(f"rpc:ServeTask {self.addr}")
            md.append(ddl)
            timeout = dl.clamp(None)
        tenant = tnc.current()
        if tenant:
            # tenant continuation: same sidecar channel as the
            # deadline and trace context — the worker scopes its ledger
            # and batcher keys by it (attrs are already storage-prefixed)
            md.append((tnc.WIRE_KEY, tenant))
        sp = otrace.current()
        lg = costs.current()
        if not sp:
            # unsampled: the call's span books its time, no context rides
            # the wire
            with otrace.span("rpc:ServeTask"):
                if lg is None:
                    if not md:
                        return decode_result(self._serve(msg))
                    return decode_result(self._serve(
                        msg, metadata=tuple(md), timeout=timeout))
                # cost ledger armed without a sampled trace: with_call so
                # the worker's shipped cost record is readable from the
                # trailer
                resp, call = self._serve.with_call(
                    msg, metadata=tuple(md) or None, timeout=timeout)
                self._merge_cost(lg, call)
                return decode_result(resp)
        # propagate the span context; the worker's spans ride back in
        # trailing metadata and graft into this trace's buffer
        with sp.tracer.start("rpc:ServeTask", parent=sp, kind="client",
                             attrs={"addr": self.addr,
                                    "attr": q.attr}) as rsp:
            md.append((otrace.WIRE_KEY, f"{rsp.trace_id}:{rsp.span_id}"))
            resp, call = self._serve.with_call(
                msg, metadata=tuple(md), timeout=timeout)
            for k, v in call.trailing_metadata() or ():
                if k == otrace.SPANS_KEY:
                    rsp.tracer.add_remote(otrace.decode_spans(v))
            self._merge_cost(lg, call)
            return decode_result(resp)

    def _merge_cost(self, lg, call) -> None:
        """Graft the worker's shipped cost record (trailing metadata)
        under the caller's ledger, keyed by this worker's address."""
        if lg is None:
            return
        for k, v in call.trailing_metadata() or ():
            if k == costs.WIRE_KEY:
                lg.merge_remote(self.addr, costs.CostLedger.from_wire(v))

    def membership(self) -> ipb.MembershipResponse:
        return self._membership(ipb.MembershipRequest())

    def _budgeted(self, stub, msg):
        """Issue a write-path RPC under the caller's deadline: remaining
        budget as the gRPC timeout + propagated metadata, so a blackholed
        leader costs the budget, never an unbounded wait. Unbudgeted
        callers keep the pre-existing no-timeout behavior."""
        ddl = dl.to_metadata()
        if ddl is None:
            return stub(msg)
        dl.check(f"rpc {self.addr}")
        return stub(msg, metadata=(ddl,), timeout=dl.clamp(None))

    def mutate(self, start_ts: int, edges) -> ipb.MutateResponse:
        return self._budgeted(self._mutate, ipb.MutateRequest(
            start_ts=start_ts, edges=[encode_edge(e) for e in edges]))

    def decide(self, start_ts: int, commit_ts: int, keys) -> None:
        self._budgeted(self._decide, ipb.DecisionRequest(
            start_ts=start_ts, commit_ts=commit_ts, keys=list(keys)))

    def close(self) -> None:
        self.channel.close()


class HedgedReplicas:
    """One group's replica set with tail-latency hedging + health echo.

    Reference: worker/task.go:75-132 processWithBackupRequest — a read RPC
    goes to one replica and, after a grace period, is hedged to a second
    (Jeff-Dean-style backup requests); conn/pool.go:153-186 runs a
    background Echo loop per connection feeding routing. Here Status is the
    echo; the loop marks replicas healthy/unhealthy and remembers which one
    leads. Reads prefer the leader but fail over / hedge to any healthy
    replica; staleness is prevented by the min_applied gate in serve_task
    (the follower waits for its applied watermark or refuses)."""

    HEDGE_GRACE = 0.3        # seconds before the backup request fires
    HEALTH_INTERVAL = 2.0    # echo loop period
    # breaker tuning: trip after this many consecutive transport failures,
    # probe again after BREAKER_OPEN_S (half-open)
    BREAKER_FAILS = 3
    BREAKER_OPEN_S = 2.0

    def __init__(self, addrs: list[str], metrics=None) -> None:
        from ..utils.metrics import Registry

        self.addrs = list(addrs)
        self.workers = [RemoteWorker(a) for a in addrs]
        self._ok = [True] * len(addrs)
        self._leader_idx = 0
        self._leader_confirmed = False
        self.metrics = metrics if metrics is not None else Registry()
        # per-replica circuit breakers fed by the same error/latency
        # signals the hedger sees: an open breaker routes fan-out around a
        # flapping replica instead of paying its timeout every request
        self.breakers = [CircuitBreaker(fail_threshold=self.BREAKER_FAILS,
                                        open_s=self.BREAKER_OPEN_S)
                         for _ in addrs]
        self._breaker_gauge = self.metrics.keyed("dgraph_breaker_state")
        self._breaker_open = self.metrics.counter(
            "dgraph_breaker_open_total")
        self._hedges = self.metrics.counter("dgraph_hedge_fired_total")
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max(2, 2 * len(addrs)))
        self._stop = threading.Event()
        self._thread = None
        if len(addrs) > 1:
            self._poll_once()    # routing is correct from the first read
            # dgraph: allow(ctxvar-copy) detached health-echo bg loop
            self._thread = threading.Thread(target=self._echo_loop,
                                            daemon=True)
            self._thread.start()

    def _record(self, idx: int, ok: bool, latency_s: float | None = None,
                e: Exception | None = None) -> None:
        """Feed one replica outcome into its breaker. Application-level
        refusals (FAILED_PRECONDITION: behind the floor / not leader) and
        caller-budget exhaustion (DeadlineExceeded / wire
        DEADLINE_EXCEEDED — the budget's fault, not the replica's) are
        NOT transport faults and never trip the breaker; a genuinely slow
        replica is caught by the latency soft-failure signal instead."""
        if e is not None and (
                self._is_behind(e)
                or isinstance(e, dl.DeadlineExceeded)
                or (isinstance(e, grpc.RpcError) and e.code() ==
                    grpc.StatusCode.DEADLINE_EXCEEDED)):
            return
        br = self.breakers[idx]
        was = br.state
        br.record(ok, latency_s)
        now = br.state
        if now != was:
            self._breaker_gauge.set(self.addrs[idx], now)
            if now == CircuitBreaker.OPEN:
                self._breaker_open.inc()
                otrace.event("breaker_open", addr=self.addrs[idx])

    # -- health echo ---------------------------------------------------------

    def _poll_once(self) -> None:
        saw_leader = False
        for i, rw in enumerate(self.workers):
            try:
                st = rw.status(timeout=1.0)
                self._ok[i] = True
                if st.leader:
                    self._leader_idx = i
                    saw_leader = True
                # the echo IS a breaker probe: a half-open replica whose
                # Status answers closes without needing query traffic
                self._record(i, True)
            except Exception as e:
                self._ok[i] = False
                self._record(i, False, e=e)
        self._leader_confirmed = saw_leader

    def _echo_loop(self) -> None:
        while not self._stop.wait(self.HEALTH_INTERVAL):
            self._poll_once()

    def mark_stale(self) -> None:
        """Force the next leader_worker() to re-discover (mutate-retry
        invalidation)."""
        self._leader_confirmed = False

    def _submit(self, fn, *args):
        """Pool submit that carries the caller's contextvars (the active
        trace span) into the worker thread, so hedged RPCs propagate the
        span context like the synchronous path does."""
        ctx = contextvars.copy_context()
        return self._pool.submit(ctx.run, fn, *args)

    def leader_worker(self) -> "RemoteWorker":
        """The group's current leader (single-replica groups lead
        themselves). Re-polls when unconfirmed; raises when no live replica
        claims leadership."""
        if len(self.workers) == 1:
            return self.workers[0]
        if not (self._leader_confirmed and self._ok[self._leader_idx]):
            self._poll_once()
        if self._leader_confirmed:
            return self.workers[self._leader_idx]
        raise Unavailable("group has no live leader")

    # -- routing -------------------------------------------------------------

    def _order(self) -> list[int]:
        """Primary first (leader if healthy, else first healthy), then the
        healthy rest, then unhealthy as a last resort. Breaker routing is
        POSITIONAL: an OPEN replica counts as unhealthy (fan-out routes
        around it instead of paying its timeout), a HALF-OPEN one is
        demoted behind every closed replica — it only sees the fallback
        traffic that reaches it when healthier replicas fail, which is
        the probe. Recovery without traffic comes from the Status echo
        loop (_poll_once feeds the breakers). Ordering never consumes
        allow() probe tokens — an order slot is not a dial."""
        n = len(self.workers)
        closed, half = [], []
        for i in range(n):
            if not self._ok[i]:
                continue
            st = self.breakers[i].state
            if st == CircuitBreaker.OPEN:
                continue
            (half if st == CircuitBreaker.HALF_OPEN else closed).append(i)
        if self._leader_idx in closed:
            order = [self._leader_idx] + \
                [i for i in closed if i != self._leader_idx] + half
        else:
            order = closed + half
        if not order:
            order = [i for i in range(n) if self._ok[i]]
        if not order:
            order = list(range(n))
        order += [i for i in range(n) if i not in order]
        return order

    @staticmethod
    def _is_behind(e: Exception) -> bool:
        return (isinstance(e, grpc.RpcError)
                and e.code() == grpc.StatusCode.FAILED_PRECONDITION)

    def _call(self, idx: int, q, read_ts: int,
              min_applied: int, replica_read: bool = False) -> TaskResult:
        """One replica attempt, feeding its breaker with the outcome and
        latency (the hedger's own signals)."""
        t0 = time.monotonic()
        try:
            res = self.workers[idx].process_task(q, read_ts, min_applied,
                                                 replica_read=replica_read)
        except Exception as e:
            self._record(idx, False, e=e)
            raise
        self._record(idx, True, time.monotonic() - t0)
        return res

    def _leader_only(self, q, read_ts: int) -> TaskResult:
        try:
            rw = self.leader_worker()
            idx = self.workers.index(rw)
        except RuntimeError:
            idx = self._order()[0]
        return self._call(idx, q, read_ts, 0)

    def process_task(self, q: TaskQuery, read_ts: int,
                     min_applied: int = 0,
                     replica_read: bool = False) -> TaskResult:
        if replica_read:
            # tablet-replica read (coord/placement.py): every freshness
            # decision is the HOLDER's (behind/ahead/dropped gates in
            # serve_task). No floor-stripping retry and no leader-only
            # fallback — a refusal here must bubble to the dispatcher,
            # whose fallback is the tablet's PRIMARY group, the only
            # party allowed to serve without the replica gates.
            return self._call(self._order()[0], q, read_ts, min_applied,
                              replica_read=True)
        order = self._order()
        if len(order) == 1:
            try:
                return self._call(order[0], q, read_ts, min_applied)
            except Exception as e:
                if min_applied > 0 and self._is_behind(e):
                    # the sole replica is behind the commit floor after
                    # its applied-wait: with nobody else to serve the
                    # tablet, this is the lost-Decide shape the
                    # multi-replica path already falls back on — retry
                    # once without the floor and serve its best state
                    return self._call(order[0], q, read_ts, 0)
                raise
        if min_applied <= 0:
            # no commit floor known for this tablet (cold cluster / Zero
            # restart): only the leader is guaranteed current, so don't
            # hedge to followers — same routing as the pre-hedging client
            return self._leader_only(q, read_ts)
        errs: list[Exception] = []
        rem = dl.remaining()
        if rem is not None and rem <= self.HEDGE_GRACE:
            # a hedge needs at least one grace period of budget; below
            # that the backup request could never beat the deadline —
            # fail over SEQUENTIALLY within what remains instead
            dl.check("hedged read")
            for idx in order:
                try:
                    return self._call(idx, q, read_ts, min_applied)
                except Exception as e:
                    errs.append(e)
                    if dl.remaining() <= 0:
                        break
            if errs and all(self._is_behind(e) for e in errs):
                return self._leader_only(q, read_ts)
            raise errs[-1]
        res = self._hedged_pair(q, read_ts, min_applied, order, errs)
        if res is not None:
            return res
        for idx in order[2:]:    # remaining replicas, sequentially
            try:
                return self._call(idx, q, read_ts, min_applied)
            except Exception as e:
                errs.append(e)
        if errs and all(self._is_behind(e) for e in errs):
            # every replica is behind the floor: the commit's Decide
            # fan-out was lost (client died between Zero commit and
            # Decide). The undelivered decision is invisible by the
            # reference's semantics — serve the leader's best state
            # instead of wedging reads until the next write heals it.
            return self._leader_only(q, read_ts)
        raise errs[-1]

    def _hedged_pair(self, q, read_ts, min_applied, order,
                     errs) -> TaskResult | None:
        f1 = self._submit(self._call, order[0], q, read_ts, min_applied)
        try:
            # grace clamps to the remaining budget so a hedged read never
            # waits past its deadline before even firing the backup
            return f1.result(timeout=dl.clamp(self.HEDGE_GRACE))
        except futures.TimeoutError:
            pending = {f1}       # slow primary: fire the backup request
            self._hedges.inc()
            otrace.event("hedge", addr=self.addrs[order[1]],
                         attr=q.attr)
        except Exception as e:
            errs.append(e)
            pending = set()
        pending.add(self._submit(self._call, order[1], q, read_ts,
                                 min_applied))
        while pending:
            done, pending = futures.wait(
                pending, return_when=futures.FIRST_COMPLETED,
                timeout=dl.clamp(None))
            if not done:
                # budget ran out mid-hedge: the in-flight RPCs carry
                # their own clamped timeouts and will drain on their own
                from ..utils.deadline import DeadlineExceeded

                raise DeadlineExceeded("hedged read: deadline exceeded "
                                       "waiting for replicas")
            for f in done:
                try:
                    return f.result()
                except Exception as e:
                    errs.append(e)
        return None

    def sort(self, *a, **kw):
        return self.workers[self._order()[0]].sort(*a, **kw)

    def schema(self, preds=()):
        return self.workers[self._order()[0]].schema(preds)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3.0)
        self._pool.shutdown(wait=False)
        for rw in self.workers:
            rw.close()


class NetworkDispatcher:
    """ProcessTaskOverNetwork: route each task by its tablet's owner —
    local group short-circuits, remote groups go over the wire."""

    def __init__(self, zero, local_group: int, local_snap_fn,
                 remotes: dict[int, RemoteWorker], schema,
                 pred_floors: dict[str, int] | None = None,
                 cache=None, gate=None,
                 tablet_replicas: dict[str, list[int]] | None = None,
                 metrics=None, rr_counter=None) -> None:
        self.zero = zero
        self.local_group = local_group
        self.local_snap_fn = local_snap_fn     # read_ts -> GraphSnapshot
        self.remotes = remotes                 # RemoteWorker or HedgedReplicas
        self.schema = schema
        # per-tablet commit floors (Zero oracle): hedged replica reads wait
        # for (or refuse below) this applied watermark
        self.pred_floors = pred_floors or {}
        # read-only tablet replicas (coord/placement.py): attr -> holder
        # groups. Reads spread round-robin across owner + holders; any
        # holder refusal (behind / ahead / dropped — FAILED_PRECONDITION)
        # or transport failure collapses back to the primary. Requires a
        # known commit floor: with floor 0 (cold cluster / Zero restart)
        # only the owner is provably current, so holders are skipped.
        self.tablet_replicas = tablet_replicas or {}
        self.metrics = metrics
        # replica spread cursor: callers that build a dispatcher PER
        # REQUEST (ClusterClient) pass a shared itertools.count so the
        # rotation continues across requests — a per-dispatcher cursor
        # would pin every request's first task to the owner
        import itertools

        self._rr = rr_counter if rr_counter is not None \
            else itertools.count()
        self._rr_lock = threading.Lock()
        # client-side task cache + dispatch gate over the fan-out: k-hop
        # queries replaying the same shape skip the wire entirely, and
        # concurrent identical tasks share one in-flight RPC. Keyed on
        # read_ts — an MVCC read at a given ts is immutable cluster-wide;
        # the owning ClusterClient clears the cache on its invalidation
        # path (leader failover / tablet-map refresh).
        self.cache = cache
        self.gate = gate

    def process_task(self, q: TaskQuery, read_ts: int) -> TaskResult:
        if self.cache is not None:
            return self.cache.dispatch(
                ("net", read_ts), q,
                lambda tq: self._process_task_raw(tq, read_ts))
        return self._process_task_raw(q, read_ts)

    def _process_task_raw(self, q: TaskQuery, read_ts: int) -> TaskResult:
        if self.gate is not None:
            return self.gate.run(lambda: self._route_task(q, read_ts))
        return self._route_task(q, read_ts)

    def _route_task(self, q: TaskQuery, read_ts: int) -> TaskResult:
        attr = q.attr[1:] if q.attr.startswith("~") else q.attr
        # consult (don't claim) the tablet map: a query on a never-seen
        # predicate answers empty locally instead of minting a tablet
        group = self.zero.tablets().get(attr)
        if group is None or group == self.local_group:
            return process_task(self.local_snap_fn(read_ts), q, self.schema)
        floor = self.pred_floors.get(attr, 0)
        holder = self._pick_replica(attr, group, floor)
        if holder is not None:
            hr = self.remotes.get(holder)
            try:
                res = hr.process_task(q, read_ts, min_applied=floor,
                                      replica_read=True)
                if self.metrics is not None:
                    self.metrics.counter("dgraph_replica_reads_total").inc()
                return res
            except Exception:
                # behind/ahead/dropped refusals AND transport failures all
                # collapse to the primary — replica reads are an
                # optimization, never a correctness dependency
                if self.metrics is not None:
                    self.metrics.counter(
                        "dgraph_replica_fallbacks_total").inc()
        rw = self.remotes.get(group)
        if rw is None:
            # a silent local fallback would answer with empty results for
            # data that exists — surface the unreachable group instead
            raise Unavailable(
                f"no connection to group {group} serving {attr!r}")
        return rw.process_task(q, read_ts, min_applied=floor)

    def _pick_replica(self, attr: str, owner: int,
                      floor: int) -> int | None:
        """Round-robin slot for this read over [owner] + holder groups;
        None = serve from the owner (no holders, unknown floor, or the
        cursor landed on the owner's slot)."""
        if floor <= 0:
            return None
        holders = self.tablet_replicas.get(attr)
        if not holders:
            return None
        cands = [h for h in holders
                 if h != owner and h in self.remotes]
        if not cands:
            return None
        with self._rr_lock:
            slot = next(self._rr)
        pick = slot % (len(cands) + 1)         # owner owns one slot
        return None if pick == 0 else cands[pick - 1]

    def sort_over_network(self, attr: str, uids, desc: bool, lang: str,
                          read_ts: int, need: int = 0):
        """Route an order-by to the attr's owning group (worker/sort.go:50
        SortOverNetwork): the owner walks its sortable index (bounded) or
        value-sorts, returning the candidates reordered."""
        group = self.zero.tablets().get(attr)
        if group is None or group == self.local_group:
            return None              # local/unknown: caller sorts locally
        rw = self.remotes.get(group)
        if rw is None:
            raise Unavailable(f"no connection to group {group} for sort")
        return rw.sort(attr, uids, desc, lang, read_ts, need)

    def schema_over_network(self, preds=()):
        """Merged schema text from every reachable group
        (worker/schema.go:160 GetSchemaOverNetwork)."""
        parts = []
        for g, rw in sorted(self.remotes.items()):
            try:
                t = rw.schema(preds)
            # dgraph: allow(except-seam) schema merge is best-effort per
            # group; an unreachable group contributes nothing
            except Exception:
                continue
            if t:
                parts.append(t)
        return "\n".join(parts)

    # -- write fan-out (MutateOverNetwork / CommitOverNetwork) ---------------

    def mutate_over_network(self, edges, start_ts: int, local_store):
        """Split a txn's edges by owning group and apply on each — local
        slice in-process, remote slices via the Mutate RPC
        (worker/mutation.go:470 populateMutationMap + :424 proposeOrSend).
        Returns (keys_by_group, conflict keys, touched preds); the caller
        tracks conflicts in its oracle and later calls decide_over_network.

        Partial failure aborts every slice already buffered (the same leak
        guard the in-process cluster path has); writes to moving tablets
        are rejected up front (the predicate-move fence)."""
        from ..query import mutation as mut

        for e in edges:
            if self.zero.writes_blocked(e.attr) or (
                    e.attr == "*" and self.zero.moving_tablets()):
                raise FailedPrecondition(
                    f"predicate {e.attr!r} is moving; retry")
        by_group = mut.split_edges_by_group(
            edges, self.zero.n_groups, self.zero.should_serve)
        keys_by_group: dict[int, list[bytes]] = {}
        conflicts: list[bytes] = []
        preds: set[str] = set()
        try:
            for g, ge in sorted(by_group.items()):
                if g == self.local_group:
                    touched, conflict, p = mut.apply_mutations(
                        local_store, ge, start_ts)
                else:
                    rw = self.remotes.get(g)
                    if rw is None:
                        raise Unavailable(f"no connection to group {g}")
                    resp = rw.mutate(start_ts, ge)
                    touched = list(resp.keys)
                    conflict = list(resp.conflict_keys)
                    p = set(resp.preds)
                keys_by_group[g] = touched
                conflicts += conflict
                preds |= p
        except BaseException:
            # abort the slices that DID buffer so they can't pin the
            # oracle watermark / leak uncommitted layers
            try:
                self.decide_over_network(start_ts, 0, keys_by_group,
                                         local_store)
            # dgraph: allow(except-seam) best-effort abort fan-out on
            # the unwind path; the raise below carries the real failure
            except Exception:
                pass
            raise
        return keys_by_group, conflicts, preds

    def decide_over_network(self, start_ts: int, commit_ts: int,
                            keys_by_group: dict, local_store) -> None:
        """Fan the commit (commit_ts > 0) or abort decision to every group
        that buffered a slice (CommitOverNetwork)."""
        for g, keys in sorted(keys_by_group.items()):
            if g == self.local_group:
                if commit_ts:
                    local_store.commit(start_ts, commit_ts, keys)
                else:
                    local_store.abort(start_ts, keys)
            else:
                self.remotes[g].decide(start_ts, commit_ts, keys)
