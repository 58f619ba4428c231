"""Zero as its own process: the coordinator's gRPC surface + client stub.

Port of dgraph_tpu/coord/zero_service.py: host code only (Zero takes no
device).

Reference semantics: `dgraph zero` is a separate Raft-backed service
(dgraph/cmd/zero/zero.go:328 Connect, oracle.go:276 commit, assign.go:65
leases, protos/internal.proto:370-379 service Zero). This exposes the
library Zero (coord/zero.py — oracle, uid lease, tablet map) over the
internal wire protocol so worker and client processes coordinate through
RPCs instead of shared memory. Single-instance (the library object IS the
replicated state machine's apply target; multi-zero Raft is out of scope —
the in-process quorum story lives in coord/replication.py).
"""

from __future__ import annotations

import json
import threading
import time
from concurrent import futures

try:
    import grpc
except ImportError:              # pragma: no cover
    grpc = None

from ..obs import otrace
from ..protos import internal_pb2 as ipb
from ..utils import deadline as dl
from ..utils import faults
from ..utils.ballot import tally as _tally
from ..utils.deadline import DeadlineExceeded
from ..utils.errors import FailedPrecondition, Unavailable
from ..utils.retry import backoff_s
from .zero import TxnConflict, TxnNotFound, Zero

SERVICE = "dgraph_tpu.internal.Zero"


class ZeroService:
    """gRPC handlers over one Zero instance. With a ZeroReplica attached
    (multi-zero mode), coordination RPCs are served only by the leader —
    standbys reject with FAILED_PRECONDITION and clients rotate."""

    def __init__(self, zero: Zero) -> None:
        self.zero = zero
        self._lock = threading.Lock()
        self._members: dict[int, list[str]] = {}   # group -> member addrs
        self.replica: "ZeroReplica | None" = None  # multi-zero role
        # trace continuation for coordinator RPCs: a client-propagated span
        # context puts lease/commit/tablet calls in the query's trace
        self.tracer = otrace.Tracer(proc="zero")

    def _require_leader(self, ctx) -> None:
        if self.replica is not None and not self.replica.is_leader:
            if ctx is None:            # ops-HTTP path (no gRPC context)
                raise FailedPrecondition("not zero leader")
            ctx.abort(grpc.StatusCode.FAILED_PRECONDITION,
                      "not zero leader")

    # -- membership ----------------------------------------------------------

    def connect(self, msg: ipb.ZeroConnectRequest, ctx) -> ipb.ZeroConnectResponse:
        """Assign a joining worker to a group (zero.go:328-434: fill groups
        round-robin; an explicit group joins as another replica of it)."""
        self._require_leader(ctx)
        with self._lock:
            if msg.group >= 0:
                g = int(msg.group)
            else:
                sizes = {g: len(a) for g, a in self._members.items()}
                for g in range(self.zero.n_groups):
                    sizes.setdefault(g, 0)
                g = min(sizes, key=lambda k: (sizes[k], k))
            members = self._members.setdefault(g, [])
            if msg.addr and msg.addr not in members:
                members.append(msg.addr)
            rid = members.index(msg.addr) if msg.addr in members else 0
            return ipb.ZeroConnectResponse(group=g, replica_id=rid)

    # -- leases --------------------------------------------------------------

    def new_txn(self, msg: ipb.ZeroLeaseRequest, ctx) -> ipb.ZeroLeaseResponse:
        self._require_leader(ctx)
        return ipb.ZeroLeaseResponse(
            first=self.zero.oracle.new_txn().start_ts)

    def timestamps(self, msg: ipb.ZeroLeaseRequest, ctx) -> ipb.ZeroLeaseResponse:
        self._require_leader(ctx)
        return ipb.ZeroLeaseResponse(
            first=self.zero.oracle.timestamps(max(1, int(msg.n))))

    def assign_uids(self, msg: ipb.ZeroLeaseRequest, ctx) -> ipb.ZeroLeaseResponse:
        self._require_leader(ctx)
        first, _last = self.zero.uids.assign(max(1, int(msg.n)))
        return ipb.ZeroLeaseResponse(first=first)

    # -- oracle --------------------------------------------------------------

    def commit_or_abort(self, msg: ipb.ZeroCommitRequest,
                        ctx) -> ipb.ZeroCommitResponse:
        """Track the txn's conflict keys then decide (oracle.go:276-320;
        the client sends keys collected from every group's Mutate reply)."""
        self._require_leader(ctx)
        start_ts = int(msg.start_ts)
        if msg.abort:
            self.zero.oracle.abort(start_ts)
            return ipb.ZeroCommitResponse(commit_ts=0, aborted=True)
        try:
            self.zero.oracle.track(start_ts, list(msg.conflict_keys),
                                   list(msg.preds))
            commit_ts = self.zero.oracle.commit(start_ts)
            return ipb.ZeroCommitResponse(commit_ts=commit_ts, aborted=False)
        except TxnConflict:
            return ipb.ZeroCommitResponse(commit_ts=0, aborted=True)
        except TxnNotFound as e:
            ctx.abort(grpc.StatusCode.NOT_FOUND, str(e))

    # -- tablets -------------------------------------------------------------

    def should_serve(self, msg: ipb.ZeroTabletRequest,
                     ctx) -> ipb.ZeroTabletResponse:
        self._require_leader(ctx)
        if msg.read_only:
            g = self.zero.tablets().get(msg.attr)
            return ipb.ZeroTabletResponse(group=-1 if g is None else g)
        return ipb.ZeroTabletResponse(group=self.zero.should_serve(msg.attr))

    def state(self, _msg: ipb.ZeroStateRequest, ctx) -> ipb.ZeroStateResponse:
        self._require_leader(ctx)   # clients read floors/ts from the leader
        st = self.zero.state()
        with self._lock:
            for g, addrs in self._members.items():
                st["groups"].setdefault(str(g), {})["members"] = list(addrs)
        st["tabletMap"] = self.zero.tablets()
        return ipb.ZeroStateResponse(state_json=json.dumps(st))

    def _traced(self, fn, name: str):
        """Wrap one handler with trace continuation: join a propagated
        span context, ship the server span back in trailing metadata."""
        def handler(msg, ctx):
            wire = None
            if ctx is not None:
                for k, v in ctx.invocation_metadata() or ():
                    if k == otrace.WIRE_KEY:
                        wire = v
                        break
            if not wire:
                return fn(msg, ctx)
            sp = self.tracer.join(wire, f"zero:{name}")
            try:
                with sp:
                    return fn(msg, ctx)
            finally:
                spans = self.tracer.take(sp.trace_id)
                if spans:
                    try:
                        ctx.set_trailing_metadata(
                            ((otrace.SPANS_KEY,
                              otrace.encode_spans(spans)),))
                    # dgraph: allow(except-seam) aborted RPC: spans
                    # drop, buffer already drained
                    except Exception:
                        pass
        return handler

    def handler(self):
        def u(fn, req_cls, resp_cls, name=""):
            return grpc.unary_unary_rpc_method_handler(
                self._traced(fn, name) if name else fn,
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)
        methods = {
            "Connect": u(self.connect, ipb.ZeroConnectRequest,
                         ipb.ZeroConnectResponse, "Connect"),
            "NewTxn": u(self.new_txn, ipb.ZeroLeaseRequest,
                        ipb.ZeroLeaseResponse, "NewTxn"),
            "Timestamps": u(self.timestamps, ipb.ZeroLeaseRequest,
                            ipb.ZeroLeaseResponse, "Timestamps"),
            "AssignUids": u(self.assign_uids, ipb.ZeroLeaseRequest,
                            ipb.ZeroLeaseResponse, "AssignUids"),
            "CommitOrAbort": u(self.commit_or_abort, ipb.ZeroCommitRequest,
                               ipb.ZeroCommitResponse, "CommitOrAbort"),
            "ShouldServe": u(self.should_serve, ipb.ZeroTabletRequest,
                             ipb.ZeroTabletResponse, "ShouldServe"),
            "State": u(self.state, ipb.ZeroStateRequest,
                       ipb.ZeroStateResponse, "State"),
        }
        if self.replica is not None:
            r = self.replica
            methods.update({
                "ZeroShip": u(r.zero_ship, ipb.ZeroShipRequest,
                              ipb.ZeroShipResponse),
                "ZeroVote": u(r.zero_vote, ipb.ZeroVoteRequest,
                              ipb.ZeroVoteResponse),
                "ZeroPing": u(r.zero_ping, ipb.ZeroPingRequest,
                              ipb.ZeroPingResponse),
            })
        return grpc.method_handlers_generic_handler(SERVICE, methods)


class ZeroReplica:
    """Multi-zero replication + ballot election (reference
    dgraph/cmd/zero/raft.go: Zero is its own Raft group).

    Redesign onto the quorum-shipping machinery: the leader ships its FULL
    durable state (zero_state.json — lease ceilings + tablet map, the exact
    payload a restarted Zero recovers from) plus the worker registry to
    standbys on every persist, quorum-acked. Standbys store it; a standby
    that misses pings campaigns (up-to-dateness = state sequence), and the
    winner re-initializes its Zero from the replicated state — the kill -9
    restart path — then serves. Crash semantics match the single-zero
    durability contract: at most one lease block burns; pending txns abort.
    """

    PING_S = 0.5
    ELECTION_TIMEOUT_S = (1.5, 3.0)

    def __init__(self, svc: ZeroService, zero_dir: str, advertise: str,
                 members: list[str], bootstrap_leader: bool) -> None:
        import os

        self.svc = svc
        self.dir = zero_dir
        self.advertise = advertise
        self.members = sorted(set(members) | {advertise})
        self.is_leader = False
        self.seq = 0
        self._meta_path = os.path.join(zero_dir, "zero_repl.json")
        self.term = 0
        if os.path.exists(self._meta_path):
            meta = json.loads(open(self._meta_path).read())
            self.term = int(meta.get("term", 0))
            self.seq = int(meta.get("seq", 0))
        self._lock = threading.RLock()
        self._leader_contact = time.monotonic()
        self._stop = threading.Event()
        self._bootstrap = bootstrap_leader
        self._peer_cache: dict[str, ZeroClient] = {}
        self._ping_fail_rounds = 0
        self._ship_pool = None       # parallel ship fan-out executor
        svc.replica = self

    # -- durable meta --------------------------------------------------------

    def _save_meta(self) -> None:
        import os

        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.term, "seq": self.seq}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path)

    # -- leader side ---------------------------------------------------------

    def start(self) -> None:
        from ..utils.ballot import BallotLoop

        # bootstrap only a FRESH cluster: a restarted idx-0 zero with a
        # persisted term may rejoin a cluster that elected past it — it
        # must campaign like anyone else, not self-promote into a
        # split-brain at a colliding term
        if self._bootstrap and self.term == 0:
            self._become_leader(1)

        def touch():
            self._leader_contact = time.monotonic()

        self._ballot = BallotLoop(
            is_leader=lambda: self.is_leader,
            send_pings=self._ping_round,
            campaign=self._campaign,
            leader_contact=lambda: self._leader_contact,
            touch_contact=touch,
            ping_s=self.PING_S,
            timeout_range=self.ELECTION_TIMEOUT_S,
            stop_event=self._stop)
        self._ballot.start()

    def stop(self) -> None:
        self._stop.set()
        if self._ship_pool is not None:
            self._ship_pool.shutdown(wait=False)
        for c in self._peer_cache.values():
            try:
                c.close()
            # dgraph: allow(except-seam) shutdown path: close every peer
            # channel even when one is already torn down
            except Exception:
                pass
        self._peer_cache.clear()

    def _peer_clients(self):
        # persistent channels: pings run every PING_S and ships run under
        # Zero._plock — per-call channel setup would serialize lease
        # issuance behind TCP handshakes
        out = []
        for a in self.members:
            if a == self.advertise:
                continue
            c = self._peer_cache.get(a)
            if c is None:
                c = self._peer_cache[a] = ZeroClient(a)
            out.append(c)
        return out

    def _become_leader(self, term: int) -> None:
        with self._lock:
            self.term = term
            self._save_meta()
            # adopt the replicated state: re-init Zero from this dir (the
            # restart-recovery path: lease ceilings + tablets)
            old = self.svc.zero
            fresh = Zero(n_groups=old.n_groups, dirpath=self.dir)
            fresh.persist_sink = self._ship
            self.svc.zero = fresh
            # worker registry from the last ship received (if any)
            import os

            mp = os.path.join(self.dir, "zero_members.json")
            if os.path.exists(mp):
                try:
                    reg = json.loads(open(mp).read())
                    with self.svc._lock:
                        self.svc._members = {int(g): list(a)
                                             for g, a in reg.items()}
                except (ValueError, OSError):
                    pass    # torn legacy file: workers re-register anyway
            self._ping_fail_rounds = 0   # fresh leadership, fresh tolerance
            self.is_leader = True

    def _ship(self, state_json: str) -> None:
        """Called from Zero._persist (under its _plock): replicate to a
        quorum of zeros. Quorum counts self; on failure step down — a
        minority leader must not keep minting leases.

        The RPC fan-out runs in PARALLEL with the replica lock released:
        ships are full-state idempotent replaces ordered by seq (standbys
        reject anything below their seq), so ordering needs no lock — and
        one partitioned standby must cost one RPC timeout, not stall
        every lease persist behind a sequential walk while holding the
        lock the ping/vote handlers need."""
        with self._lock:
            if not self.is_leader:
                return
            self.seq += 1
            seq = self.seq
            term = self.term
            self._save_meta()
            with self.svc._lock:
                members_json = json.dumps(
                    {str(g): a for g, a in self.svc._members.items()})
            peers = self._peer_clients()
            members_n = len(self.members)
            if self._ship_pool is None and peers:
                self._ship_pool = futures.ThreadPoolExecutor(
                    max_workers=max(len(self.members), 2),
                    thread_name_prefix="dgt-zship")
            pool = self._ship_pool

        def one(c) -> int:
            try:
                r = c.zero_ship(term, seq, state_json, members_json)
                if r.ok:
                    return 1
                return -1 if r.term > term else 0
            except Exception:
                return 0

        try:
            results = list(pool.map(one, peers)) if peers else []
        except RuntimeError:
            # stop() shut the pool down mid-persist: count every peer as
            # un-acked — the quorum check below raises the same clean
            # quorum-lost error the sequential path produced
            results = [0] * len(peers)
        acks = 1 + sum(1 for r in results if r == 1)
        deposed = any(r == -1 for r in results)
        quorum = members_n // 2 + 1
        if deposed or acks < quorum:
            with self._lock:
                self.is_leader = False
            if acks < quorum:
                raise Unavailable(
                    f"zero quorum lost ({acks}/{members_n})")

    def _ping_round(self) -> None:
        """One leader ping fan-out with quorum tracking: a partitioned
        leader must stop deciding — two live oracles must never coexist
        (the worker path's NoQuorum step-down, applied to pings)."""
        acked = 1                    # self
        for c in self._peer_clients():
            try:
                r = c.zero_ping(self.term, self.advertise, self.members)
                if r.term <= self.term:
                    acked += 1
                else:                # deposed: a newer term exists
                    with self._lock:
                        self.term = int(r.term)
                        self.is_leader = False
                        self._save_meta()
                    self._ping_fail_rounds = 0
                    return
            # dgraph: allow(except-seam) ping fan-out: a dead peer is the
            # EXPECTED case; the tally below counts the silence
            except Exception:
                pass
        if not _tally(acked, len(self.members)):
            self._ping_fail_rounds += 1
            if self._ping_fail_rounds >= 3:
                with self._lock:
                    self.is_leader = False
        else:
            self._ping_fail_rounds = 0

    def _campaign(self) -> None:
        others = [a for a in self.members if a != self.advertise]
        if not others:
            return
        with self._lock:
            t = self.term + 1
            self.term = t
            self._save_meta()
            my_seq = self.seq
        votes = 1
        for c in self._peer_clients():
            try:
                r = c.zero_vote(t, my_seq, self.advertise)
                if r.granted:
                    votes += 1
                elif r.term > t:
                    with self._lock:
                        self.term = max(self.term, int(r.term))
                        self._save_meta()
                    return
            # dgraph: allow(except-seam) campaign fan-out: unreachable
            # voters are abstentions; the tally decides
            except Exception:
                pass
        if _tally(votes, len(self.members)):
            with self._lock:
                if self.term == t:
                    self._become_leader(t)

    # -- standby handlers ----------------------------------------------------

    def zero_ship(self, msg: ipb.ZeroShipRequest, ctx) -> ipb.ZeroShipResponse:
        import os

        with self._lock:
            if msg.term < self.term:
                return ipb.ZeroShipResponse(ok=False, term=self.term,
                                            seq=self.seq)
            newer_term = msg.term > self.term
            if newer_term or self.is_leader:
                self.term = int(msg.term)
                self.is_leader = False
            if not newer_term and int(msg.seq) < self.seq:
                # stale re-ship (e.g. a deposed leader's in-flight persist)
                # — but ONLY within the same term. A strictly newer term's
                # ship is a full-state replace and its seq is adopted: a
                # standby that alone received a quorum-failed ship would
                # otherwise reject every subsequent ship via this check
                # and later resurrect the unacked state by winning an
                # election on its inflated seq.
                return ipb.ZeroShipResponse(ok=False, term=self.term,
                                            seq=self.seq)
            self._leader_contact = time.monotonic()
            # store the full state durably (idempotent full replace)
            path = os.path.join(self.dir, "zero_state.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(msg.state_json)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            if msg.members_json:
                mp = os.path.join(self.dir, "zero_members.json")
                with open(mp + ".tmp", "w") as f:
                    f.write(msg.members_json)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(mp + ".tmp", mp)
            self.seq = int(msg.seq)
            self._save_meta()
            return ipb.ZeroShipResponse(ok=True, term=self.term,
                                        seq=self.seq)

    def zero_vote(self, msg: ipb.ZeroVoteRequest, ctx) -> ipb.ZeroVoteResponse:
        with self._lock:
            if msg.term <= self.term:
                return ipb.ZeroVoteResponse(granted=False, term=self.term)
            self.term = int(msg.term)
            self.is_leader = False
            self._save_meta()
            if int(msg.seq) >= self.seq:      # up-to-dateness on state seq
                self._leader_contact = time.monotonic()
                return ipb.ZeroVoteResponse(granted=True, term=self.term)
            return ipb.ZeroVoteResponse(granted=False, term=self.term)

    def zero_ping(self, msg: ipb.ZeroPingRequest, ctx) -> ipb.ZeroPingResponse:
        with self._lock:
            if msg.term < self.term:
                return ipb.ZeroPingResponse(term=self.term, ok=False,
                                            leader=self.is_leader)
            if msg.term > self.term:
                self.term = int(msg.term)
                self.is_leader = False
                self._save_meta()
            self._leader_contact = time.monotonic()
            if msg.members:
                self.members = sorted(set(msg.members) | {self.advertise})
            return ipb.ZeroPingResponse(term=self.term, ok=True,
                                        leader=self.is_leader)


class MoveError(Exception):
    pass


class ZeroOps:
    """Cluster operations driven FROM Zero: tablet moves over the wire and
    the automatic rebalance tick (dgraph/cmd/zero/tablet.go:60-74; move
    protocol worker/predicate_move.go:86-177)."""

    def __init__(self, svc: ZeroService) -> None:
        import os

        from ..parallel.remote import MOVE_CHUNK_BYTES

        self.svc = svc
        self._move_lock = threading.Lock()
        # env override so systests can force many small chunks through the
        # real wire path
        self.chunk_bytes = int(os.environ.get("DGRAPH_TPU_MOVE_CHUNK",
                                              MOVE_CHUNK_BYTES))

    @property
    def zero(self):
        # dynamic: a ZeroReplica promotion swaps svc.zero for a fresh
        # instance recovered from the replicated state
        return self.svc.zero

    def _leader_of(self, group: int):
        from ..parallel.remote import RemoteWorker

        with self.svc._lock:
            addrs = list(self.svc._members.get(group, ()))
        if not addrs:
            raise MoveError(f"group {group} has no members")
        if len(addrs) == 1:
            return RemoteWorker(addrs[0])
        for a in addrs:
            rw = RemoteWorker(a)
            try:
                if rw.status().leader:
                    return rw
            # dgraph: allow(except-seam) leader probe: an unreachable
            # candidate simply is not the leader
            except Exception:
                pass
            rw.close()
        raise MoveError(f"group {group} has no live leader")

    def move_tablet(self, attr: str, dst_group: int) -> dict:
        """The 7-step move over the internal protocol: block writes → abort
        open txns touching the tablet → snapshot-stream its records to the
        destination leader → commit → flip the map → delete at the source.
        Buffered layers of aborted txns on workers are reaped by their own
        decide/abort paths; a mid-stream failure leaves the source
        authoritative (the copy rides an uncommitted txn)."""
        import base64

        with self._move_lock:
            # read replicas of a moving tablet are dropped FIRST — inside
            # _move_lock, so a concurrent install_replica (controller tick
            # or manual /addReplica) cannot re-install one between the
            # drop and the stream: the move streams into the destination
            # store, and a destination that already holds replica rows
            # would union two copies; holders on other groups would keep
            # pulling deltas from a deposed owner.
            for g in sorted(self.zero.replica_holders(attr)):
                try:
                    self.drop_replica(attr, g)
                # dgraph: allow(except-seam) routing already stopped;
                # orphaned replica data is reaped by a later install
                except Exception:
                    pass
            src_group = self.zero.tablets().get(attr)
            if src_group is None:
                raise MoveError(f"tablet {attr!r} is not served")
            if src_group == dst_group:
                return {"moved_records": 0, "tablet": attr}
            src = self._leader_of(src_group)
            try:
                dst = self._leader_of(dst_group)
            except BaseException:
                src.close()
                raise
            self.zero.block_writes(attr)
            try:
                aborted = 0
                for ts in self.zero.oracle.pending_on(attr):
                    self.zero.oracle.abort(ts)
                    aborted += 1
                # a commit DECIDED at the oracle may still have its Decide
                # RPC in flight to the source leader; streaming before it
                # applies would silently drop committed postings (and the
                # source delete would destroy them). Wait for the source's
                # applied per-tablet watermark to reach the oracle's.
                target = self.zero.oracle.pred_commit.get(attr, 0)
                deadline = time.monotonic() + 5.0
                while target and time.monotonic() < deadline:
                    applied = json.loads(
                        src.membership().pred_commit_json or "{}")
                    if int(applied.get(attr, 0)) >= target:
                        break
                    time.sleep(0.05)
                else:
                    if target:
                        raise MoveError(
                            f"source never applied commits on {attr!r} up "
                            f"to ts {target} (lost Decide?); move aborted")
                read_ts = self.zero.oracle.read_ts()
                move_st = self.zero.oracle.new_txn()
                keys_b64 = []
                try:
                    # chunked stream: <=MOVE_CHUNK_BYTES per message
                    # (reference predicate_move.go:187), resumable cursor,
                    # count handshake before the map flips (:171-176)
                    sent = ingested = 0
                    cursor = b""
                    while True:
                        faults.fire("move.chunk_ship")
                        resp = src.predicate_data(
                            attr, read_ts, move_st.start_ts, after=cursor,
                            max_bytes=self.chunk_bytes)
                        keys_b64.extend(base64.b64encode(bytes(k)).decode()
                                        for k in resp.keys)
                        sent += len(resp.records)
                        if resp.records:
                            ingested += dst.ingest_records(
                                list(resp.records))
                        if resp.done:
                            break
                        cursor = bytes(resp.next)
                    if ingested != sent:
                        raise MoveError(
                            f"move count handshake failed: sent {sent} "
                            f"records, destination ingested {ingested}")
                    commit_ts = self.zero.oracle.commit(move_st.start_ts)
                    crec = json.dumps(
                        {"t": "c", "s": move_st.start_ts, "ts": commit_ts,
                         "k": keys_b64}, separators=(",", ":")).encode()
                    dst.ingest_records([crec])
                except BaseException:
                    # mid-stream failure (incl. a lost commit record): the
                    # map never flipped, so the source stays authoritative.
                    # Reap the partial copy buffered on dst — otherwise
                    # each retried move stacks another full tablet copy —
                    # and release the move txn at the oracle (a no-conflict
                    # txn, so a post-commit abort record is still safe: the
                    # tablet's data was never exposed under dst's map).
                    try:
                        arec = json.dumps(
                            {"t": "a", "s": move_st.start_ts,
                             "k": keys_b64},
                            separators=(",", ":")).encode()
                        dst.ingest_records([arec])
                    # dgraph: allow(except-seam) best-effort abort record
                    # on the unwind path; the raise below carries the
                    # real failure
                    except Exception:
                        pass
                    self.zero.oracle.abort(move_st.start_ts)
                    raise
                self.zero.move_tablet(attr, dst_group)
                src.delete_predicate(attr)
                return {"moved_records": sent,
                        "aborted_txns": aborted, "tablet": attr,
                        "src": src_group, "dst": dst_group}
            finally:
                self.zero.unblock_writes(attr)
                src.close()
                dst.close()

    # -- read-only tablet replicas (coord/placement.py drives these) --------

    def install_replica(self, attr: str, dst_group: int) -> dict:
        """Install a read-only copy of a tablet on another group — the
        move protocol's streaming half with neither the map flip nor the
        source delete, and WITHOUT blocking writes (the copy is a snapshot
        cut; later commits reach the holder via delta ships).

        Coverage ordering makes the replica-read gate exact: read_ts is
        taken FIRST, so every commit <= read_ts was assigned before it and
        is <= the oracle's per-tablet floor read afterwards; waiting for
        the source to APPLY up to that floor guarantees the stream at
        read_ts contains them all. The holder commits the copy at read_ts
        — its gate watermark claims exactly what the cut holds."""
        with self._move_lock:
            src_group = self.zero.tablets().get(attr)
            if src_group is None:
                raise MoveError(f"tablet {attr!r} is not served")
            if src_group == dst_group:
                return {"installed_records": 0, "tablet": attr,
                        "noop": "owner"}
            if dst_group in self.zero.replica_holders(attr):
                return {"installed_records": 0, "tablet": attr,
                        "noop": "already a holder"}
            src = self._leader_of(src_group)
            try:
                dst = self._leader_of(dst_group)
            except BaseException:
                src.close()
                raise
            try:
                # clear any ORPHANED copy first: a prior drop_replica may
                # have unregistered the holder but failed the delete
                # (holder unreachable) — streaming over the stale copy
                # would union the two and resurrect deleted edges behind
                # a watermark that claims full freshness. Idempotent on a
                # clean destination.
                dst.delete_predicate(attr)
                read_ts = self.zero.oracle.read_ts()
                target = self.zero.oracle.pred_commit.get(attr, 0)
                deadline = time.monotonic() + 5.0
                while target and time.monotonic() < deadline:
                    applied = json.loads(
                        src.membership().pred_commit_json or "{}")
                    if int(applied.get(attr, 0)) >= target:
                        break
                    time.sleep(0.05)
                else:
                    if target:
                        raise MoveError(
                            f"source never applied commits on {attr!r} up "
                            f"to ts {target}; replica install aborted")
                start_ts = self.zero.oracle.timestamps(1)
                keys_b64: list[str] = []
                sent = ingested = 0
                cursor = b""
                try:
                    import base64

                    while True:
                        faults.fire("move.chunk_ship")
                        resp = src.predicate_data(
                            attr, read_ts, start_ts, after=cursor,
                            max_bytes=self.chunk_bytes)
                        keys_b64.extend(base64.b64encode(bytes(k)).decode()
                                        for k in resp.keys)
                        sent += len(resp.records)
                        if resp.records:
                            ingested += dst.ingest_records(
                                list(resp.records))
                        if resp.done:
                            break
                        cursor = bytes(resp.next)
                    if ingested != sent:
                        raise MoveError(
                            f"replica install handshake failed: sent "
                            f"{sent}, destination ingested {ingested}")
                    crec = json.dumps(
                        {"t": "c", "s": start_ts, "ts": read_ts,
                         "k": keys_b64}, separators=(",", ":")).encode()
                    dst.ingest_records([crec])
                except BaseException:
                    # reap the partial copy; the tablet was never routed
                    # to this holder, so aborting the buffered txn is safe
                    try:
                        arec = json.dumps(
                            {"t": "a", "s": start_ts, "k": keys_b64},
                            separators=(",", ":")).encode()
                        dst.ingest_records([arec])
                    # dgraph: allow(except-seam) best-effort abort record
                    # on the unwind path; the raise below carries the
                    # real failure
                    except Exception:
                        pass
                    raise
                # routing starts ONLY now, with the data fully installed
                self.zero.add_replica(attr, dst_group, read_ts)
                return {"installed_records": sent, "tablet": attr,
                        "src": src_group, "dst": dst_group,
                        "watermark": read_ts}
            finally:
                src.close()
                dst.close()

    def ship_replica_delta(self, attr: str, holder_group: int) -> dict:
        """Freshness ship: pull the owner's O(Δ) journal above the
        holder's watermark as DEL_ALL+rewrite records, apply them on the
        holder, commit at the owner's covered watermark. A journal that
        cannot prove completeness triggers a full re-install."""
        faults.fire("replica.delta_ship")
        holders = self.zero.replica_holders(attr)
        if holder_group not in holders:
            raise MoveError(f"group {holder_group} holds no replica of "
                            f"{attr!r}")
        since = int(holders[holder_group])
        src_group = self.zero.tablets().get(attr)
        if src_group is None or src_group == holder_group:
            raise MoveError(f"tablet {attr!r} has no distinct owner")
        src = self._leader_of(src_group)
        try:
            dst = self._leader_of(holder_group)
        except BaseException:
            src.close()
            raise
        try:
            read_ts = self.zero.oracle.read_ts()
            start_ts = self.zero.oracle.timestamps(1)
            resp = src.tablet_delta(attr, since, read_ts, start_ts)
            watermark = int(resp.watermark)
            if resp.full_resync:
                # journal overflow / bulk install: drop + re-install
                self.drop_replica(attr, holder_group)
                out = self.install_replica(attr, holder_group)
                out["resync"] = True
                return out
            if watermark <= since or not resp.records:
                self.zero.set_replica_watermark(attr, holder_group,
                                                watermark)
                return {"shipped_records": 0, "tablet": attr,
                        "watermark": max(watermark, since)}
            import base64

            keys_b64 = [base64.b64encode(bytes(k)).decode()
                        for k in resp.keys]
            try:
                dst.ingest_records(list(resp.records))
                crec = json.dumps(
                    {"t": "c", "s": start_ts, "ts": watermark,
                     "k": keys_b64}, separators=(",", ":")).encode()
                dst.ingest_records([crec])
            except BaseException:
                # reap the buffered rewrite txn: a failure between the
                # record ship and the commit record would otherwise leave
                # uncommitted layers at start_ts on the holder forever
                # (nothing else ever decides that ts)
                try:
                    arec = json.dumps(
                        {"t": "a", "s": start_ts, "k": keys_b64},
                        separators=(",", ":")).encode()
                    dst.ingest_records([arec])
                # dgraph: allow(except-seam) best-effort abort record on
                # the unwind path; the raise below carries the real one
                except Exception:
                    pass
                raise
            self.zero.set_replica_watermark(attr, holder_group, watermark)
            return {"shipped_records": len(resp.records), "tablet": attr,
                    "keys": len(resp.keys), "watermark": watermark}
        finally:
            src.close()
            dst.close()

    def drop_replica(self, attr: str, holder_group: int) -> bool:
        """Demote a replica: unregister from the map FIRST (routing stops;
        in-flight reads are covered by the holder's serve-time existence
        check), then delete the copy at the holder."""
        if not self.zero.drop_replica(attr, holder_group):
            return False
        try:
            rw = self._leader_of(holder_group)
            try:
                rw.delete_predicate(attr)
            finally:
                rw.close()
        # dgraph: allow(except-seam) holder unreachable: the data is
        # orphaned but unrouted; a later install starts from delete
        except Exception:
            pass
        return True

    def rebalance_once(self) -> dict | None:
        """One tick: size reports from every group's leader feed the shared
        decision (coord/zero.choose_rebalance_move), then move_tablet."""
        from .zero import choose_rebalance_move

        sizes: dict[int, dict[str, int]] = {}
        with self.svc._lock:
            groups = list(self.svc._members)
        for g in groups:
            try:
                rw = self._leader_of(g)
            except MoveError:
                continue
            try:
                sizes[g] = {a: int(s) for a, s in json.loads(
                    rw.status().tablet_sizes_json or "{}").items()}
            finally:
                rw.close()
        # replicated tablets are the load controller's responsibility —
        # their copies also inflate holder sizes, which would mislead the
        # size-only decision
        pick = choose_rebalance_move(
            sizes, blocked=self.zero.moving_tablets()
            | set(self.zero.replicas()))
        if pick is None:
            return None
        attr, _src, dst, sz = pick
        out = self.move_tablet(attr, dst)
        out["bytes"] = sz
        return out

    def remove_node(self, group: int, addr: str) -> bool:
        """Drop a member from the membership registry (zero /removeNode,
        http.go:38-128); its replicas stop being move/leader candidates."""
        with self.svc._lock:
            members = self.svc._members.get(group, [])
            if addr in members:
                members.remove(addr)
                return True
        return False


def fleet_scrape(svc: ZeroService) -> dict:
    """Poll every registered worker's Status for its shipped metric
    snapshot (StatusResponse.metrics_json — the same probe that carries
    the placement load reports) and return
    {"nodes": {addr: export}, "merged": merged, "unreachable": [...]}.
    Histograms merge exactly (fixed buckets, utils/metrics.merge_exports);
    counters and keyed gauges sum."""
    from concurrent import futures as _futures

    from ..parallel.remote import RemoteWorker
    from ..utils.metrics import merge_exports

    with svc._lock:
        addrs = sorted({a for addrs in svc._members.values()
                        for a in addrs})

    def poll(a: str):
        rw = RemoteWorker(a)
        try:
            st = rw.status(timeout=2.0)
            return a, json.loads(st.metrics_json or "{}")
        except Exception:
            return a, None               # RPC failed: truly unreachable
        finally:
            rw.close()

    nodes: dict[str, dict] = {}
    unreachable: list[str] = []
    if addrs:
        # concurrent polls: a partially-down fleet must not push the
        # scrape past Prometheus's timeout (serial 2s-per-dead-worker
        # would — and a down fleet is exactly when the view matters)
        with _futures.ThreadPoolExecutor(
                max_workers=min(len(addrs), 16)) as pool:
            for a, snap in pool.map(poll, addrs):
                if snap is None:
                    unreachable.append(a)
                elif snap:
                    nodes[a] = snap
                # else: reachable but no snapshot shipped (older binary
                # mid rolling upgrade) — NOT unreachable, just absent
    return {"nodes": nodes,
            "merged": merge_exports(list(nodes.values())),
            "unreachable": unreachable}


def serve_zero_http(svc: ZeroService, ops: ZeroOps, host: str = "127.0.0.1",
                    port: int = 0, controller=None):
    """Zero's ops HTTP endpoints (dgraph/cmd/zero/http.go:38-130):
    GET /state, GET /moveTablet?tablet=X&group=N,
    GET /removeNode?group=N&addr=A, plus the placement surface —
    GET /placement (controller decision log + load book + config),
    GET /addReplica?tablet=X&group=N, GET /dropReplica?tablet=X&group=N,
    GET /shipReplica?tablet=X&group=N — and the fleet metrics surface:
    GET /metrics/fleet (one Prometheus exposition summing/
    merging every worker's scrape — histograms merge exactly because
    buckets are fixed) and GET /debug/fleet (the per-node + merged JSON).
    Returns (server, bound_port)."""
    import http.server
    import urllib.parse

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):     # noqa: N802 — quiet
            pass

        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):              # noqa: N802 — http.server API
            u = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(u.query)
            try:
                if u.path == "/state":
                    self._reply(200, json.loads(svc.state(
                        ipb.ZeroStateRequest(), None).state_json))
                elif u.path == "/moveTablet":
                    out = ops.move_tablet(q["tablet"][0],
                                          int(q["group"][0]))
                    self._reply(200, out)
                elif u.path == "/removeNode":
                    ok = ops.remove_node(int(q["group"][0]), q["addr"][0])
                    self._reply(200 if ok else 404, {"removed": ok})
                elif u.path == "/addReplica":
                    self._reply(200, ops.install_replica(
                        q["tablet"][0], int(q["group"][0])))
                elif u.path == "/dropReplica":
                    ok = ops.drop_replica(q["tablet"][0],
                                          int(q["group"][0]))
                    self._reply(200 if ok else 404, {"dropped": ok})
                elif u.path == "/shipReplica":
                    self._reply(200, ops.ship_replica_delta(
                        q["tablet"][0], int(q["group"][0])))
                elif u.path == "/metrics/fleet":
                    from ..obs import prom as _prom

                    merged = fleet_scrape(svc)["merged"]
                    body, ctype = _prom.negotiated(
                        self.headers.get("Accept"),
                        lambda ex: _prom.render_export(merged,
                                                       exemplars=ex))
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/debug/fleet":
                    self._reply(200, fleet_scrape(svc))
                elif u.path == "/placement":
                    if controller is None:
                        self._reply(200, {"enabled": False,
                                          "replicaMap": {
                                              a: sorted(gs) for a, gs in
                                              ops.zero.replicas().items()}})
                    else:
                        self._reply(200, controller.snapshot())
                else:
                    self._reply(404, {"error": f"unknown path {u.path}"})
            except Exception as e:      # noqa: BLE001 — ops surface
                self._reply(500, {"error": str(e)})

    httpd = http.server.ThreadingHTTPServer((host, port), Handler)
    # dgraph: allow(ctxvar-copy) ops-HTTP accept loop: requests root
    # their own context at the handler
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def serve_zero(zero: Zero, addr: str = "localhost:0", max_workers: int = 8,
               svc: "ZeroService | None" = None):
    """Start the Zero gRPC server; returns (server, bound_port, service).
    Pass a pre-built svc when a ZeroReplica must be attached before the
    handler map is registered (multi-zero mode)."""
    svc = svc if svc is not None else ZeroService(zero)
    from ..parallel.remote import GRPC_OPTIONS

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         options=GRPC_OPTIONS)
    server.add_generic_rpc_handlers((svc.handler(),))
    port = server.add_insecure_port(addr)
    if port == 0:
        raise Unavailable(f"could not bind zero listener on {addr}")
    server.start()
    return server, port, svc


class ZeroClient:
    """Client stub for a remote Zero — mirrors the library surface the
    dispatcher and write path consume (tablets/should_serve/oracle calls).

    Accepts a comma-separated list of zero addresses (multi-zero): a call
    that hits a dead zero or a standby (FAILED_PRECONDITION "not zero
    leader") rotates to the next address and retries, so failover is
    transparent to workers and clients."""

    _STUBS = {
        "_connect": ("Connect", ipb.ZeroConnectRequest,
                     ipb.ZeroConnectResponse),
        "_new_txn": ("NewTxn", ipb.ZeroLeaseRequest, ipb.ZeroLeaseResponse),
        "_timestamps": ("Timestamps", ipb.ZeroLeaseRequest,
                        ipb.ZeroLeaseResponse),
        "_assign_uids": ("AssignUids", ipb.ZeroLeaseRequest,
                         ipb.ZeroLeaseResponse),
        "_commit": ("CommitOrAbort", ipb.ZeroCommitRequest,
                    ipb.ZeroCommitResponse),
        "_should_serve": ("ShouldServe", ipb.ZeroTabletRequest,
                          ipb.ZeroTabletResponse),
        "_state": ("State", ipb.ZeroStateRequest, ipb.ZeroStateResponse),
        "_zero_ship": ("ZeroShip", ipb.ZeroShipRequest,
                       ipb.ZeroShipResponse),
        "_zero_vote": ("ZeroVote", ipb.ZeroVoteRequest,
                       ipb.ZeroVoteResponse),
        "_zero_ping": ("ZeroPing", ipb.ZeroPingRequest,
                       ipb.ZeroPingResponse),
    }

    def __init__(self, addr: str | list[str]) -> None:
        self.addrs = ([a.strip() for a in addr.split(",") if a.strip()]
                      if isinstance(addr, str) else list(addr))
        self._i = 0
        self.channel = None
        self._open(self.addrs[0])

    @property
    def addr(self) -> str:
        return self.addrs[self._i]

    def _open(self, addr: str) -> None:
        from ..parallel.remote import GRPC_OPTIONS

        if self.channel is not None:
            self.channel.close()
        self.channel = grpc.insecure_channel(addr, options=GRPC_OPTIONS)
        for attr, (name, req_cls, resp_cls) in self._STUBS.items():
            setattr(self, attr, self.channel.unary_unary(
                f"/{SERVICE}/{name}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString))

    def _rotate(self) -> None:
        self._i = (self._i + 1) % len(self.addrs)
        self._open(self.addrs[self._i])

    def _rpc(self, stub_name: str, req, timeout: float = 10.0):
        """Issue an RPC with leader failover: dead zero / standby rejection
        rotates to the next address (2 passes over the ring). When a trace
        is active, the call runs under a client span and propagates the
        span context to Zero (its server span rides back in trailing
        metadata), so coordinator hops show in the query's trace."""
        sp = otrace.current()
        if sp is None:
            return self._rpc_raw(stub_name, req, timeout, None)
        with sp.tracer.start(f"zero:{self._STUBS[stub_name][0]}", parent=sp,
                             kind="client",
                             attrs={"addr": self.addr}) as rsp:
            return self._rpc_raw(stub_name, req, timeout, rsp)

    def _rpc_raw(self, stub_name: str, req, timeout: float, rsp):
        import random as _random

        last = None
        for attempt in range(max(2 * len(self.addrs), 1)):
            # budgeted callers never start an attempt past their deadline
            # — a pre-send check is unambiguous (nothing went out)
            dl.check(f"zero:{self._STUBS[stub_name][0]}")
            faults.fire("zero.rpc")
            try:
                stub = getattr(self, stub_name)
                call_timeout = dl.clamp(timeout)
                if call_timeout <= 0:
                    # budget hit zero between the check above and here:
                    # a pre-send raise is unambiguous (nothing went out),
                    # unlike falling back to the full unclamped timeout
                    raise DeadlineExceeded(
                        f"zero:{self._STUBS[stub_name][0]} budget "
                        "exhausted before send")
                md = []
                ddl = dl.to_metadata()
                if ddl is not None:
                    md.append(ddl)
                if rsp is None:
                    if not md:
                        return stub(req, timeout=call_timeout)
                    return stub(req, timeout=call_timeout,
                                metadata=tuple(md))
                md.append((otrace.WIRE_KEY,
                           f"{rsp.trace_id}:{rsp.span_id}"))
                resp, call = stub.with_call(
                    req, timeout=call_timeout, metadata=tuple(md))
                for k, v in call.trailing_metadata() or ():
                    if k == otrace.SPANS_KEY:
                        rsp.tracer.add_remote(otrace.decode_spans(v))
                return resp
            except grpc.RpcError as e:
                code = e.code()
                # explicit DEADLINE_EXCEEDED handling: an in-flight
                # timeout is ambiguous — re-firing a CommitOrAbort or
                # AssignUids that DID land would corrupt txn/lease state —
                # so it surfaces, typed, with NO rotation retry.
                if code == grpc.StatusCode.DEADLINE_EXCEEDED:
                    raise DeadlineExceeded(
                        f"zero:{self._STUBS[stub_name][0]} deadline "
                        f"exceeded at {self.addr}") from e
                # rotate only on signals that the call was NOT processed
                # (dead zero / standby rejection), with full-jitter
                # backoff between attempts so a thundering herd of
                # clients doesn't re-dogpile the surviving zero in step
                if len(self.addrs) > 1 and code in (
                        grpc.StatusCode.UNAVAILABLE,
                        grpc.StatusCode.FAILED_PRECONDITION):
                    last = e
                    self._rotate()
                    pause = backoff_s(attempt, base_s=0.05, cap_s=0.5,
                                      rng=_random)
                    rem = dl.remaining()
                    if rem is not None and pause >= rem:
                        raise      # sleeping would blow the budget
                    time.sleep(pause)
                    continue
                raise
        raise last

    def connect(self, addr: str, group: int = -1) -> tuple[int, int]:
        r = self._rpc("_connect", ipb.ZeroConnectRequest(addr=addr,
                                                         group=group))
        return r.group, r.replica_id

    def new_txn(self) -> int:
        return self._rpc("_new_txn", ipb.ZeroLeaseRequest(n=1)).first

    def timestamps(self, n: int = 1) -> int:
        return self._rpc("_timestamps", ipb.ZeroLeaseRequest(n=n)).first

    def assign_uids(self, n: int) -> int:
        return self._rpc("_assign_uids", ipb.ZeroLeaseRequest(n=n)).first

    def commit(self, start_ts: int, conflict_keys, preds) -> int:
        """Returns commit_ts; raises TxnConflict on SSI abort."""
        r = self._rpc("_commit", ipb.ZeroCommitRequest(
            start_ts=start_ts, conflict_keys=list(conflict_keys),
            preds=sorted(preds)))
        if r.aborted:
            raise TxnConflict(f"txn {start_ts} aborted by oracle")
        return r.commit_ts

    def abort(self, start_ts: int) -> None:
        self._rpc("_commit",
                  ipb.ZeroCommitRequest(start_ts=start_ts, abort=True))

    def should_serve(self, attr: str) -> int:
        return self._rpc("_should_serve",
                         ipb.ZeroTabletRequest(attr=attr)).group

    def tablets(self) -> dict[str, int]:
        return {a: g for a, g in self.state().get("tabletMap", {}).items()}

    def state(self) -> dict:
        return json.loads(
            self._rpc("_state", ipb.ZeroStateRequest()).state_json)

    # -- multi-zero replication RPCs (leader <-> standby, no rotation) -------

    def zero_ship(self, term: int, seq: int, state_json: str,
                  members_json: str = "") -> ipb.ZeroShipResponse:
        return self._zero_ship(ipb.ZeroShipRequest(
            term=term, seq=seq, state_json=state_json,
            members_json=members_json), timeout=3.0)

    def zero_vote(self, term: int, seq: int,
                  candidate: str) -> ipb.ZeroVoteResponse:
        return self._zero_vote(ipb.ZeroVoteRequest(
            term=term, seq=seq, candidate=candidate), timeout=1.5)

    def zero_ping(self, term: int, leader_addr: str,
                  members: list[str]) -> ipb.ZeroPingResponse:
        return self._zero_ping(ipb.ZeroPingRequest(
            term=term, leader_addr=leader_addr, members=members),
            timeout=1.5)

    # move fences are server-side in this topology
    def writes_blocked(self, _attr: str) -> bool:
        return False

    def moving_tablets(self) -> set:
        return set()

    def close(self) -> None:
        self.channel.close()
