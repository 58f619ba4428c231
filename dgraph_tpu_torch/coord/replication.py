"""Replication: WAL shipping to a replica quorum with leader failover.

Port of dgraph_tpu/coord/replication.py; the leader Node and the
follower readers fold onto the group's `device` ("cuda" unless given).

Reference semantics (the contract, not the transport):
  - worker/draft.go:190 proposeAndWait — a mutation is acked only after the
    Raft quorum has the entry; :485-624 Run loop stores entries before
    applying them.
  - conn/node.go:47-105 — replica membership and health; CheckQuorum.
  - raftwal/wal.go:31 — the per-replica durable log replayed on restart.
  - worker/draft.go:452 retrieveSnapshot — a lagging follower catches up by
    full snapshot + log tail from the leader.

TPU-era redesign: replicas are posting-store directories; the data plane
needing consensus is ONLY the WAL byte stream (device snapshots rebuild from
it deterministically), so replication is synchronous record shipping — every
WAL record fsyncs on a majority of live replicas before the leader's own
append proceeds. Failover promotes the live replica with the longest log
(Raft's up-to-date rule) by opening a Node on its directory — the normal
crash-recovery path — and fences the old term via a per-replica term file.

In-process today (one ReplicaGroup object owns the member dirs — the
embedded single-process cluster mode of SURVEY.md §4); the record stream is
already the wire format a gRPC/DCN transport would carry.
"""

from __future__ import annotations

import contextvars
import os
import struct
import threading

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.query import dql
from dgraph_tpu_torch.query.engine import Executor
from dgraph_tpu_torch.storage.store import Store, decode_record
from dgraph_tpu_torch.utils.watermark import WaterMark

_U32 = struct.Struct("<I")


class NoQuorum(Exception):
    """Fewer than a majority of replicas are alive and acking."""


class StaleLeader(Exception):
    """A deposed leader tried to ship records (term fencing)."""


class _Member:
    """One replica: a directory with wal.log (+ snapshot) and a term file."""

    def __init__(self, member_id: int, dirpath: str) -> None:
        self.id = member_id
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.alive = True
        self.reader: "FollowerReader | None" = None
        self._wal = None

    # -- term fencing --------------------------------------------------------

    @property
    def term(self) -> int:
        try:
            with open(os.path.join(self.dir, "TERM")) as f:
                return int(f.read().strip() or 0)
        except FileNotFoundError:
            return 0

    def set_term(self, term: int) -> None:
        with open(os.path.join(self.dir, "TERM"), "w") as f:
            f.write(str(term))

    # -- log append (the follower side of the ship) --------------------------

    def append(self, data: bytes, sync: bool) -> None:
        if self._wal is None:
            self._wal = open(os.path.join(self.dir, "wal.log"), "ab")
        self._wal.write(_U32.pack(len(data)) + data)
        if sync:
            self._wal.flush()
            os.fsync(self._wal.fileno())

    def close(self) -> None:
        if self._wal is not None:
            self._wal.flush()
            self._wal.close()
            self._wal = None

    def wal_len(self) -> int:
        try:
            return os.path.getsize(os.path.join(self.dir, "wal.log"))
        except FileNotFoundError:
            return 0


class FollowerReader:
    """A read replica: an in-memory Store that live-applies shipped WAL
    records, serving (slightly stale) snapshot reads for hedging
    (worker/draft.go applies committed entries to follower state the same
    way; worker/task.go:75-132 reads from it on backup requests)."""

    def __init__(self, dirpath: str | None = None,
                 device: str = "cuda") -> None:
        self.device = resolve_device(device)
        # memory-only going forward: the member's file WAL is the durability
        # story, the reader just mirrors state. An existing replica dir seeds
        # the mirror (rejoin / restart), then the file handles detach so the
        # member's own appends stay the only writer.
        if dirpath and (os.path.exists(os.path.join(dirpath, "snapshot.bin"))
                        or os.path.exists(os.path.join(dirpath, "wal.log"))):
            s = Store(dirpath)
            if s._wal is not None:
                s._wal.close()
                s._wal = None
            s.dir = None
            self.store = s
        else:
            self.store = Store()
        self._lock = threading.Lock()
        # incremental per-predicate snapshot reuse: a commit
        # touching one predicate re-folds one predicate on this follower
        from dgraph_tpu_torch.storage.csr_build import (STRUCTURAL_RECORDS,
                                                        SnapshotAssembler)

        self._assembler = SnapshotAssembler(self.store, device=self.device)
        self._structural = STRUCTURAL_RECORDS
        self._read_lock = threading.Lock()
        self._version = 0
        # applied watermark: record index n is done once apply(n) returns;
        # wait_for_mark(n) = "this reader reflects the first n records"
        # (x/watermark.go applied-watermark contract)
        self.applied = WaterMark("applied")

    def apply(self, data: bytes) -> None:
        with self._lock:
            idx = self._version + 1
            self.applied.begin(idx)
            try:
                rec = decode_record(data)
                self.store.apply_record(rec)
                if rec.get("t") in self._structural:
                    # schema/drop records change structure beyond the
                    # per-predicate commit watermark the assembler keys on.
                    # Serialize with in-flight assembly (_read_lock): an
                    # invalidate landing mid-assemble would otherwise be
                    # overwritten by the pre-drop entries being cached.
                    with self._read_lock:
                        self._assembler.invalidate()
            finally:
                self._version = idx
                self.applied.done(idx)

    def query(self, q: str, variables: dict | None = None) -> dict:
        # capture ts under the apply lock, assemble OUTSIDE it: the leader's
        # synchronous ship path blocks on that lock, so holding it across a
        # fold would stall every commit. Assembly at read_ts = ts is torn-
        # proof (visibility is commit_ts <= read_ts, and a concurrent apply
        # lands at a ts the fold excludes); per-predicate reuse means only
        # predicates committed since the last read are re-folded.
        with self._lock:
            ts = self.store.max_seen_commit_ts
        with self._read_lock:
            snap = self._assembler.snapshot(ts)
        return Executor(snap, self.store.schema).execute(
            dql.parse(q, variables))


class ReplicaGroup:
    """A leader Node plus follower replicas with synchronous quorum shipping."""

    def __init__(self, base_dir: str, n: int = 3,
                 serve_reads: bool = False, device: str = "cuda") -> None:
        if n < 1:
            raise ValueError("need n >= 1 replicas")
        # the leader Node and the follower readers fold onto this device
        self.device = resolve_device(device)
        self.n = n
        self.term = 1
        self.serve_reads = serve_reads
        self.members = [_Member(i, os.path.join(base_dir, f"replica{i}"))
                        for i in range(n)]
        for m in self.members:
            m.set_term(self.term)
        self.leader_id = 0
        self.hedged_reads = 0
        # fault injection hook (test/ops surface): called per (member,
        # record) before a follower append; raising simulates a transport
        # fault for that member — it stops counting toward the quorum.
        # Reference analog: conn/pool Echo health failures.
        self.fault_hook = None
        if serve_reads:
            for m in self._followers_of(0):
                m.reader = FollowerReader(m.dir, device=self.device)
        self.node: Node = self._open_leader()

    # -- leadership ----------------------------------------------------------

    @property
    def quorum(self) -> int:
        return self.n // 2 + 1

    def _followers(self) -> list[_Member]:
        return self._followers_of(self.leader_id)

    def _followers_of(self, leader_id: int) -> list[_Member]:
        return [m for m in self.members if m.id != leader_id]

    def _open_leader(self) -> Node:
        node = Node(self.members[self.leader_id].dir, device=self.device)
        node.store.wal_sink = self._ship
        return node

    def _ship(self, data: bytes, sync: bool) -> None:
        """Deliver one WAL record to followers; ack needs a quorum counting
        the leader itself (proposeAndWait's commit wait).

        Quorum feasibility and term fencing are checked for EVERY live
        follower before any append, so a rejected ship leaves no follower
        holding a record the leader never wrote. A member whose transport
        faults (fault_hook raising) is marked dead — the failure-detection
        path — and the quorum re-checked before anything is appended. Term
        fencing runs FIRST, over every live member: a higher-term member
        deposes this leader even if its transport is currently faulty."""
        live = [m for m in self._followers() if m.alive]
        for m in live:
            if m.term > self.term:
                raise StaleLeader(
                    f"member {m.id} is at term {m.term} > {self.term}")
        if self.fault_hook is not None:
            for m in list(live):
                try:
                    self.fault_hook(m, data)
                except Exception:
                    m.alive = False      # detected failure: stop counting it
                    m.close()
                    live.remove(m)
        if len(live) + 1 < self.quorum:
            raise NoQuorum(
                f"{len(live) + 1}/{self.n} acks < quorum {self.quorum}")
        for m in live:
            m.append(data, sync)
            if m.reader is not None:
                m.reader.apply(data)

    # -- hedged reads --------------------------------------------------------

    def read(self, q: str, variables: dict | None = None,
             hedge_after: float = 0.05) -> tuple[str, dict]:
        """Backup-request read (worker/task.go:75-132): ask the leader; when
        it hasn't answered within hedge_after seconds — or is dead — race a
        live follower reader; the first answer wins. Returns
        ("leader" | "followerN", result). Follower answers reflect the
        quorum-acked prefix (read-your-quorum, possibly a beat behind the
        leader's unacked tail — the same staleness contract as the
        reference's best-effort backup reads)."""
        result: list[tuple[str, dict]] = []
        errs: list[Exception] = []
        done = threading.Event()
        leader = self.members[self.leader_id]
        leader_asked = leader.alive
        if leader.alive:
            def from_leader():
                try:
                    out, _ = self.node.query(q, variables)
                    result.append(("leader", out))
                except Exception as e:   # noqa: BLE001 — raced result decides
                    errs.append(e)
                finally:
                    done.set()
            # copy context so the leader read carries the caller's
            # deadline/trace/cost contextvars across the thread seam
            ctx = contextvars.copy_context()
            threading.Thread(target=ctx.run, args=(from_leader,),
                             daemon=True).start()
            done.wait(dl.clamp(hedge_after))
            if result:
                return result[0]
        self.hedged_reads += 1
        for m in self._followers():
            if m.alive and m.reader is not None:
                out = m.reader.query(q, variables)
                return result[0] if result else (f"follower{m.id}", out)
        if not leader_asked:
            # dead leader AND no follower reader: nothing will ever answer
            raise NoQuorum("no live member can serve reads")
        # no follower reader available: block on the leader after all —
        # clamped to the caller's budget (typed, never a hang)
        if not done.wait(dl.clamp(None)):
            dl.check("quorum read: leader reply")
        if result:
            return result[0]
        raise errs[0] if errs else NoQuorum("no live member can serve reads")

    # -- failures ------------------------------------------------------------

    def kill(self, member_id: int) -> None:
        """Crash a member. Killing the leader triggers failover to the live
        member with the longest log (Raft's up-to-date election rule)."""
        m = self.members[member_id]
        m.alive = False
        m.close()
        if member_id != self.leader_id:
            return
        self.node.close()
        live = [x for x in self.members if x.alive]
        if len(live) < self.quorum:
            raise NoQuorum(
                f"{len(live)} live members cannot form quorum {self.quorum}")
        new_leader = max(live, key=lambda x: (x.wal_len(), -x.id))
        self.term += 1
        for x in live:
            x.set_term(self.term)
        self.leader_id = new_leader.id
        new_leader.close()
        new_leader.reader = None      # leaders serve reads directly
        self.node = self._open_leader()

    def rejoin(self, member_id: int) -> None:
        """Bring a dead member back via snapshot + WAL tail from the leader
        (retrieveSnapshot / populateShard analog)."""
        m = self.members[member_id]
        if member_id == self.leader_id:
            raise ValueError("leader cannot rejoin itself")
        # fold the leader's log so the copy is compact, then clone state
        # (clone_to flushes + copies under the store lock, so no concurrent
        # commit can land half-shipped in the copy window)
        self.node.store.checkpoint(self.node.store.max_seen_commit_ts)
        m.close()
        self.node.store.clone_to(m.dir)
        m.set_term(self.term)
        m.alive = True
        if self.serve_reads:
            m.reader = FollowerReader(m.dir, device=self.device)   # reseed

    def close(self) -> None:
        self.node.close()
        for m in self.members:
            m.close()
