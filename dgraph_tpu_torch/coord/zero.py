"""Zero-analog cluster coordinator: timestamps, UID leases, txn oracle, tablets.

Copy of dgraph_tpu/coord/zero.py for the PyTorch port.

Reference semantics (dgraph/cmd/zero/):
  - oracle.go:71-83 hasConflict — SSI write-conflict detection: a txn aborts
    if any of its conflict-key fingerprints was committed by a txn with
    commit_ts > this txn's start_ts.
  - oracle.go:276-320 commit — assign commitTs, update per-key max-commit-ts,
    stream the decision to groups.
  - assign.go:65-125 — UID and timestamp block leases (10k chunks), handed to
    servers/loaders on demand.
  - zero.go:436 ShouldServe / tablet.go — predicate → group ("tablet")
    assignment.

Redesign: the reference runs this as a separate Raft-replicated process
reached over gRPC. Here it is an in-process object (the embedded
single-process cluster mode the reference's own tests use, SURVEY.md §4);
the distribution layer (parallel/) consults the same tablet map to place
predicates on mesh device groups. All logic is host-side and device-free.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field


class TxnConflict(Exception):
    """SSI write-conflict: another txn committed one of our keys after our
    start_ts (reference oracle.go:71 hasConflict → Code aborted)."""


class TxnNotFound(Exception):
    pass


def fingerprint(key_bytes: bytes) -> int:
    """Conflict-key fingerprint (reference x.Fingerprint / farmhash)."""
    return int.from_bytes(
        hashlib.blake2b(key_bytes, digest_size=8).digest(), "big")


@dataclass
class TxnState:
    start_ts: int
    keys: set[int] = field(default_factory=set)   # conflict fingerprints
    preds: set[str] = field(default_factory=set)  # touched predicates


LEASE_BLOCK = 10_000  # reference assign.go leaseBankSize


class Oracle:
    """SSI transaction oracle (reference dgraph/cmd/zero/oracle.go).

    Timestamps are a single monotonic sequence shared by reads and commits;
    max_commit_ts per conflict key implements first-committer-wins snapshot
    isolation. `max_applied` tracks the highest ts whose commit decision has
    been applied to the store — reads wait below it (the WaitForTs analog;
    in-process application is synchronous so it equals max_assigned here).
    """

    PURGE_EVERY = 256  # commit/abort decisions between watermark purges

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # durability hook: called UNDER _lock whenever max_assigned crosses
        # the current lease ceiling, BEFORE the triggering ts is returned —
        # a caller never receives a timestamp the new ceiling doesn't
        # durably cover (assign.go lease-block semantics). Covers every
        # mutator (timestamps/new_txn/commit) by construction.
        self.on_lease = None
        self._ceiling = 0
        self._next_ts = 1
        self._key_commit: dict[int, int] = {}     # fingerprint -> max commit_ts
        self._pending: dict[int, TxnState] = {}   # start_ts -> state
        self._aborted: set[int] = set()
        # attr -> highest commit_ts ASSIGNED to a txn touching it: tablet
        # moves wait for the owner to APPLY up to this before streaming
        # (a Decide RPC still in flight must not be left behind)
        self.pred_commit: dict[str, int] = {}
        self.max_assigned = 0
        self._decisions = 0                       # purge cadence counter

    def _bump_ceiling_locked(self) -> None:
        if self.on_lease is not None and self.max_assigned >= self._ceiling:
            self._ceiling = self.max_assigned + LEASE_BLOCK
            self.on_lease(self._ceiling)

    def _purge_below_locked(self) -> None:
        """Drop conflict/abort state no live or future txn can observe
        (reference oracle.go purgeBelow at the MinTs watermark :112-160).

        A _key_commit entry with ts <= every pending txn's start_ts can never
        trigger _has_conflict (future txns get start_ts > max_assigned >= ts).
        """
        watermark = min(self._pending, default=self.max_assigned + 1)
        self._key_commit = {fp: ts for fp, ts in self._key_commit.items()
                            if ts > watermark}
        self._aborted = {ts for ts in self._aborted if ts >= watermark}

    # -- timestamps ----------------------------------------------------------

    def timestamps(self, n: int = 1) -> int:
        """Lease n timestamps; returns the first (reference assign.go:127)."""
        with self._lock:
            ts = self._next_ts
            self._next_ts += n
            self.max_assigned = self._next_ts - 1
            self._bump_ceiling_locked()
            return ts

    def new_txn(self) -> TxnState:
        with self._lock:
            ts = self._next_ts
            self._next_ts += 1
            self.max_assigned = self._next_ts - 1
            self._bump_ceiling_locked()
            st = TxnState(ts)
            self._pending[ts] = st
            return st

    def pending_on(self, attr: str) -> list[int]:
        """start_ts of open txns that touched a predicate (the TryAbort
        candidates when that tablet moves; zero.go:436 + predicate_move)."""
        with self._lock:
            return [ts for ts, st in self._pending.items()
                    if attr in st.preds]

    def min_pending(self) -> int | None:
        """Smallest open txn start_ts (the MinTs watermark feeding rollup and
        conflict GC; reference oracle.go MinTs)."""
        with self._lock:
            return min(self._pending) if self._pending else None

    def read_ts(self) -> int:
        """Snapshot ts for a fresh read-only query: everything committed so
        far is visible (max assigned; application is synchronous here)."""
        with self._lock:
            return self.max_assigned

    # -- conflict tracking ---------------------------------------------------

    def track(self, start_ts: int, key_bytes_list: list[bytes],
              preds: list[str] = ()) -> None:
        """Record conflict keys touched by a txn (TxnContext.Keys, mvcc.go:222)."""
        with self._lock:
            st = self._pending.get(start_ts)
            if st is None:
                # decided (committed/aborted/purged) or never-issued ts:
                # recreating it would resurrect a finished txn, or register
                # one whose start_ts the sequence hasn't reached
                if start_ts in self._aborted:
                    raise TxnNotFound(f"txn {start_ts} was aborted")
                raise TxnNotFound(f"txn {start_ts} is not pending")
            st.keys.update(fingerprint(kb) for kb in key_bytes_list)
            st.preds.update(preds)

    def _has_conflict(self, st: TxnState) -> bool:
        return any(self._key_commit.get(fp, 0) > st.start_ts for fp in st.keys)

    # -- commit / abort ------------------------------------------------------

    def commit(self, start_ts: int) -> int:
        """Assign a commit ts if conflict-free, else abort (oracle.go:276).

        Returns commit_ts. Raises TxnConflict (txn is aborted server-side,
        like the reference's ABORTED TxnContext) on an SSI conflict.
        """
        with self._lock:
            st = self._pending.get(start_ts)
            if st is None:
                if start_ts in self._aborted:
                    raise TxnConflict(f"txn {start_ts} already aborted")
                raise TxnNotFound(f"unknown txn {start_ts}")
            if self._has_conflict(st):
                del self._pending[start_ts]
                self._aborted.add(start_ts)
                raise TxnConflict(
                    f"txn {start_ts} conflicts on a key committed after it")
            commit_ts = self._next_ts
            self._next_ts += 1
            self.max_assigned = self._next_ts - 1
            self._bump_ceiling_locked()
            for fp in st.keys:
                prev = self._key_commit.get(fp, 0)
                if commit_ts > prev:
                    self._key_commit[fp] = commit_ts
            for pred in st.preds:
                if commit_ts > self.pred_commit.get(pred, 0):
                    self.pred_commit[pred] = commit_ts
            del self._pending[start_ts]
            self._decisions += 1
            if self._decisions % self.PURGE_EVERY == 0:
                self._purge_below_locked()
            return commit_ts

    def commit_batch(self, start_ts_list: list[int]) -> list:
        """One commit window's decisions under ONE lock hold (the group-
        commit conflict pass): per member, exactly commit()'s
        logic — conflict check against _key_commit, commit_ts assignment,
        key/pred watermark updates. Returns a per-member list of either the
        assigned commit_ts (int) or the exception INSTANCE (TxnConflict /
        TxnNotFound) that member's solo commit() would have raised; the
        caller demuxes. Intra-window conflicts resolve first-committer-wins
        naturally: an earlier member's _key_commit update aborts a later
        member of the same window that shares a key."""
        out: list = []
        with self._lock:
            d0 = self._decisions
            for start_ts in start_ts_list:
                st = self._pending.get(start_ts)
                if st is None:
                    if start_ts in self._aborted:
                        out.append(TxnConflict(
                            f"txn {start_ts} already aborted"))
                    else:
                        out.append(TxnNotFound(f"unknown txn {start_ts}"))
                    continue
                if self._has_conflict(st):
                    del self._pending[start_ts]
                    self._aborted.add(start_ts)
                    self._decisions += 1
                    out.append(TxnConflict(
                        f"txn {start_ts} conflicts on a key committed "
                        f"after it"))
                    continue
                commit_ts = self._next_ts
                self._next_ts += 1
                self.max_assigned = self._next_ts - 1
                self._bump_ceiling_locked()
                for fp in st.keys:
                    if commit_ts > self._key_commit.get(fp, 0):
                        self._key_commit[fp] = commit_ts
                for pred in st.preds:
                    if commit_ts > self.pred_commit.get(pred, 0):
                        self.pred_commit[pred] = commit_ts
                del self._pending[start_ts]
                self._decisions += 1
                out.append(commit_ts)
            if self._decisions // self.PURGE_EVERY > d0 // self.PURGE_EVERY:
                self._purge_below_locked()
        return out

    def abort(self, start_ts: int) -> None:
        with self._lock:
            self._pending.pop(start_ts, None)
            self._aborted.add(start_ts)
            self._decisions += 1
            if self._decisions % self.PURGE_EVERY == 0:
                self._purge_below_locked()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)


class UidLease:
    """Monotonic UID allocator handing out blocks (reference assign.go:65)."""

    def __init__(self, start: int = 1) -> None:
        self._lock = threading.Lock()
        self.on_lease = None       # same contract as Oracle.on_lease
        self._ceiling = 0
        self._next = start

    def _bump_ceiling_locked(self) -> None:
        if self.on_lease is not None and self._next - 1 >= self._ceiling:
            self._ceiling = self._next - 1 + LEASE_BLOCK
            self.on_lease(self._ceiling)

    def assign(self, n: int) -> tuple[int, int]:
        """Lease n uids; returns [start, end] inclusive."""
        if n <= 0:
            raise ValueError("need n >= 1")
        with self._lock:
            s = self._next
            self._next += n
            self._bump_ceiling_locked()
            return s, self._next - 1

    def bump_to(self, uid: int) -> None:
        """Advance the lease past an externally-seen uid (xidmap/restart)."""
        with self._lock:
            self._next = max(self._next, uid + 1)
            self._bump_ceiling_locked()

    @property
    def max_leased(self) -> int:
        with self._lock:
            return self._next - 1


REBALANCE_RATIO = 0.85   # tablet.go:60-74: move only while the smallest
                         # group serves < 85% of the largest (anti-ping-pong)


def choose_rebalance_move(sizes: dict[int, dict[str, int]],
                          ratio: float = REBALANCE_RATIO,
                          blocked: set | frozenset = frozenset()):
    """One rebalance decision (dgraph/cmd/zero/tablet.go:60-74 + :156
    chooseTablet): compare the largest- and smallest-serving groups; if
    imbalanced past `ratio`, pick the largest source tablet that fits half
    the gap. Returns (attr, src_group, dst_group, size) or None. Shared by
    the in-process Cluster and the Zero-process rebalancer so the two
    planes cannot drift."""
    totals = {g: sum(t.values()) for g, t in sizes.items()}
    if len(totals) < 2:
        return None
    src = max(totals, key=lambda g: totals[g])
    dst = min(totals, key=lambda g: totals[g])
    if src == dst or totals[dst] >= ratio * totals[src]:
        return None
    gap = (totals[src] - totals[dst]) / 2
    for attr, sz in sorted(sizes[src].items(), key=lambda kv: -kv[1]):
        if sz <= gap and attr not in blocked:
            return attr, src, dst, sz
    return None


class Zero:
    """The coordinator facade: oracle + uid lease + tablet map.

    Reference: the `dgraph zero` process. Tablets map predicates to groups
    (zero.go:436 ShouldServe); in the TPU design a "group" is a set of mesh
    devices serving that predicate's sharded CSR (parallel/mesh.py).

    Durability (`dirpath`): the reference Raft-persists leases and the
    tablet map (assign.go:65-125 proposes lease BLOCKS so a crash skips at
    most one block; zero.go tablet proposals). Here a state file records
    lease CEILINGS (bumped a block ahead of issuance) plus the tablet map:
    a restarted Zero resumes past every ts/uid it could have handed out —
    it may burn up to one block, exactly the reference's crash semantics.
    Pending (undecided) txns are lost on restart = aborted, also matching
    the reference (their Decide would fail at the new oracle).
    """

    def __init__(self, n_groups: int = 1, dirpath: str | None = None) -> None:
        self.oracle = Oracle()
        self.uids = UidLease()
        self.n_groups = max(1, n_groups)
        self._tablets: dict[str, int] = {}
        # read-only tablet replicas (coord/placement.py): attr -> {holder
        # group: applied watermark}. A holder serves reads of a tablet it
        # does NOT own, kept fresh by delta ships; the watermark is the
        # owner commit ts its copy provably covers (the replica-read gate
        # bound). Owners never appear as their own holders.
        self._replicas: dict[str, dict[int, int]] = {}
        self._moving: set[str] = set()     # tablets mid-move: writes blocked
        # multi-tenant QoS: the serving node installs its
        # TenantRegistry here so /state exposes the cluster's tenant
        # table (specs + totals + sheds) next to the tablet map
        self.tenants = None
        self._tlock = threading.Lock()
        self._dir = dirpath
        self._ts_ceiling = 0
        self._uid_ceiling = 0
        self._plock = threading.Lock()
        if dirpath:
            import json as _json
            import os as _os

            _os.makedirs(dirpath, exist_ok=True)
            path = _os.path.join(dirpath, "zero_state.json")
            if _os.path.exists(path):
                with open(path) as f:
                    st = _json.load(f)
                # restore the CEILINGS too: a restart that issues nothing
                # before the next crash must not write them back as 0
                self._ts_ceiling = int(st.get("ts_ceiling", 0))
                self._uid_ceiling = int(st.get("uid_ceiling", 0))
                self.oracle.timestamps(max(self._ts_ceiling, 0))
                if self._uid_ceiling > 0:
                    self.uids.bump_to(self._uid_ceiling)
                self._tablets = {a: int(g)
                                 for a, g in st.get("tablets", {}).items()}
                self._replicas = {
                    a: {int(g): int(wm) for g, wm in gs.items()}
                    for a, gs in st.get("replicas", {}).items()}
                self.n_groups = max(self.n_groups,
                                    int(st.get("n_groups", self.n_groups)))
            # lease-source callbacks run UNDER the issuing lock, so a ts
            # or uid is never returned before the ceiling covering it is
            # durable (assign.go: a crash burns at most one block)
            self.oracle.on_lease = self._on_ts_lease
            self.uids.on_lease = self._on_uid_lease
            self._persist()

    def _on_ts_lease(self, ceiling: int) -> None:
        self._ts_ceiling = ceiling
        self._persist()

    def _on_uid_lease(self, ceiling: int) -> None:
        self._uid_ceiling = ceiling
        self._persist()

    # multi-zero hook: called with the persisted state JSON after every
    # durable write — the leader's ZeroReplica ships it to standby zeros
    persist_sink = None

    def _persist(self, tablets: dict | None = None,
                 replicas: dict | None = None) -> None:
        import json as _json
        import os as _os

        # take the tablet/replica snapshots BEFORE _plock (callers inside
        # _tlock pass them; taking _tlock under _plock would deadlock
        # against the _tlock -> _plock order of the claim paths)
        snap = tablets if tablets is not None else self.tablets()
        rsnap = replicas if replicas is not None else self.replicas()
        path = _os.path.join(self._dir, "zero_state.json")
        tmp = path + ".tmp"
        with self._plock:   # ts/uid/tablet persists may race each other
            payload = _json.dumps({"ts_ceiling": self._ts_ceiling,
                                   "uid_ceiling": self._uid_ceiling,
                                   "tablets": snap,
                                   "replicas": {a: {str(g): wm
                                                    for g, wm in gs.items()}
                                                for a, gs in rsnap.items()},
                                   "n_groups": self.n_groups})
            with open(tmp, "w") as f:
                f.write(payload)
                f.flush()
                _os.fsync(f.fileno())
            _os.replace(tmp, path)
            sink = self.persist_sink
            if sink is not None:
                # under _plock: standbys receive states in persist order
                sink(payload)

    def block_writes(self, attr: str) -> None:
        """Mark a tablet read-only for the duration of a move (the reference
        aborts/rejects mutations on a moving predicate,
        predicate_move.go:86 + worker/mutation.go tablet checks)."""
        with self._tlock:
            self._moving.add(attr)

    def unblock_writes(self, attr: str) -> None:
        with self._tlock:
            self._moving.discard(attr)

    def writes_blocked(self, attr: str) -> bool:
        with self._tlock:
            return attr in self._moving

    def moving_tablets(self) -> set[str]:
        with self._tlock:
            return set(self._moving)

    def should_serve(self, attr: str) -> int:
        """Group owning a predicate; first-asker claims it, balanced by
        tablet count (reference zero.go:436 + tablet.go chooseTablet)."""
        with self._tlock:
            g = self._tablets.get(attr)
            if g is None:
                loads = [0] * self.n_groups
                for gg in self._tablets.values():
                    loads[gg] += 1
                g = loads.index(min(loads))
                self._tablets[attr] = g
                if self._dir:
                    # durable BEFORE any caller can act on the claim — a
                    # crash must not re-balance a tablet that data already
                    # landed on (the reference Raft-proposes the claim)
                    self._persist(tablets=dict(self._tablets),
                                  replicas=self._replicas_locked())
        return g

    def tablets(self) -> dict[str, int]:
        with self._tlock:
            return dict(self._tablets)

    def move_tablet(self, attr: str, group: int) -> None:
        with self._tlock:
            self._tablets[attr] = group
            # the new owner must not also be listed as a read replica of
            # itself (a move to a holder group collapses that replica)
            holders = self._replicas.get(attr)
            if holders is not None:
                holders.pop(group, None)
                if not holders:
                    del self._replicas[attr]
            if self._dir:
                self._persist(tablets=dict(self._tablets),
                              replicas=self._replicas_locked())

    # -- read-only tablet replicas (coord/placement.py) ----------------------

    def _replicas_locked(self) -> dict:
        return {a: dict(gs) for a, gs in self._replicas.items()}

    def replicas(self) -> dict[str, dict[int, int]]:
        """attr -> {holder group: covered watermark} for every tablet with
        read replicas."""
        with self._tlock:
            return self._replicas_locked()

    def replica_holders(self, attr: str) -> dict[int, int]:
        with self._tlock:
            return dict(self._replicas.get(attr, {}))

    def add_replica(self, attr: str, group: int, watermark: int) -> None:
        """Register a read replica AFTER its data is installed (routing
        starts the moment the map carries it — never before the copy is
        complete)."""
        with self._tlock:
            if self._tablets.get(attr) == group:
                return                 # the owner is not a replica
            self._replicas.setdefault(attr, {})[group] = int(watermark)
            if self._dir:
                self._persist(tablets=dict(self._tablets),
                              replicas=self._replicas_locked())

    def set_replica_watermark(self, attr: str, group: int,
                              watermark: int) -> None:
        with self._tlock:
            holders = self._replicas.get(attr)
            if holders is not None and group in holders:
                holders[group] = max(holders[group], int(watermark))
                if self._dir:
                    self._persist(tablets=dict(self._tablets),
                                  replicas=self._replicas_locked())

    def drop_replica(self, attr: str, group: int) -> bool:
        """Unregister a replica BEFORE its data is deleted (routing stops
        first; in-flight reads are covered by the holder-side existence
        check in serve_task)."""
        with self._tlock:
            holders = self._replicas.get(attr)
            if holders is None or group not in holders:
                return False
            del holders[group]
            if not holders:
                del self._replicas[attr]
            if self._dir:
                self._persist(tablets=dict(self._tablets),
                              replicas=self._replicas_locked())
            return True

    def state(self) -> dict:
        """Membership dump (reference /state, dgraph/cmd/zero/http.go:130)."""
        out = {
            "maxTxnTs": self.oracle.max_assigned,
            "maxLeaseId": self.uids.max_leased,
            # per-tablet last commit ts: the replica-read floor hedged
            # reads carry (TaskRequest.min_applied)
            "predCommit": dict(self.oracle.pred_commit),
            # read-replica holders per tablet (the query router spreads
            # reads across owner + holders; coord/placement.py maintains)
            "replicaMap": {a: sorted(gs)
                           for a, gs in self.replicas().items()},
            "groups": {str(g): {"tablets": sorted(
                a for a, gg in self.tablets().items() if gg == g)}
                for g in range(self.n_groups)},
        }
        if self.tenants is not None and self.tenants.configured:
            out["tenants"] = self.tenants.table()
        return out
