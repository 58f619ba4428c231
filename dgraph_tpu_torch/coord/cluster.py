"""Multi-group cluster: per-group stores, tablet routing, predicate moves.

Port of dgraph_tpu/coord/cluster.py; the federated snapshot lives on the
Cluster's `device` ("cuda" unless given).

Reference semantics:
- worker/groups.go:292 BelongsTo — every predicate ("tablet") is owned by
  exactly one group; mutations and task execution route to the owner.
- worker/mutation.go:470 populateMutationMap — a mutation's edges are split
  by owning group and applied on each.
- worker/predicate_move.go:86-177 — moving a tablet: block writes, abort
  open txns touching it, stream every key of the predicate to the target
  group at a snapshot ts, flip the tablet map in Zero, delete at the source.

Topology: one shared Zero (oracle + uid lease + tablet map) over N group
stores in one process — the same collapse the reference's own test harness
uses (embedded zero+workers). Queries assemble a federated snapshot by
building each predicate's device arrays from its OWNING group's store, so
the Executor is unchanged. Cross-group transactions work because conflict
detection is centralized in the shared oracle while buffered layers live in
each group's store.
"""

from __future__ import annotations

import threading

from dgraph_tpu_torch.coord.zero import Zero
from dgraph_tpu_torch.query import dql
from dgraph_tpu_torch.query import mutation as mut
from dgraph_tpu_torch.query.engine import Executor
from dgraph_tpu_torch.storage import keys as K
from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.storage.csr_build import GraphSnapshot
from dgraph_tpu_torch.storage.postings import Op
from dgraph_tpu_torch.storage.store import Store
from dgraph_tpu_torch.utils.schema import SchemaState, parse_schema


class MoveInProgress(Exception):
    pass


class Cluster:
    """N group stores behind one Zero (embedded multi-group topology)."""

    def __init__(self, n_groups: int = 2, dirs: list[str] | None = None,
                 device: str = "cuda") -> None:
        # the federated snapshot's device columns live here ("cuda" raises
        # without a card)
        self.device = resolve_device(device)
        self.zero = Zero(n_groups)
        self.stores = [Store(dirs[g] if dirs else None)
                       for g in range(n_groups)]
        self._lock = threading.RLock()
        self._txn_keys: dict[int, dict[int, list[bytes]]] = {}  # ts -> g -> keys
        # per-(group, attr) cumulative load counters [reads, writes,
        # bytes, serve_s] — the embedded analog of the workers'
        # tablet_load_json report, feeding the placement controller
        self._loads: dict[tuple[int, str], list[float]] = {}
        self._rr = 0     # replica read spread cursor

    # -- routing -------------------------------------------------------------

    def group_of(self, attr: str) -> int:
        return self.zero.should_serve(attr)

    def store_of(self, attr: str) -> Store:
        return self.stores[self.group_of(attr)]

    @property
    def schema(self) -> SchemaState:
        """Cluster-wide schema view: alter replicates entries to every group,
        but mutation-time INFERRED entries land only on the owning group's
        store — merge them all (each predicate is owned by exactly one group,
        so there are no conflicting entries)."""
        merged = SchemaState()
        for s in self.stores:
            for attr in s.schema.predicates():
                merged.set(s.schema.get(attr))
        return merged

    # -- schema --------------------------------------------------------------

    def alter(self, schema_text: str) -> None:
        for e in parse_schema(schema_text):
            for s in self.stores:
                s.set_schema(e)
        for a in getattr(self, "_assemblers", ()):
            a.invalidate()   # schema is structural: cached folds may be wrong

    # -- mutate --------------------------------------------------------------

    def mutate(self, set_nquads: str = "", del_nquads: str = "",
               commit_now: bool = True) -> dict[str, int]:
        """Split edges by owning group, apply on each, commit via the shared
        oracle (populateMutationMap + MutateOverNetwork)."""
        from dgraph_tpu_torch.query import rdf

        nq_set = rdf.parse(set_nquads) if set_nquads else []
        nq_del = rdf.parse(del_nquads) if del_nquads else []
        with self._lock:
            for e in nq_set + nq_del:
                if self.zero.writes_blocked(e.predicate) or (
                        e.predicate == "*" and self.zero.moving_tablets()):
                    raise MoveInProgress(
                        f"predicate {e.predicate!r} is moving; retry")
            st = self.zero.oracle.new_txn()
            keys_by_group: dict[int, list[bytes]] = {}
            try:
                uid_map = mut.assign_uids(nq_set + nq_del, self.zero.uids)
                edges = mut.to_edges(nq_set, uid_map, Op.SET) + \
                    mut.to_edges(nq_del, uid_map, Op.DEL)
                by_group = mut.split_edges_by_group(
                    edges, len(self.stores), self.group_of)
                conflicts: list[bytes] = []
                preds: set[str] = set()
                for g, ge in sorted(by_group.items()):
                    touched, conflict, p = mut.apply_mutations(
                        self.stores[g], ge, st.start_ts)
                    keys_by_group[g] = touched
                    conflicts += conflict
                    preds |= p
                self.zero.oracle.track(st.start_ts, conflicts, sorted(preds))
                self._txn_keys[st.start_ts] = keys_by_group
                for e in edges:
                    if e.attr == "*":
                        continue
                    row = self._loads.setdefault(
                        (self.group_of(e.attr), e.attr),
                        [0.0, 0.0, 0.0, 0.0])
                    row[1] += 1.0
            except BaseException:
                # abort everything buffered so far: leaked pending txns pin
                # the oracle's purge watermark forever
                for g, kb in keys_by_group.items():
                    self.stores[g].abort(st.start_ts, kb)
                self.zero.oracle.abort(st.start_ts)
                raise
            if commit_now:
                self.commit(st.start_ts)
        return uid_map

    def commit(self, start_ts: int) -> int:
        with self._lock:
            keys_by_group = self._txn_keys.pop(start_ts, {})
            try:
                commit_ts = self.zero.oracle.commit(start_ts)
            except Exception:
                for g, kb in keys_by_group.items():
                    self.stores[g].abort(start_ts, kb)
                raise
            for g, kb in keys_by_group.items():
                self.stores[g].commit(start_ts, commit_ts, kb)
            self._ship_replica_deltas(start_ts, commit_ts, keys_by_group)
            # live-query wake: the wire-mode seam — workers
            # applied, the querying node's manager re-evaluates. Touched
            # predicates derive from the committed keys themselves, so
            # the wake filter sees exactly what the journal recorded.
            live = getattr(self, "_live", None)
            if live is not None and live.active:
                preds = {K.kind_attr_of(kb)[1]
                         for kbs in keys_by_group.values() for kb in kbs}
                live.notify_commit(commit_ts, preds)
            return commit_ts

    def _ship_replica_deltas(self, start_ts: int, commit_ts: int,
                             keys_by_group: dict) -> None:
        """Embedded-mode replica freshness: rewrite each touched key of a
        replicated tablet on every holder at the SAME commit_ts, under the
        cluster lock — in-process holders are therefore always exact, so
        replica-spread reads are byte-identical to owner reads at any
        read_ts the embedded query path can produce (the wire path's
        asynchronous analog is ZeroOps.ship_replica_delta)."""
        replicas = self.zero.replicas()
        if not replicas:
            return
        from dgraph_tpu_torch.storage.postings import Op as _Op
        from dgraph_tpu_torch.storage.postings import Posting as _Posting

        touched: dict[str, list[bytes]] = {}
        for _g, kbs in keys_by_group.items():
            for kb in kbs:
                attr = K.kind_attr_of(kb)[1]
                if attr in replicas:
                    touched.setdefault(attr, []).append(kb)
        for attr, kbs in touched.items():
            owner = self.stores[self.zero.tablets()[attr]]
            for holder in sorted(replicas[attr]):
                hstore = self.stores[holder]
                for kb in kbs:
                    key = K.parse_key(kb)
                    pl = owner.lists.get(kb)
                    hstore.add_mutation(start_ts, key,
                                        _Posting(0, _Op.DEL_ALL))
                    if pl is not None:
                        for p in pl.postings(commit_ts):
                            hstore.add_mutation(start_ts, key, p)
                hstore.commit(start_ts, commit_ts, kbs)
                self.zero.set_replica_watermark(attr, holder, commit_ts)

    # -- query ---------------------------------------------------------------

    def query(self, q: str, variables: dict | None = None,
              read_ts: int | None = None) -> dict:
        """Federated read: each predicate's snapshot arrays come from its
        owning group's store (ProcessTaskOverNetwork routes the same way),
        through per-store incremental assemblers — a commit touching one
        predicate re-folds one predicate, not the world per query
        (posting/lists.go:243 read-through).

        read_ts pins the snapshot timestamp (live-query re-evaluation at
        a notification's carried watermark); None reads the newest."""
        serving: dict[str, int] = {}
        with self._lock:
            # read_ts under the lock: a move completing in between would make
            # the moved predicate invisible (streamed copy commits above our
            # ts, source copy already deleted)
            if read_ts is None:
                read_ts = self.zero.oracle.read_ts()
            if not hasattr(self, "_assemblers"):
                from dgraph_tpu_torch.storage.csr_build import SnapshotAssembler

                self._assemblers = [SnapshotAssembler(s, device=self.device)
                                    for s in self.stores]
            per_group = [a.snapshot(read_ts) for a in self._assemblers]
            snap = GraphSnapshot(read_ts, device=self.device)
            from dgraph_tpu_torch.storage.csr_build import DelegateThunk, LazyPreds

            # lazy federation: the per-group assemblers hand
            # out fold-thunks — routing only needs tablet PRESENCE, so
            # delegate per-attr reads to the owning group's map instead
            # of folding every tablet at assembly time
            lazy = LazyPreds()
            snap.preds = lazy
            replicas = self.zero.replicas()
            for attr, g in sorted(self.zero.tablets().items()):
                src_g = g
                holders = replicas.get(attr)
                if holders:
                    # spread reads round-robin across owner + holders:
                    # embedded holders are exact at every commit (see
                    # _ship_replica_deltas), so any source is correct
                    cands = [g] + sorted(h for h in holders if h != g)
                    src_g = cands[self._rr % len(cands)]
                    self._rr += 1
                src = per_group[src_g].preds
                if attr not in src:
                    continue
                if getattr(src, "is_pending", lambda _a: False)(attr):
                    lazy.register(attr, DelegateThunk(src, attr))
                else:
                    pd = src.get(attr)
                    if pd is None:
                        continue
                    lazy[attr] = pd
                serving[attr] = src_g

        def on_task(tq, res, dt):
            attr = tq.attr[1:] if tq.attr.startswith("~") else tq.attr
            g = serving.get(attr)
            if g is None:
                return
            with self._lock:
                row = self._loads.setdefault((g, attr),
                                             [0.0, 0.0, 0.0, 0.0])
                row[0] += 1.0
                if res.dest_uids is not None:
                    row[2] += 8.0 * len(res.dest_uids)
                row[3] += dt
        return Executor(snap, self.schema,
                        on_task=on_task).execute(dql.parse(q, variables))

    # -- live queries --------------------------------------------

    def subscribe(self, q: str, variables: dict | None = None, *,
                  cursor: int | None = None, queue_max: int | None = None):
        """Wire-mode standing query: each group's store applies its
        tablets' writes, the querying node's manager re-evaluates the
        federated read at the commit watermark and streams diffs — the
        same fan-out seam as query(). Lazy: the manager (and its notifier
        thread) exists only once something subscribes."""
        live = getattr(self, "_live", None)
        if live is None:
            from dgraph_tpu_torch.live import LiveManager

            live = LiveManager(
                eval_fn=lambda qq, vv, ts: self.query(qq, vv, read_ts=ts),
                watermark_fn=lambda: max(
                    (s.max_seen_commit_ts for s in self.stores), default=0),
                parse_fn=dql.parse,
                stores=self.stores)
            self._live = live
            for s in self.stores:
                s.on_delta_overflow = live.on_journal_overflow
        return live.subscribe(q, variables, cursor=cursor,
                              queue_max=queue_max)

    # -- predicate move ------------------------------------------------------

    def move_predicate(self, attr: str, dst_group: int) -> dict:
        """The full move protocol (worker/predicate_move.go:86-177):
        1. block writes on the tablet (new mutations raise MoveInProgress);
        2. abort open txns that touched it (Zero TryAbort);
        3. snapshot-read every key of the predicate at ts and stream the
           effective postings into the destination store under one txn;
        4. flip the tablet map;
        5. delete the predicate at the source;
        6. unblock writes.
        """
        src_group = self.group_of(attr)
        if src_group == dst_group:
            return {"moved_keys": 0, "aborted_txns": 0}
        # replicas of a moving tablet drop first: the destination may BE a
        # holder (its copy would union with the streamed one), and holders
        # must not outlive their owner's location
        for holder in sorted(self.zero.replica_holders(attr)):
            self.drop_replica(attr, holder)
        src, dst = self.stores[src_group], self.stores[dst_group]
        self.zero.block_writes(attr)
        try:
            with self._lock:
                aborted = 0
                for ts in self.zero.oracle.pending_on(attr):
                    self.zero.oracle.abort(ts)
                    kb = self._txn_keys.pop(ts, {})
                    for g, keys in kb.items():
                        self.stores[g].abort(ts, keys)
                    aborted += 1
                read_ts = self.zero.oracle.read_ts()
                move_st = self.zero.oracle.new_txn()
                moved_keys: list[bytes] = []
                try:
                    for kind in (K.KeyKind.DATA, K.KeyKind.REVERSE,
                                 K.KeyKind.INDEX, K.KeyKind.COUNT):
                        for kb in src.keys_of(kind, attr):
                            pl = src.lists.get(kb)
                            if pl is None:
                                continue
                            key = K.parse_key(kb)
                            for p in pl.postings(read_ts):
                                dst.add_mutation(move_st.start_ts, key, p)
                            moved_keys.append(kb)
                    entry = src.schema.get(attr)
                    if entry is not None:
                        dst.set_schema(entry)
                    # the move txn carries no conflict keys (writes on attr
                    # are blocked), so the oracle commit always succeeds
                    commit_ts = self.zero.oracle.commit(move_st.start_ts)
                except BaseException:
                    # mid-stream failure: drop the partial copy and the
                    # pending move txn; source stays authoritative
                    dst.abort(move_st.start_ts, moved_keys)
                    self.zero.oracle.abort(move_st.start_ts)
                    raise
                dst.commit(move_st.start_ts, commit_ts, moved_keys)
                self.zero.move_tablet(attr, dst_group)
                src.delete_predicate(attr)
                return {"moved_keys": len(moved_keys), "aborted_txns": aborted}
        finally:
            self.zero.unblock_writes(attr)

    # -- read-only tablet replicas (coord/placement.py, embedded mode) -------

    def add_replica(self, attr: str, group: int) -> dict:
        """Install a read-only copy of `attr` on `group`'s store: stream
        every key's effective postings at a snapshot cut under one txn,
        then register the holder — routing starts only with the copy
        complete. Freshness afterwards is synchronous (commit-time
        rewrite, _ship_replica_deltas), so embedded holders never lag."""
        with self._lock:
            src_group = self.group_of(attr)
            if src_group == group:
                return {"installed_keys": 0, "noop": "owner"}
            if group in self.zero.replica_holders(attr):
                return {"installed_keys": 0, "noop": "already a holder"}
            src, dst = self.stores[src_group], self.stores[group]
            read_ts = self.zero.oracle.read_ts()
            st = self.zero.oracle.new_txn()
            copied: list[bytes] = []
            try:
                for kind in (K.KeyKind.DATA, K.KeyKind.REVERSE,
                             K.KeyKind.INDEX, K.KeyKind.COUNT):
                    for kb in src.keys_of(kind, attr):
                        pl = src.lists.get(kb)
                        if pl is None:
                            continue
                        key = K.parse_key(kb)
                        for p in pl.postings(read_ts):
                            dst.add_mutation(st.start_ts, key, p)
                        copied.append(kb)
                entry = src.schema.get(attr)
                if entry is not None:
                    dst.set_schema(entry)
                commit_ts = self.zero.oracle.commit(st.start_ts)
            except BaseException:
                dst.abort(st.start_ts, copied)
                self.zero.oracle.abort(st.start_ts)
                raise
            dst.commit(st.start_ts, commit_ts, copied)
            self.zero.add_replica(attr, group, commit_ts)
            return {"installed_keys": len(copied), "tablet": attr,
                    "src": src_group, "dst": group,
                    "watermark": commit_ts}

    def drop_replica(self, attr: str, group: int) -> bool:
        """Demote: unregister first (routing stops under the cluster
        lock), then delete the copy."""
        with self._lock:
            if not self.zero.drop_replica(attr, group):
                return False
            self.stores[group].delete_predicate(attr)
            self._loads.pop((group, attr), None)
            return True

    def tablet_loads(self) -> dict[int, dict[str, dict]]:
        """Cumulative per-group per-tablet load counters, the embedded
        analog of the wire Status tablet_load_json report."""
        with self._lock:
            out: dict[int, dict[str, dict]] = {
                g: {} for g in range(len(self.stores))}
            for (g, attr), r in self._loads.items():
                out[g][attr] = {"r": r[0], "w": r[1], "b": r[2],
                                "d": round(r[3], 6)}
            return out

    def placement_controller(self, cfg=None, metrics=None,
                             clock=None):
        """A PlacementController wired to this embedded cluster: sizes +
        load counters in, move/add_replica/drop_replica out. The caller
        drives tick() (tests) or start(interval_s)."""
        import time as _time

        from dgraph_tpu_torch.coord.placement import PlacementController

        cluster = self

        class _Exec:
            def move(self, attr, dst):
                return cluster.move_predicate(attr, dst)

            def add_replica(self, attr, dst):
                return cluster.add_replica(attr, dst)

            def drop_replica(self, attr, group):
                return cluster.drop_replica(attr, group)

            # freshness is synchronous in-process: nothing to ship

        def collect():
            loads = cluster.tablet_loads()
            return {g: (cluster.stores[g].tablet_sizes(), loads.get(g, {}))
                    for g in range(len(cluster.stores))}

        return PlacementController(
            self.zero, collect, _Exec(), cfg=cfg, metrics=metrics,
            clock=clock if clock is not None else _time.monotonic)

    # -- auto-rebalance (dgraph/cmd/zero/tablet.go:60-74) ---------------------

    def rebalance_once(self) -> dict | None:
        """One pass of the reference's rebalance tick (decision logic shared
        with the Zero process: coord/zero.choose_rebalance_move). Returns
        the move stats or None."""
        from dgraph_tpu_torch.coord.zero import choose_rebalance_move

        sizes = {g: self.stores[g].tablet_sizes()
                 for g in range(len(self.stores))}
        # replicated tablets are the load controller's responsibility —
        # their copies also inflate holder sizes, which would mislead the
        # size-only decision
        pick = choose_rebalance_move(
            sizes, blocked=self.zero.moving_tablets()
            | set(self.zero.replicas()))
        if pick is None:
            return None
        attr, src, dst, sz = pick
        stats = self.move_predicate(attr, dst)
        stats.update(tablet=attr, src=src, dst=dst, bytes=sz)
        return stats

    def start_rebalancer(self, interval_s: float = 8.0) -> None:
        """Background rebalance tick (the --rebalance_interval loop)."""
        import time as _time

        def loop():
            while not self._stop_rebalance.is_set():
                try:
                    self.rebalance_once()
                except Exception:
                    pass                   # next tick retries
                self._stop_rebalance.wait(interval_s)

        self._stop_rebalance = threading.Event()
        # dgraph: allow(ctxvar-copy) detached rebalance bg loop
        self._rebalance_thread = threading.Thread(target=loop, daemon=True)
        self._rebalance_thread.start()

    def close(self) -> None:
        live = getattr(self, "_live", None)
        if live is not None:
            live.close()
        ev = getattr(self, "_stop_rebalance", None)
        if ev is not None:
            ev.set()
        for s in self.stores:
            s.close()
