"""Mesh-native cross-shard execution: whole-plan traversals as one program.

Port of dgraph_tpu/parallel/mesh_exec.py. Reference semantics: a multi-hop
traversal crossing predicate shards pays one ProcessTaskOverNetwork round
trip PER HOP PER GROUP (worker/task.go:137). Here per-predicate CSR arrays
are placed across the mesh (parallel/mesh.py) as row-range shards (small
tablets stay on the classic single-device/host path), and the planner's
WHOLE physical plan — the expansion chain with its pointwise filters and
per-row pagination windows (query/fusedplan.py), the fused single-child
`@recurse`, and the shortest-path BFS — runs as ONE program whose only
inter-shard traffic is one psum per hop of (per-rank contribution counts ‖
local edge total).

A program is a cached closure: its body runs once per shard in a Python
loop over the shard devices, and each collective folds the per-shard
results onto the leader device (parallel/mesh.Mesh). The layouts are the
JAX package's — `[rows_per]` row blocks, `[ecap]` edge blocks, the `nd`
dump slot of every rank-space vector and the `rows_per` inactive row — so
the host replay (fusedplan.replay_hop) and every rank map are the same
bytes. Every index of a JAX `mode="drop"` scatter stays inside its buffer
here: an out-of-range row lands in a dump slot that is sliced off, and the
rank scatters count only a shard's real edges (the JAX programs aim every
dropped edge at one dump slot, which on the card would serialize millions
of atomic adds on one address); the slots that are kept come out the same.

Fused programs ship ONLY replicated frontier masks and edge totals back to
the host; the host replays each hop's pruned rows from its CSR mirrors
with the same allow-sets the device applied, byte-identical by
construction. The recurse program keeps its per-level masks on the device
and fetches once; the BFS, PageRank and CC loops have device-side
conditions that the host reads once an iteration (`loop_reads`).

Shapes the fused programs do not cover fall back to the classic per-task
seam, labeled by reason on dgraph_mesh_fallbacks_total{reason=}.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import replace

import numpy as np
import torch

from dgraph_tpu_torch.obs import otrace
from dgraph_tpu_torch.parallel.dist import (SNT, DistPredCSR, _local_rows,
                                            pad_frontier)
from dgraph_tpu_torch.parallel.mesh import Mesh, make_mesh
from dgraph_tpu_torch.query.fusedplan import eval_formula_np
from dgraph_tpu_torch.storage.csr_build import GraphSnapshot, PredCSR


def _target_table(csr: DistPredCSR) -> np.ndarray:
    """Sorted distinct destination uids of one sharded tablet (cached: one
    O(E log E) host pass per placement) — the rank space of traversal
    masks: anything a hop can reach is in here."""
    t = getattr(csr, "_target_table", None)
    if t is None:
        t = (np.unique(csr.indices).astype(np.int32) if len(csr.indices)
             else np.zeros(0, np.int32))
        csr._target_table = t
    return t


def _fcap_for(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1) + 1))), 4)


def _edge_rows(csr: DistPredCSR) -> list:
    """Per shard [ecap] local-edge → local-row map; padding slots point at
    row `rows_per` (a reserved always-inactive slot)."""
    er = getattr(csr, "_edge_rows", None)
    if er is not None:
        return er
    n_shards = csr.mesh.shape["shard"]
    ecap = csr.ecap
    rows_per = csr.rows_per
    n_rows = len(csr.subjects)
    out = np.full((n_shards, ecap), rows_per, dtype=np.int32)
    for s in range(n_shards):
        lo = min(s * rows_per, n_rows)
        hi = min((s + 1) * rows_per, n_rows)
        deg = np.diff(csr.indptr[lo: hi + 1]).astype(np.int64)
        local = np.repeat(np.arange(hi - lo, dtype=np.int32), deg)
        out[s, : len(local)] = local
    er = [t.long() for t in csr.mesh.shard_put(out)]
    csr._edge_rows = er
    return er


def _pag_window_dense(keep: torch.Tensor, lptr: torch.Tensor,
                      erow: torch.Tensor, rows_per: int, first: int,
                      offset: int) -> torch.Tensor:
    """Per-row [offset, offset+first) window over the filter-SURVIVING
    positions — the device twin of engine._apply_child_row_mods' slicing
    (negative first keeps the last |first| of the post-offset run).
    lptr [rows_per+1] holds the shard-local row→edge offsets, erow the
    per-edge local row."""
    ecap = keep.shape[0]
    ki = keep.to(torch.int64)
    ci = torch.cumsum(ki, 0)
    cexcl = ci - ki
    cext = torch.cat([cexcl, ci[-1:]])                    # [ecap + 1]
    lp = lptr.long()
    base_r = cext[torch.clamp(lp[:-1], 0, ecap)]          # [rows_per]
    cnt_r = cext[torch.clamp(lp[1:], 0, ecap)] - base_r
    er = torch.clamp(erow, 0, rows_per - 1)
    p = cexcl - base_r[er]
    win = p >= offset
    if first > 0:
        win &= p < offset + first
    elif first < 0:
        win &= p >= cnt_r[er] + first
    return keep & win


def _row_mask(rows: torch.Tensor, rows_per: int) -> torch.Tensor:
    """bool[rows_per + 1] active-row mask from local rows (SENTINEL =
    absent): the JAX scatter's out-of-range index lands in a dump slot
    at rows_per + 1, sliced off; slot rows_per stays False."""
    act = torch.zeros((rows_per + 2,), dtype=torch.bool, device=rows.device)
    act[torch.where(rows == SNT, rows_per + 1, rows).long()] = True
    return act[: rows_per + 1]


def _relay(mext: torch.Tensor, rrank: torch.Tensor) -> torch.Tensor:
    """Next hop's active rows: the previous rank mask (with its False
    tail slot) gathered through a row → rank map, plus the inactive row."""
    nd = mext.shape[0] - 1
    return torch.cat([mext[torch.clamp(rrank, 0, nd)],
                      torch.zeros(1, dtype=torch.bool, device=mext.device)])


def _rank_counts(erank: torch.Tensor, keep: torch.Tensor,
                 n: int) -> torch.Tensor:
    """int32[n]: per rank, the kept edges aimed at it. The JAX programs
    scatter every dropped edge into the dump slot; here each edge adds its
    0/1 to its own rank instead, and the callers pass a shard's real edges
    only (padding is never kept), so no single slot takes millions of
    atomic adds. The ranks below the dump slot come out the same."""
    return torch.zeros((n,), dtype=torch.int32,
                       device=erank.device).index_add_(
        0, erank, keep.to(torch.int32))


class MeshExecutor:
    """Owns the device mesh, the tablet placement cache, the allow-set
    cache, and the fused-plan programs. One per Node."""

    # tablets below this edge count stay replicated (the classic
    # single-device/host path): sharding them buys no bandwidth and pays
    # the collective per hop. Aligned with task.HOST_EXPAND_MAX so a
    # sharded tablet is by definition a device-class tablet.
    SHARD_MIN_EDGES = 1 << 16
    _PLACE_CACHE = 512      # placed-PredData entries (identity-keyed)
    _SNAP_CACHE = 8         # placed-snapshot entries (identity-keyed)
    _ALLOW_CACHE = 512      # resolved allow-sets (pred-identity-keyed)
    _DEVSET_CACHE = 256     # uploaded allow-set rank masks
    _DENSE_CACHE = 256      # (tablet, rank-space) edge/row rank maps

    def __init__(self, mesh: Mesh | None = None, n_devices: int | None = None,
                 metrics=None, shard_min_edges: int | None = None,
                 residency=None) -> None:
        from dgraph_tpu_torch.utils.metrics import Registry

        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        self.metrics = metrics if metrics is not None else Registry()
        if shard_min_edges is not None:
            self.SHARD_MIN_EDGES = int(shard_min_edges)
        # device working-set manager (storage/residency.py): placement
        # defers to it — a tablet whose per-device row-shard would not fit
        # the node's device budget stays on the host/replicated path
        self.residency = residency
        # id(PredData) -> (PredData ref, placed PredData): the assembler
        # reuses PredData identity for clean predicates, so identity-keyed
        # placement keeps per-predicate cache tokens stable across commits
        # to OTHER predicates
        self._placed_pd: OrderedDict[int, tuple] = OrderedDict()
        self._placed_snaps: OrderedDict[int, tuple] = OrderedDict()
        self._progs: dict = {}
        self._allow: OrderedDict[tuple, tuple] = OrderedDict()
        self._dev_sets: OrderedDict[tuple, tuple] = OrderedDict()
        self._dense: OrderedDict[tuple, tuple] = OrderedDict()
        self._bfs_tgt: OrderedDict[tuple, tuple] = OrderedDict()
        # host reads of the loops' device-side conditions, per program
        # family (one a BFS level / PageRank or CC iteration)
        self.loop_reads = {"bfs": 0, "pagerank": 0, "cc": 0}
        m = self.metrics
        self._c_dispatch = m.counter("dgraph_mesh_dispatches_total")
        self._c_hops = m.counter("dgraph_mesh_fused_hops_total")
        self._c_edges = m.counter("dgraph_mesh_traversed_edges_total")
        # per-reason fallback breakdown: the labeled series
        # dgraph_mesh_fallbacks_total{reason=} enumerates every
        # fused-coverage gap from /metrics
        self._k_fallback = m.keyed("dgraph_mesh_fallbacks_total",
                                   labels=("reason",))
        self._c_fused_q = m.counter("dgraph_mesh_fused_queries_total")
        self._c_unfused_q = m.counter("dgraph_mesh_unfused_queries_total")
        self._c_compiles = m.counter("dgraph_mesh_program_builds_total")
        # device-runtime observatory (obs/devprof.py): the node attaches
        # its DevProfiler so every program-cache miss notes its family +
        # triggering shape key
        self._prof = None
        m.counter("dgraph_mesh_devices").set(self.n_devices)
        m.counter("dgraph_mesh_sharded_tablets").set(0)
        m.counter("dgraph_mesh_replicated_tablets").set(0)

    @property
    def n_devices(self) -> int:
        return int(self.mesh.shape["shard"])

    def owns(self, csr) -> bool:
        """Is this a tablet THIS executor placed (fused programs only run
        over their own mesh's shards)?"""
        return isinstance(csr, DistPredCSR) and csr.mesh is self.mesh

    def fallback(self, reason: str) -> None:
        """One labeled fused-coverage miss."""
        self._k_fallback.inc(reason)

    def fallback_total(self) -> int:
        return sum(self._k_fallback.snapshot().values())

    def note_query(self, fused: bool) -> None:
        """Per-query coverage accounting: fused/(fused+unfused) is the
        coverage ratio surfaced on /debug/metrics."""
        (self._c_fused_q if fused else self._c_unfused_q).inc()

    def _built(self, family: str, key) -> None:
        self._c_compiles.inc()
        if self._prof is not None:
            self._prof.on_build(family, key)

    # -- allow-set caches ----------------------------------------------------

    def allow_cached(self, key: tuple, pd) -> np.ndarray | None:
        hit = self._allow.get(key)
        if hit is not None and hit[0] is pd:
            self._allow.move_to_end(key)
            return hit[1]
        return None

    def allow_store(self, key: tuple, pd, s: np.ndarray) -> None:
        self._allow[key] = (pd, s)
        while len(self._allow) > self._ALLOW_CACHE:
            self._allow.popitem(last=False)

    # -- placement (snapshot assembly → mesh) --------------------------------

    def place_snapshot(self, snap: GraphSnapshot) -> GraphSnapshot:
        """Mesh view of a snapshot: large uid adjacencies become
        row-range-sharded DistPredCSRs over the mesh; small tablets, value
        tables, and token indexes stay replicated. Identity-cached at both
        the snapshot and the PredData level so cache tokens
        (qcache.task_token) stay stable."""
        hit = self._placed_snaps.get(id(snap))
        if hit is not None and hit[0] is snap:
            return hit[1]
        out = GraphSnapshot(snap.read_ts, device=snap.device)
        out.metrics = getattr(snap, "metrics", None)
        pend_fn = getattr(snap.preds, "pending_attrs", None)
        # capture the pending list BEFORE folded_items: a tablet resolving
        # between the two reads must land in at least one set
        pending = pend_fn() if pend_fn is not None else []
        if pending:
            # lazy base: folded tablets place eagerly; pending ones
            # register pass-through thunks that fold-then-place on first
            # read
            from dgraph_tpu_torch.storage.csr_build import (DelegateThunk,
                                                            LazyPreds)

            preds = LazyPreds()
            preds.hint_fn = getattr(snap.preds, "hint_fn", None)
            out.preds = preds
            for attr, pd in snap.preds.folded_items():
                preds[attr] = self._place_pred(pd)
            for attr in pending:
                preds.register(attr, DelegateThunk(snap.preds, attr,
                                                   wrap=self._place_pred))
            preds.on_resolve = lambda _a, _pd: self._count_placed(preds)
        else:
            for attr, pd in snap.preds.items():
                out.preds[attr] = self._place_pred(pd)
        self._count_placed(out.preds)
        self._placed_snaps[id(snap)] = (snap, out)
        while len(self._placed_snaps) > self._SNAP_CACHE:
            self._placed_snaps.popitem(last=False)
        return out

    def _count_placed(self, preds) -> None:
        """Refresh the sharded/replicated tablet gauges over the placed
        (folded) entries; retries a walk that a concurrent resolution
        interrupted — a gauge refresh must never fail a read."""
        for _ in range(4):
            sharded = replicated = 0
            try:
                items = getattr(preds, "folded_items", preds.items)()
                for _attr, pd in items:
                    for c in (pd.csr, pd.rev_csr):
                        if c is None:
                            continue
                        if self.owns(c):
                            sharded += 1
                        else:
                            replicated += 1
            except RuntimeError:
                continue
            break
        else:
            return
        self.metrics.counter("dgraph_mesh_sharded_tablets").set(sharded)
        self.metrics.counter("dgraph_mesh_replicated_tablets").set(replicated)

    def _place_pred(self, pd):
        hit = self._placed_pd.get(id(pd))
        if hit is not None and hit[0] is pd:
            self._placed_pd.move_to_end(id(pd))
            return hit[1]
        csr = self._place_csr(pd.csr)
        rev = self._place_csr(pd.rev_csr)
        vec = self._place_vec(pd.vecindex)
        placed = pd if (csr is pd.csr and rev is pd.rev_csr
                        and vec is pd.vecindex) \
            else replace(pd, csr=csr, rev_csr=rev, vecindex=vec)
        self._placed_pd[id(pd)] = (pd, placed)
        while len(self._placed_pd) > self._PLACE_CACHE:
            self._placed_pd.popitem(last=False)
        return placed

    def _place_vec(self, vi):
        """Mesh placement of a vector index: large embedding matrices scan
        row-sharded across the mesh with a replicated top-k merge
        (vector_topk); small ones and delta overlays stay on the classic
        path until compaction folds a fresh base."""
        if vi is None or vi.is_overlay or \
                vi.n * vi.dim < self.SHARD_MIN_EDGES:
            return vi
        if self.residency is not None and self.residency.enabled and \
                vi.device_nbytes() // max(self.n_devices, 1) > \
                self.residency.budget:
            self.metrics.counter(
                "dgraph_mesh_residency_deferred_total").inc()
            return vi
        import copy

        placed = copy.copy(vi)
        placed._mesh = self
        placed._mesh_dev = None
        return placed

    def _place_csr(self, csr):
        """Shard one adjacency, or leave it on the fallback path: None,
        already-dist, delta overlays (host-side until compaction), and
        small tablets (replicated)."""
        if csr is None or getattr(csr, "is_dist", False):
            return csr
        if not isinstance(csr, PredCSR):
            return csr               # OverlayCSR etc.: host fallback
        if csr.num_edges < self.SHARD_MIN_EDGES:
            return csr               # small tablet: replicated
        if self.residency is not None and self.residency.enabled and \
                csr.host_nbytes() // max(self.n_devices, 1) > \
                self.residency.budget:
            # even one row-shard of this tablet would blow the per-device
            # budget — keep it on the warm/cold host path and mark it so
            # the fused-plan classifier labels the miss reason=budget
            self.metrics.counter(
                "dgraph_mesh_residency_deferred_total").inc()
            csr._mesh_deferred = True
            return csr
        sub, ptr, idx = csr.host_arrays()
        placed = DistPredCSR(sub, ptr, idx, self.mesh)
        placed.metrics = self.metrics
        return placed

    # -- dense rank-space precomputes (host, identity-cached) ----------------
    #
    # Fused traversals run DENSE: frontiers are bool masks over a tablet's
    # sorted distinct-target table (the rank space), edges carry
    # precomputed (local row, target rank) indices, and the per-hop
    # exchange is ONE psum of an int32 [nd+1] vector (per-rank contribution
    # counts ‖ local raw edge total).

    def _dense_maps(self, csr: DistPredCSR, tgt: np.ndarray):
        """(erank, rrank) per-shard tensors for one (tablet, rank-space)
        pair: erank [ecap] maps each local edge to its target's rank in
        `tgt` (nd = dump slot for padding), rrank [rows_per] maps each
        local row's SUBJECT to its rank (nd where absent)."""
        key = (id(csr), id(tgt))
        hit = self._dense.get(key)
        if hit is not None and hit[0] is csr and hit[1] is tgt:
            self._dense.move_to_end(key)
            return hit[2], hit[3]
        nd = len(tgt)
        S = csr.mesh.shape["shard"]
        ecap = csr.ecap
        rows_per = csr.rows_per
        n_rows = len(csr.subjects)
        erank = np.full((S, ecap), nd, dtype=np.int32)
        rrank = np.full((S, rows_per), nd, dtype=np.int32)
        for s in range(S):
            lo = min(s * rows_per, n_rows)
            hi = min((s + 1) * rows_per, n_rows)
            seg = csr.indices[csr.indptr[lo]: csr.indptr[hi]]
            if len(seg):
                pos = np.searchsorted(tgt, seg)
                pc = np.clip(pos, 0, max(nd - 1, 0))
                erank[s, : len(seg)] = np.where(
                    (nd > 0) & (tgt[pc] == seg), pc, nd)
            subs = csr.subjects[lo:hi]
            if len(subs):
                pos = np.searchsorted(tgt, subs)
                pc = np.clip(pos, 0, max(nd - 1, 0))
                rrank[s, : len(subs)] = np.where(
                    (nd > 0) & (tgt[pc] == subs), pc, nd)
        erank_d = [t.long() for t in csr.mesh.shard_put(erank)]
        rrank_d = [t.long() for t in csr.mesh.shard_put(rrank)]
        self._dense[key] = (csr, tgt, erank_d, rrank_d)
        while len(self._dense) > self._DENSE_CACHE:
            self._dense.popitem(last=False)
        return erank_d, rrank_d

    def _dense_set_mask(self, s: np.ndarray, tgt: np.ndarray) -> list:
        """One allow-set as a replicated bool[nd + 1] rank mask (tail slot
        False for padding takes); identity-cached per (set, rank-space)."""
        key = (id(s), id(tgt))
        hit = self._dev_sets.get(key)
        if hit is not None and hit[0] is s and hit[1] is tgt:
            self._dev_sets.move_to_end(key)
            return hit[2]
        nd = len(tgt)
        m = np.zeros(nd + 1, dtype=bool)
        if nd and len(s):
            pos = np.searchsorted(s, tgt)
            pc = np.clip(pos, 0, len(s) - 1)
            m[:nd] = s[pc] == tgt
        dev = self.mesh.put(m)
        self._dev_sets[key] = (s, tgt, dev)
        while len(self._dev_sets) > self._DEVSET_CACHE:
            self._dev_sets.popitem(last=False)
        return dev

    def _local_ptr(self, csr: DistPredCSR) -> list:
        """Per shard [rows_per + 1] local row→edge offsets (the pagination
        window's row boundaries)."""
        lp = getattr(csr, "_local_ptr", None)
        if lp is not None:
            return lp
        S = csr.mesh.shape["shard"]
        rows_per = csr.rows_per
        n_rows = len(csr.subjects)
        out = np.zeros((S, rows_per + 1), dtype=np.int32)
        for s in range(S):
            lo = min(s * rows_per, n_rows)
            hi = min((s + 1) * rows_per, n_rows)
            base = int(csr.indptr[lo])
            out[s, : hi - lo + 1] = csr.indptr[lo: hi + 1] - base
            out[s, hi - lo + 1:] = out[s, hi - lo]
        lp = [t.long() for t in csr.mesh.shard_put(out)]
        csr._local_ptr = lp
        return lp

    # -- whole-plan fused program: N hops + filters + pagination, ONE run ----

    def _plan_program(self, fcap0: int, meta: tuple, term: tuple = None):
        """meta: per hop (ecap, rows_per, nd, formula, nsets, has_pag). The
        program returns ONLY the per-hop dest rank masks (replicated bool
        [nd]) and raw edge totals — the host replays uidMatrix rows from
        its own mirrors.

        term: optional (ecap, rows_per, ndt, ops) TERMINAL segmented-reduce
        stage (fusedplan.TerminalIR): the groupby key tablet expands from
        the final hop's mask and reduces per key-target rank — int32
        member counts plus one (f32 candidate, f32 valid-count) pair per
        __agg_* op, in the same single run."""
        key = ("plan", fcap0, meta, term)
        prog = self._progs.get(key)
        if prog is not None:
            return prog
        self._built("mesh.plan", key)
        mesh = self.mesh
        S = self.n_devices

        def run(sub0, hops, tstage, fr0):
            outs = []
            mext = None
            for h, ((_ecap, rows_per, nd, formula, _ns, has_pag),
                    hp) in enumerate(zip(meta, hops)):
                packs = []
                for s in range(S):
                    if h:
                        act = _relay(mext[s], hp["prow"][s])
                    else:
                        act = _row_mask(_local_rows(sub0[s], fr0[s]),
                                        rows_per)
                    erow = hp["erow"][s]
                    ae = act[erow]                            # [ecap]
                    keep = ae
                    if formula is not None:
                        er = hp["erank"][s]
                        keep = keep & eval_formula_np(
                            formula, [m_[s][er] for m_ in hp["sets"]])
                    if has_pag:
                        keep = _pag_window_dense(
                            keep, hp["lptr"][s], erow, rows_per,
                            hp["first"], hp["offset"])
                    E = hp["edges"][s]
                    contrib = _rank_counts(hp["erank"][s][:E], keep[:E],
                                           nd + 1)
                    trav = ae.sum(dtype=torch.int32)
                    packs.append(torch.cat([contrib[:nd], trav[None]]))
                tot = mesh.psum(packs)[0]                     # the ONE hop
                mask = tot[:nd] > 0
                outs += [mask, tot[nd]]
                mext = mesh.replicate(torch.cat(
                    [mask, torch.zeros(1, dtype=torch.bool,
                                       device=mask.device)]))
            if term is not None:
                _ecap_t, _rows_per_t, ndt, ops = term
                cnts, acts = [], []
                for s in range(S):
                    E = tstage["edges"][s]
                    act = _relay(mext[s], tstage["prow"][s])
                    ae = act[tstage["erow"][s][:E]]           # real edges
                    acts.append(ae)
                    cnt = _rank_counts(tstage["erank"][s][:E], ae, ndt + 1)
                    cnts.append(torch.cat([cnt[:ndt],
                                           ae.sum(dtype=torch.int32)[None]]))
                cnt = mesh.psum(cnts)[0]
                outs += [cnt[:ndt], cnt[ndt]]
                for a, op in enumerate(ops):
                    cands, cntvs = [], []
                    for s in range(S):
                        E = tstage["edges"][s]
                        v = tstage["avals"][a][s][tstage["erow"][s][:E]]
                        ok = acts[s] & ~torch.isnan(v)
                        # a dropped edge adds its op's identity to its own
                        # rank (the JAX program sends it to the dump slot)
                        iv = tstage["erank"][s][:E]
                        if op == "min":
                            c = torch.full((ndt + 1,), float("inf"),
                                           dtype=torch.float32,
                                           device=v.device).scatter_reduce(
                                0, iv, torch.where(ok, v, float("inf")),
                                "amin")
                        elif op == "max":
                            c = torch.full((ndt + 1,), float("-inf"),
                                           dtype=torch.float32,
                                           device=v.device).scatter_reduce(
                                0, iv, torch.where(ok, v, float("-inf")),
                                "amax")
                        else:     # sum / avg share the f32 sum candidate
                            c = torch.zeros((ndt + 1,), dtype=torch.float32,
                                            device=v.device).index_add_(
                                0, iv, torch.where(ok, v, 0.0))
                        cands.append(c)
                        cntvs.append(torch.zeros(
                            (ndt + 1,), dtype=torch.float32,
                            device=v.device).index_add_(
                            0, iv, ok.to(torch.float32)))
                    fold = {"min": mesh.pmin, "max": mesh.pmax}.get(
                        op, mesh.psum)
                    outs += [fold(cands)[0][:ndt], mesh.psum(cntvs)[0][:ndt]]
            return outs

        self._progs[key] = run
        return run

    def run_plan(self, hops: list, seeds: np.ndarray, terminal=None):
        """Execute a whole fused chain — root frontier through every hop's
        filter/pagination/expansion — as ONE mesh program.

        hops: list of (csr, formula, sets, first, offset) where formula /
        sets come from fusedplan (sets are sorted int64 host arrays).
        Returns one (frontier_in, traversed, next_frontier) per hop; the
        caller replays the pruned uidMatrix rows from the host mirrors
        (fusedplan.replay_hop).

        terminal: optional (csr, ops, avals) groupby/aggregation stage
        (fusedplan.TerminalIR) — csr is the key predicate's tablet, ops a
        tuple of agg op names, avals one host f32 [S, rows_per] value
        plane per op (NaN = subject has no value). When given, returns
        (levels, {"table", "counts", "traversed", "aggs"})."""
        seeds = np.asarray(seeds, dtype=np.int64)
        fcap0 = _fcap_for(len(seeds))
        meta = []
        hop_args: list = []
        tgts = []
        prev_tgt = None
        for h, (csr, formula, sets, first, offset) in enumerate(hops):
            tgt = _target_table(csr)
            tgts.append(tgt)
            erank, _rrank = self._dense_maps(csr, tgt)
            has_pag = bool(first or offset)
            meta.append((csr.ecap, csr.rows_per, len(tgt), formula,
                         len(sets), has_pag))
            hp = {"erow": _edge_rows(csr), "erank": erank,
                  "edges": csr.shard_edges,
                  "sets": [self._dense_set_mask(s, tgt) for s in sets]}
            if h:
                hp["prow"] = self._dense_maps(csr, prev_tgt)[1]
            if has_pag:
                hp.update(lptr=self._local_ptr(csr),
                          first=int(first), offset=int(offset))
            hop_args.append(hp)
            prev_tgt = tgt
        term = None
        tstage = None
        tgt_t = None
        if terminal is not None:
            tcsr, ops, avals = terminal
            tgt_t = _target_table(tcsr)
            erank_t, _ = self._dense_maps(tcsr, tgt_t)
            _er2, prow_t = self._dense_maps(tcsr, prev_tgt)
            term = (tcsr.ecap, tcsr.rows_per, len(tgt_t), tuple(ops))
            tstage = {"erow": _edge_rows(tcsr), "erank": erank_t,
                      "prow": prow_t, "edges": tcsr.shard_edges,
                      "avals": [self.mesh.shard_put(
                          np.asarray(av, dtype=np.float32))
                          for av in avals]}
        fr0 = self.mesh.put(pad_frontier(seeds, fcap0))
        prog = self._plan_program(fcap0, tuple(meta), term)
        with otrace.span("device_kernel", kernel="mesh.plan",
                         hops=len(hops), terminal=bool(term),
                         devices=self.n_devices) as sp:
            flat = prog(hops[0][0].sharded.subjects, hop_args, tstage, fr0)
            flat = [t.cpu().numpy() for t in flat]   # ONE fetch, at the end
            self._c_dispatch.inc()
            self._c_hops.inc(len(hops))
            levels = []
            frontier = seeds
            total = 0
            for h in range(len(hops)):
                mask, trav = flat[2 * h], int(flat[2 * h + 1])
                nxt = tgts[h][mask].astype(np.int64)
                total += trav
                otrace.event("mesh_hop", hop=h, edges=trav,
                             frontier=len(frontier), dest=len(nxt))
                levels.append((frontier, trav, nxt))
                frontier = nxt
            term_out = None
            if term is not None:
                base = 2 * len(hops)
                counts = np.asarray(flat[base], dtype=np.int64)
                ttrav = int(flat[base + 1])
                total += ttrav
                aggs = [(flat[base + 2 + 2 * a], flat[base + 3 + 2 * a])
                        for a in range(len(term[3]))]
                otrace.event("mesh_hop", hop=len(hops), edges=ttrav,
                             frontier=len(frontier),
                             dest=int(np.count_nonzero(counts)),
                             terminal=True)
                term_out = {"table": tgt_t.astype(np.int64),
                            "counts": counts, "traversed": ttrav,
                            "aggs": aggs}
            self._c_edges.inc(total)
            if sp:
                sp.set(edges=total)
        if terminal is not None:
            return levels, term_out
        return levels

    # -- fused @recurse: edge-dedup levels, ONE run --------------------------

    def _recurse_prog(self, key_meta: tuple):
        (_ecap, rows_per, nd, _fcap0, depth, allow_loop, formula,
         _nsets) = key_meta
        key = ("recurse", key_meta)
        prog = self._progs.get(key)
        if prog is not None:
            return prog
        self._built("mesh.recurse", key)
        mesh = self.mesh
        S = self.n_devices

        def run(sub, erow, erank, rrank, edges, sets, fr0):
            acts = [_row_mask(_local_rows(sub[s], fr0[s]), rows_per)
                    for s in range(S)]
            seen = [torch.zeros_like(erow[s], dtype=torch.bool)
                    for s in range(S)]
            masks, tots = [], []
            for _lvl in range(depth):
                packs = []
                for s in range(S):
                    ae = acts[s][erow[s]]                     # [ecap]
                    if allow_loop:
                        fresh_e = ae
                    else:
                        fresh_e = ae & ~seen[s]               # edge-dedup
                        seen[s] |= ae                         # (recurse.go:129)
                    contrib = _rank_counts(erank[s][:edges[s]],
                                           fresh_e[:edges[s]], nd + 1)
                    packs.append(torch.cat(
                        [contrib[:nd], ae.sum(dtype=torch.int32)[None]]))
                tot = mesh.psum(packs)[0]
                mask = tot[:nd] > 0
                if formula is not None:
                    # classic recurse filters the NEXT frontier
                    # (child.dest_uids), never the matrix rows
                    mask = mask & eval_formula_np(
                        formula, [s_[0][:nd] for s_ in sets])
                masks.append(mask)
                tots.append(tot[nd])
                mext = mesh.replicate(torch.cat(
                    [mask, torch.zeros(1, dtype=torch.bool,
                                       device=mask.device)]))
                acts = [_relay(mext[s], rrank[s]) for s in range(S)]
            return torch.stack(masks), torch.stack(tots)

        self._progs[key] = run
        return run

    def run_recurse(self, csr: DistPredCSR, seeds: np.ndarray, depth: int,
                    allow_loop: bool, formula: tuple | None = None,
                    sets: list | None = None):
        """All `depth` edge-dedup recurse levels in ONE run: per level,
        each shard masks its first-traversal edges against a carried seen
        vector, the fresh target-rank contributions merge in ONE psum, and
        the child filter's allow-set formula narrows the frontier mask
        on the device. The masks stay on the device until one fetch at the
        end. Returns one (frontier, traversed) per level; matrices replay
        from the host mirrors (query/recurse.py)."""
        seeds = np.asarray(seeds, dtype=np.int64)
        tgt = _target_table(csr)
        nd = len(tgt)
        fcap0 = _fcap_for(len(seeds))
        erank, rrank = self._dense_maps(csr, tgt)
        devsets = [self._dense_set_mask(s, tgt) for s in (sets or [])]
        prog = self._recurse_prog((csr.ecap, csr.rows_per, nd, fcap0,
                                   depth, allow_loop, formula,
                                   len(devsets)))
        with otrace.span("device_kernel", kernel="mesh.recurse",
                         depth=depth, devices=self.n_devices) as sp:
            masks, tots = prog(csr.sharded.subjects, _edge_rows(csr), erank,
                               rrank, csr.shard_edges, devsets,
                               self.mesh.put(pad_frontier(seeds, fcap0)))
            masks, tots = masks.cpu().numpy(), tots.cpu().numpy()
            self._c_dispatch.inc()
            self._c_hops.inc(depth)
            levels = []
            frontier = seeds
            total = 0
            for lvl in range(depth):
                trav = int(tots[lvl])
                total += trav
                otrace.event("mesh_hop", hop=lvl, edges=trav,
                             frontier=len(frontier))
                levels.append((frontier, trav))
                frontier = tgt[masks[lvl]].astype(np.int64)
            self._c_edges.inc(total)
            if sp:
                sp.set(edges=total)
        return levels

    # -- fused shortest-path BFS: the whole expandOut loop, ONE run ----------

    def bfs_targets(self, csrs: list[DistPredCSR]) -> np.ndarray:
        """Combined sorted distinct-target table of a multi-predicate
        traversal — the rank space of the BFS distance vector (cached per
        CSR identity tuple)."""
        key = tuple(id(c) for c in csrs)
        hit = self._bfs_tgt.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], csrs)):
            self._bfs_tgt.move_to_end(key)
            return hit[1]
        tgt = (np.unique(np.concatenate(
            [_target_table(c) for c in csrs]))
            if csrs else np.zeros(0, np.int32))
        self._bfs_tgt[key] = (tuple(csrs), tgt)
        while len(self._bfs_tgt) > 64:
            self._bfs_tgt.popitem(last=False)
        return tgt

    BFS_UNREACHED = np.int32(np.iinfo(np.int32).max)

    def _bfs_program(self, shapes: tuple, nd: int):
        """shapes: per pred (ecap, rows_per)."""
        key = ("bfs", shapes, nd)
        prog = self._progs.get(key)
        if prog is not None:
            return prog
        self._built("mesh.bfs", key)
        mesh = self.mesh
        S = self.n_devices
        P_n = len(shapes)

        def run(preds, vis, dist, src, maxd, budget, stop):
            lead = mesh.leader
            srcs = mesh.put(np.asarray([src], dtype=np.int32))
            acts = []
            for p in range(P_n):
                sub = preds[p]["sub"]
                rows_per = shapes[p][1]
                per = []
                for s in range(S):
                    pos = torch.searchsorted(sub[s], srcs[s])
                    posc = torch.clamp(pos, 0, rows_per - 1)
                    ok = sub[s][posc] == srcs[s]
                    per.append(_row_mask(torch.where(ok, posc, SNT),
                                         rows_per))
                acts.append(per)
            stop_c = min(max(stop, 0), max(nd - 1, 0))
            hop = 0
            edges = torch.zeros((), dtype=torch.int64, device=lead)
            # the first test reads host values only: live, hop 0, edges 0
            go = (0 < maxd) and (0 <= budget) and \
                not (stop >= 0 and bool(vis[stop_c]))
            vis = torch.from_numpy(vis).to(lead)
            dist = torch.from_numpy(dist).to(lead)
            while go:
                packs = []
                for s in range(S):
                    contrib = torch.zeros((nd + 1,), dtype=torch.int32,
                                          device=preds[0]["erow"][s].device)
                    for p in range(P_n):
                        ae = acts[p][s][preds[p]["erow"][s]]
                        E = preds[p]["edges"][s]
                        contrib += _rank_counts(preds[p]["erank"][s][:E],
                                                ae[:E], nd + 1)
                        # the JAX scatter puts every inactive edge (padding
                        # included) into slot nd and then adds the active
                        # count there too: slot nd is the padded edge slots
                        contrib[nd] += shapes[p][0]
                    packs.append(contrib)
                tot = mesh.psum(packs)[0]
                gmask = tot[:nd] > 0
                fresh = gmask & ~vis
                vis = vis | gmask
                dist = torch.where(fresh, hop + 1, dist)
                fext = mesh.replicate(torch.cat(
                    [fresh, torch.zeros(1, dtype=torch.bool,
                                        device=fresh.device)]))
                acts = [[_relay(fext[s], preds[p]["rrank"][s])
                         for s in range(S)] for p in range(P_n)]
                hop += 1
                edges = edges + tot[nd]
                cond = fresh.any() & (edges <= budget)
                if stop >= 0:
                    cond = cond & ~vis[stop_c]
                self.loop_reads["bfs"] += 1
                go = hop < maxd and bool(cond.item())
            return dist, hop, edges

        self._progs[key] = run
        return run

    def run_bfs(self, csrs: list[DistPredCSR], src: int, max_depth: int,
                budget: int, stop_at: int | None = None):
        """The whole shortest-path expandOut loop (query/shortest.go:134)
        as ONE program: frontier masks, visited set, and distance vector
        stay on the device between levels; the host reads the loop's
        condition once a level.

        Returns (dist, hops, edges): dist[i] is the BFS level at which the
        combined target table's i-th uid was first reached (UNREACHED
        otherwise), hops the number of levels executed, edges the loop's
        edge total (the padded edge slots of every shard, once a level, as
        the JAX program counts them)."""
        tgt = self.bfs_targets(csrs)
        nd = len(tgt)
        if nd == 0:
            return (np.zeros(0, np.int32), 0, 0)
        shapes = tuple((c.ecap, c.rows_per) for c in csrs)
        prog = self._bfs_program(shapes, nd)
        vis = np.zeros(nd, dtype=bool)
        dist = np.full(nd, int(self.BFS_UNREACHED), dtype=np.int32)
        pos = int(np.searchsorted(tgt, src))
        if pos < nd and tgt[pos] == src:
            vis[pos] = True
            dist[pos] = 0
        preds = []
        for c in csrs:
            erank, rrank = self._dense_maps(c, tgt)
            preds.append({"sub": c.sharded.subjects, "erow": _edge_rows(c),
                          "erank": erank, "rrank": rrank,
                          "edges": c.shard_edges})
        stop_rank = -1
        if stop_at is not None:
            sp_ = int(np.searchsorted(tgt, stop_at))
            if sp_ < nd and tgt[sp_] == stop_at:
                stop_rank = sp_
        with otrace.span("device_kernel", kernel="mesh.bfs",
                         devices=self.n_devices, preds=len(csrs),
                         nd=nd) as sp:
            dist_d, hops_h, edges_d = prog(
                preds, vis, dist, min(src, SNT), int(max_depth),
                min(budget, (1 << 30)), stop_rank)
            dist_h = dist_d.cpu().numpy()
            edges_h = int(edges_d)
            self._c_dispatch.inc()
            self._c_hops.inc(int(hops_h))
            self._c_edges.inc(edges_h)
            otrace.event("mesh_hop", hop=int(hops_h), edges=edges_h)
            if sp:
                sp.set(edges=edges_h, hops=int(hops_h))
        return dist_h, int(hops_h), edges_h

    # -- sharded vector top-k: row-scan fan-out, replicated merge ------------

    def _vec_program(self, rows_per: int, dim: int, kk: int, metric: str):
        key = ("vec", rows_per, dim, kk, metric)
        prog = self._progs.get(key)
        if prog is not None:
            return prog
        self._built("mesh.vector_topk", key)
        mesh = self.mesh
        S = self.n_devices

        def run(mat, nrm, valid, qv):
            from dgraph_tpu_torch.ops.vector import (_check_fp32, _neg_dist,
                                                     _stable_topk)

            cs_all, rows_all = [], []
            for s in range(S):
                _check_fp32(mat[s])
                nd = _neg_dist(mat[s], nrm[s], qv[s][None, :], metric)[0]
                nd = torch.where(valid[s], nd, float("-inf"))
                # ties to the lower row: the int64 (score, -row) key
                cs, ci = _stable_topk(nd, kk)
                cs_all.append(cs)
                rows_all.append((s * rows_per + ci).to(torch.int32))
            # the replicated top-k merge: the host takes the union as the
            # candidate superset (global top-kk ⊆ union by construction)
            gs = mesh.all_gather(cs_all)[0]
            gr = mesh.all_gather(rows_all)[0]
            return gs.reshape(-1), gr.reshape(-1)

        self._progs[key] = run
        return run

    def _vec_sharded(self, vi):
        dev = getattr(vi, "_mesh_dev", None)
        if dev is not None:
            return dev
        from dgraph_tpu_torch.ops.vector import row_capacity

        nd = self.n_devices
        # ceil-division shard rows (dist.shard_rows_per convention): a
        # non-pow2 device count must still tile the pow2 row capacity
        rows_per = -(-max(row_capacity(vi.n), nd) // nd)
        R = rows_per * nd
        mat = np.zeros((nd, rows_per, vi.dim), dtype=np.float32)
        mat.reshape(R, vi.dim)[: vi.n] = vi.vecs
        nrm = np.ones((nd, rows_per), dtype=np.float32)
        nrm.reshape(R)[: vi.n] = np.linalg.norm(vi.vecs, axis=1)
        dev = (self.mesh.shard_put(mat), self.mesh.shard_put(nrm),
               R, rows_per)
        vi._mesh_dev = dev
        return dev

    def vector_topk(self, vi, q: np.ndarray, kprime: int,
                    dead_rows: np.ndarray) -> np.ndarray:
        """Float32 candidate rows of one similarity probe, row-sharded
        across the mesh (storage/vecindex.search's device stage; the
        float64 re-rank stays on the host, so mesh results are
        byte-identical to the single-device path)."""
        mat, nrm, R, rows_per = self._vec_sharded(vi)
        valid = np.zeros(R, dtype=bool)
        valid[: vi.n] = True
        if len(dead_rows):
            valid[dead_rows] = False
        vdev = self.mesh.shard_put(valid.reshape(self.n_devices, rows_per))
        kk = min(kprime, rows_per)
        prog = self._vec_program(rows_per, vi.dim, kk, vi.metric)
        with otrace.span("device_kernel", kernel="mesh.vector_topk",
                         rows=int(vi.n), k=kk,
                         devices=self.n_devices) as sp:
            scores, rows = prog(mat, nrm, vdev,
                                self.mesh.put(q.astype(np.float32)))
            scores_h, rows_h = scores.cpu().numpy(), rows.cpu().numpy()
            self._c_dispatch.inc()
            self.metrics.counter(
                "dgraph_vector_mesh_dispatches_total").inc()
            if sp:
                sp.set(cands=int((scores_h > -np.inf).sum()))
        return rows_h[scores_h > -np.inf]

    # -- whole-graph analytics: device-resident loops -------------------------
    #
    # PageRank / connected components iterate on the device (the run_bfs
    # idiom: edge-sharded scatter + ONE collective per iteration, the
    # condition read once an iteration); only the converged vector crosses
    # to the host. Edges arrive as rank pairs into a node table built by
    # query/analytics.graph_arrays; padding edges scatter into a dump slot
    # (edst = ncap) that is sliced off.

    def _shard_edges(self, esrc: np.ndarray, edst: np.ndarray, ncap: int):
        S = self.n_devices
        E = len(esrc)
        epc = _fcap_for(-(-E // S) if E else 1)
        es = np.zeros((S, epc), dtype=np.int32)
        ed = np.full((S, epc), ncap, dtype=np.int32)
        es.reshape(-1)[:E] = esrc
        ed.reshape(-1)[:E] = edst
        # the programs read each shard's real edges only: the padding's
        # scatters into the dump slot (dropped in the JAX programs, and
        # millions of atomic adds on one address here) change nothing kept
        real = [min(epc, max(E - s * epc, 0)) for s in range(S)]
        return ([t.long()[:n] for t, n in zip(self.mesh.shard_put(es), real)],
                [t.long()[:n] for t, n in zip(self.mesh.shard_put(ed), real)],
                epc)

    def _pagerank_program(self, epc: int, ncap: int):
        key = ("pagerank", epc, ncap)
        pr_prog = self._progs.get(key)
        if pr_prog is not None:
            return pr_prog
        self._built("mesh.pagerank", key)
        mesh = self.mesh
        S = self.n_devices

        def run(esrc, edst, outdeg, dangling, live, r, n, damping, tol,
                maxit):
            it = 0
            go = maxit > 0
            while go:
                parts = []
                for s in range(S):
                    w = r[s][esrc[s]] / outdeg[s][esrc[s]]
                    parts.append(torch.zeros(
                        (ncap + 1,), dtype=torch.float32,
                        device=w.device).index_add_(0, edst[s], w))
                contrib = mesh.psum(parts)[0][:ncap]
                rl = r[0]
                dang = torch.sum(rl * dangling[0])
                new = torch.where(
                    live[0] > 0,
                    (1.0 - damping) / n + damping * (contrib + dang / n),
                    torch.zeros((), dtype=torch.float32, device=rl.device))
                delta = torch.sum(torch.abs(new - rl))
                r = mesh.replicate(new)
                it += 1
                self.loop_reads["pagerank"] += 1
                go = it < maxit and bool((delta > tol).item())
            return r[0], it

        self._progs[key] = run
        return run

    def run_pagerank(self, esrc: np.ndarray, edst: np.ndarray, n: int, *,
                     damping: float = 0.85, tol: float = 1e-6,
                     max_iters: int = 100):
        """Power iteration over rank-space edges, edge-sharded across the
        mesh. esrc/edst: int32[E] node ranks (0..n). Returns (float32[n]
        ranks, iterations). The f32 iterate (its atomic sum order differs
        from XLA's and between runs) is held to the float64 host oracle
        within tolerance, not bitwise."""
        ncap = _fcap_for(max(n, 1))
        es, ed, epc = self._shard_edges(esrc, edst, ncap)
        outdeg = np.zeros(ncap, dtype=np.float32)
        deg = np.bincount(esrc, minlength=n).astype(np.float32) \
            if len(esrc) else np.zeros(n, np.float32)
        outdeg[:n] = deg[:n]
        dangling = np.zeros(ncap, dtype=np.float32)
        dangling[:n] = (outdeg[:n] == 0).astype(np.float32)
        outdeg = np.maximum(outdeg, 1.0)
        live = np.zeros(ncap, dtype=np.float32)
        live[:n] = 1.0
        rank0 = np.zeros(ncap, dtype=np.float32)
        rank0[:n] = 1.0 / max(n, 1)
        pr_prog = self._pagerank_program(epc, ncap)
        f32 = np.float32
        with otrace.span("device_kernel", kernel="mesh.pagerank",
                         nodes=n, edges=len(esrc),
                         devices=self.n_devices) as sp:
            r, it = pr_prog(es, ed, self.mesh.put(outdeg),
                            self.mesh.put(dangling), self.mesh.put(live),
                            self.mesh.put(rank0),
                            torch.tensor(f32(max(n, 1))),
                            torch.tensor(f32(damping)),
                            torch.tensor(f32(tol)), int(max_iters))
            r_h = r.cpu().numpy()[:n].copy()
            self._c_dispatch.inc()
            self._c_edges.inc(len(esrc) * int(it))
            if sp:
                sp.set(iterations=int(it))
        return r_h, int(it)

    def _cc_program(self, epc: int, ncap: int):
        key = ("cc", epc, ncap)
        cc_prog = self._progs.get(key)
        if cc_prog is not None:
            return cc_prog
        self._built("mesh.cc", key)
        mesh = self.mesh
        S = self.n_devices

        def run(esrc, edst, lab, maxit):
            it = 0
            go = maxit > 0
            while go:
                parts = []
                for s in range(S):
                    ls = lab[s]
                    # clip-mode takes, as in the JAX program
                    le = ls[torch.clamp(esrc[s], 0, ncap - 1)]
                    te = ls[torch.clamp(edst[s], 0, ncap - 1)]
                    cand = torch.full((ncap + 1,), ncap, dtype=torch.int32,
                                      device=ls.device)
                    cand = cand.scatter_reduce(0, edst[s], le, "amin")
                    cand = cand.scatter_reduce(0, esrc[s], te, "amin")
                    parts.append(cand)
                cand = mesh.pmin(parts)[0][:ncap]
                new = torch.minimum(lab[0], cand)
                changed = torch.any(new != lab[0])
                lab = mesh.replicate(new)
                it += 1
                self.loop_reads["cc"] += 1
                go = it < maxit and bool(changed.item())
            return lab[0], it

        self._progs[key] = run
        return run

    def run_cc(self, esrc: np.ndarray, edst: np.ndarray, n: int, *,
               max_iters: int = 0):
        """Min-label propagation (undirected: both edge directions each
        iteration) until fixpoint. Returns (int32[n] labels — the minimum
        node rank of each component, so EXACT vs any host oracle,
        iterations)."""
        ncap = _fcap_for(max(n, 1))
        es, ed, epc = self._shard_edges(esrc, edst, ncap)
        lab0 = np.arange(ncap, dtype=np.int32)
        maxit = max_iters or (n + 2)
        cc_prog = self._cc_program(epc, ncap)
        with otrace.span("device_kernel", kernel="mesh.cc",
                         nodes=n, edges=len(esrc),
                         devices=self.n_devices) as sp:
            lab, it = cc_prog(es, ed, self.mesh.put(lab0), int(maxit))
            l_h = lab.cpu().numpy()[:n].copy()
            self._c_dispatch.inc()
            self._c_edges.inc(2 * len(esrc) * int(it))
            if sp:
                sp.set(iterations=int(it))
        return l_h, int(it)

    def _tri_program(self, rows_per: int, ncap: int):
        key = ("tri", rows_per, ncap)
        tri_prog = self._progs.get(key)
        if tri_prog is not None:
            return tri_prog
        self._built("mesh.triangles", key)
        mesh = self.mesh
        S = self.n_devices

        def run(arow, afull):
            from dgraph_tpu_torch.ops.vector import _check_fp32

            parts = []
            for s in range(S):
                _check_fp32(arow[s])
                # trace(A^3) row-sharded: each shard contracts its row
                # block against the replicated adjacency. The products are
                # exact small integers in float32 (at most ncap <= 2**24);
                # their sum is taken in float64 so it stays exact past
                # 2**24 (the JAX program's float32 sum does not)
                b = arow[s] @ afull[s]
                parts.append(torch.sum(arow[s] * b, dtype=torch.float64))
            return mesh.psum(parts)[0]

        self._progs[key] = run
        return run

    def run_triangles(self, esrc: np.ndarray, edst: np.ndarray, n: int):
        """Dense trace(A^3)/6 on the mesh — row-sharded matmul over the
        symmetrized 0/1 adjacency, exact; the caller gates on n (dense A
        is O(n^2) replicated)."""
        S = self.n_devices
        ncap = max(_fcap_for(max(n, 1)), S)
        a = np.zeros((ncap, ncap), dtype=np.float32)
        a[esrc, edst] = 1.0
        a[edst, esrc] = 1.0
        np.fill_diagonal(a, 0.0)
        rows_per = ncap // S
        arow = self.mesh.shard_put(a.reshape(S, rows_per, ncap))
        tri_prog = self._tri_program(rows_per, ncap)
        with otrace.span("device_kernel", kernel="mesh.triangles",
                         nodes=n, edges=len(esrc),
                         devices=self.n_devices) as sp:
            t_h = float(tri_prog(arow, self.mesh.put(a)))
            self._c_dispatch.inc()
            self._c_edges.inc(len(esrc))
            tri = int(round(t_h / 6.0))
            if sp:
                sp.set(triangles=tri)
        return tri
