"""@recurse: iterative frontier expansion to fixed depth or exhaustion.

Port of dgraph_tpu/query/recurse.py.
Reference semantics: query/recurse.go — expandRecurse (:31-177): loop per
level, spawning copies of the original children as the new frontier's
SubGraphs (:157-164); loop prevention via a reach-set of (attr, from, to)
edges (:129-141) unless `loop: true`; bounded by the edge budget (:167).

  * Large CSRs run the active-prefix kernels (ops/pull_bfs over
    ops/prefix): per level, the kernel streams the dst-sorted edge array
    against the frontier; the fused per-edge prefix yields active flags and
    edge dedup is two masks on the device (fresh = active & ~seen,
    seen |= active) plus a node-sized bounds diff for the next frontier.
    A single uid child with no filter and no value children runs every
    level in one recurse_fused call; other shapes take one recurse_step per
    level and fetch their value children at every level. uidMatrix rows
    stay deferred (LazyRecurseMatrix). Concurrent compatible fused
    recurses pack into one multi-source run through the device batcher
    (Executor.batched_recurse, query/batch.py).
  * Small CSRs keep the vectorized host-mirror gather.
  * Mesh-sharded tablets (parallel/mesh_exec.py): a single uid child runs
    every level in one mesh program (its filter compiles to an allow-set
    formula; value children layer host-side per level); other shapes
    expand per task with (attr, from, to) edge-key dedup, as the wire
    path does.
"""

from __future__ import annotations

import numpy as np
import torch

from dgraph_tpu_torch.obs import costs
from dgraph_tpu_torch.ops import pull_bfs as pb
from dgraph_tpu_torch.query.engine import QueryError, SubGraph
from dgraph_tpu_torch.query.task import TaskQuery
from dgraph_tpu_torch.utils.types import TypeID

# kernel-path admission by edge count: a path choice, never an output.
# Tests set KERNEL_MIN_EDGES to 0 to force the kernels (their plain versions
# on the CPU). On CUDA tensors the kernels are admitted from
# _KERNEL_MIN_CUDA edges: on an H100 (bench_torch_crossover.py) a depth-3
# recurse from 128 seeds ties the host mirror at R-MAT scale 10 (12,104
# edges) and runs 3.6x faster at scale 12 (53,425 edges). On the CPU the
# host mirror always wins by default.
KERNEL_MIN_EDGES: int | None = None       # None = device-dependent default
_KERNEL_MIN_CUDA = 1 << 14
FUSED_MAX_DEPTH = 8   # fresh-flag buffer is depth × E_pad bools


def _kernel_min(csr) -> int:
    if KERNEL_MIN_EDGES is not None:
        return KERNEL_MIN_EDGES
    if csr.device.type == "cuda":
        return _KERNEL_MIN_CUDA
    return 1 << 62


class FreshFlags:
    """Host cache of a traversal's per-edge fresh flags, shared by every
    level's LazyRecurseMatrix: one device pack + one bit-packed fetch for
    the whole [depth, E_pad] (or [E_pad]) buffer."""

    def __init__(self, fresh_dev: torch.Tensor):
        self._dev = fresh_dev            # [E_pad] or [depth, E_pad]
        self._h: np.ndarray | None = None

    def level(self, lvl) -> np.ndarray:
        if self._h is None:
            d = self._dev
            packed = pb.pack_mask(d.view(-1, d.shape[-1])).cpu().numpy()
            self._h = np.stack([pb.unpack_words(p, d.shape[-1])
                                for p in packed])
        return self._h[0] if self._dev.dim() == 1 else self._h[lvl]


class LazyRecurseMatrix:
    """A recurse level's uidMatrix in deferred CSR form: ragged per-source
    target lists are built on the host only when an encoder, cascade or
    count reads them."""

    def __init__(self, csr, g, frontier: np.ndarray, fresh: FreshFlags,
                 level, allow_loop: bool):
        self._csr = csr
        self._g = g
        self._frontier = np.asarray(frontier, dtype=np.int64)
        self._fresh = fresh
        self._level = level              # row of the stacked buffer, or None
        self._allow_loop = allow_loop
        self._rows: list[np.ndarray] | None = None

    def _materialize(self) -> list[np.ndarray]:
        if self._rows is not None:
            return self._rows
        pos, offs, targets = _gather_frontier_edges(self._csr, self._frontier)
        if self._allow_loop:
            keep = np.ones(len(pos), dtype=bool)
        else:
            fresh_h = self._fresh.level(self._level)
            keep = fresh_h[self._g.inv_order[pos]]
        self._rows = [targets[offs[i]: offs[i + 1]][keep[offs[i]: offs[i + 1]]]
                      for i in range(len(self._frontier))]
        return self._rows

    def __len__(self) -> int:
        return len(self._frontier)

    def __bool__(self) -> bool:
        return len(self._frontier) > 0

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())


class LazyCounts:
    """list-like per-source counts over a LazyRecurseMatrix."""

    def __init__(self, m: LazyRecurseMatrix):
        self._m = m

    def __len__(self) -> int:
        return len(self._m)

    def __bool__(self) -> bool:
        return len(self._m) > 0

    def __getitem__(self, i) -> int:
        return len(self._m._materialize()[i])

    def __iter__(self):
        return (len(r) for r in self._m._materialize())


def _gather_frontier_edges(csr, frontier: np.ndarray):
    """The frontier's CSR edge positions in one vectorized gather:
    (pos int64[total], offs int64[F+1], targets int64[total])."""
    from dgraph_tpu_torch.ops import uidset as us

    subjects, indptr, indices = csr.host_arrays()
    rows = us.host_rank_of(subjects, frontier, -1)
    ok = rows >= 0
    rc = np.where(ok, rows, 0)
    starts = np.where(ok, indptr[rc], 0).astype(np.int64)
    ends = np.where(ok, indptr[rc + 1], 0).astype(np.int64)
    counts = ends - starts
    total = int(counts.sum())
    offs = np.zeros(len(frontier) + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    pos = np.repeat(starts - offs[:-1], counts) + np.arange(total)
    return pos, offs, indices[pos].astype(np.int64)


def _expand_dedup(csr, frontier: np.ndarray, seen: np.ndarray,
                  allow_loop: bool) -> tuple[list[np.ndarray], int]:
    """One level with first-traversal edge dedup on the host: previously
    seen positions masked out, seen updated in place."""
    pos, offs, targets = _gather_frontier_edges(csr, frontier)
    total = len(pos)
    if allow_loop:
        fresh = np.ones(total, dtype=bool)
    else:
        fresh = ~seen[pos]
        seen[pos] = True
    matrix = [targets[offs[i]: offs[i + 1]][fresh[offs[i]: offs[i + 1]]]
              for i in range(len(frontier))]
    return matrix, total


def _dedup_task_edges(seen_keys: dict, attr: str, frontier: np.ndarray,
                      uid_matrix, allow_loop: bool) -> list[np.ndarray]:
    """First-traversal dedup of a per-task level on (attr, from, to) keys
    (reference recurse.go:129-141): an edge seen at an earlier level, or
    earlier in this one, is dropped unless loop is allowed. Vectorized:
    from and to pack into one int64 key and seen_keys[attr] holds the
    sorted keys seen so far; the kept targets are exactly a per-edge set
    walk's, in the same order. The uids of a folded uid tablet lie below
    2**31 - 1 (the fold refuses larger ones), so a task result past that
    range, from another process, is refused."""
    counts = np.fromiter((len(t) for t in uid_matrix), dtype=np.int64,
                         count=len(frontier))
    offs = np.zeros(len(frontier) + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    flat = (np.concatenate([np.asarray(t, dtype=np.int64)
                            for t in uid_matrix])
            if offs[-1] else np.zeros(0, np.int64))
    if allow_loop:
        keep = np.ones(len(flat), dtype=bool)
    else:
        src = np.repeat(np.asarray(frontier, dtype=np.int64), counts)
        if len(flat) and (min(src.min(), flat.min()) < 0
                          or max(src.max(), flat.max()) >= (1 << 31) - 1):
            raise QueryError(f"recurse over {attr!r}: an edge outside the "
                             f"uid space [0, 2**31 - 1)")
        keys = (src << 31) | flat
        # a sorted frontier over sorted rows gives increasing keys already
        order = (None if np.all(keys[1:] > keys[:-1])
                 else np.argsort(keys, kind="stable"))
        sk = keys if order is None else keys[order]
        first = np.ones(len(sk), dtype=bool)
        first[1:] = sk[1:] != sk[:-1]
        seen = seen_keys.get(attr, np.zeros(0, np.int64))
        if len(seen):
            at = np.minimum(np.searchsorted(seen, sk), len(seen) - 1)
            first &= seen[at] != sk
        if order is None:
            keep = first
        else:
            keep = np.empty(len(sk), dtype=bool)
            keep[order] = first
        seen_keys[attr] = np.sort(np.concatenate([seen, sk[first]]),
                                  kind="stable")
    return [flat[offs[i]: offs[i + 1]][keep[offs[i]: offs[i + 1]]]
            for i in range(len(frontier))]


def _set_list_result(child: SubGraph, matrix: list[np.ndarray]) -> None:
    """uidMatrix + per-source counts + merged dest set."""
    child.uid_matrix = matrix
    child.counts = [len(m) for m in matrix]
    child.dest_uids = (np.unique(np.concatenate(matrix))
                       if any(len(m) for m in matrix)
                       else np.zeros(0, np.int64))


def _seeds_mask(uids: np.ndarray, num_nodes: int,
                device: torch.device) -> torch.Tensor:
    sel = uids[uids < num_nodes].astype(np.int64)
    m = torch.zeros((num_nodes,), dtype=torch.bool, device=device)
    if len(sel):
        m[torch.from_numpy(sel).to(device)] = True
    return m


def recurse(ex, sg: SubGraph) -> None:
    gq = sg.gq
    spec = gq.recurse
    depth = spec.depth if spec.depth > 0 else 64  # "until exhaustion" cap
    uid_children = [c for c in gq.children
                    if ex.schema.type_of(c.attr) == TypeID.UID
                    or (ex.snap.pred(c.attr) is not None
                        and ex.snap.pred(c.attr).csr is not None)
                    or c.attr.startswith("~")]
    val_children = [c for c in gq.children if c not in uid_children]
    seen_masks: dict[str, np.ndarray] = {}     # host path: attr -> bool[E]
    kstates: dict[str, dict] = {}              # kernel path: attr -> g, seen
    seen_keys: dict[str, np.ndarray] = {}      # per-task path: attr -> keys
    edges = 0

    def _csr_for(cgq):
        attr = cgq.attr
        rev = attr.startswith("~")
        pd = ex.snap.pred(attr[1:] if rev else attr)
        if pd is None:
            return None
        return pd.rev_csr if rev else pd.csr

    def _use_kernel(csr) -> bool:
        return (csr is not None and not getattr(csr, "is_dist", False)
                and csr.num_edges >= _kernel_min(csr))

    def _kstate(attr: str, csr):
        st = kstates.get(attr)
        if st is None:
            g = pb.pull_graph_for(csr)
            st = kstates[attr] = {
                "g": g,
                "seen": torch.zeros((g.in_src_pad.shape[0],),
                                    dtype=torch.bool, device=g.device)}
        return st

    # ---- fused path: single uid child, no filter, no value children --------
    if (len(uid_children) == 1 and not val_children
            and uid_children[0].filter is None
            and depth <= FUSED_MAX_DEPTH and len(sg.dest_uids)):
        cgq = uid_children[0]
        csr = _csr_for(cgq)
        if _use_kernel(csr):
            _recurse_fused_path(ex, sg, cgq, csr, depth, spec.allow_loop)
            ex._record_uid_var(gq, sg)
            return
    # ---- mesh fused path: single uid child, filters compile to allow-set
    # formulas, value children layer host-side per level -------------------
    mesh = getattr(ex, "mesh", None)
    if mesh is not None and len(sg.dest_uids) and \
            any(mesh.owns(_csr_for(c)) for c in uid_children):
        from dgraph_tpu_torch.query import fusedplan as fp

        cgq = uid_children[0] if len(uid_children) == 1 else None
        if cgq is None:
            # multi-predicate recurse dedups edges in DEPTH-FIRST sibling
            # order (build_level recursion) — inherently sequential, the
            # one traversal shape the level-synchronous program can't hold
            ex._mesh_miss(fp.REASON_MULTI_PRED)
        elif depth > FUSED_MAX_DEPTH:
            ex._mesh_miss(fp.REASON_DEPTH)
        elif mesh.owns(_csr_for(cgq)):
            csr = _csr_for(cgq)
            formula = None
            sets: list | None = None
            ok = True
            if cgq.filter is not None:
                try:
                    formula, leaves = fp.compile_filter(
                        cgq.filter, ex.schema,
                        fp._block_child_defines(gq))
                    sets = [fp.resolve_leaf(ex, s) for s in leaves]
                except fp.Unfusable as e:
                    ex._mesh_miss(e.reason)
                    ok = False
                except Exception:
                    ex._mesh_miss(fp.REASON_FILTER)
                    ok = False
            if ok:
                _mesh_recurse_path(ex, sg, cgq, csr, depth,
                                   spec.allow_loop, mesh, formula, sets,
                                   val_children)
                ex._record_uid_var(gq, sg)
                return

    def build_level(frontier: np.ndarray, remaining: int) -> list[SubGraph]:
        nonlocal edges
        out: list[SubGraph] = []
        frontier = np.sort(frontier)
        # value/scalar children appear at every level
        for cgq in val_children:
            child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=frontier)
            res = ex._dispatch(TaskQuery(cgq.attr, frontier=frontier,
                                         lang=cgq.lang))
            child.value_matrix = res.value_matrix
            child.uid_matrix = res.uid_matrix
            child.counts = res.counts
            child.dest_uids = res.dest_uids
            out.append(child)
        if remaining <= 0:
            return out
        for cgq in uid_children:
            child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=frontier)
            csr = _csr_for(cgq)
            if _use_kernel(csr) and len(frontier):
                # kernel path: one stepped level
                st = _kstate(cgq.attr, csr)
                g = st["g"]
                fmask = _seeds_mask(frontier, g.num_nodes, g.device)
                with costs.kernel("pb.recurse_step", attr=cgq.attr):
                    dest_words, trav, seen2, fresh = ex.gated(
                        lambda: pb.recurse_step(
                            g.in_src_pad, g.in_iptr_rank, g.subjects,
                            g.in_subjects, fmask, st["seen"],
                            chunks=g.chunks, num_nodes=g.num_nodes,
                            allow_loop=spec.allow_loop),
                        klass="recurse")
                st["seen"] = seen2
                edges += int(trav)
                if edges > ex.edge_budget():
                    raise QueryError(
                        "recurse exceeded edge budget (ErrTooBig)")
                m = LazyRecurseMatrix(csr, g, frontier, FreshFlags(fresh),
                                      None, spec.allow_loop)
                child.uid_matrix = m
                child.counts = LazyCounts(m)
                child.dest_uids = np.flatnonzero(pb.unpack_words(
                    dest_words.cpu().numpy(), g.num_nodes)).astype(np.int64)
            elif csr is not None and not getattr(csr, "is_dist", False):
                # small CSR: vectorized host-mirror gather
                if cgq.attr not in seen_masks and len(frontier):
                    seen_masks[cgq.attr] = np.zeros(csr.num_edges, dtype=bool)
                matrix, total = (_expand_dedup(
                    csr, frontier, seen_masks.get(cgq.attr),
                    spec.allow_loop) if len(frontier)
                    else ([], 0))
                edges += total
                if edges > ex.edge_budget():
                    raise QueryError(
                        "recurse exceeded edge budget (ErrTooBig)")
                _set_list_result(child, matrix)
            else:
                # mesh-sharded, tablet-routed or missing adjacency: expand
                # per task through the dispatch seam (over the wire under
                # a ClusterClient), dedup on (attr, from, to) keys
                # (reference recurse.go:129-141)
                res = ex._dispatch(TaskQuery(cgq.attr, frontier=frontier))
                edges += res.traversed_edges
                if edges > ex.edge_budget():
                    raise QueryError(
                        "recurse exceeded edge budget (ErrTooBig)")
                _set_list_result(child, _dedup_task_edges(
                    seen_keys, cgq.attr, frontier, res.uid_matrix,
                    spec.allow_loop))
            child.dest_uids = ex._apply_filter(cgq.filter, child.dest_uids)
            if len(child.dest_uids):
                child.children = build_level(child.dest_uids, remaining - 1)
            out.append(child)
        return out

    sg.children = build_level(sg.dest_uids, depth)
    ex._record_uid_var(gq, sg)


def _mesh_recurse_path(ex, sg: SubGraph, cgq, csr, depth: int,
                       allow_loop: bool, mesh, formula=None, sets=None,
                       val_children=()) -> None:
    """All levels of a mesh-sharded recurse in ONE mesh program: the
    seen-edge vector lives per shard on the device across levels, the
    fresh dest ranks merge into the next frontier in one psum, and the
    child filter's allow-set formula narrows it device-side
    (mesh_exec.run_recurse — only replicated frontiers and edge totals
    come back). The SubGraph chain replays from the HOST mirrors
    (_expand_dedup, the same vectorized gather the classic small-CSR
    path runs), so matrices, filter narrowing, and value children are
    byte-identical to build_level's depth recursion by construction."""
    seeds = np.asarray(sg.dest_uids, dtype=np.int64)
    with costs.kernel("mesh.recurse", attr=cgq.attr):
        levels = ex.gated(lambda: mesh.run_recurse(csr, seeds, depth,
                                                   allow_loop, formula,
                                                   sets),
                          klass="mesh")
    ex._mesh_fused += 1
    seen = np.zeros(csr.num_edges, dtype=bool)
    attach = sg.children = []
    cum = 0
    frontier = seeds
    for lvl in range(depth + 1):
        fr_sorted = np.sort(frontier)
        cur: list[SubGraph] = []
        # value/scalar children appear at every level (build_level's
        # per-invocation head), including the depth-exhausted tail
        for vq in val_children:
            vchild = SubGraph(gq=vq, attr=vq.attr, src_uids=fr_sorted)
            res = ex._dispatch(TaskQuery(vq.attr, frontier=fr_sorted,
                                         lang=vq.lang))
            vchild.value_matrix = res.value_matrix
            vchild.uid_matrix = res.uid_matrix
            vchild.counts = res.counts
            vchild.dest_uids = res.dest_uids
            cur.append(vchild)
        child = None
        if depth - lvl > 0:
            matrix, total = _expand_dedup(csr, fr_sorted, seen,
                                          allow_loop)
            cum += total
            if cum > ex.edge_budget():
                raise QueryError("recurse exceeded edge budget (ErrTooBig)")
            child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=fr_sorted)
            _set_list_result(child, matrix)
            child.dest_uids = ex._apply_filter(cgq.filter,
                                               child.dest_uids)
            cur.append(child)
            # cross-check the device program's frontier relay against
            # the host replay (the host — which evaluates the REAL
            # filter tree — stays authoritative, so a divergence means
            # an allow-set resolver gap or a program bug: surfaced as a
            # counter, never a wrong result)
            if lvl + 1 < len(levels) and not np.array_equal(
                    levels[lvl + 1][0], child.dest_uids):
                mesh.metrics.counter(
                    "dgraph_mesh_replay_divergence_total").inc()
        attach.extend(cur)
        if child is None or not len(child.dest_uids):
            break
        attach = child.children
        frontier = child.dest_uids


def _recurse_fused_path(ex, sg: SubGraph, cgq, csr, depth: int,
                        allow_loop: bool) -> None:
    """All levels in one recurse_fused call; the SubGraph chain is built
    from the stacked per-level masks. Matches build_level's output for the
    single-uid-child no-filter shape exactly."""
    g = pb.pull_graph_for(csr)
    seeds = np.sort(np.asarray(sg.dest_uids, dtype=np.int64))
    seeds_mask = _seeds_mask(seeds, g.num_nodes, g.device)

    # batched-dispatch seam (query/batch.py): compatible concurrent
    # traversals stack their seed masks into one multi-source run; without
    # a batcher this is the gated solo call
    def _solo_fused():
        with costs.kernel("pb.recurse_fused", attr=cgq.attr):
            return pb.recurse_fused(
                g.in_src_pad, g.in_src_pad_d, g.in_iptr_rank, g.subjects,
                g.in_subjects, seeds_mask,
                depth=depth, chunks=g.chunks, chunks_d=g.chunks_d,
                allow_loop=allow_loop)

    masks_p, trav, fresh = ex.batched_recurse(
        g, seeds_mask, depth, allow_loop, _solo_fused)
    # one fetch for the whole traversal, bit-packed in dst-rank space (fresh
    # flags stay on the device until a uidMatrix is materialized)
    masks_h, trav_h = masks_p.cpu().numpy(), trav.cpu().numpy()
    nd = len(g.host_in_subjects)
    shared_fresh = FreshFlags(fresh)
    frontier = seeds
    attach = sg.children = []
    cum = 0
    for lvl in range(depth):
        if len(frontier) == 0:
            break
        cum += int(trav_h[lvl])
        if cum > ex.edge_budget():
            raise QueryError("recurse exceeded edge budget (ErrTooBig)")
        child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=frontier)
        m = LazyRecurseMatrix(csr, g, frontier, shared_fresh, lvl, allow_loop)
        child.uid_matrix = m
        child.counts = LazyCounts(m)
        ranks = np.flatnonzero(pb.unpack_words(masks_h[lvl], nd))
        child.dest_uids = g.host_in_subjects[ranks].astype(np.int64)
        attach.append(child)
        attach = child.children
        frontier = child.dest_uids
