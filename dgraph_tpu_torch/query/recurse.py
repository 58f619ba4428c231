"""@recurse: iterative frontier expansion to fixed depth or exhaustion.

Port of dgraph_tpu/query/recurse.py (all of it but the mesh path).
Reference semantics: query/recurse.go — expandRecurse (:31-177): loop per
level, spawning copies of the original children as the new frontier's
SubGraphs (:157-164); loop prevention via a reach-set of (attr, from, to)
edges (:129-141) unless `loop: true`; bounded by the edge budget (:167).

  * Large CSRs run the active-prefix kernels (ops/pull_bfs over
    ops/prefix): per level, the kernel streams the dst-sorted edge array
    against the frontier; the fused per-edge prefix yields active flags and
    edge dedup is two masks on the device (fresh = active & ~seen,
    seen |= active) plus a node-sized bounds diff for the next frontier.
    The single-child no-filter shape runs every level in one recurse_fused
    call; uidMatrix rows stay deferred (LazyRecurseMatrix).
  * Small CSRs keep the vectorized host-mirror gather. (Tablet-routed
    predicates, which expand over the wire with (attr, from, to) edge-key
    dedup, wait for the cluster slice.)
"""

from __future__ import annotations

import numpy as np
import torch

from dgraph_tpu_torch.ops import pull_bfs as pb
from dgraph_tpu_torch.query.engine import QueryError, SubGraph
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
    if any(c not in uid_children for c in gq.children):
        raise NotImplementedError(
            "@recurse with value children is not ported yet: it waits for "
            "the value slice of dgraph_tpu_torch")
    seen_masks: dict[str, np.ndarray] = {}     # host path: attr -> bool[E]
    kstates: dict[str, dict] = {}              # kernel path: attr -> g, seen
    edges = 0

    def _csr_for(cgq):
        attr = cgq.attr
        rev = attr.startswith("~")
        pd = ex.snap.pred(attr[1:] if rev else attr)
        if pd is None:
            return None
        return pd.rev_csr if rev else pd.csr

    def _use_kernel(csr) -> bool:
        return csr is not None and csr.num_edges >= _kernel_min(csr)

    def _kstate(attr: str, csr):
        st = kstates.get(attr)
        if st is None:
            g = pb.pull_graph_for(csr)
            st = kstates[attr] = {
                "g": g,
                "seen": torch.zeros((g.in_src_pad.shape[0],),
                                    dtype=torch.bool, device=g.device)}
        return st

    # ---- fused path: single uid child, no filter ---------------------------
    if (len(uid_children) == 1 and uid_children[0].filter is None
            and depth <= FUSED_MAX_DEPTH and len(sg.dest_uids)):
        cgq = uid_children[0]
        csr = _csr_for(cgq)
        if _use_kernel(csr):
            _recurse_fused_path(ex, sg, cgq, csr, depth, spec.allow_loop)
            ex._record_uid_var(gq, sg)
            return

    def build_level(frontier: np.ndarray, remaining: int) -> list[SubGraph]:
        nonlocal edges
        out: list[SubGraph] = []
        frontier = np.sort(frontier)
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
                dest_words, trav, seen2, fresh = pb.recurse_step(
                    g.in_src_pad, g.in_iptr_rank, g.subjects,
                    g.in_subjects, fmask, st["seen"],
                    chunks=g.chunks, num_nodes=g.num_nodes,
                    allow_loop=spec.allow_loop)
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
            elif csr is not None:
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
                # no adjacency for the predicate: no edges to expand
                _set_list_result(child, [np.zeros(0, np.int64)
                                         for _ in frontier])
            child.dest_uids = ex._apply_filter(cgq.filter, child.dest_uids)
            if len(child.dest_uids):
                child.children = build_level(child.dest_uids, remaining - 1)
            out.append(child)
        return out

    sg.children = build_level(sg.dest_uids, depth)
    ex._record_uid_var(gq, sg)


def _recurse_fused_path(ex, sg: SubGraph, cgq, csr, depth: int,
                        allow_loop: bool) -> None:
    """All levels in one recurse_fused call; the SubGraph chain is built
    from the stacked per-level masks. Matches build_level's output for the
    single-uid-child no-filter shape exactly."""
    g = pb.pull_graph_for(csr)
    seeds = np.sort(np.asarray(sg.dest_uids, dtype=np.int64))
    seeds_mask = _seeds_mask(seeds, g.num_nodes, g.device)
    masks_p, trav, fresh = pb.recurse_fused(
        g.in_src_pad, g.in_src_pad_d, g.in_iptr_rank, g.subjects,
        g.in_subjects, seeds_mask,
        depth=depth, chunks=g.chunks, chunks_d=g.chunks_d,
        allow_loop=allow_loop)
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
