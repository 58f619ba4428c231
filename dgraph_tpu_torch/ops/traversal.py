"""Iterative traversal on the device: k-hop BFS and SSSP over one CSR.

Port of dgraph_tpu/ops/traversal.py. Reference semantics: query/recurse.go
expandRecurse (level-synchronous frontier loop with a reach-set) and
query/shortest.go (host Dijkstra over a hash-map adjacency). Here both are
vectorized sparse steps over the device CSR:

  - k_hop: per level one CSR gather (ops/csr.expand), a sort-dedup and a
    visited-mask filter, with the JAX package's static capacities kept:
    `frontier_cap` truncates the sorted fresh set, and a level whose edges
    exceed `edge_cap` is gathered only up to it (`traversed` still counts
    every edge).
  - sssp: Bellman-Ford edge relaxation, one segment-min over all E edges per
    iteration, until no distance changes. It is the `shortest` tier for
    depths the distance-label kernel cannot hold and for CPU tensors.
  - k_hop_dense / k_hop_pull: bit-vector frontiers (no sorts); the pull form
    needs only an E-sized gather and a cumsum per hop.

Where JAX loops on the device (lax.fori_loop, lax.while_loop) the port runs
a Python loop; sssp reads one flag per iteration (`improved.any()`), the
k-hop forms read nothing until the caller does. `.at[].min/max(mode="drop")`
becomes scatter_reduce; sssp's min runs on int32 keys of the floats and its
dropped parent entries offer -1 in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dgraph_tpu_torch.ops.csr import expand
from dgraph_tpu_torch.ops.uidset import sentinel


def _searchsorted_rows(indptr: torch.Tensor, n: int) -> torch.Tensor:
    """Per-edge CSR row: row r owns edges [indptr[r], indptr[r+1])."""
    pos = torch.arange(n, dtype=indptr.dtype, device=indptr.device)
    return (torch.searchsorted(indptr, pos, right=True) - 1).to(torch.int32)


class KHopResult(NamedTuple):
    visited: torch.Tensor         # bool[num_nodes]: every uid reached (seeds too)
    frontier: torch.Tensor        # final frontier uid set (sentinel-padded)
    traversed: torch.Tensor       # 0-d int32: edges traversed in all
    frontier_sizes: torch.Tensor  # int32[hops]: frontier size after each hop


def k_hop(subjects: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
          seeds: torch.Tensor, *, hops: int, frontier_cap: int,
          num_nodes: int, edge_cap: int | None = None) -> KHopResult:
    """BFS `hops` levels from the uid set `seeds` over one predicate's CSR.

    num_nodes bounds the uid space (max uid + 1). edge_cap is the capacity of
    one level's edge gather (defaults to frontier_cap, and must be at least
    frontier_cap); frontier_cap the capacity of the frontier set. Both are
    capacity classes: a level that overflows them reports its true edge
    total in `traversed` so the caller can re-issue at the next class."""
    snt = int(sentinel(torch.int32))
    dev = seeds.device
    edge_cap = edge_cap or frontier_cap
    ns = subjects.shape[0]

    def resolve_rows(uids):
        if ns == 0:
            return torch.full(uids.shape, snt, dtype=torch.int32, device=dev)
        pos = torch.searchsorted(subjects, uids)
        pos_c = torch.clamp(pos, 0, ns - 1)
        ok = (subjects[pos_c] == uids) & (uids != snt)
        return torch.where(ok, pos_c, snt).to(torch.int32)

    seeds = seeds.to(torch.int32)
    visited = torch.zeros((num_nodes,), dtype=torch.bool, device=dev)
    s64 = seeds.to(torch.int64)
    visited[s64[(seeds != snt) & (s64 < num_nodes)]] = True
    sizes = torch.zeros((hops,), dtype=torch.int32, device=dev)
    # the carried frontier has a fixed width: widen (or truncate) the seeds
    if seeds.shape[0] < frontier_cap:
        frontier = torch.cat([seeds, torch.full(
            (frontier_cap - seeds.shape[0],), snt, dtype=torch.int32,
            device=dev)])
    else:
        frontier = torch.sort(seeds).values[:frontier_cap]
    traversed = torch.zeros((), dtype=torch.int32, device=dev)
    for level in range(hops):
        res = expand(indptr, indices, resolve_rows(frontier), edge_cap)
        # dedup the targets, then drop already-visited uids
        dest = torch.sort(res.targets).values
        dup = torch.zeros(dest.shape, dtype=torch.bool, device=dev)
        dup[1:] = dest[1:] == dest[:-1]
        dest = torch.where(dup, snt, dest)
        live = dest != snt
        safe = torch.clamp(torch.where(live, dest, num_nodes).to(torch.int64),
                           0, num_nodes - 1)
        was_visited = visited[safe] & live
        fresh = torch.sort(torch.where(was_visited | ~live, snt, dest)
                           ).values[:frontier_cap]
        f64 = fresh.to(torch.int64)
        visited[f64[(fresh != snt) & (f64 < num_nodes)]] = True
        sizes[level] = (fresh != snt).sum().to(torch.int32)
        traversed = traversed + res.total.to(torch.int32)
        frontier = fresh
    return KHopResult(visited, frontier, traversed, sizes)


class SSSPResult(NamedTuple):
    dist: torch.Tensor    # float32[num_nodes]; inf = unreachable
    parent: torch.Tensor  # int32[num_nodes]; -1 = none or the root
    iterations: int


def sssp(subjects: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
         weights: torch.Tensor | None, src: int, *, num_nodes: int,
         max_iters: int = 64) -> SSSPResult:
    """Single-source shortest paths by iterated edge relaxation.

    One iteration relaxes ALL E edges: candidate[dst] = min(dist[src] + w)
    by a segment-min scatter, until no distance changes or max_iters. Every
    uid (subjects and indices) must be below num_nodes. weights=None means
    unit costs. The parent of an improved node is the MAXIMUM source uid
    among the edges that reach its new distance (the JAX package's rule;
    min and max do not depend on the order of the scatter, so dist and
    parent are exact)."""
    dev = indices.device
    E = indices.shape[0]
    edge_src = subjects[_searchsorted_rows(indptr, E).to(torch.int64)]
    edge_dst = indices.to(torch.int64)
    w = weights if weights is not None else torch.ones(
        (E,), dtype=torch.float32, device=dev)

    dist = torch.full((num_nodes,), float("inf"), dtype=torch.float32,
                      device=dev)
    if 0 <= src < num_nodes:
        dist[src] = 0.0
    parent = torch.full((num_nodes,), -1, dtype=torch.int32, device=dev)
    src_idx = edge_src.to(torch.int64)
    it = 0
    while it < max_iters:
        cand = dist[src_idx] + w
        # the segment-min on order-preserving int32 keys: on CUDA a native
        # atomicMin, where a float32 amin retries a compare-and-swap on
        # every contended hub
        new_dist = _float_key(_float_key(dist).scatter_reduce(
            0, edge_dst, _float_key(cand), reduce="amin", include_self=True))
        improved = new_dist < dist
        wins = (cand == new_dist[edge_dst]) & improved[edge_dst]
        # stale parents out; an edge that does not win offers -1, which
        # changes no parent (a dump slot past the end would take every
        # such edge's atomic on one address)
        parent = torch.where(improved, -1, parent).scatter_reduce(
            0, edge_dst, torch.where(wins, edge_src, -1), reduce="amax",
            include_self=True)
        dist = new_dist
        it += 1
        if not bool(improved.any()):     # the iteration's one host read
            break
    return SSSPResult(dist, parent, it)


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """float32 <-> int32 keys that order as the floats do (NaN aside): the
    bits, with the magnitude bits flipped where the sign is set. Its own
    inverse: an int32 key maps back to the float32."""
    i = x.view(torch.int32)
    k = i ^ ((i >> 31) & 0x7FFFFFFF)
    return k if x.dtype == torch.float32 else k.view(torch.float32)


class DenseBFSResult(NamedTuple):
    visited: torch.Tensor    # bool[num_nodes]
    frontier: torch.Tensor   # bool[num_nodes]: the final frontier
    traversed: torch.Tensor  # 0-d int32: edges scanned


def k_hop_dense(subjects: torch.Tensor, indptr: torch.Tensor,
                indices: torch.Tensor, edge_src_row: torch.Tensor,
                seeds_mask: torch.Tensor, *, hops: int,
                num_nodes: int) -> DenseBFSResult:
    """Dense-frontier BFS: frontier and visited are bool vectors over the
    uid space; one hop is one gather over E edges and one scatter, no sorts.
    edge_src_row[e] is the CSR row of edge e (edge_src_rows). traversed
    counts every adjacency entry of every frontier uid per hop, as k_hop."""
    dev = seeds_mask.device
    frontier, visited = seeds_mask, seeds_mask
    traversed = torch.zeros((), dtype=torch.int32, device=dev)
    idx64 = indices.to(torch.int64)
    in_range = idx64 < num_nodes
    row = edge_src_row.to(torch.int64)
    for _ in range(hops):
        active = frontier[subjects.to(torch.int64)][row]
        traversed = traversed + active.sum().to(torch.int32)
        nxt = torch.zeros((num_nodes,), dtype=torch.bool, device=dev)
        nxt[idx64[active & in_range]] = True
        nxt = nxt & ~visited
        frontier, visited = nxt, visited | nxt
    return DenseBFSResult(visited, frontier, traversed)


def edge_src_rows(indptr: torch.Tensor) -> torch.Tensor:
    """Per-edge source row for k_hop_dense: edge e belongs to the row r
    with indptr[r] <= e < indptr[r+1]."""
    return _searchsorted_rows(indptr, int(indptr[-1]))


def k_hop_pull(subjects: torch.Tensor, indptr: torch.Tensor,
               in_subjects: torch.Tensor, in_indptr: torch.Tensor,
               in_src: torch.Tensor, seeds_mask: torch.Tensor, *, hops: int,
               num_nodes: int) -> DenseBFSResult:
    """Pull-style dense BFS over both orientations of the CSR:

      traversed += sum of out-degrees over frontier rows       (R-sized)
      active[e]  = frontier[in_src[e]]                         (E-sized gather)
      reached[r] = segment-any(active) by one cumsum and diff  (no E-scatter)
      frontier'  = reached & ~visited                          (R-sized scatter)
    """
    dev = seeds_mask.device
    out_deg = indptr[1:] - indptr[:-1]
    sub64 = subjects.to(torch.int64)
    in_sub64 = in_subjects.to(torch.int64)
    src64 = in_src.to(torch.int64)
    lo, hi = in_indptr[:-1].to(torch.int64), in_indptr[1:].to(torch.int64)
    keep = in_sub64 < num_nodes
    frontier, visited = seeds_mask, seeds_mask
    traversed = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(hops):
        f_rows = frontier[sub64]
        traversed = traversed + torch.where(f_rows, out_deg, 0).sum().to(
            torch.int32)
        active = frontier[src64].to(torch.int32)
        c = torch.zeros((active.shape[0] + 1,), dtype=torch.int32, device=dev)
        c[1:] = torch.cumsum(active, 0, dtype=torch.int32)
        reached = (c[hi] - c[lo]) > 0
        fresh = reached & ~visited[torch.clamp(in_sub64, max=num_nodes - 1)]
        nxt = torch.zeros((num_nodes,), dtype=torch.bool, device=dev)
        nxt[in_sub64[keep]] = fresh[keep]
        frontier, visited = nxt, visited | nxt
    return DenseBFSResult(visited, frontier, traversed)


def reverse_csr(subjects: np.ndarray, indptr: np.ndarray,
                indices: np.ndarray):
    """Host transpose: (in_subjects, in_indptr, in_src), where in_src lists,
    per destination node, the source uids of its incoming edges."""
    src = np.repeat(subjects, np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    dst_sorted = indices[order]
    src_sorted = src[order]
    in_subjects, counts = np.unique(dst_sorted, return_counts=True)
    in_indptr = np.zeros(len(in_subjects) + 1, dtype=np.int64)
    np.cumsum(counts, out=in_indptr[1:])
    return (in_subjects.astype(np.int32), in_indptr.astype(np.int32),
            src_sorted.astype(np.int32))


# device-runtime observatory (obs/devprof.py): the module's entry points by
# program family, under the JAX package's names; torch ops, probed at 0
# programs on /debug/compiles (see ops/segments.py).
JIT_PROGRAMS = {
    "traversal.k_hop": k_hop,
    "traversal.sssp": sssp,
    "traversal.k_hop_dense": k_hop_dense,
    "traversal.k_hop_pull": k_hop_pull,
}
