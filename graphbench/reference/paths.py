"""The plain reference for point-to-point shortest paths: a level-synchronous
BFS over the generator's own edge arrays, and the canonical path, in plain
PyTorch operations.

It imports nothing of the program and reads nothing the program made: it
starts from the reference's Adjacency (graph.py) of the generated (src, dst)
tensors, on whatever device those are on (the card after the window, the
CPU in the tests). The semantics are Dgraph's unweighted `shortest` block
as the repository states them (the module notes of the port's
query/shortest.py): every edge costs 1, a path has at most `max_hops`
edges, and where several shortest paths tie, each step back from the
target takes the minimum uid at distance d - 1 that has an edge to the
current vertex.

The BFS stops as soon as the target's distance is known: before a level is
expanded, the target's in-neighbours are looked up in it, so the level
that would reach the target (often the largest) is never expanded. One
read of the host a level, and one a step of the walk back.
"""

from __future__ import annotations

import torch

from graphbench.reference.graph import Adjacency

UNSEEN = -1
MAX_HOPS = 126           # distances are int8


def in_adjacency(adj: Adjacency) -> Adjacency:
    """The transpose of `adj` (row v holds the uids with an edge to v,
    sorted), built once per Adjacency, with a host copy of its indptr."""
    rev = getattr(adj, "_in", None)
    if rev is None:
        src = torch.repeat_interleave(
            torch.arange(adj.n + 1, device=adj.device), adj.degree)
        rev = adj._in = Adjacency(adj.n, adj.indices, src)
        rev.host_indptr = rev.indptr.tolist()
    return rev


def _int32(adj: Adjacency):
    """(indptr, indices) of `adj` as int32, made once per Adjacency."""
    got = getattr(adj, "_int32", None)
    if got is None:
        got = adj._int32 = (adj.indptr.to(torch.int32),
                            adj.indices.to(torch.int32))
    return got


def _in_row(adj: Adjacency, v: int) -> torch.Tensor:
    rev = in_adjacency(adj)
    return rev.indices[rev.host_indptr[v]: rev.host_indptr[v + 1]]


def bfs(adj: Adjacency, src: int, dst: int,
        max_hops: int) -> tuple[torch.Tensor, int | None]:
    """(dist, d): int8[n + 1] BFS distances from `src` (UNSEEN where not
    reached) of every level before `dst`'s, and d, the distance of `dst`,
    or None when it is not within `max_hops`. Without a `dst` of its own
    (say uid 0, which is no vertex) the levels run through `src`'s whole
    component."""
    if max_hops > MAX_HOPS:
        raise ValueError(f"max_hops {max_hops} > {MAX_HOPS}")
    indptr, indices = _int32(adj)
    dev = adj.device
    dist = torch.full((adj.n + 1,), UNSEEN, dtype=torch.int8, device=dev)
    dist[src] = 0
    if src == dst:
        return dist, 0
    into_dst = _in_row(adj, dst)
    frontier = adj.as_tensor([src])             # the uids at `level`
    for level in range(max_hops):
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total, hit = torch.stack([counts.sum(), (dist[into_dst] == level)
                                  .any().to(torch.int64)]).tolist()
        if hit:
            return dist, level + 1
        if total == 0 or level + 1 == max_hops:
            break
        offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        idx = torch.repeat_interleave(starts - offs, counts,
                                      output_size=total)
        idx += torch.arange(total, dtype=torch.int32, device=dev)
        reached = torch.zeros(adj.n + 1, dtype=torch.bool, device=dev)
        reached[indices[idx]] = True
        fresh = reached & (dist == UNSEEN)
        dist[fresh] = level + 1
        frontier = torch.nonzero(fresh).flatten()
    return dist, None


def shortest_path(adj: Adjacency, src: int, dst: int,
                  max_hops: int) -> list[int] | None:
    """The canonical shortest path [src, ..., dst] over `adj`, or None when
    `dst` is not within `max_hops` edges of `src`."""
    dist, d = bfs(adj, src, dst, max_hops)
    if d is None:
        return None
    big = adj.n + 1
    path, cur = [dst], dst
    for level in range(d - 1, -1, -1):
        row = _in_row(adj, cur)
        cur = int(torch.where(dist[row] == level, row, big).min())
        path.append(cur)
    if cur != src:
        raise RuntimeError("the walk back did not end at the source")
    return path[::-1]
