"""The plain reference for Dgraph's `@recurse(depth: d, loop: false)` block
over one uid predicate, in plain PyTorch operations.

It imports nothing of the program and reads nothing the program made: it
starts from the reference's Adjacency (graph.py) of the generated (src,
dst) tensors, on whatever device those are on (the card after the window,
the CPU in the tests). The semantics are Dgraph's level-synchronous
expansion, written literally: at each level every out-edge (from, to) of
every uid of the frontier is expanded; an edge traversed at an earlier
level is dropped (loop: false); the distinct dests of the edges kept are
the level's dest set and the next frontier; the loop ends after `depth`
levels or at an empty frontier. A var on the recurse's predicate binds the
union of every level's dest set (Dgraph's var map merges the predicate's
copy at each level).

The edges traversed are flags over the Adjacency's CSR positions, and the
level sets are node masks: no sort a level.
"""

from __future__ import annotations

import torch

from graphbench.reference.graph import Adjacency


def _positions(adj: Adjacency, frontier: torch.Tensor) -> torch.Tensor:
    """The CSR positions of every out-edge of the (distinct) frontier."""
    starts = adj.indptr[frontier]
    counts = adj.indptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return starts[:0]
    offs = torch.cumsum(counts, 0) - counts
    return torch.repeat_interleave(starts - offs, counts,
                                   output_size=total) + torch.arange(
        total, device=adj.device)


def recurse(adj: Adjacency, seeds, depth: int
            ) -> tuple[list[torch.Tensor], int]:
    """(each level's dest set as sorted uids, the edges the levels kept)."""
    traversed = torch.zeros(adj.indices.numel(), dtype=torch.bool,
                            device=adj.device)
    frontier = torch.unique(adj.as_tensor(seeds))
    levels, kept = [], 0
    for _ in range(depth):
        if frontier.numel() == 0:
            break
        pos = _positions(adj, frontier)
        pos = pos[~traversed[pos]]          # loop: false
        traversed[pos] = True
        kept += pos.numel()
        dest = torch.zeros(adj.n + 1, dtype=torch.bool, device=adj.device)
        dest[adj.indices[pos]] = True
        frontier = torch.nonzero(dest).flatten()
        levels.append(frontier)
    return levels, kept


def union(levels: list[torch.Tensor], n: int) -> torch.Tensor:
    """The sorted uids of every level's dest set."""
    if not levels:
        return torch.zeros(0, dtype=torch.int64)
    seen = torch.zeros(n + 1, dtype=torch.bool, device=levels[0].device)
    for lv in levels:
        seen[lv] = True
    return torch.nonzero(seen).flatten()
