"""The plain reference: adjacency and k-hop sets over the benchmark's own
generated edge arrays, in plain PyTorch operations.

It imports nothing of the program and reads nothing the program made: it
starts from the (src, dst) tensors the generator handed to the loader, and
runs on whatever device those are on (the card after the window, the CPU in
the tests). The semantics are Dgraph's, as the repository's golden battery
and chip_smoke.py's host BFS state them: a uid predicate is a set of edges;
expanding a set of uids gives the set of their out-neighbours and requires
every out-edge of every uid in it.
"""

from __future__ import annotations

import torch


class Adjacency:
    """CSR over uids 0..n (row u holds u's out-neighbours, sorted)."""

    def __init__(self, n: int, src: torch.Tensor, dst: torch.Tensor):
        order = torch.argsort(src * (n + 1) + dst)
        self.n = n
        self.indices = dst[order].contiguous()
        deg = torch.bincount(src, minlength=n + 1)
        self.indptr = torch.zeros(n + 2, dtype=torch.int64, device=src.device)
        self.indptr[1:] = torch.cumsum(deg, 0)
        self.degree = deg
        self.device = src.device

    def as_tensor(self, uids) -> torch.Tensor:
        return torch.as_tensor(uids, dtype=torch.int64, device=self.device)

    def expand(self, frontier: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(sorted distinct out-neighbours of `frontier`, edges required)."""
        frontier = torch.unique(frontier)
        starts = self.indptr[frontier]
        counts = self.indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return frontier[:0], 0
        offs = torch.cumsum(counts, 0) - counts
        idx = torch.repeat_interleave(starts - offs, counts) + torch.arange(
            total, device=self.device)
        return torch.unique(self.indices[idx]), total

    def khop_union(self, seeds, hops: int) -> tuple[torch.Tensor, int]:
        """The uids at 1..hops steps from `seeds` (a walk may revisit), and
        the edges the walk required."""
        level, edges, found = self.as_tensor(seeds), 0, []
        for _ in range(hops):
            level, e = self.expand(level)
            edges += e
            found.append(level)
        return torch.unique(torch.cat(found)), edges
