"""The plain reference for Dgraph's grouped value var over a uid key, in
plain PyTorch operations:

    { var(func: uid(S)) { p { B as p } }
      var(func: uid(B)) @groupby(p) { c as count(uid) }
      q(func: uid(c), orderdesc: val(c), first: F) { uid n: val(c) }
      g(func: uid(c)) { count(uid) }
      t() { s: sum(val(c)) } }

It imports nothing of the program and reads nothing the program made: it
starts from the reference's Adjacency (graph.py) of the generated (src,
dst) tensors, on whatever device those are on (the card after the window,
the CPU in the tests). The semantics are Dgraph's: B is the dest of the
second level from the seeds (Adjacency.expand twice); grouping B by p puts
each member under every uid its p edges reach, and count(uid) counts a
group's distinct members, so, a posting list being a set, a key's count is
the number of B's out-edges into it: one bincount over B's out-edge
targets, whose non-zero bins are the keys. c maps each key to its count;
the top F come by count descending, then uid ascending.
"""

from __future__ import annotations

import torch

from graphbench.reference.graph import Adjacency


def out_targets(adj: Adjacency, frontier: torch.Tensor) -> torch.Tensor:
    """The target of every out-edge of the (distinct) frontier."""
    starts = adj.indptr[frontier]
    counts = adj.indptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return adj.indices[:0]
    offs = torch.cumsum(counts, 0) - counts
    pos = torch.repeat_interleave(starts - offs, counts, output_size=total)
    return adj.indices[pos + torch.arange(total, device=adj.device)]


def grouped_counts(adj: Adjacency, seeds, hops: int
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(the keys ascending, their counts, the edges required: every
    out-edge of the seeds, of each level and of the members)."""
    level, edges = adj.as_tensor(seeds), 0
    for _ in range(hops):
        level, e = adj.expand(level)
        edges += e
    targets = out_targets(adj, level)
    counts = torch.bincount(targets, minlength=adj.n + 1)
    keys = torch.nonzero(counts).flatten()
    return keys, counts[keys], edges + targets.numel()


def top(keys: torch.Tensor, counts: torch.Tensor,
        first: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The `first` keys of most count, ties by ascending uid (keys come
    ascending, and the sort is stable), with their counts."""
    order = torch.sort(counts, descending=True, stable=True).indices[:first]
    return keys[order], counts[order]
