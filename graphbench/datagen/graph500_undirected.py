"""Graph500's own graph (Benchmark 1 "Search", section 3): the Kronecker
generator's edges taken as undirected, on the device.

It calls graph500.generate for the directed edge set (labels permuted at
random from the seed and starting at uid 1, self-loops dropped, repeats
merged) and emits every kept edge in both directions: an undirected edge
{u, v} is stored as the two uid triples u -> v and v -> u of one predicate,
so a vertex's out-neighbours are its in-neighbours. An edge generated in
both directions is stored once each way.
"""

from __future__ import annotations

import torch

from graphbench import spec


def generate(cfg: dict, seed: int, device) -> dict:
    data = spec.plugin("datagen", "graph500").generate(cfg, seed, device)
    attr = cfg["predicate"]
    src, dst = data["edges"][attr]
    key = torch.unique(torch.cat([(src << 32) | dst, (dst << 32) | src]))
    del src, dst
    data["edges"][attr] = (key >> 32, key & 0xFFFFFFFF)
    return data
