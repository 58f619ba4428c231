"""The Graph500 Kronecker generator (Benchmark 1 "Search", section 3), on
the device.

The specification's reference code (kronecker_generator.m): for each of
`scale` bits, an edge's source bit is set with probability 1 - (A + B), and
its destination bit with probability 1 - A / (A + B) when the source bit is
clear and 1 - C / (1 - (A + B)) when it is set; then the vertex labels are
permuted at random. The edge list's own permutation does not matter here:
the edges are stored as a set, sorted. Self-loops are dropped and
duplicates merged (Dgraph stores a set), and labels start at uid 1.
"""

from __future__ import annotations

import torch


def generate(cfg: dict, seed: int, device) -> dict:
    scale, edgefactor = int(cfg["scale"]), int(cfg["edgefactor"])
    a, b, c, _d = (float(x) for x in cfg["initiator"])
    n, m = 1 << scale, edgefactor << scale
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ib = torch.rand(m, generator=g, device=device) > ab
        jb = torch.rand(m, generator=g, device=device) > torch.where(
            ib, c_norm, a_norm)
        i |= ib.to(torch.int64) << bit
        j |= jb.to(torch.int64) << bit
    perm = torch.randperm(n, generator=g, device=device) + 1
    src, dst = perm[i], perm[j]
    del i, j
    keep = src != dst
    key = torch.unique((src[keep] << 32) | dst[keep])      # sorted, a set
    attr = cfg["predicate"]
    return {"n": n, "schema": cfg["schema"],
            "edges": {attr: (key >> 32, key & 0xFFFFFFFF)}, "values": {}}
