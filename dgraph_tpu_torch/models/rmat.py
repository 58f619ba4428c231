"""R-MAT graph generator (Chakrabarti et al.) — vectorized numpy.

Copy of dgraph_tpu/models/rmat.py: the port makes its data from the same
seed with the same generator. The dedup packs each edge into one int64
(src << scale | dst) for a 1-D np.unique, which sorts and dedups exactly as
np.unique(axis=0) over (src, dst) rows does (dst < 2**scale) without its
row-view sort; rmat_csr then needs no second sort.

Generates power-law directed graphs with LDBC-like degree skew for the
traversal benchmarks (BASELINE.md: LDBC-SNB 3-hop friends-of-friends).
"""

from __future__ import annotations

import numpy as np


def rmat_edges(scale: int, edge_factor: int = 16,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               seed: int = 1, dedup: bool = True) -> np.ndarray:
    """Generate ~edge_factor * 2**scale directed edges over 2**scale nodes.

    Returns int64 array [E, 2] of (src, dst), self-loops removed, optionally
    deduplicated (then sorted by (src, dst)). Vectorized bit-by-bit quadrant
    sampling.
    """
    n_edges = edge_factor << scale
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(n_edges)
        # quadrant probabilities: a=(0,0) b=(0,1) c=(1,0) d=(1,1)
        src_bit = (r >= a + b).astype(np.int64)
        dst_bit = ((r >= a) & (r < a + b) | (r >= a + b + c)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if dedup:
        packed = np.unique((src << scale) | dst)
        src, dst = packed >> scale, packed & ((1 << scale) - 1)
    return np.stack([src, dst], axis=1)


def rmat_csr(scale: int, edge_factor: int = 16, seed: int = 1,
             base_uid: int = 1):
    """R-MAT graph as a CSR (subjects, indptr, indices) with uids starting at
    base_uid (uid 0 is reserved, storage/postings.py VALUE_UID)."""
    edges = rmat_edges(scale, edge_factor, seed=seed) + base_uid  # sorted
    subjects, counts = np.unique(edges[:, 0], return_counts=True)
    indptr = np.zeros(len(subjects) + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return (subjects.astype(np.int32), indptr.astype(np.int32),
            edges[:, 1].astype(np.int32))
