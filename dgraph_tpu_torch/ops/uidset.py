"""Sorted-uid set algebra in PyTorch, plus the host (numpy) helpers.

Port of dgraph_tpu/ops/uidset.py. Reference semantics: algo/uidlist.go —
IntersectWith (:133), MergeSorted (:344), Difference (:312), IndexOf
(:395).

A *uid set* is a fixed-capacity 1-D integer tensor, sorted ascending,
strictly increasing over its valid prefix, padded at the tail with SENTINEL
(the dtype's max value). Membership tests are one vectorized
torch.searchsorted; unions are a sort plus run dedup.

The *_host helpers answer the engine's per-level combines on numpy arrays.
The JAX package sends sets above its HOST_CUTOVER (8192) to the device; here
they stay on the host until an H100 measurement says where a crossover lies
(the answers are identical either way).
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL32 = np.int32(np.iinfo(np.int32).max)


def sentinel(dtype) -> np.generic:
    """Padding value for a uid-set of the given integer dtype (numpy or
    torch dtype)."""
    if isinstance(dtype, torch.dtype):
        return np.asarray(torch.iinfo(dtype).max).astype(
            np.int64 if dtype == torch.int64 else np.int32)[()]
    return np.asarray(np.iinfo(np.dtype(dtype)).max, dtype=dtype)[()]


def host_rank_of(sorted_arr: np.ndarray, values: np.ndarray,
                 miss: int) -> np.ndarray:
    """Position of each value in a sorted host array, `miss` where absent
    (reference algo/uidlist.go:395 IndexOf, vectorized). The shared helper
    behind frontier→CSR-row mapping, rank compression, and seed mapping."""
    values = np.asarray(values)
    if len(sorted_arr) == 0:
        return np.full(values.shape, miss, dtype=np.int64)
    pos = np.searchsorted(sorted_arr, values)
    pos_c = np.clip(pos, 0, len(sorted_arr) - 1)
    ok = sorted_arr[pos_c] == values
    return np.where(ok, pos_c, miss)


# ---------------------------------------------------------------------------
# construction / host interop
# ---------------------------------------------------------------------------

def make_set(uids, capacity: int | None = None, dtype=torch.int32,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """Build a uid-set tensor from host uids (any order, dupes allowed)."""
    from dgraph_tpu_torch import resolve_device

    dev = resolve_device(device)
    npdt = np.int64 if dtype == torch.int64 else np.int32
    arr = np.unique(np.asarray(uids, dtype=npdt))
    cap = capacity if capacity is not None else max(len(arr), 1)
    if len(arr) > cap:
        raise ValueError(f"{len(arr)} uids exceed capacity {cap}")
    snt = sentinel(dtype)
    if len(arr) and arr[-1] == snt:
        raise ValueError(f"uid {arr[-1]} collides with the padding sentinel")
    out = np.full(cap, snt, dtype=npdt)
    out[: len(arr)] = arr
    return torch.from_numpy(out).to(dev)


def to_numpy(s: torch.Tensor) -> np.ndarray:
    """Valid (non-sentinel) entries of a uid-set as a host numpy array."""
    arr = s.cpu().numpy()
    return arr[arr != sentinel(arr.dtype)]


# ---------------------------------------------------------------------------
# core algebra
# ---------------------------------------------------------------------------

def size(a: torch.Tensor) -> torch.Tensor:
    """Number of valid entries."""
    return (a != int(sentinel(a.dtype))).sum().to(torch.int32)


def compact(a: torch.Tensor) -> torch.Tensor:
    """Push sentinels to the tail (valid entries ascend; sentinel is max)."""
    return torch.sort(a).values


def is_member(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean mask over `a`: a[i] present in set `b`. Sentinels map to
    False."""
    snt = int(sentinel(a.dtype))
    if b.numel() == 0:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    idx = torch.searchsorted(b, a)
    hit = b[torch.clamp(idx, max=b.numel() - 1)]
    return (idx < b.numel()) & (hit == a) & (a != snt)


def intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sorted intersection in a's capacity (algo/uidlist.go:133)."""
    snt = int(sentinel(a.dtype))
    return compact(torch.where(is_member(a, b), a, snt))


def difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a \\ b (algo/uidlist.go:312)."""
    snt = int(sentinel(a.dtype))
    keep = ~is_member(a, b) & (a != snt)
    return compact(torch.where(keep, a, snt))


def _dedup_sorted(x: torch.Tensor) -> torch.Tensor:
    """Kill duplicate runs in a sorted tensor (keeps the first of each run),
    re-compact."""
    snt = int(sentinel(x.dtype))
    dup = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    dup[1:] = x[1:] == x[:-1]
    return compact(torch.where(dup, snt, x))


def resize(a: torch.Tensor, capacity: int) -> torch.Tensor:
    """Grow (pad) or shrink (truncate the valid prefix) a compacted set."""
    n = a.numel()
    if capacity == n:
        return a
    if capacity > n:
        pad = torch.full((capacity - n,), int(sentinel(a.dtype)),
                         dtype=a.dtype, device=a.device)
        return torch.cat([a, pad])
    return a[:capacity]


def merge(a: torch.Tensor, b: torch.Tensor,
          out_size: int | None = None) -> torch.Tensor:
    """Sorted union with dedup (algo/uidlist.go:344); default capacity
    |a|+|b|."""
    merged = _dedup_sorted(compact(torch.cat([a, b])))
    if out_size is not None and out_size != merged.numel():
        merged = resize(merged, out_size)
    return merged


# ---------------------------------------------------------------------------
# host-facing combines (the engine's DestUIDs / filter seam)
# ---------------------------------------------------------------------------

def intersect_host(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted-unique int64 intersection (query/query.go:1924)."""
    return np.intersect1d(a, b)


def union_host(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted-unique int64 union."""
    return np.union1d(a, b)


def difference_host(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted-unique int64 a \\ b."""
    return np.setdiff1d(a, b)
