"""Sorted-uid set algebra in PyTorch, plus the host-facing combines.

Port of dgraph_tpu/ops/uidset.py. Reference semantics: algo/uidlist.go —
IntersectWith (:133), IntersectSorted (:278), MergeSorted (:344),
Difference (:312), ApplyFilter (:31), IndexOf (:395).

A *uid set* is a fixed-capacity 1-D integer tensor, sorted ascending,
strictly increasing over its valid prefix, padded at the tail with SENTINEL
(the dtype's max value). Membership tests are one vectorized
torch.searchsorted; unions are a sort plus run dedup.

The *_host combines answer the engine's DestUIDs/filter seam on numpy
arrays: numpy below HOST_CUTOVER, torch ops on the caller's device from it
(set from an H100 run of bench_torch_crossover.py section 6). union_parts
is uid(A, B, ...)'s union: where a var's uids are on the card already (a
gathered level's dest) it unions every part there in one pass. The device
branch keeps int64 throughout, so every uid the host holds comes back, and
sizes its tensors exactly: the JAX package pads to power-of-two capacities
(`_pow2_cap`) only to bound XLA recompiles, which torch does not have.
"""

from __future__ import annotations

import numpy as np
import torch

from dgraph_tpu_torch.obs import costs

SENTINEL32 = np.int32(np.iinfo(np.int32).max)
SENTINEL64 = np.int64(np.iinfo(np.int64).max)


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


def apply_filter(a: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Keep a[i] where mask[i]; the result is a valid (compacted) uid-set
    (algo/uidlist.go:31)."""
    snt = int(sentinel(a.dtype))
    return compact(torch.where(mask & (a != snt), a, snt))


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


def merge_many(matrix: torch.Tensor,
               out_size: int | None = None) -> torch.Tensor:
    """Union of the rows of a 2-D tensor of uid-sets (MergeSorted over a
    uidMatrix, query/query.go:1928); default capacity = its element
    count."""
    flat = _dedup_sorted(compact(matrix.reshape(-1)))
    if out_size is not None and out_size != flat.numel():
        flat = resize(flat, out_size)
    return flat


def intersect_many(matrix: torch.Tensor,
                   out_size: int | None = None) -> torch.Tensor:
    """Intersection of the rows of a 2-D tensor of uid-sets
    (algo/uidlist.go:278 IntersectSorted). Each row is duplicate-free, so
    after one sort of the flattened matrix a value is in every row iff it
    heads a run of length k: one sort instead of k-1 passes."""
    k = matrix.shape[0]
    flat = compact(matrix.reshape(-1))
    if k > 1:
        snt = int(sentinel(flat.dtype))
        n = flat.numel()
        ahead = torch.full_like(flat, snt)      # flat[i + k - 1], or snt
        if n >= k:
            ahead[: n - k + 1] = flat[k - 1:]
        first = torch.ones(flat.shape, dtype=torch.bool, device=flat.device)
        first[1:] = flat[1:] != flat[:-1]
        keep = first & (ahead == flat) & (flat != snt)
        flat = compact(torch.where(keep, flat, snt))
    if out_size is not None and out_size != flat.numel():
        flat = resize(flat, out_size)
    return flat


def index_of(a: torch.Tensor, v) -> torch.Tensor:
    """int32 index of uid v in set a, -1 on a miss or for the sentinel
    (algo/uidlist.go:395)."""
    vt = torch.as_tensor(v, dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return torch.full(vt.shape, -1, dtype=torch.int32, device=a.device)
    idx = torch.searchsorted(a, vt)
    hit = (idx < a.numel()) & (a[torch.clamp(idx, max=a.numel() - 1)] == vt) \
        & (vt != int(sentinel(a.dtype)))
    return torch.where(hit, idx, -1).to(torch.int32)


def rank_of(sorted_t: torch.Tensor, values: torch.Tensor,
            miss: int) -> torch.Tensor:
    """host_rank_of on tensors: the int32 position of each value in a
    sorted uid tensor, `miss` where absent. values must fit sorted_t's
    dtype (index_of casts, so a wider value would wrap)."""
    pos = index_of(sorted_t, values)
    return torch.where(pos >= 0, pos, miss).to(torch.int32)


def paginate(a: torch.Tensor, offset: int, count: int) -> torch.Tensor:
    """Keep valid entries with rank in [offset, offset+count); a negative
    offset counts from the end, count < 0 runs to the end (x/x.go:191
    PageRange, query/query.go:2114). `a` must be compacted: rank is
    position."""
    ranks = torch.arange(a.numel(), device=a.device)
    total = size(a)
    off = torch.clamp(total + offset, min=0) if offset < 0 else offset
    end = total if count < 0 else off + count
    return apply_filter(a, (ranks >= off) & (ranks < end))


# ---------------------------------------------------------------------------
# host-facing combines (the engine's DestUIDs / filter seam)
# ---------------------------------------------------------------------------

# from this min(len(a), len(b)) the combines run as torch ops on the
# caller's device, below it as numpy's set ops: the smallest power of two
# from which the H100 path (host-to-device and back included) beat numpy
# for all three ops at every larger size, 1:1 and 1:16, in
# bench_torch_crossover.py section 6 (PERF.md §4; at 1024 numpy's
# difference still won). It picks a path, never an answer.
HOST_CUTOVER = 2048

# device combines run, by op and device type (as csr.UNIONS counts unions)
COMBINES = {op: {"cuda": 0, "cpu": 0}
            for op in ("intersect", "union", "difference")}


def _to_device(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(dev)


def _device_combine(op: str, a, b, device) -> np.ndarray:
    """One combine as int64 torch ops on `device`: membership by
    searchsorted and an order-preserving selection for intersect and
    difference (O(n log m), no sort of sorted-unique inputs), one
    sort-unique of the concatenation for union. Equal to numpy's set ops
    for inputs in any order, with repeats, and for every int64 uid."""
    from dgraph_tpu_torch import resolve_device

    with costs.kernel("uidset." + op, n=len(a) + len(b)) as ck:
        out = _device_combine_on(op, a, b, resolve_device(device))
        ck.set(h2d=8 * (len(a) + len(b)), d2h=int(out.nbytes))
    return out


def _device_combine_on(op: str, a, b, dev: torch.device) -> np.ndarray:
    ta, tb = _to_device(a, dev), _to_device(b, dev)
    if op == "union":
        out = torch.unique(torch.cat([ta, tb]))
    else:
        # one read-back says which inputs are not sorted-unique (a uid(...)
        # literal list may be neither): those are sorted on the device
        okd = torch.stack([(t[1:] > t[:-1]).all() for t in (ta, tb)])
        ok = okd.tolist()
        costs.transfer(d2h=okd.numel() * okd.element_size())
        ta, tb = (t if good else torch.unique(t)
                  for t, good in zip((ta, tb), ok))
        if op == "intersect" and ta.numel() > tb.numel():
            ta, tb = tb, ta                 # search the smaller in the larger
        hit = torch.zeros(ta.shape, dtype=torch.bool, device=dev)
        if tb.numel():
            idx = torch.searchsorted(tb, ta)
            hit = (idx < tb.numel()) & \
                (tb[torch.clamp(idx, max=tb.numel() - 1)] == ta)
        out = ta[hit if op == "intersect" else ~hit]
    COMBINES[op][dev.type] = COMBINES[op].get(dev.type, 0) + 1
    return out.cpu().numpy()


def intersect_host(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    """Sorted-unique intersection (query/query.go:1924 DestUIDs =
    IntersectSorted), on `device` from HOST_CUTOVER."""
    if min(len(a), len(b)) < HOST_CUTOVER:
        return np.intersect1d(a, b)
    return _device_combine("intersect", a, b, device)


def union_host(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    """Sorted-unique union, on `device` from HOST_CUTOVER."""
    if min(len(a), len(b)) < HOST_CUTOVER:
        return np.union1d(a, b)
    return _device_combine("union", a, b, device)


def difference_host(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    """Sorted-unique a \\ b, on `device` from HOST_CUTOVER."""
    if min(len(a), len(b)) < HOST_CUTOVER:
        return np.setdiff1d(a, b)
    return _device_combine("difference", a, b, device)


def union_parts(parts: list, device, metrics=None) -> np.ndarray:
    """The union behind uid(A, B, ...): parts are (host uids, the card's
    copy of them or None) pairs, the first a uid(...) literal list where
    there is one. From HOST_CUTOVER uids in all, where two or more parts
    are given and one of them is on the card already, the union runs
    there once: only the parts without a copy go up, the parts are joined
    in int32 where the largest uid fits (else int64), deduplicated by one
    csr.unique_targets, and the result comes back once and is cast to
    int64 on the host (counted in metrics'
    dgraph_var_union_on_device_total, and the parts that went up in
    dgraph_var_union_parts_uploaded_total). Else union_host folds the
    parts in order, and a single part is returned as it is. The result is
    np.union1d's either way."""
    full = [(h, d) for h, d in parts if len(h)]
    if len(parts) < 2 or all(d is None for _, d in full) or \
            sum(len(h) for h, _ in full) < HOST_CUTOVER:
        out = parts[0][0]
        for host, _dev in parts[1:]:
            out = union_host(out, host, device)
        return out
    from dgraph_tpu_torch.ops.csr import unique_targets

    dev = next(d.device for _, d in full if d is not None)
    # a card copy is a level's sorted dest: its last uid is its largest
    hi = max(int(h[-1]) if d is not None else int(h.max()) for h, d in full)
    wide = hi > np.iinfo(np.int32).max
    dtype, npdt = (torch.int64, np.int64) if wide else (torch.int32, np.int32)
    up = [h for h, d in full if d is None]
    with costs.kernel("uidset.var_union",
                      n=sum(len(h) for h, _ in full)) as ck:
        ts = [torch.from_numpy(np.ascontiguousarray(h, dtype=npdt)).to(dev)
              if d is None else d.to(dtype) for h, d in full]
        out_d, read = unique_targets(torch.cat(ts))
        out = out_d.cpu().numpy()
        ck.set(h2d=np.dtype(npdt).itemsize * sum(len(h) for h in up),
               d2h=read + int(out.nbytes))
    COMBINES["union"][dev.type] = COMBINES["union"].get(dev.type, 0) + 1
    if metrics is not None:
        metrics.counter("dgraph_var_union_on_device_total").inc()
        metrics.counter("dgraph_var_union_parts_uploaded_total").inc(len(up))
    return out.astype(np.int64, copy=False)
