"""Segmented reductions — @groupby / aggregation on the device.

Port of dgraph_tpu/ops/segments.py. Reference semantics: query/groupby.go
:43-75,142-165 aggregates (count / min / max / sum / avg) per group by
iterating each group's uid list; query/aggregator.go applies the op
pairwise. Here groups become segment ids and every group's aggregate
computes in one scatter over the flat member array: `index_add_` for sums
and counts, `scatter_reduce_` ("amin"/"amax") for min/max. These are plain
PyTorch ops; the JAX package has no Pallas kernel here either.

Two exactness regimes:

  * the DEVICE stage reduces f32 CANDIDATES (sum/min/max) plus an exact
    valid-value count (int64), with segment ids derived ON THE DEVICE from
    the per-group length vector (a cumsum + searchsorted(right=True), no
    host ``np.repeat``) and padding/dead rows masked into a dump segment
    that is sliced off;
  * the HOST finalizes in f64: avg is always ``f64(sum)/f64(count)``, and an
    empty segment becomes NaN (count becomes 0) by masking on the exact
    count. `scatter_reduce_` leaves an empty segment at its initial value
    (JAX's segment_min/max give ±inf there); the count mask, never
    `include_self`, decides emptiness.

Sums may be nondeterministic, but only where they are not used. A CUDA
`index_add_` on f32 adds in no fixed order. That is exact only under the
f32 rule (all-int values, |sum| < 2**24), and that rule is exactly where
query/groupby._batch_aggregates sends work to the device; outside it the
device candidates never reach a JSON answer (the host reduces in f64).

Host-facing entries: `group_reduce(op, seg_ids, values, num_groups)` (host
segment ids, one op), `fused_group_reduce(ops, values, lens, num_groups)`
(device segment ids from lengths, many ops in one pass) and
`rank_in_table(table, values)` (the group-code rank search). Each takes
`device` (default "cuda", which raises without CUDA) and returns numpy.
`count_in_table(table, values)` counts a gather's targets against its
sorted dest where both already lie on one device, and returns a tensor
there. REDUCES and RANKS count the device passes by device type, as
ops/csr.UNIONS counts unions, so a caller can show which side ran.
"""

from __future__ import annotations

import numpy as np
import torch

from dgraph_tpu_torch import resolve_device

_OPS = ("sum", "min", "max", "avg", "count")

# from this many lookups up the device rank search (its two copies and the
# table's upload included) beats numpy's searchsorted: on an H100 80GB HBM3
# at 700 W (bench_torch_crossover.py section 4) the device won at every
# measured size, 2^12..2^22 lookups into tables of 2^10..2^20 uids
# (4,096 lookups: 0.15-0.86 ms against 0.35-1.59 ms)
_RANK_DEVICE_MIN = 1 << 12

REDUCES = {"cuda": 0, "cpu": 0}
RANKS = {"cuda": 0, "cpu": 0}


def seg_capacity(n: int) -> int:
    """Pow2 padding capacity (the JAX package's retrace bound, kept so the
    padded shapes match the reference's)."""
    return 1 << max(int(np.ceil(np.log2(max(int(n), 1)))), 4)


def _counts(valid: torch.Tensor, seg: torch.Tensor, ns: int) -> torch.Tensor:
    """Exact int64 count of valid entries per segment."""
    return torch.zeros(ns, dtype=torch.int64, device=seg.device).index_add_(
        0, seg, valid.to(torch.int64))


def _scatter(op: str, values: torch.Tensor, valid: torch.Tensor,
             seg: torch.Tensor, ns: int) -> torch.Tensor:
    """f32 sum/min/max candidate per segment over the valid entries."""
    dev = values.device
    if op in ("sum", "avg"):
        return torch.zeros(ns, dtype=torch.float32, device=dev).index_add_(
            0, seg, torch.where(valid, values, 0.0))
    if op == "min":
        return torch.full((ns,), float("inf"), device=dev).scatter_reduce_(
            0, seg, torch.where(valid, values, float("inf")), "amin")
    if op == "max":
        return torch.full((ns,), float("-inf"), device=dev).scatter_reduce_(
            0, seg, torch.where(valid, values, float("-inf")), "amax")
    raise ValueError(f"unknown segment op {op!r}")


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor, *, op: str,
                   num_segments: int) -> torch.Tensor:
    """One fused reduction over all segments.

    values: float32[N] (NaN = missing, excluded from every op)
    seg_ids: integer[N] in [0, num_segments)
    Returns float32[num_segments]; empty segments yield NaN (count yields 0).
    """
    if op not in _OPS:
        raise ValueError(f"unknown segment op {op!r}")
    seg = seg_ids.to(torch.int64)
    valid = ~torch.isnan(values)
    cnt = _counts(valid, seg, num_segments)
    if op == "count":
        return cnt.to(torch.float32)
    out = _scatter(op, values, valid, seg, num_segments)
    if op == "avg":
        out = out / cnt.clamp(min=1).to(torch.float32)
    return torch.where(cnt == 0, float("nan"), out)


def _sum_count(values: torch.Tensor, seg_ids: torch.Tensor, *,
               num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 sum candidate + exact valid count in one pass (avg feeds the
    host-f64 finalize from these instead of dividing on the device)."""
    seg = seg_ids.to(torch.int64)
    valid = ~torch.isnan(values)
    return (_scatter("sum", values, valid, seg, num_segments),
            _counts(valid, seg, num_segments))


def group_reduce(op: str, seg_ids: np.ndarray, values: np.ndarray,
                 num_groups: int,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """numpy → device → numpy wrapper (empty input → all-NaN/0 vector).

    avg finalizes on the host in f64 from the device's (sum, count)
    candidates — byte-identical to a host f64 tail whenever the sum is
    f32-exact.
    """
    if op not in _OPS:
        raise ValueError(f"unknown segment op {op!r}")
    dev = resolve_device(device)
    if num_groups == 0:
        return np.zeros(0, dtype=np.float32)
    if len(seg_ids) == 0:
        out = np.full(num_groups, np.nan, dtype=np.float32)
        if op == "count":
            out[:] = 0.0
        return out
    vals = torch.from_numpy(np.asarray(values, dtype=np.float32)).to(dev)
    segs = torch.from_numpy(np.asarray(seg_ids, dtype=np.int64)).to(dev)
    REDUCES[dev.type] += 1
    if op == "avg":
        s, cnt = _sum_count(vals, segs, num_segments=int(num_groups))
        s64 = s.cpu().numpy().astype(np.float64)
        c64 = cnt.cpu().numpy().astype(np.float64)
        return np.where(c64 == 0, np.nan, s64 / np.maximum(c64, 1.0))
    res = segment_reduce(vals, segs, op=op, num_segments=int(num_groups))
    return res.cpu().numpy()


# ---------------------------------------------------------------------------
# fused multi-op reduce with device-derived segment ids
# ---------------------------------------------------------------------------

def _lens_reduce(values: torch.Tensor, lens: torch.Tensor, total: int, *,
                 ops: tuple, num_segments: int) -> dict:
    """Reduce with segment ids built ON THE DEVICE from per-group lengths.

    values: f32[cap] flat member values, caller-padded (NaN = missing)
    lens:   int64[gcap] per-group member counts, zero-padded
    total:  the live prefix of `values`

    Position p belongs to the group whose cumulative-length window covers
    it; padding/dead rows (p >= total) and overflow land in a dump segment
    `num_segments` that is sliced off. Returns f32 candidate tensors per
    requested op plus the exact valid count.
    """
    cap = values.shape[0]
    ns = num_segments
    ends = torch.cumsum(lens, 0)
    pos = torch.arange(cap, dtype=torch.int64, device=values.device)
    seg = torch.searchsorted(ends, pos, right=True)
    live = pos < total
    seg = torch.where(live & (seg < ns), seg, ns)
    valid = live & ~torch.isnan(values)
    out = {"count": _counts(valid, seg, ns + 1)[:ns]}
    if "sum" in ops or "avg" in ops:
        out["sum"] = _scatter("sum", values, valid, seg, ns + 1)[:ns]
    for op in ("min", "max"):
        if op in ops:
            out[op] = _scatter(op, values, valid, seg, ns + 1)[:ns]
    return out


def fused_group_reduce(ops, values: np.ndarray, lens, num_groups: int,
                       device: str | torch.device = "cuda") -> dict:
    """All requested ops over one flat value vector in ONE device pass.

    values: float per-member values in group-concatenation order (NaN =
    member has no value); lens: per-group member counts (their cumsum
    defines the segments — the device derives ids, no host np.repeat).
    Returns {op: float64[num_groups]} finalized on the host: sum/min/max
    widen the f32 candidates, avg = f64(sum)/f64(count), empty → NaN
    (count → 0).
    """
    for op in ops:
        if op not in _OPS:
            raise ValueError(f"unknown segment op {op!r}")
    dev = resolve_device(device)
    ng = int(num_groups)
    if ng == 0:
        return {op: np.zeros(0, dtype=np.float64) for op in ops}
    n = len(values)
    if n == 0:
        return {op: (np.zeros(ng) if op == "count"
                     else np.full(ng, np.nan)) for op in ops}
    vp = np.full(seg_capacity(n), np.nan, dtype=np.float32)
    vp[:n] = np.asarray(values, dtype=np.float32)
    lp = np.zeros(seg_capacity(ng), dtype=np.int64)
    lp[:ng] = np.asarray(lens, dtype=np.int64)
    res = _lens_reduce(torch.from_numpy(vp).to(dev),
                       torch.from_numpy(lp).to(dev), n,
                       ops=tuple(sorted(set(ops))), num_segments=ng)
    REDUCES[dev.type] += 1
    cnt = res["count"].cpu().numpy().astype(np.float64)
    empty = cnt == 0
    out = {}
    for op in ops:
        if op == "count":
            out[op] = cnt
        elif op == "avg":
            s = res["sum"].cpu().numpy().astype(np.float64)
            out[op] = np.where(empty, np.nan, s / np.maximum(cnt, 1.0))
        else:
            cand = res[op].cpu().numpy().astype(np.float64)
            out[op] = np.where(empty, np.nan, cand)
    return out


# ---------------------------------------------------------------------------
# rank-space coding against a distinct-target table
# ---------------------------------------------------------------------------

def _rank_kernel(table: torch.Tensor, values: torch.Tensor):
    """Clipped rank of each value in a sorted int64 table, and whether the
    table holds it there (searchsorted needs both in one dtype)."""
    nt = table.shape[0]
    pos = torch.searchsorted(table, values).clamp_(0, max(nt - 1, 0))
    return pos, table[pos] == values


def rank_in_table(table: np.ndarray, values: np.ndarray,
                  device: str | torch.device = "cuda"):
    """(pos, hit): rank of each value in a SORTED table — the group-code
    primitive (codes = ranks in the tablet's distinct-target table, no
    per-query np.unique sort). Host numpy below _RANK_DEVICE_MIN lookups,
    a device searchsorted on `device` from there up.
    """
    dev = resolve_device(device)
    nv = len(values)
    if len(table) == 0 or nv == 0:
        return (np.zeros(nv, dtype=np.int64),
                np.zeros(nv, dtype=bool))
    if nv >= _RANK_DEVICE_MIN:
        vp = np.full(seg_capacity(nv), table[0], dtype=np.int64)
        vp[:nv] = values
        pos, hit = _rank_kernel(
            torch.from_numpy(np.asarray(table, dtype=np.int64)).to(dev),
            torch.from_numpy(vp).to(dev))
        RANKS[dev.type] += 1
        return (pos[:nv].cpu().numpy().astype(np.int64),
                hit[:nv].cpu().numpy())
    pos = np.searchsorted(table, values)
    posc = np.minimum(pos, len(table) - 1)
    return posc.astype(np.int64), table[posc] == values


def count_in_table(table: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """How often each entry of a sorted table occurs among `values`, every
    one of which the table holds (a gather's targets against the level's
    dest): one rank of the values in the table (a searchsorted, as
    _rank_kernel) and one bincount over the ranks, on their device. The
    counts come in int32 where the values are fewer than 2**31, else
    int64."""
    pos = torch.searchsorted(table, values)
    counts = torch.bincount(pos, minlength=table.numel())
    RANKS[values.device.type] = RANKS.get(values.device.type, 0) + 1
    return counts.to(torch.int32) if values.numel() < 2**31 else counts


# device-runtime observatory (obs/devprof.py): the module's entry points by
# program family, under the JAX package's names. They are torch ops, which
# build no program per shape, so /debug/compiles probes each at 0.
JIT_PROGRAMS = {
    "segments.reduce": segment_reduce,
    "segments.sum_count": _sum_count,
    "segments.lens_reduce": _lens_reduce,
    "segments.rank_kernel": _rank_kernel,
}
