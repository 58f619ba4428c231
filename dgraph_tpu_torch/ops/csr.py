"""CSR frontier expansion — the SpMSpV gather at the heart of traversal.

Port of dgraph_tpu/ops/csr.py. Reference semantics: worker/task.go
handleUidPostings (:476-602) emits one sorted uid list per frontier uid
(the uidMatrix). Here the whole frontier expands in one gather over the
predicate's device CSR:

    counts  = indptr[row+1] - indptr[row]          (per-frontier-slot degree)
    offsets = cumsum(counts)
    out[j]  = indices[ starts[seg(j)] + j - offsets[seg(j)-1] ]

Output capacity `out_cap` is static; `total` reports the true edge count so
the host can detect overflow and re-issue with a larger capacity class
(x/init.go:53 QueryEdgeLimit). Targets past `total` hold the sentinel.
Out-of-range indices are clamped and masked explicitly (torch raises where
jnp.take clips).

expand_dest is the union of many rows (index root functions union the uid
rows of their tokens): expand, sort, dedup. expand_masked is the base-side
half of a delta-overlay merge-on-read (storage/delta.OverlayCSR): the
frontier expands over the unchanged base with the patched slots masked to
the sentinel. EXPANDS, UNIONS and MASKED count the calls of expand (the
gather under the other two as well), expand_dest and expand_masked by the
device type of the tensors they were given, so a caller can show which
side ran.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dgraph_tpu_torch.ops.uidset import _dedup_sorted, sentinel

EXPANDS = {"cuda": 0, "cpu": 0}
UNIONS = {"cuda": 0, "cpu": 0}
MASKED = {"cuda": 0, "cpu": 0}


class ExpandResult(NamedTuple):
    """uidMatrix in CSR form.

    targets: [out_cap] flat neighbor uids, grouped by source slot, sentinel
             tail.
    seg:     [out_cap] frontier slot of each target (-1 in padding).
    counts:  [frontier] per-slot degree.
    total:   0-d true edge count (may exceed out_cap → truncated).
    """

    targets: torch.Tensor
    seg: torch.Tensor
    counts: torch.Tensor
    total: torch.Tensor


def degrees(indptr: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Per-slot out-degree for sentinel-padded row ids (posting/list.go
    Length)."""
    valid = rows != int(sentinel(rows.dtype))
    r = torch.where(valid, rows, 0).to(torch.int64)
    if indptr.numel() < 2:
        return torch.zeros(rows.shape, dtype=indptr.dtype,
                           device=rows.device)
    r = torch.clamp(r, max=indptr.numel() - 2)
    return torch.where(valid, indptr[r + 1] - indptr[r], 0)


def expand(indptr: torch.Tensor, indices: torch.Tensor, rows: torch.Tensor,
           out_cap: int) -> ExpandResult:
    """Expand a frontier of CSR row ids into the concatenated neighbor
    lists. rows: sentinel-padded int32 row indices."""
    dev = rows.device
    EXPANDS[dev.type] = EXPANDS.get(dev.type, 0) + 1
    if indices.numel() == 0 or rows.numel() == 0:
        return ExpandResult(
            torch.full((out_cap,), int(sentinel(indices.dtype)),
                       dtype=indices.dtype, device=dev),
            torch.full((out_cap,), -1, dtype=torch.int32, device=dev),
            torch.zeros((rows.numel(),), dtype=indptr.dtype, device=dev),
            torch.zeros((), dtype=indptr.dtype, device=dev))
    valid = rows != int(sentinel(rows.dtype))
    r = torch.clamp(torch.where(valid, rows, 0).to(torch.int64),
                    max=indptr.numel() - 2)
    starts = indptr[r]
    counts = torch.where(valid, indptr[r + 1] - starts, 0)
    offsets = torch.cumsum(counts, 0, dtype=indptr.dtype)
    total = offsets[-1]

    pos = torch.arange(out_cap, dtype=offsets.dtype, device=dev)
    seg = torch.searchsorted(offsets, pos, right=True)
    seg_c = torch.clamp(seg, 0, rows.numel() - 1)
    prev = torch.where(seg_c > 0, offsets[torch.clamp(seg_c - 1, min=0)], 0)
    src = starts[seg_c] + (pos - prev)
    ok = pos < total
    gathered = indices[torch.clamp(src.to(torch.int64), 0,
                                   indices.numel() - 1)]
    out = torch.where(ok, gathered, int(sentinel(indices.dtype)))
    seg_out = torch.where(ok, seg_c.to(torch.int32), -1)
    return ExpandResult(out, seg_out, counts, total)


def expand_masked(indptr: torch.Tensor, indices: torch.Tensor,
                  rows: torch.Tensor, patched: torch.Tensor,
                  out_cap: int) -> ExpandResult:
    """Base-side half of a delta-overlay merge-on-read: expand the frontier
    over the unchanged base tensors with the overlay-patched slots
    (patched: bool per slot) masked to the sentinel — their rows come from
    the overlay's host replacement rows, which the caller splices into the
    uidMatrix. The base tensors are never rebuilt or re-uploaded."""
    MASKED[rows.device.type] = MASKED.get(rows.device.type, 0) + 1
    snt = int(sentinel(rows.dtype))
    rows = torch.where(patched.to(rows.device), snt, rows)
    return expand(indptr, indices, rows, out_cap)


def expand_dest(indptr: torch.Tensor, indices: torch.Tensor,
                rows: torch.Tensor, out_cap: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frontier expand returning (deduped sorted union of the rows' uids,
    sentinel tail, capacity out_cap; true total). If total > out_cap the
    union is incomplete and the caller re-issues at a larger capacity
    (query/query.go:1928 DestUIDs = MergeSorted(uidMatrix))."""
    UNIONS[rows.device.type] = UNIONS.get(rows.device.type, 0) + 1
    res = expand(indptr, indices, rows, out_cap)
    return _dedup_sorted(torch.sort(res.targets).values), res.total
