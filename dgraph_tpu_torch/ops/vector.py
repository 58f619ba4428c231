"""Dense-vector top-k on the device: the similarity probe of @index(vector).

Port of dgraph_tpu/ops/vector.py. The probe is a matrix product plus a
top-k: score = M @ q over the predicate's row-aligned [R, D] device-resident
embedding matrix, then the k best rows. The JAX package computes both with
jnp (no Pallas kernel), so here they are torch ops: `torch.matmul` for the
product, `torch.topk` for the selection.

Numerical contract (storage/vecindex.py owns the orchestration):

  * the device stage ranks by float32 *negated distance* — it only has to
    produce a candidate superset (k' >= k, with margin);
  * the host re-scores candidates in float64 and picks the final k by
    (distance, uid) — one exact, deterministic ranking rule shared by the
    host-scan, device, IVF and fused-ANN paths, so every path returns
    byte-identical results.

Distances: cosine -> 1 - cos(x, q); l2 -> squared L2; dot -> -x.q.
Smaller is better everywhere; the device carries the negation so a
descending top-k applies.

Tie rule. JAX `lax.top_k` puts equal scores in lower-index order, so with
more tied rows than k' the candidate set holds the lowest rows (rows are
uid-sorted: the smallest uids). `torch.topk` promises no order among
equal values, so the selection here runs on one int64 key per row: the
float32 score mapped to an order-preserving int32 in the high half and
(2^31 - 1 - index) in the low half. Keys are distinct, so the top k keys
are exactly the k best (score desc, index asc) and come out in that order.
In `ivf_topk` the index is the position in `cand_rows` (list order), as in
JAX.

Precision. The candidate stage is full fp32: TF32 would round the product's
inputs to 10 mantissa bits, which is another candidate set. `_check_fp32`
raises where a CUDA scan would run with TF32 on; no module of this package
turns it on.

`ann_expand` is the hybrid pipeline: top-k candidates -> uid mapping -> CSR
frontier expansion with no host round trip between the stages (one span,
`device_kernel` kernel=vector.ann_expand).
"""

from __future__ import annotations

import numpy as np
import torch

from dgraph_tpu_torch.ops.csr import ExpandResult, expand
from dgraph_tpu_torch.ops.uidset import sentinel

METRICS = ("cosine", "l2", "dot")

# the JAX package's row-block size (its scan is a loop of [BLOCK_ROWS, D]
# products); the port scans the whole matrix in one product, so nothing here
# is sized by it, and the name stays for readers of both packages
BLOCK_ROWS = 1 << 12

# queries per product in the stacked scan: bounds the [B, R] score and key
# buffers (16 queries over 2^20 rows: 64 MB of scores, 128 MB of keys)
_BATCH_CHUNK_CELLS = 1 << 24

_LOW31 = (1 << 31) - 1


def row_capacity(n: int) -> int:
    """Pow2 row-capacity class for an n-row matrix (>= 8)."""
    return 1 << max(int(np.ceil(np.log2(max(n, 1) + 1))), 3)


def k_capacity(k: int, n_cap: int) -> int:
    """Pow2 candidate-capacity class for a final top-k of k: enough margin
    that the float64 re-rank's winners are inside the float32 candidate
    set for anything but adversarially tied corpora."""
    want = max(2 * k, k + 16)
    return min(1 << int(np.ceil(np.log2(max(want, 1)))), n_cap)


def host_distances(vecs64: np.ndarray, q64: np.ndarray, metric: str) -> np.ndarray:
    """Exact float64 distances of every row — the reference ranking every
    other path must reproduce (and the brute-force acceptance gate)."""
    s = vecs64 @ q64
    if metric == "cosine":
        nx = np.linalg.norm(vecs64, axis=1)
        nq = np.linalg.norm(q64)
        return 1.0 - s / np.maximum(nx * nq, 1e-300)
    if metric == "l2":
        nx2 = np.einsum("ij,ij->i", vecs64, vecs64)
        return nx2 - 2.0 * s + float(q64 @ q64)
    return -s                               # dot


def _check_fp32(t: torch.Tensor) -> None:
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "vector scan: torch.backends.cuda.matmul.allow_tf32 is True; "
            "the candidate stage must run in full fp32")


def _neg_dist(blk, nrm, Q, metric: str) -> torch.Tensor:
    """Negated distances [B, rows] of row block blk [rows, D] (norms nrm)
    against queries Q [B, D], float32."""
    s = torch.matmul(Q, blk.T)
    if metric == "cosine":
        qn = torch.sqrt(torch.sum(Q * Q, dim=1, keepdim=True))
        return s / torch.clamp(nrm[None, :] * qn, min=1e-30) - 1.0
    if metric == "l2":
        qn2 = torch.sum(Q * Q, dim=1, keepdim=True)
        return -(nrm[None, :] * nrm[None, :] - 2.0 * s + qn2)
    return s                                # dot


def _ordered_key(nd: torch.Tensor) -> torch.Tensor:
    """int64 keys, descending in (score, -index) along the last axis:
    an order-preserving int32 image of the float32 score (-0.0 folded onto
    +0.0 first, so equal scores share a key half) over 2^31-1 - index."""
    bits = (nd + 0.0).contiguous().view(torch.int32)
    key32 = torch.where(bits < 0, bits ^ _LOW31, bits).to(torch.int64)
    idx = torch.arange(nd.shape[-1], dtype=torch.int64, device=nd.device)
    return key32 * (1 << 32) + (_LOW31 - idx)


def _stable_topk(nd: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (JAX lax.top_k's order). k <= nd.shape[-1]."""
    key = torch.topk(_ordered_key(nd), k, dim=-1, sorted=True).values
    ix = _LOW31 - (key & 0xFFFFFFFF)
    return torch.gather(nd, -1, ix), ix


def _valid_mask(R: int, nrows: int, dead_rows: torch.Tensor,
                device) -> torch.Tensor:
    """Row-validity vector: real rows minus the overlay's dead rows
    (dead_rows is sentinel-padded with R -> dropped)."""
    valid = torch.arange(R, dtype=torch.int64, device=device) < int(nrows)
    dr = dead_rows.to(device=device, dtype=torch.int64)
    dr = dr[dr < R]
    valid[dr] = False
    return valid


def _topk_rows(matrix, norms, valid, Q, k: int, metric: str):
    """(neg_dist f32[B, k], rows i32[B, k]) of the stacked queries Q;
    masked and padding slots surface as (-inf, R)."""
    R = matrix.shape[0]
    kk = min(k, R)
    nd = _neg_dist(matrix, norms, Q, metric)
    nd = torch.where(valid[None, :], nd, float("-inf"))
    vals, ix = _stable_topk(nd, kk)
    rows = torch.where(vals > float("-inf"), ix, R).to(torch.int32)
    if kk < k:
        B = Q.shape[0]
        vals = torch.cat([vals, torch.full((B, k - kk), float("-inf"),
                                           dtype=vals.dtype,
                                           device=vals.device)], 1)
        rows = torch.cat([rows, torch.full((B, k - kk), R, dtype=torch.int32,
                                           device=rows.device)], 1)
    return vals, rows


def topk_candidates(matrix, norms, qv, nrows, dead_rows, *,
                    k: int, metric: str):
    """Float32 candidate stage: (neg_dist f32[k], rows i32[k]); padding /
    masked rows surface as (-inf, R)."""
    _check_fp32(matrix)
    valid = _valid_mask(matrix.shape[0], nrows, dead_rows, matrix.device)
    nd, rows = _topk_rows(matrix, norms, valid, qv[None, :], k, metric)
    return nd[0], rows[0]


def topk_candidates_batch(matrix, norms, Q, nrows, dead_rows, *,
                          k: int, metric: str):
    """Stacked-query candidate stage: Q [B, D] -> per-query (neg_dist
    f32[B, k], rows i32[B, k]). One product [B, D] @ [D, R] for B queries
    (in chunks bounding the [B, R] buffers), so B concurrent queries pay
    the fixed dispatch and sync once (query/batch.py). Per-query
    candidates obey the solo contract (a float32 superset the host
    re-ranks in float64), so batched results are byte-identical to solo
    execution."""
    _check_fp32(matrix)
    R = matrix.shape[0]
    valid = _valid_mask(R, nrows, dead_rows, matrix.device)
    step = max(1, _BATCH_CHUNK_CELLS // max(R, 1))
    parts = [_topk_rows(matrix, norms, valid, Q[i: i + step], k, metric)
             for i in range(0, Q.shape[0], step)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def ivf_topk(matrix, norms, qv, cand_rows, *, k: int, metric: str):
    """IVF fine stage: score only the gathered candidate rows (cand_rows
    sentinel-padded with R) — gather + product + top-k of the selected
    nprobe lists. Ties go to the earlier position in cand_rows."""
    _check_fp32(matrix)
    R = matrix.shape[0]
    cand = cand_rows.to(torch.int64)
    ok = cand < R
    rc = torch.clamp(cand, 0, R - 1)
    nd = _neg_dist(matrix[rc], norms[rc], qv[None, :], metric)[0]
    nd = torch.where(ok, nd, float("-inf"))
    kk = min(k, int(cand_rows.shape[0]))
    cs, ci = _stable_topk(nd, kk)
    rows = torch.where(cs > float("-inf"), rc[ci], R).to(torch.int32)
    if kk < k:
        cs = torch.cat([cs, torch.full((k - kk,), float("-inf"),
                                       dtype=torch.float32,
                                       device=cs.device)])
        rows = torch.cat([rows, torch.full((k - kk,), R, dtype=torch.int32,
                                           device=rows.device)])
    return cs, rows


def ann_expand(matrix, norms, qv, nrows, dead_rows, vec_subjects,
               csr_subjects, indptr, indices, *,
               k: int, metric: str, ecap: int):
    """Fused ANN -> graph hop: top-k candidate rows, map rows -> uids ->
    CSR rows, expand the candidate frontier, with no host round trip
    between the ANN stage and the traversal stage.

    Returns (neg_dist f32[k], cand_uids i32[k] sentinel-padded,
    ExpandResult over the k candidate slots). The host slices the
    expansion rows of the float64-selected final k."""
    R = matrix.shape[0]
    nd, rows = topk_candidates(matrix, norms, qv, nrows, dead_rows,
                               k=k, metric=metric)
    dt = csr_subjects.dtype if csr_subjects.shape[0] else torch.int32
    snt = int(sentinel(dt))
    ok = nd > float("-inf")
    uids = torch.where(ok, vec_subjects[torch.clamp(rows.to(torch.int64),
                                                    0, R - 1)], snt)
    if csr_subjects.shape[0]:
        n = csr_subjects.shape[0]
        pos = torch.clamp(torch.searchsorted(csr_subjects, uids), 0, n - 1)
        hit = ok & (csr_subjects[pos] == uids)
        crows = torch.where(hit, pos.to(torch.int32), snt)
    else:
        crows = torch.full((k,), snt, dtype=torch.int32, device=nd.device)
    res = expand(indptr, indices, crows.to(torch.int32), ecap)
    return nd, uids.to(torch.int32), res


__all__ = ["METRICS", "BLOCK_ROWS", "ExpandResult", "row_capacity",
           "k_capacity", "host_distances", "topk_candidates",
           "topk_candidates_batch", "ivf_topk", "ann_expand"]


# device-runtime observatory (obs/devprof.py): device entry points by the
# JAX program-family names, probed on /debug/compiles (see ops/segments.py)
JIT_PROGRAMS = {
    "vector.topk": topk_candidates,
    "vector.topk_batch": topk_candidates_batch,
    "vector.ivf_topk": ivf_topk,
    "vector.ann_expand": ann_expand,
}
