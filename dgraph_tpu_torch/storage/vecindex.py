"""Device-resident vector index: per-predicate embedding matrix + overlay.

Port of dgraph_tpu/storage/vecindex.py. The tokenizer/index extension point
(reference tok/ + posting/index.go; mirrored in utils/tok.py +
storage/index.py) admits new index types; this is the device one: a
predicate declared
`pred: float32vector @index(vector(dim: D[, metric: ...]))` folds — at
snapshot assembly, exactly where token indexes fold — into a row-aligned
`[n_subjects, D]` float32 matrix with precomputed norms, uploaded to the
snapshot's device at the first device-path search, so the similarity probe
(`similar_to` in DQL) is a matrix product + top-k (ops/vector.py).

Freshness follows storage/delta.py's delta-main split, one level up:

  * a commit touching the predicate STAMPS a `VecOverlay` — the UNCHANGED
    base matrix (device identity preserved: no re-fold, no re-upload) plus
    replacement rows for exactly the touched subjects, O(Δ);
  * searches merge on read: base candidates (touched rows masked on
    device) + overlay rows re-scored host-side, one ranking rule;
  * compaction (SnapshotAssembler.compact -> build_pred) folds the overlay
    back into a fresh base — stamped and folded views rank identically
    (tests/test_vector.py asserts byte-equivalence).

Ranking rule (shared by EVERY path — host scan, device brute force, IVF,
fused ANN->expand): float32 device stages only produce a
candidate superset; the final k is picked host-side by exact float64
(distance, uid). Brute force is therefore byte-identical to a host
float64 scan whenever the float32 margin holds (the acceptance gate), and
toggling host/device/IVF paths can never change a result.

IVF: at fold time, tablets past `IVF_MIN_ROWS` also build a k-means
coarse quantizer (deterministic seeded Lloyd's in host numpy, so the
centroids and lists equal the JAX package's bit for bit); searches scan the
`nprobe` nearest lists (`VECTOR_NPROBE`, --vector_nprobe) and re-score
candidates exactly. Recall@k >= 0.95 is gated in tests and chip_smoke.py.

A mesh placement (`_mesh`, set by parallel/mesh_exec.MeshExecutor on its
copy of the index) scans rows sharded across the mesh with a replicated
top-k merge; the float64 re-rank stays on the host, so the answer is the
same bytes. It wins over IVF: the sharded brute scan is what the
placement exists for.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.obs import otrace
from dgraph_tpu_torch.ops import vector as vops
from dgraph_tpu_torch.utils.schema import VectorSpec
from dgraph_tpu_torch.utils.types import TypeID, Val

# below this many row*dim float32 cells the float64 host scan beats the
# device's fixed per-dispatch + sync cost (the same size-adaptive switch
# task.HOST_EXPAND_MAX applies to frontier expands)
HOST_SCAN_MAX = 1 << 16

# IVF knobs (ops-tunable: --vector_nprobe / --vector_centroids; docs/ops.md)
IVF_MIN_ROWS = 4096          # smaller tablets stay brute-force exact
VECTOR_NPROBE = 8            # coarse lists scanned per query
VECTOR_CENTROIDS = 0         # 0 = auto (~sqrt(n), clamped to [8, 1024])
_KMEANS_ITERS = 8
_KMEANS_SEED = 7


@dataclass(frozen=True)
class VectorKnobs:
    """Per-node IVF knob overrides (Node kwargs / serve flags). Rides the
    node's Store into the fold (csr_build) so two Nodes in one process
    never see each other's thresholds; zero/negative fields keep the
    module defaults above.

    nprobe is stamped onto each VectorIndex at fold time — the coarse
    quantizer and the lists-scanned-per-query knob belong to the same
    index instance."""

    nprobe: int = 0              # 0 = VECTOR_NPROBE
    centroids: int = -1          # -1 = VECTOR_CENTROIDS, 0 = auto
    ivf_min_rows: int = 0        # 0 = IVF_MIN_ROWS


@dataclass
class IVFIndex:
    """Coarse quantizer: centroids + row lists (CSR over parent rows)."""

    centroids: np.ndarray        # float32 [C, D]
    list_indptr: np.ndarray      # int64 [C+1]
    list_rows: np.ndarray        # int32 [n] parent row ids, grouped by list

    @property
    def n_lists(self) -> int:
        return len(self.centroids)

    def nbytes(self) -> int:
        return int(self.centroids.nbytes + self.list_indptr.nbytes +
                   self.list_rows.nbytes)


class VectorIndex:
    """One predicate's folded vector index: sorted subjects + row-aligned
    embedding matrix (host float32 mirror; device tensors upload to
    `device` lazily on the first device-path search and keep identity for
    the snapshot's lifetime — the device-resident contract)."""

    is_overlay = False
    # residency owner protocol (storage/residency.py): the [R, D] device
    # matrix + norms + subjects are the droppable buffer group; the host
    # float32 fold is the warm-tier truth
    _res = None
    _res_attr = ""
    _res_kind = "vec"

    def __init__(self, attr: str, spec: VectorSpec, subjects: np.ndarray,
                 vecs: np.ndarray, ivf: IVFIndex | None = None,
                 nprobe: int = 0,
                 device: str | torch.device = "cuda") -> None:
        self.torch_device = resolve_device(device)
        self.attr = attr
        self.dim = int(spec.dim)
        self.metric = spec.metric
        self.subjects = np.asarray(subjects, dtype=np.int64)   # sorted
        self.vecs = np.asarray(vecs, dtype=np.float32).reshape(
            len(self.subjects), self.dim)
        self.ivf = ivf
        self.nprobe = int(nprobe)    # 0 = VECTOR_NPROBE at search time
        self._vecs64 = None      # lazy float64 mirror (exact re-rank)
        self._dev = None         # lazy (matrix[R,D], norms[R], subs[R])
        self._mesh = None        # mesh placement (parallel/mesh_exec.py)

    @property
    def n(self) -> int:
        return len(self.subjects)

    def nbytes(self) -> int:
        return int(self.subjects.nbytes + self.vecs.nbytes +
                   (self._vecs64.nbytes if self._vecs64 is not None else 0) +
                   (self.ivf.nbytes() if self.ivf is not None else 0))

    def vecs64(self) -> np.ndarray:
        """Full float64 mirror — host-scan-class tablets only (<= 64 KB
        float32); device-class paths must slice candidates via rows64()
        so a large tablet never pins an 8*n*D host copy."""
        if self._vecs64 is None:
            m = self.vecs.astype(np.float64)
            if self.n * self.dim <= HOST_SCAN_MAX:
                self._vecs64 = m
            else:
                return m
        return self._vecs64

    def rows64(self, rows: np.ndarray) -> np.ndarray:
        """Float64 view of the selected candidate rows (exact re-rank)."""
        if self._vecs64 is not None:
            return self._vecs64[rows]
        return self.vecs[rows].astype(np.float64)

    def device(self, prefetch: bool = False):
        """(matrix [R, D], norms [R], subjects [R] int32) on
        self.torch_device, padded to the pow2 row-capacity class (the JAX
        package's shape classes; padding rows are masked invalid). Uploads through the
        residency seam when managed — admission against the device budget,
        evictable back to the warm host tier without touching this
        object's identity."""
        from dgraph_tpu_torch.storage import residency as resmod

        def build():
            R = vops.row_capacity(self.n)
            mat = np.zeros((R, self.dim), dtype=np.float32)
            mat[: self.n] = self.vecs
            norms = np.ones(R, dtype=np.float32)
            norms[: self.n] = np.linalg.norm(self.vecs, axis=1)
            subs = np.zeros(R, dtype=np.int32)
            subs[: self.n] = self.subjects.astype(np.int32)
            return tuple(torch.from_numpy(a).to(self.torch_device)
                          for a in (mat, norms, subs))

        return resmod.ensure_device(self, "_dev", build, prefetch=prefetch)

    def device_resident(self) -> bool:
        return self._dev is not None

    def drop_device(self) -> None:
        self._dev = None

    def device_nbytes(self) -> int:
        R = vops.row_capacity(self.n)
        return int(R * self.dim * 4 + R * 4 + R * 4)

    def prefer_host(self) -> bool:
        from dgraph_tpu_torch.storage import residency as resmod

        return resmod.prefer_host(self)


class VecOverlay:
    """VectorIndex view = unchanged base + replacement rows for the
    touched subjects (has[i]=False deletes). Never stacks: the assembler
    re-stamps from the true folded base (storage/delta.py contract)."""

    is_overlay = True

    def __init__(self, base: VectorIndex | None, attr: str,
                 spec: VectorSpec, subs: np.ndarray, vecs: np.ndarray,
                 has: np.ndarray) -> None:
        assert base is None or not base.is_overlay
        self.base = base
        self.attr = attr
        self.dim = int(spec.dim)
        self.metric = spec.metric
        self.subs = np.asarray(subs, dtype=np.int64)        # sorted
        self.ovecs = np.asarray(vecs, dtype=np.float32).reshape(
            len(self.subs), self.dim)
        self.has = np.asarray(has, dtype=bool)
        # base rows shadowed by the overlay (masked out of device scans)
        if base is not None and base.n:
            from dgraph_tpu_torch.ops import uidset as us

            rb = us.host_rank_of(base.subjects, self.subs, -1)
            self.dead_rows = rb[rb >= 0].astype(np.int32)
        else:
            self.dead_rows = np.zeros(0, np.int32)

    @property
    def n(self) -> int:
        base_n = self.base.n if self.base is not None else 0
        return base_n - len(self.dead_rows) + int(self.has.sum())

    def nbytes(self) -> int:
        return int(self.subs.nbytes + self.ovecs.nbytes +
                   self.has.nbytes + self.dead_rows.nbytes)

    def live_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """(subjects, vecs float64) of the overlay's live replacement rows."""
        return self.subs[self.has], self.ovecs[self.has].astype(np.float64)


# ---------------------------------------------------------------------------
# fold / stamp
# ---------------------------------------------------------------------------

def _kmeans(vecs: np.ndarray, k: int, iters: int, seed: int) -> np.ndarray:
    """Deterministic Lloyd's over float32 rows; empty clusters re-seed from
    the farthest points so every centroid stays live."""
    rng = np.random.default_rng(seed)
    n = len(vecs)
    cent = vecs[rng.choice(n, size=k, replace=False)].astype(np.float64)
    x = vecs.astype(np.float64)
    x2 = np.einsum("ij,ij->i", x, x)
    for _ in range(iters):
        d = x2[:, None] - 2.0 * (x @ cent.T) + \
            np.einsum("ij,ij->i", cent, cent)[None, :]
        assign = np.argmin(d, axis=1)
        empties = []
        for c in range(k):
            m = assign == c
            if m.any():
                cent[c] = x[m].mean(axis=0)
            else:
                empties.append(c)
        if empties:
            # DISTINCT farthest points per empty cluster (k <= n
            # guarantees enough), not one shared argmax — duplicate
            # centroids would split a list's rows arbitrarily and waste
            # nprobe slots on clones
            far = np.argsort(d.min(axis=1))[::-1]
            for j, c in enumerate(empties):
                cent[c] = x[int(far[j])]
    return cent.astype(np.float32)


def _build_ivf(vecs: np.ndarray, metric: str,
               centroids: int = -1) -> IVFIndex:
    n = len(vecs)
    k = (centroids if centroids >= 0 else VECTOR_CENTROIDS) \
        or int(np.clip(int(np.sqrt(n)), 8, 1024))
    k = min(k, n)
    if metric == "cosine":
        # cosine is scale-invariant: cluster DIRECTIONS (row-normalized
        # spherical space), or vectors of different norms pointing the
        # same way land in different lists and the probe misses them
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        vecs = (vecs / np.maximum(norms, 1e-30)).astype(np.float32)
    cent = _kmeans(vecs, k, _KMEANS_ITERS, _KMEANS_SEED)
    # assignment by L2 to the centroid in the (possibly normalized)
    # coarse space — standard IVF
    x = vecs.astype(np.float64)
    c64 = cent.astype(np.float64)
    d = (np.einsum("ij,ij->i", x, x)[:, None] - 2.0 * (x @ c64.T) +
         np.einsum("ij,ij->i", c64, c64)[None, :])
    assign = np.argmin(d, axis=1)
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=k)
    indptr = np.zeros(k + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return IVFIndex(cent, indptr, order.astype(np.int32))


def _subject_vectors(spec: VectorSpec, host_values: dict[int, Val]):
    subs, rows = [], []
    for u in sorted(host_values):
        v = host_values[u]
        if v.tid != TypeID.VECTOR or len(v.value) != spec.dim:
            continue          # defensive: mutation validation enforces dim
        subs.append(u)
        rows.append(v.value)
    return subs, rows


def build_vecindex(attr: str, spec: VectorSpec,
                   host_values: dict[int, Val],
                   knobs: VectorKnobs | None = None,
                   device: str | torch.device = "cuda") -> VectorIndex | None:
    """Fold one predicate's vector rows at snapshot assembly (the vector
    analog of csr_build's token-index fold). None when no rows. Host only:
    the matrix uploads to `device` at its first device search."""
    from dgraph_tpu_torch.storage.csr_build import MAX_DEVICE_UID

    subs, rows = _subject_vectors(spec, host_values)
    if not subs:
        return None
    if subs[-1] > MAX_DEVICE_UID:      # sorted; same read-time contract
        raise ValueError(             # as the CSR/value-table folds
            f"uid {subs[-1]} exceeds device uid space")
    vecs = np.asarray(rows, dtype=np.float32)
    min_rows = (knobs.ivf_min_rows if knobs and knobs.ivf_min_rows > 0
                else IVF_MIN_ROWS)
    ivf = _build_ivf(vecs, spec.metric,
                     knobs.centroids if knobs else -1) \
        if len(subs) >= min_rows else None
    return VectorIndex(attr, spec, np.asarray(subs, dtype=np.int64),
                       vecs, ivf, nprobe=knobs.nprobe if knobs else 0,
                       device=device)


def stamp_vecindex(base: VectorIndex | None, attr: str, spec: VectorSpec,
                   touched: np.ndarray,
                   host_values: dict[int, Val]) -> "VecOverlay | VectorIndex | None":
    """O(Δ) overlay stamp: replacement rows for the commit's touched
    subjects, derived from the already-patched host_values (the same
    source a full fold reads — byte-equivalence by construction)."""
    subs = np.asarray(sorted(int(s) for s in touched), dtype=np.int64)
    vecs = np.zeros((len(subs), spec.dim), dtype=np.float32)
    has = np.zeros(len(subs), dtype=bool)
    for i, u in enumerate(subs.tolist()):
        v = host_values.get(u)
        if v is not None and v.tid == TypeID.VECTOR and \
                len(v.value) == spec.dim:
            vecs[i] = np.asarray(v.value, dtype=np.float32)
            has[i] = True
    if base is None and not has.any():
        return None
    return VecOverlay(base, attr, spec, subs, vecs, has)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _rank(dists: np.ndarray, uids: np.ndarray, k: int):
    """Final (distance, uid) ascending rank — THE selection rule."""
    order = np.lexsort((uids, dists))[: k]
    return uids[order], dists[order]


def _rescore(base: VectorIndex, rows: np.ndarray, q64: np.ndarray):
    d = vops.host_distances(base.rows64(rows), q64, base.metric)
    return base.subjects[rows], d


def _device_candidates(vi: VectorIndex, q: np.ndarray, kprime: int,
                       dead_rows: np.ndarray, metrics=None) -> np.ndarray:
    """Float32 device candidate rows (superset stage). Mesh-sharded
    placements fan the row scan across the mesh with a replicated top-k
    merge (parallel/mesh_exec.py)."""
    if vi._mesh is not None:
        return vi._mesh.vector_topk(vi, q, kprime, dead_rows)
    mat, norms, _subs = vi.device()
    with otrace.span("device_kernel", kernel="vector.topk",
                     rows=int(vi.n), k=kprime) as sp:
        nd, rows = vops.topk_candidates(
            mat, norms, torch.from_numpy(q.astype(np.float32)).to(mat.device),
            vi.n, torch.from_numpy(np.asarray(dead_rows, np.int32)),
            k=kprime, metric=vi.metric)
        rows_h = rows.cpu().numpy()
        nd_h = nd.cpu().numpy()
        if sp:
            sp.set(transfer_d2h_bytes=int(rows_h.nbytes + nd_h.nbytes))
    return rows_h[nd_h > -np.inf]


def _ivf_candidate_rows(vi: VectorIndex, q64: np.ndarray,
                        nprobe: int) -> np.ndarray:
    ivf = vi.ivf
    # coarse ranking in the index's own metric: cosine queries must rank
    # lists scale-invariantly (a 0.01x query has the same exact answer,
    # so it must probe the same lists)
    cd = vops.host_distances(ivf.centroids.astype(np.float64), q64,
                             vi.metric)
    lists = np.argsort(cd, kind="stable")[: max(nprobe, 1)]
    parts = [ivf.list_rows[ivf.list_indptr[c]: ivf.list_indptr[c + 1]]
             for c in sorted(lists.tolist())]
    return np.concatenate(parts) if parts else np.zeros(0, np.int32)


def search(vi, q, k: int, *, nprobe: int | None = None,
           exact: bool | None = None, metrics=None):
    """Top-k nearest subjects of one vector index view.

    Returns (uids int64[<=k], dists float64[<=k]) ranked by (distance,
    uid) ascending — identical across the host-scan / device / IVF /
    overlay paths by the shared float64 re-rank.

    exact: None = auto (IVF when the fold built one), True forces the
    brute-force path (the recall gate's reference), False forces IVF.
    """
    if vi is None or k <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    q = np.asarray(q, dtype=np.float32).reshape(-1)
    if len(q) != vi.dim:
        from dgraph_tpu_torch.query.task import TaskError

        raise TaskError(
            f"similar_to({vi.attr}): query vector dim {len(q)} != "
            f"index dim {vi.dim}")
    q64 = q.astype(np.float64)
    if metrics is not None:
        metrics.counter("dgraph_vector_searches_total").inc()

    base = vi.base if vi.is_overlay else vi
    dead = vi.dead_rows if vi.is_overlay else np.zeros(0, np.int32)

    # residency tier consult: a COLD vector tablet (device matrix larger
    # than the whole device budget) serves the exact float64 host scan —
    # the same ranking rule, never an upload
    cold = base is not None and base.prefer_host()
    if cold and getattr(base, "_res", None) is not None:
        base._res.note_cold_serve()

    def _host_scan():
        d = vops.host_distances(base.vecs64(), q64, base.metric)
        if len(dead):
            d[dead] = np.inf
        rows = np.argsort(d, kind="stable")[: min(k, base.n)]
        rows = rows[np.isfinite(d[rows])]
        cand_subs.append(base.subjects[rows])
        cand_d.append(d[rows])

    cand_subs: list[np.ndarray] = []
    cand_d: list[np.ndarray] = []
    if base is not None and base.n:
        # a mesh-sharded placement wins over IVF: the sharded brute scan
        # is what the placement exists for (per-device row slices), while
        # _ivf_device_stage would upload the FULL base matrix to one
        # device — exactly the memory profile sharding avoids
        use_ivf = base._mesh is None and ((exact is False) or (
            exact is None and base.ivf is not None))
        if use_ivf and base.ivf is not None:
            if metrics is not None:
                metrics.counter("dgraph_vector_ivf_probes_total").inc()
            rows = _ivf_candidate_rows(
                base, q64,
                nprobe or base.nprobe or VECTOR_NPROBE)
            if len(dead):
                rows = rows[~np.isin(rows, dead)]
            if len(rows):
                if len(rows) * base.dim > HOST_SCAN_MAX and not cold:
                    from dgraph_tpu_torch.utils.faults import FaultError

                    try:
                        rows = _ivf_device_stage(base, q, rows, k, metrics)
                    except FaultError:
                        pass    # injected h2d fault: exact host re-rank
                        # of the full probed candidate set (a superset)
                s, d = _rescore(base, rows, q64)
                cand_subs.append(s)
                cand_d.append(d)
        elif base.n * base.dim <= HOST_SCAN_MAX or cold:
            # tiny tablet (or cold tier): exact float64 host scan, no
            # dispatch (sized on the BASE so vecs64() caching always
            # applies for the tiny case; a large base with many
            # overlay-dead rows stays on the device path, which masks
            # them without pinning a full float64 mirror)
            _host_scan()
        else:
            from dgraph_tpu_torch.utils.faults import FaultError

            kprime = vops.k_capacity(k, vops.row_capacity(base.n))
            try:
                rows = _device_candidates(base, q, kprime, dead, metrics)
            except FaultError:
                # injected h2d fault at the upload seam: byte-identical
                # host scan (the shared float64 ranking rule)
                rows = None
            if rows is None:
                _host_scan()
            elif len(rows):
                s, d = _rescore(base, rows, q64)
                cand_subs.append(s)
                cand_d.append(d)
    if vi.is_overlay:
        osubs, ovecs = vi.live_rows()
        if len(osubs):
            cand_subs.append(osubs)
            cand_d.append(vops.host_distances(ovecs, q64, vi.metric))
    if not cand_subs:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    return _rank(np.concatenate(cand_d), np.concatenate(cand_subs), k)


def _ivf_device_stage(base: VectorIndex, q: np.ndarray, rows: np.ndarray,
                      k: int, metrics=None) -> np.ndarray:
    """Large IVF candidate set: gather + score + top-k on device, then the
    usual float64 re-rank over the reduced set. The candidate vector is
    padded to the JAX package's pow2 class: k' derives from it, and k' sets
    which tied rows survive."""
    mat, norms, _subs = base.device()
    R = int(mat.shape[0])
    ccap = 1 << max(int(np.ceil(np.log2(len(rows) + 1))), 4)
    cr = np.full(ccap, R, np.int32)
    cr[: len(rows)] = rows
    kprime = vops.k_capacity(k, ccap)
    with otrace.span("device_kernel", kernel="vector.ivf_topk",
                     cands=int(len(rows)), k=kprime) as sp:
        nd, sel = vops.ivf_topk(
            mat, norms,
            torch.from_numpy(q.astype(np.float32)).to(mat.device),
            torch.from_numpy(cr).to(mat.device), k=kprime,
            metric=base.metric)
        sel_h = sel.cpu().numpy()
        nd_h = nd.cpu().numpy()
        if sp:
            sp.set(transfer_d2h_bytes=int(sel_h.nbytes + nd_h.nbytes))
    return sel_h[nd_h > -np.inf]
