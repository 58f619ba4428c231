"""Immutable graph snapshots: host CSR columns plus lazily uploaded device
columns.

Port of the snapshot types of dgraph_tpu/storage/csr_build.py for the uid
traversal slice: MAX_DEVICE_UID, PredCSR, PredData (its uid parts) and
GraphSnapshot. A snapshot at read_ts is a set of immutable per-predicate
arrays; the host numpy columns are the authoritative fold (frontier→row
mapping, degree counting and recurse edge dedup run on them), and the
device columns are a cache uploaded on first kernel access. Folding a
posting Store into a snapshot (build_pred / build_snapshot, LazyPreds,
SnapshotAssembler) waits for the Node slice; snapshots are built from numpy
arrays here (carry.snapshot_from_numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.utils.types import TypeID

MAX_DEVICE_UID = 2**31 - 2  # int32 space, sentinel-exclusive


class PredCSR:
    """Adjacency of one predicate: row r = subjects[r] →
    indices[indptr[r]:indptr[r+1]], int32 host columns; device columns on
    `device`, uploaded at first access."""

    def __init__(self, subjects, indptr, indices,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self._subjects_h = np.asarray(subjects)   # int32[N] sorted
        self._indptr_h = np.asarray(indptr)       # int32[N+1]
        self._indices_h = np.asarray(indices)     # int32[E] sorted per row
        for name, a in (("subjects", self._subjects_h),
                        ("indices", self._indices_h)):
            if len(a) and (int(a.max()) > MAX_DEVICE_UID or int(a.min()) < 0):
                raise ValueError(f"{name}: uid outside the device uid space "
                                 f"[0, {MAX_DEVICE_UID}]")
        self._dev: tuple | None = None

    @property
    def num_edges(self) -> int:
        return int(self._indices_h.shape[0])

    def device_arrays(self) -> tuple:
        """(subjects, indptr, indices) as int32 tensors on self.device."""
        if self._dev is None:
            self._dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                    self.device)
                for a in (self._subjects_h, self._indptr_h,
                          self._indices_h))
        return self._dev

    @property
    def subjects(self) -> torch.Tensor:
        return self.device_arrays()[0]

    @property
    def indptr(self) -> torch.Tensor:
        return self.device_arrays()[1]

    @property
    def indices(self) -> torch.Tensor:
        return self.device_arrays()[2]

    def host_arrays(self) -> tuple:
        """(subjects, indptr, indices) as numpy — the host truth."""
        return (self._subjects_h, self._indptr_h, self._indices_h)


def transpose_csr(subjects, indptr, indices) -> tuple:
    """Reverse adjacency (object → sorted subjects) of a CSR, as the
    @reverse ReverseKey tablets fold it: int32 (subjects, indptr, indices)."""
    subjects = np.asarray(subjects, dtype=np.int64)
    src = np.repeat(subjects, np.diff(np.asarray(indptr)))
    dst = np.asarray(indices, dtype=np.int64)
    order = np.lexsort((src, dst))
    rsub, counts = np.unique(dst[order], return_counts=True)
    rptr = np.zeros(len(rsub) + 1, dtype=np.int32)
    np.cumsum(counts, out=rptr[1:])
    return (rsub.astype(np.int32), rptr, src[order].astype(np.int32))


@dataclass
class PredData:
    """The uid parts of one predicate's snapshot. Value columns, token
    indexes, facets and vectors wait for later slices of the port."""

    attr: str
    type_id: TypeID
    csr: PredCSR | None = None
    rev_csr: PredCSR | None = None

    def has_subjects(self) -> np.ndarray:
        """uids for has(attr): subjects with any edge."""
        if self.csr is None:
            return np.zeros(0, dtype=np.int32)
        return np.unique(self.csr.host_arrays()[0])


class GraphSnapshot:
    """Immutable view of (a subset of) the graph at read_ts on one device."""

    def __init__(self, read_ts: int,
                 device: str | torch.device = "cuda") -> None:
        self.read_ts = read_ts
        self.device = resolve_device(device)
        self.preds: dict[str, PredData] = {}

    def pred(self, attr: str) -> PredData | None:
        return self.preds.get(attr)
