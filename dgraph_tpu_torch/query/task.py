"""process_task: execute one (predicate, frontier, function) task on a
snapshot.

Port of dgraph_tpu/query/task.py. Reference semantics: worker/task.go
processTask (:605) dispatches on posting-list kind: handleValuePostings
(:319, value predicates: fetch/convert/compare) or handleUidPostings (:476,
uid/index/reverse/count lists). Function taxonomy at :211-271: eq/le/lt/
ge/gt (indexed, via worker/tokens.go:124 getInequalityTokens), has, uid_in,
regexp (trigram index + automaton :768), term (anyofterms/allofterms),
full-text, geo (:921), compare-scalar over the count index (:1498),
password. Lossy tokenizers re-check candidates against stored values
(:837-919).

The per-uid pointer walk is one batched CSR gather (ops/csr.expand) over the
predicate's device adjacency, or a host-mirror gather below HOST_EXPAND_MAX
edges. A frontier of uidset.HOST_CUTOVER uids or more maps to CSR rows on
the card (the device subjects and indptr), a smaller one by a binary
search of the host mirror. expand_route is the one decision of the path,
for the solo expand and the batcher's classification (query/batch.py)
alike, and gather_on_device the one device gather of both. Every path
keeps the level's uidMatrix as columns (UidMatrix: flat targets and row
offsets), and the device gather dedups the level's dest set on the card
beside it (ops/csr.unique_targets); its targets stay on the card until a
reader asks for rows, and rows are views cut, and the targets cast to
int64, only where one does. Over a delta overlay
(storage/delta.OverlayCSR) the base's rows come from the same two paths
(ops/csr.expand_masked on the device) and the overlay's replacement rows
are spliced in. Index functions pick token rows on the host (the term
table is small) and union the rows' uid lists on the host below
HOST_EXPAND_MAX uids, on the snapshot's device above it
(ops/csr.expand_dest). Numeric compares read the float64 host mirror
(num_values_host), as the JAX package does: exact for INT below 2^53,
DATETIME, FLOAT and BOOL.

similar_to probes the vector index (storage/vecindex.search): the top-k
uids with their float64 distances, which the engine binds as the
`vector_distance` value variable.
"""

from __future__ import annotations

import bisect
import re as remod
import threading
from contextlib import nullcontext
from dataclasses import dataclass, field, replace
from typing import NamedTuple

import numpy as np
import torch

from dgraph_tpu_torch.obs import costs, otrace
from dgraph_tpu_torch.ops import csr as csrops
from dgraph_tpu_torch.ops import uidset as us
from dgraph_tpu_torch.storage.csr_build import (GraphSnapshot, PredCSR,
                                                PredData, TokenIndex)
from dgraph_tpu_torch.storage.delta import (OverlayCSR, csr_subjects_degrees,
                                            csr_subjects_host)
from dgraph_tpu_torch.utils import geo as geomod
from dgraph_tpu_torch.utils.faults import FaultError
from dgraph_tpu_torch.utils import tok as tokmod
from dgraph_tpu_torch.utils.schema import SchemaState
from dgraph_tpu_torch.utils.types import (TypeID, Val, compare_vals, convert,
                                          to_device_scalar, verify_password)


class TaskError(ValueError):
    pass


# below this edge (or index uid) volume the host-mirror gather beats a
# device dispatch + sync (reference algo/uidlist.go:147-155 ratio
# heuristic). It picks a path, never an output. The TPU-era value holds on
# an H100 (bench_torch_crossover.py): the two gathers tie at ~2^16 edges,
# the host wins 2.5x at ~2^12 and the device 1.7x at 2^18.
HOST_EXPAND_MAX = 1 << 16

# frontier filters over a uid predicate: finish_uid_expand keeps the
# frontier slots their rows pass and merges no dest, so their expand
# computes none
_ROW_FILTERS = ("uid_in", "has")


@dataclass
class TaskQuery:
    """One execution task (reference: intern.Query, protos/internal.proto:38)."""

    attr: str
    frontier: np.ndarray | None = None      # subject uids; None = root function
    func: tuple[str, list] | None = None    # (name, args) root/filter function
    reverse: bool = False                   # traverse ReverseKey space (~attr)
    lang: str = ""
    facet_keys: list[str] = field(default_factory=list)  # non-empty: attach facets
    first: int = 0                          # per-uid result truncation
    # override of the host/device expand cutover (0 = HOST_EXPAND_MAX);
    # groupby pins key expansions to the host with it. Results are the
    # same either way, so qcache.task_key leaves it out.
    cutover: int = 0


class UidMatrix:
    """A uid level's uidMatrix as columns: flat int64 targets grouped by
    frontier slot, and int64 offsets, one more than the frontier has
    slots. It reads as the list of per-slot rows it replaces: len, m[i]
    (the view flat[offsets[i]:offsets[i + 1]]) and iteration. Read-only: a
    caller that replaces rows assigns a plain list. The targets may arrive
    in the gather's own integer dtype: flat casts them to int64 on its
    first read, so a level no reader walks never pays the cast. A device
    gather's targets may stay on the card as a tensor: the first reader
    of a row copies them back, once, in a uidmatrix.fetch seam of its own
    (counted in `metrics`' dgraph_expand_targets_fetched_total); len,
    counts and nbytes read the offsets alone. dest is the level's
    sorted-unique targets where the gather computed them beside the rows
    (on the card), else None; dest_dev is the card's copy of that dest,
    which finish_uid_expand moves onto the TaskResult."""

    __slots__ = ("_flat", "offsets", "dest", "dest_dev", "_metrics")

    def __init__(self, flat: np.ndarray | torch.Tensor, offsets: np.ndarray,
                 dest: np.ndarray | None = None, metrics=None,
                 dest_dev: torch.Tensor | None = None) -> None:
        self._flat = flat
        self.offsets = offsets
        self.dest = dest
        self.dest_dev = dest_dev
        self._metrics = metrics

    @classmethod
    def from_rows(cls, rows) -> "UidMatrix":
        rows = [np.asarray(r, dtype=np.int64) for r in rows]
        offs = np.zeros(len(rows) + 1, dtype=np.int64)
        if rows:
            np.cumsum([len(r) for r in rows], out=offs[1:])
        flat = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        return cls(flat, offs)

    @classmethod
    def empty(cls, n: int = 0) -> "UidMatrix":
        """n empty rows."""
        return cls(np.zeros(0, np.int64), np.zeros(n + 1, np.int64))

    def _host(self) -> np.ndarray:
        """The targets on the host, in the gather's dtype: a tensor still
        on the card is copied back here, once, whichever thread asks
        first (the task cache shares one matrix between requests)."""
        flat = self._flat
        if isinstance(flat, torch.Tensor):
            with _FETCH_LOCK:
                flat = self._flat
                if isinstance(flat, torch.Tensor):
                    with costs.kernel("uidmatrix.fetch",
                                      edges=flat.numel()) as ck:
                        flat = flat.cpu().numpy()
                        ck.set(d2h=flat.nbytes)
                    if self._metrics is not None:
                        self._metrics.counter(
                            "dgraph_expand_targets_fetched_total").inc()
                    self._flat = flat
        return flat

    @property
    def flat(self) -> np.ndarray:
        flat = self._host()
        if flat.dtype != np.int64:
            flat = self._flat = flat.astype(np.int64)
        return flat

    def nbytes(self) -> int:
        """The columns' bytes with the targets as int64, read without
        fetching or casting them."""
        return 8 * len(self._flat) + int(self.offsets.nbytes)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        n = len(self)
        if not -n <= i < n:
            raise IndexError("uidMatrix row out of range")
        i %= n
        return self.flat[self.offsets[i]: self.offsets[i + 1]]

    def __iter__(self):
        flat, offs = self.flat, self.offsets.tolist()
        return (flat[offs[i]: offs[i + 1]] for i in range(len(offs) - 1))

    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def truncated(self, first: int) -> "UidMatrix":
        """Each row cut to row[:first] (first > 0) or row[first:]
        (first < 0), in one pass over the flat targets."""
        flat = self._host()
        cnt = self.counts()
        keep = np.minimum(cnt, abs(first))
        pos = np.arange(len(flat)) - np.repeat(self.offsets[:-1], cnt)
        mask = (pos < first) if first > 0 else \
            (pos >= np.repeat(cnt - keep, cnt))
        offs = np.zeros(len(cnt) + 1, dtype=np.int64)
        np.cumsum(keep, out=offs[1:])
        return UidMatrix(flat[mask], offs)


# one device-held matrix's targets are copied back once, whichever reader
# asks first
_FETCH_LOCK = threading.Lock()


@dataclass
class TaskResult:
    """Reference: intern.Result (protos/internal.proto:69). Rows given as
    a list are taken into a UidMatrix. counts is an int64 array where an
    expand made it, a list where the wire did. dest_dev is the card's copy
    of dest_uids where the device gather deduplicated the level there
    (gather_on_device with want_dest), set only while equal to dest_uids:
    the task cache keeps none (qcache) and the wire sends none."""

    uid_matrix: UidMatrix = field(default_factory=UidMatrix.empty)
    value_matrix: list[list[Val]] = field(default_factory=list)
    facet_matrix: list[list[tuple]] = field(default_factory=list)
    counts: np.ndarray | list[int] = field(default_factory=list)
    dest_uids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    traversed_edges: int = 0
    dest_dev: torch.Tensor | None = None

    def __post_init__(self) -> None:
        if not isinstance(self.uid_matrix, UidMatrix):
            self.uid_matrix = UidMatrix.from_rows(self.uid_matrix)


def rows_for_uids(csr: PredCSR, uids: np.ndarray) -> np.ndarray:
    """Map subject uids to CSR rows; missing subjects → sentinel."""
    subjects = csr.host_arrays()[0]
    return us.host_rank_of(subjects, uids, us.SENTINEL32).astype(np.int32)


def _frontier_degrees(csr, uids: np.ndarray):
    """(rows, deg, need) for a frontier over one adjacency's host mirrors:
    the host first pass of a size-adaptive expand."""
    rows = rows_for_uids(csr, uids)
    deg = _row_degrees(csr.host_arrays()[1], rows)
    return rows, deg, int(deg.sum())


def _row_degrees(indptr_h: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Per-slot degree of CSR rows from the host indptr (SENTINEL32 rows
    read 0)."""
    rc = np.clip(rows, 0, max(len(indptr_h) - 2, 0))
    ok = rows != us.SENTINEL32
    return np.where(ok, indptr_h[rc + 1] - indptr_h[rc], 0)


def _rows_on_device(subjects_d: torch.Tensor,
                    uids: np.ndarray) -> tuple[torch.Tensor, int]:
    """rows_for_uids on the card: the frontier goes up (int32 where every
    uid fits, else int64 with the uids outside the int32 uid space mapped
    to a miss, since the rank's cast would wrap them) and is ranked in the
    device subjects. Returns (int32 rows, SENTINEL32 for a miss; the bytes
    uploaded)."""
    miss = int(us.SENTINEL32)
    if int(uids.min()) >= 0 and int(uids.max()) <= miss:
        u_d = torch.from_numpy(uids.astype(np.int32)).to(subjects_d.device)
        return us.rank_of(subjects_d, u_d, miss), 4 * len(uids)
    u_d = torch.from_numpy(np.ascontiguousarray(uids, np.int64)).to(
        subjects_d.device)
    fits = (u_d >= 0) & (u_d < miss)
    rows_d = us.rank_of(subjects_d,
                        torch.where(fits, u_d, 0).to(torch.int32), miss)
    return torch.where(fits, rows_d, miss), 8 * len(uids)


def _host_expand_matrix(csr, uids: np.ndarray, rows: np.ndarray | None,
                        deg: np.ndarray | None,
                        cutover: int | None) -> UidMatrix:
    """The uidMatrix of a frontier from the host mirrors: below the
    cutover, on a cold tablet, after an upload fault, or on rows the card
    mapped and read back. Ranks the frontier on the host where `rows` is
    None, and reads the degrees where `deg` is."""
    _, indptr_h, indices_h = csr.host_arrays()
    if rows is None:
        rows, deg, _need = _frontier_degrees(csr, uids)
    elif deg is None:
        deg = _row_degrees(indptr_h, rows)
    offs = np.zeros(len(uids) + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    otrace.event("host_expand", need=int(offs[-1]),
                 cutover=int(cutover or HOST_EXPAND_MAX))
    return UidMatrix(_gather_rows_host(indptr_h, indices_h, rows, deg, offs),
                     offs)


def _gather_rows_host(indptr_h: np.ndarray, indices_h: np.ndarray,
                      rows: np.ndarray, deg: np.ndarray,
                      offs: np.ndarray) -> np.ndarray:
    """Flat host gather of per-row spans (SENTINEL32 rows skipped)."""
    total = int(offs[-1])
    ok = rows != us.SENTINEL32
    rc = np.clip(rows, 0, max(len(indptr_h) - 2, 0))
    starts = np.where(ok, indptr_h[rc], 0).astype(np.int64)
    pos = np.repeat(starts - offs[:-1], deg) + np.arange(total)
    return indices_h[pos].astype(np.int64)


def _host_reason(owner, need: int, cutover: int = 0,
                 serve: bool = True) -> str | None:
    """The host-or-device rule for a gather of `need` edges (or index
    uids) from one owner: "host_path" at or below the cutover (0 =
    HOST_EXPAND_MAX), "cold_tier" above it on an owner the residency tier
    holds COLD (storage/residency.py: its device footprint exceeds the
    node's whole budget), None for the device. A caller that serves the
    read on the host now (serve) counts the cold serve; a consult
    (expand_route) counts none. Unmanaged owners are never cold."""
    if need <= (cutover or HOST_EXPAND_MAX):
        return "host_path"
    f = getattr(owner, "prefer_host", None)
    if f is None or not f():
        return None
    if serve:
        _note_cold_serve(owner)
    return "cold_tier"


def _note_cold_serve(owner) -> None:
    mgr = getattr(owner, "_res", None)
    if mgr is not None:
        mgr.note_cold_serve()


def _device_arrays(owner) -> tuple | None:
    """The owner's device arrays (uploaded at first use), or None after an
    injected residency.h2d_upload fault, counted in
    dgraph_residency_host_fallbacks_total: the caller serves the
    byte-identical host answer, so the read never fails. Only the
    injected faults.FaultError comes here: a real CUDA error or an
    out-of-memory on upload raises to the caller."""
    try:
        return owner.device_arrays()
    except FaultError:
        mgr = getattr(owner, "_res", None)
        if mgr is not None:
            mgr.metrics.counter(
                "dgraph_residency_host_fallbacks_total").inc()
        return None


class ExpandRoute(NamedTuple):
    """The path a uid expand takes (expand_route), with the host first
    pass (rows, deg, need) where the route computed one."""

    # empty, mesh_sharded, overlay, cold_tier, host_path or device
    kind: str
    rows: np.ndarray | None = None
    deg: np.ndarray | None = None
    need: int | None = None


def expand_route(csr, uids: np.ndarray, cutover: int = 0) -> ExpandRoute:
    """Which path an expand of `uids` over `csr` takes: the one decision
    behind the solo expand (_expand_csr) and the batcher's classification
    (query/batch.py). A consult: it uploads nothing and counts no cold
    serve.

    A frontier of uidset.HOST_CUTOVER uids or more over a tablet the tier
    does not hold cold, under a cutover below its edge count, is `device`
    with nothing ranked on the host: the card maps it to rows and learns
    its degree sum (gather_on_device). That is the card's measured
    crossover for a searchsorted membership with its copies: on an H100
    the map with its upload and read took 0.65 ms against the host's 0.85
    ms at 2048 uids of a 547K-subject tablet, 1.26 against 20.6 ms at
    300K. A cutover at or above the tablet's edge count is `host_path`
    unranked. A smaller frontier is ranked on the host and takes
    _host_reason's answer, else `device`."""
    if csr is None or len(uids) == 0:
        return ExpandRoute("empty")
    if getattr(csr, "is_dist", False):
        return ExpandRoute("mesh_sharded")
    if isinstance(csr, OverlayCSR):
        return ExpandRoute("overlay")
    co = cutover or HOST_EXPAND_MAX
    if co >= csr.num_edges:
        return ExpandRoute("host_path")
    if len(uids) >= us.HOST_CUTOVER and not csr.prefer_host():
        return ExpandRoute("device")
    rows, deg, need = _frontier_degrees(csr, uids)
    kind = _host_reason(csr, need, cutover, serve=False) or "device"
    return ExpandRoute(kind, rows, deg, need)


def resolve_reverse(q: TaskQuery) -> TaskQuery:
    """`~attr` as process_task runs it: attr without the "~" and reverse
    set, every other field kept (the planner's cutover too)."""
    if not q.attr.startswith("~"):
        return q
    return replace(q, attr=q.attr[1:], reverse=True)


def _expand_overlay(ov, uids: np.ndarray,
                    cutover: int = 0) -> tuple[UidMatrix, int]:
    """Merge-on-read expand over an OverlayCSR (storage/delta.py): gather
    the untouched rows from the unchanged base (host mirror at or below
    the cutover or on a cold base, ops/csr.expand_masked on the base's
    device tensors above it) and splice the overlay's replacement rows per
    frontier slot — O(frontier + Δ), never a merge of the tablet. The base
    tensors keep identity: a commit costs its delta, not a re-upload."""
    rb, ro, deg_b, deg_o = ov.frontier_plan(uids)
    need_base = int(deg_b.sum())
    total = need_base + int(deg_o.sum())
    offs = np.zeros(len(uids) + 1, dtype=np.int64)
    np.cumsum(deg_b, out=offs[1:])
    base = ov.base
    if base is None or need_base == 0:
        base_targets = np.zeros(0, np.int64)
    elif _host_reason(base, need_base, cutover) \
            or (dev := _device_arrays(base)) is None:
        _, indptr_h, indices_h = base.host_arrays()
        base_targets = _gather_rows_host(indptr_h, indices_h, rb, deg_b,
                                         offs)
    else:
        _, indptr_d, indices_d = dev
        cap = 1 << max(int(np.ceil(np.log2(need_base + 1))), 4)
        keep = ro >= 0
        with costs.kernel("csr.expand_masked", need=need_base,
                          cutover=int(cutover or HOST_EXPAND_MAX)) as ck:
            res = csrops.expand_masked(
                indptr_d, indices_d,
                torch.from_numpy(rb).to(base.device),
                torch.from_numpy(keep).to(base.device), out_cap=cap)
            # one D2H, which is also the sync that lands the kernel's
            # time in this span
            targets_h = res.targets.cpu().numpy()
            ck.set(h2d=int(rb.nbytes + keep.nbytes),
                   d2h=int(targets_h.nbytes))
            ck.annotate(edges=need_base)
        base_targets = targets_h[:need_base].astype(np.int64)
    matrix = [base_targets[offs[i]: offs[i + 1]] for i in range(len(uids))]
    for i in np.flatnonzero(ro >= 0).tolist():
        matrix[i] = ov.delta.rows[ro[i]]
    return UidMatrix.from_rows(matrix), total


def _expand_csr(csr: PredCSR, uids: np.ndarray, first: int = 0,
                cutover: int = 0, want_dest: bool = True,
                metrics=None) -> tuple[UidMatrix, int]:
    """uidMatrix for a frontier over one adjacency, on the path
    expand_route picks: the host gather (small, or a cold tablet), the
    device gather (gather_on_device), the merge on read of an overlaid
    adjacency (OverlayCSR: _expand_overlay), or the mesh of a
    mesh-sharded one; all give the same matrix. The device gather also
    dedups its targets on the card into the matrix's dest (counted in
    metrics' dgraph_expand_dest_on_device_total), unless the caller reads
    no dest (want_dest False) or first truncates the rows.

    cutover: the planner's override of the host/device switch point (0 =
    HOST_EXPAND_MAX)."""
    route = expand_route(csr, uids, cutover)
    if route.kind == "empty":
        return UidMatrix.empty(len(uids)), 0
    if route.kind == "overlay":
        matrix, total = _expand_overlay(csr, uids, cutover)
        return apply_first(matrix, first), total
    if route.kind == "mesh_sharded":
        # the same size-adaptive rule as a resident tablet: a small
        # frontier gathers from the host mirrors; past the cutover the
        # expand runs over the owning mesh (parallel/dist.DistPredCSR)
        route = ExpandRoute("host_path", *_frontier_degrees(csr, uids))
        if not _host_reason(csr, route.need, cutover):
            rows_l, total = csr.expand_matrix(uids)
            return apply_first(UidMatrix.from_rows(rows_l), first), total
    if route.kind == "device":
        matrix, total, _h2d, _d2h = gather_on_device(
            csr, uids, route, cutover or HOST_EXPAND_MAX,
            want_dest and first == 0, metrics)
        return apply_first(matrix, first), total
    if route.kind == "cold_tier":
        _note_cold_serve(csr)
    matrix = _host_expand_matrix(csr, uids, route.rows, route.deg, cutover)
    return apply_first(matrix, first), int(matrix.offsets[-1])


def gather_on_device(csr: PredCSR, uids: np.ndarray, route: ExpandRoute,
                     cutover: int | None, want_dest: bool, metrics=None,
                     ck=None) -> tuple[UidMatrix, int, int, int]:
    """The device gather of a frontier over a plain tablet: one query's
    (_expand_csr), or a batch's frontiers concatenated (query/batch.py).
    Returns (the uidMatrix, the edge total, the bytes up, the bytes back).

    The route's host rows go up where it carries them; else the card
    ranks the frontier in the device subjects and one scalar read of the
    degree sum sizes the gather (counted in metrics'
    dgraph_expand_rows_on_device_total). At or below `cutover` (None: a
    batch, gathered whatever the sum) the rows come back for the host
    gather; above it one gather at a pow2 capacity class, whose targets
    stay on the card, in its dtype, until a reader asks for rows (counted
    in metrics' dgraph_expand_targets_on_device_total; the matrix keeps
    `metrics` to count its fetch). Only the counts come back, and with
    want_dest the level's dest, from the same gather, deduplicated on the
    card; the matrix keeps the card's copy of it too (dest_dev). An
    injected upload fault takes the host gather. The device work runs
    inside the caller's costs.kernel seam `ck` (a batch's), else inside a
    csr.expand seam of its own; the seam takes the bytes it copied."""
    dev = _device_arrays(csr)
    rows, matrix, h2d, d2h = route.rows, None, 0, 0
    if dev is not None:
        subjects_d, indptr_d, indices_d = dev
        seam = costs.kernel("csr.expand", cutover=cutover) \
            if ck is None else nullcontext(ck)
        with seam as ck:
            if rows is None:
                rows_d, h2d = _rows_on_device(subjects_d, uids)
                need_d = csrops.degrees(indptr_d, rows_d).sum()
                need = int(need_d)               # the sync that sizes cap
                d2h = need_d.element_size()
                ck.annotate(need=need, rows_on_device=True)
                if metrics is not None:
                    metrics.counter(
                        "dgraph_expand_rows_on_device_total").inc()
            else:
                rows_d = torch.from_numpy(rows).to(csr.device)
                h2d, need = int(rows.nbytes), route.need
                ck.annotate(need=need)
            if cutover is not None and need <= cutover:
                rows = rows_d.cpu().numpy()
                d2h += int(rows.nbytes)
            else:
                cap = 1 << max(int(np.ceil(np.log2(need + 1))), 4)
                res = csrops.expand(indptr_d, indices_d, rows_d,
                                    out_cap=cap)
                total = int(res.total)           # device sync point
                # the targets stay on the card until a reader asks for
                # rows (UidMatrix._host); the counts come back for the
                # offsets
                flat_d = res.targets[:total]
                counts = res.counts.cpu().numpy()
                d2h += res.total.element_size() + int(counts.nbytes)
                dest = dest_d = None
                if want_dest:
                    dest_d, read = csrops.unique_targets(flat_d)
                    dest = dest_d.cpu().numpy().astype(np.int64)
                    d2h += read + int(dest_d.numel() * dest_d.element_size())
                    if metrics is not None:
                        metrics.counter(
                            "dgraph_expand_dest_on_device_total").inc()
                ck.annotate(edges=total)
                offs = np.zeros(len(counts) + 1, dtype=np.int64)
                np.cumsum(counts, out=offs[1:])
                matrix = UidMatrix(flat_d, offs, dest, metrics, dest_d)
                if metrics is not None:
                    metrics.counter(
                        "dgraph_expand_targets_on_device_total").inc()
            ck.set(h2d=h2d, d2h=d2h)
    if matrix is None:
        matrix = _host_expand_matrix(csr, uids, rows, route.deg, cutover)
    return matrix, int(matrix.offsets[-1]), h2d, d2h


def apply_first(matrix: UidMatrix, first: int) -> UidMatrix:
    """Per-uid result truncation (intern.Query.first)."""
    return matrix.truncated(first) if first else matrix


def _merge_matrix(matrix: UidMatrix) -> np.ndarray:
    """A level's dest: the sorted-unique union of its rows — the dest its
    gather computed on the card, else the host unique of its flat
    targets."""
    if matrix.dest is not None:
        return matrix.dest
    return np.unique(matrix.flat)


# ---------------------------------------------------------------------------
# index helpers
# ---------------------------------------------------------------------------

def _index_uids_for_rows(ti: TokenIndex, rows: list[int]) -> np.ndarray:
    """Union of the uid lists of the chosen token rows: a host merge at or
    below HOST_EXPAND_MAX uids (or on a cold-tier index), one expand_dest on
    the index's device above it."""
    if not rows:
        return np.zeros(0, np.int64)
    indptr_h, uids_h = ti.host_arrays()
    total = int(sum(indptr_h[r + 1] - indptr_h[r] for r in rows))

    def host_union():
        parts = [uids_h[indptr_h[r]: indptr_h[r + 1]] for r in rows]
        return np.unique(np.concatenate(parts))

    costs.add_rows(total)
    if _host_reason(ti, total) or (dev := _device_arrays(ti)) is None:
        return host_union()
    indptr_d, uids_d = dev
    cap = int(indptr_h[-1]) or 1
    with costs.kernel("csr.expand_dest", need=total, rows=len(rows)) as ck:
        rows_arr = us.make_set(np.asarray(rows, dtype=np.int32),
                               capacity=len(rows), device=ti.device)
        dest, _total = csrops.expand_dest(indptr_d, uids_d, rows_arr,
                                          out_cap=cap)
        # the union is at most the whole index (cap), so it is complete;
        # the sentinel tail stays on the device
        n_d = us.size(dest)
        out = dest[:int(n_d)].cpu().numpy()
        ck.set(h2d=rows_arr.numel() * rows_arr.element_size(),
               d2h=n_d.element_size() + int(out.nbytes))
        ck.annotate(edges=int(len(out)))
    return out.astype(np.int64)


def _index_uids_intersect_rows(ti: TokenIndex, rows: list[int]) -> np.ndarray:
    """Intersection of the uid lists of the chosen token rows (allofterms),
    on the host mirrors."""
    if not rows:
        return np.zeros(0, np.int64)
    indptr, uids_h = ti.host_arrays()
    out = None
    for r in rows:
        u = uids_h[indptr[r]: indptr[r + 1]]
        out = u if out is None else us.intersect_host(out, u, ti.device)
        if len(out) == 0:
            break
    return out


def _tokens_for(pd: PredData, schema: SchemaState, v: Val,
                prefer: tuple[str, ...]) -> tuple[str, list[bytes]]:
    """Pick a tokenizer (preference order) and produce query tokens.

    A predicate indexed per schema but with no index rows yet (no data at
    this read_ts) matches zero uids instead of erroring."""
    names = schema.tokenizer_names(pd.attr)
    for p in prefer:
        if p in names:
            if p not in pd.indexes:
                return p, []  # indexed, but empty at this snapshot
            tz = tokmod.get(p)
            sv = convert(v, tz.type_id) if v.tid != tz.type_id else v
            return p, [t[1:] for t in tz.tokens(sv)]  # strip ident byte: index rows store it stripped
    raise TaskError(f"predicate {pd.attr} needs @index({'|'.join(prefer)})")


def _ineq_rows(ti: TokenIndex, op: str, token: bytes) -> list[int]:
    """Token rows satisfying an inequality against a *sortable* tokenizer
    (reference: worker/tokens.go:124 getInequalityTokens — walks the sorted
    index bucket space). Terms are byte-ordered == value-ordered."""
    i = bisect.bisect_left(ti.terms, token)
    if op == "eq":
        return [i] if i < len(ti.terms) and ti.terms[i] == token else []
    if op in ("lt", "le"):
        hi = bisect.bisect_right(ti.terms, token)
        if op == "lt" and i < len(ti.terms) and ti.terms[i] == token:
            return list(range(0, i))
        return list(range(0, hi))
    if op in ("gt", "ge"):
        if op == "ge":
            return list(range(i, len(ti.terms)))
        hi = bisect.bisect_right(ti.terms, token)
        return list(range(hi, len(ti.terms)))
    raise TaskError(f"bad inequality {op}")


def _stored_values(pd: PredData, u: int) -> list[Val]:
    """Every stored value of subject u: the full [type] list when present
    (host_values holds only the first-by-sort representative — a match on
    ANY element counts), else the scalar, else lang-tagged values. Shared by
    all lossy-tokenizer post-filters (eq/ineq, regexp, geo)."""
    vals = list(pd.list_values.get(u, ()))
    if not vals:
        sv = pd.host_values.get(u)
        vals = [sv] if sv is not None else []
    if not vals and u in pd.lang_values:
        vals = list(pd.lang_values[u].values())
    return [v for v in vals if v is not None]


def _post_filter_compare(pd: PredData, uids: np.ndarray, op: str, v: Val) -> np.ndarray:
    """Exact re-check for lossy tokenizers (reference worker/task.go:837-919)."""
    keep = []
    for u in uids.tolist():
        if any(compare_vals(op, x, v) for x in _stored_values(pd, int(u))):
            keep.append(u)
    return np.asarray(keep, dtype=np.int64)


def _eq_candidates(pd: PredData, schema, v: Val) -> np.ndarray:
    name, toks = _tokens_for(
        pd, schema, v, ("int", "float", "bool", "exact", "hash", "term",
                        "year", "month", "day", "hour"))
    ti = pd.indexes.get(name)
    if ti is None:
        return np.zeros(0, np.int64)
    rows = [r for t in toks if (r := ti.term_row(t)) >= 0]
    uids = _index_uids_for_rows(ti, rows)
    if tokmod.get(name).lossy:
        uids = _post_filter_compare(pd, uids, "eq", v)
    return uids


# ---------------------------------------------------------------------------
# main dispatch
# ---------------------------------------------------------------------------

def process_task(snap: GraphSnapshot, q: TaskQuery,
                 schema: SchemaState) -> TaskResult:
    """Execute one task against a snapshot (reference worker/task.go:605)."""
    q = resolve_reverse(q)
    attr = q.attr
    pd = snap.pred(attr) or PredData(attr, schema.type_of(attr))
    res = TaskResult()

    fname = q.func[0].lower() if q.func else None
    args = q.func[1] if q.func else []

    # ---- root functions (no frontier): produce dest_uids ------------------
    if q.frontier is None:
        if fname == "similar_to":
            # vector similarity probe (storage/vecindex.py): dest_uids is
            # the top-k set; value_matrix carries the aligned distances so
            # the engine can expose them as the `vector_distance` val var
            _similar_root(snap, pd, schema, args, res)
            return res
        res.dest_uids = _root_func(snap, pd, schema, fname, args, q)
        return res

    frontier = np.asarray(q.frontier, dtype=np.int64)

    # ---- frontier + uid-edge predicate: expand ----------------------------
    if pd.type_id == TypeID.UID or pd.csr is not None or q.reverse:
        csr = pd.rev_csr if q.reverse else pd.csr
        matrix, traversed = _expand_csr(
            csr, frontier, q.first, q.cutover,
            want_dest=fname not in _ROW_FILTERS,
            metrics=getattr(snap, "metrics", None))
        return finish_uid_expand(pd, q, frontier, matrix, traversed)

    # ---- frontier + value predicate: fetch values / compare filter --------
    # vectorized presence over the value subjects: one searchsorted instead
    # of a dict probe per frontier uid (handleValuePostings' per-uid posting
    # fetch, worker/task.go:319)
    costs.add_rows(len(frontier))      # value rows scanned host-side
    if pd.value_subjects_host is not None:
        vsub = pd.value_subjects_host
        pos = np.searchsorted(vsub, frontier)
        posc = np.clip(pos, 0, max(len(vsub) - 1, 0))
        present = (len(vsub) > 0) & (vsub[posc] == frontier)
    else:
        present = np.zeros(len(frontier), dtype=bool)

    if fname == "has" and not q.lang:
        # value_subjects includes lang-only nodes, so presence alone
        # decides has()
        res.dest_uids = frontier[present]
        res.value_matrix = [[] for _ in frontier]
        return res

    if (fname in ("eq", "le", "lt", "ge", "gt") and not q.lang
            and pd.num_values_host is not None
            and not schema.is_list(attr)
            and pd.type_id in (TypeID.INT, TypeID.FLOAT, TypeID.BOOL,
                               TypeID.DATETIME)):
        # numeric compare on the exact float64 host mirror, one vector op
        # over the frontier. num_values_host holds ONE representative value
        # per subject, so [type] list predicates (a match on any element
        # counts) take the all-values loop below.
        vs = [_parse_arg_val(pd, schema, a)
              for a in (args if fname == "eq" else args[:1])]
        rhs = [to_device_scalar(v) for v in vs]
        nv = pd.num_values_host
        x = np.where(present, nv[posc], np.nan)
        keep = np.zeros(len(frontier), dtype=bool)
        for r in (r for r in rhs if r is not None):
            if fname == "eq":
                keep |= x == r
            elif fname == "le":
                keep |= x <= r
            elif fname == "lt":
                keep |= x < r
            elif fname == "ge":
                keep |= x >= r
            elif fname == "gt":
                keep |= x > r
        res.dest_uids = frontier[keep]
        res.value_matrix = [
            [pd.host_values[int(u)]] if k and int(u) in pd.host_values else []
            for u, k in zip(frontier, keep)]
        return res

    res.value_matrix = []
    lang_chain = q.lang.split(":") if q.lang else ()
    for u, pres in zip(frontier.tolist(), present):
        vals: list[Val] = []
        if q.lang:
            # language preference chain "fr:es:." — first hit wins; "."
            # means untagged-first-then-any (reference: @lang fallback,
            # query/outputnode.go valToBytes language handling)
            lv = pd.lang_values.get(int(u), {})
            for lg in lang_chain:
                if lg == ".":
                    sv = pd.host_values.get(int(u))
                    if sv is not None:
                        vals = [sv]
                    elif lv:
                        vals = [next(iter(lv.values()))]
                    break
                if lg in lv:
                    vals = [lv[lg]]
                    break
        elif pres:
            lv = pd.list_values.get(int(u))
            if lv is not None:
                vals = list(lv)        # [type] predicate: every value
            else:
                sv = pd.host_values.get(int(u))
                if sv is not None:
                    vals = [sv]
        res.value_matrix.append(vals)
    if q.facet_keys:
        # facets on VALUE edges live at the untagged slot (subj, 0); lang
        # slots carry their own (reference: facets on scalar postings)
        from dgraph_tpu_torch.storage.postings import lang_uid
        slot = lang_uid(q.lang.split(":")[0]) if q.lang else 0
        res.facet_matrix = [[pd.facets.get((int(u), slot), ())]
                            for u in frontier]
    if fname in ("eq", "le", "lt", "ge", "gt"):
        # eq(pred, v1, v2, ...) matches ANY listed value
        vs = [_parse_arg_val(pd, schema, a) for a in (args if fname == "eq" else args[:1])]
        keep = np.asarray(
            [any(compare_vals(fname, x, v) for x in vals for v in vs)
             for vals in res.value_matrix],
            dtype=bool)
        res.dest_uids = frontier[keep]
    elif fname == "has":
        # has(attr) matches lang-only nodes too (the data key exists)
        keep = np.asarray(
            [len(vals) > 0 or int(u) in pd.lang_values
             for u, vals in zip(frontier.tolist(), res.value_matrix)], dtype=bool)
        res.dest_uids = frontier[keep]
    elif fname == "checkpwd":
        keep = []
        for u, vals in zip(frontier.tolist(), res.value_matrix):
            ok = bool(vals) and verify_password(str(args[0]), str(vals[0].value))
            keep.append(ok)
        res.dest_uids = frontier[np.asarray(keep, dtype=bool)]
        res.value_matrix = [[Val(TypeID.BOOL, k)] for k in keep]
    else:
        res.dest_uids = frontier[
            np.asarray([len(v) > 0 for v in res.value_matrix], dtype=bool)]
    return res


def finish_uid_expand(pd: PredData, q: TaskQuery, frontier: np.ndarray,
                      matrix: UidMatrix, traversed: int) -> TaskResult:
    """Host tail of a uid-predicate frontier task: the edge facets, the
    uid_in / has filter functions and the dest merge. q is reverse-resolved
    (attr without "~", q.reverse set) as process_task rewrites it."""
    res = TaskResult()
    fname = q.func[0].lower() if q.func else None
    args = q.func[1] if q.func else []
    res.uid_matrix = matrix
    res.counts = matrix.counts()
    res.traversed_edges = traversed
    if q.facet_keys:
        # every facet of each edge; the encoder keeps the asked keys
        res.facet_matrix = [
            [pd.facets.get((int(s), int(o)), ()) for o in m]
            for s, m in zip(frontier, matrix)]
    if fname not in _ROW_FILTERS:
        with otrace.span("merge"):
            res.dest_uids = _merge_matrix(matrix)
        if matrix.dest_dev is not None:
            # the card's copy of the dest the merge took goes with the
            # result, not with the matrix a task cache may keep
            res.dest_dev, matrix.dest_dev = matrix.dest_dev, None
    elif fname == "uid_in":
        # uid_in(pred, u1, u2, ...) keeps subjects with ANY listed object
        want = {int(str(a), 0) for a in args}
        keep = np.asarray([bool(want.intersection(m)) for m in matrix],
                          dtype=bool)
        res.dest_uids = frontier[keep]
    else:
        # has(attr) over a frontier: subjects with >= 1 edge (or a value,
        # for mixed untyped predicates)
        keep = res.counts > 0
        if pd.value_subjects_host is not None:
            vsub = pd.value_subjects_host
            posv = np.clip(np.searchsorted(vsub, frontier), 0,
                           max(len(vsub) - 1, 0))
            keep |= (len(vsub) > 0) & (vsub[posv] == frontier)
        res.dest_uids = frontier[keep]
    return res


def _parse_arg_val(pd: PredData, schema, arg) -> Val:
    if isinstance(arg, Val):
        return arg
    tid = pd.type_id if pd.type_id != TypeID.DEFAULT else TypeID.STRING
    if tid == TypeID.UID:
        tid = TypeID.STRING
    return convert(Val(TypeID.STRING, str(arg)), tid)


def _root_func(snap: GraphSnapshot, pd: PredData, schema, fname: str | None,
               args: list, q: TaskQuery) -> np.ndarray:
    if fname is None:
        raise TaskError("root query needs a function or explicit uids")
    if fname == "uid":
        return np.unique(np.asarray([int(a) for a in args], dtype=np.int64))
    if fname == "has":
        if q.reverse:
            # has(~pred): nodes with at least one INCOMING edge
            if pd.rev_csr is None:
                return np.zeros(0, np.int64)
            return csr_subjects_host(pd.rev_csr)
        return pd.has_subjects().astype(np.int64)

    if fname in ("le", "lt", "ge", "gt", "eq"):
        # compare-scalar over count index: eq(count(pred), N); the reverse
        # form eq(count(~pred), N) compares in-degrees over the reverse CSR
        if args and isinstance(args[0], str) and args[0] == "__count__":
            return _count_func(pd, fname, int(args[1]), reverse=q.reverse)
        if not args:
            if fname == "eq":
                # eq(pred, []) — degenerate but parseable; matches nothing
                return np.zeros(0, np.int64)
            raise TaskError(f"{fname}({pd.attr}) needs a value to compare")
        v = _parse_arg_val(pd, schema, args[0])
        if fname == "eq":
            out = [_eq_candidates(pd, schema, vv) for vv in
                   [v] + [_parse_arg_val(pd, schema, a) for a in args[1:]]]
            return np.unique(np.concatenate(out)) if out else np.zeros(0, np.int64)
        name, toks = _tokens_for(pd, schema, v, ("int", "float", "exact",
                                                 "year", "month", "day", "hour"))
        ti = pd.indexes.get(name)
        if ti is None or not toks:
            return np.zeros(0, np.int64)
        rows = _ineq_rows(ti, fname, toks[0])
        uids = _index_uids_for_rows(ti, rows)
        if tokmod.get(name).lossy:
            uids = _post_filter_compare(pd, uids, fname, v)
        return uids

    if fname in ("anyofterms", "allofterms"):
        return _terms_func(pd, schema, fname, str(args[0]), "term")
    if fname in ("anyoftext", "alloftext"):
        # the attr's lang tag picks the full-text analyzer (tok/fts.go):
        # alloftext(desc@ru, ...) stems the query the way @ru values were
        # indexed
        return _terms_func(pd, schema,
                           "anyofterms" if fname == "anyoftext" else "allofterms",
                           str(args[0]), "fulltext", lang=q.lang)
    if fname == "regexp":
        return _regexp_func(pd, schema, str(args[0]),
                            str(args[1]) if len(args) > 1 else "")
    if fname in ("near", "within", "contains", "intersects"):
        return _geo_func(pd, schema, fname, args)
    if fname == "uid_in":
        raise TaskError("uid_in is not a root function")
    raise TaskError(f"unknown function {fname!r}")


def parse_similar_args(pd: PredData, args: list) -> tuple[np.ndarray, int]:
    """similar_to(pred, $vec, k) argument canonicalization: one vector
    literal (string "[...]" / JSON array / GraphQL var) + one integer k,
    accepted in either order (the reference's v24 surface puts k first)."""
    from dgraph_tpu_torch.utils.types import parse_vector

    vec_arg = k_arg = None
    for a in args:
        if isinstance(a, bool):
            raise TaskError(f"similar_to({pd.attr}): bad argument {a!r}")
        if isinstance(a, int) and k_arg is None:
            k_arg = a
        elif isinstance(a, (str, list, tuple)) and vec_arg is None:
            vec_arg = a
        else:
            raise TaskError(
                f"similar_to({pd.attr}) takes one vector and one integer k")
    if vec_arg is None or k_arg is None:
        raise TaskError(
            f"similar_to({pd.attr}) needs a query vector and k")
    if k_arg <= 0:
        raise TaskError(f"similar_to({pd.attr}): k must be >= 1")
    try:
        vec = np.asarray(parse_vector(vec_arg), dtype=np.float32)
    except ValueError as e:
        raise TaskError(f"similar_to({pd.attr}): {e}") from None
    return vec, int(k_arg)


def _similar_root(snap: GraphSnapshot, pd: PredData, schema,
                  args: list, res: TaskResult) -> None:
    from dgraph_tpu_torch.storage import vecindex as vecmod

    spec = schema.vector_spec(pd.attr)
    if spec is None:
        raise TaskError(f"predicate {pd.attr} needs @index(vector(...))")
    vec, k = parse_similar_args(pd, args)
    if len(vec) != spec.dim:
        raise TaskError(
            f"similar_to({pd.attr}): query vector dim {len(vec)} != "
            f"schema dim {spec.dim}")
    vi = pd.vecindex
    if vi is None:
        # indexed per schema but empty at this snapshot: zero matches
        res.dest_uids = np.zeros(0, np.int64)
        return
    uids, dists = vecmod.search(vi, vec, k,
                                metrics=getattr(snap, "metrics", None))
    set_similar_result(res, uids, dists)


def set_similar_result(res: TaskResult, uids: np.ndarray,
                       dists: np.ndarray) -> None:
    """Shape ranked (uid, distance) pairs into a TaskResult — shared by
    the solo similar_to root and the batched vector demux (query/batch.py).
    dest_uids is a SORTED uid set (engine set algebra); distances ride
    value_matrix in the same order."""
    order = np.argsort(uids, kind="stable")
    res.dest_uids = uids[order]
    res.value_matrix = [[Val(TypeID.FLOAT, float(d))]
                        for d in dists[order]]


def _count_func(pd: PredData, op: str, n: int,
                reverse: bool = False) -> np.ndarray:
    """Compare-scalar on degree (reference countParams.evaluate :1498; the
    count index becomes a degree compare over the host indptr mirror)."""
    csr = pd.rev_csr if reverse else pd.csr
    if csr is None:
        return np.zeros(0, np.int64)
    subjects, deg = csr_subjects_degrees(csr)
    mask = {"eq": deg == n, "le": deg <= n, "lt": deg < n,
            "ge": deg >= n, "gt": deg > n}[op]
    return subjects[mask]


def _empty_or_missing_index(pd: PredData, schema, tokname: str) -> np.ndarray | None:
    """Indexed per schema but no rows at this snapshot → zero matches;
    not indexed at all → None (caller raises TaskError)."""
    if tokname in schema.tokenizer_names(pd.attr):
        return np.zeros(0, np.int64)
    return None


def _terms_func(pd: PredData, schema, fname: str, text: str, tokname: str,
                lang: str = "") -> np.ndarray:
    ti = pd.indexes.get(tokname)
    if ti is None:
        empty = _empty_or_missing_index(pd, schema, tokname)
        if empty is not None:
            return empty
        raise TaskError(f"predicate {pd.attr} needs @index({tokname})")
    tz = tokmod.get(tokname)
    if tokname == "fulltext" and lang:
        toks = tokmod.fulltext_tokens(text, lang.split(":")[0])
    else:
        toks = [t[1:] for t in tz.tokens(Val(TypeID.STRING, text))]
    rows = [r for t in toks if (r := ti.term_row(t)) >= 0]
    if fname == "allofterms":
        if len(rows) != len(toks):
            return np.zeros(0, np.int64)
        return _index_uids_intersect_rows(ti, rows)
    return _index_uids_for_rows(ti, rows)


def _regexp_func(pd: PredData, schema, pattern: str, flags: str) -> np.ndarray:
    """Trigram-index candidates + exact automaton post-filter
    (reference worker/task.go:768-835, worker/trigram.go:36)."""
    ti = pd.indexes.get("trigram")
    if ti is None:
        empty = _empty_or_missing_index(pd, schema, "trigram")
        if empty is not None:
            return empty
        raise TaskError(f"predicate {pd.attr} needs @index(trigram)")
    rx = remod.compile(pattern, remod.IGNORECASE if "i" in flags else 0)
    # candidate trigrams: any literal 3-gram required by the pattern; fall
    # back to scanning every indexed uid when the pattern has no required
    # per-branch OR-of-AND trigram query (worker/trigram.go:36 + codesearch
    # index/regexp): candidates = union over alternation branches of the
    # intersection of each required trigram's uid list. Case-insensitive
    # patterns probe each trigram's 2^3 case variants (the index stores
    # raw-case trigrams) — case-folded query expansion, not a full scan.
    plan = _trigram_plan(pattern)
    # inline ignorecase ((?i) / (?i:...)) is invisible to the literal
    # analysis — the trigrams come out exact-case, so the probe must
    # case-expand exactly as for /re/i. Substring detection over-matches
    # (e.g. an escaped paren) only toward a WIDER probe — always sound.
    ci = "i" in flags or "(?i" in pattern
    if plan is not None:
        cands = None
        for tris in plan:
            branch = None
            for t in tris:
                if ci:
                    rows = [r for v in _case_variants(t)
                            if (r := ti.term_row(v.encode())) >= 0]
                else:
                    r0 = ti.term_row(t.encode())
                    rows = [r0] if r0 >= 0 else []
                uids = _index_uids_for_rows(ti, rows)
                branch = uids if branch is None \
                    else us.intersect_host(branch, uids, ti.device)
                if not len(branch):
                    break
            if branch is not None and len(branch):
                cands = branch if cands is None \
                    else np.union1d(cands, branch)
        if cands is None:
            cands = np.zeros(0, np.int64)
    else:
        nrows = max(len(ti.terms), 0)
        cands = _index_uids_for_rows(ti, list(range(nrows)))
    keep = []
    for u in cands.tolist():
        if any(rx.search(str(v.value)) for v in _stored_values(pd, int(u))):
            keep.append(u)
    return np.asarray(keep, dtype=np.int64)


def _case_variants(tri: str) -> list[str]:
    """All case spellings of one trigram (8 for pure-alpha)."""
    out = [""]
    for c in tri:
        if c.lower() != c.upper():
            out = [p + v for p in out for v in (c.lower(), c.upper())]
        else:
            out = [p + c for p in out]
    return out


_MAX_PLAN_ALTS = 16     # alternation product cap (planner bail-out)


def _sre_parser():
    """The stdlib regex parser module: re._parser on 3.11+, sre_parse
    before (same API — the 3.11 rename left the parse() surface intact)."""
    try:
        import re._parser as sre
    except ImportError:
        import sre_parse as sre
    return sre


def _lit_alternatives(seq) -> list[list[str]] | None:
    """Required-literal analysis of a parsed regex sequence (simplified
    codesearch index/regexp, the planner behind worker/trigram.go:36).

    Returns a list of alternatives — ANY match satisfies at least one — and
    for each alternative the list of literal runs EVERY match of it must
    contain. Soundness rules: constructs we don't model (classes, anchors,
    backrefs, min==0 repeats) contribute nothing and break the current run;
    group/repeat boundaries also break runs (never concatenate across them,
    "ab+c" must not claim "abc"). None = give up (caller scans)."""
    alts: list[list[str]] = [[""]]      # per alternative: runs; last is open

    def brk(a):
        if a[-1] != "":
            a.append("")

    def product(sub_alts):
        nonlocal alts
        if sub_alts is None:
            return False
        if len(alts) * len(sub_alts) > _MAX_PLAN_ALTS:
            return False
        out = []
        for a in alts:
            base = a if a[-1] == "" else a + [""]
            for s in sub_alts:
                out.append(base + [r for r in s if r] + [""])
            # the empty-run padding keeps sub-runs from concatenating
        alts = out
        return True

    for op, av in seq:
        name = str(op)
        if name == "LITERAL":
            ch = chr(av)
            for a in alts:
                a[-1] += ch
        elif name == "SUBPATTERN":
            sub = av[3]
            if not product(_lit_alternatives(sub)):
                return None
        elif name == "BRANCH":
            branches = av[1]
            sub_alts: list[list[str]] = []
            for b in branches:
                r = _lit_alternatives(b)
                if r is None:
                    return None
                sub_alts.extend(r)
            if not product(sub_alts):
                return None
        elif name in ("MAX_REPEAT", "MIN_REPEAT"):
            mn, _mx, sub = av
            if mn >= 1:
                # at least one occurrence is required
                if not product(_lit_alternatives(sub)):
                    return None
            else:
                for a in alts:
                    brk(a)
        else:
            # IN / ANY / AT / CATEGORY / GROUPREF / ...: matches something
            # we don't track — requireds on either side still hold
            for a in alts:
                brk(a)
    return [[r for r in a if r] for a in alts]


def _trigram_plan(pattern: str) -> list[list[str]] | None:
    """OR-of-AND trigram query for a pattern: one AND-list per alternation
    branch (candidates = union over branches of the intersection of each
    trigram's uid list). None = no branch has a literal >= 3 chars, or the
    pattern is beyond the planner — caller falls back to the full scan."""
    try:
        parsed = list(_sre_parser().parse(pattern))
    except Exception:
        return None
    alts = _lit_alternatives(parsed)
    if alts is None:
        return None
    plan = []
    for runs in alts:
        tris = sorted({run[i: i + 3] for run in runs if len(run) >= 3
                       for i in range(len(run) - 2)})
        if not tris:
            return None     # one unbounded branch poisons the whole query
        plan.append(tris)
    return plan


def _geo_func(pd: PredData, schema, fname: str, args: list) -> np.ndarray:
    ti = pd.indexes.get("geo")
    if ti is None:
        empty = _empty_or_missing_index(pd, schema, "geo")
        if empty is not None:
            return empty
        raise TaskError(f"predicate {pd.attr} needs @index(geo)")
    a0 = args[0]
    if isinstance(a0, (list, tuple)) and len(a0) == 2 and \
            all(isinstance(x, (int, float)) for x in a0):
        # DQL coordinate form: near(loc, [lon, lat], dist)
        a0 = {"type": "Point", "coordinates": [float(a0[0]), float(a0[1])]}
    g = a0 if isinstance(a0, geomod.Geom) else geomod.parse_geojson(a0)
    radius = float(args[1]) if fname == "near" and len(args) > 1 else None
    qtoks = geomod.query_tokens(g, radius)
    # probe covers and all their indexed ancestors/descendants
    rows = set()
    for t in qtoks:
        for p in range(geomod.MIN_PRECISION, len(t) + 1):
            r = ti.term_row(t[:p].encode())
            if r >= 0:
                rows.add(r)
        # descendants: terms with prefix t
        i = bisect.bisect_left(ti.terms, t.encode())
        while i < len(ti.terms) and ti.terms[i].startswith(t.encode()):
            rows.add(i)
            i += 1
    cands = _index_uids_for_rows(ti, sorted(rows))
    keep = []
    for u in cands.tolist():
        for sv in _stored_values(pd, int(u)):
            stored = sv.value
            ok = {"near": lambda: geomod.near(stored, g.coords if g.kind == "Point" else next(iter(g.points())), radius or 0.0),
                  "within": lambda: geomod.within(stored, g),
                  "contains": lambda: geomod.contains(stored, g),
                  "intersects": lambda: geomod.intersects(stored, g)}[fname]()
            if ok:
                keep.append(u)
                break
    return np.asarray(keep, dtype=np.int64)
