"""process_task: execute one (predicate, frontier, function) task on a
snapshot.

Port of the uid-expand path of dgraph_tpu/query/task.py. Reference
semantics: worker/task.go processTask (:605) → handleUidPostings (:476):
per-uid posting iteration intersected with the frontier, here one batched
CSR gather (ops/csr.expand) over the predicate's device adjacency, or a
host-mirror gather below HOST_EXPAND_MAX edges. The uidMatrix stays CSR
shaped until the host splits it per source.

Not ported yet (each raises NotImplementedError naming its slice): root
functions (index probes, has(), similar_to) and value predicates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dgraph_tpu_torch.ops import csr as csrops
from dgraph_tpu_torch.ops import uidset as us
from dgraph_tpu_torch.storage.csr_build import GraphSnapshot, PredCSR, PredData
from dgraph_tpu_torch.utils.schema import SchemaState
from dgraph_tpu_torch.utils.types import TypeID, Val


# below this edge volume the host-mirror gather beats a device dispatch +
# sync (reference algo/uidlist.go:147-155 ratio heuristic). It picks a
# path, never an output. The TPU-era value holds on an H100
# (bench_torch_crossover.py): the two gathers tie at ~2^16 edges, the host
# wins 2.5x at ~2^12 and the device 1.7x at 2^18.
HOST_EXPAND_MAX = 1 << 16


@dataclass
class TaskQuery:
    """One execution task (reference: intern.Query, protos/internal.proto:38)."""

    attr: str
    frontier: np.ndarray | None = None      # subject uids; None = root function
    func: tuple[str, list] | None = None    # (name, args) root/filter function
    reverse: bool = False                   # traverse ReverseKey space (~attr)


@dataclass
class TaskResult:
    """Reference: intern.Result (protos/internal.proto:69)."""

    uid_matrix: list[np.ndarray] = field(default_factory=list)
    value_matrix: list[list[Val]] = field(default_factory=list)
    facet_matrix: list[list[tuple]] = field(default_factory=list)
    counts: list[int] = field(default_factory=list)
    dest_uids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    traversed_edges: int = 0


def rows_for_uids(csr: PredCSR, uids: np.ndarray) -> np.ndarray:
    """Map subject uids to CSR rows; missing subjects → sentinel."""
    subjects = csr.host_arrays()[0]
    return us.host_rank_of(subjects, uids, us.SENTINEL32).astype(np.int32)


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


def _expand_csr(csr: PredCSR,
                uids: np.ndarray) -> tuple[list[np.ndarray], int]:
    """uidMatrix for a frontier over one adjacency: exact degree sum counted
    on the host indptr mirror, then the host gather (small) or one device
    gather at a pow2 capacity class (large); both give the same matrix."""
    if len(uids) == 0 or csr is None:
        return [np.zeros(0, np.int64) for _ in range(len(uids))], 0
    rows = rows_for_uids(csr, uids)
    _, indptr_h, indices_h = csr.host_arrays()
    rc = np.clip(rows, 0, max(len(indptr_h) - 2, 0))
    ok = rows != us.SENTINEL32
    deg = np.where(ok, indptr_h[rc + 1] - indptr_h[rc], 0)
    need = int(deg.sum())
    if need <= HOST_EXPAND_MAX:
        offs = np.zeros(len(uids) + 1, dtype=np.int64)
        np.cumsum(deg, out=offs[1:])
        targets = _gather_rows_host(indptr_h, indices_h, rows, deg, offs)
        matrix = [targets[offs[i]: offs[i + 1]] for i in range(len(uids))]
        total = need
    else:
        cap = 1 << max(int(np.ceil(np.log2(need + 1))), 4)
        rows_d = torch.from_numpy(rows).to(csr.device)
        res = csrops.expand(csr.indptr, csr.indices, rows_d, out_cap=cap)
        total = int(res.total)                       # device sync point
        targets = res.targets[:total].cpu().numpy().astype(np.int64)
        counts = res.counts.cpu().numpy()[: len(uids)]
        offs = np.zeros(len(uids) + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        matrix = [targets[offs[i]: offs[i + 1]] for i in range(len(uids))]
    return matrix, total


def _merge_matrix(matrix: list[np.ndarray]) -> np.ndarray:
    if not matrix:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(matrix)) if any(len(m) for m in matrix) else np.zeros(0, np.int64)


def process_task(snap: GraphSnapshot, q: TaskQuery,
                 schema: SchemaState) -> TaskResult:
    """Execute one task against a snapshot (reference worker/task.go:605)."""
    attr = q.attr
    if attr.startswith("~"):
        attr = attr[1:]
        q = TaskQuery(attr, q.frontier, q.func, True)
    pd = snap.pred(attr) or PredData(attr, schema.type_of(attr))

    if q.frontier is None:
        raise NotImplementedError(
            "root functions (index probes, has, similar_to) are not ported "
            "yet: they wait for the index slice of dgraph_tpu_torch")

    frontier = np.asarray(q.frontier, dtype=np.int64)
    if pd.type_id == TypeID.UID or pd.csr is not None or q.reverse:
        csr = pd.rev_csr if q.reverse else pd.csr
        matrix, traversed = _expand_csr(csr, frontier) \
            if csr is not None else (
            [np.zeros(0, np.int64) for _ in frontier], 0)
        return finish_uid_expand(q, frontier, matrix, traversed)
    raise NotImplementedError(
        f"value predicate {attr!r}: value predicates are not ported yet; "
        f"they wait for the value slice of dgraph_tpu_torch")


def finish_uid_expand(q: TaskQuery, frontier: np.ndarray,
                      matrix: list[np.ndarray], traversed: int) -> TaskResult:
    """Host tail of a uid-predicate frontier task: the uid_in filter
    function and the dest merge."""
    res = TaskResult()
    fname = q.func[0].lower() if q.func else None
    args = q.func[1] if q.func else []
    res.uid_matrix = matrix
    res.counts = [len(m) for m in matrix]
    res.traversed_edges = traversed
    if fname == "uid_in":
        # uid_in(pred, u1, u2, ...) keeps subjects with ANY listed object
        want = {int(str(a), 0) for a in args}
        keep = np.asarray([bool(want.intersection(m)) for m in matrix],
                          dtype=bool)
        res.dest_uids = frontier[keep]
    else:
        res.dest_uids = _merge_matrix(matrix)
    return res
