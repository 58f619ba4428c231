"""A large frontier's CSR rows mapped on the card (query/task.py
_expand_rows_on_device), on the CPU.

From uidset.HOST_CUTOVER frontier uids, over a resident plain PredCSR and
under a cutover below the tablet's size, the expand ranks the frontier in
the device subjects and sums the degrees from the device indptr, instead
of the host mirror's binary search. Against the host map:

- the same UidMatrix (flat targets, offsets, dest), counts and traversed
  edges for frontiers sorted, unsorted, with repeats, with absent uids,
  with uids above 2^31 - 1, and with no subject at all, both want_dest
  values and first != 0;
- dgraph_expand_rows_on_device_total moves only where the map engages:
  not below HOST_CUTOVER, on a cold tablet, over an OverlayCSR, under
  groupby's host pin or on the injected residency.h2d_upload fault
  fallback;
- a cutover above the mapped degree sum takes the host gather with the
  rows read back, with equal answers.
"""

import numpy as np
import pytest
import torch

from dgraph_tpu_torch import carry
from dgraph_tpu_torch.ops import uidset as us
from dgraph_tpu_torch.query import groupby as tgroupby
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.storage import csr_build as tcb
from dgraph_tpu_torch.storage.delta import OverlayCSR, OverlayRows
from dgraph_tpu_torch.storage.residency import ResidencyManager
from dgraph_tpu_torch.utils import faults
from dgraph_tpu_torch.utils import schema as tschema
from dgraph_tpu_torch.utils.metrics import Registry
from dgraph_tpu_torch.utils.types import TypeID

ON_DEVICE = "dgraph_expand_rows_on_device_total"
DEST_ON_DEVICE = "dgraph_expand_dest_on_device_total"
N = 5000              # subjects 1..N, every third with an empty row
BIG = 2 ** 31         # above the int32 uid space


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed=4, n=N, m=6 * N):
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(1, n + 1, m),
                                rng.integers(1, 2 * n, m)], axis=1), axis=0)
    deg = np.bincount(pairs[:, 0], minlength=n + 1)[1:]
    deg[::3] = 0
    keep = deg[pairs[:, 0] - 1] > 0
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    return (np.arange(1, n + 1, dtype=np.int32), indptr.astype(np.int32),
            pairs[keep, 1].astype(np.int32))


def _csr(arrays=None):
    return tcb.PredCSR(*(arrays or _arrays()), device="cpu")


def _frontier(kind, seed=9):
    """A frontier of at least HOST_CUTOVER uids of the given kind."""
    rng = np.random.default_rng(seed)
    k = us.HOST_CUTOVER + 300
    if kind == "sorted":
        return np.sort(rng.choice(np.arange(1, N + 1), k, replace=False))
    if kind == "unsorted":
        return rng.choice(np.arange(1, N + 1), k, replace=False)
    if kind == "repeats":
        return rng.integers(1, N + 1, k)
    if kind == "absent":          # half are no subject (above N, or 0)
        return rng.integers(0, 2 * N, k)
    if kind == "above_int32":
        u = rng.integers(1, N + 1, k)
        # the int32 casts of these are subjects: a wrap would map them
        u[::7] = (1 << 32) * rng.integers(1, 1 << 20, len(u[::7])) \
            + rng.integers(1, N + 1, len(u[::7]))
        u[1] = BIG + 5            # the int32 cast is negative
        u[3] = 2 ** 31 - 1        # the int32 sentinel is no subject
        u[5] = 2 ** 63 - 1
        return u
    if kind == "none_mapped":
        return np.arange(N + 1, N + 1 + k)
    raise AssertionError(kind)


KINDS = ["sorted", "unsorted", "repeats", "absent", "above_int32",
         "none_mapped"]


def _want(arrays, uids, first):
    """The rows (cut by first) and the edge total, uid by uid."""
    s, p, x = arrays
    rows, total = [], 0
    for u in np.asarray(uids).tolist():
        i = np.searchsorted(s, u)
        row = x[p[i]: p[i + 1]].astype(np.int64) \
            if i < len(s) and s[i] == u else np.zeros(0, np.int64)
        total += len(row)
        rows.append(row[:first] if first > 0 else
                    row[first:] if first < 0 else row)
    return rows, total


def _expand(csr, uids, first=0, cutover=0, want_dest=True):
    metrics = Registry()
    matrix, total = ttask._expand_csr(csr, np.asarray(uids, np.int64),
                                      first, cutover, want_dest, metrics)
    return matrix, total, metrics


def _cols(matrix):
    dest = None if matrix.dest is None else matrix.dest.tolist()
    return matrix.flat.tolist(), matrix.offsets.tolist(), dest


@pytest.mark.parametrize("want_dest", [True, False])
@pytest.mark.parametrize("first", [0, 2, -1])
@pytest.mark.parametrize("kind", KINDS)
def test_device_map_gives_the_host_maps_matrix(kind, first, want_dest,
                                               monkeypatch):
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays = _arrays()
    uids = _frontier(kind)
    got, got_total, metrics = _expand(_csr(arrays), uids, first,
                                      want_dest=want_dest)
    assert metrics.counter(ON_DEVICE).value == 1
    # the host map: the same expand with the device map switched off
    monkeypatch.setattr(us, "HOST_CUTOVER", 1 << 62)
    want, want_total, host_metrics = _expand(_csr(arrays), uids, first,
                                             want_dest=want_dest)
    assert host_metrics.counter(ON_DEVICE).value == 0
    assert _cols(got) == _cols(want)
    assert got.counts().tolist() == want.counts().tolist()
    assert got_total == want_total
    rows, total = _want(arrays, uids, first)
    assert [r.tolist() for r in got] == [r.tolist() for r in rows]
    assert got_total == total
    on_card = want_dest and first == 0 and total > 0
    assert (got.dest is not None) == on_card
    assert metrics.counter(DEST_ON_DEVICE).value == int(on_card)
    if on_card:
        assert got.dest.tolist() == np.unique(np.concatenate(rows)).tolist()


@pytest.mark.parametrize("kind", KINDS)
def test_rows_on_device_equal_rows_for_uids(kind):
    csr = _csr()
    uids = _frontier(kind).astype(np.int64)
    rows_d, h2d = ttask._rows_on_device(csr.subjects, uids)
    assert rows_d.dtype == torch.int32
    assert rows_d.numpy().tolist() == ttask.rows_for_uids(csr, uids).tolist()
    # the frontier goes up as int32 where every uid fits
    assert h2d == (8 if kind == "above_int32" else 4) * len(uids)


def _snap(arrays):
    snap = carry.snapshot_from_numpy(
        {"friend": (int(TypeID.UID), *arrays)}, 1, device="cpu")
    snap.metrics = Registry()
    return snap


@pytest.mark.parametrize("kind", KINDS)
def test_process_task_counts_and_traversed_edges(kind, monkeypatch):
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays = _arrays()
    uids = _frontier(kind)
    snap = _snap(arrays)
    q = ttask.TaskQuery("friend", frontier=uids)
    sc = tschema.SchemaState()
    for e in tschema.parse_schema("friend: [uid] ."):
        sc.set(e)
    got = ttask.process_task(snap, q, sc)
    assert snap.metrics.counter(ON_DEVICE).value == 1
    monkeypatch.setattr(us, "HOST_CUTOVER", 1 << 62)
    want = ttask.process_task(_snap(arrays), q, sc)
    assert [int(c) for c in got.counts] == [int(c) for c in want.counts]
    assert got.traversed_edges == want.traversed_edges
    assert got.dest_uids.tolist() == want.dest_uids.tolist()
    assert [r.tolist() for r in got.uid_matrix] == \
        [r.tolist() for r in want.uid_matrix]


# ---------------------------------------------------------------------------
# where the map engages
# ---------------------------------------------------------------------------

def _managed(budget_bytes):
    mgr = ResidencyManager(budget_bytes=budget_bytes, metrics=Registry())
    csr = _csr()
    mgr._adopt(csr, "friend", "csr")
    return csr, mgr


def _overlay():
    arrays = _arrays()
    base = _csr(arrays)
    subs = np.asarray([2, 3, N + 7], np.int64)
    rows = [np.asarray([1, 9], np.int64), np.zeros(0, np.int64),
            np.asarray([4], np.int64)]
    return OverlayCSR(base, OverlayRows(subs, rows))


@pytest.mark.parametrize("case", ["engaged", "below_cutover", "cold",
                                  "overlay", "groupby_pin", "upload_fault"])
def test_counter_moves_only_where_the_map_engages(case, monkeypatch):
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    uids = _frontier("sorted")
    cutover, mgr = 0, None
    if case == "below_cutover":
        uids = uids[: us.HOST_CUTOVER - 1]
    if case in ("engaged", "below_cutover", "groupby_pin"):
        csr = _csr()
    if case == "groupby_pin":
        cutover = tgroupby._PIN_HOST
    if case == "cold":
        csr, mgr = _managed(16)              # the tablet exceeds the budget
        assert csr.prefer_host()
    if case == "overlay":
        csr = _overlay()
    if case == "upload_fault":
        csr, mgr = _managed(1 << 30)
        faults.GLOBAL.reseed(7)
        faults.GLOBAL.install("residency.h2d_upload", "error", p=1.0)
    try:
        got, total, metrics = _expand(csr, uids, cutover=cutover)
    finally:
        faults.GLOBAL.clear()
    engaged = case == "engaged"
    assert metrics.counter(ON_DEVICE).value == int(engaged)
    if case != "overlay":
        rows, want_total = _want(csr.host_arrays(), uids, 0)
        assert [r.tolist() for r in got] == [r.tolist() for r in rows]
        assert total == want_total
    if case == "cold":
        assert not csr.device_resident()
        assert mgr.metrics.counter(
            "dgraph_residency_cold_serves_total").value == 1
    if case == "upload_fault":
        assert not csr.device_resident()
        assert mgr.metrics.counter(
            "dgraph_residency_host_fallbacks_total").value == 1
        assert mgr.metrics.counter(
            "dgraph_residency_upload_failures_total").value == 1
    if case == "groupby_pin":
        assert got.dest is None            # the host gather ran


def test_a_cutover_above_the_mapped_need_takes_the_host_gather(monkeypatch):
    arrays = _arrays()
    uids = _frontier("unsorted")
    _rows, need = _want(arrays, uids, 0)
    assert 0 < need < len(arrays[2])
    csr = _csr(arrays)
    got, total, metrics = _expand(csr, uids, cutover=need)
    # the map ran on the card, then the rows came back for the host gather
    assert metrics.counter(ON_DEVICE).value == 1
    assert metrics.counter(DEST_ON_DEVICE).value == 0
    assert got.dest is None and total == need
    monkeypatch.setattr(us, "HOST_CUTOVER", 1 << 62)
    want, want_total, _m = _expand(_csr(arrays), uids, cutover=need)
    assert _cols(got) == _cols(want) and total == want_total
    # one edge more than the cutover allows: the device gather
    got2, total2, metrics2 = _expand(_csr(arrays), uids, cutover=need - 1)
    assert metrics2.counter(DEST_ON_DEVICE).value == 1
    assert got2.flat.tolist() == want.flat.tolist() and total2 == need
