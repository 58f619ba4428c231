"""A large frontier's CSR rows mapped on the card (query/task.py
gather_on_device), and the one expand route (task.expand_route) the solo
expand and the batcher's classification share, on the CPU.

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

The route's kinds, each with the batch classification's miss reason or
`expand`; a large frontier classified and batched with nothing ranked on
the host, its batched answers equal to process_task's alone, also under
an injected upload fault; and a `~attr` task that keeps the planner's
host pin.

The benchmark's k-hop count through Node.query gives the reference's
count on both branches; on the device branch every level keeps its
gathered targets on the card (dgraph_expand_targets_on_device_total)
and none is copied back (dgraph_expand_targets_fetched_total stays 0).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dgraph_tpu_torch import carry
from dgraph_tpu_torch.ops import uidset as us
from dgraph_tpu_torch.query import batch as tbatch
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


# ---------------------------------------------------------------------------
# one route for the solo expand and the batcher
# ---------------------------------------------------------------------------

# case: (expand_route's kind, whether the route ranked on the host)
ROUTES = {
    "empty": ("empty", False),
    "mesh": ("mesh_sharded", False),
    "overlay": ("overlay", False),
    "cold": ("cold_tier", True),
    "cutover_at_edges": ("host_path", False),
    "small_host": ("host_path", True),
    "small_device": ("device", True),
    "large": ("device", False),
}


def _route_case(case):
    """(csr, frontier, cutover) of one expand_route case."""
    arrays = _arrays()
    csr, uids = _csr(arrays), _frontier("sorted")[:40]
    need = _want(arrays, uids, 0)[1]
    cutover = {"small_host": need, "cutover_at_edges": len(arrays[2]),
               "large": 1}.get(case, need - 1)
    if case == "empty":
        uids = uids[:0]
    if case == "mesh":
        csr = SimpleNamespace(is_dist=True)
    if case == "overlay":
        csr = _overlay()
    if case == "cold":
        csr, _mgr = _managed(16)
    if case == "large":
        uids = _frontier("unsorted")
    return csr, uids, cutover


@pytest.mark.parametrize("case", list(ROUTES))
def test_expand_route_and_the_batch_classification_agree(case):
    csr, uids, cutover = _route_case(case)
    route = ttask.expand_route(csr, uids, cutover)
    kind, ranked = ROUTES[case]
    assert route.kind == kind
    assert (route.rows is not None) == ranked
    if ranked:
        rows, need = _want(csr.host_arrays(), uids, 0)
        assert route.need == need == int(route.deg.sum())
        assert route.deg.tolist() == [len(r) for r in rows]
    snap = _snap(_arrays())
    snap.pred("friend").csr = csr
    key, reason, work = tbatch.classify(
        snap, tschema.SchemaState(),
        ttask.TaskQuery("friend", frontier=uids, cutover=cutover))
    want = {"empty": "empty_frontier", "device": "expand"}.get(kind, kind)
    assert reason == want
    assert (key is not None) == (kind == "device")
    if key is not None:
        assert work.route.kind == "device" and work.csr is csr
    if case == "cold":
        # both are consults: nothing uploaded, no cold serve counted
        assert not csr.device_resident()
        assert csr._res.metrics.counter(
            "dgraph_residency_cold_serves_total").value == 0


def _no_host_rank(*_a, **_k):
    raise AssertionError("a frontier was ranked on the host")


def test_a_large_frontier_classifies_without_a_host_rank(monkeypatch):
    snap = _snap(_arrays())
    monkeypatch.setattr(us, "host_rank_of", _no_host_rank)
    key, kind, work = tbatch.classify(
        snap, tschema.SchemaState(),
        ttask.TaskQuery("friend", frontier=_frontier("repeats"), cutover=1))
    assert kind == "expand" and key == ("expand", id(snap.pred("friend").csr))
    assert work.route.rows is None and work.route.need is None


@pytest.mark.parametrize("upload", ["plain", "upload_fault"])
def test_batched_large_frontiers_equal_process_task_alone(upload,
                                                          monkeypatch):
    """Two frontiers of HOST_CUTOVER uids or more, batched: the card ranks
    their concatenation as a whole (nothing is ranked on the host), or
    under an injected upload fault the host gather serves them."""
    arrays = _arrays()
    sc = tschema.SchemaState()
    frontiers = [_frontier("unsorted", seed=1), _frontier("absent", seed=2)]
    qs = [ttask.TaskQuery("friend", frontier=f, cutover=1) for f in frontiers]
    want = [ttask.process_task(_snap(arrays), q, sc) for q in qs]
    snap = _snap(arrays)
    mgr = ResidencyManager(budget_bytes=1 << 30, metrics=Registry())
    mgr._adopt(snap.pred("friend").csr, "friend", "csr")
    entries = []
    for q in qs:
        _key, kind, work = tbatch.classify(snap, sc, q)
        assert kind == "expand" and work.route.rows is None
        entries.append(tbatch._Entry(work))
    batcher = tbatch.DeviceBatcher(metrics=Registry(), idle_fire=False)
    if upload == "plain":
        monkeypatch.setattr(us, "host_rank_of", _no_host_rank)
    try:
        if upload == "upload_fault":
            faults.GLOBAL.reseed(3)
            faults.GLOBAL.install("residency.h2d_upload", "error", p=1.0)
        batcher._run_expand(entries)
    finally:
        faults.GLOBAL.clear()
    for e, w in zip(entries, want):
        assert e.error is None
        assert [r.tolist() for r in e.result.uid_matrix] == \
            [r.tolist() for r in w.uid_matrix]
        assert e.result.counts.tolist() == w.counts.tolist()
        assert e.result.traversed_edges == w.traversed_edges
        assert e.result.dest_uids.tolist() == w.dest_uids.tolist()
    csr = snap.pred("friend").csr
    assert csr.device_resident() == (upload == "plain")
    assert mgr.metrics.counter(
        "dgraph_residency_host_fallbacks_total").value == \
        int(upload == "upload_fault")


@pytest.mark.parametrize("cutover", [0, tgroupby._PIN_HOST])
def test_a_reverse_task_keeps_its_cutover(cutover, monkeypatch):
    """process_task's `~attr` rewrite keeps every field: the planner's pin
    holds the reverse expand on the host gather, as in a batch."""
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    s, p, x = _arrays()
    rev = tcb.transpose_csr(s, p, x)
    snap = carry.snapshot_from_numpy(
        {"friend": (int(TypeID.UID), s, p, x),
         "~friend": (int(TypeID.UID), *rev)}, 1, device="cpu")
    snap.metrics = Registry()
    uids = np.asarray(rev[0][: us.HOST_CUTOVER + 1], np.int64)
    got = ttask.process_task(
        snap, ttask.TaskQuery("~friend", frontier=uids, cutover=cutover),
        tschema.SchemaState())
    pinned = cutover == tgroupby._PIN_HOST
    assert snap.metrics.counter(ON_DEVICE).value == int(not pinned)
    assert snap.metrics.counter(DEST_ON_DEVICE).value == int(not pinned)
    rows, total = _want(rev, uids, 0)
    assert [r.tolist() for r in got.uid_matrix] == [r.tolist() for r in rows]
    assert got.traversed_edges == total


# ---------------------------------------------------------------------------
# the k-hop count through the Node: no reader asks for the gathered rows
# ---------------------------------------------------------------------------

HELD = "dgraph_expand_targets_on_device_total"
FETCHED = "dgraph_expand_targets_fetched_total"


@pytest.fixture(scope="module")
def khop_node():
    from dgraph_tpu_torch.api.server import Node
    s, p, x = _arrays()
    node = Node(device="cpu", planner=False, batching=False,
                task_cache_mb=0, result_cache_mb=0)
    quads = [f"<0x{int(u):x}> <friend> <0x{int(v):x}> ."
             for i, u in enumerate(s.tolist()) for v in x[p[i]: p[i + 1]]]
    node.alter(schema_text="friend: [uid] @reverse .")
    node.mutate(set_nquads="\n".join(quads), commit_now=True)
    seeds = np.sort(np.random.default_rng(12).choice(
        s[p[1:] > p[:-1]], 512, replace=False)).astype(np.int64)
    yield node, (s, p, x), seeds
    node.close()


def _khop_count(arrays, seeds, hops=3):
    """|A ∪ B ∪ C|: the uids one to `hops` steps from the seeds."""
    s, p, x = arrays
    frontier, reached = seeds, set()
    for _ in range(hops):
        rows, _t = _want(arrays, frontier, 0)
        frontier = np.unique(np.concatenate(rows))
        reached.update(frontier.tolist())
    return len(reached)


@pytest.mark.parametrize("path", ["host", "device"])
def test_the_khop_count_keeps_its_targets_on_the_device(path, khop_node,
                                                        monkeypatch):
    """The benchmark's k-hop request shape: two of its levels map their
    frontier on the card, every level gathers there, and nothing reads
    the rows, so no level's targets come back."""
    if path == "device":
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    node, arrays, seeds = khop_node
    q = ("{ var(func: uid(%s)) { A as friend { B as friend { C as friend "
         "} } } q(func: uid(A, B, C)) { count(uid) } }"
         % ", ".join(hex(int(u)) for u in seeds))
    c = {k: node.metrics.counter(k) for k in (HELD, FETCHED, ON_DEVICE)}
    before = {k: v.value for k, v in c.items()}
    out = node.query(q)[0]
    moved = {k: v.value - before[k] for k, v in c.items()}
    assert out == {"q": [{"count": _khop_count(arrays, seeds)}]}
    on_card = path == "device"
    assert moved[HELD] == (3 if on_card else 0)
    assert moved[ON_DEVICE] == (2 if on_card else 0)
    assert moved[FETCHED] == 0
