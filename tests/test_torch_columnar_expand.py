"""The columnar uid level (query/task.UidMatrix) and the encoder's skipped
walk, on the CPU.

A uid expand keeps its uidMatrix as flat targets and row offsets, and the
device gather dedups the level's dest set beside them
(ops/csr.unique_targets). Against the list of per-slot rows it replaces:

- random CSRs with empty rows, frontiers with missing subjects (sentinel
  rows), on the host branch and on the device branch (HOST_EXPAND_MAX 0):
  equal rows, counts, dest_uids and traversed_edges, with first positive,
  negative and 0;
- the task cache's copies share the columns and stay isolated, and its
  sizing reads no row and stays within the per-row estimate;
- dgraph_expand_dest_on_device_total moves only on the device branch;
- every path gives a UidMatrix: rows handed in as a list, the wire's
  decode, and the batcher; and the device gather's targets are cast to
  int64 only when a row or the flat column is read.

The device gather leaves its targets on the card
(dgraph_expand_targets_on_device_total): len, bool, counts, nbytes, the
dest merge, the task cache's sizing and copy, and `has` read none of
them. Each reader of rows (flat, m[i], iteration, first +1 and -1,
uid_in, the batcher's split, groupby, the wire encode, @cascade) gives
the host branch's answer and copies the targets back once
(dgraph_expand_targets_fetched_total); the gather's seam books no target
bytes and the fetch's seam books exactly them; a task-cache hit read on
another thread shares the one copy.

A gathered level's result carries the card's copy of its dest
(TaskResult.dest_dev) only on the device branch with a dest, never in
the task cache, a cache hit or a batched member.

encode_result skips its per-uid walk for a block whose children are all
aggregates or count(uid): the JSON stays byte-identical to the JAX
package's Executor, and dgraph_encode_walks_skipped_total moves for such
blocks only.
"""

import json

import numpy as np
import pytest
import torch

from dgraph_tpu.models.rmat import rmat_csr
from dgraph_tpu.query import dql as jdql
from dgraph_tpu.query import engine as jeng
from dgraph_tpu.query import task as jtask
from dgraph_tpu.storage import csr_build as jcb
from dgraph_tpu.utils import schema as jschema
from dgraph_tpu.utils.types import TypeID as JTypeID

from dgraph_tpu_torch import carry
from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.ops import csr as tcsr
from dgraph_tpu_torch.query import dql as tdql
from dgraph_tpu_torch.query import engine as teng
from dgraph_tpu_torch.query import qcache
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.utils import schema as tschema
from dgraph_tpu_torch.utils.metrics import Registry
from dgraph_tpu_torch.utils.types import TypeID

SKIPPED = "dgraph_encode_walks_skipped_total"
ON_DEVICE = "dgraph_expand_dest_on_device_total"
HELD = "dgraph_expand_targets_on_device_total"
FETCHED = "dgraph_expand_targets_fetched_total"
SCHEMA = "follow: [uid] @reverse .\nfriend: [uid] ."


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_csr(seed, n=300, m=2400):
    """int32 (subjects, indptr, indices) over uids 1..n: every third
    subject has an empty row, and uids above n never appear as subjects."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n + 1, m)
    dst = rng.integers(1, 2 * n, m)
    pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
    subjects = np.arange(1, n + 1)
    deg = np.bincount(pairs[:, 0], minlength=n + 1)[1:]
    deg[::3] = 0
    keep = deg[pairs[:, 0] - 1] > 0
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    return (subjects.astype(np.int32), indptr.astype(np.int32),
            pairs[keep, 1].astype(np.int32))


def _frontier(seed, n=300, k=120):
    """Sorted-unique uids: subjects (some with empty rows) and uids that
    are no subject at all."""
    rng = np.random.default_rng(seed + 1)
    return np.unique(rng.integers(1, 2 * n, k)).astype(np.int64)


def _want(arrays, frontier, first):
    """The uidMatrix as the list of per-slot rows, from the arrays."""
    s, p, x = arrays
    rows, traversed = [], 0
    for u in frontier.tolist():
        i = np.searchsorted(s, u)
        if i < len(s) and s[i] == u:
            row = x[p[i]: p[i + 1]].astype(np.int64)
        else:
            row = np.zeros(0, np.int64)
        traversed += len(row)
        rows.append(row[:first] if first > 0 else
                    row[first:] if first < 0 else row)
    flat = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    return rows, np.unique(flat), traversed


def _snap(arrays):
    snap = carry.snapshot_from_numpy(
        {"friend": (int(TypeID.UID), *arrays)}, 1, device="cpu")
    snap.metrics = Registry()
    return snap


def _schema():
    ts = tschema.SchemaState()
    for e in tschema.parse_schema(SCHEMA):
        ts.set(e)
    return ts


@pytest.mark.parametrize("first", [0, 2, -2, 1, -1, 1000])
@pytest.mark.parametrize("path", ["host", "device"])
@pytest.mark.parametrize("seed", [3, 11])
def test_columnar_matrix_equals_the_row_list(seed, path, first, monkeypatch):
    if path == "device":
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays = _random_csr(seed)
    frontier = _frontier(seed)
    snap = _snap(arrays)
    res = ttask.process_task(
        snap, ttask.TaskQuery("friend", frontier=frontier, first=first),
        _schema())
    rows, dest, traversed = _want(arrays, frontier, first)
    m = res.uid_matrix
    assert isinstance(m, ttask.UidMatrix)
    assert len(m) == len(rows) and bool(m) == bool(rows)
    assert all(r.dtype == np.int64 for r in m)
    assert [r.tolist() for r in m] == [r.tolist() for r in rows]
    assert [m[i].tolist() for i in range(len(m))] == \
        [r.tolist() for r in rows]
    assert m[-1].tolist() == rows[-1].tolist()
    assert [int(c) for c in res.counts] == [len(r) for r in rows]
    assert res.dest_uids.dtype == np.int64
    assert res.dest_uids.tolist() == dest.tolist()
    assert res.traversed_edges == traversed
    # the card computes the dest only on the device branch, and only for
    # untruncated rows
    on_device = path == "device" and first == 0
    assert (m.dest is not None) == on_device
    assert snap.metrics.counter(ON_DEVICE).value == int(on_device)


@pytest.mark.parametrize("n_rows", [0, 1, 7])
def test_rows_given_as_a_list_become_columns(n_rows):
    rng = np.random.default_rng(n_rows)
    rows = [rng.integers(1, 99, int(k)).astype(np.int32)
            for k in rng.integers(0, 4, n_rows)]
    res = ttask.TaskResult(uid_matrix=rows)
    m = res.uid_matrix
    assert isinstance(m, ttask.UidMatrix) and m.dest is None
    assert [r.tolist() for r in m] == [r.tolist() for r in rows]
    assert all(r.dtype == np.int64 for r in m)
    assert m.counts().tolist() == [len(r) for r in rows]
    empty = ttask.TaskResult()
    assert isinstance(empty.uid_matrix, ttask.UidMatrix)
    assert len(empty.uid_matrix) == 0 and not empty.uid_matrix
    assert len(ttask.UidMatrix.empty(3)) == 3
    assert [len(r) for r in ttask.UidMatrix.empty(3)] == [0, 0, 0]


def test_device_targets_cast_only_when_read(monkeypatch):
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays = _random_csr(19)
    frontier = _frontier(19)
    res = ttask.process_task(
        _snap(arrays), ttask.TaskQuery("friend", frontier=frontier),
        _schema())
    m = res.uid_matrix
    rows, dest, _t = _want(arrays, frontier, 0)
    # the dest and the counts need no cast of the gathered int32 targets
    assert res.dest_uids.tolist() == dest.tolist()
    # held on the device as the gather left them
    assert isinstance(m._flat, torch.Tensor)
    assert m._flat.dtype == torch.int32
    assert m.nbytes() == 8 * len(m._flat) + m.offsets.nbytes
    assert [r.tolist() for r in m] == [r.tolist() for r in rows]
    assert m._flat.dtype == np.int64 and m.flat.dtype == np.int64


@pytest.mark.parametrize("path", ["host", "device"])
def test_wire_round_trip_keeps_the_columns(path, monkeypatch):
    from dgraph_tpu_torch.parallel import remote as tremote
    from dgraph_tpu_torch.protos import internal_pb2 as tipb
    if path == "device":
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays = _random_csr(23)
    frontier = _frontier(23)
    res = ttask.process_task(
        _snap(arrays), ttask.TaskQuery("friend", frontier=frontier),
        _schema())
    wire = tremote.encode_result(res).SerializeToString()
    back = tremote.decode_result(tipb.TaskResponse.FromString(wire))
    assert isinstance(back.uid_matrix, ttask.UidMatrix)
    assert [r.tolist() for r in back.uid_matrix] == \
        [r.tolist() for r in res.uid_matrix]
    assert list(back.counts) == res.counts.tolist()
    assert back.dest_uids.tolist() == res.dest_uids.tolist()
    assert tremote.encode_result(back).SerializeToString() == wire


@pytest.mark.parametrize("spread", ["dense", "sparse"])
def test_unique_targets_equals_np_unique(spread):
    rng = np.random.default_rng(5)
    hi = 50 if spread == "dense" else 1 << 30
    t = rng.integers(0, hi, 400).astype(np.int32)
    got, read = tcsr.unique_targets(torch.from_numpy(t))
    assert got.dtype == torch.int32 and read > 0
    assert got.tolist() == np.unique(t).tolist()
    empty, read = tcsr.unique_targets(torch.from_numpy(t[:0]))
    assert empty.numel() == 0 and read == 0


@pytest.mark.parametrize("fname", ["uid_in", "has"])
def test_row_readers_keep_their_paths(fname, monkeypatch):
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays = _random_csr(7)
    frontier = _frontier(7)
    snap = _snap(arrays)
    rows, _dest, _t = _want(arrays, frontier, 0)
    args = [hex(int(rows[1][0]))] if fname == "uid_in" else []
    res = ttask.process_task(
        snap, ttask.TaskQuery("friend", frontier=frontier,
                              func=(fname, args)), _schema())
    if fname == "uid_in":
        want = [u for u, r in zip(frontier, rows) if int(args[0], 0) in r]
    else:
        want = [u for u, r in zip(frontier, rows) if len(r)]
    assert res.dest_uids.tolist() == [int(u) for u in want]
    assert res.uid_matrix.dest is None
    assert snap.metrics.counter(ON_DEVICE).value == 0


@pytest.mark.parametrize("path", ["host", "device"])
def test_task_cache_copies_are_isolated(path, monkeypatch):
    if path == "device":
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays = _random_csr(13)
    frontier = _frontier(13)
    snap, schema = _snap(arrays), _schema()
    q = ttask.TaskQuery("friend", frontier=frontier)
    cache = qcache.TaskResultCache(1 << 20)
    calls = []

    def compute(tq):
        calls.append(1)
        return ttask.process_task(snap, tq, schema)

    first = cache.dispatch(1, q, compute)
    want = [r.tolist() for r in first.uid_matrix]
    want_counts = [int(c) for c in first.counts]
    # a caller replaces rows and reassigns, as child pagination does
    first.uid_matrix = [r[:1] for r in first.uid_matrix]
    first.counts = [len(r) for r in first.uid_matrix]
    first.dest_uids = first.dest_uids[:1]
    again = cache.dispatch(1, q, compute)
    assert len(calls) == 1                        # served from the cache
    assert isinstance(again.uid_matrix, ttask.UidMatrix)
    assert [r.tolist() for r in again.uid_matrix] == want
    assert [int(c) for c in again.counts] == want_counts
    assert again.dest_uids.tolist() == _want(arrays, frontier, 0)[1].tolist()
    other = qcache.copy_result(again)
    other.uid_matrix = []
    assert [r.tolist() for r in again.uid_matrix] == want


class _Unreadable(ttask.UidMatrix):
    """A columnar matrix whose rows must not be read."""

    __slots__ = ()

    def __getitem__(self, i):
        raise AssertionError("a row was read")

    def __iter__(self):
        raise AssertionError("the rows were walked")


@pytest.mark.parametrize("n_rows", [1, 10, 1000])
def test_result_nbytes_reads_no_row_and_stays_within_the_old_estimate(
        n_rows):
    rng = np.random.default_rng(n_rows)
    counts = rng.integers(0, 6, n_rows)
    offs = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    flat = rng.integers(1, 1 << 20, int(offs[-1])).astype(np.int64)
    m = _Unreadable(flat, offs)
    res = ttask.TaskResult(uid_matrix=m, counts=m.counts(),
                           dest_uids=np.unique(flat))
    got = qcache.result_nbytes(res)
    rows = [flat[offs[i]: offs[i + 1]] for i in range(n_rows)]
    old = 256 + 8 * n_rows + res.dest_uids.nbytes + \
        sum(r.nbytes + 16 for r in rows)
    assert 0 < got <= old
    assert got >= flat.nbytes + res.dest_uids.nbytes


def _node_graph(node, n=60, m=400, k=6):
    """Load a random graph; returns k subjects with a row (all the
    subjects, empty rows too, where k is None)."""
    s, p, x = _random_csr(17, n=n, m=m)
    quads = []
    for i, u in enumerate(s.tolist()):
        quads += [f"<0x{u:x}> <friend> <0x{int(v):x}> ."
                  for v in x[p[i]: p[i + 1]]]
    node.alter(schema_text=SCHEMA)
    node.mutate(set_nquads="\n".join(quads), commit_now=True)
    if k is None:
        return [int(u) for u in s]
    return [int(u) for u in s[p[1:] > p[:-1]][:k]]


@pytest.mark.parametrize("first,size", [
    pytest.param(f, size, id=str(f) if size == "small" else f"{f}-{size}")
    for size in ("small", "large") for f in (0, 1, -1)])
def test_batched_expand_gives_the_solo_columns(first, size, monkeypatch):
    """The batcher's expand (rows ranked on the host by its
    classification) against the solo one; a large frontier's solo expand
    maps its rows on the card (from uidset.HOST_CUTOVER uids)."""
    import threading

    from dgraph_tpu_torch.ops import uidset as us
    from dgraph_tpu_torch.query.batch import DeviceBatcher
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    n = Node(device="cpu", planner=False, task_cache_mb=0,
             result_cache_mb=0)
    try:
        if size == "small":
            seeds = _node_graph(n)
        else:
            seeds = _node_graph(n, n=2 * us.HOST_CUTOVER + 200,
                                m=6 * us.HOST_CUTOVER, k=None)
        half = len(seeds) // 2
        batcher = DeviceBatcher(n.dispatch_gate, n.metrics, window_ms=2000,
                                max_batch=2, idle_fire=False)
        snap, schema = n.snapshot(), n.store.schema
        qs = [ttask.TaskQuery("friend", frontier=np.asarray(
            sorted(part), dtype=np.int64), first=first)
            for part in (seeds[:half], seeds[half:])]
        rows_on_card = snap.metrics.counter(
            "dgraph_expand_rows_on_device_total")
        c0 = rows_on_card.value
        want = [ttask.process_task(snap, q, schema) for q in qs]
        assert rows_on_card.value - c0 == (2 if size == "large" else 0)
        got = [None, None]
        barrier = threading.Barrier(2)

        def run(i):
            barrier.wait(timeout=10)
            got[i] = batcher.dispatch(
                snap, schema, qs[i],
                lambda tq, klass=None: ttask.process_task(snap, tq, schema))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        occ = n.metrics.histogram("dgraph_batch_occupancy").snapshot()
        assert occ["max"] == 2, occ
        for g, w in zip(got, want):
            assert isinstance(g.uid_matrix, ttask.UidMatrix)
            assert [r.tolist() for r in g.uid_matrix] == \
                [r.tolist() for r in w.uid_matrix]
            assert g.counts.tolist() == w.counts.tolist()
            assert g.dest_uids.tolist() == w.dest_uids.tolist()
    finally:
        n.close()


@pytest.mark.parametrize("path", ["host", "device"])
def test_dest_counter_moves_only_on_the_device_branch(path, monkeypatch):
    if path == "device":
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    n = Node(device="cpu", planner=False, batching=False,
             task_cache_mb=0, result_cache_mb=0)
    try:
        seeds = _node_graph(n)
        q = "{ q(func: uid(%s)) { uid friend { uid } } }" % \
            ", ".join(hex(u) for u in seeds)
        c0 = n.metrics.counter(ON_DEVICE).value
        out = n.query(q)[0]
        moved = n.metrics.counter(ON_DEVICE).value - c0
        assert len(out["q"]) == len(seeds)
        assert moved == (1 if path == "device" else 0)
    finally:
        n.close()


# ---------------------------------------------------------------------------
# a device-gathered level's targets stay on the card until a reader asks
# ---------------------------------------------------------------------------

def _device_task(arrays, frontier, func=None):
    """process_task on the device branch (HOST_EXPAND_MAX 0 is set by the
    caller): (the result, the snapshot, whose registry counts)."""
    snap = _snap(arrays)
    res = ttask.process_task(
        snap, ttask.TaskQuery("friend", frontier=frontier, func=func),
        _schema())
    return res, snap


def _cols_of(res):
    """A task result as plain lists: rows, counts, dest, traversed."""
    return ([r.tolist() for r in res.uid_matrix],
            [int(c) for c in res.counts], res.dest_uids.tolist(),
            res.traversed_edges)


def _read_rows(m):
    return [r.tolist() for r in m]


def _split_flat(m):
    flat = m.flat
    return [flat[m.offsets[i]: m.offsets[i + 1]].tolist()
            for i in range(len(m))]


def _exec_json(snap, q):
    return json.dumps(teng.Executor(snap, _schema()).execute(tdql.parse(q)))


def _batched(arrays, frontier):
    """The batcher's expand of two halves of the frontier: each member's
    result as plain lists."""
    from dgraph_tpu_torch.query import batch as tbatch
    snap, sc = _snap(arrays), _schema()
    half = len(frontier) // 2
    qs = [ttask.TaskQuery("friend", frontier=part)
          for part in (frontier[:half], frontier[half:])]
    works = [tbatch.classify(snap, sc, q)[2] for q in qs]
    if any(w is None for w in works):
        # the host branch: the classification sends the tasks solo
        return [_cols_of(ttask.process_task(snap, q, sc)) for q in qs], snap
    entries = [tbatch._Entry(w) for w in works]
    tbatch.DeviceBatcher(metrics=Registry(), idle_fire=False)._run_expand(
        entries)
    assert all(e.error is None for e in entries)
    return [_cols_of(e.result) for e in entries], snap


# a reader of rows: (what it reads as plain values, the registry counting
# the fetch); the fetch must happen once, wherever the reader sits
def _reader_task(read):
    def run(arrays, frontier):
        res, snap = _device_task(arrays, frontier)
        return (_cols_of(res)[1:], read(res)), snap
    return run


def _reader_func(arrays, frontier):
    res, snap = _device_task(arrays, frontier,
                             ("uid_in", [hex(int(frontier[1]))]))
    return _cols_of(res), snap


def _reader_wire(arrays, frontier):
    from dgraph_tpu_torch.parallel import remote as tremote
    res, snap = _device_task(arrays, frontier)
    return tremote.encode_result(res).SerializeToString(), snap


def _reader_query(q):
    def run(arrays, frontier):
        snap = _snap(arrays)
        return _exec_json(snap, q % ", ".join(hex(int(u))
                                              for u in frontier)), snap
    return run


ROW_READERS = {
    "flat": _reader_task(lambda res: _split_flat(res.uid_matrix)),
    "getitem": _reader_task(lambda res: [
        res.uid_matrix[i].tolist() for i in range(len(res.uid_matrix))]),
    "iter": _reader_task(lambda res: _read_rows(res.uid_matrix)),
    "first+1": _reader_task(
        lambda res: _read_rows(ttask.apply_first(res.uid_matrix, 1))),
    "first-1": _reader_task(
        lambda res: _read_rows(ttask.apply_first(res.uid_matrix, -1))),
    "uid_in": _reader_func,
    "batch": _batched,
    "groupby": _reader_query(
        "{ q(func: uid(%s)) @groupby(friend) { count(uid) } }"),
    "wire": _reader_wire,
    "cascade": _reader_query(
        "{ q(func: uid(%s)) @cascade { uid friend { uid } } }"),
}


@pytest.mark.parametrize("reader", list(ROW_READERS))
def test_a_row_reader_fetches_the_device_targets_once(reader, monkeypatch):
    from dgraph_tpu_torch.query import groupby as tgroupby
    # groupby pins its key expansion to the host; unpinned here, so that
    # its reader meets a level held on the card
    monkeypatch.setattr(tgroupby, "_PIN_HOST", 0)
    arrays = _random_csr(29)
    frontier = _frontier(29)
    want, _host_snap = ROW_READERS[reader](arrays, frontier)
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    got, snap = ROW_READERS[reader](arrays, frontier)
    assert got == want
    # @cascade runs its child again over the frontier it pruned: two levels
    held = snap.metrics.counter(HELD).value
    assert held == (2 if reader == "cascade" else 1)
    assert snap.metrics.counter(FETCHED).value == held


def test_a_gathered_level_stays_on_the_device(monkeypatch):
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays = _random_csr(31)
    frontier = _frontier(31)
    res, snap = _device_task(arrays, frontier)
    m = res.uid_matrix
    assert isinstance(m._flat, torch.Tensor) and m.dest is not None
    assert snap.metrics.counter(HELD).value == 1
    assert snap.metrics.counter(FETCHED).value == 0
    rows, dest, traversed = _want(arrays, frontier, 0)
    # the readers of the offsets and the dest do not fetch
    assert len(m) == len(rows) and bool(m)
    assert m.counts().tolist() == [len(r) for r in rows]
    assert m.nbytes() == 8 * traversed + m.offsets.nbytes
    assert res.dest_uids.tolist() == dest.tolist()
    assert res.traversed_edges == traversed
    assert ttask._merge_matrix(m) is m.dest
    assert qcache.result_nbytes(res) > 0
    qcache.copy_result(res)
    has, has_snap = _device_task(arrays, frontier, ("has", []))
    assert has.dest_uids.tolist() == \
        [int(u) for u, r in zip(frontier, rows) if len(r)]
    assert isinstance(has.uid_matrix._flat, torch.Tensor)
    assert isinstance(m._flat, torch.Tensor)
    for sn in (snap, has_snap):
        assert sn.metrics.counter(FETCHED).value == 0
    # the first row read fetches; later reads do not
    assert _read_rows(m) == [r.tolist() for r in rows]
    assert isinstance(m._flat, np.ndarray)
    assert m.flat.tolist() == np.concatenate(rows).tolist()
    assert snap.metrics.counter(FETCHED).value == 1


def test_the_seams_book_the_bytes_each_copied(monkeypatch):
    from dgraph_tpu_torch.obs import costs
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    timers = []
    real = costs.kernel

    def spy(name, *a, **kw):
        t = real(name, *a, **kw)
        timers.append((name, t))
        return t
    monkeypatch.setattr(costs, "kernel", spy)
    arrays = _random_csr(37)
    frontier = _frontier(37)
    res, _snap_ = _device_task(arrays, frontier)
    assert [n for n, _t in timers] == ["csr.expand"]
    gather = timers[0][1]
    rows, dest, traversed = _want(arrays, frontier, 0)
    flat32 = torch.from_numpy(np.concatenate(rows).astype(np.int32))
    _dest_d, read = tcsr.unique_targets(flat32)
    # the total, the counts and the dest (with the scalars that sized
    # it); the host ranked the rows, so none came back
    assert gather.d2h == 4 + 4 * len(frontier) + read + 4 * len(dest)
    _read_rows(res.uid_matrix)
    _read_rows(res.uid_matrix)
    assert [n for n, _t in timers] == ["csr.expand", "uidmatrix.fetch"]
    fetch = timers[1][1]
    assert (fetch.h2d, fetch.d2h) == (0, 4 * traversed)


def test_a_cache_hit_on_a_device_held_level(monkeypatch):
    import threading
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays = _random_csr(41)
    frontier = _frontier(41)
    snap, schema = _snap(arrays), _schema()
    q = ttask.TaskQuery("friend", frontier=frontier)
    cache = qcache.TaskResultCache(1 << 20)
    calls = []

    def compute(tq):
        calls.append(1)
        return ttask.process_task(snap, tq, schema)

    first = cache.dispatch(1, q, compute)
    hit = cache.dispatch(1, q, compute)
    assert len(calls) == 1
    assert hit.uid_matrix is first.uid_matrix
    assert isinstance(hit.uid_matrix._flat, torch.Tensor)
    rows, dest, traversed = _want(arrays, frontier, 0)
    want = ([r.tolist() for r in rows], [len(r) for r in rows],
            dest.tolist(), traversed)
    got = [None]
    t = threading.Thread(target=lambda: got.__setitem__(0, _cols_of(hit)))
    t.start()
    t.join(30)
    assert got[0] == want
    assert _cols_of(first) == want
    assert snap.metrics.counter(FETCHED).value == 1


@pytest.mark.parametrize("case", ["device", "host", "first", "has",
                                  "cache", "batched"])
def test_the_card_dest_rides_only_a_fresh_gather(case, monkeypatch):
    """A gathered level's TaskResult carries the card's copy of its dest
    (dest_dev, equal to dest_uids) only where the gather deduplicated it
    (want_dest, no first): its matrix keeps none, the task cache stores
    none and serves a hit with none, and a batched member has none."""
    from dgraph_tpu_torch.query import batch as tbatch
    if case != "host":
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    arrays = _random_csr(43)
    frontier = _frontier(43)
    snap, schema = _snap(arrays), _schema()
    dest = _want(arrays, frontier, 0)[1].tolist()
    q = ttask.TaskQuery("friend", frontier=frontier,
                        first=2 if case == "first" else 0,
                        func=("has", []) if case == "has" else None)
    if case == "cache":
        cache = qcache.TaskResultCache(1 << 20)
        led = cache.dispatch(1, q, lambda tq: ttask.process_task(
            snap, tq, schema))
        hit = cache.dispatch(1, q, lambda tq: pytest.fail("not cached"))
        (stored, _nb), = cache._entries.values()
        assert led.dest_dev.tolist() == led.dest_uids.tolist() == dest
        assert hit.dest_dev is None and stored.dest_dev is None
        assert hit.dest_uids.tolist() == dest
        return
    if case == "batched":
        works = [tbatch.classify(snap, schema, ttask.TaskQuery(
            "friend", frontier=part))[2]
            for part in (frontier[::2], frontier[1::2])]
        entries = [tbatch._Entry(w) for w in works]
        tbatch.DeviceBatcher(metrics=Registry(),
                             idle_fire=False)._run_expand(entries)
        assert all(e.error is None and e.result.dest_dev is None
                   for e in entries)
        return
    res = ttask.process_task(snap, q, schema)
    assert res.uid_matrix.dest_dev is None
    if case == "device":
        assert isinstance(res.dest_dev, torch.Tensor)
        assert res.dest_dev.tolist() == res.dest_uids.tolist() == dest
    else:
        assert res.dest_dev is None


# ---------------------------------------------------------------------------
# the encoder: JSON byte-identical to the JAX Executor
# ---------------------------------------------------------------------------

def _graph(seed=42, n=48):
    rng = np.random.default_rng(seed)
    out = {}
    for attr, m in (("follow", n * 3), ("friend", n * 2)):
        a = rng.integers(1, n + 1, m)
        b = rng.integers(1, n + 1, m)
        pairs = np.unique(np.stack([a, b], axis=1), axis=0)
        out[attr] = pairs
        if attr == "follow":
            out["~follow"] = pairs[:, ::-1]
    return {k: _csr_of(v) for k, v in out.items()}


def _csr_of(pairs):
    pairs = np.unique(pairs, axis=0)
    subjects, counts = np.unique(pairs[:, 0], return_counts=True)
    indptr = np.zeros(len(subjects) + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return subjects.astype(np.int32), indptr, pairs[:, 1].astype(np.int32)


def _kronecker():
    s, p, x = rmat_csr(9, 8, seed=5)
    return {"friend": (np.asarray(s), np.asarray(p), np.asarray(x))}


def _run_both(arrays, q):
    jsnap = jcb.GraphSnapshot(1)
    for attr, (s, p, x) in arrays.items():
        if attr.startswith("~"):
            jsnap.preds[attr[1:]].rev_csr = jcb.PredCSR(s, p, x)
        else:
            jsnap.preds[attr] = jcb.PredData(attr, JTypeID.UID,
                                             csr=jcb.PredCSR(s, p, x))
    tsnap = carry.snapshot_from_numpy(
        {a: (int(JTypeID.UID), s, p, x) for a, (s, p, x) in arrays.items()},
        1, device="cpu")
    tsnap.metrics = Registry()
    js = jschema.SchemaState()
    for e in jschema.parse_schema(SCHEMA):
        js.set(e)
    want = json.dumps(jeng.Executor(jsnap, js).execute(jdql.parse(q)))
    got = json.dumps(teng.Executor(tsnap, _schema()).execute(tdql.parse(q)))
    return want, got, tsnap.metrics.counter(SKIPPED).value


def _seeds(arrays, k):
    s = arrays["friend"][0]
    return ", ".join(hex(int(u)) for u in s[:: max(len(s) // k, 1)][:k])


# (query, graph, blocks encoded without the walk)
BLOCKS = [
    ("{ q(func: uid(0x1, 0x2, 0x3, 0x2f)) { count(uid) } }", _graph, 1),
    ("{ var(func: uid(0x1, 0x2, 0x3)) { c as count(follow) } "
     "q() { n: sum(val(c)) m: max(val(c)) } }", _graph, 1),
    ("{ q(func: uid(0x1, 0x2, 0x3)) { uid count(uid) } }", _graph, 0),
    ("{ q(func: uid(0x1, 0x2, 0x3)) @normalize { uid follow { uid "
     "friend { uid } } } }", _graph, 0),
    ("{ q(func: uid(0x1, 0x2)) @ignorereflex { uid follow { uid "
     "follow { uid } } } }", _graph, 0),
    ("{ var(func: uid(%s)) { A as friend { B as friend { C as friend } } }"
     " q(func: uid(A, B, C)) { count(uid) } }", _kronecker, 1),
]


@pytest.mark.parametrize("path", ["host", "device"])
@pytest.mark.parametrize("bidx", range(len(BLOCKS)))
def test_encoder_json_byte_identical(bidx, path, monkeypatch):
    if path == "device":
        monkeypatch.setattr(jtask, "HOST_EXPAND_MAX", 0)
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    q, graph, skipped = BLOCKS[bidx]
    arrays = graph()
    if "%s" in q:
        q = q % _seeds(arrays, 8)
    want, got, moved = _run_both(arrays, q)
    assert got == want
    assert json.loads(got).get("q")
    assert moved == skipped
