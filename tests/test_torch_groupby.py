"""The port's aggregation slice against the JAX package, on the CPU:
ops/segments (segmented reductions and the rank search) and query/groupby.

segments: the same seeded inputs go to the JAX function and the port's
(on CPU tensors), for every op, empty inputs, zero groups, all-NaN and
zero-length segments. Integer values with |sum| < 2**24 are exact; general
floats hold sum/avg to rtol=1e-6 (the two packages add in other orders)
and min/max/count exactly. rank_in_table runs on both sides of
_RANK_DEVICE_MIN (0 in both packages sends it to the device functions).

groupby: a JAX Node folds the golden dataset (and the shapes of
tests/test_groupby_vector.py); carry brings the snapshot to the port, and
both engines must give byte-identical JSON with VECTORIZE on and off and
with _HOST_AGG_MAX = _RANK_DEVICE_MIN = 0 in both packages, so that the
device functions run (on CPU tensors in the port).
"""

import datetime as dt
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dgraph_tpu.ops import segments as jsegs
from dgraph_tpu.query import engine as jeng
from dgraph_tpu.query import groupby as jgb
from dgraph_tpu.utils.types import TypeID as JTypeID
from dgraph_tpu.utils.types import Val as JVal

from dgraph_tpu_torch.ops import segments as tsegs
from dgraph_tpu_torch.query import engine as teng
from dgraph_tpu_torch.query import groupby as tgb
from dgraph_tpu_torch.utils.types import TypeID, Val

REPO = Path(__file__).resolve().parents[1]
OPS = ("sum", "min", "max", "avg", "count")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _load("golden_battery_gb", REPO / "tests" / "test_golden.py")
VALUES = _load("torch_values_gb", REPO / "tests" / "test_torch_values.py")
EXPECTED = json.loads((REPO / "tests" / "golden" / "expected.json")
                      .read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# ops/segments against the JAX functions
# ---------------------------------------------------------------------------

def _groups(seed, kind, ng=40, max_len=9, nan_frac=0.2):
    """(lens, flat values) with zero-length groups and NaN-coded missing
    members; kind "int" keeps |sum| < 2**24, "float" is general."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len, ng)
    lens[::7] = 0
    n = int(lens.sum())
    if kind == "int":
        vals = rng.integers(-5000, 5000, n).astype(np.float64)
    else:
        vals = rng.normal(size=n) * 100.0
    vals[rng.random(n) < nan_frac] = np.nan
    return lens, vals


def _same(op, got, want, kind):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if kind == "float" and op in ("sum", "avg"):
        np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    else:
        assert np.array_equal(got, want, equal_nan=True), op


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_reduce_matches_jax(seed, op, kind):
    lens, vals = _groups(seed, kind)
    seg_ids = np.repeat(np.arange(len(lens)), lens)
    want = jsegs.group_reduce(op, seg_ids, vals, len(lens))
    got = tsegs.group_reduce(op, seg_ids, vals, len(lens), device="cpu")
    _same(op, got, want, kind)


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("seed", [3, 4])
def test_fused_group_reduce_matches_jax(seed, kind):
    lens, vals = _groups(seed, kind, ng=70, max_len=13)
    want = jsegs.fused_group_reduce(OPS, vals, lens, len(lens))
    got = tsegs.fused_group_reduce(OPS, vals, lens, len(lens), device="cpu")
    assert set(got) == set(want)
    for op in OPS:
        _same(op, got[op], want[op], kind)
    # zero-length groups are empty: NaN, count 0
    empty = lens == 0
    assert np.all(got["count"][empty] == 0)
    assert np.all(np.isnan(got["sum"][empty]))


@pytest.mark.parametrize("op", OPS)
def test_segment_reduce_matches_jax(op):
    import jax.numpy as jnp

    lens, vals = _groups(5, "int")
    seg_ids = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    ns = len(lens) + 3          # trailing segments no id reaches
    want = np.asarray(jsegs.segment_reduce(
        jnp.asarray(vals.astype(np.float32)), jnp.asarray(seg_ids), op=op,
        num_segments=ns))
    got = tsegs.segment_reduce(
        torch.from_numpy(vals.astype(np.float32)),
        torch.from_numpy(seg_ids), op=op, num_segments=ns).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("op", OPS)
def test_empty_inputs_and_all_nan_segments(op):
    # zero groups
    assert np.array_equal(tsegs.group_reduce(op, [], [], 0, device="cpu"),
                          jsegs.group_reduce(op, [], [], 0))
    assert tsegs.fused_group_reduce((op,), [], [], 0, device="cpu")[op] \
        .shape == (0,)
    # groups but no members
    assert np.array_equal(
        tsegs.group_reduce(op, np.zeros(0, np.int64), [], 4, device="cpu"),
        jsegs.group_reduce(op, np.zeros(0, np.int64), [], 4),
        equal_nan=True)
    assert np.array_equal(
        tsegs.fused_group_reduce((op,), [], [0, 0, 0], 3,
                                 device="cpu")[op],
        jsegs.fused_group_reduce((op,), [], [0, 0, 0], 3)[op],
        equal_nan=True)
    # every member missing: NaN everywhere, count 0
    vals = np.full(6, np.nan)
    got = tsegs.fused_group_reduce((op,), vals, [2, 4], 2, device="cpu")[op]
    want = jsegs.fused_group_reduce((op,), vals, [2, 4], 2)[op]
    assert np.array_equal(got, want, equal_nan=True)
    assert (got == 0).all() if op == "count" else np.isnan(got).all()


def test_bad_op_raises():
    for fn in (lambda: tsegs.group_reduce("median", [0], [1.0], 1,
                                          device="cpu"),
               lambda: tsegs.fused_group_reduce(("sum", "median"), [1.0],
                                                [1], 1, device="cpu"),
               lambda: tsegs.segment_reduce(torch.ones(1),
                                            torch.zeros(1, dtype=torch.int64),
                                            op="median", num_segments=1)):
        with pytest.raises(ValueError, match="unknown segment op"):
            fn()
    with pytest.raises(ValueError, match="unknown segment op"):
        jsegs.group_reduce("median", [0], [1.0], 1)


@pytest.mark.parametrize("device_side", [False, True])
@pytest.mark.parametrize("seed", [6, 7])
def test_rank_in_table_matches_jax(seed, device_side, monkeypatch):
    rng = np.random.default_rng(seed)
    table = np.unique(rng.integers(0, 5000, 700))
    values = np.concatenate([rng.choice(table, 900),
                             rng.integers(-10, 5100, 300)])
    if device_side:
        monkeypatch.setattr(jsegs, "_RANK_DEVICE_MIN", 0)
        monkeypatch.setattr(tsegs, "_RANK_DEVICE_MIN", 0)
    before = tsegs.RANKS["cpu"]
    pos_j, hit_j = jsegs.rank_in_table(table, values)
    pos_t, hit_t = tsegs.rank_in_table(table, values, device="cpu")
    assert np.array_equal(pos_t, pos_j) and np.array_equal(hit_t, hit_j)
    assert pos_t.dtype == np.int64 and hit_t.dtype == bool
    assert tsegs.RANKS["cpu"] == before + int(device_side)
    # empty table / no lookups
    for tb, vs in ((table[:0], values), (table, values[:0])):
        p, h = tsegs.rank_in_table(tb, vs, device="cpu")
        pj, hj = jsegs.rank_in_table(tb, vs)
        assert np.array_equal(p, pj) and np.array_equal(h, hj)


def test_segments_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsegs.group_reduce("sum", [0], [1.0], 1)
    with pytest.raises(RuntimeError, match="cuda"):
        tsegs.fused_group_reduce(("sum",), [1.0], [1], 1)
    with pytest.raises(RuntimeError, match="cuda"):
        tsegs.rank_in_table(np.arange(3), np.arange(3))


# ---------------------------------------------------------------------------
# _batch_aggregates: routes, the f32 rule, empty groups, datetimes
# ---------------------------------------------------------------------------

class _Counter:
    def __init__(self):
        self.n = {}

    def counter(self, name):
        c = self.n.setdefault(name, SimpleNamespace(v=0))
        return SimpleNamespace(inc=lambda k=1, c=c: setattr(c, "v", c.v + k))


def _fake_ex(vals_by_uid, metrics, device=None):
    snap = SimpleNamespace(metrics=metrics)
    if device is not None:
        snap.device = torch.device(device)
    return SimpleNamespace(vars={"x": SimpleNamespace(vals=vals_by_uid)},
                           snap=snap)


def _agg_child(op):
    return SimpleNamespace(attr=f"__agg_{op}", val_ref="x", alias=None,
                           is_uid_node=False, is_count=False)


def _both_batch(vals, members, op, monkeypatch, host_max):
    """(port rows, JAX rows, port counters, JAX counters)."""
    monkeypatch.setattr(tgb, "_HOST_AGG_MAX", host_max)
    monkeypatch.setattr(jgb, "_HOST_AGG_MAX", host_max)
    tm, jm = _Counter(), _Counter()
    tvals = {u: Val(TypeID(int(t)), v) for u, (t, v) in vals.items()}
    jvals = {u: JVal(JTypeID(int(t)), v) for u, (t, v) in vals.items()}
    tc, jc = _agg_child(op), _agg_child(op)
    got = tgb._batch_aggregates(_fake_ex(tvals, tm, "cpu"), [tc], members)
    want = jgb._batch_aggregates(_fake_ex(jvals, jm), [jc], members)
    return got.get(id(tc)), want.get(id(jc)), tm.n, jm.n


@pytest.mark.parametrize("op", ["sum", "min", "max", "avg"])
def test_batch_aggregates_routes_device_vs_host(op, monkeypatch):
    members = [np.asarray([1, 2], np.int64), np.asarray([3], np.int64),
               np.asarray([4], np.int64)]
    ints = {1: (TypeID.INT, 5), 2: (TypeID.INT, 7), 3: (TypeID.INT, 11)}
    # all-int and far below 2**24: the device route (uid 4 has no value:
    # its group is empty and its row omitted)
    got, want, tm, jm = _both_batch(ints, members, op, monkeypatch, 0)
    assert got == want and got[2] == {}
    assert tm["dgraph_agg_device_reduces_total"].v == 1
    assert jm["dgraph_agg_device_reduces_total"].v == 1
    # members past the crossover take the host route
    got, want, tm, _ = _both_batch(ints, members, op, monkeypatch, 1 << 17)
    assert got == want
    assert "dgraph_agg_device_reduces_total" not in tm
    assert tm["dgraph_agg_host_reduces_total"].v == 1
    # floats never take the device route
    flts = {1: (TypeID.FLOAT, 0.1), 2: (TypeID.FLOAT, 0.2),
            3: (TypeID.FLOAT, 1e-9)}
    got, want, tm, _ = _both_batch(flts, members, op, monkeypatch, 0)
    assert got == want
    assert "dgraph_agg_device_reduces_total" not in tm


@pytest.mark.parametrize("base,route", [((1 << 24) - 2, "device"),
                                        (1 << 24, "host")])
def test_f32_crossover_pin(base, route, monkeypatch):
    """|sum| >= 2**24 is exactly where f32 accumulation starts dropping
    units: the device route stops there (the cases of
    tests/test_agg_differential.py::test_f32_crossover_pin)."""
    vals = {1: (TypeID.INT, base), 2: (TypeID.INT, 1)}
    members = [np.asarray([1, 2], np.int64)]
    got, want, tm, _ = _both_batch(vals, members, "sum", monkeypatch, 0)
    assert got == want == [{"sum(val(x))": base + 1}]
    assert f"dgraph_agg_{route}_reduces_total" in tm
    lens, flat = [2], np.asarray([float(base), 1.0])
    if route == "device":
        assert tsegs.fused_group_reduce(("sum",), flat, lens, 1,
                                        device="cpu")["sum"][0] == base + 1


def test_datetime_min_max_stays_on_reference_path(monkeypatch):
    """min/max over datetimes must return the original Val: the batched
    route skips them and the per-group aggregator answers."""
    stamps = [dt.datetime(2020 + i, 3, 1 + 2 * i, tzinfo=dt.timezone.utc)
              for i in (3, 0, 5, 1)]
    vals = {i + 1: (TypeID.DATETIME, s) for i, s in enumerate(stamps)}
    members = [np.asarray([1, 2, 3, 4], np.int64)]
    for op in ("min", "max"):
        got, want, tm, _ = _both_batch(vals, members, op, monkeypatch, 0)
        assert got is None and want is None
        assert not tm


def _fused_for(rows, members, aggs=None):
    """A hand-built whole-plan terminal that agrees with the host groups:
    the key table, per-rank member counts and per-rank agg candidates."""
    keys = np.asarray([int(next(iter(r.values())), 16) for r in rows])
    table = np.unique(np.concatenate([keys, keys + 1000]))
    counts = np.zeros(len(table), np.int64)
    counts[np.searchsorted(table, keys)] = [len(m) for m in members]
    return {"table": table, "counts": counts, "aggs": aggs or {}}


@pytest.mark.parametrize("corrupt", [None, "keys", "counts", "aggs"])
def test_fused_terminal_cross_checks(corrupt, monkeypatch):
    """_fused_check_counts and _check_fused_agg: a fused terminal that
    agrees passes in both packages; one that diverges raises QueryError
    in both."""
    rows = [{"k": "0x5"}, {"k": "0x9"}]
    members = [np.asarray([1, 2], np.int64), np.asarray([3], np.int64)]
    out = {}
    for gb, eng, V, T in ((tgb, teng, Val, TypeID),
                          (jgb, jeng, JVal, JTypeID)):
        monkeypatch.setattr(gb, "_HOST_AGG_MAX", 0)
        child = _agg_child("sum")
        vals = {1: V(T.INT, 5), 2: V(T.INT, 7), 3: V(T.INT, 11)}
        ex = _fake_ex(vals, _Counter(), "cpu" if gb is tgb else None)
        ex.schema = None
        gq = SimpleNamespace(children=[child])
        fused = _fused_for(rows, members)
        ranks = np.searchsorted(fused["table"], [5, 9])
        cand = np.zeros(len(fused["table"]))
        cand[ranks] = [12.0, 11.0]
        fused["aggs"] = {id(child): {"cand": cand,
                                     "cntv": fused["counts"].astype(float)}}
        if corrupt == "keys":
            fused["table"] = fused["table"] + 1
        elif corrupt == "counts":
            fused["counts"] = fused["counts"] + 1
        elif corrupt == "aggs":
            fused["aggs"][id(child)]["cand"] = cand + 1
        seeds = [dict(r) for r in rows]
        if corrupt is None:
            out[gb] = gb._assemble_rows(ex, gq, seeds, members, fused)
        else:
            with pytest.raises(eng.QueryError, match="diverged"):
                gb._assemble_rows(ex, gq, seeds, members, fused)
    if corrupt is None:
        assert out[tgb] == out[jgb] == [{"k": "0x5", "sum(val(x))": 12},
                                        {"k": "0x9", "sum(val(x))": 11}]


# ---------------------------------------------------------------------------
# @groupby through both engines
# ---------------------------------------------------------------------------

def _state(schema_text, nquads):
    return VALUES._node(schema_text, nquads)


def _vector_dataset():
    """The dataset of tests/test_groupby_vector.py's node fixture."""
    rng = np.random.default_rng(42)
    quads = []
    genres, cities = ["a", "b", "c"], ["x", "y"]
    for i in range(1, 61):
        quads.append(f'<0x{i:x}> <name> "p{i}" .')
        if i % 7:
            quads.append(f'<0x{i:x}> <genre> "{genres[i % 3]}" .')
        quads.append(f'<0x{i:x}> <city> "{cities[i % 2]}" .')
        quads.append(f'<0x{i:x}> <age> "{20 + i % 5}"^^<xs:int> .')
        for _ in range(2):
            t = int(rng.integers(1, 61))
            quads.append(f"<0x{i:x}> <likes> <0x{t:x}> .")
        quads.append(f'<0x{i:x}> <tags> "t{i % 4}" .')
        if i % 5 == 0:
            quads.append(f'<0x{i:x}> <motto> "m{i % 3}"@en .')
    return "\n".join(quads)


VECTOR_SCHEMA = ("name: string .\ngenre: string @index(exact) .\n"
                 "age: int @index(int) .\ncity: string .\n"
                 "likes: [uid] .\ntags: [string] .\nmotto: string @lang .")

VECTOR_QUERIES = [
    ("string_key", '{ q(func: has(name)) @groupby(genre) { count(uid) } }'),
    ("string_x_string",
     '{ q(func: has(name)) @groupby(genre, city) { count(uid) } }'),
    ("string_x_int",
     '{ q(func: has(name)) @groupby(city, age) { count(uid) } }'),
    ("uid_key", '{ q(func: has(name)) @groupby(likes) { count(uid) } }'),
    ("value_x_uid",
     '{ q(func: has(name)) @groupby(genre, likes) { count(uid) } }'),
    ("aggregates", '{ q(func: has(name)) @groupby(genre, city) { count(uid) '
                   '  m: max(val(ag)) s: sum(val(ag)) } '
                   '  var(func: has(name)) { ag as age } }'),
    ("uid_key_aggs", '{ var(func: has(name)) { ag as age } '
                     '  q(func: has(name)) @groupby(likes) { count(uid) '
                     '  lo: min(val(ag)) hi: max(val(ag)) s: sum(val(ag)) '
                     '  mean: avg(val(ag)) } }'),
    ("int_key_aggs", '{ var(func: has(name)) { ag as age } '
                     '  q(func: has(name)) @groupby(age) { count(uid) '
                     '  s: sum(val(ag)) mean: avg(val(ag)) } }'),
    ("aliased", '{ q(func: has(name)) @groupby(g: genre) { count(uid) } }'),
    ("list_key", '{ q(func: has(name)) @groupby(tags) { count(uid) } }'),
    ("lang_key", '{ q(func: has(name)) @groupby(motto@en) { count(uid) } }'),
    ("empty_groupby", '{ q(func: has(name)) @groupby() { count(uid) } }'),
    ("child_level", '{ q(func: uid(0x1, 0x2, 0x3)) { name '
                    'likes @groupby(city) { count(uid) } } }'),
    ("groupby_var", '{ var(func: has(name)) @groupby(city) { c as count(uid) }'
                    '  q(func: uid(c)) { name } }'),
    ("no_members", '{ q(func: eq(genre, "zzz")) @groupby(city) '
                   '{ count(uid) } }'),
]


@pytest.fixture(scope="module")
def vector_state():
    return _state(VECTOR_SCHEMA, _vector_dataset())


@pytest.fixture(scope="module")
def golden_state():
    return _state(GOLDEN.SCHEMA, GOLDEN._dataset())


@pytest.fixture(params=["plain", "dict_path", "device_fns"])
def gb_mode(request, monkeypatch):
    if request.param == "dict_path":
        monkeypatch.setattr(jgb, "VECTORIZE", False)
        monkeypatch.setattr(tgb, "VECTORIZE", False)
    elif request.param == "device_fns":
        for mod in (jgb, tgb):
            monkeypatch.setattr(mod, "_HOST_AGG_MAX", 0)
        for mod in (jsegs, tsegs):
            monkeypatch.setattr(mod, "_RANK_DEVICE_MIN", 0)
    return request.param


@pytest.mark.parametrize("name,q", VECTOR_QUERIES,
                         ids=[n for n, _ in VECTOR_QUERIES])
def test_groupby_byte_identical(vector_state, gb_mode, name, q):
    before = dict(tsegs.REDUCES), dict(tsegs.RANKS)
    want, got = VALUES._run(vector_state, q)
    assert got == want
    if gb_mode == "device_fns" and name in ("uid_key_aggs", "aggregates",
                                            "int_key_aggs"):
        assert tsegs.REDUCES["cpu"] > before[0]["cpu"]
    if gb_mode == "device_fns" and name == "uid_key_aggs":
        assert tsegs.RANKS["cpu"] > before[1]["cpu"]


def test_golden_groupby_equals_expected(golden_state, gb_mode):
    q = dict(GOLDEN.QUERIES)["groupby"]
    want, got = VALUES._run(golden_state, q)
    assert got == want
    assert json.loads(got) == EXPECTED["groupby"]


def test_groupby_rank_space_codes_cache_per_csr(vector_state):
    """The uid-key table is built once per CSR and cached on it."""
    _, _, tsnap, ts = vector_state
    pd = tsnap.pred("likes")
    tbl = tgb._uid_key_table(pd)
    assert tgb._uid_key_table(pd) is tbl
    _, _, idx = pd.csr.host_arrays()
    assert np.array_equal(tbl[0], np.unique(idx.astype(np.int64)))
    assert tbl[1] == [hex(int(t)) for t in tbl[0]]
