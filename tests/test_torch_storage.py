"""The port's posting store and write path against the JAX package, on the
CPU: the packed codec and its native binding, the N-Quad parser, the MVCC
Store under a seeded write program (apply_mutations + commit/abort), the
fold of that store into snapshots, the durable formats (WAL and checkpoint)
across packages, and the golden battery loaded through the port's own
rdf → mutation → Store → SnapshotAssembler.

Both packages see the same inputs, made from seeds with numpy, and every
result is held exactly: equal bytes, np.array_equal, byte-identical JSON.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from dgraph_tpu.query import dql as jdql
from dgraph_tpu.query import engine as jeng
from dgraph_tpu.query import mutation as jmut
from dgraph_tpu.query import rdf as jrdf
from dgraph_tpu.query import task as jtask
from dgraph_tpu.storage import csr_build as jcb
from dgraph_tpu.storage import index as jindex
from dgraph_tpu.storage import native as jnative
from dgraph_tpu.storage import packed as jpacked
from dgraph_tpu.storage import store as jstore
from dgraph_tpu.storage.postings import Op as JOp
from dgraph_tpu.utils import schema as jschema
from dgraph_tpu.utils import types as jtypes

from dgraph_tpu_torch.ops import csr as tcsr
from dgraph_tpu_torch.query import dql as tdql
from dgraph_tpu_torch.query import engine as teng
from dgraph_tpu_torch.query import mutation as tmut
from dgraph_tpu_torch.query import rdf as trdf
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.storage import csr_build as tcb
from dgraph_tpu_torch.storage import index as tindex
from dgraph_tpu_torch.storage import keys as tkeys
from dgraph_tpu_torch.storage import native as tnative
from dgraph_tpu_torch.storage import packed as tpacked
from dgraph_tpu_torch.storage import store as tstore
from dgraph_tpu_torch.storage.postings import Op as TOp
from dgraph_tpu_torch.utils import schema as tschema
from dgraph_tpu_torch.utils import types as ttypes

REPO = Path(__file__).resolve().parents[1]
MAX_DEVICE_UID = 2**31 - 2


def _golden_module():
    """SCHEMA, _dataset() and QUERIES of tests/test_golden.py, loaded by
    path (that file stays as it is)."""
    spec = importlib.util.spec_from_file_location(
        "golden_battery_storage", REPO / "tests" / "test_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _golden_module()
EXPECTED = json.loads((REPO / "tests" / "golden" / "expected.json")
                      .read_text())
BATTERY = [(n, q) for n, q in GOLDEN.QUERIES if n != "groupby"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# normalized views: one structure for either package's objects
# ---------------------------------------------------------------------------

def nval(v, marshal):
    """(type id, marshalled bytes) of a Val: equal across packages iff the
    stored bytes are."""
    return None if v is None else (int(v.tid), marshal(v))


def pd_state(pd, marshal) -> dict:
    """Every field of a PredData both packages have, normalized: CSR and
    reverse host arrays, value tables, value dicts, facets, token indexes.
    A missing CSR reads as an empty one (a stamped overlay that emptied its
    tablet holds zero rows where a fold holds None)."""
    def arrs(csr):
        if csr is None:
            return ([], [0], [])
        return tuple(np.asarray(a, np.int64).tolist()
                     for a in csr.host_arrays())

    def vals(d):
        return {int(u): nval(v, marshal) for u, v in d.items()}

    vs = pd.value_subjects_host
    nv = pd.num_values_host
    return {
        "attr": pd.attr, "type_id": int(pd.type_id),
        "csr": arrs(pd.csr), "rev_csr": arrs(pd.rev_csr),
        "value_subjects": [] if vs is None else np.asarray(vs).tolist(),
        "num_values": b"" if nv is None
        else np.asarray(nv, np.float64).tobytes(),
        "host_values": vals(pd.host_values),
        "list_values": {int(u): [nval(x, marshal) for x in xs]
                        for u, xs in pd.list_values.items()},
        "lang_values": {int(u): {lg: nval(v, marshal)
                                 for lg, v in d.items()}
                        for u, d in pd.lang_values.items()},
        "facets": {(int(s), int(o)): tuple((n, nval(v, marshal))
                                           for n, v in fs)
                   for (s, o), fs in pd.facets.items()},
        "indexes": {name: (list(ti.terms),
                           *(np.asarray(a, np.int64).tolist()
                             for a in ti.host_arrays()))
                    for name, ti in pd.indexes.items()},
    }


def j_state(pd):
    return pd_state(pd, jtypes.marshal)


def t_state(pd):
    return pd_state(pd, ttypes.marshal)


def assert_snap_equal(jsnap, tsnap):
    assert sorted(jsnap.preds) == sorted(tsnap.preds)
    for attr in sorted(jsnap.preds):
        assert t_state(tsnap.pred(attr)) == j_state(jsnap.pred(attr)), attr


# ---------------------------------------------------------------------------
# one write program through both packages
# ---------------------------------------------------------------------------

class Pair:
    """A JAX Store and a port Store fed the same schema and transactions,
    with timestamps passed explicitly (start_ts, commit_ts)."""

    def __init__(self, schema_text: str, jdir=None, tdir=None) -> None:
        self.j = jstore.Store(jdir)
        self.t = tstore.Store(tdir)
        for e in jschema.parse_schema(schema_text):
            self.j.set_schema(e)
        for e in tschema.parse_schema(schema_text):
            self.t.set_schema(e)
        self.ts = 1

    def txn(self, set_nquads: str = "", del_nquads: str = "",
            abort: bool = False) -> int:
        """Apply one transaction to both stores; returns its commit ts (or
        the start ts of an aborted one)."""
        start = self.ts + 1
        commit = self.ts + 2
        self.ts = commit
        for rdf, mut, store, op in ((jrdf, jmut, self.j, JOp),
                                    (trdf, tmut, self.t, TOp)):
            s_nq, d_nq = rdf.parse(set_nquads), rdf.parse(del_nquads)
            edges = mut.to_edges(s_nq, {}, op.SET) + \
                mut.to_edges(d_nq, {}, op.DEL)
            touched, _, _ = mut.apply_mutations(store, edges, start)
            if abort:
                store.abort(start, touched)
            else:
                store.commit(start, commit, touched)
        return start if abort else commit


STORE_SCHEMA = """
friend: [uid] @reverse @count .
boss: uid @reverse .
name: string @index(exact, term) @lang .
age: int @index(int) .
score: float @index(float) .
alive: bool @index(bool) .
born: dateTime @index(year) .
loc: geo @index(geo) .
pw: password .
tags: [int] @index(int) .
note: default .
"""

# a fixed salted hash: a password typed as pwd:hashed is stored as given,
# so both packages store the same bytes
PW_HASH = ("pbkdf2$00112233445566778899aabbccddeeff$"
           + "ab" * 32)


def _store_program(seed: int = 17, n: int = 40, txns: int = 10):
    """A seeded write program: (set, del, abort) per transaction, covering
    uid edges with @reverse and @count, every scalar type, [int], @lang,
    geo, password, facets on uid and value edges, S P * and S * * deletes
    and an aborted transaction."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "omega"]
    prog = []
    for t in range(txns):
        sets, dels = [], []
        for _ in range(8):
            s, o = (int(x) for x in rng.integers(1, n + 1, 2))
            facet = f" (since={int(rng.integers(2000, 2024))}, " \
                    f"w={float(rng.integers(1, 9)) / 4})" \
                if rng.random() < 0.4 else ""
            sets.append(f"<0x{s:x}> <friend> <0x{o:x}>{facet} .")
        for _ in range(4):
            s = int(rng.integers(1, n + 1))
            w = " ".join(rng.choice(words, 2))
            sets.append(f'<0x{s:x}> <name> "{w}" (src="t{t}") .')
            sets.append(f'<0x{s:x}> <name> "{w} fr"@fr .')
            sets.append(f'<0x{s:x}> <age> "{int(rng.integers(1, 90))}"'
                        f'^^<xs:int> .')
            sets.append(f'<0x{s:x}> <score> "{rng.integers(0, 400) / 8}"'
                        f'^^<xs:float> .')
            sets.append(f'<0x{s:x}> <alive> "{str(bool(rng.random() < .5)).lower()}"'
                        f'^^<xs:boolean> .')
            sets.append(f'<0x{s:x}> <born> "19{int(rng.integers(50, 99))}'
                        f'-0{int(rng.integers(1, 9))}-1{int(rng.integers(0, 9))}'
                        f'T10:00:00Z"^^<xs:dateTime> .')
            lat, lng = rng.integers(-80, 80) / 2, rng.integers(-170, 170) / 2
            sets.append(f'<0x{s:x}> <loc> "{{\\"type\\":\\"Point\\",'
                        f'\\"coordinates\\":[{lng},{lat}]}}"'
                        f'^^<geo:geojson> .')
            sets.append(f'<0x{s:x}> <tags> "{int(rng.integers(0, 6))}"'
                        f'^^<xs:int> .')
            sets.append(f'<0x{s:x}> <note> "n{t}" .')
            sets.append(f'<0x{s:x}> <boss> <0x{int(rng.integers(1, n + 1)):x}> .')
        if t % 3 == 1:
            sets.append(f'<0x{t + 1:x}> <pw> "{PW_HASH}"^^<pwd:hashed> .')
        if t >= 2:
            s, o = (int(x) for x in rng.integers(1, n + 1, 2))
            dels.append(f"<0x{s:x}> <friend> <0x{o:x}> .")
            dels.append(f"<0x{int(rng.integers(1, n + 1)):x}> <friend> * .")
            dels.append(f"<0x{int(rng.integers(1, n + 1)):x}> <name> * .")
            dels.append(f"<0x{int(rng.integers(1, n + 1)):x}> <tags> "
                        f'"{int(rng.integers(0, 6))}"^^<xs:int> .')
        if t == 6:
            dels.append(f"<0x{int(rng.integers(1, n + 1)):x}> * * .")
        prog.append(("\n".join(sets), "\n".join(dels), t == 4))
    return prog


@pytest.fixture(scope="module")
def program_pair():
    pair = Pair(STORE_SCHEMA)
    stamps = []
    for s, d, abort in _store_program():
        ts = pair.txn(s, d, abort=abort)
        if not abort:
            stamps.append(ts)
    return pair, stamps


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

def _codec_rows():
    rng = np.random.default_rng(21)
    rows = [np.zeros(0, np.uint64), np.asarray([5], np.uint64),
            np.asarray([1, 1 + 2**33, 2**40, 2**40 + 1], np.uint64),
            np.arange(MAX_DEVICE_UID - 300, MAX_DEVICE_UID + 1,
                      dtype=np.uint64)]
    for n in (1, 127, 128, 129, 1000, 4096):
        gaps = rng.integers(1, rng.choice([2, 300, 1 << 20, 1 << 34]), n)
        rows.append(np.cumsum(gaps).astype(np.uint64))
    return rows


def _packed_bytes(p):
    return (int(p.count), p.block_first.tobytes(), p.block_last.tobytes(),
            p.block_count.tobytes(), p.block_width.tobytes(),
            p.block_off.tobytes(), p.words.tobytes())


@pytest.mark.parametrize("i", range(len(_codec_rows())))
def test_codec_pack_unpack_equals_jax(i):
    row = _codec_rows()[i]
    want = jpacked.pack(row)
    for got in (tpacked.pack(row), tnative.pack(row)):
        assert _packed_bytes(got) == _packed_bytes(want)
    for dec in (tpacked.unpack, tnative.unpack):
        assert np.array_equal(dec(want), jpacked.unpack(want))
        assert np.array_equal(dec(want), row)


def test_codec_many_equals_jax_and_native_is_built():
    assert tnative.available()
    lib = tnative.library_path()
    assert lib.parent == REPO / "build" / "dgraph_tpu_torch"
    assert lib.exists()
    assert lib.resolve() != Path(jnative._SO).resolve()
    rows = _codec_rows()
    want = jpacked.pack_many(rows)
    for got in (tpacked.pack_many(rows), tnative.pack_many(rows)):
        assert [_packed_bytes(p) for p in got] == \
            [_packed_bytes(p) for p in want]
    for dec in (tpacked.unpack_many, tnative.unpack_many):
        for a, b in zip(dec(want), jpacked.unpack_many(want)):
            assert np.array_equal(a, b)
    flat, counts = tnative.unpack_many_flat(want)
    assert np.array_equal(flat, np.concatenate(rows))
    assert counts.tolist() == [len(r) for r in rows]


# ---------------------------------------------------------------------------
# RDF
# ---------------------------------------------------------------------------

RDF_CORPUS = r"""
<0x1> <name> "Alice" .
<0x1> <name> "Alicia"@es .
<0x1> <name> "Alice \"the\" first\n"@en .
_:b1 <friend> <0x2> (since=2019, close=true, w=0.5, note="a \"q\"") .
_:b1 <friend> _:b2 .
<0x2> <age> "42"^^<xs:int> .
<0x2> <score> "4.25"^^<xs:float> .
<0x2> <alive> "true"^^<xs:boolean> .
<0x2> <born> "1990-05-17T10:00:00Z"^^<xs:dateTime> .
<0x2> <born> "2001-02-03"^^<http://www.w3.org/2001/XMLSchema#date> .
<0x2> <loc> "{\"type\":\"Point\",\"coordinates\":[1.5,2.5]}"^^<geo:geojson> .
<0x2> <pw> "pbkdf2$00$11"^^<pwd:hashed> .
<0x2> <friend> * .
<0x3> * * .
<0x3> <note> "x" <graph> .
<0x4> <name> "tab\tand # not a comment" . # trailing comment
# a comment line
"""

RDF_BAD = [
    "<0x1> <name> .",
    "<0x1> * <0x2> .",
    '<0x1> <name> "unterminated .',
    '<0x1> <age> "5"^^<xs:nosuchtype> .',
    "<0x1> <friend> <0x2>",
    '<0x1> <age> "five"^^<xs:int> .',
    "just words",
]


def _nq_state(nqs, marshal):
    return [(q.subject, q.predicate, q.object_id,
             nval(q.object_value, marshal), q.lang,
             [(n, nval(v, marshal)) for n, v in q.facets], q.star,
             q.subject_var, q.object_var, q.val_var) for q in nqs]


@pytest.mark.parametrize("corpus", ["golden", "features"])
def test_rdf_parse_equals_jax(corpus):
    text = GOLDEN._dataset() if corpus == "golden" else RDF_CORPUS
    want = _nq_state(jrdf.parse(text), jtypes.marshal)
    got = _nq_state(trdf.parse(text), ttypes.marshal)
    assert got == want
    assert len(got) > 10


@pytest.mark.parametrize("line", RDF_BAD)
def test_rdf_malformed_line_raises_in_both(line):
    with pytest.raises(ValueError) as jerr:
        jrdf.parse(line)
    with pytest.raises(ValueError) as terr:
        trdf.parse(line)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# store parity: the seeded write program, folded at several read_ts
# ---------------------------------------------------------------------------

def test_write_program_touches_every_shape(program_pair):
    pair, stamps = program_pair
    assert len(stamps) == 9                      # one of ten aborted
    assert set(pair.t.predicates()) == {
        "friend", "boss", "name", "age", "score", "alive", "born", "loc",
        "pw", "tags", "note"}
    assert pair.t.pred_commit_ts == pair.j.pred_commit_ts
    assert pair.t.max_seen_commit_ts == pair.j.max_seen_commit_ts
    assert sorted(pair.t.lists) == sorted(pair.j.lists)


@pytest.mark.parametrize("k", [0, 3, 6, 8])
def test_build_snapshot_equals_jax_at_read_ts(program_pair, k):
    pair, stamps = program_pair
    ts = stamps[k]
    jsnap = jcb.build_snapshot(pair.j, ts)
    tsnap = tcb.build_snapshot(pair.t, ts, device="cpu")
    assert tsnap.device.type == "cpu"
    assert_snap_equal(jsnap, tsnap)
    for pd in tsnap.preds.values():
        for csr in (pd.csr, pd.rev_csr):
            if csr is not None:
                assert csr.device.type == "cpu" and csr._dev is None


def test_aborted_write_is_invisible(program_pair):
    pair, stamps = program_pair
    pl = [p for kb, p in pair.t.lists.items() if p.uncommitted]
    assert pl == []                 # aborted layers are gone, not parked
    ts = stamps[-1]
    snap = tcb.build_snapshot(pair.t, ts, device="cpu", fold_workers=1)
    ref = pair.j
    assert_snap_equal(jcb.build_snapshot(ref, ts, fold_workers=1), snap)


def test_build_pred_equals_build_value_pred(program_pair):
    """build_value_pred's row fold and the store fold give the same
    PredData over the same value rows."""
    pair, stamps = program_pair
    ts = stamps[-1]
    checked = 0
    for attr in ("name", "age", "score", "alive", "born", "loc", "pw",
                 "tags", "note"):
        if pair.t.schema.get(attr).type_id == ttypes.TypeID.UID:
            continue        # `note: default .` became uid under S * *
        checked += 1
        pd = tcb.build_pred(pair.t, attr, ts, device="cpu")
        rows = []
        from dgraph_tpu_torch.storage import keys as K

        for kb in pair.t.keys_of(K.KeyKind.DATA, attr):
            live = pair.t.lists[kb].live_map(ts)
            for p in live.values():
                if p.value is not None:
                    rows.append((K.uid_of(kb), p.value, p.lang, p.facets))
        entry = pair.t.schema.get(attr)
        vp = tcb.build_value_pred(attr, entry, rows, device="cpu")
        assert t_state(vp) == t_state(pd), attr
    assert checked >= 8


def test_build_entry_points_default_to_cuda(program_pair):
    pair, stamps = program_pair
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default is legal")
    for call in (lambda: tcb.build_pred(pair.t, "friend", stamps[-1]),
                 lambda: tcb.build_snapshot(pair.t, stamps[-1]),
                 lambda: tcb.SnapshotAssembler(pair.t)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_read_below_rollup_watermark_raises():
    pair = Pair("friend: [uid] .")
    ts = pair.txn("<0x1> <friend> <0x2> .")
    ts2 = pair.txn("<0x1> <friend> <0x3> .")
    pair.t.checkpoint(ts2)
    pair.j.checkpoint(ts2)
    for build, store, kw in ((jcb.build_pred, pair.j, {}),
                             (tcb.build_pred, pair.t, {"device": "cpu"})):
        with pytest.raises(ValueError, match="rollup watermark"):
            build(store, "friend", ts, **kw)


# (schema before, schema after, its token indexes, @reverse, @count)
REINDEX = [
    ("name: string .", "name: string @index(exact, term) .",
     ["exact", "term"], False, False),
    ("friend: [uid] .", "friend: [uid] @reverse @count .", [], True, True),
    ("age: int @index(int) .", "age: int @index(int) @count .", ["int"],
     False, True),
    ("age: int @index(int) .", "age: int .", [], False, False),
]


@pytest.mark.parametrize("old,new,indexes,reverse,count", REINDEX)
def test_schema_change_reindex_equals_jax(old, new, indexes, reverse,
                                          count):
    """needs_reindex and the rebuild_index/reverse/count that follow a
    schema change (the Node's alter), in both packages over the same data:
    equal decisions and byte-identical folds afterwards."""
    pair = Pair(old)
    pair.txn("\n".join(
        f'<0x{i:x}> <name> "w{i % 3} v{i % 5}" .\n'
        f'<0x{i:x}> <age> "{i % 7}"^^<xs:int> .\n'
        f"<0x{i:x}> <friend> <0x{i % 9 + 1:x}> .\n"
        f"<0x{i:x}> <friend> <0x{i % 4 + 2:x}> ." for i in range(1, 30)))
    pair.txn(del_nquads="<0x3> <friend> * .\n<0x4> <age> * .")
    read_ts, commit_ts = pair.ts, pair.ts + 1
    decisions = []
    for store, sch, idx in ((pair.j, jschema, jindex),
                            (pair.t, tschema, tindex)):
        for e in sch.parse_schema(new):
            was = store.schema.get(e.predicate)
            store.set_schema(e)
            decisions.append(idx.needs_reindex(was, e))
            if decisions[-1]:
                for rebuild in (idx.rebuild_index, idx.rebuild_reverse,
                                idx.rebuild_count):
                    rebuild(store, e.predicate, read_ts, commit_ts)
    assert decisions == [True, True]
    jsnap = jcb.build_snapshot(pair.j, commit_ts)
    tsnap = tcb.build_snapshot(pair.t, commit_ts, device="cpu")
    assert_snap_equal(jsnap, tsnap)
    attr = new.split(":")[0]
    pd = tsnap.pred(attr)
    assert sorted(pd.indexes) == indexes
    assert all(ti.terms for ti in pd.indexes.values())
    assert (pd.rev_csr is not None) == reverse
    assert bool(pair.t.keys_of(tkeys.KeyKind.COUNT, attr)) == count
    if reverse:
        q = ('{ q(func: has(friend)) { uid count(friend) ~friend { uid } } '
             'c(func: eq(count(friend), 2)) { uid } }')
        assert json.dumps(teng.Executor(tsnap, pair.t.schema).execute(
            tdql.parse(q))) == json.dumps(jeng.Executor(
                jsnap, pair.j.schema).execute(jdql.parse(q)))


def test_vector_values_raise_naming_the_slice():
    s = tstore.Store()
    for e in tschema.parse_schema(
            "emb: float32vector @index(vector(dim: 2, metric: cosine)) ."):
        s.set_schema(e)
    nq = trdf.parse('<0x1> <emb> "[1.0, 2.0]"^^<xs:float32vector> .')
    with pytest.raises(NotImplementedError, match="vector slice"):
        tmut.apply_mutations(s, tmut.to_edges(nq, {}), 1)
    with pytest.raises(NotImplementedError, match="vector slice"):
        tmut.nquads_from_json({"uid": "0x1", "emb": [1.0, 2.0]},
                              schema=s.schema)


def test_json_mutations_equal_jax():
    obj = [{"uid": "0x1", "name": "a", "friend": [{"uid": "0x2"},
                                                   {"name": "b"}],
            "friend|w": 2, "age": 3, "loc": {"type": "Point",
                                             "coordinates": [1.0, 2.0]},
            "name@fr": "un", "born": "2020-01-02T03:04:05Z"}]
    want = _nq_state(jmut.nquads_from_json(obj), jtypes.marshal)
    got = _nq_state(tmut.nquads_from_json(obj), ttypes.marshal)
    assert got == want


class _Uids:
    """The zero uid lease of assign_uids: bump_to + assign."""

    def __init__(self):
        self.next = 1

    def bump_to(self, u):
        self.next = max(self.next, u + 1)

    def assign(self, n):
        s = self.next
        self.next += n
        return s, s + n - 1


def test_assign_uids_equals_jax():
    text = "_:a <friend> _:b .\n_:b <friend> <0x20> .\n_:c <name> \"x\" ."
    want = jmut.assign_uids(jrdf.parse(text), _Uids())
    got = tmut.assign_uids(trdf.parse(text), _Uids())
    assert got == want == {"_:a": 33, "_:b": 34, "_:c": 35}


# ---------------------------------------------------------------------------
# durability: WAL and checkpoint across packages
# ---------------------------------------------------------------------------

def _durable_program(pair):
    prog = _store_program(seed=23, n=24, txns=6)
    stamps = []
    for i, (s, d, abort) in enumerate(prog):
        ts = pair.txn(s, d, abort=abort)
        if not abort:
            stamps.append(ts)
        if i == 2:
            pair.j.checkpoint(ts)
            pair.t.checkpoint(ts)
    # an open transaction: its uncommitted layer survives in the WAL
    for store, rdf, mut in ((pair.j, jrdf, jmut), (pair.t, trdf, tmut)):
        mut.apply_mutations(store, mut.to_edges(
            rdf.parse("<0x3> <friend> <0x4> ."), {}), 99)
    return stamps


@pytest.fixture(scope="module")
def durable_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("durable")
    jdir, tdir = str(root / "jax"), str(root / "port")
    pair = Pair(STORE_SCHEMA, jdir, tdir)
    stamps = _durable_program(pair)
    pair.j.close()
    pair.t.close()
    return jdir, tdir, stamps


def _files(d):
    return {name: Path(d, name).read_bytes()
            for name in ("snapshot.bin", "wal.log")}


def test_wal_and_checkpoint_bytes_identical(durable_dirs):
    jdir, tdir, _ = durable_dirs
    assert _files(tdir) == _files(jdir)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_store_directory_opens_in_the_other_package(durable_dirs, direction,
                                                    tmp_path):
    """A directory one package wrote (checkpoint + WAL tail + an open
    transaction) opens in the other with an equal fold at every commit
    the WAL still holds; a checkpoint written there reopens equal."""
    jdir, tdir, stamps = durable_dirs
    src = jdir if direction == "jax_to_port" else tdir
    j_open = jstore.Store(src if direction == "port_to_jax" else jdir)
    t_open = tstore.Store(src if direction == "jax_to_port" else tdir)
    try:
        assert t_open.max_seen_commit_ts == j_open.max_seen_commit_ts
        for ts in stamps[3:]:
            assert_snap_equal(jcb.build_snapshot(j_open, ts),
                              tcb.build_snapshot(t_open, ts, device="cpu"))
        for store in (j_open, t_open):
            assert any(p.uncommitted for p in store.lists.values())
    finally:
        j_open.close()
        t_open.close()


def test_checkpoint_of_reopened_store_is_byte_identical(durable_dirs,
                                                        tmp_path):
    import shutil

    jdir, tdir, stamps = durable_dirs
    a, b = tmp_path / "a", tmp_path / "b"
    shutil.copytree(jdir, a)
    shutil.copytree(jdir, b)
    js, ts_ = jstore.Store(str(a)), tstore.Store(str(b))
    js.checkpoint(stamps[-1])
    ts_.checkpoint(stamps[-1])
    js.close()
    ts_.close()
    assert _files(b) == _files(a)


# ---------------------------------------------------------------------------
# the golden battery through the port's own write path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_store():
    """The golden dataset through each package's own rdf → mutation →
    Store → SnapshotAssembler: (port schema, port snapshot, JAX schema,
    JAX snapshot)."""
    pair = Pair(GOLDEN.SCHEMA)
    ts = pair.txn(GOLDEN._dataset())
    tsnap = tcb.SnapshotAssembler(pair.t, device="cpu").snapshot(ts)
    jsnap = jcb.SnapshotAssembler(pair.j).snapshot(ts)
    return pair.t.schema, tsnap, pair.j.schema, jsnap


@pytest.mark.parametrize("union_path", ["default", "device"])
@pytest.mark.parametrize("name,q", BATTERY, ids=[n for n, _ in BATTERY])
def test_golden_battery_through_store(golden_store, name, q, union_path,
                                      monkeypatch):
    """Byte for byte: the JAX engine's JSON over its own store, and
    tests/golden/expected.json (written with sorted keys) in that form."""
    ts_, tsnap, js, jsnap = golden_store
    if union_path == "device":
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
        monkeypatch.setattr(jtask, "HOST_EXPAND_MAX", 0)
    before = dict(tcsr.UNIONS)
    got = teng.Executor(tsnap, ts_).execute(tdql.parse(q))
    want = jeng.Executor(jsnap, js).execute(jdql.parse(q))
    assert json.dumps(got) == json.dumps(want)
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(EXPECTED[name], sort_keys=True)
    assert tcsr.UNIONS["cuda"] == before["cuda"]
