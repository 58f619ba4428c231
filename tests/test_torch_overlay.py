"""The port's snapshot assembly against the JAX package, on the CPU: O(Δ)
delta-overlay stamps, lazy folds, the overlay expand (ops/csr.expand_masked),
@recurse and shortest over overlaid predicates on the kernel path, and the
planner statistics.

Both packages hold the same data (R-MAT scale 10 loaded through each one's
Store.bulk_install, then the same seeded commits) and each package's own
SnapshotAssembler folds and stamps it. After every commit the port's
stamped PredData equals a from-scratch build_pred at that ts (the
byte-identity contract of storage/delta.py) and the JAX assembler's stamped
PredData, field by field. Everything is held exactly.
"""

import json
import threading
import types

import numpy as np
import pytest
import torch

import dgraph_tpu.query.recurse as jrec
import dgraph_tpu.query.shortest as jsh
from dgraph_tpu.ops import csr as jcsrops
from dgraph_tpu.query import dql as jdql
from dgraph_tpu.query import engine as jeng
from dgraph_tpu.query import task as jtask
from dgraph_tpu.storage import csr_build as jcb
from dgraph_tpu.storage import delta as jdelta
from dgraph_tpu.storage import index as jindex
from dgraph_tpu.storage import keys as jkeys
from dgraph_tpu.storage import native as jnative
from dgraph_tpu.storage import postings as jpostings
from dgraph_tpu.storage import stats as jstats
from dgraph_tpu.utils import types as jtypes

import dgraph_tpu_torch.query.recurse as trec
import dgraph_tpu_torch.query.shortest as tsh
from dgraph_tpu_torch.models.rmat import rmat_csr
from dgraph_tpu_torch.ops import csr as tcsrops
from dgraph_tpu_torch.ops import prefix as tpx
from dgraph_tpu_torch.query import dql as tdql
from dgraph_tpu_torch.query import engine as teng
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.storage import csr_build as tcb
from dgraph_tpu_torch.storage import delta as tdelta
from dgraph_tpu_torch.storage import index as tindex
from dgraph_tpu_torch.storage import keys as tkeys
from dgraph_tpu_torch.storage import native as tnative
from dgraph_tpu_torch.storage import postings as tpostings
from dgraph_tpu_torch.storage import stats as tstats
from dgraph_tpu_torch.storage.csr_build import transpose_csr
from dgraph_tpu_torch.utils import types as ttypes

from test_torch_storage import Pair, assert_snap_equal, j_state, t_state

JPKG = types.SimpleNamespace(keys=jkeys, postings=jpostings, native=jnative,
                             index=jindex, types=jtypes, cb=jcb)
TPKG = types.SimpleNamespace(keys=tkeys, postings=tpostings, native=tnative,
                             index=tindex, types=ttypes, cb=tcb)

RMAT_SCHEMA = "friend: [uid] @reverse @count .\nage: int @index(int) .\n"
SMALL_SCHEMA = ("name: string @index(exact, term) .\n"
                "age: int @index(int) .\n"
                "follows: [uid] @reverse @count .\n")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# two stores, two assemblers
# ---------------------------------------------------------------------------

def bulk_load(pkg, store, csr, ages, ts=1):
    """friend (with its REVERSE keys) and age (DATA + INDEX keys) packed
    with the package's native.pack_many into posting lists and installed
    with Store.bulk_install at ts, as the bulk loader's reduce does."""
    K, P = pkg.keys, pkg.postings
    subjects, indptr, indices = csr
    rsub, rptr, ridx = transpose_csr(subjects, indptr, indices)
    keys, rows, posts = [], [], {}
    for i, s in enumerate(subjects.tolist()):
        keys.append(K.data_key("friend", s).encode())
        rows.append(indices[indptr[i]:indptr[i + 1]].astype(np.uint64))
    for i, o in enumerate(rsub.tolist()):
        keys.append(K.reverse_key("friend", o).encode())
        rows.append(ridx[rptr[i]:rptr[i + 1]].astype(np.uint64))
    entry = store.schema.get("age")
    tokens: dict[bytes, list[int]] = {}
    for s, a in ages.items():
        v = pkg.types.Val(pkg.types.TypeID.INT, int(a))
        kb = K.data_key("age", s).encode()
        keys.append(kb)
        rows.append(np.asarray([P.VALUE_UID], np.uint64))
        posts[kb] = {P.VALUE_UID: P.Posting(P.VALUE_UID, P.Op.SET, v)}
        for tk in pkg.index.index_tokens(entry, v):
            tokens.setdefault(tk, []).append(s)
    for tk, ss in tokens.items():
        keys.append(K.index_key("age", tk).encode())
        rows.append(np.unique(np.asarray(ss, np.uint64)))
    lists = {}
    for kb, pu in zip(keys, pkg.native.pack_many(rows)):
        pl = P.PostingList()
        pl.base_ts = ts
        pl.base_packed = pu
        pl.base_postings = posts.get(kb, {})
        lists[kb] = pl
    store.bulk_install(lists, ts)


class Twin(Pair):
    """A Pair of stores plus each package's own SnapshotAssembler (the
    port's on the CPU)."""

    def __init__(self, schema_text: str, **asm_kw) -> None:
        super().__init__(schema_text)
        self.jasm = jcb.SnapshotAssembler(self.j, **asm_kw)
        self.tasm = tcb.SnapshotAssembler(self.t, device="cpu", **asm_kw)
        self.js, self.tschema = self.j.schema, self.t.schema

    def snaps(self, ts=None):
        ts = self.ts if ts is None else ts
        return self.jasm.snapshot(ts), self.tasm.snapshot(ts)

    def query(self, q: str, ts=None) -> dict:
        """The request through both engines over their assemblers'
        snapshots: byte-identical JSON, returned parsed."""
        jsnap, tsnap = self.snaps(ts)
        want = json.dumps(jeng.Executor(jsnap, self.js).execute(
            jdql.parse(q)))
        got = json.dumps(teng.Executor(tsnap, self.tschema).execute(
            tdql.parse(q)))
        assert got == want, q
        return json.loads(got)

    def check_fold(self, attrs, ts=None):
        """The port's assembled PredData equals a from-scratch fold at ts
        and the JAX assembler's, field by field."""
        ts = self.ts if ts is None else ts
        jsnap, tsnap = self.snaps(ts)
        for attr in attrs:
            got = t_state(tsnap.pred(attr))
            assert got == t_state(tcb.build_pred(self.t, attr, ts,
                                                 device="cpu")), attr
            assert got == j_state(jsnap.pred(attr)), attr


def small_twin(n=60, follows=3, **asm_kw) -> Twin:
    tw = Twin(SMALL_SCHEMA, **asm_kw)
    quads = []
    for i in range(1, n + 1):
        quads.append(f'<0x{i:x}> <name> "p{i}" .')
        quads.append(f'<0x{i:x}> <age> "{18 + i % 40}"^^<xs:int> .')
        for j in range(follows):
            quads.append(f'<0x{i:x}> <follows> <0x{(i + j) % n + 1:x}> .')
    tw.txn("\n".join(quads))
    return tw


# ---------------------------------------------------------------------------
# stamp parity on R-MAT scale 10 under a seeded commit program
# ---------------------------------------------------------------------------

def _rmat_commits(csr, ages, seed=13, txns=12):
    """(set, del) per transaction: 4 friend edges from a pool of 32
    subjects, 2 existing friend edges of those rows deleted, 2 ages
    moved."""
    subjects, indptr, indices = csr
    rng = np.random.default_rng(seed)
    pool = np.sort(rng.choice(subjects, 32, replace=False))
    rows = {int(s): set(indices[indptr[i]:indptr[i + 1]].tolist())
            for i, s in enumerate(subjects.tolist())}
    uids = sorted(ages)
    out = []
    for _ in range(txns):
        sets, dels = [], []
        for _ in range(4):
            s = int(rng.choice(pool))
            o = int(rng.choice(uids))
            rows[s].add(o)
            sets.append(f"<0x{s:x}> <friend> <0x{o:x}> .")
        for _ in range(2):
            s = int(rng.choice(pool))
            if rows[s]:
                o = int(rng.choice(sorted(rows[s])))
                rows[s].discard(o)
                dels.append(f"<0x{s:x}> <friend> <0x{o:x}> .")
        for _ in range(2):
            s = int(rng.choice(uids))
            sets.append(f'<0x{s:x}> <age> "{int(rng.integers(0, 100))}"'
                        f'^^<xs:int> .')
        out.append(("\n".join(sets), "\n".join(dels)))
    return out


@pytest.fixture(scope="module")
def rmat_twin():
    csr = rmat_csr(10, 16, seed=7)
    n = 1 << 10
    rng = np.random.default_rng(11)
    ages = {u: int(a) for u, a in zip(range(1, n + 1),
                                      rng.integers(0, 100, n))}
    tw = Twin(RMAT_SCHEMA)
    bulk_load(JPKG, tw.j, csr, ages)
    bulk_load(TPKG, tw.t, csr, ages)
    return tw, csr, ages


def test_rmat_store_fold_equals_input_and_jax(rmat_twin):
    tw, csr, ages = rmat_twin
    jsnap, tsnap = tw.snaps(1)
    assert tsnap.preds.pending_attrs() == ["age", "friend"]   # lazy
    fr = tsnap.pred("friend")
    for got, want in zip(fr.csr.host_arrays(), csr):
        assert np.array_equal(got, want)
    for got, want in zip(fr.rev_csr.host_arrays(), transpose_csr(*csr)):
        assert np.array_equal(got, want)
    age = tsnap.pred("age")
    assert age.value_subjects_host.tolist() == sorted(ages)
    assert age.num_values_host.tolist() == [float(ages[u])
                                            for u in sorted(ages)]
    assert_snap_equal(jsnap, tsnap)


@pytest.fixture(scope="module")
def rmat_overlaid(rmat_twin):
    """rmat_twin after the seeded commit program (and one aborted write),
    run once for the module whichever test asks first. Per commit it
    records what test_rmat_commits_stamp_overlays_equal_to_fold_and_jax
    holds: the overlay types, the base's identity, its device tensors' and
    the port's stamped PredData against a from-scratch fold and the JAX
    assembler's."""
    tw, csr, ages = rmat_twin
    _, tsnap = tw.snaps()
    base = tsnap.pred("friend").csr
    base_rev = tsnap.pred("friend").rev_csr
    base_dev = base.device_arrays()
    base_index = tsnap.pred("age").indexes["int"]
    log = []
    for k, (s, d) in enumerate(_rmat_commits(csr, ages)):
        if k == 5:
            tw.txn("<0x1> <friend> <0x2> .\n<0x1> <age> \"999\"^^<xs:int> .",
                   abort=True)
        tw.txn(s, d)
        jsnap, tsnap = tw.snaps()
        fr = tsnap.pred("friend")
        folds = {}
        for attr in ("friend", "age"):
            got = t_state(tsnap.pred(attr))
            folds[attr] = (
                got == t_state(tcb.build_pred(tw.t, attr, tw.ts,
                                              device="cpu")),
                got == j_state(jsnap.pred(attr)))
        log.append({
            "overlays": (isinstance(fr.csr, tdelta.OverlayCSR),
                         isinstance(fr.rev_csr, tdelta.OverlayCSR),
                         isinstance(tsnap.pred("age").indexes["int"],
                                    tdelta.LazyTokenIndex)),
            "base": (fr.csr.base is base, fr.rev_csr.base is base_rev),
            "base_dev": all(a is b for a, b in zip(base.device_arrays(),
                                                   base_dev)),
            "folds": folds})
    return tw, csr, ages, log, base_index


def test_rmat_commits_stamp_overlays_equal_to_fold_and_jax(rmat_overlaid):
    """Every commit of the seeded program stamps overlays (never a fold,
    never a re-upload of the base) equal to a from-scratch fold and to the
    JAX assembler's stamp; an aborted write stays invisible."""
    tw, _, _, log, base_index = rmat_overlaid
    assert len(log) == 12
    for k, rec in enumerate(log):
        assert rec["overlays"] == (True, True, True), k
        assert rec["base"] == (True, True), k
        assert rec["base_dev"], k
        assert rec["folds"] == {"friend": (True, True),
                                "age": (True, True)}, k
    assert tw.snaps()[1].pred("age").host_values.get(1) != ttypes.Val(
        ttypes.TypeID.INT, 999)
    assert base_index._dev is None          # no union asked for it


# ---------------------------------------------------------------------------
# the Node-free shapes of tests/test_delta_overlay.py
# ---------------------------------------------------------------------------

def test_single_quad_commit_keeps_base_identity():
    tw = small_twin()
    tw.query('{ q(func: uid(0x1)) { follows { uid } } }')
    base = tw.snaps()[1].pred("follows").csr
    dev = base.device_arrays()
    tw.txn('<0x1> <follows> <0x30> .')
    out = tw.query('{ q(func: uid(0x1)) { follows { uid } } }')
    assert "0x30" in {x["uid"] for x in out["q"][0]["follows"]}
    csr = tw.snaps()[1].pred("follows").csr
    assert isinstance(csr, tdelta.OverlayCSR)
    assert csr.base is base
    assert csr.base.subjects is dev[0] and csr.base.indices is dev[2]
    tw.check_fold(["follows"])


def test_value_reverse_and_count_overlays():
    tw = small_twin()
    tw.query('{ q(func: has(name)) { name age follows { uid } ~follows '
             '{ uid } } }')
    tw.txn('<0x1> <age> "99"^^<xs:int> .\n<0x2> <name> "zzz" .\n'
           '<0x3> <follows> <0x9> .\n<0x3> <follows> <0xa> .')
    _, tsnap = tw.snaps()
    assert isinstance(tsnap.pred("follows").rev_csr, tdelta.OverlayCSR)
    assert isinstance(tsnap.pred("age").indexes["int"],
                      tdelta.LazyTokenIndex)
    assert tw.query('{ q(func: eq(age, 99)) { uid age } }')["q"] == \
        [{"uid": "0x1", "age": 99}]
    assert tw.query('{ q(func: eq(name, "zzz")) { uid } }')["q"] == \
        [{"uid": "0x2"}]
    for q in ('{ q(func: ge(age, 50), orderasc: age) { uid age } }',
              '{ q(func: has(age), orderdesc: age, first: 5) { uid } }',
              '{ q(func: uid(0x3)) { count(follows) ~follows { uid } } }',
              '{ q(func: uid(0x9, 0xa)) { ~follows { uid } } }',
              '{ q(func: eq(count(follows), 5)) { uid } }',
              '{ q(func: has(~follows)) { count(uid) } }',
              '{ q(func: anyofterms(name, "zzz p7")) { uid name } }'):
        tw.query(q)
    tw.check_fold(["name", "age", "follows"])


def test_del_all_readd_and_emptied_row():
    tw = small_twin()
    tw.query('{ q(func: has(follows)) { follows { uid } } }')
    tw.txn(del_nquads='<0x4> <follows> * .')
    tw.txn('<0x4> <follows> <0x2> .')                  # re-add after DEL_ALL
    tw.txn(del_nquads='<0x5> <follows> * .')           # emptied row
    tw.txn(del_nquads='<0x6> <name> * .')
    _, tsnap = tw.snaps()
    ov = tsnap.pred("follows").csr
    assert isinstance(ov, tdelta.OverlayCSR)
    assert 5 not in ov.subjects_host().tolist()
    out = tw.query('{ q(func: uid(0x4, 0x5)) { follows { uid } } }')
    assert out["q"] == [{"follows": [{"uid": "0x2"}]}]
    tw.query('{ q(func: has(follows)) { count(uid) } }')
    tw.check_fold(["name", "follows"])


def test_overlay_on_edgeless_base_tablet():
    tw = Twin("friend: [uid] .")
    tw.txn('<0x1> <friend> <0x2> .')
    tw.query('{ q(func: uid(0x1)) { friend { uid } } }')
    tw.txn(del_nquads='<0x1> <friend> <0x2> .')
    tw.query('{ q(func: uid(0x1)) { friend { uid } } }')
    lock = threading.Lock()
    assert tw.tasm.compact(lock, force=True) == 1
    tw.jasm.compact(lock, force=True)
    assert tw.snaps()[1].pred("friend").csr is None       # edgeless base
    tw.txn('<0x1> <friend> <0x3> .')
    ov = tw.snaps()[1].pred("friend").csr
    assert isinstance(ov, tdelta.OverlayCSR) and ov.base is None
    assert ov.device.type == "cpu"
    out = tw.query('{ q(func: uid(0x1)) { friend { uid } } }')
    assert out["q"] == [{"friend": [{"uid": "0x3"}]}]
    tw.check_fold(["friend"])


def test_deep_overlay_folds_inline():
    tw = small_twin(overlay_max_keys=2)
    tw.query('{ q(func: uid(0x1)) { follows { uid } } }')
    tw.txn("\n".join(f'<0x{i:x}> <follows> <0x30> .' for i in range(1, 9)))
    out = tw.query('{ q(func: uid(0x3)) { follows { uid } } }')
    assert "0x30" in {x["uid"] for x in out["q"][0]["follows"]}
    assert not isinstance(tw.snaps()[1].pred("follows").csr,
                          tdelta.OverlayCSR)
    tw.check_fold(["follows"])


def test_journal_overflow_falls_back_to_fold():
    tw = small_twin()
    tw.j.MAX_DELTA_KEYS = tw.t.MAX_DELTA_KEYS = 4
    tw.query('{ q(func: uid(0x1)) { follows { uid } } }')
    tw.txn("\n".join(f'<0x{i:x}> <follows> <0x30> .' for i in range(1, 9)))
    assert tw.t.delta_since("follows",
                            tw.t.pred_commit_ts["follows"] - 1) is None
    out = tw.query('{ q(func: uid(0x5)) { follows { uid } } }')
    assert "0x30" in {x["uid"] for x in out["q"][0]["follows"]}
    tw.txn('<0x1> <follows> <0x31> .')       # the fold re-based stamping
    tw.query('{ q(func: uid(0x1)) { follows { uid } } }')
    assert isinstance(tw.snaps()[1].pred("follows").csr, tdelta.OverlayCSR)
    tw.check_fold(["follows"])


def test_replay_race_rebuilds_cached_view():
    """A commit replayed below the predicate's watermark after assembly
    (out-of-order WAL/replication apply) rebuilds the cached view."""
    from dgraph_tpu_torch.storage.postings import Op, Posting
    from dgraph_tpu_torch.storage.store import decode_record, encode_record
    from dgraph_tpu_torch.utils.types import TypeID, Val

    tw = Twin("a: int .")
    tw.txn('<0x1> <a> "1"^^<xs:int> .')
    tw.txn('<0x2> <a> "2"^^<xs:int> .')
    s = tw.t
    snap1 = tw.tasm.snapshot(tw.ts)
    assert snap1.pred("a").host_values == {1: Val(TypeID.INT, 1),
                                           2: Val(TypeID.INT, 2)}
    kb3 = tkeys.data_key("a", 3).encode()
    for rec in ({"t": "m", "s": 3, "k": kb3,
                 "p": Posting(0, Op.SET, Val(TypeID.INT, 33))},
                {"t": "c", "s": 3, "ts": 4, "k": [kb3]}):
        s.apply_record(decode_record(encode_record(rec)))
    assert s.pred_replay_seq.get("a", 0) == 1
    snap2 = tw.tasm.snapshot(tw.ts)
    assert snap2 is not snap1
    assert snap2.pred("a").host_values[3] == Val(TypeID.INT, 33)


def test_parallel_folds_equal_serial():
    tw = small_twin(n=50)
    ser = tcb.build_snapshot(tw.t, tw.ts, fold_workers=1, device="cpu")
    par = tcb.build_snapshot(tw.t, tw.ts, fold_workers=4, device="cpu")
    assert sorted(ser.preds) == sorted(par.preds)
    for attr in ser.preds:
        assert t_state(ser.preds[attr]) == t_state(par.preds[attr])


def test_compaction_empties_overlay_and_results_unchanged():
    tw = small_twin()
    q = '{ q(func: uid(0x1, 0x2)) { follows { uid name } ~follows { uid } } }'
    tw.query(q)
    tw.txn('<0x1> <follows> <0x30> .\n<0x2> <name> "renamed" .')
    before = tw.query(q)
    assert tw.tasm.overlay_stats()
    assert tw.tasm.compact(threading.Lock(), force=True) >= 1
    assert tw.tasm.overlay_stats() == {}
    pd = tw.snaps()[1].pred("follows")
    assert not isinstance(pd.csr, tdelta.OverlayCSR)
    assert tw.query(q) == before
    tw.check_fold(["follows", "name"])


def test_stacked_overlay_and_type_change_raise():
    tw = small_twin()
    tw.query('{ q(func: has(follows)) { follows { uid } age } }')
    tw.txn('<0x1> <follows> <0x30> .')
    _, tsnap = tw.snaps()
    stamped = tsnap.pred("follows")
    kb = tkeys.data_key("follows", 1).encode()
    rkb = tkeys.reverse_key("follows", 0x30).encode()
    for keys in ([kb], [rkb]):           # delta.py data and reverse raises
        with pytest.raises(ValueError, match="stacked overlay"):
            tdelta.stamp_pred(tw.t, "follows", stamped, tw.ts, keys,
                              device="cpu")
    age = tsnap.pred("age")
    tw.t.schema.get("age").type_id = ttypes.TypeID.FLOAT
    try:
        with pytest.raises(ValueError, match="schema type changed"):
            tdelta.stamp_pred(tw.t, "age", age, tw.ts, [], device="cpu")
    finally:
        tw.t.schema.get("age").type_id = ttypes.TypeID.INT


def test_failed_stamp_becomes_a_fold(monkeypatch):
    """The reference behaviour: a stamp that raises is caught and the
    assembler folds in full — right answer, no overlay."""
    tw = small_twin()
    tw.query('{ q(func: uid(0x1)) { follows { uid } } }')

    def boom(*a, **kw):
        raise RuntimeError("stamp failed")

    monkeypatch.setattr(tdelta, "stamp_pred", boom)
    tw.txn('<0x1> <follows> <0x30> .')
    _, tsnap = tw.snaps()
    assert not isinstance(tsnap.pred("follows").csr, tdelta.OverlayCSR)
    tw.check_fold(["follows"])


# ---------------------------------------------------------------------------
# expand_masked and the overlay expand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", ["above", "below"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_expand_masked_equals_jax(seed, cap):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    n = 40
    deg = rng.integers(0, 9, n)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, 500, int(indptr[-1])).astype(np.int32)
    rows = rng.integers(0, n, 25).astype(np.int32)
    rows[rng.random(25) < 0.2] = 2**31 - 1            # missing subjects
    patched = rng.random(25) < 0.3
    total = int(np.where(rows < n, deg[np.minimum(rows, n - 1)], 0)
                [~patched].sum())
    out_cap = total + 7 if cap == "above" else max(total // 2, 1)
    want = jcsrops.expand_masked(jnp.asarray(indptr), jnp.asarray(indices),
                                 jnp.asarray(rows), patched, out_cap)
    before = tcsrops.MASKED["cpu"]
    got = tcsrops.expand_masked(torch.from_numpy(indptr),
                                torch.from_numpy(indices),
                                torch.from_numpy(rows),
                                torch.from_numpy(patched), out_cap)
    assert tcsrops.MASKED["cpu"] == before + 1
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got.total) == total


def test_expand_overlay_device_path_equals_host_path(rmat_overlaid, monkeypatch):
    tw, csr, *_ = rmat_overlaid
    _, tsnap = tw.snaps()
    ov = tsnap.pred("friend").csr
    assert isinstance(ov, tdelta.OverlayCSR)
    uids = np.unique(np.concatenate([ov.delta.subs[:20], csr[0][::7]]))
    host, htotal = ttask._expand_overlay(ov, uids)
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    before = dict(tcsrops.MASKED)
    dev, dtotal = ttask._expand_overlay(ov, uids)
    assert tcsrops.MASKED["cpu"] == before["cpu"] + 1
    assert tcsrops.MASKED["cuda"] == before["cuda"]
    assert htotal == dtotal
    for a, b in zip(host, dev):
        assert np.array_equal(a, b)
    # each row equals the merged CSR's
    s, ip, ix = ov.host_arrays()
    pos = np.searchsorted(s, uids)
    for u, p, row in zip(uids.tolist(), pos.tolist(), host):
        want = ix[ip[p]:ip[p + 1]] if p < len(s) and s[p] == u else []
        assert np.array_equal(row, want)


@pytest.mark.parametrize("path", ["host", "device"])
def test_overlay_expand_request_equals_jax(rmat_overlaid, path, monkeypatch):
    tw, csr, *_ = rmat_overlaid
    if path == "device":
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
        monkeypatch.setattr(jtask, "HOST_EXPAND_MAX", 0)
    seeds = csr[0][::40]
    tw.query("{ q(func: uid(%s)) { friend { uid } } }"
             % ", ".join(hex(int(u)) for u in seeds))


# ---------------------------------------------------------------------------
# recurse and shortest over an overlay, on the kernel path
# ---------------------------------------------------------------------------

def test_recurse_over_overlay_on_kernel_path(rmat_overlaid, monkeypatch):
    tw, csr, *_ = rmat_overlaid
    monkeypatch.setattr(trec, "KERNEL_MIN_EDGES", 0)
    monkeypatch.setattr(jrec, "KERNEL_MIN_EDGES", 0)
    _, tsnap = tw.snaps()
    assert isinstance(tsnap.pred("friend").csr, tdelta.OverlayCSR)
    seeds = np.unique(np.random.default_rng(3).choice(csr[0], 8,
                                                      replace=False))
    tpx.reset_launches()
    out = tw.query("{ q(func: uid(%s)) @recurse(depth: 3) { friend } }"
                   % ", ".join(hex(int(u)) for u in seeds))
    assert out["q"]
    assert tpx.LAUNCHES == {"active_prefix": 0, "active_prefix_sparse": 0}
    tw.query("{ q(func: uid(%s)) @recurse(depth: 2) { ~friend } }"
             % hex(int(seeds[0])))


@pytest.mark.parametrize("tier", ["kernel", "sssp"])
def test_shortest_over_overlay(rmat_overlaid, tier, monkeypatch):
    tw, csr, *_ = rmat_overlaid
    for mod in (jsh, tsh):
        monkeypatch.setattr(mod, "DEVICE_SSSP_MIN_EDGES", 0)
        monkeypatch.setattr(mod, "SSSP_KERNEL_MIN",
                            0 if tier == "kernel" else None)
    _, tsnap = tw.snaps()
    ov = tsnap.pred("friend").csr
    assert isinstance(ov, tdelta.OverlayCSR)
    src = int(ov.delta.subs[0])
    dst = int(csr[0][-1])
    tw.query("{ p as shortest(from: %s, to: %s) { friend } "
             "q(func: uid(p)) { uid } }" % (hex(src), hex(dst)))


# ---------------------------------------------------------------------------
# lazy folds (the Node-free cases of tests/test_lazy_fold.py)
# ---------------------------------------------------------------------------

def test_lazy_key_views_do_not_fold_and_get_folds_one():
    tw = small_twin()
    snap = tw.tasm.snapshot(tw.ts)
    preds = snap.preds
    assert sorted(preds.pending_attrs()) == ["age", "follows", "name"]
    assert len(preds) == 3 and "age" in preds and list(preds) == \
        ["age", "follows", "name"]
    assert preds.folded_items() == []
    assert preds.pending_card("follows") == 60
    pd = preds.get("follows")
    assert pd is not None and pd.csr.device.type == "cpu"
    assert sorted(preds.pending_attrs()) == ["age", "name"]
    assert preds.get("missing") is None


def test_racing_first_readers_share_one_fold(monkeypatch):
    tw = small_twin()
    snap = tw.tasm.snapshot(tw.ts)
    calls = []
    orig = tcb._build_pred

    def counted(store, attr, read_ts, own, dev):
        if attr == "follows":
            calls.append(attr)
        return orig(store, attr, read_ts, own, dev)

    monkeypatch.setattr(tcb, "_build_pred", counted)
    got = [None] * 8
    barrier = threading.Barrier(8)

    def read(i):
        barrier.wait()
        got[i] = snap.preds.get("follows")

    ths = [threading.Thread(target=read, args=(i,)) for i in range(8)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert calls == ["follows"]
    assert all(g is got[0] and g is not None for g in got)


def test_failed_fold_resets_leadership(monkeypatch):
    tw = small_twin()
    snap = tw.tasm.snapshot(tw.ts)
    orig = tcb._build_pred
    fails = [1]

    def flaky(store, attr, read_ts, own, dev):
        if attr == "age" and fails:
            fails.pop()
            raise RuntimeError("transient fold failure")
        return orig(store, attr, read_ts, own, dev)

    monkeypatch.setattr(tcb, "_build_pred", flaky)
    with pytest.raises(RuntimeError, match="transient"):
        snap.preds.get("age")
    assert snap.preds.is_pending("age")
    pd = snap.preds.get("age")               # the retry folds
    assert pd is not None and len(pd.host_values) == 60


def test_lazy_copy_shares_thunks():
    tw = small_twin()
    snap = tw.tasm.snapshot(tw.ts)
    cp = snap.preds.lazy_copy()
    # the copy folds nothing (the JAX package's copy folds every pending
    # tablet: dict.update goes through the subclass's keys/__getitem__)
    assert cp.pending_attrs() == ["age", "follows", "name"]
    assert snap.preds.pending_attrs() == ["age", "follows", "name"]
    pd = cp.get("name")
    assert snap.preds.get("name") is pd           # one shared fold
    snap.preds["age"] = pd                        # an explicit entry wins
    assert snap.preds.folded_get("age") is pd
    assert cp.is_pending("age")


def test_delegate_thunk_resolves_through_its_source():
    """A DelegateThunk registered in another LazyPreds folds through the
    source map's own thunk: one fold, one wrap, one identity for racing
    readers; a delegate over an absent tablet reads as absent."""
    tw = small_twin()
    src = tw.tasm.snapshot(tw.ts).preds
    wrapped = []

    def wrap(pd):
        wrapped.append(pd.attr)
        return pd

    dst = tcb.LazyPreds()
    dst.register("follows", tcb.DelegateThunk(src, "follows", wrap))
    dst.register("missing", tcb.DelegateThunk(src, "missing"))
    assert dst.is_pending("follows") and src.is_pending("follows")
    got = [None] * 6
    barrier = threading.Barrier(6)

    def read(i):
        barrier.wait()
        got[i] = dst.get("follows")

    ths = [threading.Thread(target=read, args=(i,)) for i in range(6)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ths)
    assert wrapped == ["follows"]
    assert all(g is got[0] and g is not None for g in got)
    assert src.folded_get("follows") is got[0]
    assert dst.get("missing") is None and not dst.is_pending("missing")


def test_eager_and_lazy_folds_byte_identical():
    tw = small_twin()
    tw.txn('<0x1> <name> "x y" .\n<0x2> <follows> <0x9> .')
    eager = tcb.build_snapshot(tw.t, tw.ts, device="cpu")
    lazy = tcb.build_snapshot(tw.t, tw.ts, lazy=True, device="cpu")
    assert lazy.preds.pending_attrs()
    for attr in eager.preds:
        assert t_state(lazy.preds[attr]) == t_state(eager.preds[attr])
    assert lazy.preds.pending_attrs() == []


# ---------------------------------------------------------------------------
# planner statistics
# ---------------------------------------------------------------------------

def _stats(mod, snap, attrs):
    out = {"snapshot": mod.snapshot_stats(snap, top_k=4)}
    for a in attrs:
        pd = snap.pred(a)
        st = mod.pred_stats(pd)
        out[a] = (st.to_dict(), st.has_card, st.fwd.via_delta)
        for name, ti in pd.indexes.items():
            terms = list(ti.terms)
            probe = terms[len(terms) // 2] if terms else b""
            out[(a, name)] = (
                mod.term_freq(ti, probe), mod.topk_terms(ti, 3),
                [mod.range_count(ti, op, probe)
                 for op in ("eq", "lt", "le", "gt", "ge")])
    return out


@pytest.mark.parametrize("overlaid", [False, True])
def test_stats_equal_jax(overlaid):
    tw = small_twin()
    for a in ("name", "age", "follows"):
        tw.snaps()[0].pred(a)
        tw.snaps()[1].pred(a)
    if overlaid:
        tw.txn('<0x1> <follows> <0x30> .\n<0x2> <age> "91"^^<xs:int> .\n'
               '<0x3> <name> "new words" .')
    jsnap, tsnap = tw.snaps()
    for a in ("name", "age", "follows"):
        jsnap.pred(a)
        tsnap.pred(a)
    if overlaid:
        assert isinstance(tsnap.pred("follows").csr, tdelta.OverlayCSR)
    got = _stats(tstats, tsnap, ["name", "age", "follows"])
    want = _stats(jstats, jsnap, ["name", "age", "follows"])
    assert got == want
    assert got["follows"][2] is overlaid
