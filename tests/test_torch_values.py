"""The port's value slice against the JAX package, on the CPU: value
predicates, index root functions, value filters, ordering, val/math/
aggregates, facet filters and @recurse with value children.

The same state goes to both packages: a JAX Node folds N-Quads into a
snapshot, and carry.snapshot_from_numpy(..., values=, facets=) brings its
adjacencies, values, token indexes and facets to the port. The repo's
golden battery (tests/test_golden.py, tests/golden/expected.json) then runs
through the bare JAX Executor and the port's, on both index-union paths
(the host merge, and HOST_EXPAND_MAX = 0 in both packages so every union
and expand takes the device functions, here on CPU tensors). Everything is
held exactly: byte-identical JSON and np.array_equal on arrays.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dgraph_tpu.api.server import Node
from dgraph_tpu.models.rmat import rmat_csr
from dgraph_tpu.ops import csr as jcsr
from dgraph_tpu.query import dql as jdql
from dgraph_tpu.query import engine as jeng
from dgraph_tpu.query import recurse as jrec
from dgraph_tpu.query import task as jtask

from dgraph_tpu_torch import carry
from dgraph_tpu_torch.ops import csr as tcsr
from dgraph_tpu_torch.query import dql as tdql
from dgraph_tpu_torch.query import engine as teng
from dgraph_tpu_torch.query import recurse as trec
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.storage.csr_build import build_value_pred
from dgraph_tpu_torch.utils import schema as tschema
from dgraph_tpu_torch.utils.types import (TypeID, Val, hash_password,
                                          parse_datetime)

REPO = Path(__file__).resolve().parents[1]


def _golden_module():
    """SCHEMA, _dataset() and QUERIES of tests/test_golden.py, loaded by
    path (that file stays as it is)."""
    spec = importlib.util.spec_from_file_location(
        "golden_battery", REPO / "tests" / "test_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _golden_module()
EXPECTED = json.loads((REPO / "tests" / "golden" / "expected.json")
                      .read_text())
BATTERY = list(GOLDEN.QUERIES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry_snapshot(jsnap, attrs):
    """The port's snapshot (on the CPU) of a JAX snapshot's predicates."""
    preds, values, facets = {}, {}, {}
    for a in attrs:
        pd = jsnap.pred(a)
        if pd is None:
            continue
        if pd.csr is not None:
            preds[a] = (int(pd.type_id), *pd.csr.host_arrays())
            if pd.rev_csr is not None:
                preds["~" + a] = (int(pd.type_id), *pd.rev_csr.host_arrays())
        if pd.value_subjects_host is not None or pd.indexes:
            values[a] = {
                "type_id": int(pd.type_id),
                "value_subjects": pd.value_subjects_host,
                "num_values": pd.num_values_host,
                "host_values": pd.host_values,
                "list_values": pd.list_values,
                "lang_values": pd.lang_values,
                "indexes": {name: (ti.terms, *ti.host_arrays())
                            for name, ti in pd.indexes.items()}}
        if pd.facets:
            facets[a] = pd.facets
    return carry.snapshot_from_numpy(preds, jsnap.read_ts, device="cpu",
                                     facets=facets, values=values)


def _node(schema_text, nquads):
    """(JAX snapshot, JAX schema, port snapshot, port schema)."""
    n = Node()
    n.alter(schema_text=schema_text)
    n.mutate(set_nquads=nquads, commit_now=True)
    jsnap, js = n.snapshot(), n._schema_view()
    ts = tschema.SchemaState()
    for e in tschema.parse_schema(schema_text):
        ts.set(e)
    assert sorted(ts.predicates()) == sorted(js.predicates())
    return jsnap, js, carry_snapshot(jsnap, js.predicates()), ts


def _run(state, q):
    """(JAX JSON, port JSON) of one request."""
    jsnap, js, tsnap, ts = state
    want = json.dumps(jeng.Executor(jsnap, js).execute(jdql.parse(q)))
    got = json.dumps(teng.Executor(tsnap, ts).execute(tdql.parse(q)))
    return want, got


@pytest.fixture(scope="module")
def golden():
    return _node(GOLDEN.SCHEMA, GOLDEN._dataset())


@pytest.fixture(params=["host_union", "device_union"])
def union_path(request, monkeypatch):
    if request.param == "device_union":
        monkeypatch.setattr(jtask, "HOST_EXPAND_MAX", 0)
        monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    return request.param


# ---------------------------------------------------------------------------
# the golden battery, byte for byte
# ---------------------------------------------------------------------------

# queries whose root is an index probe: their union runs expand_dest
UNION_ROOTS = {"eq_exact", "term_any", "ineq_int", "year_index", "regexp",
               "geo_near"}


@pytest.mark.parametrize("name,q", BATTERY, ids=[n for n, _ in BATTERY])
def test_golden_battery_byte_identical(golden, union_path, name, q):
    before = tcsr.UNIONS["cpu"]
    want, got = _run(golden, q)
    assert got == want
    assert json.loads(got) == EXPECTED[name]
    if union_path == "device_union" and name in UNION_ROOTS:
        assert tcsr.UNIONS["cpu"] > before


def test_golden_battery_covers_the_file():
    assert len(BATTERY) == 38
    assert {n for n, _ in GOLDEN.QUERIES} == set(EXPECTED)


# shapes the battery leaves out: geo and datetime output, ordering by a
# lang value and by a value var with after, allofterms at the root,
# val-var root functions, facet variables and cascade over value children
EXTRA = [
    '{ q(func: near(loc, [-117.5, 31.25], 400000), orderasc: name) '
    '{ name loc } }',
    '{ q(func: within(loc, "{\\"type\\":\\"Polygon\\",\\"coordinates\\":'
    '[[[-125,25],[-100,25],[-100,40],[-125,40],[-125,25]]]}")) '
    '{ name email } }',
    '{ q(func: has(release_date), orderdesc: release_date, first: 3, '
    'offset: 1) { name release_date runtime } }',
    '{ q(func: allofterms(name, "film noir"), orderdesc: runtime) '
    '{ uid name@. runtime } }',
    '{ var(func: has(runtime)) { rt as runtime } '
    '  q(func: eq(val(rt), 100, 101, 102, 113)) { name val(rt) } }',
    '{ q(func: uid(0x2006, 0x2007)) { name starring @facets(b as billing) '
    '{ name } } r(func: uid(b), orderasc: val(b), after: 0x3001) '
    '{ uid val(b) } }',
    '{ q(func: has(rating), orderasc: rating, first: 8) @cascade '
    '{ name@fr rating } }',
    '{ q(func: anyofterms(name, "comedy noir"), first: 5) @filter('
    'has(release_date) AND NOT le(runtime, 120)) { name genre { name } } }',
    '{ q(func: ge(count(starring), 3), first: 4) '
    '{ n: count(starring) s: starring @facets(eq(character, "char1")) '
    '{ name } } }',
]


@pytest.mark.parametrize("qidx", range(len(EXTRA)))
def test_extra_value_shapes_byte_identical(golden, union_path, qidx):
    want, got = _run(golden, EXTRA[qidx])
    assert got == want
    assert len(json.loads(got)) > 0


def test_similar_to_raises_naming_its_slice(golden):
    """similar_to over the golden `name` (no vector index) raises the JAX
    package's typed error naming the missing index."""
    from dgraph_tpu.query.task import TaskError as JTaskError
    from dgraph_tpu_torch.query.task import TaskError as TTaskError

    jsnap, js, tsnap, ts = golden
    q = '{ q(func: similar_to(name, "[1, 2]", 3)) { uid } }'
    with pytest.raises(TTaskError) as te:
        teng.Executor(tsnap, ts).execute(tdql.parse(q))
    with pytest.raises(JTaskError) as je:
        jeng.Executor(jsnap, js).execute(jdql.parse(q))
    assert str(te.value) == str(je.value) and "vector" in str(te.value)


# ---------------------------------------------------------------------------
# build_value_pred against the JAX package's build_pred
# ---------------------------------------------------------------------------

FOLD_SCHEMA = """
age: int @index(int) .
score: float @index(float) .
alive: bool @index(bool) .
born: dateTime @index(year, month, day, hour) .
name: string @index(exact, hash, term, trigram, fulltext) @lang .
tags: [int] @index(int) .
loc: geo @index(geo) .
pwd: password .
note: string .
"""

WORDS = ["river", "stone", "rivers", "running", "ran", "the", "blue",
         "Über", "café", "north"]


def _fold_rows():
    """(N-Quads, {attr: [(subject, Val, lang, facets)]}) of one seeded
    state: every value type, @lang, a list, geo, a password and facets."""
    rng = np.random.default_rng(17)
    quads, rows = [], {}
    digest = hash_password("s3cret-pass")

    def add(s, attr, lit, val, lang="", fac=()):
        text = f'<0x{s:x}> <{attr}> {lit}'
        if lang:
            text += f"@{lang}"
        if fac:
            text += " (" + ", ".join(f"{k}={lit_}" for k, lit_, _ in fac) + ")"
        quads.append(text + " .")
        rows.setdefault(attr, []).append(
            (s, val, lang, tuple((k, v) for k, _, v in sorted(fac))))

    for s in range(1, 41):
        if s % 5:
            a = int(rng.integers(-5, 90))
            add(s, "age", f'"{a}"', Val(TypeID.STRING, str(a)))
        if s % 3:
            f = round(float(rng.normal(0, 30)), 3)
            add(s, "score", f'"{f}"^^<xs:float>', Val(TypeID.FLOAT, f))
        if s % 4 == 1:
            b = bool(rng.integers(0, 2))
            add(s, "alive", f'"{str(b).lower()}"', Val(TypeID.STRING,
                                                       str(b).lower()))
        if s % 2:
            d = f"{1990 + s % 7}-0{1 + s % 9}-1{s % 10}T{s % 24:02d}:30:00"
            add(s, "born", f'"{d}"^^<xs:dateTime>',
                Val(TypeID.DATETIME, parse_datetime(d)))
        words = " ".join(WORDS[int(i)] for i in rng.integers(0, len(WORDS), 3))
        fac = ((("since", str(2000 + s), Val(TypeID.INT, 2000 + s)),
                ("via", '"web"', Val(TypeID.STRING, "web")))
               if s % 6 == 0 else ())
        if s % 7:
            add(s, "name", f'"{words} {s}"', Val(TypeID.STRING,
                                                 f"{words} {s}"), fac=fac)
        if s % 3 == 0:
            add(s, "name", f'"le {words}"', Val(TypeID.STRING, f"le {words}"),
                lang="fr", fac=fac)
        if s % 5 == 2:
            add(s, "name", f'"der {words}"', Val(TypeID.STRING,
                                                 f"der {words}"), lang="de")
        for t in sorted(set(rng.integers(0, 6, int(rng.integers(0, 4))))):
            tfac = ((("w", str(int(t)), Val(TypeID.INT, int(t))),)
                    if t % 2 else ())
            add(s, "tags", f'"{int(t) * 10}"', Val(TypeID.STRING,
                                                    str(int(t) * 10)),
                fac=tfac)
        if s % 4 == 0:
            lng, lat = float(-120 + s), float(30 + s / 4)
            g = ('{\\"type\\":\\"Point\\",\\"coordinates\\":'
                 f'[{lng},{lat}]}}')
            add(s, "loc", f'"{g}"^^<geo:geojson>',
                Val(TypeID.STRING, g.replace('\\"', '"')))
        if s % 8 == 3:
            add(s, "pwd", f'"{digest}"^^<pwd:hashed>',
                Val(TypeID.PASSWORD, digest))
        if s % 9 == 4:
            add(s, "note", f'"note {s}"', Val(TypeID.STRING, f"note {s}"))
    return "\n".join(quads), rows


def _norm(v):
    if v.tid == TypeID.GEO:
        return (int(v.tid), v.value.kind, v.value.coords)
    return (int(v.tid), v.value)


def _norm_facets(fs):
    return tuple((k, _norm(v)) for k, v in fs)


def test_build_value_pred_matches_build_pred():
    nquads, rows = _fold_rows()
    n = Node()
    n.alter(schema_text=FOLD_SCHEMA)
    n.mutate(set_nquads=nquads, commit_now=True)
    jsnap, js = n.snapshot(), n._schema_view()
    ts = tschema.SchemaState()
    for e in tschema.parse_schema(FOLD_SCHEMA):
        ts.set(e)
    for attr in sorted(rows):
        want = jsnap.pred(attr)
        got = build_value_pred(attr, ts.get(attr), rows[attr], device="cpu")
        assert int(got.type_id) == int(want.type_id), attr
        assert got.csr is None and want.csr is None, attr
        np.testing.assert_array_equal(got.value_subjects_host,
                                      want.value_subjects_host, err_msg=attr)
        np.testing.assert_array_equal(got.num_values_host,
                                      want.num_values_host, err_msg=attr)
        assert {u: _norm(v) for u, v in got.host_values.items()} == \
            {u: _norm(v) for u, v in want.host_values.items()}, attr
        assert {u: [_norm(v) for v in vs]
                for u, vs in got.list_values.items()} == \
            {u: [_norm(v) for v in vs]
             for u, vs in want.list_values.items()}, attr
        # lang dicts compare with their order: "." reads the first entry
        assert {u: [(lg, _norm(v)) for lg, v in lv.items()]
                for u, lv in got.lang_values.items()} == \
            {u: [(lg, _norm(v)) for lg, v in lv.items()]
             for u, lv in want.lang_values.items()}, attr
        assert {k: _norm_facets(f) for k, f in got.facets.items()} == \
            {k: _norm_facets(f) for k, f in want.facets.items()}, attr
        assert sorted(got.indexes) == sorted(want.indexes), attr
        for name, ti in want.indexes.items():
            gi = got.indexes[name]
            assert gi.terms == ti.terms, (attr, name)
            for g, w in zip(gi.host_arrays(), ti.host_arrays()):
                np.testing.assert_array_equal(g, w, err_msg=f"{attr}/{name}")
    # the fold's state answers as the JAX node does
    snap = carry.snapshot_from_numpy({}, 1, device="cpu")
    for attr, r in rows.items():
        snap.preds[attr] = build_value_pred(attr, ts.get(attr), r,
                                            device="cpu")
    for q in ('{ q(func: anyoftext(name, "river running"), orderasc: age) '
              '{ uid name name@fr age score born alive tags loc '
              'checkpwd(pwd, "s3cret-pass") } }',
              '{ q(func: regexp(name, /^(blue|north) /i)) @filter('
              'has(tags) OR ge(score, 0)) { uid name@de:. tags } }',
              '{ q(func: eq(tags, 20, 40)) { uid tags name @facets } }',
              '{ q(func: ge(born, "1993-01-01T00:00:00"), first: 6) '
              '{ uid born pwd note } }'):
        want = json.dumps(jeng.Executor(jsnap, js).execute(jdql.parse(q)))
        got = json.dumps(teng.Executor(snap, ts).execute(tdql.parse(q)))
        assert got == want, q
        assert len(json.loads(got).get("q", [])) > 0, q


# ---------------------------------------------------------------------------
# the device union
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_cap", [64, 1 << 14])
@pytest.mark.parametrize("seed", [1, 2])
def test_expand_dest_matches_jax(seed, out_cap):
    s, p, x = rmat_csr(9, 8, seed=seed)
    rng = np.random.default_rng(seed)
    rows = np.unique(rng.integers(0, len(s), 60)).astype(np.int32)
    rows = np.concatenate([rows, np.full(4, np.iinfo(np.int32).max,
                                         np.int32)])
    want = jcsr.expand_dest(jnp.asarray(p), jnp.asarray(x),
                            jnp.asarray(rows), out_cap)
    got = tcsr.expand_dest(torch.from_numpy(p), torch.from_numpy(x),
                           torch.from_numpy(rows), out_cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (int(got[1]) > out_cap) == (out_cap == 64)


# ---------------------------------------------------------------------------
# seeded value filters over an R-MAT graph
# ---------------------------------------------------------------------------

RMAT_SCHEMA = ("friend: [uid] @reverse @count .\n"
               "age: int @index(int) .\nscore: float @index(float) .\n")


@pytest.fixture(scope="module")
def rmat_state():
    s, p, x = rmat_csr(10, 8, seed=7)
    rng = np.random.default_rng(23)
    quads = [f"<0x{a:x}> <friend> <0x{b:x}> ."
             for a, b in zip(np.repeat(s, np.diff(p)).tolist(), x.tolist())]
    n_nodes = int(max(s.max(), x.max()))
    for u in range(1, n_nodes + 1):
        if rng.random() < 0.9:
            quads.append(f'<0x{u:x}> <age> "{int(rng.integers(0, 100))}" .')
        if rng.random() < 0.8:
            quads.append(f'<0x{u:x}> <score> '
                         f'"{int(rng.integers(0, 10000)) / 100}" .')
    seeds = np.unique(np.random.default_rng(3).choice(s, 24, replace=False))
    return _node(RMAT_SCHEMA, "\n".join(quads)), seeds


def _leaf(rng):
    kind = int(rng.integers(0, 6))
    op = ["eq", "le", "lt", "ge", "gt"][int(rng.integers(0, 5))]
    if kind == 0:
        return f"{op}(age, {int(rng.integers(0, 100))})"
    if kind == 1:
        return f"{op}(score, {int(rng.integers(0, 10000)) / 100})"
    if kind == 2:
        return ["has(age)", "has(score)", "has(friend)"][int(rng.integers(0, 3))]
    if kind == 3:
        return f"{op}(count(friend), {int(rng.integers(0, 6))})"
    if kind == 4:
        return f"{op}(val(a), {int(rng.integers(0, 100))})"
    return "eq(age, %s)" % ", ".join(str(int(v)) for v in
                                     rng.integers(0, 100, 3))


def _tree(rng, depth=0):
    if depth >= 2 or rng.random() < 0.35:
        return _leaf(rng)
    op = ["AND", "OR", "NOT"][int(rng.integers(0, 3))]
    if op == "NOT":
        return f"NOT ({_tree(rng, depth + 1)})"
    return f"({_tree(rng, depth + 1)} {op} {_tree(rng, depth + 1)})"


def _fuzz_query(i, seeds):
    rng = np.random.default_rng(100 + i)
    f = _tree(rng)
    sel = ", ".join(hex(int(u)) for u in seeds)
    var = f"var(func: uid({sel})) {{ friend {{ a as age }} }} "
    if i % 3 == 0:
        return (f"{{ {var} q(func: has(age), first: 30, orderasc: score) "
                f"@filter({f}) {{ uid age score }} }}")
    if i % 3 == 1:
        return (f"{{ {var} q(func: uid({sel})) {{ uid friend @filter({f}) "
                f"(first: 7, orderdesc: age) {{ uid age score }} }} }}")
    return (f"{{ {var} q(func: ge(score, {int(rng.integers(0, 90))}), "
            f"orderdesc: age, orderasc: score, first: 25, offset: 3) "
            f"@filter({f}) {{ uid age count(friend) }} }}")


@pytest.mark.parametrize("i", range(18))
def test_filter_fuzz_byte_identical(rmat_state, i):
    """The first of up to five seeded filters whose answer is not empty."""
    state, seeds = rmat_state
    for k in range(5):
        want, got = _run(state, _fuzz_query(10 * i + k, seeds))
        assert got == want
        if got != "{}":
            break
    assert got != "{}"


@pytest.mark.parametrize("first", [3, -2])
def test_task_first_truncates_rows_like_jax(rmat_state, union_path, first):
    """TaskQuery.first cuts each uidMatrix row (intern.Query.first) on both
    expand paths; the task's value matrix comes along unchanged."""
    (jsnap, js, tsnap, ts), seeds = rmat_state
    frontier = np.asarray(seeds, dtype=np.int64)
    want = jtask.process_task(jsnap, jtask.TaskQuery(
        "friend", frontier=frontier, first=first), js)
    got = ttask.process_task(tsnap, ttask.TaskQuery(
        "friend", frontier=frontier, first=first), ts)
    assert len(got.uid_matrix) == len(want.uid_matrix) == len(frontier)
    for g, w in zip(got.uid_matrix, want.uid_matrix):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert len(g) <= abs(first)
    np.testing.assert_array_equal(got.dest_uids, want.dest_uids)
    assert got.traversed_edges == want.traversed_edges
    vals = ttask.process_task(tsnap, ttask.TaskQuery(
        "age", frontier=frontier, first=first), ts)
    jvals = jtask.process_task(jsnap, jtask.TaskQuery(
        "age", frontier=frontier, first=first), js)
    assert [[v.value for v in vs] for vs in vals.value_matrix] == \
        [[v.value for v in vs] for vs in jvals.value_matrix]


@pytest.mark.parametrize("shape", [
    "{ q(func: uid(%s)) @recurse(depth: 3) { age friend @filter(lt(age, 40)) } }",
    "{ q(func: uid(%s)) @recurse(depth: 2) { age score friend } }",
    "{ q(func: uid(%s)) @recurse(depth: 3) { friend @filter(ge(score, 30.5)) "
    "age } }"])
def test_recurse_value_children_kernel_path(rmat_state, monkeypatch, shape):
    monkeypatch.setattr(jrec, "KERNEL_MIN_EDGES", 0)
    monkeypatch.setattr(trec, "KERNEL_MIN_EDGES", 0)
    state, seeds = rmat_state
    calls = {"step": 0}
    real = trec.pb.recurse_step

    def counted(*a, **k):
        calls["step"] += 1
        return real(*a, **k)

    monkeypatch.setattr(trec.pb, "recurse_step", counted)
    want, got = _run(state, shape % ", ".join(hex(int(u)) for u in seeds))
    assert got == want
    assert calls["step"] > 0
    assert len(json.loads(got)["q"]) > 0


def test_term_tokens_equal_jax():
    """The port's term tokenizer gives the JAX package's terms: ASCII with
    every punctuation and control character, digits and case, and
    non-ASCII text."""
    from dgraph_tpu.utils import tok as jtok
    from dgraph_tpu.utils.types import TypeID as JT, Val as JV
    from dgraph_tpu_torch.utils import tok as ttok

    rng = np.random.default_rng(29)
    ascii_all = "".join(chr(c) for c in range(128))
    texts = [ascii_all, ascii_all[::-1], "", "   ", "p17 wab wcd WEF",
             "Hello, World! 3.14 e=mc^2 _under_score_ tab\there",
             "Ünïcödé café naïve — résumé", "日本語 テキスト 123", "ﬁne ﬂow Ⅻ"]
    for _ in range(200):
        k = int(rng.integers(0, 40))
        pool = ascii_all if rng.random() < 0.7 else ascii_all + "éßΩ–ﬁ"
        texts.append("".join(pool[int(i)] for i in
                             rng.integers(0, len(pool), k)))
    for t in texts:
        assert ttok._term_tokens(Val(TypeID.STRING, t)) == \
            jtok._term_tokens(JV(JT.STRING, t)), repr(t)


# ---------------------------------------------------------------------------
# filter combines above a lowered uidset.HOST_CUTOVER (torch ops on the CPU)
# ---------------------------------------------------------------------------

COMBINE_SCHEMA = """
name: string @index(term) .
age: int @index(int) .
"""
COMBINE_WORDS = ("wa", "wb", "wc", "wd", "we", "wf")
# unsorted and repeated on purpose: the literal list reaches the combine
# as written (engine._eval_filter_func)
COMBINE_DROP = [0x2F, 0x3, 0x1C0, 0x3, 0x11, 0x5A, 0x11] + \
    list(range(0x100, 0x80, -7))
COMBINE_QUERIES = (
    '{ q(func: has(name)) @filter((anyofterms(name, "wa wb") OR ge(age, 50))'
    ' AND NOT uid(%s)) { uid name age } }'
    % ", ".join(hex(u) for u in COMBINE_DROP),
    '{ q(func: has(name)) @filter(uid(0x3, 0x1, 0x1)) { uid name age } }',
    '{ A as var(func: anyofterms(name, "wc")) B as var(func: ge(age, 70)) '
    'q(func: uid(A, B)) @filter(NOT uid(%s)) { uid age } }'
    % ", ".join(hex(u) for u in COMBINE_DROP),
)


@pytest.fixture(scope="module")
def combine_state():
    """A few hundred uids with a term-indexed name and an int age."""
    rng = np.random.default_rng(31)
    quads = []
    for u in range(1, 401):
        w = rng.choice(len(COMBINE_WORDS), 2, replace=False)
        quads.append(f'<{hex(u)}> <name> "n{u} {COMBINE_WORDS[w[0]]} '
                     f'{COMBINE_WORDS[w[1]]}" .')
        quads.append(f'<{hex(u)}> <age> "{int(rng.integers(0, 100))}" .')
    return _node(COMBINE_SCHEMA, "\n".join(quads))


@pytest.mark.parametrize("qi", range(len(COMBINE_QUERIES)))
def test_filter_combines_on_the_device_branch_equal_jax(combine_state,
                                                       monkeypatch, qi):
    """AND / OR / NOT over an index-backed function, a value compare and
    uid(...) literals, with the port's HOST_CUTOVER lowered to 16 so the
    combines run as torch ops on the snapshot's device (the CPU here):
    JSON byte-identical to the JAX Executor, and the combine counter shows
    the device branch ran."""
    from dgraph_tpu_torch.ops import uidset as tus

    monkeypatch.setattr(tus, "HOST_CUTOVER", 16)
    before = {op: c["cpu"] for op, c in tus.COMBINES.items()}
    want, got = _run(combine_state, COMBINE_QUERIES[qi])
    assert got == want
    assert len(json.loads(got)["q"]) > 0
    moved = {op: c["cpu"] - before[op] for op, c in tus.COMBINES.items()}
    if qi == 0:
        # the OR's union, the NOT's difference, the AND's and the
        # anyofterms leaf's intersections
        assert moved["union"] >= 1 and moved["difference"] >= 1
        assert moved["intersect"] >= 2
    elif qi == 1:
        assert sum(moved.values()) == 0       # three literals: numpy
    else:
        # the root's uid(A, B) union and the literal filter's intersection
        # (the NOT's difference is over the few dropped uids: numpy)
        assert moved["union"] >= 1 and moved["intersect"] >= 1
