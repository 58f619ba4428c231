"""uid(A, B, ...) over vars that keep the card's copy of their level's dest,
on the CPU.

A device-gathered level keeps the card's copy of its dest
(task.TaskResult.dest_dev) and a uid var bound to that level keeps it
beside its host uids (engine.VarValue.dev). uidset.union_parts unions a
uid(...) root or filter on the card from HOST_CUTOVER uids where a part
has such a copy: only the parts without one go up, and the result comes
back once. Against np.union1d and the JAX package's Executor:

- union_parts on parts with and without copies, uid literals unsorted and
  repeated, empty parts, repeats across parts, a uid above 2^31 (the
  int64 path), under HOST_CUTOVER and a single part (the host path);
- the k-hop request `uid(A, B, C)` on a Kronecker graph, A gathered on the
  host and B and C on the card: the same JSON as the JAX package's, one
  union on the card with one part uploaded, and none for the 2-hop
  request under HOST_CUTOVER; a root with uid literals and a var bound by a
  root function; the uid(...) filter with a uid above 2^31;
- a var on a filtered, first / offset, facet-filtered or @cascade level
  holds no card copy, and the answers are the host path's and the JAX
  package's;
- an ordered or paginated root's var is stored ascending, with no copy.
"""

import functools
import json

import numpy as np
import pytest
import torch

from dgraph_tpu.api.server import Node
from dgraph_tpu.models.rmat import rmat_csr
from dgraph_tpu.query import dql as jdql
from dgraph_tpu.query import engine as jeng
from dgraph_tpu.storage import csr_build as jcb
from dgraph_tpu.utils import schema as jschema
from dgraph_tpu.utils.types import TypeID as JTypeID

from dgraph_tpu_torch import carry
from dgraph_tpu_torch.ops import uidset as us
from dgraph_tpu_torch.query import dql as tdql
from dgraph_tpu_torch.query import engine as teng
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.utils import schema as tschema
from dgraph_tpu_torch.utils.metrics import Registry

ON_CARD = "dgraph_var_union_on_device_total"
UPLOADED = "dgraph_var_union_parts_uploaded_total"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# union_parts against np.union1d
# ---------------------------------------------------------------------------

def _sorted_part(rng, n, hi=6000):
    return np.unique(rng.integers(1, hi, n)).astype(np.int64)


def _card(host):
    """A level's dest as the gather leaves it: int32 on the device."""
    return torch.from_numpy(host.astype(np.int32))


def _parts(case):
    """(parts, card unions, parts uploaded) of one case."""
    rng = np.random.default_rng(7)
    a, b, c = (_sorted_part(rng, n) for n in (300, 2500, 4000))
    lit = rng.integers(1, 6000, 40).astype(np.int64)     # unsorted, repeats
    lit[:5] = lit[5]
    if case == "copies":
        return [(a, _card(a)), (b, _card(b)), (c, _card(c))], 1, 0
    if case == "mixed":
        return [(a, None), (b, _card(b)), (c, _card(c))], 1, 1
    if case == "literals":
        return [(lit, None), (a, None), (b, _card(b))], 1, 2
    if case == "empty":
        empty = np.zeros(0, np.int64)
        return [(empty, None), (empty, _card(empty)), (c, _card(c)),
                (a, None)], 1, 1
    if case == "repeats":
        return [(c, _card(c)), (c[::3].copy(), None), (c, _card(c))], 1, 1
    if case == "wide":
        big = np.asarray([2 ** 31 + 5, 2 ** 32 + 1, 3], np.int64)
        return [(big, None), (b, _card(b)), (c, _card(c))], 1, 1
    if case == "no_copies":
        return [(a, None), (b, None), (c, None)], 0, 0
    if case == "under":
        return [(a, None), (a[:100].copy(), _card(a[:100]))], 0, 0
    assert case == "single"
    return [(c, _card(c))], 0, 0


@pytest.mark.parametrize("case", ["copies", "mixed", "literals", "empty",
                                  "repeats", "wide", "no_copies", "under",
                                  "single"])
def test_union_parts_equals_union1d(case):
    parts, on_card, uploaded = _parts(case)
    reg = Registry()
    before = us.COMBINES["union"]["cpu"]
    got = us.union_parts(parts, "cpu", reg)
    want = functools.reduce(np.union1d, [h for h, _ in parts]) \
        if len(parts) > 1 else parts[0][0]
    assert got.dtype == np.int64
    assert got.tolist() == want.tolist()
    assert reg.counter(ON_CARD).value == on_card
    assert reg.counter(UPLOADED).value == uploaded
    if on_card:
        assert us.COMBINES["union"]["cpu"] == before + 1
    if case == "wide":
        assert 2 ** 32 + 1 in got.tolist()


# ---------------------------------------------------------------------------
# the k-hop request against the JAX package
# ---------------------------------------------------------------------------

SCHEMA = "friend: [uid] ."
KHOP = ("{ var(func: uid(%s)) { A as friend { B as friend { C as friend } } }"
        " q(func: uid(A, B, C)) { count(uid) } }")
KHOP2 = ("{ var(func: uid(%s)) { A as friend { B as friend } }"
         " q(func: uid(A, B)) { count(uid) } }")
ROOTS = ("{ var(func: uid(%s)) { A as friend { B as friend } }"
         " N as var(func: has(friend))"
         " q(func: uid(0x5, 0x9, A, B, N, 0x5)) { count(uid) } }")
FILTER = ("{ var(func: uid(%s)) { A as friend { B as friend { C as friend } } }"
          " q(func: has(friend)) @filter(uid(A, B, C, 0x100000001))"
          " { count(uid) } }")


@pytest.fixture(scope="module")
def kronecker():
    s, p, x = (np.asarray(a) for a in rmat_csr(12, 8, seed=5))
    jsnap = jcb.GraphSnapshot(1)
    jsnap.preds["friend"] = jcb.PredData("friend", JTypeID.UID,
                                         csr=jcb.PredCSR(s, p, x))
    js = jschema.SchemaState()
    for e in jschema.parse_schema(SCHEMA):
        js.set(e)
    # 16 seeds of out-degree 4 to 8: A a few dozen uids, B and C thousands
    deg = np.diff(p)
    cand = s[(deg >= 4) & (deg <= 8)]
    seeds = ", ".join(hex(int(u)) for u in cand[:: len(cand) // 16][:16])
    return jsnap, js, (s, p, x), seeds


def _port(arrays):
    snap = carry.snapshot_from_numpy({"friend": (int(JTypeID.UID), *arrays)},
                                     1, device="cpu")
    snap.metrics = Registry()
    ts = tschema.SchemaState()
    for e in tschema.parse_schema(SCHEMA):
        ts.set(e)
    return snap, ts


@pytest.mark.parametrize("q,on_card,uploaded", [
    pytest.param(KHOP, 1, 1, id="khop3"),
    pytest.param(KHOP2, 0, 0, id="khop2-under-cutover"),
    pytest.param(ROOTS, 1, 3, id="literals-and-root-func"),
    pytest.param(FILTER, 1, 2, id="filter-wide"),
])
def test_the_khop_union_equals_jax(kronecker, q, on_card, uploaded,
                                   monkeypatch):
    """A's level (a few dozen uids a frontier) gathers on the host, B's and
    C's, over the cutover, on the card."""
    jsnap, js, arrays, seeds = kronecker
    khop, q = q in (KHOP, KHOP2), q % seeds
    want = json.dumps(jeng.Executor(jsnap, js).execute(jdql.parse(q)))
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 2000)
    snap, ts = _port(arrays)
    ex = teng.Executor(snap, ts)
    got = json.dumps(ex.execute(tdql.parse(q)))
    assert got == want
    assert json.loads(got)["q"][0]["count"] > 0
    assert ex.vars["A"].dev is None and ex.vars["B"].dev is not None
    for v in ex.vars.values():
        if v.dev is not None:
            assert v.dev.tolist() == v.uids.tolist()
    assert snap.metrics.counter(ON_CARD).value == on_card
    assert snap.metrics.counter(UPLOADED).value == uploaded
    if khop:
        # over and under the cutover by their own sizes
        total = sum(len(v.uids) for v in ex.vars.values())
        assert (total >= us.HOST_CUTOVER) == bool(on_card)


# ---------------------------------------------------------------------------
# a level that changes its dest after the gather holds no card copy
# ---------------------------------------------------------------------------

MODS = {
    "filter": "@filter(has(name))",
    "first": "(first: 2)",
    "offset": "(offset: 1)",
    "facets": "@facets(gt(w, 1))",
    "cascade": "@cascade",
}


@pytest.fixture(scope="module")
def faceted():
    """300 uids, ~2,400 friend edges each with a facet w in 0..3, a name on
    every other uid: (JAX snapshot, JAX schema, port snapshot, port
    schema, seeds)."""
    rng = np.random.default_rng(23)
    src = rng.integers(1, 301, 2400)
    dst = rng.integers(1, 301, 2400)
    pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
    w = rng.integers(0, 4, len(pairs))
    quads = [f"<{hex(a)}> <friend> <{hex(b)}> (w={k}) ."
             for (a, b), k in zip(pairs.tolist(), w.tolist())]
    quads += [f'<{hex(u)}> <name> "n{u}" .' for u in range(1, 301, 2)]
    schema = "friend: [uid] .\nname: string ."
    n = Node()
    n.alter(schema_text=schema)
    n.mutate(set_nquads="\n".join(quads), commit_now=True)
    jsnap, js = n.snapshot(), n._schema_view()
    preds, facets, values = {}, {}, {}
    pd = jsnap.pred("friend")
    preds["friend"] = (int(pd.type_id), *pd.csr.host_arrays())
    facets["friend"] = pd.facets
    nd = jsnap.pred("name")
    values["name"] = {"type_id": int(nd.type_id),
                      "value_subjects": nd.value_subjects_host,
                      "num_values": nd.num_values_host,
                      "host_values": nd.host_values,
                      "list_values": nd.list_values,
                      "lang_values": nd.lang_values, "indexes": {}}
    tsnap = carry.snapshot_from_numpy(preds, jsnap.read_ts, device="cpu",
                                      facets=facets, values=values)
    tsnap.metrics = Registry()
    ts = tschema.SchemaState()
    for e in tschema.parse_schema(schema):
        ts.set(e)
    seeds = ", ".join(hex(u) for u in range(3, 300, 37))
    return jsnap, js, tsnap, ts, seeds


@pytest.mark.parametrize("mod", list(MODS))
def test_a_changed_level_unions_no_stale_copy(faceted, mod, monkeypatch):
    jsnap, js, tsnap, ts, seeds = faceted
    body = "{ name }" if mod == "cascade" else "{ B as friend }"
    q = ("{ var(func: uid(%s)) { A as friend %s %s  C as friend } "
         "q(func: uid(A, C)) { count(uid) } "
         "r(func: uid(A, 0x1)) { count(uid) } "
         "f(func: has(friend)) @filter(uid(A, 0x2)) { count(uid) } }"
         % (seeds, MODS[mod], body))
    want = json.dumps(jeng.Executor(jsnap, js).execute(jdql.parse(q)))
    host = json.dumps(teng.Executor(tsnap, ts).execute(tdql.parse(q)))
    monkeypatch.setattr(ttask, "HOST_EXPAND_MAX", 0)
    monkeypatch.setattr(us, "HOST_CUTOVER", 4)
    c0 = tsnap.metrics.counter(ON_CARD).value
    ex = teng.Executor(tsnap, ts)
    card = json.dumps(ex.execute(tdql.parse(q)))
    assert host == want and card == want
    # @cascade prunes its level after the var is bound: the var holds the
    # gather's dest, and its copy with it
    assert (ex.vars["A"].dev is None) == (mod != "cascade")
    assert ex.vars["C"].dev is not None
    for v in ex.vars.values():
        if v.dev is not None:
            assert v.dev.tolist() == v.uids.tolist()
    # uid(A, C) ran on the card; uid(A, 0x1) and uid(A, 0x2) with it only
    # where A kept its copy
    assert tsnap.metrics.counter(ON_CARD).value - c0 == \
        (3 if mod == "cascade" else 1)


@pytest.mark.parametrize("order", ["orderasc: name", "orderdesc: name",
                                   "orderdesc: name, first: 20, offset: 3"])
def test_an_ordered_root_var_is_stored_ascending(faceted, order):
    jsnap, js, tsnap, ts, _seeds = faceted
    q = ("{ A as var(func: has(name), %s) q(func: uid(A)) { count(uid) } }"
         % order)
    ex = teng.Executor(tsnap, ts)
    got = json.dumps(ex.execute(tdql.parse(q)))
    assert got == json.dumps(jeng.Executor(jsnap, js).execute(jdql.parse(q)))
    a = ex.vars["A"]
    assert a.dev is None
    assert len(a.uids) == (20 if "first" in order else 150)
    assert a.uids.tolist() == sorted(a.uids.tolist())
