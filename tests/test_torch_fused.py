"""Whole-plan fused compilation and the fused @groupby terminal of the
port's mesh Node, against the JAX package's, on the CPU.

Four Nodes hold the same graph: a JAX Node and a port Node without a mesh,
a JAX mesh Node on the 8 forced host-platform devices and a port mesh Node
on 8 repeats of the CPU device (tests/test_fused_plan.py's and
tests/test_agg_terminal.py's data). Every query's JSON must be the same
bytes on all four, and the port's mesh Node must move the same counters as
the JAX mesh Node: dispatches, fused hops, traversed edges, program builds,
fused/unfused queries, fallbacks by reason, terminal ops. Exact throughout.

The groupby terminal's cross-checks (groupby._fused_check_counts and
_check_fused_agg) run on the port's rank-space path for `[uid]` keys (the
JAX package takes its dict path there) and on a single `uid` key; a
corrupted device count vector raises QueryError in both packages.
"""

import json

import numpy as np
import pytest
import torch

from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.query import groupby as jgb
from dgraph_tpu.query.engine import QueryError as JQueryError

from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.obs import prom as tprom
from dgraph_tpu_torch.query import fusedplan as tfp
from dgraph_tpu_torch.query import groupby as tgb
from dgraph_tpu_torch.query.engine import QueryError as TQueryError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCHEMA = """
name: string @index(exact) .
rating: float @index(float) .
score: int @index(int) .
boss: uid .
p0: [uid] .
p1: [uid] .
p2: [uid] @reverse .
follows: [uid] .
"""


def _quads():
    """tests/test_fused_plan.py's graph (facets on p0) with
    tests/test_agg_terminal.py's int `score` on a subset, plus a single
    `boss` uid edge per node."""
    rng = np.random.default_rng(11)
    quads = [f'_:n{i} <name> "node{i}" .' for i in range(80)]
    quads += [f'_:n{i} <rating> "{(i * 13) % 100 / 10}"^^<xs:float> .'
              for i in range(80)]
    quads += [f'_:n{i} <score> "{(i * 7) % 50}"^^<xs:int> .'
              for i in range(80) if i % 5]
    quads += [f"_:n{i} <boss> _:n{(i * 11 + 4) % 23} ." for i in range(80)]
    for i in range(80):
        for attr, mul, off in (("p0", 3, 1), ("p1", 5, 2), ("p2", 7, 3)):
            for k in range(3):
                t = (i * mul + off + k) % 80
                facet = ' (w=%d)' % (k + 1) if attr == "p0" else ""
                quads.append(f"_:n{i} <{attr}> _:n{t}{facet} .")
        for j in sorted(rng.choice(80, size=3, replace=False)):
            if j != i:
                quads.append(f"_:n{i} <follows> _:n{j} .")
    return "\n".join(quads)


@pytest.fixture(scope="module")
def quad():
    made = []
    for cls, mesh in ((JNode, 0), (JNode, 8), (TNode, 0), (TNode, 8)):
        kw = {"device": "cpu"} if cls is TNode else {}
        n = cls(mesh_devices=mesh, mesh_min_edges=1, **kw)
        n.alter(schema_text=SCHEMA)
        n.mutate(set_nquads=_quads(), commit_now=True)
        n.task_cache = n.result_cache = None
        made.append(n)
    yield made
    for n in made:
        n.close()


KEYS = ("dgraph_mesh_dispatches_total", "dgraph_mesh_fused_hops_total",
        "dgraph_mesh_traversed_edges_total",
        "dgraph_mesh_program_builds_total",
        "dgraph_mesh_fused_queries_total",
        "dgraph_mesh_unfused_queries_total",
        "dgraph_agg_terminal_ops_total")


def _state(n):
    return ({k: n.metrics.counter(k).value for k in KEYS},
            n.metrics.keyed("dgraph_mesh_fallbacks_total",
                            labels=("reason",)).snapshot())


def _run(quad, q, **kw):
    """All four Nodes answer q with the same bytes; returns the per-counter
    deltas of the JAX and port mesh Nodes (which must be equal) and the
    JSON."""
    jp, jm, tp, tm = quad
    before = [_state(n) for n in (jm, tm)]
    outs = [json.dumps(n.query(q, **kw)[0], sort_keys=True, default=str)
            for n in (jp, jm, tp, tm)]
    assert len(set(outs)) == 1, (q, outs)
    after = [_state(n) for n in (jm, tm)]
    deltas = [{k: a[0][k] - b[0][k] for k in KEYS}
              for a, b in zip(after, before)]
    assert deltas[1] == deltas[0], q
    assert after[1][1] == after[0][1], q
    return deltas[1], json.loads(outs[0])


# ---------------------------------------------------------------------------
# fused shapes (tests/test_fused_plan.py): byte identity + ONE dispatch
# ---------------------------------------------------------------------------

FUSED_BATTERY = [
    '{ q(func: eq(name, "node3")) { p0 @filter(ge(rating, 3.0)) '
    '{ p1 @filter(lt(rating, 8.0)) { p2 } } } }',
    '{ q(func: eq(name, "node3")) { p0 @filter(uid(0x1,0x2,0x3,0x10)) '
    '{ p1 { p2 } } } }',
    '{ q(func: eq(name, "node3")) { p0 @filter(NOT eq(name, "node10")) '
    '{ p1 @filter(has(rating) AND ge(rating, 1.0)) { p2 } } } }',
    '{ q(func: eq(name, "node3")) { p0 @filter(ge(count(p1), 3)) '
    '{ p1 { p2 } } } }',
    '{ q(func: eq(name, "node3")) { p0 @filter(le(count(p1), 0)) '
    '{ p1 { p2 } } } }',
    '{ q(func: eq(name, "node3")) { p0 (first: 2) '
    '{ p1 (first: 1, offset: 1) { p2 } } } }',
    '{ q(func: eq(name, "node3")) { p0 (first: -2) { p1 { p2 } } } }',
    '{ q(func: eq(name, "node3")) { p0 @filter(ge(rating, 2.0)) '
    '(first: 2, offset: 1) { p1 { p2 } } } }',
    '{ q(func: eq(name, "node3")) { p0 @facets(w) { p1 { p2 } } } }',
    '{ q(func: eq(name, "node3")) { name p0 { name rating '
    'p1 { p2 { name } } } } }',
    '{ q(func: eq(name, "node3")) { p0 { count(p1) p1 { p2 } } } }',
    '{ q(func: eq(name, "node3")) { p0 { v as p1 { p2 } } } '
    ' r(func: uid(v), first: 3) { name } }',
    '{ q(func: eq(name, "node5")) { p2 @filter(ge(rating, 1.0)) '
    '{ ~p2 } } }',
    '{ q(func: eq(name, "node3")) { p0 (orderasc: rating) '
    '{ p1 { p2 } } } }',
]


@pytest.mark.parametrize("qi", range(len(FUSED_BATTERY)))
def test_fused_battery_equals_jax_one_dispatch(quad, qi):
    d, _ = _run(quad, FUSED_BATTERY[qi])
    assert d["dgraph_mesh_dispatches_total"] == 1


def test_fuzz_grid_filter_pagination_facets(quad):
    """Filter × pagination × facet-read combinations on a 2-hop chain."""
    filters = ["", "@filter(ge(rating, 2.0))",
               "@filter(uid(0x2, 0x5, 0x9, 0x11))",
               "@filter(NOT le(rating, 4.0))",
               "@filter(eq(count(p2), 3) OR ge(rating, 8.0))"]
    pags = ["", "(first: 2)", "(first: 2, offset: 1)", "(first: -1)"]
    for f in filters:
        for p in pags:
            for fc in ("", "@facets(w)"):
                _run(quad, '{ q(func: eq(name, "node7")) { p0 %s %s %s '
                           '{ p1 { uid } } } }' % (fc, f, p))


@pytest.mark.parametrize("q", [
    '{ q(func: eq(name, "node1")) @recurse(depth: 3) '
    '{ name follows @filter(ge(rating, 1.0)) } }',
    '{ q(func: eq(name, "node1")) @recurse(depth: 4) { rating follows } }',
    '{ q(func: eq(name, "node1")) @recurse(depth: 3, loop: true) '
    '{ follows } }',
], ids=["filter", "val_child", "loop"])
def test_recurse_filter_and_val_children(quad, q):
    d, _ = _run(quad, q)
    assert d["dgraph_mesh_dispatches_total"] == 1


@pytest.mark.parametrize("q", [
    '{ p as shortest(from: 0x1, to: 0x30) { follows } '
    ' r(func: uid(p)) { uid } }',
    '{ p as shortest(from: 0x1, to: 0x30) { follows p0 } '
    ' r(func: uid(p)) { uid } }',
    '{ p as shortest(from: 0x1, to: 0x30, numpaths: 2) { follows } '
    ' r(func: uid(p)) { uid } }',
    '{ p as shortest(from: 0x1, to: 0x999) { follows } '
    ' r(func: uid(p)) { uid } }',
], ids=["single", "multi_pred", "k2", "unreachable"])
def test_shortest_one_dispatch_all_variants(quad, q):
    d, _ = _run(quad, q)
    assert d["dgraph_mesh_dispatches_total"] == 1


@pytest.mark.parametrize("q,reason", [
    ('{ q(func: eq(name, "node3")) { p0 @facets(eq(w, 1)) '
     '{ p1 { p2 } } } }', "facet"),
    ('{ q(func: eq(name, "node3")) { p0 { x as p1 '
     '{ p2 @filter(uid(x)) } } } }', "var"),
    ('{ q(func: eq(name, "node1")) @recurse(depth: 2) { follows p0 } }',
     "multi_pred"),
    ('{ q(func: eq(name, "node3")) { p0 { p1 @groupby(name) '
     '{ count(uid) } } } }', "groupby"),
    ('{ q(func: eq(name, "node3")) { p0 { p1 @groupby(p2, follows) '
     '{ count(uid) } } } }', "groupby"),
    ('{ q(func: eq(name, "node3")) { p0 { p1 @groupby(p2) '
     '{ count(uid) name } } } }', "agg"),
], ids=["facet", "var", "multi_pred", "value_key", "multi_key",
        "non_agg_child"])
def test_fallbacks_labeled_as_jax(quad, q, reason):
    jm, tm = quad[1], quad[3]
    before = _state(tm)[1].get(reason, 0)
    _run(quad, q)
    assert _state(tm)[1].get(reason, 0) > before
    assert _state(tm)[1] == _state(jm)[1]


def test_plan_cache_carries_fused_ir(quad):
    """The plan holds the chain IR (fused_chains, as in the JAX plan), and
    a plan-cache hit still runs one mesh program."""
    from dgraph_tpu.query import dql as jdql
    from dgraph_tpu.query import planner as jpl
    from dgraph_tpu_torch.query import dql as tdql
    from dgraph_tpu_torch.query import planner as tpl

    jp, jm, tp, tm = quad
    q = ('{ q(func: eq(name, "n")) { p0 @filter(ge(rating, 2.0) AND NOT '
         'uid(0x1)) (first: 2) { p1 @groupby(p2) { count(uid) } } } }')
    jreq, treq = jdql.parse(q), tdql.parse(q)
    jplan = jpl.build_plan(jreq, jm.snapshot(), jm.store.schema)
    tplan = tpl.build_plan(treq, tm.snapshot(), tm.store.schema)
    jir = jplan.fused_chains[id(jreq.queries[0])]
    tir = tplan.fused_chains[id(treq.queries[0])]
    assert [(h.attr, h.formula, h.first, [lf.kind for lf in h.leaves])
            for h in tir.hops] == \
        [(h.attr, h.formula, h.first, [lf.kind for lf in h.leaves])
         for h in jir.hops]
    assert tir.terminal.key_attr == jir.terminal.key_attr == "p2"
    q = '{ q(func: eq(name, "node9")) { p0 { p1 { p2 } } } }'
    c = tm.metrics.counter("dgraph_mesh_dispatches_total")
    _run(quad, q)
    hits0 = tm.metrics.counter("dgraph_planner_cache_hits_total").value
    d0 = c.value
    _run(quad, q)
    assert c.value - d0 == 1
    assert tm.metrics.counter(
        "dgraph_planner_cache_hits_total").value > hits0


def test_formula_evaluator_serves_numpy_and_tensors():
    """One formula evaluator for the device masks and the host replay."""
    from dgraph_tpu.query import fusedplan as jfp

    f = ("or", ("not", ("leaf", 0)), ("and", ("leaf", 0), ("leaf", 1)))
    a = np.asarray([True, False, True, False])
    b = np.asarray([True, True, False, False])
    want = jfp.eval_formula_np(f, [a, b]).tolist()
    assert tfp.eval_formula_np(f, [a, b]).tolist() == want
    assert tfp.eval_formula_np(
        f, [torch.from_numpy(a), torch.from_numpy(b)]).tolist() == want


def test_debug_metrics_mesh_section_and_prom_labels(quad):
    from dgraph_tpu.api.http import _serving_metrics as jserving
    from dgraph_tpu_torch.api.http import _serving_metrics as tserving

    # one fused and one unfused query, so the coverage lies strictly
    # between 0 and 1 whichever tests ran on these Nodes before
    _run(quad, '{ q(func: eq(name, "node3")) { p0 { p1 { p2 } } } }')
    _run(quad, '{ q(func: eq(name, "node3")) { p0 @facets(eq(w, 1)) '
               '{ p1 { p2 } } } }')
    jm, tm = quad[1], quad[3]
    a, b = jserving(jm)["mesh"], tserving(tm)["mesh"]
    assert b == a
    assert b["enabled"] and b["devices"] == 8
    assert 0.0 < b["fused_coverage_ratio"] < 1.0
    text = tprom.render(tm.metrics)
    assert 'reason="facet"' in text
    assert any(k.startswith("dgraph_mesh_fallbacks_total")
               for k in tprom.parse(text))


# ---------------------------------------------------------------------------
# the groupby terminal (tests/test_agg_terminal.py), [uid] and uid keys
# ---------------------------------------------------------------------------

TERMINAL_BATTERY = [
    '{ q(func: eq(name, "node3")) { p0 @groupby(p2) { count(uid) } } }',
    '{ q(func: eq(name, "node3")) { p0 { p1 @groupby(p2) '
    '{ count(uid) } } } }',
    '{ q(func: eq(name, "node3")) { p0 @filter(ge(rating, 2.0)) '
    '{ p1 @groupby(p2) { count(uid) } } } }',
    '{ var(func: has(name)) { r as rating } '
    '  q(func: eq(name, "node3")) { p0 { p1 @groupby(p2) '
    '{ count(uid) s: sum(val(r)) m: min(val(r)) x: max(val(r)) '
    '  a: avg(val(r)) } } } }',
    '{ var(func: has(name)) { sc as score } '
    '  q(func: eq(name, "node3")) { p0 { p1 @groupby(p2) '
    '{ count(uid) t: sum(val(sc)) mn: min(val(sc)) } } } }',
    '{ var(func: has(name)) { r as rating } '
    '  q(func: eq(name, "node3")) { p0 @groupby(p2) '
    '{ x: max(val(r)) } } }',
    # a single `uid` key
    '{ var(func: has(name)) { sc as score } '
    '  q(func: eq(name, "node3")) { p0 @groupby(boss) '
    '{ count(uid) t: sum(val(sc)) mx: max(val(sc)) } } }',
    '{ q(func: eq(name, "node3")) { p0 { p1 @groupby(boss) '
    '{ count(uid) } } } }',
]


@pytest.mark.parametrize("qi", range(len(TERMINAL_BATTERY)))
def test_terminal_battery_equals_jax_one_dispatch(quad, qi):
    d, _ = _run(quad, TERMINAL_BATTERY[qi])
    assert d["dgraph_mesh_dispatches_total"] == 1
    assert d["dgraph_agg_terminal_ops_total"] == 1


@pytest.mark.parametrize("qi", [3, 4, 6])
def test_terminal_cross_checks_run_on_uid_keys(quad, monkeypatch, qi):
    """The device terminal's key table, counts and agg candidates reach
    both cross-checks over a non-trivial group set, and agree with the
    host assembly (the port holds [uid] keys in rank space)."""
    tm = quad[3]
    seen = {"counts": [], "aggs": 0}
    orig_c, orig_a = tgb._fused_check_counts, tgb._check_fused_agg

    def spy_c(fused, row_seeds, members_per):
        seen["counts"].append((len(fused["table"]), len(row_seeds)))
        return orig_c(fused, row_seeds, members_per)

    def spy_a(*a, **kw):
        seen["aggs"] += 1
        return orig_a(*a, **kw)

    monkeypatch.setattr(tgb, "_fused_check_counts", spy_c)
    monkeypatch.setattr(tgb, "_check_fused_agg", spy_a)
    _run(quad, TERMINAL_BATTERY[qi])
    assert seen["counts"] and seen["counts"][0][0] >= 2 \
        and seen["counts"][0][1] >= 2
    assert seen["aggs"] >= 1


def test_terminal_cross_check_has_teeth(quad, monkeypatch):
    """A corrupted device count vector is a QueryError in both packages."""
    jm, tm = quad[1], quad[3]
    errs = []
    for node, mod, err in ((jm, jgb, JQueryError), (tm, tgb, TQueryError)):
        orig = mod._fused_check_counts

        def corrupt(fused, row_seeds, members_per, _o=orig):
            fused = dict(fused, counts=np.asarray(fused["counts"]) + 1)
            return _o(fused, row_seeds, members_per)

        monkeypatch.setattr(mod, "_fused_check_counts", corrupt)
        with pytest.raises(err) as ei:
            node.query(TERMINAL_BATTERY[0])
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("root", ['eq(name, "node1")', 'eq(name, "node42")',
                                  'uid(0x1)', 'uid(0x1, 0x9, 0x20)'])
@pytest.mark.parametrize("key", ["p2", "p1", "boss"])
def test_terminal_fuzz_roots(quad, root, key):
    _run(quad, '{ var(func: has(name)) { r as rating } '
               '  q(func: %s) { p0 { follows @groupby(%s) '
               '{ count(uid) s: sum(val(r)) } } } }' % (root, key))


def test_non_numeric_val_var_stays_host_side(quad):
    _run(quad, '{ var(func: has(name)) { nm as name } '
               '  q(func: eq(name, "node3")) { p0 @groupby(p2) '
               '{ count(uid) w: min(val(nm)) } } }')


def test_root_groupby_rows_equal_jax(quad):
    """A root-level @groupby renders its rows: the same bytes."""
    _, out = _run(quad, '{ q(func: has(name)) @groupby(p2) '
                        '{ count(uid) } }')
    assert len(out["q"][0]["@groupby"]) > 2


@pytest.mark.parametrize("q", [
    '{ q(func: has(name)) @groupby(p2) { count(uid) } }',
    '{ var(func: has(name)) { r as rating } '
    '  q(func: eq(name, "node3")) { p0 @groupby(p2) '
    '{ count(uid) s: sum(val(r)) } } }',
], ids=["root", "child_level"])
def test_explain_groupby_rows_equal_jax(quad, q):
    """EXPLAIN's groupby step (desc, estimate, actual, aggregate count) on
    the mesh Nodes reads as the JAX mesh Node's."""
    jm, tm = quad[1], quad[3]

    def rows(node):
        out, _ = node.query(q, explain=True)
        found = []

        def walk(blk):
            if isinstance(blk, dict):
                if "groupby" in blk and isinstance(blk["groupby"], dict):
                    g = blk["groupby"]
                    found.append((g.get("desc"), g.get("est"),
                                  g.get("actual"), g.get("aggs")))
                for v in blk.values():
                    walk(v)
            elif isinstance(blk, list):
                for v in blk:
                    walk(v)

        walk(out["explain"])
        return found

    got = rows(tm)
    assert got and got == rows(jm)
    assert got[0][0] == "p2" and got[0][3] >= 1
