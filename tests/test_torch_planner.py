"""The port's cost-based planner (query/planner.py) against the JAX
package's, on the CPU.

The cases of tests/test_planner.py on a port Node(device="cpu"), with a
JAX Node over the same film graph beside it (the JAX models/film.py data,
generated here for both): estimates, root swaps, AND orders, sibling
orders and cutovers must equal the JAX plan's on the same request and
snapshot, compared by step description (the plans key on AST node ids);
EXPLAIN JSON must equal the JAX Node's; and planned output must be
byte-identical to parse-order output and to the JAX Node's.
"""

import importlib.util
import json
import random
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.models.film import GENRES
from dgraph_tpu.query import dql as jdql
from dgraph_tpu.query import planner as jplanner

from dgraph_tpu_torch.api import http as thttp
from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.query import dql, planner
from dgraph_tpu_torch.storage import stats as stmod

REPO = Path(__file__).resolve().parents[1]
N_PEOPLE = 2000
FOLLOWS = 6


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _load("golden_battery_planner", REPO / "tests" / "test_golden.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _film(node, n_people=N_PEOPLE, follows=FOLLOWS, seed=2):
    """The JAX models/film.film_node graph, loaded into any Node."""
    node.alter(schema_text="name: string @index(exact) .\n"
                           "age: int @index(int) .\n"
                           "genre: string @index(exact) .\n"
                           "follows: [uid] .")
    rng = np.random.default_rng(seed)
    quads = []
    for i in range(n_people):
        quads.append(f'<0x{i + 1:x}> <name> "p{i}" .')
        quads.append(f'<0x{i + 1:x}> <age> "{18 + i % 60}"^^<xs:int> .')
        quads.append(f'<0x{i + 1:x}> <genre> "{GENRES[i % 4]}" .')
    src = rng.integers(1, n_people + 1, n_people * follows)
    dst = rng.integers(1, n_people + 1, n_people * follows)
    for s, d in zip(src.tolist(), dst.tolist()):
        quads.append(f"<0x{s:x}> <follows> <0x{d:x}> .")
    for lo in range(0, len(quads), 50000):
        node.mutate(set_nquads="\n".join(quads[lo: lo + 50000]),
                    commit_now=True)
    return node


@pytest.fixture(scope="module")
def pair():
    t = _film(TNode(device="cpu"))
    j = _film(JNode(batching=False, devprof=False))
    yield t, j
    t.close()
    j.close()


@pytest.fixture
def node(pair):
    return pair[0]


def _est(node, snap, fname, attr, *args, pkg=None, **kw):
    d, pl = (jdql, jplanner) if pkg == "jax" else (dql, planner)
    fn = d.Function(name=fname, attr=attr, args=list(args), **kw)
    return pl._est_func(fn, snap, node.store.schema, None, 10**9)


def _est_both(pair, fname, attr, *args, **kw):
    t, j = pair
    got = _est(t, t.snapshot(), fname, attr, *args, **kw)
    assert got == _est(j, j.snapshot(), fname, attr, *args, pkg="jax", **kw)
    return got


def _decisions(plan, req, pkg_planner):
    """A plan's decisions keyed by step description, not by id(): the
    explain tree (every step's desc, est, source, cutover) plus each
    decision table rendered in plan-building order."""
    tree = pkg_planner.render_explain(plan, None)

    def desc_of(node_id):
        step = plan.nodes.get(node_id)
        return step.desc if step is not None else None

    return {
        "tree": json.loads(json.dumps(tree, default=str)),
        "root_swap": [(pkg_planner._fn_desc(sw.new_func),
                       pkg_planner._fn_desc(sw.orig_func), desc_of(sw.leaf_id))
                      for sw in plan.root_swap.values()],
        "and_order": list(plan.and_order.values()),
        "child_order": list(plan.child_order.values()),
        "cutover": [(desc_of(k), v) for k, v in plan.cutover.items()],
    }


def _plans(pair, q):
    t, j = pair
    treq, jreq = dql.parse(q), jdql.parse(q)
    tplan = planner.build_plan(treq, t.snapshot(), t.store.schema)
    jplan = jplanner.build_plan(jreq, j.snapshot(), j.store.schema)
    return (tplan, treq), (jplan, jreq)


# ---------------------------------------------------------------------------
# estimation math
# ---------------------------------------------------------------------------

def test_eq_estimate_is_exact_term_frequency(pair):
    assert _est_both(pair, "eq", "name", "p7") == (1, "index probe", False)
    est, src, _ = _est_both(pair, "eq", "genre", "noir")
    assert src == "index probe" and est == N_PEOPLE // 4
    est2, _, _ = _est_both(pair, "eq", "genre", "noir", "drama")
    assert est2 == 2 * (N_PEOPLE // 4)


def test_inequality_estimate_counts_index_range(pair):
    est, src, dep = _est_both(pair, "ge", "age", 50)
    assert src == "index probe" and not dep
    actual, _ = pair[0].query('{ q(func: ge(age, 50)) { count(uid) } }')
    assert est == actual["q"][0]["count"]


def test_has_estimate_and_frontier_dependence(pair):
    est, src, dep = _est_both(pair, "has", "age")
    assert est == N_PEOPLE and src == "tablet scan" and dep
    est, src, dep = _est_both(pair, "has", "follows")
    assert src == "tablet scan" and not dep and est > 0


def test_absent_predicate_estimates_zero(pair):
    assert _est_both(pair, "eq", "nosuchpred", "x")[0] == 0


# ---------------------------------------------------------------------------
# ordering decisions, equal to the JAX plan's
# ---------------------------------------------------------------------------

CHAIN = ('{ q(func: has(age)) @filter(ge(count(follows), 1) AND '
         'eq(genre, "noir") AND eq(name, "p6")) { uid name } }')


def test_and_order_most_selective_first(pair):
    (plan, req), (jplan, jreq) = _plans(pair, CHAIN)
    gq = req.queries[0]
    sw = plan.root_swap.get(id(gq))
    assert sw is not None and sw.new_func.attr == "name"
    ft = gq.filter
    ordered = []
    for i in plan.and_order[id(ft)]:
        leaf = ft.children[i]
        fn = sw.orig_func if id(leaf) == sw.leaf_id else leaf.func
        ordered.append((fn.attr, fn.is_count))
    assert ordered == [("genre", False), ("follows", True), ("age", False)]
    assert _decisions(plan, req, planner) == \
        _decisions(jplan, jreq, jplanner)


def test_no_swap_when_uids_join_the_root(node):
    q = '{ q(func: has(age)) @filter(eq(name, "p6")) { uid } }'
    req = dql.parse(q)
    req.queries[0].uids = [1, 2]
    plan = planner.build_plan(req, node.snapshot(), node.store.schema)
    assert id(req.queries[0]) not in plan.root_swap


def test_sibling_order_skipped_when_vars_bind(node):
    req = dql.parse('{ q(func: eq(age, 30)) { x as age follows { uid } } }')
    plan = planner.build_plan(req, node.snapshot(), node.store.schema)
    assert id(req.queries[0]) not in plan.child_order
    assert not planner._orderable_children(req.queries[0])


def test_cutover_override_for_moderate_expansions(node):
    snap = node.snapshot()
    pd = snap.pred("follows")
    real = stmod.pred_stats(pd)
    fake = stmod.PredStats(
        attr="follows", type_name="UID",
        fwd=stmod.CSRStats(n_subjects=real.fwd.n_subjects,
                           n_edges=200_000),
        rev=stmod.CSRStats())
    pd.__dict__[stmod._STATS_ATTR] = fake
    try:
        req = dql.parse('{ q(func: has(age)) { follows { uid } } }')
        plan = planner.build_plan(req, snap, node.store.schema)
        cut = plan.cutover.get(id(req.queries[0].children[0]))
        assert cut is not None and cut > (1 << 16)
        assert cut <= planner.DEVICE_MIN_EDGES
    finally:
        pd.__dict__[stmod._STATS_ATTR] = real


PLAN_BATTERY = [
    CHAIN,
    '{ q(func: has(age)) @filter(eq(name, "p6")) { uid } }',
    '{ q(func: has(name)) @filter(eq(genre, "noir") AND ge(age, 70)) '
    '{ name follows { uid } genre } }',
    '{ q(func: eq(genre, "scifi"), first: 5) { follows { name age } '
    'name genre } }',
    '{ q(func: ge(age, 70)) @filter(NOT eq(genre, "drama") OR '
    'eq(name, "p9")) { uid } }',
    '{ q(func: has(follows)) @filter(has(genre) AND le(age, 20) AND '
    'eq(count(follows), 2)) { count(follows) } }',
    '{ q(func: eq(name, "p1")) { follows @filter(ge(age, 30) AND '
    'eq(genre, "noir")) { follows { uid } } } }',
    '{ a(func: has(age)) @filter(eq(name, "p3")) { uid } '
    'b(func: uid(0x1, 0x2)) { name age genre follows { uid } } }',
]


@pytest.mark.parametrize("q", PLAN_BATTERY,
                         ids=[f"q{i}" for i in range(len(PLAN_BATTERY))])
def test_plan_decisions_equal_jax(pair, q):
    (plan, req), (jplan, jreq) = _plans(pair, q)
    assert _decisions(plan, req, planner) == \
        _decisions(jplan, jreq, jplanner)
    assert json.dumps(plan.pred_stats, default=str) == \
        json.dumps(jplan.pred_stats, default=str)


# ---------------------------------------------------------------------------
# plan ≡ parse-order equivalence, and equal to the JAX Node
# ---------------------------------------------------------------------------

def _on_off(node, q):
    """Planner off, then on, with the task and result caches disabled (a
    cache hit would make the comparison vacuous)."""
    stash = (node.task_cache, node.result_cache)
    node.task_cache = node.result_cache = None
    try:
        node.planner_enabled = False
        off, _ = node.query(q)
        node.planner_enabled = True
        on, _ = node.query(q)
    finally:
        node.task_cache, node.result_cache = stash
    return json.dumps(off, sort_keys=True, default=str), \
        json.dumps(on, sort_keys=True, default=str)


def test_golden_corpus_equivalence():
    t = TNode(device="cpu")
    j = JNode(batching=False, devprof=False)
    try:
        for n in (t, j):
            n.alter(schema_text=GOLDEN.SCHEMA)
            n.mutate(set_nquads=GOLDEN._dataset(), commit_now=True)
        for qname, q in GOLDEN.QUERIES:
            off, on = _on_off(t, q)
            assert off == on, f"planner changed output of {qname!r}"
            assert on == _on_off(j, q)[1], qname
        assert t.metrics.counter("dgraph_planner_plans_total").value > 0
    finally:
        t.close()
        j.close()


def test_fuzz_seed_equivalence(pair):
    t, j = pair
    rng = random.Random(20260803)
    leaves = ['eq(genre, "noir")', 'eq(genre, "drama")', 'eq(name, "p6")',
              'ge(age, 40)', 'le(age, 30)', 'has(genre)', 'has(follows)',
              'ge(count(follows), 1)', 'eq(count(follows), 2)',
              'eq(name, "p100")', 'lt(age, 77)']
    roots = ['has(age)', 'has(name)', 'eq(genre, "scifi")', 'ge(age, 70)',
             'has(follows)']

    def tree(depth):
        if depth == 0 or rng.random() < 0.5:
            return rng.choice(leaves)
        op = rng.choice([" AND ", " OR "])
        parts = [tree(depth - 1) for _ in range(rng.randint(2, 3))]
        tr = "(" + op.join(parts) + ")"
        if rng.random() < 0.2:
            tr = f"(NOT {tr})"
        return tr

    for i in range(40):
        body = rng.choice(["uid", "uid name", "uid follows { uid }",
                           "name count(follows)"])
        q = (f'{{ q(func: {rng.choice(roots)}) @filter({tree(2)}) '
             f'{{ {body} }} }}')
        off, on = _on_off(t, q)
        assert off == on, q
        if i % 4 == 0:
            assert on == _on_off(j, q)[1], q


def test_child_filter_reorder_equivalence(pair):
    q = ('{ q(func: eq(age, 30), first: 10) { name follows '
         '@filter(ge(count(follows), 1) AND eq(genre, "noir") AND '
         'eq(name, "p6")) { uid } } }')
    off, on = _on_off(pair[0], q)
    assert off == on == _on_off(pair[1], q)[1]


# ---------------------------------------------------------------------------
# EXPLAIN surface + plan cache + flags
# ---------------------------------------------------------------------------

def test_explain_returns_est_vs_actual(pair):
    t, j = pair
    t.planner_enabled = j.planner_enabled = True
    out, _ = t.query(CHAIN, explain=True)
    ex = out["explain"]
    assert ex["planner"] == "on"
    assert ex["decisions"]["root_swaps"] >= 1
    assert ex["stats"]["name"]["subjects"] == 0
    assert ex["stats"]["name"]["values"] == N_PEOPLE
    assert len(ex["stats"]["genre"]["top_terms"]["exact"]) == 4
    blk = ex["blocks"][0]
    assert blk["root"]["swapped"] is True
    assert blk["root"]["est"] >= 0 and blk["root"]["actual"] is not None
    assert any(f["actual"] is not None for f in blk["filters"])
    # the whole EXPLAIN JSON (estimates, actuals, stats) equals JAX's
    jout, _ = j.query(CHAIN, explain=True)
    assert json.dumps(out, default=str) == json.dumps(jout, default=str)
    out2, _ = t.query(CHAIN)
    assert "explain" not in out2


def test_explain_planner_off():
    n = TNode(planner=False, device="cpu")
    n.alter(schema_text="name: string @index(exact) .")
    n.mutate(set_nquads='<0x1> <name> "a" .', commit_now=True)
    try:
        out, _ = n.query('{ q(func: has(name)) { uid } }', explain=True)
        assert out["explain"] == {"planner": "off"}
        assert n.metrics.counter("dgraph_planner_plans_total").value == 0
    finally:
        n.close()


def test_plan_cache_hits_and_invalidates(pair):
    node = pair[0]
    node.planner_enabled = True
    stash, node.result_cache = node.result_cache, None
    q = '{ q(func: has(age)) @filter(eq(name, "p9")) { uid } }'
    c = lambda name: node.metrics.counter(name).value
    node.query(q)
    h0 = c("dgraph_planner_cache_hits_total")
    node.query(q)
    node.result_cache = stash
    assert c("dgraph_planner_cache_hits_total") == h0 + 1
    m0 = c("dgraph_planner_cache_misses_total")
    for n in pair:        # both graphs stay equal for the later cases
        n.mutate(set_nquads=f'<0x{N_PEOPLE + 50:x}> <name> "fresh" .',
                 commit_now=True)
    node.query(q)
    assert c("dgraph_planner_cache_misses_total") == m0 + 1


def test_estimation_error_histogram_feeds(node):
    node.planner_enabled = True
    node.query(CHAIN)
    snap = node.metrics.histogram(
        "dgraph_planner_est_error_log2").snapshot()
    assert snap["count"] > 0


def test_http_explain_surface(pair):
    from dgraph_tpu.api import http as jhttp

    t, j = pair
    t.planner_enabled = j.planner_enabled = True
    srvs = [thttp.serve_forever(t, port=0), jhttp.serve_forever(j, port=0)]
    try:
        envs = []
        for srv in srvs:
            port = srv.server_address[1]
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/query?explain=true",
                data=CHAIN.encode())
            with urllib.request.urlopen(req, timeout=10) as r:
                envs.append(json.loads(r.read()))
        env, jenv = envs
        assert env["extensions"]["explain"]["planner"] == "on"
        assert "explain" not in env["data"]
        assert env["data"] == jenv["data"]
        assert env["extensions"]["explain"] == jenv["extensions"]["explain"]
        port = srvs[0].server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/metrics", timeout=10) as r:
            m = json.loads(r.read())
        assert m["planner"]["plans_built"] > 0
        assert "est_error_log2" in m["planner"]
    finally:
        for srv in srvs:
            srv.shutdown()
