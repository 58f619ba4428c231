"""Cost-based query planner: order decisions from live cardinality stats.

Port of dgraph_tpu/query/planner.py. The plan also carries the
mesh-fusable chain IR of each block (`fused_chains`, query/fusedplan.py),
so a plan-cache hit hands the mesh executor its IR without a tree walk.

The engine executes whatever order the query text happens to use:
`Executor._run_root_func` takes the root function at face value,
`_eval_filter` walks the AND/OR tree in parse order, and
`_process_children` expands siblings in declaration order — the same
fixed-order recursion as the reference's query.ProcessGraph
(query/query.go:1831). On a predicate-sharded graph the work difference
between a good and a bad order is orders of magnitude (a `has(film)`
tablet scan vs an `eq` index probe of 3 uids); classic results (Selinger
et al.; Leis et al.) show cheap cardinality estimates capture most of
that gap. This module consumes a parsed request plus per-predicate stats
(storage/stats.py) and emits an ordered physical plan:

  * ROOT-SOURCE SELECTION — when the root function is an expensive source
    (a `has` tablet scan) and some AND-filter leaf is a much more
    selective index-probe, the plan swaps them: the probe becomes the
    root and the original root function re-enters the filter tree at the
    probe's old position. Sound because every filter function evaluates
    POINTWISE (membership of u depends only on u — engine._eval_filter_func
    intersects with the frontier), so root ∩ filters is symmetric.
  * MOST-SELECTIVE-FIRST AND ORDERING with short-circuit frontier
    intersection — AND children evaluate in ascending estimated
    cardinality and each child sees the frontier already narrowed by its
    predecessors (pointwise ⇒ identical result set, far less work).
  * SIBLING-EXPANSION ORDERING — independent child expansions run
    cheapest-estimate-first (result slots are restored to declaration
    order, so output bytes are unchanged). Skipped whenever a sibling
    defines or consumes a query variable (vars bind in sibling order).
  * HOST/DEVICE DISPATCH CUTOVER — the static HOST_EXPAND_MAX threshold
    in query/task.py becomes an estimated-frontier-size-driven choice:
    expansions the stats say stay moderate keep the host gather (no
    dispatch latency), genuinely large ones keep the device path.

Plans never change semantics, only order — stale stats can cost time but
never correctness. `--no_planner` (Node(planner=False)) restores exact
parse-order execution. The EXPLAIN surface (`?explain=true`,
Node.query(explain=True)) renders the plan tree with estimated vs actual
per-step cardinalities; every decision increments a counter and feeds the
estimation-error histogram on /debug/metrics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from dgraph_tpu_torch.obs import otrace
from dgraph_tpu_torch.query import dql
from dgraph_tpu_torch.storage import stats as stmod

# a filter probe must look this many times cheaper than the root source
# before the plan swaps them (estimates are upper bounds; don't churn the
# root for marginal wins)
ROOT_SWAP_FACTOR = 4

# dispatch-cutover policy: expansions estimated below DEVICE_MIN_EDGES
# prefer the host gather even past the static 64k threshold (the fixed
# per-dispatch + sync cost outweighs the gather); past it, the device
# path keeps the static cutover
DEVICE_MIN_EDGES = 1 << 20

_INDEX_FUNCS = frozenset({"eq", "le", "lt", "ge", "gt", "anyofterms",
                          "allofterms", "anyoftext", "alloftext",
                          "regexp", "near", "within", "contains",
                          "intersects", "similar_to"})
# functions safe to PROMOTE to the root position: frontier-independent
# index probes (uid/val/count shapes read executor state; has is a scan —
# never an upgrade). similar_to qualifies: its filter form evaluates as
# global-top-k ∩ frontier, which is pointwise in the frontier.
_ROOT_SWAPPABLE = frozenset({"eq", "le", "lt", "ge", "gt", "anyofterms",
                             "allofterms", "anyoftext", "alloftext",
                             "regexp", "similar_to"})


@dataclass
class Step:
    """One planned step: estimate now, actual recorded at execution."""

    kind: str                  # "root" | "filter" | "expand"
    desc: str
    est: int
    extra: dict = field(default_factory=dict)


@dataclass
class RootSwap:
    new_func: dql.Function     # the promoted index probe
    orig_func: dql.Function    # the demoted root source
    leaf_id: int               # id(FilterTree leaf) the probe came from


class Plan:
    """The physical plan for one parsed request. Keyed on AST-node object
    ids — valid exactly as long as `req` (held here) is the tree being
    executed, which the plan cache guarantees (qcache.PlanCache.plan
    checks request identity). Read-only during execution; many queries
    share one cached plan concurrently."""

    def __init__(self, req, metrics=None) -> None:
        self.req = req
        self.metrics = metrics
        self.nodes: dict[int, Step] = {}
        self.and_order: dict[int, list[int]] = {}
        self.root_swap: dict[int, RootSwap] = {}
        self.child_order: dict[int, list[int]] = {}
        self.cutover: dict[int, int] = {}
        # fusable-step IR (query/fusedplan.py): the maximal mesh-fusable
        # chain below each block level, compiled from the AST once and
        # cached with the plan — mesh-mode engines consume it instead of
        # re-walking the tree per query
        self.fused_chains: dict[int, object] = {}
        self.tree: list[dict] = []
        self.pred_stats: dict[str, dict] = {}   # EXPLAIN stats header

    def record(self, ast_node, actual: int, recorder=None,
               bound: int | None = None) -> None:
        """Executor hook: actual cardinality of one planned step. Feeds
        the estimation-error histogram and, when an EXPLAIN recorder is
        active, the per-query actuals (the shared plan stays pristine).

        bound: the input frontier size at execution time — a filter's
        result can never exceed it, so the error compares the actual
        against min(est, bound), not the absolute-universe estimate."""
        sid = id(ast_node)
        step = self.nodes.get(sid)
        if step is None:
            return
        if recorder is not None:
            recorder[sid] = int(actual)
        est = step.est if bound is None else min(step.est, int(bound))
        if self.metrics is not None:
            err = abs(math.log2((int(actual) + 1) / (est + 1)))
            self.metrics.histogram(
                "dgraph_planner_est_error_log2").observe(err)
        sp = otrace.current()
        if sp is not None:
            # est-vs-actual per executed plan step rides the span timeline
            # (instant events in the Perfetto export / slow-query tree)
            sp.event("plan_step", kind=step.kind, desc=step.desc,
                     est=int(est), actual=int(actual))


# ---------------------------------------------------------------------------
# cardinality estimation
# ---------------------------------------------------------------------------

def _fn_desc(fn: dql.Function) -> str:
    arg = ""
    if fn.args:
        a0 = fn.args[0]
        arg = f", {a0!r}" if not isinstance(a0, dql.VarRef) \
            else f", val({a0.name})"
    inner = f"count({fn.attr})" if fn.is_count else fn.attr
    return f"{fn.name}({inner}{arg})"


def _est_func(fn: dql.Function, snap, schema, metrics,
              frontier_est: int) -> tuple[int, str, bool]:
    """(estimated result cardinality, source label, frontier_dependent).

    frontier_dependent marks leaves whose evaluation COST scales with the
    current frontier (value compares, count probes, var filters) — they
    sort after absolute index probes of similar cardinality."""
    name = fn.name.lower()
    attr = fn.attr
    rev = attr.startswith("~")
    pd = snap.pred(attr[1:] if rev else attr)
    if name == "uid":
        uids, refs = dql._split_uid_args(fn.args)
        return (len(uids) + 32 * len(refs)) or 1, "uid list", True
    if fn.is_valvar:
        return max(frontier_est // 2, 1), "value var", True
    if pd is None:
        return 0, "empty predicate", False
    st = stmod.pred_stats(pd, metrics)
    if fn.is_count:
        return max(st.has_card // 8, 1), "count probe", True
    if name == "has":
        card = st.rev.n_subjects if rev else st.has_card
        return card, "tablet scan", st.type_name not in ("UID",)
    if name in ("eq", "le", "lt", "ge", "gt"):
        try:
            from dgraph_tpu_torch.query import task as taskmod

            prefs = ("int", "float", "bool", "exact", "hash", "term",
                     "year", "month", "day", "hour") if name == "eq" else \
                ("int", "float", "exact", "year", "month", "day", "hour")
            total = 0
            args = fn.args if name == "eq" else fn.args[:1]
            for a in args:
                v = taskmod._parse_arg_val(pd, schema, a)
                tok_name, toks = taskmod._tokens_for(pd, schema, v, prefs)
                ti = pd.indexes.get(tok_name)
                if ti is None or not toks:
                    continue
                if name == "eq":
                    total += sum(stmod.term_freq(ti, t) for t in toks)
                else:
                    total += stmod.range_count(ti, name, toks[0])
            return total, "index probe", False
        except Exception:
            # unindexed / unconvertible: a frontier value compare
            return max(st.value_count // 4, 1), "value compare", True
    if name in ("anyofterms", "allofterms", "anyoftext", "alloftext"):
        tok_name = "term" if name.endswith("terms") else "fulltext"
        ti = pd.indexes.get(tok_name)
        if ti is None:
            return 0, "index probe", False
        try:
            from dgraph_tpu_torch.utils import tok as tokmod
            from dgraph_tpu_torch.utils.types import TypeID, Val

            tz = tokmod.get(tok_name)
            toks = [t[1:] for t in tz.tokens(
                Val(TypeID.STRING, str(fn.args[0])))]
            freqs = [stmod.term_freq(ti, t) for t in toks]
            if not freqs:
                return 0, "index probe", False
            est = min(freqs) if name in ("allofterms", "alloftext") \
                else sum(freqs)
            return est, "index probe", False
        except Exception:
            return st.index_postings.get(tok_name, 0), "index scan", False
    if name == "regexp":
        ti = pd.indexes.get("trigram")
        full = st.index_postings.get("trigram", 0)
        if ti is None:
            return 0, "index probe", False
        try:
            from dgraph_tpu_torch.query.task import _trigram_plan

            plan = _trigram_plan(str(fn.args[0]))
            if plan is None:
                return full, "index scan", False
            est = sum(min((stmod.term_freq(ti, t.encode()) for t in tris),
                          default=0) for tris in plan)
            return est, "index probe", False
        except Exception:
            return full, "index scan", False
    if name in ("near", "within", "contains", "intersects"):
        return max(st.index_postings.get("geo", 0) // 4, 1), \
            "index probe", False
    if name == "similar_to":
        # top-k probe over the vector index: at most k results (exactly k
        # when the tablet has >= k embeddings). A vector predicate with no
        # index rows at this snapshot estimates 0 — and when stats are
        # absent entirely the plan simply costs it 0, never raises: the
        # executor (not the planner) owns similar_to's typed errors.
        k = next((int(a) for a in fn.args
                  if isinstance(a, int) and not isinstance(a, bool)), 0)
        if st.vector_rows <= 0:
            return 0, "index probe", False
        return max(min(k or 1, st.vector_rows), 1), "index probe", False
    if name in ("uid_in", "checkpwd"):
        return max(frontier_est // 2, 1), "frontier probe", True
    return st.has_card, "tablet scan", True


def _leaf_fn(ft: dql.FilterTree, swap) -> dql.Function:
    """The function a filter leaf will EXECUTE: the demoted root when the
    leaf's probe was promoted (engine._eval_filter substitutes the same
    way), else the leaf's own."""
    if swap is not None and id(ft) == swap.leaf_id:
        return swap.orig_func
    return ft.func


def _est_filter(ft: dql.FilterTree | None, snap, schema, metrics,
                frontier_est: int, swap=None) -> int:
    """Estimated cardinality of a whole filter subtree (upper bound)."""
    if ft is None:
        return frontier_est
    if ft.func is not None:
        est, _src, dep = _est_func(_leaf_fn(ft, swap), snap, schema,
                                   metrics, frontier_est)
        return min(est, frontier_est) if not dep else min(
            max(est, 1), frontier_est)
    ests = [_est_filter(c, snap, schema, metrics, frontier_est, swap)
            for c in ft.children]
    if ft.op == "and":
        return min(ests) if ests else frontier_est
    if ft.op == "or":
        return min(sum(ests), frontier_est)
    if ft.op == "not":
        return max(frontier_est - (ests[0] if ests else 0), 0)
    return frontier_est


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------

def build_plan(req, snap, schema, metrics=None, top_k: int = 8,
               trace=None) -> Plan:
    """Plan every block of a parsed request against one snapshot's stats."""
    plan = Plan(req, metrics)
    for gq in req.queries:
        blk = _plan_block(plan, gq, snap, schema, metrics, trace,
                          frontier_est=None)
        plan.tree.append(blk)
    # EXPLAIN stats header: the read set's live stats, with the top-K
    # term-frequency sketch per index tokenizer
    from dgraph_tpu_torch.query.qcache import plan_attrs

    for attr in (plan_attrs(req) or ()):
        pd = snap.pred(attr)
        if pd is None:
            continue
        d = stmod.pred_stats(pd, metrics).to_dict()
        if top_k:
            d["top_terms"] = {name: stmod.topk_terms(ti, top_k)
                              for name, ti in pd.indexes.items()}
        plan.pred_stats[attr] = d
    if metrics is not None:
        metrics.counter("dgraph_planner_plans_total").inc()
    return plan


def _snapshot_universe(snap, metrics) -> int:
    """Total has() cardinality across the snapshot — the root-estimate
    normalization. A lazy snapshot (storage/csr_build.LazyPreds) must NOT
    fold the world for a normalization constant: folded tablets use their
    live stats, pending ones a decode-free key-count hint. Order decisions
    only — results are identical either way (plan ≡ parse-order)."""
    preds = snap.preds
    folded = getattr(preds, "folded_values", None)
    if folded is None:
        return sum(stmod.pred_stats(pd, metrics).has_card
                   for pd in preds.values()) or 1
    total = sum(stmod.pred_stats(pd, metrics).has_card
                for pd in folded())
    for attr in preds.pending_attrs():
        total += preds.pending_card(attr)
    return total or 1


def _count(metrics, name: str) -> None:
    if metrics is not None:
        metrics.counter(name).inc()


def _printf(trace, msg: str, *args) -> None:
    if trace is not None:
        trace.printf(msg, *args)


def _plan_block(plan: Plan, gq, snap, schema, metrics, trace,
                frontier_est: int | None) -> dict:
    """Plan one block (root or nested child level); returns its explain
    subtree."""
    # -- root source ---------------------------------------------------------
    root_est = frontier_est if frontier_est is not None else 0
    source = "frontier"
    swapped = False
    if frontier_est is None:
        universe = _snapshot_universe(snap, metrics)
        root_est = universe
        parts = []
        if gq.uids:
            parts.append((len(gq.uids), "uid list"))
        if gq.root_uid_vars:
            parts.append((32 * len(gq.root_uid_vars), "uid var"))
        if gq.func is not None:
            est, src, _dep = _est_func(gq.func, snap, schema, metrics,
                                       universe)
            parts.append((est, src))
        root_est = sum(e for e, _ in parts) if parts else 0
        source = "+".join(s for _, s in parts) or "empty"
        swapped = _maybe_swap_root(plan, gq, snap, schema, metrics, trace,
                                   root_est)
        if swapped:
            sw = plan.root_swap[id(gq)]
            root_est, source, _ = _est_func(sw.new_func, snap, schema,
                                            metrics, universe)
            source += " (swapped root)"
    root_fn = plan.root_swap[id(gq)].new_func if swapped else gq.func
    root_step = Step("root", _fn_desc(root_fn) if root_fn is not None
                     else source, max(root_est, 0),
                     {"source": source, "swapped": swapped})
    if frontier_est is None:
        # nested levels keep their id(gq) slot for the expand step
        # (_plan_children registered it); only true roots execute one
        plan.nodes[id(gq)] = root_step
    # -- filters -------------------------------------------------------------
    swap = plan.root_swap.get(id(gq))
    filt_steps = _plan_filter(plan, gq.filter, snap, schema, metrics,
                              trace, max(root_est, 1), swap)
    dest_est = _est_filter(gq.filter, snap, schema, metrics,
                           max(root_est, 0), swap)
    dest_est = min(dest_est, max(root_est, 0))
    first = int(gq.args.get("first", 0))
    if first > 0:
        dest_est = min(dest_est, int(gq.args.get("offset", 0)) + first)
    # -- children ------------------------------------------------------------
    if gq.recurse is None and gq.shortest is None and gq.children:
        from dgraph_tpu_torch.query import fusedplan

        plan.fused_chains[id(gq)] = fusedplan.chain_ir(gq, schema)
    children = _plan_children(plan, gq, snap, schema, metrics, trace,
                              max(dest_est, 1))
    out = {"block": gq.alias or gq.attr or "q",
           "root": _step_ref(gq, root_step),
           "est_dest": int(dest_est),
           "filters": filt_steps,
           "children": children}
    if frontier_est is None and gq.groupby is not None:
        out["groupby"] = _plan_groupby(plan, gq, snap, schema, metrics,
                                       int(dest_est))
    return out


def _step_ref(node, step: Step) -> dict:
    return {"sid": id(node), "desc": step.desc, "est": step.est,
            **step.extra}


def _plan_groupby(plan: Plan, gq, snap, schema, metrics,
                  members_est: int) -> dict:
    """EXPLAIN step for a @groupby terminal: estimated group count =
    product of the key predicates' distinct-target cardinalities (uid
    keys: the reverse tablet's subject count; value keys: the value-table
    cardinality), capped by the member estimate — a level can't produce
    more non-empty groups than members. Recorded against the GroupBy AST
    node (query/groupby.process_groupby), so est-vs-actual renders like
    every other step."""
    est = 1
    for _alias, attr, _lang in gq.groupby.attrs:
        rev = attr.startswith("~")
        pd = snap.pred(attr[1:] if rev else attr)
        if pd is None:
            card = 1
        else:
            st = stmod.pred_stats(pd, metrics)
            card = (st.fwd.n_subjects if rev else st.rev.n_subjects) \
                or st.value_count or 1
        est *= max(int(card), 1)
    est = int(min(est, max(members_est, 1)))
    keys = ",".join(a for _x, a, _l in gq.groupby.attrs) or "()"
    naggs = sum(1 for c in gq.children
                if c.attr.startswith("__agg_") or
                (c.is_uid_node and c.is_count))
    step = Step("groupby", keys, est, {"aggs": naggs})
    plan.nodes[id(gq.groupby)] = step
    return _step_ref(gq.groupby, step)


def _maybe_swap_root(plan: Plan, gq, snap, schema, metrics, trace,
                     root_est: int) -> bool:
    """Promote the most selective AND-filter index probe to the root when
    it beats the declared root source by ROOT_SWAP_FACTOR. Only when the
    function is the SOLE root source (explicit uids / uid vars union with
    the root — swapping would change the result set) and the block is a
    plain one (recurse/shortest drive their own frontiers)."""
    if (gq.func is None or gq.uids or gq.root_uid_vars
            or gq.recurse is not None or gq.shortest is not None
            or gq.filter is None):
        return False
    fn = gq.func
    if fn.name.lower() == "uid" or fn.is_valvar:
        return False
    # candidate leaves: direct func children of a top-level AND (or the
    # single-leaf filter), root-runnable index probes only
    leaves: list[dql.FilterTree] = []
    if gq.filter.func is not None:
        leaves = [gq.filter]
    elif gq.filter.op == "and":
        leaves = [c for c in gq.filter.children if c.func is not None]
    best = None
    for leaf in leaves:
        f = leaf.func
        if (f.name.lower() not in _ROOT_SWAPPABLE or f.is_count
                or f.is_valvar):
            continue
        est, src, dep = _est_func(f, snap, schema, metrics, root_est)
        if dep or src != "index probe":
            continue
        if best is None or est < best[0]:
            best = (est, leaf)
    if best is None or best[0] * ROOT_SWAP_FACTOR >= max(root_est, 1):
        return False
    est, leaf = best
    plan.root_swap[id(gq)] = RootSwap(new_func=leaf.func,
                                      orig_func=fn, leaf_id=id(leaf))
    _count(metrics, "dgraph_planner_root_swaps_total")
    _printf(trace, "planner: root swap %s (est %d) <- %s (est %d)",
            _fn_desc(leaf.func), est, _fn_desc(fn), root_est)
    return True


def _plan_filter(plan: Plan, ft, snap, schema, metrics, trace,
                 frontier_est: int, swap: RootSwap | None) -> list[dict]:
    """Register Steps for every filter leaf and the AND-order decisions.
    Returns the explain entries in PLANNED evaluation order."""
    out: list[dict] = []
    if ft is None:
        return out
    if ft.func is not None:
        # the leaf EXECUTES the demoted root when its probe was promoted
        fn = _leaf_fn(ft, swap)
        est, src, dep = _est_func(fn, snap, schema, metrics, frontier_est)
        step = Step("filter", _fn_desc(fn), est,
                    {"source": src, "frontier_dependent": dep})
        plan.nodes[id(ft)] = step
        out.append(_step_ref(ft, step))
        return out
    if ft.op == "and":
        keyed = []
        for i, c in enumerate(ft.children):
            est = _est_filter(c, snap, schema, metrics, frontier_est,
                              swap)
            dep = not (c.func is not None and not _est_func(
                _leaf_fn(c, swap), snap, schema, metrics,
                frontier_est)[2])
            is_not = c.op == "not"
            # absolute index probes first (their cost ≈ their est),
            # frontier-scaled leaves after, NOT-subtrees last (their
            # cardinality is the complement — rarely selective)
            keyed.append(((is_not, dep, est, i), i, c))
        keyed.sort(key=lambda t: t[0])
        order = [i for _, i, _ in keyed]
        if order != list(range(len(ft.children))):
            plan.and_order[id(ft)] = order
            _count(metrics, "dgraph_planner_filter_reorders_total")
            _printf(trace, "planner: AND reorder %s", order)
        remaining = frontier_est
        for _, _i, c in keyed:
            out.extend(_plan_filter(plan, c, snap, schema, metrics, trace,
                                    max(remaining, 1), swap))
            remaining = min(remaining, _est_filter(
                c, snap, schema, metrics, max(remaining, 1), swap))
        return out
    for c in ft.children:       # or / not: parse order, shared frontier
        out.extend(_plan_filter(plan, c, snap, schema, metrics, trace,
                                frontier_est, swap))
    return out


def _subtree_uses_vars(gq) -> bool:
    """True when any node in gq's subtree defines or reads a query
    variable (or is a virtual/expand node) — variables bind in
    depth-first sibling order, so such subtrees must not be reordered."""
    if (gq.var_name or gq.expand or gq.is_uid_node or gq.needs_vars
            or gq.attr in ("val", "math") or gq.attr.startswith("__agg_")
            or gq.facets is not None or gq.val_ref
            or gq.math is not None):
        return True
    vars_in_filter: list[str] = []
    dql.collect_filter_vars(gq.filter, vars_in_filter)
    if vars_in_filter:
        return True
    return any(_subtree_uses_vars(c) for c in gq.children)


def _orderable_children(gq) -> bool:
    """Sibling reordering is safe only when no sibling SUBTREE defines or
    reads a query variable (a grandchild's `x as p` must still run before
    any consumer in a later sibling's subtree)."""
    return not any(_subtree_uses_vars(c) for c in gq.children)


def _plan_children(plan: Plan, gq, snap, schema, metrics, trace,
                   frontier_est: int) -> list[dict]:
    out: list[dict] = []
    ests: list[int] = []
    for cgq in gq.children:
        attr = cgq.attr
        rev = attr.startswith("~")
        pd = snap.pred(attr[1:] if rev else attr)
        if pd is None or cgq.is_uid_node or attr in ("val", "math") or \
                attr.startswith("__agg_") or cgq.expand:
            ests.append(0)
            out.append({"attr": attr, "virtual": True})
            continue
        st = stmod.pred_stats(pd, metrics)
        avg = st.rev.avg_degree if rev else st.avg_degree
        est_edges = int(frontier_est * avg) if avg else \
            min(frontier_est, st.value_count)
        step = Step("expand", attr, est_edges, {})
        plan.nodes[id(cgq)] = step
        ests.append(est_edges)
        # dispatch cutover: moderate expansions stay on the host gather
        # even past the static threshold; big ones keep the device path
        cut = 0
        uid_like = (st.fwd.n_edges if not rev else st.rev.n_edges) > 0
        if uid_like and est_edges:
            from dgraph_tpu_torch.query.task import HOST_EXPAND_MAX

            if HOST_EXPAND_MAX < est_edges < DEVICE_MIN_EDGES:
                cut = 1 << max(int(math.ceil(math.log2(
                    min(2 * est_edges, DEVICE_MIN_EDGES)))), 16)
                plan.cutover[id(cgq)] = cut
            _count(metrics,
                   "dgraph_planner_host_expands_total" if
                   (est_edges <= HOST_EXPAND_MAX or cut)
                   else "dgraph_planner_device_expands_total")
        ref = _step_ref(cgq, step)
        if cut:
            ref["cutover"] = cut
        if cgq.groupby is not None:
            ref["groupby"] = _plan_groupby(plan, cgq, snap, schema,
                                           metrics, est_edges)
        # nested levels: plan the grandchildren's filters/expansions too
        if cgq.children or cgq.filter is not None:
            child_frontier = max(min(est_edges,
                                     st.fwd.n_edges or est_edges), 1)
            sub = _plan_block(plan, cgq, snap, schema, metrics, trace,
                              frontier_est=child_frontier)
            ref["filters"] = sub["filters"]
            ref["children"] = sub["children"]
        out.append(ref)
    if len(gq.children) > 1 and _orderable_children(gq):
        order = sorted(range(len(ests)), key=lambda i: (ests[i], i))
        if order != list(range(len(ests))):
            plan.child_order[id(gq)] = order
            _count(metrics, "dgraph_planner_child_reorders_total")
            _printf(trace, "planner: sibling reorder %s", order)
    return out


# ---------------------------------------------------------------------------
# EXPLAIN rendering
# ---------------------------------------------------------------------------

def render_explain(plan: Plan, recorder: dict | None) -> dict:
    """The ?explain=true payload: the plan tree with estimated vs actual
    cardinalities per step (actual is null for steps never executed —
    short-circuited filters, cached levels)."""
    recorder = recorder or {}

    def walk(node):
        if isinstance(node, list):
            return [walk(x) for x in node]
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "sid":
                out["actual"] = recorder.get(v)
            else:
                out[k] = walk(v)
        return out

    return {"planner": "on",
            "decisions": {
                "root_swaps": len(plan.root_swap),
                "filter_reorders": len(plan.and_order),
                "sibling_reorders": len(plan.child_order),
                "cutover_overrides": len(plan.cutover)},
            "stats": plan.pred_stats,
            "blocks": walk(plan.tree)}
