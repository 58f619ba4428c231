"""Fusable-step IR: compile the planner's physical plan into mesh programs.

Port of dgraph_tpu/query/fusedplan.py, whole: host IR and the host replay.
eval_formula_np serves numpy arrays and torch bool tensors alike (both take
& | ~), so the device masks of parallel/mesh_exec.py and the host replay
share one formula evaluator.

A mesh program that fused only BARE uid chains would send any chain with
one filter, one facet key, or a `first:` argument back to per-task
dispatches, which is exactly the shape real traffic has. The fused regime
covers the whole physical plan: a chain hop may carry

  * POINTWISE FILTERS — every filter function this engine evaluates is
    pointwise (membership of u depends only on u; the planner's root-swap
    soundness argument, query/planner.py), so a filter tree compiles to a
    boolean FORMULA over sorted "allow-set" membership tests. The allow
    sets resolve host-side (index probes, value-table compares, degree
    scans — the control-plane data the host already mirrors), upload once
    (identity-cached per predicate state), and the device applies the
    formula per emitted edge inside the fused program: the next hop's
    frontier never comes back to the host between hops.
  * PAGINATION — `first` / `offset` apply per uidMatrix row among the
    filter-surviving positions (query/engine._apply_child_row_mods), a
    segmented-prefix window the device computes from the expand segment
    ids. Negative `first` (last-N) included; negative `offset` falls back.
  * FACET READS — facet tuples live in host dicts; the host tail attaches
    them to the kept edges after the fused dispatch (reads never break
    fusion; facet FILTERS still do — they prune on per-edge facet values
    the device does not hold).
  * CO-CHILDREN — value-predicate reads, count() children, val()/math
    virtuals riding chain levels are host/control-plane tasks layered on
    the fused traversal's per-level frontiers.

The IR is built from the AST once (planner.build_plan attaches it to the
cached Plan, so repeated queries skip the walk; engines without a plan
build it ad hoc) and is purely structural: tablet OWNERSHIP (mesh-sharded
vs replicated vs overlay) is checked at execution time, truncating the
chain where the placement stops covering it.

The host REPLAY (replay_hop) re-derives each level's pruned uidMatrix
from the host CSR mirrors with the same allow-sets and pagination windows
the device applied — result materialization is inherently ragged and
host-side by design (SURVEY §7), and byte-identity with the classic
per-task path holds by construction because both sides evaluate the same
pointwise membership on the same mirrors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.ops import uidset as us
from dgraph_tpu_torch.query import dql
from dgraph_tpu_torch.utils.types import TypeID

# fallback-reason vocabulary (dgraph_mesh_fallbacks_total{reason=...}):
# every way a mesh-relevant traversal can decline the fused program, so
# coverage gaps are enumerable from /metrics
REASON_FILTER = "filter"          # uncompilable filter leaf (checkpwd, ...)
REASON_FACET = "facet"            # facet FILTER mid-chain / facet cost key
REASON_PAGINATION = "pagination"  # negative offset (host-slice semantics)
REASON_OVERLAY = "overlay"        # delta-overlay tablet awaiting compaction
REASON_LANG = "lang"              # @lang on a uid expansion
REASON_CASCADE = "cascade"        # @cascade on an intermediate hop
REASON_BUDGET = "budget"          # residency deferred the tablet's shards
REASON_VAR = "var"                # filter reads a var defined in this block
REASON_SHAPE = "shape"            # branching chains / expand()
REASON_GROUPBY = "groupby"        # groupby shape outside the terminal regime
#                                   (multi-key / value key / lang / cascade)
REASON_AGG = "agg"                # aggregation child outside the terminal
#                                   ops (datetime min/max, string vals, ...)
REASON_DEPTH = "depth"            # recurse depth past the fused scan cap
REASON_MULTI_PRED = "multi_pred"  # multi-predicate @recurse (depth-first
#                                   dedup order is inherently sequential)


class Unfusable(Exception):
    """Raised by the IR compiler when a shape cannot ride the fused
    program; .reason is the dgraph_mesh_fallbacks_total label."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


@dataclass
class LeafSpec:
    """One filter leaf resolved to a sorted allow-set at execution time.

    kind: how the set resolves —
      uid     — uid literals + uid-var unions (per-query, engine vars)
      valvar  — value-var compare (per-query, engine vars)
      count   — degree scan over the (reverse) CSR; `invert` marks the
                zero-matches case (absent subjects satisfy the compare,
                so the set holds the FAILING subjects and the formula
                wraps it in NOT)
      has_uid — has(p) on a uid predicate: the tablet's subject set
      task    — value-predicate has/compare/uid_in: the exact
                process_task membership evaluated over the tablet's
                whole subject universe (host fast paths, cacheable)
      root    — frontier-independent index probe via the engine's
                root-function dispatch (task-cache backed)
    """

    kind: str
    fn: dql.Function
    invert: bool = False


@dataclass
class HopIR:
    """One fused chain hop: a uid expansion plus its riding features."""

    gq: dql.GraphQuery
    attr: str
    formula: tuple | None = None       # ("and"|"or"|"not"|"leaf", ...)
    leaves: list[LeafSpec] = field(default_factory=list)
    first: int = 0
    offset: int = 0
    facets: bool = False


@dataclass
class TerminalIR:
    """The chain's terminal segmented-reduce stage: a single-uid-key
    @groupby whose count(uid) / numeric __agg_* children reduce ON DEVICE
    into the key tablet's rank space as one more stage of the same mesh
    dispatch. The host assembly (query/groupby.py) stays authoritative —
    the device per-rank member counts and f32 agg candidates ride back
    for the byte-identity cross-check, and "top posters among
    friends-of-friends" becomes ONE dispatch end to end."""

    gq: dql.GraphQuery        # the groupby-bearing hop (id() keys plans)
    key_attr: str             # the single uid-type group-key predicate
    aggs: list = field(default_factory=list)  # [(op, val_ref, child_gq)]
    has_count: bool = False


@dataclass
class ChainIR:
    """A maximal fusable chain below one block level. hops < 2 means the
    fused program buys nothing over the single per-task dispatch (one hop
    + a terminal stage does); the stop reason (when set) names the
    feature that truncated the walk — recorded as a labeled fallback only
    when it actually cost fusion."""

    hops: list[HopIR] = field(default_factory=list)
    stop_reason: str | None = None
    # True when the rejected/terminal node's subtree holds MORE fusable
    # expansions — i.e. the stop reason truncated a real chain
    stop_cost: bool = False
    terminal: TerminalIR | None = None


# ---------------------------------------------------------------------------
# IR construction (AST-only; cacheable alongside the physical plan)
# ---------------------------------------------------------------------------

def _is_uid_expansion(cgq: dql.GraphQuery, schema) -> bool:
    """Does this child LOOK like a uid-adjacency expansion (the only step
    kind that can become a fused hop)? Ownership is an execution-time
    question; this is the AST-level shape test."""
    if (cgq.expand or cgq.is_uid_node or cgq.is_count or cgq.checkpwd
            or cgq.attr in ("val", "math") or cgq.attr.startswith("__agg_")):
        return False
    return cgq.attr.startswith("~") or \
        schema.type_of(cgq.attr) == TypeID.UID


def _block_child_defines(gq: dql.GraphQuery) -> set[str]:
    """Vars defined strictly BELOW the block's root level. A chain filter
    reading one of these would observe a binding the fused program cannot
    know before dispatch (classic binds them mid-walk) — reject."""
    out: set[str] = set()

    def walk(g: dql.GraphQuery) -> None:
        if g.var_name:
            out.add(g.var_name)
        if g.facets is not None:
            out.update(g.facets.var_map.values())
        for c in g.children:
            walk(c)

    for c in gq.children:
        walk(c)
    return out


def _filter_reads(ft) -> list[str]:
    out: list[str] = []
    dql.collect_filter_vars(ft, out)
    return out


def _block_child_reads(gq: dql.GraphQuery) -> set[str]:
    """Vars READ anywhere below the block's root level (val()/math
    consumers, filter leaves, uid-var references). A block that both
    defines and reads a var below its root binds depth-first in sibling
    order — an order the level-synchronous fused assembly cannot
    reproduce, so such blocks stay classic."""
    out: set[str] = set()

    def walk(g: dql.GraphQuery) -> None:
        out.update(g.needs_vars or ())
        out.update(_filter_reads(g.filter))
        if g.val_ref:
            out.add(g.val_ref)
        for c in g.children:
            walk(c)

    for c in gq.children:
        walk(c)
    return out


def _has_chain2(gq: dql.GraphQuery, schema) -> bool:
    """Does the subtree hold a ≥2-hop expansion chain — i.e. would
    fusion actually have saved dispatches here?"""
    for c in gq.children:
        if _is_uid_expansion(c, schema) and \
                _subtree_has_expansion(c, schema):
            return True
        if _has_chain2(c, schema):
            return True
    return False


def compile_filter(ft: dql.FilterTree | None, schema,
                   defined: set[str]) -> tuple[tuple | None, list[LeafSpec]]:
    """Filter tree → (formula, leaf specs). Mirrors the branch precedence
    of engine._eval_filter_func exactly, so every leaf's allow-set equals
    the classic evaluation's membership. Raises Unfusable otherwise."""
    leaves: list[LeafSpec] = []
    if ft is None:
        return None, leaves
    if set(_filter_reads(ft)) & defined:
        raise Unfusable(REASON_VAR)

    def leaf(spec: LeafSpec) -> tuple:
        leaves.append(spec)
        return ("leaf", len(leaves) - 1)

    def walk(node: dql.FilterTree) -> tuple:
        if node.func is not None:
            fn = node.func
            name = fn.name.lower()
            if name == "uid":
                return leaf(LeafSpec("uid", fn))
            if fn.is_valvar and fn.args and \
                    isinstance(fn.args[0], dql.VarRef):
                return leaf(LeafSpec("valvar", fn))
            if any(isinstance(a, dql.VarRef) for a in fn.args):
                raise Unfusable(REASON_VAR)
            if fn.is_count:
                try:
                    ns = [int(a) for a in
                          (fn.args if name == "eq" else fn.args[:1])]
                except (TypeError, ValueError):
                    raise Unfusable(REASON_FILTER) from None
                from dgraph_tpu_torch.query.engine import _int_cmp

                if name not in ("eq", "le", "lt", "ge", "gt") or not ns:
                    raise Unfusable(REASON_FILTER)
                # subjects absent from the tablet have degree 0: when 0
                # satisfies the compare the allow-set is the COMPLEMENT
                # of the failing subjects
                zero = any(_int_cmp(name, 0, n) for n in ns)
                l = leaf(LeafSpec("count", fn, invert=zero))
                return ("not", l) if zero else l
            if name == "checkpwd":
                raise Unfusable(REASON_FILTER)   # bcrypt per subject
            attr = fn.attr[1:] if fn.attr.startswith("~") else fn.attr
            tid = schema.type_of(attr)
            if name in ("has", "uid_in") or tid != TypeID.UID:
                if name == "has" and tid == TypeID.UID:
                    return leaf(LeafSpec("has_uid", fn))
                if name == "has" or name == "uid_in" or \
                        name in ("eq", "le", "lt", "ge", "gt"):
                    return leaf(LeafSpec("task", fn))
                # term/regexp/geo/similar_to on value predicates fall
                # through to the root-probe-and-intersect path
            return leaf(LeafSpec("root", fn))
        subs = [walk(c) for c in node.children]
        if node.op == "not":
            return ("not", subs[0])
        if node.op in ("and", "or"):
            return (node.op, *subs)
        raise Unfusable(REASON_FILTER)

    return walk(ft), leaves


def _hop_ir(cgq: dql.GraphQuery, schema, defined: set[str]) -> HopIR:
    """One chain node's IR, or Unfusable(reason) when a feature breaks
    the fused regime."""
    if cgq.lang:
        raise Unfusable(REASON_LANG)
    if cgq.facets is not None and cgq.facets.filter is not None:
        raise Unfusable(REASON_FACET)
    if cgq.facets is not None and cgq.facets.var_map:
        # facet vars bind per edge during the classic walk
        raise Unfusable(REASON_FACET)
    first = int(cgq.args.get("first", 0))
    offset = int(cgq.args.get("offset", 0))
    if offset < 0:
        raise Unfusable(REASON_PAGINATION)
    formula, leaves = compile_filter(cgq.filter, schema, defined)
    return HopIR(gq=cgq, attr=cgq.attr, formula=formula, leaves=leaves,
                 first=first, offset=offset,
                 facets=cgq.facets is not None)


def _subtree_has_expansion(gq: dql.GraphQuery, schema) -> bool:
    return any(_is_uid_expansion(c, schema) or
               _subtree_has_expansion(c, schema) for c in gq.children)


def _terminal_ir(cont: dql.GraphQuery, schema):
    """(TerminalIR, None) when the groupby can compile as a terminal
    segmented-reduce stage, else (None, labeled reason). Eligible shape:
    exactly one plain uid-type group key (the rank space) and children
    limited to count(uid) plus __agg_* sum/min/max/avg over val vars —
    type/exactness gating of each agg happens at execution (the host
    stays authoritative either way)."""
    gb = cont.groupby
    if len(gb.attrs) != 1 or cont.cascade:
        return None, REASON_GROUPBY
    _alias, attr, lang = gb.attrs[0]
    if lang or attr.startswith("~") or \
            schema.type_of(attr) != TypeID.UID:
        return None, REASON_GROUPBY
    aggs: list = []
    has_count = False
    for c in cont.children:
        if c.is_uid_node and c.is_count:
            has_count = True
            continue
        if c.attr.startswith("__agg_") and c.val_ref:
            op = c.attr[len("__agg_"):]
            if op in ("sum", "min", "max", "avg"):
                aggs.append((op, c.val_ref, c))
                continue
        return None, REASON_AGG
    return TerminalIR(gq=cont, key_attr=attr, aggs=aggs,
                      has_count=has_count), None


def chain_ir(gq: dql.GraphQuery, schema) -> ChainIR:
    """The maximal fusable chain under one root block: walk the unique
    uid-expansion continuation per level, compiling each into a HopIR.
    Structural only — ownership/overlay checks happen at execution."""
    ir = ChainIR()
    defined = _block_child_defines(gq)
    if defined and defined & _block_child_reads(gq):
        # define+read below the root: classic's depth-first binding
        # order is load-bearing
        ir.stop_reason = REASON_VAR
        ir.stop_cost = _has_chain2(gq, schema)
        return ir
    node = gq
    while True:
        if any(c.expand for c in node.children):
            break          # expand() resolves against runtime vars/schema
        cands = [c for c in node.children if _is_uid_expansion(c, schema)]
        if not cands:
            break
        if len(cands) > 1:
            # branching traversal: fuse the first branch, classic the
            # rest; the gap is a real coverage cost when both branches
            # chain deeper
            if any(_subtree_has_expansion(c, schema) for c in cands[1:]):
                ir.stop_reason = REASON_SHAPE
                ir.stop_cost = bool(ir.hops) or \
                    _subtree_has_expansion(cands[0], schema)
        cont = cands[0]
        if cont.groupby is not None:
            # terminal regime: a single-uid-key groupby whose children
            # are count(uid) / numeric __agg_* rides the chain as a
            # TERMINAL segmented-reduce stage; every other groupby shape
            # stays classic under its own labeled reason
            term, why = _terminal_ir(cont, schema)
            hop = None
            if term is not None:
                try:
                    hop = _hop_ir(cont, schema, defined)
                except Unfusable as e:
                    term, why = None, e.reason
            if term is None:
                ir.stop_reason = ir.stop_reason or why
                ir.stop_cost = ir.stop_cost or bool(ir.hops)
                break
            ir.hops.append(hop)
            ir.terminal = term
            break
        try:
            hop = _hop_ir(cont, schema, defined)
        except Unfusable as e:
            ir.stop_reason = e.reason
            ir.stop_cost = bool(ir.hops) or \
                _subtree_has_expansion(cont, schema)
            break
        ir.hops.append(hop)
        if cont.cascade:
            break          # cascade re-prunes: legal only as the tail
        node = cont
    return ir


# ---------------------------------------------------------------------------
# allow-set resolution (execution time)
# ---------------------------------------------------------------------------

def _universe(pd) -> np.ndarray:
    return np.unique(pd.has_subjects().astype(np.int64)) \
        if pd is not None else np.zeros(0, np.int64)


def resolve_leaf(ex, spec: LeafSpec) -> np.ndarray:
    """One leaf's sorted allow-set. Mirrors engine._eval_filter_func /
    task.process_task membership exactly (several kinds call straight
    into them). Cacheable kinds go through the mesh executor's LRU."""
    fn = spec.fn
    name = fn.name.lower()
    if spec.kind == "uid":
        uids, refs = dql._split_uid_args(fn.args)
        sel = np.asarray(uids, dtype=np.int64)
        for r in refs:
            vv = ex.vars.get(r)
            if vv is not None and vv.uids is not None:
                sel = us.union_host(sel, vv.uids, ex.snap.device)
            elif vv is not None:
                sel = us.union_host(
                    sel, np.asarray(sorted(vv.vals), dtype=np.int64),
                    ex.snap.device)
        return np.unique(sel)
    if spec.kind == "valvar":
        from dgraph_tpu_torch.query.engine import _match_any_rhs

        vv = ex.vars.get(fn.args[0].name)
        if vv is None:
            return np.zeros(0, np.int64)
        keep = [u for u, val in vv.vals.items()
                if _match_any_rhs(name, val, fn.args)]
        return np.unique(np.asarray(keep, dtype=np.int64))
    if spec.kind == "root":
        return np.unique(ex._run_root_func(fn))

    # pd-state-dependent kinds: identity-cached on the mesh executor
    mesh = ex.mesh
    rev = fn.attr.startswith("~")
    pd = ex.snap.pred(fn.attr[1:] if rev else fn.attr)
    from dgraph_tpu_torch.query.qcache import _freeze

    key = (spec.kind, fn.attr, name, _freeze(list(fn.args)), fn.lang,
           spec.invert, id(pd))
    if mesh is not None:
        hit = mesh.allow_cached(key, pd)
        if hit is not None:
            return hit

    if spec.kind == "has_uid":
        out = _universe(pd)
    elif spec.kind == "count":
        from dgraph_tpu_torch.query.engine import _int_cmp

        csr = (pd.rev_csr if rev else pd.csr) if pd is not None else None
        if csr is None:
            out = np.zeros(0, np.int64)
        else:
            from dgraph_tpu_torch.storage.delta import csr_subjects_degrees

            subjects, deg = csr_subjects_degrees(csr)
            ns = [int(a) for a in
                  (fn.args if name == "eq" else fn.args[:1])]
            ok = np.zeros(len(subjects), dtype=bool)
            for n in ns:
                ok |= {"eq": deg == n, "le": deg <= n, "lt": deg < n,
                       "ge": deg >= n, "gt": deg > n}[name]
            # invert: the set holds the FAILING subjects (the formula
            # wraps it in NOT because degree-0 absentees also match)
            out = np.unique(subjects[~ok if spec.invert else ok]
                            .astype(np.int64))
    else:  # "task": the exact process_task membership over the universe
        from dgraph_tpu_torch.query.task import TaskQuery, process_task

        uni = _universe(pd)
        if len(uni) == 0:
            out = np.zeros(0, np.int64)
        else:
            # cutover pinned sky-high: the membership scan must stay on
            # the host value/CSR mirrors, never a device dispatch
            q = TaskQuery(fn.attr, frontier=uni,
                          func=(name, list(fn.args)), lang=fn.lang,
                          cutover=1 << 62)
            out = np.unique(
                process_task(ex.snap, q, ex.schema).dest_uids)
    if mesh is not None:
        mesh.allow_store(key, pd, out)
    return out


def resolve_sets(ex, hop: HopIR) -> list[np.ndarray]:
    return [resolve_leaf(ex, spec) for spec in hop.leaves]


# ---------------------------------------------------------------------------
# formula evaluation (host mirror of the device version)
# ---------------------------------------------------------------------------

def eval_formula_np(formula: tuple, membs: list[np.ndarray]) -> np.ndarray:
    op = formula[0]
    if op == "leaf":
        return membs[formula[1]]
    if op == "not":
        return ~eval_formula_np(formula[1], membs)
    out = eval_formula_np(formula[1], membs)
    for sub in formula[2:]:
        m = eval_formula_np(sub, membs)
        out = (out & m) if op == "and" else (out | m)
    return out


def _member_np(targets: np.ndarray, s: np.ndarray) -> np.ndarray:
    if len(s) == 0:
        return np.zeros(len(targets), dtype=bool)
    pos = np.searchsorted(s, targets)
    posc = np.clip(pos, 0, len(s) - 1)
    return s[posc] == targets


# ---------------------------------------------------------------------------
# host replay: pruned uidMatrix per fused level
# ---------------------------------------------------------------------------

def replay_hop(csr, fr: np.ndarray, hop: HopIR,
               sets: list[np.ndarray]):
    """Re-derive one fused hop's pruned uidMatrix from the host mirrors
    with the SAME allow-sets and pagination windows the device applied.

    Returns (matrix, counts, dest, traversed). traversed is the RAW
    gathered edge count (pre-filter), matching the classic path's
    res.traversed_edges which counts before _apply_child_row_mods."""
    subjects, indptr, indices = csr.host_arrays()
    rows = us.host_rank_of(subjects, fr, -1)
    ok = rows >= 0
    rc = np.where(ok, rows, 0)
    starts = np.where(ok, indptr[rc], 0).astype(np.int64)
    deg = np.where(ok, indptr[rc + 1] - starts, 0).astype(np.int64)
    total = int(deg.sum())
    offs = np.zeros(len(fr) + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    pos = np.repeat(starts - offs[:-1], deg) + np.arange(total)
    targets = indices[pos].astype(np.int64)
    keep = np.ones(total, dtype=bool)
    if hop.formula is not None:
        membs = [_member_np(targets, s) for s in sets]
        keep &= eval_formula_np(hop.formula, membs)
    if hop.first or hop.offset:
        # survivor position within each row (filter-surviving order),
        # then the [offset, offset+first) window — negative first keeps
        # the last |first| of the post-offset run (engine
        # _apply_child_row_mods semantics)
        ki = keep.astype(np.int64)
        cexcl = np.cumsum(ki) - ki
        cext = np.concatenate([cexcl, [int(ki.sum())]])
        base = cext[offs[:-1]]
        cnt = cext[offs[1:]] - base
        seg = np.repeat(np.arange(len(fr)), deg)
        p = cexcl - base[seg]
        win = p >= hop.offset
        if hop.first > 0:
            win &= p < hop.offset + hop.first
        elif hop.first < 0:
            win &= p >= cnt[seg] + hop.first
        keep &= win
    kept = targets[keep]
    ck = np.concatenate([[0], np.cumsum(keep)])      # kept-prefix, len T+1
    koffs = np.zeros(len(fr) + 1, dtype=np.int64)
    np.cumsum(ck[offs[1:]] - ck[offs[:-1]], out=koffs[1:])
    matrix = [kept[koffs[i]: koffs[i + 1]] for i in range(len(fr))]
    counts = [len(m) for m in matrix]
    dest = np.unique(kept) if len(kept) else np.zeros(0, np.int64)
    return matrix, counts, dest, total
