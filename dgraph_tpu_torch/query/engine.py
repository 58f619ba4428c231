"""Query engine: SubGraph plan execution (ProcessGraph) over a snapshot.

Port of dgraph_tpu/query/engine.py. Reference semantics: query/query.go —
SubGraph is both plan node and result holder (:165-192); ProcessGraph
(:1831): root function / frontier task → DestUIDs = MergeSorted(uidMatrix)
→ filters combined and/or/not (:1955-2013) → ordering and pagination
(:2016-2031) → variable recording (:2035) → children with SrcUIDs =
DestUIDs (:2081). ProcessQuery runs blocks in dependency waves
(:2431-2586). Value, uid and facet variables: varValue / populateVarMap;
aggregation and math: query/aggregator.go, query/math.go.

Ported: uid(...) and index root functions, uid and value children (lang
chains, checkpwd, @facets reads, facet filters and facet variables), value,
count and uid(...) filters under and/or/not, val()/math()/min/max/sum/avg,
orderasc/orderdesc (index-ordered for a bounded single key), pagination,
@cascade, @recurse, shortest paths (query/shortest.py). The mesh, batcher,
caches, dispatch gate and planner of the JAX engine are not carried over.
@groupby raises NotImplementedError naming its slice, and similar_to (in
query/task.py) names the vector slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from dgraph_tpu_torch.ops import uidset as us
from dgraph_tpu_torch.query import dql
from dgraph_tpu_torch.query.task import TaskQuery, process_task
from dgraph_tpu_torch.storage.csr_build import GraphSnapshot
from dgraph_tpu_torch.utils.schema import SchemaState
from dgraph_tpu_torch.utils.types import (TypeID, Val, compare_vals,
                                          convert, sort_key, verify_password)

MAX_QUERY_EDGES = 1_000_000  # reference x/init.go:53 QueryEdgeLimit


def set_query_edge_limit(n: int) -> None:
    """Set the process-wide per-query traversed-edge budget (the
    reference's --query_edge_limit flag); traversal modules read it through
    ex.edge_budget(). The per-request override waits for the Node slice."""
    global MAX_QUERY_EDGES
    MAX_QUERY_EDGES = int(n)


class QueryError(ValueError):
    pass


def _unported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it waits for the {slice_name} slice of "
        f"dgraph_tpu_torch")


@dataclass
class VarValue:
    """A recorded variable (reference query.varValue)."""

    uids: np.ndarray | None = None                  # uid var
    vals: dict[int, Val] = field(default_factory=dict)  # value var (uid → Val)
    is_uid: bool = True


@dataclass
class SubGraph:
    """Plan node + result holder (reference query.SubGraph, query/query.go:165)."""

    gq: dql.GraphQuery
    attr: str = ""
    src_uids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    dest_uids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    uid_matrix: list[np.ndarray] = field(default_factory=list)
    value_matrix: list[list[Val]] = field(default_factory=list)
    facet_matrix: list[list[tuple]] = field(default_factory=list)
    counts: list[int] = field(default_factory=list)
    children: list["SubGraph"] = field(default_factory=list)
    group_result: Any = None
    agg_value: Val | None = None
    math_vals: dict[int, Val] = field(default_factory=dict)
    paths: list = field(default_factory=list)
    traversed: int = 0


class Executor:
    """Executes one parsed request against a snapshot; the device is the
    snapshot's."""

    def __init__(self, snap: GraphSnapshot, schema: SchemaState):
        self.snap = snap
        self.schema = schema
        self.vars: dict[str, VarValue] = {}
        self.traversed_edges = 0

    def _dispatch(self, q: TaskQuery):
        return process_task(self.snap, q, self.schema)

    def edge_budget(self) -> int:
        """Traversed-edge budget for this request (read at call time, so
        set_query_edge_limit applies)."""
        return MAX_QUERY_EDGES

    # ------------------------------------------------------------------ API

    def execute(self, req: dql.ParsedRequest) -> dict:
        """Run all query blocks in dependency waves (query/query.go:2431)."""
        blocks = [SubGraph(gq=q, attr=q.attr) for q in req.queries]
        pending = list(blocks)
        done_vars: set[str] = set()
        for _wave in range(len(blocks) + 1):
            if not pending:
                break
            runnable = [b for b in pending
                        if all(v in done_vars for v in _block_needs(b.gq))]
            if not runnable:
                missing = {v for b in pending for v in _block_needs(b.gq)} - done_vars
                raise QueryError(f"circular or missing variable dependency: {missing}")
            for b in runnable:
                self._process_block(b)
                done_vars.update(_block_defines(b.gq))
            pending = [b for b in pending if b not in runnable]
        from dgraph_tpu_torch.query.outputnode import encode_result

        out: dict = {}
        for b in blocks:
            if b.gq.attr == "var":
                continue
            encode_result(self, b, out)
        return out

    # ---------------------------------------------------------------- blocks

    def _process_block(self, sg: SubGraph) -> None:
        gq = sg.gq
        if gq.shortest is not None:
            from dgraph_tpu_torch.query.shortest import shortest_path

            shortest_path(self, sg)
            return
        sg.src_uids = self._root_uids(gq)
        if gq.recurse is not None:
            from dgraph_tpu_torch.query.recurse import recurse

            sg.dest_uids = sg.src_uids
            sg.dest_uids = self._apply_filter(gq.filter, sg.dest_uids)
            recurse(self, sg)
            return
        sg.dest_uids = sg.src_uids
        self._finish_level(sg, is_root=True)

    def _root_uids(self, gq: dql.GraphQuery) -> np.ndarray:
        uids: list[np.ndarray] = []
        if gq.uids:
            want = np.unique(np.asarray(gq.uids, dtype=np.int64))
            present = _known_uids(self.snap)
            uids.append(want[np.isin(want, present)]
                        if len(present) else want)
        for v in gq.root_uid_vars:
            vv = self.vars.get(v)
            if vv is not None and vv.uids is not None:
                uids.append(vv.uids)
            elif vv is not None and not vv.is_uid:
                uids.append(np.asarray(sorted(vv.vals.keys()), dtype=np.int64))
        if gq.func is not None:
            uids.append(self._run_root_func(gq.func))
        if not uids:
            return np.zeros(0, np.int64)
        out = uids[0]
        for u in uids[1:]:
            out = us.union_host(out, u)
        return out

    def _run_root_func(self, fn: dql.Function) -> np.ndarray:
        args = list(fn.args)
        if fn.is_count:
            # eq(count(pred), n) — compare-scalar form; eq matches ANY listed n
            outs = [self._dispatch(
                TaskQuery(fn.attr, func=(fn.name, ["__count__", int(n)]))
                ).dest_uids
                for n in (args if fn.name == "eq" else args[:1])]
            return (np.unique(np.concatenate(outs)) if outs
                    else np.zeros(0, np.int64))
        if fn.is_valvar and args and isinstance(fn.args[0], dql.VarRef):
            # eq(val(x), v): select uids whose var value compares true
            vv = self.vars.get(fn.args[0].name)
            if vv is None:
                return np.zeros(0, np.int64)
            out = [u for u, val in sorted(vv.vals.items())
                   if _match_any_rhs(fn.name, val, args)]
            return np.asarray(out, dtype=np.int64)
        q = TaskQuery(fn.attr, func=(fn.name, args), lang=fn.lang)
        return self._dispatch(q).dest_uids

    # ---------------------------------------------------------------- levels

    def _finish_level(self, sg: SubGraph, is_root: bool) -> None:
        """Filter → order/paginate → record vars → children (ProcessGraph
        tail). Child levels already applied filter + pagination per
        uidMatrix row (the reference's applyPagination works per row)."""
        gq = sg.gq
        if is_root:
            sg.dest_uids = self._apply_filter(gq.filter, sg.dest_uids)
        if gq.groupby is not None:
            raise _unported("@groupby", "groupby")
        if is_root:
            if gq.order:
                sg.dest_uids = self._apply_order(gq, sg.dest_uids)
            self._paginate_ordered(sg)
        self._record_uid_var(gq, sg)
        self._process_children(sg)
        if gq.cascade:
            self._cascade(sg)

    def _paginate_ordered(self, sg: SubGraph) -> None:
        gq = sg.gq
        first = int(gq.args.get("first", 0))
        offset = int(gq.args.get("offset", 0))
        after = int(gq.args.get("after", 0))
        u = sg.dest_uids
        if after:
            u = u[u > after]        # a mask keeps an ordered list's order
        if offset:
            u = u[offset:]
        if first > 0:
            u = u[:first]
        elif first < 0:
            u = u[first:]  # negative first = last N (x/x.go:191 PageRange)
        sg.dest_uids = u

    def _process_children(self, sg: SubGraph) -> None:
        """Expand each child over this level's DestUIDs, one task each."""
        gq = sg.gq
        frontier = np.sort(sg.dest_uids)
        for cgq in self._effective_children(gq, frontier):
            if cgq.is_uid_node or cgq.attr in ("val", "math") or \
               cgq.attr.startswith("__agg_"):
                child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=frontier)
                self._compute_virtual_child(sg, child, frontier)
                sg.children.append(child)
                continue
            child = self._run_child_task(cgq, frontier)
            sg.children.append(child)
            if cgq.children or cgq.cascade:
                self._finish_level(child, is_root=False)

    def _run_child_task(self, cgq: dql.GraphQuery,
                        frontier: np.ndarray) -> SubGraph:
        """One non-virtual child level through the dispatch seam: expand /
        value fetch, facet filter, per-row filter + pagination, var
        recording."""
        child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=frontier)
        tq = TaskQuery(cgq.attr, frontier=frontier, lang=cgq.lang)
        if cgq.facets is not None:
            # every facet comes back; the encoder keeps the asked keys
            tq.facet_keys = [k for _, k in cgq.facets.keys] or ["__all__"]
        res = self._dispatch(tq)
        self.traversed_edges += res.traversed_edges
        if self.traversed_edges > self.edge_budget():
            raise QueryError("query exceeded edge budget (ErrTooBig)")
        if cgq.checkpwd:
            # checkpwd(pwd, "cand"): stored password -> bool per uid
            # (query/outputnode.go checkPwd)
            res.value_matrix = [
                [Val(TypeID.BOOL,
                     bool(vs) and verify_password(cgq.checkpwd,
                                                  str(vs[0].value)))]
                for vs in res.value_matrix]
        child.uid_matrix = res.uid_matrix
        child.value_matrix = res.value_matrix
        child.facet_matrix = res.facet_matrix
        child.counts = res.counts
        child.dest_uids = res.dest_uids
        child.traversed = res.traversed_edges
        if cgq.facets is not None and cgq.facets.filter is not None:
            self._apply_facet_filter(child)
        if child.uid_matrix and (cgq.filter is not None or
                                 cgq.args.get("first") or cgq.args.get("offset")):
            self._apply_child_row_mods(child)
        self._record_child_vars(cgq, child, frontier)
        return child

    def _apply_child_row_mods(self, child: SubGraph) -> None:
        """Filter dest uids, then prune + paginate each uidMatrix row
        (reference: filters :1955 then applyPagination :2114 per list)."""
        cgq = child.gq
        dest = np.sort(self._apply_filter(cgq.filter, child.dest_uids))
        first = int(cgq.args.get("first", 0))
        offset = int(cgq.args.get("offset", 0))
        new_matrix = []
        for i, row in enumerate(child.uid_matrix):
            row = np.asarray(row, dtype=np.int64)
            sel = np.flatnonzero(us.host_rank_of(dest, row, -1) >= 0)
            if offset:
                sel = sel[offset:]
            if first > 0:
                sel = sel[:first]
            elif first < 0:
                sel = sel[first:]
            new_matrix.append(row[sel])
            if child.facet_matrix and i < len(child.facet_matrix):
                frow = child.facet_matrix[i]
                child.facet_matrix[i] = [frow[j] for j in sel.tolist()
                                         if j < len(frow)]
        child.uid_matrix = new_matrix
        child.counts = [len(m) for m in new_matrix]
        child.dest_uids = (np.unique(np.concatenate(new_matrix))
                           if any(len(m) for m in new_matrix)
                           else np.zeros(0, np.int64))

    def _effective_children(self, gq: dql.GraphQuery, frontier: np.ndarray):
        """expand(_all_) / expand(var) → concrete children (reference
        expandSubgraph :1736: a variable must hold predicate-name values)."""
        out = []
        for c in gq.children:
            if c.expand:
                if c.expand == "_all_":
                    preds = self.schema.predicates()
                else:
                    vv = self.vars.get(c.expand)
                    if vv is None or vv.is_uid:
                        raise QueryError(
                            f"expand({c.expand}) needs _all_ or a value "
                            f"variable holding predicate names")
                    preds = sorted({str(v.value) for v in vv.vals.values()})
                for p in preds:
                    sub = dql.GraphQuery(alias=p, attr=p)
                    sub.children = list(c.children)
                    out.append(sub)
            else:
                out.append(c)
        return out

    def _compute_virtual_child(self, sg: SubGraph, child: SubGraph,
                               frontier: np.ndarray) -> None:
        """uid / val(x) / math / min-max-sum-avg pseudo-attributes."""
        cgq = child.gq
        child.dest_uids = frontier
        if cgq.is_uid_node:
            self._record_child_vars(cgq, child, frontier)
            return
        if cgq.attr == "val":
            vv = self.vars.get(cgq.val_ref)
            if vv is not None:
                child.value_matrix = [
                    [vv.vals[int(u)]] if int(u) in vv.vals else [] for u in frontier]
            return
        if cgq.attr == "math":
            from dgraph_tpu_torch.query.math import eval_math

            vals = eval_math(cgq.math, self.vars, frontier)
            child.math_vals = vals
            child.value_matrix = [
                [vals[int(u)]] if int(u) in vals else [] for u in frontier]
            if cgq.var_name:
                self.vars[cgq.var_name] = VarValue(vals=vals, is_uid=False)
            return
        if cgq.attr.startswith("__agg_"):
            from dgraph_tpu_torch.query.aggregator import aggregate

            op = cgq.attr[len("__agg_"):]
            vv = self.vars.get(cgq.val_ref)
            vals = vv.vals if vv else {}
            # aggregate over the enclosing block's uid space when non-empty
            keys = [int(u) for u in frontier if int(u) in vals] or list(vals)
            child.agg_value = aggregate(op, [vals[k] for k in keys])

    # ---------------------------------------------------------------- filters

    def _apply_filter(self, ft: dql.FilterTree | None,
                      frontier: np.ndarray) -> np.ndarray:
        if ft is None or len(frontier) == 0:
            return frontier
        return self._eval_filter(ft, frontier)

    def _eval_filter(self, ft: dql.FilterTree,
                     frontier: np.ndarray) -> np.ndarray:
        if ft.func is not None:
            return self._eval_filter_func(ft.func, frontier)
        parts = [self._eval_filter(c, frontier) for c in ft.children]
        if ft.op == "and":
            out = parts[0]
            for p in parts[1:]:
                out = us.intersect_host(out, p)
            return out
        if ft.op == "or":
            out = parts[0]
            for p in parts[1:]:
                out = us.union_host(out, p)
            return out
        if ft.op == "not":
            return us.difference_host(frontier, parts[0])
        raise QueryError(f"bad filter op {ft.op}")

    def _eval_filter_func(self, fn: dql.Function,
                          frontier: np.ndarray) -> np.ndarray:
        name = fn.name.lower()
        if name == "uid":
            uids, refs = dql._split_uid_args(fn.args)
            sel = np.asarray(uids, dtype=np.int64)
            for r in refs:
                vv = self.vars.get(r)
                if vv is not None and vv.uids is not None:
                    sel = us.union_host(sel, vv.uids)
                elif vv is not None:
                    sel = us.union_host(sel, np.asarray(sorted(vv.vals), dtype=np.int64))
            return us.intersect_host(frontier, sel)
        if fn.is_valvar and fn.args and isinstance(fn.args[0], dql.VarRef):
            vv = self.vars.get(fn.args[0].name)
            if vv is None:
                return np.zeros(0, np.int64)
            keep = [int(u) for u in frontier if int(u) in vv.vals
                    and _match_any_rhs(name, vv.vals[int(u)], fn.args)]
            return np.asarray(keep, dtype=np.int64)
        if fn.is_count:
            # filter-level eq(count(pred), n): degree check over frontier;
            # eq matches ANY listed n
            res = self._dispatch(TaskQuery(fn.attr, frontier=frontier))
            ns = [int(a) for a in (fn.args if name == "eq" else fn.args[:1])]
            keep = [u for u, c in zip(frontier, res.counts)
                    if any(_int_cmp(name, c, n) for n in ns)]
            return np.asarray(keep, dtype=np.int64)
        tid = self.schema.type_of(fn.attr)
        if name == "has" and tid == TypeID.UID:
            root = self._dispatch(TaskQuery(fn.attr, func=("has", []))).dest_uids
            return us.intersect_host(frontier, root)
        if name in ("has", "uid_in", "checkpwd") or (
                name in ("eq", "le", "lt", "ge", "gt") and tid != TypeID.UID):
            # pointwise over the frontier: value presence, a value compare
            # (float64 host mirror or stored values), uid_in, checkpwd
            q = TaskQuery(fn.attr, frontier=frontier,
                          func=(name, list(fn.args)), lang=fn.lang)
            return self._dispatch(q).dest_uids
        # index-backed functions: run at root, intersect with frontier
        root = self._run_root_func(fn)
        return us.intersect_host(frontier, root)

    def _apply_facet_filter(self, child: SubGraph) -> None:
        ft = child.gq.facets.filter
        new_matrix = []
        for i, (uids, facets) in enumerate(zip(child.uid_matrix, child.facet_matrix)):
            keep_idx = [j for j, f in enumerate(facets)
                        if _facet_filter_match(ft, dict(f))]
            new_matrix.append(np.asarray([uids[j] for j in keep_idx], dtype=np.int64))
            child.facet_matrix[i] = [facets[j] for j in keep_idx]
        child.uid_matrix = new_matrix
        child.counts = [len(m) for m in new_matrix]
        child.dest_uids = (np.unique(np.concatenate(new_matrix))
                           if any(len(m) for m in new_matrix) else np.zeros(0, np.int64))

    # ---------------------------------------------------------------- vars

    def _record_uid_var(self, gq: dql.GraphQuery, sg: SubGraph) -> None:
        if gq.var_name:
            self.vars[gq.var_name] = VarValue(uids=np.sort(sg.dest_uids))

    def _record_child_vars(self, cgq: dql.GraphQuery, child: SubGraph,
                           frontier: np.ndarray) -> None:
        if cgq.var_name:
            if cgq.is_count:
                vals = {int(u): Val(TypeID.INT, c)
                        for u, c in zip(frontier, child.counts)}
                self.vars[cgq.var_name] = VarValue(vals=vals, is_uid=False)
            elif child.value_matrix:
                vals = {int(u): vs[0]
                        for u, vs in zip(frontier, child.value_matrix) if vs}
                self.vars[cgq.var_name] = VarValue(vals=vals, is_uid=False)
            else:
                self.vars[cgq.var_name] = VarValue(uids=child.dest_uids)
        # facet variables: var per facet key mapped over target uids
        if cgq.facets is not None and cgq.facets.var_map:
            for key, vname in cgq.facets.var_map.items():
                vals: dict[int, Val] = {}
                for uids, facets in zip(child.uid_matrix, child.facet_matrix):
                    for u, f in zip(uids, facets):
                        fv = dict(f).get(key)
                        if fv is not None:
                            vals[int(u)] = fv
                self.vars[vname] = VarValue(vals=vals, is_uid=False)

    # ---------------------------------------------------------------- order

    def _apply_order(self, gq: dql.GraphQuery, uids: np.ndarray) -> np.ndarray:
        """Multi-key order (reference worker/sort.go).

        Single-key sorts over an indexed sortable predicate walk the token
        buckets in key order (sortWithIndex, worker/sort.go:144-259),
        intersecting each bucket with the candidate set and stopping once
        offset+first is satisfied; everything else takes the value sort.
        Stable sorts applied from the last key to the first give multi-key
        semantics; uids with a missing sort value sink to the end, in either
        direction."""
        if (len(gq.order) == 1 and not gq.order[0].is_val
                and not gq.order[0].lang
                and int(gq.args.get("after", 0)) == 0
                and int(gq.args.get("first", 0)) > 0):
            # bounded sorts only: an unbounded walk of every bucket loses to
            # the single value-sort pass (worker/sort.go:379)
            need = int(gq.args.get("offset", 0)) + int(gq.args["first"])
            got = self._sort_with_index(gq.order[0], uids, need)
            if got is not None:
                return got
        ordered = [int(u) for u in uids]
        for o in reversed(gq.order):
            present = [(self._order_key(o, u), u) for u in ordered]
            have = [(k, u) for k, u in present if k is not None]
            missing = [u for k, u in present if k is None]
            have.sort(key=lambda t: t[0], reverse=o.desc)
            ordered = [u for _, u in have] + missing
        return np.asarray(ordered, dtype=np.int64)

    def _sort_with_index(self, o: dql.Order, uids: np.ndarray,
                         need: int) -> np.ndarray | None:
        """Index-ordered sort: walk sortable token buckets in term order
        (reversed for desc), intersect each with the candidate set
        (intersectBucket, worker/sort.go:480), sort lossy buckets by value,
        stop at `need` results. Returns None when no sortable non-list index
        is available (value-sort fallback). Token encodings are
        order-preserving (utils/tok.py), so bucket term order is value
        order."""
        from dgraph_tpu_torch.utils import tok as tokmod

        pd = self.snap.pred(o.attr)
        entry = self.schema.get(o.attr)
        if pd is None or entry is None or entry.is_list or \
                getattr(entry, "lang", False):
            # @lang predicates: tagged-only values are indexed but invisible
            # to the untagged value sort — keep one code path (value sort)
            return None
        ti = tz = None
        for name in self.schema.tokenizer_names(o.attr):
            t = tokmod.get(name)
            if t.sortable and name in pd.indexes:
                ti, tz = pd.indexes[name], t
                break
        if ti is None or not ti.terms:
            return None
        cand = np.asarray(uids, dtype=np.int64)
        indptr, tuids = ti.host_arrays()
        ordered: list[int] = []
        rows = range(len(ti.terms) - 1, -1, -1) if o.desc \
            else range(len(ti.terms))
        satisfied = False
        for r in rows:
            bucket = tuids[indptr[r]:indptr[r + 1]]
            inb = us.intersect_host(bucket, cand)
            if len(inb) == 0:
                continue
            if tz.lossy and len(inb) > 1:
                # lossy tokenizer: one bucket spans many values — order
                # within the bucket by actual value
                keyed = sorted(
                    ((self._order_key(o, int(u)), int(u)) for u in inb),
                    key=lambda t: (t[0] is None, t[0]), reverse=o.desc)
                inb = [u for _, u in keyed]
            ordered.extend(int(u) for u in inb)
            if need and len(ordered) >= need:
                satisfied = True
                break
        if not satisfied:
            # uids with no index entry (no value) sink to the end, ascending
            # — identical to the value sort's missing tail
            missing = np.setdiff1d(cand, np.asarray(ordered, dtype=np.int64))
            ordered.extend(int(u) for u in missing)
        return np.asarray(ordered, dtype=np.int64)

    def _order_key(self, o: dql.Order, uid: int):
        if o.is_val:
            vv = self.vars.get(o.attr)
            if vv is None or uid not in vv.vals:
                return None
            return sort_key(vv.vals[uid])
        pd = self.snap.pred(o.attr)
        if pd is None:
            return None
        if o.lang:
            v = pd.lang_values.get(uid, {}).get(o.lang)
        else:
            v = pd.host_values.get(uid)
        return sort_key(v) if v is not None else None

    # ---------------------------------------------------------------- cascade

    def _cascade(self, sg: SubGraph) -> None:
        """@cascade: keep uids with a non-empty result in EVERY child."""
        keep = set(int(u) for u in sg.dest_uids)
        frontier = np.sort(sg.dest_uids)
        for child in sg.children:
            if child.gq.is_uid_node or child.gq.attr in ("val", "math") or \
               child.gq.attr.startswith("__agg_") or child.gq.is_count:
                continue
            for i, u in enumerate(frontier):
                hit = (i < len(child.uid_matrix) and len(child.uid_matrix[i])) or \
                      (i < len(child.value_matrix) and len(child.value_matrix[i]))
                if not hit:
                    keep.discard(int(u))
        if len(keep) != len(sg.dest_uids):
            sg.dest_uids = np.asarray(sorted(keep), dtype=np.int64)
            # re-run children on the pruned frontier for consistent output
            sg.children = []
            self._process_children(sg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _block_needs(gq: dql.GraphQuery) -> list[str]:
    out = list(gq.all_needs())

    def walk(g: dql.GraphQuery):
        for c in g.children:
            out.extend(c.needs_vars)
            dql.collect_filter_vars(c.filter, out)
            walk(c)

    walk(gq)
    defines = _block_defines(gq)
    return [v for v in out if v not in defines]


def _block_defines(gq: dql.GraphQuery) -> set[str]:
    out = set()

    def walk(g: dql.GraphQuery):
        if g.var_name:
            out.add(g.var_name)
        if g.facets is not None:
            out.update(g.facets.var_map.values())
        for c in g.children:
            walk(c)

    walk(gq)
    return out


def _known_uids(snap: GraphSnapshot) -> np.ndarray:
    """All uids present anywhere in the snapshot (subjects or objects),
    computed once per snapshot — uid(...) validation runs per query."""
    cached = getattr(snap, "_known_uids_cache", None)
    if cached is not None:
        return cached
    parts = []
    for pd in snap.preds.values():
        parts.append(pd.has_subjects().astype(np.int64))
        if pd.csr is not None:
            parts.append(np.asarray(
                pd.csr.host_arrays()[2]).astype(np.int64))
    out = np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int64)
    snap._known_uids_cache = out
    return out


def _match_any_rhs(op: str, val: Val, args: list) -> bool:
    """val-var compare: args[0] is the VarRef; eq matches ANY of args[1:],
    other ops take exactly one rhs."""
    rhss = args[1:] if op == "eq" else args[1:2]
    return any(_compare_any(op, val, r) for r in rhss)


def _compare_any(op: str, a: Val, b) -> bool:
    rhs = b if isinstance(b, Val) else _val_from_literal(b, a.tid)
    try:
        return compare_vals(op, a, rhs)
    except ValueError:
        return False


def _val_from_literal(x, tid: TypeID) -> Val:
    if isinstance(x, bool):
        return Val(TypeID.BOOL, x)
    if isinstance(x, int):
        v = Val(TypeID.INT, x)
    elif isinstance(x, float):
        v = Val(TypeID.FLOAT, x)
    else:
        v = Val(TypeID.STRING, str(x))
    try:
        return convert(v, tid) if tid not in (TypeID.DEFAULT,) else v
    except ValueError:
        return v


def _facet_filter_match(ft: dql.FilterTree, facets: dict) -> bool:
    """Evaluate a facet filter tree against one edge's facets
    (reference: facets filter application in query/query.go facetsFilter)."""
    if ft.func is not None:
        fn = ft.func
        fv = facets.get(fn.attr)
        if fv is None:
            return False
        if fn.name.lower() == "has":
            return True
        op = fn.name.lower()
        rhss = fn.args if op == "eq" else fn.args[:1]
        return any(_compare_any(op, fv, r) for r in rhss)
    parts = (_facet_filter_match(c, facets) for c in ft.children)
    if ft.op == "and":
        return all(parts)
    if ft.op == "or":
        return any(parts)
    if ft.op == "not":
        return not _facet_filter_match(ft.children[0], facets)
    return False


def _int_cmp(op: str, a: int, b: int) -> bool:
    return {"eq": a == b, "le": a <= b, "lt": a < b, "ge": a >= b, "gt": a > b}[op]
