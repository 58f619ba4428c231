"""Query engine: SubGraph plan execution (ProcessGraph) over a snapshot.

Port of dgraph_tpu/query/engine.py for the uid-traversal slice. Reference
semantics: query/query.go — SubGraph is both plan node and result holder
(:165-192); ProcessGraph (:1831): frontier task → DestUIDs = MergeSorted
(uidMatrix) → filters combined and/or/not (:1955-2013) → pagination
(:2016-2031) → variable recording (:2035) → children with SrcUIDs =
DestUIDs (:2081). ProcessQuery runs blocks in dependency waves
(:2431-2586).

Ported: uid(...) roots and uid variables, uid children (expand, count,
uid selections, reverse edges), uid(...) filters under and/or/not, child
row pagination, @cascade, @recurse. The mesh, batcher, caches, dispatch
gate, planner and vector seams of the JAX engine are not carried over.
Each unported branch raises NotImplementedError naming its slice: root
functions and value filters (index slice), value children, val/math/
aggregates and ordering (value slice), shortest (shortest slice),
@groupby (groupby slice), facets (value slice).
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
from dgraph_tpu_torch.utils.types import TypeID, Val

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
            raise _unported("shortest", "shortest")
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
            raise _unported(f"root function {gq.func.name}()", "index")
        if not uids:
            return np.zeros(0, np.int64)
        out = uids[0]
        for u in uids[1:]:
            out = us.union_host(out, u)
        return out

    # ---------------------------------------------------------------- levels

    def _finish_level(self, sg: SubGraph, is_root: bool) -> None:
        """Filter → paginate → record vars → children (ProcessGraph tail).
        Child levels already applied filter + pagination per uidMatrix row."""
        gq = sg.gq
        if is_root:
            sg.dest_uids = self._apply_filter(gq.filter, sg.dest_uids)
        if gq.groupby is not None:
            raise _unported("@groupby", "groupby")
        if is_root:
            if gq.order:
                raise _unported("orderasc/orderdesc", "value")
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
            u = u[u > after]
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
            if cgq.is_uid_node:
                child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=frontier)
                child.dest_uids = frontier
                self._record_child_vars(cgq, child, frontier)
                sg.children.append(child)
                continue
            if cgq.attr in ("val", "math") or cgq.attr.startswith("__agg_"):
                raise _unported(f"{cgq.attr} children", "value")
            child = self._run_child_task(cgq, frontier)
            sg.children.append(child)
            if cgq.children or cgq.cascade:
                self._finish_level(child, is_root=False)

    def _run_child_task(self, cgq: dql.GraphQuery,
                        frontier: np.ndarray) -> SubGraph:
        """One child level through the dispatch seam: expand, per-row
        filter + pagination, var recording."""
        if cgq.facets is not None:
            raise _unported("@facets", "value")
        if cgq.checkpwd:
            raise _unported("checkpwd", "value")
        child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=frontier)
        if cgq.lang:
            raise _unported("language tags", "value")
        res = self._dispatch(TaskQuery(cgq.attr, frontier=frontier))
        self.traversed_edges += res.traversed_edges
        if self.traversed_edges > self.edge_budget():
            raise QueryError("query exceeded edge budget (ErrTooBig)")
        child.uid_matrix = res.uid_matrix
        child.counts = res.counts
        child.dest_uids = res.dest_uids
        child.traversed = res.traversed_edges
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
        for row in child.uid_matrix:
            row = np.asarray(row, dtype=np.int64)
            sel = np.flatnonzero(us.host_rank_of(dest, row, -1) >= 0)
            if offset:
                sel = sel[offset:]
            if first > 0:
                sel = sel[:first]
            elif first < 0:
                sel = sel[first:]
            new_matrix.append(row[sel])
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
        if name == "uid_in":
            q = TaskQuery(fn.attr, frontier=frontier,
                          func=(name, list(fn.args)))
            return self._dispatch(q).dest_uids
        raise _unported(f"filter function {fn.name}()", "index")

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
            else:
                self.vars[cgq.var_name] = VarValue(uids=child.dest_uids)

    # ---------------------------------------------------------------- cascade

    def _cascade(self, sg: SubGraph) -> None:
        """@cascade: keep uids with a non-empty result in EVERY child."""
        keep = set(int(u) for u in sg.dest_uids)
        frontier = np.sort(sg.dest_uids)
        for child in sg.children:
            if child.gq.is_uid_node or child.gq.is_count:
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
