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
@cascade, @recurse, shortest paths (query/shortest.py) and @groupby
(query/groupby.py), and similar_to over the vector index with its
`vector_distance` variable and the fused ANN -> expand pipeline
(ops/vector.ann_expand). The serving seams of the JAX Executor are here: the
task dispatcher, the task-result cache, the dispatch gate (`gated`), the
device batcher (`batcher`, query/batch.py, and `batched_recurse`), the
planner's physical plan (`plan`, query/planner.py) and its EXPLAIN
recorder (`explain`), the per-request edge limit, the per-task deadline
check, otrace spans and cost-ledger attribution (`_traced_dispatch`), and
the per-task hook (`on_task`), and the mesh (`mesh`, a
parallel/mesh_exec.MeshExecutor): a chain over mesh-sharded tablets — its
pointwise filters, pagination windows and a single-uid-key @groupby
terminal included — runs as one mesh program whose per-level frontiers the
host replays from its CSR mirrors (`_mesh_fused_plan`); recurse and shortest
consult it too.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from dgraph_tpu_torch.obs import costs, otrace
from dgraph_tpu_torch.ops import uidset as us
from dgraph_tpu_torch.ops.csr import UNIQUE_BITMAP_SPREAD
from dgraph_tpu_torch.query import dql
from dgraph_tpu_torch.query.task import TaskQuery, process_task
from dgraph_tpu_torch.storage.csr_build import GraphSnapshot
from dgraph_tpu_torch.utils.schema import SchemaState
from dgraph_tpu_torch.utils.types import (TypeID, Val, compare_vals,
                                          convert, sort_key, verify_password)

MAX_QUERY_EDGES = 1_000_000  # reference x/init.go:53 QueryEdgeLimit


def set_query_edge_limit(n: int) -> None:
    """Set the process-default per-query traversed-edge budget (the
    reference's --query_edge_limit server flag, x/config.go:18-24). The
    module global is only the DEFAULT: an Executor built with edge_limit=N
    (the per-request override, Node.query(edge_limit=...)) ignores it —
    traversal modules read the effective budget via ex.edge_budget()."""
    global MAX_QUERY_EDGES
    MAX_QUERY_EDGES = int(n)


class QueryError(ValueError):
    pass


@dataclass
class ValueColumns:
    """A value var held as columns, as a grouped var is bound
    (query/groupby.py): keys, its ascending distinct int64 uids; values,
    their values in that order as one numeric array of the var's type
    (tid: INT in any integer dtype, FLOAT in float64); keys_dev, the
    card's copy of keys where the grouping made them there, else None."""

    keys: np.ndarray
    values: np.ndarray
    tid: TypeID
    keys_dev: torch.Tensor | None = None

    def lookup(self, uids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(the position in keys, whether keys holds it) of each uid."""
        if len(self.keys) == 0:
            return (np.zeros(len(uids), dtype=np.int64),
                    np.zeros(len(uids), dtype=bool))
        pos = np.minimum(np.searchsorted(self.keys, uids),
                         len(self.keys) - 1)
        return pos, self.keys[pos] == uids

    def vals_of(self, uids: np.ndarray) -> list[Val | None]:
        """The Val of each uid, None where the var holds none."""
        pos, hit = self.lookup(uids)
        got = self.values[pos].tolist()
        return [Val(self.tid, v) if h else None
                for v, h in zip(got, hit.tolist())]

    def as_dict(self) -> dict[int, Val]:
        return {u: Val(self.tid, v) for u, v in
                zip(self.keys.tolist(), self.values.tolist())}

    def order(self, uids: np.ndarray, desc: bool,
              need: int | None) -> np.ndarray | None:
        """uids ordered by their value (_apply_order's rule: ties and the
        uids without a value keep their order in uids, the latter last), or
        the first `need` of that order; None where the values hold a NaN or
        an INT that cannot be negated, which the caller leaves to the
        value sort."""
        if uids is self.keys:           # uid(x) itself: each has a value
            have, rest, key = None, uids[:0], self.values
        else:
            pos, hit = self.lookup(uids)
            have, rest = np.flatnonzero(hit), uids[~hit]
            key = self.values[pos[have]]
        if self.tid == TypeID.FLOAT and np.isnan(key).any():
            return None
        if desc:
            if key.dtype.kind == "i" and len(key) and \
                    key.min() == np.iinfo(key.dtype).min:
                return None
            key = -key
        if need is not None and need < len(key):
            # every key up to the need-th smallest, ties at it included,
            # then the stable sort of those alone
            cand = np.flatnonzero(key <= np.partition(key, need - 1)[need - 1])
            sel = cand[np.argsort(key[cand], kind="stable")][:need]
        else:
            sel = np.argsort(key, kind="stable")
        out = uids[sel if have is None else have[sel]]
        if need is None or len(out) < need:
            out = np.concatenate([out, rest if need is None
                                  else rest[:need - len(out)]])
        return out.astype(np.int64, copy=False)

    def aggregate(self, op: str, uids: np.ndarray):
        """A root aggregate's Val (or None) over the values of uids where
        the var holds any of them, else over every value: aggregate()'s
        answer for an INT column, or NotImplemented for a FLOAT one or a
        sum that could pass int64 (the caller asks aggregate() itself)."""
        if self.tid != TypeID.INT:
            return NotImplemented
        pos, hit = self.lookup(uids)
        sel = self.values[pos[hit]] if hit.any() else self.values
        if len(sel) == 0:
            return None
        if op in ("min", "max"):
            return Val(TypeID.INT, int(sel.min() if op == "min"
                                       else sel.max()))
        lo, hi = int(sel.min()), int(sel.max())
        if max(-lo, hi) >= (1 << 62) // len(sel):
            return NotImplemented
        total = int(sel.sum(dtype=np.int64))
        return Val(TypeID.FLOAT, float(total) / len(sel)) if op == "avg" \
            else Val(TypeID.INT, total)


class VarValue:
    """A recorded variable (reference query.varValue). dev is the card's
    copy of uids, where uids is a level's dest as its device gather made
    it (SubGraph.card_dest); uid(...) unions read it (us.union_parts). A
    value var is a dict of uid → Val (vals), or columns (cols), from which
    vals is built when a reader first asks for it."""

    __slots__ = ("uids", "_vals", "is_uid", "dev", "cols")

    def __init__(self, uids: np.ndarray | None = None,
                 vals: dict[int, Val] | None = None, is_uid: bool = True,
                 dev: torch.Tensor | None = None,
                 cols: ValueColumns | None = None) -> None:
        self.uids = uids                    # uid var
        self._vals = vals
        self.is_uid = is_uid
        self.dev = dev
        self.cols = cols

    @property
    def vals(self) -> dict[int, Val]:
        if self._vals is None:
            self._vals = self.cols.as_dict() if self.cols is not None \
                else {}
        return self._vals


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
    # (the dest_uids array, the card's copy of it) where a device gather
    # made both (task.TaskResult.dest_dev); read through card_dest
    dest_dev: tuple | None = None

    def card_dest(self) -> torch.Tensor | None:
        """The card's copy of dest_uids while dest_uids is still the
        gather's array, else None: a step that gives the level another
        dest (a filter, pagination, a facet filter, @cascade) leaves the
        copy behind."""
        if self.dest_dev is None:
            return None
        host, dev = self.dest_dev
        return dev if host is self.dest_uids else None


class Executor:
    """Executes one parsed request against a snapshot; the device is the
    snapshot's.

    The embedded single-process analog of the reference's server: no RPC —
    the same code path their tests exercise via the in-process worker
    (query/query_test.go TestMain, SURVEY.md §4).
    """

    def __init__(self, snap: GraphSnapshot, schema: SchemaState,
                 dispatch=None, cache=None, gate=None,
                 edge_limit: int | None = None,
                 plan=None, explain: dict | None = None,
                 mesh=None, batcher=None, on_task=None):
        self.snap = snap
        self.schema = schema
        # mesh deployment mode (parallel/mesh_exec.MeshExecutor): multi-hop
        # expansion chains over mesh-sharded tablets run as ONE mesh
        # program instead of one dispatch per hop; recurse/shortest
        # consult it too. None = classic per-task dispatch only.
        self.mesh = mesh
        # fused-coverage accounting: per query, how many fused mesh
        # programs ran, how many labeled fallbacks were recorded, and
        # whether mesh-owned tablets were touched at all — execute() folds
        # the three into the mesh executor's coverage ratio. A single-task
        # serve of a mesh tablet is already at minimal dispatch count, so
        # it counts as covered; only labeled fallbacks mark a query
        # unfused.
        self._mesh_fused = 0
        self._mesh_misses = 0
        self._mesh_touched = False
        # physical plan (query/planner.py): order decisions only — root
        # source selection, AND-filter order, sibling order, dispatch
        # cutover. None = parse-order execution. `explain` is a per-query
        # {step id: actual cardinality} recorder feeding EXPLAIN.
        self.plan = plan
        self.explain = explain
        self.vars: dict[str, VarValue] = {}
        self.traversed_edges = 0
        # per-request edge budget override; None = module default (read
        # dynamically so set_query_edge_limit still applies)
        self.edge_limit = edge_limit
        self.gate = gate               # DispatchGate | None
        # task dispatch seam (ProcessTaskOverNetwork): the default executes
        # against the local snapshot; a dispatcher may route each task
        # elsewhere
        self._remote = dispatch is not None
        raw = dispatch or (
            lambda q: process_task(self.snap, q, self.schema))
        if gate is not None:
            from dgraph_tpu_torch.query.batch import kernel_klass

            inner = raw
            # klass hint: the batcher refines the coarse kernel_klass with
            # its classification (host-path fallbacks feed the gate's
            # "host" EWMA class, not the device-class estimates)
            raw = lambda q, klass=None: gate.run(
                lambda: inner(q),
                klass=klass if klass is not None else kernel_klass(q))
        # device-dispatch batcher (query/batch.py): between the
        # singleflight tier (which dedupes IDENTICAL tasks — only flight
        # leaders reach this seam) and the gate, DISTINCT compatible
        # device-class tasks from concurrent queries pack into ONE batched
        # launch. Local snapshots only.
        self.batcher = batcher if dispatch is None else None
        if self.batcher is not None:
            ungated = raw
            solo = raw if gate is not None else (
                lambda q, klass=None: ungated(q))
            raw = lambda q: self.batcher.dispatch(self.snap, self.schema,
                                                  q, solo)
        if cache is not None:
            from dgraph_tpu_torch.query.qcache import task_token

            # per-PREDICATE tokens (not per-snapshot): a commit to P rotates
            # only P's task keys, so unrelated predicates keep their cache
            # heat across writes (the delta-overlay tier's cache contract)
            self._dispatch = lambda q: cache.dispatch(
                task_token(snap, q), q, raw)
        else:
            self._dispatch = raw
        self._dispatch = self._traced_dispatch(self._dispatch)
        if on_task is not None:
            # per-task accounting seam: the hook sees every dispatched
            # task — cache tiers and gate run inside, so the elapsed time
            # is what the caller experienced
            inner_hooked = self._dispatch

            def _counted(q, _inner=inner_hooked, _hook=on_task):
                import time as _time

                t0 = _time.monotonic()
                res = _inner(q)
                try:
                    _hook(q, res, _time.monotonic() - t0)
                except Exception:
                    pass          # accounting must never fail a query
                return res
            self._dispatch = _counted

    @staticmethod
    def _traced_dispatch(inner):
        """Span per task at the dispatch seam (`task:<attr>`, recorded on
        every request, sampled or not): cache tiers and the gate run
        INSIDE the span, so cache hit/miss and wait time are attributed to
        the task that caused them.

        The per-task deadline check lives here too: a budgeted multi-hop
        query gives up BETWEEN tasks the moment its budget runs out (typed
        DeadlineExceeded) — even when every remaining task would be a
        cache hit — instead of finishing work nobody is waiting for.

        The cost ledger (obs/costs.py) attributes here as well: the task's
        predicate scopes every device-kernel charge below, and the task's
        traversed edges land on the per-predicate row — one contextvar
        read when unarmed."""
        from dgraph_tpu_torch.utils import deadline as _dl

        def traced(q):
            if _dl.current() is not None:      # unbudgeted: zero cost
                _dl.check(f"task:{q.attr}")
            with otrace.span("task:" + q.attr) as sp:
                if sp:
                    sp.set(attr=q.attr)
                    if q.func is not None:
                        sp.set(func=q.func[0])
                    if q.frontier is not None:
                        sp.set(frontier=int(len(q.frontier)))
                lg = costs.current()
                if lg is None:
                    res = inner(q)
                else:
                    attr = q.attr[1:] if q.attr.startswith("~") else q.attr
                    with lg.task(attr):
                        res = inner(q)
                    lg.add_task(attr, int(res.traversed_edges))
                if sp:
                    sp.set(dest=int(len(res.dest_uids)),
                           edges=int(res.traversed_edges))
                return res
        return traced

    def edge_budget(self) -> int:
        """Effective traversed-edge budget for this request (read at call
        time, so set_query_edge_limit applies)."""
        return self.edge_limit if self.edge_limit is not None \
            else MAX_QUERY_EDGES

    def gated(self, fn, klass: str | None = None):
        """Run a device-step closure through the dispatch gate when one is
        installed (recurse kernel steps that bypass _dispatch). klass feeds
        the gate's per-kernel-class EWMA so shed decisions use the right
        step estimate."""
        return self.gate.run(fn, klass=klass) if self.gate is not None \
            else fn()

    def batched_recurse(self, g, seeds_mask, depth: int, allow_loop: bool,
                        solo):
        """Fused-recurse seam of the dispatch batcher: compatible
        concurrent traversals (same PullGraph object — which pins tablet
        and snapshot — same depth and loop rule) stack their seed masks
        into one multi-source run (ops/pull_bfs.recurse_fused_multi)
        instead of serializing through the gate one fused recurse each."""
        if self.batcher is not None:
            return self.batcher.dispatch_recurse(g, seeds_mask, depth,
                                                 allow_loop, solo)
        return self.gated(solo, klass="recurse")

    # ------------------------------------------------------------------ API

    def execute(self, req: dql.ParsedRequest) -> dict:
        """Run all query blocks in dependency waves (query/query.go:2431)."""
        with otrace.span("execute"):
            return self._execute(req)

    def _execute(self, req: dql.ParsedRequest) -> dict:
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
            with otrace.span("encode"):
                encode_result(self, b, out)
        if self.mesh is not None and (self._mesh_fused or
                                      self._mesh_misses or
                                      self._mesh_touched):
            # mesh-relevant query: the ratio of the two counters is the
            # fused-coverage number the /debug/metrics mesh section shows
            self.mesh.note_query(self._mesh_misses == 0)
        return out

    def _mesh_miss(self, reason: str) -> None:
        """One labeled fused-coverage miss for this query."""
        self._mesh_misses += 1
        if self.mesh is not None:
            self.mesh.fallback(reason)

    # ---------------------------------------------------------------- blocks

    def _process_block(self, sg: SubGraph) -> None:
        with otrace.span("block"):
            self._run_block(sg)

    def _run_block(self, sg: SubGraph) -> None:
        gq = sg.gq
        if gq.shortest is not None:
            from dgraph_tpu_torch.query.shortest import shortest_path

            shortest_path(self, sg)
            return
        if self._try_vector_fused(sg):
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
        # (host uids, the card's copy or None), unioned by us.union_parts
        uids: list[tuple] = []
        if gq.uids:
            want = np.unique(np.asarray(gq.uids, dtype=np.int64))
            if self._remote:
                # existence spans groups the local snapshot can't see;
                # accept explicit uids as-is
                uids.append((want, None))
            else:
                present = _known_uids(self.snap)
                uids.append((_in_sorted(want, present)
                             if len(present) else want, None))
        uids += self._var_parts(gq.root_uid_vars)
        if gq.func is not None:
            fn = gq.func
            if self.plan is not None:
                sw = self.plan.root_swap.get(id(gq))
                if sw is not None:
                    # planner root-source swap: the selective index probe
                    # runs as the root; the demoted root function re-enters
                    # at the probe's old filter position (_eval_filter)
                    fn = sw.new_func
            uids.append((self._run_root_func(fn), None))
        if not uids:
            if self.plan is not None:
                self.plan.record(gq, 0, self.explain)
            return np.zeros(0, np.int64)
        out = us.union_parts(uids, self.snap.device,
                             getattr(self.snap, "metrics", None))
        if self.plan is not None:
            self.plan.record(gq, len(out), self.explain)
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
        res = self._dispatch(q)
        if fn.name.lower() == "similar_to" and res.value_matrix:
            # val() score exposure: the top-k distances bind the reserved
            # `vector_distance` value var — read it with
            # val(vector_distance) / orderasc: val(vector_distance)
            self.vars["vector_distance"] = VarValue(
                vals={int(u): row[0]
                      for u, row in zip(res.dest_uids, res.value_matrix)
                      if row},
                is_uid=False)
        return res.dest_uids

    # ---------------------------------------------------------------- levels

    def _finish_level(self, sg: SubGraph, is_root: bool) -> None:
        """Filter → order/paginate → record vars → children (ProcessGraph
        tail). Child levels already applied filter + pagination per
        uidMatrix row (the reference's applyPagination works per row)."""
        gq = sg.gq
        if is_root:
            swap = self.plan.root_swap.get(id(gq)) \
                if self.plan is not None else None
            sg.dest_uids = self._apply_filter(gq.filter, sg.dest_uids,
                                              swap=swap)
        if gq.groupby is not None:
            from dgraph_tpu_torch.query.groupby import process_groupby

            process_groupby(self, sg)
            self._record_uid_var(gq, sg)
            return
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
        """Expand each child over this level's DestUIDs, one task each.

        With a plan, independent siblings expand cheapest-estimate-first
        (the planner guarantees no sibling defines or reads a var); result
        slots are restored to declaration order so output encoding — which
        walks sg.children — is byte-identical either way."""
        gq = sg.gq
        frontier = _sorted(sg.dest_uids)
        eff = self._effective_children(gq, frontier)
        if self.mesh is not None and len(frontier) and \
                self._mesh_fused_plan(sg, eff, frontier):
            return
        order = None
        if self.plan is not None:
            order = self.plan.child_order.get(id(gq))
            if order is not None and len(order) != len(eff):
                order = None    # expand() reshaped the list: declaration order
        slots: list[SubGraph | None] = [None] * len(eff)
        seq = [(i, eff[i]) for i in order] if order is not None \
            else list(enumerate(eff))
        for slot, cgq in seq:
            if cgq.is_uid_node or cgq.attr in ("val", "math") or \
               cgq.attr.startswith("__agg_"):
                child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=frontier)
                self._compute_virtual_child(sg, child, frontier)
                slots[slot] = child
                continue
            child = self._run_child_task(cgq, frontier)
            slots[slot] = child
            if cgq.children or cgq.cascade:
                self._finish_level(child, is_root=False)
        sg.children.extend(c for c in slots if c is not None)

    def _run_child_task(self, cgq: dql.GraphQuery,
                        frontier: np.ndarray) -> SubGraph:
        """One non-virtual child level through the dispatch seam: expand /
        value fetch, facet filter, per-row filter + pagination, var
        recording."""
        child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=frontier)
        if self.mesh is not None and self._mesh_hop_csr(cgq) is not None:
            # a one-task serve of a mesh-owned tablet: already at the
            # minimal dispatch count, covered for the coverage ratio
            self._mesh_touched = True
        tq = TaskQuery(cgq.attr, frontier=frontier, lang=cgq.lang)
        if cgq.facets is not None:
            # every facet comes back; the encoder keeps the asked keys
            tq.facet_keys = [k for _, k in cgq.facets.keys] or ["__all__"]
        if self.plan is not None:
            # estimated-frontier-size-driven host/device dispatch
            # cutover (0 = the static task.HOST_EXPAND_MAX default)
            tq.cutover = self.plan.cutover.get(id(cgq), 0)
        res = self._dispatch(tq)
        if self.plan is not None:
            self.plan.record(cgq, res.traversed_edges, self.explain)
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
        if res.dest_dev is not None:
            child.dest_dev = (res.dest_uids, res.dest_dev)
        child.traversed = res.traversed_edges
        if cgq.facets is not None and cgq.facets.filter is not None:
            self._apply_facet_filter(child)
        if child.uid_matrix and (cgq.filter is not None or
                                 cgq.args.get("first") or cgq.args.get("offset")):
            self._apply_child_row_mods(child)
        self._record_child_vars(cgq, child, frontier)
        return child

    # ------------------------------------------------------------- mesh mode

    def _mesh_hop_csr(self, cgq: dql.GraphQuery):
        """The mesh-sharded adjacency a chain hop expands over, or None."""
        attr = cgq.attr
        rev = attr.startswith("~")
        pd = self.snap.pred(attr[1:] if rev else attr)
        if pd is None:
            return None
        csr = pd.rev_csr if rev else pd.csr
        return csr if (csr is not None and self.mesh.owns(csr)) else None

    def _mesh_break_reason(self, cgq: dql.GraphQuery) -> str | None:
        """Why an UNOWNED tablet broke the chain — labeled only when the
        tablet would have been mesh-class: a delta overlay awaiting
        compaction, or shards the working-set manager declined to admit.
        Small replicated tablets break chains silently (host-class by
        design, not a coverage gap)."""
        from dgraph_tpu_torch.query import fusedplan as fp
        from dgraph_tpu_torch.storage.delta import OverlayCSR

        attr = cgq.attr
        rev = attr.startswith("~")
        pd = self.snap.pred(attr[1:] if rev else attr)
        csr = (pd.rev_csr if rev else pd.csr) if pd is not None else None
        if isinstance(csr, OverlayCSR):
            return fp.REASON_OVERLAY
        if getattr(csr, "_mesh_deferred", False):
            return fp.REASON_BUDGET
        return None

    def _mesh_fused_plan(self, sg: SubGraph, eff: list,
                         frontier: np.ndarray) -> bool:
        """Execute the whole physical plan below this level as ONE mesh
        dispatch (parallel/mesh_exec.run_plan): the expansion chain WITH
        its pointwise filters (allow-set membership formulas) and per-row
        pagination windows runs fused; facet reads, value-predicate
        co-children, count children, and virtual nodes layer host-side on
        the fused traversal's per-level frontiers (query/fusedplan.py).
        Returns False when the shape doesn't qualify — the caller runs
        the classic loop, byte-identical — recording the labeled
        fallback reason whenever the miss actually cost fusion."""
        from dgraph_tpu_torch.query import fusedplan as fp

        gq = sg.gq
        if any(c.expand for c in gq.children):
            return False        # expand() reshaped eff: classic handles
        ir = None
        if self.plan is not None:
            ir = self.plan.fused_chains.get(id(gq))
        if ir is None:
            ir = fp.chain_ir(gq, self.schema)
        # execution-time narrowing: the IR is AST-shaped; ownership
        # (sharded vs replicated vs overlay vs residency-deferred)
        # truncates the chain here
        hops: list[fp.HopIR] = []
        csrs: list = []
        reason = ir.stop_reason if ir.stop_cost else None
        for hop in ir.hops:
            csr = self._mesh_hop_csr(hop.gq)
            if csr is None:
                r = self._mesh_break_reason(hop.gq)
                if r is not None and (hops or
                                      fp._subtree_has_expansion(
                                          hop.gq, self.schema)):
                    reason = reason or r
                break
            hops.append(hop)
            csrs.append(csr)
        if hops:
            self._mesh_touched = True
        # terminal stage eligibility: the groupby rides only when the
        # whole chain fused up to it AND the key tablet is mesh-owned —
        # otherwise the hops still fuse and the groupby assembles classic
        term = ir.terminal if (ir.terminal is not None
                               and len(hops) == len(ir.hops)) else None
        tcsr = None
        if term is not None:
            tpd = self.snap.pred(term.key_attr)
            kc = tpd.csr if tpd is not None else None
            if kc is not None and self.mesh.owns(kc):
                tcsr = kc
            else:
                from dgraph_tpu_torch.storage.delta import OverlayCSR

                if isinstance(kc, OverlayCSR):
                    reason = reason or fp.REASON_OVERLAY
                elif getattr(kc, "_mesh_deferred", False):
                    reason = reason or fp.REASON_BUDGET
                term = None
        # one hop + a terminal reduce still beats two dispatches; a bare
        # single hop does not
        if len(hops) < (1 if tcsr is not None else 2):
            if reason is not None:
                self._mesh_miss(reason)
            return False
        try:
            sets = [fp.resolve_sets(self, hop) for hop in hops]
        except Exception:
            # a leaf whose resolution raises (missing index, bad args)
            # goes classic: the stepped path raises the same typed error
            # at the same filter — or never reaches it on an empty
            # frontier, which is exactly the semantics to preserve
            self._mesh_miss(fp.REASON_FILTER)
            return False
        terminal = None
        kept_aggs: list = []
        if tcsr is not None:
            # per-agg value planes in the key tablet's sharded row layout
            # (local row j of shard s ↔ host mirror row s*rows_per+j);
            # non-numeric val vars (datetime/string) drop that agg from
            # the device ops — the host computes it anyway
            from dgraph_tpu_torch.utils.types import to_device_scalar

            subs_h, _ip, _ix = tcsr.host_arrays()
            rows_cap = self.mesh.n_devices * tcsr.rows_per
            tops: list = []
            tavals: list = []
            for op, ref, cgq in term.aggs:
                plane = np.full(rows_cap, np.nan, dtype=np.float32)
                vv = self.vars.get(ref)
                vals = getattr(vv, "vals", None) if vv is not None else None
                if vals:
                    try:
                        u = np.asarray(list(vals.keys()), dtype=np.int64)
                        v = np.asarray(
                            [float(to_device_scalar(x)) if isinstance(x, Val)
                             else float(x) for x in vals.values()],
                            dtype=np.float64)
                    except (TypeError, ValueError):
                        continue
                    r_ = us.host_rank_of(subs_h, np.sort(u), -1)
                    order_ = np.argsort(u, kind="stable")
                    hit_ = r_ >= 0
                    plane[r_[hit_]] = v[order_][hit_].astype(np.float32)
                tops.append(op)
                tavals.append(plane.reshape(self.mesh.n_devices,
                                            tcsr.rows_per))
                kept_aggs.append((op, ref, cgq))
            terminal = (tcsr, tuple(tops), tavals)
        with costs.kernel("mesh.plan") as ck:
            run = lambda: self.mesh.run_plan(
                [(c, h.formula, s, h.first, h.offset)
                 for c, h, s in zip(csrs, hops, sets)], frontier,
                terminal=terminal)
            got = self.gated(run, klass="mesh")
        term_out = None
        if terminal is not None:
            levels, term_out = got
        else:
            levels = got
        lg = costs.current()
        if lg is not None and ck.ms > 0:
            # ONE launch traversed every hop: apportion its device ms to
            # the per-predicate rows by each hop's traversed edges, so
            # /debug/top?group=pred points at the tablet actually burning
            # the device instead of whichever predicate led the chain
            trav = [max(int(lv[1]), 0) for lv in levels[: len(hops)]]
            preds = [hop.gq.attr for hop in hops]
            if term_out is not None:
                trav.append(max(int(term_out["traversed"]), 0))
                preds.append(term.key_attr)
            tot = float(sum(trav))
            for a, t in zip(preds, trav):
                frac = (t / tot) if tot > 0 else 1.0 / len(preds)
                lg.attribute_pred_ms(a, ck.ms * frac)
        self._mesh_fused += 1
        parent = sg
        fr = frontier
        for i, (hop, csr, hsets) in enumerate(zip(hops, csrs, sets)):
            _fr_in, traversed, nxt = levels[i]
            # host replay: pruned uidMatrix rows from the host mirrors
            # with the SAME allow-sets/windows the device applied —
            # byte-identical to _apply_child_row_mods by construction
            matrix, counts, dest, _raw = fp.replay_hop(csr, fr, hop,
                                                       hsets)
            fused = SubGraph(gq=hop.gq, attr=hop.gq.attr, src_uids=fr)
            fused.uid_matrix = matrix
            fused.counts = counts
            fused.dest_uids = dest
            fused.traversed = traversed
            if hop.facets:
                rev = hop.attr.startswith("~")
                pd = self.snap.pred(hop.attr[1:] if rev else hop.attr)
                fused.facet_matrix = [
                    [pd.facets.get((int(s_), int(o)), ()) for o in m]
                    for s_, m in zip(fr, matrix)]
            if self.plan is not None:
                self.plan.record(hop.gq, traversed, self.explain)
            lg = costs.current()
            if lg is not None:
                # fused hops bypass _dispatch: attribute their traversed
                # edges to the hop's predicate here instead
                a = hop.gq.attr
                lg.add_task(a[1:] if a.startswith("~") else a, traversed)
            self.traversed_edges += traversed
            if self.traversed_edges > self.edge_budget():
                raise QueryError("query exceeded edge budget (ErrTooBig)")
            # this level's children in DECLARATION order, the fused hop
            # attached at its slot with vars recorded at that point —
            # exactly the classic walk's binding order
            level_children = eff if parent is sg else parent.gq.children
            for cgq in level_children:
                if cgq is hop.gq:
                    self._record_child_vars(cgq, fused, fr)
                    parent.children.append(fused)
                    continue
                if cgq.is_uid_node or cgq.attr in ("val", "math") or \
                        cgq.attr.startswith("__agg_"):
                    vchild = SubGraph(gq=cgq, attr=cgq.attr, src_uids=fr)
                    self._compute_virtual_child(parent, vchild, fr)
                    parent.children.append(vchild)
                    continue
                co = self._run_child_task(cgq, fr)
                parent.children.append(co)
                if cgq.children or cgq.cascade:
                    self._finish_level(co, is_root=False)
            parent = fused
            fr = np.sort(dest)
            if not np.array_equal(fr, nxt):
                # defense in depth: the device frontier disagreeing with
                # the host replay would mean a program bug — the host
                # mirrors are the truth the classic path serves from
                raise QueryError("mesh fused frontier diverged")
        if term_out is not None:
            # the device terminal's per-rank member counts + f32 agg
            # candidates ride to the host groupby assembly (which stays
            # authoritative) for the byte-identity cross-check
            parent._fused_gb = {
                "table": term_out["table"],
                "counts": term_out["counts"],
                "aggs": {id(cgq): {"op": op,
                                   "cand": term_out["aggs"][i][0],
                                   "cntv": term_out["aggs"][i][1]}
                         for i, (op, _ref, cgq) in enumerate(kept_aggs)},
            }
            self.mesh.metrics.counter(
                "dgraph_agg_terminal_ops_total").inc()
        # the last chain hop's own subtree (and @cascade) continues classic
        if hops[-1].gq.children or hops[-1].gq.cascade:
            self._finish_level(parent, is_root=False)
        return True

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
            if vv is not None and vv.cols is not None:
                child.value_matrix = [[v] if v is not None else []
                                      for v in vv.cols.vals_of(frontier)]
            elif vv is not None:
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
            if vv is not None and vv.cols is not None:
                got = vv.cols.aggregate(op, frontier)
                if got is not NotImplemented:
                    child.agg_value = got
                    return
            vals = vv.vals if vv else {}
            # aggregate over the enclosing block's uid space when non-empty
            keys = [int(u) for u in frontier if int(u) in vals] or list(vals)
            child.agg_value = aggregate(op, [vals[k] for k in keys])

    # ---------------------------------------------------------------- filters

    def _apply_filter(self, ft: dql.FilterTree | None,
                      frontier: np.ndarray, swap=None) -> np.ndarray:
        if ft is None or len(frontier) == 0:
            return frontier
        return self._eval_filter(ft, frontier, swap)

    def _eval_filter(self, ft: dql.FilterTree, frontier: np.ndarray,
                     swap=None) -> np.ndarray:
        if ft.func is not None:
            fn = ft.func
            if swap is not None and id(ft) == swap.leaf_id:
                # this leaf's probe was promoted to the root; the demoted
                # root function evaluates here instead (root ∩ filters is
                # symmetric — every filter function is pointwise)
                fn = swap.orig_func
            out = self._eval_filter_func(fn, frontier)
            if self.plan is not None:
                self.plan.record(ft, len(out), self.explain,
                                 bound=len(frontier))
            return out
        if ft.op == "and":
            order = self.plan.and_order.get(id(ft)) \
                if self.plan is not None else None
            if order is not None:
                # planned: most-selective-first with short-circuit
                # frontier intersection. Every filter function evaluates
                # pointwise (result ⊆ frontier, membership of u depends
                # only on u), so evaluating child k over the frontier
                # already narrowed by children 0..k-1 yields exactly the
                # parse-order intersection.
                out = frontier
                for i in order:
                    if len(out) == 0:
                        break
                    out = self._eval_filter(ft.children[i], out, swap)
                return out
        parts = [self._eval_filter(c, frontier, swap) for c in ft.children]
        if ft.op == "and":
            out = parts[0]
            for p in parts[1:]:
                out = us.intersect_host(out, p, self.snap.device)
            return out
        if ft.op == "or":
            out = parts[0]
            for p in parts[1:]:
                out = us.union_host(out, p, self.snap.device)
            return out
        if ft.op == "not":
            return us.difference_host(frontier, parts[0],
                                      self.snap.device)
        raise QueryError(f"bad filter op {ft.op}")

    def _eval_filter_func(self, fn: dql.Function,
                          frontier: np.ndarray) -> np.ndarray:
        name = fn.name.lower()
        if name == "uid":
            uids, refs = dql._split_uid_args(fn.args)
            sel = us.union_parts(
                [(np.asarray(uids, dtype=np.int64), None)]
                + self._var_parts(refs),
                self.snap.device, getattr(self.snap, "metrics", None))
            return us.intersect_host(frontier, sel, self.snap.device)
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
            return us.intersect_host(frontier, root, self.snap.device)
        if name in ("has", "uid_in", "checkpwd") or (
                name in ("eq", "le", "lt", "ge", "gt") and tid != TypeID.UID):
            # pointwise over the frontier: value presence, a value compare
            # (float64 host mirror or stored values), uid_in, checkpwd
            q = TaskQuery(fn.attr, frontier=frontier,
                          func=(name, list(fn.args)), lang=fn.lang)
            return self._dispatch(q).dest_uids
        # index-backed functions: run at root, intersect with frontier
        root = self._run_root_func(fn)
        return us.intersect_host(frontier, root, self.snap.device)

    def _var_parts(self, names) -> list[tuple]:
        """(host uids, the card's copy or None) of each named var that is
        set: a uid var's uids, a value var's keys."""
        out = []
        for v in names:
            vv = self.vars.get(v)
            if vv is not None and vv.uids is not None:
                out.append((vv.uids, vv.dev))
            elif vv is not None and vv.cols is not None:
                out.append((vv.cols.keys, vv.cols.keys_dev))
            elif vv is not None and not vv.is_uid:
                out.append((np.asarray(sorted(vv.vals), dtype=np.int64),
                            None))
        return out

    # ----------------------------------------------------- fused ANN pipeline

    def _vector_fusable(self, gq: dql.GraphQuery):
        """Shape check for the fused ANN->expand pipeline: a bare
        similar_to root feeding exactly one plain uid expansion, over a
        device-resident plain vector index and plain PredCSR. Anything
        needing host logic between the two stages (filters, pagination,
        order, overlays, IVF) falls back to the classic
        stepped path — results are identical either way (the shared
        float64 ranking rule, storage/vecindex.py)."""
        from dgraph_tpu_torch.storage.csr_build import PredCSR

        fn = gq.func
        if (fn is None or fn.name.lower() != "similar_to" or gq.uids
                or gq.root_uid_vars or gq.filter is not None or gq.order
                or gq.recurse is not None or gq.groupby is not None
                or gq.cascade or not gq.children):
            return None
        if any(gq.args.get(a) for a in ("first", "offset", "after")):
            return None
        pd = self.snap.pred(fn.attr)
        vi = pd.vecindex if pd is not None else None
        if vi is None or vi.is_overlay or vi._mesh is not None \
                or self.schema.vector_spec(fn.attr) is None:
            return None
        # an IVF-equipped tablet answers through the approximate coarse
        # quantizer on the classic path; the fused program is brute-force
        # only, so fusing it would make the SAME root return different
        # candidates depending on incidental query shape — fuse only when
        # the classic path would brute-force too
        if vi.ivf is not None:
            return None
        # the same size-adaptive host/device cutover as the classic path:
        # a tiny tablet answers faster by float64 host scan + host expand
        # than by a device dispatch
        from dgraph_tpu_torch.storage import vecindex as vecmod

        if vi.n * vi.dim <= vecmod.HOST_SCAN_MAX:
            return None
        # plain `uid` selections are virtual (no dispatch); exactly one
        # real expansion child may ride the fused program
        expands = [c for c in gq.children
                   if not (c.is_uid_node and c.filter is None
                           and not c.var_name and not c.args)]
        if len(expands) != 1:
            return None
        cgq = expands[0]
        if (cgq.expand or cgq.is_uid_node or cgq.is_count or cgq.checkpwd
                or cgq.attr in ("val", "math")
                or cgq.attr.startswith("__agg_") or cgq.attr.startswith("~")
                or cgq.filter is not None or cgq.facets is not None
                or cgq.lang or cgq.cascade or cgq.groupby is not None
                or cgq.order or cgq.var_name):
            return None
        if any(cgq.args.get(a) for a in ("first", "offset", "after")):
            return None
        cpd = self.snap.pred(cgq.attr)
        if cpd is None or not isinstance(cpd.csr, PredCSR) or \
                cpd.csr.num_edges == 0:
            return None
        # residency tier consult: a COLD vector matrix or expansion CSR
        # (device footprint > budget, storage/residency.py) must not ride
        # the fused device program — the classic stepped path serves it
        # through the host-cutover machinery, byte-identically
        if vi.prefer_host() or cpd.csr.prefer_host():
            return None
        return vi, cgq, cpd.csr

    def _try_vector_fused(self, sg: SubGraph) -> bool:
        """Hybrid ANN -> graph hop as ONE device dispatch
        (ops/vector.ann_expand): top-k candidates, uid->CSR-row mapping,
        and the frontier expansion never leave the device; the host only
        re-ranks the candidates in float64 and slices the expansion rows
        of the selected k. The span tree shows a single device_kernel
        between the two logical stages."""
        from dgraph_tpu_torch.ops import vector as vops
        from dgraph_tpu_torch.query.task import parse_similar_args

        gq = sg.gq
        shape = self._vector_fusable(gq)
        if shape is None:
            return False
        vi, cgq, csr = shape
        pd = self.snap.pred(gq.func.attr)
        try:
            vec, k = parse_similar_args(pd, list(gq.func.args))
        except Exception:
            return False          # bad args: classic path raises typed
        if len(vec) != vi.dim or vi.n == 0:
            return False
        metrics = getattr(self.snap, "metrics", None)
        kprime = vops.k_capacity(k, vops.row_capacity(vi.n))
        ecap = 1 << max(int(np.ceil(np.log2(
            min(csr.num_edges, kprime * max(csr.max_degree(), 1)) + 1))), 4)
        from dgraph_tpu_torch.utils.faults import FaultError

        try:
            mat, norms, subs_dev = vi.device()
            c_subs, c_ptr, c_idx = csr.device_arrays()
            dr = torch.zeros(0, dtype=torch.int32)
            with costs.kernel("vector.ann_expand", attr=gq.func.attr,
                              rows=int(vi.n), k=kprime, ecap=ecap) as ck:
                qv = torch.from_numpy(vec).to(mat.device)
                nd, uids, res = self.gated(lambda: vops.ann_expand(
                    mat, norms, qv, vi.n, dr,
                    subs_dev, c_subs, c_ptr, c_idx,
                    k=kprime, metric=vi.metric, ecap=ecap),
                    klass="vector")
                nd_h = nd.cpu().numpy()
                uids_h = uids.cpu().numpy()
                counts_h = res.counts.cpu().numpy()
                targets_h = res.targets.cpu().numpy()
                ck.set(h2d=int(vec.nbytes),
                       d2h=int(nd_h.nbytes + uids_h.nbytes
                               + counts_h.nbytes + targets_h.nbytes))
                counts_h = counts_h[:kprime]
                uids_h = uids_h.astype(np.int64)
                if ck.sampled:
                    ck.annotate(edges=int(res.total))
        except FaultError:
            # injected residency.h2d_upload fault before any result state
            # was written: the classic stepped path (which falls back to
            # host scans itself) serves the query byte-identically
            return False
        ok = nd_h > -np.inf
        cand_uids = uids_h[ok]
        if len(cand_uids) == 0:
            sel_uids = np.zeros(0, np.int64)
            dists = np.zeros(0, np.float64)
        else:
            # float64 re-score + (dist, uid) rank: the ONE selection rule,
            # shared with the classic/host/IVF paths in vecindex
            from dgraph_tpu_torch.storage import vecindex as vx

            rows = us.host_rank_of(vi.subjects, cand_uids, -1)
            uids64, d = vx._rescore(vi, rows, vec.astype(np.float64))
            sel_uids, dists = vx._rank(d, uids64, k)
        if metrics is not None:
            metrics.counter("dgraph_vector_searches_total").inc()
            metrics.counter("dgraph_vector_fused_pipelines_total").inc()
        # root level: dest set + distance var, exactly like the classic path
        so = np.argsort(sel_uids, kind="stable")
        sg.src_uids = sg.dest_uids = sel_uids[so]
        self.vars["vector_distance"] = VarValue(
            vals={int(u): Val(TypeID.FLOAT, float(dd))
                  for u, dd in zip(sel_uids, dists)},
            is_uid=False)
        if self.plan is not None:
            self.plan.record(gq, len(sg.dest_uids), self.explain)
        self._record_uid_var(gq, sg)
        # child level: slice the fused expansion rows of the selected uids
        offs = np.zeros(kprime + 1, dtype=np.int64)
        np.cumsum(counts_h, out=offs[1:])
        slot_of = {int(u): j for j, u in enumerate(uids_h)}
        frontier = sg.dest_uids
        matrix, traversed = [], 0
        for u in frontier.tolist():
            j = slot_of.get(int(u))
            if j is None:
                matrix.append(np.zeros(0, np.int64))
                continue
            row = targets_h[offs[j]: offs[j + 1]].astype(np.int64)
            matrix.append(row)
            traversed += len(row)
        child = SubGraph(gq=cgq, attr=cgq.attr, src_uids=frontier)
        child.uid_matrix = matrix
        child.counts = [len(m) for m in matrix]
        child.dest_uids = (np.unique(np.concatenate(matrix))
                           if any(len(m) for m in matrix)
                           else np.zeros(0, np.int64))
        child.traversed = traversed
        if self.plan is not None:
            self.plan.record(cgq, traversed, self.explain)
        lg = costs.current()
        if lg is not None:
            # fused child bypassed _dispatch; normalize like every other
            # attribution site (the fusable check rejects reverse attrs
            # today, but the stripping must not depend on that)
            a = cgq.attr
            lg.add_task(a[1:] if a.startswith("~") else a, traversed)
        self.traversed_edges += traversed
        if self.traversed_edges > self.edge_budget():
            raise QueryError("query exceeded edge budget (ErrTooBig)")
        self._record_child_vars(cgq, child, frontier)
        # children in declaration order: virtual uid selections compute
        # host-side; the expansion child carries the fused matrices
        for c in gq.children:
            if c is cgq:
                sg.children.append(child)
                continue
            vchild = SubGraph(gq=c, attr=c.attr, src_uids=frontier)
            self._compute_virtual_child(sg, vchild, frontier)
            sg.children.append(vchild)
        if cgq.children or cgq.cascade:
            self._finish_level(child, is_root=False)
        return True

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
            # a level's dest is ascending already, a root's after an order
            # may not be: _sorted sorts only that one
            uids = _sorted(sg.dest_uids)
            self.vars[gq.var_name] = VarValue(
                uids=uids,
                dev=sg.card_dest() if uids is sg.dest_uids else None)

    def _record_child_vars(self, cgq: dql.GraphQuery, child: SubGraph,
                           frontier: np.ndarray) -> None:
        if cgq.var_name:
            if cgq.is_count:
                vals = {int(u): Val(TypeID.INT, int(c))
                        for u, c in zip(frontier, child.counts)}
                self.vars[cgq.var_name] = VarValue(vals=vals, is_uid=False)
            elif child.value_matrix:
                vals = {int(u): vs[0]
                        for u, vs in zip(frontier, child.value_matrix) if vs}
                self.vars[cgq.var_name] = VarValue(vals=vals, is_uid=False)
            else:
                self.vars[cgq.var_name] = VarValue(uids=child.dest_uids,
                                                   dev=child.card_dest())
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
        """Multi-key order (reference worker/sort.go): the `order` span,
        its time booked in dgraph_order_ns_total.

        Single-key sorts over an indexed sortable predicate walk the token
        buckets in key order (sortWithIndex, worker/sort.go:144-259),
        intersecting each bucket with the candidate set and stopping once
        offset+first is satisfied; a single val(x) key over a var held as
        columns sorts the columns, keeping only offset+first rows where no
        `after` is given; everything else takes the value sort. Stable
        sorts applied from the last key to the first give multi-key
        semantics; uids with a missing sort value sink to the end, in either
        direction."""
        t0 = time.perf_counter_ns()
        with otrace.span("order"):
            out = self._order_uids(gq, uids)
        otrace.count("dgraph_order_ns_total", time.perf_counter_ns() - t0)
        return out

    def _order_uids(self, gq: dql.GraphQuery, uids: np.ndarray) -> np.ndarray:
        first = int(gq.args.get("first", 0))
        bounded = int(gq.args.get("after", 0)) == 0 and first > 0
        if len(gq.order) == 1 and gq.order[0].is_val:
            vv = self.vars.get(gq.order[0].attr)
            if vv is not None and vv.cols is not None:
                need = int(gq.args.get("offset", 0)) + first \
                    if bounded else None
                got = vv.cols.order(uids, gq.order[0].desc, need)
                if got is not None:
                    return got
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
            remote_keys = None
            if not o.is_val and self.snap.pred(o.attr) is None:
                # sort key lives on a remote tablet: fetch the values once
                # through the dispatch seam (ProcessTaskOverNetwork)
                cand = sorted(ordered)
                res = self._dispatch(TaskQuery(
                    o.attr, frontier=np.asarray(cand, np.int64),
                    lang=o.lang))
                remote_keys = {u: sort_key(vals[0]) for u, vals in
                               zip(cand, res.value_matrix) if vals}
            present = [((remote_keys.get(u) if remote_keys is not None
                         else self._order_key(o, u)), u) for u in ordered]
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
            inb = us.intersect_host(bucket, cand, self.snap.device)
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


def _filter_has_similar(ft) -> bool:
    if ft is None:
        return False
    if ft.func is not None and ft.func.name.lower() == "similar_to":
        return True
    return any(_filter_has_similar(c) for c in ft.children)


def _block_defines(gq: dql.GraphQuery) -> set[str]:
    out = set()

    def walk(g: dql.GraphQuery):
        # similar_to — root form OR @filter member, at any level — binds
        # the reserved distance var (_run_root_func), so same-block
        # val(vector_distance) consumers must not count as an unmet
        # dependency
        if (g.func is not None and g.func.name.lower() == "similar_to") \
                or _filter_has_similar(g.filter):
            out.add("vector_distance")
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
    out = _unique_union(parts)
    snap._known_uids_cache = out
    return out


def _unique_union(parts: list[np.ndarray]) -> np.ndarray:
    """np.unique of the int64 uids of every array in `parts`. Where they
    are dense (a snapshot's subjects and objects name each uid many times
    over) one bitmap takes a scatter of each in place of concatenating and
    sorting them; the result is the same."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.zeros(0, np.int64)
    lo = min(int(p.min()) for p in parts)
    hi = max(int(p.max()) for p in parts)
    if lo >= 0 and hi < UNIQUE_BITMAP_SPREAD * sum(len(p) for p in parts):
        seen = np.zeros(hi + 1, dtype=bool)
        for p in parts:
            seen[p] = True
        return np.flatnonzero(seen).astype(np.int64, copy=False)
    return np.unique(np.concatenate(parts))


def _sorted(uids: np.ndarray) -> np.ndarray:
    """uids in ascending order: the array itself where it is already so
    (a var's uids, a level's dest), else a sorted copy."""
    if len(uids) < 2 or bool((uids[1:] >= uids[:-1]).all()):
        return uids
    return np.sort(uids)


def _in_sorted(want: np.ndarray, present: np.ndarray) -> np.ndarray:
    """The uids of `want` found in `present` (sorted, distinct, not
    empty), in want's order: a binary search each, where np.isin would
    sort or tabulate the whole of `present`."""
    pos = np.minimum(np.searchsorted(present, want), len(present) - 1)
    return want[present[pos] == want]


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
