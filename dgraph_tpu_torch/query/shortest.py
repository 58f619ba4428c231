"""Shortest path / k-shortest paths.

Port of dgraph_tpu/query/shortest.py. Reference semantics:
query/shortest.go — ShortestPath
(:437): single-source Dijkstra over an adjacency map accreted by
level-synchronous frontier expansion (expandOut :134-261); edge cost from a
facet else 1.0 (getCost :102); KShortestPath (:274): the k-paths variant,
carrying the whole path per heap item; capped by QueryEdgeLimit returning
ErrTooBig (:214); result materialized as a `_path_` block (:598).

Three tiers, as in the JAX package:
  * kernel: a single-predicate unweighted block over a large CSR runs
    ops/pull_bfs.bfs_dist (one K1 or K2 launch per hop) and walks the
    predecessors on the host;
  * Bellman-Ford: ops/traversal.sssp, for depths of 254 and more (past the
    byte distance labels) and for CSRs below the kernel floor;
  * host: a level-by-level adjacency through the task seam, then Dijkstra
    or loopless k-shortest. It serves facet costs, child filters,
    numpaths > 1, several predicates and small CSRs.
On a mesh (parallel/mesh_exec.py), blocks over mesh-sharded tablets —
several predicates included — run the whole expandOut loop as ONE mesh
program (mesh_exec.run_bfs) with the frontier, visited set and distance
vector on the device between levels; single paths reconstruct straight
from the distance vector, k-shortest rebuilds the level adjacency from it.
The tiers agree on every path's length. On ties they may return different
paths: the kernel tier and Dijkstra take the minimum-uid predecessor at
distance d-1, sssp the maximum (its parent scatter-max), as in the JAX
package.
"""

from __future__ import annotations

import heapq

import numpy as np

from dgraph_tpu_torch.obs import costs, otrace
from dgraph_tpu_torch.query import dql
from dgraph_tpu_torch.query.engine import QueryError, SubGraph, VarValue
from dgraph_tpu_torch.query.task import TaskQuery


def _resolve_end(ex, end) -> int:
    if isinstance(end, dql.VarRef):
        vv = ex.vars.get(end.name)
        if vv is None or vv.uids is None or len(vv.uids) == 0:
            raise QueryError(f"shortest endpoint var {end.name} is empty")
        return int(vv.uids[0])
    return int(end)


def _build_adjacency(ex, sg: SubGraph, src: int, dst: int):
    """Level-synchronous expansion accreting adjacency[from] = [(to, cost, attr)]."""
    spec = sg.gq.shortest
    adj: dict[int, list[tuple[int, float, str]]] = {}
    frontier = np.asarray([src], dtype=np.int64)
    seen: set[int] = {src}
    edges = 0
    max_depth = spec.depth if spec.depth > 0 else 64
    for _level in range(max_depth):
        if len(frontier) == 0:
            break
        next_f: set[int] = set()
        for cgq in sg.gq.children:
            facet_key = None
            if cgq.facets is not None and cgq.facets.keys:
                facet_key = cgq.facets.keys[0][1]
            tq = TaskQuery(cgq.attr, frontier=np.sort(frontier),
                           facet_keys=[facet_key] if facet_key else [])
            res = ex._dispatch(tq)
            edges += res.traversed_edges
            if edges > ex.edge_budget():
                raise QueryError("shortest path exceeded edge budget (ErrTooBig)")
            dests = res.dest_uids
            if cgq.filter is not None:
                allowed = set(int(x) for x in ex._apply_filter(cgq.filter, dests))
            else:
                allowed = None
            for u, targets, facets in zip(
                    np.sort(frontier), res.uid_matrix,
                    res.facet_matrix or [[]] * len(res.uid_matrix)):
                for j, t in enumerate(targets):
                    t = int(t)
                    if allowed is not None and t not in allowed:
                        continue
                    cost = 1.0
                    if facet_key and facets and j < len(facets):
                        fv = dict(facets[j]).get(facet_key)
                        if fv is not None and isinstance(fv.value, (int, float)):
                            cost = float(fv.value)
                    adj.setdefault(int(u), []).append((t, cost, cgq.attr))
                    if t not in seen:
                        seen.add(t)
                        next_f.add(t)
        frontier = np.asarray(sorted(next_f), dtype=np.int64)
    return adj


# Path choice by edge count, per device (as recurse._kernel_min). Tests set
# the module globals to force a tier: DEVICE_SSSP_MIN_EDGES = 0 admits the
# device tiers, 1 << 62 keeps the host tier; SSSP_KERNEL_MIN = 0 sends the
# device range to the kernel tier. A threshold picks a path and never a
# path's length; because the tiers break ties differently (module notes), it
# can change WHICH shortest path comes back.
DEVICE_SSSP_MIN_EDGES: int | None = None   # None = device-dependent default
SSSP_KERNEL_MIN: int | None = None         # None = device-dependent default

# CPU tensors keep the JAX package's CPU behaviour: the device tier from
# 1 << 17 edges, the kernel tier never (its plain versions only). On CUDA
# tensors, bench_torch_crossover.py section 3 on an H100 80GB HBM3 at 700 W
# (R-MAT, edge factor 16, the far pair from seeds[0]): the host tier takes
# 0.70 ms at 508 edges against Bellman-Ford's 1.50, and 3.80 at 2,587
# against 1.62, so the device tiers start near 1 << 10; Bellman-Ford and the
# kernel tier tie at 955,244 edges (5.22 ms each; 2.15 against 2.80 ms at
# 228,088, 8.79 against 6.48 at 3,939,472), so the kernels start at 1 << 20.
_DEVICE_SSSP_MIN_CPU = 1 << 17
_DEVICE_SSSP_MIN_CUDA = 1 << 10
_SSSP_KERNEL_MIN_CUDA = 1 << 20


def _device_sssp_min(csr) -> int:
    if DEVICE_SSSP_MIN_EDGES is not None:
        return DEVICE_SSSP_MIN_EDGES
    return _DEVICE_SSSP_MIN_CUDA if csr.device.type == "cuda" \
        else _DEVICE_SSSP_MIN_CPU


def _sssp_kernel_min(csr) -> int:
    if SSSP_KERNEL_MIN is not None:
        return SSSP_KERNEL_MIN
    return _SSSP_KERNEL_MIN_CUDA if csr.device.type == "cuda" else (1 << 62)


def _device_csr(ex, sg: SubGraph):
    """The single predicate CSR eligible for the device tiers, or None.

    Eligible: one uid child, no facet cost key, no child filter, no lang,
    numpaths <= 1, resident on this device (a mesh-sharded tablet takes the
    mesh BFS) and large enough that device relaxation amortizes its
    dispatch cost."""
    spec = sg.gq.shortest
    if spec.numpaths > 1 or len(sg.gq.children) != 1:
        return None
    cgq = sg.gq.children[0]
    if cgq.filter is not None or cgq.lang:
        return None
    if cgq.facets is not None and cgq.facets.keys:
        return None
    rev = cgq.attr.startswith("~")
    pd = ex.snap.pred(cgq.attr[1:] if rev else cgq.attr)
    if pd is None:
        return None
    csr = pd.rev_csr if rev else pd.csr
    if csr is None or getattr(csr, "is_dist", False):
        return None
    if csr.num_edges < _device_sssp_min(csr):
        return None
    return cgq.attr, csr


def _device_shortest(attr: str, csr, src: int, dst: int, max_depth: int):
    """Unweighted single-source shortest path on the device, the parent
    chain walked on the host: the kernel tier (bfs_dist) from
    _sssp_kernel_min edges, else the Bellman-Ford relaxation (sssp), which
    also serves depths of 254 and more. Work is bounded by iterations x E
    (the resident CSR), so the reference's discovered-edge budget does not
    apply here."""
    from dgraph_tpu_torch.ops import pull_bfs as pb
    from dgraph_tpu_torch.ops import traversal

    # a depth past the kernel's distance labels keeps the sssp tier (its
    # max_iters honours any depth): 254+ hop paths must not go "unreachable"
    if csr.num_edges >= _sssp_kernel_min(csr) and max_depth < pb.DIST_UNREACHED:
        path = pb.shortest_bfs(pb.pull_graph_for(csr), src, dst, max_depth)
        if path is None:
            return None
        return (float(len(path) - 1), path, [attr] * (len(path) - 1))

    subjects, indptr, indices = csr.host_arrays()
    hi = max(int(subjects[-1]) if len(subjects) else 0,
             int(indices.max()) if len(indices) else 0)
    if src > hi or dst > hi:
        return None              # endpoint outside this predicate's uid space
    # pow2 capacity class, as the JAX package sizes it
    num_nodes = 1 << max(int(np.ceil(np.log2(hi + 2))), 4)
    with costs.kernel("traversal.sssp") as ck:
        res = traversal.sssp(csr.subjects, csr.indptr, csr.indices, None,
                             src, num_nodes=num_nodes, max_iters=max_depth)
        dist = float(res.dist[dst])
        ck.set(d2h=res.dist.element_size())
        if not np.isfinite(dist):
            return None
        parent = res.parent.cpu().numpy()
        ck.set(d2h=int(parent.nbytes))
    path = [dst]
    while path[-1] != src:
        p = int(parent[path[-1]])
        if p < 0 or len(path) > max_depth + 1:
            return None      # broken chain (cannot happen for finite dist)
        path.append(p)
    return (dist, path[::-1], [attr] * (len(path) - 1))


def _mesh_csrs(ex, sg: SubGraph):
    """[(attr, mesh-sharded CSR)] when the block's whole expansion can run
    as ONE fused BFS dispatch: every uid child (multi-predicate blocks
    included — the level union is synchronous) free of filters, lang, and
    facet cost keys, over tablets this mesh placed. Serves both single
    and k-shortest (the rebuilt adjacency feeds either). Declines record
    the labeled fallback reason when a mesh-owned tablet was involved."""
    mesh = getattr(ex, "mesh", None)
    if mesh is None or not sg.gq.children:
        return None
    from dgraph_tpu_torch.query import fusedplan as fp

    csrs = []
    owned_any = False
    reason = None
    for cgq in sg.gq.children:
        rev = cgq.attr.startswith("~")
        pd = ex.snap.pred(cgq.attr[1:] if rev else cgq.attr)
        csr = (pd.rev_csr if rev else pd.csr) if pd is not None else None
        if csr is not None and mesh.owns(csr):
            owned_any = True
        elif csr is not None:
            reason = reason or ex._mesh_break_reason(cgq) or fp.REASON_SHAPE
        if cgq.filter is not None:
            reason = reason or fp.REASON_FILTER
        elif cgq.lang:
            reason = reason or fp.REASON_LANG
        elif cgq.facets is not None and cgq.facets.keys:
            reason = reason or fp.REASON_FACET
        csrs.append((cgq.attr, csr))
    if reason is None and owned_any and \
            all(c is not None and mesh.owns(c) for _a, c in csrs):
        return csrs
    if owned_any and reason is not None:
        ex._mesh_miss(reason)
    return None


def _mesh_shortest_single(ex, sg: SubGraph, csrs, src: int, dst: int):
    """Single shortest path from ONE fused BFS dispatch, reconstructed
    straight from the distance vector — no adjacency dict, no host
    Dijkstra. With unit edge costs (the mesh path rejects facet costs)
    Dijkstra's prev[x] is exactly the MINIMUM-uid predecessor at
    dist[x]-1 (all dist-(d-1) nodes pop before any dist-d node, in uid
    order), and its recorded attr is the FIRST child predicate holding
    that edge — both derivable from dist + the host CSR mirrors. The
    program early-exits once the destination's level completes
    (reference stopExpansion, query/shortest.go): levels beyond
    dist[dst] cannot shorten the path."""
    spec = sg.gq.shortest
    max_depth = spec.depth if spec.depth > 0 else 64
    mesh = ex.mesh
    only = [c for _a, c in csrs]
    with costs.kernel("mesh.bfs"):
        dist, hops, edges = ex.gated(
            lambda: mesh.run_bfs(only, src, max_depth, ex.edge_budget(),
                                 stop_at=dst),
            klass="shortest")
    if edges > ex.edge_budget():
        raise QueryError("shortest path exceeded edge budget (ErrTooBig)")
    ex._mesh_fused += 1
    tgt = mesh.bfs_targets(only)
    pos = int(np.searchsorted(tgt, dst)) if len(tgt) else 0
    if not len(tgt) or pos >= len(tgt) or tgt[pos] != dst or \
            dist[pos] >= int(mesh.BFS_UNREACHED):
        return None
    d = int(dist[pos])
    host = [(attr, csr.host_arrays()) for attr, csr in csrs]

    def _edge_exists(arrs, u: int, t: int) -> bool:
        subjects, indptr, indices = arrs
        r = int(np.searchsorted(subjects, u))
        if r >= len(subjects) or subjects[r] != u:
            return False
        row = indices[indptr[r]: indptr[r + 1]]
        j = int(np.searchsorted(row, t))
        return j < len(row) and row[j] == t

    path = [dst]
    attrs: list[str] = []
    cur = dst
    for level in range(d - 1, -1, -1):
        cands = tgt[dist == level].astype(np.int64)
        if level == 0:
            cands = np.unique(np.concatenate(
                [cands, np.asarray([src], dtype=np.int64)]))
        best = None
        for _attr, arrs in host:
            subjects, indptr, indices = arrs
            rows = np.searchsorted(subjects, cands)
            rc = np.clip(rows, 0, max(len(subjects) - 1, 0))
            ok = (len(subjects) > 0) & (subjects[rc] == cands)
            starts = np.where(ok, indptr[rc], 0).astype(np.int64)
            deg = np.where(ok, indptr[rc + 1] - starts, 0).astype(np.int64)
            total = int(deg.sum())
            if not total:
                continue
            offs = np.zeros(len(cands) + 1, dtype=np.int64)
            np.cumsum(deg, out=offs[1:])
            flat = np.repeat(starts - offs[:-1], deg) + np.arange(total)
            hit = indices[flat] == cur
            if hit.any():
                seg = np.searchsorted(offs[1:], np.flatnonzero(hit),
                                      side="right")
                u = int(cands[seg].min())
                best = u if best is None else min(best, u)
        if best is None:
            return None       # cannot happen for a finite dist
        # attr = the FIRST child predicate holding the chosen edge (the
        # first (t, cost, attr) tuple Dijkstra relaxed from adj[u])
        attr_used = next(a for a, arrs in host
                         if _edge_exists(arrs, best, cur))
        path.append(best)
        attrs.append(attr_used)
        cur = best
    return (float(d), path[::-1], attrs[::-1])


def _mesh_bfs_adjacency(ex, sg: SubGraph, csrs, src: int):
    """expandOut's whole level loop (query/shortest.go:134) as ONE mesh
    program (mesh_exec.run_bfs): frontier, visited set, and distance
    vector stay on the device between levels. The host rebuilds the level adjacency from the distance
    vector and its CSR mirrors: a node expanded at level L holds its full
    per-predicate rows in child order, exactly what _build_adjacency
    accretes (cost 1.0, all targets recorded), so Dijkstra / k-shortest
    see byte-identical inputs."""
    spec = sg.gq.shortest
    max_depth = spec.depth if spec.depth > 0 else 64
    mesh = ex.mesh
    only = [c for _a, c in csrs]
    with costs.kernel("mesh.bfs"):
        dist, hops, edges = ex.gated(
            lambda: mesh.run_bfs(only, src, max_depth, ex.edge_budget()),
            klass="shortest")
    if edges > ex.edge_budget():
        raise QueryError("shortest path exceeded edge budget (ErrTooBig)")
    ex._mesh_fused += 1
    tgt = mesh.bfs_targets(only)
    # nodes EXPANDED by the loop: in the frontier of an executed level —
    # dist L < hops (the last level's fresh targets joined no frontier)
    reached = tgt[dist < hops].astype(np.int64) if hops else \
        np.zeros(0, np.int64)
    uids = np.unique(np.concatenate(
        [np.asarray([src], dtype=np.int64), reached]))
    adj: dict[int, list[tuple[int, float, str]]] = {}
    for attr, csr in csrs:
        subjects, indptr, indices = csr.host_arrays()
        rows = np.searchsorted(subjects, uids)
        rc = np.clip(rows, 0, max(len(subjects) - 1, 0))
        ok = (len(subjects) > 0) & (subjects[rc] == uids)
        for i in np.flatnonzero(ok):
            u = int(uids[i])
            r = int(rc[i])
            row = indices[indptr[r]: indptr[r + 1]]
            if len(row):
                adj.setdefault(u, []).extend(
                    (int(t), 1.0, attr) for t in row)
    return adj


def shortest_path(ex, sg: SubGraph) -> None:
    with otrace.span("shortest"):
        _shortest_path(ex, sg)


def _shortest_path(ex, sg: SubGraph) -> None:
    spec = sg.gq.shortest
    src = _resolve_end(ex, spec.from_)
    dst = _resolve_end(ex, spec.to)
    max_depth = spec.depth if spec.depth > 0 else 64
    sg.paths = []
    if src == dst:
        sg.paths = [(0.0, [src], [])]
    else:
        dev = _device_csr(ex, sg)
        mesh = _mesh_csrs(ex, sg) if dev is None else None
        if dev is not None:
            p = _device_shortest(dev[0], dev[1], src, dst, max_depth)
            sg.paths = [p] if p is not None else []
        elif mesh is not None and spec.numpaths <= 1:
            p = _mesh_shortest_single(ex, sg, mesh, src, dst)
            sg.paths = [p] if p is not None else []
        else:
            if mesh is not None:
                adj = _mesh_bfs_adjacency(ex, sg, mesh, src)
            else:
                adj = _build_adjacency(ex, sg, src, dst)
            if spec.numpaths <= 1:
                p = _dijkstra(adj, src, dst)
                sg.paths = [p] if p is not None else []
            else:
                sg.paths = _k_shortest(adj, src, dst, spec.numpaths,
                                       ex.edge_budget())
        sg.paths = [p for p in sg.paths
                    if spec.minweight <= p[0] <= spec.maxweight]
    uids = sorted({u for _c, path, _a in sg.paths for u in path})
    sg.dest_uids = np.asarray(uids, dtype=np.int64)
    if sg.gq.var_name:
        ex.vars[sg.gq.var_name] = VarValue(uids=sg.dest_uids)


def _dijkstra(adj, src: int, dst: int):
    dist = {src: 0.0}
    prev: dict[int, tuple[int, str]] = {}
    pq = [(0.0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if u == dst:
            break
        if d > dist.get(u, float("inf")):
            continue
        for (t, c, attr) in adj.get(u, ()):
            nd = d + c
            if nd < dist.get(t, float("inf")):
                dist[t] = nd
                prev[t] = (u, attr)
                heapq.heappush(pq, (nd, t))
    if dst not in dist:
        return None
    path = [dst]
    attrs: list[str] = []
    while path[-1] != src:
        p, attr = prev[path[-1]]
        attrs.append(attr)
        path.append(p)
    return (dist[dst], path[::-1], attrs[::-1])


def _k_shortest(adj, src: int, dst: int, k: int, budget: int):
    """Loopless k-shortest via best-first path enumeration (the reference
    carries whole paths per heap item too, query/shortest.go:274). The pop
    budget is the query edge limit (x/init.go:53 QueryEdgeLimit) — each pop
    relaxes at most one path-edge extension."""
    out = []
    pq = [(0.0, [src], [])]
    pops = 0
    while pq and len(out) < k and pops < budget:
        d, path, attrs = heapq.heappop(pq)
        pops += 1
        u = path[-1]
        if u == dst:
            out.append((d, path, attrs))
            continue
        for (t, c, attr) in adj.get(u, ()):
            if t in path:
                continue
            heapq.heappush(pq, (d + c, path + [t], attrs + [attr]))
    return out


def encode_paths(ex, sg: SubGraph, out: dict) -> None:
    """Materialize `_path_` (reference query/shortest.go:598)."""
    paths = getattr(sg, "paths", [])
    objs = []
    for cost, path, attrs in paths:
        node: dict = {"uid": hex(path[-1])}
        for i in range(len(path) - 2, -1, -1):
            node = {"uid": hex(path[i]), attrs[i]: [node]}
        node["_weight_"] = cost
        objs.append(node)
    if objs:
        out["_path_"] = objs
