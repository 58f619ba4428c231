"""Whole-graph analytics: PageRank / connected components / triangles.

Port of dgraph_tpu/query/analytics.py, whole. Iterative programs that the
per-query traversal engine cannot express run as device-resident loops over
the mesh-sharded rank-space edge list (parallel/mesh_exec.run_pagerank /
run_cc / run_triangles — the run_bfs idiom: one collective per iteration,
only the converged vector crosses to the host).

Surfaced as Node.analytics(...) + HTTP /analytics; deadline/shed-aware at
the DispatchGate, cost-ledger-attributed, residency-aware: overlay or
residency-deferred tablets (and nodes without a mesh) serve via the host
fallbacks below. CC labels and triangle counts are EXACT either way (CC
converges to the minimum member rank per component on both paths; the
device triangle sum is taken in float64); PageRank device f32 vs host f64
agree to oracle tolerance, not bitwise — the result carries a ``device``
flag so callers know which path ran.
"""

from __future__ import annotations

import numpy as np

KINDS = ("pagerank", "cc", "triangles")

# dense trace(A^3) replicates an ncap x ncap f32 adjacency per device —
# past this node count the exact host intersection counter wins
TRI_DENSE_MAX = 2048


def graph_arrays(csr):
    """(nodes, esrc, edst): one tablet's edge list in rank space. nodes is
    the sorted union of subjects and targets (int64 uids); esrc/edst are
    int32 node ranks per edge — the coordinate system every kernel and
    every oracle below shares."""
    subjects, indptr, indices = csr.host_arrays()
    deg = np.diff(indptr)
    src_u = np.repeat(np.asarray(subjects, dtype=np.int64), deg)
    dst_u = np.asarray(indices, dtype=np.int64)
    nodes = np.unique(np.concatenate([np.asarray(subjects, np.int64),
                                      dst_u]))
    esrc = np.searchsorted(nodes, src_u).astype(np.int32)
    edst = np.searchsorted(nodes, dst_u).astype(np.int32)
    return nodes, esrc, edst


# ---------------------------------------------------------------------------
# host fallbacks (cold tablets / no mesh) — the oracles the device
# programs are tested against
# ---------------------------------------------------------------------------

def pagerank_host(esrc, edst, n: int, *, damping: float = 0.85,
                  tol: float = 1e-6, max_iters: int = 100):
    """float64 power iteration, same update rule and stop criterion as
    the device program (L1 delta <= tol)."""
    if n == 0:
        return np.zeros(0), 0
    r = np.full(n, 1.0 / n)
    outdeg = np.bincount(esrc, minlength=n).astype(np.float64)[:n]
    dang = outdeg == 0
    od = np.maximum(outdeg, 1.0)
    it = 0
    while it < max_iters:
        w = r[esrc] / od[esrc]
        contrib = np.zeros(n)
        np.add.at(contrib, edst, w)
        new = (1.0 - damping) / n + damping * (contrib + r[dang].sum() / n)
        delta = np.abs(new - r).sum()
        r = new
        it += 1
        if delta <= tol:
            break
    return r, it


def cc_host(esrc, edst, n: int):
    """Union-find with union-by-minimum: every component's representative
    is its minimum node rank — bit-identical to the device label
    propagation's fixpoint."""
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(esrc.tolist(), edst.tolist()):
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if ra < rb:
            parent[rb] = ra
        else:
            parent[ra] = rb
    return np.fromiter((find(i) for i in range(n)), np.int64,
                       n).astype(np.int32)


def triangles_host(esrc, edst, n: int) -> int:
    """Exact count via sorted-adjacency intersection over the symmetrized
    simple graph: triangle (u<v<w) counted once at edge (u,v) as a common
    neighbor w>v."""
    if n == 0 or len(esrc) == 0:
        return 0
    a = np.concatenate([esrc, edst]).astype(np.int64)
    b = np.concatenate([edst, esrc]).astype(np.int64)
    keep = a != b
    key = np.unique(a[keep] * n + b[keep])
    u = (key // n).astype(np.int64)
    v = (key % n).astype(np.int64)
    starts = np.searchsorted(u, np.arange(n + 1))
    tri = 0
    fwd = u < v
    for uu, vv in zip(u[fwd].tolist(), v[fwd].tolist()):
        nu = v[starts[uu]: starts[uu + 1]]
        nv = v[starts[vv]: starts[vv + 1]]
        common = np.intersect1d(nu, nv, assume_unique=True)
        tri += int((common > vv).sum())
    return tri


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _device_eligible(mesh, csr) -> bool:
    """Residency gate: the device path re-shards the edge list fresh, but
    overlay tablets (uncompacted deltas) and residency-deferred shards
    stay host-side by policy — cold data must not force HBM pressure."""
    if mesh is None or csr is None:
        return False
    from dgraph_tpu_torch.storage.delta import OverlayCSR

    if isinstance(csr, OverlayCSR):
        return False
    return not getattr(csr, "_mesh_deferred", False)


def run(kind: str, csr, mesh=None, gate=None, metrics=None, *,
        damping: float = 0.85, tol: float = 1e-6, max_iters: int = 100,
        top: int = 20) -> dict:
    """One analytics computation over one tablet's whole graph. mesh is a
    parallel/mesh_exec.MeshExecutor (or None → host oracles); gate the
    DispatchGate (deadline/shed enforcement around the device program)."""
    from dgraph_tpu_torch.obs import costs

    if kind not in KINDS:
        raise ValueError(f"unknown analytics kind {kind!r}; "
                         f"one of {', '.join(KINDS)}")
    nodes, esrc, edst = graph_arrays(csr)
    n = len(nodes)
    device = _device_eligible(mesh, csr)
    if kind == "triangles" and n > TRI_DENSE_MAX:
        device = False
    if metrics is not None:
        metrics.counter("dgraph_analytics_runs_total").inc()
        metrics.counter("dgraph_analytics_edges_total").inc(len(esrc))
        if not device:
            metrics.counter("dgraph_analytics_host_fallbacks_total").inc()

    def gated(fn):
        return gate.run(fn, klass="mesh") if gate is not None else fn()

    out = {"kind": kind, "nodes": int(n), "edges": int(len(esrc)),
           "device": bool(device)}
    if kind == "pagerank":
        with costs.kernel("analytics.pagerank"):
            if device:
                r, it = gated(lambda: mesh.run_pagerank(
                    esrc, edst, n, damping=damping, tol=tol,
                    max_iters=max_iters))
            else:
                r, it = pagerank_host(esrc, edst, n, damping=damping,
                                      tol=tol, max_iters=max_iters)
        order = np.argsort(-np.asarray(r, dtype=np.float64),
                           kind="stable")[: max(int(top), 0)]
        out["iterations"] = int(it)
        out["top"] = [{"uid": hex(int(nodes[i])), "score": float(r[i])}
                      for i in order.tolist()]
    elif kind == "cc":
        with costs.kernel("analytics.cc"):
            if device:
                lab, it = gated(lambda: mesh.run_cc(esrc, edst, n))
            else:
                lab, it = cc_host(esrc, edst, n), 0
        comps, sizes = np.unique(lab, return_counts=True) \
            if n else (np.zeros(0), np.zeros(0, np.int64))
        out["iterations"] = int(it)
        out["components"] = int(len(comps))
        out["largest"] = int(sizes.max()) if len(sizes) else 0
    else:
        with costs.kernel("analytics.triangles"):
            if device:
                tri = gated(lambda: mesh.run_triangles(esrc, edst, n))
            else:
                tri = triangles_host(esrc, edst, n)
        out["triangles"] = int(tri)
    if metrics is not None and "iterations" in out:
        metrics.counter("dgraph_analytics_iterations_total").inc(
            out["iterations"])
    return out
