"""Distributed traversal: uid-range-sharded CSR + per-shard frontier steps.

Port of dgraph_tpu/parallel/dist.py. Reference semantics: worker/task.go
ProcessTaskOverNetwork (:137) fans one intern.Query out to the group owning
the predicate, and query/query.go merges the returned uidMatrix. Here the
fan-out runs over the mesh (parallel/mesh.py): the CSR row space is
range-partitioned across the shard devices, the frontier is replicated,
every shard expands its local rows in one CSR gather, and an all_gather +
merge on the leader replaces the gRPC scatter-gather. Edge totals combine
with psum.

Layout (kept from the JAX package, so the host reassembly and every rank
map agree byte for byte):
  - frontier: replicated — small (<= frontier_cap int32) and every shard
    needs all of it (any uid's row can live on any shard).
  - CSR arrays: one tensor per shard, padded to the largest shard: subjects
    [R], indptr [R+1], indices [E]. Rows are contiguous chunks of the
    subject table, so each subject row lives on exactly one shard (a
    tablet's contiguous key range, x/keys.go).

A "program" is a cached Python closure over the mesh (nothing compiles);
the caches keep the JAX keys so the build counters mean the same.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from dgraph_tpu_torch.obs import devprof
from dgraph_tpu_torch.ops.csr import expand
from dgraph_tpu_torch.ops.uidset import _dedup_sorted, sentinel
from dgraph_tpu_torch.parallel.mesh import Mesh

SNT = int(sentinel(np.int32))


class ShardedCSR(NamedTuple):
    """One predicate's adjacency, row-partitioned across the mesh: per
    shard subjects [R], indptr [R+1], indices [E], padded to the largest
    shard. Padding rows have subject=SENTINEL and zero degree."""

    subjects: list
    indptr: list
    indices: list

    @property
    def n_shards(self) -> int:
        return len(self.subjects)


def shard_rows_per(n_rows: int, n_shards: int) -> int:
    """Rows per shard for a contiguous row-range partition (shared by
    shard_csr and the host-side uidMatrix reassembly, which must agree on
    which shard owns which row)."""
    return -(-max(n_rows, 1) // n_shards)


def shard_edge_counts(indptr: np.ndarray, n_rows: int,
                      n_shards: int) -> list[int]:
    """Edges held by each shard of the row-range partition."""
    rows_per = shard_rows_per(n_rows, n_shards)
    out = []
    for s in range(n_shards):
        lo, hi = min(s * rows_per, n_rows), min((s + 1) * rows_per, n_rows)
        out.append(int(indptr[hi]) - int(indptr[lo]))
    return out


def shard_csr(subjects: np.ndarray, indptr: np.ndarray, indices: np.ndarray,
              mesh: Mesh) -> ShardedCSR:
    """Partition host CSR into contiguous row chunks, pad, and place."""
    n_shards = mesh.shape["shard"]
    n_rows = len(subjects)
    rows_per = shard_rows_per(n_rows, n_shards)
    max_edges = max([1] + shard_edge_counts(indptr, n_rows, n_shards))
    sub_chunks, ptr_chunks, idx_chunks = [], [], []
    for s in range(n_shards):
        lo, hi = min(s * rows_per, n_rows), min((s + 1) * rows_per, n_rows)
        e_lo, e_hi = int(indptr[lo]), int(indptr[hi])
        sub = np.full(rows_per, SNT, dtype=np.int32)
        sub[: hi - lo] = subjects[lo:hi]
        ptr = np.zeros(rows_per + 1, dtype=np.int32)
        ptr[: hi - lo + 1] = indptr[lo: hi + 1] - e_lo
        ptr[hi - lo + 1:] = ptr[hi - lo]
        idx = np.full(max_edges, SNT, dtype=np.int32)
        idx[: e_hi - e_lo] = indices[e_lo:e_hi]
        sub_chunks.append(sub)
        ptr_chunks.append(ptr)
        idx_chunks.append(idx)
    return ShardedCSR(mesh.shard_put(np.stack(sub_chunks)),
                      mesh.shard_put(np.stack(ptr_chunks)),
                      mesh.shard_put(np.stack(idx_chunks)))


def _local_rows(subjects: torch.Tensor, frontier: torch.Tensor) -> torch.Tensor:
    """Local row of each frontier uid in this shard's subject block, or
    SENTINEL (a clip-mode take, as in the JAX program)."""
    pos = torch.searchsorted(subjects, frontier)
    pos_c = torch.clamp(pos, 0, subjects.shape[0] - 1)
    ok = (subjects[pos_c] == frontier) & (frontier != SNT)
    return torch.where(ok, pos_c, SNT).to(torch.int32)


@lru_cache(maxsize=64)
def _expand_program(mesh: Mesh, fcap: int, edge_cap: int):
    """ONE sharded-expand program per (mesh, frontier cap, edge cap). Each
    shard resolves the replicated frontier against its local subject rows
    and gathers its adjacency slices — ProcessTaskOverNetwork's scatter
    (worker/task.go:137) as a per-shard step; the host reassembles the
    uidMatrix (assemble_matrix). Besides the per-shard (counts, targets)
    it emits the MERGED next frontier (dedup of the all-gathered dest
    sets) so a stepped multi-hop caller can stage it on the device."""
    devprof.note_build("dist.expand", (fcap, edge_cap))

    def run(sub, ptr, idx, fr):
        counts, targets, dests = [], [], []
        for s in range(mesh.shape["shard"]):
            rows = _local_rows(sub[s], fr[s])
            res = expand(ptr[s], idx[s], rows, edge_cap)
            counts.append(res.counts.to(torch.int32))
            targets.append(res.targets)
            dests.append(_dedup_sorted(torch.sort(res.targets).values))
        gathered = mesh.all_gather(dests)[0]
        merged = _dedup_sorted(torch.sort(gathered.reshape(-1)).values)[:fcap]
        return counts, targets, merged

    return run


def assemble_matrix(counts: np.ndarray, targets: np.ndarray,
                    F: int) -> list[np.ndarray]:
    """Host uidMatrix reassembly from per-shard (counts [S, fcap],
    targets [S, edge_cap]): each subject row lives on exactly one shard
    (contiguous row ranges), so each frontier slot picks the one shard
    with a nonzero count and slices its local target run."""
    offs = np.zeros((counts.shape[0], counts.shape[1] + 1), dtype=np.int64)
    np.cumsum(counts, axis=1, out=offs[:, 1:])
    matrix: list[np.ndarray] = []
    for i in range(F):
        owners = np.nonzero(counts[:, i])[0]
        if len(owners) == 0:
            matrix.append(np.zeros(0, np.int64))
            continue
        s = int(owners[0])
        o = offs[s, i]
        matrix.append(targets[s, o: o + counts[s, i]].astype(np.int64))
    return matrix


def pad_frontier(uids: np.ndarray, fcap: int) -> np.ndarray:
    fr = np.full(fcap, SNT, dtype=np.int32)
    fr[: len(uids)] = uids
    return fr


class DistPredCSR:
    """Mesh-sharded drop-in for csr_build.PredCSR.

    The expand hot path (the uidMatrix gather) runs over the mesh via the
    cached `_expand_program`; the `subjects`/`indptr`/`indices` numpy host
    mirrors keep the scalar paths (count-index degrees, reflexive scans)
    working unchanged. Multi-hop traversals go through
    parallel/mesh_exec.MeshExecutor, which runs the whole hop loop as one
    program; the per-task path here stages its merged next frontier on
    the device so stepped callers replaying it skip the re-upload.
    """

    is_dist = True
    # metrics Registry installed by the placing MeshExecutor (None for
    # direct constructions): per-task mesh dispatches count alongside the
    # fused-program dispatches so dispatches-per-query is honest
    metrics = None

    def __init__(self, subjects, indptr, indices, mesh: Mesh) -> None:
        self.subjects = np.asarray(subjects)
        self.indptr = np.asarray(indptr)
        self.indices = np.asarray(indices)
        self.mesh = mesh
        self.sharded = shard_csr(self.subjects, self.indptr, self.indices,
                                 mesh)
        # host metadata mirroring shard_csr's partition: row r lives on
        # shard r // rows_per with local edge base edge_lo[shard]
        n_shards = mesh.shape["shard"]
        self.rows_per = shard_rows_per(len(self.subjects), n_shards)
        self.edge_lo = np.asarray(
            [int(self.indptr[min(s * self.rows_per, len(self.subjects))])
             for s in range(n_shards)], dtype=np.int64)
        self.shard_edges = shard_edge_counts(self.indptr, len(self.subjects),
                                             n_shards)
        # device staging: (host uids of the staged frontier, replicated
        # tensors) — a stepped caller whose next frontier IS the previous
        # merged dest set reuses the on-device copy
        self._staged: tuple | None = None
        self._host: tuple | None = None

    @property
    def num_subjects(self) -> int:
        return len(self.subjects)

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    @property
    def ecap(self) -> int:
        """Padded per-shard edge capacity (the largest shard's edges)."""
        return int(self.sharded.indices[0].shape[0])

    def host_arrays(self) -> tuple:
        """(subjects, indptr, indices) numpy mirrors — the PredCSR surface
        stats/known-uid/has() paths consume without a device fetch."""
        if self._host is None:
            self._host = (self.subjects, self.indptr, self.indices)
        return self._host

    def expand_matrix(self, uids: np.ndarray) -> tuple[list[np.ndarray], int]:
        """uidMatrix rows for `uids`, gathered across shards in ONE cached
        mesh program. The merged next frontier stays staged on the
        device."""
        F = len(uids)
        if F == 0 or self.num_edges == 0:
            return [np.zeros(0, np.int64) for _ in range(F)], 0
        staged = self._staged
        if staged is not None and len(staged[0]) == F and \
                np.array_equal(staged[0], uids):
            fr_dev, fcap = staged[1], int(staged[1][0].shape[0])
            self._staged = None
        else:
            fcap = 1 << max(int(np.ceil(np.log2(F))), 4)
            fr_dev = self.mesh.put(pad_frontier(np.asarray(uids), fcap))
        counts_all, targets_all, next_fr = _expand_program(
            self.mesh, fcap, self.ecap)(
            self.sharded.subjects, self.sharded.indptr,
            self.sharded.indices, fr_dev)
        counts = torch.stack([c.cpu() for c in counts_all]).numpy()
        targets = torch.stack([t.cpu() for t in targets_all]).numpy()
        matrix = assemble_matrix(counts, targets, F)
        next_h = next_fr.cpu().numpy()
        self._staged = (next_h[next_h != SNT].astype(np.int64),
                        self.mesh.replicate(next_fr))
        total = int(counts[:, :F].sum())
        if self.metrics is not None:
            self.metrics.counter("dgraph_mesh_dispatches_total").inc()
            self.metrics.counter("dgraph_mesh_traversed_edges_total").inc(
                total)
        return matrix, total


@lru_cache(maxsize=64)
def _k_hop_program(mesh: Mesh, hops: int, frontier_cap: int, num_nodes: int,
                   edge_cap: int):
    """Cached k-hop program: per hop, per shard, resolve the frontier
    against the local subjects, gather, dedup; then ONE all_gather of the
    dest blocks, a replicated merge + visited update, and a psum of the
    edge counts."""
    devprof.note_build("dist.k_hop",
                       (hops, frontier_cap, num_nodes, edge_cap))
    S = mesh.shape["shard"]

    def run(sub, ptr, idx, seeds, visited):
        frontier = mesh.replicate(seeds)
        total = torch.zeros((), dtype=torch.int32, device=mesh.leader)
        for _i in range(hops):
            dests, tots = [], []
            for s in range(S):
                rows = _local_rows(sub[s], frontier[s])
                res = expand(ptr[s], idx[s], rows, edge_cap)
                dests.append(_dedup_sorted(torch.sort(res.targets).values))
                tots.append(res.total.to(torch.int32))
            gathered = mesh.all_gather(dests)[0]
            merged = _dedup_sorted(
                torch.sort(gathered.reshape(-1)).values)[:frontier_cap]
            valid = merged != SNT
            seen = visited[torch.clamp(merged, 0, num_nodes - 1).long()] \
                & valid
            fresh = torch.sort(torch.where(seen | ~valid, SNT, merged)).values
            # the dropped scatter slot: sentinels write into visited[n]
            # of an n+1 buffer, sliced off
            vext = torch.cat([visited, torch.zeros(1, dtype=torch.bool,
                                                   device=visited.device)])
            vext[torch.where(fresh == SNT, num_nodes, fresh).long()] = True
            visited = vext[:num_nodes]
            total = total + mesh.psum(tots)[0]
            frontier = mesh.replicate(fresh)
        return frontier[0], visited, total

    return run


def dist_k_hop(csr: ShardedCSR, seeds: torch.Tensor, mesh: Mesh, *,
               hops: int, frontier_cap: int, num_nodes: int,
               edge_cap: int | None = None):
    """Multi-device k-hop BFS. Returns (frontier, visited bool[num_nodes],
    traversed int32) on the leader device.

    edge_cap must cover one shard's largest per-level edge gather (a
    shard's total edge count, csr.indices[0].shape[0], is always safe)."""
    edge_cap = edge_cap or frontier_cap
    dev = mesh.leader
    seeds = seeds.to(dev, torch.int32)
    if seeds.shape[0] < frontier_cap:
        seeds = torch.cat([seeds, torch.full(
            (frontier_cap - seeds.shape[0],), SNT, dtype=torch.int32,
            device=dev)])
    else:
        seeds = torch.sort(seeds).values[:frontier_cap]
    visited0 = torch.zeros((num_nodes + 1,), dtype=torch.bool, device=dev)
    visited0[torch.where(seeds == SNT, num_nodes, seeds).long()] = True
    frontier, visited, total = _k_hop_program(
        mesh, hops, frontier_cap, num_nodes, edge_cap)(
        csr.subjects, csr.indptr, csr.indices, seeds, visited0[:num_nodes])
    return frontier, visited, total
