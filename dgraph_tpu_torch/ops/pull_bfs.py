"""Pull-BFS and edge-dedup @recurse over the active-prefix kernels.

Port of the orchestration half of dgraph_tpu/ops/pallas_bfs.py; the two
kernels are in ops/prefix.py (CUDA, csrc/active_prefix.cu). Per hop:

    prefix    = inclusive cumsum(frontier_bit[in_src[e]])   (K1 or K2)
    reached_v = prefix[iptr[v+1]] - prefix[iptr[v]] > 0      (node-sized)
    frontier' = reached & ~visited

Both endpoint spaces are rank-compressed exactly as in the JAX package
(PullGraph), and the bitmap keeps pack_words' bit-plane layout, so K1 takes
byte-identical words from either package.

Where JAX branches on the device (lax.cond on push_ok and on
fcount <= SPARSE_MAX, lax.scan over recurse levels), the port reads one
scalar per hop on the host and runs a Python loop: a fused depth-D recurse
pays D host syncs (the per-level frontier count) plus one fetch of the
packed level masks. jnp.nonzero(size=, fill_value=) becomes a cumsum +
scatter into a fixed-size buffer (no extra sync); .at[].set(mode="drop")
and jnp.take(mode="clip") become explicit masks and clamps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.ops.csr import degrees as _csr_degrees
from dgraph_tpu_torch.ops.csr import expand as _csr_expand
from dgraph_tpu_torch.ops.prefix import (EDGE_BLOCK, FRONTIER_CAP, INT32_MAX,
                                         LANES, NODES_PER_CHUNK,
                                         active_prefix, active_prefix_sparse)
from dgraph_tpu_torch.ops.uidset import host_rank_of

# Path-choice constants carried over from the TPU tuning by name. They pick
# a path and never change an output; their H100 values await measurement.
PUSH_CAP = 1 << 17      # push-path edge-gather capacity (targets buffer)
SPARSE_MAX = FRONTIER_CAP   # popcount at/below which K2 runs instead of K1


class PullGraph(NamedTuple):
    """Device-resident pull-BFS layout of one predicate CSR (field for field
    the JAX PullGraph: int32 tensors on one device, host numpy mirrors)."""

    in_src_pad: torch.Tensor    # int32[E_pad] source SRC-RANKS, dst-sorted
    in_src_pad_d: torch.Tensor  # int32[E_pad] source DST-RANKS, dst-sorted
    in_iptr_rank: torch.Tensor  # int32[Nd+1] edge offsets per dst rank
    subjects: torch.Tensor      # int32[Ns] sorted uids with out-edges
    in_subjects: torch.Tensor   # int32[Nd] sorted uids with in-edges
    map_s2d: torch.Tensor       # int32[Ns] dst rank of subject j, or Nd
    fwd_indptr: torch.Tensor    # int32[Ns+1] forward CSR (push path)
    fwd_dst_rank: torch.Tensor  # int32[E] dst RANKS in forward edge order
    map_d2s: torch.Tensor       # int32[Nd] src rank of dst i, or SENTINEL
    num_nodes: int
    num_edges: int
    chunks: int                 # bitmap chunks over the SRC-RANK space
    chunks_d: int               # bitmap chunks over the DST-RANK space
    inv_order: np.ndarray | None = None        # HOST fwd pos -> dst-sorted
    host_in_iptr: np.ndarray | None = None     # HOST int32[Nd+1]
    host_in_src: np.ndarray | None = None      # HOST int32[E] src ranks
    host_map_s2d: np.ndarray | None = None     # HOST int32[Ns]
    host_in_subjects: np.ndarray | None = None  # HOST int64[Nd]
    host_subjects: np.ndarray | None = None     # HOST int64[Ns]

    @property
    def device(self) -> torch.device:
        return self.in_src_pad.device


DEVICE_FIELDS = PullGraph._fields[:9]


def _chunks_for(n: int) -> int:
    c = max(1, (n + NODES_PER_CHUNK - 1) // NODES_PER_CHUNK)
    if c * NODES_PER_CHUNK <= n:
        c += 1                   # pad rank must be outside real ranks
    return c


def prep_pull(subjects: np.ndarray, indptr: np.ndarray, indices: np.ndarray,
              num_nodes: int, with_host_arrays: bool = False,
              device: str | torch.device = "cuda") -> PullGraph:
    """Host-side once-per-snapshot prep (numpy): transpose to dst-sorted
    in-edges, remap both endpoints to rank spaces, pad the edge stream to
    EDGE_BLOCK pointing at an always-zero bitmap bit; then one upload."""
    dev = resolve_device(device)
    E = len(indices)
    if E and int(np.max(indices)) >= num_nodes:
        raise ValueError(
            f"prep_pull: destination uid {int(np.max(indices))} >= "
            f"num_nodes={num_nodes}; pass num_nodes > max uid")
    if len(subjects) and int(np.max(subjects)) >= num_nodes:
        raise ValueError(
            f"prep_pull: subject uid {int(np.max(subjects))} >= "
            f"num_nodes={num_nodes}; pass num_nodes > max uid")
    subjects = np.asarray(subjects)
    src = np.repeat(np.arange(len(subjects), dtype=np.int64),
                    np.diff(indptr))                 # source RANK per edge
    order = np.argsort(np.asarray(indices), kind="stable")
    dst_sorted = np.asarray(indices)[order]
    src_sorted = src[order].astype(np.int32)
    in_subjects, counts = np.unique(dst_sorted, return_counts=True)
    nd = len(in_subjects)
    iptr = np.zeros(nd + 1, dtype=np.int32)
    np.cumsum(counts, out=iptr[1:])
    map_s2d = host_rank_of(in_subjects, subjects, nd).astype(np.int32)

    ns = len(subjects)
    chunks = _chunks_for(ns)
    pad_src = chunks * NODES_PER_CHUNK - 1     # beyond Ns: bit always 0
    e_pad = max(EDGE_BLOCK, -(-E // EDGE_BLOCK) * EDGE_BLOCK)
    src_pad = np.full(e_pad, pad_src, dtype=np.int32)
    src_pad[:E] = src_sorted

    # hop >= 2 frontiers are subsets of the destinations: a second stream
    # in dst-rank space reads the fresh mask directly (no remap per hop)
    chunks_d = _chunks_for(nd)
    pad_src_d = chunks_d * NODES_PER_CHUNK - 1
    src_d = map_s2d[src_sorted]                # Nd = "not a destination"
    src_d = np.where(src_d == nd, pad_src_d, src_d).astype(np.int32)
    src_pad_d = np.full(e_pad, pad_src_d, dtype=np.int32)
    src_pad_d[:E] = src_d

    fwd_dst_rank = np.searchsorted(in_subjects, np.asarray(indices)).astype(
        np.int32)
    map_d2s = host_rank_of(subjects, in_subjects, INT32_MAX).astype(np.int32)
    host = (None,) * 6
    if with_host_arrays:
        inv_order = np.empty(E, dtype=np.int32)
        inv_order[order] = np.arange(E, dtype=np.int32)
        host = (inv_order, iptr, src_sorted, map_s2d,
                in_subjects.astype(np.int64), subjects.astype(np.int64))
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    return PullGraph(up(src_pad), up(src_pad_d), up(iptr), up(subjects),
                     up(in_subjects), up(map_s2d), up(indptr),
                     up(fwd_dst_rank), up(map_d2s), int(num_nodes), int(E),
                     int(chunks), int(chunks_d), *host)


def pull_graph_for(csr) -> PullGraph:
    """Cached PullGraph for a storage PredCSR (one host prep per CSR)."""
    g = getattr(csr, "_pull_graph", None)
    if g is None:
        subjects, indptr, indices = csr.host_arrays()
        hi = max(int(subjects[-1]) if len(subjects) else 0,
                 int(indices.max()) if len(indices) else 0)
        g = prep_pull(np.asarray(subjects), np.asarray(indptr),
                      np.asarray(indices), hi + 1, with_host_arrays=True,
                      device=csr.device)
        csr._pull_graph = g
    return g


# ---------------------------------------------------------------------------
# bitmap packing
# ---------------------------------------------------------------------------

def pack_words(mask: torch.Tensor, chunks: int) -> torch.Tensor:
    """bool[..., n] -> int32[..., chunks*8, 128] bit-plane bitmap: word
    [p, l] holds bit b for node p*4096 + b*128 + l (pallas_bfs.pack_words).
    Leading dimensions are batch dimensions (pack_mask over [D, n])."""
    cap = chunks * NODES_PER_CHUNK
    lead = tuple(mask.shape[:-1])
    m = torch.zeros(lead + (cap,), dtype=torch.int64, device=mask.device)
    m[..., : mask.shape[-1]] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    m = m.view(lead + (chunks * 8, 32, LANES)) << shifts.view(32, 1)
    words = m.sum(dim=-2)                       # distinct bits: sum == or
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_chunks(n: int) -> int:
    """Minimal chunk count whose word capacity covers n bits."""
    return max(1, (n + NODES_PER_CHUNK - 1) // NODES_PER_CHUNK)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """Bit-pack a bool vector, or each row of a [D, n] buffer in one pass
    (pallas_bfs.pack_mask and pack_mask_rows), for a host fetch with 8x
    fewer bytes."""
    return pack_words(mask, pack_chunks(mask.shape[-1]))


def unpack_words(words: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of pack_words: word [p, l] bit b holds node
    p*4096 + b*128 + l."""
    w = np.asarray(words)
    bits = (w[:, None, :] >> np.arange(32, dtype=np.int32)[None, :, None]) & 1
    return bits.reshape(-1)[:n].astype(bool)


# ---------------------------------------------------------------------------
# one hop
# ---------------------------------------------------------------------------

def _frontier_table(frontier: torch.Tensor) -> torch.Tensor:
    """bool[n] (popcount <= FRONTIER_CAP) -> (33, 128) search table: the
    sorted set ranks, INT32_MAX-padded to FRONTIER_CAP, as 128 buckets of
    32; row 0 = bucket maxima, rows 1..32 = bucket entries. The fixed-size
    rank list (jnp.nonzero(size=, fill_value=)) is a cumsum + scatter into a
    buffer with one dump slot, so it needs no host sync."""
    dev = frontier.device
    pos = torch.cumsum(frontier.to(torch.int64), 0) - 1
    keep = frontier & (pos < FRONTIER_CAP)
    slot = torch.where(keep, pos, FRONTIER_CAP)
    flist = torch.full((FRONTIER_CAP + 1,), INT32_MAX, dtype=torch.int32,
                       device=dev)
    ranks = torch.arange(frontier.shape[0], dtype=torch.int32, device=dev)
    flist.scatter_(0, slot, torch.where(keep, ranks, INT32_MAX))
    buckets = flist[:FRONTIER_CAP].view(LANES, 32)
    return torch.cat([buckets[:, 31][None, :], buckets.T], 0).contiguous()


def _prefix_for(frontier_bits: torch.Tensor, stream: torch.Tensor,
                n_chunks: int) -> torch.Tensor:
    """Active-edge inclusive prefix for one frontier: K2 at or below
    SPARSE_MAX set bits, K1 above. The popcount is the hop's one host read
    (the JAX lax.cond)."""
    fcount = int(frontier_bits.sum())
    if fcount <= SPARSE_MAX:
        return active_prefix_sparse(_frontier_table(frontier_bits), stream)
    return active_prefix(pack_words(frontier_bits, n_chunks), stream,
                         n_chunks)


def _take_clip(arr: torch.Tensor, idx: torch.Tensor,
               fill=0) -> torch.Tensor:
    """jnp.take(arr, idx, mode="clip"), and `fill` when arr is empty."""
    if arr.numel() == 0:
        return torch.full(idx.shape, fill, dtype=arr.dtype, device=idx.device)
    return arr[torch.clamp(idx.to(torch.int64), 0, arr.numel() - 1)]


def _bounds_reached(prefix: torch.Tensor,
                    in_iptr_rank: torch.Tensor) -> torch.Tensor:
    """Per dst rank: > 0 prefix increments inside its in-edge slice."""
    bounds = _take_clip(prefix, in_iptr_rank.to(torch.int64) - 1)
    bounds = torch.where(in_iptr_rank == 0, 0, bounds)
    return (bounds[1:] - bounds[:-1]) > 0


# ---------------------------------------------------------------------------
# k-hop BFS
# ---------------------------------------------------------------------------

class PullBFSResult(NamedTuple):
    visited: torch.Tensor     # bool[num_nodes]
    frontier: torch.Tensor    # bool[num_nodes]
    traversed: torch.Tensor   # 0-d int32


def _k_hop_impl(g: PullGraph, seeds_mask: torch.Tensor,
                seeds_ranks: torch.Tensor, hops: int,
                have_seeds: bool) -> PullBFSResult:
    """Direction-optimizing hop loop in rank spaces (pallas_bfs._k_hop_impl):
    push while the frontier is a known src-rank list (<= FRONTIER_CAP) with
    degree sum <= PUSH_CAP, else a mask hop through K2/K1."""
    dev = g.device
    if hops == 0:
        return PullBFSResult(seeds_mask, seeds_mask,
                             torch.zeros((), dtype=torch.int32, device=dev))
    nd = g.in_subjects.shape[0]
    snt = INT32_MAX

    def push_hop(flist, visited_d, traversed, build_next: bool):
        res = _csr_expand(g.fwd_indptr, g.fwd_dst_rank, flist, PUSH_CAP)
        traversed = traversed + res.total.to(torch.int32)
        tmask = torch.zeros((nd,), dtype=torch.bool, device=dev)
        hit = res.targets < nd                        # sentinel pads drop
        tmask[res.targets[hit].to(torch.int64)] = True
        fresh = tmask & ~visited_d
        visited2 = visited_d | fresh
        if build_next:
            tsort = torch.sort(res.targets).values    # sentinels at the end
            valid = tsort < nd
            dup = torch.zeros_like(valid)
            dup[1:] = tsort[1:] == tsort[:-1]
            was = _take_clip(visited_d, tsort, False) & valid
            keep = valid & ~dup & ~was
            nfresh = int(keep.sum())
            idxs = torch.nonzero(keep).flatten()[:FRONTIER_CAP]
            cand_d = torch.full((FRONTIER_CAP,), nd, dtype=torch.int64,
                                device=dev)
            cand_d[: idxs.numel()] = tsort[idxs].to(torch.int64)
            flist2 = torch.where(cand_d < nd, _take_clip(g.map_d2s, cand_d),
                                 snt).to(torch.int32)
            ok2 = nfresh <= FRONTIER_CAP
        else:
            flist2, ok2 = flist, False
        return flist2, ok2, fresh, visited2, traversed

    def mask_hop(fresh_d, visited_d, traversed, first: bool):
        if first:
            # src-rank space: a seed with out-edges but no in-edges exists
            # only here
            frontier, stream, n_chunks = (
                seeds_mask[g.subjects.to(torch.int64)], g.in_src_pad,
                g.chunks)
        else:
            frontier, stream, n_chunks = fresh_d, g.in_src_pad_d, g.chunks_d
        prefix = _prefix_for(frontier, stream, n_chunks)
        traversed = traversed + prefix[-1]
        fresh = _bounds_reached(prefix, g.in_iptr_rank) & ~visited_d
        return fresh, visited_d | fresh, traversed

    in_sub = g.in_subjects.to(torch.int64)
    visited_d = seeds_mask[in_sub]                   # seeds, dst-rank space
    fresh_d = torch.zeros((nd,), dtype=torch.bool, device=dev)
    traversed = torch.zeros((), dtype=torch.int32, device=dev)
    flist = seeds_ranks if have_seeds else torch.full(
        (FRONTIER_CAP,), snt, dtype=torch.int32, device=dev)
    flist_ok = bool(have_seeds)
    for h in range(hops):
        push_ok = flist_ok and int(
            _csr_degrees(g.fwd_indptr, flist).sum()) <= PUSH_CAP
        if push_ok:
            flist, flist_ok, fresh_d, visited_d, traversed = push_hop(
                flist, visited_d, traversed, build_next=h + 1 < hops)
        else:
            fresh_d, visited_d, traversed = mask_hop(
                fresh_d, visited_d, traversed, first=(h == 0))
            flist_ok = False

    # back to full-uid-space semantics once, not per hop
    packed = torch.zeros((g.num_nodes,), dtype=torch.int32, device=dev)
    packed[in_sub] = visited_d.to(torch.int32) | (fresh_d.to(torch.int32) << 1)
    visited = seeds_mask | ((packed & 1) > 0)
    frontier = (packed & 2) > 0
    return PullBFSResult(visited, frontier, traversed)


def k_hop_pull_pallas(g: PullGraph, seeds_mask: torch.Tensor, *, hops: int,
                      seed_uids=None) -> PullBFSResult:
    """k-hop BFS with the active-prefix kernels per hop (the name of the JAX
    entry point is kept). seeds_mask: bool[num_nodes] on g's device.
    seed_uids: optional explicit seed uid list (<= FRONTIER_CAP entries,
    matching seeds_mask) — enables the push fast path for hop 1."""
    dev = g.device
    if seeds_mask.device != dev or seeds_mask.dtype != torch.bool:
        raise ValueError(f"seeds_mask must be a bool tensor on {dev}")
    if seed_uids is not None:
        # dedup: a repeated seed would be pushed once per occurrence
        seed_uids = np.unique(np.asarray(seed_uids))
    have_seeds = seed_uids is not None and len(seed_uids) <= FRONTIER_CAP
    seeds_ranks = torch.full((FRONTIER_CAP,), INT32_MAX, dtype=torch.int32,
                             device=dev)
    if have_seeds and len(seed_uids):
        seeds = torch.from_numpy(seed_uids.astype(np.int32)).to(dev)
        ns = g.subjects.shape[0]
        pos = torch.searchsorted(g.subjects, seeds)
        pos_c = torch.clamp(pos, 0, max(ns - 1, 0))
        hit = (ns > 0) & (_take_clip(g.subjects, pos_c) == seeds)
        seeds_ranks[: len(seed_uids)] = torch.where(
            hit, pos_c.to(torch.int32), INT32_MAX)
    return _k_hop_impl(g, seeds_mask, seeds_ranks, hops, have_seeds)


# ---------------------------------------------------------------------------
# edge-dedup @recurse (reference query/recurse.go:31-177 expandRecurse)
# ---------------------------------------------------------------------------

def _recurse_tail(prefix: torch.Tensor, in_iptr_rank: torch.Tensor,
                  seen: torch.Tensor, allow_loop: bool):
    """prefix -> (reached_d, traversed, seen', fresh): edge dedup plus the
    bounds-diff reachability, shared by the fused and stepped paths."""
    traversed = prefix[-1]
    active = torch.empty(prefix.shape, dtype=torch.bool, device=prefix.device)
    active[0] = prefix[0] > 0
    active[1:] = (prefix[1:] - prefix[:-1]) > 0
    if allow_loop:
        fresh, seen2 = active, seen
    else:
        fresh = active & ~seen
        seen2 = seen | active
    freshp = torch.cumsum(fresh.to(torch.int32), 0, dtype=torch.int32)
    return _bounds_reached(freshp, in_iptr_rank), traversed, seen2, fresh


def recurse_step(in_src_pad, in_iptr_rank, subjects, in_subjects,
                 frontier_mask, seen, *, chunks: int, num_nodes: int,
                 allow_loop: bool):
    """One stepped level over the full uid space (filters / several recurse
    children need host control between levels). Returns (dest words packed,
    traversed, seen', fresh)."""
    fbits = frontier_mask[subjects.to(torch.int64)]          # src ranks
    prefix = _prefix_for(fbits, in_src_pad, chunks)
    reached, trav, seen2, fresh = _recurse_tail(prefix, in_iptr_rank, seen,
                                                allow_loop)
    dest = torch.zeros((num_nodes,), dtype=torch.bool,
                       device=frontier_mask.device)
    dest[in_subjects.to(torch.int64)] = reached
    return pack_words(dest, pack_chunks(num_nodes)), trav, seen2, fresh


def recurse_fused(in_src_pad, in_src_pad_d, in_iptr_rank, subjects,
                  in_subjects, seeds_mask, *, depth: int, chunks: int,
                  chunks_d: int, allow_loop: bool):
    """All `depth` levels in one call: level 1 reads seed bits in src-rank
    space, later levels the previous level's fresh dst-rank mask against the
    dst-rank stream. Returns (dest words [D, Cd*8, 128] packed dst-rank
    masks, traversed int32[D], fresh bool[D, E_pad] kept on the device)."""
    nd = in_subjects.shape[0]
    dev = seeds_mask.device
    seen = torch.zeros((in_src_pad.shape[0],), dtype=torch.bool, device=dev)
    reached = torch.zeros((nd,), dtype=torch.bool, device=dev)
    masks, travs, freshes = [], [], []
    for i in range(depth):
        if i == 0:
            prefix = _prefix_for(seeds_mask[subjects.to(torch.int64)],
                                 in_src_pad, chunks)
        else:
            prefix = _prefix_for(reached, in_src_pad_d, chunks_d)
        reached, trav, seen, fresh = _recurse_tail(prefix, in_iptr_rank,
                                                   seen, allow_loop)
        masks.append(reached)
        travs.append(trav)
        freshes.append(fresh)
    return (pack_words(torch.stack(masks), pack_chunks(nd)),
            torch.stack(travs), torch.stack(freshes))
