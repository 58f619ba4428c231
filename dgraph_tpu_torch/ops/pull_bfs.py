"""Pull-BFS, edge-dedup @recurse and shortest-path BFS distances over the
active-prefix kernels.

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
packed level masks; bfs_dist reads its loop condition in the same read.
jnp.nonzero(size=, fill_value=) becomes a cumsum + scatter into a
fixed-size buffer (no extra sync); .at[].set(mode="drop") and
jnp.take(mode="clip") become explicit masks and clamps.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.obs import costs, otrace
from dgraph_tpu_torch.ops.csr import degrees as _csr_degrees
from dgraph_tpu_torch.ops.csr import expand as _csr_expand
from dgraph_tpu_torch.ops.prefix import (EDGE_BLOCK, FRONTIER_CAP, INT32_MAX,
                                         LANES, NODES_PER_CHUNK,
                                         active_prefix, active_prefix_sparse)
from dgraph_tpu_torch.ops.uidset import rank_of

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
    """Once-per-snapshot prep: upload the CSR's int32 arrays, transpose to
    dst-sorted in-edges (a stable sort), remap both endpoints to rank
    spaces and pad the edge stream to EDGE_BLOCK pointing at an
    always-zero bitmap bit, all on `device`; the host mirrors come back in
    one copy each. (On a 31.4M-edge CSR the same steps in numpy took 10.9
    s of an H100 machine's host.)"""
    dev = resolve_device(device)
    subjects, indices = np.asarray(subjects), np.asarray(indices)
    E = len(indices)
    if E and int(np.max(indices)) >= num_nodes:
        raise ValueError(
            f"prep_pull: destination uid {int(np.max(indices))} >= "
            f"num_nodes={num_nodes}; pass num_nodes > max uid")
    if len(subjects) and int(np.max(subjects)) >= num_nodes:
        raise ValueError(
            f"prep_pull: subject uid {int(np.max(subjects))} >= "
            f"num_nodes={num_nodes}; pass num_nodes > max uid")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    sub, ptr, ind = up(subjects), up(indptr), up(indices)
    ns = len(subjects)
    src = torch.repeat_interleave(                   # source RANK per edge
        torch.arange(ns, dtype=torch.int32, device=dev), ptr.diff(),
        output_size=E)
    dst_sorted, order = torch.sort(ind, stable=True)
    src_sorted = src[order]
    del src
    in_subjects, counts = torch.unique_consecutive(dst_sorted,
                                                   return_counts=True)
    del dst_sorted
    nd = in_subjects.numel()
    iptr = torch.zeros(nd + 1, dtype=torch.int32, device=dev)
    iptr[1:] = torch.cumsum(counts, 0)
    map_s2d = rank_of(in_subjects, sub, nd)

    chunks = _chunks_for(ns)
    pad_src = chunks * NODES_PER_CHUNK - 1     # beyond Ns: bit always 0
    e_pad = max(EDGE_BLOCK, -(-E // EDGE_BLOCK) * EDGE_BLOCK)
    src_pad = torch.full((e_pad,), pad_src, dtype=torch.int32, device=dev)
    src_pad[:E] = src_sorted

    # hop >= 2 frontiers are subsets of the destinations: a second stream
    # in dst-rank space reads the fresh mask directly (no remap per hop)
    chunks_d = _chunks_for(nd)
    pad_src_d = chunks_d * NODES_PER_CHUNK - 1
    src_d = map_s2d[src_sorted.to(torch.int64)]  # Nd = "not a destination"
    src_pad_d = torch.full((e_pad,), pad_src_d, dtype=torch.int32,
                           device=dev)
    src_pad_d[:E] = torch.where(src_d == nd, pad_src_d, src_d)
    del src_d

    fwd_dst_rank = torch.searchsorted(in_subjects, ind).to(torch.int32)
    map_d2s = rank_of(sub, in_subjects, INT32_MAX)
    host = (None,) * 6
    if with_host_arrays:
        inv_order = torch.empty(E, dtype=torch.int32, device=dev)
        inv_order[order] = torch.arange(E, dtype=torch.int32, device=dev)
        host = (inv_order.cpu().numpy(), iptr.cpu().numpy(),
                src_sorted.cpu().numpy(), map_s2d.cpu().numpy(),
                in_subjects.cpu().numpy().astype(np.int64),
                subjects.astype(np.int64))
    return PullGraph(src_pad, src_pad_d, iptr, sub, in_subjects, map_s2d, ptr,
                     fwd_dst_rank, map_d2s, int(num_nodes), int(E),
                     int(chunks), int(chunks_d), *host)


def pull_graph_for(csr) -> PullGraph:
    """Cached PullGraph for a storage PredCSR (one prep per CSR)."""
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
    w = np.ascontiguousarray(words, dtype="<i4")
    bits = np.unpackbits(w.view(np.uint8).reshape(w.shape[0], -1, 4),
                         axis=2, bitorder="little")     # [p, l, b]
    return bits.transpose(0, 2, 1).reshape(-1)[:n].view(bool)


def words_to_uids(words: torch.Tensor,
                  in_subjects: torch.Tensor) -> torch.Tensor:
    """dst-rank words [Cd*8, 128] -> int64 uids of their set bits,
    ascending (in_subjects is sorted): unpack_words and the rank -> uid map
    on the card, one sync to size the result."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.reshape(-1, 1, LANES) >> shifts.view(1, 32, 1)) & 1
    ranks = torch.nonzero(bits.view(-1)[: in_subjects.shape[0]]).squeeze(1)
    return in_subjects[ranks].to(torch.int64)


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
                n_chunks: int, fcount: int | None = None) -> torch.Tensor:
    """Active-edge inclusive prefix for one frontier: K2 at or below
    SPARSE_MAX set bits, K1 above. The popcount is the hop's one host read
    (the JAX lax.cond), unless the caller read it already (`fcount`)."""
    if fcount is None:
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


def _recurse_fused_levels(in_src_pad, in_src_pad_d, in_iptr_rank, subjects,
                          in_subjects, seeds_masks, *, depth: int,
                          chunks: int, chunks_d: int, allow_loop: bool):
    """The level loop shared by recurse_fused (B = 1) and
    recurse_fused_multi (pallas_bfs._recurse_fused_levels). It runs
    level-major: at each level the B frontiers' popcounts are stacked and
    read in one host sync, then each slice goes to K2 (at most SPARSE_MAX
    set bits) or K1 as _prefix_for routes it. Level 1 reads seed bits in
    src-rank space, later levels the previous level's reached dst-rank mask
    against the dst-rank stream. Each query keeps its own seen-edge mask and
    every op is integer or boolean, so slice b depends on seeds_masks[b]
    alone. Returns (masks_p [B, D, Cd*8, 128], traversed int32[B, D], fresh
    bool[B, D, E_pad])."""
    nb = seeds_masks.shape[0]
    nd = in_subjects.shape[0]
    dev = seeds_masks.device
    e_pad = in_src_pad.shape[0]
    seen = [torch.zeros((e_pad,), dtype=torch.bool, device=dev)
            for _ in range(nb)]
    masks = [[] for _ in range(nb)]
    travs = [[] for _ in range(nb)]
    freshes = [[] for _ in range(nb)]
    fronts = seeds_masks[:, subjects.to(torch.int64)]    # src ranks, level 1
    for i in range(depth):
        stream, n_chunks = (in_src_pad, chunks) if i == 0 \
            else (in_src_pad_d, chunks_d)
        counts = fronts.sum(dim=1).tolist()               # the level's read
        reached = []
        for b in range(nb):
            prefix = _prefix_for(fronts[b], stream, n_chunks, counts[b])
            r, trav, seen[b], fresh = _recurse_tail(prefix, in_iptr_rank,
                                                    seen[b], allow_loop)
            reached.append(r)
            masks[b].append(r)
            travs[b].append(trav)
            freshes[b].append(fresh)
        fronts = torch.stack(reached)
    return (pack_words(torch.stack([torch.stack(m) for m in masks]),
                       pack_chunks(nd)),
            torch.stack([torch.stack(t) for t in travs]),
            torch.stack([torch.stack(f) for f in freshes]))


def recurse_fused(in_src_pad, in_src_pad_d, in_iptr_rank, subjects,
                  in_subjects, seeds_mask, *, depth: int, chunks: int,
                  chunks_d: int, allow_loop: bool):
    """All `depth` levels of one query in one call, one popcount read a
    level. Returns (dest words [D, Cd*8, 128] packed dst-rank masks,
    traversed int32[D], fresh bool[D, E_pad] kept on the device)."""
    masks_p, trav, fresh = _recurse_fused_levels(
        in_src_pad, in_src_pad_d, in_iptr_rank, subjects, in_subjects,
        seeds_mask[None], depth=depth, chunks=chunks, chunks_d=chunks_d,
        allow_loop=allow_loop)
    return masks_p[0], trav[0], fresh[0]


def recurse_fused_multi(in_src_pad, in_src_pad_d, in_iptr_rank, subjects,
                        in_subjects, seeds_masks, *, depth: int, chunks: int,
                        chunks_d: int, allow_loop: bool):
    """Multi-source recurse: seeds_masks [B, num_nodes] stacks B concurrent
    queries' seed masks (the batched-dispatch tier, query/batch.py). The
    JAX version maps the level body over the batch in one dispatch; here
    the shared level loop reads the B popcounts of a level in one host
    sync, so a batch pays `depth` reads instead of B x depth, and slice b
    is bit-identical to a solo recurse_fused call with seeds_masks[b].
    Returns (masks_p [B, D, Cd*8, 128], traversed int32[B, D], fresh
    bool[B, D, E_pad])."""
    return _recurse_fused_levels(
        in_src_pad, in_src_pad_d, in_iptr_rank, subjects, in_subjects,
        seeds_masks, depth=depth, chunks=chunks, chunks_d=chunks_d,
        allow_loop=allow_loop)


# ---------------------------------------------------------------------------
# unweighted shortest path (the `shortest` kernel tier)
# ---------------------------------------------------------------------------

_DIST_BITS = 8          # distance labels fit a byte (max_hops clamped below)
DIST_UNREACHED = (1 << _DIST_BITS) - 1


def bfs_dist(in_src_pad, in_src_pad_d, in_iptr_rank, subjects, in_subjects,
             seeds_mask, dst_rank: int, max_hops: int, *, chunks: int,
             chunks_d: int):
    """Unweighted single-source BFS distances per dst rank, stopping once
    dst_rank is reached (pallas_bfs.bfs_dist). Hop 1 reads the seed bits in
    src-rank space; later hops the fresh dst-rank mask against the dst-rank
    stream, as recurse_fused does.

    JAX's lax.while_loop becomes a host loop whose condition, ~found &
    (h < max_hops) & (h == 0 | fresh.any()), is read once per hop together
    with the popcount that picks K2 or K1: a path of d hops costs d + 1
    reads. Returns (dist uint8[Nd] on the device, DIST_UNREACHED where
    never reached; found, a 0-d bool tensor; h, the hops run)."""
    nd = in_subjects.shape[0]
    dev = seeds_mask.device
    visited = seeds_mask[in_subjects.to(torch.int64)]        # [Nd]
    dist = torch.where(visited, 0, DIST_UNREACHED).to(torch.uint8)
    found = visited[dst_rank]
    fresh = torch.zeros((nd,), dtype=torch.bool, device=dev)
    h = 0
    while h < max_hops:
        if h == 0:
            frontier, stream, n_chunks = (
                seeds_mask[subjects.to(torch.int64)], in_src_pad, chunks)
        else:
            frontier, stream, n_chunks = fresh, in_src_pad_d, chunks_d
        fcount, hit = torch.stack(
            [frontier.sum(), found.to(torch.int64)]).tolist()
        if hit or (h > 0 and fcount == 0):
            break
        prefix = _prefix_for(frontier, stream, n_chunks, fcount)
        fresh = _bounds_reached(prefix, in_iptr_rank) & ~visited
        visited = visited | fresh
        dist = torch.where(fresh, h + 1, dist)
        found = visited[dst_rank]
        h += 1
    return dist, found, h


def shortest_bfs(g: PullGraph, src: int, dst: int, max_hops: int):
    """Run bfs_dist, fetch the byte distances once, and walk the predecessor
    chain on the host in-adjacency: at each step the lowest src rank (so
    the lowest uid) among the in-edges at distance d-1, and at d == 1 the
    seed itself. Returns the uid path [src..dst], or None when dst is not
    reached within max_hops. g needs its host arrays (pull_graph_for).

    The loop and the fetch run in the `shortest_bfs` span, inside the
    `pb.shortest_bfs` device seam; the walk in the `shortest_walk` span.
    Inside a request each books its time, and the loop its hops, in the
    request's Node registry (dgraph_shortest_{bfs,walk}_ns_total,
    dgraph_shortest_bfs_hops_total)."""
    nd = len(g.host_in_subjects)
    if nd == 0:
        return None
    dr = int(np.searchsorted(g.host_in_subjects, dst))
    if dr >= nd or g.host_in_subjects[dr] != dst:
        return None              # dst has no in-edges: unreachable
    max_hops = min(int(max_hops), DIST_UNREACHED - 1)
    if src >= g.num_nodes:
        return None
    t0 = time.perf_counter_ns()
    with otrace.span("shortest_bfs"), costs.kernel("pb.shortest_bfs") as ck:
        seeds_mask = torch.zeros((g.num_nodes,), dtype=torch.bool,
                                 device=g.device)
        seeds_mask[src] = True
        dist_d, _found, hops = bfs_dist(
            g.in_src_pad, g.in_src_pad_d, g.in_iptr_rank, g.subjects,
            g.in_subjects, seeds_mask, dr, max_hops, chunks=g.chunks,
            chunks_d=g.chunks_d)
        dist = dist_d.cpu().numpy()                    # the one fetch
        ck.set(d2h=int(dist.nbytes))
    t1 = time.perf_counter_ns()
    otrace.count("dgraph_shortest_bfs_ns_total", t1 - t0)
    otrace.count("dgraph_shortest_bfs_hops_total", hops)
    if dist[dr] == DIST_UNREACHED:
        return None
    with otrace.span("shortest_walk"):
        path = _walk_back(g, dist, dr, src)
    otrace.count("dgraph_shortest_walk_ns_total", time.perf_counter_ns() - t1)
    return path


def _walk_back(g: PullGraph, dist: np.ndarray, dr: int, src: int):
    """The predecessor chain from dst rank `dr` back to `src` over the host
    in-adjacency and the fetched distances; None on labels that cannot
    come from bfs_dist. A dst rank's in-edges are sorted by src rank (the
    stable transpose of prep_pull), so the lowest src rank at distance d-1
    is the first one, and the seed is found by binary search."""
    nd = len(g.host_in_subjects)
    iptr, in_src = g.host_in_iptr, g.host_in_src
    sub_uids = g.host_subjects   # uid of a src rank
    s_rank = int(np.searchsorted(sub_uids, src))
    if s_rank >= len(sub_uids) or sub_uids[s_rank] != src:
        s_rank = -1              # the seed has no out-edge: never a source

    path = [int(g.host_in_subjects[dr])]
    v_rank = dr
    for d in range(int(dist[dr]), 0, -1):
        srcs = in_src[iptr[v_rank]: iptr[v_rank + 1]]     # src RANKS
        if d == 1:
            # the predecessor must be the seed itself
            j = int(np.searchsorted(srcs, s_rank))
            if j >= len(srcs) or srcs[j] != s_rank:
                return None      # inconsistent labels (cannot happen)
            path.append(src)
            break
        u_rank = _first_at(srcs, g.host_map_s2d, dist, d - 1, nd)
        if u_rank is None:
            return None          # inconsistent labels (cannot happen)
        path.append(int(sub_uids[u_rank]))
        v_rank = int(g.host_map_s2d[u_rank])
    return path[::-1]


WALK_CHUNK = 256     # in-edges a walk step tests first; each next chunk 8x


def _first_at(srcs: np.ndarray, map_s2d: np.ndarray, dist: np.ndarray,
              level: int, nd: int):
    """The first src rank in `srcs` whose dst rank lies at distance
    `level`, or None. The ranks are tested a chunk at a time, each chunk 8
    times the last, so a hub's step stops at the first chunk that holds
    one instead of testing every in-edge."""
    i, step = 0, WALK_CHUNK
    while i < len(srcs):
        part = srcs[i: i + step]
        m = map_s2d[part]
        hit = m < nd
        hit[hit] = dist[m[hit]] == level
        k = int(np.argmax(hit))
        if hit[k]:
            return int(part[k])
        i += step
        step *= 8
    return None


# device-runtime observatory (obs/devprof.py): the module's entry points by
# program family, under the JAX package's names. Nothing here compiles per
# shape: /debug/compiles probes each for the programs it holds built, which
# is the one nvcc library of K1/K2 for the kernel families (prefix.py) and
# none for the torch-op functions.
JIT_PROGRAMS = {
    "pb.active_prefix": active_prefix,
    "pb.active_prefix_sparse": active_prefix_sparse,
    "pb.k_hop": _k_hop_impl,
    "pb.pack_mask": pack_mask,
    "pb.recurse_step": recurse_step,
    "pb.bfs_dist": bfs_dist,
    "pb.recurse_fused": recurse_fused,
    "pb.recurse_fused_multi": recurse_fused_multi,
}
