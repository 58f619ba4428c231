"""Block-packed sorted-uid codec — the TPU descendant of SIMD-BP128.

Copy of dgraph_tpu/storage/packed.py for the PyTorch port.

Reference semantics: bp128/ — delta compression of sorted uint64 uid lists in
256-int blocks with per-block metadata {2 seed uint64s, byte offset}
(bp128/bp128.go:23,137-144), block-skipping seek for galloping intersection
(BPackIterator.Init/AfterUid, :219-340), generated SSE2 kernels for each bit
width (bp128/peachpy/*.py).

TPU redesign — NOT a translation:
- Block size is 128 (the VPU lane width) so one block decodes as one vector op.
- Per-block metadata is a struct-of-arrays (first uid, last uid, count, bit
  width, word offset) instead of interleaved bytes: on device these become
  gatherable int arrays; `last` gives block-skip seek (the AfterUid analog) as
  a vectorized binary search instead of a pointer walk.
- Deltas are packed little-endian into a flat uint32 word stream, each block
  word-aligned. Decode is branch-free for every width w<=32:
      pair = words[k] | words[k+1] << 32 ;  v = (pair >> s) & mask
  followed by an intra-block cumsum — shifts-by-vector + cumsum are native VPU
  ops, so ONE kernel handles all widths (the reference generates 33 unrolled
  asm kernels per direction; XLA's vectorizer makes that unnecessary).
- Blocks whose deltas need >32 bits use a word-aligned raw64 escape
  (width=64, two words per value).

The host codec here is vectorized numpy (pack/unpack plus pack_many/
unpack_many batched forms for whole-tablet work); `ops/packed_decode.py`
decodes the same format on device so packed lists can live in HBM.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BLOCK = 128
_MASK32 = np.uint64(0xFFFFFFFF)


@dataclass
class PackedUidList:
    """Immutable packed sorted uid list (struct-of-arrays block metadata)."""

    count: int                 # total uids
    block_first: np.ndarray    # uint64[nb] first uid of block
    block_last: np.ndarray     # uint64[nb] last uid of block (seek metadata)
    block_count: np.ndarray    # int32[nb]  uids in block (<= BLOCK; only last partial)
    block_width: np.ndarray    # int32[nb]  bits per delta (0..32, or 64 = raw escape)
    block_off: np.ndarray      # int64[nb]  word offset of block's packed deltas
    words: np.ndarray          # uint32[W]  packed delta stream

    @property
    def nblocks(self) -> int:
        return len(self.block_first)

    @property
    def nbytes(self) -> int:
        return int(self.words.nbytes + self.block_first.nbytes + self.block_last.nbytes
                   + self.block_count.nbytes + self.block_width.nbytes + self.block_off.nbytes)


def _width_for(maxdelta: np.ndarray) -> np.ndarray:
    """Bits needed per block; 64 = raw escape for deltas >= 2**32."""
    w = np.zeros(maxdelta.shape, dtype=np.int32)
    nz = maxdelta > 0
    w[nz] = np.floor(np.log2(maxdelta[nz].astype(np.float64))).astype(np.int32) + 1
    # float64 log2 is exact enough below 2**48; verify and bump any edge cases
    bad = (maxdelta >> np.minimum(w, 63).astype(np.uint64)) > 0
    w[bad] += 1
    w[w > 32] = 64
    return w


def pack(uids) -> PackedUidList:
    """Pack a sorted, duplicate-free uid array."""
    uids = np.asarray(uids, dtype=np.uint64)
    n = len(uids)
    if n == 0:
        z64 = np.zeros(0, dtype=np.uint64)
        z32 = np.zeros(0, dtype=np.int32)
        return PackedUidList(0, z64, z64.copy(), z32, z32.copy(),
                             np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint32))
    nb = -(-n // BLOCK)
    padded = np.empty(nb * BLOCK, dtype=np.uint64)
    padded[:n] = uids
    padded[n:] = uids[-1]  # zero deltas in the tail of the last block
    blocks = padded.reshape(nb, BLOCK)

    deltas = np.zeros_like(blocks)
    deltas[:, 1:] = blocks[:, 1:] - blocks[:, :-1]
    block_first = blocks[:, 0].copy()
    counts = np.full(nb, BLOCK, dtype=np.int32)
    counts[-1] = n - (nb - 1) * BLOCK
    block_last = padded.reshape(nb, BLOCK)[np.arange(nb), counts - 1].copy()
    widths = _width_for(deltas.max(axis=1))

    words_per_block = np.where(widths == 64, 2 * BLOCK, -(-(BLOCK * widths) // 32)).astype(np.int64)
    offs = np.zeros(nb, dtype=np.int64)
    offs[1:] = np.cumsum(words_per_block)[:-1]
    total_words = int(words_per_block.sum())
    words = np.zeros(total_words + 1, dtype=np.uint32)  # +1 pad word for pair reads

    # raw64 escape blocks: word-aligned lo/hi pairs
    raw = widths == 64
    if raw.any():
        for b in np.nonzero(raw)[0]:
            d = deltas[b]
            o = offs[b]
            words[o : o + 2 * BLOCK : 2] = (d & _MASK32).astype(np.uint32)
            words[o + 1 : o + 1 + 2 * BLOCK : 2] = (d >> np.uint64(32)).astype(np.uint32)

    # bitpacked blocks, fully vectorized across all blocks at once
    bp = np.nonzero(~raw & (widths > 0))[0]
    if len(bp) > 0:
        w = widths[bp][:, None].astype(np.int64)                     # [B,1]
        bitpos = np.arange(BLOCK, dtype=np.int64)[None, :] * w       # [B,128]
        widx = offs[bp][:, None] + (bitpos >> 5)
        shift = (bitpos & 31).astype(np.uint64)
        v = deltas[bp]
        lo = ((v << shift) & _MASK32).astype(np.uint32)
        hi = (v >> (np.uint64(32) - shift)).astype(np.uint32)        # shift==0 → v>>32
        np.bitwise_or.at(words, widx.ravel(), lo.ravel())
        np.bitwise_or.at(words, (widx + 1).ravel(), hi.ravel())

    return PackedUidList(n, block_first, block_last, counts, widths, offs, words[:-1])


def pack_many(rows: list[np.ndarray]) -> list[PackedUidList]:
    """Pack many sorted uid arrays in one vectorized pass.

    Semantically identical to [pack(r) for r in rows] but amortizes numpy
    call overhead across rows — the bulk loader packs hundreds of thousands
    of small per-subject lists (reduce.go:36 packs per key too, but in Go a
    call is cheap; in numpy the per-call fixed cost dominates tiny lists).
    Metadata and word arrays of each result are zero-copy slices of shared
    buffers."""
    R = len(rows)
    lens = np.fromiter((len(r) for r in rows), dtype=np.int64, count=R)
    nbs = -(-lens // BLOCK)                       # blocks per row (0 for empty)
    nonempty = lens > 0
    if not nonempty.any():
        return [pack(np.zeros(0, dtype=np.uint64)) for _ in rows]
    concat = np.concatenate([np.asarray(r, dtype=np.uint64)
                             for r, ne in zip(rows, nonempty) if ne])
    row_start = np.zeros(R, dtype=np.int64)
    np.cumsum(lens[:-1], out=row_start[1:])
    row_block_start = np.zeros(R, dtype=np.int64)
    np.cumsum(nbs[:-1], out=row_block_start[1:])
    NB = int(nbs.sum())

    block_row = np.repeat(np.arange(R, dtype=np.int64), nbs)          # [NB]
    block_pos = np.arange(NB, dtype=np.int64) - row_block_start[block_row]
    lane = np.arange(BLOCK, dtype=np.int64)
    elem = (row_start[block_row, None] + block_pos[:, None] * BLOCK
            + lane[None, :])
    row_end = row_start[block_row] + lens[block_row]                  # [NB]
    blocks = concat[np.minimum(elem, (row_end - 1)[:, None])]         # pad=last

    deltas = np.zeros_like(blocks)
    deltas[:, 1:] = blocks[:, 1:] - blocks[:, :-1]
    block_first = np.ascontiguousarray(blocks[:, 0])
    counts = np.minimum(BLOCK, lens[block_row] - block_pos * BLOCK).astype(np.int32)
    block_last = blocks[np.arange(NB), counts - 1].copy()
    widths = _width_for(deltas.max(axis=1))

    words_per_block = np.where(widths == 64, 2 * BLOCK,
                               -(-(BLOCK * widths) // 32)).astype(np.int64)
    offs = np.zeros(NB, dtype=np.int64)
    offs[1:] = np.cumsum(words_per_block)[:-1]
    total_words = int(words_per_block.sum())
    words = np.zeros(total_words + 1, dtype=np.uint32)

    raw = widths == 64
    if raw.any():
        for b in np.nonzero(raw)[0]:
            d, o = deltas[b], offs[b]
            words[o : o + 2 * BLOCK : 2] = (d & _MASK32).astype(np.uint32)
            words[o + 1 : o + 1 + 2 * BLOCK : 2] = (d >> np.uint64(32)).astype(np.uint32)
    bp = np.nonzero(~raw & (widths > 0))[0]
    if len(bp) > 0:
        w = widths[bp][:, None].astype(np.int64)
        bitpos = lane[None, :] * w
        widx = offs[bp][:, None] + (bitpos >> 5)
        shift = (bitpos & 31).astype(np.uint64)
        v = deltas[bp]
        lo = ((v << shift) & _MASK32).astype(np.uint32)
        hi = (v >> (np.uint64(32) - shift)).astype(np.uint32)
        np.bitwise_or.at(words, widx.ravel(), lo.ravel())
        np.bitwise_or.at(words, (widx + 1).ravel(), hi.ravel())

    out: list[PackedUidList] = []
    word_ends = offs + words_per_block
    for r in range(R):
        n = int(lens[r])
        if n == 0:
            out.append(pack(np.zeros(0, dtype=np.uint64)))
            continue
        b0 = int(row_block_start[r])
        b1 = b0 + int(nbs[r])
        wbase = int(offs[b0])
        wend = int(word_ends[b1 - 1])
        out.append(PackedUidList(
            n, block_first[b0:b1], block_last[b0:b1], counts[b0:b1],
            widths[b0:b1], offs[b0:b1] - wbase, words[wbase:wend]))
    return out


def unpack(pl: PackedUidList) -> np.ndarray:
    """Decode every uid (numpy mirror of the device kernel in ops/packed_decode.py)."""
    nb = pl.nblocks
    if nb == 0:
        return np.zeros(0, dtype=np.uint64)
    words = np.concatenate([pl.words, np.zeros(2, dtype=np.uint32)])
    w = pl.block_width[:, None].astype(np.int64)
    raw = pl.block_width == 64
    bitpos = np.arange(BLOCK, dtype=np.int64)[None, :] * np.where(w == 64, 0, w)
    widx = pl.block_off[:, None] + (bitpos >> 5)
    shift = (bitpos & 31).astype(np.uint64)
    pair = words[widx].astype(np.uint64) | (words[widx + 1].astype(np.uint64) << np.uint64(32))
    mask = np.where(w >= 32, _MASK32, (np.uint64(1) << w.astype(np.uint64)) - np.uint64(1))
    deltas = (pair >> shift) & mask
    deltas = np.where(w == 0, np.uint64(0), deltas)
    if raw.any():
        ro = pl.block_off[raw][:, None] + 2 * np.arange(BLOCK, dtype=np.int64)[None, :]
        deltas[raw] = words[ro].astype(np.uint64) | (words[ro + 1].astype(np.uint64) << np.uint64(32))
    deltas[:, 0] = 0
    out = pl.block_first[:, None] + np.cumsum(deltas, axis=1)
    lane = np.tile(np.arange(BLOCK), nb)
    keep = lane < np.repeat(pl.block_count, BLOCK)
    return out.ravel()[keep]


def unpack_many(pls: list[PackedUidList]) -> list[np.ndarray]:
    """Decode many packed lists in one vectorized pass (mirror of pack_many:
    snapshot builds decode every list of a tablet; per-call numpy overhead
    dominates small lists)."""
    R = len(pls)
    nbs = np.fromiter((p.nblocks for p in pls), dtype=np.int64, count=R)
    NB = int(nbs.sum())
    if NB == 0:
        return [np.zeros(0, dtype=np.uint64) for _ in pls]
    nz = [p for p in pls if p.nblocks]
    word_lens = np.fromiter((len(p.words) for p in nz), dtype=np.int64,
                            count=len(nz))
    word_base = np.zeros(len(nz), dtype=np.int64)
    np.cumsum(word_lens[:-1], out=word_base[1:])
    words = np.concatenate([p.words for p in nz] + [np.zeros(2, np.uint32)])
    block_first = np.concatenate([p.block_first for p in nz])
    block_count = np.concatenate([p.block_count for p in nz])
    block_width = np.concatenate([p.block_width for p in nz])
    block_off = np.concatenate(
        [p.block_off + b for p, b in zip(nz, word_base)])

    w = block_width[:, None].astype(np.int64)
    raw = block_width == 64
    bitpos = np.arange(BLOCK, dtype=np.int64)[None, :] * np.where(w == 64, 0, w)
    widx = block_off[:, None] + (bitpos >> 5)
    shift = (bitpos & 31).astype(np.uint64)
    pair = words[widx].astype(np.uint64) | (words[widx + 1].astype(np.uint64) << np.uint64(32))
    mask = np.where(w >= 32, _MASK32, (np.uint64(1) << w.astype(np.uint64)) - np.uint64(1))
    deltas = (pair >> shift) & mask
    deltas = np.where(w == 0, np.uint64(0), deltas)
    if raw.any():
        ro = block_off[raw][:, None] + 2 * np.arange(BLOCK, dtype=np.int64)[None, :]
        deltas[raw] = words[ro].astype(np.uint64) | (words[ro + 1].astype(np.uint64) << np.uint64(32))
    deltas[:, 0] = 0
    all_vals = block_first[:, None] + np.cumsum(deltas, axis=1)   # [NB, 128]

    out: list[np.ndarray] = []
    b0 = 0
    for p, nb in zip(pls, nbs):
        if nb == 0:
            out.append(np.zeros(0, dtype=np.uint64))
            continue
        rows = all_vals[b0 : b0 + nb]
        cnts = block_count[b0 : b0 + nb]
        lane = np.tile(np.arange(BLOCK), int(nb))
        keep = lane < np.repeat(cnts, BLOCK)
        out.append(rows.ravel()[keep])
        b0 += int(nb)
    return out


def seek_block(pl: PackedUidList, after_uid: int) -> int:
    """First block that can contain a uid > after_uid (AfterUid seek,
    reference bp128/bp128.go:276). Returns pl.nblocks when exhausted."""
    return int(np.searchsorted(pl.block_last, np.uint64(after_uid), side="right"))
