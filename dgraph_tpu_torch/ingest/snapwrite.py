"""Streaming tablet-sectioned snapshot writer (DGTS3).

Copy of dgraph_tpu/ingest/snapwrite.py for the PyTorch port. One
difference: a section gathers its rows' column pieces in memory and hands
them to the spools ROW_BUFFER bytes at a time, not one write per column
per row (2.1M rows made 30M small spool writes); the bytes are the same.

DGTS2 (storage/store.py) concatenates every list's packed metadata into
file-global columns — writing it requires every PostingList (and every
column) in RAM at once, so a checkpoint was a memory event proportional to
key count. DGTS3 keeps the same 14 columns but scopes them PER TABLET:

  b"DGTS3" | u64 upto_ts | u32 meta_len | meta json |
  sections until EOF, in globally sorted key order:
    u32 n_rows | 14 x (u64 byte_len | column bytes)

Tablet prefixes (kind byte + u32 attr len + attr) are never prefixes of one
another, so sorting sections by prefix keeps the concatenated key stream
globally sorted — every DGTS2 reader invariant (contiguous tablet runs,
sorted keys, searchsorted find) carries over per section.

Rows STREAM in: each section spools its columns to bounded buffers
(tempfile.SpooledTemporaryFile — RAM up to `spool_max` per column, disk
past it), so writer memory is O(open sections x spool_max), independent of
row count. A pristine mmap'd SegmentRun can be attached wholesale
(`add_run`): its columns are copied file-to-file in chunks with ZERO
per-row work — the checkpoint fast path for untouched tablets.

Shared by Store.checkpoint (storage/store.py) and the bulk loader's
out-of-core reduce (loader/bulk.py) — one writer is what makes spill-mode
bulk output byte-identical to the in-RAM path.
"""

from __future__ import annotations

import json
import struct
import tempfile

import numpy as np

from dgraph_tpu_torch.storage import packed

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

SPOOL_MAX = 1 << 22          # per-column RAM before a section spools to disk
_COPY_CHUNK = 1 << 22        # file-to-file copy granularity (bytes)
ROW_BUFFER = 1 << 20         # a section's pending row bytes before a flush

# column order — MUST match storage/store.py's DGTS2 column order (the
# loader shares slicing code); dtypes noted for the derived columns
_NCOLS = 14


def tablet_prefix(kind: int, attr: str) -> bytes:
    """Sort key for sections == the shared prefix of every key in the
    tablet (storage/keys.py encoding: kind, u32 len, attr)."""
    a = attr.encode("utf-8")
    return bytes([kind]) + struct.pack(">I", len(a)) + a


def _write_arr(f, arr: np.ndarray) -> None:
    """Chunked array write: mmap-backed views stream through without one
    whole-column copy."""
    if arr.nbytes <= _COPY_CHUNK:
        f.write(arr.tobytes())
        return
    step = max(1, _COPY_CHUNK // max(1, arr.itemsize))
    for i in range(0, len(arr), step):
        f.write(arr[i: i + step].tobytes())


class _Section:
    """One tablet's columns, accumulated row-by-row into spooled buffers."""

    __slots__ = ("prefix", "n", "cols", "_writer", "_pending", "_pending_n")

    def __init__(self, prefix: bytes, spool_max: int, writer) -> None:
        self.prefix = prefix
        self.n = 0
        self.cols = [tempfile.SpooledTemporaryFile(max_size=spool_max)
                     for _ in range(_NCOLS)]
        self._writer = writer
        self._pending = [[] for _ in range(_NCOLS)]   # column pieces
        self._pending_n = 0

    def add_row(self, kb: bytes, base_ts: int, pu: packed.PackedUidList,
                post: bytes = b"") -> None:
        pieces = (
            _U32.pack(len(kb)),
            kb,
            _U64.pack(base_ts),
            _U32.pack(pu.count),
            _U32.pack(pu.nblocks),
            np.ascontiguousarray(pu.block_first, np.uint64).tobytes(),
            np.ascontiguousarray(pu.block_last, np.uint64).tobytes(),
            np.ascontiguousarray(pu.block_count, np.int32).tobytes(),
            np.ascontiguousarray(pu.block_width, np.int32).tobytes(),
            np.ascontiguousarray(pu.block_off, np.int64).tobytes(),
            _U64.pack(len(pu.words)),
            np.ascontiguousarray(pu.words, np.uint32).tobytes(),
            _U32.pack(len(post)),
            post)
        for pend, piece in zip(self._pending, pieces):
            pend.append(piece)
        nbytes = len(kb) + len(post) + pu.nbytes + 8 * _NCOLS
        self._pending_n += nbytes
        if self._pending_n >= ROW_BUFFER:
            self._flush()
        self.n += 1
        self._writer._note_row(nbytes)

    def _flush(self) -> None:
        for col, pend in zip(self.cols, self._pending):
            col.write(b"".join(pend))
            pend.clear()
        self._pending_n = 0

    def _emit(self, out) -> None:
        self._flush()
        out.write(_U32.pack(self.n))
        for col in self.cols:
            blen = col.tell()
            out.write(_U64.pack(blen))
            col.seek(0)
            while True:
                chunk = col.read(_COPY_CHUNK)
                if not chunk:
                    break
                out.write(chunk)
            col.close()


class _RunSection:
    """A pristine SegmentRun attached wholesale: columns stream straight
    from the snapshot mmap — no spools, no per-row work."""

    __slots__ = ("prefix", "seg", "n")

    def __init__(self, prefix: bytes, seg) -> None:
        self.prefix = prefix
        self.seg = seg
        self.n = seg.n

    def _emit(self, out) -> None:
        seg = self.seg
        n = seg.n
        out.write(_U32.pack(n))
        kends = np.asarray(seg.kends, np.int64)
        wstarts = np.asarray(seg.wstarts, np.int64)
        pstarts = np.asarray(seg.pstarts, np.int64)
        key_lens = np.empty(n, np.int64)
        key_lens[0] = kends[0]
        np.subtract(kends[1:], kends[:-1], out=key_lens[1:])
        cols = [
            key_lens.astype(np.uint32),
            np.asarray(seg.keys_blob, np.uint8),
            np.asarray(seg.base_ts, np.uint64),
            np.asarray(seg.counts, np.uint32),
            np.asarray(seg.nbs, np.uint32),
            np.asarray(seg.bfirst, np.uint64),
            np.asarray(seg.blast, np.uint64),
            np.asarray(seg.bcount, np.int32),
            np.asarray(seg.bwidth, np.int32),
            np.asarray(seg.boff, np.int64),
            (wstarts[1:] - wstarts[:-1]).astype(np.uint64),
            np.asarray(seg.words, np.uint32),
            (pstarts[1:] - pstarts[:-1]).astype(np.uint32),
            np.asarray(seg.post_blob, np.uint8),
        ]
        for arr in cols:
            out.write(_U64.pack(arr.nbytes))
            _write_arr(out, arr)


class SnapshotWriter:
    """Assemble a DGTS3 snapshot from sections created in ANY order; they
    are emitted sorted by tablet prefix at finish(). Tracks the peak
    transient estimate (spooled-RAM ceiling + largest row) for the
    checkpoint metrics satellite."""

    def __init__(self, f, upto_ts: int, spool_max: int = SPOOL_MAX) -> None:
        self._f = f
        self.upto_ts = int(upto_ts)
        self.spool_max = spool_max
        self._sections: dict[bytes, object] = {}
        self._open_mem = 0           # sum of min(col bytes, spool_max)
        self.rows = 0
        self.peak_transient = 0

    def _note_row(self, nbytes: int) -> None:
        self.rows += 1
        # RAM estimate: spooled columns cap at spool_max each; count the
        # uncapped growth until then plus the row being appended
        self._open_mem = min(self._open_mem + nbytes,
                             len(self._sections) * _NCOLS * self.spool_max)
        self.peak_transient = max(self.peak_transient,
                                  self._open_mem + nbytes)

    def section(self, kind: int, attr: str) -> _Section:
        prefix = tablet_prefix(kind, attr)
        sec = self._sections.get(prefix)
        if sec is None:
            sec = self._sections[prefix] = _Section(
                prefix, self.spool_max, self)
        return sec

    def add_run(self, kind: int, attr: str, seg) -> None:
        prefix = tablet_prefix(kind, attr)
        assert prefix not in self._sections, "tablet emitted twice"
        self._sections[prefix] = _RunSection(prefix, seg)
        self.rows += seg.n

    def finish(self, meta: dict) -> None:
        f = self._f
        f.write(b"DGTS3")
        f.write(_U64.pack(self.upto_ts))
        mb = json.dumps(meta).encode()
        f.write(_U32.pack(len(mb)) + mb)
        for prefix in sorted(self._sections):
            sec = self._sections[prefix]
            if sec.n == 0:
                if isinstance(sec, _Section):
                    for col in sec.cols:
                        col.close()
                continue
            sec._emit(f)
        self._sections.clear()
