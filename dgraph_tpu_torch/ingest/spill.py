"""Sorted run spilling + k-way merge — the external-memory map/shuffle.

Copy of dgraph_tpu/ingest/spill.py for the PyTorch port (host code only).

Reference semantics: dgraph/cmd/bulk/mapper.go:121-175 — map output
accumulates in a bounded in-RAM batch, and when the batch crosses the spill
budget it is sorted and written to a tmp file (one sorted "run"); the
shuffle/reduce then k-way-merges all runs of a shard (merge_shards.go:30,
reduce.go:36). Same shape here, with two run flavors:

  - uid PAIRS (subject→object edges, their reverses, degree→subject pairs):
    sorted by (a, b) and encoded with the storage/packed.py block codec in
    fixed-size chunks. The a-column is monotonic so it packs tightly; the
    b-column is only sorted within each a-group, so group boundaries fall
    back to the codec's raw64 escape — correctness is exact either way
    because pack/unpack round-trip deltas mod 2**64.
  - FRAMED records (typed values, facets, index tokens): (key bytes, seq,
    payload bytes) sorted by (key, seq). The global seq makes the k-way
    merge a total order, so per-key payload order is exactly input order —
    the determinism contract the in-RAM reduce path provides for free.

Merges are streaming: each run keeps one decoded chunk (pairs) or one io
buffer (framed) in RAM, so merge memory is O(fan-in × chunk), never O(run).
"""

from __future__ import annotations

import heapq
import itertools
import os
import struct
from array import array
from dataclasses import dataclass

import numpy as np

from dgraph_tpu_torch.storage import packed

_CHDR = struct.Struct("<I")          # pairs in chunk
_PHDR = struct.Struct("<IIQ")        # packed list: count, nblocks, words len
_FHDR = struct.Struct("<IQI")        # frame: key len, seq, payload len

PAIR_CHUNK = 1 << 16                 # pairs per on-disk chunk (decode unit)
_PAIR_COST = 16                      # buffered bytes per (a, b) pair
_FRAME_COST = 48                     # framed-record overhead past key+payload
MERGE_FANIN_MAX = 64                 # open run files per merge pass; beyond
# this, runs cascade into intermediate runs first (bounds fds: a huge load
# with a small budget can produce thousands of runs per channel, and one
# flat heap over all of them would hit EMFILE exactly when out-of-core
# matters most — the reference shuffles map shards the same way,
# merge_shards.go smallest-into-smallest)


@dataclass
class SpillStats:
    """Ingest observability feed (satellite: /metrics ingest counters)."""

    spill_bytes: int = 0             # bytes written to run files
    spill_runs: int = 0              # run files written
    spill_flushes: int = 0           # whole-buffer flush events
    merge_fanin: int = 0             # max runs merged for one channel
    buffered_peak: int = 0           # max in-RAM buffer estimate seen

    def note_buffered(self, n: int) -> None:
        if n > self.buffered_peak:
            self.buffered_peak = n


# -- packed (de)serialization for pair runs ----------------------------------

def write_packed(f, pu: packed.PackedUidList) -> int:
    """Serialize one PackedUidList; returns bytes written."""
    parts = [_PHDR.pack(pu.count, pu.nblocks, len(pu.words)),
             pu.block_first.tobytes(), pu.block_last.tobytes(),
             pu.block_count.tobytes(), pu.block_width.tobytes(),
             pu.block_off.tobytes(), pu.words.tobytes()]
    n = 0
    for p in parts:
        f.write(p)
        n += len(p)
    return n


def read_packed(buf: bytes, off: int) -> tuple[packed.PackedUidList, int]:
    count, nb, wlen = _PHDR.unpack_from(buf, off)
    off += _PHDR.size

    def arr(dt, n):
        nonlocal off
        a = np.frombuffer(buf, dtype=dt, count=n, offset=off)
        off += a.nbytes
        return a

    return packed.PackedUidList(
        count, arr(np.uint64, nb), arr(np.uint64, nb), arr(np.int32, nb),
        arr(np.int32, nb), arr(np.int64, nb), arr(np.uint32, wlen)), off


# -- spillers ----------------------------------------------------------------

class SpillSet:
    """Shared budget over every channel of every registered spiller: when
    the combined in-RAM estimate crosses the budget, ALL channels flush
    (the reference flushes whole map batches, mapper.go:152 — a per-channel
    budget would let many small channels blow the global bound)."""

    def __init__(self, tmp_dir: str, budget_bytes: int,
                 stats: SpillStats | None = None) -> None:
        os.makedirs(tmp_dir, exist_ok=True)
        self.tmp_dir = tmp_dir
        self.budget = max(1, int(budget_bytes))
        self.stats = stats if stats is not None else SpillStats()
        self.bytes = 0
        self._spillers: list = []
        self._names = itertools.count()
        self.on_flush = None         # optional callback(stats) per flush

    def register(self, spiller) -> None:
        self._spillers.append(spiller)

    def charge(self, n: int) -> None:
        self.bytes += n
        self.stats.note_buffered(self.bytes)
        if self.bytes >= self.budget:
            self.flush()

    def flush(self) -> None:
        had = self.bytes > 0
        if had:
            self.stats.spill_flushes += 1
        for s in self._spillers:
            s.flush()
        self.bytes = 0
        if had and self.on_flush is not None:
            self.on_flush(self.stats)

    def new_run_path(self) -> str:
        from dgraph_tpu_torch.utils import faults

        # disk fault seam: every spill-run write starts here, so a failing
        # or slow scratch disk surfaces as a typed error / stall at the
        # exact point a real ENOSPC/slow-NFS would
        faults.fire("disk.spill")
        return os.path.join(self.tmp_dir, f"run{next(self._names):06d}.spl")


class UidPairSpiller:
    """Channels of (a, b) uid pairs -> sorted chunked run files."""

    def __init__(self, pool: SpillSet) -> None:
        self.pool = pool
        self._bufs: dict = {}        # channel -> (array a, array b)
        self._runs: dict = {}        # channel -> [run path]
        pool.register(self)

    def add(self, channel, a: int, b: int) -> None:
        buf = self._bufs.get(channel)
        if buf is None:
            buf = self._bufs[channel] = (array("Q"), array("Q"))
        buf[0].append(a)
        buf[1].append(b)
        self.pool.charge(_PAIR_COST)

    def flush(self) -> None:
        for channel, (aa, bb) in self._bufs.items():
            if not len(aa):
                continue
            a = np.frombuffer(aa, dtype=np.uint64)
            b = np.frombuffer(bb, dtype=np.uint64)
            order = np.lexsort((b, a))
            a, b = a[order], b[order]
            path = self.pool.new_run_path()
            n = 0
            with open(path, "wb") as f:
                for i in range(0, len(a), PAIR_CHUNK):
                    ca, cb = a[i: i + PAIR_CHUNK], b[i: i + PAIR_CHUNK]
                    f.write(_CHDR.pack(len(ca)))
                    n += _CHDR.size
                    n += write_packed(f, packed.pack(ca))
                    n += write_packed(f, packed.pack(cb))
            self._runs.setdefault(channel, []).append(path)
            st = self.pool.stats
            st.spill_bytes += n
            st.spill_runs += 1
        self._bufs.clear()

    def channels(self):
        return sorted(set(self._runs) | set(self._bufs),
                      key=lambda c: str(c))

    def runs(self, channel) -> list[str]:
        return self._runs.get(channel, [])

    def discard(self, channel) -> None:
        """Delete a channel's consumed run files (frees tmp space as the
        reduce walks predicates — runs are single-use)."""
        for p in self._runs.pop(channel, []):
            try:
                os.unlink(p)
            except OSError:
                pass


class _PairRunReader:
    __slots__ = ("_f", "a", "b", "eof")

    def __init__(self, path: str) -> None:
        self._f = open(path, "rb")
        self.a = np.zeros(0, np.uint64)
        self.b = np.zeros(0, np.uint64)
        self.eof = False

    def fill(self) -> None:
        """Append the next chunk to the buffer (sets eof at end)."""
        hdr = self._f.read(_CHDR.size)
        if len(hdr) < _CHDR.size:
            self.eof = True
            self._f.close()
            return
        (n,) = _CHDR.unpack(hdr)
        ca = self._read_column()
        cb = self._read_column()
        assert len(ca) == n and len(cb) == n, "torn pair-run chunk"
        self.a = np.concatenate([self.a, ca]) if len(self.a) else ca
        self.b = np.concatenate([self.b, cb]) if len(self.b) else cb

    def _read_column(self) -> np.ndarray:
        head = self._f.read(_PHDR.size)
        _count, nb, wlen = _PHDR.unpack(head)
        body = self._f.read(nb * (8 + 8 + 4 + 4 + 8) + wlen * 4)
        pu, _ = read_packed(head + body, 0)
        return packed.unpack(pu)


def _write_pair_run(path: str, groups) -> None:
    """Materialize a merged (a, b-array) group stream back into a sorted
    chunked run file (the cascade step's intermediate)."""
    buf_a: list[np.ndarray] = []
    buf_b: list[np.ndarray] = []
    n = 0
    with open(path, "wb") as f:

        def emit(final: bool) -> None:
            nonlocal n, buf_a, buf_b
            while n >= PAIR_CHUNK or (final and n):
                a = np.concatenate(buf_a)
                b = np.concatenate(buf_b)
                ca, cb = a[:PAIR_CHUNK], b[:PAIR_CHUNK]
                buf_a, buf_b = [a[PAIR_CHUNK:]], [b[PAIR_CHUNK:]]
                n = len(buf_a[0])
                f.write(_CHDR.pack(len(ca)))
                write_packed(f, packed.pack(ca))
                write_packed(f, packed.pack(cb))

        for a, row in groups:
            buf_a.append(np.full(len(row), a, np.uint64))
            buf_b.append(row)
            n += len(row)
            emit(False)
        emit(True)


def merge_pairs(paths: list[str], stats: SpillStats | None = None,
                max_fanin: int = MERGE_FANIN_MAX):
    """K-way merge of sorted pair runs -> (a, sorted unique b array) per
    group, ascending a. More runs than `max_fanin` cascade into
    intermediate runs first, so open fds stay bounded regardless of how
    many flushes the spill budget forced."""
    if stats is not None:
        stats.merge_fanin = max(stats.merge_fanin,
                                min(len(paths), max_fanin))
    paths = list(paths)
    temps: list[str] = []
    try:
        while len(paths) > max_fanin:
            head, paths = paths[:max_fanin], paths[max_fanin:]
            t = f"{head[0]}.c{len(temps)}"
            _write_pair_run(t, _merge_pair_runs(head))
            temps.append(t)
            paths.append(t)
        yield from _merge_pair_runs(paths)
    finally:
        for t in temps:
            try:
                os.unlink(t)
            except OSError:
                pass


def _merge_pair_runs(paths: list[str]):
    """Single-pass streaming merge: each run buffers whole chunks; emission
    advances to the smallest last-buffered `a` across non-EOF runs, so a
    group is only ever emitted once all its pairs are in view. Duplicate
    pairs (within and across runs) collapse exactly like the in-RAM
    reduce's global dedupe (loader/bulk.py _group_rows)."""
    readers = [_PairRunReader(p) for p in paths]
    while True:
        for r in readers:
            # keep >= 2 distinct subjects buffered (or EOF): guarantees the
            # cut below always advances past r's first group
            while not r.eof and (len(r.a) == 0 or r.a[0] == r.a[-1]):
                r.fill()
        active = [r for r in readers if len(r.a)]
        if not active:
            return
        bounds = [int(r.a[-1]) for r in active if not r.eof]
        cut = min(bounds) if bounds else None      # None: all EOF, take all
        take_a, take_b = [], []
        for r in active:
            if cut is None:
                ta, tb = r.a, r.b
                r.a = np.zeros(0, np.uint64)
                r.b = np.zeros(0, np.uint64)
            else:
                k = int(np.searchsorted(r.a, np.uint64(cut), side="left"))
                ta, tb = r.a[:k], r.b[:k]
                r.a, r.b = r.a[k:], r.b[k:]
            if len(ta):
                take_a.append(ta)
                take_b.append(tb)
        if not take_a:
            continue
        a = np.concatenate(take_a)
        b = np.concatenate(take_b)
        order = np.lexsort((b, a))
        a, b = a[order], b[order]
        keep = np.ones(len(a), bool)
        keep[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
        a, b = a[keep], b[keep]
        uq, starts = np.unique(a, return_index=True)
        ends = np.append(starts, len(a))
        for i in range(len(uq)):
            yield int(uq[i]), b[ends[i]: ends[i + 1]]


class FramedSpiller:
    """Channels of (key bytes, payload bytes) records; runs sorted by
    (key, seq) with a global monotone seq, so the merged per-key payload
    sequence is exactly input order (the determinism contract value rows
    and facets need)."""

    def __init__(self, pool: SpillSet) -> None:
        self.pool = pool
        self._bufs: dict = {}        # channel -> [(key, seq, payload)]
        self._runs: dict = {}
        self._seq = itertools.count()
        pool.register(self)

    def add(self, channel, key: bytes, payload: bytes) -> None:
        self._bufs.setdefault(channel, []).append(
            (key, next(self._seq), payload))
        self.pool.charge(len(key) + len(payload) + _FRAME_COST)

    def flush(self) -> None:
        for channel, recs in self._bufs.items():
            if not recs:
                continue
            recs.sort(key=lambda r: (r[0], r[1]))
            path = self.pool.new_run_path()
            n = 0
            with open(path, "wb") as f:
                for key, seq, payload in recs:
                    f.write(_FHDR.pack(len(key), seq, len(payload)))
                    f.write(key)
                    f.write(payload)
                    n += _FHDR.size + len(key) + len(payload)
            self._runs.setdefault(channel, []).append(path)
            st = self.pool.stats
            st.spill_bytes += n
            st.spill_runs += 1
        self._bufs.clear()

    def channels(self):
        return sorted(set(self._runs) | set(self._bufs),
                      key=lambda c: str(c))

    def runs(self, channel) -> list[str]:
        return self._runs.get(channel, [])

    def discard(self, channel) -> None:
        for p in self._runs.pop(channel, []):
            try:
                os.unlink(p)
            except OSError:
                pass


def _iter_frames(path: str):
    with open(path, "rb", buffering=1 << 20) as f:
        while True:
            hdr = f.read(_FHDR.size)
            if len(hdr) < _FHDR.size:
                return
            klen, seq, plen = _FHDR.unpack(hdr)
            yield f.read(klen), seq, f.read(plen)


def _write_framed_run(path: str, frames) -> None:
    with open(path, "wb", buffering=1 << 20) as f:
        for key, seq, payload in frames:
            f.write(_FHDR.pack(len(key), seq, len(payload)))
            f.write(key)
            f.write(payload)


def merge_framed(paths: list[str], stats: SpillStats | None = None,
                 max_fanin: int = MERGE_FANIN_MAX):
    """K-way merge of framed runs by (key, seq) — streaming heap merge,
    cascading through intermediate runs past `max_fanin` (fd bound)."""
    if stats is not None:
        stats.merge_fanin = max(stats.merge_fanin,
                                min(len(paths), max_fanin))
    paths = list(paths)
    temps: list[str] = []
    key_fn = lambda t: (t[0], t[1])   # noqa: E731
    try:
        while len(paths) > max_fanin:
            head, paths = paths[:max_fanin], paths[max_fanin:]
            t = f"{head[0]}.c{len(temps)}"
            _write_framed_run(t, heapq.merge(
                *[_iter_frames(p) for p in head], key=key_fn))
            temps.append(t)
            paths.append(t)
        yield from heapq.merge(*[_iter_frames(p) for p in paths],
                               key=key_fn)
    finally:
        for t in temps:
            try:
                os.unlink(t)
            except OSError:
                pass


def group_framed(frames):
    """(key, seq, payload) stream -> (key, [payloads in seq order]) groups.
    One group is buffered at a time."""
    key = None
    payloads: list[bytes] = []
    for k, _seq, p in frames:
        if k != key:
            if key is not None:
                yield key, payloads
            key, payloads = k, []
        payloads.append(p)
    if key is not None:
        yield key, payloads
