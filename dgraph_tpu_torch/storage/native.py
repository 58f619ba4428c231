"""ctypes binding for the host codec (csrc/codec.cc).

Port of dgraph_tpu/storage/native.py. The C++ source is the port's own copy
of native/codec.cc; it is built at first use with g++ into
build/dgraph_tpu_torch/ at the repository root, named by a hash of the
source and the flags, through a temporary file and os.replace so that
concurrent first users (parallel test workers) never load a torn library.
The JAX package's native/libdgt.so is never read or written.

Every entry gives way to the numpy codec when the toolchain or library is
unavailable: `available()` gates use, and storage/packed.py stays the
source of truth for the wire format (the native codec is bit-identical and
tested against it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "codec.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dgraph_tpu_torch"
# -mtune (not -march): the library may travel to an older CPU with the
# checkout, where -march=native would SIGILL
CXX_FLAGS = ("-O3", "-mtune=native", "-fPIC", "-shared", "-std=c++17")

_lib = None
_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdgt-{digest}.so"


def _build(path: Path) -> bool:
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _lib = _open()
        _tried = True
    return _lib


def _open():
    if not _SRC.exists():
        return None
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        # torn library from an interrupted build: rebuild once
        if not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
    i64, u64p = ctypes.c_int64, np.ctypeslib.ndpointer(np.uint64, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    lib.dgt_pack.restype = i64
    lib.dgt_pack.argtypes = [u64p, i64, u64p, u64p, i32p, i32p, i64p, u32p]
    lib.dgt_unpack.restype = i64
    lib.dgt_unpack.argtypes = [u64p, i32p, i32p, i64p, u32p, i64, u64p]
    lib.dgt_pack_many.restype = i64
    lib.dgt_pack_many.argtypes = [u64p, i64p, i64p, i64, u64p, u64p, i32p,
                                  i32p, i64p, u32p, i64p]
    lib.dgt_unpack_many.restype = i64
    lib.dgt_unpack_many.argtypes = [u64p, i32p, i32p, i64p, u32p, i64p, i64p,
                                    i64, u64p]
    return lib


def available() -> bool:
    return _load() is not None


def pack(uids: np.ndarray):
    """Native pack; same result object as packed.pack. uids must be a sorted
    C-contiguous uint64 array."""
    from dgraph_tpu_torch.storage import packed

    lib = _load()
    n = len(uids)
    if lib is None or n == 0:
        return packed.pack(uids)
    uids = np.ascontiguousarray(uids, dtype=np.uint64)
    nb = -(-n // packed.BLOCK)
    bfirst = np.empty(nb, np.uint64)
    blast = np.empty(nb, np.uint64)
    bcount = np.empty(nb, np.int32)
    bwidth = np.empty(nb, np.int32)
    boff = np.empty(nb, np.int64)
    words = np.empty(nb * 2 * packed.BLOCK, np.uint32)
    total = lib.dgt_pack(uids, n, bfirst, blast, bcount, bwidth, boff, words)
    return packed.PackedUidList(n, bfirst, blast, bcount, bwidth, boff,
                                words[:total].copy())


def unpack(pl) -> np.ndarray:
    """Native unpack; bit-identical to packed.unpack."""
    from dgraph_tpu_torch.storage import packed

    lib = _load()
    if lib is None or pl.nblocks == 0:
        return packed.unpack(pl)
    words = np.empty(len(pl.words) + 2, np.uint32)   # decode pair-read pad
    words[: len(pl.words)] = pl.words
    words[len(pl.words):] = 0
    out = np.empty(pl.count, np.uint64)
    k = lib.dgt_unpack(
        np.ascontiguousarray(pl.block_first, np.uint64),
        np.ascontiguousarray(pl.block_count, np.int32),
        np.ascontiguousarray(pl.block_width, np.int32),
        np.ascontiguousarray(pl.block_off, np.int64),
        words, pl.nblocks, out)
    assert k == pl.count
    return out


def unpack_many_flat(pls) -> tuple[np.ndarray, np.ndarray]:
    """Batched unpack WITHOUT per-row slicing: (flat uint64 uids, int64
    per-row counts). The snapshot fold consumes rows as spans of the flat
    array — materializing 100k+ tiny arrays is the 10M-scale fold cliff."""
    from dgraph_tpu_torch.storage import packed

    R = len(pls)
    counts = np.fromiter((p.count for p in pls), np.int64, count=R)
    if R == 0:
        return np.zeros(0, np.uint64), counts
    lib = _load()
    if lib is None:
        rows = packed.unpack_many(pls)
        return (np.concatenate(rows) if rows else np.zeros(0, np.uint64),
                counts)
    nbs = np.fromiter((p.nblocks for p in pls), dtype=np.int64, count=R)
    if int(nbs.sum()) == 0:
        return np.zeros(0, np.uint64), counts
    nz = [p for p in pls if p.nblocks]
    word_lens = np.fromiter((len(p.words) for p in nz), np.int64,
                            count=len(nz))
    word_base_nz = np.zeros(len(nz), np.int64)
    np.cumsum(word_lens[:-1], out=word_base_nz[1:])
    words = np.empty(int(word_lens.sum()) + 2, np.uint32)
    for p, b in zip(nz, word_base_nz):
        words[int(b): int(b) + len(p.words)] = p.words
    words[-2:] = 0
    row_word_start = np.zeros(R, np.int64)
    row_word_start[nbs > 0] = word_base_nz
    bfirst = np.concatenate([p.block_first for p in nz]).astype(
        np.uint64, copy=False)
    bcount = np.concatenate([p.block_count for p in nz]).astype(
        np.int32, copy=False)
    bwidth = np.concatenate([p.block_width for p in nz]).astype(
        np.int32, copy=False)
    boff = np.concatenate([p.block_off for p in nz]).astype(
        np.int64, copy=False)
    out = np.empty(int(counts.sum()), np.uint64)
    k = lib.dgt_unpack_many(
        np.ascontiguousarray(bfirst), np.ascontiguousarray(bcount),
        np.ascontiguousarray(bwidth), np.ascontiguousarray(boff),
        words, nbs, row_word_start, R, out)
    assert k == len(out)
    return out, counts


def unpack_columns(tp, total: int) -> np.ndarray | None:
    """Decode a whole TabletPacked in ONE native call (zero per-list
    marshalling — the cold-open fold hot path). None when the native
    library is unavailable (caller falls back to per-list decode)."""
    lib = _load()
    if lib is None:
        return None
    words = np.empty(len(tp.words) + 2, np.uint32)   # decode pair-read pad
    words[: len(tp.words)] = tp.words
    words[-2:] = 0
    out = np.empty(total, np.uint64)
    k = lib.dgt_unpack_many(
        np.ascontiguousarray(tp.bfirst, np.uint64),
        np.ascontiguousarray(tp.bcount, np.int32),
        np.ascontiguousarray(tp.bwidth, np.int32),
        np.ascontiguousarray(tp.boff, np.int64),
        words, np.ascontiguousarray(tp.nbs, np.int64),
        np.ascontiguousarray(tp.row_word_start, np.int64), tp.n, out)
    assert k == total
    return out


def unpack_many(pls) -> list[np.ndarray]:
    """Native batched unpack; same per-row arrays as packed.unpack_many."""
    from dgraph_tpu_torch.storage import packed

    lib = _load()
    R = len(pls)
    if lib is None or R == 0:
        return packed.unpack_many(pls)
    nbs = np.fromiter((p.nblocks for p in pls), dtype=np.int64, count=R)
    NB = int(nbs.sum())
    if NB == 0:
        return [np.zeros(0, np.uint64) for _ in pls]
    nz = [p for p in pls if p.nblocks]
    word_lens = np.fromiter((len(p.words) for p in nz), np.int64,
                            count=len(nz))
    word_base_nz = np.zeros(len(nz), np.int64)
    np.cumsum(word_lens[:-1], out=word_base_nz[1:])
    words = np.empty(int(word_lens.sum()) + 2, np.uint32)
    for p, b in zip(nz, word_base_nz):
        words[int(b): int(b) + len(p.words)] = p.words
    words[-2:] = 0
    row_word_start = np.zeros(R, np.int64)
    row_word_start[nbs > 0] = word_base_nz
    bfirst = np.concatenate([p.block_first for p in nz]).astype(
        np.uint64, copy=False)
    bcount = np.concatenate([p.block_count for p in nz]).astype(
        np.int32, copy=False)
    bwidth = np.concatenate([p.block_width for p in nz]).astype(
        np.int32, copy=False)
    boff = np.concatenate([p.block_off for p in nz]).astype(
        np.int64, copy=False)
    counts = np.fromiter((p.count for p in pls), np.int64, count=R)
    out = np.empty(int(counts.sum()), np.uint64)
    k = lib.dgt_unpack_many(
        np.ascontiguousarray(bfirst), np.ascontiguousarray(bcount),
        np.ascontiguousarray(bwidth), np.ascontiguousarray(boff),
        words, nbs, row_word_start, R, out)
    assert k == len(out)
    ends = np.cumsum(counts)
    return [out[e - c: e] for c, e in zip(counts, ends)]


def pack_many(rows: list[np.ndarray]):
    """Native batched pack; same per-row results as packed.pack_many."""
    from dgraph_tpu_torch.storage import packed

    lib = _load()
    R = len(rows)
    if lib is None or R == 0:
        return packed.pack_many(rows)
    lens = np.fromiter((len(r) for r in rows), dtype=np.int64, count=R)
    if not (lens > 0).any():
        return packed.pack_many(rows)
    nbs = -(-lens // packed.BLOCK)
    NB = int(nbs.sum())
    concat = np.concatenate(
        [np.ascontiguousarray(r, np.uint64) for r in rows if len(r)])
    row_block_start = np.zeros(R, np.int64)
    np.cumsum(nbs[:-1], out=row_block_start[1:])
    bfirst = np.empty(NB, np.uint64)
    blast = np.empty(NB, np.uint64)
    bcount = np.empty(NB, np.int32)
    bwidth = np.empty(NB, np.int32)
    boff = np.empty(NB, np.int64)
    words = np.empty(NB * 2 * packed.BLOCK, np.uint32)
    row_word_start = np.empty(R, np.int64)
    total = lib.dgt_pack_many(concat, lens, row_block_start, R, bfirst, blast,
                              bcount, bwidth, boff, words, row_word_start)
    words = words[:total].copy()
    out = []
    for r in range(R):
        n = int(lens[r])
        if n == 0:
            out.append(packed.pack(np.zeros(0, np.uint64)))
            continue
        b0, b1 = int(row_block_start[r]), int(row_block_start[r] + nbs[r])
        w0 = int(row_word_start[r])
        w1 = int(row_word_start[r + 1]) if r + 1 < R else total
        out.append(packed.PackedUidList(
            n, bfirst[b0:b1], blast[b0:b1], bcount[b0:b1], bwidth[b0:b1],
            boff[b0:b1], words[w0:w1]))
    return out
