"""Durable posting store: in-memory map + append-only WAL + packed snapshots.

Copy of dgraph_tpu/storage/store.py for the PyTorch port. Its eager
DGTS3 load reads each tablet's row bounds as Python ints once per section,
not per row; the loaded lists are the same as the JAX store's.

Replaces the reference's embedded badger LSM (vendor/github.com/dgraph-io/
badger) for the posting space. The reference relies on badger's managed MVCC
transactions (NewTransactionAt/CommitAt) plus an LRU of decoded lists
(posting/lists.go lcache); here MVCC lives in PostingList layers
(storage/postings.py) and durability comes from:

  - WAL: every buffered mutation / commit / abort / schema change is appended
    as a length-prefixed JSON record and fsync'd on commit; replayed on open
    (analog of badger's value log + the Raft WAL replay path,
    worker/draft.go:738 InitAndStartNode).
  - Snapshot: `checkpoint()` rolls lists up to a watermark ts and writes a
    binary segment file of packed lists; on open the snapshot is loaded and
    the WAL tail replayed (analog of Raft snapshot + log truncation,
    worker/draft.go:636-705).

Keys are storage/keys.py encoded bytes; a per-(kind, attr) registry gives O(1)
tablet scans (a predicate's keys are a contiguous range in the reference,
x/keys.go; here they're an explicit set).
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import io
import json
import os
import struct
import threading

import numpy as np

from dgraph_tpu_torch.storage import keys as K
from dgraph_tpu_torch.storage import packed
from dgraph_tpu_torch.storage.postings import Op, Posting, PostingList
from dgraph_tpu_torch.utils.schema import SchemaEntry, SchemaState, parse_schema
from dgraph_tpu_torch.utils.sync import SafeLock
from dgraph_tpu_torch.utils.types import TypeID, Val, marshal, unmarshal

_U32 = struct.Struct("<I")


# -- posting (de)serialization ----------------------------------------------

def _val_to_json(v: Val | None):
    if v is None:
        return None
    return {"t": int(v.tid), "b": base64.b64encode(marshal(v)).decode("ascii")}


def _val_from_json(j) -> Val | None:
    if j is None:
        return None
    return unmarshal(TypeID(j["t"]), base64.b64decode(j["b"]))


def posting_to_json(p: Posting) -> dict:
    d: dict = {"u": p.uid, "o": int(p.op)}
    if p.value is not None:
        d["v"] = _val_to_json(p.value)
    if p.lang:
        d["l"] = p.lang
    if p.facets:
        d["f"] = [[n, _val_to_json(v)] for n, v in p.facets]
    return d


def posting_from_json(d: dict) -> Posting:
    return Posting(
        uid=d["u"],
        op=Op(d["o"]),
        value=_val_from_json(d.get("v")),
        lang=d.get("l", ""),
        facets=tuple((n, _val_from_json(v)) for n, v in d.get("f", [])),
    )


# -- binary WAL record codec -------------------------------------------------
# The hot record types (mutation / commit / abort — ~all of a load's volume)
# encode as packed structs; rare types (schema, drops) stay JSON. The first
# byte discriminates: '{' (0x7b) = JSON, else the binary tag. Old JSON WALs
# replay unchanged. Decoded records carry RAW key bytes and Posting objects
# ("fast form"); _apply_record_locked accepts both forms. This is also the
# replication wire format — followers decode the same bytes.
#
# VERSIONING: tags 0x01-0x03 denote EXACTLY this layout (u32 key lengths,
# u16 lang/facet lengths). Any future layout change must claim NEW tag
# bytes — the tag byte is the format version, like the snapshot header
# (DGTS1/DGTS2/DGTS3 below; the writer emits DGTS3, all three still load).

_REC_M, _REC_C, _REC_A, _REC_GC = 0x01, 0x02, 0x03, 0x04
_Q = struct.Struct("<q")
_HDR_M = struct.Struct("<q I")        # start_ts, key len
_HDR_C = struct.Struct("<q q I")      # start_ts, commit_ts, n keys
_HDR_A = struct.Struct("<q I")        # start_ts, n keys
# group commit: one record = one window's commit decisions,
# appended and fsynced as ONE WAL write. Layout: tag, u32 member count,
# then per member exactly the _REC_C payload (_HDR_C + length-prefixed
# keys). Replays identically to N _REC_C records; pre-16 WALs (per-commit
# records) still load — tags discriminate.
_HDR_GC = struct.Struct("<I")         # n member commits


@dataclasses.dataclass
class TabletPacked:
    """One tablet's packed columns as contiguous slices of the snapshot's
    shared buffers (DGTS2 is key-sorted, so a tablet is one run). `pure`
    means no row carried base_postings at load; any later write drops the
    whole entry, so a surviving entry implies layer-free lists too."""

    n: int
    counts: np.ndarray            # int64[n]
    nbs: np.ndarray               # int64[n] blocks per row
    row_word_start: np.ndarray    # int64[n] word base per row (tablet-rel)
    bfirst: np.ndarray
    bcount: np.ndarray
    bwidth: np.ndarray
    boff: np.ndarray
    words: np.ndarray
    pure: bool
    max_base_ts: int              # reads below this must raise (isolation)


@dataclasses.dataclass
class SegmentRun:
    """One tablet's rows in the mmap'd snapshot (paged mode): everything a
    PostingList needs, as FILE-BACKED views the OS pages in and out. The
    badger-LSM role (SURVEY §2.1): datasets larger than host RAM, served
    through lazy per-key materialization + eviction of clean lists."""

    n: int
    uid_keyed: bool                # DATA/REVERSE: fixed-len keys ending in
    # a big-endian uid (enables the vectorized find index)
    keys_blob: "np.ndarray"        # uint8 view of this run's key bytes
    kends: "np.ndarray"            # int64[n] key end offsets (run-relative)
    base_ts: "np.ndarray"
    counts: "np.ndarray"
    nbs: "np.ndarray"              # blocks per row
    bstarts: "np.ndarray"          # int64[n+1] block offsets (run-relative)
    wstarts: "np.ndarray"          # int64[n+1] word offsets (run-relative)
    pstarts: "np.ndarray"          # int64[n+1] postings-json offsets
    bfirst: "np.ndarray"
    blast: "np.ndarray"
    bcount: "np.ndarray"
    bwidth: "np.ndarray"
    boff: "np.ndarray"
    words: "np.ndarray"
    post_blob: "np.ndarray"        # uint8 view

    def key_at(self, i: int) -> bytes:
        k0 = int(self.kends[i - 1]) if i else 0
        return bytes(self.keys_blob[k0: int(self.kends[i])])

    def _uid_index(self):
        """For fixed-length uid-keyed runs (DATA/REVERSE): the sorted
        big-endian uid column, built lazily ONCE — find() becomes one
        numpy searchsorted instead of ~log2(n) Python byte compares."""
        idx = getattr(self, "_uids", None)
        if idx is None:
            L = int(self.kends[0])
            if not self.uid_keyed or self.n * L != int(self.kends[-1]):
                self._uids = False        # variable-length keys (index)
            else:
                blob = np.ascontiguousarray(
                    np.asarray(self.keys_blob).reshape(self.n, L)[:, -8:])
                self._uids = blob.view(">u8").ravel().astype(np.uint64)
            idx = self._uids
        return idx

    def find(self, kb: bytes) -> int:
        """Binary search (keys are sorted); -1 = absent."""
        uids = self._uid_index()
        if uids is not False:
            u = np.uint64(int.from_bytes(kb[-8:], "big"))
            i = int(np.searchsorted(uids, u))
            return i if i < self.n and uids[i] == u else -1
        lo, hi = 0, self.n - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            k = self.key_at(mid)
            if k == kb:
                return mid
            if k < kb:
                lo = mid + 1
            else:
                hi = mid - 1
        return -1

    def iter_keys(self):
        for i in range(self.n):
            yield self.key_at(i)

    def build_list(self, i: int) -> PostingList:
        b0, b1 = int(self.bstarts[i]), int(self.bstarts[i + 1])
        w0, w1 = int(self.wstarts[i]), int(self.wstarts[i + 1])
        p0, p1 = int(self.pstarts[i]), int(self.pstarts[i + 1])
        pl = PostingList()
        pl.base_ts = int(self.base_ts[i])
        pl.base_packed = packed.PackedUidList(
            int(self.counts[i]), self.bfirst[b0:b1], self.blast[b0:b1],
            self.bcount[b0:b1], self.bwidth[b0:b1], self.boff[b0:b1],
            self.words[w0:w1])
        if p1 > p0:
            pl.base_postings = {
                p.uid: p for p in map(
                    posting_from_json,
                    json.loads(bytes(self.post_blob[p0:p1])))}
        pl._seg_ts = pl.base_ts      # eviction safety marker
        return pl


class LazyLists(dict):
    """store.lists in paged mode: a plain dict of materialized lists whose
    misses fall through to the snapshot segments. Mutation paths write
    through normal dict assignment; eviction drops CLEAN entries (the
    segment row can reproduce them exactly)."""

    def __init__(self, store: "Store") -> None:
        super().__init__()
        self._store = store

    def get(self, kb, default=None):
        pl = super().get(kb)
        if pl is None:
            pl = self._store._materialize(kb)
        return pl if pl is not None else default

    def __getitem__(self, kb):
        pl = self.get(kb)
        if pl is None:
            raise KeyError(kb)
        return pl

    def __contains__(self, kb) -> bool:
        return super().__contains__(kb) or \
            self._store._segment_find(kb) is not None


def _key_bytes(k) -> bytes:
    return k if isinstance(k, (bytes, bytearray)) else base64.b64decode(k)


def _enc_val(out: list, v: Val) -> None:
    b = marshal(v)
    out.append(struct.pack("<B I", int(v.tid), len(b)))
    out.append(b)


def _dec_val(raw: bytes, off: int) -> tuple[Val, int]:
    tid, blen = struct.unpack_from("<B I", raw, off)
    off += 5
    return unmarshal(TypeID(tid), raw[off: off + blen]), off + blen


def encode_record(rec: dict) -> bytes:
    """Record dict -> wire/WAL bytes (binary for m/c/a, JSON otherwise)."""
    t = rec["t"]
    if t == "m":
        kb = _key_bytes(rec["k"])
        p = rec["p"]
        if not isinstance(p, Posting):
            p = posting_from_json(p)
        out = [bytes([_REC_M]), _HDR_M.pack(rec["s"], len(kb)), kb]
        flags = ((1 if p.value is not None else 0)
                 | (2 if p.lang else 0) | (4 if p.facets else 0))
        out.append(struct.pack("<Q B B", p.uid, int(p.op), flags))
        if p.value is not None:
            _enc_val(out, p.value)
        if p.lang:
            lb = p.lang.encode()
            out.append(struct.pack("<H", len(lb)) + lb)
        if p.facets:
            out.append(struct.pack("<H", len(p.facets)))
            for name, fv in p.facets:
                nb = name.encode()
                out.append(struct.pack("<H", len(nb)) + nb)
                _enc_val(out, fv)
        return b"".join(out)
    if t in ("c", "a"):
        keys = [_key_bytes(k) for k in rec["k"]]
        if t == "c":
            out = [bytes([_REC_C]), _HDR_C.pack(rec["s"], rec["ts"], len(keys))]
        else:
            out = [bytes([_REC_A]), _HDR_A.pack(rec["s"], len(keys))]
        for kb in keys:
            out.append(struct.pack("<I", len(kb)))
            out.append(kb)
        return b"".join(out)
    if t == "gc":
        out = [bytes([_REC_GC]), _HDR_GC.pack(len(rec["txns"]))]
        for sub in rec["txns"]:
            keys = [_key_bytes(k) for k in sub["k"]]
            out.append(_HDR_C.pack(sub["s"], sub["ts"], len(keys)))
            for kb in keys:
                out.append(struct.pack("<I", len(kb)))
                out.append(kb)
        return b"".join(out)
    return json.dumps(rec, separators=(",", ":")).encode("utf-8")


def decode_record(raw: bytes) -> dict:
    """Wire/WAL bytes -> record dict (fast form for binary records)."""
    tag = raw[0]
    if tag == 0x7B:                     # '{' — JSON record
        return json.loads(raw)
    off = 1
    if tag == _REC_M:
        s, klen = _HDR_M.unpack_from(raw, off)
        off += _HDR_M.size
        kb = raw[off: off + klen]
        off += klen
        uid, op, flags = struct.unpack_from("<Q B B", raw, off)
        off += 10
        value = lang = None
        facets = ()
        if flags & 1:
            value, off = _dec_val(raw, off)
        if flags & 2:
            (n,) = struct.unpack_from("<H", raw, off)
            lang = raw[off + 2: off + 2 + n].decode()
            off += 2 + n
        if flags & 4:
            (cnt,) = struct.unpack_from("<H", raw, off)
            off += 2
            fs = []
            for _ in range(cnt):
                (n,) = struct.unpack_from("<H", raw, off)
                name = raw[off + 2: off + 2 + n].decode()
                off += 2 + n
                fv, off = _dec_val(raw, off)
                fs.append((name, fv))
            facets = tuple(fs)
        return {"t": "m", "s": s, "k": kb,
                "p": Posting(uid, Op(op), value, lang or "", facets)}
    if tag == _REC_GC:
        (cnt,) = _HDR_GC.unpack_from(raw, off)
        off += _HDR_GC.size
        txns = []
        for _ in range(cnt):
            s, ts, n = _HDR_C.unpack_from(raw, off)
            off += _HDR_C.size
            keys = []
            for _ in range(n):
                (klen,) = struct.unpack_from("<I", raw, off)
                off += 4
                keys.append(raw[off: off + klen])
                off += klen
            # members are plain "c" records: replay/replication apply them
            # through the exact single-commit branch
            txns.append({"t": "c", "s": s, "k": keys, "ts": ts})
        return {"t": "gc", "txns": txns}
    if tag == _REC_C:
        s, ts, n = _HDR_C.unpack_from(raw, off)
        off += _HDR_C.size
    elif tag == _REC_A:
        s, n = _HDR_A.unpack_from(raw, off)
        ts = None
        off += _HDR_A.size
    else:
        raise ValueError(f"unknown WAL record tag {tag}")
    keys = []
    for _ in range(n):
        (klen,) = struct.unpack_from("<I", raw, off)
        off += 4
        keys.append(raw[off: off + klen])
        off += klen
    rec = {"t": "c" if tag == _REC_C else "a", "s": s, "k": keys}
    if ts is not None:
        rec["ts"] = ts
    return rec


class Store:
    """One group's posting store (the `pstore` of a server node)."""

    def __init__(self, dirpath: str | None = None,
                 memory_budget: int | None = None,
                 max_delta_keys: int | None = None) -> None:
        """memory_budget (bytes): enables PAGED mode — the snapshot is
        mmap'd, posting lists materialize lazily per key, and clean lists
        are evicted once the resident estimate exceeds the budget. The
        badger-LSM role: the dataset no longer has to fit in host RAM.

        max_delta_keys: per-attr delta-journal bound (--delta_journal_max_keys
        on the CLI); shadows the MAX_DELTA_KEYS class default. Size it to
        the working set a live subscriber may fall behind by — overflow
        forces affected subscriptions through a full resync."""
        self.dir = dirpath
        if max_delta_keys:
            self.MAX_DELTA_KEYS = int(max_delta_keys)
        self.paged = memory_budget is not None
        self.memory_budget = int(memory_budget or 0)
        self._segments: dict[tuple[int, str], SegmentRun] = {}
        self._touched: set[tuple[int, str]] = set()   # tablets with writes
        self._lazy_bytes = 0           # resident estimate (paged mode)
        self._evict_tick = 0
        self.lists: dict[bytes, PostingList] = \
            LazyLists(self) if self.paged else {}
        self.by_pred: dict[tuple[int, str], set[bytes]] = {}
        self.schema = SchemaState()
        self.dirty: set[bytes] = set()
        # lock-discipline asserts (utils/sync.py) + lockdep class name
        # (utils/locks.py) for runtime order verification in chaos runs
        self._lock = SafeLock("store.Store._lock")
        self._wal: io.BufferedWriter | None = None
        self.max_seen_commit_ts = 0
        # attr -> highest commit_ts of any commit touching it: the dirty
        # watermark incremental snapshot builds compare against (the
        # reference never rebuilds the world — posting/lists.go:243
        # read-through; here clean predicates reuse device arrays)
        self.pred_commit_ts: dict[str, int] = {}
        self.pred_replay_seq: dict[str, int] = {}   # below-watermark commits
        # per-predicate applied WaterMarks mirroring pred_commit_ts: the
        # replica-read gate (remote.serve_task min_applied) blocks on
        # wait_for_mark(timeout=) instead of a sleep/poll loop, so a
        # catching-up follower wakes the exact moment the commit applies
        self._applied_marks: dict[str, "WaterMark"] = {}
        # per-predicate delta journal: attr -> {key bytes: last commit_ts}
        # for every key committed since _delta_floor_for(attr). This is what
        # makes commit-to-visible O(Δ): the snapshot assembler stamps cached
        # device views with exactly these keys (storage/delta.py) instead of
        # re-folding the tablet. Bounded per attr; overflow resets the
        # completeness floor and the next full fold re-bases stamping.
        self._delta_log: dict[str, dict[bytes, int]] = {}
        self._delta_floor: dict[str, int] = {}
        self._delta_base_floor = 0   # commits at/below this live in bases
        # live-query retention: the oldest active subscription cursor pins
        # prune_delta so a reconnect-with-cursor stays provable; overflow
        # (the bound above still wins over the pin) notifies the live
        # manager which predicates lost completeness. The callback runs
        # INSIDE the commit critical section and must not take locks.
        self._delta_pin: int | None = None
        self._delta_overflows = 0
        self.on_delta_overflow = None
        # cold-open fold accelerator: per-(kind, attr) CONTIGUOUS packed
        # columns captured at snapshot load (the DGTS2 layout is already
        # tablet-ordered). While an entry survives — dropped on the first
        # write touching its tablet — the snapshot fold decodes the whole
        # tablet in ONE native call with zero per-list marshalling.
        self._packed_tablets: dict[tuple[int, str], "TabletPacked"] = {}
        self.snapshot_ts = 0  # commits at/below this are folded into bases
        # records currently in wal.log (an up-to-dateness signal for
        # elections; NOT the replication ship index — that is a per-term
        # session sequence, parallel/remote.py — because checkpoint
        # compaction rewrites this file)
        self.wal_record_count = 0
        if dirpath:
            os.makedirs(dirpath, exist_ok=True)
            self._load()
            self._wal = open(os.path.join(dirpath, "wal.log"), "ab")

    # -- basic access -------------------------------------------------------

    def get(self, key: K.Key) -> PostingList:
        kb = key.encode()
        with self._lock:
            pl = self.lists.get(kb)
            if pl is None:
                pl = PostingList()
                self.lists[kb] = pl
                self.by_pred.setdefault((int(key.kind), key.attr), set()).add(kb)
                self._drop_packed(int(key.kind), key.attr)
            return pl

    def _drop_packed(self, kind: int, attr: str) -> None:
        """Invalidate the cold-open fold cache for one tablet (any write
        breaks the contiguous-and-pure contract of TabletPacked — and the
        paged bulk fold's pristine-segment assumption)."""
        if self._packed_tablets:
            self._packed_tablets.pop((kind, attr), None)
        if self._segments:
            self._touched.add((kind, attr))

    def packed_tablet(self, kind: int, attr: str) -> TabletPacked | None:
        return self._packed_tablets.get((kind, attr))

    def _purge_cached(self, kind: int, attr: str) -> None:
        """Drop materialized segment-backed lists of a dropped tablet —
        they never entered by_pred, so the by_pred purge misses them."""
        if not self.paged:
            return
        for kb in [k for k in dict.keys(self.lists)
                   if K.kind_attr_of(k) == (kind, attr)]:
            pl = dict.pop(self.lists, kb, None)
            if pl is not None:
                self._lazy_bytes -= pl.approx_bytes()
        self._lazy_bytes = max(self._lazy_bytes, 0)

    # -- paged mode (segments + lazy lists + eviction) ----------------------

    def _segment_find(self, kb: bytes):
        if not self._segments:
            return None
        seg = self._segments.get(K.kind_attr_of(kb))
        if seg is None:
            return None
        i = seg.find(kb)
        return (seg, i) if i >= 0 else None

    def _materialize(self, kb: bytes, cache: bool = True):
        """Build a PostingList from its snapshot segment row; None when the
        key has no segment backing. Cached copies count toward the resident
        estimate and are evictable while clean."""
        hit = self._segment_find(kb)
        if hit is None:
            return None
        seg, i = hit
        pl = seg.build_list(i)
        tick = False
        if cache:
            with self._lock:
                # re-check under the lock immediately before inserting: a
                # writer (Store.get + add_mutation) may have installed —
                # and dirtied — a list for this key while we built our
                # pristine copy from the segment. Clobbering theirs would
                # make a committed write invisible until WAL replay;
                # return the existing object instead.
                existing = dict.get(self.lists, kb)
                if existing is not None:
                    return existing
                dict.__setitem__(self.lists, kb, pl)
                self._lazy_bytes += pl.approx_bytes()
                self._evict_tick += 1
                if self._evict_tick >= 512:
                    self._evict_tick = 0
                    tick = True
        if tick:
            self._evict_clean()
        return pl

    def _evict_clean(self) -> None:
        """Drop clean segment-backed lists until under budget. Clean =
        reproducible from the segment row bit-for-bit: no layers, no
        uncommitted txns, base untouched since materialization, not dirty.
        Readers holding a reference keep a valid object (drop only unlinks
        from the map — the read-through contract of posting/lists.go)."""
        if self.memory_budget <= 0 or self._lazy_bytes <= self.memory_budget:
            return
        import sys

        target = int(self.memory_budget * 0.8)
        for kb, pl in list(self.lists.items()):
            if self._lazy_bytes <= target:
                break
            if (getattr(pl, "_seg_ts", None) == pl.base_ts
                    and not pl.layers and not pl.uncommitted
                    and kb not in self.dirty):
                # a writer may hold this object between Store.get and its
                # add_mutation: external references (> the 4 we create:
                # dict slot, items() snapshot, loop var, getrefcount arg)
                # mean in-flight use — skip
                if sys.getrefcount(pl) > 4:
                    continue
                dict.pop(self.lists, kb, None)
                if pl.layers or pl.uncommitted or kb in self.dirty:
                    # lost the race after all: reinstate, never drop a write
                    dict.__setitem__(self.lists, kb, pl)
                    continue
                self._lazy_bytes -= pl.approx_bytes()
        self._lazy_bytes = max(self._lazy_bytes, 0)

    def segment_max_uid(self, uid_typed_fn, slot_bits: int) -> int:
        """Max uid across segment-backed rows without materializing them
        (paged-mode uid-lease recovery): subject uids from each run's last
        key, object uids from packed block_last metadata. Rows whose
        metadata is slot-tagged (>= slot_bits: value postings) decode
        transiently — the max REAL uid hides below the slots."""
        m = 0
        for (kind, attr), seg in self._segments.items():
            if kind not in (int(K.KeyKind.DATA), int(K.KeyKind.REVERSE)) \
                    or seg.n == 0:
                continue
            m = max(m, K.uid_of(seg.key_at(seg.n - 1)))
            if kind != int(K.KeyKind.DATA) or not uid_typed_fn(attr):
                continue
            bl = np.asarray(seg.blast)
            if len(bl) == 0:
                continue
            mx = int(bl.max())
            if mx < slot_bits:
                m = max(m, mx)
                continue
            # per-row last-block max (vectorized): decode ONLY slot-tagged
            # rows — one tagged list must not force an O(edges) scan
            nz = np.flatnonzero(np.asarray(seg.nbs) > 0)
            row_last = bl[np.asarray(seg.bstarts)[nz + 1] - 1]
            clean = row_last < slot_bits
            if clean.any():
                m = max(m, int(row_last[clean].max()))
            for i in nz[~clean].tolist():   # tagged rows: transient decode
                pl = seg.build_list(i)
                u = pl.uids(max(self.max_seen_commit_ts, pl.base_ts))
                real = u[u < slot_bits]
                if len(real):
                    m = max(m, int(real[-1]))
        return m

    def tablet_lists(self, kind: int, attr: str,
                     kbs: list[bytes]) -> list:
        """PostingLists for a whole tablet scan (fold paths). Paged mode
        with no post-snapshot writes on the tablet serves the segment rows
        IN ORDER — transient objects, no per-key search, no cache churn;
        any other shape falls back to per-key lookup."""
        seg = self._segments.get((kind, attr))
        if (seg is not None and seg.n == len(kbs)
                and (kind, attr) not in self._touched
                and not self.by_pred.get((kind, attr))):
            return [seg.build_list(i) for i in range(seg.n)]
        return [self.lists.get(kb) for kb in kbs]

    def get_no_store(self, key: K.Key) -> PostingList | None:
        """Read-only peek (reference posting/lists.go GetNoStore :274)."""
        return self.lists.get(key.encode())

    def keys_of(self, kind: K.KeyKind, attr: str) -> list[bytes]:
        """All keys of one (kind, predicate) — a tablet scan. Paged mode
        merges the snapshot segment's keys (not resident in by_pred) with
        keys created by later writes."""
        with self._lock:
            extra = self.by_pred.get((int(kind), attr), ())
            seg = self._segments.get((int(kind), attr))
            if seg is None:
                return sorted(extra)
            if not extra:
                return list(seg.iter_keys())   # already sorted
            return sorted(set(seg.iter_keys()) | set(extra))

    def memory_stats(self) -> dict:
        """Approximate host memory held by posting lists (the accounting
        behind the --memory_mb budget; posting/lists.go:123-180)."""
        total = 0
        layers = 0
        with self._lock:
            pls = list(self.lists.values())
        for pl in pls:
            total += pl.approx_bytes()
            layers += pl.layer_count()
        out = {"bytes": total, "lists": len(pls), "layers": layers}
        if self.paged:
            out["paged"] = True
            out["segment_keys"] = sum(s.n for s in self._segments.values())
        return out

    def predicates(self) -> list[str]:
        with self._lock:
            out = {attr for (kind, attr) in self.by_pred
                   if kind == int(K.KeyKind.DATA)}
            out |= {attr for (kind, attr) in self._segments
                    if kind == int(K.KeyKind.DATA)}
            return sorted(out)

    def tablet_sizes(self) -> dict[str, int]:
        """Approximate bytes served per predicate, across every key space it
        owns (the size reports a group streams to Zero for rebalancing —
        worker/groups.go:454-549 periodicMembershipUpdate)."""
        out: dict[str, int] = {}
        with self._lock:
            items = [(attr, list(keys))
                     for (_kind, attr), keys in self.by_pred.items()]
        for attr, keys in items:
            n = out.get(attr, 0)
            for kb in keys:
                pl = self.lists.get(kb)
                if pl is not None:
                    n += 64 + pl.approx_bytes()
            out[attr] = n
        return out

    # -- write path ---------------------------------------------------------

    def add_mutation(self, start_ts: int, key: K.Key, p: Posting) -> None:
        self._wal_write({"t": "m", "s": start_ts, "k": key.encode(), "p": p})
        self._drop_packed(int(key.kind), key.attr)
        self.get(key).add_mutation(start_ts, p)
        self.dirty.add(key.encode())

    def commit(self, start_ts: int, commit_ts: int, key_bytes: list[bytes]) -> None:
        self._wal_write({"t": "c", "s": start_ts, "ts": commit_ts,
                         "k": list(key_bytes)}, sync=True)
        with self._lock:
            for kb in key_bytes:
                pl = self.lists.get(kb)
                if pl is not None:
                    pl.commit(start_ts, commit_ts)
                self._bump_pred_ts(kb, commit_ts)
            self.max_seen_commit_ts = max(self.max_seen_commit_ts, commit_ts)

    def commit_group(self, members: list[tuple[int, int, list[bytes]]]) -> None:
        """One commit window's durability + visibility (group
        commit): members is [(start_ts, commit_ts, key_bytes), ...] already
        decided conflict-free by the oracle. The whole window appends as
        ONE contiguous WAL record with ONE fsync (and one wal_sink ship),
        then every member's in-memory apply — pl.commit + _bump_pred_ts
        watermark/journal advance — runs under ONE store-lock hold, so the
        delta journal accumulates the window's UNION delta per predicate
        and the next read stamps each touched predicate once. A crash
        mid-append leaves a torn tail replay drops whole: the window is
        all-or-nothing in the log, never torn across members."""
        self._wal_write(
            {"t": "gc", "txns": [{"s": s, "ts": ts, "k": list(kbs)}
                                 for s, ts, kbs in members]}, sync=True)
        with self._lock:
            for start_ts, commit_ts, key_bytes in members:
                for kb in key_bytes:
                    pl = self.lists.get(kb)
                    if pl is not None:
                        pl.commit(start_ts, commit_ts)
                    self._bump_pred_ts(kb, commit_ts)
                self.max_seen_commit_ts = max(self.max_seen_commit_ts,
                                              commit_ts)

    MAX_DELTA_KEYS = 8192     # per-attr journal bound (bulk loads overflow
    # it on purpose: their next fold re-bases incremental stamping)

    def _bump_pred_ts(self, kb: bytes, commit_ts: int) -> None:
        self._lock.assert_held()   # caller owns the commit critical section
        attr = K.kind_attr_of(kb)[1]
        cur = self.pred_commit_ts.get(attr, 0)
        if commit_ts > cur:
            self.pred_commit_ts[attr] = commit_ts
            mark = self._applied_marks.get(attr)
            if mark is not None:
                # lock order store._lock -> mark cv is safe: waiters take
                # only the mark's cv, never the store lock
                mark.set_done_until(commit_ts)
        elif commit_ts < cur:
            # a commit arriving BELOW the watermark (replication replay /
            # out-of-order apply): max-only watermarks can't see it, so
            # cached snapshots key staleness on this counter too
            self.pred_replay_seq[attr] = self.pred_replay_seq.get(attr, 0) + 1
        log = self._delta_log.get(attr)
        if log is None:
            log = self._delta_log[attr] = {}
        if commit_ts > log.get(kb, 0):
            log[kb] = commit_ts
        if len(log) > self.MAX_DELTA_KEYS:
            log.clear()
            self._delta_floor[attr] = max(
                self.pred_commit_ts.get(attr, 0),
                self._delta_floor.get(attr, 0))
            self._delta_overflows += 1
            if self.metrics is not None:
                self.metrics.counter("dgraph_delta_journal_overflows").inc()
            cb = self.on_delta_overflow
            if cb is not None:   # lock-free by contract (see __init__)
                cb(attr)

    # -- delta journal (overlay stamping feed, storage/delta.py) ------------

    def _delta_floor_for(self, attr: str) -> int:
        return max(self._delta_base_floor, self._delta_floor.get(attr, 0))

    def delta_since(self, attr: str, base_ts: int) -> dict[bytes, int] | None:
        """Keys of attr committed after base_ts ({kb: commit_ts}), or None
        when the journal can't prove completeness above base_ts (overflow,
        bulk install, pre-journal snapshot) — the caller must full-fold."""
        with self._lock:
            if self._delta_floor_for(attr) > base_ts:
                return None
            log = self._delta_log.get(attr)
            if not log:
                return {}
            return {kb: ts for kb, ts in log.items() if ts > base_ts}

    def prune_delta(self, attr: str, upto_ts: int) -> None:
        """A full fold at upto_ts subsumes journal entries at/below it.
        Clamped at the subscription pin: retained extra entries are
        harmless for stamping but keep reconnect cursors provable."""
        with self._lock:
            pin = self._delta_pin
            if pin is not None and upto_ts > pin:
                upto_ts = pin
            if upto_ts < self._delta_floor_for(attr):
                return
            log = self._delta_log.get(attr)
            if log:
                for kb in [kb for kb, ts in log.items() if ts <= upto_ts]:
                    del log[kb]
            self._delta_floor[attr] = max(
                self._delta_floor.get(attr, 0), upto_ts)

    def pin_delta_floor(self, ts: int | None) -> None:
        """Retention pin from the live manager: prune_delta will not erase
        journal entries above `ts` (None unpins). The per-attr bound still
        wins — a subscriber cannot make the journal unbounded, it can only
        be told (via on_delta_overflow) that its cursor became unprovable."""
        with self._lock:
            self._delta_pin = None if ts is None else int(ts)
            if self.metrics is not None:
                self.metrics.counter("dgraph_delta_journal_pinned_floor") \
                    .set(0 if ts is None else int(ts))

    def delta_log_stats(self) -> dict:
        with self._lock:
            keys = sum(len(v) for v in self._delta_log.values())
            if self.metrics is not None:
                self.metrics.counter("dgraph_delta_journal_keys").set(keys)
            return {"attrs": len(self._delta_log), "keys": keys,
                    "max_keys": self.MAX_DELTA_KEYS,
                    "overflows": self._delta_overflows,
                    "pinned_floor": self._delta_pin,
                    "base_floor": self._delta_base_floor}

    def delta_log_by_attr(self) -> dict[str, int]:
        """attr -> journal keys held. The per-tenant accounting input:
        tenant attrs are distinct storage attrs, so grouping these by
        namespace prefix attributes journal retention to its tenant."""
        with self._lock:
            return {attr: len(v) for attr, v in self._delta_log.items()}

    def applied_mark(self, attr: str):
        """The predicate's applied watermark (done_until mirrors
        pred_commit_ts[attr]); created lazily and advanced by every commit
        bump. Callers block via wait_for_mark(ts, timeout=) — the
        replica-read gate's wait primitive."""
        from ..utils.watermark import WaterMark

        with self._lock:
            mark = self._applied_marks.get(attr)
            if mark is None:
                mark = WaterMark(name=f"applied:{attr}")
                mark.set_done_until(self.pred_commit_ts.get(attr, 0))
                self._applied_marks[attr] = mark
            return mark

    def abort(self, start_ts: int, key_bytes: list[bytes]) -> None:
        self._wal_write({"t": "a", "s": start_ts, "k": list(key_bytes)})
        with self._lock:
            for kb in key_bytes:
                pl = self.lists.get(kb)
                if pl is not None:
                    pl.abort(start_ts)

    def set_schema(self, e: SchemaEntry) -> None:
        self._wal_write({"t": "s", "line": str(e)})
        self.schema.set(e)

    def delete_predicate(self, attr: str) -> None:
        """Drop every key of a predicate (reference posting/index.go:946
        DeletePredicate; used by predicate moves and drop operations)."""
        self._wal_write({"t": "dp", "attr": attr}, sync=True)
        self._delete_predicate_mem(attr)

    def drop_kind(self, attr: str, kind: K.KeyKind) -> None:
        """Drop all keys of one (kind, predicate) — WAL-logged so index
        rebuilds survive crash+replay without resurrecting stale postings."""
        self._wal_write({"t": "dk", "attr": attr, "kind": int(kind)}, sync=True)
        self._drop_kind_mem(attr, kind)

    def _reset_delta(self, attr: str) -> None:
        """Drops are structural: the journal can't express them — reset
        completeness so stamping waits for the next full fold."""
        self._delta_log.pop(attr, None)
        self._delta_floor[attr] = max(self._delta_floor.get(attr, 0),
                                      self.max_seen_commit_ts)

    def _drop_kind_mem(self, attr: str, kind: K.KeyKind) -> None:
        with self._lock:
            self._drop_packed(int(kind), attr)
            self._reset_delta(attr)
            self._segments.pop((int(kind), attr), None)
            for kb in self.by_pred.pop((int(kind), attr), set()):
                self.lists.pop(kb, None)
                self.dirty.discard(kb)
            self._purge_cached(int(kind), attr)

    def _delete_predicate_mem(self, attr: str) -> None:
        with self._lock:
            self._reset_delta(attr)
            for kind in list(K.KeyKind):
                self._drop_packed(int(kind), attr)
                self._segments.pop((int(kind), attr), None)
                for kb in self.by_pred.pop((int(kind), attr), set()):
                    self.lists.pop(kb, None)
                    self.dirty.discard(kb)
                self._purge_cached(int(kind), attr)
            self.schema.delete(attr)

    # -- bulk ingest ---------------------------------------------------------

    @contextlib.contextmanager
    def _sink_suspended(self):
        """Checkpoint's WAL-reset rewrites are LOCAL compaction — shipping
        them would append duplicates to follower logs while the leader
        truncates its own (followers keep full history instead)."""
        sink, self.wal_sink = self.wal_sink, None
        try:
            yield
        finally:
            self.wal_sink = sink

    def clone_to(self, dst_dir: str) -> None:
        """Copy this store's durable state (snapshot + WAL) to another dir,
        atomically vs concurrent writers (follower catch-up,
        worker/predicate_move.go populateShard / retrieveSnapshot)."""
        import shutil

        with self._lock:
            if self._wal is not None:
                self._wal.flush()
                os.fsync(self._wal.fileno())
            for name in ("snapshot.bin", "wal.log"):
                src = os.path.join(self.dir, name)
                dst = os.path.join(dst_dir, name)
                if os.path.exists(src):
                    shutil.copyfile(src, dst)
                elif os.path.exists(dst):
                    os.remove(dst)

    @contextlib.contextmanager
    def suspend_wal(self):
        """Run with the WAL off (bulk loads write packed bases directly and
        then checkpoint — reference bulk loader writes SSTs, not the Raft
        WAL, dgraph/cmd/bulk/reduce.go:36)."""
        wal, self._wal = self._wal, None
        try:
            yield self
        finally:
            self._wal = wal

    def bulk_install(self, lists: dict[bytes, "PostingList"],
                     commit_ts: int) -> None:
        """Register fully-built posting lists (packed bases at commit_ts).

        The caller is expected to run under suspend_wal() and checkpoint()
        afterwards so durability comes from the snapshot, not per-posting
        WAL records."""
        with self._lock:
            self._packed_tablets.clear()   # direct installs bypass get()
            for kb, pl in lists.items():
                kind, attr = K.kind_attr_of(kb)
                self.lists[kb] = pl
                self.by_pred.setdefault((kind, attr), set()).add(kb)
                if commit_ts > self.pred_commit_ts.get(attr, 0):
                    self.pred_commit_ts[attr] = commit_ts
                    mark = self._applied_marks.get(attr)
                    if mark is not None:
                        mark.set_done_until(commit_ts)
                # installs bypass the delta journal: stamping resumes after
                # the next full fold re-bases these tablets
                self._delta_floor[attr] = max(
                    self._delta_floor.get(attr, 0), commit_ts)
            self.max_seen_commit_ts = max(self.max_seen_commit_ts, commit_ts)

    # -- WAL ----------------------------------------------------------------

    # Replication hook: when set, every WAL record is offered to the sink
    # BEFORE the local append (a record must reach the quorum before the
    # leader treats it as durable — worker/draft.go proposeAndWait waits for
    # the Raft commit the same way). The sink raising aborts the local write.
    wal_sink = None

    def _wal_write(self, rec: dict, sync: bool = False) -> None:
        if self._wal is None and self.wal_sink is None:
            return    # in-memory, unreplicated: records have nowhere to go
        from ..utils import faults

        # disk fault seam: a failing/slow WAL write surfaces BEFORE the
        # in-memory apply, the same ordering a real fsync failure has
        faults.fire("disk.wal_write", m=getattr(self, "metrics", None))
        data = encode_record(rec)
        with self._lock:
            # ship under the same lock as the local append so followers see
            # records in exactly the leader's log order (replication is
            # independent of local durability: an in-memory leader still
            # ships — its quorum of follower fsyncs IS the durability)
            if self.wal_sink is not None:
                self.wal_sink(data, sync)
            if self._wal is not None:
                self._wal.write(_U32.pack(len(data)) + data)
                self.wal_record_count += 1
                if sync:
                    # the durability seam itself (sync writes only): a
                    # delay fault here emulates the fsync cost class of
                    # durable disks (bench_write's sync sweep) — it
                    # sleeps under the lock exactly as a real fsync
                    # serializes writers
                    faults.fire("disk.fsync",
                                m=getattr(self, "metrics", None))
                    self._wal.flush()
                    os.fsync(self._wal.fileno())

    def _replay_wal(self, path: str) -> None:
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            raw = f.read()
        off = 0
        with self._lock:       # one lock hold for the whole replay
            while off + 4 <= len(raw):
                (n,) = _U32.unpack_from(raw, off)
                off += 4
                if off + n > len(raw):
                    break  # torn tail write — ignore (crash mid-append)
                self._apply_record_locked(decode_record(raw[off: off + n]))
                off += n
                self.wal_record_count += 1

    def ingest_record(self, rec: dict, sync: bool = False) -> None:
        """Write-and-apply one record through the normal WAL path — the
        receiving side of a predicate move (worker/predicate_move.go:187
        batches received KVs into proposals; here the records ARE proposals,
        so a replicated leader ships them to its quorum automatically)."""
        self._wal_write(rec, sync=sync)
        self.apply_record(rec)

    def append_replica_record(self, data: bytes, sync: bool = True,
                              rec: dict | None = None) -> None:
        """Follower-side replication apply: one shipped WAL record becomes
        durable in this replica's own log AND live in memory, atomically
        under the store lock (the worker/draft.go:485-624 store-then-apply
        order, collapsed because the record is already quorum-ordered by
        the leader). Pass `rec` when the caller already parsed the bytes
        (the replication hot path parses once)."""
        with self._lock:
            if self._wal is not None:
                self._wal.write(_U32.pack(len(data)) + data)
                if sync:
                    self._wal.flush()
                    os.fsync(self._wal.fileno())
            self._apply_record_locked(rec if rec is not None
                                      else decode_record(data))
            self.wal_record_count += 1

    def apply_record(self, rec: dict) -> None:
        """Apply one WAL record to in-memory state — replay on restart, and
        the follower-side live apply when records arrive over replication
        (worker/draft.go:485-624 applies committed entries the same way)."""
        with self._lock:
            self._apply_record_locked(rec)

    def _apply_record_locked(self, rec: dict) -> None:
        t = rec["t"]
        if t == "m":
            kb = _key_bytes(rec["k"])
            # unconditional: _drop_packed also records the tablet in
            # _touched (paged mode). Gating it on a non-empty
            # _packed_tablets skipped that side effect after checkpoint()
            # cleared the packed cache, so tablet_lists() kept serving
            # pristine segment rows that omit this applied mutation
            # (stale reads on WAL replay / follower ship-apply /
            # predicate-move ingest).
            self._drop_packed(*K.kind_attr_of(kb))
            pl = self.lists.get(kb)
            if pl is None:      # full parse only on first sight of the key
                key = K.parse_key(kb)
                pl = PostingList()
                self.lists[kb] = pl
                self.by_pred.setdefault(
                    (int(key.kind), key.attr), set()).add(kb)
            p = rec["p"]
            pl.add_mutation(
                rec["s"], p if isinstance(p, Posting) else posting_from_json(p))
            self.dirty.add(kb)
        elif t == "c":
            for kraw in rec["k"]:
                kb = _key_bytes(kraw)
                self._bump_pred_ts(kb, rec["ts"])
                pl = self.lists.get(kb)
                if pl is None:
                    continue
                if rec["ts"] <= self.snapshot_ts:
                    # already folded into the snapshot base (crash between
                    # snapshot replace and WAL truncation): replaying would
                    # double-apply — notably DEL_ALL — on the rolled-up base
                    pl.abort(rec["s"])
                else:
                    pl.commit(rec["s"], rec["ts"])
            self.max_seen_commit_ts = max(self.max_seen_commit_ts, rec["ts"])
        elif t == "gc":
            # a group record IS its member commits: each applies through
            # the exact "c" branch above (including the ts <= snapshot_ts
            # already-folded abort rule, per member)
            for sub in rec["txns"]:
                self._apply_record_locked(
                    {"t": "c", "s": sub["s"], "k": sub["k"],
                     "ts": sub["ts"]})
        elif t == "a":
            for kraw in rec["k"]:
                pl = self.lists.get(_key_bytes(kraw))
                if pl is not None:
                    pl.abort(rec["s"])
        elif t == "s":
            for e in parse_schema(rec["line"]):
                self.schema.set(e)
        elif t == "dp":
            self._delete_predicate_mem(rec["attr"])
        elif t == "dk":
            self._drop_kind_mem(rec["attr"], K.KeyKind(rec["kind"]))

    # -- snapshot / checkpoint ---------------------------------------------

    def checkpoint(self, upto_ts: int) -> None:
        """Roll lists up to upto_ts, STREAM a snapshot tablet-by-tablet,
        truncate the WAL.

        The write is external-memory (ingest/snapwrite.py DGTS3): pristine
        mmap'd tablets copy file-to-file with zero per-row work, touched
        tablets merge resident lists over their segment rows, and rows of
        purely-resident tablets stream one at a time — peak transient
        memory is the writer's spool ceiling, independent of key count
        (the v2 writer materialized a PostingList per row and held every
        column in RAM, making a 100M-key checkpoint a memory event).

        Uncommitted txns and layers above upto_ts survive via the fresh WAL.
        (Reference: worker/draft.go snapshot at min pending-txn ts.)
        """
        from dgraph_tpu_torch.ingest.snapwrite import SnapshotWriter

        self._packed_tablets.clear()   # rollup replaces packed bases
        if self.dir is None:
            for pl in list(self.lists.values()):
                pl.rollup(upto_ts)
            self.snapshot_ts = max(self.snapshot_ts, upto_ts)
            return
        with self._lock, self._sink_suspended():
            self.snapshot_ts = max(self.snapshot_ts, upto_ts)
            snap_path = os.path.join(self.dir, "snapshot.bin.tmp")
            with open(snap_path, "wb") as f:
                w = SnapshotWriter(f, upto_ts, spool_max=self.SNAP_SPOOL_MAX)
                self._write_sections(w, upto_ts)
                w.finish({"schema": self.schema.to_text(),
                          "max_commit_ts": self.max_seen_commit_ts})
            self.last_checkpoint_stats = {
                "rows": w.rows,
                "peak_transient_bytes": w.peak_transient}
            if self.metrics is not None:
                self.metrics.counter(
                    "dgraph_checkpoint_peak_transient_bytes").set(
                        w.peak_transient)
            os.replace(snap_path, os.path.join(self.dir, "snapshot.bin"))
            # reset WAL with still-relevant records (uncommitted + layers > upto_ts)
            if self._wal is not None:
                self._wal.close()
            wal_path = os.path.join(self.dir, "wal.log")
            self._wal = open(wal_path + ".tmp", "ab")
            self.wal_record_count = 0   # re-counted by the rewrites below
            for kb in sorted(self.lists):
                pl = self.lists[kb]
                for sts, layer in pl.uncommitted.items():
                    if layer.del_all:
                        self._wal_write({"t": "m", "s": sts, "k": kb,
                                         "p": Posting(0, Op.DEL_ALL)})
                    for p in layer.postings.values():
                        self._wal_write({"t": "m", "s": sts, "k": kb, "p": p})
                for layer in pl.layers:
                    fake_start = -layer.commit_ts  # synthetic txn id for replay
                    recs = list(layer.postings.values())
                    if layer.del_all:
                        recs = [Posting(0, Op.DEL_ALL)] + recs
                    for p in recs:
                        self._wal_write({"t": "m", "s": fake_start, "k": kb,
                                         "p": p})
                    self._wal_write({"t": "c", "s": fake_start,
                                     "ts": layer.commit_ts, "k": [kb]})
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._wal.close()
            os.replace(wal_path + ".tmp", wal_path)
            self._wal = open(wal_path, "ab")
            self.dirty.clear()

    # spool ceiling per section column before the writer rolls to disk
    # (class attr so tests can shrink it to prove bounded transients)
    SNAP_SPOOL_MAX = 1 << 22
    metrics = None                  # optional utils/metrics.Registry
    last_checkpoint_stats: dict = {}

    def _write_sections(self, w, upto_ts: int) -> None:
        """Feed the DGTS3 writer one tablet at a time.

        Three shapes, cheapest first:
          - pristine segment tablet (paged, untouched since load): attach
            the mmap'd run wholesale — file-to-file column copy;
          - touched segment tablet: two-pointer merge of the (sorted)
            resident keys over the (sorted) segment rows; resident lists
            shadow their row, untouched rows copy as metadata VIEWS —
            no PostingList is ever built for them;
          - memory-only tablet: stream the resident lists in key order.
        """
        self._lock.assert_held()
        resident: dict[tuple[int, str], list[bytes]] = {}
        for kb in dict.keys(self.lists):
            resident.setdefault(K.kind_attr_of(kb), []).append(kb)
        for t in set(resident) | set(self._segments):
            seg = self._segments.get(t)
            res = sorted(resident.get(t, ()))
            if seg is not None and not res and t not in self._touched \
                    and not self.by_pred.get(t):
                w.add_run(t[0], t[1], seg)
                continue
            sec = w.section(t[0], t[1])
            si, seg_n = 0, (seg.n if seg is not None else 0)
            for kb in res:
                while si < seg_n and seg.key_at(si) < kb:
                    self._emit_segment_row(sec, seg, si)
                    si += 1
                if si < seg_n and seg.key_at(si) == kb:
                    si += 1          # the resident copy shadows its row
                self._emit_resident_row(sec, kb, upto_ts)
            while si < seg_n:
                self._emit_segment_row(sec, seg, si)
                si += 1

    @staticmethod
    def _emit_segment_row(sec, seg: "SegmentRun", i: int) -> None:
        """Copy one pristine row segment->section as column slices (the
        packed list is a bundle of views into the mmap, never decoded)."""
        b0, b1 = int(seg.bstarts[i]), int(seg.bstarts[i + 1])
        w0, w1 = int(seg.wstarts[i]), int(seg.wstarts[i + 1])
        p0, p1 = int(seg.pstarts[i]), int(seg.pstarts[i + 1])
        pu = packed.PackedUidList(
            int(seg.counts[i]), seg.bfirst[b0:b1], seg.blast[b0:b1],
            seg.bcount[b0:b1], seg.bwidth[b0:b1], seg.boff[b0:b1],
            seg.words[w0:w1])
        sec.add_row(seg.key_at(i), int(seg.base_ts[i]), pu,
                    bytes(seg.post_blob[p0:p1]))

    def _emit_resident_row(self, sec, kb: bytes, upto_ts: int) -> None:
        pl = dict.get(self.lists, kb)
        had_fold = any(l.commit_ts <= upto_ts for l in pl.layers)
        pl.rollup(upto_ts)
        if not had_fold and hasattr(pl, "_seg_ts"):
            # content unchanged (only the watermark moved): keep the
            # list evictable, or the first checkpoint would pin every
            # resident list for the life of the process
            pl._seg_ts = pl.base_ts
        post = b"" if not pl.base_postings else json.dumps(
            [posting_to_json(p) for p in pl.base_postings.values()]).encode()
        sec.add_row(kb, int(pl.base_ts), pl.base_packed, post)

    def _load(self) -> None:
        snap = os.path.join(self.dir, "snapshot.bin")
        if os.path.exists(snap):
            if self.paged and os.path.getsize(snap) > 5:
                # mmap: columns become file-backed views the OS pages in
                # and out — the dataset no longer has to fit in RAM
                raw = np.memmap(snap, dtype=np.uint8, mode="r")
                magic = bytes(raw[:5])
                if magic == b"DGTS3":
                    self._load_v3(raw)
                elif magic == b"DGTS2":
                    self._load_v2(raw)
                else:
                    self._load_v1(bytes(raw))     # legacy format: eager
            else:
                with open(snap, "rb") as f:
                    raw = f.read()
                if raw[:5] == b"DGTS3":
                    self._load_v3(raw)
                elif raw[:5] == b"DGTS2":
                    self._load_v2(raw)
                else:
                    self._load_v1(raw)
        # commits at/below the snapshot ts live in the loaded bases, not the
        # journal; the WAL tail replay below records everything above it
        self._delta_base_floor = self.snapshot_ts
        self._replay_wal(os.path.join(self.dir, "wal.log"))

    def _load_v3(self, raw) -> None:
        """Tablet-sectioned columnar snapshot (DGTS3, the checkpoint's
        streaming write format — ingest/snapwrite.py). Sections arrive in
        globally sorted key order, so each one IS a tablet run: no run
        detection pass, the per-tablet structures build directly."""
        off = 5
        (self.snapshot_ts,) = struct.unpack_from("<Q", raw, off)
        off += 8
        (n,) = _U32.unpack_from(raw, off)
        off += 4
        meta = json.loads(bytes(raw[off: off + n]))
        off += n
        for e in parse_schema(meta.get("schema", "")):
            self.schema.set(e)
        self.max_seen_commit_ts = meta.get("max_commit_ts", 0)
        paged = self.paged and isinstance(raw, np.memmap)
        total = len(raw)
        while off + 4 <= total:
            off = self._load_v3_section(raw, off, paged)

    def _load_v3_section(self, raw, off: int, paged: bool) -> int:
        (N,) = _U32.unpack_from(raw, off)
        off += 4

        def col(dt):
            nonlocal off
            (blen,) = struct.unpack_from("<Q", raw, off)
            off += 8
            if paged:
                # file-backed view (see _load_v2.col for the downcast note)
                arr = raw[off: off + blen].view(dt).view(np.ndarray)
            else:
                arr = np.frombuffer(raw[off: off + blen], dtype=dt)
            off += blen
            return arr

        key_lens = col(np.uint32)
        keys_blob_arr = col(np.uint8)
        base_ts = col(np.uint64)
        counts = col(np.uint32)
        nblocks = col(np.uint32)
        bfirst = col(np.uint64)
        blast = col(np.uint64)
        bcount = col(np.int32)
        bwidth = col(np.int32)
        boff = col(np.int64)
        word_lens = col(np.uint64)
        words = col(np.uint32)
        post_lens = col(np.uint32)
        post_blob_arr = col(np.uint8)
        if N == 0:
            return off

        kends = np.cumsum(key_lens.astype(np.int64))
        bends = np.cumsum(nblocks.astype(np.int64))
        wends = np.cumsum(word_lens.astype(np.int64))
        pends = np.cumsum(post_lens.astype(np.int64))
        first_key = bytes(keys_blob_arr[: int(kends[0])]) if paged \
            else keys_blob_arr[: int(kends[0])].tobytes()
        kind, attr = K.kind_attr_of(first_key)

        def starts(ends):
            out = np.zeros(len(ends) + 1, np.int64)
            out[1:] = ends
            return out

        if paged:
            self._segments[(kind, attr)] = SegmentRun(
                n=N,
                uid_keyed=kind in (int(K.KeyKind.DATA),
                                   int(K.KeyKind.REVERSE)),
                keys_blob=keys_blob_arr, kends=kends,
                base_ts=base_ts, counts=counts, nbs=nblocks,
                bstarts=starts(bends), wstarts=starts(wends),
                pstarts=starts(pends),
                bfirst=bfirst, blast=blast, bcount=bcount, bwidth=bwidth,
                boff=boff, words=words, post_blob=post_blob_arr)
        else:
            keys_blob = keys_blob_arr.tobytes()
            post_blob = post_blob_arr.tobytes()
            k0 = b0 = w0 = p0 = 0
            preds = self.by_pred.setdefault((kind, attr), set())
            # row bounds as Python ints once per section, not per row
            rows = zip(kends.tolist(), bends.tolist(), wends.tolist(),
                       pends.tolist(), base_ts.tolist(), counts.tolist())
            for k1, b1, w1, p1, ts_i, count_i in rows:
                kb = keys_blob[k0:k1]
                pl = PostingList()
                pl.base_ts = ts_i
                # zero-copy slices of the shared (read-only) buffers:
                # packed bases are immutable — rollup REPLACES base_packed
                pl.base_packed = packed.PackedUidList(
                    count_i, bfirst[b0:b1], blast[b0:b1],
                    bcount[b0:b1], bwidth[b0:b1], boff[b0:b1], words[w0:w1])
                if p1 > p0:
                    pl.base_postings = {
                        p.uid: p for p in map(posting_from_json,
                                              json.loads(post_blob[p0:p1]))}
                self.lists[kb] = pl
                preds.add(kb)
                k0, b0, w0, p0 = k1, b1, w1, p1
        if kind in (int(K.KeyKind.DATA), int(K.KeyKind.REVERSE)):
            wl = word_lens.astype(np.int64)
            self._packed_tablets[(kind, attr)] = TabletPacked(
                n=N,
                counts=counts.astype(np.int64),
                nbs=nblocks.astype(np.int64),
                row_word_start=wends - wl,
                bfirst=bfirst, bcount=bcount, bwidth=bwidth, boff=boff,
                words=words,
                pure=not post_lens.any(),
                max_base_ts=int(base_ts.max()))
        return off

    def _load_v2(self, raw: bytes) -> None:
        off = 5
        (self.snapshot_ts,) = struct.unpack_from("<Q", raw, off)
        off += 8
        (n,) = _U32.unpack_from(raw, off)
        off += 4
        meta = json.loads(bytes(raw[off : off + n]))
        off += n
        for e in parse_schema(meta.get("schema", "")):
            self.schema.set(e)
        self.max_seen_commit_ts = meta.get("max_commit_ts", 0)
        (N,) = _U32.unpack_from(raw, off)
        off += 4

        paged = self.paged and isinstance(raw, np.memmap)

        def col(dt):
            nonlocal off
            (blen,) = struct.unpack_from("<Q", raw, off)
            off += 8
            if paged:
                # file-backed view: the OS pages it; nothing is pinned in
                # anonymous memory. Downcast to plain ndarray (same buffer,
                # the mmap stays alive via .base): every later slice of a
                # memmap subclass pays ~2us of __array_finalize__, and the
                # fold slices these millions of times
                arr = raw[off: off + blen].view(dt).view(np.ndarray)
            else:
                # per-column copy: a view into `raw` would pin the ENTIRE
                # snapshot bytes for as long as any single list survives
                arr = np.frombuffer(raw[off: off + blen], dtype=dt)
            off += blen
            return arr

        key_lens = col(np.uint32)
        keys_blob_arr = col(np.uint8)
        keys_blob = keys_blob_arr if paged else keys_blob_arr.tobytes()
        base_ts = col(np.uint64)
        counts = col(np.uint32)
        nblocks = col(np.uint32)
        bfirst = col(np.uint64)
        blast = col(np.uint64)
        bcount = col(np.int32)
        bwidth = col(np.int32)
        boff = col(np.int64)
        word_lens = col(np.uint64)
        words = col(np.uint32)
        post_lens = col(np.uint32)
        post_blob_arr = col(np.uint8)
        post_blob = post_blob_arr if paged else post_blob_arr.tobytes()

        kends = np.cumsum(key_lens)
        bends = np.cumsum(nblocks.astype(np.int64))
        wends = np.cumsum(word_lens.astype(np.int64))
        pends = np.cumsum(post_lens.astype(np.int64))

        # tablet-run capture: keys are globally sorted, so a (kind, attr)
        # occupies one contiguous row run — record its column slices for
        # the one-call cold-open fold (csr_build._fold_uid_tablet)
        run_key: tuple[int, str] | None = None
        run_start = 0
        wstarts = wends - word_lens.astype(np.int64)
        bstarts = bends - nblocks.astype(np.int64)

        pstarts = pends - post_lens.astype(np.int64)
        kstarts = kends - key_lens.astype(np.int64)

        def flush_run(end: int) -> None:
            if run_key is None or end <= run_start:
                return
            r0, r1 = run_start, end
            bb0, bb1 = int(bstarts[r0]), int(bends[r1 - 1])
            ww0, ww1 = int(wstarts[r0]), int(wends[r1 - 1])
            if paged:
                # paged mode: the lazy-materialization segment (ALL kinds)
                pp0, pp1 = int(pstarts[r0]), int(pends[r1 - 1])
                kk0, kk1 = int(kstarts[r0]), int(kends[r1 - 1])
                bst = np.concatenate(
                    [bstarts[r0:r1] - bb0, [bb1 - bb0]]).astype(np.int64)
                wst = np.concatenate(
                    [wstarts[r0:r1] - ww0, [ww1 - ww0]]).astype(np.int64)
                pst = np.concatenate(
                    [pstarts[r0:r1] - pp0, [pp1 - pp0]]).astype(np.int64)
                self._segments[run_key] = SegmentRun(
                    n=r1 - r0,
                    uid_keyed=run_key[0] in (int(K.KeyKind.DATA),
                                             int(K.KeyKind.REVERSE)),
                    keys_blob=keys_blob_arr[kk0:kk1],
                    kends=(kends[r0:r1] - kk0).astype(np.int64),
                    base_ts=base_ts[r0:r1], counts=counts[r0:r1],
                    nbs=nblocks[r0:r1], bstarts=bst, wstarts=wst,
                    pstarts=pst,
                    bfirst=bfirst[bb0:bb1], blast=blast[bb0:bb1],
                    bcount=bcount[bb0:bb1], bwidth=bwidth[bb0:bb1],
                    boff=boff[bb0:bb1], words=words[ww0:ww1],
                    post_blob=post_blob_arr[pp0:pp1])
            if run_key[0] not in (int(K.KeyKind.DATA),
                                  int(K.KeyKind.REVERSE)):
                return       # only uid-edge tablets consult the fold cache
            self._packed_tablets[run_key] = TabletPacked(
                n=r1 - r0,
                counts=counts[r0:r1].astype(np.int64),
                nbs=nblocks[r0:r1].astype(np.int64),
                row_word_start=wstarts[r0:r1] - ww0,
                bfirst=bfirst[bb0:bb1], bcount=bcount[bb0:bb1],
                bwidth=bwidth[bb0:bb1], boff=boff[bb0:bb1],
                words=words[ww0:ww1],
                pure=not post_lens[r0:r1].any(),
                max_base_ts=int(base_ts[r0:r1].max()) if r1 > r0 else 0)

        k0 = b0 = w0 = p0 = 0
        for i in range(N):
            k1, b1 = int(kends[i]), int(bends[i])
            w1, p1 = int(wends[i]), int(pends[i])
            kb = bytes(keys_blob[k0:k1]) if paged else keys_blob[k0:k1]
            kind, attr = K.kind_attr_of(kb)
            if not paged:
                pl = PostingList()
                pl.base_ts = int(base_ts[i])
                # zero-copy slices of the shared (read-only) buffers: packed
                # bases are immutable — rollup REPLACES base_packed wholesale
                pl.base_packed = packed.PackedUidList(
                    int(counts[i]), bfirst[b0:b1], blast[b0:b1],
                    bcount[b0:b1], bwidth[b0:b1], boff[b0:b1], words[w0:w1])
                if p1 > p0:
                    pl.base_postings = {
                        p.uid: p for p in map(posting_from_json,
                                              json.loads(post_blob[p0:p1]))}
                self.lists[kb] = pl
                self.by_pred.setdefault((kind, attr), set()).add(kb)
            # paged: keys stay in the segment — no per-key object, no
            # per-key registry entry (the LSM role: RAM ∝ touched keys)
            if (kind, attr) != run_key:
                flush_run(i)
                run_key, run_start = (kind, attr), i
            k0, b0, w0, p0 = k1, b1, w1, p1
        flush_run(N)

    def _load_v1(self, raw: bytes) -> None:
        """Row-format reader kept for snapshots written before DGTS2."""
        assert raw[:5] == b"DGTS1", "bad snapshot magic"
        off = 5
        (snap_ts,) = struct.unpack_from("<Q", raw, off)
        self.snapshot_ts = snap_ts
        off += 8
        (n,) = _U32.unpack_from(raw, off)
        off += 4
        meta = json.loads(raw[off : off + n])
        off += n
        for e in parse_schema(meta.get("schema", "")):
            self.schema.set(e)
        self.max_seen_commit_ts = meta.get("max_commit_ts", 0)
        while off < len(raw):
            (klen,) = _U32.unpack_from(raw, off)
            off += 4
            kb = raw[off : off + klen]
            off += klen
            base_ts, count = struct.unpack_from("<QI", raw, off)
            off += 12
            arrs = []
            for dt in (np.uint64, np.uint64, np.int32, np.int32, np.int64, np.uint32):
                (blen,) = _U32.unpack_from(raw, off)
                off += 4
                arrs.append(np.frombuffer(raw[off : off + blen], dtype=dt).copy())
                off += blen
            (plen,) = _U32.unpack_from(raw, off)
            off += 4
            pbody = raw[off : off + plen]
            off += plen
            pl = PostingList()
            pl.base_ts = base_ts
            pl.base_packed = packed.PackedUidList(count, *arrs)
            if pbody != b"[]":   # uid-only lists skip the json machinery
                pl.base_postings = {
                    p.uid: p
                    for p in map(posting_from_json, json.loads(pbody))}
            kind, attr = K.kind_attr_of(kb)
            self.lists[kb] = pl
            self.by_pred.setdefault((kind, attr), set()).add(kb)

    def close(self) -> None:
        if self._wal is not None:
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._wal.close()
            self._wal = None
