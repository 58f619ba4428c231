"""External-id → uid assignment for loaders — disk-backed sharded LRU.

Copy of dgraph_tpu/loader/xidmap.py for the PyTorch port, over the port's
coord/zero.UidLease; the shard and log formats are the JAX package's, so
either package resumes the other's map.

Reference semantics: xidmap/xidmap.go:30 — loaders map RDF node names
(blank nodes, IRIs) to uids, leasing uid ranges from Zero; names that parse
as uids ("0x2a", "123") pass through and advance the lease so later leased
blocks can never collide. The reference shards an LRU over badger; this
build mirrors that shape directly:

  - HASH SHARDS: crc32(xid) picks one of N shards; each shard is a plain
    dict while resident and a framed file (`shard_NNNN.xs`) on disk.
  - BOUNDED LRU: with `cache_entries` set, least-recently-used shards
    flush to disk and drop from RAM — live-load xid cardinality is no
    longer capped by host memory.
  - APPEND LOG (`wal_path`): every NEW mapping appends one fsynced record
    (`sync()` per committed batch); `open()` replays it, so a crashed load
    RESUMES with every identity it had already assigned. `flush()` makes
    the shard files durable and truncates the log — the log only ever
    holds the tail since the last flush, not the whole history.

A map built with neither dirpath nor cache bound degenerates to the old
single-dict behavior (1 shard, no hashing on the hot path).

The whole-map JSON `save`/`load` pair is DEPRECATED in favor of the
sharded on-disk format; `migrate()` converts old files one-shot, and
`load()` keeps reading them so existing bulk outputs stay usable.
"""

from __future__ import annotations

import json
import os
import struct
import warnings
import zlib
from collections import OrderedDict
from dataclasses import dataclass

from dgraph_tpu_torch.coord.zero import LEASE_BLOCK, UidLease

_SHARD_MAGIC = b"DGXS1"
_REC = struct.Struct("<IQ")        # key len, uid
DEFAULT_SHARDS = 32


def parse_uid_literal(xid: str) -> int | None:
    """'0x2a' / '123' → uid, else None (a name to map)."""
    try:
        u = int(xid, 0)
    except ValueError:
        return None
    return u if u > 0 else None


@dataclass
class XidMapStats:
    """LRU observability (satellite: xidmap hit rate on /metrics)."""

    lookups: int = 0
    shard_loads: int = 0           # disk loads (LRU misses)
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        if not self.lookups:
            return 1.0
        return 1.0 - self.shard_loads / self.lookups


class XidMap:
    def __init__(self, lease: UidLease, block: int = LEASE_BLOCK, *,
                 dirpath: str | None = None,
                 cache_entries: int | None = None,
                 shards: int | None = None) -> None:
        if cache_entries is not None and dirpath is None:
            raise ValueError("a bounded xidmap cache needs a dirpath to "
                             "evict shards into")
        self._lease = lease
        self._block = block
        self._dir = dirpath
        self._nshards = shards if shards is not None else (
            DEFAULT_SHARDS if dirpath is not None else 1)
        self.cache_entries = cache_entries
        # explicit uids that fall inside the CURRENT leased block (never
        # hand out). Bounded O(block): bump_to fences every later block
        # above all previously-seen explicit uids, so entries below a new
        # block's start can never collide again and are pruned — an
        # all-literal-uid input must not grow an O(distinct uids) set
        # that the --xidmap_cache_mb bound can't see
        self._taken: set[int] = set()
        self._next = 0
        self._end = -1   # exhausted
        self._wal = None   # set ONLY by open(): appending to an existing
        # log without replaying it would mint divergent duplicate uids
        self._max_uid = 0
        self.stats = XidMapStats()
        self._dirty: set[int] = set()
        self._lru: OrderedDict[int, None] = OrderedDict()
        self._resident = 0
        if dirpath is not None:
            os.makedirs(dirpath, exist_ok=True)
            meta = self._read_meta()
            if meta:
                self._nshards = int(meta.get("shards", self._nshards))
                self._max_uid = int(meta.get("max_uid", 0))
                self._counts = [int(c) for c in meta.get(
                    "counts", [0] * self._nshards)]
                if not meta.get("clean"):
                    # crashed before flush(): shard files may carry uids
                    # past the meta's last-eviction snapshot
                    self._recover_ceiling_from_shards()
                    if len(self._counts) < self._nshards:
                        self._counts += [0] * (self._nshards
                                               - len(self._counts))
                if self._max_uid:
                    lease.bump_to(self._max_uid)
            else:
                self._counts = [0] * self._nshards
                # dirs from before the eager meta write (or a crash inside
                # the very first eviction): best effort — widen the shard
                # count to cover every file present, recover the ceiling
                self._recover_ceiling_from_shards()
                if self._max_uid:
                    lease.bump_to(self._max_uid)
                self._counts = [0] * self._nshards
                # pin the shard count + shape immediately: a later crash
                # must never re-attach with a DIFFERENT modulus (wrong
                # shard lookup -> missed mapping -> duplicate uid)
                self._write_meta(clean=False)
        else:
            self._counts = [0] * self._nshards
        self._shards: list[dict | None] = [None] * self._nshards

    def _recover_ceiling_from_shards(self) -> None:
        """Crash window: LRU evictions wrote shard files but the crash
        landed before a meta write recorded their ceiling. Attaching those
        shards WITHOUT recovering max_uid would leave the lease low and
        mint already-assigned uids for new xids (silent entity merging) —
        scan the files once, bump the ceiling, and widen the shard count
        past every file index seen."""
        import glob as _glob

        files = sorted(_glob.glob(os.path.join(self._dir, "shard_*.xs")))
        if not files:
            return
        top = max(int(os.path.basename(p)[6:10]) for p in files)
        if top >= self._nshards:
            self._nshards = top + 1
        for path in files:
            with open(path, "rb") as f:
                raw = f.read()
            if raw[:5] != _SHARD_MAGIC:
                continue
            off = 5
            while off + _REC.size <= len(raw):
                klen, uid = _REC.unpack_from(raw, off)
                off += _REC.size + klen
                if uid > self._max_uid:
                    self._max_uid = uid
        if self._max_uid:
            self._lease.bump_to(self._max_uid)

    # -- shard residency ----------------------------------------------------

    def _meta_path(self) -> str:
        return os.path.join(self._dir, "meta.json")

    def _read_meta(self) -> dict | None:
        try:
            with open(self._meta_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _shard_path(self, i: int) -> str:
        return os.path.join(self._dir, f"shard_{i:04d}.xs")

    def _shard_of(self, xid: str) -> int:
        if self._nshards == 1:
            return 0
        return zlib.crc32(xid.encode("utf-8")) % self._nshards

    def _shard(self, i: int) -> dict:
        sh = self._shards[i]
        if sh is None:
            sh = self._load_shard(i)
        if self.cache_entries is not None:
            self._lru[i] = None
            self._lru.move_to_end(i)
            if self._resident > self.cache_entries:
                self._evict(keep=i)
        return sh

    def _load_shard(self, i: int) -> dict:
        sh: dict[str, int] = {}
        if self._dir is not None:
            path = self._shard_path(i)
            if os.path.exists(path):
                self.stats.shard_loads += 1
                with open(path, "rb") as f:
                    raw = f.read()
                assert raw[:5] == _SHARD_MAGIC, f"bad shard magic in {path}"
                off = 5
                while off + _REC.size <= len(raw):
                    klen, uid = _REC.unpack_from(raw, off)
                    off += _REC.size
                    sh[raw[off: off + klen].decode("utf-8")] = uid
                    off += klen
        self._shards[i] = sh
        self._counts[i] = len(sh)
        self._resident += len(sh)
        return sh

    def _write_shard(self, i: int) -> None:
        sh = self._shards[i]
        path = self._shard_path(i)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_SHARD_MAGIC)
            for xid, uid in sh.items():
                kb = xid.encode("utf-8")
                f.write(_REC.pack(len(kb), uid))
                f.write(kb)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _evict(self, keep: int) -> None:
        """Flush + drop least-recently-used shards until under the cache
        bound (never the shard being served, never the last one)."""
        wrote = False
        while self._resident > self.cache_entries and len(self._lru) > 1:
            j, _ = self._lru.popitem(last=False)
            if j == keep:              # newest-by-definition; re-add, stop
                self._lru[j] = None
                break
            if j in self._dirty:
                self._write_shard(j)
                self._dirty.discard(j)
                wrote = True
            self._resident -= self._counts[j]
            self._shards[j] = None
            self.stats.evictions += 1
        if wrote:
            # keep the ceiling on disk ahead of the shard files: a crash
            # after this point re-attaches with max_uid covering every
            # assignment made so far (clean=False -> attach double-checks
            # the shards anyway)
            self._write_meta(clean=False)

    # -- durability ---------------------------------------------------------

    @classmethod
    def open(cls, wal_path: str, lease: UidLease,
             block: int = LEASE_BLOCK, *,
             cache_entries: int | None = None,
             shards: int | None = None) -> "XidMap":
        """Crash-resumable map: attach the shard dir (if one exists or a
        cache bound asks for one), replay the assignment log, then append.
        A torn trailing record (crash mid-write) is dropped — its xid was
        never acked, so the loader re-assigns it."""
        dirpath = wal_path + ".shards"
        if cache_entries is None and not os.path.isdir(dirpath):
            dirpath = None             # legacy pure-log mode
        xm = cls(lease, block, dirpath=dirpath,
                 cache_entries=cache_entries, shards=shards)
        if os.path.exists(wal_path):
            with open(wal_path, "rb") as f:
                raw = f.read()
            # a record is durable only when newline-terminated: ANY
            # unterminated tail is torn (a truncated uid still parses as
            # a valid shorter number — parseability cannot detect it) and
            # must be truncated away so the next append cannot fuse onto it
            keep_upto = raw.rfind(b"\n") + 1
            for line in raw[:keep_upto].split(b"\n"):
                if not line:
                    continue
                try:
                    xid_b, uid_b = line.rsplit(b"\t", 1)
                    xid, uid = xid_b.decode("utf-8"), int(uid_b)
                except (ValueError, UnicodeDecodeError):
                    continue         # unparseable complete line: skip
                i = xm._shard_of(xid)
                sh = xm._shard(i)
                if xid not in sh:    # may already live in a flushed shard
                    sh[xid] = uid
                    xm._counts[i] += 1
                    xm._resident += 1
                    xm._dirty.add(i)
                xm._max_uid = max(xm._max_uid, uid)
            if keep_upto < len(raw):
                with open(wal_path, "r+b") as f:
                    f.truncate(keep_upto)
            if xm._max_uid:
                lease.bump_to(xm._max_uid)
        xm._wal = open(wal_path, "ab")
        return xm

    def _log(self, xid: str, uid: int) -> None:
        if self._wal is not None:
            self._wal.write(xid.encode("utf-8") + b"\t" +
                            str(uid).encode() + b"\n")

    def sync(self) -> None:
        """Make all assignments so far durable (call per committed batch:
        an identity must never be re-assigned after its txn was acked)."""
        if self._wal is not None:
            self._wal.flush()
            os.fsync(self._wal.fileno())

    def _write_meta(self, clean: bool) -> None:
        meta = {"shards": self._nshards, "max_uid": self._max_uid,
                "counts": self._counts, "clean": clean}
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path())

    def flush(self) -> None:
        """Persist every dirty resident shard + the meta record, THEN
        truncate the append log — shard durability must land before the
        log entries covering it go away."""
        if self._dir is None:
            return
        for i in sorted(self._dirty):
            if self._shards[i] is not None:
                self._write_shard(i)
        self._dirty.clear()
        self._write_meta(clean=True)
        if self._wal is not None:
            self._wal.flush()
            self._wal.truncate(0)
            os.fsync(self._wal.fileno())

    def close(self) -> None:
        if self._dir is not None:
            self.flush()
        if self._wal is not None:
            self.sync()
            self._wal.close()
            self._wal = None

    # -- assignment ---------------------------------------------------------

    def uid(self, xid: str) -> int:
        self.stats.lookups += 1
        i = self._shard_of(xid)
        sh = self._shard(i)
        u = sh.get(xid)
        if u is not None:
            return u
        explicit = parse_uid_literal(xid)
        if explicit is not None:
            # reserve: the uid may only collide if it falls inside the
            # block we're currently consuming (future blocks start past
            # the bump ceiling). Memoize like named nodes — graph data
            # repeats each uid ~degree times, and re-parsing + re-locking
            # the lease per occurrence was the bulk loader's hottest line
            if self._next <= explicit <= self._end:
                self._taken.add(explicit)
            self._lease.bump_to(explicit)
            sh[xid] = explicit           # literal uids need no log (stateless)
            self._counts[i] += 1
            self._resident += 1
            self._dirty.add(i)
            if explicit > self._max_uid:
                self._max_uid = explicit
            return explicit
        while True:
            if self._next > self._end:
                self._next, self._end = self._lease.assign(self._block)
                # the new block starts above every explicit uid seen so
                # far (bump_to fencing): stale reservations are dead
                self._taken = {u for u in self._taken if u >= self._next}
            u = self._next
            self._next += 1
            if u not in self._taken:
                break
        sh[xid] = u
        self._counts[i] += 1
        self._resident += 1
        self._dirty.add(i)
        if u > self._max_uid:
            self._max_uid = u
        self._log(xid, u)
        return u

    def __len__(self) -> int:
        return sum(self._counts)

    # -- deprecated whole-map persistence + migration -----------------------

    def _iter_all(self):
        for i in range(self._nshards):
            resident = self._shards[i] is not None
            sh = self._shards[i] if resident else self._load_shard(i)
            yield from sh.items()
            if not resident and self.cache_entries is not None:
                # transient visit: don't let a full scan blow the cache
                self._resident -= self._counts[i]
                self._shards[i] = None

    def save(self, path: str) -> None:
        """DEPRECATED: whole-map JSON (pre-r10 format). Prefer the sharded
        on-disk dir (construct with dirpath=... and call flush())."""
        warnings.warn("XidMap.save writes the deprecated whole-map JSON "
                      "format; use a dirpath-backed map + flush() instead",
                      DeprecationWarning, stacklevel=2)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(self._iter_all()), f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, lease: UidLease,
             block: int = LEASE_BLOCK) -> "XidMap":
        """Read a deprecated whole-map JSON file (kept so old bulk outputs
        stay loadable; see migrate() for the one-shot conversion)."""
        xm = cls(lease, block)
        sh = xm._shard(0)
        with open(path) as f:
            sh.update({k: int(v) for k, v in json.load(f).items()})
        xm._counts[0] = len(sh)
        xm._resident = len(sh)
        if sh:
            xm._max_uid = max(sh.values())
            lease.bump_to(xm._max_uid)
        return xm

    @classmethod
    def migrate(cls, json_path: str, dirpath: str, lease: UidLease,
                block: int = LEASE_BLOCK) -> "XidMap":
        """One-shot migration: deprecated whole-map JSON → sharded dir.
        Returns the attached sharded map (the JSON file is left in place)."""
        xm = cls(lease, block, dirpath=dirpath)
        with open(json_path) as f:
            for k, v in json.load(f).items():
                i = xm._shard_of(k)
                sh = xm._shard(i)
                if k not in sh:
                    sh[k] = int(v)
                    xm._counts[i] += 1
                    xm._resident += 1
                    xm._dirty.add(i)
                if int(v) > xm._max_uid:
                    xm._max_uid = int(v)
        if xm._max_uid:
            lease.bump_to(xm._max_uid)
        xm.flush()
        return xm
