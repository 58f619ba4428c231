"""Posting lists with an immutable packed layer + MVCC mutation layers.

Copy of dgraph_tpu/storage/postings.py for the PyTorch port.

Reference semantics: posting/list.go — a List is an immutable bp128-packed
`plist` + a sorted mutable layer of posting deltas + per-transaction
uncommitted postings (posting/list.go:71-84); AddMutation (:292),
CommitMutation/AbortTransaction (:423,:384), Iterate(readTs, afterUid) (:502);
posting/mvcc.go — Txn deltas keyed by StartTs, commit writes deltas at
commitTs.

Redesign notes: the reference interleaves a skiplist-ish mlayer with compressed
blocks during every read. Here reads at a readTs fold committed delta layers
over the packed base *once per snapshot build* (storage/csr_build.py) — the
device always sees immutable CSR snapshots, so per-read merging happens only
for host-side point reads (values, single-list iteration). rollup() re-packs
committed layers into the base, the analog of SyncIfDirty (posting/list.go).

An SP* wildcard delete (subject-predicate star, rdf "S P *") is a DEL_ALL
posting that shadows everything at or below its commit ts.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from dgraph_tpu_torch.storage import native, packed
from dgraph_tpu_torch.utils.types import Val

# uid slot used by non-lang value postings (reference uses math.MaxUint64 for
# the value fingerprint; we reserve 0 — real uids start at 1).
VALUE_UID = 0


class Op(IntEnum):
    SET = 0
    DEL = 1
    DEL_ALL = 2  # S P * wildcard


def lang_uid(lang: str) -> int:
    """Fingerprint for @lang value postings (stable per language tag)."""
    if not lang:
        return VALUE_UID
    import hashlib

    h = int.from_bytes(hashlib.blake2b(lang.encode(), digest_size=7).digest(), "big")
    return h | (1 << 60)  # keep clear of real uid space


def value_fingerprint(v: Val) -> int:
    """Posting slot for one value of a list-valued scalar predicate
    (reference: multi-valued postings keyed by value fingerprint)."""
    import hashlib

    from dgraph_tpu_torch.utils.types import marshal

    raw = bytes([int(v.tid)]) + marshal(v)
    h = int.from_bytes(hashlib.blake2b(raw, digest_size=7).digest(), "big")
    return h | (1 << 61)  # distinct from lang (1<<60) and uid space


@dataclass(frozen=True)
class Posting:
    uid: int                      # object uid (uid-edges) or value slot
    op: Op = Op.SET
    value: Val | None = None      # value postings
    lang: str = ""
    facets: tuple = ()            # tuple of (name, Val), sorted by name


@dataclass(frozen=True)
class DirectedEdge:
    """One mutation edge (reference: protos DirectedEdge, intern.proto:167)."""

    subject: int
    attr: str
    object_uid: int = 0           # uid edges
    value: Val | None = None      # value edges
    op: Op = Op.SET
    lang: str = ""
    facets: tuple = ()

    def to_posting(self, is_list: bool = False) -> Posting:
        if self.op == Op.DEL_ALL:
            return Posting(VALUE_UID, Op.DEL_ALL)
        if self.value is not None:
            slot = value_fingerprint(self.value) if is_list else lang_uid(self.lang)
            return Posting(slot, self.op, self.value, self.lang, self.facets)
        return Posting(self.object_uid, self.op, None, self.lang, self.facets)


@dataclass
class _Layer:
    commit_ts: int
    postings: dict[int, Posting] = field(default_factory=dict)  # uid -> last write wins
    del_all: bool = False


# shared immutable empty base: bulk loads create hundreds of thousands of
# lists, and packing a fresh empty array per list measurably slowed them
_EMPTY_PACKED = packed.pack(np.zeros(0, dtype=np.uint64))


class PostingList:
    """MVCC posting list for one storage key."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.base_ts: int = 0
        self.base_packed: packed.PackedUidList = _EMPTY_PACKED
        self.base_postings: dict[int, Posting] = {}   # only uids with value/facets
        self.layers: list[_Layer] = []                # sorted by commit_ts
        self.uncommitted: dict[int, _Layer] = {}      # start_ts -> pending layer

    # -- write path ---------------------------------------------------------

    def add_mutation(self, start_ts: int, p: Posting) -> None:
        """Buffer a posting under a transaction (reference AddMutation :292)."""
        with self._lock:
            layer = self.uncommitted.setdefault(start_ts, _Layer(0))
            if p.op == Op.DEL_ALL:
                layer.del_all = True
                layer.postings.clear()
            else:
                layer.postings[p.uid] = p

    def commit(self, start_ts: int, commit_ts: int) -> bool:
        """Promote a txn's postings to a committed layer (CommitMutation :423)."""
        with self._lock:
            layer = self.uncommitted.pop(start_ts, None)
            if layer is None:
                return False
            layer.commit_ts = commit_ts
            # insert sorted (commits arrive nearly ordered)
            i = len(self.layers)
            while i > 0 and self.layers[i - 1].commit_ts > commit_ts:
                i -= 1
            self.layers.insert(i, layer)
            return True

    def abort(self, start_ts: int) -> None:
        with self._lock:
            self.uncommitted.pop(start_ts, None)

    def has_uncommitted(self, start_ts: int | None = None) -> bool:
        with self._lock:
            return bool(self.uncommitted) if start_ts is None else start_ts in self.uncommitted

    # -- read path ----------------------------------------------------------

    def _fold(self, read_ts: int, own_start_ts: int | None = None):
        """Effective (uids set, postings map) at read_ts.

        Folds: packed base → committed layers with commit_ts <= read_ts →
        (optionally) the reader's own uncommitted layer. Returns
        (sorted uid numpy array, {uid: Posting}).
        """
        if read_ts < self.base_ts:
            # rollup discarded history below base_ts; serving this read would
            # silently return future state (reference gates with a min-readTs
            # watermark before snapshotting, posting/mvcc.go:105).
            raise ValueError(f"read at ts {read_ts} below rollup watermark {self.base_ts}")
        uids = native.unpack(self.base_packed).astype(np.int64)
        live: dict[int, Posting] = dict(self.base_postings)
        present = dict.fromkeys(uids.tolist(), True)

        def apply(layer: _Layer):
            nonlocal present
            if layer.del_all:
                present = {}
                live.clear()
            for uid, p in sorted(layer.postings.items()):
                if p.op == Op.DEL:
                    present.pop(uid, None)
                    live.pop(uid, None)
                else:
                    present[uid] = True
                    if p.value is not None or p.facets:
                        live[uid] = p
                    else:
                        live.pop(uid, None)

        for layer in self.layers:
            if layer.commit_ts > read_ts:
                break
            apply(layer)
        if own_start_ts is not None and own_start_ts in self.uncommitted:
            apply(self.uncommitted[own_start_ts])
        out = np.fromiter(present.keys(), dtype=np.int64, count=len(present))
        out.sort()
        return out, live

    def _base_only(self, read_ts: int, own_start_ts: int | None) -> bool:
        """True when the read is served by the packed base alone — the common
        shape after a bulk load or rollup. Lets readers skip the per-uid dict
        fold (50k lists x dict-of-20 costs seconds on snapshot builds)."""
        if read_ts < self.base_ts:
            raise ValueError(
                f"read at ts {read_ts} below rollup watermark {self.base_ts}")
        if own_start_ts is not None and own_start_ts in self.uncommitted:
            return False
        return not self.layers or self.layers[0].commit_ts > read_ts

    def uids(self, read_ts: int, after_uid: int = 0, own_start_ts: int | None = None) -> np.ndarray:
        if self._base_only(read_ts, own_start_ts):
            u = native.unpack(self.base_packed).astype(np.int64)
        else:
            u, _ = self._fold(read_ts, own_start_ts)
        if after_uid:
            u = u[u > after_uid]
        return u

    def postings(self, read_ts: int, own_start_ts: int | None = None) -> list[Posting]:
        if self._base_only(read_ts, own_start_ts):
            u = native.unpack(self.base_packed).astype(np.int64)
            live = self.base_postings
        else:
            u, live = self._fold(read_ts, own_start_ts)
        return [live.get(int(x), Posting(int(x))) for x in u]

    def value(self, read_ts: int, lang: str = "", own_start_ts: int | None = None) -> Val | None:
        """The value posting (reference Value/ValueForTag, posting/list.go).

        lang="" reads ONLY the untagged slot (reference postingForLangs: an
        untagged read returns ErrNoValue when only lang-tagged values exist);
        the any-language fallback applies only to the explicit "." tag
        (`name@.`), preferring the untagged value first."""
        if self._base_only(read_ts, own_start_ts):
            live = self.base_postings
        else:
            _, live = self._fold(read_ts, own_start_ts)
        if lang == ".":
            p = live.get(lang_uid(""))
            if p is not None and p.value is not None:
                return p.value
            for q in live.values():
                if q.value is not None:
                    return q.value
            return None
        p = live.get(lang_uid(lang))
        return p.value if p else None

    def live_map(self, read_ts: int, own_start_ts: int | None = None) -> dict[int, Posting]:
        """Only the value/facet-carrying postings (uid→Posting) at read_ts —
        snapshot builds scan this instead of materializing a Posting per uid."""
        if self._base_only(read_ts, own_start_ts):
            return self.base_postings
        _, live = self._fold(read_ts, own_start_ts)
        return live

    def value_for_slot(self, read_ts: int, slot: int,
                       own_start_ts: int | None = None) -> Val | None:
        """Exact slot read, no language fallback (index maintenance must not
        see a different language's value as 'the old value')."""
        if self._base_only(read_ts, own_start_ts):
            live = self.base_postings
        else:
            _, live = self._fold(read_ts, own_start_ts)
        p = live.get(slot)
        return p.value if p else None

    def all_values(self, read_ts: int, own_start_ts: int | None = None) -> list[Val]:
        """Every live value posting (list-valued scalars, @lang variants)."""
        if self._base_only(read_ts, own_start_ts):
            live = self.base_postings
        else:
            _, live = self._fold(read_ts, own_start_ts)
        return [p.value for p in live.values() if p.value is not None]

    def length(self, read_ts: int, after_uid: int = 0) -> int:
        return int(len(self.uids(read_ts, after_uid)))

    def is_empty(self, read_ts: int) -> bool:
        return self.length(read_ts) == 0

    # -- maintenance --------------------------------------------------------

    def rollup(self, upto_ts: int) -> None:
        """Fold committed layers <= upto_ts into the packed base (SyncIfDirty
        analog: re-pack uids, keep value/facet postings in the base map)."""
        with self._lock:
            if not any(l.commit_ts <= upto_ts for l in self.layers):
                # nothing to fold — keep the packed base untouched (bulk-built
                # stores would otherwise unpack+repack every list on checkpoint)
                self.base_ts = max(self.base_ts, upto_ts)
                return
            u, live = self._fold(upto_ts)
            keep = [l for l in self.layers if l.commit_ts > upto_ts]
            self.base_packed = native.pack(u.astype(np.uint64))
            self.base_postings = live
            self.layers = keep
            self.base_ts = upto_ts

    # rough per-Posting host cost (object header + dict slot + Val), used by
    # the memory manager's budget accounting (posting/lists.go AllottedMemory)
    _POSTING_COST = 200

    def approx_bytes(self) -> int:
        with self._lock:
            n = 256 + self.base_packed.nbytes
            n += self._POSTING_COST * len(self.base_postings)
            for layer in self.layers:
                n += 64 + self._POSTING_COST * len(layer.postings)
            for layer in self.uncommitted.values():
                n += 64 + self._POSTING_COST * len(layer.postings)
            return n

    def layer_count(self) -> int:
        with self._lock:
            return len(self.layers)

    def min_pending_start_ts(self) -> int | None:
        with self._lock:
            return min(self.uncommitted) if self.uncommitted else None
