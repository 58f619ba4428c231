"""Immutable graph snapshots: a posting Store folded into host CSR columns
plus lazily uploaded device columns.

Port of dgraph_tpu/storage/csr_build.py. A snapshot at read_ts is a set of
immutable per-predicate arrays; the host numpy columns are the
authoritative fold (frontier→row mapping, degree counting, recurse edge
dedup, index probes and value compares run on them), and the device columns
are a cache uploaded on first kernel access:

  - uid predicates      → forward CSR (subjects / indptr / indices) and, for
                          @reverse predicates, a reverse CSR (ReverseKey
                          tablets, posting/index.go:190).
  - indexed predicates  → per-tokenizer token→uid CSR (TokenIndex).
  - value predicates    → host-side exact {uid: Val} maps plus the float64
                          numeric mirror aligned to value_subjects_host.
  - vector predicates   → a row-aligned embedding matrix (VectorIndex,
                          storage/vecindex.py), plus an IVF quantizer past
                          its size threshold.

build_pred folds one predicate of a Store; build_snapshot folds many,
eagerly through the shared fold pool or lazily as fold-thunks (LazyPreds);
SnapshotAssembler caches folds per predicate and makes a commit visible in
O(Δ) by stamping delta overlays (storage/delta.py). build_value_pred folds
value rows without a Store (the value and index halves of build_pred).

Every entry point that makes device state takes `device` (default "cuda",
which raises without CUDA). Folds run on the host only — on `dgt-fold` pool
threads too — and never touch the device: columns upload at first access,
on the thread that reads them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import torch

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.storage import keys as K
from dgraph_tpu_torch.storage.postings import VALUE_UID, PostingList
from dgraph_tpu_torch.storage.store import Store
from dgraph_tpu_torch.utils.types import TypeID, Val, convert, to_device_scalar

MAX_DEVICE_UID = 2**31 - 2  # int32 space, sentinel-exclusive


class PredCSR:
    """Adjacency of one predicate: row r = subjects[r] →
    indices[indptr[r]:indptr[r+1]], int32 host columns; device columns on
    `device`, uploaded at first access.

    The host numpy columns are the authoritative fold; the device columns
    are a droppable cache that uploads on first kernel access and — when
    a ResidencyManager is attached at fold time (storage/residency.py) —
    admits against the node's device-byte budget (evicting colder
    tablets) and can be demoted back to the warm host tier without
    touching this object's identity."""

    # residency owner protocol (set by ResidencyManager.adopt_pred)
    _res = None
    _res_attr = ""
    _res_kind = "csr"

    def __init__(self, subjects, indptr, indices,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self._subjects_h = np.asarray(subjects)   # int32[N] sorted
        self._indptr_h = np.asarray(indptr)       # int32[N+1]
        self._indices_h = np.asarray(indices)     # int32[E] sorted per row
        for name, a in (("subjects", self._subjects_h),
                        ("indices", self._indices_h)):
            if len(a) and (int(a.max()) > MAX_DEVICE_UID or int(a.min()) < 0):
                raise ValueError(f"{name}: uid outside the device uid space "
                                 f"[0, {MAX_DEVICE_UID}]")
        self._dev: tuple | None = None            # droppable device cache
        self._max_degree: int | None = None

    @property
    def num_subjects(self) -> int:
        return int(self._subjects_h.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self._indices_h.shape[0])

    # -- device tier ----------------------------------------------------------

    def device_arrays(self, prefetch: bool = False) -> tuple:
        """(subjects, indptr, indices) as int32 tensors on self.device,
        uploaded on first access through the residency seam (budget
        admission + the residency.h2d_upload fault point) when managed."""
        from dgraph_tpu_torch.storage import residency as resmod

        return resmod.ensure_device(
            self, "_dev",
            lambda: tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                    self.device)
                for a in (self._subjects_h, self._indptr_h,
                          self._indices_h)),
            prefetch=prefetch)

    @property
    def subjects(self) -> torch.Tensor:
        return self.device_arrays()[0]

    @property
    def indptr(self) -> torch.Tensor:
        return self.device_arrays()[1]

    @property
    def indices(self) -> torch.Tensor:
        return self.device_arrays()[2]

    def device_resident(self) -> bool:
        return self._dev is not None

    def drop_device(self) -> None:
        """Demote to the warm tier: drop the device tensors, keep the host
        fold. A kernel already enqueued keeps its own references; the next
        device access re-uploads byte-identical columns."""
        self._dev = None

    def device_nbytes(self) -> int:
        """The int32 device columns' bytes."""
        return 4 * int(len(self._subjects_h) + len(self._indptr_h)
                       + len(self._indices_h))

    def host_nbytes(self) -> int:
        return int(self._subjects_h.nbytes + self._indptr_h.nbytes
                   + self._indices_h.nbytes)

    def prefer_host(self) -> bool:
        """Tier consult for the query layer: True = COLD (footprint
        exceeds the whole device budget) — serve via the host-cutover
        machinery instead of uploading."""
        from dgraph_tpu_torch.storage import residency as resmod

        return resmod.prefer_host(self)

    # -- host tier ------------------------------------------------------------

    def host_arrays(self) -> tuple:
        """(subjects, indptr, indices) as numpy — the host truth."""
        return (self._subjects_h, self._indptr_h, self._indices_h)

    def max_degree(self) -> int:
        """Largest row length, cached."""
        if self._max_degree is None:
            ptr = self._indptr_h
            self._max_degree = int(np.max(ptr[1:] - ptr[:-1])) \
                if len(ptr) > 1 else 0
        return self._max_degree


def transpose_csr(subjects, indptr, indices) -> tuple:
    """Reverse adjacency (object → sorted subjects) of a CSR, as the
    @reverse ReverseKey tablets fold it: int32 (subjects, indptr, indices)."""
    subjects = np.asarray(subjects, dtype=np.int64)
    src = np.repeat(subjects, np.diff(np.asarray(indptr)))
    dst = np.asarray(indices, dtype=np.int64)
    order = np.lexsort((src, dst))
    rsub, counts = np.unique(dst[order], return_counts=True)
    rptr = np.zeros(len(rsub) + 1, dtype=np.int32)
    np.cumsum(counts, out=rptr[1:])
    return (rsub.astype(np.int32), rptr, src[order].astype(np.int32))


class TokenIndex:
    """token→uid CSR for one (predicate, tokenizer): row r holds the sorted
    uids of term terms[r] (terms sorted, stored without the tokenizer's
    ident byte). Host columns are the truth; device columns are uploaded to
    `device` at first use (the union of many rows, task._index_uids_for_rows)
    through the residency seam, as PredCSR's are."""

    _res = None
    _res_attr = ""
    _res_kind = "index"

    def __init__(self, terms: list[bytes], indptr, uids,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self.terms = terms      # sorted; host-side (binary-searched)
        self._indptr_h = np.asarray(indptr)   # int32[T+1]
        self._uids_h = np.asarray(uids)       # int32[sum lens], sorted/row
        self._dev: tuple | None = None
        self._host: tuple | None = None       # lazy (indptr, uids64)

    def term_row(self, term: bytes) -> int:
        import bisect

        i = bisect.bisect_left(self.terms, term)
        return i if i < len(self.terms) and self.terms[i] == term else -1

    def device_arrays(self, prefetch: bool = False) -> tuple:
        """(indptr, uids) as int32 tensors on self.device."""
        from dgraph_tpu_torch.storage import residency as resmod

        return resmod.ensure_device(
            self, "_dev",
            lambda: tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                    self.device)
                for a in (self._indptr_h, self._uids_h)),
            prefetch=prefetch)

    @property
    def indptr(self) -> torch.Tensor:
        return self.device_arrays()[0]

    @property
    def uids(self) -> torch.Tensor:
        return self.device_arrays()[1]

    def device_resident(self) -> bool:
        return self._dev is not None

    def drop_device(self) -> None:
        self._dev = None

    def device_nbytes(self) -> int:
        return 4 * int(len(self._indptr_h) + len(self._uids_h))

    def host_nbytes(self) -> int:
        return int(self._indptr_h.nbytes + self._uids_h.nbytes)

    def prefer_host(self) -> bool:
        from dgraph_tpu_torch.storage import residency as resmod

        return resmod.prefer_host(self)

    def host_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr, uids int64) host mirrors: index sorts and bucket walks
        never touch the device."""
        if self._host is None:
            self._host = (self._indptr_h, self._uids_h.astype(np.int64))
        return self._host


def _token_index(rows: list[tuple[bytes, np.ndarray]],
                 device: str | torch.device) -> TokenIndex:
    rows.sort(key=lambda x: x[0])
    terms = [t for t, _ in rows]
    lens = np.asarray([len(u) for _, u in rows], dtype=np.int64)
    indptr = np.zeros(len(rows) + 1, dtype=np.int32)
    if len(rows):
        np.cumsum(lens, out=indptr[1:])
        uids = np.concatenate([u for _, u in rows]).astype(np.int32)
    else:
        uids = np.zeros(0, dtype=np.int32)
    return TokenIndex(terms, indptr, uids, device)


@dataclass
class PredData:
    """One predicate at read_ts: its adjacency (uid edges), its values and
    their token indexes, and the facets of both."""

    attr: str
    type_id: TypeID
    csr: PredCSR | None = None
    rev_csr: PredCSR | None = None
    value_subjects_host: np.ndarray | None = None  # int64[N] sorted uids with a value
    num_values_host: np.ndarray | None = None    # float64[N] exact mirror (NaN=non-numeric)
    host_values: dict[int, Val] = field(default_factory=dict)
    # [type] list predicates: every value per subject (host_values keeps the
    # first for single-value compare/sort paths)
    list_values: dict[int, list[Val]] = field(default_factory=dict)
    lang_values: dict[int, dict[str, Val]] = field(default_factory=dict)
    # (subject, object uid or value slot) -> ((name, Val), ...) sorted by
    # name, as a posting carries them (storage/postings.py slots)
    facets: dict[tuple[int, int], tuple] = field(default_factory=dict)
    indexes: dict[str, TokenIndex] = field(default_factory=dict)
    # @index(vector) predicates: row-aligned embedding matrix + IVF
    # (storage/vecindex.VectorIndex, or VecOverlay when delta-stamped)
    vecindex: object | None = None

    def has_subjects(self) -> np.ndarray:
        """uids for has(attr): subjects with any edge or value."""
        outs = []
        if self.csr is not None:
            sub_fn = getattr(self.csr, "subjects_host", None)
            if sub_fn is not None:
                # delta overlay (storage/delta.OverlayCSR): merged subjects
                # without forcing the full edge merge
                outs.append(sub_fn())
            else:
                outs.append(self.csr.host_arrays()[0])
        if self.value_subjects_host is not None:
            outs.append(self.value_subjects_host)
        if not outs:
            return np.zeros(0, dtype=np.int32)
        return np.unique(np.concatenate(outs))


def build_value_pred(attr: str, entry, rows,
                     device: str | torch.device = "cuda") -> PredData:
    """Fold one value predicate's committed state into a PredData: the value
    and index halves of the JAX package's build_pred (its per-subject
    _fold_value_subject), with rows in place of the posting Store.

    rows: iterable of (subject, Val, lang, facets) — one live value posting
    each; facets a tuple of (name, Val) sorted by name. A value whose type
    differs from the schema's converts as a mutation would. The posting
    slot is the lang tag's (storage/postings.lang_uid), or on a [type] list
    predicate the value's fingerprint; a later row at a taken slot replaces
    the earlier one, and a subject's postings are read in slot order, as one
    committed layer of a posting list applies them. Index rows store each
    term without its tokenizer's ident byte."""
    from dgraph_tpu_torch.storage.index import index_tokens
    from dgraph_tpu_torch.storage.postings import (VALUE_UID, lang_uid,
                                                   value_fingerprint)
    from dgraph_tpu_torch.utils import tok as tokmod

    tid = entry.type_id if entry is not None else TypeID.DEFAULT
    if tid == TypeID.UID:
        raise ValueError(f"{attr}: a uid predicate holds no values")
    is_list = entry is not None and entry.is_list
    pd = PredData(attr, tid)
    live: dict[int, dict[int, tuple]] = {}
    for subj, v, lang, facets in rows:
        if tid not in (TypeID.DEFAULT, v.tid):
            v = convert(v, tid)
        slot = value_fingerprint(v) if is_list else lang_uid(lang)
        live.setdefault(int(subj), {})[slot] = (v, lang, tuple(facets))

    tokenizers = list(entry.tokenizers) if entry is not None else []
    by_tok: dict[str, dict[bytes, list[int]]] = {n: {} for n in tokenizers}
    ident_to_name = {tokmod.get(n).ident: n for n in tokenizers}
    term_cache: dict[tuple, list[bytes]] = {}
    val_subjects: list[int] = []
    num_vals: list[float] = []
    for subj in sorted(live):
        slots = live[subj]
        postings = [(slot, *slots[slot]) for slot in sorted(slots)]
        p0 = slots.get(VALUE_UID)
        v = p0[0] if p0 is not None else None
        if v is None and is_list:
            # [type] list predicate: the whole list plus the first as the
            # compare/sort representative
            lv = sorted((pv for _, pv, plang, _ in postings if not plang),
                        key=lambda x: str(x.value))
            if lv:
                pd.list_values[subj] = lv
                v = lv[0]
        num: float | None = None
        if v is not None:
            pd.host_values[subj] = v
            sc = to_device_scalar(v)
            num = np.nan if sc is None else float(sc)
        had_lang = False
        for slot, pv, plang, pfacets in postings:
            if plang:
                pd.lang_values.setdefault(subj, {})[plang] = pv
                had_lang = True
            if pfacets:
                pd.facets[(subj, slot)] = pfacets
            if not tokenizers:
                continue
            key = _term_key(pv, plang)
            terms = term_cache.get(key) if key is not None else None
            if terms is None:
                terms = index_tokens(entry, pv, plang)
                if key is not None:
                    term_cache[key] = terms
            for t in terms:
                name = ident_to_name.get(t[0])
                if name is None:
                    continue
                lst = by_tok[name].setdefault(t[1:], [])
                if not lst or lst[-1] != subj:
                    lst.append(subj)
        if v is None and had_lang:
            # lang-only node: still a has(attr) subject, but carries no
            # untagged value
            num = np.nan
        if num is not None:
            val_subjects.append(subj)
            num_vals.append(num)
    if val_subjects:
        vs = np.asarray(val_subjects, dtype=np.int64)   # already sorted
        if vs[-1] > MAX_DEVICE_UID or vs[0] < 0:
            raise ValueError("value subject uid outside the device uid space")
        pd.value_subjects_host = vs
        pd.num_values_host = np.asarray(num_vals, dtype=np.float64)
    for name, terms in by_tok.items():
        pd.indexes[name] = _token_index(
            [(t, np.asarray(u, dtype=np.int64)) for t, u in terms.items()],
            device)
    return pd


def _term_key(v: Val, lang: str) -> tuple | None:
    """Cache key of a value's index terms: equal keys give equal terms.
    None for the types where equal values can tokenize apart (a datetime's
    year depends on its zone; -0.0 == 0.0 but encodes apart, hence hex)."""
    if v.tid == TypeID.FLOAT:
        return (v.tid, float(v.value).hex(), lang)
    if v.tid in (TypeID.INT, TypeID.STRING, TypeID.BOOL):
        return (v.tid, v.value, lang)
    return None


class GraphSnapshot:
    """Immutable view of (a subset of) the graph at read_ts on one device."""

    def __init__(self, read_ts: int,
                 device: str | torch.device = "cuda") -> None:
        self.read_ts = read_ts
        self.device = resolve_device(device)
        self.preds: dict[str, PredData] = {}

    def pred(self, attr: str) -> PredData | None:
        return self.preds.get(attr)


def _csr_from_rows(rows: list[tuple[int, np.ndarray]],
                   device: torch.device) -> PredCSR | None:
    rows = [(s, o) for s, o in rows if len(o)]
    if not rows:
        return None
    rows.sort(key=lambda x: x[0])
    subjects = np.asarray([s for s, _ in rows], dtype=np.int64)
    if len(subjects) and subjects[-1] > MAX_DEVICE_UID:
        raise ValueError(f"uid {subjects[-1]} exceeds device uid space")
    lens = np.asarray([len(o) for _, o in rows], dtype=np.int64)
    indptr = np.zeros(len(rows) + 1, dtype=np.int32)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate([o for _, o in rows]).astype(np.int64)
    if len(indices) and indices.max() > MAX_DEVICE_UID:
        raise ValueError("object uid exceeds device uid space")
    return PredCSR(subjects.astype(np.int32), indptr,
                   indices.astype(np.int32), device)


# ---------------------------------------------------------------------------
# lazy on-demand snapshot folds
# ---------------------------------------------------------------------------
#
# A lazy snapshot registers unfolded tablets as fold-thunks: the first read
# of a predicate (GraphSnapshot.pred / LazyPreds.get) folds exactly that
# tablet, with singleflight per tablet so racing first readers share one
# fold. The fold is byte-identical to eager assembly (the same build_pred at
# the same read_ts). An unresolved thunk folds against the live store at its
# registration-time read_ts: normal commits land above that ts and stay
# invisible; a predicate drop resolves the pending tablet as empty, and a
# replay below the watermark moves pred_replay_seq, so the next snapshot()
# call rebuilds.

# fold-trigger counters of an optional metrics registry
_FOLD_COUNTERS = {
    "lazy": "dgraph_fold_lazy_total",
    "eager": "dgraph_fold_eager_total",
    "prefetch": "dgraph_fold_prefetch_total",
    "inline": "dgraph_fold_inline_total",
}


def _note_fold(metrics, trigger: str, dt_ms: float | None) -> None:
    if metrics is None:
        return
    metrics.counter(_FOLD_COUNTERS.get(trigger,
                                       "dgraph_fold_lazy_total")).inc()
    if dt_ms is not None:
        metrics.histogram("dgraph_fold_ms").observe(dt_ms)


class _FoldThunk:
    """One unfolded tablet: fold-on-first-read with per-tablet
    singleflight. The claim lock is held only to elect a leader — the fold
    itself runs outside it. A failed fold propagates to the waiters of that
    attempt and resets leadership so a later read retries; a resolved thunk
    answers every later caller (LazyPreds copies sharing it included)
    without re-folding."""

    __slots__ = ("attr", "eff", "pct", "seq", "inline", "fold",
                 "pd", "error", "_lock", "_event", "_claimed")

    def __init__(self, attr: str, eff: int, fold, pct: int = 0,
                 seq: int = 0, inline: bool = False) -> None:
        self.attr = attr
        self.eff = eff
        self.pct = pct
        self.seq = seq
        self.inline = inline      # fold forced by overlay depth/stamp miss
        self.fold = fold          # callable(thunk, trigger) -> PredData
        self.pd: PredData | None = None
        self.error: BaseException | None = None
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._claimed = False

    def resolve(self, trigger: str = "lazy") -> PredData:
        pd = self.pd
        if pd is not None:
            return pd
        with self._lock:
            if self.pd is not None:
                return self.pd
            lead = not self._claimed
            if lead:
                self._claimed = True
            event = self._event
        if not lead:
            # racing first reader: share the leader's fold, clamped to the
            # caller's own deadline budget — never an unbounded hang
            from dgraph_tpu_torch.utils import deadline as dl

            if not event.wait(dl.clamp(None)):
                dl.check("lazy fold follower")
                raise dl.DeadlineExceeded(
                    f"lazy fold of {self.attr} timed out")
            if self.pd is not None:
                return self.pd
            if self.error is not None:
                raise self.error
            return self.resolve(trigger)       # leader failed then reset
        try:
            pd = self.fold(self, "inline" if self.inline else trigger)
        except BaseException as e:
            with self._lock:
                self.error = e
                self._claimed = False
                self._event = threading.Event()
            event.set()
            raise
        self.pd = pd
        self.error = None
        event.set()
        return pd


class DelegateThunk:
    """Pass-through thunk: resolves another lazy map's entry. The fold
    singleflight lives in the underlying map's own thunk; the claim lock
    here serializes the optional `wrap` transform too, so racing first
    readers receive one identity."""

    __slots__ = ("src", "attr", "wrap", "pd", "_lock")

    def __init__(self, src, attr: str, wrap=None) -> None:
        self.src = src
        self.attr = attr
        self.wrap = wrap          # optional post-fold transform
        self.pd = None
        self._lock = threading.Lock()

    def resolve(self, trigger: str = "lazy"):
        if self.pd is not None:
            return self.pd
        with self._lock:
            if self.pd is None:
                pd = self.src.get(self.attr)
                if pd is not None and self.wrap is not None:
                    pd = self.wrap(pd)
                if pd is None:
                    return None
                self.pd = pd
        return self.pd


class LazyPreds(dict):
    """attr → PredData where unfolded tablets are fold-thunks.

    The dict storage holds folded entries only; `_thunks` holds the pending
    tablets. Key views (len / contains / iter / keys) see the union without
    folding; `get`/`[]` fold exactly the requested tablet; `values()` /
    `items()` materialize everything first (in parallel through the fold
    pool). Assignment (`[k] = v`, `update`) drops any shadowed thunk: an
    explicit entry always wins."""

    __slots__ = ("_thunks", "hint_fn", "on_resolve")

    def __init__(self) -> None:
        super().__init__()
        self._thunks: dict[str, object] = {}
        self.hint_fn = None       # callable(attr) -> cardinality estimate
        self.on_resolve = None    # callback(attr, pd) per materialization

    # -- registration ---------------------------------------------------------

    def register(self, attr: str, thunk) -> None:
        if not dict.__contains__(self, attr):
            self._thunks[attr] = thunk

    # -- resolution -----------------------------------------------------------

    def resolve(self, attr: str, trigger: str = "lazy"):
        """Fold one pending tablet (or return the folded entry)."""
        pd = dict.get(self, attr)
        if pd is not None:
            return pd
        th = self._thunks.get(attr)
        if th is None:
            return dict.get(self, attr)   # raced another resolver
        pd = th.resolve(trigger)
        if pd is None:                    # delegate over an absent tablet
            self._thunks.pop(attr, None)
            return None
        dict.__setitem__(self, attr, pd)
        self._thunks.pop(attr, None)
        cb = self.on_resolve
        if cb is not None:
            try:
                cb(attr, pd)
            except Exception:
                pass          # bookkeeping must never fail a read
        return pd

    def materialize_all(self, trigger: str = "eager") -> int:
        """Fold every pending tablet, in parallel through the shared fold
        pool. Distinct attrs have distinct thunks and each pool task waits
        only on a leader that is already running, so pool-width saturation
        cannot deadlock."""
        pending = [a for a in list(self._thunks)
                   if not dict.__contains__(self, a)]
        if not pending:
            return 0
        if len(pending) > 1:
            from concurrent.futures import TimeoutError as _FutTimeout

            from dgraph_tpu_torch.utils import deadline as dl

            pool = _fold_pool()
            # dgraph: allow(ctxvar-copy) folds build SHARED snapshot
            # state cached across requests — they must not inherit any
            # one request's deadline/trace context
            futs = [pool.submit(self.resolve, a, trigger) for a in pending]
            for f in futs:
                try:
                    # clamped to the caller's budget
                    f.result(timeout=dl.clamp(None))
                except _FutTimeout:
                    dl.check("materialize_all fold")
                    raise dl.DeadlineExceeded(
                        "materialize-all folds timed out")
        else:
            self.resolve(pending[0], trigger)
        return len(pending)

    # -- mapping protocol -----------------------------------------------------

    def __getitem__(self, attr):
        pd = dict.get(self, attr)
        if pd is not None:
            return pd
        if attr in self._thunks:
            pd = self.resolve(attr)
            if pd is not None:
                return pd
        raise KeyError(attr)

    def get(self, attr, default=None):
        pd = dict.get(self, attr)
        if pd is not None:
            return pd
        if attr in self._thunks:
            pd = self.resolve(attr)
            if pd is not None:
                return pd
        return default

    def __contains__(self, attr) -> bool:
        return dict.__contains__(self, attr) or attr in self._thunks

    def __len__(self) -> int:
        return len(set(dict.keys(self)) | set(self._thunks))

    def __iter__(self):
        return iter(sorted(set(dict.keys(self)) | set(self._thunks)))

    def keys(self):
        return sorted(set(dict.keys(self)) | set(self._thunks))

    def values(self):
        # sorted-key order: on-demand resolution inserts in completion
        # order, and iteration must stay deterministic
        self.materialize_all()
        return [v for _k, v in sorted(dict.items(self))]

    def items(self):
        self.materialize_all()
        return sorted(dict.items(self))

    def __setitem__(self, attr, pd) -> None:
        self._thunks.pop(attr, None)
        dict.__setitem__(self, attr, pd)

    def update(self, other=(), **kw) -> None:
        d = dict(other, **kw)
        for k in d:
            self._thunks.pop(k, None)
        dict.update(self, d)

    # -- lazy-aware views (stats / memory) ------------------------------------

    def folded_get(self, attr, default=None):
        """Folded entry or default — never resolves a thunk."""
        return dict.get(self, attr, default)

    def folded_items(self):
        return list(dict.items(self))

    def folded_values(self):
        return list(dict.values(self))

    def pending_attrs(self) -> list[str]:
        return [a for a in list(self._thunks)
                if not dict.__contains__(self, a)]

    def is_pending(self, attr: str) -> bool:
        return attr in self._thunks and not dict.__contains__(self, attr)

    def pending_card(self, attr: str) -> int:
        """Cardinality estimate for an unfolded tablet (order decisions
        only, never results)."""
        fn = self.hint_fn
        if fn is None:
            return 0
        try:
            return int(fn(attr))
        except Exception:
            return 0

    def lazy_copy(self) -> "LazyPreds":
        """Folded entries copied, pending thunks shared: a fold through
        either map resolves the one shared thunk (`dict(preds)` would drop
        the pending tablets). The copy reads the dict storage itself:
        dict.update over this subclass would go through its keys() and
        __getitem__ and fold every pending tablet, as the JAX package's
        copy does."""
        out = LazyPreds()
        dict.update(out, dict.items(self))
        out._thunks = dict(self._thunks)
        out.hint_fn = self.hint_fn
        out.on_resolve = self.on_resolve
        return out


_UNPACK_CHUNK = 16384   # lists decoded per vectorized unpack_many call


def _tablet_uids(store: Store, kbs: list[bytes], read_ts: int,
                 own: int | None,
                 pls: list | None = None) -> list[np.ndarray]:
    """uids() for every key of a tablet, batching pure-base lists through one
    vectorized decode (native.unpack_many)."""
    from dgraph_tpu_torch.storage import native

    # .get: a predicate dropped mid-build reads as empty rather than
    # KeyError; the reader's version bump rebuilds after
    if pls is None:
        pls = [store.lists.get(kb) for kb in kbs]
    pls = [pl if pl is not None else PostingList() for pl in pls]
    out: list[np.ndarray | None] = [None] * len(pls)
    batch_idx: list[int] = []
    for i, pl in enumerate(pls):
        if pl._base_only(read_ts, own):
            batch_idx.append(i)
        else:
            out[i] = pl.uids(read_ts, own_start_ts=own)
    for lo in range(0, len(batch_idx), _UNPACK_CHUNK):
        part = batch_idx[lo: lo + _UNPACK_CHUNK]
        for i, u in zip(part, native.unpack_many(
                [pls[i].base_packed for i in part])):
            out[i] = u.astype(np.int64)
    return out


def _uids_of_keys(kbs: list[bytes]) -> np.ndarray:
    """Vectorized K.uid_of over a tablet's DATA/REVERSE keys (all the same
    length for one attr: kind + u32 len + attr + u64 uid, big-endian)."""
    n = len(kbs)
    if n == 0:
        return np.zeros(0, np.int64)
    buf = b"".join(kbs)
    L = len(kbs[0])
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(n, L)
    return np.ascontiguousarray(arr[:, -8:]).view(">u8").ravel().astype(
        np.int64)


def _csr_from_flat(subjects: np.ndarray, counts: np.ndarray,
                   indices: np.ndarray, device: torch.device) -> PredCSR:
    """Assemble a PredCSR from flat arrays, dropping empty rows."""
    keep = counts > 0
    subjects_k = subjects[keep]
    if len(subjects_k) and subjects_k[-1] > MAX_DEVICE_UID:
        raise ValueError(f"uid {subjects_k[-1]} exceeds device uid space")
    if len(indices) and indices.max() > MAX_DEVICE_UID:
        raise ValueError("object uid exceeds device uid space")
    indptr = np.zeros(int(keep.sum()) + 1, dtype=np.int32)
    np.cumsum(counts[keep], out=indptr[1:])
    return PredCSR(subjects_k.astype(np.int32), indptr,
                   indices.astype(np.int32), device)


def _fold_uid_tablet(store: Store, kbs: list[bytes], read_ts: int,
                     own: int | None, pd: PredData | None,
                     device: torch.device,
                     kind: int = int(K.KeyKind.DATA)) -> PredCSR | None:
    """Flat fold of a uid-edge tablet: one vectorized key parse, one
    batched native decode into a single flat index array, bulk span copies —
    no per-key numpy slicing.

    pd: facet capture target for lists with live postings (None for
    reverse tablets — the forward fold owns facets)."""
    from dgraph_tpu_torch.storage import native

    N = len(kbs)
    if N == 0:
        return None

    # cold-open fast path: the snapshot loader captured this tablet's
    # packed columns contiguously (store.TabletPacked; the entry survives
    # only while untouched by writes) — decode every list in one native call
    attr = K.kind_attr_of(kbs[0])[1]
    tp = store.packed_tablet(kind, attr)
    if tp is not None and tp.pure and tp.n == N:
        if read_ts < tp.max_base_ts:
            raise ValueError(
                f"read at ts {read_ts} below rollup watermark "
                f"{tp.max_base_ts}")
        flat = native.unpack_columns(tp, int(tp.counts.sum()))
        if flat is not None:
            return _csr_from_flat(_uids_of_keys(kbs), tp.counts,
                                  flat.view(np.int64), device)

    pls = [store.lists.get(kb) for kb in kbs]
    subjects = _uids_of_keys(kbs)      # keys_of is sorted → ascending
    max_bts = max((pl.base_ts for pl in pls if pl is not None), default=0)
    if read_ts < max_bts:
        # the isolation guard PostingList._base_only enforces per list: a
        # rollup above read_ts folded later commits into the base
        raise ValueError(
            f"read at ts {read_ts} below rollup watermark {max_bts}")
    pure = np.fromiter(
        ((pl is not None and not pl.layers and not pl.uncommitted
          and not pl.base_postings) for pl in pls), bool, N)
    comp_rows: dict[int, np.ndarray] = {}
    for i in np.flatnonzero(~pure).tolist():
        pl = pls[i]
        if pl is None:                 # dropped mid-build: reads as empty
            comp_rows[i] = np.zeros(0, np.int64)
            continue
        comp_rows[i] = pl.uids(read_ts, own_start_ts=own)
        if pd is not None:
            live = pl.live_map(read_ts, own_start_ts=own)
            subj = int(subjects[i])
            for p in live.values():
                if p.facets:
                    pd.facets[(subj, p.uid)] = p.facets
    pure_idx = np.flatnonzero(pure)
    flat, counts_pure = native.unpack_many_flat(
        [pls[i].base_packed for i in pure_idx.tolist()])
    counts = np.zeros(N, np.int64)
    counts[pure] = counts_pure
    for i, u in comp_rows.items():
        counts[i] = len(u)
    total = int(counts.sum())
    if total == 0:
        return None
    offs = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    indices = np.empty(total, np.int64)
    if not comp_rows:
        indices[:] = flat              # single bulk copy (casts u64→i64)
    else:
        pure_off = np.zeros(len(pure_idx) + 1, np.int64)
        np.cumsum(counts_pure, out=pure_off[1:])
        # consecutive pure keys form runs → one span copy per run
        starts = np.concatenate(
            [[0], np.flatnonzero(np.diff(pure_idx) != 1) + 1])
        ends = np.concatenate([starts[1:], [len(pure_idx)]])
        for j0, j1 in zip(starts.tolist(), ends.tolist()):
            if j0 == j1:
                continue
            i0, i_last = int(pure_idx[j0]), int(pure_idx[j1 - 1])
            indices[offs[i0]: offs[i_last + 1]] = \
                flat[pure_off[j0]: pure_off[j1]]
        for i, u in comp_rows.items():
            indices[offs[i]: offs[i + 1]] = u
    return _csr_from_flat(subjects, counts, indices, device)


def _fold_value_subject(pd: PredData, entry, tid: TypeID, subj: int, pl,
                        read_ts: int,
                        own: int | None) -> tuple[bool, float | None]:
    """Per-subject value/facet fold — the one implementation shared by
    build_pred and the delta-overlay stamp (storage/delta.py), so a stamped
    entry is byte-identical to a full fold at the same read_ts.

    Mutates pd's value/facet dicts; returns (is_edge_row, num_mirror):
    is_edge_row means the subject's uids belong in the CSR (uid-typed, or
    DEFAULT with no value postings); num_mirror is the subject's
    value_subjects numeric-mirror entry (None = no entry)."""
    live = pl.live_map(read_ts, own_start_ts=own)
    # type heuristic for untyped predicates probes any value ("." tag);
    # host_values below still reads only the untagged slot
    has_value = any(p.value is not None for p in live.values())
    if tid == TypeID.UID or (tid == TypeID.DEFAULT and not has_value):
        for p in live.values():
            if p.facets:
                pd.facets[(subj, p.uid)] = p.facets
        return True, None
    p0 = live.get(VALUE_UID)
    v = p0.value if p0 is not None else None
    if v is None and entry is not None and entry.is_list:
        # [type] list predicate: values live at fingerprint slots; surface
        # the whole list plus the first as the compare/sort representative
        lv = sorted((p.value for p in live.values()
                     if p.value is not None and not p.lang),
                    key=lambda x: str(x.value))
        if lv:
            pd.list_values[subj] = lv
            v = lv[0]
    num: float | None = None
    if v is not None:
        pd.host_values[subj] = v
        sc = to_device_scalar(v)
        num = np.nan if sc is None else float(sc)
    had_lang = False
    for p in live.values():
        if p.value is not None and p.lang:
            pd.lang_values.setdefault(subj, {})[p.lang] = p.value
            had_lang = True
        if p.facets:
            pd.facets[(subj, p.uid)] = p.facets
    if v is None and had_lang:
        # lang-only node: still a has(attr) subject, but carries no
        # untagged value
        num = np.nan
    return False, num


def build_pred(store: Store, attr: str, read_ts: int,
               own_start_ts: int | None = None,
               device: str | torch.device = "cuda") -> PredData:
    """Fold one predicate's tablets at read_ts into a PredData whose device
    columns live on `device` (uploaded at first access).

    own_start_ts: when set, the caller's open txn's uncommitted layers are
    visible too (posting/list.go:528). Such views must not be cached."""
    return _build_pred(store, attr, read_ts, own_start_ts,
                       resolve_device(device))


def _build_pred(store: Store, attr: str, read_ts: int,
                own_start_ts: int | None, dev: torch.device) -> PredData:
    entry = store.schema.get(attr)
    tid = entry.type_id if entry else TypeID.DEFAULT
    pd = PredData(attr, tid)

    fwd_rows: list[tuple[int, np.ndarray]] = []
    val_subjects: list[int] = []
    num_vals: list[float] = []
    own = own_start_ts
    kbs = store.keys_of(K.KeyKind.DATA, attr)
    uid_typed = tid == TypeID.UID
    if uid_typed:
        # flat fold: no per-key loop at all for declared-uid predicates
        pd.csr = _fold_uid_tablet(store, kbs, read_ts, own, pd, dev,
                                  kind=int(K.KeyKind.DATA))
        kbs = []
    tablet_pls = store.tablet_lists(int(K.KeyKind.DATA), attr, kbs)
    tablet_uids = _tablet_uids(store, kbs, read_ts, own, pls=tablet_pls)
    for kb, u, pl in zip(kbs, tablet_uids, tablet_pls):
        subj = K.uid_of(kb)
        if pl is None:             # predicate dropped mid-build
            continue
        is_edge, num = _fold_value_subject(pd, entry, tid, subj, pl,
                                           read_ts, own)
        if is_edge:
            if len(u):
                fwd_rows.append((subj, u))
        elif num is not None:
            val_subjects.append(subj)
            num_vals.append(num)
    if fwd_rows:                  # non-uid-typed heuristic edges only
        pd.csr = _csr_from_rows(fwd_rows, dev)
    if val_subjects:
        order = np.argsort(np.asarray(val_subjects, dtype=np.int64))
        vs = np.asarray(val_subjects, dtype=np.int64)[order]
        if vs[-1] > MAX_DEVICE_UID:
            raise ValueError("value subject uid exceeds device uid space")
        pd.value_subjects_host = vs
        pd.num_values_host = np.asarray(num_vals, dtype=np.float64)[order]

    # reverse CSR (flat fold; facets belong to the forward tablet)
    if entry is not None and entry.reverse:
        rkbs = store.keys_of(K.KeyKind.REVERSE, attr)
        pd.rev_csr = _fold_uid_tablet(store, rkbs, read_ts, own, None, dev,
                                      kind=int(K.KeyKind.REVERSE))

    # vector index: fold the predicate's embeddings into the row-aligned
    # device matrix (+ IVF coarse quantizer past the size threshold)
    if entry is not None and entry.vector is not None:
        from dgraph_tpu_torch.storage import vecindex as vecmod

        pd.vecindex = vecmod.build_vecindex(
            attr, entry.vector, pd.host_values,
            knobs=getattr(store, "vector_knobs", None), device=dev)

    # token indexes, split per tokenizer by the 1-byte term prefix
    if entry is not None and entry.indexed:
        from dgraph_tpu_torch.utils import tok as tokmod

        by_tok: dict[str, list[tuple[bytes, np.ndarray]]] = {
            name: [] for name in entry.tokenizers}
        ident_to_name = {tokmod.get(n).ident: n for n in entry.tokenizers}
        ikbs = store.keys_of(K.KeyKind.INDEX, attr)
        ipls = store.tablet_lists(int(K.KeyKind.INDEX), attr, ikbs)
        for kb, u in zip(ikbs, _tablet_uids(store, ikbs, read_ts, own,
                                            pls=ipls)):
            key = K.parse_key(kb)
            if not key.term or not len(u):
                continue
            name = ident_to_name.get(key.term[0])
            if name is None:
                continue
            by_tok[name].append((key.term[1:], u))
        for name, rows in by_tok.items():
            pd.indexes[name] = _token_index(rows, dev)

    # residency seam: a device working-set manager attached to the store
    # adopts every device-buffer owner of this fold
    mgr = getattr(store, "residency", None)
    if mgr is not None:
        mgr.adopt_pred(pd)
    return pd


_FOLD_POOL = None
_FOLD_POOL_LOCK = threading.Lock()


def default_fold_workers() -> int:
    import os

    return max(1, min(8, (os.cpu_count() or 2) - 1))


def _fold_pool():
    """One process-wide fixed-width thread pool for parallel tablet folds
    (never resized or shut down — replacing a live pool would race other
    assemblers' submits). Folds are host numpy/native work that releases
    the GIL, and they never touch the device."""
    global _FOLD_POOL
    from concurrent.futures import ThreadPoolExecutor

    with _FOLD_POOL_LOCK:
        if _FOLD_POOL is None:
            _FOLD_POOL = ThreadPoolExecutor(
                max_workers=default_fold_workers(),
                thread_name_prefix="dgt-fold")
        return _FOLD_POOL


def _fold_attrs(store: Store, attrs: list[str], read_ts: int,
                own_start_ts: int | None, workers: int, dev: torch.device,
                metrics=None) -> list[PredData]:
    """build_pred over many attrs, through the fold pool when it pays;
    `workers` caps this call's concurrency without resizing the pool."""
    def one(a):
        t0 = time.perf_counter()
        pd = _build_pred(store, a, read_ts, own_start_ts, dev)
        _note_fold(metrics, "eager", (time.perf_counter() - t0) * 1e3)
        return pd

    if len(attrs) > 1 and workers > 1:
        pool = _fold_pool()
        sem = threading.Semaphore(workers)
        if metrics is not None:
            metrics.counter("dgraph_parallel_folds_total").inc(len(attrs))
            metrics.counter("dgraph_fold_pool_width").set(
                min(workers, default_fold_workers()))

        def run(a):
            with sem:
                return one(a)

        # dgraph: allow(ctxvar-copy) folds build SHARED snapshot state
        # cached across requests — they must not inherit any one
        # request's deadline/trace context
        futs = [pool.submit(run, a) for a in attrs]
        return [f.result() for f in futs]
    return [one(a) for a in attrs]


def build_snapshot(store: Store, read_ts: int,
                   attrs: Iterable[str] | None = None,
                   own_start_ts: int | None = None,
                   fold_workers: int | None = None,
                   lazy: bool = False,
                   device: str | torch.device = "cuda") -> GraphSnapshot:
    """Fold the store at read_ts into a GraphSnapshot on `device`. Folds run
    across the shared thread pool; fold_workers=1 forces the serial path.

    lazy=True registers every tablet as a fold-thunk instead: the first
    read of a predicate folds exactly that tablet (singleflighted),
    byte-identical to the eager fold at the same read_ts."""
    dev = resolve_device(device)
    snap = GraphSnapshot(read_ts, dev)
    todo = sorted(attrs) if attrs is not None else store.predicates()
    if lazy:
        metrics = getattr(store, "metrics", None)
        preds = LazyPreds()
        snap.preds = preds

        def bare_fold(th, trigger):
            t0 = time.perf_counter()
            pd = _build_pred(store, th.attr, th.eff, own_start_ts, dev)
            _note_fold(metrics, trigger,
                       (time.perf_counter() - t0) * 1e3)
            return pd

        for attr in todo:
            preds.register(attr, _FoldThunk(attr, read_ts, bare_fold))
        return snap
    workers = fold_workers if fold_workers is not None \
        else default_fold_workers()
    for attr, pd in zip(todo, _fold_attrs(store, todo, read_ts,
                                          own_start_ts, workers, dev)):
        snap.preds[attr] = pd
    return snap


@dataclass
class _OverlayState:
    """Book-keeping for one predicate's live overlay: the true folded base
    it stacks on (re-stamps always start from here — overlays never nest),
    its current depth in touched keys, and its birth time (age-triggered
    compaction)."""

    base_ts: int
    base_pd: PredData
    depth: int
    born: float


class SnapshotAssembler:
    """Incremental snapshot cache: per-predicate PredData reuse keyed on the
    store's per-predicate commit watermark (pred_commit_ts), plus a small
    per-read-ts snapshot cache — the read-through contract of
    posting/lists.go:243: the world is never rebuilt.

    Commit-to-visible is O(Δ): a commit whose touched keys are in the
    store's delta journal stamps the cached PredData with replacement rows
    (storage/delta.py) instead of re-folding the tablet — base device
    tensors keep identity, and only the touched subjects/terms are
    re-derived. Deep or old overlays compact back into folded bases (inline
    past OVERLAY_MAX_KEYS; off the query path via compact()).

    Every snapshot lives on `device` (default "cuda", which raises without
    CUDA)."""

    SNAP_CACHE = 4
    OVERLAY_MAX_KEYS = 512       # stamp depth ceiling: past it, fold inline
    OVERLAY_MAX_AGE_S = 30.0     # background compaction age trigger

    def __init__(self, store, on_pred_build=None, metrics=None,
                 overlay_enabled: bool = True,
                 overlay_max_keys: int | None = None,
                 overlay_max_age_s: float | None = None,
                 fold_workers: int | None = None,
                 lazy_folds: bool = True,
                 device: str | torch.device = "cuda") -> None:
        self.store = store
        self.device = resolve_device(device)
        self.on_pred_build = on_pred_build       # callback(attr) per re-fold
        self.metrics = metrics                   # optional metrics registry
        self.overlay_enabled = overlay_enabled
        if overlay_max_keys is not None:
            self.OVERLAY_MAX_KEYS = int(overlay_max_keys)
        if overlay_max_age_s is not None:
            self.OVERLAY_MAX_AGE_S = float(overlay_max_age_s)
        self.fold_workers = (fold_workers if fold_workers is not None
                             else default_fold_workers())
        # lazy on-demand folds: assembly registers fold-thunks and the first
        # read of a predicate folds exactly that tablet
        self.lazy_folds = bool(lazy_folds)
        # attr -> (built_ts, PredData, replay_seq at build)
        self._pred_cache: dict[str, tuple[int, PredData, int]] = {}
        self._overlays: dict[str, _OverlayState] = {}
        self._snaps: dict[int, GraphSnapshot] = {}
        # attr -> unresolved fold thunk, carried across assemblies while the
        # data window is unchanged so successive snapshots share one fold
        self._pending: dict[str, _FoldThunk] = {}
        self._card_hints: dict[str, int] = {}    # attr -> DATA key count
        # bumped by invalidate(): structural changes don't move
        # pred_commit_ts/pred_replay_seq, so a lazy fold in flight across an
        # alter needs its own stability check before writing _pred_cache
        self._cache_gen = 0

    def snapshot(self, read_ts: int) -> GraphSnapshot:
        """Committed view at read_ts (clamped to the newest commit: two
        read_ts above it see identical data and share the cache entry)."""
        eff = min(read_ts, self.store.max_seen_commit_ts)
        snap = self._snaps.get(eff)
        if snap is None or self._stale(snap):
            snap = self._assemble(eff)
            self._snaps[eff] = snap
            while len(self._snaps) > self.SNAP_CACHE:
                self._snaps.pop(next(iter(self._snaps)))
        return snap

    def _stale(self, snap: GraphSnapshot) -> bool:
        # A cached snapshot at read_ts is immutable under normal commits
        # (they land above read_ts). It rots only when a commit arrives
        # at/below read_ts after assembly (replication replay races): compare
        # each predicate's watermark against the value stamped at assembly,
        # and only when the new watermark is visible at this read_ts.
        stamped = getattr(snap, "pred_watermarks", None)
        replays = getattr(snap, "pred_replays", None)
        if stamped is None:
            return True
        for attr in self.store.predicates():
            pct = self.store.pred_commit_ts.get(attr, 0)
            if pct <= snap.read_ts and stamped.get(attr) != pct:
                return True               # replayed/new commit now visible
            if self.store.pred_replay_seq.get(attr, 0) != \
                    (replays or {}).get(attr, 0):
                # a commit landed below the predicate's watermark since
                # assembly: treat every cached view as suspect
                return True
        return False

    def _stamp(self, snap: GraphSnapshot) -> None:
        snap.pred_watermarks = {
            a: self.store.pred_commit_ts.get(a, 0) for a in snap.preds}
        snap.pred_replays = {
            a: self.store.pred_replay_seq.get(a, 0) for a in snap.preds}

    def _assemble(self, eff: int) -> GraphSnapshot:
        snap = GraphSnapshot(eff, self.device)
        if self.lazy_folds:
            preds = LazyPreds()
            preds.hint_fn = self._card_hint
            snap.preds = preds
        reused = 0
        todo: list[tuple[str, int, int, bool]] = []
        for attr in self.store.predicates():
            pct = self.store.pred_commit_ts.get(attr, 0)
            seq = self.store.pred_replay_seq.get(attr, 0)
            cached = self._pred_cache.get(attr)
            if cached is not None and cached[2] != seq:
                # a commit landed below the watermark after the cached fold
                # (replication replay): the cached view silently misses it
                self._pred_cache.pop(attr, None)
                self._overlays.pop(attr, None)
                cached = None
            if cached is not None and cached[0] >= pct and eff >= pct:
                # both views contain every commit to attr (all <= pct)
                snap.preds[attr] = cached[1]
                reused += 1
                continue
            pd = self._try_stamp(attr, cached, pct, seq, eff)
            if pd is not None:
                snap.preds[attr] = pd
            else:
                todo.append((attr, pct, seq, cached is not None))
        if todo and self.lazy_folds:
            # register fold-thunks instead of folding; a still-pending thunk
            # from an earlier assembly is reused while its data window
            # matches — the same both-views-complete rule as _pred_cache
            for attr, pct, seq, had_cached in todo:
                th = self._pending.get(attr)
                if th is None or not (th.eff >= pct and eff >= pct
                                      and th.seq == seq):
                    th = _FoldThunk(attr, eff, self._fold_pending,
                                    pct=pct, seq=seq, inline=had_cached)
                    if eff >= pct:
                        self._pending[attr] = th
                snap.preds.register(attr, th)
            self._set_pending_gauge()
        elif todo:
            attrs = [a for a, _p, _s, _c in todo]
            for attr, pd in zip(attrs, _fold_attrs(
                    self.store, attrs, eff, None, self.fold_workers,
                    self.device, self.metrics)):
                if self.on_pred_build is not None:
                    self.on_pred_build(attr)
                pct = self.store.pred_commit_ts.get(attr, 0)
                if eff >= pct:
                    self._pred_cache[attr] = (
                        eff, pd, self.store.pred_replay_seq.get(attr, 0))
                    self._overlays.pop(attr, None)
                    self._set_depth(attr, 0)
                    self.store.prune_delta(attr, eff)
                snap.preds[attr] = pd
        if reused and len(snap.preds) > reused and self.metrics is not None:
            self.metrics.counter(
                "dgraph_cache_invalidations_avoided_total").inc(reused)
        snap.metrics = self.metrics
        self._stamp(snap)
        return snap

    def _fold_pending(self, th: _FoldThunk, trigger: str) -> PredData:
        """On-demand fold of one registered thunk (the _FoldThunk leader
        runs this outside the claim lock) plus the cache bookkeeping of the
        eager assembly tail. pct/seq are read around the fold and the cache
        entry written only when nothing moved mid-fold, so a racing commit
        or replay can never pin a view whose delta the journal can't
        reproduce."""
        store = self.store
        gen0 = self._cache_gen
        pct0 = store.pred_commit_ts.get(th.attr, 0)
        seq0 = store.pred_replay_seq.get(th.attr, 0)
        t0 = time.perf_counter()
        pd = _build_pred(store, th.attr, th.eff, None, self.device)
        _note_fold(self.metrics, trigger, (time.perf_counter() - t0) * 1e3)
        if self.on_pred_build is not None:
            self.on_pred_build(th.attr)
        pct = store.pred_commit_ts.get(th.attr, 0)
        seq = store.pred_replay_seq.get(th.attr, 0)
        if th.eff >= pct and (pct0, seq0) == (pct, seq) \
                and gen0 == self._cache_gen:
            self._pred_cache[th.attr] = (th.eff, pd, seq)
            self._overlays.pop(th.attr, None)
            self._set_depth(th.attr, 0)
            store.prune_delta(th.attr, th.eff)
        if self._pending.get(th.attr) is th:
            self._pending.pop(th.attr, None)
        self._set_pending_gauge()
        return pd

    def _card_hint(self, attr: str) -> int:
        """DATA key count of one tablet (order decisions only, never
        results). Cached until invalidate()."""
        h = self._card_hints.get(attr)
        if h is None:
            tp = self.store.packed_tablet(int(K.KeyKind.DATA), attr)
            h = int(tp.n) if tp is not None else \
                len(self.store.keys_of(K.KeyKind.DATA, attr))
            self._card_hints[attr] = h
        return h

    def _set_pending_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.counter("dgraph_fold_pending_tablets").set(
                len(self._pending))

    def _set_depth(self, attr: str, depth: int) -> None:
        if self.metrics is not None:
            self.metrics.keyed("dgraph_overlay_depth").set(attr, depth)

    def _try_stamp(self, attr: str, cached, pct: int, seq: int,
                   eff: int) -> PredData | None:
        """O(Δ) overlay stamp of the cached PredData; None = not stampable
        (caller folds). Never stacks: re-stamps start from the true base.
        A stamp that raises becomes a fold: the answer stays right, and the
        fallback is counted on the metrics registry when there is one."""
        if not self.overlay_enabled or cached is None:
            return None
        if eff < pct or cached[0] > eff:
            return None       # old-ts view: fold it (and don't cache)
        st = self._overlays.get(attr)
        base_ts, base_pd = (st.base_ts, st.base_pd) if st is not None \
            else (cached[0], cached[1])
        dmap = self.store.delta_since(attr, base_ts)
        if dmap is None:
            return None       # journal can't prove completeness: fold
        dkeys = [kb for kb, cts in dmap.items() if cts <= eff]
        if len(dkeys) > self.OVERLAY_MAX_KEYS:
            return None       # deep overlay: inline compaction via fold
        from dgraph_tpu_torch.storage import delta as dmod

        try:
            pd = dmod.stamp_pred(self.store, attr, base_pd, eff, dkeys,
                                 device=self.device)
        except Exception:
            if self.metrics is not None:
                self.metrics.counter(
                    "dgraph_overlay_fold_fallbacks_total").inc()
            return None
        self._pred_cache[attr] = (eff, pd, seq)
        born = st.born if st is not None else time.monotonic()
        self._overlays[attr] = _OverlayState(base_ts, base_pd,
                                             len(dkeys), born)
        if self.metrics is not None:
            self.metrics.counter("dgraph_overlay_stamps_total").inc()
        self._set_depth(attr, len(dkeys))
        return pd

    # -- compaction (rollup) -------------------------------------------------

    def overlay_stats(self) -> dict[str, int]:
        """attr -> overlay depth in touched keys. Readers may race assembly,
        so retry the briefly-inconsistent iteration."""
        for _ in range(4):
            try:
                return {attr: st.depth
                        for attr, st in list(self._overlays.items())}
            except RuntimeError:
                continue
        return {}

    def overlay_bytes(self) -> int:
        """Host bytes held by live overlay rows."""
        from dgraph_tpu_torch.storage import delta as dmod

        for _ in range(4):
            try:
                return sum(dmod.overlay_nbytes(c[1])
                           for c in list(self._pred_cache.values()))
            except RuntimeError:
                continue
        return 0

    def compact_candidates(self, force: bool = False) -> list[str]:
        now = time.monotonic()
        for _ in range(4):
            try:
                return [attr for attr, st in list(self._overlays.items())
                        if force or st.depth >= self.OVERLAY_MAX_KEYS
                        or now - st.born >= self.OVERLAY_MAX_AGE_S]
            except RuntimeError:
                continue
        return []

    def compact(self, lock, attrs: list[str] | None = None,
                force: bool = False) -> int:
        """Merge overlays back into folded bases off the query path: fold
        outside `lock` at a pinned watermark, swap under `lock` only if
        nothing moved meanwhile. After a successful compaction the
        predicate's overlay is empty, the delta journal is pruned, and reads
        serve the fresh base — results unchanged. Returns the number of
        predicates compacted."""
        with lock:
            cands = (list(attrs) if attrs is not None
                     else self.compact_candidates(force=force))
            pinned = {
                attr: (self.store.pred_commit_ts.get(attr, 0),
                       self.store.pred_replay_seq.get(attr, 0))
                for attr in cands if attr in self._overlays}
        done = 0
        for attr, (ts, seq) in pinned.items():
            t0 = time.perf_counter()
            try:
                pd = _build_pred(self.store, attr, ts, None, self.device)
            except Exception:
                continue      # store moved under us: the next call retries
            with lock:
                if (self.store.pred_commit_ts.get(attr, 0),
                        self.store.pred_replay_seq.get(attr, 0)) != (ts, seq):
                    continue  # commit/replay raced the fold: retry later
                old = self._pred_cache.get(attr)
                if attr not in self._overlays:
                    continue
                self._pred_cache[attr] = (ts, pd, seq)
                self._overlays.pop(attr, None)
                self.store.prune_delta(attr, ts)
                # cached snapshots pinning the stamped view: drop them so the
                # next read reassembles over the fresh base (folded-only
                # peek: .get would fold pending tablets just to compare)
                if old is not None:
                    for k in [k for k, s in self._snaps.items()
                              if getattr(s.preds, "folded_get",
                                         s.preds.get)(attr) is old[1]]:
                        self._snaps.pop(k, None)
                done += 1
                self._set_depth(attr, 0)
                if self.metrics is not None:
                    self.metrics.counter("dgraph_compactions_total").inc()
                    self.metrics.histogram("dgraph_compaction_s").observe(
                        time.perf_counter() - t0)
        return done

    def invalidate(self) -> int:
        """Structural change (schema, drop, predicate delete): every cached
        view may be wrong — rebuild from scratch on next read. Returns the
        number of dropped cache entries."""
        n = len(self._pred_cache) + len(self._snaps)
        for attr in self._overlays:
            self._set_depth(attr, 0)
        self._pred_cache.clear()
        self._overlays.clear()
        self._snaps.clear()
        # outstanding lazy thunks (held by handed-out snapshots) still
        # resolve at their own read_ts; the generation bump keeps an
        # in-flight fold from writing its stale view back after this clear
        self._cache_gen += 1
        self._pending.clear()
        self._card_hints.clear()
        self._set_pending_gauge()
        return n

    def cache_size(self) -> int:
        return len(self._pred_cache) + len(self._snaps)


# WAL record types that change visible structure beyond the per-predicate
# commit watermark: schema lines, predicate/kind drops
STRUCTURAL_RECORDS = frozenset({"s", "dp", "dk"})
