"""Immutable graph snapshots: host CSR columns plus lazily uploaded device
columns.

Port of the snapshot types of dgraph_tpu/storage/csr_build.py: MAX_DEVICE_UID,
PredCSR, TokenIndex, PredData and GraphSnapshot, plus build_value_pred, the
value and index halves of build_pred as a fold of rows. A snapshot at read_ts
is a set of immutable per-predicate arrays; the host numpy columns are the
authoritative fold (frontier→row mapping, degree counting, recurse edge
dedup, index probes and value compares run on them), and the device columns
are a cache uploaded on first kernel access. Folding a posting Store into a
snapshot (build_pred / build_snapshot, LazyPreds, SnapshotAssembler) waits
for the storage slice; snapshots are built from numpy arrays
(carry.snapshot_from_numpy) and value rows (build_value_pred) here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.utils.types import TypeID, Val, convert, to_device_scalar

MAX_DEVICE_UID = 2**31 - 2  # int32 space, sentinel-exclusive


class PredCSR:
    """Adjacency of one predicate: row r = subjects[r] →
    indices[indptr[r]:indptr[r+1]], int32 host columns; device columns on
    `device`, uploaded at first access."""

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
        self._dev: tuple | None = None

    @property
    def num_edges(self) -> int:
        return int(self._indices_h.shape[0])

    def device_arrays(self) -> tuple:
        """(subjects, indptr, indices) as int32 tensors on self.device."""
        if self._dev is None:
            self._dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                    self.device)
                for a in (self._subjects_h, self._indptr_h,
                          self._indices_h))
        return self._dev

    @property
    def subjects(self) -> torch.Tensor:
        return self.device_arrays()[0]

    @property
    def indptr(self) -> torch.Tensor:
        return self.device_arrays()[1]

    @property
    def indices(self) -> torch.Tensor:
        return self.device_arrays()[2]

    def host_arrays(self) -> tuple:
        """(subjects, indptr, indices) as numpy — the host truth."""
        return (self._subjects_h, self._indptr_h, self._indices_h)


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
    `device` at first use (the union of many rows, task._index_uids_for_rows)."""

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

    def device_arrays(self) -> tuple:
        """(indptr, uids) as int32 tensors on self.device."""
        if self._dev is None:
            self._dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                    self.device)
                for a in (self._indptr_h, self._uids_h))
        return self._dev

    @property
    def indptr(self) -> torch.Tensor:
        return self.device_arrays()[0]

    @property
    def uids(self) -> torch.Tensor:
        return self.device_arrays()[1]

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

    def has_subjects(self) -> np.ndarray:
        """uids for has(attr): subjects with any edge or value."""
        outs = []
        if self.csr is not None:
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
