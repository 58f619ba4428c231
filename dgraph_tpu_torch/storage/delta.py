"""Incremental delta-overlay posting maintenance: O(Δ) commit-to-visible.

Port of dgraph_tpu/storage/delta.py. Reference semantics: the reference
never rebuilds the world on a write — a posting list is an immutable packed
base plus a mutable delta layer merged at read time (posting/lists.go:243
read-through, posting/mvcc.go), compacted by background rollups. Here the
delta-main split lives at snapshot granularity:

  * A commit's touched keys land in the store's per-predicate delta journal
    (storage/store.py `delta_since`). The SnapshotAssembler stamps a cached
    PredData with the journal delta instead of re-folding: replacement rows
    for exactly the touched subjects, computed from each key's own layer
    stack at read_ts — cost O(Δ), not O(tablet).
  * `OverlayCSR` = unchanged base `PredCSR` (device tensors keep identity —
    no re-fold, no re-upload) + sorted replacement rows for the touched
    subjects. The hot expand path patches per frontier slot
    (query/task._expand_overlay: host gather, or ops/csr.expand_masked on
    the base's device tensors); cold consumers (the pull-BFS prep, sorts)
    see lazily merged mirrors.
  * Token indexes and value tables patch the same way: touched terms /
    subjects are re-derived, everything else is shared by reference with
    the base PredData.
  * A size/age threshold triggers compaction (csr_build.SnapshotAssembler.
    compact): the overlay folds into a fresh base off the query path.

Byte-identity contract: a stamped PredData must be indistinguishable from a
from-scratch `build_pred` at the same read_ts. Replacement rows use the
exact same per-key fold (`PostingList.uids` / csr_build's shared
`_fold_value_subject`), so the contract holds by construction.

Everything here is host numpy; device tensors appear only where a merged
view uploads at first device access (OverlayCSR._merged_device,
LazyTokenIndex.device_arrays), on the device of the snapshot.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from dgraph_tpu_torch.ops import uidset as us
from dgraph_tpu_torch.storage import keys as K
from dgraph_tpu_torch.utils.types import TypeID

_EMPTY64 = np.zeros(0, np.int64)


class OverlayRows:
    """Replacement rows for the touched subjects of one (kind, attr) CSR:
    subject -> its complete sorted uid row at read_ts (empty = all edges
    gone). Replacement (not add/del sets) keeps DEL_ALL, re-adds, and
    mixed-op layers correct with one code path — the row is re-derived from
    the key's own layer stack, which is O(that key), not O(tablet)."""

    __slots__ = ("subs", "rows", "lens")

    def __init__(self, subs: np.ndarray, rows: list[np.ndarray]) -> None:
        self.subs = np.asarray(subs, dtype=np.int64)      # sorted, unique
        self.rows = rows
        self.lens = np.fromiter((len(r) for r in rows), np.int64,
                                count=len(rows))

    @property
    def depth(self) -> int:
        return len(self.rows)

    def nbytes(self) -> int:
        return int(self.subs.nbytes + self.lens.nbytes +
                   sum(r.nbytes for r in self.rows))


def overlay_rows(store, kbs: list[bytes], read_ts: int) -> OverlayRows:
    """Build replacement rows for a delta's DATA/REVERSE keys at read_ts."""
    from dgraph_tpu_torch.storage.csr_build import MAX_DEVICE_UID

    pairs = sorted((K.uid_of(kb), kb) for kb in kbs)
    subs = np.asarray([s for s, _ in pairs], dtype=np.int64)
    rows = []
    for subj, kb in pairs:
        pl = store.lists.get(kb)
        u = pl.uids(read_ts) if pl is not None else _EMPTY64
        if len(u) and int(u[-1]) > MAX_DEVICE_UID:
            raise ValueError("object uid exceeds device uid space")
        rows.append(u)
    if len(subs) and int(subs[-1]) > MAX_DEVICE_UID:
        raise ValueError(f"uid {subs[-1]} exceeds device uid space")
    return OverlayRows(subs, rows)


class OverlayCSR:
    """PredCSR view = immutable base + replacement rows for touched
    subjects. Duck-types PredCSR:

      * `.base` keeps the original device tensors untouched (identity across
        overlay-only commits — the no-re-upload contract).
      * `subjects_host()` / `subjects_degrees_host()` merge subjects and
        degrees only — O(N) vectorized, no edge copy (has(), count()).
      * `host_arrays()` lazily materializes fully merged host mirrors (the
        pull-BFS prep, recurse seed mapping, sorts).
      * `.subjects/.indptr/.indices` / `device_arrays()` lazily upload a
        merged PredCSR on `device` for device consumers; compaction soon
        replaces the overlay, so this is a transient cost.
      * the hot expand path never touches the merged mirrors:
        `frontier_plan` hands task._expand_overlay a per-slot patch plan.
      * `_pull_graph` caches the pull-BFS layout like any CSR
        (ops/pull_bfs.pull_graph_for).

    `device` is the base's; a base-less overlay (a tablet born from deltas)
    takes the snapshot's."""

    # residency owner protocol (storage/residency.py): the overlay's
    # merged device view is the droppable buffer group; the base PredCSR
    # is adopted separately and keeps its own entry
    _res = None
    _res_attr = ""
    _res_kind = "csr:merged"

    def __init__(self, base, delta: OverlayRows,
                 device: str | torch.device | None = None) -> None:
        # stacking overlays would hide the true base: the assembler always
        # re-stamps from the folded PredData, so `base` is plain (or None)
        assert not isinstance(base, OverlayCSR)
        if base is None and device is None:
            raise ValueError("a base-less overlay needs a device")
        self.base = base
        self.delta = delta
        self.device = base.device if base is not None \
            else torch.device(device)
        self._subs_deg = None          # merged (subjects, degrees)
        self._merged_host = None       # merged (subjects, indptr, indices)
        self._merged_dev = None        # merged PredCSR on self.device

    # -- base mirrors --------------------------------------------------------

    def _base_host(self):
        if self.base is None:
            return (_EMPTY64, np.zeros(1, np.int64), _EMPTY64)
        return self.base.host_arrays()

    # -- merged subject/degree view (O(N), no edge copy) ---------------------

    def subjects_degrees_host(self) -> tuple[np.ndarray, np.ndarray]:
        if self._subs_deg is None:
            bs, bip, _ = self._base_host()
            bs = np.asarray(bs, dtype=np.int64)
            deg_b = (np.asarray(bip[1:], np.int64)
                     - np.asarray(bip[:-1], np.int64))
            rb = us.host_rank_of(bs, self.delta.subs, -1)
            keep = np.ones(len(bs), dtype=bool)
            keep[rb[rb >= 0]] = False
            add = self.delta.lens > 0          # empty rows fall out of the CSR
            subs = np.concatenate([bs[keep], self.delta.subs[add]])
            degs = np.concatenate([deg_b[keep], self.delta.lens[add]])
            order = np.argsort(subs, kind="stable")
            self._subs_deg = (subs[order], degs[order])
        return self._subs_deg

    def subjects_host(self) -> np.ndarray:
        return self.subjects_degrees_host()[0]

    @property
    def num_subjects(self) -> int:
        return len(self.subjects_host())

    @property
    def num_edges(self) -> int:
        return int(self.subjects_degrees_host()[1].sum())

    def approx_nbytes(self) -> int:
        base = self.base.host_nbytes() if self.base is not None else 0
        return base + self.delta.nbytes()

    # -- hot-path merge plan (task._expand_overlay) --------------------------

    def frontier_plan(self, uids: np.ndarray):
        """Per-frontier-slot merge plan: (base rows with touched slots
        masked to SENTINEL32, overlay row index or -1, base degree, overlay
        degree). O(|frontier| log N + Δ) — never materializes the merge."""
        bs, bip, _ = self._base_host()
        ro = us.host_rank_of(self.delta.subs, uids, -1)
        touched = ro >= 0
        if len(bs) == 0:        # base-less overlay (tablet born from deltas)
            rb = np.full(len(uids), us.SENTINEL32, np.int32)
            deg_b = np.zeros(len(uids), np.int64)
        else:
            rb = us.host_rank_of(bs, uids, us.SENTINEL32).astype(np.int32)
            rb = np.where(touched, us.SENTINEL32, rb).astype(np.int32)
            rc = np.clip(rb, 0, len(bip) - 2)
            bip = np.asarray(bip, dtype=np.int64)
            deg_b = np.where(rb != us.SENTINEL32, bip[rc + 1] - bip[rc], 0)
        lens = self.delta.lens
        lc = np.clip(ro, 0, max(len(lens) - 1, 0))
        deg_o = np.where(touched, lens[lc] if len(lens) else 0, 0)
        return rb, ro, deg_b.astype(np.int64), deg_o.astype(np.int64)

    # -- fully merged mirrors (cold consumers) -------------------------------

    def host_arrays(self):
        if self._merged_host is None:
            bs, bip, bix = self._base_host()
            bs = np.asarray(bs, dtype=np.int64)
            bip = np.asarray(bip, dtype=np.int64)
            bix = np.asarray(bix, dtype=np.int64)
            rb = us.host_rank_of(bs, self.delta.subs, -1)
            keep = np.ones(len(bs), dtype=bool)
            keep[rb[rb >= 0]] = False
            add = self.delta.lens > 0
            ov_rows = [r for r, a in zip(self.delta.rows, add) if a]
            ov_flat = (np.concatenate(ov_rows).astype(np.int64)
                       if ov_rows else _EMPTY64)
            ov_starts = np.zeros(len(ov_rows), np.int64)
            if ov_rows:
                np.cumsum(self.delta.lens[add][:-1], out=ov_starts[1:])
            src = np.concatenate([bix, ov_flat])
            subs = np.concatenate([bs[keep], self.delta.subs[add]])
            counts = np.concatenate(
                [bip[1:][keep] - bip[:-1][keep], self.delta.lens[add]])
            starts = np.concatenate([bip[:-1][keep], len(bix) + ov_starts])
            order = np.argsort(subs, kind="stable")
            subs, counts, starts = subs[order], counts[order], starts[order]
            indptr = np.zeros(len(subs) + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            total = int(indptr[-1])
            idx = (np.repeat(starts - indptr[:-1], counts)
                   + np.arange(total, dtype=np.int64))
            self._merged_host = (subs, indptr, src[idx])
        return self._merged_host

    def _merged_device(self):
        """The merged CSR as a PredCSR on the base's device, built at first
        device access (on the reading thread)."""
        if self._merged_dev is None:
            from dgraph_tpu_torch.storage import residency as resmod
            from dgraph_tpu_torch.storage.csr_build import PredCSR

            def build():
                subs, indptr, indices = self.host_arrays()
                return PredCSR(subs.astype(np.int32),
                               indptr.astype(np.int32),
                               indices.astype(np.int32), self.device)

            resmod.ensure_device(self, "_merged_dev", build)
        return self._merged_dev

    def device_arrays(self) -> tuple:
        return self._merged_device().device_arrays()

    def device_resident(self) -> bool:
        return self._merged_dev is not None

    def drop_device(self) -> None:
        self._merged_dev = None

    def device_nbytes(self) -> int:
        return self.approx_nbytes()

    def prefer_host(self) -> bool:
        from dgraph_tpu_torch.storage import residency as resmod

        # the hot expand path merges on read against the base's device
        # tensors: the overlay defers to the base's tier for that decision
        if self.base is not None:
            return self.base.prefer_host()
        return resmod.prefer_host(self)

    @property
    def subjects(self) -> torch.Tensor:
        return self._merged_device().subjects

    @property
    def indptr(self) -> torch.Tensor:
        return self._merged_device().indptr

    @property
    def indices(self) -> torch.Tensor:
        return self._merged_device().indices


def csr_subjects_host(csr) -> np.ndarray:
    """Host-side subject uids of a PredCSR-like, without forcing an overlay
    edge merge (int64)."""
    f = getattr(csr, "subjects_host", None)
    if f is not None:
        return f()
    return np.asarray(csr.host_arrays()[0], dtype=np.int64)


def csr_subjects_degrees(csr) -> tuple[np.ndarray, np.ndarray]:
    """(subjects, out-degrees) of a PredCSR-like — the count-index base
    quantity — without forcing an overlay edge merge."""
    f = getattr(csr, "subjects_degrees_host", None)
    if f is not None:
        return f()
    s, ip, _ = csr.host_arrays()
    ip = np.asarray(ip, dtype=np.int64)
    return np.asarray(s, dtype=np.int64), ip[1:] - ip[:-1]


class LazyTokenIndex:
    """TokenIndex duck-type over merged host columns: the terms list and
    host mirrors are exact at stamp time (inequality walks, sorts, and the
    host union path never touch the device); the int32 device columns
    upload to `device` at the first large union, through the residency
    seam when a manager is attached."""

    _res = None
    _res_attr = ""
    _res_kind = "index:merged"

    def __init__(self, terms: list[bytes], indptr: np.ndarray,
                 uids: np.ndarray,
                 device: str | torch.device) -> None:
        self.terms = terms
        self.device = torch.device(device)
        self._indptr_h = indptr.astype(np.int64)
        self._uids_h = uids.astype(np.int64)
        self._dev = None

    def term_row(self, term: bytes) -> int:
        i = bisect.bisect_left(self.terms, term)
        return i if i < len(self.terms) and self.terms[i] == term else -1

    def host_arrays(self):
        return self._indptr_h, self._uids_h

    def device_resident(self) -> bool:
        return self._dev is not None

    def drop_device(self) -> None:
        self._dev = None

    def device_nbytes(self) -> int:
        # int32 device columns (half the int64 host mirror width)
        return int(self._indptr_h.nbytes + self._uids_h.nbytes) // 2

    def host_nbytes(self) -> int:
        return int(self._indptr_h.nbytes + self._uids_h.nbytes)

    def prefer_host(self) -> bool:
        from dgraph_tpu_torch.storage import residency as resmod

        return resmod.prefer_host(self)

    def device_arrays(self, prefetch: bool = False) -> tuple:
        """(indptr, uids) as int32 tensors on self.device."""
        from dgraph_tpu_torch.storage import residency as resmod

        return resmod.ensure_device(
            self, "_dev",
            lambda: tuple(
                torch.from_numpy(a.astype(np.int32)).to(self.device)
                for a in (self._indptr_h, self._uids_h)),
            prefetch=prefetch)

    @property
    def indptr(self) -> torch.Tensor:
        return self.device_arrays()[0]

    @property
    def uids(self) -> torch.Tensor:
        return self.device_arrays()[1]


def merge_token_index(base, patches: dict[bytes, np.ndarray],
                      device: str | torch.device):
    """base TokenIndex + {term: replacement uid row} -> merged index.
    Empty replacement rows delete the term (build_pred never emits empty
    index rows); unknown terms insert. O(T + rows) vectorized."""
    if base is not None:
        b_terms = list(base.terms)
        b_indptr, b_uids = base.host_arrays()
        b_indptr = np.asarray(b_indptr, dtype=np.int64)
        b_uids = np.asarray(b_uids, dtype=np.int64)
    else:
        b_terms, b_indptr, b_uids = [], np.zeros(1, np.int64), _EMPTY64
    keep = np.ones(len(b_terms), dtype=bool)
    inserts: list[tuple[bytes, np.ndarray]] = []
    for term in patches:
        i = bisect.bisect_left(b_terms, term)
        if i < len(b_terms) and b_terms[i] == term:
            keep[i] = False
        row = patches[term]
        if len(row):
            inserts.append((term, np.asarray(row, dtype=np.int64)))
    inserts.sort(key=lambda t: t[0])
    kept_idx = np.flatnonzero(keep)
    terms = [b_terms[i] for i in kept_idx] + [t for t, _ in inserts]
    counts = np.concatenate(
        [b_indptr[kept_idx + 1] - b_indptr[kept_idx],
         np.asarray([len(r) for _, r in inserts], dtype=np.int64)])
    ins_flat = (np.concatenate([r for _, r in inserts])
                if inserts else _EMPTY64)
    ins_starts = np.zeros(len(inserts), np.int64)
    if inserts:
        np.cumsum(counts[len(kept_idx):][:-1], out=ins_starts[1:])
    starts = np.concatenate([b_indptr[kept_idx], len(b_uids) + ins_starts])
    order = np.argsort(np.array(terms, dtype=object), kind="stable") \
        if terms else np.zeros(0, np.int64)
    terms = [terms[i] for i in order]
    counts, starts = counts[order], starts[order]
    indptr = np.zeros(len(terms) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    total = int(indptr[-1])
    idx = (np.repeat(starts - indptr[:-1], counts)
           + np.arange(total, dtype=np.int64))
    src = np.concatenate([b_uids, ins_flat])
    return LazyTokenIndex(terms, indptr, src[idx] if total else _EMPTY64,
                          device)


# ---------------------------------------------------------------------------
# the stamp: cached PredData + journal delta -> patched PredData
# ---------------------------------------------------------------------------

def stamp_pred(store, attr: str, base_pd, read_ts: int,
               dkeys: list[bytes], device: str | torch.device):
    """Patch a folded PredData with a commit delta at read_ts — O(Δ).

    base_pd must be a plain fold (never itself stamped — the assembler
    re-stamps from the true base so overlays never stack). Untouched state
    is shared by reference with base_pd; every touched subject/term is
    re-derived with the exact logic build_pred uses, so the result is
    byte-identical to a from-scratch fold at read_ts. Raises on shapes the
    stamp can't express (the caller falls back to the full fold). `device`
    is the snapshot's: a base-less overlay and merged token indexes live
    there."""
    from dgraph_tpu_torch.storage import csr_build as cb

    entry = store.schema.get(attr)
    tid = entry.type_id if entry else TypeID.DEFAULT
    if tid != base_pd.type_id:
        raise ValueError("schema type changed under the overlay")

    data_k: list[bytes] = []
    rev_k: list[bytes] = []
    idx_k: list[bytes] = []
    for kb in dkeys:
        kind = kb[0]
        if kind == int(K.KeyKind.DATA):
            data_k.append(kb)
        elif kind == int(K.KeyKind.REVERSE):
            rev_k.append(kb)
        elif kind == int(K.KeyKind.INDEX):
            idx_k.append(kb)
        # COUNT buckets are implicit in the CSR (degree) — nothing to patch

    pd = cb.PredData(attr, tid)
    # share everything by reference; touched pieces are replaced below
    pd.csr = base_pd.csr
    pd.rev_csr = base_pd.rev_csr
    pd.value_subjects_host = base_pd.value_subjects_host
    pd.num_values_host = base_pd.num_values_host
    pd.host_values = base_pd.host_values
    pd.list_values = base_pd.list_values
    pd.lang_values = base_pd.lang_values
    pd.facets = base_pd.facets
    pd.indexes = base_pd.indexes
    pd.vecindex = base_pd.vecindex

    if data_k:
        _stamp_data(store, pd, base_pd, entry, tid, data_k, read_ts, device)
    if rev_k:
        if entry is not None and entry.reverse:
            base = base_pd.rev_csr
            if isinstance(base, OverlayCSR):
                raise ValueError("stacked overlay")
            pd.rev_csr = OverlayCSR(base, overlay_rows(store, rev_k, read_ts),
                                    device)
    if idx_k:
        _stamp_indexes(store, pd, base_pd, entry, idx_k, read_ts, device)
    # residency seam: new owners a stamp minted (merged views) adopt; base
    # objects keep their entries — the no-re-upload contract
    mgr = getattr(store, "residency", None)
    if mgr is not None:
        mgr.adopt_pred(pd)
    return pd


def _stamp_data(store, pd, base_pd, entry, tid, data_k, read_ts,
                device) -> None:
    """Patch the forward CSR + value tables for the delta's DATA keys."""
    from dgraph_tpu_torch.storage import csr_build as cb

    if isinstance(base_pd.csr, OverlayCSR):
        raise ValueError("stacked overlay")
    pairs = sorted((K.uid_of(kb), kb) for kb in data_k)
    touched = np.asarray([s for s, _ in pairs], dtype=np.int64)
    touched_set = set(touched.tolist())

    uid_typed = tid == TypeID.UID
    value_side = not uid_typed     # DEFAULT predicates may carry either
    if value_side:
        pd.host_values = {u: v for u, v in base_pd.host_values.items()
                          if u not in touched_set}
        pd.list_values = {u: v for u, v in base_pd.list_values.items()
                          if u not in touched_set}
        pd.lang_values = {u: v for u, v in base_pd.lang_values.items()
                          if u not in touched_set}
    if base_pd.facets:
        pd.facets = {k: v for k, v in base_pd.facets.items()
                     if k[0] not in touched_set}
    else:
        pd.facets = {}

    edge_rows: list[np.ndarray] = []
    val_entries: dict[int, float] = {}      # subj -> num mirror value
    for subj, kb in pairs:
        pl = store.lists.get(kb)
        if pl is None:
            edge_rows.append(_EMPTY64)
            continue
        u = pl.uids(read_ts)
        if uid_typed:
            # the flat fold's facet capture: only lists carrying postings
            if pl.base_postings or pl.layers or pl.uncommitted:
                for p in pl.live_map(read_ts).values():
                    if p.facets:
                        pd.facets[(int(subj), p.uid)] = p.facets
            edge_rows.append(u)
            continue
        is_edge, num = cb._fold_value_subject(
            pd, entry, tid, int(subj), pl, read_ts, None)
        if is_edge:
            edge_rows.append(u)
        else:
            edge_rows.append(_EMPTY64)     # value subject: no CSR row
            if num is not None:
                val_entries[int(subj)] = num

    if len(touched) and int(touched[-1]) > cb.MAX_DEVICE_UID:
        raise ValueError(f"uid {touched[-1]} exceeds device uid space")
    for r in edge_rows:
        if len(r) and int(r[-1]) > cb.MAX_DEVICE_UID:
            raise ValueError("object uid exceeds device uid space")

    rows = OverlayRows(touched, edge_rows)
    if base_pd.csr is not None or rows.lens.any():
        pd.csr = OverlayCSR(base_pd.csr, rows, device)

    if value_side:
        _patch_value_arrays(pd, base_pd, touched, val_entries)
        if entry is not None and entry.vector is not None:
            # vector-index overlay: replacement embedding rows for exactly
            # the touched subjects (the base matrix keeps device identity —
            # commit-to-visible costs O(Δ), never a re-fold/re-upload)
            from dgraph_tpu_torch.storage import vecindex as vecmod

            base_vi = base_pd.vecindex
            if base_vi is not None and base_vi.is_overlay:
                raise ValueError("stacked overlay")
            pd.vecindex = vecmod.stamp_vecindex(
                base_vi, entry.predicate, entry.vector, touched,
                pd.host_values)


def _patch_value_arrays(pd, base_pd, touched: np.ndarray,
                        val_entries: dict[int, float]) -> None:
    """Splice the touched subjects into the sorted value tables (host
    mirrors: value compares run on the float64 host mirror, never on the
    device). The port's PredData has no float32 device mirror, so only the
    host fields are set."""
    from dgraph_tpu_torch.storage.csr_build import MAX_DEVICE_UID

    vs = base_pd.value_subjects_host
    nv = base_pd.num_values_host
    if vs is None:
        vs, nv = _EMPTY64, np.zeros(0, np.float64)
    rb = us.host_rank_of(vs, touched, -1)
    keep = np.ones(len(vs), dtype=bool)
    keep[rb[rb >= 0]] = False
    add_subs = np.asarray(sorted(val_entries), dtype=np.int64)
    add_nums = np.asarray([val_entries[int(s)] for s in add_subs],
                          dtype=np.float64)
    new_vs = np.concatenate([vs[keep], add_subs])
    new_nv = np.concatenate([nv[keep], add_nums])
    order = np.argsort(new_vs, kind="stable")
    new_vs, new_nv = new_vs[order], new_nv[order]
    if len(new_vs) == 0:
        pd.value_subjects_host = None
        pd.num_values_host = None
        return
    if int(new_vs[-1]) > MAX_DEVICE_UID:
        raise ValueError("value subject uid exceeds device uid space")
    pd.value_subjects_host = new_vs
    pd.num_values_host = new_nv


def _stamp_indexes(store, pd, base_pd, entry, idx_k, read_ts,
                   device) -> None:
    """Patch touched token rows of each tokenizer's index."""
    from dgraph_tpu_torch.utils import tok as tokmod

    if entry is None or not entry.indexed:
        return          # index keys without schema index: nothing visible
    ident_to_name = {tokmod.get(n).ident: n for n in entry.tokenizers}
    per_tok: dict[str, dict[bytes, np.ndarray]] = {}
    for kb in idx_k:
        key = K.parse_key(kb)
        if not key.term:
            continue
        name = ident_to_name.get(key.term[0])
        if name is None:
            continue     # stale tokenizer ident (a schema change rebuilds)
        pl = store.lists.get(kb)
        u = pl.uids(read_ts) if pl is not None else _EMPTY64
        per_tok.setdefault(name, {})[key.term[1:]] = u
    if not per_tok:
        return
    pd.indexes = dict(base_pd.indexes)
    for name, patches in per_tok.items():
        pd.indexes[name] = merge_token_index(
            base_pd.indexes.get(name), patches, device)


def overlay_nbytes(pd) -> int:
    """Host bytes attributable to a stamped PredData's overlay state."""
    n = 0
    for csr in (pd.csr, pd.rev_csr):
        if isinstance(csr, OverlayCSR):
            n += csr.delta.nbytes()
    vi = getattr(pd, "vecindex", None)
    if vi is not None and getattr(vi, "is_overlay", False):
        n += vi.nbytes()
    return n
