"""Live per-predicate cardinality statistics — the planner's cost model feed.

Copy of dgraph_tpu/storage/stats.py for the PyTorch port (the port's PredData
holds no vector index yet, so its vector rows read as 0).

Reference context: the reference has no cost-based planner — query.go
executes in parse order — but its badger levels DO keep per-table key
counts, and classic systems (Selinger et al.; Leis et al., "How Good Are
Query Optimizers, Really?") show cheap cardinality stats capture most of
the gap between good and bad evaluation orders. On a predicate-sharded
graph the quantities a planner needs are already sitting in the fold
outputs (storage/csr_build.PredData): the CSR host mirrors give subject
and edge counts and the exact degree distribution; every token index
gives exact per-term frequencies. This module snapshots them as a small
`PredStats` per predicate:

  * subject / edge counts and a log2 degree histogram per CSR (forward
    and reverse),
  * value-subject count and the numeric/other value-type mix,
  * per-tokenizer term counts, total postings, and a lazy top-K
    term-frequency sketch (EXPLAIN readout; point probes use the exact
    index row lengths, see `term_freq` / `range_count`).

Freshness contract: stats are cached ON the PredData / PredCSR objects
they describe. The snapshot assembler replaces those objects on any
visible change (fold or O(Δ) overlay stamp, storage/delta.py), so stats
can never describe dead data. An overlay stamp costs O(Δ): the stamped
`OverlayCSR` keeps base identity, so the base's cached stats are adjusted
by exactly the touched subjects' old/new degrees instead of recounting
the tablet — the same delta journal that drives overlay stamping drives
stats maintenance. Compaction folds a fresh base and stats recompute from
it, reconciling the deltas exactly (tests/test_stats.py asserts both).

Stats only ever steer ORDER (query/planner.py); stale or approximate
stats can cost time, never correctness.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.ops import uidset as us

HIST_BUCKETS = 32          # log2 degree buckets (degree < 2^31 by uid space)
_STATS_ATTR = "_dgt_stats"   # cache slot on PredData / PredCSR objects


@dataclass
class CSRStats:
    """Counts for one adjacency (forward or reverse CSR)."""

    n_subjects: int = 0
    n_edges: int = 0
    hist: np.ndarray = field(
        default_factory=lambda: np.zeros(HIST_BUCKETS, np.int64))
    via_delta: bool = False    # True = adjusted O(Δ) from a base's stats

    @property
    def avg_degree(self) -> float:
        return self.n_edges / self.n_subjects if self.n_subjects else 0.0


def _hist_of(deg: np.ndarray) -> np.ndarray:
    """log2-bucket histogram of a degree vector (degree >= 1)."""
    if len(deg) == 0:
        return np.zeros(HIST_BUCKETS, np.int64)
    b = np.clip(np.log2(np.maximum(deg, 1)).astype(np.int64), 0,
                HIST_BUCKETS - 1)
    return np.bincount(b, minlength=HIST_BUCKETS).astype(np.int64)


def csr_stats(csr, metrics=None) -> CSRStats:
    """Stats for a PredCSR-like, cached per object. An OverlayCSR adjusts
    its UNCHANGED base's cached stats by the delta's touched subjects —
    O(Δ), never a recount of the merged tablet."""
    if csr is None:
        return CSRStats()
    cached = getattr(csr, _STATS_ATTR, None)
    if cached is not None:
        return cached
    from dgraph_tpu_torch.storage.delta import OverlayCSR

    if isinstance(csr, OverlayCSR):
        base_st = csr_stats(csr.base, metrics)
        bs, bip, _ = csr._base_host()
        bs = np.asarray(bs, dtype=np.int64)
        bip = np.asarray(bip, dtype=np.int64)
        if len(bs) == 0:       # base-less overlay (tablet born from deltas)
            inb = np.zeros(len(csr.delta.subs), dtype=bool)
            old_deg = np.zeros(len(csr.delta.subs), dtype=np.int64)
        else:
            rb = us.host_rank_of(bs, csr.delta.subs, -1)
            inb = rb >= 0
            rc = np.clip(rb, 0, len(bip) - 2)
            old_deg = np.where(inb, bip[rc + 1] - bip[rc], 0)
        new_deg = csr.delta.lens
        hist = base_st.hist.copy()
        if inb.any():
            hist -= _hist_of(old_deg[inb])
        add = new_deg > 0
        if add.any():
            hist += _hist_of(new_deg[add])
        st = CSRStats(
            n_subjects=base_st.n_subjects - int(inb.sum()) + int(add.sum()),
            n_edges=base_st.n_edges - int(old_deg.sum())
            + int(new_deg.sum()),
            hist=hist, via_delta=True)
        if metrics is not None:
            metrics.counter("dgraph_stats_delta_updates_total").inc()
    else:
        if getattr(csr, "is_dist", False):
            # mesh-sharded tablet: device metadata only, no host recount
            st = CSRStats(n_subjects=int(csr.num_subjects),
                          n_edges=int(csr.num_edges))
        else:
            _, indptr, _ = csr.host_arrays()
            indptr = np.asarray(indptr, dtype=np.int64)
            deg = indptr[1:] - indptr[:-1]
            st = CSRStats(n_subjects=len(deg), n_edges=int(deg.sum()),
                          hist=_hist_of(deg))
        if metrics is not None:
            metrics.counter("dgraph_stats_builds_total").inc()
    try:
        setattr(csr, _STATS_ATTR, st)
    except AttributeError:     # frozen duck-type: recompute per call
        pass
    return st


@dataclass
class PredStats:
    """One predicate's planner-facing statistics at a snapshot."""

    attr: str
    type_name: str
    fwd: CSRStats
    rev: CSRStats
    value_count: int = 0
    numeric_values: int = 0    # value-type mix: numeric vs other
    lang_values: int = 0
    index_terms: dict[str, int] = field(default_factory=dict)
    index_postings: dict[str, int] = field(default_factory=dict)
    # @index(vector) predicates: embedding row count + dimensionality
    # (deliberately OUTSIDE index_terms/index_postings — the vector index
    # is not a TokenIndex and must never trip the term-sketch paths)
    vector_rows: int = 0
    vector_dim: int = 0

    @property
    def has_card(self) -> int:
        """Upper-bound cardinality of has(attr): edge subjects + value
        subjects (the exact quantity PredData.has_subjects unions)."""
        return self.fwd.n_subjects + self.value_count

    @property
    def avg_degree(self) -> float:
        return self.fwd.avg_degree

    def to_dict(self) -> dict:
        return {
            "attr": self.attr, "type": self.type_name,
            "subjects": self.fwd.n_subjects, "edges": self.fwd.n_edges,
            "avg_degree": round(self.avg_degree, 2),
            "rev_subjects": self.rev.n_subjects,
            "rev_edges": self.rev.n_edges,
            "values": self.value_count,
            "value_mix": {"numeric": self.numeric_values,
                          "other": self.value_count - self.numeric_values,
                          "lang": self.lang_values},
            "degree_hist": {f"2^{i}": int(n)
                            for i, n in enumerate(self.fwd.hist) if n},
            "index_terms": dict(self.index_terms),
            "index_postings": dict(self.index_postings),
            "via_delta": self.fwd.via_delta,
            **({"vector": {"rows": self.vector_rows,
                           "dim": self.vector_dim}}
               if self.vector_rows else {}),
        }


def pred_stats(pd, metrics=None) -> PredStats:
    """PredStats for one PredData, cached per object. The assembler
    replaces PredData on any visible change (and the CSR sub-stats ride
    the delta path when the change was an overlay stamp), so a cache hit
    is always current."""
    cached = getattr(pd, _STATS_ATTR, None)
    if cached is not None:
        return cached
    vs = pd.value_subjects_host
    nv = pd.num_values_host
    vi = getattr(pd, "vecindex", None)
    st = PredStats(
        attr=pd.attr,
        type_name=pd.type_id.name,
        fwd=csr_stats(pd.csr, metrics),
        rev=csr_stats(pd.rev_csr, metrics),
        value_count=0 if vs is None else len(vs),
        numeric_values=0 if nv is None
        else int(np.count_nonzero(~np.isnan(nv))),
        lang_values=len(pd.lang_values),
        index_terms={name: len(ti.terms)
                     for name, ti in pd.indexes.items()},
        index_postings={
            name: int(np.asarray(ti.host_arrays()[0])[-1])
            if len(ti.terms) else 0
            for name, ti in pd.indexes.items()},
        vector_rows=0 if vi is None else int(vi.n),
        vector_dim=0 if vi is None else int(vi.dim),
    )
    pd.__dict__[_STATS_ATTR] = st
    return st


# ---------------------------------------------------------------------------
# exact index probes (the planner's point estimates)
# ---------------------------------------------------------------------------

def term_freq(ti, term: bytes) -> int:
    """Exact uid count of one token row (0 = absent). O(log T)."""
    r = ti.term_row(term)
    if r < 0:
        return 0
    indptr = np.asarray(ti.host_arrays()[0], dtype=np.int64)
    return int(indptr[r + 1] - indptr[r])


def range_count(ti, op: str, token: bytes) -> int:
    """Exact candidate count of an inequality over a SORTABLE tokenizer:
    the postings between the range's bucket bounds (worker/tokens.go:124
    getInequalityTokens, counted instead of walked). O(log T)."""
    indptr = np.asarray(ti.host_arrays()[0], dtype=np.int64)
    i = bisect.bisect_left(ti.terms, token)
    if op == "eq":
        lo, hi = i, i + 1 if (i < len(ti.terms) and ti.terms[i] == token) \
            else i
    elif op in ("lt", "le"):
        lo = 0
        hi = (i if op == "lt" and i < len(ti.terms)
              and ti.terms[i] == token
              else bisect.bisect_right(ti.terms, token))
    elif op in ("gt", "ge"):
        hi = len(ti.terms)
        lo = i if op == "ge" else bisect.bisect_right(ti.terms, token)
    else:
        return 0
    lo = min(lo, len(ti.terms))
    hi = min(hi, len(ti.terms))
    if hi <= lo:
        return 0
    return int(indptr[hi] - indptr[lo])


def topk_terms(ti, k: int = 8) -> list[tuple[str, int]]:
    """Top-K most frequent terms of one token index (EXPLAIN / ops
    readout), cached per index object. Vectorized argpartition over the
    row-length column."""
    cache = getattr(ti, "_dgt_topk", None)
    if cache is not None and cache[0] >= k:
        return cache[1][:k]
    indptr = np.asarray(ti.host_arrays()[0], dtype=np.int64)
    lens = indptr[1:] - indptr[:-1]
    if len(lens) == 0:
        out: list[tuple[str, int]] = []
    else:
        kk = min(k, len(lens))
        idx = np.argpartition(lens, -kk)[-kk:]
        idx = idx[np.argsort(-lens[idx], kind="stable")]
        out = [(ti.terms[int(i)].decode("utf-8", "replace"),
                int(lens[int(i)])) for i in idx]
    try:
        ti._dgt_topk = (k, out)
    except AttributeError:
        pass
    return out


def snapshot_stats(snap, metrics=None, top_k: int = 0) -> dict:
    """Whole-snapshot stats readout ({attr: PredStats dict}) — the
    /debug/metrics "stats" section and the EXPLAIN header. Lazy
    snapshots report FOLDED tablets only: a debug scrape must never
    trigger the folds the lazy cold path exists to defer."""
    out = {}
    items = getattr(snap.preds, "folded_items", snap.preds.items)()
    for attr, pd in sorted(items):
        d = pred_stats(pd, metrics).to_dict()
        if top_k:
            d["top_terms"] = {name: topk_terms(ti, top_k)
                              for name, ti in pd.indexes.items()}
        out[attr] = d
    return out
