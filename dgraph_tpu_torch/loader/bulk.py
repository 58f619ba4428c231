"""Offline bulk loader: RDF(.gz) → packed posting snapshot, WAL bypassed.

Port of dgraph_tpu/loader/bulk.py (host code only: no device is touched).
Its output directory is the JAX package's format, byte for byte, so either
package's Store opens the other's.

Reference semantics: dgraph/cmd/bulk — a local map/shuffle/reduce:
  map    (mapper.go:121)  parallel RDF chunk parse → (key, posting) entries
  shuffle (shuffle.go)    group by predicate
  reduce (reduce.go:36)   k-way merge per key → bp128-packed PostingList
                          written straight to badger SSTs (no Raft/WAL)
plus xidmap for node names and a schema file.

Redesign: the reduce target is this package's packed SoA posting format
(storage/packed.py) installed as PostingList bases at one commit_ts, with
token/reverse/count indexes built directly from numpy-grouped edge arrays —
then one `Store.checkpoint` makes the snapshot durable. A `Node` opened on
the output dir serves queries immediately (uid lease + ts recovery are the
normal restart path, api/server.py Node.__init__).

Two reduce tiers share one map stage and one snapshot writer:

  - in-RAM (default): all parsed columns group in dicts, one vectorized
    pack, `bulk_install` + `Store.checkpoint` — fastest when the dataset
    fits in host memory.
  - OUT-OF-CORE (`spill_mb`): mapped edges spill as sorted per-predicate
    runs (ingest/spill.py, the reference's mapper.go:121-175 shape), a
    streaming k-way merge feeds the reduce, and packed rows stream
    straight into DGTS3 tablet sections (ingest/snapwrite.py) — peak RAM
    is the spill budget + merge buffers, independent of graph size, and
    the output is BYTE-IDENTICAL to the in-RAM path.
"""

from __future__ import annotations

import gzip
import json
import os
import pickle
import shutil
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

import numpy as np

from dgraph_tpu_torch.coord.zero import UidLease
from dgraph_tpu_torch.ingest import spill as _spill
from dgraph_tpu_torch.ingest.snapwrite import SnapshotWriter
from dgraph_tpu_torch.loader.xidmap import XidMap
from dgraph_tpu_torch.storage import keys as K
from dgraph_tpu_torch.storage import native
from dgraph_tpu_torch.storage.index import index_tokens
from dgraph_tpu_torch.storage.postings import (Op, Posting, PostingList, lang_uid,
                                         value_fingerprint)
from dgraph_tpu_torch.storage.store import Store, posting_to_json
from dgraph_tpu_torch.utils import log
from dgraph_tpu_torch.utils.schema import parse_schema
from dgraph_tpu_torch.utils.types import TypeID, Val, convert


def _check_vector_dim(entry, v, attr: str, s: int) -> None:
    """float32vector literal vs the schema's @index(vector(dim: D)) —
    reject the load with a typed error instead of folding a ragged row
    (NaN components were already rejected at parse, types.parse_vector)."""
    if v.tid == TypeID.VECTOR and entry.vector is not None and \
            len(v.value) != entry.vector.dim:
        raise BulkError(
            f"predicate <{attr}>, subject 0x{s:x}: vector dimension "
            f"{len(v.value)} != schema dim {entry.vector.dim}")


class BulkError(ValueError):
    pass


@dataclass
class BulkStats:
    edges: int = 0            # total postings written (uid + value)
    uid_edges: int = 0
    values: int = 0
    nodes: int = 0            # distinct subjects
    predicates: int = 0
    xids: int = 0             # mapped external ids
    seconds: float = 0.0
    # out-of-core tier (spill_mb): ingest observability satellite
    spill_bytes: int = 0      # bytes written to sorted run files
    spill_runs: int = 0       # run files written
    merge_fanin: int = 0      # max runs k-way-merged for one channel
    buffered_peak: int = 0    # max in-RAM map-buffer estimate
    xidmap_hit_rate: float = 1.0


CHUNK_LINES = 65536


def _parse_chunk(payload: bytes) -> bytes:
    """Worker: parse one text chunk → pickled column lists (spawn-safe:
    a parse worker is pure-CPU string work and never touches the device).

    Columns instead of NQuad objects: unpickling a million dataclasses in
    the parent dominated load time (~40s/M); flat str/None lists unpickle
    ~8x faster (the map/reduce handoff of mapper.go is also a flat
    MapEntry stream, not parsed structs)."""
    from dgraph_tpu_torch.query import rdf
    from dgraph_tpu_torch.utils.types import TypeID, Val

    subs, preds, objs, vals, langs, facets, stars = [], [], [], [], [], [], []
    for line in payload.decode("utf-8").splitlines():
        # fast path for the dominant bulk shape `<s> <p> <o> .` / blank nodes
        # with no literals/facets — 3-4x the full-grammar regex
        if '"' not in line and "(" not in line:
            parts = line.split()
            if (len(parts) == 4 and parts[3] == "."
                    and parts[0][0] in "<_" and parts[1][0] == "<"
                    and parts[2][0] in "<_"):
                subs.append(parts[0][1:-1] if parts[0][0] == "<" else parts[0])
                preds.append(parts[1][1:-1])
                objs.append(parts[2][1:-1] if parts[2][0] == "<" else parts[2])
                vals.append(None)
                langs.append("")
                facets.append(None)
                stars.append(False)
                continue
            if not line.strip() or line.lstrip().startswith("#"):
                continue
        elif "(" not in line and "\\" not in line and line.count('"') == 2:
            # fast path for plain string literals `<s> <p> "text" .` (no
            # escapes/lang/type/facets) — the other dominant bulk shape
            lq = line.index('"')
            rq = line.rindex('"')
            head = line[:lq].split()
            tail = line[rq + 1:].split()
            if (len(head) == 2 and tail == ["."]
                    and (head[0][0] == "_"
                         or (head[0][0] == "<" and head[0][-1] == ">"))
                    and head[1][0] == "<" and head[1][-1] == ">"):
                subs.append(head[0][1:-1] if head[0][0] == "<" else head[0])
                preds.append(head[1][1:-1])
                objs.append("")
                vals.append(Val(TypeID.DEFAULT, line[lq + 1:rq]))
                langs.append("")
                facets.append(None)
                stars.append(False)
                continue
        for q in rdf.parse(line):
            subs.append(q.subject)
            preds.append(q.predicate)
            objs.append(q.object_id)
            vals.append(q.object_value)
            langs.append(q.lang)
            facets.append(tuple(sorted(q.facets)) if q.facets else None)
            stars.append(q.star)
    return pickle.dumps((subs, preds, objs, vals, langs, facets, stars),
                        protocol=pickle.HIGHEST_PROTOCOL)


def _read_chunks(path: str):
    op = gzip.open if path.endswith(".gz") else open
    buf: list[str] = []
    with op(path, "rt", encoding="utf-8") as f:
        for line in f:
            buf.append(line)
            if len(buf) >= CHUNK_LINES:
                yield "".join(buf).encode("utf-8")
                buf = []
    if buf:
        yield "".join(buf).encode("utf-8")


def _map_stage(paths: list[str], workers: int):
    """Parallel parse (the reference's map goroutines, mapper.go:121).

    Yields (subject, predicate, object_id, object_value, lang, facets, star)
    column tuples per chunk."""
    chunks = (c for p in paths for c in _read_chunks(p))
    if workers <= 1:
        for c in chunks:
            yield pickle.loads(_parse_chunk(c))
        return
    import multiprocessing as mp

    # never fork a process that may hold CUDA state: a fork after CUDA
    # init is undefined. (The JAX package also strips a TPU plugin's site
    # directory from the workers' PYTHONPATH here; nothing of the kind
    # exists for this package, so the environment passes through.)
    ctx = mp.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        for blob in ex.map(_parse_chunk, chunks):
            yield pickle.loads(blob)


def iter_quads(paths: list[str], workers: int):
    """Row iterator over _map_stage for consumers that want NQuad-shaped
    tuples: (subject, predicate, object_id, object_value, lang, facets, star)."""
    for cols in _map_stage(paths, workers):
        yield from zip(*cols)


def _group_rows(subs: np.ndarray, objs: np.ndarray):
    """Sort (subject, object) edge arrays and yield (subject, sorted unique
    object array) per subject — the reduce step's k-way merge, vectorized."""
    order = np.lexsort((objs, subs))
    subs, objs = subs[order], objs[order]
    # global dedupe on the sorted pairs: per-row np.unique calls dominated
    # the reduce step at bulk scale
    if len(subs):
        keep = np.ones(len(subs), bool)
        keep[1:] = (subs[1:] != subs[:-1]) | (objs[1:] != objs[:-1])
        subs, objs = subs[keep], objs[keep]
    uq, starts = np.unique(subs, return_index=True)
    bounds = np.append(starts, len(subs))
    for i, s in enumerate(uq):
        yield int(s), objs[bounds[i]:bounds[i + 1]]


def bulk_load(rdf_paths: str | list[str], schema_text: str, out_dir: str, *,
              workers: int | None = None, commit_ts: int = 1,
              progress=None, spill_mb: float | None = None,
              xidmap_cache: int | None = None, metrics=None) -> BulkStats:
    """Load RDF file(s) into a fresh posting snapshot at out_dir.

    spill_mb: in-RAM map-buffer budget in MB — when set, the out-of-core
    tier runs (sorted spill runs + streaming merge/reduce; byte-identical
    output, bounded RSS). xidmap_cache: resident xid→uid entry bound for
    the sharded identity map (None = unbounded). metrics: optional
    utils/metrics.Registry — in-process (embedded-node) loads feed the
    dgraph_ingest_*/dgraph_xidmap_* counters so they show on /metrics."""
    t0 = time.perf_counter()
    paths = [rdf_paths] if isinstance(rdf_paths, str) else list(rdf_paths)
    for p in paths:
        if not os.path.exists(p):
            raise BulkError(f"no such file: {p}")
    store = Store(out_dir)
    if store.lists:
        store.close()
        raise BulkError(f"{out_dir} already contains a posting store")
    workers = workers if workers is not None else min(8, os.cpu_count() or 1)
    if spill_mb:
        if not out_dir:
            store.close()
            raise BulkError("spill_mb needs a durable out_dir for run files")
        return _bulk_load_spill(paths, schema_text, out_dir, store, workers,
                                commit_ts, progress,
                                int(spill_mb * (1 << 20)), xidmap_cache, t0,
                                metrics)

    lease = UidLease()
    xm = XidMap(lease, dirpath=os.path.join(out_dir, "xidmap")
                if out_dir else None, cache_entries=xidmap_cache)
    stats = BulkStats()

    # -- map + shuffle: group parsed quads by predicate ----------------------
    uid_sub: dict[str, list[int]] = {}
    uid_obj: dict[str, list[int]] = {}
    uid_facets: dict[str, dict[tuple[int, int], tuple]] = {}
    val_rows: dict[str, dict[int, list]] = {}   # attr -> subj -> [(lang, Val, facets)]
    n = 0
    xid = xm.uid
    for subs_c, preds_c, objs_c, vals_c, langs_c, facets_c, stars_c in \
            _map_stage(paths, workers):
        for subj, pred, obj, val, lang, facets, star in \
                zip(subs_c, preds_c, objs_c, vals_c, langs_c, facets_c, stars_c):
            if star or pred == "*":
                raise BulkError("deletes are not valid in a bulk load")
            s = xid(subj)
            if obj:
                uid_sub.setdefault(pred, []).append(s)
                uid_obj.setdefault(pred, []).append(xid(obj))
                if facets:
                    uid_facets.setdefault(pred, {})[(s, uid_obj[pred][-1])] = facets
            else:
                val_rows.setdefault(pred, {}).setdefault(s, []).append(
                    (lang, val, facets or ()))
        n += len(subs_c)
        if progress and n % 500000 < len(subs_c):
            progress(n)

    with store.suspend_wal():
        for e in parse_schema(schema_text or ""):
            store.set_schema(e)
        lists: dict[bytes, PostingList] = {}
        subjects_seen: set[int] = set()
        batch_keys: list[bytes] = []        # packed in one pack_many pass
        batch_rows: list[np.ndarray] = []
        batch_postings: dict[bytes, dict[int, Posting]] = {}

        def emit(kb: bytes, row: np.ndarray,
                 postings: dict[int, Posting] | None = None) -> None:
            batch_keys.append(kb)
            batch_rows.append(row)
            if postings:
                batch_postings[kb] = postings

        # -- reduce: uid predicates → packed CSR-style bases -----------------
        for attr in sorted(uid_sub):
            entry = store.schema.ensure(attr, TypeID.UID)
            subs = np.asarray(uid_sub[attr], dtype=np.int64)
            objs = np.asarray(uid_obj[attr], dtype=np.int64)
            facets = uid_facets.get(attr, {})
            rev_sub: dict[int, list[int]] = {}
            deg_pairs: list[tuple[int, int]] = []
            for s, row in _group_rows(subs, objs):
                postings = None
                if facets:
                    postings = {o: Posting(o, Op.SET, facets=facets[(s, o)])
                                for o in row.tolist() if (s, o) in facets}
                emit(K.data_key(attr, s).encode(), row, postings)
                subjects_seen.add(s)
                stats.uid_edges += len(row)
                if entry.reverse:
                    for o in row.tolist():
                        rev_sub.setdefault(int(o), []).append(s)
                if entry.count:
                    deg_pairs.append((len(row), s))
            for o, srcs in rev_sub.items():
                emit(K.reverse_key(attr, o).encode(),
                     np.unique(np.asarray(srcs, dtype=np.int64)))
            if entry.count:
                by_deg: dict[int, list[int]] = {}
                for d, s in deg_pairs:
                    by_deg.setdefault(d, []).append(s)
                for d, ss in by_deg.items():
                    emit(K.count_key(attr, d).encode(),
                         np.unique(np.asarray(ss, dtype=np.int64)))

        # -- reduce: value predicates → value bases + token indexes ----------
        for attr in sorted(val_rows):
            if attr in uid_sub:
                raise BulkError(
                    f"predicate <{attr}> carries both uid edges and literal "
                    f"values in the input — pick one representation")
            first_val = next(iter(val_rows[attr].values()))[0][1]
            entry = store.schema.ensure(attr, first_val.tid)
            tokens: dict[bytes, list[int]] = {}
            for s, triples in val_rows[attr].items():
                slots, postings = [], {}
                for lang, v, fa in triples:
                    if entry.type_id not in (TypeID.DEFAULT, v.tid):
                        try:
                            v = convert(v, entry.type_id)
                        except ValueError as e:
                            raise BulkError(
                                f"predicate <{attr}>, subject 0x{s:x}: "
                                f"{e}") from e
                    _check_vector_dim(entry, v, attr, s)
                    slot = value_fingerprint(v) if entry.is_list \
                        else lang_uid(lang)
                    slots.append(slot)
                    postings[slot] = Posting(slot, Op.SET, v, lang, fa)
                    if entry.indexed:
                        for tk in index_tokens(entry, v, lang):
                            tokens.setdefault(tk, []).append(s)
                    stats.values += 1
                emit(K.data_key(attr, s).encode(),
                     np.unique(np.asarray(slots, dtype=np.uint64)), postings)
                subjects_seen.add(s)
            for tk, ss in tokens.items():
                emit(K.index_key(attr, tk).encode(),
                     np.unique(np.asarray(ss, dtype=np.int64)))

        # one vectorized pack across every list (reduce.go's per-key pack,
        # batched for numpy)
        for kb, pu in zip(batch_keys, native.pack_many(batch_rows)):
            pl = PostingList()
            pl.base_ts = commit_ts
            pl.base_packed = pu
            pl.base_postings = batch_postings.get(kb, {})
            lists[kb] = pl

        store.bulk_install(lists, commit_ts)
        stats.nodes = len(subjects_seen)
        stats.predicates = len(uid_sub) + len(val_rows)
        stats.xids = len(xm)
        stats.edges = stats.uid_edges + stats.values
    store.checkpoint(commit_ts)
    xm.close()     # sharded identity map lands next to the snapshot
    store.close()
    stats.xidmap_hit_rate = xm.stats.hit_rate
    stats.seconds = time.perf_counter() - t0
    _ingest_metrics(metrics, stats, xm)
    return stats


def _ingest_metrics(reg, stats: BulkStats, xm: XidMap) -> None:
    """Feed an embedded node's registry (satellite: ingest counters on
    /metrics). The offline CLI has no registry — there the same numbers
    ride BulkStats and the structured 'bulk load done' log event."""
    if reg is None:
        return
    reg.counter("dgraph_ingest_spill_bytes_total").inc(stats.spill_bytes)
    reg.counter("dgraph_ingest_spill_runs_total").inc(stats.spill_runs)
    if stats.merge_fanin:
        reg.counter("dgraph_ingest_merge_fanin").set(stats.merge_fanin)
    reg.counter("dgraph_xidmap_lookups_total").inc(xm.stats.lookups)
    reg.counter("dgraph_xidmap_shard_loads_total").inc(xm.stats.shard_loads)
    reg.counter("dgraph_xidmap_evictions_total").inc(xm.stats.evictions)


# -- out-of-core tier ---------------------------------------------------------

_ROW_BATCH = 4096          # rows per pack_many call in the streaming reduce


class _SectionBatch:
    """Stream rows into one tablet section, packing in bounded batches —
    pack()/pack_many() are per-row independent, so any batching yields the
    byte-identical columns the in-RAM path's single global pack produces."""

    __slots__ = ("sec", "ts", "keys", "rows", "posts")

    def __init__(self, sec, base_ts: int) -> None:
        self.sec = sec
        self.ts = base_ts
        self.keys: list[bytes] = []
        self.rows: list[np.ndarray] = []
        self.posts: list[bytes] = []

    def add(self, kb: bytes, row: np.ndarray, post: bytes = b"") -> None:
        self.keys.append(kb)
        self.rows.append(row)
        self.posts.append(post)
        if len(self.keys) >= _ROW_BATCH:
            self.flush()

    def flush(self) -> None:
        if not self.keys:
            return
        for kb, pu, post in zip(self.keys, native.pack_many(self.rows),
                                self.posts):
            self.sec.add_row(kb, self.ts, pu, post)
        self.keys.clear()
        self.rows.clear()
        self.posts.clear()


def _post_json(postings: dict[int, Posting] | None) -> bytes:
    """Same serialization Store's checkpoint uses for base_postings — the
    byte-identity contract between the two reduce tiers."""
    if not postings:
        return b""
    return json.dumps([posting_to_json(p) for p in postings.values()]).encode()


def _bulk_load_spill(paths: list[str], schema_text: str, out_dir: str,
                     store: Store, workers: int, commit_ts: int, progress,
                     spill_bytes: int, xidmap_cache: int | None,
                     t0: float, metrics=None) -> BulkStats:
    """External-memory bulk load (reference cmd/bulk shape): map spills
    sorted per-predicate runs, the reduce k-way-merges them and streams
    packed rows straight into DGTS3 tablet sections. RAM is bounded by
    the spill budget + merge chunk buffers + the xidmap cache — never by
    graph size."""
    try:
        return _bulk_load_spill_inner(
            paths, schema_text, out_dir, store, workers, commit_ts,
            progress, spill_bytes, xidmap_cache, t0, metrics)
    except BaseException:
        # embedded callers live on past a BulkError: release the store's
        # WAL fd and reap the graph-sized run files + half-written snapshot
        store.close()
        shutil.rmtree(os.path.join(out_dir, ".spill"), ignore_errors=True)
        try:
            os.unlink(os.path.join(out_dir, "snapshot.bin.tmp"))
        except OSError:
            pass
        raise


def _bulk_load_spill_inner(paths: list[str], schema_text: str, out_dir: str,
                           store: Store, workers: int, commit_ts: int,
                           progress, spill_bytes: int,
                           xidmap_cache: int | None,
                           t0: float, metrics=None) -> BulkStats:
    lg = log.get_logger("bulk")
    lease = UidLease()
    xm = XidMap(lease, dirpath=os.path.join(out_dir, "xidmap"),
                cache_entries=xidmap_cache)
    stats = BulkStats()
    tmp_dir = os.path.join(out_dir, ".spill")
    sstats = _spill.SpillStats()
    pool = _spill.SpillSet(tmp_dir, spill_bytes, sstats)
    pool.on_flush = lambda st: lg.info(
        "spill", runs=st.spill_runs, bytes=st.spill_bytes)
    pairs = _spill.UidPairSpiller(pool)
    frames = _spill.FramedSpiller(pool)
    with store.suspend_wal():   # schema durability comes from snapshot meta
        for e in parse_schema(schema_text or ""):
            store.set_schema(e)

    # -- map: parse + xid + spill into per-(kind, predicate) channels -------
    uid_preds: set[str] = set()
    val_preds: dict[str, TypeID] = {}   # pred -> first-seen value type
    n = 0
    xid = xm.uid
    u64 = lambda u: u.to_bytes(8, "big")  # noqa: E731 — sort-key encoding
    for subs_c, preds_c, objs_c, vals_c, langs_c, facets_c, stars_c in \
            _map_stage(paths, workers):
        for subj, pred, obj, val, lang, facets, star in \
                zip(subs_c, preds_c, objs_c, vals_c, langs_c, facets_c,
                    stars_c):
            if star or pred == "*":
                raise BulkError("deletes are not valid in a bulk load")
            s = xid(subj)
            if obj:
                if pred in val_preds:
                    raise BulkError(
                        f"predicate <{pred}> carries both uid edges and "
                        f"literal values in the input — pick one "
                        f"representation")
                uid_preds.add(pred)
                o = xid(obj)
                pairs.add(("d", pred), s, o)
                entry = store.schema.get(pred)
                if entry is not None and entry.reverse:
                    pairs.add(("r", pred), o, s)
                if facets:
                    frames.add(("f", pred), u64(s) + u64(o),
                               pickle.dumps(facets,
                                            pickle.HIGHEST_PROTOCOL))
            else:
                if pred in uid_preds:
                    raise BulkError(
                        f"predicate <{pred}> carries both uid edges and "
                        f"literal values in the input — pick one "
                        f"representation")
                if pred not in val_preds:
                    val_preds[pred] = val.tid
                frames.add(("v", pred), u64(s),
                           pickle.dumps((lang, val, facets or ()),
                                        pickle.HIGHEST_PROTOCOL))
        n += len(subs_c)
        if progress and n % 500000 < len(subs_c):
            progress(n)
    pool.flush()
    lg.info("map done", quads=n, spill_runs=sstats.spill_runs,
            spill_mb=round(sstats.spill_bytes / (1 << 20), 1))

    # -- reduce: merge runs, stream packed rows into tablet sections --------
    subj_ch = ("s", "")              # distinct-subject accounting channel
    snap_tmp = os.path.join(out_dir, "snapshot.bin.tmp")
    with open(snap_tmp, "wb") as f:
        w = SnapshotWriter(f, commit_ts, spool_max=store.SNAP_SPOOL_MAX)

        for attr in sorted(uid_preds):
            entry = store.schema.ensure(attr, TypeID.UID)
            batch = _SectionBatch(
                w.section(int(K.KeyKind.DATA), attr), commit_ts)
            facet_it = iter(_spill.merge_framed(frames.runs(("f", attr)),
                                                sstats))
            fpend = next(facet_it, None)

            def facets_for(s: int):
                nonlocal fpend
                out = {}
                skey = u64(s)
                while fpend is not None and fpend[0][:8] <= skey:
                    if fpend[0][:8] == skey:
                        out[int.from_bytes(fpend[0][8:], "big")] = \
                            pickle.loads(fpend[2])   # last occurrence wins
                    fpend = next(facet_it, None)
                return out

            for s, row in _spill.merge_pairs(pairs.runs(("d", attr)),
                                             sstats):
                fmap = facets_for(s)
                postings = {int(o): Posting(int(o), Op.SET,
                                            facets=fmap[int(o)])
                            for o in row.tolist()
                            if int(o) in fmap} if fmap else None
                batch.add(K.data_key(attr, s).encode(), row,
                          _post_json(postings))
                stats.uid_edges += len(row)
                pairs.add(subj_ch, s, 0)
                if entry.count:
                    pairs.add(("c", attr), len(row), s)
            batch.flush()
            pairs.discard(("d", attr))
            frames.discard(("f", attr))
            if entry.reverse:
                rbatch = _SectionBatch(
                    w.section(int(K.KeyKind.REVERSE), attr), commit_ts)
                for o, srcs in _spill.merge_pairs(pairs.runs(("r", attr)),
                                                  sstats):
                    rbatch.add(K.reverse_key(attr, o).encode(), srcs)
                rbatch.flush()
                pairs.discard(("r", attr))
            if entry.count:
                pool.flush()
                cbatch = _SectionBatch(
                    w.section(int(K.KeyKind.COUNT), attr), commit_ts)
                for d, ss in _spill.merge_pairs(pairs.runs(("c", attr)),
                                                sstats):
                    cbatch.add(K.count_key(attr, d).encode(), ss)
                cbatch.flush()
                pairs.discard(("c", attr))

        for attr in sorted(val_preds):
            entry = store.schema.ensure(attr, val_preds[attr])
            batch = _SectionBatch(
                w.section(int(K.KeyKind.DATA), attr), commit_ts)
            tok_ch = ("t", attr)
            saw_tokens = False
            for key, payloads in _spill.group_framed(
                    _spill.merge_framed(frames.runs(("v", attr)), sstats)):
                s = int.from_bytes(key, "big")
                slots, postings = [], {}
                for pb in payloads:
                    lang, v, fa = pickle.loads(pb)
                    if entry.type_id not in (TypeID.DEFAULT, v.tid):
                        try:
                            v = convert(v, entry.type_id)
                        except ValueError as e:
                            raise BulkError(
                                f"predicate <{attr}>, subject 0x{s:x}: "
                                f"{e}") from e
                    _check_vector_dim(entry, v, attr, s)
                    slot = value_fingerprint(v) if entry.is_list \
                        else lang_uid(lang)
                    slots.append(slot)
                    postings[slot] = Posting(slot, Op.SET, v, lang, fa)
                    if entry.indexed:
                        for tk in index_tokens(entry, v, lang):
                            frames.add(tok_ch, tk, u64(s))
                            saw_tokens = True
                    stats.values += 1
                batch.add(K.data_key(attr, s).encode(),
                          np.unique(np.asarray(slots, dtype=np.uint64)),
                          _post_json(postings))
                pairs.add(subj_ch, s, 0)
            batch.flush()
            frames.discard(("v", attr))
            if saw_tokens:
                pool.flush()
                ibatch = _SectionBatch(
                    w.section(int(K.KeyKind.INDEX), attr), commit_ts)
                for tk, subs in _spill.group_framed(
                        _spill.merge_framed(frames.runs(tok_ch), sstats)):
                    ss = np.unique(np.frombuffer(
                        b"".join(subs), dtype=">u8").astype(np.int64))
                    ibatch.add(K.index_key(attr, tk).encode(), ss)
                ibatch.flush()
                frames.discard(tok_ch)

        # distinct subjects across every DATA tablet (stats.nodes), via the
        # same merge machinery — no resident subject set
        pool.flush()
        stats.nodes = sum(1 for _ in _spill.merge_pairs(
            pairs.runs(subj_ch), sstats))
        pairs.discard(subj_ch)

        w.finish({"schema": store.schema.to_text(),
                  "max_commit_ts": commit_ts})
    os.replace(snap_tmp, os.path.join(out_dir, "snapshot.bin"))
    shutil.rmtree(tmp_dir, ignore_errors=True)

    stats.predicates = len(uid_preds) + len(val_preds)
    stats.xids = len(xm)
    stats.edges = stats.uid_edges + stats.values
    stats.spill_bytes = sstats.spill_bytes
    stats.spill_runs = sstats.spill_runs
    stats.merge_fanin = sstats.merge_fanin
    stats.buffered_peak = sstats.buffered_peak
    stats.xidmap_hit_rate = xm.stats.hit_rate
    xm.close()
    store.close()
    stats.seconds = time.perf_counter() - t0
    _ingest_metrics(metrics, stats, xm)
    lg.info("reduce done", rows=w.rows,
            peak_transient_mb=round(w.peak_transient / (1 << 20), 1),
            merge_fanin=stats.merge_fanin,
            xidmap_hit_rate=round(stats.xidmap_hit_rate, 4))
    return stats
