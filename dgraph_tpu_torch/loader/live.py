"""Online (live) loader: batched mutations through a running node.

Port of dgraph_tpu/loader/live.py: it drives the port's Node, so the
node's device serves the reads the load's upserts and indexes make.

Reference semantics: dgraph/cmd/live/run.go + batch.go — parse RDF, batch N
quads per txn, M concurrent in-flight txns with retry on ABORTED, xidmap for
blank nodes/IRIs shared across batches so identities stay stable. Here the
loader drives an embedded Node (the in-process analog of the gRPC client);
batches run through the normal Mutate/Commit path, so indexes, conflict
detection, and the WAL all apply — the durable-but-slower sibling of
loader/bulk.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from dgraph_tpu_torch.coord.zero import TxnConflict
from dgraph_tpu_torch.loader.bulk import iter_quads
from dgraph_tpu_torch.loader.xidmap import XidMap
from dgraph_tpu_torch.query.rdf import NQuad
from dgraph_tpu_torch.utils.retry import RetryPolicy


@dataclass
class LiveStats:
    quads: int = 0
    txns: int = 0
    aborts: int = 0


def live_load(node, rdf_paths: str | list[str], *, batch: int = 1000,
              retries: int = 3, workers: int = 1,
              xm: XidMap | None = None, xidmap_path: str | None = None,
              xidmap_cache: int | None = None,
              progress=None) -> LiveStats:
    """Stream RDF file(s) into a node as committed transactions.

    xidmap_path: crash-resumable identity log (xidmap/xidmap.go's
    badger-persisted map, in append-log form) — assignments are fsynced
    BEFORE each txn commits, so a re-run of an interrupted load reuses
    every identity it had already assigned instead of minting duplicates.

    xidmap_cache: resident-entry bound for the sharded identity map
    (requires xidmap_path; shards page to <xidmap_path>.shards/): external
    id cardinality is no longer capped by host RAM — the reference's
    badger-backed sharded LRU, xidmap/xidmap.go:30-80.
    """
    paths = [rdf_paths] if isinstance(rdf_paths, str) else list(rdf_paths)
    own_xm = xm is None
    if own_xm:
        if xidmap_cache is not None and not xidmap_path:
            raise ValueError("xidmap_cache needs xidmap_path (the shard "
                             "dir lives next to the log)")
        xm = (XidMap.open(xidmap_path, node.zero.uids,
                          cache_entries=xidmap_cache) if xidmap_path
              else XidMap(node.zero.uids))
    stats = LiveStats()
    # snapshot so a SHARED xm across resumed loads reports per-call deltas,
    # not its cumulative lifetime totals again
    stats0 = (xm.stats.lookups, xm.stats.shard_loads, xm.stats.evictions)
    pending: list = []

    # aborted-txn retries ride the unified policy (utils/retry): full-
    # jitter exponential backoff instead of the old immediate hot loop,
    # deadline-aware (never sleeps past an active budget, never retries
    # DeadlineExceeded/CommitAmbiguous), and the attempts show up on the
    # node's dgraph_retry_total
    policy = RetryPolicy(max_attempts=retries + 1, name="live_load",
                         metrics=getattr(node, "metrics", None))

    def flush():
        if not pending:
            return
        xm.sync()   # identities durable before the txn that uses them

        def attempt():
            try:
                # commit_now routes each batch through the node's group-
                # commit window (storage/writebatch.py): concurrent
                # loader workers share fsyncs and conflict passes
                node.mutate_quads(pending, commit_now=True)
            except TxnConflict:
                stats.aborts += 1
                raise

        policy.run(attempt, retryable=(TxnConflict,))
        stats.txns += 1
        pending.clear()

    for subj, pred, obj, val, lang, facets, star in iter_quads(paths, workers):
        # pin identities through the shared xidmap: same name in different
        # batches must hit the same uid (live/batch.go uid lookups)
        pending.append(NQuad(
            subject=f"0x{xm.uid(subj):x}", predicate=pred,
            object_id=f"0x{xm.uid(obj):x}" if obj else "",
            object_value=val, lang=lang,
            facets=list(facets) if facets else [], star=star))
        stats.quads += 1
        if len(pending) >= batch:
            flush()
            if progress and stats.quads % 100000 < batch:
                progress(stats.quads)
    flush()
    if own_xm:
        xm.close()
    reg = getattr(node, "metrics", None)
    if reg is not None:    # xidmap LRU behavior shows on the node's /metrics
        reg.counter("dgraph_xidmap_lookups_total").inc(
            xm.stats.lookups - stats0[0])
        reg.counter("dgraph_xidmap_shard_loads_total").inc(
            xm.stats.shard_loads - stats0[1])
        reg.counter("dgraph_xidmap_evictions_total").inc(
            xm.stats.evictions - stats0[2])
    return stats
