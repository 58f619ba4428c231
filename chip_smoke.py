#!/usr/bin/env python3
"""Smoke run of dgraph_tpu_torch on one NVIDIA GPU (H100), end to end.

    python3 chip_smoke.py                 # needs one CUDA card

At the repository's headline configuration — R-MAT scale 20, edge factor 16,
seed 7, 128 seeds from default_rng(3), as bench.py measures the JAX package —
it:
  1. prints the card's name and power limit and builds the CUDA kernels from
     dgraph_tpu_torch/ops/csrc (nvcc, sm_90a), with the build time;
  2. holds K1 (active_prefix) and K2 (active_prefix_sparse) to their plain
     PyTorch versions on the card at the full-size edge streams (exact int32
     equality; empty, <= 4096, 10% and 60% frontiers; K1 == K2 on the sparse
     one), then on the edge cases of their design (a bitmap too large for
     shared memory and the sizes around that limit, a table of exactly 4,096
     entries, INT32_MAX ranks, a stream of one EDGE_BLOCK) and over 50
     launches each at the main path's shapes, on that over-large bitmap and
     on a full-size stream with a 4,096-entry table; times each with CUDA
     events, one call alone (`ms`, the host's launch overhead included) and
     back-to-back calls (`ms_back_to_back`, the device's time per call),
     beside its bound and beside torch.cumsum of the same stream timed both
     ways;
  3. runs the raw 3-hop BFS (k_hop_pull_pallas), equal to a host BFS;
  4. runs DQL `@recurse(depth: 3)` from the 128 seeds through Executor — the
     main path, with the launch counts read around one query — each level's
     dest uids equal to the host-mirror path's;
  5. sends a few requests through Executor.execute to JSON, byte-identical
     between the kernel path and the host-mirror path;
  6. runs DQL `shortest` from seeds[0] through Executor.execute on the
     kernel tier (bfs_dist over K1/K2, launch counts read around the
     picks): to the lowest uid at the largest distance, to one at distance
     2 and to an unreachable one, each path equal to a numpy walk over
     minimum-uid predecessors and each `_weight_` to the host BFS distance;
     times the far request and profiles it; runs the Bellman-Ford tier
     (traversal.sssp) over the whole graph, its distances equal to the host
     BFS at every node and its parents to the maximum-uid predecessors; and
     sends a weighted `numpaths: 3` request over a second predicate `road`
     (R-MAT scale 12, an integer facet `w` per edge), byte-identical across
     the host, default and device expand paths, its weights non-decreasing
     and each the sum of the `w` facets along its path;
  7. folds three value predicates on every node id with build_value_pred
     (age int, score float, name string with exact and term indexes; data
     from default_rng(11)) and sends six value requests through
     Executor.execute: an index range root, BASELINE config 2's one-hop
     expand with a value filter, an anyofterms root ordered by score, an
     exact-match root, @recurse with value children and a value filter,
     and val/math/aggregates over value variables, and a seventh whose
     filter combines an anyofterms leaf and two value compares with AND,
     OR and NOT over all ids (every operand >= COMBINE_OPERAND_MIN uids).
     Each one's JSON is byte-identical between the default path and the
     host path (numpy set combines included), and held to numpy over the
     same data; the device union (ops/csr.expand_dest) must run for the two
     index roots, K1 or K2 for the recurse, and each combine of the seventh
     on the card where its operands reach uidset.HOST_CUTOVER; each request
     is timed (p50, min..max of 3 runs; the seventh on the host path too)
     and two are profiled. Before the folds, the `set_algebra` line holds
     the three set combines, forced onto the card, to numpy at min(len)
     2^13, 2^17 and 2^22 (uids past 2^32, the uid 2^31 - 1, an unsorted
     input with repeats) and the five set ops (apply_filter, merge_many,
     intersect_many, index_of, paginate) on int64 sets of 2^20 ids to their
     numpy meaning. After phase 14 a `combines` line counts the combines of
     phases 7-14 that reached HOST_CUTOVER, and says so plainly if none
     did;
  8. loads the headline graph (with its REVERSE keys) and `age` on every
     node id into the port's Store (posting lists packed by the native
     codec, Store.bulk_install), folds it eagerly (held to the input
     arrays), runs phase 4's @recurse over a SnapshotAssembler's lazy
     folds (levels equal to phase 4's, K1 and K2 launched), commits a
     seeded write program of COMMITS transactions (one more aborted) through
     rdf -> mutation -> Store.commit with a one-uid probe after each
     (commit-to-visible ms; every commit stamped as a delta overlay over
     base tensors that keep their device pointers), then over the last
     overlay snapshot the one-hop expand (ops/csr.expand_masked on the
     card), the @recurse (K1/K2 over the merged CSR) and an index root
     (the device union over the merged index), each equal to the host path
     or to numpy after the same edits, and finally compacts the overlays
     (a from-scratch fold of each predicate at the last commit): the
     stamped CSRs and values equal the fold's and every request gives the
     same JSON over it; the store lives in a temporary directory and is
     checkpointed at its last commit;
  7b. (between 7 and 8, over phase 7's snapshot) sends two @groupby
     requests through Executor.execute: (a) phase 8's expand frontier (the
     seeds and the largest rows, 146 uids) grouped by `friend` (one group
     per distinct target) and (b) every node grouped by `age`, each with
     count(uid) and aggregates of a value variable of ages <= 31 (the f32
     rule holds). Each runs the device
     route (ops/segments' fused reduce; for (a) also the device rank
     search), asserted by counters read around it, is byte-identical to
     the host route and equal to numpy, and is timed (p50 of 5 runs);
  9. serves through the port's Node on the card: the golden battery via
     alter -> mutate -> query, equal to tests/golden/expected.json, with an
     upsert and a conflicting transaction pair; then a Node opened over
     phase 8's checkpoint answers phase 5's one-uid @recurse (K1 or K2
     launched) and request (a), each byte-identical to phase 8's JSON over
     its compaction, and reads back SERVE_TXNS of its own transactions
     (commit-to-visible through the Node);
  10. (inside phase 9, after its two requests and before its
     transactions) puts the wire in front of the serving Node: first
     `python -m dgraph_tpu_torch serve` as a user starts it (--device left
     at cuda), held to the golden battery over HTTP and over gRPC, with a
     conflicting pair (409), /metrics parsed and /admin/shutdown (exit 0);
     then the port's HTTP and gRPC servers over phase 9's Node: phase 5's
     @recurse over HTTP (K1/K2 launches read around it, `launches_wire`)
     and phase 7b's request (a) over gRPC, each byte-identical to phase
     8's JSON over its compaction, and /subscribe SSE streams on one uid
     (a one-hop read under WIRE_COMMITS commits over HTTP, and for the
     last an @recurse whose re-evaluation launches K1/K2), each commit
     delivering one diff event at its timestamp that equals the diff
     applied and a read-only query at that timestamp; every reply's
     status is checked with its payload (the CLI starts before phase 9
     opens its Node, so its start overlaps that open);
  11. the default serving configuration (phase 9's Node is opened with the
     planner, the batcher and the device observatory on and an unbounded
     working-set manager, as the JAX Node serves): (a) before phase 10's
     commits, BURST distinct one-uid @recurse(depth: 3) requests, each
     first alone and then all together from threads behind a barrier —
     each concurrent JSON byte-identical to its solo JSON, at least one
     recurse batch of two or more packed into one recurse_fused_multi run
     with K1 or K2 launched inside it (`launches_batch`) — and the same for
     EXPAND_SLICES slices of phase 8's expand frontier (batched
     ops/csr.expand); (c) a ResidencyManager adopting the friend and
     ~friend tablets, with budgets from their own device footprints:
     BUDGET_FIT x the larger (one fits, two do not) while the wide one-hop
     expand alternates over friend and ~friend through an Executor without
     a task cache (evictions, a re-admission counted as thrash, and
     torch.cuda.memory_allocated falling by at least the evicted
     footprint), then BUDGET_COLD x the smaller (both COLD: host serves,
     no upload), every JSON byte-identical to the unbounded run; and after
     phase 10's commits, over its HTTP server, (b) PLANNER_QUERY through
     the Node with explain=True and over ?explain=true (a root swap, the
     data byte-identical to a plan-less Executor on the same snapshot) and
     (d) /debug/timeline (recurse and expand records with CUDA-event device
     intervals), /debug/compiles (the port's families), the HBM high-water
     mark from torch.cuda.memory_stats and the device busy share in [0, 1];
  9b. (after phase 9, before 12) the mesh on the one card: a
     MeshExecutor over MESH_SHARDS repeats of the card (the single-
     controller mesh of parallel/mesh.py; the shards run one after another
     on it) places phase 4's friend and ~friend as row-range shards (the
     sharded-tablets gauge reads 2; each shard's edges printed), then (b)
     phase 4's 128-seed @recurse(depth: 3) through Executor(mesh=) as one
     mesh program, each level's dest uids equal to phase 4's with the
     replay-divergence counter unmoved, run_recurse's own device frontiers
     equal to phase 4's levels, and phase 5's one-uid @recurse
     byte-identical to the unsharded Executor's JSON;
     (c) a two-hop chain with a value filter and first/offset as one
     run_plan, byte-identical to the unsharded path; (d) phase 6's far
     shortest through run_bfs, JSON equal to the kernel tier's; (e) phase
     7b's request (a) over the placement, JSON equal to the unsharded
     answer, and a nested @groupby(friend) as the fused terminal, both
     cross-checks run and the JSON equal; (f) PageRank over friend within
     PAGERANK_TOL (absolute) and PAGERANK_RTOL (relative to each score)
     of a float64 power iteration (np.bincount), the top 5 equal; CC equal to scipy's connected_components mapped to minimum
     ranks; triangles on R-MAT scale MESH_TRI_SCALE equal to the exact
     host count; (h) Node(device="cuda", mesh_devices=-1, mesh_min_edges=1)
     serving the golden battery equal to expected.json with fused queries,
     its analytics equal to a mesh-less Node's. Its `mesh` line carries
     each step's time (host clock, p50 of 5 where repeated), the host
     reads per loop, the program builds, the fused/unfused counts and the
     fallbacks by reason; K1/K2 launches on this path (expected 0: the
     mesh programs are torch ops) go into the kernels line as
     `launches_mesh`;
  12. vectors at ANN-Benchmarks sift-128-euclidean's shape: VEC_N rows of
     128 float32 dims (a seeded Gaussian mixture with VEC_PLANTED identical
     rows planted) on uids of the headline graph, loaded into the port's
     Store and folded (a brute-force tablet), in one snapshot with phase
     4's `friend`: (a) similar_to probes equal to a numpy float64 exact
     scan, the planted tie decided for the smallest uids; (b) a burst of
     VEC_BURST requests in one batch.vector_topk, each JSON equal to its
     solo JSON; (c) the fused ANN -> friend hop as one vector.ann_expand
     span, equal to JSON from (a)'s answers over phase 2's host CSR; (d) a
     commit of new rows and deletions stamped as a VecOverlay, equal to a
     from-scratch fold; (e) similar_to feeding @recurse(depth: 2) over
     friend, K1 or K2 launched (`launches_vector`), byte-identical to the
     host-mirror route; (f) IVF with VEC_IVF_CENTROIDS lists over the
     first VEC_IVF_ROWS rows: the device stage equal to the float64
     re-rank of the probed rows, recall@10 >= VEC_RECALL_MIN; (g) a cold
     tablet serving by host scan; and, for phase 9b, one probe over the
     MESH_SHARDS-shard placement of the index (mesh_exec.vector_topk),
     equal to the exact scan; the fold's seconds, the probe, burst and
     fused times, the candidate stage's CUDA-event time beside its bytes
     bound and a probe's torch.profiler trace;
  13. the loader chain users run, each a subprocess of the port's CLI:
     ldbc_gen (LDBC-SNB SF LDBC_SF), convert --ldbc, bulk, then serve -p
     over the output: the 3-hop friends-of-friends @recurse over `knows`
     from the hub person (K1/K2 launched, read from the server's /metrics:
     `launches_loader`), IS3 and the longest reply chain, each held to
     numpy over the CSVs and to the host-mirror route; export equal to the
     input N-Quads under the xid map; live of a LIVE_PREFIX prefix equal to
     bulk of it; ops/packed_decode over the knows tablet's bp128 lists;
  14. the wire cluster: (a) in this process, over loopback gRPC, a Zero
     with two groups and two workers on the card (serve_worker(device=));
     group 0's Store holds friend with ~friend, group 1's age and name on
     every node id (phase 7's values), both installing phase 8's packed
     lists as loaded; the tablet map read back from ZeroClient; then
     through a ClusterClient: phase 4's 128-seed @recurse(depth: 3) walked
     on the Executor its query() runs (ClusterClient.read_executor; levels
     equal to phase 4's, no JSON: a cut, its size; p50 of CLUSTER_TIMED, a
     torch.profiler trace beside CUDA events, a worker expand on the
     card), phase 5's one-uid @recurse and CLUSTER_CHAIN (a two-hop chain
     across both groups sorted by a remote key with first/offset), each
     JSON byte-identical to the unsharded Executor over phase 4's
     snapshot, and a mutation of a friend edge and an age committed
     through Zero and read back (commit-to-visible); each worker's open
     and first-task seconds, ServeTask calls and response bytes per
     request, the workers' dgraph_replica_*/dgraph_batch_* counters; K1/K2
     launches of the recurse go into the kernels line as
     `launches_cluster`; (b) `python -m dgraph_tpu_torch zero --groups 2`
     and two `worker --device cuda` processes: the golden battery loaded
     through ClusterClient.mutate, every query equal to expected.json;
  15. runs the port's project-invariant analyzer as a user runs it,
     `python -m dgraph_tpu_torch.analysis --format=json dgraph_tpu_torch`
     in a subprocess over the checkout: exit 0, no finding, and under
     ANALYSIS_MAX_S of wall clock (interpreter start included); its line
     carries the files analyzed, the findings by rule, the wall seconds
     and the analyzer's own;
  16. prints the card line, a {"kernels": [...]} line and the final
     {"ok": true, "device": {...}} line.
Any mismatch raises and the script exits non-zero. It never imports jax or
the JAX package.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SCALE, EDGE_FACTOR, SEED = 20, 16, 7   # the headline graph (bench.py)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# both kernels do integer work: 64 INT32 operations per clock per SM
# (4 partitions x 16 lanes) x 132 SMs x 1.98 GHz boost on the H100 SXM
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations per edge of the kernels' design, as counted in the notes
# of dgraph_tpu_torch/ops/csrc/active_prefix.cu: the membership test (K1 the
# bitmap word, K2 one hash probe), the mask, the output, and the per-tile
# scans shared by a thread's 8 edges
OPS_PER_EDGE = {"active_prefix": 22, "active_prefix_sparse": 19}
RACE_LAUNCHES = 50
JSON_MAX_BYTES = 10 << 20
ANALYSIS_MAX_S = 10.0       # phase 15: the analyzer's budget, as its tests
# phase 7: value predicates on every node id, names from a 64-word
# vocabulary (three words each: one word's term row holds ~47k uids)
VALUES_SCHEMA = """
age: int @index(int) .
score: float @index(float) .
name: string @index(exact, term) .
"""
VOCAB = tuple(f"w{chr(97 + i // 8)}{chr(97 + i % 8)}" for i in range(64))
# phase 7's set_algebra line: the three combines forced onto the card at
# these min(len) sizes, the five set ops on int64 sets of SET_OPS_N uids;
# and a request whose filter combines operands of at least
# COMBINE_OPERAND_MIN uids each
SET_COMBINE_SIZES = (1 << 13, 1 << 17, 1 << 22)
SET_OPS_N = 1 << 20
COMBINE_OPERAND_MIN = 1 << 17
# phase 8: the headline graph and age in the port's Store, then a seeded
# program of COMMITS transactions over a pool of COMMIT_POOL subjects (32
# transactions since phase 10 came, 16 since phase 14 came: the script's
# time limit, a cut of scale)
STORE_SCHEMA = "friend: [uid] @reverse .\nage: int @index(int) ."
COMMITS, COMMIT_POOL = 16, 32
# the overlay expand adds the largest rows to the seeds until the base side
# alone passes this many edges (past task.HOST_EXPAND_MAX: the device gather)
EXPAND_EDGES = 300_000
# phase 7b: @groupby over phase 8's expand frontier (a uid key) and over
# every age (a value key), each aggregating a value variable of ages <= GROUPBY_AGE_MAX
# so the f32 rule holds (all ints, |sum| < 2**24)
GROUPBY_AGE_MAX = 31
GROUPBY_UID = ("{ var(func: uid(%s)) @filter(le(age, %d)) { a as age } "
               "q(func: uid(%s)) @groupby(friend) { count(uid) "
               "s: sum(val(a)) lo: min(val(a)) hi: max(val(a)) } }")
GROUPBY_VALUE = ("{ var(func: has(age)) @filter(le(age, %d)) { b as age } "
                 "q(func: has(age)) @groupby(age) { count(uid) "
                 "s: sum(val(b)) lo: min(val(b)) hi: max(val(b)) "
                 "mean: avg(val(b)) } }" % GROUPBY_AGE_MAX)
# phase 9: read-your-writes transactions through the Node
SERVE_TXNS = 8
# phase 10: commits over HTTP under two live subscriptions on one uid of
# phase 7b's set, the one whose two-hop edge count is nearest WIRE_TWO_HOP
WIRE_COMMITS, WIRE_TWO_HOP = 4, 20_000
# phase 11: the default serving configuration over phase 9's Node. BURST
# distinct one-uid @recurse(depth: 3) requests (the seeds of phase 4's 128
# whose rendered JSON is smallest by a host estimate, from BURST_MIN_ROWS
# rendered uids up; at most BURST_MAX_ROWS) run alone, then together behind
# a barrier, packed by the batcher's documented knobs (batch_window_ms,
# batch_max) for the burst; then EXPAND_SLICES slices of phase 8's expand
# frontier the same way; a root-swapping filter request; the residency
# budgets as shares of the friend tablets' own footprints
BURST, BURST_WINDOW_MS = 8, 1000.0
BURST_MIN_ROWS, BURST_MAX_ROWS = 2_000, 2_000_000
EXPAND_SLICES = 4
PLANNER_QUERY = "{ q(func: has(friend)) @filter(eq(age, 42)) { uid age } }"
BUDGET_FIT, BUDGET_COLD = 1.5, 0.5
# phase 9b: the mesh on the one card. MESH_SHARDS shards of the headline
# graph's friend and ~friend (row ranges; the partition is the JAX
# package's, so R-MAT's skew puts most edges on shard 0); tablets below
# MESH_MIN_EDGES stay replicated (phase 6's `road` among them). The chain
# request (c) starts from MESH_CHAIN_SEEDS of the 128 seeds; the terminal
# request of (e) groups friend(seeds) by friend. Triangles (f) run on
# R-MAT scale MESH_TRI_SCALE: 2,048 ids, analytics.TRI_DENSE_MAX
MESH_SHARDS, MESH_MIN_EDGES = 4, 1 << 20
MESH_CHAIN_SEEDS, MESH_TRI_SCALE = 16, 11
MESH_CHAIN = ("{ q(func: uid(%s)) { friend @filter(ge(age, 50)) "
              "(first: 5, offset: 1) { friend (first: 3) { uid age } } } }")
MESH_TERMINAL = ("{ var(func: uid(%s)) { friend @filter(le(age, %d)) "
                 "{ a as age } } q(func: uid(%s)) { friend @groupby(friend) "
                 "{ count(uid) s: sum(val(a)) lo: min(val(a)) "
                 "hi: max(val(a)) } } }")
# PageRank against the float64 power iteration: the absolute limit of the
# JAX tests (graphs of some hundreds of nodes, scores near 2e-3), and, since
# the mean score here is 1/646,136 (about 1.5e-6, no larger than that
# limit), a relative limit on every node's score as well
PAGERANK_TOL = 1e-6
PAGERANK_RTOL = 1e-4
# phase 12: vectors at ANN-Benchmarks sift-128-euclidean's shape (1,000,000
# base vectors of 128 float32 dims, metric l2, k = 10) on uids 1..VEC_N of
# the headline graph. The data is a mixture of VEC_CLUSTERS Gaussian
# components (centres N(0, 1), spread VEC_NOISE about them) from
# default_rng(VEC_SEED); VEC_PLANTED identical rows of small integers at
# scattered uids make a tie past k' = k_capacity(10, 2^20) = 32. Two cuts
# of (f), the IVF index: VEC_IVF_CENTROIDS lists, as the automatic count
# (1,000) would make the kept JAX k-means build an 8 GB distance matrix
# every Lloyd iteration; and the first VEC_IVF_ROWS rows, as that k-means
# over all 1,000,000 rows took about 45 s of the script's time limit on an
# H100 host
VEC_N, VEC_DIM, VEC_K, VEC_SEED = 1_000_000, 128, 10, 17
VEC_CLUSTERS, VEC_NOISE, VEC_PLANTED = 1024, 0.1, 40
VEC_QUERIES, VEC_BURST = 100, 16
VEC_OVERLAY_SET, VEC_OVERLAY_DEL = 900, 100
VEC_IVF_CENTROIDS, VEC_IVF_ROWS, VEC_RECALL_MIN = 256, 250_000, 0.95
# (f) holds the device stage to a float64 re-rank of all probed rows (tens
# of MB of float64 a query) for the first VEC_IVF_RERANKS queries
VEC_IVF_RERANKS = 20
VEC_RECURSE_MAX_ROWS = 200_000
VEC_SCHEMA = "emb: float32vector @index(vector(dim: 128, metric: l2)) ."
# phase 13: the loader chain at LDBC-SNB scale factor LDBC_SF (a cut from
# SF 1, the smallest official scale, to keep the script well inside its
# time limit on slower hosts), then live of the first LIVE_PREFIX N-Quads
# against bulk of the same prefix
LDBC_SF, LDBC_SEED, LIVE_PREFIX = 0.2, 20260804, 5000
# bulk runs its out-of-core tier (the one an SF 100 load needs; its output
# is byte-identical to the in-RAM tier's), which logs the map and the reduce
LDBC_SPILL_MB = 512
LDBC_PARSE_WORKERS = 4     # the export check's parse (bulk's map stage)
# phase 14: the wire cluster. Group 0's store holds friend (with ~friend),
# group 1's age and name on every node id (phase 7's values; name without
# an index: phase 14 fetches it and never looks it up). The chain crosses
# both groups twice and sorts by a remote key; CLUSTER_TIMED runs are timed
CLUSTER_SCHEMAS = ("friend: [uid] @reverse .",
                   "age: int @index(int) .\nname: string .")
CLUSTER_TABLETS = {"friend": 0, "age": 1, "name": 1}
CLUSTER_CHAIN_SEEDS, CLUSTER_TIMED = 16, 3
CLUSTER_CHAIN = ("{ var(func: uid(%s)) { friend { f as friend "
                 "@filter(ge(age, 50)) } } q(func: uid(f), orderasc: age, "
                 "first: 20, offset: 5) { uid age name friend (first: 2) "
                 "{ uid age } } }")


def host_3hop(subjects, indptr, indices, seeds, hops=3):
    """Vectorized numpy BFS (a copy of bench.py:host_3hop)."""
    sub = subjects
    visited = np.zeros(int(indices.max()) + 2, dtype=bool)
    visited[seeds] = True
    frontier = np.unique(seeds)
    traversed = 0
    for _ in range(hops):
        pos = np.searchsorted(sub, frontier)
        pos = np.clip(pos, 0, len(sub) - 1)
        ok = sub[pos] == frontier
        rows = pos[ok]
        starts, ends = indptr[rows], indptr[rows + 1]
        counts = ends - starts
        total = int(counts.sum())
        traversed += total
        if total == 0:
            frontier = np.zeros(0, dtype=frontier.dtype)
            break
        offs = np.concatenate([[0], np.cumsum(counts)])
        idx = np.repeat(starts - offs[:-1], counts) + np.arange(total)
        flat = indices[idx]
        dest = np.unique(flat)
        fresh = dest[~visited[dest]]
        visited[fresh] = True
        frontier = fresh
    return visited, traversed


def host_bfs_dist(subjects, indptr, indices, src, n):
    """Vectorized numpy BFS hop counts from src over uids [0, n); -1 where
    unreached."""
    dist = np.full(n, -1, dtype=np.int32)
    dist[src] = 0
    frontier, d = np.asarray([src], dtype=np.int64), 0
    while len(frontier):
        d += 1
        pos = np.clip(np.searchsorted(subjects, frontier), 0,
                      len(subjects) - 1)
        rows = pos[subjects[pos] == frontier]
        starts, counts = indptr[rows], indptr[rows + 1] - indptr[rows]
        total = int(counts.sum())
        if total == 0:
            break
        offs = np.concatenate([[0], np.cumsum(counts)])
        flat = indices[np.repeat(starts - offs[:-1], counts)
                       + np.arange(total)]
        dest = np.unique(flat)
        frontier = dest[dist[dest] < 0]
        dist[frontier] = d
    return dist


def min_pred_walk(rsub, rptr, ridx, dist, src, dst):
    """The path [src..dst] that takes, from dst back, the minimum-uid
    in-neighbour one hop closer (the kernel tier's and Dijkstra's rule),
    over the reverse CSR (rows of sorted subjects)."""
    path, v = [dst], dst
    for d in range(int(dist[dst]), 0, -1):
        r = int(np.searchsorted(rsub, v))
        preds = ridx[rptr[r]: rptr[r + 1]]
        v = int(preds[dist[preds] == d - 1][0])
        path.append(v)
    if path[-1] != src:
        raise SystemExit(f"min_pred_walk ended at {path[-1]}, not {src}")
    return path[::-1]


def path_uids(node, attr):
    """uids along one `_path_` object: {"uid": .., attr: [{...}]}."""
    out = []
    while node is not None:
        out.append(int(node["uid"], 16))
        node = node[attr][0] if attr in node else None
    return out


def widened(subjects, indptr, seeds, edges=EXPAND_EDGES):
    """`seeds` plus the subjects of the largest rows, largest first, until
    those rows pass `edges` edges: phase 8's expand frontier and phase 7b's
    uid set (146 uids at the headline scale)."""
    deg = np.diff(indptr)
    big = np.argsort(-deg, kind="stable")
    big = big[: int(np.searchsorted(np.cumsum(deg[big]), edges)) + 1]
    return np.union1d(seeds, subjects[big]).astype(np.int64)


def groupby_uid_text(uids) -> str:
    s = ", ".join(hex(int(u)) for u in uids)
    return GROUPBY_UID % (s, GROUPBY_AGE_MAX, s)


def groupby_uid_numpy(csr, age, uids) -> list[dict]:
    """Phase 7b request (a) in numpy: one row per distinct `friend` target
    of `uids`, its member count and the sum/min/max of the members' ages
    <= GROUPBY_AGE_MAX (omitted where no member has one), rows ordered as
    the engine orders groups (by the repr of the key tuple)."""
    subjects, indptr, indices = csr
    pos = np.searchsorted(subjects, uids)
    lens = indptr[pos + 1] - indptr[pos]
    member = np.repeat(uids, lens)
    target = np.concatenate([indices[indptr[p]: indptr[p + 1]]
                             for p in pos]).astype(np.int64)
    order = np.lexsort((member, target))
    member, target = member[order], target[order]
    fresh = np.ones(len(target), dtype=bool)     # one pair per (target, member)
    fresh[1:] = (target[1:] != target[:-1]) | (member[1:] != member[:-1])
    member, target = member[fresh], target[fresh]
    keys, starts = np.unique(target, return_index=True)
    a = age[member - 1].astype(np.int64)
    ok = a <= GROUPBY_AGE_MAX
    n_ok = np.add.reduceat(ok.astype(np.int64), starts)
    s = np.add.reduceat(np.where(ok, a, 0), starts)
    lo = np.minimum.reduceat(np.where(ok, a, 1 << 40), starts)
    hi = np.maximum.reduceat(np.where(ok, a, -1), starts)
    counts = np.diff(np.append(starts, len(target)))
    rows = []
    for i, k in enumerate(keys.tolist()):
        row = {"friend": hex(k), "count": int(counts[i])}
        if n_ok[i]:
            row.update(s=int(s[i]), lo=int(lo[i]), hi=int(hi[i]))
        rows.append(row)
    rows.sort(key=lambda r: repr((r["friend"],)))
    return rows


def groupby_value_numpy(age) -> list[dict]:
    """Phase 7b request (b) in numpy: one row per distinct age with its
    node count, and for ages <= GROUPBY_AGE_MAX the four aggregates."""
    vals, counts = np.unique(age, return_counts=True)
    rows = []
    for v, c in zip(vals.tolist(), counts.tolist()):
        row = {"age": v, "count": c}
        if v <= GROUPBY_AGE_MAX:
            row.update(s=v * c, lo=v, hi=v, mean=float(v))
        rows.append(row)
    rows.sort(key=lambda r: repr((r["age"],)))
    return rows


def golden_battery():
    """(SCHEMA, N-Quads, QUERIES, expected answers) of the repo's golden
    battery: tests/test_golden.py's definitions are read with ast (that
    file imports the JAX package) and tests/golden/expected.json."""
    import ast
    import os

    path = Path(__file__).resolve().parent / "tests" / "test_golden.py"
    tree = ast.parse(path.read_text())
    body = [n for n in tree.body if isinstance(n, (ast.Assign, ast.AnnAssign))
            or (isinstance(n, ast.FunctionDef) and n.name == "_dataset")]
    ns = {"os": os, "__file__": str(path)}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    expected = json.loads((path.parent / "golden" / "expected.json")
                          .read_text())
    return ns["SCHEMA"], ns["_dataset"](), ns["QUERIES"], expected


def timed(fn, calls=20, reps=5, warm=3):
    """Median over `reps` runs of CUDA-event ms per call, each run `calls`
    calls back to back, so the device's time and not the host's enqueue is
    read. calls=1 times one call with the device idle before it: the host's
    launch overhead included."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / calls)
    return float(np.median(ts))


def band(samples):
    s = sorted(samples)
    return {"min": s[0], "median": s[len(s) // 2], "max": s[-1]}


def on_host(fn):
    """fn() with every expand, union, set combine and recurse level on the
    host mirrors (the reference each request's default path is held
    to)."""
    from dgraph_tpu_torch.ops import uidset
    from dgraph_tpu_torch.query import recurse as rec
    from dgraph_tpu_torch.query import task

    kept = rec.KERNEL_MIN_EDGES, task.HOST_EXPAND_MAX, uidset.HOST_CUTOVER
    rec.KERNEL_MIN_EDGES = task.HOST_EXPAND_MAX = uidset.HOST_CUTOVER = \
        1 << 62
    try:
        return fn()
    finally:
        rec.KERNEL_MIN_EDGES, task.HOST_EXPAND_MAX, uidset.HOST_CUTOVER = \
            kept


def device_combines() -> int:
    """Set combines run on the device branch so far (uidset.COMBINES, every
    op and device type)."""
    from dgraph_tpu_torch.ops import uidset

    return sum(sum(c.values()) for c in uidset.COMBINES.values())


def say(tag: str, **kw) -> None:
    print(json.dumps({"phase": tag, **kw}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 2

    from dgraph_tpu_torch import carry
    from dgraph_tpu_torch.models.rmat import rmat_csr
    from dgraph_tpu_torch.ops import prefix as px
    from dgraph_tpu_torch.ops import pull_bfs as pb
    from dgraph_tpu_torch.query import dql
    from dgraph_tpu_torch.query import engine as eng
    from dgraph_tpu_torch.query import recurse as rec
    from dgraph_tpu_torch.storage.csr_build import transpose_csr
    from dgraph_tpu_torch.utils.schema import SchemaState, parse_schema
    from dgraph_tpu_torch.utils.types import TypeID

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # ---- 1. card + build ---------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    lib_path, build_log = px.build(verbose=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.split("ptxas info    : ")[-1] for ln in
             build_log.splitlines()
             if "Used" in ln or "Compiling" in ln or "spill" in ln]
    say("build", seconds=build_s, library=lib_path.name, ptxas=ptxas,
        torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0))

    # ---- data --------------------------------------------------------------
    t0 = time.perf_counter()
    subjects, indptr, indices = rmat_csr(SCALE, EDGE_FACTOR, seed=SEED)
    num_nodes = 1 + (1 << SCALE) + 1
    seeds = np.unique(np.random.default_rng(3).choice(
        subjects, size=128, replace=False)).astype(np.int32)
    g = pb.prep_pull(subjects, indptr, indices, num_nodes, device=dev)
    sync()
    say("data", seconds=time.perf_counter() - t0, edges=int(len(indices)),
        subjects=int(len(subjects)), e_pad=int(g.in_src_pad.numel()),
        chunks=g.chunks, chunks_d=g.chunks_d)

    # ---- 2. kernel parity + timing at full-size shapes ---------------------
    rng = np.random.default_rng(11)

    def held(name, kfn, pfn, label):
        """One kernel call, held to its plain version exactly (int32)."""
        got, want = kfn(), pfn()
        sync()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise SystemExit(f"{name} != plain on {label}: {bad} positions "
                             f"differ")
        return got

    def k1_pair(words, stream, chunks):
        return ("active_prefix",
                lambda: px.active_prefix(words, stream, chunks),
                lambda: px.active_prefix_ref(words, stream, chunks))

    def k2_pair(ftab, stream):
        return ("active_prefix_sparse",
                lambda: px.active_prefix_sparse(ftab, stream),
                lambda: px.active_prefix_sparse_ref(ftab, stream))

    def raced(name, kfn, want, label):
        """RACE_LAUNCHES launches, each bit-identical to the plain version:
        run-to-run races in the look-back show up only now and then."""
        for i in range(RACE_LAUNCHES):
            if not torch.equal(kfn(), want):
                raise SystemExit(f"{name} on {label}: launch {i} of "
                                 f"{RACE_LAUNCHES} differs from the plain "
                                 f"version")

    def exact_mask(n, k):
        m = np.zeros(n, dtype=bool)
        m[rng.choice(n, k, replace=False)] = True
        return torch.from_numpy(m).to(dev)

    def synthetic_stream(n_ranks, n_edges, chunks):
        """n_edges random ranks padded to EDGE_BLOCK with the pad rank."""
        e_pad = -(-n_edges // px.EDGE_BLOCK) * px.EDGE_BLOCK
        src = np.full(e_pad, chunks * px.NODES_PER_CHUNK - 1, dtype=np.int32)
        src[:n_edges] = rng.integers(0, n_ranks, n_edges)
        return torch.from_numpy(src).to(dev)

    kernels = {}
    streams = {"src": (g.in_src_pad, g.chunks, len(subjects)),
               "dst": (g.in_src_pad_d, g.chunks_d,
                       int(g.in_subjects.numel()))}
    for sname, (stream, chunks, n) in streams.items():
        for fname, density in (("empty", 0.0), ("sparse", None),
                               ("10pct", 0.10), ("60pct", 0.60)):
            mask = (exact_mask(n, 4000) if density is None else
                    torch.from_numpy(rng.random(n) < density).to(dev))
            label = f"{sname}/{fname}"
            k1 = held(*k1_pair(pb.pack_words(mask, chunks), stream, chunks),
                      label)
            line = {"stream": sname, "frontier": fname,
                    "active": int(k1[-1]), "k1_max_abs_err": 0}
            if int(mask.sum()) <= pb.SPARSE_MAX:
                k2 = held(*k2_pair(pb._frontier_table(mask), stream), label)
                if not torch.equal(k2, k1):
                    raise SystemExit(f"K2 != K1 on {label}")
                line["k2_max_abs_err"] = 0
            say("parity", **line)
        # the main path's shapes: K2 on the src-rank stream (hop 1 from 128
        # seeds), K1 on the dst-rank stream (the dense hops)
        e_pad = stream.numel()
        if sname == "src":
            ftab = pb._frontier_table(exact_mask(n, 128))
            name, kfn, pfn = k2_pair(ftab, stream)
            in_bytes = ftab.numel() * 4
        else:
            mask = torch.from_numpy(rng.random(n) < 0.10).to(dev)
            words = pb.pack_words(mask, chunks)
            name, kfn, pfn = k1_pair(words, stream, chunks)
            in_bytes = words.numel() * 4
        moved = 4 * e_pad + 4 * e_pad + in_bytes
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_EDGE[name] * e_pad / INT32_OPS_PER_S * 1e3
        want = pfn()
        err = int((kfn().to(torch.int64) - want.to(torch.int64)).abs().max())
        raced(name, kfn, want, f"the {sname}-rank stream")
        cumsum = lambda: torch.cumsum(stream, 0, dtype=torch.int32)
        yardstick = {"cumsum_int32_ms": timed(cumsum, calls=1, reps=20),
                     "cumsum_int32_ms_back_to_back": timed(cumsum)}
        kernels[name] = {
            "name": name, "route": "cuda",
            "source": "dgraph_tpu_torch/ops/csrc/active_prefix.cu",
            "replaces": ("dgraph_tpu/ops/pallas_bfs.py:78"
                         if name == "active_prefix"
                         else "dgraph_tpu/ops/pallas_bfs.py:124"),
            "launches": 0, "max_abs_err": err,
            "ms": timed(kfn, calls=1, reps=20), "ms_back_to_back": timed(kfn),
            "plain_ms": timed(pfn, calls=1, reps=10),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "e_pad": int(e_pad), "stream": sname}
        if err:
            raise SystemExit(f"{name}: max_abs_err {err}")
        shares = {f"share_of_bound{sfx}": kernels[name]["bound_ms"]
                  / kernels[name][f"ms{sfx}"] for sfx in ("", "_back_to_back")}
        if max(shares.values()) > 1:
            raise SystemExit(f"{name}: a time is below its bound: {shares}, "
                             f"{kernels[name]}")
        say("kernel_time", race_launches=RACE_LAUNCHES, **shares, **yardstick,
            **kernels[name])

    # edge cases of the design, each held to the plain version
    src_stream = g.in_src_pad
    n_src = len(subjects)
    # a bitmap past what a block can stage (4M ranks: 123 chunks, 984 rows)
    # takes the read-only path; 50 chunks (400 rows) is the largest staged
    for n_ranks, n_edges in ((4_000_000, 3_000_000), (50 * 32768, 200_000),
                             (51 * 32768, 200_000)):
        chunks = pb.pack_chunks(n_ranks)
        stream = synthetic_stream(n_ranks, n_edges, chunks)
        mask = torch.from_numpy(rng.random(n_ranks) < 0.10).to(dev)
        words = pb.pack_words(mask, chunks)
        active = int(held(*k1_pair(words, stream, chunks),
                          f"{chunks} chunks")[-1])
        line = {"case": "bitmap", "chunks": chunks, "rows": chunks * 8,
                "e_pad": int(stream.numel()), "active": active,
                "k1_max_abs_err": 0}
        if n_ranks == 4_000_000:
            name, kfn, pfn = k1_pair(words, stream, chunks)
            raced(name, kfn, pfn(), f"{chunks} chunks")
            line["race_launches"] = RACE_LAUNCHES
            ftab = pb._frontier_table(exact_mask(n_ranks, px.FRONTIER_CAP))
            line["k2_4096_active"] = int(held(*k2_pair(ftab, stream),
                                              "4,096 entries, 4M ranks")[-1])
            line["k2_max_abs_err"] = 0
        say("parity_edge", **line)
    # a full table on the full-size stream: longer probe chains
    ftab = pb._frontier_table(exact_mask(n_src, px.FRONTIER_CAP))
    name, kfn, pfn = k2_pair(ftab, src_stream)
    raced(name, kfn, held(name, kfn, pfn, "4,096 entries, src-rank stream"),
          "4,096 entries, src-rank stream")
    say("parity_edge", case="full_table", entries=px.FRONTIER_CAP,
        e_pad=int(src_stream.numel()), race_launches=RACE_LAUNCHES,
        k2_max_abs_err=0)
    # INT32_MAX ranks: a table with pads holds INT32_MAX, a full one does not
    imax = src_stream.clone()
    imax[::997] = px.INT32_MAX
    for n_set in (128, px.FRONTIER_CAP):
        mask = exact_mask(n_src, n_set)
        ftab = pb._frontier_table(mask)
        k2_active = int(held(*k2_pair(ftab, imax),
                             f"INT32_MAX, {n_set} entries")[-1])
        words = pb.pack_words(mask, g.chunks)
        k1_active = int(held(*k1_pair(words, imax, g.chunks),
                             f"INT32_MAX, {n_set} ranks")[-1])
        say("parity_edge", case="int32_max", entries=n_set,
            k2_active=k2_active, k1_active=k1_active, k1_max_abs_err=0,
            k2_max_abs_err=0)
    # one EDGE_BLOCK: fewer tiles than the persistent grid has blocks
    one = src_stream[: px.EDGE_BLOCK]
    for n_set in (128, px.FRONTIER_CAP):
        mask = exact_mask(n_src, n_set)
        held(*k2_pair(pb._frontier_table(mask), one), f"one block, {n_set}")
        held(*k1_pair(pb.pack_words(mask, g.chunks), one, g.chunks),
             f"one block, {n_set}")
    say("parity_edge", case="one_edge_block", e_pad=px.EDGE_BLOCK,
        k1_max_abs_err=0, k2_max_abs_err=0)

    # ---- 3. raw 3-hop BFS (bench.py `value`) -------------------------------
    seeds_mask = torch.zeros(num_nodes, dtype=torch.bool, device=dev)
    seeds_mask[torch.from_numpy(seeds.astype(np.int64)).to(dev)] = True
    run_bfs = lambda: pb.k_hop_pull_pallas(g, seeds_mask, hops=3,
                                           seed_uids=seeds)
    px.reset_launches()
    res = run_bfs()
    sync()
    bfs_launches = dict(px.LAUNCHES)
    traversed = int(res.traversed)
    h_visited, h_traversed = host_3hop(subjects, indptr, indices, seeds, 3)
    got = res.visited.cpu().numpy()
    if traversed != h_traversed:
        raise SystemExit(f"BFS traversed {traversed} != host {h_traversed}")
    if not np.array_equal(np.nonzero(got)[0],
                          np.nonzero(h_visited[: len(got)])[0]):
        raise SystemExit("BFS visited set != host BFS")
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(10):
            r = run_bfs()
        int(r.traversed)
        sync()
        samples.append(traversed / ((time.perf_counter() - t0) / 10))
    say("bfs3", traversed=traversed, visited=int(got.sum()),
        launches=bfs_launches,
        rmat_traversed_edges_per_sec=band(samples))

    # ---- 4. DQL @recurse(depth: 3): the main path --------------------------
    rsub, rptr, ridx = transpose_csr(subjects, indptr, indices)
    snap = carry.snapshot_from_numpy(
        {"friend": (int(TypeID.UID), subjects, indptr, indices),
         "~friend": (int(TypeID.UID), rsub, rptr, ridx)}, 1, device=dev)
    schema = SchemaState()
    for e in parse_schema("friend: [uid] @reverse ."):
        schema.set(e)
    eng.set_query_edge_limit(1 << 31)
    q = "{ q(func: uid(%s)) @recurse(depth: 3) { friend } }" % \
        ", ".join(hex(int(u)) for u in seeds)
    req = dql.parse(q)

    def run_block():
        ex = eng.Executor(snap, schema)
        sg = eng.SubGraph(gq=req.queries[0], attr=req.queries[0].attr)
        ex._process_block(sg)
        return sg

    def chain(sg):
        out, node = [], sg
        while node.children:
            out.append(node.children[0])
            node = node.children[0]
        return out

    rec.KERNEL_MIN_EDGES = 1 << 62
    t0 = time.perf_counter()
    host_levels = chain(run_block())
    host_s = time.perf_counter() - t0
    rec.KERNEL_MIN_EDGES = None             # the default admission on CUDA
    pb.pull_graph_for(snap.pred("friend").csr)      # prep once, untimed
    sync()
    px.reset_launches()
    kern_levels = chain(run_block())
    sync()
    main_launches = dict(px.LAUNCHES)
    if len(host_levels) != len(kern_levels):
        raise SystemExit("recurse level-count mismatch")
    for i, (h, k) in enumerate(zip(host_levels, kern_levels)):
        if not np.array_equal(h.dest_uids, k.dest_uids):
            raise SystemExit(f"recurse level {i} dest-set mismatch")
    if min(main_launches.values()) == 0:
        raise SystemExit(f"a kernel of the main path never launched: "
                         f"{main_launches}")
    deg = np.diff(indptr)
    trav, frontier = 0, np.sort(seeds).astype(np.int64)
    for h in host_levels:
        pos = np.clip(np.searchsorted(subjects, frontier), 0,
                      len(subjects) - 1)
        trav += int(deg[pos[subjects[pos] == frontier]].sum())
        frontier = h.dest_uids
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_block()
        sync()
        samples.append(trav / (time.perf_counter() - t0))
    for name, n in main_launches.items():
        kernels[name]["launches"] = n
    prof = profile_query(run_block)
    say("dql_recurse3", traversed=trav,
        levels=[int(len(h.dest_uids)) for h in host_levels],
        launches=main_launches, host_mirror_seconds=host_s,
        dql_recurse3_traversed_edges_per_sec=band(samples), profile=prof)

    # ---- 5. requests end to end: kernel path vs host-mirror path -----------
    def execute(text):
        return json.dumps(eng.Executor(snap, schema).execute(dql.parse(text)))

    def pick(make, candidates, accept=lambda host: True):
        """First candidate whose host JSON is non-trivial, under the size
        cap and accepted; returns (query, json bytes)."""
        for c in candidates:
            text = make(c)
            host = on_host(lambda: execute(text))
            if 1000 < len(host) <= JSON_MAX_BYTES and accept(c):
                return text, host
        raise SystemExit(f"no candidate fits {make(candidates[0])[:80]}")

    out_deg = dict(zip(subjects.tolist(), deg.tolist()))
    by_out = sorted(subjects.tolist(), key=lambda u: (out_deg[u], u))
    cum = np.cumsum([out_deg[int(u)] for u in seeds])
    expand_seeds = seeds[: max(1, int(np.searchsorted(cum, 300_000)))]
    low = [u for u in by_out if out_deg[u] >= 3][:: max(1, len(by_out) // 400)]
    # the filtered shape starts from more seeds than SPARSE_MAX (K1 on level
    # 1) and keeps only a few in-degree hubs (K2 on level 2, small JSON);
    # the hubs are not seeds, so their own edges are still fresh at level 2
    hubs = rsub[np.argsort(-np.diff(rptr), kind="stable")]
    pool = np.setdiff1d(subjects, hubs[:64])
    many = np.sort(np.random.default_rng(5).choice(
        pool, min(len(pool), pb.SPARSE_MAX + 400), replace=False))
    px.reset_launches()
    shapes = {
        "expand": pick(lambda s: "{ q(func: uid(%s)) { friend { uid } } }" %
                       ", ".join(hex(int(u)) for u in s), [expand_seeds]),
        "filtered_recurse": pick(
            lambda k: "{ q(func: uid(%s)) @recurse(depth: 2) "
                      "{ friend @filter(uid(%s)) } }" % (
                ", ".join(hex(int(u)) for u in many),
                ", ".join(hex(int(u)) for u in np.sort(hubs[:k]))),
            [16, 8, 4, 2]),
        "reverse_recurse": pick(
            lambda u: "{ q(func: uid(%s)) @recurse(depth: 2) { ~friend } }"
                      % hex(u), low),
        "loop_recurse": pick(
            lambda u: "{ q(func: uid(%s)) @recurse(depth: 3, loop: true) "
                      "{ friend } }" % hex(u), low),
    }
    for sname, (text, host) in shapes.items():
        got = execute(text)
        if got != host:
            raise SystemExit(f"{sname}: kernel-path JSON differs from the "
                             f"host-mirror JSON")
        say("request", shape=sname, json_bytes=len(got), query=text[:120])
    req_launches = dict(px.LAUNCHES)
    if min(req_launches.values()) == 0:
        raise SystemExit(f"requests did not launch both kernels: "
                         f"{req_launches}")
    say("requests", launches=req_launches)

    # ---- 6. DQL shortest: kernel tier, Bellman-Ford, weighted k-shortest ---
    t0 = time.perf_counter()
    short_launches, far = shortest_phase(
        snap, schema, (subjects, indptr, indices), (rsub, rptr, ridx),
        int(seeds[0]), num_nodes, dev)
    for name, n in short_launches.items():
        kernels[name]["launches_shortest"] = n
    say("shortest_phase", seconds=time.perf_counter() - t0,
        script_seconds=time.perf_counter() - t_start)

    # ---- 7. value predicates, index roots, filters, order, aggregates ------
    t0 = time.perf_counter()
    combines_before = device_combines()
    value_launches, forced_combines = values_phase(
        snap, schema, (subjects, indptr, indices), seeds, dev)
    for name, n in value_launches.items():
        kernels[name]["launches_values"] = n
    say("values_phase", seconds=time.perf_counter() - t0,
        script_seconds=time.perf_counter() - t_start,
        combines=device_combines())

    # ---- 7b. @groupby: a uid key and a value key on the device route -------
    t0 = time.perf_counter()
    wide = widened(subjects, indptr, expand_seeds)
    groupby_jsons = groupby_phase(snap, schema, (subjects, indptr, indices),
                                  wide)
    say("groupby_phase", seconds=time.perf_counter() - t0,
        script_seconds=time.perf_counter() - t_start,
        combines=device_combines())

    # ---- 8. the Store, commits and overlays ---------------------------------
    json_recurse = shapes["loop_recurse"][0].replace(", loop: true", "")
    with tempfile.TemporaryDirectory(prefix="dgt-ckpt-") as ckpt_dir:
        t0 = time.perf_counter()
        storage_launches, served, lists = storage_phase(
            snap, schema, (subjects, indptr, indices), (rsub, rptr, ridx),
            seeds, expand_seeds, wide, json_recurse, 1 << SCALE,
            ckpt_dir, dev)
        for name, n in storage_launches.items():
            kernels[name]["launches_storage"] = n
        torch.cuda.empty_cache()
        say("storage_phase", seconds=time.perf_counter() - t0,
            script_seconds=time.perf_counter() - t_start,
            combines=device_combines())

        # ---- 9. serving through the Node, and 10. the wire ------------------
        def wire(node):
            """Phases 10 and 11, run inside phase 9 over its Node's state:
            11 (a) and (c) before phase 10's commits, (b) and (d) over
            phase 10's HTTP server after them."""
            t0 = time.perf_counter()
            cli_out = cli_phase(cli, dev)
            t11 = time.perf_counter()
            batch_launches = batch_phase(node, seeds, wide, dev)
            residency_phase(node, wide,
                            widened(rsub, rptr, expand_seeds), dev)
            t11 = time.perf_counter() - t11
            t10 = time.perf_counter()
            wire_launches, t_after = wire_phase(
                node, served, json_recurse, wide,
                (subjects, indptr, indices), dev,
                after=lambda port: planner_devprof_phase(node, port))
            say("wire_phase", seconds=time.perf_counter() - t10 - t_after,
                cli_seconds=cli_out["seconds"],
                script_seconds=time.perf_counter() - t_start)
            say("default_phase", seconds=t11 + t_after,
                script_seconds=time.perf_counter() - t_start)
            return wire_launches, batch_launches

        t0 = time.perf_counter()
        cli = CliServer()
        try:
            serve_launches, (wire_launches, batch_launches) = serve_phase(
                ckpt_dir, served, wide, json_recurse, 1 << SCALE, dev, wire)
        finally:
            cli.stop()
        for name, n in serve_launches.items():
            kernels[name]["launches_serve"] = n
        for name, n in wire_launches.items():
            kernels[name]["launches_wire"] = n
        for name, n in batch_launches.items():
            kernels[name]["launches_batch"] = n
        say("serve_phase", seconds=time.perf_counter() - t0,
            script_seconds=time.perf_counter() - t_start,
            combines=device_combines())

    # ---- 9b. the mesh on the one card ---------------------------------------
    t0 = time.perf_counter()
    mesh_launches = mesh_phase(snap, schema, (subjects, indptr, indices), q,
                               seeds, host_levels, json_recurse, far, wide,
                               groupby_jsons["groupby_uid"], dev)
    for name, n in mesh_launches.items():
        kernels[name]["launches_mesh"] = n
    torch.cuda.empty_cache()
    say("mesh_phase", seconds=time.perf_counter() - t0,
        script_seconds=time.perf_counter() - t_start,
        combines=device_combines())

    # ---- 12. vectors at sift-128-euclidean's shape --------------------------
    t0 = time.perf_counter()
    vector_launches = vector_phase(snap, (subjects, indptr, indices), dev)
    for name, n in vector_launches.items():
        kernels[name]["launches_vector"] = n
    torch.cuda.empty_cache()
    say("vector_phase_done", seconds=time.perf_counter() - t0,
        script_seconds=time.perf_counter() - t_start,
        combines=device_combines())

    # ---- 13. the loader chain, then serve -----------------------------------
    t0 = time.perf_counter()
    loader_launches = loader_phase(dev)
    for name, n in loader_launches.items():
        kernels[name]["launches_loader"] = n
    say("loader_phase_done", seconds=time.perf_counter() - t0,
        script_seconds=time.perf_counter() - t_start,
        combines=device_combines())

    # ---- 14. the wire cluster: Zero, workers on the card, ClusterClient ----
    t0 = time.perf_counter()
    cluster_launches = cluster_phase(
        snap, schema, (subjects, indptr, indices), lists, seeds, q,
        host_levels, json_recurse, dev)
    del lists
    for name, n in cluster_launches.items():
        kernels[name]["launches_cluster"] = n
    say("cluster_phase_done", seconds=time.perf_counter() - t0,
        script_seconds=time.perf_counter() - t_start,
        combines=device_combines())

    # the set combines of phases 7-14 (this process; the CLI servers'
    # own are not counted) that reached uidset.HOST_CUTOVER, set_algebra's
    # forced ones left out
    from dgraph_tpu_torch.ops import uidset

    reached = device_combines() - combines_before - forced_combines
    say("combines", reached_cutover=reached,
        host_cutover=uidset.HOST_CUTOVER,
        by_op={op: dict(c) for op, c in uidset.COMBINES.items()},
        forced_by_set_algebra=forced_combines)
    if reached == 0:
        print(f"no set combine in phases 7-14 reached HOST_CUTOVER "
              f"({uidset.HOST_CUTOVER} uids): every one ran on numpy",
              flush=True)

    # ---- 15. the port's project-invariant analyzer --------------------------
    analysis_phase()

    # ---- 16. summary lines -------------------------------------------------
    kern_line = {"kernels": [
        {k: v for k, v in kernels[n].items() if k not in ("e_pad", "stream")}
        for n in ("active_prefix", "active_prefix_sparse")]}
    print(card)
    print(json.dumps(kern_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def shortest_phase(snap, schema, csr, rev, src, num_nodes, dev) -> dict:
    """Phase 6 on the headline snapshot (friend, ~friend); adds `road`.
    Returns the K1/K2 launches of the kernel tier's picks."""
    import torch

    from dgraph_tpu_torch import carry
    from dgraph_tpu_torch.models.rmat import rmat_csr
    from dgraph_tpu_torch.ops import prefix as px
    from dgraph_tpu_torch.ops import traversal
    from dgraph_tpu_torch.query import dql
    from dgraph_tpu_torch.query import engine as eng
    from dgraph_tpu_torch.query import task
    from dgraph_tpu_torch.utils.schema import parse_schema
    from dgraph_tpu_torch.utils.types import TypeID, Val

    subjects, indptr, indices = csr
    rsub, rptr, ridx = rev
    sync = torch.cuda.synchronize

    def execute(text):
        return eng.Executor(snap, schema).execute(dql.parse(text))

    # picks from a host BFS over the whole graph
    t0 = time.perf_counter()
    hd = host_bfs_dist(subjects, indptr, indices, src, num_nodes)
    has_in = np.zeros(num_nodes, dtype=bool)
    has_in[indices] = True
    far_d = int(hd.max())
    unreached = np.flatnonzero((hd < 0) & has_in)
    picks = {"far": int(np.flatnonzero(hd == far_d)[0]),
             "d2": int(np.flatnonzero(hd == 2)[0]),
             "unreached": int(unreached[0]) if len(unreached)
             else int(np.flatnonzero(~has_in[1:])[0]) + 1}
    host_bfs_s = time.perf_counter() - t0
    text = ("{ p as shortest(from: %s, to: %%s) { friend } "
            "r(func: uid(p)) { uid } }" % hex(src))

    # the kernel tier through Executor.execute, its launches counted
    px.reset_launches()
    outs = {k: execute(text % hex(v)) for k, v in picks.items()}
    sync()
    launches = dict(px.LAUNCHES)
    for k, v in picks.items():
        out = outs[k]
        if k == "unreached":
            if "_path_" in out:
                raise SystemExit(f"shortest to unreachable {v} gave a path")
            continue
        got = path_uids(out["_path_"][0], "friend")
        want = min_pred_walk(rsub, rptr, ridx, hd, src, v)
        if out["_path_"][0]["_weight_"] != float(hd[v]):
            raise SystemExit(f"shortest {k}: _weight_ "
                             f"{out['_path_'][0]['_weight_']} != {hd[v]}")
        if got != want:
            raise SystemExit(f"shortest {k}: path {got} != numpy walk {want}")
        if sorted(int(r["uid"], 16) for r in out["r"]) != sorted(want):
            raise SystemExit(f"shortest {k}: var p block != the path")
    if min(launches.values()) == 0:
        raise SystemExit(f"shortest did not launch both kernels: {launches}")

    far_q = text % hex(picks["far"])
    px.reset_launches()
    execute(far_q)
    sync()
    far_launches = dict(px.LAUNCHES)
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        execute(far_q)
        sync()
        samples.append((time.perf_counter() - t0) * 1e3)
    prof = profile_query(lambda: execute(far_q))
    say("shortest", picks=picks, hops={k: int(hd[v]) for k, v in
                                       picks.items()},
        launches=launches, far_launches=far_launches,
        syncs_per_query=prof["dtoh_copies"], shortest_ms=band(samples),
        host_bfs_seconds=host_bfs_s, profile=prof)

    # the Bellman-Ford tier over the whole graph
    pcsr = snap.pred("friend").csr
    hi = max(int(subjects[-1]), int(indices.max()))
    nn = 1 << max(int(np.ceil(np.log2(hi + 2))), 4)     # shortest.py's class
    run = lambda: traversal.sssp(pcsr.subjects, pcsr.indptr, pcsr.indices,
                                 None, src, num_nodes=nn)
    res = run()
    dist, parent = res.dist.cpu().numpy(), res.parent.cpu().numpy()
    hdn = np.full(nn, -1, dtype=np.int32)          # uids past hi: unreached
    hdn[: min(nn, num_nodes)] = hd[: min(nn, num_nodes)]
    want_d = np.where(hdn >= 0, hdn, np.inf).astype(np.float32)
    if not np.array_equal(dist, want_d):
        raise SystemExit(f"sssp dist != host BFS at "
                         f"{int((dist != want_d).sum())} nodes")
    src_e = np.repeat(subjects, np.diff(indptr)).astype(np.int64)
    dst_e = indices.astype(np.int64)
    tree = (hd[src_e] >= 0) & (hd[dst_e] == hd[src_e] + 1)
    want_p = np.full(nn, -1, dtype=np.int64)
    np.maximum.at(want_p, dst_e[tree], src_e[tree])
    if not np.array_equal(parent, want_p):
        raise SystemExit(f"sssp parent != maximum-uid predecessor at "
                         f"{int((parent != want_p).sum())} nodes")
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    say("sssp", iterations=res.iterations, reached=int((hd >= 0).sum()),
        sssp_ms=band(ms), ms_per_iteration=float(np.median(ms))
        / res.iterations)

    # a weighted k-shortest request over `road`, with an integer facet w
    rs, rp, rx = rmat_csr(12, 16, seed=9)
    w = np.random.default_rng(9).integers(1, 10, len(rx))
    road_src = np.repeat(rs, np.diff(rp))
    wmap = {(int(a), int(b)): int(c) for a, b, c in zip(road_src, rx, w)}
    road = carry.snapshot_from_numpy(
        {"road": (int(TypeID.UID), rs, rp, rx)}, 1, device=dev,
        facets={"road": {k: (("w", Val(TypeID.INT, c)),)
                         for k, c in wmap.items()}})
    snap.preds["road"] = road.pred("road")
    for e in parse_schema("road: [uid] ."):
        schema.set(e)
    deg = np.diff(rp)
    n_road = int(max(rs.max(), rx.max())) + 1
    wtext = ("{ p as shortest(from: %s, to: %s, numpaths: 3) "
             "{ road @facets(w) } r(func: uid(p)) { uid road @facets(w) "
             "{ uid } } }")
    # pairs two hops apart: best-first enumeration of loopless paths grows
    # with the hubs within reach of the third path's weight, and at three
    # hops one pair of this graph needs more than 50,000 heap pops
    eng.set_query_edge_limit(1 << 18)      # at most 262,144 pops a request
    for a in rs[(deg >= 3) & (deg <= 16)][:20]:
        rd = host_bfs_dist(rs, rp, rx, int(a), n_road)
        if not (rd == 2).any():
            continue
        wq = wtext % (hex(int(a)), hex(int(np.flatnonzero(rd == 2)[0])))
        expand_max = task.HOST_EXPAND_MAX
        jsons = {}
        t0 = time.perf_counter()
        for path, cut in (("host", 1 << 62), ("default", expand_max),
                          ("device", 0)):
            task.HOST_EXPAND_MAX = cut
            try:
                jsons[path] = json.dumps(execute(wq))
            finally:
                task.HOST_EXPAND_MAX = expand_max
        k_ms = (time.perf_counter() - t0) * 1e3 / 3
        paths = json.loads(jsons["default"]).get("_path_", [])
        if 1000 < len(jsons["default"]) <= JSON_MAX_BYTES and len(paths) == 3:
            break
    else:
        raise SystemExit("no road pair gives 3 paths in 1 KB..10 MB of JSON")
    if len(set(jsons.values())) != 1:
        raise SystemExit("weighted k-shortest JSON differs between the host, "
                         "default and device expand paths")
    weights = [pth["_weight_"] for pth in paths]
    if weights != sorted(weights):
        raise SystemExit(f"k-shortest weights decrease: {weights}")
    for pth in paths:
        uids = path_uids(pth, "road")
        cost = sum(wmap[(a, b)] for a, b in zip(uids, uids[1:]))
        if pth["_weight_"] != float(cost):
            raise SystemExit(f"_weight_ {pth['_weight_']} != facet sum {cost}")
    say("k_shortest", query=wq[:120], json_bytes=len(jsons["default"]),
        weights=weights, hops=[len(path_uids(p, "road")) - 1 for p in paths],
        ms_per_request=k_ms)
    return launches, {"src": src, "dst": picks["far"],
                      "hops": int(hd[picks["far"]])}


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """np.unique by a sort: numpy's unique is hash-based on the card's host
    and takes seconds for millions of uids."""
    x = np.sort(x)
    return x[np.concatenate([[True], x[1:] != x[:-1]])] if len(x) else x


def member(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Mask over x: x[i] in the sorted array y."""
    if not len(y):
        return np.zeros(len(x), bool)
    i = np.searchsorted(y, x)
    return y[np.minimum(i, len(y) - 1)] == x


def set_algebra(dev, ids) -> int:
    """Phase 7's `set_algebra` line: intersect_host, union_host and
    difference_host forced onto the card (HOST_CUTOVER = 0) at each min(len)
    of SET_COMBINE_SIZES, on a pair whose first set holds uids at and past
    2^32 and 2^31 - 1 (a real uid here, JAX's int32 sentinel), unsorted
    with repeats, in both orders, each equal to numpy's meaning of the op
    (computed with sorted_unique and searchsorted); then the five set ops
    on int64 sets of SET_OPS_N of phase 7's ids on the card, each equal to
    its numpy meaning. Returns the device-branch combines it ran."""
    import torch

    from dgraph_tpu_torch.ops import uidset as us

    rng = np.random.default_rng(13)

    def draw(m, hi):
        """m distinct sorted uids below hi."""
        u = np.flatnonzero(rng.random(hi, dtype=np.float32) < 0.5)
        return np.sort(rng.choice(u, m, replace=False))

    def fail(msg):
        raise SystemExit(f"set_algebra: {msg}")

    ref = {"intersect": lambda x, y: x[member(x, y)],
           "union": lambda x, y: sorted_unique(np.concatenate([x, y])),
           "difference": lambda x, y: x[~member(x, y)]}
    line = {"combines": []}
    t_all, c_all = time.perf_counter(), device_combines()
    keep = us.HOST_CUTOVER
    for m in SET_COMBINE_SIZES:
        q = m // 4
        a_set = np.concatenate([draw(m - q - 1, 4 * m), [2 ** 31 - 1],
                                (1 << 32) + draw(q, 4 * m)])
        b_set = np.concatenate([draw(m - q - 1, 4 * m), [2 ** 31 - 1],
                                (1 << 32) + draw(q, 4 * m)])
        a_in = rng.permutation(np.concatenate(
            [a_set, a_set[rng.integers(0, m, m // 8)]]))
        row = {"min_len": m, "wide_uids": int((a_set >= 1 << 31).sum())}
        outs = {}
        for op, fn in (("intersect", us.intersect_host),
                       ("union", us.union_host),
                       ("difference", us.difference_host)):
            for (x, y), (xs, ys) in (((a_in, b_set), (a_set, b_set)),
                                     ((b_set, a_in), (b_set, a_set))):
                before = us.COMBINES[op][dev.type]
                us.HOST_CUTOVER = 0
                try:
                    t0 = time.perf_counter()
                    got = fn(x, y, dev)
                    dms = (time.perf_counter() - t0) * 1e3
                finally:
                    us.HOST_CUTOVER = keep
                want = ref[op](xs, ys)
                if us.COMBINES[op][dev.type] != before + 1:
                    fail(f"{op} at {m} did not run on the card")
                if got.dtype != np.int64 or not np.array_equal(got, want):
                    fail(f"{op} at {m}: {len(got)} uids != numpy "
                         f"{len(want)}")
                outs[op] = got
            row[op] = {"out": int(len(want)), "device_ms": dms}
        if 2 ** 31 - 1 not in outs["intersect"] or \
                not (outs["union"] >= 1 << 32).any():
            fail(f"no 2^31 - 1 or no uid past 2^32 came back at {m}")
        line["combines"].append(row)

    # the five ops on the card, int64 sets of phase 7's ids
    n = SET_OPS_N
    rows = [np.sort(rng.choice(ids, n // 2, replace=False))
            for _ in range(4)]
    mat = torch.stack([us.make_set(r, capacity=n, dtype=torch.int64,
                                   device=dev) for r in rows])
    s0, x0 = mat[0], rows[0]
    ops = {}
    got = us.merge_many(mat)
    ops["merge_many"] = got.shape == (4 * n,) and np.array_equal(
        us.to_numpy(got), sorted_unique(np.concatenate(rows)))
    want = rows[0]
    for r in rows[1:]:
        want = want[member(want, r)]
    got = us.intersect_many(mat, out_size=n)
    ops["intersect_many"] = got.shape == (n,) and \
        np.array_equal(us.to_numpy(got), want)
    mask = rng.random(n) < 0.3
    got = us.apply_filter(s0, torch.from_numpy(mask).to(dev))
    ops["apply_filter"] = got.shape == (n,) and \
        np.array_equal(us.to_numpy(got), x0[mask[: len(x0)]])
    probe = np.concatenate([x0[rng.integers(0, len(x0), 1000)],
                            ids[~member(ids, x0)][:1000],
                            [int(us.SENTINEL64)]])
    got = us.index_of(s0, torch.from_numpy(probe).to(dev))
    ops["index_of"] = got.dtype == torch.int32 and np.array_equal(
        got.cpu().numpy(), us.host_rank_of(x0, probe, -1))
    total, page_ok = len(x0), True
    for off, cnt in ((1000, 500), (-700, -1), (0, -1), (-(n + 5), 100),
                     (total - 3, 10)):
        o = max(total + off, 0) if off < 0 else off
        want = x0[o: total if cnt < 0 else o + cnt]
        got = us.paginate(s0, off, cnt)
        page_ok &= got.shape == (n,) and \
            np.array_equal(us.to_numpy(got), want)
    ops["paginate"] = bool(page_ok)
    torch.cuda.synchronize()
    bad = [k for k, ok in ops.items() if not ok]
    if bad:
        fail(f"{bad} differ from numpy at {n}")
    del mat
    forced = device_combines() - c_all
    say("set_algebra", seconds=time.perf_counter() - t_all,
        host_cutover=keep, forced_combines=forced, ops_n=n, ops=sorted(ops),
        **line)
    return forced


def values_phase(snap, schema, csr, seeds, dev) -> tuple[dict, int]:
    """Phase 7 on the headline snapshot: the set_algebra line, then adds
    age, score and name on every node id and runs the seven value
    requests. Returns the K1/K2 launches of the requests' default-path runs
    and the combines set_algebra forced onto the card."""
    import torch

    from dgraph_tpu_torch.ops import csr as csrops
    from dgraph_tpu_torch.ops import uidset as us
    from dgraph_tpu_torch.ops import prefix as px
    from dgraph_tpu_torch.query import dql
    from dgraph_tpu_torch.query import engine as eng
    from dgraph_tpu_torch.storage.csr_build import build_value_pred
    from dgraph_tpu_torch.utils.schema import parse_schema
    from dgraph_tpu_torch.utils.types import TypeID, Val

    subjects, indptr, indices = csr
    sync = torch.cuda.synchronize
    eng.set_query_edge_limit(1 << 31)      # phase 6 left it at 1 << 18
    n = 1 << SCALE
    ids = np.arange(1, n + 1, dtype=np.int64)
    forced = set_algebra(dev, ids)
    rng = np.random.default_rng(11)
    age = rng.integers(0, 100, n)
    cents = rng.integers(0, 10000, n)       # score: [0, 100), 2 decimals
    words = rng.integers(0, len(VOCAB), (n, 3))
    name_of = lambda u: "p%d %s %s %s" % (u, *(VOCAB[w] for w in
                                                 words[u - 1]))
    for e in parse_schema(VALUES_SCHEMA):
        schema.set(e)
    ulist = ids.tolist()
    rows = {
        "age": ((u, Val(TypeID.INT, a), "", ())
                for u, a in zip(ulist, age.tolist())),
        "score": ((u, Val(TypeID.FLOAT, c / 100), "", ())
                  for u, c in zip(ulist, cents.tolist())),
        "name": ((u, Val(TypeID.STRING, name_of(u)), "", ())
                 for u in ulist)}
    fold_s = {}
    for attr, r in rows.items():
        t0 = time.perf_counter()
        snap.preds[attr] = build_value_pred(attr, schema.get(attr), r,
                                            device=dev)
        fold_s[attr] = time.perf_counter() - t0
    say("values_fold", seconds=sum(fold_s.values()), per_predicate=fold_s,
        ids=n, index_terms={a: {k: len(ti.terms) for k, ti in
                                snap.preds[a].indexes.items()}
                            for a in rows})

    # numpy truth over the same data (index uid - 1)
    score = cents / 100
    row_of = lambda u: indices[indptr[int(np.searchsorted(subjects, u))]:
                               indptr[int(np.searchsorted(subjects, u)) + 1]
                               ].astype(np.int64)

    def execute(text):
        return json.dumps(eng.Executor(snap, schema).execute(dql.parse(text)))

    def host_json(text):
        return on_host(lambda: execute(text))

    def root_set(text):
        ex = eng.Executor(snap, schema)
        return ex._root_uids(dql.parse(text).queries[0])

    def fail(what, msg):
        raise SystemExit(f"values {what}: {msg}")

    seed_list = ", ".join(hex(int(u)) for u in seeds)
    w3 = " ".join(VOCAB[:3])
    picked = np.isin(words, [0, 1, 2]).any(axis=1)
    texts = {
        "index_range": "{ q(func: ge(age, 90), first: 1000) { uid age } }",
        "expand_filter": "{ q(func: uid(%s)) { uid friend @filter(ge(age, "
                         "50) AND has(name)) { uid age } } }" % seed_list,
        "terms_order": '{ q(func: anyofterms(name, "%s"), orderasc: score, '
                       'first: 20) { uid name score } }' % w3,
        "eq_exact": '{ q(func: eq(name, "%s")) { uid name age friend '
                    '(first: 10) { uid name score } } }'
                    % name_of(int(seeds[0])),
        "val_agg": "{ var(func: uid(%s)) { friend { a as age s as score "
                   "m as math(a * 2 + s) } } stats() { mn: min(val(a)) "
                   "mx: max(val(a)) sm: sum(val(a)) } q(func: uid(m), "
                   "orderdesc: val(m), first: 10) { uid val(m) } }"
                   % seed_list,
        # AND / OR / NOT over an index-backed function and value compares
        # on all ids: every combine's operands pass COMBINE_OPERAND_MIN
        "combine_filter": '{ F as var(func: has(age)) @filter((anyofterms('
                          'name, "%s") OR ge(score, 60)) AND NOT le(age, 20)) '
                          'q(func: uid(F), first: 1000) { uid age score } }'
                          % w3,
    }
    rtext = ("{ q(func: uid(%s)) @recurse(depth: 3) { age friend "
             "@filter(lt(age, %%d)) } }" % seed_list)
    hosts = {}
    for k in (8, 4, 2, 1):                  # phase 5's pick: largest that fits
        h = host_json(rtext % k)
        if 1000 < len(h) <= JSON_MAX_BYTES:
            texts["recurse_values"], hosts["recurse_values"] = rtext % k, h
            break
    else:
        fail("recurse_values", "no k gives 1 KB..10 MB of JSON")
    order = ["index_range", "expand_filter", "terms_order", "eq_exact",
             "recurse_values", "val_agg", "combine_filter"]
    for name in order:
        if name not in hosts:
            hosts[name] = host_json(texts[name])

    # the default path: one checked run of each, its launches and unions
    outs, stats = {}, {}
    px.reset_launches()
    for name in order:
        before = (dict(px.LAUNCHES), csrops.UNIONS["cuda"],
                  {op: c[dev.type] for op, c in us.COMBINES.items()})
        t0 = time.perf_counter()
        got = execute(texts[name])
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        if got != hosts[name]:
            fail(name, "default-path JSON differs from the host path")
        outs[name] = json.loads(got)
        stats[name] = {
            "first_ms": first_ms, "json_bytes": len(got),
            "launches": {k: v - before[0][k] for k, v in px.LAUNCHES.items()},
            "device_unions": csrops.UNIONS["cuda"] - before[1],
            "device_combines": {op: c[dev.type] - before[2][op]
                                for op, c in us.COMBINES.items()}}
    launches = dict(px.LAUNCHES)

    # held to numpy
    want = ids[age >= 90]
    got = root_set(texts["index_range"])
    if not np.array_equal(got, want):
        fail("index_range", f"root set {len(got)} uids != numpy {len(want)}")
    q = outs["index_range"]["q"]
    if [int(o["uid"], 16) for o in q] != want[:1000].tolist() or \
            any(o["age"] != int(age[int(o["uid"], 16) - 1]) for o in q):
        fail("index_range", "first 1000 rows differ from numpy")
    stats["index_range"]["root_uids"] = int(len(want))

    rows_seen = 0
    for obj in outs["expand_filter"]["q"]:
        u = int(obj["uid"], 16)
        t = row_of(u)
        t = t[age[t - 1] >= 50]
        got = [(int(o["uid"], 16), o["age"]) for o in obj.get("friend", [])]
        if got != [(int(x), int(age[x - 1])) for x in t]:
            fail("expand_filter", f"row of {hex(u)} differs from numpy")
        rows_seen += 1
    if rows_seen != len(seeds):
        fail("expand_filter", f"{rows_seen} rows for {len(seeds)} seeds")
    stats["expand_filter"]["edges"] = int(sum(len(row_of(u)) for u in seeds))

    want = ids[picked]
    got = root_set(texts["terms_order"])
    if not np.array_equal(got, want):
        fail("terms_order", f"root set {len(got)} uids != numpy {len(want)}")
    top = want[np.lexsort((want, score[want - 1]))][:20]
    q = outs["terms_order"]["q"]
    if [int(o["uid"], 16) for o in q] != top.tolist():
        fail("terms_order", "first 20 by score differ from numpy")
    sc = [o["score"] for o in q]
    if sc != sorted(sc) or any(
            o["name"] != name_of(int(o["uid"], 16))
            or not set(o["name"].split()[1:]) & set(VOCAB[:3]) for o in q):
        fail("terms_order", "scores decrease or a name lacks the words")
    stats["terms_order"]["root_uids"] = int(len(want))

    q = outs["eq_exact"]["q"]
    s0 = int(seeds[0])
    t = row_of(s0)[:10]
    if len(q) != 1 or int(q[0]["uid"], 16) != s0 or \
            q[0]["age"] != int(age[s0 - 1]) or \
            [(int(o["uid"], 16), o["name"], o["score"]) for o in
             q[0].get("friend", [])] != \
            [(int(x), name_of(int(x)), float(score[x - 1])) for x in t]:
        fail("eq_exact", "not exactly the one seed with its values")

    if not any(stats["recurse_values"]["launches"].values()):
        fail("recurse_values", "launched neither K1 nor K2")
    stats["recurse_values"]["k"] = k

    targets = np.unique(np.concatenate([row_of(u) for u in seeds]))
    a = age[targets - 1]
    agg = {k: v for d in outs["val_agg"]["stats"] for k, v in d.items()}
    if agg != {"mn": int(a.min()), "mx": int(a.max()), "sm": int(a.sum())}:
        fail("val_agg", f"{agg} != numpy over {len(targets)} targets")
    m = 2.0 * a + score[targets - 1]
    top = np.lexsort((targets, -m))[:10]
    if [(int(o["uid"], 16), o["val(m)"]) for o in outs["val_agg"]["q"]] != \
            [(int(targets[i]), float(m[i])) for i in top]:
        fail("val_agg", "first 10 by val(m) differ from numpy")
    stats["val_agg"]["targets"] = int(len(targets))

    for name in ("index_range", "terms_order"):
        if stats[name]["device_unions"] == 0:
            fail(name, "the device union did not run")

    sets = {"anyofterms": picked, "ge_score": score >= 60,
            "le_age": age <= 20}
    sets["or"] = sets["anyofterms"] | sets["ge_score"]
    sets["not"] = ~sets["le_age"]
    keep = sets["or"] & sets["not"]
    want = ids[keep]
    ex = eng.Executor(snap, schema)
    ex.execute(dql.parse(texts["combine_filter"]))
    got = ex.vars["F"].uids
    if not np.array_equal(got, want):
        fail("combine_filter", f"F holds {len(got)} uids != numpy "
             f"{len(want)}")
    if [(int(o["uid"], 16), o["age"], o["score"])
            for o in outs["combine_filter"]["q"]] != \
            [(int(u), int(age[u - 1]), float(score[u - 1]))
             for u in want[:1000]]:
        fail("combine_filter", "first 1000 rows differ from numpy")
    operands = {k: int(v.sum()) for k, v in sets.items()}
    small = {k: v for k, v in operands.items() if v < COMBINE_OPERAND_MIN}
    if small:
        fail("combine_filter", f"operands below {COMBINE_OPERAND_MIN}: "
             f"{small}")
    stats["combine_filter"].update(
        operands=operands, matched=int(len(want)), host_cutover=us.HOST_CUTOVER,
        reached_cutover=min(operands.values()) >= us.HOST_CUTOVER)
    if stats["combine_filter"]["reached_cutover"] and \
            not all(stats["combine_filter"]["device_combines"].values()):
        fail("combine_filter", "an operand passed HOST_CUTOVER but a "
             "combine stayed on the host")

    # timing: 3 runs after the checked one (5 until phase 9b came: the
    # script's time limit); profiles of two requests
    for name in order:
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            execute(texts[name])
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        line = dict(stats[name], ms=band(ms), query=texts[name][:120])
        if name == "combine_filter":
            hms = []
            for _ in range(3):
                t0 = time.perf_counter()
                host_json(texts[name])
                hms.append((time.perf_counter() - t0) * 1e3)
            line["host_ms"] = band(hms)
        if name in ("expand_filter", "terms_order", "combine_filter"):
            line["profile"] = profile_query(lambda: execute(texts[name]))
        say("value_request", request=name, **line)
    return launches, forced



def groupby_phase(snap, schema, csr, wide) -> dict:
    """Phase 7b over phase 7's snapshot: request (a), a uid key over the
    widened uid set `wide`, and request (b), a value key over every node id, each
    through Executor.execute with the device route (the fused segmented
    reduce, and for (a) the device rank search) asserted by counters read
    around it, byte-identical to the host route and equal to numpy.
    Returns each request's JSON."""
    import torch

    from dgraph_tpu_torch.ops import segments as segs
    from dgraph_tpu_torch.query import dql
    from dgraph_tpu_torch.query import engine as eng
    from dgraph_tpu_torch.query import groupby as gb
    from dgraph_tpu_torch.utils.metrics import Registry

    sync = torch.cuda.synchronize
    age = snap.pred("age").num_values_host.astype(np.int64)   # uid - 1
    snap.metrics = Registry()
    reduces = snap.metrics.counter("dgraph_agg_device_reduces_total")

    def execute(text):
        return json.dumps(eng.Executor(snap, schema).execute(dql.parse(text)))

    def on_host_route(text):
        kept = gb._HOST_AGG_MAX, segs._RANK_DEVICE_MIN
        gb._HOST_AGG_MAX = segs._RANK_DEVICE_MIN = 1 << 62
        try:
            return execute(text)
        finally:
            gb._HOST_AGG_MAX, segs._RANK_DEVICE_MIN = kept

    edges = int(sum(np.diff(csr[1])[np.searchsorted(csr[0], wide)]))
    requests = {
        "groupby_uid": (groupby_uid_text(wide),
                        groupby_uid_numpy(csr, age, wide), True),
        "groupby_value": (GROUPBY_VALUE, groupby_value_numpy(age), False)}
    jsons = {}
    for name, (text, want, ranks) in requests.items():
        before = reduces.value, segs.REDUCES["cuda"], segs.RANKS["cuda"]
        t0 = time.perf_counter()
        got = execute(text)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        ran = {"agg_device_reduces": reduces.value - before[0],
               "segment_reduces_cuda": segs.REDUCES["cuda"] - before[1],
               "rank_searches_cuda": segs.RANKS["cuda"] - before[2]}
        if ran["agg_device_reduces"] == 0 or ran["segment_reduces_cuda"] == 0:
            raise SystemExit(f"{name}: the device reduce did not run: {ran}")
        if ranks and ran["rank_searches_cuda"] == 0:
            raise SystemExit(f"{name}: the device rank search did not run")
        if on_host_route(text) != got:
            raise SystemExit(f"{name}: JSON differs from the host route")
        rows = json.loads(got)["q"][0]["@groupby"]
        if rows != want:
            raise SystemExit(f"{name}: {len(rows)} groups differ from numpy "
                             f"({len(want)} groups)")
        jsons[name] = got
        ms = []
        for _ in range(3):       # 5 until phase 9b came (the time limit)
            t0 = time.perf_counter()
            execute(text)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        line = {"request": name, "groups": len(rows), "json_bytes": len(got),
                "first_ms": first_ms, "ms": band(ms), **ran}
        if name == "groupby_uid":
            line.update(uids=int(len(wide)), edges=edges,
                        profile=profile_query(lambda: execute(text)))
        else:
            line["members"] = int(len(age))
        say("groupby_request", **line)
    snap.metrics = None
    return jsons


def storage_phase(snap4, schema4, csr, rev, seeds, expand_seeds, wide,
                  json_recurse, n_ids, ckpt_dir, dev) -> tuple[dict, dict,
                                                              dict]:
    """Phase 8: the headline graph (with its REVERSE keys) and `age` on
    every node id loaded into the port's Store (a directory, ckpt_dir)
    through bulk_install, folded, read through a SnapshotAssembler, written
    to by a seeded program of COMMITS transactions (one more aborted) and
    read again through the delta overlays, then compacted and checkpointed
    at the last commit. snap4/schema4 are phase 4's carried snapshot (with
    phase 7's `age`, the same data); json_recurse is a one-uid
    @recurse(depth: 3) whose JSON fits JSON_MAX_BYTES; wide is the expand
    frontier and phase 7b's uid set. Returns the K1/K2 launches of the two
    counted 128-seed @recurse runs, the JSON of json_recurse and of phase
    7b's request (a) over the compaction, which phase 9 serves from the
    checkpoint, and the lists as loaded (before any commit), which phase
    14's groups install: "friend" and "age" ({key: packed row}: friend with
    ~friend, age's index) and "age_values" ({key: its age posting})."""
    import threading

    import torch

    from dgraph_tpu_torch.ops import csr as csrops
    from dgraph_tpu_torch.ops import prefix as px
    from dgraph_tpu_torch.ops import pull_bfs as pb
    from dgraph_tpu_torch.query import dql, mutation, rdf
    from dgraph_tpu_torch.query import engine as eng
    from dgraph_tpu_torch.storage import keys as K
    from dgraph_tpu_torch.storage import native
    from dgraph_tpu_torch.storage.csr_build import (
        PredCSR, SnapshotAssembler, build_snapshot)
    from dgraph_tpu_torch.storage.delta import LazyTokenIndex, OverlayCSR
    from dgraph_tpu_torch.storage.index import index_tokens
    from dgraph_tpu_torch.storage.postings import VALUE_UID, Op, Posting
    from dgraph_tpu_torch.utils.schema import parse_schema
    from dgraph_tpu_torch.utils.types import TypeID, Val

    subjects, indptr, indices = csr
    rsub, rptr, ridx = rev
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()

    def fail(what, msg):
        raise SystemExit(f"storage {what}: {msg}")

    # ---- load: bulk_install of packed lists, as loader/bulk.py's reduce ---
    if not native.available():
        fail("load", "the native codec did not build")
    load = {}
    t0 = time.perf_counter()
    keys = encoded_keys(K.data_key, "friend", subjects)
    rows = np.split(indices.astype(np.uint64), indptr[1:-1])
    keys += encoded_keys(K.reverse_key, "friend", rsub)
    rows += np.split(ridx.astype(np.uint64), rptr[1:-1])
    load["friend_rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids = np.arange(1, n_ids + 1, dtype=np.int64)
    age = np.random.default_rng(11).integers(0, 100, n_ids)   # phase 7's
    by_age = [Posting(VALUE_UID, Op.SET, Val(TypeID.INT, a))
              for a in range(100)]
    age_values = dict(zip(encoded_keys(K.data_key, "age", ids),
                          (by_age[a] for a in age.tolist())))
    ikeys, irows = [], []
    entry = parse_schema(STORE_SCHEMA)[1]
    order = np.argsort(age, kind="stable")
    cuts = np.searchsorted(age[order], np.arange(101))
    for a in range(100):
        members = ids[order[cuts[a]: cuts[a + 1]]].astype(np.uint64)
        if len(members):
            for tk in index_tokens(entry, Val(TypeID.INT, a)):
                ikeys.append(K.index_key("age", tk).encode())
                irows.append(members)
    load["age_rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lists = {"friend": packed_rows(keys, rows),
             "age": packed_rows(ikeys, irows), "age_values": age_values}
    load["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = packed_store(STORE_SCHEMA, {**lists["friend"], **lists["age"]},
                         age_values, dirpath=ckpt_dir)
    schema = store.schema
    load["install"] = time.perf_counter() - t0
    del keys, rows, ikeys, irows
    say("storage_load", seconds=load, native=native.available(),
        keys=len(store.lists), ids=n_ids)

    # ---- fold: the eager build_snapshot, held to the input arrays ---------
    t0 = time.perf_counter()
    full = build_snapshot(store, 1, device=dev)
    fold_s = time.perf_counter() - t0
    fr, ag = full.pred("friend"), full.pred("age")
    for what, got, want in (("friend", fr.csr, csr), ("~friend", fr.rev_csr,
                                                      rev)):
        if not all(np.array_equal(g, w)
                   for g, w in zip(got.host_arrays(), want)):
            fail("fold", f"{what} CSR differs from the input arrays")
    if not (np.array_equal(ag.value_subjects_host, ids) and np.array_equal(
            ag.num_values_host, age.astype(np.float64))):
        fail("fold", "age's value table differs from numpy")
    del full, fr, ag

    # ---- the assembler's lazy folds and phase 4's @recurse over them -----
    asm = SnapshotAssembler(store, device=dev)
    s1 = asm.snapshot(1)
    per_pred = {}
    for attr in ("friend", "age"):
        t0 = time.perf_counter()
        s1.pred(attr)
        per_pred[attr] = time.perf_counter() - t0
    say("storage_fold", build_snapshot_seconds=fold_s,
        lazy_fold_seconds=per_pred, native=native.available())

    req = dql.parse("{ q(func: uid(%s)) @recurse(depth: 3) { friend } }"
                    % ", ".join(hex(int(u)) for u in seeds))

    def levels(snap, sch):
        """The 128-seed @recurse through the engine (phase 4's run_block):
        each level's dest uids."""
        sg = eng.SubGraph(gq=req.queries[0], attr=req.queries[0].attr)
        eng.Executor(snap, sch)._process_block(sg)
        out = []
        while sg.children:
            sg = sg.children[0]
            out.append(sg.dest_uids)
        return out

    def execute(snap, text, sch=schema):
        return json.dumps(eng.Executor(snap, sch).execute(dql.parse(text)))

    def counted(fn):
        px.reset_launches()
        out = fn()
        sync()
        return out, dict(px.LAUNCHES)

    def p50(fn, runs=5):
        ms = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return band(ms)

    def same_levels(a, b, what):
        if len(a) != len(b) or not all(np.array_equal(x, y)
                                       for x, y in zip(a, b)):
            fail(what, "@recurse levels differ from the reference")

    def launched(what, launches):
        if min(launches.values()) == 0:
            fail(what, f"a kernel never launched: {launches}")

    t_step = time.perf_counter()
    ref_levels = levels(snap4, schema4)
    ref_json = execute(snap4, json_recurse, schema4)
    t0 = time.perf_counter()
    pb.pull_graph_for(s1.pred("friend").csr)
    sync()
    prep_store = time.perf_counter() - t0
    got, l_store = counted(lambda: levels(s1, schema))
    same_levels(got, ref_levels, "recurse_store")
    if execute(s1, json_recurse) != ref_json:
        fail("recurse_store", "JSON differs from phase 4's snapshot")
    launched("recurse_store", l_store)
    # the same request over phase 4's carried snapshot, timed and profiled
    # beside it: what the store-built snapshot adds
    say("storage_request", request="recurse_store", launches=l_store,
        levels=[int(len(x)) for x in got], prep_pull_seconds=prep_store,
        json_bytes=len(ref_json), json_query=json_recurse[:120],
        ms=p50(lambda: levels(s1, schema)),
        ms_phase4_snapshot=p50(lambda: levels(snap4, schema4)),
        profile=profile_query(lambda: levels(s1, schema)),
        profile_phase4_snapshot=profile_query(
            lambda: levels(snap4, schema4)),
        step_seconds=time.perf_counter() - t_step)

    # ---- commits: the seeded write program, each made visible ------------
    base = s1.pred("friend").csr
    base_rev = s1.pred("friend").rev_csr
    ptrs = [t.data_ptr() for c in (base, base_rev) for t in c.device_arrays()]
    rng = np.random.default_rng(13)
    pool = np.sort(rng.choice(expand_seeds, min(COMMIT_POOL,
                                                len(expand_seeds)),
                              replace=False))
    at = np.searchsorted(subjects, pool)
    model = {int(u): set(indices[indptr[p]: indptr[p + 1]].tolist())
             for u, p in zip(pool, at)}
    ages = age.copy()
    probe_q = "{ q(func: uid(%s)) { age friend { uid } } }"

    def write(start, set_nq, del_nq):
        edges = (mutation.to_edges(rdf.parse(set_nq), {}, Op.SET)
                 + mutation.to_edges(rdf.parse(del_nq), {}, Op.DEL))
        return mutation.apply_mutations(store, edges, start)[0]

    def probe(snap, u):
        q = eng.Executor(snap, schema).execute(dql.parse(probe_q % hex(u)))
        return q["q"][0] if q.get("q") else {}

    def held_probe(obj, u, what):
        if sorted(int(o["uid"], 16) for o in obj.get("friend", [])) != \
                sorted(model.get(u, ())) or obj.get("age") != int(ages[u - 1]):
            fail(what, f"probe of {hex(u)} differs from the write program")

    t_step = time.perf_counter()
    parts = {"write": [], "commit": [], "snapshot": [], "probe": [],
             "visible": []}
    aborted = None
    for k in range(COMMITS):
        cts = k + 2
        sets, dels = [], []
        for _ in range(4):
            u, o = int(rng.choice(pool)), int(rng.integers(1, n_ids + 1))
            model[u].add(o)
            sets.append(f"<{hex(u)}> <friend> <{hex(o)}> .")
        who = int(sets[0].split()[0][1:-1], 16)    # the probed subject
        for _ in range(2):
            u = int(rng.choice(pool))
            if model[u]:
                o = int(rng.choice(sorted(model[u])))
                model[u].discard(o)
                dels.append(f"<{hex(u)}> <friend> <{hex(o)}> .")
        for _ in range(2):
            u, a = int(rng.integers(1, n_ids + 1)), int(rng.integers(0, 100))
            ages[u - 1] = a
            sets.append(f'<{hex(u)}> <age> "{a}"^^<xs:int> .')
        if k == COMMITS // 2:
            # a write that is aborted: never visible
            aborted = (int(pool[0]), n_ids)
            touched = write(cts - 1, f"<{hex(aborted[0])}> <friend> "
                            f"<{hex(aborted[1])}> .\n<{hex(aborted[0])}> "
                            f'<age> "999"^^<xs:int> .', "")
            store.abort(cts - 1, touched)
        t0 = time.perf_counter()
        touched = write(cts - 1, "\n".join(sets), "\n".join(dels))
        t1 = time.perf_counter()
        store.commit(cts - 1, cts, touched)
        t2 = time.perf_counter()
        snap = asm.snapshot(cts)
        t3 = time.perf_counter()
        obj = probe(snap, who)
        sync()
        t4 = time.perf_counter()
        for name, dt in (("write", t1 - t0), ("commit", t2 - t1),
                         ("snapshot", t3 - t2), ("probe", t4 - t3),
                         ("visible", t4 - t1)):
            parts[name].append(dt * 1e3)
        held_probe(obj, who, f"commit {cts}")
        fr = snap.pred("friend")
        if not (isinstance(fr.csr, OverlayCSR)
                and isinstance(fr.rev_csr, OverlayCSR)
                and isinstance(snap.pred("age").indexes["int"],
                               LazyTokenIndex)):
            fail("commits", f"commit {cts} was folded, not stamped")
        if fr.csr.base is not base or fr.rev_csr.base is not base_rev or \
                [t.data_ptr() for c in (base, base_rev)
                 for t in c.device_arrays()] != ptrs:
            fail("commits", f"commit {cts} replaced the base's tensors")
        if aborted is not None and k == COMMITS // 2:
            held_probe(probe(snap, aborted[0]), aborted[0], "aborted write")
    last_ts = COMMITS + 1
    depth = {a: len(store.delta_since(a, 1) or ()) for a in ("friend", "age")}
    say("storage_commits", commits=COMMITS, aborted=1, pool=len(pool),
        overlay_keys=depth, overlay_stats=asm.overlay_stats(),
        ms={k: band(v) for k, v in parts.items()},
        step_seconds=time.perf_counter() - t_step)
    if max(depth.values()) >= asm.OVERLAY_MAX_KEYS:
        fail("commits", f"touched keys {depth} reach OVERLAY_MAX_KEYS")

    # ---- requests over the last overlay snapshot --------------------------
    # each is held here to the host path and to numpy, and below to the same
    # request over a from-scratch fold of the store at last_ts: compaction
    # folds each predicate again with build_snapshot's _build_pred
    last = asm.snapshot(last_ts)
    t_step = time.perf_counter()
    # phase 5's expand from the seeds, widened by the largest rows until the
    # base side alone passes EXPAND_EDGES, with the overlay's rows spliced in
    frontier = wide
    ex_q = "{ q(func: uid(%s)) { uid friend { uid } } }" % ", ".join(
        hex(int(u)) for u in frontier)
    m0 = csrops.MASKED[dev.type]
    t0 = time.perf_counter()
    ex_json = execute(last, ex_q)
    sync()
    ex_ms = (time.perf_counter() - t0) * 1e3
    masked = csrops.MASKED[dev.type] - m0
    if masked == 0:
        fail("overlay_expand", f"expand_masked did not run on {dev.type}")
    if on_host(lambda: execute(last, ex_q)) != ex_json:
        fail("overlay_expand", "JSON differs from the host path")
    got = {int(o["uid"], 16): [int(x["uid"], 16) for x in o["friend"]]
           for o in json.loads(ex_json)["q"] if "friend" in o}
    want = {}
    for u in frontier.tolist():
        p = int(np.searchsorted(subjects, u))
        row = sorted(model[u]) if u in model else \
            indices[indptr[p]: indptr[p + 1]].tolist()
        if row:
            want[u] = row
    if got != want:
        fail("overlay_expand", "rows differ from numpy after the edits")
    say("storage_request", request="overlay_expand", expand_masked=masked,
        frontier=int(len(frontier)),
        edges=int(sum(len(r) for r in want.values())),
        json_bytes=len(ex_json), first_ms=ex_ms,
        step_seconds=time.perf_counter() - t_step)

    # the merged host CSR is built already: the first uid(...) root over
    # each new snapshot merges it (engine._known_uids, in every probe)
    t_step = time.perf_counter()
    ov = last.pred("friend").csr
    t0 = time.perf_counter()
    pb.pull_graph_for(ov)
    sync()
    prep_s = time.perf_counter() - t0
    got_levels, l_ov = counted(lambda: levels(last, schema))
    rec_json = execute(last, json_recurse)
    launched("overlay_recurse", l_ov)
    say("storage_request", request="overlay_recurse", launches=l_ov,
        levels=[int(len(x)) for x in got_levels], prep_pull_seconds=prep_s,
        json_bytes=len(rec_json), ms=p50(lambda: levels(last, schema)),
        step_seconds=time.perf_counter() - t_step)

    t_step = time.perf_counter()
    ix_q = "{ q(func: ge(age, 90), orderasc: age, first: 100) { uid age } }"
    u0 = csrops.UNIONS[dev.type]
    t0 = time.perf_counter()
    ix_json = execute(last, ix_q)
    sync()
    ix_ms = (time.perf_counter() - t0) * 1e3
    unions = csrops.UNIONS[dev.type] - u0
    if unions == 0:
        fail("overlay_index", f"no union ran on {dev.type}")
    root = eng.Executor(last, schema)._root_uids(dql.parse(ix_q).queries[0])
    want = ids[ages >= 90]
    if not np.array_equal(root, want):
        fail("overlay_index", f"root set {len(root)} != numpy {len(want)}")
    top = want[np.lexsort((want, ages[want - 1]))][:100]
    if [(int(o["uid"], 16), o["age"]) for o in json.loads(ix_json)["q"]] \
            != [(int(u), int(ages[u - 1])) for u in top]:
        fail("overlay_index", "first 100 by age differ from numpy")
    say("storage_request", request="overlay_index", device_unions=unions,
        root_uids=int(len(want)), first_ms=ix_ms,
        profile=profile_query(lambda: execute(last, ix_q)),
        step_seconds=time.perf_counter() - t_step)

    # ---- compaction: a from-scratch fold at last_ts, the same answers -----
    t_step = time.perf_counter()
    done = asm.compact(threading.Lock(), force=True)
    compact_s = time.perf_counter() - t_step
    post = asm.snapshot(last_ts)
    fr, fr_last = post.pred("friend"), last.pred("friend")
    if isinstance(fr.csr, OverlayCSR) or not isinstance(fr.csr, PredCSR) \
            or fr.csr is base or store.pred_commit_ts.get("friend") != last_ts:
        fail("compact", f"friend is {type(fr.csr).__name__} after "
                        f"compaction, not a fold at ts {last_ts}")
    # the byte-identity contract: the stamped views equal the fold
    for what, a, b in (("friend", fr_last.csr, fr.csr),
                       ("~friend", fr_last.rev_csr, fr.rev_csr)):
        if not all(np.array_equal(x, y)
                   for x, y in zip(a.host_arrays(), b.host_arrays())):
            fail("compact", f"{what}'s overlay differs from the fold")
    ag, ag_last = post.pred("age"), last.pred("age")
    if not (np.array_equal(ag.value_subjects_host, ag_last.value_subjects_host)
            and np.array_equal(ag.num_values_host, ag_last.num_values_host)
            and np.array_equal(ag.value_subjects_host, ids)
            and np.array_equal(ag.num_values_host, ages.astype(np.float64))):
        fail("compact", "age's value table differs from the overlay or numpy")
    same_levels(levels(post, schema), got_levels, "overlay_recurse")
    for what, text, want_json in (("overlay_expand", ex_q, ex_json),
                                  ("overlay_recurse", json_recurse, rec_json),
                                  ("overlay_index", ix_q, ix_json)):
        if execute(post, text) != want_json:
            fail(what, "JSON differs from a from-scratch fold")
    # phase 7b's request (a) over the compaction, for phase 9 to serve
    t0 = time.perf_counter()
    gb_json = execute(post, groupby_uid_text(wide))
    gb_s = time.perf_counter() - t0
    say("storage_compact", compacted=done, seconds=compact_s,
        groupby_uid_seconds=gb_s, groupby_uid_json_bytes=len(gb_json),
        step_seconds=time.perf_counter() - t_step)

    # ---- checkpoint at the last commit, for phase 9's Node ---------------
    t_step = time.perf_counter()
    store.checkpoint(last_ts)
    store.close()
    say("storage_checkpoint", ts=last_ts,
        rows=store.last_checkpoint_stats["rows"],
        peak_transient_bytes=store.last_checkpoint_stats[
            "peak_transient_bytes"],
        bytes=sum(f.stat().st_size for f in Path(ckpt_dir).iterdir()),
        step_seconds=time.perf_counter() - t_step,
        phase_seconds=time.perf_counter() - t_phase)
    return ({k: l_store[k] + l_ov[k] for k in l_store},
            {"recurse": rec_json, "groupby_uid": gb_json}, lists)


def serve_phase(ckpt_dir, expected, wide, json_recurse, n_ids, dev,
                wire) -> dict:
    """Phase 9: serving through the port's Node on the card. The golden
    battery through alter -> mutate -> query (every answer equal to
    tests/golden/expected.json), an upsert and a conflicting pair; then a
    Node opened over phase 8's checkpoint serves phase 5's one-uid
    @recurse (K1 or K2 launched) and phase 7b's request (a), each
    byte-identical to phase 8's JSON over its compaction, hands itself to
    `wire(node)` (phase 10's servers, over the same state), and reads back
    SERVE_TXNS transactions of its own (commit-to-visible). Returns the
    K1/K2 launches of the @recurse request and what `wire` returned."""
    import torch

    from dgraph_tpu_torch.api.server import Node
    from dgraph_tpu_torch.coord.zero import TxnConflict
    from dgraph_tpu_torch.ops import prefix as px
    from dgraph_tpu_torch.query import dql

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()

    def fail(what, msg):
        raise SystemExit(f"serve {what}: {msg}")

    def timed_query(node, text):
        t0 = time.perf_counter()
        out = json.dumps(node.query(text)[0])
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    # ---- the golden battery, an upsert and a conflicting pair -------------
    t_step = time.perf_counter()
    schema_text, nquads, queries, want = golden_battery()
    node = Node(device=dev)
    try:
        node.alter(schema_text=schema_text)
        node.mutate(set_nquads=nquads, commit_now=True)
        for name, q in queries:
            got = json.loads(json.dumps(node.query(q)[0], default=str))
            if got != want[name]:
                fail("golden", f"{name} differs from expected.json")
        if sorted(n for n, _ in queries) != sorted(want):
            fail("golden", "the battery and expected.json name other queries")
        up = dql.parse('upsert { query { v as var(func: eq(email, '
                       '"new@films.io")) } mutation @if(eq(len(v), 0)) '
                       '{ set { _:n <email> "new@films.io" . _:n <name> '
                       '"newcomer" . } } }').upsert
        made = [node.upsert(up["query"], up["mutations"],
                            commit_now=True)[1] for _ in range(2)]
        if len(made[0]) != 1 or made[1]:
            fail("upsert", f"assigned {made}, want one uid then none")
        if node.query('{ q(func: eq(email, "new@films.io")) { name } }')[0] \
                != {"q": [{"name": "newcomer"}]}:
            fail("upsert", "the inserted node does not read back")
        t1, t2 = node.new_txn(), node.new_txn()
        for t, mail in ((t1, "one"), (t2, "two")):
            node.mutate(set_nquads=f'<0x1000> <email> "{mail}@films.io" .',
                        start_ts=t.start_ts)
        node.commit(t1.start_ts)
        try:
            node.commit(t2.start_ts)
            fail("conflict", "the second committer was not refused")
        except TxnConflict:
            pass
        if node.query('{ q(func: uid(0x1000)) { email } }')[0] != \
                {"q": [{"email": "one@films.io"}]}:
            fail("conflict", "the first committer's write is not visible")
    finally:
        node.close()
    say("serve_golden", queries=len(queries),
        step_seconds=time.perf_counter() - t_step)

    # ---- the headline graph from phase 8's checkpoint ----------------------
    t0 = time.perf_counter()
    node = Node(dirpath=ckpt_dir, device=dev)
    open_s = time.perf_counter() - t0
    try:
        px.reset_launches()
        rec_json, first_ms = timed_query(node, json_recurse)
        launches = dict(px.LAUNCHES)
        if rec_json != expected["recurse"]:
            fail("recurse", "JSON differs from phase 8's compaction")
        if not any(launches.values()):
            fail("recurse", f"launched neither K1 nor K2: {launches}")
        gb_json, gb_first_ms = timed_query(node, groupby_uid_text(wide))
        if gb_json != expected["groupby_uid"]:
            fail("groupby_uid", "JSON differs from phase 8's compaction")
        t_wire = time.perf_counter()
        wired = wire(node)
        wire_s = time.perf_counter() - t_wire

        # read-your-writes: SERVE_TXNS commits, each probed right after
        rng = np.random.default_rng(17)
        probe = "{ q(func: uid(%s)) { age friend { uid } } }"
        visible = []
        for _ in range(SERVE_TXNS):
            u = int(rng.choice(wide))
            objs = rng.choice(np.arange(1, n_ids + 1), 4, replace=False)
            a = int(rng.integers(0, 100))
            nq = "\n".join([f"<{hex(u)}> <friend> <{hex(int(o))}> ."
                            for o in objs]
                           + [f'<{hex(u)}> <age> "{a}"^^<xs:int> .'])
            t0 = time.perf_counter()
            node.mutate(set_nquads=nq, commit_now=True)
            got = node.query(probe % hex(u))[0]["q"][0]
            sync()
            visible.append((time.perf_counter() - t0) * 1e3)
            seen = {int(o["uid"], 16) for o in got.get("friend", [])}
            if got.get("age") != a or not {int(o) for o in objs} <= seen:
                fail("read_your_writes", f"the writes to {hex(u)} do not "
                                         f"read back")
        say("serve", open_seconds=open_s, first_query_ms=first_ms,
            groupby_uid_first_ms=gb_first_ms,
            commit_to_visible_ms=band(visible), txns=SERVE_TXNS,
            launches=launches,
            recurse_json_bytes=len(rec_json),
            groupby_uid_json_bytes=len(gb_json),
            first_query_since_open_ms=node.metrics.counter(
                "dgraph_first_query_ms").value,
            phase_seconds=time.perf_counter() - t_phase - wire_s,
            wire_seconds=wire_s)
    finally:
        node.close()
    return launches, wired


def http_call(port, method, path, body=None, headers=None, timeout=300):
    """(status, body bytes) of one request to 127.0.0.1:port."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
            headers = {"Content-Type": "application/json", **(headers or {})}
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class CliProcess:
    """`python -m dgraph_tpu_torch <args>` started as a user starts it, its
    output read by a thread that stamps each line's arrival, so its start
    time reads right however late its lines are read; stop() kills it if
    it is still running."""

    def __init__(self, *args):
        import queue
        import threading

        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dgraph_tpu_torch", *args],
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines: queue.Queue = queue.Queue()
        self.log: list[str] = []
        self.reader = threading.Thread(target=self._pump, daemon=True)
        self.reader.start()

    def _pump(self):
        for ln in self.proc.stdout:
            self.log.append(ln)
            self.lines.put((time.perf_counter(), ln))
        self.lines.put((time.perf_counter(), None))

    def banner(self, timeout=240.0):
        """(port, line, seconds from start) of its `... serving ... on
        host:port` line; fails if the process ends or never says it."""
        import queue
        import re

        end = time.perf_counter() + timeout
        while True:
            try:
                t, ln = self.lines.get(timeout=max(end - time.perf_counter(),
                                                   0.01))
            except queue.Empty:
                ln = None
            if ln is None:
                raise SystemExit(f"cli {self.proc.args[3]}: no serving "
                                 f"line: {''.join(self.log)[-2000:]}")
            m = re.search(r"serving .* on [\w.]+:(\d+)", ln)
            if m:
                return int(m.group(1)), ln.strip(), t - self.t0

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self.reader.join(timeout=10)


class CliServer(CliProcess):
    """`python -m dgraph_tpu_torch serve` with --device at its default, its
    gRPC port `gport` picked here and its HTTP port by the server. Phase
    9's starts before phase 9 opens its Node, so its start (torch import,
    CUDA context) overlaps that open. `args` go after serve's own (phase
    13: -p DIR)."""

    def __init__(self, *args):
        self.gport = free_port()
        super().__init__("serve", "--port", "0", "--grpc_port",
                         str(self.gport), *args)


def cli_phase(cli: CliServer, dev) -> dict:
    """Phase 10 (a): the CLI server of `cli`; its HTTP banner must name
    `dev`. Over its HTTP port: /alter the golden schema, /mutate its
    N-Quads with commitNow, the 38 golden queries (data equal to
    expected.json), a conflicting pair (409) and /metrics parsed as
    Prometheus text; over its gRPC port, through the port's client, the 38
    queries again (json equal to expected.json); then /admin/shutdown, and
    the process exits 0. Every reply's status is checked with its payload:
    the handler turns any exception, a device error included, into a 400
    envelope."""
    import queue

    import grpc

    from dgraph_tpu_torch.api.grpc_client import DgraphClient
    from dgraph_tpu_torch.obs import prom
    from dgraph_tpu_torch.protos import api_pb2 as pbm

    def fail(what, msg):
        raise SystemExit(f"wire_cli {what}: {msg}")

    def ok(status, body, what):
        if status != 200:
            fail(what, f"status {status}: {body[:300]!r}")
        return json.loads(body)

    t_phase = time.perf_counter()
    proc, gport, log = cli.proc, cli.gport, cli.log
    client = None
    try:
        banners = {}
        while len(banners) < 2:
            try:
                t_line, ln = cli.lines.get(timeout=180)
            except queue.Empty:
                fail("start", f"no banners in 180 s: {''.join(log)[-2000:]}")
            if ln is None:
                fail("start", f"exited {proc.wait()}: {''.join(log)[-2000:]}")
            for role in ("gRPC", "HTTP"):
                if ln.startswith(f"serving {role} on "):
                    banners[role] = ln
        start_s = t_line - cli.t0
        hport = int(banners["HTTP"].split()[3].rsplit(":", 1)[1])
        if f"device={dev}" not in banners["HTTP"].split():
            fail("start", f"the server is not on {dev}: {banners['HTTP']}")
        if not banners["gRPC"].startswith(f"serving gRPC on 127.0.0.1:{gport}"):
            fail("start", f"gRPC banner {banners['gRPC']!r}")

        t_steps = time.perf_counter()
        schema_text, nquads, queries, want = golden_battery()
        if sorted(n for n, _ in queries) != sorted(want):
            fail("golden", "the battery and expected.json name other queries")
        ok(*http_call(hport, "POST", "/alter", schema_text), "alter")
        out = ok(*http_call(hport, "POST", "/mutate?commitNow=true",
                            "{ set {\n" + nquads + "\n} }"), "mutate")
        if not out["extensions"]["txn"]["commit_ts"]:
            fail("mutate", f"not committed: {out}")
        for name, q in queries:
            got = ok(*http_call(hport, "POST", "/query", q), name)["data"]
            if got != want[name]:
                fail("golden_http", f"{name} differs from expected.json")
        channel = grpc.insecure_channel(f"127.0.0.1:{gport}")
        client = DgraphClient(channel=channel)
        grpc.channel_ready_future(channel).result(timeout=60)
        for name, q in queries:
            resp = client._query(pbm.Request(query=q, read_only=True),
                                 timeout=120)
            if json.loads(resp.json) != want[name]:
                fail("golden_grpc", f"{name} differs from expected.json")
        t1, t2 = (ok(*http_call(hport, "POST", "/mutate",
                                '{ set { <0x1000> <email> "%s@films.io" . } }'
                                % who), "txn")["extensions"]["txn"]["start_ts"]
                  for who in ("one", "two"))
        ok(*http_call(hport, "POST", f"/commit?startTs={t1}"), "commit")
        st, body = http_call(hport, "POST", f"/commit?startTs={t2}")
        if st != 409 or json.loads(body)["errors"][0]["code"] != \
                "ErrorAborted":
            fail("conflict", f"status {st}: {body[:300]!r}")
        got = ok(*http_call(hport, "POST", "/query",
                            "{ q(func: uid(0x1000)) { email } }"), "readback")
        if got["data"] != {"q": [{"email": "one@films.io"}]}:
            fail("conflict", f"the first committer's write reads {got}")
        st, body = http_call(hport, "GET", "/metrics")
        series = prom.parse(body.decode()) if st == 200 else {}
        served = series.get("dgraph_num_queries_total", [({}, 0)])[0][1]
        if served < 2 * len(queries) + 1:
            fail("metrics", f"status {st}, {served} queries counted")
        ok(*http_call(hport, "POST", "/admin/shutdown"), "shutdown")
        rc = proc.wait(timeout=120)
        if rc != 0:
            fail("shutdown", f"exit code {rc}: {''.join(log)[-2000:]}")
        steps_s = time.perf_counter() - t_steps
    finally:
        if client is not None:
            client.close()
        cli.stop()
    out = {"start_seconds": start_s, "steps_seconds": steps_s,
           "queries": 2 * len(queries), "metric_series": len(series),
           "seconds": time.perf_counter() - t_phase}
    say("wire_cli", **out)
    return out


def apply_diff(old: dict, diff: dict | None) -> dict:
    """A live event's diff applied to the result before it: entries with a
    uid are matched by uid, the others as a multiset of encodings (the
    rules of live/diff.py, written out again here)."""
    from dgraph_tpu_torch.live.diff import canon

    new = {k: list(v) if isinstance(v, list) else v for k, v in old.items()}
    for block, d in (diff or {}).items():
        if not isinstance(new.get(block, []), list):
            new[block] = d["changed"][0]
            continue
        rows = new.get(block, [])
        gone_uid = {e["uid"] for e in d["removed"] + d["changed"]
                    if isinstance(e, dict) and "uid" in e}
        gone_anon = [canon(e) for e in d["removed"]
                     if not (isinstance(e, dict) and "uid" in e)]
        kept = []
        for e in rows:
            if isinstance(e, dict) and e.get("uid") in gone_uid:
                continue
            if canon(e) in gone_anon:
                gone_anon.remove(canon(e))
                continue
            kept.append(e)
        new[block] = kept + d["changed"] + d["added"]
    return new


def same_rows(a: dict, b: dict) -> bool:
    """Two results equal up to the order of each block's top-level rows."""
    from dgraph_tpu_torch.live.diff import canon

    def norm(r):
        return canon({k: sorted((canon(e) for e in v)) if isinstance(v, list)
                      else v for k, v in r.items()})
    return norm(a) == norm(b)


def wire_phase(node, expected, json_recurse, wide, csr, dev,
               after=None) -> tuple:
    """Phase 10 (b): the headline graph over the wire. The port's HTTP and
    gRPC servers go in front of phase 9's Node (its state is phase 8's
    checkpoint): phase 5's one-uid @recurse over HTTP, byte-identical to
    phase 8's JSON over the compaction, with K1/K2 launches read around it;
    phase 7b's request (a) over gRPC, equal to it too. The Node's result
    cache is emptied before each, so each executes (phase 9 sent the same
    texts). Then a /subscribe SSE stream on a one-hop `friend` read of a
    uid x of `wide`, and WIRE_COMMITS commits over HTTP that add friends
    to x (one also deletes one); before the last, a second stream on an
    @recurse(depth: 2) from x, whose re-evaluation runs K1/K2. Each commit
    delivers one diff event on each open stream at the commit's
    timestamp, whose result equals the diff applied to the result before
    it, a fresh read-only query at that timestamp, and (the one-hop read)
    the friend set the commits made. Launches are read around each
    commit, with no other traffic. Then `after(port)` runs over the same
    servers (phase 11 (b) and (d)). Returns the K1/K2 launches of the HTTP
    @recurse and the seconds `after` took."""
    import queue
    import threading

    import grpc
    import torch

    from dgraph_tpu_torch.api.grpc_client import DgraphClient
    from dgraph_tpu_torch.api.grpc_server import serve_grpc
    from dgraph_tpu_torch.api.http import make_server
    from dgraph_tpu_torch.live.diff import canon
    from dgraph_tpu_torch.ops import prefix as px
    from dgraph_tpu_torch.protos import api_pb2 as pbm

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    subjects, indptr, indices = csr

    def fail(what, msg):
        raise SystemExit(f"wire {what}: {msg}")

    srv = make_server(node, "127.0.0.1", 0)
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    gsrv, gport = serve_grpc(node, "127.0.0.1:0")
    port = srv.server_address[1]
    channel = grpc.insecure_channel(
        f"127.0.0.1:{gport}",
        options=[("grpc.max_receive_message_length", -1)])
    client = DgraphClient(channel=channel)
    streams: list = []
    sids: list = []
    try:
        # ---- phase 5's @recurse over HTTP ----------------------------------
        node.result_cache.clear()
        sync()
        px.reset_launches()
        t0 = time.perf_counter()
        st, rec_body = http_call(port, "POST", "/query", json_recurse)
        http_ms = (time.perf_counter() - t0) * 1e3
        sync()
        launches = dict(px.LAUNCHES)
        if st != 200:
            fail("recurse", f"status {st}: {rec_body[:300]!r}")
        if not rec_body.startswith(b'{"data": ' + expected["recurse"].encode()
                                   + b', "extensions": '):
            fail("recurse", "data differs from phase 8's compaction")
        if not any(launches.values()):
            fail("recurse", f"launched neither K1 nor K2: {launches}")
        http_server_ms = json.loads(rec_body)["extensions"][
            "server_latency"]["total_ns"] / 1e6

        # ---- phase 7b's request (a) over gRPC -------------------------------
        grpc.channel_ready_future(channel).result(timeout=60)
        node.result_cache.clear()
        t0 = time.perf_counter()
        resp = client._query(pbm.Request(query=groupby_uid_text(wide),
                                         read_only=True), timeout=600)
        grpc_ms = (time.perf_counter() - t0) * 1e3
        if resp.json.decode() != expected["groupby_uid"]:
            fail("groupby_uid", "json differs from phase 8's compaction")
        grpc_server_ms = resp.latency.total_ns / 1e6

        # ---- live subscriptions over SSE ------------------------------------
        deg = np.diff(indptr)
        row = {int(u): i for i, u in enumerate(subjects)}

        def two_hop(u):
            i = row.get(int(u))
            if i is None:
                return 0
            nb = indices[indptr[i]: indptr[i + 1]]
            return int(deg[i]) + sum(int(deg[row[int(v)]]) for v in nb
                                     if int(v) in row)
        cands = [u for u in wide if int(u) in row and deg[row[int(u)]] >= 4]
        x = min(cands, key=lambda u: (abs(two_hop(u) - WIRE_TWO_HOP), u))
        q_read = "{ q(func: uid(%s)) { uid friend { uid } } }" % hex(int(x))
        q_rec = ("{ q(func: uid(%s)) @recurse(depth: 2) { uid friend } }"
                 % hex(int(x)))

        def subscribe(q):
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            conn.request("POST", "/subscribe",
                         json.dumps({"query": q, "heartbeat_s": 5}),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            if r.status != 200:
                fail("subscribe", f"status {r.status}: {r.read()[:300]!r}")
            events: queue.Queue = queue.Queue()

            def pump(fp=r.fp):
                kind = None
                try:
                    while True:
                        ln = fp.readline()
                        if not ln:
                            break
                        ln = ln.decode().rstrip("\n")
                        if ln.startswith("event: "):
                            kind = ln[7:]
                        elif ln.startswith("data: "):
                            events.put((time.perf_counter(), kind,
                                        json.loads(ln[6:])))
                except (OSError, ValueError):      # the stream was closed
                    pass
                events.put(None)

            th = threading.Thread(target=pump, daemon=True)
            th.start()
            streams.append((conn, r, th))
            return events

        def next_event(events, what):
            try:
                item = events.get(timeout=300)
            except queue.Empty:
                fail(what, "no event within 300 s")
            if item is None:
                fail(what, "the stream closed")
            return item

        state, queries, open_s = {}, {}, {}

        def open_sub(what, q):
            t0 = time.perf_counter()
            events = subscribe(q)
            _t, kind, ev = next_event(events, what)
            if kind != "init":
                fail(what, f"first event {kind}")
            state[what], queries[what] = ev["result"], (events, q)
            sids.append(ev["sub"])
            open_s[what] = time.perf_counter() - t0

        t_subs = time.perf_counter()
        open_sub("read", q_read)
        friends = {int(e["uid"], 16)
                   for e in state["read"]["q"][0].get("friend", [])}
        rng = np.random.default_rng(19)
        notify = {"read": [], "recurse": []}
        commit_launches = []
        for i in range(WIRE_COMMITS):
            if i == WIRE_COMMITS - 1:
                # the @recurse joins for the last commit: every commit
                # wakes it, and each re-evaluation over a new overlay
                # pays a merged prep_pull (PERF.md section 5)
                open_sub("recurse", q_rec)
            fresh = [int(o) for o in rng.choice(subjects, 8, replace=False)
                     if int(o) not in friends][:2]
            gone = [min(friends)] if i == WIRE_COMMITS // 2 else []
            quads = lambda objs: " ".join(
                f"<{hex(int(x))}> <friend> <{hex(o)}> ." for o in objs)
            text = "{ set { %s } delete { %s } }" % (quads(fresh),
                                                     quads(gone))
            sync()
            px.reset_launches()
            st, body = http_call(port, "POST", "/mutate?commitNow=true", text)
            t_resp = time.perf_counter()
            if st != 200:
                fail("commit", f"status {st}: {body[:300]!r}")
            ts = json.loads(body)["extensions"]["txn"]["commit_ts"]
            friends = (friends | set(fresh)) - set(gone)
            for what, (events, q) in queries.items():
                t_ev, kind, ev = next_event(events, what)
                if kind != "diff" or ev["at"] != ts:
                    fail(what, f"commit {i} at ts {ts}: got {kind} at "
                               f"{ev.get('at')}")
                if not same_rows(apply_diff(state[what], ev["diff"]),
                                 ev["result"]):
                    fail(what, f"commit {i}: the diff does not give the "
                               f"result")
                node.result_cache.clear()
                fresh_read = node.query(q, start_ts=ts, read_only=True)[0]
                if canon(fresh_read) != canon(ev["result"]):
                    fail(what, f"commit {i}: the event differs from a "
                               f"read-only query at {ts}")
                state[what] = ev["result"]
                notify[what].append((t_ev - t_resp) * 1e3)
            sync()
            commit_launches.append(dict(px.LAUNCHES))
            got = {int(e["uid"], 16)
                   for e in state["read"]["q"][0].get("friend", [])}
            if got != friends:
                fail("read", f"commit {i}: friends of {hex(int(x))} are not "
                             f"what the commits made")
        if not any(commit_launches[-1].values()):
            fail("recurse", f"its re-evaluation launched neither K1 nor "
                            f"K2: {commit_launches}")
        subs_s = time.perf_counter() - t_subs
        t_after = time.perf_counter()
        if after is not None:
            after(port)
        t_after = time.perf_counter() - t_after
    finally:
        # cancelled subscriptions end their streams from the server's side
        for sid in sids:
            node.live.cancel(sid)
        for conn, r, th in streams:
            th.join(timeout=30)
            r.close()
            conn.close()
        client.close()
        gsrv.stop(0)
        srv.shutdown()
        srv.server_close()
        serving.join(timeout=30)
    say("wire", device=str(dev), launches=launches,
        http_recurse_ms=http_ms, http_recurse_server_ms=http_server_ms,
        http_recurse_wire_ms=http_ms - http_server_ms,
        http_recurse_bytes=len(rec_body),
        grpc_groupby_ms=grpc_ms, grpc_groupby_server_ms=grpc_server_ms,
        grpc_groupby_wire_ms=grpc_ms - grpc_server_ms,
        grpc_groupby_bytes=len(resp.json),
        subscription_uid=hex(int(x)), subscription_two_hop=two_hop(x),
        subscription_open_seconds=open_s,
        recurse_init_bytes=len(canon(state["recurse"])),
        subscription_notify_ms={k: band(v) for k, v in notify.items()},
        subscription_notify_samples_ms=notify, commits=WIRE_COMMITS,
        commit_launches=commit_launches, subscriptions_seconds=subs_s,
        phase_seconds=time.perf_counter() - t_phase - t_after)
    return launches, t_after


def batch_phase(node, seeds, wide, dev) -> dict:
    """Phase 11 (a), over phase 9's Node before phase 10's commits: BURST
    one-uid @recurse(depth: 3) requests, each alone and then all at once
    from threads behind a barrier, then EXPAND_SLICES slices of phase 8's
    expand frontier the same way. The seeds and slices are chosen from the
    served snapshot's own friend arrays. Task and result caches are
    emptied before each run, so each executes. Each solo JSON must render
    a non-empty block and equal the host-mirror route's JSON (on_host);
    each concurrent JSON must equal its solo JSON; each burst must form a
    batch of two or more (dgraph_batch_tasks_total grows past
    dgraph_batch_formed_total); a recurse_fused_multi run of B >= 2 must
    launch K1 or K2. One solo recurse request is profiled for the device's
    busy time. Returns the K1/K2 launches of the recurse burst's
    concurrent run."""
    import threading

    import torch

    from dgraph_tpu_torch.ops import prefix as px
    from dgraph_tpu_torch.ops import pull_bfs as pb
    from dgraph_tpu_torch.query import task as taskmod

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()

    def fail(what, msg):
        raise SystemExit(f"batch {what}: {msg}")

    b = node.batcher
    if b is None or not node.planner_enabled or node.devprof is None \
            or node.residency is None or node.residency.enabled:
        fail("defaults", "phase 9's Node does not serve with the planner, "
                         "the batcher, the observatory and an unbounded "
                         "working-set manager")
    subjects, indptr, indices = (
        np.asarray(a) for a in node.snapshot().pred("friend").csr.host_arrays())
    deg = np.diff(indptr).astype(np.int64)
    # the rendered size of a one-uid @recurse(depth: 3) from s: a uid's row
    # is rendered under every occurrence of the uid, so the uids rendered
    # are deg(s) + S(s) + sum of S(v) over s's targets v, where S(r) sums
    # the out-degrees of row r's targets (an upper bound: edge dedup only
    # removes rows)
    pos = np.clip(np.searchsorted(subjects, indices), 0, len(subjects) - 1)
    hit = subjects[pos] == indices

    def row_sums(per_edge):
        cs = np.concatenate([[0], np.cumsum(per_edge)])
        return cs[indptr[1:]] - cs[indptr[:-1]]

    s2 = row_sums(np.where(hit, deg[pos], 0))
    s3 = row_sums(np.where(hit, s2[pos], 0))
    del pos, hit
    rows = np.clip(np.searchsorted(subjects, seeds), 0, len(subjects) - 1)
    # a seed without a friend row renders nothing: its estimate is 0
    est = sorted((int(deg[r] + s2[r] + s3[r]) if subjects[r] == u else 0,
                  int(u)) for r, u in zip(rows, seeds))
    picks = [(e, u) for e, u in est if e >= BURST_MIN_ROWS][:BURST]
    if len(picks) < BURST or picks[-1][0] > BURST_MAX_ROWS:
        fail("recurse", f"no {BURST} seeds render {BURST_MIN_ROWS}.."
                        f"{BURST_MAX_ROWS} uids: {est[:2 * BURST]}")
    est_rows, picks = [e for e, _ in picks], [u for _, u in picks]
    c = lambda n: node.metrics.counter(n).value

    def run(text):
        return json.dumps(node.query(text)[0])

    def clear():
        node.result_cache.clear()
        node.task_cache.clear()

    def burst(what, texts):
        """Each text alone, then all together; returns (solo JSONs, the
        batches formed, the tasks they held, seconds of the burst, the
        K1/K2 launches of the concurrent run)."""
        solo = []
        for i, text in enumerate(texts):
            clear()
            solo.append(run(text))
            if not json.loads(solo[-1]).get("q"):
                fail(what, f"request {i} renders no block: {solo[-1][:80]}")
            clear()
            if on_host(lambda: run(text)) != solo[-1]:
                fail(what, f"request {i}: the solo JSON differs from the "
                           f"host-mirror route's")
        clear()
        outs, errs = [None] * len(texts), [None] * len(texts)
        barrier = threading.Barrier(len(texts))

        def go(i):
            barrier.wait(timeout=60)
            try:
                outs[i] = run(texts[i])
            except BaseException as e:      # surfaced below
                errs[i] = e

        kept = b.window_s, b.max_batch
        b.window_s, b.max_batch = BURST_WINDOW_MS / 1e3, len(texts)
        f0, k0 = c("dgraph_batch_formed_total"), c("dgraph_batch_tasks_total")
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(texts))]
        sync()
        px.reset_launches()
        t0 = time.perf_counter()
        b.hint_burst()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        finally:
            b.window_s, b.max_batch = kept
        sync()
        burst_s = time.perf_counter() - t0
        launches = dict(px.LAUNCHES)
        if any(t.is_alive() for t in threads):
            fail(what, "a request of the burst did not finish in 600 s")
        if any(errs):
            fail(what, f"a request of the burst raised: {errs}")
        for i, (a, w) in enumerate(zip(outs, solo)):
            if a != w:
                fail(what, f"request {i}: the concurrent JSON differs from "
                           f"its solo JSON")
        formed = c("dgraph_batch_formed_total") - f0
        tasks = c("dgraph_batch_tasks_total") - k0
        if tasks - formed < 1:
            fail(what, f"no batch of two or more formed ({tasks} tasks in "
                       f"{formed} batches)")
        return solo, formed, tasks, burst_s, launches

    # ---- the recurse family ------------------------------------------------
    texts = ["{ q(func: uid(%s)) @recurse(depth: 3) { friend } }" % hex(u)
             for u in picks]
    real, multi = pb.recurse_fused_multi, []

    def spy(*a, **k):
        sync()
        l0 = dict(px.LAUNCHES)
        out = real(*a, **k)
        sync()
        multi.append({"batch": int(a[5].shape[0]),
                      **{n: px.LAUNCHES[n] - l0[n] for n in l0}})
        return out

    t_step = time.perf_counter()
    pb.recurse_fused_multi = spy
    try:
        solo, formed, tasks, burst_s, launches = burst("recurse", texts)
    finally:
        pb.recurse_fused_multi = real
    if not any(m["batch"] >= 2 and (m["active_prefix"]
                                    or m["active_prefix_sparse"])
               for m in multi):
        fail("recurse", f"no recurse_fused_multi run of two or more "
                        f"launched K1 or K2: {multi}")
    # the device's busy time for one solo request (a trace, not the
    # timeline's event-bracketed intervals)
    clear()
    prof = profile_query(lambda: (clear(), run(texts[0])))
    say("batch", family="recurse", requests=len(texts),
        seeds=[hex(u) for u in picks], est_rows=est_rows, batches=formed,
        tasks=tasks, multi_runs=multi, launches=launches,
        json_bytes=[len(x) for x in solo], burst_seconds=burst_s,
        solo_profile=prof, step_seconds=time.perf_counter() - t_step)

    # ---- the expand family -------------------------------------------------
    t_step = time.perf_counter()
    pos = np.clip(np.searchsorted(subjects, wide), 0, len(subjects) - 1)
    dw = dict(zip(wide.tolist(),
                  np.where(subjects[pos] == wide, deg[pos], 0).tolist()))
    for k in range(EXPAND_SLICES, 1, -1):
        parts, sums = [[] for _ in range(k)], [0] * k
        for u in sorted(dw, key=lambda x: (-dw[x], x)):
            i = int(np.argmin(sums))
            parts[i].append(u)
            sums[i] += dw[u]
        if min(sums) > taskmod.HOST_EXPAND_MAX:
            break
    else:
        fail("expand", f"no split of the frontier puts every slice past "
                       f"HOST_EXPAND_MAX: {sums}")
    texts = ["{ q(func: uid(%s)) { friend { uid } } }" % ", ".join(
        hex(u) for u in sorted(p)) for p in parts]
    solo, formed, tasks, burst_s, _launches = burst("expand", texts)
    say("batch", family="expand", requests=len(texts), slice_edges=sums,
        batches=formed, tasks=tasks, json_bytes=[len(x) for x in solo],
        burst_seconds=burst_s, step_seconds=time.perf_counter() - t_step,
        phase_seconds=time.perf_counter() - t_phase)
    return launches


def residency_phase(node, wide, wide_rev, dev) -> None:
    """Phase 11 (c): a ResidencyManager adopts phase 9's friend and
    ~friend tablets (phase 8's compaction, from its checkpoint) through the
    adopt seam. The wide one-hop expand over friend and over ~friend runs
    through an Executor without a task cache: first under the Node's own
    unbounded manager (the JSON every later run must equal), then under
    BUDGET_FIT x the larger device footprint (one tablet fits, two do
    not): friend, ~friend, friend — evictions, a re-admission counted as
    thrash, and torch.cuda.memory_allocated, read around each eviction's
    drop, falling by at least the evicted footprint — and then under
    BUDGET_COLD x the smaller (both COLD: the host gather serves, no
    upload). The Node's manager adopts the tablets back at the end."""
    import torch

    from dgraph_tpu_torch.query import dql
    from dgraph_tpu_torch.query import engine as eng
    from dgraph_tpu_torch.storage.csr_build import PredCSR
    from dgraph_tpu_torch.storage.residency import ResidencyManager
    from dgraph_tpu_torch.utils.metrics import Registry

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()

    def fail(what, msg):
        raise SystemExit(f"residency {what}: {msg}")

    snap, schema = node.snapshot(), node._schema_view()
    pd = snap.pred("friend")
    owners = {"friend": pd.csr, "~friend": pd.rev_csr}
    if not all(type(o) is PredCSR for o in owners.values()):
        fail("tablets", f"friend is {type(pd.csr).__name__}, not a fold")
    texts = {"friend": "{ q(func: uid(%s)) { friend { uid } } }" % ", ".join(
                 hex(int(u)) for u in wide),
             "~friend": "{ q(func: uid(%s)) { ~friend { uid } } }" % ", ".join(
                 hex(int(u)) for u in wide_rev)}

    def execute(what):
        out = json.dumps(eng.Executor(snap, schema).execute(
            dql.parse(texts[what])))
        sync()
        return out

    def allocated():
        # no gc.collect(): a collection over millions of posting lists
        # takes seconds, longer than the thrash window; the dropped device
        # tuples hold no reference cycles
        sync()
        return torch.cuda.memory_allocated(dev)

    falls = []

    def measured(what, drop):
        """The owner's drop_device with memory_allocated read around it:
        the eviction frees to the caching allocator only if nothing else
        holds the tensors."""
        def run():
            m0 = allocated()
            drop()
            falls.append({"evicted": what, "footprint": foot[what],
                          "fall": m0 - allocated()})
        return run

    t_step = time.perf_counter()
    want = {w: execute(w) for w in texts}
    unbounded_s = time.perf_counter() - t_step
    node.residency.evict_to(0)
    mgr = ResidencyManager(budget_bytes=0, metrics=Registry())
    mgr.adopt_pred(pd)
    foot = {w: o.device_nbytes() for w, o in owners.items()}
    for w, o in owners.items():
        o.drop_device = measured(w, o.drop_device)
    c = lambda n: mgr.metrics.counter(f"dgraph_residency_{n}_total").value
    try:
        # ---- one fits, two do not ----------------------------------------
        t_step = time.perf_counter()
        mgr.budget = int(BUDGET_FIT * max(foot.values()))
        for what in ("friend", "~friend", "friend"):
            if execute(what) != want[what]:
                fail("fit", f"{what}: JSON differs from the unbounded run")
            if [w for w, o in owners.items() if o.device_resident()] \
                    != [what]:
                fail("fit", f"after {what}, resident: "
                            f"{[w for w, o in owners.items() if o.device_resident()]}")
        mgr.evict_to(0)
        fit = {n: c(n) for n in ("admissions", "evictions", "thrash")}
        if fit["evictions"] < 2 or fit["thrash"] < 1 or len(falls) < 3:
            fail("fit", f"counters {fit}, evictions measured {falls}")
        if any(f["fall"] < f["footprint"] for f in falls):
            fail("fit", f"memory_allocated fell by less than the evicted "
                        f"footprint: {falls}")
        fit_s = time.perf_counter() - t_step

        # ---- both cold ---------------------------------------------------
        t_step = time.perf_counter()
        mgr.budget = int(BUDGET_COLD * min(foot.values()))
        m0, a0 = allocated(), c("admissions")
        for what in ("friend", "~friend"):
            if execute(what) != want[what]:
                fail("cold", f"{what}: JSON differs from the unbounded run")
        if any(o.device_resident() for o in owners.values()) \
                or c("admissions") != a0 or allocated() != m0:
            fail("cold", "a cold tablet uploaded")
        if c("cold_serves") < 2:
            fail("cold", f"cold_serves {c('cold_serves')}")
        cold_s = time.perf_counter() - t_step
        say("residency", footprints=foot,
            budgets={"fit": int(BUDGET_FIT * max(foot.values())),
                     "cold": mgr.budget},
            fit=fit, evicted_falls=falls, cold_serves=c("cold_serves"),
            upload_failures=c("upload_failures"),
            json_bytes={w: len(x) for w, x in want.items()},
            unbounded_seconds=unbounded_s, fit_seconds=fit_s,
            cold_seconds=cold_s, phase_seconds=time.perf_counter() - t_phase)
    finally:
        for o in owners.values():
            del o.drop_device
        mgr.evict_to(0)
        node.residency.adopt_pred(pd)


def planner_devprof_phase(node, port) -> None:
    """Phase 11 (b) and (d), after phase 10's commits, over its HTTP server
    in front of phase 9's Node. (b) PLANNER_QUERY through Node.query with
    explain=True and over POST /query?explain=true: the plan swaps its root
    (root_swaps >= 1) and the data is byte-identical to an Executor with no
    plan on the same snapshot. (d) /debug/timeline holds recurse and expand
    records whose CUDA-event device intervals are resolved and
    non-negative, its device busy share lies in [0, 1]; /debug/compiles
    lists the port's program families; /debug/metrics has an HBM
    high-water mark from torch.cuda.memory_stats above 0."""
    from dgraph_tpu_torch.query import dql
    from dgraph_tpu_torch.query import engine as eng

    t_phase = time.perf_counter()

    def fail(what, msg):
        raise SystemExit(f"default {what}: {msg}")

    def get(path):
        st, body = http_call(port, "GET", path)
        if st != 200:
            fail(path, f"status {st}: {body[:300]!r}")
        return json.loads(body)

    # ---- (b) the planner ---------------------------------------------------
    node.result_cache.clear()
    node.task_cache.clear()
    t0 = time.perf_counter()
    out = dict(node.query(PLANNER_QUERY, explain=True)[0])
    planned_ms = (time.perf_counter() - t0) * 1e3
    ex = out.pop("explain")
    t0 = time.perf_counter()
    plain = json.dumps(eng.Executor(node.snapshot(), node._schema_view())
                       .execute(dql.parse(PLANNER_QUERY)))
    plain_ms = (time.perf_counter() - t0) * 1e3
    if json.dumps(out) != plain:
        fail("planner", "the planned JSON differs from the plan-less one")
    if ex.get("planner") != "on" or ex["decisions"]["root_swaps"] < 1:
        fail("planner", f"no root swap: {ex.get('decisions')}")
    st, body = http_call(port, "POST", "/query?explain=true", PLANNER_QUERY)
    if st != 200 or not body.startswith(b'{"data": ' + plain.encode()
                                        + b', "extensions": '):
        fail("planner", f"?explain=true status {st} or data differs")
    hx = json.loads(body)["extensions"]["explain"]
    if hx["decisions"]["root_swaps"] < 1:
        fail("planner", f"no root swap over HTTP: {hx['decisions']}")
    say("planner", query=PLANNER_QUERY, decisions=ex["decisions"],
        root=ex["blocks"][0]["root"], json_bytes=len(plain),
        planned_ms=planned_ms, plain_ms=plain_ms,
        plans_built=node.metrics.counter("dgraph_planner_plans_total").value)

    # ---- (d) the device observatory -----------------------------------------
    recs = get("/debug/timeline?view=raw&n=4096")
    by = {}
    for r in recs:
        by.setdefault(r["klass"], []).append(r)
    for k in ("recurse", "expand"):
        rs = by.get(k, [])
        if not rs:
            fail("timeline", f"no {k} dispatch record: {sorted(by)}")
        if not all(r.get("device_ms", -1) >= 0
                   and r.get("device_start_ms", -1) >= 0 for r in rs):
            fail("timeline", f"a {k} record has no device interval, or a "
                             f"negative one: {rs[:4]}")
    chrome = get("/debug/timeline")
    share = chrome["otherData"].get("dispatch_in_flight_share")
    if share is None or not 0.0 <= share <= 1.0:
        fail("timeline", f"dispatch-in-flight share {share}")
    compiles = get("/debug/compiles")
    sizes = compiles["cache_sizes"]
    fams = ("pb.active_prefix", "pb.active_prefix_sparse",
            "pb.recurse_fused", "pb.recurse_fused_multi", "segments.reduce",
            "traversal.sssp")
    if not all(f in sizes for f in fams) or sizes["pb.active_prefix"] != 1:
        fail("compiles", f"families {sorted(sizes)}")
    dm = get("/debug/metrics")["devprof"]
    hw = dm["hbm"]["high_water"]
    if not dm["hbm"]["capable"] or hw.get("device", 0) <= 0:
        fail("hbm", f"no device high-water mark: {dm['hbm']}")
    cost = record_dispatch_cost(node)
    dev_ms = {k: band([r["device_ms"] for r in by[k]])
              for k in ("recurse", "expand")}
    run_ms = {k: band([r["run_ms"] for r in by[k]])
              for k in ("recurse", "expand")}
    say("devprof", records=len(recs), klasses=sorted(by),
        device_ms=dev_ms, run_ms=run_ms, dispatch_in_flight_share=share,
        record_dispatch_cost=cost,
        utilization_pct=dm["utilization_pct"],
        dispatches=dm["dispatches"], hbm=dm["hbm"],
        compiles={k: v for k, v in compiles["families"].items()},
        cache_sizes=sizes, phase_seconds=time.perf_counter() - t_phase)


def record_dispatch_cost(node, n: int = 4096) -> dict:
    """The observatory's own cost per dispatch, on a DevProfiler of its
    own over the Node's device and working-set manager (the Node's ring
    and meters stay as they are): mean microseconds of record_dispatch
    (the allocator and the residency spine read every UTIL_REFRESH), of
    one allocator read (torch.cuda.memory_stats) and of one residency
    spine read (usage() plus host_bytes(), which walk every live
    PredData)."""
    import torch

    from dgraph_tpu_torch.obs.devprof import DevProfiler
    from dgraph_tpu_torch.utils.metrics import Registry

    prof = DevProfiler(Registry(), residency=node.residency,
                       device=node.device)
    prof.record_dispatch("expand", 0.0, 0.0, 0.001)      # the probe
    t0 = time.perf_counter()
    for _ in range(n):
        prof.record_dispatch("expand", 0.0, 0.0, 0.001)
    per_us = (time.perf_counter() - t0) / n * 1e6
    spine, alloc = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        node.residency.usage()
        node.residency.host_bytes()
        spine.append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        torch.cuda.memory_stats(node.device)
        alloc.append((time.perf_counter() - t0) * 1e6)
    return {"record_dispatch_us": per_us, "dispatches": n,
            "spine_read_us": band(spine), "allocator_read_us": band(alloc),
            "util_refresh": DevProfiler.UTIL_REFRESH}


def vec_text(q) -> str:
    """A similar_to literal that parses back to the same float32 values."""
    return "[" + ", ".join(repr(float(x)) for x in q) + "]"


def exact_topk(vecs64, nx2, uids, Q64, k):
    """Per query of Q64, the k (uid, distance) of the float64 exact scan
    ranked by (distance, uid): the reference every path is held to.
    Ties at the k-th distance are all kept before the uid order cuts."""
    out = []
    for q in Q64:
        d = nx2 - 2.0 * (vecs64 @ q) + float(q @ q)
        thr = np.partition(d, k - 1)[k - 1]
        sel = np.nonzero(d <= thr)[0]
        order = np.lexsort((uids[sel], d[sel]))[:k]
        out.append((uids[sel][order], d[sel][order]))
    return out


def same_ranking(got_uids, got_d, want_uids, want_d) -> bool:
    """Equal uids in rank order, distances equal to float64 rounding (the
    re-rank scores a candidate subset with the same formula as the
    reference; a BLAS product over another row set may round its last bit
    differently): |a - b| <= 1e-9 * max(1, |b|)."""
    return (np.array_equal(np.asarray(got_uids), np.asarray(want_uids))
            and np.allclose(got_d, want_d, rtol=1e-9, atol=1e-9))


def mesh_phase(snap, schema, csr, q128, seeds, host_levels, json_recurse,
               far, wide, want_a, dev) -> dict:
    """Phase 9b: the mesh on the one card, over phase 4's snapshot (with
    phase 7's values and phase 6's `road`); want_a is phase 7b's JSON of
    its request (a). Returns the K1/K2 launches
    made by the mesh path's own calls (the unsharded references' are left
    out; the mesh programs are torch ops: 0 expected)."""
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from dgraph_tpu_torch import carry
    from dgraph_tpu_torch.api.server import Node
    from dgraph_tpu_torch.models.rmat import rmat_csr
    from dgraph_tpu_torch.ops import prefix as px
    from dgraph_tpu_torch.parallel.mesh import make_mesh
    from dgraph_tpu_torch.parallel.mesh_exec import MeshExecutor
    from dgraph_tpu_torch.query import analytics as an
    from dgraph_tpu_torch.query import dql
    from dgraph_tpu_torch.query import engine as eng
    from dgraph_tpu_torch.query import groupby as gb
    from dgraph_tpu_torch.utils.types import TypeID

    subjects, indptr, indices = csr
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    ms = {}

    def fail(what, msg):
        raise SystemExit(f"mesh {what}: {msg}")

    def p50(fn, runs=5):
        samples = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            sync()
            samples.append((time.perf_counter() - t0) * 1e3)
        return band(samples)["median"]

    def plain(text):
        return json.dumps(eng.Executor(snap, schema).execute(dql.parse(text)))

    eng.set_query_edge_limit(1 << 31)
    mesh_launch = {k: 0 for k in px.LAUNCHES}

    def on_mesh(fn):
        """fn() on the mesh path, its K1/K2 launches counted."""
        before = dict(px.LAUNCHES)
        out = fn()
        sync()
        for k in mesh_launch:
            mesh_launch[k] += px.LAUNCHES[k] - before[k]
        return out

    # ---- (a) placement ----------------------------------------------------
    t0 = time.perf_counter()
    me = MeshExecutor(mesh=make_mesh(MESH_SHARDS, devices=[dev] * MESH_SHARDS),
                      shard_min_edges=MESH_MIN_EDGES)
    msnap = me.place_snapshot(snap)
    sync()
    ms["place"] = (time.perf_counter() - t0) * 1e3
    c = lambda name: me.metrics.counter(name).value
    fc, rc = msnap.pred("friend").csr, msnap.pred("friend").rev_csr
    if c("dgraph_mesh_sharded_tablets") != 2 or not (me.owns(fc)
                                                     and me.owns(rc)):
        fail("place", f"{c('dgraph_mesh_sharded_tablets')} sharded tablets")
    for name, pc in (("friend", fc), ("~friend", rc)):
        if sum(pc.shard_edges) != len(indices):
            fail("place", f"{name}: shard edges {pc.shard_edges}")
    say("mesh_place", shards=MESH_SHARDS, devices=[str(d) for d in
                                                   me.mesh.devices],
        shard_edges={"friend": fc.shard_edges, "~friend": rc.shard_edges},
        ecap={"friend": fc.ecap, "~friend": rc.ecap},
        rows_per=fc.rows_per, replicated=c("dgraph_mesh_replicated_tablets"),
        place_ms=ms["place"])

    def mexec(text):
        return on_mesh(lambda: json.dumps(eng.Executor(
            msnap, schema, mesh=me).execute(dql.parse(text))))

    def counted(fn, **want):
        """fn() with counter deltas of the mesh executor checked."""
        before = {k: c(k) for k in want}
        out = fn()
        sync()
        for k, v in want.items():
            if c(k) - before[k] != v:
                fail(k, f"moved by {c(k) - before[k]}, not {v}")
        return out

    one = {"dgraph_mesh_dispatches_total": 1}
    # a recurse's device frontiers feed only this counter (the host replay
    # builds the answer), so a wrong recurse program shows here alone
    one_rec = {**one, "dgraph_mesh_replay_divergence_total": 0}

    # ---- (b) the 128-seed @recurse(depth: 3) as one mesh program ----------
    req = dql.parse(q128)

    def mesh_block():
        ex = eng.Executor(msnap, schema, mesh=me)
        sg = eng.SubGraph(gq=req.queries[0], attr=req.queries[0].attr)
        on_mesh(lambda: ex._process_block(sg))
        return sg

    def levels(sg):
        out, node = [], sg
        while node.children:
            out.append(node.children[0])
            node = node.children[0]
        return out

    t0 = time.perf_counter()
    got = levels(counted(mesh_block, **one_rec))
    ms["recurse128_first"] = (time.perf_counter() - t0) * 1e3
    if [len(h.dest_uids) for h in got] != \
            [len(h.dest_uids) for h in host_levels] or not all(
                np.array_equal(a.dest_uids, b.dest_uids)
                for a, b in zip(got, host_levels)):
        fail("recurse", "levels differ from phase 4's")
    # the device program's own frontiers, one level deeper than the query
    # so that its last level comes back too, against phase 4's levels
    dev_levels = counted(lambda: on_mesh(lambda: me.run_recurse(
        fc, np.unique(seeds), len(host_levels) + 1, False)), **one)
    for i, h in enumerate(host_levels):
        if not np.array_equal(dev_levels[i + 1][0], h.dest_uids):
            fail("recurse", f"device frontier {i + 1} differs from "
                            f"phase 4's ({len(dev_levels[i + 1][0])} vs "
                            f"{len(h.dest_uids)} uids)")
    ms["recurse128"] = p50(lambda: counted(mesh_block, **one_rec), runs=3)
    profiles = {"recurse128": profile_query(mesh_block)}
    want = plain(json_recurse)
    if counted(lambda: mexec(json_recurse), **one_rec) != want:
        fail("recurse", "phase 5's one-uid JSON differs from the unsharded")
    ms["recurse1"] = p50(lambda: mexec(json_recurse))

    # ---- (c) a two-hop chain with a value filter and first/offset ---------
    chain_q = MESH_CHAIN % ", ".join(
        hex(int(u)) for u in np.sort(seeds)[:MESH_CHAIN_SEEDS])
    want = plain(chain_q)
    got = counted(lambda: mexec(chain_q),
                  dgraph_mesh_dispatches_total=1,
                  dgraph_mesh_fused_queries_total=1,
                  dgraph_mesh_fused_hops_total=2)
    if got != want or len(got) < 200:
        fail("chain", f"JSON differs from the unsharded ({len(got)} bytes)")
    ms["chain"] = p50(lambda: mexec(chain_q))
    profiles["chain"] = profile_query(lambda: mexec(chain_q))

    # ---- (d) the far shortest through run_bfs -----------------------------
    short_q = ("{ p as shortest(from: %s, to: %s) { friend } "
               "r(func: uid(p)) { uid } }" % (hex(far["src"]),
                                              hex(far["dst"])))
    want = plain(short_q)
    reads0 = me.loop_reads["bfs"]
    got = counted(lambda: mexec(short_q), **one)
    bfs_reads = me.loop_reads["bfs"] - reads0
    if got != want:
        fail("shortest", "JSON differs from the kernel tier's")
    if json.loads(got)["_path_"][0]["_weight_"] != float(far["hops"]):
        fail("shortest", f"_weight_ != {far['hops']}")
    ms["shortest"] = p50(lambda: mexec(short_q))

    # ---- (e) @groupby: request (a) over the placement; the fused terminal -
    text_a = groupby_uid_text(wide)
    t0 = time.perf_counter()
    got = mexec(text_a)
    ms["groupby_a"] = (time.perf_counter() - t0) * 1e3
    groups_a = len(json.loads(got)["q"][0]["@groupby"])
    if got != want_a:
        fail("groupby", "request (a) differs from the unsharded answer")
    s128 = ", ".join(hex(int(u)) for u in np.sort(seeds))
    term_q = MESH_TERMINAL % (s128, GROUPBY_AGE_MAX, s128)
    checks = {"counts": [], "aggs": 0}
    kept = gb._fused_check_counts, gb._check_fused_agg

    def spy_counts(fused, row_seeds, members_per):
        checks["counts"].append((len(fused["table"]), len(row_seeds),
                                 int(np.count_nonzero(fused["counts"]))))
        return kept[0](fused, row_seeds, members_per)

    def spy_aggs(*a, **kw):
        checks["aggs"] += 1
        return kept[1](*a, **kw)

    want = plain(term_q)
    gb._fused_check_counts, gb._check_fused_agg = spy_counts, spy_aggs
    try:
        t0 = time.perf_counter()
        got = counted(lambda: mexec(term_q),
                      dgraph_mesh_dispatches_total=1,
                      dgraph_agg_terminal_ops_total=1)
        ms["terminal_first"] = (time.perf_counter() - t0) * 1e3
    finally:
        gb._fused_check_counts, gb._check_fused_agg = kept
    if got != want:
        fail("terminal", "JSON differs from the unsharded answer")
    if not checks["counts"] or checks["counts"][0][1] < 2 or \
            checks["aggs"] < 3:
        fail("terminal", f"the cross-checks did not run: {checks}")
    ms["terminal"] = p50(lambda: mexec(term_q), runs=1)

    # ---- (f) analytics ----------------------------------------------------
    nodes, esrc, edst = an.graph_arrays(fc)
    n = len(nodes)
    reads0 = me.loop_reads["pagerank"]
    t0 = time.perf_counter()
    rank, pr_it = on_mesh(lambda: me.run_pagerank(esrc, edst, n))
    sync()
    ms["pagerank"] = (time.perf_counter() - t0) * 1e3
    pr_reads = me.loop_reads["pagerank"] - reads0
    t0 = time.perf_counter()
    deg = np.bincount(esrc, minlength=n).astype(np.float64)
    dang, od = deg == 0, np.maximum(deg, 1.0)
    r64, it64 = np.full(n, 1.0 / n), 0
    while it64 < 100:
        contrib = np.bincount(edst, weights=r64[esrc] / od[esrc],
                              minlength=n)
        new = 0.15 / n + 0.85 * (contrib + r64[dang].sum() / n)
        delta = np.abs(new - r64).sum()
        r64, it64 = new, it64 + 1
        if delta <= 1e-6:
            break
    oracle_s = time.perf_counter() - t0
    pr_abs = np.abs(rank.astype(np.float64) - r64)
    pr_err = float(pr_abs.max())
    pr_rel = float((pr_abs / r64).max())
    top = lambda r: np.argsort(-np.asarray(r, np.float64),
                               kind="stable")[:5].tolist()
    if pr_err >= PAGERANK_TOL or pr_rel >= PAGERANK_RTOL or \
            top(rank) != top(r64) or abs(pr_it - it64) > 1:
        fail("pagerank", f"max |err| {pr_err}, max |err|/score {pr_rel}, "
                         f"top {top(rank)} vs {top(r64)}, iterations "
                         f"{pr_it} vs {it64}")
    out_pr = on_mesh(lambda: an.run("pagerank", fc, mesh=me, top=5))
    if not out_pr["device"] or [int(x["uid"], 16) for x in out_pr["top"]] \
            != nodes[top(r64)].tolist():
        fail("pagerank", f"analytics.run: {out_pr}")
    reads0 = me.loop_reads["cc"]
    t0 = time.perf_counter()
    lab, cc_it = on_mesh(lambda: me.run_cc(esrc, edst, n))
    sync()
    ms["cc"] = (time.perf_counter() - t0) * 1e3
    cc_reads = me.loop_reads["cc"] - reads0
    ncomp, comp = connected_components(
        coo_matrix((np.ones(len(esrc), np.int8), (esrc, edst)),
                   shape=(n, n)), directed=False)
    mins = np.full(ncomp, n, np.int64)
    np.minimum.at(mins, comp, np.arange(n))
    if not np.array_equal(lab.astype(np.int64), mins[comp]):
        fail("cc", f"labels differ from scipy at "
                   f"{int((lab != mins[comp]).sum())} nodes")
    ts, tp, tx = rmat_csr(MESH_TRI_SCALE, EDGE_FACTOR, seed=SEED)
    tri_csr = carry.snapshot_from_numpy(
        {"t": (int(TypeID.UID), ts, tp, tx)}, 1, device=dev).pred("t").csr
    t0 = time.perf_counter()
    out_tri = on_mesh(lambda: an.run("triangles", tri_csr, mesh=me))
    ms["triangles"] = (time.perf_counter() - t0) * 1e3
    _tn, tsrc, tdst = an.graph_arrays(tri_csr)
    want_tri = an.triangles_host(tsrc, tdst, len(_tn))
    if not out_tri["device"] or out_tri["triangles"] != want_tri:
        fail("triangles", f"{out_tri} != exact {want_tri}")
    say("mesh_analytics", nodes=int(n), edges=int(len(esrc)),
        pagerank_iterations=pr_it, oracle_iterations=it64,
        pagerank_max_abs_err=pr_err, pagerank_max_rel_err=pr_rel,
        oracle_seconds=oracle_s,
        cc_iterations=cc_it, components=int(ncomp),
        triangles=int(want_tri), triangle_nodes=int(out_tri["nodes"]))

    stats = {k: c(k) for k in ("dgraph_mesh_dispatches_total",
                               "dgraph_mesh_fused_hops_total",
                               "dgraph_mesh_traversed_edges_total",
                               "dgraph_mesh_program_builds_total",
                               "dgraph_mesh_fused_queries_total",
                               "dgraph_mesh_unfused_queries_total")}
    fallbacks = me.metrics.keyed("dgraph_mesh_fallbacks_total",
                                 labels=("reason",)).snapshot()
    loop_reads = dict(me.loop_reads)
    del me, msnap, fc, rc
    torch.cuda.empty_cache()

    # ---- (h) the serving Node with its mesh --------------------------------
    schema_text, nquads, queries, expected = golden_battery()
    t0 = time.perf_counter()
    mn, pn = Node(device=dev, mesh_devices=-1, mesh_min_edges=1), \
        Node(device=dev)
    try:
        for node in (mn, pn):
            node.alter(schema_text=schema_text)
            node.mutate(set_nquads=nquads, commit_now=True)
        for name, qq in queries:
            got = json.loads(json.dumps(on_mesh(lambda: mn.query(qq)[0]),
                                        default=str))
            if got != expected[name]:
                fail("node", f"golden {name} differs from expected.json")
        node_fused = mn.metrics.counter(
            "dgraph_mesh_fused_queries_total").value
        if node_fused == 0:
            fail("node", "no golden query ran fused")
        for kind in ("pagerank", "cc", "triangles"):
            a = on_mesh(lambda: mn.analytics(kind, "starring"))
            b = pn.analytics(kind, "starring")
            if not a["device"] or b["device"]:
                fail("node", f"{kind}: device flags {a['device']}, "
                             f"{b['device']}")
            if kind == "pagerank":
                if [x["uid"] for x in a["top"]] != \
                        [x["uid"] for x in b["top"]] or any(
                            abs(x["score"] - y["score"]) >= PAGERANK_TOL
                            for x, y in zip(a["top"], b["top"])):
                    fail("node", f"pagerank {a} vs {b}")
            else:
                for d in (a, b):
                    d.pop("device"), d.pop("iterations", None)
                if a != b:
                    fail("node", f"{kind}: {a} vs {b}")
        node_stats = {"fused": node_fused, "unfused": mn.metrics.counter(
            "dgraph_mesh_unfused_queries_total").value,
            "devices": mn.mesh_exec.n_devices}
    finally:
        mn.close()
        pn.close()
    ms["node"] = (time.perf_counter() - t0) * 1e3

    say("mesh", shards=MESH_SHARDS, steps_ms=ms,
        loop_reads={"bfs_levels": bfs_reads, "pagerank_iterations": pr_reads,
                    "cc_iterations": cc_reads, "total": loop_reads},
        program_builds=stats["dgraph_mesh_program_builds_total"],
        dispatches=stats["dgraph_mesh_dispatches_total"],
        fused_hops=stats["dgraph_mesh_fused_hops_total"],
        traversed_edges=stats["dgraph_mesh_traversed_edges_total"],
        fused_queries=stats["dgraph_mesh_fused_queries_total"],
        unfused_queries=stats["dgraph_mesh_unfused_queries_total"],
        fallbacks=fallbacks, groupby_a_groups=groups_a,
        terminal_checks=checks["counts"], node=node_stats,
        profiles=profiles,
        launches=mesh_launch,
        phase_seconds=time.perf_counter() - t_phase)
    return mesh_launch


def vector_phase(snap4, csr, dev, n=VEC_N, n_queries=VEC_QUERIES) -> dict:
    """Phase 12: vectors at sift-128-euclidean's shape. `n` float32 rows of
    VEC_DIM dims from a seeded Gaussian mixture (VEC_PLANTED identical
    rows of small integers planted at scattered uids) go into the port's
    Store as `emb` values on uids 1..n of the headline graph (bulk_install,
    as phase 8 installs `age`), fold through a SnapshotAssembler with
    VectorKnobs(ivf_min_rows > n) (a brute-force tablet), and join phase
    4's carried `friend` in one snapshot. Over it: (a) solo probes equal
    to a numpy float64 exact scan, the planted tie decided by the uid rule;
    (b) a burst of VEC_BURST through one DeviceBatcher batch, each JSON
    byte-identical to its solo JSON; (c) the fused ANN -> friend hop as one
    vector.ann_expand span, equal to JSON built from (a)'s uids and phase
    2's host CSR; (d) a commit of VEC_OVERLAY_SET new rows and
    VEC_OVERLAY_DEL deletions stamped as a VecOverlay, its answers equal
    to a from-scratch fold's; (e) similar_to ... @recurse(depth: 2) over
    friend with K1 or K2 launched, byte-identical to the host-mirror
    route; (f) an IVF index of VEC_IVF_CENTROIDS lists over the first
    VEC_IVF_ROWS rows, its device stage equal to the float64 re-rank of the
    same probed rows and its recall@10 against a float64 exact scan of
    those rows at least VEC_RECALL_MIN; (g) a COLD tablet under a budget
    below its footprint serving two probes by host scan, no upload.
    Returns the K1/K2 launches of (e)."""
    import threading

    import torch

    from dgraph_tpu_torch.obs import otrace
    from dgraph_tpu_torch.ops import prefix as px
    from dgraph_tpu_torch.ops import vector as vops
    from dgraph_tpu_torch.query import batch as batchmod
    from dgraph_tpu_torch.query import dql, mutation, rdf
    from dgraph_tpu_torch.query import engine as eng
    from dgraph_tpu_torch.query.qcache import DispatchGate
    from dgraph_tpu_torch.storage import keys as K
    from dgraph_tpu_torch.storage import native
    from dgraph_tpu_torch.storage import residency as resmod
    from dgraph_tpu_torch.storage import vecindex as vx
    from dgraph_tpu_torch.storage.csr_build import (
        GraphSnapshot, PredData, SnapshotAssembler, build_pred)
    from dgraph_tpu_torch.storage.postings import VALUE_UID, Op, Posting
    from dgraph_tpu_torch.utils.metrics import Registry
    from dgraph_tpu_torch.utils.schema import (SchemaState, VectorSpec,
                                               parse_schema)
    from dgraph_tpu_torch.utils.types import TypeID, Val

    subjects, indptr, indices = csr
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    steps = {}

    def fail(what, msg):
        raise SystemExit(f"vector {what}: {msg}")

    if torch.backends.cuda.matmul.allow_tf32:
        fail("precision", "TF32 is on: the candidate stage must be fp32")

    # ---- data: a seeded Gaussian mixture, built in place in float32 -------
    t0 = time.perf_counter()
    rng = np.random.default_rng(VEC_SEED)
    centres = rng.standard_normal((VEC_CLUSTERS, VEC_DIM), dtype=np.float32)
    vecs = rng.standard_normal((n, VEC_DIM), dtype=np.float32)
    vecs *= VEC_NOISE
    vecs += centres[rng.integers(0, VEC_CLUSTERS, n)]
    uids = np.arange(1, n + 1, dtype=np.int64)
    planted_vec = rng.integers(3, 7, VEC_DIM).astype(np.float32)
    planted = np.sort(rng.choice(n, VEC_PLANTED, replace=False))
    vecs[planted] = planted_vec
    picks = rng.integers(0, VEC_CLUSTERS, n_queries)
    Q = (centres[picks] + VEC_NOISE * rng.standard_normal(
        (n_queries, VEC_DIM), dtype=np.float32)).astype(np.float32)
    steps["data"] = time.perf_counter() - t0

    # ---- the reference: a float64 exact scan of every query ---------------
    t0 = time.perf_counter()
    vecs64 = vecs.astype(np.float64)
    nx2 = np.einsum("ij,ij->i", vecs64, vecs64)
    ref = exact_topk(vecs64, nx2, uids,
                     np.vstack([Q, planted_vec[None]]).astype(np.float64),
                     VEC_K)
    ref_planted = ref.pop()
    del vecs64, nx2
    want_planted = uids[planted][:VEC_K]
    if not np.array_equal(ref_planted[0], want_planted) or \
            np.any(ref_planted[1] != 0.0):
        fail("reference", f"the planted query's exact scan is not its "
                          f"{VEC_K} smallest uids at distance 0")
    steps["reference"] = time.perf_counter() - t0

    # ---- load through the Store (bulk_install) and fold -------------------
    t0 = time.perf_counter()
    if not native.available():
        fail("load", "the native codec did not build")
    store = packed_store(VEC_SCHEMA, {}, dict(zip(
        encoded_keys(K.data_key, "emb", uids),
        (Posting(VALUE_UID, Op.SET, Val(TypeID.VECTOR, tuple(r)))
         for r in vecs.tolist()))))
    store.vector_knobs = vx.VectorKnobs(ivf_min_rows=n + 1)
    steps["load"] = time.perf_counter() - t0
    # (d)'s commit touches VEC_OVERLAY_SET + VEC_OVERLAY_DEL keys: the
    # stamp bound is raised to that (serve --overlay_max_keys; the default
    # 512 would fold it inline instead of stamping)
    asm = SnapshotAssembler(store, device=dev,
                            overlay_max_keys=VEC_OVERLAY_SET + VEC_OVERLAY_DEL)
    t0 = time.perf_counter()
    pd = asm.snapshot(1).pred("emb")
    fold_s = time.perf_counter() - t0
    vi = pd.vecindex
    if vi is None or vi.is_overlay or vi.ivf is not None or vi.n != n:
        fail("fold", f"not a brute-force index of {n} rows: {vi}")
    if not (np.array_equal(vi.subjects, uids) and
            np.array_equal(vi.vecs, vecs)):
        fail("fold", "the folded matrix differs from the input rows")
    R = vops.row_capacity(n)
    footprint = vi.device_nbytes()
    if footprint != R * (VEC_DIM * 4 + 4 + 4):
        fail("fold", f"device footprint {footprint}")
    t0 = time.perf_counter()
    vi.device()
    sync()
    upload_s = time.perf_counter() - t0

    schema = SchemaState()
    for e in parse_schema("friend: [uid] @reverse .\n" + VEC_SCHEMA):
        schema.set(e)
    metrics = Registry()

    def joined(emb_pd):
        """Phase 4's friend and ~friend with `emb` of this Store."""
        s = GraphSnapshot(2, device=dev)
        for attr in ("friend", "~friend"):
            if snap4.pred(attr) is not None:
                s.preds[attr] = snap4.pred(attr)
        s.preds["emb"] = emb_pd
        s.metrics = metrics
        return s

    snap = joined(pd)
    c = lambda name: metrics.counter(name).value
    solo_text = "{ q(func: similar_to(emb, \"%s\", %d)) " \
                "{ uid d : val(vector_distance) } }"

    def execute(s, text, **kw):
        return eng.Executor(s, schema, **kw).execute(dql.parse(text))

    def ranked(out):
        """(uids, distances) of a solo answer, in the reference's order."""
        rows_ = out.get("q", [])
        u = np.asarray([int(r["uid"], 16) for r in rows_], np.int64)
        d = np.asarray([r["d"] for r in rows_], np.float64)
        o = np.lexsort((u, d))
        return u[o], d[o]

    # ---- (a) solo probes ---------------------------------------------------
    t0 = time.perf_counter()
    texts = [solo_text % (vec_text(q), VEC_K) for q in Q]
    solo_json = []
    for i, text in enumerate(texts):
        out = execute(snap, text)
        solo_json.append(json.dumps(out))
        if not same_ranking(*ranked(out), *ref[i]):
            fail("solo", f"query {i}: {ranked(out)} != exact {ref[i]}")
    out = execute(snap, solo_text % (vec_text(planted_vec), VEC_K))
    if not same_ranking(*ranked(out), *ref_planted):
        fail("tie", f"the planted tie kept {ranked(out)[0]}, not the "
                    f"{VEC_K} smallest uids {want_planted}")
    if c("dgraph_vector_searches_total") != n_queries + 1:
        fail("solo", f"{c('dgraph_vector_searches_total')} searches")
    steps["solo"] = time.perf_counter() - t0
    probe = lambda q: vx.search(vi, q, VEC_K)
    samples = []
    for q in Q[:20]:
        t1 = time.perf_counter()
        probe(q)
        samples.append((time.perf_counter() - t1) * 1e3)
    solo_prof = profile_query(lambda: probe(Q[0]))
    if not solo_prof["device_busy_ms"]:
        fail("profile", "the trace of a device probe shows no device time")
    # the candidate stage alone (the matrix product and the top-k) by CUDA
    # events: one call, and back to back (the device's time per probe, the
    # share of the bytes bound is read from it). The trace above gives the
    # breakdown by kernel; in a process that has traced before, it can miss
    # kernels (its busy time then falls below the bound: flagged)
    mat, norms, _subs = vi.device()
    qd = torch.from_numpy(Q[0]).to(dev)
    nodead = torch.zeros(0, dtype=torch.int32)
    stage = lambda: vops.topk_candidates(mat, norms, qd, n, nodead,
                                         k=vops.k_capacity(VEC_K, R),
                                         metric="l2")
    stage_ms = {"one_call": timed(stage, calls=1, reps=20),
                "back_to_back": timed(stage)}
    bound_ms = footprint / HBM_BYTES_PER_S * 1e3
    if stage_ms["back_to_back"] < bound_ms:
        fail("timing", f"the candidate stage {stage_ms} is below its bound "
                       f"{bound_ms} ms")
    say("vector_solo", queries=n_queries, k=VEC_K,
        kprime=vops.k_capacity(VEC_K, R), planted=VEC_PLANTED,
        planted_uids=[int(u) for u in ranked(out)[0]],
        probe_ms=band(samples), candidate_stage_ms=stage_ms,
        bytes_bound_ms=bound_ms,
        share_of_bytes_bound=bound_ms / stage_ms["back_to_back"],
        trace_below_bound=solo_prof["device_busy_ms"] < bound_ms,
        profile=solo_prof, seconds=steps["solo"])

    # ---- phase 9b's probe: the index over MESH_SHARDS shards ----------------
    t0 = time.perf_counter()
    from dgraph_tpu_torch.parallel.mesh import make_mesh
    from dgraph_tpu_torch.parallel.mesh_exec import MeshExecutor

    vme = MeshExecutor(mesh=make_mesh(MESH_SHARDS,
                                      devices=[dev] * MESH_SHARDS))
    es = GraphSnapshot(2, device=dev)
    es.preds["emb"] = pd
    es.metrics = Registry()          # phase 12's own counters stay as they are
    placed = vme.place_snapshot(es)
    if placed.pred("emb").vecindex._mesh is not vme:
        fail("mesh", "the index was not placed on the mesh")
    before = dict(px.LAUNCHES)
    got = json.dumps(execute(placed, texts[0], mesh=vme))
    if got != solo_json[0] or not same_ranking(
            *ranked(json.loads(got)), *ref[0]):
        fail("mesh", "the sharded probe differs from the exact scan")
    mesh_probe_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        execute(placed, texts[0], mesh=vme)
        sync()
        mesh_probe_ms.append((time.perf_counter() - t1) * 1e3)
    vmc = vme.metrics.counter("dgraph_vector_mesh_dispatches_total").value
    if vmc != 6 or dict(px.LAUNCHES) != before:
        fail("mesh", f"{vmc} sharded scans, launches {px.LAUNCHES}")
    mesh_prof = profile_query(lambda: execute(placed, texts[0], mesh=vme))
    say("vector_mesh", shards=MESH_SHARDS, rows=n,
        rows_per_shard=int(placed.pred("emb").vecindex._mesh_dev[3]),
        probe_ms=band(mesh_probe_ms), scans=vmc, profile=mesh_prof,
        seconds=time.perf_counter() - t0)
    del vme, es, placed
    torch.cuda.empty_cache()

    # ---- (b) a burst through one batch -------------------------------------
    t0 = time.perf_counter()
    gate = DispatchGate(width=4, metrics=metrics)
    batcher = batchmod.DeviceBatcher(gate, metrics,
                                     window_ms=BURST_WINDOW_MS,
                                     max_batch=VEC_BURST, idle_fire=False)
    burst_texts = texts[:VEC_BURST]
    outs, errs = [None] * VEC_BURST, [None] * VEC_BURST
    barrier = threading.Barrier(VEC_BURST)
    shapes = []
    real = vops.topk_candidates_batch

    def spy(*a, **k):
        shapes.append(tuple(a[2].shape))
        return real(*a, **k)

    def go(i):
        barrier.wait(timeout=60)
        try:
            outs[i] = json.dumps(execute(snap, burst_texts[i], gate=gate,
                                         batcher=batcher))
        except BaseException as e:           # surfaced below
            errs[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(VEC_BURST)]
    vops.topk_candidates_batch = spy
    try:
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        sync()
        burst_s = time.perf_counter() - t1
    finally:
        vops.topk_candidates_batch = real
    if any(t.is_alive() for t in threads) or any(errs):
        fail("burst", f"a request did not finish or raised: {errs}")
    for i, (a, w) in enumerate(zip(outs, solo_json)):
        if a != w:
            fail("burst", f"request {i}: the batched JSON differs from its "
                          f"solo JSON")
    formed = c("dgraph_batch_formed_total")
    if shapes != [(VEC_BURST, VEC_DIM)] or formed != 1:
        fail("burst", f"not one batch.vector_topk of {VEC_BURST}: "
                      f"{shapes}, {formed} batches")
    say("vector_burst", requests=VEC_BURST, batches=formed,
        stacked=list(shapes[0]), burst_seconds=burst_s,
        seconds=time.perf_counter() - t0)

    # ---- (c) the fused ANN -> friend hop ------------------------------------
    t0 = time.perf_counter()
    fused_text = ("{ q(func: similar_to(emb, \"%s\", %d)) "
                  "{ uid friend { uid } } }")
    pos = np.clip(np.searchsorted(subjects, ref[0][0]), 0, len(subjects) - 1)
    want = {"q": []}
    for u, p in zip(ref[0][0].tolist(), pos.tolist()):
        row = {"uid": hex(u)}
        if subjects[p] == u and indptr[p + 1] > indptr[p]:
            row["friend"] = [{"uid": hex(int(v))}
                             for v in indices[indptr[p]: indptr[p + 1]]]
        want["q"].append(row)
    want["q"].sort(key=lambda r: int(r["uid"], 16))
    tracer = otrace.Tracer(fraction=1.0, proc="chip_smoke")
    f0 = c("dgraph_vector_fused_pipelines_total")
    with tracer.root("query"):
        got = execute(snap, fused_text % (vec_text(Q[0]), VEC_K))
    if json.dumps(got) != json.dumps(want):
        fail("fused", "the fused JSON differs from (a)'s uids over phase 2's "
                      "host CSR")
    rec = tracer.sink.get(tracer.sink.index()[0]["trace_id"])
    names = [(s["name"], s["attrs"].get("kernel")) for s in rec["spans"]]
    kernels_ = [k for nm, k in names if nm == "device_kernel"]
    if kernels_ != ["vector.ann_expand"] or \
            any(nm.startswith("task:") for nm, _ in names) or \
            c("dgraph_vector_fused_pipelines_total") != f0 + 1:
        fail("fused", f"not one vector.ann_expand dispatch: {names}")
    samples = []
    for q in Q[1:6]:
        t1 = time.perf_counter()
        execute(snap, fused_text % (vec_text(q), VEC_K))
        samples.append((time.perf_counter() - t1) * 1e3)
    say("vector_fused", json_bytes=len(json.dumps(got)), spans=names,
        request_ms=band(samples), seconds=time.perf_counter() - t0)

    # ---- (e) similar_to feeding @recurse over friend (K1/K2) ----------------
    t0 = time.perf_counter()
    deg = np.diff(indptr).astype(np.int64)
    hit_pos = np.clip(np.searchsorted(subjects, indices), 0, len(subjects) - 1)
    two = np.where(subjects[hit_pos] == indices, deg[hit_pos], 0)
    cs = np.concatenate([[0], np.cumsum(two)])
    s2 = cs[indptr[1:]] - cs[indptr[:-1]]
    del hit_pos, two, cs

    def est(u_set):
        p = np.clip(np.searchsorted(subjects, u_set), 0, len(subjects) - 1)
        ok = subjects[p] == u_set
        return int((deg[p] + s2[p])[ok].sum())

    pick = next((i for i in range(n_queries)
                 if 200 <= est(ref[i][0]) <= VEC_RECURSE_MAX_ROWS), None)
    if pick is None:
        fail("recurse", "no query's answers render a depth-2 tree of "
                        f"200..{VEC_RECURSE_MAX_ROWS} rows")
    rtext = ("{ q(func: similar_to(emb, \"%s\", %d)) @recurse(depth: 2) "
             "{ friend } }" % (vec_text(Q[pick]), VEC_K))
    host = on_host(lambda: json.dumps(execute(snap, rtext)))
    sync()
    px.reset_launches()
    got = json.dumps(execute(snap, rtext))
    sync()
    launches = dict(px.LAUNCHES)
    if got != host:
        fail("recurse", "the kernel-path JSON differs from the host-mirror "
                        "route's")
    if not any(launches.values()):
        fail("recurse", f"K1/K2 never launched: {launches}")
    say("vector_recurse", query=pick, est_rows=est(ref[pick][0]),
        json_bytes=len(got), launches=launches,
        seconds=time.perf_counter() - t0)

    # ---- (d) an overlay: new rows and deletions through the Store ----------
    t0 = time.perf_counter()
    touched_u = rng.choice(uids, VEC_OVERLAY_SET + VEC_OVERLAY_DEL,
                           replace=False)
    set_u, del_u = touched_u[:VEC_OVERLAY_SET], touched_u[VEC_OVERLAY_SET:]
    newv = (centres[rng.integers(0, VEC_CLUSTERS, VEC_OVERLAY_SET)]
            + VEC_NOISE * rng.standard_normal((VEC_OVERLAY_SET, VEC_DIM),
                                              dtype=np.float32))
    set_nq = "\n".join(f'<{hex(int(u))}> <emb> "{vec_text(v)}" .'
                       for u, v in zip(set_u, newv.astype(np.float32)))
    del_nq = "\n".join(f"<{hex(int(u))}> <emb> * ." for u in del_u)
    edges = (mutation.to_edges(rdf.parse(set_nq), {}, Op.SET)
             + mutation.to_edges(rdf.parse(del_nq), {}, Op.DEL))
    touched = mutation.apply_mutations(store, edges, 2)[0]
    store.commit(2, 3, touched)
    t1 = time.perf_counter()
    pd3 = asm.snapshot(3).pred("emb")
    stamp_ms = (time.perf_counter() - t1) * 1e3
    vo = pd3.vecindex
    if not getattr(vo, "is_overlay", False) or vo.base is not vi:
        fail("overlay", f"the commit was not stamped over the base: {vo}")
    if len(vo.dead_rows) != len(touched_u) or \
            vo.n != n - VEC_OVERLAY_DEL:
        fail("overlay", f"dead rows {len(vo.dead_rows)}, n {vo.n}")
    t1 = time.perf_counter()
    fresh = build_pred(store, "emb", 3, device=dev).vecindex
    refold_s = time.perf_counter() - t1
    if fresh.is_overlay or fresh.n != vo.n:
        fail("overlay", "the from-scratch fold is not a plain index")
    snap3 = joined(pd3)
    dead = set(del_u.tolist())
    for i, q in enumerate(Q):
        a = vx.search(vo, q, VEC_K)
        b = vx.search(fresh, q, VEC_K)
        if not same_ranking(a[0], a[1], b[0], b[1]):
            fail("overlay", f"query {i}: overlay {a} != fold {b}")
        if dead & set(a[0].tolist()):
            fail("overlay", f"query {i} returned a deleted uid")
        out = execute(snap3, texts[i])
        if not same_ranking(*ranked(out), *b):
            fail("overlay", f"query {i}: the request over the overlay "
                            f"differs from the fold")
    if not vi.device_resident():
        fail("overlay", "the overlay's base scan left the card")
    fresh.drop_device()
    del fresh
    say("vector_overlay", set=VEC_OVERLAY_SET, deleted=VEC_OVERLAY_DEL,
        dead_rows=int(len(vo.dead_rows)), stamp_ms=stamp_ms,
        refold_seconds=refold_s, seconds=time.perf_counter() - t0)

    # ---- (f) IVF over the first VEC_IVF_ROWS rows -------------------------
    t0 = time.perf_counter()
    spec = VectorSpec(dim=VEC_DIM, metric="l2")
    m = min(n, VEC_IVF_ROWS)
    t1 = time.perf_counter()
    ivf = vx._build_ivf(vecs[:m], "l2", VEC_IVF_CENTROIDS)
    ivf_build_s = time.perf_counter() - t1
    vi_ivf = vx.VectorIndex("emb", spec, uids[:m], vecs[:m], ivf,
                            device=dev)
    sub64 = vecs[:m].astype(np.float64)
    ref_ivf = exact_topk(sub64, np.einsum("ij,ij->i", sub64, sub64),
                         uids[:m], Q.astype(np.float64), VEC_K)
    del sub64
    hits = 0
    cands = []
    for i, q in enumerate(Q):
        q64 = q.astype(np.float64)
        rows_ = vx._ivf_candidate_rows(vi_ivf, q64, vx.VECTOR_NPROBE)
        cands.append(len(rows_))
        dev_rows = vx._ivf_device_stage(vi_ivf, q, rows_, VEC_K)
        su, sd = vx._rescore(vi_ivf, dev_rows, q64)
        got_u, got_d = vx._rank(sd, su, VEC_K)
        if i < VEC_IVF_RERANKS:
            hu, hd = vx._rescore(vi_ivf, rows_, q64)
            want_u, want_d = vx._rank(hd, hu, VEC_K)
            if not same_ranking(got_u, got_d, want_u, want_d):
                fail("ivf", f"query {i}: the device stage {got_u} differs "
                            f"from the float64 re-rank of the probed rows "
                            f"{want_u}")
        auto_u, _ = vx.search(vi_ivf, q, VEC_K)
        if not np.array_equal(auto_u, got_u):
            fail("ivf", f"query {i}: search() took another route")
        hits += len(set(got_u.tolist()) & set(ref_ivf[i][0].tolist()))
    recall = hits / (VEC_K * n_queries)
    if recall < VEC_RECALL_MIN:
        fail("ivf", f"recall@{VEC_K} {recall} < {VEC_RECALL_MIN}")
    vi_ivf.drop_device()
    say("vector_ivf", rows=m, centroids=ivf.n_lists, nprobe=vx.VECTOR_NPROBE,
        reranked=min(VEC_IVF_RERANKS, n_queries),
        build_seconds=ivf_build_s, candidates=band(cands),
        recall_at_10=recall, seconds=time.perf_counter() - t0)

    # ---- (g) the cold tier: a budget below the footprint -------------------
    t0 = time.perf_counter()
    mgr = resmod.ResidencyManager(budget_bytes=footprint // 2,
                                  metrics=Registry())
    vi_cold = vx.VectorIndex("emb", spec, uids, vecs, device=dev)
    holder = PredData("emb", TypeID.VECTOR)
    holder.vecindex = vi_cold
    mgr.adopt_pred(holder)
    alloc0 = torch.cuda.memory_allocated()
    for i in range(2):
        u, d = vx.search(vi_cold, Q[i], VEC_K)
        if not same_ranking(u, d, *ref[i]):
            fail("cold", f"query {i}: the host scan differs from (a)")
    cold = mgr.metrics.counter("dgraph_residency_cold_serves_total").value
    if cold < 1 or vi_cold.device_resident() or \
            torch.cuda.memory_allocated() != alloc0:
        fail("cold", f"cold serves {cold}, resident "
                     f"{vi_cold.device_resident()}")
    say("vector_cold", budget=footprint // 2, footprint=footprint,
        cold_serves=cold, seconds=time.perf_counter() - t0)

    vi.drop_device()
    say("vector_phase", rows=n, dim=VEC_DIM, fold_seconds=fold_s,
        upload_seconds=upload_s, steps=steps,
        seconds=time.perf_counter() - t_phase)
    return launches


def read_csv(path) -> list[list[str]]:
    """Rows of one LDBC CSV (pipe-separated, one header row)."""
    with open(path, encoding="utf-8") as f:
        return [ln.rstrip("\n").split("|") for ln in f][1:]


def cli_start(*args) -> subprocess.Popen:
    """`python -m dgraph_tpu_torch <args>` started; cli_wait reads it."""
    return subprocess.Popen(
        [sys.executable, "-m", "dgraph_tpu_torch", *args],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def cli_wait(p: subprocess.Popen, timeout=600) -> str:
    """stdout of a started CLI run; a non-zero exit fails the phase with
    the tail of its output (the process is killed at the timeout)."""
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise SystemExit(f"loader cli {p.args[3]}: no end in {timeout} s")
    if p.returncode != 0:
        raise SystemExit(f"loader cli {p.args[3]}: exit {p.returncode}: "
                         f"{(out + err)[-2000:]}")
    return out


def cli(*args, timeout=600) -> tuple[float, str]:
    """(seconds, stdout) of `python -m dgraph_tpu_torch <args>` run to its
    end."""
    t0 = time.perf_counter()
    out = cli_wait(cli_start(*args), timeout)
    return time.perf_counter() - t0, out


def analysis_phase() -> None:
    """Phase 15: `python -m dgraph_tpu_torch.analysis` over the checkout's
    port package. A finding, a non-zero exit or ANALYSIS_MAX_S of wall
    clock or more fails the run."""
    from dgraph_tpu_torch.analysis import RULES

    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "dgraph_tpu_torch.analysis", "--format=json",
         "dgraph_tpu_torch"], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=120)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise SystemExit(f"analysis: exit {p.returncode}: "
                         f"{(p.stdout + p.stderr)[-2000:]}")
    out = json.loads(p.stdout)
    by_rule = {r: 0 for r in sorted(RULES)}
    for f in out["findings"]:
        by_rule[f["rule"]] += 1
    say("analysis", files=out["files"], findings=by_rule, seconds=wall,
        analyzer_seconds=out["elapsed_s"])
    if out["findings"] or wall >= ANALYSIS_MAX_S:
        raise SystemExit(f"analysis: {len(out['findings'])} finding(s) in "
                         f"{wall} s (budget {ANALYSIS_MAX_S} s)")


def kernel_launches(port) -> dict:
    """The server's own K1/K2 launch counts, from its /metrics."""
    from dgraph_tpu_torch.obs import prom

    st, body = http_call(port, "GET", "/metrics")
    if st != 200:
        raise SystemExit(f"loader metrics: status {st}")
    series = prom.parse(body.decode()).get("dgraph_kernel_launches", [])
    out = {"active_prefix": 0, "active_prefix_sparse": 0}
    for labels, v in series:
        out[labels.get("kernel", "")] = int(v)
    return out


def loader_phase(dev, sf=LDBC_SF) -> dict:
    """Phase 13: the loader chain users run, each step a subprocess of the
    port's CLI: `ldbc_gen --sf sf`, `convert --ldbc`, `bulk`, then `serve
    -p` over the bulk output (started as phase 10 starts the CLI). Over its
    HTTP: the 3-hop friends-of-friends @recurse over `knows` from the
    person with the most `knows` edges (K1 or K2 launched, read from the
    server's own /metrics), IS3 (a person's friends, both directions) and
    the longest reply chain, each held to numpy over the generated CSVs;
    after the server stops, each is held to the host-mirror route through
    a Node on the same directory. Then `export -p` equals the input
    N-Quads under the bulk load's xid map; `live` of a LIVE_PREFIX-quad
    prefix into a fresh directory exports equal to `bulk` of the same
    prefix; and ops/packed_decode decodes every bp128 list of the `knows`
    tablet on the card, equal to the host codec. Returns the server's
    K1/K2 launches over the requests."""
    import gzip
    from collections import Counter

    from dgraph_tpu_torch.api.server import Node
    from dgraph_tpu_torch.coord.zero import UidLease
    from dgraph_tpu_torch.loader import bulk
    from dgraph_tpu_torch.loader.xidmap import XidMap
    from dgraph_tpu_torch.ops import packed_decode as pdec
    from dgraph_tpu_torch.storage import keys as K
    from dgraph_tpu_torch.storage import packed
    from dgraph_tpu_torch.storage.store import Store
    from dgraph_tpu_torch.utils.schema import parse_schema
    from dgraph_tpu_torch.utils.types import convert

    t_phase = time.perf_counter()
    secs = {}

    def fail(what, msg):
        raise SystemExit(f"loader {what}: {msg}")

    with tempfile.TemporaryDirectory(prefix="dgt-ldbc-") as tmp:
        tmp = Path(tmp)
        dump, quads, post = tmp / "csv", tmp / "q.rdf.gz", tmp / "p"
        schema_path = Path(f"{quads}.schema")
        secs["ldbc_gen"], _ = cli("ldbc_gen", "--sf", str(sf), "--seed",
                                  str(LDBC_SEED), "--out", str(dump))
        secs["convert"], _ = cli("convert", "--ldbc", str(dump), "--out",
                                 str(quads))
        t_bulk = time.time()
        secs["bulk"], out = cli("bulk", "-f", str(quads), "-s",
                                str(schema_path), "-o", str(post),
                                "--spill_mb", str(LDBC_SPILL_MB),
                                "--log_json")
        events = {e.get("event"): e for e in map(json.loads, (
            ln for ln in out.splitlines() if ln.startswith("{")))}
        if not {"map done", "reduce done", "bulk load done"} <= set(events):
            fail("bulk", f"log events {sorted(events)}")
        secs["map"] = events["map done"]["ts"] - t_bulk
        secs["reduce"] = events["reduce done"]["ts"] - \
            events["map done"]["ts"]
        done = events["bulk load done"]

        # ---- numpy over the CSVs --------------------------------------------
        knows = np.asarray([(int(a), int(b)) for a, b, _ in read_csv(
            next(dump.glob("person_knows_person_*.csv")))], np.int64)
        persons = {int(r[0]): r for r in read_csv(
            next(dump.glob("person_[0-9]*.csv")))}
        out_deg = np.bincount(knows[:, 0])
        hub = int(np.argmax(out_deg))
        adj = {}
        for a, b in knows.tolist():
            adj.setdefault(a, []).append(b)
        reach, frontier = {hub}, {hub}
        for _ in range(3):
            frontier = {v for u in frontier for v in adj.get(u, ())} - reach
            reach |= frontier
        # IS3 reads both directions of knows: a pair listed each way
        # counts once per direction
        friend_of = sorted(set(knows[knows[:, 0] == hub, 1].tolist())) + \
            sorted(set(knows[knows[:, 1] == hub, 0].tolist()))
        friend_of.sort()
        reply = dict((int(a), int(b)) for a, b in read_csv(
            next(dump.glob("comment_replyOf_comment_*.csv"))))
        to_post = dict((int(a), int(b)) for a, b in read_csv(
            next(dump.glob("comment_replyOf_post_*.csv"))))

        def chain(cid):
            out_ = [cid]
            while out_[-1] in reply:
                out_.append(reply[out_[-1]])
            return out_

        longest = max(reply, key=lambda cid: (len(chain(cid)), -cid))
        want_chain = chain(longest)
        want_post = to_post[want_chain[-1]]

        requests = {
            "fof3": "{ q(func: eq(person.id, %d)) @recurse(depth: 3) "
                    "{ person.id knows } }" % hub,
            "is3": "{ q(func: eq(person.id, %d)) { knows { person.id "
                   "firstName lastName } ~knows { person.id firstName "
                   "lastName } } }" % hub,
            "reply_chain": "{ q(func: eq(comment.id, %d)) "
                           "@recurse(depth: %d) { comment.id post.id "
                           "replyOf } }" % (longest, len(want_chain) + 1),
        }

        def check(name, data):
            if name == "fof3":
                ids = set()

                def walk(rows):
                    for r in rows:
                        ids.add(r["person.id"])
                        walk(r.get("knows", []))
                walk(data["q"])
                if ids != reach:
                    fail(name, f"{len(ids)} persons != the BFS's "
                               f"{len(reach)}")
            elif name == "is3":
                row = data["q"][0]
                got = sorted(r["person.id"] for r in
                             row.get("knows", []) + row.get("~knows", []))
                if got != friend_of:
                    fail(name, "the friends differ from the CSV")
                for r in row.get("knows", []) + row.get("~knows", []):
                    p = persons[r["person.id"]]
                    if (r["firstName"], r["lastName"]) != (p[1], p[2]):
                        fail(name, f"names of {r['person.id']}")
            else:
                ids, node = [], data["q"][0]
                while True:
                    ids.append(node.get("comment.id", node.get("post.id")))
                    nxt = node.get("replyOf", [])
                    if not nxt:
                        break
                    node = nxt[0]
                if ids != want_chain + [want_post]:
                    fail(name, f"chain {ids} != {want_chain + [want_post]}")

        # ---- serve -p over the bulk output ----------------------------------
        server = CliServer("-p", str(post))
        served, timings = {}, {}
        try:
            banners = {}
            while len(banners) < 2:
                t_line, ln = server.lines.get(timeout=300)
                if ln is None:
                    fail("serve", f"exited: {''.join(server.log)[-2000:]}")
                for role in ("gRPC", "HTTP"):
                    if ln.startswith(f"serving {role} on "):
                        banners[role] = ln
            secs["serve_open"] = t_line - server.t0
            port = int(banners["HTTP"].split()[3].rsplit(":", 1)[1])
            if f"device={dev}" not in banners["HTTP"].split():
                fail("serve", f"not on {dev}: {banners['HTTP']}")
            before = kernel_launches(port)
            for name, text in requests.items():
                t0 = time.perf_counter()
                st, body = http_call(port, "POST", "/query", text)
                timings[name] = (time.perf_counter() - t0) * 1e3
                if st != 200:
                    fail(name, f"status {st}: {body[:300]!r}")
                served[name] = json.loads(body)["data"]
                check(name, served[name])
                if name == "fof3":
                    fof_launches = {k: v - before[k] for k, v in
                                    kernel_launches(port).items()}
            secs["first_query"] = timings["fof3"] / 1e3
            if not any(fof_launches.values()):
                fail("fof3", f"K1/K2 never launched: {fof_launches}")
            st, _ = http_call(port, "POST", "/admin/shutdown")
            if st != 200 or server.proc.wait(timeout=120) != 0:
                fail("serve", "the server did not stop cleanly")
        finally:
            server.stop()

        # ---- the host-mirror route over the same directory ------------------
        node = Node(dirpath=str(post), device=dev)
        try:
            for name, text in requests.items():
                host = on_host(lambda: node.query(text)[0])
                if host != served[name]:
                    fail(name, "the served data differs from the host-mirror "
                               "route's")
        finally:
            node.close()

        # ---- export -p equals the input N-Quads under the xid map -----------
        t0 = time.perf_counter()
        exported = tmp / "export.rdf.gz"
        export_proc = cli_start("export", "-p", str(post), "-o",
                                str(exported))
        schema = {e.predicate: e.type_id
                  for e in parse_schema(schema_path.read_text())}
        xm = XidMap(UidLease(), dirpath=str(post / "xidmap"))
        n_xids = len(xm)

        def facts(path, mapped):
            """The multiset of (subject uid, predicate, object uid or
            (type id, value) converted to the schema's type), parsed by the
            bulk loader's map stage (its spawned parse workers)."""
            out_ = []
            for s_, p_, oid, val, _lang, _fac, _star in bulk.iter_quads(
                    [str(path)], LDBC_PARSE_WORKERS):
                s_ = xm.uid(s_) if mapped else int(s_, 16)
                if oid:
                    o = xm.uid(oid) if mapped else int(oid, 16)
                else:
                    v = convert(val, schema[p_])
                    o = (int(v.tid), v.value)
                out_.append((s_, p_, o))
            return Counter(out_)

        want_facts = facts(quads, True)
        cli_wait(export_proc)
        got_facts = facts(exported, False)
        if len(xm) != n_xids:
            fail("export", "an input xid is missing from the bulk xid map")
        if got_facts != want_facts:
            fail("export", "the export differs from the input N-Quads")
        secs["export"] = time.perf_counter() - t0

        # ---- live of a prefix against bulk of the same prefix ---------------
        t0 = time.perf_counter()
        lines = gzip.decompress(quads.read_bytes()).decode().splitlines()
        prefix = tmp / "prefix.rdf"
        prefix.write_text("\n".join(lines[:LIVE_PREFIX]) + "\n")
        # live and bulk of the prefix side by side, then both exports
        for p in [cli_start("live", "-f", str(prefix), "-s",
                            str(schema_path), "-p", str(tmp / "live")),
                  cli_start("bulk", "-f", str(prefix), "-s",
                            str(schema_path), "-o", str(tmp / "bulk_prefix"))]:
            cli_wait(p)
        for p in [cli_start("export", "-p", str(tmp / src), "-o",
                            str(tmp / f"{src}.gz"))
                  for src in ("live", "bulk_prefix")]:
            cli_wait(p)
        dumps = [sorted(gzip.decompress((tmp / f"{src}.gz").read_bytes())
                        .splitlines()) for src in ("live", "bulk_prefix")]
        if dumps[0] != dumps[1] or len(dumps[0]) < LIVE_PREFIX // 2:
            fail("live", "live's export differs from bulk's of the prefix")
        secs["live_vs_bulk"] = time.perf_counter() - t0

        # ---- packed decode of the knows tablet on the card ------------------
        t0 = time.perf_counter()
        store = Store(str(post))
        try:
            kbs = store.keys_of(K.KeyKind.DATA, "knows")
            pls = [pl.base_packed for pl in store.tablet_lists(
                int(K.KeyKind.DATA), "knows", kbs)
                if pl.base_packed is not None]
        finally:
            store.close()
        # the tablet's lists as one block stream (each block decodes from
        # its own first uid and word offset): one upload, one decode
        offs = np.concatenate([[0], np.cumsum([len(pu.words) for pu in pls])])
        tablet = packed.PackedUidList(
            count=sum(pu.count for pu in pls),
            block_first=np.concatenate([pu.block_first for pu in pls]),
            block_last=np.concatenate([pu.block_last for pu in pls]),
            block_count=np.concatenate([pu.block_count for pu in pls]),
            block_width=np.concatenate([pu.block_width for pu in pls]),
            block_off=np.concatenate([pu.block_off + o
                                      for pu, o in zip(pls, offs)]),
            words=np.concatenate([pu.words for pu in pls]))
        got = pdec.unpack_device(pdec.to_device(tablet, device=dev))
        got = got.cpu().numpy()
        want = np.concatenate([packed.unpack(pu) for pu in pls])
        if not np.array_equal(got[got != 2**31 - 1].astype(np.int64),
                              want.astype(np.int64)):
            fail("packed", "unpack_device differs from packed.unpack")
        decoded = len(want)
        if decoded != int(len(knows)):
            fail("packed", f"{decoded} uids decoded, {len(knows)} knows rows")
        secs["packed_decode"] = time.perf_counter() - t0

    say("loader_phase", sf=sf, persons=len(persons), knows=int(len(knows)),
        hub=hub, reach3=len(reach), nquads=len(lines),
        bulk=dict(nodes=done.get("nodes"), uid_edges=done.get("uid_edges"),
                  values=done.get("values")),
        launches=fof_launches, request_ms=timings, lists=len(pls),
        step_seconds=secs, seconds=time.perf_counter() - t_phase)
    return fof_launches

def encoded_keys(make, attr, uids) -> list[bytes]:
    """Encoded keys of one kind for many uids: the key's head once and the
    uid as 8 big-endian bytes (checked against storage/keys.py)."""
    head = make(attr, 0).encode()[:-8]
    raw = np.asarray(uids, dtype=">u8").tobytes()
    out = [head + raw[i: i + 8] for i in range(0, len(raw), 8)]
    if out and out[-1] != make(attr, int(uids[-1])).encode():
        raise SystemExit("key layout differs from storage/keys.py")
    return out


def packed_rows(keys, rows) -> dict:
    """{key: its row packed by the native codec} for uint64 uid rows, as
    loader/bulk.py's reduce packs them."""
    from dgraph_tpu_torch.storage import native

    return dict(zip(keys, native.pack_many(rows)))


def packed_store(schema_text, packed, values=None, dirpath=None):
    """A Store (in `dirpath`, else in memory) holding at commit ts 1 the
    packed uid rows `packed` ({key: row}, from packed_rows) and the value
    lists `values` ({key: its one value posting}), installed as
    loader/bulk.py's reduce installs them. The value lists share one packed
    [VALUE_UID] row, and two stores may share packed rows: a packed row is
    immutable (a commit or a compaction replaces it)."""
    from dgraph_tpu_torch.storage import native
    from dgraph_tpu_torch.storage.postings import VALUE_UID, PostingList
    from dgraph_tpu_torch.storage.store import Store
    from dgraph_tpu_torch.utils.schema import parse_schema

    store = Store(dirpath)
    for e in parse_schema(schema_text):
        store.set_schema(e)

    def posting_list(pu, postings):
        pl = PostingList()
        pl.base_ts = 1
        pl.base_packed = pu
        pl.base_postings = postings
        return pl

    lists = {kb: posting_list(pu, {}) for kb, pu in packed.items()}
    if values:
        (shared,) = native.pack_many([np.asarray([VALUE_UID], np.uint64)])
        lists.update((kb, posting_list(shared, {VALUE_UID: post}))
                     for kb, post in values.items())
    store.bulk_install(lists, 1)
    return store


def cluster_phase(snap, schema, csr, lists, seeds, q128, host_levels,
                  json_recurse, dev) -> dict:
    """Phase 14: the wire cluster on the card; (b)'s CLI processes start
    first, so their imports and CUDA contexts overlap (a). Returns the
    K1/K2 launches of the 128-seed recurse through the cluster."""
    schema_text, nquads, queries, expected = golden_battery()
    if {name for name, _ in queries} != set(expected):
        raise SystemExit("cluster golden: the battery and expected.json "
                         "name other queries")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dgt-cluster-") as tmp:
        tmp = Path(tmp)
        (tmp / "schema.txt").write_text(schema_text)
        zport = free_port()
        procs = [CliProcess("zero", "--port", str(zport), "--groups", "2")]
        try:
            procs += [CliProcess(
                "worker", "--port", "0", "-p", str(tmp / f"w{g}"),
                "--schema", str(tmp / "schema.txt"), "--zero",
                f"127.0.0.1:{zport}", "--group", str(g), "--device", "cuda")
                for g in range(2)]
            launches = cluster_in_process(snap, schema, csr, lists, seeds,
                                          q128, host_levels, json_recurse,
                                          dev)
            cluster_cli(procs, zport, nquads, queries, expected)
        finally:
            for p in procs:
                p.stop()
    say("cluster_phase", seconds=time.perf_counter() - t_phase)
    return launches


def cluster_in_process(snap, schema, csr, lists, seeds, q128, host_levels,
                       json_recurse, dev) -> dict:
    """Phase 14 (a). In this process, over
    loopback gRPC: serve_zero with two groups and two serve_worker(store,
    device=dev); group 0's Store holds friend with ~friend, group 1's age
    and name on every node id, both installing phase 8's lists as loaded
    (`lists`, see storage_phase) through packed_store. The tablet map is read back from ZeroClient. Then through a ClusterClient:
    phase 4's 128-seed @recurse(depth: 3) (levels equal to phase 4's,
    timed, traced), phase 5's one-uid @recurse and CLUSTER_CHAIN (the
    remote sort key), each JSON byte-identical to the unsharded Executor
    over phase 4's snapshot, and a mutation across both groups committed
    through Zero, read back. Returns the K1/K2 launches of the 128-seed
    recurse."""
    import torch

    from dgraph_tpu_torch.coord.zero import Zero
    from dgraph_tpu_torch.coord.zero_service import ZeroClient, serve_zero
    from dgraph_tpu_torch.ops import csr as csrops
    from dgraph_tpu_torch.ops import prefix as px
    from dgraph_tpu_torch.parallel.client import ClusterClient
    from dgraph_tpu_torch.parallel.remote import RemoteWorker, serve_worker
    from dgraph_tpu_torch.query import dql
    from dgraph_tpu_torch.query import engine as eng
    from dgraph_tpu_torch.query.task import TaskQuery
    from dgraph_tpu_torch.storage import keys as K
    from dgraph_tpu_torch.storage import native
    from dgraph_tpu_torch.storage.postings import VALUE_UID, Op, Posting
    from dgraph_tpu_torch.utils.types import TypeID, Val

    subjects, indptr, indices = csr
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()

    def fail(what, msg):
        raise SystemExit(f"cluster {what}: {msg}")

    if not native.available():
        fail("load", "the native codec did not build")

    # ---- (a) the groups' stores: phase 8's lists as loaded, and `name` ----
    opened = {}
    t0 = time.perf_counter()
    g0 = packed_store(CLUSTER_SCHEMAS[0], lists["friend"])
    opened["store_0"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = 1 << SCALE
    ids = np.arange(1, n + 1, dtype=np.int64)
    rng = np.random.default_rng(11)            # phase 7's draws, in order
    age = rng.integers(0, 100, n)
    rng.integers(0, 10000, n)                  # phase 7's score
    words = rng.integers(0, len(VOCAB), (n, 3)).tolist()
    values = dict(lists["age_values"])
    values.update(zip(encoded_keys(K.data_key, "name", ids), (
        Posting(VALUE_UID, Op.SET, Val(TypeID.STRING, "p%d %s %s %s" % (
            u, *(VOCAB[w] for w in ws)))) for u, ws in zip(ids.tolist(),
                                                           words))))
    g1 = packed_store(CLUSTER_SCHEMAS[1], lists["age"], values)
    del values, words
    opened["store_1"] = time.perf_counter() - t0

    # ---- Zero and the two workers on the card ------------------------------
    zero = Zero(2)
    for attr, g in CLUSTER_TABLETS.items():
        zero.move_tablet(attr, g)
    zero.oracle.timestamps(1)          # read_ts 1: the installs' commit ts
    zsrv, zport, _ = serve_zero(zero, "localhost:0")
    servers, addrs, client = [], [], None
    try:
        for g, store in enumerate((g0, g1)):
            t0 = time.perf_counter()
            srv, port = serve_worker(store, "localhost:0", device=dev)
            opened[f"serve_{g}"] = time.perf_counter() - t0
            servers.append(srv)
            addrs.append(f"localhost:{port}")
        zc = ZeroClient(f"localhost:{zport}")
        tablets = zc.tablets()
        zc.close()
        if tablets != CLUSTER_TABLETS:
            fail("tablets", f"ZeroClient reads {tablets}")
        # each worker's first tasks: the lazy fold of the tablet they read
        first = {}
        probe = np.sort(seeds[:1]).astype(np.int64)
        for g, attr in ((0, "friend"), (1, "age"), (1, "name")):
            rw = RemoteWorker(addrs[g])
            t0 = time.perf_counter()
            rw.process_task(TaskQuery(attr, frontier=probe), 1)
            first[f"{g}:{attr}"] = time.perf_counter() - t0
            rw.close()
        say("cluster_open", store_and_serve_seconds=opened,
            first_task_seconds=first, tablets=tablets,
            devices=[str(s.dgt_svc.device) for s in servers],
            keys=[len(g0.lists), len(g1.lists)])

        client = ClusterClient(f"localhost:{zport}",
                               {g: [a] for g, a in enumerate(addrs)})

        def cold():
            client.task_cache.clear()
            for srv in servers:
                srv.dgt_svc.task_cache.clear()

        def loads():
            return [srv.dgt_svc.tablet_load_snapshot() for srv in servers]

        def wire(before):
            """ServeTask calls and response bytes per worker since
            `before`."""
            out = []
            for b, a in zip(before, loads()):
                out.append({"calls": int(sum(
                    r["r"] - b.get(k, {}).get("r", 0) for k, r in a.items())),
                    "bytes": int(sum(r["b"] - b.get(k, {}).get("b", 0)
                                     for k, r in a.items()))})
            return out

        def levels():
            """Phase 4's 128-seed @recurse on the Executor that
            ClusterClient.query runs (ClusterClient.read_executor): each
            level's dest uids, no JSON (hundreds of MB at this size)."""
            parsed = dql.parse(q128)
            sg = eng.SubGraph(gq=parsed.queries[0],
                              attr=parsed.queries[0].attr)
            client.read_executor()._process_block(sg)
            out = []
            while sg.children:
                sg = sg.children[0]
                out.append(sg.dest_uids)
            return out

        # ---- 1. the 128-seed recurse: the main path of the phase ----------
        cold()
        before = loads()
        expands0 = csrops.EXPANDS["cuda"]
        px.reset_launches()
        t0 = time.perf_counter()
        got = levels()
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(px.LAUNCHES)
        expands = csrops.EXPANDS["cuda"] - expands0
        q1_wire = wire(before)
        if len(got) != len(host_levels) or not all(
                np.array_equal(g, h.dest_uids)
                for g, h in zip(got, host_levels)):
            fail("recurse", "levels differ from phase 4's")
        if expands == 0:
            fail("recurse", "no worker expand ran on the card")
        ms = [first_ms]                # the checked run is the first timed
        for _ in range(CLUSTER_TIMED - 1):
            cold()
            t0 = time.perf_counter()
            levels()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        cold()
        prof = device_profile(levels)
        say("cluster_recurse", levels=[int(len(x)) for x in got],
            first_ms=first_ms, ms=band(ms), launches=launches,
            device_expands=expands, serve_task=q1_wire, profile=prof)

        # ---- 2. phase 5's one-uid recurse, JSON ---------------------------
        want = json.dumps(eng.Executor(snap, schema).execute(
            dql.parse(json_recurse)))
        cold()
        before = loads()
        t0 = time.perf_counter()
        got2 = json.dumps(client.query(json_recurse))
        q2_ms = (time.perf_counter() - t0) * 1e3
        if got2 != want:
            fail("recurse_json", "JSON differs from the unsharded Executor")
        say("cluster_request", request="one_uid_recurse", ms=q2_ms,
            json_bytes=len(got2), serve_task=wire(before))

        # ---- 3. the cross-group chain with the remote sort key -------------
        chain_q = CLUSTER_CHAIN % ", ".join(
            hex(int(u)) for u in np.sort(seeds)[:CLUSTER_CHAIN_SEEDS])
        want = json.dumps(eng.Executor(snap, schema).execute(
            dql.parse(chain_q)))
        cold()
        before = loads()
        t0 = time.perf_counter()
        got3 = json.dumps(client.query(chain_q))
        q3_ms = (time.perf_counter() - t0) * 1e3
        if got3 != want:
            fail("chain", "JSON differs from the unsharded Executor")
        rows3 = json.loads(got3)["q"]
        ages = [r["age"] for r in rows3]
        if len(rows3) != 20 or ages != sorted(ages) or min(ages) < 50:
            fail("chain", f"not 20 rows sorted by age >= 50: {ages}")
        say("cluster_request", request="chain_remote_sort", ms=q3_ms,
            json_bytes=len(got3), serve_task=wire(before))

        # ---- 4. a mutation across both groups, read back ------------------
        u = int(seeds[0])
        row = indices[indptr[int(np.searchsorted(subjects, u))]:
                      indptr[int(np.searchsorted(subjects, u)) + 1]]
        v = next(int(x) for x in np.sort(seeds) if x != u and x not in row)
        new_age = (int(age[u - 1]) + 1) % 100
        read = "{ q(func: uid(%s)) { age friend @filter(uid(%s)) { uid } } }" \
            % (hex(u), hex(v))
        want4 = {"q": [{"age": new_age, "friend": [{"uid": hex(v)}]}]}
        before = loads()
        t0 = time.perf_counter()
        client.mutate(set_nquads='<%s> <friend> <%s> .\n<%s> <age> '
                                 '"%d"^^<xs:int> .' % (hex(u), hex(v),
                                                       hex(u), new_age))
        commit_ms = (time.perf_counter() - t0) * 1e3
        reads = 0
        while True:
            cold()
            reads += 1
            if client.query(read) == want4:
                break
            if time.perf_counter() - t0 > 60:
                fail("commit", "the write is not visible after 60 s")
        visible_ms = (time.perf_counter() - t0) * 1e3
        metrics = {}
        for name, reg in [(f"worker_{g}", srv.dgt_svc.metrics)
                          for g, srv in enumerate(servers)] + [
                              ("client", client.metrics)]:
            c = reg.export()["counters"]
            metrics[name] = {k: v for k, v in sorted(c.items())
                             if k.startswith(("dgraph_replica_",
                                              "dgraph_batch_"))}
        say("cluster_commit", cluster_commit_ms=commit_ms,
            cluster_commit_to_visible_ms=visible_ms, reads=reads,
            serve_task=wire(before),
            metrics=metrics, seconds_a=time.perf_counter() - t_phase)
    finally:
        if client is not None:
            client.close()
        for srv in servers:
            srv.stop(0)
        zsrv.stop(0)
        del g0, g1
        torch.cuda.empty_cache()

    return launches


def cluster_cli(procs, zport, nquads, queries, expected) -> None:
    """Phase 14 (b): `zero --groups 2` and two `worker --device cuda`
    processes (procs, started by cluster_phase): the golden battery loaded
    through ClusterClient.mutate, every query equal to expected.json, the
    tablets on both groups."""
    from dgraph_tpu_torch.parallel.client import ClusterClient

    def fail(what, msg):
        raise SystemExit(f"cluster {what}: {msg}")

    t_b = time.perf_counter()
    zero_s = procs[0].banner()[2]
    banners = [p.banner() for p in procs[1:]]
    if not all("device=cuda" in b[1] for b in banners):
        fail("cli", f"a worker is not on the card: {banners}")
    client = ClusterClient(
        f"127.0.0.1:{zport}",
        {g: [f"127.0.0.1:{b[0]}"] for g, b in enumerate(banners)},
        default_timeout_ms=120_000)
    try:
        t0 = time.perf_counter()
        client.mutate(set_nquads=nquads)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name, text in queries:
            if client.query(text) != expected[name]:
                fail("golden", f"{name} differs from expected.json")
        golden_s = time.perf_counter() - t0
        spread = sorted(set(client.zero.tablets().values()))
        if spread != [0, 1]:
            fail("cli", f"tablets on groups {spread}")
    finally:
        client.close()
    # the JAX ClusterClient answers every golden query (tests/
    # test_torch_cluster_cli.py holds both clients to expected.json)
    say("cluster_cli", queries=len(queries), left_out=[],
        zero_start_seconds=zero_s,
        worker_start_seconds=[b[2] for b in banners],
        load_seconds=load_s, golden_seconds=golden_s,
        seconds=time.perf_counter() - t_b)


def device_profile(run) -> dict:
    """One run under torch.profiler, CUDA events around it: wall ms, the
    events' ms, summed device-activity ms (the device's busy time; idle
    share = 1 - busy / wall) and the top kernels. Only the device's own
    rows (kernels, copies, memsets) are summed: an operator row (aten::mm,
    aten::topk) carries the time of the kernels it launched as its self
    device time, so summing it too counts them twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()        # every stream, not just b's
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, dtoh = [], 0
    for e in prof.key_averages():
        if "DtoH" in e.key:
            dtoh += e.count         # device-to-host copies: the host syncs
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "event_ms": a.elapsed_time(b),
            "device_busy_ms": busy, "dtoh_copies": dtoh,
            "device_idle_share": 1 - busy / wall_ms if wall_ms else None,
            "top": [{"name": k[:60], "ms": ms, "calls": n}
                    for ms, k, n in rows[:8]]}


def profile_query(run) -> dict:
    """device_profile of one run, then where the host's share goes: one
    more run under cProfile, by self time."""
    import torch

    out = device_profile(run)
    cp = cProfile.Profile()
    cp.enable()
    run()
    torch.cuda.synchronize()
    cp.disable()
    host = sorted(((tt * 1e3, f"{Path(fn).name}:{line}({name})", nc)
                   for (fn, line, name), (_cc, nc, tt, _ct, _callers)
                   in pstats.Stats(cp).stats.items()), reverse=True)
    return {**out, "host_top": [{"name": k[:60], "self_ms": ms, "calls": n}
                                for ms, k, n in host[:10]],
            "torch": torch.__version__}


if __name__ == "__main__":
    sys.exit(main())
