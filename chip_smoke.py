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
     and val/math/aggregates over value variables. Each one's JSON is
     byte-identical between the default path and the host path, and held to
     numpy over the same data; the device union (ops/csr.expand_dest) must
     run for the two index roots and K1 or K2 for the recurse; each request
     is timed (p50, min..max of 5 runs) and two are profiled;
  8. loads the headline graph (with its REVERSE keys) and `age` on every
     node id into the port's Store (posting lists packed by the native
     codec, Store.bulk_install), folds it eagerly (held to the input
     arrays), runs phase 4's @recurse over a SnapshotAssembler's lazy
     folds (levels equal to phase 4's, K1 and K2 launched), commits a
     seeded write program of 64 transactions (one more aborted) through
     rdf -> mutation -> Store.commit with a one-uid probe after each
     (commit-to-visible ms; every commit stamped as a delta overlay over
     base tensors that keep their device pointers), then over the last
     overlay snapshot the one-hop expand (ops/csr.expand_masked on the
     card), the @recurse (K1/K2 over the merged CSR) and an index root
     (the device union over the merged index), each equal to the host path
     or to numpy after the same edits, and finally compacts the overlays
     (a from-scratch fold of each predicate at the last commit): the
     stamped CSRs and values equal the fold's and every request gives the
     same JSON over it;
  9. prints the card line, a {"kernels": [...]} line and the final
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
# phase 7: value predicates on every node id, names from a 64-word
# vocabulary (three words each: one word's term row holds ~47k uids)
VALUES_SCHEMA = """
age: int @index(int) .
score: float @index(float) .
name: string @index(exact, term) .
"""
VOCAB = tuple(f"w{chr(97 + i // 8)}{chr(97 + i % 8)}" for i in range(64))
# phase 8: the headline graph and age in the port's Store, then a seeded
# program of COMMITS transactions over a pool of COMMIT_POOL subjects
STORE_SCHEMA = "friend: [uid] @reverse .\nage: int @index(int) ."
COMMITS, COMMIT_POOL = 64, 32
# the overlay expand adds the largest rows to the seeds until the base side
# alone passes this many edges (past task.HOST_EXPAND_MAX: the device gather)
EXPAND_EDGES = 300_000


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


def band(samples):
    s = sorted(samples)
    return {"min": s[0], "median": s[len(s) // 2], "max": s[-1]}


def on_host(fn):
    """fn() with every expand, union and recurse level on the host
    mirrors (the reference each request's default path is held to)."""
    from dgraph_tpu_torch.query import recurse as rec
    from dgraph_tpu_torch.query import task

    kept = rec.KERNEL_MIN_EDGES, task.HOST_EXPAND_MAX
    rec.KERNEL_MIN_EDGES = task.HOST_EXPAND_MAX = 1 << 62
    try:
        return fn()
    finally:
        rec.KERNEL_MIN_EDGES, task.HOST_EXPAND_MAX = kept


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

    def timed(fn, calls=20, reps=5, warm=3):
        """Median over `reps` runs of CUDA-event ms per call, each run
        `calls` calls back to back, so the device's time and not the host's
        enqueue is read. calls=1 times one call with the device idle before
        it: the host's launch overhead included."""
        for _ in range(warm):
            fn()
        sync()
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
    short_launches = shortest_phase(snap, schema, (subjects, indptr, indices),
                                    (rsub, rptr, ridx), int(seeds[0]),
                                    num_nodes, dev)
    for name, n in short_launches.items():
        kernels[name]["launches_shortest"] = n
    say("shortest_phase", seconds=time.perf_counter() - t0,
        script_seconds=time.perf_counter() - t_start)

    # ---- 7. value predicates, index roots, filters, order, aggregates ------
    t0 = time.perf_counter()
    value_launches = values_phase(snap, schema, (subjects, indptr, indices),
                                  seeds, dev)
    for name, n in value_launches.items():
        kernels[name]["launches_values"] = n
    say("values_phase", seconds=time.perf_counter() - t0,
        script_seconds=time.perf_counter() - t_start)

    # ---- 8. the Store, commits and overlays ---------------------------------
    t0 = time.perf_counter()
    storage_launches = storage_phase(
        snap, schema, (subjects, indptr, indices), (rsub, rptr, ridx), seeds,
        expand_seeds, shapes["loop_recurse"][0].replace(", loop: true", ""),
        1 << SCALE, dev)
    for name, n in storage_launches.items():
        kernels[name]["launches_storage"] = n
    say("storage_phase", seconds=time.perf_counter() - t0,
        script_seconds=time.perf_counter() - t_start)

    # ---- 9. summary lines --------------------------------------------------
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
    return launches


def values_phase(snap, schema, csr, seeds, dev) -> dict:
    """Phase 7 on the headline snapshot: adds age, score and name on every
    node id and runs the six value requests. Returns the K1/K2 launches of
    the requests' default-path runs."""
    import torch

    from dgraph_tpu_torch.ops import csr as csrops
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
             "recurse_values", "val_agg"]
    for name in order:
        if name not in hosts:
            hosts[name] = host_json(texts[name])

    # the default path: one checked run of each, its launches and unions
    outs, stats = {}, {}
    px.reset_launches()
    for name in order:
        before = (dict(px.LAUNCHES), csrops.UNIONS["cuda"])
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
            "device_unions": csrops.UNIONS["cuda"] - before[1]}
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

    # timing: 5 runs after the checked one; profiles of two requests
    for name in order:
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            execute(texts[name])
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        line = dict(stats[name], ms=band(ms), query=texts[name][:120])
        if name in ("expand_filter", "terms_order"):
            line["profile"] = profile_query(lambda: execute(texts[name]))
        say("value_request", request=name, **line)
    return launches



def storage_phase(snap4, schema4, csr, rev, seeds, expand_seeds, json_recurse,
                  n_ids, dev) -> dict:
    """Phase 8: the headline graph (with its REVERSE keys) and `age` on
    every node id loaded into the port's Store through bulk_install, folded,
    read through a SnapshotAssembler, written to by a seeded program of
    COMMITS transactions (one more aborted) and read again through the
    delta overlays, then compacted. snap4/schema4 are phase 4's carried
    snapshot (with phase 7's `age`, the same data); json_recurse is a
    one-uid @recurse(depth: 3) whose JSON fits JSON_MAX_BYTES. Returns the
    K1/K2 launches of the two counted 128-seed @recurse runs."""
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
    from dgraph_tpu_torch.storage.postings import (
        VALUE_UID, Op, Posting, PostingList)
    from dgraph_tpu_torch.storage.store import Store
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
    store = Store()
    for e in parse_schema(STORE_SCHEMA):
        store.set_schema(e)
    schema = store.schema

    def keys_of(make, attr, uids):
        """Encoded keys of one kind for many uids: the key's head once and
        the uid as 8 big-endian bytes (checked against keys.py)."""
        head = make(attr, 0).encode()[:-8]
        raw = np.asarray(uids, dtype=">u8").tobytes()
        out = [head + raw[i: i + 8] for i in range(0, len(raw), 8)]
        if out and out[-1] != make(attr, int(uids[-1])).encode():
            fail("load", "key layout differs from storage/keys.py")
        return out

    load = {}
    t0 = time.perf_counter()
    keys = keys_of(K.data_key, "friend", subjects)
    rows = np.split(indices.astype(np.uint64), indptr[1:-1])
    keys += keys_of(K.reverse_key, "friend", rsub)
    rows += np.split(ridx.astype(np.uint64), rptr[1:-1])
    load["friend_rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids = np.arange(1, n_ids + 1, dtype=np.int64)
    age = np.random.default_rng(11).integers(0, 100, n_ids)   # phase 7's
    akeys = keys_of(K.data_key, "age", ids)
    posts = {kb: {VALUE_UID: Posting(VALUE_UID, Op.SET, Val(TypeID.INT, a))}
             for kb, a in zip(akeys, age.tolist())}
    keys += akeys
    rows += [np.asarray([VALUE_UID], np.uint64)] * n_ids
    order = np.argsort(age, kind="stable")
    cuts = np.searchsorted(age[order], np.arange(101))
    entry = schema.get("age")
    for a in range(100):
        members = ids[order[cuts[a]: cuts[a + 1]]].astype(np.uint64)
        if len(members):
            for tk in index_tokens(entry, Val(TypeID.INT, a)):
                keys.append(K.index_key("age", tk).encode())
                rows.append(members)
    load["age_rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lists = {}
    for kb, pu in zip(keys, native.pack_many(rows)):
        pl = PostingList()
        pl.base_ts = 1
        pl.base_packed = pu
        pl.base_postings = posts.get(kb, {})
        lists[kb] = pl
    load["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store.bulk_install(lists, 1)
    load["install"] = time.perf_counter() - t0
    del keys, rows, posts, lists
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
    deg = np.diff(indptr)
    big = np.argsort(-deg, kind="stable")
    big = big[: int(np.searchsorted(np.cumsum(deg[big]), EXPAND_EDGES)) + 1]
    frontier = np.union1d(expand_seeds, subjects[big])
    ex_q = "{ q(func: uid(%s)) { uid friend { uid } } }" % ", ".join(
        hex(int(u)) for u in frontier)
    m0 = csrops.MASKED[dev.type]
    ex_json = execute(last, ex_q)
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
        json_bytes=len(ex_json), ms=p50(lambda: execute(last, ex_q)),
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
    ix_json = execute(last, ix_q)
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
        root_uids=int(len(want)), ms=p50(lambda: execute(last, ix_q)),
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
    say("storage_compact", compacted=done, seconds=compact_s,
        step_seconds=time.perf_counter() - t_step,
        phase_seconds=time.perf_counter() - t_phase)
    return {k: l_store[k] + l_ov[k] for k in l_store}


def profile_query(run) -> dict:
    """One run under torch.profiler: wall ms, summed device-kernel ms (the
    device's busy time; idle share = 1 - busy / wall) and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, dtoh = [], 0
    for e in prof.key_averages():
        if "DtoH" in e.key:
            dtoh += e.count         # device-to-host copies: the host syncs
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    # where the host's share goes: one more run under cProfile, by self time
    cp = cProfile.Profile()
    cp.enable()
    run()
    torch.cuda.synchronize()
    cp.disable()
    host = sorted(((tt * 1e3, f"{Path(fn).name}:{line}({name})", nc)
                   for (fn, line, name), (_cc, nc, tt, _ct, _callers)
                   in pstats.Stats(cp).stats.items()), reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "dtoh_copies": dtoh,
            "device_idle_share": 1 - busy / wall_ms if wall_ms else None,
            "top": [{"name": k[:60], "ms": ms, "calls": n}
                    for ms, k, n in rows[:8]],
            "host_top": [{"name": k[:60], "self_ms": ms, "calls": n}
                         for ms, k, n in host[:10]],
            "torch": torch.__version__}


if __name__ == "__main__":
    sys.exit(main())
