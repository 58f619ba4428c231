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
  6. prints the card line, a {"kernels": [...]} line and the final
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


def band(samples):
    s = sorted(samples)
    return {"min": s[0], "median": s[len(s) // 2], "max": s[-1]}


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
    from dgraph_tpu_torch.query import task as task
    from dgraph_tpu_torch.storage.csr_build import transpose_csr
    from dgraph_tpu_torch.utils.schema import SchemaState, parse_schema
    from dgraph_tpu_torch.utils.types import TypeID

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
            expand_max = task.HOST_EXPAND_MAX
            rec.KERNEL_MIN_EDGES = task.HOST_EXPAND_MAX = 1 << 62
            try:
                host = execute(text)
            finally:
                rec.KERNEL_MIN_EDGES, task.HOST_EXPAND_MAX = None, expand_max
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

    # ---- 6. summary lines --------------------------------------------------
    kern_line = {"kernels": [
        {k: v for k, v in kernels[n].items() if k not in ("e_pad", "stream")}
        for n in ("active_prefix", "active_prefix_sparse")]}
    print(card)
    print(json.dumps(kern_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    rows = []
    for e in prof.key_averages():
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms if wall_ms else None,
            "top": [{"name": k[:60], "ms": ms, "calls": n}
                    for ms, k, n in rows[:8]],
            "host_top": [{"name": k[:60], "self_ms": ms, "calls": n}
                         for ms, k, n in host[:10]],
            "torch": torch.__version__}


if __name__ == "__main__":
    sys.exit(main())
