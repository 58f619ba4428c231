#!/usr/bin/env python3
"""Where dgraph_tpu_torch's device paths start to beat its host mirror.

    python3 bench_torch_crossover.py              # all sections
    python3 bench_torch_crossover.py groupby      # section 4 alone
    python3 bench_torch_crossover.py unique       # section 5 alone
    python3 bench_torch_crossover.py sets         # section 6 alone

Eight path choices in the port are made by size. Each picks a path and
never an answer's value; this script times each side of them on the card
and its host (needs one CUDA card):

  1. recurse._kernel_min: a CSR of at least that many edges runs @recurse
     on the active-prefix kernels, a smaller one on the host mirror. For
     R-MAT graphs of scales 10..20 (edge factor 16, seed 7; 128 seeds from
     default_rng(3), as bench.py), `@recurse(depth: 3) { friend }` runs
     through the Executor with the kernels forced on and forced off: the
     block alone (dest uids, as the headline rate counts it) at every
     scale, and the whole request to JSON where the JSON stays small.
     Every level's dest uids, and the JSON, must agree between the paths.
  2. task.HOST_EXPAND_MAX: a one-hop expand whose degree sum is at most
     that runs as a host gather, a larger one as a device gather. On the
     scale-20 graph, _expand_csr runs both ways for frontiers whose degree
     sums span 2^8..2^22; the uid matrices must agree.
  3. shortest.DEVICE_SSSP_MIN_EDGES and shortest.SSSP_KERNEL_MIN: a
     single-predicate unweighted `shortest` over a CSR of at least the first
     runs on the device, on the kernel tier (bfs_dist over K1/K2) from the
     second and on the Bellman-Ford tier (traversal.sssp) below it; a
     smaller CSR runs on the host tier (level adjacency, then Dijkstra). For
     the same R-MAT graphs and two smaller ones (scales 6 and 8),
     `shortest(from: seeds[0], to: dst_far)` (dst_far the lowest uid at the
     largest host-BFS distance) runs through Executor.execute on each tier,
     the host tier until the first scale where one run passes
     HOST_SHORTEST_MAX_S. Every tier's `_weight_` must
     equal the host-BFS distance (on ties the tiers may pick different
     paths of that length).
  4. groupby._HOST_AGG_MAX and segments._RANK_DEVICE_MIN: a @groupby whose
     aggregated members pass the first reduces on the device
     (segments.fused_group_reduce), a smaller one on the host (numpy
     ufunc.at over host segment ids, as groupby._batch_aggregates does);
     a uid-key groupby with at least the second many edges ranks them in
     the key table on the device (segments.rank_in_table), fewer with
     numpy's searchsorted. Members 2^12..2^22 over 100 and 10,000 groups
     (integer values, the f32 rule holding), and lookups 2^12..2^22 into
     tables of 2^10..2^20 sorted uids, run both ways; the results must
     agree exactly.
  5. engine._unique_uids: the known-uid set of a snapshot (engine.
     _known_uids, merged once per snapshot that answers a uid(...) root)
     is one scatter into a bitmap where the uids are dense (the largest
     below UNIQUE_BITMAP_SPREAD times their count), np.unique (the JAX
     package's code) elsewhere.
     Host work on the card's host: both run on the uids that the scale-20
     snapshot of chip_smoke.py phases 8 and 9 hands _known_uids (`friend`
     and `~friend` subjects and objects, `age` subjects), and on 2^22
     uids drawn below 1/16..64 times their count; the results must agree.
  6. uidset.HOST_CUTOVER: the engine's set combines (intersect_host,
     union_host, difference_host) run as numpy below it and as int64 torch
     ops on the card from it (min(len(a), len(b))). Pairs of sorted-unique
     int64 uid arrays, the smaller of SET_SIZES (2^10..2^22) uids and the
     larger 1 or 16 times that, each drawn below 4 times the larger size
     (default_rng(29)), run all three combines both ways: numpy, and the
     device path with its host-to-device and device-to-host copies (the
     engine hands numpy in and takes numpy out). The results must be
     equal. A last line names the smallest power of two from which the
     device path wins all three ops at every larger size measured, both
     ratios (above the largest size when it wins at none).

Each line of output is one JSON object; times are host-clock milliseconds
(torch.cuda.synchronize before each reading), the median and band of REPS
runs after one warm run.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SCALES = (10, 12, 14, 16, 18, 20)
SHORTEST_SCALES = (6, 8) + SCALES
JSON_MAX_SCALE = 12          # whole-request JSON above this grows past ~10 MB
EDGE_FACTOR, SEED = 16, 7
EXPAND_NEEDS = tuple(1 << k for k in range(8, 23, 2))
REPS = 5
SET_SIZES = tuple(1 << k for k in range(10, 23))
SET_RATIOS = (1, 16)
SET_REPS = 3                 # section 6: samples after the warm run
SET_SLOW_MS = 1000.0         # a call slower than this is timed once
HOST_SHORTEST_MAX_S = 20.0   # the host tier stops after a scale past this


def band(ms: list[float]) -> dict:
    s = sorted(ms)
    return {"min": s[0], "median": s[len(s) // 2], "max": s[-1]}


def timed(fn, sync, reps=REPS, slow_ms=None) -> tuple[object, dict]:
    """The warm run, then `reps` timed runs; with slow_ms, a warm run
    slower than that is the one sample (numpy's set ops on 2^26 uids take
    tens of seconds on the card's host)."""
    t0 = time.perf_counter()
    out = fn()
    sync()
    first = (time.perf_counter() - t0) * 1e3
    if slow_ms is not None and first > slow_ms:
        return out, band([first])
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, band(ms)


def groupby_section(dev, sync) -> None:
    """Section 4: the two path choices of @groupby, host vs device."""
    from dgraph_tpu_torch.ops import segments as segs
    from dgraph_tpu_torch.query import groupby as gb

    rng = np.random.default_rng(19)
    for groups in (100, 10_000):
        for k in range(12, 23, 2):
            n = 1 << k
            lens = np.bincount(rng.integers(0, groups, n), minlength=groups)
            vals = rng.integers(0, 100, n).astype(np.float64)
            vals[rng.random(n) < 0.1] = np.nan

            def host():
                seg = np.repeat(np.arange(groups, dtype=np.int32), lens)
                hit = ~np.isnan(vals)
                return gb._host_segment_reduce("sum", seg[hit], vals[hit],
                                               groups)

            def device():
                return segs.fused_group_reduce(
                    ("sum",), vals.astype(np.float32), lens, groups,
                    device=dev)["sum"]

            line = {"phase": "fused_group_reduce", "members": n,
                    "groups": groups}
            want, line["host_ms"] = timed(host, sync)
            got, line["device_ms"] = timed(device, sync)
            if not np.array_equal(got, want, equal_nan=True):
                raise SystemExit(f"fused_group_reduce {n}/{groups}: the "
                                 f"routes differ")
            print(json.dumps(line), flush=True)
    keep = segs._RANK_DEVICE_MIN
    for t in range(10, 21, 2):
        table = np.unique(rng.integers(1, 1 << 30, 1 << t))
        for k in range(12, 23, 2):
            values = table[rng.integers(0, len(table), 1 << k)]
            values[::7] += 1                   # some lookups miss
            line = {"phase": "rank_in_table", "lookups": 1 << k,
                    "table": int(len(table))}
            got = {}
            for path, cut in (("host", 1 << 62), ("device", 0)):
                segs._RANK_DEVICE_MIN = cut
                try:
                    got[path], line[f"{path}_ms"] = timed(
                        lambda: segs.rank_in_table(table, values,
                                                   device=dev), sync)
                finally:
                    segs._RANK_DEVICE_MIN = keep
            if not all(np.array_equal(a, b) for a, b in
                       zip(got["host"], got["device"])):
                raise SystemExit(f"rank_in_table {1 << k}/{1 << t}: the "
                                 f"routes differ")
            print(json.dumps(line), flush=True)


def unique_section() -> None:
    """Section 5: the known-uid merge, bitmap vs np.unique (host only)."""
    from dgraph_tpu_torch.models.rmat import rmat_csr
    from dgraph_tpu_torch.query import engine as eng

    subjects, indptr, indices = rmat_csr(20, EDGE_FACTOR, seed=SEED)
    cases = {"headline": np.concatenate([
        subjects, indices,                               # friend
        np.unique(indices), np.repeat(subjects, np.diff(indptr)),  # ~friend
        np.arange(1, (1 << 20) + 1, dtype=np.int64)])}   # age
    rng = np.random.default_rng(23)
    for spread in (1 / 16, 1 / 4, 1, 2, 4, 8, 16, 64):
        cases[f"spread_{spread:g}"] = rng.integers(
            0, int(spread * (1 << 22)), 1 << 22).astype(np.int64)
    for label, uids in cases.items():
        line = {"phase": "unique_uids", "case": label, "n": int(len(uids)),
                "max_over_n": float(uids.max() / len(uids)),
                "bitmap": bool(uids.max() < eng.UNIQUE_BITMAP_SPREAD
                               * len(uids))}
        want, line["np_unique_ms"] = timed(lambda: np.unique(uids),
                                           lambda: None)
        got, line["unique_uids_ms"] = timed(lambda: eng._unique_uids(uids),
                                            lambda: None)
        if not np.array_equal(got, want):
            raise SystemExit(f"unique_uids {label}: the paths differ")
        line["distinct"] = int(len(want))
        print(json.dumps(line), flush=True)


def sorted_uids(rng, n: int, hi: int) -> np.ndarray:
    """n distinct int64 uids below hi, sorted, drawn uniformly: each uid
    kept with a probability a little above n / hi, the surplus dropped at
    random (no np.unique: it is hash-based and slow on the card's host)."""
    p = min(1.0, (n + 4 * np.sqrt(n) + 16) / hi)
    while True:
        u = np.flatnonzero(rng.random(hi, dtype=np.float32) < p)
        if len(u) >= n:
            return np.delete(u, rng.choice(len(u), len(u) - n,
                                           replace=False))


def sets_section(dev, sync, sizes=SET_SIZES) -> int:
    """Section 6: the engine's set combines, numpy vs the device path.
    Returns the measured cutover (a power of two)."""
    from dgraph_tpu_torch.ops import uidset as us

    rng = np.random.default_rng(29)
    keep = us.HOST_CUTOVER
    wins = {}                                   # (n, ratio) -> all 3 won
    for ratio in SET_RATIOS:
        for n in sizes:
            a = sorted_uids(rng, n, 4 * n * ratio)
            b = sorted_uids(rng, n * ratio, 4 * n * ratio)
            line = {"phase": "set_combine", "min_len": n, "ratio": ratio,
                    "len_b": int(len(b))}
            won = True
            for op, fn in (("intersect", us.intersect_host),
                           ("union", us.union_host),
                           ("difference", us.difference_host)):
                got = {}
                for path, cut in (("host", 1 << 62), ("device", 0)):
                    us.HOST_CUTOVER = cut
                    try:
                        got[path], line[f"{op}_{path}_ms"] = timed(
                            lambda: fn(a, b, dev), sync, SET_REPS,
                            SET_SLOW_MS)
                    finally:
                        us.HOST_CUTOVER = keep
                if not np.array_equal(got["host"], got["device"]):
                    raise SystemExit(f"{op} {n}:{n * ratio}: the paths "
                                     f"differ")
                line[f"{op}_out"] = int(len(got["host"]))
                won &= line[f"{op}_device_ms"]["median"] < \
                    line[f"{op}_host_ms"]["median"]
            wins[n, ratio] = won
            print(json.dumps(line), flush=True)
    cut = 2 * max(sizes)
    for n in sorted(sizes, reverse=True):
        if not all(wins[n, r] for r in SET_RATIOS):
            break
        cut = n
    print(json.dumps({"phase": "set_cutover", "host_cutover": cut,
                      "device_won_at_none": cut > max(sizes),
                      "in_use": keep}), flush=True)
    return cut


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_crossover: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2

    from dgraph_tpu_torch import carry
    from dgraph_tpu_torch.models.rmat import rmat_csr
    from dgraph_tpu_torch.ops import pull_bfs as pb
    from dgraph_tpu_torch.query import dql
    from dgraph_tpu_torch.query import engine as eng
    from dgraph_tpu_torch.query import recurse as rec
    from dgraph_tpu_torch.query import shortest as sh
    from dgraph_tpu_torch.query import task
    from dgraph_tpu_torch.utils.schema import SchemaState, parse_schema
    from dgraph_tpu_torch.utils.types import TypeID

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0], flush=True)
    if sys.argv[1:] == ["groupby"]:
        groupby_section(dev, sync)
        return 0
    if sys.argv[1:] == ["unique"]:
        unique_section()
        return 0
    if sys.argv[1:] == ["sets"]:
        sets_section(dev, sync)
        return 0
    schema = SchemaState()
    for e in parse_schema("friend: [uid] ."):
        schema.set(e)
    eng.set_query_edge_limit(1 << 31)

    def levels(sg) -> list[np.ndarray]:
        out, node = [], sg
        while node.children:
            node = node.children[0]
            out.append(node.dest_uids)
        return out

    def load(scale):
        """(subjects, indptr, indices, seeds, snapshot) of one R-MAT graph,
        its pull graph prepared (once, untimed)."""
        subjects, indptr, indices = rmat_csr(scale, EDGE_FACTOR, seed=SEED)
        seeds = np.unique(np.random.default_rng(3).choice(
            subjects, size=min(128, len(subjects)), replace=False))
        snap = carry.snapshot_from_numpy(
            {"friend": (int(TypeID.UID), subjects, indptr, indices)}, 1,
            device=dev)
        pb.pull_graph_for(snap.pred("friend").csr)
        return subjects, indptr, indices, seeds, snap

    # ---- 1. @recurse: kernels vs host mirror, by CSR size -------------------
    graphs = {}
    for scale in SCALES:
        graphs[scale] = load(scale)
        subjects, indptr, indices, seeds, snap = graphs[scale]
        text = "{ q(func: uid(%s)) @recurse(depth: 3) { friend } }" % \
            ", ".join(hex(int(u)) for u in seeds)
        req = dql.parse(text)

        def block():
            sg = eng.SubGraph(gq=req.queries[0], attr=req.queries[0].attr)
            eng.Executor(snap, schema)._process_block(sg)
            return sg

        def request():
            return json.dumps(eng.Executor(snap, schema).execute(req))

        line = {"phase": "recurse3", "scale": scale,
                "edges": int(len(indices))}
        got = {}
        for path, kmin in (("kernel", 0), ("host", 1 << 62)):
            rec.KERNEL_MIN_EDGES = kmin
            try:
                sg, line[f"{path}_block_ms"] = timed(block, sync)
                got[path] = levels(sg)
                if scale <= JSON_MAX_SCALE:
                    got[path + "_json"], line[f"{path}_json_ms"] = \
                        timed(request, sync)
            finally:
                rec.KERNEL_MIN_EDGES = None
        if len(got["kernel"]) != len(got["host"]) or not all(
                np.array_equal(k, h)
                for k, h in zip(got["kernel"], got["host"])):
            raise SystemExit(f"scale {scale}: recurse levels differ")
        if scale <= JSON_MAX_SCALE:
            if got["kernel_json"] != got["host_json"]:
                raise SystemExit(f"scale {scale}: JSON differs")
            line["json_bytes"] = len(got["host_json"])
        line["traversed_levels"] = [int(len(x)) for x in got["host"]]
        print(json.dumps(line), flush=True)

    # ---- 2. one-hop expand: device gather vs host gather, by degree sum ----
    csr = snap.pred("friend").csr            # the scale-20 graph from above
    deg = np.diff(indptr)
    order = np.random.default_rng(5).permutation(len(subjects))
    cum = np.cumsum(deg[order])
    for need in EXPAND_NEEDS:
        k = int(np.searchsorted(cum, need)) + 1
        uids = np.sort(subjects[order[:k]]).astype(np.int64)
        line = {"phase": "expand", "need": int(cum[k - 1]),
                "frontier": int(k)}
        got = {}
        for path, cut in (("device", -1), ("host", 1 << 62)):
            keep = task.HOST_EXPAND_MAX
            task.HOST_EXPAND_MAX = cut
            try:
                (matrix, total), line[f"{path}_ms"] = timed(
                    lambda: task._expand_csr(csr, uids), sync)
            finally:
                task.HOST_EXPAND_MAX = keep
            got[path] = (np.concatenate(matrix), total)
        if got["device"][1] != got["host"][1] or not np.array_equal(
                got["device"][0], got["host"][0]):
            raise SystemExit(f"need {need}: expand matrices differ")
        print(json.dumps(line), flush=True)

    # ---- 3. shortest: kernel, Bellman-Ford and host tiers, by CSR size -----
    from chip_smoke import host_bfs_dist

    host_tier = True
    for scale in SHORTEST_SCALES:
        subjects, indptr, indices, seeds, snap = graphs.get(scale) or \
            load(scale)
        src = int(seeds[0])
        hd = host_bfs_dist(subjects, indptr, indices, src,
                           int(max(subjects.max(), indices.max())) + 1)
        far = int(np.flatnonzero(hd == hd.max())[0])
        req = dql.parse("{ shortest(from: %s, to: %s) { friend } }"
                        % (hex(src), hex(far)))
        line = {"phase": "shortest", "scale": scale,
                "edges": int(len(indices)), "hops": int(hd[far])}

        def run():
            return eng.Executor(snap, schema).execute(req)

        for tier, dmin, kmin in (("kernel", 0, 0), ("sssp", 0, 1 << 62),
                                 ("host", 1 << 62, None)):
            if tier == "host" and not host_tier:
                continue
            sh.DEVICE_SSSP_MIN_EDGES, sh.SSSP_KERNEL_MIN = dmin, kmin
            try:
                if tier != "host":
                    out, line[f"{tier}_ms"] = timed(run, sync)
                else:
                    # the first run is the warm one; then samples while the
                    # tier's time stays under the limit
                    ms = []
                    while len(ms) < REPS + 1 and \
                            sum(ms) < HOST_SHORTEST_MAX_S * 1e3:
                        t0 = time.perf_counter()
                        out = run()
                        sync()
                        ms.append((time.perf_counter() - t0) * 1e3)
                    line["host_ms"] = band(ms[1:] or ms)
                    line["host_runs"] = len(ms)
                    host_tier = ms[0] <= HOST_SHORTEST_MAX_S * 1e3
            finally:
                sh.DEVICE_SSSP_MIN_EDGES = sh.SSSP_KERNEL_MIN = None
            weight = out["_path_"][0]["_weight_"]
            if weight != float(hd[far]):
                raise SystemExit(f"scale {scale}: {tier} tier _weight_ "
                                 f"{weight} != host BFS {hd[far]}")
        print(json.dumps(line), flush=True)

    # ---- 4. @groupby: device reduce and rank search vs the host ------------
    groupby_section(dev, sync)

    # ---- 5. the known-uid merge: bitmap vs np.unique, by density ----------
    unique_section()

    # ---- 6. the set combines: numpy vs the device path, by size ----------
    sets_section(dev, sync)
    return 0


if __name__ == "__main__":
    sys.exit(main())
