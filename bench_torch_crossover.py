#!/usr/bin/env python3
"""Where dgraph_tpu_torch's device paths start to beat its host mirror.

    python3 bench_torch_crossover.py      # needs one CUDA card

Two path choices in the port are made by edge count. Both pick a path and
never an answer; this script times each side of them on the card:

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
JSON_MAX_SCALE = 12          # whole-request JSON above this grows past ~10 MB
EDGE_FACTOR, SEED = 16, 7
EXPAND_NEEDS = tuple(1 << k for k in range(8, 23, 2))
REPS = 5


def band(ms: list[float]) -> dict:
    s = sorted(ms)
    return {"min": s[0], "median": s[len(s) // 2], "max": s[-1]}


def timed(fn, sync) -> tuple[object, dict]:
    out = fn()
    sync()
    ms = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, band(ms)


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
    from dgraph_tpu_torch.query import task
    from dgraph_tpu_torch.utils.schema import SchemaState, parse_schema
    from dgraph_tpu_torch.utils.types import TypeID

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0], flush=True)
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

    # ---- 1. @recurse: kernels vs host mirror, by CSR size -------------------
    for scale in SCALES:
        subjects, indptr, indices = rmat_csr(scale, EDGE_FACTOR, seed=SEED)
        seeds = np.unique(np.random.default_rng(3).choice(
            subjects, size=min(128, len(subjects)), replace=False))
        snap = carry.snapshot_from_numpy(
            {"friend": (int(TypeID.UID), subjects, indptr, indices)}, 1,
            device=dev)
        text = "{ q(func: uid(%s)) @recurse(depth: 3) { friend } }" % \
            ", ".join(hex(int(u)) for u in seeds)
        req = dql.parse(text)

        def block():
            sg = eng.SubGraph(gq=req.queries[0], attr=req.queries[0].attr)
            eng.Executor(snap, schema)._process_block(sg)
            return sg

        def request():
            return json.dumps(eng.Executor(snap, schema).execute(req))

        pb.pull_graph_for(snap.pred("friend").csr)      # prep once, untimed
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
