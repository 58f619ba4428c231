#!/usr/bin/env python3
"""Times the port's active-prefix kernels K1 and K2 against another checkout's.

    python3 bench_torch_prefix.py --against DIR     # needs one CUDA card

DIR is the root of another checkout of this repository (for example the
parent commit, unpacked with `git archive`). Its dgraph_tpu_torch/ops/prefix.py
is loaded on its own, under another module name, and builds its kernels from
its own csrc/ into DIR/build/. Both versions then run on the same inputs, at
the main path's shapes on the headline graph (R-MAT scale 20, edge factor 16,
seed 7): K1 on the dst-rank stream with a 10% frontier, K2 on the src-rank
stream with a 128-rank table. Every output is held to the plain version
exactly. The versions alternate, against/this/this/against, ROUNDS times.

Each is timed two ways with CUDA events, as chip_smoke.py phase 2 times them:
`one_call_ms`, the median over 20 calls each timed alone, the host's enqueue
included; and `back_to_back_ms`, the median over 5 runs of 20 calls back to
back, divided by 20. One JSON line per reading, then a summary line of the
medians per version and kernel.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SCALE, EDGE_FACTOR, SEED = 20, 16, 7
ROUNDS = 2


def load_prefix(root: Path):
    path = root / "dgraph_tpu_torch" / "ops" / "prefix.py"
    spec = importlib.util.spec_from_file_location("against_prefix", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="root of the checkout to compare with")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_prefix: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2

    from dgraph_tpu_torch.models.rmat import rmat_csr
    from dgraph_tpu_torch.ops import prefix as this
    from dgraph_tpu_torch.ops import pull_bfs as pb

    sync = torch.cuda.synchronize
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0], flush=True)
    versions = {"this": this, "against": load_prefix(args.against.resolve())}
    for mod in versions.values():
        mod.build()

    subjects, indptr, indices = rmat_csr(SCALE, EDGE_FACTOR, seed=SEED)
    g = pb.prep_pull(subjects, indptr, indices, 1 + (1 << SCALE) + 1,
                     device=dev)
    rng = np.random.default_rng(11)
    pick = np.zeros(len(subjects), dtype=bool)
    pick[rng.choice(len(subjects), 128, replace=False)] = True
    ftab = pb._frontier_table(torch.from_numpy(pick).to(dev))
    dense = torch.from_numpy(
        rng.random(int(g.in_subjects.numel())) < 0.10).to(dev)
    words = pb.pack_words(dense, g.chunks_d)
    calls = {
        "active_prefix": lambda m: m.active_prefix(words, g.in_src_pad_d,
                                                   g.chunks_d),
        "active_prefix_sparse": lambda m: m.active_prefix_sparse(
            ftab, g.in_src_pad),
    }
    want = {"active_prefix": this.active_prefix_ref(words, g.in_src_pad_d,
                                                    g.chunks_d),
            "active_prefix_sparse": this.active_prefix_sparse_ref(
                ftab, g.in_src_pad)}

    def timed(fn, n_calls, reps, warm=3):
        for _ in range(warm):
            fn()
        sync()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n_calls):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / n_calls)
        return float(np.median(ts))

    readings = {}
    for rnd in range(ROUNDS):
        for vname in ("against", "this", "this", "against"):
            mod = versions[vname]
            for kname, call in calls.items():
                fn = lambda: call(mod)
                if not torch.equal(fn(), want[kname]):
                    raise SystemExit(f"{vname} {kname} != plain version")
                line = {"round": rnd, "version": vname, "kernel": kname,
                        "one_call_ms": timed(fn, 1, 20),
                        "back_to_back_ms": timed(fn, 20, 5)}
                print(json.dumps(line), flush=True)
                readings.setdefault((vname, kname), []).append(line)
    print(json.dumps({"summary": [
        {"version": v, "kernel": k, "readings": len(ls),
         **{f: float(np.median([x[f] for x in ls]))
            for f in ("one_call_ms", "back_to_back_ms")}}
        for (v, k), ls in readings.items()]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
