"""The control of `correct`: the plain reference put in the program's place
with one of the configuration's guarantees broken, judged like a run.

    python3 -m graphbench.control --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--requests <n>]

The guarantee broken is the snapshot read's: a read at read_ts sees every
write committed before it. The control answers from a stale snapshot that
misses STALE_SHARE of the writes: that share of the edges of every uid
predicate, and that share of the value cells, which keep another uid's
value. It makes the window's requests from each seed as a run does (an open
loop's rate x seconds of them, a closed loop's --requests), answers each
from the stale snapshot, and judges each answer with the sound reference.
The benchmark's own runs never run it; its readings set the upper end of
each limit in run.LIMITS.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

STALE_SHARE = 0.01


def stale(data: dict, seed: int) -> dict:
    """A copy of `data` as a stale snapshot sees it."""
    import torch

    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed) + 1)
    out = dict(data)
    out["edges"] = {}
    for attr, (src, dst) in data["edges"].items():
        keep = torch.rand(src.numel(), generator=g) >= STALE_SHARE
        keep = keep.to(src.device)
        out["edges"][attr] = (src[keep], dst[keep])
    out["values"] = {}
    for attr, column in data["values"].items():
        n = len(column)
        hit = (torch.rand(n, generator=g) < STALE_SHARE).nonzero().flatten()
        other = torch.randint(0, n, (hit.numel(),), generator=g)
        col = list(column)
        for i, j in zip(hit.tolist(), other.tolist()):
            col[i] = column[j]
        out["values"][attr] = col
    return out


def control_run(cell, seed: int, seconds: float, requests: int,
                device: str) -> dict:
    from graphbench import loadgen, spec
    from graphbench.reference.dataset import Reference
    from graphbench.run import host_data, to_device

    t0 = time.perf_counter()
    data = host_data(spec.plugin("datagen", cell.config["generator"])
                     .generate(cell.config, seed, device))
    mix = loadgen.Mix(cell.traffic, data)
    rng = np.random.default_rng([seed, 1])
    if cell.traffic["loop"] == "open":
        count = len(loadgen.arrivals(float(cell.traffic["rate"]), seconds,
                                     np.random.default_rng([seed, 3])))
    else:
        count = requests
    reqs = mix.requests(count, rng)
    bad = Reference(to_device(stale(data, seed), device))
    ref = Reference(to_device(data, device))
    wrong = sum(not mix.judge(ref, r, mix.answer(bad, r)[0])[0]
                for r in reqs)
    return {"workload": cell.name, "seed": seed, "requests": len(reqs),
            "wrong_answers": wrong, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m graphbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--requests", type=int, default=200)
    args = ap.parse_args(argv)
    import torch

    from graphbench import spec

    if not torch.cuda.is_available():
        print("graphbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(control_run(cell, int(s), args.seconds,
                                     args.requests, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
