"""Find an open-loop cell's knee: one set-up, then rates stepped upward,
each held for --step-seconds, on the cell's own traffic mix.

    python3 -m graphbench.sweep --workload <cell> --seed <n> \
        --rates 5,10,20,40 --step-seconds 15

One JSON line per rate: requests/s completed in the step, p50 and p95
latency from when each request was due, how late the requests started
(p95, from due to sent: the backlog waiting for a client), the backlog at
the step's end (due, not yet answered) and the failures. The knee is the
highest rate whose backlog does not grow over its step. The chosen rate
goes into the traffic mix's file as a number; no benchmark run sweeps.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def step(p, cell, rate: float, seconds: float, grace_s: float, rng) -> dict:
    """One step of the sweep on a prepared cell `p` (run.Prepared)."""
    from graphbench import loadgen

    due = loadgen.arrivals(rate, seconds, rng)
    recs, late = loadgen.open_loop(p.call, p.mix.requests(len(due), rng),
                                   due, int(cell.traffic["clients"]),
                                   seconds, grace_s)
    lat = sorted(((r.done - r.due) if r.resp is not None
                  else seconds + grace_s - r.due) * 1e3 for r in recs)
    started = sorted((r.sent - r.due) * 1e3 for r in recs
                     if r.sent is not None)
    return {
        "rate": rate, "requests": len(recs),
        "completed_per_s": sum(r.resp is not None and r.done <= seconds
                               for r in recs) / seconds,
        "p50_ms": loadgen.percentile(lat, 50),
        "p95_ms": loadgen.percentile(lat, 95),
        "generator_late_p95_ms": loadgen.percentile(sorted(late), 95) * 1e3,
        "start_late_p95_ms": loadgen.percentile(started, 95)
        if started else None,
        "backlog_at_end": sum(r.done is None or r.done > seconds
                              for r in recs),
        "failed": sum(r.resp is None for r in recs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m graphbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--step-seconds", type=float, default=15.0)
    ap.add_argument("--grace-seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    import torch

    from graphbench import spec
    from graphbench.run import Prepared

    if not torch.cuda.is_available():
        print("graphbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    p = Prepared(cell, args.seed, "cuda")
    print(json.dumps({"workload": cell.name, "setup": p.setup}), flush=True)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        rng = np.random.default_rng([args.seed, 10 + i])
        print(json.dumps(step(p, cell, rate, args.step_seconds,
                              args.grace_seconds, rng)), flush=True)
    p.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
