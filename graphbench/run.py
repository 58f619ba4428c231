"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m graphbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the seed it makes the cell's data on the card, loads it into the
port's serving Node through the port's store, warms the cell's request
shapes, drives the window (closed or open loop, graphbench/loadgen.py),
then judges every answer of the window against the plain reference
(graphbench/reference/) and prints, as the last line of standard output,
one JSON object: correct, attempted, failed, metrics, device, with --trace 1
a breakdown, and last the numbers compared, each with its limit (also the
last lines of standard error). It exits non-zero, printing no result, when
there is no CUDA card or fewer than the cell asks for, or when jax, jaxlib,
flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dgraph_tpu")
GRACE_S = 60.0          # how long answers due in the window are waited for
# what decides `correct`: answers the reference disagrees with, and answers
# due in the window that never came; both exact
LIMITS = {"wrong_answers": 0, "missing_answers": 0}


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among `names` (default: what this
    process has loaded), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def host_data(data: dict) -> dict:
    """The generated arrays moved off the card (the loader and the request
    draws read them there), with each uid predicate's subjects as the pool
    that seed uids are drawn from."""
    data["edges"] = {a: (s.cpu(), d.cpu()) for a, (s, d) in
                     data["edges"].items()}
    data["pools"] = {a: np.unique(s.numpy()) for a, (s, _) in
                     data["edges"].items()}
    return data


def to_device(data: dict, device) -> dict:
    data["edges"] = {a: (s.to(device), d.to(device)) for a, (s, d) in
                     data["edges"].items()}
    return data


class Prepared:
    """A cell's set-up: the data, the loaded Node, its query call, the
    traffic mix."""

    def __init__(self, cell, seed: int, device: str, call_hook=None):
        import torch

        from graphbench import loadgen, spec
        from graphbench.ingest import packed
        from dgraph_tpu_torch.api.server import Node

        cfg = cell.config
        self.cuda = torch.device(device).type == "cuda"
        self.setup: dict = {}
        t0 = time.perf_counter()
        gen = spec.plugin("datagen", cfg["generator"])
        self.data = host_data(gen.generate(cfg, seed, device))
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.setup["generate"] = time.perf_counter() - t0
        self.node = node = Node(device=device, **cfg.get("node", {}))
        self.setup["ingest"] = packed.install(node, self.data)
        limit = int(cfg["query_edge_limit"])

        def call(text):
            return node.query(text, edge_limit=limit)[0]

        self.call = call if call_hook is None else call_hook(node, call)
        self.mix = loadgen.Mix(cell.traffic, self.data)
        warm_rng = np.random.default_rng([seed, 2])
        t0 = time.perf_counter()
        for i in range(len(self.mix.kinds)):
            for _ in range(int(cell.traffic.get("warmup", 3))):
                self.call(self.mix.make(warm_rng, i,
                                        float(warm_rng.random()))["text"])
        if self.cuda:
            torch.cuda.synchronize()
        self.setup["warmup"] = time.perf_counter() - t0

    def close(self) -> None:
        import torch

        self.node.close()
        self.node = self.call = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             call_hook=None, t_start: float = T_START) -> dict:
    """One run of `cell` on `device`. call_hook(node, call) may replace the
    Node's query call (the tests plant faults with it)."""
    import torch

    from graphbench import loadgen, spec
    from graphbench.reference.dataset import Reference

    traffic = cell.traffic
    p = Prepared(cell, seed, device, call_hook)
    node, call, mix, data, cuda = p.node, p.call, p.mix, p.data, p.cuda
    rng = np.random.default_rng([seed, 1])
    late = []
    if traffic["loop"] == "open":
        due = loadgen.arrivals(float(traffic["rate"]), seconds,
                               np.random.default_rng([seed, 3]))
        reqs = mix.requests(len(due), rng)
    setup_s = time.perf_counter() - t_start

    tracer = None
    if trace:
        from graphbench.trace import Tracer

        tracer = Tracer(node, torch.device(device))
        tracer.start()
    if traffic["loop"] == "open":
        records, late = loadgen.open_loop(
            call, reqs, due, int(traffic["clients"]), seconds, GRACE_S)
    else:
        records = loadgen.closed_loop(
            call, mix, rng, seconds, int(traffic["clients"]), GRACE_S)
    in_window = [r for r in records if r.due is not None and r.due < seconds]
    completed = [r for r in in_window if r.resp is not None
                 and r.done <= seconds]
    window = tracer.stop(sum(r.resp is not None for r in records)) \
        if tracer else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del node, call
    p.close()

    # ---- judge every answer of the window against the plain reference ---
    t0 = time.perf_counter()
    ref = Reference(to_device(data, device))
    wrong, edges_of = 0, {}
    examples = []
    for r in in_window:
        if r.resp is None:
            continue
        ok, edges = mix.judge(ref, r.req, r.resp)
        edges_of[id(r)] = edges
        if not ok:
            wrong += 1
            if len(examples) < 3:
                examples.append({"request": r.req["text"][:300],
                                 "answer": json.dumps(r.resp)[:300]})
    missing = [r for r in in_window if r.resp is None]
    judge_s = time.perf_counter() - t0

    lat = sorted(((r.done - r.due) if r.resp is not None
                  else seconds + GRACE_S - r.due) * 1e3 for r in in_window)
    values = {"setup_s": setup_s}
    if lat:
        values["latency_p50_ms"] = loadgen.percentile(lat, 50)
        values["latency_p95_ms"] = loadgen.percentile(lat, 95)
    # a rate is all the window's work over all its time: an open loop's
    # window is its schedule; a closed loop's runs until the last request
    # sent in it is answered, so no request is cut in two
    if traffic["loop"] == "closed" and not missing:
        done, span = in_window, max(r.done for r in in_window)
    else:
        done, span = completed, seconds
    values["queries_per_s"] = len(done) / span
    counted = [edges_of.get(id(r)) for r in done]
    if counted and all(e is not None for e in counted):
        values["traversed_edges_per_s"] = sum(counted) / span
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.plugin("metrics", m["name"]).read(window)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": units[m["name"]]}
    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
               "count": cell.chips, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    checks = {"wrong_answers": wrong, "missing_answers": len(missing)}
    out = {"correct": all(checks[k] <= LIMITS[k] for k in checks),
           "attempted": len(in_window), "failed": len(missing),
           "metrics": metrics, "device": dev}
    if window is not None:
        from graphbench.trace import breakdown

        dev["busy_s"] = window.busy_s
        dev["window_s"] = window.window_s
        out["breakdown"] = breakdown(window)
    out["checks"] = {k: {"value": v, "limit": LIMITS[k]}
                     for k, v in checks.items()}
    out["_notes"] = {"setup": p.setup, "judge_s": judge_s,
                     "generator_late_p95_ms": (
                         loadgen.percentile(sorted(late), 95) * 1e3
                         if late else None),
                     "wrong_examples": examples,
                     "latencies_ms": [round(x, 1) for x in lat[:600]],
                     "errors": sorted({r.error for r in missing
                                       if r.error})[:3],
                     "all_metrics": values}
    return out


def emit(out: dict) -> None:
    """The notes on standard error, then the checks as its last lines; the
    result line last on standard output, the checks last in it."""
    notes = out.pop("_notes")
    checks = out.pop("checks")
    print(json.dumps({"notes": notes}), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    out["checks"] = checks
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m graphbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from graphbench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("graphbench: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"graphbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"graphbench: loaded in this process: {', '.join(bad)}; "
              "no result", file=sys.stderr)
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
