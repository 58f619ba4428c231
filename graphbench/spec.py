"""Find a cell's parts by name: BENCHMARK.json's entries, the
configuration's file, the traffic mix's file, and the code that a name
points to (a generator, a request kind, a metric's reader)."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def plugin(kind: str, name: str):
    """graphbench/<kind>/<name>.py, loaded by its path (a name may hold
    dots and dashes) once per process."""
    key = f"graphbench._{kind}.{name}"
    mod = sys.modules.get(key)
    if mod is None:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"graphbench: no {kind} named {name!r} "
                                    f"({path.relative_to(ROOT)})")
        s = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(s)
        sys.modules[key] = mod
        s.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, as it is run
    traffic: dict         # the traffic mix's file
    end_to_end: list      # BENCHMARK.json entries that this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"graphbench: no workload named {name!r}")
    w = found[0]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    return Cell(name=name, chips=int(w["chips"]),
                config=json.loads((ROOT / c["file"]).read_text()),
                traffic=traffic(w["traffic"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])
