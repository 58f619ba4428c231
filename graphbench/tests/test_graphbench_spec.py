"""BENCHMARK.json against the contract the harness is written to: every
name finds its file, every per-layer metric moves an end-to-end metric
that each of its cells reports, and the limits of names and units hold."""

import json
import re

import pytest

from graphbench import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def reported(cell: str) -> set:
    return {m["name"] for m in spec.cell(cell).end_to_end}


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(B)) < 64 << 10
    assert 1 <= B["run_seconds"] <= 51
    assert B["paths"] == ["graphbench"]


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_parts_exist(w):
    cell = spec.cell(w["name"])
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and len(w["why"]) <= 200
    for r in cell.traffic["requests"]:
        spec.plugin("requests", r["kind"])
    spec.plugin("datagen", cell.config["generator"])
    names = reported(w["name"])
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_configs():
    for c in B["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert c["file"].startswith("graphbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        spec.plugin("metrics", m["name"])
        cells = m.get("workloads", [w["name"] for w in B["workloads"]])
        assert all(m["moves"] in reported(c) for c in cells)
