"""The per-layer readers on a synthetic window: device intervals and
sampled host frames."""

import pytest

from graphbench import spec
from graphbench.trace import Window, breakdown


def window():
    w = Window()
    w.window_s = 2.0
    w.completed = 4
    w.busy_s = 0.5
    w.device_events = [("void dense_scan<true>(...)", 0.1, 0.002),
                       ("void dense_scan<false>(...)", 0.2, 0.002),
                       ("sparse_scan(...)", 0.3, 0.001),
                       ("elementwise", 0.4, 0.495)]
    w.host_seconds = {"query/task.py:process_task": 0.4,
                      "query/engine.py:_process_block": 0.2,
                      "ops/csr.py:expand_dest": 0.1,
                      "query/recurse.py:recurse": 0.02,
                      "api/server.py:query": 0.08,
                      "obs/costs.py:record": 0.04,
                      "storage/store.py:get": 1.0}
    w.gaps = [(0.0, 0.1), (1.0, 1.5)]
    w.timeline = [(0.05, "query/task.py:process_task"),
                  (1.2, "api/server.py:query"),
                  (1.3, "api/server.py:query")]
    return w


def read(name, w):
    return spec.plugin("metrics", name).read(w)


def test_idle_share():
    assert read("device_idle_share", window()) == pytest.approx(0.75)


def test_host_layers():
    w = window()
    assert read("host_ms_per_query.engine", w) == pytest.approx(150.0)
    assert read("host_ms_per_query.traversal", w) == pytest.approx(30.0)
    assert read("host_ms_per_query.node", w) == pytest.approx(30.0)


def test_breakdown_names_gaps_by_host_frame():
    b = breakdown(window())
    assert b["device_ops"][0] == ["elementwise", 0.495]
    assert b["idle_gaps"][0] == ["api/server.py:query", 0.5]
    assert b["idle_gaps"][1] == ["query/task.py:process_task", 0.1]


@pytest.mark.parametrize("m", spec.benchmark()["per_layer"],
                         ids=lambda m: m["name"])
def test_every_per_layer_metric_reads(m):
    """Each reader BENCHMARK.json names reads a number from a window with
    something to read, and nothing from a window without."""
    assert read(m["name"], window()) is not None
    empty = Window()
    assert read(m["name"], empty) is None
