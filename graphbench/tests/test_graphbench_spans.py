"""The span readers on synthetic windows: the counter readers on
`w.counters`, the idle readers on synthetic gaps and a synthetic span
ring."""

import pytest

from dgraph_tpu_torch.obs import otrace
from graphbench import spec
from graphbench.trace import Window

LAYERS = ("node", "engine", "traversal", "device")


def read(name, w):
    return spec.plugin("metrics", name).read(w)


def idle(gaps, entries):
    return spec.plugin("metrics", "_span_idle").idle_by_layer(gaps, entries)


def window(gaps=(), counters=None, completed=2):
    w = Window()
    w.window_s = 10.0
    w.completed = completed
    w.gaps = list(gaps)
    w.counters = dict(counters or {})
    return w


def test_counter_readers():
    w = window(counters={
        "dgraph_span_self_ns_node_total": 40_000_000,
        "dgraph_span_self_ns_engine_total": 3_000_000_000,
        "dgraph_span_self_ns_device_total": 100_000_000,
        "dgraph_transfer_d2h_bytes_total": 160_000_000,
        "dgraph_transfer_h2d_bytes_total": 4_000_000,
        "dgraph_dispatch_wait_ns_total": 6_000_000})
    assert read("span_ms_per_query.node", w) == pytest.approx(20.0)
    assert read("span_ms_per_query.engine", w) == pytest.approx(1500.0)
    assert read("span_ms_per_query.device", w) == pytest.approx(50.0)
    # a counter the window lacks reads 0
    assert read("span_ms_per_query.traversal", w) == 0.0
    assert read("d2h_bytes_per_query", w) == pytest.approx(80e6)
    assert read("h2d_bytes_per_query", w) == pytest.approx(2e6)
    assert read("gate_wait_ms_per_query", w) == pytest.approx(3.0)
    assert read("span_ms_per_query.node", window(completed=0)) is None


def test_innermost_span_takes_the_slice():
    # one thread: query [0, 10) > execute [1, 9) > device_kernel [2, 3)
    ring = [("node", "query", 1, 0.0, 10.0),
            ("engine", "execute", 1, 1.0, 9.0),
            ("device", "device_kernel", 1, 2.0, 3.0)]
    got = idle([(0.5, 2.5), (8.0, 9.5)], ring)
    assert got["node"] == pytest.approx(0.5 + 0.5)     # 0.5-1, 9-9.5
    assert got["engine"] == pytest.approx(1.0 + 1.0)   # 1-2, 8-9
    assert got["device"] == pytest.approx(0.5)         # 2-2.5
    assert got["traversal"] == 0.0


def test_two_threads_split_a_slice():
    ring = [("engine", "merge", 1, 0.0, 4.0),
            ("node", "parse", 2, 1.0, 3.0)]
    got = idle([(0.0, 4.0)], ring)
    # 0-1 and 3-4 engine alone; 1-3 split half and half
    assert got["engine"] == pytest.approx(2.0 + 1.0)
    assert got["node"] == pytest.approx(1.0)


def test_a_gap_with_no_span_open_goes_nowhere():
    ring = [("engine", "encode", 1, 0.0, 1.0)]
    got = idle([(0.5, 1.0), (2.0, 3.0)], ring)
    assert got["engine"] == pytest.approx(0.5)
    assert sum(got.values()) == pytest.approx(0.5)


def test_idle_readers_read_the_ring(monkeypatch):
    ring = [("node", "query", 1, 0.0, 10.0),
            ("engine", "encode", 1, 2.0, 6.0),
            ("device", "device_kernel", 1, 6.0, 7.0)]
    monkeypatch.setattr(otrace, "span_log", lambda a, b: [
        e for e in ring if e[4] >= a and e[3] <= b])
    gaps = [(0.0, 1.0), (2.0, 4.0), (6.5, 9.0)]
    w = window(gaps, completed=2)
    got = {lay: read(f"idle_ms_per_query.{lay}", w) for lay in LAYERS}
    assert got == pytest.approx({"node": 1e3 * (1.0 + 2.0) / 2,
                                 "engine": 1e3 * 2.0 / 2,
                                 "traversal": 0.0,
                                 "device": 1e3 * 0.5 / 2})
    # gaps wholly inside spans: the four readers cover the idle time
    idle_s = sum(b - a for a, b in gaps)
    assert sum(got.values()) * w.completed / 1e3 == pytest.approx(idle_s)


def test_a_dropped_ring_gives_no_reading(monkeypatch):
    monkeypatch.setattr(otrace, "span_log", lambda a, b: [])
    w = window([(0.0, 1.0)],
               counters={"dgraph_span_ring_dropped_total": 3})
    for lay in LAYERS:
        assert read(f"idle_ms_per_query.{lay}", w) is None
    w.counters = {}
    for lay in LAYERS:
        assert read(f"idle_ms_per_query.{lay}", w) == 0.0


def test_a_program_without_layer_spans_gives_no_reading(monkeypatch):
    monkeypatch.delattr(otrace, "span_log")
    w = window([(0.0, 1.0)],
               counters={"dgraph_span_self_ns_engine_total": 5})
    assert read("span_ms_per_query.engine", w) is None
    assert read("idle_ms_per_query.engine", w) is None
    assert read("d2h_bytes_per_query", w) is None
