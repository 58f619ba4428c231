"""The shortest kernel tier's tracing, on the CPU, and the benchmark's
readers of it.

Inside a request, ops/pull_bfs.shortest_bfs runs its BFS loop in the
`shortest_bfs` span and its host walk in the `shortest_walk` span, both of
the traversal layer, and books their times and the loop's hops in the
Node's registry; every K1/K2 run (the plain versions here) books itself
and what it streamed there too (ops/prefix.py). graphbench's readers turn
those counters into bfs_ms_per_query, walk_ms_per_query and the K1/K2
roofline shares, and give no reading on a program that lacks them.
"""

import time

import pytest

from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.obs import otrace
from dgraph_tpu_torch.ops import pull_bfs, prefix
from dgraph_tpu_torch.query import shortest
from dgraph_tpu_torch.utils import metrics as metrics_mod

from graphbench import spec
from graphbench.trace import Window

# 1 - 2 - 3 - 4 - 5 - 6 and a chord 1 - 7 - 8, every edge both ways
EDGES = [(1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (1, 7), (7, 8)]
NEW = ("dgraph_shortest_bfs_ns_total", "dgraph_shortest_walk_ns_total",
       "dgraph_shortest_bfs_hops_total",
       "dgraph_prefix_k1_launches_total", "dgraph_prefix_k1_edge_slots_total",
       "dgraph_prefix_k1_bitmap_words_total",
       "dgraph_prefix_k2_launches_total", "dgraph_prefix_k2_edge_slots_total",
       "dgraph_prefix_k2_table_entries_total")
READERS = ("prefix_roofline_share.k1", "prefix_roofline_share.k2",
           "bfs_ms_per_query", "walk_ms_per_query")


@pytest.fixture
def node(monkeypatch):
    """A Node over EDGES with the kernel tier forced and the caches off."""
    monkeypatch.setattr(shortest, "DEVICE_SSSP_MIN_EDGES", 0)
    monkeypatch.setattr(shortest, "SSSP_KERNEL_MIN", 0)
    n = Node(device="cpu")
    n.alter("friend: [uid] .")
    n.mutate(set_nquads="\n".join(
        f"<{hex(a)}> <friend> <{hex(b)}> .\n<{hex(b)}> <friend> <{hex(a)}> ."
        for a, b in EDGES), commit_now=True)
    n.task_cache = n.result_cache = None
    yield n
    n.close()


def _counts(n) -> dict:
    return {k: n.metrics.counters[k].value for k in NEW}


def _moved(n, text: str) -> dict:
    before = _counts(n)
    n.query(text, edge_limit=1 << 31)
    return {k: v - before[k] for k, v in _counts(n).items()}


def _graph(n):
    return pull_bfs.pull_graph_for(n.snapshot().preds["friend"].csr)


def test_counters_are_preregistered():
    reg = metrics_mod.Registry()
    assert all(k in reg.counters for k in NEW)


@pytest.mark.parametrize("sparse_max,kernel", [(pull_bfs.SPARSE_MAX, "k2"),
                                               (-1, "k1")])
def test_a_known_query_moves_the_counters(node, monkeypatch, sparse_max,
                                          kernel):
    """1 -> 6 is five hops: five launches of the kernel the popcount picks,
    each over the whole padded edge stream; hop 1 reads the source-rank
    bitmap, hops 2-5 the destination-rank one."""
    monkeypatch.setattr(pull_bfs, "SPARSE_MAX", sparse_max)
    text = "{ path as shortest(from: 0x1, to: 0x6) { friend } }"
    out = node.query(text, edge_limit=1 << 31)[0]
    assert out["_path_"][0]["_weight_"] == 5.0
    d = _moved(node, text)
    g = _graph(node)
    e_pad = g.in_src_pad.numel()
    other = "k2" if kernel == "k1" else "k1"
    assert d["dgraph_shortest_bfs_hops_total"] == 5
    assert d[f"dgraph_prefix_{kernel}_launches_total"] == 5
    assert d[f"dgraph_prefix_{kernel}_edge_slots_total"] == 5 * e_pad
    assert d[f"dgraph_prefix_{other}_launches_total"] == 0
    assert d[f"dgraph_prefix_{other}_edge_slots_total"] == 0
    if kernel == "k1":
        words = (g.chunks + 4 * g.chunks_d) * 8 * prefix.LANES
        assert d["dgraph_prefix_k1_bitmap_words_total"] == words
    else:
        assert d["dgraph_prefix_k2_table_entries_total"] == 5 * 33 * 128
    assert d["dgraph_shortest_bfs_ns_total"] > 0
    assert d["dgraph_shortest_walk_ns_total"] > 0


def test_an_unreachable_target_books_no_walk(node):
    node.mutate(set_nquads="<0x9> <friend> <0xa> .\n<0xa> <friend> <0x9> .",
                commit_now=True)
    text = "{ path as shortest(from: 0x1, to: 0x9) { friend } }"
    assert node.query(text, edge_limit=1 << 31)[0] == {}
    d = _moved(node, text)
    # the component of 1 is 1..8, 6 the farthest at five hops: a sixth
    # finds nothing new, and the loop stops on the empty frontier
    assert d["dgraph_shortest_bfs_hops_total"] == 6
    assert d["dgraph_shortest_bfs_ns_total"] > 0
    assert d["dgraph_shortest_walk_ns_total"] == 0


def test_both_spans_land_in_the_traversal_layer(node):
    assert otrace.layer_of("shortest_bfs") == "traversal"
    assert otrace.layer_of("shortest_walk") == "traversal"
    trav = "dgraph_span_self_ns_traversal_total"
    t0 = node.metrics.counters[trav].value
    a = time.perf_counter()
    node.query("{ path as shortest(from: 0x8, to: 0x5) { friend } }",
               edge_limit=1 << 31)
    b = time.perf_counter()
    entries = otrace.span_log(a, b)
    by_name = {e[1]: e for e in entries}
    for name in ("shortest_bfs", "shortest_walk"):
        assert by_name[name][0] == "traversal"
    bfs, walk = by_name["shortest_bfs"], by_name["shortest_walk"]
    assert bfs[4] <= walk[3]                  # the walk follows the loop
    kernel = [e for e in entries if e[1] == "device_kernel"
              and bfs[3] <= e[3] and e[4] <= bfs[4]]
    assert kernel                             # the seam inside the loop
    shortest_span = by_name["shortest"]
    assert shortest_span[3] <= bfs[3] and walk[4] <= shortest_span[4]
    assert node.metrics.counters[trav].value > t0


# ---- the benchmark's readers ---------------------------------------------

def read(name, w):
    return spec.plugin("metrics", name).read(w)


def _window(counters: dict, events=()) -> Window:
    w = Window()
    w.window_s, w.completed = 2.0, 4
    w.counters = dict(counters)
    w.device_events = list(events)
    return w


def test_roofline_shares_on_a_synthetic_window():
    """Bytes bound both kernels: 8 B an edge slot and 4 B a frontier word
    over 3.35 TB/s, against 22 (K1) or 19 (K2) operations a slot over
    16.7e12/s."""
    slots, words, entries = 64 * 2**20, 3 * 4096, 2 * 33 * 128
    k1_s = [0.000061, 0.000059]
    k2_s = [0.000070]
    w = _window({"dgraph_prefix_k1_edge_slots_total": slots,
                 "dgraph_prefix_k1_bitmap_words_total": words,
                 "dgraph_prefix_k2_edge_slots_total": slots // 2,
                 "dgraph_prefix_k2_table_entries_total": entries},
                [("void (anonymous namespace)::dense_scan<true>(int const*)",
                  0.1, k1_s[0]),
                 ("void (anonymous namespace)::dense_scan<false>(int const*)",
                  0.2, k1_s[1]),
                 ("void (anonymous namespace)::sparse_scan(int const*)",
                  0.3, k2_s[0]),
                 ("void at::native::elementwise_kernel<...>", 0.4, 0.5)])
    k1 = (8 * slots + 4 * words) / 3.35e12
    assert k1 > 22 * slots / 16.7e12
    k2 = (8 * slots // 2 + 4 * entries) / 3.35e12
    assert k2 > 19 * (slots // 2) / 16.7e12
    assert read("prefix_roofline_share.k1", w) == \
        pytest.approx(100 * k1 / sum(k1_s))
    assert read("prefix_roofline_share.k2", w) == \
        pytest.approx(100 * k2 / sum(k2_s))
    # no time for the kernel in the trace: nothing to read
    assert read("prefix_roofline_share.k1", _window(w.counters)) is None


def test_span_time_readers_on_a_synthetic_window():
    w = _window({"dgraph_shortest_bfs_ns_total": 12_000_000,
                 "dgraph_shortest_walk_ns_total": 2_000_000})
    assert read("bfs_ms_per_query", w) == pytest.approx(3.0)
    assert read("walk_ms_per_query", w) == pytest.approx(0.5)
    assert read("walk_ms_per_query", _window({})) == 0.0
    w.completed = 0
    assert read("bfs_ms_per_query", w) is None


@pytest.mark.parametrize("name", READERS)
def test_no_reading_without_the_counters(monkeypatch, name):
    """A program whose registry lacks the counters (as before they were
    added) gives no reading, though the window holds the kernels' time."""

    class Older(metrics_mod.Registry):
        def __init__(self):
            super().__init__()
            for k in NEW:
                del self.counters[k]

    w = _window({}, [("dense_scan<true>", 0.1, 0.001),
                     ("sparse_scan", 0.2, 0.001)])
    assert read(name, w) is not None
    monkeypatch.setattr(metrics_mod, "Registry", Older)
    assert read(name, w) is None
