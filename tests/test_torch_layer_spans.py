"""The port's layer spans (dgraph_tpu_torch/obs/otrace.py), on the CPU.

Every request records its layer-boundary spans, sampled or not: each span
adds its self time to its layer's counter in the Node's registry and one
entry to the process-wide span ring; the device seam (obs/costs.kernel)
books the bytes it moves. A Node over a small R-MAT graph answers the
3-hop var-block count the benchmark's k-hop cell sends, with the device
expand forced (HOST_EXPAND_MAX 0, planner off, so no cutover override):

- the four layers' self-time counters add up to the root span's duration,
  which lies inside a perf_counter bracket around `node.query`;
- the ring's entries for the request nest per thread and carry the
  table's layers;
- the byte counters move as the cost ledger's h2d / d2h do;
- an unsampled request's spans are falsy and reach no sink, while a
  sampled request's tree has the same span names;
- every literal span name in the package is in the layer table;
- a ring too small for a request counts what it overwrote.
"""

import ast
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.obs import costs, otrace
from dgraph_tpu_torch.query import qcache
from dgraph_tpu_torch.query import task as taskmod
from dgraph_tpu_torch.utils.metrics import Registry

PKG = Path(otrace.__file__).resolve().parent.parent
SELF_NS = {lay: f"dgraph_span_self_ns_{lay}_total" for lay in otrace.LAYERS}
H2D, D2H = "dgraph_transfer_h2d_bytes_total", "dgraph_transfer_d2h_bytes_total"
DROPPED = "dgraph_span_ring_dropped_total"
QUERY = ("{ var(func: uid(%s)) { A as friend { B as friend "
         "{ C as friend } } } q(func: uid(A, B, C)) { count(uid) } }")


def _rmat(scale=9, edgefactor=8, seed=3):
    """Graph500's Kronecker initiator (0.57/0.19/0.19/0.05), uids from 1,
    self-loops dropped."""
    rng = np.random.default_rng(seed)
    n = edgefactor << scale
    src = np.zeros(n, np.int64)
    dst = np.zeros(n, np.int64)
    a, b, c = 0.57, 0.19, 0.19
    for bit in range(scale):
        r = rng.random(n)
        src |= (r >= a + b).astype(np.int64) << bit
        dst |= (((r >= a) & (r < a + b)) | (r >= a + b + c)
                ).astype(np.int64) << bit
    keep = src != dst
    return src[keep] + 1, dst[keep] + 1


@pytest.fixture
def graph_node(monkeypatch):
    monkeypatch.setattr(taskmod, "HOST_EXPAND_MAX", 0)
    made = []

    def make(**kw):
        n = Node(device="cpu", planner=False, batching=False,
                 task_cache_mb=0, result_cache_mb=0, **kw)
        made.append(n)
        n.alter(schema_text="friend: [uid] @reverse .")
        src, dst = _rmat()
        n.mutate(set_nquads="\n".join(
            f"<0x{s:x}> <friend> <0x{d:x}> ." for s, d in zip(src, dst)),
            commit_now=True)
        seeds = np.unique(src)[:8]
        return n, QUERY % ", ".join(hex(int(s)) for s in seeds)
    yield make
    for n in made:
        n.close()


def _counters(n):
    return {k: n.metrics.counter(k).value
            for k in (*SELF_NS.values(), H2D, D2H, DROPPED)}


def _delta(n, c0):
    return {k: v - c0[k] for k, v in _counters(n).items()}


def _timed_query(n, q):
    c0 = _counters(n)
    t0 = time.perf_counter()
    out = n.query(q)[0]
    t1 = time.perf_counter()
    return out, t0, t1, _delta(n, c0)


def test_self_times_sum_to_the_root_span(graph_node):
    n, q = graph_node(span_sample=0.0)
    n.query(q)                        # first touch: uploads, folds
    out, t0, t1, d = _timed_query(n, q)
    assert out["q"][0]["count"] > 0
    roots = [e for e in otrace.span_log(t0, t1) if e[1] == "query"]
    assert len(roots) == 1
    _lay, _name, _tid, r0, r1 = roots[0]
    assert t0 <= r0 < r1 <= t1
    total_ns = sum(d[SELF_NS[lay]] for lay in otrace.LAYERS)
    assert total_ns == pytest.approx((r1 - r0) * 1e9, abs=1e3)
    assert d[SELF_NS["device"]] > 0 and d[SELF_NS["engine"]] > 0
    assert d[SELF_NS["traversal"]] == 0       # no @recurse, no shortest


def test_ring_entries_nest_per_thread_with_their_layers(graph_node):
    n, q = graph_node(span_sample=0.0)
    n.query(q)
    _out, t0, t1, _d = _timed_query(n, q)
    log = otrace.span_log(t0, t1)
    want = {"query": "node", "parse": "node", "execute": "engine",
            "task:friend": "engine", "merge": "engine", "encode": "engine",
            "device_kernel": "device"}
    names = {e[1] for e in log}
    assert set(want) <= names, names
    for lay, name, _tid, _a, _b in log:
        assert lay == otrace.layer_of(name)
        if name in want:
            assert lay == want[name], name
    for tid in {e[2] for e in log}:
        open_ends: list[float] = []
        for _lay, _name, _t, a, b in (e for e in log if e[2] == tid):
            while open_ends and open_ends[-1] <= a:
                open_ends.pop()
            # a span starting inside another ends inside it too
            assert not open_ends or b <= open_ends[-1]
            open_ends.append(b)


def test_byte_counters_equal_the_cost_ledger(graph_node):
    n, q = graph_node(span_sample=0.0)
    n.query(q)
    _out, _t0, _t1, d = _timed_query(n, q)
    total = n.cost_book.last()["total"]
    assert d[H2D] > 0 and d[D2H] > 0
    assert (d[H2D], d[D2H]) == (total["h2d"], total["d2h"])


def test_unsampled_spans_are_lean_and_sampled_ones_keep_the_tree(
        graph_node, monkeypatch):
    n, q = graph_node(span_sample=0.0)
    seen = []
    real = taskmod._merge_matrix

    def spy(matrix):
        seen.append(otrace.current())
        return real(matrix)
    monkeypatch.setattr(taskmod, "_merge_matrix", spy)
    n.query(q)
    _out, t0, t1, d = _timed_query(n, q)
    assert seen and all(isinstance(s, otrace.LeanSpan) and not s
                        for s in seen)
    assert all(s.name == "merge" for s in seen)
    assert len(n.tracer.sink) == 0
    assert sum(d[SELF_NS[lay]] for lay in otrace.LAYERS) > 0
    lean_names = {e[1] for e in otrace.span_log(t0, t1)}

    s, q2 = graph_node(span_sample=1.0)
    seen.clear()
    s.query(q2)
    assert seen and all(bool(x) for x in seen)
    queries = [r for r in s.tracer.sink.index() if r["root"] == "query"]
    assert len(queries) == 1
    rec = s.tracer.sink.get(queries[0]["trace_id"])
    assert {sp["name"] for sp in rec["spans"]} == lean_names
    kern = [sp for sp in rec["spans"] if sp["name"] == "device_kernel"]
    assert kern and all(sp["attrs"].get("transfer_d2h_bytes", 0) > 0
                        for sp in kern)


def _strict_layer(name: str) -> str | None:
    """The table's layer for a name, without layer_of's default."""
    if name in otrace.SPAN_LAYERS:
        return otrace.SPAN_LAYERS[name]
    head, sep, _ = name.partition(":")
    return otrace.SPAN_LAYERS.get(head + sep) if sep else None


def _literal_head(node) -> str | None:
    """A span name's literal text, or its literal prefix when the rest is
    computed ("task:" + attr, f"zero:{name}")."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name) and node.id == "KERNEL_SPAN":
        return costs.KERNEL_SPAN
    if isinstance(node, ast.JoinedStr) and node.values and \
            isinstance(node.values[0], ast.Constant):
        return node.values[0].value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _literal_head(node.left)
    return None


# functions that only pass their caller's span name on
FORWARDERS = {("api/server.py", "_span"), ("obs/otrace.py", "span")}


def test_every_span_name_in_the_package_has_a_layer():
    checked, bad = 0, []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)):
                    continue
                f = call.func
                owner = ast.unparse(f.value)
                if f.attr == "span" and owner == "otrace":
                    arg = call.args[0] if call.args else None
                elif f.attr in ("start", "root") and \
                        owner.endswith("tracer"):
                    arg = call.args[0] if call.args else None
                elif f.attr == "join" and owner.endswith("tracer"):
                    arg = call.args[1] if len(call.args) > 1 else None
                elif f.attr == "_span" and owner == "self":
                    arg = call.args[0] if call.args else None
                elif f.attr == "kernel" and owner == "costs":
                    # the seam opens KERNEL_SPAN; its own argument is the
                    # kernel's name, a literal so /debug/top can rank it
                    if _literal_head(call.args[0]) is None:
                        bad.append((rel, call.lineno, "kernel name"))
                    arg = ast.Constant(costs.KERNEL_SPAN)
                else:
                    continue
                if (rel, fn.name) in FORWARDERS:
                    continue
                head = _literal_head(arg) if arg is not None else None
                checked += 1
                if head is None or _strict_layer(head) is None:
                    bad.append((rel, call.lineno, head))
    assert checked > 30, f"scan looks broken: {checked} sites"
    assert not bad, bad
    assert set(otrace.SPAN_LAYERS.values()) == set(otrace.LAYERS)


def test_a_full_ring_counts_what_it_overwrote(graph_node, monkeypatch):
    n, q = graph_node(span_sample=0.0)
    n.query(q)
    monkeypatch.setattr(otrace, "_RING", otrace._SpanRing(4))
    c0 = _counters(n)
    n.query(q)
    d = _delta(n, c0)
    assert d[DROPPED] > 0
    assert len(otrace._RING.entries()) == 4


def test_gate_wait_books_the_counter_and_the_ledger():
    reg = Registry()
    gate = qcache.DispatchGate(1, reg)
    held, release = threading.Event(), threading.Event()

    def hold():
        gate.run(lambda: (held.set(), release.wait(5)))
    t = threading.Thread(target=hold)
    t.start()
    held.wait(5)
    lg = costs.CostLedger()
    threading.Timer(0.05, release.set).start()
    with costs.scope(lg):
        gate.run(lambda: None)
    t.join(5)
    ns = reg.counter("dgraph_dispatch_wait_ns_total").value
    assert ns >= 0.04e9
    assert ns == pytest.approx(lg.gate_wait_ms * 1e6, rel=1e-6)


def test_threads_book_every_span(monkeypatch):
    """More threads than cores, each a request of nested spans, with a short
    switch interval: the ring holds every span and the counters add up to
    the roots' durations (a lost update would break either)."""
    import os
    import sys

    monkeypatch.setattr(otrace, "_RING", otrace._SpanRing(1 << 16))
    reg = Registry()
    tr = otrace.Tracer(metrics=reg)
    n_threads = 2 * (os.cpu_count() or 2) + 2
    per = 200

    def request():
        with tr.root("query"):
            for _ in range(per):
                with otrace.span("execute"):
                    with otrace.span("device_kernel"):
                        pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=request)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    entries = otrace._RING.entries()
    assert len(entries) == n_threads * (1 + 2 * per)
    assert reg.counter(DROPPED).value == 0
    roots_ns = sum((e[4] - e[3]) * 1e9 for e in entries if e[1] == "query")
    booked = sum(reg.counter(SELF_NS[lay]).value for lay in otrace.LAYERS)
    assert booked == pytest.approx(roots_ns, abs=n_threads * 4)
