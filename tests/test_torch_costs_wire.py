"""The PyTorch port against tests/test_costs.py: its wire cases, with the
port's modules (workers and Node on device="cpu", the plain PyTorch
versions).

Query cost ledger + fleet metrics:
per-request resource attribution threaded through every execution seam,
aggregatable fixed-bucket histograms with trace exemplars, the
Zero-federated fleet scrape, and the /debug/top sliding-window profiler
with EWMA regression baselines."""

import random
import urllib.error
import urllib.request

import pytest

from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.obs import costs, prom
from dgraph_tpu_torch.query import task as taskmod
from dgraph_tpu_torch.utils import metrics

SCHEMA = """
    name: string @index(exact) .
    age: int @index(int) .
    follows: [uid] @reverse .
"""


@pytest.fixture
def node():
    n = Node(span_sample=1.0, trace_rng=random.Random(11), device="cpu")
    n.alter(schema_text=SCHEMA)
    n.mutate(set_nquads="""
        _:a <name> "ann" .
        _:b <name> "bob" .
        _:c <name> "cid" .
        _:a <age> "30" .
        _:a <follows> _:b .
        _:a <follows> _:c .
    """, commit_now=True)
    yield n
    n.close()


# ---------------------------------------------------------------------------
# ledger unit behavior
# ---------------------------------------------------------------------------


def test_ledger_wire_roundtrip_and_remote_merge():
    w = costs.CostLedger(endpoint="serve_task")
    with w.task("follows"):
        w.add_kernel("csr.expand", 2.5, h2d=10, d2h=20)
        w.add_task("follows", 3)
    w.finish()
    raw = w.to_wire()
    rec = costs.CostLedger.from_wire(raw)
    assert rec["edges"] == 3 and rec["pred"]["follows"][1] == 3

    root = costs.CostLedger(endpoint="query")
    root.add_task("follows", 3)     # the root attributed the RPC result
    root.merge_remote("w1:7080", rec)
    root.merge_remote("w1:7080", rec)   # second RPC to the same worker
    out = root.to_dict()
    # physical costs sum; logical counts dedupe against the root's view
    assert out["groups"]["w1:7080"]["device_ms"] == 5.0
    assert out["total"]["edges"] == 6       # 2 RPCs' worth, not 9
    assert out["total"]["device_ms"] == 5.0
    assert out["total"]["h2d"] == 20


# ---------------------------------------------------------------------------
# wire cluster: one assembled record + fleet merge exactness
# ---------------------------------------------------------------------------

grpc = pytest.importorskip("grpc")


@pytest.fixture
def wire_cluster():
    from dgraph_tpu_torch.coord.zero import Zero
    from dgraph_tpu_torch.coord.zero_service import ZeroClient, serve_zero
    from dgraph_tpu_torch.parallel.client import ClusterClient
    from dgraph_tpu_torch.parallel.remote import serve_worker
    from dgraph_tpu_torch.storage.store import Store
    from dgraph_tpu_torch.utils.schema import parse_schema

    def mk():
        s = Store()
        for e in parse_schema(SCHEMA):
            s.set_schema(e)
        return s

    zero = Zero(2)
    zero.move_tablet("name", 0)
    zero.move_tablet("follows", 1)
    zero.move_tablet("age", 1)
    zsrv, zport, zsvc = serve_zero(zero, "localhost:0")
    w0, p0 = serve_worker(mk(), "localhost:0", device="cpu")
    w1, p1 = serve_worker(mk(), "localhost:0", device="cpu")
    # register with Zero's membership so the fleet scrape finds them
    zc = ZeroClient(f"localhost:{zport}")
    zc.connect(f"localhost:{p0}", 0)
    zc.connect(f"localhost:{p1}", 1)
    zc.close()
    client = ClusterClient(
        f"localhost:{zport}",
        {0: [f"localhost:{p0}"], 1: [f"localhost:{p1}"]},
        span_sample=1.0, trace_rng=random.Random(7))
    client.mutate(set_nquads="""
        _:a <name> "ann" .
        _:b <name> "bob" .
        _:c <name> "cid" .
        _:a <age> "30" .
        _:a <follows> _:b .
        _:a <follows> _:c .
    """)
    yield client, zsvc, (f"localhost:{p0}", f"localhost:{p1}")
    client.close()
    w0.stop(0)
    w1.stop(0)
    zsrv.stop(0)


def test_cross_shard_query_one_merged_cost_record(wire_cluster,
                                                 monkeypatch):
    """a cross-shard query yields ONE assembled
    record whose per-group device ms/bytes/edges match the spans."""
    client, _zsvc, addrs = wire_cluster
    monkeypatch.setattr(taskmod, "HOST_EXPAND_MAX", 0)
    out = client.query(
        '{ q(func: eq(name, "ann")) { name age follows { name } } }')
    assert len(out["q"][0]["follows"]) == 2
    rec = client.cost_book.last()
    # both groups shipped their cost records back over trailing metadata
    assert set(rec["groups"]) == set(addrs), rec["groups"].keys()
    t = rec["total"]
    assert t["edges"] == 2                      # logical, not double-booked
    g_follows = rec["groups"][addrs[1]]
    assert g_follows["pred"]["follows"][1] == 2
    assert g_follows["device_ms"] > 0
    # per-group device charges reconcile against the shipped spans: every
    # group's device_kernel span total is <= that group's ledger device
    # ms (the ledger times the same fenced section), and a group with
    # kernel spans has nonzero ledger charges
    trace = client.tracer.sink.get(rec["trace_id"])
    assert trace is not None
    by_proc: dict = {}
    for s in trace["spans"]:
        if s["name"] == "device_kernel":
            by_proc.setdefault(s["proc"], 0.0)
            by_proc[s["proc"]] += s["dur"] * 1e3
    assert by_proc, "no device spans shipped"
    for proc, span_ms in by_proc.items():
        addr = proc.split(":", 1)[1] if ":" in proc else proc
        g = rec["groups"].get(addr)
        assert g is not None, (proc, rec["groups"].keys())
        assert g["device_ms"] >= span_ms * 0.5, \
            f"{addr}: ledger {g['device_ms']}ms vs spans {span_ms}ms"
    # the shipped per-group edge counts agree with the span annotations
    span_edges = sum(s["attrs"].get("edges", 0)
                     for s in trace["spans"]
                     if s["name"] == "device_kernel"
                     and s["attrs"].get("kernel") == "csr.expand")
    assert span_edges == g_follows["pred"]["follows"][1]


def test_fleet_scrape_merge_equals_per_node_sum(wire_cluster):
    """/metrics/fleet histogram _sum/_count equal
    the sum of the per-node scrapes (merge exactness)."""
    from dgraph_tpu_torch.coord.zero_service import fleet_scrape

    client, zsvc, addrs = wire_cluster
    for i in range(3):
        client.query('{ q(func: eq(name, "ann")) { name follows '
                     '{ name } } }', variables={"$i": str(i)})
    fl = fleet_scrape(zsvc)
    assert set(fl["nodes"]) == set(addrs), fl["unreachable"]
    merged = fl["merged"]
    per = list(fl["nodes"].values())
    for cname in ("dgraph_task_cache_misses_total",
                  "dgraph_posting_writes_total"):
        assert merged["counters"][cname] == \
            sum(p["counters"][cname] for p in per)
    for hname, h in merged["histograms"].items():
        assert h["count"] == sum(
            p["histograms"][hname]["count"] for p in per
            if hname in p["histograms"])
        assert h["sum"] == pytest.approx(sum(
            p["histograms"][hname]["sum"] for p in per
            if hname in p["histograms"]))
        cum = 0
        total = 0
        for c in h["counts"]:
            total += c
        assert total == h["count"]
    # and the merged exposition is valid prom text
    text = prom.render_export(merged)
    series = prom.parse(text)
    assert series
