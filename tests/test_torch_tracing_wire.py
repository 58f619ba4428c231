"""The PyTorch port against tests/test_tracing.py: its wire cases, with the
port's modules (workers and Node on device="cpu", the plain PyTorch
versions).

End-to-end distributed tracing (obs/otrace.py): one trace id spans
client -> every group's serve_task -> Zero coordinator calls -> device
kernels, with parent/child links intact; traces export as Chrome
trace-event JSON (Perfetto-loadable, validated structurally); /metrics
serves a parseable Prometheus exposition; the slow-query log captures
plan + span tree for threshold-crossing queries."""

import random

import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu_torch.coord.zero import Zero
from dgraph_tpu_torch.coord.zero_service import serve_zero
from dgraph_tpu_torch.obs import otrace
from dgraph_tpu_torch.parallel.client import ClusterClient
from dgraph_tpu_torch.parallel.remote import serve_worker
from dgraph_tpu_torch.query import task as taskmod
from dgraph_tpu_torch.storage.store import Store
from dgraph_tpu_torch.utils.schema import parse_schema

SCHEMA = """
    name: string @index(exact) .
    age: int @index(int) .
    follows: [uid] @reverse .
"""


def _mk_store():
    s = Store()
    for e in parse_schema(SCHEMA):
        s.set_schema(e)
    return s


@pytest.fixture
def wire_cluster():
    """2 worker groups + a zero, all over real loopback gRPC; name lives
    on group 0, follows/age on group 1, so a 2-hop query fans to both."""
    zero = Zero(2)
    zero.move_tablet("name", 0)
    zero.move_tablet("follows", 1)
    zero.move_tablet("age", 1)
    zsrv, zport, _zsvc = serve_zero(zero, "localhost:0")
    stores = [_mk_store(), _mk_store()]
    w0, p0 = serve_worker(stores[0], "localhost:0", device="cpu")
    w1, p1 = serve_worker(stores[1], "localhost:0", device="cpu")
    client = ClusterClient(f"localhost:{zport}",
                           {0: [f"localhost:{p0}"], 1: [f"localhost:{p1}"]},
                           span_sample=1.0, trace_rng=random.Random(7))
    client.mutate(set_nquads="""
        _:a <name> "ann" .
        _:b <name> "bob" .
        _:c <name> "cid" .
        _:a <age> "30" .
        _:b <age> "41" .
        _:a <follows> _:b .
        _:a <follows> _:c .
    """)
    yield client, (f"localhost:{p0}", f"localhost:{p1}"), (w0, w1)
    client.close()
    w0.stop(0)
    w1.stop(0)
    zsrv.stop(0)


def _links_intact(spans):
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans if not s["parent_id"]]
    assert len(roots) == 1, f"expected one root, got {roots}"
    for s in spans:
        if s["parent_id"]:
            assert s["parent_id"] in ids, \
                f"dangling parent {s['parent_id']} for {s['name']}"
    return roots[0]


def test_single_trace_spans_client_workers_zero_device(wire_cluster,
                                                       monkeypatch):
    client, addrs, _srvs = wire_cluster
    # force the device expand path for tiny frontiers so the trace carries
    # a real device-kernel span with transfer bytes
    monkeypatch.setattr(taskmod, "HOST_EXPAND_MAX", 0)
    out = client.query(
        '{ q(func: eq(name, "ann")) { name age follows { name } } }')
    assert out["q"][0]["name"] == "ann"
    assert len(out["q"][0]["follows"]) == 2

    idx = client.tracer.sink.index()
    rec = client.tracer.sink.get(
        next(r["trace_id"] for r in idx if r["root"] == "query"))
    spans = rec["spans"]
    # exactly one trace id across every span
    assert {s["trace_id"] for s in spans} == {rec["trace_id"]}
    root = _links_intact(spans)
    assert root["name"] == "query" and root["proc"] == "client"

    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    # client-side fan-out spans hit BOTH workers
    rpc_addrs = {s["attrs"]["addr"] for s in by_name["rpc:ServeTask"]}
    assert set(addrs) <= rpc_addrs
    # each worker's server span arrived over trailing metadata, with its
    # proc naming the worker
    worker_procs = {s["proc"] for s in by_name["serve_task"]}
    assert len(worker_procs) == 2
    # Zero coordinator calls are part of the same trace
    assert any(n.startswith("zero:") for n in by_name), by_name.keys()
    assert any(s["proc"] == "zero" for s in spans)
    # at least one device-kernel span with transfer bytes, under a worker
    kernels = by_name.get("device_kernel", [])
    assert kernels, f"no device span; names={sorted(by_name)}"
    assert any(k["attrs"].get("transfer_d2h_bytes", 0) > 0 for k in kernels)
    assert all(k["proc"].startswith("worker:") for k in kernels)
    # no span buffers left behind anywhere
    assert client.tracer.active_traces() == 0


def test_failed_fanout_leaks_no_spans(wire_cluster):
    client, _addrs, (w0, w1) = wire_cluster
    client.query('{ q(func: eq(name, "ann")) { name follows { name } } }')
    w1.stop(0)            # group 1 (follows/age) dies mid-cluster
    client.task_cache.clear()   # don't let cached tasks mask the dead group
    with pytest.raises(Exception):
        client.query(
            '{ q(func: eq(name, "bob")) { name follows { name } } }')
    # the root span finished with the error and the trace assembled —
    # nothing lingers in the per-trace buffers
    assert client.tracer.active_traces() == 0
    failed = [r for r in client.tracer.sink.index() if r["error"]]
    assert failed, "failed query should still produce an assembled trace"


    # finish the sampled roots so nothing leaks
    # (roots 0/2/4 were real spans)


def test_join_take_roundtrip_and_remote_merge():
    a = otrace.Tracer(fraction=1.0, proc="caller", rng=random.Random(1))
    b = otrace.Tracer(proc="callee", rng=random.Random(2))
    with a.root("query") as root:
        wire = otrace.wire_context()
        assert wire and wire.startswith(root.trace_id)
        with b.join(wire, "serve_task") as srv:
            with b.start("device", parent=srv):
                pass
        shipped = b.take(root.trace_id)
        assert len(shipped) == 2 and b.active_traces() == 0
        a.add_remote(shipped)
    rec = a.sink.get(root.trace_id)
    assert rec["nspans"] == 3
    tree = otrace.span_tree(rec)
    q = tree["tree"][0]
    assert q["name"] == "query"
    assert q["children"][0]["name"] == "serve_task"
    assert q["children"][0]["children"][0]["name"] == "device"
