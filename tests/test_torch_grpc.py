"""The PyTorch port's gRPC api.Dgraph service and client, on the CPU.

First the cases of tests/test_grpc.py with the port's client against the
port's server (a Node(device="cpu") behind it). Then across packages: a
JAX client against a port server and a port client against a JAX server,
each fed the same request sequence as a same-package pair, every response
equal field by field (the `json` bytes, assigned uids, timestamps) to the
pair's. Both packages' api_pb2 modules load in one process: the port
builds its messages in a private descriptor pool (see its docstring), and a
subprocess pins that in both import orders. Every call has a deadline.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import grpc
import pytest

from dgraph_tpu.api import grpc_client as jclient
from dgraph_tpu.api import grpc_server as jserver
from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.protos import api_pb2 as jpb

from dgraph_tpu_torch.api import grpc_client as tclient
from dgraph_tpu_torch.api import grpc_server as tserver
from dgraph_tpu_torch.api.grpc_client import DgraphClient, TxnAborted
from dgraph_tpu_torch.api.grpc_server import serve_grpc
from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.protos import api_pb2 as tpb

REPO = Path(__file__).resolve().parents[1]


def _ready(c, timeout=5):
    grpc.channel_ready_future(c.channel).result(timeout=timeout)
    return c


@pytest.fixture(scope="module")
def client():
    node = TNode(device="cpu")
    server, port = serve_grpc(node, "localhost:0")
    c = _ready(DgraphClient(f"localhost:{port}"))
    try:
        yield c
    finally:
        c.close()
        server.stop(0)
        node.close()


def test_check_version(client):
    assert client.check_version() == "dgraph-tpu"


def test_alter_mutate_query(client):
    client.alter(schema="name: string @index(exact) .\nage: int @index(int) .")
    txn = client.txn()
    uids = txn.mutate(set_nquads='_:a <name> "alice" .\n_:a <age> "30" .',
                      commit_now=True)
    assert "a" in uids
    out = client.txn(read_only=True).query(
        '{ q(func: eq(name, "alice")) { name age } }')
    assert out == {"q": [{"name": "alice", "age": 30}]}


def test_txn_commit_visibility(client):
    txn = client.txn()
    txn.mutate(set_nquads='_:b <name> "bob" .')
    # not yet visible to other readers
    out = client.txn(read_only=True).query('{ q(func: eq(name, "bob")) { name } }')
    assert out == {}
    # visible to the txn itself
    own = txn.query('{ q(func: eq(name, "bob")) { name } }')
    assert own == {"q": [{"name": "bob"}]}
    txn.commit()
    out = client.txn(read_only=True).query('{ q(func: eq(name, "bob")) { name } }')
    assert out == {"q": [{"name": "bob"}]}


def test_txn_discard(client):
    txn = client.txn()
    txn.mutate(set_nquads='_:c <name> "carol" .')
    txn.discard()
    out = client.txn(read_only=True).query('{ q(func: eq(name, "carol")) { name } }')
    assert out == {}


def test_conflict_aborts(client):
    t1 = client.txn()
    t2 = client.txn()
    t1.mutate(set_nquads='<0x777> <name> "one" .')
    t2.mutate(set_nquads='<0x777> <name> "two" .')
    t1.commit()
    with pytest.raises(TxnAborted):
        t2.commit()


def test_bad_query_is_invalid_argument(client):
    with pytest.raises(grpc.RpcError) as ei:
        client.txn(read_only=True).query("{ not valid dql !!!")
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_json_mutation(client):
    txn = client.txn()
    uids = txn.mutate(set_json={"name": "dave", "age": 41}, commit_now=True)
    assert uids
    out = client.txn(read_only=True).query(
        '{ q(func: eq(name, "dave")) { name age } }')
    assert out == {"q": [{"name": "dave", "age": 41}]}


def test_drop_attr(client):
    client.alter(schema="tmp: string @index(exact) .")
    client.txn().mutate(set_nquads='_:t <tmp> "gone" .', commit_now=True)
    client.alter(drop_attr="tmp")
    out = client.txn(read_only=True).query('{ q(func: has(tmp)) { tmp } }')
    assert out == {}


def test_query_then_mutate_same_txn(client):
    # lazy txn open: first op is a query, mutate must join the same txn
    txn = client.txn()
    out = txn.query('{ q(func: eq(name, "nobody-here")) { name } }')
    assert out == {}
    txn.mutate(set_nquads='_:e <name> "erin" .')
    txn.commit()
    out = client.txn(read_only=True).query('{ q(func: eq(name, "erin")) { name } }')
    assert out == {"q": [{"name": "erin"}]}


def test_grpc_upsert_insert_then_update(client):
    client.alter(schema="email: string @index(exact) @upsert .")
    q = '{ v as var(func: eq(email, "up@x.io")) }'
    # insert when absent
    _, uids = client.txn().upsert(
        q, set_nquads='_:u <email> "up@x.io" .\n_:u <name> "first" .')
    assert "u" in uids
    # second run: cond-free update via uid(v)
    txn = client.txn()
    out, uids2 = txn.upsert(q, set_nquads='uid(v) <name> "second" .')
    assert uids2 == {}
    res = client.txn(read_only=True).query(
        '{ q(func: eq(email, "up@x.io")) { name } }')
    assert res == {"q": [{"name": "second"}]}


def test_grpc_conditional_upsert_cond_blocks(client):
    q = '{ v as var(func: eq(email, "up@x.io")) }'
    pb = tpb
    req = pb.Request(query=q, commit_now=True, mutations=[
        pb.Mutation(set_nquads=b'_:dup <email> "up@x.io" .',
                    cond="@if(eq(len(v), 0))")])
    resp = client._query(req, timeout=10)
    assert dict(resp.uids) == {}   # cond failed, no insert
    res = client.txn(read_only=True).query(
        '{ q(func: eq(email, "up@x.io")) { uid } }')
    assert len(res["q"]) == 1      # still exactly one


def test_multi_mutation_uids_all_returned(client):
    pb = tpb
    req = pb.Request(commit_now=True, mutations=[
        pb.Mutation(set_nquads=b'_:m1 <name> "m-one" .'),
        pb.Mutation(set_nquads=b'_:m2 <name> "m-two" .')])
    resp = client._query(req, timeout=10)
    assert set(resp.uids) == {"m1", "m2"}


# -- across packages -----------------------------------------------------------

def _program(pb, st):
    """The request sequence, built with one package's messages; `st` holds
    what earlier responses returned on this channel (open txns)."""
    yield "alter", pb.Operation(schema="name: string @index(exact) .\n"
                                       "age: int @index(int) .\n"
                                       "email: string @index(exact) "
                                       "@upsert .")
    yield "check", pb.Check()
    yield "query", pb.Request(commit_now=True, mutations=[pb.Mutation(
        set_nquads=b'_:a <name> "alice" .\n_:a <age> "30" .')])
    yield "query", pb.Request(commit_now=True, mutations=[pb.Mutation(
        set_json=json.dumps({"name": "dave", "age": 41}).encode())])
    yield "query", pb.Request(query='{ q(func: has(name)) { uid name age } }',
                              read_only=True)
    # a lazy txn: the query opens it, the mutation joins it, then commit
    yield "query", pb.Request(query='{ q(func: eq(name, "erin")) { name } }')
    yield "query", pb.Request(start_ts=st["ts"], mutations=[pb.Mutation(
        set_nquads=b'_:e <name> "erin" .')])
    yield "commit", pb.TxnContext(start_ts=st["ts"])
    # a conflicting pair: the second committer is refused
    yield "query", pb.Request(mutations=[pb.Mutation(
        set_nquads=b'<0x777> <name> "one" .')])
    st["t1"] = st["ts"]
    yield "query", pb.Request(mutations=[pb.Mutation(
        set_nquads=b'<0x777> <name> "two" .')])
    yield "commit", pb.TxnContext(start_ts=st["t1"])
    yield "commit", pb.TxnContext(start_ts=st["ts"])
    # a discarded txn leaves nothing behind
    yield "query", pb.Request(mutations=[pb.Mutation(
        set_nquads=b'_:c <name> "carol" .')])
    yield "commit", pb.TxnContext(start_ts=st["ts"], aborted=True)
    # upserts: insert when absent, then a cond that fails
    q = '{ v as var(func: eq(email, "up@x.io")) }'
    for _ in range(2):
        yield "query", pb.Request(query=q, commit_now=True, mutations=[
            pb.Mutation(set_nquads=b'_:u <email> "up@x.io" .\n'
                                   b'_:u <name> "first" .',
                        cond="@if(eq(len(v), 0))")])
    yield "query", pb.Request(query=q, commit_now=True, mutations=[
        pb.Mutation(set_nquads=b'uid(v) <name> "second" .')])
    yield "query", pb.Request(commit_now=True, mutations=[
        pb.Mutation(set_nquads=b'_:m1 <name> "m-one" .'),
        pb.Mutation(set_nquads=b'_:m2 <name> "m-two" .')])
    yield "query", pb.Request(query="{ not valid dql !!!", read_only=True)
    yield "alter", pb.Operation(drop_attr="age")
    yield "query", pb.Request(
        query="{ q(func: has(name), orderasc: name) { name age email } }",
        read_only=True)


def _drive(client_mod, pb, addr):
    """Run _program through client_mod's stubs; one outcome per step."""
    c = _ready(client_mod.DgraphClient(addr))
    calls = {"alter": c._alter, "check": c._version, "query": c._query,
             "commit": c._commit}
    st, out = {}, []
    try:
        for method, req in _program(pb, st):
            try:
                resp = calls[method](req, timeout=10)
            except grpc.RpcError as e:
                out.append((method, "error", e.code(), e.details()))
                continue
            if method == "query":
                st["ts"] = resp.txn.start_ts
                out.append((method, resp.json, sorted(resp.uids.items()),
                            resp.txn.start_ts, resp.txn.commit_ts,
                            resp.txn.aborted, list(resp.txn.keys),
                            list(resp.txn.preds)))
            else:
                out.append((method, resp.SerializeToString()))
    finally:
        c.close()
    return out


def test_cross_package_clients_and_servers_agree():
    """A JAX client against a port server and a port client against a JAX
    server give, step by step, the responses of the same-package pairs."""
    nodes, servers = [], []
    try:
        addrs = {}
        for name, mod, make in (
                ("jax", jserver, lambda: JNode(planner=False, batching=False,
                                               devprof=False)),
                ("jax2", jserver, lambda: JNode(planner=False,
                                                batching=False,
                                                devprof=False)),
                ("port", tserver, lambda: TNode(device="cpu")),
                ("port2", tserver, lambda: TNode(device="cpu"))):
            nodes.append(make())
            srv, port = mod.serve_grpc(nodes[-1], "localhost:0")
            servers.append(srv)
            addrs[name] = f"localhost:{port}"
        jj = _drive(jclient, jpb, addrs["jax"])
        tt = _drive(tclient, tpb, addrs["port"])
        jt = _drive(jclient, jpb, addrs["port2"])    # JAX client, port server
        tj = _drive(tclient, tpb, addrs["jax2"])     # port client, JAX server
        assert len(jj) == 21
        assert tt == jj
        assert jt == jj
        assert tj == jj
        # the program reached what it was written for
        codes = [r[2] for r in jj if r[1] == "error"]
        assert codes == [grpc.StatusCode.ABORTED,
                         grpc.StatusCode.INVALID_ARGUMENT]
        last = json.loads(jj[-1][1])["q"]
        assert [r["name"] for r in last] == [
            "alice", "dave", "erin", "m-one", "m-two", "one", "second"]
        assert all("age" not in r for r in last)
    finally:
        for srv in servers:
            srv.stop(0)
        for n in nodes:
            n.close()


def test_both_api_pb2_load_in_one_process():
    """The port's messages live in a private pool: both modules load in one
    process, in either order, keep the package name dgraph_tpu.api (the
    wire's method paths), and parse each other's bytes."""
    assert tpb.POOL is not jpb._descriptor_pool.Default()
    assert tpb.Request.DESCRIPTOR.full_name == "dgraph_tpu.api.Request"
    assert jpb.Request.DESCRIPTOR.full_name == "dgraph_tpu.api.Request"
    assert tserver.SERVICE == jserver.SERVICE == tclient.SERVICE == \
        "dgraph_tpu.api.Dgraph"
    req = tpb.Request(query="{ q(func: has(name)) { name } }", start_ts=7,
                      vars={"$a": "1"}, commit_now=True,
                      mutations=[tpb.Mutation(set_nquads=b"<0x1> <n> \"x\" .",
                                              cond="@if(eq(len(v), 0))")])
    wire = req.SerializeToString(deterministic=True)
    back = jpb.Request.FromString(wire)
    assert back.SerializeToString(deterministic=True) == wire
    assert tpb.Request.FromString(back.SerializeToString()) == req
    resp = jpb.Response(json=b'{"q": []}', uids={"a": 9},
                        txn=jpb.TxnContext(start_ts=3, commit_ts=4,
                                           preds=["name"]))
    assert tpb.Response.FromString(resp.SerializeToString()).SerializeToString(
        deterministic=True) == resp.SerializeToString(deterministic=True)
    for first, second in (("dgraph_tpu", "dgraph_tpu_torch"),
                          ("dgraph_tpu_torch", "dgraph_tpu")):
        code = (f"import {first}.protos.api_pb2 as a, "
                f"{second}.protos.api_pb2 as b\n"
                "w = a.Request(query='x', start_ts=2).SerializeToString()\n"
                "assert b.Request.FromString(w).start_ts == 2\n"
                "print(a.Request.DESCRIPTOR.full_name, "
                "b.Request.DESCRIPTOR.full_name)")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=str(REPO)),
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split() == ["dgraph_tpu.api.Request"] * 2
