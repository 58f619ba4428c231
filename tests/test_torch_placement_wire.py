"""The PyTorch port against tests/test_placement.py: its wire cases (the
3-group `wire3` cluster), with the port's modules (workers and Node on
device="cpu", the plain PyTorch versions).

Self-driving shard placement: the decision core, the
embedded controller loop, the wire replica protocol, and the systest —
an adversarially skewed read-heavy workload on a 3-group cluster
self-heals below the utilization-spread threshold with byte-identical
results throughout, and --no_rebalance reproduces static placement."""

import json
import time

import pytest

from dgraph_tpu_torch.coord.placement import PlacementConfig, utilization

SCHEMA = """
    name: string @index(exact) .
    age: int @index(int) .
    follows: [uid] @reverse .
"""


# ---------------------------------------------------------------------------
# wire protocol: replica install / staleness routing / delta ship / drop
# ---------------------------------------------------------------------------

@pytest.fixture
def wire3():
    grpc = pytest.importorskip("grpc")  # noqa: F841
    from dgraph_tpu_torch.coord.zero import Zero
    from dgraph_tpu_torch.coord.zero_service import ZeroOps, serve_zero
    from dgraph_tpu_torch.parallel.client import ClusterClient
    from dgraph_tpu_torch.parallel.remote import serve_worker
    from dgraph_tpu_torch.storage.store import Store
    from dgraph_tpu_torch.utils.schema import parse_schema

    zero = Zero(3)
    zero.move_tablet("name", 0)
    zero.move_tablet("age", 1)
    zero.move_tablet("follows", 2)
    zsrv, zport, svc = serve_zero(zero, "localhost:0")
    stores, workers, addrs = [], [], []
    for g in range(3):
        s = Store()
        for e in parse_schema(SCHEMA):
            s.set_schema(e)
        stores.append(s)
        srv, port = serve_worker(s, "localhost:0", device="cpu")
        workers.append(srv)
        addrs.append(f"localhost:{port}")
        svc._members[g] = [addrs[g]]
    client = ClusterClient(f"localhost:{zport}",
                           {g: [addrs[g]] for g in range(3)})
    nq = []
    for i in range(20):
        nq.append(f'_:p{i} <name> "p{i}" .')
        nq.append(f'_:p{i} <age> "{20 + i}"^^<xs:int> .')
    for i in range(19):
        nq.append(f"_:p{i} <follows> _:p{i + 1} .")
    client.mutate(set_nquads="\n".join(nq))
    ops = ZeroOps(svc)
    yield zero, ops, client, workers, stores
    client.close()
    for w in workers:
        w.stop(0)
    zsrv.stop(0)


def _wire_query(client, q):
    client.task_cache.clear()         # force the wire (and the router)
    return json.dumps(client.query(q), sort_keys=True)


def test_wire_replica_serves_and_stale_routes_to_primary(wire3):
    """Satellite: a replica behind the primary's applied watermark must
    route back to the primary (FAILED_PRECONDITION path), never serve
    stale; after the delta ship it serves again."""
    zero, ops, client, workers, stores = wire3
    q = '{ q(func: eq(name, "p3")) { name age } }'
    golden = _wire_query(client, q)
    out = ops.install_replica("name", 2)
    assert out["installed_records"] > 0
    assert 2 in zero.replica_holders("name")

    # spread: the holder serves some 'name' tasks, byte-identical
    for _ in range(8):
        assert _wire_query(client, q) == golden
    holder_loads = workers[2].dgt_svc.tablet_load_snapshot()
    assert holder_loads.get("name", {}).get("r", 0) > 0
    assert client.metrics.counter("dgraph_replica_reads_total").value > 0

    # a write makes the replica stale: reads MUST fall back to the
    # primary and see the new value immediately
    client.mutate(set_nquads='_:x <name> "fresh" .')
    fb0 = client.metrics.counter("dgraph_replica_fallbacks_total").value
    for _ in range(4):
        client.task_cache.clear()
        r = client.query('{ q(func: eq(name, "fresh")) { name } }')
        assert r["q"] == [{"name": "fresh"}], r
    assert client.metrics.counter(
        "dgraph_replica_fallbacks_total").value > fb0

    # freshness ship: the O(Δ) journal rewrite catches the holder up and
    # it serves the NEW value byte-identically
    out = ops.ship_replica_delta("name", 2)
    assert out["shipped_records"] > 0
    new_golden = _wire_query(client, '{ q(func: eq(name, "fresh")) '
                                     '{ name } }')
    r0 = client.metrics.counter("dgraph_replica_reads_total").value
    for _ in range(8):
        assert _wire_query(client, '{ q(func: eq(name, "fresh")) '
                                   '{ name } }') == new_golden
    assert client.metrics.counter(
        "dgraph_replica_reads_total").value > r0

    # demotion: routing collapses to the primary, results unchanged
    assert ops.drop_replica("name", 2)
    assert "name" not in stores[2].predicates()
    assert _wire_query(client, q) != ""      # still answers
    assert zero.replica_holders("name") == {}


def test_wire_move_drops_replicas_first(wire3):
    zero, ops, client, workers, stores = wire3
    q = '{ q(func: eq(name, "p3")) { name } }'
    golden = _wire_query(client, q)
    ops.install_replica("name", 1)
    out = ops.move_tablet("name", 1)         # move INTO the holder group
    assert out["tablet"] == "name"
    assert zero.tablets()["name"] == 1
    assert zero.replica_holders("name") == {}
    assert _wire_query(client, q) == golden


def test_wire_status_carries_tablet_load(wire3):
    zero, ops, client, workers, stores = wire3
    _wire_query(client, '{ q(func: eq(name, "p3")) { name } }')
    from dgraph_tpu_torch.parallel.remote import RemoteWorker

    rw = RemoteWorker(client.replicas[0].addrs[0])
    try:
        st = rw.status()
        loads = json.loads(st.tablet_load_json)
    finally:
        rw.close()
    assert loads.get("name", {}).get("r", 0) >= 1
    assert {"r", "w", "b", "d"} <= set(loads["name"])


def test_wire_systest_zipfian_self_heal(wire3):
    """Acceptance systest: adversarially skewed (Zipfian, read-heavy)
    load on a 3-group wire cluster; the controller converges utilization
    spread below threshold within a bounded number of ticks, with every
    sampled result byte-identical through moves/replica transitions."""
    import random

    from dgraph_tpu_torch.coord.placement import (PlacementController,
                                            ZeroOpsExecutor, wire_collect)

    zero, ops, client, workers, stores = wire3
    rng = random.Random(20260803)
    battery = {
        "name": '{ q(func: eq(name, "p%d")) { name } }',
        "age": '{ q(func: ge(age, %d)) { age } }',
        "follows": '{ q(func: has(follows), first: %d) { uid } }',
    }
    goldens = {}
    for i in range(6):
        goldens[("name", i)] = _wire_query(client, battery["name"] % i)
    goldens[("age", 30)] = _wire_query(client, battery["age"] % 30)
    goldens[("follows", 3)] = _wire_query(client, battery["follows"] % 3)

    def zipf_round(n=60):
        # ~85% of traffic hammers the 'name' tablet (rank-1 of a Zipfian),
        # the rest trickles to the others — the one-hot-predicate shape
        for _ in range(n):
            r = rng.random()
            if r < 0.85:
                i = rng.randrange(6)
                assert _wire_query(client,
                                   battery["name"] % i) == goldens[
                                       ("name", i)]
            elif r < 0.93:
                assert _wire_query(client,
                                   battery["age"] % 30) == goldens[
                                       ("age", 30)]
            else:
                assert _wire_query(client,
                                   battery["follows"] % 3) == goldens[
                                       ("follows", 3)]

    cfg = PlacementConfig(threshold=0.6, persist_ticks=1, cooldown_s=0.0,
                          max_replicas=2, min_rate=0.5)
    ctl = PlacementController(zero, wire_collect(ops),
                              ZeroOpsExecutor(ops), cfg=cfg)
    ctl.tick()                                # primes counters
    actions = []
    healed = False
    for _tick in range(8):
        time.sleep(0.05)                      # a real dt for the rates
        zipf_round()
        act = ctl.tick()
        if act is not None:
            actions.append(act)
        if actions and ctl.last_diag.get("spread", 1.0) <= cfg.threshold:
            healed = True
            break
    assert actions, "controller never acted"
    assert healed, (ctl.last_diag, actions)
    # the hot tablet grew replicas (read-heavy skew => replication, and
    # reads actually spread: holders show serve counts)
    holders = zero.replica_holders("name")
    assert holders, actions
    served = sum(workers[g].dgt_svc.tablet_load_snapshot()
                 .get("name", {}).get("r", 0) for g in holders)
    assert served > 0
    # one more full round stays byte-identical in the healed layout
    zipf_round(30)
