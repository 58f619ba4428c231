"""The PyTorch port against tests/test_hedged.py: every case, with the port's
modules (workers and Node on device="cpu", the plain PyTorch versions).

Hedged remote reads + background health echo.

Reference: worker/task.go:75-132 processWithBackupRequest (grace-period
backup request to a second replica), conn/pool.go:153-186 Echo health loop.
Staleness guard: TaskRequest.min_applied makes a behind follower wait for
its applied per-tablet watermark or refuse (FAILED_PRECONDITION), so a
hedged read can never answer from a replica that missed a commit.
"""

import time

import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu_torch.parallel.remote import (HedgedReplicas, RemoteWorker,
                                        WorkerService)
from dgraph_tpu_torch.query import mutation as mut
from dgraph_tpu_torch.query import rdf
from dgraph_tpu_torch.query.task import TaskQuery
from dgraph_tpu_torch.storage.store import Store
from dgraph_tpu_torch.utils.schema import parse_schema


def _serve(svc):
    import concurrent.futures as _f

    server = grpc.server(_f.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((svc.handler(),))
    port = server.add_insecure_port("localhost:0")
    server.start()
    return server, f"localhost:{port}"


def _mk_pair(nquads):
    """Two identical stores behind live gRPC servers."""
    from dgraph_tpu_torch.coord.zero import UidLease
    from dgraph_tpu_torch.storage.postings import Op

    svcs, servers, addrs = [], [], []
    for _ in range(2):
        s = Store()
        for e in parse_schema("name: string @index(exact) .\nv: int ."):
            s.set_schema(e)
        edges = mut.to_edges(rdf.parse(nquads),
                             mut.assign_uids(rdf.parse(nquads), UidLease()),
                             Op.SET)
        touched, _, _ = mut.apply_mutations(s, edges, 1)
        s.commit(1, 2, touched)
        svc = WorkerService(s, device="cpu")
        server, addr = _serve(svc)
        svcs.append(svc)
        servers.append(server)
        addrs.append(addr)
    return svcs, servers, addrs


NQ = "\n".join(f'<0x{i:x}> <name> "p{i}" .' for i in range(1, 9))


def test_hedge_slow_primary_does_not_stall():
    svcs, servers, addrs = _mk_pair(NQ)
    real = svcs[0].serve_task

    def slow(msg, ctx):
        time.sleep(3.0)
        return real(msg, ctx)

    # handler() captured the bound method at registration — re-serve with
    # the slow wrapper bound first
    for s in servers:
        s.stop(0)
    svcs[0].serve_task = slow
    servers, addrs = [], []
    for svc in svcs:
        server, addr = _serve(svc)
        servers.append(server)
        addrs.append(addr)

    hr = HedgedReplicas(addrs)
    hr.HEDGE_GRACE = 0.15
    try:
        t0 = time.monotonic()
        # min_applied > 0: hedging engages (floor-less reads route to the
        # leader only and never hedge to possibly-stale followers)
        res = hr.process_task(TaskQuery("name", func=("eq", ["p3"])), 5,
                              min_applied=2)
        dt = time.monotonic() - t0
        assert list(res.dest_uids) == [3]
        assert dt < 2.0, f"hedge did not fire (took {dt:.1f}s)"
    finally:
        hr.close()
        for s in servers:
            s.stop(0)


def test_dead_replica_fails_over():
    svcs, servers, addrs = _mk_pair(NQ)
    hr = HedgedReplicas(addrs)
    hr.HEDGE_GRACE = 0.15
    try:
        servers[0].stop(0)        # primary dies
        res = hr.process_task(TaskQuery("name", func=("eq", ["p5"])), 5,
                              min_applied=2)
        assert list(res.dest_uids) == [5]
        # echo loop eventually marks it unhealthy and reroutes directly
        hr._poll_once()
        assert hr._ok == [False, True]
        assert hr._order()[0] == 1
    finally:
        hr.close()
        for s in servers:
            s.stop(0)


def test_min_applied_gate_blocks_behind_replica():
    """A follower missing a commit refuses (or waits out) a gated read."""
    svcs, servers, addrs = _mk_pair(NQ)
    rw = RemoteWorker(addrs[0])
    svcs[0].APPLIED_WAIT = 0.2
    try:
        # both stores applied commit_ts=2; a floor above that must block
        with pytest.raises(grpc.RpcError) as ei:
            rw.process_task(TaskQuery("name", func=("eq", ["p3"])), 5,
                            min_applied=99)
        assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        # at/below the applied watermark it serves fine
        res = rw.process_task(TaskQuery("name", func=("eq", ["p3"])), 5,
                              min_applied=2)
        assert list(res.dest_uids) == [3]
    finally:
        rw.close()
        for s in servers:
            s.stop(0)


def test_min_applied_gate_unblocks_when_caught_up():
    import threading

    svcs, servers, addrs = _mk_pair(NQ)
    rw = RemoteWorker(addrs[0])
    svcs[0].APPLIED_WAIT = 5.0
    store = svcs[0].store

    def catch_up():
        time.sleep(0.15)
        store.pred_commit_ts["name"] = 50
        # the replica-read gate blocks on the applied WaterMark now, not a
        # poll loop — advance it the way a real commit's _bump_pred_ts does
        store.applied_mark("name").set_done_until(50)

    try:
        threading.Thread(target=catch_up, daemon=True).start()
        res = rw.process_task(TaskQuery("name", func=("eq", ["p7"])), 5,
                              min_applied=50)
        assert list(res.dest_uids) == [7]
    finally:
        rw.close()
        for s in servers:
            s.stop(0)


def test_hedged_both_dead_raises():
    svcs, servers, addrs = _mk_pair(NQ)
    hr = HedgedReplicas(addrs)
    hr.HEDGE_GRACE = 0.1
    try:
        for s in servers:
            s.stop(0)
        with pytest.raises(Exception):
            hr.process_task(TaskQuery("name", func=("eq", ["p1"])), 5,
                            min_applied=2)
    finally:
        hr.close()


def test_floorless_read_routes_to_leader_only():
    """min_applied == 0 (cold cluster / Zero restart): never hedge to a
    follower whose staleness the gate cannot check."""
    svcs, servers, addrs = _mk_pair(NQ)
    svcs[1].is_leader = True      # replica 1 is the (status-visible) leader
    calls = []
    real = svcs[0].serve_task
    svcs[0].serve_task = lambda m, c: calls.append(1) or real(m, c)
    hr = HedgedReplicas(addrs)
    try:
        hr._poll_once()
        res = hr.process_task(TaskQuery("name", func=("eq", ["p2"])), 5)
        assert list(res.dest_uids) == [2]
        assert not calls, "floor-less read touched a non-leader replica"
    finally:
        hr.close()
        for s in servers:
            s.stop(0)


def test_wedged_floor_falls_back_to_leader():
    """Every replica behind an orphaned floor (lost Decide): reads serve
    the leader's best state instead of failing forever."""
    svcs, servers, addrs = _mk_pair(NQ)
    svcs[0].is_leader = True
    for svc in svcs:
        svc.APPLIED_WAIT = 0.1
    hr = HedgedReplicas(addrs)
    hr.HEDGE_GRACE = 0.05
    try:
        hr._poll_once()
        res = hr.process_task(TaskQuery("name", func=("eq", ["p4"])), 5,
                              min_applied=999)   # nobody ever applied this
        assert list(res.dest_uids) == [4]
    finally:
        hr.close()
        for s in servers:
            s.stop(0)


def test_hedge_never_fires_below_grace_budget():
    """with remaining budget < HEDGE_GRACE a hedge
    could never beat the deadline — the backup request must NOT fire
    (sequential failover within the budget instead)."""
    from dgraph_tpu_torch.utils import deadline as dl
    from dgraph_tpu_torch.utils.deadline import DeadlineExceeded

    svcs, servers, addrs = _mk_pair(NQ)
    real = svcs[0].serve_task

    def slow(msg, ctx):
        time.sleep(1.0)
        return real(msg, ctx)

    backup_calls = []
    real1 = svcs[1].serve_task
    for s in servers:
        s.stop(0)
    svcs[0].serve_task = slow
    svcs[1].serve_task = lambda m, c: backup_calls.append(1) or real1(m, c)
    servers, addrs = [], []
    for svc in svcs:
        server, addr = _serve(svc)
        servers.append(server)
        addrs.append(addr)

    hr = HedgedReplicas(addrs)
    hr.HEDGE_GRACE = 0.3
    try:
        t0 = time.monotonic()
        with dl.scope(0.15):          # budget < grace
            with pytest.raises((DeadlineExceeded, grpc.RpcError)):
                hr.process_task(TaskQuery("name", func=("eq", ["p3"])), 5,
                                min_applied=2)
        dt = time.monotonic() - t0
        assert dt < 0.8, f"wait was not deadline-bounded ({dt:.2f}s)"
        assert not backup_calls, "hedge fired below the grace budget"
        assert hr.metrics.counter("dgraph_hedge_fired_total").value == 0
    finally:
        hr.close()
        for s in servers:
            s.stop(0)


def test_hedge_counts_metric_when_it_fires():
    svcs, servers, addrs = _mk_pair(NQ)
    real = svcs[0].serve_task

    def slow(msg, ctx):
        time.sleep(1.0)
        return real(msg, ctx)

    for s in servers:
        s.stop(0)
    svcs[0].serve_task = slow
    servers, addrs = [], []
    for svc in svcs:
        server, addr = _serve(svc)
        servers.append(server)
        addrs.append(addr)
    hr = HedgedReplicas(addrs)
    hr.HEDGE_GRACE = 0.1
    try:
        res = hr.process_task(TaskQuery("name", func=("eq", ["p3"])), 5,
                              min_applied=2)
        assert list(res.dest_uids) == [3]
        assert hr.metrics.counter("dgraph_hedge_fired_total").value == 1
    finally:
        hr.close()
        for s in servers:
            s.stop(0)


def test_breaker_open_replica_is_skipped():
    """a replica whose circuit breaker is OPEN is
    routed around — fan-out does not pay its timeout per request — and
    half-open probes re-admit it once it recovers."""
    from dgraph_tpu_torch.utils.retry import CircuitBreaker

    svcs, servers, addrs = _mk_pair(NQ)
    calls = [0, 0]
    reals = [svc.serve_task for svc in svcs]

    def count(i):
        def h(m, c):
            calls[i] += 1
            return reals[i](m, c)
        return h

    for s in servers:
        s.stop(0)
    for i, svc in enumerate(svcs):
        svc.serve_task = count(i)
    servers, addrs = [], []
    for svc in svcs:
        server, addr = _serve(svc)
        servers.append(server)
        addrs.append(addr)
    hr = HedgedReplicas(addrs)
    hr.HEDGE_GRACE = 0.05
    try:
        # trip replica 0's breaker the way real traffic would: transport
        # failures recorded against it
        for _ in range(hr.BREAKER_FAILS):
            hr._record(0, False, e=ConnectionError("down"))
        assert hr.breakers[0].state == CircuitBreaker.OPEN
        assert hr.metrics.counter("dgraph_breaker_open_total").value == 1
        assert hr.metrics.keyed("dgraph_breaker_state").get(addrs[0]) == 2
        assert hr._order()[0] == 1      # open breaker demoted from primary
        before = calls[0]
        res = hr.process_task(TaskQuery("name", func=("eq", ["p5"])), 5,
                              min_applied=2)
        assert list(res.dest_uids) == [5]
        assert calls[0] == before, "breaker-open replica was still dialed"
        # recovery: after open_s the replica goes half-open (demoted
        # behind closed replicas in routing), and the Status echo loop is
        # the no-traffic probe that closes it
        hr.breakers[0]._opened_at -= (hr.BREAKER_OPEN_S + 1)
        assert hr.breakers[0].state == CircuitBreaker.HALF_OPEN
        assert hr._order()[0] == 1      # half-open: still not primary
        hr._poll_once()                 # echo succeeds -> breaker closes
        assert hr.breakers[0].state == CircuitBreaker.CLOSED
        assert hr._order()[0] == 0      # back to primary (it is idx 0)
        res = hr.process_task(TaskQuery("name", func=("eq", ["p6"])), 5,
                              min_applied=2)
        assert list(res.dest_uids) == [6]
    finally:
        hr.close()
        for s in servers:
            s.stop(0)


def test_deadline_errors_do_not_trip_breaker():
    """Caller-budget exhaustion is the budget's fault, not the
    replica's: neither the typed DeadlineExceeded nor a wire
    DEADLINE_EXCEEDED may open a healthy replica's breaker."""
    from dgraph_tpu_torch.utils.deadline import DeadlineExceeded
    from dgraph_tpu_torch.utils.retry import CircuitBreaker

    hr = HedgedReplicas(["localhost:9"])
    try:
        for _ in range(hr.BREAKER_FAILS + 2):
            hr._record(0, False, e=DeadlineExceeded("budget gone"))
        assert hr.breakers[0].state == CircuitBreaker.CLOSED
        for _ in range(hr.BREAKER_FAILS):
            hr._record(0, False, e=ConnectionError("real fault"))
        assert hr.breakers[0].state == CircuitBreaker.OPEN
    finally:
        hr.close()


def test_behind_replica_does_not_trip_breaker():
    """FAILED_PRECONDITION (replica behind the floor / not leader) is an
    application-level refusal, not a transport fault — it must never open
    the breaker and cut the replica out of routing."""
    from dgraph_tpu_torch.utils.retry import CircuitBreaker

    svcs, servers, addrs = _mk_pair(NQ)
    for svc in svcs:
        svc.APPLIED_WAIT = 0.05
    hr = HedgedReplicas(addrs)
    hr.HEDGE_GRACE = 0.05
    try:
        svcs[0].is_leader = True
        hr._poll_once()
        for _ in range(hr.BREAKER_FAILS + 1):
            res = hr.process_task(TaskQuery("name", func=("eq", ["p2"])),
                                  5, min_applied=999)   # wedged floor
            assert list(res.dest_uids) == [2]           # leader fallback
        assert all(b.state == CircuitBreaker.CLOSED for b in hr.breakers)
    finally:
        hr.close()
        for s in servers:
            s.stop(0)


def test_single_replica_behind_floor_retries_floorless():
    """a SINGLE-replica group whose sole
    replica reports FAILED_PRECONDITION after the applied-wait must get
    the same lost-Decide fallback the multi-replica path has — one retry
    with min_applied=0 — instead of surfacing the error to the client."""
    svcs, servers, addrs = _mk_pair(NQ)
    # sole replica: a one-address group
    svcs[0].APPLIED_WAIT = 0.1
    hr = HedgedReplicas(addrs[:1])
    try:
        res = hr.process_task(TaskQuery("name", func=("eq", ["p3"])), 5,
                              min_applied=999)   # floor nobody applied
        assert list(res.dest_uids) == [3]
    finally:
        hr.close()
        for s in servers:
            s.stop(0)
