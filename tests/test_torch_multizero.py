"""The PyTorch port against tests/test_multizero.py: every case, with the
port's modules (workers and Node on device="cpu", the plain PyTorch
versions).

Multi-zero replication + election.

Three ZeroService instances with ZeroReplica roles: the leader quorum-ships
its durable state on every persist, standbys reject coordination RPCs,
clients rotate transparently, and when the leader dies a standby wins the
ballot, recovers Zero from the replicated state, and serves — lease
ceilings guarantee no ts/uid reuse across the failover (assign.go
semantics: at most one lease block burns)."""

import time

import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu_torch.coord.zero import Zero
from dgraph_tpu_torch.protos import internal_pb2 as ipb
from dgraph_tpu_torch.coord.zero_service import (ZeroClient, ZeroReplica,
                                           ZeroService, serve_zero)


def _mk_zeros(tmp_path, n=3, fast=True):
    # two-phase: bind ports first so every replica knows the full member set
    import socket

    socks, addrs = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        addrs.append(f"127.0.0.1:{s.getsockname()[1]}")
        socks.append(s)
    for s in socks:
        s.close()

    svcs, servers, reps = [], [], []
    for i in range(n):
        d = str(tmp_path / f"z{i}")
        import os

        os.makedirs(d, exist_ok=True)
        zero = Zero(n_groups=1, dirpath=d)
        svc = ZeroService(zero)
        rep = ZeroReplica(svc, d, addrs[i], addrs, bootstrap_leader=i == 0)
        if fast:
            rep.PING_S = 0.1
            rep.ELECTION_TIMEOUT_S = (0.4, 0.8)
        server, _port, svc = serve_zero(zero, addrs[i], svc=svc)
        rep.start()
        svcs.append(svc)
        servers.append(server)
        reps.append(rep)
    return svcs, servers, reps, addrs


def test_standby_rejects_and_client_rotates(tmp_path):
    svcs, servers, reps, addrs = _mk_zeros(tmp_path)
    try:
        # direct call to a standby fails with FAILED_PRECONDITION
        standby = ZeroClient(addrs[1])
        with pytest.raises(grpc.RpcError) as ei:
            standby.new_txn()
        assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        standby.close()
        # a rotating client pointed at a standby first still succeeds
        c = ZeroClient(",".join([addrs[1], addrs[0]]))
        ts = c.new_txn()
        assert ts > 0
        c.close()
    finally:
        for s in servers:
            s.stop(0)
        for r in reps:
            r.stop()


def test_zero_failover_preserves_lease_ceilings(tmp_path):
    svcs, servers, reps, addrs = _mk_zeros(tmp_path)
    try:
        c = ZeroClient(",".join(addrs))
        ts1 = c.timestamps(5)
        uid1 = c.assign_uids(7)
        assert ts1 > 0 and uid1 > 0
        # ships reached the standbys
        deadline = time.monotonic() + 3
        while time.monotonic() < deadline:
            if all(r.seq > 0 for r in reps[1:]):
                break
            time.sleep(0.05)
        assert all(r.seq > 0 for r in reps[1:])

        servers[0].stop(0)         # kill the zero leader
        reps[0].stop()
        reps[0].is_leader = False

        deadline = time.monotonic() + 6
        new = None
        while time.monotonic() < deadline:
            up = [i for i in (1, 2) if reps[i].is_leader]
            if up:
                new = up[0]
                break
            time.sleep(0.05)
        assert new is not None, "no standby won the zero ballot"

        # the rotating client keeps working; leases never go backwards
        ts2 = c.timestamps(1)
        uid2 = c.assign_uids(1)
        assert ts2 > ts1
        assert uid2 > uid1
        c.close()
    finally:
        for s in servers:
            s.stop(0)
        for r in reps:
            r.stop()


def test_single_zero_mode_unaffected(tmp_path):
    """No replica attached: handlers serve as before (no leader gate)."""
    zero = Zero(n_groups=1)
    server, port, _svc = serve_zero(zero, "127.0.0.1:0")
    try:
        c = ZeroClient(f"127.0.0.1:{port}")
        assert c.new_txn() > 0
        c.close()
    finally:
        server.stop(0)


def test_standby_adopts_newer_term_ship_with_lower_seq(tmp_path):
    """a standby that alone received a
    quorum-failed ship (inflated seq) must accept a strictly-newer term's
    full-state replace and ADOPT the leader's lower seq — the old
    `msg.seq < self.seq` check rejected every subsequent ship and let the
    standby later resurrect the unacked state by winning an election."""
    import os

    d = str(tmp_path / "zs")
    os.makedirs(d, exist_ok=True)
    svc = ZeroService(Zero(n_groups=1))
    rep = ZeroReplica(svc, d, "127.0.0.1:1", ["127.0.0.1:1"],
                      bootstrap_leader=False)
    # term-1 leader ships seq 5 — then dies before quorum-acking it
    r = rep.zero_ship(ipb.ZeroShipRequest(term=1, seq=5,
                                          state_json="{\"a\":1}"), None)
    assert r.ok and rep.seq == 5
    # same-term stale re-ship still rejected
    r = rep.zero_ship(ipb.ZeroShipRequest(term=1, seq=3,
                                          state_json="{}"), None)
    assert not r.ok
    # the NEW term-2 leader (elected without the unacked seq-5 state)
    # ships its full state at seq 1: must be accepted, seq adopted
    r = rep.zero_ship(ipb.ZeroShipRequest(term=2, seq=1,
                                          state_json="{\"b\":2}"), None)
    assert r.ok and rep.term == 2 and rep.seq == 1
    with open(os.path.join(d, "zero_state.json")) as f:
        assert f.read() == "{\"b\":2}"
    # a vote request keyed on the adopted seq no longer out-ranks peers
    v = rep.zero_vote(ipb.ZeroVoteRequest(term=3, seq=1,
                                          candidate="x"), None)
    assert v.granted
