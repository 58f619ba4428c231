"""The PyTorch port against tests/test_election.py: every case, with the port's
modules (workers and Node on device="cpu", the plain PyTorch versions).

Wire leader election: a replica set heals
its own leadership with a RequestVote-style ballot — no control plane.

Reference: conn/node.go:47-105 etcd-raft ballot + CheckQuorum;
worker/draft.go:485-624. Here the ballot rides the session-sequence
replication: heartbeats carry membership, silence triggers a campaign,
grants follow Raft's up-to-date rule on (max_commit_ts, log_len), and the
winner self-promotes through the same _become_leader path Promote uses.
"""

import time

import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu_torch.parallel.remote import RemoteWorker, WorkerService
from dgraph_tpu_torch.storage.store import Store
from dgraph_tpu_torch.storage.postings import Op
from dgraph_tpu_torch.storage import keys as K
from dgraph_tpu_torch.utils.schema import parse_schema


def _mk_trio(tmp_path, fast=True):
    import concurrent.futures as _f

    svcs, servers, addrs = [], [], []
    for i in range(3):
        store = Store(str(tmp_path / f"r{i}"))
        for e in parse_schema("v: int ."):
            store.set_schema(e)
        svc = WorkerService(store, device="cpu")
        if fast:
            svc.HEARTBEAT_S = 0.1
            svc.ELECTION_TIMEOUT_S = (0.4, 0.8)
        server = grpc.server(_f.ThreadPoolExecutor(max_workers=6))
        server.add_generic_rpc_handlers((svc.handler(),))
        port = server.add_insecure_port("localhost:0")
        server.start()
        svc.advertise_addr = f"localhost:{port}"
        svcs.append(svc)
        servers.append(server)
        addrs.append(f"localhost:{port}")
    return svcs, servers, addrs


def _write(addr, uid, ts):
    rw = RemoteWorker(addr)
    try:
        kb = K.data_key("v", uid)
        store_rec = rw  # noqa: F841
        # go through the Mutate RPC so the write rides the leader WAL path
        from dgraph_tpu_torch.storage.postings import DirectedEdge

        resp = rw.mutate(ts, [DirectedEdge(
            subject=uid, attr="v", object_uid=0,
            value=__import__("dgraph_tpu_torch.utils.types",
                             fromlist=["Val"]).Val(
                __import__("dgraph_tpu_torch.utils.types",
                           fromlist=["TypeID"]).TypeID.INT, 1),
            op=Op.SET)])
        rw.decide(ts, ts + 1, list(resp.keys))
    finally:
        rw.close()


def _leader_idx(svcs):
    return [i for i, s in enumerate(svcs) if s.is_leader]


def test_election_after_leader_death(tmp_path):
    svcs, servers, addrs = _mk_trio(tmp_path)
    rw = RemoteWorker(addrs[0])
    assert rw.promote(1, [addrs[1], addrs[2]]).ok
    rw.close()
    for svc in svcs:
        svc.enable_elections()
    # heartbeats propagate membership to followers
    deadline = time.monotonic() + 3
    while time.monotonic() < deadline:
        if all(len(s.group_members) == 3 for s in svcs[1:]):
            break
        time.sleep(0.05)
    assert all(len(s.group_members) == 3 for s in svcs[1:])

    _write(addrs[0], 1, ts=10)          # replicate something

    servers[0].stop(0)                   # SIGKILL-equivalent: leader gone
    svcs[0].stop_elections()
    svcs[0]._step_down()

    deadline = time.monotonic() + 6
    new_leader = None
    while time.monotonic() < deadline:
        up = [i for i in (1, 2) if svcs[i].is_leader]
        if up:
            new_leader = up[0]
            break
        time.sleep(0.05)
    assert new_leader is not None, "no replica won the ballot"
    assert svcs[new_leader].term > 1

    # the new leader serves writes through the quorum path
    _write(addrs[new_leader], 2, ts=20)
    follower = 3 - new_leader            # the other live replica
    deadline = time.monotonic() + 3
    while time.monotonic() < deadline:
        if svcs[follower].store.max_seen_commit_ts >= 21:
            break
        time.sleep(0.05)
    assert svcs[follower].store.max_seen_commit_ts >= 21

    for s in servers[1:]:
        s.stop(0)


def test_stale_candidate_loses(tmp_path):
    """A replica behind on applied state must not win the ballot."""
    svcs, servers, addrs = _mk_trio(tmp_path, fast=False)
    rw = RemoteWorker(addrs[0])
    assert rw.promote(1, [addrs[1], addrs[2]]).ok
    rw.close()
    for s in svcs:
        s.group_members = list(addrs)
    _write(addrs[0], 1, ts=10)
    # make replica 2 artificially ahead so 1's candidacy is rejected
    svcs[2].store.max_seen_commit_ts = 99

    r = RemoteWorker(addrs[2])
    try:
        got = r.vote(5, svcs[1].store.max_seen_commit_ts,
                     svcs[1].store.wal_record_count, addrs[1])
        assert not got.granted            # candidate behind receiver
        got = r.vote(6, 100, 10_000, addrs[1])
        assert got.granted                # up-to-date candidate wins
    finally:
        r.close()
    for s in servers:
        s.stop(0)


def test_no_campaign_without_membership(tmp_path):
    """A lone replica that never learned members must not loop ballots."""
    svcs, servers, addrs = _mk_trio(tmp_path)
    svcs[0].enable_elections()
    time.sleep(1.2)
    assert svcs[0].term == 0 and not svcs[0].is_leader
    for s in servers:
        s.stop(0)
