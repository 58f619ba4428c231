"""The PyTorch port against tests/test_replication.py: every case, with the
port's modules (workers and Node on device="cpu", the plain PyTorch
versions).

Replication contract: quorum WAL shipping, leader failover, catch-up.

3-node in-process cluster — write, kill leader,
fail over, read: the bank invariant holds and nothing committed is lost.
Reference: worker/draft.go:190/:485-624, conn/node.go:47-105,
raftwal/wal.go:31, retrieveSnapshot :452; the bank hammer mirrors
contrib/integration/bank.
"""

import numpy as np
import pytest

from dgraph_tpu_torch.coord.replication import NoQuorum, ReplicaGroup, StaleLeader
from dgraph_tpu_torch.coord.zero import TxnConflict

N_ACCOUNTS = 8
START = 100


def _seed_bank(node):
    node.alter(schema_text="bal: int .\nacct: string @index(exact) .")
    quads = [f'<0x{i:x}> <acct> "a{i}" .\n<0x{i:x}> <bal> "{START}"^^<xs:int> .'
             for i in range(1, N_ACCOUNTS + 1)]
    node.mutate(set_nquads="\n".join(quads), commit_now=True)


def _balances(node) -> dict[int, int]:
    out, _ = node.query('{ q(func: has(acct)) { uid bal } }')
    return {int(r["uid"], 16): r["bal"] for r in out.get("q", [])}


def _transfer(node, rng) -> bool:
    a, b = rng.choice(np.arange(1, N_ACCOUNTS + 1), size=2, replace=False)
    ctx = node.new_txn()
    try:
        bals = _balances(node)
        amt = int(rng.integers(1, 20))
        node.mutate(
            set_nquads=f'<0x{a:x}> <bal> "{bals[int(a)] - amt}"^^<xs:int> .\n'
                       f'<0x{b:x}> <bal> "{bals[int(b)] + amt}"^^<xs:int> .',
            start_ts=ctx.start_ts)
        node.commit(ctx.start_ts)
        return True
    except TxnConflict:
        return False


def test_kill_leader_loses_nothing(tmp_path):
    g = ReplicaGroup(str(tmp_path), n=3, device="cpu")
    _seed_bank(g.node)
    rng = np.random.default_rng(3)
    for _ in range(25):
        _transfer(g.node, rng)
    before = _balances(g.node)
    assert sum(before.values()) == N_ACCOUNTS * START

    old_leader = g.leader_id
    g.kill(old_leader)                       # crash the primary
    assert g.leader_id != old_leader
    after = _balances(g.node)
    assert after == before, "committed state lost in failover"

    # the promoted leader keeps serving writes (quorum 2/3 still alive)
    for _ in range(10):
        _transfer(g.node, rng)
    assert sum(_balances(g.node).values()) == N_ACCOUNTS * START
    g.close()


def test_second_leader_loss_breaks_quorum(tmp_path):
    g = ReplicaGroup(str(tmp_path), n=3, device="cpu")
    _seed_bank(g.node)
    g.kill(g.leader_id)
    with pytest.raises(NoQuorum):
        g.kill(g.leader_id)                  # 1 live member < quorum 2


def test_follower_loss_then_writes_then_rejoin(tmp_path):
    g = ReplicaGroup(str(tmp_path), n=3, device="cpu")
    _seed_bank(g.node)
    rng = np.random.default_rng(9)
    dead = next(m.id for m in g.members if m.id != g.leader_id)
    g.kill(dead)                             # follower down: 2/3 still quorum
    for _ in range(10):
        _transfer(g.node, rng)
    snapshot_bals = _balances(g.node)

    g.rejoin(dead)                           # snapshot + tail catch-up
    # fail over onto the rejoined member's cohort: kill the leader, the
    # promoted member must carry everything incl. post-outage commits
    g.kill(g.leader_id)
    assert _balances(g.node) == snapshot_bals
    assert sum(_balances(g.node).values()) == N_ACCOUNTS * START
    g.close()


def test_no_quorum_blocks_commits(tmp_path):
    g = ReplicaGroup(str(tmp_path), n=3, device="cpu")
    _seed_bank(g.node)
    for m in g.members:
        if m.id != g.leader_id:
            g.kill(m.id)                     # both followers down
    with pytest.raises(NoQuorum):
        g.node.mutate(set_nquads='<0x1> <bal> "1"^^<xs:int> .',
                      commit_now=True)
    g.close()


def test_stale_leader_fenced(tmp_path):
    g = ReplicaGroup(str(tmp_path), n=3, device="cpu")
    _seed_bank(g.node)
    # a member observes a newer term (as if another leader was elected)
    for m in g.members:
        if m.id != g.leader_id:
            m.set_term(g.term + 1)
            break
    with pytest.raises(StaleLeader):
        g.node.mutate(set_nquads='<0x1> <bal> "0"^^<xs:int> .',
                      commit_now=True)
    g.close()


def test_single_replica_degenerate(tmp_path):
    g = ReplicaGroup(str(tmp_path), n=1, device="cpu")
    _seed_bank(g.node)
    assert sum(_balances(g.node).values()) == N_ACCOUNTS * START
    g.close()


# -- hedged reads (worker/task.go:75-132 backup requests) --------------------

def _mk_read_group(tmp_path, n=3):
    from dgraph_tpu_torch.coord.replication import ReplicaGroup
    g = ReplicaGroup(str(tmp_path / "grp"), n=n, serve_reads=True, device="cpu")
    g.node.alter(schema_text="name: string @index(exact) .\nbal: int .")
    g.node.mutate(set_nquads='_:a <name> "hedge" .\n_:a <bal> "10" .',
                  commit_now=True)
    return g


def test_fast_leader_serves_read(tmp_path):
    g = _mk_read_group(tmp_path)
    g.node.query('{ q(func: eq(name, "hedge")) { bal } }')  # warm the snapshot
    src, out = g.read('{ q(func: eq(name, "hedge")) { bal } }', hedge_after=5)
    assert src == "leader" and out["q"][0]["bal"] == 10
    assert g.hedged_reads == 0
    g.close()


def test_slow_leader_hedges_to_follower(tmp_path):
    import time as _time
    g = _mk_read_group(tmp_path)
    real_query = g.node.query

    def slow_query(*a, **kw):
        _time.sleep(0.5)
        return real_query(*a, **kw)

    g.node.query = slow_query
    t0 = _time.perf_counter()
    src, out = g.read('{ q(func: eq(name, "hedge")) { bal } }',
                      hedge_after=0.02)
    dt = _time.perf_counter() - t0
    assert src.startswith("follower")
    assert out["q"][0]["bal"] == 10       # quorum-acked data is visible
    assert dt < 0.45                      # did not wait for the slow leader
    assert g.hedged_reads == 1
    g.close()


def test_dead_leader_read_from_follower(tmp_path):
    g = _mk_read_group(tmp_path)
    # mark dead WITHOUT failover (the window before election completes)
    g.members[g.leader_id].alive = False
    src, out = g.read('{ q(func: eq(name, "hedge")) { bal } }')
    assert src.startswith("follower")
    assert out["q"][0]["bal"] == 10
    g.close()


def test_follower_reader_tracks_new_commits(tmp_path):
    g = _mk_read_group(tmp_path)
    g.node.mutate(set_nquads='_:b <name> "late" .', commit_now=True)
    fid = next(m.id for m in g._followers() if m.reader is not None)
    out = g.members[fid].reader.query('{ q(func: eq(name, "late")) { name } }')
    assert out == {"q": [{"name": "late"}]}
    g.close()


def test_rejoined_member_reader_reseeds(tmp_path):
    g = _mk_read_group(tmp_path)
    victim = next(m.id for m in g._followers())
    g.kill(victim)
    g.node.mutate(set_nquads='_:c <name> "while-dead" .', commit_now=True)
    g.rejoin(victim)
    out = g.members[victim].reader.query(
        '{ q(func: eq(name, "while-dead")) { name } }')
    assert out == {"q": [{"name": "while-dead"}]}
    g.close()


def test_read_raises_when_nothing_can_serve(tmp_path):
    from dgraph_tpu_torch.coord.replication import NoQuorum, ReplicaGroup
    g = ReplicaGroup(str(tmp_path / "g2"), n=3, device="cpu")   # serve_reads=False
    g.members[g.leader_id].alive = False
    with pytest.raises(NoQuorum):
        g.read("{ q(func: has(name)) { name } }")
    g.close()


def test_follower_sees_shipped_predicate_drop(tmp_path):
    g = _mk_read_group(tmp_path)
    fid = next(m.id for m in g._followers() if m.reader is not None)
    rd = g.members[fid].reader
    assert rd.query('{ q(func: has(name)) { name } }')["q"]
    g.node.store.delete_predicate("name")   # ships a "dp" record
    assert rd.query('{ q(func: has(name)) { name } }') == {}
    g.close()
