"""The PyTorch port against tests/test_zero_durability.py: every case, with the
port's modules (workers and Node on device="cpu", the plain PyTorch
versions).

Zero coordinator durability (reference assign.go:65-125 lease blocks +
Raft-persisted tablet map): a restarted Zero must never re-issue a
timestamp or uid it could already have handed out, and keeps its tablet
assignments; a crash skips at most one lease block."""


from dgraph_tpu_torch.coord.zero import LEASE_BLOCK, Zero


def test_restart_never_reissues_leases(tmp_path):
    d = str(tmp_path / "z")
    z = Zero(n_groups=2, dirpath=d)
    issued_ts = [z.oracle.new_txn().start_ts for _ in range(5)]
    issued_ts.append(z.oracle.timestamps(3))
    s, e = z.uids.assign(1000)
    assert z.should_serve("name") in (0, 1)
    z.move_tablet("age", 1)
    g_name = z.tablets()["name"]

    z2 = Zero(n_groups=2, dirpath=d)
    # monotonic past everything possibly issued (may burn <= one block)
    nt = z2.oracle.new_txn().start_ts
    assert nt > max(issued_ts)
    assert nt <= max(issued_ts) + 2 * LEASE_BLOCK
    s2, _ = z2.uids.assign(10)
    assert s2 > e
    # tablet map survived
    assert z2.tablets() == {"name": g_name, "age": 1}


def test_restart_after_many_blocks(tmp_path):
    d = str(tmp_path / "z")
    z = Zero(dirpath=d)
    # cross several persist blocks
    last = 0
    for _ in range(5):
        last = z.oracle.timestamps(LEASE_BLOCK // 2 + 7)
    hw = z.oracle.max_assigned
    z2 = Zero(dirpath=d)
    assert z2.oracle.new_txn().start_ts > hw


def test_memory_only_zero_unchanged():
    z = Zero()
    a = z.oracle.new_txn().start_ts
    b = z.oracle.new_txn().start_ts
    assert b == a + 1


def test_commit_ts_covered_by_ceiling(tmp_path):
    """Commit timestamps also cross the persisted ceiling (review r4: the
    commit mutator must be covered, not just new_txn/timestamps)."""
    import json
    import os

    d = str(tmp_path / "z")
    z = Zero(dirpath=d)
    # drive max_assigned right up to the ceiling using commits only
    sts = [z.oracle.new_txn() for _ in range(8)]
    for st in sts:
        z.oracle.track(st.start_ts, [b"k%d" % st.start_ts])
    commit_ts = [z.oracle.commit(st.start_ts) for st in sts]
    with open(os.path.join(d, "zero_state.json")) as f:
        ceiling = json.load(f)["ts_ceiling"]
    assert ceiling > max(commit_ts)
    z2 = Zero(dirpath=d)
    assert z2.oracle.new_txn().start_ts > max(commit_ts)


def test_double_restart_keeps_ceilings(tmp_path):
    """A restart that issues NOTHING before the next crash must still
    protect everything the previous incarnation issued (review r4: the
    restored ceilings were written back as 0)."""
    d = str(tmp_path / "z")
    z = Zero(dirpath=d)
    issued = [z.oracle.new_txn().start_ts for _ in range(3)]
    z.uids.assign(50)
    z2 = Zero(dirpath=d)      # restart 1: serves nothing
    z3 = Zero(dirpath=d)      # restart 2
    assert z3.oracle.new_txn().start_ts > max(issued)
    s, _ = z3.uids.assign(1)
    assert s > 50
