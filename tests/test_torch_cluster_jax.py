"""The embedded cluster, its replicas, Zero and the hedged reads across
packages: the PyTorch port against the JAX package on the same seeded
inputs, on the CPU.

tests/test_torch_{cluster,replication,hedged,election,multizero,
zero_durability,live_cluster}.py run the JAX cases on the port alone. Here
each deterministic outcome is computed by both packages from the same
inputs and compared: the federated answers (byte-identical JSON, key order
included), the uid maps, the tablet maps and sizes, the move, rebalance and
replica reports, the placement controller's actions under one fake clock,
the commit/abort outcomes, the live-query events, the replica group's
failovers and follower reads, Zero's leases across restarts and the
ballot's tally. Where the wire is involved, records and results cross the
package boundary: a follower reader of one package applies the other's
shipped WAL records, a hedged client of one package reads from the
other's workers, and a Zero trio mixes the packages.
"""

import json
import os
import time

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu.coord import cluster as jcl
from dgraph_tpu.coord import placement as jpl
from dgraph_tpu.coord import replication as jrep
from dgraph_tpu.coord import zero as jzero
from dgraph_tpu.coord import zero_service as jzs
from dgraph_tpu.parallel import remote as jremote
from dgraph_tpu.query import mutation as jmut
from dgraph_tpu.query import rdf as jrdf
from dgraph_tpu.query import task as jtask
from dgraph_tpu.storage import keys as jK
from dgraph_tpu.storage import postings as jpost
from dgraph_tpu.storage import store as jstore
from dgraph_tpu.utils import ballot as jballot
from dgraph_tpu.utils import schema as jschema

from dgraph_tpu_torch.coord import cluster as tcl
from dgraph_tpu_torch.coord import placement as tpl
from dgraph_tpu_torch.coord import replication as trep
from dgraph_tpu_torch.coord import zero as tzero
from dgraph_tpu_torch.coord import zero_service as tzs
from dgraph_tpu_torch.parallel import remote as tremote
from dgraph_tpu_torch.query import mutation as tmut
from dgraph_tpu_torch.query import rdf as trdf
from dgraph_tpu_torch.query import task as ttask
from dgraph_tpu_torch.storage import keys as tK
from dgraph_tpu_torch.storage import postings as tpost
from dgraph_tpu_torch.storage import store as tstore
from dgraph_tpu_torch.utils import ballot as tballot
from dgraph_tpu_torch.utils import schema as tschema

from test_torch_wire import BATTERY, SCHEMA, TABLETS, _graph_quads

PKG = {
    "j": dict(cl=jcl, pl=jpl, rep=jrep, zero=jzero, zs=jzs, remote=jremote,
              mut=jmut, rdf=jrdf, task=jtask, K=jK, post=jpost,
              store=jstore, ballot=jballot, schema=jschema, kw={}),
    "t": dict(cl=tcl, pl=tpl, rep=trep, zero=tzero, zs=tzs, remote=tremote,
              mut=tmut, rdf=trdf, task=ttask, K=tK, post=tpost,
              store=tstore, ballot=tballot, schema=tschema,
              kw={"device": "cpu"}),
}


def _dump(obj) -> str:
    return json.dumps(obj)


def _cluster(p, schema=SCHEMA, tablets=TABLETS, n_groups=2):
    c = PKG[p]["cl"].Cluster(n_groups=n_groups, **PKG[p]["kw"])
    c.alter(schema)
    for attr, g in (tablets or {}).items():
        c.zero.move_tablet(attr, g)
    return c


def _both(fn):
    """fn(package) for the JAX package and the port; asserts the two
    results serialize to the same JSON and returns the JAX one."""
    j, t = fn("j"), fn("t")
    assert _dump(t) == _dump(j)
    return j


def _outcome(fn):
    try:
        return ["ok", fn()]
    except Exception as e:    # noqa: BLE001 — the outcome is compared
        return ["raised", type(e).__name__]


def _battery(c) -> list:
    """Each battery query's JSON, or the error it raised (a schedule that
    renames p3 leaves the shortest-path query without an endpoint)."""
    return [_outcome(lambda q=q: _dump(c.query(q))) for q in BATTERY]


def _keys(store, K, attr) -> dict[str, list[str]]:
    return {kind.name: sorted(kb.hex() for kb in store.keys_of(kind, attr))
            for kind in (K.KeyKind.DATA, K.KeyKind.REVERSE, K.KeyKind.INDEX,
                         K.KeyKind.COUNT)}


# -- the embedded Cluster: loads and federated answers -----------------------

@pytest.fixture(scope="module")
def loaded():
    """A JAX and a port Cluster, tablets pinned as test_torch_wire pins
    them, loaded with the same seeded graph; the uid map each load gave."""
    cs = {p: _cluster(p) for p in "jt"}
    maps = {p: cs[p].mutate(set_nquads=_graph_quads()) for p in "jt"}
    yield cs, maps
    for c in cs.values():
        c.close()


def test_cluster_load_equals_jax(loaded):
    cs, maps = loaded
    assert maps["t"] == maps["j"]
    assert cs["t"].zero.tablets() == cs["j"].zero.tablets() == TABLETS
    for g in range(2):
        assert cs["t"].stores[g].tablet_sizes() == \
            cs["j"].stores[g].tablet_sizes()


@pytest.mark.parametrize("i", range(len(BATTERY)))
def test_cluster_federated_answer_equals_jax(loaded, i):
    cs, _ = loaded
    want = _dump(cs["j"].query(BATTERY[i]))
    assert _dump(cs["t"].query(BATTERY[i])) == want


def test_cluster_claims_equal_jax():
    """Unpinned: the load-balanced claims put every tablet on the same
    group in both packages, and the answers agree."""
    cs = {p: _cluster(p, tablets=None) for p in "jt"}
    try:
        for p in "jt":
            cs[p].mutate(set_nquads=_graph_quads(seed=5, n=24))
        assert cs["t"].zero.tablets() == cs["j"].zero.tablets()
        assert len(set(cs["j"].zero.tablets().values())) == 2
        assert _battery(cs["t"]) == _battery(cs["j"])
    finally:
        for c in cs.values():
            c.close()


# -- moves, replicas, rebalance, the placement controller --------------------

@pytest.mark.parametrize("attr", sorted(TABLETS))
def test_move_predicate_report_equals_jax(attr):
    cs = {p: _cluster(p) for p in "jt"}
    try:
        for p in "jt":
            cs[p].mutate(set_nquads=_graph_quads(n=24))
        dst = 1 - TABLETS[attr]
        reports = {p: cs[p].move_predicate(attr, dst) for p in "jt"}
        assert reports["t"] == reports["j"]
        assert reports["j"]["moved_keys"] > 0
        assert cs["t"].zero.tablets() == cs["j"].zero.tablets()
        for g in range(2):
            assert _keys(cs["t"].stores[g], tK, attr) == \
                _keys(cs["j"].stores[g], jK, attr)
        assert _battery(cs["t"]) == _battery(cs["j"])
        # a second move to the same group is a no-op in both
        assert cs["t"].move_predicate(attr, dst) == \
            cs["j"].move_predicate(attr, dst)
    finally:
        for c in cs.values():
            c.close()


def _open_write(c, P, nquads):
    """A txn buffered on every group it touches, left open."""
    st = c.zero.oracle.new_txn()
    edges = P["mut"].to_edges(P["rdf"].parse(nquads), {}, P["post"].Op.SET)
    keys, conflicts, preds = {}, [], set()
    for g, ge in P["mut"].split_edges_by_group(edges, len(c.stores),
                                                c.group_of).items():
        touched, confl, pr = P["mut"].apply_mutations(c.stores[g], ge,
                                                      st.start_ts)
        keys[g] = touched
        conflicts += confl
        preds |= pr
    c.zero.oracle.track(st.start_ts, conflicts, sorted(preds))
    c._txn_keys[st.start_ts] = keys
    return st.start_ts


def test_move_aborts_open_txns_equal_jax():
    def run(p):
        c = _cluster(p)
        try:
            c.mutate(set_nquads=_graph_quads(n=24))
            ts = _open_write(c, PKG[p], '<0x1> <age> "99"^^<xs:int> .')
            report = c.move_predicate("age", 1)
            late = _outcome(lambda: c.commit(ts))
            return [report, late, c.zero.oracle.pending_count(),
                    _battery(c)]
        finally:
            c.close()
    got = _both(run)
    assert got[0]["aborted_txns"] == 1 and got[1][0] == "raised"


def test_rebalance_once_equals_jax():
    """JAX's skewed-group case: both heavy tablets on group 0."""
    def run(p):
        c = _cluster(p, "name: string @index(exact) .\nbig: string .\n"
                        "small: int .", {"name": 0, "big": 0, "small": 1})
        try:
            c.mutate(set_nquads="\n".join(
                f'_:n{i} <name> "person{i}" .\n_:n{i} <big> "{"x" * 200}" .'
                for i in range(40)) + '\n_:n0 <small> "1"^^<xs:int> .')
            first, again = c.rebalance_once(), c.rebalance_once()
            return [first, again, c.zero.tablets(),
                    c.query('{ q(func: eq(name, "person3")) { name big } }')]
        finally:
            c.close()
    got = _both(run)
    assert got[0] is not None and got[0]["dst"] == 1


def test_add_and_drop_replica_equal_jax():
    def run(p):
        c = _cluster(p)
        try:
            c.mutate(set_nquads=_graph_quads(n=24))
            out = [c.add_replica("name", 1), c.add_replica("name", 1),
                   c.add_replica("name", 0), sorted(
                       c.zero.replica_holders("name"))]
            out.append(_battery(c))
            c.mutate(set_nquads='<0x2> <name> "renamed" .')
            out.append(_dump(c.query(
                '{ q(func: eq(name, "renamed")) { uid name } }')))
            out += [c.drop_replica("name", 1), c.drop_replica("name", 1),
                    sorted(c.stores[1].predicates())]
            loads = c.tablet_loads()
            out.append({g: {a: [r["r"], r["w"], r["b"]]
                            for a, r in sorted(rows.items())}
                        for g, rows in loads.items()})
            return out
        finally:
            c.close()
    got = _both(run)
    assert got[0]["installed_keys"] > 0


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_placement_controller_actions_equal_jax():
    """test_placement's zipfian skew: three groups, a hot read-heavy
    tablet; the controller's actions, tick by tick, and the answers."""
    hot = '{ q(func: eq(name, "p3")) { name } }'
    warm = ['{ q(func: ge(age, 30)) { age } }',
            '{ q(func: has(follows), first: 3) { uid } }']

    def run(p):
        c = _cluster(p, tablets={"name": 0, "age": 1, "follows": 2},
                     n_groups=3)
        try:
            nq = []
            for i in range(24):
                nq.append(f'_:p{i} <name> "p{i}" .')
                nq.append(f'_:p{i} <age> "{20 + i}"^^<xs:int> .')
            nq += [f"_:p{i} <follows> _:p{i + 1} ." for i in range(23)]
            c.mutate(set_nquads="\n".join(nq))
            clock = _FakeClock()
            cfg = PKG[p]["pl"].PlacementConfig(
                threshold=0.5, persist_ticks=2, cooldown_s=5.0,
                max_replicas=2, min_rate=0.5)
            ctl = c.placement_controller(cfg=cfg, clock=clock)
            ctl.tick()
            actions = []
            for _ in range(6):
                for _ in range(40):
                    c.query(hot)
                for q in warm:
                    for _ in range(4):
                        c.query(q)
                clock.t += 10.0
                act = ctl.tick()
                actions.append(None if act is None else
                               [act.kind, act.attr, act.src, act.dst])
            return [actions, c.zero.tablets(),
                    {a: sorted(c.zero.replica_holders(a))
                     for a in ("name", "age", "follows")},
                    [_dump(c.query(q)) for q in [hot] + warm]]
        finally:
            c.close()
    got = _both(run)
    assert ["add_replica", "name"] in [a[:2] for a in got[0] if a]


# -- transactions across groups -----------------------------------------------

def test_conflict_schedule_outcomes_equal_jax():
    """A seeded schedule of overlapping cross-group txns: which commit and
    which abort, every commit ts, and the answers after."""
    rng = np.random.default_rng(17)
    txns = []
    for _ in range(12):
        u = int(rng.integers(1, 9))
        txns.append(f'<0x{u:x}> <name> "n{int(rng.integers(100))}" .\n'
                    f'<0x{u:x}> <balance> "{int(rng.integers(900))}"'
                    f'^^<xs:int> .')
    order = rng.permutation(len(txns)).tolist()

    def run(p):
        c = _cluster(p)
        try:
            c.mutate(set_nquads=_graph_quads(n=24))
            open_ts = [_open_write(c, PKG[p], nq) for nq in txns]
            out = [_outcome(lambda ts=open_ts[i]: c.commit(ts))
                   for i in order]
            return [out, c.zero.oracle.pending_count(), _battery(c)]
        finally:
            c.close()
    got = _both(run)
    kinds = {o[0] for o in got[0]}
    assert kinds == {"ok", "raised"}


def test_star_delete_and_rejected_writes_equal_jax():
    def run(p):
        c = _cluster(p)
        try:
            c.mutate(set_nquads=_graph_quads(n=24))
            c.mutate(del_nquads="<0x1> * * .")
            out = [_dump(c.query('{ q(func: uid(0x1)) { name age balance '
                                 'follows { uid } } }'))]
            c.zero.block_writes("age")
            out.append(_outcome(lambda: c.mutate(
                set_nquads='<0x2> <age> "50"^^<xs:int> .')))
            c.zero.unblock_writes("age")
            out.append(_outcome(lambda: c.mutate(
                set_nquads='<0x2> <age> "not-an-int" .')))
            out += [c.zero.oracle.pending_count(), _battery(c)]
            return out
        finally:
            c.close()
    got = _both(run)
    assert got[1] == ["raised", "MoveInProgress"]


# -- live queries over the federation -----------------------------------------

def test_cluster_subscribe_events_equal_jax():
    """Every event of one subscription, in order, through writes on both
    groups (one that does not touch the query wakes nothing)."""
    q = "{ q(func: has(name)) { uid name age } }"

    def run(p):
        c = _cluster(p, "name: string @index(term) .\nage: int .",
                     {"name": 0, "age": 1})
        try:
            c.mutate(set_nquads='<0x1> <name> "alice" .')
            sub = c.subscribe(q)
            events = [sub.next(5)]
            c.mutate(set_nquads='<0x2> <name> "bob" .\n'
                                '<0x2> <age> "9"^^<xs:int> .')
            events.append(sub.next(5))
            c.mutate(set_nquads='<0x1> <age> "40"^^<xs:int> .')
            events.append(sub.next(5))
            c.mutate(del_nquads='<0x2> <name> "bob" .')
            events.append(sub.next(5))
            sub.cancel()
            return [{k: ev[k] for k in ("type", "at", "result", "diff")
                     if k in ev} for ev in events]
        finally:
            c.close()
    got = _both(run)
    assert [e["type"] for e in got] == ["init", "diff", "diff", "diff"]


# -- ReplicaGroup and FollowerReader ------------------------------------------

N_ACCOUNTS, START = 8, 100


def _balances(node):
    out, _ = node.query("{ q(func: has(acct)) { uid bal } }")
    return {r["uid"]: r["bal"] for r in out.get("q", [])}


def _bank(g, rng, n):
    """n seeded transfers through the group's leader; each one's outcome."""
    out = []
    for _ in range(n):
        a, b = rng.choice(np.arange(1, N_ACCOUNTS + 1), size=2,
                          replace=False)
        amt = int(rng.integers(1, 20))

        def transfer():
            ctx = g.node.new_txn()
            bals = _balances(g.node)
            g.node.mutate(
                set_nquads=f'<0x{a:x}> <bal> "{bals[hex(a)] - amt}"'
                           f'^^<xs:int> .\n<0x{b:x}> <bal> '
                           f'"{bals[hex(b)] + amt}"^^<xs:int> .',
                start_ts=ctx.start_ts)
            return g.node.commit(ctx.start_ts)
        out.append(_outcome(transfer))
    return out


def _replica_group(p, tmp_path, **kw):
    g = PKG[p]["rep"].ReplicaGroup(str(tmp_path / p), n=3, **kw,
                                   **PKG[p]["kw"])
    g.node.alter(schema_text="bal: int .\nacct: string @index(exact) .")
    g.node.mutate(set_nquads="\n".join(
        f'<0x{i:x}> <acct> "a{i}" .\n<0x{i:x}> <bal> "{START}"^^<xs:int> .'
        for i in range(1, N_ACCOUNTS + 1)), commit_now=True)
    return g


def test_replica_group_failovers_equal_jax(tmp_path):
    """Transfers, a leader crash, more transfers, a rejoin, a second crash
    and then the loss of quorum: leaders, terms, outcomes and balances."""
    def run(p):
        g = _replica_group(p, tmp_path)
        rng = np.random.default_rng(3)
        try:
            out = [_bank(g, rng, 12), _balances(g.node)]
            g.kill(g.leader_id)
            out += [g.leader_id, g.term, _balances(g.node),
                    _bank(g, rng, 6)]
            g.rejoin(0)
            g.kill(g.leader_id)
            out += [g.leader_id, g.term, _balances(g.node)]
            others = [m.id for m in g.members
                      if m.alive and m.id != g.leader_id]
            g.kill(others[0])
            out.append(_bank(g, rng, 2))
            return out
        finally:
            g.close()
    got = _both(run)
    assert sum(got[1].values()) == N_ACCOUNTS * START
    assert got[-1][0] == ["raised", "NoQuorum"]


def test_follower_reads_equal_jax(tmp_path):
    """serve_reads=True: reads through a dead leader come from a follower
    reader, equal in both packages; and each package's shipped WAL records,
    applied by the OTHER package's FollowerReader, give the same answers."""
    q = '{ q(func: eq(acct, "a3")) { uid acct bal } ' \
        'all(func: has(acct)) { count(uid) } }'
    other = {"j": "t", "t": "j"}

    def run(p):
        cross = PKG[other[p]]["rep"].FollowerReader(**PKG[other[p]]["kw"])
        g = PKG[p]["rep"].ReplicaGroup(str(tmp_path / f"f{p}"), n=3,
                                       serve_reads=True, **PKG[p]["kw"])
        shipped = []

        def hook(member, data):
            if member.id == 1:
                shipped.append(data)
        g.fault_hook = hook
        try:
            g.node.alter(schema_text="bal: int .\n"
                                     "acct: string @index(exact) .")
            g.node.mutate(set_nquads="\n".join(
                f'<0x{i:x}> <acct> "a{i}" .\n<0x{i:x}> <bal> "{START}"'
                f'^^<xs:int> .' for i in range(1, N_ACCOUNTS + 1)),
                commit_now=True)
            _bank(g, np.random.default_rng(5), 6)
            for data in shipped:
                cross.apply(data)
            leader = g.read(q, hedge_after=5.0)
            g.kill(g.leader_id)
            g.fault_hook = None
            return [leader, g.read(q), cross.query(q), len(shipped)]
        finally:
            g.close()
    got = _both(run)
    assert got[0][0] == "leader" and got[1][1] == got[0][1] == got[2]


# -- Zero: leases across restarts, a mixed Zero trio --------------------------

def test_zero_restart_leases_equal_jax(tmp_path):
    def run(p):
        Z = PKG[p]["zero"]
        d = str(tmp_path / f"z{p}")
        z = Z.Zero(n_groups=2, dirpath=d)
        out = [[z.oracle.new_txn().start_ts for _ in range(5)],
               z.oracle.timestamps(3), list(z.uids.assign(1000)),
               z.should_serve("name")]
        z.move_tablet("age", 1)
        for _ in range(3):
            out.append(z.oracle.timestamps(Z.LEASE_BLOCK // 2 + 7))
        start = z.oracle.new_txn().start_ts
        out.append(z.oracle.commit(start))
        for _ in range(2):
            z = Z.Zero(n_groups=2, dirpath=d)
            out += [z.oracle.new_txn().start_ts, list(z.uids.assign(10)),
                    z.tablets()]
        m = Z.Zero()
        out += [m.oracle.new_txn().start_ts, m.oracle.new_txn().start_ts]
        return out
    got = _both(run)
    assert got[-1] == got[-2] + 1


def _zero_trio(tmp_path, pkgs):
    """Three Zeros, member i from package pkgs[i]; member 0 bootstraps as
    leader (the test_multizero wiring, fast timers)."""
    import socket

    socks, addrs = [], []
    for _ in pkgs:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        addrs.append(f"127.0.0.1:{s.getsockname()[1]}")
        socks.append(s)
    for s in socks:
        s.close()
    servers, reps = [], []
    for i, p in enumerate(pkgs):
        P = PKG[p]
        d = str(tmp_path / f"zt{i}")
        os.makedirs(d, exist_ok=True)
        zero = P["zero"].Zero(n_groups=1, dirpath=d)
        svc = P["zs"].ZeroService(zero)
        rep = P["zs"].ZeroReplica(svc, d, addrs[i], addrs,
                                  bootstrap_leader=i == 0)
        rep.PING_S = 0.1
        rep.ELECTION_TIMEOUT_S = (0.4, 0.8)
        server, _port, svc = P["zs"].serve_zero(zero, addrs[i], svc=svc)
        rep.start()
        servers.append(server)
        reps.append(rep)
    return servers, reps, addrs


@pytest.mark.parametrize("pkgs", ["jtt", "tjj"])
def test_mixed_zero_trio_ships_and_fails_over(tmp_path, pkgs):
    """A Zero trio of both packages: a standby of the other package refuses
    coordination, a rotating client of each package gets leases from the
    leader, and once the leader dies a standby of the other package wins
    the ballot and never reissues a lease."""
    servers, reps, addrs = _zero_trio(tmp_path, pkgs)
    try:
        for p in "jt":
            standby = PKG[p]["zs"].ZeroClient(addrs[1])
            with pytest.raises(grpc.RpcError) as ei:
                standby.new_txn()
            assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
            standby.close()
        ts_issued, uids_issued = [], []
        for p in "jt":
            c = PKG[p]["zs"].ZeroClient(",".join([addrs[1], addrs[0]]))
            ts_issued.append(c.new_txn())
            uids_issued.append(c.assign_uids(100) + 99)
            c.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if all(r.seq > 0 for r in reps[1:]):
                break
            time.sleep(0.05)
        assert all(r.seq > 0 for r in reps[1:])   # ships reached both
        servers[0].stop(0)
        reps[0].stop()
        reps[0].is_leader = False
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if any(r.is_leader for r in reps[1:]):
                break
            time.sleep(0.05)
        assert any(r.is_leader for r in reps[1:])
        for p in "jt":
            c = PKG[p]["zs"].ZeroClient(",".join(addrs[1:]))
            ts = c.new_txn()
            assert ts > max(ts_issued)
            first = c.assign_uids(10)
            assert first > max(uids_issued)
            ts_issued.append(ts)
            uids_issued.append(first + 9)
            c.close()
    finally:
        for r in reps:
            r.stop()
        for s in servers:
            s.stop(0)


# -- hedged reads across packages ---------------------------------------------

NQ = "\n".join(f'<0x{i:x}> <name> "p{i}" .' for i in range(1, 9))


def _worker(p):
    """A worker of package p holding NQ at commit ts 2, served on
    loopback."""
    import concurrent.futures as _f

    P = PKG[p]
    s = P["store"].Store()
    for e in P["schema"].parse_schema("name: string @index(exact) .\n"
                                      "v: int ."):
        s.set_schema(e)
    nq = P["rdf"].parse(NQ)
    edges = P["mut"].to_edges(nq, P["mut"].assign_uids(
        nq, P["zero"].UidLease()), P["post"].Op.SET)
    touched, _, _ = P["mut"].apply_mutations(s, edges, 1)
    s.commit(1, 2, touched)
    svc = P["remote"].WorkerService(s, **P["kw"])
    server = grpc.server(_f.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((svc.handler(),))
    port = server.add_insecure_port("localhost:0")
    server.start()
    return server, f"localhost:{port}"


@pytest.mark.parametrize("client,primary,backup",
                         [("j", "t", "t"), ("t", "j", "j"), ("j", "j", "t"),
                          ("t", "t", "j")])
def test_hedged_failover_across_packages(client, primary, backup):
    """A HedgedReplicas of one package over workers of either: the primary
    dies and the backup answers, and the result's wire bytes equal the
    all-JAX answer's."""
    P = PKG[client]
    servers, addrs = zip(*(_worker(p) for p in (primary, backup)))
    want = None
    hr = P["remote"].HedgedReplicas(list(addrs))
    hr.HEDGE_GRACE = 0.15
    try:
        tq = P["task"].TaskQuery("name", func=("eq", ["p5"]))
        before = hr.process_task(tq, 5, min_applied=2)
        servers[0].stop(0)
        after = hr.process_task(tq, 5, min_applied=2)
        jw, jaddr = _worker("j")
        try:
            rw = jremote.RemoteWorker(jaddr)
            want = jremote.encode_result(rw.process_task(
                jtask.TaskQuery("name", func=("eq", ["p5"])), 5))
            rw.close()
        finally:
            jw.stop(0)
        for res in (before, after):
            got = P["remote"].encode_result(res).SerializeToString()
            assert got == want.SerializeToString()
        assert list(after.dest_uids) == [5]
    finally:
        hr.close()
        for s in servers:
            s.stop(0)


# -- the ballot ---------------------------------------------------------------

def test_tally_equals_jax():
    rng = np.random.default_rng(23)
    cases = [(int(v), int(n)) for n in range(1, 8)
             for v in range(0, n + 1)]
    cases += [(int(rng.integers(0, 40)), int(rng.integers(1, 40)))
              for _ in range(64)]
    assert [tballot.tally(v, n) for v, n in cases] == \
        [jballot.tally(v, n) for v, n in cases]
