"""The PyTorch port against tests/test_systest.py, case for case:
multi-PROCESS cluster system tests (reference systest/cluster_test.go:36).

Topology per test: a real `zero` coordinator process plus worker processes
spawned via the port's CLI (`python -m dgraph_tpu_torch zero|worker
--device cpu`), coordinated ONLY
over the internal gRPC protocol — no in-process ReplicaGroup, no shared
memory. Replication ships WAL records through the Append RPC with quorum
acks; the leader is killed with SIGKILL mid-hammer and the control plane
promotes the live replica with the longest log (Raft's up-to-date rule,
worker/draft.go:485-624 / conn/node.go:47-105 contract).
"""

import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu_torch.parallel.client import ClusterClient
from dgraph_tpu_torch.parallel.remote import RemoteWorker

SCHEMA = """
name: string @index(exact) .
balance: int .
follows: [uid] .
owner: uid .
"""


REPO = str(Path(__file__).resolve().parents[1])


def _cpu(args):
    """Workers run the plain PyTorch versions on the host here."""
    return args + ["--device", "cpu"] if args[0] == "worker" else args


def _spawn(tmp_path, args, tag):
    """Start a CLI process; return (proc, bound_port) parsed from stdout."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("PYTHONUNBUFFERED", "1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dgraph_tpu_torch"] + _cpu(args),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    port = None
    deadline = time.time() + 120   # jax import under load
    lines = []
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(f"{tag} died: {''.join(lines)}")
            continue
        lines.append(line)
        m = re.search(r"serving .* on [\w.]+:(\d+)", line)
        if m:
            port = int(m.group(1))
            break
    if port is None:
        proc.kill()
        raise RuntimeError(f"{tag} never reported a port: {''.join(lines)}")
    return proc, port


@pytest.fixture()
def procs():
    running = []

    def add(p):
        running.append(p)
        return p

    yield add
    for p in running:
        if p.poll() is None:
            p.kill()
    for p in running:
        try:
            p.wait(timeout=10)
        except Exception:
            pass


def _write_schema(tmp_path):
    sf = tmp_path / "schema.txt"
    sf.write_text(SCHEMA)
    return str(sf)


def _start_cluster(tmp_path, procs, n_replicas=3, n_groups=1):
    zp, zport = _spawn(tmp_path, ["zero", "--port", "0",
                                  "--groups", str(n_groups)], "zero")
    procs(zp)
    sf = _write_schema(tmp_path)
    workers = []   # (proc, addr) per replica of group 0 … n_groups-1
    groups = {}
    for g in range(n_groups):
        addrs = []
        for r in range(n_replicas if g == 0 else 1):
            wp, wport = _spawn(tmp_path, [
                "worker", "--port", "0",
                "-p", str(tmp_path / f"g{g}r{r}"),
                "--schema", sf, "--zero", f"127.0.0.1:{zport}",
                "--group", str(g)], f"worker g{g}r{r}")
            procs(wp)
            workers.append((wp, f"127.0.0.1:{wport}", g, r))
            addrs.append(f"127.0.0.1:{wport}")
        groups[g] = addrs
    return zport, workers, groups


def _balances(client):
    out = client.query("{ q(func: has(balance)) { name balance } }")
    return {x["name"]: x["balance"] for x in out.get("q", [])}


def test_replicated_group_kill9_failover(tmp_path, procs):
    """3-replica group: quorum-shipped writes survive a SIGKILL of the
    leader; the longest-log live replica takes over and the bank invariant
    holds across the failover."""
    zport, workers, groups = _start_cluster(tmp_path, procs, n_replicas=3)
    addrs = groups[0]
    replicas = [RemoteWorker(a) for a in addrs]
    # control plane promotes — unless the wire ballot (always on in CLI
    # workers) already elected; either way exactly one leader emerges
    t0 = max(rw.status().term for rw in replicas)
    r = replicas[0].promote(t0 + 1, [addrs[1], addrs[2]])
    if not r.ok:     # lost the race to a self-election: adopt its leader
        deadline = time.time() + 20
        while time.time() < deadline and not any(
                rw.status().leader for rw in replicas):
            time.sleep(0.2)
    assert any(rw.status().leader for rw in replicas)
    client = ClusterClient(f"127.0.0.1:{zport}", groups)

    n_accounts, start = 6, 100
    client.mutate(set_nquads="\n".join(
        f'_:a{i} <name> "acct{i}" .\n_:a{i} <balance> "{start}"^^<xs:int> .'
        for i in range(n_accounts)))
    assert sum(_balances(client).values()) == n_accounts * start

    def hammer(rounds):
        import random
        rng = random.Random(7)
        moved = 0
        for _ in range(rounds):
            bal = _balances(client)
            names = sorted(bal)
            a, b = rng.sample(names, 2)
            amt = rng.randint(1, 25)
            # read-modify-write both balances in ONE txn
            uid_out = client.query(
                '{ q(func: has(balance)) { uid name } }')
            uids = {x["name"]: x["uid"] for x in uid_out["q"]}
            client.mutate(set_nquads=(
                f'<{uids[a]}> <balance> "{bal[a] - amt}"^^<xs:int> .\n'
                f'<{uids[b]}> <balance> "{bal[b] + amt}"^^<xs:int> .'))
            moved += amt
        return moved

    hammer(5)
    assert sum(_balances(client).values()) == n_accounts * start

    # SIGKILL the CURRENT leader (promoted or self-elected) mid-life
    old_leader = next(i for i, rw in enumerate(replicas)
                      if rw.status().leader)
    old_term = replicas[old_leader].status().term
    leader_proc = workers[old_leader][0]
    os.kill(leader_proc.pid, signal.SIGKILL)
    leader_proc.wait(timeout=10)

    # control plane: promote the most up-to-date live replica (highest
    # applied commit, then longest durable log — Raft's rule); the wire
    # ballot may win the race, which is equally valid
    live = [i for i in range(3) if i != old_leader]
    stats = sorted(((replicas[i].status().max_commit_ts,
                     replicas[i].status().log_len, -i, i) for i in live),
                   reverse=True)
    new_leader = stats[0][3]
    peer = [addrs[j] for j in live if j != new_leader]
    if not replicas[new_leader].promote(old_term + 1, peer).ok:
        deadline = time.time() + 20
        while time.time() < deadline:
            up = [i for i in live if replicas[i].status().leader]
            if up:
                new_leader = up[0]
                break
            time.sleep(0.2)

    # the hammer continues against the new leader (client re-discovers it)
    hammer(5)
    got = _balances(client)
    assert sum(got.values()) == n_accounts * start
    assert len(got) == n_accounts

    # stale leader fencing: the new leader's term supersedes the old one
    st = replicas[new_leader].status()
    assert st.leader and st.term > old_term


def test_cross_group_processes(tmp_path, procs):
    """Two single-replica groups behind a zero process: mutations split by
    tablet owner, 2-hop queries fan out over ServeTask, Sort and Schema ride
    their own RPCs (worker/sort.go:50, worker/schema.go:160)."""
    zport, workers, groups = _start_cluster(tmp_path, procs,
                                            n_replicas=1, n_groups=2)
    client = ClusterClient(f"127.0.0.1:{zport}", groups)
    client.mutate(set_nquads="\n".join(
        f'_:p{i} <name> "p{i}" .\n_:p{i} <balance> "{10 * i}"^^<xs:int> .'
        for i in range(1, 5)) + """
        _:p1 <follows> _:p2 .
        _:p2 <follows> _:p3 .
        _:p1 <owner> _:p4 .
    """)
    # tablets actually split across the two groups
    tablets = client.zero.tablets()
    assert len(set(tablets.values())) == 2, tablets

    out = client.query('{ q(func: eq(name, "p1")) '
                       '{ name follows { name follows { name } } owner { name } } }')
    q = out["q"][0]
    assert q["follows"][0]["name"] == "p2"
    assert q["follows"][0]["follows"][0]["name"] == "p3"
    assert q["owner"][0]["name"] == "p4"

    # order-by on a (possibly remote) predicate matches value order
    out = client.query('{ q(func: has(balance), orderdesc: balance) '
                       '{ name balance } }')
    got = [x["balance"] for x in out["q"]]
    assert got == sorted(got, reverse=True)

    # Sort RPC direct: owner group orders candidates by its tablet's values
    g = tablets["balance"]
    rw = client.leader_of(g)
    uid_out = client.query("{ q(func: has(balance)) { uid balance } }")
    import numpy as np

    uids = np.asarray([int(x["uid"], 16) for x in uid_out["q"]], np.int64)
    ordered = rw.sort("balance", np.sort(uids), desc=False, lang="",
                      read_ts=int(client.zero.state()["maxTxnTs"]))
    by_uid = {int(x["uid"], 16): x["balance"] for x in uid_out["q"]}
    vals = [by_uid[int(u)] for u in ordered]
    assert vals == sorted(vals)

    # Schema RPC: merged cluster schema covers both groups' entries
    schema = client.schema()
    assert schema.get("balance") is not None
    assert schema.get("follows") is not None
    client.close()


def test_process_move_tablet_and_rebalance(tmp_path, procs):
    """Tablet move OVER THE WIRE driven from the zero process: HTTP
    /moveTablet streams the predicate to the destination leader, flips the
    map, deletes at the source; /state reflects it; queries stay correct.
    A skewed cluster then auto-rebalances (tablet.go:60-74)."""
    import json as _json
    import urllib.request

    # zero with ops HTTP + fast rebalance tick; spawn manually to capture
    # BOTH ports (http + grpc)
    env_extra = ["zero", "--port", "0", "--groups", "2",
                 "--rebalance_interval", "1"]
    import os as _os, re as _re, subprocess as _sp, sys as _sys, time as _time
    env = dict(_os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONUNBUFFERED"] = "1"
    # force MANY small chunks through the wire move (predicate_move.go:187)
    env["DGRAPH_TPU_MOVE_CHUNK"] = "256"
    p = _sp.Popen([_sys.executable, "-m", "dgraph_tpu_torch"] + env_extra,
                  stdout=_sp.PIPE, stderr=_sp.STDOUT, text=True, env=env,
                  cwd=REPO)
    procs(p)
    http_port = grpc_port = None
    deadline = _time.time() + 60
    while _time.time() < deadline and (http_port is None or grpc_port is None):
        line = p.stdout.readline()
        m = _re.search(r"ops HTTP on [\w.]+:(\d+)", line or "")
        if m:
            http_port = int(m.group(1))
        m = _re.search(r"zero serving .* on [\w.]+:(\d+)", line or "")
        if m:
            grpc_port = int(m.group(1))
    assert http_port and grpc_port

    sf = _write_schema(tmp_path)
    groups = {}
    for g in range(2):
        wp, wport = _spawn(tmp_path, [
            "worker", "--port", "0", "-p", str(tmp_path / f"mg{g}"),
            "--schema", sf, "--zero", f"127.0.0.1:{grpc_port}",
            "--group", str(g)], f"worker g{g}")
        procs(wp)
        groups[g] = [f"127.0.0.1:{wport}"]

    client = ClusterClient(f"127.0.0.1:{grpc_port}", groups)
    client.mutate(set_nquads="\n".join(
        f'_:n{i} <name> "q{i}" .' for i in range(20)))
    tablets = client.zero.tablets()
    src = tablets["name"]
    dst = 1 - src

    def http_get(path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http_port}{path}", timeout=30) as r:
            return _json.loads(r.read())

    out = http_get(f"/moveTablet?tablet=name&group={dst}")
    assert out.get("tablet") == "name" and out.get("dst") == dst, out
    assert http_get("/state")["tabletMap"]["name"] == dst
    res = client.query('{ q(func: eq(name, "q7")) { name } }')
    assert [x["name"] for x in res["q"]] == ["q7"]

    # deterministic skew: several comparable tablets all on group 0, none
    # on group 1 — choose_rebalance_move MUST find a tablet fitting half
    # the gap, so the background rebalancer has to move one within its tick
    client.mutate(set_nquads="\n".join(
        f'_:b{i} <balance> "{i}"^^<xs:int> .\n'
        f'_:b{i} <follows> _:b{(i + 1) % 300} .' for i in range(300)))
    for t, g in http_get("/state")["tabletMap"].items():
        if g != 0:
            http_get(f"/moveTablet?tablet={t}&group=0")
    before = http_get("/state")["tabletMap"]
    assert set(before.values()) == {0}
    deadline = _time.time() + 30
    moved = False
    while _time.time() < deadline:
        now = http_get("/state")["tabletMap"]
        if any(g != 0 for g in now.values()):
            moved = True
            break
        _time.sleep(0.5)
    assert moved, f"auto-rebalancer never moved a tablet: {now}"
    # queries stay correct through the automatic move; allow the client's
    # 1s tablet-map TTL to lapse (the reference's membership stream has the
    # same propagation window, worker/groups.go:454)
    deadline = _time.time() + 10
    while _time.time() < deadline:
        client._invalidate()
        res = client.query("{ q(func: has(balance)) { balance } }")
        res2 = client.query('{ q(func: eq(name, "q3")) { name } }')
        if len(res.get("q", [])) == 300 and \
                [x["name"] for x in res2.get("q", [])] == ["q3"]:
            break
        _time.sleep(0.5)
    assert len(res["q"]) == 300
    assert [x["name"] for x in res2["q"]] == ["q3"]
    client.close()


def test_zero_process_restart_with_wal(tmp_path, procs):
    """kill -9 the zero coordinator and restart it from its state dir: the
    tablet map and lease ceilings survive, so the cluster keeps answering
    and new uids/timestamps never collide with pre-crash ones."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    zport = s.getsockname()[1]
    s.close()
    zw = str(tmp_path / "zw")
    zp, _ = _spawn(tmp_path, ["zero", "--port", str(zport), "-w", zw], "zero")
    procs(zp)
    sf = _write_schema(tmp_path)
    wp, wport = _spawn(tmp_path, [
        "worker", "--port", "0", "-p", str(tmp_path / "w0"),
        "--schema", sf, "--zero", f"127.0.0.1:{zport}",
        "--group", "0", "--membership_interval", "1"], "worker")
    procs(wp)
    groups = {0: [f"127.0.0.1:{wport}"]}
    client = ClusterClient(f"127.0.0.1:{zport}", groups)
    uids1 = client.mutate(set_nquads='_:a <name> "before" .')
    out = client.query('{ q(func: eq(name, "before")) { uid name } }')
    assert [x["name"] for x in out["q"]] == ["before"]
    old_uid = int(out["q"][0]["uid"], 16)

    os.kill(zp.pid, signal.SIGKILL)
    zp.wait(timeout=10)
    zp2, _ = _spawn(tmp_path, ["zero", "--port", str(zport), "-w", zw],
                    "zero-restarted")
    procs(zp2)

    client._invalidate()
    deadline = time.time() + 30
    uids2 = None
    while time.time() < deadline:
        try:
            uids2 = client.mutate(set_nquads='_:b <name> "after" .')
            break
        except Exception:
            time.sleep(0.5)
    assert uids2 is not None, "cluster never recovered after zero restart"
    new_uid = uids2["_:b"]
    assert new_uid > old_uid        # lease ceiling prevented uid reuse
    out = client.query('{ q(func: has(name), orderasc: name) { name } }')
    assert [x["name"] for x in out["q"]] == ["after", "before"]
    client.close()


def _free_ports(n):
    import socket

    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


def test_self_healing_cluster_no_control_plane(tmp_path, procs):
    """SIGKILL the zero leader AND the group
    leader with NO control-plane actor; the zero standbys and worker
    replicas elect over the wire and the cluster keeps serving reads and
    writes."""
    zports = _free_ports(3)
    zaddrs = [f"127.0.0.1:{p}" for p in zports]
    peers = ",".join(zaddrs)
    zprocs = []
    for i, p in enumerate(zports):
        zp, _ = _spawn(tmp_path, [
            "zero", "--port", str(p), "--groups", "1",
            "--peers", peers, "--idx", str(i),
            "-w", str(tmp_path / f"z{i}")], f"zero{i}")
        procs(zp)
        zprocs.append(zp)

    sf = _write_schema(tmp_path)
    wprocs, waddrs = [], []
    for r in range(3):
        wp, wport = _spawn(tmp_path, [
            "worker", "--port", "0", "-p", str(tmp_path / f"w{r}"),
            "--schema", sf, "--zero", peers, "--group", "0",
            "--membership_interval", "1"], f"worker{r}")
        procs(wp)
        wprocs.append(wp)
        waddrs.append(f"127.0.0.1:{wport}")

    # the group SELF-elects (no Promote from any control plane): wait for
    # one replica to report leadership via Status
    def leader_idx(deadline=25.0):
        end = time.time() + deadline
        while time.time() < end:
            for i, a in enumerate(waddrs):
                rw = RemoteWorker(a)
                try:
                    if rw.status(timeout=1.0).leader:
                        return i
                except Exception:
                    pass
                finally:
                    rw.close()
            time.sleep(0.3)
        return None

    first = leader_idx()
    assert first is not None, "group never self-elected a leader"

    client = ClusterClient(peers, {0: waddrs})
    client.mutate(set_nquads='_:a <name> "before" .')
    out = client.query('{ q(func: eq(name, "before")) { name } }')
    assert out["q"][0]["name"] == "before"

    # SIGKILL the zero leader (idx 0 bootstraps) AND the group leader
    zprocs[0].send_signal(signal.SIGKILL)
    wprocs[first].send_signal(signal.SIGKILL)

    second = None
    end = time.time() + 30
    while time.time() < end:
        for i, a in enumerate(waddrs):
            if i == first:
                continue
            rw = RemoteWorker(a)
            try:
                st = rw.status(timeout=1.0)
                if st.leader and st.term > 1:
                    second = i
                    break
            except Exception:
                pass
            finally:
                rw.close()
        if second is not None:
            break
        time.sleep(0.3)
    assert second is not None, "no surviving replica won the wire ballot"

    # reads AND writes keep working with both leaders dead
    client2 = ClusterClient(peers, {0: [a for i, a in enumerate(waddrs)
                                        if i != first]})
    deadline = time.time() + 30
    ok = False
    while time.time() < deadline:
        try:
            client2.mutate(set_nquads='_:b <name> "after" .')
            out = client2.query('{ q(func: eq(name, "after")) { name } }')
            if out.get("q") and out["q"][0]["name"] == "after":
                ok = True
                break
        except Exception:
            time.sleep(0.5)
    assert ok, "cluster did not converge to serve reads+writes"
    client.close()
    client2.close()
