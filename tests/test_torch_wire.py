"""The wire cluster across packages: the PyTorch port's Zero, workers and
ClusterClient against the JAX package's, over loopback gRPC on the CPU.

Both packages speak protos/internal.proto with the package name
`dgraph_tpu.internal` (part of every gRPC method path); the port builds its
messages in a private descriptor pool so both modules load in one process.
Each case builds a two-group cluster from a choice of packages — the Zero's,
each group's worker's, the client's — loads the same seeded graph through
the client and runs one battery. Every answer, and the uid map each mutation
returns, must be byte-identical to the all-JAX cluster's. Workers of the
port run on device="cpu" (the plain PyTorch versions); every call has a
deadline.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu.coord import zero as jzero
from dgraph_tpu.coord import zero_service as jzs
from dgraph_tpu.parallel import client as jclient
from dgraph_tpu.parallel import remote as jremote
from dgraph_tpu.protos import internal_pb2 as jipb
from dgraph_tpu.query.task import TaskQuery as JTaskQuery
from dgraph_tpu.query.task import TaskResult as JTaskResult
from dgraph_tpu.storage import store as jstore
from dgraph_tpu.storage.postings import DirectedEdge as JEdge
from dgraph_tpu.storage.postings import Op as JOp
from dgraph_tpu.utils import schema as jschema
from dgraph_tpu.utils.types import TypeID as JTypeID
from dgraph_tpu.utils.types import Val as JVal

from dgraph_tpu_torch.coord import zero as tzero
from dgraph_tpu_torch.coord import zero_service as tzs
from dgraph_tpu_torch.parallel import client as tclient
from dgraph_tpu_torch.parallel import remote as tremote
from dgraph_tpu_torch.protos import internal_pb2 as tipb
from dgraph_tpu_torch.query.task import TaskQuery as TTaskQuery
from dgraph_tpu_torch.query.task import TaskResult as TTaskResult
from dgraph_tpu_torch.storage import store as tstore
from dgraph_tpu_torch.storage.postings import DirectedEdge as TEdge
from dgraph_tpu_torch.storage.postings import Op as TOp
from dgraph_tpu_torch.utils import schema as tschema
from dgraph_tpu_torch.utils.types import TypeID as TTypeID
from dgraph_tpu_torch.utils.types import Val as TVal

REPO = Path(__file__).resolve().parents[1]

PKG = {
    "j": dict(zero=jzero, zs=jzs, client=jclient, remote=jremote,
              store=jstore, schema=jschema, kw={}),
    "t": dict(zero=tzero, zs=tzs, client=tclient, remote=tremote,
              store=tstore, schema=tschema, kw={"device": "cpu"}),
}

SCHEMA = """
name: string @index(exact, term) .
age: int @index(int) .
balance: int .
follows: [uid] @reverse @count .
"""

# name/age on group 0; balance/follows on group 1: hops, filters and sort
# keys cross groups
TABLETS = {"name": 0, "age": 0, "balance": 1, "follows": 1}


def _graph_quads(seed=11, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(f'_:p{i} <name> "p{i}" .')
        out.append(f'_:p{i} <age> "{int(rng.integers(18, 70))}"^^<xs:int> .')
        if i % 4:
            out.append(f'_:p{i} <balance> "{int(rng.integers(0, 900))}"'
                       f'^^<xs:int> .')
        for j in sorted(set(rng.integers(0, n, size=3).tolist()) - {i}):
            out.append(f"_:p{i} <follows> _:p{j} .")
    return "\n".join(out)


BATTERY = [
    '{ q(func: eq(name, "p3")) { name age balance } }',
    '{ q(func: eq(name, "p1")) { name follows { name age } } }',
    '{ q(func: eq(name, "p5")) { ~follows { name } } }',
    '{ q(func: ge(age, 50), orderasc: name) { name age } }',
    '{ q(func: has(name), orderasc: balance, first: 6, offset: 2) '
    '{ name balance } }',
    '{ q(func: has(name), orderdesc: age, first: 5) { name age } }',
    '{ q(func: has(name), first: 12) { name follows (orderdesc: balance) '
    '@filter(ge(balance, 300)) { name balance } } }',
    '{ q(func: eq(name, "p0")) { name count(follows) } }',
    '{ q(func: eq(name, "p4")) @recurse(depth: 3) { name follows } }',
    '{ a as var(func: eq(name, "p6")) { f as follows }\n'
    '  q(func: uid(f), orderasc: name) @filter(NOT uid(a)) { name } }',
    '{ q(func: has(balance), first: 4) { name follows { name } } }',
    '{ q(func: anyofterms(name, "p7 p8 p9"), orderasc: age) { name age } }',
    '{ a as var(func: eq(name, "p3")) b as var(func: eq(name, "p20"))\n'
    '  path as shortest(from: uid(a), to: uid(b)) { follows }\n'
    '  q(func: uid(path)) { name } }',
    '{ q(func: has(follows)) @groupby(age) { count(uid) } }',
    '{ var(func: has(balance)) { b as balance }\n'
    '  q() { s: sum(val(b)) m: max(val(b)) } }',
    '{ q(func: has(name)) @filter(uid_in(follows, 0x3)) '
    '{ name count(follows) } }',
    '{ q(func: eq(name, "p9")) { name follows (first: 2, offset: 1) '
    '{ name } } }',
    '{ q(func: has(name), orderasc: age, orderdesc: balance, first: 8) '
    '{ name age balance } }',
    '{ q(func: eq(name, "p7")) @recurse(depth: 4, loop: true) '
    '{ name follows } }',
    '{ q(func: eq(name, "p2")) @recurse(depth: 3) { age ~follows } }',
]


class _Wire:
    """A Zero + one worker per group + a client, each from a package."""

    def __init__(self, zero_pkg: str, worker_pkgs: str, client_pkg: str):
        zp = PKG[zero_pkg]
        zero = zp["zero"].Zero(2)
        for attr, g in TABLETS.items():
            zero.move_tablet(attr, g)
        self.zsrv, zport, _ = zp["zs"].serve_zero(zero, "localhost:0")
        self.workers = []
        for g, wp in enumerate(worker_pkgs):
            P = PKG[wp]
            s = P["store"].Store()
            for e in P["schema"].parse_schema(SCHEMA):
                s.set_schema(e)
            self.workers.append(P["remote"].serve_worker(
                s, "localhost:0", **P["kw"]))
        self.client = PKG[client_pkg]["client"].ClusterClient(
            f"localhost:{zport}",
            {g: [f"localhost:{w[1]}"] for g, w in enumerate(self.workers)},
            default_timeout_ms=20000)
        self.addrs = {g: f"localhost:{w[1]}"
                      for g, w in enumerate(self.workers)}

    def close(self):
        self.client.close()
        for w, _p in self.workers:
            w.stop(0)
        self.zsrv.stop(0)


def _drive(zero_pkg, worker_pkgs, client_pkg):
    """Load the graph and run the battery; the outputs as JSON text."""
    w = _Wire(zero_pkg, worker_pkgs, client_pkg)
    try:
        uids = w.client.mutate(set_nquads=_graph_quads())
        out = {"uids": json.dumps(uids, sort_keys=True)}
        for qi, q in enumerate(BATTERY):
            w.client.task_cache.clear()
            out[qi] = json.dumps(w.client.query(q))
        # a delete crossing both groups, then a re-read
        p1 = hex(uids["_:p1"])
        w.client.mutate(del_nquads=f"<{p1}> <follows> * .\n"
                                   f"<{p1}> <age> * .")
        w.client.task_cache.clear()
        out["after_delete"] = json.dumps(w.client.query(BATTERY[1]))
        return out
    finally:
        w.close()


# (zero, workers of groups 0 and 1, client); "jj j" is the reference
COMBOS = ["t tt t", "t tt j", "j jj t", "j jt t", "t jt j", "t tj t"]


@pytest.fixture(scope="module")
def reference():
    return _drive("j", "jj", "j")


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(combo):
        if combo not in cache:
            cache[combo] = _drive(*combo.split())
        return cache[combo]
    return get


@pytest.mark.parametrize("combo", COMBOS)
def test_uid_map_and_delete_equal_jax(reference, runs, combo):
    got = runs(combo)
    assert got["uids"] == reference["uids"]
    assert got["after_delete"] == reference["after_delete"]
    assert "age" not in json.loads(got["after_delete"])["q"][0]


@pytest.mark.parametrize("qi", range(len(BATTERY)))
@pytest.mark.parametrize("combo", ["t tt t", "j jt t", "t jt j"])
def test_battery_byte_identical_to_jax(reference, runs, combo, qi):
    """The port's cluster, a mixed one and each client over the other
    package's servers: every answer is the all-JAX cluster's, bytes."""
    assert runs(combo)[qi] == reference[qi]


def test_jax_client_over_port_cluster(reference, runs):
    got = runs("t tt j")
    assert all(got[qi] == reference[qi] for qi in range(len(BATTERY)))


def test_port_client_over_jax_workers(reference, runs):
    got = runs("j jj t")
    assert all(got[qi] == reference[qi] for qi in range(len(BATTERY)))


def test_commit_abort_outcomes_equal_jax():
    """Two txns write one key through Zero and a worker of each package:
    the first commits, the second aborts with TxnConflict, and the
    timestamps match across packages."""
    outcomes = {}
    for zp, wp in (("j", "j"), ("t", "t"), ("t", "j"), ("j", "t")):
        Z, W = PKG[zp], PKG[wp]
        zsrv, zport, _ = Z["zs"].serve_zero(Z["zero"].Zero(1), "localhost:0")
        s = W["store"].Store()
        for e in W["schema"].parse_schema(SCHEMA):
            s.set_schema(e)
        wsrv, wport = W["remote"].serve_worker(s, "localhost:0", **W["kw"])
        zc = PKG["t"]["zs"].ZeroClient(f"localhost:{zport}")
        rw = PKG["t"]["remote"].RemoteWorker(f"localhost:{wport}")
        try:
            log = []
            a, b = zc.new_txn(), zc.new_txn()
            edge = TEdge(subject=5, attr="name", object_uid=0,
                         value=TVal(TTypeID.STRING, "x"), op=TOp.SET)
            ra = rw.mutate(a, [edge])
            rb = rw.mutate(b, [edge])
            ca = zc.commit(a, list(ra.conflict_keys), list(ra.preds))
            rw.decide(a, ca, list(ra.keys))
            log.append(("commit", a, ca))
            try:
                zc.commit(b, list(rb.conflict_keys), list(rb.preds))
                log.append(("commit", b))
            except tzero.TxnConflict:
                rw.decide(b, 0, list(rb.keys))
                log.append(("abort", b))
            outcomes[zp + wp] = log
        finally:
            rw.close()
            zc.close()
            wsrv.stop(0)
            zsrv.stop(0)
    first = outcomes["jj"]
    assert first[0][0] == "commit" and first[1][0] == "abort"
    assert all(v == first for v in outcomes.values()), outcomes


def test_both_internal_pb2_load_in_one_process():
    """The port's internal messages live in a private pool: both modules
    load in one process, in either order, keep the package name
    dgraph_tpu.internal, and parse each other's bytes."""
    assert tipb.POOL is not jipb._descriptor_pool.Default()
    assert tipb.TaskRequest.DESCRIPTOR.full_name == \
        jipb.TaskRequest.DESCRIPTOR.full_name == \
        "dgraph_tpu.internal.TaskRequest"
    assert tremote.SERVICE == jremote.SERVICE
    assert tzs.SERVICE == jzs.SERVICE
    assert tremote.GRPC_OPTIONS == jremote.GRPC_OPTIONS
    assert dict(tremote.GRPC_OPTIONS)["grpc.max_receive_message_length"] \
        == 1 << 30
    names = sorted(m.name for m in
                   jipb.DESCRIPTOR.message_types_by_name.values())
    assert sorted(m.name for m in
                  tipb.DESCRIPTOR.message_types_by_name.values()) == names
    for first, second in (("dgraph_tpu", "dgraph_tpu_torch"),
                          ("dgraph_tpu_torch", "dgraph_tpu")):
        code = (f"import {first}.protos.internal_pb2 as a, "
                f"{second}.protos.internal_pb2 as b\n"
                "w = a.TaskRequest(attr='x', read_ts=2).SerializeToString()\n"
                "assert b.TaskRequest.FromString(w).read_ts == 2\n"
                "print(a.TaskRequest.DESCRIPTOR.full_name, "
                "b.TaskRequest.DESCRIPTOR.full_name)")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=str(REPO)),
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split() == ["dgraph_tpu.internal.TaskRequest"] * 2


def _task_pair(rng):
    frontier = np.sort(rng.choice(1 << 20, size=int(rng.integers(0, 40)),
                                  replace=False)).astype(np.int64)
    kw = dict(func=("eq", ["age", int(rng.integers(0, 99))]),
              lang="fr" if rng.random() < 0.5 else "",
              facet_keys=["w"] if rng.random() < 0.5 else [],
              first=int(rng.integers(-3, 4)))
    return (JTaskQuery("friend", frontier=frontier, **kw),
            TTaskQuery("friend", frontier=frontier, **kw))


def _result(mod_vals, rng):
    TypeID, Val, TaskResult = mod_vals
    rows = [np.sort(rng.choice(1000, size=int(rng.integers(0, 6)),
                               replace=False)).astype(np.int64)
            for _ in range(int(rng.integers(0, 5)))]
    vals = [[Val(TypeID.INT, int(x)) for x in r[:2]] for r in rows]
    facs = [[(("w", Val(TypeID.FLOAT, float(x) / 8)),) for x in r[:1]]
            for r in rows]
    dest = np.unique(np.concatenate(rows)) if rows else np.zeros(0, np.int64)
    return TaskResult(uid_matrix=rows, value_matrix=vals, facet_matrix=facs,
                      counts=[len(r) for r in rows], dest_uids=dest,
                      traversed_edges=int(sum(len(r) for r in rows)))


@pytest.mark.parametrize("seed", range(4))
def test_codecs_byte_identical(seed):
    """encode_task / encode_result / encode_edge give the same bytes in
    both packages, and each package decodes the other's."""
    jq, tq = _task_pair(np.random.default_rng(seed))
    jb = jremote.encode_task(jq, 42, min_applied=7,
                             replica_read=True).SerializeToString()
    tb = tremote.encode_task(tq, 42, min_applied=7,
                             replica_read=True).SerializeToString()
    assert jb == tb
    back, ts = tremote.decode_task(tipb.TaskRequest.FromString(jb))
    assert ts == 42 and back.func == tq.func and back.first == tq.first
    np.testing.assert_array_equal(back.frontier, tq.frontier)
    jr = _result((JTypeID, JVal, JTaskResult), np.random.default_rng(seed))
    tr = _result((TTypeID, TVal, TTaskResult), np.random.default_rng(seed))
    jb = jremote.encode_result(jr).SerializeToString()
    assert tremote.encode_result(tr).SerializeToString() == jb
    rt = tremote.decode_result(tipb.TaskResponse.FromString(jb))
    assert tremote.encode_result(rt).SerializeToString() == jb
    je = JEdge(subject=9, attr="age", object_uid=0,
               value=JVal(JTypeID.INT, seed), op=JOp.SET,
               facets=(("w", JVal(JTypeID.FLOAT, 0.5)),))
    te = TEdge(subject=9, attr="age", object_uid=0,
               value=TVal(TTypeID.INT, seed), op=TOp.SET,
               facets=(("w", TVal(TTypeID.FLOAT, 0.5)),))
    jb = jremote.encode_edge(je).SerializeToString()
    assert tremote.encode_edge(te).SerializeToString() == jb
    assert tremote.decode_edge(tipb.Edge.FromString(jb)) == te


def _walk_dedup(seen, frontier, uid_matrix, allow_loop):
    """The reference's per-edge set walk over (from, to) keys."""
    out = []
    for u, targets in zip(frontier, uid_matrix):
        kept = []
        for t in targets:
            ek = (int(u), int(t))
            if not allow_loop and ek in seen:
                continue
            seen.add(ek)
            kept.append(int(t))
        out.append(np.asarray(kept, dtype=np.int64))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_per_task_recurse_dedup_equals_set_walk(seed):
    """A recurse level expanded per task (over the wire) drops edges seen
    at earlier levels: the vectorized dedup keeps exactly the per-edge set
    walk's targets, in order, level after level, duplicates inside a level
    included; a result outside the uid space is refused."""
    from dgraph_tpu_torch.query.engine import QueryError
    from dgraph_tpu_torch.query.recurse import _dedup_task_edges

    rng = np.random.default_rng(seed)
    seen_keys, walk = {}, set()
    hi = 60 if seed % 2 else (1 << 31) - 1
    for level in range(4):
        frontier = np.unique(rng.integers(1, hi, size=12)).astype(np.int64)
        # sorted rows (as a CSR answers) on some levels, unsorted on others
        mat = [rng.choice(frontier, size=int(rng.integers(0, 9)))
               .astype(np.int64) for _ in frontier]
        if (seed + level) % 2:
            mat = [np.unique(m) for m in mat]
        got = _dedup_task_edges(seen_keys, "f", frontier, mat, False)
        want = _walk_dedup(walk, frontier, mat, False)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    loop = _dedup_task_edges({}, "f", frontier, mat, True)
    assert [g.tolist() for g in loop] == [m.tolist() for m in mat]
    with pytest.raises(QueryError, match="uid space"):
        _dedup_task_edges({}, "f", frontier[:1],
                          [np.asarray([(1 << 31) - 1])], False)


def _entry_points(tmp_path):
    from dgraph_tpu_torch.coord.cluster import Cluster
    from dgraph_tpu_torch.coord.replication import FollowerReader, ReplicaGroup

    return {
        "WorkerService": lambda: tremote.WorkerService(tstore.Store()),
        "serve_worker": lambda: tremote.serve_worker(tstore.Store(),
                                                     "localhost:0"),
        "Cluster": lambda: Cluster(2),
        "ReplicaGroup": lambda: ReplicaGroup(str(tmp_path), n=3),
        "FollowerReader": lambda: FollowerReader(),
    }


@pytest.mark.parametrize("name", ["WorkerService", "serve_worker", "Cluster",
                                  "ReplicaGroup", "FollowerReader"])
def test_wire_entry_points_default_to_cuda(name, tmp_path, monkeypatch):
    """Every wire entry point that touches a snapshot defaults to the card
    and raises without one: the CPU runs only when the caller asks."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points(tmp_path)[name]()


def test_worker_cli_defaults_to_cuda(tmp_path):
    """`python -m dgraph_tpu_torch worker` without --device asks for the
    card and fails where there is none (this machine); --device cpu
    serves and says so in its banner."""
    import torch

    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    args = [sys.executable, "-m", "dgraph_tpu_torch", "worker", "--port",
            "0", "-p", str(tmp_path / "w")]
    if not torch.cuda.is_available():
        proc = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert "cuda" in proc.stderr + proc.stdout
    proc = subprocess.Popen(args + ["--device", "cpu"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        line = ""
        while "serving" not in line:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "worker exited"
        assert "device=cpu" in line and "tablets on" in line
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_read_executor_is_the_query_path(reference):
    """ClusterClient.read_executor() is the Executor query() runs: its
    answers are query()'s, and a SubGraph walked on it (how the smoke times
    the headline @recurse without its JSON) reaches each level's uids."""
    from dgraph_tpu_torch.query import dql
    from dgraph_tpu_torch.query import engine as eng

    w = _Wire("t", "tt", "t")
    try:
        w.client.mutate(set_nquads=_graph_quads())
        for qi, q in enumerate(BATTERY):
            w.client.task_cache.clear()
            got = w.client.read_executor().execute(dql.parse(q))
            assert json.dumps(got) == reference[qi]
        q = BATTERY[8].replace("{ name follows }", "{ uid follows }")
        parsed = dql.parse(q)           # @recurse(depth: 3) from p4
        sg = eng.SubGraph(gq=parsed.queries[0], attr=parsed.queries[0].attr)
        w.client.read_executor()._process_block(sg)
        levels = []
        while True:
            sg = next((c for c in sg.children if c.attr == "follows"), None)
            if sg is None:
                break
            levels.append({int(u) for u in sg.dest_uids})
        # the same recurse through query(): the uids at each JSON depth
        depth, nodes = [], w.client.query(q)["q"]
        while nodes:
            nodes = [c for n in nodes for c in n.get("follows", [])]
            if nodes:
                depth.append({int(c["uid"], 16) for c in nodes})
        assert len(levels) >= 2 and levels[0]
        assert all(lv <= d for lv, d in zip(levels, depth))
        assert set().union(*levels) == set().union(*depth)
    finally:
        w.close()
