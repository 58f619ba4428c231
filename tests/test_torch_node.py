"""The port's serving Node against expected.json and the JAX Node, on the
CPU.

The port's Node(device="cpu") takes the golden schema and dataset through
alter → mutate → query, and every one of the 38 golden answers must equal
tests/golden/expected.json. Then a seeded request sequence goes to a JAX
Node and a port Node side by side (the `Twin`): each step must give the
same JSON, the same TxnConflict raises, the same commit timestamps and the
same assigned uids — blank nodes, deletes and `S * *` deletes, a
conflicting pair of transactions, upserts with @if, read-your-writes in an
open transaction, alter(drop_attr=), a deadline that runs out, result and
task cache hits and their invalidation by a commit to one predicate, two
tenants, a slow-log entry and the /debug/top rows of the cost ledger. Both
Nodes of the Twin run with their planner, batcher and device observatory
off, so that span trees and cost records line up.

The serving seams that default on in both packages (the planner, the
batcher, the device observatory, the HBM working-set manager under a
budget and pins) and the methods behind them (set_memory_budget,
enforce_memory, set_devprof, query(explain=True), Executor(plan=,
explain=, batcher=)) each answer as the JAX Node's do with the same
setting, and so do the mesh seams: Node(mesh_devices=), Node.analytics and
Executor(mesh=) (their full suites: tests/test_torch_mesh.py,
test_torch_fused.py, test_torch_analytics.py).

The paged store: Node(dirpath, memory_mb=) in the port answers as an eager
port Node and as the JAX paged Node, and Store(memory_budget=) folds equal
the JAX store's, each package opening the other's directory.

Every Node is closed by a fixture finalizer: the rollup thread must not
outlive its test.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dgraph_tpu import tenancy as jtnc
from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.coord.zero import TxnConflict as JTxnConflict
from dgraph_tpu.query import dql as jdql
from dgraph_tpu.storage import csr_build as jcb
from dgraph_tpu.storage.store import Store as JStore
from dgraph_tpu.utils.deadline import DeadlineExceeded as JDeadline

from dgraph_tpu_torch import tenancy as ttnc
from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.coord.zero import TxnConflict as TTxnConflict
from dgraph_tpu_torch.query import engine as teng
from dgraph_tpu_torch.query import groupby as tgb
from dgraph_tpu_torch.storage import csr_build as tcb
from dgraph_tpu_torch.storage.store import Store as TStore
from dgraph_tpu_torch.utils.deadline import DeadlineExceeded as TDeadline

REPO = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _load("golden_battery_node", REPO / "tests" / "test_golden.py")
STORAGE = _load("torch_storage_node",
                REPO / "tests" / "test_torch_storage.py")
EXPECTED = json.loads((REPO / "tests" / "golden" / "expected.json")
                      .read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def nodes(request):
    """Factory of Nodes closed at teardown."""
    made = []

    def make(cls, *a, **kw):
        n = cls(*a, **kw)
        made.append(n)
        return n

    yield make
    for n in made:
        n.close()


def _port_node(make, *a, **kw):
    return make(TNode, *a, device="cpu", **kw)


def _jax_node(make, *a, **kw):
    return make(JNode, *a, planner=False, batching=False, devprof=False,
                **kw)


# ---------------------------------------------------------------------------
# the golden battery through the port's Node
# ---------------------------------------------------------------------------

def test_golden_battery_through_node(nodes):
    """alter → mutate → query: all 38 answers equal expected.json, compared
    as tests/test_golden.py compares them."""
    n = _port_node(nodes)
    n.alter(schema_text=GOLDEN.SCHEMA)
    n.mutate(set_nquads=GOLDEN._dataset(), commit_now=True)
    got = {name: n.query(q)[0] for name, q in GOLDEN.QUERIES}
    got_j = json.loads(json.dumps(got, default=str))
    assert len(got_j) == 38
    assert sorted(got_j) == sorted(EXPECTED)
    for name in EXPECTED:
        assert got_j[name] == EXPECTED[name], name


def test_node_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TNode()


@pytest.mark.parametrize("kw,slice_name", [
    ({"mesh_devices": -1}, "mesh"),
], ids=lambda x: str(x))
def test_off_seams_raise_naming_their_slice(nodes, kw, slice_name):
    """The seam that raised naming its slice until the mesh came now
    answers: Node(mesh_devices=-1) on the CPU is a one-shard mesh (the CPU
    is one device; the JAX tests' CPU platform is forced to eight), and its
    golden answers equal expected.json and the JAX mesh Node's."""
    t = _port_node(nodes, mesh_min_edges=1, **kw)
    j = nodes(JNode, mesh_min_edges=1, **kw)
    assert t.mesh_exec is not None and t.mesh_exec.n_devices == 1
    assert j.mesh_exec.n_devices == 8
    for n in (t, j):
        n.alter(schema_text=GOLDEN.SCHEMA)
        n.mutate(set_nquads=GOLDEN._dataset(), commit_now=True)
    for name, q in GOLDEN.QUERIES[:12]:
        got = json.loads(json.dumps(t.query(q)[0], default=str))
        assert got == EXPECTED[name] == \
            json.loads(json.dumps(j.query(q)[0], default=str)), name
    key = "dgraph_mesh_sharded_tablets"
    assert t.metrics.counter(key).value == j.metrics.counter(key).value > 0


@pytest.mark.parametrize("call,slice_name", [
    (lambda n: n.analytics("pagerank", "friend"), "mesh"),
], ids=["analytics"])
def test_off_methods_raise_naming_their_slice(nodes, call, slice_name):
    """Node.analytics answers as the JAX Node's: over a Node without a
    mesh, the float64 host oracles, the same dict; a predicate without uid
    edges, the same ValueError."""
    t, j = _port_node(nodes), _jax_node(nodes)
    errs = []
    for n in (t, j):
        with pytest.raises(ValueError) as e:
            call(n)
        errs.append(str(e.value))
        n.alter(schema_text="friend: [uid] @reverse .")
        n.mutate(set_nquads="<0x1> <friend> <0x2> .\n<0x2> <friend> <0x3> ."
                            "\n<0x3> <friend> <0x1> .\n<0x4> <friend> <0x5> .",
                 commit_now=True)
    assert errs[0] == errs[1]
    for kind in ("pagerank", "cc", "triangles"):
        a, b = t.analytics(kind, "friend"), j.analytics(kind, "friend")
        assert json.dumps(a) == json.dumps(b), kind
        assert a["device"] is False
    assert call(t)["top"][0]["uid"] == call(j)["top"][0]["uid"]


@pytest.mark.parametrize("kw,slice_name", [({"mesh": 8}, "mesh")])
def test_executor_off_seams_raise(kw, slice_name):
    """Executor(mesh=) runs the fused chain over a placed snapshot: the
    port's MeshExecutor on 8 repeats of the CPU device against the JAX
    MeshExecutor, the same JSON, one mesh program each."""
    from dgraph_tpu.parallel.mesh_exec import MeshExecutor as JME
    from dgraph_tpu.query import dql as jdql
    from dgraph_tpu.query.engine import Executor as JExecutor
    from dgraph_tpu.utils import schema as jsch
    from dgraph_tpu.utils.types import TypeID as JTypeID
    from dgraph_tpu_torch import carry
    from dgraph_tpu_torch.parallel.mesh import make_mesh
    from dgraph_tpu_torch.parallel.mesh_exec import MeshExecutor as TME
    from dgraph_tpu_torch.query import dql as tdql
    from dgraph_tpu_torch.utils import schema as tsch

    S = kw["mesh"]
    rng = np.random.default_rng(3)
    arrays = {}
    for attr in ("a", "b"):
        e = np.unique(rng.integers(1, 200, size=(900, 2)), axis=0)
        e = e[e[:, 0] != e[:, 1]]
        subs, counts = np.unique(e[:, 0], return_counts=True)
        ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        arrays[attr] = (subs.astype(np.int32), ptr, e[:, 1].astype(np.int32))
    jsnap = jcb.GraphSnapshot(1)
    for attr, (s, p, i) in arrays.items():
        jsnap.preds[attr] = jcb.PredData(attr, JTypeID.UID,
                                         csr=jcb.PredCSR(s, p, i))
    tsnap = carry.snapshot_from_numpy(
        {a: (int(JTypeID.UID), *v) for a, v in arrays.items()}, 1,
        device="cpu")
    jschema, tschema = jsch.SchemaState(), tsch.SchemaState()
    for mod, sch in ((jsch, jschema), (tsch, tschema)):
        for e in mod.parse_schema("a: [uid] .\nb: [uid] ."):
            sch.set(e)
    jm = JME(n_devices=S, shard_min_edges=1)
    tm = TME(mesh=make_mesh(S, devices=[torch.device("cpu")] * S),
             shard_min_edges=1)
    q = "{ q(func: uid(0x3, 0x9, 0x20)) { a (first: 3) { b { a } } } }"
    a = JExecutor(jm.place_snapshot(jsnap), jschema,
                  mesh=jm).execute(jdql.parse(q))
    b = teng.Executor(tm.place_snapshot(tsnap), tschema,
                      mesh=tm).execute(tdql.parse(q))
    assert json.dumps(b, sort_keys=True) == json.dumps(a, sort_keys=True)
    for m in (jm, tm):
        assert m.metrics.counter("dgraph_mesh_dispatches_total").value == 1
        assert m.metrics.counter("dgraph_mesh_fused_queries_total").value == 1


# ---------------------------------------------------------------------------
# the serving seams that default on, each equal to the JAX Node's
# ---------------------------------------------------------------------------

SEAM_READS = [
    '{ q(func: has(name)) @filter(eq(city, "ams") AND ge(age, 30)) '
    '{ name age friend { name } } }',
    '{ q(func: eq(name, "p0")) @recurse(depth: 3) { name friend } }',
    '{ q(func: ge(age, 40), orderdesc: age, first: 5) { name ~friend '
    '{ name } } }',
]


def _seam_pair(nodes, **kw):
    """A port Node and a JAX Node with the same seam setting, over the
    same seeded data."""
    t = _port_node(nodes, **kw)
    j = nodes(JNode, **kw)
    for n in (t, j):
        n.alter(schema_text=SCHEMA)
        n.mutate(set_nquads=_seed_quads(), commit_now=True)
    return t, j


def _same_reads(t, j, reads=SEAM_READS):
    for q in reads:
        assert json.dumps(t.query(q)[0], default=str) == \
            json.dumps(j.query(q)[0], default=str), q


@pytest.mark.parametrize("kw,check", [
    ({"planner": True},
     lambda n: n.planner_enabled and n.metrics.counter(
         "dgraph_planner_plans_total").value > 0),
    ({"batching": True}, lambda n: n.batcher is not None),
    ({"devprof": True},
     lambda n: n.dispatch_gate.profiler is n.devprof and n.metrics.counter(
         "dgraph_devprof_dispatches_total").value > 0),
    ({"device_budget_mb": 64},
     lambda n: n.residency.budget == 64 << 20 and n.residency.enabled),
    ({"residency_pin": "friend"},
     lambda n: n.residency.pins == {"friend"}),
], ids=["planner", "batching", "devprof", "device_budget_mb",
        "residency_pin"])
def test_seams_work_and_equal_jax(nodes, kw, check):
    t, j = _seam_pair(nodes, **kw)
    _same_reads(t, j)
    assert check(t) and check(j)


@pytest.mark.parametrize("call", [
    lambda n: n.set_memory_budget(1 << 20) or n.memory_budget,
    lambda n: sorted(n.enforce_memory(1 << 20)),
    lambda n: (n.set_devprof(False), n.devprof, n.dispatch_gate.profiler,
               n.set_devprof(True), n.devprof is not None)[1:3] + (
                  n.dispatch_gate.profiler is n.devprof,),
    lambda n: n.query('{ q(func: has(name)) @filter(eq(city, "ber")) '
                      '{ name } }', explain=True)[0],
], ids=["set_memory_budget", "enforce_memory", "set_devprof", "explain"])
def test_methods_work_and_equal_jax(nodes, call):
    t, j = _seam_pair(nodes)
    got, want = call(t), call(j)
    assert json.dumps(got, default=str) == json.dumps(want, default=str)
    _same_reads(t, j)


@pytest.mark.parametrize("seam", ["plan", "explain", "batcher"])
def test_executor_seams_work(nodes, seam):
    """Executor(plan=, explain=, batcher=): the same JSON as a plain
    Executor and as the JAX Executor with the same seam."""
    from dgraph_tpu.query import batch as jbatch
    from dgraph_tpu.query import engine as jeng
    from dgraph_tpu.query import planner as jplanner
    from dgraph_tpu_torch.query import batch as tbatch
    from dgraph_tpu_torch.query import planner as tplanner

    t, j = _seam_pair(nodes, planner=False, batching=False)
    q = SEAM_READS[0]
    outs = []
    for n, eng, pl, bt, parse in ((t, teng, tplanner, tbatch, t._parse),
                                  (j, jeng, jplanner, jbatch, j._parse)):
        snap, schema = n.snapshot(), n.store.schema
        req = parse(q, None)
        kw = {}
        if seam in ("plan", "explain"):
            kw["plan"] = pl.build_plan(req, snap, schema)
        if seam == "explain":
            kw["explain"] = {}
        if seam == "batcher":
            kw["batcher"] = bt.DeviceBatcher(n.dispatch_gate, n.metrics)
        got = eng.Executor(snap, schema, gate=n.dispatch_gate,
                           **kw).execute(req)
        assert got == eng.Executor(snap, schema).execute(req)
        if seam == "explain":
            got = pl.render_explain(kw["plan"], kw["explain"])
            assert any(v is not None for v in kw["explain"].values())
        outs.append(json.dumps(got, default=str))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the seeded request sequence, JAX Node and port Node side by side
# ---------------------------------------------------------------------------

SCHEMA = """
name: string @index(exact) .
email: string @index(exact) @upsert .
age: int @index(int) .
city: string @index(exact) .
friend: [uid] @reverse @count .
"""


class Twin:
    """One JAX Node and one port Node fed the same requests."""

    def __init__(self, make, **kw):
        self.j = _jax_node(make, **kw)
        self.t = _port_node(make, planner=False, batching=False,
                            devprof=False, **kw)

    def both(self, fn, may_raise=False):
        """fn(node, package) on each side → (JAX result, port result),
        where package names the side's own TxnConflict, DeadlineExceeded
        and tenancy module. With may_raise, a raise becomes ("raised",
        type name, text)."""
        out = []
        for n, p in ((self.j, SimpleNS(JTxnConflict, JDeadline, jtnc)),
                     (self.t, SimpleNS(TTxnConflict, TDeadline, ttnc))):
            try:
                out.append(fn(n, p))
            except Exception as e:      # compared across the packages
                if not may_raise:
                    raise
                out.append(("raised", type(e).__name__, str(e)))
        return tuple(out)

    def same(self, fn, may_raise=False):
        j, t = self.both(fn, may_raise)
        assert json.dumps(t, default=str) == json.dumps(j, default=str)
        return t

    def query(self, q, may_raise=False, **kw):
        return self.same(lambda n, p: n.query(q, **kw)[0], may_raise)

    def mutate(self, **kw):
        """Same assigned uids and the same start/commit timestamps."""
        def run(n, p):
            res = n.mutate(**kw)
            return {"uids": res.uids, "start": res.context.start_ts,
                    "commit": res.context.commit_ts}
        return self.same(run)

    def counter(self, name):
        return self.both(lambda n, p: n.metrics.counter(name).value)


class SimpleNS:
    def __init__(self, conflict, deadline, tnc):
        self.TxnConflict = conflict
        self.DeadlineExceeded = deadline
        self.tnc = tnc


def _seed_quads(seed=23, n=30):
    rng = np.random.default_rng(seed)
    quads = []
    for i in range(n):
        quads.append(f'_:p{i} <name> "p{i}" .')
        quads.append(f'_:p{i} <age> "{int(rng.integers(18, 60))}"'
                     '^^<xs:int> .')
        quads.append(f'_:p{i} <city> "{["ams", "ber", "cdg"][i % 3]}" .')
        if i % 4 == 0:
            quads.append(f'_:p{i} <email> "p{i}@x.io" .')
        for t in rng.choice(n, 3, replace=False):
            if t != i:
                quads.append(f"_:p{i} <friend> _:p{int(t)} .")
    return "\n".join(quads)


READS = [
    '{ q(func: has(name), orderasc: name, first: 8) { uid name age '
    'count(friend) friend { name } } }',
    '{ q(func: ge(age, 40), orderdesc: age) { name age city } }',
    '{ var(func: has(name)) { a as age } '
    '  q(func: has(name)) @groupby(city) { count(uid) s: sum(val(a)) '
    'lo: min(val(a)) hi: max(val(a)) mean: avg(val(a)) } }',
    '{ q(func: eq(city, "ber")) @groupby(friend) { count(uid) } }',
    '{ q(func: eq(name, "p0")) @recurse(depth: 3) { name friend } }',
    '{ q(func: eq(name, "p1")) { name ~friend { name } } }',
]


@pytest.fixture
def twin(nodes):
    tw = Twin(nodes, span_sample=1.0, slow_query_ms=0.001)
    tw.same(lambda n, p: n.alter(schema_text=SCHEMA))
    tw.seeded = tw.mutate(set_nquads=_seed_quads(), commit_now=True)
    return tw


def _uid(tw, name):
    return tw.seeded["uids"]["_:" + name]


def test_seeded_writes_and_reads(twin):
    assert len(twin.seeded["uids"]) == 30 and twin.seeded["commit"] > 0
    for q in READS:
        twin.query(q)


def test_deletes_and_star_deletes(twin):
    a, b = hex(_uid(twin, "p1")), hex(_uid(twin, "p2"))
    twin.mutate(set_nquads=f"<{a}> <friend> <{b}> .", commit_now=True)
    twin.mutate(del_nquads=f"<{a}> <friend> <{b}> .", commit_now=True)
    twin.mutate(del_nquads=f"<{b}> * * .", commit_now=True)
    twin.mutate(del_nquads=f"<{a}> <age> * .", commit_now=True)
    for q in READS + ['{ q(func: uid(%s, %s)) { name age friend '
                      '{ name } } }' % (a, b)]:
        twin.query(q)


def test_conflicting_pair(twin):
    """Two transactions write the same @upsert value: the first committer
    wins, the second raises TxnConflict on both sides, at the same
    timestamps."""
    u = hex(_uid(twin, "p4"))

    def run(n, p):
        t1, t2 = n.new_txn(), n.new_txn()
        n.mutate(set_nquads=f'<{u}> <email> "one@x.io" .',
                 start_ts=t1.start_ts)
        n.mutate(set_nquads=f'<{u}> <email> "two@x.io" .',
                 start_ts=t2.start_ts)
        c1 = n.commit(t1.start_ts)
        with pytest.raises(p.TxnConflict):
            n.commit(t2.start_ts)
        return [t1.start_ts, t2.start_ts, c1]
    twin.same(run)
    twin.query('{ q(func: uid(%s)) { email } }' % u)


def test_upsert_with_conditions(twin):
    block = '''upsert {
  query { v as var(func: eq(email, "%s")) }
  mutation @if(eq(len(v), 0)) { set { _:n <email> "%s" .
    _:n <name> "fresh" . } }
  mutation @if(gt(len(v), 0)) { set { uid(v) <name> "seen" . } }
}'''
    for email in ("new@x.io", "new@x.io", "p0@x.io"):
        q = block % (email, email)
        twin.same(lambda n, p: n.upsert(
            jdql.parse(q).upsert["query"], jdql.parse(q).upsert["mutations"],
            commit_now=True)[:2])
        twin.query('{ q(func: eq(email, "%s")) { name } }' % email)
    twin.query('{ q(func: has(email), orderasc: email) { email name } }')


def test_read_your_writes_in_open_txn(twin):
    u = hex(_uid(twin, "p5"))
    probe = '{ q(func: uid(%s)) { name age } }' % u

    def run(n, p):
        res = n.mutate(set_nquads=f'<{u}> <age> "99"^^<xs:int> .')
        st = res.context.start_ts
        inside = n.query(probe, start_ts=st)[0]
        outside = n.query(probe)[0]
        ct = n.commit(st)
        after = n.query(probe)[0]
        return [st, ct, inside, outside, after]
    got = twin.same(run)
    assert got[2]["q"][0]["age"] == 99 and got[3]["q"][0]["age"] != 99
    assert got[4]["q"][0]["age"] == 99


def test_alter_drop_attr(twin):
    twin.same(lambda n, p: n.alter(drop_attr="city"))
    for q in READS:
        twin.query(q, may_raise=True)
    assert twin.query(READS[3], may_raise=True)[0] == "raised"
    assert twin.query('{ q(func: has(city)) { name } }') == {}


def test_deadline_runs_out(twin):
    q = '{ q(func: has(name)) { name friend { name friend { name } } } }'

    def run(n, p):
        with pytest.raises(p.DeadlineExceeded):
            n.query(q, timeout_ms=1e-6)
        return n.metrics.counter("dgraph_deadline_exceeded_total").value
    assert twin.same(run) == 1
    twin.query(q, timeout_ms=60_000)


def test_cache_hits_and_invalidation(twin):
    """A replay hits the result cache; a commit to `age` rotates only the
    plans that read `age`; a new request over cached predicates hits the
    task cache."""
    q_age = '{ q(func: ge(age, 30)) { name age } }'
    q_city = '{ q(func: eq(city, "ams")) { name } }'
    hits = "dgraph_result_cache_hits_total"
    for q in (q_age, q_city, q_age, q_city):
        twin.query(q)
    assert twin.counter(hits) == (2, 2)
    u = hex(_uid(twin, "p7"))
    twin.mutate(set_nquads=f'<{u}> <age> "31"^^<xs:int> .', commit_now=True)
    twin.query(q_city)
    assert twin.counter(hits) == (3, 3)          # city untouched: a hit
    twin.query(q_age)
    assert twin.counter(hits) == (3, 3)          # age rotated: re-executed
    t0 = twin.counter("dgraph_task_cache_hits_total")
    twin.query('{ q(func: eq(city, "ams")) { name city } }')
    t1 = twin.counter("dgraph_task_cache_hits_total")
    assert t1[0] > t0[0] and t1[1] - t0[1] == t1[0] - t0[0]


def test_tenants_do_not_see_each_other(twin):
    def run(n, p):
        out = {}
        for tenant, tag in (("acme", "a"), ("beta", "b")):
            with p.tnc.scope(tenant):
                n.alter(schema_text="name: string @index(exact) .\n"
                                    "friend: [uid] .")
                res = n.mutate(set_nquads="\n".join(
                    [f'_:x{i} <name> "{tag}{i}" .' for i in range(3)] +
                    [f"_:x0 <friend> _:x{i} ." for i in (1, 2)]),
                    commit_now=True)
                out[tenant] = res.uids
        for tenant in ("acme", "beta", ""):
            with p.tnc.scope(tenant):
                out["q" + tenant] = n.query(
                    '{ q(func: has(name), orderasc: name) '
                    '{ name friend { name } } }')[0]
        out["preds"] = sorted(n.store.predicates())
        return out
    got = twin.same(run)
    assert {r["name"] for r in got["qacme"]["q"]} == {"a0", "a1", "a2"}
    assert {r["name"] for r in got["qbeta"]["q"]} == {"b0", "b1", "b2"}
    assert "acme/name" in got["preds"]


def test_slow_log_and_cost_ledger(twin):
    """The armed slow log records every request (threshold 0.001 ms);
    /debug/top ranks the same shapes, predicates, task and edge counts."""
    q = READS[0]
    twin.query(q)

    def slow(n, p):
        e = next(e for e in n.slow_log.recent() if e["root"] == "query"
                 and e["query"] == q.strip().splitlines()[0][:120])
        names = set()

        def walk(nodes):
            for node in nodes:
                names.add(node["name"].split(":")[0])
                walk(node.get("children", []))
        walk(e["tree"])
        return {"error": e["error"], "spans": sorted(names)}
    got = twin.same(slow)
    assert "task" in got["spans"]

    def top(n, p):
        rows = n.cost_book.top(window_s=600, by="edges", group="pred")
        shapes = n.cost_book.top(window_s=600, group="shape")
        return {"preds": [(r["key"], r["records"], r["tasks"], r["edges"])
                          for r in rows["top"]],
                "shapes": sorted((r["key"], r["records"], r["edges"])
                                 for r in shapes["top"]),
                "records": shapes["records_in_window"]}
    got = twin.same(top)
    assert got["records"] >= 1 and any(k == "friend" for k, *_ in
                                       got["preds"])


def test_run_request_and_health(twin):
    twin.same(lambda n, p: n.run_request(
        '{ set { _:z <name> "zed" . } }')[1].uids)
    twin.query('{ q(func: eq(name, "zed")) { name } }')
    twin.same(lambda n, p: n.health()["maxAssigned"])
    twin.same(lambda n, p: sorted(n.state()))


# ---------------------------------------------------------------------------
# the paged store
# ---------------------------------------------------------------------------

PAGED_SCHEMA = ("name: string @index(exact) .\nage: int @index(int) .\n"
                "friend: [uid] .")
PAGED_QUERIES = [
    '{ q(func: eq(name, "p7")) { name age friend { name } } }',
    '{ q(func: ge(age, 60), orderasc: name, first: 5) { name age } }',
    '{ q(func: uid(0x1)) @recurse(depth: 2) { friend } }',
    '{ q(func: has(friend)) { count(uid) } }',
    '{ var(func: has(age)) { a as age } '
    '  q(func: has(name)) @groupby(friend) { count(uid) s: sum(val(a)) } }',
]


def _paged_dataset(make, cls_maker, d, n=400):
    """The dataset of tests/test_paged.py, written and checkpointed."""
    node = cls_maker(make, dirpath=d)
    node.alter(schema_text=PAGED_SCHEMA)
    rng = np.random.default_rng(11)
    quads = []
    for i in range(1, n + 1):
        quads.append(f'<0x{i:x}> <name> "p{i}" .')
        quads.append(f'<0x{i:x}> <age> "{20 + i % 50}"^^<xs:int> .')
        for _ in range(3):
            t = int(rng.integers(1, n + 1))
            quads.append(f"<0x{i:x}> <friend> <0x{t:x}> .")
    node.mutate(set_nquads="\n".join(quads), commit_now=True)
    node.store.checkpoint(node.store.max_seen_commit_ts)
    node.close()


@pytest.fixture
def paged_dirs(nodes, tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _paged_dataset(nodes, _jax_node, jdir)
    _paged_dataset(nodes, _port_node, tdir)
    return jdir, tdir


def test_paged_node_matches_eager_and_jax(nodes, paged_dirs):
    jdir, tdir = paged_dirs
    eager = _port_node(nodes, dirpath=tdir)
    outs_e = [eager.query(q)[0] for q in PAGED_QUERIES]
    eager.close()
    paged = _port_node(nodes, dirpath=tdir, memory_mb=64)
    assert paged.store.paged and paged.store._segments
    outs_p = [paged.query(q)[0] for q in PAGED_QUERIES]
    jpaged = _jax_node(nodes, dirpath=jdir, memory_mb=64)
    outs_j = [jpaged.query(q)[0] for q in PAGED_QUERIES]
    for e, p, j in zip(outs_e, outs_p, outs_j):
        assert json.dumps(p) == json.dumps(e) == json.dumps(j)
    # a write on top of segment-backed keys, then the same reads
    for n in (paged, jpaged):
        n.mutate(set_nquads='<0x7> <friend> <0x9> .\n<0x7> <age> '
                            '"61"^^<xs:int> .', commit_now=True)
    for q in PAGED_QUERIES:
        assert json.dumps(paged.query(q)[0]) == json.dumps(jpaged.query(q)[0])


@pytest.mark.parametrize("budget", [1, 1 << 20])
@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_paged_store_folds_equal_jax(paged_dirs, budget, direction):
    """Store(memory_budget=) folds equal the JAX store's, each package
    opening the directory the other wrote."""
    jdir, tdir = paged_dirs
    src = jdir if direction == "port_reads_jax" else tdir
    t_open = TStore(src, memory_budget=budget)
    j_open = JStore(src, memory_budget=budget)
    try:
        assert t_open.paged and j_open.paged
        ts = t_open.max_seen_commit_ts
        assert ts == j_open.max_seen_commit_ts
        STORAGE.assert_snap_equal(jcb.build_snapshot(j_open, ts),
                                  tcb.build_snapshot(t_open, ts,
                                                     device="cpu"))
    finally:
        t_open.close()
        j_open.close()


# ---------------------------------------------------------------------------
# the guard: serving through the Node loads neither jax nor dgraph_tpu
# ---------------------------------------------------------------------------

_GUARD = r"""
import json, sys
before = set(sys.modules)
from dgraph_tpu_torch.api.server import Node
n = Node(device="cpu")
n.alter(schema_text="name: string @index(exact) .\nage: int .\n"
                    "friend: [uid] .")
n.mutate(set_nquads='_:a <name> "a" .\n_:b <name> "b" .\n'
                    '_:a <age> "3"^^<xs:int> .\n_:a <friend> _:b .',
         commit_now=True)
out, _ = n.query('{ var(func: has(name)) { x as age } '
                 'q(func: has(name)) @groupby(friend) { count(uid) '
                 's: sum(val(x)) } }')
n.close()
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib")
             or m == "dgraph_tpu" or m.startswith("dgraph_tpu."))
print(json.dumps({"bad": bad, "out": out,
                  "loaded": sorted(m for m in new
                                   if m.startswith("dgraph_tpu_torch."))}))
"""


def test_node_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["out"]["q"][0]["@groupby"] == [
        {"friend": res["out"]["q"][0]["@groupby"][0]["friend"],
         "count": 1, "s": 3}]
    for mod in ("api.server", "coord.zero", "obs.costs", "obs.otrace",
                "obs.slowlog", "query.groupby", "query.qcache",
                "query.upsert", "parallel.scheduler", "storage.writebatch",
                "tenancy", "utils.metrics", "utils.retry"):
        assert "dgraph_tpu_torch." + mod in res["loaded"], mod


def test_uid_list_key_takes_the_rank_path(nodes, monkeypatch):
    """A [uid] group key codes through the rank table in the port (the
    JAX package sends it to the per-uid dict path); same answers."""
    from dgraph_tpu_torch.ops import segments as tsegs

    monkeypatch.setattr(tsegs, "_RANK_DEVICE_MIN", 0)
    t = _port_node(nodes)
    j = _jax_node(nodes)
    for n in (t, j):
        n.alter(schema_text=SCHEMA)
        n.mutate(set_nquads=_seed_quads(), commit_now=True)
    q = READS[3]
    before = tsegs.RANKS["cpu"]
    assert json.dumps(t.query(q)[0]) == json.dumps(j.query(q)[0])
    assert tsegs.RANKS["cpu"] == before + 1
    monkeypatch.setattr(tgb, "VECTORIZE", False)
    t.result_cache.clear()
    assert json.dumps(t.query(q)[0]) == json.dumps(j.query(q)[0])
    assert tsegs.RANKS["cpu"] == before + 1


def test_tenant_uid_root_answers(nodes):
    """A tenant's explicit uid(...) root: the port's namespace view holds
    the engine's known-uid cache and answers as the default namespace
    does; the JAX view has no slot for the cache and raises (a reference
    fault the port does not copy)."""
    t, j = _port_node(nodes), _jax_node(nodes)
    outs = {}
    for n, tnc in ((t, ttnc), (j, jtnc)):
        for tenant in ("", "acme"):
            with tnc.scope(tenant):
                n.alter(schema_text="name: string .\nfriend: [uid] .")
                r = n.mutate(set_nquads='_:a <name> "x" .\n_:b <name> "y" .'
                                        '\n_:a <friend> _:b .',
                             commit_now=True)
                q = "{ q(func: uid(%s)) { name friend { name } } }" % \
                    hex(r.uids["_:a"])
                try:
                    outs[(n is t, tenant)] = n.query(q)[0]
                except AttributeError as e:
                    outs[(n is t, tenant)] = ("raised", str(e))
    want = {"q": [{"name": "x", "friend": [{"name": "y"}]}]}
    assert outs[(True, "")] == outs[(True, "acme")] == outs[(False, "")] \
        == want
    assert outs[(False, "acme")][0] == "raised"
    assert "_known_uids_cache" in outs[(False, "acme")][1]


@pytest.mark.parametrize("row_buffer", [1, 1 << 20])
def test_checkpoint_bytes_equal_jax(nodes, tmp_path, monkeypatch,
                                    row_buffer):
    """The port's snapshot writer gathers rows before it spools them; the
    checkpoint file is byte for byte the JAX writer's, whether every row
    flushes at once (ROW_BUFFER 1) or the section flushes at its end."""
    from dgraph_tpu_torch.ingest import snapwrite

    monkeypatch.setattr(snapwrite, "ROW_BUFFER", row_buffer)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _paged_dataset(nodes, _jax_node, jdir)
    _paged_dataset(nodes, _port_node, tdir)
    got = (Path(tdir) / "snapshot.bin").read_bytes()
    assert got == (Path(jdir) / "snapshot.bin").read_bytes()
    assert len(got) > 20_000


def test_executor_dispatch_seams(nodes):
    """The Executor's seams without a Node: a dispatcher stands in for the
    local snapshot (explicit uids are then taken as they are), the gate
    and the task cache wrap it, and an on_task hook sees every task — a
    hook that raises never fails the query."""
    from dgraph_tpu_torch.query import dql as tdql
    from dgraph_tpu_torch.query import qcache
    from dgraph_tpu_torch.query.task import process_task

    n = _port_node(nodes)
    n.alter(schema_text=SCHEMA)
    n.mutate(set_nquads=_seed_quads(), commit_now=True)
    snap, schema = n.snapshot(), n._schema_view()
    q = READS[0]
    want = teng.Executor(snap, schema).execute(tdql.parse(q))
    seen, sent = [], []

    def dispatch(tq):
        sent.append(tq.attr)
        return process_task(snap, tq, schema)

    def hook(tq, res, dt):
        seen.append((tq.attr, len(res.dest_uids), dt >= 0))
        raise RuntimeError("accounting fault")

    cache = qcache.TaskResultCache(1 << 20)
    gate = qcache.DispatchGate(2)
    for _ in range(2):
        ex = teng.Executor(snap, schema, dispatch=dispatch, cache=cache,
                           gate=gate, on_task=hook)
        assert ex.execute(tdql.parse(q)) == want
    # every task reaches the hook; the second run is served by the cache
    half = len(seen) // 2
    assert len(seen) == 2 * half and seen[:half] == seen[half:]
    assert 0 < len(sent) <= half
    assert cache.metrics.counter("dgraph_task_cache_hits_total").value \
        == len(seen) - len(sent)
    ghost = "{ q(func: uid(0x7fffff0)) { uid } }"
    assert teng.Executor(snap, schema).execute(tdql.parse(ghost)) == {}
    assert teng.Executor(snap, schema, dispatch=dispatch).execute(
        tdql.parse(ghost)) == {"q": [{"uid": "0x7fffff0"}]}


POSTINGS_SCHEMA = ("name: string @index(exact) @lang .\n"
                   "age: int @index(int) .\nfriend: [uid] @reverse .")
POSTINGS_QUADS = "\n".join([
    '<0x1> <name> "ann" .', '<0x1> <name> "anne"@fr .',
    '<0x2> <name> "bo" .', '<0x3> <name> "ann" .',
    '<0x1> <age> "31"^^<xs:int> .', '<0x2> <age> "31"^^<xs:int> .',
    '<0x3> <age> "47"^^<xs:int> .',
    '<0x1> <friend> <0x2> (w=0.5, since=2020) .',
    '<0x1> <friend> <0x3> (w=1.5) .', '<0x2> <friend> <0x3> .'])


def _rewrite_as_dgts2(src: str, dst: str, schema_text: str) -> str:
    """Write the lists of the checkpoint in `src` (read by the JAX store)
    into `dst` in the DGTS2 layout: a header, then file-global columns over
    every list in key order, as storage/store.py's _load_v2 reads them."""
    import struct

    from dgraph_tpu.storage.store import posting_to_json

    js = JStore(src)
    try:
        rows = sorted(dict.items(js.lists))
        ts = js.max_seen_commit_ts
    finally:
        js.close()
    bps = [pl.base_packed for _, pl in rows]
    posts = [json.dumps([posting_to_json(p) for p in
                         pl.base_postings.values()]).encode()
             if pl.base_postings else b"" for _, pl in rows]
    n = len(rows)

    def cat(dt, arrs):
        arrs = [np.asarray(a, dt) for a in arrs if len(a)]
        return np.concatenate(arrs) if arrs else np.zeros(0, dt)

    cols = [np.array([len(kb) for kb, _ in rows], np.uint32),
            np.frombuffer(b"".join(kb for kb, _ in rows), np.uint8),
            np.array([pl.base_ts for _, pl in rows], np.uint64),
            np.array([bp.count for bp in bps], np.uint32),
            np.array([bp.nblocks for bp in bps], np.uint32),
            cat(np.uint64, [bp.block_first for bp in bps]),
            cat(np.uint64, [bp.block_last for bp in bps]),
            cat(np.int32, [bp.block_count for bp in bps]),
            cat(np.int32, [bp.block_width for bp in bps]),
            cat(np.int64, [bp.block_off for bp in bps]),
            np.array([len(bp.words) for bp in bps], np.uint64),
            cat(np.uint32, [bp.words for bp in bps]),
            np.array([len(b) for b in posts], np.uint32),
            np.frombuffer(b"".join(posts), np.uint8)]
    os.makedirs(dst)
    meta = json.dumps({"schema": schema_text, "max_commit_ts": ts}).encode()
    with open(os.path.join(dst, "snapshot.bin"), "wb") as f:
        f.write(b"DGTS2" + struct.pack("<Q", ts))
        f.write(struct.pack("<I", len(meta)) + meta)
        f.write(struct.pack("<I", n))
        for arr in cols:
            f.write(struct.pack("<Q", arr.nbytes) + arr.tobytes())
    return dst


@pytest.mark.parametrize("fmt", ["DGTS3", "DGTS2"])
def test_eager_open_equals_jax(nodes, tmp_path, fmt):
    """An eager open (the whole snapshot resident) of a checkpoint with
    value, lang, facet and reverse postings folds equal to the JAX store's
    over the same directory: the DGTS3 the port's checkpoint writes, and
    the older DGTS2 layout (file-global columns) that still loads."""
    d = str(tmp_path / "t")
    node = _port_node(nodes, dirpath=d)
    node.alter(schema_text=POSTINGS_SCHEMA)
    node.mutate(set_nquads=POSTINGS_QUADS, commit_now=True)
    node.store.checkpoint(node.store.max_seen_commit_ts)
    node.close()
    if fmt == "DGTS2":
        d = _rewrite_as_dgts2(d, str(tmp_path / "v2"), POSTINGS_SCHEMA)
    with open(os.path.join(d, "snapshot.bin"), "rb") as f:
        assert f.read(5) == fmt.encode()
    t_open, j_open = TStore(d), JStore(d)
    try:
        assert not t_open.paged
        ts = t_open.max_seen_commit_ts
        assert ts == j_open.max_seen_commit_ts > 0
        postings = [p for pl in dict.values(t_open.lists)
                    for p in pl.base_postings.values()]
        assert any(p.value is not None and p.lang for p in postings)
        assert any(p.facets for p in postings)
        STORAGE.assert_snap_equal(jcb.build_snapshot(j_open, ts),
                                  tcb.build_snapshot(t_open, ts,
                                                     device="cpu"))
    finally:
        t_open.close()
        j_open.close()
