"""The PyTorch port against tests/test_remote.py: every case, with the port's
modules (workers and Node on device="cpu", the plain PyTorch versions).

Cross-process query execution over the internal wire protocol
(reference: worker/task.go:137 ProcessTaskOverNetwork + protos/internal.proto
ServeTask; worker/groups.go:292 BelongsTo routing)."""

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu_torch.coord.zero import Zero
from dgraph_tpu_torch.parallel.remote import (NetworkDispatcher, RemoteWorker,
                                        decode_result, decode_task,
                                        encode_result, encode_task,
                                        serve_worker)
from dgraph_tpu_torch.query import dql
from dgraph_tpu_torch.query import mutation as mut
from dgraph_tpu_torch.query import rdf
from dgraph_tpu_torch.query.engine import Executor
from dgraph_tpu_torch.query.task import TaskQuery, TaskResult
from dgraph_tpu_torch.storage.csr_build import build_snapshot
from dgraph_tpu_torch.storage.postings import Op
from dgraph_tpu_torch.storage.store import Store
from dgraph_tpu_torch.utils.schema import parse_schema
from dgraph_tpu_torch.utils.types import TypeID, Val


def _mk_store(schema_text, nquads, ts=1):
    from dgraph_tpu_torch.coord.zero import UidLease
    s = Store()
    for e in parse_schema(schema_text):
        s.set_schema(e)
    edges = mut.to_edges(rdf.parse(nquads),
                         mut.assign_uids(rdf.parse(nquads),
                                         UidLease()), Op.SET)
    touched, _, _ = mut.apply_mutations(s, edges, ts)
    s.commit(ts, ts + 1, touched)
    return s


def test_task_codec_roundtrip():
    q = TaskQuery("friend", frontier=np.array([1, 5, 9], np.int64),
                  func=("eq", ["x", 2]), lang="fr", facet_keys=["w"],
                  first=3)
    q2, ts = decode_task(encode_task(q, 42))
    assert ts == 42 and q2.attr == "friend" and q2.func == ("eq", ["x", 2])
    np.testing.assert_array_equal(q2.frontier, [1, 5, 9])
    res = TaskResult(
        uid_matrix=[np.array([2, 3], np.int64), np.zeros(0, np.int64)],
        value_matrix=[[Val(TypeID.INT, 7)], []],
        facet_matrix=[[(("w", Val(TypeID.FLOAT, 0.5)),)], [()]],
        counts=[2, 0], dest_uids=np.array([2, 3], np.int64),
        traversed_edges=2)
    r2 = decode_result(encode_result(res))
    np.testing.assert_array_equal(r2.uid_matrix[0], [2, 3])
    assert r2.value_matrix[0][0].value == 7
    assert r2.facet_matrix[0][0][0][1].value == 0.5
    assert r2.counts == [2, 0] and r2.traversed_edges == 2


@pytest.fixture(scope="module")
def network():
    """Two groups: names local, ages+follows on a remote worker."""
    # group 1 (remote): age + follows tablets
    g1 = _mk_store("age: int @index(int) .\nfollows: [uid] @reverse .",
                   "\n".join(f'<0x{i:x}> <age> "{20 + i}"^^<xs:int> .'
                             for i in range(1, 6))
                   + '\n<0x1> <follows> <0x2> .\n<0x1> <follows> <0x3> .')
    server, port = serve_worker(g1, "localhost:0", device="cpu")
    # group 0 (local): name tablet
    g0 = _mk_store("name: string @index(exact, term) .",
                   "\n".join(f'<0x{i:x}> <name> "p{i}" .'
                             for i in range(1, 6)))
    zero = Zero(2)
    zero.move_tablet("name", 0)
    zero.move_tablet("age", 1)
    zero.move_tablet("follows", 1)
    remote = RemoteWorker(f"localhost:{port}")
    snap = build_snapshot(g0, read_ts=10, device="cpu")

    # merged schema view for the coordinator
    sch = g0.schema
    for attr in g1.schema.predicates():
        sch.set(g1.schema.get(attr))
    disp = NetworkDispatcher(zero, 0, lambda ts=10: snap,
                             {1: remote}, sch)
    yield disp, sch
    remote.close()
    server.stop(0)


def _run(network, q):
    disp, sch = network
    ex = Executor(disp.local_snap_fn(), sch,
                  dispatch=lambda tq: disp.process_task(tq, 10))
    return ex.execute(dql.parse(q))


def test_remote_root_function(network):
    out = _run(network, '{ q(func: ge(age, 23), orderasc: name) { name } }')
    assert [x["name"] for x in out["q"]] == ["p3", "p4", "p5"]


def test_cross_group_two_hop(network):
    # root resolves locally (name), expansion + value fetch go over the wire
    out = _run(network, '{ q(func: eq(name, "p1")) '
                        '{ name follows { name age } } }')
    assert out["q"][0]["name"] == "p1"
    got = {(f["name"], f["age"]) for f in out["q"][0]["follows"]}
    assert got == {("p2", 22), ("p3", 23)}


def test_remote_reverse_edge(network):
    out = _run(network, '{ q(func: eq(name, "p2")) { ~follows { name } } }')
    assert [x["name"] for x in out["q"][0]["~follows"]] == ["p1"]


def test_remote_filter(network):
    out = _run(network, '{ q(func: has(name), orderasc: name) '
                        '@filter(le(age, 22)) { name age } }')
    assert [(x["name"], x["age"]) for x in out["q"]] == [("p1", 21),
                                                         ("p2", 22)]


def test_matches_single_process(network):
    """The network-routed answer must equal an all-local merged store."""
    disp, sch = network
    merged = _mk_store(
        "name: string @index(exact, term) .\nage: int @index(int) .\n"
        "follows: [uid] @reverse .",
        "\n".join(f'<0x{i:x}> <name> "p{i}" .\n'
                  f'<0x{i:x}> <age> "{20 + i}"^^<xs:int> .'
                  for i in range(1, 6))
        + '\n<0x1> <follows> <0x2> .\n<0x1> <follows> <0x3> .')
    local = Executor(build_snapshot(merged, read_ts=10, device="cpu"), merged.schema)
    q = ('{ q(func: ge(age, 22), orderasc: name) '
         '{ name age follows { name } } }')
    assert _run(network, q) == local.execute(dql.parse(q))


def test_remote_sort_key(network):
    # orderasc on a REMOTE tablet (age lives on group 1)
    out = _run(network, '{ q(func: has(name), orderdesc: age, first: 3) '
                        '{ name age } }')
    assert [(x["name"], x["age"]) for x in out["q"]] == [
        ("p5", 25), ("p4", 24), ("p3", 23)]


def test_remote_groupby_value_key(network):
    out = _run(network, '{ q(func: has(name)) @groupby(age) { count(uid) } }')
    groups = {g["age"]: g["count"] for g in out["q"][0]["@groupby"]}
    assert groups == {21: 1, 22: 1, 23: 1, 24: 1, 25: 1}


def test_unreachable_group_errors(network):
    disp, sch = network
    disp.zero.move_tablet("orphan", 1)
    saved = dict(disp.remotes)
    disp.remotes.clear()
    try:
        with pytest.raises(RuntimeError):
            disp.process_task(TaskQuery("orphan", func=("has", [])), 10)
    finally:
        disp.remotes.update(saved)


def test_unknown_predicate_answers_empty(network):
    out = _run(network, '{ q(func: has(never_seen)) { uid } }')
    assert out == {}


# -- write fan-out over the wire (MutateOverNetwork / CommitOverNetwork) ----

@pytest.fixture
def wnet():
    """Fresh 2-group topology with a writable dispatcher."""
    from dgraph_tpu_torch.coord.zero import UidLease
    g0 = _mk_store("name: string @index(exact) .",
                   '<0x1> <name> "p1" .\n<0x2> <name> "p2" .')
    g1 = _mk_store("age: int @index(int) .",
                   '<0x1> <age> "21"^^<xs:int> .')
    server, port = serve_worker(g1, "localhost:0", device="cpu")
    zero = Zero(2)
    zero.oracle.timestamps(8)   # move past seed commit ts
    zero.move_tablet("name", 0)
    zero.move_tablet("age", 1)
    remote = RemoteWorker(f"localhost:{port}")
    sch = g0.schema
    for attr in g1.schema.predicates():
        sch.set(g1.schema.get(attr))

    def snap_fn(ts=None):
        return build_snapshot(g0, read_ts=zero.oracle.read_ts(), device="cpu")

    disp = NetworkDispatcher(zero, 0, snap_fn, {1: remote}, sch)
    yield disp, g0, zero
    remote.close()
    server.stop(0)


def _dist_query(disp, zero, q):
    ts = zero.oracle.read_ts()
    ex = Executor(disp.local_snap_fn(), disp.schema,
                  dispatch=lambda tq: disp.process_task(tq, ts))
    return ex.execute(dql.parse(q))


def _dist_mutate(disp, g0, zero, nquads, commit=True):
    st = zero.oracle.new_txn()
    edges = mut.to_edges(rdf.parse(nquads), {}, Op.SET)
    keys_by_group, conflicts, preds = disp.mutate_over_network(
        edges, st.start_ts, g0)
    zero.oracle.track(st.start_ts, conflicts, sorted(preds))
    if commit:
        commit_ts = zero.oracle.commit(st.start_ts)
        disp.decide_over_network(st.start_ts, commit_ts, keys_by_group, g0)
    else:
        zero.oracle.abort(st.start_ts)
        disp.decide_over_network(st.start_ts, 0, keys_by_group, g0)
    return st.start_ts


def test_cross_group_write_commit(wnet):
    disp, g0, zero = wnet
    _dist_mutate(disp, g0, zero,
                 '<0x2> <age> "44"^^<xs:int> .\n<0x3> <name> "p3" .')
    out = _dist_query(disp, zero, '{ q(func: has(name), orderasc: name) '
                                  '{ name age } }')
    assert out["q"] == [{"name": "p1", "age": 21},
                       {"name": "p2", "age": 44}, {"name": "p3"}]


def test_cross_group_write_abort_invisible(wnet):
    disp, g0, zero = wnet
    _dist_mutate(disp, g0, zero, '<0x9> <age> "99"^^<xs:int> .',
                 commit=False)
    out = _dist_query(disp, zero, '{ q(func: ge(age, 90)) { uid } }')
    assert out == {}


def test_remote_conflict_detected(wnet):
    from dgraph_tpu_torch.coord.zero import TxnConflict
    disp, g0, zero = wnet
    st1, st2 = zero.oracle.new_txn(), zero.oracle.new_txn()
    e = mut.to_edges(rdf.parse('<0x1> <age> "30"^^<xs:int> .'), {}, Op.SET)
    k1, c1, p1 = disp.mutate_over_network(e, st1.start_ts, g0)
    k2, c2, p2 = disp.mutate_over_network(
        mut.to_edges(rdf.parse('<0x1> <age> "31"^^<xs:int> .'), {}, Op.SET),
        st2.start_ts, g0)
    zero.oracle.track(st1.start_ts, c1, sorted(p1))
    zero.oracle.track(st2.start_ts, c2, sorted(p2))
    cts = zero.oracle.commit(st1.start_ts)
    disp.decide_over_network(st1.start_ts, cts, k1, g0)
    with pytest.raises(TxnConflict):
        zero.oracle.commit(st2.start_ts)
    disp.decide_over_network(st2.start_ts, 0, k2, g0)
    out = _dist_query(disp, zero, '{ q(func: uid(0x1)) { age } }')
    assert out["q"][0]["age"] == 30


def test_partial_failure_aborts_buffered_slices(wnet):
    disp, g0, zero = wnet
    disp.zero.move_tablet("phantom", 1)
    saved = dict(disp.remotes)
    disp.remotes.clear()     # group 1 unreachable
    st = zero.oracle.new_txn()
    try:
        with pytest.raises(RuntimeError):
            # name slice (local) buffers first, then phantom's group fails
            disp.mutate_over_network(
                mut.to_edges(rdf.parse(
                    '<0x5> <name> "ghost" .\n<0x5> <phantom> "x" .'),
                    {}, Op.SET), st.start_ts, g0)
    finally:
        disp.remotes.update(saved)
    zero.oracle.abort(st.start_ts)
    # the locally-buffered name layer was aborted: nothing leaks into reads
    # and no uncommitted layer remains anywhere in the local store
    out = _dist_query(disp, zero, '{ q(func: eq(name, "ghost")) { uid } }')
    assert out == {}
    assert not any(pl.has_uncommitted() for pl in g0.lists.values())


def test_move_fence_blocks_networked_writes(wnet):
    disp, g0, zero = wnet
    zero.block_writes("age")
    st = zero.oracle.new_txn()
    try:
        with pytest.raises(RuntimeError):
            disp.mutate_over_network(
                mut.to_edges(rdf.parse('<0x1> <age> "50"^^<xs:int> .'),
                             {}, Op.SET), st.start_ts, g0)
    finally:
        zero.unblock_writes("age")
        zero.oracle.abort(st.start_ts)


# -- replication protocol (Append/Promote/Status; worker/draft.go analog) ----

def _mk_replica_trio():
    """Leader + 2 follower WorkerServices with live gRPC servers."""
    from concurrent import futures as _f

    from dgraph_tpu_torch.parallel.remote import WorkerService

    svcs, servers, addrs = [], [], []
    for _ in range(3):
        store = Store()
        for e in parse_schema("v: int ."):
            store.set_schema(e)
        svc = WorkerService(store, device="cpu")
        server = grpc.server(_f.ThreadPoolExecutor(max_workers=4))
        server.add_generic_rpc_handlers((svc.handler(),))
        port = server.add_insecure_port("localhost:0")
        server.start()
        svcs.append(svc)
        servers.append(server)
        addrs.append(f"localhost:{port}")
    return svcs, servers, addrs


def _write_edge(leader_addr, uid, val, ts):
    rw = RemoteWorker(leader_addr)
    from dgraph_tpu_torch.storage.postings import DirectedEdge

    resp = rw.mutate(ts, [DirectedEdge(uid, "v", value=Val(TypeID.INT, val))])
    rw.decide(ts, ts + 1, list(resp.keys))
    rw.close()


def test_lagging_peer_catches_up_from_buffer():
    """A transiently-failing follower is re-fed missed records from the
    leader's buffer on the next ship (per-peer nextIndex semantics)."""
    svcs, servers, addrs = _mk_replica_trio()
    leader, fa, fb = svcs
    rw = RemoteWorker(addrs[0])
    assert rw.promote(1, [addrs[1], addrs[2]]).ok

    # make peer B's transport fail for the next ship only
    pb = leader.peers[1]
    real_append = pb.append
    fails = {"n": 2}     # one txn = mutation record + commit record ships

    def flaky(*a, **kw):
        if fails["n"]:
            fails["n"] -= 1
            raise RuntimeError("transient transport fault")
        return real_append(*a, **kw)

    pb.append = flaky
    _write_edge(addrs[0], 1, 10, ts=10)   # B misses these records
    assert fa.store.max_seen_commit_ts == 11
    assert fb.store.max_seen_commit_ts == 0

    _write_edge(addrs[0], 2, 20, ts=20)   # next ship re-feeds B everything
    assert fb.store.max_seen_commit_ts == 21
    assert fb._last_seq == leader._session_seq
    rw.close()
    for s in servers:
        s.stop(0)


def test_leader_steps_down_without_quorum():
    """NoQuorum steps the leader down: it must not keep minting sequence
    numbers its group never accepted (log-fork guard)."""
    import pytest as _pytest

    from dgraph_tpu_torch.parallel.remote import NoQuorum

    svcs, servers, addrs = _mk_replica_trio()
    leader = svcs[0]
    rw = RemoteWorker(addrs[0])
    assert rw.promote(1, [addrs[1], addrs[2]]).ok
    servers[1].stop(0)
    servers[2].stop(0)

    from dgraph_tpu_torch.storage.postings import DirectedEdge
    from dgraph_tpu_torch.query import mutation as mut

    with _pytest.raises(NoQuorum):
        mut.apply_mutations(leader.store,
                            [DirectedEdge(1, "v", value=Val(TypeID.INT, 1))],
                            5)
    assert not leader.is_leader
    assert leader.store.wal_sink is None
    rw.close()
    servers[0].stop(0)


def test_stale_leader_fenced_by_term():
    """A deposed leader's ship is rejected once a peer saw a higher term."""
    from dgraph_tpu_torch.parallel.remote import StaleLeader

    svcs, servers, addrs = _mk_replica_trio()
    l1, l2, f = svcs
    rw1, rw2 = RemoteWorker(addrs[0]), RemoteWorker(addrs[1])
    assert rw1.promote(1, [addrs[1], addrs[2]]).ok
    _write_edge(addrs[0], 1, 1, ts=2)
    # replica 1 takes over at term 2 (shares follower addrs[2])
    assert rw2.promote(2, [addrs[2]]).ok
    _write_edge(addrs[1], 2, 2, ts=6)

    from dgraph_tpu_torch.storage.postings import DirectedEdge
    from dgraph_tpu_torch.query import mutation as mut
    import pytest as _pytest

    with _pytest.raises(StaleLeader):
        mut.apply_mutations(l1.store,
                            [DirectedEdge(3, "v", value=Val(TypeID.INT, 3))],
                            9)
    assert not l1.is_leader
    rw1.close()
    rw2.close()
    for s in servers:
        s.stop(0)


def test_follower_state_sync_beyond_buffer():
    """A follower that missed more records than the leader's ship buffer
    holds pulls the leader's full state via FetchState and resumes appends
    (retrieveSnapshot analog, worker/draft.go:452)."""
    import tempfile
    import time as _t
    from concurrent import futures as _f

    from dgraph_tpu_torch.parallel.remote import (GRPC_OPTIONS, RemoteWorker,
                                            WorkerService)

    tmp = tempfile.mkdtemp()
    svcs, servers, addrs = [], [], []
    for i in range(3):
        store = Store(f"{tmp}/r{i}")
        for e in parse_schema("v: int ."):
            store.set_schema(e)
        svc = WorkerService(store, device="cpu")
        svc.SHIP_BUFFER = 8            # tiny window to force the sync
        svc._buffer = __import__("collections").deque(maxlen=8)
        server = grpc.server(_f.ThreadPoolExecutor(max_workers=4),
                             options=GRPC_OPTIONS)
        server.add_generic_rpc_handlers((svc.handler(),))
        port = server.add_insecure_port("localhost:0")
        svc.advertise_addr = f"localhost:{port}"
        server.start()
        svcs.append(svc)
        servers.append(server)
        addrs.append(f"localhost:{port}")
    leader, fa, fb = svcs
    rw = RemoteWorker(addrs[0])
    assert rw.promote(1, [addrs[1], addrs[2]]).ok

    # B's transport goes dark for a while
    pb = leader.peers[1]
    real_append = pb.append
    pb.append = lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("down"))
    for i in range(30):                # >> buffer of 8 (2 records per txn)
        _write_edge(addrs[0], i + 1, i, ts=10 + 2 * i)
    assert fa.store.max_seen_commit_ts == 10 + 2 * 29 + 1
    assert fb.store.max_seen_commit_ts == 0

    # B comes back: next ship finds the gap beyond the buffer; B pulls the
    # leader's full state and subsequent appends land normally
    pb.append = real_append
    _write_edge(addrs[0], 99, 99, ts=200)   # gap detected: sync kicks off
    # drive more writes until the post-sync resume lands on B
    deadline = _t.time() + 20
    ts = 400
    while _t.time() < deadline and fb.store.max_seen_commit_ts < 401:
        _write_edge(addrs[0], 101, 101, ts=ts)
        ts += 2
        _t.sleep(0.2)
    assert fb.store.max_seen_commit_ts >= 401, fb.store.max_seen_commit_ts
    assert fb._last_seq == leader._session_seq
    rw.close()
    for s in servers:
        s.stop(0)


def test_in_memory_leader_buffer_never_evicts():
    """An in-memory leader has no files for FetchState, so its promote()
    must install an unbounded ship buffer — the buffer IS the history a
    lagging follower catches up from (review r4)."""
    svcs, servers, addrs = _mk_replica_trio()   # in-memory stores
    leader = svcs[0]
    rw = RemoteWorker(addrs[0])
    assert rw.promote(1, [addrs[1], addrs[2]]).ok
    assert leader._buffer.maxlen is None

    # follower B misses far more than SHIP_BUFFER would hold, then recovers
    leader.SHIP_BUFFER = 8   # would have evicted if maxlen were set
    pb = leader.peers[1]
    real_append = pb.append
    pb.append = lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("down"))
    for i in range(30):
        _write_edge(addrs[0], i + 1, i, ts=10 + 2 * i)
    pb.append = real_append
    # the failed peer backed off; keep writing until its due tick re-feeds
    # the ENTIRE history from the unbounded buffer
    fb = svcs[2]
    ts = 200
    for _ in range(80):
        _write_edge(addrs[0], 99, 99, ts=ts)
        ts += 2
        if fb._last_seq == leader._session_seq:
            break
    assert fb._last_seq == leader._session_seq
    assert fb.store.max_seen_commit_ts == ts - 1
    rw.close()
    for s in servers:
        s.stop(0)


def test_chunked_predicate_data_stream():
    """Predicate moves stream in <=max_bytes chunks with a resumable cursor
    (reference predicate_move.go:187 <=32MB batches) and the destination
    returns applied counts (the :171-176 count handshake)."""
    src = _mk_store("name: string @index(exact, term) .",
                    "\n".join(f'<0x{i:x}> <name> "person{i}" .'
                              for i in range(1, 60)))
    server, port = serve_worker(src, "localhost:0", device="cpu")
    rw = RemoteWorker(f"localhost:{port}")
    try:
        full = rw.predicate_data("name", read_ts=10, start_ts=100)
        assert full.done and not full.next
        assert len(full.records) > 60        # data + index rows + schema

        records, keys, chunks = [], [], 0
        cursor = b""
        while True:
            resp = rw.predicate_data("name", 10, 100, after=cursor,
                                     max_bytes=256)
            records.extend(bytes(r) for r in resp.records)
            keys.extend(bytes(k) for k in resp.keys)
            chunks += 1
            if resp.done:
                assert not resp.next
                break
            assert resp.next
            cursor = bytes(resp.next)
        assert chunks > 3, "chunking did not engage"
        assert records == [bytes(r) for r in full.records]
        assert keys == [bytes(k) for k in full.keys]

        # count handshake: destination reports exactly what it applied
        dst = _mk_store("name: string @index(exact, term) .",
                        '<0x1> <name> "seed" .')
        server2, port2 = serve_worker(dst, "localhost:0", device="cpu")
        rw2 = RemoteWorker(f"localhost:{port2}")
        try:
            ingested = 0
            for lo in range(0, len(records), 7):
                ingested += rw2.ingest_records(records[lo: lo + 7])
            assert ingested == len(records)
        finally:
            rw2.close()
            server2.stop(0)
    finally:
        rw.close()
        server.stop(0)


# -- the remote sort key against the JAX cluster -------------------------

SORT_SCHEMA = ("name: string @index(exact) .\nage: int @index(int) .\n"
               "balance: int .")


def _sort_cluster(pkg):
    """A Zero, two workers and a ClusterClient of one package: name on
    group 0, age and balance on group 1, so every sort key below is a
    remote tablet of the root's group. Seeded values with ties, and some
    uids without a balance (missing keys sink to the end)."""
    import importlib

    mods = {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "coord.zero", "coord.zero_service", "parallel.remote",
        "parallel.client", "storage.store", "utils.schema")}
    kw = {"device": "cpu"} if pkg == "dgraph_tpu_torch" else {}
    zero = mods["coord.zero"].Zero(2)
    for attr, g in (("name", 0), ("age", 1), ("balance", 1)):
        zero.move_tablet(attr, g)
    zsrv, zport, _ = mods["coord.zero_service"].serve_zero(zero,
                                                           "localhost:0")
    workers = []
    for _g in range(2):
        s = mods["storage.store"].Store()
        for e in mods["utils.schema"].parse_schema(SORT_SCHEMA):
            s.set_schema(e)
        workers.append(mods["parallel.remote"].serve_worker(
            s, "localhost:0", **kw))
    client = mods["parallel.client"].ClusterClient(
        f"localhost:{zport}",
        {g: [f"localhost:{w[1]}"] for g, w in enumerate(workers)},
        default_timeout_ms=20000)
    rng = np.random.default_rng(5)
    nq = []
    for i in range(30):
        nq.append(f'_:p{i} <name> "p{i}" .')
        nq.append(f'_:p{i} <age> "{int(rng.integers(20, 30))}"^^<xs:int> .')
        if i % 3:
            nq.append(f'_:p{i} <balance> "{int(rng.integers(0, 50))}"'
                      f'^^<xs:int> .')
    client.mutate(set_nquads="\n".join(nq))

    def close():
        client.close()
        for w, _p in workers:
            w.stop(0)
        zsrv.stop(0)
    return client, close


SORT_QUERIES = [
    f"{{ q(func: has(name), {o}: {k}{pg}) {{ name age balance }} }}"
    for o in ("orderasc", "orderdesc") for k in ("balance", "age")
    for pg in ("", ", first: 5", ", first: 4, offset: 7")
]


@pytest.fixture(scope="module")
def sort_pair():
    tc, tclose = _sort_cluster("dgraph_tpu_torch")
    jc, jclose = _sort_cluster("dgraph_tpu")
    yield tc, jc
    tclose()
    jclose()


@pytest.mark.parametrize("q", SORT_QUERIES)
def test_remote_sort_key_equals_jax(sort_pair, q):
    """orderasc/orderdesc on another group's tablet, with and without
    first/offset: one dispatch of the candidate set fetches the keys, and
    the port's JSON is the JAX cluster's, bytes."""
    import json

    tc, jc = sort_pair
    tc.task_cache.clear()
    jc.task_cache.clear()
    got, want = json.dumps(tc.query(q)), json.dumps(jc.query(q))
    assert got == want
    rows = json.loads(got)["q"]
    key = "balance" if ": balance" in q else "age"
    vals = [r[key] for r in rows if key in r]
    assert vals == sorted(vals, reverse="orderdesc" in q)
    assert len(vals) > 1


def test_noquorum_is_a_transport_error_and_retried():
    """NoQuorum joins transport_errors() (as in the JAX package), so the
    unified RetryPolicy retries a quorum loss instead of surfacing it."""
    from dgraph_tpu.parallel.remote import NoQuorum as JNoQuorum
    from dgraph_tpu.utils.retry import transport_errors as jtransport

    from dgraph_tpu_torch.parallel.remote import NoQuorum
    from dgraph_tpu_torch.utils.retry import RetryPolicy, transport_errors

    assert NoQuorum in transport_errors()
    assert JNoQuorum in jtransport()
    assert [c.__name__ for c in transport_errors()] == \
        [c.__name__ for c in jtransport()]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise NoQuorum("1/3 acks < quorum 2")
        return "ok"

    policy = RetryPolicy(max_attempts=4, base_s=0.001, cap_s=0.002)
    assert policy.run(flaky, retryable=transport_errors()) == "ok"
    assert len(calls) == 3
