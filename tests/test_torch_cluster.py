"""The PyTorch port against tests/test_cluster.py: every case, with the port's
modules (workers and Node on device="cpu", the plain PyTorch versions).

Multi-group cluster: tablet routing, cross-group txns, federated queries,
and the predicate-move protocol (reference worker/groups.go BelongsTo,
worker/mutation.go populateMutationMap, worker/predicate_move.go:86-177)."""

import pytest

from dgraph_tpu_torch.coord.cluster import Cluster, MoveInProgress
from dgraph_tpu_torch.storage import keys as K


@pytest.fixture
def cluster():
    c = Cluster(n_groups=2, device="cpu")
    c.alter("""
        name: string @index(exact) .
        follows: [uid] @reverse @count .
        age: int @index(int) .
    """)
    return c


def _seed(c):
    c.mutate(set_nquads="""
        _:a <name> "ann" .
        _:a <age> "30" .
        _:b <name> "bob" .
        _:b <age> "41" .
        _:a <follows> _:b .
    """)


def test_tablets_split_across_groups(cluster):
    _seed(cluster)
    groups = {cluster.group_of(a) for a in ("name", "age", "follows")}
    assert len(groups) == 2          # load-balanced claim spread the tablets


def test_cross_group_txn_and_federated_query(cluster):
    _seed(cluster)
    out = cluster.query('{ q(func: eq(name, "ann")) { name age follows { name } } }')
    assert out == {"q": [{"name": "ann", "age": 30,
                          "follows": [{"name": "bob"}]}]}


def test_move_predicate_full_protocol(cluster):
    _seed(cluster)
    attr = "name"
    src = cluster.group_of(attr)
    dst = 1 - src
    before = cluster.query('{ q(func: eq(name, "bob"), orderasc: name) { name age } }')
    report = cluster.move_predicate(attr, dst)
    assert report["moved_keys"] > 0
    # ownership flipped; data gone at the source, fully served at the target
    assert cluster.group_of(attr) == dst
    assert not cluster.stores[src].keys_of(K.KeyKind.DATA, attr)
    assert cluster.stores[dst].keys_of(K.KeyKind.DATA, attr)
    after = cluster.query('{ q(func: eq(name, "bob"), orderasc: name) { name age } }')
    assert after == before
    # index keys moved too: eq() above used the exact index on the new group
    assert cluster.stores[dst].keys_of(K.KeyKind.INDEX, attr)


def test_move_blocks_writes_and_aborts_open_txns(cluster):
    _seed(cluster)
    attr = "age"
    dst = 1 - cluster.group_of(attr)
    # an open txn touching the predicate gets aborted by the move
    from dgraph_tpu_torch.query import rdf
    from dgraph_tpu_torch.query import mutation as mut
    from dgraph_tpu_torch.storage.postings import Op
    st = cluster.zero.oracle.new_txn()
    edges = mut.to_edges(rdf.parse('<0x1> <age> "99" .'), {}, Op.SET)
    touched, conflict, preds = mut.apply_mutations(
        cluster.store_of(attr), edges, st.start_ts)
    cluster.zero.oracle.track(st.start_ts, conflict, sorted(preds))
    cluster._txn_keys[st.start_ts] = {cluster.group_of(attr): touched}
    report = cluster.move_predicate(attr, dst)
    assert report["aborted_txns"] == 1
    with pytest.raises(Exception):
        cluster.commit(st.start_ts)
    # the aborted write is invisible
    out = cluster.query('{ q(func: eq(name, "ann")) { age } }')
    assert out["q"][0]["age"] == 30


def test_writes_rejected_mid_move(cluster):
    _seed(cluster)
    cluster.zero.block_writes("age")
    with pytest.raises(MoveInProgress):
        cluster.mutate(set_nquads='<0x1> <age> "50" .')
    cluster.zero.unblock_writes("age")
    cluster.mutate(set_nquads='<0x1> <age> "50" .')
    out = cluster.query('{ q(func: eq(name, "ann")) { age } }')
    assert out["q"][0]["age"] == 50


def test_reverse_and_count_follow_the_move(cluster):
    _seed(cluster)
    attr = "follows"
    dst = 1 - cluster.group_of(attr)
    cluster.move_predicate(attr, dst)
    out = cluster.query('{ q(func: eq(name, "bob")) { ~follows { name } } }')
    assert out == {"q": [{"~follows": [{"name": "ann"}]}]}
    out = cluster.query('{ q(func: eq(count(follows), 1)) { name } }')
    assert out == {"q": [{"name": "ann"}]}


def test_move_to_same_group_noop(cluster):
    _seed(cluster)
    g = cluster.group_of("name")
    assert cluster.move_predicate("name", g) == {"moved_keys": 0,
                                                 "aborted_txns": 0}


def test_conflict_detection_spans_groups(cluster):
    _seed(cluster)
    from dgraph_tpu_torch.coord.zero import TxnConflict
    from dgraph_tpu_torch.query import rdf
    from dgraph_tpu_torch.query import mutation as mut
    from dgraph_tpu_torch.storage.postings import Op

    def open_write(val):
        st = cluster.zero.oracle.new_txn()
        edges = mut.to_edges(rdf.parse(f'<0x1> <age> "{val}" .'), {}, Op.SET)
        touched, conflict, preds = mut.apply_mutations(
            cluster.store_of("age"), edges, st.start_ts)
        cluster.zero.oracle.track(st.start_ts, conflict, sorted(preds))
        cluster._txn_keys[st.start_ts] = {cluster.group_of("age"): touched}
        return st.start_ts

    t1, t2 = open_write(71), open_write(72)
    cluster.commit(t1)
    with pytest.raises(TxnConflict):
        cluster.commit(t2)


def test_star_delete_spans_groups(cluster):
    _seed(cluster)
    # <0x1>=ann has name (one group) and age (the other); S * * must clear both
    out = cluster.query('{ q(func: eq(name, "ann")) { uid } }')
    uid = out["q"][0]["uid"]
    cluster.mutate(del_nquads=f"<{uid}> * * .")
    out = cluster.query(f'{{ q(func: uid({uid})) {{ name age }} }}')
    assert out == {}


def test_failed_mutation_aborts_oracle_txn(cluster):
    _seed(cluster)
    before = cluster.zero.oracle.pending_count()
    with pytest.raises(Exception):
        cluster.mutate(set_nquads='<0x1> <age> "not-an-int" .')
    assert cluster.zero.oracle.pending_count() == before
    # and a MoveInProgress rejection leaks nothing either (raises pre-txn)
    cluster.zero.block_writes("age")
    with pytest.raises(MoveInProgress):
        cluster.mutate(set_nquads='<0x1> <age> "77" .')
    cluster.zero.unblock_writes("age")
    assert cluster.zero.oracle.pending_count() == before


# -- auto-rebalance (dgraph/cmd/zero/tablet.go:60-74) ------------------------

def test_rebalance_moves_tablet_from_skewed_group(tmp_path):
    from dgraph_tpu_torch.coord.cluster import Cluster

    c = Cluster(n_groups=2, device="cpu")
    c.alter("name: string @index(exact) .\nbig: string .\nsmall: int .")
    # force a skew: both heavy tablets on group 0
    c.zero.move_tablet("name", 0)
    c.zero.move_tablet("big", 0)
    c.zero.move_tablet("small", 1)
    c.mutate(set_nquads="\n".join(
        f'_:n{i} <name> "person{i}" .\n_:n{i} <big> "{"x" * 200}" .'
        for i in range(40)) + '\n_:n0 <small> "1"^^<xs:int> .')

    sizes = {g: sum(c.stores[g].tablet_sizes().values()) for g in (0, 1)}
    assert sizes[0] > sizes[1] / 0.85

    moved = c.rebalance_once()
    assert moved is not None and moved["src"] == 0 and moved["dst"] == 1
    # the map flipped and queries stay correct THROUGH the move
    assert c.zero.tablets()[moved["tablet"]] == 1
    out = c.query('{ q(func: eq(name, "person3")) { name big } }')
    assert out["q"][0]["name"] == "person3"
    assert len(out["q"][0]["big"]) == 200

    # balanced enough now: a second tick is a no-op or improves further
    again = c.rebalance_once()
    if again is not None:
        assert again["tablet"] != moved["tablet"]
    c.close()


def test_rebalancer_background_loop(tmp_path):
    import time as _t

    from dgraph_tpu_torch.coord.cluster import Cluster

    c = Cluster(n_groups=2, device="cpu")
    c.alter("name: string @index(exact) .\nbig: string .")
    c.zero.move_tablet("name", 0)
    c.zero.move_tablet("big", 0)
    c.mutate(set_nquads="\n".join(
        f'_:n{i} <name> "p{i}" .\n_:n{i} <big> "{"y" * 150}" .'
        for i in range(30)))
    c.start_rebalancer(interval_s=0.1)
    deadline = _t.time() + 10
    while _t.time() < deadline:
        if len(set(c.zero.tablets().values())) == 2:
            break
        _t.sleep(0.05)
    assert len(set(c.zero.tablets().values())) == 2, c.zero.tablets()
    out = c.query('{ q(func: eq(name, "p7")) { name big } }')
    assert out["q"][0]["name"] == "p7"
    c.close()


def test_cluster_query_reuses_device_arrays():
    """Federated queries reuse per-predicate device arrays across calls;
    a commit touching one predicate re-folds only that predicate."""
    from dgraph_tpu_torch.coord.cluster import Cluster

    c = Cluster(n_groups=2, device="cpu")
    c.alter("name: string @index(exact) .\nage: int .")
    c.zero.move_tablet("name", 0)
    c.zero.move_tablet("age", 1)
    c.mutate(set_nquads='_:a <name> "x" .\n_:a <age> "3"^^<xs:int> .')
    c.query('{ q(func: eq(name, "x")) { name age } }')
    snap1 = {attr: a._pred_cache.get(attr)
             for a, attr in ((c._assemblers[0], "name"),
                             (c._assemblers[1], "age"))}
    c.mutate(set_nquads='_:b <age> "9"^^<xs:int> .')   # touches age only
    out = c.query('{ q(func: eq(name, "x")) { name age } }')
    assert out["q"][0]["age"] == 3
    assert c._assemblers[0]._pred_cache["name"][1] is snap1["name"][1]
    assert c._assemblers[1]._pred_cache["age"][1] is not snap1["age"][1]
    # schema change invalidates; move keeps queries correct
    c.alter("nick: string @index(term) .")
    c.move_predicate("name", 1)
    out = c.query('{ q(func: eq(name, "x")) { name age } }')
    assert out["q"][0]["name"] == "x"
    c.close()


def test_choose_rebalance_move_decision_table():
    """The shared decision function (tablet.go:60-74 + chooseTablet :156)
    drives BOTH the in-process and zero-process rebalancers."""
    from dgraph_tpu_torch.coord.zero import choose_rebalance_move as pick

    # balanced within the 85% ratio: no move
    assert pick({0: {"a": 100}, 1: {"b": 90}}) is None
    # single group: no move
    assert pick({0: {"a": 100}}) is None
    # imbalanced: the largest tablet fitting half the gap moves
    got = pick({0: {"a": 60, "b": 50}, 1: {"c": 10}})
    assert got == ("b", 0, 1, 50)     # gap=(110-10)/2=50; b fits, a doesn't
    # nothing fits half the gap (one huge tablet): no move (anti-thrash)
    assert pick({0: {"a": 200}, 1: {"b": 10}}) is None
    # blocked tablets are skipped (gap=38: a fits and sorts first, so only
    # the blocked check can force b)
    assert pick({0: {"a": 38, "b": 38}, 1: {}})[0] == "a"
    got = pick({0: {"a": 38, "b": 38}, 1: {}}, blocked={"a"})
    assert got[0] == "b"
    # empty smallest group with several comparable tablets
    got = pick({0: {"x": 30, "y": 29, "z": 28}, 1: {}})
    assert got[0] == "x" and got[2] == 1


def test_cluster_conflict_aborts_across_groups():
    """SSI conflict on a cross-group txn aborts every group's slice."""
    from dgraph_tpu_torch.coord.cluster import Cluster
    from dgraph_tpu_torch.coord.zero import TxnConflict

    c = Cluster(n_groups=2, device="cpu")
    c.alter("name: string @index(exact) @upsert .\nage: int .")
    c.zero.move_tablet("name", 0)
    c.zero.move_tablet("age", 1)
    c.mutate(set_nquads='<0x1> <name> "a" .\n<0x1> <age> "1"^^<xs:int> .')

    # two txns race on the same subject+predicate
    st1 = c.zero.oracle.new_txn()
    st2 = c.zero.oracle.new_txn()
    from dgraph_tpu_torch.query import mutation as mut
    from dgraph_tpu_torch.query import rdf
    from dgraph_tpu_torch.storage.postings import Op

    def buffer(st, val):
        nq = rdf.parse(f'<0x1> <name> "{val}" .\n'
                       f'<0x1> <age> "9"^^<xs:int> .')
        edges = mut.to_edges(nq, {}, Op.SET)
        by_group = mut.split_edges_by_group(edges, 2, c.group_of)
        keys = {}
        conflicts = []
        for g, ge in by_group.items():
            touched, confl, preds = mut.apply_mutations(
                c.stores[g], ge, st.start_ts)
            keys[g] = touched
            conflicts += confl
        c.zero.oracle.track(st.start_ts, conflicts)
        return keys

    k1 = buffer(st1, "x")
    k2 = buffer(st2, "y")
    ts1 = c.zero.oracle.commit(st1.start_ts)
    for g, kb in k1.items():
        c.stores[g].commit(st1.start_ts, ts1, kb)
    with pytest.raises(TxnConflict):
        c.zero.oracle.commit(st2.start_ts)
    for g, kb in k2.items():
        c.stores[g].abort(st2.start_ts, kb)
    out = c.query('{ q(func: eq(name, "x")) { name age } }')
    assert out["q"] == [{"name": "x", "age": 9}]
    c.close()
