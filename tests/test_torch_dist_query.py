"""parallel/worker.py of the PyTorch port: distribute_snapshot and
group_submesh, case for case the cases of tests/test_dist_query.py.

Every uid-predicate expand of a real DQL query runs over a mesh of CPU
devices (the port's counterpart of the JAX tests' forced 8-device host
platform), routed by the Zero tablet map, and the JSON must equal the
single-device Executor's and the JAX Node's over the same mutations. The
tablet-routing cases use indexed CPU devices (cpu:0 … cpu:7) so that two
group submeshes are told apart by their devices, as the JAX test tells them
apart by device id.
"""

import json

import numpy as np
import pytest
import torch

from dgraph_tpu.api.server import Node as JNode

from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.parallel.mesh import make_mesh
from dgraph_tpu_torch.parallel.worker import distribute_snapshot, group_submesh
from dgraph_tpu_torch.query import dql
from dgraph_tpu_torch.query.engine import Executor

SCHEMA = """
    name: string @index(exact, term) .
    age: int @index(int) .
    follows: [uid] @reverse @count .
    likes: [uid] .
"""


def _quads():
    rng = np.random.default_rng(7)
    people = [f'_:p{i} <name> "person{i}" .\n'
              f'_:p{i} <age> "{20 + i % 40}"^^<xs:int> .'
              for i in range(60)]
    edges = []
    for i in range(60):
        for j in sorted(rng.choice(60, size=4, replace=False)):
            if i != j:
                edges.append(f"_:p{i} <follows> _:p{j} .")
        if i % 3 == 0:
            edges.append(f"_:p{i} <likes> _:p{(i * 7 + 1) % 60} .")
    return "\n".join(people + edges)


@pytest.fixture(scope="module")
def nodes():
    t = Node(device="cpu", planner=False, batching=False, devprof=False)
    j = JNode(planner=False, batching=False, devprof=False)
    for n in (t, j):
        n.alter(schema_text=SCHEMA)
        n.mutate(set_nquads=_quads(), commit_now=True)
    yield t, j
    t.close()
    j.close()


QUERIES = [
    '{ q(func: eq(name, "person3")) { name follows @filter(ge(age, 25)) '
    '{ name follows { name age } } } }',
    '{ q(func: ge(age, 55)) @filter(has(likes)) { name count(follows) } }',
    '{ q(func: eq(name, "person5")) { name ~follows { name } } }',
    '{ q(func: has(follows), orderasc: age, first: 7, offset: 3) { name age } }',
    '{ q(func: eq(name, "person1")) @recurse(depth: 3) { name follows } }',
    '{ a as var(func: eq(name, "person2")) { f as follows }\n'
    '  q(func: uid(f)) @filter(NOT uid(a)) { name } }',
]


def _indexed_cpus(n):
    return [torch.device("cpu", i) for i in range(n)]


@pytest.mark.parametrize("n_devices", [2, 4, 8])
@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_dist_query_matches_single_device_and_jax(nodes, n_devices, qi,
                                                  monkeypatch):
    from dgraph_tpu_torch.query import task as taskmod

    t, j = nodes
    q = QUERIES[qi]
    single, _ = t.query(q)
    jax_out, _ = j.query(q)
    mesh = make_mesh(n_devices, devices=[torch.device("cpu")] * n_devices)
    dsnap = distribute_snapshot(t.snapshot(), mesh, t.zero)
    # every expand past the host cutover: the sharded gather runs
    monkeypatch.setattr(taskmod, "HOST_EXPAND_MAX", 0)
    dist_out = Executor(dsnap, t.store.schema).execute(dql.parse(q))
    assert json.dumps(dist_out) == json.dumps(single) == json.dumps(jax_out)


def test_tablet_routing_to_group_submeshes(nodes):
    """With n_groups=2 on an 8-device mesh, predicates land on disjoint
    4-device submeshes per the Zero tablet map, and results still match."""
    t, j = nodes
    mesh = make_mesh(8, devices=_indexed_cpus(8))
    zero2 = type(t.zero)(n_groups=2)
    dsnap = distribute_snapshot(t.snapshot(), mesh, zero2)
    tablets = zero2.tablets()
    assert set(tablets.values()) == {0, 1}, tablets
    meshes = {attr: dsnap.preds[attr].csr.mesh
              for attr in tablets if dsnap.preds[attr].csr is not None}
    seen_devsets = {frozenset(d.index for d in m.devices)
                    for m in meshes.values()}
    assert len(seen_devsets) == 2
    assert all(len(s) == 4 for s in seen_devsets)
    q = QUERIES[0]
    single, _ = t.query(q)
    jax_out, _ = j.query(q)
    dist_out = Executor(dsnap, t.store.schema).execute(dql.parse(q))
    assert json.dumps(dist_out) == json.dumps(single) == json.dumps(jax_out)


def test_group_submesh_layout():
    mesh = make_mesh(8, devices=_indexed_cpus(8))
    subs = [group_submesh(mesh, 2, g) for g in range(2)]
    ids = [sorted(d.index for d in m.devices) for m in subs]
    assert ids[0] + ids[1] == sorted(d.index for d in mesh.devices)
    # degenerate: too few devices per group -> whole-mesh passthrough identity
    m2 = make_mesh(2, devices=_indexed_cpus(2))
    assert group_submesh(m2, 2, 0) is m2
