"""Graph500's undirected graph under Dgraph's shortest-path block, on the
CPU: the port's serving Node against the benchmark's plain reference.

graphbench's generator (datagen/graph500_undirected.py) makes a seeded
undirected Kronecker graph at scales 8 and 10, graphbench's loader puts it
into a `Node(device="cpu")`, and each `{ path as shortest(from: S, to: T)
{ friend } }` answer is compared with the `_path_` JSON of the plain
reference (graphbench/reference/paths.py: a level-synchronous BFS and the
minimum-uid walk back, rendered by requests/shortest_pair.py). The tier is
forced through the port's query/shortest.py globals: the kernel tier's
plain K2 and K1 versions, the Bellman-Ford tier and the host tier (level
adjacency, then Dijkstra). The kernel tier and Dijkstra take the
minimum-uid predecessor on ties, as the reference does, so their JSON is
equal whole. Bellman-Ford takes the maximum (query/shortest.py's module
notes), so its answers are held to the reference's distances: the same
`_weight_`, and a path whose i-th uid lies at distance i, each step an
edge.
"""

import numpy as np
import pytest
import torch

from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.ops import pull_bfs
from dgraph_tpu_torch.query import shortest

from graphbench import run, spec
from graphbench.ingest import packed
from graphbench.reference import paths
from graphbench.reference.dataset import Reference

CELL = "g500u20.shortest-pair"
SEED = 2**31 + 18
DEPTH = 64
TIERS = {
    # tier: (DEVICE_SSSP_MIN_EDGES, SSSP_KERNEL_MIN, pull_bfs.SPARSE_MAX)
    "kernel_k2": (0, 0, pull_bfs.SPARSE_MAX),
    "kernel_k1": (0, 0, -1),
    "bellman_ford": (0, None, pull_bfs.SPARSE_MAX),
    "host": (1 << 62, None, pull_bfs.SPARSE_MAX),
}
PAIRS = ("one_hop", "far", "tie", "unreachable")


def render(path):
    return spec.plugin("requests", "shortest_pair").render(path, "friend")


def _data(scale: int, seed: int = SEED) -> dict:
    cfg = spec.cell(CELL).config
    cfg["scale"] = scale
    return run.host_data(spec.plugin("datagen", cfg["generator"]).generate(
        cfg, seed, "cpu"))


_LOADED: dict = {}


def _loaded(scale: int):
    """(data, reference, pairs) for one scale, made once per process."""
    if scale not in _LOADED:
        data = _data(scale)
        ref = Reference(data)
        _LOADED[scale] = (data, ref, _pairs(ref, data))
    return _LOADED[scale]


def _pairs(ref, data) -> dict:
    """A pair of each kind, found with the reference's distances (a BFS to
    uid 0, which is no vertex, runs through the source's whole component):
    one hop from the uid with the most edges; the farthest pair of a double
    sweep (the uid farthest from that one, and the uid farthest from it);
    from the same source the farthest tie (a target with two or more
    neighbours one level nearer); and a uid the source cannot reach, of
    another component where the graph has one, else a uid with no edge."""
    adj = ref.adj["friend"]
    pool = data["pools"]["friend"]
    hub = int(torch.argmax(adj.degree))
    dist = paths.bfs(adj, hub, 0, DEPTH)[0].numpy()
    one = int(pool[dist[pool] == 1][0])
    src = int(pool[np.argmax(dist[pool])])
    dist = paths.bfs(adj, src, 0, DEPTH)[0].numpy()
    far = int(pool[np.argmax(dist[pool])])
    rin = paths.in_adjacency(adj)
    ties = [int(t) for t in pool[dist[pool] >= 2]
            if int((dist[rin.indices[int(rin.indptr[t]):
                                     int(rin.indptr[t + 1])].numpy()]
                    == dist[t] - 1).sum()) >= 2]
    tie = max(ties, key=lambda t: (dist[t], -t))
    other = pool[dist[pool] == paths.UNSEEN]
    if not len(other):
        other = np.flatnonzero(adj.degree.numpy() == 0)[1:]    # not uid 0
    return {"one_hop": (hub, one), "far": (src, far), "tie": (src, tie),
            "unreachable": (src, int(other[0]))}


def _node(data) -> Node:
    node = Node(device="cpu")
    packed.install(node, data)
    node.task_cache = node.result_cache = None
    return node


def _ask(node, s: int, t: int) -> dict:
    return node.query("{ path as shortest(from: %s, to: %s) { friend } }"
                      % (hex(s), hex(t)), edge_limit=1 << 31)[0]


def _uids(answer: dict) -> list[int]:
    out, node = [], answer["_path_"][0]
    while node is not None:
        out.append(int(node["uid"], 16))
        node = node.get("friend", [None])[0]
    return out


@pytest.mark.parametrize("scale", [8, 10])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_node_answers_as_the_reference(monkeypatch, tier, scale):
    dev_min, kernel_min, sparse_max = TIERS[tier]
    monkeypatch.setattr(shortest, "DEVICE_SSSP_MIN_EDGES", dev_min)
    monkeypatch.setattr(shortest, "SSSP_KERNEL_MIN", kernel_min)
    monkeypatch.setattr(pull_bfs, "SPARSE_MAX", sparse_max)
    bfs_calls = []
    real_bfs = pull_bfs.shortest_bfs
    monkeypatch.setattr(pull_bfs, "shortest_bfs",
                        lambda *a: bfs_calls.append(a) or real_bfs(*a))
    data, ref, pairs = _loaded(scale)
    adj = ref.adj["friend"]
    node = _node(data)
    try:
        for kind in PAIRS:
            s, t = pairs[kind]
            want = render(paths.shortest_path(adj, s, t, DEPTH))
            got = _ask(node, s, t)
            if tier != "bellman_ford" or kind == "unreachable":
                assert got == want, (kind, got, want)
                continue
            assert got["_path_"][0]["_weight_"] == \
                want["_path_"][0]["_weight_"]
            uids = _uids(got)
            dist = paths.bfs(adj, s, 0, DEPTH)[0]
            assert [int(dist[u]) for u in uids] == list(range(len(uids)))
            for u, v in zip(uids, uids[1:]):
                row = adj.indices[int(adj.indptr[u]): int(adj.indptr[u + 1])]
                assert bool((row == v).any())
    finally:
        node.close()
    assert bool(bfs_calls) == tier.startswith("kernel")


@pytest.mark.parametrize("chunk", [1, 3])
def test_the_walk_keeps_the_minimum_uid_chunk_by_chunk(monkeypatch, chunk):
    """The kernel tier's host walk tests a step's in-edges a chunk at a
    time (pull_bfs.WALK_CHUNK, then 8x wider): at chunks of 1 and 3 hub
    steps span several, and every answer still equals the reference's."""
    monkeypatch.setattr(shortest, "DEVICE_SSSP_MIN_EDGES", 0)
    monkeypatch.setattr(shortest, "SSSP_KERNEL_MIN", 0)
    monkeypatch.setattr(pull_bfs, "WALK_CHUNK", chunk)
    data, ref, pairs = _loaded(10)
    adj = ref.adj["friend"]
    rng = np.random.default_rng(chunk)
    pool = data["pools"]["friend"]
    asked = list(pairs.values()) + [
        tuple(int(x) for x in rng.choice(pool, 2, replace=False))
        for _ in range(40)]
    node = _node(data)
    try:
        for s, t in asked:
            assert _ask(node, s, t) == \
                render(paths.shortest_path(adj, s, t, DEPTH)), (s, t)
    finally:
        node.close()


@pytest.mark.parametrize("kind", PAIRS)
def test_pair_kinds(kind):
    """Each kind of pair is what its name says, on the reference alone."""
    data, ref, pairs = _loaded(10)
    s, t = pairs[kind]
    path = paths.shortest_path(ref.adj["friend"], s, t, DEPTH)
    if kind == "unreachable":
        assert path is None and render(path) == {}
        return
    assert path[0] == s and path[-1] == t
    if kind == "one_hop":
        assert len(path) == 2
    elif kind == "far":
        dist = paths.bfs(ref.adj["friend"], s, 0, DEPTH)[0]
        assert len(path) - 1 == int(dist.max()) >= 4
    else:
        assert len(path) >= 3


@pytest.mark.parametrize("scale", [8, 10])
def test_the_generated_graph_is_undirected(scale):
    """Symmetric, no self-loops, no repeats, labels from uid 1, and the
    same seed gives the same graph."""
    data = _data(scale)
    src, dst = data["edges"]["friend"]
    n = 1 << scale
    assert data["n"] == n
    assert int(src.min()) >= 1 and int(dst.max()) <= n
    assert not bool((src == dst).any())
    key = src * (n + 1) + dst
    assert bool((key[1:] > key[:-1]).all())              # sorted, a set
    back = torch.sort(dst * (n + 1) + src).values
    assert torch.equal(back, key)                        # v -> u for u -> v
    again = _data(scale)["edges"]["friend"]
    assert torch.equal(again[0], src) and torch.equal(again[1], dst)
    other = _data(scale, SEED + 1)["edges"]["friend"]
    assert other[0].numel() != src.numel() or not torch.equal(other[1], dst)


def test_every_directed_edge_is_kept_both_ways():
    """The undirected graph is the directed generator's set with each edge
    added the other way: nothing more, nothing dropped."""
    cfg = spec.cell(CELL).config
    cfg["scale"] = 9
    directed = spec.plugin("datagen", "graph500").generate(cfg, SEED, "cpu")
    s, d = directed["edges"]["friend"]
    u = spec.plugin("datagen", cfg["generator"]).generate(cfg, SEED, "cpu")
    us, ud = u["edges"]["friend"]
    n = 1 << 9
    both = torch.unique(torch.cat([s * (n + 1) + d, d * (n + 1) + s]))
    assert torch.equal(both, us * (n + 1) + ud)
