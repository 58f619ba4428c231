"""The PyTorch port against tests/test_live.py's embedded-cluster case
(Cluster on device="cpu", the plain PyTorch versions): a subscription
federated across two groups, each notification byte-identical
(live.diff.canon) to re-running the query read-only at the commit
watermark it carries. The other test_live.py cases are mirrored in
tests/test_torch_live.py; tests/test_torch_cluster_jax.py holds this
subscription's events to the JAX cluster's."""

from dgraph_tpu_torch.coord.cluster import Cluster
from dgraph_tpu_torch.live.diff import canon

SCHEMA = """
name: string @index(term) .
age: int @index(int) .
follows: [uid] @reverse .
"""

Q_NAME = "{ q(func: has(name)) { uid name } }"


# -- wire mode (multi-group cluster) ----------------------------------------

def test_cluster_subscribe_federated_and_byte_identical():
    cl = Cluster(n_groups=2, device="cpu")
    try:
        cl.alter(SCHEMA)
        cl.mutate(set_nquads='<0x1> <name> "alice" .')
        sub = cl.subscribe(Q_NAME)
        ev = sub.next(5)
        assert ev["type"] == "init"
        cl.mutate(set_nquads='<0x2> <name> "bob" .\n<0x2> <age> "9" .')
        ev = sub.next(5)
        assert ev["type"] == "diff"
        assert ev["diff"]["q"]["added"] == [{"uid": "0x2", "name": "bob"}]
        rerun = cl.query(Q_NAME, read_ts=ev["at"])
        assert canon(ev["result"]) == canon(rerun)
        # unrelated predicate on the other group: no wake
        cl.mutate(set_nquads='<0x1> <age> "40" .')
        assert sub.next(0.8) is None
        sub.cancel()
    finally:
        cl.close()
