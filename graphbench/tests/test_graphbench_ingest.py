"""The loader puts a generated data set into a Node: uid predicates (with
their reverse edges) and value columns (with their index keys) read back
through queries, at the install's timestamp."""

import torch

from dgraph_tpu_torch.api.server import Node
from graphbench.ingest import packed


def test_uid_and_value_rows_read_back():
    data = {"n": 4,
            "schema": "friend: [uid] @reverse .\nname: string @index(exact) .",
            "edges": {"friend": (torch.tensor([1, 1, 2, 3]),
                                 torch.tensor([2, 3, 3, 4]))},
            "values": {"name": ["ann", "bob", "ann", "cy"]}}
    node = Node(device="cpu")
    try:
        secs = packed.install(node, data)
        assert set(secs) == {"uid_rows", "value_rows", "pack", "install"}
        out = node.query('{ q(func: eq(name, "ann")) { uid name '
                         'friend { name } ~friend { uid } } }')[0]
    finally:
        node.close()
    rows = sorted(out["q"], key=lambda r: r["uid"])
    assert [r["uid"] for r in rows] == ["0x1", "0x3"]
    assert sorted(f["name"] for f in rows[0]["friend"]) == ["ann", "bob"]
    assert rows[1]["friend"] == [{"name": "cy"}]
    assert rows[1]["~friend"] == [{"uid": "0x1"}, {"uid": "0x2"}]
