"""The reference's view of one generated data set: an Adjacency per uid
predicate and the value columns, built from the generator's own arrays."""

from __future__ import annotations

from graphbench.reference.graph import Adjacency


class Reference:
    def __init__(self, data: dict):
        self.n = data["n"]
        self.values = data["values"]
        self.adj = {attr: Adjacency(self.n, src, dst)
                    for attr, (src, dst) in data["edges"].items()}
