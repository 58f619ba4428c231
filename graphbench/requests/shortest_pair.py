"""A point-to-point shortest path, Dgraph's documented block:

    { path as shortest(from: S, to: T) { p } }

answered as `_path_`: the path's uids nested along `p`, with `_weight_`
the number of edges, or no `_path_` at all when T is not within the
default depth of S. S and T are drawn uniformly, S != T, afresh for every
request, from the uids with at least one edge (Graph500's rule for search
keys). The reference computes the canonical path (reference/paths.py) and
the whole answer is compared exactly.
"""

from __future__ import annotations

import numpy as np

from graphbench.reference import paths

DEPTH = 64      # the request sets no depth: the serving default applies


def make(rng: np.random.Generator, data: dict, params: dict,
         u: float) -> dict:
    pred = params["predicate"]
    src, dst = (int(x) for x in rng.choice(data["pools"][pred], 2,
                                           replace=False))
    text = "{ path as shortest(from: %s, to: %s) { %s } }" % (
        hex(src), hex(dst), pred)
    return {"text": text, "src": src, "dst": dst, "pred": pred}


def render(path: list[int] | None, pred: str) -> dict:
    """Dgraph's answer for one path over one predicate."""
    if path is None:
        return {}
    node: dict = {"uid": hex(path[-1])}
    for uid in reversed(path[:-1]):
        node = {"uid": hex(uid), pred: [node]}
    node["_weight_"] = float(len(path) - 1)
    return {"_path_": [node]}


def answer(ref, req) -> tuple[dict, None]:
    path = paths.shortest_path(ref.adj[req["pred"]], req["src"], req["dst"],
                               DEPTH)
    return render(path, req["pred"]), None


def judge(ref, req, resp) -> tuple[bool, None]:
    want, _ = answer(ref, req)
    return resp == want, None
