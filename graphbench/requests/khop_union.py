"""A k-hop neighbourhood count from a set of seed uids.

    { var(func: uid(S)) { A as p { B as p { C as p } } }
      q(func: uid(A, B, C)) { count(uid) } }

(for hops = 3): the uids within `hops` steps of the seeds, counted. The
seeds are drawn uniformly, without repeats, from the uids that have an
out-edge. The request requires every out-edge of every uid of each level
but the last; the reference counts those edges from the degrees.
"""

from __future__ import annotations

import numpy as np

VARS = "ABCDEFGH"


def make(rng: np.random.Generator, data: dict, params: dict,
         u: float) -> dict:
    pred = params["predicate"]
    seeds = np.sort(rng.choice(data["pools"][pred], int(params["seeds"]),
                               replace=False))
    hops = int(params["hops"])
    inner = ""
    for v in reversed(VARS[:hops]):
        inner = f"{v} as {pred}" + (f" {{ {inner} }}" if inner else "")
    text = ("{ var(func: uid(%s)) { %s } q(func: uid(%s)) { count(uid) } }"
            % (", ".join(hex(int(s)) for s in seeds), inner,
               ", ".join(VARS[:hops])))
    return {"text": text, "seeds": seeds.tolist(), "pred": pred,
            "hops": hops}


def answer(ref, req) -> tuple[dict, int]:
    reached, edges = ref.adj[req["pred"]].khop_union(req["seeds"],
                                                     req["hops"])
    return {"q": [{"count": int(reached.numel())}]}, edges


def judge(ref, req, resp) -> tuple[bool, int]:
    want, edges = answer(ref, req)
    return resp == want, edges
