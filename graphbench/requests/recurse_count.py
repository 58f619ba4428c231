"""Friends of friends of friends of one Person, counted: Dgraph's documented
`@recurse` block with a var on its predicate, and a count over the var.

    { var(func: uid(S)) @recurse(depth: 3, loop: false) { R as knows }
      q(func: uid(R)) { count(uid) } }

(for depth = 3). R binds every uid the recurse reached, at any level; the
answer is {"q": [{"count": |R|}]}, compared whole. The start Person is
drawn uniformly from the uids with at least one edge. The request's edges
are those the recurse kept (each traversed once, loop: false), counted by
the reference (reference/recurse.py).

A program that binds no var inside `@recurse` would answer every request
with a count of 0, and be timed doing so. So before its first request the
kind asks the program's own Node, a throwaway one on the CPU holding the
chain 1 -> 2 -> 3, for R of a depth-2 recurse from 1, and refuses to make
requests (it raises, and the run ends without a result) unless R holds both
levels' uids.
"""

from __future__ import annotations

import numpy as np

from graphbench.reference import recurse

CHAIN = "<0x1> <p> <0x2> .\n<0x2> <p> <0x3> ."
ASK = ("{ var(func: uid(0x1)) @recurse(depth: 2, loop: false) { R as p } "
       "q(func: uid(R)) { count(uid) } }")
_checked: list[bool] = []


def program_binds_every_level() -> None:
    """Raise unless the program binds every level's uids to a var inside
    @recurse (asked once a process)."""
    if _checked:
        return
    from dgraph_tpu_torch.api.server import Node

    node = Node(device="cpu")
    try:
        node.alter("p: [uid] .")
        node.mutate(set_nquads=CHAIN, commit_now=True)
        got = node.query(ASK)[0]
    finally:
        node.close()
    if got != {"q": [{"count": 2}]}:
        raise RuntimeError("recurse_count: the program binds a var inside "
                           f"@recurse to other uids than every level's ({got}"
                           " for the chain 1 -> 2 -> 3); no request is made")
    _checked.append(True)


def make(rng: np.random.Generator, data: dict, params: dict,
         u: float) -> dict:
    program_binds_every_level()
    pred = params["predicate"]
    seeds = np.sort(rng.choice(data["pools"][pred], int(params["seeds"]),
                               replace=False))
    depth = int(params["depth"])
    text = ("{ var(func: uid(%s)) @recurse(depth: %d, loop: false) "
            "{ R as %s } q(func: uid(R)) { count(uid) } }"
            % (", ".join(hex(int(s)) for s in seeds), depth, pred))
    return {"text": text, "seeds": seeds.tolist(), "pred": pred,
            "depth": depth}


def answer(ref, req) -> tuple[dict, int]:
    adj = ref.adj[req["pred"]]
    levels, edges = recurse.recurse(adj, req["seeds"], req["depth"])
    return {"q": [{"count": int(recurse.union(levels, adj.n).numel())}]}, \
        edges


def judge(ref, req, resp) -> tuple[bool, int]:
    want, edges = answer(ref, req)
    return resp == want, edges
