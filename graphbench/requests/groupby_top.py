"""Who a cohort's followees follow most: Dgraph's documented `@groupby`
value-var pattern (a var block groups by a uid predicate and binds the
count, the keys are then ordered by it), over a set of seed uids.

    { var(func: uid(S)) { p { B as p } }
      var(func: uid(B)) @groupby(p) { c as count(uid) }
      q(func: uid(c), orderdesc: val(c), first: F) { uid n: val(c) }
      g(func: uid(c)) { count(uid) }
      t() { s: sum(val(c)) } }

(for hops = 2). B binds the uids two steps from the seeds; c maps each
uid their p edges reach to how many of B reach it. The answer is the top
F keys with their counts, the number of keys and the sum of the counts,
compared whole with the plain reference (reference/groupby.py). The seeds
are drawn uniformly, without repeats, from the uids that have an
out-edge. The request's edges are every out-edge of the seeds, of each
level and of B.

A program that binds no grouped var would answer every request with a
count of 0 and nothing else, and be timed doing so. So before its first
request the kind asks the program's own Node, a throwaway one on the CPU
holding the edges 1 -> 2, 1 -> 3, 2 -> 3, 4 -> 3, to group uid(1, 2, 4) by
the predicate, and refuses to make requests (it raises, and the run ends
without a result) unless c maps 0x3 to 3 and 0x2 to 1.
"""

from __future__ import annotations

import numpy as np

from graphbench.reference import groupby

EDGES = ("<0x1> <p> <0x2> .\n<0x1> <p> <0x3> .\n<0x2> <p> <0x3> .\n"
         "<0x4> <p> <0x3> .")
ASK = ("{ var(func: uid(0x1, 0x2, 0x4)) @groupby(p) { c as count(uid) } "
       "q(func: uid(c), orderdesc: val(c)) { uid n: val(c) } }")
WANT = {"q": [{"uid": "0x3", "n": 3}, {"uid": "0x2", "n": 1}]}
_checked: list[bool] = []


def program_binds_grouped_var() -> None:
    """Raise unless the program binds a grouped count to a var (asked
    once a process)."""
    if _checked:
        return
    from dgraph_tpu_torch.api.server import Node

    node = Node(device="cpu")
    try:
        node.alter("p: [uid] .")
        node.mutate(set_nquads=EDGES, commit_now=True)
        got = node.query(ASK)[0]
    finally:
        node.close()
    if got != WANT:
        raise RuntimeError("groupby_top: the program binds no grouped var "
                           f"of a uid key's counts ({got} for 1 -> 2, 1 -> 3,"
                           " 2 -> 3, 4 -> 3); no request is made")
    _checked.append(True)


def make(rng: np.random.Generator, data: dict, params: dict,
         u: float) -> dict:
    program_binds_grouped_var()
    pred = params["predicate"]
    seeds = np.sort(rng.choice(data["pools"][pred], int(params["seeds"]),
                               replace=False))
    hops, first = int(params["hops"]), int(params["first"])
    inner = ""
    for i in reversed(range(hops)):
        inner = (f"B as {pred}" if i == hops - 1 else pred) + \
            (f" {{ {inner} }}" if inner else "")
    text = ("{ var(func: uid(%s)) { %s } "
            "var(func: uid(B)) @groupby(%s) { c as count(uid) } "
            "q(func: uid(c), orderdesc: val(c), first: %d) { uid n: val(c) } "
            "g(func: uid(c)) { count(uid) } "
            "t() { s: sum(val(c)) } }"
            % (", ".join(hex(int(s)) for s in seeds), inner, pred, first))
    return {"text": text, "seeds": seeds.tolist(), "pred": pred,
            "hops": hops, "first": first}


def answer(ref, req) -> tuple[dict, int]:
    keys, counts, edges = groupby.grouped_counts(
        ref.adj[req["pred"]], req["seeds"], req["hops"])
    out: dict = {"g": [{"count": int(keys.numel())}]}
    if keys.numel():
        tk, tc = groupby.top(keys, counts, req["first"])
        out["q"] = [{"uid": hex(k), "n": c}
                    for k, c in zip(tk.tolist(), tc.tolist())]
        out["t"] = [{"s": int(counts.sum())}]
    return out, edges


def judge(ref, req, resp) -> tuple[bool, int]:
    want, edges = answer(ref, req)
    return resp == want, edges
