"""The grouped-var cell at a tiny size on the CPU: the plain reference
against a brute-force count over the edge list, the request kind made and
judged, wrong answers judged wrong, and the probe that refuses a program
which binds no grouped var. This module also gives conftest.TINY the cell's
configuration's tiny scale, which the cell-wide tests read when they run."""

import collections

import numpy as np
import pytest

from graphbench import run, spec
from graphbench.reference import groupby as ref_groupby
from graphbench.reference.dataset import Reference

from conftest import TINY, tiny_cell

CELL = "g500s20.groupby"
TINY.setdefault("graph500-s20-groupby", {"scale": 10})
KIND = spec.plugin("requests", "groupby_top")


def _tiny(seed: int = 3):
    cell = tiny_cell(CELL)
    data = run.host_data(spec.plugin("datagen", cell.config["generator"])
                         .generate(cell.config, seed, "cpu"))
    return cell, data, Reference(data)


def _brute(src, dst, seeds, hops):
    """Levels by Python sets over the edge list, then each key's count of
    distinct level-`hops` uids with an edge into it."""
    out = collections.defaultdict(set)
    for s, d in zip(src.tolist(), dst.tolist()):
        out[s].add(d)
    level = set(seeds)
    for _ in range(hops):
        level = set().union(*(out[u] for u in level))
    groups = collections.Counter()
    for u in level:
        for t in out[u]:
            groups[t] += 1
    return groups


def test_reference_equals_a_brute_force_count():
    cell, data, ref = _tiny()
    src, dst = data["edges"]["friend"]
    rng = np.random.default_rng(7)
    for _ in range(3):
        seeds = rng.choice(data["pools"]["friend"], 128,
                           replace=False).tolist()
        keys, counts, _ = ref_groupby.grouped_counts(ref.adj["friend"],
                                                     seeds, 2)
        want = _brute(src, dst, seeds, 2)
        assert dict(zip(keys.tolist(), counts.tolist())) == dict(want)
        tk, tc = ref_groupby.top(keys, counts, 100)
        order = sorted(want.items(), key=lambda kv: (-kv[1], kv[0]))[:100]
        assert list(zip(tk.tolist(), tc.tolist())) == order


def test_make_and_judge():
    cell, data, ref = _tiny()
    params = cell.traffic["requests"][0]["params"]
    req = KIND.make(np.random.default_rng(1), data, params, 0.5)
    assert "{ friend { B as friend } }" in req["text"]
    assert "var(func: uid(B)) @groupby(friend) { c as count(uid) }" \
        in req["text"]
    assert "q(func: uid(c), orderdesc: val(c), first: 100) " \
        "{ uid n: val(c) }" in req["text"]
    assert "t() { s: sum(val(c)) }" in req["text"]
    assert len(req["seeds"]) == 128 == len(set(req["seeds"]))
    want, edges = KIND.answer(ref, req)
    assert KIND.judge(ref, req, want) == (True, edges)
    keys, counts, _ = ref_groupby.grouped_counts(ref.adj["friend"],
                                                 req["seeds"], 2)
    assert want["g"] == [{"count": keys.numel()}]
    assert want["t"] == [{"s": int(counts.sum())}]
    assert len(want["q"]) == min(100, keys.numel())


@pytest.mark.parametrize("fault", ["count", "row", "order", "total"])
def test_wrong_answers_are_judged_wrong(fault):
    cell, data, ref = _tiny()
    req = KIND.make(np.random.default_rng(2), data,
                    cell.traffic["requests"][0]["params"], 0.5)
    resp, _ = KIND.answer(ref, req)
    if fault == "count":
        resp["q"][-1]["n"] -= 1
    elif fault == "row":
        del resp["q"][-1]
    elif fault == "order":
        resp["q"][0], resp["q"][1] = resp["q"][1], resp["q"][0]
    else:
        resp["t"][0]["s"] += 1
    assert KIND.judge(ref, req, resp)[0] is False


def test_a_program_that_binds_no_grouped_var_is_refused(monkeypatch):
    """A program whose @groupby binds no var (the JAX package's rule, the
    port's before grouped vars) gets no request made: the kind raises, so
    a run ends without a result instead of being timed on empty
    answers."""
    from dgraph_tpu_torch.query import groupby as program_groupby

    monkeypatch.setattr(program_groupby, "_grouped_var_children",
                        lambda ex, gq: [])
    monkeypatch.setattr(KIND, "_checked", [])
    cell, data, _ = _tiny()
    params = cell.traffic["requests"][0]["params"]
    with pytest.raises(RuntimeError, match="binds no grouped var"):
        KIND.make(np.random.default_rng(1), data, params, 0.5)
    monkeypatch.undo()
    assert KIND.make(np.random.default_rng(1), data, params, 0.5)["seeds"]
