"""The LDBC knows cell at a tiny size on the CPU: its generator keeps the
configuration's shape, its request kind is judged right on a sound run,
and a wrong count comes out not correct. This module also gives
conftest.TINY the configuration's tiny size, which the cell-wide tests
read when they run: 2,000 Persons at a mean degree of 5. At the
mean-degree law's 21.6 there, three hops reach every Person from any
start, and a count that is always 2,000 would not see a lost edge.
"""

import time

import numpy as np
import pytest
import torch

from graphbench import run, spec
from graphbench.reference import recurse as ref_recurse
from graphbench.reference.dataset import Reference

from conftest import TINY

CELL = "ldbc100.recurse3-person"
GEN = spec.plugin("datagen", "ldbc_knows")
PERSONS = 2000
TINY.setdefault("ldbc-snb-sf100-knows", {"persons": PERSONS, "knows": 5000})


def tiny():
    cell = spec.cell(CELL)
    cell.config.update(TINY[cell.config["name"]])
    return cell


def _edges(seed: int, **over):
    cfg = tiny().config
    cfg.update(over)
    return cfg, GEN.generate(cfg, seed, "cpu")


def test_the_law_gives_the_published_sf100_mean():
    """0.89 n^(0.512 - 0.028 log10 n) at SF 100's Person count is its
    published 2 knows / persons within 0.1%."""
    cfg = spec.cell(CELL).config
    published = 2 * cfg["knows"] / cfg["persons"]
    assert GEN.mean_degree(cfg["persons"]) == pytest.approx(published,
                                                            rel=1e-3)


def test_same_seed_same_graph():
    _, a = _edges(2**31 + 1)
    _, b = _edges(2**31 + 1)
    _, c = _edges(2**31 + 2)
    assert all(torch.equal(x, y) for x, y in zip(a["edges"]["knows"],
                                                 b["edges"]["knows"]))
    assert not torch.equal(a["edges"]["knows"][1], c["edges"]["knows"][1])


@pytest.mark.parametrize("persons", [1000, PERSONS, 5000])
def test_shape_at_a_reduced_person_count(persons):
    """Within 3% of the law's knows count (so of its mean degree), uids
    1..persons, no self-loop, every edge stored both ways once, no Person
    above the degree cap."""
    knows = round(persons * GEN.mean_degree(persons) / 2)
    cfg, d = _edges(2**31 + 7, persons=persons, knows=knows)
    src, dst = d["edges"]["knows"]
    assert d["n"] == persons
    assert abs(src.numel() / 2 - knows) <= 0.03 * knows
    assert abs(src.numel() / persons - 2 * knows / persons) <= \
        0.03 * 2 * knows / persons
    assert int(src.min()) >= 1 and int(src.max()) <= persons
    assert not bool((src == dst).any())
    fwd = (src << 32) | dst
    assert bool((fwd[1:] > fwd[:-1]).all())          # sorted, distinct
    rev, _ = torch.sort((dst << 32) | src)
    assert torch.equal(rev, fwd)                      # symmetric
    degree = torch.bincount(src, minlength=persons + 1)
    assert int(degree.max()) <= min(cfg["degree_cap"], persons - 1)


def test_a_sound_run_is_correct():
    out = run.run_cell(tiny(), 2**31 + 5, 3.0, False, "cpu",
                       t_start=time.perf_counter())
    assert out["correct"] is True
    assert out["attempted"] > 0
    assert out["checks"]["wrong_answers"]["value"] == 0


def test_make_and_judge():
    cell = tiny()
    data = run.host_data(GEN.generate(cell.config, 3, "cpu"))
    ref = Reference(data)
    kind = spec.plugin("requests", "recurse_count")
    req = kind.make(np.random.default_rng(1), data,
                    cell.traffic["requests"][0]["params"], 0.5)
    assert "@recurse(depth: 3, loop: false) { R as knows }" in req["text"]
    assert "q(func: uid(R)) { count(uid) }" in req["text"]
    adj = ref.adj["knows"]
    levels, edges = ref_recurse.recurse(adj, req["seeds"], 3)
    count = int(ref_recurse.union(levels, adj.n).numel())
    assert kind.judge(ref, req, {"q": [{"count": count}]}) == (True, edges)
    assert kind.judge(ref, req, {"q": [{"count": count - 1}]})[0] is False
    assert kind.judge(ref, req, {"q": [{"count": 0}]})[0] is False


def test_a_wrong_count_is_not_correct():
    """A count one short in every answer of the window."""
    cell = tiny()
    warm = [0]
    n_warm = cell.traffic["warmup"]

    def planted(node, call):
        def maybe(text):
            warm[0] += 1
            out = call(text)
            if warm[0] > n_warm:
                out["q"][0]["count"] -= 1
            return out

        return maybe

    out = run.run_cell(cell, 2**31 + 9, 3.0, False, "cpu",
                       call_hook=planted, t_start=time.perf_counter())
    assert out["correct"] is False
    assert out["checks"]["wrong_answers"]["value"] == out["attempted"]


def test_a_program_that_binds_only_the_block_var_is_refused(monkeypatch):
    """A program whose recurse binds no var on its predicate (the JAX
    package's rule, the port's before the binding) gets no request made:
    the kind raises, so a run ends without a result instead of being
    timed on answers of 0."""
    from dgraph_tpu_torch.query import recurse as program_recurse

    kind = spec.plugin("requests", "recurse_count")

    def block_var_only(ex, sg, uid_children):
        ex._record_uid_var(sg.gq, sg)

    monkeypatch.setattr(program_recurse, "bind_vars", block_var_only)
    monkeypatch.setattr(kind, "_checked", [])
    cell = tiny()
    data = run.host_data(GEN.generate(cell.config, 3, "cpu"))
    with pytest.raises(RuntimeError, match="binds a var inside @recurse"):
        kind.make(np.random.default_rng(1), data,
                  cell.traffic["requests"][0]["params"], 0.5)
    monkeypatch.undo()
    assert kind.make(np.random.default_rng(1), data,
                     cell.traffic["requests"][0]["params"], 0.5)["seeds"]
