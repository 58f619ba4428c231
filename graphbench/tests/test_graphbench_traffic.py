"""Each cell's traffic, run through Node(device="cpu") at a tiny scale,
answers what the plain reference answers; every answer is judged. The
generator's open loop and the knee sweep run on the first cell's data."""

import time

import pytest

from graphbench import run

from conftest import CELLS, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_cell_answers_match_reference(name):
    """Each cell of BENCHMARK.json."""
    out = run.run_cell(tiny_cell(name), 2**31 + 99, 2.0, False, "cpu",
                       t_start=time.perf_counter())
    assert out["checks"]["wrong_answers"]["value"] == 0, \
        out["_notes"]["wrong_examples"]
    assert out["checks"]["missing_answers"]["value"] == 0, \
        out["_notes"]["errors"]
    assert out["correct"] is True and out["attempted"] > 0
    assert out["failed"] == 0
    assert list(out)[-2:] == ["checks", "_notes"]
    want = {m["name"] for m in tiny_cell(name).end_to_end}
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())


def open_loop_cell(rate: float = 4.0):
    """The first cell at the tiny size, its traffic sent in an open loop
    at `rate` requests a second by 4 client threads."""
    cell = tiny_cell(CELLS[0])
    cell.traffic = dict(cell.traffic, loop="open", rate=rate, clients=4)
    return cell


def test_open_loop_answers_match_reference():
    out = run.run_cell(open_loop_cell(), 17, 3.0, False, "cpu",
                       t_start=time.perf_counter())
    assert out["correct"] is True and out["attempted"] == 12
    assert out["_notes"]["generator_late_p95_ms"] is not None


def test_every_seed_gets_the_same_work():
    """Two seeds' open-loop windows: as many requests, the same kinds in
    the same shares and the same seed count each, different uids."""
    import numpy as np

    from graphbench import loadgen, spec

    cell = open_loop_cell()
    data = run.host_data(spec.plugin("datagen", "graph500").generate(
        cell.config, 3, "cpu"))
    mix = loadgen.Mix(cell.traffic, data)
    due = [loadgen.arrivals(4.0, 10.0, np.random.default_rng([s, 3]))
           for s in (1, 2)]
    assert len(due[0]) == len(due[1]) == 40
    assert not np.array_equal(due[0], due[1])
    a = mix.requests(40, np.random.default_rng([1, 1]))
    b = mix.requests(40, np.random.default_rng([2, 1]))
    assert [r["seeds"] for r in a] != [r["seeds"] for r in b]
    assert sorted((r["kind"], len(r["seeds"])) for r in a) == \
        sorted((r["kind"], len(r["seeds"])) for r in b)


def test_sweep_step_on_the_cpu():
    import numpy as np

    from graphbench import sweep

    cell = open_loop_cell()
    p = run.Prepared(cell, 5, "cpu")
    try:
        row = sweep.step(p, cell, 4.0, 2.0, 10.0, np.random.default_rng(1))
    finally:
        p.close()
    assert row["requests"] == 8 and row["failed"] == 0
    assert row["p50_ms"] <= row["p95_ms"]


def test_closed_loop_kinds_in_exact_shares_per_block():
    import numpy as np

    from graphbench import loadgen

    traffic = {"loop": "closed", "clients": 1, "requests": [
        {"kind": "khop_union", "share": s} for s in (0.4, 0.3, 0.2, 0.1)]}
    mix = loadgen.Mix(traffic, {"n": 10})
    seen = []
    mix.make = lambda rng, i, u: seen.append(i) or {"text": "", "kind": i}
    loadgen.closed_loop(lambda text: {}, mix, np.random.default_rng(3),
                        0.3, 1, 1.0)
    assert len(seen) >= 2 * loadgen.BLOCK
    for b in range(len(seen) // loadgen.BLOCK):
        block = seen[b * loadgen.BLOCK:(b + 1) * loadgen.BLOCK]
        assert [block.count(k) for k in range(4)] == [8, 6, 4, 2]
