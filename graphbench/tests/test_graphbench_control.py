"""The control, the reference answering from a stale snapshot that misses
1% of the writes, comes out not correct in every cell; the sound reference
passes its own answers."""

import pytest

from graphbench import control, loadgen, run, spec
from graphbench.reference.dataset import Reference

from conftest import CELLS, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    out = control.control_run(tiny_cell(name), 2**31 + 3, 12.0, 24, "cpu")
    assert out["requests"] >= 24
    assert out["wrong_answers"] > 0


def test_stale_snapshot_misses_a_share_of_writes():
    cell = tiny_cell(CELLS[0])
    data = run.host_data(spec.plugin("datagen", cell.config["generator"])
                         .generate(cell.config, 9, "cpu"))
    data["values"] = {"name": [f"v{i}" for i in range(data["n"])]}
    old = control.stale(data, 9)
    for attr, (src, _) in data["edges"].items():
        e, o = src.numel(), old["edges"][attr][0].numel()
        assert 0.97 * e < o < e
    changed = sum(a != b for a, b in zip(data["values"]["name"],
                                         old["values"]["name"]))
    assert 0 < changed < 0.03 * data["n"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_reference_passes_itself(name):
    cell = tiny_cell(name)
    data = run.host_data(spec.plugin("datagen", cell.config["generator"])
                         .generate(cell.config, 4, "cpu"))
    mix = loadgen.Mix(cell.traffic, data)
    ref = Reference(data)
    import numpy as np

    rng = np.random.default_rng(1)
    for k in mix.kind_order(20, rng):
        req = mix.make(rng, int(k), float(rng.random()))
        assert mix.judge(ref, req, mix.answer(ref, req)[0])[0]
