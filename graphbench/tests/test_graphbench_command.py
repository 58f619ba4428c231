"""The command as the benchmark's runner starts it: with no card it fails
and prints no result (no CPU fallback); outside a checkout of the program
it fails too."""

import json
import shutil
import subprocess
import sys

import pytest

from graphbench import spec


def _run(cwd):
    return subprocess.run(
        [sys.executable, "-m", "graphbench.run", "--workload",
         "g500s20.khop3-analytic", "--seed", "5", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd)


def _result(stdout: str):
    for line in stdout.splitlines()[::-1]:
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: this test needs a machine without")
    res = _run(spec.ROOT)
    assert res.returncode != 0
    assert _result(res.stdout) is None
    assert "cuda" in res.stderr.lower()


def test_fails_without_the_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "graphbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert _result(res.stdout) is None


@pytest.mark.card
def test_cell_on_the_card(card, tmp_path):
    """One short run of the first cell on the card: correct, with the
    contract's keys."""
    res = _run(spec.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = _result(res.stdout)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
