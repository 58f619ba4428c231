"""graphbench's own tests, run with `python -m pytest graphbench/tests`.

They run on the CPU at tiny sizes through `Node(device="cpu")`. A test that
needs the card takes the `card` fixture and carries the `card` marker: the
fixture decides, when the test runs, whether a card is there, and skips
with a reason where none is."""

import pytest

from graphbench import spec

TINY = {
    "graph500-s20": {"scale": 10},
}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


def tiny_cell(name: str):
    cell = spec.cell(name)
    cell.config.update(TINY[cell.config["name"]])
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card")
    return torch.device("cuda")
