"""Each generator is deterministic per seed, and its shape statistics match
its configuration at a tiny scale."""

import json

import pytest
import torch

from graphbench import spec

from conftest import TINY


def _gen(config: str, seed: int, **over):
    (c,) = [c for c in spec.benchmark()["configs"] if c["name"] == config]
    cfg = json.loads((spec.ROOT / c["file"]).read_text())
    cfg.update(TINY[config], **over)
    return cfg, spec.plugin("datagen", cfg["generator"]).generate(
        cfg, seed, "cpu")


@pytest.mark.parametrize("config", sorted(TINY))
def test_same_seed_same_data(config):
    _, a = _gen(config, 2**31 + 12345)
    _, b = _gen(config, 2**31 + 12345)
    _, c = _gen(config, 2**31 + 12346)
    for attr in a["edges"]:
        assert all(torch.equal(x, y) for x, y in zip(a["edges"][attr],
                                                     b["edges"][attr]))
        assert not torch.equal(a["edges"][attr][1], c["edges"][attr][1])
    assert a["values"] == b["values"]


def test_graph500_shape():
    cfg, d = _gen("graph500-s20", 7, scale=12)
    src, dst = d["edges"]["friend"]
    n = 1 << 12
    assert d["n"] == n
    assert int(src.min()) >= 1 and int(dst.max()) <= n
    assert not bool((src == dst).any())
    key = src * (n + 1) + dst
    assert bool((key[1:] > key[:-1]).all())            # sorted, a set
    ef = src.numel() / n
    assert 12 <= ef <= 16                               # 16 before dedup
    deg = torch.bincount(src, minlength=n + 1).double()
    assert float(deg.max()) > 20 * float(deg.mean())    # Kronecker skew
