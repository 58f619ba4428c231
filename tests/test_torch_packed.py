"""The port's packed posting codec and its device decoder
(ops/packed_decode.py) against the JAX package's, on the CPU.

Each case of tests/test_packed.py runs through both packages: the host
codec (storage/packed.py) must write the same blocks and words, and the
port's `to_device(pl, device="cpu")` + `unpack_device` (torch ops, the
uint32 funnel shift done in int64) must give the JAX decoder's
sentinel-padded uid-set exactly, with its rejections (raw64 blocks, uids
at or past the int32 sentinel). Every bit width 0..31 is decoded too.
"""

import numpy as np
import pytest
import torch

from dgraph_tpu.ops import packed_decode as jpd
from dgraph_tpu.ops import uidset as jus
from dgraph_tpu.storage import packed as jpk

from dgraph_tpu_torch.ops import packed_decode as tpd
from dgraph_tpu_torch.storage import packed as tpk


def gen_uids(rng, n, max_delta=1000):
    deltas = rng.integers(1, max_delta, size=n).astype(np.uint64)
    return np.cumsum(deltas)


def _same_blocks(a, b):
    assert a.count == b.count
    for f in ("block_first", "block_last", "block_count", "block_width",
              "block_off", "words"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def _decode_both(uids):
    pl = tpk.pack(uids)
    _same_blocks(pl, jpk.pack(uids))
    want = np.asarray(jpd.unpack_device(jpd.to_device(jpk.pack(uids))))
    got = tpd.unpack_device(tpd.to_device(pl, device="cpu"))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


@pytest.mark.parametrize("n", [0, 1, 5, 127, 128, 129, 1000, 10_000])
def test_roundtrip_sizes(rng, n):
    uids = gen_uids(rng, n) if n else np.zeros(0, dtype=np.uint64)
    pl = tpk.pack(uids)
    _same_blocks(pl, jpk.pack(uids))
    np.testing.assert_array_equal(tpk.unpack(pl), uids)
    if n == 0 or int(uids[-1]) < 2**31 - 1:
        out = _decode_both(uids)
        np.testing.assert_array_equal(
            out[out != jus.SENTINEL32].astype(np.int64), uids.astype(np.int64))


def test_roundtrip_dense_and_sparse(rng):
    dense = np.arange(5000, dtype=np.uint64) + 7
    pl = tpk.pack(dense)
    assert pl.block_width.max() <= 1
    _decode_both(dense)
    sparse = np.cumsum(rng.integers(1, 2**40, size=500).astype(np.uint64))
    pl = tpk.pack(sparse)
    _same_blocks(pl, jpk.pack(sparse))
    assert (pl.block_width == 64).any()
    np.testing.assert_array_equal(tpk.unpack(pl), sparse)
    for pd in (tpd, jpd):
        with pytest.raises(ValueError, match="raw64"):
            pd.to_device(pl) if pd is jpd else pd.to_device(pl, device="cpu")


def test_compression_ratio(rng):
    uids = gen_uids(rng, 100_000, max_delta=100)
    pl = tpk.pack(uids)
    assert pl.nbytes < uids.nbytes / 4
    _same_blocks(pl, jpk.pack(uids))
    _decode_both(uids)


def test_seek_block(rng):
    uids = gen_uids(rng, 1000, max_delta=10)
    pl = tpk.pack(uids)
    for after in [0, int(uids[0]), int(uids[500]), int(uids[-1])]:
        assert tpk.seek_block(pl, after) == jpk.seek_block(jpk.pack(uids),
                                                           after)


@pytest.mark.parametrize("n,max_delta",
                         [(1, 2), (300, 3), (4096, 1000), (10_000, 30)])
def test_device_decode_parity(rng, n, max_delta):
    uids = gen_uids(rng, n, max_delta=max_delta)
    assert int(uids[-1]) < 2**31
    out = _decode_both(uids)
    np.testing.assert_array_equal(
        out[out != jus.SENTINEL32].astype(np.int64), uids.astype(np.int64))
    assert len(out) == tpd.to_device(tpk.pack(uids), device="cpu").capacity


@pytest.mark.parametrize("width", list(range(0, 32)))
def test_every_bit_width_decodes(width):
    """One block per width: deltas up to 2^width - 1 (width 0: a single uid
    per block), funnel shifts across word boundaries included."""
    rng = np.random.default_rng(width)
    hi = max(1, (1 << width) - 1)
    deltas = rng.integers(max(1, hi // 2), hi + 1, size=300).astype(np.uint64)
    deltas[0] = 1
    uids = np.cumsum(deltas)
    uids = uids[uids < 2**31 - 1]
    pl = tpk.pack(uids)
    if width:
        assert width in pl.block_width.tolist() or len(uids) < 2
    _decode_both(uids)


def test_device_rejects_wide_uids(rng):
    wide = tpk.pack(np.array([1, 2**33], dtype=np.uint64))
    with pytest.raises(ValueError):
        tpd.to_device(wide, device="cpu")
    with pytest.raises(ValueError):
        jpd.to_device(jpk.pack(np.array([1, 2**33], dtype=np.uint64)))
    at_sentinel = np.array([5, 2**31 - 1], dtype=np.uint64)
    for pk, pd in ((tpk, tpd), (jpk, jpd)):
        with pytest.raises(ValueError, match="sentinel"):
            pl = pk.pack(at_sentinel)
            pd.to_device(pl, device="cpu") if pd is tpd else pd.to_device(pl)


def test_pack_many_matches_pack(rng):
    rows = [
        np.zeros(0, dtype=np.uint64),
        np.array([5], dtype=np.uint64),
        np.unique(rng.integers(0, 10**6, size=20).astype(np.uint64)),
        np.unique(rng.integers(0, 10**9, size=300).astype(np.uint64)),
        np.arange(128, dtype=np.uint64) * 7 + 3,
        np.arange(129, dtype=np.uint64),
        np.array([1, 2**33, 2**40], dtype=np.uint64),
        np.unique(rng.integers(0, 50, size=10).astype(np.uint64)),
    ]
    many = tpk.pack_many(rows)
    jmany = jpk.pack_many(rows)
    assert len(many) == len(rows)
    for row, pm, jm in zip(rows, many, jmany):
        np.testing.assert_array_equal(tpk.unpack(pm), row)
        _same_blocks(pm, jm)
        if not len(row) or int(row[-1]) < 2**31 - 1:
            got = tpd.unpack_device(tpd.to_device(pm, device="cpu"))
            want = jpd.unpack_device(jpd.to_device(jm))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpd.to_device(tpk.pack(np.arange(3, dtype=np.uint64)))
