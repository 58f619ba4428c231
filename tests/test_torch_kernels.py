"""Parity of the port's active-prefix kernels with the Pallas originals.

The port's K1/K2 (dgraph_tpu_torch/ops/prefix.py) take their plain PyTorch
versions on CPU tensors; the JAX active_prefix / active_prefix_sparse run in
Pallas interpret mode on the CPU, as the JAX package's own tests run them.
Inputs are made with numpy from a seed and handed to both; the outputs are
int32 prefix counts and must be equal exactly (tolerance 0). The CUDA
kernels themselves are held to the same plain versions on the card by
chip_smoke.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dgraph_tpu.ops import pallas_bfs as jpb
from dgraph_tpu_torch.ops import prefix as tpx
from dgraph_tpu_torch.ops import pull_bfs as tpb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's intra-op pool, and the tier-1
    run shares the cores with timing-sensitive tests in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(rng, n_ranks: int, n_edges: int):
    """Destination-sorted-like stream of source ranks padded to EDGE_BLOCK
    with the always-zero pad rank, as prep_pull lays it out."""
    chunks = tpb._chunks_for(n_ranks)
    e_pad = max(tpx.EDGE_BLOCK, -(-n_edges // tpx.EDGE_BLOCK) * tpx.EDGE_BLOCK)
    src = np.full(e_pad, chunks * tpx.NODES_PER_CHUNK - 1, dtype=np.int32)
    src[:n_edges] = rng.integers(0, n_ranks, n_edges)
    return src, chunks


def _dense_both(mask: np.ndarray, src: np.ndarray, chunks: int):
    words_j = jpb.pack_words(jnp.asarray(mask), chunks)
    words_t = tpb.pack_words(torch.from_numpy(mask), chunks)
    np.testing.assert_array_equal(np.asarray(words_j), words_t.numpy())
    want = np.asarray(jpb.active_prefix(words_j, jnp.asarray(src),
                                        chunks=chunks))
    got = tpx.active_prefix(words_t, torch.from_numpy(src), chunks)
    return want, got.numpy()


def _sparse_both(mask: np.ndarray, src: np.ndarray):
    ftab_j = jpb._frontier_table(jnp.asarray(mask))
    ftab_t = tpb._frontier_table(torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(ftab_j), ftab_t.numpy())
    want = np.asarray(jpb.active_prefix_sparse(ftab_j, jnp.asarray(src)))
    got = tpx.active_prefix_sparse(ftab_t, torch.from_numpy(src))
    return want, got.numpy()


@pytest.mark.parametrize("n_ranks", [32767, 32768, 32769])
def test_dense_chunk_boundary(n_ranks):
    rng = np.random.default_rng(n_ranks)
    src, chunks = _stream(rng, n_ranks, 12000)
    mask = rng.random(n_ranks) < 0.3
    mask[n_ranks - 1] = True           # the last real rank, next to the pad
    want, got = _dense_both(mask, src, chunks)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[-1] > 0


def test_dense_multi_chunk_bitmap():
    rng = np.random.default_rng(7)
    src, chunks = _stream(rng, 140_000, 9000)
    assert chunks == 5
    mask = rng.random(140_000) < 0.05
    want, got = _dense_both(mask, src, chunks)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extra", [1, 8191])
def test_stream_not_block_aligned(extra):
    rng = np.random.default_rng(extra)
    src, chunks = _stream(rng, 5000, tpx.EDGE_BLOCK + extra)
    assert len(src) == 2 * tpx.EDGE_BLOCK
    mask = rng.random(5000) < 0.5
    want, got = _dense_both(mask, src, chunks)
    np.testing.assert_array_equal(got, want)
    # the padding tail never counts
    assert got[tpx.EDGE_BLOCK + extra - 1] == got[-1]


def test_empty_frontier_both_kernels():
    rng = np.random.default_rng(3)
    src, chunks = _stream(rng, 40_000, 10_000)
    mask = np.zeros(40_000, dtype=bool)
    for want, got in (_dense_both(mask, src, chunks),
                      _sparse_both(mask, src)):
        np.testing.assert_array_equal(got, want)
        assert got[-1] == 0


@pytest.mark.parametrize("n_set", [1, 300, tpx.FRONTIER_CAP])
def test_sparse_matches_jax_and_dense(n_set):
    """K2 equals the Pallas sparse kernel, and K1 == K2 on one frontier."""
    rng = np.random.default_rng(n_set)
    n = 60_000
    src, chunks = _stream(rng, n, 15_000)
    mask = np.zeros(n, dtype=bool)
    mask[rng.choice(n, n_set, replace=False)] = True
    want_s, got_s = _sparse_both(mask, src)
    np.testing.assert_array_equal(got_s, want_s)
    want_d, got_d = _dense_both(mask, src, chunks)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_s, got_d)


@pytest.mark.parametrize("n", [1, 4095, 32768, 70_001])
def test_pack_unpack_round_trip(n):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.5
    chunks = tpb.pack_chunks(n)
    words_t = tpb.pack_words(torch.from_numpy(mask), chunks).numpy()
    np.testing.assert_array_equal(
        words_t, np.asarray(jpb.pack_words(jnp.asarray(mask), chunks)))
    np.testing.assert_array_equal(tpb.unpack_words(words_t, n), mask)
    np.testing.assert_array_equal(tpb.unpack_words(words_t, n),
                                  jpb.unpack_words(words_t, n))
    # batched rows pack like the JAX vmap
    rows = np.stack([mask, ~mask])
    np.testing.assert_array_equal(
        tpb.pack_mask(torch.from_numpy(rows)).numpy(),
        np.asarray(jpb.pack_mask_rows(jnp.asarray(rows))))


def test_wrappers_reject_bad_inputs():
    src = torch.zeros(tpx.EDGE_BLOCK, dtype=torch.int32)
    words = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="length"):
        tpx.active_prefix(words, src[:100], 1)
    with pytest.raises(TypeError, match="int32"):
        tpx.active_prefix(words, src.to(torch.int64), 1)
    with pytest.raises(ValueError, match="words must be"):
        tpx.active_prefix(words, src, 2)
    with pytest.raises(ValueError, match="ftab must be"):
        tpx.active_prefix_sparse(words, src)
    with pytest.raises(ValueError, match="contiguous"):
        tpx.active_prefix(torch.zeros((128, 8), dtype=torch.int32).T, src, 1)
    # CPU tensors take the plain versions and never count a launch
    tpx.reset_launches()
    tpx.active_prefix(words, src, 1)
    assert tpx.LAUNCHES == {"active_prefix": 0, "active_prefix_sparse": 0}


@pytest.mark.parametrize("n_set", [0, 1, 300, tpx.FRONTIER_CAP])
def test_sparse_ref_is_table_membership(n_set):
    """The CUDA K2 tests "src[e] is an entry of ftab[1:]" with a hash set.
    For the tables _frontier_table builds (sorted, unique, INT32_MAX pads)
    that is exactly the plain version's bucket search, pad ranks and
    INT32_MAX ranks in the stream included: a table with fewer than 4,096
    entries holds INT32_MAX, so an INT32_MAX edge counts; a full one does
    not."""
    rng = np.random.default_rng(200 + n_set)
    n, n_edges = 50_000, 20_000
    src, _ = _stream(rng, n, n_edges)           # pad ranks in the tail
    mask = np.zeros(n, dtype=bool)
    mask[rng.choice(n, n_set, replace=False)] = True
    members = np.flatnonzero(mask)
    if n_set:                                   # some edges hit the frontier
        src[:n_edges:7] = rng.choice(members, len(src[:n_edges:7]))
    n_max = 300
    src[rng.choice(len(src), n_max, replace=False)] = tpx.INT32_MAX
    ftab = tpb._frontier_table(torch.from_numpy(mask))
    src_t = torch.from_numpy(src)
    want = torch.cumsum(torch.isin(src_t, ftab[1:].reshape(-1)), 0)
    got = tpx.active_prefix_sparse_ref(ftab, src_t)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    hits = int(np.isin(src, members).sum())
    assert hits > 0 or n_set == 0
    assert int(got[-1]) == hits + (n_max if n_set < tpx.FRONTIER_CAP else 0)


def test_cuda_tile_divides_edge_block():
    """The CPU tests build no CUDA kernel, so the tile comes from the
    source."""
    cu = (Path(tpx.__file__).parent / "csrc" / "active_prefix.cu").read_text()
    tile = int(re.search(r"constexpr int kTile = (\d+);", cu).group(1))
    assert tile > 0 and tpx.EDGE_BLOCK % tile == 0


def test_bench_loads_another_checkouts_kernels():
    """bench_torch_prefix.py --against DIR loads DIR's prefix module on its
    own: a separate module whose build goes under DIR, whose wrappers give
    the same answers on CPU tensors."""
    import bench_torch_prefix

    root = Path(tpx.__file__).resolve().parents[2]
    other = bench_torch_prefix.load_prefix(root)
    assert other is not tpx and other.BUILD_DIR == root / "build" / \
        "dgraph_tpu_torch"
    rng = np.random.default_rng(41)
    src, chunks = _stream(rng, 5_000, 3_000)
    src = torch.from_numpy(src)
    mask = torch.from_numpy(rng.random(5_000) < 0.04)
    words, ftab = tpb.pack_words(mask, chunks), tpb._frontier_table(mask)
    np.testing.assert_array_equal(
        other.active_prefix(words, src, chunks).numpy(),
        tpx.active_prefix(words, src, chunks).numpy())
    np.testing.assert_array_equal(other.active_prefix_sparse(ftab, src).numpy(),
                                  tpx.active_prefix_sparse(ftab, src).numpy())
