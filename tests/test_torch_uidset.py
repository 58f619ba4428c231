"""The port's uid-set algebra (dgraph_tpu_torch/ops/uidset.py) against the
JAX package's, on the CPU.

The first eight tests mirror tests/test_uidset.py case for case: the same
numpy inputs go through both packages and every output array must be equal
element for element (capacity, sentinel padding, out_size/resize). The rest
hold the host-facing combines (intersect_host, union_host,
difference_host) to numpy on both sides of HOST_CUTOVER, lowered here so
that the torch branch runs on CPU tensors, and pin the reference's int32
wrap above its cutover.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgraph_tpu.ops import uidset as jus
from dgraph_tpu_torch.ops import uidset as tus


def random_sorted(rng, n, lo=0, hi=10_000):
    return np.unique(rng.integers(lo, hi, size=n))


def both(uids, capacity):
    """The same uids as a JAX set and a port set (int32, CPU)."""
    return (jus.make_set(uids, capacity=capacity),
            tus.make_set(uids, capacity=capacity, device="cpu"))


def same(t, j):
    """The port's tensor equals the JAX array, element for element."""
    want = np.asarray(j)
    got = t.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("na,nb,hi", [(5, 5, 20), (100, 100, 300),
                                      (10, 1000, 5000), (1000, 10, 5000),
                                      (0, 50, 100), (500, 500, 600)])
def test_intersect_difference_merge(rng, na, nb, hi):
    a_np = random_sorted(rng, na, hi=hi) if na else np.array([], np.int64)
    b_np = random_sorted(rng, nb, hi=hi) if nb else np.array([], np.int64)
    ja, ta = both(a_np, max(na, 1) + 7)
    jb, tb = both(b_np, max(nb, 1) + 3)
    same(tus.intersect(ta, tb), jus.intersect(ja, jb))
    same(tus.compact(tus.difference(ta, tb)),
         jus.compact(jus.difference(ja, jb)))
    same(tus.merge(ta, tb), jus.merge(ja, jb))
    np.testing.assert_array_equal(tus.to_numpy(tus.intersect(ta, tb)),
                                  np.intersect1d(a_np, b_np))
    np.testing.assert_array_equal(tus.to_numpy(tus.difference(ta, tb)),
                                  np.setdiff1d(a_np, b_np))
    np.testing.assert_array_equal(tus.to_numpy(tus.merge(ta, tb)),
                                  np.union1d(a_np, b_np))


def test_intersect_many(rng):
    lists = [random_sorted(rng, 200, hi=500) for _ in range(4)]
    pairs = [both(l, 256) for l in lists]
    jm = jnp.stack([j for j, _ in pairs])
    tm = torch.stack([t for _, t in pairs])
    same(tus.intersect_many(tm), jus.intersect_many(jm))
    want = lists[0]
    for l in lists[1:]:
        want = np.intersect1d(want, l)
    np.testing.assert_array_equal(tus.to_numpy(tus.intersect_many(tm)), want)
    # a single row passes through; out_size pads and truncates as in JAX
    same(tus.intersect_many(tm[:1]), jus.intersect_many(jm[:1]))
    for out in (1200, 64):
        same(tus.intersect_many(tm, out_size=out),
             jus.intersect_many(jm, out_size=out))


def test_merge_many(rng):
    lists = [random_sorted(rng, 50, hi=2000) for _ in range(6)]
    pairs = [both(l, 64) for l in lists]
    jm = jnp.stack([j for j, _ in pairs])
    tm = torch.stack([t for _, t in pairs])
    same(tus.merge_many(tm), jus.merge_many(jm))
    want = lists[0]
    for l in lists[1:]:
        want = np.union1d(want, l)
    np.testing.assert_array_equal(tus.to_numpy(tus.merge_many(tm)), want)
    for out in (512, 100):
        same(tus.merge_many(tm, out_size=out),
             jus.merge_many(jm, out_size=out))


def test_apply_filter_and_paginate():
    ja, ta = both([2, 4, 6, 8, 10], 8)
    mask = [True, False, True, True, False, False, False, False]
    same(tus.apply_filter(ta, torch.tensor(mask)),
         jus.apply_filter(ja, jnp.asarray(mask)))
    np.testing.assert_array_equal(
        tus.to_numpy(tus.apply_filter(ta, torch.tensor(mask))), [2, 6, 8])
    for (off, cnt), want in (((1, 2), [4, 6]), ((0, -1), [2, 4, 6, 8, 10]),
                             ((3, 100), [8, 10]), ((-2, -1), [8, 10]),
                             ((-9, 2), [2, 4]), ((-3, 1), [6])):
        got = tus.paginate(ta, off, cnt)
        same(got, jus.paginate(ja, off, cnt))
        np.testing.assert_array_equal(tus.to_numpy(got), want)


def test_index_of_and_membership():
    ja, ta = both([5, 7, 11, 13], 6)
    for v, want in ((11, 2), (6, -1), (13, 3), (5, 0), (99, -1)):
        got = tus.index_of(ta, v)
        assert got.dtype == torch.int32 and int(got) == want
        same(got, jus.index_of(ja, v))
    jb, tb = both([7, 13, 99], 4)
    same(tus.is_member(ta, tb), jus.is_member(ja, jb))
    np.testing.assert_array_equal(tus.is_member(ta, tb).numpy()[:4],
                                  [False, True, False, True])


def test_size_and_resize():
    ja, ta = both([1, 2, 3], 10)
    assert int(tus.size(ta)) == int(jus.size(ja)) == 3
    same(tus.size(ta), jus.size(ja))
    grown = tus.resize(ta, 16)
    assert grown.shape == (16,) and int(tus.size(grown)) == 3
    same(grown, jus.resize(ja, 16))
    same(tus.resize(ta, 2), jus.resize(ja, 2))
    np.testing.assert_array_equal(tus.to_numpy(tus.resize(ta, 2)), [1, 2])


def test_int64_works_and_a_sentinel_collision_raises():
    """JAX needs x64 mode for int64 sets (test_int64_requires_x64); torch
    has int64 natively, so the port's int64 sets work and only a uid equal
    to the sentinel is refused."""
    big = [1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5]
    a = tus.make_set(big, capacity=6, dtype=torch.int64, device="cpu")
    b = tus.make_set([2 ** 31 - 1, 2 ** 32 + 5, 7], capacity=4,
                     dtype=torch.int64, device="cpu")
    assert a.dtype == torch.int64
    np.testing.assert_array_equal(tus.to_numpy(tus.intersect(a, b)),
                                  [2 ** 31 - 1, 2 ** 32 + 5])
    np.testing.assert_array_equal(tus.to_numpy(tus.merge(a, b)),
                                  sorted(set(big) | {7}))
    assert int(tus.index_of(a, 2 ** 32 + 5)) == 3
    with pytest.raises(ValueError, match="sentinel"):
        tus.make_set([1, int(tus.SENTINEL64)], dtype=torch.int64,
                     device="cpu")
    with pytest.raises(ValueError, match="sentinel"):
        tus.make_set([1, int(tus.SENTINEL32)], device="cpu")


def test_intersect_output_is_valid_set():
    # regression: results must be compacted so downstream binary searches
    # work
    ja, ta = both([1, 5, 9], 3)
    j5, t5 = both([5], 1)
    c = tus.intersect(ta, t5)
    same(c, jus.intersect(ja, j5))
    assert bool(tus.is_member(t5, c)[0])
    d = tus.difference(ta, t5)
    same(d, jus.difference(ja, j5))
    np.testing.assert_array_equal(tus.to_numpy(d), [1, 9])
    j15, t15 = both([1, 5], 4)
    assert int(tus.index_of(t15, int(tus.SENTINEL32))) == -1
    same(tus.index_of(t15, int(tus.SENTINEL32)),
         jus.index_of(j15, int(jus.SENTINEL32)))


# ---------------------------------------------------------------------------
# the host-facing combines
# ---------------------------------------------------------------------------

COMBINES = ((tus.intersect_host, jus.intersect_host, np.intersect1d,
             "intersect"),
            (tus.union_host, jus.union_host, np.union1d, "union"),
            (tus.difference_host, jus.difference_host, np.setdiff1d,
             "difference"))


def counts():
    return {op: dict(c) for op, c in tus.COMBINES.items()}


@pytest.mark.parametrize("n", [10, 9000])
@pytest.mark.parametrize("ratio", [1, 7])
def test_dispatchers_at_the_default_cutover(n, ratio):
    """n = 10 and n = 9000 as the JAX tests send them: each side of the
    cutovers in both packages, all uids below 2^31."""
    rng = np.random.default_rng(n + ratio)
    a = random_sorted(rng, n, hi=4 * n)
    b = random_sorted(rng, n * ratio, hi=4 * n)
    for tf, jf, nf, _ in COMBINES:
        got = tf(a, b, "cpu")
        np.testing.assert_array_equal(got, nf(a, b))
        np.testing.assert_array_equal(got, jf(a, b))


@pytest.mark.parametrize("cut", [16, 256])
@pytest.mark.parametrize("side", ["below", "at", "above"])
def test_dispatchers_both_sides_of_a_lowered_cutover(monkeypatch, cut,
                                                     side):
    """min(len) just below, at and above HOST_CUTOVER: numpy below, torch
    ops on the CPU from it, each equal to numpy and to JAX, and the
    combine counter moves only from the cutover."""
    monkeypatch.setattr(tus, "HOST_CUTOVER", cut)
    monkeypatch.setattr(jus, "HOST_CUTOVER", cut)
    m = {"below": cut - 1, "at": cut, "above": cut + 3}[side]
    rng = np.random.default_rng(cut)
    a = np.sort(rng.choice(8 * cut, m, replace=False)).astype(np.int64)
    b = np.sort(rng.choice(8 * cut, 3 * m, replace=False)).astype(np.int64)
    for tf, jf, nf, op in COMBINES:
        for x, y in ((a, b), (b, a)):
            before = counts()
            got = tf(x, y, "cpu")
            moved = tus.COMBINES[op]["cpu"] - before[op]["cpu"]
            assert moved == (0 if side == "below" else 1), (op, side)
            assert tus.COMBINES[op]["cuda"] == before[op]["cuda"]
            np.testing.assert_array_equal(got, nf(x, y))
            np.testing.assert_array_equal(got, jf(x, y))
            if side != "below":
                assert got.dtype == np.int64


@pytest.mark.parametrize("seed", range(6))
def test_device_branch_on_unsorted_input_with_repeats(monkeypatch, seed):
    """A uid(...) literal list reaches the combines unsorted and repeated
    (engine._eval_filter_func); numpy's set ops unique their inputs, and
    so must the torch branch."""
    monkeypatch.setattr(tus, "HOST_CUTOVER", 0)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 300, rng.integers(0, 400))
    b = rng.integers(0, 300, rng.integers(0, 400))
    if seed % 2:
        a = np.unique(a)            # one sorted side, one unsorted
    for tf, _, nf, _ in COMBINES:
        for x, y in ((a, b), (b, a), (a, a[::-1])):
            np.testing.assert_array_equal(tf(x, y, "cpu"), nf(x, y))


def test_device_branch_on_empty_inputs(monkeypatch):
    monkeypatch.setattr(tus, "HOST_CUTOVER", 0)
    e = np.zeros(0, np.int64)
    a = np.array([3, 1, 3, 2], np.int64)
    for tf, _, nf, _ in COMBINES:
        for x, y in ((e, e), (a, e), (e, a)):
            got = tf(x, y, "cpu")
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, nf(x, y))


WIDE = (2 ** 31 - 1, 2 ** 31, 2 ** 32, 2 ** 40, 2 ** 62)


@pytest.mark.parametrize("base", WIDE)
def test_device_branch_keeps_int64_uids(monkeypatch, base):
    """Uids at 2^31 - 1 (the JAX int32 sentinel, a real uid here), 2^31,
    2^32 and above come back exactly from the torch branch."""
    monkeypatch.setattr(tus, "HOST_CUTOVER", 64)
    rng = np.random.default_rng(base % 1009)
    a = base + np.sort(rng.choice(400, 150, replace=False)).astype(np.int64)
    b = np.concatenate([
        np.sort(rng.choice(200, 100, replace=False)).astype(np.int64),
        base + np.sort(rng.choice(400, 150, replace=False))])
    for tf, _, nf, op in COMBINES:
        before = tus.COMBINES[op]["cpu"]
        got = tf(a, b, "cpu")
        assert tus.COMBINES[op]["cpu"] == before + 1
        np.testing.assert_array_equal(got, nf(a, b))
    assert 2 ** 31 - 1 in tus.union_host(
        np.array([2 ** 31 - 1] * 70 + list(range(70)), np.int64),
        np.arange(64, 200, dtype=np.int64), "cpu")


def test_reference_wraps_uids_past_int32_above_its_cutover(monkeypatch):
    """Pins the JAX fault the port repairs: above HOST_CUTOVER the JAX
    combines build int32 device sets (`make_set`'s default dtype), so uids
    >= 2^31 wrap. The port's torch branch equals numpy; JAX's does not."""
    a = np.arange(1, 9001, dtype=np.int64) + 2 ** 32
    b = np.arange(1, 9001, dtype=np.int64)
    assert min(len(a), len(b)) >= jus.HOST_CUTOVER    # JAX's device branch
    # the reference answers 9000 uids (1..9000) for both, numpy 0 and 18000
    ji, ju = jus.intersect_host(a, b), jus.union_host(a, b)
    np.testing.assert_array_equal(ji, b)
    np.testing.assert_array_equal(ju, b)
    assert len(np.intersect1d(a, b)) == 0 and len(np.union1d(a, b)) == 18000
    # the port equals numpy on its host branch and on its torch branch
    for cut in (1 << 62, 0):
        monkeypatch.setattr(tus, "HOST_CUTOVER", cut)
        before = counts()
        for tf, _, nf, op in COMBINES:
            np.testing.assert_array_equal(tf(a, b, "cpu"), nf(a, b))
            assert tus.COMBINES[op]["cpu"] - before[op]["cpu"] == \
                (1 if cut == 0 else 0)


def test_dispatchers_refuse_a_missing_card():
    """The device branch runs where the caller says: a CUDA device without
    a card raises rather than falling back to numpy or the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA branch runs")
    big = np.arange(tus.HOST_CUTOVER + 1, dtype=np.int64)
    with pytest.raises(RuntimeError, match="cuda"):
        tus.intersect_host(big, big, "cuda")
    # below the cutover numpy answers whatever the device
    np.testing.assert_array_equal(
        tus.union_host(big[:3], big[:2], "cuda"), big[:3])
