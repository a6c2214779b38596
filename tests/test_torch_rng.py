"""The port's threefry draws against the JAX package's ``core/rng.py``.

Counter-based draws decide packet loss and phold's peers, and the
simulator's contract is event logs equal bit for bit to the CPU oracle's,
so every draw must equal the reference's exactly: the tolerance is exact
integer equality.
"""

import numpy as np
import pytest
import torch

from shadow_tpu.core import rng as ref_rng
from shadow_tpu_torch.backend import kernels, lanes
from shadow_tpu_torch.core import rng

SEEDS = [0, 1, (1 << 32) + 7, (1 << 64) - 1]
COUNTERS = [0, 1, (1 << 31) - 1, (1 << 32) - 1]
LANES = np.arange(0, lanes.MAX_LANES, 97, dtype=np.uint64)


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_reference_over_the_grid(seed):
    """``rand_u32``, the lane draw with an int32 counter and the kernel
    wrapper's plain draw, over streams LOSS|lane and APP|lane and counters
    up to 2**32 - 1."""
    lo, hi = rng.split_seed(seed)
    assert (lo, hi) == ref_rng._split_seed(seed)
    for base in (ref_rng.LOSS_STREAM, ref_rng.APP_STREAM):
        stream = (LANES | base).astype(np.uint32)
        t_stream = torch.from_numpy(stream.astype(np.int64))
        for counter in COUNTERS:
            want = ref_rng.rand_u32(seed, stream,
                                    np.full(stream.shape, counter, np.uint64))
            want = want.astype(np.int64)
            got = rng.rand_u32(seed, t_stream, counter)
            np.testing.assert_array_equal(got.numpy(), want)
            c32 = torch.full(stream.shape, counter, dtype=torch.int64).to(
                torch.int32)  # 2**32 - 1 wraps to -1, as the lane counter
            lane = lanes.rand_u32_lane(seed, t_stream, c32)
            np.testing.assert_array_equal(lane.numpy(), want)
            bits = kernels.rand_u32(seed, rng.as_i32(t_stream), c32)
            assert bits.dtype == torch.int32
            np.testing.assert_array_equal(
                (bits.to(torch.int64) & rng.M32).numpy(), want)


def test_both_words_and_64_bit_counters_match_reference():
    r = np.random.default_rng(3)
    stream = r.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    counter = r.integers(0, 1 << 63, 4096, dtype=np.uint64)
    for seed in SEEDS:
        want = ref_rng.rand_u32_pair(seed, stream, counter)
        got = rng.rand_u32_pair(seed, torch.from_numpy(stream.astype(np.int64)),
                                torch.from_numpy(counter.astype(np.int64)))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_threefry_rounds_match_reference_on_random_words():
    r = np.random.default_rng(5)
    k0, k1, c0, c1 = (r.integers(0, 1 << 32, 8192, dtype=np.uint64)
                      .astype(np.uint32) for _ in range(4))
    want = ref_rng.threefry2x32(k0, k1, c0, c1)
    got = rng.threefry2x32(*(torch.from_numpy(a.astype(np.int64))
                             for a in (k0, k1, c0, c1)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_u32_below_matches_reference():
    r = np.random.default_rng(9)
    u = np.concatenate([[0, 1, (1 << 32) - 1],
                        r.integers(0, 1 << 32, 4000, dtype=np.uint64)])
    u = u.astype(np.uint32)
    for n in (1, 2, 3, 9_999, lanes.MAX_LANES - 1, (1 << 31) - 1):
        want = ref_rng.u32_below(u, n).astype(np.int64)
        got = rng.u32_below(torch.from_numpy(u.astype(np.int64)), n)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.max()) < n


@pytest.mark.parametrize("loss", [0.0, 1.0, 0.01, 0.2, 0.5, 1e-9,
                                  0.999999999, -0.5, 1.5])
def test_loss_threshold_matches_reference(loss):
    assert rng.loss_threshold(loss) == ref_rng.loss_threshold(loss)


def test_kernel_wrapper_takes_the_plain_draw_on_cpu_and_checks_words():
    kernels.reset_launches()
    words = torch.zeros(3, dtype=torch.int32)
    assert kernels.rand_u32(1, words, words).shape == (3,)
    assert kernels.rand_u32.launches == 0
    with pytest.raises(ValueError, match="rand_u32"):
        kernels.rand_u32(1, words, words[:2])
    with pytest.raises(ValueError, match="rand_u32"):
        kernels.rand_u32(1, words, words.to(torch.int64))
    with pytest.raises(ValueError, match="rand_u32"):
        kernels.rand_u32(1, words[None], words[None])


def test_as_i32_keeps_the_bits():
    x = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    got = rng.as_i32(x)
    assert got.dtype == torch.int32
    assert got.tolist() == [0, 1, (1 << 31) - 1, -(1 << 31), -1]
    assert ((got.to(torch.int64) & rng.M32) == x).all()
