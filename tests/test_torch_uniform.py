"""The port's uniform draw (ops/random.py), on the CPU: the plain Philox
version that the CUDA kernel (csrc/uniform.cu) is held to bitwise on the
card, and the dispatch that keeps CPU tensors off the kernel.

The TPU kernel's bits (cxxnet_tpu/ops/pallas_kernels.py ``uniform``) cannot
be reproduced off the TPU, so the draw is held to the JAX package on what
it computes: U[0, 1) on a ladder of 2^24 values, one deterministic stream
per seed, independent across seeds; and against ``jax.random.uniform``,
the draw the JAX layers make on the CPU, as a distribution (two-sample
Kolmogorov-Smirnov).

Bars: the Philox known-answer vectors bit for bit (Random123's, checked
against a reference implementation); moments within 5 standard errors at
10^6 draws; the one-sample KS distance under 2e-3 at 10^6 draws (the 1%
critical value is 1.63e-3); the two-sample distance against JAX under
3e-3 (the 1% critical value at 10^6 + 10^6 draws is 2.3e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu_torch.ops import _build
from cxxnet_tpu_torch.ops import random as trandom

M32 = 0xFFFFFFFF


@pytest.mark.parametrize("counter, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32,) * 4, (M32, M32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    got = trandom.philox4x32(torch.tensor([counter], dtype=torch.int64), key)
    assert tuple(int(w) for w in got[0]) == want


def test_mulhilo_is_the_full_64_bit_product():
    rng = np.random.RandomState(0)
    xs = [0, 1, M32, M32 - 1, 1 << 31] + list(rng.randint(0, 1 << 32, 200,
                                                          dtype=np.uint64))
    x = torch.tensor([int(v) for v in xs], dtype=torch.int64)
    for m in trandom.PHILOX_M + (M32,):
        hi, lo = trandom._mulhilo(m, x)
        for v, h, w in zip(xs, hi.tolist(), lo.tolist()):
            assert (h << 32) | w == m * int(v)


def test_draw_is_on_the_24_bit_ladder_in_unit_interval():
    u = trandom.uniform_ref(12345, (1 << 16,))
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    scaled = u.double() * 2 ** 24
    assert torch.equal(scaled, scaled.round())
    # the words are the top 24 bits of Philox's output: element i is word
    # i % 4 of counter i // 4
    words = trandom.philox4x32(torch.tensor([[7, 0, 0, 0]]),
                               trandom.seed_key(12345))[0]
    assert torch.equal(u[28:32], (words >> 8).float() * 2.0 ** -24)


def test_moments_and_kolmogorov_smirnov_distance():
    n = 10 ** 6
    u = trandom.uniform_ref(2024, (n,)).double()
    se_mean = (1 / 12 / n) ** 0.5
    # variance of (u - 1/2)^2 is 1/80 - 1/144
    se_var = ((1 / 80 - 1 / 144) / n) ** 0.5
    assert abs(float(u.mean()) - 0.5) < 5 * se_mean
    assert abs(float(u.var()) - 1 / 12) < 5 * se_var
    s, _ = torch.sort(u)
    i = torch.arange(1, n + 1, dtype=torch.float64)
    ks = float(torch.maximum(i / n - s, s - (i - 1) / n).max())
    assert ks < 2e-3


def test_draw_follows_the_distribution_of_jax_random_uniform():
    n = 10 ** 6
    a = np.sort(trandom.uniform_ref(99, (n,)).numpy())
    b = np.sort(np.asarray(jax.random.uniform(jax.random.PRNGKey(99), (n,),
                                              jnp.float32)))
    grid = np.concatenate([a, b])
    ks = np.abs(np.searchsorted(a, grid, side="right") / n
                - np.searchsorted(b, grid, side="right") / n).max()
    assert ks < 3e-3


def test_each_seed_is_one_deterministic_stream():
    a = trandom.uniform_ref(5, (3, 7, 11))
    assert torch.equal(a, trandom.uniform_ref(5, (3, 7, 11)))
    b = trandom.uniform_ref(6, (3, 7, 11))
    assert float((a == b).float().mean()) < 0.01
    # a seed above 2^32 uses its high word: it is not the low word's stream
    c = trandom.uniform_ref(5 + (1 << 32), (3, 7, 11))
    assert float((a == c).float().mean()) < 0.01
    assert trandom.seed_key((3 << 32) + 9) == (9, 3)
    with pytest.raises(ValueError, match="seed"):
        trandom.uniform_ref(-1, (4,))
    with pytest.raises(ValueError, match="seed"):
        trandom.uniform_ref(1 << 64, (4,))


@pytest.mark.parametrize("n", [1, 3, 5, 4 * 37 + 3, 4 * 64])
def test_stream_does_not_depend_on_shape_or_split(n):
    # the element at flat index i is the same whatever the shape, the
    # length of the draw, or how the counters are split among launches
    full = trandom.uniform_ref(31, (4 * 64 + 8,))
    assert torch.equal(trandom.uniform_ref(31, (n,)), full[:n])
    if n % 4 == 0:
        assert torch.equal(trandom.uniform_ref(31, (n // 4, 2, 2)).reshape(-1),
                           full[:n])
    key = trandom.seed_key(31)
    idx = torch.arange(66, dtype=torch.int64)
    ctr = torch.stack((idx, 0 * idx, 0 * idx, 0 * idx), -1)
    whole = trandom.philox4x32(ctr, key)
    parts = torch.cat([trandom.philox4x32(ctr[a:b], key)
                       for a, b in ((0, 1), (1, 17), (17, 40), (40, 66))])
    assert torch.equal(whole, parts)
    assert torch.equal((whole.reshape(-1)[:n] >> 8).float() * 2.0 ** -24,
                       full[:n])


def test_uniform_on_the_cpu_never_launches_the_kernel(monkeypatch):
    def no_launch(*args):
        raise AssertionError("the kernel was launched for a CPU device")
    monkeypatch.setattr(_build, "launch", no_launch)
    before = trandom.launches
    got = trandom.uniform(3, (2, 5), "cpu")
    assert trandom.launches == before
    assert torch.equal(got, trandom.uniform_ref(3, (2, 5)))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        trandom.uniform_cuda(3, (2, 5), "cpu")
    with pytest.raises(ValueError, match="no implementation"):
        trandom.uniform(3, (2, 5), "meta")
    assert trandom.uniform(3, (0, 4), "cpu").shape == (0, 4)
