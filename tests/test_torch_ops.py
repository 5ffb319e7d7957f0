"""The port's plain ops against the JAX package's: grouped conv2d and
ceil-mode max pooling, on the same seeded numpy inputs.

Tolerance fp32: relative 1e-5 (the reference's PairTest bar) with an
absolute floor of 1e-5 for conv outputs near zero, where the two libraries'
different summation orders leave absolute errors of a few fp32 ulps of the
summands. Pooling selects values without arithmetic, so it must be exact.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu import ops as jops
from cxxnet_tpu_torch import ops as tops


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("stride, pad, groups", [(1, (0, 0), 1),
                                                 (4, (0, 0), 1),
                                                 (1, (2, 2), 2),
                                                 (2, (1, 0), 2)])
def test_conv2d_matches_jax(stride, pad, groups):
    x = _rand((2, 4, 13, 11), 0)
    w = _rand((6, 4 // groups, 3, 5), 1)
    want = np.asarray(jops.conv2d(x, w, stride=stride, pad=pad,
                                  groups=groups))
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      stride=stride, pad=pad, groups=groups).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [13, 14, 15, 27, 55])
@pytest.mark.parametrize("k, s, pad", [(3, 2, (0, 0)), (2, 2, (0, 0)),
                                       (3, 1, (1, 1)), (3, 3, (0, 1))])
def test_max_pool_ceil_mode_matches_jax(size, k, s, pad):
    x = _rand((2, 3, size, size + 1), 2)
    want = np.asarray(jops.pool2d(x, "max", (k, k), s, pad=pad))
    got = tops.pool2d(torch.from_numpy(x), "max", (k, k), s,
                      pad=pad).numpy()
    assert got.shape == want.shape
    assert got.shape[2] == tops.pool_out_dim(size + 2 * pad[0], k, s)
    np.testing.assert_array_equal(got, want)


def test_ceil_mode_differs_from_floor():
    # 14 -> 7 with k=3, s=2 where floor mode gives 6: the extra window
    # hangs off the edge and is padded with -inf
    assert tops.pool_out_dim(14, 3, 2) == 7
    assert (14 - 3) // 2 + 1 == 6
    x = torch.arange(14.0).reshape(1, 1, 1, 14).expand(1, 1, 3, 14)
    out = tops.pool2d(x.contiguous(), "max", (3, 3), 2)
    assert out.shape == (1, 1, 1, 7)
    assert out[0, 0, 0].tolist() == [2, 4, 6, 8, 10, 12, 13]


@pytest.mark.parametrize("x, k, s, p, want", [(227, 11, 4, 0, 55),
                                              (27, 5, 1, 2, 27),
                                              (13, 3, 1, 1, 13)])
def test_conv_out_dim(x, k, s, p, want):
    assert tops.conv_out_dim(x, k, s, p) == jops.conv_out_dim(x, k, s, p) \
        == want


def test_pool2d_other_modes_not_ported():
    # max, sum and avg are ported (tests/test_torch_pool_concat.py); any
    # other mode is refused by name
    with pytest.raises(ValueError, match="min"):
        tops.pool2d(torch.zeros(1, 1, 4, 4), "min", (2, 2), 2)


def test_softmax_matches_jax():
    x = _rand((4, 10), 3) * 5
    want = np.asarray(jops.softmax(x))
    got = tops.softmax(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
