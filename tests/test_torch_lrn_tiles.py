"""The arithmetic of the LRN kernels (cxxnet_tpu_torch/csrc/lrn_fwd.cu and
lrn_bwd.cu), modelled in plain torch on the CPU.

The kernels cut the channels into tiles of ``ops.lrn.CHANNEL_TILE`` (CT).
A tile is staged with its halo: the forward's rows [c0 - lo, c0 + CT +
nsize - 1 - lo), the backward's mirrored rows [c0 + lo - nsize + 1, c0 +
CT + lo), lo = nsize // 2, zero where they fall outside [0, C). The
forward squares each staged x once; the backward forms q = n^(-beta-1)
and t = (g x) q once a staged element (t = 0 outside [0, C)), and
p = n^(-beta) as q n for the tile's own channels. Each window is then
summed directly, in f32, in ascending channel order, and the norm is
(s * salpha) + knorm with salpha the f32 the kernel is given.

The model's norm is held bit for bit to ``lrn_ref_with_norm`` (the kernel's
norm is held so on the card, tests/test_torch_cuda.py), its out to
``lrn_ref`` and its dx to ``lrn_bwd_ref`` at relative 1e-5 (the
reference's PairTest bar; the backward with an absolute 8 f32 epsilons of
the largest |dx|, as on the card: dx is the difference of two terms that
can cancel), and both to the JAX package: out to ``pallas_kernels.lrn`` in
interpret mode and dx to ``jax.grad`` of ``ops.lrn_xla``, at the same bars.
Inputs are made with numpy from a seed.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu import ops as jops
from cxxnet_tpu.ops import pallas_kernels
from cxxnet_tpu_torch.ops import lrn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CT = lrn.CHANNEL_TILE
BETA = 0.75
EPS = float(np.finfo(np.float32).eps)

CHANNELS = [1, 5, CT - 1, CT, CT + 1, 96, 256]
NSIZES = [1, 2, 3, 4, 5, 6, 9]
# small planes, odd and even
PLANES = [(3, 3), (2, 3)]
# nsize above C: every window holds every channel
WIDE = [(1, 2), (1, 9), (5, 6), (5, 9), (CT - 1, CT + 3)]


def _f32(v: float) -> torch.Tensor:
    """v as the f32 scalar the kernel is given (ctypes c_float)."""
    return torch.tensor(np.float32(v))


def _staged(t: torch.Tensor, first: int, rows: int) -> torch.Tensor:
    """Channels [first, first + rows) of t, zero outside [0, C)."""
    c = t.shape[1]
    out = torch.zeros((t.shape[0], rows) + tuple(t.shape[2:]), dtype=t.dtype)
    lo, hi = max(first, 0), min(first + rows, c)
    if hi > lo:
        out[:, lo - first:hi - first] = t[:, lo:hi]
    return out


def _window_sums(terms: torch.Tensor, nsize: int) -> torch.Tensor:
    """s[i] = terms[i] + terms[i + 1] + ... + terms[i + nsize - 1], f32,
    in ascending order, for the CT rows of a tile."""
    s = terms[:, 0:CT].clone()
    for j in range(1, nsize):
        s = s + terms[:, j:j + CT]
    return s


def model_fwd(x, nsize, alpha, beta, knorm):
    """(out, f32 norm) by the forward kernel's partition and order."""
    xf = x.float()
    c = xf.shape[1]
    lo = nsize // 2
    salpha, knorm32 = _f32(alpha / nsize), _f32(knorm)
    out, norm = torch.empty_like(xf), torch.empty_like(xf)
    for c0 in range(0, c, CT):
        own = min(CT, c - c0)
        xs = _staged(xf, c0 - lo, CT + nsize - 1)
        s = _window_sums(xs * xs, nsize)[:, :own]
        n = s * salpha + knorm32
        norm[:, c0:c0 + own] = n
        out[:, c0:c0 + own] = xs[:, lo:lo + own] * n.pow(-beta)
    return out.to(x.dtype), norm


def model_bwd(x, norm, g, nsize, alpha, beta):
    """dx by the backward kernel's partition and order."""
    xf, gf = x.float(), g.float()
    c = xf.shape[1]
    lo = nsize // 2
    coef = _f32(2.0 * (alpha / nsize) * beta)
    nb1 = float(-np.float32(beta) - np.float32(1.0))   # the kernel's f32
    dx = torch.empty_like(xf)
    for c0 in range(0, c, CT):
        own = min(CT, c - c0)
        first, rows = c0 + lo - nsize + 1, CT + nsize - 1
        xs, gs = _staged(xf, first, rows), _staged(gf, first, rows)
        ns = _staged(norm, first, rows)
        inside = _staged(torch.ones_like(norm), first, rows) > 0
        q = ns.pow(nb1)
        t = torch.where(inside, (gs * xs) * q, torch.zeros_like(ns))
        s = _window_sums(t, nsize)[:, :own]
        r = nsize - 1 - lo   # the row of channel c0
        xo, go, no, qo = (a[:, r:r + own] for a in (xs, gs, ns, q))
        dx[:, c0:c0 + own] = go * (qo * no) - (coef * xo) * s
    return dx.to(x.dtype)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(*shape) * 3).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _assert_dx_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=8 * EPS * float(np.abs(want).max()))


_CASES = [(c, n, hw) for c in CHANNELS for n in NSIZES for hw in PLANES] \
    + [(c, n, PLANES[0]) for c, n in WIDE]


@pytest.mark.parametrize("channels, nsize, plane", _CASES, ids=str)
@pytest.mark.parametrize("alpha, knorm", [(0.001, 1.0), (1.0, 0.1)])
def test_tile_model_matches_the_plain_versions(channels, nsize, plane, alpha,
                                               knorm):
    # (alpha 1, knorm 0.1): the window sum is most of the norm, so a wrong
    # halo or window shows far above the bar
    xn, gn = _inputs((2, channels) + plane, seed=channels * 16 + nsize)
    x, g = torch.from_numpy(xn), torch.from_numpy(gn)
    out, norm = model_fwd(x, nsize, alpha, BETA, knorm)
    ref_out, ref_norm = lrn.lrn_ref_with_norm(x, nsize, alpha, BETA, knorm)
    assert torch.equal(norm, ref_norm)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=0)
    dx = model_bwd(x, norm, g, nsize, alpha, BETA)
    _assert_dx_close(dx.numpy(), lrn.lrn_bwd_ref(x, norm, g, nsize, alpha,
                                                 BETA).numpy())


@pytest.mark.parametrize("channels", [5, CT + 1, 96])
@pytest.mark.parametrize("nsize", [2, 5])
def test_tile_model_norm_is_bitwise_for_bf16_inputs(channels, nsize):
    xn, _ = _inputs((2, channels, 3, 3), seed=channels + nsize)
    x = torch.from_numpy(xn).bfloat16()
    out, norm = model_fwd(x, nsize, 1.0, BETA, 0.1)
    ref_out, ref_norm = lrn.lrn_ref_with_norm(x, nsize, 1.0, BETA, 0.1)
    assert torch.equal(norm, ref_norm) and torch.equal(out, ref_out)


@pytest.mark.parametrize("channels, nsize",
                         [(c, n) for c in CHANNELS for n in (1, 2, 5, 9)]
                         + WIDE, ids=str)
def test_tile_model_matches_the_jax_package(channels, nsize):
    xn, gn = _inputs((2, channels, 3, 3), seed=100 + channels + nsize)
    x, g = torch.from_numpy(xn), torch.from_numpy(gn)
    out, norm = model_fwd(x, nsize, 1.0, BETA, 0.1)
    want = pallas_kernels.lrn(xn, nsize, 1.0, BETA, 0.1, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=0)

    def f(xj):
        return jnp.sum(jops.lrn_xla(xj, nsize, 1.0, BETA, 0.1) * gn)
    dx = model_bwd(x, norm, g, nsize, 1.0, BETA)
    _assert_dx_close(dx.numpy(), jax.grad(f)(jnp.asarray(xn)))


def test_the_kernels_share_the_tile_and_the_window_limit():
    # the model's CT is the kernels' kChannelTile, and MAX_NSIZE is the
    # widest window whose staged rows fit a block's shared memory
    csrc = os.path.join(REPO, "cxxnet_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "lrn_tile.cuh")).read()
    tile, threads, smem = (int(re.search(r"constexpr int %s = (\d+);" % k,
                                         src).group(1))
                           for k in ("kChannelTile", "kThreads", "kMaxSmem"))
    for name in ("lrn_fwd.cu", "lrn_bwd.cu"):
        kernel = open(os.path.join(csrc, name)).read()
        assert '#include "lrn_tile.cuh"' in kernel
        assert "constexpr int" not in kernel
    assert tile == CT
    row = threads * 12   # the backward's x, g and norm words
    assert (CT + lrn.MAX_NSIZE - 1) * row <= smem < (CT + lrn.MAX_NSIZE) * row
