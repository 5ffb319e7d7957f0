"""The port's LRN backward against the JAX package's: the plain torch
version (lrn_bwd_ref, what a CPU tensor's backward runs) and the autograd
of the port's LRN on the CPU, against the Pallas backward kernel in
interpret mode (``_lrn_bwd_call``) and against ``jax.grad`` of
``ops.lrn_xla``. The CUDA kernel is held to lrn_bwd_ref on the card by
tests/test_torch_cuda.py and chip_smoke.py.

nsize runs over 1..5: for even nsize the channels whose window holds m
(the mirrored window) are not m's own window, so a backward that reused
the forward window would fail at 2 and 4 only.

Tolerances. fp32: relative 1e-5 (the reference's PairTest bar) plus an
absolute 1e-6 of the tensor's largest |dx|: dx is the difference of two
terms that cancel, so an element can pass near zero where its terms do
not, and there an ulp of the terms (about 1.2e-7 of the largest |dx|)
is a large relative error. bf16: relative 2e-2 (two bf16 ulps, 2^-8
each), with the same absolute slack in bf16's precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu import ops as jops
from cxxnet_tpu.ops import pallas_kernels
from cxxnet_tpu_torch.ops import lrn as tlrn

ALPHA, BETA, KNORM = 0.001, 0.75, 1.0
NSIZES = [1, 2, 3, 4, 5]
SHAPES = [(2, 7, 5, 5), (2, 16, 3, 4)]
FP32_RTOL, FP32_ATOL_REL = 1e-5, 1e-6
BF16_RTOL, BF16_ATOL_REL = 2e-2, 1e-2


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, g


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


def _pallas_bwd(x, g, nsize, alpha, beta, knorm):
    """(dx, norm) from the JAX package's Pallas kernels in interpret
    mode."""
    _, norm = pallas_kernels._lrn_call(x, nsize, alpha / nsize, beta, knorm,
                                       True)
    dx = pallas_kernels._lrn_bwd_call(x, norm, g, nsize, alpha / nsize,
                                      beta, True)
    return dx, np.array(norm).reshape(x.shape)


@pytest.mark.parametrize("nsize", NSIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_lrn_bwd_ref_matches_pallas_interpret_fp32(nsize, shape):
    # alpha 1, knorm 0.1: the window term is a large part of the norm, so
    # a wrong (unmirrored) window shows well above the tolerance
    x, g = _inputs(shape, seed=nsize)
    want, norm = _pallas_bwd(x, g, nsize, 1.0, BETA, 0.1)
    got = tlrn.lrn_bwd_ref(torch.from_numpy(x), torch.from_numpy(norm),
                           torch.from_numpy(g), nsize, 1.0, BETA)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, FP32_RTOL, FP32_ATOL_REL)


@pytest.mark.parametrize("nsize", NSIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_port_autograd_matches_jax_grad_of_lrn_xla(nsize, shape):
    x, g = _inputs(shape, seed=10 + nsize)

    def f(xj):
        return jnp.sum(jops.lrn_xla(xj, nsize, 1.0, BETA, 0.1) * g)
    want = jax.grad(f)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tlrn.forward(xt, nsize, 1.0, BETA, 0.1)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    _close(got.numpy(), want, FP32_RTOL, FP32_ATOL_REL)


@pytest.mark.parametrize("nsize", NSIZES)
def test_port_autograd_matches_pallas_at_alexnet_constants(nsize):
    x, g = _inputs((2, 16, 3, 4), seed=20 + nsize)
    want, _ = _pallas_bwd(x, g, nsize, ALPHA, BETA, KNORM)
    xt = torch.from_numpy(x).requires_grad_()
    out = tlrn.forward(xt, nsize, ALPHA, BETA, KNORM)
    out.backward(torch.from_numpy(g))
    _close(xt.grad.numpy(), want, FP32_RTOL, FP32_ATOL_REL)


def test_even_window_is_mirrored():
    # the mirrored window of channel m is [m + lo - nsize + 1, m + lo]:
    # with nsize 2 (lo 1) channel m collects from m and m + 1, while its
    # forward window is [m - 1, m]
    x = np.ones((1, 4, 1, 1), np.float32)
    norm = np.ones((1, 4, 1, 1), np.float32)
    g = np.array([1, 2, 4, 8], np.float32).reshape(1, 4, 1, 1)
    dx = tlrn.lrn_bwd_ref(torch.from_numpy(x), torch.from_numpy(norm),
                          torch.from_numpy(g), 2, 2.0, 1.0)
    # dx_m = g_m - 2 * (2/2) * 1 * sum over the mirrored window of g
    np.testing.assert_allclose(dx.numpy().ravel(),
                               [1 - 2 * 3, 2 - 2 * 6, 4 - 2 * 12, 8 - 2 * 8])
    want = pallas_kernels._lrn_bwd_call(x, norm.reshape(1, 4, 1), g, 2, 1.0,
                                        1.0, True)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want))


@pytest.mark.parametrize("nsize", NSIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_lrn_bwd_ref_bf16(nsize, shape):
    x, g = _inputs(shape, seed=30 + nsize)
    xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    want, norm = _pallas_bwd(xb, gb, nsize, ALPHA, BETA, KNORM)
    xt = torch.from_numpy(x).bfloat16()
    gt = torch.from_numpy(g).bfloat16()
    got = tlrn.lrn_bwd_ref(xt, torch.from_numpy(norm), gt, nsize, ALPHA,
                           BETA)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), BF16_RTOL,
           BF16_ATOL_REL)


def test_cpu_autograd_saves_norm_and_never_launches():
    x, g = _inputs((2, 7, 3, 3), seed=40)
    xt = torch.from_numpy(x).requires_grad_()
    before = (tlrn.launches, tlrn.bwd_launches)
    out = tlrn.forward(xt, 5, ALPHA, BETA, KNORM)
    assert out.grad_fn is not None and "LRNFunction" in type(
        out.grad_fn).__name__
    # a non-contiguous upstream gradient is made contiguous first
    gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 1, 3, 2))) \
        .transpose(2, 3)
    assert not gt.is_contiguous()
    out.backward(gt)
    want = tlrn.lrn_bwd_ref(xt.detach(),
                            tlrn.lrn_ref_with_norm(xt.detach(), 5, ALPHA,
                                                   BETA, KNORM)[1],
                            torch.from_numpy(g), 5, ALPHA, BETA)
    torch.testing.assert_close(xt.grad, want, rtol=0, atol=0)
    assert (tlrn.launches, tlrn.bwd_launches) == before


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(1, 4, 2, 2),
    lambda: torch.zeros(1, 4, 2, 2, device="meta"),
])
def test_bwd_kernel_wrapper_refuses_non_cuda(make):
    x = make()
    with pytest.raises(ValueError, match="CUDA"):
        tlrn.lrn_bwd_cuda(x, torch.ones_like(x), torch.zeros_like(x), 3,
                          ALPHA, BETA)
