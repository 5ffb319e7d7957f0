"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 to relative 1e-5 (the reference's PairTest bar); the bf16
output to 2e-2 (kernel and plain version round the same f32 value to bf16,
and an f32 ulp of difference can move that by one bf16 ulp, 2^-8); the f32
norm always to 1e-5. The backward's dx gets, beside these, an absolute
8 f32 epsilons of its largest magnitude: dx is the difference of two terms
that can cancel, and where an element passes near zero the few ulps by
which the two versions' terms differ (the kernel sums the window in
double, the plain version in f32) are a large relative error.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch.ops import lrn

ARGS = dict(nsize=5, alpha=0.001, beta=0.75, knorm=1.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(4, 96, 27, 27), (4, 256, 13, 13),
                                   (3, 7, 5, 5), (2, 1, 1, 33)])
@pytest.mark.parametrize("nsize", [1, 3, 5])
def test_lrn_kernel_matches_plain(card, shape, dtype, rtol, nsize):
    x = torch.from_numpy(np.random.RandomState(5).randn(*shape)
                         .astype(np.float32) * 3).to(card, dtype)
    args = dict(ARGS, nsize=nsize)
    before = lrn.launches
    out, norm = lrn.lrn_fwd_cuda(x, **args)
    torch.cuda.synchronize()
    assert lrn.launches == before + 1
    assert out.dtype == dtype and norm.dtype == torch.float32
    ref_out, ref_norm = lrn.lrn_ref_with_norm(x, **args)
    torch.testing.assert_close(norm, ref_norm, rtol=1e-5, atol=0)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=rtol,
                               atol=0)


@pytest.mark.cuda
def test_lrn_dispatch_launches_kernel_and_has_no_backward(card):
    # the name is the first slice's, when the backward raised; now the
    # backward launches its kernel, once per backward, on a gradient that
    # autograd may hand over non-contiguous
    x = torch.randn(2, 8, 3, 3, device=card, requires_grad=True)
    before = (lrn.launches, lrn.bwd_launches)
    out = lrn.forward(x, 5, 0.001, 0.75, 1.0)
    assert (lrn.launches, lrn.bwd_launches) == (before[0] + 1, before[1])
    g = torch.randn(2, 8, 3, 3, device=card).transpose(2, 3)
    assert not g.is_contiguous()
    out.backward(g)
    torch.cuda.synchronize()
    assert (lrn.launches, lrn.bwd_launches) == (before[0] + 1, before[1] + 1)
    _, norm = lrn.lrn_ref_with_norm(x.detach(), 5, 0.001, 0.75, 1.0)
    want = lrn.lrn_bwd_ref(x.detach(), norm, g.contiguous(), 5, 0.001, 0.75)
    _assert_dx_close(x.grad, want, 1e-5)


def _assert_dx_close(got, want, rtol):
    atol = 8 * torch.finfo(torch.float32).eps * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(4, 96, 27, 27), (4, 256, 13, 13),
                                   (2, 7, 5, 5), (2, 16, 3, 4),
                                   (2, 1, 1, 33)])
@pytest.mark.parametrize("nsize", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("alpha, knorm", [(0.001, 1.0), (1.0, 0.1)])
def test_lrn_bwd_kernel_matches_plain(card, shape, dtype, rtol, nsize,
                                      alpha, knorm):
    # (alpha 1, knorm 0.1): the window term is a large part of the norm,
    # so a wrong window (the forward's instead of the mirrored one, which
    # differ at even nsize) shows far above the tolerance
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3) \
        .to(card, dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(card, dtype)
    _, norm = lrn.lrn_fwd_cuda(x, nsize, alpha, 0.75, knorm)
    before = lrn.bwd_launches
    dx = lrn.lrn_bwd_cuda(x, norm, g, nsize, alpha, 0.75)
    torch.cuda.synchronize()
    assert lrn.bwd_launches == before + 1
    assert dx.dtype == dtype and dx.shape == x.shape
    _assert_dx_close(dx, lrn.lrn_bwd_ref(x, norm, g, nsize, alpha, 0.75),
                     rtol)


@pytest.mark.cuda
def test_lrn_bwd_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros(1, 4, 2, 2, device=card)
    norm = torch.ones_like(x)
    g = torch.zeros_like(x)
    with pytest.raises(ValueError, match="g contiguous"):
        lrn.lrn_bwd_cuda(x, norm, g.transpose(2, 3), 3, 0.001, 0.75)
    with pytest.raises(ValueError, match="g contiguous"):
        lrn.lrn_bwd_cuda(x, norm, g.bfloat16(), 3, 0.001, 0.75)
    with pytest.raises(ValueError, match="g contiguous"):
        lrn.lrn_bwd_cuda(x, norm, g[:, :2], 3, 0.001, 0.75)
    with pytest.raises(ValueError, match="float32 norm"):
        lrn.lrn_bwd_cuda(x.bfloat16(), norm.bfloat16(), g.bfloat16(), 3,
                         0.001, 0.75)
    with pytest.raises(ValueError, match="float32 norm"):
        lrn.lrn_bwd_cuda(x, norm.cpu(), g, 3, 0.001, 0.75)
    with pytest.raises(TypeError):
        lrn.lrn_bwd_cuda(x.double(), norm, g.double(), 3, 0.001, 0.75)


@pytest.mark.cuda
def test_lrn_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(TypeError):
        lrn.lrn_fwd_cuda(torch.zeros(1, 4, 2, 2, device=card,
                                     dtype=torch.float64), **ARGS)
    with pytest.raises(ValueError, match="contiguous"):
        lrn.lrn_fwd_cuda(torch.zeros(1, 2, 2, 4, device=card)
                         .transpose(1, 3), **ARGS)
    with pytest.raises(ValueError, match="4-D"):
        lrn.lrn_fwd_cuda(torch.zeros(4, 2, 2, device=card), **ARGS)
