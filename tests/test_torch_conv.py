"""The port's convolution as an autograd op, on the CPU: ``ops.conv2d``'s
data and weight gradients (the weight gradient by im2col and batched
matrix products, ``ops.conv2d_weight``) against the autograd of
``F.conv2d`` at AlexNet's grouped, padded and strided shapes, at a small
batch, and against float64.

Tolerance: relative 1e-5 (the reference's PairTest bar) plus an absolute
1e-5 of the gradient's largest element: the two sum the same products in
other orders, and an element that nearly cancels carries a few float32
ulps of the largest summands.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cxxnet_tpu_torch import ops

RTOL, ATOL_REL = 1e-5, 1e-5

# (input (N, C, H, W), weight (O, C/g, KH, KW), stride, pad, groups):
# ImageNet.conf's five convolutions at batch 2, then two odd shapes
SHAPES = {
    "conv1": ((2, 3, 227, 227), (96, 3, 11, 11), 4, (0, 0), 1),
    "conv2": ((2, 96, 27, 27), (256, 48, 5, 5), 1, (2, 2), 2),
    "conv3": ((2, 256, 13, 13), (384, 256, 3, 3), 1, (1, 1), 1),
    "conv4": ((2, 384, 13, 13), (384, 192, 3, 3), 1, (1, 1), 2),
    "conv5": ((2, 384, 13, 13), (256, 192, 3, 3), 1, (1, 1), 2),
    "odd_pad_stride": ((3, 4, 13, 11), (6, 2, 3, 5), 2, (1, 0), 2),
    "one_by_one": ((2, 64, 1, 40), (96, 64, 1, 1), 1, (0, 0), 1),
}


def _close(got, want):
    want = want.double()
    torch.testing.assert_close(
        got.double(), want, rtol=RTOL,
        atol=ATOL_REL * float(want.abs().max()))


def _case(name):
    xs, ws, stride, pad, groups = SHAPES[name]
    rng = np.random.RandomState(sum(xs) + sum(ws))
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32))
    w = torch.from_numpy(rng.randn(*ws).astype(np.float32) * 0.1)
    return x, w, dict(stride=stride, pad=pad, groups=groups)


def _grads(fn, x, w, g):
    x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = fn(x, w)
    out.backward(g)
    return out.detach(), x.grad, w.grad


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_conv2d_gradients_match_f_conv2d(name):
    x, w, kw = _case(name)
    pad = kw["pad"]

    def ref(x_, w_):
        return F.conv2d(x_, w_, stride=kw["stride"], padding=pad,
                        groups=kw["groups"])

    def port(x_, w_):
        return ops.conv2d(x_, w_, **kw)

    g = torch.from_numpy(np.random.RandomState(3).randn(
        *ref(x, w).shape).astype(np.float32))
    out, dx, dw = _grads(port, x, w, g)
    rout, rdx, rdw = _grads(ref, x, w, g)
    assert torch.equal(out, rout)
    _close(dx, rdx)
    _close(dw, rdw)
    # both against float64
    _, dx64, dw64 = _grads(ref, x.double(), w.double(), g.double())
    _close(dw, dw64)
    _close(dx, dx64)


@pytest.mark.parametrize("images_per_chunk, sum_terms", [
    (2, 4096), (7, 729 * 2), (4, 1), (3, 729 * 4)])
def test_weight_gradient_in_batch_chunks(monkeypatch, images_per_chunk,
                                         sum_terms):
    # chunks of the unfolded input and groups of images per product, with
    # ragged last chunks and groups, give the same gradient
    x, w, kw = _case("conv2")
    x = torch.cat([x, x * 0.5, -x, x * 2])[:7]
    g = torch.randn(7, 256, 27, 27,
                    generator=torch.Generator().manual_seed(4))
    args = (w.shape, g, kw["stride"], kw["pad"], kw["groups"])
    whole = torch.nn.grad.conv2d_weight(
        x.double(), w.shape, g.double(), stride=kw["stride"],
        padding=kw["pad"], groups=kw["groups"])
    per_image = 48 * 25 * 27 * 27 * 4
    monkeypatch.setattr(ops, "UNFOLD_BYTES", images_per_chunk * per_image)
    monkeypatch.setattr(ops, "SUM_TERMS", sum_terms)
    _close(ops.conv2d_weight(x, *args), whole)


def test_conv2d_without_weight_gradient():
    x, w, kw = _case("odd_pad_stride")
    xl = x.clone().requires_grad_()
    ops.conv2d(xl, w, **kw).sum().backward()
    assert xl.grad is not None and xl.grad.shape == x.shape
