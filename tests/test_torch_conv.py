"""The port's convolution as an autograd op, on the CPU: ``ops.conv2d``'s
data and weight gradients (the weight gradient by im2col and batched
matrix products, ``ops.conv2d_weight``) against the autograd of
``F.conv2d`` at AlexNet's grouped, padded and strided shapes, MobileNet's
depthwise and ViT-S/16's patch embedding, at a small batch, and against
float64; the weight gradient's number of matrix products, which does not
grow with the number of groups.

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
    # MobileNet's depthwise 3x3 (ngroup = C) at stride 1 and 2, and
    # ViT-S/16's patch embedding (16x16, stride 16)
    "depthwise_s1": ((4, 32, 28, 28), (32, 1, 3, 3), 1, (1, 1), 32),
    "depthwise_s2": ((4, 64, 28, 28), (64, 1, 3, 3), 2, (1, 1), 64),
    "vit_patch_embed": ((2, 3, 224, 224), (384, 3, 16, 16), 16, (0, 0), 1),
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
    per_image = 96 * 25 * 27 * 27 * 4
    monkeypatch.setattr(ops, "UNFOLD_BYTES", images_per_chunk * per_image)
    monkeypatch.setattr(ops, "SUM_TERMS", sum_terms)
    _close(ops.conv2d_weight(x, *args), whole)


def test_conv2d_without_weight_gradient():
    x, w, kw = _case("odd_pad_stride")
    xl = x.clone().requires_grad_()
    ops.conv2d(xl, w, **kw).sum().backward()
    assert xl.grad is not None and xl.grad.shape == x.shape


@pytest.mark.parametrize("name", ["conv2", "depthwise_s1", "depthwise_s2",
                                  "vit_patch_embed"])
def test_weight_gradient_within_1e5_of_float64(name):
    """fp32 dw within 1e-5 of the largest element of the float64 one."""
    x, w, kw = _case(name)
    out = F.conv2d(x, w, stride=kw["stride"], padding=kw["pad"],
                   groups=kw["groups"])
    g = torch.from_numpy(np.random.RandomState(5).randn(
        *out.shape).astype(np.float32))
    dw = ops.conv2d_weight(x, w.shape, g, kw["stride"], kw["pad"],
                           kw["groups"])
    want = torch.nn.grad.conv2d_weight(
        x.double(), w.shape, g.double(), stride=kw["stride"],
        padding=kw["pad"], groups=kw["groups"])
    assert dw.dtype == torch.float32
    err = float((dw.double() - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err


@pytest.mark.parametrize("stride", [1, 2])
def test_weight_gradient_products_do_not_grow_with_groups(monkeypatch,
                                                          stride):
    """A depthwise 3x3 (groups = C) runs as many batched products as the
    dense 3x3 on the same input, in whole batches and in chunks."""
    calls = []
    bmm = torch.bmm

    def counted(a, b):
        calls.append(a.shape[0])
        return bmm(a, b)
    monkeypatch.setattr(torch, "bmm", counted)
    x = torch.randn(6, 16, 12, 12, generator=torch.Generator().manual_seed(6))
    n_calls = {}
    for chunked in (False, True):
        if chunked:
            # two images a chunk, three images a product: ragged groups
            monkeypatch.setattr(ops, "UNFOLD_BYTES", 2 * 16 * 9 * 144 * 4)
            monkeypatch.setattr(ops, "SUM_TERMS", 3 * 144)
        for groups in (1, 4, 16):
            w_shape = (16, 16 // groups, 3, 3)
            oh = (12 + 2 - 3) // stride + 1
            g = torch.randn(6, 16, oh, oh)
            calls.clear()
            ops.conv2d_weight(x, w_shape, g, stride, (1, 1), groups)
            n_calls[(chunked, groups)] = len(calls)
    for chunked in (False, True):
        assert len({n_calls[(chunked, gr)] for gr in (1, 4, 16)}) == 1, \
            n_calls
