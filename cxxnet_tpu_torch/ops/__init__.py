"""Op library of the port: the counterpart of cxxnet_tpu/ops/__init__.py.

conv2d          <- unpack_patch2col + dot + swapaxis   (src/layer/convolution_layer-inl.hpp:79-105)
pool2d          <- pool<Reducer>, max / sum / avg      (src/layer/pooling_layer-inl.hpp)
chpool_sum/lrn  <- chpool<red::sum>                    (src/layer/lrn_layer-inl.hpp:55-60)
softmax         <- mshadow::Softmax                    (src/layer/loss/softmax_layer-inl.hpp)
xelu / mxelu    <- op::xelu, op::mxelu                 (src/layer/op.h:56-60, src/layer/prelu_layer-inl.hpp:10-14)
softplus        <- jax.nn.softplus (the reference parses softplus but has no op for it)

Convolution and pooling were left to XLA by the JAX package and go to
PyTorch's own ops here; the convolution's weight gradient is an im2col
product of our own (``conv2d_weight``), because cuDNN's fp32 one misses
the reference's 1e-5 bar on AlexNet's conv2. LRN and flash attention were
Pallas kernels on the TPU and are hand-written CUDA kernels here
(ops/lrn.py, ops/flash_attn.py); so is the uniform draw of the noisy
activations (the TPU's on-core PRNG, here Philox, ops/random.py). Shapes
follow the reference exactly (ceil-mode pooling with clamp), and
activations stay NCHW.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import flash_attn  # noqa: F401  (flash attention: kernel or plain)
from . import lrn  # noqa: F401  (ops.lrn.forward: kernel or plain LRN)
from . import random  # noqa: F401  (ops.random.uniform: kernel or plain)
from . import library  # noqa: F401  (the cxxnet:: ops the above call)
from .lrn import chpool_sum, lrn_ref  # noqa: F401


def conv_out_dim(x: int, k: int, s: int, p: int) -> int:
    """Conv output size, reference: src/layer/convolution_layer-inl.hpp:180-183."""
    return (x + 2 * p - k) // s + 1


def pool_out_dim(x: int, k: int, s: int) -> int:
    """Pooling output size (ceil-mode with clamp),
    reference: src/layer/pooling_layer-inl.hpp:104-106."""
    return min(x - k + s - 1, x - 1) // s + 1


# the largest unfolded input conv2d_weight holds at once (bytes)
UNFOLD_BYTES = 1 << 30
# about how many products conv2d_weight sums in one matrix-product row
# before it adds partial sums: a few thousand keeps fp32 within ~1e-6 of
# the largest element, where one sum over batch x positions would not
SUM_TERMS = 4096


def conv2d_weight(x: torch.Tensor, w_shape: Tuple[int, ...],
                  g: torch.Tensor, stride: int, pad: Tuple[int, int],
                  groups: int) -> torch.Tensor:
    """The weight gradient of a grouped convolution, dw[o, k] = sum over
    images n and output positions p of g[n, o, p] cols[n, p, k], with
    cols the im2col of x: the windows are a strided view of the padded
    input, copied once per batch chunk (the chunk's unfolded input, every
    group's, stays under UNFOLD_BYTES), and the sum is matrix products
    batched over (group, group of s images), s P ~ SUM_TERMS products per
    row, whose partial sums are then added in a float32 accumulator,
    rounded once to the input's dtype at the end (full fp32 on the card,
    where TF32 is off). One batched product covers every group, so the
    number of products does not grow with ``groups``: a depthwise
    convolution (groups = C) takes as many as a dense one. In bf16 each
    group's matrix product is summed in f32 and rounded to bf16 once, and
    the groups of images are added in float32 without a float32 copy of
    the product, where a bf16 accumulator would round at every add: dw
    takes one rounding per group of s images and one at the end, where
    XLA's conv backward sums in f32 and rounds once.
    cuDNN's fp32 weight gradient of AlexNet's conv2 (5x5, pad 2, two
    groups) is 6e-3 to 9e-3 of its largest element off float64; this one
    reaches the reference's 1e-5."""
    n = x.shape[0]
    o, cg, kh, kw = w_shape
    og = o // groups
    oh, ow = g.shape[2], g.shape[3]
    p_out = oh * ow
    k_len = cg * kh * kw
    s = max(1, min(n, SUM_TERMS // p_out))
    per_image = groups * k_len * p_out * x.element_size()
    chunk = max(1, UNFOLD_BYTES // max(per_image, 1)) // s * s or s
    win = F.pad(x, (pad[1], pad[1], pad[0], pad[0])) \
        .unfold(2, kh, stride).unfold(3, kw, stride)  # (n, c, oh, ow, kh, kw)
    win = win.reshape(n, groups, cg, oh, ow, kh, kw)
    # (groups, n, og, P): each group's output gradient, images in order
    gg = g.reshape(n, groups, og, p_out).transpose(0, 1)
    dw = torch.zeros((groups, og, k_len), dtype=torch.float32,
                     device=x.device)
    for n0 in range(0, n, chunk):
        xs = win[n0:n0 + chunk]
        b = xs.shape[0]
        # (groups, b, P, k_len), one copy of the chunk's windows
        cols = xs.permute(1, 0, 3, 4, 2, 5, 6).reshape(groups, b, p_out,
                                                       k_len)
        gs = gg[:, n0:n0 + b]
        for b0 in range(0, b, b // s * s or b):
            m = s if b - b0 >= s else b - b0
            nb = (b - b0) // m
            gm = gs[:, b0:b0 + nb * m].reshape(groups, nb, m, og, p_out) \
                .transpose(2, 3).reshape(groups * nb, og, m * p_out)
            cm = cols[:, b0:b0 + nb * m].reshape(groups * nb, m * p_out,
                                                 k_len)
            dw += torch.bmm(gm, cm).reshape(groups, nb, og, k_len) \
                .sum(1, dtype=torch.float32)
    return dw.reshape(w_shape).to(x.dtype)


class Conv2dFunction(torch.autograd.Function):
    """Convolution whose forward and data gradient are F.conv2d's (cuDNN
    on the card) and whose weight gradient is conv2d_weight."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, groups):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, pad, groups)
        return F.conv2d(x, w, stride=stride, padding=pad, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad, groups = ctx.args
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w, g, stride=stride,
                                            padding=pad, groups=groups)
        if ctx.needs_input_grad[1]:
            dw = conv2d_weight(x, w.shape, g, stride, pad, groups)
        return dx, dw, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           pad: Tuple[int, int] = (0, 0), groups: int = 1) -> torch.Tensor:
    """2-D convolution of an (N, C, H, W) input with (O, C/groups, KH, KW)
    OIHW weights, the reference's storage layout; differentiable, with
    the weight gradient of conv2d_weight."""
    return Conv2dFunction.apply(x, w, stride, tuple(pad), groups)


def _pool_padding(h: int, w: int, k: Tuple[int, int], s: int):
    """Output size and the extra bottom/right padding that ceil-mode
    pooling needs (the JAX package's _pool_padding)."""
    oh, ow = pool_out_dim(h, k[0], s), pool_out_dim(w, k[1], s)
    ph = max((oh - 1) * s + k[0] - h, 0)
    pw = max((ow - 1) * s + k[1] - w, 0)
    return (oh, ow), (ph, pw)


def pool2d(x: torch.Tensor, mode: str, kernel: Tuple[int, int], stride: int,
           pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Pooling with the reference's ceil-mode output shape; mode 'max',
    'sum' or 'avg'. ``pad`` adds symmetric input padding first, and the
    ceil-mode windows that run past the input take the extra bottom/right
    padding: -inf for max, so padding never wins, and zeros for sum and
    avg. avg is the window's sum times 1/(kh kw) whatever the padding, as
    the reference (src/layer/pooling_layer-inl.hpp:44-46) and the JAX
    package (cxxnet_tpu/ops/__init__.py:189-192) compute it; F.avg_pool2d
    with ceil_mode would leave the ceil-mode extra out of its divisor."""
    if mode not in ("max", "sum", "avg"):
        raise ValueError("unknown pooling mode %s" % mode)
    _, _, h, w = x.shape
    py, px = pad
    _, (ph, pw) = _pool_padding(h + 2 * py, w + 2 * px, kernel, stride)
    if py or px or ph or pw:
        x = F.pad(x, (px, px + pw, py, py + ph),
                  value=float("-inf") if mode == "max" else 0.0)
    if mode == "max":
        return F.max_pool2d(x, kernel, stride)
    # the window sum (a divisor of 1), rounded once to x's dtype
    out = F.avg_pool2d(x, kernel, stride, divisor_override=1)
    if mode == "avg":
        out = out * (1.0 / (kernel[0] * kernel[1]))
    return out


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


def xelu(x: torch.Tensor, b) -> torch.Tensor:
    """Leaky relu with *divisor* b, a number or a tensor of x's shape
    (reference op::xelu, src/layer/op.h:56-60)."""
    return torch.where(x > 0, x, x / b)


def mxelu(x: torch.Tensor, m) -> torch.Tensor:
    """Leaky relu with *multiplier* m (reference op::mxelu,
    src/layer/prelu_layer-inl.hpp:10-14)."""
    return torch.where(x > 0, x, x * m)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the JAX package computes it: jax.nn.softplus is
    jnp.logaddexp(x, 0), max(x, 0) + log1p(exp(-|x|)) with the gradient
    exp(x - out), and so is torch.logaddexp. Not F.softplus, which returns
    x itself above its threshold (tests/test_torch_layers_more.py)."""
    return torch.logaddexp(x, x.new_zeros(()))
