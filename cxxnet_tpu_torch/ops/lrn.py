"""Cross-channel LRN, forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions, and the dispatch between them.

Replaces the TPU kernels ``_lrn_fwd_kernel`` / ``_lrn_call`` and
``_lrn_bwd_kernel`` / ``_lrn_bwd_call``
(cxxnet_tpu/ops/pallas_kernels.py:49-104). The kernels are
``csrc/lrn_fwd.cu`` and ``csrc/lrn_bwd.cu``, built with nvcc at first use and
bound with ctypes; their source comments state the design (channel tiles of
``CHANNEL_TILE`` staged with their halo in shared memory, each window summed
directly in ascending channel order) and the bound (bytes moved / 3.35
TB/s).

``forward`` on a CUDA tensor that needs no gradient (``torch.no_grad()``,
or x not requiring one) launches the forward kernel without the norm and
builds no graph; otherwise it goes through ``LRNFunction``, whose forward
saves the f32 norm and whose backward takes it: the kernels for a tensor on
a CUDA card, the plain versions for a tensor on the CPU. A failed build or
launch raises: nothing falls back to a plain version for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# launches of the CUDA kernels, counted in lrn_fwd_cuda / lrn_bwd_cuda
# where each launches; no_norm_launches counts the forward's launches that
# store no norm (inference), which launches counts as well
launches = 0
no_norm_launches = 0
bwd_launches = 0

# channels a block of either kernel owns (kChannelTile in
# csrc/lrn_tile.cuh); the kernels sum each window over this partition
CHANNEL_TILE = 16
# the widest window the kernels take: the backward stages
# (CHANNEL_TILE + nsize - 1) rows of 128 positions at 12 bytes each, within
# the 227 KB (232,448 bytes) of shared memory a block may use
MAX_NSIZE = 232448 // (128 * 12) - CHANNEL_TILE + 1

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _window_sum(x: torch.Tensor, nsize: int, before: int) -> torch.Tensor:
    """Sum over dim 1 of the nsize channels [i - before, i - before +
    nsize) around each channel i, clipped to the valid range."""
    c = x.shape[1]
    xp = F.pad(x, (0, 0, 0, 0, before, nsize - 1 - before))
    out = xp[:, 0:c]
    for j in range(1, nsize):
        out = out + xp[:, j:j + c]
    return out


def chpool_sum(x: torch.Tensor, nsize: int) -> torch.Tensor:
    """Cross-channel sliding-window sum over dim 1 (mshadow chpool<red::sum>):
    channel i sums channels win(i) = [i - nsize//2, i - nsize//2 + nsize)
    clipped to the valid range."""
    return _window_sum(x, nsize, nsize // 2)


def lrn_ref_with_norm(x: torch.Tensor, nsize: int, alpha: float, beta: float,
                      knorm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain LRN forward in f32 whatever the input dtype, as the kernel
    computes it: returns (out in x's dtype, f32 norm)."""
    xf = x.float()
    norm = chpool_sum(xf * xf, nsize) * (alpha / nsize) + knorm
    return (xf * norm.pow(-beta)).to(x.dtype), norm


def lrn_ref(x: torch.Tensor, nsize: int, alpha: float, beta: float,
            knorm: float) -> torch.Tensor:
    """Plain LRN (the counterpart of cxxnet_tpu.ops.lrn_xla,
    reference src/layer/lrn_layer-inl.hpp:52-60)."""
    return lrn_ref_with_norm(x, nsize, alpha, beta, knorm)[0]


def lrn_bwd_ref(x: torch.Tensor, norm: torch.Tensor, g: torch.Tensor,
                nsize: int, alpha: float, beta: float) -> torch.Tensor:
    """Plain LRN backward, the formula of ``_lrn_bwd_kernel``: for the f32
    ``norm`` the forward saved and the upstream gradient g,

        dx_m = g_m n_m^-b - 2 (alpha/nsize) b x_m sum_{i: m in win(i)}
               g_i x_i n_i^(-b-1)

    in f32 whatever the input dtype, cast to x's dtype. The channels i
    whose window holds m are [m + lo - nsize + 1, m + lo] (lo = nsize//2):
    the mirrored window, which differs from win(m) for even nsize."""
    xf, gf = x.float(), g.float()
    salpha = alpha / nsize
    inner = gf * xf * norm.pow(-beta - 1.0)
    s = _window_sum(inner, nsize, nsize - 1 - nsize // 2)
    return (gf * norm.pow(-beta) - (2.0 * salpha * beta) * xf * s).to(x.dtype)


_ARGTYPES = {
    "lrn_fwd": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    "lrn_bwd": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
}


def check_kernel_input(x: torch.Tensor, nsize: int,
                       kernel: str = "lrn_fwd") -> None:
    """What the kernels take: a contiguous 4-D (B, C, H, W) float32 or
    bfloat16 tensor on a CUDA device, and 1 <= nsize <= MAX_NSIZE."""
    if x.device.type != "cuda":
        raise ValueError("%s kernel needs a CUDA tensor, got one on %s"
                         % (kernel, x.device))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("%s kernel takes float32 or bfloat16, got %s"
                        % (kernel, x.dtype))
    if x.dim() != 4:
        raise ValueError("%s kernel needs a 4-D NCHW tensor, got shape %s"
                         % (kernel, tuple(x.shape)))
    if not x.is_contiguous():
        raise ValueError("%s kernel needs a contiguous NCHW tensor" % kernel)
    if nsize < 1:
        raise ValueError("lrn local_size must be >= 1, got %d" % nsize)
    if nsize > MAX_NSIZE:
        raise ValueError("%s kernel takes local_size <= %d, got %d"
                         % (kernel, MAX_NSIZE, nsize))


def lrn_fwd_cuda(x: torch.Tensor, nsize: int, alpha: float, beta: float,
                 knorm: float, with_norm: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel on the current stream: returns (out in x's
    dtype, f32 norm), or (out, None) with ``with_norm=False``, which
    allocates and stores no norm. Raises on an input it does not take or a
    failed launch."""
    global launches, no_norm_launches
    check_kernel_input(x, nsize)
    out = torch.empty_like(x)
    norm = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if with_norm else None
    if x.numel() == 0:
        return out, norm
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        _build.launch("lrn_fwd", _ARGTYPES["lrn_fwd"], x.data_ptr(),
                      out.data_ptr(), norm.data_ptr() if with_norm else None,
                      _DTYPE_CODE[x.dtype], b, c, h * w, nsize,
                      alpha / nsize, beta, knorm,
                      torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    if not with_norm:
        no_norm_launches += 1
    return out, norm


def lrn_bwd_cuda(x: torch.Tensor, norm: torch.Tensor, g: torch.Tensor,
                 nsize: int, alpha: float, beta: float) -> torch.Tensor:
    """Launch the LRN backward kernel on the current stream: dx in x's
    dtype from x, the forward's f32 norm and the upstream gradient g (same
    shape and dtype as x, contiguous). Raises on an input it does not take
    or a failed launch."""
    global bwd_launches
    check_kernel_input(x, nsize, "lrn_bwd")
    if g.device != x.device or g.dtype != x.dtype or g.shape != x.shape \
            or not g.is_contiguous():
        raise ValueError("lrn_bwd kernel needs g contiguous, on x's device, "
                         "of x's dtype and shape; got %s %s %s on %s"
                         % (g.dtype, tuple(g.shape),
                            "contiguous" if g.is_contiguous()
                            else "non-contiguous", g.device))
    if norm.device != x.device or norm.dtype != torch.float32 \
            or norm.shape != x.shape or not norm.is_contiguous():
        raise ValueError("lrn_bwd kernel needs a contiguous float32 norm of "
                         "x's shape on x's device")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        _build.launch("lrn_bwd", _ARGTYPES["lrn_bwd"], x.data_ptr(),
                      norm.data_ptr(), g.data_ptr(), dx.data_ptr(),
                      _DTYPE_CODE[x.dtype], b, c, h * w, nsize,
                      2.0 * (alpha / nsize) * beta, beta,
                      torch.cuda.current_stream(x.device).cuda_stream)
    bwd_launches += 1
    return dx


class LRNFunction(torch.autograd.Function):
    """LRN as an autograd op: the forward saves x and the f32 norm, the
    backward takes them with the upstream gradient. On a CUDA tensor both
    directions run the kernels; on a CPU tensor the plain versions."""

    @staticmethod
    def forward(ctx, x, nsize, alpha, beta, knorm):
        if x.device.type == "cuda":
            out, norm = lrn_fwd_cuda(x, nsize, alpha, beta, knorm)
        else:
            out, norm = lrn_ref_with_norm(x, nsize, alpha, beta, knorm)
        ctx.save_for_backward(x, norm)
        ctx.args = (nsize, alpha, beta)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, norm = ctx.saved_tensors
        g = grad_out.contiguous()
        if x.device.type == "cuda":
            dx = lrn_bwd_cuda(x, norm, g, *ctx.args)
        else:
            dx = lrn_bwd_ref(x, norm, g, *ctx.args)
        return dx, None, None, None, None


def forward(x: torch.Tensor, nsize: int, alpha: float, beta: float,
            knorm: float) -> torch.Tensor:
    """LRN over the channels of an NCHW tensor, differentiable: the CUDA
    kernels for a CUDA tensor (the forward without its norm, and no graph,
    where no gradient is needed), the plain versions for a CPU tensor."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError("lrn forward: no implementation for a tensor on %s"
                         % x.device)
    if x.device.type == "cuda" and not (torch.is_grad_enabled()
                                        and x.requires_grad):
        return lrn_fwd_cuda(x, nsize, alpha, beta, knorm, with_norm=False)[0]
    return LRNFunction.apply(x, nsize, alpha, beta, knorm)
