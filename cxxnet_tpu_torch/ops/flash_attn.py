"""Flash attention forward: the hand-written CUDA kernel, its plain PyTorch
version, and the dispatch between them.

Replaces the TPU kernel ``_fwd_kernel`` / ``_flash_fwd``
(cxxnet_tpu/ops/flash_attn.py:82-120, launched at :284) and the gate
``supports`` (:213-216). The kernel is ``csrc/flash_fwd.cu``, built with
nvcc at first use and bound with ctypes; its source comment states the
design and the bound.

``flash_attention`` goes through ``FlashAttention``: for a CUDA tensor the
forward launches the kernel, and the backward raises (the backward kernels,
rows 5-6 of the kernel table, belong to the LM training slice); for a CPU
tensor the forward is ``flash_fwd_ref`` and the backward differentiates it.
Nothing falls back to the plain version for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

# launches of the CUDA kernel, counted in flash_fwd_cuda where it launches
launches = 0

# finite stand-in for -inf: exp(NEG_INF - m) is 0 and never NaN (the TPU
# kernel's rule, cxxnet_tpu/ops/flash_attn.py:46)
NEG_INF = -1e30
# head dims the kernel is compiled for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_float, ctypes.c_void_p]


def supports(L: int, d: int) -> bool:
    """Shapes the attention layer sends to the flash path: L >= 128 and a
    head dim that is a multiple of 8 (the JAX package's rule without its
    TPU clause)."""
    return L >= 128 and d % 8 == 0


def _check_shapes(q, k, v, causal: bool, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (b, h, L, d) tensors, got "
                         "q %s k %s v %s" % (tuple(q.shape), tuple(k.shape),
                                             tuple(v.shape)))
    b, h, L, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (L, d):
        raise ValueError("flash attention: k and v must be (b, nkv, L, d) "
                         "of q's b, L and d; got q %s k %s v %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if k.shape[1] < 1 or h % k.shape[1] != 0:
        raise ValueError("flash attention: query heads %d must be a "
                         "multiple of kv heads %d" % (h, k.shape[1]))
    if window < 0 or (window > 0 and not causal):
        raise ValueError("flash attention: window %d needs causal and must "
                         "be >= 0" % window)


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, scale: Optional[float] = None,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: (out in q's dtype, f32 lse of shape
    (b, h, L)) with out = softmax(scale q k^T + mask) v and lse the per-row
    logsumexp of the masked scores. Computed densely in f32 whatever the
    input dtype, grouped k/v read per query-head group without a broadcast
    copy; masked scores are NEG_INF as in the kernel. Differentiable."""
    _check_shapes(q, k, v, causal, window)
    b, h, L, d = q.shape
    nkv = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, nkv, h // nkv, L, d)
    s = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) * scale
    if causal:
        pos = torch.arange(L, device=q.device)
        diff = pos[:, None] - pos[None, :]
        keep = diff >= 0
        if window > 0:
            keep = keep & (diff < window)
        s = s.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bngqk,bnkd->bngqd", p, v.float())
    return (out.reshape(b, h, L, d).to(q.dtype), lse.reshape(b, h, L))


def check_kernel_input(q, k, v, causal: bool, window: int) -> None:
    """What the kernel takes: q (b, h, L, d) and k/v (b, nkv, L, d),
    contiguous, float32 or bfloat16 alike, on one CUDA device, with
    nkv | h, d one of KERNEL_HEAD_DIMS and window only with causal."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError("flash_fwd kernel needs CUDA tensors, got %s on "
                             "%s" % (name, t.device))
        if t.dtype not in _DTYPE_CODE or t.dtype != q.dtype:
            raise TypeError("flash_fwd kernel takes float32 or bfloat16 "
                            "q, k, v of one dtype, got %s %s %s"
                            % (q.dtype, k.dtype, v.dtype))
        if not t.is_contiguous():
            raise ValueError("flash_fwd kernel needs a contiguous %s" % name)
        if t.device != q.device:
            raise ValueError("flash_fwd kernel needs q, k, v on one device")
    _check_shapes(q, k, v, causal, window)
    d = q.shape[3]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError("flash_fwd kernel is compiled for head dims %s, not "
                         "%d" % (KERNEL_HEAD_DIMS, d))


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream: (out in q's dtype, f32
    lse (b, h, L)). Raises on an input it does not take or a failed
    launch."""
    global launches
    check_kernel_input(q, k, v, causal, window)
    b, h, L, d = q.shape
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        _build.launch("flash_fwd", _ARGTYPES, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      _DTYPE_CODE[q.dtype], b, h, k.shape[1], L, d,
                      int(bool(causal)), window, float(scale),
                      torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Flash attention as an autograd op. A CUDA tensor runs the kernel,
    whose backward is not ported yet; a CPU tensor runs flash_fwd_ref, and
    its backward differentiates the plain version again from the saved
    inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        if q.device.type == "cuda":
            out, _ = flash_fwd_cuda(q, k, v, causal, scale, window)
        else:
            out, _ = flash_fwd_ref(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        if q.device.type == "cuda":
            raise NotImplementedError(
                "the flash attention backward kernels (_dq_kernel, "
                "_dkv_kernel: kernel table rows 5-6) are not ported yet; "
                "they come with the LM training slice")
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out, _ = flash_fwd_ref(*leaves, *ctx.args)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad_out)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Memory-O(L) attention (the JAX package's ops.flash_attention): q
    (b, h, L, d), k/v (b, nkv, L, d) with nkv | h; the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError("flash attention: no implementation for a tensor "
                         "on %s" % q.device)
    return FlashAttention.apply(q, k, v, causal, scale, window)
