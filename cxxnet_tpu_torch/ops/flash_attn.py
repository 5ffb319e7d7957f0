"""Flash attention: the hand-written CUDA kernels of the forward and the
backward, their plain PyTorch versions, and the dispatch between them.

Replaces the TPU kernels ``_fwd_kernel`` (cxxnet_tpu/ops/flash_attn.py:82,
launched at :284), ``_dq_kernel`` (:123, launched at :337) and
``_dkv_kernel`` (:156, launched at :363), and the gate ``supports``
(:213-216). The kernels are ``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu``
and ``csrc/flash_bwd_dkv.cu``, built with nvcc at first use and bound with
ctypes; their source comments state the design and the bound. They take
every head dim the gate admits: up to 256 in the next compiled width with
zero-filled columns, above 256 in slices of 256 columns
(csrc/flash_common.cuh).

``flash_attention`` goes through ``FlashAttention``: for a CUDA tensor the
forward launches the forward kernel and keeps its lse, and the backward
launches the dQ and dK/dV kernels; for a CPU tensor the forward is
``flash_fwd_ref`` and the backward ``flash_bwd_ref``. The forward goes
through the custom op ``cxxnet::flash_fwd`` (ops/library.py), so an
exported program keeps the kernel. Nothing falls back to the plain version
for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

# launches of the CUDA kernels, each counted in its wrapper where it
# launches: the forward, the dQ and the dK/dV kernel
launches = 0
dq_launches = 0
dkv_launches = 0

# finite stand-in for -inf: exp(NEG_INF - m) is 0 and never NaN (the TPU
# kernel's rule, cxxnet_tpu/ops/flash_attn.py:46)
NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# after the tensor pointers: dtype, batch, heads, kv_heads, L, d, causal,
# window, scale, stream
_SHAPE_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 5 + _SHAPE_ARGTYPES
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + _SHAPE_ARGTYPES
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + _SHAPE_ARGTYPES


def kept_pairs(L: int, causal, window: int, skv: Optional[int] = None,
               q_off: int = 0, kv_off: int = 0) -> int:
    """(query, key) pairs of one head that the mask keeps, for L queries
    at the global positions q_off.. against skv keys (L by default) at
    kv_off.. (a ring step's block, a decode step's cache; 0 and 0 for a
    whole sequence)."""
    skv = L if skv is None else skv
    if not causal:
        return L * skv
    qpos = q_off + np.arange(L, dtype=np.int64)
    hi = np.minimum(qpos - kv_off + 1, skv)            # keys <= the query
    lo = np.maximum(qpos - window + 1 - kv_off, 0) if window > 0 else 0
    return int(np.clip(hi - lo, 0, None).sum())


def work(b: int, h: int, nkv: int, L: int, d: int, causal, window: int,
         esize: int) -> Tuple[int, int]:
    """(operations, bytes) the flash forward needs: 4 d flops (q k^T and
    p v) per (query, key) pair the mask keeps, counted for this shape;
    q, k, v read once, out (input dtype) and lse (f32) written once."""
    ops = 4 * d * kept_pairs(L, causal, window) * b * h
    nbytes = esize * (2 * b * h * L * d + 2 * b * nkv * L * d) + 4 * b * h * L
    return ops, nbytes


def bwd_work(b: int, h: int, nkv: int, L: int, d: int, causal, window: int,
             esize: int):
    """((dq operations, bytes), (dk/dv operations, bytes)) the backward
    kernels need, counted for this shape: per (query, key) pair the mask
    keeps, 6 d flops for dQ (S, dP, dS K) and 8 d for dK/dV (S, P^T dO, dP,
    dS^T Q); each input read once (q, k, v, dO in the input dtype, lse and
    D in f32), each output written once."""
    pairs = kept_pairs(L, causal, window) * b * h
    q_elems, kv_elems = b * h * L * d, b * nkv * L * d
    rows = 8 * b * h * L
    return ((6 * d * pairs, esize * (3 * q_elems + 2 * kv_elems) + rows),
            (8 * d * pairs, esize * (2 * q_elems + 4 * kv_elems) + rows))


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


def _keep_mask(L: int, causal: bool, window: int,
               device: torch.device) -> Optional[torch.Tensor]:
    """(L, L) bool of the (query, key) pairs the mask keeps, None when it
    keeps every pair."""
    if not causal:
        return None
    pos = torch.arange(L, device=device)
    diff = pos[:, None] - pos[None, :]
    keep = diff >= 0
    if window > 0:
        keep = keep & (diff < window)
    return keep


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
    keep = _keep_mask(L, causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bngqk,bnkd->bngqd", p, v.float())
    return (out.reshape(b, h, L, d).to(q.dtype), lse.reshape(b, h, L))


def bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO o O) in f32, (b, h, L): the term of dS that both
    backward kernels read, one PyTorch reduction before their launches, as
    the JAX package computes it in XLA outside its kernels
    (cxxnet_tpu/ops/flash_attn.py:330-331)."""
    return (dout.float() * out.float()).sum(-1)


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  causal: bool = False, scale: Optional[float] = None,
                  window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward kernels: (dq, dk, dv) of
    flash attention at the forward's (out, lse) and the upstream gradient
    dout, in the FlashAttention-2 factorisation of the JAX package
    (cxxnet_tpu/ops/flash_attn.py:15-23): P = exp(scale q k^T + mask - lse)
    with masked scores at NEG_INF, dV = P^T dO, dS = P o (dO V^T - D) with
    D = rowsum(dO o O), dQ = scale dS K, dK = scale dS^T Q. Computed densely
    in f32 one (batch row, kv head) at a time, so that a long sequence
    holds a few (h / nkv, L, L) temporaries and not (b, h, L, L) ones; dk
    and dv come back summed over each kv head's query heads, all three in
    the inputs' dtypes."""
    _check_shapes(q, k, v, causal, window)
    b, h, L, d = q.shape
    nkv = k.shape[1]
    g = h // nkv
    if scale is None:
        scale = d ** -0.5
    keep = _keep_mask(L, causal, window, q.device)
    delta = bwd_delta(out, dout)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for bi in range(b):
        for n in range(nkv):
            hs = slice(n * g, (n + 1) * g)
            qf, do = q[bi, hs].float(), dout[bi, hs].float()  # (g, L, d)
            kf, vf = k[bi, n].float(), v[bi, n].float()        # (L, d)
            s = (qf @ kf.T) * scale                            # (g, L, L)
            if keep is not None:
                s = s.masked_fill(~keep, NEG_INF)
            p = torch.exp(s - lse[bi, hs, :, None])
            del s
            ds = p * ((do @ vf.T) - delta[bi, hs, :, None]) * scale
            dq[bi, hs] = (ds @ kf).to(q.dtype)
            dk[bi, n] = (ds.transpose(1, 2) @ qf).sum(0).to(k.dtype)
            dv[bi, n] = (p.transpose(1, 2) @ do).sum(0).to(v.dtype)
    return dq, dk, dv


def check_kernel_input(q, k, v, causal: bool, window: int,
                       name: str = "flash_fwd") -> None:
    """What the kernels take: q (b, h, L, d) and k/v (b, nkv, L, d),
    contiguous, float32 or bfloat16 alike, on one CUDA device, with
    nkv | h, d >= 1 and window only with causal."""
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError("%s kernel needs CUDA tensors, got %s on %s"
                             % (name, nm, t.device))
        if t.dtype not in _DTYPE_CODE or t.dtype != q.dtype:
            raise TypeError("%s kernel takes float32 or bfloat16 q, k, v of "
                            "one dtype, got %s %s %s"
                            % (name, q.dtype, k.dtype, v.dtype))
        if not t.is_contiguous():
            raise ValueError("%s kernel needs a contiguous %s" % (name, nm))
        if t.device != q.device:
            raise ValueError("%s kernel needs q, k, v on one device" % name)
    _check_shapes(q, k, v, causal, window)
    if q.shape[3] < 1:
        raise ValueError("%s kernel needs a head dim >= 1" % name)


def _shape_args(q, k, causal, scale, window):
    """The trailing arguments of every entry point: dtype, batch, heads,
    kv heads, L, d, causal, window, scale, stream."""
    b, h, L, d = q.shape
    if scale is None:
        scale = d ** -0.5
    return (_DTYPE_CODE[q.dtype], b, h, k.shape[1], L, d, int(bool(causal)),
            window, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream: (out in q's dtype,
    f32 lse (b, h, L)). Raises on an input it does not take or a failed
    launch."""
    global launches
    check_kernel_input(q, k, v, causal, window)
    b, h, L, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        _build.launch("flash_fwd", _ARGTYPES, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      *_shape_args(q, k, causal, scale, window))
    launches += 1
    return out, lse


def _check_bwd_input(name, q, k, v, dout, lse, delta, causal, window):
    check_kernel_input(q, k, v, causal, window, name)
    if (dout.shape != q.shape or dout.dtype != q.dtype
            or dout.device != q.device or not dout.is_contiguous()):
        raise ValueError("%s kernel needs a contiguous dout of q's shape, "
                         "dtype and device" % name)
    for nm, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError("%s kernel needs a contiguous float32 %s of "
                             "shape (b, h, L) on q's device" % (name, nm))


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool = False,
                      scale: Optional[float] = None,
                      window: int = 0) -> torch.Tensor:
    """Launch the dQ kernel on the current stream: dq in q's dtype, from
    the forward's lse and D = bwd_delta(out, dout). Raises on an input it
    does not take or a failed launch."""
    global dq_launches
    _check_bwd_input("flash_bwd_dq", q, k, v, dout, lse, delta, causal,
                     window)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    with torch.cuda.device(q.device):
        _build.launch("flash_bwd_dq", _DQ_ARGTYPES, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                      *_shape_args(q, k, causal, scale, window))
    dq_launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal: bool = False,
                       scale: Optional[float] = None, window: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel on the current stream: (dk, dv) in k's
    dtype at kv-head resolution (each summed over its query heads inside
    the kernel). Raises on an input it does not take or a failed launch."""
    global dkv_launches
    _check_bwd_input("flash_bwd_dkv", q, k, v, dout, lse, delta, causal,
                     window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        _build.launch("flash_bwd_dkv", _DKV_ARGTYPES, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), *_shape_args(q, k, causal, scale, window))
    dkv_launches += 1
    return dk, dv


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   window: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card, flash_bwd_ref's contract: D as one
    PyTorch reduction, then the dQ and the dK/dV kernels."""
    delta = bwd_delta(out, dout)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale, window)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, scale,
                                window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention as an autograd op. The forward keeps (q, k, v, out,
    lse) for the backward. A CUDA tensor runs the kernels both ways (the
    forward kernel's lse feeds the backward kernels); a CPU tensor runs
    flash_fwd_ref and flash_bwd_ref."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        out, lse = torch.ops.cxxnet.flash_fwd(
            q, k, v, bool(causal),
            float(q.shape[3] ** -0.5 if scale is None else scale),
            int(window))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_bwd_cuda if q.device.type == "cuda" else flash_bwd_ref
        # autograd hands over the gradient of a transposed view; the
        # kernels take it contiguous
        dq, dk, dv = bwd(q, k, v, out, lse, grad_out.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Memory-O(L) attention (the JAX package's ops.flash_attention): q
    (b, h, L, d), k/v (b, nkv, L, d) with nkv | h; the kernels for CUDA
    tensors, the plain versions for CPU tensors."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError("flash attention: no implementation for a tensor "
                         "on %s" % q.device)
    return FlashAttention.apply(q, k, v, causal, scale, window)
