"""The ring-attention step kernels: one ring step's forward update, its dQ
and its dK/dV contribution, their plain PyTorch versions, and the gate
``supports``.

Replaces the TPU kernels ``_fwd_step_kernel`` (cxxnet_tpu/ops/ring_flash.py:83,
``fwd_step`` at :191), ``_dq_step_kernel`` (:121, ``dq_step`` at :224) and
``_dkv_step_kernel`` (:150, ``dkv_step`` at :248). The kernels are
``csrc/ring_fwd_step.cu``, ``csrc/ring_dq_step.cu`` and
``csrc/ring_dkv_step.cu``, built with nvcc at first use and bound with ctypes;
their source comments state the design and the bound. parallel/ring.py
drives them around the ring.

Each function takes the JAX function's arguments in the same order and
shapes: q (bh, sq, d); a K/V block (bkv, skv, d); m, l, lse and delta
(bh, sq, 1) f32; the carries acc and dq (bh, sq, d) and dk, dv, all f32;
``offs = (q_off, kv_off)``, the global positions of q's row 0 and the
block's key 0, as host ints. One departure: the block may carry
fewer rows than q (grouped-query attention, bkv = bh / g), q row r reading
block row r // g (JAX expands K/V per call,
cxxnet_tpu/parallel/ring.py:279-285); the dK/dV carries are at JAX's
query-head resolution (bh, skv, d), each query row's share apart, and the
ring sums each group once after its last step (JAX after every step,
:330-333). With g = 1 the shapes are JAX's.

``fwd_step``, ``dq_step`` and ``dkv_step`` launch the kernels for CUDA
tensors and run the plain versions for CPU tensors. The kernels update the
acc, dq, dk and dv carries in place (JAX aliases them) and return them; the
plain versions return new tensors. Nothing falls back to the plain version
for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .flash_attn import NEG_INF, kept_pairs

# launches of the CUDA kernels, each counted in its wrapper where it
# launches: the forward step, the dQ step and the dK/dV step
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# after the tensor pointers: dtype, rows, kv_rows, sq, skv, d, q_off,
# kv_off, causal, window, scale, stream
_SHAPE_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + _SHAPE_ARGTYPES
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + _SHAPE_ARGTYPES
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + _SHAPE_ARGTYPES


def work(kernel: str, bh: int, bkv: int, sq: int, skv: int, d: int,
         q_off: int, kv_off: int, causal, window: int,
         esize: int) -> Tuple[int, int]:
    """(operations, bytes) one ring step needs (``kernel`` "fwd", "dq" or
    "dkv"), counted for these offsets: per (query, key) pair the mask
    keeps 4 d flops (forward), 6 d (dQ) or 8 d (dK/dV); q, the block's k
    and v (and dO, lse, D) read once, the f32 carries read and written
    once. A step that keeps no pair needs only the forward's (m, l)
    copied."""
    pairs = kept_pairs(sq, causal, window, skv, q_off, kv_off) * bh
    q_b, kv_b = esize * bh * sq * d, esize * bkv * skv * d
    rows, q_f32, kv_f32 = 4 * bh * sq, 4 * bh * sq * d, 4 * bkv * skv * d
    if kernel == "fwd":
        if not pairs:
            return 0, 4 * rows
        return 4 * d * pairs, q_b + 2 * kv_b + 4 * rows + 2 * q_f32
    if not pairs:
        return 0, 0
    if kernel == "dq":
        return 6 * d * pairs, 2 * q_b + 2 * kv_b + 2 * rows + 2 * q_f32
    return 8 * d * pairs, 2 * q_b + 2 * kv_b + 2 * rows + 4 * kv_f32


def supports(sq: int, skv: int, d: int) -> bool:
    """Shapes the ring sends to the step kernels: local blocks of at least
    128 rows in multiples of 128 and a head dim that is a multiple of 8
    (the JAX package's rule, cxxnet_tpu/ops/ring_flash.py:48-52, without
    its TPU clause); any other shape runs the dense ring."""
    return (sq >= 128 and sq % 128 == 0 and skv >= 128 and skv % 128 == 0
            and d % 8 == 0)


def _keep(sq: int, skv: int, offs: Sequence[int], causal: bool, window: int,
          device: torch.device) -> Optional[torch.Tensor]:
    """(sq, skv) bool of the (query, key) pairs the mask keeps at the
    global offsets, None when it keeps every pair."""
    if not causal:
        return None
    qpos = offs[0] + torch.arange(sq, device=device)[:, None]
    kpos = offs[1] + torch.arange(skv, device=device)[None, :]
    keep = qpos >= kpos
    if window > 0:
        keep = keep & (qpos - kpos < window)
    return keep


def _grouped(x: torch.Tensor, bkv: int) -> torch.Tensor:
    """(bh, s, e) as (bkv, g, s, e) in f32: q row r in group r // g."""
    return x.float().reshape(bkv, -1, x.shape[1], x.shape[2])


def _scores(q, k_blk, offs, causal, scale, window):
    """The masked scores (bkv, g, sq, skv) in f32, NEG_INF where masked,
    and the keep mask."""
    bkv, skv = k_blk.shape[0], k_blk.shape[1]
    s = torch.einsum("ngqd,nkd->ngqk", _grouped(q, bkv), k_blk.float()) \
        * scale
    keep = _keep(q.shape[1], skv, offs, causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    return s, keep


def fwd_step_ref(q, k_blk, v_blk, m, l, acc, offs, *, causal: bool,
                 scale: float, window: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the forward step: the updated (m, l, acc) after
    folding the block's keys into the carry, densely in f32. Masked mass is
    zeroed outright, so a row none of whose keys is kept keeps its carry."""
    bh, sq, d = q.shape
    bkv = k_blk.shape[0]
    s, keep = _scores(q, k_blk, offs, causal, scale, window)
    mg = m.reshape(bkv, -1, sq, 1)
    m_new = torch.maximum(mg, s.amax(-1, keepdim=True))
    alpha = torch.exp(mg - m_new)
    p = torch.exp(s - m_new)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    l_new = l.reshape(bkv, -1, sq, 1) * alpha + p.sum(-1, keepdim=True)
    acc_new = acc.reshape(bkv, -1, sq, d) * alpha + torch.einsum(
        "ngqk,nkd->ngqd", p, v_blk.float())
    return (m_new.reshape(bh, sq, 1), l_new.reshape(bh, sq, 1),
            acc_new.reshape(bh, sq, d))


def _ds(q, k_blk, v_blk, do, lse, delta, offs, causal, scale, window):
    """(P, dS) of one step, (bkv, g, sq, skv) f32: P = exp(S - lse) with
    the masked scores at NEG_INF, dS = P (dO v^T - D) scale."""
    bkv, sq = k_blk.shape[0], q.shape[1]
    s, _ = _scores(q, k_blk, offs, causal, scale, window)
    p = torch.exp(s - lse.reshape(bkv, -1, sq, 1))
    dp = torch.einsum("ngqd,nkd->ngqk", _grouped(do, bkv), v_blk.float())
    return p, p * (dp - delta.reshape(bkv, -1, sq, 1)) * scale


def dq_step_ref(q, k_blk, v_blk, do, lse, delta, dq, offs, *, causal: bool,
                scale: float, window: int = 0) -> torch.Tensor:
    """The plain version of the dQ step: dq + scale (P o (dO v^T - D)) k,
    densely in f32."""
    bh, sq, d = q.shape
    _, ds = _ds(q, k_blk, v_blk, do, lse, delta, offs, causal, scale,
                window)
    return dq + torch.einsum("ngqk,nkd->ngqd", ds,
                             k_blk.float()).reshape(bh, sq, d)


def dkv_step_ref(q, k_blk, v_blk, do, lse, delta, dk, dv, offs, *,
                 causal: bool, scale: float, window: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dK/dV step: (dk + scale dS^T q, dv + P^T
    dO), one query row's share in each row of the carries (bh, skv, d),
    densely in f32."""
    bkv = k_blk.shape[0]
    p, ds = _ds(q, k_blk, v_blk, do, lse, delta, offs, causal, scale,
                window)
    dv_step = torch.einsum("ngqk,ngqd->ngkd", p, _grouped(do, bkv))
    dk_step = torch.einsum("ngqk,ngqd->ngkd", ds, _grouped(q, bkv))
    return dk + dk_step.reshape(dk.shape), dv + dv_step.reshape(dv.shape)


def _check(name, q, k_blk, v_blk, offs, causal, window, **f32):
    """What the kernels take: q (bh, sq, d) and a block (bkv, skv, d) with
    bkv | bh, float32 or bfloat16 alike, the f32 carries and row vectors
    of their shapes, all contiguous on q's CUDA device, a shape supports()
    admits, and a window only with causal."""
    for nm, t in (("q", q), ("k_blk", k_blk), ("v_blk", v_blk)):
        if t.device.type != "cuda":
            raise ValueError("%s kernel needs CUDA tensors, got %s on %s"
                             % (name, nm, t.device))
        if t.dtype not in _DTYPE_CODE or t.dtype != q.dtype:
            raise TypeError("%s kernel takes float32 or bfloat16 q, k, v of "
                            "one dtype, got %s %s %s"
                            % (name, q.dtype, k_blk.dtype, v_blk.dtype))
        if t.dim() != 3 or not t.is_contiguous() or t.device != q.device:
            raise ValueError("%s kernel needs contiguous 3-d q, k, v on one "
                             "device, got %s %s" % (name, nm,
                                                    tuple(t.shape)))
    bh, sq, d = q.shape
    bkv, skv = k_blk.shape[0], k_blk.shape[1]
    if v_blk.shape != k_blk.shape or k_blk.shape[2] != d or bkv < 1 \
            or bh % bkv != 0:
        raise ValueError("%s kernel: the block must be (bkv, skv, d) with "
                         "bkv dividing q's %d rows and q's d; got q %s k %s "
                         "v %s" % (name, bh, tuple(q.shape),
                                   tuple(k_blk.shape), tuple(v_blk.shape)))
    if not supports(sq, skv, d):
        raise ValueError("%s kernel takes sq, skv >= 128 in multiples of "
                         "128 and d a multiple of 8, not sq %d skv %d d %d"
                         % (name, sq, skv, d))
    if window < 0 or (window > 0 and not causal):
        raise ValueError("%s kernel: window %d needs causal and must be "
                         ">= 0" % (name, window))
    if len(offs) != 2:
        raise ValueError("%s kernel: offs is (q_off, kv_off)" % name)
    for nm, (t, shape) in f32.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError("%s kernel needs a contiguous float32 %s of "
                             "shape %s on q's device, got %s %s"
                             % (name, nm, shape, t.dtype, tuple(t.shape)))


def _shape_args(q, k_blk, offs, causal, scale, window):
    """The trailing arguments of every entry point: dtype, rows, kv_rows,
    sq, skv, d, q_off, kv_off, causal, window, scale, stream."""
    bh, sq, d = q.shape
    return (_DTYPE_CODE[q.dtype], bh, k_blk.shape[0], sq, k_blk.shape[1], d,
            int(offs[0]), int(offs[1]), int(bool(causal)), int(window),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)


def fwd_step_cuda(q, k_blk, v_blk, m, l, acc, offs, *, causal: bool,
                  scale: float, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward step kernel on the current stream: new (m, l)
    and acc updated in place. Raises on an input it does not take or a
    failed launch."""
    global fwd_launches
    bh, sq, d = q.shape
    _check("ring_fwd_step", q, k_blk, v_blk, offs, causal, window,
           m=(m, (bh, sq, 1)), l=(l, (bh, sq, 1)), acc=(acc, (bh, sq, d)))
    m_out, l_out = torch.empty_like(m), torch.empty_like(l)
    with torch.cuda.device(q.device):
        _build.launch("ring_fwd_step", _FWD_ARGTYPES, q.data_ptr(),
                      k_blk.data_ptr(), v_blk.data_ptr(), m.data_ptr(),
                      l.data_ptr(), m_out.data_ptr(), l_out.data_ptr(),
                      acc.data_ptr(),
                      *_shape_args(q, k_blk, offs, causal, scale, window))
    fwd_launches += 1
    return m_out, l_out, acc


def _check_bwd(name, q, k_blk, v_blk, do, lse, delta, offs, causal, window,
               **carries):
    bh, sq, _ = q.shape
    if (do.shape != q.shape or do.dtype != q.dtype or do.device != q.device
            or not do.is_contiguous()):
        raise ValueError("%s kernel needs a contiguous dO of q's shape, "
                         "dtype and device" % name)
    _check(name, q, k_blk, v_blk, offs, causal, window,
           lse=(lse, (bh, sq, 1)), delta=(delta, (bh, sq, 1)), **carries)


def dq_step_cuda(q, k_blk, v_blk, do, lse, delta, dq, offs, *, causal: bool,
                 scale: float, window: int = 0) -> torch.Tensor:
    """Launch the dQ step kernel on the current stream: dq updated in
    place. Raises on an input it does not take or a failed launch."""
    global dq_launches
    _check_bwd("ring_dq_step", q, k_blk, v_blk, do, lse, delta, offs, causal,
               window, dq=(dq, tuple(q.shape)))
    with torch.cuda.device(q.device):
        _build.launch("ring_dq_step", _DQ_ARGTYPES, q.data_ptr(),
                      k_blk.data_ptr(), v_blk.data_ptr(), do.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                      *_shape_args(q, k_blk, offs, causal, scale, window))
    dq_launches += 1
    return dq


def dkv_step_cuda(q, k_blk, v_blk, do, lse, delta, dk, dv, offs, *,
                  causal: bool, scale: float, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV step kernel on the current stream: dk and dv
    (bh, skv, d) updated in place. Raises on an input it does not take or
    a failed launch."""
    global dkv_launches
    carry = (q.shape[0],) + tuple(k_blk.shape[1:])
    _check_bwd("ring_dkv_step", q, k_blk, v_blk, do, lse, delta, offs,
               causal, window, dk=(dk, carry), dv=(dv, carry))
    with torch.cuda.device(q.device):
        _build.launch("ring_dkv_step", _DKV_ARGTYPES, q.data_ptr(),
                      k_blk.data_ptr(), v_blk.data_ptr(), do.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(),
                      *_shape_args(q, k_blk, offs, causal, scale, window))
    dkv_launches += 1
    return dk, dv


def fwd_step(q, k_blk, v_blk, m, l, acc, offs, **kw):
    """One ring step's forward update: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    fn = fwd_step_cuda if q.device.type == "cuda" else fwd_step_ref
    return fn(q, k_blk, v_blk, m, l, acc, offs, **kw)


def dq_step(q, k_blk, v_blk, do, lse, delta, dq, offs, **kw):
    """One ring step's dQ contribution, added to the carry dq."""
    fn = dq_step_cuda if q.device.type == "cuda" else dq_step_ref
    return fn(q, k_blk, v_blk, do, lse, delta, dq, offs, **kw)


def dkv_step(q, k_blk, v_blk, do, lse, delta, dk, dv, offs, **kw):
    """One ring step's dK/dV contribution, added to the carries dk, dv."""
    fn = dkv_step_cuda if q.device.type == "cuda" else dkv_step_ref
    return fn(q, k_blk, v_blk, do, lse, delta, dk, dv, offs, **kw)
