"""The forward kernels of the serving path as PyTorch custom ops, so that an
exported program (``torch.export``) keeps them as graph nodes of their own.

    cxxnet::lrn_fwd       (x, nsize, alpha, beta, knorm) -> out
    cxxnet::lrn_fwd_norm  (x, nsize, alpha, beta, knorm) -> (out, f32 norm)
    cxxnet::flash_fwd     (q, k, v, causal, scale, window) -> (out, f32 lse)

Each op has one implementation per device type. On a CUDA tensor it is the
kernel's wrapper (``ops.lrn.lrn_fwd_cuda``, ``ops.flash_attn.flash_fwd_cuda``),
which counts the launch and raises if the build or the launch fails; on a
CPU tensor it is the kernel's plain version (``lrn_ref`` /
``lrn_ref_with_norm``, ``flash_fwd_ref``). Any other device has no
implementation. ``register_fake`` gives each op its output shapes and dtypes,
which is all a fake-tensor trace needs: the trace never launches a kernel.

``ops.lrn.forward`` / ``LRNFunction`` and ``ops.flash_attn.FlashAttention``
call the kernels through these ops, so eager runs and exported programs take
one path. A program that holds a ``cxxnet::`` node loads only after this
module is imported (``api.load_exported`` and ``api.load_decode`` import it).
This module imports torch and the port's op modules, nothing else of the
port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import flash_attn, lrn

__all__ = ["lrn_fwd", "lrn_fwd_norm", "flash_fwd"]


@torch.library.custom_op("cxxnet::lrn_fwd", mutates_args=(),
                         device_types="cpu")
def lrn_fwd(x: torch.Tensor, nsize: int, alpha: float, beta: float,
            knorm: float) -> torch.Tensor:
    """LRN across the channels of an NCHW tensor, without the norm (the
    inference form of the forward kernel, csrc/lrn_fwd.cu)."""
    return lrn.lrn_ref(x, nsize, alpha, beta, knorm)


@lrn_fwd.register_kernel("cuda")
def _lrn_fwd_cuda(x, nsize, alpha, beta, knorm):
    return lrn.lrn_fwd_cuda(x, nsize, alpha, beta, knorm, with_norm=False)[0]


@lrn_fwd.register_fake
def _lrn_fwd_fake(x, nsize, alpha, beta, knorm):
    return torch.empty_like(x)


@torch.library.custom_op("cxxnet::lrn_fwd_norm", mutates_args=(),
                         device_types="cpu")
def lrn_fwd_norm(x: torch.Tensor, nsize: int, alpha: float, beta: float,
                 knorm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """LRN forward that also returns the f32 norm the backward takes (the
    training form of the forward kernel)."""
    return lrn.lrn_ref_with_norm(x, nsize, alpha, beta, knorm)


@lrn_fwd_norm.register_kernel("cuda")
def _lrn_fwd_norm_cuda(x, nsize, alpha, beta, knorm):
    return lrn.lrn_fwd_cuda(x, nsize, alpha, beta, knorm)


@lrn_fwd_norm.register_fake
def _lrn_fwd_norm_fake(x, nsize, alpha, beta, knorm):
    return torch.empty_like(x), torch.empty_like(x, dtype=torch.float32)


@torch.library.custom_op("cxxnet::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float, window: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward: (out in q's dtype, f32 lse (b, h, L)) for
    q (b, h, L, d) and k/v (b, nkv, L, d) (csrc/flash_fwd.cu)."""
    return flash_attn.flash_fwd_ref(q, k, v, causal, scale, window)


@flash_fwd.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, causal, scale, window):
    return flash_attn.flash_fwd_cuda(q, k, v, causal, scale, window)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, window):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:3], dtype=torch.float32))
