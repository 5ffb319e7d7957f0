"""Uniform random numbers for the layers that draw noise in training: the
hand-written CUDA Philox kernel, its plain PyTorch version, and the
dispatch between them.

Replaces the TPU kernel ``_uniform_kernel`` launched by ``uniform``
(cxxnet_tpu/ops/pallas_kernels.py:138-177), which ``rrelu_mask`` (:180-187)
turns into the insanity layer's slopes. The kernel is ``csrc/uniform.cu``,
built with nvcc at first use and bound with ctypes; its source comment
states the design and the bound.

The generator is Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel
random numbers: as easy as 1, 2, 3", SC'11), keyed by the 64-bit seed as
two 32-bit words (low word first). Element i of the flat draw is word
i % 4 of the block of the counter (i // 4 as two words, low first, 0, 0),
and u = (bits >> 8) * 2^-24: the TPU kernel's ladder of 2^24 values in
[0, 1) (pallas_kernels.py:145-149). The stream is a function of (seed, i)
alone, never of a launch shape, so the kernel and the plain version give
the same bits, on the card and on the CPU. The TPU's own bits cannot be
reproduced here; what carries over is the function: U[0, 1) on the 24-bit
ladder, one deterministic stream per seed, independent across seeds. The
per-block reseeding of the TPU kernel (``prng_seed(seed, block)``) has no
counterpart: the counter does its job.

``uniform(seed, shape, device)`` launches the kernel for a CUDA device and
runs the plain version for the CPU; nothing falls back to the plain
version for a CUDA device.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from . import _build

# launches of the CUDA kernel, counted in uniform_cuda where it launches
launches = 0

# Philox4x32's round multipliers and Weyl key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF
# the ladder: the top 24 of 32 bits, times 2^-24
LADDER_BITS = 24

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
             ctypes.c_uint32, ctypes.c_void_p]


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * x for a 32-bit constant m and an
    int64 tensor of 32-bit words x. The full product can reach 2^64, past a
    signed int64, so m is split into 16-bit halves: each partial product
    stays under 2^48 and every sum under 2^50."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (t >> 32) + (p_hi >> 16), t & _MASK32


def philox4x32(counter: torch.Tensor, key: Tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 of ``counter``, an int64 tensor (..., 4) of 32-bit
    words, under ``key``, two 32-bit words: the (..., 4) output block as
    int64 words in [0, 2^32)."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3), -1)


def seed_key(seed: int) -> Tuple[int, int]:
    """The Philox key of a 64-bit seed: (low word, high word)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError("uniform: seed must be in [0, 2^64), got %d" % seed)
    return seed & _MASK32, seed >> 32


def uniform_ref(seed: int, shape: Sequence[int],
                device="cpu") -> torch.Tensor:
    """The plain version of the kernel: a float32 tensor of ``shape`` on
    ``device`` whose flat element i is word i % 4 of Philox4x32-10 of the
    counter (i // 4, 0, 0) under the seed's key, as u = (bits >> 8) 2^-24;
    computed in int64 arithmetic, bit for bit the kernel's."""
    n = math.prod(shape)
    idx = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    ctr = torch.stack((idx & _MASK32, idx >> 32, zero, zero), -1)
    bits = philox4x32(ctr, seed_key(seed)).reshape(-1)[:n]
    u = (bits >> (32 - LADDER_BITS)).to(torch.float32) \
        * 2.0 ** -LADDER_BITS
    return u.reshape(tuple(shape))


def uniform_cuda(seed: int, shape: Sequence[int], device) -> torch.Tensor:
    """Launch the kernel on the current stream of the CUDA ``device``: a
    float32 tensor of ``shape``, bit for bit uniform_ref's. Raises on a
    device that is not CUDA or a failed launch."""
    global launches
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("uniform kernel needs a CUDA device, got %s"
                         % device)
    key = seed_key(seed)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        _build.launch("uniform", _ARGTYPES, out.data_ptr(), out.numel(),
                      key[0], key[1],
                      torch.cuda.current_stream(device).cuda_stream)
    launches += 1
    return out


def uniform(seed: int, shape: Sequence[int], device) -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` from ``seed``: the kernel for a CUDA
    device, the plain version for the CPU, the same bits on both."""
    device = torch.device(device)
    if device.type == "cuda":
        return uniform_cuda(seed, shape, device)
    if device.type == "cpu":
        return uniform_ref(seed, shape, device)
    raise ValueError("uniform: no implementation for a tensor on %s" % device)
