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

A second entry point of the same kernel source draws the noise of a
sampling step, one stream per row: ``uniform_rows(seeds, pos, rowid, n)``
gives row r the n words of the counters (j // 4, pos[r], rowid[r], 0) under
the key of seeds[r] (``uniform_rows_ref`` is its plain version, bit for
bit). A row's draw is then a function of its request's seed, its position
and its row within the request, so a request served in a batch of other
requests draws what it draws alone. The JAX package samples with
``jax.random.categorical`` (cxxnet_tpu/nnet/trainer.py:45-71), whose bits
cannot be reproduced here: the port's sampling draws are its own, as its
noisy layers' are.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from . import _build

# launches of the CUDA kernel, counted in uniform_cuda where it launches
launches = 0
# launches of its per-row entry point, counted in uniform_rows_cuda
rows_launches = 0

# Philox4x32's round multipliers and Weyl key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF
# the ladder: the top 24 of 32 bits, times 2^-24
LADDER_BITS = 24

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
             ctypes.c_uint32, ctypes.c_void_p]
_ROWS_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p]
# the grid's y dimension: one block row per draw row
MAX_ROWS = 65535


# Philox4x32-10 per counter: 10 rounds of 2 low and 2 high 32-bit products
# and 4 xors, 9 key bumps of 2 adds, then per word a shift, a conversion and
# a multiply: ~110 integer operations per 4 elements
OPS_PER_ELEM = 28


def work(n: int) -> Tuple[int, int]:
    """(operations, bytes) of the bulk draw of n words: the f32 words
    written once."""
    return n * OPS_PER_ELEM, 4 * n


def rows_work(rows: int, n: int) -> Tuple[int, int]:
    """(operations, bytes) of the per-row draw of n words for each of
    ``rows`` rows: the f32 words written once, each row's seed, position
    and row id (int64) read once."""
    return rows * n * OPS_PER_ELEM, 4 * rows * n + 3 * 8 * rows


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
    return _philox_keys(counter, key[0], key[1])


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


def seed_word(seed: int) -> int:
    """A 64-bit seed as the int64 of the same bits, as the per-row draw
    takes its seeds from an int64 tensor."""
    seed_key(seed)
    seed = int(seed)
    return seed - (1 << 64) if seed >= 1 << 63 else seed


def _rows_args(seeds: torch.Tensor, pos: torch.Tensor, rowid: torch.Tensor,
               n: int) -> int:
    rows = seeds.shape[0]
    for what, t in (("seeds", seeds), ("pos", pos), ("rowid", rowid)):
        if t.dtype != torch.int64 or t.shape != (rows,):
            raise ValueError("uniform_rows: %s must be an int64 tensor of "
                             "shape (%d,), got %s %s"
                             % (what, rows, t.dtype, tuple(t.shape)))
    if n < 0:
        raise ValueError("uniform_rows: width must be >= 0, got %d" % n)
    return rows


def uniform_rows_ref(seeds: torch.Tensor, pos: torch.Tensor,
                     rowid: torch.Tensor, n: int) -> torch.Tensor:
    """The plain version of the per-row entry point: (rows, n) float32 on
    the tensors' device; element j of row r is word j % 4 of Philox4x32-10
    of the counter (j // 4, pos[r], rowid[r], 0) under the key of seeds[r]
    (int64 tensors, a seed's 64 bits), as u = (bits >> 8) 2^-24."""
    rows = _rows_args(seeds, pos, rowid, n)
    dev = seeds.device
    j = torch.arange((n + 3) // 4, dtype=torch.int64, device=dev)
    shape = (rows, j.shape[0])
    ctr = torch.stack((j.expand(shape), (pos & _MASK32)[:, None].expand(shape),
                       (rowid & _MASK32)[:, None].expand(shape),
                       torch.zeros(shape, dtype=torch.int64, device=dev)), -1)
    k0 = (seeds & _MASK32)[:, None]
    k1 = ((seeds >> 32) & _MASK32)[:, None]
    bits = _philox_keys(ctr, k0, k1).reshape(rows, -1)[:, :n]
    return (bits >> (32 - LADDER_BITS)).to(torch.float32) \
        * 2.0 ** -LADDER_BITS


def _philox_keys(counter: torch.Tensor, k0: torch.Tensor,
                 k1: torch.Tensor) -> torch.Tensor:
    """philox4x32 with a key per row: k0, k1 int64 tensors of 32-bit
    words that broadcast against counter[..., 0]."""
    c0, c1, c2, c3 = counter.unbind(-1)
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3), -1)


def uniform_rows_cuda(seeds: torch.Tensor, pos: torch.Tensor,
                      rowid: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the per-row entry point on the current stream of the tensors'
    CUDA device: (rows, n) float32, bit for bit uniform_rows_ref's. Raises
    on tensors that are not on one CUDA device or a failed launch."""
    global rows_launches
    rows = _rows_args(seeds, pos, rowid, n)
    dev = seeds.device
    if dev.type != "cuda" or pos.device != dev or rowid.device != dev:
        raise ValueError("uniform_rows kernel needs its tensors on one CUDA "
                         "device, got %s, %s, %s"
                         % (seeds.device, pos.device, rowid.device))
    if rows > MAX_ROWS:
        raise ValueError("uniform_rows kernel takes up to %d rows, not %d"
                         % (MAX_ROWS, rows))
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    seeds, pos, rowid = (t.contiguous() for t in (seeds, pos, rowid))
    with torch.cuda.device(dev):
        _build.launch("uniform", _ROWS_ARGTYPES, out.data_ptr(), rows, n,
                      seeds.data_ptr(), pos.data_ptr(), rowid.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream,
                      entry="cxxnet_uniform_rows")
    rows_launches += 1
    return out


def uniform_rows(seeds: torch.Tensor, pos: torch.Tensor, rowid: torch.Tensor,
                 n: int) -> torch.Tensor:
    """The per-row draw: the kernel for CUDA tensors, the plain version for
    CPU tensors, the same bits on both."""
    if seeds.device.type == "cuda":
        return uniform_rows_cuda(seeds, pos, rowid, n)
    if seeds.device.type == "cpu":
        return uniform_rows_ref(seeds, pos, rowid, n)
    raise ValueError("uniform_rows: no implementation for a tensor on %s"
                     % seeds.device)
