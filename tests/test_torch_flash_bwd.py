"""The flash attention backward's plain version against the JAX package, on
the CPU: ``flash_bwd_ref`` against ``jax.vjp`` of the JAX package's
``flash_attention``, whose backward runs the Pallas kernels ``_dq_kernel``
and ``_dkv_kernel`` in interpret mode (as tests/test_flash_attention.py
runs them); and the autograd route of ``FlashAttention`` on CPU tensors.

Inputs come from seeded numpy; L 200 is padded to the tile on the JAX side
and masked in place in the port. Tolerances, each against the largest
magnitude of the gradient compared:

- fp32 within 1e-5: both sides compute the same f32 function, the JAX
  kernels blockwise (S recomputed per tile, dQ and dK/dV summed over
  tiles, the GQA group summed outside) and the port densely, so the sums
  run in another order; each side also takes its own forward's out and lse.
- bf16 within 2e-2: the JAX kernels round P and dS to bf16 before their
  second products (``.astype(k.dtype)``), the port's plain version keeps
  them in f32 and rounds only the result, as the CUDA kernels do; a bf16
  rounding is 2^-8 relative, and the gradient sums many such terms.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.ops import flash_attn as jflash
from cxxnet_tpu_torch.ops import flash_attn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
H = 4

CASES = [
    # (L, d, nkv, causal, window)
    (128, 64, 4, False, 0),
    (128, 16, 4, True, 0),
    (128, 24, 1, True, 0),
    (256, 64, 2, True, 0),
    (256, 16, 1, False, 0),
    (256, 24, 2, True, 64),
    (200, 64, 4, True, 0),
    (200, 24, 4, False, 0),
    (200, 16, 2, True, 64),
    (200, 64, 1, True, 64),
]


def _inputs(seed, L, d, nkv, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, H, L, d).astype(np.float32) * 1.5,
            rng.randn(b, nkv, L, d).astype(np.float32) * 1.5,
            rng.randn(b, nkv, L, d).astype(np.float32),
            rng.randn(b, H, L, d).astype(np.float32))


def _jax_grads(q, k, v, do, causal, window, dtype):
    jd = jnp.dtype(dtype)
    args = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q_, k_, v_: jflash.flash_attention(
        q_, k_, v_, causal, None, True, window), *args)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do).astype(jd))]


def _port_grads(q, k, v, do, causal, window, dtype):
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    out, lse = flash_attn.flash_fwd_ref(tq, tk, tv, causal, None, window)
    grads = flash_attn.flash_bwd_ref(tq, tk, tv, out, lse, tdo, causal, None,
                                     window)
    for g, t in zip(grads, (tq, tk, tv)):
        assert g.dtype == td and g.shape == t.shape
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L, d, nkv, causal, window", CASES)
def test_flash_bwd_ref_matches_pallas_backward(L, d, nkv, causal, window,
                                               dtype):
    q, k, v, do = _inputs(L + d + nkv + window, L, d, nkv)
    want = _jax_grads(q, k, v, do, causal, window, dtype)
    got = _port_grads(q, k, v, do, causal, window, dtype)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=TOL[dtype] * float(np.abs(w).max()),
            err_msg=name)


def test_flash_bwd_ref_is_the_gradient_of_flash_fwd_ref():
    # the factorised backward against autograd of the dense forward, with a
    # window and grouped kv heads (float64 leaves; both plain versions
    # compute in f32 and return the inputs' dtype)
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _inputs(3, 160, 16, 2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = flash_attn.flash_fwd_ref(*leaves, True, None, 48)
    want = torch.autograd.grad(out, leaves, do)
    got = flash_attn.flash_bwd_ref(q, k, v, out.detach(), lse.detach(), do,
                                   True, None, 48)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(
            w.abs().max()))


def test_window_one_gradients_stay_finite():
    # window 1: each query sees only its own key and every other score is
    # NEG_INF, so P is the identity: dS = P (dP - D) is 0 up to the rounding
    # of two orders of one dot product (dP = dO v^T against D = rowsum(dO o)
    # out with out = v), and dv is dO summed over each kv head's query heads
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(4, 130, 16, 2))
    out, lse = flash_attn.flash_fwd_ref(q, k, v, True, None, 1)
    dq, dk, dv = flash_attn.flash_bwd_ref(q, k, v, out, lse, do, True, None,
                                          1)
    assert bool(torch.isfinite(dq).all() and torch.isfinite(dk).all())
    torch.testing.assert_close(dv, do.reshape(2, 2, 2, 130, 16).sum(2),
                               rtol=1e-6, atol=1e-6)
    bound = 1e-5 * float(dv.abs().max())
    assert float(dq.abs().max()) <= bound and float(dk.abs().max()) <= bound


@pytest.mark.parametrize("causal, window, nkv", [(False, 0, 4), (True, 0, 1),
                                                 (True, 48, 2)])
def test_autograd_on_cpu_reaches_flash_bwd_ref(monkeypatch, causal, window,
                                               nkv):
    q, k, v, do = _inputs(7 + nkv, 160, 24, nkv)
    seen = []
    real = flash_attn.flash_bwd_ref

    def spy(*args):
        seen.append(tuple(a.shape for a in args[:6]))
        return real(*args)
    monkeypatch.setattr(flash_attn, "flash_bwd_ref", spy)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (flash_attn.launches, flash_attn.dq_launches,
              flash_attn.dkv_launches)
    out = flash_attn.flash_attention(*leaves, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    assert (flash_attn.launches, flash_attn.dq_launches,
            flash_attn.dkv_launches) == before
    assert seen == [((2, H, 160, 24), (2, nkv, 160, 24), (2, nkv, 160, 24),
                     (2, H, 160, 24), (2, H, 160), (2, H, 160, 24))]
    want = _jax_grads(q, k, v, do, causal, window, "float32")
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_backward_wrappers_refuse_cpu_tensors_and_bad_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 128, 64, 2, b=1))
    lse = torch.zeros(1, H, 128)
    with pytest.raises(ValueError, match="flash_bwd_dq kernel needs CUDA"):
        flash_attn.flash_bwd_dq_cuda(q, k, v, do, lse, lse, True)
    with pytest.raises(ValueError, match="flash_bwd_dkv kernel needs CUDA"):
        flash_attn.flash_bwd_dkv_cuda(q, k, v, do, lse, lse, True)
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attn.flash_bwd_cuda(q, k, v, q, lse, do, True)
    with pytest.raises(ValueError, match="needs causal"):
        flash_attn.flash_bwd_ref(q, k, v, q, lse, do, False, None, 16)
