"""The flash attention forward's plain version against the JAX package, on
the CPU: ``flash_fwd_ref`` against the Pallas kernel run in interpret mode
(as tests/test_flash_attention.py runs it) for out and lse, and against
``attention_reference``; the gate ``supports``; the autograd route of
``flash_attention`` on CPU tensors against ``jax.grad``; and the
wrapper's refusal of what the kernel does not take. At head dim 256, the
widest the kernels take, ``flash_fwd_ref`` and ``flash_bwd_ref`` against
the Pallas forward and ``jax.vjp`` of the Pallas backward, both in
interpret mode.

Inputs come from seeded numpy. Tolerance: relative 1e-5 (the reference's
PairTest bar) plus an absolute 1e-5 of the largest magnitude compared: the
plain version sums densely, the Pallas kernel blockwise with an online
rescale, so the sums run in another order. Gradients: relative and
absolute 1e-4 of the largest magnitude, as the JAX package's own flash
gradient test holds them (the backward adds a second product and a
softmax derivative in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.ops import flash_attn as jflash
from cxxnet_tpu.parallel.ring import attention_reference as jattention
from cxxnet_tpu_torch.ops import attention as tattention
from cxxnet_tpu_torch.ops import flash_attn

from tests.test_torch_flash_bwd import TOL as BWD_TOL
from tests.test_torch_flash_bwd import _inputs, _jax_grads, _port_grads

RTOL, ATOL_REL = 1e-5, 1e-5


def _qkv(seed, b, h, nkv, L, d, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, L, d).astype(np.float32) * scale,
            rng.randn(b, nkv, L, d).astype(np.float32) * scale,
            rng.randn(b, nkv, L, d).astype(np.float32))


def _close(got, want, rtol=RTOL, atol_rel=ATOL_REL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()),
                               err_msg=what)


CASES = [
    # (L, d, nkv, causal, window) with h = 4
    (128, 64, 4, False, 0),
    (128, 16, 4, True, 0),
    (200, 64, 2, True, 0),
    (200, 16, 1, False, 0),
    (384, 64, 4, True, 64),
    (384, 16, 2, True, 64),
    (200, 64, 1, True, 64),
    (384, 16, 4, False, 0),
]


@pytest.mark.parametrize("L, d, nkv, causal, window", CASES)
def test_flash_fwd_ref_matches_pallas_kernel(L, d, nkv, causal, window):
    q, k, v = _qkv(L + d + nkv, 2, 4, nkv, L, d, scale=1.5)
    out, res = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, None, True, window)
    jlse = np.asarray(res[4])[:, :L, 0].reshape(2, 4, L)
    got_out, got_lse = flash_attn.flash_fwd_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, None, window)
    assert got_out.dtype == torch.float32 and got_lse.shape == (2, 4, L)
    _close(got_out, out, what="out")
    _close(got_lse, jlse, what="lse")


# head dim 256 (the widest compiled width of the kernels), with h = 4
CASES_D256 = [
    (128, 4, True, 0),
    (128, 2, False, 0),
    (200, 2, True, 64),
    (200, 1, True, 0),
]


@pytest.mark.parametrize("L, nkv, causal, window", CASES_D256)
def test_flash_fwd_ref_at_head_dim_256_matches_pallas_kernel(L, nkv, causal,
                                                             window):
    test_flash_fwd_ref_matches_pallas_kernel(L, 256, nkv, causal, window)


@pytest.mark.parametrize("L, nkv, causal, window", CASES_D256)
def test_flash_bwd_ref_at_head_dim_256_matches_pallas_backward(L, nkv,
                                                               causal,
                                                               window):
    # fp32: both sides compute the same f32 function, blockwise in JAX and
    # densely here, so within 1e-5 of each gradient's largest magnitude
    q, k, v, do = _inputs(L + nkv + window, L, 256, nkv)
    want = _jax_grads(q, k, v, do, causal, window, "float32")
    got = _port_grads(q, k, v, do, causal, window, "float32")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=BWD_TOL["float32"] * float(np.abs(w).max()),
            err_msg=name)


@pytest.mark.parametrize("L, d, nkv, causal, window", CASES)
def test_flash_fwd_ref_matches_attention_reference(L, d, nkv, causal,
                                                   window):
    q, k, v = _qkv(L * d + nkv, 2, 4, nkv, L, d)
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got, _ = flash_attn.flash_fwd_ref(tq, tk, tv, causal, None, window)
    _close(got, want)
    # the port's own dense attention is the same function
    _close(tattention.attention_reference(tq, tk, tv, causal=causal,
                                          window=window), want)


@pytest.mark.parametrize("q_offset, window", [(0, 0), (37, 0), (60, 16)])
def test_dense_attention_with_q_offset_matches_jax(q_offset, window):
    # the decode step's shape: a few query rows at a global offset against
    # a longer cache, grouped kv heads
    rng = np.random.RandomState(q_offset + window)
    q = rng.randn(2, 4, 3, 16).astype(np.float32)
    k = rng.randn(2, 2, 64, 16).astype(np.float32)
    v = rng.randn(2, 2, 64, 16).astype(np.float32)
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, window=window, q_offset=q_offset)
    got = tattention.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, q_offset=q_offset)
    _close(got, want)


def test_bf16_inputs_take_f32_sums():
    q, k, v = _qkv(3, 2, 4, 2, 256, 64)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out, lse = flash_attn.flash_fwd_ref(tq, tk, tv, True, None, 0)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want, want_lse = flash_attn.flash_fwd_ref(tq.float(), tk.float(),
                                              tv.float(), True, None, 0)
    assert torch.equal(out, want.bfloat16())
    assert torch.equal(lse, want_lse)


@pytest.mark.parametrize("L, d, want", [(128, 64, True), (127, 64, False),
                                        (2048, 16, True), (200, 8, True),
                                        (200, 12, False), (4096, 128, True)])
def test_supports(L, d, want):
    assert flash_attn.supports(L, d) is want
    assert jflash.supports(L, d) is want


@pytest.mark.parametrize("causal, window, nkv", [(False, 0, 4), (True, 0, 2),
                                                 (True, 48, 1)])
def test_autograd_on_cpu_matches_jax_grad(causal, window, nkv):
    q, k, v = _qkv(17 + nkv, 2, 4, nkv, 160, 16)
    w = np.random.RandomState(5).randn(2, 4, 160, 16).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jnp.sin(jattention(q_, k_, v_, causal=causal,
                                          window=window)) * w)
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = flash_attn.launches
    out = flash_attn.flash_attention(*leaves, causal=causal, window=window)
    (torch.sin(out) * torch.from_numpy(w)).sum().backward()
    assert flash_attn.launches == before
    for leaf, g in zip(leaves, want):
        _close(leaf.grad, g, rtol=1e-4, atol_rel=1e-4)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 4, 2, 128, 64))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attn.flash_fwd_cuda(q, k, v, True)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        k3 = k[:, :1].expand(1, 3, 128, 64)
        flash_attn.flash_fwd_ref(q, k3, k3, True)
    with pytest.raises(ValueError, match="needs causal"):
        flash_attn.flash_fwd_ref(q, k, v, False, None, 16)
    with pytest.raises(ValueError, match="of q's b, L and d"):
        flash_attn.flash_fwd_ref(q, k[:, :, :64], v[:, :, :64], True)


def test_layer_sends_long_sequences_to_the_flash_path(monkeypatch):
    from cxxnet_tpu_torch.layer import layers as TL
    from cxxnet_tpu_torch.layer.base import ApplyContext
    seen = []
    real = flash_attn.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), q.is_contiguous(), kw))
        return real(q, k, v, **kw)
    monkeypatch.setattr(flash_attn, "flash_attention", spy)
    lay = TL.AttentionLayer()
    for key, val in (("nhead", "4"), ("causal", "1"), ("nkvhead", "2"),
                     ("attn_window", "40")):
        lay.set_param(key, val)
    for L in (127, 128):
        lay.infer_shape([(2, 64, 1, L)])
        params = {k: torch.randn(*s) * 0.1
                  for k, s in lay.param_shapes().items()}
        lay.forward(params, [torch.randn(2, 64, 1, L)], ApplyContext())
    assert seen == [((2, 4, 128, 16), True, {"causal": True, "window": 40})]
