"""The transformer LM under ``compute_dtype = bfloat16`` through the port on
the CPU against the JAX package, from one JAX-written model file: serving
(the full-sequence forward that ``predict`` runs, and the KV-cached
``decode`` that ``generate`` runs, teacher-forced) and one training step
(loss and every gradient), with grouped-query heads, a window and RoPE on
one of the two configs. On the CPU the attention layers take the flash
kernel's plain version at L 128 (flash_fwd_ref / flash_bwd_ref, which sum
in f32 whatever the input dtype) where the JAX package runs dense
attention in bf16.

The rule: the port's bf16 error against the JAX package's bf16 result is
at most twice the JAX package's own bf16-versus-float32 error, plus
1e-3, each error the largest difference over the largest float32
magnitude of the tensor (probabilities; each gradient, worst over the
net; the loss relative). The KV-cached decode's probabilities are held
to the JAX bf16 full forward's by the same rule. Measured with both
packages on the CPU (JAX bf16 vs f32 -> port bf16 vs JAX bf16):
probabilities 5.0e-4 -> 4.8e-4 (MHA; the decode's 4.9e-4) and 4.1e-4 ->
4.9e-4 (GQA, window, RoPE; the decode's 4.8e-4); gradients 0.15 -> 0.094
and 0.19 -> 0.12 at most; the loss 5.0e-7 -> 2.5e-7 and 3.3e-7 -> 8.4e-7
relative. float32: everything within 1e-5 (gradients 8.4e-7 of their
largest at most).
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu import api as japi
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import models

from tests.test_torch_googlenet import _err, _jax_forward_backward

SEQ, BATCH, VOCAB = 128, 2, 300
BF16 = "compute_dtype = bfloat16\n"
ATTN = {"mha": "", "gqa_window_rope": "nkvhead = 2\nattn_window = 48\n"
                                      "rope = 1\n"}


def _cfg(attn, extra=""):
    return models.transformer_lm_config(
        vocab=VOCAB, seq=SEQ, batch_size=BATCH, dim=64, nhead=4, nlayer=2,
        dev="cpu", attn_extra=ATTN[attn], extra_cfg=extra)


def _batch():
    rng = np.random.RandomState(11)
    return (rng.randint(0, VOCAB, (BATCH, 1, 1, SEQ)).astype(np.float32),
            rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.float32))


def _run(pkg, cfg, fname, x, y):
    """(full-forward probabilities, loss, gradients, teacher-forced decode
    probabilities or None) of one package's LM."""
    net = (japi if pkg == "jax" else tapi).Net(dev="cpu", cfg=cfg)
    net.load_model(fname)
    tr = net.net_
    last = tr.net_cfg.param.num_nodes - 1
    if pkg == "jax":
        probs, loss, grads = _jax_forward_backward(tr, x, y, last)
        return probs, loss, grads, None
    from cxxnet_tpu_torch.io import DataBatch
    b = DataBatch()
    b.data, b.label, b.batch_size = x, y, BATCH
    values, _, loss, grads = tr._forward_backward(
        b, torch.Generator().manual_seed(0),
        [(i, k) for i, p in enumerate(tr.params) for k in p])
    probs = values[last].detach().float().numpy()
    grads = iter(grads)
    grads = [{k: next(grads).numpy() for k in p} for p in tr.params]
    # the decode loop teacher-forced on x: prefill of 64, then one step a
    # position; probabilities of positions 0 .. SEQ - 2
    dec = np.zeros((BATCH, VOCAB, SEQ - 1), np.float32)

    def keep(t0, p):
        dec[:, :, t0:t0 + p.shape[2]] = p.float().numpy()
    toks = torch.from_numpy(x.reshape(BATCH, SEQ)).long()
    tr.decode(toks, torch.full((BATCH,), SEQ), 64, SEQ, on_probs=keep)
    return probs, float(loss), grads, dec


@pytest.fixture(scope="module", params=sorted(ATTN))
def runs(request, tmp_path_factory):
    attn = request.param
    fname = str(tmp_path_factory.mktemp(attn) / "jax.model")
    net = japi.Net(dev="cpu", cfg=_cfg(attn))
    net.init_model()
    net.save_model(fname)
    x, y = _batch()
    return {(dt, pkg): _run(pkg, _cfg(attn, extra), fname, x, y)
            for dt, extra in (("f32", ""), ("bf16", BF16))
            for pkg in ("jax", "port")}


def test_float32_matches_jax(runs):
    jp, jl, jg, _ = runs[("f32", "jax")]
    tp, tl, tg, td = runs[("f32", "port")]
    assert _err(tp, jp, jp) <= 1e-5
    assert _err(td, jp[:, :, 0, :-1], jp) <= 1e-5
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(tg, jg):
        for k in b:
            assert _err(a[k], b[k], b[k]) <= 1e-5, k


def test_bfloat16_serving_within_twice_jax_own_error(runs):
    fp = runs[("f32", "jax")][0]
    jp = runs[("bf16", "jax")][0]
    tp, _, _, td = runs[("bf16", "port")]
    own = _err(jp, fp, fp)
    assert _err(tp, jp, fp) <= 2 * own + 1e-3
    assert _err(td, jp[:, :, 0, :-1], fp) <= 2 * own + 1e-3


def test_bfloat16_step_within_twice_jax_own_error(runs):
    _, fl, fg, _ = runs[("f32", "jax")]
    _, jl, jg, _ = runs[("bf16", "jax")]
    _, tl, tg, _ = runs[("bf16", "port")]
    assert abs(tl - jl) / abs(fl) <= 2 * abs(jl - fl) / abs(fl) + 1e-3
    worst_port = max(_err(a[k], b[k], c[k])
                     for a, b, c in zip(tg, jg, fg) for k in c)
    worst_jax = max(_err(b[k], c[k], c[k]) for b, c in zip(jg, fg)
                    for k in c)
    assert worst_port <= 2 * worst_jax + 1e-3, (worst_port, worst_jax)
