"""The port's LM training slice on the CPU, against the JAX package: a small
transformer LM (vocab 64, d_model 32, 4 heads of width 8, 2 blocks) at
L 128 and 256, so that every attention layer of the port takes the flash
path (flash_fwd_ref and flash_bwd_ref on CPU tensors), as MHA and with
``nkvhead 1, attn_window 64, rope 1``. The JAX package inits and writes
the model file; both packages load it and take 3 Adam updates (the
config's own, eta 0.003) on the same numpy batches of random ids. Before
every update the loss and every gradient are compared, after it every
parameter and the Adam state. Then the port writes a model file with its
Adam state, the JAX package loads it and both take one more update.

Tolerances and why:

- loss: relative 1e-5. The packages sum the products and softmaxes in
  other orders (XLA's CPU kernels and JAX's dense attention against
  PyTorch's and the port's flash path).
- gradients of the first update, from identical parameters: 1e-5 of each
  tensor's largest magnitude, for the same reason.
- gradients of the later updates: 1e-4 of each tensor's largest magnitude.
  They are taken at parameters that already differ by the next bound.
- parameters after each update: 1e-2 of eta. Adam moves an element by
  about eta g / (|g| + 3.2e-7) on its first step (beta2 = 0.999, epsilon
  1e-8), so an element whose gradient is near zero turns a gradient
  difference of a few f32 ulps of the tensor's largest term into an
  update difference of a visible share of eta. It is held to eta, not to
  the parameter's own size.
- Adam's m1 and m2: 1e-4 of each tensor's largest magnitude, as the
  gradients they average.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu import api as japi
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import models
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.ops import flash_attn

VOCAB, DIM, NHEAD, NLAYER, BATCH, ETA = 64, 32, 4, 2, 4, 0.003
EXTRA = {"mha": "", "gqa_window_rope": "nkvhead = 1\nattn_window = 64\n"
                                       "rope = 1\n"}
LOSS_RTOL, GRAD_TOL_FIRST, GRAD_TOL, PARAM_TOL_ETA, ADAM_TOL = \
    1e-5, 1e-5, 1e-4, 1e-2, 1e-4


def _cfg(seq, extra):
    return models.transformer_lm_config(
        vocab=VOCAB, seq=seq, batch_size=BATCH, dim=DIM, nhead=NHEAD,
        nlayer=NLAYER, dev="cpu", attn_extra=EXTRA[extra])


def _batches(seq, n, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (BATCH, 1, 1, seq)).astype(np.float32),
             rs.randint(0, VOCAB, (BATCH, seq)).astype(np.float32))
            for _ in range(n)]


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    """model_file(seq, extra): a model file the JAX package initialised and
    wrote, made once."""
    made = {}

    def get(seq, extra):
        if (seq, extra) not in made:
            net = japi.Net(dev="cpu", cfg=_cfg(seq, extra))
            net.init_model()
            made[seq, extra] = str(tmp_path_factory.mktemp("lm") /
                                   "jax.model")
            net.save_model(made[seq, extra])
        return made[seq, extra]
    return get


def _pair(fname, cfg):
    jnet = japi.Net(dev="cpu", cfg=cfg)
    jnet.load_model(fname)
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.load_model(fname)
    return jnet, tnet


def _jax_loss_and_grads(jt, x, y):
    """The loss and gradients of the forward JAX's next update takes."""
    rng = jax.random.fold_in(jax.random.PRNGKey(jt.seed),
                             jt._rng_counter + 1)
    (loss, _), grads = jax.value_and_grad(jt._loss_fn, has_aux=True)(
        jt.params, jnp.asarray(x), jnp.asarray(y), rng,
        jnp.asarray(jt.epoch_counter, jnp.int32))
    return float(loss), grads


def _batch(x, y):
    b = DataBatch()
    b.data, b.label, b.batch_size = x, y, x.shape[0]
    return b


def _close_rel(got, want, tol, what):
    got = got.detach().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _check_step(jnet, tnet, x, y, grad_tol, what):
    jt, tt = jnet.net_, tnet.net_
    jloss, jgrads = _jax_loss_and_grads(jt, x, y)
    tloss, tgrads = tt.loss_and_grads(_batch(x, y))
    np.testing.assert_allclose(float(tloss), jloss, rtol=LOSS_RTOL,
                               err_msg=what + " loss")
    for i, (jg, tg) in enumerate(zip(jgrads, tgrads)):
        assert sorted(jg) == sorted(tg)
        for k in jg:
            _close_rel(tg[k], jg[k], grad_tol,
                       "%s: gradient of layer %d %s" % (what, i, k))
    jnet.update(x, y)
    tnet.update(x, y)
    assert tt.epoch_counter == jt.epoch_counter
    for i, (jp, tp) in enumerate(zip(jt.canonical_params(), tt.params)):
        for k in jp:
            np.testing.assert_allclose(
                tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                atol=PARAM_TOL_ETA * ETA,
                err_msg="%s: layer %d %s after the update" % (what, i, k))
    for i, (js, ts) in enumerate(zip(jt.opt_state, tt.opt_state)):
        for k in js:
            assert sorted(js[k]) == sorted(ts[k]) == ["m1", "m2"]
            for sk in js[k]:
                _close_rel(ts[k][sk], js[k][sk], ADAM_TOL,
                           "%s: layer %d %s/%s" % (what, i, k, sk))


@pytest.mark.parametrize("extra", sorted(EXTRA))
@pytest.mark.parametrize("seq", [128, 256])
def test_lm_updates_match_jax(model_file, seq, extra):
    assert flash_attn.supports(seq, DIM // NHEAD)
    jnet, tnet = _pair(model_file(seq, extra), _cfg(seq, extra))
    before = (flash_attn.launches, flash_attn.dq_launches,
              flash_attn.dkv_launches)
    for step, (x, y) in enumerate(_batches(seq, 3)):
        _check_step(jnet, tnet, x, y,
                    GRAD_TOL_FIRST if step == 0 else GRAD_TOL,
                    "%s L %d update %d" % (extra, seq, step + 1))
    # CPU tensors: the plain versions, no kernel launch
    assert (flash_attn.launches, flash_attn.dq_launches,
            flash_attn.dkv_launches) == before


@pytest.mark.parametrize("extra", sorted(EXTRA))
def test_jax_continues_from_the_ports_model_file(model_file, tmp_path,
                                                 extra):
    seq = 128
    cfg = _cfg(seq, extra)
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.load_model(model_file(seq, extra))
    batches = _batches(seq, 4, seed=3)
    for x, y in batches[:3]:
        tnet.update(x, y)
    fname = str(tmp_path / "port.model")
    tnet.save_model(fname)
    jnet = japi.Net(dev="cpu", cfg=cfg)
    jnet.load_model(fname)
    jt, tt = jnet.net_, tnet.net_
    assert jt.epoch_counter == tt.epoch_counter == 3
    for jp, tp in zip(jt.canonical_params(), tt.params):
        for k in jp:
            np.testing.assert_array_equal(np.asarray(jp[k]),
                                          tp[k].detach().numpy())
    for js, ts in zip(jt.opt_state, tt.opt_state):
        for k in js:
            for sk in js[k]:
                np.testing.assert_array_equal(np.asarray(js[k][sk]),
                                              ts[k][sk].numpy())
    # one more update on both sides from the same state
    _check_step(jnet, tnet, *batches[3], GRAD_TOL_FIRST,
                "%s update 4 from the port's file" % extra)


def test_integer_token_ids_train_as_float_ids(model_file):
    # ids handed over as int64 stay integer up to the embedding and give
    # the same loss and gradients as the same ids in float32
    cfg = _cfg(128, "mha")
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.load_model(model_file(128, "mha"))
    tt = tnet.net_
    x, y = _batches(128, 1, seed=5)[0]
    assert tt._input(x.astype(np.int64)).dtype == torch.int64
    assert tt._input(x).dtype == torch.float32
    loss_f, grads_f = tt.loss_and_grads(_batch(x, y))
    loss_i, grads_i = tt.loss_and_grads(_batch(x.astype(np.int64), y))
    assert float(loss_f) == float(loss_i)
    for gf, gi in zip(grads_f, grads_i):
        for k in gf:
            assert torch.equal(gf[k], gi[k])
    # loss_and_grads steps nothing
    assert tt.epoch_counter == 0 and tt._rng_counter == 0
