"""The RReLU slice on the CPU against the JAX package: the layers
``insanity``, ``insanity_max_pooling``, ``xelu`` and ``prelu``, their
forward and gradients, eval mode and the annealed bounds; PReLU's slope
through model files and ``params_from_jax``; and a whole training step of
a narrow RReLU form of example/kaggle_bowl/bowl.conf (the net of Xu et
al., arXiv:1505.00853).

The layers draw their noise through ``layers.draw_uniform``. The JAX
layers draw ``jax.random.uniform(ctx.rng, x.shape)`` on the CPU
(cxxnet_tpu/layer/layers.py:394, :427, :781), so the tests hand the port
that very draw: the arithmetic is then the same on both sides and is held
to 1e-6 (relative, plus 1e-6 of the largest magnitude compared: the
pooling's gradient is a scatter-add whose few terms may be summed in
another order). The whole-net step runs where both packages are
deterministic (``lb == ub``, ``keep = 1``, dropout off) with the weights
carried over by ``params_from_jax``, held as tests/test_torch_train.py
holds AlexNet's steps (1e-5).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu import api as japi
from cxxnet_tpu.layer import factory as jfactory
from cxxnet_tpu.layer.base import ApplyContext as JContext
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import convert, models
from cxxnet_tpu_torch.layer import factory as tfactory
from cxxnet_tpu_torch.layer import layers as tlayers
from cxxnet_tpu_torch.layer.base import ApplyContext
from cxxnet_tpu_torch.ops import random as trandom

from tests.test_torch_train import _assert_same_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _close(got, want, what="", tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _pair(name, keys, shape):
    """(JAX layer, port layer, output shape) of type ``name`` with
    ``keys``, shapes inferred for an input of ``shape``."""
    out = []
    for fac in (jfactory, tfactory):
        lay = fac.create_layer(fac.get_layer_type(name))
        for k, v in keys:
            lay.set_param(k, v)
        out_shape = lay.infer_shape([shape])[0]
        out.append(lay)
    return out[0], out[1], out_shape


def _run(name, keys, shape, train, epoch=0, seed=0, monkeypatch=None,
         params=None):
    """Forward and gradients (input, then each parameter) of the layer in
    both packages on one seeded input, the port given the JAX draw."""
    jlay, tlay, out_shape = _pair(name, keys, shape)
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*out_shape).astype(np.float32)
    params = params if params is not None else \
        {k: np.asarray(v) for k, v in jlay.init_params(rng).items()}
    key = jax.random.PRNGKey(seed + 100)
    if monkeypatch is not None:
        monkeypatch.setattr(tlayers, "draw_uniform", lambda ctx, s, dev:
                            torch.from_numpy(np.array(jax.random.uniform(
                                key, tuple(s), jnp.float32))))
    jctx = JContext(train=train, rng=key, epoch=jnp.int32(epoch))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jout, vjp = jax.vjp(lambda x_, p_: jlay.apply(p_, [x_], jctx)[0],
                        jnp.asarray(x), jp)
    jdx, jdp = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    tctx = ApplyContext(train=train, epoch=epoch,
                        gen=torch.Generator().manual_seed(seed))
    tout = tlay.forward(tp, [xt], tctx)[0]
    tout.backward(torch.from_numpy(g))
    return ((tout, np.asarray(jout)), (xt.grad, np.asarray(jdx)),
            [(tp[k].grad, np.asarray(jdp[k])) for k in sorted(params)])


def _check(res):
    (out, jout), (dx, jdx), dparams = res
    _close(out, jout, "out")
    _close(dx, jdx, "dx")
    for dp, jdp in dparams:
        _close(dp, jdp, "dparam")


INSANITY = [("lb", "3"), ("ub", "8")]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(4, 6, 9, 9), (3, 1, 1, 20)])
def test_insanity_matches_jax(monkeypatch, train, shape):
    _check(_run("insanity", INSANITY, shape, train, monkeypatch=monkeypatch))


def test_insanity_default_bounds_match_jax(monkeypatch):
    _check(_run("insanity", [], (2, 5, 7, 7), True, monkeypatch=monkeypatch))


CALM = INSANITY + [("calm_start", "10"), ("calm_end", "30")]


@pytest.mark.parametrize("epoch", [0, 10, 17, 29, 30, 45])
def test_insanity_annealed_bounds_match_jax(monkeypatch, epoch):
    jlay, tlay, _ = _pair("insanity", CALM, (2, 3, 4, 4))
    jb = [float(v) for v in jlay._bounds(jnp.int32(epoch))]
    tb = tlay._bounds(epoch)
    np.testing.assert_allclose(tb, jb, rtol=TOL)
    # before the schedule the configured bounds, after it the midpoint
    if epoch <= 10:
        assert tb == (3.0, 8.0)
    if epoch >= 30:
        assert tb == (5.5, 5.5)
    _check(_run("insanity", CALM, (2, 3, 6, 6), True, epoch=epoch,
                monkeypatch=monkeypatch))
    # eval divides by the configured mean, not the annealed one
    _check(_run("insanity", CALM, (2, 3, 6, 6), False, epoch=epoch))


POOL = [("kernel_size", "3"), ("stride", "2")]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("keep", ["0.75", "0.2"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 13), (2, 4, 9, 10)])
def test_insanity_pooling_matches_jax(monkeypatch, train, keep, shape):
    _check(_run("insanity_max_pooling", POOL + [("keep", keep)], shape,
                train, monkeypatch=monkeypatch))


def test_insanity_pooling_displaces_each_way(monkeypatch):
    # keep 0: every pixel is displaced; each of the four bands of the flag
    # takes its value from the pixel above, below, left or right of it,
    # clamped to the image
    flag = torch.tensor([0.1, 0.3, 0.6, 0.9]).reshape(1, 4, 1, 1) \
        .expand(1, 4, 3, 3).contiguous()
    monkeypatch.setattr(tlayers, "draw_uniform", lambda ctx, s, dev: flag)
    lay = tlayers.InsanityPoolingLayer()
    for k, v in [("kernel_size", "1"), ("stride", "1"), ("keep", "0")]:
        lay.set_param(k, v)
    lay.infer_shape([(1, 4, 3, 3)])
    img = torch.arange(9.0).reshape(3, 3)
    out = lay.forward({}, [img.expand(1, 4, 3, 3).contiguous()],
                      ApplyContext(train=True))[0][0]
    rows, cols = torch.arange(3), torch.arange(3)
    up, down = (rows - 1).clamp_min(0), (rows + 1).clamp_max(2)
    left, right = (cols - 1).clamp_min(0), (cols + 1).clamp_max(2)
    assert torch.equal(out[0], img[up])
    assert torch.equal(out[1], img[down])
    assert torch.equal(out[2], img[:, left])
    assert torch.equal(out[3], img[:, right])


@pytest.mark.parametrize("shape", [(4, 6, 5, 5), (3, 1, 1, 12)])
def test_xelu_matches_jax(shape):
    _check(_run("xelu", [("b", "3.5")], shape, True))
    _check(_run("xelu", [], shape, False))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("keys", [[], [("random", "0.3")],
                                  [("random_slope", "1"),
                                   ("init_slope", "0.8"),
                                   ("random", "0.5")]], ids=str)
@pytest.mark.parametrize("shape", [(4, 6, 5, 5), (3, 1, 1, 12)])
def test_prelu_matches_jax(monkeypatch, train, keys, shape):
    # the slope's gradient sums over the batch and the positions
    _check(_run("prelu", keys, shape, train, monkeypatch=monkeypatch))


def test_prelu_slopes_outside_unit_interval_are_clipped(monkeypatch):
    slope = np.array([-0.5, 0.3, 1.7], np.float32)
    _check(_run("prelu", [], (2, 3, 4, 4), False, params={"slope": slope}))
    _check(_run("prelu", [("random", "0.9")], (2, 3, 4, 4), True,
                params={"slope": slope}, monkeypatch=monkeypatch))


def test_draw_is_the_layer_seeds_philox_stream():
    gen = torch.Generator().manual_seed(1234567)
    ctx = ApplyContext(train=True, gen=gen)
    got = tlayers.draw_uniform(ctx, (2, 3, 5), torch.device("cpu"))
    assert torch.equal(got, trandom.uniform_ref(1234567, (2, 3, 5)))
    # the generator is not advanced: dropout after a noisy layer draws
    # what it would have drawn alone
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=torch.Generator()
                                  .manual_seed(1234567)))


PRELU_NET = """
netconfig = start
layer[0->1] = fullc:fc1
  nhidden = 12
layer[1->2] = prelu:pr
  random_slope = 1
  init_slope = 0.6
layer[2->3] = fullc:fc2
  nhidden = 5
layer[3->3] = softmax
netconfig = end
input_shape = 1,1,7
batch_size = 4
"""


def test_prelu_slope_moves_through_model_files_and_params_from_jax(tmp_path):
    jnet = japi.Net(dev="cpu", cfg=PRELU_NET)
    jnet.init_model()
    fname = str(tmp_path / "prelu.model")
    jnet.save_model(fname)
    tnet = tapi.Net(dev="cpu", cfg=PRELU_NET)
    tnet.load_model(fname)
    want = np.asarray(jnet.net_.canonical_params()[1]["slope"])
    assert want.shape == (12,) and not np.all(want == want[0])
    np.testing.assert_array_equal(tnet.net_.params[1]["slope"].numpy(), want)
    # the reference visits the slope under the bias tag
    np.testing.assert_array_equal(tnet.get_weight("pr", "bias"),
                                  jnet.get_weight("pr", "bias"))
    ported = convert.params_from_jax(jnet.net_.canonical_params(),
                                     tnet.net_.net, torch.device("cpu"))
    np.testing.assert_array_equal(ported[1]["slope"].numpy(), want)
    # and back: the port's file loads in the JAX package
    tnet.set_weight(np.full((1, 12), 0.125, np.float32), "pr", "bias")
    tnet.save_model(fname)
    jnet.load_model(fname)
    np.testing.assert_array_equal(
        np.asarray(jnet.net_.canonical_params()[1]["slope"]), 0.125)
    x = np.random.RandomState(3).randn(4, 7).astype(np.float32)
    _close(tnet.extract(x, "top[-1]"), jnet.extract(x, "top[-1]"), tol=1e-5)


# the narrow RReLU bowl net: bowl.conf's layers at an eighth of its conv
# widths, 32 and 10 hidden units, with its optimizer and init keys
BOWL_KEYS = ("metric", "input_shape", "momentum", "wmat:lr", "wmat:wd",
             "bias:wd", "bias:lr", "lr:schedule", "lr:gamma", "lr:step",
             "random_type", "init_sigma")


def bowl_cfg(lb=3.0, ub=8.0, keep=0.75, threshold=0.5, rows=8):
    text = open(os.path.join(REPO, "example/kaggle_bowl/bowl.conf")).read()
    a = text.index("netconfig=start")
    b = text.index("netconfig=end") + len("netconfig=end")
    net = re.sub(r"nchannel = (\d+)",
                 lambda m: "nchannel = %d" % (int(m.group(1)) // 8), text[a:b])
    net = net.replace("nhidden = 256", "nhidden = 32") \
        .replace("nhidden = 121", "nhidden = 10") \
        .replace("threshold = 0.5", "threshold = %g" % threshold)
    tail = [ln.strip() for ln in text[b:].splitlines()
            if ln.split("=")[0].strip() in BOWL_KEYS]
    return (models.rrelu_config(net, lb, ub, keep) + "\n" + "\n".join(tail)
            + "\nbatch_size = %d\n" % rows)


def _bowl_batches(n, rows=8, seed=21):
    rng = np.random.RandomState(seed)
    return [((rng.randn(rows, 3, 40, 40) * 50).astype(np.float32),
             rng.randint(0, 10, size=rows).astype(np.float32))
            for _ in range(n)]


def test_bowl_cfg_is_the_rrelu_net():
    cfg = bowl_cfg()
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.init_model()
    types = [lay.type_name for lay in tnet.net_.net.layers]
    assert types.count("insanity") == 4 and "relu" not in types
    assert types.count("insanity_max_pooling") == 3
    assert "max_pooling" not in types


def test_bowl_step_matches_jax_where_both_are_deterministic():
    cfg = bowl_cfg(lb=5, ub=5, keep=1, threshold=0)
    jnet = japi.Net(dev="cpu", cfg=cfg)
    jnet.init_model()
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.init_model()
    tnet.net_.params = convert.params_from_jax(
        jnet.net_.canonical_params(), tnet.net_.net, torch.device("cpu"))
    batches = _bowl_batches(2)
    x0 = batches[0][0]
    _close(tnet.extract(x0, "top[-1]"), jnet.extract(x0, "top[-1]"),
           tol=1e-5)
    for step, (x, y) in enumerate(batches):
        jnet.update(x, y)
        tnet.update(x, y)
        _assert_same_state(jnet, tnet, "bowl step %d" % step)


def test_bowl_eval_with_noise_configured_matches_jax():
    # eval is deterministic in both packages: insanity divides by the
    # mean slope and the pooling does not move pixels
    cfg = bowl_cfg()
    jnet = japi.Net(dev="cpu", cfg=cfg)
    jnet.init_model()
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.init_model()
    tnet.net_.params = convert.params_from_jax(
        jnet.net_.canonical_params(), tnet.net_.net, torch.device("cpu"))
    x = _bowl_batches(1)[0][0]
    _close(tnet.extract(x, "top[-1]"), jnet.extract(x, "top[-1]"), tol=1e-5)


def test_noisy_bowl_training_is_seeded_per_step_and_layer(monkeypatch):
    seeds = []
    real = trandom.uniform

    def spy(seed, shape, device):
        seeds.append(seed)
        return real(seed, shape, device)
    monkeypatch.setattr(trandom, "uniform", spy)
    batches = _bowl_batches(2)

    def train(seed):
        net = tapi.Net(dev="cpu", cfg=bowl_cfg() + "seed = %d\n" % seed)
        net.init_model()
        for x, y in batches:
            net.update(x, y)
        return [{k: v.clone() for k, v in p.items()} for p in net.net_.params]
    before = trandom.launches
    a = train(1)
    assert trandom.launches == before      # the CPU never launches
    # 4 insanity and 3 pooling draws a step, each from a seed of its own
    assert len(seeds) == 14 and len(set(seeds)) == 14
    b = train(1)
    assert seeds[:14] == seeds[14:]
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a, b) for k in p)
    c = train(2)
    assert not all(torch.equal(p[k], q[k]) for p, q in zip(a, c) for k in p)
