"""The port's updaters and schedules against the JAX package's, on the
same numpy-made weights, gradients and state, over 6 updates.

Tolerance: relative 1e-6 plus 1e-7 of the tensor's largest magnitude.
Both sides run the same float32 operations in the same order, with the
schedule's scalars computed in float32 on both; what differs is the
implementation of pow/cos/sqrt (an ulp or two) and whether a multiply-add
is fused, which moves a value by a few float32 ulps (2^-23 = 1.2e-7
relative) per update.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu import updater as jupd
from cxxnet_tpu_torch import updater as tupd

RTOL, ATOL_REL = 1e-6, 1e-7
EPOCHS = 6

# (updater kind, tag, config pairs in the order a config file gives them)
CASES = {
    "sgd_imagenet_wmat": ("sgd", "wmat", [
        ("momentum", "0.9"), ("wmat:lr", "0.01"), ("wmat:wd", "0.0005"),
        ("bias:wd", "0.000"), ("bias:lr", "0.02"), ("lr:schedule", "expdecay"),
        ("lr:gamma", "0.1"), ("lr:step", "2")]),
    "sgd_imagenet_bias": ("sgd", "bias", [
        ("momentum", "0.9"), ("wmat:lr", "0.01"), ("wmat:wd", "0.0005"),
        ("bias:wd", "0.000"), ("bias:lr", "0.02"), ("lr:schedule", "expdecay"),
        ("lr:gamma", "0.1"), ("lr:step", "2")]),
    "sgd_clip_nan": ("sgd", "wmat", [
        ("lr", "0.1"), ("clip_gradient", "0.5"), ("wd", "0.01")]),
    "sgd_polydecay": ("sgd", "wmat", [
        ("lr", "0.1"), ("lr:schedule", "polydecay"), ("lr:gamma", "0.5"),
        ("lr:alpha", "0.75"), ("lr:step", "2")]),
    "sgd_factor_floor": ("sgd", "wmat", [
        ("lr", "0.1"), ("lr:schedule", "factor"), ("lr:factor", "0.1"),
        ("lr:step", "1"), ("lr:minimum_lr", "0.0005")]),
    "sgd_lr_below_minimum": ("sgd", "wmat", [
        ("lr", "0.000003"), ("lr:schedule", "factor"), ("lr:step", "1")]),
    "sgd_start_epoch": ("sgd", "wmat", [
        ("lr", "0.1"), ("lr:schedule", "expdecay"), ("lr:gamma", "0.5"),
        ("lr:start_epoch", "3")]),
    "sgd_warmup": ("sgd", "wmat", [
        ("lr", "0.1"), ("lr:warmup", "4")]),
    "sgd_cosine": ("sgd", "wmat", [
        ("lr", "0.1"), ("lr:schedule", "cosine"), ("lr:total", "5"),
        ("lr:minimum_lr", "0.001")]),
    "sgd_momentum_schedule": ("sgd", "wmat", [
        ("lr", "0.05"), ("momentum_schedule", "1"), ("base_momentum", "0.5"),
        ("final_momentum", "0.9"), ("saturation_epoch", "4")]),
    "nag": ("nag", "wmat", [
        ("lr", "0.05"), ("momentum", "0.8"), ("wd", "0.001"),
        ("lr:schedule", "expdecay"), ("lr:gamma", "0.5")]),
    "adam": ("adam", "wmat", [
        ("lr", "0.01"), ("wd", "0.001"), ("wmat:beta1", "0.2"),
        ("beta2", "0.01")]),
    "adamw_cosine_clip": ("adamw", "bias", [
        ("lr", "0.01"), ("wd", "0.01"), ("lr:schedule", "cosine"),
        ("lr:total", "4"), ("lr:warmup", "2"), ("clip_gradient", "0.3"),
        ("bias:beta1", "0.8"), ("adam_eps", "1e-6")]),
}


def _pair(kind, tag, pairs):
    ju, tu = jupd.create_updater(kind, tag), tupd.create_updater(kind, tag)
    for k, v in pairs:
        ju.set_param(k, v)
        tu.set_param(k, v)
    return ju, tu


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    atol = ATOL_REL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_updater_matches_jax_over_six_updates(name):
    kind, tag, pairs = CASES[name]
    ju, tu = _pair(kind, tag, pairs)
    rng = np.random.RandomState(sorted(CASES).index(name))
    w0 = rng.randn(6, 9).astype(np.float32)
    jw, jst = w0, ju.init_state(w0)
    tw = torch.from_numpy(w0.copy())
    tst = tu.init_state(tw)
    assert sorted(tst) == sorted(jst)
    for sk in jst:
        # a fresh state, not yet the JAX one: start both from the same
        # nonzero values so the first update already reads the state
        init = (rng.rand(*w0.shape).astype(np.float32) * 0.1
                if sk == "m2" else rng.randn(*w0.shape).astype(np.float32)
                * 0.1)
        jst[sk] = init
        tst[sk] = torch.from_numpy(init.copy())
    for epoch in range(EPOCHS):
        g = rng.randn(*w0.shape).astype(np.float32) * 2
        if name == "sgd_clip_nan":
            g[0, :3] = np.nan
            g[1, 0] = np.inf
        jw, jst = ju.apply(jw, g, jst, epoch)
        tw, tst = tu.apply(tw, torch.from_numpy(g.copy()), tst, epoch)
        assert np.isfinite(tw.numpy()).all()
        _close(tw.numpy(), jw, "%s w after update %d" % (name, epoch))
        for sk in jst:
            _close(tst[sk].numpy(), jst[sk],
                   "%s %s after update %d" % (name, sk, epoch))


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_jax(name):
    kind, tag, pairs = CASES[name]
    ju, tu = _pair(kind, tag, pairs)
    for epoch in (0, 1, 2, 3, 4, 5, 6, 99, 100, 250):
        jlr, jmom = ju.param.schedule_epoch(epoch)
        tlr, tmom = tu.param.schedule_epoch(epoch)
        assert isinstance(tlr, float) and isinstance(tmom, float)
        np.testing.assert_allclose(tlr, float(jlr), rtol=RTOL, atol=0)
        np.testing.assert_allclose(tmom, float(jmom), rtol=RTOL, atol=0)


def test_lr_minimum_floors_but_never_raises():
    _, tu = _pair(*CASES["sgd_factor_floor"])
    assert tu.param.schedule_epoch(5)[0] == pytest.approx(0.0005, rel=1e-6)
    _, tu = _pair(*CASES["sgd_lr_below_minimum"])
    # base lr under the 1e-5 default minimum is honoured exactly
    assert tu.param.schedule_epoch(3)[0] == pytest.approx(3e-6, rel=1e-6)


def test_tag_scoped_overrides():
    _, wmat = _pair(*CASES["sgd_imagenet_wmat"])
    _, bias = _pair(*CASES["sgd_imagenet_bias"])
    assert (wmat.param.base_lr, wmat.param.wd) == (0.01, 0.0005)
    assert (bias.param.base_lr, bias.param.wd) == (0.02, 0.0)
    assert wmat.param.lr_schedule == bias.param.lr_schedule == 1


def test_cosine_needs_total():
    _, tu = _pair("sgd", "wmat", [("lr:schedule", "cosine")])
    with pytest.raises(ValueError, match="lr:total"):
        tu.param.schedule_epoch(0)


@pytest.mark.parametrize("layer, tag", [(0, "wmat"), (0, "bias"),
                                        (7, "wmat"), (12, "bias")])
def test_data_keys_match_jax(layer, tag):
    key = tupd.encode_data_key(layer, tag)
    assert key == jupd.encode_data_key(layer, tag)
    assert tupd.decode_tag(key) == tag


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="unknown updater"):
        tupd.create_updater("rmsprop", "wmat")
    with pytest.raises(ValueError, match="wmat or bias"):
        tupd.encode_data_key(0, "gamma")
    with pytest.raises(ValueError, match="invalid key"):
        tupd.decode_tag(2)
