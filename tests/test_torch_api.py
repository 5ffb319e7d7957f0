"""The port's ``api.DataIter`` and ``api.train`` against ``cxxnet_tpu.api``
on the CPU: the same config-section strings give the same batches, and
``train`` over a DataIter (with an eval DataIter) or over numpy gives the
same weights and eval lines when both start from one JAX-written model
file (each package's ``init_model`` is pointed at it, since their random
initializations draw different bits). ``Net.update`` / ``evaluate`` /
``predict`` / ``extract`` take a DataIter as the JAX Net does.

Weights are held as tests/test_torch_train.py holds a step (relative 1e-5
plus 1e-5 of the tensor's largest magnitude), with the absolute part
taken once per step (12 steps over 2 rounds of 6).
"""

import contextlib
import io
import os

import numpy as np
import pytest

from cxxnet_tpu import api as japi
from cxxnet_tpu_torch import api as tapi

from tests.synth_mnist import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NET = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 32
  init_sigma = 0.01
layer[+1:sg1] = sigmoid:se1
layer[sg1->fc2] = fullc:fc2
  nhidden = 10
  init_sigma = 0.01
layer[+0] = softmax
netconfig=end
input_shape = 1,1,784
batch_size = 100
eta = 0.1
momentum = 0.9
metric = error
"""


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("api")), n_train=600,
                        n_test=200)


def _iter_cfg(paths, part="train", extra=""):
    img, lab = (("train_img", "train_lab") if part == "train"
                else ("test_img", "test_lab"))
    return ("iter = mnist\n  path_img = \"%s\"\n  path_label = \"%s\"\n"
            "  shuffle = %d\n  silent = 1\n%s  batch_size = 100\n"
            "iter = end\n" % (paths[img], paths[lab], part == "train",
                              extra))


@pytest.mark.parametrize("extra", ["", "iter = threadbuffer\n"])
def test_dataiter_matches_jax(mnist, extra):
    cfg = _iter_cfg(mnist, extra=extra)
    got, want = tapi.DataIter(cfg), japi.DataIter(cfg)
    with pytest.raises(RuntimeError):
        got.get_data()
    for _ in range(2):
        got.before_first()
        want.before_first()
        n = 0
        while want.next():
            assert got.next()
            np.testing.assert_array_equal(got.get_data(), want.get_data())
            np.testing.assert_array_equal(got.get_label(), want.get_label())
            n += 1
        assert not got.next() and n == 6
    got.close()


def test_dataiter_batches_outlive_next_like_jax(mnist):
    """A threadbuffer hands out batches of their own, as the JAX DataIter
    does: arrays kept across ``next()`` keep their values."""
    cfg = _iter_cfg(mnist, extra="iter = threadbuffer\n")
    got, want = tapi.DataIter(cfg), japi.DataIter(cfg)
    kept = {"got": [], "want": []}
    for it, out in ((got, kept["got"]), (want, kept["want"])):
        it.before_first()
        while it.next():
            out.append((it.get_data(), it.get_label()))
    got.close()
    assert len(kept["got"]) == len(kept["want"]) == 6
    for (gd, gl), (wd, wl) in zip(kept["got"], kept["want"]):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    assert not np.array_equal(kept["got"][0][0], kept["got"][1][0])


@pytest.fixture
def jax_init(tmp_path, monkeypatch):
    """Point both packages' init_model at one model file that the JAX
    package initialized."""
    net = japi.Net(dev="cpu", cfg=NET)
    net.init_model()
    fname = str(tmp_path / "init.model")
    net.save_model(fname)
    for mod in (japi, tapi):
        monkeypatch.setattr(mod.Net, "init_model",
                            lambda self: self.load_model(fname))
    return fname


def _same_weights(tnet, jnet, steps):
    for layer in ("fc1", "fc2"):
        for tag in ("wmat", "bias"):
            want = np.asarray(jnet.get_weight(layer, tag))
            np.testing.assert_allclose(
                tnet.get_weight(layer, tag), want, rtol=1e-5,
                atol=steps * 1e-5 * float(np.abs(want).max()),
                err_msg="%s %s" % (layer, tag))


def test_train_over_dataiters_matches_jax(mnist, jax_init):
    nets, lines = {}, {}
    for name, api in (("port", tapi), ("jax", japi)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            nets[name] = api.train(
                NET, api.DataIter(_iter_cfg(mnist)), 2, {"eta": "0.1"},
                eval_data=api.DataIter(_iter_cfg(mnist, "test")), dev="cpu")
        lines[name] = err.getvalue().splitlines()
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 2
    assert lines["jax"][0].startswith("\ttrain-error:")
    _same_weights(nets["port"], nets["jax"], 12)


def test_train_on_numpy_matches_jax(jax_init):
    rng = np.random.RandomState(5)
    x = rng.rand(100, 784).astype(np.float32)
    y = rng.randint(0, 10, 100).astype(np.float32)
    tnet = tapi.train(NET, x, 3, [("momentum", "0.5")], label=y, dev="cpu")
    jnet = japi.train(NET, x, 3, [("momentum", "0.5")], label=y, dev="cpu")
    _same_weights(tnet, jnet, 3)


def test_net_takes_a_dataiter_like_jax(mnist, jax_init):
    cfg = _iter_cfg(mnist, "test")
    out = {}
    for name, api in (("port", tapi), ("jax", japi)):
        net = api.Net(dev="cpu", cfg=NET)
        net.init_model()
        it = api.DataIter(cfg)
        it.before_first()
        assert it.next()
        net.update(it)
        with pytest.raises((ValueError, AssertionError)):
            net.update(it, label=np.zeros(100))
        out[name] = (net.predict(it), net.extract(it, "sg1"),
                     net.evaluate(it, "test"))
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=1e-5,
                               atol=1e-6)
    assert out["port"][2] == out["jax"][2]
