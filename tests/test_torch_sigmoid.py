"""The port's ``sigmoid`` layer against the JAX SigmoidLayer
(cxxnet_tpu/layer/layers.py:298-300) on the CPU: forward and input
gradient on seeded inputs, in eval and in training mode, including inputs
far out in both tails; and one update of example/MNIST/MNIST.conf's net
(fullc, sigmoid, fullc, softmax) from a JAX-written model file.

Tolerance: relative 1e-6 plus 1e-6 of the largest magnitude (both sides
compute 1 / (1 + e^-x) in float32 with their own exp); the update is
held as tests/test_torch_train.py holds a step (1e-5).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu import api as japi
from cxxnet_tpu_torch import api as tapi

from tests.test_torch_insanity import _check, _run
from tests.test_torch_train import _assert_same_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(4, 6, 5, 5), (3, 1, 1, 100)])
def test_sigmoid_matches_jax(train, shape):
    _check(_run("sigmoid", [], shape, train))


def test_sigmoid_tails_match_jax():
    from cxxnet_tpu.layer.layers import SigmoidLayer as J
    from cxxnet_tpu_torch.layer.layers import SigmoidLayer as T
    x = np.array([-120., -88., -30., -1e-3, 0., 1e-3, 30., 88., 120.],
                 np.float32).reshape(1, 1, 1, 9)
    want = np.asarray(J().apply({}, [jnp.asarray(x)], None)[0])
    got = T().forward({}, [torch.from_numpy(x)], None)[0].numpy()
    # at -88 the sigmoid is subnormal (6.1e-39), which XLA's CPU code
    # flushes to 0: the smallest normal float32 is the absolute bar
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=np.finfo(np.float32).tiny)
    assert np.isfinite(got).all()


def test_mnist_net_update_matches_jax(tmp_path):
    cfg = open(os.path.join(REPO, "example/MNIST/MNIST.conf")).read()
    cfg = cfg.replace("dev = cpu", "dev = cpu\nbatch_size = 20")
    jnet = japi.Net(dev="cpu", cfg=cfg)
    jnet.init_model()
    fname = str(tmp_path / "m.model")
    jnet.save_model(fname)
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.load_model(fname)
    rng = np.random.RandomState(2)
    for _ in range(2):
        x = rng.rand(20, 784).astype(np.float32)
        y = rng.randint(0, 10, 20).astype(np.float32)
        jnet.update(x, y)
        tnet.update(x, y)
    _assert_same_state(jnet, tnet, "after 2 updates")
    x = rng.rand(20, 784).astype(np.float32)
    np.testing.assert_allclose(tnet.extract(x, "sg1"),
                               np.asarray(jnet.extract(x, "sg1")),
                               rtol=1e-5, atol=1e-6)
    assert jax.devices()[0].platform == "cpu"
