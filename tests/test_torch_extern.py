"""The ``extern`` layer (the reference's caffe-plugin slot) of the port on
the CPU against the JAX package's: one op, y = x * scale + shift per
channel, registered as a jax function in the JAX package and as a torch
function in the port (``cxxnet_tpu_torch.layer.register_extern``). A
net of every new layer type with the op on its im2seq node takes one
training forward and one SGD update in both packages (held by
tests/test_torch_mobilenet.py's float32 bars); the weights are visited
under ``blob0`` (scale) and ``blob1`` (shift), so ``blob0:lr = 0`` freezes
the scale in both; the model file (LayerParam, the op name, the
settings, the weights by name) is byte for byte the JAX layer's, both
ways; ``caffe`` is an alias; an unregistered op is refused by name.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cxxnet_tpu import api as japi
from cxxnet_tpu.layer import register_extern as jregister
from cxxnet_tpu.layer.extern import _EXTERN_REGISTRY as JREG
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch.layer import register_extern
from cxxnet_tpu_torch.layer.extern import _EXTERN_REGISTRY as TREG
from tests.test_torch_layers_more import (misc_batch, misc_fixconn,
                                          misc_netconfig)
from tests.test_torch_mobilenet import check_float32, jax_and_port

EXTERN = """layer[sq->ex] = extern:ex
  op = scale_shift
  gain = 1.5
"""


class JaxScaleShift:
    def infer_shape(self, in_shapes, setting):
        return [in_shapes[0]]

    def init_params(self, rng, in_shapes, setting):
        c = in_shapes[0][1]
        return {"scale": np.full((c,), float(setting.get("gain", 1.0)),
                                 np.float32) + rng.rand(c).astype(np.float32),
                "shift": rng.randn(c).astype(np.float32) * 0.1}

    def apply(self, params, inputs, *, train, rng):
        return [inputs[0] * params["scale"][:, None, None]
                + params["shift"][:, None, None]]


class TorchScaleShift:
    seen = []

    def infer_shape(self, in_shapes, setting):
        return [in_shapes[0]]

    def init_params(self, gen, in_shapes, setting):
        c = in_shapes[0][1]
        return {"scale": torch.full((c,), float(setting.get("gain", 1.0)))
                + torch.rand(c, generator=gen),
                "shift": torch.randn(c, generator=gen) * 0.1}

    def apply(self, params, inputs, *, train, generator):
        self.seen.append((train, generator))
        return [inputs[0] * params["scale"][:, None, None]
                + params["shift"][:, None, None]]


@pytest.fixture(autouse=True)
def scale_shift():
    jregister("scale_shift", JaxScaleShift)
    op = register_extern("scale_shift", TorchScaleShift)
    op.seen.clear()
    yield op
    JREG.pop("scale_shift", None)
    TREG.pop("scale_shift", None)


def test_a_net_with_an_extern_op_trains_as_jax(tmp_path, scale_shift):
    cfg = misc_netconfig(misc_fixconn(tmp_path), EXTERN)
    x, y = misc_batch()
    r = jax_and_port(cfg, x, y, "ex")
    check_float32(r)
    # the op ran in training with the layer's generator
    assert any(train and isinstance(gen, torch.Generator)
               for train, gen in scale_shift.seen)


def test_blob_tags_follow_the_jax_layer(tmp_path):
    cfg = misc_netconfig(misc_fixconn(tmp_path), EXTERN.replace(
        "  gain = 1.5\n", "  gain = 1.5\n  blob0:lr = 0\n"))
    jn, tn = japi.Net(dev="cpu", cfg=cfg), tapi.Net(dev="cpu", cfg=cfg)
    jn.init_model()
    tn.init_model()
    i = tn.net_.net_cfg.get_layer_index("ex")
    assert tn.net_.net.layers[i].visit_order() == \
        jn.net_.net.layers[i].visit_order() == [("blob0", "scale"),
                                                 ("blob1", "shift")]
    x, y = misc_batch()
    r = jax_and_port(cfg, x, y, "ex", jax_net=jn)
    check_float32(r)
    before, after = r["port"][4][i], r["port"][3][i]
    np.testing.assert_array_equal(after["scale"].numpy(), before["scale"])
    assert not np.array_equal(after["shift"].numpy(), before["shift"])
    # the config's gain reached both ops' init
    assert (np.asarray(jn.net_.canonical_params()[i]["scale"]) >= 1.5).all()
    assert (tn.net_.params[i]["scale"] >= 1.5).all()


def test_model_file_bytes_equal_jax_both_ways(tmp_path):
    cfg = misc_netconfig(misc_fixconn(tmp_path), EXTERN)
    jn = japi.Net(dev="cpu", cfg=cfg)
    jn.init_model()
    jn.save_model(str(tmp_path / "jax.model"))
    tn = tapi.Net(dev="cpu", cfg=cfg)
    tn.load_model(str(tmp_path / "jax.model"))
    tn.save_model(str(tmp_path / "port.model"))
    assert (tmp_path / "port.model").read_bytes() == \
        (tmp_path / "jax.model").read_bytes()
    x, _ = misc_batch(2)
    np.testing.assert_allclose(tn.extract(x, "ex"), jn.extract(x, "ex"),
                               rtol=1e-5, atol=1e-6)
    # a port-initialised model loads in the JAX package and writes back the
    # same bytes
    tn = tapi.Net(dev="cpu", cfg=cfg)
    tn.init_model()
    tn.save_model(str(tmp_path / "port0.model"))
    jn = japi.Net(dev="cpu", cfg=cfg)
    jn.load_model(str(tmp_path / "port0.model"))
    jn.save_model(str(tmp_path / "jax0.model"))
    assert (tmp_path / "jax0.model").read_bytes() == \
        (tmp_path / "port0.model").read_bytes()


def test_caffe_alias_and_refusals(tmp_path):
    path = misc_fixconn(tmp_path)
    cfg = misc_netconfig(path, EXTERN.replace("extern:ex", "caffe:ex"))
    net = tapi.Net(dev="cpu", cfg=cfg)
    net.init_model()
    assert net.net_.net.layers[
        net.net_.net_cfg.get_layer_index("ex")].type_name == "extern"
    bad = misc_netconfig(path, EXTERN.replace("scale_shift", "no_such_op"))
    with pytest.raises(ValueError, match="'no_such_op' is not registered"):
        tapi.Net(dev="cpu", cfg=bad).init_model()
    with pytest.raises(ValueError, match="must set op"):
        tapi.Net(dev="cpu", cfg=misc_netconfig(
            path, EXTERN.replace("  op = scale_shift\n", ""))).init_model()

    class NoList(TorchScaleShift):
        def apply(self, params, inputs, *, train, generator):
            return inputs[0]
    register_extern("scale_shift", NoList)
    net = tapi.Net(dev="cpu", cfg=cfg)
    net.init_model()
    with pytest.raises(ValueError, match="must return a list"):
        net.predict(misc_batch()[0])
    with pytest.raises(ValueError, match="infer_shape"):
        register_extern("broken", object())


def test_jax_op_and_torch_op_agree_alone():
    """The two registrations compute the same function (the comparison
    above is of the nets, not of the ops)."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 1, 5).astype(np.float32)
    p = {"scale": rs.rand(3).astype(np.float32),
         "shift": rs.randn(3).astype(np.float32)}
    want = JaxScaleShift().apply({k: jnp.asarray(v) for k, v in p.items()},
                                 [jnp.asarray(x)], train=False, rng=None)[0]
    got = TorchScaleShift().apply({k: torch.from_numpy(v)
                                   for k, v in p.items()},
                                  [torch.from_numpy(x)], train=False,
                                  generator=None)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
