"""The port's ``compute_dtype = bfloat16`` rules on the CPU against the JAX
package (cxxnet_tpu/nnet/net.py:140-172, 579-581, 640-645;
cxxnet_tpu/nnet/trainer.py:193-197, 920-921, 1694).

- The key takes float32, bfloat16 or bf16 and refuses anything else with
  the JAX package's message.
- The dtype of every node value of a training forward equals the JAX
  package's, on an image net with every layer type of this slice and on
  the LM: bf16 everywhere, except the loss layers' outputs (float32 inputs)
  and the integer-id nodes, never cast.
- Token ids above 256 (where bf16 has no integers) give the same forward
  as in float32 ids.
- The master weights, their gradients and batch-norm's running statistics
  are float32; an update leaves them float32.
- Loss layers take float32 inputs.
- ``predict``, ``extract`` and the CLI's ``pred_raw`` / ``extract`` hand
  out float32 arrays that hold bf16 values (the JAX package returns bf16
  arrays); the CLI prints them in the JAX CLI's format.
- The KV caches of a bf16 decode are bf16.
- The conv weight gradient accumulates in float32 and rounds once.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu import api as japi
from cxxnet_tpu import learn_task as jlt
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import learn_task as tlt
from cxxnet_tpu_torch import models, ops
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.layer import layers as tlayers

from tests.synth_mnist import make_dataset
from tests.test_torch_learn_task import PRED_SECTION, _rows, cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = "compute_dtype = bfloat16\n"

# every layer type of this slice, and the LRN kernel's layer
IMAGE_NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 8
  pad = 1
layer[1->2] = relu_max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = lrn
  local_size = 3
  alpha = 0.001
  beta = 0.75
layer[3->4,5,6] = split
layer[4->7] = conv:a
  kernel_size = 1
  nchannel = 4
layer[5->8] = avg_pooling
  kernel_size = 3
  stride = 1
  pad = 1
layer[6->9] = sum_pooling
  kernel_size = 3
  stride = 1
  pad = 1
layer[7,8,9->10] = ch_concat
layer[10->11] = batch_norm:bn
  moving_average = 1
layer[11->12] = flatten
layer[12->13] = fullc:f1
  nhidden = 6
layer[12->14] = fullc:f2
  nhidden = 6
layer[13,14->15] = concat
layer[15->15] = dropout
  threshold = 0.3
layer[15->16] = fullc:f3
  nhidden = 5
layer[16->16] = softmax
netconfig = end
input_shape = 3,9,9
batch_size = 4
eta = 0.05
momentum = 0.9
dev = cpu
"""


def _img_batch():
    rng = np.random.RandomState(2)
    return (rng.randn(4, 3, 9, 9).astype(np.float32),
            rng.randint(0, 5, 4).astype(np.float32))


def _lm_cfg(extra=""):
    return models.transformer_lm_config(vocab=600, seq=16, batch_size=2,
                                        dim=16, nhead=2, nlayer=1,
                                        dev="cpu", extra_cfg=extra)


def _lm_batch():
    rng = np.random.RandomState(4)
    # ids above 256: bf16 would round them
    return (rng.randint(300, 600, (2, 1, 1, 16)).astype(np.float32),
            rng.randint(0, 600, (2, 16)).astype(np.float32))


def _jax_node_dtypes(cfg, x, y):
    net = japi.Net(dev="cpu", cfg=cfg)
    net.init_model()
    tr = net.net_
    values, loss = tr.net.forward(
        tr.params, jnp.asarray(x), labels=tr.net.label_info_from(
            y.reshape(y.shape[0], -1)), train=True,
        rng=jax.random.PRNGKey(0))
    return [None if v is None else str(v.dtype) for v in values], \
        str(loss.dtype)


def _port_node_dtypes(cfg, x, y):
    net = tapi.Net(dev="cpu", cfg=cfg)
    net.init_model()
    tr = net.net_
    values, loss = tr.net.forward(
        tr.params, torch.from_numpy(x),
        labels=tr.net.label_info_from(torch.from_numpy(
            y.reshape(y.shape[0], -1))), train=True)
    return [None if v is None else str(v.dtype)[6:] for v in values], \
        str(loss.dtype)[6:]


@pytest.mark.parametrize("net", ["image", "lm"])
@pytest.mark.parametrize("extra", ["", BF16, "compute_dtype = bf16\n"])
def test_node_dtypes_match_jax(net, extra):
    cfg, (x, y) = (IMAGE_NET + extra, _img_batch()) if net == "image" \
        else (_lm_cfg(extra), _lm_batch())
    jd, jloss = _jax_node_dtypes(cfg, x, y)
    td, tloss = _port_node_dtypes(cfg, x, y)
    assert td == jd
    assert tloss == jloss == "float32"
    if extra:
        # the input (after its normalization) and every inner node compute
        # in bf16; the loss layer's node is float32
        assert "bfloat16" in td and td[-1] == "float32"


def test_compute_dtype_values():
    for val in ("float32", "bfloat16", "bf16"):
        tapi.Net(dev="cpu", cfg=IMAGE_NET + "compute_dtype = %s\n" % val)
    for mod in (japi, tapi):
        with pytest.raises(Exception, match="compute_dtype must be float32 "
                                            "or bfloat16"):
            mod.Net(dev="cpu", cfg=IMAGE_NET + "compute_dtype = float16\n") \
                .init_model()


def test_integer_ids_are_never_cast():
    net = tapi.Net(dev="cpu", cfg=_lm_cfg(BF16))
    net.init_model()
    tr = net.net_
    assert 0 in tr.net.id_nodes
    x, y = _lm_batch()
    as_float = torch.from_numpy(x)
    values, _ = tr.net.forward(tr.params, as_float)
    assert values[0].dtype == torch.float32
    assert torch.equal(values[0], as_float)
    ints, _ = tr.net.forward(tr.params, as_float.long())
    assert ints[0].dtype == torch.int64
    for a, b in zip(values[1:], ints[1:]):
        assert torch.equal(a, b)


def test_masters_and_gradients_stay_float32_and_loss_inputs_are_float32(
        monkeypatch):
    net = tapi.Net(dev="cpu", cfg=IMAGE_NET + BF16)
    net.init_model()
    tr = net.net_
    seen = []
    fwd = tlayers.SoftmaxLayer.forward

    def record(self, params, inputs, ctx):
        seen.extend(x.dtype for x in inputs)
        return fwd(self, params, inputs, ctx)
    monkeypatch.setattr(tlayers.SoftmaxLayer, "forward", record)
    x, y = _img_batch()
    b = DataBatch()
    b.data, b.label, b.batch_size = x, y.reshape(-1, 1), 4
    loss, grads = tr.loss_and_grads(b)
    assert seen == [torch.float32] and loss.dtype == torch.float32
    for g in grads:
        for v in g.values():
            assert v.dtype == torch.float32
    for _ in range(2):
        net.update(x, y)
    for p in tr.params:
        for k, v in p.items():
            assert v.dtype == torch.float32, k
    for st in tr.opt_state:
        for sub in st.values():
            for v in sub.values():
                assert v.dtype == torch.float32


def _is_bf16_valued(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return torch.equal(t.to(torch.bfloat16).float(), t)


def test_predict_and_extract_give_float32_arrays_of_bf16_values():
    net = tapi.Net(dev="cpu", cfg=IMAGE_NET + BF16)
    net.init_model()
    x, _ = _img_batch()
    for node in ("10", "15", "top[-1]"):
        out = net.extract(x, node)
        assert out.dtype == np.float32
        if node != "top[-1]":
            # inner nodes are bf16 values, exactly
            assert _is_bf16_valued(out)
    assert net.predict(x).dtype == np.float32
    assert net.predict_device(x).dtype == torch.float32


def test_bf16_decode_keeps_bf16_caches_and_float32_ids():
    net = tapi.Net(dev="cpu", cfg=_lm_cfg(BF16))
    net.init_model()
    prompts = _lm_batch()[0].reshape(2, 16)[:, :6].astype(np.int64)
    toks = net.generate(prompts, 4)
    assert toks.shape == (2, 4) and toks.dtype == np.int32
    caches = net.net_._net_for(2, 1)._last_cache_updates
    assert caches and all(c.dtype == torch.bfloat16 for c in caches.values())


def test_conv_weight_gradient_sums_in_float32():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(16, 8, 20, 20).astype(np.float32))
    g = torch.from_numpy(rng.randn(16, 6, 20, 20).astype(np.float32))
    want = ops.conv2d_weight(x.double(), (6, 8, 3, 3), g.double(), 1,
                             (1, 1), 1)
    got = ops.conv2d_weight(x.to(torch.bfloat16), (6, 8, 3, 3),
                            g.to(torch.bfloat16), 1, (1, 1), 1)
    assert got.dtype == torch.bfloat16
    # the bf16 inputs' own rounding, then one rounding of the f32 sum: a
    # sum in bf16 over 6,400 terms would be off by far more
    ref = ops.conv2d_weight(x.to(torch.bfloat16).double(), (6, 8, 3, 3),
                            g.to(torch.bfloat16).double(), 1, (1, 1), 1)
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert err <= 2.0 ** -8
    assert float((got.double() - want).abs().max() / want.abs().max()) < 0.02


@pytest.fixture(scope="module")
def mnist_models(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16cli")
    make_dataset(str(root / "data"), n_train=100, n_test=200)
    conf = root / "task.conf"
    conf.write_text(open(os.path.join(REPO, "example/MNIST/MNIST.conf"))
                    .read() + PRED_SECTION["mnist"] % 1)
    cli(jlt, str(conf), ["dev=cpu", "num_round=0", "model_dir=models"],
        str(root))
    return root, str(conf), str(root / "models" / "0000.model")


@pytest.mark.parametrize("task,extra", [
    ("pred_raw", []), ("extract", ["extract_node_name=fc1"]),
    ("extract", ["extract_node_name=fc1", "output_format=bin"])])
def test_cli_bf16_outputs_match_jax_format(mnist_models, task, extra):
    root, conf, model = mnist_models
    outs = {}
    for side, mod in (("jax", jlt), ("port", tlt)):
        name = "%s_%s.txt" % (task, side)
        cli(mod, conf, ["dev=cpu", "compute_dtype=bfloat16", "task=" + task,
                        "model_in=" + model, "pred=" + name] + extra,
            str(root))
        outs[side] = os.path.join(str(root), name)
    if "output_format=bin" in extra:
        got, want = (np.fromfile(outs[s], "<f4") for s in ("port", "jax"))
        assert _is_bf16_valued(got) and _is_bf16_valued(want)
    else:
        got, want = _rows(outs["port"]), _rows(outs["jax"])
        text = open(outs["port"]).read().split()
        # printed as the JAX CLI prints: "%g" of each value
        assert text == ["%g" % float(v) for v in got.ravel()]
    if task == "extract":
        assert open(outs["port"] + ".meta").read() == \
            open(outs["jax"] + ".meta").read()
    assert got.shape == want.shape and got.size > 0
    # the two packages' bf16 runs, each rounded in its own order
    np.testing.assert_allclose(got, want, rtol=2 ** -6,
                               atol=2 ** -6 * float(np.abs(want).max()))
