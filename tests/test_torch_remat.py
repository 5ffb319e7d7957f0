"""``remat`` in the port (cxxnet_tpu/layer/base.py:234-243,
cxxnet_tpu/nnet/net.py:496-512, 583-589) on the CPU.

Layers with ``remat = 1`` run under torch.utils.checkpoint, a piece of
ceil(sqrt(n)) consecutive ones at a time (NeuralNet.remat_segments): a
piece's forward runs again in the backward instead of keeping its
activations, and the training forward keeps only the values that leave a
piece. Each layer's generator is made inside the checkpointed function
from its seed, so the recompute draws the same dropout mask: on a net
with dropout, loss and gradients with remat on are bitwise those with
remat off, and so are the parameters after an update. Loss layers, layers
with state (batch-norm's running statistics) and the KV-cached decode
forward are not recomputed, as in the JAX package. VGG.conf's
netconfig-level ``remat = 1`` reaches every layer, as the JAX package
reads it.
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu import api as japi
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import models
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.utils.config import parse_config_string

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NET = """
netconfig = start
%(remat)s
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 8
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 2
  stride = 2
layer[3->4] = batch_norm:bn
  moving_average = 1
layer[4->5] = flatten
layer[5->6] = fullc:fc1
  nhidden = 16
layer[6->7] = relu
layer[7->7] = dropout
  threshold = 0.5
layer[7->8] = fullc:fc2
  nhidden = 4
layer[8->8] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 5
eta = 0.1
momentum = 0.9
wd = 0.0005
dev = cpu
"""


def _cfg(remat, extra=""):
    return NET % {"remat": "remat = 1" if remat else ""} + extra


def _batch():
    rng = np.random.RandomState(3)
    b = DataBatch()
    b.data = rng.randn(5, 3, 8, 8).astype(np.float32)
    b.label = rng.randint(0, 4, (5, 1)).astype(np.float32)
    b.batch_size = 5
    return b


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    net = tapi.Net(dev="cpu", cfg=_cfg(False))
    net.init_model()
    fname = str(tmp_path_factory.mktemp("remat") / "port.model")
    net.save_model(fname)
    return fname


def _net(fname, remat, extra=""):
    net = tapi.Net(dev="cpu", cfg=_cfg(remat, extra))
    net.load_model(fname)
    return net


def _count_forwards(net, monkeypatch):
    """Calls of each layer's forward, by connection index."""
    calls = {}
    for i, lay in enumerate(net.net_.net.layers):
        fwd = lay.forward

        def counted(p, ins, ctx, i=i, fwd=fwd):
            calls[i] = calls.get(i, 0) + 1
            return fwd(p, ins, ctx)
        monkeypatch.setattr(lay, "forward", counted)
    return calls


@pytest.mark.parametrize("extra", ["", "compute_dtype = bfloat16\n"])
def test_remat_on_and_off_give_bitwise_equal_gradients(model_file, extra):
    off, on = _net(model_file, False, extra), _net(model_file, True, extra)
    assert all(lay.remat == 1 for lay in on.net_.net.layers)
    assert not any(lay.remat for lay in off.net_.net.layers)
    b = _batch()
    loss_off, g_off = off.net_.loss_and_grads(b)
    loss_on, g_on = on.net_.loss_and_grads(b)
    assert torch.equal(loss_on, loss_off)
    for a, c in zip(g_on, g_off):
        assert sorted(a) == sorted(c)
        for k in a:
            assert torch.equal(a[k], c[k]), k
    for net in (off, on):
        net.update(b.data, b.label)
    for p, q in zip(on.net_.params, off.net_.params):
        for k in p:
            assert torch.equal(p[k], q[k]), k


def test_remat_recomputes_only_stateless_non_loss_layers(model_file,
                                                         monkeypatch):
    on = _net(model_file, True)
    # conv relu pool | bn | flatten fc1 relu dropout fc2 | softmax: the runs
    # of 3 and 5 remat layers cut into pieces of ceil(sqrt(n)), 2 and 3
    assert on.net_.net.remat_segments() == [range(0, 2), range(2, 3),
                                            range(4, 7), range(7, 9)]
    calls = _count_forwards(on, monkeypatch)
    _, grads = on.net_.loss_and_grads(_batch())
    types = [lay.type_name for lay in on.net_.net.layers]
    for i, t in enumerate(types):
        # batch-norm keeps running statistics and softmax is the loss: one
        # forward each; every layer of a piece runs again in the backward
        want = {"batch_norm": 1, "softmax": 1}.get(t, 2)
        assert calls[i] == want, (i, t, calls[i])
    calls.clear()
    with torch.no_grad():
        on.net_.net.forward(on.net_.params, torch.from_numpy(_batch().data))
    # no graph, no recompute
    assert set(calls.values()) == {1}


def test_remat_forward_keeps_only_values_that_leave_a_piece(model_file):
    on, off = _net(model_file, True), _net(model_file, False)
    b = _batch()
    data = torch.from_numpy(b.data)
    labels = on.net_.net.label_info_from(torch.from_numpy(b.label))
    kept = {}
    for name, net in (("on", on), ("off", off)):
        values, _ = net.net_.net.forward(net.net_.params, data, labels=labels,
                                         train=True, keep=(6,))
        kept[name] = [j for j, v in enumerate(values) if v is not None]
    # node 1 (conv's output) stays inside conv-relu, node 5 (flatten's)
    # inside flatten-fc1-relu and node 7 (dropout's) inside dropout-fc2;
    # 6 is asked for, 8 is the last
    assert kept["on"] == [0, 2, 3, 4, 6, 8]
    assert kept["off"] == list(range(9))


def test_dropout_draws_differ_between_steps_but_replay_within_one(
        model_file):
    # two steps' masks differ (the step counter is in the seed), so the
    # bitwise agreement above is not a mask of ones
    on = _net(model_file, True)
    b = _batch()
    l1, _ = on.net_.loss_and_grads(b)
    on.update(b.data, b.label)
    off = _net(model_file, False)
    off.update(b.data, b.label)
    l2_on, _ = on.net_.loss_and_grads(b)
    l2_off, _ = off.net_.loss_and_grads(b)
    assert torch.equal(l2_on, l2_off)
    assert not torch.equal(l1, l2_on)


def test_vgg_conf_sets_remat_on_every_layer():
    text = open(os.path.join(REPO, "example/ImageNet/VGG.conf")).read()
    pairs = [(k, v) for k, v in parse_config_string(text)
             if not (k == "dev" or k.startswith("data") or k == "eval")]
    cfg = "\n".join("%s = %s" % kv for kv in pairs)
    # the conf's own net, but shrunk to a 32x32 input for the CPU
    cfg = cfg.replace("input_shape = 3,224,224", "input_shape = 3,32,32")
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tr = tnet._create_net()
    tr.net_cfg.configure(tr.cfg_pairs)
    from cxxnet_tpu_torch.nnet.net import NeuralNet
    net = NeuralNet(tr.net_cfg, 2)
    assert len(net.layers) > 30 and all(lay.remat == 1 for lay in net.layers)
    assert tr.compute_dtype == torch.bfloat16
    assert models.vgg_netconfig(remat=1).startswith("netconfig=start\nremat")


def test_vgg11_remat_step_matches_jax_remat_step(tmp_path):
    # the small VGG of the JAX package's own remat test shape, dropout off:
    # one step with remat on in both packages from one model file
    cfg = models.vgg_config(batch_size=2, input_hw=32, dev="cpu",
                            n_class=10, arch="vgg11", fc_dim=32, remat=1,
                            dropout=0.0)
    jnet = japi.Net(dev="cpu", cfg=cfg)
    jnet.init_model()
    fname = str(tmp_path / "vgg11.model")
    jnet.save_model(fname)
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.load_model(fname)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 2).astype(np.float32)
    jnet.update(x, y)
    tnet.update(x, y)
    from tests.test_torch_train import _assert_same_state
    _assert_same_state(jnet, tnet, "vgg11 remat step")
