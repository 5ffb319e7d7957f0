"""The port's placement rules (``parallel/sharding.py``) and mesh
(``parallel/mesh.py``) against the JAX package's, with no processes: the
ZeRO-1 split of an optimizer-state tensor, fsdp's split of every weight
and the tensor / expert-parallel split, on the shapes of the JAX package's
tests/test_fsdp.py, tests/test_compose.py and tests/test_moe.py nets and
of ImageNet.conf, on every mesh of 2, 4 and 8 devices over the data, ep and
model axes; the refusals of ``pipeline_parallel`` / ``pipeline_micro``;
the JAX trainer's divisibility messages; and a rank's block of a split
(``shard``) against the JAX array's addressable shard on the same device.

A port placement is a tuple in the form of a ``PartitionSpec``; JAX's
spec is read as a tuple and both are padded with None to the tensor's
rank before they are compared.
"""

import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh, NamedSharding

from cxxnet_tpu.nnet.config import NetConfig as JNetConfig
from cxxnet_tpu.nnet.net import NeuralNet as JNeuralNet
from cxxnet_tpu.parallel import sharding as jsharding
from cxxnet_tpu.utils.config import ConfigIterator as JConfigIterator
from cxxnet_tpu.utils.config import parse_config_string
from cxxnet_tpu_torch.nnet import trainer as ttrainer
from cxxnet_tpu_torch.nnet.config import NetConfig
from cxxnet_tpu_torch.nnet.net import NeuralNet
from cxxnet_tpu_torch.parallel import mesh as tmesh
from cxxnet_tpu_torch.parallel import sharding
from tests.test_torch_dist_train import ATT, CONV_BN, MLP, MOE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGENET = os.path.join(REPO, "example", "ImageNet", "ImageNet.conf")

MESHES = [{"data": 2}, {"data": 4}, {"data": 8},
          {"data": 1, "model": 2}, {"data": 2, "model": 2},
          {"data": 4, "model": 2}, {"data": 2, "model": 4},
          {"data": 2, "ep": 2}, {"data": 4, "ep": 2},
          {"data": 2, "ep": 2, "model": 2}, {"data": 1, "ep": 4}]


def _meshes(sizes):
    """(JAX mesh over the first devices, the port's shape-only mesh)."""
    axes = [a for a in ("data", "ep", "model")
            if a == "data" or sizes.get(a, 1) > 1]
    shape = tuple(sizes.get(a, 1) for a in axes)
    n = int(np.prod(shape))
    jm = JMesh(np.array(jax.devices()[:n]).reshape(shape), tuple(axes))
    return jm, tmesh.Mesh(sizes)


def _norm(spec, ndim):
    out = [None if e is None else (e if isinstance(e, str) else tuple(e))
           for e in tuple(spec)]
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in out]
    return tuple(out + [None] * (ndim - len(out)))


def _nets(text, batch=16):
    """(JAX net, port net) of a config, structure only."""
    pairs = list(parse_config_string(text))
    jc, tc = JNetConfig(), NetConfig()
    jc.configure(pairs)
    tc.configure(pairs)
    return JNeuralNet(jc, batch), NeuralNet(tc, batch)


def _imagenet_text():
    return "".join("%s = %s\n" % (k, v) for k, v in JConfigIterator(IMAGENET))


NETS = {"mlp": MLP, "att": ATT, "moe": MOE, "conv_bn": CONV_BN}


def _net_text(name):
    return _imagenet_text() if name == "imagenet" else NETS[name]


@pytest.fixture(scope="module")
def nets():
    return {name: _nets(_net_text(name))
            for name in sorted(NETS) + ["imagenet"]}


def _fake(shape):
    return np.broadcast_to(np.float32(0), tuple(shape))


@pytest.mark.parametrize("name", sorted(NETS) + ["imagenet"])
def test_rules_match_jax_on_every_mesh(nets, name):
    jnet, tnet = nets[name]
    shapes = tnet.param_shapes()
    fake = [{k: _fake(s) for k, s in p.items()} for p in shapes]
    for sizes in MESHES:
        jm, tm = _meshes(sizes)
        jtp = jsharding.param_shardings(jm, jnet.layers, fake)
        ttp = sharding.param_shardings(tm, tnet.layers, shapes)
        jfs = jsharding.fsdp_shardings(jm, jnet.layers, fake,
                                       base_shardings=jtp)
        tfs = sharding.fsdp_shardings(tm, tnet.layers, shapes,
                                      base_shardings=ttp)
        for i, p in enumerate(shapes):
            for k, shape in p.items():
                nd, what = len(shape), "%s %s layer %d %s" % (name, sizes,
                                                              i, k)
                assert _norm(ttp[i][k], nd) == _norm(jtp[i][k].spec, nd), \
                    what
                assert _norm(tfs[i][k], nd) == _norm(jfs[i][k].spec, nd), \
                    what
                jz = jsharding.zero_sharding(jm, fake[i][k],
                                             base_spec=jtp[i][k].spec)
                tz = sharding.zero_sharding(tm, shape, base_spec=ttp[i][k])
                assert _norm(tz, nd) == _norm(jz.spec, nd), what
                jz0 = jsharding.zero_sharding(jm, fake[i][k])
                assert _norm(sharding.zero_sharding(tm, shape), nd) == \
                    _norm(jz0.spec, nd), what


def test_imagenet_tp_splits_every_conv_and_fullc(nets):
    """ImageNet.conf at model_parallel 2: every conv's output channels
    and every fullc's outputs split, biases whole; the rank's blocks hold
    half the weight bytes."""
    _, tnet = nets["imagenet"]
    shapes = tnet.param_shapes()
    tm = tmesh.Mesh({"data": 2, "model": 2})
    tp = sharding.param_shardings(tm, tnet.layers, shapes)
    for lay, p, s in zip(tnet.layers, shapes, tp):
        if lay.type_name in ("conv", "fullc"):
            assert sharding.split_of(s["wmat"]) is not None, lay.type_name
            assert sharding.split_of(s["bias"]) is None
    full = sum(int(np.prod(v)) for p in shapes for k, v in p.items()
               if k == "wmat")
    mine = sum(int(np.prod(sharding.shard_shape(v, tm, tp[i][k])))
               for i, p in enumerate(shapes) for k, v in p.items()
               if k == "wmat")
    assert mine * 2 == full


@pytest.mark.parametrize("sizes, spec", [
    ({"data": 4, "model": 2}, (("model", "data"), None)),
    ({"data": 2, "ep": 2, "model": 2}, (("data", "ep", "model"),)),
    ({"data": 2, "model": 2}, (None, ("model", "data"), None)),
    ({"data": 4}, (None, "data"))])
def test_shard_is_the_jax_devices_block(sizes, spec):
    """A rank's block of a split (the first axis major) is the shard JAX
    puts on the device of the same mesh position."""
    jm, _ = _meshes(sizes)
    shape = (16, 8, 3)[:max(len(spec), 2)]
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    arr = jax.device_put(x, NamedSharding(jm, jax.sharding.PartitionSpec(
        *spec)))
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    flat = list(jm.devices.flat)
    for rank, dev in enumerate(flat):
        tm = tmesh.Mesh(sizes, rank=rank)
        got = sharding.shard(torch.from_numpy(x), tm, spec).numpy()
        np.testing.assert_array_equal(got, by_dev[dev],
                                      err_msg="rank %d" % rank)


def test_mesh_order_and_groups_without_processes():
    m = tmesh.Mesh({"data": 2, "ep": 2, "model": 2}, rank=5)
    assert m.axis_names == ("data", "ep", "model")
    assert m.coords == {"data": 1, "ep": 0, "model": 1}
    assert m.rank_of(m.coords) == 5
    assert tmesh.Mesh({"data": 2, "model": 1}).axis_names == ("data",)
    # a model group is consecutive ranks
    assert m._members(("model",), m.coords) == [4, 5]
    # a joint split over (model, data): model major
    assert m._members(("model", "data"), m.coords) == [0, 4, 1, 5]


@pytest.mark.parametrize("key, val, msg", [
    ("pipeline_parallel", "2", "pipeline_parallel > 1 is not ported yet: "
     "it is ROADMAP.md Queue 1 item 12b"),
    ("pipeline_micro", "4", "pipeline_micro > 0 is not ported yet: it "
     "belongs to pipeline_parallel, ROADMAP.md Queue 1 item 12b")])
def test_pipeline_keys_are_refused_naming_item_12b(key, val, msg):
    tr = ttrainer.Trainer()
    with pytest.raises(ValueError, match=msg):
        tr.set_param(key, val)
    tr.set_param(key, "1" if key == "pipeline_parallel" else "0")


@pytest.mark.parametrize("n, mp, ep, batch, msg", [
    (8, 3, 1, 16, "device count 8 must be divisible by model_parallel"),
    (4, 2, 4, 16, "device count 4 must be divisible by model_parallel"),
    (1, 2, 1, 16, "device count 1 must be divisible by model_parallel"),
    (8, 2, 1, 6, "batch_size must be divisible by the data-parallel "
     "degree"),
    (8, 1, 3, 16, "device count 8 must be divisible")])
def test_divisibility_messages_are_the_jax_trainers(n, mp, ep, batch, msg):
    with pytest.raises(ValueError, match=msg):
        tmesh.create_mesh(mp, ep, batch, n=n, rank=0, groups=False)
    # the JAX trainer raises the same on as many devices
    from cxxnet_tpu.nnet.trainer import Trainer
    jt = Trainer()
    for k, v in parse_config_string(MLP + "dev = cpu:0-%d\nbatch_size = %d\n"
                                    "model_parallel = %d\nexpert_parallel "
                                    "= %d\n" % (n - 1, batch, mp, ep)):
        jt.set_param(k, v)
    with pytest.raises(ValueError, match=msg.split(" by ")[0]):
        jt.init_model()


def test_a_world_of_one_builds_no_mesh():
    assert tmesh.create_mesh(1, 1, 16) is None
    m = tmesh.create_mesh(2, 2, 16, n=8, rank=3, groups=False)
    assert m.shape == {"data": 2, "ep": 2, "model": 2}
