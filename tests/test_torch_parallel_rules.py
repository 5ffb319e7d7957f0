"""The port's placement rules (``parallel/sharding.py``) and mesh
(``parallel/mesh.py``) against the JAX package's, with no processes: the
ZeRO-1 split of an optimizer-state tensor, fsdp's split of every weight
and the tensor / expert-parallel split, on the shapes of the JAX package's
tests/test_fsdp.py, tests/test_compose.py and tests/test_moe.py nets and
of ImageNet.conf, on every mesh of 2, 4 and 8 devices over the data, ep and
model axes; the pipeline's refusals (the microbatch divisibility, an
updater that is not elementwise, a metric node inside the pipelined
prefix, a shared layer across stages) and its stage plan and live sets on
the JAX tests' nets; the JAX trainer's divisibility messages; and a
rank's block of a split
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


# the refusals of the pipeline (the keys themselves are taken now): JAX's
# checks, each raised by the port on a shape-only mesh of 4 ranks (the
# trainer's mesh built without process groups; nothing here runs a
# collective) and by the JAX trainer on as many devices
SHARED_ACROSS = """
netconfig = start
layer[0->1] = fullc:fa
  nhidden = 8
  init_sigma = 0.1
layer[1->2] = relu
layer[2->3] = fullc:fb
  nhidden = 8
  init_sigma = 0.1
layer[3->4] = relu
layer[4->5] = fullc:fc
  nhidden = 8
  init_sigma = 0.1
layer[5->6] = relu
layer[6->7] = share[fb]
layer[7->8] = fullc:out
  nhidden = 4
  init_sigma = 0.1
layer[8->8] = softmax
netconfig = end
input_shape = 1,1,8
batch_size = 16
eta = 0.1
"""


def _pipe_trainer(monkeypatch, cfg, n=4, rank=0):
    """A port trainer of ``cfg`` on a shape-only mesh of n ranks."""
    real = tmesh.create_mesh

    def shape_only(*a, **kw):
        kw.update(n=n, rank=rank, groups=False)
        return real(*a, **kw)
    monkeypatch.setattr(ttrainer.mesh_mod, "create_mesh", shape_only)
    tr = ttrainer.Trainer()
    for k, v in parse_config_string(cfg + "dev = cpu\n"):
        tr.set_param(k, v)
    return tr


def _jax_refuses(cfg, n, msg, step=False):
    from cxxnet_tpu.io.data import DataBatch
    from cxxnet_tpu.nnet.trainer import Trainer
    jt = Trainer()
    for k, v in parse_config_string(cfg + "dev = cpu:0-%d\n" % (n - 1)):
        jt.set_param(k, v)
    with pytest.raises(ValueError, match=msg):
        jt.init_model()
        if step:
            b = DataBatch()
            b.data = np.zeros((16, 1, 1, 48), np.float32)
            b.label = np.zeros((16, 1), np.float32)
            b.batch_size = 16
            jt.update(b)


@pytest.mark.parametrize("case", ["micro_count", "micro_size",
                                  "not_elementwise", "metric_in_prefix",
                                  "shared_across_stages"])
def test_pipeline_keys_are_refused_naming_item_12b(monkeypatch, case):
    """``pipeline_parallel`` and ``pipeline_micro`` are taken (ROADMAP
    item 12b is ported); what the JAX trainer refuses under them the port
    refuses with its message: a batch the microbatch count does not
    divide, a microbatch the data ranks do not divide, an updater that
    is not elementwise, a train metric on a node inside the pipelined
    prefix and a shared layer split from its primary by a stage cut."""
    tr = ttrainer.Trainer()
    tr.set_param("pipeline_parallel", "2")
    tr.set_param("pipeline_micro", "4")
    assert (tr.pipeline_parallel, tr.pipeline_micro) == (2, 4)
    pp = "pipeline_parallel = 2\n"
    if case == "micro_count":
        msg = "batch_size must be divisible by the microbatch count"
        with pytest.raises(ValueError, match=msg):
            tmesh.create_mesh(1, 1, 12, n=4, rank=0, groups=False,
                              pipeline_parallel=2, pipeline_micro=8)
        _jax_refuses(MLP + pp + "pipeline_micro = 8\nbatch_size = 12\n", 4,
                     msg)
    elif case == "micro_size":
        msg = "microbatch size \\(batch_size / pipeline_micro\\) must be"
        with pytest.raises(ValueError, match=msg):
            tmesh.create_mesh(1, 1, 16, n=8, rank=0, groups=False,
                              pipeline_parallel=2, pipeline_micro=8)
        _jax_refuses(MLP + pp + "pipeline_micro = 8\n", 8, msg)
    elif case == "not_elementwise":
        from cxxnet_tpu_torch.updater import updaters as tupd
        monkeypatch.setattr(tupd.Updater, "elementwise", False)
        tr = _pipe_trainer(monkeypatch, MLP + pp)
        with pytest.raises(ValueError, match="pipeline_parallel: updater "
                           "'sgd' for layer 0 key wmat declares "
                           "elementwise=False"):
            tr.init_model()
    elif case == "metric_in_prefix":
        cfg = MLP + pp + "metric[label,fc1] = error\n"
        tr = _pipe_trainer(monkeypatch, cfg)
        tr.init_model()
        x = torch.zeros((16, 1, 1, 48))
        y = torch.zeros((16, 1))
        with pytest.raises(ValueError, match="metric node 1 lives inside "
                           "the pipelined prefix"):
            tr._train_step(True, True, x, y)
        _jax_refuses(cfg, 4, "metric node 1 lives inside the pipelined "
                     "prefix", step=True)
    else:
        msg = "pipeline_parallel: shared layer 6 and its primary 2 must " \
            "fall in the same pipeline stage"
        tr = _pipe_trainer(monkeypatch, SHARED_ACROSS + pp)
        with pytest.raises(ValueError, match=msg):
            tr.init_model()
        _jax_refuses(SHARED_ACROSS + pp, 4, msg)


# the stage plan against JAX's on the branched, inception-style and resnet
# trunks of the JAX package's tests/test_compose.py
INCEPTION = """
netconfig = start
layer[0->1,2] = split
layer[1->3] = conv:sa
  kernel_size = 1
  nchannel = 8
  random_type = xavier
layer[2->4] = conv:sb
  kernel_size = 1
  nchannel = 4
  random_type = xavier
layer[3,4->5] = ch_concat
layer[5->6] = relu
layer[6->7] = conv:gc
  kernel_size = 3
  pad = 1
  nchannel = 8
  ngroup = 2
  random_type = xavier
layer[7->8] = relu
layer[8->9] = flatten
layer[9->10] = fullc:fc
  nhidden = 6
  init_sigma = 0.1
layer[+0] = softmax
netconfig = end
input_shape = 4,6,6
batch_size = 16
"""


def _plan_nets():
    from cxxnet_tpu import models as jmodels
    lm = open(os.path.join(REPO, "example", "transformer",
                           "lm_pipeline.conf")).read()
    return {"branched_lm": lm, "inception": INCEPTION,
            "resnet": jmodels.resnet_netconfig(depths=(2, 2), base_ch=8,
                                               n_class=4, final_pool=4)
            + "input_shape = 3,32,32\nbatch_size = 8\n",
            "shared": SHARED_ACROSS, "mlp": MLP}


@pytest.mark.parametrize("name", ["branched_lm", "inception", "resnet",
                                  "shared", "mlp"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_stage_plan_and_live_sets_are_the_jax_nets(name, k):
    text = _plan_nets()[name]
    pairs = parse_config_string(text)
    jcfg = JNetConfig()
    jcfg.configure(pairs)
    jnet = JNeuralNet(jcfg, 8)
    tcfg = NetConfig()
    tcfg.configure(pairs)
    tnet = NeuralNet(tcfg, 8)
    want_first = jnet._pipeline_chain_prefix()
    assert tnet._pipeline_chain_prefix() == want_first
    jparams = jnet.init_params(0)
    try:
        want = jnet.pipeline_plan(jparams, k)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:40]):
            tnet.pipeline_plan(k)
        return
    stages, first_loss = tnet.pipeline_plan(k)
    assert (stages, first_loss) == (list(want[0]), want[1])
    want_bounds = [jnet._pipeline_live_set(0, first_loss)] + [
        jnet._pipeline_live_set(hi, first_loss) if hi > lo else None
        for lo, hi in want[0]]
    for i in range(1, len(want_bounds)):
        if want_bounds[i] is None:
            want_bounds[i] = want_bounds[i - 1]
    assert tnet.pipeline_boundaries(stages, first_loss) == want_bounds
    for cut in range(first_loss + 1):
        assert tnet._pipeline_live_set(cut, first_loss) == \
            jnet._pipeline_live_set(cut, first_loss)


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


@pytest.mark.parametrize("n, keys", [(4, "pipeline_parallel = 2\n"),
                                     (8, "pipeline_parallel = 2\n"),
                                     (8, "pipeline_parallel = 4\n")])
def test_zero1_blocks_of_a_stage_are_the_jax_packed_rows(n, keys):
    """ZeRO-1 inside a stage: the port lays each stage's tensors end to
    end as the JAX trainer packs its row of (k, F_p) (layer order, each
    layer's keys sorted: the same offsets) and cuts it into the data
    ranks' blocks as JAX shards the row over ``data``. JAX pads every row
    to the widest stage's (a rectangular array); the port cuts each stage
    at its own width, so the widest stage's blocks are JAX's, on a net
    whose every tensor is stepped."""
    from cxxnet_tpu.nnet.trainer import Trainer
    jt = Trainer()
    for k, v in parse_config_string(MLP + keys + "fsdp = 1\ndev = cpu:0-%d\n"
                                    % (n - 1)):
        jt.set_param(k, v)
    jt.init_model()
    dp = jt.mesh.shape["data"]
    f_p = jt.params[-1][jt._PACKED].shape[1]
    stage_sizes = [[int(np.prod(e[3])) for e in es]
                   for es in jt._pp_entries]
    widest = max(range(len(stage_sizes)), key=lambda s_: sum(stage_sizes[s_]))
    for s_, entries in enumerate(jt._pp_entries):
        sizes = stage_sizes[s_]
        for d in range(dp):
            offs, c, segs = sharding.flat_blocks(sizes, dp, d)
            assert offs == [e[2] for e in entries]
            if s_ != widest:
                continue
            assert c * dp == f_p
            lo, hi = d * c, (d + 1) * c
            for off, size, seg in zip(offs, sizes, segs):
                got = np.arange(off, off + size)[seg[0]:seg[1]]
                want = np.arange(off, off + size)
                want = want[(want >= lo) & (want < hi)]
                np.testing.assert_array_equal(got, want)
