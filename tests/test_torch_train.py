"""The port's training slice as a whole, on the CPU, against the JAX
package: the AlexNet-shaped narrow net of test_torch_alexnet.py (both LRNs,
grouped convs, dropout, softmax) with ImageNet.conf's optimizer keys.

The JAX package inits and saves the model; both packages load the file
and take the same ``update`` steps on the same numpy batches, with
``threshold = 0`` so that dropout is the identity on both sides (the two
packages draw different random bits). After every step each parameter and
each optimizer-state tensor must agree.

Tolerance: relative 1e-5 (the reference's PairTest bar) plus an absolute
1e-5 of the tensor's largest magnitude. The forward and the gradients sum
conv and fullc products in another order on the two sides (XLA's CPU
kernels against PyTorch's), which moves a gradient by a few float32 ulps
of its largest summands; a gradient element that nearly cancels to zero
carries that absolute error at a large relative one, and the momentum
(-lr times the gradient) inherits it. Parameters move by lr times the
gradient per step, far below their own magnitude, so they agree much more
closely than the bound.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu import api as japi
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch.io import DataBatch, IIterator
from cxxnet_tpu_torch.layer.base import ApplyContext
from cxxnet_tpu_torch.layer.layers import DropoutLayer
from cxxnet_tpu_torch.nnet import trainer as ttrainer
from cxxnet_tpu_torch.ops import lrn as tlrn
from cxxnet_tpu_torch.utils import checkpoint, serializer

from tests.test_torch_alexnet import NET_CFG

RTOL, ATOL_REL = 1e-5, 1e-5

OPT_CFG = """
momentum = 0.9
wmat:lr  = 0.01
wmat:wd  = 0.0005
bias:wd  = 0.000
bias:lr  = 0.02
lr:schedule = expdecay
lr:gamma = 0.1
lr:step = 2
metric = error
metric = rec@1
metric = rec@5
"""
TRAIN_CFG = NET_CFG.replace("threshold = 0.5", "threshold = 0") + OPT_CFG

VARIANTS = {
    "imagenet_sgd": "",
    "update_period_2": "update_period = 2\n",
    "adam": "updater = adam\n",
    "nag_clip_global_norm": "updater = nag\nclip_global_norm = 0.05\n",
    "label_smooth": "",
}


def _cfg(variant):
    cfg = TRAIN_CFG + VARIANTS[variant]
    if variant == "label_smooth":
        cfg = cfg.replace("layer[21->21] = softmax",
                          "layer[21->21] = softmax\n  label_smooth = 0.1")
    return cfg


def _batches(n, rows=8, seed=11):
    rng = np.random.RandomState(seed)
    return [((rng.randn(rows, 3, 67, 67) * 50).astype(np.float32),
             rng.randint(0, 10, size=rows).astype(np.float32))
            for _ in range(n)]


def _close(got, want, what):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL_REL * float(np.abs(want).max()),
        err_msg=what)


def _assert_same_state(jnet, tnet, what):
    jt, tt = jnet.net_, tnet.net_
    assert tt.epoch_counter == jt.epoch_counter
    for i, (jp, tp) in enumerate(zip(jt.canonical_params(), tt.params)):
        assert sorted(jp) == sorted(tp)
        for k in jp:
            _close(tp[k], jp[k], "%s: layer %d %s" % (what, i, k))
    for i, (js, ts) in enumerate(zip(jt.opt_state, tt.opt_state)):
        assert sorted(js) == sorted(ts)
        for k in js:
            assert sorted(js[k]) == sorted(ts[k])
            for sk in js[k]:
                _close(ts[k][sk], js[k][sk],
                       "%s: layer %d %s/%s" % (what, i, k, sk))


def _load_pair(fname, cfg):
    jnet = japi.Net(dev="cpu", cfg=cfg)
    jnet.load_model(fname)
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.load_model(fname)
    return jnet, tnet


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """model_files(cfg): a model file that the JAX package initialized and
    wrote under ``cfg`` (weights and a fresh optimizer state of the
    config's updater), made once per config."""
    made = {}

    def get(cfg):
        if cfg not in made:
            net = japi.Net(dev="cpu", cfg=cfg)
            net.init_model()
            made[cfg] = str(tmp_path_factory.mktemp("train") / "jax.model")
            net.save_model(made[cfg])
        return made[cfg]
    return get


@pytest.fixture(scope="module")
def model_file(model_files):
    return model_files(TRAIN_CFG)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_three_updates_match_jax(model_files, variant):
    jnet, tnet = _load_pair(model_files(_cfg(variant)), _cfg(variant))
    before = [{k: v.clone() for k, v in p.items()}
              for p in tnet.net_.params]
    for step, (x, y) in enumerate(_batches(3)):
        jnet.update(x, y)
        tnet.update(x, y)
        _assert_same_state(jnet, tnet, "%s step %d" % (variant, step))
    # every parameter moved
    for p0, p1 in zip(before, tnet.net_.params):
        for k in p0:
            assert not torch.equal(p0[k], p1[k]), k


def test_update_period_2_updates_every_second_batch(model_file):
    _, tnet = _load_pair(model_file, _cfg("update_period_2"))
    w0 = tnet.net_.params[0]["wmat"].clone()
    (x, y), (x2, y2) = _batches(2)
    tnet.update(x, y)
    assert torch.equal(tnet.net_.params[0]["wmat"], w0)
    assert tnet.net_.grad_accum is not None and tnet.net_.epoch_counter == 0
    tnet.update(x2, y2)
    assert not torch.equal(tnet.net_.params[0]["wmat"], w0)
    assert tnet.net_.grad_accum is None and tnet.net_.epoch_counter == 1


def test_partial_batch_scales_by_configured_batch_size(model_file):
    # 4 rows under batch_size = 8: the loss scale is 1/8 on both sides
    jnet, tnet = _load_pair(model_file, TRAIN_CFG)
    x, y = _batches(1, rows=4, seed=5)[0]
    jnet.update(x, y)
    tnet.update(x, y)
    _assert_same_state(jnet, tnet, "4 rows")


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_optimizer_state_moves_through_model_files(model_file, tmp_path,
                                                   direction):
    jnet, tnet = _load_pair(model_file, TRAIN_CFG)
    (x, y), (x2, y2) = _batches(2, seed=21)
    jnet.update(x, y)
    tnet.update(x, y)
    fname = str(tmp_path / "step1.model")
    if direction == "port_to_jax":
        tnet.save_model(fname)
        jnet = japi.Net(dev="cpu", cfg=TRAIN_CFG)
        jnet.load_model(fname)
    else:
        jnet.save_model(fname)
        tnet = tapi.Net(dev="cpu", cfg=TRAIN_CFG)
        tnet.load_model(fname)
    # the momentum came through: it is nonzero and equal on both sides
    assert float(np.abs(np.asarray(jnet.net_.opt_state[0]["wmat"]["m"]))
                 .max()) > 0
    _assert_same_state(jnet, tnet, "%s after load" % direction)
    jnet.update(x2, y2)
    tnet.update(x2, y2)
    _assert_same_state(jnet, tnet, "%s step 2" % direction)


def test_port_model_file_round_trip_keeps_state(model_file, tmp_path):
    _, tnet = _load_pair(model_file, TRAIN_CFG)
    x, y = _batches(1, seed=31)[0]
    tnet.update(x, y)
    fname = str(tmp_path / "port.model")
    tnet.save_model(fname)
    back = tapi.Net(dev="cpu", cfg=TRAIN_CFG)
    back.load_model(fname)
    assert back.net_.epoch_counter == 1
    for a, b in zip(tnet.net_.opt_state, back.net_.opt_state):
        for k in a:
            for sk in a[k]:
                assert torch.equal(a[k][sk], b[k][sk])


def test_model_file_with_stray_bytes_is_refused(model_file, tmp_path):
    # the bytes after the optimizer-state section must be the end of the
    # file or the training-state section: stray bytes in its place are
    # refused
    _, tnet = _load_pair(model_file, TRAIN_CFG)
    fname = str(tmp_path / "port.model")
    tnet.save_model(fname)
    payload, _ = checkpoint.read_verified(fname)
    state = payload.rfind(checkpoint.STATE_MAGIC)
    assert state > 0
    with open(fname, "wb") as f:
        f.write(checkpoint.frame(payload[:state] + b"GARBAGE!"))
    with pytest.raises(ValueError, match="unexpected bytes"):
        tapi.Net(dev="cpu", cfg=TRAIN_CFG).load_model(fname)


def test_opt_state_from_jax(model_file):
    jnet, tnet = _load_pair(model_file, TRAIN_CFG)
    x, y = _batches(1, seed=41)[0]
    jnet.update(x, y)
    tnet.update(x, y)
    jstate = [{k: {sk: np.asarray(v) for sk, v in sub.items()}
               for k, sub in st.items()} for st in jnet.net_.opt_state]
    got = convert.opt_state_from_jax(jstate, tnet.net_)
    for a, b in zip(got, tnet.net_.opt_state):
        for k in b:
            for sk in b[k]:
                _close(a[k][sk], b[k][sk].numpy(), "layer %s" % k)
    bad = [dict(st) for st in jstate]
    bad[0] = {"wmat": {"m": jstate[0]["wmat"]["m"][:, :1]},
              "bias": jstate[0]["bias"]}
    with pytest.raises(ValueError, match="shape"):
        convert.opt_state_from_jax(bad, tnet.net_)
    bad[0] = {"wmat": jstate[0]["wmat"]}
    with pytest.raises(ValueError, match="keys"):
        convert.opt_state_from_jax(bad, tnet.net_)


class _ListIter(IIterator):
    """Batches of a fixed list; the last one carries padding rows."""

    def __init__(self, batches, pad):
        self.batches, self.pad, self.pos = batches, pad, 0

    def before_first(self):
        self.pos = 0

    def next(self):
        self.pos += 1
        return self.pos <= len(self.batches)

    def value(self):
        x, y = self.batches[self.pos - 1]
        b = DataBatch()
        b.data, b.label = x, y.reshape(-1, 1)
        b.batch_size = x.shape[0]
        b.num_batch_padd = self.pad if self.pos == len(self.batches) else 0
        return b


def test_evaluate_strings_match_jax(model_file):
    jnet, tnet = _load_pair(model_file, TRAIN_CFG)
    for x, y in _batches(2, seed=51):
        jnet.update(x, y)
        tnet.update(x, y)
    it = _ListIter(_batches(3, seed=52), pad=3)
    got = tnet.evaluate(it, "test")
    want = jnet.net_.evaluate(it, "test")
    assert got == want
    assert got.startswith("\ttrain-error:") and "\ttest-rec@5:" in got
    # the train sums were read and cleared: only the eval metrics remain
    # non-zero-count on a second call without updates
    assert tnet.evaluate(None, "test") == jnet.net_.evaluate(None, "test")


def test_copy_model_from_copies_name_matched_layers(model_file):
    # fc8 renamed: it keeps its fresh init, the other named layers copy
    cfg = TRAIN_CFG.replace("fullc:fc8", "fullc:fc8new").replace(
        "seed = 3", "seed = 9")
    payload, _ = checkpoint.read_verified(model_file)

    def copied(pkg):
        net = pkg.Net(dev="cpu", cfg=cfg)
        trainer = net._create_net()
        r = serializer.Reader(payload)
        r.read_int32()
        trainer.silent = 1
        trainer.copy_model_from(r)
        return trainer
    jt, tt = copied(japi), copied(tapi)
    src = tapi.Net(dev="cpu", cfg=TRAIN_CFG)
    src.load_model(model_file)
    fresh = tapi.Net(dev="cpu", cfg=cfg)
    fresh.init_model()
    names = {info.name: i for i, info in enumerate(tt.net_cfg.layers)}
    for name, i in names.items():
        if not name:
            continue
        for k, v in tt.params[i].items():
            want = (fresh.net_.params[i][k] if name == "fc8new"
                    else src.net_.params[i][k])
            assert torch.equal(v, want), (name, k)
            if name != "fc8new":
                np.testing.assert_array_equal(
                    v.numpy(), np.asarray(jt.canonical_params()[i][k]))
    assert tt.epoch_counter == 0
    assert all(not sub["m"].any() for st in tt.opt_state
               for sub in st.values())


def test_dropout_mask_keeps_half_scaled_by_two():
    lay = DropoutLayer()
    lay.set_param("threshold", "0.5")
    x = torch.ones(200, 1000)

    def run(seed):
        ctx = ApplyContext(train=True,
                           gen=torch.Generator().manual_seed(seed))
        return lay.forward({}, [x], ctx)[0]
    a, b, c = run(1), run(1), run(2)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.01
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(lay.forward({}, [x], ApplyContext())[0], x)


def test_dropout_in_training_is_seeded(model_file):
    cfg = NET_CFG + OPT_CFG          # threshold = 0.5
    x, y = _batches(1, seed=61)[0]
    nets = []
    for _ in range(2):
        net = tapi.Net(dev="cpu", cfg=cfg)
        net.load_model(model_file)
        net.update(x, y)
        nets.append(net)
    plain = tapi.Net(dev="cpu", cfg=TRAIN_CFG)
    plain.load_model(model_file)
    plain.update(x, y)
    fc7 = [n.get_weight("fc7") for n in nets + [plain]]
    np.testing.assert_array_equal(fc7[0], fc7[1])
    assert not np.array_equal(fc7[0], fc7[2])


def test_train_step_on_cpu_never_launches_kernels(model_file):
    _, tnet = _load_pair(model_file, TRAIN_CFG)
    before = (tlrn.launches, tlrn.bwd_launches)
    tnet.update(*_batches(1, seed=71)[0])
    assert (tlrn.launches, tlrn.bwd_launches) == before


@pytest.mark.parametrize("key, val", [("model_parallel", "2"),
                                      ("nonfinite_action", "ignore"),
                                      ("update_period", "0")])
def test_unported_training_keys_raise(key, val):
    """Keys of features that are not ported, and values the trainer
    refuses as the JAX trainer does (health_monitor and nonfinite_action
    are ported: test_training_health_keys_are_read). model_parallel is
    ported since the multi-process slice: one rank refuses it when the
    mesh is built, with the JAX trainer's device-count message."""
    tr = ttrainer.Trainer()
    if key == "model_parallel":
        tr.set_param(key, val)
        with pytest.raises(ValueError, match="device count 1 must be "
                           "divisible"):
            tr._setup_mesh()
        return
    with pytest.raises(ValueError, match="not ported|update_period|"
                       "nonfinite_action must be"):
        tr.set_param(key, val)


@pytest.mark.parametrize("key, val, attr, want", [
    ("health_monitor", "1", "health_monitor", 1),
    ("nonfinite_action", "skip", "nonfinite_action", "skip"),
    ("nonfinite_action", "abort", "nonfinite_action", "abort")])
def test_training_health_keys_are_read(key, val, attr, want):
    tr = ttrainer.Trainer()
    tr.set_param(key, val)
    assert getattr(tr, attr) == want


def test_staging_ring_refills_a_slot_only_after_its_copy():
    """The trainer's host-to-card staging ring on the CPU, in ordinary
    memory and with a stand-in event: a slot is refilled only after the
    event recorded behind its last copy is waited on, the caller's arrays
    are copied (free again at once), and a batch of another dtype or shape
    gets buffers of its own."""
    waited = []

    class Event:
        def __init__(self, k):
            self.k = k

        def synchronize(self):
            waited.append(self.k)

    ring = ttrainer.StagingRing(n=2, pin=False)
    data = np.zeros((4, 3), np.float32)
    label = np.zeros((4, 1), np.float32)
    slots = []
    for k in range(1, 6):
        data[:] = k
        label[:] = -k
        host = ring.fill((data, label))
        data[:] = 0          # the loader reuses its buffer at once
        assert float(host[0][0, 0]) == k and float(host[1][0, 0]) == -k
        slots.append(host[0].data_ptr())
        ring.record(Event(k))
    assert waited == [1, 2, 3]
    assert len(set(slots)) == 2 and slots[0] == slots[2] == slots[4]
    host = ring.fill((np.ones((4, 3), np.uint8), label))
    assert host[0].dtype == torch.uint8 and waited == [1, 2, 3, 4]
