"""The port's training health (cxxnet_tpu_torch/utils/health.py, the
trainer's health vector and skip guard, learn_task's rollback) on the CPU,
against the JAX package's.

The scenarios of tests/test_health_faults.py run against the port by
swapping the globals of the JAX test module that name the package's
classes and modules for the port's, for the length of the case (the report
tool for its twin, ``cxxnet_tpu_torch.tools.telemetry_report``). Every
port run starts from the JAX package's initial weights of the same conf
(``convert.params_from_jax`` inside ``Trainer.init_model``), so that the
port's batch-excluded control is held to the JAX control as well. Left
out, each for its reason:

* ``test_corrupt_imgbin_record_skipped_and_quarantined``,
  ``test_truncated_pack_ends_epoch_instead_of_crashing`` and
  ``test_decode_timeout_restarts_dead_worker`` drive the image iterators,
  whose twins run in tests/test_torch_io.py (corrupt records,
  ``decode_timeout``) and tests/test_torch_jpeg.py (truncated records);
* ``test_telemetry_report_exits_2_on_unresolved_anomaly`` tests the report
  tool alone; it runs on the twin in tests/test_torch_tools.py.

Beside them: one step's health vector against the JAX trainer's (loss and
``grad_norm_sq`` to rel 1e-5, the NaN count and ``ok`` exact, on a clean
and on a NaN batch), the port's rollback and skip runs bitwise the port's
control and ``_rng_counter`` equal, and a net with dropout, where the skip
run keeps the step's draw and equals a control that counts the dropped
step without applying it.
"""

import inspect
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

from cxxnet_tpu.api import Net as JNet
from cxxnet_tpu.learn_task import LearnTask as JLearnTask
from cxxnet_tpu.nnet.trainer import Trainer as JTrainer
from cxxnet_tpu_torch import api, convert
from cxxnet_tpu_torch.io.batch import ThreadBufferIterator
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.learn_task import LearnTask
from cxxnet_tpu_torch.nnet.trainer import Trainer
from cxxnet_tpu_torch.tools import telemetry_report
from cxxnet_tpu_torch.utils import health, telemetry
from cxxnet_tpu_torch.utils.metric import MetricLogloss, MetricSet

from . import faultinject as fi
from . import synth_mnist
from . import test_health_faults as jtests

SCENARIOS = (
    "test_nan_batch_rollback_and_skip_exact",
    "test_loss_spike_triggers_lr_backoff",
    "test_nonfinite_action_skip_suppresses_on_device",
    "test_nonfinite_action_abort_dumps_diagnostics",
    "test_rollback_retries_exhausted_aborts",
    "test_watchdog_fires_on_stalled_prefetch_stub",
    "test_watchdog_pause_disarms_channel",
    "test_dead_prefetch_thread_raises_instead_of_hanging",
    "test_metric_nan_warns_and_counts_instead_of_raising",
    "test_load_model_bad_name_is_structured_error",
    "test_health_policy_selftest",
)


def _jax_init_params(conf):
    """The JAX trainer's initial weights for the net of ``conf``."""
    tr = JTrainer()
    from cxxnet_tpu.utils.config import ConfigIterator
    for k, v in ConfigIterator(conf, []):
        tr.set_param(k, v)
    tr.init_model()
    return tr.canonical_params()


@pytest.fixture(scope="module")
def mnist_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("health_mnist")
    return synth_mnist.make_dataset(str(d), n_train=400, n_test=100)


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory, mnist_data):
    d = tmp_path_factory.mktemp("jax_init")
    return _jax_init_params(jtests.write_conf(d, mnist_data))


@pytest.fixture()
def from_jax_init(jax_init):
    """Port trainers start from the JAX package's initial weights."""
    orig = Trainer.init_model

    def init_model(self):
        orig(self)
        self.params = convert.params_from_jax(jax_init, self.net, self.dev)
    with mock.patch.object(Trainer, "init_model", init_model):
        yield


def _swap(monkeypatch):
    for attr, val in (("LearnTask", LearnTask), ("Trainer", Trainer),
                      ("health", health), ("telemetry", telemetry),
                      ("MetricLogloss", MetricLogloss),
                      ("MetricSet", MetricSet),
                      ("ThreadBufferIterator", ThreadBufferIterator),
                      ("DataBatch", DataBatch),
                      ("telemetry_report", telemetry_report)):
        monkeypatch.setattr(jtests, attr, val)


def _probe(tmp_path_factory, mnist_data, task_cls, trainer_cls, tag):
    """The JAX module's probe fixture for one package: a clean run that
    records the target batch's key, then the batch-excluded control."""
    d = tmp_path_factory.mktemp(tag + "_probe")
    records = []
    conf = jtests.write_conf(d, mnist_data)
    with mock.patch.object(trainer_cls, "update", fi.recording_update(
            trainer_cls.update, records)):
        task_cls().run([conf])
    keys = [idx for r, idx in records if r == jtests.TARGET_TRAINER_ROUND]
    target = int(keys[jtests.TARGET_BATCH_POS])
    dc = tmp_path_factory.mktemp(tag + "_control")
    with mock.patch.object(trainer_cls, "update", fi.poison_batch(
            trainer_cls.update, jtests.TARGET_TRAINER_ROUND, target,
            mode="drop")):
        control = task_cls()
        control.run([jtests.write_conf(dc, mnist_data)])
    return {"target": target, "control": control,
            "models": str(d / "models")}


@pytest.fixture(scope="module")
def probes(tmp_path_factory, mnist_data, jax_init):
    """One probe / control pair per package, shared by the module."""
    orig = Trainer.init_model

    def init_model(self):
        orig(self)
        self.params = convert.params_from_jax(jax_init, self.net, self.dev)
    with mock.patch.object(Trainer, "init_model", init_model):
        port = _probe(tmp_path_factory, mnist_data, LearnTask, Trainer,
                      "port")
    jax = _probe(tmp_path_factory, mnist_data, JLearnTask, JTrainer, "jax")
    return {"port": port, "jax": jax}


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning"))
    if n == "test_dead_prefetch_thread_raises_instead_of_hanging" else n
    for n in SCENARIOS])
def test_jax_health_scenario_on_the_port(name, tmp_path, mnist_data, probes,
                                         from_jax_init, capfd,
                                         monkeypatch):
    _swap(monkeypatch)
    fn = getattr(jtests, name)
    given = {"tmp_path": tmp_path, "mnist_data": mnist_data,
             "probe": probes["port"], "capfd": capfd,
             "monkeypatch": monkeypatch}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


def test_port_control_matches_the_jax_control(probes):
    """The two packages' batch-excluded controls, from the same initial
    weights over the same batches, agree within 1e-5 (two rounds of
    SGD with momentum; the sums run in another order)."""
    assert probes["port"]["target"] == probes["jax"]["target"]
    port = probes["port"]["control"].net_trainer
    jax = probes["jax"]["control"].net_trainer
    for lp, lj in zip(port.canonical_params(), jax.canonical_params()):
        assert set(lp) == set(lj)
        for k in lp:
            np.testing.assert_allclose(lp[k], np.asarray(lj[k]), rtol=1e-5,
                                       atol=1e-5 * float(np.abs(
                                           np.asarray(lj[k])).max()))


def test_port_rollback_and_skip_are_bitwise_the_port_control(
        tmp_path, mnist_data, probes, from_jax_init, monkeypatch):
    """The NaN run that rolls back and the skip run end on the port
    control's weights bit for bit, with its rng counter."""
    control = probes["port"]["control"].net_trainer
    for action in ("rollback", "skip"):
        d = tmp_path / action
        d.mkdir()
        conf = jtests.write_conf(d, mnist_data)
        with mock.patch.object(Trainer, "update", fi.poison_batch(
                Trainer.update, jtests.TARGET_TRAINER_ROUND,
                probes["port"]["target"], mode="nan")):
            task = LearnTask()
            task.run([conf, "health_monitor=1",
                      "nonfinite_action=" + action])
        assert task._recovery.total_rollbacks == (action == "rollback")
        got = task.net_trainer
        assert got._rng_counter == control._rng_counter + (action == "skip")
        jtests.assert_same_weights(got.canonical_params(),
                                   control.canonical_params())


# ----------------------------------------------------------------------
# one step's health vector against the JAX trainer's
NET = """netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.01
layer[+1:sg1] = sigmoid:se1
layer[sg1->fc2] = fullc:fc2
  nhidden = 10
  init_sigma = 0.01
layer[+0] = softmax
netconfig=end
input_shape = 1,1,784
batch_size = 100
eta = 0.2
momentum = 0.9
metric = error
health_monitor = 1
"""


@pytest.mark.parametrize("poison", [False, True])
def test_health_vector_matches_jax(poison):
    rs = np.random.RandomState(7)
    x = rs.rand(100, 1, 1, 784).astype(np.float32)
    if poison:
        x[3, 0, 0, :5] = np.nan
    y = rs.randint(0, 10, (100, 1)).astype(np.float32)
    jnet = JNet(dev="cpu", cfg=NET)
    jnet.init_model()
    net = api.Net(dev="cpu", cfg=NET)
    net.init_model()
    net.net_.params = convert.params_from_jax(
        jnet.net_.canonical_params(), net.net_.net, net.net_.dev)
    jnet.update(x, y)
    net.update(x, y)
    want = np.asarray(jnet.net_.last_health, np.float32)
    got = net.net_.last_health
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    got = got.numpy()
    if poison:
        assert np.isnan(got[0]) and np.isnan(want[0])
        assert np.isnan(got[1]) and np.isnan(want[1])
        assert got[2] > 0
    else:
        np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    assert got[2] == want[2] and got[3] == want[3] == (0.0 if poison
                                                        else 1.0)


def test_skip_with_dropout_keeps_the_step_draw(tmp_path):
    """With dropout the skip run's suppressed step still takes its draw
    (the host cannot know the step was bad without reading the card), so
    it equals, bit for bit, a control that counts the dropped step
    (``_rng_counter`` and ``epoch_counter``) without applying it; the
    plain drop control, which takes no draw, differs."""
    cfg = NET.replace("layer[+1:sg1] = sigmoid:se1\n",
                      "layer[+1:sg1] = sigmoid:se1\nlayer[+0] = dropout\n"
                      "  threshold = 0.5\n") + "nonfinite_action = skip\n"
    rs = np.random.RandomState(3)
    batches = [(rs.rand(100, 1, 1, 784).astype(np.float32),
                rs.randint(0, 10, (100, 1)).astype(np.float32))
               for _ in range(4)]

    def run(mode):
        net = api.Net(dev="cpu", cfg=cfg)
        net.init_model()
        tr = net.net_
        for i, (x, y) in enumerate(batches):
            if i == 1 and mode == "counted":
                tr._rng_counter += 1
                tr.epoch_counter += 1
                continue
            if i == 1 and mode == "drop":
                continue
            net.update(np.full_like(x, np.nan) if i == 1 else x, y)
        return tr.canonical_params()

    skip, counted, drop = run("skip"), run("counted"), run("drop")
    jtests.assert_same_weights(skip, counted)
    assert not all(np.array_equal(a[k], b[k]) for a, b in zip(skip, drop)
                   for k in a)


def test_health_module_scenarios_cover_the_jax_file():
    """Every test of tests/test_health_faults.py runs here or is named in
    the module docstring with the file that runs its twin."""
    names = {n for n in dir(jtests) if n.startswith("test_")}
    left_out = {n for n in names if n in __doc__}
    assert names == set(SCENARIOS) | left_out, names - set(SCENARIOS)
    assert os.path.basename(jtests.__file__) == "test_health_faults.py"
