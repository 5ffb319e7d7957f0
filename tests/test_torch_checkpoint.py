"""The port's durable checkpoints and exact resume, on the CPU, against the
JAX package's: a model save that fails part-way, through both of the port's
callers (``api.Net.save_model`` and the command line's ``_save_model``); the
scenarios of tests/test_checkpoint_faults.py run against the port; the
training-state section (``CXTSTA01``) byte for byte against the JAX
package's; each package resuming from the other's emergency file; and a
small conv net with an LRN layer and an augmenting, prefetching image chain
killed mid-round and resumed bit for bit.

A JAX scenario runs against the port by swapping the globals of the JAX test
module that name the task, the trainer, the checkpoint module, the
serializer, the fault injector and the checker (``LearnTask``, ``Trainer``,
``ckpt``, ``serializer``, ``fi``, ``ckpt_fsck``) for the port's, for the
length of the case (the checker's twin is
``cxxnet_tpu_torch.tools.ckpt_fsck``); its module-scoped fixtures
(``mnist_data``, ``trained``) are rebuilt here on the port. Every scenario
of tests/test_checkpoint_faults.py runs.
"""

import builtins
import errno
import inspect
import json
import os
import types

import numpy as np
import pytest
import torch

from cxxnet_tpu.learn_task import LearnTask as JLearnTask
from cxxnet_tpu.nnet.trainer import Trainer as JTrainer
from cxxnet_tpu.utils import checkpoint as jckpt
from cxxnet_tpu.utils import serializer as jserializer
from cxxnet_tpu.utils.config import ConfigIterator as JConfigIterator
from cxxnet_tpu_torch import api, convert
from cxxnet_tpu_torch.io import synth
from cxxnet_tpu_torch.learn_task import LearnTask
from cxxnet_tpu_torch.nnet.trainer import Trainer
from cxxnet_tpu_torch.tools import ckpt_fsck
from cxxnet_tpu_torch.utils import checkpoint as ckpt
from cxxnet_tpu_torch.utils import serializer
from cxxnet_tpu_torch.utils.config import ConfigIterator

from . import faultinject as jfi
from . import synth_mnist
from . import test_checkpoint_faults as jtests


# ----------------------------------------------------------------------
# the fault injector over the port's checkpoint module
def _strip_framing(path: str) -> None:
    """tests/faultinject.py's ``strip_framing`` on the port's reader."""
    payload, fmt = ckpt.read_verified(path)
    assert fmt == "v1"
    with open(path, "wb") as f:
        f.write(payload)


fi = types.SimpleNamespace(
    truncate=jfi.truncate, bit_flip=jfi.bit_flip,
    tear_footer=jfi.tear_footer, strip_framing=_strip_framing,
    make_stale_tmp=jfi.make_stale_tmp, killing_method=jfi.killing_method,
    failing_once=jfi.failing_once, always_failing=jfi.always_failing)


@pytest.fixture(scope="module")
def mnist_data(tmp_path_factory):
    return synth_mnist.make_dataset(str(tmp_path_factory.mktemp("mnist")))


@pytest.fixture(scope="module")
def trained(tmp_path_factory, mnist_data):
    """tests/test_checkpoint_faults.py's shared 3-round run, on the port."""
    d = tmp_path_factory.mktemp("ckpt_base")
    conf = str(d / "train.conf")
    with open(conf, "w") as f:
        f.write(jtests.CONF.format(model_dir=str(d / "models"),
                                   num_round=3, **mnist_data))
    task = LearnTask()
    task.run([conf])
    return {"dir": str(d), "conf": conf, "models": str(d / "models"),
            "err": task.net_trainer.metric.evals[0].get()}


def _conf(tmp_path, mnist_data, name="t.conf", num_round=2, extra=""):
    conf = str(tmp_path / name)
    with open(conf, "w") as f:
        f.write(jtests.CONF.format(model_dir=str(tmp_path / "models"),
                                   num_round=num_round, **mnist_data)
                + extra)
    return conf


def run_task(conf, *overrides):
    task = LearnTask()
    task.run([conf] + list(overrides))
    return task


# ----------------------------------------------------------------------
# a save that fails part-way, through both callers
def _half_then_enospc(path_of_interest):
    """An ``open`` for the checkpoint module whose writable files take half
    of each write and then raise ENOSPC (a disk that fills mid-save)."""
    real = builtins.open

    class _Full:
        def __init__(self, f):
            self.f = f

        def write(self, data):
            data = bytes(data)
            self.f.write(data[: len(data) // 2])
            self.f.flush()
            raise OSError(errno.ENOSPC, "injected: no space left on device")

        def __getattr__(self, name):
            return getattr(self.f, name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()
            return False

    def fake_open(file, mode="r", *a, **kw):
        f = real(file, mode, *a, **kw)
        if "w" in mode and str(file).startswith(path_of_interest):
            return _Full(f)
        return f
    return fake_open


class _Counting:
    """``failing_once`` / ``always_failing`` that also counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


NET_CFG = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.01
layer[+1:sg1] = sigmoid:se1
layer[sg1->fc2] = fullc:fc2
  nhidden = 10
  init_sigma = 0.01
layer[+0] = softmax
netconfig=end
input_shape = 1,1,64
batch_size = 8
eta = 0.1
momentum = 0.9
"""


def _api_saver(tmp_path, mnist_data):
    """(path, save(), change()) over api.Net.save_model."""
    net = api.Net(dev="cpu", cfg=NET_CFG)
    net.init_model()
    path = str(tmp_path / "net.model")

    def change():
        w = net.get_weight("fc1", "wmat")
        net.set_weight(w + 1.0, "fc1", "wmat")
    return path, lambda: net.save_model(path), change


def _cli_saver(tmp_path, mnist_data):
    """(path, save(), change()) over the command line's round save."""
    task = run_task(_conf(tmp_path, mnist_data, num_round=1))
    path = os.path.join(str(tmp_path / "models"), "0001.model")
    assert os.path.exists(path) and task.start_counter == 2
    task.ckpt_fsync = 1      # the default (the conf turns it off for speed)

    def save():
        task.start_counter = 1
        assert task._save_model(force=True)

    def change():
        p = task.net_trainer.params[0]["wmat"]
        p.data.add_(1.0)
    return path, save, change


SAVERS = {"api.Net.save_model": _api_saver, "cli._save_model": _cli_saver}


@pytest.mark.parametrize("caller", sorted(SAVERS))
def test_atomic_write_rename_failure_retries(caller, tmp_path, mnist_data,
                                             monkeypatch):
    """tests/test_checkpoint_faults.py:172's scenario through the caller:
    the first rename fails, the retry writes the new file."""
    path, save, change = SAVERS[caller](tmp_path, mnist_data)
    save()
    old = open(path, "rb").read()
    change()
    rename = _Counting(fi.failing_once(os.replace))
    monkeypatch.setattr(ckpt.os, "replace", rename)
    save()
    assert rename.calls == 2          # the write went through the rename
    new = open(path, "rb").read()
    assert new != old and ckpt.split_footer(new)[1] == "v1"
    assert not os.path.exists(path + ".tmp")


@pytest.mark.parametrize("caller", sorted(SAVERS))
def test_atomic_write_hard_failure_keeps_old_file(caller, tmp_path,
                                                  mnist_data, monkeypatch):
    path, save, change = SAVERS[caller](tmp_path, mnist_data)
    save()
    old = open(path, "rb").read()
    change()
    monkeypatch.setattr(ckpt.os, "replace", fi.always_failing())
    with pytest.raises(OSError):
        save()
    assert open(path, "rb").read() == old       # bitwise, tolerance zero
    assert not os.path.exists(path + ".tmp")


@pytest.mark.parametrize("caller", sorted(SAVERS))
def test_disk_full_leaves_no_partial_file(caller, tmp_path, mnist_data,
                                          monkeypatch):
    """A disk that fills while the file is written (ENOSPC half-way
    through each write) and one whose fsync fails: the old file stays
    bitwise, and no tmp file is left."""
    path, save, change = SAVERS[caller](tmp_path, mnist_data)
    save()
    old = open(path, "rb").read()
    change()
    monkeypatch.setattr(ckpt, "open", _half_then_enospc(path),
                        raising=False)
    with pytest.raises(OSError):
        save()
    assert open(path, "rb").read() == old
    assert not os.path.exists(path + ".tmp")
    monkeypatch.undo()
    monkeypatch.setattr(ckpt.os, "fsync", fi.always_failing())
    with pytest.raises(OSError):
        save()
    assert open(path, "rb").read() == old
    assert not os.path.exists(path + ".tmp")


# ----------------------------------------------------------------------
# the JAX scenarios against the port
SCENARIOS = (
    "test_footer_roundtrip_and_corruption_classes",
    "test_serializer_rejects_short_and_corrupt_reads",
    "test_missing_state_section_returns_none",
    "test_atomic_write_rename_failure_retries",
    "test_atomic_write_hard_failure_keeps_old_file",
    "test_disk_full_leaves_no_partial_file",
    "test_resume_tolerates_numbering_gaps",
    "test_resume_quarantines_truncated_newest",
    "test_resume_quarantines_bit_flipped_newest",
    "test_resume_all_corrupt_fails_loudly",
    "test_config_mismatch_aborts_without_quarantine",
    "test_stale_tmp_ignored_and_collected",
    "test_legacy_footerless_checkpoint_still_loads",
    "test_save_period_saves_round_zero_and_final",
    "test_max_round_capped_session_saves_final_round",
    "test_retry_io_skips_permanent_errors",
    "test_retention_policy",
    "test_sigterm_emergency_checkpoint_exact_resume",
    "test_sigterm_mid_accumulation_restores_grad_accum",
    "test_ckpt_telemetry_events",
    "test_fsck_flags_every_injected_corruption",
)


@pytest.mark.parametrize("name", SCENARIOS)
def test_jax_checkpoint_scenario_on_the_port(name, trained, mnist_data,
                                             tmp_path, monkeypatch,
                                             capsys):
    from cxxnet_tpu_torch.utils import telemetry
    fn = getattr(jtests, name)
    given = {"trained": trained, "mnist_data": mnist_data,
             "tmp_path": tmp_path, "monkeypatch": monkeypatch,
             "capsys": capsys}
    # a patch context of its own: the scenarios undo their own monkeypatch
    # part-way, which must not undo the swap
    try:
        with pytest.MonkeyPatch.context() as mp:
            for attr, val in (("LearnTask", LearnTask), ("Trainer", Trainer),
                              ("ckpt", ckpt), ("serializer", serializer),
                              ("fi", fi), ("ckpt_fsck", ckpt_fsck)):
                mp.setattr(jtests, attr, val)
            fn(**{p: given[p] for p in inspect.signature(fn).parameters})
    finally:
        # test_ckpt_telemetry_events turns the JAX registry off at its
        # end; the port's is the one its run turned on
        telemetry.disable()


# ----------------------------------------------------------------------
# the training-state section against the JAX package's
def _jax_and_port_trainers(tmp_path, mnist_data, update_period=2):
    """A JAX trainer and a port trainer holding the same model (one
    JAX-written file), the conf's update_period."""
    conf = _conf(tmp_path, mnist_data, num_round=1,
                 extra="update_period = %d\n" % update_period)
    jt = JLearnTask()
    for k, v in JConfigIterator(conf, []):
        jt.set_param(k, v)
    jt.init()
    path = str(tmp_path / "start.model")
    w = jserializer.Writer()
    w.write_int32(0)
    jt.net_trainer.save_model(w)
    jckpt.write_checkpoint(path, w.f.getbuffer(), fsync=False)
    pt = LearnTask()
    for k, v in ConfigIterator(conf, ["model_in=" + path,
                                      "start_counter=0"]):
        pt.set_param(k, v)
    pt.init()
    return jt, pt


def _close(task):
    """Stop a task's iterator threads (the JAX LearnTask has no close)."""
    for itr in [task.itr_train, task.itr_pred] + task.itr_evals:
        if itr is not None:
            itr.close()


def _state_bytes(trainer, extra):
    w = serializer.Writer()
    trainer.save_training_state(w, extra=extra)
    return w.getvalue()


def test_state_section_bytes_equal_the_jax_package(tmp_path, mnist_data):
    """The CXTSTA01 section the port writes for a trainer state equals,
    byte for byte, the one the JAX package writes for the same weights
    and state: counters, the learn task's cursor, the (n_metrics, 2) metric
    sums and the per-layer gradient sums (the port's flat list mapped by
    its weight tags)."""
    import jax.numpy as jnp
    jt, pt = _jax_and_port_trainers(tmp_path, mnist_data)
    try:
        j, p = jt.net_trainer, pt.net_trainer
        extra = {"start_counter": 3, "batches_done": 5}
        assert _state_bytes(p, extra) == _state_bytes(j, extra)
        rs = np.random.RandomState(0)
        ma = rs.randn(len(p.train_metric), 2).astype(np.float32)
        ga = [{k: rs.randn(*np.shape(v)).astype(np.float32)
               for k, v in layer.items()}
              for layer in j.canonical_params()]
        for t in (j, p):
            t._rng_counter, t.sample_counter = 11, 1
        j._metric_accum = jnp.asarray(ma)
        j.grad_accum = [{k: jnp.asarray(v) for k, v in d.items()}
                        for d in ga]
        p._metric_accum = torch.from_numpy(ma)
        p.grad_accum = [torch.from_numpy(ga[i][k])
                        for i, k in p._update_keys()]
        got, want = _state_bytes(p, extra), _state_bytes(j, extra)
        assert got == want and got.startswith(ckpt.STATE_MAGIC)
        # and each side reads the other's section into the same state
        st = p.load_training_state(serializer.Reader(want))
        jst = j.load_training_state(jserializer.Reader(got))
        assert json.dumps({k: v for k, v in st.items()
                           if k not in ("metric_accum", "grad_accum")},
                          sort_keys=True) == \
            json.dumps({k: v for k, v in jst.items()
                        if k not in ("metric_accum", "grad_accum")},
                       sort_keys=True)
        assert np.array_equal(st["metric_accum"], jst["metric_accum"])
        for a, b in zip(st["grad_accum"], jst["grad_accum"]):
            assert set(a) == set(b)
            for k in a:
                assert np.array_equal(a[k], b[k])
    finally:
        _close(jt)
        _close(pt)


def test_state_section_after_updates_matches_the_jax_layout(tmp_path,
                                                            mnist_data):
    """After one update with update_period = 2 on the same batch, both
    packages' sections hold the same meta and the same gradient sums to
    1e-5 (each package's own float32 arithmetic)."""
    jt, pt = _jax_and_port_trainers(tmp_path, mnist_data)
    try:
        for t in (jt, pt):
            t.itr_train.before_first()
            assert t.itr_train.next()
            t.net_trainer.update(t.itr_train.value())
        extra = {"start_counter": 1, "batches_done": 1}
        jst = jt.net_trainer.load_training_state(jserializer.Reader(
            _state_bytes(jt.net_trainer, extra)))
        pst = pt.net_trainer.load_training_state(serializer.Reader(
            _state_bytes(pt.net_trainer, extra)))
        meta = ("rng_counter", "sample_counter", "start_counter",
                "batches_done", "has_grad_accum", "has_metric_accum")
        assert {k: pst[k] for k in meta} == {k: jst[k] for k in meta}
        assert pst["has_grad_accum"] and pst["sample_counter"] == 1
        np.testing.assert_allclose(pst["metric_accum"],
                                   jst["metric_accum"], rtol=1e-5)
        for a, b in zip(pst["grad_accum"], jst["grad_accum"]):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                           atol=1e-5 * np.abs(b[k]).max())
    finally:
        _close(jt)
        _close(pt)


# ----------------------------------------------------------------------
# each package resumes from the other's emergency file
def _killed_run(pkg, tmp_path, mnist_data, monkeypatch):
    """A run of ``pkg`` ("jax" or "port") with update_period = 2 killed by
    SIGTERM after 9 updates (an odd one: mid-accumulation, 3 batches into
    round 1); returns (its task, its model dir)."""
    d = tmp_path / pkg
    d.mkdir()
    conf = _conf(d, mnist_data, num_round=2, extra="update_period = 2\n")
    Task, Tr = (JLearnTask, JTrainer) if pkg == "jax" else \
        (LearnTask, Trainer)
    monkeypatch.setattr(Tr, "update", fi.killing_method(Tr.update, n=9))
    task = Task()
    task.run([conf])
    monkeypatch.undo()
    return task, conf, str(d / "models")


def _resume_init(pkg, conf, models):
    Task, It = (JLearnTask, JConfigIterator) if pkg == "jax" else \
        (LearnTask, ConfigIterator)
    task = Task()
    for k, v in It(conf, ["continue=1", "model_dir=" + models]):
        task.set_param(k, v)
    task.init()
    return task


def _host(x):
    return None if x is None else np.asarray(
        x.detach().cpu().numpy() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_each_package_resumes_from_the_others_emergency_file(
        writer, reader, tmp_path, mnist_data, monkeypatch):
    src, conf, models = _killed_run(writer, tmp_path, mnist_data,
                                    monkeypatch)
    epath = os.path.join(models, ckpt.EMERGENCY_NAME)
    st = ckpt.peek_state(ckpt.read_verified(epath)[0])
    assert (st["start_counter"], st["batches_done"]) == (2, 3)
    assert st["sample_counter"] == 1 and st["has_grad_accum"]
    dst = _resume_init(reader, conf, models)
    try:
        assert dst.start_counter == 2 and dst._resume_batches == 3
        dst.net_trainer.restore_training_state(dst._resume_state)
        a, b = src.net_trainer, dst.net_trainer
        assert b.sample_counter == a.sample_counter == 1
        # the JAX package's eval forwards draw from the stream too, the
        # port's do not: the counter is the file's either way
        assert b._rng_counter == a._rng_counter == st["rng_counter"]
        # the metric sums of the round's 3 trained batches
        assert np.array_equal(_host(b._metric_accum),
                              _host(a._metric_accum))
        ga = a._grad_accum_layers() if writer == "port" else \
            [{k: np.asarray(v) for k, v in d.items()}
             for d in a.grad_accum]
        gb = b._grad_accum_layers() if reader == "port" else \
            [{k: np.asarray(v) for k, v in d.items()}
             for d in b.grad_accum]
        for x, y in zip(ga, gb):
            assert set(x) == set(y)
            for k in x:
                assert np.array_equal(x[k], y[k]), k
        for x, y in zip(a.canonical_params(), b.canonical_params()):
            for k in x:
                assert np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
    finally:
        _close(dst)
    # and the reader's resume runs to the end of the schedule
    task = (JLearnTask if reader == "jax" else LearnTask)()
    task.run([conf, "continue=1"])
    assert task.start_counter == 3
    assert not os.path.exists(epath)


# ----------------------------------------------------------------------
# a conv net with LRN over an augmenting, prefetching image chain
IMG_CONF = """
data = train
iter = imgbin
  image_list = "{lst}"
  image_bin = "{bin}"
  rand_crop = 1
  rand_mirror = 1
iter = threadbuffer
iter = end

netconfig=start
layer[0->1] = conv
  kernel_size = 3
  nchannel = 6
  pad = 1
layer[1->2] = relu
layer[2->3] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[3->4] = max_pooling
  kernel_size = 2
  stride = 2
layer[4->5] = flatten
layer[5->6] = fullc
  nhidden = 16
layer[6->6] = dropout
  threshold = 0.5
layer[6->7] = fullc
  nhidden = 4
layer[7->7] = softmax
netconfig=end

input_shape = 3,12,12
batch_size = 8
dev = cpu
metric = error
eta = 0.05
momentum = 0.9
wd = 0.0005
save_model = 1
num_round = 2
max_round = 2
silent = 1
ckpt_fsync = 0
"""


def test_lrn_conv_net_killed_mid_round_resumes_bit_for_bit(tmp_path,
                                                           monkeypatch):
    """Weights from a numpy seed through convert.params_from_jax; the
    plain LRN version on the CPU; random crops and mirrors drawn by the
    augmenter behind a threadbuffer (6 batches a round). A run killed 2
    batches into round 1 and resumed with continue = 1 ends bit for bit where the
    uninterrupted run ends: the model file, the weights and the
    optimizer state, the rng counter and the eval lines; the resumed run
    trains only the batches the killed one had not."""
    lst, binp = str(tmp_path / "tr.lst"), str(tmp_path / "tr.bin")
    synth.write_pack(((lab, synth.ppm_bytes(img)) for lab, img in
                      synth.images(48, 16, 4, 3)), lst, binp)
    conf = str(tmp_path / "img.conf")
    with open(conf, "w") as f:
        f.write(IMG_CONF.format(lst=lst, bin=binp))
    # the start model: the JAX layouts' weights drawn from a numpy seed
    net = api.Net(dev="cpu", cfg=open(conf).read())
    net.init_model()
    tr = net.net_
    rs = np.random.RandomState(7)
    jax_params = [{k: (0.1 * rs.randn(*v.shape)).astype(np.float32)
                   for k, v in layer.items()} for layer in tr.params]
    tr.params = convert.params_from_jax(jax_params, tr.net, tr.dev)
    start = str(tmp_path / "start" / "0000.model")
    os.makedirs(os.path.dirname(start))
    net.save_model(start)

    def run(models, *extra):
        t = LearnTask()
        t.run([conf, "model_in=" + start, "model_dir=" + models]
              + list(extra))
        return t

    import io
    from contextlib import redirect_stderr
    err_a = io.StringIO()
    with redirect_stderr(err_a):
        task_a = run(str(tmp_path / "a"))
    ma = str(tmp_path / "b")
    monkeypatch.setattr(Trainer, "update",
                        fi.killing_method(Trainer.update, n=6 + 2))
    task_b = run(ma)
    monkeypatch.undo()
    epath = os.path.join(ma, ckpt.EMERGENCY_NAME)
    st = ckpt.peek_state(ckpt.read_verified(epath)[0])
    assert (st["start_counter"], st["batches_done"]) == (2, 2)
    assert "iter_rng" in st and task_b.start_counter == 2
    from cxxnet_tpu_torch.ops import lrn
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = lrn.lrn_ref_with_norm, lrn.lrn_bwd_ref

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return real_bwd(*a, **kw)
    monkeypatch.setattr(lrn, "lrn_ref_with_norm", fwd)
    monkeypatch.setattr(lrn, "lrn_bwd_ref", bwd)
    err_c = io.StringIO()
    with redirect_stderr(err_c):
        task_c = LearnTask()
        task_c.run([conf, "continue=1", "model_dir=" + ma])
    monkeypatch.undo()
    assert task_c.start_counter == task_a.start_counter == 3
    # the plain LRN ran for the 4 batches left in round 1 only, once
    # forward and once backward each: the 2 drained batches ran no net
    assert calls == {"fwd": 6 - 2, "bwd": 6 - 2}
    want = open(os.path.join(str(tmp_path / "a"), "0002.model"),
                "rb").read()
    assert open(os.path.join(ma, "0002.model"), "rb").read() == want
    assert not os.path.exists(epath)
    assert task_c.net_trainer._rng_counter == task_a.net_trainer._rng_counter
    for x, y in zip(task_a.net_trainer.canonical_params(),
                    task_c.net_trainer.canonical_params()):
        for k in x:
            assert np.array_equal(x[k], y[k]), k
    ea = [ln for ln in err_a.getvalue().splitlines() if ln.startswith("[")]
    ec = [ln for ln in err_c.getvalue().splitlines() if ln.startswith("[")]
    assert ec and ea[-1] == ec[-1]


def test_serve_reload_scan_ranks_the_emergency_file_and_quarantines(
        tmp_path, mnist_data, monkeypatch):
    """The scan a serve reload runs (``_sync_latest_model`` from counter
    0): the emergency file of a preempted run outranks the numbered files
    by its cursor; a corrupt one is quarantined and the newest valid
    numbered file is served instead."""
    task, conf, models = _killed_run("port", tmp_path, mnist_data,
                                     monkeypatch)
    epath = os.path.join(models, ckpt.EMERGENCY_NAME)
    serve = LearnTask()
    for k, v in ConfigIterator(conf, ["task=serve", "model_dir=" + models,
                                      "model_in=" + os.path.join(
                                          models, "0000.model")]):
        serve.set_param(k, v)
    serve.start_counter = 0
    assert serve._sync_latest_model() == 1
    assert (serve.start_counter, serve._resume_batches) == (2, 3)
    for x, y in zip(task.net_trainer.canonical_params(),
                    serve.net_trainer.canonical_params()):
        for k in x:
            assert np.array_equal(x[k], y[k])
    fi.bit_flip(epath)
    serve.start_counter = 0
    assert serve._sync_latest_model() == 1
    assert (serve.start_counter, serve._resume_batches) == (2, 0)
    assert not os.path.exists(epath) and os.path.exists(epath + ".corrupt")
