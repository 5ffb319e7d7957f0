"""The port's command-line driver (cxxnet_tpu_torch.learn_task) against the
JAX package's (cxxnet_tpu.learn_task), both in process on the CPU
(``dev=cpu``), on three configs:

* example/MNIST/MNIST.conf;
* example/MNIST/MNIST_CONV.conf with its dropout threshold set to 0 (the
  two packages draw different dropout bits; everything else is the file);
* an imgbin + threadbuffer AlexNet-shaped config at small width with an
  LRN layer, a mean image and random crops and mirrors, on a PPM pack.

The data comes from tests/synth_mnist.py and cxxnet_tpu_torch.io.synth.
The JAX CLI initializes a model (``num_round=0``); both CLIs train two
rounds from it (``model_in``). Compared: the ``[round]`` eval lines on
stderr, exactly; every saved model's weights and optimizer state; the
``pred`` file line for line; ``pred_raw`` and ``extract`` (with its
``.meta``) to 1e-5.

Tolerance for the weights: the bar tests/test_torch_train.py holds a step
to (relative 1e-5 plus 1e-5 of the tensor's largest magnitude) with the
absolute part taken once for every step trained so far: after round r,
6 r steps on MNIST and 4 r on the image config. The packages sum conv and
fullc products in other orders, and each step adds its rounding to the
weights. On the image config, whose unscaled pixels move conv1's weights
by about their own magnitude in a round, the difference measured 2.6e-5
of the largest weight after round 1 and 3.4e-5 after round 2 on an
earlier synthetic pack, and 1.6e-6 on io.synth's pack of today.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from cxxnet_tpu import learn_task as jlt
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import learn_task as tlt
from cxxnet_tpu_torch.io import synth

from tests.synth_mnist import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL_REL = 1e-5, 1e-5
PAGE = 1 << 14

IMAGE_CONF = """
data = train
iter = imgbin
  image_list = "../tr.lst"
  image_bin = "../tr.bin"
  image_mean = "mean.bin"
  page_size = %(page)d
  rand_crop = 1
  rand_mirror = 1
iter = threadbuffer
iter = end
eval = test
iter = imgbin
  image_list = "../te.lst"
  image_bin = "../te.bin"
  image_mean = "mean.bin"
  page_size = %(page)d
iter = end
netconfig=start
layer[0->1] = conv:c1
  kernel_size = 5
  stride = 2
  nchannel = 16
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 3
  stride = 2
layer[3->4] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[4->5] = conv:c2
  nchannel = 16
  kernel_size = 3
  pad = 1
layer[5->6] = relu
layer[6->7] = flatten
layer[7->8] = fullc:fc
  nhidden = 10
layer[8->8] = softmax
netconfig=end
input_shape = 3,32,32
batch_size = 16
metric = error
metric = rec@5
momentum = 0.9
wmat:lr = 0.01
wmat:wd = 0.0005
bias:wd = 0
bias:lr = 0.02
random_type = xavier
dev = cpu
""" % {"page": PAGE}

PRED_SECTION = {
    "mnist": """
pred = pred.txt
iter = mnist
  path_img = "./data/t10k-images-idx3-ubyte.gz"
  path_label = "./data/t10k-labels-idx1-ubyte.gz"
  input_flat = %d
iter = end
""",
    "image": """
pred = pred.txt
iter = imgbin
  image_list = "../te.lst"
  image_bin = "../te.bin"
  image_mean = "mean.bin"
  page_size = %d
iter = threadbuffer
iter = end
""" % PAGE}

CONFS = ("MNIST", "MNIST_CONV", "image")
STEPS_PER_ROUND = {"MNIST": 6, "MNIST_CONV": 6, "image": 4}


@pytest.fixture(scope="module", autouse=True)
def flush_denormals():
    """XLA's CPU code flushes subnormal floats to zero and PyTorch's does
    not. The image config drives some softmax rows to underflow within a
    round (its pixels are unscaled), where JAX's exact zeros tie and the
    port's subnormals would rank: the port's CPU path flushes them here
    too, so both packages see the same ties (ranked by index in both)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def cli(mod, conf, args, cwd):
    """Run one package's CLI in ``cwd``; returns (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert mod.LearnTask().run([conf] + list(args)) == 0
    finally:
        os.chdir(old)
    return out.getvalue(), err.getvalue()


def eval_lines(stderr):
    return [ln for ln in stderr.splitlines() if ln.startswith("[")]


def _conf_text(name):
    if name == "image":
        return IMAGE_CONF + PRED_SECTION["image"]
    text = open(os.path.join(REPO, "example/MNIST/%s.conf" % name)).read()
    if name == "MNIST_CONV":
        # the two packages draw different dropout bits
        text = text.replace("threshold = 0.5", "threshold = 0")
    return text + PRED_SECTION["mnist"] % (name == "MNIST")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    make_dataset(str(root / "mnist"), n_train=600, n_test=200)
    d = str(root / "img")
    os.makedirs(d)
    synth.make_ppm_pack(d, "tr", 64, 36, 10, seed=0, page_ints=PAGE)
    synth.make_ppm_pack(d, "te", 40, 36, 10, seed=1, page_ints=PAGE)
    return root


def _workdir(root, name, side):
    """A working directory per (config, side): the MNIST configs read
    ./data, the image config ../tr.lst; each side keeps its own mean
    image and models."""
    base = root / ("img" if name == "image" else "mnist_" + name)
    if not base.exists():
        base.mkdir()
    wd = base / side if name != "image" else root / "img" / (name + side)
    if not wd.exists():
        wd.mkdir()
        if name != "image":
            os.symlink(str(root / "mnist"), str(wd / "data"))
    conf = wd / "task.conf"
    conf.write_text(_conf_text(name))
    return str(wd), str(conf)


@pytest.fixture(scope="module")
def trained(data_root):
    """runs(name): both CLIs' two rounds from one JAX-initialized model."""
    made = {}

    def get(name):
        if name in made:
            return made[name]
        init_wd, conf = _workdir(data_root, name, "init")
        cli(jlt, conf, ["dev=cpu", "num_round=0", "model_dir=models"],
            init_wd)
        model0 = os.path.join(init_wd, "models", "0000.model")
        run = {"conf": conf, "model0": model0}
        for side, mod in (("jax", jlt), ("port", tlt)):
            wd, conf = _workdir(data_root, name, side)
            out, err = cli(mod, conf, ["dev=cpu", "model_in=" + model0,
                                       "num_round=2", "save_model=1",
                                       "model_dir=models"], wd)
            run[side] = {"wd": wd, "conf": conf, "out": out, "err": err}
        made[name] = run
        return run
    return get


def _trainer(path, conf):
    net = tapi.Net(dev="cpu", cfg=open(conf).read())
    net.load_model(path)
    return net.net_


def _close(got, want, what, steps=1):
    got = got.detach().cpu().numpy()
    want = want.detach().cpu().numpy()
    np.testing.assert_allclose(
        got, want, rtol=RTOL,
        atol=steps * ATOL_REL * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("name", CONFS)
def test_eval_lines_match_jax(trained, name):
    run = trained(name)
    got, want = eval_lines(run["port"]["err"]), eval_lines(run["jax"]["err"])
    assert [ln.split("\t")[0] for ln in want] == ["[1]", "[2]"]
    assert got == want
    # the round lines on stdout have the JAX format
    assert re.search(r"round 1: input-wait [\d.]+% \(io [\d.inf]+ img/s "
                     r"when blocked, step [\d.inf]+ img/s\)",
                     run["port"]["out"])


@pytest.mark.parametrize("counter", [1, 2])
@pytest.mark.parametrize("name", CONFS)
def test_models_match_jax(trained, name, counter):
    run = trained(name)
    fname = "models/%04d.model" % counter
    got = _trainer(os.path.join(run["port"]["wd"], fname), run["conf"])
    want = _trainer(os.path.join(run["jax"]["wd"], fname), run["conf"])
    steps = counter * STEPS_PER_ROUND[name]
    assert got.epoch_counter == want.epoch_counter == steps
    for i, (gp, wp) in enumerate(zip(got.params, want.params)):
        for k in wp:
            _close(gp[k], wp[k], "round %d layer %d %s" % (counter, i, k),
                   steps)
    for i, (gs, ws) in enumerate(zip(got.opt_state, want.opt_state)):
        for k in ws:
            for sk in ws[k]:
                _close(gs[k][sk], ws[k][sk],
                       "round %d layer %d %s/%s" % (counter, i, k, sk),
                       steps)


def _predict(run, task, writer, extra=()):
    """Both CLIs' output file of ``task`` on the model ``writer`` saved
    after round 2."""
    model = os.path.join(run[writer]["wd"], "models", "0002.model")
    outs = {}
    for side, mod in (("jax", jlt), ("port", tlt)):
        wd = run[side]["wd"]
        cli(mod, run[side]["conf"], ["dev=cpu", "task=" + task,
                                     "model_in=" + model,
                                     "pred=%s_%s.txt" % (task, writer)]
            + list(extra), wd)
        outs[side] = os.path.join(wd, "%s_%s.txt" % (task, writer))
    return outs


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", CONFS)
def test_pred_matches_jax_line_for_line(trained, name, writer):
    outs = _predict(trained(name), "pred", writer)
    got, want = open(outs["port"]).read(), open(outs["jax"]).read()
    assert got.splitlines() == want.splitlines()
    assert len(want.splitlines()) == (40 if name == "image" else 200)


def _rows(path):
    return np.array([[float(x) for x in ln.split()]
                     for ln in open(path).read().splitlines()])


@pytest.mark.parametrize("name", CONFS)
def test_pred_raw_and_extract_match_jax(trained, name):
    run = trained(name)
    outs = _predict(run, "pred_raw", "jax")
    got, want = _rows(outs["port"]), _rows(outs["jax"])
    assert got.shape == want.shape == (40 if name == "image" else 200, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    node = {"MNIST": "fc1", "MNIST_CONV": "top[-4]", "image": "top[-3]"}[name]
    for fmt in ("txt", "bin"):
        outs = _predict(run, "extract", "jax",
                        ["extract_node_name=" + node, "output_format=" + fmt])
        metas = [open(outs[s] + ".meta").read() for s in ("port", "jax")]
        assert metas[0] == metas[1]
        if fmt == "txt":
            got, want = _rows(outs["port"]), _rows(outs["jax"])
        else:
            got, want = (np.fromfile(outs[s], "<f4") for s in ("port", "jax"))
        assert got.shape == want.shape and got.size > 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_finetune_matches_jax(trained, data_root):
    run = trained("MNIST")
    model = os.path.join(run["jax"]["wd"], "models", "0002.model")
    files = {}
    for side, mod in (("jax", jlt), ("port", tlt)):
        wd = os.path.join(run[side]["wd"], "ft")
        os.makedirs(wd)
        os.symlink(str(data_root / "mnist"), os.path.join(wd, "data"))
        _, err = cli(mod, run["conf"], ["dev=cpu", "task=finetune",
                                        "model_in=" + model, "num_round=1",
                                        "model_dir=ft"], wd)
        files[side] = (sorted(os.listdir(os.path.join(wd, "ft"))),
                       eval_lines(err), wd)
    assert files["port"][:2] == files["jax"][:2]
    for fname in files["jax"][0]:
        got = _trainer(os.path.join(files["port"][2], "ft", fname),
                       run["conf"])
        want = _trainer(os.path.join(files["jax"][2], "ft", fname),
                        run["conf"])
        for gp, wp in zip(got.params, want.params):
            for k in wp:
                _close(gp[k], wp[k], fname + " " + k)


def test_fresh_model_and_save_counter_follow_jax(data_root, tmp_path):
    """model_in = NULL starts a fresh model; save_model = 2 saves the
    counters 0 and 2 and the session's last round, as the JAX CLI does."""
    names = {}
    for side, mod in (("jax", jlt), ("port", tlt)):
        wd = tmp_path / side
        wd.mkdir()
        os.symlink(str(data_root / "mnist"), str(wd / "data"))
        conf = os.path.join(REPO, "example/MNIST/MNIST.conf")
        out, _ = cli(mod, conf, ["dev=cpu", "num_round=3", "save_model=2",
                                 "model_dir=m"], str(wd))
        names[side] = sorted(os.listdir(str(wd / "m")))
    assert names["port"] == names["jax"] == \
        ["0000.model", "0002.model", "0003.model"]


def test_model_name_without_counter_is_refused_for_training(trained,
                                                            tmp_path):
    run = trained("MNIST")
    odd = tmp_path / "best.model"
    odd.write_bytes(open(run["model0"], "rb").read())
    with pytest.raises(ValueError, match="start_counter"):
        cli(tlt, run["conf"], ["dev=cpu", "model_in=%s" % odd],
            run["port"]["wd"])


@pytest.mark.parametrize("key, val", [
    ("continue", "1"), ("telemetry_log", "t.jsonl"), ("status_port", "0"),
    ("profile_dir", "prof"), ("health_monitor", "1"),
    ("watchdog_timeout", "5"), ("coordinator", "localhost:1234"),
    ("num_worker", "2"), ("ckpt_keep_last", "3"), ("ckpt_keep_every", "2"),
    ("task", "serve"), ("task", "export"), ("task", "route")])
def test_unported_keys_are_refused(key, val):
    lt = tlt.LearnTask()
    with pytest.raises(ValueError, match="not ported to cxxnet_tpu_torch"):
        lt.set_param(key, val)


@pytest.mark.parametrize("key, val", [
    ("continue", "0"), ("telemetry_log", ""), ("status_port", "-1"),
    ("health_monitor", "0"), ("watchdog_timeout", "0"), ("num_worker", "1"),
    ("ckpt_keep_last", "0"), ("task", "pred_raw"), ("task", "generate")])
def test_defaults_of_unported_keys_are_accepted(key, val):
    tlt.LearnTask().set_param(key, val)


def test_config_dev_is_honoured_and_the_command_line_overrides_it(
        monkeypatch):
    """dev = cpu in MNIST.conf keeps the net on the CPU; dev=gpu on the
    command line moves it to the card, which this machine lacks."""
    conf = os.path.join(REPO, "example/MNIST/MNIST.conf")
    lt = tlt.LearnTask()
    for k, v in tlt.ConfigIterator(conf, []):
        lt.set_param(k, v)
    assert lt._create_net().dev_spec == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlt.LearnTask().run([conf, "dev=gpu"])
