"""The port's offline tools (cxxnet_tpu_torch/tools/) on the CPU, against
the JAX package's tools under tools/: the cases of tests/test_roofline.py,
the report cases of tests/test_telemetry.py and tests/test_e2e.py whose
runs the port makes (its telemetry, its command line) and the report
case of tests/test_health_faults.py that reads a written log, each
through the twin (the rest of that file runs on the port in
tests/test_torch_health_faults.py); differential runs that give one log
written by the port to both report tools (``--json`` aggregates and the
rendered report equal: a training run, a training run that rolls back
from a NaN batch, a serving run), the
same model files and corruptions to both checkers (equal verdicts), the
zoo to both roofline tools (equal FLOPs per sample for AlexNet, GoogLeNet,
ResNet-18, VGG-16 and both LM rows, equal decode-bound bytes), and one
per-request trace to both trace tools (equal output); and the profiler
mode of the trace twin on a synthetic trace in ``torch.profiler``'s event
format.

A JAX case runs against the port by swapping the globals of its test
module that name the tool and the package modules it drives for the
port's, for the length of the case (a tool a case imports inside its body
is swapped in ``sys.modules``).
"""

import gzip
import inspect
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import cxxnet_tpu.utils as jutils
from cxxnet_tpu.nnet.trainer import Trainer as JTrainer
from cxxnet_tpu.utils import checkpoint as jckpt
from cxxnet_tpu_torch import api, models
from cxxnet_tpu_torch.learn_task import LearnTask
from cxxnet_tpu_torch.nnet.trainer import Trainer
from cxxnet_tpu_torch.tools import (ckpt_fsck, roofline, summarize_trace,
                                    telemetry_report)
from cxxnet_tpu_torch.utils import checkpoint as ckpt
from cxxnet_tpu_torch.utils import perf, servd, telemetry
from cxxnet_tpu_torch.utils.config import parse_config_string

from . import faultinject as jfi
from . import synth_mnist
from . import test_e2e as je2e_tests
from . import test_health_faults as jhealth_tests
from . import test_roofline as jroofline_tests
from . import test_telemetry as jtelemetry_tests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import ckpt_fsck as jckpt_fsck  # noqa: E402
import roofline as jroofline  # noqa: E402
import summarize_trace as jsummarize_trace  # noqa: E402
import telemetry_report as jtelemetry_report  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_registries():
    """Telemetry is process-global in both packages: every case starts
    and ends with both registries off and empty."""
    from cxxnet_tpu.utils import telemetry as jtelemetry
    for mod in (telemetry, jtelemetry):
        mod.disable()
        mod.reset()
    # a program carded before would not card itself again in this case
    perf.reset()
    yield
    for mod in (telemetry, jtelemetry):
        mod.disable()
        mod.reset()
    perf.reset()


def _run_case(mod, name, given):
    fn = getattr(mod, name)
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


# ----------------------------------------------------------------------
# roofline
def _port_lm_trainer(vocab=50, seq=16, batch_size=8, dim=64, nhead=4,
                     nlayer=2, dev="cpu", extra_cfg="", attn_extra=""):
    """The port's counterpart of the JAX ``transformer_lm_trainer``."""
    tr = Trainer()
    for k, v in parse_config_string(models.transformer_lm_config(
            vocab=vocab, seq=seq, batch_size=batch_size, dim=dim,
            nhead=nhead, nlayer=nlayer, dev="cpu", extra_cfg=extra_cfg,
            attn_extra=attn_extra)):
        tr.set_param(k, v)
    tr.init_model()
    return tr


ROOFLINE_CASES = ("test_attention_projection_flops_scale_with_L",
                  "test_decode_bound_hand_computed",
                  "test_decode_bound_window_caps_kv_read")


def test_every_roofline_case_is_run():
    names = {n for n, f in vars(jroofline_tests).items()
             if n.startswith("test_") and callable(f)}
    assert names == set(ROOFLINE_CASES)


@pytest.mark.parametrize("name", ROOFLINE_CASES)
def test_jax_roofline_case_on_the_port(name, monkeypatch):
    monkeypatch.setattr(jroofline_tests, "roofline", roofline)
    monkeypatch.setattr(jroofline_tests, "transformer_lm_trainer",
                        _port_lm_trainer)
    _run_case(jroofline_tests, name, {})


def test_roofline_peaks_come_from_the_port_table(monkeypatch):
    monkeypatch.delenv("CXXNET_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("CXXNET_PEAK_HBM_GBS", raising=False)
    assert roofline.peak_flops() == perf.DEVICE_SPECS["h100"].peak_flops
    assert roofline.peak_hbm_bytes() == perf.DEVICE_SPECS["h100"].hbm_bw
    monkeypatch.setenv("CXXNET_PEAK_TFLOPS", "100")
    monkeypatch.setenv("CXXNET_PEAK_HBM_GBS", "1000")
    assert roofline.peak_flops() == 100e12
    assert roofline.peak_hbm_bytes() == 1000e9


def _jax_shapes_only(monkeypatch):
    """The JAX model functions' trainers with their net and numpy weights only:
    no optimizer state and nothing put on a device (FLOPs are shape
    arithmetic)."""
    def init_model(self):
        self._init_net_structure()
        self.params = self.net.init_params(self.seed)
    monkeypatch.setattr(JTrainer, "init_model", init_model)
    monkeypatch.setattr(JTrainer, "canonical_params", lambda self:
                        self.params)


ZOO = ("alexnet", "googlenet", "resnet18", "vgg16", "mobilenet", "vit_s16",
       "transformer_lm_L2048", "transformer_lm_L8192_gqa_window")


@pytest.mark.parametrize("name", ZOO)
def test_zoo_flops_equal_the_jax_tool(name, monkeypatch):
    """Both tools' zoo rows count the same FLOPs per sample (per token
    for the LMs): the port's nets from its own config functions and the
    repo's configs (AlexNet: example/ImageNet/ImageNet.conf), the JAX
    tool's from the JAX model functions."""
    _jax_shapes_only(monkeypatch)
    (got,) = roofline.zoo([name])
    (want,) = jroofline.zoo([name])
    assert got[0] == want[0] == name and got[2] == want[2]
    assert got[1] == want[1], (got, want)


def test_zoo_skips_the_unported_models_as_the_jax_tool_does(capsys):
    """Every zoo model is ported: mobilenet and vit_s16 give their rows
    (no longer "skipped"), in the order asked, with nothing skipped."""
    rows = roofline.zoo(["mobilenet", "vit_s16", "alexnet"])
    assert [r[0] for r in rows] == ["alexnet", "mobilenet", "vit_s16"]
    assert all(r[2] == "img" and r[1] > 0 for r in rows)
    assert "skipped" not in capsys.readouterr().err


def test_decode_bound_bytes_equal_the_jax_tool(monkeypatch):
    """decode_zoo's rows: equal parameter bytes, and bounds that differ
    by the two tables' bandwidths alone."""
    _jax_shapes_only(monkeypatch)
    jrows = {r[0]: r for r in jroofline.decode_zoo()}
    for name, build, batch, plen, gen_to in roofline.decode_zoo():
        jb = jrows[name]
        assert (batch, plen, gen_to) == tuple(jb[2:])
        bound, pbytes = roofline.decode_bound(build(), batch, plen, gen_to)
        jbound, jpbytes = jroofline.decode_bound(jb[1](), batch, plen,
                                                 gen_to)
        assert pbytes == jpbytes
        assert bound / roofline.peak_hbm_bytes() == pytest.approx(
            jbound / jroofline.peak_hbm_bytes(), rel=1e-12)


def test_roofline_main_tables(capsys, tmp_path):
    bench = tmp_path / "b.jsonl"
    bench.write_text('{"metric": "alexnet_imagenet", "value": 1000.0}\n'
                     '{"metric": "vgg16_imagenet", "value": null}\n')
    roofline.main(["--bench", str(bench), "alexnet", "vgg16"])
    out = capsys.readouterr().out
    f = roofline.zoo(["alexnet"])[0][1]
    assert "# 1 bench row(s) skipped" in out
    assert "| alexnet | %.2f | %.2f | 1000 | %.1f%% |" % (
        f / 1e9, 3 * f / 1e9, 100.0 * 1000 * 3 * f / 989e12) in out
    assert "| vgg16 |" in out and "| googlenet |" not in out
    roofline.main(["--decode"])
    out = capsys.readouterr().out
    assert "lm_decode (b8, 64->2048)" in out and "HBM 3350 GB/s" in out


# ----------------------------------------------------------------------
# summarize_trace
def _profiler_trace():
    """Events as torch.profiler's Chrome export writes them: host lanes
    (python_function, cpu_op, cuda_runtime, user_annotation), the card's
    kernels, copies and sets on its stream lanes, and the annotation
    lane the profiler mirrors onto the card."""
    lrn_fwd = ("void (anonymous namespace)::lrn_fwd_kernel<float>(float "
               "const*, float*, float*, long, int, long, int, float, float, "
               "float)")
    ev = [
        {"ph": "M", "name": "process_name", "pid": 4242,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "python_function", "name": "train.py: step",
         "pid": 4242, "tid": 4242, "ts": 0.0, "dur": 900.0},
        {"ph": "X", "cat": "user_annotation", "name": "train.step",
         "pid": 4242, "tid": 4242, "ts": 0.0, "dur": 800.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train.step",
         "pid": 0, "tid": 7, "ts": 10.0, "dur": 700.0},
        {"ph": "X", "cat": "cpu_op", "name": "cxxnet::lrn_fwd",
         "pid": 4242, "tid": 4242, "ts": 1.0, "dur": 30.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 4242, "tid": 4242, "ts": 2.0, "dur": 5.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 0,
         "tid": 7, "ts": 20.0},
    ]
    t = 20.0
    for name, cat, dur, n in ((lrn_fwd, "kernel", 180.0, 10),
                              ("lrn_bwd_kernel<float>", "kernel", 240.0, 8),
                              ("Memcpy HtoD (Pageable -> Device)",
                               "gpu_memcpy", 50.0, 2),
                              ("Memset (Device)", "gpu_memset", 2.0, 3)):
        for _ in range(n):
            ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                       "tid": 7, "ts": t, "dur": dur,
                       "args": {"device": 0, "stream": 7}})
            t += dur
    return {"schemaVersion": 1, "deviceProperties": [{"id": 0}],
            "traceEvents": ev}


def test_summarize_trace_ranks_the_device_ops(tmp_path, capsys):
    trace = _profiler_trace()
    path = tmp_path / "prof" / "trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps(trace))
    summarize_trace.main([str(tmp_path / "prof"), "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "trace: %s" % path
    total = 10 * 180.0 + 8 * 240.0 + 2 * 50.0 + 3 * 2.0
    assert out[1] == ("device-lane total: %.1f ms over 4 distinct ops"
                      % (total / 1e3))
    rows = out[3:]
    assert len(rows) == 3             # top_n
    assert rows[0].startswith("lrn_bwd_kernel<float>")
    assert rows[0].split()[-3:] == ["1.92", "8",
                                    "%.1f%%" % (100 * 1920 / total)]
    assert "lrn_fwd_kernel<float>" in rows[1]
    assert rows[1].split()[-3:] == ["1.80", "10",
                                    "%.1f%%" % (100 * 1800 / total)]
    assert rows[2].startswith("Memcpy HtoD")
    text = "\n".join(out)
    for host in ("cudaLaunchKernel", "cxxnet::lrn_fwd", "train.step",
                 "train.py"):
        assert host not in text
    # the JAX tool keeps only TPU / XLA lanes: it finds nothing here
    sys.argv, old = ["summarize_trace.py", str(path)], sys.argv
    try:
        jsummarize_trace.main()
    finally:
        sys.argv = old
    assert "over 0 distinct ops" in capsys.readouterr().out


def test_summarize_trace_reads_gzip_and_picks_the_newest(tmp_path, capsys):
    trace = _profiler_trace()
    for name in ("a.json", "b.json.gz"):
        opener = gzip.open if name.endswith(".gz") else open
        with opener(str(tmp_path / name), "wt") as f:
            json.dump(trace if name.endswith(".gz") else {"traceEvents": []},
                      f)
    summarize_trace.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert "b.json.gz" in out and "over 4 distinct ops" in out
    with pytest.raises(SystemExit):
        summarize_trace.main([str(tmp_path / "nothing_here")])


def test_request_traces_render_as_the_jax_tool_renders(tmp_path, capsys):
    """One per-request trace (the phase lanes and a recompile) through
    both tools: the same lines."""
    ev = [{"ph": "X", "name": "queue_wait", "ts": 0.0, "dur": 1500.0,
           "args": {"request": "r-9", "outcome": "served"}},
          {"ph": "X", "name": "dispatch", "ts": 1500.0, "dur": 200.0},
          {"ph": "X", "name": "prefill", "ts": 1700.0, "dur": 4000.0},
          {"ph": "X", "name": "decode", "ts": 5700.0, "dur": 9000.0},
          {"ph": "X", "name": "compile:jit.decode_step", "ts": 1800.0,
           "dur": 2500.0, "args": {"cause": "new_signature"}}]
    p = tmp_path / "req.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    summarize_trace.main([str(p)])
    mine = capsys.readouterr().out
    sys.argv, old = ["summarize_trace.py", str(p)], sys.argv
    try:
        jsummarize_trace.main()
    finally:
        sys.argv = old
    assert mine == capsys.readouterr().out
    assert "request r-9 (served): total 14.70ms" in mine


# ----------------------------------------------------------------------
# ckpt_fsck
def test_ckpt_fsck_selftest():
    assert ckpt_fsck.selftest() == 0
    out = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.ckpt_fsck",
         "--selftest"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "all corruption classes detected" in out.stdout


MLP = """
netconfig = start
layer[0->1] = fullc:fc1
  nhidden = 16
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 4
layer[3->3] = softmax
netconfig = end
input_shape = 1,1,12
batch_size = 4
updater = sgd
momentum = 0.9
eta = 0.1
dev = cpu
"""


@pytest.fixture()
def corrupted(tmp_path):
    """A model directory the port wrote (3 checkpoints of a small MLP),
    then damaged as tests/faultinject.py damages files: one truncated, one
    with a bit flipped, one torn at its footer, a footer-less legacy copy,
    a stale tmp and a quarantined copy."""
    d = tmp_path / "models"
    d.mkdir()
    net = api.Net(dev="cpu", cfg=MLP)
    net.init_model()
    rs = np.random.RandomState(0)
    for i in range(6):
        net.update(data=rs.rand(4, 12).astype(np.float32),
                   label=rs.randint(0, 4, (4, 1)).astype(np.float32))
        if i % 2:
            net.save_model(str(d / ("%04d.model" % (i // 2 + 1))))
    good = str(d / "0001.model")
    jfi.truncate(str(d / "0002.model"))
    jfi.bit_flip(str(d / "0003.model"))
    blob = open(good, "rb").read()
    (d / "0004.model").write_bytes(blob[:-1])
    payload, _ = ckpt.read_verified(good)
    (d / "0005.model").write_bytes(payload)
    (d / "0006.model").write_bytes(payload[:len(payload) // 2])
    jfi.make_stale_tmp(str(d))
    (d / "0007.model.corrupt").write_bytes(blob[:100])
    return str(d)


def test_fsck_verdicts_equal_the_jax_tool(corrupted, capsys):
    files = sorted(os.path.join(corrupted, f) for f in os.listdir(corrupted))
    for path in files + [corrupted]:
        for deep in (False, True):
            if os.path.isdir(path):
                args = [path, "--json"] + (["--deep"] if deep else [])
                rc = ckpt_fsck.main(args)
                mine = json.loads(capsys.readouterr().out)
                jrc = jckpt_fsck.main(args)
                want = json.loads(capsys.readouterr().out)
                assert (rc, mine) == (jrc, want)
                continue
            got = ckpt_fsck.inspect_file(path, deep=deep)
            want = jckpt_fsck.inspect_file(path, deep=deep)
            # the deep parse's message names each package's own error
            assert {k: v for k, v in got.items() if k != "reason"} == \
                {k: v for k, v in want.items() if k != "reason"}, path
            assert bool(got["reason"]) == bool(want["reason"])
    verdicts = {os.path.basename(r["path"]): r["status"] for r in mine[
        "checkpoints"]}
    assert verdicts == {"0001.model": "ok", "0002.model": "corrupt",
                        "0003.model": "corrupt", "0004.model": "corrupt",
                        "0005.model": "legacy", "0006.model": "corrupt"}
    assert [os.path.basename(p) for p in mine["stale_tmp"]] == \
        ["9999.model.tmp"]
    assert [os.path.basename(p) for p in mine["quarantined"]] == \
        ["0007.model.corrupt"]


def test_fsck_deep_parse_and_quarantine(corrupted, capsys):
    """--deep loads each readable file through the port's net: the legacy
    copy cut in half passes the framing check (it has none) and fails the
    parse; --quarantine moves the corrupt files aside as the trainer
    would; a quarantined copy named on the command line is reported bad."""
    half = os.path.join(corrupted, "0006.model")
    assert ckpt_fsck.inspect_file(half)["status"] == "legacy"
    rep = ckpt_fsck.inspect_file(half, deep=True)
    assert rep["status"] == "corrupt" and "deep parse failed" in \
        rep["reason"]
    good = ckpt_fsck.inspect_file(os.path.join(corrupted, "0001.model"),
                                  deep=True)
    assert good["status"] == "ok" and good["state"] is not None
    q = os.path.join(corrupted, "0007.model.corrupt")
    assert ckpt_fsck.main([q, "--deep"]) == 1
    assert "CORRUPT" in capsys.readouterr().out
    assert ckpt_fsck.main([corrupted, "--quarantine"]) == 1
    left = sorted(os.listdir(corrupted))
    assert "0002.model" not in left and any(
        n.startswith("0002.model.corrupt") for n in left)
    assert "0001.model" in left


POOL_NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 4
layer[1->2] = max_pooling
  kernel_size = 2
  stride = 2
layer[2->3] = flatten
layer[3->4] = fullc:fc
  nhidden = 3
layer[4->4] = softmax
netconfig = end
input_shape = 1,8,8
batch_size = 2
dev = cpu
"""


def test_fsck_deep_parse_of_a_pooling_net_takes_its_config(tmp_path,
                                                           capsys):
    """A model file does not carry a pooling layer's size: without its
    config the deep parse fails in both tools alike; the twin's --conf
    gives the net its config first, as the command line does."""
    conf = tmp_path / "net.conf"
    conf.write_text(POOL_NET)
    net = api.Net(dev="cpu", cfg=POOL_NET)
    net.init_model()
    path = str(tmp_path / "0001.model")
    net.save_model(path)
    for tool in (ckpt_fsck, jckpt_fsck):
        rep = tool.inspect_file(path, deep=True)
        assert rep["status"] == "corrupt" and "kernel_size" in rep["reason"]
    assert ckpt_fsck.main([path, "--deep", "--conf", str(conf)]) == 0
    assert "OK " in capsys.readouterr().out


# ----------------------------------------------------------------------
# telemetry_report
TELEMETRY_CASES = ("test_counters_flushed_incrementally",
                   "test_report_tool_roundtrip",
                   "test_report_tool_rejects_malformed")


@pytest.mark.parametrize("name", TELEMETRY_CASES)
def test_jax_telemetry_report_case_on_the_port(name, tmp_path, capsys,
                                               monkeypatch):
    monkeypatch.setattr(jtelemetry_tests, "telemetry", telemetry)
    monkeypatch.setitem(sys.modules, "telemetry_report", telemetry_report)
    _run_case(jtelemetry_tests, name, {"tmp_path": tmp_path,
                                       "capsys": capsys})


def test_jax_health_report_case_on_the_port(tmp_path, capsys, monkeypatch):
    """tests/test_health_faults.py's exit-2 gate on an unresolved anomaly,
    through the twin (the rest of that file runs on the port in
    tests/test_torch_health_faults.py)."""
    monkeypatch.setattr(jhealth_tests, "telemetry_report", telemetry_report)
    _run_case(jhealth_tests,
              "test_telemetry_report_exits_2_on_unresolved_anomaly",
              {"tmp_path": tmp_path, "capsys": capsys})


@pytest.fixture(scope="module")
def mnist_data(tmp_path_factory):
    return synth_mnist.make_dataset(str(tmp_path_factory.mktemp("mnist")))


def test_jax_e2e_telemetry_logged_train_run_on_the_port(
        tmp_path, mnist_data, capsys, monkeypatch):
    """tests/test_e2e.py's test_telemetry_logged_train_run through the
    port's command line (on the CPU) and telemetry, the report rendered
    by the twin."""
    def run_task(conf_path, *overrides):
        task = LearnTask()
        task.run([conf_path, "dev=cpu"] + list(overrides))
        return task
    monkeypatch.setattr(je2e_tests, "run_task", run_task)
    monkeypatch.setattr(jutils, "telemetry", telemetry)
    monkeypatch.setitem(sys.modules, "telemetry_report", telemetry_report)
    _run_case(je2e_tests, "test_telemetry_logged_train_run",
              {"tmp_path": tmp_path, "mnist_data": mnist_data,
               "capsys": capsys})


def _both_reports(paths, capsys, extra=()):
    """(rc, --json aggregate, rendered report) from the twin and from
    the JAX tool, over the same log(s)."""
    out = []
    for tool in (telemetry_report, jtelemetry_report):
        rc = tool.main(list(paths) + ["--json"] + list(extra))
        agg = json.loads(capsys.readouterr().out)
        rc2 = tool.main(list(paths) + list(extra))
        text = capsys.readouterr().out
        assert rc == rc2
        out.append((rc, agg, text))
    return out


def test_reports_of_a_port_training_log_equal(tmp_path, mnist_data,
                                              capsys):
    """One log of a training run the port's command line wrote (spans,
    compiles, rounds, counters, histograms and the program cards of its
    performance ledger) through both report tools."""
    log = str(tmp_path / "run.jsonl")
    conf = je2e_tests.write_conf(tmp_path, je2e_tests.MLP_CONF, mnist_data,
                                 num_round=2)
    task = LearnTask()
    task.run([conf, "dev=cpu", "telemetry_log=%s" % log, "silent=1"])
    telemetry.disable()
    capsys.readouterr()
    evs = [json.loads(ln) for ln in open(log) if ln.strip()]
    assert any(e["ev"] == "program_card" for e in evs)
    (rc, agg, text), (jrc, jagg, jtext) = _both_reports([log], capsys)
    assert rc == jrc == 0
    assert agg == jagg
    assert text == jtext
    assert agg["programs"]["count"] >= 1 and "program ledger" in text


def test_reports_of_a_port_health_log_equal(tmp_path, mnist_data, capsys,
                                            monkeypatch):
    """One log of a port training run with health_monitor = 1 whose
    second batch of round 1 is NaN (anomaly, rollback, quarantined replay,
    all resolved) through both report tools: rc 0, equal aggregates and
    text, and the health section names the recovery."""
    log = str(tmp_path / "run.jsonl")
    conf = je2e_tests.write_conf(tmp_path, je2e_tests.MLP_CONF, mnist_data,
                                 num_round=2)
    seen = {"n": 0, "key": None}
    orig = Trainer.update

    def poisoned(self, batch):
        if self.round == 2:
            seen["n"] += 1
            if seen["n"] == 2:
                seen["key"] = int(batch.inst_index[0])
            if int(batch.inst_index[0]) == seen["key"]:
                batch = batch.shallow_copy()
                batch.data = np.full(np.shape(batch.data), np.nan,
                                     np.float32)
        return orig(self, batch)
    monkeypatch.setattr(Trainer, "update", poisoned)
    task = LearnTask()
    task.run([conf, "dev=cpu", "telemetry_log=%s" % log, "silent=1",
              "health_monitor=1", "max_round=5"])
    monkeypatch.undo()
    telemetry.disable()
    capsys.readouterr()
    assert task._recovery.total_rollbacks == 1 and task.start_counter == 3
    (rc, agg, text), (jrc, jagg, jtext) = _both_reports([log], capsys)
    assert rc == jrc == 0
    assert agg == jagg
    assert text == jtext
    h = agg["health"]
    assert [a["kind"] for a in h["anomalies"]] == ["nonfinite"]
    assert h["unresolved"] == [] and h["skipped_batches"] == 1


def test_reports_of_a_port_serving_log_equal(tmp_path, capsys):
    """One log of the port's serving frontend (requests, a deadline, a
    breaker that opens and heals, phase-attributed request records)
    through both report tools, merged with the training shard as a
    two-process run and with --incidents."""
    log = str(tmp_path / "serve.jsonl")
    telemetry.enable(log)
    try:
        fe = servd.ServeFrontend(
            jfi.healing_backend(lambda toks, seq: [t + 1 for t in toks],
                                fail_first=2),
            breaker_fails=2, breaker_cooldown_ms=1.0, queue_size=8,
            drain_ms=2000.0)
        fe.start()
        port = fe.listen(0)
        for line in ("1 2", "3", "4", "5", "DEADLINE 0 6", "7 8",
                     "TRACE r-1 9"):
            jfi.serve_request(port, line)
        fe.drain()
    finally:
        telemetry.finish(close=True)
    capsys.readouterr()
    (rc, agg, text), (jrc, jagg, jtext) = _both_reports(
        [log], capsys, extra=["--incidents"])
    assert rc == jrc and agg == jagg and text == jtext
    assert agg["serving"]["accepted"] == 7 and "== serving ==" in text
    # the same log as two shards of one run
    other = str(tmp_path / "serve.1.jsonl")
    with open(other, "w") as f:
        for ln in open(log):
            ev = json.loads(ln)
            ev["p"] = 1
            f.write(json.dumps(ev) + "\n")
    (rc, agg, text), (jrc, jagg, jtext) = _both_reports(
        ["--merge", log, other], capsys)
    assert rc == jrc and agg == jagg and text == jtext


def test_report_trace_export_equals_the_jax_tool(tmp_path, capsys):
    log = str(tmp_path / "r.jsonl")
    telemetry.enable(log)
    with telemetry.span("train.step", batch=3):
        telemetry.count("train.images", 8)
    telemetry.record_compile("jit.train_step", "new_signature", 0.5)
    telemetry.finish(close=True)
    outs = []
    for tool, name in ((telemetry_report, "a.json"),
                       (jtelemetry_report, "b.json")):
        assert tool.main([log, "--trace", str(tmp_path / name)]) == 0
        outs.append(json.load(open(str(tmp_path / name))))
    capsys.readouterr()
    assert outs[0] == outs[1] and outs[0]["traceEvents"]


def test_report_module_runs_as_a_program(tmp_path):
    log = tmp_path / "bad.jsonl"
    log.write_text("not json\n")
    out = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.telemetry_report",
         str(log)], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 2 and "malformed JSONL line" in out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.telemetry_report"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 1 and "cxxnet_tpu_torch.tools" in out.stderr


def test_the_twins_read_the_jax_tools_checkpoint_module_nowhere():
    """Each twin names the port's modules: none is a JAX module."""
    for mod in (ckpt_fsck, telemetry_report, roofline, summarize_trace):
        for v in vars(mod).values():
            if isinstance(v, types.ModuleType):
                assert not v.__name__.startswith("cxxnet_tpu."), \
                    (mod.__name__, v.__name__)
    assert ckpt_fsck.ckpt is ckpt and ckpt is not jckpt
