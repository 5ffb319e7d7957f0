"""The port's performance ledger (cxxnet_tpu_torch/utils/perf.py) on the
CPU, against the JAX package's: the scenarios of tests/test_perf.py that
need no JAX program run against the port's ``perf``, ``statusd`` and
``telemetry`` (card math from faked analyses, the MFU and headroom joins,
cards keyed by signature, the recompile detector's hook, /programz and
/metrics, the /profilez guard, the decode bound and the paged pool's cap);
one sequence of faked compiles and analyses given to both packages'
ledgers, whose cards, snapshots (less the device spec), readiness, pool
caps and decode bounds must be equal; ``shapes_signature`` of a tensor and
of an array of its shape and dtype; the device table and its env
overrides; the selftest; and a real CPU training step carding itself.

A JAX scenario runs against the port by swapping the globals of the JAX
test module that name those modules for the port's, for the length of the
case, and the tools it imports (``telemetry_report``, ``roofline``) for
their twins in the port (``cxxnet_tpu_torch.tools``). Left out, each for
its reason: ``test_device_spec_table_and_env_overrides`` (the TPU
generations; the port's table is tested below),
``test_roofline_peaks_come_from_the_shared_table`` (the TPU table; the
twin's peaks are held to the port's table in tests/test_torch_tools.py),
``test_bench_compare_prints_null_skip_count`` (tools/bench_compare.py
alone, a shared tool that reads no package),
``test_real_train_step_produces_a_program_card`` (a JAX program;
the port's own step is carded below) and
``test_profilez_real_capture_writes_a_loadable_trace`` (a JAX profiler
capture; the port's real capture is tested below).
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cxxnet_tpu.utils import perf as jperf
from cxxnet_tpu.utils import telemetry as jtelemetry
from cxxnet_tpu_torch.tools import roofline, telemetry_report
from cxxnet_tpu_torch.utils import perf, statusd, telemetry

from . import test_perf as jtests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENARIOS = (
    "test_shapes_signature_stable_and_truncated",
    "test_card_math_flops_vs_bandwidth_bound",
    "test_mfu_and_headroom_join_measured_hist",
    "test_on_compile_accumulates_and_keys_cards",
    "test_jitwatch_calls_compile_hook_with_key",
    "test_jitwatch_hook_fires_even_with_telemetry_disabled",
    "test_programz_and_metrics_render_the_ledger",
    "test_profilez_guard_and_404s",
    "test_profilez_shutdown_cuts_capture_short",
    "test_decode_bound_annotation_null_safe",
    "test_decode_pool_cap_bytes_sizes_from_live_account",
    "test_report_program_ledger_section",
    "test_roofline_counts_null_bench_rows",
)


@pytest.fixture(autouse=True)
def _lockrank_on(monkeypatch):
    monkeypatch.setenv("CXXNET_LOCKRANK", "1")


@pytest.mark.parametrize("name", SCENARIOS)
def test_jax_perf_scenario_on_the_port(name, tmp_path, monkeypatch):
    for attr, mod in (("perf", perf), ("statusd", statusd),
                      ("telemetry", telemetry)):
        monkeypatch.setattr(jtests, attr, mod)
    # the scenarios import the tools by name inside their bodies
    monkeypatch.setitem(sys.modules, "telemetry_report", telemetry_report)
    monkeypatch.setitem(sys.modules, "roofline", roofline)
    fn = getattr(jtests, name)
    given = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


# ----------------------------------------------------------------------
# one sequence through both packages' ledgers
class _Arr:
    def __init__(self, shape, dtype="float32"):
        self.shape, self.dtype = shape, dtype


def _drive(pkg_perf, pkg_tel):
    """Faked compiles, analyses, measurements and a warm grid through a
    fresh ledger of one package; returns what it shows."""
    reg = pkg_tel._Registry()
    reg.enable()
    spec = pkg_perf.DeviceSpec("t", 100e12, 500e9, 8 * 2.0**30)
    lg = pkg_perf.Ledger(registry=reg, spec=spec).enable()
    try:
        lg.set_expected_grid([(("sess_prefill", 8, 0.0, 0), "prefill"),
                              (("sess_admit", 2), "2"),
                              (("sess_step", 2, 0.0, 0), "2"),
                              ("bare-key")])
        calls = [
            ("jit.train_step", "new_signature", 1.5,
             ([_Arr((8, 3, 32, 32)), {"w": _Arr((16, 27))}],), ("train", 1)),
            ("jit.train_step", "rebuild_after_clear", 0.5,
             ([_Arr((8, 3, 32, 32)), {"w": _Arr((16, 27))}],), ("train", 1)),
            ("jit.decode_prefill", "new_signature", 0.25,
             (_Arr((1, 8), "int32"),), ("sess_prefill", 8, 0.0, 0)),
            ("jit.decode_step", "new_signature", 0.125,
             (_Arr((2, 1), "int32"), _Arr((2, 64), "bfloat16")),
             ("decode", 2, 8, 24, 0.0, 0)),
            ("jit.predict", "shape_change", 0.75,
             (_Arr((4, 10)), 3, 0.5), None)]
        for name, cause, secs, args, key in calls:
            lg.on_compile(name, cause, secs, fn=None, args=args, key=key)
        sigs = {c["name"]: c["sig"] for c in lg.cards()}
        lg.complete_card("jit.train_step", sigs["jit.train_step"],
                         cost={"flops": 3.0e12, "bytes accessed": 2.0e9},
                         mem={"argument_size_in_bytes": 2 << 30,
                              "temp_size_in_bytes": 1 << 30,
                              "output_size_in_bytes": 1 << 20})
        lg.complete_card("jit.decode_step", sigs["jit.decode_step"],
                         cost={"flops": 1.0e9, "bytes accessed": 4.0e9},
                         mem={"argument_size_in_bytes": 1 << 28,
                              "temp_size_in_bytes": None,
                              "output_size_in_bytes": 1 << 10})
        lg.complete_card("jit.predict", sigs["jit.predict"], error="boom")
        for d in (0.02, 0.03, 0.04, 0.05):
            reg.hist("train.step", d)
            reg.hist("decode.decode", d / 10)
        lg.set_decode_kv(lambda: 3 << 20)
        snap = lg.snapshot()
        snap.pop("spec")
        out = {"cards": lg.cards(), "snapshot": snap,
               "readiness": lg.readiness(),
               "caps": [lg.decode_pool_cap_bytes(f)
                        for f in (0.0, 0.25, 0.5, 1.0, 2.0, -1.0)],
               "compiles": [{k: v for k, v in r.items() if k != "ts"}
                            for r in lg.recent_compiles()]}
        # the module-level decode bound over the same ledger
        mod = pkg_perf.ledger()
        old = (mod._registry, mod.spec, mod._cards, mod._order,
               mod.enabled)
        mod._registry, mod.spec = reg, spec
        mod._cards, mod._order = lg._cards, lg._order
        mod.enabled = True
        try:
            out["bounds"] = [pkg_perf.decode_bound_tokens_per_s(n)
                             for n in (None, 0, 1, 2, 17, 64)]
        finally:
            (mod._registry, mod.spec, mod._cards, mod._order,
             mod.enabled) = old
        return out
    finally:
        lg.disable()
        reg.disable()


def test_ledgers_of_both_packages_show_the_same():
    assert _drive(perf, telemetry) == _drive(jperf, jtelemetry)


def test_session_step_card_joins_its_own_spans():
    """The one departure of the snapshot: a session's one-step card
    (``jit.decode_step`` under a ``sess_step`` key) joins the
    ``decode.step`` spans that time one step, where the JAX table joins
    every decode-step card to the solo loop's ``decode.decode``."""
    reg = telemetry._Registry()
    reg.enable()
    lg = perf.Ledger(registry=reg, spec=perf.DeviceSpec(
        "t", 100e12, 500e9, 8 * 2.0**30)).enable()
    try:
        for key in (("sess_step", 4, 0.0, 0), ("decode", 1, 8, 16, 0.0, 0)):
            lg.on_compile("jit.decode_step", "new_signature", 0.1,
                          args=(_Arr((len(key), 3)),), key=key)
        for d in (0.001, 0.002):
            reg.hist("decode.step", d)
        reg.hist("decode.decode", 0.5)
        by_key = {c["key"]: c for c in lg.snapshot()["cards"]}
        sess = by_key[str(("sess_step", 4, 0.0, 0))]
        solo = by_key[str(("decode", 1, 8, 16, 0.0, 0))]
        assert (sess["measured_series"], sess["measured_n"]) == \
            ("decode.step", 2)
        assert (solo["measured_series"], solo["measured_n"]) == \
            ("decode.decode", 1)
        assert sess["series_shared_by"] == solo["series_shared_by"] == 1
    finally:
        lg.disable()
        reg.disable()


def test_readiness_cap_and_bound_match_jax():
    got, want = _drive(perf, telemetry), _drive(jperf, jtelemetry)
    assert got["readiness"] == want["readiness"]
    assert got["readiness"]["ready_pct"] == 25.0
    assert got["caps"] == want["caps"]
    assert got["bounds"] == want["bounds"] and got["bounds"][3] is not None


DTYPES = [("float32", torch.float32), ("float16", torch.float16),
          ("bfloat16", torch.bfloat16), ("int32", torch.int32),
          ("int64", torch.int64), ("uint8", torch.uint8),
          ("bool", torch.bool), ("float64", torch.float64)]


@pytest.mark.parametrize("np_name,dtype", DTYPES, ids=[d for d, _ in DTYPES])
def test_shapes_signature_of_a_tensor_equals_an_arrays(np_name, dtype):
    """The JAX package's signature of numpy arrays (of JAX arrays for
    bfloat16, which numpy lacks) equals the port's of tensors of the same
    shapes and dtype, nested and with a scalar among them."""
    import jax.numpy as jnp
    shapes = [(8, 3, 227, 227), (), (5,), (2, 1, 1, 2048)]
    tensors = [torch.zeros(s, dtype=dtype) for s in shapes]
    if np_name == "bfloat16":
        arrays = [jnp.zeros(s, dtype=jnp.bfloat16) for s in shapes]
    else:
        arrays = [np.zeros(s, np_name) for s in shapes]
    args_t = (tensors[0], {"w": tensors[1], "b": [tensors[2]]}, 7,
              tensors[3])
    args_a = (arrays[0], {"w": arrays[1], "b": [arrays[2]]}, 7, arrays[3])
    assert perf.shapes_signature(args_t) == \
        jperf.shapes_signature(args_a)


def test_device_table_and_env_overrides(monkeypatch):
    for k in ("CXXNET_PEAK_TFLOPS", "CXXNET_PEAK_HBM_GBS",
              "CXXNET_HBM_CAPACITY_GIB"):
        monkeypatch.delenv(k, raising=False)
    h = perf.device_spec("h100")
    assert (h.peak_flops, h.hbm_bw) == (989e12, 3.35e12)
    assert (h.fp32_flops, h.tf32_flops) == (67e12, 495e12)
    assert perf.device_spec("cpu").peak_flops > 0
    assert perf.card_spec_name("NVIDIA H100 80GB HBM3") == "h100"
    with pytest.raises(ValueError, match="no device spec"):
        perf.card_spec_name("NVIDIA A100-SXM4-40GB")
    with pytest.raises(KeyError):
        perf.device_spec("v5e")
    # a card's own capacity replaces the nominal one
    c = perf.device_spec("h100", capacity=85e9)
    assert c.hbm_capacity == 85e9 and c.peak_flops == 989e12
    # the host's spec where no card runs
    if not torch.cuda.is_available():
        assert perf.current_device_spec().name == "cpu"
    assert perf.current_device_spec("cpu").name == "cpu"
    monkeypatch.setenv("CXXNET_PEAK_TFLOPS", "50")
    monkeypatch.setenv("CXXNET_PEAK_HBM_GBS", "100")
    monkeypatch.setenv("CXXNET_HBM_CAPACITY_GIB", "4")
    for name in ("h100", "cpu"):
        s = perf.device_spec(name)
        assert (s.peak_flops, s.hbm_bw, s.hbm_capacity) == \
            (50e12, 100e9, 4 * 2.0**30)
        assert s.name == name + "+env"
    # the override wins over a card's measured capacity as well
    assert perf.device_spec("h100", capacity=85e9).hbm_capacity == \
        4 * 2.0**30


def test_probe_window_never_lowers_the_process_peak(monkeypatch):
    """A program's first call measures its own allocator peak in a window
    of its own, and the process's high-water mark that
    ``device.memory_stats`` reports (the hbm series of telemetry and
    statusd) never drops across it. The card's allocator is faked on the
    CPU through the torch.cuda calls the probe and memory_stats make."""
    from cxxnet_tpu_torch import device as device_mod
    gib = 1 << 30
    alloc = {"now": 0, "peak": 0}

    def grow(n):
        alloc["now"] += n
        alloc["peak"] = max(alloc["peak"], alloc["now"])
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d=None: alloc["now"])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d=None: alloc["peak"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda d=None: alloc.update(peak=alloc["now"]))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (0, 80 * gib))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    monkeypatch.setattr(device_mod, "_PEAK_BEFORE", {})
    dev = torch.device("cuda", 0)

    def peak():
        return device_mod.memory_stats(dev)["peak_bytes_in_use"]
    grow(10 * gib)                  # a step's 10 GiB came and went
    grow(-8 * gib)
    peaks = [peak()]
    probe = perf.DeviceProbe(dev)
    for temps in (gib, 3 * gib):    # two compiles, each in its window
        before = probe.begin()
        peaks.append(peak())
        grow(temps)
        grow(-temps)
        mem = probe.end(before, (), {}, None)
        assert mem["peak_size_in_bytes"] == 2 * gib + temps
        assert mem["temp_size_in_bytes"] == temps
        peaks.append(peak())
    grow(12 * gib)
    peaks.append(peak())
    assert peaks == [10 * gib] * 5 + [14 * gib]


def test_perf_selftest_exits_0():
    env = dict(os.environ, CXXNET_LOCKRANK="1", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m",
                          "cxxnet_tpu_torch.utils.perf", "--selftest"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "perf selftest" in out.stdout


def test_real_train_step_produces_a_program_card():
    """A real CPU update through the port's trainer: the step's first call
    cards it inline (ready, its flops and bytes the work account's, its
    compile seconds, its key), and three updates join the train.step
    histogram."""
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.nnet import cost
    from cxxnet_tpu_torch.nnet.trainer import Trainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    telemetry.reset()
    telemetry.enable()
    perf.reset()
    perf.enable()
    try:
        tr = Trainer()
        for k, v in parse_config_string(jtests.TINY_CONF):
            tr.set_param(k, v)
        tr.init_model()
        rs = np.random.RandomState(0)
        b = DataBatch()
        b.data = rs.rand(8, 1, 1, 16).astype(np.float32)
        b.label = rs.randint(0, 10, (8, 1)).astype(np.float32)
        b.batch_size = 8
        for _ in range(3):
            tr.update(b)
        assert perf.drain(1.0)
        card = perf.ledger().card("jit.train_step")
        assert card is not None and card["status"] == "ready", card
        want = cost.train_step_cost(tr.net, tr.params, tr.updaters)
        assert card["flops"] == want["flops"] > 0
        assert card["bytes_accessed"] == want["bytes accessed"] > 0
        assert card["predicted_s"] and card["predicted_s"] > 0
        assert card["compile_s"] > 0 and card["compiles"] == 1
        assert card["cause"] == "new_signature"
        assert card["key"] == str(("train", True, False, False, False,
                                   False))
        # the CPU has no allocator figures: arguments and outputs only
        assert card["temp_bytes"] is None and card["arg_bytes"] > 0
        snap = perf.ledger().snapshot()
        c = [c for c in snap["cards"] if c["name"] == "jit.train_step"][0]
        assert c["measured_n"] == 3
        assert c["mfu_pct"] is not None
        assert c["roofline_eff_pct"] is not None
        assert snap["spec"]["name"] == "cpu"
        evs = [e for e in telemetry.events()
               if e.get("ev") in ("compile", "program_compile",
                                  "program_card")]
        assert [e["ev"] for e in evs] == ["compile", "program_compile",
                                          "program_card"]
    finally:
        perf.disable()
        perf.reset()
        telemetry.disable()
        telemetry.reset()


def test_real_profiler_capture_writes_a_loadable_trace(tmp_path):
    """The default /profilez capture: a torch.profiler Chrome trace that
    json.load reads, with the ops run during its window."""
    import time
    prof = perf.ProfilerCapture(str(tmp_path))
    ok, path = prof.start(0.5)
    assert ok
    deadline = time.monotonic() + 60
    while prof.busy() and time.monotonic() < deadline:
        torch.ones((64, 64)).sum()
        time.sleep(0.02)
    assert prof.wait(30.0) and prof.last_error is None, prof.last_error
    with open(os.path.join(path, "trace.json")) as f:
        doc = json.load(f)
    assert "traceEvents" in doc


# ----------------------------------------------------------------------
# the command line's keys
@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    from tests.synth_mnist import make_dataset
    root = tmp_path_factory.mktemp("perf_cli")
    make_dataset(str(root / "data"), n_train=400, n_test=100)
    with open(os.path.join(REPO, "example", "MNIST", "MNIST.conf")) as f:
        (root / "MNIST.conf").write_text(f.read())
    return root


def _cli(root, *args):
    import contextlib
    import io
    from cxxnet_tpu_torch import learn_task
    old = os.getcwd()
    os.chdir(str(root))
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out, \
                contextlib.redirect_stderr(io.StringIO()):
            assert learn_task.LearnTask().run(
                ["MNIST.conf", "num_round=2", "max_round=2",
                 "model_dir=models"] + list(args)) == 0
    finally:
        os.chdir(old)
    return out.getvalue()


def _events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def test_cli_profile_dir_writes_a_loadable_round_2_trace(mnist_dir):
    """profile_dir = <dir>: a torch.profiler Chrome trace of round 2 that
    json.load reads, holding that round's ops."""
    out = _cli(mnist_dir, "profile_dir=prof")
    path = os.path.join(str(mnist_dir), "prof", "trace.json")
    assert "profiler trace written to %s" % os.path.join("prof",
                                                         "trace.json") \
        in out
    with open(path) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    # the round's forward products and their backward
    assert any(n and n.startswith("aten::") and "mm" in n for n in names)
    assert "MmBackward0" in names


@pytest.mark.parametrize("ledger_on", (1, 0))
def test_cli_perf_ledger_cards_the_runs_programs(mnist_dir, ledger_on):
    """perf_ledger (1 by default whenever telemetry is on) cards every
    program the run compiles: program_compile and program_card events in
    the run log, the train step's and the eval forward's cards ready;
    perf_ledger = 0 cards nothing while the compile events stay."""
    log = os.path.join(str(mnist_dir), "t%d.jsonl" % ledger_on)
    _cli(mnist_dir, "telemetry_log=%s" % log, "perf_ledger=%d" % ledger_on)
    evs = _events(log)
    cards = {e["name"]: e for e in evs if e.get("ev") == "program_card"}
    compiles = [e for e in evs if e.get("ev") == "compile"]
    assert {e["name"] for e in compiles} >= {"jit.train_step",
                                             "jit.eval_fwd"}
    if not ledger_on:
        assert not cards
        return
    for name in ("jit.train_step", "jit.eval_fwd"):
        c = cards[name]
        assert c["status"] == "ready" and c["flops"] > 0, c
        assert c["spec"] == "cpu" and c["predicted_s"] > 0
    assert not perf.enabled()
