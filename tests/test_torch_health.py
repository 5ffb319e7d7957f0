"""The port's health module (cxxnet_tpu_torch/utils/health.py) against the
JAX package's cxxnet_tpu/utils/health.py, on the CPU: both selftests;
property-based sequences of health vectors (NaN, inf, spikes, the warmup
edge) through both packages' HealthMonitor and RecoveryPolicy with the same
anomalies, decisions, quarantine and ``lr_scale``; the watchdog firing once
per stall with its stack dump; ``python -m ... --selftest``; and an import
that loads neither jax nor a CUDA context.
"""

import io
import os
import subprocess
import sys
import time

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from cxxnet_tpu.utils import health as jhealth
from cxxnet_tpu_torch.utils import health, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_selftests_agree():
    assert jhealth.selftest() == 0
    assert health.selftest() == 0


def test_selftest_entry_point():
    out = subprocess.run([sys.executable, "-m",
                          "cxxnet_tpu_torch.utils.health", "--selftest"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "7 scenarios" in out.stdout


# one step: (loss kind, nan_grads); the loss kind picks a finite loss, a
# spike, NaN, +inf or -inf
_step = st.tuples(st.sampled_from(["ok", "spike", "nan", "inf", "-inf",
                                   "big"]),
                  st.integers(0, 4),
                  st.floats(0.5, 2.0, allow_nan=False))


def _vec(kind, nan_grads, base):
    loss = {"ok": base, "spike": 40.0 * base, "nan": float("nan"),
            "inf": float("inf"), "-inf": float("-inf"),
            "big": 3.5e38}[kind]
    gn = float("nan") if kind == "nan" else base * base
    ok = 1.0 if np.isfinite(np.float32(loss)) and np.isfinite(gn) else 0.0
    return np.asarray([loss, gn, float(nan_grads), ok], np.float64)


def _drive(mod, steps, action, spike, warmup, backoff, retries, batches):
    """Feed the steps through ``mod``'s monitor and policy as learn_task
    does (observe one late, drain at each round's end); returns the trace
    of (round, batch, kind, decision) and the policy's books."""
    mon = mod.HealthMonitor(spike_factor=spike, spike_warmup=warmup)
    pol = mod.RecoveryPolicy(action=action, backoff=backoff,
                             max_retries=retries)
    trace = []

    def decide(a):
        if a is not None:
            trace.append((a.round, a.batch, a.kind, a.nan_grads,
                          pol.decide(a), pol.lr_scale, pol.retries))

    for i, (kind, nan_grads, base) in enumerate(steps):
        r, b = divmod(i, batches)
        if pol.should_skip(r, b):
            trace.append(("skipped", r, b))
            continue
        decide(mon.observe(r, b, _vec(kind, nan_grads, base)))
        if b == batches - 1:
            decide(mon.drain())
            pol.on_round_complete()
    decide(mon.drain())
    return trace, pol.skipped(), pol.total_rollbacks, pol.lr_scale, \
        mon.anomaly_count


@settings(max_examples=150, deadline=None, database=None)
@given(steps=st.lists(_step, min_size=1, max_size=30),
       action=st.sampled_from(["rollback", "skip", "abort"]),
       spike=st.sampled_from([0.0, 3.0, 10.0]),
       warmup=st.integers(0, 4), backoff=st.sampled_from([1.0, 0.5, 0.3]),
       retries=st.integers(0, 3), batches=st.integers(1, 5))
def test_monitor_and_policy_decide_as_jax(steps, action, spike, warmup,
                                          backoff, retries, batches):
    telemetry.disable()
    got = _drive(health, steps, action, spike, warmup, backoff, retries,
                 batches)
    want = _drive(jhealth, steps, action, spike, warmup, backoff, retries,
                  batches)
    assert got == want


def test_watchdog_fires_once_per_stall_with_a_stack_dump(capfd):
    telemetry.enable(None)
    stalls = []
    # only this test's channel is read: a thread another test left behind
    # may beat a channel of its own while the watchdog runs
    wd = health.Watchdog(timeout=0.15, action="warn", poll=0.03,
                         on_stall=lambda ch, age: stalls.append((ch, age)))
    try:
        wd.start()
        health.beat("train.step")
        time.sleep(0.5)                  # one stall, fired once
        mine = [a for c, a in stalls if c == "train.step"]
        assert len(mine) == 1 and mine[0] >= 0.15
        chans = {c[0]: c[3] for c in health.channel_status()}
        assert chans["train.step"] is True
        health.beat("train.step")        # a fresh beat re-arms it
        time.sleep(0.5)
        assert [c for c, _ in stalls].count("train.step") == 2
        evs = [e for e in telemetry.events()
               if e.get("ev") == "watchdog_stall"
               and e["channel"] == "train.step"]
        assert len(evs) == 2
    finally:
        wd.stop()
        telemetry.disable()
    assert health.channel_status() == []
    err = capfd.readouterr().err
    assert err.count("WATCHDOG: channel 'train.step'") == 2
    assert "--- thread" in err and "test_watchdog_fires_once" in err


def test_diagnostics_dump_names_the_anomaly():
    a = health.Anomaly("nonfinite", 1, 2, float("nan"), float("nan"), 3)
    buf = io.StringIO()
    health.dump_diagnostics("nonfinite_action=abort", a, out=buf)
    text = buf.getvalue()
    assert text.startswith("HEALTH ABORT: nonfinite_action=abort")
    assert "nonfinite at round 1 batch 2" in text and "--- thread" in text


def test_health_import_loads_no_jax_and_no_cuda():
    code = ("import sys\n"
            "import cxxnet_tpu_torch.utils.health\n"
            "import torch\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cxxnet_tpu' or "
            "m.startswith('cxxnet_tpu.'))\n"
            "print(bad, torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False"
