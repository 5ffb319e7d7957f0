"""Training health: anomaly detection, recovery and the watchdog, the
port's copy of cxxnet_tpu/utils/health.py.

A long training run must survive a non-finite loss or gradient (one bad
batch, an overflowing LR), a diverging run (a loss spike) and a wedged
input pipeline. The pieces, as in the JAX package:

* **HealthMonitor** reads the per-step health vectors the trainer
  computes on the device (``[loss, grad_norm_sq, nan_grad_elems, ok]``,
  ``Trainer._health_vector``) one step LATE: step N-1's vector is checked
  after step N was dispatched. On a card the trainer copies each vector
  into page-locked memory behind an event right after its own step
  (``trainer.StagedVector``), so the check waits for that copy only and
  never for the step queued behind it. An EMA detector also flags loss
  spikes. A detected anomaly is a ``health_anomaly`` telemetry event.
* **RecoveryPolicy**, the host state machine: on an anomaly roll back to
  the newest valid checkpoint with the offending (round, batch)
  quarantined and the LR backed off by ``rollback_backoff`` per retry,
  or skip (``nonfinite_action = skip``: the trainer's guard already kept
  the old state on the device), or abort with a diagnostic dump after
  ``rollback_max_retries`` consecutive rollbacks.
* **Watchdog**, a daemon thread over heartbeat channels (``beat`` from
  the train loop, the batch prefetcher, the serving frontend and the
  router): a channel silent past the timeout gets every thread's stack
  dumped and a ``watchdog_stall`` event flushed BEFORE the action
  (``warn``, or ``abort`` = exit code 70).

learn_task.py wires them behind ``health_monitor``, ``nonfinite_action``,
``loss_spike_factor``, ``loss_spike_warmup``, ``rollback_backoff``,
``rollback_max_retries``, ``watchdog_timeout`` and ``watchdog_action``.

Standard library only: serving and routing processes import this module,
which must neither load torch nor touch a card, and ``python -m
cxxnet_tpu_torch.utils.health --selftest`` runs anywhere.
"""

from __future__ import annotations

import math
import os
import struct
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import lockrank
from . import telemetry

__all__ = [
    "Anomaly", "TrainingAnomalyError", "HealthMonitor", "RecoveryPolicy",
    "Watchdog", "beat", "pause", "channel_status", "dump_all_stacks",
    "dump_diagnostics", "new_anomaly_id", "note_nonfinite", "selftest",
]

# health-vector slots, shared with nnet/trainer.py _health_vector
H_LOSS, H_GNORM_SQ, H_NAN_GRADS, H_OK = 0, 1, 2, 3

# ranked (utils/lockrank.py): anomaly ids are allocated from telemetry and
# watchdog callbacks, so the ordering discipline covers it
_id_lock = lockrank.lock("health.ids")
_next_anomaly_id = [0]


def new_anomaly_id() -> int:
    """The next anomaly id of this process (1, 2, ...)."""
    with _id_lock:
        _next_anomaly_id[0] += 1
        return _next_anomaly_id[0]


class Anomaly:
    """One detected training anomaly (which step, what went wrong)."""

    __slots__ = ("id", "kind", "round", "batch", "loss", "grad_norm_sq",
                 "nan_grads")

    def __init__(self, kind: str, round_: int, batch: int, loss: float,
                 grad_norm_sq: float, nan_grads: int):
        self.id = new_anomaly_id()
        self.kind = kind
        self.round = int(round_)
        self.batch = int(batch)
        self.loss = float(loss)
        self.grad_norm_sq = float(grad_norm_sq)
        self.nan_grads = int(nan_grads)

    def describe(self) -> str:
        return ("%s at round %d batch %d (loss=%g, grad_norm_sq=%g, "
                "nan_grads=%d)" % (self.kind, self.round, self.batch,
                                   self.loss, self.grad_norm_sq,
                                   self.nan_grads))


class TrainingAnomalyError(RuntimeError):
    """Raised by the train loop when the recovery policy wants a rollback;
    the train loop restores the newest valid checkpoint and re-enters
    with the offending batch window quarantined."""

    def __init__(self, anomaly: Anomaly):
        super().__init__(anomaly.describe())
        self.anomaly = anomaly


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX monitor reads its vector."""
    try:
        return struct.unpack("f", struct.pack("f", x))[0]
    except OverflowError:
        return math.copysign(math.inf, x)


def _values(health) -> List[float]:
    """The floats of a health vector: a ``StagedVector`` of the trainer
    (its ``tolist`` waits for its own copy only), a tensor or a numpy
    array (``tests/faultinject.py``'s ``spoof_health``) or a sequence."""
    vals = health.tolist() if hasattr(health, "tolist") else list(health)
    return [_f32(float(v)) for v in vals]


class HealthMonitor:
    """Host-side detector over the per-step health vectors.

    ``observe(round, batch, vec)`` queues the CURRENT step's vector and
    checks the PREVIOUS one; ``drain()`` checks whatever is still queued
    (call it before eval and checkpoint, so that a bad step is never
    persisted as good). Both return the detected :class:`Anomaly` or None.
    The vector is queued with its (round, batch) key, so the late check
    still names the exact offending step.
    """

    def __init__(self, spike_factor: float = 0.0, spike_warmup: int = 20,
                 spike_decay: float = 0.98):
        self.spike_factor = float(spike_factor)
        self.spike_warmup = int(spike_warmup)
        self.spike_decay = float(spike_decay)
        self._pending = deque()
        self._ema = 0.0
        self._nseen = 0
        self.anomaly_count = 0

    def observe(self, round_: int, batch: int, health) -> Optional[Anomaly]:
        if health is None:
            return None
        self._pending.append((round_, batch, health))
        if len(self._pending) > 1:
            return self._check(*self._pending.popleft())
        return None

    def drain(self) -> Optional[Anomaly]:
        while self._pending:
            a = self._check(*self._pending.popleft())
            if a is not None:
                return a
        return None

    def reset_pending(self) -> None:
        """Drop queued vectors (they belong to a trainer that a rollback
        is about to discard)."""
        self._pending.clear()

    # ------------------------------------------------------------------
    def _check(self, round_: int, batch: int, health) -> Optional[Anomaly]:
        h = _values(health)
        loss = h[H_LOSS]
        gn_sq = h[H_GNORM_SQ]
        nan_grads = int(h[H_NAN_GRADS])
        if nan_grads > 0:
            # the elements the updaters' clip would silently zero, or that
            # reach the optimizer raw, made visible as a counter
            telemetry.count("health/nan_grads_zeroed", nan_grads)
        if not (math.isfinite(loss) and math.isfinite(gn_sq)):
            return self._anomaly("nonfinite", round_, batch, loss, gn_sq,
                                 nan_grads)
        if self.spike_factor > 0.0:
            if self._nseen >= self.spike_warmup \
                    and loss > self.spike_factor * max(self._ema, 1e-12):
                return self._anomaly("loss_spike", round_, batch, loss,
                                     gn_sq, nan_grads)
            self._nseen += 1
            self._ema = loss if self._nseen == 1 else (
                self.spike_decay * self._ema
                + (1.0 - self.spike_decay) * loss)
        return None

    def _anomaly(self, kind, round_, batch, loss, gn_sq, nan_grads):
        a = Anomaly(kind, round_, batch, loss, gn_sq, nan_grads)
        self.anomaly_count += 1
        telemetry.count("health/anomalies")
        telemetry.event({"ev": "health_anomaly", "id": a.id, "kind": kind,
                         "round": a.round, "batch": a.batch,
                         "loss": _json_num(loss),
                         "grad_norm_sq": _json_num(gn_sq),
                         "nan_grads": a.nan_grads})
        return a


def _json_num(x: float):
    """NaN / Inf as strings, so that the JSONL log stays strict JSON."""
    return float(x) if math.isfinite(x) else repr(float(x))


class RecoveryPolicy:
    """Host state machine from anomalies to recovery decisions.

    * ``rollback``: quarantine the offending (round, batch), fold the LR
      backoff into ``lr_scale``, count a retry; the train loop restores the
      newest valid checkpoint and replays without the quarantined batches.
    * ``skip``: the trainer's device guard (``nonfinite_action = skip``)
      already kept the old state; nothing to restore. Loss spikes are only
      logged in this mode.
    * ``abort``: ``nonfinite_action = abort``, or retries exhausted
      (``retries > max_retries``); the train loop dumps diagnostics and dies.

    A completed round resets the consecutive-retry counter; the quarantine
    set and ``lr_scale`` last for the rest of the run.
    """

    ACTIONS = ("rollback", "skip", "abort")

    def __init__(self, action: str = "rollback", backoff: float = 1.0,
                 max_retries: int = 2):
        if action not in self.ACTIONS:
            raise ValueError("nonfinite_action must be one of %s, got %r"
                             % ("|".join(self.ACTIONS), action))
        self.action = action
        self.backoff = float(backoff)
        self.max_retries = int(max_retries)
        self.retries = 0          # consecutive rollbacks without a round
        self.total_rollbacks = 0
        self.lr_scale = 1.0
        self._skip: Dict[int, set] = {}
        # the anomaly being recovered from: set by a rollback or abort
        # decision, cleared by resolve() once the restore is done;
        # statusd's /healthz answers 503 while it is set
        self.pending: Optional[Anomaly] = None

    def decide(self, anomaly: Anomaly) -> str:
        """'skip' | 'rollback' | 'abort'. A 'rollback' has already
        quarantined the batch and folded the backoff into ``lr_scale``
        (applied by Trainer.scale_lr after the restore)."""
        if self.action == "abort":
            self.pending = anomaly
            return "abort"
        if self.action == "skip":
            return "skip"
        self.pending = anomaly
        self.retries += 1
        if self.retries > self.max_retries:
            return "abort"
        self.total_rollbacks += 1
        self._skip.setdefault(anomaly.round, set()).add(anomaly.batch)
        if self.backoff != 1.0:
            self.lr_scale *= self.backoff
        return "rollback"

    def resolve(self) -> None:
        """The train loop finished recovering: /healthz returns to 200. Aborts
        never resolve."""
        self.pending = None

    def should_skip(self, round_: int, batch: int) -> bool:
        s = self._skip.get(int(round_))
        return s is not None and int(batch) in s

    def skipped(self):
        """The quarantined windows as a sorted [[round, batch], ...]."""
        return [[r, b] for r in sorted(self._skip)
                for b in sorted(self._skip[r])]

    def on_round_complete(self) -> None:
        self.retries = 0


# ----------------------------------------------------------------------
# watchdog: heartbeat channels and stack dumps of a stalled run
_beats: Dict[str, float] = {}
_active_watchdog: Optional["Watchdog"] = None


def beat(channel: str = "train.step") -> None:
    """Heartbeat a liveness channel. No-op unless a Watchdog runs; one dict
    store under the GIL, safe from any thread."""
    if _active_watchdog is not None:
        _beats[channel] = time.monotonic()


def pause(channel: str = "train.step") -> None:
    """Disarm a liveness channel for a legitimately silent phase (eval and
    checkpoint, the gap between prefetch passes, an idle queue, a kernel
    built at first use); the next ``beat`` re-arms it."""
    _beats.pop(channel, None)
    wd = _active_watchdog
    if wd is not None:
        wd._fired.pop(channel, None)


def channel_status() -> List[Tuple[str, float, float, bool]]:
    """``[(channel, age_s, timeout_s, overdue), ...]`` over every ARMED
    channel; empty while no watchdog runs."""
    wd = _active_watchdog
    if wd is None:
        return []
    now = time.monotonic()
    return [(ch, now - t, wd.timeout, (now - t) > wd.timeout)
            for ch, t in list(_beats.items())]


def dump_all_stacks(out=None, header: str = "") -> str:
    """Write every thread's current stack to ``out`` (default stderr)."""
    names = {t.ident: t.name + (" [daemon]" if t.daemon else "")
             for t in threading.enumerate()}
    lines = [header] if header else []
    for tid, frame in sorted(sys._current_frames().items()):
        lines.append("--- thread %s (%d) ---" % (names.get(tid, "?"), tid))
        for entry in traceback.format_stack(frame):
            lines.extend(entry.rstrip("\n").splitlines())
    text = "\n".join(lines) + "\n"
    f = out or sys.stderr
    f.write(text)
    try:
        f.flush()
    except Exception:
        pass
    return text


def dump_diagnostics(reason: str, anomaly: Optional[Anomaly] = None,
                     out=None) -> None:
    """The abort path's post-mortem: reason, anomaly, every thread's
    stack, telemetry flushed."""
    f = out or sys.stderr
    f.write("HEALTH ABORT: %s\n" % reason)
    if anomaly is not None:
        f.write("  anomaly: %s\n" % anomaly.describe())
    dump_all_stacks(out=f, header="-- diagnostic all-thread stack dump --")
    try:
        telemetry.flush()
    except Exception:
        pass


class Watchdog:
    """Daemon thread that fires when a heartbeat channel is silent for
    longer than ``timeout`` seconds: every thread's stack to stderr, a
    ``watchdog_stall`` event, a telemetry flush, then the action (``warn``
    leaves the process alone; ``abort`` exits with code 70). Each stall
    fires once; a fresh beat re-arms the channel. Only channels that have
    beaten since their last ``pause()`` are watched."""

    def __init__(self, timeout: float, action: str = "warn",
                 poll: Optional[float] = None, on_stall=None):
        if action not in ("warn", "abort"):
            raise ValueError("watchdog_action must be warn|abort, got %r"
                             % action)
        self.timeout = float(timeout)
        self.action = action
        self.poll = poll if poll is not None else \
            max(0.05, min(self.timeout / 4.0, 1.0))
        self.on_stall = on_stall
        self.stalls = 0
        self._fired: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        global _active_watchdog
        _beats.clear()
        self._stop.clear()
        _active_watchdog = self
        self._thread = threading.Thread(target=self._run,
                                        name="cxn-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        global _active_watchdog
        if _active_watchdog is self:
            _active_watchdog = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            now = time.monotonic()
            for ch, t in list(_beats.items()):
                # once per stall: a newer beat re-arms the channel
                if now - t > self.timeout and self._fired.get(ch) != t:
                    self._fired[ch] = t
                    self._fire(ch, now - t)

    def _fire(self, channel: str, age: float) -> None:
        self.stalls += 1
        dump_all_stacks(header=(
            "WATCHDOG: channel %r silent for %.2fs (timeout %.2fs) — "
            "all-thread stack dump follows" % (channel, age, self.timeout)))
        telemetry.event({"ev": "watchdog_stall", "channel": channel,
                         "stalled_s": round(age, 3),
                         "timeout_s": self.timeout, "action": self.action})
        telemetry.count("health/watchdog_stalls")
        try:
            telemetry.flush()
        except Exception:
            pass
        if self.on_stall is not None:
            try:
                self.on_stall(channel, age)
            except Exception:
                pass
        if self.action == "abort":
            sys.stderr.write(
                "WATCHDOG: aborting the wedged process (exit code 70); "
                "resume with continue=1\n")
            sys.stderr.flush()
            os._exit(70)


# ----------------------------------------------------------------------
_warned_sites = set()


def note_nonfinite(where: str, count: int = 1) -> None:
    """A non-finite metric or eval value seen on the host: a health event
    (warned once per site) and a counter, with ``resolution: "warned"``
    so that the report tool does not count it as an unrecovered training
    anomaly."""
    telemetry.count("health/nonfinite_metric", count)
    telemetry.event({"ev": "health_anomaly", "id": new_anomaly_id(),
                     "kind": "metric_nonfinite", "where": where,
                     "count": int(count), "resolution": "warned"})
    if where not in _warned_sites:
        _warned_sites.add(where)
        sys.stderr.write(
            "WARNING: non-finite value(s) in %s; excluded and counted "
            "(health/nonfinite_metric)\n" % where)


# ----------------------------------------------------------------------
def _sim_vec(loss: float, nan_grads: int = 0):
    gn = float("nan") if not math.isfinite(loss) else 1.0
    ok = 1.0 if math.isfinite(loss) else 0.0
    return [loss, gn, float(nan_grads), ok]


def selftest(verbose: bool = False) -> int:
    """Host simulation of the detect / rollback / skip state machine (the
    JAX package's seven scenarios): the simulated trainer state is the
    list of (round, batch) updates applied, a checkpoint a copy of it at
    each round boundary; bad batches give non-finite or spiking vectors
    through the real HealthMonitor and RecoveryPolicy."""

    class _Roll(Exception):
        pass

    class _Abort(Exception):
        pass

    def run(bad, action="rollback", backoff=1.0, max_retries=2,
            spike=0.0, rounds=3, batches=4):
        mon = HealthMonitor(spike_factor=spike, spike_warmup=1)
        pol = RecoveryPolicy(action=action, backoff=backoff,
                             max_retries=max_retries)
        state = []
        ckpts = {0: []}              # learn_task saves round 0's start too

        def decide(a):
            d = pol.decide(a)
            if d == "abort":
                raise _Abort(a.describe())
            if d == "rollback":
                raise _Roll()
            # skip: the device guard already kept the old state
            state.remove((a.round, a.batch))

        r = 0
        try:
            while r < rounds:
                try:
                    b = 0
                    while b < batches:
                        if pol.should_skip(r, b):
                            b += 1
                            continue
                        is_bad = (r, b) in bad
                        state.append((r, b))
                        loss = (100.0 if spike else float("nan")) \
                            if is_bad else 1.0
                        a = mon.observe(r, b, _sim_vec(loss,
                                                       3 if is_bad else 0))
                        if a is not None:
                            decide(a)
                        b += 1
                    a = mon.drain()
                    if a is not None:
                        decide(a)
                except _Roll:
                    mon.reset_pending()
                    r = max(ckpts)
                    state = list(ckpts[r])
                    continue
                pol.on_round_complete()
                r += 1
                ckpts[r] = list(state)
        except _Abort:
            return state, pol, True
        return state, pol, False

    clean = [(r, b) for r in range(3) for b in range(4)]

    state, pol, aborted = run(bad=set())
    assert state == clean and not aborted and pol.total_rollbacks == 0

    state, pol, aborted = run(bad={(1, 2)}, backoff=0.5)
    assert state == [x for x in clean if x != (1, 2)], state
    assert not aborted and pol.total_rollbacks == 1
    assert abs(pol.lr_scale - 0.5) < 1e-12

    state, pol, aborted = run(bad={(1, 1), (1, 3)}, backoff=0.5)
    assert state == [x for x in clean if x not in ((1, 1), (1, 3))]
    assert pol.total_rollbacks == 2 and abs(pol.lr_scale - 0.25) < 1e-12

    state, pol, aborted = run(bad={(2, 0)}, spike=5.0, backoff=0.5)
    assert state == [x for x in clean if x != (2, 0)] and not aborted
    assert pol.total_rollbacks == 1

    state, pol, aborted = run(bad={(0, b) for b in range(4)},
                              max_retries=2)
    assert aborted and pol.retries == 3

    state, pol, aborted = run(bad={(0, 1), (2, 2)}, action="skip")
    assert state == [x for x in clean if x not in ((0, 1), (2, 2))]
    assert not aborted and pol.total_rollbacks == 0

    state, pol, aborted = run(bad={(0, 0)}, action="abort")
    assert aborted

    if verbose:
        print("health selftest: detect/rollback/skip state machine ok "
              "(7 scenarios)")
    return 0


if __name__ == "__main__":
    if "--selftest" in sys.argv[1:]:
        sys.exit(selftest(verbose=True))
    print(__doc__)
    sys.exit(1)
