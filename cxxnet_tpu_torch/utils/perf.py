"""Live program performance ledger of the port: per-program cost and
memory cards, MFU and roofline-efficiency gauges, the HBM headroom account,
the warm-grid readiness account and an on-demand profiler capture guard —
the port's copy of cxxnet_tpu/utils/perf.py, with the same names, card
fields, events and pages (it imports nothing of ``cxxnet_tpu``).

* **DeviceSpec** — peak FLOP/s, memory bandwidth and memory capacity per
  device (``DEVICE_SPECS``): ``h100`` (dense bf16 989 TFLOP/s, 3.35 TB/s,
  the H100 SXM data sheet; its fp32 and TF32 rates ride along for the
  kernels' bounds) and a nominal ``cpu`` entry that keeps every gauge
  testable on the host. ``current_device_spec()`` reads the card's name
  through ``device.py`` and its capacity from
  ``torch.cuda.get_device_properties``; a card the table lacks fails
  loudly. ``CXXNET_PEAK_TFLOPS`` / ``CXXNET_PEAK_HBM_GBS`` /
  ``CXXNET_HBM_CAPACITY_GIB`` override any entry.

* **ProgramCard** — one card per (program name, input-shapes signature).
  A program is one of the trainer's units of work under the JAX package's
  name and key (``jit.train_step``, ``jit.decode_step``, ...), and its
  compile is its first call at a new signature (``telemetry.jit_watch``):
  the port's cold start. The watch hands ``Ledger.on_compile`` the
  program, its arguments and the allocator's figures of that first call;
  the card is completed inline, with ``flops`` and ``bytes accessed`` from
  the program's own account (``fn.cost_analysis(*args)``, built on
  ``nnet/cost.py``: the net's layer graph and node shapes, no second run)
  and ``peak`` / ``arg`` / ``temp`` / ``out`` bytes from the allocator
  (``DeviceProbe``). A roofline-predicted execution time falls out:
  ``max(flops/peak_flops, bytes/hbm_bw)``.

* **live gauges** — ``snapshot()`` joins each card against the program's
  measured latency histogram (``MEASURED_SERIES``, with a session's
  one-step cards joined to ``decode.step``): ``mfu_pct`` = flops /
  (measured p50 x peak), ``roofline_eff_pct`` = predicted / measured p50.
  Aggregates: ``hbm_peak_bytes`` and ``hbm_headroom_bytes`` against the
  capacity, with the live decode KV cache charged (``set_decode_kv``).
  statusd renders it: ``/programz``, ``/compilez`` and the
  ``cxxnet_program_*`` / ``cxxnet_hbm_*`` / ``cxxnet_ready_programs_pct``
  series of ``/metrics``.

* **ProfilerCapture** — the guard behind statusd's ``/profilez?secs=N``:
  one ``torch.profiler`` capture at a time (CPU activity, and CUDA
  activity on a card), written as a Chrome trace into a fresh numbered
  directory of ``profilez_dir``.

Standard library and ``torch`` only; torch is imported inside the calls
that need it. ``python -m cxxnet_tpu_torch.utils.perf --selftest`` checks
the card math, the joins, the compile ring and readiness, and the pages
over a real socket with faked analyses.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import lockrank
from . import telemetry

__all__ = [
    "DeviceSpec", "DEVICE_SPECS", "device_spec",
    "current_device_spec", "card_spec_name", "MEASURED_SERIES",
    "measured_series", "Ledger", "DeviceProbe", "ProfilerCapture",
    "torch_profiler", "ledger",
    "enable", "disable", "enabled", "drain", "reset",
    "decode_bound_tokens_per_s", "shapes_signature", "predicted_seconds",
    "footprint_bytes", "selftest",
]


class DeviceSpec:
    """One device's roofline constants: peak matmul FLOP/s (dense bf16 on
    a card), memory bandwidth (bytes/s) and memory capacity (bytes); on a
    card also the fp32 rate outside the tensor cores and the dense TF32
    rate, the rates of the kernels' fp32 bounds."""

    __slots__ = ("name", "peak_flops", "hbm_bw", "hbm_capacity",
                 "fp32_flops", "tf32_flops")

    def __init__(self, name: str, peak_flops: float, hbm_bw: float,
                 hbm_capacity: float, fp32_flops: Optional[float] = None,
                 tf32_flops: Optional[float] = None):
        self.name = name
        self.peak_flops = float(peak_flops)
        self.hbm_bw = float(hbm_bw)
        self.hbm_capacity = float(hbm_capacity)
        self.fp32_flops = fp32_flops
        self.tf32_flops = tf32_flops

    def to_dict(self) -> dict:
        return {"name": self.name, "peak_flops": self.peak_flops,
                "hbm_bw": self.hbm_bw, "hbm_capacity": self.hbm_capacity}

    def __repr__(self):
        return ("DeviceSpec(%s, %.0f GFLOP/s, %.0f GB/s, %.1f GiB)"
                % (self.name, self.peak_flops / 1e9, self.hbm_bw / 1e9,
                   self.hbm_capacity / 2**30))


# Peaks per device. ``h100``: the H100 SXM data sheet's dense rates (bf16
# on the tensor cores 989 TFLOP/s, TF32 495, fp32 outside the tensor cores
# 67) and HBM3 at 3.35 TB/s; its capacity here is nominal, and
# current_device_spec() reads the card's own. The ``cpu`` entry is NOMINAL
# (a few-core container has no single honest peak), chosen so MFU% and
# headroom stay defined in CPU runs; every field yields to the
# CXXNET_PEAK_* env overrides below.
DEVICE_SPECS: Dict[str, DeviceSpec] = {
    "h100": DeviceSpec("h100", 989.0e12, 3.35e12, 80 * 2.0**30,
                       fp32_flops=67.0e12, tf32_flops=495.0e12),
    "cpu": DeviceSpec("cpu", 0.2e12, 25.0e9, 16 * 2.0**30),
}

# card name (torch.cuda.get_device_name) token -> table key
_CARD_TOKENS = (("H100", "h100"),)


def device_spec(name: str = "h100",
                capacity: Optional[float] = None) -> DeviceSpec:
    """The spec of a table entry (``h100`` by default), its capacity
    replaced by ``capacity`` when given, with the env overrides applied:
    ``CXXNET_PEAK_TFLOPS``, ``CXXNET_PEAK_HBM_GBS``,
    ``CXXNET_HBM_CAPACITY_GIB``. An unknown name raises KeyError."""
    if name not in DEVICE_SPECS:
        raise KeyError("no device spec %r (known: %s)"
                       % (name, ", ".join(sorted(DEVICE_SPECS))))
    base = DEVICE_SPECS[name]
    peak, bw = base.peak_flops, base.hbm_bw
    cap = base.hbm_capacity if capacity is None else float(capacity)
    env_used = False
    env = os.environ.get("CXXNET_PEAK_TFLOPS")
    if env:
        peak, env_used = float(env) * 1e12, True
    env = os.environ.get("CXXNET_PEAK_HBM_GBS")
    if env:
        bw, env_used = float(env) * 1e9, True
    env = os.environ.get("CXXNET_HBM_CAPACITY_GIB")
    if env:
        cap, env_used = float(env) * 2.0**30, True
    if not env_used and capacity is None:
        return base
    return DeviceSpec(base.name + ("+env" if env_used else ""), peak, bw,
                      cap, base.fp32_flops, base.tf32_flops)


def card_spec_name(card_name: str) -> str:
    """The table key of a card by its name; raises ValueError for a card
    the table lacks (no silent fallback to another card's peaks)."""
    for token, key in _CARD_TOKENS:
        if token in card_name:
            return key
    raise ValueError("perf: no device spec for the card %r; add its peaks "
                     "to perf.DEVICE_SPECS" % (card_name,))


def current_device_spec(device=None) -> DeviceSpec:
    """The spec of the device programs run on: ``device`` (a torch device
    or spec), else the current card when this process has started CUDA,
    else the host. A card's name comes through ``device.card_name`` and
    its capacity from ``torch.cuda.get_device_properties``; an unknown
    card raises ValueError."""
    import torch
    from .. import device as device_mod
    if device is None:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return device_spec("cpu")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return device_spec("cpu")
    key = card_spec_name(device_mod.card_name(device))
    return device_spec(key, capacity=float(
        torch.cuda.get_device_properties(device).total_memory))


# program name -> the telemetry histogram that MEASURES its executions
# (the join key between a card's predicted time and reality): the JAX
# package's table. A session's one-step program (key "sess_step..."), which
# the JAX table joins to the solo loop's decode.decode, joins to its own
# decode.step spans here (measured_series).
MEASURED_SERIES = {
    "jit.train_step": "train.step",
    "jit.eval_fwd": "eval.forward",
    "jit.predict": "predict",
    "jit.decode_prefill": "decode.prefill",
    "jit.decode_step": "decode.decode",
    "jit.beam_decode": "decode.beam",
}
_SESSION_STEP_SERIES = "decode.step"


def measured_series(card: dict) -> Optional[str]:
    """The histogram that measures a card's program."""
    key = card.get("key") or ""
    if card.get("name") == "jit.decode_step" \
            and key.startswith("('sess_step"):
        return _SESSION_STEP_SERIES
    return MEASURED_SERIES.get(card.get("name"))


_DTYPE_SHORT = {
    "float32": "f32", "float64": "f64", "float16": "f16",
    "bfloat16": "bf16", "int32": "i32", "int64": "i64", "int8": "i8",
    "uint8": "u8", "uint32": "u32", "bool": "b1",
}


def _leaves(obj):
    """Pytree leaf walk over list/tuple/dict containers (the only shapes
    the trainer's call signatures use); dicts in key order."""
    if isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _leaves(obj[k])
    else:
        yield obj


def _dtype_name(dtype) -> str:
    """``torch.float32`` and numpy's ``float32`` both read ``float32``."""
    s = str(dtype)
    return s[6:] if s.startswith("torch.") else s


def shapes_signature(args, kwargs=None) -> Tuple[str, str]:
    """(display, hash) signature of a call's input shapes/dtypes — the
    card key's second half; a tensor gives the string a numpy or JAX array
    of its shape and dtype gives. Duck-typed (``.shape``/``.dtype``);
    python scalars are folded in by repr; None leaves and other objects
    (a program's context: its session, its sampler) vanish. The display
    form is truncated for tables; the crc32 hash is the stable key."""
    toks: List[str] = []
    for leaf in _leaves((args, kwargs or {})):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            dt = _dtype_name(dtype)
            toks.append("%s[%s]" % (
                _DTYPE_SHORT.get(dt, dt),
                ",".join(str(int(d)) for d in shape)))
        elif isinstance(leaf, (bool, int, float, str)):
            toks.append(repr(leaf)[:16])
    full = ",".join(toks)
    h = "%08x" % (zlib.crc32(full.encode("utf-8", "replace"))
                  & 0xffffffff)
    if len(full) > 56:
        disp = "%s..(%d args)#%s" % (full[:40], len(toks), h)
    else:
        disp = full or "()"
    return disp, h


def _mem_field(mem, name):
    """Read one memory field from a probe's dict (or a faked one)."""
    if mem is None:
        return None
    if isinstance(mem, dict):
        v = mem.get(name)
    else:
        v = getattr(mem, name, None)
    return int(v) if v is not None else None


def predicted_seconds(flops, bytes_accessed,
                      spec: DeviceSpec) -> Optional[float]:
    """THE roofline execution-time bound: max(flops/peak, bytes/bw). None
    when neither term is known."""
    bounds = []
    if flops is not None and spec.peak_flops > 0:
        bounds.append(float(flops) / spec.peak_flops)
    if bytes_accessed is not None and spec.hbm_bw > 0:
        bounds.append(float(bytes_accessed) / spec.hbm_bw)
    return max(bounds) if bounds else None


def footprint_bytes(mem) -> Optional[int]:
    """THE program footprint: the allocator's high-water mark over the
    program's first call (``peak_size_in_bytes``) where the card measured
    one, else argument+temp+output bytes (the JAX package's definition,
    which faked analyses use). None when no field is present."""
    peak = _mem_field(mem, "peak_size_in_bytes")
    if peak is not None:
        return peak
    parts = [_mem_field(mem, k) for k in
             ("argument_size_in_bytes", "temp_size_in_bytes",
              "output_size_in_bytes")]
    if all(v is None for v in parts):
        return None
    return sum(v or 0 for v in parts)


def _nbytes(obj) -> int:
    """Bytes of every tensor leaf of a call's arguments or results."""
    n = 0
    for leaf in _leaves(obj):
        nb = getattr(leaf, "nbytes", None)
        if nb is not None and hasattr(leaf, "shape"):
            n += int(nb)
    return n


class DeviceProbe:
    """The memory half of a card, read around a program's FIRST call (the
    ``probe`` of ``telemetry.jit_watch``): ``begin()`` opens a window of
    the card's allocator high-water mark (``device.reset_peak_window``,
    which keeps the process's own peak whole) and reads what is
    allocated; ``end()`` waits for the card once and returns the memory
    fields of the card —
    ``peak_size_in_bytes`` (``torch.cuda.max_memory_allocated`` over the
    call), ``temp_size_in_bytes`` (that peak less what was allocated before
    the call) and ``argument_size_in_bytes`` / ``output_size_in_bytes``
    (the call's tensors' nbytes). On the CPU the allocator fields are
    None."""

    def __init__(self, device):
        self.device = device

    def _cuda(self) -> bool:
        return getattr(self.device, "type", None) == "cuda"

    def sync(self) -> None:
        """Wait for the card (nothing on the CPU)."""
        if self._cuda():
            import torch
            torch.cuda.synchronize(self.device)

    def begin(self):
        if not self._cuda():
            return None
        import torch
        from .. import device as device_mod
        device_mod.reset_peak_window(self.device)
        return torch.cuda.memory_allocated(self.device)

    def end(self, before, args, kwargs, out) -> dict:
        mem = {"argument_size_in_bytes": _nbytes((args, kwargs or {})),
               "output_size_in_bytes": _nbytes(out),
               "temp_size_in_bytes": None, "peak_size_in_bytes": None}
        if self._cuda():
            import torch
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
            mem["peak_size_in_bytes"] = int(peak)
            mem["temp_size_in_bytes"] = max(0, int(peak) - int(before))
        return mem


# bound on the compile flight ring (per-compile records with trigger
# attribution) — sized like telemetry.FlightRecorder's request ring: the
# full grid of a serving run fits with room for reload rebuilds
COMPILE_RING_CAP = 256


class Ledger:
    """The program performance ledger: cards keyed by (program name,
    shapes hash), completed inline at the program's first call, joined
    against measured latency histograms at snapshot time. One per process
    (the module singleton); tests build isolated instances against
    private telemetry registries."""

    def __init__(self, registry=None, spec: Optional[DeviceSpec] = None,
                 compile_ring_cap: int = COMPILE_RING_CAP):
        # ranked between telemetry.flight and telemetry.registry: card
        # completion emits the program_card event under this lock
        # (completion order must match log order)
        self._cond = lockrank.condition("perf.ledger")
        self._registry = registry
        self.spec = spec
        self.enabled = False
        self._cards: Dict[Tuple[str, str], dict] = {}
        self._order: List[Tuple[str, str]] = []
        # the compile flight recorder: a bounded ring of per-compile
        # records with trigger attribution (which request / dispatcher
        # window paid the cliff), plus the warm-grid readiness account —
        # the expected program grid vs the keys compiled so far. One lock
        # guards both (rank perf.compiles); the program_compile JSONL
        # event is emitted OUTSIDE it.
        self._clock = lockrank.lock("perf.compiles")
        self._ring: deque = deque(maxlen=max(1, int(compile_ring_cap)))
        self._compile_seq = 0
        self._expected: Dict[str, str] = {}   # key str -> bucket label
        self._warm: set = set()               # key strs compiled so far
        # set_decode_kv: a callable returning the serving frontend's live
        # decode KV-cache bytes — persistent device state BETWEEN program
        # executions, charged next to the peak program footprint
        self._decode_kv_fn = None

    def _reg(self):
        return self._registry if self._registry is not None \
            else telemetry._REG

    def _spec(self) -> DeviceSpec:
        return self.spec or current_device_spec()

    # -- lifecycle -----------------------------------------------------
    def enable(self, spec: Optional[DeviceSpec] = None) -> "Ledger":
        """Arm the ledger and hook the recompile detector. The spec stays
        UNRESOLVED unless given: it resolves at first card completion /
        snapshot (``current_device_spec()``), once a program ran on its
        device."""
        with self._cond:
            if spec is not None:
                self.spec = spec
            self.enabled = True
        self._reg().compile_hook = self.on_compile
        return self

    def disable(self, join_timeout: float = 20.0) -> None:
        """Unhook the recompile detector. (Cards complete inline: there is
        no analysis thread to join.)"""
        reg = self._reg()
        if reg.compile_hook == self.on_compile:
            reg.compile_hook = None
        with self._cond:
            self.enabled = False

    def reset(self) -> None:
        with self._cond:
            self._cards.clear()
            del self._order[:]
        with self._clock:
            self._ring.clear()
            self._warm.clear()
            # the expected grid survives: it is conf-derived wiring (like
            # the compile hook), not per-run measurement state

    # -- capture -------------------------------------------------------
    def on_compile(self, name: str, cause: str, seconds: float,
                   fn=None, args=(), kwargs=None, key=None,
                   mem=None) -> None:
        """The recompile detector's hook: called once per genuinely new
        (program, signature) first call with the program, the triggering
        call's arguments and (``mem``) the allocator's figures of that
        call. Records the compile, then completes the card inline from the
        program's own account (``fn.cost_analysis(*args)``) — a program without
        one (``fn=None``: the fakes of tests) leaves the card ``new``.
        Never raises: a ledger bug must not kill a train step or a served
        request."""
        try:
            if not self.enabled:
                return
            disp, h = shapes_signature(args, kwargs)
            with self._cond:
                card = self._cards.get((name, h))
                if card is None:
                    card = self._new_card(name, h, disp, cause, key)
                    self._cards[(name, h)] = card
                    self._order.append((name, h))
                card["compiles"] += 1
                card["compile_s"] = round(card["compile_s"]
                                          + float(seconds), 6)
                need = fn is not None and card["status"] == "new"
            self._record_flight(name, cause, seconds, disp, h, key)
            reg = self._reg()
            reg.count("perf.compile_hooks")
            if need:
                cost, err = None, None
                try:
                    cost = fn.cost_analysis(*args, **(kwargs or {}))
                except Exception as e:
                    err = "%s: %s" % (type(e).__name__, e)
                self.complete_card(name, h, cost=cost, mem=mem, error=err)
        except Exception:
            self._reg().count("perf.capture_errors")

    def _record_flight(self, name, cause, seconds, disp, h, key) -> None:
        """One compile into the flight ring + the warm-grid account, with
        trigger attribution: the active trace context (a serving request
        paying the cliff at prefill) and/or the active compile window (the
        dispatcher's session-creation / batch-step bracket). Emits the
        ``program_compile`` JSONL event OUTSIDE the ring lock."""
        reg = self._reg()
        tc = reg.current_trace()
        win = reg.current_compile_window()
        ks = str(key) if key is not None else None
        rec = {"name": name, "key": ks, "cause": cause,
               "shapes": disp, "sig": h,
               "seconds": round(float(seconds), 6),
               # the compile STARTED seconds ago (same convention as the
               # telemetry compile event's ts)
               "ts": round(reg._ts(time.perf_counter()) - seconds, 6),
               "trigger_request": tc.request_id if tc is not None
               else None,
               "trigger_context": win.label if win is not None else None}
        with self._clock:
            self._compile_seq += 1
            rec["seq"] = self._compile_seq
            self._ring.append(dict(rec))
            if ks is not None:
                self._warm.add(ks)
            expected = len(self._expected)
            warm = sum(1 for k in self._expected if k in self._warm)
        ev = {"ev": "program_compile"}
        ev.update(rec)
        if expected:
            # the readiness transition rides the event: the offline report
            # replays warm-up as a 0 -> 100 trajectory
            ev["warm_programs"] = warm
            ev["expected_programs"] = expected
            ev["ready_pct"] = round(100.0 * warm / expected, 2)
        reg.record(ev)

    def recent_compiles(self, n: Optional[int] = None) -> List[dict]:
        """Newest-first snapshot of the compile flight ring."""
        with self._clock:
            out = [dict(r) for r in self._ring]
        out.reverse()
        return out[:n] if n else out

    def set_expected_grid(self, entries) -> None:
        """Register the EXPECTED program grid (the warm-grid readiness
        denominator): an iterable of ``(key, bucket_label)`` pairs — or
        bare keys — where ``key`` is the trainer's program key for a
        program the conf implies will run (``Trainer.
        expected_decode_grid`` enumerates the serving grid). Replaces any
        previous grid; keys are matched by ``str()`` against the keys the
        recompile detector reports."""
        exp: Dict[str, str] = {}
        for e in entries or ():
            if isinstance(e, (tuple, list)) and len(e) == 2 \
                    and isinstance(e[1], str):
                exp[str(e[0])] = e[1]
            else:
                exp[str(e)] = ""
        with self._clock:
            self._expected = exp

    def readiness(self) -> dict:
        """The warm-grid account: expected vs warm program counts,
        headline ``ready_pct`` (None when no grid is registered) and the
        per-bucket-label breakdown."""
        with self._clock:
            exp = dict(self._expected)
            warm_set = set(self._warm)
        buckets: Dict[str, dict] = {}
        warm = 0
        for k, label in sorted(exp.items()):
            st = buckets.setdefault(label or "all",
                                    {"expected": 0, "warm": 0})
            st["expected"] += 1
            if k in warm_set:
                st["warm"] += 1
                warm += 1
        for st in buckets.values():
            st["ready_pct"] = round(100.0 * st["warm"] / st["expected"],
                                    2)
        return {"expected": len(exp), "warm": warm,
                "ready_pct": round(100.0 * warm / len(exp), 2)
                if exp else None,
                "cold_keys": sorted(k for k in exp
                                    if k not in warm_set)[:16],
                "buckets": buckets}

    @staticmethod
    def _new_card(name, h, disp, cause, key) -> dict:
        return {"name": name, "shapes": disp, "sig": h,
                "key": str(key) if key is not None else None,
                "cause": cause, "compiles": 0, "compile_s": 0.0,
                "flops": None, "bytes_accessed": None,
                "arg_bytes": None, "temp_bytes": None, "out_bytes": None,
                "gen_code_bytes": None, "peak_bytes": None,
                "predicted_s": None, "status": "new", "error": None}

    def complete_card(self, name: str, sig: str, cost=None, mem=None,
                      error: Optional[str] = None) -> Optional[dict]:
        """Fill a card's analysis fields (the program's account and the
        probe's memory dict, or faked test dicts), compute the roofline
        prediction, and publish the ``program_card`` telemetry event."""
        spec = self._spec()
        with self._cond:
            card = self._cards.get((name, sig))
            if card is None:
                card = self._new_card(name, sig, sig, "unknown", None)
                self._cards[(name, sig)] = card
                self._order.append((name, sig))
            if error is not None:
                card["status"] = "error"
                card["error"] = error[:200]
            else:
                card["status"] = "ready"
                if cost:
                    f = cost.get("flops")
                    b = cost.get("bytes accessed")
                    card["flops"] = float(f) if f is not None else None
                    card["bytes_accessed"] = float(b) if b is not None \
                        else None
                card["arg_bytes"] = _mem_field(mem,
                                               "argument_size_in_bytes")
                card["temp_bytes"] = _mem_field(mem, "temp_size_in_bytes")
                card["out_bytes"] = _mem_field(mem, "output_size_in_bytes")
                card["gen_code_bytes"] = _mem_field(
                    mem, "generated_code_size_in_bytes")
                card["peak_bytes"] = footprint_bytes(mem)
                card["predicted_s"] = predicted_seconds(
                    card["flops"], card["bytes_accessed"], spec)
            # the spec's peaks ride the event so an offline report can
            # recompute the MFU/eff joins without guessing the device
            ev = {"ev": "program_card", "spec": spec.name,
                  "spec_peak_flops": spec.peak_flops,
                  "spec_hbm_bw": spec.hbm_bw}
            ev.update({k: card[k] for k in (
                "name", "shapes", "sig", "key", "cause", "compiles",
                "compile_s", "flops", "bytes_accessed", "arg_bytes",
                "temp_bytes", "out_bytes", "peak_bytes", "predicted_s",
                "status", "error")})
            reg = self._reg()
            reg.count("perf.cards")
            reg.record(ev)
            return dict(card)

    def drain(self, timeout: float = 10.0) -> bool:
        """Cards complete inline: always idle (kept for the JAX callers'
        end-of-run flush)."""
        return True

    # -- views ---------------------------------------------------------
    def cards(self) -> List[dict]:
        """Insertion-ordered card copies."""
        with self._cond:
            return [dict(self._cards[k]) for k in self._order]

    def card(self, name: str) -> Optional[dict]:
        """The most recent card for a program name (any signature)."""
        with self._cond:
            for k in reversed(self._order):
                if k[0] == name:
                    return dict(self._cards[k])
        return None

    def snapshot(self) -> dict:
        """Everything the surfaces render: the spec, the cards joined
        against their measured latency histograms (mfu_pct /
        roofline_eff_pct / measured p50+p99), the HBM account and the
        warm-grid readiness."""
        spec = self._spec()
        cards = self.cards()
        series = [measured_series(c) for c in cards]
        needed = set(series)
        needed.discard(None)
        reg = self._reg()
        stats: Dict[str, dict] = {}
        if needed:
            with reg._lock:
                for s in needed:
                    hist = reg.hists.get(s)
                    if hist is not None and hist.n:
                        stats[s] = hist.stats()
        by_series: Dict[Tuple[str, Optional[str]], int] = {}
        for c, s in zip(cards, series):
            by_series[(c["name"], s)] = by_series.get((c["name"], s),
                                                      0) + 1
        peak = None
        for c, s in zip(cards, series):
            st = stats.get(s) if s else None
            c["measured_series"] = s
            # the measured histogram is per series: with several live
            # signatures (decode buckets, prompt lengths) each card's
            # mfu/eff joins a p50 that AGGREGATES its siblings — flagged
            c["series_shared_by"] = by_series[(c["name"], s)]
            c["measured_n"] = st["count"] if st else 0
            c["measured_p50_ms"] = st["p50_ms"] if st else None
            c["measured_p99_ms"] = st["p99_ms"] if st else None
            c["mfu_pct"] = c["roofline_eff_pct"] = None
            if st and st["p50_ms"]:
                p50_s = st["p50_ms"] / 1e3
                if c["flops"] is not None and spec.peak_flops > 0:
                    c["mfu_pct"] = round(
                        100.0 * c["flops"] / (p50_s * spec.peak_flops), 2)
                if c["predicted_s"] is not None:
                    c["roofline_eff_pct"] = round(
                        100.0 * c["predicted_s"] / p50_s, 2)
            if c["peak_bytes"] is not None:
                peak = max(peak or 0, c["peak_bytes"])
        decode_kv = None
        fn = self._decode_kv_fn
        if fn is not None:
            try:
                decode_kv = int(fn())
            except Exception:
                decode_kv = None    # the account never kills a scrape
        hbm = {"capacity_bytes": spec.hbm_capacity,
               "peak_bytes": peak,
               # the live decode KV cache: persistent device state held
               # BETWEEN program executions, charged on top of the peak
               # program footprint (conservative: a card's peak already
               # holds the caches resident at its first call)
               "decode_kv_bytes": decode_kv,
               "headroom_bytes":
               (spec.hbm_capacity - peak - (decode_kv or 0))
               if peak is not None else None}
        return {"spec": spec.to_dict(), "enabled": self.enabled,
                "cards": cards, "hbm": hbm,
                "readiness": self.readiness()}

    def decode_pool_cap_bytes(self,
                              frac: float = 0.5) -> Optional[int]:
        """Byte budget for the PAGED decode KV pool: ``frac`` of what the
        capacity leaves after the peak program footprint measured so far.
        The decode-KV hook is NOT charged here — the pool replaces the
        dense caches that hook reports. None when the ledger is off (the
        pool then sizes at dense-equivalent capacity).
        ``Trainer.decode_kv_pool`` floors the result at one max-length
        sequence."""
        if not self.enabled:
            return None
        spec = self._spec()
        peak = 0
        with self._cond:
            for c in self._cards.values():
                pb = c.get("peak_bytes")
                if pb is not None:
                    peak = max(peak, int(pb))
        room = spec.hbm_capacity - peak
        if room <= 0:
            return None
        return int(max(0.0, min(1.0, float(frac))) * room)

    def set_decode_kv(self, fn) -> None:
        """Register the decode KV-cache account hook (``fn() -> bytes``;
        None clears): servd's batching frontend wires its
        ``decode_kv_bytes`` here."""
        self._decode_kv_fn = fn


def torch_profiler(cuda: bool):
    """A ``torch.profiler`` of CPU activity, and of CUDA activity (the
    card's kernels, from every thread of the process) with ``cuda``."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _torch_trace(stop: threading.Event, secs: float, path: str) -> None:
    """One ``torch.profiler`` capture of ``secs`` seconds (CUDA activity
    where a card is present), cut short by ``stop``, written as
    ``trace.json`` (a Chrome trace) into ``path``."""
    import torch
    prof = torch_profiler(torch.cuda.is_available())
    prof.start()
    try:
        # sliced sleep so shutdown() can end the capture early
        deadline = time.monotonic() + secs
        while time.monotonic() < deadline and not stop.is_set():
            time.sleep(min(0.2, max(0.0, deadline - time.monotonic())))
    finally:
        prof.stop()
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


class ProfilerCapture:
    """The /profilez guard: at most ONE profiler capture at a time, each
    into a fresh numbered subdirectory of the run-scoped ``outdir`` (conf
    key ``profilez_dir``). ``start(secs)`` returns (ok, detail)
    immediately — the capture itself runs on a daemon thread so the HTTP
    handler never blocks for the capture window. ``trace_fn(secs, path)``
    is injectable for tests; the default is a ``torch.profiler`` capture
    (``trace.json`` in the directory)."""

    MAX_SECS = 120.0

    def __init__(self, outdir: str, trace_fn=None):
        self.outdir = outdir
        self._trace_fn = trace_fn or self._default_trace
        self._lock = lockrank.lock("perf.profilez")
        self._busy = False
        # shutdown() sets _stop to cut an in-flight capture short and
        # LATCHES _shutdown so a racing /profilez request cannot start a
        # fresh capture thread into interpreter teardown
        self._stop = threading.Event()
        self._shutdown = False
        self._thread: Optional[threading.Thread] = None
        self.captures = 0
        self.last_path: Optional[str] = None
        self.last_error: Optional[str] = None

    def _default_trace(self, secs: float, path: str) -> None:
        _torch_trace(self._stop, secs, path)

    def start(self, secs: float) -> Tuple[bool, str]:
        try:
            secs = float(secs)
        except (TypeError, ValueError):
            return False, "secs must be a number"
        if not (0 < secs <= self.MAX_SECS):
            return False, ("secs must be in (0, %g]" % self.MAX_SECS)
        with self._lock:
            if self._shutdown:
                return False, "profiler shut down (process exiting)"
            if self._busy:
                return False, ("capture already in progress (into %s); "
                               "one at a time" % (self.last_path or "?"))
            self._busy = True
            self.captures += 1
            path = os.path.join(self.outdir,
                                "capture_%03d" % self.captures)
            self.last_path = path
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, args=(secs, path),
                name="cxn-profilez", daemon=True)
            # started under the lock: shutdown() can never observe _busy
            # without also seeing a joinable thread
            self._thread.start()
        telemetry.count("perf.profilez_captures")
        telemetry.event({"ev": "profilez", "secs": secs, "path": path})
        return True, path

    def _run(self, secs: float, path: str) -> None:
        err = None
        try:
            os.makedirs(path, exist_ok=True)
            self._trace_fn(secs, path)
        except Exception as e:
            err = "%s: %s" % (type(e).__name__, e)
        with self._lock:
            self._busy = False
            self.last_error = err
        if err:
            # the HTTP 200 went out before the capture ran: make the
            # failure visible — counted, logged, and echoed by the NEXT
            # /profilez response (statusd reads last_error)
            telemetry.count("perf.profilez_errors")
            telemetry.event({"ev": "profilez_error", "path": path,
                             "error": err[:200]})

    def busy(self) -> bool:
        with self._lock:
            return self._busy

    def shutdown(self, timeout: float = 20.0) -> bool:
        """Cut short any in-flight capture and JOIN its thread; run before
        process teardown (learn_task's exit path does). True when the
        capture finished within the timeout. Latches: a /profilez request
        racing the drain is refused from here on."""
        with self._lock:
            self._shutdown = True
            self._stop.set()
            t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        with self._lock:
            return not self._busy

    def wait(self, timeout: float = 30.0) -> bool:
        """Poll until the in-flight capture (if any) finishes."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.busy():
                return True
            time.sleep(0.02)
        return not self.busy()


# ----------------------------------------------------------------------
# module-level singleton surface (the learn-task wiring)
_LEDGER = Ledger()


def ledger() -> Ledger:
    return _LEDGER


def enable(spec: Optional[DeviceSpec] = None) -> Ledger:
    return _LEDGER.enable(spec=spec)


def disable() -> None:
    _LEDGER.disable()


def enabled() -> bool:
    return _LEDGER.enabled


def drain(timeout: float = 10.0) -> bool:
    return _LEDGER.drain(timeout)


def reset() -> None:
    _LEDGER.reset()


def set_decode_kv(fn) -> None:
    """Module-level form of ``Ledger.set_decode_kv`` (the learn-task serve
    wiring)."""
    _LEDGER.set_decode_kv(fn)


def decode_bound_tokens_per_s(ntok: int) -> Optional[float]:
    """The decode-step roofline bound for a served request: the decode
    program generates ntok-1 of the request's tokens (the first came from
    prefill), so the hardware-allowed rate is (ntok-1) / the program's
    predicted execution time. None until a decode-step card is ready —
    callers (servd's flight recorder) stay null-safe."""
    if ntok is None or ntok < 2 or not _LEDGER.enabled:
        return None
    card = _LEDGER.card("jit.decode_step")
    if card is None or not card.get("predicted_s"):
        return None
    return round((ntok - 1) / card["predicted_s"], 3)


# ----------------------------------------------------------------------
def selftest(verbose: bool = False) -> int:
    """Card math from faked analyses, MFU/headroom joins against a private
    telemetry registry, the compile ring and readiness, /programz +
    /compilez + /metrics + /profilez over a real socket, the
    one-capture-at-a-time guard. Runs under runtime lock-rank
    enforcement."""
    with lockrank.enforced():
        return _selftest_body(verbose)


def _selftest_body(verbose: bool = False) -> int:
    from urllib.request import urlopen
    from urllib.error import HTTPError

    reg = telemetry._Registry()
    reg.enable()
    spec = DeviceSpec("test", 100e12, 500e9, 8 * 2.0**30)
    lg = Ledger(registry=reg, spec=spec).enable()
    assert reg.compile_hook == lg.on_compile

    # a faked train-step compile + analysis: flops-bound program
    class _A:
        def __init__(self, shape, dtype="float32"):
            self.shape, self.dtype = shape, dtype
    disp, sig = shapes_signature(([_A((8, 128)), {"w": _A((128, 64))}],),
                                 None)
    lg.on_compile("jit.train_step", "new_signature", 1.25, fn=None,
                  args=([_A((8, 128)), {"w": _A((128, 64))}],), key="k1")
    card = lg.complete_card(
        "jit.train_step", sig,
        cost={"flops": 2.0e12, "bytes accessed": 1.0e9},
        mem={"argument_size_in_bytes": 3 * 2**30,
             "temp_size_in_bytes": 2**30,
             "output_size_in_bytes": 2**20})
    # flops-bound: 2e12/100e12 = 20ms > 1e9/500e9 = 2ms
    assert abs(card["predicted_s"] - 0.02) < 1e-9, card
    assert card["peak_bytes"] == 3 * 2**30 + 2**30 + 2**20
    assert card["status"] == "ready" and card["compile_s"] == 1.25
    evs = [e for e in reg.events() if e.get("ev") == "program_card"]
    assert evs and evs[-1]["flops"] == 2.0e12

    # a program with its own account is carded inline at its compile, the
    # allocator's peak winning over the sum of the parts
    class _Prog:
        def cost_analysis(self, *args):
            return {"flops": 4.0e9, "bytes accessed": 1.0e9}
    lg.on_compile("jit.eval_fwd", "new_signature", 0.1, fn=_Prog(),
                  args=(_A((2, 3)),),
                  mem={"argument_size_in_bytes": 10,
                       "temp_size_in_bytes": 5,
                       "output_size_in_bytes": 1,
                       "peak_size_in_bytes": 100})
    inline = lg.card("jit.eval_fwd")
    assert inline["status"] == "ready" and inline["flops"] == 4.0e9, inline
    assert inline["peak_bytes"] == 100
    assert inline["predicted_s"] == 1.0e9 / 500e9

    # measured join: feed the train.step histogram at ~40ms -> MFU 50%
    for _ in range(10):
        reg.hist("train.step", 0.040)
    snap = lg.snapshot()
    c = [c for c in snap["cards"] if c["name"] == "jit.train_step"][0]
    assert c["measured_n"] == 10
    assert c["mfu_pct"] is not None and 35.0 < c["mfu_pct"] < 65.0, c
    assert c["roofline_eff_pct"] is not None \
        and 35.0 < c["roofline_eff_pct"] < 65.0
    assert snap["hbm"]["peak_bytes"] == card["peak_bytes"]
    assert snap["hbm"]["headroom_bytes"] == \
        spec.hbm_capacity - card["peak_bytes"]

    # an error completion keeps the card visible, fields null
    lg.on_compile("jit.predict", "new_signature", 0.2, fn=None,
                  args=(_A((4, 4)),))
    _, sig2 = shapes_signature((_A((4, 4)),), None)
    bad = lg.complete_card("jit.predict", sig2, error="boom")
    assert bad["status"] == "error" and bad["flops"] is None

    # decode bound: needs a ready decode-step card
    assert decode_bound_tokens_per_s(16) is None     # module ledger off
    _, sig3 = shapes_signature((_A((1, 8)),), None)
    lg.on_compile("jit.decode_step", "new_signature", 0.5, fn=None,
                  args=(_A((1, 8)),))
    lg.complete_card("jit.decode_step", sig3,
                     cost={"flops": 1.0e9, "bytes accessed": 5.0e8})
    cardd = lg.card("jit.decode_step")
    assert cardd["predicted_s"] == 5.0e8 / 500e9

    # compile flight ring + the warm-grid readiness account
    lg.set_expected_grid([(("sess_step", 2, 0.0, 0), "2"),
                          (("sess_admit", 2), "2"),
                          (("sess_prefill", 8, 0.0, 0), "prefill")])
    rd = lg.readiness()
    assert rd["expected"] == 3 and rd["warm"] == 0 \
        and rd["ready_pct"] == 0.0, rd
    with reg.trace_context("req-7") as tc7:
        reg.record_compile("jit.decode_prefill", "new_signature", 0.3,
                           key=("sess_prefill", 8, 0.0, 0))
        lg.on_compile("jit.decode_prefill", "new_signature", 0.3,
                      fn=None, args=(_A((1, 8)),),
                      key=("sess_prefill", 8, 0.0, 0))
    assert tc7.compiles and tc7.compiles[0]["dur"] == 0.3
    with reg.compile_window("session:b2") as cwin:
        reg.record_compile("jit.decode_step", "new_signature", 0.7,
                           key=("sess_step", 2, 0.0, 0))
        lg.on_compile("jit.decode_step", "new_signature", 0.7,
                      fn=None, args=(_A((2, 8)),),
                      key=("sess_step", 2, 0.0, 0))
    assert cwin.stall_s == 0.7, cwin.compiles
    assert reg.current_compile_window() is None
    recs = lg.recent_compiles(2)          # newest first
    assert recs[0]["key"] == str(("sess_step", 2, 0.0, 0))
    assert recs[0]["trigger_context"] == "session:b2" \
        and recs[0]["trigger_request"] is None, recs[0]
    assert recs[1]["trigger_request"] == "req-7" \
        and recs[1]["trigger_context"] is None, recs[1]
    assert recs[0]["seq"] > recs[1]["seq"] > 0
    rd = lg.readiness()
    assert rd["warm"] == 2 and rd["ready_pct"] == 66.67, rd
    assert rd["buckets"]["2"] == {"expected": 2, "warm": 1,
                                  "ready_pct": 50.0}, rd
    assert rd["cold_keys"] == [str(("sess_admit", 2))], rd
    # a session's one-step card joins decode.step, the solo loop's
    # decode.decode
    for _ in range(3):
        reg.hist("decode.step", 0.002)
    sc = [c for c in lg.snapshot()["cards"]
          if c["key"] == str(("sess_step", 2, 0.0, 0))][0]
    assert sc["measured_series"] == "decode.step" and sc["measured_n"] == 3

    # /programz + /metrics + /compilez + /profilez over a real socket
    from . import statusd
    srv = statusd.StatusServer(0, host="127.0.0.1", registry=reg).start()
    srv.perf = lg
    started = []

    def fake_trace(secs, path):
        started.append(path)
        time.sleep(secs)

    import tempfile
    prof = ProfilerCapture(tempfile.mkdtemp(prefix="cxn-perf-selftest-"),
                           trace_fn=fake_trace)
    srv.profiler = prof
    try:
        base = "http://127.0.0.1:%d" % srv.port
        page = urlopen(base + "/programz", timeout=5).read().decode()
        assert "jit.train_step" in page and "MFU" in page
        doc = json.loads(urlopen(base + "/programz?json=1",
                                 timeout=5).read())
        assert any(c["name"] == "jit.train_step" for c in doc["cards"])
        m = urlopen(base + "/metrics", timeout=5).read().decode()
        for line in m.splitlines():
            if line and not line.startswith("#"):
                assert statusd.PROM_LINE_RE.match(line), line
        assert 'cxxnet_program_mfu_pct{process="0",program=' in m
        assert "cxxnet_hbm_peak_bytes" in m
        assert "cxxnet_ready_programs_pct" in m
        assert 'cxxnet_ready_programs_bucket_pct{process="0"' \
               ',bucket="2"} 50.0' in m
        page = urlopen(base + "/compilez", timeout=5).read().decode()
        assert "compile flight recorder" in page \
            and "session:b2" in page and "66.7% ready" in page, page
        doc = json.loads(urlopen(base + "/compilez?json=1&n=2",
                                 timeout=5).read())
        assert doc["shown"] == 2 and doc["total"] >= 4
        assert doc["compiles"][0]["trigger_context"] == "session:b2"
        try:
            urlopen(base + "/compilez?n=nope", timeout=5)
            raise AssertionError("bad n should 400")
        except HTTPError as e:
            assert e.code == 400
        r = urlopen(base + "/profilez?secs=0.5", timeout=5)
        assert r.status == 200 and b"capture_001" in r.read()
        try:
            urlopen(base + "/profilez?secs=0.5", timeout=5)
            raise AssertionError("concurrent capture should 409")
        except HTTPError as e:
            assert e.code == 409
        prof.wait(5.0)
        assert started and started[0].endswith("capture_001")
        ok, detail = prof.start(0.01)      # guard released after finish
        assert ok, detail
        prof.wait(5.0)
        srv.profiler = None
        try:
            urlopen(base + "/profilez?secs=1", timeout=5)
            raise AssertionError("no profiler registered should 404")
        except HTTPError as e:
            assert e.code == 404
        srv.perf = None
        try:
            urlopen(base + "/compilez", timeout=5)
            raise AssertionError("no ledger registered should 404")
        except HTTPError as e:
            assert e.code == 404
    finally:
        srv.stop()
        lg.disable()
        reg.disable()
    if verbose:
        print("perf selftest: card math, inline cards, MFU/headroom "
              "joins, compile ring + readiness, /programz, /compilez, "
              "/metrics program series, /profilez guard ok")
    return 0


if __name__ == "__main__":
    import sys
    if "--selftest" in sys.argv[1:]:
        sys.exit(selftest(verbose=True))
    print(__doc__)
    sys.exit(1)
