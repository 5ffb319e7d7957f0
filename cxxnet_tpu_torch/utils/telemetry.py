"""Process-wide structured telemetry of the port: counters, gauges,
histograms, events, spans and request attribution — the parts of
cxxnet_tpu/utils/telemetry.py that the serving frontend (``utils/servd.py``),
the trainer and ``learn_task`` call, with the same names, event shapes and
JSONL format.

* **counters / gauges / histograms** — ``count("serve.tokens", n)``,
  ``gauge("serve.queue_depth", v)``, ``hist("serve.ttft", seconds)`` into
  fixed LOG-SPACED buckets (``HIST_BUCKETS``: 4 per decade, 1µs..1000s,
  the JAX package's bounds, so histograms of the two packages merge by
  bucket-count addition); ``declare_hist`` registers an empty series.
* **events and spans** — ``event({...})`` appends one raw event; ``with
  span("name"):`` records a wall-time span and feeds the histogram of its
  name.
* **request attribution** — ``with trace_context(request_id) as tc:``
  tags every event recorded on the same thread underneath it with
  ``"req": request_id`` and collects per-request counter deltas, compile
  records and marks on ``tc``; ``mark(name)`` timestamps a named boundary
  on the active context (the trainer marks ``first_token`` at its
  prefill/decode split, after the first token reached the host: the TTFT
  boundary). Contexts are thread-local and work with telemetry DISABLED.
* **compile windows** — ``compile_window(label)`` collects the compile
  records taken on its thread while it is open. What stands in for a
  compile in the port is the first-use build and load of a CUDA kernel
  library (``ops/_build.py`` records it through ``record_compile``); a
  kernel first used inside a request stalls that request exactly as an
  XLA compile stalls a JAX one, and the records keep the JAX field names
  (``name``, ``cause``, ``dur``).
* **flight recorder** — ``FlightRecorder``, a bounded ring of the last N
  completed request records; ``request_chrome_trace`` renders one as a
  Chrome trace.
* **conservation laws** — ``BooksAuditor`` (``audit_register`` /
  ``audit_unregister`` / ``audit_sweep``): named invariants over the
  serving books, latched on the first violation.

Sink: ``enable(path)`` opens a JSONL run log (one event per line, the
``telemetry_log`` key of the command line); ``flush()`` writes what is
pending, with a counters and a histograms snapshot when they moved.
Without a path events stay buffered in memory, bounded.

Disabled (the default) the module is near-zero overhead: ``span()`` returns
a shared no-op context manager, counters are one thread-local read plus a
branch, and no events are buffered. Standard library only.
"""


import bisect
import io
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import lockrank

__all__ = [
    "enable", "disable", "enabled", "span", "count", "gauge", "hist",
    "event", "record_compile", "flush", "events", "recent_events",
    "Histogram", "HIST_BUCKETS", "trace_context", "current_trace", "mark",
    "declare_hist", "TraceContext", "FlightRecorder", "request_chrome_trace",
    "REQUEST_PHASES", "CompileWindow", "compile_window", "BooksAuditor",
    "auditor", "audit_register", "audit_unregister", "audit_sweep",
]

# in-memory event buffer bound when NO log sink drains it (library mode):
# oldest events drop past this
_PENDING_CAP = 65536
# recent-event ring kept even WITH a log sink (``recent_events``)
_RING_CAP = 4096

# Fixed log-spaced histogram bucket upper bounds (seconds): 4 per decade,
# 1µs .. 1000s. FIXED for every histogram in every process by design —
# merging is then exact bucket-count addition.
HIST_BUCKETS = tuple(round(10.0 ** (e / 4.0), 10) for e in range(-24, 13))


class Histogram:
    """Fixed-bucket latency histogram (see HIST_BUCKETS). ``counts[i]``
    holds observations with value <= HIST_BUCKETS[i] (and > the previous
    bound); the final slot is the +Inf overflow. Mergeable exactly."""

    __slots__ = ("counts", "sum", "n")

    def __init__(self):
        self.counts = [0] * (len(HIST_BUCKETS) + 1)
        self.sum = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(HIST_BUCKETS, v)] += 1
        self.sum += v
        self.n += 1

    def to_dict(self) -> dict:
        """JSON-friendly sparse snapshot (only nonzero buckets)."""
        return {"buckets": {str(i): c for i, c in enumerate(self.counts)
                            if c},
                "sum": round(self.sum, 9), "count": self.n}

class _NullSpan:
    """Shared no-op context manager returned by span() when disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("reg", "name", "attrs", "t0", "depth")

    def __init__(self, reg: "_Registry", name: str, attrs):
        self.reg = reg
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = self.reg._stack()
        self.depth = len(stack)
        stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        stack = self.reg._stack()
        if stack and stack[-1] is self.name:
            stack.pop()
        self.reg._record_span(self.name, self.t0, dur, self.depth,
                              self.attrs)
        return False


class TraceContext:
    """One request's attribution scope (``with trace_context(rid):``).

    While active on a thread, every span/event that thread records is
    tagged ``"req": request_id``, counter deltas are mirrored into
    ``self.counts``, recompile events into ``self.compiles``, and
    ``mark(name)`` timestamps named boundaries into ``self.marks``
    (perf_counter stamps — the serving worker turns the trainer's
    ``first_token`` mark into TTFT). Contexts nest (innermost wins) and
    deliberately work with telemetry DISABLED: attribution costs a
    thread-local read, and the SLO layer needs the marks whether or not
    a JSONL sink exists."""

    __slots__ = ("reg", "request_id", "marks", "counts", "compiles", "t0")

    def __init__(self, reg: "_Registry", request_id):
        self.reg = reg
        self.request_id = str(request_id)
        self.marks: Dict[str, float] = {}
        self.counts: Dict[str, float] = {}
        self.compiles: List[dict] = []
        self.t0: Optional[float] = None

    def __enter__(self) -> "TraceContext":
        self.t0 = time.perf_counter()
        self.reg._ctx_stack().append(self)
        return self

    def __exit__(self, *exc):
        stack = self.reg._ctx_stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False

    def mark(self, name: str) -> None:
        self.marks[name] = time.perf_counter()


class CompileWindow:
    """Collects the compile records observed on this thread while
    active — the batching dispatcher's stall-attribution bracket around
    work that runs OUTSIDE any request's trace context (warm-session
    creation, the batch-wide decode step): a compile inside the window
    stalled every request aboard the batch, so the dispatcher fans
    ``window.compiles`` out to their flight records as
    ``compile_stall_s``. Like TraceContext it works with telemetry
    DISABLED (thread-local append, no sink needed) and nests — every
    active window on the thread sees the compile. In the port a compile
    is the first-use build and load of a kernel library
    (``ops/_build.py``)."""

    __slots__ = ("reg", "label", "compiles")

    def __init__(self, reg: "_Registry", label):
        self.reg = reg
        self.label = str(label)
        self.compiles: List[dict] = []

    def __enter__(self) -> "CompileWindow":
        self.reg._win_stack().append(self)
        return self

    def __exit__(self, *exc):
        stack = self.reg._win_stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False

    @property
    def stall_s(self) -> float:
        return round(sum(c["dur"] for c in self.compiles), 6)


class _Registry:
    """The process-wide telemetry state. Use the module-level functions;
    the class exists so tests can build isolated instances."""

    def __init__(self):
        self.enabled = False
        self.log_path: Optional[str] = None
        self._log_f: Optional[io.TextIOBase] = None
        # innermost rank by design: every subsystem records telemetry,
        # so nothing may be acquired while this is held
        self._lock = lockrank.lock("telemetry.registry")
        self._tls = threading.local()
        # the JAX package's shard index; one process here, so always 0
        # (every event still carries "p", as there)
        self.process_index = 0
        self.reset()

    # -- lifecycle -----------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._pending: List[dict] = []
            self.counters: Dict[str, float] = {}
            self.gauges: Dict[str, float] = {}
            self.hists: Dict[str, Histogram] = {}
            self.compiles: List[dict] = []
            self._flushed_counters: Dict[str, float] = {}
            self._flushed_hist_n: Dict[str, int] = {}
            # recent-event ring (kept even with a log sink)
            self._recent: deque = deque(maxlen=_RING_CAP)
            self.t0_perf = time.perf_counter()
            # the wall-clock epoch of the events' ts, never a duration
            self.t0_wall = time.time()

    def enable(self, log_path: Optional[str] = None) -> None:
        self.reset()
        self.log_path = log_path or None
        if self._log_f is not None:
            self._log_f.close()
            self._log_f = None
        if self.log_path:
            d = os.path.dirname(os.path.abspath(self.log_path))
            if d:
                os.makedirs(d, exist_ok=True)
            self._log_f = open(self.log_path, "w")
        self.enabled = True
        self.record({"ev": "meta", "pid": os.getpid(),
                     "t0_wall": self.t0_wall})

    def disable(self) -> None:
        self.enabled = False
        if self._log_f is not None:
            self._log_f.close()
            self._log_f = None
        self.log_path = None

    # -- recording -----------------------------------------------------
    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _ctx_stack(self) -> list:
        s = getattr(self._tls, "ctx", None)
        if s is None:
            s = self._tls.ctx = []
        return s

    def _win_stack(self) -> list:
        s = getattr(self._tls, "win", None)
        if s is None:
            s = self._tls.win = []
        return s

    def trace_context(self, request_id) -> TraceContext:
        return TraceContext(self, request_id)

    def current_trace(self) -> Optional[TraceContext]:
        s = getattr(self._tls, "ctx", None)
        return s[-1] if s else None

    def compile_window(self, label) -> CompileWindow:
        return CompileWindow(self, label)

    def mark(self, name: str) -> None:
        """Timestamp a named boundary on this thread's active trace
        context (no-op without one); with telemetry enabled the boundary
        is also recorded as a ``mark`` event in the stream."""
        tc = self.current_trace()
        if tc is not None:
            tc.mark(name)
        if self.enabled:
            self.record({"ev": "mark", "name": name})

    def _ts(self, t_perf: float) -> float:
        return t_perf - self.t0_perf

    def record(self, ev: dict) -> None:
        """Append one raw event (already-shaped dict). No-op if disabled."""
        if not self.enabled:
            return
        if "ts" not in ev:
            ev["ts"] = round(self._ts(time.perf_counter()), 6)
        with self._lock:
            self._append(ev)

    def _append(self, ev: dict) -> None:
        # lock held. Without a sink nothing drains _pending: bound it so
        # an enabled-without-log run (library mode) cannot leak per-step
        if "p" not in ev:
            ev["p"] = self.process_index
        if "req" not in ev:
            # request attribution: the recording thread's active trace
            # context tags the event (thread-local read — safe under the
            # registry lock, never contended)
            tc = self.current_trace()
            if tc is not None:
                ev["req"] = tc.request_id
        self._pending.append(ev)
        self._recent.append(ev)
        if self._log_f is None and len(self._pending) > _PENDING_CAP:
            del self._pending[: _PENDING_CAP // 2]

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs or None)

    def _record_span(self, name, t0, dur, depth, attrs) -> None:
        if not self.enabled:     # disabled mid-span: drop silently
            return
        ev = {"ev": "span", "name": name, "ts": round(self._ts(t0), 6),
              "dur": round(dur, 6), "depth": depth,
              "tid": threading.get_ident()}
        if attrs:
            ev.update(attrs)
        with self._lock:
            self._append(ev)
            # every span feeds the mergeable fixed-bucket histogram of its
            # name
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = Histogram()
            h.observe(dur)

    def count(self, name: str, n=1) -> None:
        tc = self.current_trace()
        if tc is not None:
            # per-request attribution rides the thread-local context even
            # with telemetry disabled (the flight recorder's counter view)
            tc.counts[name] = tc.counts.get(name, 0) + n
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def hist(self, name: str, value: float) -> None:
        """Observe one value (seconds) into the named fixed-bucket
        histogram — for latencies measured outside a span (or values that
        are not span-shaped at all)."""
        if not self.enabled:
            return
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = Histogram()
            h.observe(value)

    def declare_hist(self, name: str) -> None:
        """Register a histogram series with zero observations, so a
        reader of the histograms (``metrics_snapshot``, the JSONL
        ``hists`` snapshot) sees the series exist BEFORE the first
        request, not appear mid-run."""
        if not self.enabled:
            return
        with self._lock:
            self.hists.setdefault(name, Histogram())

    def gauge(self, name: str, value) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = value
            self._append(
                {"ev": "gauge", "name": name, "value": value,
                 "ts": round(self._ts(time.perf_counter()), 6)})

    def record_compile(self, name: str, cause: str, seconds: float,
                       key=None) -> None:
        tc = self.current_trace()
        if tc is not None:
            # attribute the compile to the request that paid the cliff;
            # "off" = compile start relative to the context entry (the
            # backend call), so the trace export draws the bar inside
            # the phase that actually paid it — a fresh decode-program
            # compile runs in the decode phase, not prefill
            entry = {"name": name, "cause": cause,
                     "dur": round(seconds, 6)}
            if tc.t0 is not None:
                entry["off"] = round(
                    time.perf_counter() - seconds - tc.t0, 6)
            tc.compiles.append(entry)
        wins = getattr(self._tls, "win", None)
        if wins:
            # every active compile window on the thread sees the
            # compile — the batching dispatcher's batch-wide stall
            # attribution (a step compile stalls ALL slots aboard)
            wentry = {"name": name, "cause": cause,
                      "dur": round(seconds, 6)}
            if key is not None:
                wentry["key"] = str(key)
            for w in wins:
                w.compiles.append(dict(wentry))
        if not self.enabled:
            return
        ev = {"ev": "compile", "name": name, "cause": cause,
              "dur": round(seconds, 6),
              "ts": round(self._ts(time.perf_counter()) - seconds, 6),
              "tid": threading.get_ident()}
        if key is not None:
            ev["key"] = str(key)
        with self._lock:
            self._append(ev)
            self.compiles.append(ev)

    # -- sinks ---------------------------------------------------------
    def flush(self) -> None:
        """Write pending events to the JSONL log (if one is attached),
        plus a counters snapshot when any counter moved since the last
        flush — so a crashed run keeps its counters too, not only its
        spans. Without a log path events stay buffered in memory (the
        library mode; ``events()`` reads them there)."""
        if self._log_f is None:
            return
        with self._lock:
            batch, self._pending = self._pending, []
            counters = None
            if self.counters != self._flushed_counters:
                counters = dict(self.counters)
                self._flushed_counters = dict(counters)
            hists = None
            hist_n = {k: h.n for k, h in self.hists.items()}
            if hist_n != self._flushed_hist_n:
                hists = {k: h.to_dict() for k, h in self.hists.items()}
                self._flushed_hist_n = hist_n
            ts = round(self._ts(time.perf_counter()), 6)
            p = self.process_index
        for ev in batch:
            self._log_f.write(json.dumps(ev) + "\n")
        if counters is not None:
            self._log_f.write(json.dumps(
                {"ev": "counters", "counters": counters,
                 "ts": ts, "p": p}) + "\n")
        if hists is not None:
            # cumulative snapshot, last-wins on re-read — like counters,
            # so a crashed run keeps its histograms to the last flush
            self._log_f.write(json.dumps(
                {"ev": "hists", "hists": hists, "ts": ts, "p": p}) + "\n")
        self._log_f.flush()

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._pending)

    def recent_events(self) -> List[dict]:
        """The last ~_RING_CAP events regardless of sink."""
        with self._lock:
            return list(self._recent)

    def metrics_snapshot(self) -> dict:
        """One consistent point-in-time copy of the counters, gauges,
        raw histogram buckets, compile totals and uptime, taken under the
        lock so a reader never sees a half-updated histogram."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "hists": {k: h.to_dict() for k, h in self.hists.items()},
                "compiles": len(self.compiles),
                "compile_s": round(sum(c["dur"] for c in self.compiles), 6),
                "uptime_s": time.perf_counter() - self.t0_perf,
                "process": self.process_index,
            }


# the canonical request-phase order:
# queue_wait (accept -> worker pop), dispatch (pop -> backend call),
# prefill (backend call -> first token: TTFT's server-side share),
# decode (first token -> last token). The phases TILE the request's
# wall-clock — their sum is the request's total by construction.
REQUEST_PHASES = ("queue_wait", "dispatch", "prefill", "decode")


class FlightRecorder:
    """Bounded ring of the last N completed request traces — the
    per-request black box the serving frontend fills
    (``request_chrome_trace`` renders one). A record is one plain dict::

        {"id": "17", "outcome": "served", "tokens_in": 8, "tokens_out":
         16, "t_wall": <arrival unix time>, "total_s": 0.213,
         "ttft_s": 0.041, "tokens_per_s": 93.1,
         "phases": {"queue_wait": .., "dispatch": .., "prefill": ..,
                    "decode": ..},
         "recompiles": [{"name": "kernel:flash_fwd", "cause":
                         "first_use", "dur": 1.2}, ...],
         "counts": {<per-request counter deltas>}}

    Bounded and lock-guarded; eviction is oldest-first (deque maxlen).
    Registry-independent, so it works with telemetry disabled — a flight record must survive a run that configured no
    JSONL log."""

    def __init__(self, cap: int = 256):
        self.cap = max(1, int(cap))
        self._lock = lockrank.lock("telemetry.flight")
        self._ring: deque = deque(maxlen=self.cap)

    def record(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)

    def get(self, request_id) -> Optional[dict]:
        rid = str(request_id)
        with self._lock:
            # newest-first: a repeated id resolves to the most recent
            # flight. Repeats happen across frontend restarts feeding
            # one recorder, and with client-chosen TRACE ids — a
            # client that reuses an id (or picks one colliding with a
            # local dense id) shadows the older record here; clients
            # choose unique trace ids, the lookup does not guarantee it
            for rec in reversed(self._ring):
                if rec.get("id") == rid:
                    return rec
        return None

    def list(self) -> List[dict]:
        """Newest-first snapshot of the ring."""
        with self._lock:
            return list(reversed(self._ring))

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def request_chrome_trace(rec: dict, batch_iters=None) -> dict:
    """One flight record -> a Chrome-trace / Perfetto JSON object: the
    phases as back-to-back complete ('X') events on one lane (they tile
    the request's wall-clock), recompiles on a second lane inside the
    phase that paid them. Timestamps are µs relative to request accept,
    so the trace opens in ui.perfetto.dev showing exactly where this
    request's milliseconds went.

    ``batch_iters`` (optional, oldest-first) are the batching
    dispatcher's per-iteration scheduler records containing this
    request (``servd.BatchFlightRecorder.for_request``): they render as
    slot-Gantt lanes — one lane per decode slot, one bar per occupant
    run — aligned on the shared wall epoch (each iteration record's
    ``t_wall`` minus the request's), so the request's bar shows exactly
    which iterations it shared its decode with, and with whom."""
    rid = str(rec.get("id", "?"))
    trace: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "cxxnet-request %s" % rid}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
         "args": {"name": "phases"}},
    ]
    phases = rec.get("phases") or {}
    t = 0.0
    args = {"request": rid, "outcome": rec.get("outcome", "?"),
            "tokens_in": rec.get("tokens_in", 0),
            "tokens_out": rec.get("tokens_out", 0)}
    for name in REQUEST_PHASES:
        dur = float(phases.get(name, 0.0) or 0.0)
        if dur <= 0.0:
            continue
        trace.append({"ph": "X", "name": name, "pid": 0, "tid": 0,
                      "ts": round(t * 1e6, 1), "dur": round(dur * 1e6, 1),
                      "args": args})
        t += dur
    if t == 0.0:
        # no positive phase at all — an admission shed (honest zero
        # phases: nothing was dequeued or dispatched). The lane must
        # still be VISIBLE in a stitched cross-process trace (the
        # retried-request case renders the shed hop next to the served
        # one), so draw a 1µs marker named for the outcome.
        name = str(rec.get("outcome", "?"))
        if rec.get("shed_at"):
            name += "(%s)" % rec["shed_at"]
        trace.append({"ph": "X", "name": name, "pid": 0, "tid": 0,
                      "ts": 0.0, "dur": 1.0, "args": args})
    comp_t0 = float(phases.get("queue_wait", 0.0) or 0.0) \
        + float(phases.get("dispatch", 0.0) or 0.0)
    if rec.get("recompiles"):
        trace.append({"ph": "M", "name": "thread_name", "pid": 0,
                      "tid": 1, "args": {"name": "recompiles"}})
        ct = comp_t0
        for c in rec["recompiles"]:
            dur = float(c.get("dur", 0.0))
            off = c.get("off")
            # "off" places the bar where the compile actually ran
            # (relative to the backend call = prefill start) — a fresh
            # decode-program compile lands in the decode lane section,
            # matching the phase accounting; records without it (older
            # logs) fall back to stacking from prefill start
            ts = comp_t0 + max(0.0, float(off)) if off is not None \
                else ct
            trace.append({"ph": "X", "name": "compile:%s"
                          % c.get("name", "?"), "pid": 0, "tid": 1,
                          "ts": round(ts * 1e6, 1),
                          "dur": round(dur * 1e6, 1),
                          "args": {"cause": c.get("cause", "?"),
                                   "request": rid}})
            ct = ts + dur
    t0_wall = rec.get("t_wall")
    if batch_iters and t0_wall is not None:
        # slot-Gantt lanes: per slot, contiguous runs of the same
        # occupant merge into one bar (a straggler shows as one long
        # bar next to the short bars of the batchmates that came and
        # went). Each iteration spans [t_wall - step, t_wall] on the
        # shared wall epoch; clock skew vs the request's own accept
        # epoch is sub-ms on one host — good enough for a Gantt.
        runs: Dict[int, dict] = {}       # slot -> open run
        bars: List[tuple] = []           # (slot, closed run)
        for it in batch_iters:
            it_wall = it.get("t_wall")
            if it_wall is None:
                continue
            step_s = float(it.get("step_ms") or 0.0) / 1e3
            start = it_wall - t0_wall - step_s
            end = it_wall - t0_wall
            seen = set()
            for row in it.get("slots") or []:
                slot, occupant = int(row[0]), str(row[1])
                seen.add(slot)
                run = runs.get(slot)
                if run is not None and run["rid"] == occupant:
                    run["end"] = end
                    run["iters"][1] = it.get("iter")
                    continue
                if run is not None:
                    bars.append((slot, run))
                runs[slot] = {"rid": occupant, "start": start,
                              "end": end,
                              "iters": [it.get("iter"),
                                        it.get("iter")]}
            for slot in [s for s in runs if s not in seen]:
                bars.append((slot, runs.pop(slot)))
        bars.extend(runs.items())
        if bars:
            lanes = sorted({slot for slot, _ in bars})
            for slot in lanes:
                trace.append({"ph": "M", "name": "thread_name",
                              "pid": 0, "tid": 10 + slot,
                              "args": {"name": "batch slot %d" % slot}})
            for slot, run in bars:
                trace.append({
                    "ph": "X",
                    "name": run["rid"] if run["rid"] != rid
                    else "%s (this request)" % rid,
                    "pid": 0, "tid": 10 + slot,
                    "ts": round(run["start"] * 1e6, 1),
                    "dur": round(max(run["end"] - run["start"],
                                     1e-6) * 1e6, 1),
                    "args": {"occupant": run["rid"],
                             "iterations": "%s..%s" % tuple(run["iters"]),
                             "request": rid}})
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


class BooksAuditor:
    """Conservation-law registry: named invariants over the serving
    books — "accepted = served + shed + errors + deadline + abandoned",
    "blocks total = free + live + retained", "tenant charges sum to the
    door books" — checked on a daemon sweep (``start``) or on demand
    (``sweep``), so every number the request autopsy cites is provably
    reconciled.

    A law is a callable ``fn() -> Optional[str]``: ``None`` means the
    books reconcile (or the law could not take a consistent snapshot —
    inconclusive PASSES; a law must never false-latch off a racy read:
    use a stable-snapshot double-read and return None when the bracket
    moved), a string is the violation detail. The first violation
    LATCHES the law sticky-broken (``snapshot()["broken"]`` keeps it
    until ``reset()``), emits exactly one ``books_broken`` transition
    event (``broken: 1`` carrying the detail; ``reset()`` emits the
    matching ``broken: 0`` clear), and bumps the ``books.violations``
    counter — a single bad snapshot can never flap the state, and a
    reader sees the latch even if every later sweep reconciles.

    Laws run OUTSIDE the auditor lock (a law reads other subsystems'
    locked state; rank "telemetry.audit" keeps the latch bookkeeping
    below only the registry itself), and the transition events are
    emitted outside it too. A law that RAISES is counted
    (``law_errors``) but treated as inconclusive: laws are registered
    at start() and unregistered at drain(), and a transient exception
    during concurrent teardown must not break the books."""

    def __init__(self, registry: Optional["_Registry"] = None):
        self._lock = lockrank.lock("telemetry.audit")
        self._registry = registry
        self._laws: Dict[str, object] = {}
        self._broken: Dict[str, str] = {}
        self.violations = 0          # cumulative latches (survives reset)
        self.sweeps = 0
        self.law_errors = 0

    def _reg(self) -> "_Registry":
        return self._registry if self._registry is not None else _REG

    def register(self, name: str, fn) -> None:
        """Install (or replace) the named law."""
        with self._lock:
            self._laws[str(name)] = fn

    def unregister(self, name: str) -> None:
        """Remove the named law. A latch it already tripped STAYS
        latched — a violation observed just before drain must still
        fail the next scrape."""
        with self._lock:
            self._laws.pop(str(name), None)

    def sweep(self) -> Dict[str, Optional[str]]:
        """Evaluate every registered law once. Returns {law: detail}
        (None = reconciled/inconclusive) for this sweep; latch state is
        cumulative and read via snapshot()."""
        with self._lock:
            laws = list(self._laws.items())
        results: Dict[str, Optional[str]] = {}
        errors = 0
        for name, fn in laws:
            try:
                detail = fn()
            except Exception:
                errors += 1
                detail = None
            results[name] = None if detail is None else str(detail)
        newly: List[tuple] = []
        with self._lock:
            self.sweeps += 1
            self.law_errors += errors
            for name, detail in results.items():
                if detail is not None and name not in self._broken:
                    self._broken[name] = detail
                    self.violations += 1
                    newly.append((name, detail))
        reg = self._reg()
        for name, detail in newly:
            reg.count("books.violations")
            reg.record({"ev": "books_broken", "law": name, "broken": 1,
                        "detail": detail})
        return results

    def snapshot(self) -> dict:
        """Point-in-time view of the laws and their latches."""
        with self._lock:
            return {"laws": sorted(self._laws),
                    "broken": dict(self._broken),
                    "violations": self.violations,
                    "sweeps": self.sweeps,
                    "law_errors": self.law_errors}

# ----------------------------------------------------------------------
# module-level singleton surface
_REG = _Registry()


def enable(log_path: Optional[str] = None) -> None:
    """Turn telemetry on; with ``log_path`` events go to that JSONL file
    at every ``flush()``."""
    _REG.enable(log_path)


def disable() -> None:
    _REG.disable()


def enabled() -> bool:
    return _REG.enabled


def span(name: str, **attrs):
    return _REG.span(name, **attrs)


def count(name: str, n=1) -> None:
    _REG.count(name, n)


def gauge(name: str, value) -> None:
    _REG.gauge(name, value)


def hist(name: str, value: float) -> None:
    _REG.hist(name, value)


def declare_hist(name: str) -> None:
    _REG.declare_hist(name)


def trace_context(request_id) -> TraceContext:
    return _REG.trace_context(request_id)


def current_trace() -> Optional[TraceContext]:
    return _REG.current_trace()


def compile_window(label) -> CompileWindow:
    """A stall-attribution bracket for work outside any request's trace
    context (``with compile_window("step:b4") as w:`` — then read
    ``w.compiles`` / ``w.stall_s``). Works with telemetry disabled."""
    return _REG.compile_window(label)


def mark(name: str) -> None:
    _REG.mark(name)


def event(ev: dict) -> None:
    _REG.record(ev)


def record_compile(name: str, cause: str, seconds: float, key=None) -> None:
    _REG.record_compile(name, cause, seconds, key)


def flush() -> None:
    _REG.flush()


def events() -> List[dict]:
    return _REG.events()


def recent_events() -> List[dict]:
    return _REG.recent_events()


# the process-wide conservation-law auditor: subsystems register laws at
# start() (servd's door books, kvblocks' block conservation) and
# unregister them at drain(); ``audit_sweep`` evaluates them
_AUDITOR = BooksAuditor()


def auditor() -> BooksAuditor:
    return _AUDITOR


def audit_register(name: str, fn) -> None:
    _AUDITOR.register(name, fn)


def audit_unregister(name: str) -> None:
    _AUDITOR.unregister(name)


def audit_sweep() -> Dict[str, Optional[str]]:
    return _AUDITOR.sweep()
