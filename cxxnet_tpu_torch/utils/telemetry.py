"""Process-wide structured telemetry of the port: counters, gauges,
histograms, events, spans and request attribution — the port's copy of
cxxnet_tpu/utils/telemetry.py, with the same names, event shapes and JSONL
format.

* **counters / gauges / histograms** — ``count("serve.tokens", n)``,
  ``gauge("serve.queue_depth", v)``, ``hist("serve.ttft", seconds)`` into
  fixed LOG-SPACED buckets (``HIST_BUCKETS``: 4 per decade, 1µs..1000s,
  the JAX package's bounds, so histograms of the two packages merge by
  bucket-count addition); ``declare_hist`` registers an empty series.
* **events and spans** — ``event({...})`` appends one raw event; ``with
  span("name"):`` records a wall-time span (``span_event`` from explicit
  timings) and feeds the histogram of its name; ``sample_device_memory``
  records a card's allocator figures (``device.memory_stats``) as
  ``device.*`` gauges.
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
* **recompile detector** — ``jit_watch(fn, name, cause=..., key=...)``
  wraps one of the trainer's programs (``jit.train_step``,
  ``jit.decode_step``, ...) and records a ``compile`` event, with its cause
  and seconds, at the program's first call with an input signature it has
  not seen (the shapes and dtypes of its tensor arguments): the port's
  cold start, where kernel libraries build and cuBLAS, cuDNN and the
  allocator warm up. A compile's seconds are the first call's wall time
  with one wait for the card at its end; warm calls are never waited on.
  With a ``compile_hook`` on the registry (the performance ledger,
  ``utils/perf.py``) the watch also hands the hook the program, its
  arguments, its key and the allocator's figures of that first call.
* **flight recorder** — ``FlightRecorder``, a bounded ring of the last N
  completed request records; ``request_chrome_trace`` renders one as a
  Chrome trace.
* **conservation laws** — ``BooksAuditor`` (``audit_register`` /
  ``audit_unregister`` / ``audit_sweep``): named invariants over the
  serving books, latched on the first violation.

Sinks: ``enable(path)`` opens a JSONL run log (one event per line, the
``telemetry_log`` key of the command line); ``flush()`` writes what is
pending, with a counters and a histograms snapshot when they moved.
Without a path events stay buffered in memory, bounded. ``finish()``
records the end-of-run ``summary()`` (per-span totals and percentiles,
counters, gauges, compiles) and writes a Chrome trace beside the log
(``chrome_trace``, ``events_to_chrome``); the status pages
(``utils/statusd.py``) read the registry live.

Disabled (the default) the module is near-zero overhead: ``span()`` returns
a shared no-op context manager, counters are one thread-local read plus a
branch, and no events are buffered. Standard library only.
"""

from __future__ import annotations

import bisect
import io
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import lockrank

__all__ = [
    "enable", "disable", "enabled", "reset", "span", "count", "gauge",
    "hist", "event", "record_compile", "jit_watch", "JitWatch",
    "sample_device_memory",
    "flush", "finish", "summary", "brief_summary", "events",
    "recent_events", "last_event", "wall_epoch", "span_event",
    "percentile", "count_by",
    "chrome_trace", "events_to_chrome", "write_chrome_trace",
    "Histogram", "HIST_BUCKETS", "trace_context", "current_trace", "mark",
    "declare_hist", "TraceContext", "FlightRecorder",
    "request_chrome_trace", "REQUEST_PHASES",
    "CompileWindow", "compile_window", "current_compile_window",
    "BooksAuditor", "auditor", "audit_register", "audit_unregister",
    "audit_sweep",
]

# per-span-name duration history kept for live percentiles (the JSONL log
# keeps everything; this only bounds in-memory state on week-long runs)
_DUR_CAP = 8192
# in-memory event buffer bound when NO log sink drains it (bench/library
# mode): oldest events drop past this; aggregates (summary) are unaffected
_PENDING_CAP = 65536
# recent-event ring kept even WITH a log sink — the /trace endpoint's
# snapshot source (statusd serves a live Chrome trace from it)
_RING_CAP = 4096

# Fixed log-spaced histogram bucket upper bounds (seconds): 4 per decade,
# 1µs .. 1000s. FIXED for every histogram in every process by design —
# cross-process/shard merging is then exact bucket-count addition (the
# property Prometheus `le` buckets and telemetry_report --merge rely on).
HIST_BUCKETS = tuple(round(10.0 ** (e / 4.0), 10) for e in range(-24, 13))


def fmt_ms(v) -> str:
    """Render a millisecond figure, turning the empty-series sentinel
    (None — ``Histogram`` on zero observations) into "n/a". The ONE
    renderer of the sentinel, shared by /statusz and the report tools
    so the format cannot drift between them."""
    return "n/a" if v is None else "%.2fms" % v


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

    def percentile(self, p: float) -> float:
        """Estimated percentile: walk the cumulative counts to the target
        rank, interpolate linearly inside the bucket. Error is bounded by
        the bucket width (~78% per log-spaced step) — exact enough for
        p50/p90/p99 dashboards, and identical no matter how many shards
        were merged to produce the counts. Ranks landing in the +Inf
        overflow slot are CLAMPED to the last bound (1000s): the result
        must stay finite (strict-JSON logs, bench lines), so a tail past
        1000s reads as exactly 1000s — the overflow bucket's count is
        the tell.

        An EMPTY histogram returns None (never NaN, never a fake 0.0):
        a series that was declared but never fired — TTFT on a run that
        served zero requests — has no percentiles, and 0.0ms would read
        as an impossibly fast tail on /statusz and in bench lines. The
        renderers turn None into "n/a"; JSON sinks carry it as null."""
        if self.n == 0:
            return None
        rank = (p / 100.0) * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= rank:
                lo = HIST_BUCKETS[i - 1] if i > 0 else 0.0
                hi = HIST_BUCKETS[i] if i < len(HIST_BUCKETS) \
                    else HIST_BUCKETS[-1]
                frac = min(1.0, max(0.0, (rank - prev) / c))
                return lo + (hi - lo) * frac
        return HIST_BUCKETS[-1]

    def to_dict(self) -> dict:
        """JSON-friendly sparse snapshot (only nonzero buckets)."""
        return {"buckets": {str(i): c for i, c in enumerate(self.counts)
                            if c},
                "sum": round(self.sum, 9), "count": self.n}

    def merge_dict(self, d: dict) -> "Histogram":
        """Fold a ``to_dict`` snapshot in — EXACT because every histogram
        shares HIST_BUCKETS (shard merge = bucket-count addition). An
        out-of-range bucket index means the snapshot came from a build
        with DIFFERENT buckets (or a corrupted log): merging it would be
        silently wrong, so it raises ValueError for the caller to report."""
        for i, c in (d.get("buckets") or {}).items():
            i = int(i)
            if not 0 <= i < len(self.counts):
                raise ValueError(
                    "histogram bucket index %d out of range (%d buckets) "
                    "— snapshot from a mismatched HIST_BUCKETS version or "
                    "a corrupted log" % (i, len(self.counts)))
            self.counts[i] += int(c)
        self.sum += float(d.get("sum", 0.0))
        self.n += int(d.get("count", 0))
        return self

    def stats(self) -> dict:
        """Summary dict; the percentile fields are None (rendered "n/a",
        serialized null) when the histogram never observed anything."""
        if self.n == 0:
            return {"count": 0, "sum_s": 0.0,
                    "p50_ms": None, "p90_ms": None, "p99_ms": None}
        return {"count": self.n, "sum_s": round(self.sum, 6),
                "p50_ms": round(1e3 * self.percentile(50), 4),
                "p90_ms": round(1e3 * self.percentile(90), 4),
                "p99_ms": round(1e3 * self.percentile(99), 4)}


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
        self.process_index = 0
        # the performance ledger's compile hook (utils/perf.py): called by
        # JitWatch with the program, its call arguments and the first
        # call's memory figures on every detected compile. Survives
        # reset()/enable(), like the JAX registry's
        self.compile_hook = None
        self.reset()

    # -- lifecycle -----------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._pending: List[dict] = []
            self.counters: Dict[str, float] = {}
            self.gauges: Dict[str, float] = {}
            self.span_agg: Dict[str, list] = {}   # name -> [n, total, max]
            self.span_durs: Dict[str, deque] = {}
            self.hists: Dict[str, Histogram] = {}
            self.compiles: List[dict] = []
            self._flushed_counters: Dict[str, float] = {}
            self._flushed_hist_n: Dict[str, int] = {}
            # recent-event ring (kept even with a log sink): the /trace
            # endpoint's snapshot + last-event-by-kind for /statusz
            self._recent: deque = deque(maxlen=_RING_CAP)
            self.last_by_kind: Dict[str, dict] = {}
            self.t0_perf = time.perf_counter()
            # cxxlint: disable=wallclock — the shard-merge epoch: --merge
            # re-bases shards on the shared wall clock, never a duration
            self.t0_wall = time.time()

    def enable(self, log_path: Optional[str] = None,
               process_index: Optional[int] = None) -> None:
        self.reset()
        # the shard index of a multi-process run: the process's rank
        # (learn_task passes it), 0 alone
        self.process_index = int(process_index or 0)
        path = log_path or None
        if path and "%d" in path:
            # the multihost shard contract: each rank writes its own file
            path = path.replace("%d", str(self.process_index))
        elif path and self.process_index:
            # no placeholder on a non-zero rank: suffix rather than
            # silently clobber rank 0's shard
            sys.stderr.write(
                "WARNING: telemetry_log %r has no %%d rank placeholder in "
                "a multi-process run; writing %s.%d instead so shard 0 is "
                "not clobbered\n" % (path, path, self.process_index))
            path = "%s.%d" % (path, self.process_index)
        self.log_path = path
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

    def current_compile_window(self) -> Optional[CompileWindow]:
        s = getattr(self._tls, "win", None)
        return s[-1] if s else None

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
        # an enabled-without-log run (bench mode) cannot leak per-step
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
        self.last_by_kind[ev.get("ev", "?")] = ev
        if self._log_f is None and len(self._pending) > _PENDING_CAP:
            del self._pending[: _PENDING_CAP // 2]

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs or None)

    def span_event(self, name: str, start_perf: float, dur: float,
                   **attrs) -> None:
        """Record a span from explicit perf_counter timings — for call
        sites that must time regardless of telemetry (the train loop's
        probes) or that only know post hoc whether the interval counts."""
        if not self.enabled:
            return
        self._record_span(name, start_perf, dur, len(self._stack()),
                          attrs or None)

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
            agg = self.span_agg.get(name)
            if agg is None:
                agg = self.span_agg[name] = [0, 0.0, 0.0]
                self.span_durs[name] = deque(maxlen=_DUR_CAP)
            agg[0] += 1
            agg[1] += dur
            if dur > agg[2]:
                agg[2] = dur
            self.span_durs[name].append(dur)
            # every span feeds the mergeable fixed-bucket histogram of its
            # name — the /metrics latency series and the shard-merge feed
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
        """Register a histogram series with zero observations, so
        /metrics exports its (empty) bucket series from scrape one and
        /statusz shows it as "n/a" — a dashboard watching serve_ttft
        must see the series exist BEFORE the first request, not appear
        mid-run."""
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
        bench / library mode — summary() and chrome_trace() read them
        there)."""
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
        """The last ~_RING_CAP events regardless of sink — the /trace
        endpoint's snapshot source."""
        with self._lock:
            return list(self._recent)

    def last_event(self, kind: str) -> Optional[dict]:
        """Most recent event of the given ``ev`` kind (e.g. "ckpt_save"
        for /statusz's checkpoint-age line)."""
        with self._lock:
            return self.last_by_kind.get(kind)

    def metrics_snapshot(self) -> dict:
        """One consistent point-in-time copy of everything /metrics
        serves: counters, gauges, raw histogram buckets, compile totals,
        uptime — taken under the lock so a scrape mid-step never sees a
        half-updated histogram."""
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

    def summary(self) -> dict:
        """Aggregate view: per-span totals, counters, gauges, compiles,
        and p50/p90/p99 duration percentiles per span name."""
        with self._lock:
            spans = {}
            for name, (n, total, mx) in self.span_agg.items():
                durs = sorted(self.span_durs[name])
                spans[name] = {
                    "count": n, "total_s": round(total, 6),
                    "mean_ms": round(1e3 * total / n, 4),
                    "max_ms": round(1e3 * mx, 4),
                    "p50_ms": round(1e3 * percentile(durs, 50), 4),
                    "p90_ms": round(1e3 * percentile(durs, 90), 4),
                    "p99_ms": round(1e3 * percentile(durs, 99), 4),
                }
            return {
                "spans": spans,
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "hists": {name: h.stats()
                          for name, h in self.hists.items()},
                "compiles": {
                    "count": len(self.compiles),
                    "total_s": round(sum(c["dur"] for c in self.compiles),
                                     6),
                    "by_cause": count_by(self.compiles, "cause"),
                    "by_name": count_by(self.compiles, "name"),
                },
            }

    def brief_summary(self, top: int = 8,
                      summary: Optional[dict] = None) -> dict:
        """Compact per-phase breakdown for embedding in one-line JSON
        (the bench.py contract): top spans by total time + compile cost.
        Pass a precomputed ``summary()`` to avoid re-sorting every span's
        duration history."""
        s = summary if summary is not None else self.summary()
        ranked = sorted(s["spans"].items(),
                        key=lambda kv: -kv[1]["total_s"])[:top]
        out = {"spans": {name: {"count": a["count"],
                                "total_s": a["total_s"],
                                "p50_ms": a["p50_ms"],
                                "p90_ms": a["p90_ms"],
                                "p99_ms": a["p99_ms"]}
                         for name, a in ranked},
               "compiles": s["compiles"]["count"],
               "compile_s": s["compiles"]["total_s"]}
        if s["counters"]:
            out["counters"] = s["counters"]
        return out

    def finish(self, close: bool = False) -> Optional[dict]:
        """Record the end-of-run summary event, flush the log, and (with a
        log path) write the Chrome-trace export next to it. Returns the
        summary dict (None if disabled)."""
        if not self.enabled:
            return None
        s = self.summary()
        if self.log_path:
            self.flush()   # drain events + counters snapshot first, so
            #                the summary below stays the log's last line
        self.record({"ev": "summary", "summary": s,
                     "ts": round(self._ts(time.perf_counter()), 6)})
        if self.log_path:
            self.flush()
            try:
                self.write_chrome_trace(self.log_path + ".trace.json")
            except Exception:
                pass
        if close:
            self.disable()
        return s

    # -- chrome trace ----------------------------------------------------
    def _all_events(self) -> List[dict]:
        """Everything recorded so far: the log file's lines (events already
        flushed) plus the in-memory pending buffer."""
        evs: List[dict] = []
        if self.log_path and os.path.exists(self.log_path):
            if self._log_f is not None:
                self.flush()
            with open(self.log_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        evs.append(json.loads(line))
            return evs
        return self.events()

    def chrome_trace(self) -> dict:
        return events_to_chrome(self._all_events())

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


def percentile(sorted_vals: list, p: float) -> float:
    """Nearest-rank percentile of an ascending-sorted list (shared with
    tools/telemetry_report.py so live and offline numbers agree)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round((p / 100.0)
                                            * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def count_by(evs: List[dict], key: str) -> Dict[str, int]:
    """Histogram of ``ev[key]`` over a list of event dicts."""
    out: Dict[str, int] = {}
    for e in evs:
        k = e.get(key, "?")
        out[k] = out.get(k, 0) + 1
    return out



def events_to_chrome(evs: List[dict]) -> dict:
    """Build a chrome://tracing / Perfetto 'traceEvents' JSON object from a
    list of telemetry events (live or re-read from a JSONL log). Spans and
    compiles become complete ('X') events; gauges become counter ('C')
    tracks. Timestamps are microseconds relative to run start."""
    trace = []
    tids = {}

    def tid_of(ev):
        t = ev.get("tid", 0)
        if t not in tids:
            tids[t] = len(tids)
            trace.append({"ph": "M", "name": "thread_name", "pid": 0,
                          "tid": tids[t],
                          "args": {"name": "thread-%d" % tids[t]}})
        return tids[t]

    for ev in evs:
        kind = ev.get("ev")
        if kind == "span":
            trace.append({
                "ph": "X", "name": ev["name"], "pid": 0,
                "tid": tid_of(ev),
                "ts": round(ev["ts"] * 1e6, 1),
                "dur": round(ev["dur"] * 1e6, 1),
            })
        elif kind == "compile":
            trace.append({
                "ph": "X", "name": "compile:" + ev["name"], "pid": 0,
                "tid": tid_of(ev),
                "ts": round(max(ev.get("ts", 0.0), 0.0) * 1e6, 1),
                "dur": round(ev["dur"] * 1e6, 1),
                "args": {"cause": ev.get("cause", "?")},
            })
        elif kind == "gauge":
            trace.append({
                "ph": "C", "name": ev["name"], "pid": 0,
                "ts": round(ev["ts"] * 1e6, 1),
                "args": {"value": ev.get("value", 0)},
            })
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


# the canonical request-phase order (doc/observability.md glossary):
# queue_wait (accept -> worker pop), dispatch (pop -> backend call),
# prefill (backend call -> first token: TTFT's server-side share),
# decode (first token -> last token). The phases TILE the request's
# wall-clock — their sum is the request's total by construction.
REQUEST_PHASES = ("queue_wait", "dispatch", "prefill", "decode")


class FlightRecorder:
    """Bounded ring of the last N completed request traces — the
    per-request black box the serving frontend fills and statusd serves
    (``/trace?request=<id>`` as a Chrome trace, ``/requestz`` as a
    list). A record is one plain dict::

        {"id": "17", "outcome": "served", "tokens_in": 8, "tokens_out":
         16, "t_wall": <arrival unix time>, "total_s": 0.213,
         "ttft_s": 0.041, "tokens_per_s": 93.1,
         "phases": {"queue_wait": .., "dispatch": .., "prefill": ..,
                    "decode": ..},
         "recompiles": [{"name": "kernel:flash_fwd", "cause":
                         "first_use", "dur": 1.2}, ...],
         "counts": {<per-request counter deltas>}}

    Bounded and lock-guarded; eviction is oldest-first (deque maxlen).
    Jax-free and registry-independent, so it works with telemetry
    disabled — a flight record must survive a run that configured no
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
            # local dense id) shadows the older record here; that is
            # the documented contract (doc/serving.md: choose unique
            # trace ids), not a lookup guarantee
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


def _tensor_signature(args, kwargs) -> tuple:
    """The (shape, dtype) of every tensor among a call's own arguments, in
    argument order (keyword arguments in key order): what a program's
    first call at a new signature is told apart by. Containers are not
    walked: they hold a program's fixed state (parameters, nets, caches),
    whose shapes its key already fixes. Python scalars and None are left
    out, as positions and seeds change every call."""
    out = []
    for o in args if not kwargs else \
            list(args) + [kwargs[k] for k in sorted(kwargs)]:
        shape = getattr(o, "shape", None)
        if shape is not None:
            dtype = getattr(o, "dtype", None)
            if dtype is not None:
                out.append((tuple(shape), dtype))
    return tuple(out)


class JitWatch:
    """Recompile detector (the JAX package's ``JitWatch``,
    cxxnet_tpu/utils/telemetry.py:1025-1082): wraps one of the trainer's
    programs and records a compile event whenever the program is called
    at a signature it has not run before — its first call (``cause``, what
    the call site knows: new_signature, rebuild_after_clear,
    decode_cache_drop), and later first calls at new tensor shapes
    ("shape_change"). The signature of every call is kept, instrumented or
    not, so that a first call is told apart whoever watches: it costs a
    set lookup over the call's few tensor arguments, as JAX's cache-size
    check costs a read.

    The compile's seconds are the first call's wall time; ``probe`` (a
    ``perf.DeviceProbe``), when given, brackets that first call only: it
    waits for the card once at its end and, with a compile hook set, reads
    the allocator's figures, which the hook receives as ``mem``. Warm calls
    pass straight through and are never waited on."""

    __slots__ = ("_fn", "_name", "_cause_next", "_reg", "_key", "_seen",
                 "_probe")

    def __init__(self, fn, name: str, cause: str = "new_signature",
                 registry: Optional[_Registry] = None, key=None,
                 probe=None):
        self._fn = fn
        self._name = name
        self._cause_next = cause
        self._reg = registry or _REG
        # the caller's program key (the trainer's program-cache key): rides
        # the compile event and the perf ledger's ProgramCard
        self._key = key
        self._seen: set = set()
        self._probe = probe

    def __call__(self, *args, **kwargs):
        sig = _tensor_signature(args, kwargs)
        if sig in self._seen:
            return self._fn(*args, **kwargs)
        self._seen.add(sig)
        reg = self._reg
        if not reg.enabled and reg.current_trace() is None \
                and reg.current_compile_window() is None \
                and reg.compile_hook is None:
            # an active trace context or compile window wants its
            # compiles attributed (the flight recorder works with
            # telemetry disabled too), and the perf ledger wants its
            # cards either way
            return self._fn(*args, **kwargs)
        probe = self._probe
        hooked = reg.compile_hook is not None
        mem = None
        t0 = time.perf_counter()
        tok = probe.begin() if probe is not None and hooked else None
        out = self._fn(*args, **kwargs)
        if probe is not None:
            # the first call's one wait for the device; the allocator's
            # figures only where the ledger takes them
            if hooked:
                mem = probe.end(tok, args, kwargs, out)
            else:
                probe.sync()
        dt = time.perf_counter() - t0
        reg.record_compile(self._name, self._cause_next, dt, key=self._key)
        hook = reg.compile_hook
        if hook is not None:
            # the perf ledger (utils/perf.py): hand it the program and
            # the triggering call so it can card it. Supervised — a
            # ledger bug must not kill the step that compiled
            try:
                hook(self._name, self._cause_next, dt, fn=self._fn,
                     args=args, kwargs=kwargs, key=self._key, mem=mem)
            except Exception:
                pass
        self._cause_next = "shape_change"
        return out

    def __getattr__(self, name):
        # forward the program's own attributes (its cost account)
        return getattr(self._fn, name)


class BooksAuditor:
    """Conservation-law registry: named invariants over the serving
    books — "accepted = served + shed + errors + deadline + abandoned",
    "blocks total = free + live + retained", "tenant charges sum to the
    door books", "fleet sums = Σ replica feeds" — checked on a daemon
    sweep and at every /metrics scrape, so every number the request
    autopsy and the bench rows cite is provably reconciled.

    A law is a callable ``fn() -> Optional[str]``: ``None`` means the
    books reconcile (or the law could not take a consistent snapshot —
    inconclusive PASSES; a law must never false-latch off a racy read:
    use a stable-snapshot double-read and return None when the bracket
    moved), a string is the violation detail. The first violation
    LATCHES the law sticky-broken (``cxxnet_books_broken{law=...}``
    stays 1 until ``reset()``), emits exactly one ``books_broken``
    transition event (``broken: 1`` carrying the detail; ``reset()``
    emits the matching ``broken: 0`` clear), and bumps the
    ``books.violations`` counter — a single bad snapshot can never flap
    the gauge, and telemetry_report's exit-2 gate sees the latch even
    if every later sweep reconciles.

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
        self._thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()

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
        """Point-in-time view for /metrics and bench rows."""
        with self._lock:
            return {"laws": sorted(self._laws),
                    "broken": dict(self._broken),
                    "violations": self.violations,
                    "sweeps": self.sweeps,
                    "law_errors": self.law_errors}

    def reset(self) -> None:
        """Clear every latch, emitting the ``broken: 0`` transition for
        each — the operator's acknowledge. ``violations`` stays
        cumulative (the bench-row feed)."""
        with self._lock:
            cleared = sorted(self._broken)
            self._broken.clear()
        reg = self._reg()
        for name in cleared:
            reg.record({"ev": "books_broken", "law": name, "broken": 0})

    def start(self, period_s: float = 1.0) -> None:
        """Start the daemon sweep loop (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop_ev.clear()
            t = threading.Thread(target=self._run,
                                 args=(max(0.05, float(period_s)),),
                                 name="books-auditor", daemon=True)
            self._thread = t
        t.start()

    def _run(self, period_s: float) -> None:
        while not self._stop_ev.wait(period_s):
            try:
                self.sweep()
            except Exception:
                pass

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            self._stop_ev.set()
            t.join(timeout=2.0)


# ----------------------------------------------------------------------
# module-level singleton surface
_REG = _Registry()


def enable(log_path: Optional[str] = None,
           process_index: Optional[int] = None) -> None:
    _REG.enable(log_path, process_index=process_index)


def disable() -> None:
    _REG.disable()


def enabled() -> bool:
    return _REG.enabled


def reset() -> None:
    _REG.reset()


def span(name: str, **attrs):
    return _REG.span(name, **attrs)


def span_event(name: str, start_perf: float, dur: float, **attrs) -> None:
    _REG.span_event(name, start_perf, dur, **attrs)


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


def current_compile_window() -> Optional[CompileWindow]:
    return _REG.current_compile_window()


def mark(name: str) -> None:
    _REG.mark(name)


def event(ev: dict) -> None:
    _REG.record(ev)


def record_compile(name: str, cause: str, seconds: float, key=None) -> None:
    _REG.record_compile(name, cause, seconds, key)


def jit_watch(fn, name: str, cause: str = "new_signature",
              key=None, probe=None) -> JitWatch:
    return JitWatch(fn, name, cause=cause, key=key, probe=probe)


def flush() -> None:
    _REG.flush()


def finish(close: bool = False) -> Optional[dict]:
    return _REG.finish(close=close)


def summary() -> dict:
    return _REG.summary()


def brief_summary(top: int = 8, summary: Optional[dict] = None) -> dict:
    return _REG.brief_summary(top=top, summary=summary)


def events() -> List[dict]:
    return _REG.events()


def recent_events() -> List[dict]:
    return _REG.recent_events()


def wall_epoch() -> float:
    """The registry's wall-clock epoch: event ``ts`` seconds are
    relative to this, so cross-process alignment (the /eventz incident
    merge, --merge shard re-basing) is ``t0_wall + ts``."""
    return _REG.t0_wall


def last_event(kind: str) -> Optional[dict]:
    return _REG.last_event(kind)


def chrome_trace() -> dict:
    return _REG.chrome_trace()


def write_chrome_trace(path: str) -> str:
    return _REG.write_chrome_trace(path)


# the process-wide conservation-law auditor: subsystems register laws
# at start() (servd's door books, kvblocks' block conservation, routerd's
# federation sums) and unregister them at drain(); statusd sweeps at
# every scrape and exports the latches as cxxnet_books_broken{law=...}
_AUDITOR = BooksAuditor()


def auditor() -> BooksAuditor:
    return _AUDITOR


def audit_register(name: str, fn) -> None:
    _AUDITOR.register(name, fn)


def audit_unregister(name: str) -> None:
    _AUDITOR.unregister(name)


def audit_sweep() -> Dict[str, Optional[str]]:
    return _AUDITOR.sweep()


def sample_device_memory(stats: Optional[dict] = None) -> Optional[dict]:
    """Record a device's allocator figures as gauges (``device.`` + each
    key: ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``, as
    ``device.memory_stats`` reads them on a card) and return them; None
    with telemetry off or without figures (the CPU)."""
    if not _REG.enabled or not stats:
        return None
    for k, v in stats.items():
        gauge("device." + k, int(v))
    return stats
