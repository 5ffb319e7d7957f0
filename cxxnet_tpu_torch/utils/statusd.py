"""Live introspection service of the port: /metrics, /healthz, /statusz,
/trace and the serving pages — the port's copy of cxxnet_tpu/utils/statusd.py
(it imports nothing of ``cxxnet_tpu``): a standard-library ``http.server``
on a daemon thread, started by the conf key ``status_port=<p>`` (port 0 =
ephemeral, printed at startup) for every task, and by ``python -m
cxxnet_tpu_torch.utils.servd --stub --status-port <p>``.

Endpoints (``ENDPOINTS``):

* ``/metrics`` — Prometheus text format: every telemetry counter as a
  ``_total`` series, gauges, the fixed-bucket histograms
  (``telemetry.HIST_BUCKETS``) as ``_seconds_bucket{le=...}`` series, the
  run's progress (``cxxnet_progress_round``, ``_batch``), readiness and
  liveness, the SLO account, the decode batch account and the
  conservation-law latches; every series carries a ``process`` label.
  ``?json=1`` returns the raw registry snapshot with the SLO window and
  the batch account.
* ``/healthz`` — READINESS: 200 while the process should receive traffic,
  503 while a heartbeat channel is overdue (``health.channel_status``) or
  any registered probe fails (the serving frontend's draining or
  breaker-open state).
* ``/livez`` — LIVENESS: 503 only for an overdue heartbeat or a probe
  registered with ``liveness=True`` (a dead serve worker). A draining
  server is not ready but is alive.
* ``/`` and ``/statusz`` — the human page: run config, progress, health,
  SLO, requests, batching, the last checkpoint, latency histograms,
  counters and gauges.
* ``/trace`` — a Chrome trace of the recent-event ring; with
  ``?request=<id>`` one request's phase-attributed trace from the flight
  recorder (with its batch's slot-Gantt lanes on a batching replica).
* ``/requestz`` — the flight recorder, newest first (HTML, ``?json=1``,
  ``?n=<k>``, ``?request=<id>`` for one raw record).
* ``/batchz`` — the decode batch scheduler: KV account, buckets and the
  iteration flight ring (HTML, ``?json=1``, ``?n=<k>``).
* ``/why?request=<id>`` — one request's slowdown autopsy
  (``autopsy.classify_record``).
* ``/eventz`` — the incident timeline (``autopsy.incidents``).

* ``/programz`` — the program performance ledger (``utils/perf.py``): the
  HBM account and one row per carded program (flops, peak bytes, the
  roofline prediction, measured p50/p99, MFU%, roofline efficiency);
  ``?json=1``, ``?n=<k>``. 404 naming the wiring without a ledger.
* ``/compilez`` — the compile flight recorder: the warm-grid readiness
  account and the recent compiles with their trigger (``?json=1``,
  ``?n=<k>``).
* ``/profilez?secs=N`` — start an on-demand ``torch.profiler`` capture of
  the next N seconds into the run-scoped ``profilez_dir`` (409 while one
  runs).

* ``/fleetz`` — the serving fleet's routing table (``utils/routerd.py``,
  registered by ``task = route`` through ``set_fleet``): one row per
  replica (state, load gauges, warm fraction, ejection backoff), the
  router's counters and the rolling-reload drain windows; ``?json=1``,
  ``?n=<k>``. ``/metrics`` exports the same account as the
  ``cxxnet_fleet_*`` series. On a router process ``/trace?request=<id>``
  returns the stitched cross-process trace (the router's attempt lane and
  each touched replica's phase lanes), ``/why`` the stitched autopsy, and
  ``/eventz`` the timeline merged over the replicas' own.

Serving SLOs: an ``SLOTracker`` (objectives ``slo_ttft_ms`` /
``slo_p99_ms`` / ``slo_availability`` over a rolling window) turns each
completed request into an error-budget account; its burn rate is
exported as ``cxxnet_slo_burn_rate`` with the alert gauge
``cxxnet_slo_burn``.

The server binds in its constructor (so ``status_port=0`` resolves to a
real port before the run starts), serves each request on its own thread,
and reads snapshot copies of the telemetry state, so a scrape never holds
up the train loop beyond one lock acquisition. It binds loopback unless
``status_host`` widens it (the pages are unauthenticated). The
module-level calls (``update_progress``, ``register_probe``, ``set_*``)
are no-ops while no server runs. Standard library only; ``python -m
cxxnet_tpu_torch.utils.statusd --selftest`` serves, scrapes and checks.
"""

from __future__ import annotations

import html
import json
import re
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from . import autopsy
from . import health as health_mod
from . import lockrank
from . import telemetry

__all__ = [
    "StatusServer", "SLOTracker", "start", "stop", "active",
    "set_run_info", "update_progress", "register_probe", "wire_health",
    "set_flight_recorder", "set_slo", "set_slo_tenants", "set_perf",
    "set_profiler", "set_batch",
    "set_fleet", "set_auditor",
    "prometheus_metrics", "programz_html", "compilez_html",
    "fleetz_html", "requestz_html", "batchz_html", "why_html",
    "eventz_html", "ENDPOINTS", "PROM_LINE_RE", "selftest",
]

# Every endpoint the handler serves, with its query contract: (path,
# takes ?json=1, takes ?n=<k>). The 404 page derives from this table.
ENDPOINTS: Tuple[Tuple[str, bool, bool], ...] = (
    ("/metrics", True, False),
    ("/healthz", False, False),
    ("/livez", False, False),
    ("/statusz", False, False),
    ("/trace", False, False),
    ("/requestz", True, True),
    ("/batchz", True, True),
    ("/programz", True, True),
    ("/compilez", True, True),
    ("/profilez", False, False),
    ("/fleetz", True, True),
    ("/why", True, False),
    ("/eventz", True, True),
)

_NAME_SAN = re.compile(r"[^a-zA-Z0-9_]")

# one exposition line: metric name, optional {label="value",...}, value.
# Shared with tests — the validity contract /metrics promises scrapers.
PROM_LINE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*")*\})?'
    r' (?:[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|\+Inf|-Inf|NaN)$')


def _mname(name: str) -> str:
    """Telemetry name -> Prometheus metric name (``train.step`` ->
    ``cxxnet_train_step``)."""
    n = _NAME_SAN.sub("_", str(name))
    if n and n[0].isdigit():
        n = "_" + n
    return "cxxnet_" + n


def _lesc(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


# the shared empty-series-sentinel renderer (None -> "n/a")
_ms = telemetry.fmt_ms


class SLOTracker:
    """Rolling-window serving SLO / error-budget tracker.

    Objectives (0 disables a latency objective):

    * ``ttft_ms`` — a request whose time-to-first-token (accept ->
      first token) exceeds this is an SLO violation;
    * ``p99_ms`` — same for end-to-end latency;
    * ``availability`` — the SLO target fraction of GOOD requests
      (default 0.999). Its complement is the **error budget**: the
      fraction of requests allowed to be bad while still meeting SLO.

    Every completed request is ``observe()``d: a request that errored
    (``ok=False``) or blew any latency objective is *bad*. Over the
    rolling ``window_s`` the tracker computes ``bad_fraction`` and the
    **burn rate** = bad_fraction / (1 - availability) — the classic
    error-budget form: 1x means bad requests arrive exactly as fast as
    the budget allows; 10x means the month's budget is gone in 3 days.
    The ``alert`` flag (exported as the ``cxxnet_slo_burn`` gauge, and
    as ``slo_burn`` transition events in the telemetry stream) flips to
    1 while burn_rate >= 1 with at least ``min_requests`` in the window
    — the floor keeps one unlucky request over an empty window from
    paging.

    Thread-safe and jax-free; the serving frontend calls ``observe``
    from its worker thread, /metrics and /statusz read ``snapshot()``.
    """

    def __init__(self, ttft_ms: float = 0.0, p99_ms: float = 0.0,
                 availability: float = 0.999, window_s: float = 300.0,
                 min_requests: int = 10, min_bad: int = 3,
                 clock=time.monotonic):
        self.ttft_ms = float(ttft_ms)
        self.p99_ms = float(p99_ms)
        self.availability = float(availability)
        # availability=1 would make every bad request an instant page
        # AND divide by zero: floor the budget at one-in-a-million
        self.budget = max(1.0 - self.availability, 1e-6)
        self.window_s = float(window_s)
        self.min_requests = max(1, int(min_requests))
        # with a tight budget (0.999 -> 0.1%) ONE error among 10
        # requests already reads as 100x burn: require a minimum count
        # of bad requests before paging, so a single recovered hiccup
        # in a busy window can't flip the gauge (and fail the report's
        # exit-2 gate) — the breaker analog needs 5 consecutive fails
        self.min_bad = max(1, int(min_bad))
        self._clock = clock
        # ranked: _update emits telemetry under this lock (deliberate —
        # transition ordering), so statusd.slo < telemetry.registry
        self._lock = lockrank.lock("statusd.slo")
        self._win: deque = deque()     # (t, violation reason or None)
        # incremental violation counts — observe()/scrape run on the
        # serving accept/worker threads under the lock, so the window
        # (QPS x window_s entries under sustained load) must never be
        # rescanned per request: append/evict keep these current
        self._by_reason: Dict[str, int] = {}
        self.alert = 0
        self.flips = 0

    def observe(self, ok: bool = True, ttft_s: Optional[float] = None,
                latency_s: Optional[float] = None) -> dict:
        """Account one completed request; returns the fresh snapshot."""
        reason = None
        if not ok:
            reason = "error"
        elif (self.ttft_ms > 0 and ttft_s is not None
                and ttft_s * 1e3 > self.ttft_ms):
            reason = "ttft"
        elif (self.p99_ms > 0 and latency_s is not None
                and latency_s * 1e3 > self.p99_ms):
            reason = "latency"
        with self._lock:
            self._win.append((self._clock(), reason))
            if reason is not None:
                self._by_reason[reason] = \
                    self._by_reason.get(reason, 0) + 1
        return self._update()

    def snapshot(self) -> dict:
        """The current window's accounting (evicts aged-out requests
        first, so a scrape long after the last request reads the live
        truth, not a stale burn)."""
        return self._update()

    def _update(self) -> dict:
        now = self._clock()
        with self._lock:
            while self._win and self._win[0][0] < now - self.window_s:
                _, evicted = self._win.popleft()
                if evicted is not None:
                    left = self._by_reason[evicted] - 1
                    if left:
                        self._by_reason[evicted] = left
                    else:
                        del self._by_reason[evicted]
            n = len(self._win)
            by_reason = dict(self._by_reason)
            bad = sum(by_reason.values())
            bad_fraction = bad / float(n) if n else 0.0
            burn_rate = bad_fraction / self.budget
            if n >= self.min_requests:
                alert = 1 if (burn_rate >= 1.0
                              and bad >= self.min_bad) else 0
            else:
                # too few requests in the window to judge either way:
                # HOLD the previous state. Clearing here would let a
                # zero-traffic scrape age the flood out of the window
                # and log a state-0 transition with no recovery
                # evidence — the report's end-of-log exit-2 gate would
                # then depend on scrape timing (the breaker analog:
                # open until a successful probe, not until silence)
                alert = self.alert
            flipped = alert != self.alert
            self.alert = alert
            if flipped:
                self.flips += 1
                # transition events, not per-request spam: the telemetry
                # log's last slo_burn state is the report's exit-2 gate,
                # so emit under the lock — two racing flips must land in
                # the log in the order the state machine took them
                telemetry.count("slo.burn_flips")
                telemetry.event({"ev": "slo_burn", "state": alert,
                                 "burn_rate": round(burn_rate, 4),
                                 "bad": bad, "window": n})
        return {"objectives": {"ttft_ms": self.ttft_ms,
                               "p99_ms": self.p99_ms,
                               "availability": self.availability},
                "window_s": self.window_s, "requests": n, "bad": bad,
                "by_reason": by_reason,
                "bad_fraction": round(bad_fraction, 6),
                "budget": round(self.budget, 6),
                # the alert floors ride the snapshot so the fleet
                # federation (routerd) can apply them FLEET-wide to
                # the merged window — the each-replica-just-under
                # case is exactly what the fleet account exists for
                "min_requests": self.min_requests,
                "min_bad": self.min_bad,
                "burn_rate": round(burn_rate, 4), "alert": alert}


def prometheus_metrics(snapshot: dict, progress: Optional[dict] = None,
                       health_failures: Optional[list] = None,
                       channels: Optional[list] = None,
                       live_failures: Optional[list] = None,
                       slo: Optional[dict] = None,
                       slo_tenants: Optional[dict] = None,
                       perf: Optional[dict] = None,
                       batch: Optional[dict] = None,
                       fleet: Optional[dict] = None,
                       books: Optional[dict] = None) -> str:
    """Render a ``telemetry.metrics_snapshot()`` as Prometheus text
    exposition format 0.0.4. Pure function of its inputs — the selftest
    and tests validate its output without a socket. ``channels`` is the
    heartbeat snapshot the caller derived ``health_failures`` from, so
    one scrape can never contradict itself (healthy gauge vs overdue
    heartbeat ages from two different instants)."""
    p = str(snapshot.get("process", 0))
    base = '{process="%s"}' % _lesc(p)
    out: List[str] = []

    def emit(name, mtype, value, labels=base, help_=None):
        if help_:
            out.append("# HELP %s %s" % (name, help_))
        out.append("# TYPE %s %s" % (name, mtype))
        out.append("%s%s %s" % (name, labels, _fmt(value)))

    def _fmt(v):
        if isinstance(v, float):
            if v != v:
                return "NaN"
            if v == float("inf"):
                return "+Inf"
            if v == float("-inf"):
                return "-Inf"
            return repr(v)
        return str(v)

    def emit_hist(mname, h):
        """One fixed-bucket histogram family (cumulative ``le`` rows)
        from a sparse ``Histogram.to_dict`` snapshot — shared by the
        registry's own series and the fleet-federated ones."""
        out.append("# TYPE %s histogram" % mname)
        counts = {int(i): int(c) for i, c in
                  (h.get("buckets") or {}).items()}
        cum = 0
        for i, le in enumerate(telemetry.HIST_BUCKETS):
            cum += counts.get(i, 0)
            out.append('%s_bucket{process="%s",le="%g"} %d'
                       % (mname, _lesc(p), le, cum))
        total = int(h.get("count", 0))
        out.append('%s_bucket{process="%s",le="+Inf"} %d'
                   % (mname, _lesc(p), total))
        out.append('%s_sum%s %s' % (mname, base,
                                    _fmt(float(h.get("sum", 0.0)))))
        out.append('%s_count%s %d' % (mname, base, total))

    emit("cxxnet_up", "gauge", 1,
         help_="1 while the introspection service is serving")
    emit("cxxnet_uptime_seconds", "gauge",
         round(float(snapshot.get("uptime_s", 0.0)), 3))
    emit("cxxnet_compiles_total", "counter", int(snapshot.get("compiles", 0)),
         help_="jit recompiles detected since run start")
    emit("cxxnet_compile_seconds_total", "counter",
         float(snapshot.get("compile_s", 0.0)))
    if health_failures is not None:
        emit("cxxnet_healthy", "gauge", 0 if health_failures else 1,
             help_="1 when /healthz (readiness) returns 200")
    if live_failures is not None:
        emit("cxxnet_live", "gauge", 0 if live_failures else 1,
             help_="1 when /livez (liveness) returns 200")
    if slo is not None:
        # the serving SLO account (SLOTracker.snapshot()): the alert
        # gauge first — cxxnet_slo_burn is the series alert rules watch
        emit("cxxnet_slo_burn", "gauge", int(slo.get("alert", 0)),
             help_="1 while the rolling-window error-budget burn rate "
                   "is >= 1x (SLO burning)")
        emit("cxxnet_slo_burn_rate", "gauge",
             float(slo.get("burn_rate", 0.0)),
             help_="bad_fraction / (1 - slo_availability) over the "
                   "rolling window")
        emit("cxxnet_slo_bad_fraction", "gauge",
             float(slo.get("bad_fraction", 0.0)))
        emit("cxxnet_slo_window_requests", "gauge",
             int(slo.get("requests", 0)))
    if slo_tenants:
        # per-tenant SLO floors (one SLOTracker per configured tenant):
        # labeled rows, so a noisy tenant's burn is visible NEXT TO the
        # victim's holding at 0 — the multi-tenant QoS acceptance
        fams = (("cxxnet_slo_tenant_burn",
                 lambda s: int(s.get("alert", 0)),
                 "1 while this tenant's own error budget burns >= 1x"),
                ("cxxnet_slo_tenant_burn_rate",
                 lambda s: float(s.get("burn_rate", 0.0)), None),
                ("cxxnet_slo_tenant_window_requests",
                 lambda s: int(s.get("requests", 0)), None))
        for mname, get, help_ in fams:
            if help_:
                out.append("# HELP %s %s" % (mname, help_))
            out.append("# TYPE %s gauge" % mname)
            for t in sorted(slo_tenants):
                out.append('%s{process="%s",tenant="%s"} %s'
                           % (mname, _lesc(p), _lesc(t),
                              _fmt(get(slo_tenants[t]))))
    if perf is not None:
        # the program performance ledger (perf.Ledger.snapshot()):
        # aggregates as plain gauges, per-program figures as labeled
        # families (one TYPE line per family, one row per card — the
        # heartbeat-channel pattern)
        hbm = perf.get("hbm") or {}
        if hbm.get("peak_bytes") is not None:
            emit("cxxnet_hbm_peak_bytes", "gauge", int(hbm["peak_bytes"]),
                 help_="largest per-device program footprint "
                       "(arguments+temp+output) the ledger has carded")
        if hbm.get("headroom_bytes") is not None:
            emit("cxxnet_hbm_headroom_bytes", "gauge",
                 int(hbm["headroom_bytes"]),
                 help_="device HBM capacity minus the peak program "
                       "footprint minus the live decode KV cache")
        if hbm.get("decode_kv_bytes") is not None:
            emit("cxxnet_hbm_decode_kv_bytes", "gauge",
                 int(hbm["decode_kv_bytes"]),
                 help_="live decode KV-cache bytes charged against "
                       "HBM headroom (persistent between programs)")
        if hbm.get("capacity_bytes") is not None:
            emit("cxxnet_hbm_capacity_bytes", "gauge",
                 int(hbm["capacity_bytes"]))
        cards = perf.get("cards") or []
        emit("cxxnet_program_cards", "gauge", len(cards),
             help_="compiled programs the performance ledger has carded")
        fams = (("cxxnet_program_flops", "flops",
                 "XLA cost_analysis FLOPs per execution"),
                ("cxxnet_program_bytes_accessed", "bytes_accessed", None),
                ("cxxnet_program_peak_bytes", "peak_bytes",
                 "per-device argument+temp+output bytes"),
                ("cxxnet_program_predicted_seconds", "predicted_s",
                 "roofline-predicted execution time"),
                ("cxxnet_program_compile_seconds", "compile_s", None),
                ("cxxnet_program_mfu_pct", "mfu_pct",
                 "achieved FLOPs vs chip peak at the measured p50"),
                ("cxxnet_program_roofline_eff_pct", "roofline_eff_pct",
                 "predicted/measured p50 — low means slower than the "
                 "hardware allows"))
        for mname, field, help_ in fams:
            rows = [c for c in cards if _num(c.get(field))]
            if not rows:
                continue
            if help_:
                out.append("# HELP %s %s" % (mname, help_))
            out.append("# TYPE %s gauge" % mname)
            for c in rows:
                out.append(
                    '%s{process="%s",program="%s",shapes="%s"} %s'
                    % (mname, _lesc(p), _lesc(c.get("name", "?")),
                       _lesc(c.get("sig", "?")), _fmt(c[field])))
        rd = perf.get("readiness") or {}
        if rd.get("ready_pct") is not None:
            # warm-grid readiness: absent entirely when no expected
            # program grid was registered (serve-only wiring) — the
            # absence-is-capability-signal convention
            emit("cxxnet_ready_programs_pct", "gauge", rd["ready_pct"],
                 help_="compiled fraction of the expected serving "
                       "program grid; below 100 the replica is still "
                       "paying compile cliffs on first hits")
            emit("cxxnet_expected_programs", "gauge",
                 int(rd.get("expected", 0)))
            emit("cxxnet_warm_programs", "gauge", int(rd.get("warm", 0)))
            bks = rd.get("buckets") or {}
            if bks:
                out.append("# TYPE cxxnet_ready_programs_bucket_pct "
                           "gauge")
                for b in sorted(bks):
                    out.append(
                        'cxxnet_ready_programs_bucket_pct{process="%s"'
                        ',bucket="%s"} %s'
                        % (_lesc(p), _lesc(str(b)),
                           _fmt(bks[b].get("ready_pct", 0.0))))
    if batch is not None:
        # the decode-datapath observability account
        # (servd.ServeFrontend.batch_snapshot()): the live KV/HBM
        # occupancy series paged KV (ROADMAP item 2) will be judged
        # against, per-bucket as labeled rows, plus the convoy latch
        out.append("# HELP cxxnet_decode_kv_bytes allocated decode "
                   "KV-cache bytes per warm session bucket")
        out.append("# TYPE cxxnet_decode_kv_bytes gauge")
        for b, bs in sorted((batch.get("buckets") or {}).items(),
                            key=lambda kv: int(kv[0])):
            out.append('cxxnet_decode_kv_bytes{process="%s",'
                       'bucket="%s"} %d'
                       % (_lesc(p), _lesc(str(b)),
                          int(bs.get("kv_bytes", 0))))
        out.append("# TYPE cxxnet_decode_kv_live_bytes gauge")
        for b, bs in sorted((batch.get("buckets") or {}).items(),
                            key=lambda kv: int(kv[0])):
            out.append('cxxnet_decode_kv_live_bytes{process="%s",'
                       'bucket="%s"} %d'
                       % (_lesc(p), _lesc(str(b)),
                          int(bs.get("kv_live_bytes", 0))))
        if _num(batch.get("kv_live_pct")):
            emit("cxxnet_decode_kv_live_pct", "gauge",
                 batch["kv_live_pct"],
                 help_="live-vs-allocated decode cache utilization — "
                       "the padding+dead-slot waste paged KV reclaims")
        if _num(batch.get("slot_waste_pct")):
            emit("cxxnet_decode_slot_waste_pct", "gauge",
                 batch["slot_waste_pct"],
                 help_="warm decode slots not decoding (bucket-"
                       "rounding waste)")
        emit("cxxnet_decode_convoy", "gauge",
             int(batch.get("convoy", 0)),
             help_="1 while a long sequence pins a full bucket with "
                   "queued work waiting (decode_convoy events mark "
                   "the transitions)")
        emit("cxxnet_decode_convoys_total", "counter",
             int(batch.get("convoys", 0)))
        pool = batch.get("pool")
        if pool is not None:
            # the paged-KV block pool account (doc/performance.md
            # "Decode KV cache"): free-list level, block-exact pool
            # bytes, and the prefix-reuse / copy-on-write lifetime
            # tallies — absent entirely (not zero) on dense backends,
            # the absence-is-the-capability-signal discipline
            emit("cxxnet_decode_kv_block_total", "gauge",
                 int(pool.get("blocks_total", 0)),
                 help_="allocatable KV blocks in the paged decode "
                       "pool (scratch block excluded)")
            emit("cxxnet_decode_kv_block_free", "gauge",
                 int(pool.get("blocks_free", 0)))
            emit("cxxnet_decode_kv_block_used", "gauge",
                 int(pool.get("blocks_used", 0)))
            emit("cxxnet_decode_kv_block_tokens", "gauge",
                 int(pool.get("block_tokens", 0)),
                 help_="cache rows per KV block (serve_kv_block)")
            emit("cxxnet_decode_kv_pool_bytes", "gauge",
                 int(pool.get("pool_bytes", 0)),
                 help_="the paged pool's real device array nbytes "
                       "(block-exact: equals cxxnet_decode_kv_bytes "
                       "under paging)")
            emit("cxxnet_decode_prefix_queries_total", "counter",
                 int(pool.get("prefix_queries", 0)),
                 help_="paged admissions completed (a deferred ask "
                       "retries and counts once, at success — "
                       "cxxnet_decode_kv_defers_total counts the "
                       "defers)")
            emit("cxxnet_decode_prefix_hits_total", "counter",
                 int(pool.get("prefix_hits", 0)),
                 help_="admissions that reused >= 1 resident shared-"
                       "prefix token (prefilled once, fleet-of-"
                       "buckets-wide)")
            emit("cxxnet_decode_prefix_hit_tokens_total", "counter",
                 int(pool.get("prefix_hit_tokens", 0)))
            emit("cxxnet_decode_prefix_cow_total", "counter",
                 int(pool.get("cow_copies", 0)),
                 help_="copy-on-write block demotions (whole-prompt "
                       "matches recomputing their last position)")
            emit("cxxnet_decode_kv_defers_total", "counter",
                 int(pool.get("alloc_failures", 0)),
                 help_="admissions deferred on block-pool exhaustion "
                       "(deterministic queue-wait, never a device "
                       "OOM)")
            if _num(pool.get("prefix_hit_rate")):
                emit("cxxnet_decode_prefix_hit_rate", "gauge",
                     pool["prefix_hit_rate"],
                     help_="share of admitted prompt tokens served "
                           "from resident shared blocks (token-"
                           "weighted, %)")
            # retained conversation cache (doc/robustness.md "Memory
            # governance"): parked refcount-0 blocks, the revival
            # tallies, eviction churn, and the pressure latch
            emit("cxxnet_decode_kv_block_retained", "gauge",
                 int(pool.get("blocks_retained", 0)),
                 help_="refcount-0 blocks parked in the retained "
                       "conversation cache (evictable headroom)")
            emit("cxxnet_decode_retained_hits_total", "counter",
                 int(pool.get("retained_hits", 0)),
                 help_="admissions that REVIVED a retired "
                       "conversation's blocks (the retained sub-"
                       "source of the prefix hit rate)")
            emit("cxxnet_decode_retained_hit_tokens_total", "counter",
                 int(pool.get("retained_hit_tokens", 0)))
            emit("cxxnet_decode_retained_evictions_total", "counter",
                 int(pool.get("retained_evictions", 0)),
                 help_="retained blocks recycled onto the free list "
                       "(LRU, deepest-suffix-first)")
            if _num(pool.get("retained_hit_rate")):
                emit("cxxnet_decode_retained_hit_rate", "gauge",
                     pool["retained_hit_rate"],
                     help_="share of admitted prompt tokens served "
                           "from RETAINED (refcount-0) blocks")
            if "pressure" in pool:
                emit("cxxnet_decode_kv_pressure", "gauge",
                     1 if pool.get("pressure") else 0,
                     help_="1 while the low-headroom latch sheds "
                           "retained mass (kv_pressure events mark "
                           "the transitions)")
    if fleet is not None:
        # the routing fleet (routerd.Router.fleet_snapshot()): per-state
        # counts as one labeled family, per-replica load/liveness rows
        # keyed by replica address (the heartbeat-channel pattern)
        reps = fleet.get("replicas") or []
        emit("cxxnet_fleet_replicas", "gauge", len(reps),
             help_="replicas configured behind the router")
        emit("cxxnet_fleet_replicas_eligible", "gauge",
             int(fleet.get("eligible", 0)),
             help_="replicas up and in rotation (not held by a "
                   "rolling reload)")
        by_state: Dict[str, int] = {}
        for r in reps:
            # a standby is NOT routable whatever its probe state says:
            # it gets its own state row, and replica_up 0 below — a
            # dashboard counting "up" must count replicas that accept
            # traffic, not held-out spares
            st = "standby" if r.get("standby") \
                else r.get("state", "?")
            by_state[st] = by_state.get(st, 0) + 1
        if by_state:
            out.append("# TYPE cxxnet_fleet_state gauge")
            for st in sorted(by_state):
                out.append('cxxnet_fleet_state{process="%s",state="%s"}'
                           ' %d' % (_lesc(p), _lesc(st), by_state[st]))
        fams = (("cxxnet_fleet_replica_up",
                 lambda r: 1 if (r.get("state") == "up"
                                 and not r.get("standby")) else 0,
                 "1 while the replica is routable"),
                ("cxxnet_fleet_replica_queue_depth",
                 lambda r: r.get("queue_depth", 0), None),
                ("cxxnet_fleet_replica_in_flight",
                 lambda r: r.get("in_flight", 0), None),
                ("cxxnet_fleet_replica_outstanding",
                 lambda r: r.get("outstanding", 0),
                 "requests this router currently has on the replica"),
                ("cxxnet_fleet_replica_lost_contact",
                 lambda r: r.get("lost", 0),
                 "lost-contact attempts charged to this replica "
                 "(each one fed the replay failover)"))
        for mname, get, help_ in fams:
            if not reps:
                continue
            if help_:
                out.append("# HELP %s %s" % (mname, help_))
            out.append("# TYPE %s gauge" % mname)
            for r in reps:
                out.append('%s{process="%s",replica="%s"} %s'
                           % (mname, _lesc(p),
                              _lesc(r.get("name", "?")),
                              _fmt(get(r))))
        # the router-local failover account: route.* counters are
        # router-owned,
        # not federated from replicas — emitted here so the headline
        # chaos acceptance can scrape replays/hedges off the router
        rstats = fleet.get("stats") or {}
        ffams = (("lost_contact", "attempts that went silent after "
                  "dispatch (EOF/timeout) — replay failover feed"),
                 ("replays", "lost attempts re-executed on a "
                  "different replica (deterministic replay)"),
                 ("replay_denied", "replays refused (generation "
                  "moved, or tenant over fair share)"),
                 ("hedges", "duplicate tail-hedge attempts launched"),
                 ("hedge_wins", "requests whose hedge answered first"),
                 ("discarded_late", "duplicate answers reaped and "
                  "discarded (exactly-once to the client)"))
        for k, help_ in ffams:
            if k in rstats:
                emit("cxxnet_fleet_failover_%s_total" % k, "counter",
                     int(rstats.get(k) or 0), help_=help_)
        # warm-grid readiness per replica: only rows for replicas
        # that declare a grid (absence is the capability signal —
        # a missing row, never a lying 0)
        wreps = [r for r in reps if r.get("warm_pct") is not None]
        if wreps:
            out.append("# HELP cxxnet_fleet_replica_warm_pct compiled "
                       "fraction of the replica's expected serving "
                       "program grid (ADMIN warm_programs/"
                       "expected_programs)")
            out.append("# TYPE cxxnet_fleet_replica_warm_pct gauge")
            for r in wreps:
                out.append(
                    'cxxnet_fleet_replica_warm_pct{process="%s"'
                    ',replica="%s"} %s'
                    % (_lesc(p), _lesc(r.get("name", "?")),
                       _fmt(r["warm_pct"])))
        fed = fleet.get("federation")
        if fed:
            # the federated fleet account (routerd.federation_snapshot)
            # — per-replica serve histograms merged EXACTLY (shared
            # fixed buckets: bucket-count addition) into fleet series,
            # counters summed, SLO over the merged windows, and the
            # per-replica outlier verdicts
            emit("cxxnet_fleet_federated_replicas", "gauge",
                 int(fed.get("replicas", 0)),
                 help_="replicas whose metrics the last federation "
                       "sweep reached")
            emit("cxxnet_fleet_federation_age_seconds", "gauge",
                 round(float(fed.get("age_s", 0.0)), 3))
            for name, h in sorted((fed.get("series") or {}).items()):
                emit_hist("cxxnet_fleet_"
                          + _NAME_SAN.sub("_", str(name)) + "_seconds",
                          {"buckets": h.get("buckets"),
                           "count": h.get("count", 0),
                           "sum": h.get("sum_s", 0.0)})
            for cname, v in sorted((fed.get("counters") or {}).items()):
                if _num(v):
                    emit("cxxnet_fleet_"
                         + _NAME_SAN.sub("_", str(cname)) + "_total",
                         "counter", v)
            fslo = fed.get("slo")
            if fslo is not None:
                emit("cxxnet_fleet_slo_burn", "gauge",
                     int(fslo.get("alert", 0)),
                     help_="1 while the FLEET-wide merged-window error "
                           "budget burns >= 1x — fires even when no "
                           "single replica's own alert floor trips")
                emit("cxxnet_fleet_slo_burn_rate", "gauge",
                     float(fslo.get("burn_rate", 0.0)))
                emit("cxxnet_fleet_slo_bad_fraction", "gauge",
                     float(fslo.get("bad_fraction", 0.0)))
                emit("cxxnet_fleet_slo_window_requests", "gauge",
                     int(fslo.get("requests", 0)))
            verdicts = fed.get("outliers") or {}
            if verdicts:
                out.append("# HELP cxxnet_fleet_outlier 1 while the "
                           "replica's serve p99 diverges from the "
                           "fleet median past fleet_outlier_ratio")
                out.append("# TYPE cxxnet_fleet_outlier gauge")
                for name in sorted(verdicts):
                    out.append(
                        'cxxnet_fleet_outlier{process="%s",'
                        'replica="%s"} %d'
                        % (_lesc(p), _lesc(name),
                           1 if verdicts[name].get("outlier") else 0))
                out.append("# TYPE cxxnet_fleet_replica_p99_seconds "
                           "gauge")
                for name in sorted(verdicts):
                    p99 = verdicts[name].get("p99_ms")
                    if p99 is None:
                        continue
                    out.append(
                        'cxxnet_fleet_replica_p99_seconds'
                        '{process="%s",replica="%s"} %s'
                        % (_lesc(p), _lesc(name),
                           _fmt(round(p99 / 1e3, 6))))
            dec = fed.get("decode")
            if dec:
                # the fleet-wide decode KV/HBM account (exact: byte
                # sums over the replicas' own accounts, live pct
                # recomputed from the sums — never a mean of means)
                emit("cxxnet_fleet_decode_kv_bytes", "gauge",
                     int(dec.get("kv_bytes", 0)),
                     help_="allocated decode KV-cache bytes summed "
                           "over the federated replicas")
                emit("cxxnet_fleet_decode_kv_live_bytes", "gauge",
                     int(dec.get("kv_live_bytes", 0)))
                if _num(dec.get("kv_live_pct")):
                    emit("cxxnet_fleet_decode_kv_live_pct", "gauge",
                         dec["kv_live_pct"])
                emit("cxxnet_fleet_decode_convoy_replicas", "gauge",
                     int(dec.get("convoy_replicas", 0)),
                     help_="replicas currently latched in a decode "
                           "convoy (a straggler pinning a full bucket "
                           "while work queues)")
                pl = dec.get("pool")
                if pl:
                    # paged-KV pool federation: block counts summed
                    # exactly over the paged replicas, fleet prefix
                    # hit rate recomputed from the token sums
                    emit("cxxnet_fleet_decode_kv_block_total", "gauge",
                         int(pl.get("blocks_total", 0)),
                         help_="paged decode KV blocks summed over "
                               "the federated replicas")
                    emit("cxxnet_fleet_decode_kv_block_free", "gauge",
                         int(pl.get("blocks_free", 0)))
                    if _num(pl.get("prefix_hit_rate")):
                        emit("cxxnet_fleet_decode_prefix_hit_rate",
                             "gauge", pl["prefix_hit_rate"],
                             help_="fleet share of admitted prompt "
                                   "tokens served from resident "
                                   "shared blocks (token-weighted, "
                                   "%)")
                    emit("cxxnet_fleet_decode_kv_defers_total",
                         "counter", int(pl.get("kv_defers", 0)))
                    emit("cxxnet_fleet_decode_kv_block_retained",
                         "gauge", int(pl.get("blocks_retained", 0)),
                         help_="retained conversation-cache blocks "
                               "summed over the federated replicas")
                    emit("cxxnet_fleet_decode_retained_hits_total",
                         "counter", int(pl.get("retained_hits", 0)))
                    if _num(pl.get("retained_hit_rate")):
                        emit("cxxnet_fleet_decode_retained_hit_rate",
                             "gauge", pl["retained_hit_rate"])
                    emit("cxxnet_fleet_decode_kv_pressure_replicas",
                         "gauge", int(pl.get("pressure_replicas", 0)),
                         help_="replicas currently latched in KV "
                               "memory pressure (shedding retained "
                               "mass)")
        scale = fleet.get("scale")
        if scale:
            # the closed-loop autoscaler's account (routerd
            # scale_snapshot): target = active replicas the policy
            # currently holds in rotation, plus the cumulative
            # transition count the fleet_scale JSONL events mirror
            emit("cxxnet_fleet_target_replicas", "gauge",
                 int(scale.get("target_replicas", 0)),
                 help_="replicas the autoscaler holds in rotation "
                       "(standbys excluded until a scale-up admits "
                       "them)")
            emit("cxxnet_fleet_scale_events_total", "counter",
                 int(scale.get("events", 0)),
                 help_="autoscaler scale-up/scale-down transitions")
            emit("cxxnet_fleet_standby_replicas", "gauge",
                 int(scale.get("standby", 0)))
        tenants = fleet.get("tenants")
        if tenants:
            # per-tenant fleet books: the router's own outcome counts
            # (labels bound by the conf tenant table), each tenant's
            # federated fleet p99, and its fleet-wide merged-window SLO
            # burn — the "noisy tenant sheds, victim holds" series
            tfams = (("cxxnet_fleet_tenant_accepted_total", "counter",
                      lambda d: (d.get("router") or {}).get("accepted")),
                     ("cxxnet_fleet_tenant_served_total", "counter",
                      lambda d: (d.get("router") or {}).get("served")),
                     ("cxxnet_fleet_tenant_shed_total", "counter",
                      lambda d: (d.get("router") or {}).get("shed")),
                     ("cxxnet_fleet_tenant_errors_total", "counter",
                      lambda d: (d.get("router") or {}).get("errors")),
                     ("cxxnet_fleet_tenant_weight", "gauge",
                      lambda d: d.get("weight")),
                     ("cxxnet_fleet_tenant_p99_seconds", "gauge",
                      lambda d: None if d.get("p99_ms") is None
                      else round(d["p99_ms"] / 1e3, 6)),
                     ("cxxnet_fleet_tenant_slo_burn", "gauge",
                      lambda d: None if d.get("slo") is None
                      else int(d["slo"].get("alert", 0))),
                     ("cxxnet_fleet_tenant_slo_burn_rate", "gauge",
                      lambda d: None if d.get("slo") is None
                      else float(d["slo"].get("burn_rate", 0.0))))
            for mname, mtype, get in tfams:
                rows = [(t, get(d)) for t, d in sorted(tenants.items())]
                rows = [(t, v) for t, v in rows if _num(v)]
                if not rows:
                    continue
                out.append("# TYPE %s %s" % (mname, mtype))
                for t, v in rows:
                    out.append('%s{process="%s",tenant="%s"} %s'
                               % (mname, _lesc(p), _lesc(t), _fmt(v)))
    if channels is None:
        channels = health_mod.channel_status()
    if channels:
        # ONE TYPE line for the whole family (the exposition spec allows
        # one per metric name; the channels are label values)
        out.append("# TYPE cxxnet_heartbeat_age_seconds gauge")
        for ch, age, timeout, overdue in channels:
            out.append(
                'cxxnet_heartbeat_age_seconds{process="%s",channel="%s"}'
                ' %s' % (_lesc(p), _lesc(ch), _fmt(round(age, 3))))
    for key in ("round", "num_round", "batch", "served", "errors",
                "shed", "deadline"):
        v = (progress or {}).get(key)
        if _num(v):
            emit("cxxnet_progress_" + key, "gauge", v)
    if books is not None:
        # the conservation-law auditor's account (telemetry.BooksAuditor
        # snapshot): one latched gauge row per law — a 1 is sticky until
        # an operator resets the auditor, so a scrape-miss between sweep
        # and page can never hide a violation. Broken laws that were
        # since unregistered (a drained router) still render their latch.
        laws = sorted(set(books.get("laws") or ())
                      | set(books.get("broken") or ()))
        if laws:
            out.append("# HELP cxxnet_books_broken 1 latched once the "
                       "named conservation law was ever violated")
            out.append("# TYPE cxxnet_books_broken gauge")
            broken = set(books.get("broken") or ())
            for law in laws:
                out.append('cxxnet_books_broken{process="%s",law="%s"} %d'
                           % (_lesc(p), _lesc(law),
                              1 if law in broken else 0))
        emit("cxxnet_books_laws", "gauge",
             len(books.get("laws") or ()),
             help_="conservation laws currently registered for sweeping")
        emit("cxxnet_books_sweeps_total", "counter",
             int(books.get("sweeps", 0)))
    for name, v in sorted(snapshot.get("counters", {}).items()):
        if _num(v):
            emit(_mname(name) + "_total", "counter", v)
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        if _num(v):
            emit(_mname(name), "gauge", v)
    for name, h in sorted(snapshot.get("hists", {}).items()):
        emit_hist(_mname(name) + "_seconds", h)
    return "\n".join(out) + "\n"


def _mib(v) -> str:
    return "n/a" if v is None else "%.1f" % (v / float(1 << 20))


def programz_html(snap: dict) -> str:
    """Render a ``perf.Ledger.snapshot()`` as the /programz page: the
    HBM account, then one row per carded program. Pure function of the
    snapshot — the perf selftest and tests validate it socket-free."""
    esc = html.escape
    spec = snap.get("spec") or {}
    hbm = snap.get("hbm") or {}
    parts = ["<html><head><title>cxxnet programz</title></head>"
             "<body><h1>program performance ledger</h1><pre>"]
    parts.append("device spec: %s  peak %.1f TFLOP/s  HBM %.0f GB/s  "
                 "capacity %.1f GiB"
                 % (esc(str(spec.get("name", "?"))),
                    (spec.get("peak_flops") or 0.0) / 1e12,
                    (spec.get("hbm_bw") or 0.0) / 1e9,
                    (spec.get("hbm_capacity") or 0.0) / 2.0**30))
    peak = hbm.get("peak_bytes")
    head = hbm.get("headroom_bytes")
    dkv = hbm.get("decode_kv_bytes")
    parts.append("hbm: peak program footprint %s MiB   headroom %s MiB"
                 % (_mib(peak), _mib(head))
                 + ("   decode kv cache %s MiB (see /batchz)"
                    % _mib(dkv) if dkv is not None else ""))
    parts.append("</pre><h2>programs</h2><pre>")
    cols = ("program", "shapes", "cause", "n", "compile_s", "GFLOPs",
            "peak MiB", "pred ms", "p50 ms", "p99 ms", "MFU%", "eff%")
    fmt = "%-18s %-28s %-18s %3s %9s %9s %9s %8s %8s %8s %6s %6s"
    parts.append(fmt % cols)

    def num(v, scale=1.0, form="%.2f"):
        return "n/a" if v is None else form % (v * scale)

    for c in snap.get("cards") or []:
        if c.get("status") == "error":
            parts.append(fmt % (
                esc(c.get("name", "?")), esc(str(c.get("shapes", "?"))),
                esc(str(c.get("cause", "?"))), c.get("compiles", 0),
                num(c.get("compile_s")), "ERR", "ERR", "-", "-", "-",
                "-", "-"))
            parts.append("    analysis error: %s"
                         % esc(str(c.get("error"))))
            continue
        shared = c.get("series_shared_by", 1) > 1
        parts.append(fmt % (
            esc(c.get("name", "?")), esc(str(c.get("shapes", "?"))),
            esc(str(c.get("cause", "?"))), c.get("compiles", 0),
            num(c.get("compile_s")), num(c.get("flops"), 1e-9),
            _mib(c.get("peak_bytes")), num(c.get("predicted_s"), 1e3),
            num(c.get("measured_p50_ms")) + ("*" if shared else ""),
            num(c.get("measured_p99_ms")),
            num(c.get("mfu_pct"), form="%.1f"),
            num(c.get("roofline_eff_pct"), form="%.1f")))
    if not snap.get("cards"):
        parts.append("(no programs carded yet — nothing compiled since "
                     "the ledger was enabled)")
    parts.append("</pre><p>pred = max(flops/peak, bytes/bw) roofline; "
                 "MFU% and eff% join the measured latency histogram "
                 "(doc/performance.md \"Live program ledger\"); "
                 "* = several signatures of this program share one "
                 "measured series, so p50/MFU/eff aggregate them; "
                 "<a href='/programz?json=1'>json</a> "
                 "<a href='/statusz'>statusz</a></p></body></html>")
    return "\n".join(parts)


def compilez_html(body: dict) -> str:
    """Render the compile flight recorder as the /compilez page: the
    warm-grid readiness account, then one row per recorded compile
    (newest first) with its trigger attribution — which request /
    dispatcher window paid the cliff. Pure function of the
    ``{"compiles", "total", "shown", "readiness"}`` body the handler
    builds — the perf selftest and tests validate it socket-free."""
    esc = html.escape
    rd = body.get("readiness") or {}
    parts = ["<html><head><title>cxxnet compilez</title></head>"
             "<body><h1>compile flight recorder</h1><pre>"]
    pct = rd.get("ready_pct")
    if pct is None:
        parts.append("warm grid: no expected program grid registered "
                     "(serve-only; learn_task wires it from "
                     "serve_buckets/serve_plen_buckets)")
    else:
        parts.append("warm grid: %d/%d programs compiled (%.1f%% ready)"
                     % (rd.get("warm", 0), rd.get("expected", 0), pct))
        for b, st in sorted((rd.get("buckets") or {}).items()):
            parts.append("  bucket %-10s %d/%d (%.1f%%)"
                         % (esc(str(b)), st.get("warm", 0),
                            st.get("expected", 0),
                            st.get("ready_pct", 0.0)))
        cold = rd.get("cold_keys") or []
        if cold:
            parts.append("  cold: " + " ".join(esc(k) for k in cold))
    parts.append("</pre><h2>compiles (%d shown of %d recorded)</h2><pre>"
                 % (body.get("shown", 0), body.get("total", 0)))
    cols = ("seq", "ts", "program", "cause", "seconds", "trigger",
            "key")
    fmt = "%5s %9s %-18s %-19s %8s %-24s %s"
    parts.append(fmt % cols)
    for r in body.get("compiles") or []:
        trig = r.get("trigger_request") or r.get("trigger_context") \
            or "-"
        parts.append(fmt % (
            r.get("seq", "?"),
            "%.2f" % r["ts"] if r.get("ts") is not None else "n/a",
            esc(str(r.get("name", "?"))), esc(str(r.get("cause", "?"))),
            "%.3f" % r.get("seconds", 0.0), esc(str(trig)),
            esc(str(r.get("key") or r.get("shapes") or "?"))))
    if not body.get("compiles"):
        parts.append("(no compiles recorded since the ledger was "
                     "enabled)")
    parts.append("</pre><p>trigger = the request id (prefill paid the "
                 "cliff inside that request) or the dispatcher window "
                 "(session:/step: — every request aboard the batch "
                 "stalled; their flight records carry it as "
                 "compile_stall_s); "
                 "<a href='/compilez?json=1'>json</a> "
                 "<a href='/programz'>programz</a> "
                 "<a href='/statusz'>statusz</a></p></body></html>")
    return "\n".join(parts)


def fleetz_html(snap: dict) -> str:
    """Render a ``routerd.Router.fleet_snapshot()`` as the /fleetz
    page: one row per replica (state machine + load + ejection
    backoff), the router's counters, and the recent rolling-reload
    drain windows. Pure function of the snapshot — the routerd
    selftest and tests validate it socket-free."""
    esc = html.escape
    parts = ["<html><head><title>cxxnet fleetz</title></head>"
             "<body><h1>serving fleet</h1><pre>"]
    reps = snap.get("replicas") or []
    parts.append("replicas: %d configured, %d eligible%s%s"
                 % (len(reps), snap.get("eligible", 0),
                    "  DRAINING" if snap.get("draining") else "",
                    "  ROLLING-RELOAD" if snap.get("reloading")
                    else ""))
    parts.append("</pre><h2>replicas</h2><pre>")
    cols = ("replica", "state", "hold", "queue", "in_flight",
            "outstanding", "lost", "buckets", "blocks", "retained",
            "warm", "ejections", "probed", "detail")
    fmt = ("%-21s %-12s %-4s %5s %9s %11s %5s %-12s %-9s %-9s %-9s "
           "%9s %8s  %s")
    parts.append(fmt % cols)
    for r in reps:
        age = r.get("last_probe_age_s")
        # the per-bucket load signal (ADMIN stats bucket.<b>.*): each
        # warm bucket as <size>:<active>/<size> — the column
        # disaggregated scheduling will route on; "-" pre-batching
        bks = " ".join(
            "%s:%s/%s" % (b, d.get("active", 0), b)
            for b, d in sorted((r.get("buckets") or {}).items(),
                               key=lambda kv: int(kv[0]))
            if d.get("warm")) or "-"
        detail = str(r.get("detail", ""))
        if r.get("standby"):
            # held out of dispatch until the autoscaler admits it
            detail = "STANDBY " + detail
        if r.get("outlier"):
            # the federation sweep's verdict: this replica's serve p99
            # diverges from the fleet median — the flagged row the
            # cxxnet_fleet_outlier gauge and fleet_outlier event name
            detail = ("OUTLIER (p99 %.1fms vs fleet) " % r["p99_ms"]
                      if r.get("p99_ms") is not None
                      else "OUTLIER ") + detail
        # paged-KV pool level (ADMIN stats kv_blocks_free/total):
        # "-" on dense/pre-paging replicas (None in the snapshot —
        # absence is the capability signal, never rendered as 0/0)
        blks = ("%s/%s" % (r.get("kv_blocks_free"),
                           r.get("kv_blocks_total"))
                if r.get("kv_blocks_total") is not None else "-")
        # retained conversation cache (ADMIN stats
        # kv_retained_blocks/kv_retained_hits): parked blocks and
        # lifetime revivals — "-" on pre-retention replicas (None in
        # the snapshot; absence is the capability signal)
        ret = ("%s:%s" % (r.get("kv_retained_blocks"),
                          r.get("kv_retained_hits"))
               if r.get("kv_retained_blocks") is not None else "-")
        # warm-grid readiness (ADMIN stats warm_programs/
        # expected_programs): compiled fraction of the replica's
        # expected program grid — "-" when it declares no grid (None
        # in the snapshot; absence is the capability signal)
        warm = ("%.0f%% (%s/%s)" % (r["warm_pct"],
                                    r.get("warm_programs"),
                                    r.get("expected_programs"))
                if r.get("warm_pct") is not None else "-")
        parts.append(fmt % (
            esc(r.get("name", "?")), esc(r.get("state", "?")),
            "yes" if r.get("hold") else "-", r.get("queue_depth", 0),
            r.get("in_flight", 0), r.get("outstanding", 0),
            r.get("lost", 0),
            esc(bks), esc(blks), esc(ret), esc(warm),
            r.get("ejections", 0),
            "never" if age is None else "%.1fs" % age,
            esc(detail)))
    parts.append("</pre><h2>router</h2><pre>")
    stats = snap.get("stats") or {}
    parts.append(" ".join("%s=%s" % kv for kv in
                          sorted(stats.items())))
    if stats.get("lost_contact") or stats.get("hedges"):
        # the failover account, interpreted: how many losses the
        # replay machinery recovered vs surfaced, and the hedge win
        # rate — the at-a-glance line behind the
        # cxxnet_fleet_failover_* series
        parts.append("failover: %s lost-contact, %s replayed, %s "
                     "denied; %s hedged, %s hedge wins; %s late "
                     "duplicate answer(s) discarded"
                     % (stats.get("lost_contact", 0),
                        stats.get("replays", 0),
                        stats.get("replay_denied", 0),
                        stats.get("hedges", 0),
                        stats.get("hedge_wins", 0),
                        stats.get("discarded_late", 0)))
    fed = snap.get("federation")
    if fed:
        parts.append("</pre><h2>federated fleet metrics</h2><pre>")
        parts.append("%d replica(s) federated, %.1fs ago"
                     % (fed.get("replicas", 0), fed.get("age_s", 0.0)))
        for name, h in sorted((fed.get("series") or {}).items()):
            parts.append("%-28s n=%-8d p50=%s p99=%s"
                         % (esc(name), h.get("count", 0),
                            _ms(h.get("p50_ms")), _ms(h.get("p99_ms"))))
        fslo = fed.get("slo")
        if fslo is not None:
            parts.append("fleet slo: %d requests, %d bad, burn %.2fx%s"
                         % (fslo.get("requests", 0),
                            fslo.get("bad", 0),
                            fslo.get("burn_rate", 0.0),
                            "  BURNING" if fslo.get("alert") else ""))
        dec = fed.get("decode")
        if dec:
            pct = dec.get("kv_live_pct")
            parts.append("decode kv (%d replica(s)): %s MiB allocated, "
                         "%s MiB live (%s%%)%s"
                         % (dec.get("replicas", 0),
                            _mib(dec.get("kv_bytes")),
                            _mib(dec.get("kv_live_bytes")),
                            "n/a" if pct is None else "%.1f" % pct,
                            "  CONVOY on %d replica(s)"
                            % dec["convoy_replicas"]
                            if dec.get("convoy_replicas") else ""))
            pl = dec.get("pool")
            if pl:
                hr = pl.get("prefix_hit_rate")
                rr = pl.get("retained_hit_rate")
                parts.append("paged kv (%d replica(s)): %s/%s blocks "
                             "free, %s retained (%s revival(s), hit "
                             "rate %s%%), prefix hit rate %s%%, %s "
                             "exhaustion defer(s)%s"
                             % (pl.get("replicas", 0),
                                pl.get("blocks_free", 0),
                                pl.get("blocks_total", 0),
                                pl.get("blocks_retained", 0),
                                pl.get("retained_hits", 0),
                                "n/a" if rr is None else "%.1f" % rr,
                                "n/a" if hr is None else "%.1f" % hr,
                                pl.get("kv_defers", 0),
                                "  PRESSURE on %d replica(s)"
                                % pl["pressure_replicas"]
                                if pl.get("pressure_replicas") else ""))
    scale = snap.get("scale")
    if scale:
        parts.append("</pre><h2>autoscaler</h2><pre>")
        parts.append("target %d replicas (bounds %d..%d, %d standby); "
                     "%d scale event(s); up at burn>=%gx, retire after "
                     "%gs idle, cooldown %gs"
                     % (scale.get("target_replicas", 0),
                        scale.get("min", 0), scale.get("max", 0),
                        scale.get("standby", 0),
                        scale.get("events", 0),
                        scale.get("up_burn", 0.0),
                        scale.get("down_idle_s", 0.0),
                        scale.get("cooldown_s", 0.0)))
        for ev in scale.get("recent") or []:
            # warm_pct: the replica's compiled fraction at the scale
            # decision — a 0% scale-up is "admitted but paying every
            # compile cliff ahead" (serve_scale_up_to_first_token_s)
            wp = ev.get("warm_pct")
            parts.append("%-4s %-21s -> %d active%s  (%s)"
                         % (esc(ev.get("action", "?")),
                            esc(ev.get("replica", "?")),
                            ev.get("active", 0),
                            "" if wp is None
                            else ", %.0f%% warm" % wp,
                            esc(ev.get("reason", ""))))
    tenants = snap.get("tenants")
    if tenants:
        parts.append("</pre><h2>tenants (weighted-fair QoS)</h2><pre>")
        cols = ("tenant", "weight", "accepted", "served", "shed",
                "errors", "fleet p99", "slo burn")
        tfmt = "%-16s %6s %9s %9s %9s %9s %10s %9s"
        parts.append(tfmt % cols)
        for t, d in sorted(tenants.items()):
            ro = d.get("router") or {}
            slo = d.get("slo") or {}
            parts.append(tfmt % (
                esc(t), "%g" % d.get("weight", 1.0),
                ro.get("accepted", 0), ro.get("served", 0),
                ro.get("shed", 0), ro.get("errors", 0),
                _ms(d.get("p99_ms")),
                ("%.2fx%s" % (slo["burn_rate"],
                              " BURNING" if slo.get("alert") else "")
                 if slo.get("burn_rate") is not None else "n/a")))
    wins = snap.get("windows") or []
    if wins:
        parts.append("</pre><h2>rolling-reload drain windows</h2><pre>")
        for w in wins:
            parts.append("%-21s out %.3f -> back %.3f (%.3fs)"
                         % (esc(w.get("replica", "?")), w["out_s"],
                            w["back_s"], w["back_s"] - w["out_s"]))
    parts.append("</pre><p><a href='/fleetz?json=1'>json</a> "
                 "<a href='/statusz'>statusz</a></p></body></html>")
    return "\n".join(parts)


def requestz_html(recs: List[dict], total: int, cap: int,
                  limit: int) -> str:
    """Render a flight-recorder listing as the /requestz page — one
    row per request, newest first. Handles BOTH record shapes: a servd
    replica's phase-attributed records and a router's attempt records
    (utils/routerd.py), so the same page works on every process.
    Pure function of its inputs — validated socket-free in tests."""
    esc = html.escape
    parts = ["<html><head><title>cxxnet requestz</title></head>"
             "<body><h1>request flight recorder</h1><pre>"]
    parts.append("%d of last %d requests recorded%s"
                 % (total, cap,
                    "  (showing newest %d — ?n=<k> to change)"
                    % len(recs) if limit > 0 and total > len(recs)
                    else ""))
    parts.append("</pre><pre>")
    cols = ("request", "outcome", "total", "ttft", "tok", "detail")
    fmt = "%-24s %-14s %9s %9s %5s  %s"
    parts.append(fmt % cols)
    for r in recs:
        total_s = r.get("total_s")
        ttft_s = r.get("ttft_s")
        if r.get("attempts") is not None:
            # router shape: the routing life in one cell
            detail = " -> ".join(
                "%s:%s%s" % (a.get("replica", "?"),
                             a.get("outcome", "?"),
                             " (retried)" if a.get("retried") else "")
                for a in r["attempts"]) or "(no attempt)"
        else:
            ph = r.get("phases") or {}
            detail = " ".join(
                "%s=%s" % (k, _ms(None if ph.get(k) is None
                                  else ph[k] * 1e3))
                for k in telemetry.REQUEST_PHASES if k in ph)
            if r.get("shed_at"):
                detail = "shed at admission (%s)" % r["shed_at"]
        parts.append(fmt % (
            esc(str(r.get("id", "?"))), esc(str(r.get("outcome", "?"))),
            _ms(None if total_s is None else total_s * 1e3),
            _ms(None if ttft_s is None else ttft_s * 1e3),
            r.get("tokens_out", r.get("retries", 0)),
            esc(detail)))
    if not recs:
        parts.append("(no requests recorded yet)")
    parts.append("</pre><p>one request's Chrome trace: "
                 "<code>/trace?request=&lt;id&gt;</code> "
                 "(on a router: the stitched cross-process trace); "
                 "<a href='/requestz?json=1'>json</a> "
                 "<a href='/statusz'>statusz</a></p></body></html>")
    return "\n".join(parts)


def batchz_html(snap: dict) -> str:
    """Render a ``servd.ServeFrontend.batch_snapshot(ring=...)`` as the
    /batchz page: the KV/occupancy account, the per-bucket table, and
    the newest iteration records of the scheduler flight ring (one row
    per decode iteration: composition, step latency, queue pressure,
    convoy verdict). Pure function of the snapshot — validated
    socket-free in tests."""
    esc = html.escape
    parts = ["<html><head><title>cxxnet batchz</title></head>"
             "<body><h1>decode batch scheduler</h1><pre>"]
    occ = snap.get("mean_occupancy")
    parts.append("iterations: %d (%d slot-iterations, mean occupancy "
                 "%s)   capacity %d, free slots %d, queue depth %d"
                 % (snap.get("iterations", 0),
                    snap.get("slot_iterations", 0),
                    "n/a" if occ is None else "%.2f" % occ,
                    snap.get("capacity", 0), snap.get("free_slots", 0),
                    snap.get("queue_depth", 0)))
    kv_pct = snap.get("kv_live_pct")
    waste = snap.get("slot_waste_pct")
    parts.append("kv cache: %s MiB allocated, %s MiB live (%s%% live"
                 "%s) — the paged-KV reclaim target (ROADMAP item 2)"
                 % (_mib(snap.get("kv_bytes")),
                    _mib(snap.get("kv_live_bytes")),
                    "n/a" if kv_pct is None else "%.1f" % kv_pct,
                    "" if waste is None
                    else ", %.1f%% slot waste" % waste))
    pool = snap.get("pool")
    if pool is not None:
        hr = pool.get("prefix_hit_rate")
        parts.append("paged pool: %s/%s blocks free (%s tokens/block, "
                     "%s MiB pool)   prefix reuse: %s/%s admissions "
                     "hit, %s%% of prompt tokens resident, %s CoW, "
                     "%s exhaustion defers"
                     % (pool.get("blocks_free", 0),
                        pool.get("blocks_total", 0),
                        pool.get("block_tokens", 0),
                        _mib(pool.get("pool_bytes")),
                        pool.get("prefix_hits", 0),
                        pool.get("prefix_queries", 0),
                        "n/a" if hr is None else "%.1f" % hr,
                        pool.get("cow_copies", 0),
                        pool.get("alloc_failures", 0)))
        rr = pool.get("retained_hit_rate")
        parts.append("retained cache: %s block(s) parked (cap %s), "
                     "%s revival(s) (%s%% of prompt tokens), %s "
                     "eviction(s)%s"
                     % (pool.get("blocks_retained", 0),
                        pool.get("retained_cap", 0),
                        pool.get("retained_hits", 0),
                        "n/a" if rr is None else "%.1f" % rr,
                        pool.get("retained_evictions", 0),
                        "   MEMORY PRESSURE (shedding)"
                        if pool.get("pressure") else ""))
    parts.append("convoy: %s (%d episode(s); threshold %d iterations "
                 "pinned with queued work at zero free slots)"
                 % ("ACTIVE" if snap.get("convoy") else "none",
                    snap.get("convoys", 0),
                    snap.get("convoy_iters", 0)))
    parts.append("</pre><h2>buckets</h2><pre>")
    cols = ("bucket", "warm", "active", "kv MiB", "live MiB", "live%")
    fmt = "%-7s %5s %7s %9s %9s %7s"
    if pool is not None:
        cols = cols + ("blocks",)
        fmt += " %7s"
    parts.append(fmt % cols)
    for b, bs in sorted((snap.get("buckets") or {}).items(),
                        key=lambda kv: int(kv[0])):
        kvb = bs.get("kv_bytes", 0)
        row = (esc(str(b)), bs.get("warm", 0), bs.get("active", 0),
               _mib(kvb), _mib(bs.get("kv_live_bytes", 0)),
               "%.1f" % (100.0 * bs.get("kv_live_bytes", 0) / kvb)
               if kvb else "n/a")
        if pool is not None:
            # block-table claims: a shared prefix block counts once
            # per holder, so the column can sum past blocks_used
            row = row + (bs.get("blocks_held", 0),)
        parts.append(fmt % row)
    ring = snap.get("flight") or []
    if ring:
        parts.append("</pre><h2>iteration flight ring (newest %d of "
                     "cap %d)</h2><pre>"
                     % (len(ring), snap.get("flight_cap", 0)))
        cols = ("iter", "bucket", "occ", "step", "queue", "q_age",
                "kv_live%", "slots [slot:id@age]")
        ifmt = "%-8s %6s %4s %9s %6s %8s %8s  %s"
        if pool is not None:
            # block pressure per iteration: next to the queue columns
            # it answers "queued because slots or because blocks?"
            cols = cols[:7] + ("blk_free",) + cols[7:]
            ifmt = "%-8s %6s %4s %9s %6s %8s %8s %8s  %s"
        parts.append(ifmt % cols)
        for it in ring:
            slots = " ".join("%s:%s@%s" % (r[0], r[1], r[2])
                             for r in it.get("slots") or [])
            extra = []
            for rid, slot in it.get("admitted") or []:
                extra.append("+%s" % rid)
            for row in it.get("retired") or []:
                extra.append("-%s" % row[0])
            if it.get("convoy"):
                extra.append("CONVOY")
            if it.get("error"):
                extra.append("ERROR %s" % it["error"])
            if extra:
                slots += "  (" + " ".join(extra) + ")"
            kvp = it.get("kv_live_pct")
            row = (it.get("iter", "?"), it.get("bucket", "?"),
                   it.get("occupancy", 0), _ms(it.get("step_ms")),
                   it.get("queue_depth", 0),
                   _ms(None if it.get("queue_age_s") is None
                       else it["queue_age_s"] * 1e3),
                   "n/a" if kvp is None else "%.1f" % kvp)
            if pool is not None:
                row = row + ("%s/%s" % (it.get("blocks_free", "?"),
                                        it.get("blocks_total", "?")),)
            parts.append(ifmt % (row + (esc(slots),)))
    parts.append("</pre><p>one request's slot-Gantt view: "
                 "<code>/trace?request=&lt;id&gt;</code>; "
                 "<a href='/batchz?json=1'>json</a> "
                 "<a href='/statusz'>statusz</a></p></body></html>")
    return "\n".join(parts)


def why_html(payload: dict) -> str:
    """Render one request's slowdown autopsy (a ``classify_record`` /
    ``classify_route`` verdict, or a router's ``stitch_route`` merge)
    as the /why page: the primary verdict up top, then the cause
    waterfall with seconds and share of wall time, then — on a router —
    each hop's own local verdict. Pure function of the payload —
    validated socket-free in tests."""
    esc = html.escape
    aut = payload.get("autopsy") or {}
    causes = aut.get("causes") or {}
    wall = float(aut.get("wall_s") or 0.0)
    parts = ["<html><head><title>cxxnet why</title></head>"
             "<body><h1>request autopsy: %s</h1><pre>"
             % esc(str(payload.get("id", "?")))]
    parts.append("outcome: %-12s  wall %s   PRIMARY VERDICT: %s"
                 % (esc(str(payload.get("outcome", "?"))),
                    _ms(wall * 1e3),
                    esc(str(aut.get("primary", "?")))))
    parts.append("</pre><h2>cause waterfall</h2><pre>")
    fmt = "%-16s %10s %7s  %s"
    parts.append(fmt % ("cause", "seconds", "share", ""))
    for cause in autopsy.CAUSES:
        s = float(causes.get(cause, 0.0))
        share = (100.0 * s / wall) if wall > 0 else 0.0
        bar = "#" * int(round(share / 4.0))
        mark = " <-- primary" if cause == aut.get("primary") else ""
        parts.append(fmt % (esc(cause), "%.6f" % s,
                            "%.1f%%" % share, bar + mark))
    hops = payload.get("hops") or {}
    if hops:
        parts.append("</pre><h2>hops (each replica's local verdict)"
                     "</h2><pre>")
        hfmt = "%-16s %-16s %10s  %s"
        parts.append(hfmt % ("replica", "primary", "wall", "causes"))
        for name in sorted(hops):
            h = hops[name] or {}
            hc = h.get("causes") or {}
            detail = " ".join(
                "%s=%s" % (c, _ms(hc[c] * 1e3))
                for c in autopsy.CAUSES if hc.get(c, 0.0) > 0.0)
            parts.append(hfmt % (
                esc(str(name)), esc(str(h.get("primary", "?"))),
                _ms(float(h.get("wall_s") or 0.0) * 1e3), esc(detail)))
    parts.append("</pre><p>the raw record: "
                 "<code>/requestz?request=&lt;id&gt;</code>; the Gantt "
                 "view: <code>/trace?request=&lt;id&gt;</code>; "
                 "<a href='/why?request=%s&amp;json=1'>json</a> "
                 "<a href='/eventz'>eventz</a> "
                 "<a href='/statusz'>statusz</a></p></body></html>"
                 % esc(str(payload.get("id", "?"))))
    return "\n".join(parts)


def eventz_html(rows: List[dict], limit: int = 0) -> str:
    """Render the incident timeline (``autopsy.incidents`` rows — on a
    router the fleet-merged feed) as the /eventz page: one wall-clock
    ordered row per transition or point incident, begin rows naming the
    requests whose autopsies cite the episode. Pure function of the
    rows — validated socket-free in tests."""
    esc = html.escape
    parts = ["<html><head><title>cxxnet eventz</title></head>"
             "<body><h1>fleet incident timeline</h1><pre>"]
    parts.append("%d incident row(s)%s"
                 % (len(rows),
                    "  (newest %d — ?n=<k> to change)" % limit
                    if limit > 0 else ""))
    parts.append("</pre><pre>")
    fmt = "%-12s %-10s %-14s %-6s %-24s %s"
    parts.append(fmt % ("t+", "process", "kind", "state", "requests",
                        "detail"))
    for r in rows:
        ev = r.get("event") or {}
        detail = " ".join(
            "%s=%s" % (k, ev[k]) for k in sorted(ev)
            if k not in ("ev", "ts") and not isinstance(ev[k], (dict,
                                                               list)))
        reqs = ",".join(str(x) for x in (r.get("requests") or ())) \
            or "-"
        parts.append(fmt % (
            "%.3fs" % float(r.get("ts") or 0.0),
            esc(str(r.get("process", "-"))), esc(str(r.get("kind", "?"))),
            esc(str(r.get("state", "?"))), esc(reqs), esc(detail)))
    if not rows:
        parts.append("(no incidents recorded — a quiet fleet)")
    parts.append("</pre><p>each begin row names the requests whose "
                 "<code>/why?request=&lt;id&gt;</code> autopsies cite "
                 "the episode; "
                 "<a href='/eventz?json=1'>json</a> "
                 "<a href='/statusz'>statusz</a></p></body></html>")
    return "\n".join(parts)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    statusd: "StatusServer"


class _Endpoint(BaseHTTPRequestHandler):
    server_version = "cxxnet-statusd/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # quiet: no per-scrape stderr spam
        pass

    def _reply(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):   # noqa: N802 (BaseHTTPRequestHandler contract)
        srv = self.server.statusd
        path, _, query = self.path.partition("?")
        try:
            if path == "/metrics":
                if parse_qs(query).get("json"):
                    # the RAW registry snapshot (+ SLO window, batch
                    # account): exact bucket counts, so a merge of
                    # several processes is bucket addition
                    body = {"metrics": srv.registry.metrics_snapshot(),
                            "slo": srv.slo.snapshot()
                            if srv.slo is not None else None,
                            "slo_tenants": {
                                t: tr.snapshot() for t, tr in
                                sorted(srv.slo_tenants.items())}
                            if srv.slo_tenants else None,
                            # the decode KV/convoy account rides the
                            # federation feed: the router sums the
                            # byte accounts into cxxnet_fleet_decode_*
                            "batch": srv.batch.batch_snapshot()
                            if srv.batch is not None else None}
                    self._reply(200, "application/json",
                                json.dumps(body).encode("utf-8"))
                else:
                    self._reply(
                        200,
                        "text/plain; version=0.0.4; charset=utf-8",
                        srv.metrics_text().encode("utf-8"))
            elif path == "/healthz":
                fails = srv.health_failures()
                if fails:
                    body = "unhealthy\n" + "".join(
                        "%s: %s\n" % (n, d) for n, d in fails)
                    self._reply(503, "text/plain; charset=utf-8",
                                body.encode("utf-8"))
                else:
                    self._reply(200, "text/plain; charset=utf-8", b"ok\n")
            elif path == "/livez":
                fails = srv.health_failures(liveness_only=True)
                if fails:
                    body = "dead\n" + "".join(
                        "%s: %s\n" % (n, d) for n, d in fails)
                    self._reply(503, "text/plain; charset=utf-8",
                                body.encode("utf-8"))
                else:
                    self._reply(200, "text/plain; charset=utf-8",
                                b"alive\n")
            elif path in ("/", "/statusz"):
                self._reply(200, "text/html; charset=utf-8",
                            srv.statusz_html().encode("utf-8"))
            elif path == "/trace":
                # keep_blank_values: "?request=" with an empty id must
                # 404 like any other unknown id, not silently fall
                # through to the whole-ring event trace
                rid = (parse_qs(query, keep_blank_values=True)
                       .get("request") or [None])[0]
                if rid is not None:
                    if srv.fleet is not None and hasattr(
                            srv.fleet, "stitched_trace"):
                        # router process: ONE cross-process trace —
                        # the router's attempt lane plus each touched
                        # replica's phase lanes, fetched live over
                        # their statusd and clock-aligned on the
                        # shared wall epoch (routerd.stitched_trace)
                        trace = srv.fleet.stitched_trace(rid)
                        if trace is None:
                            self._reply(
                                404, "text/plain; charset=utf-8",
                                ("no routed request %r in the router "
                                 "flight ring; see /requestz\n" % rid)
                                .encode("utf-8"))
                        else:
                            self._reply(200, "application/json",
                                        json.dumps(trace)
                                        .encode("utf-8"))
                        return
                    # one request's flight record as a Chrome trace
                    fr = srv.flight
                    rec = fr.get(rid) if fr is not None else None
                    if rec is None:
                        detail = ("no flight record for request %r"
                                  % rid) if fr is not None else \
                            "no flight recorder registered (serving off?)"
                        self._reply(404, "text/plain; charset=utf-8",
                                    (detail + "; see /requestz\n")
                                    .encode("utf-8"))
                    else:
                        # on a batching replica, merge the request's
                        # scheduler iterations in as slot-Gantt lanes
                        # (which iterations it shared, and with whom)
                        ring = getattr(srv.batch, "batch_flight", None)\
                            if srv.batch is not None else None
                        iters = ring.for_request(rid) \
                            if ring is not None else None
                        self._reply(
                            200, "application/json",
                            json.dumps(telemetry.request_chrome_trace(
                                rec, batch_iters=iters))
                            .encode("utf-8"))
                else:
                    trace = telemetry.events_to_chrome(
                        srv.registry.recent_events())
                    self._reply(200, "application/json",
                                json.dumps(trace).encode("utf-8"))
            elif path == "/requestz":
                q = parse_qs(query, keep_blank_values=True)
                fr = srv.flight
                rid = (q.get("request") or [None])[0]
                if rid is not None:
                    # ONE raw flight record by id — the cross-process
                    # stitch fetches a replica's half of a routed
                    # request through this (routerd.stitched_trace)
                    rec = fr.get(rid) if fr is not None else None
                    if rec is None:
                        self._reply(404, "text/plain; charset=utf-8",
                                    ("no flight record for request %r\n"
                                     % rid).encode("utf-8"))
                    else:
                        self._reply(200, "application/json",
                                    json.dumps(rec).encode("utf-8"))
                    return
                try:
                    # ?n=<k>: the ring default (256 records) is an
                    # unreadable wall in a browser — bound the listing
                    n = int((q.get("n") or ["0"])[0])
                except ValueError:
                    self._reply(400, "text/plain; charset=utf-8",
                                b"n must be an integer\n")
                    return
                recs = fr.list() if fr is not None else []
                total = len(recs)
                if n > 0:
                    recs = recs[:n]
                if q.get("json"):
                    body = {"requests": recs,
                            "capacity": fr.cap if fr is not None else 0,
                            "total": total, "shown": len(recs)}
                    self._reply(200, "application/json",
                                json.dumps(body).encode("utf-8"))
                else:
                    # HTML by default, ?json=1 for the raw snapshot —
                    # the same contract as /fleetz and /programz
                    self._reply(200, "text/html; charset=utf-8",
                                requestz_html(
                                    recs, total,
                                    fr.cap if fr is not None else 0,
                                    n).encode("utf-8"))
            elif path == "/batchz":
                fe = srv.batch
                q = parse_qs(query)
                try:
                    # ?n=<k>: iteration-ring rows shown (default 64 —
                    # the full ring is an unreadable wall)
                    n = int((q.get("n") or ["64"])[0])
                except ValueError:
                    self._reply(400, "text/plain; charset=utf-8",
                                b"n must be an integer\n")
                    return
                # ONE snapshot per request: it takes the frontend's
                # admission lock, so the probe must not pay it twice
                snap = fe.batch_snapshot(ring=max(0, n)) \
                    if fe is not None else None
                if snap is None:
                    self._reply(404, "text/plain; charset=utf-8",
                                b"no batching frontend registered "
                                b"(serve_buckets unset, or this "
                                b"process is not serving)\n")
                elif q.get("json"):
                    self._reply(200, "application/json",
                                json.dumps(snap).encode("utf-8"))
                else:
                    self._reply(200, "text/html; charset=utf-8",
                                batchz_html(snap).encode("utf-8"))
            elif path == "/programz":
                lg = srv.perf
                q = parse_qs(query)
                try:
                    # ?n=<k>: program cards shown (default all — the
                    # grid is small; floods of shapes are not). The
                    # query contract outranks the subsystem check: a
                    # malformed ?n is 400 even with no ledger wired.
                    n = int((q.get("n") or ["0"])[0])
                except ValueError:
                    self._reply(400, "text/plain; charset=utf-8",
                                b"n must be an integer\n")
                    return
                if lg is None:
                    self._reply(404, "text/plain; charset=utf-8",
                                b"no performance ledger registered "
                                b"(perf_ledger=0?)\n")
                else:
                    snap = lg.snapshot()
                    if n > 0:
                        snap = dict(snap)
                        snap["cards"] = (snap.get("cards") or [])[:n]
                    if q.get("json"):
                        self._reply(200, "application/json",
                                    json.dumps(snap).encode("utf-8"))
                    else:
                        self._reply(200, "text/html; charset=utf-8",
                                    programz_html(snap).encode("utf-8"))
            elif path == "/compilez":
                lg = srv.perf
                q = parse_qs(query)
                try:
                    # ?n=<k>: compile-ring rows shown (default 64).
                    # Contract first: malformed ?n is 400, ledger or not.
                    n = int((q.get("n") or ["64"])[0])
                except ValueError:
                    self._reply(400, "text/plain; charset=utf-8",
                                b"n must be an integer\n")
                    return
                if lg is None:
                    self._reply(404, "text/plain; charset=utf-8",
                                b"no performance ledger registered "
                                b"(perf_ledger=0?)\n")
                else:
                    recs = lg.recent_compiles()
                    total = len(recs)
                    if n > 0:
                        recs = recs[:n]
                    body = {"compiles": recs, "total": total,
                            "shown": len(recs),
                            "readiness": lg.readiness()}
                    if q.get("json"):
                        self._reply(200, "application/json",
                                    json.dumps(body).encode("utf-8"))
                    else:
                        self._reply(200, "text/html; charset=utf-8",
                                    compilez_html(body).encode("utf-8"))
            elif path == "/fleetz":
                fl = srv.fleet
                q = parse_qs(query)
                try:
                    # ?n=<k>: replica rows shown (default all).
                    # Contract first: malformed ?n is 400, fleet or not.
                    n = int((q.get("n") or ["0"])[0])
                except ValueError:
                    self._reply(400, "text/plain; charset=utf-8",
                                b"n must be an integer\n")
                    return
                if fl is None:
                    self._reply(404, "text/plain; charset=utf-8",
                                b"no fleet registered (this process is "
                                b"not a router; task = route wires "
                                b"one)\n")
                else:
                    snap = fl.fleet_snapshot()
                    if n > 0:
                        snap = dict(snap)
                        snap["replicas"] = \
                            (snap.get("replicas") or [])[:n]
                    if q.get("json"):
                        self._reply(200, "application/json",
                                    json.dumps(snap).encode("utf-8"))
                    else:
                        self._reply(200, "text/html; charset=utf-8",
                                    fleetz_html(snap).encode("utf-8"))
            elif path == "/why":
                q = parse_qs(query, keep_blank_values=True)
                rid = (q.get("request") or [None])[0]
                if rid is None:
                    self._reply(400, "text/plain; charset=utf-8",
                                b"which request? /why?request=<id> "
                                b"(ids on /requestz)\n")
                    return
                if srv.fleet is not None and hasattr(
                        srv.fleet, "stitched_why"):
                    # router process: the cross-process verdict — the
                    # router's own lane decomposition with the winning
                    # replica's books stitched into the latency lane
                    # (routerd.stitched_why)
                    payload = srv.fleet.stitched_why(rid)
                else:
                    fr = srv.flight
                    rec = fr.get(rid) if fr is not None else None
                    payload = None if rec is None else {
                        "id": rec.get("id"),
                        "outcome": rec.get("outcome"),
                        # replicas stamp the verdict at record time
                        # (servd._observe_request); classify on the
                        # fly for records that predate the autopsy
                        "autopsy": rec.get("autopsy")
                        or autopsy.classify_record(rec),
                        "hops": {}}
                if payload is None:
                    self._reply(404, "text/plain; charset=utf-8",
                                ("no flight record for request %r; "
                                 "see /requestz\n" % rid)
                                .encode("utf-8"))
                elif q.get("json"):
                    self._reply(200, "application/json",
                                json.dumps(payload).encode("utf-8"))
                else:
                    self._reply(200, "text/html; charset=utf-8",
                                why_html(payload).encode("utf-8"))
            elif path == "/eventz":
                q = parse_qs(query)
                try:
                    # ?n=<k>: newest incident rows shown (default all —
                    # the transition streams are sparse by design)
                    n = int((q.get("n") or ["0"])[0])
                except ValueError:
                    self._reply(400, "text/plain; charset=utf-8",
                                b"n must be an integer\n")
                    return
                if srv.fleet is not None and hasattr(
                        srv.fleet, "fleet_eventz"):
                    # router process: the fleet-merged timeline — this
                    # router's incidents plus every replica's own
                    # /eventz feed under one wall clock
                    rows = srv.fleet.fleet_eventz(
                        n if n > 0 else None)
                else:
                    fr = srv.flight
                    rows = autopsy.incidents(
                        srv.registry.recent_events(),
                        t0_wall=getattr(srv.registry, "t0_wall", 0.0),
                        records=fr.list() if fr is not None else None,
                        n=n if n > 0 else None)
                if q.get("json"):
                    body = {"rows": rows, "shown": len(rows)}
                    self._reply(200, "application/json",
                                json.dumps(body).encode("utf-8"))
                else:
                    self._reply(200, "text/html; charset=utf-8",
                                eventz_html(rows, n).encode("utf-8"))
            elif path == "/profilez":
                prof = srv.profiler
                if prof is None:
                    self._reply(404, "text/plain; charset=utf-8",
                                b"no profiler registered (learn_task "
                                b"runs wire one whenever status_port "
                                b"is set; embedders call "
                                b"statusd.set_profiler)\n")
                else:
                    secs = (parse_qs(query).get("secs")
                            or ["2"])[0]
                    try:
                        secs = float(secs)
                    except ValueError:
                        self._reply(400, "text/plain; charset=utf-8",
                                    b"secs must be a number\n")
                        return
                    # a PREVIOUS capture's failure surfaces on the next
                    # request (the 200 goes out before a capture runs)
                    prev_err = getattr(prof, "last_error", None)
                    ok, detail = prof.start(secs)
                    if ok:
                        body = ("profiling for %gs into %s\n(a "
                                "torch.profiler Chrome trace, "
                                "trace.json)\n" % (secs, detail))
                        if prev_err:
                            body += ("WARNING: previous capture FAILED: "
                                     "%s\n" % prev_err)
                        self._reply(200, "text/plain; charset=utf-8",
                                    body.encode("utf-8"))
                    else:
                        code = 409 if "in progress" in detail else 400
                        self._reply(code, "text/plain; charset=utf-8",
                                    (detail + "\n").encode("utf-8"))
            else:
                # the endpoint table IS the list
                self._reply(404, "text/plain; charset=utf-8",
                            ("not found; endpoints: %s\n"
                             % " ".join(p for p, _, _ in ENDPOINTS))
                            .encode("utf-8"))
        except Exception as e:    # a broken probe must not kill the server
            try:
                self._reply(500, "text/plain; charset=utf-8",
                            ("internal error: %r\n" % e).encode("utf-8"))
            except Exception:
                pass


class StatusServer:
    """The live-introspection HTTP server. Construct + ``start()`` binds
    a daemon thread; ``stop()`` shuts it down. One per process (the
    module-level ``start``/``stop`` manage the singleton the learn task
    uses); tests build isolated instances against private registries."""

    def __init__(self, port: int = 0, host: str = "",
                 registry=None):
        self.registry = registry if registry is not None else telemetry._REG
        self.run_info: Dict[str, object] = {}
        self.progress: Dict[str, object] = {}
        # serving wiring (set_flight_recorder / set_slo): the per-request
        # flight ring behind /trace?request= and /requestz, and the SLO
        # tracker behind the cxxnet_slo_* gauges and the /statusz section
        self.flight: Optional[telemetry.FlightRecorder] = None
        self.slo: Optional[SLOTracker] = None
        # per-tenant SLO trackers ({tenant: SLOTracker}) — the
        # cxxnet_slo_tenant_* label rows, the /statusz tenant lines,
        # and the slo_tenants half of the /metrics?json=1 federation
        # feed (doc/serving.md "Multi-tenant QoS")
        self.slo_tenants: Dict[str, SLOTracker] = {}
        # batching wiring (set_batch): the ServeFrontend whose
        # batch_snapshot()/batch_flight back /batchz, the
        # cxxnet_decode_* series, the /metrics?json=1 federation feed,
        # and the /trace slot-Gantt lanes
        self.batch = None
        # performance-ledger wiring (set_perf / set_profiler): the
        # perf.Ledger behind /programz, /compilez and the cxxnet_program_*
        # series, and the perf.ProfilerCapture behind /profilez
        self.perf = None
        self.profiler = None
        # fleet wiring (set_fleet): the routerd.Router behind /fleetz
        # and the cxxnet_fleet_* series (task = route registers it)
        self.fleet = None
        # the conservation-law auditor behind cxxnet_books_* — the
        # PROCESS-wide one by default (servd/routerd register their
        # laws there), swappable for isolation via set_auditor(None)
        self.auditor = telemetry.auditor()
        # (name, probe_fn, liveness): see register_probe
        self.probes: List[Tuple[str, Callable[[], Tuple[bool, str]],
                                bool]] = []
        # loopback by default: /statusz exposes the full run config (data
        # and model paths included), so wide exposure is OPT-IN —
        # status_host=0.0.0.0 for a cross-host Prometheus scrape
        self._httpd = _HTTPServer((host or "127.0.0.1", int(port)),
                                  _Endpoint)
        self._httpd.statusd = self
        self.host = self._httpd.server_address[0]
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        # cxxlint: disable=wallclock — rendered via localtime on /statusz
        self.t0_wall = time.time()

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "StatusServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="cxn-statusd",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StatusServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- wiring --------------------------------------------------------
    def register_probe(self, name: str,
                       fn: Callable[[], Tuple[bool, str]],
                       liveness: bool = False) -> None:
        """``fn() -> (ok, detail)``; a False (or raising) probe flips
        /healthz (readiness) to 503 with the detail in the body.
        ``liveness=True`` probes additionally flip /livez — reserve those
        for "restart me" conditions (dead thread), not "don't route to
        me" ones (draining, breaker open, rollback in flight)."""
        self.probes.append((name, fn, bool(liveness)))

    def wire_health(self, recovery=None) -> None:
        """Wire the standard health sources: the watchdog heartbeat
        channels are always consulted (health.channel_status); a
        RecoveryPolicy adds the unresolved-anomaly probe — 503 from the
        moment an anomaly decides rollback/abort until the train loop calls
        ``recovery.resolve()`` after the restore."""
        if recovery is not None:
            def _probe():
                a = recovery.pending
                if a is None:
                    return True, "no unresolved anomaly"
                return False, "unresolved anomaly: " + a.describe()
            self.register_probe("anomaly", _probe)

    def all_failures(self, channels: Optional[list] = None) \
            -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
        """ONE evaluation of every heartbeat channel and probe ->
        ``(readiness_failures, liveness_failures)`` — so a scrape that
        needs both views (the cxxnet_healthy and cxxnet_live gauges)
        runs each probe once and the two lists can never disagree about
        a single evaluation. An overdue heartbeat fails BOTH: a hung
        process is neither routable nor worth keeping; probe failures
        are readiness-only unless registered with ``liveness=True``."""
        if channels is None:
            channels = health_mod.channel_status()
        ready: List[Tuple[str, str]] = []
        live: List[Tuple[str, str]] = []
        for ch, age, timeout, overdue in channels:
            if overdue:
                f = ("watchdog:" + ch,
                     "heartbeat silent %.2fs (timeout %.2fs)"
                     % (age, timeout))
                ready.append(f)
                live.append(f)
        for name, fn, liveness in list(self.probes):
            try:
                ok, detail = fn()
            except Exception as e:
                ok, detail = False, "probe raised: %r" % e
            if not ok:
                ready.append((name, detail))
                if liveness:
                    live.append((name, detail))
        return ready, live

    def health_failures(self, channels: Optional[list] = None,
                        liveness_only: bool = False) \
            -> List[Tuple[str, str]]:
        """Readiness failures by default; ``liveness_only=True`` gives
        the /livez view (overdue heartbeats + liveness probes)."""
        ready, live = self.all_failures(channels)
        return live if liveness_only else ready

    # -- renderers -----------------------------------------------------
    def metrics_text(self) -> str:
        # ONE heartbeat snapshot and ONE probe pass per scrape: the
        # healthy/live gauges and the per-channel age rows must agree
        # within a single response
        channels = health_mod.channel_status()
        ready, live = self.all_failures(channels)
        books = None
        if self.auditor is not None:
            # EVERY scrape sweeps: a violation can never hide between
            # daemon periods, and the latched account below is at most
            # one scrape old
            self.auditor.sweep()
            books = self.auditor.snapshot()
        return prometheus_metrics(
            self.registry.metrics_snapshot(),
            progress=dict(self.progress),
            health_failures=ready,
            channels=channels,
            live_failures=live,
            slo=self.slo.snapshot() if self.slo is not None else None,
            slo_tenants={t: tr.snapshot()
                         for t, tr in sorted(self.slo_tenants.items())}
            if self.slo_tenants else None,
            perf=self.perf.snapshot() if self.perf is not None else None,
            batch=self.batch.batch_snapshot()
            if self.batch is not None else None,
            fleet=self.fleet.fleet_snapshot()
            if self.fleet is not None else None,
            books=books)

    def statusz_html(self) -> str:
        reg = self.registry
        snap = reg.metrics_snapshot()
        s = reg.summary()
        esc = html.escape
        parts = ["<html><head><title>cxxnet statusz</title></head>"
                 "<body><h1>cxxnet_tpu_torch statusz</h1>"]

        def table(title, rows):
            if not rows:
                return
            parts.append("<h2>%s</h2><pre>" % esc(title))
            w = max(len(str(k)) for k, _ in rows)
            for k, v in rows:
                parts.append("%-*s  %s" % (w, esc(str(k)), esc(str(v))))
            parts.append("</pre>")

        info = [(k, v) for k, v in self.run_info.items() if k != "config"]
        info.append(("uptime", "%.1fs" % snap["uptime_s"]))
        info.append(("process", snap["process"]))
        info.append(("started", time.strftime(
            "%Y-%m-%d %H:%M:%S", time.localtime(self.t0_wall))))
        table("run", info)
        prog = sorted(self.progress.items())
        table("progress", prog)

        channels = health_mod.channel_status()
        fails, live_fails = self.all_failures(channels)
        rows = [("healthz (ready)", "503 UNHEALTHY" if fails
                 else "200 ok"),
                ("livez (alive)", "503 DEAD" if live_fails
                 else "200 alive")]
        rows += [("probe " + n, d) for n, d in fails]
        for ch, age, timeout, overdue in channels:
            rows.append(("heartbeat " + ch, "%.2fs ago (timeout %.1fs)%s"
                         % (age, timeout, " OVERDUE" if overdue else "")))
        table("health", rows)

        if self.slo is not None:
            sn = self.slo.snapshot()
            obj = sn["objectives"]
            objs = []
            if obj["ttft_ms"] > 0:
                objs.append("ttft<=%gms" % obj["ttft_ms"])
            if obj["p99_ms"] > 0:
                objs.append("latency<=%gms" % obj["p99_ms"])
            objs.append("availability>=%g" % obj["availability"])
            reasons = " ".join("%s=%d" % kv
                               for kv in sorted(sn["by_reason"].items()))
            table("slo", [
                ("objectives", "  ".join(objs)),
                ("window", "%.0fs: %d requests, %d bad%s"
                 % (sn["window_s"], sn["requests"], sn["bad"],
                    ("  (" + reasons + ")") if reasons else "")),
                ("error budget", "%.4f%% of requests may be bad"
                 % (100 * sn["budget"])),
                ("burn rate", "%.2fx%s" % (sn["burn_rate"],
                                           "  BURNING" if sn["alert"]
                                           else ""))])
        if self.fleet is not None:
            fsnap = self.fleet.fleet_snapshot()
            by: Dict[str, int] = {}
            for r in fsnap.get("replicas") or []:
                by[r.get("state", "?")] = by.get(r.get("state", "?"),
                                                 0) + 1
            table("fleet", [
                ("replicas", "%d configured, %d eligible (%s) — see "
                 "/fleetz" % (len(fsnap.get("replicas") or []),
                              fsnap.get("eligible", 0),
                              " ".join("%s=%d" % kv
                                       for kv in sorted(by.items()))
                              or "none")),
                ("router", " ".join(
                    "%s=%s" % kv
                    for kv in sorted((fsnap.get("stats")
                                      or {}).items())))])

        if self.flight is not None and len(self.flight):
            latest = self.flight.list()[0]
            table("requests", [
                ("flight recorder", "%d of last %d requests recorded"
                 % (len(self.flight), self.flight.cap)),
                ("latest", "id=%s outcome=%s total=%s"
                 % (latest.get("id"), latest.get("outcome"),
                    _ms(None if latest.get("total_s") is None
                        else latest["total_s"] * 1e3)))])

        # continuous-batching occupancy: the honest weighted mean over
        # decode iterations (serve.batch_slot_iterations /
        # serve.batch_iterations — a last-write gauge scraped between
        # batches lies); 1.00 means every pass served one sequence
        iters = snap["counters"].get("serve.batch_iterations", 0)
        if iters:
            slots = snap["counters"].get("serve.batch_slot_iterations",
                                         0)
            rows = [
                ("mean occupancy", "%.2f sequences/pass over %d decode "
                 "iterations" % (slots / float(iters), iters)),
                ("last pass", snap["gauges"].get(
                    "serve.batch_occupancy", "n/a"))]
            bsnap = self.batch.batch_snapshot() \
                if self.batch is not None else None
            if bsnap:
                kv_pct = bsnap.get("kv_live_pct")
                rows.append(
                    ("kv cache", "%s MiB allocated, %s%% live — see "
                     "/batchz" % (_mib(bsnap.get("kv_bytes")),
                                  "n/a" if kv_pct is None
                                  else "%.1f" % kv_pct)))
                rows.append(
                    ("convoy", "%s (%d episode(s))"
                     % ("ACTIVE" if bsnap.get("convoy") else "none",
                        bsnap.get("convoys", 0))))
            table("batching", rows)

        if self.perf is not None:
            psnap = self.perf.snapshot()
            hbm = psnap.get("hbm") or {}
            prows = [
                ("cards", "%d compiled programs (see /programz)"
                 % len(psnap.get("cards") or [])),
                ("hbm peak", "%s MiB (headroom %s MiB)"
                 % (_mib(hbm.get("peak_bytes")),
                    _mib(hbm.get("headroom_bytes"))))]
            if hbm.get("decode_kv_bytes") is not None:
                prows.append(("hbm decode kv", "%s MiB (live decode "
                              "cache — a first-class HBM consumer)"
                              % _mib(hbm["decode_kv_bytes"])))
            table("program ledger", prows)

        ck = reg.last_event("ckpt_save")
        if ck is not None and "ts" in ck:
            table("checkpoint", [
                ("last save", ck.get("path", "?")),
                ("age", "%.1fs" % (snap["uptime_s"] - ck["ts"])),
                ("bytes", ck.get("bytes", "?"))])

        hist_rows = []
        for name, a in sorted(s.get("hists", {}).items(),
                              key=lambda kv: -kv[1]["sum_s"]):
            # a declared-but-never-fired series (TTFT before the first
            # request) renders "n/a", not a 0.00ms lie
            hist_rows.append((name, "n=%d p50=%s p90=%s p99=%s"
                              % (a["count"], _ms(a["p50_ms"]),
                                 _ms(a["p90_ms"]), _ms(a["p99_ms"]))))
        table("latency histograms", hist_rows)

        comp = s.get("compiles", {})
        if comp.get("count"):
            table("recompiles", [("count", comp["count"]),
                                 ("total_s", comp["total_s"])] +
                  sorted(comp.get("by_cause", {}).items()))
        table("counters", sorted(snap["counters"].items()))
        table("gauges", sorted(snap["gauges"].items()))

        cfg = self.run_info.get("config")
        if cfg:
            parts.append("<details><summary>config (%d keys)</summary><pre>"
                         % len(cfg))
            for k, v in cfg:
                parts.append("%s = %s" % (esc(str(k)), esc(str(v))))
            parts.append("</pre></details>")
        parts.append("<p>endpoints: %s</p></body></html>"
                     % " ".join("<a href='%s'>%s</a>" % (p, p)
                                for p, _, _ in ENDPOINTS))
        return "\n".join(parts)


# ----------------------------------------------------------------------
# module-level singleton surface (the learn-task wiring); every function
# is a cheap no-op while no server is running, so instrumented call
# sites (per-batch progress updates) cost one attribute test by default
_SERVER: Optional[StatusServer] = None


def start(port: int = 0, host: str = "", registry=None) -> StatusServer:
    global _SERVER
    stop()
    _SERVER = StatusServer(port, host=host, registry=registry).start()
    # the continuous half of the conservation-law auditor: scrapes
    # sweep on demand (metrics_text), the daemon sweeps between them —
    # an unwatched process still latches cxxnet_books_broken
    telemetry.auditor().start(0.5)
    return _SERVER


def stop() -> None:
    global _SERVER
    if _SERVER is not None:
        s, _SERVER = _SERVER, None
        s.stop()
        telemetry.auditor().stop()


def active() -> Optional[StatusServer]:
    return _SERVER


def set_run_info(**kv) -> None:
    s = _SERVER
    if s is not None:
        s.run_info.update(kv)


def update_progress(**kv) -> None:
    s = _SERVER
    if s is not None:
        s.progress.update(kv)


def register_probe(name: str, fn, liveness: bool = False) -> None:
    s = _SERVER
    if s is not None:
        s.register_probe(name, fn, liveness=liveness)


def wire_health(recovery=None) -> None:
    s = _SERVER
    if s is not None:
        s.wire_health(recovery)


def set_flight_recorder(fr) -> None:
    """Attach a telemetry.FlightRecorder — /trace?request=<id> and
    /requestz serve from it. No-op without a running server."""
    s = _SERVER
    if s is not None:
        s.flight = fr


def set_slo(tracker: Optional[SLOTracker]) -> None:
    """Attach an SLOTracker — /metrics exports its cxxnet_slo_* gauges
    and /statusz renders the budget account. No-op without a server."""
    s = _SERVER
    if s is not None:
        s.slo = tracker


def set_batch(frontend) -> None:
    """Attach a batching ServeFrontend (or any object exposing
    ``batch_snapshot(ring=...)`` and ``batch_flight``) — /batchz, the
    cxxnet_decode_* /metrics families, the /metrics?json=1 federation
    feed, and the /trace slot-Gantt lanes serve from it. None clears
    (a reload that swapped to a solo frontend)."""
    s = _SERVER
    if s is not None:
        s.batch = frontend


def set_slo_tenants(trackers) -> None:
    """Attach the per-tenant SLOTracker map ({tenant: tracker}) —
    /metrics exports cxxnet_slo_tenant_* label rows and the
    /metrics?json=1 federation feed carries each tenant's window for
    the fleet-wide per-tenant merge. None/empty clears."""
    s = _SERVER
    if s is not None:
        s.slo_tenants = dict(trackers or {})


def set_perf(ledger) -> None:
    """Attach a perf.Ledger — /programz and the cxxnet_program_* /
    cxxnet_hbm_* series serve from it. No-op without a server."""
    s = _SERVER
    if s is not None:
        s.perf = ledger


def set_profiler(capture) -> None:
    """Attach a perf.ProfilerCapture — /profilez?secs=N starts captures
    through its one-at-a-time guard. No-op without a server."""
    s = _SERVER
    if s is not None:
        s.profiler = capture


def set_fleet(router) -> None:
    """Attach a routerd.Router — /fleetz and the cxxnet_fleet_* series
    serve from its fleet_snapshot(). No-op without a server."""
    s = _SERVER
    if s is not None:
        s.fleet = router


def set_auditor(aud) -> None:
    """Swap the conservation-law auditor behind the cxxnet_books_*
    series (the process-wide telemetry.auditor() by default). None
    stops exporting books state. No-op without a server."""
    s = _SERVER
    if s is not None:
        s.auditor = aud


# ----------------------------------------------------------------------
def selftest(verbose: bool = False) -> int:
    """Serve on port 0, scrape every endpoint over a real socket,
    validate the Prometheus text format, flip /healthz with a failing
    probe, shut down. Runs with runtime lock-order enforcement on for
    the registry/SLO/flight locks (utils/lockrank.py)."""
    with lockrank.enforced():
        return _selftest_body(verbose)


def _selftest_body(verbose: bool = False) -> int:
    from urllib.request import urlopen
    from urllib.error import HTTPError

    reg = telemetry._Registry()
    reg.enable()                       # in-memory sink
    with reg.span("selftest.step"):
        time.sleep(0.001)
    reg.count("selftest.requests", 3)
    reg.gauge("selftest.level", 7)
    reg.hist("selftest.latency", 0.012)
    reg.declare_hist("selftest.never_fired")   # -> "n/a", empty buckets

    srv = StatusServer(0, host="127.0.0.1", registry=reg).start()
    srv.slo = SLOTracker(ttft_ms=50.0, availability=0.999,
                         min_requests=3, window_s=60.0)
    srv.flight = telemetry.FlightRecorder(cap=8)
    srv.flight.record({"id": "7", "outcome": "served", "tokens_in": 4,
                       "tokens_out": 8, "total_s": 0.061, "ttft_s": 0.02,
                       "phases": {"queue_wait": 0.001, "dispatch": 0.0005,
                                  "prefill": 0.02, "decode": 0.04},
                       "recompiles": []})
    try:
        base = "http://127.0.0.1:%d" % srv.port

        metrics = urlopen(base + "/metrics", timeout=5).read().decode()
        for line in metrics.splitlines():
            if not line or line.startswith("#"):
                continue
            assert PROM_LINE_RE.match(line), \
                "invalid Prometheus line: %r" % line
        assert "cxxnet_selftest_requests_total" in metrics
        assert 'cxxnet_selftest_step_seconds_bucket' in metrics
        assert 'le="+Inf"' in metrics
        # a declared-but-empty series still exports (zeroed) buckets
        assert "cxxnet_selftest_never_fired_seconds_bucket" in metrics
        # the SLO account: healthy window -> burn gauge 0
        assert 'cxxnet_slo_burn{process="0"} 0' in metrics
        assert "cxxnet_slo_burn_rate" in metrics

        # per-request flight recorder: HTML by default (the ?json=1
        # contract /fleetz and /programz follow), listable as JSON,
        # ?n=<k> bounded, one raw record by ?request=<id> (the
        # cross-process stitch feed)
        rpage = urlopen(base + "/requestz", timeout=5).read().decode()
        assert "flight recorder" in rpage and ">7<" not in rpage
        reqz = json.loads(urlopen(base + "/requestz?json=1",
                                  timeout=5).read())
        assert reqz["requests"] and reqz["requests"][0]["id"] == "7"
        srv.flight.record({"id": "8", "outcome": "shed",
                           "shed_at": "queue", "total_s": 0.0,
                           "phases": {}, "recompiles": []})
        lim = json.loads(urlopen(base + "/requestz?json=1&n=1",
                                 timeout=5).read())
        assert lim["shown"] == 1 and lim["total"] == 2 \
            and lim["requests"][0]["id"] == "8"
        one = json.loads(urlopen(base + "/requestz?request=7",
                                 timeout=5).read())
        assert one["id"] == "7" and one["outcome"] == "served"
        try:
            urlopen(base + "/requestz?request=nope", timeout=5)
            raise AssertionError("unknown request id should 404")
        except HTTPError as e:
            assert e.code == 404
        try:
            urlopen(base + "/requestz?n=x", timeout=5)
            raise AssertionError("non-integer n should 400")
        except HTTPError as e:
            assert e.code == 400
        # the federation feed: raw registry snapshot + SLO window
        mj = json.loads(urlopen(base + "/metrics?json=1",
                                timeout=5).read())
        assert mj["metrics"]["counters"]["selftest.requests"] == 3
        assert "selftest.latency" in mj["metrics"]["hists"]
        assert mj["slo"]["min_requests"] == 3
        rtrace = json.loads(urlopen(
            base + "/trace?request=7", timeout=5).read())
        names = [t["name"] for t in rtrace["traceEvents"]
                 if t.get("ph") == "X"]
        assert names == ["queue_wait", "dispatch", "prefill", "decode"]
        try:
            urlopen(base + "/trace?request=nope", timeout=5)
            raise AssertionError("unknown request id should 404")
        except HTTPError as e:
            assert e.code == 404
        # request autopsy: /why decomposes the record's wall time into
        # named causes, exactly ONE primary verdict, and the attributed
        # seconds tile >= 95% of wall_s
        why = json.loads(urlopen(base + "/why?request=7&json=1",
                                 timeout=5).read())
        aut = why["autopsy"]
        assert aut["primary"] == "decode_baseline", aut
        assert sum(aut["causes"].values()) >= 0.95 * aut["wall_s"], aut
        wpage = urlopen(base + "/why?request=7",
                        timeout=5).read().decode()
        assert "PRIMARY VERDICT" in wpage and "decode_baseline" in wpage
        try:
            urlopen(base + "/why?request=nope", timeout=5)
            raise AssertionError("unknown request id should 404")
        except HTTPError as e:
            assert e.code == 404
        try:
            urlopen(base + "/why", timeout=5)
            raise AssertionError("missing request id should 400")
        except HTTPError as e:
            assert e.code == 400
        # incident timeline: a transition pair and a point event merge
        # into wall-clock-ordered rows on /eventz
        reg.record({"ev": "kv_pressure", "pressure": 1, "ts": 0.01})
        reg.record({"ev": "kv_pressure", "pressure": 0, "ts": 0.05})
        reg.record({"ev": "serve_drain", "ts": 0.06})
        evz = json.loads(urlopen(base + "/eventz?json=1",
                                 timeout=5).read())
        kinds = [r["kind"] for r in evz["rows"]]
        assert "kv_pressure" in kinds and "serve_drain" in kinds, kinds
        walls = [r["t_wall"] for r in evz["rows"]]
        assert walls == sorted(walls)
        lim2 = json.loads(urlopen(base + "/eventz?json=1&n=1",
                                  timeout=5).read())
        assert lim2["shown"] == 1
        epage = urlopen(base + "/eventz", timeout=5).read().decode()
        assert "incident timeline" in epage
        try:
            urlopen(base + "/eventz?n=x", timeout=5)
            raise AssertionError("non-integer n should 400")
        except HTTPError as e:
            assert e.code == 400
        # SLO burn flips under a flood of objective-violating requests
        for _ in range(5):
            srv.slo.observe(ok=True, ttft_s=0.5)     # >> 50ms objective
        m2 = urlopen(base + "/metrics", timeout=5).read().decode()
        assert 'cxxnet_slo_burn{process="0"} 1' in m2

        assert urlopen(base + "/healthz", timeout=5).status == 200
        assert urlopen(base + "/livez", timeout=5).status == 200
        srv.register_probe("boom", lambda: (False, "injected failure"))
        try:
            urlopen(base + "/healthz", timeout=5)
            raise AssertionError("healthz should be 503")
        except HTTPError as e:
            assert e.code == 503
            assert "injected failure" in e.read().decode()
        # a readiness failure is NOT a liveness failure: /livez stays 200
        assert urlopen(base + "/livez", timeout=5).status == 200
        m = urlopen(base + "/metrics", timeout=5).read().decode()
        assert 'cxxnet_healthy{process="0"} 0' in m
        assert 'cxxnet_live{process="0"} 1' in m
        srv.register_probe("dead", lambda: (False, "worker died"),
                           liveness=True)
        try:
            urlopen(base + "/livez", timeout=5)
            raise AssertionError("livez should be 503")
        except HTTPError as e:
            assert e.code == 503
            assert "worker died" in e.read().decode()
        srv.probes.clear()

        # fleet surfaces: 404 before a router registers, then the
        # /fleetz page + cxxnet_fleet_* series from a snapshot-shaped
        # fake (the real Router drives these in the routerd selftest)
        try:
            urlopen(base + "/fleetz", timeout=5)
            raise AssertionError("fleetz without a fleet should 404")
        except HTTPError as e:
            assert e.code == 404

        class _FakeFleet:
            def fleet_snapshot(self):
                return {"replicas": [
                    {"name": "127.0.0.1:7001", "state": "up",
                     "hold": False, "queue_depth": 2, "in_flight": 1,
                     "outstanding": 1, "ejections": 0,
                     "probe_fails": 0, "last_probe_age_s": 0.1,
                     "detail": "ready"},
                    {"name": "127.0.0.1:7002", "state": "dead",
                     "hold": False, "queue_depth": 0, "in_flight": 0,
                     "outstanding": 0, "ejections": 3,
                     "probe_fails": 3, "last_probe_age_s": None,
                     "detail": "statusd unreachable"},
                    {"name": "127.0.0.1:7003", "state": "up",
                     "standby": True, "hold": False,
                     "queue_depth": 0, "in_flight": 0,
                     "outstanding": 0, "ejections": 0,
                     "probe_fails": 0, "last_probe_age_s": 0.1,
                     "detail": "ready"}],
                    "eligible": 1, "draining": False,
                    "reloading": False,
                    "windows": [{"replica": "127.0.0.1:7001",
                                 "out_s": 1.0, "back_s": 1.5}],
                    "stats": {"accepted": 5, "served": 4, "shed": 1,
                              "errors": 0, "deadline": 0,
                              "retries": 1, "admin": 0,
                              "client_gone": 0}}

        srv.fleet = _FakeFleet()
        fz = urlopen(base + "/fleetz", timeout=5).read().decode()
        assert "127.0.0.1:7001" in fz and "dead" in fz
        assert "drain windows" in fz
        fj = json.loads(urlopen(base + "/fleetz?json=1",
                                timeout=5).read())
        assert fj["eligible"] == 1 and len(fj["replicas"]) == 3
        mf = urlopen(base + "/metrics", timeout=5).read().decode()
        for line in mf.splitlines():
            if line and not line.startswith("#"):
                assert PROM_LINE_RE.match(line), \
                    "invalid Prometheus line: %r" % line
        assert 'cxxnet_fleet_replicas{process="0"} 3' in mf
        assert 'cxxnet_fleet_replicas_eligible{process="0"} 1' in mf
        assert ('cxxnet_fleet_state{process="0",state="dead"} 1'
                in mf)
        # a held-out standby is its OWN state and NOT "up"/routable —
        # a probe-state "up" must not leak into the replica_up gauge
        assert ('cxxnet_fleet_state{process="0",state="standby"} 1'
                in mf)
        assert ('cxxnet_fleet_state{process="0",state="up"} 1'
                in mf)
        assert ('cxxnet_fleet_replica_up{process="0",'
                'replica="127.0.0.1:7003"} 0' in mf)
        assert ('cxxnet_fleet_replica_up{process="0",'
                'replica="127.0.0.1:7002"} 0' in mf)
        assert ('cxxnet_fleet_replica_queue_depth{process="0",'
                'replica="127.0.0.1:7001"} 2' in mf)

        page = urlopen(base + "/statusz", timeout=5).read().decode()
        assert "statusz" in page and "selftest.requests" in page
        assert "fleet" in page and "eligible" in page
        srv.fleet = None
        # never-fired series renders n/a, not 0.00ms; SLO section shows
        assert "selftest.never_fired" in page and "n/a" in page
        assert "burn rate" in page and "BURNING" in page
        trace = json.loads(urlopen(base + "/trace", timeout=5).read())
        assert any(t.get("ph") == "X" for t in trace["traceEvents"])

        # conservation-law auditor: a law that cannot reconcile latches
        # cxxnet_books_broken on the next scrape (metrics_text sweeps),
        # sticky until an operator resets the auditor
        telemetry.audit_register("selftest.books",
                                 lambda: "debit 3 != credit 2")
        try:
            mb = urlopen(base + "/metrics", timeout=5).read().decode()
            for line in mb.splitlines():
                if line and not line.startswith("#"):
                    assert PROM_LINE_RE.match(line), \
                        "invalid Prometheus line: %r" % line
            assert ('cxxnet_books_broken{process="0",'
                    'law="selftest.books"} 1' in mb)
            assert "cxxnet_books_laws" in mb
            # the latch is sticky: a clean follow-up sweep cannot clear
            mb2 = urlopen(base + "/metrics", timeout=5).read().decode()
            assert ('cxxnet_books_broken{process="0",'
                    'law="selftest.books"} 1' in mb2)
        finally:
            telemetry.audit_unregister("selftest.books")
            telemetry.auditor().reset()

        try:
            urlopen(base + "/nope", timeout=5)
            raise AssertionError("unknown path should 404")
        except HTTPError as e:
            assert e.code == 404
            # the 404 body derives from the ENDPOINTS table
            body = e.read().decode()
            for p, _, _ in ENDPOINTS:
                assert p in body, (p, body)
    finally:
        srv.stop()
        reg.disable()
    if verbose:
        print("statusd selftest: /metrics /healthz /livez /statusz "
              "/trace /requestz /why /eventz ok (Prometheus format "
              "valid, readiness vs liveness flips, per-request trace, "
              "autopsy verdict + incident timeline, books latch, SLO "
              "burn flip, empty-series n/a, 404)")
    return 0


if __name__ == "__main__":
    if "--selftest" in sys.argv[1:]:
        sys.exit(selftest(verbose=True))
    print(__doc__)
    sys.exit(1)
