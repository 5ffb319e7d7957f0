"""The serving SLO account and the status registry of the port: the parts
of cxxnet_tpu/utils/statusd.py that the serving frontend and ``task =
serve`` call.

* ``SLOTracker`` — the rolling-window error-budget account every completed
  request feeds (burn rate, the ``alert`` latch and its ``slo_burn``
  transition events), the JAX package's class unchanged.
* The module-level calls the frontend and the driver make to publish to
  a status server (``register_probe``, ``update_progress``,
  ``set_flight_recorder``, ``set_slo``, ``set_slo_tenants``,
  ``set_batch``): no-ops, as the JAX package's are while no server runs.

The HTTP server itself (``/metrics``, ``/healthz``, ``/trace``,
``/batchz``, ...) is not ported yet: nothing here opens a socket, and the
command line refuses ``status_port`` off -1. Standard library only.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

from . import lockrank
from . import telemetry

__all__ = ["SLOTracker", "update_progress", "register_probe",
           "set_flight_recorder", "set_slo", "set_slo_tenants", "set_batch"]


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
    The ``alert`` flag (the ``cxxnet_slo_burn`` gauge of the JAX
    package's status server, and ``slo_burn`` transition events in the
    telemetry stream) flips to
    1 while burn_rate >= 1 with at least ``min_requests`` in the window
    — the floor keeps one unlucky request over an empty window from
    paging.

    Thread-safe; the serving frontend calls ``observe`` from its worker
    thread, readers call ``snapshot()``.
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




# The status HTTP server is not ported: these are the JAX module's calls
# with no server running, where each is a no-op (cxxnet_tpu/utils/statusd.py
# :2289-2341 with _SERVER None).
def update_progress(**kv) -> None:
    pass


def register_probe(name: str, fn, liveness: bool = False) -> None:
    pass


def set_flight_recorder(fr) -> None:
    pass


def set_slo(tracker: Optional[SLOTracker]) -> None:
    pass


def set_slo_tenants(trackers) -> None:
    pass


def set_batch(frontend) -> None:
    pass
