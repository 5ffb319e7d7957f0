"""The port's fleet router: a health-aware TCP router over servd replicas.

The port's own copy of cxxnet_tpu/utils/routerd.py, whole: the same line
protocol, replica state machine, retry and replay rules, hedging, tenant
gate, federation, autoscaler, rolling reload, counters, flight records and
events, on the port's ``autopsy``, ``checkpoint``, ``health``, ``lockrank``,
``servd`` and ``telemetry``. It imports nothing of ``cxxnet_tpu`` and
calls nothing of ``torch``: the router is a host process that routes lines
to ``task = serve`` replicas (each one a process of its own on its card)
and creates no CUDA context.

It speaks the servd line protocol exactly (one request line in, one
response line out, ``DEADLINE``/``TRACE``/``TENANT``/``ADMIN`` prefixes,
``ERR <class> <detail>``), so a client cannot tell the fleet from a single
replica.

Per-replica state machine, fed by two signal paths:

* **probe path**: a prober thread polls each replica's status server
  ``/healthz`` (readiness) every ``probe_ms`` and classifies:
  200 → ``up`` (and the replica's live ``queue_depth`` / ``in_flight``
  gauges, read through its ``ADMIN stats``, refresh the load estimate),
  503 naming the warm grid → ``warming``, 503 naming a drain →
  ``draining``, any other 503 (breaker open, stalled backend) →
  ``breaker_open``, unreachable → ``dead``.
* **dispatch path**: outcomes seen while routing move the machine without
  waiting a probe interval: connect refused → ``dead``, ``ERR busy
  breaker`` → ``breaker_open``, ``ERR draining`` → ``draining``.

A ``dead`` replica is ejected and re-probed on the shared exponential
backoff schedule (``checkpoint.backoff_delay``); a successful probe
re-admits it and resets the backoff.

Dispatch is least-loaded with power-of-two choices: two eligible replicas
are sampled and the one with the lower load (probed queue_depth +
in_flight plus the router's own outstanding count, minus the replica's
probed free decode slots) wins; ties go to the lower replica index.
``free_slots`` is the continuous-batching capacity a batching replica
reports in ``ADMIN stats``; a replica that omits it counts 0.

**Retry-on-shed, exactly-once kept.** The third token of a servd error
line is a machine-readable detail token, and the router retries a request
on a different replica only when that token proves the request never
dispatched:

    response                     dispatched?   router action
    ------------------------     -----------   -----------------------
    ERR busy queue ...           never         retry elsewhere
    ERR busy breaker ...         never         eject + retry elsewhere
    ERR busy tenant ...          never         relay (no retry: the
                                               fair-share verdict holds
                                               fleet-wide)
    ERR draining server ...      never         mark draining + retry
    ERR draining shutdown ...    never         mark draining + retry
    ERR draining backend ...     MAYBE         relay (no retry)
    ERR backend rescued ...      yes, rescued  REPLAY elsewhere
    ERR backend ...              yes           relay (no retry)
    ERR parse / empty / deadline deterministic relay (no retry)
    connect refused              never         mark dead + retry
    sent, then no response       MAYBE         REPLAY elsewhere (close
                                               the old socket, reap and
                                               discard a late answer)

**Deterministic replay.** Generation is a pure function of (prompt, seed,
model version), so a lost attempt is re-executed on a different replica
(``route.replays``) from the same deadline budget, and the old socket goes
to a reaper that counts and drops a late answer (``route.discarded_late``):
the client never sees two answers. Replay is denied to a tenant over its
fair share (``route.replay_denied``), never applies to ``ADMIN`` traffic,
and refuses to splice generations across a weight push (the replay carries
the lost replica's last reload count; a survivor whose count differs
answers ``ERR backend generation ...``). ``route_replay = 0`` relays the
error instead.

**Tail hedging.** After ``route_hedge_ms`` (at ``-1``, the live federated
serve p99) a still-unanswered first attempt launches one duplicate on
another replica (``route.hedges``); the first served answer wins
(``route.hedge_wins``) and the other is read and dropped. Hedges are
capped at ``route_hedge_max_pct`` of the requests in flight and denied to
over-share tenants.

Retries spend from the client's ``DEADLINE`` budget, parsed once at
accept: every forward carries the budget remaining at that instant, and a
budget that runs out between attempts is answered ``ERR deadline`` by the
router. Without a deadline each attempt is bounded by ``stall_s``.

**Fleet ADMIN.** ``ADMIN stats`` sums every reachable replica's counters.
``ADMIN reload`` starts a rolling reload: one replica at a time is held
out of rotation, its outstanding requests drain, ``ADMIN reload`` is
forwarded, and the replica rejoins once its reload counter moved and
``/healthz`` reads ready, so at most one replica is out at a time. Each
hold is kept as a (replica, out, back) drain window.

The router's counters reconcile: ``accepted == served + errors + shed +
deadline`` (``retries`` and ``admin`` ride outside). ``statusd.set_fleet``
serves ``/fleetz`` and the ``cxxnet_fleet_*`` series from
``fleet_snapshot()``; ``health_probe`` / ``liveness_probe`` plug into
``/healthz`` / ``/livez``.

**Fleet observability.**

* **Trace propagation**: the router mints one fleet-wide request id per
  client request (or adopts a valid client ``TRACE <id>``) and stamps
  ``TRACE <id>`` on every attempt; each replica adopts it as its own id.
  A replica that answers ``ERR parse`` to the prefix is resent the bare
  line once (a parse rejection proves nothing dispatched) and latched
  ``no_trace``.
* **Router flight recorder**: every routed request's life (the
  power-of-two candidates and their loads, each attempt's replica,
  outcome and latency, the deadline spend) lands in a bounded ring
  (``route_flight_cap``). On the router, ``/trace?request=<id>`` returns
  the stitched cross-process Chrome trace (the router's attempt lane plus
  each touched replica's phase lanes, fetched from the replicas'
  ``/requestz?request=<id>`` and aligned on the wall clock), ``/why`` the
  stitched autopsy (``autopsy.stitch_route``) and ``/eventz`` the
  fleet-merged incident timeline. Each request also emits a
  ``route_request_done`` event.
* **Live federation**: every ``fleet_federate_ms`` the prober pulls each
  replica's raw metrics snapshot (``/metrics?json=1``) and merges the
  serve histograms and counters exactly (bucket-count addition over the
  shared fixed buckets) into ``cxxnet_fleet_*`` series: fleet TTFT and
  latency percentiles, a fleet-wide SLO burn account, and an outlier
  detector that flags a replica whose serve p99 is ``fleet_outlier_ratio``
  times the median of the others (leave-one-out, at least
  ``fleet_outlier_min_n`` requests).

**Autoscaler**: ``standby_replicas`` are held out of dispatch; one policy
pass per prober sweep (``autoscale_now``) admits a standby when the fleet
SLO burn reaches ``scale_up_burn`` or work queues with no free decode slot
anywhere (bounded by ``scale_min`` / ``scale_max``), and retires a
scaled-up replica idle for ``scale_down_idle_s``, at most one action per
``scale_cooldown_s``.

**Tenants**: with a ``tenants`` table the router forwards the ``TENANT``
prefix (with the same downgrade ladder as ``TRACE``), keeps per-tenant
books, sheds an over-share tenant at the door when the fleet is
saturated, and merges per-tenant SLO windows and histograms into
``cxxnet_fleet_tenant_*{tenant=}`` series.

Standard library only. ``python -m cxxnet_tpu_torch.utils.routerd
--selftest`` drives routing, retry, ejection, rolling reload and drain
over loopback sockets with in-process servd replicas. It runs as
``task = route`` of ``bin/cxxnet_torch`` (keys ``route_port``,
``route_replicas``, ``route_probe_ms``, ``route_retries``,
``route_stall_s``, ``route_host``, ``route_standby_replicas``,
``route_scale_*``, ``route_tenants``, ``route_replay``, ``route_hedge_*``,
``fleet_*``).
"""
from __future__ import annotations

import json
import random
import re
import socket
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import autopsy
from . import checkpoint as ckpt
from . import health
from . import lockrank
from . import servd
from . import telemetry

__all__ = ["Replica", "Router", "parse_replicas", "retryable",
           "route_chrome_trace", "stitched_chrome_trace",
           "UP", "DRAINING", "WARMING", "BREAKER_OPEN", "DEAD",
           "selftest"]

UP = "up"
DRAINING = "draining"
# warming: the replica's /healthz answers 503 "warming: ..." — its
# warm-grid readiness gate (servd.set_warm_account) is unmet. Probed
# and ADMIN-answering (the warm fraction keeps refreshing onto
# /fleetz) but NOT routed; flips to UP by itself once the grid
# compiles. The autoscaler MAY admit a warming standby — that is
# exactly the "admitted vs useful" gap the scale-up event's warm_pct
# field measures.
WARMING = "warming"
BREAKER_OPEN = "breaker_open"
DEAD = "dead"

# stat key -> telemetry counter (reconciliation mirrors servd's:
# accepted == served + errors + shed + deadline; retries/admin outside)
_COUNTERS = {
    "accepted": "route.accepted",
    "served": "route.served",
    "errors": "route.errors",
    "shed": "route.shed",
    "deadline": "route.deadline",
    "admin": "route.admin",
    "retries": "route.retries",
    "client_gone": "route.client_gone",
    # failover account (module docstring "Deterministic replay
    # failover" / "Tail hedging"): OUTSIDE the reconciling subset like
    # retries — these count extra ATTEMPTS and discarded duplicate
    # answers; the client request is charged exactly once above
    "lost_contact": "route.lost_contact",
    "replays": "route.replays",
    "replay_denied": "route.replay_denied",
    "hedges": "route.hedges",
    "hedge_wins": "route.hedge_wins",
    "discarded_late": "route.discarded_late",
}
# the per-tenant reconciling subset — ONE definition with servd (the
# shared-parser discipline: router and replica books must never
# desynchronize): accepted == served + errors + shed + deadline per
# tenant
_TENANT_KEYS = servd._TENANT_KEYS



def parse_replicas(spec) -> List[Tuple[str, int, int]]:
    """``route_replicas`` conf value -> [(host, serve_port,
    status_port)]. Items are comma/whitespace separated, each
    ``host:serve_port:status_port`` (host defaults to 127.0.0.1 when
    only two fields are given)."""
    if not isinstance(spec, str):
        return list(spec)
    out: List[Tuple[str, int, int]] = []
    for item in re.split(r"[,\s]+", spec.strip()):
        if not item:
            continue
        bits = item.rsplit(":", 2)
        if len(bits) == 2:
            host, port, sport = "127.0.0.1", bits[0], bits[1]
        elif len(bits) == 3:
            host, port, sport = bits
        else:
            raise ValueError(
                "route_replicas item %r is not host:port:status_port"
                % item)
        out.append((host or "127.0.0.1", int(port), int(sport)))
    return out


def retryable(resp: str) -> bool:
    """The retryability half of the wire contract (module docstring):
    True only when the response PROVES the request never dispatched to
    a backend — a shed (``ERR busy``) or a drain refusal that is not
    the drain-gave-up-on-in-flight case (``ERR draining backend``) —
    AND a different replica could rule differently. ``ERR busy
    tenant`` is the exception on the second clause: it never
    dispatched, but it is the weighted-fair POLICY verdict, and every
    replica shares the tenant table — retrying a flooding tenant's
    shed elsewhere only doubles the flood's traffic. Everything else
    stays with the replica: exactly-once beats availability."""
    toks = resp.split()
    if toks[:2] == ["ERR", "busy"]:
        return toks[2:3] != ["tenant"]
    if toks[:2] == ["ERR", "draining"]:
        return toks[2:3] != ["backend"]
    return False


def _http_get(host: str, port: int, path: str,
              timeout: float) -> Tuple[int, str]:
    """Tiny GET helper -> (status, body); raises OSError when the
    endpoint is unreachable (URLError is an OSError)."""
    from urllib.error import HTTPError
    from urllib.request import urlopen
    try:
        with urlopen("http://%s:%d%s" % (host, port, path),
                     timeout=timeout) as resp:
            return resp.status, resp.read().decode("utf-8", "replace")
    except HTTPError as e:
        return e.code, e.read().decode("utf-8", "replace")


class _SloMerge:
    """Accumulate SLOTracker.snapshot() dicts from N replicas into ONE
    merged-window account (requests/bad summed, the tightest budget,
    fleet-wide alert floors) — the shape ``federation_snapshot`` hangs
    on ``slo`` fleet-wide and on ``slo_tenants`` per tenant."""

    def __init__(self):
        self.req = self.bad = 0
        self.budget = None
        self.floor_req = self.floor_bad = 1
        self.seen = False

    def add(self, slo) -> None:
        if not slo:
            return
        self.seen = True
        self.req += int(slo.get("requests", 0))
        self.bad += int(slo.get("bad", 0))
        if slo.get("budget") is not None:
            b = float(slo["budget"])
            self.budget = b if self.budget is None \
                else min(self.budget, b)
        self.floor_req = max(self.floor_req,
                             int(slo.get("min_requests", 1)))
        self.floor_bad = max(self.floor_bad, int(slo.get("min_bad", 1)))

    def result(self):
        if not self.seen or self.budget is None:
            return None
        bad_fraction = self.bad / float(self.req) if self.req else 0.0
        burn = bad_fraction / self.budget
        return {"requests": self.req, "bad": self.bad,
                "budget": round(self.budget, 6),
                "bad_fraction": round(bad_fraction, 6),
                "burn_rate": round(burn, 4),
                "alert": 1 if (self.req >= self.floor_req
                               and self.bad >= self.floor_bad
                               and burn >= 1.0) else 0}


class Replica:
    """One replica's routing state. All mutable fields are guarded by
    the router's fleet lock; the object itself is a dumb record."""

    __slots__ = ("name", "host", "port", "status_port", "state",
                 "detail", "hold", "queue_depth", "in_flight",
                 "free_slots", "has_slots", "kv_blocks_total",
                 "kv_blocks_free", "has_kv_blocks",
                 "kv_retained_blocks", "kv_retained_hits",
                 "has_kv_retained",
                 "warm_programs", "expected_programs", "has_warm",
                 "buckets", "outstanding", "reloads", "lost",
                 "probe_fails", "ejections", "next_probe_at",
                 "last_probe", "no_trace", "trace_ok",
                 "no_tenant", "tenant_ok", "standby", "from_standby")

    def __init__(self, host: str, port: int, status_port: int,
                 standby: bool = False):
        self.host = host
        self.port = int(port)
        self.status_port = int(status_port)
        self.name = "%s:%d" % (host, self.port)
        # optimistic start: routable until a probe or a dispatch says
        # otherwise — a router must not refuse traffic for probe_ms
        # after startup when the fleet is healthy
        self.state = UP
        self.detail = "unprobed (optimistic)"
        self.hold = False            # rolling reload: out of rotation
        self.queue_depth = 0         # last probed gauges (load signal)
        self.in_flight = 0
        self.free_slots = 0          # continuous-batching capacity: a
        #                              batching replica reports free
        #                              decode slots; old replicas omit
        #                              the field (0 = no bonus)
        self.has_slots = False       # whether the replica REPORTS
        #                              free_slots at all — absent means
        #                              no batching, and 0 must then read
        #                              as "unknown", not "saturated"
        self.kv_blocks_total = 0     # paged-KV pool level from ADMIN
        self.kv_blocks_free = 0      # stats (kv_blocks_total/free):
        #                              process-global (the pool is
        #                              shared across buckets), so the
        #                              fleet sum is exact. Absent on
        #                              dense/pre-paging replicas —
        self.has_kv_blocks = False   # the same absence-is-the-
        #                              capability-signal discipline as
        #                              free_slots
        self.kv_retained_blocks = 0  # retained conversation cache
        self.kv_retained_hits = 0    # (ADMIN kv_retained_blocks/
        #                              kv_retained_hits): refcount-0
        #                              blocks parked for revival and
        #                              the lifetime revival count —
        #                              absent on pre-retention
        self.has_kv_retained = False  # replicas ("-", never 0)
        self.warm_programs = 0       # warm-grid readiness from ADMIN
        self.expected_programs = 0   # stats (compiled vs expected
        #                              serving programs) — the /fleetz
        #                              warm column and the scale-up
        #                              event's warm_pct read these.
        self.has_warm = False        # absent on replicas with no
        #                              declared grid: "-", never 0%
        self.buckets = {}            # per-bucket load signal from
        #                              ADMIN stats (bucket.<b>.warm /
        #                              .active): {b: {"warm", "active"}}
        #                              — what /fleetz shows and
        #                              disaggregated scheduling will
        #                              route on; empty pre-batching
        self.outstanding = 0         # router-side live request count
        self.reloads = -1            # model generation: the replica's
        #                              ADMIN stats reload count, -1
        #                              until probed — the replay
        #                              failover's generation guard
        #                              compares the lost replica's
        #                              against the survivor's
        self.lost = 0                # lost-contact attempts charged to
        #                              this replica (the /fleetz
        #                              failover column)
        self.probe_fails = 0
        self.ejections = 0           # backoff exponent while dead
        self.next_probe_at = 0.0     # monotonic; dead replicas re-probe
        #                              on the backoff schedule only
        self.last_probe: Optional[float] = None
        # pre-TRACE replica latch (module docstring): once a TRACE
        # prefix was proven unsupported (ERR parse on the traced line,
        # success on the bare resend) forwards skip the prefix; cleared
        # on re-admission from DEAD (a restart may have upgraded it).
        # trace_ok is the POSITIVE latch: one traced exchange answered
        # by anything but ERR parse proves the replica parsed the
        # prefix, so later ERR parse answers are genuine client body
        # errors and never pay the downgrade resend (also cleared on
        # re-admission — a rollback may have downgraded the binary)
        self.no_trace = False
        self.trace_ok = False
        # the TENANT prefix's pre-tenant latch pair — exactly the TRACE
        # discipline: no_tenant after a proven downgrade, tenant_ok
        # after a proven parse, both re-learned on DEAD -> UP
        self.no_tenant = False
        self.tenant_ok = False
        # autoscaler state: a standby replica is listed in the conf but
        # held OUT of dispatch until a scale-up admits it; from_standby
        # marks scale-up admits as the ones a scale-down may retire
        # (the fleet returns to its configured shape when idle)
        self.standby = bool(standby)
        self.from_standby = bool(standby)

    def backlog(self) -> int:
        """Work waiting at the replica: its probed queue depth or, on a
        solo replica (no ``free_slots`` signal, one request at a time),
        the router's own requests to it beyond the one it runs, whichever
        is larger. The probe is up to one probe interval old; the
        outstanding count is live (fleet-lock caller)."""
        if self.has_slots:
            return self.queue_depth
        return max(self.queue_depth, self.outstanding - 1)

    def warm_pct(self) -> Optional[float]:
        """Warm fraction of the replica's expected program grid, or
        None when it reports no grid (fleet-lock caller)."""
        if not self.has_warm or self.expected_programs <= 0:
            return None
        return round(100.0 * self.warm_programs
                     / self.expected_programs, 1)

    def snapshot(self, now: float) -> dict:
        return {"name": self.name, "state": self.state,
                "standby": self.standby,
                "detail": self.detail, "hold": self.hold,
                "queue_depth": self.queue_depth,
                "in_flight": self.in_flight,
                "free_slots": self.free_slots,
                "kv_blocks_total": self.kv_blocks_total
                if self.has_kv_blocks else None,
                "kv_blocks_free": self.kv_blocks_free
                if self.has_kv_blocks else None,
                "kv_retained_blocks": self.kv_retained_blocks
                if self.has_kv_retained else None,
                "kv_retained_hits": self.kv_retained_hits
                if self.has_kv_retained else None,
                "warm_programs": self.warm_programs
                if self.has_warm else None,
                "expected_programs": self.expected_programs
                if self.has_warm else None,
                "warm_pct": self.warm_pct(),
                "buckets": {str(b): dict(d) for b, d
                            in sorted(self.buckets.items())},
                "outstanding": self.outstanding,
                "reloads": self.reloads if self.reloads >= 0 else None,
                "lost": self.lost,
                "ejections": self.ejections,
                "probe_fails": self.probe_fails,
                "last_probe_age_s": None if self.last_probe is None
                else round(now - self.last_probe, 3)}


class Router:
    """The fleet router. ``replicas`` is a ``parse_replicas`` spec (or
    its output). Lifecycle mirrors servd: ``start()`` (prober thread) →
    ``listen(port)`` (accept thread) → ``drain()``.

    Client connections are handled one request at a time per connection
    (the positional line protocol pairs responses to requests, and the
    forward is synchronous), so fleet concurrency comes from concurrent
    connections — exactly the shape of the serving chaos harness."""

    def __init__(self, replicas, probe_ms: float = 200.0,
                 retries: int = 2, stall_s: float = 30.0,
                 drain_ms: float = 5000.0,
                 connect_timeout: float = 1.0,
                 probe_timeout: float = 1.0,
                 client_timeout: float = 10.0,
                 probe_backoff_cap_s: float = 30.0,
                 reload_timeout_s: float = 30.0,
                 flight_cap: int = 256,
                 federate_ms: float = 1000.0,
                 outlier_ratio: float = 3.0,
                 outlier_min_n: int = 20,
                 standby_replicas=None,
                 scale_min: int = 0, scale_max: int = 0,
                 scale_up_burn: float = 1.0,
                 scale_down_idle_s: float = 30.0,
                 scale_cooldown_s: float = 10.0,
                 tenants=None, tenant_default: str = "default",
                 slo_tenants=None,
                 replay: bool = True,
                 hedge_ms: float = 0.0,
                 hedge_max_pct: float = 10.0):
        specs = parse_replicas(replicas)
        if not specs:
            raise ValueError("router needs at least one replica")
        self._replicas = [Replica(*s) for s in specs]
        # autoscaler (module docstring "Fleet autoscaling"): standby
        # replicas ride the same probe/state machinery but are held out
        # of dispatch until autoscale_now() admits one; bounds default
        # to [primary count, total count]
        standby_specs = parse_replicas(standby_replicas or [])
        self._replicas += [Replica(*s, standby=True)
                           for s in standby_specs]
        n_primary = len(specs)
        self.scale_min = int(scale_min) if scale_min > 0 else n_primary
        self.scale_max = int(scale_max) if scale_max > 0 \
            else len(self._replicas)
        self.scale_up_burn = float(scale_up_burn)
        self.scale_down_idle_s = float(scale_down_idle_s)
        self.scale_cooldown_s = float(scale_cooldown_s)
        # scale decisions + idle bookkeeping live under their own rank
        # (lockrank "routerd.scale", OUTSIDE the fleet lock: a decision
        # reads fleet state and then marks replicas under it); all IO —
        # probing a standby before admitting it — stays outside
        self._scale_lock = lockrank.lock("routerd.scale")
        self._scale_last = -float("inf")   # monotonic of last action
        self._scale_events = 0
        self._scale_log: List[dict] = []
        self._idle_since: Dict[str, float] = {}
        # multi-tenant weighted-fair QoS: the shared tenant table (one
        # parse_tenants implementation with servd — the processes
        # enforcing fairness must agree on it)
        self._tenants = servd.parse_tenants(tenants)
        self.tenant_default = str(tenant_default)
        if self._tenants and self.tenant_default not in self._tenants:
            self._tenants[self.tenant_default] = 1.0
        self._tstats: Dict[str, Dict[str, int]] = {
            t: {k: 0 for k in _TENANT_KEYS} for t in self._tenants}
        self._tenant_active: Dict[str, int] = {
            t: 0 for t in self._tenants}
        # per-tenant SLO trackers for requests that NEVER touched a
        # replica (door sheds — the fair-share gate, no-routable-fleet,
        # router-side deadline): every replica-touching request is
        # already in some replica's own window, so observing only the
        # zero-attempt outcomes here keeps the federated merge
        # double-count-free while a flood shed entirely at the router's
        # door still burns ITS tenant's fleet-wide budget (the
        # burn-reads-0-under-total-overload trap, the router edition)
        self.slo_tenants = dict(slo_tenants or {})
        self.probe_s = max(0.01, float(probe_ms) / 1e3)
        self.retries = max(0, int(retries))
        self.stall_s = float(stall_s)
        self.drain_ms = float(drain_ms)
        self.connect_timeout = float(connect_timeout)
        self.probe_timeout = float(probe_timeout)
        self.client_timeout = float(client_timeout)
        self.probe_backoff_cap_s = float(probe_backoff_cap_s)
        self.reload_timeout_s = float(reload_timeout_s)
        # federation cadence (0 disables) + outlier thresholds: a
        # replica whose serve p99 exceeds outlier_ratio x the median
        # of the OTHER replicas (with >= outlier_min_n observations
        # behind it) is flagged — conf keys fleet_federate_ms /
        # fleet_outlier_*
        self.federate_s = max(0.0, float(federate_ms) / 1e3)
        self.outlier_ratio = float(outlier_ratio)
        self.outlier_min_n = max(1, int(outlier_min_n))
        # ranked locks (utils/lockrank.py): fleet state outermost, then
        # stats — both may record telemetry (registry is innermost)
        self._lock = lockrank.lock("routerd.fleet")
        self._slock = lockrank.lock("routerd.stats")
        # federated per-replica metric snapshots + outlier verdicts
        # (written by the prober's federation sweep, read per scrape)
        self._fed_lock = lockrank.lock("routerd.fed")
        self._fed: Dict[str, dict] = {}
        self._fed_outlier: Dict[str, dict] = {}
        self._fed_at = 0.0
        # the routing flight recorder: one record per routed request —
        # candidates at pick time, per-attempt replica/outcome/latency,
        # deadline spend (statusd /requestz + the /trace stitch source)
        self.flight = telemetry.FlightRecorder(flight_cap)
        # fleet-wide trace-id minting: a short random prefix makes ids
        # from a restarted (or second) router distinguishable without
        # coordination; the counter rides the stats lock
        self._trace_prefix = "r%05x" % random.randrange(16 ** 5)
        self._trace_n = 0
        self._stats = {k: 0 for k in _COUNTERS}
        # failover knobs (module docstring "Deterministic replay
        # failover" / "Tail hedging"): replay gates the lost->replay
        # path, hedge_ms the duplicate-attempt delay (0 off, -1 = live
        # federated serve p99), hedge_max_pct the in-flight hedge cap
        self.replay = bool(replay)
        self.hedge_ms = float(hedge_ms)
        self.hedge_max_pct = float(hedge_max_pct)
        self._hedge_auto_s: Optional[float] = None  # GIL-atomic store,
        #                              written by the federation sweep
        self._hedges_live = 0        # under _slock: duplicate attempts
        #                              currently in flight (the cap)
        self._draining = False
        self._stop = False
        self._active = 0             # requests currently being handled
        self._reloading = False
        self._windows: List[Tuple[str, float, float]] = []
        self._wake = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._sock: Optional[socket.socket] = None
        self.port: Optional[int] = None

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "Router":
        telemetry.declare_hist("route.request")
        telemetry.gauge("route.replicas", len(self._replicas))
        telemetry.gauge("route.replicas_up", len(self._replicas))
        telemetry.audit_register("route.books", self._law_books)
        telemetry.audit_register("route.tenant_books",
                                 self._law_tenant_books)
        telemetry.audit_register("fleet.federation",
                                 self._law_federation)
        self._probe_thread = threading.Thread(
            target=self._prober_run, name="cxn-routerd-probe",
            daemon=True)
        self._probe_thread.start()
        return self

    def listen(self, port: int = 0, host: str = "") -> int:
        self._sock = socket.create_server((host or "127.0.0.1",
                                           int(port)))
        self._sock.settimeout(0.25)
        self.port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_run, name="cxn-routerd-accept",
            daemon=True)
        self._accept_thread.start()
        telemetry.event({"ev": "route_listen", "port": self.port,
                         "replicas": [r.name for r in self._replicas]})
        return self.port

    def stats(self) -> dict:
        with self._slock:
            return dict(self._stats)

    def _bump(self, *names: str) -> None:
        with self._slock:
            for name in names:
                self._stats[name] += 1
        for name in names:
            telemetry.count(_COUNTERS[name])

    # -- conservation laws (telemetry.BooksAuditor) --------------------
    def _law_books(self) -> Optional[str]:
        """``accepted == served + errors + shed + deadline`` up to the
        requests in flight. _handle's ordering makes both directions
        sound: the active slot is claimed BEFORE accepted is bumped and
        released AFTER the outcome lands, so at every instant
        ``active >= accepted - outcomes`` — outcomes exceeding accepted
        is an immediate violation, the forward direction must persist
        across stable-snapshot brackets (a bracket the books moved
        through is inconclusive, never a latch)."""
        detail = None
        for _ in range(6):
            with self._slock:
                s1 = dict(self._stats)
            with self._lock:
                active = self._active
            with self._slock:
                s2 = dict(self._stats)
            if s1 != s2:
                return None          # the books moved mid-bracket
            a = s1["accepted"]
            o = (s1["served"] + s1["errors"] + s1["shed"]
                 + s1["deadline"])
            if o > a:
                return ("route books: outcomes %d exceed accepted %d "
                        "(served %d + errors %d + shed %d + deadline "
                        "%d)" % (o, a, s1["served"], s1["errors"],
                                 s1["shed"], s1["deadline"]))
            if a <= o + active:
                return None
            detail = ("route books: accepted %d != outcomes %d + "
                      "in-flight %d" % (a, o, active))
            time.sleep(0.005)        # let an in-limbo answer land
        return detail

    def _law_tenant_books(self) -> Optional[str]:
        """Per outcome key, the tenant charges sum to at most the
        door's own books — exact, because ONE stats-lock snapshot
        covers both, and _handle bumps the global counter BEFORE the
        tenant's for accepted and outcome alike."""
        if not self._tenants:
            return None
        with self._slock:
            g = dict(self._stats)
            ts = {t: dict(st) for t, st in self._tstats.items()}
        for k in _TENANT_KEYS:
            tot = sum(st[k] for st in ts.values())
            if tot > g[k]:
                return ("route tenant books: tenant %s charges sum to "
                        "%d, the door counted %d" % (k, tot, g[k]))
        return None

    def _law_federation(self) -> Optional[str]:
        """Every federated fleet counter equals the sum of the stored
        replica feeds — the merge must never invent or lose a count.
        Recomputed from the SAME stored snapshots the snapshot method
        reads; a federation sweep landing mid-check makes the bracket
        inconclusive (epoch recheck), never a latch."""
        with self._fed_lock:
            if not self._fed:
                return None
            at1 = self._fed_at
            feeds = [d["snap"] for d in self._fed.values()]
        snap = self.federation_snapshot()
        with self._fed_lock:
            if self._fed_at != at1:
                return None          # a sweep landed mid-check
        if snap is None:
            return None
        expect: Dict[str, float] = {}
        for s in feeds:
            for cname, v in ((s.get("metrics") or {})
                             .get("counters") or {}).items():
                if cname.startswith("serve.") \
                        and isinstance(v, (int, float)):
                    expect[cname] = expect.get(cname, 0) + v
        got = snap.get("counters") or {}
        for cname, v in expect.items():
            if got.get(cname, 0) != v:
                return ("federation books: fleet %s = %r != sum of "
                        "replica feeds %r"
                        % (cname, got.get(cname, 0), v))
        return None

    # -- health (statusd probes) ---------------------------------------
    def health_probe(self) -> Tuple[bool, str]:
        """Readiness: the router can place a request somewhere."""
        if self._draining:
            return False, "draining: not accepting new requests"
        with self._lock:
            n = sum(1 for r in self._replicas
                    if r.state == UP and not r.hold
                    and not r.standby)
            total = len(self._replicas)
        if n == 0:
            return False, ("no routable replica (0 of %d up)" % total)
        return True, "routing to %d of %d replicas" % (n, total)

    def liveness_probe(self) -> Tuple[bool, str]:
        t = self._probe_thread
        if t is not None and not t.is_alive() and not self._stop:
            return False, "router prober thread died"
        return True, "alive"

    # -- fleet snapshot (statusd /fleetz + cxxnet_fleet_* series) ------
    def fleet_snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            reps = [r.snapshot(now) for r in self._replicas]
            eligible = sum(1 for r in self._replicas
                           if r.state == UP and not r.hold
                           and not r.standby)
            windows = [{"replica": n, "out_s": round(a, 3),
                        "back_s": round(b, 3)}
                       for n, a, b in self._windows[-32:]]
            body = {"replicas": reps, "eligible": eligible,
                    "draining": self._draining,
                    "reloading": self._reloading,
                    "windows": windows}
        body["stats"] = self.stats()
        fed = self.federation_snapshot()
        if fed is not None:
            body["federation"] = fed
            for rsnap in reps:
                v = fed["outliers"].get(rsnap["name"])
                if v is not None:
                    rsnap["outlier"] = v["outlier"]
                    rsnap["p99_ms"] = v["p99_ms"]
        if self.scaling_enabled():
            body["scale"] = self.scale_snapshot()
        if self._tenants:
            # one per-tenant table joining the router's own books, the
            # federated fleet books, and the per-tenant fleet SLO — the
            # /fleetz "tenants" section and the cxxnet_fleet_tenant_*
            # label rows render from exactly this
            tstats = self.tenant_stats()
            ften = (fed or {}).get("tenants") or {}
            fslo = (fed or {}).get("slo_tenants") or {}
            body["tenants"] = {
                t: {"weight": self._tenants[t],
                    "router": tstats.get(t) or {},
                    "fleet": ften.get(t) or {},
                    "slo": fslo.get(t),
                    "p99_ms": (ften.get(t) or {}).get("p99_ms")}
                for t in sorted(self._tenants)}
        return body

    # -- replica state machine (fleet lock) ----------------------------
    def _mark(self, r: Replica, state: str, detail: str) -> None:
        """Move one replica's state machine; emits a transition event
        (never per-observation spam). Lock taken here — callers must
        NOT hold the fleet lock (the event emission nests registry
        under fleet, which the rank order allows, but the IO callers
        around this must stay lock-free)."""
        with self._lock:
            prev = r.state
            r.state = state
            r.detail = detail
            if state == UP and prev == DEAD:
                # re-admission after death: the process may have been
                # restarted on a newer (or OLDER) build — re-learn its
                # TRACE capability from scratch
                r.no_trace = False
                r.trace_ok = False
                r.no_tenant = False
                r.tenant_ok = False
            if state == DEAD:
                # ejection: re-probe on the shared backoff curve; each
                # consecutive failure doubles the wait
                r.next_probe_at = time.monotonic() + ckpt.backoff_delay(
                    r.ejections, base_delay=self.probe_s,
                    cap=self.probe_backoff_cap_s)
                r.ejections += 1
                r.probe_fails += 1
            elif state == UP:
                r.ejections = 0
                r.probe_fails = 0
            up = sum(1 for x in self._replicas if x.state == UP)
            changed = prev != state
            if changed:
                telemetry.count("route.transitions")
                telemetry.event({"ev": "route_replica",
                                 "replica": r.name, "state": state,
                                 "prev": prev, "detail": detail[:120]})
        if changed:
            telemetry.gauge("route.replicas_up", up)

    # -- prober --------------------------------------------------------
    def probe_now(self) -> None:
        """One synchronous probe sweep (tests, and ``task = route``'s
        initial fleet check) — same classification as the prober thread."""
        for r in list(self._replicas):
            with self._lock:
                if r.state == DEAD and \
                        time.monotonic() < r.next_probe_at:
                    continue             # still backing off
                host, sport = r.host, r.status_port
            self._probe_one(r, host, sport)

    def _probe_one(self, r: Replica, host: str, sport: int) -> None:
        # ALL IO lock-free; the classification lands via _mark
        try:
            code, body = _http_get(host, sport, "/healthz",
                                   self.probe_timeout)
        except OSError as e:
            self._mark(r, DEAD, "statusd unreachable: %r" % (e,))
            return
        with self._lock:
            r.last_probe = time.monotonic()
        if code == 200:
            self._refresh_load(r)
            self._mark(r, UP, "ready")
        else:
            lower = body.lower()
            if "draining" in lower:
                self._mark(r, DRAINING, body.strip()[:120])
            elif "warming" in lower:
                # warm-grid gate unmet (servd.set_warm_account): out
                # of rotation like breaker_open, but the replica's
                # ADMIN surface is live — keep refreshing its load and
                # warm counts so /fleetz shows the warm fraction
                # CLIMB, not a stale snapshot from admission time
                self._refresh_load(r)
                self._mark(r, WARMING, body.strip()[:120])
            else:
                # breaker open, stalled backend, anomaly: unready for a
                # cause other than drain — grouped as breaker_open (out
                # of rotation until a ready probe; statusd reachable,
                # so no backoff ejection)
                self._mark(r, BREAKER_OPEN, body.strip()[:120])

    def _refresh_load(self, r: Replica) -> None:
        """Refresh one replica's load/capability signals from its own
        ADMIN stats (the live queue_depth/in_flight gauges, read under
        its admission lock): per-replica-exact even when replicas
        share one telemetry registry in-process, and far cheaper than
        a /metrics scrape (which runs the replica's whole probe pass +
        registry snapshot per poll). The same gauges ride /metrics for
        dashboards. IO lock-free; the update lands under the fleet
        lock."""
        st = self._replica_stats(r)
        if st is None:
            return
        with self._lock:
            r.queue_depth = st.get("queue_depth", r.queue_depth)
            r.in_flight = st.get("in_flight", r.in_flight)
            # model generation (reload count): the replay failover's
            # generation guard — defensive parse, same reason as below
            if "reloads" in st:
                try:
                    r.reloads = int(st["reloads"])
                except (TypeError, ValueError):
                    pass
            # absent on pre-batching replicas: reset to 0, not
            # last-known — the field IS the capability signal
            r.free_slots = st.get("free_slots", 0)
            r.has_slots = "free_slots" in st
            # paged-KV pool level: same absent-means-dense
            # discipline, and the same defensive parse — a
            # foreign replica may emit any value shape, and an
            # exception here would kill the prober for good
            try:
                r.kv_blocks_total = int(st.get("kv_blocks_total", 0))
                r.kv_blocks_free = int(st.get("kv_blocks_free", 0))
            except (TypeError, ValueError):
                r.kv_blocks_total = r.kv_blocks_free = 0
            r.has_kv_blocks = "kv_blocks_total" in st
            # retained conversation cache: same absent-means-
            # no-retention discipline, same defensive parse — garbage
            # from a foreign replica must not kill the prober
            try:
                r.kv_retained_blocks = int(
                    st.get("kv_retained_blocks", 0))
                r.kv_retained_hits = int(
                    st.get("kv_retained_hits", 0))
            except (TypeError, ValueError):
                r.kv_retained_blocks = r.kv_retained_hits = 0
            r.has_kv_retained = "kv_retained_blocks" in st
            # warm-grid readiness (warm_programs/expected_programs):
            # the compile-cliff account — absent on replicas with no
            # declared grid, and the same defensive parse
            try:
                r.warm_programs = int(st.get("warm_programs", 0))
                r.expected_programs = int(
                    st.get("expected_programs", 0))
            except (TypeError, ValueError):
                r.warm_programs = r.expected_programs = 0
            r.has_warm = "expected_programs" in st
            # per-bucket warm/active counts (bucket.<b>.warm /
            # bucket.<b>.active): the per-bucket load signal —
            # wholesale replacement, same absent-means-none
            # discipline as free_slots
            buckets: Dict[int, dict] = {}
            for k, v in st.items():
                if not k.startswith("bucket."):
                    continue
                # defensive parse: a foreign/old replica may
                # emit any 'bucket.*' shape, and a ValueError
                # here would kill the prober thread for good
                parts = k.split(".")
                if len(parts) != 3 \
                        or parts[2] not in ("warm", "active",
                                            "blocks_held"):
                    continue
                try:
                    buckets.setdefault(
                        int(parts[1]), {})[parts[2]] = v
                except ValueError:
                    continue
            r.buckets = buckets

    def _prober_run(self) -> None:
        # wait FIRST: replicas start optimistic (routable), so the
        # sweep is refresh, not gate — and a caller that wants a
        # verified fleet before serving calls probe_now() itself
        while True:
            health.beat("route.probe")
            self._wake.wait(self.probe_s)
            with self._lock:
                if self._draining or self._stop:
                    break
            self.probe_now()
            if self.federate_s > 0:
                with self._fed_lock:
                    due = (time.monotonic() - self._fed_at
                           >= self.federate_s)
                if due:
                    self.federate_now()
            # the control-plane half: every sweep's fresh signals feed
            # one autoscale policy pass (no-op without standbys; its
            # own cooldown is the hysteresis)
            self.autoscale_now()
        health.pause("route.probe")

    # -- dispatch ------------------------------------------------------
    def _load(self, r: Replica) -> float:
        # free decode slots SUBTRACT: a request a replica can batch
        # into its running decode pass costs no queueing there — the
        # power-of-two pick prefers the replica that can batch it in
        # (may go negative: idle batching capacity beats idle solo)
        return (r.queue_depth + r.in_flight + r.outstanding
                - r.free_slots)

    def _pick(self, exclude) -> Tuple[Optional[Replica], List[dict]]:
        """Power-of-two-choices among eligible replicas (up, not held,
        not yet tried for this request); the checked-out replica's
        outstanding count is bumped under the same lock so concurrent
        picks see each other's load. Also returns the sampled
        candidates' load signals AT PICK TIME — the flight record keeps
        them, so a routing decision stays explainable after the fact."""
        with self._lock:
            elig = [r for r in self._replicas
                    if r.state == UP and not r.hold and not r.standby
                    and r.name not in exclude]
            if not elig:
                return None, []
            if len(elig) == 1:
                r = elig[0]
                sample = [r]
            else:
                a, b = random.sample(elig, 2)
                sample = [a, b]
                la, lb = self._load(a), self._load(b)
                if la == lb:
                    # deterministic tie-break: the lower replica index
                    # (selftest + zero-load behavior must not flap)
                    r = a if self._replicas.index(a) \
                        < self._replicas.index(b) else b
                else:
                    r = a if la < lb else b
            cands = [{"replica": x.name, "load": self._load(x),
                      "queue_depth": x.queue_depth,
                      "in_flight": x.in_flight,
                      "free_slots": x.free_slots,
                      "outstanding": x.outstanding} for x in sample]
            r.outstanding += 1
            return r, cands

    def _checkin(self, r: Replica) -> None:
        with self._lock:
            r.outstanding = max(0, r.outstanding - 1)

    def _forward_keep(self, r: Replica, line: str, timeout: float
                      ) -> Tuple[str, Optional[str], Optional[socket.socket]]:
        """One attempt against one replica -> (status, response, sock):
        ``ok`` (a response line), ``noconnect`` (the request never
        left: SAFE to retry), ``lost`` (sent, then EOF/timeout: the
        request MAY have dispatched). On a read TIMEOUT the still-open
        socket is returned so the replay path can reap — and count —
        a late answer (``route.discarded_late``); on EOF/send failure
        there is nothing to reap and sock is None. A fresh connection
        per attempt: a pooled socket into a replica that died between
        requests would turn an innocent request into a false 'lost'."""
        try:
            c = socket.create_connection((r.host, r.port),
                                         timeout=self.connect_timeout)
        except OSError:
            return "noconnect", None, None
        keep = False
        try:
            c.settimeout(max(0.05, timeout))
            try:
                c.sendall((line + "\n").encode("utf-8", "replace"))
                resp = c.makefile("r", encoding="utf-8").readline()
            except socket.timeout:
                # subclass of OSError — MUST be caught first: a timeout
                # means the replica may still answer on this socket
                keep = True
                return "lost", None, c
            except OSError:
                return "lost", None, None
            if not resp:
                return "lost", None, None
            return "ok", resp.rstrip("\n"), None
        finally:
            if not keep:
                try:
                    c.close()
                except OSError:
                    pass

    def _forward(self, r: Replica, line: str,
                 timeout: float) -> Tuple[str, Optional[str]]:
        """_forward_keep without the reapable socket (probes, ADMIN):
        any kept socket is closed — a late probe answer has no replay
        to feed."""
        status, resp, sock = self._forward_keep(r, line, timeout)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        return status, resp

    def _reap_socket(self, sock: socket.socket, rname: str, tid: str,
                     grace_s: float) -> None:
        """Drain a lost attempt's kept socket in the background: a late
        answer arriving after the request was replayed elsewhere is
        discarded and COUNTED (route.discarded_late) — the observable
        half of the exactly-once-to-the-client guarantee. Always closes
        the socket; daemon thread, never joined (drain does not wait on
        a dead replica's silence)."""
        def run():
            late = False
            try:
                sock.settimeout(max(0.05, grace_s))
                late = bool(sock.makefile(
                    "r", encoding="utf-8").readline())
            except OSError:
                pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
            if late:
                self._bump("discarded_late")
                telemetry.event({"ev": "route_discarded_late",
                                 "replica": rname, "request": tid})
        threading.Thread(target=run, name="cxn-routerd-reap",
                         daemon=True).start()

    def _mint_trace_id(self) -> str:
        """One fleet-wide request id (router prefix + counter): valid
        per the shared servd contract, unique per router lifetime."""
        with self._slock:
            self._trace_n += 1
            return "%s-%d" % (self._trace_prefix, self._trace_n)

    def _bump_tenant(self, tenant: Optional[str], *names: str) -> None:
        """Per-tenant half of _bump (the reconciling subset) plus the
        ``route.tenant.<t>.<key>`` telemetry mirror — tenant names are
        conf-bounded, so the series set is too."""
        if not self._tenants or tenant not in self._tstats:
            return
        keys = [n for n in names if n in _TENANT_KEYS]
        if not keys:
            return
        with self._slock:
            st = self._tstats[tenant]
            for k in keys:
                st[k] += 1
        for k in keys:
            telemetry.count("route.tenant.%s.%s" % (tenant, k))

    def tenant_stats(self) -> dict:
        with self._slock:
            return {t: dict(st) for t, st in self._tstats.items()}

    def _tenant_gate(self, tenant: Optional[str]) -> Optional[str]:
        """The router's weighted-fair admission check: when the fleet
        is SATURATED — every eligible replica either has a queued
        backlog (``Replica.backlog``: the probed queue depth, or on a
        solo replica the router's own live requests beyond the one it
        runs), or (a batching replica, which reports ``free_slots``)
        is busy with zero free decode slots; a merely-busy solo replica
        with nothing waiting is NOT saturated — a tenant already holding
        at least its weighted fair share of the router's in-flight
        requests is shed at the door: third token ``tenant``, the
        policy verdict that holds fleet-wide under the shared tenant
        table (never retried: every replica would rule the same way).
        The share is computed over the tenants ACTIVE right now
        (work-conserving, like _FairQueue's borrow rule: the only
        sending tenant owns the whole fleet — an idle tenant's share is
        never reserved against live traffic), and is floored at 1, so
        a tenant with nothing in flight is never gated. An unsaturated
        fleet admits everyone — fairness never taxes an idle fleet.
        Returns the shed line, or None to admit."""
        if not self._tenants or tenant is None:
            return None
        with self._lock:
            elig = [r for r in self._replicas
                    if r.state == UP and not r.hold and not r.standby]
            saturated = bool(elig) and all(
                r.backlog() > 0
                or (r.has_slots and r.free_slots <= 0
                    and (r.in_flight + r.outstanding) > 0)
                for r in elig)
        if not saturated:
            return None
        with self._slock:
            active = dict(self._tenant_active)
        total = sum(active.values()) + 1      # the arrival included
        live = {t for t, n in active.items() if n > 0}
        live.add(tenant)
        weight_sum = sum(self._tenants[t] for t in live)
        share = max(1, int(total * self._tenants[tenant] / weight_sum))
        mine = active.get(tenant, 0)
        if mine < share:
            return None
        return ("ERR busy tenant %s over fair share (router: %d "
                "in flight / share %d, fleet saturated)"
                % (tenant, mine, share))

    def _handle(self, line: str) -> str:
        """Route one request line; returns the one response line."""
        parts = line.split()
        # trace propagation: adopt a valid client-sent TRACE id (a
        # request already named upstream keeps its name through this
        # hop — router-of-routers composes), refuse a malformed one
        # with the same ERR proto a replica would (ONE shared checker:
        # servd.parse_trace_prefix), mint otherwise
        tid, proto_detail, parts = servd.parse_trace_prefix(parts)
        # the tenant prefix rides the same discipline (one shared
        # checker: servd.parse_tenant_prefix; TRACE first, then TENANT,
        # then DEADLINE). tenant_sent is the id to FORWARD — a
        # defaulted tenant stays off the wire so prefix-less clients
        # hit the replica byte-identically to the pre-tenant protocol
        tenant_sent = None
        if proto_detail is None:
            tenant_sent, proto_detail, parts = \
                servd.parse_tenant_prefix(parts)
            if proto_detail is None and tenant_sent is not None \
                    and self._tenants \
                    and tenant_sent not in self._tenants:
                proto_detail = ("tenant %s is not in the configured "
                                "tenant table" % tenant_sent)
        # the accounted tenant: None on a protocol violation (nothing
        # to charge a malformed/unknown id to), the configured default
        # for prefix-less clients otherwise
        tenant = None
        if proto_detail is None:
            tenant = tenant_sent
            if tenant is None and self._tenants:
                tenant = self.tenant_default
        proto_err = None if proto_detail is None \
            else "ERR proto " + proto_detail
        if proto_err is None and parts and parts[0] == "ADMIN":
            return self._handle_admin(parts[1:])
        t0 = time.monotonic()
        # parse the deadline ONCE at accept: every retry spends from
        # this clock. A malformed bound is forwarded untouched — the
        # replica's parser answers ERR parse (one implementation).
        deadline = None
        deadline_ms: Optional[float] = None
        rest = parts
        if parts[:1] == ["DEADLINE"] and len(parts) >= 2:
            try:
                budget = float(parts[1]) / 1e3
            except ValueError:
                budget = None
            if budget is not None and 0 <= budget < float("inf"):
                deadline = t0 + budget
                deadline_ms = budget * 1e3
                rest = parts[2:]
        # admission + accounting in one critical section with drain()'s
        # flag flip (the servd rule): a post-drain arrival is refused
        # WITHOUT entering the accounting
        with self._lock:
            if self._draining or self._stop:
                return "ERR draining router is shutting down"
            self._active += 1
        self._bump("accepted")
        self._bump_tenant(tenant, "accepted")
        if tid is None:
            tid = self._mint_trace_id()
        tracked = bool(self._tenants) and tenant is not None
        try:
            attempts: List[dict] = []
            if proto_err is not None:
                text, outcome = proto_err, "errors"
            else:
                # the weighted-fair admission gate BEFORE any replica
                # is touched: a saturated fleet sheds the over-share
                # tenant at the router's door instead of burning a
                # replica queue slot (and a retry) on a verdict every
                # replica would reach anyway
                gate = self._tenant_gate(tenant)
                if gate is not None:
                    text, outcome = gate, "shed"
                else:
                    if tracked:
                        with self._slock:
                            self._tenant_active[tenant] += 1
                    try:
                        text, outcome = self._route(
                            tid, rest, deadline, t0, attempts,
                            tenant=tenant_sent, tenant_acct=tenant)
                    finally:
                        if tracked:
                            with self._slock:
                                self._tenant_active[tenant] -= 1
            reached = any(a.get("status") != "noconnect"
                          for a in attempts)
            if not reached and tenant is not None \
                    and outcome != "served":
                # nothing reached a replica window — zero attempts
                # (door sheds, router deadline, proto) or every
                # attempt connect-refused (fleet-wide outage): the
                # router's own per-tenant tracker burns for it. A
                # "lost" attempt counts as reached — the replica MAY
                # have accepted it into its own window, and the merge
                # must never count a request twice.
                tr = self.slo_tenants.get(tenant)
                if tr is not None:
                    tr.observe(ok=False)
            total = time.monotonic() - t0
            # the flight record + route_request_done event land BEFORE
            # the response goes out (the servd rule): a client that
            # just read its answer can immediately /trace?request=<id>
            self._record_request(tid, outcome, text, attempts, total,
                                 deadline_ms, tenant)
            # outcome lands BEFORE the active slot is released: drain()
            # snapshots final stats the moment _active hits 0, and an
            # accepted-but-not-yet-outcomed request would read as
            # non-reconciling books in the route_done event
            self._bump(outcome)
            self._bump_tenant(tenant, outcome)
            telemetry.hist("route.request", total)
        finally:
            with self._lock:
                self._active -= 1
        return text

    def _record_request(self, tid: str, outcome: str, text: str,
                        attempts: List[dict], total: float,
                        deadline_ms: Optional[float],
                        tenant: Optional[str] = None) -> None:
        rec = {"id": tid, "outcome": outcome,
               "tenant": tenant,
               "resp": " ".join(text.split()[:3])
               if text.startswith("ERR") else "served",
               # cxxlint: disable=wallclock — flight-record accept
               # epoch: the cross-process stitch aligns the router and
               # replica lanes on this shared wall clock, never a
               # duration
               "t_wall": round(time.time() - total, 6),
               "total_s": round(total, 6),
               "deadline_ms": deadline_ms,
               "retries": max(0, len(attempts) - 1),
               "attempts": attempts}
        # the router-side autopsy rides the record AND the done event:
        # /why?request=<id> refines it with the replica's books (the
        # stitch); a log consumer gets the verdict with zero joins
        rec["autopsy"] = autopsy.classify_route(rec)
        self.flight.record(rec)
        ev = {"ev": "route_request_done", "req": tid,
              "outcome": outcome,
              "attempts": len(attempts),
              "replicas": [a["replica"] for a in attempts],
              "retries": rec["retries"],
              "total_s": rec["total_s"],
              "autopsy": rec["autopsy"]}
        if tenant is not None:
            ev["tenant"] = tenant
        telemetry.event(ev)

    def _attempt_once(self, r: Replica, tid: str, sendbody: str,
                      tenant: Optional[str], timeout: float, att: dict
                      ) -> Tuple[str, Optional[str],
                                 Optional[socket.socket]]:
        """One full attempt against one PICKED replica (prefix build,
        forward, capability-downgrade ladder) -> (status, resp, sock).
        sock is the kept socket of a timed-out read (reapable), else
        None. Checks the replica back in; fills att latency/status."""
        with self._lock:
            traced = not r.no_trace
            tenanted = tenant is not None and not r.no_tenant
        # wire order: TRACE <id> TENANT <t> DEADLINE <ms> <toks> —
        # the replica parser strips them in exactly this order
        sendline = sendbody
        if tenanted:
            sendline = "TENANT %s %s" % (tenant, sendline)
        if traced:
            sendline = "TRACE %s %s" % (tid, sendline)
        t_att = time.monotonic()
        sock: Optional[socket.socket] = None
        try:
            status, resp, sock = self._forward_keep(r, sendline,
                                                    timeout)
            if (traced or tenanted) and status == "ok":
                if not resp.startswith("ERR parse"):
                    # ANY other answer to a prefixed line proves
                    # the prefixes were parsed: latch the positive
                    # capability flags so later genuine client
                    # parse errors never pay the downgrade resends
                    # (one write each, then steady)
                    if (traced and not r.trace_ok) \
                            or (tenanted and not r.tenant_ok):
                        with self._lock:
                            if traced:
                                r.trace_ok = True
                            if tenanted:
                                r.tenant_ok = True
                else:
                    # maybe an OLD replica rejecting a prefix
                    # itself: a parse rejection proves the request
                    # never dispatched, so each progressively
                    # barer resend is exactly-once safe. A genuine
                    # client parse error comes back identical at
                    # every rung and is relayed; a changed answer
                    # proves which prefix the replica predates —
                    # latch it (the ladder: drop TENANT first —
                    # newer than TRACE — then TRACE too).
                    status, resp = self._prefix_downgrade(
                        r, tid, sendbody, traced, tenanted,
                        timeout, att, resp)
        finally:
            self._checkin(r)
        att["latency_s"] = round(time.monotonic() - t_att, 6)
        att["status"] = status
        return status, resp, sock

    def _tenant_over_share(self, tenant: Optional[str]) -> bool:
        """True when the tenant already holds MORE than its weighted
        fair share of the router's in-flight requests — the replay and
        hedge denial gate. Unlike _tenant_gate there is no saturation
        requirement: a replay or hedge is EXTRA fleet work on top of
        an already-charged request, so an over-share tenant is denied
        even on an idle fleet (a flood must not double itself through
        failover). A sole-active tenant is never denied — its share is
        the whole router."""
        if not self._tenants or tenant is None \
                or tenant not in self._tenants:
            return False
        with self._slock:
            active = dict(self._tenant_active)
        total = sum(active.values())
        live = {t for t, n in active.items() if n > 0}
        live.add(tenant)
        weight_sum = sum(self._tenants[t] for t in live)
        share = max(1, int(total * self._tenants[tenant] / weight_sum))
        return active.get(tenant, 0) > share

    def _hedge_delay(self) -> Optional[float]:
        """The hedge launch delay in seconds, or None when hedging is
        off: route_hedge_ms > 0 is a fixed bound; -1 tracks the live
        fleet-merged serve p99 (None until the federation sweep has
        enough observations to trust); 0 disables."""
        if self.hedge_ms > 0:
            return self.hedge_ms / 1e3
        if self.hedge_ms < 0:
            return self._hedge_auto_s
        return None

    def _hedge_allowed(self, tenant: Optional[str]) -> bool:
        """Claim one hedge slot -> bool. Hedges are capped at
        hedge_max_pct of the requests in flight right now (floored at
        one) and denied to a tenant over its fair share. Sequential
        lock takes (fleet, then stats) — never nested."""
        if self._tenant_over_share(tenant):
            return False
        with self._lock:
            active = self._active
        with self._slock:
            cap = max(1, int(self.hedge_max_pct / 100.0 * active))
            if self._hedges_live >= cap:
                return False
            self._hedges_live += 1
            return True

    def _discard_loser(self, status: str, resp: Optional[str],
                       sock: Optional[socket.socket], rname: str,
                       tid: str, winner_resp: Optional[str]) -> None:
        """Account a hedge race's losing lane: a full answer is
        discarded and COUNTED (route.discarded_late) — and
        cross-checked against the winner's, because determinism says
        duplicate answers are identical: a mismatch is a correctness
        alarm (route.hedge_mismatch), not noise. A kept socket (the
        lane timed out) is reaped in the background."""
        if status == "ok" and resp:
            self._bump("discarded_late")
            if (winner_resp and not resp.startswith("ERR")
                    and not winner_resp.startswith("ERR")
                    and resp != winner_resp):
                telemetry.count("route.hedge_mismatch")
                telemetry.event({"ev": "route_hedge_mismatch",
                                 "request": tid, "replica": rname,
                                 "loser": resp[:80],
                                 "winner": winner_resp[:80]})
        if sock is not None:
            self._reap_socket(sock, rname, tid, self.stall_s)

    def _attempt_hedged(self, r: Replica, att: dict, tid: str,
                        sendbody: str, tenant: Optional[str],
                        tenant_acct: Optional[str], timeout: float,
                        delay: float, t0: float, tried: set,
                        attempts_out: List[dict]
                        ) -> Tuple[str, Optional[str],
                                   Optional[socket.socket],
                                   Replica, dict]:
        """Race a primary attempt against ONE delayed duplicate on a
        different replica -> (status, resp, sock, replica, att) for
        the winning lane. First genuine answer wins; the loser is
        discarded+counted by whichever side observes the race outcome
        — the CPython-atomic dict.setdefault claim makes it exactly
        one. A hedge answer is adopted only when it is a real answer
        (ok, non-ERR): hedging never worsens an outcome — a lost
        primary still flows into the replay machinery upstream."""
        res: dict = {}
        evt = threading.Event()

        def primary():
            try:
                res["p"] = self._attempt_once(r, tid, sendbody,
                                              tenant, timeout, att)
            except Exception:
                res["p"] = ("lost", None, None)
            evt.set()
            # loser self-accounting: the main thread already adopted
            # the hedge answer AND saw this lane unfinished — the
            # setdefault claim picks exactly one accountant
            if res.get("winner") == "hedge" \
                    and res.setdefault("acct", "p") == "p":
                st, rp, sk = res["p"]
                self._discard_loser(st, rp, sk, r.name, tid,
                                    res.get("winner_resp"))

        threading.Thread(target=primary, name="cxn-routerd-hedge-pri",
                         daemon=True).start()
        if evt.wait(delay):
            st, rp, sk = res["p"]
            return st, rp, sk, r, att
        # the downgrade ladder can legally take ~3x the per-forward
        # timeout: the pathological wait bound for the primary lane
        bound = 3.0 * timeout + 1.0
        if not self._hedge_allowed(tenant_acct):
            evt.wait(bound)
            st, rp, sk = res.get("p", ("lost", None, None))
            return st, rp, sk, r, att
        try:
            r2, cands2 = self._pick(tried | {r.name})
            if r2 is None:
                evt.wait(bound)
                st, rp, sk = res.get("p", ("lost", None, None))
                return st, rp, sk, r, att
            self._bump("hedges")
            att2 = {"replica": r2.name, "cls": "hedge",
                    "t_off_s": round(time.monotonic() - t0, 6),
                    "candidates": cands2}
            st2, rp2, sk2 = self._attempt_once(r2, tid, sendbody,
                                               tenant, timeout, att2)
            tried.add(r2.name)
        finally:
            with self._slock:
                self._hedges_live -= 1
        p = res.get("p") if evt.is_set() else None
        if p is not None and p[0] == "ok" and p[1] is not None \
                and not p[1].startswith("ERR"):
            # the primary produced a genuine answer: it wins (it was
            # first, or close enough that order doesn't matter —
            # determinism makes the answers identical either way)
            att2["outcome"] = "hedge_loser"
            attempts_out.append(att2)
            self._discard_loser(st2, rp2, sk2, r2.name, tid, p[1])
            return p[0], p[1], p[2], r, att
        if st2 == "ok" and rp2 is not None \
                and not rp2.startswith("ERR"):
            # the hedge produced the genuine answer: adopt it; the
            # primary lane (late, lost, or errored) is the loser
            res["winner_resp"] = rp2
            res["winner"] = "hedge"
            self._bump("hedge_wins")
            if evt.is_set() and res.setdefault("acct", "m") == "m":
                st, rp, sk = res["p"]
                self._discard_loser(st, rp, sk, r.name, tid, rp2)
            att["outcome"] = "hedge_loser"
            attempts_out.append(att)
            return st2, rp2, sk2, r2, att2
        # the hedge failed too (ERR / lost / noconnect): wait out the
        # primary — it may still answer, and a lost primary flows into
        # the replay machinery upstream
        att2["outcome"] = (" ".join(rp2.split()[:3])
                           if (st2 == "ok" and rp2) else st2)
        attempts_out.append(att2)
        if sk2 is not None:
            self._reap_socket(sk2, r2.name, tid, self.stall_s)
        if evt.wait(bound):
            st, rp, sk = res["p"]
            return st, rp, sk, r, att
        # pathological: the primary never returned inside the bound —
        # report it lost; its late completion self-discards via the
        # winner flag
        res["winner"] = "hedge"
        res["winner_resp"] = None
        res.setdefault("acct", "p")
        return "lost", None, None, r, att

    def _route(self, tid: str, rest: List[str],
               deadline: Optional[float], t0: float,
               attempts_out: List[dict],
               tenant: Optional[str] = None,
               tenant_acct: Optional[str] = None) -> Tuple[str, str]:
        tried: set = set()
        attempts = 0
        last_shed: Optional[str] = None
        loss: Optional[str] = None    # the last lost/rescued attempt's
        #                               text (replayable losses)
        replay_gen: Optional[int] = None  # expected model generation
        #                               once replaying (the guard)
        body = " ".join(rest)
        while True:
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                return ("ERR deadline expired %.0fms past the budget "
                        "(router)" % (1e3 * (now - deadline)),
                        "deadline")
            r, cands = self._pick(tried)
            if r is None:
                if loss is not None:
                    # a replayable loss with no survivor left: the
                    # honest verdict is the loss, not a fleet shed
                    return (loss + " (no survivor to replay on)",
                            "errors")
                if last_shed is not None:
                    return last_shed, "shed"
                return ("ERR busy fleet no routable replica (%s)"
                        % self._states_brief(), "shed")
            if replay_gen is not None and replay_gen >= 0:
                # generation guard (module docstring): a replay must
                # not splice tokens across a weight push — the
                # survivor's live ADMIN reload count must match the
                # lost replica's (a fresh probe per replay: replays
                # are rare, staleness here splices generations)
                st = self._replica_stats(r)
                sg = -1
                if st is not None:
                    try:
                        sg = int(st.get("reloads", -1))
                    except (TypeError, ValueError):
                        sg = -1
                if sg >= 0 and sg != replay_gen:
                    self._checkin(r)
                    attempts_out.append(
                        {"replica": r.name, "cls": "replay",
                         "status": "denied",
                         "outcome": "replay_denied_generation"})
                    self._bump("replay_denied")
                    return ("ERR backend generation moved mid-replay "
                            "(expected %d, replica %s at %d)"
                            % (replay_gen, r.name, sg), "errors")
            timeout = self.stall_s
            sendbody = body
            if deadline is not None:
                rem = deadline - now
                timeout = min(timeout, rem)
                # forward the budget REMAINING, not the original: the
                # replica's own queue-expiry check spends the same clock
                sendbody = "DEADLINE %d %s" % (max(1, int(rem * 1e3)),
                                               body)
            att = {"replica": r.name,
                   "t_off_s": round(time.monotonic() - t0, 6),
                   "candidates": cands}
            if replay_gen is not None:
                att["cls"] = "replay"
            hdelay = self._hedge_delay()
            sock: Optional[socket.socket] = None
            if not tried and hdelay is not None and hdelay < timeout:
                # first attempt only: a retry/replay already burned
                # tail budget, doubling it again helps no one
                status, resp, sock, r, att = self._attempt_hedged(
                    r, att, tid, sendbody, tenant, tenant_acct,
                    timeout, hdelay, t0, tried, attempts_out)
            else:
                status, resp, sock = self._attempt_once(
                    r, tid, sendbody, tenant, timeout, att)
            tried.add(r.name)
            if status == "noconnect":
                # never sent: safe. Eject now — waiting a probe
                # interval would burn every retry on a dead replica.
                att["outcome"] = "noconnect"
                attempts_out.append(att)
                self._mark(r, DEAD, "connect refused at dispatch")
                if self._retry_allowed(attempts):
                    attempts += 1
                    self._bump("retries")
                    att["retried"] = True
                    continue
                return ("ERR busy fleet replicas unreachable", "shed")
            # a lost attempt (sent, then silence/EOF) or a replica-side
            # batch rescue (``ERR backend rescued``: the replica evicted
            # a wedged batch — provably no answer left it): both are
            # REPLAYABLE losses under the determinism argument in the
            # module docstring. The prober decides whether the replica
            # is dead (SIGKILL) or merely slow, so no hard eject here.
            rescued = (status == "ok" and resp is not None
                       and resp.split()[:3]
                       == ["ERR", "backend", "rescued"])
            if status == "lost" or rescued:
                with self._lock:
                    r.lost += 1
                    gen = r.reloads
                if status == "lost":
                    att["outcome"] = "lost"
                    attempts_out.append(att)
                    self._bump("lost_contact")
                    if sock is not None:
                        # the timed-out socket: reap (and count) a
                        # late answer in the background so the replay
                        # below stays exactly-once to the client
                        grace = self.stall_s
                        if deadline is not None:
                            grace = min(grace, max(
                                0.05, deadline - time.monotonic()))
                        self._reap_socket(sock, r.name, tid, grace)
                        sock = None
                    loss = ("ERR backend replica %s lost contact "
                            "mid-request" % r.name)
                else:
                    att["outcome"] = "ERR backend rescued"
                    attempts_out.append(att)
                    loss = resp
                if not self.replay:
                    if rescued:
                        return loss, "errors"
                    return (loss + " (not retried: may have "
                            "dispatched)", "errors")
                if self._tenant_over_share(tenant_acct):
                    # a flood must not double itself through failover:
                    # the over-share tenant eats its loss
                    self._bump("replay_denied")
                    return (loss + " (not replayed: tenant %s over "
                            "fair share)" % tenant_acct, "errors")
                self._bump("replays")
                att["replayed"] = True
                if replay_gen is None:
                    replay_gen = gen
                continue
            att["outcome"] = " ".join(resp.split()[:3]) \
                if resp.startswith("ERR") else "served"
            attempts_out.append(att)
            # a response line: dispatch on the retryability contract
            if retryable(resp):
                last_shed = resp
                toks = resp.split()
                detail = toks[2] if len(toks) > 2 else ""
                if toks[:2] == ["ERR", "busy"] and detail == "breaker":
                    self._mark(r, BREAKER_OPEN, resp[:120])
                elif toks[:1] == ["ERR"] and toks[1:2] == ["draining"]:
                    self._mark(r, DRAINING, resp[:120])
                if self._retry_allowed(attempts):
                    attempts += 1
                    self._bump("retries")
                    att["retried"] = True
                    continue
                return resp, "shed"
            if resp.split()[:3] == ["ERR", "busy", "tenant"]:
                # the replica's fair-share verdict: a shed (never
                # dispatched), relayed WITHOUT retry — the tenant
                # table is fleet-wide, so every replica rules the same
                return resp, "shed"
            if resp.startswith("ERR deadline"):
                return resp, "deadline"
            if resp.startswith("ERR"):
                return resp, "errors"
            return resp, "served"

    def _prefix_downgrade(self, r: Replica, tid: str, sendbody: str,
                          traced: bool, tenanted: bool, timeout: float,
                          att: dict,
                          first_resp: str) -> Tuple[str, Optional[str]]:
        """The pre-TRACE / pre-TENANT compat ladder (module docstring):
        the prefixed attempt came back ``ERR parse``, which proves it
        never dispatched — so each progressively barer resend is
        exactly-once safe. Rung 1 drops TENANT (the newer prefix; a
        changed answer latches ``no_tenant`` — and proves TRACE parsed,
        so ``trace_ok`` latches too). Rung 2 drops TRACE as well (a
        pre-TRACE replica certainly predates TENANT: both latch). An
        answer identical at every rung is a genuine client parse error,
        relayed verbatim with no latch. Skips rungs whose capability is
        already proven (``trace_ok``/``tenant_ok``) — a proven prefix
        cannot be what the replica rejected."""
        status, resp = "ok", first_resp
        if tenanted and not r.tenant_ok:
            line = sendbody if not traced \
                else "TRACE %s %s" % (tid, sendbody)
            status, resp = self._forward(r, line, timeout)
            if status != "ok":
                return status, resp
            if not resp.startswith("ERR parse"):
                with self._lock:
                    r.no_tenant = True
                    if traced:
                        r.trace_ok = True
                att["tenant_downgraded"] = True
                telemetry.count("route.tenant_downgrades")
                telemetry.event({"ev": "route_tenant_downgrade",
                                 "replica": r.name})
                return status, resp
        if traced and not r.trace_ok:
            status, resp = self._forward(r, sendbody, timeout)
            if status == "ok" and not resp.startswith("ERR parse"):
                with self._lock:
                    r.no_trace = True
                    if tenanted:
                        # a replica too old for TRACE predates TENANT
                        r.no_tenant = True
                att["trace_downgraded"] = True
                telemetry.count("route.trace_downgrades")
                telemetry.event({"ev": "route_trace_downgrade",
                                 "replica": r.name})
        return status, resp

    def _retry_allowed(self, attempts: int) -> bool:
        """Another attempt is allowed while the retry budget holds AND
        the router is not draining — drain bounds its wait on 'every
        in-flight request finishes within one attempt', so a request
        mid-retry must stop chaining attempts once drain begins."""
        if attempts >= self.retries:
            return False
        with self._lock:
            return not self._draining

    def _states_brief(self) -> str:
        with self._lock:
            by: Dict[str, int] = {}
            for r in self._replicas:
                if r.standby:
                    key = "standby"
                elif r.state == UP and r.hold:
                    key = "held"
                else:
                    key = r.state
                by[key] = by.get(key, 0) + 1
        return " ".join("%s=%d" % kv for kv in sorted(by.items()))

    # -- fleet ADMIN ---------------------------------------------------
    def _handle_admin(self, args: List[str]) -> str:
        with self._lock:
            if self._draining or self._stop:
                return "ERR draining router is shutting down"
        self._bump("admin")
        if args and args[0] == "stats":
            return self._fleet_stats_text()
        if args and args[0] == "reload":
            if self.request_rolling_reload():
                return "OK fleet reload rolling (one replica at a time)"
            return "ERR busy reload already rolling"
        if args and args[0] == "fleet":
            snap = self.fleet_snapshot()
            return "OK " + " ".join(
                "%s=%s:%d:%d" % (x["name"], x["state"],
                                 x["queue_depth"] + x["in_flight"],
                                 x["outstanding"])
                for x in snap["replicas"])
        return ("ERR parse unknown ADMIN command %r"
                % " ".join(args))

    def _replica_stats(self, r: Replica) -> Optional[Dict[str, int]]:
        """One replica's ``ADMIN stats`` counters (None when
        unreachable) — short probe timeout, never the stall bound."""
        status, resp = self._forward(r, "ADMIN stats",
                                     self.probe_timeout)
        if status != "ok" or not resp.startswith("OK "):
            return None
        out: Dict[str, int] = {}
        for kv in resp[3:].split():
            k, _, v = kv.partition("=")
            try:
                out[k] = int(v)
            except ValueError:
                continue
        return out

    def _fleet_stats_text(self) -> str:
        """Aggregate ``ADMIN stats`` over every reachable replica. Each
        replica reconciles accepted == served + errors + shed +
        deadline, so the sums reconcile too; ``replicas``/``reachable``
        ride along so a partial aggregate is visible as partial."""
        with self._lock:
            reps = [(r, r.state) for r in self._replicas]
        totals: Dict[str, int] = {}
        reachable = 0
        for r, state in reps:
            if state == DEAD:
                continue             # don't burn a timeout per scrape
            st = self._replica_stats(r)
            if st is None:
                continue
            reachable += 1
            for k, v in st.items():
                totals[k] = totals.get(k, 0) + v
        totals["replicas"] = len(reps)
        totals["reachable"] = reachable
        return "OK " + " ".join("%s=%d" % kv
                                for kv in sorted(totals.items()))

    # -- live fleet federation (metrics + SLO + outliers) --------------
    def federate_now(self) -> int:
        """One federation sweep: pull each non-dead replica's RAW
        metrics snapshot (statusd ``/metrics?json=1`` — exact bucket
        counts, no text-format round trip) plus its SLO window, store
        them, and recompute the outlier verdicts. Returns the number of
        replicas federated. All IO lock-free; the prober thread calls
        this every ``federate_s`` (tests and the selftest call it
        directly for determinism)."""
        with self._lock:
            reps = [(r.name, r.state, r.host, r.status_port)
                    for r in self._replicas]
        snaps: Dict[str, dict] = {}
        for name, state, host, sport in reps:
            if state == DEAD:
                continue             # don't burn a timeout per sweep
            try:
                code, body = _http_get(host, sport, "/metrics?json=1",
                                       self.probe_timeout)
                if code != 200:
                    continue
                snap = json.loads(body)
            except (OSError, ValueError):
                continue
            if isinstance(snap, dict) and "metrics" in snap:
                snaps[name] = snap
        now = time.monotonic()
        with self._fed_lock:
            # a replica that missed THIS sweep (one slow scrape, a GC
            # pause) keeps its last-known snapshot: dropping it would
            # make every cxxnet_fleet_* counter/bucket series dip and
            # recover, which Prometheus reads as a process reset and
            # re-counts the replica's lifetime totals as new traffic.
            # Only DEAD replicas leave the merge (a real reset).
            prev = self._fed
            live = {name for name, state, _, _ in reps
                    if state != DEAD}
            merged = {}
            for name, snap in snaps.items():
                merged[name] = {"snap": snap, "t": now}
            for name, entry in prev.items():
                if name not in merged and name in live:
                    merged[name] = entry
            self._fed = merged
            self._fed_at = now
            det = {name: e["snap"] for name, e in merged.items()}
        self._detect_outliers(det)
        return len(snaps)

    def _detect_outliers(self, snaps: Dict[str, dict]) -> None:
        """Per-replica serve p99 vs the median of the OTHER replicas
        (leave-one-out — against a median that includes itself, a
        2-replica fleet could NEVER flag its slow half: the median of
        two values is their mean, so p99 > ratio*median is impossible
        for ratio >= 2): a replica diverging by ``outlier_ratio`` x
        (with >= ``outlier_min_n`` requests behind its histogram) is an
        outlier. Verdicts are stored for /fleetz + the
        cxxnet_fleet_outlier gauges; transitions emit ONE
        ``fleet_outlier`` event each (never per-sweep spam)."""
        p99s: Dict[str, float] = {}
        h_all = telemetry.Histogram()
        for name, snap in snaps.items():
            d = (snap.get("metrics") or {}).get("hists", {}) \
                .get("serve.request")
            if not d:
                continue
            h = telemetry.Histogram()
            try:
                h.merge_dict(d)
                h_all.merge_dict(d)
            except (ValueError, TypeError):
                continue
            if h.n >= self.outlier_min_n:
                p99s[name] = h.percentile(99)
        if h_all.n >= self.outlier_min_n:
            # the fleet-merged serve p99: the live hedge delay when
            # route_hedge_ms = -1 (GIL-atomic float store; floored so
            # a degenerate all-fast histogram can't hedge everything)
            self._hedge_auto_s = max(0.001, h_all.percentile(99))
        flips = []
        with self._fed_lock:
            prev = self._fed_outlier
            verdicts: Dict[str, dict] = {}
            for name, p99 in sorted(p99s.items()):
                others = [v for n, v in p99s.items() if n != name]
                med = statistics.median(others) if others else None
                out = bool(med and med > 0
                           and p99 > self.outlier_ratio * med)
                verdicts[name] = {"outlier": out,
                                  "p99_ms": round(1e3 * p99, 3),
                                  "fleet_p99_ms":
                                  round(1e3 * med, 3)
                                  if med is not None else None}
                was = prev.get(name, {}).get("outlier", False)
                if out != was:
                    flips.append((name, verdicts[name]))
            # a FLAGGED replica that left the verdict set (died, or its
            # fresh histogram fell under min_n after a restart) must
            # emit its clearing transition — an event consumer watching
            # outlier=1 with no outlier=0 would page on it forever
            for name, was in prev.items():
                if name not in verdicts and was.get("outlier"):
                    flips.append((name, {"outlier": False,
                                         "p99_ms": None,
                                         "fleet_p99_ms": None}))
            self._fed_outlier = verdicts
        for name, v in flips:
            telemetry.count("route.outlier_flips")
            telemetry.event({"ev": "fleet_outlier", "replica": name,
                             "outlier": int(v["outlier"]),
                             "p99_ms": v["p99_ms"],
                             "fleet_p99_ms": v["fleet_p99_ms"]})

    def federation_slo(self) -> Optional[dict]:
        """The fleet-wide merged-window SLO account alone (None before
        the first sweep or without SLO-carrying replicas) — the
        autoscaler reads this every prober sweep, so it must not pay
        the full federation_snapshot histogram/counter merge per tick
        just to extract one burn rate."""
        with self._fed_lock:
            snaps = [d["snap"] for d in self._fed.values()]
        if not snaps:
            return None
        acc = _SloMerge()
        for snap in snaps:
            acc.add(snap.get("slo"))
        return acc.result()

    def federation_snapshot(self) -> Optional[dict]:
        """The merged fleet view (None before the first sweep): serve
        histograms merged EXACTLY (shared fixed buckets: bucket-count
        addition), serve counters summed, the fleet-wide SLO account
        over the replicas' merged windows, per-replica p99 + outlier
        verdicts. Rides ``fleet_snapshot()`` onto /fleetz and the
        router's /metrics (``cxxnet_fleet_*`` series)."""
        with self._fed_lock:
            if not self._fed:
                return None
            fed = {name: d["snap"] for name, d in self._fed.items()}
            age = time.monotonic() - self._fed_at
            outliers = {name: dict(v)
                        for name, v in self._fed_outlier.items()}
        hists: Dict[str, telemetry.Histogram] = {}
        counters: Dict[str, float] = {}
        slo_acc = _SloMerge()
        slo_tenant_acc: Dict[str, _SloMerge] = {}
        # the decode KV/convoy account (the replicas' batch feed):
        # byte sums are EXACT (each replica accounts its own cache),
        # live pct recomputed from the sums — never a mean of means
        dec_reps = dec_kv = dec_live = dec_convoy = 0
        # the paged-KV pool federation: block counts and prefix-token
        # tallies sum exactly (each replica's pool is its own), the
        # fleet hit rate is recomputed from the token sums — never a
        # mean of per-replica rates. Foreign/dense replicas simply
        # lack the "pool" key (absent never kills)
        pool_reps = blk_total = blk_free = 0
        pfx_hit_toks = pfx_prompt_toks = kv_defers = 0
        blk_retained = ret_hits = ret_hit_toks = pressure_reps = 0
        for name, snap in sorted(fed.items()):
            b = snap.get("batch")
            if isinstance(b, dict):
                dec_reps += 1
                dec_kv += int(b.get("kv_bytes") or 0)
                dec_live += int(b.get("kv_live_bytes") or 0)
                dec_convoy += 1 if b.get("convoy") else 0
                pl = b.get("pool")
                if isinstance(pl, dict):
                    try:
                        pool_reps += 1
                        blk_total += int(pl.get("blocks_total") or 0)
                        blk_free += int(pl.get("blocks_free") or 0)
                        pfx_hit_toks += int(
                            pl.get("prefix_hit_tokens") or 0)
                        pfx_prompt_toks += int(
                            pl.get("prompt_tokens") or 0)
                        kv_defers += int(pl.get("alloc_failures") or 0)
                        blk_retained += int(
                            pl.get("blocks_retained") or 0)
                        ret_hits += int(pl.get("retained_hits") or 0)
                        ret_hit_toks += int(
                            pl.get("retained_hit_tokens") or 0)
                        pressure_reps += 1 if pl.get("pressure") else 0
                    except (TypeError, ValueError):
                        pass
            m = snap.get("metrics") or {}
            for hname, d in (m.get("hists") or {}).items():
                if not hname.startswith("serve."):
                    continue
                try:
                    hists.setdefault(
                        hname, telemetry.Histogram()).merge_dict(d)
                except (ValueError, TypeError):
                    continue
            for cname, v in (m.get("counters") or {}).items():
                if cname.startswith("serve."):
                    counters[cname] = counters.get(cname, 0) + v
            # the merged-window account: each replica's rolling
            # window contributes its request/bad counts. The alert
            # floors are fleet-wide — N replicas each one bad
            # request under their own min_bad can still page here
            # (the fleet-over case no single replica triggers).
            # Per-tenant windows merge the same way, per tenant.
            slo_acc.add(snap.get("slo"))
            for t, tslo in (snap.get("slo_tenants") or {}).items():
                slo_tenant_acc.setdefault(str(t), _SloMerge()).add(tslo)
        # the router's own per-tenant windows (door sheds only — see
        # __init__: zero-attempt outcomes, so no request is counted in
        # two windows) join the fleet merge
        for t, tr in sorted(self.slo_tenants.items()):
            slo_tenant_acc.setdefault(str(t), _SloMerge()).add(
                tr.snapshot())
        out = {"replicas": len(fed), "age_s": round(age, 3),
               "series": {name: dict(h.stats(),
                                     buckets=h.to_dict()["buckets"])
                          for name, h in sorted(hists.items())},
               "counters": counters,
               "outliers": outliers,
               "slo": slo_acc.result(),
               "slo_tenants": {t: res
                               for t, acc in
                               sorted(slo_tenant_acc.items())
                               for res in [acc.result()]
                               if res is not None}}
        if dec_reps:
            out["decode"] = {
                "replicas": dec_reps, "kv_bytes": dec_kv,
                "kv_live_bytes": dec_live,
                "kv_live_pct": round(100.0 * dec_live / dec_kv, 2)
                if dec_kv else None,
                "convoy_replicas": dec_convoy}
            if pool_reps:
                out["decode"]["pool"] = {
                    "replicas": pool_reps,
                    "blocks_total": blk_total,
                    "blocks_free": blk_free,
                    "prefix_hit_tokens": pfx_hit_toks,
                    "prompt_tokens": pfx_prompt_toks,
                    "prefix_hit_rate":
                    round(100.0 * pfx_hit_toks / pfx_prompt_toks, 2)
                    if pfx_prompt_toks else None,
                    "kv_defers": kv_defers,
                    # retained conversation cache: block/hit sums are
                    # exact, the fleet hit rate recomputed from token
                    # sums (never a mean of per-replica rates), and
                    # pressure_replicas counts latched replicas
                    "blocks_retained": blk_retained,
                    "retained_hits": ret_hits,
                    "retained_hit_tokens": ret_hit_toks,
                    "retained_hit_rate":
                    round(100.0 * ret_hit_toks / pfx_prompt_toks, 2)
                    if pfx_prompt_toks else None,
                    "pressure_replicas": pressure_reps}
        # the per-tenant fleet account, parsed back out of the summed
        # serve.tenant.<t>.<key> counter series and the merged
        # serve.tenant.<t>.request histograms: fleet-wide per-tenant
        # books (reconciling like the replica-local ones) plus each
        # tenant's fleet p99 — what "the victim's p99 holds" is read
        # from
        tenants: Dict[str, dict] = {}
        for cname, v in counters.items():
            if not cname.startswith("serve.tenant."):
                continue
            t, _, key = cname[len("serve.tenant."):].rpartition(".")
            if t:
                tenants.setdefault(t, {})[key] = v
        for hname, h in hists.items():
            if hname.startswith("serve.tenant.") \
                    and hname.endswith(".request"):
                t = hname[len("serve.tenant."):-len(".request")]
                if t:
                    p99 = h.percentile(99)
                    tenants.setdefault(t, {})["p99_ms"] = \
                        round(1e3 * p99, 3) if p99 is not None else None
        if tenants:
            out["tenants"] = tenants
        return out

    # -- closed-loop fleet autoscaler ----------------------------------
    def scaling_enabled(self) -> bool:
        return any(r.from_standby for r in self._replicas)

    def scale_snapshot(self) -> dict:
        """The autoscaler's account for /fleetz and the
        ``cxxnet_fleet_target_replicas`` /
        ``cxxnet_fleet_scale_events_total`` series: the current target
        (active replicas), bounds, and the recent decisions."""
        with self._lock:
            active = sum(1 for r in self._replicas if not r.standby)
            standby = sum(1 for r in self._replicas if r.standby)
        with self._scale_lock:
            events = self._scale_events
            recent = list(self._scale_log[-16:])
        return {"target_replicas": active, "standby": standby,
                "min": self.scale_min, "max": self.scale_max,
                "up_burn": self.scale_up_burn,
                "down_idle_s": self.scale_down_idle_s,
                "cooldown_s": self.scale_cooldown_s,
                "events": events, "recent": recent}

    def autoscale_now(self) -> Optional[str]:
        """One policy pass over the federated signals (module
        docstring): returns "up"/"down" when a scale action was taken,
        None otherwise. The prober runs this each sweep; tests and the
        selftest call it directly for determinism. Policy:

        * **up** — fleet SLO burn >= ``scale_up_burn`` (the federated
          merged-window account), OR queued work with zero free decode
          slots anywhere (demand the fleet provably cannot absorb) —
          admit one standby, bounded by ``scale_max``. A fleet below
          ``scale_min`` admits unconditionally (the floor is a floor).
        * **down** — the fleet is quiet (no queued work, burn < 1) and
          a scale-up-admitted replica has been completely idle for
          ``scale_down_idle_s`` — retire it back to standby, never
          below ``scale_min``.
        * **hysteresis** — at most one action per ``scale_cooldown_s``
          (the floor-repair case excepted), and any sign of load
          resets every idle timer: flap costs a replica a drain.

        Decisions are recorded as transition-only ``fleet_scale``
        events; counters/gauges ride ``scale_snapshot()``. All IO
        (probing a standby before admitting it) runs lock-free."""
        if not self.scaling_enabled():
            return None
        now = time.monotonic()
        with self._lock:
            active = [r for r in self._replicas if not r.standby]
            active_up = [r for r in active
                         if r.state == UP and not r.hold]
            standbys = [r for r in self._replicas
                        if r.standby and r.state != DEAD]
            # pressure = work WAITING (the live backlog), never mere
            # in-flight: one slow request on an otherwise idle solo
            # fleet must not ratchet capacity to scale_max
            queue_total = sum(r.backlog() for r in active_up)
            busy_total = sum(r.queue_depth + r.in_flight
                             for r in active_up)
            free_total = sum(r.free_slots for r in active_up)
            outstanding = sum(r.outstanding for r in active)
            idle_names = {r.name for r in active
                          if r.from_standby and r.state == UP
                          and not r.hold
                          and r.queue_depth + r.in_flight
                          + r.outstanding == 0}
        fslo = self.federation_slo()
        burn = None if fslo is None else fslo.get("burn_rate")
        pressure = queue_total > 0 and free_total <= 0
        burning = burn is not None and burn >= self.scale_up_burn
        with self._scale_lock:
            cool = now - self._scale_last >= self.scale_cooldown_s
            below_min = len(active_up) < self.scale_min
            want_up = standbys and len(active) < self.scale_max \
                and (below_min or (cool and (burning or pressure)))
            # idle bookkeeping: any load anywhere resets every timer —
            # a fleet that still has work in it must not shed capacity
            if burning or pressure or busy_total or outstanding:
                self._idle_since.clear()
            else:
                for name in list(self._idle_since):
                    if name not in idle_names:
                        del self._idle_since[name]
                for name in idle_names:
                    self._idle_since.setdefault(name, now)
            ripe = [n for n, t in self._idle_since.items()
                    if now - t >= self.scale_down_idle_s]
            want_down = (not want_up and cool and ripe
                         and len(active_up) > self.scale_min
                         and not (burning or pressure))
        if want_up:
            # prefer a standby already probed UP, then a WARMING one
            # (admissible — it turns routable by itself once its grid
            # compiles; the event's warm_pct records how cold it was
            # at admission); IO-free — the admitted replica keeps
            # being probed like any other, and a dead-on-arrival
            # standby is ejected by the normal dispatch/probe
            # machinery
            pick = next((r for r in standbys if r.state == UP),
                        next((r for r in standbys
                              if r.state == WARMING), standbys[0]))
            reason = ("below scale_min (%d up < %d)"
                      % (len(active_up), self.scale_min)) \
                if below_min else \
                ("fleet slo burn %.2fx >= %g" % (burn or 0.0,
                                                 self.scale_up_burn)
                 if burning else
                 "queued work (%d) with zero free slots" % queue_total)
            self._scale_apply(pick, up=True, reason=reason,
                              now=now)
            return "up"
        if want_down:
            with self._lock:
                pick = next((r for r in self._replicas
                             if r.name == ripe[0]), None)
            if pick is None:
                return None
            self._scale_apply(pick, up=False,
                              reason="idle %.1fs >= %g"
                              % (now - self._idle_since.get(
                                  pick.name, now),
                                 self.scale_down_idle_s), now=now)
            return "down"
        return None

    def _scale_apply(self, r: Replica, up: bool, reason: str,
                     now: float) -> None:
        with self._lock:
            r.standby = not up
            active = sum(1 for x in self._replicas if not x.standby)
            # the replica's warm fraction AT the scale decision: on a
            # scale-up this is the honest "admitted vs useful" gap —
            # 0.0 means every program still compiles ahead (the
            # serve_scale_up_to_first_token_s cost); None = no grid
            warm_pct = r.warm_pct()
        with self._scale_lock:
            self._scale_last = now
            self._scale_events += 1
            self._idle_since.pop(r.name, None)
            self._scale_log.append({"action": "up" if up else "down",
                                    "replica": r.name,
                                    "reason": reason,
                                    "active": active,
                                    "warm_pct": warm_pct})
            if len(self._scale_log) > 64:
                del self._scale_log[:-64]
        telemetry.count("route.scale_events")
        telemetry.gauge("route.target_replicas", active)
        telemetry.event({"ev": "fleet_scale",
                         "action": "up" if up else "down",
                         "replica": r.name, "reason": reason,
                         "active": active, "warm_pct": warm_pct})

    # -- stitched cross-process traces ---------------------------------
    def _fetch_hops(self, rec: dict) -> List[Tuple[str, dict]]:
        """The flight records of every replica one routed request
        touched, fetched live over each replica's statusd
        (``/requestz?request=<id>``) — the shared hop source of the
        /trace stitch and the /why autopsy. A replica that is gone (or
        has evicted the record) simply contributes no hop — the router
        lane still names it."""
        rid = str(rec.get("id"))
        with self._lock:
            by_name = {r.name: (r.host, r.status_port)
                       for r in self._replicas}
        hops: List[Tuple[str, dict]] = []
        seen = set()
        for att in rec.get("attempts") or []:
            name = att.get("replica")
            if name in seen or name not in by_name:
                continue
            seen.add(name)
            host, sport = by_name[name]
            try:
                code, body = _http_get(
                    host, sport, "/requestz?request=%s" % rid,
                    self.probe_timeout)
                if code != 200:
                    continue
                rrec = json.loads(body)
            except (OSError, ValueError):
                continue
            if isinstance(rrec, dict) and rrec.get("id") == rid:
                hops.append((name, rrec))
        return hops

    def stitched_trace(self, request_id) -> Optional[dict]:
        """ONE Chrome trace for one routed request: the router's
        attempt lane plus the phase lane of every replica that touched
        it, aligned on the shared wall-clock epoch. None when the
        router never saw the id."""
        rec = self.flight.get(str(request_id))
        if rec is None:
            return None
        return stitched_chrome_trace(rec, self._fetch_hops(rec))

    def stitched_why(self, request_id) -> Optional[dict]:
        """ONE cross-process autopsy for one routed request (the
        router's /why): the router-lane verdict refined by the winning
        replica's own cause decomposition, ``slow_replica`` absorbing
        the latency the replica's books cannot account for. None when
        the router never saw the id."""
        rec = self.flight.get(str(request_id))
        if rec is None:
            return None
        return autopsy.stitch_route(rec, self._fetch_hops(rec))

    def fleet_eventz(self, n: Optional[int] = None) -> List[dict]:
        """The fleet incident timeline (the router's /eventz): this
        process's own incident rows merged with every non-dead
        replica's ``/eventz?json=1`` rows, aligned on the shared
        wall-clock epoch. Each replica row is tagged with the replica
        name; the router's own rows say "router". ``n`` bounds the
        output to the NEWEST rows AFTER the merge — a bound applied
        per-feed would drop old-but-fleet-relevant rows unevenly."""
        rows = autopsy.incidents(
            telemetry.recent_events(),
            t0_wall=telemetry.wall_epoch(),
            records=self.flight.list(), process="router")
        with self._lock:
            reps = [(r.name, r.state, r.host, r.status_port)
                    for r in self._replicas]
        for name, state, host, sport in reps:
            if state == DEAD:
                continue             # don't burn a timeout per render
            try:
                code, body = _http_get(host, sport, "/eventz?json=1",
                                       self.probe_timeout)
                if code != 200:
                    continue
                snap = json.loads(body)
            except (OSError, ValueError):
                continue
            if not isinstance(snap, dict):
                continue
            for row in snap.get("rows") or []:
                if isinstance(row, dict):
                    row = dict(row)
                    row["process"] = name
                    rows.append(row)
        rows.sort(key=lambda r: r.get("t_wall") or 0.0)
        if n is not None and n > 0:
            rows = rows[-int(n):]
        return rows

    # -- rolling reload ------------------------------------------------
    def request_rolling_reload(self) -> bool:
        """Start the rolling fleet reload (one drain window at a time);
        False when one is already running or the router is draining.
        Safe from a SIGHUP handler? NO — this takes locks; ``task = route``'s
        handler sets a flag and calls this from its main loop."""
        with self._lock:
            if self._reloading or self._draining or self._stop:
                return False
            self._reloading = True
        t = threading.Thread(target=self._rolling_reload_run,
                             name="cxn-routerd-reload", daemon=True)
        t.start()
        return True

    def _rolling_reload_run(self) -> None:
        try:
            for r in list(self._replicas):
                with self._lock:
                    skip = r.state == DEAD
                if skip:
                    telemetry.event({"ev": "route_reload",
                                     "replica": r.name,
                                     "phase": "skipped_dead"})
                    continue
                self._reload_one(r)
            telemetry.event({"ev": "route_reload", "phase": "complete"})
        finally:
            with self._lock:
                self._reloading = False

    def _reload_one(self, r: Replica) -> None:
        with self._lock:
            r.hold = True
            t_out = time.monotonic()
        telemetry.event({"ev": "route_reload", "replica": r.name,
                         "phase": "drain"})
        by = t_out + self.reload_timeout_s
        ok = False
        ready = False
        try:
            # 1. drain THIS router's outstanding requests off the
            # replica (new picks already skip it)
            while time.monotonic() < by:
                with self._lock:
                    n = r.outstanding
                if n == 0:
                    break
                time.sleep(0.01)
            # 2. reload; completion = the replica's reload_seen counter
            # moved — it counts every PROCESSED reload request (real
            # swap, no-op already-newest skip, and failed reload alike;
            # the old model keeps serving on failure — still 'complete'
            # for the roll). Waiting on `reloads` alone would burn the
            # whole timeout out of rotation on a no-op roll.
            base = self._replica_stats(r)
            status, resp = self._forward(r, "ADMIN reload",
                                         self.probe_timeout)
            if status != "ok" or not resp.startswith("OK"):
                self._mark(r, DEAD, "reload dispatch failed: %r"
                           % (resp,))
                return
            while time.monotonic() < by:
                st = self._replica_stats(r)
                if base is None or (st is not None and
                                    st.get("reload_seen", 0)
                                    > base.get("reload_seen", 0)):
                    ok = True
                    break
                time.sleep(0.05)
            # 3. rejoin only once readiness confirms (a reload that
            # tripped the breaker must not re-enter rotation)
            while time.monotonic() < by:
                try:
                    code, _ = _http_get(r.host, r.status_port,
                                        "/healthz", self.probe_timeout)
                except OSError:
                    code = None
                if code == 200:
                    ready = True
                    break
                time.sleep(0.05)
        finally:
            with self._lock:
                r.hold = False
                t_back = time.monotonic()
                self._windows.append((r.name, t_out, t_back))
                if len(self._windows) > 64:
                    # bounded: /fleetz reads the last 32; a cron'd
                    # SIGHUP refresh must not grow this for months
                    del self._windows[:-64]
                demote = not ready and r.state == UP
            if demote:
                # /healthz never read ready inside the window: the
                # documented invariant is rejoin-only-when-ready, so
                # the replica leaves rotation until a ready probe —
                # NOT silently back into picks still unready
                self._mark(r, BREAKER_OPEN,
                           "not ready within %gs after reload"
                           % self.reload_timeout_s)
            telemetry.event({"ev": "route_reload", "replica": r.name,
                             "phase": "done", "ok": ok,
                             "ready": ready,
                             "window_s": round(t_back - t_out, 3)})

    # -- TCP front -----------------------------------------------------
    def _accept_run(self) -> None:
        sock = self._sock
        while True:
            with self._lock:
                if self._draining or self._stop:
                    break
            health.beat("route.accept")
            try:
                conn, _addr = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break               # listener closed (drain)
            conn.settimeout(self.client_timeout)
            threading.Thread(target=self._client_run, args=(conn,),
                             name="cxn-routerd-client",
                             daemon=True).start()
        health.pause("route.accept")

    def _client_run(self, conn: socket.socket) -> None:
        # one request at a time per connection: the forward is
        # synchronous, so responses leave in request order by
        # construction (no reply-slot machinery needed)
        try:
            buf = b""
            while True:
                try:
                    chunk = conn.recv(65536)
                except socket.timeout:
                    continue        # idle client: keep the connection
                except OSError:
                    break
                eof = not chunk
                if eof and buf:
                    buf += b"\n"    # unterminated final line = request
                buf += chunk
                while b"\n" in buf:
                    raw, buf = buf.split(b"\n", 1)
                    line = raw.decode("utf-8", "replace").rstrip("\r")
                    text = self._handle(line)
                    try:
                        conn.sendall((text + "\n")
                                     .encode("utf-8", "replace"))
                    except OSError:
                        self._bump("client_gone")
                        return
                if eof:
                    break
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- drain ---------------------------------------------------------
    def drain(self, timeout_ms: Optional[float] = None) -> dict:
        """Stop accepting, let in-flight routed requests finish, stop
        the prober, flush telemetry, return the final stats.
        Idempotent. Replicas are NOT told to drain — they are their own
        processes with their own lifecycle; the fleet drain is the
        router getting out of the traffic path cleanly.

        Exactly-one-response holds through drain WITHOUT servd's
        claim machinery because every in-flight request is bounded:
        each forward times out within ``stall_s`` (or its remaining
        deadline) and the drain flag stops further retry attempts — so
        waiting ``max(budget, stall_s)`` + slack guarantees every
        accepted request's handler returned and its response line
        reached the client before this returns."""
        budget = (self.drain_ms if timeout_ms is None
                  else float(timeout_ms)) / 1e3
        t0 = time.monotonic()
        with self._lock:
            self._draining = True
        telemetry.event({"ev": "route_drain", "phase": "begin"})
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None
        self._wake.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=2.0)
            self._probe_thread = None
        # the hard bound: one in-flight attempt per active request,
        # each <= stall_s (2x for the one-shot pre-TRACE downgrade
        # resend) — past it something is wrong enough that
        # leftover_active is reported instead of waited on forever
        hard_by = t0 + max(budget, 2.0 * self.stall_s + 2.0)
        while time.monotonic() < hard_by:
            with self._lock:
                if self._active == 0:
                    break
            time.sleep(0.02)
        with self._lock:
            self._stop = True
            leftovers = self._active
        health.pause("route.accept")
        health.pause("route.probe")
        # the laws leave the auditor with the process (a latched
        # violation survives: BooksAuditor latches are sticky)
        for law in ("route.books", "route.tenant_books",
                    "fleet.federation"):
            telemetry.audit_unregister(law)
        stats = self.stats()
        telemetry.event(dict({"ev": "route_drain", "phase": "end",
                              "seconds": round(time.monotonic() - t0,
                                               3),
                              "leftover_active": leftovers}, **stats))
        telemetry.flush()
        return stats


# ----------------------------------------------------------------------
def stitched_chrome_trace(router_rec: dict, hops) -> dict:
    """ONE cross-process Chrome trace from a router flight record plus
    ``hops`` = [(replica_name, replica_flight_record), ...]. Pure
    function — ``Router.stitched_trace`` feeds it live HTTP fetches,
    the tests feed it dicts. Lanes: pid 0 is the router (a request row
    plus an attempts row), pid 1..N one per replica hop (the replica's
    phase/recompile lanes, via ``telemetry.request_chrome_trace``).
    Every lane is placed on the SHARED wall-clock epoch (the earliest
    ``t_wall`` across the records): each flight record stamps its
    accept wall time, so cross-process alignment is a subtraction, and
    a retried request renders both attempts — shed lane and served
    lane — in true time order under one id."""
    rid = str(router_rec.get("id", "?"))
    walls = [router_rec.get("t_wall")] \
        + [r.get("t_wall") for _, r in hops]
    walls = [t for t in walls if isinstance(t, (int, float))]
    epoch = min(walls) if walls else 0.0
    r_off = float(router_rec.get("t_wall") or epoch) - epoch
    trace: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "router request %s" % rid}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
         "args": {"name": "request"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 1,
         "args": {"name": "attempts"}},
    ]
    total = float(router_rec.get("total_s") or 0.0)
    trace.append({
        "ph": "X", "name": "route:%s" % router_rec.get("outcome", "?"),
        "pid": 0, "tid": 0, "ts": round(r_off * 1e6, 1),
        "dur": round(total * 1e6, 1),
        "args": {"request": rid,
                 "outcome": router_rec.get("outcome", "?"),
                 "retries": router_rec.get("retries", 0),
                 "deadline_ms": router_rec.get("deadline_ms")}})
    for i, att in enumerate(router_rec.get("attempts") or []):
        ts = r_off + float(att.get("t_off_s") or 0.0)
        trace.append({
            "ph": "X",
            # hedge/replay lanes carry their attempt class in the
            # name so the duplicate attempt is visually distinct
            "name": ("hedge:%s" if att.get("cls") == "hedge"
                     else "forward:%s") % att.get("replica", "?"),
            "pid": 0, "tid": 1, "ts": round(ts * 1e6, 1),
            "dur": round(float(att.get("latency_s") or 0.0) * 1e6, 1),
            "args": {"request": rid, "attempt": i + 1,
                     "outcome": att.get("outcome", "?"),
                     "class": att.get("cls"),
                     "candidates": att.get("candidates")}})
    for i, (name, rrec) in enumerate(hops):
        sub = telemetry.request_chrome_trace(rrec)
        off_us = (float(rrec.get("t_wall") or epoch) - epoch) * 1e6
        for ev in sub["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = i + 1
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    ev["args"] = {"name": "replica %s" % name}
            else:
                ev["ts"] = round(float(ev.get("ts", 0.0)) + off_us, 1)
            trace.append(ev)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def route_chrome_trace(rec: dict) -> dict:
    """Router-lane-only Chrome trace of one routing flight record (the
    stitch with zero replica hops)."""
    return stitched_chrome_trace(rec, [])


# ----------------------------------------------------------------------
def _ask(port: int, line: str, timeout: float = 5.0) -> str:
    return servd._ask(port, line, timeout=timeout)


def selftest(verbose: bool = False) -> int:
    """Drive routing, retry-on-shed, breaker ejection, dead-replica
    ejection + re-admission, deadline-budget forwarding, fleet stats
    aggregation, rolling reload, and drain over real loopback sockets
    with in-process servd replicas. Runs with runtime lock-order
    enforcement on."""
    with lockrank.enforced():
        return _selftest_body(verbose)


def _selftest_body(verbose: bool = False) -> int:
    from . import statusd

    # in-memory telemetry so the replicas' statusd serve real metric
    # snapshots — the federation half of this selftest needs exact
    # histogram buckets to merge (restored at the end)
    owns_telemetry = not telemetry.enabled()
    if owns_telemetry:
        telemetry.enable()

    # two replicas with DISTINGUISHABLE models: +1 and +1000 — every
    # assertion below can see which replica answered
    wedge1 = threading.Event()
    wedge1.set()
    model1 = {"v": 1}
    reload2 = []

    def backend1(toks, seq):
        wedge1.wait(10.0)
        return [t + model1["v"] for t in toks]

    def backend2(toks, seq):
        return [t + 1000 for t in toks]

    fe1 = servd.ServeFrontend(backend1, queue_size=1, breaker_fails=1,
                              breaker_cooldown_ms=50.0, drain_ms=2000.0,
                              reload_fn=lambda: model1.update(
                                  v=model1["v"] + 1) or True)
    fe2 = servd.ServeFrontend(backend2, drain_ms=2000.0,
                              reload_fn=lambda: reload2.append(1)
                              or True)
    fe1.start()
    fe2.start()
    p1, p2 = fe1.listen(0), fe2.listen(0)
    s1 = statusd.StatusServer(0, host="127.0.0.1").start()
    s2 = statusd.StatusServer(0, host="127.0.0.1").start()
    s1.register_probe("serving", fe1.health_probe)
    s2.register_probe("serving", fe2.health_probe)
    # each replica's flight ring on its statusd: the stitched-trace
    # fetch reads /requestz?request=<id> per hop
    s1.flight = fe1.flight
    s2.flight = fe2.flight

    # probing OFF the clock (probe_ms huge): every state transition in
    # this selftest is driven deterministically — by dispatch outcomes
    # or explicit probe_now() sweeps (federation likewise: off the
    # clock, federate_now() drives it)
    router = Router([("127.0.0.1", p1, s1.port),
                     ("127.0.0.1", p2, s2.port)],
                    probe_ms=3600e3, retries=2, stall_s=5.0,
                    drain_ms=2000.0, probe_backoff_cap_s=0.2,
                    reload_timeout_s=10.0, federate_ms=3600e3,
                    outlier_min_n=1)
    router.start()
    rport = router.listen(0)
    r1, r2 = router._replicas
    srv = statusd.StatusServer(0, host="127.0.0.1").start()
    srv.fleet = router
    srv.flight = router.flight
    try:
        # zero load, index tie-break: replica 1 answers
        assert _ask(rport, "1 2") == "2 3"
        # retry-on-shed: wedge replica 1 and fill its 1-slot queue so
        # any pick of it sheds `ERR busy queue`; the router must retry
        # on replica 2 transparently
        wedge1.clear()
        fe1.submit("7", lambda t: None)      # occupies the worker
        deadline = time.monotonic() + 5.0
        while not fe1._inflight and time.monotonic() < deadline:
            time.sleep(0.01)                 # wait for the worker pop
        fe1.submit("8", lambda t: None)      # fills the 1-slot queue
        # direct shed proves the detail token (the wire contract)
        direct = _ask(p1, "9")
        assert direct.startswith("ERR busy queue"), direct
        assert retryable(direct)
        assert _ask(rport, "5") == "1005"    # retried onto replica 2
        st = router.stats()
        assert st["retries"] >= 1 and st["served"] == 2, st
        wedge1.set()                         # un-wedge; queue drains
        deadline = time.monotonic() + 5.0
        while fe1.stats()["served"] < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.01)

        # breaker ejection: one failure opens replica 1's breaker
        # (breaker_fails=1). The failure itself is relayed (dispatched:
        # never retried); the NEXT pick of replica 1 sheds `ERR busy
        # breaker`, which both retries elsewhere AND ejects it.
        fe1.backend = servd_explode
        assert _ask(rport, "3").startswith("ERR backend")
        st = router.stats()
        assert st["errors"] == 1, st
        assert fe1.breaker.state == "open"
        assert _ask(rport, "4") == "1004"    # shed by 1, served by 2
        assert r1.state == BREAKER_OPEN, r1.state
        # ejected: routed straight to replica 2, no retry spent
        pre = router.stats()["retries"]
        assert _ask(rport, "6") == "1006"
        assert router.stats()["retries"] == pre

        # re-admission by probe: heal the backend, close the breaker
        # with a direct half-open probe, then one probe sweep
        fe1.backend = backend1
        time.sleep(0.08)                     # past the 50ms cooldown
        assert _ask(p1, "1") == "2"
        assert fe1.breaker.state == "closed"
        router.probe_now()
        assert r1.state == UP, (r1.state, r1.detail)

        # dead-replica ejection + backoff re-probe: a replica whose
        # ports answer nothing is marked dead at dispatch (connect
        # refused: never sent, SAFE retry) and re-probed on the
        # backoff schedule
        with socket.socket() as tmp:
            tmp.bind(("127.0.0.1", 0))
            dead_port = tmp.getsockname()[1]
        router2 = Router([("127.0.0.1", dead_port, dead_port),
                          ("127.0.0.1", p2, s2.port)],
                         probe_ms=3600e3, retries=2, stall_s=5.0,
                         drain_ms=1000.0, probe_backoff_cap_s=0.2)
        router2.start()
        rport2 = router2.listen(0)
        try:
            assert _ask(rport2, "11") == "1011"
            d1 = router2._replicas[0]
            assert d1.state == DEAD and d1.ejections == 1
            assert router2.stats()["retries"] == 1
            # backing off: a sweep before next_probe_at skips it
            fails = d1.probe_fails
            router2.probe_now()
            assert d1.probe_fails == fails, "re-probed inside backoff"
            time.sleep(0.25)                 # past the 0.2s cap
            router2.probe_now()
            assert d1.probe_fails == fails + 1, "backoff re-probe ran"
        finally:
            router2.drain(timeout_ms=500)

        # deadline budget forwarding: a mirror replica echoes the line
        # it was sent — the forwarded line must carry the minted TRACE
        # id and the REMAINING deadline budget, not the original
        mirror = _MirrorReplica().start()
        router3 = Router([("127.0.0.1", mirror.port, mirror.port)],
                         probe_ms=3600e3, retries=0, stall_s=5.0,
                         drain_ms=1000.0)
        router3.start()
        rport3 = router3.listen(0)
        try:
            resp = _ask(rport3, "DEADLINE 5000 1 2 3")
            toks = resp.split()
            assert toks[0] == "TRACE" and servd.valid_trace_id(toks[1])
            assert toks[2] == "DEADLINE" and toks[4:] == ["1", "2", "3"]
            assert 0 < int(toks[3]) <= 5000, resp
            # a client-sent TRACE id is adopted, not re-minted
            resp = _ask(rport3, "TRACE client-1 9 9")
            assert resp.split()[:2] == ["TRACE", "client-1"], resp
            assert router3.flight.get("client-1") is not None
            # an expired budget is answered by the ROUTER, not routed
            assert _ask(rport3, "DEADLINE 0 9") \
                .startswith("ERR deadline")
            assert router3.stats()["deadline"] == 1
        finally:
            router3.drain(timeout_ms=500)
            mirror.stop()

        # fleet ADMIN stats aggregates and reconciles
        resp = _ask(rport, "ADMIN stats")
        assert resp.startswith("OK "), resp
        agg = {k: int(v) for k, _, v in
               (kv.partition("=") for kv in resp[3:].split())}
        assert agg["reachable"] == 2 and agg["replicas"] == 2
        assert agg["accepted"] == (agg["served"] + agg["errors"]
                                   + agg["shed"] + agg["deadline"]), agg
        assert _ask(rport, "ADMIN fleet").startswith("OK ")
        assert _ask(rport, "ADMIN bogus").startswith("ERR parse")

        # rolling reload: both replicas reload one at a time, the drain
        # windows never overlap (capacity stays >= N-1), and the fleet
        # keeps serving throughout
        v_before = model1["v"]
        assert _ask(rport, "ADMIN reload").startswith("OK fleet")
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with router._lock:
                done = len(router._windows) >= 2 \
                    and not router._reloading
            if done:
                break
            # the fleet keeps answering while the roll is in flight
            assert not _ask(rport, "2").startswith("ERR")
            time.sleep(0.02)
        snap = router.fleet_snapshot()
        assert len(snap["windows"]) == 2, snap["windows"]
        w1, w2 = snap["windows"]
        assert w1["back_s"] <= w2["out_s"] or \
            w2["back_s"] <= w1["out_s"], "drain windows overlap"
        assert model1["v"] == v_before + 1 and reload2, \
            "rolling reload did not reach both replicas"

        # /fleetz + cxxnet_fleet_* ride statusd
        code, body = _http_status(srv.port, "/fleetz?json=1")
        assert code == 200 and '"replicas"' in body
        code, metrics = _http_status(srv.port, "/metrics")
        assert "cxxnet_fleet_replicas" in metrics
        assert 'cxxnet_fleet_replica_up{' in metrics

        # -- fleet observability plane ---------------------------------
        # ONE trace id names the request on the router AND on the
        # replica that served it (TRACE propagation end to end)
        assert not _ask(rport, "TRACE obs-1 2").startswith("ERR")
        rrec = router.flight.get("obs-1")
        assert rrec is not None and rrec["outcome"] == "served", rrec
        served_by = rrec["attempts"][-1]["replica"]
        hop_fe = fe1 if served_by.endswith(":%d" % p1) else fe2
        hop = hop_fe.flight.get("obs-1")
        assert hop is not None and hop["outcome"] == "served", hop
        # the stitched cross-process trace off the router's statusd:
        # router attempt lane (pid 0) + the replica's phase lane
        code, body = _http_status(srv.port, "/trace?request=obs-1")
        assert code == 200, body
        stitched = json.loads(body)
        xs = [t for t in stitched["traceEvents"] if t.get("ph") == "X"]
        assert any(t["name"].startswith("forward:") for t in xs)
        assert any(t["name"] == "prefill" and t["pid"] >= 1
                   for t in xs), xs
        assert all(t.get("args", {}).get("request") == "obs-1"
                   for t in xs)
        code, body = _http_status(srv.port, "/trace?request=missing")
        assert code == 404
        # router /requestz: bounded listing of the routing flights
        code, body = _http_status(srv.port, "/requestz?json=1&n=2")
        assert code == 200
        lst = json.loads(body)
        assert lst["shown"] <= 2 and lst["total"] >= 2

        # the autopsy plane: every routing record carries its verdict;
        # stitched_why (the /why source) refines the winner's latency
        # lane with the replica's own books and still tiles total_s
        assert rrec["autopsy"]["primary"] in autopsy.CAUSES, rrec
        why = router.stitched_why("obs-1")
        assert why is not None and why["hops"], why
        maut = why["autopsy"]
        assert abs(sum(maut["causes"].values()) - maut["wall_s"]) \
            <= max(1e-6, 0.05 * maut["wall_s"]), maut
        assert router.stitched_why("missing") is None
        # the fleet incident timeline merges this router's incident
        # rows with every replica's /eventz feed, wall-clock ordered
        rows = router.fleet_eventz(n=64)
        assert rows, "fleet_eventz returned no rows"
        walls = [r["t_wall"] for r in rows]
        assert walls == sorted(walls)
        assert any(r.get("process") != "router" for r in rows), rows
        # the conservation-law auditor sweeps clean over a healthy
        # router + fleet (route books / tenant books / federation)
        viol = telemetry.audit_sweep()
        assert not any(viol.values()), viol
        assert not telemetry.auditor().snapshot()["broken"]

        # live federation: EXACT histogram merge — for every merged
        # series the fleet bucket counts equal the sum of the
        # per-replica snapshot buckets (the acceptance criterion)
        code, b1 = _http_status(s1.port, "/metrics?json=1")
        code2, b2 = _http_status(s2.port, "/metrics?json=1")
        assert code == 200 and code2 == 200
        shards = [json.loads(b1)["metrics"]["hists"],
                  json.loads(b2)["metrics"]["hists"]]
        assert router.federate_now() == 2
        fed = router.federation_snapshot()
        assert fed is not None and fed["replicas"] == 2
        assert "serve.request" in fed["series"], fed["series"].keys()
        for name, h in fed["series"].items():
            expect: Dict[str, int] = {}
            for shard in shards:
                for i, c in (shard.get(name, {}).get("buckets")
                             or {}).items():
                    expect[i] = expect.get(i, 0) + c
            assert h["buckets"] == expect, (name, h["buckets"], expect)
        # no outlier between two identically-loaded replicas; the
        # verdicts (and the federated series) ride /fleetz + /metrics
        assert fed["outliers"] and not any(
            v["outlier"] for v in fed["outliers"].values())
        code, metrics = _http_status(srv.port, "/metrics")
        assert "cxxnet_fleet_serve_request_seconds_bucket" in metrics
        assert "cxxnet_fleet_federated_replicas" in metrics
        assert "cxxnet_fleet_outlier{" in metrics
        for line in metrics.splitlines():
            if line and not line.startswith("#"):
                assert statusd.PROM_LINE_RE.match(line), line

        assert router.health_probe()[0] and router.liveness_probe()[0]
    finally:
        stats = router.drain()
        srv.stop()
        s1.stop()
        s2.stop()
        fe1.drain(timeout_ms=1000)
        fe2.drain(timeout_ms=1000)
        if owns_telemetry:
            telemetry.disable()
    assert stats["accepted"] == (stats["served"] + stats["errors"]
                                 + stats["shed"] + stats["deadline"]), \
        "router counters do not reconcile: %r" % (stats,)
    assert router.health_probe() == (
        False, "draining: not accepting new requests")
    if verbose:
        print("routerd selftest: routing/retry-on-shed/breaker-eject/"
              "dead-eject+backoff/deadline-budget/fleet-stats/"
              "rolling-reload/drain + trace-propagation/stitched-trace/"
              "exact-federation/outliers ok (%r)" % (stats,))
    return 0


def servd_explode(toks, seq):
    raise RuntimeError("injected replica failure")


class _MirrorReplica:
    """A fake replica that answers every request line with the line
    itself — the fixture that makes the router's DEADLINE rewrite
    observable (a real servd consumes the prefix)."""

    def __init__(self):
        self.port = None
        self._sock = None
        self._thread = None

    def start(self) -> "_MirrorReplica":
        self._sock = socket.create_server(("127.0.0.1", 0))
        self._sock.settimeout(0.25)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._run,
                                        name="cxn-mirror", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while self._sock is not None:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                try:
                    line = conn.makefile("r").readline()
                    conn.sendall(line.encode())
                except OSError:
                    pass

    def stop(self) -> None:
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass


def _http_status(port: int, path: str) -> Tuple[int, str]:
    try:
        return _http_get("127.0.0.1", port, path, 5.0)
    except OSError as e:
        return 0, repr(e)


if __name__ == "__main__":
    if "--selftest" in sys.argv[1:]:
        sys.exit(selftest(verbose=True))
    print(__doc__)
    sys.exit(1)
