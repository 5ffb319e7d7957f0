"""The port's serving frontend: admission control, deadlines, breaker, drain.

The port's own copy of cxxnet_tpu/utils/servd.py, whole: the same
behaviour, wire format, counters, flight records and events. A
standard-library-only concurrent frontend that wraps the trainer's
``generate`` (solo dispatch) or its ``decode_session`` (continuous
batching) behind a TCP line protocol, and is also the engine behind the
stdin ``task = serve`` loop of ``bin/cxxnet_torch``. What the JAX package
calls a compile (an XLA program built inside a request) is, in the port,
the first-use build and load of a CUDA kernel library by ``ops/_build.py``;
the compile windows and ``recompiles`` fields below carry those records.
The status HTTP server (``utils/statusd.py``) reads the frontend's probes,
flight recorder and batch account. The performance ledger
(``utils/perf.py``) gives every flight record its decode bound
(``roofline_bound_tokens_per_s``, None until a decode-step card is ready)
and the warm-grid account behind ``set_warm_account``. The fleet router
(``utils/routerd.py``, ``task = route``) routes over such replicas.

What a request gets on the way to the backend:

* **admission control** — a bounded queue (``serve_queue``); when it is
  full the request is fast-rejected ``ERR busy`` from the reader thread
  (never queued, never stalls the worker) and counted (``serve.shed``).
  Load past capacity degrades into cheap rejections, not latency collapse.
* **deadlines** — ``serve_deadline_ms`` default, or a per-request
  ``DEADLINE <ms>`` prefix; a request whose deadline expired while queued
  is answered ``ERR deadline`` BEFORE dispatch (the backend never burns
  decode time on an answer nobody is waiting for) and counted.
* **backend supervision** — any backend exception is caught, answered
  ``ERR backend``, counted, and fed to a **circuit breaker**: after
  ``serve_breaker_fails`` consecutive failures it opens and requests shed
  instantly (no queue wait, no backend call); after an exponential-backoff
  cooldown (the shared ``checkpoint.backoff_delay`` schedule) ONE request
  goes through as a half-open probe — success closes the breaker, failure
  reopens it with a doubled cooldown.
* **graceful drain** — ``drain()`` (the driver calls it off the
  ``PreemptionGuard`` SIGTERM/SIGINT flag) stops accepting, finishes every
  accepted request within ``serve_drain_ms``, answers whatever is left
  ``ERR draining``, flushes telemetry, and returns the final stats —
  exactly one response line per accepted request, always.
* **hot reload** — ``ADMIN reload`` (or SIGHUP in the driver) sets a flag
  the worker honors BETWEEN requests: the reload callback swaps in the
  newest valid checkpoint without dropping the queue.

Wire protocol (one line per request, one line per response, utf-8):

    <tok> <tok> ...                 -> <id> <id> ...        (continuation)
    DEADLINE <ms> <tok> ...         -> same, with a per-request deadline
    TRACE <id> [DEADLINE <ms>] ...  -> same, request adopts the caller's
                                       fleet-wide trace id (see below)
    TENANT <id> [DEADLINE <ms>] ... -> same, request runs as tenant <id>
                                       (after TRACE, before DEADLINE)
    ADMIN reload                    -> OK reload scheduled
    ADMIN stats                     -> OK accepted=.. served=.. ...
    (anything else)                 -> ERR <class> <detail>

``TRACE <id>`` is the cross-process trace-propagation prefix (the
Dapper idea: ONE id names a request on every process that touched it).
The fleet router (utils/routerd.py) mints an id per client request and
stamps it on every forward attempt; this frontend adopts it as the
request id its ``telemetry.trace_context`` / flight record / ``/trace
?request=<id>`` surface uses — so a request retried across replicas is
findable on each of them under the same id. The prefix composes with
``DEADLINE`` (TRACE first), is optional (a TRACE-less client gets a
locally minted id, exactly as before), and is validated: the id must
be 1..``TRACE_ID_MAX`` chars of ``[A-Za-z0-9._:-]``; anything else is
answered ``ERR proto trace ...`` (class ``proto``: a protocol-level
violation, deterministic, never dispatched).

**Multi-tenant weighted-fair QoS** (doc/serving.md "Multi-tenant
QoS"): a ``tenants`` table (``parse_tenants("free:1,paid:4")`` — give
every process in the fleet the SAME value) makes the admission queue
per-tenant weighted-fair (``_FairQueue``: stride-scheduled pops, fair
shares of the queue bound with borrow-then-evict capacity fairness),
adds per-tenant books to ``ADMIN stats`` (``tenant.<id>.<key>=N``,
reconciling per tenant), per-tenant latency histograms
(``serve.tenant.<t>.request`` — the federation merges them into fleet
p99s) and per-tenant SLO windows (``slo_tenants``). The ``TENANT``
prefix names the request's tenant; prefix-less clients run as
``tenant_default``. A tenant at/over its fair share of a full queue is
shed ``ERR busy tenant ...`` — third token wire format: the fleet
router relays it WITHOUT retry (the verdict holds fleet-wide).

Error classes: ``empty`` (blank request — visible instead of a silently
missing response), ``parse`` (non-integer token, token outside vocab, bad
DEADLINE), ``proto`` (malformed TRACE or TENANT prefix, unknown
tenant), ``busy`` (queue full, breaker open, or tenant over fair
share: shed), ``deadline``,
``backend``, ``draining``. The THIRD token of an error line is a
machine-readable detail token — the retryability contract the fleet
router (utils/routerd.py) dispatches on, so these are wire format, not
prose (the full vocabulary is ONE table in doc/serving.md "Error
vocabulary"): ``ERR busy queue ...`` (admission queue full — the request
never
dispatched, instantly retryable on another replica) vs ``ERR busy
breaker ...`` (circuit breaker open — also never dispatched, retryable
elsewhere, but the replica should leave rotation); ``ERR draining
server ...`` (refused at the door) and ``ERR draining shutdown ...``
(queued, never dispatched) are retryable, ``ERR draining backend ...``
(the in-flight request drain gave up on) may have dispatched and is
NOT. Counters reconcile:
``accepted == served + errors + shed + deadline``. A request arriving
AFTER drain began is refused (``ERR draining``) without entering the
accounting — it was never accepted, so drain's final stats stay final.
Responses leave each connection in request order (the protocol pairs
them positionally), even when a rejection is produced instantly while
earlier requests are still queued.

Observability — every accepted request gets a **request id** and its
life is decomposed into phase-attributed telemetry (the measurement
contract the batching/paging/prewarm throughput arc is graded against):

* **phases** (they tile accept->answer wall-clock): ``queue_wait``
  (accept -> worker pop), ``dispatch`` (pop -> backend call),
  ``prefill`` (backend call -> first token — the worker runs the
  backend under ``telemetry.trace_context(request_id)``, and the
  trainer marks ``first_token`` at its prefill/decode split), and
  ``decode`` (first token -> last token, i.e. per-token time).
* **series**: counters ``serve.accepted/requests/errors/shed/deadline/
  empty/client_gone/backend_errors/breaker_*/reloads/tokens``, gauges
  ``serve.queue_depth`` / ``serve.in_flight`` /
  ``serve.tokens_per_second`` / ``serve.batch_occupancy`` (sequences in
  the most recent decode pass — reads 1 today, the headline once
  batching lands), histograms ``serve.request`` (end-to-end),
  ``serve.queue_wait``, ``serve.ttft`` (accept -> first token) and
  ``serve.decode_per_token`` — declared at start() so /metrics exports
  the bucket series from scrape one.
* **flight recorder**: the last ``flight_cap`` dequeued requests keep
  their full trace (phase split, tokens, outcome, the recompiles they
  paid) in ``self.flight`` (telemetry.FlightRecorder) — statusd serves
  one as a Chrome trace at ``/trace?request=<id>`` and lists the ring
  at ``/requestz``; each also emits a ``serve_request_done`` event
  (tools/telemetry_report.py's request-breakdown section).
* **SLOs**: pass ``slo=statusd.SLOTracker(...)`` and every completed
  request feeds the rolling error-budget account behind the
  ``cxxnet_slo_burn`` alert gauge.

``health_probe`` (readiness: 503 while draining
or breaker-open) and ``liveness_probe`` (worker thread death) plug into
statusd ``/healthz`` / ``/livez``; the accept and worker threads beat the
``serve.accept`` / ``serve.worker`` watchdog channels (paused across idle
periods so an empty queue is not a hang).

**Continuous batching** (doc/serving.md "Continuous batching"): pass a
``slot_backend`` and the worker becomes an iteration-granularity
batching dispatcher instead of the one-request-per-pass loop. The slot
backend owns bucketed decode sessions (``buckets`` = slot counts, e.g.
``1,2,4,8``; ``session(bucket)`` opens one; a session exposes
``prefill(slot, toks, seq) -> (first_token, done)``, ``step() ->
[(slot, token, done), ...]``, ``retire(slot)`` and optionally
``close()`` / the backend ``admits(toks) -> error-detail-or-None``
compatibility check) — ``Trainer.decode_session`` is the real one, the
tests inject fakes (tests/test_torch_servd.py). Scheduling:

* **coalesce** — up to ``batch_max`` queued requests are drained within
  a ``batch_window_ms`` gather window and admitted into the smallest
  bucket that fits; the window applies only when STARTING a batch —
  requests already decoding never stall on it.
* **iteration granularity** — each loop turn advances every active slot
  one token; a finished sequence retires its slot and the next queued
  request joins MID-DECODE (its ``queue_wait`` ends at slot admission).
* **per-iteration deadlines** — an expired sequence retires with ``ERR
  deadline`` between iterations; the others keep decoding.
* **contracts kept** — exactly-once ``_finish`` per request (drain
  mid-batch answers every in-flight slot), breaker semantics (a
  prefill/step failure that CLOSED the session — the device-fault
  signal of the session contract — counts ONE breaker failure however
  many requests die of it, and a step failure fails the whole batch
  ``ERR backend``; a prefill that raised with the session left OPEN
  never touched device state — pre-dispatch validation — and is a
  deterministic request defect the breaker ignores), honest
  per-request phases (prefill
  is the request's own admission prefill; decode is ITS first->last
  token wall; ``occupancy_at_dispatch`` rides the flight record), and
  hot reload deferred until the in-flight batch finishes (the slot
  caches hold the old model's K/V; sessions are closed, then reloaded).
* **occupancy is measured, not asserted** — every iteration feeds
  ``serve.batch_occupancy`` (gauge: last iteration) plus the honest
  weighted-mean pair ``serve.batch_iterations`` /
  ``serve.batch_slot_iterations`` (mean occupancy = slots/iterations —
  a last-write gauge scraped between batches lies), and ``ADMIN stats``
  reports ``free_slots`` (bucket capacity − active) plus per-bucket
  ``batch_buckets`` / ``bucket.<b>.warm`` / ``bucket.<b>.active`` so
  the fleet router can prefer the replica that can batch a request in.
* **block-aware admission (paged KV)** — a backend exposing the
  paged-pool hooks (``kv_free_blocks`` / ``kv_fresh_blocks`` /
  ``kv_pool_account``; doc/performance.md "Decode KV cache") gets a
  block-budgeted gather: a queued request is popped only when the
  pool covers its prompt + generation blocks RIGHT NOW, head-of-queue
  order, no skip-ahead — pool exhaustion is a deterministic FIFO
  queue-wait, never an error, never a device OOM. A retirement
  returns its blocks mid-decode and the next turn's gather admits
  into them; the rare budget race (``kvblocks.KVPoolExhausted`` from
  a prefill that ran no device work) REQUEUES at the queue head.
  ``ADMIN stats`` gains ``kv_blocks_total``/``kv_blocks_free`` +
  ``bucket.<b>.blocks_held``, and ``batch_snapshot()`` the ``pool``
  sub-dict (free-list level, prefix-reuse/CoW tallies, block-exact
  ``pool_bytes`` — what ``decode_kv_bytes`` reports under paging).
* **the scheduler is observed per ITERATION** (doc/observability.md
  "Decode datapath") — every decode iteration lands in the
  ``BatchFlightRecorder`` ring (``batch_flight_cap``): bucket, step
  latency, the slots aboard with each occupant's request id and age,
  admissions/retirements, queue depth + head-of-queue age (also the
  ``serve.queue_age`` histogram), live-KV utilization, convoy verdict.
  statusd serves it at ``/batchz`` and renders a request's iterations
  as slot-Gantt lanes inside its ``/trace?request=<id>`` trace;
  ``batch_iteration`` JSONL events fire on composition CHANGES only
  (never per token). The per-bucket KV account (``batch_snapshot``,
  joined from each session's ``kv_account()``) publishes
  ``cxxnet_decode_kv_bytes{bucket=}`` / ``cxxnet_decode_kv_live_pct``
  / ``cxxnet_decode_slot_waste_pct`` — the padding+dead-slot waste a
  paged KV cache (ROADMAP item 2) would reclaim — and feeds the perf
  ledger's HBM headroom account (``decode_kv_bytes``). A **convoy**
  — a sequence aboard >= ``convoy_iters`` iterations while queued work
  waits at zero free slots — latches ``cxxnet_decode_convoy``, counts
  ``serve.convoys``, and emits ONE transition-only ``decode_convoy``
  event per episode: the starvation signal the disaggregation
  scheduler and the autoscaler's pressure pass consume.

Standard library only (like health.py and statusd.py): the backend is an
injected callable, so ``python -m cxxnet_tpu_torch.utils.servd --selftest``
proves the whole admission/deadline/breaker/drain machinery over a real
socket on a box with no card, and ``--stub`` runs a standalone echo server
the tests drive as a subprocess (SIGTERM drain, floods, exploding
backends).
"""

from __future__ import annotations

import re
import socket
import sys
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

from . import autopsy
from . import checkpoint as ckpt
from . import health
from . import kvblocks
from . import lockrank
from . import perf
from . import statusd
from . import telemetry

__all__ = ["CircuitBreaker", "ServeFrontend", "BatchFlightRecorder",
           "embed_vocab",
           "TRACE_ID_MAX", "valid_trace_id", "TENANT_ID_MAX",
           "valid_tenant_id", "parse_tenants", "selftest"]

# the TRACE prefix's id bound: long enough for any reasonable minting
# scheme (router prefix + counter, uuid hex), short enough that a
# garbage line cannot smuggle kilobytes into every flight record and
# JSONL event the id is stamped on
TRACE_ID_MAX = 64
_TRACE_ID_RE = re.compile(r"[A-Za-z0-9._:-]{1,%d}$" % TRACE_ID_MAX)


def valid_trace_id(tid: str) -> bool:
    """The TRACE id charset/length contract, shared with the router (it
    validates before forwarding, and mints ids that pass): 1..64 chars
    of ``[A-Za-z0-9._:-]`` — safe in URLs (``/trace?request=<id>``),
    label values, and log lines without escaping."""
    return bool(_TRACE_ID_RE.match(tid))


def parse_trace_prefix(parts: List[str]):
    """Strip a leading ``TRACE <id>`` from a token list ->
    ``(trace_id, proto_detail, rest)``. ``trace_id`` is None when no
    prefix was present; ``proto_detail`` (None when valid) is the
    detail text of the ``ERR proto`` line — ONE implementation of the
    wire-format check, shared by servd's parser and the router's (the
    two must never desynchronize on what a malformed prefix is)."""
    if parts[:1] != ["TRACE"]:
        return None, None, parts
    if len(parts) < 2:
        return None, "trace prefix needs an id", parts
    if not valid_trace_id(parts[1]):
        return None, ("trace id must be 1..%d chars of "
                      "[A-Za-z0-9._:-]" % TRACE_ID_MAX), parts
    return parts[1], None, parts[2:]


# the TENANT prefix's id bound: tenant names are CONFIG identifiers
# (route_tenants / serve_tenant_default), not free-form client strings —
# short, and ':' is excluded (it is the weight separator in the conf
# value "free:1,paid:4")
TENANT_ID_MAX = 32
_TENANT_ID_RE = re.compile(r"[A-Za-z0-9._-]{1,%d}$" % TENANT_ID_MAX)


def valid_tenant_id(tid: str) -> bool:
    """The TENANT id charset/length contract, shared with the router
    (it validates before forwarding): 1..32 chars of ``[A-Za-z0-9._-]``
    — safe in metric names, label values, and the conf syntax."""
    return bool(_TENANT_ID_RE.match(tid))


def parse_tenant_prefix(parts: List[str]):
    """Strip a leading ``TENANT <id>`` from a token list ->
    ``(tenant, proto_detail, rest)``. ``tenant`` is None when no prefix
    was present; ``proto_detail`` (None when valid) is the detail text
    of the ``ERR proto`` line — ONE implementation of the wire-format
    check, shared by servd's parser and the router's (the
    parse_trace_prefix discipline: the two must never desynchronize)."""
    if parts[:1] != ["TENANT"]:
        return None, None, parts
    if len(parts) < 2:
        return None, "tenant prefix needs an id", parts
    if not valid_tenant_id(parts[1]):
        return None, ("tenant id must be 1..%d chars of "
                      "[A-Za-z0-9._-]" % TENANT_ID_MAX), parts
    return parts[1], None, parts[2:]


def parse_tenants(spec):
    """``route_tenants`` conf value -> ``{tenant: weight}``.
    ``"free:1,paid:4"`` (comma/whitespace separated, ``name[:weight]``,
    weight defaults to 1). Empty/None -> ``{}`` (single-tenant mode:
    every fairness path short-circuits to pre-tenant behavior). Shared
    by servd, routerd, and the driver so the tenant table cannot drift
    between the processes enforcing it."""
    if not spec:
        return {}
    if isinstance(spec, dict):
        out = {str(k): float(v) for k, v in spec.items()}
    else:
        out = {}
        for item in re.split(r"[,\s]+", str(spec).strip()):
            if not item:
                continue
            name, _, w = item.partition(":")
            out[name] = float(w) if w else 1.0
    for name, w in out.items():
        if not valid_tenant_id(name):
            raise ValueError("tenant name %r is not 1..%d chars of "
                             "[A-Za-z0-9._-]" % (name, TENANT_ID_MAX))
        if not (w > 0):
            raise ValueError("tenant %r needs a positive weight, got %r"
                             % (name, w))
    return out


def embed_vocab(net) -> int:
    """The vocab bound for parse-time token validation: the largest
    embed layer's vocab_size in a built net (0 = no embed layer, no
    bound). Shared by the learn-task and api serving surfaces so the
    check cannot drift between them. Pure attribute access."""
    return max((lay.vocab_size for lay in net.layers
                if getattr(lay, "type_name", "") == "embed"), default=0)


class CircuitBreaker:
    """Consecutive-failure circuit breaker with half-open probes.

    States: ``closed`` (healthy) → ``open`` after ``fails`` consecutive
    backend failures (every dispatch shed instantly) → ``half_open`` once
    the cooldown elapses (exactly ONE request goes through as a probe) →
    ``closed`` on probe success, or back to ``open`` with a doubled
    cooldown on probe failure. The cooldown follows the shared
    ``checkpoint.backoff_delay`` exponential schedule, so a backend that
    stays broken is probed ever more rarely instead of hammered.

    Thread-safe; every transition emits a ``serve_breaker`` telemetry
    event and a ``serve.breaker_<state>`` counter (what
    tools/telemetry_report.py's serving section and its unresolved-open
    exit-2 gate read).
    """

    def __init__(self, fails: int = 5, cooldown: float = 1.0,
                 max_cooldown: float = 30.0, clock=time.monotonic):
        self.fails = max(1, int(fails))
        self.cooldown = float(cooldown)
        self.max_cooldown = float(max_cooldown)
        self._clock = clock
        self._lock = lockrank.lock("servd.breaker")
        self.state = "closed"
        self.consecutive = 0      # consecutive backend failures
        self.opens = 0            # open transitions since last close
        #                           (the backoff exponent)
        self.transitions = 0
        self.reopen_at = 0.0

    def _transition(self, state: str, delay: Optional[float] = None):
        # lock held by the caller
        self.state = state
        self.transitions += 1
        telemetry.count("serve.breaker_%s" % state)
        ev = {"ev": "serve_breaker", "state": state,
              "consecutive_fails": self.consecutive}
        if delay is not None:
            ev["retry_in_s"] = round(delay, 3)
        telemetry.event(ev)

    def blocked(self) -> bool:
        """Admission-time fast check: True while open and still cooling —
        the caller sheds instantly without queueing."""
        with self._lock:
            return self.state == "open" and self._clock() < self.reopen_at

    def allow(self) -> bool:
        """Dispatch-time gate: True to call the backend. While open, the
        first call after the cooldown becomes the half-open probe; until
        that probe resolves every other dispatch is refused."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open" and self._clock() >= self.reopen_at:
                self._transition("half_open")
                return True
            return False

    def success(self) -> None:
        with self._lock:
            self.consecutive = 0
            if self.state != "closed":
                self.opens = 0
                self._transition("closed")

    def failure(self) -> None:
        with self._lock:
            self.consecutive += 1
            if self.state == "half_open" or (
                    self.state == "closed"
                    and self.consecutive >= self.fails):
                delay = ckpt.backoff_delay(self.opens,
                                           base_delay=self.cooldown,
                                           cap=self.max_cooldown)
                self.opens += 1
                self.reopen_at = self._clock() + delay
                self._transition("open", delay=delay)

    def describe(self) -> str:
        return ("%s (%d consecutive failures)"
                % (self.state, self.consecutive))


class _ConnState:
    """Per-connection response state: slot-ordered reply buffer + the
    count of filled-but-untransmitted responses (what drain waits on)."""

    __slots__ = ("cond", "slots", "dead", "eof", "unsent")

    def __init__(self):
        self.cond = lockrank.condition("servd.conn")
        self.slots: deque = deque()    # [text or None] per submitted line
        self.dead = False              # send failed: connection torn down
        self.eof = False               # reader saw client EOF
        self.unsent = 0                # filled slots not yet transmitted


# _admit_one's "block pool could not cover this admission" verdict —
# distinct from None (rejected / failed / finished at prefill) so the
# worker loop can requeue the request and its unadmitted batchmates
_KV_DEFER = object()


class _Request:
    __slots__ = ("toks", "deadline", "t_arrival", "t_wall", "reply",
                 "done", "seq", "id", "tenant", "_alock", "answered",
                 "kv_defers")

    def __init__(self, toks: List[int], deadline: Optional[float], reply,
                 tenant: Optional[str] = None):
        self.toks = toks
        self.tenant = tenant
        self.t_arrival = time.monotonic()
        # cxxlint: disable=wallclock — flight-record arrival epoch, never
        # subtracted: durations in this class all come from t_arrival
        self.t_wall = time.time()
        self.id = "?"                # assigned under the admission lock
        # deadline arrives relative (seconds); stored absolute monotonic
        self.deadline = None if deadline is None \
            else self.t_arrival + deadline
        self.reply = reply
        self.done = threading.Event()
        self.seq = -1
        # exactly-once answer guard: drain can give up on a request
        # whose backend wedged past the budget while the worker might
        # still answer it later — only the first answer goes out
        self._alock = lockrank.lock("servd.request")
        self.answered = False
        # block-pool admission defers this request ate (the paged-KV
        # requeue path) — the autopsy's kv_defer attribution signal
        self.kv_defers = 0


class _SlotState:
    """Per-slot request state on the batching dispatcher: the admitted
    request, its trace context (first_token mark, recompiles), its
    phase timestamps (queue_wait ended at slot admission), the tokens
    produced so far, the batch occupancy at its admission, and its
    scheduling coordinates (bucket, slot, first/last step-iteration
    ordinal — what lets /requestz answer "who did this request share
    its decode with" without the iteration ring)."""

    __slots__ = ("req", "tc", "queue_wait", "t_pop", "t_back", "toks",
                 "occ", "slot", "bucket", "first_iter", "last_iter",
                 "stall_s")

    def __init__(self, req, tc, queue_wait, t_pop, t_back, toks, occ,
                 slot, bucket):
        self.req = req
        self.tc = tc
        self.queue_wait = queue_wait
        self.t_pop = t_pop
        self.t_back = t_back
        self.toks = toks
        self.occ = occ
        self.slot = slot
        self.bucket = bucket
        # step-iteration ordinals this sequence was aboard for (None
        # until its first step: an n_new == 1 request finishes at
        # prefill and never shares a decode pass)
        self.first_iter = None
        self.last_iter = None
        # compile seconds this request sat through OUTSIDE its own
        # trace context — batch-wide cliffs (warm-session creation,
        # the shared decode step) the dispatcher's compile window
        # attributed to every sequence aboard; its own prefill's
        # recompiles already land on tc.compiles
        self.stall_s = 0.0


class _FairQueue:
    """Per-tenant weighted-fair admission queue (stride scheduling).

    Drop-in for the single admission deque — ``append`` / ``popleft`` /
    ``__len__`` / ``__bool__`` / ``__iter__`` / ``clear`` — except pops
    interleave tenants by WEIGHT instead of arrival order: each tenant
    carries a virtual time advanced by ``1/weight`` per pop, and
    ``popleft`` serves the backlogged tenant furthest behind. A
    weight-4 tenant therefore gets 4 dispatches for every 1 a weight-1
    tenant gets while both are backlogged, and an idle tenant's unused
    share flows to the others (its virtual time is clamped forward to
    the clock when it returns, so idling banks no credit).

    Capacity fairness rides ``over_share``/``evict_over_share``: each
    tenant's fair share of the bound is ``queue_size * w/W`` (floored
    at 1); a tenant may BORROW idle capacity beyond its share, but when
    the queue is full an arrival from an under-share tenant evicts the
    newest queued request of the most-over-share tenant — the shed is
    charged to the tenant over its fair share, never to the victim.
    All methods run under the frontend's admission lock."""

    def __init__(self, weights, queue_size: int):
        total = float(sum(weights.values()))
        self._qs = {t: deque() for t in sorted(weights)}
        self._stride = {t: 1.0 / w for t, w in weights.items()}
        self.shares = {t: max(1, int(queue_size * w / total))
                       for t, w in weights.items()}
        self._vt = {t: 0.0 for t in weights}
        self._vclock = 0.0
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __iter__(self):
        for t in sorted(self._qs):
            for req in self._qs[t]:
                yield req

    def clear(self) -> None:
        for q in self._qs.values():
            q.clear()
        self._n = 0

    def depth(self, tenant: str) -> int:
        return len(self._qs[tenant])

    def append(self, req) -> None:
        q = self._qs[req.tenant]
        if not q:
            # a tenant returning from idle starts at the clock, not at
            # its stale virtual time — idling must not bank credit that
            # would let it monopolize the worker on return
            self._vt[req.tenant] = max(self._vt[req.tenant],
                                       self._vclock)
        q.append(req)
        self._n += 1

    def popleft(self):
        vt, t = min((self._vt[t], t) for t, q in self._qs.items() if q)
        self._vclock = vt
        self._vt[t] = vt + self._stride[t]
        self._n -= 1
        return self._qs[t].popleft()

    def peek(self):
        """The request ``popleft`` would return RIGHT NOW, no mutation
        — the paged-KV gather gate budgets the NEXT admission's block
        demand (deque-parity: the plain queue peeks its [0])."""
        vt, t = min((self._vt[t], t) for t, q in self._qs.items() if q)
        return self._qs[t][0]

    def appendleft(self, req) -> None:
        """Return a popped request to ITS TENANT's queue head (the
        paged-KV defer/requeue path): the pop's virtual-time charge is
        refunded — a defer costs the tenant no fair-share credit, and
        the refund makes its tenant the furthest-behind again so the
        deferred request is the next pop (deque-parity head semantics).
        No idle clamp: the tenant never left the queue."""
        self._vt[req.tenant] -= self._stride[req.tenant]
        self._qs[req.tenant].appendleft(req)
        self._n += 1

    def oldest_arrival(self):
        """Earliest queued arrival (monotonic), or None when empty —
        the head-of-queue age the convoy detector and the
        serve.queue_age histogram read (deque-parity: the plain queue
        reads its [0])."""
        ts = [q[0].t_arrival for q in self._qs.values() if q]
        return min(ts) if ts else None

    def over_share(self, tenant: str) -> bool:
        return len(self._qs[tenant]) >= self.shares[tenant]

    def evict_over_share(self, exempt: str):
        """The newest queued request of the tenant MOST over its fair
        share (never ``exempt`` — the arriving under-share tenant), or
        None when nobody is over-share. LIFO within the borrower: its
        newest borrowed slot is the one it never fairly held."""
        worst, excess = None, 0
        for t, q in sorted(self._qs.items()):
            if t == exempt:
                continue
            over = len(q) - self.shares[t]
            if over > excess:
                worst, excess = t, over
        if worst is None:
            return None
        self._n -= 1
        return self._qs[worst].pop()


class BatchFlightRecorder:
    """Bounded ring of per-ITERATION batch scheduler records — the
    decode datapath's flight recorder (doc/observability.md "Decode
    datapath"). Where ``telemetry.FlightRecorder`` keeps one record per
    REQUEST, this ring keeps one per decode iteration: wall epoch,
    bucket, step latency, the slots aboard (each occupant's request id
    and age-in-iterations), admissions/retirements since the last
    record, queue depth + head-of-queue age at the iteration, live-KV
    utilization, and the convoy verdict. statusd serves it at
    ``/batchz`` and merges a request's iterations into its
    ``/trace?request=<id>`` Chrome trace as slot-Gantt lanes.

    Registry-independent (the FlightRecorder discipline:
    it must survive a run with telemetry disabled). Records are
    appended by the dispatcher OUTSIDE every servd lock, from a
    snapshot taken under the admission lock once per iteration — the
    per-iteration feed must never serialize token decoding against a
    /batchz read. ``iterations``/``slot_iterations`` are LIFETIME
    tallies (the ring evicts, the tallies do not): their ratio is the
    same weighted-mean occupancy the ``serve.batch_iterations`` /
    ``serve.batch_slot_iterations`` counter pair publishes — pinned
    equal by a regression test."""

    def __init__(self, cap: int = 256):
        self.cap = max(1, int(cap))
        self._lock = lockrank.lock("servd.batchflight")
        self._ring: deque = deque(maxlen=self.cap)
        self.iterations = 0
        self.slot_iterations = 0

    def record(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)
            if rec.get("stepped", 1):
                # only DECODE iterations enter the occupancy tallies —
                # a journal-flush record (admissions/retirements on a
                # turn that ran no step, e.g. n_new==1 finishing at
                # prefill) is scheduler history, not a decode pass
                self.iterations += 1
                self.slot_iterations += int(rec.get("occupancy", 0))

    def list(self, n: int = 0) -> List[dict]:
        """Newest-first snapshot of the ring (``n > 0`` bounds it)."""
        with self._lock:
            recs = list(reversed(self._ring))
        return recs[:n] if n > 0 else recs

    def for_request(self, request_id) -> List[dict]:
        """OLDEST-first: every ringed iteration the request was aboard
        — the /trace slot-Gantt feed (which iterations this request
        shared its decode with, and with whom)."""
        rid = str(request_id)
        with self._lock:
            return [rec for rec in self._ring
                    if any(str(row[1]) == rid
                           for row in rec.get("slots") or [])]

    def mean_occupancy(self) -> Optional[float]:
        if not self.iterations:
            return None
        return self.slot_iterations / float(self.iterations)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# stat key -> telemetry counter (serve.requests is the JAX package's name
# for the successfully-served count, kept so dashboards read both alike)
_COUNTERS = {
    "accepted": "serve.accepted",
    "served": "serve.requests",
    "errors": "serve.errors",
    "shed": "serve.shed",
    "deadline": "serve.deadline",
    "empty": "serve.empty",
    "admin": "serve.admin",
    "reloads": "serve.reloads",
    "reload_seen": "serve.reload_seen",
    "client_gone": "serve.client_gone",
}
# the stats mirrored into statusd's progress gauges per bump
_PROGRESS_KEYS = ("served", "errors", "shed", "deadline")
# the per-tenant reconciling subset: accepted == served + errors +
# shed + deadline holds PER TENANT exactly as it does frontend-wide
_TENANT_KEYS = ("accepted", "served", "errors", "shed", "deadline")


class ServeFrontend:
    """The concurrent serving frontend around one backend callable.

    ``backend(toks, seq) -> sequence of ints`` runs on the single worker
    thread (batch-1 decode is serial on the accelerator by design — the
    latency-bound case; concurrency buys admission, shedding, and drain,
    not parallel decode). ``seq`` is the dispatch ordinal (the driver
    folds it into the sampling seed so streams differ per request).

    ``reload_fn() -> bool`` (optional) is called between requests when a
    reload was requested; returning False (or raising) keeps the current
    model. ``vocab > 0`` rejects out-of-range token ids at parse time.

    Lifecycle: ``start()`` (worker thread) → optional ``listen(port)``
    (TCP accept thread) → ``submit()`` per request line (the connection
    readers and the driver's stdin pump both land here) → ``drain()``.
    """

    def __init__(self, backend: Callable, queue_size: int = 64,
                 deadline_ms: float = 0.0, drain_ms: float = 5000.0,
                 breaker_fails: int = 5, breaker_cooldown_ms: float = 1000.0,
                 breaker_max_cooldown_ms: float = 30000.0, vocab: int = 0,
                 reload_fn: Optional[Callable] = None,
                 client_timeout: float = 10.0,
                 stall_after_s: float = 120.0,
                 slo=None, flight_cap: int = 256,
                 slot_backend=None, batch_max: int = 0,
                 batch_window_ms: float = 0.0,
                 batch_flight_cap: int = 256, convoy_iters: int = 64,
                 tenants=None, tenant_default: str = "default",
                 slo_tenants=None, kv_pressure_pct: float = 10.0,
                 kv_pressure_clear_pct: float = 25.0):
        self.backend = backend
        # multi-tenant weighted-fair QoS (module docstring): a tenant
        # table turns the admission deque into a _FairQueue and arms
        # per-tenant accounting/SLO; empty = single-tenant mode, every
        # path byte-identical to pre-tenant behavior
        self._tenants = parse_tenants(tenants)
        self.tenant_default = str(tenant_default)
        if self._tenants and self.tenant_default not in self._tenants:
            # the default tenant must have a queue and a weight — a
            # prefix-less client is a first-class tenant, not an error
            self._tenants[self.tenant_default] = 1.0
        # per-tenant SLO trackers (statusd.SLOTracker each): the
        # per-tenant error-budget floors the fleet federation merges
        self.slo_tenants = dict(slo_tenants or {})
        self._tstats = {t: {k: 0 for k in _TENANT_KEYS}
                        for t in self._tenants}
        # continuous batching (module docstring): a slot backend makes
        # the worker an iteration-granularity batching dispatcher;
        # batch_max bounds the coalesced batch (0 = the largest bucket),
        # batch_window_ms is the gather window for a FRESH batch
        self.slot_backend = slot_backend
        self.batch_max = int(batch_max)
        self.batch_window_s = float(batch_window_ms) / 1e3
        self._buckets = []
        if slot_backend is not None:
            self._buckets = sorted(
                {max(1, int(b))
                 for b in (getattr(slot_backend, "buckets", None)
                           or (1,))})
        # per-request observability: the flight ring every dequeued
        # request lands in, and the (optional) SLO error-budget account
        # (statusd.SLOTracker) fed per completed request
        self.flight = telemetry.FlightRecorder(flight_cap)
        self.slo = slo
        self._rid = 0                # request-id counter (admission lock)
        self.queue_size = max(1, int(queue_size))
        self.deadline_ms = float(deadline_ms)
        self.drain_ms = float(drain_ms)
        self.vocab = int(vocab)
        self.reload_fn = reload_fn
        self.client_timeout = float(client_timeout)
        # a backend that BLOCKS (no exception) is invisible to the
        # breaker and to deadlines (the single worker never dispatches
        # again), and the worker heartbeat is deliberately paused across
        # backend calls (compiles). This wall-clock bound on the current
        # dispatch is the wedge detector: readiness fails past it,
        # liveness past twice it. Size it above the worst legitimate
        # call INCLUDING a first compile; 0 disables.
        self.stall_after_s = float(stall_after_s)
        self.breaker = CircuitBreaker(breaker_fails,
                                      cooldown=breaker_cooldown_ms / 1e3,
                                      max_cooldown=breaker_max_cooldown_ms
                                      / 1e3)
        # the admission queue: a plain deque, or the per-tenant
        # weighted-fair queue when a tenant table is configured (same
        # interface — every consumer is tenant-agnostic)
        self._q = (_FairQueue(self._tenants, max(1, int(queue_size)))
                   if self._tenants else deque())
        # ranked locks (utils/lockrank.py): with CXXNET_LOCKRANK=1 the
        # chaos tests assert acquisition order matches the static graph
        self._cond = lockrank.condition("servd.queue")
        self._slock = lockrank.lock("servd.stats")
        self._stats = {k: 0 for k in _COUNTERS}
        self._draining = False
        self._stop = False
        self._reload_flag = False    # plain bool: settable from a signal
        #                              handler without taking any lock
        self._inflight = 0
        self._inflight_req: Optional[_Request] = None
        # batched path: every popped-but-unanswered request (drain's
        # give-up list; _inflight counts these). Mutated by the worker
        # and read by drain/stats under _cond
        self._inflight_reqs: List[_Request] = []
        self._inflight_since: Optional[float] = None
        # batching load/occupancy account: free decode slots (ADMIN
        # stats -> the router's load signal) and the weighted-mean
        # occupancy pair (slot-iterations / iterations). Capacity is
        # known at construction so a stats probe racing worker startup
        # still reads the true idle capacity.
        self._batch_capacity = 0
        if self._buckets:
            self._batch_capacity = (min(self._buckets[-1], self.batch_max)
                                    if self.batch_max > 0
                                    else self._buckets[-1])
        self._batch_free = self._batch_capacity
        self._occ_iters = 0
        self._occ_slots = 0
        # decode-datapath observability (doc/observability.md "Decode
        # datapath"): the per-iteration scheduler flight ring, the
        # per-bucket warm-session/KV account (written by the worker
        # under _cond, read by /batchz, ADMIN stats and the perf
        # ledger's HBM hook), and the convoy detector's latch
        self.batch_flight = (BatchFlightRecorder(batch_flight_cap)
                             if slot_backend is not None else None)
        self.convoy_iters = max(1, int(convoy_iters))
        self._bucket_state = {
            b: {"warm": 0, "active": 0, "kv_bytes": 0,
                "kv_live_bytes": 0, "live_tokens": 0,
                "alloc_tokens": 0}
            for b in self._buckets}
        # paged-KV pool account mirror (worker-written under _cond from
        # the slot backend's kv_pool_account() hook; None on dense/solo
        # backends) — /batchz, ADMIN stats and the /metrics block
        # series read it instead of re-asking the backend
        self._pool_state: Optional[dict] = None
        self._convoy = False         # latched while a convoy holds
        self._convoys = 0            # episodes (0->1 transitions)
        self._convoy_since = 0       # iteration ordinal of the latch
        # KV memory-pressure latch (doc/robustness.md "Memory
        # governance"): latches when the pool's FREE headroom (the
        # block-exact mirror of the HBM ledger's decode headroom —
        # the pool is sized under perf.decode_pool_cap_bytes) drops
        # under kv_pressure_pct percent; while latched the worker
        # sheds retained conversation blocks (kv_shed_retained hook)
        # toward kv_pressure_clear_pct and clears there (hysteresis).
        # 0 disables the latch.
        self.kv_pressure_pct = float(kv_pressure_pct)
        self.kv_pressure_clear_pct = max(float(kv_pressure_clear_pct),
                                         float(kv_pressure_pct))
        self._kv_pressure = False    # latched under low headroom
        self._kv_pressures = 0       # episodes (0->1 transitions)
        self._kv_shed_blocks = 0     # retained blocks shed by the latch
        # autopsy episode windows (utils/autopsy.py): monotonic
        # [t0, t1] spans of the convoy / KV-pressure latches — the
        # classifier intersects a request's [arrival, answer] span
        # with these to attribute convoy_victim / eviction_storm
        # seconds. Single-thread discipline: latch, clear and the
        # _observe_request reads all run on the worker thread
        self._convoy_t0: Optional[float] = None
        self._convoy_episodes: deque = deque(maxlen=64)
        self._kvp_t0: Optional[float] = None
        self._kvp_episodes: deque = deque(maxlen=64)
        self._iter_ord = 0           # lifetime step-iteration ordinal
        self._kv_total = 0           # decode_kv_bytes mirror (worker-
        #                              written, read lock-free)
        # per-turn scheduler journal (worker-thread only): admissions /
        # retirements since the last ringed iteration record
        self._turn_admitted: List[list] = []
        self._turn_retired: List[list] = []
        self._seq = 0
        self._worker_thread: Optional[threading.Thread] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._sock: Optional[socket.socket] = None
        self.port: Optional[int] = None
        # live per-connection writer states (_ConnState): drain waits for
        # their queued responses to reach the kernel before returning —
        # the writer threads are daemons, and a response still buffered
        # at interpreter exit would be a silently dropped answer
        self._conn_lock = lockrank.lock("servd.conns")
        self._conns: set = set()
        # warm-grid readiness account (doc/observability.md "Compile
        # flight recorder"): a readiness callable (perf.Ledger.readiness
        # shaped) plus the gate percentage below which health_probe
        # reports "warming" — unset/0 leaves every path byte-identical
        self._warm_readiness: Optional[Callable] = None
        self._warm_ready_pct = 0.0
        # batch rescue (doc/robustness.md "Failover & hedging"): the
        # session the worker is stepping right now (GIL-atomic store,
        # read by the rescue thread), the rescued flag the worker
        # checks around each step, and the watchdog thread itself
        self._cur_sess = None
        self._batch_rescued = False
        self._rescue_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ServeFrontend":
        telemetry.gauge("serve.queue_depth", 0)
        telemetry.gauge("serve.in_flight", 0)
        telemetry.gauge("serve.batch_occupancy", 0)
        # declare the latency series up front: a dashboard (or the
        # acceptance scrape) must see serve_ttft_seconds buckets exist
        # BEFORE the first request, and /statusz shows them as "n/a"
        for name in ("serve.request", "serve.queue_wait", "serve.ttft",
                     "serve.decode_per_token"):
            telemetry.declare_hist(name)
        if self.slot_backend is not None:
            # the batching dispatcher's queue-age distribution (head-
            # of-queue age sampled once per decode iteration): declared
            # up front like the latency series — the convoy acceptance
            # scrapes its buckets before the first flood
            telemetry.declare_hist("serve.queue_age")
        # conservation laws (doc/observability.md "Metric conservation
        # laws"): the books auditor re-proves the serving invariants
        # continuously — accepted vs outcomes + queue + in-flight,
        # tenant charges vs the door books, and (paged backends) the
        # block-pool equation. Registered here, unregistered at drain;
        # a latched violation survives the unregister by design.
        telemetry.audit_register("serve.books", self._law_books)
        telemetry.audit_register("serve.tenant_books",
                                 self._law_tenant_books)
        pool_law = getattr(getattr(self.slot_backend, "alloc", None),
                           "books_law", None)
        if pool_law is not None:
            telemetry.audit_register("kv.blocks", pool_law)
        target = (self._worker_run_batched if self.slot_backend is not None
                  else self._worker_run)
        self._worker_thread = threading.Thread(
            target=target, name="cxn-servd-worker", daemon=True)
        self._worker_thread.start()
        if self.slot_backend is not None and self.stall_after_s > 0:
            # the batch-rescue watchdog: a dispatch wedged past the
            # stall bound fails the batch and answers ERR backend so
            # the requests become replayable losses upstream instead
            # of hostages (doc/robustness.md "Failover & hedging")
            self._rescue_thread = threading.Thread(
                target=self._rescue_run, name="cxn-servd-rescue",
                daemon=True)
            self._rescue_thread.start()
        return self

    def listen(self, port: int = 0, host: str = "") -> int:
        """Bind the TCP listener (port 0 = ephemeral; loopback unless
        ``host`` widens it — the protocol is unauthenticated) and start
        the accept thread. Returns the bound port."""
        self._sock = socket.create_server((host or "127.0.0.1", int(port)))
        self._sock.settimeout(0.25)
        self.port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_run, name="cxn-servd-accept", daemon=True)
        self._accept_thread.start()
        telemetry.event({"ev": "serve_listen", "port": self.port})
        return self.port

    @property
    def listening(self) -> bool:
        return self._sock is not None

    @property
    def draining(self) -> bool:
        return self._draining

    def stats(self) -> dict:
        with self._slock:
            return dict(self._stats)

    def tenant_stats(self) -> dict:
        """Per-tenant counter snapshot ({tenant: {key: n}}): each
        tenant reconciles accepted == served + errors + shed +
        deadline, exactly like the frontend-wide books."""
        with self._slock:
            return {t: dict(st) for t, st in self._tstats.items()}

    def _bump_tenant(self, tenant: Optional[str], *names: str) -> None:
        """Per-tenant half of _bump: the reconciling counter subset,
        mirrored into ``serve.tenant.<t>.<key>`` telemetry counters —
        series the fleet federation sums per tenant exactly like the
        frontend-wide serve.* ones (tenant names are conf-bounded, so
        the series set is bounded too)."""
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
            telemetry.count("serve.tenant.%s.%s" % (tenant, k))

    def _slo_observe(self, tenant: Optional[str], ok: bool,
                     ttft_s=None, latency_s=None) -> None:
        """Feed the frontend-wide SLO account AND the request's
        tenant's own tracker — per-tenant error-budget floors are what
        keep a noisy tenant's sheds from burning the victim's budget."""
        if self.slo is not None:
            self.slo.observe(ok=ok, ttft_s=ttft_s, latency_s=latency_s)
        if tenant is not None:
            tr = self.slo_tenants.get(tenant)
            if tr is not None:
                tr.observe(ok=ok, ttft_s=ttft_s, latency_s=latency_s)

    def mean_occupancy(self) -> Optional[float]:
        """Weighted-mean batch occupancy over decode iterations (None
        before the first) — the honest form of ``serve.batch_occupancy``
        (a last-write gauge scraped between batches lies). Solo dispatch
        counts each request as one iteration at occupancy 1."""
        if not self._occ_iters:
            return None
        return self._occ_slots / float(self._occ_iters)

    def decode_kv_bytes(self) -> int:
        """Total allocated decode KV-cache bytes (0 on the solo path)
        — dense: summed across the warm sessions' cache arrays; paged:
        the block pool's REAL nbytes (block-exact, free blocks
        included — they are allocated HBM). The perf ledger's
        HBM-account hook (``perf.set_decode_kv``): the decode cache is a
        first-class HBM consumer next to the program footprints.
        Lock-free (a benign read of the worker's GIL-atomic mirror):
        /metrics renders already take the admission lock once for the
        batch snapshot, and the hook must not take it a second time
        per scrape."""
        return self._kv_total

    def batch_snapshot(self, ring: int = 0) -> Optional[dict]:
        """The decode-datapath observability snapshot (None on the solo
        path): per-bucket warm-session + active-slot + KV accounts, the
        frontend-wide live-vs-allocated cache utilization
        (``kv_live_pct`` — the padding+dead-slot waste a paged KV cache
        would reclaim, ROADMAP item 2), the bucket-rounding
        ``slot_waste_pct`` (warm slots not decoding), the convoy latch
        + episode count, and the lifetime iteration tallies. ``ring >
        0`` appends the newest ``ring`` iteration records. Behind
        statusd ``/batchz``, the ``cxxnet_decode_*`` /metrics families,
        and the ``/metrics?json=1`` federation feed."""
        if self.slot_backend is None:
            return None
        with self._cond:
            buckets = {str(b): dict(bs) for b, bs
                       in sorted(self._bucket_state.items())}
            free = self._batch_free
            qd = len(self._q)
            pool = (dict(self._pool_state)
                    if self._pool_state is not None else None)
        kv = sum(bs["kv_bytes"] for bs in buckets.values())
        kv_live = sum(bs["kv_live_bytes"] for bs in buckets.values())
        warm_slots = sum(int(b) * bs["warm"]
                         for b, bs in buckets.items())
        act = sum(bs["active"] for bs in buckets.values())
        fl = self.batch_flight
        snap = {"buckets": buckets, "capacity": self._batch_capacity,
                "free_slots": free, "queue_depth": qd,
                "kv_bytes": kv, "kv_live_bytes": kv_live,
                "kv_live_pct": round(100.0 * kv_live / kv, 2)
                if kv else None,
                "slot_waste_pct":
                round(100.0 * (warm_slots - act) / warm_slots, 2)
                if warm_slots else None,
                "convoy": 1 if self._convoy else 0,
                "convoys": self._convoys,
                "convoy_iters": self.convoy_iters,
                "iterations": fl.iterations,
                "slot_iterations": fl.slot_iterations,
                "mean_occupancy": self.mean_occupancy(),
                "flight_cap": fl.cap}
        if pool is not None:
            # the paged-KV pool account (block-exact; shared across
            # buckets, so it rides ONCE at the top level, not per
            # bucket). prefix_hit_rate is TOKEN-weighted: the share of
            # admitted prompt tokens served from resident shared
            # blocks instead of being re-prefilled — the bench's
            # prefix-reuse headline.
            pt = pool.get("prompt_tokens", 0)
            pool["prefix_hit_rate"] = (
                round(100.0 * pool.get("prefix_hit_tokens", 0) / pt, 2)
                if pt else None)
            # the RETAINED sub-source of the hit rate (tokens revived
            # from the conversation cache — refcount-0 blocks a new
            # turn re-admitted) and the retained share of the pool:
            # the multi-turn bench's warm-trie evidence
            pool["retained_hit_rate"] = (
                round(100.0 * pool.get("retained_hit_tokens", 0)
                      / pt, 2) if pt else None)
            bt = pool.get("blocks_total", 0)
            pool["kv_retained_pct"] = (
                round(100.0 * pool.get("blocks_retained", 0) / bt, 2)
                if bt else None)
            snap["pool"] = pool
        if ring > 0:
            snap["flight"] = fl.list(ring)
        return snap

    def _eval_convoy(self, bucket: int, free: int, slots_snap,
                     qd: int, qage) -> Optional[int]:
        """The convoy verdict for one iteration (worker thread only):
        a long sequence PINS the bucket — some slot has been aboard >=
        ``convoy_iters`` step iterations — while queued work waits with
        zero free slots. Latched (one ``decode_convoy`` transition
        event per episode, never per-iteration spam; the clearing
        transition carries the episode length); ``serve.convoys``
        counts episodes. Returns the age skew (oldest slot vs the
        median of its batchmates, None without batchmates) for the
        iteration record."""
        ages = [row[2] for row in slots_snap]
        skew = None
        if ages:
            mx = max(ages)
            others = sorted(ages)
            others.remove(mx)
            if others:
                skew = mx - others[len(others) // 2]
        on = bool(qd > 0 and free == 0 and ages
                  and max(ages) >= self.convoy_iters)
        if on and not self._convoy:
            self._convoy = True
            self._convoys += 1
            self._convoy_since = self._iter_ord
            self._convoy_t0 = time.monotonic()
            pinned = max(slots_snap, key=lambda r: r[2])
            telemetry.count("serve.convoys")
            telemetry.event({
                "ev": "decode_convoy", "convoy": 1, "bucket": bucket,
                "pinned": pinned[1], "slot": pinned[0],
                "age_iters": pinned[2], "skew_iters": skew,
                "queue_depth": qd,
                "queue_age_s": round(qage, 6)
                if qage is not None else None})
        elif self._convoy and not on:
            self._convoy = False
            if self._convoy_t0 is not None:
                self._convoy_episodes.append(
                    (self._convoy_t0, time.monotonic()))
                self._convoy_t0 = None
            telemetry.event({
                "ev": "decode_convoy", "convoy": 0,
                "episode_iters": self._iter_ord - self._convoy_since})
        return skew

    def _record_iteration(self, bucket: int, slots_snap, step_s,
                          qd: int, qage, occupancy_after: int = 0,
                          error=None, stepped: bool = True) -> None:
        """File one scheduler turn in the flight ring and feed the
        derived series — called AFTER the admission lock is released,
        from the snapshot ``_publish_batch_state`` took under it.
        ``occupancy_after`` is the composition LEFT after the turn's
        retirements: it holds until the next composition change, which
        is what lets the report reconstruct exact per-iteration
        occupancy from transition-only events (the event at iteration
        N weighs N itself at ``occupancy`` and N+1..next-event-1 at
        ``occupancy_after``). ``stepped=False`` flushes a turn that ran
        NO decode pass (every admission finished at prefill, or every
        sequence deadline-retired) so its admissions/retirements are
        never lost or misattributed to a later iteration; such records
        stay out of the occupancy tallies. The JSONL ``batch_iteration``
        event is transition-only (emitted when the composition changed
        — never per token); the ring keeps every iteration."""
        ads, self._turn_admitted = self._turn_admitted, []
        rets, self._turn_retired = self._turn_retired, []
        skew = self._eval_convoy(bucket, self._batch_free, slots_snap,
                                 qd, qage)
        kv = kv_live = 0
        for bs in self._bucket_state.values():   # worker-owned reads
            kv += bs["kv_bytes"]
            kv_live += bs["kv_live_bytes"]
        rec = {"iter": self._iter_ord,
               # cxxlint: disable=wallclock — iteration epoch aligning
               # the slot-Gantt lanes with request flight records
               # (never subtracted from a monotonic clock)
               "t_wall": round(time.time(), 6),
               "bucket": bucket, "occupancy": len(slots_snap),
               "occupancy_after": int(occupancy_after),
               "step_ms": round(step_s * 1e3, 3)
               if step_s is not None else None,
               "slots": slots_snap,
               "admitted": ads, "retired": rets,
               "queue_depth": qd,
               "queue_age_s": round(qage, 6)
               if qage is not None else None,
               "kv_live_pct": round(100.0 * kv_live / kv, 2)
               if kv else None,
               "age_skew": skew,
               "convoy": 1 if self._convoy else 0}
        ps = self._pool_state             # worker-owned write/read
        if ps is not None:
            # the paged pool's free-list level at this iteration: the
            # /batchz ring's view of block pressure building toward an
            # admission wait (kv_defer) — next to the queue columns it
            # answers "queued because slots or because blocks?"
            rec["blocks_free"] = int(ps.get("blocks_free", 0))
            rec["blocks_total"] = int(ps.get("blocks_total", 0))
        if not stepped:
            rec["stepped"] = 0
        if error is not None:
            rec["error"] = str(error)[:200]
        self.batch_flight.record(rec)
        if qage is not None and stepped:
            telemetry.hist("serve.queue_age", qage)
        if ads or rets or error is not None:
            ev = {"ev": "batch_iteration", "iter": self._iter_ord,
                  "bucket": bucket, "occupancy": len(slots_snap),
                  "occupancy_after": int(occupancy_after),
                  "queue_depth": qd, "step_ms": rec["step_ms"],
                  "admitted": [a[0] for a in ads],
                  "retired": [r[0] for r in rets]}
            if not stepped:
                ev["stepped"] = 0
            if error is not None:
                ev["error"] = rec["error"]
            telemetry.event(ev)

    # -- health (statusd probes) ---------------------------------------
    def _stalled_for(self) -> float:
        """Seconds the CURRENT dispatch has been inside the backend
        (0.0 when idle) — benign unlocked reads of GIL-atomic stores."""
        t0 = self._inflight_since
        if not self._inflight or t0 is None:
            return 0.0
        return time.monotonic() - t0

    def set_warm_account(self, readiness_fn: Callable,
                         ready_pct: float = 0.0) -> None:
        """Register the warm-grid readiness account (a zero-arg
        callable returning ``perf.Ledger.readiness()``-shaped dicts)
        and, optionally, the gate: with ``ready_pct > 0`` the health
        probe reports ``warming`` (503, router state WARMING — probed
        but not routed) until at least that percentage of the expected
        program grid has compiled. 0 keeps the replica routable while
        cold — it serves, it just pays cliffs — but the ADMIN
        ``warm_programs``/``expected_programs`` ints still federate."""
        self._warm_readiness = readiness_fn
        self._warm_ready_pct = float(ready_pct)

    def warm_programs(self) -> Optional[Tuple[int, int, float]]:
        """``(warm, expected, ready_pct)`` from the registered warm
        account, or None when there is no account / no expected grid —
        absence is the capability signal (ADMIN omits the keys, the
        fleet table shows "-")."""
        fn = self._warm_readiness
        if fn is None:
            return None
        try:
            rd = fn() or {}
        except Exception:
            return None
        if rd.get("ready_pct") is None:
            return None
        return (int(rd.get("warm", 0)), int(rd.get("expected", 0)),
                float(rd["ready_pct"]))

    def health_probe(self) -> Tuple[bool, str]:
        """Readiness: NOT ready while draining, while the circuit
        breaker is anything but closed (open, or a half-open probe still
        unresolved), while the warm-grid gate (``set_warm_account``) is
        armed and unmet, or while the current dispatch has been stuck
        inside the backend past ``stall_after_s`` — the "don't route
        traffic here" signal."""
        if self._draining:
            return False, "draining: not accepting new requests"
        st = self.breaker.state
        if st != "closed":
            return False, "circuit breaker %s" % self.breaker.describe()
        if self._warm_ready_pct > 0:
            wp = self.warm_programs()
            if wp is not None and wp[2] < self._warm_ready_pct:
                return False, ("warming: %d/%d programs compiled "
                               "(%.1f%% ready, gate %.0f%%)"
                               % (wp[0], wp[1], wp[2],
                                  self._warm_ready_pct))
        stalled = self._stalled_for()
        if self.stall_after_s > 0 and stalled > self.stall_after_s:
            return False, ("backend stalled: request in flight for "
                           "%.0fs (bound %.0fs)"
                           % (stalled, self.stall_after_s))
        return True, "serving (breaker closed)"

    def liveness_probe(self) -> Tuple[bool, str]:
        """Liveness: the process is still functional — a dead worker
        thread (not a drained one), or a backend wedged past TWICE the
        stall bound (first stop routing, then restart), means restart,
        not just unroutable."""
        t = self._worker_thread
        if t is not None and not t.is_alive() and not self._stop:
            return False, "serve worker thread died"
        stalled = self._stalled_for()
        if self.stall_after_s > 0 and stalled > 2 * self.stall_after_s:
            return False, ("backend wedged: request in flight for %.0fs "
                           "(2x the %.0fs stall bound)"
                           % (stalled, self.stall_after_s))
        return True, "alive"

    # -- conservation laws (telemetry.BooksAuditor) --------------------
    def _law_books(self) -> Optional[str]:
        """``accepted == served + errors + shed + deadline + queued +
        in-flight``, at every instant. A sync rejection bumps accepted
        and its outcome in ONE _slock section, so outcomes can never
        exceed accepted in any snapshot — that direction latches
        immediately. The forward direction has microsecond limbo
        windows (a fair-share eviction and drain leftovers leave the
        queue under the admission lock but are answered OUTSIDE it),
        so a forward violation must PERSIST across several
        stable-snapshot brackets before it returns a detail. A torn
        bracket (the stats moved while the queue was read) is
        inconclusive, never a latch."""
        detail = None
        for _ in range(6):
            with self._slock:
                s1 = dict(self._stats)
            with self._cond:
                depth = len(self._q)
                infl = self._inflight
            with self._slock:
                s2 = dict(self._stats)
            if s1 != s2:
                return None          # the books moved mid-bracket
            a = s1["accepted"]
            o = (s1["served"] + s1["errors"] + s1["shed"]
                 + s1["deadline"])
            if o > a:
                return ("serve books: outcomes %d exceed accepted %d "
                        "(served %d + errors %d + shed %d + deadline "
                        "%d)" % (o, a, s1["served"], s1["errors"],
                                 s1["shed"], s1["deadline"]))
            if a <= o + depth + infl:
                return None
            detail = ("serve books: accepted %d != outcomes %d + "
                      "queued %d + in-flight %d"
                      % (a, o, depth, infl))
            time.sleep(0.005)        # let an in-limbo answer land
        return detail

    def _law_tenant_books(self) -> Optional[str]:
        """Per-tenant charges never exceed the door books, key by key.
        The frontend-wide counter is bumped before the tenant's and
        both live under _slock, so ONE combined snapshot makes
        ``sum_t tenant[k] <= global[k]`` exact — no persistence
        dance needed."""
        if not self._tenants:
            return None
        with self._slock:
            g = dict(self._stats)
            ts = {t: dict(st) for t, st in self._tstats.items()}
        for k in _TENANT_KEYS:
            tot = sum(st[k] for st in ts.values())
            if tot > g[k]:
                return ("tenant books: tenant %s charges sum to %d, "
                        "the door counted %d" % (k, tot, g[k]))
        return None

    # -- accounting ----------------------------------------------------
    def _bump(self, *names: str) -> None:
        """Bump one or more stat counters ATOMICALLY: a synchronously
        rejected request's ``accepted`` and its outcome (errors/shed/
        deadline) land in one critical section, so a concurrent
        ``stats()`` snapshot — drain's final reconciliation — can never
        observe a torn ``accepted > served+errors+shed+deadline``."""
        with self._slock:
            for name in names:
                self._stats[name] += 1
            if any(name in _PROGRESS_KEYS for name in names):
                # applied under the lock: two racing bumps must publish
                # their snapshots in order, or a stale one could make
                # the progress gauges transiently regress
                statusd.update_progress(
                    **{k: self._stats[k] for k in _PROGRESS_KEYS})
        for name in names:
            telemetry.count(_COUNTERS[name])

    def _send(self, reply, text: str) -> bool:
        """Deliver one response line; a reply that raises (client hung up
        mid-request) is counted, never propagated — the server outlives
        every client."""
        try:
            reply(text)
            return True
        except Exception:
            self._bump("client_gone")
            return False

    def _claim(self, req: _Request) -> bool:
        """Claim a request's exactly-once answer slot (see _finish)."""
        with req._alock:
            if req.answered:
                return False
            req.answered = True
            return True

    def _finish(self, req: _Request, text: str, *outcome: str) -> bool:
        """Answer a queued request EXACTLY ONCE, bumping its outcome
        counters only on the winning side — drain can give up on a
        request whose backend wedged past the budget while the worker
        might still complete it later; whoever claims first accounts
        and replies, the loser is a no-op. Returns whether THIS call
        won the answer slot (drain uses it to account the loss)."""
        if not self._claim(req):
            return False
        if outcome:
            self._bump(*outcome)
            self._bump_tenant(req.tenant, *outcome)
        self._send(req.reply, text)
        req.done.set()
        return True

    def _finish_observed(self, req: _Request, text: str, counter: str,
                         outcome: str, tc, queue_wait: float,
                         t_pop: float, t_back: float, t_end: float,
                         wall: float, ntok: int,
                         occupancy: Optional[int] = None,
                         batch=None) -> None:
        """Terminal step for every dequeued request: claim the
        exactly-once answer slot, publish the request's telemetry
        (flight record, SLO account, TTFT series), and only THEN send
        the response — a client synchronized on the response line can
        immediately read /trace?request=<id>. A lost claim means drain
        already answered this request (gave it up as wedged past the
        budget): record outcome "abandoned" — the phases are real work
        the backend did, but the client never received this answer —
        instead of falsely logging a served/ok request."""
        won = self._claim(req)
        self._observe_request(req, tc, outcome if won else "abandoned",
                              queue_wait, t_pop, t_back, t_end, wall,
                              ntok, occupancy=occupancy, batch=batch)
        if won:
            self._bump(counter)
            self._bump_tenant(req.tenant, counter)
            self._send(req.reply, text)
            req.done.set()

    # -- request intake ------------------------------------------------
    def _parse(self, line: str):
        """One request line -> ("req", toks, rel_deadline_s, trace_id,
        tenant) | ("admin", args) | ("err", cls, msg). ``trace_id`` is
        None unless the line carried a valid ``TRACE <id>`` prefix;
        ``tenant`` is the ``TENANT <id>`` prefix, or the configured
        default for prefix-less clients (None in single-tenant mode)."""
        parts = line.split()
        if not parts:
            return ("err", "empty", "request line has no tokens")
        # the cross-process trace id (module docstring): validated by
        # the shared checker, adopted as the request id below.
        # Malformed ids are a protocol violation — deterministic, never
        # dispatched, and distinct from "parse" so an OLD server's
        # rejection of the prefix itself (ERR parse: TRACE is not an
        # integer token) stays distinguishable on the wire
        trace_id, proto_detail, parts = parse_trace_prefix(parts)
        if proto_detail is not None:
            return ("err", "proto", proto_detail)
        if trace_id is not None and not parts:
            return ("err", "empty", "TRACE with no request line")
        # the tenant prefix (TRACE first, then TENANT, then DEADLINE):
        # same validation discipline as TRACE — malformed is a
        # deterministic protocol violation, never dispatched. An
        # unknown tenant on a frontend WITH a tenant table is refused
        # too (the table bounds queue/metric cardinality); without a
        # table the id is recorded for observability and fairness is
        # off — the pre-tenant behavior, byte for byte
        tenant, proto_detail, parts = parse_tenant_prefix(parts)
        if proto_detail is not None:
            return ("err", "proto", proto_detail)
        if tenant is not None and not parts:
            return ("err", "empty", "TENANT with no request line")
        if self._tenants:
            if tenant is None:
                tenant = self.tenant_default
            elif tenant not in self._tenants:
                return ("err", "proto",
                        "tenant %s is not in the configured tenant "
                        "table" % tenant)
        if parts[0] == "ADMIN":
            return ("admin", parts[1:])
        deadline = (self.deadline_ms / 1e3) if self.deadline_ms > 0 \
            else None
        if parts[0] == "DEADLINE":
            if len(parts) < 2:
                return ("err", "parse", "DEADLINE needs a millisecond "
                        "bound")
            try:
                deadline = float(parts[1]) / 1e3
            except ValueError:
                return ("err", "parse", "DEADLINE bound %r is not a "
                        "number" % parts[1])
            if not (0 <= deadline < float("inf")):
                # float() accepts 'nan'/'inf'/negatives; a NaN deadline
                # compares False everywhere and silently DISABLES the
                # deadline — a client framing bug must get ERR parse,
                # not an unbounded request (NaN fails both comparisons)
                return ("err", "parse", "DEADLINE bound %r is not a "
                        "finite non-negative number" % parts[1])
            parts = parts[2:]
            if not parts:
                return ("err", "empty", "DEADLINE with no request tokens")
        try:
            toks = [int(t) for t in parts]
        except ValueError:
            return ("err", "parse", "non-integer token in request")
        if self.vocab and not all(0 <= t < self.vocab for t in toks):
            return ("err", "parse",
                    "token id outside vocab_size %d" % self.vocab)
        return ("req", toks, deadline, trace_id, tenant)

    def submit(self, line: str, reply, wait: bool = False):
        """Admit one request line. ``reply`` is called EXACTLY ONCE with
        the single response line — synchronously for rejections (shed /
        parse / draining: the fast path that never touches the worker),
        from the worker thread otherwise. ``wait=True`` blocks until the
        request is answered (the stdin pump: serial by construction, so
        responses stay in request order). Returns the request's done
        Event, or None when the line was answered synchronously."""
        parsed = self._parse(line)
        if parsed[0] == "admin":
            # the drain check and the scheduling are one critical
            # section with drain()'s flag flip (like the request path):
            # a drained frontend must not promise "OK reload scheduled"
            # for a reload no worker will ever run
            with self._cond:
                if self._draining or self._stop:
                    text = "ERR draining server is shutting down"
                else:
                    self._bump("admin")
                    args = parsed[1]
                    if args and args[0] == "reload":
                        self.request_reload()
                        text = "OK reload scheduled"
                    elif args and args[0] == "stats":
                        # counters plus the LIVE load gauges (the fleet
                        # router's load signal rides here too, not just
                        # /metrics) — read under this lock, so the
                        # snapshot is consistent with the queue
                        live = dict(self.stats(),
                                    queue_depth=len(self._q),
                                    in_flight=self._inflight)
                        # per-tenant books ride the same line as
                        # tenant.<id>.<key>=N — the router's fleet
                        # aggregation sums them like any other key, so
                        # fleet-wide per-tenant reconciliation is free
                        for t, st in self.tenant_stats().items():
                            for k, v in st.items():
                                live["tenant.%s.%s" % (t, k)] = v
                        if self.slot_backend is not None:
                            # free decode slots (bucket capacity −
                            # active): the router's prefer-the-replica-
                            # that-can-batch-it-in signal. Old replicas
                            # simply omit the field — backward
                            # compatible by absence.
                            live["free_slots"] = self._batch_free
                            # per-bucket warm-session + active-slot
                            # counts (bucket.<b>.warm / .active): the
                            # per-bucket load signal the router's
                            # /fleetz shows and disaggregated
                            # scheduling will route on — same
                            # backward-compatibility-by-absence
                            live["batch_buckets"] = len(self._buckets)
                            for b, bs in sorted(
                                    self._bucket_state.items()):
                                live["bucket.%d.warm" % b] = bs["warm"]
                                live["bucket.%d.active" % b] = \
                                    bs["active"]
                                if self._pool_state is not None:
                                    live["bucket.%d.blocks_held" % b] \
                                        = bs.get("blocks_held", 0)
                            if self._pool_state is not None:
                                # paged-KV pool load (process-global —
                                # the pool is shared across buckets, so
                                # these are TOP-level keys the fleet
                                # aggregation can sum exactly; same
                                # absence-is-the-capability-signal
                                # discipline as free_slots)
                                ps = self._pool_state
                                live["kv_blocks_total"] = \
                                    ps.get("blocks_total", 0)
                                live["kv_blocks_free"] = \
                                    ps.get("blocks_free", 0)
                                live["kv_retained_blocks"] = \
                                    ps.get("blocks_retained", 0)
                                live["kv_retained_hits"] = \
                                    ps.get("retained_hits", 0)
                                live["kv_pressure"] = \
                                    1 if self._kv_pressure else 0
                        wp = self.warm_programs()
                        if wp is not None:
                            # warm-grid readiness (the compile-cliff
                            # account): compiled vs expected serving
                            # programs — the router federates these
                            # onto /fleetz as the warm fraction, and
                            # absence (no registered grid) is the
                            # capability signal
                            live["warm_programs"] = wp[0]
                            live["expected_programs"] = wp[1]
                        text = "OK " + " ".join(
                            "%s=%d" % kv for kv in sorted(live.items()))
                    else:
                        text = ("ERR parse unknown ADMIN command %r"
                                % " ".join(args))
            self._send(reply, text)
            return None
        req = None
        shed = False
        shed_rec = None
        evicted = None
        tenant = parsed[4] if parsed[0] == "req" else None
        # admission decision + accounting in ONE critical section with
        # the drain flag: after drain() flips _draining (under this
        # lock) no request can slip an accepted count past its final
        # stats snapshot — a late arrival is refused WITHOUT entering
        # the accounting (it was never accepted; it still gets its one
        # response line). The socket write happens after release.
        with self._cond:
            if self._draining or self._stop:
                text = "ERR draining server is shutting down"
            elif parsed[0] == "err":
                _, cls, msg = parsed
                self._bump(*(("accepted", "empty", "errors")
                             if cls == "empty"
                             else ("accepted", "errors")))
                text = "ERR %s %s" % (cls, msg)
            elif self.breaker.blocked():
                # breaker open: shed instantly — no queue, no backend.
                # Third token "breaker" is wire format (module docstring):
                # retryable elsewhere AND "eject me from rotation"
                self._bump("accepted", "shed")
                self._bump_tenant(tenant, "accepted", "shed")
                shed = True
                shed_rec = self._shed_record(parsed, "breaker")
                text = "ERR busy breaker open (circuit)"
            elif len(self._q) >= self.queue_size \
                    and not (self._tenants
                             and not self._q.over_share(tenant)):
                # full queue, and the arrival holds no fair-share claim
                # (single-tenant mode, or a tenant at/over its share).
                # Third token is wire format: "queue" (genuinely out of
                # capacity — never dispatched, instantly retryable on
                # another replica) vs "tenant" (a fairness verdict that
                # holds fleet-wide under the shared tenant table — the
                # router relays it WITHOUT burning a retry)
                self._bump("accepted", "shed")
                self._bump_tenant(tenant, "accepted", "shed")
                shed = True
                if self._tenants and self._q.over_share(tenant):
                    shed_rec = self._shed_record(parsed, "tenant")
                    text = ("ERR busy tenant %s over fair share "
                            "(%d queued / share %d)"
                            % (tenant, self._q.depth(tenant),
                               self._q.shares[tenant]))
                else:
                    shed_rec = self._shed_record(parsed, "queue")
                    text = "ERR busy queue full (%d)" % self.queue_size
            else:
                if len(self._q) >= self.queue_size:
                    # full queue but the arrival is UNDER its fair
                    # share: the overload is borrowed capacity — evict
                    # the newest queued request of the tenant most over
                    # its share (the shed is charged to the borrower,
                    # answered after the lock) and admit the arrival
                    evicted = self._q.evict_over_share(tenant)
                    if evicted is None:
                        # queue full of in-share traffic: genuine
                        # capacity exhaustion, shed the arrival
                        self._bump("accepted", "shed")
                        self._bump_tenant(tenant, "accepted", "shed")
                        shed = True
                        shed_rec = self._shed_record(parsed, "queue")
                        text = ("ERR busy queue full (%d)"
                                % self.queue_size)
                if not shed:
                    _, toks, deadline, tid, tenant = parsed
                    req = _Request(toks, deadline, reply, tenant=tenant)
                    # the request id that threads through the whole
                    # datapath (trace context, flight record,
                    # /trace?request=<id>): a TRACE-propagated id wins
                    # — the router minted ONE id for this request
                    # fleet-wide, and every replica that touches it
                    # must file its flight record under it. The local
                    # counter still advances so TRACE-less requests
                    # keep their dense local ids either way.
                    self._rid += 1
                    req.id = tid if tid is not None else str(self._rid)
                    self._bump("accepted")
                    self._bump_tenant(tenant, "accepted")
                    self._q.append(req)
                    telemetry.gauge("serve.queue_depth", len(self._q))
                    self._cond.notify()
                    text = None
        if shed_rec is not None:
            # admission sheds land in the flight ring too: a request the
            # fleet router retried elsewhere leaves a record — under its
            # ONE trace id — on EVERY replica that touched it, so the
            # stitched cross-process trace can show the shed attempt
            # next to the served one (phases are honest zeros: nothing
            # was dequeued, nothing dispatched)
            self.flight.record(shed_rec)
            # ... and a serve_request_done event, so the OFFLINE join
            # (telemetry_report --fleet, keyed on the trace id) shows
            # the shed hop too, not just the live stitch. Phases are
            # null like every never-dispatched event — the report's
            # percentile table must not deflate during the overload
            # these events describe
            ev = {
                "ev": "serve_request_done", "req": shed_rec["id"],
                "outcome": "shed", "shed_at": shed_rec["shed_at"],
                "tokens": 0, "total_s": 0.0, "queue_wait_s": None,
                "dispatch_s": None, "prefill_s": None,
                "decode_s": None, "recompiles": 0}
            if shed_rec.get("tenant") is not None:
                ev["tenant"] = shed_rec["tenant"]
            telemetry.event(ev)
        if evicted is not None:
            # the borrower's newest queued request leaves so the
            # under-share arrival can take its place: answered (and
            # charged) OUTSIDE the admission lock — it was already
            # accepted, so the shed keeps its books reconciling, and
            # the shed is the BORROWER's, never the arriving tenant's
            self._shed_queued(evicted, tenant)
        if req is None:
            if shed:
                # an admission shed (queue full / breaker open /
                # fair-share verdict at accept) is an availability
                # failure the error budget must burn for, exactly like
                # a dispatch-time breaker shed — otherwise a
                # total-overload flood that sheds 99% of traffic at the
                # door keeps cxxnet_slo_burn at 0. The burn lands on
                # the SHED tenant's own window — a noisy tenant's sheds
                # must not page the victim's SLO.
                self._slo_observe(tenant, ok=False)
            self._send(reply, text)
            return None
        if wait:
            req.done.wait()
            return None
        return req.done

    def _shed_record(self, parsed, where: str) -> dict:
        """Flight record for a request shed AT ADMISSION (queue full /
        breaker open). Called under the admission lock — it mints from
        the same id counter accepted requests use, so ids stay unique
        per frontend; a TRACE-propagated id wins like everywhere else.
        Phases are honest zeros (nothing was dequeued or dispatched);
        the record exists so the ONE fleet-wide id names this request
        on every replica that touched it, shed attempts included."""
        _, toks, deadline, tid, tenant = parsed
        self._rid += 1
        return {"id": tid if tid is not None else str(self._rid),
                "outcome": "shed", "shed_at": where,
                "tenant": tenant,
                "tokens_in": len(toks), "tokens_out": 0,
                # cxxlint: disable=wallclock — flight-record arrival
                # epoch (the cross-process stitch key), never subtracted
                "t_wall": round(time.time(), 6),
                "total_s": 0.0, "wall_s": 0.0, "ttft_s": None,
                "tokens_per_s": None,
                "phases": {ph: 0.0 for ph in telemetry.REQUEST_PHASES},
                "recompiles": []}

    def _shed_queued(self, req: _Request, for_tenant: str) -> None:
        """Answer a QUEUED request evicted by the fair-share policy
        (charged to its own — borrowing — tenant): exactly-once answer,
        shed accounting, a flight record + serve_request_done event
        under its id (null phases: it never dispatched), and its
        tenant's SLO burn. Called outside the admission lock."""
        won = self._finish(
            req, "ERR busy tenant %s over fair share (evicted for %s)"
            % (req.tenant, for_tenant), "shed")
        if not won:
            return
        self.flight.record({
            "id": req.id, "outcome": "shed", "shed_at": "tenant",
            "tenant": req.tenant,
            "tokens_in": len(req.toks), "tokens_out": 0,
            "t_wall": round(req.t_wall, 6),
            "total_s": 0.0, "wall_s": 0.0, "ttft_s": None,
            "tokens_per_s": None,
            "phases": {ph: 0.0 for ph in telemetry.REQUEST_PHASES},
            "recompiles": []})
        telemetry.event({
            "ev": "serve_request_done", "req": req.id,
            "outcome": "shed", "shed_at": "tenant",
            "tenant": req.tenant,
            "tokens": 0, "total_s": 0.0, "queue_wait_s": None,
            "dispatch_s": None, "prefill_s": None,
            "decode_s": None, "recompiles": 0})
        self._slo_observe(req.tenant, ok=False)

    # -- hot reload ----------------------------------------------------
    def request_reload(self) -> None:
        """Schedule a model reload between requests. Only a plain
        attribute store — safe to call from a SIGHUP handler (taking a
        lock there could deadlock against the interrupted thread); the
        worker notices within its 0.25s idle poll."""
        self._reload_flag = True

    def _do_reload(self) -> None:
        self._reload_flag = False
        # EVERY processed reload request counts here — success, no-op
        # skip (reload_fn False: already serving the newest checkpoint)
        # and failure alike — while `reloads` counts only real swaps.
        # The fleet router's rolling reload waits on THIS delta, so a
        # no-op roll completes in milliseconds instead of burning its
        # whole per-replica timeout out of rotation.
        self._bump("reload_seen")
        if self.reload_fn is None:
            return
        try:
            ok = self.reload_fn()
        except Exception as e:
            telemetry.count("serve.reload_errors")
            telemetry.event({"ev": "serve_reload", "ok": False,
                            "error": repr(e)[:200]})
            sys.stderr.write("WARNING: servd: model reload failed (%s); "
                             "keeping the current model\n" % (e,))
            return
        if ok is not False:
            self._bump("reloads")
            telemetry.event({"ev": "serve_reload", "ok": True})

    # -- worker --------------------------------------------------------
    def _worker_run(self) -> None:
        while True:
            req = None
            with self._cond:
                while not self._q and not self._stop \
                        and not self._reload_flag:
                    # idle is legitimate silence: disarm the watchdog
                    # channel so an empty queue is not a hang
                    health.pause("serve.worker")
                    self._cond.wait(0.25)
                if self._q:
                    req = self._q.popleft()
                    telemetry.gauge("serve.queue_depth", len(self._q))
                    self._inflight = 1
                    self._inflight_req = req
                    self._inflight_since = time.monotonic()
                elif self._stop:
                    break
            health.beat("serve.worker")
            if self._reload_flag:
                # a checkpoint reload is legitimately silent time, like
                # a backend call: disarm the channel so a large-model
                # reload can't false-alarm (or abort) the watchdog
                health.pause("serve.worker")
                self._do_reload()
                health.beat("serve.worker")
                if req is not None:
                    with self._cond:
                        # reload time is not backend time: restart the
                        # stall clock for the dispatch that follows
                        self._inflight_since = time.monotonic()
            if req is None:
                continue
            try:
                self._dispatch(req)
            finally:
                with self._cond:
                    self._inflight = 0
                    self._inflight_req = None
                    self._inflight_since = None
                    self._cond.notify_all()

    def _dispatch(self, req: _Request) -> None:
        now = time.monotonic()
        t_pop = time.perf_counter()
        queue_wait = now - req.t_arrival
        telemetry.hist("serve.queue_wait", queue_wait)
        if req.deadline is not None and now > req.deadline:
            # expired while queued: answered BEFORE dispatch — the
            # backend never decodes an answer nobody is waiting for
            t_end = time.perf_counter()
            wall = time.monotonic() - req.t_arrival
            self._finish_observed(
                req, "ERR deadline expired %.0fms ago"
                % (1e3 * (now - req.deadline)), "deadline", "deadline",
                None, queue_wait, t_pop, t_pop, t_end, wall, 0)
            return
        if not self.breaker.allow():
            t_end = time.perf_counter()
            wall = time.monotonic() - req.t_arrival
            self._finish_observed(
                req, "ERR busy breaker open (circuit)", "shed", "shed",
                None, queue_wait, t_pop, t_pop, t_end, wall, 0)
            return
        req.seq, self._seq = self._seq, self._seq + 1
        telemetry.gauge("serve.in_flight", 1)
        # occupancy accounting: solo dispatch is one whole-request pass
        # at occupancy 1 — the honest weighted-mean pair (iterations /
        # slot-iterations) reads 1.0 here; the batched dispatcher feeds
        # the same series per decode ITERATION
        self._observe_occupancy(1)
        # the backend call is legitimately silent time on the worker
        # channel — a first-request decode-cache compile (or the
        # recompile after a hot reload) can far outlast any sane
        # watchdog_timeout, and the rule is that compiles never arm
        # heartbeat channels. Slow backends are watched by deadlines and
        # the breaker; a silently WEDGED one by the stall_after_s bound
        # on this dispatch (health/liveness probes above); the heartbeat
        # watches the worker loop itself.
        health.pause("serve.worker")
        # the trace context tags every span/compile the backend records
        # with this request's id and carries the trainer's first_token
        # mark back out — the TTFT boundary
        tc = telemetry.trace_context(req.id)
        t_back = t_pop
        try:
            with tc:
                t_back = time.perf_counter()
                with telemetry.span("serve.request",
                                    tokens=len(req.toks)):
                    out = self.backend(req.toks, req.seq)
                # the conversion is supervised too: a backend returning a
                # non-iterable-of-ints is a backend failure, not a worker
                # death sentence
                outs = [int(t) for t in out]
            text = " ".join(str(t) for t in outs)
        except Exception as e:
            t_end = time.perf_counter()
            wall = time.monotonic() - req.t_arrival
            health.beat("serve.worker")
            telemetry.gauge("serve.in_flight", 0)
            self.breaker.failure()
            telemetry.count("serve.backend_errors")
            telemetry.event({"ev": "serve_backend_error",
                             "error": repr(e)[:200], "req": req.id})
            # one line, whatever the exception said
            self._finish_observed(
                req, "ERR backend " + " ".join(repr(e).split())[:200],
                "errors", "backend_error", tc, queue_wait, t_pop,
                t_back, t_end, wall, 0)
            return
        t_end = time.perf_counter()
        wall = time.monotonic() - req.t_arrival
        health.beat("serve.worker")
        telemetry.gauge("serve.in_flight", 0)
        self.breaker.success()
        self._finish_observed(req, text, "served", "served", tc,
                              queue_wait, t_pop, t_back, t_end, wall,
                              len(outs))

    # -- batching dispatcher (slot_backend path) -----------------------
    def _observe_occupancy(self, n: int) -> None:
        """One decode pass/iteration with ``n`` sequences aboard: the
        last-write gauge (a glance value) plus the honest weighted-mean
        counter pair — mean occupancy = slot_iterations / iterations,
        exact however the scrape interleaves with batches."""
        self._occ_iters += 1
        self._occ_slots += n
        telemetry.gauge("serve.batch_occupancy", n)
        telemetry.count("serve.batch_iterations")
        telemetry.count("serve.batch_slot_iterations", n)

    def _publish_batch_state(self, sess, active, sessions=None):
        """Refresh the load signals after any slot change: the live
        in-flight gauge, the free-slot count ``ADMIN stats`` reports
        (idle = full capacity; an active session = its free slots),
        and the per-bucket warm-session/KV account. Returns ONE
        consistent queue snapshot ``(queue_depth, head_of_queue_age)``
        taken under the same admission-lock acquisition — the
        per-iteration telemetry (queue-age histogram, iteration ring,
        convoy verdict) records FROM this snapshot after the lock is
        released, never re-taking it per token. The KV accounts are
        read from the sessions BEFORE the lock (host metadata
        arithmetic — the work-outside-the-lock rule)."""
        cap = self._batch_capacity
        free = cap if not active else \
            max(0, min(cap, sess.nslots) - len(active))
        accts = {}
        for b, s in (sessions or {}).items():
            fn = getattr(s, "kv_account", None)
            if fn is None:
                continue
            try:
                accts[b] = fn()
            except Exception:
                pass          # an account must never kill the worker
        # the paged-KV pool account (block-exact: pool_bytes IS the
        # device arrays' nbytes) — host metadata arithmetic, read
        # BEFORE the lock like the per-session accounts
        pool = None
        pool_fn = getattr(self.slot_backend, "kv_pool_account", None)
        if pool_fn is not None:
            try:
                pool = pool_fn()
            except Exception:
                pool = None
        if pool is not None:
            pool = self._kv_pressure_tick(pool, pool_fn)
        with self._cond:
            self._batch_free = free
            qd = len(self._q)
            oldest = None
            if qd:
                t0 = (self._q.oldest_arrival()
                      if isinstance(self._q, _FairQueue)
                      else self._q[0].t_arrival)
                if t0 is not None:
                    oldest = max(0.0, time.monotonic() - t0)
            if sessions is not None:
                for b, bs in self._bucket_state.items():
                    a = accts.get(b) or {}
                    warm = 1 if (b in sessions
                                 and not getattr(sessions[b], "closed",
                                                 False)) else 0
                    bs.update(warm=warm,
                              active=int(a.get("active", 0)),
                              kv_bytes=int(a.get("kv_bytes", 0)),
                              kv_live_bytes=int(a.get("kv_live_bytes",
                                                      0)),
                              live_tokens=int(a.get("live_tokens", 0)),
                              alloc_tokens=int(a.get("alloc_tokens",
                                                     0)),
                              blocks_held=int(a.get("blocks_held", 0)))
                self._pool_state = pool
                # plain-int mirror for decode_kv_bytes: the perf
                # ledger's hook reads it per /metrics scrape, and must
                # not pay this (the admission) lock a second time per
                # render — benign GIL-atomic read, worker-only write.
                # Paged backends charge the POOL's real nbytes (the
                # per-bucket kv_bytes are block-table claims: a shared
                # block counts once per holder, and free blocks are
                # still allocated memory: this IS the arrays' nbytes)
                self._kv_total = (
                    int(pool.get("pool_bytes", 0)) if pool is not None
                    else sum(bs["kv_bytes"]
                             for bs in self._bucket_state.values()))
        telemetry.gauge("serve.in_flight", len(active))
        return qd, oldest

    def _kv_pressure_tick(self, pool: dict, pool_fn) -> dict:
        """The low-headroom KV pressure latch (worker thread only,
        OUTSIDE the admission lock — shedding is host metadata
        arithmetic on the single mutating owner). Latches when free
        blocks drop under ``kv_pressure_pct`` percent of the pool,
        sheds retained conversation blocks toward
        ``kv_pressure_clear_pct`` (the ``kv_shed_retained`` hook —
        proactive evict-ahead-of-flood, distinct from the allocator's
        own evict-before-defer at admission), and clears only at the
        higher threshold (hysteresis). One transition-only
        ``kv_pressure`` flight event per episode; the latch itself
        travels in the published pool snapshot (``pressure``) to
        /batchz, ADMIN stats and ``cxxnet_decode_kv_pressure``."""
        total = int(pool.get("blocks_total") or 0)
        if total <= 0 or self.kv_pressure_pct <= 0:
            return pool
        free_pct = 100.0 * int(pool.get("blocks_free") or 0) / total
        if not self._kv_pressure and free_pct < self.kv_pressure_pct:
            self._kv_pressure = True
            self._kv_pressures += 1
            self._kvp_t0 = time.monotonic()
            telemetry.count("serve.kv_pressure")
            telemetry.event({
                "ev": "kv_pressure", "pressure": 1,
                "free_pct": round(free_pct, 2),
                "retained": int(pool.get("blocks_retained") or 0)})
        if self._kv_pressure:
            shed_fn = getattr(self.slot_backend, "kv_shed_retained",
                              None)
            if shed_fn is not None \
                    and int(pool.get("blocks_retained") or 0) > 0:
                target = -(-int(self.kv_pressure_clear_pct * total)
                           // 100)
                try:
                    shed = int(shed_fn(target) or 0)
                except Exception:
                    shed = 0      # a shed must never kill the worker
                if shed > 0:
                    self._kv_shed_blocks += shed
                    telemetry.count("serve.kv_shed_blocks", shed)
                    try:
                        pool = pool_fn() or pool
                    except Exception:
                        pass
                    free_pct = (100.0 * int(pool.get("blocks_free")
                                            or 0) / total)
            if free_pct >= self.kv_pressure_clear_pct:
                self._kv_pressure = False
                if self._kvp_t0 is not None:
                    self._kvp_episodes.append(
                        (self._kvp_t0, time.monotonic()))
                    self._kvp_t0 = None
                telemetry.event({
                    "ev": "kv_pressure", "pressure": 0,
                    "free_pct": round(free_pct, 2)})
        pool = dict(pool)
        pool["pressure"] = 1 if self._kv_pressure else 0
        return pool

    def _drop_inflight(self, req: _Request) -> None:
        """A popped request got its final answer: leave drain's
        give-up list (the popped-but-unanswered account)."""
        with self._cond:
            try:
                self._inflight_reqs.remove(req)
            except ValueError:
                pass
            self._inflight = len(self._inflight_reqs)

    def _gather(self, limit: int, fresh: bool) -> List[_Request]:
        """Pop up to ``limit`` queued requests for admission. A FRESH
        batch (no active slots) waits up to the gather window for more
        to coalesce; mid-decode joins take only what is already queued
        — sequences mid-flight must never stall on the window. Popped
        requests enter ``_inflight_reqs`` under the SAME lock as the
        pop, so drain's accounting never sees a request in neither the
        queue nor the in-flight set."""
        out: List[_Request] = []
        if limit <= 0:
            return out
        # paged-KV block budget (doc/performance.md "Decode KV cache"):
        # a request is popped only when the pool can cover its fresh
        # blocks RIGHT NOW — head-of-queue order, no skip-ahead, so
        # exhaustion is a deterministic FIFO wait (retirements return
        # blocks mid-decode and the next turn's gather admits). The
        # budget is decremented per pop because this turn's admissions
        # have not hit the allocator yet (worst-case: same-turn prefix
        # twins are NOT credited — they defer one turn and then share).
        # Hooks absent (dense/solo backend) => no gate.
        kv_free = None
        need_fn = getattr(self.slot_backend, "kv_fresh_blocks", None)
        free_fn = getattr(self.slot_backend, "kv_free_blocks", None)
        if need_fn is not None and free_fn is not None:
            try:
                kv_free = free_fn()
            except Exception:
                kv_free = None    # the gate must never kill the worker
        deadline = None
        with self._cond:
            while True:
                while self._q and len(out) < limit:
                    if kv_free is not None:
                        # the NEXT pop's block demand — peek() on the
                        # tenant fair queue (its head is virtual-time
                        # order, not arrival order), [0] on the deque
                        peek = getattr(self._q, "peek", None)
                        head = peek() if peek is not None else self._q[0]
                        try:
                            need = need_fn(head.toks)
                        except Exception:
                            need = None
                        if need is not None and need > kv_free:
                            break
                        kv_free -= need or 0
                    req = self._q.popleft()
                    out.append(req)
                    self._inflight_reqs.append(req)
                if out:
                    self._inflight = len(self._inflight_reqs)
                    telemetry.gauge("serve.queue_depth", len(self._q))
                if len(out) >= limit or not fresh or not out \
                        or self.batch_window_s <= 0 \
                        or self._draining or self._stop:
                    break
                if deadline is None:
                    deadline = time.monotonic() + self.batch_window_s
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                self._cond.wait(min(rem, 0.05))
        return out

    def _finish_popped(self, req: _Request, text: str, counter: str,
                       outcome: str, tc, queue_wait: float, t_pop: float,
                       t_back: float, ntok: int,
                       occupancy: Optional[int] = None,
                       batch=None) -> None:
        """Terminal answer for a popped request on the batched path —
        the observed finish plus the in-flight bookkeeping drop."""
        t_end = time.perf_counter()
        wall = time.monotonic() - req.t_arrival
        self._finish_observed(req, text, counter, outcome, tc,
                              queue_wait, t_pop, t_back, t_end, wall,
                              ntok, occupancy=occupancy, batch=batch)
        self._drop_inflight(req)

    def _retire_info(self, st: _SlotState) -> dict:
        """Journal a slot retirement in the per-turn scheduler log
        (the iteration ring's ``retired`` column) and return the
        record's scheduling coordinates: bucket, slot index, and the
        [first, last] step-iteration ordinals the sequence was aboard
        (None when it never stepped — n_new == 1 finishes at prefill).
        Two records with the same bucket and overlapping iteration
        ranges shared decode passes — the without-the-ring join
        /requestz readers use."""
        self._turn_retired.append([st.req.id, st.slot])
        return {"bucket": st.bucket, "slot": st.slot,
                "iterations": ([st.first_iter, st.last_iter]
                               if st.first_iter is not None else None),
                "stall_s": round(st.stall_s, 6)}

    def _requeue_head(self, reqs) -> None:
        """Return popped-but-unadmitted requests to the queue HEAD in
        their given (arrival) order — the paged-KV defer path: the
        deferred request and everything popped behind it retry before
        anything that arrived later, so FIFO holds under block
        pressure and two defers can never invert each other (the
        admission loop stops at the first). queue_wait keeps running
        (admission, not pop, ends it)."""
        with self._cond:
            for req in reversed(reqs):
                try:
                    self._inflight_reqs.remove(req)
                except ValueError:
                    continue       # already answered (a drain raced)
                self._q.appendleft(req)
            self._inflight = len(self._inflight_reqs)
            telemetry.gauge("serve.queue_depth", len(self._q))

    def _fail_unadmitted(self, reqs, msg: str) -> None:
        """Answer popped-but-never-admitted requests ``ERR backend``
        (they never reached a slot: no phases, no dispatch) — the
        session-creation-failure and closed-session-leftover paths."""
        t_pop = time.perf_counter()
        now = time.monotonic()
        for req in reqs:
            self._finish_popped(req, msg, "errors", "backend_error",
                                None, now - req.t_arrival, t_pop,
                                t_pop, 0)

    def _admit_one(self, sb, sess, active, req: _Request,
                   stall0: float = 0.0):
        """Admit one popped request into a free slot of ``sess`` (its
        ``queue_wait`` ends HERE — slot admission, not queue pop): the
        solo dispatch-time gates first (expired deadline, breaker,
        backend compatibility), then the request's own b=1 prefill runs
        under its trace context — the per-request prefill phase and the
        first_token TTFT mark are per-slot, never per-batch. Returns
        the slot the request now occupies, or None (rejected, failed,
        or already complete — an ``n_new == 1`` request finishes at
        prefill and records its admission-order occupancy: it never
        shares a decode pass, so the batch-wide stamp does not apply)."""
        t_pop = time.perf_counter()
        now = time.monotonic()
        queue_wait = now - req.t_arrival
        telemetry.hist("serve.queue_wait", queue_wait)
        if req.deadline is not None and now > req.deadline:
            self._finish_popped(
                req, "ERR deadline expired %.0fms ago"
                % (1e3 * (now - req.deadline)), "deadline", "deadline",
                None, queue_wait, t_pop, t_pop, 0)
            return
        if not self.breaker.allow():
            self._finish_popped(
                req, "ERR busy breaker open (circuit)", "shed", "shed",
                None, queue_wait, t_pop, t_pop, 0)
            return
        admits = getattr(sb, "admits", None)
        detail = admits(req.toks) if admits is not None else None
        if detail:
            # a deterministic request defect (e.g. prompt too long for
            # the model): answered as a backend-class error (relayed by
            # the router, never retried) but NOT fed to the breaker —
            # the backend is healthy, the request is not
            self._finish_popped(
                req, "ERR backend " + " ".join(str(detail).split())[:200],
                "errors", "backend_error", None, queue_wait, t_pop,
                t_pop, 0)
            return
        slot = sess.free_slots()[0]
        req.seq, self._seq = self._seq, self._seq + 1
        tc = telemetry.trace_context(req.id)
        self._inflight_since = time.monotonic()
        health.pause("serve.worker")     # prefill may compile
        t_back = t_pop
        try:
            with tc:
                t_back = time.perf_counter()
                first, done = sess.prefill(slot, req.toks, req.seq)
        except kvblocks.KVPoolExhausted:
            # transient block-pool exhaustion (the gather budget lost a
            # race it cannot model, e.g. a same-turn batchmate taking
            # the blocks): the session is OPEN and no device work ran.
            # Hand the verdict back to the worker loop (_KV_DEFER) —
            # it requeues this request AND its unadmitted batchmates
            # at the queue head in arrival order (its queue_wait keeps
            # running) to retry after retirements return blocks. A
            # deterministic wait: never an error, never a breaker
            # count, never a device OOM.
            health.beat("serve.worker")
            self._inflight_since = None
            req.kv_defers += 1
            telemetry.count("serve.kv_defer")
            return _KV_DEFER
        except Exception as e:
            health.beat("serve.worker")
            self._inflight_since = None
            # classify by the session's own verdict: a DEVICE-section
            # failure CLOSES the session (the DecodeSession contract) —
            # that is a backend fault and feeds the breaker; a prefill
            # that raised WITHOUT closing never touched device state
            # (pre-dispatch validation, e.g. a prompt too long for a
            # backend with no admits() hook) — a deterministic request
            # defect that must not poison the breaker, exactly like the
            # admits() rejection above
            if getattr(sess, "closed", False):
                self.breaker.failure()
                telemetry.count("serve.backend_errors")
                telemetry.event({"ev": "serve_backend_error",
                                 "error": repr(e)[:200], "req": req.id})
            self._finish_popped(
                req, "ERR backend " + " ".join(repr(e).split())[:200],
                "errors", "backend_error", tc, queue_wait, t_pop,
                t_back, 0)
            return None
        health.beat("serve.worker")
        self._inflight_since = None
        st = _SlotState(req, tc, queue_wait, t_pop, t_back,
                        [int(first)], len(active) + 1, slot,
                        sess.nslots)
        # seed the batch-level stall this request already paid BEFORE
        # its slot existed (the turn's warm-session creation) — set
        # before the done-at-prefill early completion below so an
        # n_new == 1 request carries it too
        st.stall_s = float(stall0)
        active[slot] = st
        self._turn_admitted.append([req.id, slot])
        if done:
            self._complete_slot(sess, active, slot)
            return None
        return slot

    def _complete_slot(self, sess, active, slot) -> None:
        """A sequence produced its last token: answer, retire the slot
        (the next queued request joins here mid-decode), account."""
        st = active.pop(slot)
        sess.retire(slot)
        t_end = time.perf_counter()
        # the request's backend time (prefill -> its own last token)
        # feeds the serve.request histogram like the solo span does
        telemetry.hist("serve.request", max(0.0, t_end - st.t_back))
        self.breaker.success()
        text = " ".join(str(t) for t in st.toks)
        self._finish_popped(st.req, text, "served", "served", st.tc,
                            st.queue_wait, st.t_pop, st.t_back,
                            len(st.toks), occupancy=st.occ,
                            batch=self._retire_info(st))

    def _retire_expired(self, sess, active) -> None:
        """Per-ITERATION deadline enforcement: an expired sequence
        retires with ``ERR deadline`` between iterations — the others
        keep decoding. Its real prefill/decode phases are recorded
        (the backend did burn that time)."""
        now = time.monotonic()
        for slot, st in list(active.items()):
            req = st.req
            if req.deadline is not None and now > req.deadline:
                del active[slot]
                sess.retire(slot)
                self._finish_popped(
                    req, "ERR deadline expired %.0fms ago (mid-decode)"
                    % (1e3 * (now - req.deadline)), "deadline",
                    "deadline", st.tc, st.queue_wait, st.t_pop,
                    st.t_back, len(st.toks), occupancy=st.occ,
                    batch=self._retire_info(st))

    def _fail_batch(self, sess, active, exc: Exception,
                    count_failure: bool = True) -> None:
        """A decode STEP failed: the whole batch is lost — every active
        sequence is answered ``ERR backend`` (exactly once), the
        breaker counts ONE backend failure, the session is dropped.
        ``count_failure=False`` when the underlying fault was already
        counted (a failed PREFILL closed the session: _admit_one's
        except path counted it — the batch dies of that same fault,
        and one fault must cost the breaker AND the backend-error
        series exactly one count; the event still fires, naming the
        requests the fault took down)."""
        if count_failure:
            self.breaker.failure()
            telemetry.count("serve.backend_errors")
        telemetry.event({"ev": "serve_backend_error",
                         "error": repr(exc)[:200],
                         "reqs": [st.req.id for st in active.values()]})
        msg = "ERR backend " + " ".join(repr(exc).split())[:200]
        for slot, st in list(active.items()):
            try:
                sess.retire(slot)
            except Exception:
                pass               # a rescued (closed) session may
                #                    refuse the retire: the slot dies
                #                    with the session either way
            self._finish_popped(st.req, msg, "errors", "backend_error",
                                st.tc, st.queue_wait, st.t_pop,
                                st.t_back, len(st.toks),
                                occupancy=st.occ,
                                batch=self._retire_info(st))
        active.clear()

    def _rescue_run(self) -> None:
        """Batch-rescue watchdog loop (doc/robustness.md "Failover &
        hedging"): a dispatch wedged inside the backend past the stall
        bound gets its batch EVICTED — every aboard request is
        answered ``ERR backend rescued`` (a replayable loss upstream:
        provably no answer left this replica) instead of sitting
        hostage until the router's stall timeout. Poll cadence scales
        with the bound."""
        tick = max(0.01, min(0.25, self.stall_after_s / 4.0))
        while not self._stop:
            if self._stalled_for() > self.stall_after_s \
                    and not self._batch_rescued:
                self._rescue_batch(self._stalled_for())
            time.sleep(tick)

    def _rescue_batch(self, stalled: float) -> None:
        """Evict the wedged batch: answer every in-flight request
        (exactly once — the answer-slot claim), count ONE breaker
        failure + ``serve.batch_rescues``, close the wedged session.
        The worker, still blocked inside ``sess.step()``, observes
        ``_batch_rescued`` when the backend finally returns (or
        raises on the closed session) and runs the slot/journal
        cleanup with ``count_failure=False`` — one fault, one count.
        The in-flight set is NOT dropped here: ``_stalled_for`` keeps
        reporting the wedge to the health probe until the worker
        actually recovers."""
        sess = self._cur_sess
        since0 = self._inflight_since
        with self._cond:
            reqs = list(self._inflight_reqs)
        if not reqs or since0 is None:
            return
        self._batch_rescued = True
        # verify-then-commit: the step may have ended in the window
        # between the trigger check and the flag write — bail (and
        # un-flag) rather than rescue a batch that is not wedged
        if self._cur_sess is not sess or self._inflight_since != since0:
            self._batch_rescued = False
            return
        self.breaker.failure()
        telemetry.count("serve.batch_rescues")
        telemetry.event({"ev": "serve_batch_rescue",
                         "stalled_s": round(stalled, 3),
                         "reqs": [r.id for r in reqs]})
        msg = ("ERR backend rescued batch wedged %.1fs inside the "
               "backend (stall bound %.1fs; replayable: no answer "
               "left this replica)" % (stalled, self.stall_after_s))
        for req in reqs:
            self._finish(req, msg, "errors")
        if sess is not None:
            try:
                close = getattr(sess, "close", None)
                if close is not None:
                    close()
            except Exception:
                pass

    def _worker_run_batched(self) -> None:
        """The iteration-granularity scheduling loop (module docstring
        "Continuous batching"): coalesce -> admit into slots ->
        per-iteration deadlines -> step every active slot one token ->
        retire finished sequences -> repeat, admitting queued requests
        into freed slots MID-DECODE. Sessions are pooled per bucket and
        stay warm (their programs cache per bucket signature — a
        request joining a warm bucket never recompiles); a model reload
        waits for the in-flight batch, then closes every session."""
        sb = self.slot_backend
        buckets = self._buckets
        cap = self._batch_capacity
        sessions = {}                  # bucket -> warm session
        sess = None                    # current session
        active = {}                    # slot -> _SlotState
        last_bucket = 0                # bucket of the most recent
        #                                session: flush records filed
        #                                after a faulted session was
        #                                evicted (sess = None) must
        #                                name the REAL bucket, not 0

        def close_all():
            for s in sessions.values():
                try:
                    close = getattr(s, "close", None)
                    if close is not None:
                        close()
                except Exception:
                    pass
            sessions.clear()

        while True:
            with self._cond:
                while not self._q and not active and not self._stop \
                        and not self._reload_flag:
                    health.pause("serve.worker")
                    self._cond.wait(0.25)
                if self._stop and not active:
                    break
            health.beat("serve.worker")
            if self._reload_flag and not active:
                # reload only BETWEEN batches: the slot caches hold the
                # old model's K/V — close the warm sessions (their
                # programs die with the old trainer), swap, resume
                health.pause("serve.worker")
                close_all()
                sess = None
                self._do_reload()
                health.beat("serve.worker")
                # the closed sessions released their caches: zero the
                # KV account NOW, not at the next admission — /batchz
                # and the HBM headroom hook must not show a freed
                # cache as still allocated across an idle stretch
                self._publish_batch_state(None, {}, sessions)
                continue
            # --- admit: coalesce queued requests into free slots ---
            if not self._reload_flag:
                sess_stall = 0.0
                if not active:
                    batch = self._gather(cap, fresh=True)
                    if batch:
                        b = next((x for x in buckets
                                  if x >= len(batch)), buckets[-1])
                        last_bucket = b
                        sess = sessions.get(b)
                        if sess is None:
                            try:
                                # warm-session creation compiles the
                                # bucket's admit/step programs OUTSIDE
                                # any request's trace context: the
                                # compile window attributes the cliff
                                # to every request admitted this turn
                                # (compile_stall_s on their flight
                                # records)
                                with telemetry.compile_window(
                                        "session:b%d" % b) as cw:
                                    sess = sessions[b] = sb.session(b)
                                sess_stall = cw.stall_s
                            except Exception as e:
                                # the batch never reached a slot: every
                                # drained request is answered, the
                                # breaker counts one failure
                                self.breaker.failure()
                                telemetry.count("serve.backend_errors")
                                telemetry.event(
                                    {"ev": "serve_backend_error",
                                     "error": repr(e)[:200]})
                                self._fail_unadmitted(
                                    batch, "ERR backend "
                                    + " ".join(repr(e).split())[:200])
                                batch = []
                                sess = None
                else:
                    free = min(len(sess.free_slots()),
                               cap - len(active))
                    batch = self._gather(free, fresh=False) \
                        if free > 0 else []
                leftovers = []
                new_slots = []
                for i, req in enumerate(batch):
                    slot = self._admit_one(sb, sess, active, req,
                                           stall0=sess_stall)
                    if slot is _KV_DEFER:
                        # the pool could not cover this admission (the
                        # gather budget's rare blind spot): it and its
                        # unadmitted batchmates go back to the queue
                        # head in arrival order — nothing popped after
                        # the deferred request may admit ahead of it
                        self._requeue_head([req] + list(batch[i + 1:]))
                        break
                    if slot is not None:
                        new_slots.append(slot)
                    if getattr(sess, "closed", False):
                        # a failed prefill closed the session: stop
                        # admitting — every further prefill would raise
                        # "closed" and spuriously count ANOTHER breaker
                        # failure for the same single fault (one fault,
                        # one count: _admit_one's except path had it)
                        leftovers = batch[i + 1:]
                        break
                # every request admitted THIS turn shares its first
                # decode pass with the whole turn's admissions: stamp
                # the final occupancy on all of them — the sequential
                # per-admit stamp would record 1, 2, 3, 4 for a fully
                # coalesced 4-request batch and /requestz would read
                # "not coalesced" for its first member
                for s in new_slots:
                    if s in active:
                        active[s].occ = len(active)
                if sess is not None and getattr(sess, "closed", False):
                    # the session's device state integrity is unknown:
                    # answer everything that died of the one prefill
                    # fault (no further breaker counts) and evict it
                    # from the warm pool — a broken session left pooled
                    # would poison every later batch
                    self._fail_unadmitted(
                        leftovers, "ERR backend decode session closed "
                        "by a failed prefill")
                    if active:
                        self._fail_batch(
                            sess, active, RuntimeError(
                                "decode session closed by a failed "
                                "prefill"), count_failure=False)
                    sessions = {b: s for b, s in sessions.items()
                                if s is not sess}
                    sess = None
            # --- per-iteration deadline retirement ---
            if active:
                self._retire_expired(sess, active)
            if sess is not None:
                last_bucket = sess.nslots
            qd, qage = self._publish_batch_state(sess, active, sessions)
            if not active:
                b0 = sess.nslots if sess is not None else last_bucket
                if self._turn_admitted or self._turn_retired:
                    # a turn with journal entries but NO decode pass
                    # (every admission finished at prefill, or every
                    # sequence deadline-retired): flush it NOW — left
                    # queued, the entries would be misattributed to
                    # whatever iteration comes next (or lost at drain).
                    # The flush also runs the convoy clear.
                    self._record_iteration(b0, [], None, qd, qage,
                                           occupancy_after=0,
                                           stepped=False)
                else:
                    # nothing to step: the convoy latch must still
                    # clear (the straggler retired / queue drained)
                    self._eval_convoy(b0, self._batch_free, [], qd,
                                      qage)
                continue
            # --- one decode iteration: every active slot, one token ---
            self._observe_occupancy(len(active))
            self._iter_ord += 1
            it_ord = self._iter_ord
            for st in active.values():
                if st.first_iter is None:
                    st.first_iter = it_ord
                st.last_iter = it_ord
            # the iteration's slot map (slot, occupant id, age in step
            # iterations) — snapshotted BEFORE the step so the record
            # reflects exactly the composition that decoded together
            slots_snap = [[s, st.req.id, it_ord - st.first_iter]
                          for s, st in sorted(active.items())]
            bucket = sess.nslots
            self._cur_sess = sess          # the rescue watchdog's view
            self._inflight_since = time.monotonic()
            health.pause("serve.worker")   # a fresh bucket may compile
            t_step = time.perf_counter()
            try:
                # the decode step runs with NO trace context (it is
                # batch-wide work): the compile window catches a
                # first-step cliff and the dispatcher fans it out to
                # every sequence that sat through it
                with telemetry.compile_window(
                        "step:b%d" % bucket) as cw:
                    res = sess.step()
            except Exception as e:
                step_s = time.perf_counter() - t_step
                health.beat("serve.worker")
                self._inflight_since = None
                self._cur_sess = None
                if cw.stall_s:
                    for st in active.values():
                        st.stall_s += cw.stall_s
                # a rescued batch already answered its requests and
                # counted the fault (the watchdog): this cleanup pass
                # must not double the breaker count — the finishes
                # below are abandoned no-ops either way (claims taken)
                rescued = self._batch_rescued
                self._batch_rescued = False
                self._fail_batch(sess, active, e,
                                 count_failure=not rescued)
                # the session's state is suspect: drop it from the pool
                sessions = {b: s for b, s in sessions.items()
                            if s is not sess}
                sess = None
                qd, qage = self._publish_batch_state(sess, active,
                                                     sessions)
                # the crash iteration is scheduler history too: ringed
                # with its error so /batchz shows where the batch died
                self._record_iteration(bucket, slots_snap, step_s, qd,
                                       qage, occupancy_after=0,
                                       error=repr(e)[:200])
                continue
            step_s = time.perf_counter() - t_step
            health.beat("serve.worker")
            self._inflight_since = None
            self._cur_sess = None
            if cw.stall_s:
                for st in active.values():
                    st.stall_s += cw.stall_s
            if self._batch_rescued:
                # the wedge cleared just as the watchdog evicted the
                # batch: the requests are already answered upstream —
                # run the same cleanup as a failed step (abandoned
                # no-ops) and drop the closed session
                self._batch_rescued = False
                self._fail_batch(sess, active, RuntimeError(
                    "batch rescued by the stall watchdog"),
                    count_failure=False)
                sessions = {b: s for b, s in sessions.items()
                            if s is not sess}
                sess = None
                qd, qage = self._publish_batch_state(sess, active,
                                                     sessions)
                self._record_iteration(bucket, slots_snap, step_s, qd,
                                       qage, occupancy_after=0,
                                       error="batch rescued")
                continue
            for slot, tok, done in res:
                st = active.get(slot)
                if st is None:
                    continue           # retired this iteration
                st.toks.append(int(tok))
                if done:
                    self._complete_slot(sess, active, slot)
            qd, qage = self._publish_batch_state(sess, active, sessions)
            self._record_iteration(bucket, slots_snap, step_s, qd, qage,
                                   occupancy_after=len(active))
        close_all()
        # the worker is exiting (drain/stop): the closed sessions
        # released their caches — zero the KV account so a /metrics
        # or /programz scrape during the drain window (or a later
        # task in this process reading the perf ledger's decode hook)
        # never reports freed memory as allocated (the reload path's
        # own invariant)
        self._publish_batch_state(None, {}, sessions)

    def _episode_overlap(self, episodes, open_t0, a: float,
                         b: float) -> float:
        """Seconds of the monotonic span [a, b] covered by recorded
        episode windows plus a still-open episode (latched at
        ``open_t0``, not yet cleared). Worker thread only — the
        episode deques have a single writer and a single reader."""
        s = 0.0
        for e0, e1 in episodes:
            s += max(0.0, min(b, e1) - max(a, e0))
        if open_t0 is not None:
            s += max(0.0, b - max(a, open_t0))
        return s

    def _observe_request(self, req: _Request, tc, outcome: str,
                         queue_wait: float, t_pop: float, t_back: float,
                         t_end: float, wall: float, ntok: int,
                         occupancy: Optional[int] = None,
                         batch=None) -> None:
        """Phase-attribute one dequeued request and publish everything
        downstream reads: the TTFT / per-token histograms and
        tokens-per-second gauge, the flight record, the
        ``serve_request_done`` event, and the SLO account. Phases TILE
        the request's accept->answer wall-clock — queue_wait, dispatch
        (pop -> backend call), prefill (call -> first token), decode
        (first -> last token) — so their sum IS the total; a request
        that never reached the backend (deadline, breaker shed) carries
        only queue_wait + dispatch."""
        dispatch = max(0.0, t_back - t_pop)
        prefill = decode = 0.0
        ttft = None
        dispatched = outcome in ("served", "backend_error", "abandoned")
        ft = tc.marks.get("first_token") if tc is not None else None
        if outcome == "deadline" and ft is not None:
            # batched path: a sequence retired MID-DECODE by its
            # deadline really did prefill and decode — record the
            # phases (the never-dispatched deadline keeps tc=None, so
            # the solo expired-in-queue case is unchanged)
            dispatched = True
        if dispatched:
            if ft is not None and t_back <= ft <= t_end:
                prefill = ft - t_back
                decode = t_end - ft
            else:
                # no first-token mark (simple backends, or a failure
                # before one): the whole call is prefill — first token
                # and last token arrive together
                prefill = t_end - t_back
            if outcome == "served":
                ttft = queue_wait + dispatch + prefill
        total = queue_wait + dispatch + prefill + decode
        # ``wall`` is the independently measured accept->last-token
        # wall-clock (one monotonic interval, stamped adjacent to t_end
        # by the caller): the >=95% phase-coverage acceptance is checked
        # against THIS, not against the phase sum itself — a regression
        # that drops or mis-measures a phase moves total in lockstep
        # but cannot move wall
        if ttft is not None:
            telemetry.hist("serve.ttft", ttft)
        if decode > 0 and ntok > 1:
            telemetry.hist("serve.decode_per_token", decode / (ntok - 1))
        tps = None
        gen = prefill + decode
        if outcome == "served" and ntok and gen > 0:
            tps = ntok / gen
            telemetry.gauge("serve.tokens_per_second", round(tps, 3))
            telemetry.count("serve.tokens", ntok)
        if self._tenants and req.tenant is not None:
            # the per-tenant latency account: a serve.* series per
            # tenant (bounded by the conf table), so the fleet
            # federation's exact histogram merge yields per-tenant
            # fleet p99 with no extra wire format — the "victim's p99
            # holds" acceptance is read off exactly this series
            telemetry.hist("serve.tenant.%s.request" % req.tenant,
                           total)
        rec = {"id": req.id, "outcome": outcome,
               "tenant": req.tenant,
               "tokens_in": len(req.toks), "tokens_out": ntok,
               "t_wall": round(req.t_wall, 6),
               "total_s": round(total, 6),
               "wall_s": round(wall, 6),
               "ttft_s": round(ttft, 6) if ttft is not None else None,
               "tokens_per_s": round(tps, 3) if tps is not None else None,
               "phases": {"queue_wait": round(queue_wait, 6),
                          "dispatch": round(dispatch, 6),
                          "prefill": round(prefill, 6),
                          "decode": round(decode, 6)},
               "recompiles": list(tc.compiles) if tc is not None else []}
        # compile seconds this request paid: its OWN prefill's
        # recompiles (tc.compiles) plus the batch-wide cliffs the
        # dispatcher's compile window attributed to its slot
        # (warm-session creation, a first decode step) — exactly 0.0
        # for a request riding warm programs, so TTFT decomposes into
        # "queued" vs "paying the cliff" honestly
        stall = sum(c["dur"] for c in tc.compiles) \
            if tc is not None else 0.0
        if batch is not None:
            stall += batch.get("stall_s") or 0.0
        rec["compile_stall_s"] = round(stall, 6)
        if req.seq >= 0:
            # the dispatch ordinal the backend was handed (the driver
            # folds it into the sampling seed: gen_seed + seq), so a
            # sampled answer can be replayed alone from its record
            rec["seq"] = req.seq
        if occupancy is not None:
            # sequences sharing the decode pass when this request was
            # admitted to its slot (itself included): /trace and
            # /requestz show the coalescing, request by request
            rec["occupancy_at_dispatch"] = int(occupancy)
        if batch is not None:
            # the scheduling coordinates (_retire_info): bucket, slot,
            # and [first, last] step-iteration ordinals — /requestz
            # answers "who did this request share its decode with"
            # by joining overlapping ranges, no iteration ring needed
            rec["bucket"] = batch.get("bucket")
            rec["slot"] = batch.get("slot")
            rec["iterations"] = batch.get("iterations")
        if tps is not None:
            # the decode-step roofline bound for THIS token count (the
            # performance ledger's card, null until one is ready):
            # measured tokens/s far under it flags "slower than the
            # hardware allows" per request, right in /requestz
            rec["roofline_bound_tokens_per_s"] = \
                perf.decode_bound_tokens_per_s(ntok)
        if tc is not None and tc.counts:
            rec["counts"] = dict(tc.counts)
        # autopsy inputs + verdict (utils/autopsy.py): seconds of this
        # request's [arrival, answer] span spent inside convoy / KV-
        # pressure episodes, its block-pool defer count, and the
        # classified cause decomposition — /why renders it, the
        # serve_request_done event carries it, and /eventz joins
        # incident rows to the requests whose autopsies cite them
        t1 = req.t_arrival + wall
        rec["convoy_overlap_s"] = round(self._episode_overlap(
            self._convoy_episodes, self._convoy_t0,
            req.t_arrival, t1), 6)
        rec["kv_pressure_overlap_s"] = round(self._episode_overlap(
            self._kvp_episodes, self._kvp_t0, req.t_arrival, t1), 6)
        rec["kv_defers"] = req.kv_defers
        rec["autopsy"] = autopsy.classify_record(rec)
        self.flight.record(rec)
        ev = {"ev": "serve_request_done", "req": req.id,
              "outcome": outcome, "tokens": ntok,
              "total_s": rec["total_s"],
              "recompiles": len(rec["recompiles"]),
              "compile_stall_s": rec["compile_stall_s"]}
        if req.tenant is not None:
            ev["tenant"] = req.tenant
        for ph, v in rec["phases"].items():
            ev[ph + "_s"] = v
        if not dispatched:
            # the flight record's zeros are honest (phases tile the
            # wall-clock), but the report's phase percentiles aggregate
            # these events: a deadline/shed request never HAD a prefill
            # or decode, and hard zeros would deflate the latency table
            # exactly during the overload it triages — null, like ttft
            ev["prefill_s"] = ev["decode_s"] = None
        if ttft is not None:
            ev["ttft_s"] = rec["ttft_s"]
        ev["autopsy"] = rec["autopsy"]
        telemetry.event(ev)
        self._slo_observe(req.tenant, ok=(outcome == "served"),
                          ttft_s=ttft, latency_s=total)

    # -- TCP listener --------------------------------------------------
    def _accept_run(self) -> None:
        sock = self._sock       # local ref: drain() nulls the attribute
        while True:
            with self._cond:
                if self._draining or self._stop:
                    break
            health.beat("serve.accept")
            try:
                conn, _addr = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break               # listener closed (drain)
            # sends run on the connection's own writer thread, so a
            # stalled reader only wedges itself — and only for this
            # long, then its connection is torn down and counted gone
            conn.settimeout(self.client_timeout)
            threading.Thread(target=self._client_run, args=(conn,),
                             name="cxn-servd-client", daemon=True).start()
        health.pause("serve.accept")

    def _conn_writer(self, conn: socket.socket, st: _ConnState) -> None:
        """Per-connection writer: transmits filled reply slots strictly
        head-first. Sends happen HERE, never on the worker thread — a
        client that stops reading (full TCP window) stalls only its own
        connection for up to ``client_timeout``, not every client's
        dispatch. Exits once the reader saw EOF and every slot is out."""
        while True:
            with st.cond:
                while not ((st.slots and st.slots[0][0] is not None)
                           or (st.eof and not st.slots)):
                    st.cond.wait(0.5)
                if st.eof and not st.slots:
                    return
                s = st.slots.popleft()
            if st.dead:
                # connection torn down: discard quietly, but keep
                # draining slots so the reader's join terminates
                with st.cond:
                    st.unsent -= 1
                    st.cond.notify_all()
                continue
            try:
                conn.sendall((s[0] + "\n").encode("utf-8", "replace"))
            except OSError:
                # a failed/timed-out send may have written PART of a
                # response: the positional stream is unrecoverable —
                # tear the connection down rather than feed a resumed
                # client desynced bytes (socket.timeout is an OSError)
                st.dead = True
                self._bump("client_gone")
                try:
                    conn.close()
                except OSError:
                    pass
            finally:
                with st.cond:
                    st.unsent -= 1
                    st.cond.notify_all()

    def _client_run(self, conn: socket.socket) -> None:
        # responses must leave the socket in REQUEST order — the line
        # protocol pairs them positionally. A synchronous rejection
        # (parse error, shed) is produced by this reader thread while
        # earlier requests may still sit in the queue, so replies are
        # buffered in per-line slots and transmitted strictly head-first
        # by the connection's writer thread: shedding stays instant for
        # the SERVER (no queue entry, no backend), the rejected client
        # just reads its answer in order.
        st = _ConnState()
        with self._conn_lock:
            self._conns.add(st)

        def make_reply(slot):
            def reply(text: str) -> None:
                with st.cond:
                    slot[0] = text
                    st.unsent += 1
                    st.cond.notify_all()
            return reply

        writer = threading.Thread(target=self._conn_writer,
                                  args=(conn, st),
                                  name="cxn-servd-send", daemon=True)
        writer.start()
        try:
            buf = b""
            while True:
                # explicit recv loop (not makefile): a timeout here is
                # an IDLE client — e.g. one waiting out a long queued
                # decode — and must keep the connection, with no
                # partial-line loss
                try:
                    chunk = conn.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    break
                eof = not chunk
                if eof and buf:
                    # client EOF with an unterminated final line: still
                    # a request (stdin's `for line in sys.stdin` yields
                    # such a line too — the two surfaces must agree, and
                    # silence is exactly the framing-bug failure ERR
                    # empty exists to prevent)
                    buf += b"\n"
                buf += chunk
                while b"\n" in buf:
                    raw, buf = buf.split(b"\n", 1)
                    line = raw.decode("utf-8", "replace").rstrip("\r")
                    slot = [None]
                    with st.cond:
                        st.slots.append(slot)
                    self.submit(line, make_reply(slot))
                if eof:
                    break
            # client EOF: the writer finishes delivering every answer,
            # however long the requests take — each submitted line gets
            # EXACTLY one reply (the worker's, or drain's ERR), so this
            # join terminates; no budget that could drop a slow answer
            with st.cond:
                st.eof = True
                st.cond.notify_all()
            writer.join()
        finally:
            with self._conn_lock:
                self._conns.discard(st)
            try:
                conn.close()
            except OSError:
                pass

    # -- graceful drain ------------------------------------------------
    def drain(self, timeout_ms: Optional[float] = None) -> dict:
        """Stop accepting, finish every accepted request within the
        budget (``drain_ms`` default), answer any leftovers ``ERR
        draining``, flush telemetry, and return the final stats. Exactly
        one response line per accepted request — a drained shutdown
        loses zero accepted requests. Idempotent."""
        budget = (self.drain_ms if timeout_ms is None
                  else float(timeout_ms)) / 1e3
        t0 = time.monotonic()
        with self._cond:
            self._draining = True
            queued = len(self._q)
            self._cond.notify_all()
        telemetry.event({"ev": "serve_drain", "phase": "begin",
                         "queued": queued})
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None
        deadline = t0 + budget
        with self._cond:
            while (self._q or self._inflight) \
                    and time.monotonic() < deadline:
                self._cond.wait(0.05)
            leftovers = list(self._q)
            self._q.clear()
            telemetry.gauge("serve.queue_depth", 0)
            self._stop = True
            self._cond.notify_all()
        for req in leftovers:
            # budget exhausted: still exactly one response per accepted
            # request — an explicit ERR beats a silent dropped socket
            if self._finish(req, "ERR draining shutdown budget "
                            "exhausted", "errors"):
                # an accepted request the client lost burns error
                # budget like an admission shed — a preemption that
                # drains a full queue as ERR draining must not leave
                # cxxnet_slo_burn reading 0 in the final snapshot (the
                # wedged in-flight case is covered by the worker's
                # "abandoned" observation when the backend returns)
                self._slo_observe(req.tenant, ok=False)
        if self._worker_thread is not None:
            self._worker_thread.join(
                timeout=max(0.5, deadline - time.monotonic() + 1.0))
            if self._worker_thread.is_alive() or self._inflight:
                # the backend outlived even the post-budget grace, or
                # the worker died with requests aboard (an error raised
                # outside its supervised calls): every in-flight request
                # (ONE on the solo path, the whole popped batch on the
                # batching path) is answered HERE, once — if the wedged
                # backend ever returns, the worker's _finish loses the
                # claim and is a no-op
                with self._cond:
                    reqs = list(self._inflight_reqs)
                    if self._inflight_req is not None:
                        reqs.append(self._inflight_req)
                for req in reqs:
                    self._finish(req, "ERR draining backend exceeded "
                                 "the drain budget", "errors")
        # every accepted request is answered by now, but TCP answers are
        # transmitted by per-connection writer threads (daemons): wait
        # for the buffered ones to reach the kernel, or a response could
        # die with the interpreter — a silently dropped answer, exactly
        # what drain exists to prevent. Bounded: a stalled reader's send
        # times out at client_timeout and counts the client gone.
        flush_by = time.monotonic() + self.client_timeout + 1.0
        while time.monotonic() < flush_by:
            with self._conn_lock:
                conns = list(self._conns)
            if all(c.unsent == 0 for c in conns):
                break
            time.sleep(0.02)
        health.pause("serve.worker")
        health.pause("serve.accept")
        # the laws leave the registry with the frontend; a latch
        # observed before drain survives the unregister (the auditor's
        # contract), so a violation still fails the next scrape
        for law in ("serve.books", "serve.tenant_books", "kv.blocks"):
            telemetry.audit_unregister(law)
        stats = self.stats()
        telemetry.event(dict({"ev": "serve_drain", "phase": "end",
                              "seconds": round(time.monotonic() - t0, 3)},
                             **stats))
        telemetry.flush()
        return stats


# ----------------------------------------------------------------------
def _ask(port: int, line: str, timeout: float = 5.0) -> str:
    """One-shot client (selftest + stub tooling): one request, one
    response line."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as c:
        c.sendall((line + "\n").encode("utf-8"))
        resp = c.makefile("r", encoding="utf-8").readline()
    return resp.rstrip("\n")


def selftest(verbose: bool = False) -> int:
    """Drive the full admission/deadline/breaker/reload/drain machinery
    over a real loopback socket with an injected backend. Runs with
    runtime lock-order
    enforcement on (utils/lockrank.py): an inversion anywhere in the
    machinery raises a named LockOrderError instead of deadlocking."""
    with lockrank.enforced():
        return _selftest_body(verbose)


def _selftest_body(verbose: bool = False) -> int:
    boom = {"on": False}
    reloads = []

    def backend(toks, seq):
        if boom["on"]:
            raise RuntimeError("injected backend failure")
        if toks and toks[0] == 42:
            # a real (ms-scale) duration: the phase-coverage assertion
            # compares against an independently stamped wall-clock, and
            # on a µs echo request scheduler noise would dominate
            time.sleep(0.025)
        return [t + 1 for t in toks]

    fe = ServeFrontend(backend, queue_size=4, breaker_fails=2,
                       breaker_cooldown_ms=300.0, drain_ms=2000.0,
                       vocab=100,
                       reload_fn=lambda: reloads.append(1) or True)
    fe.start()
    port = fe.listen(0)
    try:
        # happy path + parse/empty/vocab rejection
        assert _ask(port, "1 2 3") == "2 3 4"
        assert _ask(port, "").startswith("ERR empty")
        assert _ask(port, "1 x 2").startswith("ERR parse")
        assert _ask(port, "1 999").startswith("ERR parse")
        assert _ask(port, "DEADLINE nope 1").startswith("ERR parse")
        # a 0ms deadline has always expired by dispatch time
        assert _ask(port, "DEADLINE 0 1 2").startswith("ERR deadline")
        assert _ask(port, "DEADLINE 5000 7") == "8"
        # TRACE propagation: the caller's fleet-wide id becomes the
        # request id (the flight-record / trace-surface key); malformed
        # ids are a protocol violation, composable with DEADLINE
        assert _ask(port, "TRACE req-a 1 2") == "2 3"
        assert fe.flight.get("req-a")["outcome"] == "served"
        assert _ask(port, "TRACE req-b DEADLINE 5000 3") == "4"
        assert fe.flight.get("req-b") is not None
        assert _ask(port, "TRACE %s 1"
                    % ("x" * (TRACE_ID_MAX + 1))).startswith("ERR proto")
        assert _ask(port, "TRACE bad/id 1").startswith("ERR proto trace")
        # backend supervision: failures answered, loop survives
        boom["on"] = True
        assert _ask(port, "5").startswith("ERR backend")
        assert _ask(port, "5").startswith("ERR backend")
        # 2 consecutive failures: breaker open, sheds instantly
        assert fe.breaker.state == "open"
        assert _ask(port, "5").startswith("ERR busy")
        assert fe.health_probe()[0] is False
        # cooldown elapses, backend healed: half-open probe closes it
        boom["on"] = False
        time.sleep(0.35)
        assert _ask(port, "5") == "6"
        assert fe.breaker.state == "closed" and fe.health_probe()[0]
        # hot reload between requests
        assert _ask(port, "ADMIN reload").startswith("OK")
        assert _ask(port, "9") == "10"
        assert reloads, "reload_fn never ran"
        assert _ask(port, "ADMIN stats").startswith("OK accepted=")
        assert _ask(port, "ADMIN bogus").startswith("ERR parse")
        # request tracing: every dequeued request left a flight record
        # whose phases tile its wall-clock (the /trace?request= source);
        # token 42 makes this one slow enough for robust coverage math
        assert _ask(port, "42") == "43"
        recs = fe.flight.list()
        assert recs, "flight recorder empty after served requests"
        rec = next(r for r in recs if r["outcome"] == "served")
        assert set(rec["phases"]) == set(telemetry.REQUEST_PHASES)
        # coverage is judged against the independently measured
        # accept->observe wall-clock, NOT the phase sum (total_s is the
        # sum by construction — checking against it proves nothing)
        cover = sum(rec["phases"].values())
        assert rec["wall_s"] > 0 and cover >= 0.95 * rec["wall_s"], \
            "phases cover %.0f%% of the request wall-clock" \
            % (100 * cover / rec["wall_s"])
        assert rec["ttft_s"] is not None \
            and rec["ttft_s"] <= rec["total_s"] + 1e-9
        assert fe.flight.get(rec["id"])["id"] == rec["id"]
        ct = telemetry.request_chrome_trace(rec)
        assert any(t.get("name") == "prefill"
                   for t in ct["traceEvents"])
        # outcomes attributed: the exploded requests are in the ring too
        assert any(r["outcome"] == "backend_error" for r in recs)
    finally:
        stats = fe.drain()
    assert stats["accepted"] == (stats["served"] + stats["errors"]
                                 + stats["shed"] + stats["deadline"]), \
        "serve counters do not reconcile: %r" % (stats,)
    assert stats["served"] == 7 and stats["shed"] == 1
    assert stats["deadline"] == 1 and stats["empty"] == 1
    assert fe.health_probe() == (False,
                                 "draining: not accepting new requests")
    assert fe.liveness_probe()[0]

    # SLO error budget: a healthy run keeps the burn gauge 0; a flood of
    # objective-violating requests flips it
    slo = statusd.SLOTracker(ttft_ms=30.0, availability=0.999,
                             min_requests=4, window_s=60.0)
    fe2 = ServeFrontend(lambda toks, seq: list(toks), slo=slo,
                        drain_ms=2000.0)
    fe2.start()
    port2 = fe2.listen(0)
    try:
        for _ in range(4):
            assert _ask(port2, "1 2") == "1 2"
        assert slo.snapshot()["alert"] == 0, "healthy run burned budget"

        def slow(toks, seq):
            time.sleep(0.05)             # >> the 30ms TTFT objective
            return list(toks)

        fe2.backend = slow
        for _ in range(4):
            _ask(port2, "3")
        snap = slo.snapshot()
        assert snap["alert"] == 1 and snap["burn_rate"] >= 1.0, snap
        assert snap["by_reason"].get("ttft", 0) >= 4, snap
    finally:
        fe2.drain()
    if verbose:
        print("servd selftest: admission/deadline/breaker/reload/drain + "
              "request tracing (phases/TTFT/flight recorder) + SLO burn "
              "flip ok (%r)" % (stats,))
    return 0


def _stub_main(argv: List[str]) -> int:
    """``--stub``: a standalone replica for the chaos harness —
    prints the bound port(s), serves until SIGTERM/SIGINT, drains, prints
    the final stats as JSON, exits 0; ``--status-port N`` also starts the
    status server (``servd-stub: status on port P``). Knobs: ``--port N``
    ``--delay-ms D``
    (slow backend) ``--explode-every N`` (every Nth dispatch raises)
    ``--queue N`` ``--drain-ms D`` ``--breaker-fails N`` ``--stall-s S``
    (wedged-backend probe bound).

    Fleet knobs: the backend answers ``tok +
    version`` where ``version`` starts at 1 and each ``ADMIN reload``
    bumps it (after sleeping ``--reload-ms`` — a stand-in for the decode
    recompile a real reload pays), so a rolling-reload test can SEE which
    model answered; SIGUSR1 wedges the backend (it blocks, heartbeats
    silent — the accept-but-never-answer failure mode from inside) until
    SIGUSR2 unwedges it."""
    import json
    import signal

    def flag(name, default, cast=float):
        if name in argv:
            return cast(argv[argv.index(name) + 1])
        return default

    delay = flag("--delay-ms", 0.0) / 1e3
    explode_every = int(flag("--explode-every", 0))
    reload_s = flag("--reload-ms", 0.0) / 1e3
    model = {"version": 1}
    wedge = {"on": False}

    def backend(toks, seq):
        while wedge["on"]:          # SIGUSR1: block until SIGUSR2
            time.sleep(0.05)
        if explode_every and (seq + 1) % explode_every == 0:
            raise RuntimeError("injected stub explosion")
        if delay:
            time.sleep(delay)
        return [t + model["version"] for t in toks]

    def reload_fn():
        if reload_s:
            time.sleep(reload_s)    # the recompile stand-in
        model["version"] += 1
        return True

    # batched decode mode (--batch-max N): the continuous-batching
    # dispatcher over an inline slot backend — same deterministic
    # answer law as the solo stub continued per token (first token =
    # last prompt token + version, then +1 per decode step), so a
    # kill-mid-decode chaos test can assert token-exact replays while
    # requests are genuinely ABOARD a decode batch when the SIGKILL
    # lands (--per-token-ms paces the steps to hold them there)
    batch_max = int(flag("--batch-max", 0))
    n_new = int(flag("--n-new", 8))
    per_token_s = flag("--per-token-ms", 0.0) / 1e3

    class _StubSession:
        def __init__(self, n):
            self.nslots = n
            self.closed = False
            self.lives: dict = {}

        def free_slots(self):
            return [s for s in range(self.nslots)
                    if s not in self.lives]

        def prefill(self, slot, toks, seq):
            while wedge["on"]:
                time.sleep(0.05)
            if self.closed:
                raise RuntimeError("session closed")
            first = (toks[-1] if toks else 0) + model["version"]
            if n_new <= 1:
                return first, True
            self.lives[slot] = {"next": first + 1,
                                "remaining": n_new - 1}
            return first, False

        def step(self):
            while wedge["on"]:
                time.sleep(0.05)
            if self.closed:
                raise RuntimeError("session closed")
            if per_token_s:
                time.sleep(per_token_s)
            out = []
            for slot, live in list(self.lives.items()):
                tok = live["next"]
                live["next"] += 1
                live["remaining"] -= 1
                done = live["remaining"] <= 0
                if done:
                    self.lives.pop(slot, None)
                out.append((slot, tok, done))
            return out

        def retire(self, slot):
            self.lives.pop(slot, None)

        def close(self):
            self.closed = True
            self.lives.clear()

    class _StubSlotBackend:
        buckets = (batch_max,) if batch_max > 0 else ()

        def session(self, b):
            return _StubSession(b)

    fe = ServeFrontend(backend, queue_size=int(flag("--queue", 64)),
                       drain_ms=flag("--drain-ms", 5000.0),
                       breaker_fails=int(flag("--breaker-fails", 5)),
                       stall_after_s=flag("--stall-s", 120.0),
                       reload_fn=reload_fn,
                       slot_backend=_StubSlotBackend()
                       if batch_max > 0 else None,
                       batch_max=batch_max,
                       # multi-tenant QoS knobs for the fleet chaos
                       # harness (same conf syntax as route_tenants)
                       tenants=flag("--tenants", "", cast=str),
                       tenant_default=flag("--tenant-default",
                                           "default", cast=str))
    # the wedge handlers install BEFORE the port banner: the banner is
    # the chaos harness's spawn synchronization point, and a SIGUSR1
    # sent right after it must wedge the backend — not kill the process
    # via the default action (a real race on fast machines: the fleet
    # wedge tests flaked exactly there)
    for signum, on in ((getattr(signal, "SIGUSR1", None), True),
                       (getattr(signal, "SIGUSR2", None), False)):
        if signum is not None:
            signal.signal(signum,
                          lambda s, f, _on=on: wedge.update(on=_on))
    fe.start()
    port = fe.listen(int(flag("--port", 0)))
    print("servd-stub: listening on port %d" % port, flush=True)
    status_port = int(flag("--status-port", -1))
    if status_port >= 0:
        # the status sidecar a real task = serve replica runs: /healthz
        # readiness and the /metrics gauges
        telemetry.enable()          # in memory: /metrics reads it
        srv = statusd.start(status_port)
        statusd.register_probe("serving", fe.health_probe)
        statusd.register_probe("serving.worker", fe.liveness_probe,
                               liveness=True)
        statusd.set_flight_recorder(fe.flight)
        print("servd-stub: status on port %d" % srv.port, flush=True)
    with ckpt.PreemptionGuard(enabled=True) as guard:
        while not guard.requested:
            time.sleep(0.05)
    stats = fe.drain()
    if status_port >= 0:
        statusd.stop()
    print("servd-stub: drained " + json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    if "--selftest" in sys.argv[1:]:
        sys.exit(selftest(verbose=True))
    if "--stub" in sys.argv[1:]:
        sys.exit(_stub_main(sys.argv[1:]))
    print(__doc__)
    sys.exit(1)
