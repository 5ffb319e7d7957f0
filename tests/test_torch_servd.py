"""The port's serving frontend (cxxnet_tpu_torch/utils/servd.py) on the CPU,
against the JAX package's: the scenarios of tests/test_servd.py, each run
against the port's ``ServeFrontend`` (protocol,
rejections, deadlines, breaker, drain, batching, tenants, paged-KV
exhaustion and requeue, convoy, autopsy, selftest, the status pages, and
the report tool's sections through its twin in the port,
``cxxnet_tpu_torch.tools.telemetry_report``); a differential run of one scripted, timing-free traffic through
both frontends over the same deterministic backends, whose response lines
and ``ADMIN stats`` counters must be equal; the selftests of the port's
lockrank and servd under ``CXXNET_LOCKRANK=1`` in a subprocess; and the
port-only contracts (the port's ``KVPoolExhausted`` requeues, a dead worker
fails liveness without hanging drain).

A JAX scenario runs against the port by swapping the globals of the JAX
test module that name the frontend's modules (``servd``, ``statusd``,
``telemetry``), the report tool and the fault injector for the port's, for
the length of the case; the scenario that imports the health module
(``from cxxnet_tpu.utils import health``) gets the port's watchdog through
the package attribute. The fault injector's fake slot backend is copied here, on the port's
allocator: tests/faultinject.py's raises the JAX package's
``KVPoolExhausted``, which the port's frontend must not (and does not)
catch. Everything runs with ``CXXNET_LOCKRANK=1``, and every socket has its
own timeout.
"""

import inspect
import os
import subprocess
import sys
import time
import types

import pytest

import cxxnet_tpu.utils as jutils
from cxxnet_tpu.utils import kvblocks as jkvblocks
from cxxnet_tpu.utils import servd as jservd
from cxxnet_tpu_torch.tools import telemetry_report
from cxxnet_tpu_torch.utils import checkpoint as ckpt
from cxxnet_tpu_torch.utils import health
from cxxnet_tpu_torch.utils import kvblocks
from cxxnet_tpu_torch.utils import servd
from cxxnet_tpu_torch.utils import statusd
from cxxnet_tpu_torch.utils import telemetry
from cxxnet_tpu_torch.utils.kvblocks import KVPoolExhausted

from . import faultinject as jfaultinject
from . import test_servd as jtests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _lockrank_on(monkeypatch):
    monkeypatch.setenv("CXXNET_LOCKRANK", "1")


@pytest.fixture()
def make_frontend():
    """Started (and listening) port frontends, drained at teardown."""
    made = []

    def make(backend=jtests.echo, listen=True, **kw):
        kw.setdefault("drain_ms", 2000.0)
        fe = servd.ServeFrontend(backend, **kw)
        fe.start()
        if listen:
            fe.listen(0)
        made.append(fe)
        return fe

    yield make
    for fe in made:
        fe.drain(timeout_ms=2000)


# ----------------------------------------------------------------------
# the fault injector of the port: tests/faultinject.py's backends, the
# clients over the port's servd, and a copy of its fake slot backend on
# the port's allocator, telemetry and KVPoolExhausted
def phased_backend(base, prefill_s: float, per_token_s: float):
    """tests/faultinject.py's ``phased_backend`` marking ``first_token``
    on the port's telemetry."""

    def backend(toks, seq):
        time.sleep(prefill_s)
        telemetry.mark("first_token")
        out = list(base(toks, seq))
        for _ in range(max(0, len(out) - 1)):
            time.sleep(per_token_s)
        return out

    return backend


def serve_request(port: int, line: str, timeout: float = 5.0):
    """One request line to the port's frontend, its response line (None
    if the connection closed unanswered)."""
    resp = servd._ask(port, line, timeout=timeout)
    return resp if resp else None


def serve_flood(port: int, lines, timeout: float = 10.0):
    """Concurrent one-request clients of the port's frontend."""
    import threading

    out = [None] * len(lines)

    def one(i):
        try:
            out[i] = serve_request(port, lines[i], timeout=timeout)
        except OSError:
            out[i] = None

    ts = [threading.Thread(target=one, args=(i,))
          for i in range(len(lines))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


def slot_backend(buckets=(1, 2, 4), n_new: int = 4,
                 prefill_s: float = 0.0, per_token_s: float = 0.0,
                 long_for=None, long_n_new: int = 0,
                 step_delays=None, explode_on_iterations=(),
                 explode_prefill_for=(), reject_for=(),
                 max_prompt: int = 0, l_max: int = 64,
                 kv_row_bytes: int = 1024,
                 kv_pool_blocks: int = 0, kv_block_tokens: int = 4,
                 kv_gate: bool = True, kv_retained_frac: float = 0.0,
                 kv_evict_storm: int = 0, kv_revive_race: bool = False,
                 compile_ms: float = 0.0):
    """Fake slot backend for servd's batching dispatcher (the port's copy
    of tests/faultinject.py's) — the fake twin of
    ``Trainer.decode_session`` (same duck interface: ``buckets``,
    ``session(bucket)``; a session has ``prefill``/``step``/``retire``/
    ``free_slots``/``close``). Deterministic token math so tests verify
    responses exactly: a request whose first token is ``t`` answers
    ``t+1, t+2, ..., t+n`` (``n = n_new``, or ``long_n_new`` when ``t``
    is in ``long_for`` — the STRAGGLER knob: wedge ONE sequence in a
    batch with a long tail and prove the others retire on time and new
    requests join mid-decode).

    Phase emulation (the TTFT split, like ``phased_backend``): prefill
    sleeps ``prefill_s`` then marks ``first_token``; each iteration
    sleeps ``per_token_s`` plus any active slot's ``step_delays`` entry
    (keyed by first token — the per-slot token-delay chaos knob).
    ``explode_on_iterations`` makes those (1-based, per-session)
    iterations raise — the whole-batch backend-failure case — and
    ``explode_prefill_for`` (first tokens) makes a request's PREFILL
    raise and CLOSE the session, mirroring the DecodeSession contract
    (a failed prefill's device state integrity is unknown), while
    ``reject_for`` raises WITHOUT closing — the pre-dispatch
    validation failure the breaker must ignore.
    ``max_prompt > 0`` arms the ``admits`` compatibility check.

    ``compile_ms > 0`` arms the COMPILE-CLIFF twin: the first time a
    program shape is seen (per-plen prefill, per-bucket admit/step —
    the backend-wide ``compiled`` set plays the jit cache, shared
    across sessions like the real one) the call sleeps ``compile_ms``
    and replays JitWatch's cache-growth sequence —
    ``telemetry.record_compile`` (trace-context / compile-window
    attribution) then the supervised perf-ledger ``compile_hook``
    (compile ring + warm-grid account) — with the trainer's real key
    shapes (``("sess_prefill", plen, 0.0, 0)`` etc., temperature 0 /
    top_k 0) so ``Trainer.expected_decode_grid``-shaped warm grids
    match. The stall-attribution and readiness suites stay jax-free
    and deterministic.

    ``kv_pool_blocks > 0`` arms the PAGED-KV twin: a REAL
    ``utils.kvblocks.BlockAllocator`` (that module is jax-free — the
    fake fakes the device, not the allocator) of that many usable
    blocks x ``kv_block_tokens`` rows backs admission, prefill raises
    ``KVPoolExhausted`` when the free list cannot cover a request, a
    retired slot frees its blocks mid-decode, and the backend exposes
    the production gate/account hooks (``kv_free_blocks`` /
    ``kv_fresh_blocks`` / ``kv_pool_account`` / ``kv_shed_retained``).
    ``kv_gate=False`` disarms the gather-budget hooks (they return
    None) so the dispatcher's KVPoolExhausted REQUEUE path is what
    gets exercised.

    ``kv_retained_frac`` arms the RETAINED-cache twin (the
    never-OOM governance; production pools default 1.0 but the twin
    defaults 0.0 so the deferral-semantics suites keep exercising the
    free-instantly contract): retired conversations park in the
    allocator's retained pool and fund later admissions by eviction.
    Two chaos knobs stress the governance itself — ``kv_evict_storm=N``
    force-drains the ENTIRE retained pool before every Nth prefill (an
    eviction storm landing between a gather-time match and the
    admission that hoped to revive it), and ``kv_revive_race=True``
    evicts the LRU retained leaf before EVERY admission (the
    revive-vs-evict race: the block a request is about to revive is
    exactly the eviction candidate). Under both, admissions must
    recompute instead of crash, books must reconcile
    (``alloc.check()``), and replies stay token-exact.

    Every session appends to the shared ``backend.journal``:
    ``("admit", slot, iteration, seq)`` / ``("retire", slot,
    iteration)`` — the mid-decode-join assertions read it.
    """

    class _Session:
        def __init__(self, owner, nslots):
            self.owner = owner
            self.nslots = int(nslots)
            self.iteration = 0
            self.closed = False  # the DecodeSession contract: a failed
            #                      prefill/step closes the session (its
            #                      device state integrity is unknown)
            self._live = {}     # slot -> {"next", "remaining", "first"}
            self._tickets = {}  # slot -> AdmitTicket (paged twin)

        def free_slots(self):
            return [s for s in range(self.nslots) if s not in self._live]

        def kv_account(self):
            # the DecodeSession KV/HBM account's fake twin: a fixed
            # bytes-per-cache-row geometry (kv_row_bytes x l_max per
            # slot) so the /batchz + cxxnet_decode_kv_* tests are
            # deterministic and jax-free
            ow = self.owner
            alloc = self.nslots * ow.l_max
            kv_bytes = 0 if self.closed else alloc * ow.kv_row_bytes
            live = sum(st["plen"] + st["produced"]
                       for st in self._live.values())
            return {"bucket": self.nslots, "l_max": ow.l_max,
                    "active": len(self._live), "kv_bytes": kv_bytes,
                    "kv_live_bytes": int(round(kv_bytes * live / alloc))
                    if alloc else 0,
                    "live_tokens": live, "alloc_tokens": alloc}

        def prefill(self, slot, toks, seq):
            ow = self.owner
            if self.closed:
                raise RuntimeError("slot session is closed")
            t0 = int(toks[0])
            if t0 in ow.reject_for:
                # pre-dispatch validation failure: raises WITHOUT
                # closing — a request defect, not a device fault
                raise ValueError("injected prefill rejection (%d)" % t0)
            if t0 in ow.explode_prefill_for:
                self.closed = True
                raise RuntimeError("injected prefill explosion (%d)"
                                   % t0)
            n = ow.long_n_new if t0 in ow.long_for else ow.n_new
            if ow.alloc is not None:
                # the paged-KV admission: every block reserved up
                # front or none (exhaustion defers BEFORE any "device"
                # work — the session stays open)
                ow.prefills += 1
                if ow.evict_storm and ow.prefills % ow.evict_storm == 0:
                    # eviction storm: the whole retained pool vanishes
                    # between the gather-time match and this admission
                    ow.alloc.evict_retained()
                if ow.revive_race:
                    # revive-vs-evict race: drop the LRU leaf — often
                    # the very block this admission hoped to revive
                    ow.alloc.evict_retained(1)
                ticket = ow.alloc.admit(toks, n)
                if ticket is None:
                    raise KVPoolExhausted(
                        "fake pool exhausted (%d free)"
                        % ow.alloc.free_blocks)
                ow.alloc.register(ticket, toks)
                self._tickets[slot] = ticket
            # the prefill-shaped cliffs fire under the caller's trace
            # context (servd holds the request tc here), like real jax
            ow._compile("jit.decode_prefill",
                        ("sess_prefill", len(toks), 0.0, 0))
            ow._compile("jit.decode_admit", ("sess_admit", self.nslots))
            if ow.prefill_s:
                time.sleep(ow.prefill_s)
            telemetry.mark("first_token")
            self._live[slot] = {"next": t0 + 2, "remaining": n - 1,
                                "first": t0, "plen": len(toks),
                                "produced": 0}
            ow.journal.append(("admit", slot, self.iteration, seq))
            return t0 + 1, n == 1

        def step(self):
            ow = self.owner
            if self.closed:
                raise RuntimeError("slot session is closed")
            self.iteration += 1
            if self.iteration in ow.explode_on:
                raise RuntimeError("injected step explosion (iteration "
                                   "%d)" % self.iteration)
            # the step-shaped cliff fires inside servd's step compile
            # window (batch-wide attribution), like real jax
            ow._compile("jit.decode_step", ("sess_step", self.nslots,
                                            0.0, 0))
            delay = ow.per_token_s + sum(
                ow.step_delays.get(st["first"], 0.0)
                for st in self._live.values())
            if delay:
                time.sleep(delay)
            out = []
            for slot, st in sorted(self._live.items()):
                if st["remaining"] <= 0:
                    continue
                tok = st["next"]
                st["next"] += 1
                st["remaining"] -= 1
                st["produced"] += 1
                out.append((slot, tok, st["remaining"] <= 0))
            return out

        def retire(self, slot):
            self._live.pop(slot, None)
            t = self._tickets.pop(slot, None)
            if t is not None:
                # mid-decode block reclaim: the free list grows NOW
                self.owner.alloc.free(t.ids)
            self.owner.journal.append(("retire", slot, self.iteration))

        def close(self):
            self._live.clear()
            for t in self._tickets.values():
                self.owner.alloc.free(t.ids)
            self._tickets.clear()
            self.closed = True      # releases its (fake) cache bytes:
            #                         kv_account reads 0 from here on
            self.owner.closed += 1

    class _Backend:
        def __init__(self):
            self.buckets = list(buckets)
            self.n_new = int(n_new)
            self.prefill_s = float(prefill_s)
            self.per_token_s = float(per_token_s)
            self.long_for = set(long_for or ())
            self.long_n_new = int(long_n_new or n_new)
            self.step_delays = dict(step_delays or {})
            self.explode_on = set(explode_on_iterations or ())
            self.explode_prefill_for = set(explode_prefill_for or ())
            self.reject_for = set(reject_for or ())
            self.l_max = int(l_max)
            self.kv_row_bytes = int(kv_row_bytes)
            self.journal = []
            self.sessions = []
            self.closed = 0
            self.compile_s = float(compile_ms) / 1e3
            self.compiled = set()  # the fake jit cache: first hit per
            #                        key pays the (simulated) cliff
            self.alloc = None
            self.prefills = 0
            self.evict_storm = int(kv_evict_storm)
            self.revive_race = bool(kv_revive_race)
            if kv_pool_blocks > 0:
                self.alloc = kvblocks.BlockAllocator(
                    kv_pool_blocks + 1, kv_block_tokens,
                    retained_frac=kv_retained_frac)

        def _compile(self, name, key):
            # first-hit compile cliff: sleep the stall, then replay
            # JitWatch's exact sequence — record_compile feeds any open
            # trace context / compile window, the supervised hook feeds
            # the perf ledger's ring + warm-grid account
            if not self.compile_s or key in self.compiled:
                return
            self.compiled.add(key)
            time.sleep(self.compile_s)
            telemetry.record_compile(name, "new_signature",
                                     self.compile_s, key=key)
            hook = getattr(telemetry._REG, "compile_hook", None)
            if hook is not None:
                try:
                    hook(name, "new_signature", self.compile_s,
                         fn=None, args=(), kwargs={}, key=key)
                except Exception:
                    pass

        # the production paged-KV hook surface (learn_task adapter
        # twin): servd's gather loop budgets queue pops against these;
        # None disarms (dense, or kv_gate=False to force the
        # KVPoolExhausted requeue path instead)
        def kv_free_blocks(self):
            if self.alloc is None or not kv_gate:
                return None
            # free + evictable-retained: the gather budget MUST see
            # retained blocks as headroom or requests defer forever
            # while reclaimable memory sits parked (the evict-before-
            # defer livelock)
            return self.alloc.available_blocks

        def kv_fresh_blocks(self, toks):
            if self.alloc is None or not kv_gate:
                return None
            t0 = int(toks[0])
            n = self.long_n_new if t0 in self.long_for else self.n_new
            return self.alloc.fresh_need(len(toks), n, toks)

        def kv_shed_retained(self, target_free):
            if self.alloc is None:
                return 0
            return self.alloc.evict_retained(target_free=target_free)

        def kv_pool_account(self):
            if self.alloc is None:
                return None
            a = self.alloc.account()
            a["pool_bytes"] = ((self.alloc.blocks)
                               * self.alloc.bs * self.kv_row_bytes)
            a["block_bytes"] = self.alloc.bs * self.kv_row_bytes
            return a

        def session(self, bucket):
            s = _Session(self, bucket)
            self.sessions.append(s)
            return s

        def admits(self, toks):
            if max_prompt and len(toks) > max_prompt:
                return ("prompt len %d exceeds the %d-token bound"
                        % (len(toks), max_prompt))
            return None

    return _Backend()


faultinject = types.SimpleNamespace(
    slow_backend=jfaultinject.slow_backend,
    exploding_backend=jfaultinject.exploding_backend,
    healing_backend=jfaultinject.healing_backend,
    disconnecting_client=jfaultinject.disconnecting_client,
    phased_backend=phased_backend, slot_backend=slot_backend,
    serve_request=serve_request, serve_flood=serve_flood)


class _PortSubprocess:
    """``subprocess`` as the JAX scenarios see it, with the stub server's
    module (``-m cxxnet_tpu.utils.servd``) swapped for the port's."""
    PIPE = subprocess.PIPE

    @staticmethod
    def Popen(args, **kw):
        args = ["cxxnet_tpu_torch.utils.servd"
                if a == "cxxnet_tpu.utils.servd" else a for a in args]
        return subprocess.Popen(args, **kw)


# the JAX scenarios that run against the port's frontend (those of the
# status HTTP server on the port's StatusServer, those of the report tool
# on its twin, that of the watchdog on the port's health module)
SCENARIOS = (
    "test_tcp_roundtrip_and_reconciliation",
    "test_pipelined_requests_one_connection",
    "test_pipelined_rejections_stay_in_request_order",
    "test_unterminated_final_line_is_served",
    "test_halfclosed_client_gets_slow_answer",
    "test_empty_and_parse_rejections",
    "test_admin_stats_and_unknown",
    "test_deadline_expires_in_queue_before_dispatch",
    "test_default_deadline_from_conf",
    "test_flood_sheds_and_every_request_answered",
    "test_err_busy_detail_tokens_queue_vs_breaker",
    "test_admin_stats_reports_live_load_gauges",
    "test_backend_exception_answered_and_survived",
    "test_backend_returning_garbage_is_a_backend_error",
    "test_breaker_opens_sheds_and_recovers",
    "test_breaker_halfopen_failure_doubles_cooldown",
    "test_client_disconnect_mid_request_survived",
    "test_admin_reload_between_requests_keeps_queue",
    "test_failing_reload_keeps_model_and_serving",
    "test_drain_answers_every_accepted_request",
    "test_drain_budget_exhausted_still_answers",
    "test_drain_leftovers_burn_slo_budget",
    "test_stalled_backend_fails_readiness_then_liveness",
    "test_drain_with_wedged_backend_answers_inflight_once",
    "test_sigterm_drain_loses_zero_accepted_requests",
    "test_sync_submit_keeps_request_order",
    "test_ttft_split_phase_attribution",
    "test_unmarked_backend_falls_back_to_all_prefill",
    "test_trace_context_tags_backend_telemetry",
    "test_request_ids_unique_and_deadline_attributed",
    "test_flight_recorder_eviction",
    "test_slo_burn_flips_on_slow_flood_not_on_healthy",
    "test_admission_sheds_burn_slo_budget",
    "test_batch_coalesce_flood_exact_and_occupancy",
    "test_batch_mid_decode_join_after_retire",
    "test_batch_deadline_retires_mid_decode_others_continue",
    "test_batch_drain_mid_batch_exactly_once",
    "test_batch_step_failure_fails_whole_batch_then_recovers",
    "test_batch_prefill_failure_closes_session_and_evicts",
    "test_batch_prefill_failure_counts_one_breaker_failure",
    "test_batch_prefill_rejection_never_feeds_breaker",
    "test_batch_fresh_batch_occupancy_stamped_batchwide",
    "test_batch_free_slots_load_signal_in_admin_stats",
    "test_batch_reload_waits_for_inflight_batch",
    "test_batch_admits_check_answers_err_backend",
    "test_batch_iteration_flight_ring",
    "test_batch_flight_records_scheduling_coordinates",
    "test_trace_request_merges_slot_gantt_lanes",
    "test_admin_stats_batch_buckets",
    "test_convoy_chaos_straggler_pins_bucket",
    "test_batch_snapshot_kv_live_tracks_decode_progress",
    "test_tenant_prefix_parse_validation_and_compat",
    "test_tenant_fair_share_shed_and_eviction",
    "test_tenant_weighted_fair_scheduling_order",
    "test_tenant_slo_isolation",
    "test_servd_selftest",
    "test_paged_kv_exhaustion_deterministic_queue_wait",
    "test_paged_kv_exhaustion_requeue_path",
    "test_paged_kv_tenant_fair_queue_gate_and_requeue",
    "test_retained_kv_exhaustion_chaos_flood",
    "test_retained_eviction_storm_and_revive_race",
    "test_evict_before_defer_admission",
    "test_kv_pressure_latch_sheds_retained",
    "test_autopsy_warm_flood_zero_compile_stall",
    "test_healthz_flips_on_breaker_and_recovers",
    "test_healthz_flips_during_drain_livez_stays",
    "test_watchdog_worker_channel_pauses_when_idle",
    "test_serve_metrics_reach_prometheus",
    "test_request_tracing_end_to_end",
    "test_batch_occupancy_metrics_honest_weighted_mean",
    "test_batchz_endpoint_kv_account_and_decode_metrics",
    "test_report_serving_section_and_rates",
    "test_report_serving_section_empty_latency_renders_na",
    "test_report_exit2_on_unresolved_breaker_open",
    "test_report_request_breakdown_and_slo_exit2",
    "test_report_batch_scheduler_section",
)


@pytest.fixture()
def status_server():
    """tests/test_servd.py's ``status_server`` on the port's registry and
    server."""
    reg = telemetry._Registry()
    reg.enable()
    srv = statusd.StatusServer(0, host="127.0.0.1", registry=reg).start()
    yield srv
    srv.stop()
    reg.disable()


@pytest.mark.parametrize("name", SCENARIOS)
def test_jax_servd_scenario_on_the_port(name, make_frontend, tmp_path,
                                        capsys, monkeypatch, status_server):
    for attr, mod in (("servd", servd), ("statusd", statusd),
                      ("telemetry", telemetry),
                      ("faultinject", faultinject),
                      ("subprocess", _PortSubprocess),
                      ("telemetry_report", telemetry_report)):
        monkeypatch.setattr(jtests, attr, mod)
    monkeypatch.setattr(jutils, "health", health)
    fn = getattr(jtests, name)
    given = {"make_frontend": make_frontend, "tmp_path": tmp_path,
             "capsys": capsys, "monkeypatch": monkeypatch,
             "status_server": status_server}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


# ----------------------------------------------------------------------
# one scripted traffic through both frontends
def _solo_backend(toks, seq):
    if toks[0] == 66:
        raise RuntimeError("injected backend failure on %d" % toks[0])
    return [t + 1 + seq % 3 for t in toks]


# sequential (each line answered before the next is sent), so the
# dispatch order and every counter are timing-free
TRAFFIC = (
    "1 2 3", "", "1 x 2", "1 999", "DEADLINE nope 1", "DEADLINE 5000 7",
    "DEADLINE -3 1", "TRACE req-a 4 5", "TRACE bad/id 1", "TRACE",
    "TENANT t1 3 4", "TENANT bad:id 1", "ADMIN stats", "ADMIN bogus",
    "66 1", "5 6 7 8", "21 22", "66 2", "66 3", "ADMIN stats", "9",
    "TRACE req-b TENANT t1 DEADLINE 5000 11 12", "ADMIN stats",
)
TENANT_TRAFFIC = TRAFFIC + ("TENANT paid 1 2", "TENANT free 3",
                            "TENANT other 4", "ADMIN stats")


def _drive(mod, backend, lines, **kw):
    fe = mod.ServeFrontend(backend, drain_ms=5000.0, vocab=100,
                           breaker_fails=100, **kw)
    fe.start()
    out = []
    try:
        for line in lines:
            got = []
            fe.submit(line, got.append, wait=True)
            out.append(got)
    finally:
        stats = fe.drain()
    return out, stats, [r["outcome"] for r in fe.flight.list()]


def _slot_pair(**kw):
    return (jfaultinject.slot_backend(**kw), slot_backend(**kw))


@pytest.mark.parametrize("mode", ["solo", "solo_tenants", "batched",
                                  "batched_tenants", "paged",
                                  "batched_faults"])
def test_same_traffic_same_lines_and_stats_as_jax(mode):
    """One scripted, timing-free traffic through the JAX package's
    ServeFrontend and the port's, over the same deterministic backend (a
    solo echo that fails on token 66, or the fake slot backend, dense,
    paged or with injected prefill faults): every response line, the
    final stats, the ``ADMIN stats`` lines and the flight records'
    outcomes are the same."""
    lines = TENANT_TRAFFIC if mode.endswith("tenants") else TRAFFIC
    kw = {"tenants": "free:1,paid:4"} if mode.endswith("tenants") else {}
    if mode.startswith("solo"):
        backends = (_solo_backend, _solo_backend)
    else:
        skw = dict(buckets=(1, 2, 4), n_new=3)
        if mode == "paged":
            skw.update(kv_pool_blocks=12, kv_block_tokens=2)
        if mode == "batched_faults":
            skw.update(explode_prefill_for={66}, reject_for={21})
        backends = _slot_pair(**skw)
        kw.update(slot_backend=None, batch_max=4)
    got = {}
    for name, mod, backend in (("jax", jservd, backends[0]),
                               ("port", servd, backends[1])):
        if "slot_backend" in kw:
            kw["slot_backend"] = backend
            backend = None
        got[name] = _drive(mod, backend, lines, **kw)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]
    assert all(len(r) == 1 for r in got["port"][0])
    assert sum(r[0].startswith("OK accepted=") for r in got["port"][0]) \
        == sum(line == "ADMIN stats" for line in lines)


# ----------------------------------------------------------------------
# the selftests, with lock-order enforcement on
@pytest.mark.parametrize("module", ["lockrank", "servd"])
def test_selftest_under_lockrank(module):
    env = dict(os.environ, CXXNET_LOCKRANK="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.utils." + module,
         "--selftest"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "selftest" in out.stdout and "ok" in out.stdout


# ----------------------------------------------------------------------
# port-only contracts
def test_frontend_catches_the_ports_pool_exhaustion():
    """servd's ``except kvblocks.KVPoolExhausted`` names the port's class,
    the one the port's allocator path raises (the trainer's paged
    admission and the fake slot backend here); the JAX package's class is
    another one, so a budget race raising it would be a backend error."""
    from cxxnet_tpu_torch.nnet import trainer as ttrainer
    assert servd.kvblocks.KVPoolExhausted is KVPoolExhausted
    assert ttrainer.KVPoolExhausted is KVPoolExhausted
    assert KVPoolExhausted is not jkvblocks.KVPoolExhausted


def test_jax_pool_exhaustion_would_be_a_backend_error(make_frontend):
    """The other side of the identity: a prefill raising an exception
    that is not the port's KVPoolExhausted (here the JAX package's)
    answers ERR backend instead of requeueing."""
    sb = slot_backend(buckets=(2,), n_new=2)
    real = sb.session

    def session(bucket):
        s = real(bucket)

        def prefill(slot, toks, seq):
            raise jkvblocks.KVPoolExhausted("the JAX package's class")

        s.prefill = prefill
        return s

    sb.session = session
    fe = make_frontend(None, slot_backend=sb, batch_max=2)
    assert serve_request(fe.port, "1 2").startswith("ERR backend")


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_worker_fails_liveness_and_drain_returns(make_frontend):
    """A worker thread killed by a device error raised where the
    dispatcher does not supervise (here the session's free-slot books,
    read between decode iterations) fails the liveness probe, and drain
    answers every accepted request, the one aboard the dead batch
    included, within its budget instead of hanging."""
    sb = slot_backend(buckets=(2,), n_new=3, per_token_s=0.01)
    real = sb.session

    def session(bucket):
        s = real(bucket)
        calls = {"n": 0}
        free = s.free_slots

        def free_slots():
            calls["n"] += 1
            if calls["n"] > 1:
                raise RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered")
            return free()

        s.free_slots = free_slots
        return s

    sb.session = session
    fe = make_frontend(None, slot_backend=sb, batch_max=2)
    done = fe.submit("1 2", lambda t: None)
    deadline = time.monotonic() + 10.0
    while fe.liveness_probe()[0] and time.monotonic() < deadline:
        time.sleep(0.01)
    ok, detail = fe.liveness_probe()
    assert not ok and "died" in detail
    replies = []
    fe.submit("3 4", replies.append)
    t0 = time.monotonic()
    stats = fe.drain(timeout_ms=300)
    assert time.monotonic() - t0 < 5.0
    assert done.is_set() and replies and replies[0].startswith("ERR")
    assert jtests.reconciles(stats) and stats["accepted"] == 2


def test_stub_status_port_answers_healthz():
    """The stub's ``--status-port 0`` starts the status server beside the
    frontend: /healthz answers 200 while it serves, and a SIGTERM drains
    and exits 0."""
    import signal
    from urllib.request import urlopen
    proc = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch.utils.servd", "--stub",
         "--status-port", "0"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ports = {}
        deadline = time.monotonic() + 60
        while len(ports) < 2 and time.monotonic() < deadline:
            ln = proc.stdout.readline()
            if not ln:
                break
            for key in ("listening", "status"):
                if ln.startswith("servd-stub: %s on port " % key):
                    ports[key] = int(ln.rsplit(" ", 1)[1])
        assert set(ports) == {"listening", "status"}, ports
        r = urlopen("http://127.0.0.1:%d/healthz" % ports["status"],
                    timeout=5)
        assert (r.status, r.read()) == (200, b"ok\n")
        assert serve_request(ports["listening"], "1 2") == "2 3"
        m = urlopen("http://127.0.0.1:%d/metrics" % ports["status"],
                    timeout=5).read().decode()
        assert 'cxxnet_serve_requests_total{process="0"} 1' in m
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_preemption_guard_and_backoff_match_jax():
    from cxxnet_tpu.utils import checkpoint as jckpt
    for a in range(8):
        assert ckpt.backoff_delay(a, 0.3, 5.0) == \
            jckpt.backoff_delay(a, 0.3, 5.0)
    with ckpt.PreemptionGuard() as g:
        os.kill(os.getpid(), 15)
        for _ in range(100):
            if g.requested:
                break
            time.sleep(0.01)
    assert g.requested and g.signum == 15


def test_scan_checkpoints_matches_jax(tmp_path):
    from cxxnet_tpu.utils import checkpoint as jckpt
    for name in ("0003.model", "0010.model", "7.model", "x.model",
                 "0004.model.tmp", "emergency.model"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt.scan_checkpoints(str(tmp_path)) == \
        jckpt.scan_checkpoints(str(tmp_path))
    assert [c for c, _ in ckpt.scan_checkpoints(str(tmp_path))] == [3, 7, 10]
