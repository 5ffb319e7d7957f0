"""The learn task driver of the port: train / finetune / pred / pred_raw /
extract / generate / serve / route / export from a config file.

Counterpart of cxxnet_tpu/learn_task.py (the reference's
CXXNetLearnTask, src/cxxnet_main.cpp:16-478) for those nine tasks: the
same config keys, the same sectioned iterator chains (``data =`` /
``eval =`` / ``pred =`` ... ``iter = end``, other keys applied to every
chain), the same round loop and printed lines (progress on stdout, the
``[round]`` metric lines on stderr), checkpoint naming
(``<model_dir>/%04d.model``, counter checked before it is incremented, the
session's last round always saved) and pred / pred_raw / extract output
formats, the JAX package's ``task = generate`` (prompt lines in,
continuations out) and ``task = serve`` (the serving frontend,
``utils/servd.py``, over stdin and optionally TCP, solo or continuously
batched over decode sessions) and ``task = route`` (the fleet router,
``utils/routerd.py``, over ``task = serve`` replicas; it builds no net
and touches no card) and ``task = export`` (the inference forward as a
``torch.export`` program at ``export_out``). Model files are CRC-framed,
written atomically (tmp file, fsync, rename) with the training-state
section, as ``api.Net.save_model`` writes them, and either package loads
the other's.
``continue = 1`` resumes from the newest valid checkpoint of
``model_dir`` (the emergency file of a preempted run ranked by its
cursor, a corrupt file quarantined), mid-round and bit for bit; SIGTERM /
SIGINT during training writes that emergency file at the next step
boundary and exits cleanly; ``ckpt_keep_last`` / ``ckpt_keep_every`` set
the retention. ``health_monitor = 1`` checks every step's health vector
one step late and, on a non-finite step or a loss spike, rolls back to
the newest valid checkpoint and replays without the batch, the LR backed
off by ``rollback_backoff`` (``nonfinite_action = skip``: the step is
suppressed on the card instead; ``abort``: the run dies with a diagnostic
dump); ``watchdog_timeout`` starts the heartbeat watchdog
(``utils/health.py``) in train, serve and route. ``status_port`` serves
the live introspection pages (``utils/statusd.py``) for every task.
Whenever telemetry is on (``telemetry_log`` or ``status_port``),
``perf_ledger = 1`` (the default) cards every program the run's trainer
runs in the performance ledger
(``utils/perf.py``: ``/programz``, ``/compilez``, the ``cxxnet_program_*``
series); with the pages up, ``/profilez?secs=N`` captures a
``torch.profiler`` trace into ``profilez_dir``; ``profile_dir`` writes a
``torch.profiler`` Chrome trace of training round 2. A serving replica
declares its warm program grid with ``serve_plen_buckets`` (its health
reads ``warming`` below ``serve_warm_ready_pct``), and
``serve_kv_pool_frac`` caps the paged KV pool at that fraction of the
ledger's HBM headroom.

The net runs on the card unless the config or the command line says
``dev = cpu``; there, every threadbuffer of the chains packs its batches
into page-locked memory, which the trainer copies to the card
asynchronously.

Over several processes (cxxnet_tpu/learn_task.py:427-463, 895-899):
``coordinator`` (``host:port`` or an ``init_method`` URL), ``num_worker``
and ``worker_rank`` (or ``CXXNET_NUM_WORKER`` and ``CXXNET_WORKER_RANK`` /
``PS_RANK``) join every process into one world of ranks
(``parallel.multihost.init_distributed``); every rank runs the whole
config, serializes every model file (the gathers are collective), and rank
0 alone writes files. Telemetry takes the rank as its process index.
Emergency checkpoints are single-process, as in the JAX package. With
``dev = cpu:a-b`` or ``gpu:a-b`` and none of those keys, the command line
starts one process per listed device the machine has (``_local_launch``:
every id of a CPU list; the cards of a card list that exist, so
``gpu:0-3`` on a one-card machine is one process), the counterpart of the
JAX mesh over the listed devices.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from . import device as device_mod
from .io import create_iterator
from .nnet.trainer import Trainer, create_net
from .utils import checkpoint as ckpt
from .utils import health
from .utils import perf
from .utils import serializer
from .utils import statusd
from .utils import telemetry
from .utils.config import ConfigIterator
from .parallel import multihost
_TASKS = ("train", "finetune", "pred", "pred_raw", "extract", "generate",
          "serve", "route", "export")


class _SeededSession:
    """Maps the dispatcher's per-request dispatch ordinal onto the conf
    sampling seed (cxxnet_tpu/learn_task.py:30-66): ``seed = gen_seed +
    seq``, exactly what the solo backend passes to ``generate``, so a
    batched request's tokens equal its solo dispatch's. Every call runs
    on the trainer's card (``Trainer.on_device``): the dispatcher calls
    from its own thread, whose current device is thread-local."""

    def __init__(self, inner, seed0: int, bind):
        self._inner = inner
        self._seed0 = int(seed0)
        self._bind = bind
        self.nslots = inner.nslots

    @property
    def closed(self):
        return self._inner.closed

    def prefill(self, slot, toks, seq):
        with self._bind():
            return self._inner.prefill(slot, toks, self._seed0 + int(seq))

    def step(self):
        with self._bind():
            return self._inner.step()

    def retire(self, slot):
        with self._bind():
            self._inner.retire(slot)

    def free_slots(self):
        return self._inner.free_slots()

    def kv_account(self):
        return self._inner.kv_account()

    def close(self):
        with self._bind():
            self._inner.close()


class _SlotBackendAdapter:
    """Continuous-batching slot backend over ``Trainer.decode_session``
    (cxxnet_tpu/learn_task.py:69-170): what servd's batching dispatcher
    drives when ``serve_buckets`` is set. ``trainer()`` returns the trainer
    to serve, read at every call so that a hot reload's swapped-in trainer
    serves the next session (the dispatcher closes every session before a
    reload). Each session generates ``n_new`` tokens at ``temperature`` /
    ``top_k``, request ``seq`` drawing on ``seed + seq``. ``kv_block > 0``
    arms the paged KV cache: every session shares the trainer's block
    pool, sized at dense-equivalent capacity (the largest bucket times the
    net's sequence length) and, with the perf ledger on, clamped under
    ``kv_pool_frac`` of its live HBM headroom
    (``perf.Ledger.decode_pool_cap_bytes``; the pool floors the cap at one
    sequence of the net's length)."""

    def __init__(self, trainer, buckets, n_new: int,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 kv_block: int = 0, prefix_reuse: bool = True,
                 retained_frac: float = 1.0, kv_pool_frac: float = 0.5):
        self.trainer = trainer
        self.buckets = list(buckets)
        self.n_new = int(n_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.kv_block = int(kv_block)
        self.prefix_reuse = bool(prefix_reuse)
        self.retained_frac = float(retained_frac)
        self.kv_pool_frac = float(kv_pool_frac)

    def _l_max(self) -> int:
        return self.trainer().net_cfg.param.input_shape[2]

    def admits(self, toks):
        if len(toks) + self.n_new > self._l_max():
            return ("prompt len %d + gen_new %d exceeds the net's "
                    "sequence length %d" % (len(toks), self.n_new,
                                            self._l_max()))
        return None

    def _pool(self):
        """The shared paged pool (made at first use, made anew after a
        hot reload by ``decode_kv_pool``'s params-generation key). None
        in dense mode."""
        if self.kv_block <= 0:
            return None
        cap = perf.ledger().decode_pool_cap_bytes(self.kv_pool_frac) \
            if perf.enabled() else None
        return self.trainer().decode_kv_pool(
            self.kv_block, pool_tokens=max(self.buckets) * self._l_max(),
            prefix_reuse=self.prefix_reuse, bytes_cap=cap,
            retained_frac=self.retained_frac)

    def _live_pool(self):
        """The pool if it EXISTS and is open: the account and gate hooks
        never make one (they run at every publish, idle ones too)."""
        if self.kv_block <= 0:
            return None
        p = self.trainer()._kv_pool
        return None if p is None or p.closed else p

    def kv_pool_account(self):
        p = self._live_pool()
        return p.account() if p is not None else None

    def kv_free_blocks(self):
        """Admissible headroom for servd's gather budget (None disarms):
        free PLUS evictable retained blocks."""
        p = self._live_pool()
        return p.alloc.available_blocks if p is not None else None

    def kv_shed_retained(self, target_free):
        p = self._live_pool()
        if p is None:
            return 0
        return p.alloc.evict_retained(target_free=target_free)

    def kv_fresh_blocks(self, toks):
        """Blocks an admission would take off the free list right now
        (prefix-credited): servd pops a queued request only when this
        fits the budget."""
        p = self._live_pool()
        if p is None:
            return None
        return p.alloc.fresh_need(len(toks), self.n_new, toks)

    def session(self, bucket):
        tr = self.trainer()
        with tr.on_device():
            inner = tr.decode_session(
                bucket, self.n_new, temperature=self.temperature,
                top_k=self.top_k, kv_pool=self._pool())
        return _SeededSession(inner, self.seed, tr.on_device)


# the serve_* and slo_* keys, each read into the attribute of its name
_SERVE_KEYS = (
    ("serve_port", int), ("serve_host", str), ("serve_queue", int),
    ("serve_deadline_ms", float), ("serve_drain_ms", float),
    ("serve_breaker_fails", int), ("serve_breaker_cooldown_ms", float),
    ("serve_stall_s", float), ("serve_buckets", str),
    ("serve_batch_max", int), ("serve_batch_window_ms", float),
    ("serve_kv_block", int), ("serve_prefix_reuse", int),
    ("serve_retained_frac", float), ("serve_kv_pool_frac", float),
    ("serve_plen_buckets", str), ("serve_warm_ready_pct", float),
    ("serve_kv_pressure_pct", float),
    ("serve_kv_pressure_clear_pct", float),
    ("serve_batch_flight_cap", int), ("serve_convoy_iters", int),
    ("serve_flight_cap", int), ("serve_tenant_default", str),
    ("slo_ttft_ms", float), ("slo_p99_ms", float),
    ("slo_availability", float), ("slo_window_s", float),
)
# task = route (cxxnet_tpu/learn_task.py:362-419): the fleet router's keys
# with their defaults, read as the JAX command line reads them
# (route_tenants is shared with task = serve and kept apart)
_ROUTE_KEYS = (
    ("route_port", int, 0), ("route_host", str, ""),
    ("route_replicas", str, ""), ("route_probe_ms", float, 200.0),
    ("route_retries", int, 2), ("route_stall_s", float, 30.0),
    ("route_flight_cap", int, 256), ("route_standby_replicas", str, ""),
    ("route_scale_min", int, 0), ("route_scale_max", int, 0),
    ("route_scale_up_burn", float, 1.0),
    ("route_scale_down_idle_s", float, 30.0),
    ("route_scale_cooldown_s", float, 10.0), ("route_replay", int, 1),
    ("route_hedge_ms", float, 0.0), ("route_hedge_max_pct", float, 10.0),
    ("fleet_federate_ms", float, 1000.0),
    ("fleet_outlier_ratio", float, 3.0), ("fleet_outlier_min_n", int, 20),
)


class LearnTask:
    def __init__(self):
        self.task = "train"
        self.net_type = 0
        self.reset_net_type = -1
        self.net_trainer: Optional[Trainer] = None
        self.itr_train = None
        self.itr_pred = None
        self.itr_evals = []
        self.eval_names: List[str] = []
        self.name_model_dir = "models"
        self.num_round = 10
        self.test_io = 0
        self.silent = 0
        self.start_counter = 0
        self.max_round = 1 << 31
        self.save_period = 1
        self.continue_training = 0
        # checkpoint robustness: retention (ckpt_keep_last = N keeps the
        # newest N numbered files, ckpt_keep_every = K also every K-th; 0
        # keeps all), IO retries with backoff, durable fsync (0 trades
        # durability for speed) and the SIGTERM / SIGINT emergency
        # checkpoint (preempt_save = 0: die on the signal)
        self.ckpt_keep_last = 0
        self.ckpt_keep_every = 0
        self.ckpt_retries = 2
        self.ckpt_fsync = 1
        self.preempt_save = 1
        # training health (utils/health.py): health_monitor = 1 checks
        # every step's health vector one step late; an anomaly rolls back
        # to the newest valid checkpoint and replays with the batch
        # quarantined (nonfinite_action = rollback), is suppressed on the
        # device (skip) or ends the run with a diagnostic dump (abort, or
        # retries exhausted); watchdog_timeout > 0 starts a thread that
        # dumps every stack when a heartbeat channel goes silent
        self.health_monitor = 0
        self.nonfinite_action = "rollback"
        self.loss_spike_factor = 0.0     # 0: spike detection off
        self.loss_spike_warmup = 20
        self.rollback_backoff = 1.0      # LR scale per rollback (1: off)
        self.rollback_max_retries = 2
        self.watchdog_timeout = 0.0      # seconds; 0: no watchdog
        self.watchdog_action = "warn"
        self._health: Optional[health.HealthMonitor] = None
        self._recovery: Optional[health.RecoveryPolicy] = None
        # the resume cursor _sync_latest_model found: the training state to
        # apply before the first update, and the batches of the resumed
        # round already trained
        self._resume_state = None
        self._resume_batches = 0
        self._preempt: Optional[ckpt.PreemptionGuard] = None
        self._preempt_noted = False
        self._stop_training = False
        self._start_counter_conf = False
        self.name_model_in = "NULL"
        self.name_pred = "pred.txt"
        self.print_step = 100
        self.extract_node_name = ""
        self.output_format = 1
        # task = export: the artifact's path and batch (0: batch_size; -1:
        # a symbolic batch)
        self.name_export = "model.stablehlo"
        self.export_batch = 0
        # telemetry_log = <path>: the JSONL run log (utils/telemetry.py),
        # with a Chrome trace beside it and a summary table at the end
        self.telemetry_log = ""
        # status_port = <p>: the live introspection pages (utils/statusd.py)
        # on port p (0: an ephemeral port, printed; -1: off), on loopback
        # unless status_host widens the bind
        self.status_port = -1
        self.status_host = ""
        self._status_telemetry = False
        # perf_ledger = 1 (the default): the program performance ledger
        # (utils/perf.py) whenever telemetry is on; profilez_dir: where
        # /profilez captures land ("profilez" beside the telemetry log by
        # default); profile_dir: a torch.profiler trace of round 2
        self.perf_ledger = 1
        self.profilez_dir = ""
        self.profile_dir = ""
        self._perf_enabled = False
        # task = serve (cxxnet_tpu/learn_task.py:274-419): the frontend's
        # keys, read as the JAX command line reads them
        self.serve_port = -1
        self.serve_host = ""
        self.serve_queue = 64
        self.serve_deadline_ms = 0.0
        self.serve_drain_ms = 5000.0
        self.serve_breaker_fails = 5
        self.serve_breaker_cooldown_ms = 1000.0
        self.serve_stall_s = 120.0
        self.serve_buckets = ""
        self.serve_batch_max = 8
        self.serve_batch_window_ms = 2.0
        self.serve_kv_block = 0
        self.serve_prefix_reuse = 1
        self.serve_retained_frac = 1.0
        # the paged pool's cap: this fraction of the ledger's HBM headroom
        self.serve_kv_pool_frac = 0.5
        # the warm grid: prompt-length buckets declared for readiness, and
        # the ready share below which /healthz reads "warming" (0: off)
        self.serve_plen_buckets = ""
        self.serve_warm_ready_pct = 0.0
        self.serve_kv_pressure_pct = 10.0
        self.serve_kv_pressure_clear_pct = 25.0
        self.serve_batch_flight_cap = 256
        self.serve_convoy_iters = 64
        self.serve_flight_cap = 256
        self.serve_tenant_default = "default"
        self.route_tenants = ""
        self.slo_ttft_ms = 0.0
        self.slo_p99_ms = 0.0
        self.slo_availability = 0.999
        self.slo_window_s = 300.0
        for key, _, default in _ROUTE_KEYS:
            setattr(self, key, default)
        # task = generate (cxxnet_tpu/learn_task.py:272-273, 420-423)
        self.name_prompt_in = "prompts.txt"
        self.name_gen_out = "gen.txt"
        self.gen_new = 16
        self.gen_temperature = 0.0
        self.gen_topk = 0
        self.gen_seed = 0
        self.device = "gpu"
        # the world of processes (cxxnet_tpu/learn_task.py:425-433):
        # coordinator / num_worker / worker_rank, defaulting from the
        # environment in multihost.init_distributed
        self.coordinator = ""
        self.num_worker = 0
        self.worker_rank = -1
        self.cfg: List[Tuple[str, str]] = [("dev", "gpu")]

    def run(self, argv: List[str]) -> int:
        if len(argv) < 1:
            print("Usage: <config>")
            return 0
        for name, val in ConfigIterator(argv[0], argv[1:]):
            self.set_param(name, val)
        n_local = self._local_ranks()
        if n_local > 1:
            return self._local_launch(argv, n_local)
        pidx = None
        if self.coordinator or self.num_worker > 1:
            multihost.init_distributed(
                coordinator_address=self.coordinator or None,
                num_processes=self.num_worker or None,
                process_id=self.worker_rank if self.worker_rank >= 0
                else None,
                dev=self.device)
            pidx = multihost.worker_shard_params()[1]
        if self.telemetry_log:
            telemetry.enable(self.telemetry_log, process_index=pidx)
            telemetry.event({"ev": "run_meta", "task": self.task,
                             "dev": self.device})
        if self.status_port >= 0:
            self._start_status_server()
        if statusd.active() is not None:
            # /profilez rides statusd alone: on-demand profiling does not
            # depend on (and survives disabling) the ledger
            pdir = self.profilez_dir or os.path.join(
                os.path.dirname(self.telemetry_log) or ".", "profilez")
            statusd.set_profiler(perf.ProfilerCapture(pdir))
        if self.perf_ledger and telemetry.enabled():
            perf.enable()
            self._perf_enabled = True
            statusd.set_perf(perf.ledger())
        try:
            with telemetry.span("init"):
                # the router is a host process of the fleet layer: no
                # net, no iterators and no card; the replicas own the
                # models
                if self.task != "route":
                    self.init()
            if not self.silent:
                # serve's stdout carries exactly one response line per
                # request: startup chatter goes to stderr there
                print("initializing end, start working",
                      file=sys.stderr if self.task == "serve"
                      else sys.stdout)
            if self.task in ("train", "finetune"):
                self.task_train()
            elif self.task == "pred":
                self.task_predict()
            elif self.task == "pred_raw":
                self.task_predict_raw()
            elif self.task == "extract":
                self.task_extract_feature()
            elif self.task == "generate":
                self.task_generate()
            elif self.task == "serve":
                self.task_serve()
            elif self.task == "route":
                self.task_route()
            elif self.task == "export":
                self.task_export()
        finally:
            self.close()
            if self._perf_enabled:
                perf.drain(10.0)
                perf.disable()
                self._perf_enabled = False
            srv = statusd.active()
            if srv is not None and srv.profiler is not None:
                # an in-flight /profilez capture is stopped and joined
                # before teardown
                srv.profiler.shutdown()
            if self.status_port >= 0:
                statusd.stop()
            if self.telemetry_log:
                summary = telemetry.finish(close=True)
                if summary and not self.silent:
                    self._print_telemetry_summary(summary)
            elif self._status_telemetry:
                telemetry.disable()
                self._status_telemetry = False
            if pidx is not None:
                # the world this run joined, left before the interpreter
                # exits: a process group torn down at exit can abort on
                # its transport threads
                multihost.leave_distributed()
        return 0

    def _local_ranks(self) -> int:
        """How many local processes ``dev`` asks for when no world is
        given: the ids of a ``cpu:`` list, the ids of a card list that the
        machine has; 1 otherwise (and inside a world)."""
        if self.coordinator or self.num_worker > 0 \
                or os.environ.get("CXXNET_NUM_WORKER"):
            return 1
        kind, ids = device_mod.parse_device_spec(self.device)
        if len(ids) <= 1:
            return 1
        if kind == "cpu":
            return len(ids)
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return max(1, len([i for i in ids if i < have]))

    def _local_launch(self, argv: List[str], n: int) -> int:
        """One process of this config per rank on this host, joined at a
        ``file://`` rendezvous in a temporary directory of its own (a free
        port found here and bound later by rank 0 can be taken by another
        process in between), each writing to this process's standard
        output and error; returns 0 when every rank does. When one rank
        exits non-zero the others are killed (they would wait in a
        collective for it) and its code is returned, as torchrun does."""
        import shutil
        import subprocess
        import tempfile
        rdv = tempfile.mkdtemp(prefix="cxxnet_rdv_")
        entry = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bin", "cxxnet_torch")
        procs = [subprocess.Popen(
            [sys.executable, entry] + list(argv)
            + ["coordinator=file://" + os.path.join(rdv, "store"),
               "num_worker=%d" % n, "worker_rank=%d" % r],
            env=dict(os.environ, LOCAL_RANK=str(r)))
            for r in range(n)]
        try:
            while True:
                rcs = [p.poll() for p in procs]
                failed = next((rc for rc in rcs if rc), None)
                if failed is not None:
                    return failed
                if all(rc == 0 for rc in rcs):
                    return 0
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(rdv, ignore_errors=True)

    def _output(self, path: str, mode: str):
        """``path`` opened for writing on the writer rank; the null device
        on the others (every rank computes the rows: the gathers are
        collective)."""
        return open(path if self._is_writer() else os.devnull, mode)

    def _quarantine(self, path: str, reason: str) -> None:
        """A corrupt checkpoint moved aside, by the writer rank alone (the
        others skip it as it does)."""
        if self._is_writer():
            ckpt.quarantine(path, reason=reason)

    def _is_writer(self) -> bool:
        """Every rank serializes (the gathers are collective), rank 0
        alone touches the filesystem."""
        return multihost.worker_shard_params()[1] == 0

    def _start_status_server(self) -> None:
        """Bind the status pages (cxxnet_tpu/learn_task.py:459-488). They
        read the telemetry registry, which runs in memory when no log was
        configured. A port that cannot be bound warns and the run goes on
        without the pages."""
        if not telemetry.enabled():
            telemetry.enable(
                process_index=multihost.worker_shard_params()[1])
            self._status_telemetry = True
        try:
            srv = statusd.start(self.status_port, host=self.status_host)
        except (OSError, OverflowError) as e:
            # socket.bind raises OverflowError for a port above 65535
            sys.stderr.write(
                "WARNING: statusd: cannot bind port %d (%s); live "
                "introspection disabled for this run\n"
                % (self.status_port, e))
            if self._status_telemetry:
                telemetry.disable()
                self._status_telemetry = False
            return
        statusd.set_run_info(task=self.task, dev=self.device,
                             config=list(self.cfg))
        if not self.silent:
            # stderr: task = serve's stdout is the response stream
            print("statusd: live introspection on port %d "
                  "(/metrics /healthz /livez /statusz /trace)" % srv.port,
                  file=sys.stderr, flush=True)

    @staticmethod
    def _print_telemetry_summary(summary: dict) -> None:
        """The end-of-run telemetry table: the top spans by total time,
        the compiles, the counters and the gauges."""
        spans = summary.get("spans", {})
        print("---- telemetry summary ----")
        if spans:
            print("%-18s %7s %10s %9s %9s %9s" %
                  ("span", "count", "total_s", "p50_ms", "p99_ms",
                   "max_ms"))
            for name, a in sorted(spans.items(),
                                  key=lambda kv: -kv[1]["total_s"])[:12]:
                print("%-18s %7d %10.3f %9.2f %9.2f %9.2f" %
                      (name, a["count"], a["total_s"], a["p50_ms"],
                       a["p99_ms"], a["max_ms"]))
        comp = summary.get("compiles", {})
        if comp.get("count"):
            print("compiles: %d (%.2fs) %s" %
                  (comp["count"], comp["total_s"],
                   " ".join("%s=%d" % kv
                            for kv in sorted(comp["by_cause"].items()))))
        for name, v in sorted(summary.get("counters", {}).items()):
            print("counter %-24s %s" % (name, v))
        for name, v in sorted(summary.get("gauges", {}).items()):
            print("gauge   %-24s %s" % (name, v))

    def close(self) -> None:
        """Stop the chains' loader threads and close their files."""
        for itr in [self.itr_train, self.itr_pred] + self.itr_evals:
            if itr is not None:
                itr.close()

    def set_param(self, name: str, val: str) -> None:
        if val == "default":
            return
        if name == "coordinator":
            self.coordinator = val
        if name == "num_worker":
            self.num_worker = int(val)
        if name == "worker_rank":
            self.worker_rank = int(val)
        if name == "task":
            if val not in _TASKS:
                raise ValueError("unknown task %s" % val)
            self.task = val
        if name == "net_type":
            self.net_type = int(val)
        if name == "reset_net_type":
            self.reset_net_type = int(val)
        if name == "print_step":
            self.print_step = int(val)
        if name == "continue":
            self.continue_training = int(val)
        if name == "save_model":
            self.save_period = int(val)
        if name == "start_counter":
            self.start_counter = int(val)
            self._start_counter_conf = True
        if name == "model_in":
            self.name_model_in = val
        if name == "model_dir":
            self.name_model_dir = val
        if name == "num_round":
            self.num_round = int(val)
        if name == "max_round":
            self.max_round = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "dev":
            self.device = val
        if name == "test_io":
            self.test_io = int(val)
        if name == "extract_node_name":
            self.extract_node_name = val
        if name == "export_out":
            self.name_export = val
        if name == "export_batch":
            self.export_batch = int(val)
        if name == "output_format":
            self.output_format = 1 if val == "txt" else 0
        if name == "prompt_in":
            self.name_prompt_in = val
        if name == "gen_out":
            self.name_gen_out = val
        if name == "gen_new":
            self.gen_new = int(val)
        if name == "gen_temperature":
            self.gen_temperature = float(val)
        if name == "gen_topk":
            self.gen_topk = int(val)
        if name == "gen_seed":
            self.gen_seed = int(val)
        if name == "telemetry_log":
            self.telemetry_log = val
        if name == "status_port":
            self.status_port = int(val)
        if name == "status_host":
            self.status_host = val
        if name == "ckpt_keep_last":
            self.ckpt_keep_last = int(val)
        if name == "ckpt_keep_every":
            self.ckpt_keep_every = int(val)
        if name == "ckpt_retries":
            self.ckpt_retries = int(val)
        if name == "ckpt_fsync":
            self.ckpt_fsync = int(val)
        if name == "preempt_save":
            self.preempt_save = int(val)
        if name == "health_monitor":
            self.health_monitor = int(val)
        if name == "nonfinite_action":
            self.nonfinite_action = val
        if name == "loss_spike_factor":
            self.loss_spike_factor = float(val)
        if name == "loss_spike_warmup":
            self.loss_spike_warmup = int(val)
        if name == "rollback_backoff":
            self.rollback_backoff = float(val)
        if name == "rollback_max_retries":
            self.rollback_max_retries = int(val)
        if name == "watchdog_timeout":
            self.watchdog_timeout = float(val)
        if name == "watchdog_action":
            self.watchdog_action = val
        if name == "route_tenants":
            self.route_tenants = val
        if name == "perf_ledger":
            self.perf_ledger = int(val)
        if name == "profilez_dir":
            self.profilez_dir = val
        if name == "profile_dir":
            self.profile_dir = val
        for key, cast in _SERVE_KEYS:
            if name == key:
                setattr(self, key, cast(val))
        for key, cast, _ in _ROUTE_KEYS:
            if name == key:
                setattr(self, key, cast(val))
        self.cfg.append((name, val))

    # ------------------------------------------------------------------
    def init(self) -> None:
        if self.task == "train" and self.continue_training:
            if self._sync_latest_model() == 0:
                raise RuntimeError(
                    "Init: Cannot find models for continue training. "
                    "Please specify it by model_in instead.")
            print("Init: Continue training from round %d" % self.start_counter)
            self._create_iterators()
            return
        self.continue_training = 0
        if self.name_model_in == "NULL":
            assert self.task == "train", "must specify model_in if not training"
            self.net_trainer = self._create_net()
            self.net_trainer.init_model()
        elif self.task == "finetune":
            self._copy_model()
        else:
            self._load_model()
        self._create_iterators()

    def _model_path(self, counter: int) -> str:
        return os.path.join(self.name_model_dir, "%04d.model" % counter)

    def _sync_latest_model(self) -> int:
        """Load the newest VALID checkpoint of model_dir
        (cxxnet_tpu/learn_task.py:772-855): every ``<counter>.model`` at or
        above start_counter (gaps fine) resumes at (counter + 1, batch 0);
        the emergency file of a preempted run is ranked by the cursor in
        its training-state section. Newest first, each candidate's CRC
        framing and a full parse are checked; a corrupt file is
        quarantined to ``<name>.corrupt`` and the next one tried, an
        unreadable one skipped. A file whose CRC verifies but that fails to
        load is a config mismatch, not corruption: that aborts loudly and
        quarantines nothing. Returns 1 with the trainer swapped in, or 0
        when nothing loads."""
        d = self.name_model_dir
        cands = [((c + 1, 0), p, None, None)
                 for c, p in ckpt.scan_checkpoints(d)
                 if c >= self.start_counter]
        epath = os.path.join(d, ckpt.EMERGENCY_NAME)
        if os.path.exists(epath):
            try:
                payload, fmt = ckpt.read_verified(
                    epath, retries=self.ckpt_retries)
                st = ckpt.peek_state(payload) or {}
                prog = (int(st.get("start_counter", 0)),
                        int(st.get("batches_done", 0)))
                if prog[0] > self.start_counter:
                    cands.append((prog, epath, payload, fmt))
            except ckpt.CheckpointCorruptError as e:
                self._quarantine(epath, str(e))
            except OSError as e:     # unreadable after the retries: skip
                sys.stderr.write(    # it, never quarantine it
                    "WARNING: cannot read %s (%s); skipping\n" % (epath, e))
        cands.sort(key=lambda t: t[0], reverse=True)
        for prog, path, payload, fmt in cands:
            try:
                if payload is None:
                    payload, fmt = ckpt.read_verified(
                        path, retries=self.ckpt_retries)
            except ckpt.CheckpointCorruptError as e:
                self._quarantine(path, str(e))
                continue
            except OSError as e:
                sys.stderr.write(
                    "WARNING: cannot read %s (%s); skipping\n" % (path, e))
                continue
            try:
                r = serializer.Reader(payload)
                self.net_type = r.read_int32()
                net = self._create_net()
                net.load_model(r)
                state = net.load_training_state(r)
            except Exception as e:
                if fmt == "v1":
                    # the CRC verified: the bytes are what the writer
                    # saved, so the net or updater config of this run does
                    # not match them
                    raise RuntimeError(
                        "checkpoint %s is intact (CRC verified) but "
                        "failed to load: %s — likely a net/updater config "
                        "mismatch with the current run; fix the config "
                        "(or remove the file) and retry" % (path, e)) \
                        from e
                # a legacy file has no framing: a failed parse IS the
                # corruption signal
                self._quarantine(path, str(e))
                continue
            self.net_trainer = net
            self.start_counter = prog[0]
            self._resume_state = state
            self._resume_batches = prog[1] if state is not None else 0
            telemetry.event({"ev": "ckpt_restore", "path": path,
                             "counter": prog[0] - 1,
                             "batches_done": self._resume_batches})
            if not self.silent and self._resume_batches:
                # stderr: a serve reload runs this scan too, and there
                # stdout is the response stream
                print("Init: resuming mid-round from %s (%d batches into "
                      "round %d)" % (path, self._resume_batches,
                                     prog[0] - 1), file=sys.stderr)
            return 1
        return 0

    def _read_model_file(self, path: str) -> serializer.Reader:
        """A model file's payload, its CRC framing verified (unframed
        legacy files pass through)."""
        payload, _ = ckpt.read_verified(path, retries=self.ckpt_retries)
        return serializer.Reader(payload)

    def _load_model(self) -> None:
        base = os.path.basename(self.name_model_in)
        try:
            self.start_counter = int(base.split(".")[0])
        except ValueError:
            # a guessed counter would mis-number every later checkpoint, so
            # training needs '<counter>.model' or start_counter; inference
            # tasks never use the counter
            if not self._start_counter_conf and self.task == "train":
                raise ValueError(
                    "Cannot infer start_counter from model name %r: "
                    "expected '<counter>.model' (the save_model naming, "
                    "e.g. 0042.model). Rename the file or set "
                    "start_counter=<n> in the config." % self.name_model_in
                ) from None
        r = self._read_model_file(self.name_model_in)
        self.net_type = r.read_int32()
        self.net_trainer = self._create_net()
        self.net_trainer.load_model(r)
        self.start_counter += 1

    def _copy_model(self) -> None:
        r = self._read_model_file(self.name_model_in)
        self.net_type = r.read_int32()
        self.net_trainer = self._create_net()
        self.net_trainer.copy_model_from(r)

    def _write_checkpoint(self, name: str, resume_counter: int,
                          batches_done: int) -> None:
        """net_type, model, optimizer state and the training-state section
        with the cursor (resume_counter, batches_done), written atomically
        with CRC framing and retries (cxxnet_tpu/learn_task.py:901-923).
        The cursor also carries the training chain's augmenter state when
        it has one (``iter_rng``): the crops and mirrors of the resumed
        round are then those of the uninterrupted run."""
        t0 = time.perf_counter()
        extra = {"start_counter": int(resume_counter),
                 "batches_done": int(batches_done)}
        if self.itr_train is not None:
            rng = self.itr_train.epoch_rng_state(batches_done > 0)
            if rng:
                extra["iter_rng"] = rng
        w = serializer.Writer()
        w.write_int32(self.net_type)
        self.net_trainer.save_model(w)
        self.net_trainer.save_training_state(w, extra=extra)
        if not self._is_writer():
            return
        payload = w.f.getbuffer()   # a view of the buffer, not a copy
        os.makedirs(self.name_model_dir, exist_ok=True)
        ckpt.write_checkpoint(name, payload, fsync=bool(self.ckpt_fsync),
                              retries=self.ckpt_retries)
        telemetry.event({"ev": "ckpt_save", "path": name,
                         "bytes": len(payload),
                         "counter": int(resume_counter) - 1,
                         "batches_done": int(batches_done),
                         "seconds": round(time.perf_counter() - t0, 6)})

    def _save_model(self, force: bool = False) -> bool:
        """Round-boundary checkpoint; returns whether a file was written.
        The counter is checked before the increment, and the session's
        last round saves whatever save_period says (``force``), as in the
        JAX package (cxxnet_tpu/learn_task.py:925-955). A numbered file
        supersedes the emergency file, which goes; then stale tmp files
        are collected and the retention applies."""
        counter = self.start_counter
        self.start_counter += 1
        if self.save_period == 0:
            return False
        if counter % self.save_period != 0 and not force:
            return False
        self._write_checkpoint(self._model_path(counter),
                               self.start_counter, 0)
        if not self._is_writer():
            return True
        epath = os.path.join(self.name_model_dir, ckpt.EMERGENCY_NAME)
        try:
            if os.path.exists(epath):
                os.remove(epath)
        except OSError:
            pass
        ckpt.gc_stale_tmp(self.name_model_dir)
        if self.ckpt_keep_last > 0:
            ckpt.apply_retention(self.name_model_dir,
                                 keep_last=self.ckpt_keep_last,
                                 keep_every=self.ckpt_keep_every)
        return True

    def _save_emergency(self, batches_done: int) -> None:
        """The preemption path's one mid-round checkpoint, at a step
        boundary: the full state with the iterator cursor, so that the
        resume re-enters this round and skips the trained batches."""
        name = os.path.join(self.name_model_dir, ckpt.EMERGENCY_NAME)
        with telemetry.span("checkpoint", kind="emergency"):
            self._write_checkpoint(name, self.start_counter, batches_done)
        if not self.silent:
            print("preemption: emergency checkpoint -> %s (round %d, "
                  "batch %d)" % (name, self.start_counter - 1,
                                 batches_done))

    def _preempt_requested(self) -> bool:
        if self._preempt is None or not self._preempt.requested:
            return False
        if not self._preempt_noted:
            # the signal handler only sets flags; the loop records the
            # event when it first sees them
            self._preempt_noted = True
            telemetry.event({"ev": "preempt_signal",
                             "signum": self._preempt.signum})
        return True

    @staticmethod
    def _iter_chain_stable(it) -> bool:
        """Whether every iterator of the chain replays the same epoch
        order after a restart (what an exact mid-round resume needs)."""
        while it is not None:
            if not getattr(it, "stable_epoch_order", True):
                return False
            it = getattr(it, "base", None)
        return True

    def _create_net(self) -> Trainer:
        if self.reset_net_type != -1:
            self.net_type = self.reset_net_type
        net = create_net(self.net_type)
        for k, v in self.cfg:
            net.set_param(k, v)
        return net

    def _create_iterators(self) -> None:
        """Sectioned iterator parsing (reference :214-264): data= / eval= /
        pred= blocks terminated by iter=end; keys outside blocks are
        defaults applied to every iterator."""
        flag = 0
        evname = ""
        itcfg: List[Tuple[str, str]] = []
        defcfg: List[Tuple[str, str]] = []
        for name, val in self.cfg:
            if name == "data":
                flag = 1
                continue
            if name == "eval":
                evname = val
                flag = 2
                continue
            if name == "pred":
                flag = 3
                self.name_pred = val
                continue
            if name == "iter" and val == "end":
                assert flag != 0, "wrong configuration file"
                if flag == 1 and self.task not in ("pred", "export",
                                                   "generate"):
                    assert self.itr_train is None, "can only have one data"
                    self.itr_train = create_iterator(itcfg)
                if flag == 2 and self.task not in ("pred", "export",
                                                   "generate"):
                    self.itr_evals.append(create_iterator(itcfg))
                    self.eval_names.append(evname)
                if flag == 3 and self.task in ("pred", "pred_raw", "extract"):
                    assert self.itr_pred is None, "can only have one data:test"
                    self.itr_pred = create_iterator(itcfg)
                flag = 0
                itcfg = []
                continue
            if flag == 0:
                defcfg.append((name, val))
            else:
                itcfg.append((name, val))
        for itr in ([self.itr_train] if self.itr_train else []) + \
                ([self.itr_pred] if self.itr_pred else []) + self.itr_evals:
            for k, v in defcfg:
                itr.set_param(k, v)
            itr.init()

    # ------------------------------------------------------------------
    def task_train(self) -> None:
        start = time.monotonic()
        self._stop_training = False
        self._preempt_noted = False
        if self.health_monitor:
            self._health = health.HealthMonitor(
                spike_factor=self.loss_spike_factor,
                spike_warmup=self.loss_spike_warmup)
            self._recovery = health.RecoveryPolicy(
                action=self.nonfinite_action,
                backoff=self.rollback_backoff,
                max_retries=self.rollback_max_retries)
            # /healthz answers 503 while an anomaly is unresolved (the
            # heartbeat channels are consulted whatever the monitor)
            statusd.wire_health(self._recovery)
        wd = None
        if self.watchdog_timeout > 0:
            # the step channel arms itself at the first finished batch and
            # is paused across eval, checkpoints and kernel builds
            wd = health.Watchdog(self.watchdog_timeout,
                                 action=self.watchdog_action).start()
        # emergency checkpoints are single-process: ranks would see the
        # signal at different steps and meet in mismatched collectives
        # (cxxnet_tpu/learn_task.py:1046-1059)
        single = multihost.worker_shard_params()[0] <= 1
        if self.preempt_save and not single and not self.silent:
            print("preempt_save: disabled (multi-process run — emergency "
                  "checkpoints require single-process training)")
        with ckpt.PreemptionGuard(enabled=bool(self.preempt_save)
                                  and single) as guard:
            self._preempt = guard
            try:
                self._task_train_loop(start)
            finally:
                self._preempt = None
                if wd is not None:
                    wd.stop()

    def _task_train_loop(self, start: float) -> None:
        if self.continue_training == 0 and self.name_model_in == "NULL":
            self._save_model()
        else:
            if not self.silent:
                print("continuing from round %d" % (self.start_counter - 1))
            for itr, nm in zip(self.itr_evals, self.eval_names):
                sys.stderr.write(self.net_trainer.evaluate(itr, nm))
            sys.stderr.write("\n")
            sys.stderr.flush()
        # the checkpoint's training state applies HERE, after the
        # continue-path eval (which would absorb a restored metric
        # accumulator) and right before the first update
        if self._resume_state is not None:
            self.net_trainer.restore_training_state(self._resume_state)
            rng = self._resume_state.get("iter_rng")
            if rng and self.itr_train is not None:
                self.itr_train.set_epoch_rng_state(rng)
            self._resume_state = None
        if self.itr_train is None:
            return
        if self.test_io != 0:
            print("start I/O test")
        cc = self.max_round
        rounds_done = 0
        prof = None
        while self.start_counter <= self.num_round and cc > 0:
            cc -= 1
            rnd = self.start_counter - 1
            if self.profile_dir and rounds_done == 1:
                prof = self._start_profile()
            statusd.update_progress(round=rnd, num_round=self.num_round)
            if not self.silent:
                print("update round %d" % rnd)
            # the session's last round (num_round reached or the max_round
            # cap exhausted) always checkpoints
            last_round = cc == 0 or self.start_counter == self.num_round
            try:
                with telemetry.span("round", round=rnd):
                    t_input, t_step, t_eval, t_ckpt, n_img = \
                        self._train_one_round(start, self._resume_batches,
                                              last_round)
            except health.TrainingAnomalyError as e:
                # rollback: the newest valid checkpoint is restored and the
                # loop re-enters its round with the batch quarantined (a
                # rollback takes one unit of the max_round budget)
                self._recover_from_anomaly(e.anomaly)
                continue
            if self._recovery is not None:
                self._recovery.on_round_complete()
            self._resume_batches = 0
            wall = t_input + t_step
            if self.test_io != 0:
                print("round %d: io-only %.1f images/sec" %
                      (rnd, n_img / t_input if t_input > 0 else 0.0))
            elif not self.silent and wall > 0:
                print("round %d: input-wait %.1f%% (io %.1f img/s when "
                      "blocked, step %.1f img/s)" %
                      (rnd, 100.0 * t_input / wall,
                       n_img / t_input if t_input > 0 else float("inf"),
                       n_img / t_step if t_step > 0 else float("inf")))
            if telemetry.enabled():
                telemetry.event({
                    "ev": "round", "round": rnd, "images": n_img,
                    "input_wait_s": round(t_input, 6),
                    "step_s": round(t_step, 6),
                    "eval_s": round(t_eval, 6),
                    "checkpoint_s": round(t_ckpt, 6)})
                telemetry.sample_device_memory(
                    device_mod.memory_stats(self.net_trainer.dev))
                telemetry.flush()
            rounds_done += 1
            if prof is not None:
                self._stop_profile(prof)
                prof = None
            if self._stop_training:
                telemetry.event({"ev": "preempt_exit", "round": rnd})
                if not self.silent:
                    print("preemption: checkpointed, exiting cleanly "
                          "(resume with continue=1)")
                return
        if not self.silent:
            print("updating end, %.0f sec in all"
                  % (time.monotonic() - start))

    def _start_profile(self):
        """profile_dir: a torch.profiler capture of the round about to run
        (round 2 of the session, the JAX package's choice,
        cxxnet_tpu/learn_task.py:1114-1171), with CUDA activity on a
        card."""
        prof = perf.torch_profiler(self.net_trainer.dev.type == "cuda")
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        """Stop the capture and write it as a Chrome trace,
        ``<profile_dir>/trace.json``."""
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        if not self.silent:
            print("profiler trace written to %s" % path)

    def _train_one_round(self, start: float, skip_batches: int,
                         final_round: bool):
        """One pass over itr_train, then the eval line and the checkpoint.
        Returns (input-wait, step, eval, checkpoint seconds, images): the
        time blocked in the chain's next() against the time in ``update``.
        On the card the steps run asynchronously, so the round waits for
        the card before it stops the step clock: the device time still
        queued at the last batch counts as step time, not as eval time.
        ``skip_batches`` (a mid-round resume) drains the round's first
        batches without training on them. A preemption request stops the
        round at the next step boundary with an emergency checkpoint."""
        sample_counter = 0
        hm = self._health
        rnd = self.start_counter - 1
        self.net_trainer.start_round(self.start_counter)
        self.itr_train.before_first()
        t_input = t_step = t_eval = t_ckpt = 0.0
        n_img = 0
        batches_done = 0
        if skip_batches:
            if not self._iter_chain_stable(self.itr_train):
                print("WARNING: the training iterator's epoch order is "
                      "not replay-stable (windowed shuffle); mid-round "
                      "resume is approximate — some prefix batches may "
                      "repeat or be skipped this round")
            with telemetry.span("resume.skip", batches=skip_batches):
                batches_done = self.itr_train.skip(skip_batches)
            sample_counter = batches_done
            if not self.silent:
                print("resume: fast-forwarded %d batches into round %d"
                      % (batches_done, self.start_counter - 1))
        while True:
            t0 = time.perf_counter()
            if self._recovery is not None \
                    and self._recovery.should_skip(rnd, batches_done):
                # a quarantined batch (an earlier anomaly): the cursor
                # moves past it without training, the rollback replay's
                # exclusion of the offending batch
                if self.itr_train.skip(1) == 0:
                    break
                telemetry.event({"ev": "health_skip_batch", "round": rnd,
                                 "batch": batches_done})
                telemetry.count("health/batches_skipped")
                sample_counter += 1
                batches_done += 1
                continue
            if not self.itr_train.next():
                break
            batch = self.itr_train.value()
            t1 = time.perf_counter()
            t_input += t1 - t0
            # recorded after the fact, so that the exhausted next() at the
            # round's end is not an io.wait
            telemetry.span_event("io.wait", t0, t1 - t0)
            if self.test_io == 0:
                self.net_trainer.update(batch)
                t_step += time.perf_counter() - t1
                if hm is not None:
                    # the PREVIOUS step's vector: its copy was queued
                    # behind that step, so the read waits for it alone
                    anomaly = hm.observe(rnd, batches_done,
                                         self.net_trainer.last_health)
                    if anomaly is not None:
                        self._on_anomaly(anomaly)
            health.beat("train.step")
            n_img += batch.batch_size - batch.num_batch_padd
            sample_counter += 1
            batches_done += 1
            statusd.update_progress(batch=batches_done)
            if sample_counter % self.print_step == 0 and not self.silent:
                print("round %8d:[%8d] %.0f sec elapsed" %
                      (self.start_counter - 1, sample_counter,
                       time.monotonic() - start))
            if self.test_io == 0 and self._preempt_requested():
                t0 = time.perf_counter()
                bad = hm.drain() if hm is not None else None
                if bad is not None:
                    # never persist the state after an anomaly: the resume
                    # restarts from the last numbered checkpoint instead
                    telemetry.event({"ev": "health_anomaly_at_preempt",
                                     "anomaly": bad.id})
                else:
                    self._save_emergency(batches_done)
                t_ckpt = time.perf_counter() - t0
                self._stop_training = True
                return t_input, t_step, t_eval, t_ckpt, n_img
        # eval and the checkpoint are legitimately step-silent (the next
        # round's first batch re-arms the channel)
        health.pause("train.step")
        if hm is not None:
            # settle the round's health BEFORE eval and checkpoint: a bad
            # last step must roll back, never be saved as good
            anomaly = hm.drain()
            if anomaly is not None:
                self._on_anomaly(anomaly)
        if self.test_io == 0:
            t0 = time.perf_counter()
            self.net_trainer.synchronize()
            t_step += time.perf_counter() - t0
            t0 = time.perf_counter()
            sys.stderr.write("[%d]" % self.start_counter)
            if not self.itr_evals:
                with telemetry.span("eval", dataset="train"):
                    sys.stderr.write(self.net_trainer.evaluate(None, "train"))
            for itr, nm in zip(self.itr_evals, self.eval_names):
                with telemetry.span("eval", dataset=nm):
                    sys.stderr.write(self.net_trainer.evaluate(itr, nm))
            sys.stderr.write("\n")
            sys.stderr.flush()
            t_eval = time.perf_counter() - t0
        t0 = time.perf_counter()
        with telemetry.span("checkpoint"):
            saved = self._save_model(force=final_round)
        t_ckpt = time.perf_counter() - t0
        if self._preempt_requested():
            # the signal came during eval or the checkpoint: the round is
            # complete, and if save_period skipped its file an emergency
            # one keeps the finished work
            if not saved:
                self._save_emergency(0)
            self._stop_training = True
        return t_input, t_step, t_eval, t_ckpt, n_img

    # ------------------------------------------------------------------
    # training-health recovery (cxxnet_tpu/learn_task.py:1304-1389)
    def _on_anomaly(self, anomaly) -> None:
        """Route a detected anomaly through the recovery policy: 'skip'
        logs and goes on (the device guard already kept the old state),
        'rollback' unwinds the round through TrainingAnomalyError, 'abort'
        dumps diagnostics and raises."""
        decision = self._recovery.decide(anomaly)
        if decision == "skip":
            # the guard suppresses only NON-FINITE steps; a finite loss
            # spike in skip mode was applied and is only logged
            suppressed = anomaly.kind == "nonfinite"
            if not self.silent:
                print("health: %s -> %s" % (
                    anomaly.describe(),
                    "skip (update suppressed on device)" if suppressed
                    else "logged (skip mode does not suppress finite "
                         "spikes)"))
            telemetry.event({"ev": "health_skip", "anomaly": anomaly.id,
                             "kind": anomaly.kind, "round": anomaly.round,
                             "batch": anomaly.batch,
                             "suppressed": suppressed})
            telemetry.count("health/updates_suppressed" if suppressed
                            else "health/spikes_logged")
            return
        if not self.silent:
            print("health: %s -> %s" % (anomaly.describe(), decision))
        if decision == "abort":
            reason = ("nonfinite_action=abort" if self.nonfinite_action ==
                      "abort" else "%d consecutive rollbacks exhausted "
                      "rollback_max_retries=%d" % (self._recovery.retries,
                                                   self.rollback_max_retries))
            telemetry.event({"ev": "health_abort", "anomaly": anomaly.id,
                             "reason": reason})
            health.dump_diagnostics(reason, anomaly)
            raise RuntimeError(
                "health: training anomaly (%s); aborting: %s"
                % (anomaly.describe(), reason))
        raise health.TrainingAnomalyError(anomaly)

    def _recover_from_anomaly(self, anomaly) -> None:
        """Roll back to the newest valid checkpoint and let the train loop
        re-enter the restored round: the offending batch is left out of the
        replay (RecoveryPolicy.should_skip), the checkpoint's training
        state and augmenter state apply as on a resume, and the
        accumulated LR backoff is applied again to the new trainer."""
        pol = self._recovery
        telemetry.event({"ev": "health_rollback", "anomaly": anomaly.id,
                         "retry": pol.retries, "round": anomaly.round,
                         "batch": anomaly.batch, "lr_scale": pol.lr_scale,
                         "skip": pol.skipped()})
        telemetry.count("health/rollbacks")
        health.pause("train.step")   # the reload is step-silent
        self._health.reset_pending()
        self._resume_state = None
        self._resume_batches = 0
        # any valid checkpoint will do: drop the scan floor first
        self.start_counter = 0
        if self._sync_latest_model() == 0:
            raise RuntimeError(
                "health: anomaly at round %d batch %d requires a rollback "
                "but no valid checkpoint exists in %s (save_model=0?); "
                "cannot recover" % (anomaly.round, anomaly.batch,
                                    self.name_model_dir))
        if not self.silent:
            print("health: rolled back to round %d (retry %d/%d, lr x%g)"
                  % (self.start_counter - 1, pol.retries,
                     self.rollback_max_retries, pol.lr_scale))
        if self._resume_state is not None:
            self.net_trainer.restore_training_state(self._resume_state)
            rng = self._resume_state.get("iter_rng")
            if rng and self.itr_train is not None:
                self.itr_train.set_epoch_rng_state(rng)
            self._resume_state = None
        if not self._iter_chain_stable(self.itr_train):
            print("WARNING: the training iterator's epoch order is not "
                  "replay-stable (windowed shuffle); the rollback replay "
                  "sees a different batch order and the quarantined "
                  "window is positional — recovery is approximate")
        self.net_trainer.scale_lr(pol.lr_scale)
        # recovery done (checkpoint restored, replay armed): /healthz
        # returns to 200
        pol.resolve()

    # ------------------------------------------------------------------
    def _pred_batches(self):
        assert self.itr_pred is not None, \
            "must specify a predict iterator to generate predictions"
        self.itr_pred.before_first()
        while self.itr_pred.next():
            batch = self.itr_pred.value()
            assert batch.num_batch_padd < batch.batch_size, \
                "num batch pad must be smaller"
            yield batch

    def task_predict(self) -> None:
        print("start predicting...")
        with self._output(self.name_pred, "w") as fo:
            for batch in self._pred_batches():
                pred = self.net_trainer.predict(batch.data)
                for v in pred[: len(pred) - batch.num_batch_padd]:
                    fo.write("%g\n" % v)
        print("finished prediction, write into %s" % self.name_pred)

    def task_predict_raw(self) -> None:
        """One space-separated row of the last node's values (class
        probabilities after softmax) per input row, as
        example/kaggle_bowl/make_submission.py reads them."""
        print("start predicting (raw)...")
        with self._output(self.name_pred, "w") as fo:
            for batch in self._pred_batches():
                out = self.net_trainer.extract_feature(batch.data, "top[-1]")
                out = np.asarray(out).reshape(out.shape[0], -1)
                for row in out[: len(out) - batch.num_batch_padd]:
                    fo.write(" ".join("%g" % v for v in row) + "\n")
        print("finished prediction, write into %s" % self.name_pred)

    def task_extract_feature(self) -> None:
        assert self.extract_node_name != "", \
            "extract node name must be specified in task extract_feature."
        print("start predicting...")
        nrow = 0
        dshape = (0, 0, 0)
        with self._output(self.name_pred,
                          "w" if self.output_format else "wb") as fo:
            for batch in self._pred_batches():
                pred = self.net_trainer.extract_feature(
                    batch.data, self.extract_node_name)
                sz = pred.shape[0] - batch.num_batch_padd
                nrow += sz
                for j in range(sz):
                    row = pred[j].reshape(-1)
                    if self.output_format:
                        fo.write(" ".join("%g" % x for x in row) + " \n")
                    else:
                        fo.write(row.astype("<f4").tobytes())
                if sz:
                    dshape = pred.shape[1:]
        with self._output(self.name_pred + ".meta", "w") as fm:
            fm.write("%d,%d,%d,%d\n" % (nrow, dshape[0], dshape[1], dshape[2]))
        print("finished prediction, write into %s" % self.name_pred)


    def task_generate(self) -> None:
        """task = generate (cxxnet_tpu/learn_task.py:1483-1518): KV-cached
        continuation of token-id prompts. ``prompt_in`` is a text file of
        space-separated integer token ids, one prompt per line; lines may
        differ in length (a ragged batch through generate's prompt_lens).
        ``gen_new`` tokens are appended per prompt, greedily by default
        (gen_temperature / gen_topk / gen_seed sample), and written to
        ``gen_out``, one space-separated id line per prompt."""
        rows = []
        with open(self.name_prompt_in) as f:
            for line in f:
                line = line.split()
                if line:
                    rows.append([int(t) for t in line])
        assert rows, "prompt_in %s has no prompts" % self.name_prompt_in
        vocab = max((lay.vocab_size for lay in self.net_trainer.net.layers
                     if lay.type_name == "embed"), default=0)
        if vocab:
            bad = [t for r in rows for t in r if not 0 <= t < vocab]
            assert not bad, (
                "prompt_in contains token ids outside the net's vocab_size "
                "%d (e.g. %d); wrong tokenizer?" % (vocab, bad[0]))
        lens = [len(r) for r in rows]
        max_p = max(lens)
        prompts = [r + [0] * (max_p - len(r)) for r in rows]
        out = self.net_trainer.generate(
            prompts, self.gen_new, temperature=self.gen_temperature,
            top_k=self.gen_topk, seed=self.gen_seed, prompt_lens=lens)
        with open(self.name_gen_out, "w") as fo:
            for row in out:
                fo.write(" ".join(str(int(t)) for t in row) + "\n")
        print("generated %d x %d tokens into %s"
              % (out.shape[0], out.shape[1], self.name_gen_out))

    def task_export(self) -> None:
        """task = export (cxxnet_tpu/learn_task.py:1939-1953): the inference
        forward as a self-contained ``torch.export`` program (params baked
        in) at ``export_out``. ``extract_node_name`` selects a named node or
        top[-k] (default: the last node, the pred surface); ``export_batch``
        overrides the batch dimension (default batch_size; -1 = a symbolic
        batch, one artifact serves any n >= 1). Reload it with
        ``cxxnet_tpu_torch.api.load_exported``."""
        blob = self.net_trainer.export_forward(
            node_name=self.extract_node_name,
            batch_size=self.export_batch)
        with open(self.name_export, "wb") as fo:
            fo.write(blob)
        print("exported forward (%d bytes) into %s"
              % (len(blob), self.name_export))

    def task_serve(self) -> None:
        """task = serve (cxxnet_tpu/learn_task.py:1519-1812): online serving
        through the frontend (utils/servd.py). Each stdin line is one
        prompt of space-separated token ids, answered on stdout with one
        line (the gen_new-token continuation, or ``ERR <class> ...``), in
        request order; ``DEADLINE <ms>``, ``TRACE``, ``TENANT`` and
        ``ADMIN stats`` / ``ADMIN reload`` lines as the JAX package reads
        them. Backend failures answer ``ERR backend`` and feed the circuit
        breaker; ``ADMIN reload`` or SIGHUP loads the newest checkpoint of
        model_dir between requests; SIGTERM / SIGINT drain (every accepted
        request answered within serve_drain_ms) and exit 0. serve_port >=
        0 also serves TCP clients with the same protocol; after stdin EOF
        the process then serves until a drain signal. serve_buckets =
        "1,2,4,8" runs the continuous-batching dispatcher over decode
        sessions of those slot counts (serve_kv_block > 0: paged); without
        it each request is one ``generate`` of batch 1."""
        import signal

        from .utils import servd

        vocab = servd.embed_vocab(self.net_trainer.net)
        statusd.update_progress(served=0, errors=0)

        def backend(toks, seq):
            # reads net_trainer THROUGH self so a hot reload's swapped-in
            # trainer serves the very next request
            tr = self.net_trainer
            with tr.on_device():
                return tr.generate(
                    [toks], self.gen_new, temperature=self.gen_temperature,
                    top_k=self.gen_topk, seed=self.gen_seed + seq)[0]

        def newest_ckpt_sig():
            # identity of the newest candidates (the newest numbered file
            # and the emergency file): a new or rewritten file changes it,
            # so a matching one means a reload would load the very model
            # being served
            paths = []
            cands = ckpt.scan_checkpoints(self.name_model_dir)
            if cands:
                paths.append(cands[-1][1])
            epath = os.path.join(self.name_model_dir, ckpt.EMERGENCY_NAME)
            if os.path.exists(epath):
                paths.append(epath)
            sig = []
            for p in paths:
                try:
                    fst = os.stat(p)
                except OSError:
                    continue
                sig.append((os.path.realpath(p), fst.st_mtime_ns,
                            fst.st_size))
            return tuple(sig)

        # seed the signature when the model being served IS the newest
        # candidate, so a blind SIGHUP loop starts out free
        served_sig = [newest_ckpt_sig()]
        if served_sig[0] and not (
                len(served_sig[0]) == 1 and served_sig[0][0][0]
                == os.path.realpath(self.name_model_in)):
            served_sig[0] = None

        def reload_fn():
            sig = newest_ckpt_sig()
            if sig and sig == served_sig[0]:
                if not self.silent:
                    print("serve: reload skipped — already serving the "
                          "newest checkpoint", file=sys.stderr, flush=True)
                return False
            # every session is closed by now (the dispatcher reloads only
            # between batches): free the old pool's device memory before
            # the new trainer's params are loaded beside the old ones
            self.net_trainer.release_kv_pool()
            prev_counter = self.start_counter
            self.start_counter = 0
            with self.net_trainer.on_device():
                loaded = self._sync_latest_model()
            if loaded == 0:
                self.start_counter = prev_counter
                sys.stderr.write(
                    "WARNING: serve reload: no valid checkpoint in %s; "
                    "keeping the current model\n" % self.name_model_dir)
                return False
            served_sig[0] = sig
            if not self.silent:
                # stderr: stdout is the response stream
                print("serve: reloaded model (round %d checkpoint)"
                      % (self.start_counter - 1), file=sys.stderr,
                      flush=True)
            return True

        slo = statusd.SLOTracker(
            ttft_ms=self.slo_ttft_ms, p99_ms=self.slo_p99_ms,
            availability=self.slo_availability, window_s=self.slo_window_s)
        # multi-tenant QoS: one SLOTracker per tenant of route_tenants
        tenants = servd.parse_tenants(self.route_tenants)
        slo_tenants = {}
        if tenants:
            if self.serve_tenant_default not in tenants:
                tenants[self.serve_tenant_default] = 1.0
            slo_tenants = {
                t: statusd.SLOTracker(
                    ttft_ms=self.slo_ttft_ms, p99_ms=self.slo_p99_ms,
                    availability=self.slo_availability,
                    window_s=self.slo_window_s)
                for t in tenants}
            if not self.silent:
                print("serve: multi-tenant QoS on (%s; default %r)"
                      % (",".join("%s:%g" % kv
                                  for kv in sorted(tenants.items())),
                         self.serve_tenant_default),
                      file=sys.stderr, flush=True)
        slot_backend = None
        bucket_list = [int(x) for x in
                       str(self.serve_buckets).replace(",", " ").split()]
        if bucket_list:
            slot_backend = _SlotBackendAdapter(
                lambda: self.net_trainer, bucket_list, self.gen_new,
                temperature=self.gen_temperature, top_k=self.gen_topk,
                seed=self.gen_seed, kv_block=self.serve_kv_block,
                prefix_reuse=bool(self.serve_prefix_reuse),
                retained_frac=self.serve_retained_frac,
                kv_pool_frac=self.serve_kv_pool_frac)
            if not self.silent:
                print("serve: continuous batching on (buckets %s, "
                      "batch_max %d, window %.1fms%s)"
                      % (sorted(set(bucket_list)), self.serve_batch_max,
                         self.serve_batch_window_ms,
                         ", paged kv block %d" % self.serve_kv_block
                         if self.serve_kv_block > 0 else ""),
                      file=sys.stderr, flush=True)
        fe = servd.ServeFrontend(
            backend, queue_size=self.serve_queue,
            deadline_ms=self.serve_deadline_ms,
            drain_ms=self.serve_drain_ms,
            breaker_fails=self.serve_breaker_fails,
            breaker_cooldown_ms=self.serve_breaker_cooldown_ms,
            stall_after_s=self.serve_stall_s,
            vocab=vocab, reload_fn=reload_fn,
            slo=slo, flight_cap=self.serve_flight_cap,
            slot_backend=slot_backend,
            batch_max=self.serve_batch_max,
            batch_window_ms=self.serve_batch_window_ms,
            batch_flight_cap=self.serve_batch_flight_cap,
            convoy_iters=self.serve_convoy_iters,
            kv_pressure_pct=self.serve_kv_pressure_pct,
            kv_pressure_clear_pct=self.serve_kv_pressure_clear_pct,
            tenants=tenants, tenant_default=self.serve_tenant_default,
            slo_tenants=slo_tenants)
        fe.start()
        statusd.set_flight_recorder(fe.flight)
        statusd.set_slo(slo)
        statusd.set_slo_tenants(slo_tenants)
        if slot_backend is not None:
            # the batch pages, and the live decode KV cache charged against
            # the ledger's HBM headroom
            statusd.set_batch(fe)
            perf.set_decode_kv(fe.decode_kv_bytes)
            plen_list = [int(x) for x in str(self.serve_plen_buckets)
                         .replace(",", " ").split()]
            if plen_list and self._perf_enabled:
                # the warm grid (cxxnet_tpu/learn_task.py:1706-1730): the
                # expected programs of serve_buckets x serve_plen_buckets
                # on the ledger, the frontend's warm account read from it
                # (cxxnet_ready_programs_pct, ADMIN warm_programs, and the
                # "warming" health gate at serve_warm_ready_pct > 0)
                perf.ledger().set_expected_grid(
                    self.net_trainer.expected_decode_grid(
                        bucket_list, plen_list,
                        temperature=self.gen_temperature,
                        top_k=self.gen_topk,
                        kv_block=self.serve_kv_block))
                fe.set_warm_account(perf.ledger().readiness,
                                    ready_pct=self.serve_warm_ready_pct)
        if self.serve_port >= 0:
            try:
                port = fe.listen(self.serve_port, host=self.serve_host)
            except (OSError, OverflowError) as e:
                # a taken port must not kill serving: warn, fall back to
                # the stdin surface
                sys.stderr.write(
                    "WARNING: servd: cannot bind port %d (%s); TCP "
                    "serving disabled, stdin loop only\n"
                    % (self.serve_port, e))
            else:
                if not self.silent:
                    # stderr, not stdout: stdout carries exactly one
                    # response line per stdin request
                    print("servd: serving on port %d (line protocol; "
                          "DEADLINE/ADMIN prefixes, ERR classes)" % port,
                          file=sys.stderr, flush=True)
        statusd.register_probe("serving", fe.health_probe)
        statusd.register_probe("serving.worker", fe.liveness_probe,
                               liveness=True)
        wd = None
        if self.watchdog_timeout > 0:
            # the serve.accept / serve.worker channels beat from the
            # frontend's threads (paused across idle periods)
            wd = health.Watchdog(self.watchdog_timeout,
                                 action=self.watchdog_action).start()
        old_hup = None
        try:
            # SIGHUP = hot reload; the handler only sets a flag. Signal
            # handlers install on the main thread only.
            old_hup = signal.signal(
                signal.SIGHUP, lambda s, f: fe.request_reload())
        except (AttributeError, ValueError, OSError):
            pass                 # no SIGHUP (platform) / not main thread
        stdin_done = threading.Event()

        def pump():
            reply = lambda text: print(text, flush=True)  # noqa: E731
            for line in sys.stdin:
                # wait=True keeps responses in request order (the stdin
                # contract) while still running the full engine path
                fe.submit(line.rstrip("\n"), reply, wait=True)
            stdin_done.set()

        threading.Thread(target=pump, name="cxn-serve-stdin",
                         daemon=True).start()
        try:
            with ckpt.PreemptionGuard() as guard:
                # serve until drain is requested; a stdin EOF ends a
                # pipe-driven run unless TCP clients are being served
                while not guard.requested:
                    if stdin_done.is_set() and not fe.listening:
                        break
                    time.sleep(0.1)
                if guard.requested:
                    telemetry.event({"ev": "preempt_signal",
                                     "signum": guard.signum})
                    if not self.silent:
                        print("serve: drain requested (signal %s); "
                              "finishing accepted requests"
                              % guard.signum, file=sys.stderr, flush=True)
        finally:
            stats = fe.drain()
            if wd is not None:
                wd.stop()
            if old_hup is not None:
                try:
                    signal.signal(signal.SIGHUP, old_hup)
                except (ValueError, OSError):
                    pass
        telemetry.event(dict({"ev": "serve_done"}, **stats))
        print("served %d prompts (%d request errors)"
              % (stats["served"], stats["errors"]),
              file=sys.stderr, flush=True)
        if stats["shed"] or stats["deadline"]:
            print("  shed %d, deadline-expired %d (of %d accepted)"
                  % (stats["shed"], stats["deadline"], stats["accepted"]),
                  file=sys.stderr, flush=True)

    def task_route(self) -> None:
        """task = route (cxxnet_tpu/learn_task.py:1814-1941): the fleet
        router (utils/routerd.py). It speaks the servd line protocol on
        route_port and spreads client connections over the ``task =
        serve`` replicas of route_replicas (``host:serve_port:status_port``,
        comma separated): health-aware dispatch from each replica's
        ``/healthz`` and load gauges, least-loaded power-of-two choices,
        retry of never-dispatched sheds on another replica within the
        client's DEADLINE budget, replay of lost attempts, ejection of dead
        replicas with backoff re-probes, and ``ADMIN reload`` (or SIGHUP)
        rolled over the replicas one drain window at a time. SIGTERM /
        SIGINT drain the router (routed requests in flight finish, the
        counters reconcile, exit 0); the replicas drain on their own
        signals. The process loads no model and touches no card."""
        import signal

        from .utils import routerd, servd

        replicas = routerd.parse_replicas(self.route_replicas)
        assert replicas, \
            "task = route needs route_replicas = host:port:status_port[,...]"
        route_tenants = servd.parse_tenants(self.route_tenants)
        if route_tenants and self.serve_tenant_default \
                not in route_tenants:
            route_tenants[self.serve_tenant_default] = 1.0
        router = routerd.Router(
            replicas, probe_ms=self.route_probe_ms,
            retries=self.route_retries, stall_s=self.route_stall_s,
            drain_ms=self.serve_drain_ms,
            flight_cap=self.route_flight_cap,
            federate_ms=self.fleet_federate_ms,
            outlier_ratio=self.fleet_outlier_ratio,
            outlier_min_n=self.fleet_outlier_min_n,
            standby_replicas=self.route_standby_replicas,
            scale_min=self.route_scale_min,
            scale_max=self.route_scale_max,
            scale_up_burn=self.route_scale_up_burn,
            scale_down_idle_s=self.route_scale_down_idle_s,
            scale_cooldown_s=self.route_scale_cooldown_s,
            tenants=self.route_tenants,
            tenant_default=self.serve_tenant_default,
            replay=bool(self.route_replay),
            hedge_ms=self.route_hedge_ms,
            hedge_max_pct=self.route_hedge_max_pct,
            # the router's own per-tenant windows (door sheds), with the
            # replicas' objectives, merged into the federated burn account
            slo_tenants={
                t: statusd.SLOTracker(
                    ttft_ms=self.slo_ttft_ms, p99_ms=self.slo_p99_ms,
                    availability=self.slo_availability,
                    window_s=self.slo_window_s)
                for t in route_tenants})
        router.start()
        port = router.listen(self.route_port, host=self.route_host)
        # one synchronous sweep, so that /fleetz and the first dispatches
        # see probed states (a dead replica of the conf is ejected before
        # traffic arrives)
        router.probe_now()
        statusd.set_fleet(router)
        statusd.set_slo_tenants(router.slo_tenants)
        # the routing flight ring: /requestz lists every routed request's
        # attempts; with the fleet set, /trace?request=<id>, /why and
        # /eventz serve the stitched cross-process views
        statusd.set_flight_recorder(router.flight)
        statusd.register_probe("routing", router.health_probe)
        statusd.register_probe("routing.prober", router.liveness_probe,
                               liveness=True)
        if not self.silent:
            up = sum(1 for r in router._replicas
                     if r.state == routerd.UP)
            print("routerd: routing on port %d over %d replicas "
                  "(%d up; servd line protocol)"
                  % (port, len(replicas), up), file=sys.stderr,
                  flush=True)
        wd = None
        if self.watchdog_timeout > 0:
            # the route.accept / route.probe channels beat from the
            # router's threads
            wd = health.Watchdog(self.watchdog_timeout,
                                 action=self.watchdog_action).start()
        # SIGHUP = rolling fleet reload. The handler only sets a flag
        # (request_rolling_reload takes locks); the main loop acts on it.
        hup_flag = {"on": False}
        old_hup = None
        try:
            old_hup = signal.signal(
                signal.SIGHUP,
                lambda s, f: hup_flag.update(on=True))
        except (AttributeError, ValueError, OSError):
            pass                 # no SIGHUP (platform) / not main thread
        try:
            with ckpt.PreemptionGuard() as guard:
                while not guard.requested:
                    if hup_flag["on"]:
                        hup_flag["on"] = False
                        if router.request_rolling_reload() \
                                and not self.silent:
                            print("route: rolling fleet reload "
                                  "started (SIGHUP)", file=sys.stderr,
                                  flush=True)
                    time.sleep(0.1)
                telemetry.event({"ev": "preempt_signal",
                                 "signum": guard.signum})
                if not self.silent:
                    print("route: fleet drain requested (signal %s)"
                          % guard.signum, file=sys.stderr, flush=True)
        finally:
            stats = router.drain()
            if wd is not None:
                wd.stop()
            if old_hup is not None:
                try:
                    signal.signal(signal.SIGHUP, old_hup)
                except (ValueError, OSError):
                    pass
        telemetry.event(dict({"ev": "route_done"}, **stats))
        print("routed %d requests (%d served, %d errors, %d shed, "
              "%d deadline, %d retries)"
              % (stats["accepted"], stats["served"], stats["errors"],
                 stats["shed"], stats["deadline"], stats["retries"]),
              file=sys.stderr, flush=True)


def main(argv: List[str]) -> int:
    return LearnTask().run(argv)
