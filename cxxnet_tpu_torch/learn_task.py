"""The learn task driver of the port: train / finetune / pred / pred_raw /
extract / generate / serve from a config file.

Counterpart of cxxnet_tpu/learn_task.py (the reference's
CXXNetLearnTask, src/cxxnet_main.cpp:16-478) for those seven tasks: the
same config keys, the same sectioned iterator chains (``data =`` /
``eval =`` / ``pred =`` ... ``iter = end``, other keys applied to every
chain), the same round loop and printed lines (progress on stdout, the
``[round]`` metric lines on stderr), checkpoint naming
(``<model_dir>/%04d.model``, counter checked before it is incremented, the
session's last round always saved) and pred / pred_raw / extract output
formats, the JAX package's ``task = generate`` (prompt lines in,
continuations out) and ``task = serve`` (the serving frontend,
``utils/servd.py``, over stdin and optionally TCP, solo or continuously
batched over decode sessions). Model files are CRC-framed, as
``api.Net.save_model`` writes them, and either package loads the other's.

The net runs on the card unless the config or the command line says
``dev = cpu``; there, every threadbuffer of the chains packs its batches
into page-locked memory, which the trainer copies to the card
asynchronously. Keys of features that are not ported raise when they are
set to anything but their default (``_NOT_PORTED``).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from .io import create_iterator
from .nnet.trainer import Trainer, create_net
from .utils import checkpoint as ckpt
from .utils import serializer
from .utils import statusd
from .utils import telemetry
from .utils.config import ConfigIterator

# the fleet router's keys (task = route, cxxnet_tpu/utils/routerd.py) with
# their defaults; route_tenants is the serving frontend's too, and ported
_FLEET_DEFAULTS = {
    "route_port": 0, "route_host": "", "route_replicas": "",
    "route_probe_ms": 200.0, "route_retries": 2, "route_stall_s": 30.0,
    "route_flight_cap": 256, "route_standby_replicas": "",
    "route_scale_min": 0, "route_scale_max": 0, "route_scale_up_burn": 1.0,
    "route_scale_down_idle_s": 30.0, "route_scale_cooldown_s": 10.0,
    "route_replay": 1, "route_hedge_ms": 0.0, "route_hedge_max_pct": 10.0,
    "fleet_federate_ms": 1000.0, "fleet_outlier_ratio": 3.0,
    "fleet_outlier_min_n": 20,
}


def _is_default(default):
    if isinstance(default, str):
        return lambda v: v == default
    return lambda v: type(default)(v) == default


# keys whose features are not ported yet, with the test that a value is the
# key's default (which is accepted)
_NOT_PORTED = {
    "continue": lambda v: int(v) == 0,
    "status_port": lambda v: int(v) == -1,
    "profile_dir": lambda v: v == "",
    "health_monitor": lambda v: int(v) == 0,
    "watchdog_timeout": lambda v: float(v) == 0.0,
    "coordinator": lambda v: v == "",
    "num_worker": lambda v: int(v) <= 1,
    "ckpt_keep_last": lambda v: int(v) == 0,
    "ckpt_keep_every": lambda v: int(v) == 0,
    # the perf ledger's warm-grid account (TPU program accounting)
    "serve_plen_buckets": lambda v: v.replace(",", " ").split() == [],
    "serve_warm_ready_pct": lambda v: float(v) == 0.0,
}
_NOT_PORTED.update({k: _is_default(d) for k, d in _FLEET_DEFAULTS.items()})
_TASKS = ("train", "finetune", "pred", "pred_raw", "extract", "generate",
          "serve")
_TASKS_NOT_PORTED = ("export", "route")


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
    net's sequence length; the perf ledger's headroom cap is not ported)."""

    def __init__(self, trainer, buckets, n_new: int,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 kv_block: int = 0, prefix_reuse: bool = True,
                 retained_frac: float = 1.0):
        self.trainer = trainer
        self.buckets = list(buckets)
        self.n_new = int(n_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.kv_block = int(kv_block)
        self.prefix_reuse = bool(prefix_reuse)
        self.retained_frac = float(retained_frac)

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
        return self.trainer().decode_kv_pool(
            self.kv_block, pool_tokens=max(self.buckets) * self._l_max(),
            prefix_reuse=self.prefix_reuse,
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
    ("serve_retained_frac", float), ("serve_kv_pressure_pct", float),
    ("serve_kv_pressure_clear_pct", float),
    ("serve_batch_flight_cap", int), ("serve_convoy_iters", int),
    ("serve_flight_cap", int), ("serve_tenant_default", str),
    ("slo_ttft_ms", float), ("slo_p99_ms", float),
    ("slo_availability", float), ("slo_window_s", float),
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
        self._start_counter_conf = False
        self.name_model_in = "NULL"
        self.name_pred = "pred.txt"
        self.print_step = 100
        self.extract_node_name = ""
        self.output_format = 1
        # telemetry_log = <path>: the JSONL run log (utils/telemetry.py)
        self.telemetry_log = ""
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
        # task = generate (cxxnet_tpu/learn_task.py:272-273, 420-423)
        self.name_prompt_in = "prompts.txt"
        self.name_gen_out = "gen.txt"
        self.gen_new = 16
        self.gen_temperature = 0.0
        self.gen_topk = 0
        self.gen_seed = 0
        self.device = "gpu"
        self.cfg: List[Tuple[str, str]] = [("dev", "gpu")]

    def run(self, argv: List[str]) -> int:
        if len(argv) < 1:
            print("Usage: <config>")
            return 0
        for name, val in ConfigIterator(argv[0], argv[1:]):
            self.set_param(name, val)
        if self.telemetry_log:
            telemetry.enable(self.telemetry_log)
            telemetry.event({"ev": "run_meta", "task": self.task,
                             "dev": self.device})
        try:
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
        finally:
            self.close()
            if self.telemetry_log:
                telemetry.flush()
                telemetry.disable()
        return 0

    def close(self) -> None:
        """Stop the chains' loader threads and close their files."""
        for itr in [self.itr_train, self.itr_pred] + self.itr_evals:
            if itr is not None:
                itr.close()

    def set_param(self, name: str, val: str) -> None:
        if val == "default":
            return
        if name in _NOT_PORTED and not _NOT_PORTED[name](val):
            raise ValueError("%s = %s: this feature is not ported to "
                             "cxxnet_tpu_torch yet" % (name, val))
        if name == "task":
            if val in _TASKS_NOT_PORTED:
                raise ValueError("task = %s is not ported to "
                                 "cxxnet_tpu_torch yet" % val)
            if val not in _TASKS:
                raise ValueError("unknown task %s" % val)
            self.task = val
        if name == "net_type":
            self.net_type = int(val)
        if name == "reset_net_type":
            self.reset_net_type = int(val)
        if name == "print_step":
            self.print_step = int(val)
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
        if name == "route_tenants":
            self.route_tenants = val
        for key, cast in _SERVE_KEYS:
            if name == key:
                setattr(self, key, cast(val))
        self.cfg.append((name, val))

    # ------------------------------------------------------------------
    def init(self) -> None:
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

    def _read_model_file(self, path: str) -> serializer.Reader:
        """A model file's payload, its CRC framing verified (unframed
        legacy files pass through)."""
        payload, _ = ckpt.read_verified(path)
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

    def _save_model(self, force: bool = False) -> bool:
        """Round-boundary checkpoint; returns whether a file was written.
        The counter is checked before the increment, and the session's
        last round saves whatever save_period says (``force``), as in the
        JAX package (cxxnet_tpu/learn_task.py:925-955)."""
        counter = self.start_counter
        self.start_counter += 1
        if self.save_period == 0:
            return False
        if counter % self.save_period != 0 and not force:
            return False
        w = serializer.Writer()
        w.write_int32(self.net_type)
        self.net_trainer.save_model(w)
        os.makedirs(self.name_model_dir, exist_ok=True)
        ckpt.write_framed(self._model_path(counter), w.getvalue())
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
                if flag == 1 and self.task not in ("pred", "generate"):
                    assert self.itr_train is None, "can only have one data"
                    self.itr_train = create_iterator(itcfg)
                if flag == 2 and self.task not in ("pred", "generate"):
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
        if self.name_model_in == "NULL":
            self._save_model()
        else:
            if not self.silent:
                print("continuing from round %d" % (self.start_counter - 1))
            for itr, nm in zip(self.itr_evals, self.eval_names):
                sys.stderr.write(self.net_trainer.evaluate(itr, nm))
            sys.stderr.write("\n")
            sys.stderr.flush()
        if self.itr_train is None:
            return
        if self.test_io != 0:
            print("start I/O test")
        cc = self.max_round
        while self.start_counter <= self.num_round and cc > 0:
            cc -= 1
            rnd = self.start_counter - 1
            if not self.silent:
                print("update round %d" % rnd)
            # the session's last round (num_round reached or the max_round
            # cap exhausted) always checkpoints
            last_round = cc == 0 or self.start_counter == self.num_round
            t_input, t_step, n_img = self._train_one_round(start, last_round)
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
        if not self.silent:
            print("updating end, %.0f sec in all"
                  % (time.monotonic() - start))

    def _train_one_round(self, start: float, final_round: bool):
        """One pass over itr_train, then the eval line and the checkpoint.
        Returns (input-wait seconds, step seconds, images): the time
        blocked in the chain's next() against the time in ``update``. On
        the card the steps run asynchronously, so the round waits for the
        card before it stops the step clock: the device time still queued
        at the last batch counts as step time, not as eval time."""
        sample_counter = 0
        self.net_trainer.start_round(self.start_counter)
        self.itr_train.before_first()
        t_input = t_step = 0.0
        n_img = 0
        while True:
            t0 = time.perf_counter()
            if not self.itr_train.next():
                break
            batch = self.itr_train.value()
            t1 = time.perf_counter()
            t_input += t1 - t0
            if self.test_io == 0:
                self.net_trainer.update(batch)
                t_step += time.perf_counter() - t1
            n_img += batch.batch_size - batch.num_batch_padd
            sample_counter += 1
            if sample_counter % self.print_step == 0 and not self.silent:
                print("round %8d:[%8d] %.0f sec elapsed" %
                      (self.start_counter - 1, sample_counter,
                       time.monotonic() - start))
        if self.test_io == 0:
            t0 = time.perf_counter()
            self.net_trainer.synchronize()
            t_step += time.perf_counter() - t0
            sys.stderr.write("[%d]" % self.start_counter)
            if not self.itr_evals:
                sys.stderr.write(self.net_trainer.evaluate(None, "train"))
            for itr, nm in zip(self.itr_evals, self.eval_names):
                sys.stderr.write(self.net_trainer.evaluate(itr, nm))
            sys.stderr.write("\n")
            sys.stderr.flush()
        self._save_model(force=final_round)
        return t_input, t_step, n_img

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
        with open(self.name_pred, "w") as fo:
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
        with open(self.name_pred, "w") as fo:
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
        with open(self.name_pred, "w" if self.output_format else "wb") as fo:
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
        with open(self.name_pred + ".meta", "w") as fm:
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

    def _sync_latest_model(self) -> int:
        """Load the newest numbered checkpoint of model_dir that parses
        (cxxnet_tpu/learn_task.py:772-855 without the emergency file and
        quarantine, which are not ported): newest first, a file that fails
        its CRC or does not parse is skipped with a warning. Returns 1 and
        swaps in the new trainer, or 0 when no file loads."""
        for counter, path in reversed(ckpt.scan_checkpoints(
                self.name_model_dir)):
            if counter < self.start_counter:
                break
            try:
                r = self._read_model_file(path)
                net_type = r.read_int32()
                prev_type, self.net_type = self.net_type, net_type
                try:
                    net = self._create_net()
                    net.load_model(r)
                except Exception:
                    self.net_type = prev_type
                    raise
            except Exception as e:
                sys.stderr.write("WARNING: cannot load %s (%s); skipping\n"
                                 % (path, e))
                continue
            self.net_trainer = net
            self.start_counter = counter + 1
            telemetry.event({"ev": "ckpt_restore", "path": path,
                             "counter": counter, "batches_done": 0})
            return 1
        return 0

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
            # identity of the newest numbered checkpoint: a new or
            # rewritten file changes it, so a matching one means a reload
            # would load the very model being served
            cands = ckpt.scan_checkpoints(self.name_model_dir)
            if not cands:
                return ()
            try:
                fst = os.stat(cands[-1][1])
            except OSError:
                return ()
            return ((os.path.realpath(cands[-1][1]), fst.st_mtime_ns,
                     fst.st_size),)

        # seed the signature when the model being served IS the newest
        # checkpoint, so a blind SIGHUP loop starts out free
        served_sig = [newest_ckpt_sig()]
        if served_sig[0] and served_sig[0][0][0] != os.path.realpath(
                self.name_model_in):
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
                retained_frac=self.serve_retained_frac)
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
            statusd.set_batch(fe)
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


def main(argv: List[str]) -> int:
    return LearnTask().run(argv)
