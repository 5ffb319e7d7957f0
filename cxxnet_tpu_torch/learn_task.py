"""The learn task driver of the port: train / finetune / pred / pred_raw /
extract from a config file.

Counterpart of cxxnet_tpu/learn_task.py (the reference's
CXXNetLearnTask, src/cxxnet_main.cpp:16-478) for those five tasks: the
same config keys, the same sectioned iterator chains (``data =`` /
``eval =`` / ``pred =`` ... ``iter = end``, other keys applied to every
chain), the same round loop and printed lines (progress on stdout, the
``[round]`` metric lines on stderr), checkpoint naming
(``<model_dir>/%04d.model``, counter checked before it is incremented, the
session's last round always saved) and pred / pred_raw / extract output
formats. Model files are CRC-framed, as ``api.Net.save_model`` writes
them, and either package loads the other's.

The net runs on the card unless the config or the command line says
``dev = cpu``; there, every threadbuffer of the chains packs its batches
into page-locked memory, which the trainer copies to the card
asynchronously. Keys of features that are not ported raise when they are
set to anything but their default (``_NOT_PORTED``).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from .io import create_iterator
from .nnet.trainer import Trainer, create_net
from .utils import checkpoint as ckpt
from .utils import serializer
from .utils.config import ConfigIterator

# keys whose features are not ported yet, with the test that a value is the
# key's default (which is accepted)
_NOT_PORTED = {
    "continue": lambda v: int(v) == 0,
    "telemetry_log": lambda v: v == "",
    "status_port": lambda v: int(v) == -1,
    "profile_dir": lambda v: v == "",
    "health_monitor": lambda v: int(v) == 0,
    "watchdog_timeout": lambda v: float(v) == 0.0,
    "coordinator": lambda v: v == "",
    "num_worker": lambda v: int(v) <= 1,
    "ckpt_keep_last": lambda v: int(v) == 0,
    "ckpt_keep_every": lambda v: int(v) == 0,
}
_TASKS = ("train", "finetune", "pred", "pred_raw", "extract")
_TASKS_NOT_PORTED = ("generate", "serve", "export", "route")


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
        self.device = "gpu"
        self.cfg: List[Tuple[str, str]] = [("dev", "gpu")]

    def run(self, argv: List[str]) -> int:
        if len(argv) < 1:
            print("Usage: <config>")
            return 0
        for name, val in ConfigIterator(argv[0], argv[1:]):
            self.set_param(name, val)
        try:
            self.init()
            if not self.silent:
                print("initializing end, start working")
            if self.task in ("train", "finetune"):
                self.task_train()
            elif self.task == "pred":
                self.task_predict()
            elif self.task == "pred_raw":
                self.task_predict_raw()
            elif self.task == "extract":
                self.task_extract_feature()
        finally:
            self.close()
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
                if flag == 1 and self.task != "pred":
                    assert self.itr_train is None, "can only have one data"
                    self.itr_train = create_iterator(itcfg)
                if flag == 2 and self.task != "pred":
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


def main(argv: List[str]) -> int:
    return LearnTask().run(argv)
