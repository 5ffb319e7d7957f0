"""Trainer: the INetTrainer surface on one device.

Counterpart of cxxnet_tpu/nnet/trainer.py (the reference's
CXXNetThreadTrainer, src/nnet/nnet_impl-inl.hpp:16-455) for the port's
slices so far: configuration, model init, model files with their
optimizer-state section, prediction and feature extraction, the training
step (``update``: forward, autograd backward, ``update_period``
accumulation, ``clip_global_norm``, one updater per weight tensor, train
metrics accumulated on the device), ``evaluate``, ``copy_model_from``,
the LM serving engine for sequence nets (KV-cached ``generate``, greedy or
sampled, ``beam_generate``, and continuous batching in ``DecodeSession``
over a dense slot-major cache or the paged ``KVBlockPool``), sequence
parallelism (``seq_parallel = n``: the device runs n virtual ranks of
the sequence in every attention layer, and the result equals the
single-device run), mixed precision (``compute_dtype = bfloat16``: the
nets compute in bf16 over float32 master weights, updaters and optimizer
state) and batch-norm state updates. On a card, a training batch from
host memory goes through the trainer's own ring of page-locked buffers
and an asynchronous copy on a stream of its own (``StagingRing``,
``_batch_tensors``). Meshes over several devices, the health monitor,
the serving frontend, exported decode programs and the training-state
section belong to later slices. Under bf16, ``predict``,
``extract_feature`` and ``evaluate`` hand out float32 arrays that hold
the bf16 values (the JAX package returns bf16 arrays through ml_dtypes,
which the card's machine lacks; the conversion is exact).
"""

from __future__ import annotations

import collections
import copy
import re
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..layer.base import check, fold_in
from ..ops import random as oprandom
from ..updater import Updater, create_updater
from ..utils import kvblocks, serializer
from ..utils.kvblocks import KVPoolExhausted
from ..utils.metric import MetricSet
from .config import NetConfig
from .net import NeuralNet

# magics of the optional sections after the model blob: optimizer state
# (written by save_model, read by load_model), then the JAX package's
# training state (save_training_state), which the port steps over
OPT_MAGIC = b"CXNOPT01"
STATE_MAGIC = b"CXTSTA01"

OptState = List[Dict[str, Dict[str, torch.Tensor]]]

# the decode paths' nets kept per trainer, by their most recent use
SEQ_NETS_KEPT = 64


def topk_mask(lg: torch.Tensor, k: int) -> torch.Tensor:
    """The exact-k mask of (b, V) scores: True at each row's k largest,
    ties taken in index order as ``jax.lax.top_k`` takes them (a stable
    sort), so that exactly k survive where a >= k-th-value threshold would
    keep every tied token."""
    idx = torch.sort(lg, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.zeros_like(lg, dtype=torch.bool).scatter_(1, idx, True)


def sample_pick(temperature: float, top_k: int):
    """The next-token chooser over (b, V) softmax rows (the JAX package's
    ``_sample_pick``, cxxnet_tpu/nnet/trainer.py:45-71): the argmax at
    temperature 0, else a draw from softmax(log(probs) / temperature),
    truncated to the ``top_k`` most likely tokens first when top_k > 0.
    One definition for ``generate``/``decode`` and ``DecodeSession``: a
    request's tokens in a session are those of its solo ``generate``.

    The draw is Gumbel-max over the per-row uniform kernel (row r: its
    request's seed ``seeds[r]``, the position ``pos`` of the row's input
    token, an int or a (b,) tensor, and its row ``rowid[r]`` within the
    request), argmax(lg - log(-log(u))), the same distribution as
    ``jax.random.categorical`` but not its bits."""
    temperature, top_k = float(temperature), int(top_k)
    check(top_k >= 0, "generate: top_k must be >= 0")

    def pick(probs: torch.Tensor, seeds: torch.Tensor, pos,
             rowid: torch.Tensor) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(probs, dim=1)
        lg = torch.log(probs.float().clamp_min(1e-30)) / temperature
        if top_k and top_k < lg.shape[1]:
            lg = lg.masked_fill(~topk_mask(lg, top_k), float("-inf"))
        if not torch.is_tensor(pos):
            pos = torch.full_like(seeds, int(pos))
        u = oprandom.uniform_rows(seeds, pos, rowid, lg.shape[1])
        return torch.argmax(lg - torch.log(-torch.log(u)), dim=1)

    return pick


class StagingRing:
    """Page-locked host buffers for training batches on their way to the
    card. ``fill`` copies a batch's arrays into the next slot, after
    waiting on the event recorded behind that slot's last copy (``record``),
    so a buffer is never refilled while the card may still be reading it;
    the caller's arrays are free again as soon as ``fill`` returns."""

    def __init__(self, n: int = 2, pin: bool = True):
        self.pin = pin
        self._tensors: List[List[torch.Tensor]] = [[] for _ in range(n)]
        self._events: list = [None] * n
        self._next = self._last = 0

    def fill(self, arrays) -> List[torch.Tensor]:
        k = self._next
        self._next = (k + 1) % len(self._tensors)
        if self._events[k] is not None:
            self._events[k].synchronize()
            self._events[k] = None
        slot = self._tensors[k]
        for i, arr in enumerate(arrays):
            arr = np.ascontiguousarray(arr)
            if i == len(slot) or slot[i].shape != arr.shape \
                    or slot[i].numpy().dtype != arr.dtype:
                t = torch.empty(arr.shape, pin_memory=self.pin,
                                dtype=torch.from_numpy(arr[:0]).dtype)
                slot[i:i + 1] = [t]
            # torch's copy splits a large batch over the intra-op threads
            slot[i].copy_(torch.from_numpy(arr))
        self._last = k
        return slot[:len(arrays)]

    def record(self, event) -> None:
        """The event behind the copies out of the slot ``fill`` filled last."""
        self._events[self._last] = event


class Trainer:
    """Net trainer; one instance per model."""

    def __init__(self):
        self.cfg_pairs: List[Tuple[str, str]] = []
        self.net_cfg = NetConfig()
        self.net: Optional[NeuralNet] = None
        self.batch_size = 100
        self.update_period = 1
        self.eval_train = 1
        self.sample_counter = 0
        self.epoch_counter = 0
        self.seed = 0
        self.silent = 0
        self.dev_spec = "gpu"
        self.input_scale = 1.0      # device-side input normalization
        self.input_mean = None
        self.clip_global_norm = 0.0  # 0 -> off
        # sequence parallelism: the device runs this many virtual ranks of
        # the sequence in every attention layer (doc/multichip.md:162-193)
        self.seq_parallel = 1
        # the nets' compute dtype; None computes in float32
        self.compute_dtype: Optional[torch.dtype] = None
        self.metric = MetricSet()
        self.train_metric = MetricSet()
        self.eval_node_names: List[Optional[str]] = []  # None -> last node
        self.eval_nodes: List[int] = []
        self.params = None
        self.updaters: List[Dict[str, Updater]] = []
        self.opt_state: Optional[OptState] = None
        self.grad_accum: Optional[List[torch.Tensor]] = None
        self._metric_accum: Optional[torch.Tensor] = None  # (n_metrics, 2)
        self._rng_counter = 0
        self.round = 0
        self.dev: Optional[torch.device] = None
        # the host-to-card feed of training batches (on a card only)
        self._staging: Optional[StagingRing] = None
        self._copy_stream = None
        # the decode paths' nets by (batch size, sequence length): generate's
        # one-token step and prefills, beam search's, the sessions'; the
        # SEQ_NETS_KEPT most recently used
        self._seq_nets: Dict[Tuple[int, int], NeuralNet] = \
            collections.OrderedDict()
        # changes whenever the weights change in place (update, set_weight,
        # copy_model_from): with the params list's identity, the key of the
        # decode copy and of a session's staleness check
        self._params_gen = 0
        self._decode_params = None
        self._kv_pool: Optional["KVBlockPool"] = None

    # configuration (reference SetParam, nnet_impl-inl.hpp:31-69)
    def set_param(self, name: str, val: str) -> None:
        if name == "dev":
            self.dev_spec = val
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "update_period":
            self.update_period = int(val)
            check(self.update_period >= 1, "update_period must be >= 1")
        if name == "eval_train":
            self.eval_train = int(val)
        if name == "seed":
            self.seed = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "clip_global_norm":
            self.clip_global_norm = float(val)
        if name == "compute_dtype":
            check(val in ("float32", "bfloat16", "bf16"),
                  "compute_dtype must be float32 or bfloat16")
            self.compute_dtype = (torch.bfloat16 if val in ("bfloat16", "bf16")
                                  else None)
        if name == "seq_parallel":
            self.seq_parallel = int(val)
            check(self.seq_parallel >= 1, "seq_parallel must be >= 1")
        if name in ("model_parallel", "pipeline_parallel",
                    "expert_parallel"):
            check(int(val) == 1, "%s > 1 is not ported yet" % name)
        if name == "health_monitor":
            check(int(val) == 0, "health_monitor is not ported yet")
        if name == "nonfinite_action":
            check(False, "nonfinite_action is not ported yet (it acts "
                  "through health_monitor)")
        if name == "input_divideby":
            self.input_scale = 1.0 / float(val)
        if name == "input_scale":
            self.input_scale = float(val)
        if name == "input_mean_value":
            self.input_mean = [float(x) for x in val.split(",")]
        if name.startswith("metric"):
            m = re.match(r"metric\[([^,\]]+)(?:,([^\]]+))?\]$", name)
            label_name, node_name = (m.group(1), m.group(2)) if m \
                else ("label", None)
            self.metric.add_metric(val, label_name)
            self.train_metric.add_metric(val, label_name)
            self.eval_node_names.append(node_name)
        self.cfg_pairs.append((name, val))

    def _new_net(self, cfg: NetConfig, batch_size: int,
                 infer_shapes: bool) -> NeuralNet:
        return NeuralNet(cfg, batch_size, infer_shapes=infer_shapes,
                         input_scale=self.input_scale,
                         input_mean=self.input_mean,
                         seq_parallel=self.seq_parallel,
                         compute_dtype=self.compute_dtype)

    def _resolve_eval_nodes(self) -> None:
        self.eval_nodes = [self.net_cfg.param.num_nodes - 1 if nm is None
                           else self.net_cfg.node_name_map[nm]
                           for nm in self.eval_node_names]

    def init_model(self) -> None:
        self.dev = device_mod.resolve_device(self.dev_spec)
        self.net_cfg.configure(self.cfg_pairs)
        self.net = self._new_net(self.net_cfg, self.batch_size, True)
        self._seq_nets.clear()
        self._resolve_eval_nodes()
        self.params = self.net.init_params(self.seed, self.dev)
        self._build_updaters()
        self._init_opt()

    def _build_updaters(self) -> None:
        """One Updater per (connection, weight tag), configured from the
        global then the layer's config (reference InitUpdaters,
        neural_net-inl.hpp:177-203)."""
        self.updaters = []
        for i, lay in enumerate(self.net.layers):
            ups: Dict[str, Updater] = {}
            if not self.net.is_shared[i]:
                for tag, key in lay.visit_order():
                    up = create_updater(self.net_cfg.updater_type, tag)
                    for k, v in self.net_cfg.defcfg:
                        up.set_param(k, v)
                    for k, v in self.net_cfg.layercfg[i]:
                        up.set_param(k, v)
                    ups[key] = up
            self.updaters.append(ups)

    def _init_opt(self) -> None:
        self.opt_state = [{key: up.init_state(self.params[i][key])
                           for key, up in ups.items()}
                          for i, ups in enumerate(self.updaters)]
        self.grad_accum = None
        self._metric_accum = None
        self.sample_counter = 0

    # model files (reference SaveModel/LoadModel, nnet_impl-inl.hpp:81-100)
    def save_model(self, w: serializer.Writer) -> None:
        """Net structure, epoch counter, params, then the optimizer-state
        section, in the layout the JAX package reads and writes."""
        self.net_cfg.save_net(w)
        w.write_raw(np.int64(self.epoch_counter).tobytes())
        blob = self.net.save_model_blob(self.params)
        w.write_uint64(len(blob))
        w.write_raw(blob)
        ow = serializer.Writer()
        ow.write_uint64(len(self.opt_state))
        for st in self.opt_state:
            ow.write_uint64(len(st))
            for key in sorted(st):
                ow.write_string(key)
                sub = st[key]
                ow.write_uint64(len(sub))
                for sk in sorted(sub):
                    ow.write_string(sk)
                    ow.write_tensor(sub[sk].detach().cpu().numpy())
        blob = ow.getvalue()
        w.write_raw(OPT_MAGIC)
        w.write_uint64(len(blob))
        w.write_raw(blob)

    def load_model(self, r: serializer.Reader) -> None:
        self.dev = device_mod.resolve_device(self.dev_spec)
        self.net_cfg.load_net(r)
        self.epoch_counter = int(np.frombuffer(r.read_raw(8), np.int64)[0])
        # layer params (nhidden etc.) come from the model blob, so shape
        # inference waits until it is read, as in the reference
        self.net_cfg.configure(self.cfg_pairs)
        self.net = self._new_net(self.net_cfg, self.batch_size, False)
        self._seq_nets.clear()
        self._resolve_eval_nodes()
        nbytes = r.read_uint64()
        self.params = self.net.load_model_blob(r.read_raw(nbytes), self.dev)
        self.net.infer_shapes()
        self._check_param_shapes()
        self._build_updaters()
        self._init_opt()
        self._load_opt_state(r)

    def _check_param_shapes(self) -> None:
        for i, (want, have) in enumerate(zip(self.net.param_shapes(),
                                             self.params)):
            got = {k: tuple(v.shape) for k, v in have.items()}
            check(got == want, "layer %d: model file holds params %r, the "
                  "net expects %r" % (i, got, want))

    def _load_opt_state(self, r: serializer.Reader) -> None:
        """Restore the optional optimizer-state section (magic, uint64
        length, body); without it the fresh states stay. What follows
        must be the end of the file or the training-state section, which
        is left unread."""
        magic = r.f.read(len(OPT_MAGIC))
        if magic == OPT_MAGIC:
            sr = serializer.Reader(r.read_raw(r.read_uint64()))
            n = sr.read_uint64()
            check(n == len(self.opt_state),
                  "optimizer state layer count %d != %d"
                  % (n, len(self.opt_state)))
            for st in self.opt_state:
                for _ in range(sr.read_uint64()):
                    key = sr.read_string()
                    check(key in st, "optimizer state has unknown weight "
                          "tag %r (updater type changed?)" % key)
                    for _ in range(sr.read_uint64()):
                        sk = sr.read_string()
                        val = sr.read_tensor()
                        check(sk in st[key] and
                              tuple(st[key][sk].shape) == val.shape,
                              "optimizer state %r/%r shape mismatch"
                              % (key, sk))
                        st[key][sk] = torch.from_numpy(val).to(self.dev)
            magic = r.f.read(len(STATE_MAGIC))
        check(magic in (b"", STATE_MAGIC),
              "model file: unexpected bytes %r after the model blob" % magic)

    def copy_model_from(self, r: serializer.Reader) -> None:
        """Finetune: a fresh model with the weights of the name-matched
        layers of another model copied in (reference CopyModelFrom,
        nnet_impl-inl.hpp:101-134)."""
        self.init_model()
        old_cfg = NetConfig()
        old_cfg.load_net(r)
        r.read_raw(8)  # old epoch_counter, discarded
        self.epoch_counter = 0
        old_net = self._new_net(old_cfg, 1, False)
        old_params = old_net.load_model_blob(r.read_raw(r.read_uint64()),
                                             self.dev)
        for i, old_info in enumerate(old_cfg.layers):
            if not old_info.name:
                continue
            for j, new_info in enumerate(self.net_cfg.layers):
                if new_info.name == old_info.name:
                    if self.silent == 0:
                        print("Copying layer %s" % old_info.name)
                    self.params[j].update(old_params[i])
        self._params_gen += 1
        self._check_param_shapes()
        self._init_opt()

    # training (reference Update, nnet_impl-inl.hpp:141-185)
    def start_round(self, round_: int) -> None:
        self.round = round_

    def _next_gen(self) -> torch.Generator:
        """The step's generator: a stream of its own for every update,
        derived from (seed, step count) as the JAX package folds the
        counter into its key."""
        self._rng_counter += 1
        return torch.Generator(device=self.dev).manual_seed(
            fold_in(self.seed, self._rng_counter))

    def _forward_backward(self, batch, gen: torch.Generator, keys):
        """(node values, labels, loss, gradients of the weights ``keys``)
        of one training forward with the loss on ``batch``."""
        check(self.net is not None, "model not initialized")
        check(batch.label is not None, "update needs labels")
        data, label = self._batch_tensors(batch)
        labels = self.net.label_info_from(label)
        leaves = [self.params[i][k].requires_grad_() for i, k in keys]
        values, loss = self.net.forward(self.params, data, labels=labels,
                                        train=True, gen=gen,
                                        epoch=self.epoch_counter,
                                        keep=self.eval_nodes)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return values, labels, loss.detach(), grads

    def loss_and_grads(self, batch):
        """The loss and the weight gradients (per layer, {tag: tensor} like
        ``params``) of the forward that the next ``update`` on ``batch``
        would take, its dropout stream included; steps and advances
        nothing."""
        keys = [(i, k) for i, p in enumerate(self.params) for k in p]
        gen = torch.Generator(device=self.dev).manual_seed(
            fold_in(self.seed, self._rng_counter + 1))
        _, _, loss, grads = self._forward_backward(batch, gen, keys)
        out = [{} for _ in self.params]
        for (i, k), g in zip(keys, grads):
            out[i][k] = g
        return loss, out

    def update(self, batch) -> None:
        """One mini-batch: forward with dropout and the loss, backward,
        and, every ``update_period`` batches, the optimizer step on the
        summed gradients. Train metrics stay on the device until
        ``evaluate`` reads them; nothing here waits for the device."""
        need_update = (self.sample_counter + 1) % self.update_period == 0
        # the weights the updaters step; state (BN running stats) has none
        keys = [(i, k) for i, p in enumerate(self.params) for k in p
                if k in self.updaters[i]]
        values, labels, _, grads = self._forward_backward(
            batch, self._next_gen(), keys)
        state_ups = self.net._last_state_updates
        if self.eval_train != 0 and len(self.train_metric) > 0:
            with torch.no_grad():
                outs = [values[n].reshape(values[n].shape[0], -1).float()
                        for n in self.eval_nodes]
                stats = self.train_metric.device_stats(outs, labels)
                self._metric_accum = stats if self._metric_accum is None \
                    else self._metric_accum + stats
        del values
        if self.update_period > 1:
            if self.grad_accum is None:
                self.grad_accum = grads
            else:
                for a, g in zip(self.grad_accum, grads):
                    a.add_(g)
            grads = self.grad_accum
        if need_update:
            if self.clip_global_norm > 0:
                # whole-model norm clip: one scale for every tensor
                gn = torch.sqrt(sum(torch.vdot(g.flatten(), g.flatten())
                                    for g in grads))
                scale = torch.clamp(self.clip_global_norm
                                    / gn.clamp_min(1e-12), max=1.0)
                grads = [g * scale for g in grads]
            for (i, k), g in zip(keys, grads):
                self.updaters[i][k].apply(self.params[i][k], g,
                                          self.opt_state[i][k],
                                          self.epoch_counter)
            self.grad_accum = None
        # non-gradient updates (BN running stats), every batch, after the
        # step (cxxnet_tpu/nnet/trainer.py:1061-1066)
        for (i, k), v in state_ups.items():
            self.params[i][k] = v
        if need_update or state_ups:
            self._params_gen += 1
        self.sample_counter += 1
        if self.sample_counter >= self.update_period:
            self.sample_counter = 0
            self.epoch_counter += 1

    def synchronize(self) -> None:
        """Wait until the device has finished the work queued so far."""
        if self.dev is not None and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def evaluate(self, iter_eval, data_name: str) -> str:
        """The train metrics gathered since the last call, then the
        metrics over ``iter_eval`` (any object with before_first / next /
        value, or None) with padding rows dropped (reference Evaluate,
        nnet_impl-inl.hpp:224-243)."""
        ret = ""
        if self.eval_train != 0 and len(self.train_metric):
            if self._metric_accum is not None:
                # the only host read of the train-metric sums
                self.train_metric.absorb(self._metric_accum.cpu().numpy())
                self._metric_accum = None
            ret += self.train_metric.print_str("train")
            self.train_metric.clear()
        if iter_eval is None:
            return ret
        self.metric.clear()
        if self.eval_nodes:
            iter_eval.before_first()
            while iter_eval.next():
                batch = iter_eval.value()
                outs = self._forward_nodes(batch.data,
                                           tuple(self.eval_nodes))
                keep = batch.data.shape[0] - batch.num_batch_padd
                scores = [o.reshape(o.shape[0], -1)[:keep].float().cpu()
                          .numpy() for o in outs]
                labels = self.net.label_info_from(
                    np.asarray(batch.label)[:keep])
                self.metric.add_eval(scores, labels)
        ret += self.metric.print_str(data_name)
        return ret

    def _batch_tensors(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(data, label) of a training batch on the device. On a card, a
        batch in host memory is copied into the staging ring and from
        there on a stream of its own, overlapping the steps queued before
        it; the step waits on the copy's event, which the ring waits on
        before it refills the slot. A batch already on the device, or a
        device that is not a card, is taken as it is."""
        data, label = batch.data, batch.label
        if self.dev.type != "cuda" or (isinstance(data, torch.Tensor)
                                       and data.is_cuda):
            return (self._input(data),
                    torch.as_tensor(label).to(device=self.dev,
                                              dtype=torch.float32))
        if self._staging is None:
            self._staging = StagingRing()
            self._copy_stream = torch.cuda.Stream(self.dev)
        host = self._staging.fill((np.asarray(data), np.asarray(label)))
        compute = torch.cuda.current_stream(self.dev)
        with torch.cuda.stream(self._copy_stream):
            data, label = (t.to(self.dev, non_blocking=True) for t in host)
            copied = torch.cuda.Event()
            copied.record()
        compute.wait_event(copied)
        # the copies were allocated on the copy stream: keep the allocator
        # from handing their memory out again before the step has used it
        data.record_stream(compute)
        label.record_stream(compute)
        self._staging.record(copied)
        return self._input(data), label.float()

    # inference (reference Predict / ExtractFeature, nnet_impl-inl.hpp:186-299)
    def _input(self, data) -> torch.Tensor:
        x = torch.as_tensor(data)
        if x.dim() == 2:
            x = x.reshape(x.shape[0], 1, 1, x.shape[1])
        check(x.dim() == 4, "data must be 2-D or 4-D, got shape %s"
              % (tuple(x.shape),))
        # the batch crosses in its own dtype (a uint8 batch moves a quarter
        # of the bytes) and becomes float32 on the device
        x = x.to(device=self.dev)
        if 0 in self.net.id_nodes and not x.is_floating_point():
            # token ids for an embed input stay integer
            return x
        return x.to(dtype=torch.float32)

    def _forward_nodes(self, data, node_ids: Tuple[int, ...]):
        check(self.net is not None, "model not initialized")
        with torch.no_grad():
            values, _ = self.net.forward(self.params, self._input(data))
        return [values[n] for n in node_ids]

    def predict_device(self, data) -> torch.Tensor:
        """The last node's per-row argmax (or its scalar column) as a
        (batch,) float tensor that stays on the device."""
        out = self._forward_nodes(data, (self.net_cfg.param.num_nodes - 1,))[0]
        out = out.reshape(out.shape[0], -1)
        if out.shape[1] != 1:
            return torch.argmax(out, dim=1).float()
        return out[:, 0].float()

    def predict(self, data) -> np.ndarray:
        return self.predict_device(data).cpu().numpy()

    def _resolve_node(self, node_name: str) -> int:
        """Node id from a name or a top[-k] offset (reference
        ExtractFeature resolution, nnet_impl-inl.hpp:204-215)."""
        m = re.match(r"top\[-(\d+)\]$", node_name)
        if m:
            offset = int(m.group(1))
            nnode = self.net_cfg.param.num_nodes
            check(1 <= offset <= nnode,
                  "ExtractFeature: offset must be within num_node range")
            return nnode - offset
        check(node_name in self.net_cfg.node_name_map,
              "ExtractFeature: cannot find node name: %s" % node_name)
        return self.net_cfg.node_name_map[node_name]

    def extract_feature_device(self, data, node_name: str) -> torch.Tensor:
        """The node's values on the device, in the compute dtype."""
        return self._forward_nodes(data, (self._resolve_node(node_name),))[0]

    def extract_feature(self, data, node_name: str) -> np.ndarray:
        """The node's values as a float32 host array (bf16 values under
        bf16, exactly)."""
        return self.extract_feature_device(data, node_name).float().cpu() \
            .numpy()

    # KV-cached generation (the JAX package's Trainer.generate,
    # cxxnet_tpu/nnet/trainer.py:1405-1610)
    def generate(self, prompts, n_new: int, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0,
                 prompt_lens=None) -> np.ndarray:
        """KV-cached continuation for sequence nets (embed/attention
        stacks): prompts (batch, prompt_len) of token ids -> (batch, n_new)
        int32 ids. One chunked forward over the shared prefix
        [0, min(prompt_lens)) fills every layer's k/v cache, then one
        one-token decode step per position attends against the caches. With
        ``prompt_lens`` (per-row lengths <= prompt_len) a ragged batch
        streams each row's remaining prompt tokens through the decode steps
        and every row's n_new tokens come back aligned. Temperature 0 is
        greedy; above 0 each token is drawn from softmax(logits /
        temperature), truncated to the ``top_k`` most likely first when
        top_k > 0, with row r's draws keyed on (``seed``, position, r)
        (``sample_pick``). Tokens and caches stay on the net's device until
        the one copy of the tokens at the end."""
        check(self.net is not None, "model not initialized")
        prompts = np.asarray(prompts)
        check(prompts.ndim == 2, "generate: prompts must be (batch, len)")
        b, max_p = prompts.shape
        if prompt_lens is None:
            lens = np.full(b, max_p, np.int32)
        else:
            lens = np.asarray(prompt_lens, np.int32)
            check(lens.shape == (b,) and lens.min() >= 1
                  and lens.max() <= max_p,
                  "generate: prompt_lens must be (batch,) ints in "
                  "[1, prompts.shape[1]]")
        plen = int(lens.min())
        l_max = self.net_cfg.param.input_shape[2]
        total = int(lens.max()) + n_new
        check(total <= l_max,
              "generate: prompt_len %d + n_new %d exceeds the net's "
              "sequence length %d" % (int(lens.max()), n_new, l_max))
        if n_new <= 0:
            return np.zeros((b, 0), np.int32)
        pick = sample_pick(temperature, top_k)
        toks = torch.zeros((b, l_max), dtype=torch.int64, device=self.dev)
        toks[:, :max_p] = torch.from_numpy(prompts.astype(np.int64))
        self.decode(toks, torch.from_numpy(lens).to(self.dev), plen, total,
                    pick=pick, seed=seed)
        host = toks.cpu().numpy()
        return np.stack([host[r, lens[r]:lens[r] + n_new]
                         for r in range(b)]).astype(np.int32)

    def decode(self, toks: torch.Tensor, lens: torch.Tensor, plen: int,
               total: int,
               on_probs: Optional[Callable[[int, torch.Tensor], None]] = None,
               pick=None, seed: int = 0) -> None:
        """The decode loop of ``generate`` on a (batch, l_max) int64 token
        matrix on the device, in place: a prefill of [0, plen), then one
        step per position t in [plen, total - 1). Column t + 1 keeps the
        row's own token while t + 1 < lens[row] (its prompt), else takes
        ``pick`` (``sample_pick``'s chooser; greedy by default) of the
        softmax at position t, row r drawing on (``seed``, t, r). With
        lens >= total every column keeps its token: the run is
        teacher-forced. ``on_probs(t0, probs)``, when given, sees the last
        node's probabilities for positions t0 .. t0 + n - 1 as (batch,
        vocab, n): the prefill's, then each step's."""
        b, l_max = toks.shape
        pick = pick or sample_pick(0.0, 0)
        net2 = self._net_for(b, 1)
        pre_net = self._net_for(b, plen)
        params = self._decode_params_current()
        caches = self._new_caches(net2, b, l_max, toks.device)
        last = net2.cfg.param.num_nodes - 1
        seeds = torch.full((b,), oprandom.seed_word(seed), dtype=torch.int64,
                           device=toks.device)
        rowid = torch.arange(b, device=toks.device)

        def place(t: int, probs: torch.Tensor) -> None:
            cur = toks[:, t + 1]
            toks[:, t + 1] = torch.where(t + 1 < lens, cur,
                                         pick(probs, seeds, t, rowid))

        with torch.no_grad():
            values, _ = pre_net.forward(
                params, toks[:, :plen].reshape(b, 1, 1, plen),
                decode_pos=0, kv_cache=caches)
            probs = values[last].reshape(b, -1, plen)
            if on_probs is not None:
                on_probs(0, probs)
            place(plen - 1, probs[:, :, -1])
            for t in range(plen, total - 1):
                values, _ = net2.forward(
                    params, toks[:, t:t + 1].reshape(b, 1, 1, 1),
                    decode_pos=t, kv_cache=caches)
                probs = values[last].reshape(b, -1, 1)
                if on_probs is not None:
                    on_probs(t, probs)
                place(t, probs[:, :, 0])

    def beam_generate(self, prompts, n_new: int, beam: int = 4) -> np.ndarray:
        """KV-cached beam search (the JAX package's beam_generate,
        cxxnet_tpu/nnet/trainer.py:1696-1816): width-``beam`` search over
        summed log-probabilities, returning each row's best continuation
        (batch, n_new). The beams ride the batch dimension (b * beam rows);
        each step ranks beam x vocab candidates (ties in index order, as
        ``jax.lax.top_k``) and reorders the k/v caches to the surviving
        beams' parents with one gather along the batch. Fixed horizon,
        uniform prompt lengths."""
        check(self.net is not None, "model not initialized")
        prompts = np.asarray(prompts)
        check(prompts.ndim == 2,
              "beam_generate: prompts must be (batch, len)")
        b, plen = prompts.shape
        B = int(beam)
        check(B >= 1, "beam_generate: beam must be >= 1")
        l_max = self.net_cfg.param.input_shape[2]
        total = plen + n_new
        check(total <= l_max,
              "beam_generate: prompt_len %d + n_new %d exceeds the "
              "net's sequence length %d" % (plen, n_new, l_max))
        if n_new <= 0:
            return np.zeros((b, 0), np.int32)
        net2 = self._net_for(b * B, 1)
        pre_net = self._net_for(b, plen)
        params = self._decode_params_current()
        last = net2.cfg.param.num_nodes - 1
        dev = self.dev

        def logp(probs):
            return torch.log(probs.float().clamp_min(1e-30))

        def top(x, k):      # the k largest of each row, ties by index
            srt = torch.sort(x, dim=1, descending=True, stable=True)
            return srt.values[:, :k], srt.indices[:, :k]

        toks = torch.zeros((b, l_max), dtype=torch.int64, device=dev)
        toks[:, :plen] = torch.from_numpy(prompts.astype(np.int64))
        with torch.no_grad():
            caches = self._new_caches(pre_net, b, l_max, dev)
            values, _ = pre_net.forward(
                params, toks[:, :plen].reshape(b, 1, 1, plen),
                decode_pos=0, kv_cache=caches)
            # every beam of a row starts from the row's prompt caches
            caches = {k: v.repeat_interleave(B, dim=0)
                      for k, v in caches.items()}
            lp = logp(values[last].reshape(b, -1, plen)[:, :, -1])
            V = lp.shape[1]
            k0 = min(B, V)
            scores, tok0 = top(lp, k0)                     # (b, k0)
            if k0 < B:   # vocab smaller than beam: pad dead beams
                scores = torch.cat([scores, torch.full(
                    (b, B - k0), float("-inf"), device=dev)], 1)
                tok0 = torch.cat([tok0, torch.zeros(
                    (b, B - k0), dtype=tok0.dtype, device=dev)], 1)
            hist = toks.repeat_interleave(B, dim=0)        # (b*B, l_max)
            hist[:, plen] = tok0.reshape(-1)
            for t in range(plen, total - 1):
                values, _ = net2.forward(
                    params, hist[:, t:t + 1].reshape(b * B, 1, 1, 1),
                    decode_pos=t, kv_cache=caches)
                lp = logp(values[last].reshape(b * B, -1))
                cand = (scores.reshape(b, B, 1)
                        + lp.reshape(b, B, -1)).reshape(b, -1)
                scores, idx = top(cand, B)                 # (b, B)
                rows = (torch.arange(b, device=dev)[:, None] * B
                        + idx // V).reshape(-1)
                caches = {k: v[rows] for k, v in caches.items()}
                hist = hist[rows]
                hist[:, t + 1] = (idx % V).reshape(-1)
            best = torch.argmax(scores, dim=1)
            out = hist[torch.arange(b, device=dev) * B + best, plen:total]
        return out.cpu().numpy().astype(np.int32)

    def decode_session(self, nslots: int, n_new: int,
                       temperature: float = 0.0, top_k: int = 0,
                       kv_pool: Optional["KVBlockPool"] = None
                       ) -> "DecodeSession":
        """A batched decode session over ``nslots`` KV-cache slots, the
        continuous-batching datapath (cxxnet_tpu/nnet/trainer.py:1817-1842):
        ``prefill`` admits a request into a free slot, ``step`` advances
        every active slot one token, ``retire`` frees a finished slot so the
        next request joins mid-decode. A request's tokens equal its solo
        ``generate``'s. ``kv_pool`` (``decode_kv_pool``) swaps the dense
        slot-major cache for the paged one."""
        return DecodeSession(self, nslots, n_new, temperature=temperature,
                             top_k=top_k, kv_pool=kv_pool)

    def decode_kv_pool(self, block: int, pool_tokens: int = 0,
                       prefix_reuse: bool = True,
                       bytes_cap: Optional[int] = None,
                       retained_frac: float = 1.0) -> "KVBlockPool":
        """The trainer's paged decode KV pool, made at first use and shared
        by every paged session (cxxnet_tpu/nnet/trainer.py:1843-1867).
        Keyed on the params generation: new weights or another block size
        drop the old pool (its blocks hold the old weights' k/v) and build
        a fresh one."""
        check(self.params is not None,
              "decode_kv_pool: init_model/load_model first")
        p = self._kv_pool
        if p is not None and (p.closed or p.bs != int(block)
                              or not self._is_current(p.params_key)):
            self.release_kv_pool()
            p = None
        if p is None:
            p = KVBlockPool(self, int(block), pool_tokens=pool_tokens,
                            prefix_reuse=prefix_reuse, bytes_cap=bytes_cap,
                            retained_frac=retained_frac)
            self._kv_pool = p
        return p

    def release_kv_pool(self) -> None:
        """Drop the paged pool's device tensors: its account reads 0 from
        then on. Idempotent."""
        if self._kv_pool is not None:
            self._kv_pool.release()
        self._kv_pool = None

    def _params_key(self):
        """What the decode copy and a session's caches are made from: the
        params list (reassigned by init_model / load_model) and the
        generation of its in-place changes."""
        return (self.params, self._params_gen)

    def _is_current(self, key) -> bool:
        return key[0] is self.params and key[1] == self._params_gen

    def _decode_params_current(self):
        """The params in the compute dtype for the decode paths, cast once
        per params generation (cxxnet_tpu/nnet/trainer.py:1612-1645). In
        float32 they are the master params themselves."""
        if self.compute_dtype is None:
            return self.params
        if self._decode_params is None \
                or not self._is_current(self._decode_params[0]):
            self._decode_params = (self._params_key(),
                                   self.net._cast_params_compute(self.params))
        return self._decode_params[1]

    def _net_for(self, batch_size: int, seq_len: int) -> NeuralNet:
        """The net at (batch size, sequence length) of the decode paths,
        made at its shape's first use and kept while it is among the
        ``SEQ_NETS_KEPT`` most recently used shapes (each prompt and suffix
        length of a serving loop is a shape of its own)."""
        key = (batch_size, seq_len)
        net = self._seq_nets.pop(key, None)
        if net is None:
            net = self._seq_net(batch_size, seq_len)
            if len(self._seq_nets) >= SEQ_NETS_KEPT:
                self._seq_nets.popitem(last=False)
        self._seq_nets[key] = net
        return net

    def _seq_net(self, batch_size: int, seq_len: int) -> NeuralNet:
        """A NeuralNet over the same config at another sequence length (the
        decode and prefill nets; the weights stay the trainer's)."""
        cfg2 = copy.deepcopy(self.net_cfg)
        cfg2.param.input_shape = (1, 1, seq_len)
        return self._new_net(cfg2, batch_size, True)

    def _new_caches(self, net2: NeuralNet, b: int, l_max: int, device):
        """Zeroed k/v caches of ``_decode_cache_specs``' layout, in the
        compute dtype (cxxnet_tpu/nnet/trainer.py:1694)."""
        _, keys, shapes = self._decode_cache_specs(net2, b, l_max)
        return {k: torch.zeros(sh, dtype=net2.compute_dtype or torch.float32,
                               device=device)
                for k, sh in zip(keys, shapes)}

    @staticmethod
    def _decode_cache_specs(net2: NeuralNet, b: int, l_max: int):
        """(attention connections, cache keys, cache shapes) of a decode
        net: THE cache layout contract, a (b, nkv, l_max, d_head) k and v
        cache per attention connection, keyed (connection, "k"/"v"). Also
        enforces the decode preconditions (attention present, causal)."""
        att_idx = [i for i, lay in enumerate(net2.layers)
                   if lay.type_name == "attention"]
        check(bool(att_idx), "decode: the net has no attention layers")
        for i in att_idx:
            check(bool(net2.layers[i].causal),
                  "decode: attention layer %d is not causal" % i)
        keys, shapes = [], []
        for i in att_idx:
            lay = net2.layers[i]
            d_in = net2.node_shapes[net2.cfg.layers[i].nindex_in[0]][1]
            for nm in ("k", "v"):
                keys.append((i, nm))
                shapes.append((b, lay.nkvhead or lay.nhead, l_max,
                               d_in // lay.nhead))
        return att_idx, keys, shapes

    # weight access
    def get_weight(self, layer_name: str, tag: str):
        return self.net.get_weight(self.params, layer_name, tag)

    def set_weight(self, value: np.ndarray, layer_name: str, tag: str) -> None:
        self.net.set_weight(self.params, value, layer_name, tag)
        self._params_gen += 1


def kv_gather_views(pools: Dict, tabs: torch.Tensor, bs: int) -> Dict:
    """Dense cache views gathered from block pools through block tables
    (the JAX package's _kv_gather_views, cxxnet_tpu/nnet/trainer.py
    :2127-2148): ``tabs`` (S, T) block ids, a pool (NB, 1, nkv, bs, dh) per
    cache key, each view (S, nkv, T * bs, dh), the dense session's cache
    shape, so that the step downstream computes what the dense session
    computes. Rows gathered through the scratch block, or past a slot's
    position, only ever cover causally masked positions, whose softmax
    weight is exactly zero."""
    S, T = tabs.shape
    out = {}
    for k, p in pools.items():
        g = p[tabs.reshape(-1)]                     # (S*T, 1, nkv, bs, dh)
        out[k] = g.reshape(S, T, p.shape[2], bs, p.shape[4]) \
            .transpose(1, 2).reshape(S, p.shape[2], T * bs, p.shape[4])
    return out


class KVBlockPool:
    """The device half of the paged decode KV cache (the JAX package's
    KVBlockPool, cxxnet_tpu/nnet/trainer.py:2176-2296): one pool of blocks
    per attention-cache key, (NB, 1, nkv, block, dh) in the compute dtype,
    block 0 the scratch block, and the host allocator
    (``utils.kvblocks.BlockAllocator``) that makes every placement
    decision. Shared by every paged ``DecodeSession`` of the trainer;
    ``account()["pool_bytes"]`` is the pool tensors' nbytes.

    Sizing: ``pool_tokens`` cache rows, rounded up to blocks and floored at
    one sequence of the net's length, clamped under ``bytes_cap`` when one
    is given (still floored). Exhaustion is the allocator's verdict:
    admission evicts retained blocks before it defers, and the device never
    allocates a cache row. Made by ``Trainer.decode_kv_pool`` and keyed on
    the params generation; ``release()`` drops the tensors."""

    def __init__(self, trainer: Trainer, block: int, pool_tokens: int = 0,
                 prefix_reuse: bool = True, bytes_cap: Optional[int] = None,
                 retained_frac: float = 1.0):
        check(block >= 1, "decode_kv_pool: block must be >= 1")
        self.tr = trainer
        self.bs = int(block)
        self.l_max = trainer.net_cfg.param.input_shape[2]
        check(self.l_max % self.bs == 0,
              "decode_kv_pool: block %d must divide the net's sequence "
              "length %d" % (self.bs, self.l_max))
        self.T = self.l_max // self.bs
        self.params_key = trainer._params_key()
        net1 = trainer._net_for(1, 1)
        _, self.cache_keys, shapes1 = trainer._decode_cache_specs(
            net1, 1, self.l_max)
        self.cache_dtype = net1.compute_dtype or torch.float32
        self._block_shapes = {k: (sh[0], sh[1], self.bs, sh[3])
                              for k, sh in zip(self.cache_keys, shapes1)}
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        self.block_bytes = sum(int(np.prod(sh)) * itemsize
                               for sh in self._block_shapes.values())
        usable = max(-(-int(pool_tokens) // self.bs)
                     if pool_tokens else self.T, self.T)
        if bytes_cap:
            usable = max(self.T, min(usable,
                                     int(bytes_cap) // self.block_bytes - 1))
        nb = usable + 1                       # + the scratch block 0
        self.pools = {k: torch.zeros((nb,) + self._block_shapes[k],
                                     dtype=self.cache_dtype,
                                     device=trainer.dev)
                      for k in self.cache_keys}
        self.alloc = kvblocks.BlockAllocator(nb, self.bs,
                                             prefix_reuse=prefix_reuse,
                                             retained_frac=retained_frac)
        self.closed = False
        self._sessions = weakref.WeakSet()

    @property
    def nbytes(self) -> int:
        """The pool's device footprint: its tensors' nbytes."""
        if self.closed or self.pools is None:
            return 0
        return sum(int(t.nbytes) for t in self.pools.values())

    def reservable(self, plen: int, n_new: int, toks=None) -> bool:
        return not self.closed and self.alloc.reservable(plen, n_new, toks)

    def account(self) -> Optional[dict]:
        """The allocator's tallies, ``pool_bytes`` (the tensors' nbytes)
        and the live tokens of the open sessions (a shared prefix row
        counts once per holder). None once released."""
        if self.closed:
            return None
        live = sum(s.live_tokens() for s in list(self._sessions)
                   if not s.closed)
        a = self.alloc.account()
        a.update(pool_bytes=self.nbytes, block_bytes=self.block_bytes,
                 live_tokens=live,
                 kv_live_bytes=live * (self.block_bytes // self.bs))
        return a

    def release(self) -> None:
        """Drop the device tensors; every session on the pool is dead from
        then on. Idempotent."""
        self.closed = True
        self.pools = None


class DecodeSession:
    """Continuous batching over a fixed batch of slots (the JAX package's
    DecodeSession, cxxnet_tpu/nnet/trainer.py:2298-2890).

    A session owns ``nslots`` decode slots, each with its own KV-cache row,
    position and sampling seed, scheduled one token at a time:

    * ``prefill(slot, toks, seed)`` admits one request into a free slot:
      the same b=1 prefill a solo ``generate`` of the request runs, its k/v
      written into the slot's row, and returns (first token, done);
    * ``step()`` advances every slot one token in one batched forward of
      the one-token net at batch ``nslots``, each row at its own position
      (``decode_pos`` a (nslots,) tensor) with its own cache row and its
      own draws (its request's seed, its position, row 0), so a request's
      tokens do not depend on the other slots: they are its solo
      ``generate``'s;
    * ``retire(slot)`` frees a finished slot, so the next request joins
      mid-decode.

    Every slot is stepped. A dead slot sits at position 0 and writes there,
    in its own cache row (dense) or the scratch block (paged), where nobody
    reads; an admission overwrites what its steps read before they read
    it. Positions live on the device and advance there; the host keeps the
    same books for what scheduling and the loop bounds of a step need.

    With ``kv_pool`` the k/v rows live in the trainer's block pool: the
    session holds (nslots, T) block tables, a step gathers each slot's
    dense view through its table (``kv_gather_views``), runs the same
    forward as the dense session and writes each slot's current block back;
    an admission reserves its blocks through the allocator (a resident
    shared prefix is not computed again: the suffix is prefilled against
    it) or raises ``KVPoolExhausted`` before any device work.

    One thread drives a session. It serves the weights the trainer had at
    its creation: after the params change (a reassigned params list, an
    update, set_weight) every call raises and the session is closed,
    because its caches hold the old weights' k/v."""

    def __init__(self, trainer: Trainer, nslots: int, n_new: int,
                 temperature: float = 0.0, top_k: int = 0,
                 kv_pool: Optional[KVBlockPool] = None):
        check(nslots >= 1, "decode_session: nslots must be >= 1")
        check(n_new >= 1, "decode_session: n_new must be >= 1")
        check(trainer.params is not None,
              "decode_session: init_model/load_model first")
        self.tr = trainer
        self.nslots = int(nslots)
        self.n_new = int(n_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self._params_key = trainer._params_key()
        self.l_max = trainer.net_cfg.param.input_shape[2]
        self._net = trainer._net_for(self.nslots, 1)
        _, self._cache_keys, shapes = trainer._decode_cache_specs(
            self._net, self.nslots, self.l_max)
        self._last = self._net.cfg.param.num_nodes - 1
        self._pick = sample_pick(self.temperature, self.top_k)
        dev = trainer.dev
        self.pool = kv_pool
        self._caches = None
        self._tables = None
        self._slot_blocks: List[Optional[List[int]]] = [None] * self.nslots
        if kv_pool is not None:
            check(kv_pool.tr is trainer and not kv_pool.closed
                  and trainer._is_current(kv_pool.params_key),
                  "decode_session: the kv pool belongs to another trainer "
                  "or params generation; open a fresh one through "
                  "decode_kv_pool")
            self._tables = torch.zeros((self.nslots, kv_pool.T),
                                       dtype=torch.int64, device=dev)
            kv_pool._sessions.add(self)
        else:
            cdt = self._net.compute_dtype or torch.float32
            self._caches = {k: torch.zeros(sh, dtype=cdt, device=dev)
                            for k, sh in zip(self._cache_keys, shapes)}
        self._toks = torch.zeros((self.nslots, self.l_max),
                                 dtype=torch.int64, device=dev)
        # per slot on the device: the position of its input token, 1 while
        # it still decodes (its position's advance), its request's seed,
        # and its row within the request (0: a slot holds one request)
        self._pos = torch.zeros(self.nslots, dtype=torch.int64, device=dev)
        self._live = torch.zeros_like(self._pos)
        self._seeds = torch.zeros_like(self._pos)
        self._rowid = torch.zeros_like(self._pos)
        # the host's books of the same
        self._pos_host = [0] * self.nslots
        self._active = [False] * self.nslots
        self._remaining = [0] * self.nslots
        self._plen = [0] * self.nslots
        self.closed = False

    # -- books ---------------------------------------------------------
    @property
    def active_count(self) -> int:
        return sum(self._active)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.nslots) if not self._active[s]]

    def live_tokens(self) -> int:
        """Cache rows holding k/v of active slots: each one's prompt plus
        the tokens generated so far."""
        return sum(self._plen[s] + (self.n_new - 1 - self._remaining[s])
                   for s in range(self.nslots) if self._active[s])

    def kv_account(self) -> dict:
        """The session's KV account (cxxnet_tpu/nnet/trainer.py:2412-2457):
        dense, ``kv_bytes`` is the slot-major caches' nbytes and
        ``kv_live_bytes`` its share held by live rows; paged, ``kv_bytes``
        is the blocks this session holds times the block's bytes (a shared
        block counts per holder; the pool's own account holds the
        tensors). A closed session accounts 0."""
        if self.closed:
            return {"bucket": self.nslots, "l_max": self.l_max,
                    "active": 0, "kv_bytes": 0, "kv_live_bytes": 0,
                    "live_tokens": 0, "alloc_tokens": 0}
        live = self.live_tokens()
        if self.pool is not None:
            held = sum(len(b) for b in self._slot_blocks if b)
            bb = 0 if self.pool.closed else self.pool.block_bytes
            return {"bucket": self.nslots, "l_max": self.l_max,
                    "active": self.active_count, "kv_bytes": held * bb,
                    "kv_live_bytes": live * (bb // self.pool.bs),
                    "live_tokens": live, "alloc_tokens": held * self.pool.bs,
                    "paged": 1, "blocks_held": held}
        kv_bytes = sum(int(t.nbytes) for t in self._caches.values())
        alloc = self.nslots * self.l_max
        return {"bucket": self.nslots, "l_max": self.l_max,
                "active": self.active_count, "kv_bytes": kv_bytes,
                "kv_live_bytes": int(round(kv_bytes * live / alloc)),
                "live_tokens": live, "alloc_tokens": alloc}

    def _check_live(self) -> None:
        check(not self.closed, "decode_session: session is closed")
        if self.pool is not None and self.pool.closed:
            self.closed = True
            check(False, "decode_session: the kv block pool is closed; "
                  "open a fresh session")
        if not self.tr._is_current(self._params_key):
            self.closed = True
            check(False, "decode_session: stale session: the trainer's "
                  "params changed; close it and open a new one (the slot "
                  "caches hold the old weights' k/v)")

    # -- scheduling ----------------------------------------------------
    def prefill(self, slot: int, toks, seed: int) -> Tuple[int, bool]:
        """Admit one request into free ``slot``: its b=1 prefill, then its
        rows of the session's state; returns (first token, done), done when
        ``n_new == 1`` finished the request at admission. A paged session
        raises ``KVPoolExhausted`` before any device work when the pool
        cannot hold the request now; the session stays open."""
        self._check_live()
        check(0 <= slot < self.nslots and not self._active[slot],
              "decode_session: slot %r is not free" % (slot,))
        toks = [int(t) for t in toks]
        plen = len(toks)
        check(plen >= 1, "decode_session: empty prompt")
        check(plen + self.n_new <= self.l_max,
              "decode_session: prompt len %d + n_new %d exceeds the net's "
              "sequence length %d" % (plen, self.n_new, self.l_max))
        dev = self._toks.device
        word = oprandom.seed_word(seed)
        ticket = None
        if self.pool is not None:
            ticket = self.pool.alloc.admit(toks, self.n_new)
            if ticket is None:
                a = self.pool.alloc
                raise KVPoolExhausted(
                    "decode_session: kv block pool exhausted (%d free + %d "
                    "retained of %d); the request needs %d fresh blocks: "
                    "defer its admission" % (a.free_blocks,
                                             a.retained_blocks, a.usable,
                                             a.blocks_for(plen, self.n_new)))
        try:
            t1 = torch.tensor([toks], dtype=torch.int64, device=dev)
            with torch.no_grad():
                if ticket is None:
                    caches = {k: c[slot:slot + 1]
                              for k, c in self._caches.items()}
                    probs = self._prefill(t1, 0, caches)
                else:
                    probs = self._prefill_paged(t1, ticket)
                first = self._pick(
                    probs, torch.tensor([word], device=dev), plen - 1,
                    torch.zeros(1, dtype=torch.int64, device=dev))
                self._toks[slot, :plen] = t1[0]
                self._toks[slot, plen] = first[0]
                self._seeds[slot] = word
                self._pos[slot] = plen
                self._live[slot] = int(self.n_new > 1)
                if ticket is not None:
                    self._tables[slot].zero_()
                    self._tables[slot, :len(ticket.ids)] = torch.tensor(
                        ticket.ids, dtype=torch.int64, device=dev)
            first = int(first[0])              # waits: the first token
        except Exception:
            # the session's (and a pool's) device state is unknown now
            self.closed = True
            if ticket is not None:
                self.pool.release()
            raise
        if ticket is not None:
            # publish the prompt's full blocks only once they hold its k/v
            self.pool.alloc.register(ticket, toks)
            self._slot_blocks[slot] = list(ticket.ids)
        self._active[slot] = True
        self._remaining[slot] = self.n_new - 1
        self._plen[slot] = plen
        self._pos_host[slot] = plen
        return first, self._remaining[slot] == 0

    def _prefill(self, t1: torch.Tensor, p0: int, caches) -> torch.Tensor:
        """The b=1 forward of the prompt's positions [p0, plen) into the
        row caches ``caches``; the last position's probabilities (1, V)."""
        L = t1.shape[1] - p0
        net = self.tr._net_for(1, L)
        values, _ = net.forward(self.tr._decode_params_current(),
                                t1[:, p0:].reshape(1, 1, 1, L),
                                decode_pos=p0, kv_cache=caches)
        return values[self._last].reshape(1, -1, L)[:, :, -1]

    def _prefill_paged(self, t1: torch.Tensor, ticket) -> torch.Tensor:
        """A paged admission: the slot's dense view gathered through the
        ticket's gather ids (a shared prefix's content included), the
        prefill of [p0, plen) (p0 = 0: the whole prompt, as the dense
        session), and the blocks it wrote back into the pool."""
        pool = self.pool
        plen, p0, bs = t1.shape[1], ticket.p0, pool.bs
        dev = t1.device
        grow = torch.zeros((1, pool.T), dtype=torch.int64, device=dev)
        grow[0, :len(ticket.gather_ids)] = torch.tensor(
            ticket.gather_ids, dtype=torch.int64, device=dev)
        views = kv_gather_views(pool.pools, grow, bs)
        probs = self._prefill(t1, p0, views)
        k0, k1 = p0 // bs, -(-plen // bs)
        wb = torch.tensor(ticket.ids[k0:k1], dtype=torch.int64, device=dev)
        for k, v in views.items():
            blocks = v[0, :, k0 * bs:k1 * bs].reshape(
                v.shape[1], k1 - k0, bs, v.shape[3]).transpose(0, 1)
            pool.pools[k][wb] = blocks.unsqueeze(1)
        return probs

    def step(self) -> List[Tuple[int, int, bool]]:
        """Advance every slot one token in one batched forward; waits for
        the token vector. Returns [(slot, token, done), ...] for the slots
        that still owed tokens."""
        self._check_live()
        if self.active_count == 0:
            return []
        S = self.nslots
        try:
            with torch.no_grad():
                if self.pool is not None:
                    caches = kv_gather_views(self.pool.pools, self._tables,
                                             self.pool.bs)
                else:
                    caches = self._caches
                tok = self._toks.gather(1, self._pos[:, None])
                values, _ = self._net.forward(
                    self.tr._decode_params_current(), tok.reshape(S, 1, 1, 1),
                    decode_pos=self._pos,
                    decode_span=(min(self._pos_host), max(self._pos_host)),
                    kv_cache=caches)
                nxt = self._pick(values[self._last].reshape(S, -1),
                                 self._seeds, self._pos, self._rowid)
                self._toks.scatter_(
                    1, (self._pos + 1).clamp_(max=self.l_max - 1)[:, None],
                    nxt[:, None])
                if self.pool is not None:
                    self._write_back(caches)
                self._pos += self._live
            nxt = nxt.cpu().tolist()            # waits: this iteration
        except Exception:
            self.closed = True
            if self.pool is not None:
                self.pool.release()
            raise
        out = []
        for s in range(S):
            if not self._active[s] or self._remaining[s] <= 0:
                continue
            self._pos_host[s] += 1
            self._remaining[s] -= 1
            if self._remaining[s] == 0:
                # done: its position stops (its last token's row is never
                # written: no later step reads it)
                self._live[s] = 0
            out.append((s, int(nxt[s]), self._remaining[s] == 0))
        return out

    def _write_back(self, views) -> None:
        """Each slot's current block (the only one a step writes) from its
        view back into the pool; a dead slot's table row is all scratch."""
        bs = self.pool.bs
        S = self.nslots
        bi = self._pos // bs
        wb = self._tables.gather(1, bi[:, None])[:, 0]
        rows = torch.arange(S, device=bi.device)
        for k, v in views.items():
            blk = v.reshape(S, v.shape[1], self.pool.T, bs, v.shape[3])[
                rows, :, bi]                          # (S, nkv, bs, dh)
            self.pool.pools[k][wb] = blk.unsqueeze(1)

    def retire(self, slot: int) -> None:
        """Free a finished (or abandoned) slot: it parks at position 0, and
        a paged slot's blocks go back to the allocator now, its table row
        to the scratch block, so that its writes can never land in a block
        handed out again. Never raises on a dead session."""
        if not 0 <= slot < self.nslots:
            return
        self._active[slot] = False
        self._remaining[slot] = 0
        self._plen[slot] = 0
        self._pos_host[slot] = 0
        pool_open = self.pool is not None and not self.pool.closed
        if not self.closed:
            self._live[slot] = 0
            self._pos[slot] = 0
            if pool_open:
                self._tables[slot].zero_()
        if self.pool is not None:
            ids, self._slot_blocks[slot] = self._slot_blocks[slot], None
            if ids and pool_open:
                self.pool.alloc.free(ids)

    def close(self) -> None:
        """Release the session's device state (a paged session's claims on
        the pool go back to the allocator). Idempotent."""
        if self.pool is not None and not self.pool.closed:
            for s in range(self.nslots):
                if self._slot_blocks[s]:
                    self.pool.alloc.free(self._slot_blocks[s])
                    self._slot_blocks[s] = None
        self.closed = True
        self._toks = self._caches = self._tables = None
        self._pos = self._live = self._seeds = self._rowid = None


def create_net(net_type: int = 0) -> Trainer:
    """Factory (reference CreateNet<xpu>, src/nnet/nnet.h:99-100); net_type 0
    is the threaded trainer, the only type in the reference."""
    return Trainer()
