"""Trainer: the INetTrainer surface on one device.

Counterpart of cxxnet_tpu/nnet/trainer.py (the reference's
CXXNetThreadTrainer, src/nnet/nnet_impl-inl.hpp:16-455) for the port's
slices so far: configuration, model init, model files with their
optimizer-state section, prediction and feature extraction, the training
step (``update``: forward, autograd backward, ``update_period``
accumulation, ``clip_global_norm``, one updater per weight tensor,
train metrics accumulated on the device), ``evaluate``,
``copy_model_from`` and greedy KV-cached ``generate`` for sequence nets,
and sequence parallelism (``seq_parallel = n``: the device runs n virtual
ranks of the sequence in every attention layer, and the result equals the
single-device run). On a card, a training batch from host memory goes
through the trainer's own ring of page-locked buffers and an asynchronous
copy on a stream of its own (``StagingRing``, ``_batch_tensors``). Meshes
over several devices, the health monitor,
batch-norm state updates, sampling, beam search and the training-state
section belong to later slices.
"""

from __future__ import annotations

import copy
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..layer.base import check, fold_in
from ..updater import Updater, create_updater
from ..utils import serializer
from ..utils.metric import MetricSet
from .config import NetConfig
from .net import NeuralNet

# magics of the optional sections after the model blob: optimizer state
# (written by save_model, read by load_model), then the JAX package's
# training state (save_training_state), which the port steps over
OPT_MAGIC = b"CXNOPT01"
STATE_MAGIC = b"CXTSTA01"

OptState = List[Dict[str, Dict[str, torch.Tensor]]]


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
        # generate's nets: the one-token decode net for a batch size, and
        # the prefill nets of that batch size by prompt length
        self._decode_net = None
        self._prefill_nets: Dict[int, NeuralNet] = {}

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
            check(val == "float32",
                  "compute_dtype %s is not ported yet (float32 only)" % val)
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
                         seq_parallel=self.seq_parallel)

    def _resolve_eval_nodes(self) -> None:
        self.eval_nodes = [self.net_cfg.param.num_nodes - 1 if nm is None
                           else self.net_cfg.node_name_map[nm]
                           for nm in self.eval_node_names]

    def init_model(self) -> None:
        self.dev = device_mod.resolve_device(self.dev_spec)
        self.net_cfg.configure(self.cfg_pairs)
        self.net = self._new_net(self.net_cfg, self.batch_size, True)
        self._decode_net = None
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
        self._decode_net = None
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
                                        epoch=self.epoch_counter)
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
        keys = [(i, k) for i, p in enumerate(self.params) for k in p]
        values, labels, _, grads = self._forward_backward(
            batch, self._next_gen(), keys)
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
                scores = [o.reshape(o.shape[0], -1)[:keep].cpu().numpy()
                          for o in outs]
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
        return out[:, 0]

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
        return self._forward_nodes(data, (self._resolve_node(node_name),))[0]

    def extract_feature(self, data, node_name: str) -> np.ndarray:
        return self.extract_feature_device(data, node_name).cpu().numpy()

    # KV-cached generation (the JAX package's Trainer.generate,
    # cxxnet_tpu/nnet/trainer.py:1405-1610)
    def generate(self, prompts, n_new: int, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0,
                 prompt_lens=None) -> np.ndarray:
        """Greedy KV-cached continuation for sequence nets (embed/attention
        stacks): prompts (batch, prompt_len) of token ids -> (batch, n_new)
        int32 ids. One chunked forward over the shared prefix
        [0, min(prompt_lens)) fills every layer's k/v cache, then one
        one-token decode step per position attends against the caches. With
        ``prompt_lens`` (per-row lengths <= prompt_len) a ragged batch
        streams each row's remaining prompt tokens through the decode steps
        and every row's n_new tokens come back aligned. Tokens and caches
        stay on the net's device until the one copy of the tokens at the
        end. ``temperature > 0`` (sampling) is not ported yet; ``seed``
        belongs to it."""
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
        check(int(top_k) >= 0, "generate: top_k must be >= 0")
        check(float(temperature) <= 0.0,
              "generate: sampling (temperature > 0) is not ported yet; "
              "greedy decoding takes temperature 0")
        toks = torch.zeros((b, l_max), dtype=torch.int64, device=self.dev)
        toks[:, :max_p] = torch.from_numpy(prompts.astype(np.int64))
        self.decode(toks, torch.from_numpy(lens).to(self.dev), plen, total)
        host = toks.cpu().numpy()
        return np.stack([host[r, lens[r]:lens[r] + n_new]
                         for r in range(b)]).astype(np.int32)

    def decode(self, toks: torch.Tensor, lens: torch.Tensor, plen: int,
               total: int,
               on_probs: Optional[Callable[[int, torch.Tensor], None]] = None
               ) -> None:
        """The decode loop of ``generate`` on a (batch, l_max) int64 token
        matrix on the device, in place: a prefill of [0, plen), then one
        step per position t in [plen, total - 1). Column t + 1 keeps the
        row's own token while t + 1 < lens[row] (its prompt), else takes
        the greedy pick from the softmax at position t. With lens >= total
        every column keeps its token: the run is teacher-forced.
        ``on_probs(t0, probs)``, when given, sees the last node's
        probabilities for positions t0 .. t0 + n - 1 as (batch, vocab, n):
        the prefill's, then each step's."""
        b, l_max = toks.shape
        if self._decode_net is None or self._decode_net[0] != b:
            self._decode_net = (b, self._seq_net(b, 1))
            self._prefill_nets = {}
        net2 = self._decode_net[1]
        if plen not in self._prefill_nets:
            self._prefill_nets[plen] = self._seq_net(b, plen)
        pre_net = self._prefill_nets[plen]
        _, keys, shapes = self._decode_cache_specs(net2, b, l_max)
        caches = {k: torch.zeros(sh, dtype=torch.float32, device=toks.device)
                  for k, sh in zip(keys, shapes)}
        last = net2.cfg.param.num_nodes - 1

        def place(t: int, probs: torch.Tensor) -> None:
            cur = toks[:, t + 1]
            toks[:, t + 1] = torch.where(t + 1 < lens, cur,
                                         torch.argmax(probs, dim=1))

        with torch.no_grad():
            values, _ = pre_net.forward(
                self.params, toks[:, :plen].reshape(b, 1, 1, plen),
                decode_pos=0, kv_cache=caches)
            probs = values[last].reshape(b, -1, plen)
            if on_probs is not None:
                on_probs(0, probs)
            place(plen - 1, probs[:, :, -1])
            caches = pre_net._last_cache_updates
            for t in range(plen, total - 1):
                values, _ = net2.forward(
                    self.params, toks[:, t:t + 1].reshape(b, 1, 1, 1),
                    decode_pos=t, kv_cache=caches)
                probs = values[last].reshape(b, -1, 1)
                if on_probs is not None:
                    on_probs(t, probs)
                place(t, probs[:, :, 0])
                caches = net2._last_cache_updates

    def _seq_net(self, batch_size: int, seq_len: int) -> NeuralNet:
        """A NeuralNet over the same config at another sequence length (the
        decode and prefill nets; the weights stay the trainer's)."""
        cfg2 = copy.deepcopy(self.net_cfg)
        cfg2.param.input_shape = (1, 1, seq_len)
        return self._new_net(cfg2, batch_size, True)

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


def create_net(net_type: int = 0) -> Trainer:
    """Factory (reference CreateNet<xpu>, src/nnet/nnet.h:99-100); net_type 0
    is the threaded trainer, the only type in the reference."""
    return Trainer()
