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
``_batch_tensors``). The training-state section of a model file
(``save_training_state``, ``load_training_state``,
``restore_training_state``) carries the step state that weights and
optimizer state do not, so a preempted run resumes bit for bit. With
``health_monitor = 1`` every step also computes its health vector
``[loss, grad_norm_sq, nan_grad_elems, ok]`` on the device and copies it
to page-locked memory behind an event (``last_health``, a
``StagedVector``), which the host monitor reads one step late;
``nonfinite_action = skip`` guards the step on the device, so that a
non-finite step leaves every piece of state as it was, with no host read
(``_guard_begin`` / ``_guard_end``).
Over several ranks (a ``torch.distributed`` world, one process and one
device a rank) the trainer builds a mesh (parallel/mesh.py) of ``data``,
``ep`` and ``model`` axes and trains the model that one rank trains on the
whole batch (cxxnet_tpu/nnet/trainer.py:236-420, 900-1160): each data rank
takes its rows of the batch and the gradients are summed over the data
group; ``model_parallel`` splits fullc and conv weights on their output
features, ``expert_parallel`` the moe experts (``tp_spec``);
``update_on_server`` (ZeRO-1) reduce-scatters each gradient to its
``zero_sharding`` block, steps that block's weights and optimizer state
and all-gathers the weights; ``fsdp`` (ZeRO-3) keeps each weight as its
``fsdp_shardings`` block, gathered just before its layer, whose backward
reduce-scatters the gradient. Model files, ``get_weight``, ``predict``,
``extract`` and ``evaluate`` see the whole model and batch on every rank
(``canonical_params``, ``multihost.fetch_global``): every rank calls them
together. ``pipeline_parallel = k`` adds a ``pipe`` axis: the non-loss
prefix is cut into k stages (``NeuralNet.pipeline_plan``), each pipe rank
holds only its own stage's weights and optimizer state (the last also the
loss tail's) and runs the GPipe schedule over ``pipeline_micro``
microbatches (``NeuralNet.forward_pipelined``); ``fsdp = 1`` under the
pipeline is ZeRO-1 of a stage's optimizer state over ``data``: the stage's
weights laid end to end, each data rank stepping its block of them
(cxxnet_tpu/nnet/trainer.py:411-560). ``seq_parallel`` over several ranks
is the mesh's ``sp`` axis: every sp rank runs the same rows and each
attends its shard of the sequence, the sp ranks replicas of each other.
``export_forward`` and ``export_decode`` write the inference forward and
the decode loop as ``torch.export`` programs with the weights baked in.
Every unit of device work is one of the JAX package's programs under its
name and key (``jit.train_step``, ``jit.eval_fwd``, ``jit.predict``,
``jit.decode_prefill``,
``jit.decode_step``, ``jit.decode_admit``, ``jit.beam_decode``), run
through ``_watched_jit``: the recompile detector records its first call at
a new signature as its compile (``telemetry.jit_watch``), the performance
ledger cards it from its own work account (``nnet/cost.py``), and the
trainer's spans time it (``train.h2d``, ``train.step``, ``eval.forward``,
``predict``, ``decode.*``). Under bf16, ``predict``,
``extract_feature`` and ``evaluate`` hand out float32 arrays that hold
the bf16 values (the JAX package returns bf16 arrays through ml_dtypes,
which the card's machine lacks; the conversion is exact).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import re
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..layer.base import check, fold_in
from ..ops import random as oprandom
from ..parallel import collectives
from ..parallel import mesh as mesh_mod
from ..parallel import sharding
from ..parallel.multihost import fetch_global
from ..updater import Updater, create_updater
from ..utils import checkpoint as ckpt
from ..utils import kvblocks, perf, serializer, telemetry
from . import cost
from ..utils.kvblocks import KVPoolExhausted
from ..utils.metric import MetricSet
from .config import NetConfig
from .net import NeuralNet

# magic of the optional optimizer-state section after the model blob
# (written by save_model, read by load_model); the training-state section
# that may follow it opens with ckpt.STATE_MAGIC (save_training_state)
OPT_MAGIC = b"CXNOPT01"

OptState = List[Dict[str, Dict[str, torch.Tensor]]]

# the decode paths' nets kept per trainer, by their most recent use
SEQ_NETS_KEPT = 64


class Program:
    """One of the trainer's programs: ``run`` does the work, and ``cost``
    (called with the same arguments) gives its account, ``{"flops", "bytes
    accessed"}``, which the performance ledger reads at its compile
    through ``cost_analysis``. A program takes its trainer (or session) as
    an argument and holds no reference to it, so that a replaced trainer
    is freed as soon as its last user lets go."""

    __slots__ = ("run", "cost")

    def __init__(self, run: Callable, cost: Callable):
        self.run = run
        self.cost = cost

    def __call__(self, *args, **kwargs):
        return self.run(*args, **kwargs)

    def cost_analysis(self, *args, **kwargs) -> dict:
        return self.cost(*args, **kwargs)


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


class StagedVector:
    """A small device tensor on its way to the host: copied without
    blocking into page-locked memory right after the step that made it,
    with an event recorded behind the copy. ``tolist`` waits on that event
    alone, so a host read of step N-1's vector after step N was queued
    does not wait for step N (a plain ``.cpu()`` would: copies are ordered
    on the stream)."""

    def __init__(self, t: torch.Tensor):
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def tolist(self):
        self.event.synchronize()
        return self.host.tolist()


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
        # health_monitor = 1: every step also makes its health vector
        # [loss, grad_norm_sq, nan_grad_elems, ok] on the device
        # (last_health), read by the host monitor one step late;
        # nonfinite_action = skip also keeps the old state on the device
        # when the step is non-finite (cxxnet_tpu/nnet/trainer.py:118-128)
        self.health_monitor = 0
        self.nonfinite_action = "rollback"
        self.last_health = None
        # the skip guard's copy of the tensors the updaters step in place
        self._guard_shadow: Optional[List[torch.Tensor]] = None
        # sequence parallelism: the device runs this many virtual ranks of
        # the sequence in every attention layer (doc/multichip.md:162-193)
        self.seq_parallel = 1
        # the modes over several ranks (doc/multichip.md): tensor and
        # expert parallelism, ZeRO-1 and ZeRO-3, the replica check
        self.model_parallel = 1
        self.expert_parallel = 1
        self.update_on_server = 0
        self.fsdp = 0
        self.test_on_server = 0
        # pipeline parallelism (cxxnet_tpu/nnet/trainer.py:105-106): the
        # stage count and the microbatches (0: one per stage)
        self.pipeline_parallel = 1
        self.pipeline_micro = 0
        # under a pipe axis: the stage plan and this rank's place in it
        # (_setup_pipeline); ZeRO-1's flat layout of the stage
        # (_setup_flat); the leaf that every stage differentiates
        self._pp: Optional[dict] = None
        self._flat: Optional[dict] = None
        self._anchor: Optional[torch.Tensor] = None
        self.mesh: Optional[mesh_mod.Mesh] = None
        # per layer {key: placement}: of the stored weight, of its
        # optimizer state and reduced gradient; and fsdp's gathers, per
        # layer {key: (dimension, axes)}
        self._store_spec: Optional[List[Dict[str, tuple]]] = None
        self._opt_spec: Optional[List[Dict[str, tuple]]] = None
        self._fsdp_gather: List[Dict[str, tuple]] = []
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
        # the programs by key (_watched_jit), and every key ever built: a
        # key seen before a cache clear rebuilds as rebuild_after_clear.
        # generate's programs live apart, keyed by their batch: a new batch
        # drops them (decode_cache_drop), as in the JAX package
        self._jit_cache: Dict[tuple, telemetry.JitWatch] = {}
        self._jit_seen_keys: set = set()
        self._decode_b: Optional[int] = None
        self._decode_fns: Dict[tuple, telemetry.JitWatch] = {}
        self._decode_cause = "new_signature"

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
        if name == "model_parallel":
            self.model_parallel = int(val)
            check(self.model_parallel >= 1, "model_parallel must be >= 1")
        if name == "expert_parallel":
            self.expert_parallel = int(val)
            check(self.expert_parallel >= 1, "expert_parallel must be >= 1")
        if name == "update_on_server":
            self.update_on_server = int(val)
        if name == "fsdp":
            self.fsdp = int(val)
        if name == "test_on_server":
            self.test_on_server = int(val)
        if name == "pipeline_parallel":
            self.pipeline_parallel = int(val)
            check(self.pipeline_parallel >= 1,
                  "pipeline_parallel must be >= 1")
        if name == "pipeline_micro":
            self.pipeline_micro = int(val)
            check(self.pipeline_micro >= 0, "pipeline_micro must be >= 0")
        if name == "health_monitor":
            self.health_monitor = int(val)
        if name == "nonfinite_action":
            check(val in ("rollback", "skip", "abort"),
                  "nonfinite_action must be rollback, skip, or abort")
            self.nonfinite_action = val
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
        # over several ranks seq_parallel is the mesh's sp axis; on one
        # rank, virtual ranks in every attention layer
        net = NeuralNet(cfg, batch_size, infer_shapes=infer_shapes,
                        input_scale=self.input_scale,
                        input_mean=self.input_mean,
                        seq_parallel=self.seq_parallel
                        if self.mesh is None else 1,
                        compute_dtype=self.compute_dtype)
        net.mesh = self.mesh
        return net

    def _resolve_eval_nodes(self) -> None:
        self.eval_nodes = [self.net_cfg.param.num_nodes - 1 if nm is None
                           else self.net_cfg.node_name_map[nm]
                           for nm in self.eval_node_names]

    def init_model(self) -> None:
        self.dev = device_mod.resolve_device(self.dev_spec)
        self._setup_mesh()
        self.net_cfg.configure(self.cfg_pairs)
        self.net = self._new_net(self.net_cfg, self.batch_size, True)
        self._seq_nets.clear()
        self._resolve_eval_nodes()
        self._setup_pipeline()
        self._setup_layout()
        self.params = self._place(self.net.init_params(self.seed, self.dev))
        self._build_updaters()
        self._init_opt()

    # ranks (cxxnet_tpu/nnet/trainer.py:236-420)
    def _setup_mesh(self) -> None:
        """The mesh over the world's ranks (None on one rank), with the
        JAX trainer's divisibility checks."""
        self.mesh = mesh_mod.create_mesh(
            self.model_parallel, self.expert_parallel, self.batch_size,
            pipeline_parallel=self.pipeline_parallel,
            seq_parallel=self.seq_parallel,
            pipeline_micro=self.pipeline_micro)

    def _setup_pipeline(self) -> None:
        """The stage plan under a pipe axis (None without one) and the
        JAX trainer's refusals of what it cannot place
        (cxxnet_tpu/nnet/trainer.py:435-460): a shared layer split from
        its primary, a loss-tail layer sharing a prefix weight. This rank
        owns its stage's layers, and the last stage the loss tail's."""
        self._pp = None
        if self.mesh is None or self.mesh.axis_size("pipe") <= 1:
            return
        k = self.mesh.axis_size("pipe")
        stages, first_loss = self.net.pipeline_plan(k)
        stage_of = {i: s for s, (lo, hi) in enumerate(stages)
                    for i in range(lo, hi)}
        n_layers = len(self.net.layers)
        for i in range(first_loss):
            if self.net.is_shared[i]:
                pidx = self.net_cfg.layers[i].primary_layer_index
                check(stage_of.get(pidx) == stage_of.get(i),
                      "pipeline_parallel: shared layer %d and its primary "
                      "%d must fall in the same pipeline stage" % (i, pidx))
        for i in range(first_loss, n_layers):
            if self.net.is_shared[i]:
                pidx = self.net_cfg.layers[i].primary_layer_index
                check(pidx >= first_loss,
                      "pipeline_parallel: loss-tail shared layer %d cannot "
                      "reference prefix primary %d" % (i, pidx))
        s = self.mesh.coords["pipe"]
        bounds = self.net.pipeline_boundaries(stages, first_loss)
        tail_out = {n for info in self.net_cfg.layers[first_loss:]
                    for n in info.nindex_out}
        self._pp = {"k": k, "stage": s, "stages": stages,
                    "first_loss": first_loss,
                    "owned": {i for i in range(n_layers)
                              if stage_of.get(i, k - 1) == s},
                    "n_micro": self.pipeline_micro or k,
                    "observable": set(bounds[-1]) | tail_out}

    def _owns(self, i: int) -> bool:
        """Whether this rank holds layer i's weights (all of them without
        a pipe axis)."""
        return self._pp is None or i in self._pp["owned"]

    def _check_observable(self, nodes, what: str) -> None:
        """Under the pipeline only the final live set and the loss tail's
        nodes have values (cxxnet_tpu/nnet/trainer.py:910-917,
        1240-1252)."""
        if self._pp is None:
            return
        for n in nodes:
            check(n in self._pp["observable"], what % n)

    def _setup_layout(self) -> None:
        """The placements of every weight, its optimizer state and its
        reduced gradient on the mesh (parallel/sharding.py), by the JAX
        trainer's rules (``_place_params``, ``_apply_updates``)."""
        shapes = self.net.param_shapes()
        mesh = self.mesh
        self._fsdp_gather = [{} for _ in shapes]
        if mesh is None:
            self._store_spec = [{k: () for k in p} for p in shapes]
            self._opt_spec = self._store_spec
            return
        tp = sharding.param_shardings(mesh, self.net.layers, shapes)
        if self._pp is not None:
            # a stage's weights keep their TP / EP placement; fsdp is
            # ZeRO-1 over the stage laid flat (_setup_flat), and
            # update_on_server leaves the stage's state whole, as the JAX
            # trainer's packed state (cxxnet_tpu/nnet/trainer.py:315-320,
            # 1045-1055)
            store = opt = tp
        elif self.fsdp and mesh.axis_size("data") > 1:
            store = sharding.fsdp_shardings(mesh, self.net.layers, shapes,
                                            base_shardings=tp)
            # the tensors fsdp leaves whole keep ZeRO-1 optimizer state:
            # the mode subsumes update_on_server
            opt = [{k: sp if sharding.split_of(sp) is not None
                    else sharding.zero_sharding(mesh, shapes[i][k])
                    for k, sp in p.items()} for i, p in enumerate(store)]
            for i, p in enumerate(store):
                for k, sp in p.items():
                    rel = sharding.relative(sp, tp[i][k])
                    if rel is not None:
                        self._fsdp_gather[i][k] = rel
        elif self.update_on_server:
            store = tp
            opt = [{k: sharding.zero_sharding(mesh, shapes[i][k],
                                              base_spec=tp[i][k])
                    for k in p} for i, p in enumerate(store)]
        else:
            store = opt = tp
        self._store_spec, self._opt_spec = store, opt

    def _place(self, full):
        """This rank's stored blocks of whole per-layer params (tensors or
        arrays; a copy)."""
        if self._pp is not None:
            full = [p if self._owns(i) else {} for i, p in enumerate(full)]
        return sharding.shard_params(full, self.mesh, self._store_spec,
                                     self.dev)

    def _opt_rel(self, i: int, k: str):
        """The split of weight (i, k)'s optimizer block within its stored
        block: (dimension, axes), or None when the two are the same."""
        if self.mesh is None:
            return None
        return sharding.relative(self._opt_spec[i][k], self._store_spec[i][k])

    def _opt_view(self, i: int, k: str) -> torch.Tensor:
        """The part of the stored weight (i, k) that this rank steps: its
        optimizer block (a view)."""
        w = self.params[i][k]
        if self._flat is not None:
            a, b = self._flat["seg"][(i, k)]
            return w.view(-1)[a:b]
        rel = self._opt_rel(i, k)
        if rel is None:
            return w
        dim, axes = rel
        g = self.mesh.group(axes)
        size = w.shape[dim] // g.n
        return w.narrow(dim, g.index * size, size)

    def _data_group(self):
        return self.mesh.group("data")

    def _metric_group(self):
        """The ranks whose train-metric sums add up to the whole batch's:
        the data ranks, and the pipe ranks (only the last stage's are not
        zero)."""
        return self.mesh.group(("data", "pipe"))

    def _metric_rank(self) -> bool:
        """Whether this rank carries the whole batch's restored metric
        sums: the first data rank (of the last stage under a pipeline)."""
        return self.mesh.coords["data"] == 0 and (
            self._pp is None or self._pp["stage"] == self._pp["k"] - 1)

    @property
    def _dp(self) -> int:
        return self.mesh.axis_size("data") if self.mesh is not None else 1

    def _gather_fn(self):
        """fsdp's hook for NeuralNet.forward: a layer's weight blocks
        gathered over their axes just before the layer; the gather's
        backward reduce-scatters the gradient (summed over the data
        group). None when no weight is split so."""
        fg = self._fsdp_gather
        if not any(fg):
            return None
        mesh = self.mesh

        def gather(pidx, p):
            if not fg[pidx]:
                return p
            p = dict(p)
            for k, (dim, axes) in fg[pidx].items():
                p[k] = collectives.all_gather(p[k], mesh.group(axes),
                                              dim=dim, sum_grad=True)
            return p
        return gather

    @torch.no_grad()
    def _reduce_grad(self, i: int, k: str, g: torch.Tensor) -> torch.Tensor:
        """The gradient of weight (i, k) summed over the data group, in its
        optimizer block: an all-reduce, or a reduce-scatter to its ZeRO
        block (cut further where the block splits over the model or ep
        axes too, over which the gradient is the same on every rank).
        fsdp's gathered weights arrive reduced already."""
        if self.mesh is None or k in self._fsdp_gather[i]:
            return g
        dg = self._data_group()
        rel = self._opt_rel(i, k)
        if rel is None:
            return collectives.all_reduce(g, dg)
        dim, axes = rel
        if axes[0] == "data":
            g, axes = collectives.reduce_scatter(g, dg, dim=dim), axes[1:]
        else:
            g = collectives.all_reduce(g, dg)
        if axes:
            grp = self.mesh.group(axes)
            size = g.shape[dim] // grp.n
            g = g.narrow(dim, grp.index * size, size).contiguous()
        return g

    @torch.no_grad()
    def _gather_stepped(self, i: int, k: str) -> None:
        """After a ZeRO step of (i, k)'s block: the stored weight gathered
        back whole from the ranks' blocks."""
        rel = self._opt_rel(i, k)
        if rel is None:
            return
        dim, axes = rel
        w = self.params[i][k]
        w.copy_(collectives.all_gather(self._opt_view(i, k),
                                       self.mesh.group(axes), dim=dim))

    def _replica_axes(self, spec) -> List[str]:
        """The axes over which the ranks hold the same block of a tensor
        under ``spec``: every axis it is not split over, but ``pipe``
        (a pipe rank holds its own stage's tensors)."""
        sp = sharding.split_of(spec)
        split = sp[1] if sp is not None else ()
        return [a for a in self.mesh.axis_names
                if a not in split and a != "pipe"]

    def _counted(self, i: int, k: str) -> bool:
        """Whether this rank counts its optimizer block of (i, k) in a sum
        over the world: the first rank of each replica set (ZeRO-1 of the
        pipeline splits every block over ``data``)."""
        axes = self._replica_axes(self._opt_spec[i][k])
        if self._flat is not None:
            axes = [a for a in axes if a != "data"]
        return self.mesh.is_first(axes)

    def _world_sum(self, v: torch.Tensor) -> torch.Tensor:
        """The sum of ``v`` over every rank of the mesh."""
        if self.mesh is None:
            return v
        return collectives.all_reduce(v, self.mesh.group(
            self.mesh.axis_names))

    def param_bytes(self) -> int:
        """The bytes of the weights this rank holds."""
        return sum(t.numel() * t.element_size()
                   for p in self.params for t in p.values())

    def opt_bytes(self) -> int:
        """The bytes of the optimizer state this rank holds."""
        return sum(t.numel() * t.element_size()
                   for st in self.opt_state for sub in st.values()
                   for t in sub.values())

    def check_replica_consistency(self, atol: float = 0.0) -> None:
        """``test_on_server`` (the reference's replica check,
        src/updater/async_updater-inl.hpp:148-153): every rank's stored
        weights equal those of the other ranks that hold the same block.
        Collective: every rank calls it."""
        if self.mesh is None:
            return
        for i, p in enumerate(self.params):
            for key in sorted(p):
                grp = self.mesh.group(self._replica_axes(
                    self._store_spec[i][key]))
                if grp.n == 1:
                    continue
                w = p[key].detach().reshape(1, -1)
                allw = collectives.all_gather(w, grp, dim=0)
                diff = float((allw - allw[:1]).abs().max()) \
                    if w.numel() else 0.0
                check(diff <= atol, "TestSync: layer %d %s replicas "
                      "diverged (max |diff| = %g)" % (i, key, diff))

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
        if self._pp is not None:
            for i in range(self._pp["first_loss"]):
                for key, up in self.updaters[i].items():
                    check(getattr(up, "elementwise", False),
                          "pipeline_parallel: updater '%s' for layer %d key "
                          "%s declares elementwise=False (per-tensor "
                          "reductions); the packed stage update would be "
                          "wrong for it" % (up.kind, i, key))
        self._clear_jit_cache()

    # programs (cxxnet_tpu/nnet/trainer.py:1102-1128)
    def _clear_jit_cache(self) -> None:
        """Drop every program (a new or reloaded model). The telemetry
        counter is the rebuild pressure; _jit_seen_keys survives, so the
        recompile detector calls the rebuilds rebuild_after_clear."""
        if self._jit_cache:
            telemetry.count("jit.cache_clear")
        self._jit_cache.clear()

    def _watch(self, prog: Program, name: str, cause: str, key):
        return telemetry.jit_watch(prog, name, cause=cause, key=key,
                                   probe=perf.DeviceProbe(self.dev))

    def _watched_jit(self, key, name: str, build: Callable[[], Program]):
        """Build-or-fetch the program ``key`` in ``_jit_cache``, wrapped in
        the recompile detector, which records its first call at each new
        signature with its cause: ``new_signature`` (first build of the
        key), ``rebuild_after_clear`` (the cache was cleared by a model
        init or load and a key seen before runs again) or
        ``shape_change`` (same program, new input shapes)."""
        if key not in self._jit_cache:
            cause = ("rebuild_after_clear" if key in self._jit_seen_keys
                     else "new_signature")
            self._jit_seen_keys.add(key)
            self._jit_cache[key] = self._watch(build(), name, cause, key)
        return self._jit_cache[key]

    def _init_opt(self) -> None:
        self._setup_flat()
        self.opt_state = [{key: up.init_state(self._opt_view(i, key))
                           for key, up in ups.items() if key in self.params[i]}
                          for i, ups in enumerate(self.updaters)]
        self.grad_accum = None
        self._metric_accum = None
        self.sample_counter = 0

    def _setup_flat(self) -> None:
        """ZeRO-1 inside a pipeline stage (``fsdp = 1`` under the pipe
        axis; the JAX trainer's ``_pp_zero1``, cxxnet_tpu/nnet/trainer.py
        :423-433, 471-501): the stepped tensors this rank holds laid end
        to end (``sharding.flat_blocks``, in the JAX packed row's order)
        and cut into dp blocks; data rank d steps block d, so its
        optimizer state is 1/dp of its stage's. ``seg`` maps each tensor
        to the part of it inside this rank's block (possibly empty)."""
        self._flat = None
        if (self._pp is None or not self.fsdp
                or self.mesh.axis_size("data") <= 1):
            return
        dg = self._data_group()
        keys = sorted(self._update_keys())
        offs, c, segs = sharding.flat_blocks(
            [self.params[i][k].numel() for i, k in keys], dg.n, dg.index)
        self._flat = {"keys": keys, "offs": offs, "c": c,
                      "seg": dict(zip(keys, segs))}

    def _flat_block(self, parts) -> torch.Tensor:
        """This rank's block of the flat layout from its per-tensor parts
        (the segments, in the layout's order), padded to the block size."""
        c = self._flat["c"]
        flat = torch.cat([t.reshape(-1) for t in parts]) if parts else \
            torch.zeros(0, device=self.dev)
        if flat.numel() < c:
            flat = torch.cat([flat, flat.new_zeros(c - flat.numel())])
        return flat

    def _flat_whole(self, parts) -> List[torch.Tensor]:
        """The whole stored tensors of the flat layout, from every data
        rank's segments ``parts`` (one per tensor, in order): the blocks
        gathered over ``data``, each tensor cut out of them."""
        whole = collectives.all_gather(self._flat_block(parts),
                                       self._data_group(), dim=0)
        return [whole[a:a + self.params[i][k].numel()]
                .reshape(self.params[i][k].shape)
                for (i, k), a in zip(self._flat["keys"], self._flat["offs"])]

    def _opt_block_of(self, i: int, k: str, whole, dtype=None
                      ) -> torch.Tensor:
        """This rank's optimizer block of the whole array ``whole`` laid
        out like weight (i, k)."""
        if self._flat is None:
            return sharding.shard_copy(whole, self.mesh,
                                       self._opt_spec[i][k], self.dev, dtype)
        a, b = self._flat["seg"][(i, k)]
        block = sharding.shard(torch.as_tensor(whole), self.mesh,
                               self._store_spec[i][k])
        return block.reshape(-1)[a:b].to(self.dev, dtype).contiguous() \
            .clone()

    def _whole_opt_like(self, tensors: Dict[Tuple[int, str], torch.Tensor]
                        ) -> Dict[Tuple[int, str], np.ndarray]:
        """Whole host float32 arrays of tensors laid out as this rank's
        optimizer blocks (state, reduced gradients), keyed (layer, tag):
        gathered over the mesh, and over the pipe ranks under a pipeline
        (every key of the model then). Collective."""
        out = {}
        if self._flat is not None:
            keys = self._flat["keys"]
            stored = self._flat_whole([tensors[ik].detach().float()
                                       for ik in keys])
            for (i, k), t in zip(keys, stored):
                out[(i, k)] = fetch_global(t, self.mesh,
                                           self._store_spec[i][k])
        else:
            for (i, k), t in tensors.items():
                out[(i, k)] = fetch_global(t.detach().float(), self.mesh,
                                           self._opt_spec[i][k])
        return out

    def _pipe_share(self, arrays: Dict[Tuple[int, str], np.ndarray],
                    shapes: Dict[Tuple[int, str], tuple]
                    ) -> Dict[Tuple[int, str], np.ndarray]:
        """Every pipe rank's whole arrays (keyed (layer, tag), of
        ``shapes``; a rank gives those of the layers it owns) on every
        pipe rank: one sum over the pipe group of a buffer where each key
        has one owner. Without a pipe axis ``arrays`` as given."""
        if self._pp is None:
            return arrays
        sizes = [int(np.prod(sh)) for sh in shapes.values()]
        buf = torch.zeros(sum(sizes), device=self.dev)
        off = 0
        for key, n in zip(shapes, sizes):
            if key in arrays:
                buf[off:off + n] = torch.from_numpy(
                    np.asarray(arrays[key], np.float32).reshape(-1))
            off += n
        buf = collectives.all_reduce(buf, self.mesh.group("pipe")).cpu() \
            .numpy()
        out, off = {}, 0
        for (key, sh), n in zip(shapes.items(), sizes):
            out[key] = buf[off:off + n].reshape(sh).copy()
            off += n
        return out

    def _opt_keys(self) -> List[Tuple[int, str, str]]:
        """(layer, tag, state key) of every optimizer-state tensor of the
        whole model, in the model file's order."""
        out = []
        for i, ups in enumerate(self.updaters):
            for key in sorted(ups):
                probe = ups[key].init_state(torch.zeros(1))
                out += [(i, key, sk) for sk in sorted(probe)]
        return out

    def _canonical_opt_state(self) -> List[Dict[str, Dict[str, np.ndarray]]]:
        """The whole optimizer state per layer, {tag: {state key: host
        float32 array}}, on every rank (collective)."""
        shapes = self.net.param_shapes()
        mine = {}
        for i, st in enumerate(self.opt_state):
            for key, sub in st.items():
                for sk, t in sub.items():
                    mine[(i, key, sk)] = t
        if self._flat is not None:
            whole = {}
            for sk in sorted({sk for (_, _, sk) in mine}):
                got = self._whole_opt_like({(i, k): t for (i, k, s2), t
                                            in mine.items() if s2 == sk})
                whole.update({(i, k, sk): v for (i, k), v in got.items()})
        else:
            whole = {(i, k, sk): fetch_global(t.detach().float(), self.mesh,
                                              self._opt_spec[i][k])
                     for (i, k, sk), t in mine.items()}
        whole = self._pipe_share(whole, {(i, k, sk): tuple(shapes[i][k])
                                         for i, k, sk in self._opt_keys()})
        out = [{} for _ in self.updaters]
        for (i, k, sk), v in whole.items():
            out[i].setdefault(k, {})[sk] = v
        return out

    # model files (reference SaveModel/LoadModel, nnet_impl-inl.hpp:81-100)
    def save_model(self, w: serializer.Writer) -> None:
        """Net structure, epoch counter, params, then the optimizer-state
        section, in the layout the JAX package reads and writes."""
        self.net_cfg.save_net(w)
        w.write_raw(np.int64(self.epoch_counter).tobytes())
        blob = self.net.save_model_blob(
            [{k: torch.from_numpy(v) for k, v in p.items()}
             for p in self.canonical_params()])
        w.write_uint64(len(blob))
        w.write_raw(blob)
        ow = serializer.Writer()
        opt_state = self._canonical_opt_state()
        ow.write_uint64(len(opt_state))
        for i, st in enumerate(opt_state):
            ow.write_uint64(len(st))
            for key in sorted(st):
                ow.write_string(key)
                sub = st[key]
                ow.write_uint64(len(sub))
                for sk in sorted(sub):
                    ow.write_string(sk)
                    ow.write_tensor(sub[sk])
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
        self._setup_mesh()
        self.net = self._new_net(self.net_cfg, self.batch_size, False)
        self._seq_nets.clear()
        self._resolve_eval_nodes()
        nbytes = r.read_uint64()
        self.params = self.net.load_model_blob(r.read_raw(nbytes), self.dev)
        self.net.infer_shapes()
        self._check_param_shapes()
        self._setup_pipeline()
        self._setup_layout()
        self.params = self._place(self.params)
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
        is left for ``load_training_state``: the reader stops before its
        magic."""
        magic = r.f.read(len(OPT_MAGIC))
        if magic == OPT_MAGIC:
            sr = serializer.Reader(r.read_raw(r.read_uint64()))
            n = sr.read_uint64()
            check(n == len(self.opt_state),
                  "optimizer state layer count %d != %d"
                  % (n, len(self.opt_state)))
            shapes = self.net.param_shapes()
            for i, st in enumerate(self.opt_state):
                for _ in range(sr.read_uint64()):
                    key = sr.read_string()
                    check(key in self.updaters[i], "optimizer state has "
                          "unknown weight tag %r (updater type changed?)"
                          % key)
                    for _ in range(sr.read_uint64()):
                        sk = sr.read_string()
                        val = sr.read_tensor()
                        if not self._owns(i):
                            continue    # another pipe rank's stage
                        check(sk in st[key] and
                              tuple(shapes[i][key]) == val.shape,
                              "optimizer state %r/%r shape mismatch"
                              % (key, sk))
                        st[key][sk] = self._opt_block_of(
                            i, key, val, st[key][sk].dtype)
            magic = r.f.read(len(ckpt.STATE_MAGIC))
        check(magic in (b"", ckpt.STATE_MAGIC),
              "model file: unexpected bytes %r after the model blob" % magic)
        r.f.seek(-len(magic), 1)

    # the training-state section: the host-side step state that weights and
    # optimizer state do not cover (the rng stream position, the
    # update_period phase, in-flight gradient accumulation, the train-metric
    # sums), in the JAX package's layout (cxxnet_tpu/nnet/trainer.py:695-792):
    # ckpt.STATE_MAGIC, uint64 length, then the JSON meta with sorted keys,
    # the (n_metrics, 2) float32 metric sums and the per-layer {tag: tensor}
    # gradient sums. With it a preempted run resumes bit for bit mid-round.
    def save_training_state(self, w: serializer.Writer,
                            extra: Optional[dict] = None) -> None:
        """Append the training-state section; ``extra`` carries the
        learn task's cursor (round counter, batches done in the round)."""
        sw = serializer.Writer()
        meta = {"rng_counter": int(self._rng_counter),
                "sample_counter": int(self.sample_counter)}
        if extra:
            meta.update(extra)
        ga = self._grad_accum_layers()
        ma = self._metric_accum
        if ma is not None and self.mesh is not None:
            # the whole batch's sums (every rank calls this together)
            ma = collectives.all_reduce(ma, self._metric_group())
        meta["has_grad_accum"] = ga is not None
        meta["has_metric_accum"] = ma is not None
        sw.write_string(json.dumps(meta, sort_keys=True))
        if ma is not None:
            sw.write_tensor(ma.detach().cpu().numpy().astype(np.float32))
        if ga is not None:
            sw.write_uint64(len(ga))
            for d in ga:
                sw.write_uint64(len(d))
                for key in sorted(d):
                    sw.write_string(key)
                    sw.write_tensor(d[key])
        blob = sw.getvalue()
        w.write_raw(ckpt.STATE_MAGIC)
        w.write_uint64(len(blob))
        w.write_raw(blob)

    def load_training_state(self, r: serializer.Reader) -> Optional[dict]:
        """Parse the optional training-state section into a dict (None
        without one: an older file). It is applied apart, by
        ``restore_training_state``: the learn task's continue-path eval runs
        between the two and must not consume the restored state."""
        magic = r.f.read(len(ckpt.STATE_MAGIC))
        if magic != ckpt.STATE_MAGIC:
            return None
        sr = serializer.Reader(r.read_raw(r.read_uint64()))
        meta = json.loads(sr.read_string())
        state = dict(meta)
        if meta.get("has_metric_accum"):
            state["metric_accum"] = sr.read_tensor()
        if meta.get("has_grad_accum"):
            ga = []
            for _ in range(sr.read_uint64()):
                d = {}
                for _ in range(sr.read_uint64()):
                    key = sr.read_string()
                    d[key] = sr.read_tensor()
                ga.append(d)
            state["grad_accum"] = ga
        return state

    def restore_training_state(self, state: Optional[dict]) -> None:
        """Apply a loaded training-state dict. The counters always apply;
        the accumulators only when they match the current metric set and
        net (otherwise they are dropped with a warning: correct at update
        boundaries, not bit-identical mid-accumulation)."""
        if not state:
            return
        if "rng_counter" in state:
            self._rng_counter = int(state["rng_counter"])
        if "sample_counter" in state:
            self.sample_counter = int(state["sample_counter"])
        ma = state.get("metric_accum")
        if ma is not None:
            if np.shape(ma) == (len(self.train_metric), 2):
                ma = np.asarray(ma, np.float32)
                if self.mesh is not None and not self._metric_rank():
                    # the file holds the whole batch's sums: the first
                    # data rank carries them (of the last stage under a
                    # pipeline), the others start from zero
                    ma = np.zeros_like(ma)
                self._metric_accum = torch.from_numpy(ma).to(self.dev)
            elif not self.silent:
                print("WARNING: checkpoint train-metric state does not "
                      "match the current metric set; dropped")
        ga = state.get("grad_accum")
        if ga is not None:
            shapes = self.net.param_shapes()
            ok = len(ga) == len(shapes) and all(
                set(d) == set(p)
                and all(tuple(np.shape(d[k])) == tuple(p[k]) for k in d)
                for d, p in zip(ga, shapes))
            if ok:
                self.grad_accum = [
                    self._opt_block_of(i, k, np.asarray(ga[i][k], np.float32),
                                       self.params[i][k].dtype)
                    for i, k in self._update_keys()]
            elif not self.silent:
                print("WARNING: checkpoint gradient-accumulation state "
                      "does not match the current net/parallelism config; "
                      "dropped (resume is exact only at update "
                      "boundaries)")

    def _update_keys(self) -> List[Tuple[int, str]]:
        """(layer, weight tag) of every weight the updaters step, in the
        order of ``update``'s gradient list and of ``grad_accum``."""
        return [(i, k) for i, p in enumerate(self.params) for k in p
                if k in self.updaters[i]]

    def _grad_accum_layers(self) -> Optional[List[Dict[str, np.ndarray]]]:
        """``grad_accum`` as the JAX package keeps it: one {tag: float32
        array} per layer over all of the layer's params, zeros for the
        tensors no updater steps (batch-norm running stats); None while
        nothing is accumulated."""
        if self.grad_accum is None:
            return None
        shapes = self.net.param_shapes()
        out = [{k: np.zeros(tuple(v), np.float32) for k, v in p.items()}
               for p in shapes]
        whole = self._whole_opt_like(dict(zip(self._update_keys(),
                                              self.grad_accum)))
        whole = self._pipe_share(whole, {
            (i, k): tuple(shapes[i][k]) for i, ups in enumerate(self.updaters)
            for k in ups})
        for (i, k), v in whole.items():
            out[i][k] = v
        return out

    def canonical_params(self) -> List[Dict[str, np.ndarray]]:
        """The per-layer params as host float32 arrays, {tag: array} per
        layer (the form of the model file and of ``get_weight``), whole:
        under a mesh every rank gathers them together
        (``multihost.fetch_global``)."""
        out = [{k: fetch_global(v, self.mesh, self._store_spec[i][k])
                for k, v in p.items()}
               for i, p in enumerate(self.params)]
        if self._pp is None:
            return out
        shapes = self.net.param_shapes()
        whole = self._pipe_share(
            {(i, k): v for i, p in enumerate(out) for k, v in p.items()},
            {(i, k): tuple(sh) for i, p in enumerate(shapes)
             for k, sh in p.items()})
        out = [{} for _ in shapes]
        for i, p in enumerate(shapes):
            for k in p:
                out[i][k] = whole[(i, k)]
        return out

    def load_params(self, params) -> None:
        """Take whole per-layer params (arrays or tensors, the form of
        ``canonical_params`` and ``convert.params_from_jax``): this rank
        keeps its blocks of them. The optimizer state starts afresh."""
        check(len(params) == len(self.params),
              "load_params: %d layers given, the net has %d"
              % (len(params), len(self.params)))
        self.params = self._place(params)
        self._params_gen += 1
        self._check_param_shapes_whole()
        self._init_opt()

    def _check_param_shapes_whole(self) -> None:
        for i, (want, p) in enumerate(zip(self.net.param_shapes(),
                                          self.params)):
            if not self._owns(i):
                want = {}
            got = {k: sharding.shard_shape(want[k], self.mesh,
                                           self._store_spec[i][k])
                   for k in want}
            have = {k: tuple(v.shape) for k, v in p.items()}
            check(got == have, "layer %d: params %r, the net expects %r"
                  % (i, have, got))

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
        full = self.canonical_params()
        for i, old_info in enumerate(old_cfg.layers):
            if not old_info.name:
                continue
            for j, new_info in enumerate(self.net_cfg.layers):
                if new_info.name == old_info.name:
                    if self.silent == 0:
                        print("Copying layer %s" % old_info.name)
                    full[j].update(old_params[i])
        shapes = self.net.param_shapes()
        for j, p in enumerate(full):
            got = {k: tuple(v.shape) for k, v in p.items()}
            check(got == shapes[j], "layer %d: model file holds params %r, "
                  "the net expects %r" % (j, got, shapes[j]))
        self.params = self._place(full)
        self._params_gen += 1
        self._init_opt()

    # training (reference Update, nnet_impl-inl.hpp:141-185)
    def start_round(self, round_: int) -> None:
        self.round = round_
        if self.test_on_server:
            self.check_replica_consistency()

    def _next_gen(self) -> torch.Generator:
        """The step's generator: a stream of its own for every update,
        derived from (seed, step count) as the JAX package folds the
        counter into its key."""
        self._rng_counter += 1
        return torch.Generator(device=self.dev).manual_seed(
            fold_in(self.seed, self._rng_counter))

    def _train_tensors(self, batch):
        """(data, label) of a training batch on the device."""
        check(self.net is not None, "model not initialized")
        check(batch.label is not None, "update needs labels")
        return self._batch_tensors(batch)

    def _forward_backward(self, batch, gen: torch.Generator, keys):
        """(node values, labels, loss, gradients of the weights ``keys``)
        of one training forward with the loss on ``batch``."""
        return self._forward_backward_on(*self._train_tensors(batch), gen,
                                         keys)

    def _forward_backward_on(self, data, label, gen: torch.Generator,
                             keys):
        """``_forward_backward`` on the device tensors of a batch."""
        labels = self.net.label_info_from(label)
        leaves = [self.params[i][k].requires_grad_() for i, k in keys]
        if self._pp is not None:
            if self._anchor is None:
                self._anchor = torch.zeros((), device=self.dev,
                                           requires_grad=True)
            values, loss = self.net.forward_pipelined(
                self.params, data, labels=labels, train=True, gen=gen,
                epoch=self.epoch_counter, n_micro=self._pp["n_micro"],
                plan=(self._pp["stages"], self._pp["first_loss"]),
                row_span=self._row_span(data.shape[0]), anchor=self._anchor)
            grads = torch.autograd.grad(loss, leaves + [self._anchor],
                                        allow_unused=True)[:-1]
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, grads)]
            return values, labels, loss.detach(), grads
        values, loss = self.net.forward(self.params, data, labels=labels,
                                        train=True, gen=gen,
                                        epoch=self.epoch_counter,
                                        keep=self.eval_nodes,
                                        data_sharded=self._dp > 1,
                                        gather=self._gather_fn())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return values, labels, loss.detach(), grads

    def loss_and_grads(self, batch):
        """The loss and the weight gradients (per layer, {tag: tensor} like
        ``params``) of the forward that the next ``update`` on ``batch``
        would take, its dropout stream included; steps and advances
        nothing. Under a mesh they are this rank's: its rows' part of the
        sum, of its blocks of the weights."""
        keys = [(i, k) for i, p in enumerate(self.params) for k in p]
        gen = torch.Generator(device=self.dev).manual_seed(
            fold_in(self.seed, self._rng_counter + 1))
        _, _, loss, grads = self._forward_backward(batch, gen, keys)
        out = [{} for _ in self.params]
        for (i, k), g in zip(keys, grads):
            out[i][k] = g
        return loss, out

    def _get_step(self, do_update: bool, accumulate: bool,
                  with_accum: bool, with_stats: bool,
                  with_health: bool = False):
        """The training-step program of these flags, under the JAX key."""
        k = ("train", do_update, accumulate, with_accum, with_stats,
             with_health)

        def run(tr, params, data, label):
            return tr._train_step(do_update, with_stats, data, label,
                                  with_health)

        def account(tr, params, data, label):
            return cost.train_step_cost(tr.net, params, tr.updaters,
                                        b=data.shape[0], do_update=do_update)
        return self._watched_jit(k, "jit.train_step",
                                 lambda: Program(run, account))

    def update(self, batch) -> None:
        """One mini-batch: forward with dropout and the loss, backward,
        and, every ``update_period`` batches, the optimizer step on the
        summed gradients. Train metrics stay on the device until
        ``evaluate`` reads them; nothing here waits for the device. The
        ``train.step`` span is the host's time in the step's call (its
        dispatch), as the JAX package's."""
        need_update = (self.sample_counter + 1) % self.update_period == 0
        accumulate = self.sample_counter % self.update_period != 0
        with_accum = self.update_period > 1
        with_stats = self.eval_train != 0 and len(self.train_metric) > 0
        with_health = self.health_monitor != 0
        step = self._get_step(need_update, accumulate, with_accum,
                              with_stats, with_health)
        with telemetry.span("train.h2d"):
            data, label = self._train_tensors(batch)
        with telemetry.span("train.step"):
            vec = step(self, self.params, data, label)
            self.last_health = None if vec is None else (
                StagedVector(vec) if vec.is_cuda else vec)
        if telemetry.enabled():
            telemetry.count("train.images",
                            getattr(batch, "batch_size", data.shape[0])
                            - getattr(batch, "num_batch_padd", 0))
            if need_update and with_accum:
                telemetry.count("train.accum_flush")
        self.sample_counter += 1
        if self.sample_counter >= self.update_period:
            self.sample_counter = 0
            self.epoch_counter += 1

    def _train_step(self, need_update: bool, with_stats: bool, data,
                    label, with_health: bool = False):
        """The training step's work on the device tensors of one batch;
        returns its health vector (a float32 device tensor) when
        ``with_health``, else None."""
        if with_stats:
            self._check_observable(
                self.eval_nodes, "metric node %d lives inside the "
                "pipelined prefix; with pipeline_parallel only the "
                "loss-tail nodes are observable")
        # the weights the updaters step; state (BN running stats) has none
        keys = self._update_keys()
        values, labels, loss, grads = self._forward_backward_on(
            data, label, self._next_gen(), keys)
        if self._flat is not None:
            # ZeRO-1 of the stage: the flat gradient reduce-scattered over
            # the data group, each tensor's segment of this rank's block
            grads = self._reduce_flat(keys, grads)
        elif self.mesh is not None:
            # summed over the data group, each in its optimizer block
            grads = [self._reduce_grad(i, k, g)
                     for (i, k), g in zip(keys, grads)]
        state_ups = self.net._last_state_updates
        health = ok = None
        if with_health:
            # over the FRESH gradients, before the accumulation, so that
            # the vector names the offending batch
            health, ok = self._health_vector(loss, grads, keys)
        guard = with_health and self.nonfinite_action == "skip"
        if with_stats:
            with torch.no_grad():
                if self._pp is not None and \
                        self._pp["stage"] != self._pp["k"] - 1:
                    # the loss tail runs on the last stage: the others
                    # add nothing to the sums
                    stats = torch.zeros((len(self.train_metric), 2),
                                        device=self.dev)
                else:
                    outs = [values[n].reshape(values[n].shape[0], -1)
                            .float() for n in self.eval_nodes]
                    stats = self.train_metric.device_stats(outs, labels)
                prev = self._metric_accum
                self._metric_accum = stats if prev is None else prev + stats
                if guard:
                    self._metric_accum = torch.where(
                        ok, self._metric_accum,
                        torch.zeros_like(stats) if prev is None else prev)
        del values
        if self.update_period > 1:
            with torch.no_grad():
                if guard:
                    # a bad batch adds nothing: -0.0 leaves every sum as
                    # it is, and a fresh sum starts at zero
                    grads = [g.masked_fill(~ok, -0.0 if self.grad_accum
                                           is not None else 0.0)
                             for g in grads]
                if self.grad_accum is None:
                    self.grad_accum = grads
                else:
                    for a, g in zip(self.grad_accum, grads):
                        a.add_(g)
            grads = self.grad_accum
        if guard and need_update:
            live = self._guard_begin(keys)
        if need_update:
            if self.clip_global_norm > 0:
                # whole-model norm clip: one scale for every tensor
                gn = torch.sqrt(self._norm_sq(grads, keys))
                scale = torch.clamp(self.clip_global_norm
                                    / gn.clamp_min(1e-12), max=1.0)
                grads = [g * scale for g in grads]
            for (i, k), g in zip(keys, grads):
                self.updaters[i][k].apply(self._opt_view(i, k), g,
                                          self.opt_state[i][k],
                                          self.epoch_counter)
                if self.mesh is not None and self._flat is None:
                    self._gather_stepped(i, k)
            if self._flat is not None:
                self._gather_flat()
            if guard:
                self._guard_end(live, ok)
                if self.grad_accum is not None:
                    # flushed after a good step, kept after a bad one
                    with torch.no_grad():
                        self.grad_accum = [a.masked_fill_(ok, 0.0)
                                           for a in self.grad_accum]
            else:
                self.grad_accum = None
        # non-gradient updates (BN running stats), every batch, after the
        # step (cxxnet_tpu/nnet/trainer.py:1061-1066)
        for (i, k), v in state_ups.items():
            self.params[i][k] = torch.where(ok, v, self.params[i][k]) \
                if guard else v
        if need_update or state_ups:
            self._params_gen += 1
        return health

    def _counted_grads(self, grads, keys):
        """The gradient blocks this rank counts in a sum over the world
        (each block once: ``_counted``); all of them on one rank."""
        if self.mesh is None:
            return list(grads)
        return [g for (i, k), g in zip(keys, grads) if self._counted(i, k)]

    @torch.no_grad()
    def _reduce_flat(self, keys, grads) -> List[torch.Tensor]:
        """ZeRO-1 of the stage: the stage's gradients (of ``keys``) laid
        end to end, summed over the data group with each rank keeping its
        block (one reduce-scatter), cut into the tensors' segments, in
        ``keys``' order."""
        fl = self._flat
        dg = self._data_group()
        by_key = dict(zip(keys, grads))
        flat = torch.cat([by_key[ik].reshape(-1) for ik in fl["keys"]]) \
            if grads else torch.zeros(0, device=self.dev)
        pad = fl["c"] * dg.n - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        block = collectives.reduce_scatter(flat, dg, dim=0)
        lo = dg.index * fl["c"]
        for ik, a in zip(fl["keys"], fl["offs"]):
            sa, sb = fl["seg"][ik]
            by_key[ik] = block[a + sa - lo:a + sb - lo]
        return [by_key[ik] for ik in keys]

    @torch.no_grad()
    def _gather_flat(self) -> None:
        """After the ZeRO-1 step of the stage's blocks: every stored
        tensor gathered back whole from the data ranks' blocks."""
        keys = self._flat["keys"]
        whole = self._flat_whole([self._opt_view(i, k) for i, k in keys])
        for (i, k), w in zip(keys, whole):
            self.params[i][k].copy_(w)

    @torch.no_grad()
    def _norm_sq(self, grads, keys) -> torch.Tensor:
        """The squared norm of the whole gradient over every rank's
        blocks, each counted once."""
        mine = self._counted_grads(grads, keys)
        v = sum(torch.vdot(g.flatten(), g.flatten()) for g in mine) \
            if mine else torch.zeros((), device=self.dev)
        return self._world_sum(v)

    @torch.no_grad()
    def _health_vector(self, loss, grads, keys=None):
        """``([loss, grad_norm_sq, nan_grad_elems, ok], ok)``: the float32
        vector of cxxnet_tpu/nnet/trainer.py:1026-1043 and its ``ok`` as a
        0-d bool tensor, both on the device; no host read. Under a mesh
        the loss is the whole batch's and the gradient's figures cover
        every rank's blocks once (one all-reduce of the vector), so the
        vector and ``ok`` are the same on every rank (``keys``, the
        gradients' (layer, tag), is needed there alone)."""
        lossf = loss.float()
        mine = self._counted_grads(grads, keys)
        # one flat copy, then one dot product and one count: a handful of
        # launches where a pass per tensor took ~100 (the host's dispatch
        # held a step's vector at 2 ms on the card for 16 tensors)
        flat = torch.cat([g.reshape(-1).float() for g in mine]) if mine \
            else torch.zeros(0, device=lossf.device)
        gn_sq = torch.vdot(flat, flat)
        nan_elems = torch.isnan(flat).sum().float()
        if self.mesh is not None:
            # the loss of this rank's rows, counted by one rank of each
            # model / ep / sp replica set (a pipeline's loss is the last
            # stage's; the others' is zero)
            own = self.mesh.is_first([a for a in self.mesh.axis_names
                                      if a not in ("data", "pipe")])
            lossf, gn_sq, nan_elems = self._world_sum(torch.stack(
                [lossf * float(own), gn_sq, nan_elems]))
        ok = torch.isfinite(lossf) & torch.isfinite(gn_sq)
        return torch.stack([lossf, gn_sq, nan_elems, ok.float()]), ok

    def _guard_live(self, keys) -> List[torch.Tensor]:
        """The tensors the updaters step in place: the stepped weights and
        every optimizer-state tensor, in a fixed order."""
        live = [self.params[i][k] for i, k in keys]
        for st in self.opt_state:
            for key in sorted(st):
                live.extend(st[key][sk] for sk in sorted(st[key]))
        return live

    @torch.no_grad()
    def _guard_begin(self, keys) -> List[torch.Tensor]:
        """The skip guard's first half: copy the state the update is
        about to step in place into a persistent shadow (allocated once,
        reused every step)."""
        live = self._guard_live(keys)
        sh = self._guard_shadow
        if sh is None or len(sh) != len(live) or any(
                s.shape != t.shape or s.dtype != t.dtype
                or s.device != t.device for s, t in zip(sh, live)):
            sh = self._guard_shadow = [torch.empty_like(t) for t in live]
        torch._foreach_copy_(sh, live)
        return live

    @torch.no_grad()
    def _guard_end(self, live, ok) -> None:
        """The second half: where the step was not ok, put the shadow back
        in place (``torch.where`` on the device: no host read)."""
        for t, s in zip(live, self._guard_shadow):
            torch.where(ok, t, s, out=t)

    def scale_lr(self, factor: float) -> None:
        """Multiply every updater's base learning rate by ``factor``: the
        health policy's rollback backoff, which learn_task applies again
        after each checkpoint restore (a restore rebuilds the updaters at
        their configured rate). The port reads base_lr at every step, so
        no program is rebuilt (cxxnet_tpu/nnet/trainer.py:1221-1234)."""
        if factor == 1.0:
            return
        for ups in self.updaters:
            for up in ups.values():
                up.param.base_lr *= factor
        telemetry.count("health.lr_backoff")

    def synchronize(self) -> None:
        """Wait until the device has finished the work queued so far."""
        if self.dev is not None and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def on_device(self):
        """A context that makes the trainer's card the calling thread's
        current device (a nullcontext on the CPU). The current device is
        thread-local in torch: a thread other than the one that built the
        net (the serving frontend's worker) enters it around every call,
        so its launches go to the card and its default stream, where the
        net's tensors and the kernels' launches live."""
        if self.dev is None or self.dev.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.dev)

    def evaluate(self, iter_eval, data_name: str) -> str:
        """The train metrics gathered since the last call, then the
        metrics over ``iter_eval`` (any object with before_first / next /
        value, or None) with padding rows dropped (reference Evaluate,
        nnet_impl-inl.hpp:224-243)."""
        ret = ""
        if self.eval_train != 0 and len(self.train_metric):
            if self._metric_accum is not None:
                ma = self._metric_accum
                if self.mesh is not None:
                    # the whole batch's sums (every rank calls evaluate)
                    ma = collectives.all_reduce(ma, self._metric_group())
                # the only host read of the train-metric sums
                self.train_metric.absorb(ma.cpu().numpy())
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
        data, label = self._rows(batch.data), self._rows(batch.label)
        if self.dev.type != "cuda" or (isinstance(data, torch.Tensor)
                                       and data.is_cuda):
            if not (isinstance(label, torch.Tensor)
                    and label.device == self.dev):
                telemetry.count("io.h2d_bytes", int(np.asarray(label).nbytes))
            return (self._input(data),
                    torch.as_tensor(label).to(device=self.dev,
                                              dtype=torch.float32))
        telemetry.count("io.h2d_bytes", int(np.asarray(data).nbytes
                                            + np.asarray(label).nbytes))
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

    def _rows(self, x):
        """This data rank's rows of a training batch: the batch is either
        the whole one (its rows split over the data group) or already this
        rank's (rows * dp == batch_size, a corpus read in shards, as
        cxxnet_tpu/nnet/trainer.py:1142-1158 takes a process's local
        rows)."""
        dp = self._dp
        if dp == 1 or x is None:
            return x
        n = int(x.shape[0])
        if n * dp == self.batch_size:
            return x
        check(n % dp == 0, "a batch of %d rows does not split over %d data "
              "ranks (batch_size %d)" % (n, dp, self.batch_size))
        if self._pp is not None:
            return self._micro_rows(x)
        d = self.mesh.coords["data"]
        return x[d * (n // dp):(d + 1) * (n // dp)]

    def _micro_rows(self, x):
        """Under a pipeline, this data rank's rows of each microbatch, in
        microbatch order: the JAX pipeline cuts the batch into microbatches
        first and shards each over ``data``
        (cxxnet_tpu/nnet/net.py:996-1008)."""
        nm, dp = self._pp["n_micro"], self._dp
        n = int(x.shape[0])
        check(n % nm == 0 and (n // nm) % dp == 0,
              "microbatch size (batch_size / pipeline_micro) must be "
              "divisible by the data-parallel degree")
        mb = n // nm
        mbd, d = mb // dp, self.mesh.coords["data"]
        parts = [x[m * mb + d * mbd:m * mb + (d + 1) * mbd]
                 for m in range(nm)]
        return torch.cat(parts) if torch.is_tensor(x) else \
            np.concatenate(parts)

    def _row_span(self, rows: int):
        """Microbatch m's place in the whole batch, (rows of the whole
        batch, its first row), for ``rows`` rows on this rank: the random
        layers draw the whole batch's noise and keep those rows."""
        nm, dp = self._pp["n_micro"], self._dp
        mbd = rows // nm
        d = self.mesh.coords["data"]
        return lambda m: (rows * dp, m * mbd * dp + d * mbd)

    def _eval_forward(self, x: torch.Tensor, nodes):
        """The eval forward's values of ``nodes`` on ``x``, whole on every
        rank:
        rows that split over the data group run split, each rank its rows,
        and the values come back gathered; others run whole on every
        rank."""
        if self._pp is not None:
            return self._eval_forward_pipelined(x, nodes)
        dp = self._dp
        sharded = dp > 1 and x.shape[0] % dp == 0
        if sharded:
            d = self.mesh.coords["data"]
            b = x.shape[0] // dp
            x = x[d * b:(d + 1) * b]
        values, _ = self.net.forward(self.params, x, data_sharded=sharded,
                                     gather=self._gather_fn())
        values = [values[n] for n in nodes]
        if sharded:
            g = self._data_group()
            values = [collectives.all_gather(v, g, dim=0) for v in values]
        return values

    def _eval_forward_pipelined(self, x: torch.Tensor, nodes):
        """The pipelined eval forward (cxxnet_tpu/nnet/trainer.py:1237-
        1252): the microbatches through the stages, the tail on the last
        stage, whose values of ``nodes`` every rank then holds whole. Each
        microbatch splits over the data ranks where its rows divide."""
        self._check_observable(
            nodes, "node %d lives inside the pipelined prefix; with "
            "pipeline_parallel only loss-tail nodes are observable")
        nm, dp = self._pp["n_micro"], self._dp
        n = x.shape[0]
        check(n % nm == 0, "pipeline_parallel: batch_size %d not divisible "
              "by %d microbatches" % (n, nm))
        sharded = dp > 1 and (n // nm) % dp == 0
        xs = self._micro_rows(x) if sharded else x
        values, _ = self.net.forward_pipelined(
            self.params, xs, train=False, n_micro=nm,
            plan=(self._pp["stages"], self._pp["first_loss"]))
        last = self._pp["stage"] == self._pp["k"] - 1
        codes = torch.tensor([float(_DTYPES.index(values[nd].dtype))
                              if last else 0.0 for nd in nodes],
                             device=self.dev)
        pg = self.mesh.group("pipe")
        codes = collectives.all_reduce(codes, pg).tolist()
        out = []
        for nd, code in zip(nodes, codes):
            dt = _DTYPES[int(code)]
            shape = (xs.shape[0],) + tuple(self.net.node_shapes[nd][1:])
            v = values[nd].float() if last else \
                torch.zeros(shape, device=self.dev)
            v = collectives.all_reduce(v.contiguous(), pg).to(dt)
            if sharded:
                v = collectives.all_gather(v, self._data_group(), dim=0)
                # (data rank, microbatch, row) -> the batch's order
                v = v.reshape(dp, nm, n // nm // dp, *v.shape[1:]) \
                    .transpose(0, 1).reshape(n, *v.shape[1:])
            out.append(v)
        return out

    # inference (reference Predict / ExtractFeature, nnet_impl-inl.hpp:186-299)
    def _input(self, data) -> torch.Tensor:
        on_device = isinstance(data, torch.Tensor) and data.device == self.dev
        x = torch.as_tensor(data)
        if x.dim() == 2:
            x = x.reshape(x.shape[0], 1, 1, x.shape[1])
        check(x.dim() == 4, "data must be 2-D or 4-D, got shape %s"
              % (tuple(x.shape),))
        # the batch crosses in its own dtype (a uint8 batch moves a quarter
        # of the bytes) and becomes float32 on the device; a host batch's
        # bytes count in io.h2d_bytes, as the JAX package counts them
        if not on_device:
            telemetry.count("io.h2d_bytes", x.nbytes)
        x = x.to(device=self.dev)
        if 0 in self.net.id_nodes and not x.is_floating_point():
            # token ids for an embed input stay integer
            return x
        return x.to(dtype=torch.float32)

    def _forward_nodes(self, data, node_ids: Tuple[int, ...]):
        """The eval forward's values of ``node_ids`` (the ``jit.eval_fwd``
        program of the JAX key ``("fwd", node_ids)``)."""
        check(self.net is not None, "model not initialized")
        node_ids = tuple(node_ids)

        def run(tr, params, x):
            with torch.no_grad():
                return tr._eval_forward(x, node_ids)

        def account(tr, params, x):
            return cost.forward_cost(tr.net, params, b=x.shape[0])
        prog = self._watched_jit(("fwd", node_ids), "jit.eval_fwd",
                                 lambda: Program(run, account))
        x = self._input(data)
        with telemetry.span("eval.forward"):
            return prog(self, self.params, x)

    def predict_device(self, data) -> torch.Tensor:
        """The last node's per-row argmax (or its scalar column) as a
        (batch,) float tensor that stays on the device (the ``jit.predict``
        program)."""
        check(self.net is not None, "model not initialized")
        node = self.net_cfg.param.num_nodes - 1

        def run(tr, params, x):
            with torch.no_grad():
                out = tr._eval_forward(x, (node,))[0]
            out = out.reshape(x.shape[0], -1)
            if out.shape[1] != 1:
                return torch.argmax(out, dim=1).float()
            return out[:, 0].float()

        def account(tr, params, x):
            # the forward, and the argmax's comparison per last-node value
            n = 1
            for v in tr.net.node_shapes[node][1:]:
                n *= int(v)
            return cost.forward_cost(tr.net, params, b=x.shape[0],
                                     extra_flops=float(x.shape[0] * n))
        prog = self._watched_jit(("pred", node), "jit.predict",
                                 lambda: Program(run, account))
        x = self._input(data)
        with telemetry.span("predict"):
            return prog(self, self.params, x)

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
        with telemetry.span("decode.generate", new_tokens=n_new):
            toks = torch.zeros((b, l_max), dtype=torch.int64,
                               device=self.dev)
            toks[:, :max_p] = torch.from_numpy(prompts.astype(np.int64))
            self.decode(toks, torch.from_numpy(lens).to(self.dev), plen,
                        total, pick=pick, seed=seed,
                        sampling=(temperature, top_k))
            host = toks.cpu().numpy()
        telemetry.count("decode.tokens", int(b) * int(n_new))
        return np.stack([host[r, lens[r]:lens[r] + n_new]
                         for r in range(b)]).astype(np.int32)

    def decode(self, toks: torch.Tensor, lens: torch.Tensor, plen: int,
               total: int,
               on_probs: Optional[Callable[[int, torch.Tensor], None]] = None,
               pick=None, seed: int = 0, sampling=(0.0, 0)) -> None:
        """The decode loop of ``generate`` on a (batch, l_max) int64 token
        matrix on the device, in place: a prefill of [0, plen), then one
        step per position t in [plen, total - 1). Column t + 1 keeps the
        row's own token while t + 1 < lens[row] (its prompt), else takes
        ``pick`` (``sample_pick``'s chooser; greedy by default) of the
        softmax at position t, row r drawing on (``seed``, t, r). With
        lens >= total every column keeps its token: the run is
        teacher-forced. ``on_probs(t0, probs)``, when given, sees the last
        node's probabilities for positions t0 .. t0 + n - 1 as (batch,
        vocab, n): the prefill's, then each step's. The prefill and the
        steps are the ``jit.decode_prefill`` and ``jit.decode_step``
        programs of the JAX key ``("decode", b, plen, total, temperature,
        top_k)`` (``sampling`` is the (temperature, top_k) ``pick`` draws
        at). Where a reader wants the card's times (a trace context, the
        telemetry log or the performance ledger), the host waits for the
        first token (``first_token``, the ``decode.prefill`` span) and for
        the last (``decode.decode``); else the steps queue behind the
        prefill with no wait and the spans are the host's."""
        b = toks.shape[0]
        pick = pick or sample_pick(0.0, 0)
        pre_fn, dec_fn = self._decode_programs(
            b, (plen, total, float(sampling[0]), int(sampling[1])))
        nets = (self._net_for(b, 1), self._net_for(b, plen))
        params = self._decode_params_current()
        seeds = torch.full((b,), oprandom.seed_word(seed), dtype=torch.int64,
                           device=toks.device)
        rowid = torch.arange(b, device=toks.device)
        t0 = time.perf_counter()
        # a served request's TTFT boundary (servd's trace context) and the
        # ledger's decode series are the card's times, not the launch
        # queue's: only their readers make the host wait
        timed = telemetry.current_trace() is not None \
            or telemetry.enabled() or perf.enabled()
        caches = pre_fn(nets, params, toks, lens, seeds, rowid, pick,
                        on_probs)
        if timed:
            toks[:, plen].cpu()
        t_first = time.perf_counter()
        telemetry.mark("first_token")
        telemetry.span_event("decode.prefill", t0, t_first - t0)
        if total > plen + 1:
            dec_fn(nets, params, toks, lens, caches, seeds, rowid, pick,
                   on_probs)
            if timed:
                toks[:, total - 1].cpu()
            telemetry.span_event("decode.decode", t_first,
                                 time.perf_counter() - t_first,
                                 tokens=int(b * (total - plen - 1)))

    def _decode_programs(self, b: int, fkey: tuple):
        """generate's prefill and step-loop programs at batch b for
        ``fkey`` = (plen, total, temperature, top_k). Another batch drops
        every decode program first (cause ``decode_cache_drop``,
        cxxnet_tpu/nnet/trainer.py:1450-1470)."""
        if self._decode_b != b:
            if self._decode_b is not None:
                telemetry.count("decode.cache_drop")
                self._decode_cause = "decode_cache_drop"
            else:
                self._decode_cause = "new_signature"
            self._decode_b = b
            self._decode_fns = {}
        if fkey in self._decode_fns:
            return self._decode_fns[fkey]
        plen, total = fkey[0], fkey[1]
        l_max = self.net_cfg.param.input_shape[2]

        def place(toks, lens, t, probs, pick, seeds, rowid):
            cur = toks[:, t + 1]
            toks[:, t + 1] = torch.where(t + 1 < lens, cur,
                                         pick(probs, seeds, t, rowid))

        def prefill(nets, params, toks, lens, seeds, rowid, pick, on_probs):
            net2, pre_net = nets
            last = pre_net.cfg.param.num_nodes - 1
            caches = Trainer._new_caches(net2, b, l_max, toks.device)
            with torch.no_grad():
                values, _ = pre_net.forward(
                    params, toks[:, :plen].reshape(b, 1, 1, plen),
                    decode_pos=0, kv_cache=caches)
                probs = values[last].reshape(b, -1, plen)
                if on_probs is not None:
                    on_probs(0, probs)
                place(toks, lens, plen - 1, probs[:, :, -1], pick, seeds,
                      rowid)
            return caches

        def steps(nets, params, toks, lens, caches, seeds, rowid, pick,
                  on_probs):
            net2 = nets[0]
            last = net2.cfg.param.num_nodes - 1
            with torch.no_grad():
                for t in range(plen, total - 1):
                    values, _ = net2.forward(
                        params, toks[:, t:t + 1].reshape(b, 1, 1, 1),
                        decode_pos=t, kv_cache=caches)
                    probs = values[last].reshape(b, -1, 1)
                    if on_probs is not None:
                        on_probs(t, probs)
                    place(toks, lens, t, probs[:, :, 0], pick, seeds, rowid)

        def prefill_cost(nets, params, *_):
            return cost.forward_cost(nets[1], params, b, q_offs=[0] * b)

        def steps_cost(nets, params, *_):
            # the whole loop of total - plen - 1 one-token steps, as the
            # JAX package's scan program covers it
            return cost.decode_loop_cost(nets[0], params, b,
                                         range(plen, total - 1))
        key = ("decode", b) + tuple(fkey)
        progs = (self._watch(Program(prefill, prefill_cost),
                             "jit.decode_prefill", self._decode_cause, key),
                 self._watch(Program(steps, steps_cost), "jit.decode_step",
                             self._decode_cause, key))
        self._decode_fns[fkey] = progs
        return progs

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
        key = ("beam", b, B, plen, total)

        def account(tr, params, toks):
            c = cost.forward_cost(tr._net_for(b, plen), params, b,
                                  q_offs=[0] * b)
            loop = cost.decode_loop_cost(tr._net_for(b * B, 1), params,
                                         b * B, range(plen, total - 1))
            return {k: c[k] + loop[k] for k in c}
        prog = self._watched_jit(
            key, "jit.beam_decode",
            lambda: Program(lambda tr, params, toks: tr._beam_search(
                params, toks, b, B, plen, total), account))
        toks = torch.zeros((b, l_max), dtype=torch.int64, device=self.dev)
        toks[:, :plen] = torch.from_numpy(prompts.astype(np.int64))
        with telemetry.span("decode.beam", beam=B):
            out = prog(self, self._decode_params_current(),
                       toks).cpu().numpy()
        return out.astype(np.int32)

    def _beam_search(self, params, toks: torch.Tensor, b: int, B: int,
                     plen: int, total: int) -> torch.Tensor:
        """The beam search of ``beam_generate`` on the (b, l_max) prompt
        token matrix: the best continuation of each row, (b, n_new)."""
        l_max = toks.shape[1]
        net2 = self._net_for(b * B, 1)
        pre_net = self._net_for(b, plen)
        last = net2.cfg.param.num_nodes - 1
        dev = toks.device

        def logp(probs):
            return torch.log(probs.float().clamp_min(1e-30))

        def top(x, k):      # the k largest of each row, ties by index
            srt = torch.sort(x, dim=1, descending=True, stable=True)
            return srt.values[:, :k], srt.indices[:, :k]

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
            return hist[torch.arange(b, device=dev) * B + best, plen:total]

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

    def expected_decode_grid(self, buckets, plens, temperature:
                             float = 0.0, top_k: int = 0,
                             kv_block: int = 0):
        """Enumerate the EXPECTED serving program grid as ``(key,
        bucket_label)`` pairs — the jit-cache keys a serving datapath
        over these ``buckets`` (slot counts) and ``plens`` (declared
        prompt lengths, ``serve_plen_buckets``) will compile, exactly
        as ``DecodeSession`` keys them (the JAX package's enumeration,
        cxxnet_tpu/nnet/trainer.py:1879-1928). Feeding the pairs to
        ``perf.Ledger.set_expected_grid`` turns the compile flight
        recorder into the warm-grid readiness account (doc/
        observability.md): warm-vs-expected per bucket,
        ``cxxnet_ready_programs_pct``, the ``warming`` health state.

        Pure enumeration — no params, no device, no compile. Prefill
        keys land under the ``"prefill"`` bucket label (they are
        per-prompt-length, shared by every slot bucket); admit/step
        keys under their slot count. The paged suffix-prefill reuse
        variants (``p0 > 0`` — one per observed shared-prefix length)
        are deliberately NOT enumerated: their population is
        input-dependent, so they compile lazily and simply do not
        gate readiness."""
        temperature, top_k = float(temperature), int(top_k)
        grid = []
        for plen in sorted({int(p) for p in plens}):
            check(plen >= 1, "expected_decode_grid: plen must be >= 1")
            if kv_block > 0:
                l_max = self.net_cfg.param.input_shape[2]
                bs = int(kv_block)
                check(l_max % bs == 0,
                      "expected_decode_grid: kv_block %d must divide "
                      "the net's sequence length %d" % (bs, l_max))
                grid.append((("sess_prefill_paged", plen, 0,
                              l_max // bs, bs, temperature, top_k),
                             "prefill"))
            else:
                grid.append((("sess_prefill", plen, temperature,
                              top_k), "prefill"))
        for b in sorted({max(1, int(b)) for b in buckets}):
            if kv_block > 0:
                l_max = self.net_cfg.param.input_shape[2]
                bs = int(kv_block)
                T = l_max // bs
                grid.append((("sess_admit_paged", b, T), str(b)))
                grid.append((("sess_step_paged", b, T, bs,
                              temperature, top_k), str(b)))
            else:
                grid.append((("sess_admit", b), str(b)))
                grid.append((("sess_step", b, temperature, top_k),
                             str(b)))
        return grid

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
        if self.compute_dtype is None and self.mesh is None:
            return self.params
        if self._decode_params is None \
                or not self._is_current(self._decode_params[0]):
            # under a mesh the decode paths take the whole weights (every
            # rank gathers them together) and run the single-rank layers
            params = self.params if self.mesh is None else \
                [{k: torch.from_numpy(v).to(self.dev) for k, v in p.items()}
                 for p in self.canonical_params()]
            if self.compute_dtype is not None:
                params = self.net._cast_params_compute(params)
            self._decode_params = (self._params_key(), params)
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

    @staticmethod
    def _new_caches(net2: NeuralNet, b: int, l_max: int, device):
        """Zeroed k/v caches of ``_decode_cache_specs``' layout, in the
        compute dtype (cxxnet_tpu/nnet/trainer.py:1694)."""
        _, keys, shapes = Trainer._decode_cache_specs(net2, b, l_max)
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

    # exported serving programs (cxxnet_tpu/nnet/trainer.py:1930-2061)
    def _export_params(self) -> List[Dict[str, torch.Tensor]]:
        """The weights an exported program bakes in: ``canonical_params``
        on the trainer's device, each floating non-state tensor in the
        compute dtype (the cast the net's forward makes; the decode paths'
        copy)."""
        params = [{k: torch.from_numpy(v).to(self.dev) for k, v in p.items()}
                  for p in self.canonical_params()]
        if self.compute_dtype is not None:
            params = self.net._cast_params_compute(params)
        return params

    def export_decode(self, batch_size: int, prompt_len: int
                      ) -> Tuple[bytes, bytes]:
        """Export the KV-cached decode loop as TWO self-contained programs
        (``torch.export``, params baked in; loading one needs torch and,
        for the ``cxxnet::`` kernel ops it holds, ``ops.library``):

        * prefill: (batch, prompt_len) int32 tokens ->
          (last-position softmax row, cache tuple)
        * step:    ((batch,) int32 token, () int32 position, cache tuple)
          -> (softmax row, updated cache tuple)

        The serving host drives its own loop (sampling policy, stop
        conditions, batching) and threads the cache tuple between calls —
        ``api.load_decode`` ships a reference loop. The step returns new
        caches and leaves the ones it was given as they were (the JAX
        contract; the port's own decode writes its caches in place). The
        caches are ``_decode_cache_specs``' layout in the compute dtype.
        Returns (prefill_bytes, step_bytes), each a ``CXTF`` frame
        (utils/artifact.py) whose header carries the cache fingerprint.

        An artifact runs on the device type it was exported on (the
        trainer's ``dev``)."""
        check(self.params is not None,
              "export_decode: init_model/load_model first")
        b, plen = int(batch_size), int(prompt_len)
        l_max = self.net_cfg.param.input_shape[2]
        check(0 < plen <= l_max,
              "export_decode: prompt_len must be in [1, %d]" % l_max)
        net2, pre_net = self._seq_net(b, 1), self._seq_net(b, plen)
        _, cache_keys, cache_shapes = self._decode_cache_specs(net2, b,
                                                               l_max)
        cache_dtype = net2.compute_dtype or torch.float32
        last = net2.cfg.param.num_nodes - 1

        def prefill(params, toks):
            caches = {k: torch.zeros(sh, dtype=cache_dtype,
                                     device=toks.device)
                      for k, sh in zip(cache_keys, cache_shapes)}
            values, _ = pre_net.forward(params, toks.reshape(b, 1, 1, plen),
                                        decode_pos=0, kv_cache=caches)
            cu = pre_net._last_cache_updates
            probs = values[last].reshape(b, -1, plen)[:, :, -1]
            return probs, tuple(cu[k] for k in cache_keys)

        def step(params, tok, pos, caches):
            # every row at the one position: the per-row step of a session,
            # its chunk loop (decode_chunk) over the whole cache, whose
            # chunks past a row's position are wholly masked
            rowpos = pos.to(torch.int64).reshape(1).expand(b)
            caches = {k: c.clone() for k, c in zip(cache_keys, caches)}
            values, _ = net2.forward(params, tok.reshape(b, 1, 1, 1),
                                     decode_pos=rowpos,
                                     decode_span=(0, l_max - 1),
                                     kv_cache=caches)
            cu = net2._last_cache_updates
            return (values[last].reshape(b, -1),
                    tuple(cu[k] for k in cache_keys))

        from ..utils import artifact
        params = self._export_params()
        i32 = dict(dtype=torch.int32, device=self.dev)
        caches = tuple(torch.zeros(sh, dtype=cache_dtype, device=self.dev)
                       for sh in cache_shapes)
        pre_b = _export_program(prefill, params,
                                (torch.zeros((b, plen), **i32),))
        step_b = _export_program(step, params,
                                 (torch.zeros((b,), **i32),
                                  torch.zeros((), **i32), caches))
        meta = {"cache_fingerprint": artifact.cache_fingerprint(
                    cache_keys, cache_shapes, cache_dtype),
                "batch": b, "prompt_len": plen, "l_max": int(l_max)}
        return (artifact.frame("decode_prefill", meta, pre_b),
                artifact.frame("decode_step", meta, step_b))

    def export_forward(self, node_name: str = "",
                       batch_size: int = 0) -> bytes:
        """Export the inference forward as a self-contained program
        (``torch.export``): the trained params are baked in, so loading it
        with ``api.load_exported`` needs neither the config file nor the
        model file. A program without kernels needs torch alone; one that
        holds the LRN or flash forward (``cxxnet::`` ops) also needs
        ``ops.library`` imported. Returns a ``CXTF`` frame
        (utils/artifact.py).

        node_name: "" = the last node (the pred/pred_raw surface), else a
        named node or top[-k] (the extract surface). batch_size: 0 = the
        training batch size; -1 = a SYMBOLIC batch dim
        (``torch.export.Dim``): one artifact serves any batch n >= 1. The
        input is float32 NCHW. An artifact runs on the device type it was
        exported on (the trainer's ``dev``)."""
        check(self.params is not None,
              "export_forward: init_model/load_model first")
        node_id = (self.net_cfg.param.num_nodes - 1 if not node_name
                   else self._resolve_node(node_name))
        bs = batch_size or self.batch_size
        c, h, w = self.net_cfg.param.input_shape
        net = self.net

        def fwd(params, data):
            values, _ = net.forward(params, data)
            return values[node_id]

        from ..utils import artifact
        # a symbolic batch is traced at a batch of 2 or more: torch.export
        # takes a traced size of 1 for a constant
        x = torch.zeros((max(bs, 2) if batch_size < 0 else bs, c, h, w),
                        dtype=torch.float32, device=self.dev)
        dyn = ({0: torch.export.Dim("b", min=1)},) if batch_size < 0 \
            else None
        payload = _export_program(fwd, self._export_params(), (x,), dyn)
        return artifact.frame(
            "forward", {"input_shape": [int(c), int(h), int(w)],
                        "batch": (-1 if batch_size < 0 else int(bs))},
            payload)

    # weight access
    def get_weight(self, layer_name: str, tag: str):
        if self.mesh is None:
            return self.net.get_weight(self.params, layer_name, tag)
        idx, key = self.net._weight_key(layer_name, tag)
        if self._pp is not None:
            arr = self.canonical_params()[idx][key]
        else:
            arr = fetch_global(self.params[idx][key], self.mesh,
                               self._store_spec[idx][key])
        flat = arr.reshape(arr.shape[0], -1) if arr.ndim > 1 \
            else arr.reshape(1, -1)
        return flat, list(arr.shape)

    def set_weight(self, value: np.ndarray, layer_name: str, tag: str) -> None:
        if self.mesh is None:
            self.net.set_weight(self.params, value, layer_name, tag)
        else:
            idx, key = self.net._weight_key(layer_name, tag)
            shape = self.net.param_shapes()[idx][key]
            if not self._owns(idx):
                self._params_gen += 1
                return
            self.params[idx][key] = sharding.shard_copy(
                np.asarray(value, np.float32).reshape(shape), self.mesh,
                self._store_spec[idx][key], self.dev)
        self._params_gen += 1


# the node dtypes a pipelined eval forward hands between ranks, by code
_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


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
            t0 = time.perf_counter()
            t1 = torch.zeros((1, self.l_max), dtype=torch.int64, device=dev)
            t1[0, :plen] = torch.tensor(toks, dtype=torch.int64, device=dev)
            seed_t = torch.tensor([word], device=dev)
            params = self.tr._decode_params_current()
            if ticket is None:
                caches = {k: c[slot:slot + 1]
                          for k, c in self._caches.items()}
                first = self._prefill_fn(plen)(self, params, t1[:, :plen],
                                               seed_t, caches)
            else:
                first = self._prefill_fn_paged(plen, ticket.p0)(
                    self, params, t1[:, :plen], seed_t, ticket)
            self._admit_fn()(self, self._toks, slot, t1, first, word, plen,
                             ticket)
            first = int(first[0])              # waits: the first token
            t_first = time.perf_counter()
            # the TTFT boundary the serving frontend's trace context reads
            telemetry.mark("first_token")
            telemetry.span_event("decode.prefill", t0, t_first - t0)
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
        telemetry.count("decode.tokens")
        return first, self._remaining[slot] == 0

    # -- programs (cxxnet_tpu/nnet/trainer.py:2470-2676): the JAX keys,
    # cached on the trainer and shared by its sessions --------------------
    def _prefill_fn(self, plen: int):
        """The dense admission's prefill: the b=1 forward of the prompt
        into the slot's cache rows, and its first token."""
        def run(sess, params, t1, seed_t, caches):
            with torch.no_grad():
                probs = sess._prefill(params, t1, 0, caches)
                return sess._pick(probs, seed_t, plen - 1,
                                  torch.zeros(1, dtype=torch.int64,
                                              device=t1.device))

        def account(sess, params, *_):
            return cost.forward_cost(sess.tr._net_for(1, plen), params, 1,
                                     q_offs=[0])
        return self.tr._watched_jit(
            ("sess_prefill", plen, self.temperature, self.top_k),
            "jit.decode_prefill", lambda: Program(run, account))

    def _prefill_fn_paged(self, plen: int, p0: int):
        """The paged admission's prefill for (prompt length, reuse
        offset): the suffix [p0, plen) against the gathered view, its
        blocks written back, and its first token."""
        pool = self.pool

        def run(sess, params, t1, seed_t, ticket):
            with torch.no_grad():
                probs = sess._prefill_paged(params, t1, ticket)
                return sess._pick(probs, seed_t, plen - 1,
                                  torch.zeros(1, dtype=torch.int64,
                                              device=t1.device))

        def account(sess, params, *_):
            return cost.forward_cost(sess.tr._net_for(1, plen - p0), params,
                                     1, q_offs=[p0])
        return self.tr._watched_jit(
            ("sess_prefill_paged", plen, p0, pool.T, pool.bs,
             self.temperature, self.top_k),
            "jit.decode_prefill", lambda: Program(run, account))

    def _admit_fn(self):
        """An admission's scatter of the slot's row: its tokens, first
        token, seed, position and state (and a paged slot's block
        table)."""
        paged = self.pool is not None
        T = self.pool.T if paged else 0

        def run(sess, toks, slot, t1, first, word, plen, ticket):
            with torch.no_grad():
                toks[slot] = t1[0]
                toks[slot, plen] = first[0]
                sess._seeds[slot] = word
                sess._pos[slot] = plen
                sess._live[slot] = int(sess.n_new > 1)
                if ticket is not None:
                    sess._tables[slot].zero_()
                    sess._tables[slot, :len(ticket.ids)] = torch.tensor(
                        ticket.ids, dtype=torch.int64, device=t1.device)

        def account(sess, *_):
            return cost.admit_cost(sess.l_max, T)
        key = ("sess_admit_paged", self.nslots, T) if paged \
            else ("sess_admit", self.nslots)
        return self.tr._watched_jit(key, "jit.decode_admit",
                                    lambda: Program(run, account))

    def _step_fn(self):
        """One step of every slot: the one-token forward at each slot's
        position, its pick, and (paged) each slot's block written back.
        Its arguments name the session's token and position tensors, which
        the step reads and writes in place: a bucket's program is told
        apart by their shapes, as the JAX program is."""
        def run(sess, params, toks, pos):
            return sess._step(params)

        def account(sess, params, toks, pos):
            # the positions the slots step at in this call
            return cost.forward_cost(sess._net, params,
                                     sess.nslots,
                                     q_offs=list(sess._pos_host))
        if self.pool is not None:
            key = ("sess_step_paged", self.nslots, self.pool.T, self.pool.bs,
                   self.temperature, self.top_k)
        else:
            key = ("sess_step", self.nslots, self.temperature, self.top_k)
        return self.tr._watched_jit(key, "jit.decode_step",
                                    lambda: Program(run, account))

    def _prefill(self, params, t1: torch.Tensor, p0: int,
                 caches) -> torch.Tensor:
        """The b=1 forward of the prompt's positions [p0, plen) into the
        row caches ``caches``; the last position's probabilities (1, V)."""
        L = t1.shape[1] - p0
        net = self.tr._net_for(1, L)
        values, _ = net.forward(params, t1[:, p0:].reshape(1, 1, 1, L),
                                decode_pos=p0, kv_cache=caches)
        return values[self._last].reshape(1, -1, L)[:, :, -1]

    def _prefill_paged(self, params, t1: torch.Tensor,
                       ticket) -> torch.Tensor:
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
        probs = self._prefill(params, t1, p0, views)
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
            t0 = time.perf_counter()
            nxt = self._step_fn()(self, self.tr._decode_params_current(),
                                  self._toks, self._pos)
            nxt = nxt.cpu().tolist()            # waits: this iteration
        except Exception:
            self.closed = True
            if self.pool is not None:
                self.pool.release()
            raise
        telemetry.span_event("decode.step", t0, time.perf_counter() - t0,
                             slots=self.active_count)
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
        telemetry.count("decode.tokens", len(out))
        return out

    def _step(self, params) -> torch.Tensor:
        """One step's device work: every slot's one-token forward at its
        position, its pick written after it, its position advanced; the
        picked tokens (nslots,) on the device."""
        S = self.nslots
        with torch.no_grad():
            if self.pool is not None:
                caches = kv_gather_views(self.pool.pools, self._tables,
                                         self.pool.bs)
            else:
                caches = self._caches
            tok = self._toks.gather(1, self._pos[:, None])
            values, _ = self._net.forward(
                params, tok.reshape(S, 1, 1, 1), decode_pos=self._pos,
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
        return nxt

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


class _BakedParams(torch.nn.Module):
    """``fn(params, *args)`` as a module whose params list is its buffers,
    the form ``torch.export`` takes: the exported program carries the
    weights in its state dict."""

    def __init__(self, fn: Callable, params: List[Dict[str, torch.Tensor]]):
        super().__init__()
        self._fn = fn
        self._names: List[List[Tuple[str, str]]] = []
        for i, p in enumerate(params):
            names = []
            for k, v in p.items():
                name = "p%d_%s" % (i, k)
                self.register_buffer(name, v)
                names.append((k, name))
            self._names.append(names)

    def forward(self, *args):
        params = [{k: getattr(self, name) for k, name in names}
                  for names in self._names]
        return self._fn(params, *args)


def _export_program(fn: Callable, params, args: tuple,
                    dynamic_shapes=None) -> bytes:
    """``torch.export.save`` of ``fn(params, *args)`` traced at ``args``
    with the params baked in, as bytes."""
    import io
    with torch.no_grad():
        # the module takes *args: its specs nest one level down
        prog = torch.export.export(
            _BakedParams(fn, params), args, strict=False,
            dynamic_shapes=None if dynamic_shapes is None
            else (dynamic_shapes,))
    # the artifact keeps no example inputs: a step's would be its caches
    prog.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(prog, buf)
    return buf.getvalue()


def create_net(net_type: int = 0) -> Trainer:
    """Factory (reference CreateNet<xpu>, src/nnet/nnet.h:99-100); net_type 0
    is the threaded trainer, the only type in the reference."""
    return Trainer()
