"""NeuralNet: the assembled DAG and its forward over a params list.

Counterpart of cxxnet_tpu/nnet/net.py (the reference's NeuralNet,
src/nnet/neural_net-inl.hpp:23-297), with the KV-cached decode forward,
the compute dtype (``compute_dtype = bfloat16``: explicit casts by the JAX
package's rules, not ``torch.autocast``) and ``remat``, and without the
pipeline and fusion paths. Parameters are a list with one
dict of tensors per connection, as in the JAX package; a shared
connection (``share:<tag>``) holds {} and applies its primary's layer with
the primary's params.
``forward`` returns the node values and the summed loss of the loss layers
(zero without labels); the trainer differentiates that loss with autograd.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..layer import factory
from ..layer.base import ApplyContext, LabelInfo, Layer, check, fold_in
from ..utils import serializer
from .config import NetConfig

Params = List[Dict[str, torch.Tensor]]


class NeuralNet:
    def __init__(self, cfg: NetConfig, batch_size: int,
                 infer_shapes: bool = True, input_scale: float = 1.0,
                 input_mean=None, seq_parallel: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        """infer_shapes=False skips shape inference, for a net whose layer
        params come from a model file first (load_model_blob restores each
        layer's LayerParam, then the caller runs infer_shapes).

        input_scale/input_mean (trainer keys input_divideby / input_scale /
        input_mean_value) apply ``(x - mean) * scale`` on the device to the
        data node. seq_parallel (the trainer key) reaches every layer
        through the apply context: attention then runs over that many
        virtual ranks of the sequence.

        compute_dtype (the trainer key; None is float32) is the dtype the
        forward computes in: the input after its float32 normalization and
        every floating weight are cast to it, except integer-id nodes and
        state (batch-norm running statistics), and loss layers take float32
        inputs (cxxnet_tpu/nnet/net.py:162-172, 579-581, 640-645). The
        master weights stay float32, so their gradients come back float32
        through the casts."""
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        # the trainer's mesh of ranks (parallel/mesh.py), None on one rank;
        # reaches the layers through the apply context
        self.mesh = None
        self.seq_parallel = int(seq_parallel)
        self.max_batch = batch_size
        self.input_scale = float(input_scale)
        self.input_mean = None if input_mean is None else \
            np.asarray(input_mean, np.float32)
        self.layers: List[Layer] = []        # one per connection (shared -> primary obj)
        self.is_shared: List[bool] = []
        self.node_shapes: List[Tuple[int, int, int, int]] = []
        self._build_layers()
        # nodes of integer ids, which forward never casts
        self.id_nodes = self._integer_id_nodes()
        if infer_shapes:
            self.infer_shapes()

    def _build_layers(self) -> None:
        cfg = self.cfg
        for i, info in enumerate(cfg.layers):
            if info.type == factory.kSharedLayer:
                check(0 <= info.primary_layer_index < len(self.layers),
                      "shared layer primary_layer_index exceed bound")
                self.layers.append(self.layers[info.primary_layer_index])
                self.is_shared.append(True)
                continue
            lay = factory.create_layer(info.type)
            if hasattr(lay, "n_out"):  # split: fan-out = the out arity
                lay.n_out = max(len(info.nindex_out), 1)
            for k, v in cfg.defcfg:
                lay.set_param(k, v)
            for k, v in cfg.layercfg[i]:
                lay.set_param(k, v)
            self.layers.append(lay)
            self.is_shared.append(False)

    def infer_shapes(self) -> None:
        """Shape inference sweep (InitConnection semantics)."""
        cfg = self.cfg
        shapes: List[Optional[Tuple[int, int, int, int]]] = \
            [None] * cfg.param.num_nodes
        c, h, w = cfg.param.input_shape
        shapes[0] = (self.max_batch, c, h, w)
        for i in range(cfg.param.extra_data_num):
            es = cfg.extra_shape[i * 3: i * 3 + 3]
            shapes[i + 1] = (self.max_batch, es[0], es[1], es[2])
        for i, info in enumerate(cfg.layers):
            in_shapes = []
            for j in info.nindex_in:
                check(shapes[j] is not None,
                      "node %d used before defined" % j)
                in_shapes.append(shapes[j])
            out_shapes = self.layers[i].infer_shape(in_shapes)
            check(len(out_shapes) == len(info.nindex_out),
                  "layer %d: output arity mismatch" % i)
            for j, s in zip(info.nindex_out, out_shapes):
                shapes[j] = s
        self.node_shapes = shapes  # type: ignore[assignment]

    def param_shapes(self) -> List[Dict[str, Tuple[int, ...]]]:
        """Expected {key: shape} per connection ({} for shared ones)."""
        return [{} if self.is_shared[i] else lay.param_shapes()
                for i, lay in enumerate(self.layers)]

    def init_params(self, seed: int, device: torch.device) -> Params:
        """Random weights from the layers' init rules: each layer draws from
        its own host torch.Generator seeded from (seed, layer index), then
        moves to ``device``."""
        params: Params = []
        for i, lay in enumerate(self.layers):
            if self.is_shared[i]:
                params.append({})
                continue
            gen = torch.Generator().manual_seed(seed + i * 9973)
            params.append({k: v.to(device)
                           for k, v in lay.init_params(gen).items()})
        return params

    def _integer_id_nodes(self) -> set:
        """Nodes carrying integer ids: inputs of integer_inputs layers
        (embed) and, transitively, the inputs of the layers that produce
        them (ids routed through split). The net never casts them."""
        cfg = self.cfg
        id_nodes = set()
        for i, info in enumerate(cfg.layers):
            if self.layers[i].integer_inputs:
                id_nodes.update(info.nindex_in)
        changed = bool(id_nodes)
        while changed:
            changed = False
            for info in cfg.layers:
                if any(o in id_nodes for o in info.nindex_out):
                    new = set(info.nindex_in) - id_nodes
                    if new:
                        id_nodes |= new
                        changed = True
        return id_nodes

    def _cast_params_compute(self, params: Params) -> Params:
        """The compute-dtype view of the master params: every floating
        tensor cast, except the layers' state keys, which stay float32 so
        that their EMAs never take bf16 rounding."""
        cdt = self.compute_dtype
        return [{k: v.to(cdt) if v.is_floating_point()
                 and k not in self.layers[i].state_keys() else v
                 for k, v in p.items()}
                for i, p in enumerate(params)]

    def remat_segments(self) -> List[range]:
        """The connections that run under torch.utils.checkpoint (config
        key ``remat``, cxxnet_tpu/nnet/net.py:496-512, 583-589): each
        maximal run of consecutive remat layers that are no loss and keep
        no state, cut into pieces of ceil(sqrt(n)) connections (Chen et al.
        2016), each piece one checkpoint. The forward keeps only the values
        that leave a piece, and the backward recomputes one piece at a
        time. A checkpoint per layer would keep each layer's input, which
        the layer's own backward keeps anyway."""
        out: List[range] = []
        run: List[int] = []
        for i, lay in enumerate(self.layers + [None]):
            if lay is not None and lay.remat and not lay.is_loss \
                    and not lay.state_keys():
                run.append(i)
                continue
            step = math.isqrt(len(run) - 1) + 1 if run else 1
            out += [range(run[j], run[min(j + step, len(run)) - 1] + 1)
                    for j in range(0, len(run), step)]
            run = []
        return out

    def _apply_connection(self, i: int, params: Params,
                          values: List[Optional[torch.Tensor]],
                          ctx: ApplyContext, base_seed: int) -> None:
        """Connection i's layer on ``values``, in place. In training it
        draws from its own generator, seeded from (``base_seed``, i)."""
        info = self.cfg.layers[i]
        lay = self.layers[i]
        pidx = info.primary_layer_index if self.is_shared[i] else i
        ctx.layer_index = pidx
        p = params[pidx]
        if ctx.gather is not None:
            p = ctx.gather(pidx, p)
        # the connection, not the params slot: two share-tied attention
        # layers share weights but not a cache
        ctx.conn_index = i
        ins = [values[j] for j in info.nindex_in]
        if ctx.train:
            ctx.gen = torch.Generator(device=ins[0].device) \
                .manual_seed(fold_in(base_seed, i))
        if self.compute_dtype is not None and lay.is_loss:
            ins = [x.float() for x in ins]
        for j, v in zip(info.nindex_out, lay.forward(p, ins, ctx)):
            values[j] = v

    def _apply_remat(self, seg: range, params: Params,
                     values: List[Optional[torch.Tensor]],
                     ctx: ApplyContext, base_seed: int, keep) -> None:
        """The connections ``seg`` as one checkpoint: the values they
        write that a later connection reads, the last node and the nodes
        ``keep`` leave it; the others are recomputed in the backward and
        stay None in ``values``. Each layer's generator is made inside the
        checkpointed function from its seed, so the recompute draws the
        same dropout mask."""
        layers = self.cfg.layers
        ins: List[int] = []
        written = set()
        for i in seg:
            ins += [j for j in layers[i].nindex_in
                    if j not in written and j not in ins]
            written.update(layers[i].nindex_out)
        read_later = {j for info in layers[seg.stop:] for j in info.nindex_in}
        outs = sorted(j for j in written if j in read_later or j in keep
                      or j == len(values) - 1)

        def piece(*xs):
            local: List[Optional[torch.Tensor]] = [None] * len(values)
            for j, x in zip(ins, xs):
                local[j] = x
            c2 = ApplyContext(train=ctx.train, epoch=ctx.epoch,
                              seq_parallel=ctx.seq_parallel, mesh=ctx.mesh,
                              data_sharded=ctx.data_sharded,
                              gather=ctx.gather, in_stage=ctx.in_stage,
                              row_span=ctx.row_span)
            for i in seg:
                self._apply_connection(i, params, local, c2, base_seed)
            return tuple(local[j] for j in outs)
        res = checkpoint(piece, *[values[j] for j in ins], use_reentrant=False)
        for j in written:
            values[j] = None
        for j, v in zip(outs, res):
            values[j] = v

    def _normalize_input(self, x: torch.Tensor) -> torch.Tensor:
        """Device-side input normalization ``(x - mean) * scale``; channel
        order of input_mean matches the augmenter's mean_value key."""
        if self.input_scale == 1.0 and self.input_mean is None:
            return x
        x = x.float()
        if self.input_mean is not None:
            x = x - torch.as_tensor(self.input_mean, device=x.device) \
                .reshape(1, -1, 1, 1)
        if self.input_scale != 1.0:
            x = x * self.input_scale
        return x

    def forward(self, params: Params, data: torch.Tensor,
                labels: Optional[LabelInfo] = None, train: bool = False,
                gen: Optional[torch.Generator] = None, epoch: int = 0,
                decode_pos=None, kv_cache=None, decode_span=None,
                keep: Sequence[int] = (), data_sharded: bool = False,
                gather=None
                ) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
        """Run the DAG; returns (node values, total loss). ``train`` turns
        on the training behaviour of the layers (dropout); ``labels`` makes
        the loss layers add their loss terms. In training each connection
        i draws from its own generator on the data's device, seeded from
        (``gen``'s seed, i), as the JAX package folds i into the step's
        key; no ``gen`` means seed 0.

        ``decode_pos``/``kv_cache`` select the KV-cached decode forward
        (Trainer.generate): the data covers sequence positions
        [decode_pos, decode_pos + L), attention layers write their k/v into
        the caches and attend against them, and the updated caches land in
        ``self._last_cache_updates``. ``decode_pos`` is an int, or in a
        session step a (b,) int64 tensor of each row's position with
        ``decode_span`` its (lowest, highest) from the host. An id input node (embed's) keeps the
        data's dtype; any other is taken as float32, normalized, then cast
        to the compute dtype. A training forward leaves its batch-norm
        state updates in ``self._last_state_updates``.

        With autograd on and no decode, the ``remat`` layers run in the
        pieces of ``remat_segments``: a node that only its own piece reads
        is None in the returned values, unless it is the last node or in
        ``keep``.

        Under a mesh (``self.mesh``), ``data_sharded`` says that ``data``
        is this rank's rows of the batch (the apply context's flag), and
        ``gather(params slot, params)``, when given, returns the params a
        layer applies, called just before the layer (fsdp's all-gather of
        its weight shards)."""
        cfg = self.cfg
        cdt = self.compute_dtype
        values: List[Optional[torch.Tensor]] = [None] * cfg.param.num_nodes
        if 0 not in self.id_nodes:
            data = data.float()
        values[0] = self._normalize_input(data)
        if self.node_shapes:
            check(tuple(values[0].shape[1:]) == tuple(self.node_shapes[0][1:]),
                  "input batch shape %r does not match the declared "
                  "input_shape %r"
                  % (tuple(values[0].shape[1:]),
                     tuple(self.node_shapes[0][1:])))
        if cdt is not None:
            if 0 not in self.id_nodes:
                values[0] = values[0].to(cdt)
            params = self._cast_params_compute(params)
        ctx = ApplyContext(train=train, labels=labels, epoch=epoch,
                           decode_pos=decode_pos, decode_span=decode_span,
                           kv_cache=kv_cache or {},
                           seq_parallel=self.seq_parallel, mesh=self.mesh,
                           data_sharded=bool(data_sharded), gather=gather)
        base_seed = gen.initial_seed() if gen is not None else 0
        segments = {seg.start: seg for seg in self.remat_segments()} \
            if decode_pos is None and torch.is_grad_enabled() else {}
        i = 0
        while i < len(cfg.layers):
            if i in segments:
                self._apply_remat(segments[i], params, values, ctx,
                                  base_seed, keep)
                i = segments[i].stop
            else:
                self._apply_connection(i, params, values, ctx, base_seed)
                i += 1
        self._last_cache_updates = ctx.cache_updates
        self._last_state_updates = ctx.state_updates
        if ctx.losses:
            return values, sum(ctx.losses)
        return values, torch.zeros((), device=data.device)

    # pipeline parallelism (config key pipeline_parallel = k): the stage
    # plan, host code copied from cxxnet_tpu/nnet/net.py:667-793
    def _pipeline_chain_prefix(self) -> int:
        """Length of the non-loss prefix, verifying it is a topologically
        ordered DAG: every layer reads only the data node or nodes already
        written by an earlier layer (in-place rewrites allowed)."""
        cfg = self.cfg
        first_loss = next(
            (i for i, lay in enumerate(self.layers) if lay.is_loss),
            len(cfg.layers))
        check(first_loss > 0, "pipeline_parallel: empty non-loss prefix")
        written = {0}
        for i in range(first_loss):
            info = cfg.layers[i]
            for n in info.nindex_in:
                check(n in written,
                      "pipeline_parallel: layer %d (%s) reads node %d "
                      "before any layer writes it — the prefix must be "
                      "topologically ordered"
                      % (i, self.layers[i].type_name, n))
            written.update(info.nindex_out)
        return first_loss

    def _pipeline_live_set(self, cut: int, first_loss: int):
        """Nodes whose values must cross the stage boundary after ``cut``
        layers: nodes holding a value (the data node, or written by a
        layer < cut) that are still needed — read by a layer >= cut at or
        before the node's next in-place rewrite, or, at the final cut, the
        last prefix layer's out nodes (which predict / extract read)."""
        cfg = self.cfg
        n_layers = len(cfg.layers)
        writers: Dict[int, List[int]] = {}
        readers: Dict[int, List[int]] = {}
        for i, info in enumerate(cfg.layers):
            for n in info.nindex_in:
                readers.setdefault(n, []).append(i)
            for n in info.nindex_out:
                writers.setdefault(n, []).append(i)
        final_outs = (set(cfg.layers[first_loss - 1].nindex_out)
                      if cut >= first_loss else set())
        live = []
        for n in range(cfg.param.num_nodes):
            has_value = (n == 0) or any(w < cut
                                        for w in writers.get(n, ()))
            if not has_value:
                continue
            nxt = min((w for w in writers.get(n, ()) if w >= cut),
                      default=n_layers)
            if (n in final_outs
                    or any(cut <= r <= nxt for r in readers.get(n, ()))):
                live.append(n)
        return tuple(live)

    def _partition_stages(self, n_layers: int, k: int, param_sizes=None):
        """Split layers [0, n_layers) into k contiguous stages minimizing
        the maximum stage cost: per layer its output activation elements
        plus, with ``param_sizes``, params x output spatial extent."""
        cfg = self.cfg
        costs = []
        for i in range(n_layers):
            c = sum(int(np.prod(self.node_shapes[n][1:]))
                    for n in cfg.layers[i].nindex_out)
            if param_sizes is not None:
                shape = self.node_shapes[cfg.layers[i].nindex_out[0]]
                spatial = (int(np.prod(shape[2:])) if len(shape) > 2 else 1)
                c += int(param_sizes[i]) * spatial
            costs.append(c)
        k = min(k, n_layers)
        prefix = np.concatenate([[0], np.cumsum(costs, dtype=np.float64)])

        def seg(a, b):
            return prefix[b] - prefix[a]

        # dp[j][i] = minimal max-stage-cost splitting first i layers into j
        INF = float("inf")
        dp = [[INF] * (n_layers + 1) for _ in range(k + 1)]
        cut = [[0] * (n_layers + 1) for _ in range(k + 1)]
        dp[0][0] = 0.0
        for j in range(1, k + 1):
            for i in range(j, n_layers + 1):
                for m in range(j - 1, i):
                    v = max(dp[j - 1][m], seg(m, i))
                    if v < dp[j][i]:
                        dp[j][i] = v
                        cut[j][i] = m
        bounds = [n_layers]
        for j in range(k, 0, -1):
            bounds.append(cut[j][bounds[-1]])
        bounds.reverse()
        return [(bounds[s], bounds[s + 1]) for s in range(k)]

    def pipeline_plan(self, k: int):
        """(stages, first_loss): the k stages' layer ranges [lo, hi) of the
        non-loss prefix, empty stages at the end when the prefix is
        shorter than k; a shared stateful layer must fall in its primary's
        stage. The JAX plan takes the params for their sizes; here the
        layers' own param shapes give them (the same numbers)."""
        first_loss = self._pipeline_chain_prefix()
        psizes = [sum(int(np.prod(s)) for s in shapes.values())
                  for shapes in self.param_shapes()[:first_loss]]
        stages = self._partition_stages(first_loss, k, param_sizes=psizes)
        stages += [(first_loss, first_loss)] * (k - len(stages))
        stage_of = {i: s for s, (lo, hi) in enumerate(stages)
                    for i in range(lo, hi)}
        for i in range(first_loss):
            if self.is_shared[i] and self.layers[i].state_keys():
                pidx = self.cfg.layers[i].primary_layer_index
                check(stage_of.get(pidx) == stage_of.get(i),
                      "pipeline_parallel: shared stateful layer %d must "
                      "fall in the same stage as its primary %d (one pipe "
                      "rank must own the state slot)" % (i, pidx))
        return stages, first_loss

    def pipeline_boundaries(self, stages, first_loss: int):
        """The live set crossing into each stage and out of the last one:
        boundaries[s] enters stage s, boundaries[k] leaves the last."""
        out = [self._pipeline_live_set(0, first_loss)]
        for (lo, hi) in stages:
            out.append(self._pipeline_live_set(hi, first_loss)
                       if hi > lo else out[-1])
        return out

    def forward_pipelined(self, params: Params, data: torch.Tensor,
                          labels: Optional[LabelInfo] = None,
                          train: bool = False,
                          gen: Optional[torch.Generator] = None,
                          epoch: int = 0, n_micro: int = 0, plan=None,
                          row_span=None, anchor=None
                          ) -> Tuple[List[Optional[torch.Tensor]],
                                     torch.Tensor]:
        """This rank's part of the GPipe forward (cxxnet_tpu/nnet/net.py
        :795-1040) over the mesh's ``pipe`` axis: the non-loss prefix runs
        as the plan's stages (``plan`` = ``pipeline_plan``'s result), of
        which this rank runs its own, on ``n_micro`` microbatches of
        ``data`` (this rank's rows), each taking its live set from the
        previous stage and handing its output to the next
        (``parallel.pipeline.gpipe``); the last stage then runs the loss
        tail on the final live set of the whole batch. Returns (values,
        loss): on the last stage the final live set's and the tail's node
        values and the tail's loss; on the others no values and a zero
        loss that carries the backward (its gradient runs this stage's
        backward). ``row_span(m)`` gives microbatch m's place in the whole
        batch (the random layers' draw, ``ApplyContext.row_span``);
        ``anchor`` is a leaf that every rank differentiates, so that a
        stage with no weights still runs its backward. The stage's
        batch-norm chains its running statistics over the microbatches in
        order (forward only; the backward's recompute records nothing),
        averaged over ``data`` at the end, in ``_last_state_updates``."""
        from ..parallel import collectives
        from ..parallel import pipeline as pipe
        cfg = self.cfg
        cdt = self.compute_dtype
        mesh = self.mesh
        grp = mesh.group("pipe")
        s, k = grp.index, grp.n
        stages, first_loss = plan
        bounds = self.pipeline_boundaries(stages, first_loss)
        lo, hi = stages[s]
        if 0 not in self.id_nodes:
            data = data.float()
        x = self._normalize_input(data)
        b = x.shape[0]
        n_micro = n_micro or k
        check(b % n_micro == 0,
              "pipeline_parallel: batch_size %d not divisible by %d "
              "microbatches" % (b, n_micro))
        mb = b // n_micro
        if cdt is not None:
            if 0 not in self.id_nodes:
                x = x.to(cdt)
            params = self._cast_params_compute(params)
        keys = [(i, key) for i in range(lo, hi) if not self.is_shared[i]
                for key in sorted(params[i])]
        base_seed = gen.initial_seed() if gen is not None else 0
        state = {}

        def shape_of(n):
            dt = x.dtype if n in self.id_nodes else (cdt or torch.float32)
            return (mb,) + tuple(self.node_shapes[n][1:]), dt

        def stage(m, xs, ps, record):
            vals: List[Optional[torch.Tensor]] = [None] * cfg.param.num_nodes
            for n, v in zip(bounds[s], xs):
                vals[n] = v
            p = list(params)
            for (i, key), t in zip(keys, ps):
                p[i] = dict(p[i])
                p[i][key] = t
            ctx = ApplyContext(train=train, epoch=epoch, mesh=mesh,
                               in_stage=True,
                               row_span=row_span(m) if row_span else None)
            if record:
                ctx.state_updates.update(state)
            for i in range(lo, hi):
                self._apply_connection(i, p, vals, ctx, base_seed)
            if record:
                state.update(ctx.state_updates)
            return [vals[n] for n in bounds[s + 1]]

        micro = [[x[m * mb:(m + 1) * mb]] for m in range(n_micro)] \
            if s == 0 else None
        outs = pipe.gpipe(
            stage, n_micro, grp, micro,
            in_specs=[shape_of(n) for n in bounds[s]],
            out_specs=[shape_of(n) for n in bounds[s + 1]],
            leaves=[params[i][key] for i, key in keys],
            anchor=anchor, device=x.device)
        self._last_cache_updates = {}
        ups = {}
        if state:
            dg = mesh.group("data")
            for key_, v in state.items():
                ups[key_] = collectives.all_reduce(v, dg) / dg.n \
                    if dg.n > 1 else v
        values: List[Optional[torch.Tensor]] = [None] * cfg.param.num_nodes
        if s < k - 1:
            self._last_state_updates = ups
            return values, outs[0]
        for n, v in zip(bounds[k], outs):
            values[n] = v
        ctx = ApplyContext(train=train, labels=labels, epoch=epoch,
                           mesh=mesh, in_stage=True)
        for i in range(first_loss, len(cfg.layers)):
            self._apply_connection(i, params, values, ctx, base_seed)
        ups.update(ctx.state_updates)
        self._last_state_updates = ups
        loss = sum(ctx.losses) if ctx.losses else \
            torch.zeros((), device=x.device)
        return values, loss

    def label_info_from(self, label_batch) -> LabelInfo:
        """Named label fields of a (batch, label_width) matrix (numpy or
        torch) from the config's label_vec ranges (GetLabelInfo,
        nnet_impl-inl.hpp:257-272)."""
        fields = {}
        for name, idx in self.cfg.label_name_map.items():
            begin, end = self.cfg.label_range[idx]
            fields[name] = label_batch[:, begin:end]
        return LabelInfo(fields)

    def save_model_blob(self, params: Params) -> bytes:
        w = serializer.Writer()
        for i, lay in enumerate(self.layers):
            if not self.is_shared[i]:
                lay.save_model(w, {k: v.detach().cpu().numpy()
                                   for k, v in params[i].items()})
        return w.getvalue()

    def load_model_blob(self, blob: bytes,
                        device: torch.device) -> Params:
        r = serializer.Reader(blob)
        params: Params = []
        for i, lay in enumerate(self.layers):
            if self.is_shared[i]:
                params.append({})
            else:
                params.append({k: torch.from_numpy(v).to(device)
                               for k, v in lay.load_model(r).items()})
        return params

    # weight access (SetWeight/GetWeight, nnet_impl-inl.hpp:243-270)
    def _weight_key(self, layer_name: str, tag: str) -> Tuple[int, str]:
        idx = self.cfg.get_layer_index(layer_name)
        for t, key in self.layers[idx].visit_order():
            if t == tag:
                return idx, key
        raise ValueError("layer %s has no weight tag %s" % (layer_name, tag))

    def get_weight(self, params: Params, layer_name: str, tag: str):
        """(2-D host copy of the weight, its shape)."""
        idx, key = self._weight_key(layer_name, tag)
        arr = params[idx][key].detach().cpu().numpy()
        flat = arr.reshape(arr.shape[0], -1) if arr.ndim > 1 \
            else arr.reshape(1, -1)
        return flat, list(arr.shape)

    def set_weight(self, params: Params, value: np.ndarray,
                   layer_name: str, tag: str) -> None:
        idx, key = self._weight_key(layer_name, tag)
        cur = params[idx][key]
        params[idx][key] = torch.as_tensor(
            np.asarray(value, np.float32).reshape(tuple(cur.shape)),
            device=cur.device)
