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
                              gather=ctx.gather)
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
