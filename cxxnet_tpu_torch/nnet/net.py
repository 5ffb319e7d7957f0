"""NeuralNet: the assembled DAG and its forward over a params list.

Counterpart of cxxnet_tpu/nnet/net.py (the reference's NeuralNet,
src/nnet/neural_net-inl.hpp:23-297), with the KV-cached decode forward
and without the pipeline and fusion paths. Parameters are a list with one
dict of tensors per connection, as in the JAX package; a shared
connection (``share:<tag>``) holds {} and applies its primary's layer with
the primary's params.
``forward`` returns the node values and the summed loss of the loss layers
(zero without labels); the trainer differentiates that loss with autograd.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..layer import factory
from ..layer.base import ApplyContext, LabelInfo, Layer, check, fold_in
from ..utils import serializer
from .config import NetConfig

Params = List[Dict[str, torch.Tensor]]


class NeuralNet:
    def __init__(self, cfg: NetConfig, batch_size: int,
                 infer_shapes: bool = True, input_scale: float = 1.0,
                 input_mean=None, seq_parallel: int = 1):
        """infer_shapes=False skips shape inference, for a net whose layer
        params come from a model file first (load_model_blob restores each
        layer's LayerParam, then the caller runs infer_shapes).

        input_scale/input_mean (trainer keys input_divideby / input_scale /
        input_mean_value) apply ``(x - mean) * scale`` on the device to the
        data node. seq_parallel (the trainer key) reaches every layer
        through the apply context: attention then runs over that many
        virtual ranks of the sequence."""
        self.cfg = cfg
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
                decode_pos: Optional[int] = None, kv_cache=None
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
        ``self._last_cache_updates``. An id input node (embed's) keeps the
        data's dtype; any other is taken as float32."""
        cfg = self.cfg
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
        ctx = ApplyContext(train=train, labels=labels, epoch=epoch,
                           decode_pos=decode_pos, kv_cache=kv_cache or {},
                           seq_parallel=self.seq_parallel)
        base_seed = gen.initial_seed() if gen is not None else 0
        for i, info in enumerate(cfg.layers):
            pidx = info.primary_layer_index if self.is_shared[i] else i
            ctx.layer_index = pidx
            # the connection, not the params slot: two share-tied
            # attention layers share weights but not a cache
            ctx.conn_index = i
            if train:
                ctx.gen = torch.Generator(device=values[0].device) \
                    .manual_seed(fold_in(base_seed, i))
            outs = self.layers[i].forward(params[pidx],
                                          [values[j] for j in info.nindex_in],
                                          ctx)
            for j, v in zip(info.nindex_out, outs):
                values[j] = v
        self._last_cache_updates = ctx.cache_updates
        if ctx.losses:
            return values, sum(ctx.losses)
        return values, torch.zeros((), device=values[0].device)

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
