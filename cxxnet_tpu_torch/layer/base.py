"""Layer abstraction: shape inference, parameter init and the forward.

Counterpart of cxxnet_tpu/layer/base.py (the reference's ILayer ABI,
src/layer/layer.h:162-279). A layer here is a plain object holding its
config; its ``forward(params, inputs, ctx)`` is a function on torch tensors,
as the JAX package's ``apply(params, inputs, ctx)``, and its parameters
live outside it, in a dict per layer, so that weight sharing, model files
and the JAX package's parameter lists map one to one. The ApplyContext
carries what a training forward adds: the mode, the batch's labels, the
loss terms the loss layers append, and the layer's random stream; and what
a KV-cached decode forward adds: the position of the input's first slot
and the per-attention-layer caches.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils import serializer

Shape4 = Tuple[int, int, int, int]
Params = Dict[str, torch.Tensor]

# LayerParam's 18 scalar fields, then int reserved[64]: 328 bytes
_PARAM_FMT = "<i f i f f i i i i i i i i i i i i i"
PARAM_BYTES = struct.calcsize(_PARAM_FMT) + 64 * 4


class LayerParam:
    """Common numeric layer parameters; mirrors src/layer/param.h:15-142.

    The reference serializes this struct verbatim into model files;
    save()/load() reproduce its exact 328-byte layout (18 scalar fields +
    int reserved[64]).
    """

    def __init__(self):
        self.num_hidden = 0
        self.init_sigma = 0.01
        self.init_sparse = 10
        self.init_uniform = -1.0
        self.init_bias = 0.0
        self.num_channel = 0
        self.random_type = 0
        self.num_group = 1
        self.kernel_height = 0
        self.kernel_width = 0
        self.stride = 1
        self.pad_y = 0
        self.pad_x = 0
        self.no_bias = 0
        self.temp_col_max = 64 << 18
        self.silent = 0
        self.num_input_channel = 0
        self.num_input_node = 0

    _INT_KEYS = {"nhidden": "num_hidden", "nchannel": "num_channel",
                 "ngroup": "num_group", "kernel_height": "kernel_height",
                 "kernel_width": "kernel_width", "stride": "stride",
                 "pad_y": "pad_y", "pad_x": "pad_x", "no_bias": "no_bias",
                 "silent": "silent", "init_sparse": "init_sparse"}
    _FLOAT_KEYS = {"init_sigma": "init_sigma", "init_uniform": "init_uniform",
                   "init_bias": "init_bias"}

    def set_param(self, name: str, val: str) -> None:
        if name in self._INT_KEYS:
            setattr(self, self._INT_KEYS[name], int(val))
        elif name in self._FLOAT_KEYS:
            setattr(self, self._FLOAT_KEYS[name], float(val))
        elif name == "random_type":
            if val == "gaussian":
                self.random_type = 0
            elif val in ("uniform", "xavier"):
                self.random_type = 1
            elif val == "kaiming":
                self.random_type = 2
            else:
                raise ValueError("invalid random_type %s" % val)
        elif name == "kernel_size":
            self.kernel_width = self.kernel_height = int(val)
        elif name == "pad":
            self.pad_y = self.pad_x = int(val)
        elif name == "temp_col_max":
            self.temp_col_max = int(val) << 18

    def _fields(self):
        return (self.num_hidden, self.init_sigma, self.init_sparse,
                self.init_uniform, self.init_bias, self.num_channel,
                self.random_type, self.num_group, self.kernel_height,
                self.kernel_width, self.stride, self.pad_y, self.pad_x,
                self.no_bias, self.temp_col_max, self.silent,
                self.num_input_channel, self.num_input_node)

    def save(self, w: serializer.Writer) -> None:
        w.write_raw(struct.pack(_PARAM_FMT, *self._fields()))
        w.write_raw(b"\x00" * (64 * 4))  # reserved[64]

    def load(self, r: serializer.Reader) -> None:
        (self.num_hidden, self.init_sigma, self.init_sparse,
         self.init_uniform, self.init_bias, self.num_channel,
         self.random_type, self.num_group, self.kernel_height,
         self.kernel_width, self.stride, self.pad_y, self.pad_x,
         self.no_bias, self.temp_col_max, self.silent,
         self.num_input_channel, self.num_input_node) = struct.unpack(
             _PARAM_FMT, r.read_raw(struct.calcsize(_PARAM_FMT)))
        r.read_raw(64 * 4)

    def rand_init_weight(self, gen: torch.Generator, shape: Tuple[int, ...],
                         in_num: int, out_num: int) -> torch.Tensor:
        """Weight init: gaussian / xavier-uniform / kaiming (reference
        src/layer/param.h:113-138), drawn on the host from ``gen``."""
        if self.random_type == 0:
            sigma = self.init_sigma
        elif self.random_type == 1:
            a = math.sqrt(3.0 / (in_num + out_num))
            if self.init_uniform > 0:
                a = self.init_uniform
            u = torch.rand(shape, generator=gen, dtype=torch.float32)
            return u * (2.0 * a) - a
        elif self.random_type == 2:
            fan = (self.num_hidden if self.num_hidden > 0 else
                   self.num_channel * self.kernel_width * self.kernel_height)
            sigma = math.sqrt(2.0 / fan)
        else:
            raise ValueError("unsupported random_type %d" % self.random_type)
        return torch.randn(shape, generator=gen, dtype=torch.float32) * sigma


class LabelInfo:
    """Named label fields of a batch; mirrors layer::LabelInfo
    (src/layer/layer.h:96-121). Fields are column ranges of the batch's
    label matrix, selected by the ``label_vec[a,b) = name`` config
    ranges."""

    def __init__(self, fields: Dict[str, object]):
        self.fields = fields

    def field(self, name: str):
        if name not in self.fields:
            raise KeyError("unknown label target=%s" % name)
        return self.fields[name]


@dataclass
class ApplyContext:
    """Per-forward context threaded through the layers (the JAX package's
    ApplyContext, cxxnet_tpu/layer/base.py:168-212, for this slice)."""
    train: bool = False
    labels: Optional[LabelInfo] = None
    # scalar loss terms appended by the loss layers; the net sums them
    losses: List[torch.Tensor] = field(default_factory=list)
    # optimizer updates taken so far (the trainer's epoch_counter)
    epoch: int = 0
    # params slot of the layer now applying; set by the net's forward loop
    layer_index: int = -1
    # the applying layer's own random stream on the net's device (the JAX
    # package's per-layer folded key); set by the net's forward loop
    gen: Optional[torch.Generator] = None
    # the CONNECTION index (distinct even when share[...] ties the params
    # slot): the key of per-application state like KV caches
    conn_index: int = -1
    # KV-cached decoding (Trainer.generate): the global position of the
    # input's first sequence slot, a host int (None = a full-sequence
    # forward), or in a session step a (b,) int64 tensor on the device,
    # each row's own position. Embed reads its position rows there,
    # attention its RoPE angles, and attention attends against the cache
    decode_pos: Optional[Union[int, torch.Tensor]] = None
    # the (lowest, highest) of a tensor decode_pos, from the host's books:
    # the bounds of loops over the cache (decode_chunk) never read the
    # device
    decode_span: Optional[Tuple[int, int]] = None
    # per-attention-connection k/v caches, keyed (conn_index, "k"/"v"):
    # (b, nkv, L_max, dh) tensors that attention writes in place at
    # [decode_pos, decode_pos + L) and records in cache_updates
    kv_cache: Dict = field(default_factory=dict)
    cache_updates: Dict = field(default_factory=dict)
    # non-gradient parameter updates of a training forward (batch-norm
    # running statistics), keyed (params slot, param key); the trainer
    # writes them into the params after the optimizer step
    state_updates: Dict = field(default_factory=dict)
    # sequence parallelism (the trainer's seq_parallel): attention of a
    # full-sequence forward runs over this many virtual ranks of the
    # sequence, where the JAX package passes a mesh with an "sp" axis
    seq_parallel: int = 1
    # the trainer's mesh of ranks (parallel/mesh.py), None on one rank:
    # fullc and conv under a model group compute their output shard and
    # gather it, moe under an ep group its slice of the experts
    mesh: Optional[object] = None
    # the batch's rows are split over the mesh's data axis (a training
    # batch, and an eval batch whose rows divide): batch-norm sums its
    # statistics over the data group, and the random layers draw the
    # global batch's noise and keep their own rows of it
    data_sharded: bool = False
    # fsdp: (params slot, params) -> the params the layer applies, with
    # its weight shards gathered; set by the net's forward
    gather: Optional[object] = None
    # inside a pipeline stage (the JAX package's manual_tp): attention
    # under an sp axis attends this rank's query chunk against the whole
    # k/v, and batch-norm takes the plain mean of its rows
    in_stage: bool = False
    # (rows of the whole batch, the first of these rows): a pipeline
    # microbatch's place in the whole batch, for the random layers' draw
    row_span: Optional[Tuple[int, int]] = None

    def data_rows(self, shape, draw):
        """``draw(shape)`` of this rank's rows: under ``data_sharded`` the
        draw of the whole batch's shape, cut to this rank's rows, so that
        n ranks together draw what one rank draws for the whole batch
        (and every rank of a model or ep group the same); in a pipeline
        stage (``row_span``) the whole batch's draw cut to the
        microbatch's rows."""
        b = shape[0]
        if self.row_span is not None:
            total, first = self.row_span
            return draw((total,) + tuple(shape[1:]))[first:first + b]
        if not self.data_sharded:
            return draw(shape)
        dp = self.mesh.axis_size("data")
        d = self.mesh.coords["data"]
        return draw((b * dp,) + tuple(shape[1:]))[d * b:(d + 1) * b]


_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data): splitmix64 of the pair, the
    port's counterpart of ``jax.random.fold_in`` for seeding one
    torch.Generator per (step, layer)."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class Layer:
    """Base layer. Subclasses define shape inference, their parameter
    shapes and the forward."""

    type_name = "none"
    # True for layers whose inputs are integer ids stored as floats (embed):
    # the net never casts such nodes
    integer_inputs = False
    # loss layers: the net feeds them float32 whatever the compute dtype
    is_loss = False

    def __init__(self):
        self.param = LayerParam()
        # config key ``remat``: recompute this layer's activations in the
        # backward instead of keeping them (cxxnet_tpu/layer/base.py:234-243)
        self.remat = 0

    def set_param(self, name: str, val: str) -> None:
        if name == "remat":
            self.remat = int(val)
        self.param.set_param(name, val)

    def infer_shape(self, in_shapes: List[Shape4]) -> List[Shape4]:
        """Given input node shapes (b, c, h, w), return output node shapes;
        also finalizes derived params (e.g. num_input_node)."""
        raise NotImplementedError

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Shape of each parameter, keyed as in the JAX package's params
        dicts; valid after infer_shape. {} for parameterless layers."""
        return {}

    def init_params(self, gen: torch.Generator) -> Params:
        """Initialize weights on the host; {} for parameterless layers."""
        return {}

    def forward(self, params: Params, inputs: List[torch.Tensor],
                ctx: ApplyContext) -> List[torch.Tensor]:
        raise NotImplementedError

    def save_model(self, w: serializer.Writer,
                   params: Dict[str, np.ndarray]) -> None:
        """Serialize layer params; default: nothing (parameterless layers)."""

    def load_model(self, r: serializer.Reader) -> Dict[str, np.ndarray]:
        return {}

    def visit_order(self) -> List[Tuple[str, str]]:
        """(tag, param-key) pairs exposed to get_weight/set_weight,
        mirroring the reference's ApplyVisitor order."""
        return []

    def state_keys(self) -> Tuple[str, ...]:
        """Param keys that are state, not weights (batch-norm running
        statistics): no updater, no compute-dtype cast, no remat."""
        return ()


def check(cond: bool, msg: str, *args) -> None:
    """Fail-fast invariant check (reference utils::Check, src/utils/utils.h)."""
    if not cond:
        raise ValueError(msg % args if args else msg)
