"""Layer type ids, name parsing, and the layer factory.

Counterpart of cxxnet_tpu/layer/factory.py (the reference's type enumeration
and parser, src/layer/layer.h:284-361). The ids are the reference's, because
model files store them. Every name of the JAX package's table creates its
layer; ``extern`` (alias ``caffe``) wraps an op registered with
``register_extern``. ``create_layer`` refuses only the shared layer (the
net builds it) and the pairtest layers, which the port does not have.
"""

from __future__ import annotations

from . import layers as L
from .base import Layer, check
from .extern import ExternLayer

# type ids (src/layer/layer.h:284-315)
kSharedLayer = 0
kFullConnect = 1
kSoftmax = 2
kRectifiedLinear = 3
kSigmoid = 4
kTanh = 5
kSoftplus = 6
kFlatten = 7
kDropout = 8
kConv = 10
kMaxPooling = 11
kSumPooling = 12
kAvgPooling = 13
kLRN = 15
kBias = 17
kConcat = 18
kXelu = 19
kCaffe = 20
kReluMaxPooling = 21
kMaxout = 22
kSplit = 23
kInsanity = 24
kInsanityPooling = 25
kL2Loss = 26
kMultiLogistic = 27
kChConcat = 28
kPRelu = 29
kBatchNorm = 30
kFixConnect = 31
kAttention = 32
kEmbed = 33
kAdd = 34
kMoE = 35
kIm2Seq = 36
kPairTestGap = 1024

_NAME2TYPE = {
    "fullc": kFullConnect,
    "fixconn": kFixConnect,
    "bias": kBias,
    "softmax": kSoftmax,
    "relu": kRectifiedLinear,
    "sigmoid": kSigmoid,
    "tanh": kTanh,
    "softplus": kSoftplus,
    "flatten": kFlatten,
    "dropout": kDropout,
    "conv": kConv,
    "relu_max_pooling": kReluMaxPooling,
    "max_pooling": kMaxPooling,
    "sum_pooling": kSumPooling,
    "avg_pooling": kAvgPooling,
    "lrn": kLRN,
    "concat": kConcat,
    "xelu": kXelu,
    "maxout": kMaxout,
    "split": kSplit,
    "insanity": kInsanity,
    "insanity_max_pooling": kInsanityPooling,
    "l2_loss": kL2Loss,
    "multi_logistic": kMultiLogistic,
    "ch_concat": kChConcat,
    "prelu": kPRelu,
    "batch_norm": kBatchNorm,
    "extern": kCaffe,
    "caffe": kCaffe,
    "attention": kAttention,
    "embed": kEmbed,
    "add": kAdd,
    "moe": kMoE,
    "im2seq": kIm2Seq,
}

_TYPE2NAME = {}
for _name, _tid in _NAME2TYPE.items():
    _TYPE2NAME.setdefault(_tid, _name)

_TYPE2CLS = {_NAME2TYPE[name]: cls for name, cls in L.LAYER_CLASSES.items()}
_TYPE2CLS[kCaffe] = ExternLayer


def get_layer_type(name: str) -> int:
    """Parse a layer type name to its id (reference GetLayerType,
    src/layer/layer.h:322-361), including share:<tag> and
    pairtest-<master>-<slave>."""
    if name.startswith("share"):
        return kSharedLayer
    if name.startswith("pairtest-"):
        parts = name[len("pairtest-"):].split("-", 1)
        check(len(parts) == 2, "pairtest must be pairtest-master-slave")
        return kPairTestGap * get_layer_type(parts[0]) + get_layer_type(parts[1])
    if name in _NAME2TYPE:
        return _NAME2TYPE[name]
    raise ValueError('unknown layer type: "%s"' % name)


def create_layer(type_id: int) -> Layer:
    """Create a layer by numeric type id (reference CreateLayer_,
    src/layer/layer_impl-inl.hpp:37-76)."""
    if type_id == kSharedLayer:
        raise ValueError("shared layer is created by the net, not the factory")
    if type_id not in _TYPE2CLS:
        if type_id >= kPairTestGap:
            name = "pairtest"
        else:
            name = _TYPE2NAME.get(type_id, "id %d" % type_id)
        raise ValueError("layer type %s is not ported to cxxnet_tpu_torch yet"
                         % name)
    return _TYPE2CLS[type_id]()
