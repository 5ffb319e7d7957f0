"""The layers of the port: the AlexNet set (conv, relu, max_pooling, lrn,
flatten, fullc, dropout, softmax), in eval and in training mode.

Each class is the counterpart of the class of the same name in
cxxnet_tpu/layer/layers.py and keeps its config keys, shape inference,
parameter layout and model-file fields, so model files move between the two
packages unchanged. ``forward(params, inputs, ctx)`` runs on torch tensors;
in training (``ctx.train``) dropout draws its mask from the layer's own
generator, and the loss layer appends its loss term to ``ctx.losses``,
whose gradient autograd takes. Conv, fullc, relu, max-pool and flatten are
differentiated by autograd (cuDNN and PyTorch's own backward kernels, as
the JAX package left them to XLA); the LRN backward is a kernel
(ops/lrn.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import ops
from .base import Layer, check


def _flat2d(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


class _WeightBiasLayer(Layer):
    """Shared model-file and weight-visitor handling of fullc and conv:
    LayerParam, then wmat, then bias (zeros when no_bias, as the
    reference writes it)."""

    def _n_out(self) -> int:
        raise NotImplementedError

    def _wmat_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def _fan(self) -> Tuple[int, int]:
        """(in_num, out_num) of the weight init rule."""
        raise NotImplementedError

    def param_shapes(self):
        out = {"wmat": self._wmat_shape()}
        if self.param.no_bias == 0:
            out["bias"] = (self._n_out(),)
        return out

    def init_params(self, gen):
        in_num, out_num = self._fan()
        out = {"wmat": self.param.rand_init_weight(gen, self._wmat_shape(),
                                                   in_num, out_num)}
        if self.param.no_bias == 0:
            out["bias"] = torch.full((self._n_out(),), self.param.init_bias,
                                     dtype=torch.float32)
        return out

    def visit_order(self):
        if self.param.no_bias == 0:
            return [("wmat", "wmat"), ("bias", "bias")]
        return [("wmat", "wmat")]

    def save_model(self, w, params):
        self.param.save(w)
        w.write_tensor(params["wmat"])
        w.write_tensor(params.get("bias", np.zeros((self._n_out(),),
                                                   np.float32)))

    def load_model(self, r):
        self.param.load(r)
        wmat = r.read_tensor()
        bias = r.read_tensor()
        out = {"wmat": wmat}
        if self.param.no_bias == 0:
            out["bias"] = bias
        return out


class FullConnectLayer(_WeightBiasLayer):
    """Dense layer: out = in . W^T + b (src/layer/fullc_layer-inl.hpp:14),
    W stored (num_hidden, num_input)."""

    type_name = "fullc"

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1, "FullcLayer: only support 1-1 connection")
        b, c, h, w = in_shapes[0]
        check(c == 1 and h == 1, "FullcLayer: input need to be a matrix")
        check(self.param.num_hidden > 0,
              "FullcLayer: must set nhidden correctly")
        if self.param.num_input_node == 0:
            self.param.num_input_node = w
        else:
            check(self.param.num_input_node == w,
                  "FullcLayer: input hidden nodes is not consistent")
        return [(b, 1, 1, self.param.num_hidden)]

    def _n_out(self):
        return self.param.num_hidden

    def _wmat_shape(self):
        return (self.param.num_hidden, self.param.num_input_node)

    def _fan(self):
        return self.param.num_input_node, self.param.num_hidden

    def forward(self, params, inputs, ctx):
        x = _flat2d(inputs[0])
        y = x @ params["wmat"].t()
        if self.param.no_bias == 0:
            y = y + params["bias"]
        return [y.reshape(y.shape[0], 1, 1, y.shape[1])]


class ConvolutionLayer(_WeightBiasLayer):
    """Grouped 2-D convolution (src/layer/convolution_layer-inl.hpp:13).
    Weights are stored in the reference's (ngroup, co/g, ci/g*kh*kw) layout
    and viewed as OIHW at forward time."""

    type_name = "conv"

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1,
              "ConvolutionLayer only support 1-1 connection")
        p = self.param
        b, c, h, w = in_shapes[0]
        check(c % p.num_group == 0, "input channels must divide group size")
        check(p.num_channel % p.num_group == 0,
              "output channels must divide group size")
        check(p.num_channel > 0, "must set nchannel correctly")
        check(p.kernel_height > 0 and p.kernel_width > 0,
              "must set kernel_size correctly")
        check(p.kernel_width <= w + 2 * p.pad_x
              and p.kernel_height <= h + 2 * p.pad_y,
              "kernel size exceed input")
        if p.num_input_channel == 0:
            p.num_input_channel = c
        else:
            check(p.num_input_channel == c,
                  "ConvolutionLayer: number of input channels is not "
                  "consistent")
        oh = ops.conv_out_dim(h, p.kernel_height, p.stride, p.pad_y)
        ow = ops.conv_out_dim(w, p.kernel_width, p.stride, p.pad_x)
        return [(b, p.num_channel, oh, ow)]

    def _n_out(self):
        return self.param.num_channel

    def _wmat_shape(self):
        p = self.param
        g = p.num_group
        return (g, p.num_channel // g,
                p.num_input_channel // g * p.kernel_height * p.kernel_width)

    def _fan(self):
        shape = self._wmat_shape()
        return shape[2], shape[1]

    def forward(self, params, inputs, ctx):
        p = self.param
        w = params["wmat"].reshape(p.num_channel,
                                   p.num_input_channel // p.num_group,
                                   p.kernel_height, p.kernel_width)
        y = ops.conv2d(inputs[0], w, stride=p.stride, pad=(p.pad_y, p.pad_x),
                       groups=p.num_group)
        if p.no_bias == 0:
            y = y + params["bias"].reshape(1, -1, 1, 1)
        return [y]


class ReluLayer(Layer):
    """Elementwise max(x, 0) (src/layer/activation_layer-inl.hpp:12)."""

    type_name = "relu"

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1,
              "ActivationLayer only support 1-1 connection")
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        return [torch.relu(inputs[0])]


class MaxPoolingLayer(Layer):
    """Max pooling with the reference's ceil-mode shapes
    (src/layer/pooling_layer-inl.hpp:17)."""

    type_name = "max_pooling"

    def infer_shape(self, in_shapes):
        p = self.param
        b, c, h, w = in_shapes[0]
        check(p.kernel_height > 0 and p.kernel_width > 0,
              "must set kernel_size correctly")
        h2, w2 = h + 2 * p.pad_y, w + 2 * p.pad_x
        check(p.kernel_width <= w2 and p.kernel_height <= h2,
              "kernel size exceed input")
        oh = ops.pool_out_dim(h2, p.kernel_height, p.stride)
        ow = ops.pool_out_dim(w2, p.kernel_width, p.stride)
        return [(b, c, oh, ow)]

    def forward(self, params, inputs, ctx):
        p = self.param
        return [ops.pool2d(inputs[0], "max",
                           (p.kernel_height, p.kernel_width), p.stride,
                           pad=(p.pad_y, p.pad_x))]


class LRNLayer(Layer):
    """AlexNet cross-channel LRN (src/layer/lrn_layer-inl.hpp:12); runs the
    CUDA kernel for a tensor on the card (ops/lrn.py)."""

    type_name = "lrn"

    def __init__(self):
        super().__init__()
        self.nsize = 3
        self.alpha = 0.0
        self.beta = 0.0
        self.knorm = 1.0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "local_size":
            self.nsize = int(val)
        if name == "alpha":
            self.alpha = float(val)
        if name == "beta":
            self.beta = float(val)
        if name == "knorm":
            self.knorm = float(val)

    def infer_shape(self, in_shapes):
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        return [ops.lrn.forward(inputs[0], self.nsize, self.alpha,
                                self.beta, self.knorm)]


class FlattenLayer(Layer):
    """(b,c,h,w) -> (b,1,1,c*h*w) (src/layer/flatten_layer-inl.hpp:11)."""

    type_name = "flatten"

    def infer_shape(self, in_shapes):
        b, c, h, w = in_shapes[0]
        return [(b, 1, 1, c * h * w)]

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        return [x.reshape(x.shape[0], 1, 1, -1)]


class DropoutLayer(Layer):
    """Inverted dropout, self-loop (src/layer/dropout_layer-inl.hpp:12):
    the identity at eval; in training x * (U[0,1) < 1-threshold) /
    (1-threshold), with U drawn on x's device from the layer's generator."""

    type_name = "dropout"

    def __init__(self):
        super().__init__()
        self.threshold = 0.0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "threshold":
            self.threshold = float(val)

    def infer_shape(self, in_shapes):
        check(0.0 <= self.threshold < 1.0,
              "DropoutLayer: invalid dropout threshold")
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        if not ctx.train:
            return [x]
        pkeep = 1.0 - self.threshold
        u = torch.rand(x.shape, generator=ctx.gen, dtype=x.dtype,
                       device=x.device)
        return [x * ((u < pkeep).to(x.dtype) / pkeep)]


class LossLayerBase(Layer):
    """Loss layers, self-loop (src/layer/loss/loss_layer_base-inl.hpp):
    the forward writes the transformed node, and with labels present it
    appends a scalar loss whose gradient is the reference's
    (transformed - target) * grad_scale / (batch_size * update_period).
    ``batch_size`` is the configured one, which reaches the layer through
    the global config, not the rows of the batch."""

    def __init__(self):
        super().__init__()
        self.target = "label"
        self.batch_size = 1
        self.update_period = 1
        self.grad_scale = 1.0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "update_period":
            self.update_period = int(val)
        if name == "target":
            self.target = val
        if name == "grad_scale":
            self.grad_scale = float(val)

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1, "LossLayer: only support 1-1 connection")
        return [in_shapes[0]]

    def _scale(self) -> float:
        return self.grad_scale / (self.batch_size * self.update_period)

    def transform(self, x2d):
        """Forward transform of the node (e.g. softmax)."""
        return x2d

    def loss_term(self, x2d, label):
        """Scalar loss whose gradient wrt x2d is the reference's."""
        raise NotImplementedError

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        x2d = _flat2d(x)
        out = self.transform(x2d)
        if ctx.labels is not None:
            ctx.losses.append(self.loss_term(x2d,
                                             ctx.labels.field(self.target)))
        return [out.reshape(x.shape)]


class SoftmaxLayer(LossLayerBase):
    """Softmax + cross-entropy (src/layer/loss/softmax_layer-inl.hpp:12):
    grad = (p - onehot(label)) * scale. ``label_smooth = eps`` (beyond the
    reference) makes the target (1-eps) one-hot + eps/K uniform. The
    per-position ``seq = 1`` mode belongs to the LM slice."""

    type_name = "softmax"

    def __init__(self):
        super().__init__()
        self.seq = 0
        self.label_smooth = 0.0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "seq":
            self.seq = int(val)
        if name == "label_smooth":
            self.label_smooth = float(val)
            check(0.0 <= self.label_smooth < 1.0,
                  "label_smooth must be in [0, 1)")

    def infer_shape(self, in_shapes):
        check(not self.seq, "softmax seq = 1 is not ported yet")
        return super().infer_shape(in_shapes)

    def transform(self, x2d):
        return ops.softmax(x2d, axis=-1)

    def loss_term(self, x2d, label):
        logp = torch.log_softmax(x2d, dim=-1)
        tgt = logp.gather(1, label[:, :1].long())[:, 0]
        eps = self.label_smooth
        if eps == 0.0:
            ce = -tgt
        else:
            ce = -((1.0 - eps) * tgt + eps / logp.shape[-1] * logp.sum(-1))
        return ce.sum() * self._scale()


LAYER_CLASSES: Dict[str, type] = {
    cls.type_name: cls for cls in (
        FullConnectLayer, ConvolutionLayer, ReluLayer, MaxPoolingLayer,
        LRNLayer, FlattenLayer, DropoutLayer, SoftmaxLayer)}
