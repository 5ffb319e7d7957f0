"""The layers of the port: the AlexNet set (conv, relu, max_pooling, lrn,
flatten, fullc, dropout, softmax), in eval and in training mode, the
sigmoid of the MNIST nets, the
leaky and noisy activations of the RReLU nets (xelu, insanity, prelu,
insanity_max_pooling), the transformer LM set (embed, attention,
split, add, softmax ``seq = 1``), the GoogLeNet, VGG and ResNet set
(sum, avg and relu_max pooling, concat, ch_concat, batch_norm), ViT's
im2seq, and the rest of the JAX package's set: tanh, softplus, bias,
fixconn, maxout, the l2_loss and multi_logistic losses and moe (the
mixture of experts). ``extern`` lives in layer/extern.py.

Each class is the counterpart of the class of the same name in
cxxnet_tpu/layer/layers.py and keeps its config keys, shape inference,
parameter layout and model-file fields, so model files move between the two
packages unchanged. ``forward(params, inputs, ctx)`` runs on torch
tensors; in training (``ctx.train``) dropout draws its mask from the
layer's own generator, and the loss layer appends its loss term to
``ctx.losses``, whose gradient autograd takes. Conv, fullc, relu,
sigmoid, pooling, concat, batch-norm and flatten are differentiated by
autograd (cuDNN and PyTorch's own backward kernels, as the JAX package
left them to XLA); the LRN backward is a kernel (ops/lrn.py). The noisy
layers draw their noise through ``draw_uniform`` (ops/random.py: a
Philox kernel on the card, the same bits on the CPU). Attention sends a
sequence the flash kernel takes to it (ops/flash_attn.py) and the rest,
and every KV-cached decode step, to dense attention (ops/attention.py).
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np
import torch

from .. import ops
from ..ops import flash_attn
from ..ops.attention import attention_reference
from ..parallel import collectives, ring, tensor
from .base import ApplyContext, Layer, check


def _flat2d(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def draw_uniform(ctx: ApplyContext, shape, device) -> torch.Tensor:
    """The training noise of the applying layer: U[0, 1) float32 of
    ``shape`` from ops.random.uniform, seeded with the layer's own
    generator's seed (the net folds (step seed, connection) into it, as the
    JAX package folds them into the layer's key). The seed is read on the
    host, with no device sync, and the generator is not advanced. Every
    noisy layer draws here, once per forward, so that a test can replace
    this one function."""
    seed = ctx.gen.initial_seed()
    return ctx.data_rows(tuple(shape), lambda s: ops.random.uniform(
        seed, s, device))


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
        w = params["wmat"]
        if w.shape[0] != self.param.num_hidden:
            # column parallel: this rank's rows of the weight (tp_spec),
            # the features gathered over the model group, the replicated
            # bias added to the whole
            g = ctx.mesh.group("model")
            y = collectives.all_gather(
                tensor.column_parallel_dense(x, w, None, g), g, dim=1)
        else:
            y = x @ w.t()
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
        g = p.num_group
        wm = params["wmat"]
        # under a model group, wmat holds this rank's share of every
        # group's output channels (tp_spec: dimension 1)
        co = wm.shape[0] * wm.shape[1]
        w = wm.reshape(co, p.num_input_channel // g, p.kernel_height,
                       p.kernel_width)
        x = inputs[0]
        if co != p.num_channel:
            grp = ctx.mesh.group("model")
            x = collectives.enter_group(x, grp)
        y = ops.conv2d(x, w, stride=p.stride, pad=(p.pad_y, p.pad_x),
                       groups=g)
        if co != p.num_channel:
            # (rank, group, channel) -> (group, rank, channel)
            y = collectives.all_gather(y, grp, dim=1)
            b, _, h, wd = y.shape
            y = y.reshape(b, grp.n, g, co // g, h, wd).transpose(1, 2) \
                .reshape(b, p.num_channel, h, wd)
        if p.no_bias == 0:
            y = y + params["bias"].reshape(1, -1, 1, 1)
        return [y]


class FixConnectLayer(Layer):
    """Frozen dense layer whose weight comes from a sparse-matrix text file
    (src/layer/fixconn_layer-inl.hpp:14; cxxnet_tpu/layer/layers.py:182):
    a header "nrow ncol nnz", then nnz lines "row col value". The weight
    takes no gradient and no updater, and travels in the model file
    (LayerParam, then wmat), as in the JAX package."""

    type_name = "fixconn"

    def __init__(self):
        super().__init__()
        self.fname_weight = "NULL"
        self._wmat = None

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "fixconn_weight":
            self.fname_weight = val

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1, "FixConnLayer: only support 1-1 connection")
        b, c, h, w = in_shapes[0]
        check(c == 1 and h == 1, "FixConnLayer: input need to be a matrix")
        check(self.param.num_hidden > 0,
              "FixConnLayer: must set nhidden correctly")
        check(self.fname_weight != "NULL",
              "FixConnLayer: must specify fixconn_weight")
        wm = np.zeros((self.param.num_hidden, w), np.float32)
        with open(self.fname_weight) as f:
            toks = f.read().split()
        nrow, ncol, nnz = int(toks[0]), int(toks[1]), int(toks[2])
        check(nrow == wm.shape[0] and ncol == wm.shape[1],
              "FixConnLayer: fixconn_weight shape do not match architecture")
        for i in range(nnz):
            r, col = int(toks[3 + 3 * i]), int(toks[4 + 3 * i])
            check(0 <= r < wm.shape[0] and 0 <= col < wm.shape[1],
                  "FixConnLayer: fixconn_weight index exceed matrix shape")
            wm[r, col] = float(toks[5 + 3 * i])
        self._wmat = wm
        return [(b, 1, 1, self.param.num_hidden)]

    def param_shapes(self):
        return {"wmat": tuple(self._wmat.shape)}

    def init_params(self, gen):
        return {"wmat": torch.from_numpy(self._wmat.copy())}

    def save_model(self, w, params):
        self.param.save(w)
        w.write_tensor(params["wmat"])

    def load_model(self, r):
        self.param.load(r)
        return {"wmat": r.read_tensor()}

    def forward(self, params, inputs, ctx):
        y = _flat2d(inputs[0]) @ params["wmat"].detach().t()
        return [y.reshape(y.shape[0], 1, 1, y.shape[1])]


class BiasLayer(Layer):
    """Additive bias on a flat node, self-loop
    (src/layer/bias_layer-inl.hpp:14; cxxnet_tpu/layer/layers.py:240)."""

    type_name = "bias"

    def infer_shape(self, in_shapes):
        b, c, h, w = in_shapes[0]
        check(c == 1 and h == 1,
              "BiasLayer only works for flatten node so far")
        if self.param.num_input_node == 0:
            self.param.num_input_node = w
        else:
            check(self.param.num_input_node == w,
                  "BiasLayer: input hidden nodes is not consistent")
        return [in_shapes[0]]

    def param_shapes(self):
        return {"bias": (self.param.num_input_node,)}

    def init_params(self, gen):
        return {"bias": torch.full((self.param.num_input_node,),
                                   self.param.init_bias, dtype=torch.float32)}

    def forward(self, params, inputs, ctx):
        return [inputs[0] + params["bias"]]

    def visit_order(self):
        return [("bias", "bias")]

    def save_model(self, w, params):
        self.param.save(w)
        w.write_tensor(params["bias"])

    def load_model(self, r):
        self.param.load(r)
        return {"bias": r.read_tensor()}


class ReluLayer(Layer):
    """Elementwise max(x, 0) (src/layer/activation_layer-inl.hpp:12)."""

    type_name = "relu"

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1,
              "ActivationLayer only support 1-1 connection")
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        return [torch.relu(inputs[0])]


class SigmoidLayer(Layer):
    """Elementwise logistic 1 / (1 + e^-x) (src/layer/activation_layer-inl.hpp;
    the JAX SigmoidLayer, cxxnet_tpu/layer/layers.py:298-300)."""

    type_name = "sigmoid"

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1,
              "ActivationLayer only support 1-1 connection")
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        return [torch.sigmoid(inputs[0])]


class TanhLayer(SigmoidLayer):
    """Elementwise tanh (src/layer/op.h; cxxnet_tpu/layer/layers.py:303)."""

    type_name = "tanh"

    def forward(self, params, inputs, ctx):
        return [torch.tanh(inputs[0])]


class SoftplusLayer(SigmoidLayer):
    """Elementwise log(1 + e^x) by jax.nn.softplus's formula
    (ops.softplus; cxxnet_tpu/layer/layers.py:308). The reference parses
    softplus but its factory has no such layer."""

    type_name = "softplus"

    def forward(self, params, inputs, ctx):
        return [ops.softplus(inputs[0])]


class XeluLayer(Layer):
    """Leaky relu with divisor b: y = x > 0 ? x : x / b
    (src/layer/xelu_layer-inl.hpp:15)."""

    type_name = "xelu"

    def __init__(self):
        super().__init__()
        self.b = 5.0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "b":
            self.b = float(val)

    def infer_shape(self, in_shapes):
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        return [ops.xelu(inputs[0], self.b)]


class InsanityLayer(Layer):
    """RReLU (src/layer/insanity_layer-inl.hpp:14; Xu et al. 2015): in
    training the negative part is divided by a per-element slope u (ub -
    lb) + lb with u ~ U[0, 1) from ``draw_uniform``, outside the gradient;
    at eval by the configured mean (lb + ub) / 2. ``calm_start`` /
    ``calm_end`` anneal [lb, ub] linearly toward the midpoint over the
    update counter, in float32 as the JAX package computes it."""

    type_name = "insanity"

    def __init__(self):
        super().__init__()
        self.lb = 5.0
        self.ub = 10.0
        self.calm_start = 0
        self.calm_end = 0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "lb":
            self.lb = float(val)
        if name == "ub":
            self.ub = float(val)
        if name == "calm_start":
            self.calm_start = int(val)
        if name == "calm_end":
            self.calm_end = int(val)

    def infer_shape(self, in_shapes):
        return [in_shapes[0]]

    def _bounds(self, epoch: int) -> Tuple[float, float]:
        """(lb, ub) after ``epoch`` updates (cxxnet_tpu/layer/layers.py
        :374-383): float32 arithmetic, the bounds unchanged when the
        schedule is off."""
        if self.calm_end <= self.calm_start:
            return self.lb, self.ub
        f32 = np.float32
        mid = (self.lb + self.ub) / 2.0
        frac = np.clip(f32(epoch - self.calm_start)
                       / f32(self.calm_end - self.calm_start),
                       f32(0.0), f32(1.0))
        ub = f32(self.ub) - f32(self.ub - mid) * frac
        lb = f32(self.lb) + f32(mid - self.lb) * frac
        return float(lb), float(ub)

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        if not ctx.train:
            return [ops.xelu(x, (self.lb + self.ub) / 2.0)]
        lb, ub = self._bounds(ctx.epoch)
        u = draw_uniform(ctx, x.shape, x.device).to(x.dtype)
        return [ops.xelu(x, u * (ub - lb) + lb)]


class PReluLayer(Layer):
    """Learnable per-channel negative slope with optional training noise
    (src/layer/prelu_layer-inl.hpp:48): y = x > 0 ? x : x * mask, the mask
    the slope (times 1 + (2u - 1) random in training, u from
    ``draw_uniform``) clipped to [0, 1]. The slope is visited, and written
    in model files, under the reference's ``bias`` tag."""

    type_name = "prelu"

    def __init__(self):
        super().__init__()
        self.init_slope = 0.25
        self.init_random = 0
        self.random = 0.0
        self.channel = 0
        self.is_fc = False

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "init_slope":
            self.init_slope = float(val)
        if name == "random_slope":
            self.init_random = int(val)
        if name == "random":
            self.random = float(val)

    def infer_shape(self, in_shapes):
        b, c, h, w = in_shapes[0]
        self.channel = w if c == 1 else c
        self.is_fc = c == 1
        return [in_shapes[0]]

    def param_shapes(self):
        return {"slope": (self.channel,)}

    def init_params(self, gen):
        if self.init_random == 0:
            slope = torch.full((self.channel,), self.init_slope,
                               dtype=torch.float32)
        else:
            slope = torch.rand((self.channel,), generator=gen,
                               dtype=torch.float32) * self.init_slope
        return {"slope": slope}

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        bshape = (1, 1, 1, self.channel) if self.is_fc \
            else (1, self.channel, 1, 1)
        mask = params["slope"].reshape(bshape).expand(x.shape)
        if ctx.train and self.random != 0.0:
            u = draw_uniform(ctx, x.shape, x.device).to(x.dtype)
            mask = mask * (1 + u * self.random * 2.0 - self.random)
        return [ops.mxelu(x, mask.clamp(0.0, 1.0))]

    def visit_order(self):
        return [("bias", "slope")]

    def save_model(self, w, params):
        w.write_tensor(params["slope"])

    def load_model(self, r):
        return {"slope": r.read_tensor()}


class MaxoutLayer(Layer):
    """Channel-group maxout (cxxnet_tpu/layer/layers.py:462; the
    reference parses ``maxout`` but never implemented it): every
    ``ngroup`` adjacent channels, or features of a flat (b, 1, 1, w)
    node, reduce by max, out[j] = max(in[j*g : (j+1)*g])."""

    type_name = "maxout"

    def infer_shape(self, in_shapes):
        b, c, h, w = in_shapes[0]
        g = self.param.num_group
        if c == 1:
            check(w % g == 0, "maxout: input width must divide ngroup")
            return [(b, 1, 1, w // g)]
        check(c % g == 0, "maxout: input channels must divide ngroup")
        return [(b, c // g, h, w)]

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        g = self.param.num_group
        b, c, h, w = x.shape
        if c == 1:
            return [x.reshape(b, 1, 1, w // g, g).amax(dim=4)]
        return [x.reshape(b, c // g, g, h, w).amax(dim=2)]


class PoolingLayer(Layer):
    """Max, sum or avg pooling with the reference's ceil-mode shapes
    (src/layer/pooling_layer-inl.hpp:17); ``pad`` pads the input first."""

    mode = "max"

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

    def _pre(self, x):
        return x

    def forward(self, params, inputs, ctx):
        p = self.param
        return [ops.pool2d(self._pre(inputs[0]), self.mode,
                           (p.kernel_height, p.kernel_width), p.stride,
                           pad=(p.pad_y, p.pad_x))]


class MaxPoolingLayer(PoolingLayer):
    type_name = "max_pooling"
    mode = "max"


class SumPoolingLayer(PoolingLayer):
    type_name = "sum_pooling"
    mode = "sum"


class AvgPoolingLayer(PoolingLayer):
    """The window's sum over kh kw, padding included (ops.pool2d)."""
    type_name = "avg_pooling"
    mode = "avg"


class ReluMaxPoolingLayer(MaxPoolingLayer):
    """relu, then max pooling (layer_impl-inl.hpp:55-56)."""
    type_name = "relu_max_pooling"

    def _pre(self, x):
        return torch.relu(x)


class InsanityPoolingLayer(MaxPoolingLayer):
    """Stochastic jittered max pooling
    (src/layer/insanity_pooling_layer-inl.hpp:13-100): in training each
    source pixel is, with probability 1 - keep, displaced one step up,
    down, left or right (equiprobable bands of the flag u ~ U[0, 1) from
    ``draw_uniform``, clamped to the image) before the ceil-mode max
    pool; a gather over the flattened h w, whose autograd is the
    reference's InsanityUnPooling. At eval a plain max pool. Departure from
    the JAX package, on purpose: the flags come from the port's Philox draw
    (jax.random there, cxxnet_tpu/layer/layers.py:781), so that the card
    and the CPU draw the same flags."""

    type_name = "insanity_max_pooling"

    def __init__(self):
        super().__init__()
        self.p_keep = 1.0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "keep":
            self.p_keep = float(val)

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        if ctx.train:
            b, c, h, w = x.shape
            flag = draw_uniform(ctx, x.shape, x.device).to(x.dtype)
            p, delta = self.p_keep, (1.0 - self.p_keep) / 4.0
            loc_y = torch.arange(h, device=x.device).reshape(1, 1, h, 1) \
                .expand(x.shape)
            loc_x = torch.arange(w, device=x.device).reshape(1, 1, 1, w) \
                .expand(x.shape)
            loc_y = torch.where((flag >= p) & (flag < p + delta),
                                (loc_y - 1).clamp_min(0), loc_y)
            loc_y = torch.where((flag >= p + delta) & (flag < p + 2 * delta),
                                (loc_y + 1).clamp_max(h - 1), loc_y)
            loc_x = torch.where((flag >= p + 2 * delta)
                                & (flag < p + 3 * delta),
                                (loc_x - 1).clamp_min(0), loc_x)
            loc_x = torch.where(flag >= p + 3 * delta,
                                (loc_x + 1).clamp_max(w - 1), loc_x)
            idx = (loc_y * w + loc_x).reshape(b, c, h * w)
            x = x.reshape(b, c, h * w).gather(2, idx).reshape(b, c, h, w)
        return super().forward(params, [x], ctx)


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
        u = ctx.data_rows(tuple(x.shape), lambda s: torch.rand(
            s, generator=ctx.gen, dtype=x.dtype, device=x.device))
        return [x * ((u < pkeep).to(x.dtype) / pkeep)]


class BatchNormLayer(Layer):
    """Batch normalization (src/layer/batch_norm_layer-inl.hpp:14;
    cxxnet_tpu/layer/layers.py:844-950): over (batch, h, w) per channel of
    a conv node, or per feature of a flat (b, 1, 1, n) node. By default
    eval normalizes with the minibatch's own statistics too (the
    reference's behaviour). ``moving_average = 1`` keeps float32
    ``running_mean`` / ``running_var``: training records their EMA update
    (``bn_momentum``, default 0.9) in ``ctx.state_updates``, which the
    trainer writes into the params after the step, and eval normalizes
    with them. ``slope`` is visited under the ``wmat`` tag and ``bias``
    under ``bias``; the running statistics are state (``state_keys``)."""

    type_name = "batch_norm"

    def __init__(self):
        super().__init__()
        self.init_slope = 1.0
        self.init_bias = 0.0
        self.eps = 1e-10
        self.moving_average = 0
        self.bn_momentum = 0.9
        self.is_fc = False
        self.channel = 0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "init_slope":
            self.init_slope = float(val)
        if name == "init_bias":
            self.init_bias = float(val)
        if name == "eps":
            self.eps = float(val)
        if name == "moving_average":
            self.moving_average = int(val)
        if name == "bn_momentum":
            self.bn_momentum = float(val)

    def infer_shape(self, in_shapes):
        b, c, h, w = in_shapes[0]
        self.is_fc = c == 1
        self.channel = w if self.is_fc else c
        return [in_shapes[0]]

    def param_shapes(self):
        keys = ("slope", "bias") + self.state_keys()
        return {k: (self.channel,) for k in keys}

    def init_params(self, gen):
        f32 = dict(dtype=torch.float32)
        out = {"slope": torch.full((self.channel,), self.init_slope, **f32),
               "bias": torch.full((self.channel,), self.init_bias, **f32)}
        if self.moving_average:
            out["running_mean"] = torch.zeros((self.channel,), **f32)
            out["running_var"] = torch.ones((self.channel,), **f32)
        return out

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        xf = x.float()
        if self.is_fc:
            dims, bshape = (0, 1, 2), (1, 1, 1, self.channel)
        else:
            dims, bshape = (0, 2, 3), (1, self.channel, 1, 1)
        if self.moving_average and not ctx.train:
            mean = params["running_mean"].reshape(bshape).to(x.dtype)
            var = params["running_var"].reshape(bshape).to(x.dtype)
        else:
            # the statistics summed in f32 and rounded to x's dtype, as
            # jnp.mean of bf16 gives them; over the whole batch when its
            # rows are split over the data group, as JAX's program over
            # the sharded batch computes them
            mean = self._batch_mean(xf, dims, ctx).to(x.dtype)
            var = self._batch_mean(torch.square(xf - mean.float()), dims,
                                   ctx).to(x.dtype)
        if self.moving_average and ctx.train:
            m = self.bn_momentum
            # a share-tied BN folds every application's statistics in turn
            km = (ctx.layer_index, "running_mean")
            kv = (ctx.layer_index, "running_var")
            base_mean = ctx.state_updates.get(km, params["running_mean"])
            base_var = ctx.state_updates.get(kv, params["running_var"])
            ctx.state_updates[km] = (
                m * base_mean + (1 - m) * mean.reshape(-1).float()).detach()
            ctx.state_updates[kv] = (
                m * base_var + (1 - m) * var.reshape(-1).float()).detach()
        # the elementwise normalization in f32, rounded once to x's dtype:
        # what XLA's fusion of it computes for a bf16 x
        xhat = (xf - mean.float()) / torch.sqrt(var.float() + self.eps)
        y = xhat * params["slope"].reshape(bshape).float() \
            + params["bias"].reshape(bshape).float()
        return [y.to(x.dtype)]

    @staticmethod
    def _batch_mean(v, dims, ctx):
        if not ctx.data_sharded:
            return v.mean(dim=dims, keepdim=True)
        n = 1
        for d in dims:
            n *= v.shape[d]
        g = ctx.mesh.group("data")
        return collectives.all_reduce(v.sum(dim=dims, keepdim=True), g,
                                      sum_grad=True) / (n * g.n)

    def visit_order(self):
        return [("wmat", "slope"), ("bias", "bias")]

    def state_keys(self):
        return ("running_mean", "running_var") if self.moving_average \
            else ()

    def save_model(self, w, params):
        for k in ("slope", "bias") + self.state_keys():
            w.write_tensor(params[k])

    def load_model(self, r):
        return {k: r.read_tensor()
                for k in ("slope", "bias") + self.state_keys()}


class LossLayerBase(Layer):
    """Loss layers, self-loop (src/layer/loss/loss_layer_base-inl.hpp):
    the forward writes the transformed node, and with labels present it
    appends a scalar loss whose gradient is the reference's
    (transformed - target) * grad_scale / (batch_size * update_period).
    ``batch_size`` is the configured one, which reaches the layer through
    the global config, not the rows of the batch."""

    is_loss = True

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
    reference) makes the target (1-eps) one-hot + eps/K uniform. ``seq =
    1`` (beyond the reference) is the per-position softmax of a sequence
    node (b, vocab, 1, L) with L labels per row: the LM loss."""

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

    def transform(self, x2d):
        return ops.softmax(x2d, axis=-1)

    def _ce(self, logp, tgt):
        eps = self.label_smooth
        if eps == 0.0:
            return -tgt
        return -((1.0 - eps) * tgt + eps / logp.shape[-1] * logp.sum(-1))

    def loss_term(self, x2d, label):
        logp = torch.log_softmax(x2d, dim=-1)
        tgt = logp.gather(1, label[:, :1].long())[:, 0]
        return self._ce(logp, tgt).sum() * self._scale()

    def forward(self, params, inputs, ctx):
        if not self.seq:
            return super().forward(params, inputs, ctx)
        x = inputs[0]
        b, v, h, L = x.shape
        check(h == 1, "softmax seq=1 needs a (batch, vocab, 1, seq) node")
        logits = x.reshape(b, v, L).transpose(1, 2)          # (b, L, v)
        out = torch.softmax(logits, dim=-1)
        if ctx.labels is not None:
            label = ctx.labels.field(self.target)            # (b, L)
            check(label.shape[1] == L,
                  "softmax seq=1: label field width %d != seq length %d"
                  % (label.shape[1], L))
            logp = torch.log_softmax(logits, dim=-1)
            tgt = logp.gather(2, label.long()[..., None])[..., 0]
            ctx.losses.append(self._ce(logp, tgt).sum() / L * self._scale())
        return [out.transpose(1, 2).reshape(b, v, 1, L)]


class L2LossLayer(LossLayerBase):
    """Identity forward; the loss 0.5 sum (x - y)^2 times the scale, whose
    gradient is (x - y) * scale (src/layer/loss/l2_loss_layer-inl.hpp:12;
    cxxnet_tpu/layer/layers.py:1071)."""

    type_name = "l2_loss"

    def loss_term(self, x2d, label):
        return 0.5 * torch.square(x2d - label).sum() * self._scale()


class MultiLogisticLayer(LossLayerBase):
    """Elementwise sigmoid forward; the summed binary cross-entropy with
    logits times the scale, whose gradient is (sigmoid(x) - y) * scale
    (src/layer/loss/multi_logistic_layer-inl.hpp:12;
    cxxnet_tpu/layer/layers.py:1081)."""

    type_name = "multi_logistic"

    def transform(self, x2d):
        return torch.sigmoid(x2d)

    def loss_term(self, x2d, label):
        bce = torch.clamp_min(x2d, 0) - x2d * label \
            + torch.log1p(torch.exp(-x2d.abs()))
        return bce.sum() * self._scale()


class ConcatLayer(Layer):
    """2-4 inputs concatenated along dim 3 (src/layer/concat_layer-inl.hpp:12);
    every other dim must match."""

    type_name = "concat"
    dim = 3

    def infer_shape(self, in_shapes):
        check(1 < len(in_shapes) <= 4, "Concat layer supports 2-4 inputs")
        oshape = list(in_shapes[0])
        total = 0
        for s in in_shapes:
            total += s[self.dim]
            for j in range(4):
                if j != self.dim:
                    check(s[j] == oshape[j], "Concat shape doesn't match")
        oshape[self.dim] = total
        return [tuple(oshape)]

    def forward(self, params, inputs, ctx):
        return [torch.cat(inputs, dim=self.dim)]


class ChConcatLayer(ConcatLayer):
    """Concat along the channel dim (layer_impl-inl.hpp:62): the inception
    module's join."""
    type_name = "ch_concat"
    dim = 1


class SplitLayer(Layer):
    """1->N copy forward, summed gradients backward
    (src/layer/split_layer-inl.hpp:12)."""

    type_name = "split"

    def __init__(self, n_out: int = 2):
        super().__init__()
        # fan-out; the net sets it from the connection's out-node count
        self.n_out = n_out

    def infer_shape(self, in_shapes):
        return [in_shapes[0]] * self.n_out

    def forward(self, params, inputs, ctx):
        return [inputs[0]] * self.n_out


class AddLayer(Layer):
    """Elementwise sum of 2-4 same-shaped inputs (beyond the reference): the
    residual connection of transformer stacks."""

    type_name = "add"

    def infer_shape(self, in_shapes):
        check(2 <= len(in_shapes) <= 4, "AddLayer takes 2-4 inputs")
        for s in in_shapes[1:]:
            check(s == in_shapes[0], "add: input shapes must all match")
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return [out]


class Im2SeqLayer(Layer):
    """(b, d, h, w) feature map -> (b, d, 1, h*w) sequence, positions in
    row-major order (cxxnet_tpu/layer/layers.py:1471): a patch-embedding
    conv (kernel_size = stride = patch) and im2seq make ViT's front end."""

    type_name = "im2seq"

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1, "Im2SeqLayer only support 1-1 connection")
        b, d, h, w = in_shapes[0]
        return [(b, d, 1, h * w)]

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        b, d, h, w = x.shape
        return [x.reshape(b, d, 1, h * w)]


class EmbedLayer(Layer):
    """Token embedding (beyond the reference): input node (b, 1, 1, L) of
    token ids stored as floats, output (b, nhidden, 1, L). Weight
    (vocab_size, nhidden) under the 'wmat' tag; ``pos_embed = 1`` adds a
    learned, zero-initialised (L, nhidden) position table under 'bias'."""

    type_name = "embed"
    integer_inputs = True

    def __init__(self):
        super().__init__()
        self.vocab_size = 0
        self.pos_embed = 0
        self._seq_len = 0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "vocab_size":
            self.vocab_size = int(val)
        if name == "pos_embed":
            self.pos_embed = int(val)

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1, "EmbedLayer only support 1-1 connection")
        b, c, h, L = in_shapes[0]
        check(c == 1 and h == 1,
              "embed input must be (batch, 1, 1, seq) token ids")
        check(self.vocab_size > 0, "must set vocab_size")
        check(self.param.num_hidden > 0, "must set nhidden (embedding dim)")
        self._seq_len = L
        return [(b, self.param.num_hidden, 1, L)]

    def param_shapes(self):
        d = self.param.num_hidden
        out = {"wmat": (self.vocab_size, d)}
        if self.pos_embed:
            out["pos"] = (self._seq_len, d)
        return out

    def init_params(self, gen):
        d = self.param.num_hidden
        out = {"wmat": self.param.rand_init_weight(
            gen, (self.vocab_size, d), self.vocab_size, d)}
        if self.pos_embed:
            out["pos"] = torch.zeros((self._seq_len, d), dtype=torch.float32)
        return out

    def save_model(self, w, params):
        self.param.save(w)
        w.write_tensor(params["wmat"])
        if self.pos_embed:
            w.write_tensor(params["pos"])

    def load_model(self, r):
        self.param.load(r)
        out = {"wmat": r.read_tensor()}
        if self.pos_embed:
            out["pos"] = r.read_tensor()
        return out

    def visit_order(self):
        if self.pos_embed:
            return [("wmat", "wmat"), ("bias", "pos")]
        return [("wmat", "wmat")]

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        b, _, _, L = x.shape
        # F.embedding's backward sums each id's rows in a fixed order; an
        # indexing's accumulating backward does not on a CPU with threads,
        # and the model ranks' replicas of the table then drift apart
        emb = torch.nn.functional.embedding(x.reshape(b, L).long(),
                                            params["wmat"])   # (b, L, d)
        if self.pos_embed:
            pos = params["pos"]
            dp = ctx.decode_pos
            if torch.is_tensor(dp):
                # a session step: row r at its own position dp[r]
                pos = pos[dp[:, None] + torch.arange(L, device=dp.device)]
            elif dp is not None:
                # a decode step covers positions [decode_pos, decode_pos + L)
                pos = pos[dp:dp + L]
            emb = emb + pos
        return [emb.transpose(1, 2).reshape(b, -1, 1, L)]


class AttentionLayer(Layer):
    """Multi-head self-attention over sequence nodes (b, D, 1, L) (beyond
    the reference; cxxnet_tpu/layer/layers.py:1097-1392 for one device).
    ``causal``, ``rope`` / ``rope_base`` (rotary embedding, angles in
    float32), ``nkvhead`` (grouped-query attention: k/v carry fewer heads)
    and ``attn_window`` (sliding window, causal only). A sequence the flash
    kernel takes (ops.flash_attn.supports) goes to it, any other to dense
    attention. Under the trainer's ``seq_parallel = n`` (the apply
    context's ``seq_parallel``) a full-sequence forward runs ring or
    Ulysses attention (``sp_mode``) over n virtual ranks of the sequence
    (parallel/ring.py; cxxnet_tpu/layer/layers.py:1334-1364); over a
    world of several ranks the mesh's ``sp`` axis takes that place, each
    rank its shard (inside a pipeline stage, its query chunk). In a
    KV-cached decode forward the layer writes its k/v into the caches at
    ``decode_pos``; the prefill (position 0) attends within its own chunk,
    through the flash kernel where it takes the shape; a suffix prefill (a
    paged admission that reuses a resident prefix, at a position > 0)
    attends against the live cache [0, pos + L) as the whole prompt's
    prefill would; a one-token step attends against the whole cache,
    densely in the activation dtype, or with ``decode_chunk > 0`` over its
    live chunks, accumulating in float32
    (parallel/ring.py ``decode_attention_chunked``). A session step gives
    each row its own position (``decode_pos`` a (b,) tensor)."""

    type_name = "attention"

    def __init__(self):
        super().__init__()
        self.nhead = 1
        self.causal = 0
        self.rope = 0
        self.rope_base = 10000.0
        self.nkvhead = 0          # 0 -> nhead (classic MHA)
        self.attn_window = 0
        self.sp_mode = "ring"     # sequence parallelism: ring or ulysses
        # decode_chunk > 0: a one-token decode step reads the cache in
        # chunks of this many rows, live ones only (flash-decode)
        self.decode_chunk = 0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "nhead":
            self.nhead = int(val)
        if name == "causal":
            self.causal = int(val)
        if name == "rope":
            self.rope = int(val)
        if name == "rope_base":
            self.rope_base = float(val)
        if name == "nkvhead":
            self.nkvhead = int(val)
        if name == "attn_window":
            self.attn_window = int(val)
        if name == "decode_chunk":
            self.decode_chunk = int(val)
            check(self.decode_chunk >= 0, "decode_chunk must be >= 0")
        if name == "sp_mode":
            check(val in ("ring", "ulysses"),
                  "sp_mode must be ring or ulysses")
            self.sp_mode = val

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1,
              "AttentionLayer only support 1-1 connection")
        b, d, h, L = in_shapes[0]
        check(h == 1, "attention input must be (batch, d_model, 1, seq)")
        check(d % self.nhead == 0, "nhead must divide d_model")
        if self.rope:
            check((d // self.nhead) % 2 == 0, "rope needs an even head dim")
        if self.nkvhead:
            check(self.nhead % self.nkvhead == 0,
                  "nkvhead must divide nhead")
        if self.attn_window:
            check(self.attn_window > 0, "attn_window must be positive")
            check(self.causal, "attn_window requires causal = 1")
        self.param.num_input_channel = d
        return [in_shapes[0]]

    def _kv_width(self, d: int) -> int:
        return (self.nkvhead or self.nhead) * (d // self.nhead)

    def param_shapes(self):
        d = self.param.num_input_channel
        return {"wqkv": (d, d + 2 * self._kv_width(d)), "wo": (d, d)}

    def init_params(self, gen):
        d = self.param.num_input_channel
        w = d + 2 * self._kv_width(d)    # [q | k | v] columns
        return {"wqkv": self.param.rand_init_weight(gen, (d, w), d, w),
                "wo": self.param.rand_init_weight(gen, (d, d), d, d)}

    def save_model(self, w, params):
        self.param.save(w)
        w.write_tensor(params["wqkv"])
        w.write_tensor(params["wo"])

    def load_model(self, r):
        self.param.load(r)
        return {"wqkv": r.read_tensor(), "wo": r.read_tensor()}

    def visit_order(self):
        return [("wmat", "wqkv"), ("wo", "wo")]

    def _apply_rope(self, x: torch.Tensor, offset=0) -> torch.Tensor:
        """Rotary embedding on (b, nh, L, dh): rotate the (first-half,
        second-half) feature pairs by angles (offset + position) *
        rope_base^(-i / half), computed in float32. ``offset`` is the
        global position of row 0: an int, or a (b,) tensor of one offset
        per batch row (a session step)."""
        half = x.shape[-1] // 2
        f32 = dict(dtype=torch.float32, device=x.device)
        if torch.is_tensor(offset):
            pos = offset.to(torch.float32).reshape(-1, 1, 1, 1) \
                + torch.arange(x.shape[2], **f32)[:, None]   # (b, 1, L, 1)
        else:
            pos = offset + torch.arange(x.shape[2], **f32)[:, None]
        inv = torch.pow(self.rope_base, -torch.arange(half, **f32) / half)
        ang = pos * inv                               # (L, half) or (b, ...)
        cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _attend(self, q, k, v, causal: bool, dh: int):
        """Full-sequence attention within the input: the flash kernel where
        it takes the shape, dense attention otherwise."""
        if flash_attn.supports(q.shape[2], dh):
            return flash_attn.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=causal, window=self.attn_window)
        return attention_reference(q, k, v, causal=causal, scale=dh ** -0.5,
                                   window=self.attn_window)

    def _attend_seq_parallel(self, q, k, v, sp: int, group=None):
        """Attention over sp sequence shards (the JAX package's mesh
        branch, cxxnet_tpu/layer/layers.py:1334-1364): q, k and v were
        computed, and rotated, over the whole sequence before the split.
        With ``group`` (the mesh's sp group) each rank attends its own
        shard through the ring or Ulysses over the process group: its
        shard is split off with a backward that all-gathers the shards'
        gradients, and the shards' outputs are gathered with a backward
        that keeps this rank's block, so every sp rank goes on with the
        whole sequence and holds the whole gradient. Without, the ring
        runs sp virtual ranks on this device."""
        nh, nkv, L = q.shape[1], k.shape[1], q.shape[2]
        check(L % sp == 0, "attention: seq length %d must be divisible by "
              "seq_parallel %d" % (L, sp))
        if self.sp_mode == "ulysses":
            check(nh % sp == 0, "ulysses: nhead %d must be divisible by "
                  "seq_parallel %d" % (nh, sp))
            if nkv != nh and nkv % sp != 0:
                # ulysses' head-split all-to-all needs sp | kv heads;
                # broadcast up front when the grouping doesn't divide
                k = k.repeat_interleave(nh // nkv, 1)
                v = v.repeat_interleave(nh // nkv, 1)
            fn = ring.ulysses_attention
        else:
            # the ring takes grouped k/v as they are: the blocks that
            # rotate are nkvhead-sized
            fn = ring.ring_attention
        if group is None:
            return fn(q, k, v, n=sp, causal=bool(self.causal),
                      window=self.attn_window)
        q, k, v = (collectives.split(t, group, dim=2) for t in (q, k, v))
        out = fn(q.contiguous(), k.contiguous(), v.contiguous(),
                 group=group.pg, causal=bool(self.causal),
                 window=self.attn_window)
        return collectives.all_gather(out, group, dim=2)

    def _attend_stage_chunk(self, q, k, v, group, dh: int):
        """Sequence parallelism inside a pipeline stage
        (cxxnet_tpu/layer/layers.py:1311-1333): k/v are already whole on
        every sp rank, so each rank attends its query chunk against them
        at its global causal offset (``ring.chunk_attention``: the
        ring-step kernels as one step) and a gather over sp rebuilds the
        sequence. The chunk's gradient is all-gathered and k/v's summed
        over sp, so every rank holds the whole gradient."""
        L, n = q.shape[2], group.n
        check(L % n == 0, "attention: seq length %d must be divisible by "
              "seq_parallel %d" % (L, n))
        chunk = L // n
        q_l = collectives.split(q, group, dim=2)
        k = collectives.enter_group(k, group)
        v = collectives.enter_group(v, group)
        out = ring.chunk_attention(
            q_l, k.contiguous(), v.contiguous(),
            q_offset=group.index * chunk, causal=bool(self.causal),
            scale=dh ** -0.5, window=self.attn_window)
        return collectives.all_gather(out, group, dim=2)

    def _attend_cached(self, q, k, v, ctx, dh: int):
        """KV-cached decode: write this input's k/v into the caches at
        [pos, pos + L), in place (the JAX package returns updated copies),
        record them as the updated caches, and attend
        (cxxnet_tpu/layer/layers.py:1253-1310)."""
        pos = ctx.decode_pos
        li = ctx.conn_index
        ck, cv = ctx.kv_cache[(li, "k")], ctx.kv_cache[(li, "v")]
        b, L = q.shape[0], q.shape[2]
        if torch.is_tensor(pos):
            # a session step: row r writes its one position pos[r]
            check(L == 1, "attention: a per-row decode position takes one "
                  "token a row, not %d" % L)
            rows = torch.arange(b, device=pos.device)
            ck[rows, :, pos] = k[:, :, 0]
            cv[rows, :, pos] = v[:, :, 0]
        else:
            ck[:, :, pos:pos + L] = k
            cv[:, :, pos:pos + L] = v
        ctx.cache_updates[(li, "k")] = ck
        ctx.cache_updates[(li, "v")] = cv
        scale = dh ** -0.5
        if not torch.is_tensor(pos) and L > 1:
            if pos == 0:
                # prefill: attention within the chunk equals cache
                # attention at offset 0 (later slots are causally masked)
                return self._attend(q, k, v, True, dh)
            # suffix prefill (a paged admission that reuses a resident
            # prefix): positions [pos, pos + L) against the live cache
            # [0, pos + L), by what the whole prompt's prefill takes at
            # that width, so that its rows are the whole prefill's rows:
            # the flash kernel over the live cache with the prefix's query
            # rows left zero (each row of its output depends on its own
            # query alone), dense attention of softmax width pos + L else
            width = pos + L
            if flash_attn.supports(width, dh):
                qf = q.new_zeros(q.shape[:2] + (width, dh))
                qf[:, :, pos:] = q
                return self._attend(qf, ck[:, :, :width], cv[:, :, :width],
                                    True, dh)[:, :, pos:]
            return attention_reference(
                q, ck[:, :, :width], cv[:, :, :width], causal=True,
                scale=scale, window=self.attn_window, q_offset=pos)
        if self.decode_chunk > 0 and ck.shape[2] % self.decode_chunk == 0:
            # flash-decode: an online softmax over the live chunks only
            return ring.decode_attention_chunked(
                q, ck, cv, pos=pos, span=ctx.decode_span, scale=scale,
                window=self.attn_window, chunk=self.decode_chunk)
        # a one-position step against the whole cache, in the activation
        # dtype as in the JAX package
        return attention_reference(q, ck, cv, causal=True, scale=scale,
                                   window=self.attn_window, q_offset=pos)

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        b, d, _, L = x.shape
        seq = x.reshape(b, d, L).transpose(1, 2)             # (b, L, d)
        nh, dh = self.nhead, d // self.nhead
        nkv = self.nkvhead or nh
        kvw = self._kv_width(d)
        qkv = seq @ params["wqkv"]                          # (b, L, d+2kvw)

        def heads(t, n):  # (b, L, n*dh) -> (b, n, L, dh)
            return t.reshape(b, L, n, dh).transpose(1, 2)

        q = heads(qkv[..., :d], nh)
        k = heads(qkv[..., d:d + kvw], nkv)
        v = heads(qkv[..., d + kvw:], nkv)
        pos = ctx.decode_pos
        if self.rope:
            off = pos if pos is not None else 0
            q, k = self._apply_rope(q, off), self._apply_rope(k, off)
        sp_axis = ctx.mesh.axis_size("sp") if ctx.mesh is not None else 1
        if pos is not None:
            out = self._attend_cached(q, k, v, ctx, dh)
        elif sp_axis > 1 and ctx.in_stage:
            out = self._attend_stage_chunk(q, k, v, ctx.mesh.group("sp"), dh)
        elif sp_axis > 1:
            out = self._attend_seq_parallel(q, k, v, sp_axis,
                                            ctx.mesh.group("sp"))
        elif ctx.seq_parallel > 1:
            out = self._attend_seq_parallel(q, k, v, ctx.seq_parallel)
        else:
            out = self._attend(q, k, v, bool(self.causal), dh)
        out = out.transpose(1, 2).reshape(b, L, d) @ params["wo"]
        return [out.transpose(1, 2).reshape(b, d, 1, L)]


class MoELayer(Layer):
    """Mixture-of-experts FFN (cxxnet_tpu/layer/layers.py
    :1519, its dense dispatch without a mesh): input (b, 1, 1, din) ->
    (b, 1, 1, nhidden) through ``nexpert`` experts relu(x @ W_e), combined
    by a softmax gate. ``top_k > 0`` keeps exactly k gate probabilities
    a row, ties taken in index order as ``jax.lax.top_k`` takes them (a
    stable sort), renormalized; every expert still runs on every row.
    Model file: LayerParam, then ``<ii`` nexpert and top_k, then gate
    (E, din) and experts (E, din, dout); visited as ``wmat`` -> experts,
    ``gate`` -> gate. Under the trainer's ``expert_parallel`` each rank
    holds its slice of the experts and the ep group sums the parts
    (``parallel.tensor.expert_parallel_ffn``)."""

    type_name = "moe"

    def __init__(self):
        super().__init__()
        self.n_expert = 0
        self.top_k = 0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "nexpert":
            self.n_expert = int(val)
        if name == "top_k":
            self.top_k = int(val)

    def infer_shape(self, in_shapes):
        check(len(in_shapes) == 1, "MoELayer only support 1-1 connection")
        b, c, h, w = in_shapes[0]
        check(c == 1 and h == 1,
              "moe input must be flattened (batch, 1, 1, d); add a flatten "
              "layer first")
        check(self.n_expert > 0, "must set nexpert")
        check(self.param.num_hidden > 0, "must set nhidden")
        check(self.top_k <= self.n_expert, "top_k cannot exceed nexpert")
        self.param.num_input_node = w
        return [(b, 1, 1, self.param.num_hidden)]

    def param_shapes(self):
        din, dout = self.param.num_input_node, self.param.num_hidden
        return {"gate": (self.n_expert, din),
                "experts": (self.n_expert, din, dout)}

    def init_params(self, gen):
        din, dout = self.param.num_input_node, self.param.num_hidden
        e = self.n_expert
        return {"gate": self.param.rand_init_weight(gen, (e, din), din, e),
                "experts": self.param.rand_init_weight(
                    gen, (e, din, dout), din, dout)}

    def save_model(self, w, params):
        self.param.save(w)
        w.write_raw(struct.pack("<ii", self.n_expert, self.top_k))
        w.write_tensor(params["gate"])
        w.write_tensor(params["experts"])

    def load_model(self, r):
        self.param.load(r)
        self.n_expert, self.top_k = struct.unpack("<ii", r.read_raw(8))
        return {"gate": r.read_tensor(), "experts": r.read_tensor()}

    def visit_order(self):
        return [("wmat", "experts"), ("gate", "gate")]

    def gate_probs(self, x2: torch.Tensor, gate: torch.Tensor):
        """(b, E) combine weights: the softmax gate, cut to exactly top_k
        a row and renormalized when 0 < top_k < nexpert."""
        probs = torch.softmax(x2 @ gate.t(), dim=-1)
        if self.top_k and self.top_k < self.n_expert:
            idx = torch.sort(probs, dim=1, descending=True,
                             stable=True).indices[:, :self.top_k]
            mask = torch.zeros_like(probs).scatter_(1, idx, 1.0)
            probs = probs * mask
            probs = probs / probs.sum(dim=-1, keepdim=True)
        return probs

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        b = x.shape[0]
        x2 = x.reshape(b, -1)
        probs = self.gate_probs(x2, params["gate"])
        n_ep = ctx.mesh.axis_size("ep") if ctx.mesh is not None else 1
        if n_ep > 1:
            # this rank's slice of the experts (tp_spec), the ranks' gate-
            # weighted parts summed over the ep group
            out = tensor.expert_parallel_ffn(
                x2, params["experts"], probs, ctx.mesh.group("ep"))
        else:
            y = torch.relu(torch.einsum("bi,eio->ebo", x2,
                                        params["experts"]))
            out = torch.einsum("ebo,be->bo", y, probs)
        return [out.reshape(b, 1, 1, self.param.num_hidden)]


LAYER_CLASSES: Dict[str, type] = {
    cls.type_name: cls for cls in (
        FullConnectLayer, ConvolutionLayer, ReluLayer, SigmoidLayer,
        XeluLayer, InsanityLayer, PReluLayer, MaxPoolingLayer,
        SumPoolingLayer, AvgPoolingLayer, ReluMaxPoolingLayer,
        InsanityPoolingLayer, LRNLayer, FlattenLayer, DropoutLayer,
        BatchNormLayer, SoftmaxLayer, ConcatLayer, ChConcatLayer,
        SplitLayer, AddLayer, EmbedLayer, AttentionLayer, FixConnectLayer,
        BiasLayer, TanhLayer, SoftplusLayer, MaxoutLayer, L2LossLayer,
        MultiLogisticLayer, Im2SeqLayer, MoELayer)}
