"""Extern layer: a user-supplied torch op inside the net.

Counterpart of cxxnet_tpu/layer/extern.py, the answer to the reference's
caffe adapter (src/plugin/caffe_adapter-inl.hpp:27-200): "embed an
externally implemented layer, with its own weights, into the net". The
op is a torch function registered under a name; its backward is
autograd's.

Usage::

    from cxxnet_tpu_torch.layer import register_extern

    @register_extern("scale_shift")
    class ScaleShift:
        def infer_shape(self, in_shapes, setting):
            return [in_shapes[0]]
        def init_params(self, gen, in_shapes, setting):
            c = in_shapes[0][1]
            return {"scale": torch.ones(c), "shift": torch.zeros(c)}
        def apply(self, params, inputs, *, train, generator):
            x = inputs[0]
            return [x * params["scale"][:, None, None]
                    + params["shift"][:, None, None]]

    # config:
    #   layer[+1:ext1] = extern:ext1
    #     op = scale_shift
    #     any_key = any_value        # passed through in `setting`

``init_params`` draws from ``gen``, a host ``torch.Generator``, and may
return tensors or numpy arrays. ``apply`` gets the layer's own generator
of the forward (None outside training). The weights are visited by the
updaters under the tags ``blob0``, ``blob1``, ... in sorted-key order (the
reference's blob tags, so ``blob0:lr`` works) and written in the model
file as the JAX layer writes them: LayerParam, the op name, the settings,
then each weight by name in sorted order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import Layer, check

# name -> op instance (classes are instantiated on registration)
_EXTERN_REGISTRY: Dict[str, object] = {}


def register_extern(name: str, op: object = None):
    """Register an external op under ``name``. Usable as a decorator (on a
    class or an instance) or called directly."""

    def _do(op_obj):
        if isinstance(op_obj, type):
            op_obj = op_obj()
        check(hasattr(op_obj, "infer_shape") and hasattr(op_obj, "apply"),
              "extern op %r must define infer_shape() and apply()" % name)
        _EXTERN_REGISTRY[name] = op_obj
        return op_obj

    if op is None:
        return _do
    return _do(op)


def get_extern(name: str):
    if name not in _EXTERN_REGISTRY:
        raise ValueError(
            "extern op %r is not registered; call "
            "cxxnet_tpu_torch.layer.register_extern(%r, op) before building "
            "the net (available: %s)"
            % (name, name, sorted(_EXTERN_REGISTRY) or "none"))
    return _EXTERN_REGISTRY[name]


def _f32(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


class ExternLayer(Layer):
    """The net's wrapper over a registered external op: the reference's
    caffe-plugin slot (type id 20, src/layer/layer.h:296). Every ``key =
    value`` setting but ``op`` goes to the op verbatim."""

    type_name = "extern"

    def __init__(self):
        super().__init__()
        self.op_name = ""
        self.setting: Dict[str, str] = {}
        self._in_shapes = None
        self._shapes = None

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "op":
            self.op_name = val
        else:
            self.setting[name] = val

    def _op(self):
        check(bool(self.op_name), "extern layer: must set op = <name>")
        return get_extern(self.op_name)

    def infer_shape(self, in_shapes):
        self._in_shapes = list(in_shapes)
        self._shapes = None
        out = self._op().infer_shape(list(in_shapes), dict(self.setting))
        return [tuple(int(d) for d in s) for s in out]

    def init_params(self, gen):
        init = getattr(self._op(), "init_params", None)
        if init is None:
            return {}
        out = init(gen, list(self._in_shapes), dict(self.setting))
        return {k: _f32(v) for k, v in out.items()}

    def param_shapes(self):
        # the op's weight shapes, from one draw of its init (the net asks
        # before any weight exists)
        if self._shapes is None:
            probe = self.init_params(torch.Generator().manual_seed(0))
            self._shapes = {k: tuple(v.shape) for k, v in probe.items()}
        return dict(self._shapes)

    def forward(self, params, inputs, ctx):
        out = self._op().apply(params, list(inputs), train=ctx.train,
                               generator=ctx.gen if ctx.train else None)
        check(isinstance(out, (list, tuple)),
              "extern op %r apply() must return a list of outputs"
              % self.op_name)
        return list(out)

    def visit_order(self):
        return [("blob%d" % i, k)
                for i, k in enumerate(sorted(self.param_shapes()))]

    def save_model(self, w, params) -> None:
        self.param.save(w)
        w.write_string(self.op_name)
        w.write_uint64(len(self.setting))
        for k in sorted(self.setting):
            w.write_string(k)
            w.write_string(self.setting[k])
        keys = sorted(params)
        w.write_uint64(len(keys))
        for k in keys:
            w.write_string(k)
            w.write_tensor(np.asarray(params[k], np.float32))

    def load_model(self, r):
        self.param.load(r)
        self.op_name = r.read_string()
        # saved settings restore the op's config; the config file's pairs,
        # applied before, take precedence, as in the JAX layer
        for _ in range(r.read_uint64()):
            k = r.read_string()
            v = r.read_string()
            self.setting.setdefault(k, v)
        out = {}
        for _ in range(r.read_uint64()):
            k = r.read_string()
            out[k] = r.read_tensor()
        self._shapes = {k: tuple(v.shape) for k, v in out.items()}
        return out
