"""Carry weights and optimizer state from the JAX package into the port.

The port keeps the JAX package's parameter layouts (conv wmat as
(ngroup, co/g, ci/g*kh*kw), fullc wmat as (num_hidden, num_input), one dict
per connection) and its optimizer-state layout (one dict per connection of
{param key: {state key: array}}), so the conversion is the identity on
layouts. What it adds is the check: every key and shape must be the one the
port's net and updaters expect. Model files written by the JAX package need
no conversion at all; they load directly through ``Net.load_model``,
optimizer state included.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .layer.base import check
from .nnet.net import NeuralNet
from .nnet.trainer import OptState, Trainer


def params_from_jax(params: Sequence[Dict[str, object]], net: NeuralNet,
                    device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """Port params from a JAX params list (``Trainer.canonical_params()``,
    arrays or anything ``np.asarray`` takes): float32 tensors on ``device``.
    Raises ValueError on a missing or extra layer, key or a wrong shape."""
    want = net.param_shapes()
    check(len(params) == len(want),
          "params_from_jax: %d layers given, the net has %d"
          % (len(params), len(want)))
    out = []
    for i, (p, shapes) in enumerate(zip(params, want)):
        check(set(p) == set(shapes),
              "params_from_jax: layer %d has keys %s, the net expects %s"
              % (i, sorted(p), sorted(shapes)))
        layer = {}
        for k, v in p.items():
            arr = np.asarray(v, np.float32)
            check(arr.shape == tuple(shapes[k]),
                  "params_from_jax: layer %d %s has shape %s, the net "
                  "expects %s" % (i, k, arr.shape, tuple(shapes[k])))
            layer[k] = torch.from_numpy(arr.copy()).to(device)
        out.append(layer)
    return out


def opt_state_from_jax(opt_state: Sequence[Dict[str, Dict[str, object]]],
                       trainer: Trainer) -> OptState:
    """Port optimizer state from a JAX opt_state list (``Trainer.opt_state``
    of the JAX package, arrays or anything ``np.asarray`` takes): float32
    tensors on the trainer's device, checked against the states the
    trainer's updaters keep. Raises ValueError on a missing or extra
    layer, key or state, or a wrong shape."""
    want = trainer.opt_state
    check(len(opt_state) == len(want),
          "opt_state_from_jax: %d layers given, the trainer has %d"
          % (len(opt_state), len(want)))
    out = []
    for i, (st, have) in enumerate(zip(opt_state, want)):
        check(set(st) == set(have),
              "opt_state_from_jax: layer %d has keys %s, the trainer "
              "expects %s" % (i, sorted(st), sorted(have)))
        layer = {}
        for key, sub in st.items():
            check(set(sub) == set(have[key]),
                  "opt_state_from_jax: layer %d %s has states %s, the "
                  "updater keeps %s" % (i, key, sorted(sub),
                                        sorted(have[key])))
            layer[key] = {}
            for sk, v in sub.items():
                arr = np.asarray(v, np.float32)
                shape = tuple(have[key][sk].shape)
                check(arr.shape == shape,
                      "opt_state_from_jax: layer %d %s/%s has shape %s, "
                      "the trainer expects %s" % (i, key, sk, arr.shape,
                                                  shape))
                layer[key][sk] = torch.from_numpy(arr.copy()).to(
                    trainer.dev)
        out.append(layer)
    return out
