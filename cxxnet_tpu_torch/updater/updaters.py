"""SGD / NAG / Adam / AdamW updaters on torch tensors.

The port's counterpart of cxxnet_tpu/updater/updaters.py, with the same
numerics:
* sgd  — momentum SGD with weight decay and clip-with-NaN-zeroing
         (src/updater/sgd_updater-inl.hpp:73-88, clip struct :15-22)
* nag  — Nesterov momentum (src/updater/nag_updater-inl.hpp:66-74)
* adam — the reference's formulation: bias correction folded into lr_t and
         wd *subtracted* from the gradient (adam_updater-inl.hpp:77-87; the
         reference's sign, kept as it is)
* adamw — decoupled weight decay with the standard beta convention

The JAX functions are pure and return new arrays. Here ``apply`` updates
the weight and its state tensors IN PLACE under ``torch.no_grad()`` (and
returns them), so a training step holds one copy of the weights and the
optimizer state instead of two; callers that need the old values clone
them first.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .param import UpdaterParam

kDataKeyStep = 4

State = Dict[str, torch.Tensor]


def encode_data_key(layer_index: int, tag: str) -> int:
    """PS key scheme: key = layer_index*4 + {0: wmat, 1: bias}
    (src/updater/updater.h:150-163)."""
    if tag == "bias":
        return layer_index * kDataKeyStep + 1
    if tag == "wmat":
        return layer_index * kDataKeyStep + 0
    raise ValueError("EncodeDataKey: only support weight tag: wmat or bias")


def decode_tag(key: int) -> str:
    r = key % kDataKeyStep
    if r == 0:
        return "wmat"
    if r == 1:
        return "bias"
    raise ValueError("invalid key")


def _clip_nan(g: torch.Tensor, bound: float) -> torch.Tensor:
    """Gradient clip that first zeroes NaNs (reference struct clip)."""
    return torch.nan_to_num(g, nan=0.0, posinf=float("inf"),
                            neginf=float("-inf")).clamp_(-bound, bound)


def _pow32(base: float, e: float) -> float:
    """base ** e in float32, as jnp.power computes it on an f32 scalar."""
    return float(np.power(np.float32(base), np.float32(e)))


class Updater:
    kind = "none"

    def __init__(self, tag: str):
        self.param = UpdaterParam(tag)

    def set_param(self, name: str, val: str) -> None:
        self.param.set_param(name, val)
        # tag-scoped override for subclass keys too: "wmat:beta1" reaches
        # the Adam updaters as "beta1"
        tag = self.param.tag
        if tag and name.startswith(tag + ":"):
            name = name[len(tag) + 1:]
        self._set_extra(name, val)

    def _set_extra(self, name: str, val: str) -> None:
        """Subclass hook for optimizer-specific keys (tag prefix already
        stripped)."""

    def init_state(self, w: torch.Tensor) -> State:
        return {}

    def apply(self, w: torch.Tensor, g: torch.Tensor, state: State,
              epoch: int):
        """Update ``w`` and ``state`` in place from gradient ``g`` and
        return (w, state); ``epoch`` counts optimizer updates (the
        reference's epoch_counter)."""
        raise NotImplementedError


def _zeros_f32(w: torch.Tensor) -> torch.Tensor:
    return torch.zeros(w.shape, dtype=torch.float32, device=w.device)


class SGDUpdater(Updater):
    kind = "sgd"

    def init_state(self, w):
        return {"m": _zeros_f32(w)}

    @torch.no_grad()
    def apply(self, w, g, state, epoch):
        p = self.param
        lr, momentum = p.schedule_epoch(epoch)
        if p.clip_gradient != 0.0:
            g = _clip_nan(g, p.clip_gradient)
        m = state["m"]
        m.mul_(momentum).add_((g + p.wd * w).mul_(-lr))
        w.add_(m)
        return w, state


class NAGUpdater(Updater):
    kind = "nag"

    def init_state(self, w):
        return {"m": _zeros_f32(w)}

    @torch.no_grad()
    def apply(self, w, g, state, epoch):
        p = self.param
        lr, momentum = p.schedule_epoch(epoch)
        m = state["m"]
        old_m = m * momentum
        m.mul_(momentum).add_((g + p.wd * w).mul_(-lr))
        w.add_((1 + momentum) * m).sub_(old_m)
        return w, state


class AdamUpdater(Updater):
    kind = "adam"

    def __init__(self, tag: str):
        super().__init__(tag)
        self.decay1 = 0.1
        self.decay2 = 0.001

    def _set_extra(self, name, val):
        if name == "beta1":
            self.decay1 = float(val)
        if name == "beta2":
            self.decay2 = float(val)

    def init_state(self, w):
        return {"m1": _zeros_f32(w), "m2": _zeros_f32(w)}

    @torch.no_grad()
    def apply(self, w, g, state, epoch):
        p = self.param
        if p.wd > 0.0:
            g = g - p.wd * w  # reference sign, adam_updater-inl.hpp:79
        e1 = float(np.float32(epoch) + np.float32(1.0))
        fix1 = np.float32(1.0) - np.float32(_pow32(1.0 - self.decay1, e1))
        fix2 = np.float32(1.0) - np.float32(_pow32(1.0 - self.decay2, e1))
        lr_t = float(np.float32(p.base_lr) * np.sqrt(fix2) / fix1)
        m1, m2 = state["m1"], state["m2"]
        m1.add_((g - m1).mul_(self.decay1))
        m2.add_((g * g - m2).mul_(self.decay2))
        w.sub_((m1 / (m2.sqrt() + 1e-8)).mul_(lr_t))
        return w, state


class AdamWUpdater(Updater):
    """AdamW (beyond the reference): decoupled weight decay with the
    standard beta convention (beta1/beta2 are retention rates, defaults
    0.9/0.999) and the scheduled lr."""

    kind = "adamw"

    def __init__(self, tag: str):
        super().__init__(tag)
        self.beta1 = 0.9
        self.beta2 = 0.999
        self.eps = 1e-8

    def _set_extra(self, name, val):
        if name == "beta1":
            self.beta1 = float(val)
        if name == "beta2":
            self.beta2 = float(val)
        if name == "adam_eps":
            self.eps = float(val)

    def init_state(self, w):
        return {"m1": _zeros_f32(w), "m2": _zeros_f32(w)}

    @torch.no_grad()
    def apply(self, w, g, state, epoch):
        p = self.param
        lr, _ = p.schedule_epoch(epoch)
        if p.clip_gradient != 0.0:
            g = _clip_nan(g, p.clip_gradient)
        e1 = float(np.float32(epoch) + np.float32(1.0))
        m1, m2 = state["m1"], state["m2"]
        m1.mul_(self.beta1).add_((1.0 - self.beta1) * g)
        m2.mul_(self.beta2).add_((1.0 - self.beta2) * (g * g))
        mhat = m1 / float(np.float32(1.0) - np.float32(_pow32(self.beta1, e1)))
        vhat = m2 / float(np.float32(1.0) - np.float32(_pow32(self.beta2, e1)))
        w.sub_((mhat / (vhat.sqrt() + self.eps) + p.wd * w).mul_(lr))
        return w, state


_KINDS = {"sgd": SGDUpdater, "nag": NAGUpdater, "adam": AdamUpdater,
          "adamw": AdamWUpdater}


def create_updater(kind: str, tag: str) -> Updater:
    """Factory (reference CreateUpdater_, src/updater/updater_impl-inl.hpp:18-30)."""
    if kind not in _KINDS:
        raise ValueError("unknown updater type %s" % kind)
    return _KINDS[kind](tag)
