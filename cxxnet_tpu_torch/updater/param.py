"""Updater hyper-parameters and learning-rate / momentum schedules.

The port's counterpart of cxxnet_tpu/updater/param.py (the reference's
src/updater/param.h:13-136):
* tag-scoped overrides: ``wmat:lr = 0.01`` applies only to updaters whose
  tag is ``wmat`` (param.h:100-104)
* schedules: constant / expdecay / polydecay / factor, and cosine over
  ``lr:total`` updates
* momentum clamped to final_momentum, lr floored at lr_minimum but never
  raised above the requested base lr
* ``lr:warmup`` linear ramp, ``lr:start_epoch`` and ``momentum_schedule``

``epoch`` is a plain int (the trainer's update counter), and the schedule
is computed in float32 on the host, step for step as the JAX package
computes it on the device (f32 power, cos, min and max), so both packages
feed the same learning rate to the same update.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

f32 = np.float32

_SCHEDULES = {"constant": 0, "expdecay": 1, "polydecay": 2, "factor": 3,
              "cosine": 4}


class UpdaterParam:
    def __init__(self, tag: str = ""):
        self.tag = tag
        self.silent = 0
        self.base_lr = 0.01
        self.wd = 0.0
        self.momentum = 0.9
        self.lr_schedule = 0
        self.momentum_schedule = 0
        self.lr_step = 1
        self.lr_gamma = 0.5
        self.lr_alpha = 0.5
        self.lr_factor = 0.1
        self.lr_minimum = 0.00001
        self.start_epoch = 0
        self.base_momentum = 0.5
        self.final_momentum = 0.90
        self.saturation_epoch = 0
        self.clip_gradient = 0.0
        self.lr_warmup = 0      # linear warmup steps (0 -> none)
        self.lr_total = 0       # cosine horizon in updates (required)

    def set_param(self, name: str, val: str) -> None:
        # tag-scoped override: "wmat:lr" applies when tag == "wmat"
        if self.tag and name.startswith(self.tag):
            if len(name) > len(self.tag) and name[len(self.tag)] == ":":
                name = name[len(self.tag) + 1:]
        if name in ("lr", "eta"):
            self.base_lr = float(val)
        if name == "wd":
            self.wd = float(val)
        if name == "momentum":
            self.momentum = float(val)
        if name == "silent":
            self.silent = int(val)
        if name == "momentum_schedule":
            self.momentum_schedule = int(val)
        if name == "clip_gradient":
            self.clip_gradient = float(val)
        if name == "final_momentum":
            self.final_momentum = float(val)
        if name == "base_momentum":
            self.base_momentum = float(val)
        if name == "saturation_epoch":
            self.saturation_epoch = int(val)
        if name.startswith("lr:") or name.startswith("eta:"):
            sub = name.split(":", 1)[1]
            if sub == "schedule":
                self.lr_schedule = _SCHEDULES.get(val, self.lr_schedule)
            if sub == "gamma":
                self.lr_gamma = float(val)
            if sub == "alpha":
                self.lr_alpha = float(val)
            if sub == "step":
                self.lr_step = int(val)
            if sub == "factor":
                self.lr_factor = float(val)
            if sub == "minimum_lr":
                self.lr_minimum = float(val)
            if sub == "start_epoch":
                self.start_epoch = int(val)
            if sub == "warmup":
                self.lr_warmup = int(val)
            if sub == "total":
                self.lr_total = int(val)

    def schedule_epoch(self, epoch: int) -> Tuple[float, float]:
        """(learning rate, momentum) after ``epoch`` optimizer updates, as
        Python floats holding float32 values."""
        e = f32(epoch)
        if self.lr_schedule == 0:
            lr = f32(self.base_lr)
        elif self.lr_schedule == 1:
            lr = f32(self.base_lr) * np.power(f32(self.lr_gamma),
                                              e / f32(self.lr_step))
        elif self.lr_schedule == 2:
            lr = f32(self.base_lr) * np.power(
                f32(1.0) + np.floor(e / f32(self.lr_step)) * f32(self.lr_gamma),
                f32(-self.lr_alpha))
        elif self.lr_schedule == 3:
            lr = f32(self.base_lr) * np.power(f32(self.lr_factor),
                                              np.floor(e / f32(self.lr_step)))
        elif self.lr_schedule == 4:
            if self.lr_total <= 0:
                raise ValueError(
                    "lr_schedule = 4 (cosine) requires lr:total > 0 — "
                    "without it the schedule would collapse to "
                    "minimum_lr after the first update")
            frac = np.clip(e / f32(self.lr_total), f32(0.0), f32(1.0))
            lr = f32(self.lr_minimum) + \
                f32(0.5 * (self.base_lr - self.lr_minimum)) \
                * (f32(1.0) + np.cos(f32(np.pi) * frac))
        else:
            raise ValueError("unknown schedule type")
        momentum = f32(self.momentum)
        if self.momentum_schedule and self.saturation_epoch:
            # linear warmup toward final_momentum
            momentum = f32(self.base_momentum) + f32(
                (self.final_momentum - self.base_momentum)
                / self.saturation_epoch) * e
        momentum = min(momentum, f32(self.final_momentum))
        # floor at lr_minimum, but never above the requested base lr
        lr = max(f32(lr), f32(min(self.lr_minimum, self.base_lr)))
        if e < f32(self.start_epoch):
            lr = f32(self.base_lr)
        if self.lr_warmup > 0:
            lr = lr * np.clip((e + f32(1.0)) / f32(self.lr_warmup),
                              f32(0.0), f32(1.0))
        return float(f32(lr)), float(f32(momentum))
