"""Embeddable numpy API of the port: ``Net``.

Counterpart of ``cxxnet_tpu.api.Net`` (the reference's wrapper surface,
wrapper/cxxnet.py:64-307) for the port's slices so far: a
config-string-driven net that initializes or loads a model, trains it one
``update(data, label)`` at a time, evaluates it over an iterator, runs
prediction and feature extraction, and continues token sequences with a
KV-cached ``generate`` (sequence nets), on the card (``dev = "gpu"``, the
default) or, when asked, on the CPU. Model files are those of the JAX
package: int32 net_type, then the trainer's sections (optimizer state
included), inside the CRC framing of utils/checkpoint.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .io.data import DataBatch
from .nnet import trainer as trainer_mod
from .utils import checkpoint as ckpt
from .utils import serializer
from .utils.config import parse_config_string


def _as_batch(data: np.ndarray, label: Optional[np.ndarray]) -> DataBatch:
    """Wrap raw numpy into a DataBatch (reference CXNNetUpdateBatch path:
    wrapper/cxxnet_wrapper.cpp:295-311). 2-D data is viewed as flat
    (b, 1, 1, n) nodes."""
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim == 2:
        data = data.reshape(data.shape[0], 1, 1, data.shape[1])
    if data.ndim != 4:
        raise ValueError("data must be 2-D or 4-D, got %s" % (data.shape,))
    batch = DataBatch()
    batch.data = data
    batch.batch_size = data.shape[0]
    if label is not None:
        label = np.ascontiguousarray(label, np.float32)
        if label.ndim == 1:
            label = label.reshape(-1, 1)
        batch.label = label
    return batch


class Net:
    """A neural net driven by a netconfig config string."""

    def __init__(self, dev: str = "gpu", cfg: str = ""):
        self.cfg: List[Tuple[str, str]] = []
        self.net_type = 0
        self.net_: Optional[trainer_mod.Trainer] = None
        for k, v in parse_config_string(cfg):
            self.set_param(k, v)
        if dev:
            self.set_param("dev", dev)

    # -- configuration ------------------------------------------------
    def set_param(self, name: str, value) -> None:
        value = str(value)
        if name == "net_type" and self.net_ is not None:
            self.net_type = int(value)
            return
        if self.net_ is not None:
            self.net_.set_param(name, value)
        self.cfg.append((name, value))

    def _create_net(self) -> trainer_mod.Trainer:
        net = trainer_mod.create_net(self.net_type)
        for k, v in self.cfg:
            if k == "net_type":
                self.net_type = int(v)
                continue
            net.set_param(k, v)
        return net

    def _trainer(self) -> trainer_mod.Trainer:
        if self.net_ is None:
            raise RuntimeError("model not initialized: call init_model or "
                               "load_model first")
        return self.net_

    # -- model lifecycle ----------------------------------------------
    def init_model(self) -> None:
        self.net_ = self._create_net()
        self.net_.init_model()

    def load_model(self, fname: str) -> None:
        """Load a model file; CRC-framed files are verified, unframed legacy
        files pass through."""
        payload, _ = ckpt.read_verified(fname)
        r = serializer.Reader(payload)
        self.net_type = r.read_int32()
        self.net_ = self._create_net()
        self.net_.load_model(r)

    def save_model(self, fname: str) -> None:
        """Write a CRC-framed model file, optimizer state included, that
        either package loads."""
        w = serializer.Writer()
        w.write_int32(self.net_type)
        self._trainer().save_model(w)
        with open(fname, "wb") as f:
            f.write(ckpt.frame(w.getvalue()))

    def start_round(self, round_counter: int) -> None:
        self._trainer().start_round(round_counter)

    # -- training -----------------------------------------------------
    def update(self, data, label) -> None:
        """One training step on raw numpy (data, label): data (b, c, h, w)
        or (b, n), label (b,) or (b, label_width)."""
        self._trainer().update(_as_batch(np.asarray(data), label))

    def evaluate(self, data, name: str) -> str:
        """The train metrics since the last call, then the metrics over
        ``data``, an iterator with before_first / next / value (the
        io.IIterator protocol), or None for the train metrics alone."""
        return self._trainer().evaluate(data, name)

    # -- inference ----------------------------------------------------
    def predict(self, data) -> np.ndarray:
        """Per-row prediction (argmax over the output when it is a
        distribution — reference TransformPred)."""
        return self._trainer().predict(data)

    def predict_device(self, data) -> torch.Tensor:
        """predict() without the host copy: a (batch,) tensor on the
        net's device."""
        return self._trainer().predict_device(data)

    def extract(self, data, name: str) -> np.ndarray:
        """Activations of the named node (or ``top[-k]``) for the batch."""
        return self._trainer().extract_feature(data, name)

    def generate(self, prompts: np.ndarray, n_new: int,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 prompt_lens=None) -> np.ndarray:
        """KV-cached greedy continuation for sequence nets: (batch,
        prompt_len) token ids -> (batch, n_new) generated ids; ragged
        batches via ``prompt_lens`` (see Trainer.generate). Sampling
        (temperature > 0) is not ported yet."""
        return self._trainer().generate(prompts, n_new,
                                        temperature=temperature,
                                        top_k=top_k, seed=seed,
                                        prompt_lens=prompt_lens)

    # -- weight io ----------------------------------------------------
    def set_weight(self, weight: np.ndarray, layer_name: str,
                   tag: str = "wmat") -> None:
        self._trainer().set_weight(weight, layer_name, tag)

    def get_weight(self, layer_name: str, tag: str = "wmat") -> np.ndarray:
        """Weight as a 2-D (out, in-flat) array (reference CXNNetGetWeight
        returns the flattened view + shape)."""
        weight, _shape = self._trainer().get_weight(layer_name, tag)
        return weight
