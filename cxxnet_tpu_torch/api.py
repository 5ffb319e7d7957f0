"""Embeddable numpy API of the port: ``DataIter``, ``Net`` and ``train``.

Counterpart of ``cxxnet_tpu.api`` (the reference's wrapper surface,
wrapper/cxxnet.py:64-307) for the port's slices so far: an iterator chain
built from a config section (``DataIter``); a config-string-driven net
that initializes or loads a model, trains it one ``update`` at a time on a
DataIter's batch or on numpy (data, label), evaluates it over an iterator,
runs prediction and feature extraction, and continues token sequences
with a KV-cached ``generate`` (sequence nets), on the card (``dev =
"gpu"``, the default) or, when asked, on the CPU; and the small driver
loop ``train``. Model files are those of the JAX package: int32 net_type,
then the trainer's sections (optimizer state included), inside the CRC
framing of utils/checkpoint.py.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from . import io as io_mod
from .io.data import DataBatch
from .nnet import trainer as trainer_mod
from .utils import checkpoint as ckpt
from .utils import serializer
from .utils.config import parse_config_string


class DataIter:
    """Data iterator built from a config-section string, e.g.::

        iter = mnist
            path_img = "data/train-images-idx3-ubyte.gz"
            path_label = "data/train-labels-idx1-ubyte.gz"
        iter = end
    """

    def __init__(self, cfg: str):
        pairs = [(k, v) for k, v in parse_config_string(cfg)
                 if not (k == "iter" and v == "end")]
        self.handle = io_mod.create_iterator(pairs)
        self.handle.init()

    def next(self) -> bool:
        """Advance to the next batch; False at end of epoch."""
        return self.handle.next()

    def before_first(self) -> None:
        self.handle.before_first()

    def check_valid(self) -> DataBatch:
        try:
            batch = self.handle.value()
        except AttributeError:
            batch = None
        if batch is None:
            raise RuntimeError("iterator has no current batch; call next()")
        return batch

    def get_data(self) -> np.ndarray:
        """Current batch data as (batch, channel, h, w) numpy."""
        return np.asarray(self.check_valid().data)

    def get_label(self) -> np.ndarray:
        """Current batch labels as (batch, label_width) numpy."""
        return np.asarray(self.check_valid().label)

    def close(self) -> None:
        self.handle.close()


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
        ckpt.write_framed(fname, w.getvalue())

    def start_round(self, round_counter: int) -> None:
        self._trainer().start_round(round_counter)

    # -- training -----------------------------------------------------
    def update(self, data, label=None) -> None:
        """One training step on the DataIter's current batch, or on raw
        numpy (data, label): data (b, c, h, w) or (b, n), label (b,) or
        (b, label_width)."""
        if isinstance(data, DataIter):
            if label is not None:
                raise ValueError("label only applies to numpy data")
            self._trainer().update(data.check_valid())
            return
        self._trainer().update(_as_batch(np.asarray(data), label))

    def evaluate(self, data, name: str) -> str:
        """The train metrics since the last call, then the metrics over
        ``data``, a DataIter or an iterator with before_first / next /
        value (the io.IIterator protocol), or None for the train metrics
        alone."""
        if isinstance(data, DataIter):
            data = data.handle
        return self._trainer().evaluate(data, name)

    # -- inference ----------------------------------------------------
    @staticmethod
    def _data(data):
        return data.check_valid().data if isinstance(data, DataIter) \
            else data

    def predict(self, data) -> np.ndarray:
        """Per-row prediction (argmax over the output when it is a
        distribution — reference TransformPred) of numpy data or of a
        DataIter's current batch."""
        return self._trainer().predict(self._data(data))

    def predict_device(self, data) -> torch.Tensor:
        """predict() without the host copy: a (batch,) tensor on the
        net's device."""
        return self._trainer().predict_device(self._data(data))

    def extract(self, data, name: str) -> np.ndarray:
        """Activations of the named node (or ``top[-k]``) for the batch."""
        return self._trainer().extract_feature(self._data(data), name)

    def generate(self, prompts: np.ndarray, n_new: int,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 prompt_lens=None) -> np.ndarray:
        """KV-cached continuation for sequence nets: (batch, prompt_len)
        token ids -> (batch, n_new) generated ids, greedy at temperature 0,
        sampled above it (``top_k`` > 0 truncates, ``seed`` keys the
        draws); ragged batches via ``prompt_lens`` (see
        Trainer.generate)."""
        return self._trainer().generate(prompts, n_new,
                                        temperature=temperature,
                                        top_k=top_k, seed=seed,
                                        prompt_lens=prompt_lens)

    def beam_generate(self, prompts: np.ndarray, n_new: int,
                      beam: int = 4) -> np.ndarray:
        """Width-``beam`` KV-cached beam search: each row's best
        summed-log-probability continuation (see Trainer.beam_generate)."""
        return self._trainer().beam_generate(prompts, n_new, beam=beam)

    # -- weight io ----------------------------------------------------
    def set_weight(self, weight: np.ndarray, layer_name: str,
                   tag: str = "wmat") -> None:
        self._trainer().set_weight(weight, layer_name, tag)

    def get_weight(self, layer_name: str, tag: str = "wmat") -> np.ndarray:
        """Weight as a 2-D (out, in-flat) array (reference CXNNetGetWeight
        returns the flattened view + shape)."""
        weight, _shape = self._trainer().get_weight(layer_name, tag)
        return weight


def train(cfg: str, data, num_round: int,
          param: Union[Dict[str, str], Iterable[Tuple[str, str]]],
          eval_data: Optional[DataIter] = None,
          label: Optional[np.ndarray] = None,
          dev: str = "gpu") -> Net:
    """Small training driver over the API (reference wrapper/cxxnet.py:281,
    cxxnet_tpu/api.py:369-394): ``num_round`` passes over a DataIter, with
    the eval metrics written to stderr after each, or ``num_round`` steps
    on numpy (data, label)."""
    net = Net(dev=dev, cfg=cfg)
    if isinstance(param, dict):
        param = param.items()
    for k, v in param:
        net.set_param(k, v)
    net.init_model()
    for r in range(num_round):
        net.start_round(r)
        if isinstance(data, DataIter):
            data.before_first()
            while data.next():
                net.update(data)
            if eval_data is not None:
                sys.stderr.write(net.evaluate(eval_data, "eval") + "\n")
        else:
            net.update(data=data, label=label)
    return net
