"""Embeddable numpy API of the port: ``DataIter``, ``Net`` and ``train``.

Counterpart of ``cxxnet_tpu.api`` (the reference's wrapper surface,
wrapper/cxxnet.py:64-307) for the port's slices so far: an iterator chain
built from a config section (``DataIter``); a config-string-driven net
that initializes or loads a model, trains it one ``update`` at a time on a
DataIter's batch or on numpy (data, label), evaluates it over an iterator,
runs prediction and feature extraction, continues token sequences with a
KV-cached ``generate`` (sequence nets) and serves them online behind the
serving frontend (``Net.serve``) or exports them (``Net.export``,
``save_decode``; ``load_exported`` and ``load_decode`` run the
``torch.export`` programs), on the card (``dev = "gpu"``, the
default) or, when asked, on the CPU; and the small training loop ``train``.
Model files are those of the JAX package: int32 net_type, then the
trainer's sections (optimizer and training state included), inside the
CRC framing of utils/checkpoint.py, written atomically.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from . import io as io_mod
from .io.data import DataBatch
from .nnet import trainer as trainer_mod
from .parallel import multihost
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
        """Write a CRC-framed model file, optimizer and training state
        included, that either package loads. The write is atomic (tmp
        file, fsync, rename): a save that fails part-way leaves the old
        file as it was. Over several ranks every rank calls it together
        and the file is the whole model, as one rank writes it."""
        w = serializer.Writer()
        w.write_int32(self.net_type)
        self._trainer().save_model(w)
        self._trainer().save_training_state(w)
        # over several ranks every rank serializes (the gathers are
        # collective) and rank 0 alone writes
        if multihost.worker_shard_params()[1] == 0:
            ckpt.write_checkpoint(fname, w.f.getbuffer())

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

    def serve(self, port: int = 0, host: str = "", n_new: int = 16,
              temperature: float = 0.0, top_k: int = 0, seed: int = 0,
              buckets=None, kv_block: int = 0, **opts):
        """Start the serving frontend (``utils/servd.py``) around this
        net on a TCP line protocol (cxxnet_tpu/api.py:213): a bounded
        admission queue with ``ERR busy`` shedding, per-request ``DEADLINE
        <ms>`` deadlines, backend supervision with a circuit breaker,
        ``ADMIN stats`` / ``ADMIN reload`` and a graceful ``drain()``.
        Returns the started, listening ``servd.ServeFrontend`` (``.port``
        is the bound port; port 0 is ephemeral; loopback unless ``host``
        widens it). Request ``seq`` (its dispatch ordinal) generates
        ``n_new`` tokens with the seed ``seed + seq``, as ``generate``
        would alone. ``buckets`` (slot counts, e.g. ``(1, 2, 4, 8)``) runs
        the continuous-batching dispatcher over ``decode_session``s of
        those sizes instead of one ``generate`` per request, paged over
        the trainer's KV block pool when ``kv_block`` > 0; the tokens are
        the same. ``opts`` pass through to ServeFrontend (queue_size,
        deadline_ms, drain_ms, breaker_fails, breaker_cooldown_ms,
        reload_fn, slo, flight_cap, batch_max, batch_window_ms, ...).
        Every request gets a phase-attributed flight record in
        ``fe.flight``, its TTFT split at the trainer's first-token mark.
        The caller owns shutdown: ``.drain()`` answers every accepted
        request before it returns."""
        from .learn_task import _SlotBackendAdapter
        from .utils import servd, statusd
        vocab = servd.embed_vocab(self._trainer().net)

        def backend(toks, seq):
            # the net's trainer at each call: a reload_fn may swap it
            tr = self.net_
            with tr.on_device():
                return tr.generate(np.asarray([toks]), n_new,
                                   temperature=temperature, top_k=top_k,
                                   seed=seed + seq)[0]

        slot_backend = None
        if buckets:
            slot_backend = _SlotBackendAdapter(
                lambda: self.net_, buckets, n_new, temperature=temperature,
                top_k=top_k, seed=seed, kv_block=kv_block)
        fe = servd.ServeFrontend(backend, vocab=vocab,
                                 slot_backend=slot_backend, **opts)
        fe.start()
        fe.listen(port, host=host)
        statusd.set_flight_recorder(fe.flight)
        # unconditional: slo=None must also clear a tracker left behind by
        # an earlier frontend
        statusd.set_slo(fe.slo)
        # /programz for embedders too: the module ledger cards this
        # frontend's decode programs once perf.enable() ran (learn_task
        # wires it; library users call it themselves)
        from .utils import perf
        statusd.set_perf(perf.ledger())
        return fe

    def beam_generate(self, prompts: np.ndarray, n_new: int,
                      beam: int = 4) -> np.ndarray:
        """Width-``beam`` KV-cached beam search: each row's best
        summed-log-probability continuation (see Trainer.beam_generate)."""
        return self._trainer().beam_generate(prompts, n_new, beam=beam)

    def export(self, fname: str, node_name: str = "",
               batch_size: int = 0) -> None:
        """Write the inference forward as a self-contained ``torch.export``
        program (params baked in); reload it with ``load_exported(fname)``
        — no config or model file needed at serving time. batch_size 0 =
        training batch; -1 = symbolic batch dim (one artifact serves any
        n >= 1)."""
        blob = self._trainer().export_forward(node_name=node_name,
                                              batch_size=batch_size)
        with open(fname, "wb") as f:
            f.write(blob)

    # -- weight io ----------------------------------------------------
    def set_weight(self, weight: np.ndarray, layer_name: str,
                   tag: str = "wmat") -> None:
        self._trainer().set_weight(weight, layer_name, tag)

    def get_weight(self, layer_name: str, tag: str = "wmat") -> np.ndarray:
        """Weight as a 2-D (out, in-flat) array (reference CXNNetGetWeight
        returns the flattened view + shape)."""
        weight, _shape = self._trainer().get_weight(layer_name, tag)
        return weight


def save_decode(net, prefill_fname: str, step_fname: str,
                batch_size: int = 1, prompt_len: int = 1) -> None:
    """Write a trained sequence net's KV-cached decode loop as two
    standalone ``torch.export`` programs (Trainer.export_decode)."""
    pre, step = net.net_.export_decode(batch_size, prompt_len)
    with open(prefill_fname, "wb") as f:
        f.write(pre)
    with open(step_fname, "wb") as f:
        f.write(step)


def _load_program(payload: bytes):
    """(module, device) of a ``torch.export.save`` payload: the program's
    callable module and the device its inputs go to. The ``cxxnet::`` ops
    a program may hold are registered first."""
    import io
    from .ops import library  # noqa: F401  (registers the cxxnet:: ops)
    prog = torch.export.load(io.BytesIO(payload))
    dev = torch.device("cpu")
    for node in prog.graph.nodes:
        val = node.meta.get("val") if node.op == "placeholder" else None
        if isinstance(val, torch.Tensor):
            dev = val.device
    return prog.module(), dev


def _host(t: torch.Tensor) -> np.ndarray:
    """A program's output as a host array; bf16 values come back as
    float32 (numpy has no bf16; the conversion is exact)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def load_decode(prefill_fname: str, step_fname: str):
    """Load export_decode artifacts and return a reference greedy loop
    ``generate(prompts, n_new) -> (batch, n_new) ids`` (params baked in;
    a real deployment drives the two programs from its own loop:
    sampling, stop tokens, scheduling)."""
    from .utils import artifact
    with open(prefill_fname, "rb") as f:
        pre_meta, pre_bytes = artifact.unframe(f.read(), "decode_prefill")
    with open(step_fname, "rb") as f:
        step_meta, step_bytes = artifact.unframe(f.read(), "decode_step")
    if pre_meta.get("cache_fingerprint") != step_meta.get(
            "cache_fingerprint"):
        raise ValueError(
            "load_decode: prefill and step artifacts disagree on the KV "
            "cache layout (fingerprints %s vs %s) — they are from "
            "different exports; regenerate the pair together"
            % (pre_meta.get("cache_fingerprint"),
               step_meta.get("cache_fingerprint")))
    pre, dev = _load_program(pre_bytes)
    step, _ = _load_program(step_bytes)
    b, plen = int(pre_meta["batch"]), int(pre_meta["prompt_len"])
    l_max = int(step_meta["l_max"])

    def generate(prompts, n_new: int) -> np.ndarray:
        prompts = np.asarray(prompts, np.int32)
        assert prompts.shape == (b, plen), (
            "this artifact serves (%d, %d) prompts" % (b, plen))
        if n_new <= 0:
            return np.zeros((b, 0), np.int32)
        if plen + n_new > l_max:
            raise ValueError(
                "prompt_len %d + n_new %d exceeds the artifact's cache "
                "length %d" % (plen, n_new, l_max))
        # every step's position is on the device before the loop: a copy
        # from the host a step would wait for the queued steps each time
        pos = torch.arange(plen, plen + n_new - 1, dtype=torch.int32,
                           device=dev)
        with torch.no_grad():
            probs, caches = pre(torch.from_numpy(prompts).to(dev))
            out = []
            tok = torch.argmax(probs, dim=1).to(torch.int32)
            out.append(tok)
            for i in range(n_new - 1):
                probs, caches = step(tok, pos[i], caches)
                tok = torch.argmax(probs, dim=1).to(torch.int32)
                out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy()

    generate.prefill, generate.step, generate.device = pre, step, dev
    return generate


def load_exported(fname: str):
    """Load a ``Net.export`` / ``task = export`` artifact and return a
    callable ``fn(data) -> np.ndarray`` (params baked in; batch shape
    fixed, or any n >= 1 for artifacts exported with batch_size = -1). It
    runs on the device type the artifact was exported on; the serving
    side needs torch and, for a program that holds a kernel,
    ``cxxnet_tpu_torch.ops.library``."""
    from .utils import artifact
    with open(fname, "rb") as f:
        meta, payload = artifact.unframe(f.read(), "forward")
    mod, dev = _load_program(payload)

    def fn(data) -> np.ndarray:
        x = torch.from_numpy(np.asarray(data, np.float32)).to(dev)
        with torch.no_grad():
            return _host(mod(x))

    fn.meta, fn.module, fn.device = meta, mod, dev
    return fn


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
