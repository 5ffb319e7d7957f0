"""``dev=`` spec parsing: the counterpart of cxxnet_tpu/parallel/mesh.py:18-91.

``cpu`` selects the host; every other kind (``gpu``, ``cuda``, ``tpu``, with
or without ids) selects a card, as the JAX package runs every kind but
``cpu`` on its default accelerator (cxxnet_tpu/nnet/trainer.py:252-255). A
process is one rank and runs on one device: alone, a list of ids
(``gpu:0-3``) takes its first id; in a world of ranks
(``parallel.multihost.init_distributed``) the rank takes the id of its
place among its host's ranks (``LOCAL_RANK``, else its rank). An id the
machine does not have falls back to the cards it has, in turn, as the JAX
package falls back to the first devices when ids do not resolve
(cxxnet_tpu/parallel/mesh.py:80-86): on a one-card machine every rank runs
on card 0. A card spec with no card present raises: the port never falls
back to the CPU quietly. The ranks of a list start as processes of their
own (``learn_task``'s local launch, one per listed card the machine has).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch


def parse_device_spec(spec: str) -> Tuple[str, List[int]]:
    """Parse ``cpu`` / ``gpu`` / ``gpu:0-3`` / ``gpu:0,2`` into
    (kind, device_ids). Empty id list means "all available"."""
    if ":" not in spec:
        return spec, []
    kind, ids = spec.split(":", 1)
    if "-" in ids:
        a, b = ids.split("-")
        return kind, list(range(int(a), int(b) + 1))
    return kind, [int(x) for x in ids.split(",")]


def resolve_device(spec: str,
                   world: Optional[Tuple[int, int]] = None) -> torch.device:
    """The torch device a ``dev=`` spec names: the host for ``cpu``, else
    the card of the spec's first id when the machine has it and card 0
    when it does not (the JAX rule, cxxnet_tpu/nnet/trainer.py:252-255 and
    cxxnet_tpu/parallel/mesh.py:80-86); in a world of several ranks, the
    card of this rank's place among its host's ranks (``host_rank``).
    ``world`` is (size, rank) where the world is not up yet
    (``multihost.init_distributed`` takes its card before it joins); by
    default it is read from the world. Raises RuntimeError for a card spec
    without a card."""
    kind, ids = parse_device_spec(spec)
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("dev=%s but no CUDA device is available; pass "
                           "dev=cpu to run on the host" % spec)
    n = torch.cuda.device_count()
    lr = host_rank(*(world or (None, None)))
    if lr is None:
        first = ids[0] if ids else 0
        return torch.device("cuda", first if 0 <= first < n else 0)
    card = ids[lr] if lr < len(ids) else lr
    return torch.device("cuda", card if 0 <= card < n else lr % n)


def host_rank(size: Optional[int] = None,
              rank: Optional[int] = None) -> Optional[int]:
    """This process's place among its host's ranks in a world of ``size``
    ranks where it is ``rank`` (by default the world's): ``LOCAL_RANK``,
    else the global rank; None alone."""
    if size is None:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return None
        size, rank = dist.get_world_size(), dist.get_rank()
    if size == 1:
        return None
    return int(os.environ.get("LOCAL_RANK", rank))


# each card's allocator high-water mark as it stood at the last
# ``reset_peak_window``: the process's peak is the larger of it and
# torch's peak since, so that no window a probe opens lowers it
_PEAK_BEFORE: Dict[int, int] = {}


def _card_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def reset_peak_window(dev: torch.device) -> None:
    """Start a new window of torch's allocator peak on the card ``dev`` (a
    program's first call measures its own peak in one: ``perf.DeviceProbe``)
    while the process's high-water mark that ``memory_stats`` reports keeps
    its running maximum."""
    i = _card_index(dev)
    _PEAK_BEFORE[i] = max(_PEAK_BEFORE.get(i, 0),
                          int(torch.cuda.max_memory_allocated(dev)))
    torch.cuda.reset_peak_memory_stats(dev)


def memory_stats(dev: Optional[torch.device]) -> Optional[dict]:
    """The card's allocator figures, as the JAX package reads a device's
    ``memory_stats()``: ``bytes_in_use`` (torch's allocated bytes),
    ``peak_bytes_in_use`` (the process's high-water mark of them, across
    every ``reset_peak_window``) and ``bytes_limit`` (the card's memory);
    None on the CPU."""
    if dev is None or dev.type != "cuda":
        return None
    peak = max(_PEAK_BEFORE.get(_card_index(dev), 0),
               int(torch.cuda.max_memory_allocated(dev)))
    return {"bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": peak,
            "bytes_limit": torch.cuda.mem_get_info(dev)[1]}


def card_name(dev: torch.device) -> str:
    """The card's name, as ``torch.cuda.get_device_name`` and nvidia-smi
    give it (``NVIDIA H100 80GB HBM3``)."""
    return torch.cuda.get_device_name(dev)
