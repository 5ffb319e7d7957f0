"""``dev=`` spec parsing: the counterpart of cxxnet_tpu/parallel/mesh.py:18-30.

``cpu`` selects the host; every other kind (``gpu``, ``cuda``, ``tpu``, with
or without ids) selects the card, as the JAX package runs every kind but
``cpu`` on its default accelerator (cxxnet_tpu/nnet/trainer.py:252-255). The
port runs on one device, so a list of ids (``gpu:0-3``) takes its first id,
and an id the machine does not have falls back to card 0, as the JAX
package falls back to the first devices when ids do not resolve
(cxxnet_tpu/parallel/mesh.py:80-86). A card spec with no card present
raises: the port never falls back to the CPU quietly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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


def resolve_device(spec: str) -> torch.device:
    """The torch device a ``dev=`` spec names: the host for ``cpu``, else
    the card of the spec's first id when the machine has it and card 0
    when it does not (the JAX rule, cxxnet_tpu/nnet/trainer.py:252-255 and
    cxxnet_tpu/parallel/mesh.py:80-86). Raises RuntimeError for a card
    spec without a card."""
    kind, ids = parse_device_spec(spec)
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("dev=%s but no CUDA device is available; pass "
                           "dev=cpu to run on the host" % spec)
    first = ids[0] if ids else 0
    return torch.device("cuda", first
                        if 0 <= first < torch.cuda.device_count() else 0)


def memory_stats(dev: Optional[torch.device]) -> Optional[dict]:
    """The card's allocator figures, as the JAX package reads a device's
    ``memory_stats()``: ``bytes_in_use`` (torch's allocated bytes),
    ``peak_bytes_in_use`` (their high-water mark) and ``bytes_limit`` (the
    card's memory); None on the CPU."""
    if dev is None or dev.type != "cuda":
        return None
    return {"bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": torch.cuda.mem_get_info(dev)[1]}
