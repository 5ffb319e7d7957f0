"""Process launch and the host view of sharded values: the counterpart of
cxxnet_tpu/parallel/multihost.py:40-114.

Every process runs the same program; ``init_distributed`` joins them into
one ``torch.distributed`` world from the keys the JAX package reads
(``coordinator``, ``num_worker``, ``worker_rank``, and the environment
``CXXNET_NUM_WORKER``, ``CXXNET_WORKER_RANK`` / ``PS_RANK``). The backend
follows the device: ``nccl`` for ranks on cards, ``gloo`` on the CPU; the
environment ``CXXNET_DIST_BACKEND`` names one outright. NCCL refuses two
ranks on one card, so a one-card machine runs several ranks with
``CXXNET_DIST_BACKEND=gloo`` (the collectives then stage what gloo does not
take from the card through host memory, ``collectives``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from . import collectives
from .mesh import world


def backend_for(kind: str) -> str:
    """The backend of a world whose ranks run on devices of ``kind``
    (``cpu`` or a card kind): ``CXXNET_DIST_BACKEND`` when set, else
    ``nccl`` for cards and ``gloo`` for the CPU."""
    env = os.environ.get("CXXNET_DIST_BACKEND", "")
    if env:
        return env
    return "gloo" if kind == "cpu" else "nccl"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     dev: str = "gpu") -> None:
    """Join the world of ``num_processes`` ranks as rank ``process_id``,
    meeting at ``coordinator_address`` (``host:port``, or any
    ``init_method`` URL such as ``tcp://...`` or ``file://...``). The
    arguments default from the environment as in the JAX package. A no-op
    for one process, and when the world is already up. ``dev`` is the
    ranks' ``dev=`` spec: ranks on cards take their card first, the one
    ``device.resolve_device`` names for this rank, so that the current
    device is the one that holds the rank's tensors."""
    if num_processes is None:
        num_processes = int(os.environ.get("CXXNET_NUM_WORKER", "0")) or None
    if process_id is None:
        pid = os.environ.get("CXXNET_WORKER_RANK", os.environ.get("PS_RANK"))
        process_id = int(pid) if pid is not None else None
    if num_processes in (None, 0, 1) and coordinator_address is None:
        return
    if dist.is_initialized():
        return
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: num_worker and worker_rank must "
                         "both be set (or CXXNET_NUM_WORKER and "
                         "CXXNET_WORKER_RANK / PS_RANK)")
    if coordinator_address is None:
        raise ValueError("init_distributed: coordinator must be set for %d "
                         "processes" % num_processes)
    url = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    kind = device_mod.parse_device_spec(dev)[0]
    if kind != "cpu":
        torch.cuda.set_device(device_mod.resolve_device(
            dev, (int(num_processes), int(process_id))))
    dist.init_process_group(backend_for(kind), init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))


def leave_distributed() -> None:
    """Leave the world (every group of it) when one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank0_value(value):
    """Rank 0's ``value`` (any picklable object) on every rank of the
    world, ``value`` itself without one. Collective: every rank calls it
    at the same point."""
    n, _ = world()
    if n == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def worker_shard_params() -> Tuple[int, int]:
    """(num_workers, rank) for input sharding: the reference's
    dist_num_worker / dist_worker_rank derived from the world."""
    return world()


def fetch_global(x: torch.Tensor, mesh=None, spec=()) -> np.ndarray:
    """The host numpy value of the whole tensor of which ``x`` is this
    rank's block under ``spec`` (a placement of ``sharding``) on ``mesh``;
    ``x`` itself when the spec splits nothing. A placement never splits
    over ``pipe`` or ``sp``: a stage's tensor lives on its own pipe ranks
    alone (``Trainer.canonical_params`` shares the stages' tensors over
    the pipe group), and the sp ranks hold the same blocks.

    COLLECTIVE CONTRACT: the gather is a cross-process collective. In a
    multi-process run EVERY process must call fetch_global on the same
    tensor in the same order. Guarding a call site by rank (e.g. ``if rank
    == 0: save_model(...)``) deadlocks the world. The same contract
    therefore applies to every API that uses it: Trainer.save_model /
    evaluate / predict / extract_feature / get_weight /
    canonical_params."""
    from .sharding import split_of
    sp = split_of(spec) if mesh is not None else None
    if sp is not None:
        dim, axes = sp
        with torch.no_grad():
            x = collectives.all_gather(x.detach(), mesh.group(axes), dim=dim)
    return x.detach().cpu().numpy()
