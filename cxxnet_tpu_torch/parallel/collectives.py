"""The collectives sequence parallelism needs: the counterpart of
cxxnet_tpu/parallel/collectives.py:69-82 (``ring_shift``, ``all_to_all``).

Each works over one of two kinds of ranks:

- a ``torch.distributed`` process group, each process holding its own
  tensor. Both are ``torch.autograd.Function``s whose backward is the
  inverse collective (the shift the other way; the all-to-all with its
  axes swapped), the counterpart of the transpose rule of JAX's
  ``ppermute`` and ``all_to_all`` that JAX's dense ring relies on. The
  ring shift posts its send and its receive together
  (``batch_isend_irecv``), so that no rank waits on another.
- n virtual ranks in one process: a list of n per-rank tensors, which may
  live on one device. The shift rotates the list and the all-to-all
  regroups it, in plain (differentiable) tensor ops. There is one card,
  and NCCL will not put two ranks on one GPU, so on the card the ring runs
  as n virtual ranks, as the JAX tests run on a virtual CPU mesh.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Ranks = Union[torch.Tensor, Sequence[torch.Tensor]]


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` of ``group``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if shift % n == 0:
        return x.clone()
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, _peer(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out, _peer(group, (me - shift) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n != 0:
        raise ValueError("all_to_all: axis %d of %s does not split %d ways"
                         % (split_axis, tuple(x.shape), n))
    ins = [c.contiguous() for c in x.chunk(n, split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=group)
    return torch.cat(outs, concat_axis)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        group, split_axis, concat_axis = ctx.args
        return (_all_to_all(grad, group, concat_axis, split_axis), None,
                None, None)


def ring_shift(x: Ranks, group=None, shift: int = 1) -> Ranks:
    """Rotate around the ring: rank i's value goes to rank i + shift.

    ``x`` is this process's tensor of ``group`` (None: the default group),
    or a list of the n virtual ranks' tensors, returned rotated."""
    if isinstance(x, (list, tuple)):
        n = len(x)
        return [x[(i - shift) % n] for i in range(n)]
    return _RingShift.apply(x, group, shift)


def all_to_all(x: Ranks, group=None, *, split_axis: int,
               concat_axis: int) -> Ranks:
    """Tiled all-to-all: each rank splits its value into n chunks along
    ``split_axis`` and sends chunk j to rank j, which concatenates what it
    receives along ``concat_axis`` in rank order (JAX's ``all_to_all``
    with ``tiled=True``).

    ``x`` is this process's tensor of ``group``, or a list of the n virtual
    ranks' tensors, returned regrouped."""
    if isinstance(x, (list, tuple)):
        n = len(x)
        parts = [t.chunk(n, split_axis) for t in x]
        if any(len(p) != n or p[0].shape[split_axis] * n
               != t.shape[split_axis] for p, t in zip(parts, x)):
            raise ValueError("all_to_all: axis %d of %s does not split %d "
                             "ways" % (split_axis, tuple(x[0].shape), n))
        return [torch.cat([parts[i][j] for i in range(n)], concat_axis)
                for j in range(n)]
    return _AllToAll.apply(x, group, split_axis, concat_axis)

