"""The port's collectives: the counterpart of
cxxnet_tpu/parallel/collectives.py (``psum`` / ``all_gather`` /
``reduce_scatter`` over the data, model and ep axes; ``ring_shift`` and
``all_to_all`` for sequence parallelism, :69-82).

Each works over one of two kinds of ranks:

- a ``torch.distributed`` process group, each process holding its own
  tensor. Each is a ``torch.autograd.Function`` whose backward is the
  transpose of the collective, the counterpart of the transpose rules of
  JAX's ``psum``, ``all_gather``, ``psum_scatter``, ``ppermute`` and
  ``all_to_all``:

  - ``all_reduce``: the backward is the identity, for a result whose
    consumers are the same on every rank (a model or ep group, where every
    rank goes on with the same activations). ``sum_grad=True`` sums the
    gradient over the group too, for a result that each rank uses on rows
    of its own (a batch-norm statistic over the data group).
  - ``all_gather``: the backward takes this rank's block of the gradient;
    with ``sum_grad=True`` it sums the blocks over the group first (a
    reduce-scatter), for a gathered input whose consumers differ by rank
    (an FSDP weight shard gathered over the data group, each rank applying
    it to rows of its own).
  - ``reduce_scatter``: the backward is the all-gather.
  - ``enter_group``: the identity forward, the all-reduce backward: the
    input of a group whose ranks each compute a part of a result from it
    (the input of a column-parallel layer, or of the ep group's experts).
  - ``split``: this rank's block of a tensor that is the same on every
    rank; the backward all-gathers the blocks' gradients, so that every
    rank holds the whole gradient (sequence parallelism: a rank's shard
    of the sequence, whose gradient every sp rank needs). With
    ``all_gather`` (no ``sum_grad``), whose backward takes this rank's
    block of a gradient that is the same on every rank, it is the pair
    that keeps the sp ranks replicas of each other.
  - ``hop_send`` / ``hop_recv``: the pipeline's hop, stage s's tensors to
    stage s + 1 of a pipe group with no wraparound (JAX's ``ppermute``
    with the permutation ``(i, i + 1)``, cxxnet_tpu/parallel/pipeline.py
    :45), posted and taken apart so that a stage sends as soon as it has
    a microbatch's output. The pipeline's autograd node makes the hop
    differentiable: its backward hops the gradients back, stage s + 1 to
    s (parallel/pipeline.py).
  - ``ring_shift`` posts its send and its receive together
    (``batch_isend_irecv``), so that no rank waits on another; its
    backward is the shift the other way; ``all_to_all``'s is the
    all-to-all with its axes swapped.

  ``group`` is a process group (None: the default group), or a
  ``mesh.AxisGroup``, whose ``order`` places the blocks of a tensor split
  over several axes (the first axis major) on the group's ranks.
- n virtual ranks in one process (``ring_shift``, ``all_to_all``): a list
  of n per-rank tensors, which may live on one device. The shift rotates
  the list and the all-to-all regroups it, in plain (differentiable)
  tensor ops. The card's ring runs so: the trainer's sequence parallelism
  is virtual ranks on each rank's device.

Host staging. NCCL will not put two ranks on one card, so the one-card
machine runs its ranks over ``gloo`` (``CXXNET_DIST_BACKEND=gloo``,
``multihost.init_distributed``). ``gloo`` takes CUDA tensors for
``all_reduce``, ``all_gather`` and ``reduce_scatter`` (torch 2.11: it
stages them itself), but not for point-to-point sends (its TCP transport
is handed the device pointer and the process aborts), and it has no
``all_to_all`` at all there (it raises); the port's ``all_to_all`` over a
``gloo`` group is one send and one receive per pair of ranks. So for a
``gloo`` group ``ring_shift``, ``all_to_all`` and the pipeline's hop go
through host memory (``_STAGED``): a copy to the host, the sends, and a
copy back. The route is chosen by the group's backend, never by catching
an error: an ``nccl`` group never takes it.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Ranks = Union[torch.Tensor, Sequence[torch.Tensor]]


# the operations that go through host memory on a gloo group when given
# CUDA tensors (the module docstring says why)
_STAGED = frozenset({"all_to_all", "ring_shift", "pipe_hop"})


def _pg(group):
    """The process group of ``group`` (an AxisGroup or a process group)."""
    return getattr(group, "pg", group)


def _order(group, n: int):
    """Block j of a split tensor lives on group rank order[j]."""
    return getattr(group, "order", None) or list(range(n))


def _staged(op: str, group, t: torch.Tensor) -> bool:
    return _staged_on(op, group, t.device)


def _staged_on(op: str, group, device) -> bool:
    """Whether ``op`` on ``group`` goes through host memory for tensors on
    ``device``."""
    return (torch.device(device).type == "cuda" and op in _STAGED
            and dist.get_backend(_pg(group)) == "gloo")


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` of ``group``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if shift % n == 0:
        return x.clone()
    me = dist.get_rank(group)
    staged = _staged("ring_shift", group, x)
    src = x.cpu() if staged else x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, _peer(group, (me + shift) % n),
                      group),
           dist.P2POp(dist.irecv, out, _peer(group, (me - shift) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n != 0:
        raise ValueError("all_to_all: axis %d of %s does not split %d ways"
                         % (split_axis, tuple(x.shape), n))
    staged = _staged("all_to_all", group, x)
    src = x.cpu() if staged else x
    ins = [c.contiguous() for c in src.chunk(n, split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    if dist.get_backend(group) == "gloo":
        # gloo has no all_to_all in every torch (2.11 raises): one send
        # and one receive per pair of ranks
        me = dist.get_rank(group)
        outs[me].copy_(ins[me])
        ops = []
        for j in range(n):
            if j != me:
                ops += [dist.P2POp(dist.isend, ins[j], _peer(group, j),
                                   group),
                        dist.P2POp(dist.irecv, outs[j], _peer(group, j),
                                   group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    else:
        dist.all_to_all(outs, ins, group=group)
    out = torch.cat(outs, concat_axis)
    return out.to(x.device) if staged else out


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


def group_size(group) -> int:
    """The number of ranks of ``group`` (an AxisGroup or a process
    group)."""
    if hasattr(group, "n"):
        return group.n
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    if group_size(group) > 1:
        dist.all_reduce(out, group=_pg(group))
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x.clone()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=_pg(group))
    return torch.cat([parts[k] for k in _order(group, n)], dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x.clone()
    if x.shape[dim] % n != 0:
        raise ValueError("reduce_scatter: axis %d of %s does not split %d "
                         "ways" % (dim, tuple(x.shape), n))
    chunks = x.chunk(n, dim)
    ins = [None] * n
    for j, k in enumerate(_order(group, n)):
        ins[k] = chunks[j].contiguous()
    out = torch.empty_like(ins[0])
    dist.reduce_scatter(out, ins, group=_pg(group))
    return out


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` split over the group along ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    idx = group.index if hasattr(group, "index") else \
        _order(group, n).index(dist.get_rank(_pg(group)))
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sum_grad):
        ctx.group, ctx.sum_grad = group, sum_grad
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_grad:
            grad = _all_reduce(grad, ctx.group)
        return grad, None, None


class _EnterGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sum_grad):
        ctx.args = (group, dim, sum_grad)
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        group, dim, sum_grad = ctx.args
        if sum_grad:
            return _reduce_scatter(grad, group, dim), None, None, None
        return _block(grad, group, dim).contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        group, dim = ctx.args
        return _all_gather(grad, group, dim), None, None


def all_reduce(x: torch.Tensor, group=None, *,
               sum_grad: bool = False) -> torch.Tensor:
    """The sum over the group on every rank (JAX ``psum``); the backward
    is the identity, or with ``sum_grad`` the sum of the gradient over the
    group (see the module docstring)."""
    return _AllReduce.apply(x, group, bool(sum_grad))


def enter_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the group."""
    if group_size(group) == 1:
        return x
    return _EnterGroup.apply(x, group)


def all_gather(x: torch.Tensor, group=None, *, dim: int = 0,
               sum_grad: bool = False) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in block order (JAX
    ``all_gather`` with ``tiled=True``); the backward takes this rank's
    block of the gradient, summed over the group first with
    ``sum_grad``."""
    return _AllGather.apply(x, group, int(dim), bool(sum_grad))


def reduce_scatter(x: torch.Tensor, group=None, *,
                   dim: int = 0) -> torch.Tensor:
    """The sum over the group, of which each rank keeps its block along
    ``dim`` (JAX ``psum_scatter`` with ``tiled=True``); the backward is
    the all-gather."""
    return _ReduceScatter.apply(x, group, int(dim))


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        group, dim = ctx.args
        return _all_gather(grad.contiguous(), group, dim), None, None


def split(x: torch.Tensor, group=None, *, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` (the same on every rank) along ``dim``;
    the backward all-gathers the blocks' gradients, so each rank holds the
    whole gradient of ``x``."""
    if group_size(group) == 1:
        return x
    if x.shape[dim] % group_size(group) != 0:
        raise ValueError("split: axis %d of %s does not split %d ways"
                         % (dim, tuple(x.shape), group_size(group)))
    return _Split.apply(x, group, int(dim))


# the pipeline's sends and their bytes (hop_send), read by the chip check
hops = 0
hop_bytes = 0


def hop_send(xs, group, dst: int) -> list:
    """Post the sends of the tensors ``xs`` to group rank ``dst`` (a
    neighbouring stage), in order; returns the handles, each with the
    buffer it sends from, for ``hop_wait``. Through host memory on a gloo
    group (``_STAGED``)."""
    global hops, hop_bytes
    out = []
    for x in xs:
        hops += 1
        hop_bytes += x.numel() * x.element_size()
        buf = x.detach().contiguous()
        if _staged("pipe_hop", group, x):
            buf = buf.cpu()
        out.append((dist.isend(buf, _peer(_pg(group), dst),
                               group=_pg(group)), buf))
    return out


def hop_wait(handles) -> None:
    for work, _ in handles:
        work.wait()


def hop_recv(specs, group, src: int, device) -> list:
    """Receive one tensor per (shape, dtype) of ``specs`` from group rank
    ``src``, in the order it sent them, onto ``device``."""
    staged = _staged_on("pipe_hop", group, device)
    out = []
    for shape, dtype in specs:
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if staged else device)
        dist.recv(buf, _peer(_pg(group), src), group=_pg(group))
        out.append(buf.to(device) if staged else buf)
    return out
