"""Pipeline parallelism: the GPipe schedule of one rank over a ``pipe``
group, the counterpart of cxxnet_tpu/parallel/pipeline.py:65-188.

The JAX package runs the whole pipeline as one program on every device: a
scan over n_micro + k - 1 ticks in which each device traces every stage
body, ``lax.switch`` picks its own, and the padded boundary vectors (one
width F for all stages) hop one neighbour per tick by ``ppermute``. Here
each rank is a process that runs only its own stage, so neither the
padding nor the switch is needed: stage s takes microbatch m's live set
from stage s - 1 as soon as it is sent (``collectives.hop_recv``), runs its
layers on it and sends its output on to stage s + 1 (``hop_send``); the
last stage keeps the outputs of every microbatch. The data flow is the
JAX scan's, without the bubble ticks' wasted work.

The backward goes through the microbatches in reverse. Each stage keeps
only its microbatches' inputs and recomputes its activations from them, as
``jax.checkpoint`` of the stage body does (cxxnet_tpu/nnet/net.py:987-994):
it takes the gradient of its outputs from stage s + 1 (the last stage from
the loss tail), differentiates the recomputed stage, adds its weights'
gradients up over the microbatches and sends its inputs' gradient back to
stage s - 1. A rank never waits on a later stage in the forward or on an
earlier one in the backward, and its sends are posted without waiting, so
no order of the ranks deadlocks.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from . import collectives


class _GPipe(torch.autograd.Function):
    """The rank's whole schedule as one autograd node: the forward runs
    every microbatch through the stage without keeping its graph, the
    backward recomputes and differentiates them in reverse."""

    @staticmethod
    def forward(ctx, sched, *leaves):
        outs = sched.forward(leaves)
        ctx.sched = sched
        nondiff = [o for o in outs if not o.is_floating_point()]
        if nondiff:
            ctx.mark_non_differentiable(*nondiff)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        sched = ctx.sched
        ctx.sched = None
        return (None,) + tuple(sched.backward(list(grads)))


class _Schedule:
    def __init__(self, stage, n_micro, group, micro, in_specs, out_specs,
                 leaves, device, n_extra):
        self.stage, self.n_micro, self.group = stage, n_micro, group
        self.micro, self.device = micro, device
        self.in_specs, self.out_specs = in_specs, out_specs
        self.s, self.k = group.index, group.n
        # the node's inputs after the leaves (the anchor), which take no
        # gradient
        self.n_leaves, self.n_extra = len(leaves), n_extra
        self.leaves = leaves
        self.saved: List[List[torch.Tensor]] = []

    @property
    def last(self) -> bool:
        return self.s == self.k - 1

    def forward(self, inputs) -> List[torch.Tensor]:
        leaves = list(inputs[:self.n_leaves])
        sends, outs = [], []
        with torch.no_grad():
            for m in range(self.n_micro):
                if self.s == 0:
                    xs = list(self.micro[m])
                else:
                    xs = collectives.hop_recv(self.in_specs, self.group,
                                              self.s - 1, self.device)
                ys = self.stage(m, xs, leaves, True)
                self.saved.append(xs)
                if self.last:
                    outs.append(ys)
                else:
                    sends += collectives.hop_send(ys, self.group, self.s + 1)
        collectives.hop_wait(sends)
        self.micro = None
        if self.last:
            return [torch.cat([o[j] for o in outs], 0)
                    for j in range(len(self.out_specs))]
        # the stage's stand-in output: a zero whose backward runs the
        # schedule's backward
        return [torch.zeros((), device=self.device)]

    def backward(self, grads) -> List[Optional[torch.Tensor]]:
        acc: List[Optional[torch.Tensor]] = [None] * self.n_leaves
        if self.last:
            mb = self.out_specs[0][0][0] if self.out_specs else 0
            per = [[None if g is None else g[m * mb:(m + 1) * mb]
                    for g in grads] for m in range(self.n_micro)]
        sends = []
        for m in reversed(range(self.n_micro)):
            if self.last:
                gs = per[m]
            else:
                want = [sp for sp in self.out_specs
                        if sp[1].is_floating_point]
                got = iter(collectives.hop_recv(want, self.group, self.s + 1,
                                                self.device))
                gs = [next(got) if sp[1].is_floating_point else None
                      for sp in self.out_specs]
            xs = [x.detach().requires_grad_(self.s > 0
                                            and x.is_floating_point())
                  for x in self.saved[m]]
            self.saved[m] = None
            ps = [t.detach().requires_grad_(t.requires_grad)
                  for t in self.leaves]
            with torch.enable_grad():
                ys = self.stage(m, xs, ps, False)
            pairs = [(y, g) for y, g in zip(ys, gs)
                     if g is not None and y.requires_grad]
            wrt = [t for t in ps if t.requires_grad] + \
                [x for x in xs if x.requires_grad]
            if pairs and wrt:
                got = torch.autograd.grad([y for y, _ in pairs], wrt,
                                          [g for _, g in pairs],
                                          allow_unused=True)
            else:
                got = [None] * len(wrt)
            got = iter(got)
            for j, t in enumerate(ps):
                if t.requires_grad:
                    g = next(got)
                    if g is not None:
                        acc[j] = g if acc[j] is None else acc[j] + g
            if self.s > 0:
                dx = [next(got) if x.requires_grad else None for x in xs]
                sends += collectives.hop_send(
                    [torch.zeros_like(x) if d is None else d
                     for x, d in zip(xs, dx) if x.is_floating_point()],
                    self.group, self.s - 1)
        collectives.hop_wait(sends)
        self.leaves = None
        return acc + [None] * self.n_extra


def gpipe(stage: Callable, n_micro: int, group,
          micro: Optional[Sequence[Sequence[torch.Tensor]]],
          in_specs, out_specs, leaves: Sequence[torch.Tensor],
          anchor: Optional[torch.Tensor] = None,
          device=None) -> List[torch.Tensor]:
    """Run this rank's stage of a GPipe pipeline over ``group`` (a mesh
    ``AxisGroup`` of the ``pipe`` axis).

    ``stage(m, xs, ps, record)`` computes microbatch m's outputs (a list,
    the live set leaving the stage) from its inputs ``xs`` (the live set
    entering it) with the stage's weights ``ps`` (``leaves`` in the
    forward, differentiable copies of them in the backward's recompute);
    ``record`` is True in the forward alone (state such as batch-norm's
    running statistics is recorded there). ``micro`` holds each
    microbatch's inputs on stage 0 (None elsewhere); ``in_specs`` /
    ``out_specs`` give the (shape, dtype) of a microbatch's inputs and
    outputs, which the neighbouring stages send and receive. ``anchor``
    (a leaf tensor that requires grad) joins the node's inputs, so that
    the backward runs on a stage without weights too.

    Returns on the last stage its outputs for the whole batch (the
    microbatches concatenated in order), differentiable; on the others a
    zero whose backward runs the stage's backward."""
    extra = [] if anchor is None else [anchor]
    sched = _Schedule(stage, n_micro, group, micro, list(in_specs),
                      list(out_specs), list(leaves), device, len(extra))
    return list(_GPipe.apply(sched, *leaves, *extra))
