"""The mesh of ranks: the counterpart of cxxnet_tpu/parallel/mesh.py:18-91
and of the JAX trainer's mesh build (cxxnet_tpu/nnet/trainer.py:252-296).

JAX drives every device of its mesh from one process; the port is SPMD: one
process per rank, one device per rank, and every rank runs the same
program. A ``Mesh`` names the axes of the world in the JAX order, ``data``
outermost, then ``pipe``, ``ep``, ``sp`` and ``model`` innermost, so that a
model group is a run of consecutive ranks. ``data`` is always an axis;
another axis is one only when its size is above 1, as in the JAX trainer.
The trainer's ``seq_parallel`` is the ``sp`` axis over a world of several
ranks; on a world of one rank it runs as virtual ranks on the rank's own
device and the mesh is None.

A rank's place is its coordinate on each axis (mixed radix over the axes,
the last fastest). For every set of axes the mesh holds one
``torch.distributed`` group per rank: the ranks that differ from it on
those axes alone. ``group(axes)`` hands it out as an ``AxisGroup``, which
also knows the order of the blocks of a tensor split over those axes (the
first axis major, as a JAX ``PartitionSpec`` entry ``("model", "data")``
means) against the group's own rank order (the ranks sorted).

A ``Mesh`` made with ``groups=False`` carries the shape alone: the
placement rules (``sharding``) read nothing else, and tests set them
beside JAX's on a mesh of any size without starting a process.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

from ..layer.base import check

# the axes in mesh order (cxxnet_tpu/nnet/trainer.py:282)
AXES = ("data", "pipe", "ep", "sp", "model")


class AxisGroup:
    """The ranks that differ from this one on ``axes`` alone.

    ``n`` ranks; ``index`` is this rank's block of a tensor split over the
    axes (the first axis major); ``order[j]`` is the group rank (the
    position among the sorted global ranks) that holds block j; ``pg`` the
    process group, None when n is 1."""

    __slots__ = ("axes", "n", "index", "order", "pg")

    def __init__(self, axes, n, index, order, pg):
        self.axes, self.n, self.index, self.order, self.pg = \
            axes, n, index, order, pg


class Mesh:
    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 groups: bool = False):
        """A mesh of ``sizes`` (axis -> size, missing axes size 1), seen
        from global rank ``rank``. ``groups`` makes the process groups:
        every rank of the world must then build the mesh, in the same
        order, as ``torch.distributed.new_group`` demands."""
        for a in sizes:
            check(a in AXES, "unknown mesh axis %r" % a)
        self.axis_names: Tuple[str, ...] = tuple(
            a for a in AXES if a == "data" or int(sizes.get(a, 1)) > 1)
        self.shape: Dict[str, int] = {a: int(sizes.get(a, 1))
                                      for a in self.axis_names}
        self.size = 1
        for a in self.axis_names:
            self.size *= self.shape[a]
        check(0 <= rank < self.size, "rank %d outside a mesh of %d"
              % (rank, self.size))
        self.rank = int(rank)
        self.coords = self.coords_of(self.rank)
        self._pgs: Dict[frozenset, object] = {}
        if groups and self.size > 1:
            self._new_groups()

    def coords_of(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return out

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def _members(self, axes: Sequence[str], coords: Dict[str, int]
                 ) -> List[int]:
        """The global ranks of the group over ``axes`` through ``coords``,
        in block order (the first axis major)."""
        out = []
        for idx in itertools.product(*[range(self.shape[a]) for a in axes]):
            c = dict(coords)
            c.update(zip(axes, idx))
            out.append(self.rank_of(c))
        return out

    def _new_groups(self) -> None:
        """One process group per set of axes of size > 1 and per rank's
        place on the other axes, made in the same order on every rank."""
        live = [a for a in self.axis_names if self.shape[a] > 1]
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                others = [a for a in self.axis_names if a not in axes]
                for idx in itertools.product(
                        *[range(self.shape[a]) for a in others]):
                    c = {a: 0 for a in self.axis_names}
                    c.update(zip(others, idx))
                    ranks = sorted(self._members(axes, c))
                    pg = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._pgs[frozenset(axes)] = pg

    def group(self, axes) -> AxisGroup:
        """The group over ``axes`` (a name or a sequence of names; axes the
        mesh lacks or of size 1 drop out), with its block order."""
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if self.axis_size(a) > 1)
        members = self._members(axes, self.coords)
        n = len(members)
        if n == 1:
            return AxisGroup(axes, 1, 0, [0], None)
        srt = sorted(members)
        order = [srt.index(g) for g in members]
        key = frozenset(axes)
        check(key in self._pgs, "mesh built without process groups: no "
              "group over %s" % (axes,))
        return AxisGroup(axes, n, members.index(self.rank), order,
                         self._pgs[key])

    def is_first(self, axes) -> bool:
        """Whether this rank is at coordinate 0 on every one of ``axes``:
        the one rank of each replica set that counts a replicated value."""
        return all(self.coords.get(a, 0) == 0 for a in axes)


def world() -> Tuple[int, int]:
    """(size, rank) of the default process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(model_parallel: int = 1, expert_parallel: int = 1,
                batch_size: int = 0, n: Optional[int] = None,
                rank: Optional[int] = None, groups: bool = True,
                pipeline_parallel: int = 1, seq_parallel: int = 1,
                pipeline_micro: int = 0) -> Optional[Mesh]:
    """The trainer's mesh over the world (JAX ``Trainer._setup_mesh``,
    cxxnet_tpu/nnet/trainer.py:252-296): the world's ranks are its
    devices, dp = world / (model_parallel * seq_parallel *
    pipeline_parallel * expert_parallel), with the JAX trainer's checks and
    messages. ``seq_parallel`` joins the product only over several ranks:
    on one rank it runs as virtual ranks on the rank's device. None for a
    world of one rank. ``n`` / ``rank`` stand in for the world (the
    shape-only meshes of the rule tests)."""
    if n is None:
        n, r = world()
        rank = r if rank is None else rank
    rank = rank or 0
    mp, ep = int(model_parallel), int(expert_parallel)
    pp = int(pipeline_parallel)
    sp = int(seq_parallel) if n > 1 else 1
    ways = mp * sp * pp * ep
    check(n % ways == 0,
          "device count %d must be divisible by model_parallel * "
          "seq_parallel * pipeline_parallel * expert_parallel = %d"
          % (n, ways))
    dp = n // ways
    if pp > 1:
        n_micro = int(pipeline_micro) or pp
        check(batch_size % n_micro == 0,
              "batch_size must be divisible by the microbatch count "
              "(pipeline_micro, default pipeline_parallel)")
        check(dp == 1 or (batch_size // n_micro) % dp == 0,
              "microbatch size (batch_size / pipeline_micro) must be "
              "divisible by the data-parallel degree")
    else:
        check(dp == 1 or batch_size % dp == 0,
              "batch_size must be divisible by the data-parallel degree")
    if n <= 1:
        return None
    return Mesh({"data": dp, "pipe": pp, "ep": ep, "sp": sp, "model": mp},
                rank, groups=groups)
