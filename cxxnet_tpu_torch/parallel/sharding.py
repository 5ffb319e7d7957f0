"""Placement rules: which dimension of a tensor is split over which mesh
axes. The port's own copy of cxxnet_tpu/parallel/sharding.py:20-199, as
pure functions of a shape and the mesh.

A placement is a tuple in the form of a JAX ``PartitionSpec``: one entry
per leading dimension, None (not split), an axis name, or a tuple of axis
names (split over their product, the first axis major); ``()`` is
replicated. Every rule here splits at most one dimension (``split_of``).
``shard`` cuts a whole tensor down to a rank's block (a view),
``shard_copy`` and ``shard_params`` to a copy of its own on the rank's
device, and ``shard_shape`` gives the block's shape.

- ``tp_spec``: tensor and expert parallelism. A fullc ``wmat`` (out, in)
  splits its output dimension over ``model`` (column parallel), a conv
  ``wmat`` (g, co/g, ci/g*kh*kw) its output channels (dimension 1), a moe
  ``experts`` stack its experts over ``ep``; attention projections, biases,
  norms and embeddings stay replicated (cxxnet_tpu/parallel/sharding.py
  :148-199).
- ``zero_sharding``: ZeRO-1 (``update_on_server``), the split of one
  optimizer-state tensor: dimension 0 over ``data``, extended greedily over
  every other axis that keeps it divisible; composed with a TP placement on
  the TP dimension, TP major (:29-79).
- ``fsdp_shardings``: ZeRO-3 (``fsdp``), the weights themselves split over
  ``data`` on their first divisible dimension, composed with TP the same
  way; 1-D tensors and layer state (batch-norm running statistics) keep
  their placement (:105-146).
- ``flat_blocks``: ZeRO-1 inside a pipeline stage (``fsdp`` under
  ``pipeline_parallel``): the stage's tensors laid end to end in layer
  order, each layer's keys sorted, padded to a multiple of the data-axis
  size and cut into one block a data rank, the JAX trainer's packed row
  sharded ``P("pipe", "data")`` (cxxnet_tpu/nnet/trainer.py:462-501). A
  pipe rank's own tensors are its stage's (a rank holds no other), so
  the stage needs no placement beyond its layers' TP / EP one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

Spec = Tuple


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split_of(spec: Spec) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """(dimension, axes) of the one split of ``spec``; None when it splits
    nothing."""
    out = None
    for d, e in enumerate(spec or ()):
        if _axes(e):
            assert out is None, "placement %r splits two dimensions" % (spec,)
            out = (d, _axes(e))
    return out


def block_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a split over ``axes``
    on ``mesh``, the first axis major."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.coords.get(a, 0)
        n *= mesh.axis_size(a)
    return idx, n


def shard_shape(shape, mesh, spec: Spec) -> Tuple[int, ...]:
    sp = split_of(spec)
    shape = tuple(int(s) for s in shape)
    if sp is None:
        return shape
    d, axes = sp
    n = block_index(mesh, axes)[1]
    return shape[:d] + (shape[d] // n,) + shape[d + 1:]


def shard(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a view)."""
    sp = split_of(spec)
    if sp is None:
        return x
    d, axes = sp
    idx, n = block_index(mesh, axes)
    size = x.shape[d] // n
    return x.narrow(d, idx * size, size)


def shard_copy(x, mesh, spec: Spec, device: torch.device,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's block under ``spec`` of a whole array or tensor ``x``
    (``mesh`` None: the whole), a contiguous tensor of its own on
    ``device``, of ``dtype`` when given."""
    t = torch.as_tensor(x)
    if mesh is not None:
        t = shard(t, mesh, spec)
    return t.to(device, dtype).contiguous().clone()


def shard_params(params: Sequence[Dict[str, object]], mesh, specs,
                 device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """This rank's blocks of whole per-layer params (arrays or tensors):
    each (layer, key) cut by its placement ``specs[layer][key]`` on
    ``mesh`` (None: one rank, every tensor whole) by ``shard_copy``."""
    return [{k: shard_copy(v, mesh, specs[i][k] if mesh is not None
                           else (), device) for k, v in p.items()}
            for i, p in enumerate(params)]


def relative(spec: Spec, base: Spec) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """The split ``spec`` adds to ``base``: (dimension, the axes of spec's
    split that base's split lacks), None when it adds none. Both split the
    same dimension, or base splits none (the composition rules below)."""
    sp, bp = split_of(spec), split_of(base)
    if sp is None:
        return None
    if bp is not None:
        assert bp[0] == sp[0] and sp[1][:len(bp[1])] == bp[1], \
            "placement %r does not nest in %r" % (spec, base)
        extra = sp[1][len(bp[1]):]
        return (sp[0], extra) if extra else None
    return sp


def _extend_base_split(mesh, shape, base_spec: Spec, axis: str) -> Spec:
    """A data-axis split composed with an existing TP / EP placement: the
    split extends ON THE SAME dimension, the TP axis major, so each rank's
    shard nests inside its own TP slice. One rule for zero_sharding and
    fsdp_shardings, so the two never drift apart."""
    n = mesh.axis_size(axis)
    d = next(i for i, a in enumerate(base_spec) if a is not None)
    tp_axis = base_spec[d]
    if shape[d] % (n * mesh.axis_size(tp_axis)) == 0:
        spec = list(base_spec)
        spec[d] = (tp_axis, axis)
        return tuple(spec)
    return tuple(base_spec)


def zero_sharding(mesh, shape, axis: str = "data",
                  base_spec: Optional[Spec] = None) -> Spec:
    """The placement of one optimizer-state tensor of ``shape``: dimension
    0 split over the data axis when divisible, extended greedily over the
    other axes (the tensor is replicated over every axis, so its state may
    shard over all of them jointly); composed with a TP ``base_spec``
    instead when there is one."""
    shape = tuple(shape)
    if (base_spec and any(a is not None for a in base_spec)
            and len(shape) == len(base_spec)):
        return _extend_base_split(mesh, shape, base_spec, axis)
    if len(shape) > 0:
        joint, prod = [], 1
        for a in (axis,) + tuple(x for x in mesh.axis_names if x != axis):
            sz = mesh.axis_size(a)
            if sz > 1 and shape[0] % (prod * sz) == 0:
                joint.append(a)
                prod *= sz
        if prod > 1 and shape[0] >= prod:
            return (joint[0] if len(joint) == 1 else tuple(joint),)
    return ()


def fsdp_shardings(mesh, layers, shapes: Sequence[Dict[str, tuple]],
                   base_shardings=None, axis: str = "data"
                   ) -> List[Dict[str, Spec]]:
    """Per layer, {key: placement} of the weights under fsdp: the first
    dimension divisible by the data-axis size split over it, composed
    with a TP / EP placement (``base_shardings``, the form of
    ``param_shardings``) on the same dimension; 1-D tensors and layer
    state keep the base placement."""
    n = mesh.axis_size(axis)
    out = []
    for i, (lay, p) in enumerate(zip(layers, shapes)):
        shard_ = {}
        state = set(lay.state_keys()) if hasattr(lay, "state_keys") else ()
        for key, shape in p.items():
            shape = tuple(shape)
            base = None
            if base_shardings is not None and key in base_shardings[i]:
                base = base_shardings[i][key]
            if key in state or len(shape) < 2 or n <= 1:
                shard_[key] = tuple(base or ())
                continue
            if base is not None and any(a is not None for a in base):
                shard_[key] = _extend_base_split(mesh, shape, base, axis)
                continue
            for d in range(len(shape)):
                if shape[d] % n == 0 and shape[d] >= n:
                    spec = [None] * len(shape)
                    spec[d] = axis
                    shard_[key] = tuple(spec)
                    break
            else:
                shard_[key] = ()
        out.append(shard_)
    return out


def tp_spec(lay, key: str, shape, mesh) -> Spec:
    """The tensor / expert-parallel placement of one weight tensor."""
    tname = getattr(lay, "type_name", "")
    shape = tuple(shape)
    if "model" in mesh.axis_names:
        n_model = mesh.axis_size("model")
        if (tname == "fullc" and key == "wmat"
                and len(shape) == 2 and shape[0] % n_model == 0):
            return ("model", None)
        if (tname == "conv" and key == "wmat"
                and len(shape) == 3 and shape[1] % n_model == 0):
            return (None, "model", None)
    if (tname == "moe" and key == "experts" and "ep" in mesh.axis_names
            and len(shape) >= 1 and shape[0] % mesh.axis_size("ep") == 0):
        return ("ep", None, None)
    return ()


def param_shardings(mesh, layers, shapes: Sequence[Dict[str, tuple]]
                    ) -> List[Dict[str, Spec]]:
    """Per layer, {key: tp_spec} of every weight."""
    return [{k: tp_spec(lay, k, s, mesh) for k, s in p.items()}
            for lay, p in zip(layers, shapes)]


def flat_blocks(sizes: Sequence[int], n: int, index: int):
    """Tensors of ``sizes`` elements laid end to end and cut into ``n``
    equal blocks (the total padded up to a multiple of n): (each tensor's
    offset, the block size, the (start, stop) of each tensor inside block
    ``index``, relative to the tensor, empty where the block misses
    it)."""
    offs, off = [], 0
    for sz in sizes:
        offs.append(off)
        off += int(sz)
    c = -(-off // n)
    lo, hi = index * c, (index + 1) * c
    segs = [(min(max(lo, a), a + sz) - a, max(min(hi, a + sz), a) - a)
            for a, sz in zip(offs, sizes)]
    return offs, c, segs
