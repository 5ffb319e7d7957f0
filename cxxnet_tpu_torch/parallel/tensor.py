"""Tensor and expert parallelism over a group of ranks: the counterpart of
cxxnet_tpu/parallel/tensor.py (Megatron-style column / row parallel dense
layers, and the expert-parallel FFN of the moe layer).

Each rank of the group holds a shard of the weight and runs its part; the
collectives are explicit (``collectives``), where the JAX package leaves
them to ``shard_map``:

- ``column_parallel_dense``: the weight split on its output dimension; the
  input enters the group (its gradient summed over the ranks), the output
  is this rank's shard of the features. No collective on the forward.
- ``row_parallel_dense``: the weight split on its input dimension, the
  input split to match; one all-reduce gives the whole output.
- ``expert_parallel_ffn``: this rank's slice of the experts, dense over
  every row, the gate-weighted outputs summed over the group by one
  all-reduce.

The layers (``fullc``, ``conv``, ``moe``) run these under the trainer's
``model_parallel`` / ``expert_parallel``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed

from . import collectives


def column_parallel_dense(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor], group) -> torch.Tensor:
    """y = x @ w.T + b with w (out/n, in) this rank's rows of the weight
    and b (out/n,) its bias shard (or None): x (batch, in), the same on
    every rank; y (batch, out/n) this rank's features."""
    y = collectives.enter_group(x, group) @ w.t()
    if b is not None:
        y = y + b
    return y


def row_parallel_dense(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor], group) -> torch.Tensor:
    """y = x @ w.T + b with w (out, in/n) this rank's columns of the weight
    and x (batch, in/n) the matching block of the input; one all-reduce
    gives the whole y (batch, out) on every rank."""
    y = collectives.all_reduce(x @ w.t(), group)
    if b is not None:
        y = y + b
    return y


def expert_parallel_ffn(x: torch.Tensor, w_local: torch.Tensor,
                        gate_probs: torch.Tensor, group) -> torch.Tensor:
    """The expert-parallel FFN: x (batch, d_in), the same on every rank of
    the group; w_local (n_experts / n, d_in, d_out) this rank's experts;
    gate_probs (batch, n_experts) the gate over every expert. Each rank
    runs its experts densely over all rows (relu(x @ W_e)), weights them by
    their gate columns, and one all-reduce sums the ranks' parts."""
    n = collectives.group_size(group)
    n_exp = gate_probs.shape[1]
    if n_exp % n != 0:
        raise ValueError("expert_parallel_ffn: n_experts %d not divisible by "
                         "mesh axis %r size %d" % (n_exp, "ep", n))
    loc = n_exp // n
    if w_local.shape[0] != loc:
        raise ValueError("expert_parallel_ffn: %d local experts given, the "
                         "group of %d holds %d each"
                         % (w_local.shape[0], n, loc))
    idx = group.index if hasattr(group, "index") else \
        torch.distributed.get_rank(group)
    x = collectives.enter_group(x, group)
    probs = collectives.enter_group(gate_probs, group)
    p_l = probs[:, idx * loc:(idx + 1) * loc]
    y = torch.relu(torch.einsum("bi,eio->ebo", x, w_local))
    return collectives.all_reduce(torch.einsum("ebo,be->bo", y, p_l), group)
