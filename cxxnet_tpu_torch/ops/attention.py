"""Dense softmax attention: the counterpart of
cxxnet_tpu/parallel/ring.py:36-67 ``attention_reference``.

The JAX package leaves this function to XLA; here it is plain PyTorch ops.
The attention layer takes it for sequences the flash kernel does not take
(L < 128) and for the KV-cached decode steps, whose one query row attends
against the whole cache (cxxnet_tpu/layer/layers.py:1307-1310). A decode
step of a session gives each row its own position: ``q_offset`` may be a
(b,) tensor, where the JAX package vmaps a one-row step over the slots.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..layer.base import check


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None, window: int = 0,
                        q_offset: Union[int, torch.Tensor] = 0
                        ) -> torch.Tensor:
    """softmax(scale * q k^T + mask) v for q (b, nh, Lq, d) and k/v
    (b, nkv, Lk, d). k/v may carry fewer heads (grouped-query attention):
    nkv divides nh and each group of nh/nkv query heads attends to one
    shared k/v head, with no broadcast copy. ``causal`` keeps key positions
    <= the query's, ``window > 0`` (causal only) the last ``window`` of
    them; ``q_offset`` is the global position of q's first row (a decode
    step against a longer cache), an int or a (b,) tensor of one position
    per batch row. Masked scores are -inf, as in JAX."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    check(window == 0 or causal, "window attention requires causal")
    b, nh, sq, d = q.shape
    nkv = k.shape[1]
    check(nh % nkv == 0, "query heads must be a multiple of kv heads")
    g = nh // nkv
    qg = q.reshape(b, nkv, g, sq, d)
    s = torch.einsum("bngqd,bnkd->bngqk", qg, k) * scale
    if causal:
        skv = k.shape[2]
        qpos = torch.arange(sq, device=q.device)[:, None]
        if torch.is_tensor(q_offset):
            # (b, 1, 1, sq, 1): each batch row at its own position
            qpos = q_offset.reshape(b, 1, 1, 1, 1) + qpos
        else:
            qpos = q_offset + qpos
        kpos = torch.arange(skv, device=q.device)[None, :]
        keep = qpos >= kpos
        if window > 0:
            keep = keep & (qpos - kpos < window)
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bngqk,bnkd->bngqd", p, v).reshape(b, nh, sq, d)
