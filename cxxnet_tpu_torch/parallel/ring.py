"""Sequence parallelism: ring attention and Ulysses attention, the
counterpart of cxxnet_tpu/parallel/ring.py:146-488; and the chunked
flash-decode step of a KV-cached decode (``decode_attention_chunked``,
:70-140).

A long sequence is cut into n shards along its axis, one per rank, and
attention runs either as

- **ring attention** (``ring_attention``): each rank keeps its query shard
  and the K/V blocks rotate around the ring, one neighbour hop per step,
  while each rank folds the block it holds into an online softmax. Shapes
  that ``ring_flash.supports`` admits run the ring-step kernels
  (``_RingFlash``, JAX's ``_ring_flash_local``, :258-384): n steps of the
  forward step kernel, and a backward that is a second ring pass in which dQ
  accumulates on its rank and dK/dV travel with their K/V block, home after
  n shifts. Any other shape runs the dense ring (``_dense_ring``, JAX's
  ``_ring_attention_local``, :146-251): plain PyTorch ops whose carry is in
  q's dtype, through PyTorch's autograd and the differentiable
  ``ring_shift``.
- **Ulysses** (``ulysses_attention``, :437-488): one all-to-all swaps the
  sequence sharding for head sharding, each rank attends over whole
  sequences of its heads (the flash kernels where ``flash_attn.supports``
  admits the shape, dense attention otherwise), and a second all-to-all
  swaps back.

Both take their ranks one of two ways: ``group``, a ``torch.distributed``
process group whose ranks each pass their own shards; or ``n`` virtual
ranks in this process, which take the full (b, h, L, d) tensors and split
them along the sequence themselves. There is one card, and NCCL will not
put two ranks on one GPU, so on the card the ring runs as n virtual ranks.
The result equals single-device attention either way.

There is no switch like the JAX package's ``CXXNET_RING``: CUDA tensors of
a shape the step kernels take run the kernels, CPU tensors their plain
versions, and a kernel that fails raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..layer.base import check
from ..ops import attention, flash_attn
from ..ops import ring_flash as rf
from . import collectives

# per-step score tiles of the dense ring are capped at (RING_Q_CHUNK, skv):
# the local block runs one query chunk at a time, each recomputed in the
# backward (JAX's lax.map under jax.checkpoint)
RING_Q_CHUNK = 1024


def decode_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             pos: Union[int, torch.Tensor],
                             span: Optional[Tuple[int, int]] = None,
                             scale: Optional[float] = None, window: int = 0,
                             chunk: int = 256) -> torch.Tensor:
    """One-position cache attention that reads only the live chunks of the
    cache: ``attention_reference(q, k, v, causal=True, q_offset=pos)`` for
    a one-row query at position ``pos``, computed as an online softmax over
    ``chunk``-row blocks of the cache, accumulated in float32 (the JAX
    package's flash-decode step in plain XLA, here in plain PyTorch ops).

    q: (b, nh, 1, d); k/v: (b, nkv, L_max, d) caches, GQA-sized. ``pos`` is
    an int or a (b,) tensor of each row's position; ``span`` = (lowest,
    highest) position of the rows, from the host's bookkeeping (required
    for a tensor ``pos``: the chunk loop's bounds never read the device).
    The loop runs over chunks [c_lo, hi // chunk], c_lo the first chunk
    inside the window of the lowest row (0 without a window). A row meets
    the chunks outside its own live range as wholly masked ones: before
    its first live key its carry stays zero (the rescale of a -inf maximum
    is guarded to 0, the weights of masked keys are 0), after its last one
    it is rescaled by exp(0) = 1 and adds zeros, so each row's result is
    bitwise the one its own loop over its own chunks gives."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, nh, sq, d = q.shape
    check(sq == 1, "decode_attention_chunked is a single-position step")
    nkv, l_max = k.shape[1], k.shape[2]
    check(nh % nkv == 0, "query heads must be a multiple of kv heads")
    check(l_max % chunk == 0, "cache length %d must be divisible by "
          "decode_chunk %d" % (l_max, chunk))
    if torch.is_tensor(pos):
        check(span is not None, "decode_attention_chunked: a per-row pos "
              "needs the host's span of positions")
        lo, hi = span
        pos_r = pos.reshape(b, 1, 1, 1)
    else:
        lo = hi = int(pos)
        pos_r = pos
    g = nh // nkv
    qg = q.reshape(b, nkv, g, d).float()
    c_lo = max(0, (lo - (window - 1)) // chunk) if window > 0 else 0
    m = torch.full((b, nkv, g, 1), float("-inf"), device=q.device)
    l_sum = torch.zeros((b, nkv, g, 1), device=q.device)
    acc = torch.zeros((b, nkv, g, d), device=q.device)
    for c in range(c_lo, hi // chunk + 1):
        kc = k[:, :, c * chunk:(c + 1) * chunk].float()
        vc = v[:, :, c * chunk:(c + 1) * chunk].float()
        s = torch.einsum("bngd,bnkd->bngk", qg, kc) * scale
        kpos = c * chunk + torch.arange(chunk, device=q.device)
        keep = kpos <= pos_r
        if window > 0:
            keep = keep & (pos_r - kpos < window)
        s = s.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                            torch.zeros_like(m))
        p = torch.where(keep, torch.exp(s - m_new), torch.zeros_like(s))
        l_sum = l_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bngk,bnkd->bngd", p, vc)
        m = m_new
    return (acc / l_sum).reshape(b, nh, 1, d).to(q.dtype)


class _Ranks:
    """The sequence-parallel ranks this process runs: n virtual ranks over
    full tensors, or its own rank of a process group over its own shards."""

    def __init__(self, n: Optional[int], group):
        if (n is None) == (group is None):
            raise ValueError("sequence parallelism: pass n (virtual ranks "
                             "in this process) or group (a process group), "
                             "one of the two")
        self.group = group
        if group is not None:
            self.n = dist.get_world_size(group)
            self.idx = [dist.get_rank(group)]
        else:
            if n < 1:
                raise ValueError("sequence parallelism needs n >= 1, not %d"
                                 % n)
            self.n = n
            self.idx = list(range(n))

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The shards of x (b, h, L, d) this process holds."""
        if self.group is not None:
            return [x]
        if x.shape[2] % self.n != 0:
            raise ValueError("sequence parallelism: sequence length %d does "
                             "not split into %d ranks" % (x.shape[2],
                                                          self.n))
        return list(x.chunk(self.n, 2))

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return xs[0] if self.group is not None else torch.cat(xs, 2)

    def shift(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's tensor to the next rank of the ring."""
        if self.group is not None:
            return [collectives.ring_shift(xs[0], self.group)]
        return collectives.ring_shift(xs)

    def blocks(self, xs: List[torch.Tensor]) -> List[List[torch.Tensor]]:
        """The blocks each rank holds at the n steps of the ring, [step]
        [local rank], differentiable: step t holds the block of rank
        idx - t."""
        if self.group is None:
            out = [xs]
            for _ in range(self.n - 1):
                out.append(self.shift(out[-1]))
            return out
        return [[b] for b in _RingBlocks.apply(self.group, self.n, xs[0])]

    def all_to_all(self, xs: List[torch.Tensor], split_axis: int,
                   concat_axis: int) -> List[torch.Tensor]:
        if self.group is not None:
            return [collectives.all_to_all(xs[0], self.group,
                                           split_axis=split_axis,
                                           concat_axis=concat_axis)]
        return collectives.all_to_all(xs, split_axis=split_axis,
                                      concat_axis=concat_axis)


class _RingBlocks(torch.autograd.Function):
    """A process's block at each of the n ring steps: n - 1 shifts forward;
    backward, the n blocks' gradients carried home through n - 1 shifts
    the other way (ring_shift's transpose), summing as they go. One autograd
    node for the whole rotation: with one node per shift, autograd would
    skip the shifts whose blocks a rank never reads (a chunk wholly masked
    on that rank) and order the rest by each rank's own graph, while the
    other ranks wait on them."""

    @staticmethod
    def forward(ctx, group, n, x):
        ctx.group = group
        out = [x]
        for _ in range(n - 1):
            out.append(collectives.ring_shift(out[-1], group))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        acc = grads[-1]
        for g in reversed(grads[:-1]):
            acc = collectives.ring_shift(acc, ctx.group, -1) + g
        return None, None, acc


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(b, h, s, d) as contiguous (b h, s, d)."""
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d).contiguous()


def _ring_flash_fwd(q, k, v, ranks: _Ranks, causal: bool, scale: float,
                    window: int):
    """The kernel ring's forward: the f32 carry seeded with (NEG_INF, 0, 0),
    n steps of the forward step rotating K/V, then out = acc / max(l, 1e-30)
    and lse = m + log(max(l, 1e-30)) (cxxnet_tpu/parallel/ring.py:288-307).
    Returns out (the ranks' shards joined) and the local ranks' lse stacked,
    (ranks here, b h, sq, 1)."""
    kw = dict(causal=causal, scale=scale, window=window)
    n = ranks.n
    qf = [_rows(t) for t in ranks.split(q)]
    kb = [_rows(t) for t in ranks.split(k)]
    vb = [_rows(t) for t in ranks.split(v)]
    bh, sq, d = qf[0].shape
    skv = kb[0].shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    m = [torch.full((bh, sq, 1), flash_attn.NEG_INF, **f32) for _ in qf]
    l = [torch.zeros((bh, sq, 1), **f32) for _ in qf]
    acc = [torch.zeros((bh, sq, d), **f32) for _ in qf]
    for t in range(n):
        for i, idx in enumerate(ranks.idx):
            src = (idx - t) % n   # whose block rank idx holds at step t
            m[i], l[i], acc[i] = rf.fwd_step(
                qf[i], kb[i], vb[i], m[i], l[i], acc[i],
                (idx * sq, src * skv), **kw)
        if t + 1 < n:
            kb, vb = ranks.shift(kb), ranks.shift(vb)
    b, h = q.shape[:2]
    outs, lses = [], []
    for mi, li, ai in zip(m, l, acc):
        l_safe = li.clamp_min(1e-30)
        outs.append((ai / l_safe).to(q.dtype).reshape(b, h, sq, d))
        lses.append(mi + torch.log(l_safe))
    return ranks.join(outs), torch.stack(lses)


def _ring_flash_bwd(q, k, v, out, lse, grad, ranks: _Ranks, causal: bool,
                    scale: float, window: int):
    """The kernel ring's backward, a second ring pass
    (cxxnet_tpu/parallel/ring.py:310-376): D = rowsum(dO o O), dQ
    accumulates on its rank, dK/dV ride the ring with their K/V block and
    are home after n shifts, then each kv head's group is summed. Returns
    (dq, dk, dv) in the inputs' dtypes."""
    kw = dict(causal=causal, scale=scale, window=window)
    n = ranks.n
    qf = [_rows(t) for t in ranks.split(q)]
    kb = [_rows(t) for t in ranks.split(k)]
    vb = [_rows(t) for t in ranks.split(v)]
    dof = [_rows(t) for t in ranks.split(grad)]
    delta = [flash_attn.bwd_delta(o, g)[..., None]
             for o, g in zip((_rows(t) for t in ranks.split(out)), dof)]
    bh, sq, d = qf[0].shape
    skv = kb[0].shape[1]
    dq = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
          for t in qf]
    # dK/dV ride the ring at query-head resolution (the step kernels' and
    # JAX's); each kv head's group is summed once, after the ring
    dk = [torch.zeros((bh, skv, d), dtype=torch.float32, device=q.device)
          for _ in qf]
    dv = [torch.zeros_like(t) for t in dk]
    for t in range(n):
        for i, idx in enumerate(ranks.idx):
            offs = (idx * sq, ((idx - t) % n) * skv)
            dq[i] = rf.dq_step(qf[i], kb[i], vb[i], dof[i], lse[i], delta[i],
                               dq[i], offs, **kw)
            dk[i], dv[i] = rf.dkv_step(qf[i], kb[i], vb[i], dof[i], lse[i],
                                       delta[i], dk[i], dv[i], offs, **kw)
        # the K/V block rotates with its gradient carries: after n shifts
        # each carry is home with every rank's share in it
        if t + 1 < n:
            kb, vb = ranks.shift(kb), ranks.shift(vb)
        dk, dv = ranks.shift(dk), ranks.shift(dv)

    def back(xs, like):
        b, h = like.shape[:2]
        return ranks.join([x.reshape(b, h, -1, *x.shape[1:]).sum(2)
                           .to(like.dtype) for x in xs])
    return back(dq, q), back(dk, k), back(dv, v)


class _RingFlash(torch.autograd.Function):
    """Ring attention on the step kernels (JAX's ``_ring_flash_local`` with
    its custom VJP, cxxnet_tpu/parallel/ring.py:258-384). Grouped K/V are
    read in place by the kernels and rotate nkv-sized; the dK/dV carries
    travel at query-head resolution."""

    @staticmethod
    def forward(ctx, q, k, v, ranks, causal, scale, window):
        out, lse = _ring_flash_fwd(q, k, v, ranks, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ranks, causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        return _ring_flash_bwd(q, k, v, out, lse, grad, *ctx.args) + (
            None, None, None, None)


class _ChunkFlash(torch.autograd.Function):
    """One ring step as a whole attention: a query chunk at global offset
    ``q_off`` against a K/V block holding the whole sequence (offset 0),
    forward and backward on the step kernels."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, causal, scale, window):
        kw = dict(causal=causal, scale=scale, window=window)
        b, h, sq, d = q.shape
        qr, kr, vr = _rows(q), _rows(k), _rows(v)
        bh = qr.shape[0]
        f32 = dict(dtype=torch.float32, device=q.device)
        m, l, acc = rf.fwd_step(
            qr, kr, vr, torch.full((bh, sq, 1), flash_attn.NEG_INF, **f32),
            torch.zeros((bh, sq, 1), **f32), torch.zeros((bh, sq, d), **f32),
            (q_off, 0), **kw)
        l_safe = l.clamp_min(1e-30)
        out = (acc / l_safe).to(q.dtype).reshape(b, h, sq, d)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l_safe))
        ctx.args = (q_off, kw)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        q_off, kw = ctx.args
        qr, kr, vr, dor = _rows(q), _rows(k), _rows(v), _rows(grad)
        delta = flash_attn.bwd_delta(_rows(out), dor)[..., None]
        bh, skv, d = qr.shape[0], kr.shape[1], qr.shape[2]
        dq = rf.dq_step(qr, kr, vr, dor, lse, delta,
                        torch.zeros(qr.shape, dtype=torch.float32,
                                    device=q.device), (q_off, 0), **kw)
        z = torch.zeros((bh, skv, d), dtype=torch.float32, device=q.device)
        dk, dv = rf.dkv_step(qr, kr, vr, dor, lse, delta, z,
                             torch.zeros_like(z), (q_off, 0), **kw)

        def back(x, like):
            b, h = like.shape[:2]
            return x.reshape(b, h, -1, *x.shape[1:]).sum(2).to(like.dtype)
        return (back(dq, q), back(dk, k), back(dv, v), None, None, None,
                None)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int, causal: bool = False,
                    scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Attention of a query chunk q (b, h, sq, d), whose first row sits at
    global position ``q_offset``, against the whole sequence's k/v
    (b, nkv, L, d): sequence parallelism inside a pipeline stage
    (cxxnet_tpu/layer/layers.py:1311-1333), where k/v are already whole on
    every sp rank. The ring-step kernels run it as one step whose K/V
    block is the whole sequence, where ``ring_flash.supports`` takes
    (sq, L, d); dense attention otherwise."""
    _check_heads(q, k, causal, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if rf.supports(q.shape[2], k.shape[2], q.shape[-1]):
        return _ChunkFlash.apply(q, k, v, int(q_offset), bool(causal),
                                 float(scale), int(window))
    return attention.attention_reference(q, k, v, causal=causal, scale=scale,
                                         window=window, q_offset=q_offset)


def _ring_chunk(q_c, k_cmp, v_cmp, m_c, l_c, acc_c, q_start: int,
                k_start: int, causal: bool, scale: float, window: int):
    """One query chunk against one K/V block: the online-softmax update of
    the dense ring, in q's dtype, with JAX's guards for rows whose scores
    are all masked (cxxnet_tpu/parallel/ring.py:205-228)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q_c, k_cmp) * scale
    if causal:
        qpos = q_start + torch.arange(q_c.shape[2],
                                      device=q_c.device)[:, None]
        kpos = k_start + torch.arange(k_cmp.shape[2],
                                      device=q_c.device)[None, :]
        keep = qpos >= kpos
        if window > 0:
            keep = keep & (qpos - kpos < window)
        s = s.masked_fill(~keep, float("-inf"))
    m_new = torch.maximum(m_c, s.amax(-1))
    alpha = torch.where(torch.isinf(m_c) & torch.isinf(m_new),
                        torch.zeros_like(m_c), torch.exp(m_c - m_new))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(torch.isinf(s) & (s < 0), torch.zeros_like(p), p)
    l_new = l_c * alpha + p.sum(-1)
    acc_new = acc_c * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                      v_cmp)
    return m_new, l_new, acc_new


def _dense_ring(q, k, v, ranks: _Ranks, causal: bool, scale: float,
                window: int, q_chunk: int) -> torch.Tensor:
    """The dense ring (JAX's ``_ring_attention_local``): n steps of K/V
    rotation through ring_shift, differentiable (its transpose carries the
    gradients home); per step each query chunk of at most q_chunk rows
    folds the block into its carry, a chunk wholly above the causal
    diagonal or older than the window skipped, each chunk recomputed in the
    backward rather than kept."""
    qs = ranks.split(q)
    n = ranks.n
    # the K/V blocks of every step, rotated through the ring once
    kbs, vbs = ranks.blocks(ranks.split(k)), ranks.blocks(ranks.split(v))
    b, h, sq, d = qs[0].shape
    skv, groups = kbs[0][0].shape[2], h // kbs[0][0].shape[1]
    qc = min(sq, q_chunk if q_chunk > 0 else RING_Q_CHUNK)
    while sq % qc != 0:     # largest divisor <= the requested chunk
        qc -= 1
    like = dict(dtype=q.dtype, device=q.device)
    carry = [[(torch.full((b, h, qc), float("-inf"), **like),
               torch.zeros((b, h, qc), **like),
               torch.zeros((b, h, qc, d), **like))
              for _ in range(sq // qc)] for _ in qs]
    for t in range(n):
        for i, idx in enumerate(ranks.idx):
            k_start = ((idx - t) % n) * skv
            # GQA: the kv heads reach the query heads for this step only;
            # the ring hop stays nkv-sized
            k_cmp = kbs[t][i].repeat_interleave(groups, 1) if groups > 1 \
                else kbs[t][i]
            v_cmp = vbs[t][i].repeat_interleave(groups, 1) if groups > 1 \
                else vbs[t][i]
            for c in range(sq // qc):
                q_start = idx * sq + c * qc
                if causal and not (
                        k_start <= q_start + qc - 1 and
                        (window <= 0 or
                         q_start - (k_start + skv - 1) < window)):
                    continue
                carry[i][c] = checkpoint(
                    _ring_chunk, qs[i][:, :, c * qc:(c + 1) * qc], k_cmp,
                    v_cmp, *carry[i][c], q_start, k_start, causal, scale,
                    window, use_reentrant=False)
    return ranks.join([
        torch.cat([acc / l.clamp_min(1e-30)[..., None]
                   for _, l, acc in chunks], 2) for chunks in carry])


def _check_heads(q, k, causal: bool, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or q.shape[1] % k.shape[1] != 0:
        raise ValueError("sequence-parallel attention takes q (b, h, L, d) "
                         "and k/v (b, nkv, L, d) with nkv | h; got q %s "
                         "k %s" % (tuple(q.shape), tuple(k.shape)))
    if window < 0 or (window > 0 and not causal):
        raise ValueError("window attention requires causal")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   n: Optional[int] = None, group=None, causal: bool = False,
                   scale: Optional[float] = None, window: int = 0,
                   q_chunk: int = 0) -> torch.Tensor:
    """Ring attention over sequence shards (JAX's ``ring_attention``,
    cxxnet_tpu/parallel/ring.py:407). q (b, h, L, d), k/v (b, nkv, L, d)
    with nkv | h: with ``n``, the full tensors, run as n virtual ranks;
    with ``group``, this rank's shards. The step kernels (or, for CPU
    tensors, their plain versions) where ``ring_flash.supports`` takes the
    shard shape, the dense ring otherwise; ``q_chunk`` caps the dense
    ring's live score tile (default RING_Q_CHUNK)."""
    ranks = _Ranks(n, group)
    _check_heads(q, k, causal, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    local = ranks.split(q)[0].shape[2], ranks.split(k)[0].shape[2]
    if rf.supports(*local, q.shape[-1]):
        return _RingFlash.apply(q, k, v, ranks, bool(causal), float(scale),
                                int(window))
    return _dense_ring(q, k, v, ranks, bool(causal), float(scale),
                       int(window), q_chunk)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      n: Optional[int] = None, group=None,
                      causal: bool = False, scale: Optional[float] = None,
                      window: int = 0) -> torch.Tensor:
    """Ulysses sequence parallelism (JAX's ``ulysses_attention``,
    cxxnet_tpu/parallel/ring.py:467): all-to-all from sequence shards to
    head shards, attention over whole sequences of the rank's heads (the
    flash kernels where flash_attn.supports takes the shape, dense
    attention otherwise), all-to-all back. Heads and kv heads must divide
    by the rank count. Ranks as in ring_attention."""
    ranks = _Ranks(n, group)
    _check_heads(q, k, causal, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.shape[1] % ranks.n != 0:
        raise ValueError("ulysses needs heads (%d) divisible by sp axis (%d)"
                         % (q.shape[1], ranks.n))
    if k.shape[1] % ranks.n != 0:
        raise ValueError("ulysses needs kv heads (%d) divisible by sp axis "
                         "(%d); broadcast k/v to the query heads first"
                         % (k.shape[1], ranks.n))
    # (b, h, L/n, d) -> (b, h/n, L, d): split heads, gather the sequence
    qh, kh, vh = (ranks.all_to_all(ranks.split(t), 1, 2) for t in (q, k, v))
    outs = []
    for a, b_, c in zip(qh, kh, vh):
        L, d = a.shape[2], a.shape[3]
        if flash_attn.supports(L, d):
            outs.append(flash_attn.flash_attention(
                a, b_, c, causal=causal, scale=scale, window=window))
        else:
            outs.append(attention.attention_reference(
                a, b_, c, causal=causal, scale=scale, window=window))
    return ranks.join(ranks.all_to_all(outs, 2, 1))
