"""The port's own account of a program's work: FLOPs and bytes from the
net's layer graph and node shapes, the counterpart of what XLA's
``cost_analysis()`` gives the JAX package's performance ledger
(cxxnet_tpu/utils/perf.py). No program runs twice and no profiler runs:
the count is arithmetic over shapes, so it stays the same whatever
implements a layer.

What is counted:

* **matmul-class FLOPs**, as ``tools/roofline.py``'s
  ``net_flops_per_sample`` counts them (2 x multiply-adds): fullc
  2·b·nout·nin; the attention projections 2·b·L·prod(w) per weight; embed
  0; a shared layer once per application. One departure: a convolution
  counts only the taps that land inside its input (``conv_taps``), the
  rule of XLA's count (a 5x5 pad-2 conv on 27x27 counts 0.9131 of the
  padded count, a 3x3 pad-1 conv on 13x13 0.9001), where roofline.py
  counts every tap of the padded input.
* **attention scores and AV** at the mask's exact kept pairs
  (``ops.flash_attn.kept_pairs``), where roofline.py halves a causal L²;
  the forward and backward of a whole sequence are the flash kernels'
  own counts (``ops.flash_attn.work`` / ``bwd_work``), so the ledger and
  the kernel table count the same work. A KV-cached forward counts the
  pairs its rows keep at their positions.
* **elementwise passes** per element (``_EW``: relu, pooling windows,
  softmax, dropout, bias adds, ...), the LRN layers by their kernels'
  ``ops.lrn.work`` / ``bwd_work`` and the noisy layers' draws by
  ``ops.random.work``. Where XLA's count of the JAX layer's own ops was
  measured, the rule is that count: relu's backward is ``max``'s
  derivative (5 operations an element), batch-norm's backward 15 an
  element, and a sum or avg pool's backward its window's taps for each
  input element (the window sum transposed over the input grid).
* **the rest of the layer set**: ``fixconn`` as fullc without a weight
  gradient; ``moe`` as its products, 2·b·E·din·dout for the experts,
  2·b·E·din for the gate and 2·b·E·dout for the combine, each again for
  the data and the weight gradients (the combine's second product is the
  gate's gradient), plus the relu of every expert output and the gate's
  softmax; ``maxout`` one comparison per input element each way; the
  losses, tanh, softplus and bias elementwise; im2seq none.
* **a training step**: the forward, every weight gradient and every data
  gradient except into the data nodes (each the forward's count: the
  data and weight gradients of a convolution touch the same in-bounds
  taps), the elementwise backward passes, and the updater's per-parameter
  arithmetic (``UPDATER_OPS``).

Bytes: the parameters read (in training also their gradients written and
read, the updater's state read and written and the parameters written),
plus each layer's input and output nodes once per pass (forward; and
backward in training); a KV-cached attention adds the cache rows its
queries read and the rows it writes. Results are ``{"flops", "bytes
accessed"}`` dicts, the keys of XLA's cost analysis.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..ops import flash_attn, lrn, random as oprandom

__all__ = ["conv_taps", "UPDATER_OPS", "UPDATER_STATE", "layer_work",
           "forward_cost", "train_step_cost", "decode_loop_cost",
           "admit_cost"]

# per-element (forward, backward) operations of the elementwise layers; a
# pooling layer's count is per output element and per window tap
_EW = {
    "relu": (1, 5), "sigmoid": (4, 3), "xelu": (2, 2), "insanity": (3, 2),
    "prelu": (2, 3), "dropout": (2, 1), "softmax": (4, 1),
    "batch_norm": (8, 15), "flatten": (0, 0), "concat": (0, 0),
    "ch_concat": (0, 0), "split": (0, 0), "add": (0, 0), "embed": (0, 0),
    "im2seq": (0, 0), "tanh": (1, 3), "softplus": (4, 4), "bias": (1, 1),
    "l2_loss": (3, 1), "multi_logistic": (10, 3),
}
_POOL = {"max_pooling": 0, "sum_pooling": 0, "avg_pooling": 0,
         "relu_max_pooling": 1, "insanity_max_pooling": 2}
# batch-norm's forward per element at eval with its running statistics
_BN_EVAL_MOVING = 4
# pools whose backward is the window sum transposed: taps per input element
_WINDOW_SUM = ("sum_pooling", "avg_pooling")
# operations per parameter of one update, and the f32 state tensors each
# parameter carries (read and written every update)
UPDATER_OPS = {"sgd": 6, "nag": 9, "adam": 12, "adamw": 14}
UPDATER_STATE = {"sgd": 1, "nag": 1, "adam": 2, "adamw": 2}


def conv_taps(size: int, k: int, stride: int, pad: int, out: int) -> int:
    """Over one axis, the (output position, tap) pairs whose input position
    lies inside the input: sum over outputs o of the taps t with
    0 <= o*stride - pad + t < size."""
    n = 0
    for o in range(out):
        start = o * stride - pad
        n += max(0, min(k, size - start) - max(0, -start))
    return n


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _esize(dtype: Optional[torch.dtype]) -> int:
    return 4 if dtype is None else torch.empty((), dtype=dtype).element_size()


def _attention(lay, shape, b: int, q_offs: Optional[Sequence[int]],
               esize: int, train: bool) -> Dict[str, float]:
    """The attention layer's work on an input node of ``shape`` (batch
    replaced by b): projections, scores and AV at the kept pairs; with
    ``q_offs`` (a KV-cached forward: each row's position of its first
    query) the pairs and cache rows of those positions."""
    _, d, _, L = shape
    h = lay.nhead
    nkv = lay.nkvhead or h
    dh = d // h
    kvw = nkv * dh
    causal, window = bool(lay.causal), int(lay.attn_window)
    # wqkv (d, d + 2 kvw) and wo (d, d), applied per position
    proj = 2.0 * b * L * d * (d + 2 * kvw) + 2.0 * b * L * d * d
    out = {"fwd": proj, "dgrad": proj, "wgrad": proj, "ew_fwd": 0.0,
           "ew_bwd": 0.0, "bytes": 0.0}
    if lay.rope:
        # rotation of every q and k element: 2 products and an add
        out["ew_fwd"] += 3.0 * b * L * (d + kvw)
        out["ew_bwd"] += 3.0 * b * L * (d + kvw)
    if q_offs is None:
        ops, nbytes = flash_attn.work(b, h, nkv, L, dh, causal, window, esize)
        out["ew_fwd"] += ops
        out["bytes"] += nbytes
        if train:
            (dq, dqb), (dkv, dkvb) = flash_attn.bwd_work(
                b, h, nkv, L, dh, causal, window, esize)
            out["ew_bwd"] += dq + dkv
            out["bytes"] += dqb + dkvb
        return out
    pairs = keys = 0
    for q in q_offs:
        pairs += flash_attn.kept_pairs(L, causal, window, skv=q + L, q_off=q)
        span = q + L if not (causal and window) else min(q + L,
                                                         window + L - 1)
        keys += span
    out["ew_fwd"] += 4.0 * dh * h * pairs
    # q read and out written; the k/v cache rows the queries read; the new
    # rows' k and v written
    out["bytes"] += esize * (2.0 * b * h * L * dh + 2.0 * nkv * dh * keys
                             + 2.0 * nkv * dh * b * L)
    return out


def layer_work(net, i: int, b: int, train: bool = False,
               q_offs: Optional[Sequence[int]] = None,
               node_esize: Optional[int] = None) -> Dict[str, float]:
    """One connection's work at batch b: ``fwd`` / ``dgrad`` / ``wgrad``
    (matmul-class FLOPs), ``ew_fwd`` / ``ew_bwd`` (elementwise, kernels and
    attention cores included) and ``bytes`` of its kernels beyond its
    nodes (the attention core)."""
    info = net.cfg.layers[i]
    lay = net.layers[i]
    tname = lay.type_name
    esize = node_esize or _esize(net.compute_dtype)
    ins = [(b,) + tuple(net.node_shapes[j][1:]) for j in info.nindex_in]
    outs = [(b,) + tuple(net.node_shapes[j][1:]) for j in info.nindex_out]
    n_in = sum(_numel(s) for s in ins)
    n_out = sum(_numel(s) for s in outs)
    w = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0, "ew_fwd": 0.0,
         "ew_bwd": 0.0, "bytes": 0.0}
    p = getattr(lay, "param", None)
    if tname == "conv":
        _, c, hh, ww = ins[0]
        _, co, oh, ow = outs[0]
        taps = conv_taps(hh, p.kernel_height, p.stride, p.pad_y, oh) \
            * conv_taps(ww, p.kernel_width, p.stride, p.pad_x, ow)
        f = 2.0 * b * co * (c // p.num_group) * taps
        w.update(fwd=f, dgrad=f, wgrad=f)
        if p.no_bias == 0:
            w["ew_fwd"] += n_out
            w["ew_bwd"] += n_out
    elif tname == "fullc":
        f = 2.0 * b * p.num_hidden * p.num_input_node
        w.update(fwd=f, dgrad=f, wgrad=f)
        if p.no_bias == 0:
            w["ew_fwd"] += n_out
            w["ew_bwd"] += n_out
    elif tname == "fixconn":
        f = 2.0 * b * p.num_hidden * ins[0][3]
        w.update(fwd=f, dgrad=f)
    elif tname == "moe":
        e, din, dout = lay.n_expert, p.num_input_node, p.num_hidden
        f = 2.0 * b * e * (din * dout + din + dout)
        w.update(fwd=f, dgrad=f, wgrad=f)
        w["ew_fwd"] += b * e * (dout + _EW["softmax"][0])
        w["ew_bwd"] += b * e * (_EW["relu"][1] * dout + _EW["softmax"][1])
    elif tname == "maxout":
        w["ew_fwd"] += n_in
        w["ew_bwd"] += n_in
    elif tname == "attention":
        return _attention(lay, ins[0], b, q_offs, esize, train)
    elif tname == "lrn":
        ops, _ = lrn.work(n_in, esize, with_norm=train)
        w["ew_fwd"] += ops
        if train:
            w["ew_bwd"] += lrn.bwd_work(n_in, esize)[0]
    elif tname in _POOL:
        kk = p.kernel_height * p.kernel_width
        extra = _POOL[tname]
        w["ew_fwd"] += (kk + extra) * n_out
        w["ew_bwd"] += kk * n_in if tname in _WINDOW_SUM \
            else (kk + extra) * n_out
        if tname == "insanity_max_pooling" and train:
            w["ew_fwd"] += oprandom.work(n_in)[0]
    else:
        fw, bw = _EW.get(tname, (1, 1))
        if tname == "batch_norm" and lay.moving_average and not train:
            # the running statistics in place of the batch's: the
            # normalization alone
            fw = _BN_EVAL_MOVING
        w["ew_fwd"] += fw * n_out
        w["ew_bwd"] += bw * n_out
        if tname == "add":
            w["ew_fwd"] += (len(ins) - 1) * n_out
        elif tname == "split":
            w["ew_bwd"] += (len(outs) - 1) * n_in
        elif tname == "embed":
            # the gathered rows (and positions) out; their gradient is a
            # scatter-add of as many elements
            w["ew_fwd"] += n_out if getattr(lay, "pos_embed", 0) else 0
            w["ew_bwd"] += n_out
        elif tname == "insanity" and train:
            w["ew_fwd"] += oprandom.work(n_in)[0]
    return w


def _node_bytes(net, i: int, b: int, esize: int) -> float:
    info = net.cfg.layers[i]
    return float(esize) * sum(_numel((b,) + tuple(net.node_shapes[j][1:]))
                              for j in list(info.nindex_in)
                              + list(info.nindex_out))


def _param_bytes(net, params, b: int, L: Optional[int] = None,
                 esize: Optional[int] = None) -> float:
    """Bytes of the parameters a forward reads: every tensor once (in its
    own dtype unless ``esize`` says otherwise), an embedding table only
    the rows it gathers."""
    total = 0.0
    for i, p in enumerate(params):
        if net.is_shared[i] or not p:
            continue
        lay = net.layers[i]
        for k, t in p.items():
            es = esize or t.element_size()
            if lay.type_name == "embed":
                d = t.shape[1]
                seq = L if L is not None else \
                    net.node_shapes[net.cfg.layers[i].nindex_in[0]][3]
                rows = b * seq if k == "wmat" else seq
                total += float(es) * rows * d
            else:
                total += float(es) * t.numel()
    return total


def _data_nodes(net) -> int:
    return 1 + int(net.cfg.param.extra_data_num)


def forward_cost(net, params, b: Optional[int] = None,
                 q_offs: Optional[Sequence[int]] = None,
                 param_esize: Optional[int] = None,
                 extra_flops: float = 0.0) -> Dict[str, float]:
    """A forward (predict, eval, a prefill or one decode step) of ``net``
    over ``b`` rows (the net's batch by default); ``q_offs``: each row's
    position for a KV-cached forward; ``param_esize``: the bytes of an
    element of the weights read (their own dtype by default)."""
    b = net.max_batch if b is None else int(b)
    esize = _esize(net.compute_dtype)
    flops = float(extra_flops)
    nbytes = _param_bytes(net, params, b, esize=param_esize)
    for i in range(len(net.layers)):
        w = layer_work(net, i, b, train=False, q_offs=q_offs)
        flops += w["fwd"] + w["ew_fwd"]
        nbytes += w["bytes"] + _node_bytes(net, i, b, esize)
    return {"flops": flops, "bytes accessed": nbytes}


def train_step_cost(net, params, updaters: List[Dict],
                    b: Optional[int] = None,
                    do_update: bool = True) -> Dict[str, float]:
    """One training step: the forward, every weight gradient, every data
    gradient but those into the data nodes, the elementwise backward
    passes and (``do_update``) the updaters' per-parameter arithmetic."""
    b = net.max_batch if b is None else int(b)
    esize = _esize(net.compute_dtype)
    flops = nodes = kernel_bytes = 0.0
    data_nodes = _data_nodes(net)
    for i, info in enumerate(net.cfg.layers):
        w = layer_work(net, i, b, train=True)
        flops += w["fwd"] + w["ew_fwd"] + w["wgrad"] + w["ew_bwd"]
        if any(j >= data_nodes for j in info.nindex_in):
            flops += w["dgrad"]
        nodes += _node_bytes(net, i, b, esize)
        kernel_bytes += w["bytes"]
    read = _param_bytes(net, params, b)
    nparam = 0.0
    upd_bytes = 0.0
    for i, p in enumerate(params):
        for k, t in p.items():
            up = updaters[i].get(k) if i < len(updaters) else None
            if up is None or not t.is_floating_point():
                continue
            n = float(t.numel())
            nparam += n
            if do_update:
                flops += UPDATER_OPS.get(up.kind, 6) * n
                # the state read and written, the weight written
                upd_bytes += 4.0 * n * (2 * UPDATER_STATE.get(up.kind, 1)
                                        + 1)
    # gradients written by the backward and read by the update
    nbytes = read + 8.0 * nparam + upd_bytes + 2.0 * nodes + kernel_bytes
    return {"flops": flops, "bytes accessed": nbytes}


def decode_loop_cost(net, params, b: int, positions: Sequence[int],
                     param_esize: Optional[int] = None) -> Dict[str, float]:
    """The solo decode loop: one one-token forward of ``net`` (the batch-b,
    length-1 net) at each position of ``positions``, every row there."""
    flops = nbytes = 0.0
    for t in positions:
        c = forward_cost(net, params, b, q_offs=[int(t)] * b,
                         param_esize=param_esize)
        flops += c["flops"]
        nbytes += c["bytes accessed"]
    return {"flops": flops, "bytes accessed": nbytes}


def admit_cost(l_max: int, tables: int = 0) -> Dict[str, float]:
    """A session admission's scatter of one slot's row: its l_max int64
    tokens, its seed, position and state words (and a paged slot's block
    table of ``tables`` int64 ids) written; no arithmetic."""
    return {"flops": 0.0, "bytes accessed": 8.0 * (l_max + 3 + tables)}
