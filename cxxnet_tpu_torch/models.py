"""Model configs of the port, as netconfig text: the counterpart of the
transformer LM builders of cxxnet_tpu/models.py:346-442, and the RReLU
form of an image config.

``transformer_lm_netconfig`` writes the same text as the JAX package's
builder of that name, so a model built from it has the same layers, names
and parameter layout in both packages. ``transformer_lm_config`` is the
config-text counterpart of the JAX package's ``transformer_lm_trainer``:
the whole config (net, input shape, batch, labels, Adam), for
``api.Net(cfg=...)``. The full-width LM that ``bench.py`` measures is
``transformer_lm_config(vocab=8192, seq=2048, dim=512, nhead=8,
nlayer=4)``.

``rrelu_config`` turns an image config into its RReLU form (Xu, Wang,
Chen and Li, "Empirical evaluation of rectified activations in
convolutional network", arXiv:1505.00853): every ``relu`` layer becomes
``insanity`` (slopes drawn from U[lb, ub]) and every ``max_pooling``
layer ``insanity_max_pooling``.
"""

from __future__ import annotations

import re
from typing import Tuple


def _transformer_block(p: str, node_in: str, dim: int, nhead: int,
                       ffn: int, attn_keys: str = "") -> Tuple[str, str]:
    """One transformer block (no norm): out = x + att(x), then
    + ffn(.) with a 1x1-conv FFN. ``attn_keys`` are extra per-attention
    config lines (causal/rope/GQA/window). Returns (text, output node)."""
    txt = """layer[%(in)s->%(p)satt] = attention:%(p)s_att
  nhead = %(nh)d
  init_sigma = 0.05
%(ak)slayer[%(in)s,%(p)satt->%(p)sres1] = add
""" % {"in": node_in, "p": p, "nh": nhead,
       "ak": "".join("  %s\n" % ln.strip()
                     for ln in attn_keys.splitlines() if ln.strip())}
    txt += """layer[%(p)sres1->%(p)sf1] = conv:%(p)s_ffn1
  kernel_size = 1
  nchannel = %(ffn)d
  init_sigma = 0.05
layer[%(p)sf1->%(p)sr] = relu
layer[%(p)sr->%(p)sf2] = conv:%(p)s_ffn2
  kernel_size = 1
  nchannel = %(dim)d
  init_sigma = 0.05
layer[%(p)sres1,%(p)sf2->%(p)sout] = add
""" % {"p": p, "ffn": ffn, "dim": dim}
    return txt, p + "out"


def transformer_lm_netconfig(vocab: int, dim: int = 64, nhead: int = 4,
                             nlayer: int = 2, ffn_mult: int = 2,
                             attn_extra: str = "") -> str:
    """Decoder-only transformer LM: embed (learned positions) -> n x
    [causal attention + residual, 1x1-conv FFN + residual] -> vocab head
    -> per-position softmax (seq = 1). ``attn_extra``: extra keys of every
    attention layer (e.g. "nkvhead = 2\\nattn_window = 1024\\nrope = 1\\n"
    for the grouped-query sliding-window recipe)."""
    txt = """
netconfig = start
layer[+1:emb] = embed:emb
  vocab_size = %d
  nhidden = %d
  pos_embed = 1
  init_sigma = 0.05
""" % (vocab, dim)
    node = "emb"
    for i in range(nlayer):
        blk, node = _transformer_block(
            "blk%d" % i, node, dim, nhead, ffn_mult * dim,
            attn_keys="causal = 1\n" + attn_extra)
        txt += "\n" + blk
    txt += """
layer[%s->logits] = conv:head
  kernel_size = 1
  nchannel = %d
  init_sigma = 0.05
layer[+0] = softmax
  seq = 1
netconfig = end
""" % (node, vocab)
    return txt


def transformer_lm_config(vocab: int = 50, seq: int = 16,
                          batch_size: int = 8, dim: int = 64,
                          nhead: int = 4, nlayer: int = 2,
                          dev: str = "gpu", extra_cfg: str = "",
                          attn_extra: str = "") -> str:
    """The whole config of ``transformer_lm_trainer`` (cxxnet_tpu/models.py
    :427-442) as text: the net, ``input_shape = 1,1,seq``, the batch size,
    one label per position, Adam at eta 0.003, the device."""
    return (transformer_lm_netconfig(vocab, dim=dim, nhead=nhead,
                                     nlayer=nlayer, attn_extra=attn_extra) +
            "input_shape = 1,1,%d\n" % seq +
            "batch_size = %d\n" % batch_size +
            "label_vec[0,%d) = label\n" % seq +
            "updater = adam\neta = 0.003\n" +
            "dev = %s\n" % dev + extra_cfg)


def _retype(text: str, kind: str, new: str, keys) -> str:
    """``text`` with every layer of type ``kind`` made ``new``, the config
    lines ``keys`` added under it; its name and other keys unchanged."""
    pat = re.compile(r"^(layer\[[^\]]*\]\s*=\s*)%s(\s*:\S+)?[ \t]*$" % kind,
                     re.M)
    return pat.sub(lambda m: m.group(1) + new + (m.group(2) or "") +
                   "".join("\n  " + k for k in keys), text)


def rrelu_config(text: str, lb: float = 3.0, ub: float = 8.0,
                 keep: float = 0.75) -> str:
    """``text`` with every ``relu`` layer made ``insanity`` with slopes
    drawn from U[lb, ub] (3 and 8 are the paper's range) and every
    ``max_pooling`` layer made ``insanity_max_pooling`` keeping a pixel in
    place with probability ``keep`` (0.75 displaces a pixel each way with
    probability 1/16; the value is not the paper's)."""
    text = _retype(text, "relu", "insanity", ("lb = %g" % lb, "ub = %g" % ub))
    return _retype(text, "max_pooling", "insanity_max_pooling",
                   ("keep = %g" % keep,))
