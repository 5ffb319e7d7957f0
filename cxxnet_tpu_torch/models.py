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

The image nets of the JAX package's benchmark have their builders here
too, each writing the same text as its JAX namesake
(cxxnet_tpu/models.py:192-345, 506-620, 623-700), so the same model files:
``googlenet_netconfig`` (with ``_gnet_inception`` and
``GOOGLENET_MODULES``), ``resnet_netconfig`` (with ``_res_block``) and
``vgg_netconfig``. ``googlenet_config``, ``resnet_config`` and
``vgg_config`` are the whole configs of the JAX ``googlenet_trainer``,
``resnet_trainer`` and ``vgg_trainer`` as text (their recipes' eta,
momentum and wd); bench.py runs each under ``compute_dtype = bfloat16``.

``rrelu_config`` turns an image config into its RReLU form (Xu, Wang,
Chen and Li, "Empirical evaluation of rectified activations in
convolutional network", arXiv:1505.00853): every ``relu`` layer becomes
``insanity`` (slopes drawn from U[lb, ub]) and every ``max_pooling``
layer ``insanity_max_pooling``.
"""

from __future__ import annotations

import re
from typing import Tuple

from .layer.base import check


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


def _gnet_inception(name: str, node_in: str,
                    c1: int, c3r: int, c3: int, c5r: int, c5: int,
                    cp: int) -> Tuple[str, str]:
    """One GoogLeNet (Inception-v1) module: 1x1 / 1x1->3x3 / 1x1->5x5 /
    3x3-pool->1x1 towers, channel-concatenated (Szegedy et al. 2014).
    Expressed purely in the netconfig DSL (split + ch_concat)."""
    p = name
    txt = f"""
layer[{node_in}->{p}a,{p}b,{p}c,{p}d] = split
layer[{p}a->{p}t1] = conv:{p}_1x1
  kernel_size = 1
  nchannel = {c1}
layer[{p}t1->{p}o1] = relu
layer[{p}b->{p}t3r] = conv:{p}_3x3r
  kernel_size = 1
  nchannel = {c3r}
layer[{p}t3r->{p}r3r] = relu
layer[{p}r3r->{p}t3] = conv:{p}_3x3
  kernel_size = 3
  pad = 1
  nchannel = {c3}
layer[{p}t3->{p}o3] = relu
layer[{p}c->{p}t5r] = conv:{p}_5x5r
  kernel_size = 1
  nchannel = {c5r}
layer[{p}t5r->{p}r5r] = relu
layer[{p}r5r->{p}t5] = conv:{p}_5x5
  kernel_size = 5
  pad = 2
  nchannel = {c5}
layer[{p}t5->{p}o5] = relu
layer[{p}d->{p}pp] = max_pooling
  kernel_size = 3
  stride = 1
  pad = 1
layer[{p}pp->{p}tp] = conv:{p}_proj
  kernel_size = 1
  nchannel = {cp}
layer[{p}tp->{p}op] = relu
layer[{p}o1,{p}o3,{p}o5,{p}op->{p}out] = ch_concat
"""
    return txt, p + "out"


# (c1, c3r, c3, c5r, c5, pool_proj) per module — the paper's Table 1
GOOGLENET_MODULES = {
    "i3a": (64, 96, 128, 16, 32, 32),
    "i3b": (128, 128, 192, 32, 96, 64),
    "i4a": (192, 96, 208, 16, 48, 64),
    "i4b": (160, 112, 224, 24, 64, 64),
    "i4c": (128, 128, 256, 24, 64, 64),
    "i4d": (112, 144, 288, 32, 64, 64),
    "i4e": (256, 160, 320, 32, 128, 128),
    "i5a": (256, 160, 320, 32, 128, 128),
    "i5b": (384, 192, 384, 48, 128, 128),
}


def googlenet_netconfig(n_class: int = 1000, final_pool: int = 7) -> str:
    """GoogLeNet / Inception-v1 (Szegedy et al. 2014; the JAX package's
    benchmark config): stem, 9 inception modules with maxpools between
    stages, global avg-pool head; both LRNs run the LRN kernels on a
    card."""
    txt = """
netconfig=start
layer[0->n1] = conv:conv1
  kernel_size = 7
  stride = 2
  pad = 3
  nchannel = 64
layer[n1->n2] = relu
layer[n2->n3] = max_pooling
  kernel_size = 3
  stride = 2
layer[n3->n4] = lrn
  local_size = 5
  alpha = 0.0001
  beta = 0.75
  knorm = 1
layer[n4->n5] = conv:conv2r
  kernel_size = 1
  nchannel = 64
layer[n5->n6] = relu
layer[n6->n7] = conv:conv2
  kernel_size = 3
  pad = 1
  nchannel = 192
layer[n7->n8] = relu
layer[n8->n9] = lrn
  local_size = 5
  alpha = 0.0001
  beta = 0.75
  knorm = 1
layer[n9->n10] = max_pooling
  kernel_size = 3
  stride = 2
"""
    node = "n10"
    for mod in ("i3a", "i3b"):
        blk, node = _gnet_inception(mod, node, *GOOGLENET_MODULES[mod])
        txt += blk
    txt += """
layer[%s->p3] = max_pooling
  kernel_size = 3
  stride = 2
""" % node
    node = "p3"
    for mod in ("i4a", "i4b", "i4c", "i4d", "i4e"):
        blk, node = _gnet_inception(mod, node, *GOOGLENET_MODULES[mod])
        txt += blk
    txt += """
layer[%s->p4] = max_pooling
  kernel_size = 3
  stride = 2
""" % node
    node = "p4"
    for mod in ("i5a", "i5b"):
        blk, node = _gnet_inception(mod, node, *GOOGLENET_MODULES[mod])
        txt += blk
    txt += """
layer[%(node)s->gp] = avg_pooling
  kernel_size = %(fp)d
  stride = %(fp)d
layer[gp->fl] = flatten
layer[fl->fd] = dropout
  threshold = 0.4
layer[fd->out] = fullc:loss_fc
  nhidden = %(ncls)d
layer[+0] = softmax
netconfig=end
random_type = xavier
metric = error
""" % {"node": node, "fp": final_pool, "ncls": n_class}
    return txt


def _res_block(idx: int, node_in: str, nch: int, stride: int = 1,
               project: bool = False) -> Tuple[str, str]:
    """Basic residual block (two 3x3 convs + batch_norm, identity or
    1x1-projection shortcut, post-add relu), expressed in the layer DSL —
    beyond the reference's era (it ships concat but no residual nets); the
    `add` layer makes the family expressible."""
    p = "rb%d" % idx
    main_in = "%s_s0" % p
    short_in = "%s_s1" % p
    txt = "layer[%s->%s,%s] = split\n" % (node_in, main_in, short_in)
    txt += """layer[{mi}->{p}_c1] = conv:{p}_c1
  kernel_size = 3
  pad = 1
  stride = {stride}
  nchannel = {nch}
  random_type = kaiming
  no_bias = 1
layer[{p}_c1->{p}_b1] = batch_norm:{p}_b1
layer[{p}_b1->{p}_r1] = relu
layer[{p}_r1->{p}_c2] = conv:{p}_c2
  kernel_size = 3
  pad = 1
  nchannel = {nch}
  random_type = kaiming
  no_bias = 1
layer[{p}_c2->{p}_b2] = batch_norm:{p}_b2
""".format(p=p, mi=main_in, nch=nch, stride=stride)
    if project:
        txt += """layer[{si}->{p}_sc] = conv:{p}_sc
  kernel_size = 1
  stride = {stride}
  nchannel = {nch}
  random_type = kaiming
  no_bias = 1
layer[{p}_sc->{p}_sb] = batch_norm:{p}_sb
layer[{p}_b2,{p}_sb->{p}_add] = add
""".format(p=p, si=short_in, nch=nch, stride=stride)
    else:
        txt += "layer[%s_b2,%s->%s_add] = add\n" % (p, short_in, p)
    txt += "layer[%s_add->%s_out] = relu\n" % (p, p)
    return txt, "%s_out" % p


def resnet_netconfig(depths=(2, 2, 2, 2), base_ch: int = 64,
                     n_class: int = 1000, final_pool: int = 7) -> str:
    """ResNet-18-shaped netconfig (depths=(2,2,2,2)); shrink depths/base_ch
    for tests."""
    txt = "netconfig = start\n"
    txt += """layer[0->stem] = conv:stem
  kernel_size = 7
  pad = 3
  stride = 2
  nchannel = %d
  random_type = kaiming
  no_bias = 1
layer[stem->stem_b] = batch_norm:stem_b
layer[stem_b->stem_r] = relu
layer[stem_r->stem_p] = max_pooling
  kernel_size = 3
  stride = 2
""" % base_ch
    node = "stem_p"
    idx = 0
    for stage, n_blocks in enumerate(depths):
        nch = base_ch * (2 ** stage)
        for b in range(n_blocks):
            first = (b == 0 and stage > 0)
            blk, node = _res_block(idx, node, nch,
                                   stride=2 if first else 1,
                                   project=first)
            txt += blk
            idx += 1
    txt += """layer[%s->gap] = avg_pooling
  kernel_size = %d
  stride = %d
layer[gap->flat] = flatten
layer[flat->fc] = fullc:fc
  nhidden = %d
  random_type = kaiming
layer[fc->fc] = softmax
netconfig = end
""" % (node, final_pool, final_pool, n_class)
    return txt


# VGG (Simonyan & Zisserman 2014) — contemporary of the reference's era;
# deep uniform 3x3 stacks, the natural customer of `remat = 1` (13 conv
# activations at 224x224 otherwise dominate device memory)
VGG_STAGES = {
    "vgg11": ((64,), (128,), (256, 256), (512, 512), (512, 512)),
    "vgg16": ((64, 64), (128, 128), (256, 256, 256),
              (512, 512, 512), (512, 512, 512)),
}


def vgg_netconfig(arch: str = "vgg16", n_class: int = 1000,
                  fc_dim: int = 4096, remat: int = 0,
                  dropout: float = 0.5) -> str:
    """VGG in the layer DSL: 5 stages of 3x3/pad-1 conv+relu stacks, each
    followed by a 2x2/stride-2 max pool, then fc-relu-dropout x2 and the
    classifier head."""
    txt = "netconfig=start\n"
    if remat:
        txt += "remat = 1\n"
    node = "0"
    for s, widths in enumerate(VGG_STAGES[arch]):
        for c, width in enumerate(widths):
            name = "conv%d_%d" % (s + 1, c + 1)
            txt += """layer[%s->%s] = conv:%s
  kernel_size = 3
  pad = 1
  nchannel = %d
layer[%s->%sr] = relu
""" % (node, name, name, width, name, name)
            node = name + "r"
        txt += """layer[%s->pool%d] = max_pooling
  kernel_size = 2
  stride = 2
""" % (node, s + 1)
        node = "pool%d" % (s + 1)
    txt += "layer[%s->fl] = flatten\n" % node
    node = "fl"
    for i in (6, 7):
        txt += """layer[%s->fc%d] = fullc:fc%d
  nhidden = %d
layer[fc%d->fc%dr] = relu
layer[fc%dr->fc%dr] = dropout
  threshold = %g
""" % (node, i, i, fc_dim, i, i, i, i, dropout)
        node = "fc%dr" % i
    txt += """layer[%s->out] = fullc:head
  nhidden = %d
layer[+0] = softmax
netconfig=end
random_type = kaiming
metric = error
""" % (node, n_class)
    return txt




def _image_config(netconfig: str, input_hw: int, batch_size: int,
                  recipe: str, dev: str, extra_cfg: str) -> str:
    return (netconfig + "input_shape = 3,%d,%d\n" % (input_hw, input_hw) +
            "batch_size = %d\n" % batch_size + recipe +
            "dev = %s\n" % dev + extra_cfg)


def googlenet_config(batch_size: int = 128, input_hw: int = 224,
                     dev: str = "gpu", n_class: int = 1000,
                     extra_cfg: str = "") -> str:
    """The config of the JAX ``googlenet_trainer`` (the ImageNet recipe at
    224x224; input_hw >= 32, the final avg-pool adapts)."""
    check(input_hw >= 32, "googlenet needs input_hw >= 32")
    net = googlenet_netconfig(n_class=n_class,
                              final_pool=max(input_hw // 32, 1))
    return _image_config(net, input_hw, batch_size,
                         "eta = 0.01\nmomentum = 0.9\nwd = 0.0002\n", dev,
                         extra_cfg)


def resnet_config(batch_size: int = 128, input_hw: int = 224,
                  dev: str = "gpu", n_class: int = 1000,
                  extra_cfg: str = "") -> str:
    """The config of the JAX ``resnet_trainer`` at ResNet-18's depths
    (shrink input_hw for tests)."""
    # stem 2 x pool 2 x one stride 2 in each of the 3 later stages
    net = resnet_netconfig(n_class=n_class,
                           final_pool=max(input_hw // 32, 1))
    return _image_config(net, input_hw, batch_size,
                         "eta = 0.1\nmomentum = 0.9\nwd = 0.0001\n", dev,
                         extra_cfg)


def vgg_config(batch_size: int = 64, input_hw: int = 224, dev: str = "gpu",
               n_class: int = 1000, arch: str = "vgg16", fc_dim: int = 4096,
               remat: int = 0, dropout: float = 0.5,
               extra_cfg: str = "") -> str:
    """The config of the JAX ``vgg_trainer`` (the paper's recipe;
    input_hw a multiple of 32 to survive the 5 pools)."""
    check(input_hw % 32 == 0, "VGG needs input divisible by 32")
    net = vgg_netconfig(arch, n_class, fc_dim=fc_dim, remat=remat,
                        dropout=dropout)
    return _image_config(net, input_hw, batch_size,
                         "eta = 0.01\nmomentum = 0.9\nwd = 0.0005\n", dev,
                         extra_cfg)
