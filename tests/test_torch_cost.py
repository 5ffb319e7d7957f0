"""The port's work account (cxxnet_tpu_torch/nnet/cost.py) on the CPU,
against the JAX package's counts: the matmul-class FLOPs of fullc layers,
1x1 convolutions and attention projections equal tools/roofline.py's
``net_flops_per_sample`` exactly; every convolution of ImageNet.conf
counts, forward, data gradient and weight gradient, what XLA's
``cost_analysis()`` counts for that convolution alone (the taps inside
the input); the whole ImageNet.conf program at batch 2 is within 1% of
XLA's count for predict and within 2% for the training step (XLA counts
its own elementwise passes and updater arithmetic, which the account
counts by rule); and each kernel's ``work()`` gives the count the chip
check used before the functions moved into the ops modules (the old
formulas are copied below as the reference)."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cxxnet_tpu import models as jmodels
from cxxnet_tpu_torch.nnet import cost
from cxxnet_tpu_torch.nnet.trainer import Trainer
from cxxnet_tpu_torch.ops import flash_attn, lrn, random as oprandom
from cxxnet_tpu_torch.ops import ring_flash
from cxxnet_tpu_torch.utils.config import parse_config_file
from cxxnet_tpu_torch.utils.config import parse_config_string

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import roofline  # noqa: E402

from .test_example_configs import build_from_conf  # noqa: E402

IMAGENET = os.path.join(REPO, "example", "ImageNet", "ImageNet.conf")
MNIST = os.path.join(REPO, "example", "MNIST", "MNIST.conf")


def _port_trainer(path, batch_size):
    """The port's trainer of a shipped conf, its iterator sections left
    out, on the CPU (the JAX helper build_from_conf's rule)."""
    pairs, in_section = [], False
    for k, v in parse_config_file(path):
        if k in ("data", "eval", "pred"):
            in_section = True
            continue
        if in_section:
            if k == "iter" and v == "end":
                in_section = False
            continue
        pairs.append((k, v))
    tr = Trainer()
    for k, v in pairs:
        if k in ("dev", "batch_size", "num_round", "max_round",
                 "save_model", "model_dir", "continue"):
            continue
        tr.set_param(k, v)
    tr.set_param("dev", "cpu")
    tr.set_param("batch_size", str(batch_size))
    tr.init_model()
    return tr


def _fwd_per_sample(tr):
    return sum(cost.layer_work(tr.net, i, 1)["fwd"]
               for i in range(len(tr.net.layers)))


def _xla_flops(fn, *args):
    c = jax.jit(fn).lower(*args).cost_analysis()
    c = c[0] if isinstance(c, (list, tuple)) else c
    return float(c["flops"])


@pytest.fixture(scope="module")
def imagenet():
    """(JAX trainer, port trainer) of ImageNet.conf at batch 2."""
    jtr, _ = build_from_conf(IMAGENET, batch_size=2)
    return jtr, _port_trainer(IMAGENET, 2)


# ----------------------------------------------------------------------
# the matmul-class count against tools/roofline.py
def test_fullc_flops_equal_roofline():
    jtr, _ = build_from_conf(MNIST, batch_size=4)
    tr = _port_trainer(MNIST, 4)
    assert _fwd_per_sample(tr) == roofline.net_flops_per_sample(jtr)


LM_VARIANTS = {
    "mha": "",
    "gqa_window_rope": "nkvhead = 2\nattn_window = 8\nrope = 1\n",
}


@pytest.mark.parametrize("variant", sorted(LM_VARIANTS))
def test_attention_projection_flops_equal_roofline(variant):
    """Projections, the FFN's 1x1 convolutions and the vocab head count
    what roofline.py counts; roofline.py's score+AV estimate (causal
    halves, which the account replaces by the exact kept pairs) is taken
    out of its total first."""
    kw = dict(vocab=40, seq=16, batch_size=2, dim=32, nhead=4, nlayer=2)
    jtr = jmodels.transformer_lm_trainer(
        dev="cpu", attn_extra=LM_VARIANTS[variant], **kw)
    from cxxnet_tpu_torch import models
    tr = Trainer()
    for k, v in parse_config_string(models.transformer_lm_config(
            dev="cpu", attn_extra=LM_VARIANTS[variant], **kw)):
        tr.set_param(k, v)
    tr.init_model()
    scores = 0.0
    for i, lay in enumerate(jtr.net.layers):
        if getattr(lay, "type_name", "") == "attention":
            _, d, _, L = jtr.net.node_shapes[jtr.net.cfg.layers[i]
                                             .nindex_in[0]]
            span = min(lay.attn_window or L, L)
            scores += (2.0 if lay.causal else 4.0) * L * span * d
    assert _fwd_per_sample(tr) == roofline.net_flops_per_sample(jtr) \
        - scores


def test_attention_scores_count_the_kept_pairs():
    """The score and AV work of a whole sequence is the flash forward's
    own count: 4 d per kept pair, per head."""
    from cxxnet_tpu_torch import models
    tr = Trainer()
    for k, v in parse_config_string(models.transformer_lm_config(
            vocab=40, seq=16, batch_size=2, dim=32, nhead=4, nlayer=1,
            dev="cpu", attn_extra=LM_VARIANTS["gqa_window_rope"])):
        tr.set_param(k, v)
    tr.init_model()
    i = [j for j, lay in enumerate(tr.net.layers)
         if lay.type_name == "attention"][0]
    w = cost.layer_work(tr.net, i, 2)
    rope = 3.0 * 2 * 16 * (32 + 16)
    assert w["ew_fwd"] - rope == 4 * 8 * 4 * 2 * flash_attn.kept_pairs(
        16, True, 8)
    # a KV-cached step at positions 3 and 12 keeps 4 and 8 (window) keys
    w = cost.layer_work(tr._net_for(2, 1), i, 2, q_offs=[3, 12])
    rope = 3.0 * 2 * 1 * (32 + 16)
    assert w["ew_fwd"] - rope == 4 * 8 * 4 * (4 + 8)


# ----------------------------------------------------------------------
# every convolution of ImageNet.conf against XLA's count of it alone
def _conv_layers(tr):
    return [i for i, lay in enumerate(tr.net.layers)
            if lay.type_name == "conv"]


@pytest.mark.parametrize("nth", range(5))
def test_conv_counts_equal_xla_alone(imagenet, nth):
    _, tr = imagenet
    i = _conv_layers(tr)[nth]
    p = tr.net.layers[i].param
    info = tr.net.cfg.layers[i]
    b, c, h, w_ = tr.net.node_shapes[info.nindex_in[0]]
    _, co, oh, ow = tr.net.node_shapes[info.nindex_out[0]]
    x = jax.ShapeDtypeStruct((b, c, h, w_), jnp.float32)
    wt = jax.ShapeDtypeStruct((co, c // p.num_group, p.kernel_height,
                               p.kernel_width), jnp.float32)
    gy = jax.ShapeDtypeStruct((b, co, oh, ow), jnp.float32)

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (p.stride, p.stride),
            [(p.pad_y, p.pad_y), (p.pad_x, p.pad_x)],
            feature_group_count=p.num_group,
            dimension_numbers=("NCHW", "OIHW", "NCHW"))

    fwd = _xla_flops(conv, x, wt)
    dgrad = _xla_flops(lambda w, g: jax.linear_transpose(
        lambda xx: conv(xx, w), x)(g)[0], wt, gy)
    wgrad = _xla_flops(lambda x, g: jax.linear_transpose(
        lambda ww: conv(x, ww), wt)(g)[0], x, gy)
    work = cost.layer_work(tr.net, i, b, train=True)
    assert (work["fwd"], work["dgrad"], work["wgrad"]) == (fwd, dgrad,
                                                           wgrad)
    # roofline.py's padded count is an upper bound, equal without padding
    padded = 2.0 * b * co * (c // p.num_group) * p.kernel_height \
        * p.kernel_width * oh * ow
    assert work["fwd"] <= padded
    assert (work["fwd"] == padded) == (p.pad_y == p.pad_x == 0)


# ----------------------------------------------------------------------
# whole programs of ImageNet.conf at batch 2 against XLA's count
def test_imagenet_predict_within_1pct_of_xla(imagenet):
    jtr, tr = imagenet
    node = jtr.net_cfg.param.num_nodes - 1
    data = np.random.RandomState(0).rand(2, 3, 227, 227).astype(np.float32)

    def prog(params, data, rng):
        out = jtr._eval_values(params, data, rng, (node,))[0]
        out = out.reshape(out.shape[0], -1)
        return jnp.argmax(out, axis=1).astype(jnp.float32), params
    xla = _xla_flops(prog, jtr.params, jnp.asarray(data),
                     jax.random.PRNGKey(0))
    mine = cost.forward_cost(tr.net, tr.params)["flops"]
    assert abs(mine / xla - 1.0) < 0.01, (mine, xla)


def test_imagenet_train_step_within_2pct_of_xla(imagenet):
    from cxxnet_tpu.io.data import DataBatch
    jtr, tr = imagenet
    rs = np.random.RandomState(0)
    b = DataBatch()
    b.data = rs.rand(2, 3, 227, 227).astype(np.float32)
    b.label = rs.randint(0, 1000, (2, 1)).astype(np.float32)
    b.batch_size = 2
    c = jtr.lower_update(b).cost_analysis()
    c = c[0] if isinstance(c, (list, tuple)) else c
    xla = float(c["flops"])
    mine = cost.train_step_cost(tr.net, tr.params, tr.updaters)["flops"]
    assert abs(mine / xla - 1.0) < 0.02, (mine, xla)
    # the three products at in-bounds taps less conv1's data gradient
    # (which the step never computes) carry all but the elementwise and
    # updater work
    prods = sum(cost.layer_work(tr.net, i, 2, train=True)[k]
                for i in range(len(tr.net.layers))
                for k in ("fwd", "dgrad", "wgrad"))
    first = cost.layer_work(tr.net, _conv_layers(tr)[0], 2)["dgrad"]
    assert 0.9 < (prods - first) / mine < 1.0


# ----------------------------------------------------------------------
# each kernel's work() against the counts the chip check used
def _old_kept_pairs(L, causal, window, skv=None, q_off=0, kv_off=0):
    skv = L if skv is None else skv
    if not causal:
        return L * skv
    qpos = q_off + np.arange(L, dtype=np.int64)
    hi = np.minimum(qpos - kv_off + 1, skv)
    lo = np.maximum(qpos - window + 1 - kv_off, 0) if window > 0 else 0
    return int(np.clip(hi - lo, 0, None).sum())


def _old_flash_work(b, h, nkv, L, d, causal, window, esize):
    ops = 4 * d * _old_kept_pairs(L, causal, window) * b * h
    nbytes = esize * (2 * b * h * L * d + 2 * b * nkv * L * d) + 4 * b * h * L
    return ops, nbytes


def _old_flash_bwd_work(b, h, nkv, L, d, causal, window, esize):
    pairs = _old_kept_pairs(L, causal, window) * b * h
    q_elems, kv_elems = b * h * L * d, b * nkv * L * d
    rows = 8 * b * h * L
    return ((6 * d * pairs, esize * (3 * q_elems + 2 * kv_elems) + rows),
            (8 * d * pairs, esize * (2 * q_elems + 4 * kv_elems) + rows))


def _old_ring_step_work(kernel, bh, bkv, sq, skv, d, q_off, kv_off, causal,
                        window, esize):
    pairs = _old_kept_pairs(sq, causal, window, skv, q_off, kv_off) * bh
    q_b, kv_b = esize * bh * sq * d, esize * bkv * skv * d
    rows, q_f32, kv_f32 = 4 * bh * sq, 4 * bh * sq * d, 4 * bkv * skv * d
    if kernel == "fwd":
        if not pairs:
            return 0, 4 * rows
        return 4 * d * pairs, q_b + 2 * kv_b + 4 * rows + 2 * q_f32
    if not pairs:
        return 0, 0
    if kernel == "dq":
        return 6 * d * pairs, 2 * q_b + 2 * kv_b + 2 * rows + 2 * q_f32
    return 8 * d * pairs, 2 * q_b + 2 * kv_b + 2 * rows + 4 * kv_f32


FLASH_SHAPES = [  # (b, h, nkv, L, d, causal, window)
    (8, 8, 8, 2048, 64, True, 0), (2, 8, 2, 8192, 64, True, 1024),
    (2, 4, 4, 640, 256, False, 0), (8, 2, 2, 2048, 256, True, 0),
    (1, 1, 1, 1000, 512, True, 100), (2, 2, 2, 128, 8, True, 1)]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("esize", (4, 2))
def test_flash_work_equals_the_chip_checks_count(shape, esize):
    assert flash_attn.work(*shape, esize) == _old_flash_work(*shape, esize)
    assert flash_attn.bwd_work(*shape, esize) == \
        _old_flash_bwd_work(*shape, esize)


RING_CASES = [  # (bh, bkv, sq, skv, d, q_off, kv_off, causal, window)
    (16, 16, 512, 512, 64, 0, 0, True, 0),
    (16, 16, 512, 512, 64, 1536, 512, True, 0),
    (16, 4, 2048, 2048, 256, 2048, 4096, True, 0),
    (16, 16, 512, 512, 64, 512, 1536, True, 0),
    (8, 2, 1024, 512, 512, 4096, 2048, True, 1024),
    (4, 4, 256, 256, 64, 0, 256, False, 0)]


@pytest.mark.parametrize("case", RING_CASES, ids=str)
@pytest.mark.parametrize("kernel", ("fwd", "dq", "dkv"))
def test_ring_work_equals_the_chip_checks_count(case, kernel):
    for esize in (4, 2):
        assert ring_flash.work(kernel, *case, esize) == \
            _old_ring_step_work(kernel, *case, esize)


@pytest.mark.parametrize("shape", [(256, 96, 27, 27), (256, 256, 13, 13),
                                   (128, 64, 56, 56)], ids=str)
@pytest.mark.parametrize("esize", (4, 2))
def test_lrn_work_equals_the_chip_checks_count(shape, esize):
    n = int(np.prod(shape))
    assert lrn.work(n, esize) == (n * 9, n * (2 * esize + 4))
    assert lrn.work(n, esize, with_norm=False) == (n * 9, n * 2 * esize)
    assert lrn.bwd_work(n, esize) == (n * 12, n * (3 * esize + 4))


@pytest.mark.parametrize("n,rows", [(1, 1), (4 * 250000 + 3, 1),
                                    (8192, 8), (256 * 96 * 55 * 55, 1)])
def test_uniform_work_equals_the_chip_checks_count(n, rows):
    assert oprandom.work(n) == (n * 28, 4 * n)
    assert oprandom.rows_work(rows, n) == (rows * n * 28,
                                           4 * rows * n + 3 * 8 * rows)


def test_lrn_layer_counts_its_kernels_work(imagenet):
    """The ledger's LRN layers count their kernels' work: the norm-keeping
    forward and the backward in a training step, the no-norm forward in a
    predict."""
    _, tr = imagenet
    i = [j for j, lay in enumerate(tr.net.layers)
         if lay.type_name == "lrn"][0]
    n = int(np.prod(tr.net.node_shapes[tr.net.cfg.layers[i].nindex_in[0]]))
    w = cost.layer_work(tr.net, i, 2, train=True)
    assert w["ew_fwd"] == lrn.work(n, 4)[0]
    assert w["ew_bwd"] == lrn.bwd_work(n, 4)[0]


def test_conv_taps_rule():
    # 5x5 pad 2 on 27: 0.9131 of the padded count; 3x3 pad 1 on 13: 0.9001
    assert cost.conv_taps(27, 5, 1, 2, 27) ** 2 / (25 * 27 * 27) == \
        pytest.approx(0.9130864, abs=1e-6)
    assert cost.conv_taps(13, 3, 1, 1, 13) ** 2 / (9 * 13 * 13) == \
        pytest.approx(0.9000657, abs=1e-6)
    assert cost.conv_taps(227, 11, 4, 0, 55) == 11 * 55
    # a brute-force count over a small case
    for size, k, s, p in ((7, 3, 2, 1), (9, 4, 3, 2), (5, 5, 1, 2)):
        out = (size + 2 * p - k) // s + 1
        want = sum(1 for o in range(out) for t in range(k)
                   if 0 <= o * s - p + t < size)
        assert cost.conv_taps(size, k, s, p, out) == want


def test_train_step_counts_the_updater(imagenet):
    """The updater's arithmetic rides the step's count only on the steps
    that update (update_period accumulation)."""
    _, tr = imagenet
    n = sum(t.numel() for p in tr.params for t in p.values())
    full = cost.train_step_cost(tr.net, tr.params, tr.updaters)
    acc = cost.train_step_cost(tr.net, tr.params, tr.updaters,
                               do_update=False)
    assert full["flops"] - acc["flops"] == cost.UPDATER_OPS["sgd"] * n
    assert full["bytes accessed"] > acc["bytes accessed"]


# ----------------------------------------------------------------------
# the small MobileNet and ViT (tests/test_torch_mobilenet.py and
# tests/test_torch_vit.py's nets) against XLA's count, at ImageNet.conf's
# bars
def _small_nets():
    from cxxnet_tpu_torch import models
    return {
        "mobilenet": (models.mobilenet_config(
            batch_size=8, input_hw=16, dev="cpu", n_class=4, base_ch=8,
            blocks=((16, 1), (32, 2)), extra_cfg="eta = 0.05\n"),
            (8, 3, 16, 16), 4),
        "vit": (models.vit_config(
            n_class=10, image_hw=48, patch=4, batch_size=4, dim=32, nhead=2,
            nlayer=2, dev="cpu"), (4, 3, 48, 48), 10),
    }


def _attention_cores(tr, train):
    """(XLA's count, the account's count) of the attention cores alone:
    the JAX layer's dense ``attention_reference`` on the CPU (its forward,
    and in training its vjp too) against the flash kernels' work that the
    account counts. Both packages' programs carry the rest alike."""
    from cxxnet_tpu.parallel import attention_reference
    xla = mine = 0.0
    for i, lay in enumerate(tr.net.layers):
        if lay.type_name != "attention":
            continue
        b, d, _, L = tr.net.node_shapes[tr.net.cfg.layers[i].nindex_in[0]]
        h, dh = lay.nhead, d // lay.nhead
        q = jax.ShapeDtypeStruct((b, h, L, dh), jnp.float32)

        def core(q, k, v):
            return attention_reference(q, k, v, causal=bool(lay.causal))
        if train:
            def core_vjp(q, k, v, g):
                out, vjp = jax.vjp(core, q, k, v)
                return out, vjp(g)
            xla += _xla_flops(core_vjp, q, q, q, q)
        else:
            xla += _xla_flops(core, q, q, q)
        mine += flash_attn.work(b, h, h, L, dh, bool(lay.causal), 0, 4)[0]
        if train:
            (dq, _), (dkv, _) = flash_attn.bwd_work(
                b, h, h, L, dh, bool(lay.causal), 0, 4)
            mine += dq + dkv
    return xla, mine


@pytest.fixture(scope="module", params=["mobilenet", "vit"])
def small_net(request):
    from cxxnet_tpu import api as japi
    from cxxnet_tpu_torch import api as tapi
    cfg, shape, n_class = _small_nets()[request.param]
    jn = japi.Net(dev="cpu", cfg=cfg)
    jn.init_model()
    tn = tapi.Net(dev="cpu", cfg=cfg)
    tn.init_model()
    return request.param, jn.net_, tn.net_, shape, n_class


def test_small_net_predict_within_1pct_of_xla(small_net):
    """The forward of the small MobileNet and ViT; ViT's attention cores
    are taken out of both counts first (XLA counts JAX's dense attention
    on the CPU, the account the flash kernels the port runs)."""
    name, jtr, tr, shape, _ = small_net
    node = jtr.net_cfg.param.num_nodes - 1
    data = np.random.RandomState(0).rand(*shape).astype(np.float32)

    def prog(params, data, rng):
        out = jtr._eval_values(params, data, rng, (node,))[0]
        out = out.reshape(out.shape[0], -1)
        return jnp.argmax(out, axis=1).astype(jnp.float32), params
    xla = _xla_flops(prog, jtr.params, jnp.asarray(data),
                     jax.random.PRNGKey(0))
    mine = cost.forward_cost(tr.net, tr.params)["flops"]
    core_xla, core_mine = _attention_cores(tr, train=False)
    assert (name == "vit") == (core_mine > 0)
    assert abs((mine - core_mine) / (xla - core_xla) - 1.0) < 0.01, \
        (mine, xla, core_mine, core_xla)


def test_small_net_train_step_within_2pct_of_xla(small_net):
    from cxxnet_tpu.io.data import DataBatch
    name, jtr, tr, shape, n_class = small_net
    rs = np.random.RandomState(0)
    b = DataBatch()
    b.data = rs.rand(*shape).astype(np.float32)
    b.label = rs.randint(0, n_class, (shape[0], 1)).astype(np.float32)
    b.batch_size = shape[0]
    c = jtr.lower_update(b).cost_analysis()
    c = c[0] if isinstance(c, (list, tuple)) else c
    xla = float(c["flops"])
    mine = cost.train_step_cost(tr.net, tr.params, tr.updaters)["flops"]
    core_xla, core_mine = _attention_cores(tr, train=True)
    assert abs((mine - core_mine) / (xla - core_xla) - 1.0) < 0.02, \
        (mine, xla, core_mine, core_xla)
