"""Small MobileNet through the port on the CPU against the JAX package: the
net of the JAX ``test_mobilenet_memorizes`` (``mobilenet_config`` with
``base_ch = 8``, blocks ((16, 1), (32, 2)), 16x16 inputs, batch 8, 4
classes, eta 0.05): a depthwise 3x3 conv (ngroup = C) at stride 1 and 2
in every block, batch_norm, relu, the pointwise convs, the global pool.

The JAX trainer makes the weights and ``convert.params_from_jax`` carries
them into the port. Both packages then take the same training forward
and one SGD ``update`` on the same seeded batch. float32: the features
(the global pool's output) within relative 1e-5 plus 1e-5 of their
largest magnitude; the loss within relative 1e-5; every gradient within
1e-5 of the larger of its own largest magnitude and its layer's largest
gradient; every weight after the step within relative 1e-5 plus 1e-5 of
the tensor's largest update. The layer's scale is there for the stem's
and the first pointwise batch_norm's slope: a per-channel relu, a
depthwise conv and the next batch_norm undo any per-channel scale of
that slope while the bias is 0, so its gradient is 0 in exact arithmetic
and rounding noise in both packages (1.3e-7 and 3.6e-8 in JAX, against
bias gradients of 0.16 and 0.069).

bfloat16: ``compute_dtype = bfloat16`` by tests/test_torch_googlenet.py's
rule (the port's error against JAX's bf16 run at most twice JAX's own
bf16-versus-float32 error, plus 1e-3). The helpers here also serve
tests/test_torch_vit.py.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu import api as japi
from cxxnet_tpu import models as jmodels
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch import models as tmodels
from cxxnet_tpu_torch.io import DataBatch
from tests.test_torch_googlenet import (_jax_forward_backward,
                                        check_bfloat16,
                                        check_float32_masters)

TOL = 1e-5
BF16 = "compute_dtype = bfloat16\n"
SMALL = dict(batch_size=8, input_hw=16, dev="cpu", n_class=4, base_ch=8,
             blocks=((16, 1), (32, 2)), extra_cfg="eta = 0.05\n")


def small_cfg(extra=""):
    kw = dict(SMALL, extra_cfg=SMALL["extra_cfg"] + extra)
    return tmodels.mobilenet_config(**kw)


def seeded_batch(shape, n_class):
    rs = np.random.RandomState(0)
    return (rs.randn(*shape).astype(np.float32),
            rs.randint(0, n_class, shape[0]).astype(np.float32))


def jax_and_port(cfg, x, y, feat, jax_net=None):
    """{"jax": ..., "port": ...}, each (features, loss, gradients, weights
    after one update, weights before it) of the training forward on
    (x, y); the port's weights are the JAX trainer's, carried by
    convert.params_from_jax. A bf16 JAX run takes no update."""
    jn = jax_net or japi.Net(dev="cpu", cfg=cfg)
    if jax_net is None:
        jn.init_model()
    jt = jn.net_
    weights = [{k: np.array(v) for k, v in p.items()}
               for p in jt.canonical_params()]
    node = jt.net_cfg.node_name_map[feat]
    out = {}
    lab = y if y.ndim == 2 else y.reshape(-1, 1)
    jo, jl, jg = _jax_forward_backward(jt, x, lab, node)
    # the state (batch-norm running statistics) takes no gradient
    state = [set(lay.state_keys()) for lay in jt.net.layers]
    jg = [{k: v for k, v in g.items() if k not in st}
          for g, st in zip(jg, state)]
    if jt.compute_dtype is None:
        jn.update(x, y)
        out["jax"] = (jo, jl, jg, jt.canonical_params(), weights)
    else:
        out["jax"] = (jo, jl, jg, None, None)
    tn = tapi.Net(dev="cpu", cfg=cfg)
    tn.init_model()
    tr = tn.net_
    tr.params = convert.params_from_jax(weights, tr.net, tr.dev)
    b = DataBatch()
    b.data, b.label, b.batch_size = x, lab, x.shape[0]
    values, _, loss, grads = tr._forward_backward(
        b, torch.Generator().manual_seed(0),
        [(i, k) for i, p in enumerate(tr.params) for k in p])
    to = values[tr.net_cfg.node_name_map[feat]].detach().float().numpy()
    grads = iter(grads)
    grads = [{k: next(grads).float().numpy() for k in p} for p in tr.params]
    grads = [{k: v for k, v in g.items() if k not in st}
             for g, st in zip(grads, state)]
    tn.update(x, y)
    out["port"] = (to, float(loss), grads,
                   [{k: v.detach() for k, v in p.items()}
                    for p in tr.params], weights)
    return out


def check_float32(r, layer_scale=True, adam_eta=None):
    """The float32 bars of the module docstring. After an Adam update
    (``adam_eta``) the weights are held within 1e-2 of eta instead
    (tests/test_torch_lm_train.py's bar), where the JAX gradient stands
    above the gradient bar (1e-5 of its tensor's largest): Adam's first
    step is about eta g / |g|, so a weight whose gradient is rounding noise
    moves by an unpredictable share of eta in either package, and is held
    only to the tensor's largest step."""
    jo, jl, jg, jp, j0 = r["jax"]
    to, tl, tg, tp, _ = r["port"]
    np.testing.assert_allclose(to, jo, rtol=TOL,
                               atol=TOL * float(np.abs(jo).max()))
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert sorted(a) == sorted(b)
        largest = max([float(np.abs(v).max()) for v in b.values()] + [0.0])
        for k in b:
            scale = max(float(np.abs(b[k]).max()),
                        largest if layer_scale else 0.0)
            err = float(np.abs(a[k] - b[k]).max())
            assert err <= TOL * scale, (i, k, err, scale)
    for i, (a, b, b0) in enumerate(zip(tp, jp, j0)):
        for k in b:
            want = np.asarray(b[k], np.float32)
            got = a[k].numpy()
            step = want - b0[k]
            what = "layer %d %s after the step" % (i, k)
            if adam_eta is None:
                np.testing.assert_allclose(
                    got, want, rtol=TOL, atol=TOL * float(np.abs(step).max()),
                    err_msg=what)
                continue
            g = np.abs(jg[i][k]) if k in jg[i] else np.zeros_like(step)
            held = g > TOL * float(g.max())
            np.testing.assert_allclose(got[held], want[held], rtol=0.0,
                                       atol=1e-2 * adam_eta, err_msg=what)
            assert float(np.abs(got - b0[k])[~held].max(initial=0.0)) <= \
                float(np.abs(step).max()) * (1 + TOL), what


def bf16_runs(cfg_of, x, y, feat, tmp_dir):
    """tests/test_torch_googlenet.py's run dict for check_bfloat16: the
    JAX float32 and bf16 runs and the port's bf16 run, one weight set."""
    jn = japi.Net(dev="cpu", cfg=cfg_of(""))
    jn.init_model()
    fname = str(tmp_dir / "jax.model")
    jn.save_model(fname)
    out = {}
    for dt, extra in (("f32", ""), ("bf16", BF16)):
        net = japi.Net(dev="cpu", cfg=cfg_of(extra))
        net.load_model(fname)
        r = jax_and_port(cfg_of(extra), x, y, feat, jax_net=net)
        out[(dt, "jax")] = r["jax"]
        out[(dt, "port")] = r["port"]
    return out


@pytest.fixture(scope="module")
def f32_runs():
    x, y = seeded_batch((8, 3, 16, 16), 4)
    return jax_and_port(small_cfg(), x, y, "gap")


def test_builders_write_the_jax_text():
    assert tmodels.MOBILENET_BLOCKS == jmodels.MOBILENET_BLOCKS
    for blocks in (tmodels.MOBILENET_BLOCKS, SMALL["blocks"]):
        for hw in (16, 224, 100):
            assert tmodels._mobilenet_final_pool(blocks, hw) == \
                jmodels._mobilenet_final_pool(blocks, hw)
    assert tmodels.mobilenet_netconfig() == jmodels.mobilenet_netconfig()
    assert tmodels.mobilenet_netconfig(4, 8, SMALL["blocks"], 4) == \
        jmodels.mobilenet_netconfig(4, 8, SMALL["blocks"], 4)


def test_depthwise_weights_keep_the_jax_layout():
    tr = tapi.Net(dev="cpu", cfg=small_cfg())
    tr.init_model()
    i = tr.net_.net_cfg.get_layer_index("dw0")
    assert tuple(tr.net_.params[i]["wmat"].shape) == (8, 1, 9)


def test_float32_forward_and_step_match_jax(f32_runs):
    check_float32(f32_runs)


def test_gradient_bar_needs_the_layer_scale_only_for_zero_gradients(
        f32_runs):
    """Without the layer's scale exactly the two slopes whose gradient is 0
    in exact arithmetic miss the bar, each at rounding noise."""
    jg, tg = f32_runs["jax"][2], f32_runs["port"][2]
    missed = []
    for i, (a, b) in enumerate(zip(tg, jg)):
        for k in b:
            m = float(np.abs(b[k]).max())
            if float(np.abs(a[k] - b[k]).max()) > TOL * m:
                missed.append((i, k))
                assert m < 1e-6 * max(float(np.abs(v).max())
                                      for v in b.values())
    assert [k for _, k in missed] == ["slope", "slope"], missed


@pytest.fixture(scope="module")
def runs_bf16(tmp_path_factory):
    x, y = seeded_batch((8, 3, 16, 16), 4)
    return bf16_runs(small_cfg, x, y, "gap",
                     tmp_path_factory.mktemp("mobilenet"))


def test_bfloat16_within_twice_jax_own_error(runs_bf16):
    check_bfloat16(runs_bf16, worst_tensor=False)


def test_bfloat16_step_keeps_float32_masters(runs_bf16):
    check_float32_masters(runs_bf16)
