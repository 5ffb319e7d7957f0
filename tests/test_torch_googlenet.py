"""Small GoogLeNet through the port on the CPU against the JAX package, in
float32 and under ``compute_dtype = bfloat16``; the helpers also serve
tests/test_torch_resnet.py.

GoogLeNet is ``googlenet_netconfig`` at batch 4, 64x64 and 10 classes (as
tests/test_example_configs.py runs it), ResNet ``resnet_netconfig`` at
ResNet-18's depths, batch 8, 32x32. The port's model builders must write
the JAX builders' text. The JAX package inits and saves each model; both
packages load the file and take the same forward and one ``update`` on
the same seeded batch, with dropout's threshold 0 (the two packages draw
different bits).

float32: the features (the global pool's output) within relative 1e-5
plus 1e-5 of their largest magnitude (test_torch_train.py's bar), the
loss within relative 1e-5. XLA and PyTorch sum conv products in other
orders, which moves an element by a few ulps of the largest summands.
Every gradient is held to the net's grad_tol of its tensor's largest
magnitude, and every parameter after the step to relative 1e-5 plus
grad_tol of the tensor's largest update (the gradient's bar carried
through the step). ResNet's is 1e-4: its worst gradient is 2.0e-5 of its
tensor's largest off JAX's (a batch-norm slope). GoogLeNet's is 2e-3: a
max pool routes its gradient to the first largest element of a window,
and GoogLeNet's stride-1 pools over its inception outputs see values that
are equal in exact arithmetic and one ulp apart in one package's
rounding, so a few elements' gradients go to a neighbour (measured:
GoogLeNet's conv1, conv2r, conv2 and i3a pool-projection gradients 5e-4
to 1.37e-3 of their largest off JAX's; the same port run in float64
agrees with JAX to 1e-6).

bfloat16: the port's error against the JAX package's bf16 run must be at
most twice the JAX package's own bf16-versus-float32 error, plus 1e-3:
for the features, each error the largest difference over the largest
float32 magnitude; for the loss, the absolute difference; for every
gradient tensor, the L2 norm of the difference over the float32
gradient's norm, and for GoogLeNet also the worst tensor's largest
difference over its largest float32 magnitude. Measured with both
packages on the CPU (JAX bf16 vs f32 -> port bf16 vs JAX bf16):

- GoogLeNet: features 0.0059 -> 0.0051, loss 4.3e-6 -> 0; the gradients'
  L2 errors in JAX 0.006 to 0.36, the port's at most 0.90 of its bar (a
  bias of the last inception), and all-zero gradients would fail in all
  116 tensors; worst tensor 0.40 -> 0.21.
- ResNet: features 0.16 -> 0.13, loss 0.019 -> 0.025; the gradients' L2
  errors in JAX 0.022 (the head's bias) to 0.62, the port's at most 0.58
  of its bar, and all-zero gradients would fail in 32 of the 62 tensors,
  from the head back through the last stages. Batch-norm over 8 images,
  down to 1x1 in the last stage, makes the earlier stages' bf16
  gradients half noise in both packages (a batch of 32 leaves them at
  0.41 in JAX), so the worst element's error (1.06 in JAX) makes no bar;
  the layer itself is held to the rule in tests/test_torch_batchnorm.py.
  ResNet's model file has the JAX-initialised head's weights scaled by
  0.1: the kaiming head on ResNet's features starts the softmax
  saturated (loss 18.05, where one bf16 rounding of a logit moves it by
  tenths in either package), and scaled it starts at 2.99.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import api as japi
from cxxnet_tpu import models as jmodels
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import models as tmodels
from cxxnet_tpu_torch.io import DataBatch

F32_TOL = 1e-5
BF16 = "compute_dtype = bfloat16\n"


def _scale_head(net):
    net.set_weight(net.get_weight("fc") * 0.1, "fc")


NETS = {
    # name: (config builder, batch shape, feature node, grad_tol, what is
    # done to the JAX-initialised net before it is saved)
    "googlenet": (lambda extra: tmodels.googlenet_config(
        batch_size=4, input_hw=64, dev="cpu", n_class=10,
        extra_cfg=extra).replace("threshold = 0.4", "threshold = 0"),
        (4, 3, 64, 64), "gp", 2e-3, lambda net: None),
    "resnet18": (lambda extra: tmodels.resnet_config(
        batch_size=8, input_hw=32, dev="cpu", n_class=10, extra_cfg=extra),
        (8, 3, 32, 32), "gap", 1e-4, _scale_head),
}


def test_builders_write_the_jax_text():
    assert tmodels.googlenet_netconfig(10, 2) == \
        jmodels.googlenet_netconfig(10, 2)
    assert tmodels.GOOGLENET_MODULES == jmodels.GOOGLENET_MODULES
    assert tmodels.resnet_netconfig() == jmodels.resnet_netconfig()
    assert tmodels.resnet_netconfig((1, 1), 8, 10, 2) == \
        jmodels.resnet_netconfig((1, 1), 8, 10, 2)
    for arch in ("vgg11", "vgg16"):
        assert tmodels.vgg_netconfig(arch, remat=1) == \
            jmodels.vgg_netconfig(arch, remat=1)


def _batch(shape):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randint(0, 10, shape[0]).astype(np.float32)
    return x, y


def _jax_forward_backward(jt, x, y, node):
    """The node's values, the loss and the gradients of the forward JAX's
    next update takes (one compiled program)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(jt.seed),
                             jt._rng_counter + 1)

    def loss_fn(params):
        values, loss = jt.net.forward(
            params, jnp.asarray(x), labels=jt.net.label_info_from(y),
            train=True, rng=rng, epoch=jt.epoch_counter)
        return loss, values[node]
    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jt.params)
    return np.asarray(out, np.float32), float(loss), [
        {k: np.asarray(v, np.float32) for k, v in g.items()} for g in grads]


def _run(pkg, cfg, fname, x, y, feat):
    """(features, loss, gradients, params after one update, params
    before it) of one package's net loaded from ``fname``; the features
    are the feature node of the training forward the gradients come
    from (dropout is off). The JAX package takes its update in float32
    only: the bf16 rule holds features and gradients."""
    net = (japi if pkg == "jax" else tapi).Net(dev="cpu", cfg=cfg)
    net.load_model(fname)
    tr = net.net_
    node = tr.net_cfg.node_name_map[feat]
    if pkg == "jax":
        out, loss, grads = _jax_forward_backward(tr, x, y.reshape(-1, 1),
                                                 node)
        if tr.compute_dtype is not None:
            return out, loss, grads, None, None
        before = [{k: np.array(v) for k, v in p.items()}
                  for p in tr.canonical_params()]
        net.update(x, y)
        return out, loss, grads, tr.canonical_params(), before
    b = DataBatch()
    b.data, b.label, b.batch_size = x, y.reshape(-1, 1), x.shape[0]
    values, _, loss, grads = tr._forward_backward(
        b, torch.Generator().manual_seed(0),
        [(i, k) for i, p in enumerate(tr.params) for k in p])
    out = values[node].detach().float().numpy()
    grads = iter(grads)
    grads = [{k: next(grads).numpy() for k in p} for p in tr.params]
    before = [{k: v.detach().clone() for k, v in p.items()}
              for p in tr.params]
    net.update(x, y)
    return out, float(loss), grads, [{k: v.detach() for k, v in p.items()}
                                     for p in tr.params], before


def run_all(name, tmp_dir):
    """{(dtype, package): _run's tuple} for the net ``name``, from one
    model file that the JAX package initialized and wrote."""
    mk, shape, feat, _, prepare = NETS[name]
    fname = str(tmp_dir / "jax.model")
    net = japi.Net(dev="cpu", cfg=mk(""))
    net.init_model()
    prepare(net)
    net.save_model(fname)
    x, y = _batch(shape)
    return {(dt, pkg): _run(pkg, mk(extra), fname, x, y, feat)
            for dt, extra in (("f32", ""), ("bf16", BF16))
            for pkg in ("jax", "port")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_all("googlenet", tmp_path_factory.mktemp("googlenet"))


def _err(got, want, ref):
    return float(np.abs(got - want).max()) / float(np.abs(ref).max())


def _allclose(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32),
                               rtol=F32_TOL, atol=atol, err_msg=what)


def _l2(got, want, ref):
    return float(np.linalg.norm(got - want) / np.linalg.norm(ref))


def check_float32(r, grad_tol):
    jo, jl, jg, jp, j0 = r[("f32", "jax")]
    to, tl, tg, tp, _ = r[("f32", "port")]
    _allclose(to, jo, F32_TOL * float(np.abs(jo).max()), "features")
    np.testing.assert_allclose(tl, jl, rtol=F32_TOL)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert sorted(a) == sorted(b)
        for k in b:
            assert _err(a[k], b[k], b[k]) <= grad_tol, (i, k)
    for i, (a, b, b0) in enumerate(zip(tp, jp, j0)):
        for k in b:
            step = np.asarray(b[k], np.float32) - np.asarray(b0[k])
            _allclose(a[k].numpy(), b[k], grad_tol * float(np.abs(step).max()),
                      "layer %d %s after the step" % (i, k))


def check_bfloat16(r, worst_tensor):
    fo, fl, fg = r[("f32", "jax")][:3]
    jo, jl, jg = r[("bf16", "jax")][:3]
    to, tl, tg = r[("bf16", "port")][:3]
    assert _err(to, jo, fo) <= 2 * _err(jo, fo, fo) + 1e-3
    assert abs(tl - jl) <= 2 * abs(jl - fl) + 1e-3, (tl, jl, fl)
    for i, (a, b, c) in enumerate(zip(tg, jg, fg)):
        for k in c:
            port, own = _l2(a[k], b[k], c[k]), _l2(b[k], c[k], c[k])
            assert port <= 2 * own + 1e-3, (i, k, port, own)
    if worst_tensor:
        worst_port = max(_err(a[k], b[k], c[k])
                         for a, b, c in zip(tg, jg, fg) for k in c)
        worst_jax = max(_err(b[k], c[k], c[k]) for b, c in zip(jg, fg)
                        for k in c)
        assert worst_port <= 2 * worst_jax + 1e-3, (worst_port, worst_jax)


def check_float32_masters(r):
    # the bf16 update ran on float32 master weights and stayed finite
    for p in r[("bf16", "port")][3]:
        for v in p.values():
            assert v.dtype == torch.float32 and bool(torch.isfinite(v).all())


def test_float32_forward_and_step_match_jax(runs):
    check_float32(runs, NETS["googlenet"][3])


def test_bfloat16_within_twice_jax_own_error(runs):
    check_bfloat16(runs, worst_tensor=True)


def test_bfloat16_step_keeps_float32_masters(runs):
    check_float32_masters(runs)
