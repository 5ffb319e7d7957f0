"""The port's ``batch_norm`` on the CPU against the JAX package
(cxxnet_tpu/layer/layers.py:844-950, cxxnet_tpu/nnet/trainer.py:1061-1066).

- The layer: conv-shaped and flat inputs, ``moving_average`` 0 (eval takes
  the minibatch's statistics, the reference's behaviour) and 1 (training
  records the EMA of the running statistics, eval normalizes with them):
  output, input and weight gradients, and the recorded state updates.
- A small net with batch-norm after a conv and after a fullc (both
  without a bias, whose gradient batch-norm makes zero up to rounding
  noise), trained with
  two ``update``s from one model file in both packages: every weight, the
  running statistics and the optimizer state after each step.
- Model files: each package writes, the other reads, with and without the
  running statistics.
- Under ``compute_dtype = bfloat16`` the layer against the JAX package's
  bf16 apply, within twice JAX's own bf16-versus-float32 error plus 1e-3
  (the bf16 rule of tests/test_torch_googlenet.py); the running
  statistics are state: float32 after an update, never given to an
  updater.

float32 otherwise, held to 1e-5 relative plus 1e-5 of the largest
magnitude compared (the reference's PairTest bar); a mean over a batch is
summed in another order on the two sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu import api as japi
from cxxnet_tpu.layer import factory as jfactory
from cxxnet_tpu.layer.base import ApplyContext as JContext
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch.layer import factory as tfactory
from cxxnet_tpu_torch.layer.base import ApplyContext

from tests.test_torch_train import _assert_same_state

TOL = 1e-5


def _close(got, want, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


def _pair(keys, shape):
    out = []
    for fac in (jfactory, tfactory):
        lay = fac.create_layer(fac.get_layer_type("batch_norm"))
        for k, v in keys:
            lay.set_param(k, v)
        lay.infer_shape([shape])
        out.append(lay)
    return out


def _layer_case(moving_average, train, shape):
    """(JAX layer, port layer, x, output cotangent, params) of one case."""
    keys = [("moving_average", str(moving_average)), ("init_slope", "1.5"),
            ("init_bias", "0.25"), ("bn_momentum", "0.8")]
    jlay, tlay = _pair(keys, shape)
    rng = np.random.RandomState(moving_average + 2 * train)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    params = {k: np.asarray(v) for k, v in jlay.init_params(rng).items()}
    if moving_average:
        c = params["slope"].shape[0]
        params["running_mean"] = rng.randn(c).astype(np.float32)
        params["running_var"] = rng.rand(c).astype(np.float32) + 0.5
    assert sorted(params) == sorted(tlay.param_shapes())
    return jlay, tlay, x, g, params


def _jax_apply(lay, x, g, params, train, dtype):
    """{name: float32 array} of the JAX layer's apply with x, slope and
    bias in ``dtype`` (the running statistics stay float32, as the net's
    compute-dtype view leaves them): out, dx, dslope, dbias and the
    recorded state updates."""
    ctx = JContext(train=train)
    ctx.layer_index = 3
    p = {k: jnp.asarray(v, jnp.float32 if k.startswith("running")
                        else dtype) for k, v in params.items()}

    def f(x_, p_):
        return lay.apply(p_, [x_], ctx)[0]
    out, vjp = jax.vjp(f, jnp.asarray(x, dtype), p)
    dx, dp = vjp(jnp.asarray(g, dtype))
    res = {"out": out, "dx": dx, "dslope": dp["slope"], "dbias": dp["bias"]}
    res.update({"state %s" % k: v for (_, k), v in ctx.state_updates.items()})
    return {k: np.asarray(v, np.float32) for k, v in res.items()}


def _port_forward(lay, x, g, params, train, dtype):
    """_jax_apply's dict from the port's layer."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    tp = {k: torch.from_numpy(v.copy()).to(
        torch.float32 if k.startswith("running") else dtype)
        .requires_grad_() for k, v in params.items()}
    ctx = ApplyContext(train=train, layer_index=3)
    out = lay.forward(tp, [xt], ctx)[0]
    out.backward(torch.from_numpy(g).to(dtype))
    assert out.dtype == dtype and xt.grad.dtype == dtype
    res = {"out": out, "dx": xt.grad, "dslope": tp["slope"].grad,
           "dbias": tp["bias"].grad}
    for (_, k), v in ctx.state_updates.items():
        assert v.dtype == torch.float32
        res["state %s" % k] = v
    return {k: v.detach().float().numpy() for k, v in res.items()}


@pytest.mark.parametrize("moving_average", [0, 1])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(6, 5, 4, 3), (8, 1, 1, 7)])
def test_layer_matches_jax(moving_average, train, shape):
    jlay, tlay, x, g, params = _layer_case(moving_average, train, shape)
    want = _jax_apply(jlay, x, g, params, train, jnp.float32)
    got = _port_forward(tlay, x, g, params, train, torch.float32)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("state") for k in want) == bool(
        moving_average and train)
    for k in want:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("moving_average", [0, 1])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(6, 5, 4, 3), (8, 1, 1, 7)])
def test_layer_bfloat16_within_twice_jax_own_error(moving_average, train,
                                                   shape):
    """The layer in bf16 (x, slope and bias bf16, the running statistics
    float32, as the net's compute-dtype view gives them) against the JAX
    package's bf16 apply: for the output, dx, dslope, dbias and the state
    updates, the port's largest difference from JAX's bf16 result, over
    the tensor's largest float32 magnitude, is at most twice JAX's own
    bf16-versus-float32 error plus 1e-3. The port takes the variance
    over float32 ``x - mean`` and normalizes in float32, where JAX
    subtracts in bf16. Measured over these 8 cases: JAX's own error 4.0e-4
    (running_mean) to 2.7e-2 (dslope), the port's from JAX's bf16 at most
    0.67 of that bar (running_var), and the port's own bf16-versus-float32
    error below JAX's in 32 of the 36 tensors."""
    jlay, tlay, x, g, params = _layer_case(moving_average, train, shape)
    f32 = _jax_apply(jlay, x, g, params, train, jnp.float32)
    jbf = _jax_apply(jlay, x, g, params, train, jnp.bfloat16)
    tbf = _port_forward(tlay, x, g, params, train, torch.bfloat16)
    assert sorted(tbf) == sorted(jbf) == sorted(f32)
    for k in f32:
        scale = float(np.abs(f32[k]).max())
        own = float(np.abs(jbf[k] - f32[k]).max()) / scale
        port = float(np.abs(tbf[k] - jbf[k]).max()) / scale
        assert port <= 2 * own + 1e-3, (k, port, own)


def test_layer_keys_and_visit_order():
    _, tlay = _pair([("moving_average", "1")], (2, 3, 4, 4))
    assert tlay.visit_order() == [("wmat", "slope"), ("bias", "bias")]
    assert tlay.state_keys() == ("running_mean", "running_var")
    assert tlay.param_shapes() == {k: (3,) for k in (
        "slope", "bias", "running_mean", "running_var")}
    _, tlay = _pair([], (2, 1, 1, 9))
    assert tlay.state_keys() == () and tlay.channel == 9


NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 6
  pad = 1
  no_bias = 1
layer[1->2] = batch_norm:bn1
  moving_average = %(ma)d
layer[2->3] = relu
layer[3->4] = max_pooling
  kernel_size = 2
  stride = 2
layer[4->5] = flatten
layer[5->6] = fullc:fc1
  nhidden = 12
  no_bias = 1
layer[6->7] = batch_norm:bn2
  moving_average = %(ma)d
  bn_momentum = 0.7
layer[7->8] = relu
layer[8->9] = fullc:fc2
  nhidden = 5
layer[9->9] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 6
random_type = xavier
eta = 0.1
momentum = 0.9
wd = 0.001
dev = cpu
"""


def _cfg(ma, extra=""):
    return NET % {"ma": ma} + extra


def _batches(n):
    rng = np.random.RandomState(7)
    return [(rng.randn(6, 3, 8, 8).astype(np.float32) * 2,
             rng.randint(0, 5, 6).astype(np.float32)) for _ in range(n)]


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    out = {}
    for ma in (0, 1):
        net = japi.Net(dev="cpu", cfg=_cfg(ma))
        net.init_model()
        out[ma] = str(tmp_path_factory.mktemp("bn%d" % ma) / "jax.model")
        net.save_model(out[ma])
    return out


def _load(pkg, fname, cfg):
    net = (japi if pkg == "jax" else tapi).Net(dev="cpu", cfg=cfg)
    net.load_model(fname)
    return net


@pytest.mark.parametrize("ma", [0, 1])
def test_two_updates_match_jax(model_files, ma):
    jnet = _load("jax", model_files[ma], _cfg(ma))
    tnet = _load("port", model_files[ma], _cfg(ma))
    if ma:
        # the running statistics are params with no updater
        bn = tnet.net_.net.cfg.get_layer_index("bn1")
        assert sorted(tnet.net_.params[bn]) == ["bias", "running_mean",
                                                "running_var", "slope"]
        assert sorted(tnet.net_.updaters[bn]) == ["bias", "slope"]
    stats = []
    for step, (x, y) in enumerate(_batches(2)):
        jnet.update(x, y)
        tnet.update(x, y)
        _assert_same_state(jnet, tnet, "moving_average %d step %d"
                           % (ma, step))
        if ma:
            bn = tnet.net_.net.cfg.get_layer_index("bn1")
            stats.append(tnet.net_.params[bn]["running_mean"].clone())
    if ma:
        # the EMA moved in each of the two steps
        assert not torch.equal(stats[0], stats[1])
        assert not torch.equal(stats[0], torch.zeros_like(stats[0]))
    # eval (predict) normalizes alike: running statistics with
    # moving_average 1, the batch's own without
    x = _batches(3)[2][0]
    _close(tnet.extract(x, "top[-1]"), jnet.extract(x, "top[-1]"),
           "eval forward after two steps")


@pytest.mark.parametrize("ma", [0, 1])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_model_files_cross_both_ways(model_files, tmp_path, ma, direction):
    jnet = _load("jax", model_files[ma], _cfg(ma))
    tnet = _load("port", model_files[ma], _cfg(ma))
    x, y = _batches(1)[0]
    jnet.update(x, y)
    tnet.update(x, y)
    fname = str(tmp_path / "bn.model")
    if direction == "port_to_jax":
        tnet.save_model(fname)
        back = _load("jax", fname, _cfg(ma))
        _assert_same_state(back, tnet, "port file read by JAX")
    else:
        jnet.save_model(fname)
        back = _load("port", fname, _cfg(ma))
        _assert_same_state(jnet, back, "JAX file read by the port")
    bn = back.net_.net.cfg.get_layer_index("bn2")
    keys = sorted(back.net_.canonical_params()[bn]) \
        if direction == "port_to_jax" else sorted(back.net_.params[bn])
    assert keys == (["bias", "running_mean", "running_var", "slope"] if ma
                    else ["bias", "slope"])


def test_bfloat16_keeps_running_statistics_float32(model_files):
    tnet = _load("port", model_files[1], _cfg(1, "compute_dtype = bf16\n"))
    tr = tnet.net_
    bn = tr.net.cfg.get_layer_index("bn1")
    before = tr.params[bn]["running_var"].clone()
    x, y = _batches(1)[0]
    tnet.update(x, y)
    for i, p in enumerate(tr.params):
        for k, v in p.items():
            assert v.dtype == torch.float32, (i, k)
    assert not torch.equal(tr.params[bn]["running_var"], before)
    # the bf16 view of the params casts the weights, not the state
    view = tr.net._cast_params_compute(tr.params)
    assert view[bn]["slope"].dtype == torch.bfloat16
    assert view[bn]["running_mean"].dtype == torch.float32
