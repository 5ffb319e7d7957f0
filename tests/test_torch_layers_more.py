"""The rest of the layer set on the CPU against the JAX package: ``tanh``,
``softplus``, ``bias``, ``fixconn``, ``maxout`` (channel groups and the
flat case), ``im2seq``, ``moe`` (dense and top-k) and the ``l2_loss`` and
``multi_logistic`` losses (``moe`` in tests/test_torch_moe.py), and a
net of them all trained one step by both packages.

Each case builds the layer in both packages from the same keys and input
shapes, gives both the same seeded inputs, weights, labels and upstream
gradient, and holds the port's output and every gradient (of the inputs,
and of the weights) to jax.vjp's, in float32 within 1e-5 relative plus
1e-5 of the largest magnitude compared (the reference's PairTest bar; the
two sum products in other orders); for a weight's gradient, of the
larger of its own and the layer's largest gradient (top_k = 1's gate
gradient is zero in exact arithmetic, rounding noise of 1e-9 in JAX and
0 in the port). A loss layer's loss is held to
relative 1e-5 and its gradient is the loss's. Each layer with weights
writes the JAX layer's model-file bytes for the same weights, and reads
the JAX layer's bytes back to the same weights.

softplus is jax.nn.softplus's formula, max(x, 0) + log1p(exp(-|x|)), with
its gradient exp(x - out), not ``F.softplus``'s rule (log1p(exp(x)) up to
a threshold, x above it); ``test_softplus_is_the_jax_formula`` states
where the two differ. ``fixconn`` reads
its sparse text file as the JAX layer does, refuses the same bad files,
and gives its weight no gradient. ``moe``'s top-k keeps exactly k experts
a row, ties taken in index order as ``jax.lax.top_k`` takes them.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cxxnet_tpu import api as japi
from cxxnet_tpu.layer import factory as jfactory
from cxxnet_tpu.layer.base import ApplyContext as JContext
from cxxnet_tpu.layer.base import LabelInfo as JLabels
from cxxnet_tpu.utils import serializer as jser
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import ops as tops
from cxxnet_tpu_torch.layer import factory as tfactory
from cxxnet_tpu_torch.layer.base import ApplyContext, LabelInfo
from cxxnet_tpu_torch.utils import serializer as tser

TOL = 1e-5


def _close(got, want, what="", scale=None):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _layers(name, keys, shapes):
    """(JAX layer, port layer, output shapes) of ``name`` configured by
    ``keys`` on input ``shapes``."""
    out = []
    for fac in (jfactory, tfactory):
        lay = fac.create_layer(fac.get_layer_type(name))
        for k, v in keys:
            lay.set_param(k, v)
        out.append((lay, [tuple(s) for s in lay.infer_shape(list(shapes))]))
    (jlay, jshapes), (tlay, tshapes) = out
    assert jshapes == tshapes
    return jlay, tlay, tshapes


def _weights(jlay, tlay, rng, frozen=()):
    """The JAX layer's initial weights, every one not in ``frozen``
    replaced by seeded normals of its shape; the port declares the same
    keys and shapes."""
    p = {k: np.asarray(v, np.float32)
         for k, v in jlay.init_params(np.random.RandomState(0)).items()}
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(s) for k, s in tlay.param_shapes().items()}
    return {k: v if k in frozen else rng.randn(*v.shape).astype(np.float32)
            for k, v in p.items()}


def _labels(label):
    if label is None:
        return None, None
    return (JLabels({"label": jnp.asarray(label)}),
            LabelInfo({"label": torch.from_numpy(label)}))


def run_layer(name, keys, shapes, seed=0, label=None, scale=1.0,
              frozen=(), params=None):
    """Forward and gradients of the layer in both packages, compared;
    returns (port layer, JAX layer, weights)."""
    jlay, tlay, out_shapes = _layers(name, keys, shapes)
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
    p = params if params is not None else _weights(jlay, tlay, rng, frozen)
    g = [rng.randn(*s).astype(np.float32) for s in out_shapes]
    jl, tl = _labels(label)

    def jfn(xs_, p_):
        ctx = JContext(train=True, labels=jl)
        outs = jlay.apply(p_, list(xs_), ctx)
        return outs, (sum(ctx.losses) if ctx.losses else 0.0)

    (jouts, jloss), vjp = jax.vjp(
        jfn, [jnp.asarray(x) for x in xs],
        {k: jnp.asarray(v) for k, v in p.items()})
    if label is None:
        jdx, jdp = vjp(([jnp.asarray(a) for a in g], 0.0))
    else:
        # the loss layers' gradient is the loss's
        jdx, jdp = vjp(([jnp.zeros_like(o) for o in jouts], 1.0))
    txs = [torch.from_numpy(x).requires_grad_() for x in xs]
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    ctx = ApplyContext(train=True, labels=tl)
    touts = tlay.forward(tp, txs, ctx)
    for o, s in zip(touts, out_shapes):
        assert tuple(o.shape) == s
    for i, (a, b) in enumerate(zip(touts, jouts)):
        _close(a, b, "%s output %d" % (name, i))
    if label is None:
        torch.autograd.backward(touts, [torch.from_numpy(a) for a in g])
    else:
        loss = sum(ctx.losses)
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=TOL)
        loss.backward()
    for i, (t, j) in enumerate(zip(txs, jdx)):
        _close(t.grad, j, "%s gradient of input %d" % (name, i))
    # a weight gradient that is zero in exact arithmetic (top_k = 1's
    # gate, p / p) is rounding noise in JAX: the bar's absolute part is
    # then 1e-5 of the layer's largest gradient
    largest = max(float(np.abs(np.asarray(a)).max())
                  for a in list(jdx) + list(jdp.values()))
    for k, t in tp.items():
        want = np.asarray(jdp[k])
        got = t.grad if t.grad is not None else torch.zeros_like(t)
        _close(got, want, "%s gradient of %s" % (name, k),
               scale=max(float(np.abs(want).max()), largest))
    return tlay, jlay, p


def fixconn_file(path, nrow, ncol, entries):
    with open(path, "w") as f:
        f.write("%d %d %d\n" % (nrow, ncol, len(entries)))
        for r, c, v in entries:
            f.write("%d %d %r\n" % (r, c, v))
    return str(path)


def _fixconn_keys(tmp_path):
    rng = np.random.RandomState(7)
    entries = [(int(r), int(c), float(np.float32(rng.randn())))
               for r, c in {(rng.randint(5), rng.randint(6))
                            for _ in range(12)}]
    return [("nhidden", "5"), ("fixconn_weight",
                               fixconn_file(tmp_path / "w.txt", 5, 6,
                                            sorted(entries)))]


# (name, keys, input shapes, input scale)
CASES = {
    "tanh": ("tanh", [], [(2, 3, 4, 5)], 2.0),
    "softplus": ("softplus", [], [(2, 3, 4, 5)], 8.0),
    "bias": ("bias", [("init_bias", "0.5")], [(3, 1, 1, 7)], 1.0),
    "maxout": ("maxout", [("ngroup", "2")], [(2, 6, 3, 4)], 1.0),
    "maxout_flat": ("maxout", [("ngroup", "4")], [(3, 1, 1, 8)], 1.0),
    "im2seq": ("im2seq", [], [(2, 5, 3, 4)], 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    name, keys, shapes, scale = CASES[case]
    run_layer(name, keys, shapes, scale=scale)


def test_fixconn_matches_jax_and_takes_no_weight_gradient(tmp_path):
    keys = _fixconn_keys(tmp_path)
    tlay, jlay, p = run_layer("fixconn", keys, [(3, 1, 1, 6)],
                              frozen=("wmat",))
    # the weight is the file's, and its gradient is zero in both
    want = np.zeros((5, 6), np.float32)
    with open(dict(keys)["fixconn_weight"]) as f:
        toks = f.read().split()
    for i in range(int(toks[2])):
        want[int(toks[3 + 3 * i]), int(toks[4 + 3 * i])] = \
            float(toks[5 + 3 * i])
    np.testing.assert_array_equal(p["wmat"], want)
    np.testing.assert_array_equal(
        tlay.init_params(torch.Generator()).get("wmat").numpy(), want)
    assert tlay.visit_order() == jlay.visit_order() == []


@pytest.mark.parametrize("bad, msg", [
    ((4, 6, [(0, 0, 1.0)]), "shape do not match"),
    ((5, 6, [(5, 0, 1.0)]), "index exceed"),
    ((5, 6, [(0, -1, 1.0)]), "index exceed"),
])
def test_fixconn_refuses_the_files_jax_refuses(tmp_path, bad, msg):
    path = fixconn_file(tmp_path / "bad.txt", *bad)
    for fac in (jfactory, tfactory):
        lay = fac.create_layer(fac.get_layer_type("fixconn"))
        lay.set_param("nhidden", "5")
        lay.set_param("fixconn_weight", path)
        with pytest.raises(ValueError, match=msg):
            lay.infer_shape([(2, 1, 1, 6)])
    lay = tfactory.create_layer(tfactory.get_layer_type("fixconn"))
    lay.set_param("nhidden", "5")
    with pytest.raises(ValueError, match="must specify fixconn_weight"):
        lay.infer_shape([(2, 1, 1, 6)])


LOSS_CASES = {
    "l2_loss": ("l2_loss", [("batch_size", "4"), ("grad_scale", "0.5")],
                (4, 1, 1, 6), lambda r: r.randn(4, 6)),
    "l2_loss_conv_node": ("l2_loss", [("batch_size", "2"),
                                      ("update_period", "2")],
                          (2, 2, 1, 3), lambda r: r.randn(2, 6)),
    "multi_logistic": ("multi_logistic", [("batch_size", "4")],
                       (4, 1, 1, 6), lambda r: r.randint(0, 2, (4, 6))),
    "multi_logistic_soft": ("multi_logistic",
                            [("batch_size", "8"), ("grad_scale", "3")],
                            (4, 1, 1, 5), lambda r: r.rand(4, 5)),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_layer_matches_jax(case):
    name, keys, shape, label = LOSS_CASES[case]
    lab = label(np.random.RandomState(9)).astype(np.float32)
    run_layer(name, keys, [shape], label=lab, scale=4.0)


def test_loss_layer_without_labels_is_its_transform():
    x = np.random.RandomState(2).randn(3, 1, 1, 4).astype(np.float32)
    for name, want in (("l2_loss", x), ("multi_logistic",
                                        1 / (1 + np.exp(-x)))):
        lay = tfactory.create_layer(tfactory.get_layer_type(name))
        lay.infer_shape([x.shape])
        ctx = ApplyContext()
        out = lay.forward({}, [torch.from_numpy(x)], ctx)[0]
        assert not ctx.losses
        _close(out, want, name)


def model_file_bytes_equal_jax(name, keys, shapes):
    """The port writes the JAX layer's bytes for the same weights and
    reads the JAX layer's bytes back to them (LayerParam included)."""
    jlay, tlay, _ = _layers(name, keys, shapes)
    p = _weights(jlay, tlay, np.random.RandomState(3),
                 frozen=("wmat",) if name == "fixconn" else ())
    jw, tw = jser.Writer(), tser.Writer()
    jlay.save_model(jw, p)
    tlay.save_model(tw, p)
    blob = jw.getvalue()
    assert tw.getvalue() == blob
    fresh = tfactory.create_layer(tfactory.get_layer_type(name))
    got = fresh.load_model(tser.Reader(blob))
    assert sorted(got) == sorted(p)
    for k in p:
        np.testing.assert_array_equal(got[k], p[k])
    again = tser.Writer()
    fresh.save_model(again, got)
    assert again.getvalue() == blob
    return fresh


@pytest.mark.parametrize("case", ["bias", "fixconn"])
def test_model_file_bytes_equal_jax(case, tmp_path):
    if case == "fixconn":
        model_file_bytes_equal_jax("fixconn", _fixconn_keys(tmp_path),
                                   [(3, 1, 1, 6)])
    else:
        model_file_bytes_equal_jax(*CASES[case][:3])


def test_softplus_is_the_jax_formula():
    """The port's softplus is within 1e-5 of jax.nn.softplus, value and
    gradient, from -104 to 88 (measured: 2 float32 ulps at most, 57 of
    4,009 values; torch's and XLA's exp and log1p round apart), and takes
    jax's gradient at 0, 1/2.
    ``F.softplus`` at its default threshold 20 lands as close in float32
    (2 ulps, 100 values): past 20 JAX's log1p(exp(-x)) term is below half
    an ulp of x. Its rule departs from JAX's formula below that: at
    threshold 5 it returns x itself from 5 on, thousands of ulps off."""
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        [0.0, -0.0, 1e-8, -1e-8, 20.0, 20.5, 88.0, -104.0]]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = tops.softplus(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=0)
    got.sum().backward()
    jgrad = np.asarray(jax.grad(lambda a: jax.nn.softplus(a).sum())(
        jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=TOL, atol=0)
    np.testing.assert_array_equal(xt.grad.numpy()[x == 0], 0.5)
    lib = F.softplus(torch.from_numpy(x), threshold=5.0).numpy()
    past = (x > 5) & (x <= 20)
    np.testing.assert_array_equal(lib[past], x[past])
    assert (np.abs(lib[past] - want[past]) > TOL * want[past]).any()


def misc_netconfig(fixconn_path, extern=""):
    """A small net of every new layer type but extern (``extern``: the
    lines of an extern layer on the im2seq node ``sq``, writing ``ex``):
    tanh, maxout, im2seq, moe with top_k, softplus, fixconn, bias, and
    the multi_logistic and l2_loss heads on a split."""
    seq = "ex" if extern else "sq"
    return """netconfig = start
layer[0->t] = tanh
layer[t->m] = maxout
  ngroup = 2
layer[m->sq] = im2seq
%slayer[%s->f] = flatten
layer[f->moe] = moe:moe
  nexpert = 4
  top_k = 2
  nhidden = 16
layer[moe->sp] = softplus
layer[sp->fx] = fixconn:fx
  nhidden = 12
  fixconn_weight = %s
layer[fx->fx] = bias:b
  init_bias = 0.1
layer[fx->s1,s2] = split
layer[s1->o1] = fullc:o1
  nhidden = 5
layer[o1->o1] = multi_logistic
  target = ml
layer[s2->o2] = fullc:o2
  nhidden = 3
layer[o2->o2] = l2_loss
  target = l2
netconfig = end
input_shape = 4,6,6
batch_size = 4
label_vec[0,5) = ml
label_vec[5,8) = l2
eta = 0.1
momentum = 0.9
wd = 0.0001
dev = cpu
""" % (extern, seq, fixconn_path)


def misc_batch(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(4, 4, 6, 6).astype(np.float32)
    y = np.concatenate([rs.randint(0, 2, (4, 5)), rs.randn(4, 3)],
                       axis=1).astype(np.float32)
    return x, y


def misc_fixconn(tmp_path):
    rng = np.random.RandomState(8)
    cells = sorted({(int(rng.randint(12)), int(rng.randint(16)))
                    for _ in range(40)})
    return fixconn_file(tmp_path / "fx.txt", 12, 16,
                        [(r, c, float(np.float32(rng.randn() * 0.3)))
                         for r, c in cells])


def test_a_net_of_the_new_layers_trains_as_jax(tmp_path):
    """One training forward and one SGD update of the net, as
    tests/test_torch_mobilenet.py holds a net; the fixconn weight does not
    move."""
    from tests.test_torch_mobilenet import check_float32, jax_and_port
    cfg = misc_netconfig(misc_fixconn(tmp_path))
    x, y = misc_batch()
    r = jax_and_port(cfg, x, y, "moe")
    check_float32(r, layer_scale=True)
    fx = 6   # the fixconn connection
    assert r["port"][4][fx]["wmat"].shape == (12, 16)
    np.testing.assert_array_equal(r["port"][3][fx]["wmat"].numpy(),
                                  r["port"][4][fx]["wmat"])


def test_a_net_of_the_new_layers_saves_the_jax_bytes(tmp_path):
    cfg = misc_netconfig(misc_fixconn(tmp_path))
    jn = japi.Net(dev="cpu", cfg=cfg)
    jn.init_model()
    jn.save_model(str(tmp_path / "jax.model"))
    tn = tapi.Net(dev="cpu", cfg=cfg)
    tn.load_model(str(tmp_path / "jax.model"))
    tn.save_model(str(tmp_path / "port.model"))
    assert (tmp_path / "port.model").read_bytes() == \
        (tmp_path / "jax.model").read_bytes()
    x, _ = misc_batch(1)
    np.testing.assert_allclose(tn.predict(x), jn.predict(x))
    _close(tn.extract(x, "moe"), jn.extract(x, "moe"), "moe node")
