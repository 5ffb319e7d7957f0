"""The pooling and concat layers of the port on the CPU against the JAX
package: ``sum_pooling``, ``avg_pooling`` and ``relu_max_pooling`` with pad
0 and 1 on shapes where the ceil-mode output adds a row and a column, and
``concat`` (dim 3) and ``ch_concat`` (dim 1) with 2-4 inputs, forward and
gradients (jax.vjp against autograd on one seeded upstream gradient), in
float32 to 1e-5 relative plus 1e-5 of the largest magnitude compared (the
reference's PairTest bar; a window sum is added in another order on the two
sides).

avg pooling is the window's sum times 1/(kh kw) whatever the padding,
the ceil-mode extra included (the reference's pooling_layer-inl.hpp:44-46);
one case shows that ``F.avg_pool2d(ceil_mode=True, count_include_pad=True)``
divides the edge windows otherwise, so the port may not take it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cxxnet_tpu.layer import factory as jfactory
from cxxnet_tpu.layer.base import ApplyContext as JContext
from cxxnet_tpu_torch import ops as tops
from cxxnet_tpu_torch.layer import factory as tfactory
from cxxnet_tpu_torch.layer.base import ApplyContext

TOL = 1e-5


def _close(got, want, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


def _layers(name, keys, shapes):
    out = []
    for fac in (jfactory, tfactory):
        lay = fac.create_layer(fac.get_layer_type(name))
        for k, v in keys:
            lay.set_param(k, v)
        out_shape = lay.infer_shape(list(shapes))[0]
        out.append(lay)
    return out[0], out[1], out_shape


def _run(name, keys, shapes, seed=0):
    """(out, input gradients) of the layer in both packages on seeded
    inputs and a seeded upstream gradient."""
    jlay, tlay, out_shape = _layers(name, keys, shapes)
    assert tuple(tlay.infer_shape(list(shapes))[0]) == tuple(out_shape)
    rng = np.random.RandomState(seed)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    g = rng.randn(*out_shape).astype(np.float32)
    jout, vjp = jax.vjp(
        lambda *a: jlay.apply({}, list(a), JContext(train=True))[0],
        *[jnp.asarray(x) for x in xs])
    jdx = vjp(jnp.asarray(g))
    txs = [torch.from_numpy(x).requires_grad_() for x in xs]
    tout = tlay.forward({}, txs, ApplyContext(train=True))[0]
    assert tuple(tout.shape) == tuple(out_shape)
    tout.backward(torch.from_numpy(g))
    _close(tout, jout, "%s out" % name)
    for i, (t, j) in enumerate(zip(txs, jdx)):
        _close(t.grad, j, "%s gradient of input %d" % (name, i))
    return tout


# (kernel, stride, pad, input hw): every case's ceil-mode output runs a
# window past the padded input
POOL_CASES = [(3, 2, 0, (8, 8)), (3, 2, 1, (8, 8)), (2, 2, 0, (7, 5)),
              (3, 1, 1, (6, 6)), (5, 3, 1, (12, 11)), (3, 2, 0, (7, 7))]


@pytest.mark.parametrize("name", ["sum_pooling", "avg_pooling",
                                  "relu_max_pooling", "max_pooling"])
@pytest.mark.parametrize("kernel,stride,pad,hw", POOL_CASES)
def test_pooling_matches_jax(name, kernel, stride, pad, hw):
    keys = [("kernel_size", str(kernel)), ("stride", str(stride)),
            ("pad", str(pad))]
    _run(name, keys, [(3, 4) + hw])


def test_ceil_mode_adds_a_row_and_a_column():
    _, tlay, out_shape = _layers("avg_pooling", [("kernel_size", "3"),
                                                 ("stride", "2")],
                                 [(1, 1, 8, 8)])
    # floor mode would give 3; the reference's ceil mode gives 4
    assert out_shape[2:] == (4, 4)


def test_avg_divisor_is_the_window_size_unlike_avg_pool2d():
    x = torch.ones(1, 1, 8, 8)
    got = tops.pool2d(x, "avg", (3, 3), 2, pad=(1, 1))
    # the corner window holds 4 ones of its 9 slots; a window of the last
    # row 3: its rows are the input's last, the pad and the ceil-mode extra
    assert float(got[0, 0, 0, 0]) == pytest.approx(4 / 9)
    assert float(got[0, 0, -1, 1]) == pytest.approx(3 / 9)
    lib = F.avg_pool2d(x, 3, 2, padding=1, ceil_mode=True,
                       count_include_pad=True)
    assert lib.shape == got.shape
    # F.avg_pool2d leaves the ceil-mode extra row out of its divisor: 3 / 6
    assert float(lib[0, 0, -1, 1]) == pytest.approx(3 / 6)


def test_sum_pooling_in_bfloat16_rounds_the_window_sum_once():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, 9, 9).astype(np.float32)) \
        .to(torch.bfloat16)
    got = tops.pool2d(x, "sum", (3, 3), 2)
    want = tops.pool2d(x.float(), "sum", (3, 3), 2).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,shapes", [
    ("concat", [(2, 1, 1, 5), (2, 1, 1, 3)]),
    ("concat", [(2, 3, 4, 5), (2, 3, 4, 2), (2, 3, 4, 1), (2, 3, 4, 6)]),
    ("ch_concat", [(2, 3, 4, 5), (2, 7, 4, 5)]),
    ("ch_concat", [(2, 64, 3, 3), (2, 128, 3, 3), (2, 32, 3, 3),
                   (2, 32, 3, 3)]),
])
def test_concat_matches_jax(name, shapes):
    out = _run(name, [], shapes)
    dim = 3 if name == "concat" else 1
    assert out.shape[dim] == sum(s[dim] for s in shapes)


@pytest.mark.parametrize("name", ["concat", "ch_concat"])
@pytest.mark.parametrize("n", [1, 5])
def test_concat_takes_two_to_four_inputs(name, n):
    for fac in (jfactory, tfactory):
        lay = fac.create_layer(fac.get_layer_type(name))
        with pytest.raises(ValueError, match="2-4 inputs"):
            lay.infer_shape([(2, 3, 4, 5)] * n)


@pytest.mark.parametrize("name,bad", [("concat", (2, 4, 4, 5)),
                                      ("ch_concat", (2, 3, 4, 6))])
def test_concat_refuses_mismatched_shapes(name, bad):
    lay = tfactory.create_layer(tfactory.get_layer_type(name))
    with pytest.raises(ValueError, match="doesn't match"):
        lay.infer_shape([(2, 3, 4, 5), bad])
