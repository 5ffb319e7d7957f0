"""The port's metrics against the JAX package's MetricSet on the same
scores and labels: the host path (add_eval) and the device path
(device_stats, accumulated, then absorb) must print the same string,
byte for byte. Counts (error, rec@k) are sums of integers and come out
equal; logloss and rmse are float sums, equal here because both sides sum
the same float32 values in float64 on the host, and on the device path
held to relative 1e-6 (float32 sums in another order) before printing,
where %g keeps 6 digits.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu.layer.base import LabelInfo as JLabelInfo
from cxxnet_tpu.utils import metric as jmetric
from cxxnet_tpu_torch.layer.base import LabelInfo as TLabelInfo
from cxxnet_tpu_torch.utils import metric as tmetric

K = 10


def _batch(seed, n=40):
    rng = np.random.RandomState(seed)
    scores = rng.randn(n, K).astype(np.float32)
    probs = np.exp(scores) / np.exp(scores).sum(1, keepdims=True)
    label = rng.randint(0, K, size=(n, 1)).astype(np.float32)
    # a second field: a K-wide regression target, for rmse
    vec = rng.randn(n, K).astype(np.float32)
    return probs.astype(np.float32), np.concatenate([label, vec], axis=1)


def _fields(labels, wrap):
    return wrap({"label": labels[:, :1], "vec": labels[:, 1:]})


# (metric name, label field); each metric reads the softmax probabilities
# except rmse, which is held to the K-wide "vec" field
METRICS = [("error", "label"), ("rec@1", "label"), ("rec@5", "label"),
           ("logloss", "label"), ("rmse", "vec")]


def _sets():
    js, ts = jmetric.MetricSet(), tmetric.MetricSet()
    for name, field in METRICS:
        js.add_metric(name, field)
        ts.add_metric(name, field)
    return js, ts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_path_prints_the_same(seed):
    js, ts = _sets()
    for b in range(3):
        probs, labels = _batch(seed * 10 + b)
        js.add_eval([probs] * len(METRICS), _fields(labels, JLabelInfo))
        ts.add_eval([probs] * len(METRICS), _fields(labels, TLabelInfo))
    got, want = ts.print_str("test"), js.print_str("test")
    assert got == want
    assert "test-rec@5:" in got and "test-rmse[vec]:" in got


def test_device_path_prints_the_same():
    js, ts = _sets()
    jacc = tacc = None
    for b in range(3):
        probs, labels = _batch(100 + b)
        jst = np.asarray(js.device_stats([probs] * len(METRICS),
                                         _fields(labels, JLabelInfo)))
        tst = ts.device_stats([torch.from_numpy(probs)] * len(METRICS),
                              _fields(torch.from_numpy(labels), TLabelInfo))
        assert tst.shape == (len(METRICS), 2) and tst.dtype == torch.float32
        np.testing.assert_allclose(tst.numpy(), jst, rtol=1e-6, atol=0)
        jacc = jst if jacc is None else jacc + jst
        tacc = tst if tacc is None else tacc + tst
    # %g prints 6 significant digits, which these sums share
    js.absorb(jacc)
    ts.absorb(tacc.numpy())
    assert ts.print_str("train") == js.print_str("train")


def test_device_path_agrees_with_host_path():
    _, host = _sets()
    _, dev = _sets()
    probs, labels = _batch(7)
    host.add_eval([probs] * len(METRICS), _fields(labels, TLabelInfo))
    dev.absorb(dev.device_stats([torch.from_numpy(probs)] * len(METRICS),
                                _fields(torch.from_numpy(labels),
                                        TLabelInfo)).numpy())
    for h, d in zip(host.evals, dev.evals):
        assert d.cnt_inst == h.cnt_inst
        np.testing.assert_allclose(d.get(), h.get(), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 5])
def test_device_rec_at_k_ranks_ties_like_jax(k):
    """Tied scores (a softmax row underflowed to zeros, or equal logits)
    rank by ascending index on both sides, as jax.lax.top_k ranks them."""
    rng = np.random.RandomState(3)
    probs = np.zeros((64, K), np.float32)
    probs[16:32] = 0.25
    probs[32:48, ::3] = 0.5
    probs[48:] = rng.rand(16, K).astype(np.float32)
    labels = np.tile(np.arange(K, dtype=np.float32), 7)[:64, None]
    jm, tm = jmetric.MetricRecall("rec@%d" % k), \
        tmetric.MetricRecall("rec@%d" % k)
    want = np.asarray(jm.device_stats(probs, labels))
    got = tm.device_stats(torch.from_numpy(probs), torch.from_numpy(labels))
    np.testing.assert_array_equal(np.asarray([float(g) for g in got]), want)


@pytest.mark.parametrize("name", ["error", "logloss"])
def test_one_wide_predictions(name):
    rng = np.random.RandomState(3)
    pred = rng.rand(30, 1).astype(np.float32) * 0.98 + 0.01
    if name == "error":
        pred = pred - 0.5
    labels = (rng.rand(30, 1) > 0.5).astype(np.float32)
    jm, tm = jmetric.create_metric(name), tmetric.create_metric(name)
    jm.add_eval(pred, labels)
    tm.add_eval(pred, labels)
    assert (tm.sum_metric, tm.cnt_inst) == (jm.sum_metric, jm.cnt_inst)
    s, c = tm.device_stats(torch.from_numpy(pred), torch.from_numpy(labels))
    np.testing.assert_allclose(float(s), jm.sum_metric, rtol=1e-6)
    assert float(c) == 30


def test_bad_metrics_raise():
    ts = tmetric.MetricSet()
    with pytest.raises(ValueError, match="unknown metric"):
        ts.add_metric("auc")
    with pytest.raises(ValueError, match="rec@n"):
        tmetric.create_metric("rec@x")
    with pytest.raises(ValueError, match="meaningless"):
        tmetric.create_metric("rec@20").add_eval(
            np.zeros((2, 5), np.float32), np.zeros((2, 1), np.float32))
    ts.add_metric("error")
    with pytest.raises(ValueError, match="number of predict scores"):
        ts.add_eval([], TLabelInfo({"label": np.zeros((1, 1))}))
