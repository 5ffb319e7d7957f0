"""The ``moe`` layer (mixture of experts, dense dispatch on one device)
on the CPU against the JAX package, by tests/test_torch_layers_more.py's
rules: forward and gradients of inputs, gate and experts, dense and with
``top_k``; the top-k tie resolved as ``jax.lax.top_k`` resolves it; the
model-file bytes (LayerParam, ``<ii`` nexpert and top_k, gate, experts);
a small net with a moe layer trained one SGD step by both packages; and
``expert_parallel`` on one rank, which the port refuses with the JAX
trainer's device-count message (tests/test_torch_dist_train.py runs it over
ranks).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cxxnet_tpu_torch import api as tapi
from tests.test_torch_layers_more import (_close, _layers,
                                          model_file_bytes_equal_jax,
                                          run_layer)
from tests.test_torch_mobilenet import check_float32, jax_and_port

CASES = {
    "dense": ([("nexpert", "4"), ("nhidden", "6")], [(5, 1, 1, 8)]),
    "top2": ([("nexpert", "4"), ("nhidden", "6"), ("top_k", "2")],
             [(5, 1, 1, 8)]),
    "top1_xavier": ([("nexpert", "3"), ("nhidden", "4"), ("top_k", "1"),
                     ("random_type", "xavier")], [(4, 1, 1, 6)]),
    "top_k_is_nexpert": ([("nexpert", "3"), ("nhidden", "4"),
                          ("top_k", "3")], [(4, 1, 1, 6)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_matches_jax(case):
    run_layer("moe", *CASES[case])


def test_moe_top_k_tie_resolves_as_jax_top_k():
    """Experts 1, 2 and 3 take equal gate logits a row (equal gate rows),
    expert 0 a larger one: top_k = 2 keeps experts 0 and 1 in both
    packages, exactly two a row."""
    keys = [("nexpert", "4"), ("nhidden", "3"), ("top_k", "2")]
    jlay, tlay, _ = _layers("moe", keys, [(3, 1, 1, 5)])
    rng = np.random.RandomState(4)
    row = rng.rand(5).astype(np.float32)
    gate = np.stack([row * 2, row, row, row]).astype(np.float32)
    experts = rng.randn(4, 5, 3).astype(np.float32)
    x = rng.rand(3, 5).astype(np.float32)
    tprobs = tlay.gate_probs(torch.from_numpy(x), torch.from_numpy(gate))
    jprobs = np.asarray(jlay._gate_probs(jnp.asarray(x), jnp.asarray(gate)))
    kept = (tprobs > 0).numpy()
    assert (kept.sum(1) == 2).all()
    np.testing.assert_array_equal(kept, jprobs > 0)
    np.testing.assert_array_equal(kept[:, :2], True)
    _close(tprobs, jprobs, "gate")
    run_layer("moe", keys, [(3, 1, 1, 5)],
              params={"gate": gate, "experts": experts})


@pytest.mark.parametrize("case", ["dense", "top2"])
def test_moe_model_file_bytes_equal_jax(case):
    lay = model_file_bytes_equal_jax("moe", *CASES[case])
    assert (lay.n_expert, lay.top_k) == (4, 2 if case == "top2" else 0)


MOE_NET = """netconfig = start
layer[0->h] = fullc:h
  nhidden = 12
layer[h->moe] = moe:moe
  nexpert = 4
  top_k = 2
  nhidden = 10
layer[moe->out] = fullc:out
  nhidden = 3
layer[out->out] = softmax
netconfig = end
input_shape = 1,1,8
batch_size = 6
eta = 0.1
momentum = 0.9
dev = cpu
"""


def test_a_moe_net_trains_as_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(6, 1, 1, 8).astype(np.float32)
    y = rs.randint(0, 3, 6).astype(np.float32)
    check_float32(jax_and_port(MOE_NET, x, y, "moe"))


def test_expert_parallel_is_refused_naming_the_roadmap():
    # ported since: one rank has no second rank for the experts, and the
    # mesh refuses as the JAX trainer's does on one device
    with pytest.raises(ValueError, match="device count 1 must be divisible "
                       "by model_parallel"):
        tapi.Net(dev="cpu", cfg=MOE_NET + "expert_parallel = 2\n") \
            .init_model()
    net = tapi.Net(dev="cpu", cfg=MOE_NET + "expert_parallel = 1\n")
    net.init_model()
