"""Small ResNet-18 (``resnet_netconfig`` at depths (2, 2, 2, 2), batch 8,
32x32, 10 classes: batch_norm, add, avg_pooling) through the port on the
CPU against the JAX package, in float32 and under ``compute_dtype =
bfloat16``, by tests/test_torch_googlenet.py's rules and ResNet's bars
there (its docstring gives them, the measured figures and why the head's
weights are scaled in the shared model file)."""

import pytest

from tests.test_torch_googlenet import (NETS, check_bfloat16, check_float32,
                                        check_float32_masters, run_all)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_all("resnet18", tmp_path_factory.mktemp("resnet18"))


def test_float32_forward_and_step_match_jax(runs):
    check_float32(runs, NETS["resnet18"][3])


def test_bfloat16_within_twice_jax_own_error(runs):
    check_bfloat16(runs, worst_tensor=False)


def test_bfloat16_step_keeps_float32_masters(runs):
    check_float32_masters(runs)
