"""Small ViT through the port on the CPU against the JAX package:
``vit_config`` at ``image_hw = 48``, patch 4 (144 positions, so the
port's attention takes the flash route, its plain version on the CPU),
dim 32, 2 heads (head dim 16), 2 blocks, batch 4, 10 classes, AdamW: the
patch-embedding conv, im2seq, batch_norm with moving averages, RoPE
attention that is not causal, the 1x1-conv FFN, the mean pool over the
positions.

The JAX trainer makes the weights, ``convert.params_from_jax`` carries
them, and both packages take the same training forward and one update,
held by tests/test_torch_mobilenet.py's float32 bars (measured: every
gradient within 1.7e-6 of its own largest), the weights after the AdamW
step by check_float32's Adam rule: within 1e-2 of eta where the gradient
stands above its bar (tests/test_torch_lm_train.py's bar). One weight of
the patch embedding shows why the rest is held only to the largest step:
its gradient is -3.14e-8 in JAX and -2.82e-8 in the port (1.4e-7 of the
tensor's largest, 2.34e-2), and AdamW's first step moved it by 2.271e-3
and 2.209e-3. The JAX side runs its dense
attention (no TPU here) and, in a second case, its Pallas flash kernels
forced on in interpret mode, as tests/test_flash_attention.py forces
them. bfloat16 by tests/test_torch_googlenet.py's rule.
"""

import pytest

from cxxnet_tpu import models as jmodels
from cxxnet_tpu import ops as jops
from cxxnet_tpu_torch import models as tmodels
from cxxnet_tpu_torch.ops import flash_attn
from tests.test_torch_googlenet import check_bfloat16, check_float32_masters
from tests.test_torch_mobilenet import (bf16_runs, check_float32,
                                        jax_and_port, seeded_batch)

SMALL = dict(n_class=10, image_hw=48, patch=4, batch_size=4, dim=32,
             nhead=2, nlayer=2, dev="cpu")
SHAPE = (4, 3, 48, 48)


def small_cfg(extra=""):
    return tmodels.vit_config(extra_cfg=extra, **SMALL)


def test_builders_write_the_jax_text():
    for kw in (dict(n_class=10, image_hw=48, patch=4, dim=32, nhead=2,
                    nlayer=2),
               dict(n_class=1000, image_hw=224, patch=16, dim=384, nhead=6,
                    nlayer=12, ffn_mult=4)):
        assert tmodels.vit_netconfig(**kw) == jmodels.vit_netconfig(**kw)
    # the block with and without its norms
    for norm in (False, True):
        assert tmodels._transformer_block("b", "x", 32, 2, 64, "rope = 1\n",
                                          norm=norm) == \
            jmodels._transformer_block("b", "x", 32, 2, 64, "rope = 1\n",
                                       norm=norm)


def test_the_small_vit_takes_the_flash_route():
    assert (48 // 4) ** 2 == 144 and flash_attn.supports(144, 32 // 2)
    # bench.py's ViT-S/16: 196 positions, head dim 64
    assert flash_attn.supports((224 // 16) ** 2, 384 // 6)


@pytest.mark.parametrize("jax_flash", [False, True],
                         ids=["jax_dense", "jax_flash_interpret"])
def test_float32_forward_and_step_match_jax(jax_flash):
    x, y = seeded_batch(SHAPE, 10)
    jops.set_use_pallas(True if jax_flash else None)
    try:
        r = jax_and_port(small_cfg(), x, y, "gp")
    finally:
        jops.set_use_pallas(None)
    check_float32(r, layer_scale=False, adam_eta=0.003)


@pytest.fixture(scope="module")
def runs_bf16(tmp_path_factory):
    x, y = seeded_batch(SHAPE, 10)
    return bf16_runs(small_cfg, x, y, "gp", tmp_path_factory.mktemp("vit"))


def test_bfloat16_within_twice_jax_own_error(runs_bf16):
    check_bfloat16(runs_bf16, worst_tensor=False)


def test_bfloat16_step_keeps_float32_masters(runs_bf16):
    check_float32_masters(runs_bf16)
