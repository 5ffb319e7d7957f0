"""The port's CUDA kernels against their plain PyTorch versions, on the
card, and the paths that must go through them. Every test here needs a
CUDA card and skips without one. The file imports nothing of JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 to relative 1e-5 (the reference's PairTest bar); the bf16
output to 2e-2 (kernel and plain version round the same f32 value to bf16,
and an f32 ulp of difference can move that by one bf16 ulp, 2^-8); the f32
norm always to 1e-5, and bit for bit where a test says so (the kernel
sums each window in the plain version's order). The backward's dx gets,
beside these, an absolute 8 f32 epsilons of its largest magnitude: dx is
the difference of two terms that can cancel, and where an element passes
near zero the few ulps by which the two versions' terms differ (the
kernel's powf and PyTorch's pow may round apart) are a large relative
error.

The flash attention kernel against flash_fwd_ref: out to the same rtol
(1e-5 fp32, 2e-2 bf16) plus 8 f32 epsilons of its largest magnitude (out
is a convex combination of v rows, summed blockwise with an online rescale
in the kernel and densely in the plain version); lse, f32 in both, to rtol
1e-5 plus 8 epsilons of its largest magnitude. The backward kernels
against flash_bwd_ref: dq, dk, dv within 1e-5 (fp32) or 2e-2 (bf16) of
their largest magnitude; an LM step's gradients with the kernels against
the step with flash_bwd_ref swapped in within 1e-4 of each tensor's
largest magnitude (the difference passes back through every block, and
the embedding's gradient is a scatter-add whose order may change).
The convolution's weight gradient (ops.conv2d_weight) against float64:
1e-5 of its largest element. The uniform kernel against uniform_ref,
and its per-row entry point against uniform_rows_ref: bitwise (both
compute the same integer function of (seed, index), (seed, position, row,
index)). A small LM's dense and paged sessions on the card equal solo
generate token for token, greedy and sampled (fp32: near-ties are not
expected at these margins; the bench.py LM's bf16 sessions, where they
are, are checked in chip_smoke.py with their near-tie rule). One
RReLU AlexNet step on the card against the CPU path, noise on (both draw
the same bits), dropout off: every parameter within relative 1e-5 plus
1e-4 of the tensor's largest update (cuDNN and the CPU sum every conv and
fullc in other orders). The pinned feed: a step on a numpy batch, which
crosses through the trainer's staging ring, bitwise the step on the same
batch copied to the card synchronously (fp32 and uint8, cuDNN
deterministic); a ring slot never refilled before its copy ran.
The command line on a small imgbin + LRN config held to api.Net.update on
the same batches to relative 1e-5 plus 1e-5 of each tensor's largest
update.
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch import api, models, ops
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.ops import flash_attn, lrn
from cxxnet_tpu_torch.ops import random as trandom
from cxxnet_tpu_torch.ops import ring_flash
from cxxnet_tpu_torch.parallel import ring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGS = dict(nsize=5, alpha=0.001, beta=0.75, knorm=1.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(4, 96, 27, 27), (4, 256, 13, 13),
                                   (3, 7, 5, 5), (2, 1, 1, 33)])
@pytest.mark.parametrize("nsize", [1, 3, 5])
def test_lrn_kernel_matches_plain(card, shape, dtype, rtol, nsize):
    x = torch.from_numpy(np.random.RandomState(5).randn(*shape)
                         .astype(np.float32) * 3).to(card, dtype)
    args = dict(ARGS, nsize=nsize)
    before = lrn.launches
    out, norm = lrn.lrn_fwd_cuda(x, **args)
    torch.cuda.synchronize()
    assert lrn.launches == before + 1
    assert out.dtype == dtype and norm.dtype == torch.float32
    ref_out, ref_norm = lrn.lrn_ref_with_norm(x, **args)
    torch.testing.assert_close(norm, ref_norm, rtol=1e-5, atol=0)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=rtol,
                               atol=0)


@pytest.mark.cuda
def test_lrn_dispatch_launches_kernel_and_has_no_backward(card):
    # the name is the first slice's, when the backward raised; now the
    # backward launches its kernel, once per backward, on a gradient that
    # autograd may hand over non-contiguous
    x = torch.randn(2, 8, 3, 3, device=card, requires_grad=True)
    before = (lrn.launches, lrn.bwd_launches)
    out = lrn.forward(x, 5, 0.001, 0.75, 1.0)
    assert (lrn.launches, lrn.bwd_launches) == (before[0] + 1, before[1])
    g = torch.randn(2, 8, 3, 3, device=card).transpose(2, 3)
    assert not g.is_contiguous()
    out.backward(g)
    torch.cuda.synchronize()
    assert (lrn.launches, lrn.bwd_launches) == (before[0] + 1, before[1] + 1)
    _, norm = lrn.lrn_ref_with_norm(x.detach(), 5, 0.001, 0.75, 1.0)
    want = lrn.lrn_bwd_ref(x.detach(), norm, g.contiguous(), 5, 0.001, 0.75)
    _assert_dx_close(x.grad, want, 1e-5)


def _assert_dx_close(got, want, rtol):
    atol = 8 * torch.finfo(torch.float32).eps * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(4, 96, 27, 27), (4, 256, 13, 13),
                                   (2, 7, 5, 5), (2, 16, 3, 4),
                                   (2, 1, 1, 33)])
@pytest.mark.parametrize("nsize", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("alpha, knorm", [(0.001, 1.0), (1.0, 0.1)])
def test_lrn_bwd_kernel_matches_plain(card, shape, dtype, rtol, nsize,
                                      alpha, knorm):
    # (alpha 1, knorm 0.1): the window term is a large part of the norm,
    # so a wrong window (the forward's instead of the mirrored one, which
    # differ at even nsize) shows far above the tolerance
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3) \
        .to(card, dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(card, dtype)
    _, norm = lrn.lrn_fwd_cuda(x, nsize, alpha, 0.75, knorm)
    before = lrn.bwd_launches
    dx = lrn.lrn_bwd_cuda(x, norm, g, nsize, alpha, 0.75)
    torch.cuda.synchronize()
    assert lrn.bwd_launches == before + 1
    assert dx.dtype == dtype and dx.shape == x.shape
    _assert_dx_close(dx, lrn.lrn_bwd_ref(x, norm, g, nsize, alpha, 0.75),
                     rtol)


@pytest.mark.cuda
def test_lrn_bwd_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros(1, 4, 2, 2, device=card)
    norm = torch.ones_like(x)
    g = torch.zeros_like(x)
    with pytest.raises(ValueError, match="g contiguous"):
        lrn.lrn_bwd_cuda(x, norm, g.transpose(2, 3), 3, 0.001, 0.75)
    with pytest.raises(ValueError, match="g contiguous"):
        lrn.lrn_bwd_cuda(x, norm, g.bfloat16(), 3, 0.001, 0.75)
    with pytest.raises(ValueError, match="g contiguous"):
        lrn.lrn_bwd_cuda(x, norm, g[:, :2], 3, 0.001, 0.75)
    with pytest.raises(ValueError, match="float32 norm"):
        lrn.lrn_bwd_cuda(x.bfloat16(), norm.bfloat16(), g.bfloat16(), 3,
                         0.001, 0.75)
    with pytest.raises(ValueError, match="float32 norm"):
        lrn.lrn_bwd_cuda(x, norm.cpu(), g, 3, 0.001, 0.75)
    with pytest.raises(TypeError):
        lrn.lrn_bwd_cuda(x.double(), norm, g.double(), 3, 0.001, 0.75)


@pytest.mark.cuda
def test_lrn_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(TypeError):
        lrn.lrn_fwd_cuda(torch.zeros(1, 4, 2, 2, device=card,
                                     dtype=torch.float64), **ARGS)
    with pytest.raises(ValueError, match="contiguous"):
        lrn.lrn_fwd_cuda(torch.zeros(1, 2, 2, 4, device=card)
                         .transpose(1, 3), **ARGS)
    with pytest.raises(ValueError, match="4-D"):
        lrn.lrn_fwd_cuda(torch.zeros(4, 2, 2, device=card), **ARGS)


# every shape the LRN tests above take
LRN_SHAPES = [(4, 96, 27, 27), (4, 256, 13, 13), (3, 7, 5, 5), (2, 1, 1, 33),
              (2, 7, 5, 5), (2, 16, 3, 4)]
CT = lrn.CHANNEL_TILE
# channel counts around the kernels' channel tile, B = 1, and windows of 9,
# 17 and wider than C
LRN_EDGES = [(1, CT - 1, 5, 5), (1, CT, 3, 3), (2, CT + 1, 3, 5),
             (1, 2 * CT + 1, 7, 7), (1, 5, 3, 3), (1, 1, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LRN_SHAPES, ids=str)
@pytest.mark.parametrize("nsize", [1, 2, 3, 4, 5])
def test_lrn_norm_is_bitwise_the_plain_version(card, shape, dtype, nsize):
    # the kernel sums each window in f32 in ascending channel order, as
    # _window_sum does, and forms (s * salpha) + knorm without contraction
    x = torch.from_numpy(np.random.RandomState(11).randn(*shape)
                         .astype(np.float32) * 3).to(card, dtype)
    for alpha, knorm in ((0.001, 1.0), (1.0, 0.1)):
        _, norm = lrn.lrn_fwd_cuda(x, nsize, alpha, 0.75, knorm)
        torch.cuda.synchronize()
        _, ref = lrn.lrn_ref_with_norm(x, nsize, alpha, 0.75, knorm)
        assert torch.equal(norm, ref), float((norm - ref).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", LRN_EDGES, ids=str)
@pytest.mark.parametrize("nsize", [9, 17])
def test_lrn_kernels_at_the_tile_edges(card, shape, dtype, rtol, nsize):
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3) \
        .to(card, dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(card, dtype)
    out, norm = lrn.lrn_fwd_cuda(x, nsize, 1.0, 0.75, 0.1)
    dx = lrn.lrn_bwd_cuda(x, norm, g, nsize, 1.0, 0.75)
    torch.cuda.synchronize()
    ref_out, ref_norm = lrn.lrn_ref_with_norm(x, nsize, 1.0, 0.75, 0.1)
    assert torch.equal(norm, ref_norm)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=rtol,
                               atol=0)
    _assert_dx_close(dx, lrn.lrn_bwd_ref(x, norm, g, nsize, 1.0, 0.75), rtol)


@pytest.mark.cuda
def test_lrn_kernels_at_the_widest_window(card):
    # MAX_NSIZE stages rows in more than 48 KB of shared memory (the
    # opt-in path); one more is refused before any launch
    n = lrn.MAX_NSIZE
    rng = np.random.RandomState(17)
    x = torch.from_numpy(rng.randn(2, 2 * n, 3, 3).astype(np.float32) * 3) \
        .to(card)
    g = torch.from_numpy(rng.randn(2, 2 * n, 3, 3).astype(np.float32)) \
        .to(card)
    out, norm = lrn.lrn_fwd_cuda(x, n, 1.0, 0.75, 0.1)
    dx = lrn.lrn_bwd_cuda(x, norm, g, n, 1.0, 0.75)
    torch.cuda.synchronize()
    ref_out, ref_norm = lrn.lrn_ref_with_norm(x, n, 1.0, 0.75, 0.1)
    assert torch.equal(norm, ref_norm)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=0)
    _assert_dx_close(dx, lrn.lrn_bwd_ref(x, norm, g, n, 1.0, 0.75), 1e-5)
    before = (lrn.launches, lrn.bwd_launches)
    with pytest.raises(ValueError, match="local_size <= %d" % n):
        lrn.lrn_fwd_cuda(x, n + 1, 1.0, 0.75, 0.1)
    with pytest.raises(ValueError, match="local_size <= %d" % n):
        lrn.lrn_bwd_cuda(x, norm, g, n + 1, 1.0, 0.75)
    assert (lrn.launches, lrn.bwd_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 96, 27, 27), (4, 256, 13, 13),
                                   (2, CT + 1, 3, 5)], ids=str)
def test_lrn_forward_without_norm(card, shape, dtype):
    x = torch.from_numpy(np.random.RandomState(19).randn(*shape)
                         .astype(np.float32) * 3).to(card, dtype)
    want, _ = lrn.lrn_fwd_cuda(x, 5, 0.001, 0.75, 1.0)
    torch.cuda.synchronize()
    before = (lrn.launches, lrn.no_norm_launches)
    live = torch.cuda.memory_stats(card)["allocation.all.current"]
    out, norm = lrn.lrn_fwd_cuda(x, 5, 0.001, 0.75, 1.0, with_norm=False)
    torch.cuda.synchronize()
    # out is the one tensor it allocates
    assert norm is None
    assert torch.cuda.memory_stats(card)["allocation.all.current"] == live + 1
    assert (lrn.launches, lrn.no_norm_launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_lrn_forward_under_no_grad_builds_no_graph(card):
    x = torch.randn(2, 8, 3, 3, device=card, requires_grad=True)
    before = (lrn.launches, lrn.no_norm_launches, lrn.bwd_launches)
    with torch.no_grad():
        out = lrn.forward(x, 5, 0.001, 0.75, 1.0)
    torch.cuda.synchronize()
    assert out.grad_fn is None and not out.requires_grad
    assert (lrn.launches, lrn.no_norm_launches, lrn.bwd_launches) == \
        (before[0] + 1, before[1] + 1, before[2])
    torch.testing.assert_close(out, lrn.lrn_ref(x.detach(), 5, 0.001, 0.75,
                                                1.0), rtol=1e-5, atol=0)
    # a tensor that needs no gradient takes the same path outside no_grad
    out = lrn.forward(x.detach(), 5, 0.001, 0.75, 1.0)
    assert out.grad_fn is None
    assert lrn.no_norm_launches == before[1] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("conf, want", [
    ("example/transformer/lm.conf", 0),       # dev = tpu
    ("example/kaggle_bowl/bowl.conf", 1)])    # dev = gpu:1
def test_config_dev_specs_land_on_the_card(card, conf, want):
    from cxxnet_tpu_torch.nnet.trainer import Trainer
    from cxxnet_tpu_torch.utils.config import parse_config_file
    trainer = Trainer()
    for k, v in parse_config_file(os.path.join(REPO, conf)):
        trainer.set_param(k, v)
    trainer.init_model()
    # the JAX rule: an id the machine lacks is card 0
    want = torch.device("cuda", want if want < torch.cuda.device_count()
                        else 0)
    assert trainer.dev == want
    assert all(p.device == want for ps in trainer.params for p in ps.values())


# (b, h, nkv, L, d, causal, window)
FLASH_SHAPES = [
    (8, 8, 8, 1024, 64, True, 0),       # the bench.py LM's prefill
    (2, 8, 2, 1024, 64, True, 256),     # grouped kv heads with a window
    (2, 8, 8, 1000, 64, True, 0),       # ragged last tile
    (2, 4, 4, 1000, 64, False, 0),
    (3, 4, 4, 256, 16, True, 0),        # lm.conf's head dim
    (2, 4, 2, 300, 32, True, 100),
    (1, 8, 1, 512, 128, True, 0),
    (2, 2, 2, 130, 128, False, 0),
    (1, 2, 2, 40, 16, True, 0),         # shorter than one tile
    (2, 2, 2, 1024, 256, True, 0),      # head dim 256 (its own layout)
    (1, 4, 2, 300, 256, True, 100),
    (1, 2, 1, 200, 200, False, 0),      # run in width 256
    (1, 4, 2, 300, 264, True, 100),     # above 256: two slices
    (2, 2, 1, 256, 512, True, 0),
]


def _flash_inputs(card, shape, dtype, seed=3):
    b, h, nkv, L, d, _, _ = shape
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, n, L, d).astype(np.float32))
            .to(card, dtype) for n in (h, nkv, nkv)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_kernel_matches_plain(card, shape, dtype, rtol):
    q, k, v = _flash_inputs(card, shape, dtype)
    causal, window = shape[5], shape[6]
    before = flash_attn.launches
    out, lse = flash_attn.flash_fwd_cuda(q, k, v, causal, None, window)
    torch.cuda.synchronize()
    assert flash_attn.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == q.shape[:3]
    ref_out, ref_lse = flash_attn.flash_fwd_ref(q, k, v, causal, None,
                                                window)
    eps = torch.finfo(torch.float32).eps
    torch.testing.assert_close(
        out.float(), ref_out.float(), rtol=rtol,
        atol=8 * eps * float(ref_out.float().abs().max()))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5,
                               atol=8 * eps * float(ref_lse.abs().max()))


# (b, h, nkv, L, d, causal, window) at the edges of the tensor-core
# forward's tiles: L one short of and one past a multiple of the 64-row q
# tile and of the kv tiles (64 keys up to width 64, 32 above), head dims
# between the compiled widths (16, 32, 64, 128) and above 128 in slices of
# 128 columns, a cluster of 2, 3 or 5 blocks sharing the score product,
# and 10 slices in clusters of 5, each block forming the scores over two
# chunks; one kv head, window 64, and rows that are not a multiple of 16
# bytes (d 6: 4-byte copies; d 5 in bf16: element by element)
FLASH_FWD_EDGES = [
    (2, 4, 1, 63, 8, True, 0),
    (2, 4, 1, 65, 8, True, 64),
    (1, 4, 2, 31, 24, True, 0),
    (1, 4, 2, 97, 40, False, 0),
    (1, 4, 1, 127, 64, True, 64),
    (2, 8, 1, 129, 64, True, 0),
    (1, 4, 2, 33, 128, True, 0),
    (1, 4, 1, 95, 96, True, 64),
    (1, 2, 2, 127, 136, True, 64),
    (1, 2, 1, 129, 256, False, 0),
    (1, 2, 1, 95, 264, True, 0),
    (1, 4, 2, 161, 384, True, 64),
    (1, 2, 1, 65, 520, True, 0),
    (1, 1, 1, 70, 1160, True, 0),
    (2, 8, 2, 1025, 64, True, 0),
    (1, 2, 1, 70, 6, True, 0),
    (1, 2, 1, 70, 5, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", FLASH_FWD_EDGES, ids=str)
def test_flash_fwd_kernel_at_the_tile_edges(card, shape, dtype, rtol):
    # the bars of test_flash_kernel_matches_plain, and two runs bitwise
    # equal
    q, k, v = _flash_inputs(card, shape, dtype)
    causal, window = shape[5], shape[6]
    out, lse = flash_attn.flash_fwd_cuda(q, k, v, causal, None, window)
    again = flash_attn.flash_fwd_cuda(q, k, v, causal, None, window)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref_out, ref_lse = flash_attn.flash_fwd_ref(q, k, v, causal, None,
                                                window)
    eps = torch.finfo(torch.float32).eps
    torch.testing.assert_close(
        out.float(), ref_out.float(), rtol=rtol,
        atol=8 * eps * float(ref_out.float().abs().max()))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5,
                               atol=8 * eps * float(ref_lse.abs().max()))


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _flash_inputs(card, (1, 4, 2, 128, 64, True, 0), torch.float32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attn.flash_fwd_cuda(q.cpu(), k, v, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attn.flash_fwd_cuda(q.double(), k.double(), v.double(), True)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attn.flash_fwd_cuda(q, k.bfloat16(), v, True)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attn.flash_fwd_cuda(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), k, v, True)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        k3 = torch.zeros(1, 3, 128, 64, device=card)
        flash_attn.flash_fwd_cuda(q, k3, k3, True)
    with pytest.raises(ValueError, match="needs causal"):
        flash_attn.flash_fwd_cuda(q, k, v, False, None, 16)
    # supports() takes any head dim that is a multiple of 8, as the JAX gate
    # does, and so do the kernels: d 264 and 512 run in slices of 256
    for d in (264, 512):
        assert flash_attn.supports(128, d)
        qd, kd, vd = _flash_inputs(card, (1, 2, 2, 128, d, True, 0),
                                   torch.float32)
        out, lse = flash_attn.flash_fwd_cuda(qd, kd, vd, True)
        ref_out, ref_lse = flash_attn.flash_fwd_ref(qd, kd, vd, True)
        eps = torch.finfo(torch.float32).eps
        torch.testing.assert_close(
            out, ref_out, rtol=1e-5,
            atol=8 * eps * float(ref_out.abs().max()))
        torch.testing.assert_close(
            lse, ref_lse, rtol=1e-5,
            atol=8 * eps * float(ref_lse.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24, 40, 96])
def test_flash_head_dims_below_128_run_forward_and_backward(card, d):
    # a head dim between the compiled widths runs in the next one with
    # zero-filled columns: exact, so held to the fp32 bars of the kernels
    shape = (2, 4, 2, 200, d, True, 64)
    q, k, v = _flash_inputs(card, shape, torch.float32)
    assert flash_attn.supports(200, d)
    out, lse = flash_attn.flash_fwd_cuda(q, k, v, True, None, 64)
    ref_out, ref_lse = flash_attn.flash_fwd_ref(q, k, v, True, None, 64)
    eps = torch.finfo(torch.float32).eps
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=8 * eps * float(
        ref_out.abs().max()))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=8 * eps * float(
        ref_lse.abs().max()))
    dout = _flash_inputs(card, shape, torch.float32, seed=4)[0]
    got = flash_attn.flash_bwd_cuda(q, k, v, out, lse, dout, True, None, 64)
    want = flash_attn.flash_bwd_ref(q, k, v, out, lse, dout, True, None, 64)
    for g, w in zip(got, want):
        _assert_grad_close(g, w, 1e-5)


def _assert_grad_close(got, want, tol):
    """Within tol of the largest magnitude of want."""
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))


# (b, h, nkv, L, d, causal, window): the backward kernels' shapes
FLASH_BWD_SHAPES = [
    (8, 8, 8, 2048, 64, True, 0),       # the bench.py LM's training step
    (2, 8, 2, 2048, 64, True, 512),     # grouped kv heads with a window
    (2, 8, 8, 1000, 64, True, 0),       # ragged last tile
    (2, 4, 4, 1000, 64, False, 0),
    (3, 4, 4, 256, 16, True, 0),        # lm.conf's head dim
    (2, 4, 2, 300, 32, True, 100),
    (1, 8, 1, 512, 128, True, 0),
    (2, 2, 2, 130, 128, False, 0),
    (1, 2, 2, 40, 16, True, 0),         # shorter than one tile
    (2, 2, 2, 1024, 256, True, 0),      # head dim 256: 32-key tiles
    (1, 4, 2, 300, 256, True, 100),
    (1, 2, 1, 200, 200, False, 0),      # run in width 256
    (1, 4, 2, 300, 264, True, 100),     # above 256: two slices
    (2, 2, 1, 256, 512, True, 0),
]


def _bwd_case(card, shape, dtype):
    q, k, v = _flash_inputs(card, shape, dtype)
    dout = _flash_inputs(card, shape, dtype, seed=4)[0]
    causal, window = shape[5], shape[6]
    out, lse = flash_attn.flash_fwd_cuda(q, k, v, causal, None, window)
    return (q, k, v, out, lse, dout), (causal, None, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES, ids=str)
def test_flash_bwd_kernels_match_plain(card, shape, dtype, tol):
    # fp32 within 1e-5 of the largest magnitude (the kernels sum per tile,
    # the plain version densely); bf16 within 2e-2 (both round the same f32
    # sums to bf16, 2^-8 relative)
    (q, k, v, out, lse, dout), args = _bwd_case(card, shape, dtype)
    delta = flash_attn.bwd_delta(out, dout)
    before = (flash_attn.dq_launches, flash_attn.dkv_launches)
    dq = flash_attn.flash_bwd_dq_cuda(q, k, v, dout, lse, delta, *args)
    dk, dv = flash_attn.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, *args)
    torch.cuda.synchronize()
    assert (flash_attn.dq_launches, flash_attn.dkv_launches) == \
        (before[0] + 1, before[1] + 1)
    want = flash_attn.flash_bwd_ref(q, k, v, out, lse, dout, *args)
    for g, w in zip((dq, dk, dv), want):
        _assert_grad_close(g, w, tol)


@pytest.mark.cuda
def test_flash_bwd_kernels_are_bitwise_repeatable(card):
    (q, k, v, out, lse, dout), args = _bwd_case(
        card, (2, 8, 2, 1000, 64, True, 256), torch.float32)
    first = flash_attn.flash_bwd_cuda(q, k, v, out, lse, dout, *args)
    second = flash_attn.flash_bwd_cuda(q, k, v, out, lse, dout, *args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (b, h, nkv, L, d, causal, window) at the edges of the tensor-core
# backward's tiles: L one short of and one past a multiple of each tile
# (dQ: q tiles of 64 rows, kv tiles of 32 keys, 16 at widths 128 and 256;
# dK/dV: blocks of 64 keys, q tiles of 64 rows, 16 at widths 128 and 256,
# 32 above 256), head dims between and above the compiled widths, one kv
# head, window 64; and rows that are not a multiple of 16 bytes (d 6:
# 4-byte copies; d 5 in bf16: element by element)
FLASH_BWD_EDGES = [
    (2, 4, 1, 63, 8, True, 0),
    (2, 4, 1, 65, 8, True, 64),
    (1, 4, 2, 31, 24, True, 0),
    (1, 4, 2, 33, 24, False, 0),
    (1, 4, 1, 15, 128, True, 0),
    (1, 4, 2, 17, 128, True, 64),
    (1, 2, 2, 127, 200, True, 64),
    (1, 2, 1, 129, 200, False, 0),
    (1, 2, 2, 15, 256, True, 0),
    (1, 2, 1, 97, 256, True, 64),
    (1, 2, 1, 95, 264, True, 0),
    (1, 4, 2, 161, 264, True, 64),
    (2, 8, 1, 1023, 64, True, 64),
    (2, 8, 2, 1025, 64, True, 0),
    (1, 2, 1, 70, 6, True, 0),
    (1, 2, 1, 70, 5, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", FLASH_BWD_EDGES, ids=str)
def test_flash_bwd_kernels_at_the_tile_edges(card, shape, dtype, tol):
    # the bars of test_flash_bwd_kernels_match_plain, and two runs bitwise
    # equal
    (q, k, v, out, lse, dout), args = _bwd_case(card, shape, dtype)
    first = flash_attn.flash_bwd_cuda(q, k, v, out, lse, dout, *args)
    second = flash_attn.flash_bwd_cuda(q, k, v, out, lse, dout, *args)
    torch.cuda.synchronize()
    want = flash_attn.flash_bwd_ref(q, k, v, out, lse, dout, *args)
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)
        _assert_grad_close(a, w, tol)


@pytest.mark.cuda
def test_flash_bwd_kernels_refuse_what_they_do_not_take(card):
    (q, k, v, out, lse, dout), _ = _bwd_case(
        card, (1, 4, 2, 128, 64, True, 0), torch.float32)
    delta = flash_attn.bwd_delta(out, dout)
    for fn in (flash_attn.flash_bwd_dq_cuda, flash_attn.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="contiguous dout"):
            fn(q, k, v, dout.transpose(2, 3).contiguous().transpose(2, 3),
               lse, delta, True)
        with pytest.raises(ValueError, match="contiguous dout"):
            fn(q, k, v, dout.bfloat16(), lse, delta, True)
        with pytest.raises(ValueError, match="float32 lse"):
            fn(q, k, v, dout, lse[:, :, :64].contiguous(), delta, True)
        with pytest.raises(ValueError, match="float32 delta"):
            fn(q, k, v, dout, lse, delta.cpu(), True)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fn(q.double(), k.double(), v.double(), dout.double(), lse, delta,
               True)
        with pytest.raises(ValueError, match="needs causal"):
            fn(q, k, v, dout, lse, delta, False, None, 16)


@pytest.mark.cuda
def test_lm_update_launches_each_flash_kernel_once_per_layer(card):
    # one Net.update of a 4-block LM whose sequence takes the flash path:
    # 4 forward, 4 dQ and 4 dK/dV launches, and the gradients of the step
    # agree with the same step with flash_bwd_ref swapped in
    cfg = models.transformer_lm_config(vocab=64, seq=256, batch_size=2,
                                       dim=64, nhead=4, nlayer=4, dev="gpu",
                                       attn_extra="nkvhead = 2\nrope = 1\n")
    net = api.Net(dev="gpu", cfg=cfg + "seed = 1\n")
    net.init_model()
    rng = np.random.RandomState(2)
    x = rng.randint(0, 64, (2, 1, 1, 256)).astype(np.float32)
    y = rng.randint(0, 64, (2, 256)).astype(np.float32)
    batch = DataBatch()
    batch.data, batch.label, batch.batch_size = x, y, 2
    _, grads = net.net_.loss_and_grads(batch)
    kernel = flash_attn.flash_bwd_cuda
    flash_attn.flash_bwd_cuda = flash_attn.flash_bwd_ref
    try:
        _, plain = net.net_.loss_and_grads(batch)
    finally:
        flash_attn.flash_bwd_cuda = kernel
    for g, w in zip(grads, plain):
        for key in g:
            _assert_grad_close(g[key], w[key], 1e-4)
    before = (flash_attn.launches, flash_attn.dq_launches,
              flash_attn.dkv_launches)
    net.update(x, y)
    torch.cuda.synchronize()
    assert (flash_attn.launches, flash_attn.dq_launches,
            flash_attn.dkv_launches) == tuple(n + 4 for n in before)


@pytest.mark.cuda
def test_generate_and_full_forward_launch_the_flash_kernel(card):
    cfg = models.transformer_lm_config(vocab=64, seq=256, batch_size=2,
                                       dim=64, nhead=4, nlayer=2, dev="gpu")
    net = api.Net(dev="gpu", cfg=cfg + "seed = 1\n")
    net.init_model()
    prompts = np.random.RandomState(0).randint(0, 64, (2, 140))
    before = flash_attn.launches
    got = net.generate(prompts, 6)
    assert flash_attn.launches == before + 2
    assert got.shape == (2, 6)
    # a prompt under 128 tokens takes the dense branch
    net.generate(prompts[:, :100], 6)
    assert flash_attn.launches == before + 2
    ids = np.random.RandomState(1).randint(0, 64, (2, 1, 1, 256))
    net.predict_device(ids.astype(np.float32))
    torch.cuda.synchronize()
    assert flash_attn.launches == before + 4
    # the same tokens with the plain version swapped in
    kernel = flash_attn.flash_fwd_cuda
    flash_attn.flash_fwd_cuda = flash_attn.flash_fwd_ref
    try:
        plain = net.generate(prompts, 6)
    finally:
        flash_attn.flash_fwd_cuda = kernel
    np.testing.assert_array_equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("xs, ws, stride, pad, groups", [
    ((32, 96, 27, 27), (256, 48, 5, 5), 1, (2, 2), 2),     # AlexNet conv2
    ((16, 3, 227, 227), (96, 3, 11, 11), 4, (0, 0), 1),    # conv1
    ((32, 384, 13, 13), (384, 192, 3, 3), 1, (1, 1), 2)])  # conv4
def test_conv_weight_gradient_matches_float64(card, xs, ws, stride, pad,
                                              groups):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(np.maximum(rng.randn(*xs), 0).astype(np.float32)) \
        .to(card)
    w = torch.from_numpy(rng.randn(*ws).astype(np.float32) * 0.05).to(card)
    out_shape = torch.nn.functional.conv2d(x, w, stride=stride, padding=pad,
                                           groups=groups).shape
    g = torch.from_numpy(rng.randn(*out_shape).astype(np.float32)).to(card)
    got = ops.conv2d_weight(x, w.shape, g, stride, pad, groups)
    want = torch.nn.grad.conv2d_weight(x.double(), w.shape, g.double(),
                                       stride=stride, padding=pad,
                                       groups=groups)
    assert float((got.double() - want).abs().max()
                 / want.abs().max()) <= 1e-5
    # through autograd, the data gradient stays cuDNN's
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    ops.conv2d(xl, wl, stride=stride, pad=pad, groups=groups).backward(g)
    torch.testing.assert_close(wl.grad, got, rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_head_dim_256_trains_through_the_kernels(card):
    # an LM whose attention has head dim 256 (d_model 512, 2 heads): one
    # update launches each flash kernel once per layer, and its gradients
    # agree with the step with flash_bwd_ref swapped in
    cfg = models.transformer_lm_config(vocab=64, seq=256, batch_size=2,
                                       dim=512, nhead=2, nlayer=2, dev="gpu")
    net = api.Net(dev="gpu", cfg=cfg + "seed = 1\n")
    net.init_model()
    rng = np.random.RandomState(3)
    x = rng.randint(0, 64, (2, 1, 1, 256)).astype(np.float32)
    y = rng.randint(0, 64, (2, 256)).astype(np.float32)
    batch = DataBatch()
    batch.data, batch.label, batch.batch_size = x, y, 2
    _, grads = net.net_.loss_and_grads(batch)
    kernel = flash_attn.flash_bwd_cuda
    flash_attn.flash_bwd_cuda = flash_attn.flash_bwd_ref
    try:
        _, plain = net.net_.loss_and_grads(batch)
    finally:
        flash_attn.flash_bwd_cuda = kernel
    for g, w in zip(grads, plain):
        for key in g:
            _assert_grad_close(g[key], w[key], 1e-4)
    before = (flash_attn.launches, flash_attn.dq_launches,
              flash_attn.dkv_launches)
    net.update(x, y)
    torch.cuda.synchronize()
    assert (flash_attn.launches, flash_attn.dq_launches,
            flash_attn.dkv_launches) == tuple(n + 2 for n in before)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 7, (1 << 32) + 5, (1 << 64) - 1])
@pytest.mark.parametrize("shape", [(1,), (3,), (5,), (4 * 1000 + 3,),
                                   (256, 96, 55, 55), (3, 5, 7)], ids=str)
def test_uniform_kernel_is_bitwise_the_plain_version(card, seed, shape):
    before = trandom.launches
    got = trandom.uniform_cuda(seed, shape, card)
    torch.cuda.synchronize()
    assert trandom.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert torch.equal(got, trandom.uniform_ref(seed, shape, card))
    assert torch.equal(got, trandom.uniform(seed, shape, card))


@pytest.mark.cuda
def test_uniform_kernel_same_bits_as_the_cpu(card):
    got = trandom.uniform(2024, (7, 3001), card).cpu()
    assert torch.equal(got, trandom.uniform(2024, (7, 3001), "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("rows, n", [(1, 1), (3, 5), (8, 8192), (5, 4001),
                                     (300, 12)])
def test_uniform_rows_kernel_is_bitwise_the_plain_version(card, rows, n):
    rng = np.random.RandomState(rows + n)
    seeds = torch.tensor([trandom.seed_word(int(s)) for s in
                          rng.randint(0, 1 << 62, rows, dtype=np.int64)],
                         dtype=torch.int64)
    seeds[0] = trandom.seed_word((1 << 64) - 1)
    pos = torch.from_numpy(rng.randint(0, 1 << 31, rows).astype(np.int64))
    rowid = torch.from_numpy(rng.randint(0, 9, rows).astype(np.int64))
    before = trandom.rows_launches
    got = trandom.uniform_rows_cuda(seeds.to(card), pos.to(card),
                                    rowid.to(card), n)
    torch.cuda.synchronize()
    assert trandom.rows_launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, n)
    assert torch.equal(got.cpu(), trandom.uniform_rows_ref(seeds, pos,
                                                           rowid, n))


@pytest.mark.cuda
def test_lm_sessions_on_the_card_equal_solo_generate(card):
    # a small fp32 LM: a dense and a paged session, greedy and sampled,
    # against solo generate of each request (sampled draws launch the
    # per-row kernel); the paged session's tokens are the dense one's
    cfg = models.transformer_lm_config(vocab=64, seq=256, batch_size=2,
                                       dim=64, nhead=4, nlayer=2, dev="gpu")
    net = api.Net(dev="gpu", cfg=cfg + "seed = 1\n")
    net.init_model()
    tr = net.net_
    rng = np.random.RandomState(4)
    shared = rng.randint(0, 64, 144).tolist()
    prompts = [shared + rng.randint(0, 64, n).tolist() for n in (3, 20, 40)] \
        + [rng.randint(0, 64, n).tolist() for n in (130, 60)]
    for temp, top_k in ((0.0, 0), (0.9, 8)):
        solo = [list(tr.generate(np.asarray([p]), 6, temperature=temp,
                                 top_k=top_k, seed=3 + i)[0])
                for i, p in enumerate(prompts)]
        runs = []
        for pool in (None, tr.decode_kv_pool(16, pool_tokens=1024)):
            before = trandom.rows_launches
            sess = tr.decode_session(2, 6, temperature=temp, top_k=top_k,
                                     kv_pool=pool)
            got, live, nxt = {}, {}, 0
            while nxt < len(prompts) or live:
                for s in sess.free_slots()[:1]:
                    if nxt < len(prompts):
                        tok, _ = sess.prefill(s, prompts[nxt], 3 + nxt)
                        live[s] = (nxt, [tok])
                        nxt += 1
                for s, tok, done in sess.step():
                    live[s][1].append(tok)
                    if done:
                        i, toks = live.pop(s)
                        got[i] = toks
                        sess.retire(s)
            sess.close()
            runs.append([got[i] for i in range(len(prompts))])
            assert (trandom.rows_launches > before) == (temp > 0)
        assert runs[0] == runs[1]
        assert runs[0] == solo
    assert tr._kv_pool.alloc.prefix_hits > 0


def _rrelu_alexnet_cfg(rows):
    text = open(os.path.join(REPO, "example/ImageNet/ImageNet.conf")).read()
    return models.rrelu_config(text).replace("threshold = 0.5",
                                             "threshold = 0") + \
        "\nbatch_size = %d\nseed = 3\n" % rows


@pytest.mark.cuda
def test_rrelu_alexnet_step_card_matches_cpu(card, tmp_path):
    # 7 insanity and 3 pooling draws per step through the kernel; the CPU
    # path draws the same bits, so the two steps differ by summation order
    # once the CPU takes the card's signs at the insanity inputs: an input
    # within rounding of 0 (1-2 of ~10^6 here) can fall on the other side
    # of 0 on the two devices, and its gradient then differs by the factor
    # 1 - 1/slope, which moves every layer upstream by up to a few percent
    # of its update
    from cxxnet_tpu_torch.layer import layers as L
    cfg = _rrelu_alexnet_cfg(2)
    net = api.Net(dev="gpu", cfg=cfg)
    net.init_model()
    fname = str(tmp_path / "rrelu.model")
    net.save_model(fname)
    cpu = api.Net(dev="cpu", cfg=cfg)
    cpu.load_model(fname)
    start = [{k: v.detach().clone() for k, v in p.items()}
             for p in net.net_.params]
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 227, 227).astype(np.float32)
    y = rng.randint(0, 1000, 2).astype(np.float32)

    def insanity(n):
        return [lay for lay in n.net_.net.layers
                if lay.type_name == "insanity"]
    signs = []
    for lay in insanity(net):
        def record(params, inputs, ctx, real=lay.forward):
            signs.append(inputs[0] > 0)
            return real(params, inputs, ctx)
        lay.forward = record
    before = trandom.launches
    net.update(x, y)
    torch.cuda.synchronize()
    assert trandom.launches == before + 10 and len(signs) == 7
    for lay, keep in zip(insanity(cpu), signs):
        def forward(params, inputs, ctx, lay=lay, keep=keep.cpu()):
            lb, ub = lay._bounds(ctx.epoch)
            slope = L.draw_uniform(ctx, inputs[0].shape, "cpu") \
                * (ub - lb) + lb
            return [torch.where(keep, inputs[0], inputs[0] / slope)]
        lay.forward = forward
    cpu.update(x, y)
    assert trandom.launches == before + 10
    for i, (g, w, s0) in enumerate(zip(net.net_.params, cpu.net_.params,
                                       start)):
        for k in w:
            got, want = g[k].detach().cpu(), w[k].detach()
            step = float((want - s0[k].cpu()).abs().max())
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-4 * step,
                                       msg="layer %d %s" % (i, k))


# (bh, bkv, sq, skv, d, (q_off, kv_off), causal, window): every class of
# offsets a ring step meets, grouped k/v, sq != skv and head dims above 256
RING_STEPS = [
    (16, 16, 512, 512, 64, (512, 512), True, 0),     # the diagonal block
    (16, 4, 256, 512, 64, (1024, 0), True, 0),       # wholly visible
    (8, 8, 256, 256, 64, (0, 256), True, 0),         # wholly masked
    (8, 2, 256, 256, 64, (768, 256), True, 300),     # cut by the window
    (8, 8, 256, 384, 64, (0, 768), False, 0),        # non-causal
    (4, 4, 128, 256, 264, (256, 128), True, 0),      # above 256: slices
    (4, 2, 256, 128, 512, (256, 256), True, 100),
]


def _ring_step_inputs(card, case, dtype):
    """q, k, v, dO in dtype and the f32 carries of an earlier step (every
    third row still at (NEG_INF, 0, 0); dK/dV at query-head resolution)."""
    bh, bkv, sq, skv, d = case[:5]
    rng = np.random.RandomState(5)

    def mk(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(card)
    q, do = mk(bh, sq, d).to(dtype), mk(bh, sq, d).to(dtype)
    k, v = mk(bkv, skv, d).to(dtype), mk(bkv, skv, d).to(dtype)
    m, l, acc = mk(bh, sq, 1), mk(bh, sq, 1).abs() + 0.5, mk(bh, sq, d)
    m[:, ::3], l[:, ::3], acc[:, ::3] = flash_attn.NEG_INF, 0.0, 0.0
    lse, delta = mk(bh, sq, 1).abs() + 3.0, mk(bh, sq, 1)
    return (q, k, v, do), (m, l, acc), (lse, delta), \
        (mk(bh, sq, d), mk(bh, skv, d), mk(bh, skv, d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", RING_STEPS, ids=str)
def test_ring_step_kernels_match_plain(card, case, dtype, tol):
    # the carries within 1e-5 (m, l) and tol (acc, dq, dk, dv) of their
    # largest magnitude: kernel and plain version read the same inputs in
    # f32 and differ by their order of summation; a wholly masked step
    # leaves every carry bitwise as it was
    offs, causal, window = case[5:]
    kw = dict(causal=causal, scale=case[4] ** -0.5, window=window)
    (q, k, v, do), (m, l, acc), (lse, delta), (dq, dk, dv) = \
        _ring_step_inputs(card, case, dtype)
    before = (ring_flash.fwd_launches, ring_flash.dq_launches,
              ring_flash.dkv_launches)
    want = ring_flash.fwd_step_ref(q, k, v, m, l, acc, offs, **kw)
    got = ring_flash.fwd_step_cuda(q, k, v, m, l, acc.clone(), offs, **kw)
    want_dq = ring_flash.dq_step_ref(q, k, v, do, lse, delta, dq, offs, **kw)
    got_dq = ring_flash.dq_step_cuda(q, k, v, do, lse, delta, dq.clone(),
                                     offs, **kw)
    want_dkv = ring_flash.dkv_step_ref(q, k, v, do, lse, delta, dk, dv, offs,
                                       **kw)
    got_dkv = ring_flash.dkv_step_cuda(q, k, v, do, lse, delta, dk.clone(),
                                       dv.clone(), offs, **kw)
    torch.cuda.synchronize()
    assert (ring_flash.fwd_launches, ring_flash.dq_launches,
            ring_flash.dkv_launches) == tuple(n + 1 for n in before)
    for g, w, t in zip(got + (got_dq,) + got_dkv,
                       want + (want_dq,) + want_dkv,
                       (1e-5, 1e-5) + (tol,) * 4):
        torch.testing.assert_close(g, w, rtol=t, atol=t * float(
            w[w > 0.5 * flash_attn.NEG_INF].abs().max()))
    if offs == (0, 256):
        for g, start in zip(got + (got_dq,) + got_dkv,
                            (m, l, acc, dq, dk, dv)):
            assert torch.equal(g, start)


# (bh, bkv, sq, skv, d, (q_off, kv_off), causal, window): the forward
# step in every class of offsets a ring step meets (chip_smoke.py's
# RING_CLASSES: diagonal, wholly visible, wholly masked, cut by the window,
# non-causal) at the tensor-core forward's tile edges: offsets off the
# 64-row and 64-key tile grid (the wrapper takes lengths in multiples of
# 128), sq != skv, head dims between the compiled widths and above 128
# (clusters of 2, 3 and 5 slices), grouped k/v
RING_FWD_EDGES = [
    (8, 2, 256, 256, 64, (200, 200), True, 64),      # diagonal
    (8, 8, 128, 384, 40, (500, 0), True, 0),         # wholly visible
    (4, 4, 128, 128, 264, (0, 130), True, 50),       # wholly masked
    (8, 2, 256, 128, 136, (300, 100), True, 120),    # cut by the window
    (4, 1, 128, 256, 520, (0, 300), False, 0),       # non-causal
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", RING_FWD_EDGES, ids=str)
def test_ring_fwd_step_kernel_at_the_tile_edges(card, case, dtype, tol):
    # the bars of test_ring_step_kernels_match_plain for (m, l, acc); two
    # runs from the same carry bitwise equal; a wholly masked step leaves
    # the carry bitwise as it was
    offs, causal, window = case[5:]
    kw = dict(causal=causal, scale=case[4] ** -0.5, window=window)
    (q, k, v, _), (m, l, acc), _, _ = _ring_step_inputs(card, case, dtype)
    got = ring_flash.fwd_step_cuda(q, k, v, m, l, acc.clone(), offs, **kw)
    again = ring_flash.fwd_step_cuda(q, k, v, m, l, acc.clone(), offs, **kw)
    torch.cuda.synchronize()
    want = ring_flash.fwd_step_ref(q, k, v, m, l, acc, offs, **kw)
    for g, a, w, t in zip(got, again, want, (1e-5, 1e-5, tol)):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=t, atol=t * float(
            w[w > 0.5 * flash_attn.NEG_INF].abs().max()))
    if offs == (0, 130):
        for g, start in zip(got, (m, l, acc)):
            assert torch.equal(g, start)


# the backward steps at the same edges and at width 128 (d 120: the dQ
# body's 16-key tiles, the dK/dV body's 16-row q tiles), sq > skv, the
# diagonal crossing the block off the 16-row grid
RING_BWD_EDGES = RING_FWD_EDGES + [
    (8, 4, 384, 128, 120, (170, 90), True, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", RING_BWD_EDGES, ids=str)
def test_ring_bwd_step_kernels_at_the_tile_edges(card, case, dtype, tol):
    # dq, dk, dv from carries that are not zero within tol of their largest
    # magnitude against the plain versions; two runs from the same carries
    # bitwise equal; a wholly masked step leaves every carry bitwise as it
    # was
    offs, causal, window = case[5:]
    kw = dict(causal=causal, scale=case[4] ** -0.5, window=window)
    (q, k, v, do), _, (lse, delta), (dq, dk, dv) = \
        _ring_step_inputs(card, case, dtype)
    runs = [(ring_flash.dq_step_cuda(q, k, v, do, lse, delta, dq.clone(),
                                     offs, **kw),)
            + ring_flash.dkv_step_cuda(q, k, v, do, lse, delta, dk.clone(),
                                       dv.clone(), offs, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    want = (ring_flash.dq_step_ref(q, k, v, do, lse, delta, dq, offs,
                                   **kw),) + \
        ring_flash.dkv_step_ref(q, k, v, do, lse, delta, dk, dv, offs, **kw)
    for g, a, w in zip(*runs, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=tol,
                                   atol=tol * float(w.abs().max()))
    if offs == (0, 130):
        for g, start in zip(runs[0], (dq, dk, dv)):
            assert torch.equal(g, start)


@pytest.mark.cuda
@pytest.mark.parametrize("n, shape", [
    (4, (2, 8, 2, 2048, 64, True, 1024)),    # the long recipe's ring, cut
    (4, (2, 4, 4, 1024, 64, False, 0)),
    (2, (1, 2, 1, 512, 512, True, 200)),     # head dim 512
])
def test_ring_steps_reproduce_the_flash_kernels(card, n, shape):
    # n ring steps over the whole sequence give the flash kernels' out and
    # lse, and the backward ring pass their dq, dk, dv, within 1e-5 of the
    # largest magnitude; each step kernel launches n^2 times
    q, k, v = _flash_inputs(card, shape, torch.float32)
    dout = _flash_inputs(card, shape, torch.float32, seed=4)[0]
    causal, window = shape[5], shape[6]
    scale = shape[4] ** -0.5
    out, lse = flash_attn.flash_fwd_cuda(q, k, v, causal, None, window)
    want = flash_attn.flash_bwd_cuda(q, k, v, out, lse, dout, causal, None,
                                     window)
    before = (ring_flash.fwd_launches, ring_flash.dq_launches,
              ring_flash.dkv_launches)
    ranks = ring._Ranks(n, None)
    r_out, r_lse = ring._ring_flash_fwd(q, k, v, ranks, causal, scale,
                                        window)
    got = ring._ring_flash_bwd(q, k, v, r_out, r_lse, dout, ranks, causal,
                               scale, window)
    torch.cuda.synchronize()
    assert (ring_flash.fwd_launches, ring_flash.dq_launches,
            ring_flash.dkv_launches) == tuple(c + n * n for c in before)
    b, h, L, _ = q.shape
    r_lse = r_lse.reshape(n, b, h, L // n).permute(1, 2, 0, 3).reshape(b, h,
                                                                       L)
    for g, w in zip((r_out, r_lse) + got, (out, lse) + want):
        _assert_grad_close(g, w, 1e-5)


@pytest.mark.cuda
def test_ring_step_kernels_refuse_what_they_do_not_take(card):
    case = (4, 2, 128, 128, 64, (0, 0), True, 0)
    (q, k, v, do), (m, l, acc), (lse, delta), (dq, dk, dv) = \
        _ring_step_inputs(card, case, torch.float32)
    kw = dict(causal=True, scale=0.125)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ring_flash.fwd_step_cuda(q.cpu(), k, v, m, l, acc, (0, 0), **kw)
    with pytest.raises(ValueError, match="multiples of 128"):
        ring_flash.fwd_step_cuda(q[:, :100].contiguous(), k, v,
                                 m[:, :100].contiguous(),
                                 l[:, :100].contiguous(),
                                 acc[:, :100].contiguous(), (0, 0), **kw)
    with pytest.raises(ValueError, match="bkv dividing"):
        k3 = torch.zeros(3, 128, 64, device=card)
        ring_flash.fwd_step_cuda(q, k3, k3, m, l, acc, (0, 0), **kw)
    with pytest.raises(ValueError, match="float32 acc"):
        ring_flash.fwd_step_cuda(q, k, v, m, l, acc.bfloat16(), (0, 0), **kw)
    with pytest.raises(ValueError, match="float32 dq"):
        ring_flash.dq_step_cuda(q, k, v, do, lse, delta, dq[:, :64], (0, 0),
                                **kw)
    with pytest.raises(ValueError, match="float32 dv"):
        ring_flash.dkv_step_cuda(q, k, v, do, lse, delta, dk, dv.cpu(),
                                 (0, 0), **kw)
    with pytest.raises(ValueError, match="needs causal"):
        ring_flash.dkv_step_cuda(q, k, v, do, lse, delta, dk, dv, (0, 0),
                                 causal=False, scale=0.125, window=16)


@pytest.mark.cuda
@pytest.mark.parametrize("sp_mode, extra", [
    ("ring", ""), ("ring", "nkvhead = 1\nattn_window = 100\nrope = 1\n"),
    ("ulysses", "nkvhead = 1\nattn_window = 100\nrope = 1\n")])
def test_seq_parallel_update_matches_one_rank(card, tmp_path, sp_mode,
                                              extra):
    # seq_parallel = 2 on the card gives the single-rank run's loss and
    # gradients (1e-5 relative, 1e-4 of each tensor's largest); one update
    # launches each ring kernel n^2 = 4 times per layer (ring), or each
    # flash kernel n = 2 times per layer (ulysses)
    cfg = models.transformer_lm_config(
        vocab=64, seq=256, batch_size=2, dim=64, nhead=4, nlayer=2,
        dev="gpu", attn_extra=extra + "sp_mode = %s\n" % sp_mode)
    one = api.Net(dev="gpu", cfg=cfg + "seed = 1\n")
    one.init_model()
    fname = str(tmp_path / "lm.model")
    one.save_model(fname)
    sp = api.Net(dev="gpu", cfg=cfg + "seq_parallel = 2\n")
    sp.load_model(fname)
    rng = np.random.RandomState(3)
    x = rng.randint(0, 64, (2, 1, 1, 256)).astype(np.float32)
    y = rng.randint(0, 64, (2, 256)).astype(np.float32)
    batch = DataBatch()
    batch.data, batch.label, batch.batch_size = x, y, 2
    loss1, grads1 = one.net_.loss_and_grads(batch)
    loss2, grads2 = sp.net_.loss_and_grads(batch)
    assert abs(float(loss2) - float(loss1)) <= 1e-5 * abs(float(loss1))
    for g, w in zip(grads2, grads1):
        for key in g:
            _assert_grad_close(g[key], w[key], 1e-4)
    mod = ring_flash if sp_mode == "ring" else flash_attn
    names = ("fwd_launches", "dq_launches", "dkv_launches") \
        if sp_mode == "ring" else ("launches", "dq_launches", "dkv_launches")
    before = [getattr(mod, nm) for nm in names]
    sp.update(x, y)
    torch.cuda.synchronize()
    per_layer = 4 if sp_mode == "ring" else 2
    assert [getattr(mod, nm) - b for nm, b in zip(names, before)] == \
        [2 * per_layer] * 3


# ------------------------------------------------- the pinned feed, the CLI
PINNED_NET = """
netconfig=start
layer[0->1] = conv
  kernel_size = 3
  nchannel = 8
layer[1->2] = relu
layer[2->3] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[3->4] = flatten
layer[4->5] = fullc
  nhidden = 10
layer[5->5] = softmax
netconfig=end
input_shape = 3,16,16
batch_size = 32
momentum = 0.9
eta = 0.01
"""


def _numpy_batches(n, dtype, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = DataBatch()
        b.data = (rng.randint(0, 256, (32, 3, 16, 16)).astype(dtype)
                  if dtype == np.uint8
                  else rng.randn(32, 3, 16, 16).astype(dtype))
        b.label = rng.randint(0, 10, (32, 1)).astype(np.float32)
        b.batch_size = 32
        out.append(b)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_pinned_async_step_equals_the_synchronous_step(card, tmp_path,
                                                       dtype):
    """Bitwise: a numpy batch, staged in page-locked memory and copied
    asynchronously, feeds the step the very values of a synchronous copy
    (a uint8 batch crosses as uint8)."""
    cfg = PINNED_NET + ("input_divideby = 255\n" if dtype == np.uint8
                        else "")
    batches = _numpy_batches(5, dtype)
    fname = str(tmp_path / "p.model")
    net = api.Net(dev="gpu", cfg=cfg)
    net.init_model()
    net.save_model(fname)
    torch.backends.cudnn.deterministic = True
    try:
        sync, pinned = api.Net(dev="gpu", cfg=cfg), api.Net(dev="gpu", cfg=cfg)
        sync.load_model(fname)
        pinned.load_model(fname)
        for b in batches:
            on_card = b.shallow_copy()
            on_card.data = torch.from_numpy(b.data).to(card)
            on_card.label = torch.from_numpy(b.label).to(card)
            sync.net_.update(on_card)
            pinned.net_.update(b)
        assert sync.net_._staging is None
        assert pinned.net_._staging is not None
        for p, q in zip(sync.net_.params, pinned.net_.params):
            for k in p:
                assert torch.equal(p[k], q[k]), k
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_a_pinned_buffer_is_refilled_only_after_its_copy(card):
    """A loader overwrites its one buffer as soon as each batch is handed
    over; the staging ring refills a slot only after the copy out of it
    completed. The copy stream is held up behind a spin, so a refill that
    did not wait would overwrite batch k before the card read it."""
    from cxxnet_tpu_torch.nnet.trainer import Trainer
    tr = Trainer()
    tr.dev = card
    tr.net = type("N", (), {"id_nodes": ()})()
    b = DataBatch()
    b.data = np.empty((64, 3, 64, 64), np.float32)
    b.label = np.empty((64, 1), np.float32)
    b.batch_size = 64
    got = []
    for k in range(12):
        b.data[:] = k
        b.label[:] = k
        if tr._copy_stream is not None:
            with torch.cuda.stream(tr._copy_stream):
                torch.cuda._sleep(20_000_000)
        got.append(tr._batch_tensors(b))
    torch.cuda.synchronize()
    for k, (data, label) in enumerate(got):
        assert bool((data == k).all()) and bool((label == k).all()), k


def _image_cli_conf(d, dev):
    from cxxnet_tpu_torch.io import synth
    synth.make_ppm_pack(d, "tr", 64, 36, 10, seed=0, page_ints=1 << 14)
    conf = os.path.join(d, "task.conf")
    with open(conf, "w") as f:
        f.write(PINNED_NET.replace("input_shape = 3,16,16",
                                   "input_shape = 3,32,32")
                .replace("batch_size = 32", "batch_size = 16")
                + "data = train\niter = imgbin\n  image_list = \"tr.lst\"\n"
                "  image_bin = \"tr.bin\"\n  image_mean = \"mean.bin\"\n"
                "  page_size = 16384\n  rand_crop = 1\n  rand_mirror = 1\n"
                "iter = threadbuffer\niter = end\nmetric = error\n"
                "dev = %s\n" % dev)
    return conf


@pytest.mark.cuda
def test_cli_image_config_on_the_card_matches_api_net(card, tmp_path):
    """The CLI (imgbin + threadbuffer, staging ring, LRN kernels) against
    the same batches through api.Net.update on the card: relative 1e-5
    plus 1e-5 of each tensor's largest update (chip_smoke's card-vs-card
    step bar)."""
    from cxxnet_tpu_torch import learn_task
    d = str(tmp_path)
    conf = _image_cli_conf(d, "gpu")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        lt = learn_task.LearnTask()
        before = lrn.bwd_launches
        assert lt.run([conf, "num_round=2", "silent=1"]) == 0
        assert lt.net_trainer.dev.type == "cuda"
        assert lrn.bwd_launches == before + 2 * 4
        net = api.Net(dev="gpu", cfg=open(conf).read())
        net.init_model()
        start = [{k: v.clone() for k, v in p.items()}
                 for p in net.net_.params]
        it = api.DataIter(
            'iter = imgbin\nimage_list = "tr.lst"\nimage_bin = "tr.bin"\n'
            'image_mean = "mean2.bin"\npage_size = 16384\nrand_crop = 1\n'
            'rand_mirror = 1\niter = threadbuffer\ninput_shape = 3,32,32\n'
            'batch_size = 16\niter = end\n')
        for r in range(2):
            net.start_round(r + 1)
            it.before_first()
            while it.next():
                net.update(it)
        it.close()
        cli = api.Net(dev="gpu", cfg=open(conf).read())
        cli.load_model("models/0002.model")
    finally:
        os.chdir(cwd)
    for p, q, s in zip(cli.net_.params, net.net_.params, start):
        for k in p:
            bound = 1e-5 * q[k].abs() + 1e-5 * (q[k] - s[k]).abs().max()
            assert bool(((p[k] - q[k]).abs() <= bound).all()), k


@pytest.mark.cuda
def test_config_dev_cpu_stays_and_command_line_dev_gpu_moves(card,
                                                             tmp_path):
    from cxxnet_tpu_torch import learn_task
    d = str(tmp_path)
    conf = _image_cli_conf(d, "cpu")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        for args, want in (([], "cpu"), (["dev=gpu"], "cuda")):
            lt = learn_task.LearnTask()
            assert lt.run([conf, "num_round=1", "silent=1",
                           "model_dir=m_%s" % want] + args) == 0
            assert lt.net_trainer.dev.type == want
            assert (lt.net_trainer._staging is None) == (want == "cpu")
    finally:
        os.chdir(cwd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cxxnet_ops_launch_the_kernels_bitwise_their_wrappers(card, dtype):
    """The cxxnet:: ops on a CUDA tensor are the kernels' wrappers: the
    same bits and one launch each."""
    x = torch.from_numpy(np.random.RandomState(6).randn(4, 96, 27, 27)
                         .astype(np.float32)).to(card, dtype)
    a = tuple(ARGS.values())
    before = (lrn.launches, lrn.no_norm_launches)
    out = torch.ops.cxxnet.lrn_fwd(x, *a)
    out_n, norm = torch.ops.cxxnet.lrn_fwd_norm(x, *a)
    assert (lrn.launches, lrn.no_norm_launches) == (before[0] + 2,
                                                    before[1] + 1)
    assert torch.equal(out, lrn.lrn_fwd_cuda(x, *a, with_norm=False)[0])
    want_out, want_norm = lrn.lrn_fwd_cuda(x, *a)
    assert torch.equal(out_n, want_out) and torch.equal(norm, want_norm)
    rs = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rs.randn(2, h, 256, 64).astype(np.float32))
               .to(card, dtype) for h in (8, 2, 2))
    before = flash_attn.launches
    got = torch.ops.cxxnet.flash_fwd(q, k, v, True, 0.125, 0)
    assert flash_attn.launches == before + 1
    want = flash_attn.flash_fwd_cuda(q, k, v, True, 0.125, 0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_exported_lrn_net_launches_its_kernel_on_the_card(card, tmp_path):
    """A conv + LRN net exported on the card at a symbolic batch: the
    loaded program holds cxxnet::lrn_fwd, launches the kernel once a
    call and gives the eager forward's bits at the traced batch."""
    cfg = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 16
layer[1->2] = relu
layer[2->3] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
layer[3->4] = flatten
layer[4->5] = fullc:fc
  nhidden = 10
layer[5->5] = softmax
netconfig = end
input_shape = 3,16,16
batch_size = 8
dev = gpu
"""
    net = api.Net(dev="gpu", cfg=cfg)
    net.init_model()
    path = str(tmp_path / "lrn.pt2")
    net.export(path, batch_size=-1)
    fn = api.load_exported(path)
    targets = [str(n.target) for n in fn.module.graph.nodes]
    assert targets.count("cxxnet.lrn_fwd.default") == 1
    x = np.random.RandomState(8).randn(8, 3, 16, 16).astype(np.float32)
    for n in (1, 5, 8):
        before = lrn.launches
        got = fn(x[:n])
        assert lrn.launches == before + 1
        want = net.extract(x[:n], "top[-1]")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
