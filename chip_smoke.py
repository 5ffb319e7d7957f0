"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels from cxxnet_tpu_torch/csrc, holds each kernel
against its plain PyTorch version at the shapes of the main paths, then
drives the main paths through ``cxxnet_tpu_torch.api.Net(dev="gpu")``:
AlexNet (example/ImageNet/ImageNet.conf at full width, 3x227x227 -> 1000,
batch 256, random weights from a seed) in inference (``predict`` /
``extract``) and in training (``update`` steps with the config's own SGD
settings and dropout on) and its RReLU form (every relu made insanity,
every max_pooling insanity_max_pooling, trained the same way, its noise
drawn by the Philox kernel); then the command line (bin/cxxnet_torch,
``cxxnet_tpu_torch.learn_task.main``) on the repo's own configs:
example/MNIST/MNIST_CONV.conf trained for its 15 rounds on synthetic MNIST,
ImageNet.conf trained for 2 rounds from a synthetic 256x256 PPM pack
(imgbin + threadbuffer, the mean image made on first use, both LRN
kernels) and held to api.Net.update on the same batches, then pred /
extract / pred_raw from its model held to api.Net, and
example/kaggle_bowl/pred.conf's pred_raw with a padded last batch; then
the transformer LM that bench.py
measures (vocab 8192, d_model 512, 8 heads, 4 blocks, 2048 positions,
fp32, random weights from a seed) served through KV-cached ``generate``
and a full-sequence ``predict_device``, and its long-context recipe (8192
positions, 2 kv heads, window 1024, RoPE); then both LMs trained through
``update`` (the config's Adam, batch 8 and 2); the bench.py LM with 2
heads (head dim 256) and with 1 head (head dim 512) served and trained;
last sequence parallelism: the ring-step kernels against their plain
versions and n ring steps against the flash kernels, then the long recipe
trained with ``seq_parallel = 4`` as a ring (the ring-step kernels on
shards of 2048) and as Ulysses, and the bench.py LM as a ring, each held
to the single-card run. Exits non-zero, with no result, when there is no
card or any phase fails.

Output, in order: the card's name and power limit (nvidia-smi), the build
time, the phases ``lrn_kernel``, ``alexnet_pred``, ``lrn_bwd_kernel``,
``alexnet_train``, ``uniform_kernel``, ``rrelu_alexnet_train``,
``cli_mnist_conv``, ``cli_imagenet_train``, ``cli_imagenet_pred``,
``cli_bowl_pred_raw``, ``flash_fwd_kernel``, ``lm_serve``, ``lm_serve_long``,
``flash_bwd_kernel``, ``lm_train``, ``lm_train_long``, ``lm_hd256``,
``lm_hd512``, ``ring_step_kernels``, ``lm_sp_train_long_ring``,
``lm_sp_train_long_ulysses`` and ``lm_sp_train_ring`` (kernel checks, the
main paths' checks, throughput and profiles), the wall time, then a JSON
line ``{"kernels": [...]}`` and, last, the JSON result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SEED = 0
BATCH = 256
# the torch device of the kernel checks and the api dev spec of the main
# paths
DEV = "cuda"
NET_DEV = "gpu"
# H100 SXM data-sheet peaks (dense): device memory rate and fp32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32-accurate products on the tensor cores: 3xTF32, three TF32 products
# (495 TFLOP/s dense) per fp32 product. The rate of the fp32 bound of
# every attention kernel (the flash forward and backward, the ring steps),
# all on the tensor cores; the bound at FP32_OPS_PER_S is printed beside
# it, for comparison with the SIMT kernels they replaced
FP32_3XTF32_OPS_PER_S = 495e12 / 3
# dense bf16 on the tensor cores: the least time for bf16 attention inputs
BF16_OPS_PER_S = 989e12
# LRN forward per element: square, window add and subtract, scale and
# shift, pow (counted as 3: log, multiply, exp), output multiply
LRN_OPS_PER_ELEM = 9
# LRN backward per element: pow (3), n^-b / n (1), g*x*n^(-b-1) (2), window
# add and subtract (2), g*n^-b - coef*x*s (4)
LRN_BWD_OPS_PER_ELEM = 12
# main-path LRN inputs of AlexNet at batch 256 (lrn1 after pool1, lrn2
# after pool2)
LRN_SHAPES = {"lrn1": (BATCH, 96, 27, 27), "lrn2": (BATCH, 256, 13, 13)}
LRN_ARGS = dict(nsize=5, alpha=0.001, beta=0.75, knorm=1.0)
# kernel vs plain version: fp32 to relative 1e-5 (the reference's PairTest
# bar); bf16 output to 2e-2 relative (both round the same f32 value to
# bf16, and an f32 difference of an ulp can move that rounding by one bf16
# ulp, 2^-8); the f32 norm always to 1e-5
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
NORM_RTOL = 1e-5
# the backward kernel against lrn_bwd_ref: the same relative bars, plus an
# absolute 8 f32 epsilons of the largest |dx|. dx is the difference of two
# terms that can cancel, so an element can pass near zero where its terms
# do not; there the few ulps by which the two versions' terms differ (the
# kernel's powf and PyTorch's pow may round apart) are a large relative
# error but a tiny absolute one
BWD_ATOL_EPS = 8
# AlexNet top[-1] (softmax probabilities) with the kernel vs with the plain
# LRN swapped in, on the card: same convs, same order, so only the LRN's
# own rounding (an fp32 ulp or two) reaches the output
PRED_RTOL, PRED_ATOL = 1e-5, 1e-8
# the card against the port's CPU path on a small batch: cuDNN and the CPU
# sum conv and fullc in different orders
CPU_RTOL, CPU_ATOL = 1e-4, 1e-7
# training
TRAIN_STEPS = 10
# The kernel-vs-plain one-step comparison below runs with cuDNN off
# (PyTorch's native convolutions) so that the two runs differ in the LRN
# backward alone. The weight gradients are the port's own
# (ops.conv2d_weight, held to float64 in the "conv layer ... vs float64"
# lines): cuDNN's fp32 one of conv2 (5x5, pad 2, two groups) was several
# 1e-3 of its largest element off float64.
# Parameters after one step with the backward kernel vs with lrn_bwd_ref
# swapped in: relative 1e-5 plus 1e-5 of the tensor's largest update. Only
# the LRN backward's rounding differs; it reaches the gradients of
# conv1/conv2 as a few ulps of their largest terms, and the step moves each
# parameter by lr times its gradient
STEP_RTOL, STEP_ATOL_UPDATE = 1e-5, 1e-5
# parameters after one step on the card vs the port's CPU path (4 images,
# dropout off): relative 1e-5 plus 1e-4 of the tensor's largest update.
# The card and the CPU sum every conv, fullc and their gradients in other
# orders, and a gradient element that nearly cancels carries that absolute
# error
CPU_STEP_RTOL, CPU_STEP_ATOL_UPDATE = 1e-5, 1e-4
# every conv's weight gradient as the port computes it (ops.conv2d_weight)
# against float64: 1e-5 of its largest element (the reference's bar)
WGRAD_TOL = 1e-5

# flash attention forward: (name, b, h, nkv, L, d, causal, window). The
# first is the main path's: the LM's prefill, 4 launches per request
FLASH_SHAPES = [
    ("lm_prefill", 8, 8, 8, 1024, 64, True, 0),
    ("lm_full_sequence", 8, 8, 8, 2048, 64, True, 0),
    ("long_prefill_gqa_window", 2, 8, 2, 4096, 64, True, 1024),
    ("ragged_1000", 2, 8, 8, 1000, 64, True, 0),
    ("ragged_1000_noncausal", 2, 8, 8, 1000, 64, False, 0),
    ("lm_conf_d16", 16, 4, 4, 256, 16, True, 0),
    ("d128_gqa", 2, 8, 2, 1024, 128, True, 0),
    # head dims between the compiled widths (run in the next one)
    ("d8", 2, 4, 4, 512, 8, True, 0),
    ("d24_gqa_window", 2, 8, 2, 1000, 24, True, 256),
    ("d200_window", 2, 4, 2, 1000, 200, True, 300),
    # Ulysses' local attention on the long recipe at seq_parallel 4: a
    # quarter of the 8 query heads, k/v broadcast to them (group 1)
    ("ulysses_rank_long", 2, 2, 2, 8192, 64, True, 1024),
]
# kernel vs flash_fwd_ref: rtol 1e-5 (fp32) or 2e-2 (bf16, both round the
# same f32 value to bf16, an f32 ulp apart can round one bf16 ulp apart)
# plus 8 f32 epsilons of the largest |out|: out is a convex combination of
# v rows, summed blockwise with an online rescale in the kernel and densely
# in the plain version, so an element near zero carries a few ulps of the
# largest terms. lse (f32 in both) to rtol 1e-5 plus 8 epsilons of its
# largest magnitude
FLASH_ATOL_EPS = 8

# the LM that bench.py measures, served at full width in fp32
LM_ARGS = dict(vocab=8192, dim=512, nhead=8, nlayer=4)
LM_SEQ, LM_BATCH, LM_PROMPT, LM_NEW = 2048, 8, 1024, 64
LM_RAGGED = (1024, 1100)
# its long-context recipe (bench.py:301-310)
LONG_EXTRA = "nkvhead = 2\nattn_window = 1024\nrope = 1\n"
LONG_SEQ, LONG_BATCH, LONG_PROMPT, LONG_NEW = 8192, 2, 4096, 32
# flash attention backward: (name, b, h, nkv, L, d, causal, window). The
# first is the main path's: the bench.py LM's training step, 4 launches of
# each kernel per step; the second the long recipe's
FLASH_BWD_SHAPES = [
    ("lm_train", 8, 8, 8, 2048, 64, True, 0),
    ("long_train_gqa_window", 2, 8, 2, 8192, 64, True, 1024),
    ("ragged_1000", 2, 8, 8, 1000, 64, True, 0),
    ("ragged_200", 4, 8, 8, 200, 64, True, 0),
    ("ragged_1000_noncausal", 2, 8, 8, 1000, 64, False, 0),
    ("nkv1", 2, 8, 1, 1024, 64, True, 0),
    ("window_64", 2, 8, 2, 1024, 64, True, 64),
    ("d8", 2, 4, 4, 512, 8, True, 0),
    ("d16", 4, 4, 4, 512, 16, True, 0),
    ("d24_gqa", 2, 8, 2, 1000, 24, True, 0),
    ("d32_window", 2, 4, 2, 1000, 32, True, 100),
    ("d128_gqa", 2, 8, 2, 1024, 128, True, 0),
    ("d200_window", 2, 4, 2, 1000, 200, True, 300),
    ("ulysses_rank_long", 2, 2, 2, 8192, 64, True, 1024),
]
# backward kernels vs flash_bwd_ref: dq, dk, dv within 1e-5 (fp32) or 2e-2
# (bf16) of the largest magnitude compared. The kernels sum per 64-wide
# tile, the plain version densely; in bf16 both round the same f32 sums,
# 2^-8 relative, and the gradient sums many such terms
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the LM training phases: (phase, seq, batch, attention keys, the reduced
# (seq, batch) of the card-vs-CPU step). The long recipe's reduced seq
# exceeds its window, so that the window binds on both sides
LM_TRAIN = [("lm_train", LM_SEQ, LM_BATCH, "", 256, 2),
            ("lm_train_long", 8192, 2, "nkvhead = 2\nattn_window = 1024\n"
             "rope = 1\n", 1152, 1)]
LM_TRAIN_STEPS = 10
LM_ETA = 0.003
# The config's Adam at eta 0.003 from this random init does not lower the
# loss of a fixed batch within 10 steps, in the JAX package either (its own
# f32 run of this LM on the CPU, L 128, batch 8: 9.70, 26.4, inf, inf, inf,
# inf, 21.7, 9.05, 8.54, 8.92, 8.33; at eta 3e-4: 9.70, 9.04, ... 5.11,
# falling at every step). The main path runs the config as it is; the
# check that training lowers the loss runs the same start at this eta
LM_LOSS_ETA = 3e-4
# one LM step's gradients with the kernels against the step with
# flash_bwd_ref swapped in, and the card against the CPU path: 1e-4 of each
# tensor's largest magnitude. The attention gradients differ by the
# backward's summation order (f32 ulps of the largest terms) and pass back
# through every block; the embedding's gradient is a scatter-add, whose
# order on the card may change from run to run (the spread of two identical
# steps is printed); the card and the CPU sum every product in other orders
LM_GRAD_TOL = 1e-4
# parameters after one Adam step from the same start, card vs CPU: Adam's
# first step moves an element by eta g / (|g| + ADAM_C) (the updater's
# epsilon 1e-8 over the square root of its decay2 0.001, which the LM
# config keeps), a map whose slope is at most eta / ADAM_C. An element whose
# gradient is near zero thus turns a gradient difference of a few ulps into
# a visible share of eta, and the two sides are held to that: per element
# eta |g_card - g_cpu| / ADAM_C, plus 1e-6 of eta and two f32 ulps of the
# parameter for the roundings of the step itself
ADAM_C = 1e-8 / 0.001 ** 0.5
LM_LOSS_RTOL = 1e-5
# the LM with the kernel vs with flash_fwd_ref swapped in, on the card:
# log-probabilities of the prefill and of every teacher-forced step to
# absolute 1e-4. Only the attention's summation order differs; a few f32
# ulps of an attention output grow through 4 blocks, the vocab head and
# the log-softmax to ~1e-6 of logits of magnitude ~10. Greedy tokens must
# be equal wherever the plain run's top-2 margin exceeds twice that
LOGP_TOL = 1e-4
# a ReLU mask one side takes from the other may hide rounding alone: every
# pre-activation that flips lies within MASK_FLIP_MAG of its node's largest
# magnitude of 0, and at most MASK_FLIP_SHARE of them flip (H100 runs of
# this script: up to 10 of 67 M, within 1.3e-7). A fault that moves
# pre-activations flips larger ones, or many
MASK_FLIP_MAG, MASK_FLIP_SHARE = 1e-6, 1e-5

# the RReLU AlexNet: ImageNet.conf with its 7 relu layers made insanity
# (slopes from U[3, 8], the range of Xu et al., arXiv:1505.00853) and its
# 3 max_pooling layers made insanity_max_pooling (keep 0.75, each
# displacement on 1/16 of the pixels); one uniform draw per layer and step
RRELU = dict(lb=3.0, ub=8.0, keep=0.75)
RRELU_LAYERS = {"insanity": 7, "insanity_max_pooling": 3}
RRELU_RATE_STEPS = 5
# the uniform kernel against uniform_ref, bitwise: (name, seed, shape). The
# first is the main path's largest draw, conv1's output at batch 256
UNIFORM_SHAPES = [
    ("conv1", SEED, (BATCH, 96, 55, 55)),
    ("n1", 1, (1,)),
    ("n3", 2, (3,)),
    ("n5", 3, (5,)),
    ("n4k_plus_3", 4, (4 * 250000 + 3,)),
    ("seed_above_2^32", (1 << 32) + 11, (BATCH, 256, 27, 27)),
]
# Philox4x32-10 per counter: 10 rounds of 2 low and 2 high 32-bit products
# and 4 xors, 9 key bumps of 2 adds, then per word a shift, a conversion
# and a multiply: ~110 integer operations per 4 elements
UNIFORM_OPS_PER_ELEM = 28
# the draw's statistics: mean and variance within 5 standard errors of 1/2
# and 1/12; the one-sample Kolmogorov-Smirnov distance at 10^7 draws under
# 2e-3 (its 1% critical value there is 5.2e-4)
MOMENT_SIGMAS = 5
KS_DRAWS, KS_BAR = 10 ** 7, 2e-3

# the wide-head LMs: the bench.py LM with 2 heads (d_model 512 / 2 = 256
# per head) and with 1 head (512 per head, run in two slices of 256), fp32;
# each served through generate and trained through update, its flash
# kernels held at its own shape: {phase: (nhead, flash shape)}
HD_PHASES = {"lm_hd256": (2, ("lm_hd256", LM_BATCH, 2, 2, LM_SEQ, 256, True,
                              0)),
             "lm_hd512": (1, ("lm_hd512", LM_BATCH, 1, 1, LM_SEQ, 512, True,
                              0))}
HD_NEW = 16
HD_TRAIN_STEPS = 2

# sequence parallelism: the ring's virtual ranks on the card, and the ring
# steps at the long recipe's shard (b h = 2 * 8 query rows, 2 * 2 kv rows,
# sq = skv = 8192 / 4, d 64) in every class of offsets a step meets:
# (name, q_off, kv_off, causal, window)
SP_N = 4
RING_SHAPE = (2 * 8, 2 * 2, 2048, 2048, 64)
RING_CLASSES = [
    ("diagonal", 2048, 2048, True, 1024),
    ("visible", 4096, 0, True, 0),
    ("masked", 0, 2048, True, 1024),
    ("window_cut", 2048, 0, True, 1024),
    ("noncausal", 0, 4096, False, 0),
]
# the bench.py LM's shard at sp = SP_N (b h = 8 * 8 query and kv rows,
# sq = skv = 2048 / 4, causal, no window), in the classes its ring meets,
# then wide heads and sq != skv: (name, bh, bkv, sq, skv, d, q_off, kv_off,
# causal, window)
RING_EDGE = [
    ("bench_diagonal", 64, 64, 512, 512, 64, 512, 512, True, 0),
    ("bench_visible", 64, 64, 512, 512, 64, 1536, 512, True, 0),
    ("bench_masked", 64, 64, 512, 512, 64, 512, 1024, True, 0),
    ("d256_gqa", 8, 2, 1024, 1024, 256, 1024, 0, True, 1024),
    ("d512", 4, 4, 1024, 1024, 512, 1024, 1024, True, 0),
    ("sq_2048_skv_1024", 16, 4, 2048, 1024, 64, 2048, 1024, True, 0),
]
# n ring steps over a whole sequence against the flash kernels (rows 4-6):
# (name, b, h, nkv, L, d, causal, window); the first is the long recipe's
# attention, the main path of lm_sp_train
RING_VS_FLASH = [
    ("long_recipe", 2, 8, 2, 8192, 64, True, 1024),
    ("bench_lm", 8, 8, 8, 2048, 64, True, 0),
    ("d256", 2, 2, 2, 2048, 256, True, 512),
    ("d512_noncausal", 1, 2, 1, 2048, 512, False, 0),
]
# the ring steps against their plain versions and n steps against the flash
# kernels: 1e-5 (fp32) or 2e-2 (bf16) of the largest magnitude compared;
# m and l (f32 on both sides, one max and one sum of the same scores) to
# 1e-5 in both
RING_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the sequence-parallel training runs: (phase, seq, batch, attention keys,
# sp_mode), each one full-sequence predict_device and SP_STEPS updates
LM_SP = [("lm_sp_train_long_ring", 8192, 2, LONG_EXTRA, "ring"),
         ("lm_sp_train_long_ulysses", 8192, 2, LONG_EXTRA, "ulysses"),
         ("lm_sp_train_ring", LM_SEQ, LM_BATCH, "", "ring")]
SP_STEPS = 2

# fp32 kernel times by (kernel, shape name), filled by the kernel phases
KERNEL_MS = {}
# what names a kernel in a profile where its symbol does not: the flash
# kernels and the ring steps share their bodies (attn_fwd_tc_kernel, ...)
# and differ by the IO policy in the template's arguments
KERNEL_SYMBOLS = {"flash_fwd": "FlashFwdOut", "flash_bwd_dq": "FlashDqOut",
                  "flash_bwd_dkv": "FlashDkvOut",
                  "ring_fwd_step": "RingFwdCarry",
                  "ring_dq_step": "RingDqCarry",
                  "ring_dkv_step": "RingDkvCarry"}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip()


def ptxas_summary(text: str) -> str:
    """Registers and spills per kernel instantiation from nvcc's -Xptxas -v
    output, each named by its element type, head dim, exact-width flag, the
    wide flag (a head dim above the widest compiled width, in slices) and
    the flash forward's multi-chunk flag where the mangled name carries
    them (``float/64/exact``, ``float/128/padded/wide``)."""
    import re
    out, inst = [], "?"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"I(f|13__nv_bfloat16)(?:Li(\d+)E)?(?:Lb([01])E)?"
                          r"(?:Lb([01])E)?(?:Lb([01])E)?", m.group(1))
            inst = "?" if not t else "/".join(
                [("float" if t.group(1) == "f" else "bf16")] +
                ([t.group(2)] if t.group(2) else []) +
                ([("exact", "padded")[t.group(3) == "0"]] if t.group(3)
                 else []) + (["wide"] if t.group(4) == "1" else []) +
                (["multi"] if t.group(5) == "1" else []))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append("%s %s regs %s B spill" % (inst, m.group(1), spill))
    return ", ".join(out)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() on the card, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / |want| over elements with want != 0."""
    got, want = got.float(), want.float()
    nz = want != 0
    return float(((got - want).abs()[nz] / want.abs()[nz]).max())


def check_close(what, got, want, rtol, atol=0.0):
    """Print max abs/rel error and raise unless |got-want| <= atol +
    rtol*|want| everywhere."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_abs, max_rel = float(err.max()), rel_err(got, want)
    ok = bool((err <= atol + rtol * want.abs()).all())
    log("  %s: max_abs_err %.3e max_rel_err %.3e (tolerance rtol %.0e "
        "atol %.0e) %s" % (what, max_abs, max_rel, rtol, atol,
                           "ok" if ok else "FAILED"))
    if not ok:
        raise AssertionError("%s disagrees beyond tolerance" % what)
    return max_abs


def library(F, x, ref_out):
    """Time of F.local_response_norm on x (same size, alpha, beta, k; the
    same window as cxxnet's for odd nsize), a yardstick the port never
    calls; None where PyTorch has no such kernel for x's dtype."""
    a = LRN_ARGS

    def call():
        return F.local_response_norm(x, a["nsize"], a["alpha"], a["beta"],
                                     a["knorm"])
    try:
        out = call()
    except NotImplementedError as e:
        log("  library F.local_response_norm: not available (%s)" % e)
        return None
    log("  library F.local_response_norm vs lrn_ref: max_rel_err %.3e "
        "(yardstick only)" % rel_err(out, ref_out))
    return time_ms(call)


def library_bwd(F, x, g, ref_dx):
    """Time of the backward of F.local_response_norm on x with upstream g
    (autograd.grad over a kept graph), a yardstick the port never calls;
    None where PyTorch has no such kernel for x's dtype."""
    a = LRN_ARGS
    xl = x.detach().clone().requires_grad_()
    try:
        out = F.local_response_norm(xl, a["nsize"], a["alpha"], a["beta"],
                                    a["knorm"])

        def call():
            return torch.autograd.grad(out, xl, g, retain_graph=True)[0]
        dx = call()
    except NotImplementedError as e:
        log("  library backward of F.local_response_norm: not available "
            "(%s)" % e)
        return None
    log("  library backward of F.local_response_norm vs lrn_bwd_ref: "
        "max_rel_err %.3e (yardstick only)" % rel_err(dx, ref_dx))
    return time_ms(call)


def _add_fp32(rec, kernel_ms, plain_ms, library_ms, bound_ms, bound_by):
    """Sum one fp32 main-path shape's times into a kernel record."""
    rec["ms"] += kernel_ms
    rec["plain_ms"] += plain_ms
    rec["library_ms"] = None if (library_ms is None or
                                 rec["library_ms"] is None) \
        else rec["library_ms"] + library_ms
    rec["bound_ms"] += bound_ms
    rec["bound_by"] = bound_by


def _bound(n, nbytes, ops_per_elem):
    """(bound ms, what bounds it, bytes ms, ops ms) for n elements moving
    nbytes over the card's memory rate and doing ops_per_elem fp32
    operations each over its fp32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * ops_per_elem / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms, ops_ms)


def _new_rec():
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "max_abs_err": 0.0, "bound_by": "bytes"}


def phase_lrn_kernel(lrn):
    """The LRN kernel against lrn_ref at the main path's shapes, fp32 and
    bf16 (the f32 norm bitwise), and its no-norm form (inference) against
    its own bound; returns the per-kernel record (sums over the two fp32
    main-path shapes, i.e. one forward's worth of LRN work)."""
    import torch.nn.functional as F
    log("phase lrn_kernel")
    rec = dict(_new_rec(), no_norm_ms=0.0, no_norm_bound_ms=0.0)
    a = LRN_ARGS
    rng = np.random.RandomState(SEED)
    for name, shape in LRN_SHAPES.items():
        host = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3)
        for dtype in (torch.float32, torch.bfloat16):
            x = host.to(DEV, dtype)
            out, norm = lrn.lrn_fwd_cuda(x, **a)
            torch.cuda.synchronize()
            ref_out, ref_norm = lrn.lrn_ref_with_norm(x, **a)
            tag = "%s %s %s" % (name, tuple(shape), str(dtype)[6:])
            log(" " + tag)
            err = check_close("out vs lrn_ref", out, ref_out, RTOL[dtype])
            check_close("norm vs lrn_ref", norm, ref_norm, NORM_RTOL)
            # the kernel sums each window in the plain version's order
            same = bool(torch.equal(norm, ref_norm))
            log("  norm bitwise equal to lrn_ref's: %s" % same)
            if not same:
                raise AssertionError("the f32 norm is not bitwise the plain "
                                     "version's")
            kernel_ms = time_ms(lambda: lrn.lrn_fwd_cuda(x, **a))
            plain_ms = time_ms(lambda: lrn.lrn_ref_with_norm(x, **a))
            library_ms = library(F, x, ref_out)
            n = x.numel()
            nbytes = n * (2 * x.element_size() + 4)   # x in; out, norm out
            bound_ms, bound_by, _, ops_ms = _bound(n, nbytes,
                                                   LRN_OPS_PER_ELEM)
            log("  kernel_ms %.4f plain_ms %.4f library_ms %s bound_ms "
                "%.4f (%d bytes; ops bound %.4f ms) kernel/bound %.2f"
                % (kernel_ms, plain_ms, library_ms, bound_ms, nbytes, ops_ms,
                   kernel_ms / bound_ms))
            # inference: the same kernel storing no norm (predict's path)
            out_nn, none = lrn.lrn_fwd_cuda(x, **a, with_norm=False)
            torch.cuda.synchronize()
            if none is not None or not torch.equal(out_nn, out):
                raise AssertionError("the no-norm forward's out differs from "
                                     "the training forward's")
            nn_ms = time_ms(lambda: lrn.lrn_fwd_cuda(x, **a, with_norm=False))
            nn_bound, nn_by, _, _ = _bound(n, n * 2 * x.element_size(),
                                           LRN_OPS_PER_ELEM)
            log("  no-norm kernel_ms %.4f bound_ms %.4f (%d bytes) "
                "kernel/bound %.2f; out bitwise the training forward's"
                % (nn_ms, nn_bound, n * 2 * x.element_size(),
                   nn_ms / nn_bound))
            if dtype == torch.float32:
                _add_fp32(rec, kernel_ms, plain_ms, library_ms, bound_ms,
                          bound_by)
                rec["no_norm_ms"] += nn_ms
                rec["no_norm_bound_ms"] += nn_bound
                rec["no_norm_bound_by"] = nn_by
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            del x, out, norm, ref_out, ref_norm, out_nn
    torch.cuda.empty_cache()
    return rec


def phase_lrn_bwd_kernel(lrn):
    """The LRN backward kernel against lrn_bwd_ref at the main path's
    shapes, fp32 and bf16, on x, the norm lrn_fwd_cuda saves for it and an
    upstream gradient g; returns the per-kernel record (sums over the two
    fp32 main-path shapes, i.e. one backward's worth of LRN work)."""
    import torch.nn.functional as F
    log("phase lrn_bwd_kernel")
    rec = _new_rec()
    a = LRN_ARGS
    b = dict(nsize=a["nsize"], alpha=a["alpha"], beta=a["beta"])
    rng = np.random.RandomState(SEED + 3)
    for name, shape in LRN_SHAPES.items():
        host_x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3)
        host_g = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            x, g = host_x.to(DEV, dtype), host_g.to(DEV, dtype)
            _, norm = lrn.lrn_fwd_cuda(x, **a)
            dx = lrn.lrn_bwd_cuda(x, norm, g, **b)
            torch.cuda.synchronize()
            ref = lrn.lrn_bwd_ref(x, norm, g, **b)
            log(" %s %s %s" % (name, tuple(shape), str(dtype)[6:]))
            if dx.dtype != dtype:
                raise AssertionError("dx dtype %s, expected %s"
                                     % (dx.dtype, dtype))
            atol = BWD_ATOL_EPS * torch.finfo(torch.float32).eps \
                * float(ref.float().abs().max())
            err = check_close("dx vs lrn_bwd_ref", dx, ref, RTOL[dtype], atol)
            kernel_ms = time_ms(lambda: lrn.lrn_bwd_cuda(x, norm, g, **b))
            plain_ms = time_ms(lambda: lrn.lrn_bwd_ref(x, norm, g, **b))
            library_ms = library_bwd(F, x, g, ref)
            n = x.numel()
            # x, g and the f32 norm in; dx out
            nbytes = n * (3 * x.element_size() + 4)
            bound_ms, bound_by, _, ops_ms = _bound(n, nbytes,
                                                   LRN_BWD_OPS_PER_ELEM)
            log("  kernel_ms %.4f plain_ms %.4f library_ms %s bound_ms "
                "%.4f (%d bytes; ops bound %.4f ms) kernel/bound %.2f"
                % (kernel_ms, plain_ms, library_ms, bound_ms, nbytes, ops_ms,
                   kernel_ms / bound_ms))
            if dtype == torch.float32:
                _add_fp32(rec, kernel_ms, plain_ms, library_ms, bound_ms,
                          bound_by)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            del x, g, norm, dx, ref
    torch.cuda.empty_cache()
    return rec


def scratch_file(name: str) -> str:
    """A path under the ignored build/cxxnet_tpu_torch/ directory."""
    d = os.path.join(REPO, "build", "cxxnet_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)


def imagenet_cfg() -> str:
    cfg = open(os.path.join(REPO, "example/ImageNet/ImageNet.conf")).read()
    return cfg + "\nbatch_size = %d\nseed = %d\n" % (BATCH, SEED)


def phase_alexnet_pred(lrn, api):
    """AlexNet inference through the port's API on the card; returns the
    LRN launches counted while the main path ran."""
    log("phase alexnet_pred")
    cfg = imagenet_cfg()
    net = api.Net(dev=NET_DEV, cfg=cfg)
    t0 = time.time()
    net.init_model()
    torch.cuda.synchronize()
    log("  init_model %.2f s" % (time.time() - t0))
    x = np.random.RandomState(SEED + 1).randn(BATCH, 3, 227, 227).astype(
        np.float32)

    # the main path: the counts start at 0 here and are read right after
    lrn.launches = lrn.no_norm_launches = 0
    pred = net.predict(x)
    top = net.extract(x, "top[-1]")
    torch.cuda.synchronize()
    launches, no_norm = lrn.launches, lrn.no_norm_launches
    log("  lrn_fwd launches: %d over 2 forwards, %d of them storing no norm"
        % (launches, no_norm))
    if launches != 4 or no_norm != 4:
        raise AssertionError("expected 2 LRN kernel launches per forward, "
                             "none storing a norm; counted %d over 2, %d "
                             "without a norm" % (launches, no_norm))
    if pred.shape != (BATCH,) or top.shape != (BATCH, 1, 1, 1000):
        raise AssertionError("shapes %s %s" % (pred.shape, top.shape))
    if not np.isfinite(top).all():
        raise AssertionError("non-finite softmax output")
    row_err = float(np.abs(top.sum(axis=3) - 1.0).max())
    log("  softmax rows sum to 1 within %.3e (tolerance 1e-5)" % row_err)
    if row_err > 1e-5:
        raise AssertionError("softmax rows do not sum to 1")
    if not (pred == top.reshape(BATCH, -1).argmax(axis=1)).all():
        raise AssertionError("predict disagrees with argmax of top[-1]")

    # the same net with the plain LRN swapped in
    kernel_forward = lrn.forward
    lrn.forward = lrn.lrn_ref
    try:
        top_ref = net.extract(x, "top[-1]")
    finally:
        lrn.forward = kernel_forward
    check_close("top[-1] kernel vs lrn_ref swapped in",
                torch.from_numpy(top), torch.from_numpy(top_ref),
                PRED_RTOL, PRED_ATOL)

    # the card against the port's CPU path, same weights, small batch
    fname = scratch_file("chip_smoke.model")
    net.save_model(fname)
    cpu = api.Net(dev="cpu", cfg=cfg)
    cpu.load_model(fname)
    os.remove(fname)
    small = x[:4]
    check_close("top[-1] card vs CPU path (4 images)",
                torch.from_numpy(net.extract(small, "top[-1]")),
                torch.from_numpy(cpu.extract(small, "top[-1]")),
                CPU_RTOL, CPU_ATOL)

    # throughput: predict_device ends in an on-device argmax; sync per call
    xs = torch.from_numpy(x).to(DEV)

    def images_per_s(iters=10):
        for _ in range(2):
            net.predict_device(xs)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            net.predict_device(xs)
            torch.cuda.synchronize()
        return BATCH * iters / (time.perf_counter() - t)

    with_kernel = images_per_s()
    lrn.forward = lrn.lrn_ref
    try:
        with_plain = images_per_s()
    finally:
        lrn.forward = kernel_forward
    log("  AlexNet fp32 batch %d: %.1f images/s with the LRN kernel, %.1f "
        "with the plain LRN" % (BATCH, with_kernel, with_plain))
    profile_forward(lambda: net.predict_device(xs))
    return launches


@contextlib.contextmanager
def plain_lrn_backward(lrn):
    """LRNFunction's backward runs lrn_bwd_ref in place of the kernel (the
    forward kernel still runs and saves the norm)."""
    kernel = lrn.lrn_bwd_cuda
    lrn.lrn_bwd_cuda = lrn.lrn_bwd_ref
    try:
        yield
    finally:
        lrn.lrn_bwd_cuda = kernel


def cross_entropy(probs: np.ndarray, labels: np.ndarray) -> float:
    """Mean softmax cross-entropy of a (batch, 1, 1, K) top[-1] output,
    computed on the host in float64."""
    p = probs.reshape(probs.shape[0], -1).astype(np.float64)
    return float(-np.log(p[np.arange(p.shape[0]),
                           labels.astype(np.int64)]).mean())


def _params(net):
    return [{k: v.detach().clone() for k, v in p.items()}
            for p in net.net_.params]


@contextlib.contextmanager
def cudnn_off():
    """Convolutions through PyTorch's native kernels instead of cuDNN."""
    was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = was


def compare_params(what, got, want, start, rtol, atol_update):
    """Hold every parameter tensor to |got - want| <= rtol |want| +
    atol_update * (the tensor's largest |want - start|, its largest
    update); print the worst ratio of error to bound."""
    worst, where = 0.0, ""
    for i, (g, w, s) in enumerate(zip(got, want, start)):
        for k in w:
            err = (g[k].float() - w[k].float()).abs()
            bound = rtol * w[k].float().abs() \
                + atol_update * float((w[k] - s[k]).abs().max())
            ratio = float((err / bound.clamp_min(1e-30)).max())
            if ratio > worst:
                worst, where = ratio, "layer %d %s" % (i, k)
    verdict = "ok" if worst <= 1.0 else "FAILED"
    log("  %s: worst error/bound %.3e at %s (rtol %.0e, atol %.0e of the "
        "largest update) %s" % (what, worst, where or "-", rtol, atol_update,
                                verdict))
    if worst > 1.0:
        raise AssertionError("%s disagrees beyond tolerance" % what)


def _one_step(api, fname, cfg, x, y, dev=None):
    """(params before, params after) of one update of a net loaded from
    fname: the same weights, momentum and dropout seed on every call; on
    the main paths' device unless ``dev`` names another."""
    net = api.Net(dev=dev or NET_DEV, cfg=cfg)
    net.load_model(fname)
    before = _params(net)
    net.update(x, y)
    return before, _params(net)


def cudnn_conv2d_weight(x, w_shape, g, stride, pad, groups):
    """The weight gradient as cuDNN computes it, which the port took before
    ops.conv2d_weight: a yardstick and the "before" of the training
    throughput, swapped in by hand."""
    from torch.nn.grad import conv2d_weight
    return conv2d_weight(x, w_shape, g, stride=stride, padding=pad,
                         groups=groups)


def conv_vs_f64(net, x, y, ops):
    """Each conv's weight gradient as the port computes it
    (ops.conv2d_weight) against float64, held to WGRAD_TOL of its largest
    element, on the main path's own conv inputs, weights and output
    gradients of one training forward. Reported beside it: the output and
    data gradient (cuDNN) and cuDNN's weight gradient in its default and
    deterministic modes and with cuDNN off; timed: the port's and cuDNN's
    weight gradients."""
    from torch.nn.grad import conv2d_input
    t = net.net_
    infos = t.net_cfg.layers
    convs = [i for i, lay in enumerate(t.net.layers)
             if lay.type_name == "conv" and not t.net.is_shared[i]]
    params = [{k: v.detach().requires_grad_() for k, v in p.items()}
              for p in t.params]
    labels = t.net.label_info_from(torch.from_numpy(y.reshape(-1, 1))
                                   .to(t.dev))
    values, loss = t.net.forward(
        params, t._input(x), labels=labels, train=True,
        gen=torch.Generator(device=t.dev).manual_seed(SEED))
    douts = torch.autograd.grad(loss, [values[infos[i].nindex_out[0]]
                                       for i in convs])

    def rel(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    def err(got, want):
        e = (got.double() - want).abs()
        return "max_err/max %.3e norm-wise %.3e" % (
            float(e.max() / want.abs().max()), float(e.norm() / want.norm()))
    worst, port_total, cudnn_total = 0.0, 0.0, 0.0
    for i, dout in zip(convs, douts):
        p = t.net.layers[i].param
        inp = values[infos[i].nindex_in[0]].detach()
        w = params[i]["wmat"].detach().reshape(
            p.num_channel, p.num_input_channel // p.num_group,
            p.kernel_height, p.kernel_width)
        args = (p.stride, (p.pad_y, p.pad_x), p.num_group)
        kw = dict(stride=p.stride, padding=(p.pad_y, p.pad_x),
                  groups=p.num_group)
        want = torch.nn.functional.conv2d(inp.double(), w.double(), **kw)
        line = ["output (cuDNN) %s" % err(torch.nn.functional.conv2d(
            inp, w, **kw), want)]
        want = conv2d_input(inp.shape, w.double(), dout.double(), **kw)
        line.append("data grad (cuDNN) %s" % err(
            conv2d_input(inp.shape, w, dout, **kw), want))
        want = cudnn_conv2d_weight(inp.double(), w.shape, dout.double(),
                                   *args)
        port = rel(ops.conv2d_weight(inp, w.shape, dout, *args), want)
        worst = max(worst, port)
        line.append("cuDNN weight grad %s" % err(
            cudnn_conv2d_weight(inp, w.shape, dout, *args), want))
        torch.backends.cudnn.deterministic = True
        try:
            line.append("(deterministic) %s" % err(
                cudnn_conv2d_weight(inp, w.shape, dout, *args), want))
        finally:
            torch.backends.cudnn.deterministic = False
        with cudnn_off():
            line.append("(cuDNN off) %s" % err(
                cudnn_conv2d_weight(inp, w.shape, dout, *args), want))
        del want
        port_ms = time_ms(lambda: ops.conv2d_weight(inp, w.shape, dout,
                                                    *args), iters=5)
        cudnn_ms = time_ms(lambda: cudnn_conv2d_weight(inp, w.shape, dout,
                                                       *args), iters=5)
        port_total += port_ms
        cudnn_total += cudnn_ms
        log("  conv layer %d %s vs float64: port weight grad max_err/max "
            "%.3e (tolerance %.0e) %s, %.3f ms (cuDNN's %.3f ms); reported: "
            "%s" % (i, tuple(w.shape), port, WGRAD_TOL,
                    "ok" if port <= WGRAD_TOL else "FAILED", port_ms,
                    cudnn_ms, "; ".join(line)))
    log("  weight gradients of the %d convs: port %.3f ms, cuDNN %.3f ms "
        "per step" % (len(convs), port_total, cudnn_total))
    if worst > WGRAD_TOL:
        raise AssertionError("a conv weight gradient is %.3e of its largest "
                             "element off float64" % worst)


def phase_alexnet_train(lrn, api, ops):
    """AlexNet training through the port's API on the card; returns the
    LRN forward and backward launches counted while the main path ran."""
    log("phase alexnet_train")
    cfg = imagenet_cfg()
    net = api.Net(dev=NET_DEV, cfg=cfg)
    net.init_model()
    rng = np.random.RandomState(SEED + 2)
    x = rng.randn(BATCH, 3, 227, 227).astype(np.float32)
    y = rng.randint(0, 1000, size=BATCH).astype(np.float32)
    fname = scratch_file("chip_smoke_train.model")
    net.save_model(fname)
    start = _params(net)
    loss0 = cross_entropy(net.extract(x, "top[-1]"), y)

    # the main path: the counts start at 0 here and are read right after
    lrn.launches = 0
    lrn.bwd_launches = 0
    t = time.perf_counter()
    for step in range(TRAIN_STEPS):
        net.update(x, y)
        if (lrn.launches, lrn.bwd_launches) != (2 * step + 2, 2 * step + 2):
            raise AssertionError(
                "expected 2 LRN forward and 2 backward kernel launches per "
                "update, counted %d and %d after %d updates"
                % (lrn.launches, lrn.bwd_launches, step + 1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    fwd, bwd = lrn.launches, lrn.bwd_launches
    log("  %d update steps in %.2f s (first steps included); lrn_fwd "
        "launches %d, lrn_bwd launches %d, 2 + 2 in every update"
        % (TRAIN_STEPS, wall, fwd, bwd))
    log("  train metrics over the steps:%s"
        % net.evaluate(None, "train").replace("\t", " "))
    loss1 = cross_entropy(net.extract(x, "top[-1]"), y)
    log("  fixed-batch cross-entropy %.6f before, %.6f after %d steps"
        % (loss0, loss1, TRAIN_STEPS))
    if not (np.isfinite(loss1) and loss1 < loss0):
        raise AssertionError("training loss did not fall: %r -> %r"
                             % (loss0, loss1))
    after = _params(net)
    for i, (p0, p1) in enumerate(zip(start, after)):
        for k in p0:
            if not bool(torch.isfinite(p1[k]).all()):
                raise AssertionError("layer %d %s not finite" % (i, k))
            if torch.equal(p0[k], p1[k]):
                raise AssertionError("layer %d %s did not change" % (i, k))
    log("  every parameter changed and is finite (%d tensors)"
        % sum(len(p) for p in after))

    conv_vs_f64(net, x, y, ops)

    # the kernel against the plain backward: one step from the same file
    # (weights, momentum, dropout seed), cuDNN off for the three runs (see
    # STEP_RTOL) so that only the LRN backward differs
    with cudnn_off():
        p0, with_kernel = _one_step(api, fname, cfg, x, y)
        _, again = _one_step(api, fname, cfg, x, y)
        with plain_lrn_backward(lrn):
            _, with_plain = _one_step(api, fname, cfg, x, y)
    spread = max(float((a[k] - b[k]).abs().max())
                 for a, b in zip(with_kernel, again) for k in a)
    log("  spread of two identical kernel steps (cuDNN off): max_abs %.3e"
        % spread)
    compare_params("one step (cuDNN off), kernel vs lrn_bwd_ref swapped in",
                   with_kernel, with_plain, p0, STEP_RTOL, STEP_ATOL_UPDATE)
    del with_kernel, again, with_plain

    # the card against the port's CPU path: one step on 4 images with
    # dropout off (threshold 0) on both sides; held with cuDNN off and with
    # cuDNN on (the main path's setting)
    cfg0 = cfg.replace("threshold = 0.5", "threshold = 0")
    small_x, small_y = x[:4], y[:4]
    with cudnn_off():
        p0, on_card = _one_step(api, fname, cfg0, small_x, small_y)
    _, on_card_cudnn = _one_step(api, fname, cfg0, small_x, small_y)
    _, on_cpu = _one_step(api, fname, cfg0, small_x, small_y, dev="cpu")
    on_cpu = [{k: v.to(DEV) for k, v in p.items()} for p in on_cpu]
    compare_params("one step (4 images, no dropout, cuDNN off), card vs CPU "
                   "path", on_card, on_cpu, p0, CPU_STEP_RTOL,
                   CPU_STEP_ATOL_UPDATE)
    compare_params("the same with cuDNN on, card vs CPU path", on_card_cudnn,
                   on_cpu, p0, CPU_STEP_RTOL, CPU_STEP_ATOL_UPDATE)
    del on_card, on_card_cudnn, on_cpu, p0
    os.remove(fname)

    # throughput: through Net.update on numpy (the host-to-card copy of the
    # batch included), then with the batch already on the card, kernel and
    # plain backward in turns
    def images_per_s(step, iters=5):
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            step()
            torch.cuda.synchronize()
        return BATCH * iters / (time.perf_counter() - t)

    from cxxnet_tpu_torch.io import DataBatch
    batch = DataBatch()
    batch.data = torch.from_numpy(x).to(DEV)
    batch.label = torch.from_numpy(y.reshape(-1, 1)).to(DEV)
    batch.batch_size = BATCH

    def numpy_step():
        net.update(x, y)

    def device_step():
        net.net_.update(batch)

    log("  AlexNet fp32 training batch %d through Net.update (numpy): %.1f "
        "images/s" % (BATCH, images_per_s(numpy_step)))
    torch.cuda.reset_peak_memory_stats()
    rates = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        if which == "plain":
            with plain_lrn_backward(lrn):
                rates[which].append(images_per_s(device_step))
        else:
            rates[which].append(images_per_s(device_step))
    log("  AlexNet fp32 training batch %d, batch on the card: %s images/s "
        "with the LRN backward kernel, %s with the plain LRN backward "
        "(in turns kernel, plain, plain, kernel); peak memory %.2f GB"
        % (BATCH, " / ".join("%.1f" % r for r in rates["kernel"]),
           " / ".join("%.1f" % r for r in rates["plain"]),
           torch.cuda.max_memory_allocated() / 1e9))
    # the weight gradient before this port's repair: cuDNN's, in turns
    rates = {"port": [], "cudnn": []}
    port_wgrad = ops.conv2d_weight
    for which in ("port", "cudnn", "cudnn", "port"):
        if which == "cudnn":
            ops.conv2d_weight = cudnn_conv2d_weight
        try:
            rates[which].append(images_per_s(device_step))
        finally:
            ops.conv2d_weight = port_wgrad
    log("  AlexNet fp32 training batch %d, batch on the card: %s images/s "
        "with the port's im2col weight gradient, %s with cuDNN's swapped in "
        "(in turns port, cuDNN, cuDNN, port)"
        % (BATCH, " / ".join("%.1f" % r for r in rates["port"]),
           " / ".join("%.1f" % r for r in rates["cudnn"])))
    profile_forward(device_step, unit="step", shares=("lrn_fwd", "lrn_bwd"))
    return fwd, bwd


def kept_pairs(L, causal, window, skv=None, q_off=0, kv_off=0):
    """(query, key) pairs of one head that the mask keeps, for L queries
    at the global positions q_off.. against skv keys (L by default) at
    kv_off.. (a ring step's block; 0 and 0 for a whole sequence)."""
    skv = L if skv is None else skv
    if not causal:
        return L * skv
    qpos = q_off + np.arange(L, dtype=np.int64)
    hi = np.minimum(qpos - kv_off + 1, skv)            # keys <= the query
    lo = np.maximum(qpos - window + 1 - kv_off, 0) if window > 0 else 0
    return int(np.clip(hi - lo, 0, None).sum())


def flash_work(b, h, nkv, L, d, causal, window, esize):
    """(operations, bytes) the flash forward needs: 4 d flops (q k^T and
    p v) per (query, key) pair the mask keeps, counted for this shape;
    q, k, v read once, out (input dtype) and lse (f32) written once."""
    ops = 4 * d * kept_pairs(L, causal, window) * b * h
    nbytes = esize * (2 * b * h * L * d + 2 * b * nkv * L * d) + 4 * b * h * L
    return ops, nbytes


def sdpa_kw(q, k, causal, window):
    """scaled_dot_product_attention's arguments for the port's mask: the
    grouped kv heads through enable_gqa, a window as a boolean mask."""
    L, h, nkv = q.shape[2], q.shape[1], k.shape[1]
    kw = dict(enable_gqa=h != nkv)
    if window:
        pos = torch.arange(L, device=q.device)
        diff = pos[:, None] - pos[None, :]
        kw["attn_mask"] = (diff >= 0) & (diff < window)
    else:
        kw["is_causal"] = causal
    return kw


def sdpa_ms(F, q, k, v, causal, window, ref_out):
    """Time of F.scaled_dot_product_attention on the same inputs (grouped
    kv heads through enable_gqa, the window as a boolean mask), a
    yardstick the port never calls; None where it does not run."""
    kw = sdpa_kw(q, k, causal, window)

    def call():
        return F.scaled_dot_product_attention(q, k, v, **kw)
    try:
        out = call()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        log("  library scaled_dot_product_attention: not available (%s)"
            % str(e).splitlines()[0])
        return None
    log("  library scaled_dot_product_attention vs flash_fwd_ref: "
        "max_abs_err %.3e (yardstick only)"
        % float((out.float() - ref_out.float()).abs().max()))
    return time_ms(call)


def phase_flash_fwd_kernel(flash, shapes=None, phase="flash_fwd_kernel"):
    """The flash attention kernel against flash_fwd_ref on the card at
    ``shapes`` (by default the LM's and the edge shapes: ragged L,
    non-causal, d 8-256, grouped kv heads with a window), fp32 and bf16;
    returns the per-kernel record of the first shape (the main path's: one
    launch, fp32). Every fp32 time lands in KERNEL_MS. The fp32 bound is
    reckoned at the 3xTF32 rate of the kernel's tensor-core products, the
    FMA-rate bound printed beside it; the default run first counts the
    tensor-core instructions of the flash forward's and the ring forward
    step's libraries (one kernel body) and fails without them."""
    import torch.nn.functional as F
    log("phase %s" % phase)
    if shapes is None:
        tensor_core_instructions(("flash_fwd", "ring_fwd_step"))
    shapes = shapes or FLASH_SHAPES
    rec = _new_rec()
    rng = np.random.RandomState(SEED + 4)
    for name, b, h, nkv, L, d, causal, window in shapes:
        host = [torch.from_numpy(rng.randn(b, n, L, d).astype(np.float32))
                for n in (h, nkv, nkv)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(DEV, dtype) for t in host)
            args = (causal, None, window)
            out, lse = flash.flash_fwd_cuda(q, k, v, *args)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash.flash_fwd_ref(q, k, v, *args)
            log(" %s b %d h %d nkv %d L %d d %d causal %d window %d %s"
                % (name, b, h, nkv, L, d, causal, window, str(dtype)[6:]))
            if out.dtype != dtype or lse.shape != (b, h, L):
                raise AssertionError("out %s lse %s" % (out.dtype,
                                                        tuple(lse.shape)))
            eps = torch.finfo(torch.float32).eps
            err = check_close("out vs flash_fwd_ref", out, ref_out,
                              RTOL[dtype], FLASH_ATOL_EPS * eps
                              * float(ref_out.float().abs().max()))
            check_close("lse vs flash_fwd_ref", lse, ref_lse, NORM_RTOL,
                        FLASH_ATOL_EPS * eps * float(ref_lse.abs().max()))
            del ref_out, ref_lse
            kernel_ms = time_ms(lambda: flash.flash_fwd_cuda(q, k, v, *args))
            plain_ms = time_ms(lambda: flash.flash_fwd_ref(q, k, v, *args),
                               iters=5)
            library_ms = sdpa_ms(F, q, k, v, causal, window, out)
            ops_n, nbytes = flash_work(b, h, nkv, L, d, causal, window,
                                       q.element_size())
            fp32 = dtype == torch.float32
            peak = FP32_3XTF32_OPS_PER_S if fp32 else BF16_OPS_PER_S
            ops_ms = ops_n / peak * 1e3
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
            # the fp32 FMA-rate bound the SIMT kernel was held to
            fma_ms = max(ops_n / FP32_OPS_PER_S * 1e3, bytes_ms)
            log("  kernel_ms %.4f plain_ms %.4f library_ms %s bound_ms %.4f "
                "(%s: %.3e operations at %.0f TFLOP/s, %d bytes) "
                "kernel/bound %.2f%s"
                % (kernel_ms, plain_ms, library_ms, bound_ms, bound_by,
                   ops_n, peak / 1e12, nbytes, kernel_ms / bound_ms,
                   "; fp32 FMA-rate bound %.4f ms (%.0f TFLOP/s), "
                   "kernel/that %.2f" % (fma_ms, FP32_OPS_PER_S / 1e12,
                                         kernel_ms / fma_ms) if fp32 else ""))
            if name == shapes[0][0] and dtype == torch.float32:
                _add_fp32(rec, kernel_ms, plain_ms, library_ms, bound_ms,
                          bound_by)
            if dtype == torch.float32:
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                KERNEL_MS[("flash_fwd", name)] = kernel_ms
            del q, k, v, out, lse
        torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def plain_flash(flash):
    """FlashAttention's forward runs flash_fwd_ref in place of the kernel
    (on the card, by explicit swap)."""
    kernel = flash.flash_fwd_cuda
    flash.flash_fwd_cuda = flash.flash_fwd_ref
    try:
        yield
    finally:
        flash.flash_fwd_cuda = kernel


def lm_cfg(models, seq, batch, attn_extra="", dev=None, args=None):
    """The bench.py LM's config (the port's transformer_lm_config) at
    (seq, batch), weights from SEED; ``args`` replaces its widths."""
    return models.transformer_lm_config(
        seq=seq, batch_size=batch, dev=dev or NET_DEV, attn_extra=attn_extra,
        **(args or LM_ARGS)) + "seed = %d\n" % SEED


def lm_net(api, models, seq, batch, attn_extra="", args=None):
    net = api.Net(dev=NET_DEV, cfg=lm_cfg(models, seq, batch, attn_extra,
                                          args=args))
    t0 = time.time()
    net.init_model()
    torch.cuda.synchronize()
    n = sum(v.numel() for p in net.net_.params for v in p.values())
    log("  init_model %.2f s, %d parameters (%.1f MB fp32)"
        % (time.time() - t0, n, n * 4 / 1e6))
    return net


def forced_logp(net, toks, plen, total):
    """Log-probabilities of the prefill and of every step of the decode
    loop teacher-forced on ``toks`` ((b, l_max) int64 on the card), as
    (b, vocab, total - 1) on the card."""
    b = toks.shape[0]
    out = torch.empty((b, LM_ARGS["vocab"], total - 1), device=toks.device)

    def record(t0, probs):
        n = min(probs.shape[2], total - 1 - t0)
        out[:, :, t0:t0 + n] = torch.log(probs[:, :, :n])
    net.net_.decode(toks.clone(), torch.full((b,), total, dtype=torch.int32,
                                             device=toks.device),
                    plen, total, on_probs=record)
    return out


def check_request(flash, net, prompts, lens, got):
    """Hold one generate request on the card against the same request with
    flash_fwd_ref swapped in: log-probabilities of the prefill and of every
    teacher-forced step (forced on the kernel run's tokens) to LOGP_TOL;
    each generated token equal to the plain run's greedy pick wherever its
    top-2 margin exceeds 2 LOGP_TOL; and the plain run's own generate equal
    to the kernel run's, row by row, up to the row's first step under that
    margin."""
    b, n_new = got.shape
    plen, total = int(lens.min()), int(lens.max()) + n_new
    l_max = net.net_.net_cfg.param.input_shape[2]
    toks = np.zeros((b, l_max), np.int64)
    toks[:, :prompts.shape[1]] = prompts
    for r in range(b):
        toks[r, lens[r]:lens[r] + n_new] = got[r]
    toks = torch.from_numpy(toks).to(DEV)
    kern = forced_logp(net, toks, plen, total)
    with plain_flash(flash):
        plain = forced_logp(net, toks, plen, total)
        plain_toks = net.generate(prompts, n_new, prompt_lens=lens)
    err = float((kern - plain).abs().max())
    log("  log-probabilities of the prefill and %d teacher-forced steps, "
        "kernel vs flash_fwd_ref: max_abs_err %.3e (tolerance %.0e) %s"
        % (total - 1 - plen, err, LOGP_TOL,
           "ok" if err <= LOGP_TOL else "FAILED"))
    if not err <= LOGP_TOL:
        raise AssertionError("LM log-probabilities disagree beyond %g"
                             % LOGP_TOL)
    top2 = plain.topk(2, dim=1)
    margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
    pick = top2.indices[:, 0].cpu().numpy()
    held = flips = 0
    for r in range(b):
        first_low = n_new
        for j in range(n_new):
            t = int(lens[r]) - 1 + j
            if margin[r, t] > 2 * LOGP_TOL:
                held += 1
                if pick[r, t] != got[r, j]:
                    flips += 1
            elif first_low == n_new:
                first_low = j
        if not np.array_equal(plain_toks[r, :first_low], got[r, :first_low]):
            raise AssertionError("row %d: the plain run's tokens differ "
                                 "before its first low-margin step %d"
                                 % (r, first_low))
    log("  tokens: %d of %d generated steps above the margin, %d differ "
        "from the plain run's greedy pick; the plain run's own tokens equal "
        "up to each row's first step under the margin (%d tokens equal in "
        "all)" % (held, b * n_new, flips, int((plain_toks == got).sum())))
    if flips:
        raise AssertionError("%d tokens differ where the margin allows no "
                             "flip" % flips)


def time_generate(net, prompts, lens, n_new, reps=3):
    """Host wall times (s) of ``reps`` generate calls, each ending in its
    one copy of the tokens to the host (which waits for the card)."""
    net.generate(prompts, n_new, prompt_lens=lens)
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        net.generate(prompts, n_new, prompt_lens=lens)
        times.append(time.perf_counter() - t)
    return times


def serve_rates(flash, net, prompts, lens, n_new, label):
    """Time to first token (a generate of one token: the prompt's copy to
    the card, the prefill, the pick and the copy back) and decode tokens/s
    (the further n_new - 1 tokens of a full request over the time it adds),
    with the kernel and with flash_fwd_ref, in turns kernel, plain, plain,
    kernel."""
    b = prompts.shape[0]
    res = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        ctx = plain_flash(flash) if which == "plain" \
            else contextlib.nullcontext()
        with ctx:
            ttft = min(time_generate(net, prompts, lens, 1))
            full = min(time_generate(net, prompts, lens, n_new))
        res[which].append((ttft, full, b * (n_new - 1) / (full - ttft)))
    for which, runs in res.items():
        log("  %s %s: time to first token %s ms; request of %d new tokens "
            "%s ms; decode %s tokens/s (best of 3 each, two turns)"
            % (label, which, " / ".join("%.2f" % (r[0] * 1e3) for r in runs),
               n_new, " / ".join("%.2f" % (r[1] * 1e3) for r in runs),
               " / ".join("%.1f" % r[2] for r in runs)))


def phase_lm_serve(flash, api, models):
    """The bench.py LM served through api.Net(dev="gpu"): greedy generate
    requests (uniform 1024-token prompts, a ragged batch of 1024-1100) and
    a full-sequence predict_device; returns the flash launches counted
    while the main path ran."""
    log("phase lm_serve")
    net = lm_net(api, models, LM_SEQ, LM_BATCH)
    vocab = LM_ARGS["vocab"]
    rng = np.random.RandomState(SEED + 5)
    prompts = rng.randint(0, vocab, (LM_BATCH, LM_PROMPT))
    ragged = rng.randint(0, vocab, (LM_BATCH, LM_RAGGED[1]))
    lens = rng.randint(LM_RAGGED[0], LM_RAGGED[1] + 1, LM_BATCH)
    lens[:2] = LM_RAGGED
    uniform = np.full(LM_BATCH, LM_PROMPT)
    full = torch.from_numpy(rng.randint(0, vocab, (LM_BATCH, 1, 1, LM_SEQ))
                            .astype(np.float32)).to(DEV)
    per_layer = LM_ARGS["nlayer"]

    # the main path: the counts start at 0 here and are read right after
    torch.cuda.reset_peak_memory_stats()
    flash.launches = 0
    got = net.generate(prompts, LM_NEW)
    n_uniform = flash.launches
    got_r = net.generate(ragged, LM_NEW, prompt_lens=lens)
    n_ragged = flash.launches - n_uniform
    pred = net.predict_device(full)
    torch.cuda.synchronize()
    n_full = flash.launches - n_uniform - n_ragged
    launches = flash.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    log("  flash_fwd launches: %d per uniform request, %d per ragged "
        "request, %d per full-sequence forward (%d expected each)"
        % (n_uniform, n_ragged, n_full, per_layer))
    if (n_uniform, n_ragged, n_full) != (per_layer,) * 3:
        raise AssertionError("expected %d flash_fwd launches per request "
                             "and per forward" % per_layer)
    for what, toks in (("uniform", got), ("ragged", got_r)):
        if toks.shape != (LM_BATCH, LM_NEW) or toks.min() < 0 \
                or toks.max() >= vocab:
            raise AssertionError("%s tokens: shape %s range [%d, %d]"
                                 % (what, toks.shape, toks.min(),
                                    toks.max()))
    if pred.shape != (LM_BATCH,) or not bool(torch.isfinite(pred).all()):
        raise AssertionError("predict_device: %s" % (tuple(pred.shape),))
    log("  peak device memory over the main path %.2f GB" % peak)

    log(" uniform request (prompts %d, %d new tokens)" % (LM_PROMPT, LM_NEW))
    check_request(flash, net, prompts, uniform, got)
    log(" ragged request (prompt_lens %s)" % lens.tolist())
    check_request(flash, net, ragged, lens, got_r)
    log(" full-sequence forward (L %d)" % LM_SEQ)
    last = net.net_.net_cfg.param.num_nodes - 1
    kern = torch.log(net.net_._forward_nodes(full, (last,))[0])
    with plain_flash(flash):
        plain = torch.log(net.net_._forward_nodes(full, (last,))[0])
    err = float((kern - plain).abs().max())
    log("  log-probabilities kernel vs flash_fwd_ref: max_abs_err %.3e "
        "(tolerance %.0e) %s" % (err, LOGP_TOL,
                                  "ok" if err <= LOGP_TOL else "FAILED"))
    if not err <= LOGP_TOL:
        raise AssertionError("full-sequence log-probabilities disagree")
    del kern, plain

    serve_rates(flash, net, prompts, uniform, LM_NEW, "uniform")
    serve_rates(flash, net, ragged, lens, LM_NEW, "ragged")

    def tokens_per_s(iters=5):
        net.predict_device(full)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            net.predict_device(full)
            torch.cuda.synchronize()
        return LM_BATCH * LM_SEQ * iters / (time.perf_counter() - t)
    rates = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        with plain_flash(flash) if which == "plain" \
                else contextlib.nullcontext():
            rates[which].append(tokens_per_s())
    log("  full-sequence forward, batch %d x %d: %s tokens/s with the "
        "kernel, %s with flash_fwd_ref (in turns)"
        % (LM_BATCH, LM_SEQ, " / ".join("%.0f" % r for r in rates["kernel"]),
           " / ".join("%.0f" % r for r in rates["plain"])))
    profile_forward(lambda: net.generate(prompts, LM_NEW), iters=2,
                    unit="request", shares=("flash_fwd",))
    profile_forward(lambda: net.predict_device(full), unit="forward",
                    shares=("flash_fwd",))
    del net
    torch.cuda.empty_cache()
    return launches


def phase_lm_serve_long(flash, api, models):
    """The long-context recipe (8192 positions, 2 kv heads, window 1024,
    RoPE) served through api.Net(dev="gpu").generate: batch 2, a
    4096-token prompt, 32 new tokens; returns the flash launches counted
    while the main path ran."""
    log("phase lm_serve_long")
    net = lm_net(api, models, LONG_SEQ, LONG_BATCH, LONG_EXTRA)
    rng = np.random.RandomState(SEED + 6)
    prompts = rng.randint(0, LM_ARGS["vocab"], (LONG_BATCH, LONG_PROMPT))
    lens = np.full(LONG_BATCH, LONG_PROMPT)

    # the main path: the counts start at 0 here and are read right after
    flash.launches = 0
    got = net.generate(prompts, LONG_NEW)
    torch.cuda.synchronize()
    launches = flash.launches
    log("  flash_fwd launches: %d per request (%d expected)"
        % (launches, LM_ARGS["nlayer"]))
    if launches != LM_ARGS["nlayer"]:
        raise AssertionError("expected %d flash_fwd launches per request"
                             % LM_ARGS["nlayer"])
    if got.shape != (LONG_BATCH, LONG_NEW):
        raise AssertionError("tokens: shape %s" % (got.shape,))
    check_request(flash, net, prompts, lens, got)
    serve_rates(flash, net, prompts, lens, LONG_NEW, "long")
    del net
    torch.cuda.empty_cache()
    return launches


def flash_bwd_work(b, h, nkv, L, d, causal, window, esize):
    """((dq operations, bytes), (dk/dv operations, bytes)) the backward
    kernels need, counted for this shape: per (query, key) pair the mask
    keeps, 6 d flops for dQ (S, dP, dS K) and 8 d for dK/dV (S, P^T dO, dP,
    dS^T Q); each input read once (q, k, v, dO in the input dtype, lse and
    D in f32), each output written once."""
    pairs = kept_pairs(L, causal, window) * b * h
    q_elems, kv_elems = b * h * L * d, b * nkv * L * d
    rows = 8 * b * h * L
    return ((6 * d * pairs, esize * (3 * q_elems + 2 * kv_elems) + rows),
            (8 * d * pairs, esize * (2 * q_elems + 4 * kv_elems) + rows))


def tensor_core_instructions(names):
    """HMMA (tensor-core) instructions in the built libraries ``names``,
    counted in cuobjdump's SASS; raises if any has none (its kernels would
    then run outside the tensor cores)."""
    from cxxnet_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    counts = {}
    for name in names:
        path = _build.build_kernels([name])[name]
        sass = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        counts[name] = sum(1 for ln in sass.splitlines() if "HMMA" in ln)
    log("  tensor-core instructions (HMMA lines in cuobjdump -sass): %s"
        % ", ".join("%s %d" % kv for kv in counts.items()))
    if not all(counts.values()):
        raise AssertionError("a tensor-core library has no HMMA "
                             "instruction")


def sdpa_bwd_ms(F, q, k, v, dout, causal, window, ref):
    """Time of the backward of F.scaled_dot_product_attention on the same
    inputs (autograd.grad of dq, dk, dv over a kept graph), a yardstick the
    port never calls; None where it does not run."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    try:
        out = F.scaled_dot_product_attention(*leaves,
                                             **sdpa_kw(q, k, causal, window))

        def call():
            return torch.autograd.grad(out, leaves, dout, retain_graph=True)
        grads = call()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        log("  library backward of scaled_dot_product_attention: not "
            "available (%s)" % str(e).splitlines()[0])
        return None
    log("  library backward of scaled_dot_product_attention vs "
        "flash_bwd_ref: max_abs_err dq %.3e dk %.3e dv %.3e (yardstick only)"
        % tuple(float((g.float() - r.float()).abs().max())
                for g, r in zip(grads, ref)))
    del grads
    return time_ms(call, iters=5, warmup=1)


def phase_flash_bwd_kernel(flash, shapes=None, phase="flash_bwd_kernel"):
    """The dQ and dK/dV kernels against flash_bwd_ref on the card at
    ``shapes`` (by default the LM training shapes and the edge shapes:
    ragged L, non-causal, one kv head, window 64, d 8-256), fp32 and bf16,
    on the forward kernel's out and lse; two runs held bitwise equal;
    returns the per-kernel records of the first shape (the main path's:
    one fp32 launch each). The plain and library times are those of the
    whole backward (dq, dk and dv in one call). Every fp32 time lands in
    KERNEL_MS. The fp32 bound is reckoned at the 3xTF32 rate of the
    kernels' tensor-core products, the FMA-rate bound printed beside it;
    the default run first counts the tensor-core instructions of these
    libraries and of the ring's dQ and dK/dV steps, which run the same
    bodies, and fails without them."""
    import torch.nn.functional as F
    log("phase %s" % phase)
    if shapes is None:
        tensor_core_instructions(("flash_bwd_dq", "flash_bwd_dkv",
                                  "ring_dq_step", "ring_dkv_step"))
    shapes = shapes or FLASH_BWD_SHAPES
    recs = {"dq": _new_rec(), "dkv": _new_rec()}
    rng = np.random.RandomState(SEED + 8)
    for name, b, h, nkv, L, d, causal, window in shapes:
        host = [torch.from_numpy(rng.randn(b, n, L, d).astype(np.float32))
                for n in (h, nkv, nkv, h)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (t.to(DEV, dtype) for t in host)
            args = (causal, None, window)
            out, lse = flash.flash_fwd_cuda(q, k, v, *args)
            delta = flash.bwd_delta(out, dout)
            dq = flash.flash_bwd_dq_cuda(q, k, v, dout, lse, delta, *args)
            dk, dv = flash.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                              *args)
            torch.cuda.synchronize()
            ref = flash.flash_bwd_ref(q, k, v, out, lse, dout, *args)
            log(" %s b %d h %d nkv %d L %d d %d causal %d window %d %s"
                % (name, b, h, nkv, L, d, causal, window, str(dtype)[6:]))
            err = 0.0
            for nm, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError("%s: %s %s" % (nm, got.dtype,
                                                        tuple(got.shape)))
                tol = FLASH_BWD_TOL[dtype] * float(want.float().abs().max())
                err = max(err, check_close("%s vs flash_bwd_ref" % nm, got,
                                           want, 0.0, tol))
            again = flash.flash_bwd_cuda(q, k, v, out, lse, dout, *args)
            if not all(torch.equal(a, g) for a, g in zip(again,
                                                         (dq, dk, dv))):
                raise AssertionError("two backward runs differ")
            log("  two backward runs: dq, dk, dv bitwise equal")
            del again
            dq_ms = time_ms(lambda: flash.flash_bwd_dq_cuda(
                q, k, v, dout, lse, delta, *args))
            dkv_ms = time_ms(lambda: flash.flash_bwd_dkv_cuda(
                q, k, v, dout, lse, delta, *args))
            delta_ms = time_ms(lambda: flash.bwd_delta(out, dout))
            plain_ms = time_ms(lambda: flash.flash_bwd_ref(
                q, k, v, out, lse, dout, *args), iters=3, warmup=1)
            library_ms = sdpa_bwd_ms(F, q, k, v, dout, causal, window, ref)
            fp32 = dtype == torch.float32
            peak = FP32_3XTF32_OPS_PER_S if fp32 else BF16_OPS_PER_S
            works = flash_bwd_work(b, h, nkv, L, d, causal, window,
                                   q.element_size())
            for key, ms, (ops_n, nbytes) in (("dq", dq_ms, works[0]),
                                             ("dkv", dkv_ms, works[1])):
                ops_ms = ops_n / peak * 1e3
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                bound_ms = max(ops_ms, bytes_ms)
                bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
                # the fp32 FMA-rate bound the SIMT kernels were held to
                fma_ms = max(ops_n / FP32_OPS_PER_S * 1e3, bytes_ms)
                log("  %s kernel_ms %.4f bound_ms %.4f (%s: %.3e operations "
                    "at %.0f TFLOP/s, %d bytes, %.4f ms) kernel/bound %.2f%s"
                    % (key, ms, bound_ms, bound_by, ops_n, peak / 1e12,
                       nbytes, bytes_ms, ms / bound_ms,
                       "; fp32 FMA-rate bound %.4f ms (%.0f TFLOP/s), "
                       "kernel/that %.2f" % (fma_ms, FP32_OPS_PER_S / 1e12,
                                             ms / fma_ms) if fp32 else ""))
                if name == shapes[0][0] and dtype == torch.float32:
                    _add_fp32(recs[key], ms, plain_ms, library_ms, bound_ms,
                              bound_by)
                if dtype == torch.float32:
                    recs[key]["max_abs_err"] = max(recs[key]["max_abs_err"],
                                                   err)
                    KERNEL_MS[("flash_bwd_" + key, name)] = ms
            log("  whole backward: kernels %.4f ms + D reduction %.4f ms; "
                "plain_ms %.4f library_ms %s"
                % (dq_ms + dkv_ms, delta_ms, plain_ms, library_ms))
            del q, k, v, dout, out, lse, delta, dq, dk, dv, ref
            torch.cuda.empty_cache()
    return recs


@contextlib.contextmanager
def plain_flash_backward(flash):
    """FlashAttention's backward runs flash_bwd_ref in place of the two
    kernels (on the card, by explicit swap; the forward kernel still runs
    and saves out and lse)."""
    kernel = flash.flash_bwd_cuda
    flash.flash_bwd_cuda = flash.flash_bwd_ref
    try:
        yield
    finally:
        flash.flash_bwd_cuda = kernel


def lm_batch(x, y, dev):
    from cxxnet_tpu_torch.io import DataBatch
    batch = DataBatch()
    batch.data = torch.from_numpy(x).to(dev)
    batch.label = torch.from_numpy(y).to(dev)
    batch.batch_size = x.shape[0]
    return batch


def lm_loss(net, x, y) -> float:
    """Mean per-position cross-entropy of the net's softmax output on
    (x, y), computed on the card."""
    last = net.net_.net_cfg.param.num_nodes - 1
    probs = net.net_._forward_nodes(x, (last,))[0][:, :, 0, :]
    lab = torch.from_numpy(y).to(probs.device).long()
    return float(-torch.log(probs.gather(1, lab[:, None, :])).double().mean())


def compare_grads(what, got, want, tol):
    """Hold every gradient tensor to tol of its largest magnitude in want;
    print the worst ratio of error to bound."""
    worst, where = 0.0, ""
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            bound = tol * float(w[k].abs().max())
            err = float((g[k].to(w[k].device) - w[k]).abs().max())
            ratio = err / bound if bound > 0 else (0.0 if err == 0 else
                                                   float("inf"))
            if ratio > worst:
                worst, where = ratio, "layer %d %s (%.3e of its max)" % (
                    i, k, err / max(bound / tol, 1e-30))
    ok = worst <= 1.0
    log("  %s: worst error/bound %.3e at %s (tolerance %.0e of each "
        "tensor's largest) %s" % (what, worst, where or "-", tol,
                                  "ok" if ok else "FAILED"))
    if not ok:
        raise AssertionError("%s disagree beyond tolerance" % what)


def take_card_relu_masks(net, cpu, x):
    """Give the ReLU layers of the CPU net (or of any second net) the
    card's masks (the card's own pre-activations > 0). A pre-activation
    within rounding of 0 can fall on the other side of 0 in the two runs,
    and that flips its element's
    gradient wholesale, far beyond any summation-order tolerance; with the
    card's masks the two sides differ by rounding alone. Returns (flips,
    pre-activations, largest |pre-activation| at a flip over the node's
    largest)."""
    t, c = net.net_, cpu.net_
    relus = [i for i, lay in enumerate(c.net.layers)
             if lay.type_name == "relu"]
    nodes = tuple(c.net_cfg.layers[i].nindex_in[0] for i in relus)
    flips = total = 0
    worst = 0.0
    for i, a, b in zip(relus, t._forward_nodes(x, nodes),
                       c._forward_nodes(x, nodes)):
        keep = a > 0
        diff = keep != (b.to(DEV) > 0)
        flips += int(diff.sum())
        total += diff.numel()
        if bool(diff.any()):
            worst = max(worst, float(a[diff].abs().max() / a.abs().max()))
        mask = keep.to(device=b.device, dtype=torch.float32)
        c.net.layers[i].forward = \
            lambda params, inputs, ctx, m=mask: [inputs[0] * m]
    if worst > MASK_FLIP_MAG or flips > MASK_FLIP_SHARE * total:
        raise AssertionError(
            "%d of %d ReLU pre-activations flip, the largest %.3e of its "
            "node's largest: more than rounding (bars %.0e of the node's "
            "largest, %.0e of all)" % (flips, total, worst, MASK_FLIP_MAG,
                                       MASK_FLIP_SHARE))
    return flips, total, worst


def lm_card_vs_cpu(api, models, seq, batch, extra):
    """One step of the LM at every width but a reduced (seq, batch) on the
    card and through the port's CPU path, from one model file, with the
    card's ReLU masks on both sides: loss, gradients, and parameters after
    the Adam step."""
    net = lm_net(api, models, seq, batch, extra)
    fname = scratch_file("chip_smoke_lm.model")
    net.save_model(fname)
    cpu = api.Net(dev="cpu", cfg=lm_cfg(models, seq, batch, extra, "cpu"))
    cpu.load_model(fname)
    os.remove(fname)
    rng = np.random.RandomState(SEED + 9)
    x = rng.randint(0, LM_ARGS["vocab"], (batch, 1, 1, seq)).astype(
        np.float32)
    y = rng.randint(0, LM_ARGS["vocab"], (batch, seq)).astype(np.float32)
    flips, total, worst = take_card_relu_masks(net, cpu, x)
    log("  ReLU masks: %d of %d FFN pre-activations fall on the other side "
        "of 0 on the card and on the CPU (the largest of them %.3e of its "
        "node's largest magnitude); the CPU run takes the card's masks"
        % (flips, total, worst))
    t = time.time()
    loss_c, grads_c = cpu.net_.loss_and_grads(lm_batch(x, y, "cpu"))
    cpu_s = time.time() - t
    loss_g, grads_g = net.net_.loss_and_grads(lm_batch(x, y, DEV))
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    log("  card vs CPU path (seq %d, batch %d, every width kept; CPU step "
        "%.1f s): loss %.7f vs %.7f, relative %.3e (tolerance %.0e) %s"
        % (seq, batch, cpu_s, float(loss_g), float(loss_c), rel,
           LM_LOSS_RTOL, "ok" if rel <= LM_LOSS_RTOL else "FAILED"))
    if rel > LM_LOSS_RTOL:
        raise AssertionError("LM loss: card vs CPU")
    compare_grads("gradients card vs CPU path", grads_g, grads_c,
                  LM_GRAD_TOL)
    net.update(x, y)
    cpu.update(x, y)
    worst = ratio = 0.0
    for pg, pc, gg, gc in zip(_params(net), cpu.net_.params, grads_g,
                              grads_c):
        for k in pg:
            err = (pg[k] - pc[k].detach().to(DEV)).abs()
            bound = LM_ETA * ((gg[k] - gc[k].to(DEV)).abs() / ADAM_C + 1e-6) \
                + 2.0 ** -22 * pg[k].abs()
            worst = max(worst, float(err.max()))
            ratio = max(ratio, float((err / bound).max()))
    ok = ratio <= 1.0
    log("  parameters after one Adam step, card vs CPU path: max_abs_err "
        "%.3e = %.3e of eta; worst error / bound %.3e (bound per element: "
        "eta |g_card - g_cpu| / %.3e + 1e-6 eta + 2 ulps) %s"
        % (worst, worst / LM_ETA, ratio, ADAM_C, "ok" if ok else "FAILED"))
    if not ok:
        raise AssertionError("LM parameters after a step: card vs CPU")
    del grads_c, grads_g
    del net, cpu
    torch.cuda.empty_cache()


def conv_wgrad_ms(ops, step, vocab):
    """The conv weight gradients of one training step (ops.conv2d_weight on
    the step's own inputs, recorded in the step and timed alone):
    (1x1-conv FFN ms, vocab head ms, calls)."""
    calls = []
    real = ops.conv2d_weight

    def record(x, w_shape, g, *args):
        calls.append((x.detach(), tuple(w_shape), g.detach(), args))
        return real(x, w_shape, g, *args)
    ops.conv2d_weight = record
    try:
        step()
    finally:
        ops.conv2d_weight = real
    ffn = head = 0.0
    for x, w_shape, g, args in calls:
        ms = time_ms(lambda: real(x, w_shape, g, *args), iters=5, warmup=1)
        if w_shape[0] == vocab:
            head += ms
        else:
            ffn += ms
    return ffn, head, len(calls)


def phase_lm_train(flash, api, models, ops, phase, seq, batch, extra,
                   cpu_seq, cpu_batch):
    """An LM trained through api.Net(dev="gpu").update on one repeated
    batch of random ids: 4 launches of each flash kernel per step, the
    loss falling, the step's gradients against the plain-backward run and
    the card against the CPU path, tokens/s and a step profile; returns
    the (forward, dQ, dK/dV) launches counted while the main path ran."""
    log("phase %s (L %d, batch %d%s)" % (phase, seq, batch,
                                          ", " + extra.replace("\n", ", ")
                                          .strip(", ") if extra else ""))
    net = lm_net(api, models, seq, batch, extra)
    vocab, nlayer = LM_ARGS["vocab"], LM_ARGS["nlayer"]
    rng = np.random.RandomState(SEED + 7)
    x = rng.randint(0, vocab, (batch, 1, 1, seq)).astype(np.float32)
    y = rng.randint(0, vocab, (batch, seq)).astype(np.float32)
    loss0 = lm_loss(net, x, y)
    fname = scratch_file("chip_smoke_lm_train.model")
    net.save_model(fname)

    # the main path: the counts start at 0 here and are read right after
    torch.cuda.reset_peak_memory_stats()
    flash.launches = flash.dq_launches = flash.dkv_launches = 0
    t = time.perf_counter()
    for step in range(LM_TRAIN_STEPS):
        net.update(x, y)
        counts = (flash.launches, flash.dq_launches, flash.dkv_launches)
        if counts != (nlayer * (step + 1),) * 3:
            raise AssertionError(
                "expected %d launches of each flash kernel per update, "
                "counted %s after %d updates" % (nlayer, counts, step + 1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    log("  %d update steps in %.2f s (first steps included); flash_fwd, "
        "flash_bwd_dq, flash_bwd_dkv launches %s: %d + %d + %d in every "
        "update; peak memory %.2f GB"
        % (LM_TRAIN_STEPS, wall, counts, nlayer, nlayer, nlayer,
           torch.cuda.max_memory_allocated() / 1e9))
    loss1 = lm_loss(net, x, y)
    log("  fixed-batch cross-entropy %.6f before, %.6f after %d steps at "
        "the config's eta %g (reported; see LM_LOSS_ETA)"
        % (loss0, loss1, LM_TRAIN_STEPS, LM_ETA))
    slow = api.Net(dev=NET_DEV, cfg=lm_cfg(models, seq, batch, extra) +
                   "eta = %g\n" % LM_LOSS_ETA)
    slow.load_model(fname)
    os.remove(fname)
    losses = [loss0]
    for _ in range(LM_TRAIN_STEPS):
        slow.update(x, y)
        losses.append(lm_loss(slow, x, y))
    log("  the same start at eta %g: fixed-batch cross-entropy %s"
        % (LM_LOSS_ETA, " ".join("%.4f" % v for v in losses)))
    if not (np.isfinite(losses[-1]) and losses[-1] < loss0):
        raise AssertionError("LM training loss did not fall: %r -> %r"
                             % (loss0, losses[-1]))
    del slow
    for i, p in enumerate(_params(net)):
        for k, v in p.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError("layer %d %s not finite" % (i, k))

    # one step's gradients: kernels, kernels again, flash_bwd_ref swapped in
    batch_dev = lm_batch(x, y, DEV)
    batch_dev.data = batch_dev.data.long()
    _, with_kernel = net.net_.loss_and_grads(batch_dev)
    _, again = net.net_.loss_and_grads(batch_dev)
    spread = max(float((a[k] - b[k]).abs().max() / b[k].abs().max())
                 for a, b in zip(again, with_kernel) for k in a)
    log("  spread of two identical kernel steps' gradients: %.3e of the "
        "tensor's largest" % spread)
    del again
    with plain_flash_backward(flash):
        _, with_plain = net.net_.loss_and_grads(batch_dev)
    compare_grads("gradients kernels vs flash_bwd_ref swapped in",
                  with_kernel, with_plain, LM_GRAD_TOL)
    del with_kernel, with_plain
    torch.cuda.empty_cache()

    # tokens/s (batch * L per step): through Net.update on numpy, then with
    # the batch already on the card, kernels and plain backward in turns
    def tokens_per_s(step, iters=5):
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            step()
            torch.cuda.synchronize()
        return batch * seq * iters / (time.perf_counter() - t)

    def device_step():
        net.net_.update(batch_dev)
    log("  training through Net.update (numpy): %.0f tokens/s"
        % tokens_per_s(lambda: net.update(x, y)))
    rates = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        with plain_flash_backward(flash) if which == "plain" \
                else contextlib.nullcontext():
            rates[which].append(tokens_per_s(device_step))
    log("  training, batch on the card: %s tokens/s with the backward "
        "kernels, %s with flash_bwd_ref (in turns kernel, plain, plain, "
        "kernel)" % (" / ".join("%.0f" % r for r in rates["kernel"]),
                     " / ".join("%.0f" % r for r in rates["plain"])))
    busy_ms = profile_forward(device_step, unit="step",
                              shares=("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv"))
    ffn_ms, head_ms, n_calls = conv_wgrad_ms(ops, device_step, vocab)
    log("  conv weight gradients (ops.conv2d_weight, %d calls, timed alone "
        "on the step's inputs): 1x1-conv FFN %.3f ms, vocab head %.3f ms "
        "per step%s" % (n_calls, ffn_ms, head_ms, "" if not busy_ms else
                        ", %.1f%% and %.1f%% of the step's device time"
                        % (100 * ffn_ms / busy_ms, 100 * head_ms / busy_ms)))
    del net, batch_dev
    torch.cuda.empty_cache()
    lm_card_vs_cpu(api, models, cpu_seq, cpu_batch, extra)
    return counts


def phase_uniform_kernel(rnd):
    """The uniform kernel against uniform_ref on the card, bitwise, at the
    main path's largest draw and at edge sizes (n 1, 3, 5, 4 k + 3, a seed
    above 2^32); on conv1's draw the range, the 24-bit ladder, the mean and
    variance, the Kolmogorov-Smirnov distance at 10^7 draws, two seeds and
    the seeds of two layers of one training step apart; times against the
    bound, the plain version and torch.rand. Returns the per-kernel record
    of conv1's draw."""
    from cxxnet_tpu_torch.layer.base import fold_in
    log("phase uniform_kernel")
    rec = _new_rec()
    for name, seed, shape in UNIFORM_SHAPES:
        got = rnd.uniform_cuda(seed, shape, DEV)
        torch.cuda.synchronize()
        same = torch.equal(got, rnd.uniform_ref(seed, shape, DEV))
        log(" %s seed %d shape %s: kernel vs uniform_ref bitwise %s"
            % (name, seed, shape, "equal" if same else "DIFFERENT"))
        if not same:
            raise AssertionError("uniform kernel differs from uniform_ref")
        if name == UNIFORM_SHAPES[0][0]:
            _uniform_stats(rnd, fold_in, got, seed, shape)
            rec.update(_uniform_times(rnd, seed, shape))
        del got
    torch.cuda.empty_cache()
    return rec


def _uniform_stats(rnd, fold_in, u, seed, shape):
    n = u.numel()
    lo, hi = float(u.min()), float(u.max())
    scaled = u.double() * 2 ** 24
    ladder = bool(torch.equal(scaled, scaled.round()))
    del scaled
    mean, var = float(u.double().mean()), float(u.double().var())
    se_mean = (1 / 12 / n) ** 0.5
    se_var = ((1 / 80 - 1 / 144) / n) ** 0.5
    m = min(n, KS_DRAWS)
    s = torch.sort(u.reshape(-1)[:m].double())[0]
    i = torch.arange(1, m + 1, dtype=torch.float64, device=s.device)
    ks = float(torch.maximum(i / m - s, s - (i - 1) / m).max())
    del s, i
    ok = (0.0 <= lo and hi < 1.0 and ladder
          and abs(mean - 0.5) <= MOMENT_SIGMAS * se_mean
          and abs(var - 1 / 12) <= MOMENT_SIGMAS * se_var and ks < KS_BAR)
    log("  range [%.9f, %.9f], on the 2^-24 ladder: %s; mean %.9f (1/2 "
        "within %.0f se = %.2e), variance %.9f (1/12 within %.0f se = "
        "%.2e); KS distance at %d draws %.3e (bar %.0e) %s"
        % (lo, hi, ladder, mean, MOMENT_SIGMAS, MOMENT_SIGMAS * se_mean, var,
           MOMENT_SIGMAS, MOMENT_SIGMAS * se_var, m, ks, KS_BAR,
           "ok" if ok else "FAILED"))
    if not ok:
        raise AssertionError("uniform draw fails its statistics")
    # two seeds, and the seeds of layers 1 and 2 (conv1's insanity and the
    # insanity pooling after it) in the first update of a net of seed SEED:
    # the trainer folds the step into the seed, the net the connection
    step = fold_in(SEED, 1)
    for what, sa, sb in (("seed %d vs seed %d" % (seed, seed + 1), seed,
                          seed + 1),
                         ("layers 1 and 2 of one step", fold_in(step, 1),
                          fold_in(step, 2))):
        a = rnd.uniform_cuda(sa, shape, DEV)
        b = rnd.uniform_cuda(sb, shape, DEV)
        equal = float((a == b).double().mean())
        corr = float(torch.corrcoef(torch.stack([a.reshape(-1)[:m],
                                                 b.reshape(-1)[:m]])
                                    .double())[0, 1])
        ok = equal < 1e-5 and abs(corr) < MOMENT_SIGMAS / m ** 0.5
        log("  %s: share of equal elements %.3e (bar 1e-5), correlation "
            "over %d draws %.3e (bar %.1e) %s"
            % (what, equal, m, corr, MOMENT_SIGMAS / m ** 0.5,
               "ok" if ok else "FAILED"))
        if not ok:
            raise AssertionError("two uniform streams are not apart")
        del a, b


def _uniform_times(rnd, seed, shape):
    n = int(np.prod(shape))
    kernel_ms = time_ms(lambda: rnd.uniform_cuda(seed, shape, DEV))
    plain_ms = time_ms(lambda: rnd.uniform_ref(seed, shape, DEV), iters=3,
                       warmup=1)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    library_ms = time_ms(lambda: torch.rand(shape, generator=gen,
                                            device=DEV))
    bound_ms, bound_by, bytes_ms, ops_ms = _bound(n, 4 * n,
                                                  UNIFORM_OPS_PER_ELEM)
    log("  kernel_ms %.4f plain_ms %.4f library_ms %.4f (torch.rand on a "
        "CUDA generator) bound_ms %.4f (%s: %d bytes written, %.4f ms; "
        "%d operations at %.0f TOP/s, %.4f ms) kernel/bound %.2f"
        % (kernel_ms, plain_ms, library_ms, bound_ms, bound_by, 4 * n,
           bytes_ms, n * UNIFORM_OPS_PER_ELEM, FP32_OPS_PER_S / 1e12, ops_ms,
           kernel_ms / bound_ms))
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _insanity_layers(net):
    return [lay for lay in net.net_.net.layers if lay.type_name == "insanity"]


@contextlib.contextmanager
def recorded_signs(net):
    """Record the sign mask (input > 0) that each insanity layer of
    ``net`` applies in the forwards run inside the block."""
    signs = {}
    for lay in _insanity_layers(net):
        def forward(params, inputs, ctx, lay=lay, real=lay.forward):
            signs[id(lay)] = inputs[0] > 0
            return real(params, inputs, ctx)
        lay.forward = forward
    try:
        yield signs
    finally:
        for lay in _insanity_layers(net):
            del lay.forward


def take_card_signs(card, cpu, signs):
    """Give the insanity layers of the CPU net the card's sign masks
    (recorded in the card's step): the same slopes (the same draw), but
    the card's choice of which elements are negative. A pre-activation
    within rounding of 0 can fall on the other side of 0 on the two
    devices, which changes its gradient by the factor 1 - 1/slope, far
    beyond any summation-order tolerance; with the card's signs the two
    sides differ by rounding alone. Returns a list that the CPU step fills
    with (flips, elements) per layer."""
    from cxxnet_tpu_torch.layer import layers as L
    seen = []
    for lay_card, lay in zip(_insanity_layers(card), _insanity_layers(cpu)):
        keep = signs[id(lay_card)].cpu()

        def forward(params, inputs, ctx, lay=lay, keep=keep):
            x = inputs[0]
            seen.append((int((keep != (x > 0)).sum()), x.numel()))
            lb, ub = lay._bounds(ctx.epoch)
            slope = L.draw_uniform(ctx, x.shape, x.device) * (ub - lb) + lb
            return [torch.where(keep, x, x / slope)]
        lay.forward = forward
    return seen


def rrelu_card_vs_cpu(api, fname, cfg, x, y):
    """(params before, after one update on the card, after the same
    update on the CPU path with the card's insanity signs, moved to the
    card); prints the sign flips the CPU run took over."""
    card = api.Net(dev=NET_DEV, cfg=cfg)
    card.load_model(fname)
    before = _params(card)
    with recorded_signs(card) as signs:
        card.update(x, y)
    cpu = api.Net(dev="cpu", cfg=cfg)
    cpu.load_model(fname)
    seen = take_card_signs(card, cpu, signs)
    cpu.update(x, y)
    log("  insanity inputs: %d of %d elements fall on the other side of 0 "
        "on the card and on the CPU (per layer %s); the CPU step takes the "
        "card's signs" % (sum(f for f, _ in seen), sum(n for _, n in seen),
                          [f for f, _ in seen]))
    return before, _params(card), [{k: v.detach().to(DEV)
                                     for k, v in p.items()}
                                    for p in cpu.net_.params]


def noise_layers_ms(rnd, net):
    """Device ms per training step of the RReLU layers' work, timed alone
    on their own shapes with CUDA events: the 10 draws; the 7 insanity
    layers' forward (draw, affine, xelu) and backward, beside relu's on the
    same inputs; the 3 insanity pooling layers' forward (draw, bands,
    index, gather, max pool) and backward, beside a plain max pool's."""
    from cxxnet_tpu_torch.layer.base import ApplyContext
    t = net.net_

    def inputs(kind):
        out = []
        for i, lay in enumerate(t.net.layers):
            if lay.type_name == kind:
                info = t.net_cfg.layers[i]
                x = torch.randn(t.net.node_shapes[info.nindex_in[0]],
                                device=DEV).requires_grad_()
                g = torch.randn(t.net.node_shapes[info.nindex_out[0]],
                                device=DEV)
                out.append((lay, x, g))
        return out
    ins, pools = inputs("insanity"), inputs("insanity_max_pooling")
    train = ApplyContext(train=True,
                         gen=torch.Generator(device=DEV).manual_seed(SEED))

    def draws():
        for _, x, _ in ins + pools:
            rnd.uniform_cuda(SEED, x.shape, DEV)

    def fwd_bwd(layers, fn):
        def run():
            for lay, x, g in layers:
                torch.autograd.grad(fn(lay, x), x, g)
        return time_ms(run, iters=10)
    return {
        "draws": time_ms(draws, iters=10),
        "insanity": fwd_bwd(ins, lambda lay, x: lay.forward({}, [x],
                                                            train)[0]),
        "relu": fwd_bwd(ins, lambda lay, x: torch.relu(x)),
        "insanity_pool": fwd_bwd(pools, lambda lay, x: lay.forward(
            {}, [x], train)[0]),
        "max_pool": fwd_bwd(pools, lambda lay, x: lay.forward(
            {}, [x], ApplyContext())[0])}


def phase_rrelu_alexnet_train(rnd, lrn, api, ops, models):
    """The RReLU AlexNet trained through the port's API on the card: 10
    uniform draws (7 insanity, 3 pooling) and 2 + 2 LRN launches per update,
    the loss falling, one step card vs CPU with the noise on, images/s
    against AlexNet's in turns, step profiles; returns the (uniform, LRN
    forward, LRN backward) launches counted while the main path ran."""
    log("phase rrelu_alexnet_train")
    cfg = models.rrelu_config(imagenet_cfg(), **RRELU)
    net = api.Net(dev=NET_DEV, cfg=cfg)
    net.init_model()
    types = [lay.type_name for lay in net.net_.net.layers]
    found = {k: types.count(k) for k in RRELU_LAYERS}
    log("  layers: %s, relu %d, max_pooling %d"
        % (found, types.count("relu"), types.count("max_pooling")))
    if found != RRELU_LAYERS or "relu" in types or "max_pooling" in types:
        raise AssertionError("not the RReLU AlexNet")
    per_step = sum(RRELU_LAYERS.values())
    rng = np.random.RandomState(SEED + 10)
    x = rng.randn(BATCH, 3, 227, 227).astype(np.float32)
    y = rng.randint(0, 1000, size=BATCH).astype(np.float32)
    fname = scratch_file("chip_smoke_rrelu.model")
    net.save_model(fname)
    start = _params(net)
    loss0 = cross_entropy(net.extract(x, "top[-1]"), y)

    # the main path: the counts start at 0 here and are read right after
    rnd.launches = lrn.launches = lrn.bwd_launches = 0
    t = time.perf_counter()
    for step in range(TRAIN_STEPS):
        net.update(x, y)
        counts = (rnd.launches, lrn.launches, lrn.bwd_launches)
        if counts != (per_step * (step + 1), 2 * step + 2, 2 * step + 2):
            raise AssertionError(
                "expected %d uniform draws and 2 + 2 LRN launches per "
                "update, counted %s after %d updates"
                % (per_step, counts, step + 1))
    torch.cuda.synchronize()
    log("  %d update steps in %.2f s (first steps included); uniform, "
        "lrn_fwd, lrn_bwd launches %s: %d + 2 + 2 in every update"
        % (TRAIN_STEPS, time.perf_counter() - t, counts, per_step))
    loss1 = cross_entropy(net.extract(x, "top[-1]"), y)
    log("  fixed-batch cross-entropy %.6f before, %.6f after %d steps at "
        "the config's learning rates" % (loss0, loss1, TRAIN_STEPS))
    if not (np.isfinite(loss1) and loss1 < loss0):
        raise AssertionError("RReLU training loss did not fall: %r -> %r"
                             % (loss0, loss1))
    for i, (p0, p1) in enumerate(zip(start, _params(net))):
        for k in p0:
            if not bool(torch.isfinite(p1[k]).all()) \
                    or torch.equal(p0[k], p1[k]):
                raise AssertionError("layer %d %s not finite or unchanged"
                                     % (i, k))
    log("  every parameter changed and is finite")

    # the card against the port's CPU path, noise on (both draw the same
    # bits), dropout off: one step on 4 images, cuDNN off and on, the CPU
    # run taking the card's insanity signs (take_card_signs)
    cfg0 = cfg.replace("threshold = 0.5", "threshold = 0")
    for what, ctx in (("cuDNN off", cudnn_off()),
                      ("cuDNN on", contextlib.nullcontext())):
        with ctx:
            before = rnd.launches
            p0, on_card, on_cpu = rrelu_card_vs_cpu(api, fname, cfg0, x[:4],
                                                    y[:4])
            if rnd.launches != before + per_step:
                raise AssertionError("the card step launched %d draws, the "
                                     "CPU step must launch none"
                                     % (rnd.launches - before))
        compare_params("one step (4 images, noise on, no dropout, %s), card "
                       "vs CPU path" % what, on_card, on_cpu, p0,
                       CPU_STEP_RTOL, CPU_STEP_ATOL_UPDATE)
        del on_card, on_cpu, p0
    os.remove(fname)

    # images/s: through Net.update on numpy, then with the batch on the
    # card, the RReLU AlexNet and AlexNet (relu, max pooling) in turns
    relu = api.Net(dev=NET_DEV, cfg=imagenet_cfg())
    relu.init_model()
    from cxxnet_tpu_torch.io import DataBatch
    batch = DataBatch()
    batch.data = torch.from_numpy(x).to(DEV)
    batch.label = torch.from_numpy(y.reshape(-1, 1)).to(DEV)
    batch.batch_size = BATCH

    def images_per_s(step):
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(RRELU_RATE_STEPS):
            step()
            torch.cuda.synchronize()
        return BATCH * RRELU_RATE_STEPS / (time.perf_counter() - t)
    steps = {"rrelu": lambda: net.net_.update(batch),
             "relu": lambda: relu.net_.update(batch)}
    log("  RReLU AlexNet fp32 training batch %d through Net.update (numpy): "
        "%.1f images/s" % (BATCH, images_per_s(lambda: net.update(x, y))))
    rates = {"rrelu": [], "relu": []}
    for which in ("rrelu", "relu", "relu", "rrelu"):
        rates[which].append(images_per_s(steps[which]))
    log("  fp32 training batch %d, batch on the card: %s images/s RReLU "
        "AlexNet, %s AlexNet (in turns RReLU, AlexNet, AlexNet, RReLU); "
        "RReLU / AlexNet %.4f"
        % (BATCH, " / ".join("%.1f" % r for r in rates["rrelu"]),
           " / ".join("%.1f" % r for r in rates["relu"]),
           sum(rates["rrelu"]) / sum(rates["relu"])))
    busy = profile_forward(steps["rrelu"], unit="step",
                           shares=("uniform_kernel", "lrn_fwd", "lrn_bwd"))
    busy_relu = profile_forward(steps["relu"], unit="step",
                                shares=("lrn_fwd", "lrn_bwd"))
    ms = noise_layers_ms(rnd, net)
    extra = ms["insanity"] - ms["relu"] + ms["insanity_pool"] \
        - ms["max_pool"]
    log("  timed alone on their shapes, per step: the 10 draws %.3f ms; the "
        "7 insanity layers forward + backward %.3f ms (relu there %.3f); "
        "the 3 insanity pooling layers %.3f ms (max pooling there %.3f); "
        "together %.3f ms over AlexNet's layers"
        % (ms["draws"], ms["insanity"], ms["relu"], ms["insanity_pool"],
           ms["max_pool"], extra))
    if busy and busy_relu:
        log("  RReLU step %.3f ms vs AlexNet step %.3f ms of device time "
            "(+%.3f ms); of the RReLU step: draws %.1f%%, insanity layers "
            "%.1f%%, insanity pooling layers %.1f%%"
            % (busy, busy_relu, busy - busy_relu, 100 * ms["draws"] / busy,
               100 * ms["insanity"] / busy, 100 * ms["insanity_pool"] / busy))
    del net, relu, batch
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- the CLI
# the synthetic ImageNet pack of cli_imagenet_train / cli_imagenet_pred:
# 256x256 PPM records, labels i % 1000, made from SEED with numpy
CLI_TRAIN_IMAGES, CLI_TEST_IMAGES, CLI_HW = 1024, 256, 256
CLI_ROUNDS = 2
# rounds of each io-only (test_io) run of the ImageNet pack
IO_ROUNDS = 5
# MNIST_CONV.conf on tests/synth_mnist.make_dataset data: every round of
# the file (15) must end at test error 0, the bar .claude/skills/verify
# states for the JAX package on this data
MNIST_TRAIN, MNIST_TEST = 600, 200
# kaggle_bowl/pred.conf's test pack: 48x48 records, 121 classes; 200
# images at batch 64 leave a last batch of 8 rows and 56 padding rows
BOWL_IMAGES, BOWL_HW, BOWL_CLASSES = 200, 48, 121
# the CLI's pred_raw / extract files print "%g" (6 significant digits)
CLI_PRED_RTOL = 1e-5
# the node cli_imagenet_pred extracts: fc6's output, behind both LRNs
CLI_EXTRACT_NODE = "17"
ROUND_RE = re.compile(r"round (\d+): input-wait ([\d.]+)% \(io ([\d.]+|inf) "
                      r"img/s when blocked, step ([\d.]+|inf) img/s\)")
IO_RE = re.compile(r"round (\d+): io-only ([\d.]+) images/sec")


@contextlib.contextmanager
def in_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@contextlib.contextmanager
def scratch_dir(name):
    """A fresh directory under build/cxxnet_tpu_torch/, removed after."""
    import shutil
    d = scratch_file(name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def run_cli(learn_task, cwd, argv, echo=("[", "round ", "update round")):
    """Run the port's command line (learn_task.main, as bin/cxxnet_torch
    does) in ``cwd``; echoes its lines that start with one of ``echo``
    and returns (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with in_dir(cwd), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = learn_task.main(argv)
    log("  bin/cxxnet_torch %s" % " ".join(
        os.path.relpath(a, REPO) if a.startswith(REPO) else a for a in argv))
    for ln in (out.getvalue() + err.getvalue()).splitlines():
        if ln.startswith(echo):
            log("    | " + ln.replace("\t", " "))
    if rc != 0:
        raise AssertionError("the CLI returned %d" % rc)
    return out.getvalue(), err.getvalue()


def round_rates(out):
    """[(input-wait %, io img/s, step img/s)] of the CLI's round lines."""
    return [tuple(float(v) for v in m.groups()[1:])
            for m in ROUND_RE.finditer(out)]


def write_image_pack(lst, binp, n, hw, n_class, seed):
    from cxxnet_tpu_torch.io import synth
    synth.write_pack(((lab, synth.ppm_bytes(img)) for lab, img in
                      synth.images(n, hw, n_class, seed)), lst, binp)


def phase_cli_mnist_conv(learn_task):
    """example/MNIST/MNIST_CONV.conf through the CLI on the card, all 15
    rounds at its own widths and batch 100, on synthetic MNIST."""
    log("phase cli_mnist_conv")
    t0 = time.perf_counter()
    from tests.synth_mnist import make_dataset
    with scratch_dir("cli_mnist") as d:
        make_dataset(os.path.join(d, "data"), n_train=MNIST_TRAIN,
                     n_test=MNIST_TEST, seed=SEED)
        t = time.perf_counter()
        _, err = run_cli(learn_task, d, [os.path.join(
            REPO, "example/MNIST/MNIST_CONV.conf"), "dev=" + NET_DEV])
        lines = [ln for ln in err.splitlines() if ln.startswith("[")]
        log("  15 rounds in %.2f s" % (time.perf_counter() - t))
        m = re.search(r"test-error:([\d.e+-]+)", lines[-1]) if lines else None
        if len(lines) != 15 or m is None or float(m.group(1)) != 0.0:
            raise AssertionError("MNIST_CONV.conf did not end at test "
                                 "error 0 after 15 rounds: %r" % lines[-1:])
        log("  final test error 0 after 15 rounds (bar: 0)")
    log("  phase wall %.1f s" % (time.perf_counter() - t0))


def pinned_numpy_rates(net, x, y):
    """AlexNet training images/s fed from numpy three ways, in turns: the
    batch copied to the card synchronously before each step (the feed
    before the staging ring); Net.update(x, y), whose batch crosses
    through the trainer's page-locked staging ring and an asynchronous
    copy; and the batch already on the card."""
    from cxxnet_tpu_torch.io import DataBatch

    def on_card():
        b = DataBatch()
        b.data = torch.from_numpy(x).to(DEV)
        b.label = torch.from_numpy(y.reshape(-1, 1)).to(DEV)
        b.batch_size = BATCH
        return b
    resident = on_card()
    steps = {"sync": lambda: net.net_.update(on_card()),
             "staged": lambda: net.update(x, y),
             "card": lambda: net.net_.update(resident)}

    def images_per_s(step, iters=8):
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        return BATCH * iters / (time.perf_counter() - t)
    rates = {k: [] for k in steps}
    for which in ("sync", "staged", "card", "card", "staged", "sync"):
        rates[which].append(images_per_s(steps[which]))
    log("  AlexNet fp32 training batch %d, images/s in turns (sync, staged, "
        "card, card, staged, sync; no synchronise between steps): the "
        "batch copied synchronously before each step %s, Net.update on "
        "numpy through the staging ring and the asynchronous copy %s, "
        "batch already on the card %s"
        % (BATCH, " / ".join("%.1f" % r for r in rates["sync"]),
           " / ".join("%.1f" % r for r in rates["staged"]),
           " / ".join("%.1f" % r for r in rates["card"])))
    return rates


def imagenet_pack(root):
    """The conf's own relative paths resolve from root/a/b: the pack lies
    at root/NameList.train, root/TRAIN.BIN, root/NameList.test and
    root/TEST.BIN (ImageNet.conf's ../../ names), read unchanged."""
    t = time.perf_counter()
    write_image_pack(os.path.join(root, "NameList.train"),
                     os.path.join(root, "TRAIN.BIN"), CLI_TRAIN_IMAGES,
                     CLI_HW, 1000, SEED)
    write_image_pack(os.path.join(root, "NameList.test"),
                     os.path.join(root, "TEST.BIN"), CLI_TEST_IMAGES,
                     CLI_HW, 1000, SEED + 1)
    cwd = os.path.join(root, "a", "b")
    os.makedirs(cwd)
    log("  pack: %d + %d PPM images %dx%d (seed %d) in %.2f s"
        % (CLI_TRAIN_IMAGES, CLI_TEST_IMAGES, CLI_HW, CLI_HW, SEED,
           time.perf_counter() - t))
    return cwd


def imagenet_section(name, extra=""):
    """The conf's ``name`` iterator section as a DataIter string, with the
    global keys that the CLI applies to every chain and that the image
    chain reads."""
    text = open(os.path.join(REPO, "example/ImageNet/ImageNet.conf")).read()
    start = text.index("%s\niter = imgbin" % name)
    body = text[start + len(name) + 1: text.index("iter = end", start)]
    return body + extra + "input_shape = 3,227,227\nbatch_size = %d\n" \
        "iter = end\n" % BATCH


def phase_cli_imagenet(lrn, learn_task, api):
    """example/ImageNet/ImageNet.conf through the CLI on the card at full
    width (imgbin + threadbuffer, random crops and mirrors, the mean image
    created on first use): two training rounds held to the same batches
    driven through api.Net.update, the input pipeline's rates, then
    task=pred / extract / pred_raw from the round-2 model held to
    api.Net.predict / extract. Returns the LRN (forward, backward)
    launches counted on the training path and the forward launches on the
    prediction path."""
    log("phase cli_imagenet_train")
    t0 = time.perf_counter()
    conf = os.path.join(REPO, "example/ImageNet/ImageNet.conf")
    conf_text = imagenet_cfg()
    with scratch_dir("cli_imagenet") as root:
        cwd = imagenet_pack(root)
        args = [conf, "num_round=%d" % CLI_ROUNDS,
                "max_round=%d" % CLI_ROUNDS, "dev=" + NET_DEV]
        steps = CLI_ROUNDS * (CLI_TRAIN_IMAGES // BATCH)
        evals = CLI_ROUNDS * (CLI_TEST_IMAGES // BATCH)

        # the main path: the counts start at 0 here and are read right after
        lrn.launches = lrn.no_norm_launches = lrn.bwd_launches = 0
        t = time.perf_counter()
        out, err = run_cli(learn_task, cwd, args)
        wall = time.perf_counter() - t
        train = (lrn.launches, lrn.bwd_launches, lrn.no_norm_launches)
        log("  %d rounds in %.2f s wall (mean image, init and eval "
            "included); lrn_fwd launches %d (%d storing no norm), lrn_bwd "
            "launches %d" % (CLI_ROUNDS, wall, train[0], train[2], train[1]))
        if train != (2 * steps + 2 * evals, 2 * steps, 2 * evals):
            raise AssertionError(
                "expected 2 + 2 LRN launches in each of %d steps and 2 "
                "without a norm in each of %d eval batches; counted %s"
                % (steps, evals, train))
        if len([ln for ln in err.splitlines() if ln.startswith("[")]) \
                != CLI_ROUNDS:
            raise AssertionError("expected %d eval lines" % CLI_ROUNDS)
        rates = round_rates(out)
        log("  rounds (input-wait %%, io img/s when blocked, step img/s): "
            "%s" % rates)

        # the CLI again and the same batches through api.Net.update, both
        # with cuDNN off: cuDNN's algorithms need not sum in one order from
        # call to call, and over these 8 steps (random labels, dropout on)
        # such differences grew to 8% of the largest update (run 1), while
        # PyTorch's native convolutions repeat bit for bit. The same seed
        # gives the same initial weights; each side makes its own mean
        # image (image_mean), drawing the crops and mirrors of that pass
        net = api.Net(dev=NET_DEV, cfg=conf_text)
        with cudnn_off():
            run_cli(learn_task, cwd, args + ["model_dir=models_det",
                                             "image_mean=models_det/mean",
                                             "save_model=%d" % CLI_ROUNDS])
            net.init_model()
            start = _params(net)
            with in_dir(cwd):
                it = api.DataIter(imagenet_section(
                    "data = train", 'image_mean = "mean_api"\n'))
                means = [open(f, "rb").read() for f in (
                    "models/image_net_mean.bin", "models_det/mean",
                    "mean_api")]
                if means[1:] != means[:2]:
                    raise AssertionError("the DataIter's mean image "
                                         "differs from the CLI's")
                log("  the DataIter's mean image is byte-identical to the "
                    "CLI's (both runs)")
                for r in range(CLI_ROUNDS):
                    net.start_round(r + 1)
                    it.before_first()
                    while it.next():
                        net.update(it)
                it.close()
        cli_net = api.Net(dev=NET_DEV, cfg=conf_text)
        cli_net.load_model(os.path.join(cwd, "models_det/%04d.model"
                                        % CLI_ROUNDS))
        compare_params("round-%d model of the CLI vs the same batches "
                       "through api.Net.update (cuDNN off on both)"
                       % CLI_ROUNDS, _params(cli_net), _params(net), start,
                       STEP_RTOL, STEP_ATOL_UPDATE)
        del cli_net, start
        torch.cuda.empty_cache()

        # the host pipeline alone (test_io), with one and four decode
        # threads (imgbinx's pool) in turns, IO_ROUNDS rounds a run, the
        # first round of each run (the loader's start) set apart; then
        # four trained under the profiler; none of these runs saves a model
        io_only = {1: [], 4: []}
        for threads in (1, 4, 1, 4):
            o, _ = run_cli(learn_task, cwd, args + [
                "num_round=%d" % IO_ROUNDS, "max_round=%d" % IO_ROUNDS,
                "test_io=1", "save_model=0", "decode_thread=%d" % threads],
                echo=("[",))
            io_only[threads].append([float(m.group(2))
                                     for m in IO_RE.finditer(o)])
        for threads, runs in io_only.items():
            rest = sorted(r for run in runs for r in run[1:])
            log("  io-only images/s, decode_thread %d, %d runs of %d "
                "rounds of %d images: rounds 2-%d median %.1f (%.1f-%.1f, "
                "%d rounds); first rounds %s"
                % (threads, len(runs), IO_ROUNDS, CLI_TRAIN_IMAGES,
                   IO_ROUNDS, float(np.median(rest)), rest[0], rest[-1],
                   len(rest), " / ".join("%.1f" % run[0] for run in runs)))
        outs = []
        profile_forward(lambda: outs.append(run_cli(
            learn_task, cwd, args + ["save_model=0",
                                     "decode_thread=4"])[0]),
            iters=1, warmup=False, top=6, unit="CLI run",
            shares=("lrn_fwd", "lrn_bwd"))
        log("  decode_thread 4 rounds (input-wait %%, io img/s, step "
            "img/s), profiled: %s" % round_rates(outs[0]))
        x = np.random.RandomState(SEED + 3).randn(BATCH, 3, 227, 227) \
            .astype(np.float32)
        y = np.random.RandomState(SEED + 4).randint(0, 1000, BATCH) \
            .astype(np.float32)
        pinned_numpy_rates(net, x, y)
        del net
        torch.cuda.empty_cache()

        log("  phase wall %.1f s" % (time.perf_counter() - t0))
        log("phase cli_imagenet_pred")
        t0 = time.perf_counter()
        model = os.path.join(cwd, "models/%04d.model" % CLI_ROUNDS)
        pred_section = ["pred=%s", "iter=imgbin",
                        "image_list=../../NameList.test",
                        "image_bin=../../TEST.BIN",
                        "image_mean=models/image_net_mean.bin", "iter=end"]
        tasks = (("pred", []), ("extract", ["extract_node_name=%s"
                                            % CLI_EXTRACT_NODE]),
                 ("pred_raw", []))
        lrn.launches = lrn.no_norm_launches = 0
        for task, extra in tasks:
            run_cli(learn_task, cwd, [conf, "dev=" + NET_DEV, "task=" + task,
                                      "model_in=" + model] + extra
                    + [pred_section[0] % (task + ".txt")] + pred_section[1:])
        pred = (lrn.launches, lrn.no_norm_launches)
        log("  lrn_fwd launches over pred, extract and pred_raw: %d, %d of "
            "them storing no norm" % pred)
        if pred != (3 * 2 * (CLI_TEST_IMAGES // BATCH),) * 2:
            raise AssertionError("expected 2 LRN launches without a norm "
                                 "per batch and task; counted %s" % (pred,))
        net = api.Net(dev=NET_DEV, cfg=conf_text)
        net.load_model(model)
        want = {"pred": [], "extract": [], "pred_raw": []}
        with in_dir(cwd):
            it = api.DataIter(imagenet_section("eval = test"))
            it.before_first()
            while it.next():
                want["pred"].append(net.predict(it))
                want["extract"].append(net.extract(it, CLI_EXTRACT_NODE)
                                       .reshape(BATCH, -1))
                want["pred_raw"].append(net.extract(it, "top[-1]")
                                        .reshape(BATCH, -1))
            it.close()
        want = {k: np.concatenate(v) for k, v in want.items()}
        got = np.array([float(v) for v in
                        open(os.path.join(cwd, "pred.txt")).read().split()])
        if not np.array_equal(got, want["pred"]):
            raise AssertionError("task=pred differs from api.Net.predict")
        log("  task=pred: %d rows, bitwise api.Net.predict" % len(got))
        meta = open(os.path.join(cwd, "extract.txt.meta")).read().strip()
        log("  extract.txt.meta: %s" % meta)
        for task in ("extract", "pred_raw"):
            rows = np.array([[float(v) for v in ln.split()] for ln in open(
                os.path.join(cwd, task + ".txt")).read().splitlines()])
            check_close("task=%s vs api.Net.extract (%s)"
                        % (task, rows.shape,), torch.from_numpy(rows),
                        torch.from_numpy(want[task].astype(np.float64)),
                        CLI_PRED_RTOL, 1e-30)
        del net
        torch.cuda.empty_cache()
    log("  phase wall %.1f s" % (time.perf_counter() - t0))
    return train, pred


def phase_cli_bowl_pred_raw(learn_task, api):
    """example/kaggle_bowl/pred.conf (task = pred_raw, round_batch = 1) on
    the card with dev=gpu, from a model that api.Net initialised from the
    same netconfig, over a 200-image pack whose last batch is padded."""
    log("phase cli_bowl_pred_raw")
    t0 = time.perf_counter()
    conf = os.path.join(REPO, "example/kaggle_bowl/pred.conf")
    conf_text = open(conf).read()
    with scratch_dir("cli_bowl") as d:
        write_image_pack(os.path.join(d, "test.lst"),
                         os.path.join(d, "test.bin"), BOWL_IMAGES, BOWL_HW,
                         BOWL_CLASSES, SEED)
        os.makedirs(os.path.join(d, "models"))
        net = api.Net(dev=NET_DEV, cfg=conf_text)
        net.init_model()
        net.save_model(os.path.join(d, "models/0100.model"))
        run_cli(learn_task, d, [conf, "dev=" + NET_DEV])
        rows = np.array([[float(v) for v in ln.split()] for ln in
                         open(os.path.join(d, "test.txt")).read()
                         .splitlines()])
        if rows.shape != (BOWL_IMAGES, BOWL_CLASSES):
            raise AssertionError("pred_raw wrote %s rows, want %s"
                                 % (rows.shape, (BOWL_IMAGES, BOWL_CLASSES)))
        it = api.DataIter(
            'iter = imgbin\nimage_list = "%s/test.lst"\n'
            'image_bin = "%s/test.bin"\nimage_mean = "%s/models/'
            'image_mean.bin"\niter = threadbuffer\ninput_shape = 3,40,40\n'
            'batch_size = 64\nround_batch = 1\niter = end\n' % (d, d, d))
        want, pads = [], []
        it.before_first()
        while it.next():
            b = it.check_valid()
            out = net.extract(it, "top[-1]").reshape(64, -1)
            want.append(out[:64 - b.num_batch_padd])
            pads.append(b.num_batch_padd)
        it.close()
        log("  %d rows x %d classes written; batches padded %s rows "
            "(dropped)" % (rows.shape + (pads,)))
        if pads[-1] != 64 * len(pads) - BOWL_IMAGES:
            raise AssertionError("the last batch is not padded as expected")
        check_close("pred_raw rows vs api.Net.extract (padding dropped)",
                    torch.from_numpy(rows),
                    torch.from_numpy(np.concatenate(want).astype(np.float64)),
                    CLI_PRED_RTOL, 1e-30)
        del net
        torch.cuda.empty_cache()
    log("  phase wall %.1f s" % (time.perf_counter() - t0))


def phase_lm_head_dim(flash, api, models, phase):
    """A wide head dim (HD_PHASES: 256, or 512 in two slices): the three
    flash kernels against their plain versions at the LM's shape, fp32 and
    bf16, with times beside d 64's at equal b h d; the LM with that head
    dim served through generate (held to the plain-flash run) and trained
    through update (gradients held to the plain backward's). Returns
    (kernel records by kernel, launches of the request, (forward, dQ,
    dK/dV) launches of the training steps)."""
    nhead, shape = HD_PHASES[phase]
    d = shape[5]
    log("phase %s (bench.py LM with nhead %d: head dim %d)"
        % (phase, nhead, d))
    recs = {"flash_fwd": phase_flash_fwd_kernel(
        flash, [shape], "%s flash_fwd_kernel" % phase)}
    bwd = phase_flash_bwd_kernel(flash, [shape],
                                 "%s flash_bwd_kernel" % phase)
    recs["flash_bwd_dq"], recs["flash_bwd_dkv"] = bwd["dq"], bwd["dkv"]
    for kernel, d64 in (("flash_fwd", "lm_full_sequence"),
                        ("flash_bwd_dq", "lm_train"),
                        ("flash_bwd_dkv", "lm_train")):
        a, b = KERNEL_MS.get((kernel, phase)), KERNEL_MS.get((kernel, d64))
        if a and b:
            log("  %s fp32: d %d (%s) %.4f ms vs d 64 (%s) %.4f ms, ratio "
                "%.3f" % (kernel, d, phase, a, d64, b, a / b))
    args = dict(LM_ARGS, nhead=nhead)
    nlayer = args["nlayer"]
    net = lm_net(api, models, LM_SEQ, LM_BATCH, args=args)
    rng = np.random.RandomState(SEED + 11)
    prompts = rng.randint(0, LM_ARGS["vocab"], (LM_BATCH, LM_PROMPT))

    # the serving path: the counts start at 0 here and are read right after
    flash.launches = 0
    t = time.perf_counter()
    got = net.generate(prompts, HD_NEW)
    wall = time.perf_counter() - t
    serve = flash.launches
    log("  generate (batch %d, prompt %d, %d new tokens): %.3f s wall, "
        "flash_fwd launches %d (%d expected)"
        % (LM_BATCH, LM_PROMPT, HD_NEW, wall, serve, nlayer))
    if serve != nlayer or got.shape != (LM_BATCH, HD_NEW):
        raise AssertionError("head dim %d request: %d launches, tokens %s"
                             % (d, serve, got.shape))
    check_request(flash, net, prompts, np.full(LM_BATCH, LM_PROMPT), got)

    # the training path: the counts start at 0 here and are read right after
    x = rng.randint(0, LM_ARGS["vocab"], (LM_BATCH, 1, 1, LM_SEQ)).astype(
        np.float32)
    y = rng.randint(0, LM_ARGS["vocab"], (LM_BATCH, LM_SEQ)).astype(
        np.float32)
    loss0 = lm_loss(net, x, y)
    batch_dev = lm_batch(x, y, DEV)
    batch_dev.data = batch_dev.data.long()

    def hold_grads(when):
        _, with_kernel = net.net_.loss_and_grads(batch_dev)
        with plain_flash_backward(flash):
            _, with_plain = net.net_.loss_and_grads(batch_dev)
        compare_grads("gradients %s, kernels vs flash_bwd_ref swapped in"
                      % when, with_kernel, with_plain, LM_GRAD_TOL)
    hold_grads("of the first step")
    flash.launches = flash.dq_launches = flash.dkv_launches = 0
    t = time.perf_counter()
    for step in range(HD_TRAIN_STEPS):
        net.update(x, y)
        counts = (flash.launches, flash.dq_launches, flash.dkv_launches)
        if counts != (nlayer * (step + 1),) * 3:
            raise AssertionError("expected %d launches of each flash kernel "
                                 "per update, counted %s" % (nlayer, counts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    loss1 = lm_loss(net, x, y)
    log("  %d update steps in %.3f s (first steps included), %s launches; "
        "fixed-batch cross-entropy %.6f before, %.6f after at the config's "
        "eta %g (reported: see LM_LOSS_ETA)"
        % (HD_TRAIN_STEPS, wall, counts, loss0, loss1, LM_ETA))
    for i, p in enumerate(_params(net)):
        for k, v in p.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError("layer %d %s not finite" % (i, k))
    hold_grads("after the %d steps" % HD_TRAIN_STEPS)
    del net, batch_dev
    torch.cuda.empty_cache()
    return recs, serve, counts


def ring_step_work(kernel, bh, bkv, sq, skv, d, q_off, kv_off, causal,
                   window, esize):
    """(operations, bytes) one ring step needs, counted for these offsets:
    per (query, key) pair the mask keeps 4 d flops (forward), 6 d (dQ) or
    8 d (dK/dV); q, the block's k and v (and dO, lse, D) read once, the f32
    carries read and written once. A step that keeps no pair needs only
    the forward's (m, l) copied."""
    pairs = kept_pairs(sq, causal, window, skv, q_off, kv_off) * bh
    q_b, kv_b = esize * bh * sq * d, esize * bkv * skv * d
    rows, q_f32, kv_f32 = 4 * bh * sq, 4 * bh * sq * d, 4 * bkv * skv * d
    if kernel == "fwd":
        if not pairs:
            return 0, 4 * rows
        return 4 * d * pairs, q_b + 2 * kv_b + 4 * rows + 2 * q_f32
    if not pairs:
        return 0, 0
    if kernel == "dq":
        return 6 * d * pairs, 2 * q_b + 2 * kv_b + 2 * rows + 2 * q_f32
    return 8 * d * pairs, 2 * q_b + 2 * kv_b + 2 * rows + 4 * kv_f32


def ring_peak(dtype):
    """The operation rate of a ring step kernel's bound: every step runs a
    tensor-core body, fp32 at the 3xTF32 rate, bf16 at the bf16 rate."""
    return FP32_3XTF32_OPS_PER_S if dtype == torch.float32 else \
        BF16_OPS_PER_S


def ring_step_inputs(bh, bkv, sq, skv, d, dtype, rng):
    """q, k, v, dO in dtype, the f32 forward carry of an earlier step
    (every third row still at (NEG_INF, 0, 0)), lse and D, and the f32
    backward carries (dq; dk and dv at query-head resolution), on the
    card."""
    def mk(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(DEV)
    q, do = mk(bh, sq, d).to(dtype), mk(bh, sq, d).to(dtype)
    k, v = mk(bkv, skv, d).to(dtype), mk(bkv, skv, d).to(dtype)
    m, l, acc = mk(bh, sq, 1), mk(bh, sq, 1).abs() + 0.5, mk(bh, sq, d)
    m[:, ::3], l[:, ::3], acc[:, ::3] = -1e30, 0.0, 0.0
    lse, delta = mk(bh, sq, 1).abs() + 3.0, mk(bh, sq, 1)
    return ((q, k, v, do), (m, l, acc), (lse, delta),
            (mk(bh, sq, d), mk(bh, skv, d), mk(bh, skv, d)))


def ring_step_case(rf, case, dtype, rng):
    """The three step kernels against their plain versions at one step's
    shape and offsets, from the same carries; a step that keeps no pair
    leaves every carry bitwise as it was. Returns the largest absolute
    error and {kernel: (kernel ms, plain ms, bound ms, what bounds it)}."""
    name, bh, bkv, sq, skv, d, q_off, kv_off, causal, window = case
    (q, k, v, do), (m, l, acc), (lse, delta), (dq, dk, dv) = \
        ring_step_inputs(bh, bkv, sq, skv, d, dtype, rng)
    offs = (q_off, kv_off)
    kw = dict(causal=causal, scale=d ** -0.5, window=window)
    log(" %s bh %d bkv %d sq %d skv %d d %d offs %s causal %d window %d %s"
        % (name, bh, bkv, sq, skv, d, offs, causal, window,
           str(dtype)[6:]))
    got = rf.fwd_step_cuda(q, k, v, m, l, acc.clone(), offs, **kw) + \
        (rf.dq_step_cuda(q, k, v, do, lse, delta, dq.clone(), offs, **kw),) \
        + rf.dkv_step_cuda(q, k, v, do, lse, delta, dk.clone(), dv.clone(),
                           offs, **kw)
    torch.cuda.synchronize()
    want = rf.fwd_step_ref(q, k, v, m, l, acc, offs, **kw) + \
        (rf.dq_step_ref(q, k, v, do, lse, delta, dq, offs, **kw),) + \
        rf.dkv_step_ref(q, k, v, do, lse, delta, dk, dv, offs, **kw)
    err = 0.0
    for nm, g, w in zip(("m", "l", "acc", "dq", "dk", "dv"), got, want):
        finite = w[w > -5e29]
        scale = float(finite.abs().max()) if finite.numel() else 1.0
        tol = (RING_TOL[torch.float32] if nm in ("m", "l")
               else RING_TOL[dtype])
        err = max(err, check_close("%s vs plain" % nm, g, w, 0.0,
                                   tol * scale))
    pairs = kept_pairs(sq, causal, window, skv, q_off, kv_off)
    if pairs == 0:
        same = all(torch.equal(g, s0) for g, s0 in
                   zip(got, (m, l, acc, dq, dk, dv)))
        log("  no pair kept: every carry bitwise as it was: %s" % same)
        if not same:
            raise AssertionError("a wholly masked ring step moved a carry")
    calls = {
        "fwd": (lambda: rf.fwd_step_cuda(q, k, v, m, l, acc, offs, **kw),
                lambda: rf.fwd_step_ref(q, k, v, m, l, acc, offs, **kw)),
        "dq": (lambda: rf.dq_step_cuda(q, k, v, do, lse, delta, dq, offs,
                                       **kw),
               lambda: rf.dq_step_ref(q, k, v, do, lse, delta, dq, offs,
                                      **kw)),
        "dkv": (lambda: rf.dkv_step_cuda(q, k, v, do, lse, delta, dk, dv,
                                         offs, **kw),
                lambda: rf.dkv_step_ref(q, k, v, do, lse, delta, dk, dv,
                                        offs, **kw))}
    times = {}
    for key, (kern, plain) in calls.items():
        ms, plain_ms = time_ms(kern), time_ms(plain, iters=3, warmup=1)
        ops_n, nbytes = ring_step_work(key, bh, bkv, sq, skv, d, q_off,
                                       kv_off, causal, window,
                                       q.element_size())
        peak = ring_peak(dtype)
        bound_ms, bound_by = max((ops_n / peak * 1e3, "operations"),
                                 (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
        times[key] = (ms, plain_ms, bound_ms, bound_by)
        log("  %s kernel_ms %.4f plain_ms %.4f bound_ms %.4f (%s: %.3e "
            "operations at %.0f TFLOP/s, %d bytes, %d pairs kept a head)%s"
            % (key, ms, plain_ms, bound_ms, bound_by, ops_n, peak / 1e12,
               nbytes, pairs,
               "" if not bound_ms else " kernel/bound %.2f" % (ms / bound_ms)))
    return err, times


def ring_main_path(rf, dtype, rng):
    """One layer's ring on the main path: the long recipe's shard at
    sp = SP_N, every (rank, step) launch of the forward step, then of the
    dQ and dK/dV steps, timed as one ring each against the same launches
    of the plain versions and the sum of their bounds. Returns
    {kernel: record}."""
    bh, bkv, sq, skv, d = RING_SHAPE
    window = int(LONG_EXTRA.split("attn_window = ")[1].split()[0])
    kw = dict(causal=True, scale=d ** -0.5, window=window)
    (q, k, v, do), (m, l, acc), (lse, delta), (dq, dk, dv) = \
        ring_step_inputs(bh, bkv, sq, skv, d, dtype, rng)
    steps = [(i * sq, ((i - t) % SP_N) * skv) for t in range(SP_N)
             for i in range(SP_N)]
    calls = {
        "fwd": (rf.fwd_step_cuda, rf.fwd_step_ref,
                lambda fn, o: fn(q, k, v, m, l, acc, o, **kw)),
        "dq": (rf.dq_step_cuda, rf.dq_step_ref,
               lambda fn, o: fn(q, k, v, do, lse, delta, dq, o, **kw)),
        "dkv": (rf.dkv_step_cuda, rf.dkv_step_ref,
                lambda fn, o: fn(q, k, v, do, lse, delta, dk, dv, o, **kw))}
    recs = {}
    for key, (kern, plain, call) in calls.items():
        ms = time_ms(lambda: [call(kern, o) for o in steps], iters=5)
        plain_ms = time_ms(lambda: [call(plain, o) for o in steps], iters=2,
                           warmup=1)
        peak = ring_peak(torch.float32)
        bound_ms = ops_ms = bytes_ms = fma_ms = 0.0
        for o in steps:
            ops_n, nbytes = ring_step_work(key, bh, bkv, sq, skv, d, o[0],
                                           o[1], True, window, 4)
            ops_ms += ops_n / peak * 1e3
            bytes_ms += nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms += max(ops_n / peak, nbytes / HBM_BYTES_PER_S) * 1e3
            fma_ms += max(ops_n / FP32_OPS_PER_S,
                          nbytes / HBM_BYTES_PER_S) * 1e3
        rec = _new_rec()
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   library_ms=None)
        recs[key] = rec
        log("  one layer's ring of %d %s launches (bh %d, bkv %d, shards "
            "of %d, d %d, window %d): kernels %.4f ms, plain %.4f ms, bound "
            "%.4f ms (the sum of each launch's, at %.0f TFLOP/s), "
            "kernel/bound %.2f; fp32 FMA-rate bound %.4f ms, kernel/that "
            "%.2f"
            % (len(steps), key, bh, bkv, sq, d, window, ms, plain_ms,
               bound_ms, peak / 1e12, ms / bound_ms, fma_ms, ms / fma_ms))
    return recs


def phase_ring_step_kernels(rf, flash, ring):
    """The ring-step kernels against their plain versions on the card: at
    the long recipe's shard in every class of offsets, at d 256 and 512
    and at sq != skv, fp32 and bf16, with times, bounds and the plain
    versions' times; one layer's whole ring on the main path timed; then
    n steps over a whole sequence against the flash kernels (rows 4-6):
    out, lse, dq, dk, dv. Returns {kernel: record} (the main path's fp32
    times; the largest error of every check)."""
    log("phase ring_step_kernels")
    rng = np.random.RandomState(SEED + 13)
    bh, bkv, sq, skv, d = RING_SHAPE
    cases = [(nm, bh, bkv, sq, skv, d, qo, ko, c, w)
             for nm, qo, ko, c, w in RING_CLASSES] + RING_EDGE
    err = 0.0
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            e, _ = ring_step_case(rf, case, dtype, rng)
            if dtype == torch.float32:
                err = max(err, e)
            torch.cuda.empty_cache()
    recs = ring_main_path(rf, torch.float32, rng)
    for name, b, h, nkv, L, d_, causal, window in RING_VS_FLASH:
        for dtype in ((torch.float32, torch.bfloat16)
                      if name == RING_VS_FLASH[0][0] else (torch.float32,)):
            host = [torch.from_numpy(rng.randn(b, n, L, d_).astype(
                np.float32)) for n in (h, nkv, nkv, h)]
            q, k, v, dout = (t.to(DEV, dtype) for t in host)
            args = (causal, None, window)
            out, lse = flash.flash_fwd_cuda(q, k, v, *args)
            want = (out, lse) + flash.flash_bwd_cuda(q, k, v, out, lse, dout,
                                                     *args)
            ranks = ring._Ranks(SP_N, None)
            scale = d_ ** -0.5
            before = (rf.fwd_launches, rf.dq_launches, rf.dkv_launches)
            r_out, r_lse = ring._ring_flash_fwd(q, k, v, ranks, causal,
                                                scale, window)
            got = ring._ring_flash_bwd(q, k, v, r_out, r_lse, dout, ranks,
                                       causal, scale, window)
            torch.cuda.synchronize()
            counts = tuple(a - b0 for a, b0 in zip(
                (rf.fwd_launches, rf.dq_launches, rf.dkv_launches), before))
            r_lse = r_lse.reshape(SP_N, b, h, L // SP_N).permute(
                1, 2, 0, 3).reshape(b, h, L)
            log(" %d ring steps vs the flash kernels: %s b %d h %d nkv %d L "
                "%d d %d causal %d window %d %s; step launches %s"
                % (SP_N, name, b, h, nkv, L, d_, causal, window,
                   str(dtype)[6:], counts))
            if counts != (SP_N * SP_N,) * 3:
                raise AssertionError("expected %d launches of each step "
                                     "kernel" % (SP_N * SP_N))
            for nm, g, w in zip(("out", "lse", "dq", "dk", "dv"),
                                (r_out, r_lse) + got, want):
                tol = RING_TOL[torch.float32 if nm == "lse" else dtype]
                e = check_close("%s vs flash kernels" % nm, g, w, 0.0,
                                tol * float(w.float().abs().max()))
                if dtype == torch.float32:
                    err = max(err, e)
            del q, k, v, dout, out, lse, want, r_out, r_lse, got
            torch.cuda.empty_cache()
    for rec in recs.values():
        rec["max_abs_err"] = err
    log("  largest absolute error of the fp32 checks: %.3e" % err)
    return recs


def sp_logp(net, x):
    """log-probabilities of a full-sequence predict_device, (b, vocab, L)."""
    last = net.net_.net_cfg.param.num_nodes - 1
    return torch.log(net.net_._forward_nodes(x, (last,))[0][:, :, 0, :])


def phase_lm_sp_train(flash, rf, api, models, phase, seq, batch, extra,
                      sp_mode):
    """An LM under seq_parallel = SP_N through api.Net(dev="gpu"), loaded
    from the single-card net's model file: one full-sequence
    predict_device (log-probabilities held to the single-card flash run)
    and SP_STEPS updates (the first step's gradients held to the single
    card's; the ring runs n^2 launches of each step kernel per layer and
    direction, Ulysses n of each flash kernel); tokens/s in turns with the
    single-card run. Returns the launches of the main path: (forward, dQ,
    dK/dV) of the ring-step kernels for the ring, of the flash kernels for
    Ulysses, over the predict_device and the updates."""
    log("phase %s (L %d, batch %d, seq_parallel %d, sp_mode %s%s)"
        % (phase, seq, batch, SP_N, sp_mode,
           ", " + extra.replace("\n", ", ").strip(", ") if extra else ""))
    one = lm_net(api, models, seq, batch, extra)
    fname = scratch_file("chip_smoke_sp.model")
    one.save_model(fname)
    sp = api.Net(dev=NET_DEV, cfg=lm_cfg(
        models, seq, batch, extra + "sp_mode = %s\n" % sp_mode) +
        "seq_parallel = %d\n" % SP_N)
    sp.load_model(fname)
    os.remove(fname)
    nlayer, vocab = LM_ARGS["nlayer"], LM_ARGS["vocab"]
    rng = np.random.RandomState(SEED + 17)
    x = rng.randint(0, vocab, (batch, 1, 1, seq)).astype(np.float32)
    y = rng.randint(0, vocab, (batch, seq)).astype(np.float32)
    ring_path = sp_mode == "ring"
    per = SP_N * SP_N if ring_path else SP_N   # per layer and direction

    def counts():
        if ring_path:
            return (rf.fwd_launches, rf.dq_launches, rf.dkv_launches)
        return (flash.launches, flash.dq_launches, flash.dkv_launches)

    def zero():
        rf.fwd_launches = rf.dq_launches = rf.dkv_launches = 0
        flash.launches = flash.dq_launches = flash.dkv_launches = 0

    # the main path: the counts start at 0 here and are read right after
    zero()
    got = sp_logp(sp, x)
    torch.cuda.synchronize()
    pred = counts()
    want = sp_logp(one, x)
    err = float((got - want).abs().max())
    log("  full-sequence predict_device: %s launches (%d expected); "
        "log-probabilities vs the single-card flash run: max_abs_err %.3e "
        "(tolerance %.0e) %s" % (pred, per * nlayer, err, LOGP_TOL,
                                 "ok" if err <= LOGP_TOL else "FAILED"))
    if pred != (per * nlayer, 0, 0) or not err <= LOGP_TOL:
        raise AssertionError("%s predict_device: %s launches, error %g"
                             % (phase, pred, err))
    del got, want
    batch_dev = lm_batch(x, y, DEV)
    batch_dev.data = batch_dev.data.long()
    # the attention outputs of the two runs differ by their summation order,
    # and an FFN pre-activation within rounding of 0 can fall on the other
    # side of 0 in the two runs, which flips its element's gradient
    # wholesale; the single-card run takes the sp run's ReLU masks for the
    # comparison (as the card-vs-CPU steps do)
    flips, total, worst = take_card_relu_masks(sp, one, x)
    log("  ReLU masks: %d of %d FFN pre-activations fall on the other side "
        "of 0 in the two runs (the largest of them %.3e of its node's "
        "largest magnitude); the single-card run takes the sp run's masks "
        "for the gradients" % (flips, total, worst))
    loss_1, grads_1 = one.net_.loss_and_grads(batch_dev)
    for lay in one.net_.net.layers:
        lay.__dict__.pop("forward", None)   # its own ReLUs again
    loss_sp, grads_sp = sp.net_.loss_and_grads(batch_dev)
    rel = abs(float(loss_sp) - float(loss_1)) / abs(float(loss_1))
    log("  loss seq_parallel %.7f vs single card %.7f: relative %.3e "
        "(tolerance %.0e) %s" % (float(loss_sp), float(loss_1), rel,
                                 LM_LOSS_RTOL,
                                 "ok" if rel <= LM_LOSS_RTOL else "FAILED"))
    if rel > LM_LOSS_RTOL:
        raise AssertionError("%s loss" % phase)
    compare_grads("gradients seq_parallel vs single card", grads_sp,
                  grads_1, LM_GRAD_TOL)
    del grads_1, grads_sp
    zero()
    for step in range(SP_STEPS):
        sp.update(x, y)
    torch.cuda.synchronize()
    steps = counts()
    log("  %d update steps: %s launches (%d of each per step expected)"
        % (SP_STEPS, steps, per * nlayer))
    if steps != (SP_STEPS * per * nlayer,) * 3:
        raise AssertionError("%s: %s launches in %d updates"
                             % (phase, steps, SP_STEPS))
    for i, p in enumerate(_params(sp)):
        for k, v in p.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError("layer %d %s not finite" % (i, k))

    def tokens_per_s(net, iters=3):
        net.net_.update(batch_dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            net.net_.update(batch_dev)
        torch.cuda.synchronize()
        return batch * seq * iters / (time.perf_counter() - t)
    rates = {"one": [], "sp": []}
    for which in ("one", "sp", "sp", "one"):
        rates[which].append(tokens_per_s(one if which == "one" else sp))
    log("  training, batch on the card: %s tokens/s with seq_parallel %d "
        "(%s), %s on one rank (flash kernels), in turns one, sp, sp, one"
        % (" / ".join("%.0f" % r for r in rates["sp"]), SP_N, sp_mode,
           " / ".join("%.0f" % r for r in rates["one"])))
    profile_forward(lambda: sp.net_.update(batch_dev), unit="step",
                    shares=("ring_fwd_step", "ring_dq_step", "ring_dkv_step")
                    if ring_path else ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv"))
    del one, sp, batch_dev
    torch.cuda.empty_cache()
    return tuple(a + b for a, b in zip(pred, steps))


def device_us(e) -> float:
    """A profiler event's self device time in us, under either name that
    torch versions give it."""
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else e.self_cuda_time_total


def profile_forward(forward, iters: int = 3, top: int = 8,
                    unit: str = "forward", shares=("lrn_fwd",),
                    warmup: bool = True) -> None:
    """Where a forward's (or a training step's, a request's, a CLI run's)
    device time goes: torch.profiler over ``iters`` synchronised calls,
    after one unprofiled call unless ``warmup`` is off; prints kernel and
    copy time per call, the device's busy share of the wall time (the
    profiler's own overhead included), the largest kernels by self device
    time, and the share of the port's kernels named in ``shares``; returns
    the device time per call (None where none was recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        forward()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / iters

    kernels = [(device_us(e) / 1e3 / iters, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    if not kernels:
        log("  profile: no device time recorded (not measured)")
        return None
    kernels.sort(reverse=True)
    busy_ms = sum(ms for ms, _ in kernels)
    log("  profile over %d %ss: device kernel time %.3f ms/%s, "
        "wall %.3f ms/%s, device busy share %.3f"
        % (iters, unit, busy_ms, unit, wall_ms, unit, busy_ms / wall_ms))
    for ms, name in kernels[:top]:
        log("    %8.3f ms %5.1f%%  %s" % (ms, 100 * ms / busy_ms, name[:90]))
    for kernel in shares:
        symbol = KERNEL_SYMBOLS.get(kernel, kernel)
        k_ms = sum(ms for ms, name in kernels if symbol in name)
        log("    %s kernels: %.3f ms/%s, %.1f%% of device time"
            % (kernel, k_ms, unit, 100 * k_ms / busy_ms))
    return busy_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from cxxnet_tpu_torch import api, learn_task, models, ops
    from cxxnet_tpu_torch.ops import _build, flash_attn, lrn
    from cxxnet_tpu_torch.ops import random as rnd
    from cxxnet_tpu_torch.ops import ring_flash
    from cxxnet_tpu_torch.parallel import ring

    log(nvidia_smi())
    log("torch %s cuda %s, %s" % (torch.__version__, torch.version.cuda,
                                  torch.cuda.get_device_name(0)))
    t0 = time.time()
    libs = _build.build_kernels()
    log("build: %d kernels in %.2f s" % (len(libs), time.time() - t0))
    for name, path in libs.items():
        with open(path[:-3] + ".log") as f:
            log("  %s: %s" % (name, ptxas_summary(f.read())))

    fwd_rec = phase_lrn_kernel(lrn)
    pred_launches = phase_alexnet_pred(lrn, api)
    bwd_rec = phase_lrn_bwd_kernel(lrn)
    train_fwd, train_bwd = phase_alexnet_train(lrn, api, ops)
    uniform_rec = phase_uniform_kernel(rnd)
    rrelu = phase_rrelu_alexnet_train(rnd, lrn, api, ops, models)
    phase_cli_mnist_conv(learn_task)
    cli_train, cli_pred = phase_cli_imagenet(lrn, learn_task, api)
    phase_cli_bowl_pred_raw(learn_task, api)
    flash_rec = phase_flash_fwd_kernel(flash_attn)
    serve_launches = phase_lm_serve(flash_attn, api, models)
    long_launches = phase_lm_serve_long(flash_attn, api, models)
    bwd_recs = phase_flash_bwd_kernel(flash_attn)
    train = {spec[0]: phase_lm_train(flash_attn, api, models, ops, *spec)
             for spec in LM_TRAIN}
    wide = {}
    serve_wide = {}
    for phase in HD_PHASES:
        wide[phase], serve_wide[phase + "_serve"], \
            train[phase + "_train"] = phase_lm_head_dim(flash_attn, api,
                                                        models, phase)
    ring_recs = phase_ring_step_kernels(ring_flash, flash_attn, ring)
    sp = {spec[0]: phase_lm_sp_train(flash_attn, ring_flash, api, models,
                                     *spec) for spec in LM_SP}
    ring_paths = {p: c for p, c in sp.items() if p.endswith("_ring")}
    train.update({p: c for p, c in sp.items() if p.endswith("_ulysses")})
    per_step = {"train_step": LM_ARGS["nlayer"]}
    ring_per = {"layer_and_direction": SP_N * SP_N,
                "train_step": SP_N * SP_N * LM_ARGS["nlayer"]}
    log("wall time %.1f s" % (time.time() - t0))
    kernels = []
    for name, rec, replaces, by_path, per in (
            ("lrn_fwd", fwd_rec, "cxxnet_tpu/ops/pallas_kernels.py:78",
             {"alexnet_pred": pred_launches, "alexnet_train": train_fwd,
              "rrelu_alexnet_train": rrelu[1],
              "cli_imagenet_train": cli_train[0],
              "cli_imagenet_pred": cli_pred[0]},
             {"train_step": train_fwd // TRAIN_STEPS}),
            ("lrn_bwd", bwd_rec, "cxxnet_tpu/ops/pallas_kernels.py:98",
             {"alexnet_train": train_bwd, "rrelu_alexnet_train": rrelu[2],
              "cli_imagenet_train": cli_train[1]},
             {"train_step": train_bwd // TRAIN_STEPS}),
            ("uniform", uniform_rec, "cxxnet_tpu/ops/pallas_kernels.py:169",
             {"rrelu_alexnet_train": rrelu[0]},
             {"train_step": rrelu[0] // TRAIN_STEPS}),
            ("flash_fwd", flash_rec, "cxxnet_tpu/ops/flash_attn.py:284",
             {"lm_serve": serve_launches, "lm_serve_long": long_launches,
              **serve_wide,
              **{p: c[0] for p, c in train.items()}},
             {"generate_request": LM_ARGS["nlayer"],
              "full_sequence_forward": LM_ARGS["nlayer"], **per_step}),
            ("flash_bwd_dq", bwd_recs["dq"],
             "cxxnet_tpu/ops/flash_attn.py:337",
             {p: c[1] for p, c in train.items()}, per_step),
            ("flash_bwd_dkv", bwd_recs["dkv"],
             "cxxnet_tpu/ops/flash_attn.py:363",
             {p: c[2] for p, c in train.items()}, per_step),
            ("ring_fwd_step", ring_recs["fwd"],
             "cxxnet_tpu/ops/ring_flash.py:191",
             {p: c[0] for p, c in ring_paths.items()}, ring_per),
            ("ring_dq_step", ring_recs["dq"],
             "cxxnet_tpu/ops/ring_flash.py:224",
             {p: c[1] for p, c in ring_paths.items()}, ring_per),
            ("ring_dkv_step", ring_recs["dkv"],
             "cxxnet_tpu/ops/ring_flash.py:248",
             {p: c[2] for p, c in ring_paths.items()}, ring_per)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "cxxnet_tpu_torch/csrc/%s.cu" % name,
            "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_per": per,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
        if name == "lrn_fwd":
            kernels[-1]["inference"] = {
                "ms": rec["no_norm_ms"], "bound_ms": rec["no_norm_bound_ms"],
                "bound_by": rec["no_norm_bound_by"],
                "covers": "the forward storing no norm (predict's path)"}
        if name.startswith("flash_bwd"):
            kernels[-1]["plain_and_library_cover"] = \
                "the whole backward: dq, dk and dv in one call"
        for phase, recs in wide.items():
            if name in recs:
                kernels[-1]["head_dim_" + phase[len("lm_hd"):]] = {
                    k: recs[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms",
                                               "max_abs_err")}
        if name.startswith("ring_"):
            kernels[-1]["times_cover"] = (
                "one layer's ring on the main path: %d (rank, step) launches "
                "at the long recipe's shard" % (SP_N * SP_N))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
