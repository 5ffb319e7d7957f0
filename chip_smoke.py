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
kernels) and held to api.Net.update on the same batches, then, in
processes of their own, stopped by SIGTERM mid-round and resumed with
``continue = 1`` (its status pages scraped) to a model file equal bit for
bit to the uninterrupted run's, a torn newest file quarantined, the
port's offline tools (cxxnet_tpu_torch.tools: summarize_trace,
telemetry_report, ckpt_fsck --deep, roofline) run on that run's trace,
log and model files, the same training under the health monitor (a NaN
batch rolled back and replayed onto the batch-excluded control's model
file bit for bit, ``nonfinite_action = skip`` with no host sync in a
step, the watchdog over a whole run), then pred / extract / pred_raw
from its model held to api.Net, the port's C ABI (csrc/wrapper) driving
wrapper/test_wrapper.c and, loaded with ctypes, ImageNet.conf's net on
the card bitwise api.Net's, and example/kaggle_bowl/pred.conf's
pred_raw with a padded last batch; then the image input path without cv2: the port's host
library (csrc/host) built with g++, its JPEG decoder held to libjpeg-turbo's
hashes of tests/data/jpeg and timed alone, its warp bitwise
io/warp.py's, ImageNet.conf trained for a round from a JPEG pack made by
io/synth.py's numpy encoder (decode_thread=4 decode_timeout=30, every
record through the port's decoder) and example/kaggle_bowl/bowl.conf for
2 rounds with its geometric keys, each held to api.Net.update over the
same batches; then the exported programs (``torch.export`` with the LRN and
flash forward kernels as ``cxxnet::`` ops): ImageNet.conf's forward at
batch 256 and at a symbolic batch, and the bench.py LM's decode loop in
bf16 as a prefill and a step program, loaded and run in a fresh process
that imports torch and the port's op library only, held to api.Net's
extract / predict and generate; then
mixed precision (``compute_dtype = bfloat16``): the LRN kernels at
GoogLeNet's shapes, GoogLeNet trained and served in bf16 at batch 128
(models.googlenet_config, bench.py's recipe), example/ImageNet/
GoogLeNet.conf read unchanged by the command line for one round and pred,
VGG-16 with ``remat = 1`` at batch 64 (remat on against off), ResNet-18
at batch 128 (batch-norm), and bench.py's bf16 AlexNet and LM, each bf16
run held to the f32 run of the same weights and batch and, at a reduced
size, to the port's CPU path's bf16-versus-f32 gap; then the rest of the
layer set (tanh, softplus, bias, fixconn from a file, maxout, im2seq, moe
with top_k, a registered extern op, l2_loss, multi_logistic) in one
small net trained a step on the card against the CPU, bench.py's
MobileNet in bf16 at batch 256 (its depthwise weight gradient, one
batched product over the groups, held to float64 on the card) and
bench.py's ViT-S/16 in bf16 at batch 128 (the flash kernels at (128, 6,
196, 64), not causal, 12 launches of each a step); then
the transformer LM that bench.py
measures (vocab 8192, d_model 512, 8 heads, 4 blocks, 2048 positions,
fp32, random weights from a seed) served through KV-cached ``generate``
and a full-sequence ``predict_device``, and its long-context recipe (8192
positions, 2 kv heads, window 1024, RoPE); then the serving engine on the
bench.py LM in bf16: 24 requests through a dense and a paged
``decode_session`` (8 slots, greedy and sampled, a shared 512-token system
prompt reused by the paged cache), each request held to its solo
``generate``, beam search and ``decode_chunk``, and ``task = generate``
from the command line; then the serving frontend: the same 24 requests
sent by 8 concurrent TCP clients through ``api.Net.serve``'s continuous
batching (dense and paged greedy, dense sampled; answers held to solo
``generate``, the books reconciled, a flood against a queue of 4, a drain
with requests in flight), and ``task = serve`` from the command line on
stdin and, in a process of its own, over TCP with its status pages
scraped until SIGTERM drains it; then both
LMs trained through
``update`` (the config's Adam, batch 8 and 2); the bench.py LM with 2
heads (head dim 256) and with 1 head (head dim 512) served and trained;
last sequence parallelism: the ring-step kernels against their plain
versions and n ring steps against the flash kernels, then the long recipe
trained with ``seq_parallel = 4`` as a ring (the ring-step kernels on
shards of 2048) and as Ulysses, and the bench.py LM as a ring, each held
to the single-card run; then the modes over ranks: four processes on the
one card over gloo, started through ``coordinator`` / ``num_worker`` /
``worker_rank``, train ImageNet.conf under ZeRO-1, fsdp and dp x TP, the
bf16 LM under dp x TP and ImageNet.conf's trunk with fc7 a moe of 8
experts under dp x ep, each case's model file held to the single-process
run of the same steps, and one NCCL rank runs its collectives. Exits
non-zero, with no result, when there is no card or any phase fails.

Output, in order: the card's name and power limit (nvidia-smi), the build
time, the phases ``lrn_kernel``, ``alexnet_pred``, ``lrn_bwd_kernel``,
``alexnet_train``, ``uniform_kernel``, ``uniform_rows_kernel``,
``rrelu_alexnet_train``,
``cli_mnist_conv``, ``cli_imagenet_train``, ``cli_imagenet_resume``,
``tools_offline``, ``cli_imagenet_health``, ``cli_imagenet_pred``,
``c_abi_imagenet``,
``cli_bowl_pred_raw``, ``jpeg_decode``, ``cli_imagenet_jpeg``,
``cli_bowl_train``, ``export_forward``, ``export_decode``,
``export_load``, ``lrn_kernel_googlenet``,
``lrn_bwd_kernel_googlenet``, ``googlenet_bf16_train``,
``googlenet_bf16_pred``, ``cli_googlenet``, ``vgg16_bf16_remat``,
``resnet18_bf16_train``, ``bench_bf16``, ``layers_misc``,
``mobilenet_bf16_train``, ``vit_s16_bf16_train``, ``flash_fwd_kernel``,
``lm_serve``, ``lm_serve_long``, ``lm_serve_session``, ``cli_lm_generate``,
``lm_serve_frontend``, ``cli_lm_serve``, ``cli_lm_route``,
``flash_bwd_kernel``,
``lm_train``, ``lm_train_long``, ``lm_hd256``, ``lm_hd512``,
``ring_step_kernels``, ``lm_sp_train_long_ring``,
``lm_sp_train_long_ulysses``, ``lm_sp_train_ring``, ``dist_imagenet`` +
``dist_lm`` + ``dist_pipe`` + ``dist_sp`` (one spawn of 4 ranks: the
modes over ranks, the pipeline and the sp axis) and ``dist_nccl_1``
(kernel checks, the
main paths' checks, throughput and profiles), the wall time, then a JSON
line ``{"kernels": [...]}`` (each row's bf16 times under "bf16", rows
4-6 at the ViT step's shape under "vit_s16") and,
last, the JSON result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the card's peaks and the kernels' work counts, from the port: the
# performance ledger and this script read one table and one count
from cxxnet_tpu_torch.ops import lrn as _lrn_ops  # noqa: E402
from cxxnet_tpu_torch.ops import random as _random_ops  # noqa: E402
from cxxnet_tpu_torch.ops.flash_attn import bwd_work as flash_bwd_work  # noqa: E402,E501
from cxxnet_tpu_torch.ops.flash_attn import kept_pairs  # noqa: E402
from cxxnet_tpu_torch.ops.flash_attn import work as flash_work  # noqa: E402
from cxxnet_tpu_torch.ops.ring_flash import work as ring_step_work  # noqa: E402,E501
from cxxnet_tpu_torch.utils.perf import DEVICE_SPECS  # noqa: E402

SEED = 0
BATCH = 256
# the torch device of the kernel checks and the api dev spec of the main
# paths
DEV = "cuda"
NET_DEV = "gpu"
# H100 SXM data-sheet peaks (dense), the performance ledger's h100 entry:
# device memory rate and fp32 outside the tensor cores
H100 = DEVICE_SPECS["h100"]
HBM_BYTES_PER_S = H100.hbm_bw
FP32_OPS_PER_S = H100.fp32_flops
# fp32-accurate products on the tensor cores: 3xTF32, three TF32 products
# (495 TFLOP/s dense) per fp32 product. The rate of the fp32 bound of
# every attention kernel (the flash forward and backward, the ring steps),
# all on the tensor cores; the bound at FP32_OPS_PER_S is printed beside
# it, for comparison with the SIMT kernels they replaced
FP32_3XTF32_OPS_PER_S = H100.tf32_flops / 3
# dense bf16 on the tensor cores: the least time for bf16 attention inputs
BF16_OPS_PER_S = H100.peak_flops
# LRN operations per element, forward and backward (ops/lrn.py)
LRN_OPS_PER_ELEM = _lrn_ops.OPS_PER_ELEM
LRN_BWD_OPS_PER_ELEM = _lrn_ops.BWD_OPS_PER_ELEM
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
    # a rank of the bf16 LM at data parallel 2 (dist_lm): half the batch,
    # every head (attention stays whole under tensor parallelism)
    ("dist_lm_rank", 4, 8, 8, 2048, 64, True, 0),
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
    ("dist_lm_rank", 4, 8, 8, 2048, 64, True, 0),
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
# Philox4x32-10's integer operations per element (ops/random.py)
UNIFORM_OPS_PER_ELEM = _random_ops.OPS_PER_ELEM
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

# slice 11: compute_dtype = bfloat16. GoogLeNet and ResNet-18 at bench.py's
# batch 128, VGG-16 at its 64 (VGG.conf's), all 224x224, 1000 classes
BF16 = "compute_dtype = bfloat16\n"
# the serving engine (slice 12), on the bench.py LM in bf16: 24 requests of
# 256-1024 prompt tokens, 12 of them behind one 512-token system prompt
# (their own tails 64-512 tokens), 64 new tokens each, through sessions of
# 8 slots, greedy then sampled at (temperature, top_k); the paged cache in
# blocks of 16 rows
SESS_REQUESTS, SESS_SLOTS, SESS_NEW = 24, 8, 64
SESS_PROMPT, SESS_PREFIX, SESS_TAIL = (256, 1024), 512, (64, 512)
SESS_BLOCK = 16
# the capped paged pool of lm_serve_session: the ledger's headroom fraction
# is chosen so that the cap (perf.Ledger.decode_pool_cap_bytes) binds at
# this share of the dense-equivalent pool, above what the 24 requests' 8
# live slots ever hold (8 x (1024 + 64) rows)
POOL_CAP_SHARE = 0.6
SESS_SAMPLING = (0.8, 40)
# a divergence from the reference run is allowed only at a near-tie of the
# reference at the first diverging position: its top-two probabilities
# within NEAR_TIE of each other, relative (one bf16 ulp, 2^-8); sampling,
# the top-two pick scores within the same gap (log-probabilities over the
# temperature, plus the draw's Gumbel noise). decode_chunk accumulates its
# attention in f32 where the dense step scores in bf16, as in the JAX
# package, and its tokens were measured two bf16 ulps of a logit off the
# dense decode's (a logit in [2, 4) has the ulp 2^-6): it is held to the
# dense decode by CHUNK_TIE, 2^-4 relative, four such ulps
NEAR_TIE, CHUNK_TIE = 2.0 ** -8, 2.0 ** -4
# beam search: width, batch, prompt, new tokens
BEAM_W, BEAM_B, BEAM_PROMPT, BEAM_NEW = 4, 2, 512, 16
DECODE_CHUNK = 256
# the per-row draw: (name, rows, width), the first a sampling step's
# launches in a device-clock profile of the per-row draw and of torch.rand
UNIFORM_DEVICE_ITERS = 500
UNIFORM_ROWS = [("lm_step", SESS_SLOTS, 8192), ("one_row", 1, 8192),
                ("ragged_width", 5, 4001), ("many_rows", 300, 12)]
# task = generate from the command line: ragged prompt lines, new tokens
CLI_GEN_LENS, CLI_GEN_NEW = (300, 517, 256, 400), 32
# the serving frontend (slice 13): the session phase's 24 requests through
# api.Net.serve's continuous batching (buckets 1, 2, 4, 8) by 8 concurrent
# closed-loop TCP clients; a flood of 32 at once against a queue of 4; a
# drain with requests in flight (budget in ms); task = serve from the
# command line on 8 prompts and a DEADLINE prompt, then over TCP with
# buckets 1, 4
FE_CLIENTS, FE_BUCKETS, FE_WINDOW_MS = 8, (1, 2, 4, 8), 2.0
FE_FLOOD, FE_FLOOD_QUEUE = 32, 4
FE_DRAIN_REQUESTS, FE_DRAIN_MS = 16, 300.0
CLI_SERVE_LENS, CLI_SERVE_NEW = (160, 300, 517, 128, 256, 400, 200, 700,
                                 333), 32
IMG_HW = 224
GNET_BATCH, RESNET_BATCH, VGG_BATCH = 128, 128, 64
# example/ImageNet/GoogLeNet.conf's own batch_size
GNET_CONF_BATCH = 128
BF16_STEPS = 4
# GoogLeNet's LRN inputs at batch 128: after pool1 and after conv2
GNET_LRN_SHAPES = {"gnet_lrn1": (GNET_BATCH, 64, 56, 56),
                   "gnet_lrn2": (GNET_BATCH, 192, 56, 56)}
GNET_LRN_ARGS = dict(nsize=5, alpha=0.0001, beta=0.75, knorm=1.0)
# the flash kernels' bf16 row: the bench.py LM's bf16 training step (the
# forward at the full sequence, the backward at the training shape)
BF16_FLASH_FWD = "lm_full_sequence"
# a bf16 run against the f32 run of the same weights and batch. At a
# reduced size the card's gap (features: largest difference over the
# largest f32 magnitude; gradients: L2 of the difference over L2 of the
# f32 gradients) must be within GAP_FACTOR times the port's CPU path's
# plus GAP_SLACK. At full size the features and the loss must be within
# FULL_GAP: bf16 keeps 8 significant bits, and the bar catches a wrong
# cast or a broken layer, not rounding
GAP_FACTOR, GAP_SLACK = 2.0, 1e-3
FULL_GAP = 0.25
# slice 19: bench.py's MobileNet (bench_mobilenet: batch 256, 224 px,
# MOBILENET_BLOCKS, base 32) and ViT-S/16 (bench_vit: batch 128, 224 px,
# patch 16, dim 384, 6 heads, 12 blocks, FFN x4, AdamW), each in bf16, 1
# warm-up step and MISC_TIMED_STEPS timed ones; the small nets of their
# reduced-size bf16 gap rule
MN_BATCH, VIT_BATCH = 256, 128
VIT_ARGS = dict(n_class=1000, image_hw=224, patch=16, dim=384, nhead=6,
                nlayer=12, ffn_mult=4)
MN_SMALL = dict(batch_size=8, input_hw=32)
VIT_SMALL = dict(n_class=10, image_hw=48, patch=4, dim=64, nhead=2,
                 nlayer=2, batch_size=4)
MISC_TIMED_STEPS = 3
# MobileNet's depthwise layers whose weight gradient (ops.conv2d_weight,
# one batched product over the groups) is held to float64 on the card, in
# fp32 at WGRAD_TOL: (layer, input shape at batch 256, stride); dw0 is
# the largest stride-1 one, dw1 the first stride-2 one
MN_DW_CHECK = [("dw0", (MN_BATCH, 32, 112, 112), 1),
               ("dw1", (MN_BATCH, 64, 112, 112), 2)]
# layers_misc: the card's training step of a small net of every layer
# type of slice 19 against the port's CPU path in fp32, loss, gradients
# and weights after the step within relative 1e-5 of the largest
# magnitude compared (a gradient: of its layer's largest, as
# tests/test_torch_mobilenet.py holds a gradient that is 0 in exact
# arithmetic)
MISC_RTOL = 1e-5
# what names a kernel in a profile where its symbol does not: the flash
# kernels and the ring steps share their bodies (attn_fwd_tc_kernel, ...)
# and differ by the IO policy in the template's arguments
KERNEL_SYMBOLS = {"flash_fwd": "FlashFwdOut", "flash_bwd_dq": "FlashDqOut",
                  "flash_bwd_dkv": "FlashDkvOut",
                  "ring_fwd_step": "RingFwdCarry",
                  "ring_dq_step": "RingDqCarry",
                  "ring_dkv_step": "RingDkvCarry",
                  "uniform_rows": "uniform_rows_kernel"}


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
    back-to-back calls after ``warmup`` calls and one more; a call slower
    than 1/80 s (a plain version) is timed over fewer calls, about a
    quarter second of them and at least 3 (or ``iters``, if fewer)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = max(min(3, iters), min(iters, int(
        0.25 / max(time.perf_counter() - t, 1e-9))))
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


def library(F, x, ref_out, a):
    """Time of F.local_response_norm on x (same size, alpha, beta, k as
    ``a``; the same window as cxxnet's for odd nsize), a yardstick the
    port never calls; None where PyTorch has no such kernel for x's
    dtype."""

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


def library_bwd(F, x, g, ref_dx, a):
    """Time of the backward of F.local_response_norm on x with upstream g
    (autograd.grad over a kept graph; LRN arguments ``a``), a yardstick the
    port never calls; None where PyTorch has no such kernel for x's
    dtype."""
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


def phase_lrn_kernel(lrn, shapes=None, args=None, phase="lrn_kernel",
                     timed=True):
    """The LRN kernel against lrn_ref at the main path's shapes (AlexNet's
    by default), fp32 and bf16 (the f32 norm bitwise), and its no-norm
    form (inference) against its own bound; returns the per-kernel record
    (sums over the fp32 shapes, i.e. one forward's worth of LRN work; the
    bf16 sums under "bf16"). With ``timed`` False the shapes are checked
    only, and the record holds only max_abs_err."""
    import torch.nn.functional as F
    log("phase %s" % phase)
    rec = dict(_new_rec(), no_norm_ms=0.0, no_norm_bound_ms=0.0,
               bf16=_new_rec())
    a = args or LRN_ARGS
    rng = np.random.RandomState(SEED)
    for name, shape in (shapes or LRN_SHAPES).items():
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
            if not timed:
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                del x, out, norm, ref_out, ref_norm
                continue
            kernel_ms = time_ms(lambda: lrn.lrn_fwd_cuda(x, **a))
            plain_ms = time_ms(lambda: lrn.lrn_ref_with_norm(x, **a))
            library_ms = library(F, x, ref_out, a)
            n = x.numel()
            # x in; out, norm out
            nbytes = _lrn_ops.work(n, x.element_size())[1]
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
            nn_bytes = _lrn_ops.work(n, x.element_size(), with_norm=False)[1]
            nn_bound, nn_by, _, _ = _bound(n, nn_bytes, LRN_OPS_PER_ELEM)
            log("  no-norm kernel_ms %.4f bound_ms %.4f (%d bytes) "
                "kernel/bound %.2f; out bitwise the training forward's"
                % (nn_ms, nn_bound, nn_bytes,
                   nn_ms / nn_bound))
            if dtype == torch.float32:
                _add_fp32(rec, kernel_ms, plain_ms, library_ms, bound_ms,
                          bound_by)
                rec["no_norm_ms"] += nn_ms
                rec["no_norm_bound_ms"] += nn_bound
                rec["no_norm_bound_by"] = nn_by
            else:
                _add_fp32(rec["bf16"], kernel_ms, plain_ms, library_ms,
                          bound_ms, bound_by)
                rec["bf16"]["max_abs_err"] = max(rec["bf16"]["max_abs_err"],
                                                 err)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            del x, out, norm, ref_out, ref_norm, out_nn
    torch.cuda.empty_cache()
    return rec


def phase_lrn_bwd_kernel(lrn, shapes=None, args=None,
                         phase="lrn_bwd_kernel", timed=True):
    """The LRN backward kernel against lrn_bwd_ref at the main path's
    shapes (AlexNet's by default), fp32 and bf16, on x, the norm
    lrn_fwd_cuda saves for it and an upstream gradient g; returns the
    per-kernel record (sums over the fp32 shapes, i.e. one backward's
    worth of LRN work; the bf16 sums under "bf16"). With ``timed`` False
    the shapes are checked only, and the record holds only
    max_abs_err."""
    import torch.nn.functional as F
    log("phase %s" % phase)
    rec = dict(_new_rec(), bf16=_new_rec())
    a = args or LRN_ARGS
    b = dict(nsize=a["nsize"], alpha=a["alpha"], beta=a["beta"])
    rng = np.random.RandomState(SEED + 3)
    for name, shape in (shapes or LRN_SHAPES).items():
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
            if not timed:
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                del x, g, norm, dx, ref
                continue
            kernel_ms = time_ms(lambda: lrn.lrn_bwd_cuda(x, norm, g, **b))
            plain_ms = time_ms(lambda: lrn.lrn_bwd_ref(x, norm, g, **b))
            library_ms = library_bwd(F, x, g, ref, a)
            n = x.numel()
            # x, g and the f32 norm in; dx out
            nbytes = _lrn_ops.bwd_work(n, x.element_size())[1]
            bound_ms, bound_by, _, ops_ms = _bound(n, nbytes,
                                                   LRN_BWD_OPS_PER_ELEM)
            log("  kernel_ms %.4f plain_ms %.4f library_ms %s bound_ms "
                "%.4f (%d bytes; ops bound %.4f ms) kernel/bound %.2f"
                % (kernel_ms, plain_ms, library_ms, bound_ms, nbytes, ops_ms,
                   kernel_ms / bound_ms))
            if dtype == torch.float32:
                _add_fp32(rec, kernel_ms, plain_ms, library_ms, bound_ms,
                          bound_by)
            else:
                _add_fp32(rec["bf16"], kernel_ms, plain_ms, library_ms,
                          bound_ms, bound_by)
                rec["bf16"]["max_abs_err"] = max(rec["bf16"]["max_abs_err"],
                                                 err)
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
    launch, fp32). Of the default shapes the LM's two are timed, the edge
    shapes checked only. Every fp32 time lands in KERNEL_MS. The fp32 bound is
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
            if len(shapes) > 1 and name not in (shapes[0][0],
                                                BF16_FLASH_FWD):
                # an edge shape: checked, not timed (a cut of depth)
                if dtype == torch.float32:
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                del q, k, v, out, lse
                continue
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
            if name == BF16_FLASH_FWD and dtype == torch.bfloat16:
                rec["bf16"] = dict(_new_rec(), max_abs_err=err, at=name)
                _add_fp32(rec["bf16"], kernel_ms, plain_ms, library_ms,
                          bound_ms, bound_by)
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


def time_generate(net, prompts, lens, n_new, reps=2):
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
            "%s ms; decode %s tokens/s (best of 2 each, two turns)"
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
    profile_forward(lambda: net.generate(prompts, LM_NEW), iters=1,
                    unit="request", shares=("flash_fwd",))
    profile_forward(lambda: net.predict_device(full), unit="forward",
                    shares=("flash_fwd",))
    del net
    torch.cuda.empty_cache()
    return launches


def phase_uniform_rows_kernel(rnd):
    """The uniform kernel's per-row entry point (a sampling step's draw)
    against uniform_rows_ref on the card, bitwise, at a session step's
    (8, 8192) and at ragged seeds (one above 2^63), positions, row ids and
    widths; timed at (8, 8192) against its bound, the plain version and
    torch.rand of the same shape. Returns the record of (8, 8192)."""
    log("phase uniform_rows_kernel")
    rec = _new_rec()
    rng = np.random.RandomState(SEED + 12)
    for name, rows, n in UNIFORM_ROWS:
        seeds = torch.tensor([rnd.seed_word(int(v)) for v in rng.randint(
            0, 1 << 62, rows, dtype=np.int64)], dtype=torch.int64)
        seeds[0] = rnd.seed_word((1 << 64) - 3)
        pos = torch.from_numpy(rng.randint(0, LM_SEQ, rows).astype(np.int64))
        rowid = torch.from_numpy(rng.randint(0, 4, rows).astype(np.int64))
        seeds, pos, rowid = seeds.to(DEV), pos.to(DEV), rowid.to(DEV)
        got = rnd.uniform_rows_cuda(seeds, pos, rowid, n)
        torch.cuda.synchronize()
        same = torch.equal(got, rnd.uniform_rows_ref(seeds, pos, rowid, n))
        log(" %s (%d, %d): kernel vs uniform_rows_ref bitwise %s"
            % (name, rows, n, "equal" if same else "DIFFERENT"))
        if not same:
            raise AssertionError("uniform_rows kernel differs from its "
                                 "plain version")
        if name != UNIFORM_ROWS[0][0]:
            continue
        u = got.double()
        log("  range [%.9f, %.9f], mean %.6f (1/2)" % (
            float(u.min()), float(u.max()), float(u.mean())))
        kernel_ms = time_ms(lambda: rnd.uniform_rows_cuda(seeds, pos, rowid,
                                                          n), iters=200)
        plain_ms = time_ms(lambda: rnd.uniform_rows_ref(seeds, pos, rowid,
                                                        n), iters=20)
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        library_ms = time_ms(lambda: torch.rand((rows, n), generator=gen,
                                                device=DEV), iters=200)
        # the device's own clock: the kernels' self time in a profile of
        # many back-to-back launches, which a launch's host overhead and
        # the events' resolution do not reach
        kernel_dev = device_ms(lambda: rnd.uniform_rows_cuda(
            seeds, pos, rowid, n), UNIFORM_DEVICE_ITERS)
        library_dev = device_ms(lambda: torch.rand(
            (rows, n), generator=gen, device=DEV), UNIFORM_DEVICE_ITERS)
        log("  on the device clock (profiler self time over %d launches): "
            "kernel %.6f ms, torch.rand %.6f ms a call (kernel/torch.rand "
            "%.3f)" % (UNIFORM_DEVICE_ITERS, kernel_dev, library_dev,
                       kernel_dev / library_dev))
        nbytes = _random_ops.rows_work(rows, n)[1]
        bound_ms, bound_by, bytes_ms, ops_ms = _bound(
            rows * n, nbytes, UNIFORM_OPS_PER_ELEM)
        log("  kernel_ms %.4f plain_ms %.4f library_ms %.4f (torch.rand of "
            "the shape) bound_ms %.6f (%s: %d bytes, %.6f ms; %d operations, "
            "%.6f ms) kernel/bound %.1f: a launch, not the stores, bounds "
            "a draw this small"
            % (kernel_ms, plain_ms, library_ms, bound_ms, bound_by, nbytes,
               bytes_ms, rows * n * UNIFORM_OPS_PER_ELEM, ops_ms,
               kernel_ms / bound_ms))
        rec.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   device_ms=kernel_dev, library_device_ms=library_dev)
    return rec


def device_ms(fn, iters: int) -> float:
    """The device time of one fn() call: the self device time of every
    kernel in a torch.profiler trace of ``iters`` back-to-back calls
    (after one unprofiled warm-up), over ``iters``; a trace with no device
    time fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(device_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profile recorded no device time")
    return us / 1e3 / iters


def serve_requests(rng, vocab):
    """The session phase's 24 prompts: every other one behind the shared
    system prompt; returns (prompts, shares the prefix)."""
    prefix = rng.randint(0, vocab, SESS_PREFIX).tolist()
    prompts, shared = [], []
    for i in range(SESS_REQUESTS):
        if i % 2:
            n = rng.randint(SESS_TAIL[0], SESS_TAIL[1] + 1)
            prompts.append(prefix + rng.randint(0, vocab, n).tolist())
        else:
            n = rng.randint(SESS_PROMPT[0], SESS_PROMPT[1] + 1)
            prompts.append(rng.randint(0, vocab, n).tolist())
        shared.append(bool(i % 2))
    return prompts, shared


def drive_session(sess, prompts, seed0):
    """Serve ``prompts`` through the session: each waiting request is
    admitted as soon as a slot frees, every slot steps, a finished slot
    retires. Returns each request's tokens."""
    got, live, nxt = {}, {}, 0
    while nxt < len(prompts) or live:
        for s in sess.free_slots():
            if nxt == len(prompts):
                break
            tok, done = sess.prefill(s, prompts[nxt], seed0 + nxt)
            live[s] = (nxt, [tok])
            nxt += 1
            if done:
                i, toks = live.pop(s)
                got[i] = toks
                sess.retire(s)
        for s, tok, done in sess.step():
            live[s][1].append(tok)
            if done:
                i, toks = live.pop(s)
                got[i] = toks
                sess.retire(s)
    return [got[i] for i in range(len(prompts))]


def pick_scores(rnd, probs, temperature, top_k, seed, pos, row):
    """The scores a pick takes its argmax of: log-probabilities (greedy),
    or the temperature-scaled, top-k masked log-probabilities plus the
    Gumbel noise of the row's draw (sampling), as the port's sample_pick
    forms them."""
    from cxxnet_tpu_torch.nnet.trainer import topk_mask
    lg = torch.log(probs.float().clamp_min(1e-30))[None]
    if temperature <= 0:
        return lg[0]
    lg = lg / temperature
    if top_k:
        lg = lg.masked_fill(~topk_mask(lg, top_k), float("-inf"))
    one = lambda v: torch.tensor([v], dtype=torch.int64, device=DEV)
    u = rnd.uniform_rows(one(rnd.seed_word(seed)), one(pos), one(row),
                         lg.shape[1])
    return (lg - torch.log(-torch.log(u)))[0]


def ref_probs(net, toks, lens, n_new, where):
    """The reference run's probabilities at ``where`` {(row, position)},
    from its decode loop teacher-forced on its own tokens ``toks`` (b,
    l_max) through the decode's ``on_probs`` hook: the same computation
    as the run that made them, bitwise."""
    b = toks.shape[0]
    plen, total = int(min(lens)), int(max(lens)) + n_new
    out = {}

    def record(t0, probs):
        for (r, t) in where:
            if t0 <= t < t0 + probs.shape[2]:
                out[(r, t)] = probs[r, :, t - t0].clone()
    net.net_.decode(torch.from_numpy(toks).to(DEV),
                    torch.full((b,), total, dtype=torch.int32, device=DEV),
                    plen, total, on_probs=record)
    return out


def hold_tokens(what, rnd, net, got, ref, prompts, sampling, seeds, rows,
                tie, batched=False):
    """Hold each request's tokens ``got`` to the reference run's ``ref``
    token for token; a request may diverge only where the reference's
    top-two pick scores at the first diverging position are within ``tie``
    of each other as probabilities, relative (log-gap -log(1 - tie), over
    the temperature when sampling); its later tokens are not compared.
    ``batched``: the reference ran all requests as one batch (uniform
    prompts); else each alone. Returns the number of near-tie
    divergences; raises on any other."""
    temperature, top_k = sampling
    l_max = net.net_.net_cfg.param.input_shape[2]
    firsts = []
    for i, (g, w) in enumerate(zip(got, ref)):
        diff = [j for j in range(len(w)) if g[j] != w[j]]
        if diff:
            firsts.append((i, diff[0]))

    def forced(i):          # prompt i followed by its reference tokens
        toks = np.zeros((1, l_max), np.int64)
        toks[0, :len(prompts[i])] = prompts[i]
        toks[0, len(prompts[i]):len(prompts[i]) + len(ref[i])] = ref[i]
        return toks
    if firsts and batched:
        probs = ref_probs(net, np.concatenate([forced(i) for i in
                                               range(len(prompts))]),
                          [len(p) for p in prompts], len(ref[0]),
                          [(i, len(prompts[i]) - 1 + j) for i, j in firsts])
    bar = -np.log1p(-tie) / (temperature or 1.0)
    for i, j in firsts:
        pos = len(prompts[i]) - 1 + j
        p = probs[(i, pos)] if batched else ref_probs(
            net, forced(i), [len(prompts[i])], len(ref[i]),
            [(0, pos)])[(0, pos)]
        top2 = pick_scores(rnd, p, temperature, top_k, seeds[i], pos,
                           rows[i]).topk(2)
        gap = float(top2.values[0] - top2.values[1])
        log("  %s: request %d diverges at new token %d (position %d): the "
            "reference's top-two pick scores %.3e apart (probabilities "
            "%.6g, %.6g), %s (bar %.3e)"
            % (what, i, j, pos, gap, *(float(p[k]) for k in top2.indices),
               "a near-tie" if gap <= bar else "NOT a near-tie", bar))
        if gap > bar:
            raise AssertionError("%s: request %d diverges where the "
                                 "reference has no near-tie" % (what, i))
    equal = sum(1 for g, w in zip(got, ref) if g == w)
    log("  %s: %d of %d requests token for token equal, %d diverge at a "
        "near-tie of the reference" % (what, equal, len(got), len(firsts)))
    return len(firsts)


def run_solo(net, prompts, n_new, sampling, seed0):
    temperature, top_k = sampling
    return [list(net.generate(np.asarray([p]), n_new,
                              temperature=temperature, top_k=top_k,
                              seed=seed0 + i)[0])
            for i, p in enumerate(prompts)]


def phase_lm_serve_session(flash, rnd, api, models):
    """The serving engine on the bench.py LM in bf16 through
    api.Net(dev="gpu"): 24 requests through a dense session of 8 slots
    (each waiting request admitted as a slot frees), greedy and sampled,
    each request held to its solo generate; the same requests through a
    paged session (block 16, half of them reusing a 512-token system
    prompt) held token for token to the dense one; beam search (beam 4 at
    b 2; beam 1 against greedy generate); generate under decode_chunk
    against the dense decode. Prints the session's and solo generate's
    tokens/s and busy shares. With the performance ledger on, the greedy
    requests once more through a paged pool capped by the ledger's HBM
    headroom (``bytes_cap = decode_pool_cap_bytes(frac)``, frac chosen so
    that the cap binds below the dense-equivalent pool), held to their
    solo generate. Returns (uniform_rows launches, flash_fwd launches) of
    the sessions' run, the main path."""
    from cxxnet_tpu_torch.utils import perf
    log("phase lm_serve_session (bench.py LM, bf16, %d requests, %d slots, "
        "%d new tokens)" % (SESS_REQUESTS, SESS_SLOTS, SESS_NEW))
    t_phase = time.perf_counter()
    perf.reset()
    perf.enable()
    try:
        return _lm_serve_session(flash, rnd, api, models, perf, t_phase)
    finally:
        perf.disable()
        perf.reset()


def capped_pool_run(perf, net, tr, prompts, dense, solo, block_bytes, rnd,
                    seeds, rows0):
    """The greedy requests through a paged pool capped by the ledger: the
    pool holds at most the cap (floored at one sequence), below the dense
    equivalent, and every request equals its solo generate."""
    lg = perf.ledger()
    T = LM_SEQ // SESS_BLOCK
    dense_bytes = (SESS_SLOTS * T + 1) * block_bytes
    room = lg.decode_pool_cap_bytes(1.0)
    frac = POOL_CAP_SHARE * dense_bytes / room
    cap = lg.decode_pool_cap_bytes(frac)
    pool = tr.decode_kv_pool(SESS_BLOCK, pool_tokens=SESS_SLOTS * LM_SEQ,
                             bytes_cap=cap)
    usable, nbytes = pool.alloc.usable, pool.nbytes
    psess = tr.decode_session(SESS_SLOTS, SESS_NEW, kv_pool=pool)
    got = drive_session(psess, prompts, 100)
    psess.close()
    tr.release_kv_pool()
    snap = lg.snapshot()
    log("  capped paged pool: HBM headroom %d bytes (%s capacity %d, peak "
        "program footprint %d), frac %.6f -> cap %d bytes; the pool %d "
        "bytes, %d usable blocks of %d against the dense-equivalent %d "
        "(%d bytes); floor one sequence, %d blocks"
        % (room, snap["spec"]["name"], snap["spec"]["hbm_capacity"],
           snap["hbm"]["peak_bytes"] or 0, frac, cap, nbytes, usable,
           SESS_BLOCK, SESS_SLOTS * T, dense_bytes, T))
    if nbytes > max(cap, (T + 1) * block_bytes) \
            or usable >= SESS_SLOTS * T:
        raise AssertionError("the capped pool holds more than its cap, or "
                             "the cap did not bind below dense-equivalent")
    hold_tokens("capped paged session vs solo (greedy)", rnd, net, got,
                solo, prompts, (0.0, 0), seeds, rows0, NEAR_TIE)
    same = got == dense
    log("  capped paged session vs the dense one (greedy): token for token "
        "%s" % ("EQUAL" if same else "DIFFERENT"))
    if not same:
        raise AssertionError("the capped paged session differs from the "
                             "dense one")
    for c in snap["cards"]:
        if c["name"] in ("jit.decode_prefill", "jit.decode_step",
                         "jit.decode_admit") and c["status"] != "ready":
            raise AssertionError("card not ready: %s" % c)
    log("  ledger cards of the phase: %d (%s), all decode cards ready"
        % (len(snap["cards"]), ", ".join(sorted(
            {c["name"] for c in snap["cards"]}))))


def _lm_serve_session(flash, rnd, api, models, perf, t_phase):
    vocab, nlayer = LM_ARGS["vocab"], LM_ARGS["nlayer"]
    net = api.Net(dev=NET_DEV, cfg=bf16_cfg(lm_cfg(models, LM_SEQ,
                                                   LM_BATCH)))
    net.init_model()
    tr = net.net_
    rng = np.random.RandomState(SEED + 14)
    prompts, shared = serve_requests(rng, vocab)
    log("  prompts %d-%d tokens (%d in all), %d behind the %d-token system "
        "prompt" % (min(map(len, prompts)), max(map(len, prompts)),
                    sum(map(len, prompts)), sum(shared), SESS_PREFIX))
    modes = (("greedy", (0.0, 0)), ("sampled", SESS_SAMPLING))
    seeds = [100 + i for i in range(SESS_REQUESTS)]
    rows0 = [0] * SESS_REQUESTS
    n_tok = SESS_REQUESTS * SESS_NEW

    # warm-up before any timing: the libraries' kernels' first uses, the
    # decode nets of every prompt length, which solo generate and the
    # sessions' prefills share, and every program the timed dense
    # sessions call (each prompt length's prefill in both modes): the
    # ledger is on, so a program's first call waits for the card and
    # cards itself, which is a replica's warm-up work, not its rate
    run_solo(net, prompts, 2, SESS_SAMPLING, 100)
    for _, sampling in modes:
        wsess = tr.decode_session(SESS_SLOTS, 2, temperature=sampling[0],
                                  top_k=sampling[1])
        drive_session(wsess, prompts, 100)
        wsess.close()
    solo, solo_s = {}, {}
    for mode, sampling in modes:
        torch.cuda.synchronize()
        t = time.perf_counter()
        solo[mode] = run_solo(net, prompts, SESS_NEW, sampling, 100)
        solo_s[mode] = time.perf_counter() - t

    # the main path: the counts start at 0 here and are read right after
    rnd.rows_launches = 0
    flash.launches = 0
    dense, dense_s, paged, books = {}, {}, {}, {}
    for mode, sampling in modes:
        sess = tr.decode_session(SESS_SLOTS, SESS_NEW,
                                 temperature=sampling[0], top_k=sampling[1])
        t = time.perf_counter()
        dense[mode] = drive_session(sess, prompts, 100)
        dense_s[mode] = time.perf_counter() - t
        acct = sess.kv_account()
        sess.close()
        # a fresh pool for each mode: only the system prompt is shared
        pool = tr.decode_kv_pool(SESS_BLOCK,
                                 pool_tokens=SESS_SLOTS * LM_SEQ)
        psess = tr.decode_session(SESS_SLOTS, SESS_NEW,
                                  temperature=sampling[0],
                                  top_k=sampling[1], kv_pool=pool)
        paged[mode] = drive_session(psess, prompts, 100)
        psess.close()
        books[mode] = (pool.account(), pool.nbytes)
        tr.release_kv_pool()
    torch.cuda.synchronize()
    rows_launches, flash_launches = rnd.rows_launches, flash.launches
    n_adm = 2 * len(modes) * SESS_REQUESTS
    log("  solo runs and the 4 session runs done %.1f s into the phase"
        % (time.perf_counter() - t_phase))
    log("  launches over the 4 session runs: uniform_rows %d (the sampled "
        "runs' steps and admissions), flash_fwd %d (%d per admission; %d "
        "admissions)" % (rows_launches, flash_launches,
                         flash_launches // n_adm, n_adm))
    if rows_launches == 0 or flash_launches == 0:
        raise AssertionError("the session path did not launch the "
                             "uniform_rows or the flash_fwd kernel")
    log("  dense session KV: %d bytes allocated (%d slots x %d rows)"
        % (acct["kv_bytes"], SESS_SLOTS, LM_SEQ))

    for mode, sampling in modes:
        for what, got in (("dense session vs solo", dense[mode]),):
            for toks in got:
                if len(toks) != SESS_NEW or min(toks) < 0 \
                        or max(toks) >= vocab:
                    raise AssertionError("%s: bad tokens" % what)
            hold_tokens("%s (%s)" % (what, mode), rnd, net, got, solo[mode],
                        prompts, sampling, seeds, rows0, NEAR_TIE)
        same = paged[mode] == dense[mode]
        log("  paged session vs dense (%s): token for token %s (%d "
            "requests)" % (mode, "EQUAL" if same else "DIFFERENT",
                           SESS_REQUESTS))
        if not same:
            bad = [i for i in range(SESS_REQUESTS)
                   if paged[mode][i] != dense[mode][i]]
            log("  requests that differ: %s (behind the system prompt: %s)"
                % (bad, [shared[i] for i in bad]))
            raise AssertionError("the paged session differs from the "
                                 "dense one")
        rate_s = n_tok / dense_s[mode]
        rate_1 = n_tok / solo_s[mode]
        log("  %s: session %.1f tokens/s (%.2f s for %d tokens), solo "
            "generate %.1f tokens/s (%.2f s); session / solo %.2f"
            % (mode, rate_s, dense_s[mode], n_tok, rate_1, solo_s[mode],
               rate_s / rate_1))
    capped_pool_run(perf, net, tr, prompts, dense["greedy"], solo["greedy"],
                    books["greedy"][0]["block_bytes"], rnd, seeds, rows0)
    for mode, (a, nbytes) in books.items():
        hit = a["prefix_hit_tokens"] / max(1, a["prompt_tokens"])
        log("  paged pool (%s): %d blocks of %d rows, pool_bytes %d (%.1f "
            "MB, the tensors' nbytes), prefix hits %d of %d admissions, hit "
            "rate %.3f of prompt tokens (%d of %d not prefilled again), "
            "copy-on-write %d" % (mode, a["blocks_total"], SESS_BLOCK,
                                  a["pool_bytes"], a["pool_bytes"] / 1e6,
                                  a["prefix_hits"], a["prefix_queries"],
                                  hit, a["prefix_hit_tokens"],
                                  a["prompt_tokens"], a["cow_copies"]))
        if a["prefix_hits"] == 0 or a["pool_bytes"] != nbytes:
            raise AssertionError("no prefix reuse, or the pool account is "
                                 "off")

    log("  checks done %.1f s into the phase" % (time.perf_counter() - t_phase))
    # busy share of the session's and of solo generate's device time
    sub = prompts[:SESS_SLOTS]
    log(" profile: a dense greedy session over %d requests" % len(sub))
    profile_forward(lambda: drive_session(tr.decode_session(
        SESS_SLOTS, SESS_NEW), sub, 100), iters=1, warmup=False,
        unit="session run", shares=("flash_fwd",))
    # (one profile: solo generate's busy share is lm_serve's request
    # profile, and the per-row draw's time is uniform_rows_kernel's; the
    # profiler's own processing of a run's many small launches took most
    # of this phase's time)

    log("  profiles done %.1f s into the phase"
        % (time.perf_counter() - t_phase))
    # beam search
    bp = rng.randint(0, vocab, (BEAM_B, BEAM_PROMPT))
    b4 = net.beam_generate(bp, BEAM_NEW, beam=BEAM_W)
    again = net.beam_generate(bp, BEAM_NEW, beam=BEAM_W)
    if b4.shape != (BEAM_B, BEAM_NEW) or b4.min() < 0 or b4.max() >= vocab \
            or not np.array_equal(b4, again):
        raise AssertionError("beam search: shape %s, or not repeatable"
                             % (b4.shape,))
    b1 = net.beam_generate(bp, BEAM_NEW, beam=1)
    greedy = net.generate(bp, BEAM_NEW)
    log("  beam %d at b %d (prompt %d, %d new): repeatable; beam 1 vs greedy "
        "generate: %s; beam %d equals greedy in %d of %d tokens"
        % (BEAM_W, BEAM_B, BEAM_PROMPT, BEAM_NEW,
           "EQUAL" if np.array_equal(b1, greedy) else "DIFFERENT", BEAM_W,
           int((b4 == greedy).sum()), greedy.size))
    if not np.array_equal(b1, greedy):
        raise AssertionError("beam 1 differs from greedy generate")

    # generate under decode_chunk against the dense decode
    cnet = api.Net(dev=NET_DEV, cfg=bf16_cfg(lm_cfg(
        models, LM_SEQ, LM_BATCH, attn_extra="decode_chunk = %d\n"
        % DECODE_CHUNK)))
    cnet.init_model()
    cnet.net_.params = tr.params
    cp = rng.randint(0, vocab, (LM_BATCH, LM_PROMPT))
    want = net.generate(cp, LM_NEW)
    t = time.perf_counter()
    got = cnet.generate(cp, LM_NEW)
    t_chunk = time.perf_counter() - t
    t = time.perf_counter()
    net.generate(cp, LM_NEW)
    t_dense = time.perf_counter() - t
    hold_tokens("decode_chunk %d vs the dense decode" % DECODE_CHUNK, rnd,
                net, [list(r) for r in got], [list(r) for r in want],
                [list(r) for r in cp], (0.0, 0), [0] * LM_BATCH,
                list(range(LM_BATCH)), CHUNK_TIE, batched=True)
    log("  generate b %d, prompt %d, %d new: decode_chunk %.1f ms, dense "
        "%.1f ms (one call each)" % (LM_BATCH, LM_PROMPT, LM_NEW,
                                     t_chunk * 1e3, t_dense * 1e3))
    del net, cnet, tr
    torch.cuda.empty_cache()
    log("  phase wall %.1f s" % (time.perf_counter() - t_phase))
    return rows_launches, flash_launches


def phase_cli_lm_generate(learn_task, api, models):
    """task = generate from the command line: a model file of the bench.py
    LM in bf16 written here, ragged prompt lines, gen_out held to
    api.Net.generate of the same model and prompts, token for token."""
    log("phase cli_lm_generate")
    vocab = LM_ARGS["vocab"]
    cfg = bf16_cfg(lm_cfg(models, LM_SEQ, LM_BATCH))
    rng = np.random.RandomState(SEED + 15)
    lines = [rng.randint(0, vocab, n).tolist() for n in CLI_GEN_LENS]
    with scratch_dir("cli_lm_generate") as d:
        net = api.Net(dev=NET_DEV, cfg=cfg)
        net.init_model()
        model = os.path.join(d, "lm.model")
        net.save_model(model)
        with open(os.path.join(d, "prompts.txt"), "w") as f:
            for r in lines:
                f.write(" ".join(map(str, r)) + "\n")
        with open(os.path.join(d, "gen.conf"), "w") as f:
            f.write(cfg + "task = generate\nmodel_in = lm.model\n"
                    "prompt_in = prompts.txt\ngen_out = gen.txt\n"
                    "gen_new = %d\n" % CLI_GEN_NEW)
        out, _ = run_cli(learn_task, d, [os.path.join(d, "gen.conf")],
                         echo=("generated",))
        with open(os.path.join(d, "gen.txt")) as f:
            got = np.asarray([[int(t) for t in ln.split()] for ln in f])
        ref = api.Net(dev=NET_DEV, cfg=cfg)
        ref.load_model(model)
        prompts = np.zeros((len(lines), max(CLI_GEN_LENS)), np.int64)
        for i, r in enumerate(lines):
            prompts[i, :len(r)] = r
        want = ref.generate(prompts, CLI_GEN_NEW,
                            prompt_lens=list(CLI_GEN_LENS))
        same = got.shape == want.shape and np.array_equal(got, want)
        log("  gen_out (%d ragged prompts of %s tokens, %d new) vs "
            "api.Net.generate of the same model file: %s"
            % (len(lines), list(CLI_GEN_LENS), CLI_GEN_NEW,
               "EQUAL" if same else "DIFFERENT"))
        if not same:
            raise AssertionError("task = generate differs from "
                                 "api.Net.generate")
        del net, ref
    torch.cuda.empty_cache()


def serve_clients(port, lines, nclients, timeout=600.0, lat=None):
    """``lines`` dealt round-robin to ``nclients`` closed-loop TCP clients
    of the frontend on ``port``, one connection each, each line sent once
    the client's previous answer is in. Returns (answers aligned with
    ``lines``, None where none came; the wall seconds). ``lat``, a list as
    long as ``lines``, gets each request's seconds from send to answer."""
    out = [None] * len(lines)
    errors = []

    def client(c):
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=timeout) as conn:
                f = conn.makefile("r", encoding="utf-8")
                for i in range(c, len(lines), nclients):
                    t = time.perf_counter()
                    conn.sendall((lines[i] + "\n").encode("utf-8"))
                    out[i] = f.readline().rstrip("\n") or None
                    if lat is not None:
                        lat[i] = time.perf_counter() - t
        except OSError as e:
            errors.append(repr(e))
    ts = [threading.Thread(target=client, args=(c,))
          for c in range(nclients)]
    t = time.perf_counter()
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    wall = time.perf_counter() - t
    if errors:
        log("  client errors: %s" % errors[:3])
    return out, wall


def reconciled(what, stats):
    """The frontend's books: accepted == served + errors + shed +
    deadline."""
    ok = stats["accepted"] == (stats["served"] + stats["errors"]
                               + stats["shed"] + stats["deadline"])
    log("  %s books: accepted %d = served %d + errors %d + shed %d + "
        "deadline %d: %s" % (what, stats["accepted"], stats["served"],
                             stats["errors"], stats["shed"],
                             stats["deadline"],
                             "reconciled" if ok else "NOT RECONCILED"))
    if not ok:
        raise AssertionError("%s: the serving books do not reconcile"
                             % what)


def answer_tokens(what, line, n_new, vocab):
    toks = [int(t) for t in (line or "").split()] \
        if line and not line.startswith(("ERR", "OK")) else None
    if toks is None or len(toks) != n_new or min(toks) < 0 \
            or max(toks) >= vocab:
        raise AssertionError("%s: bad answer %r" % (what, (line or "")[:80]))
    return toks


def pct(vals, p):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(p / 100.0 * (len(vals) - 1))))]


def phase_lm_serve_frontend(flash, rnd, api, models):
    """The serving frontend (utils/servd.py) on the bench.py LM in bf16 at
    full width through api.Net(dev="gpu").serve: the session phase's 24
    requests (seed 14, 64 new tokens) by 8 concurrent TCP clients into
    continuous batching over buckets 1, 2, 4, 8, dense greedy, paged greedy
    (block 16, a fresh pool) and dense sampled at (0.8, 40); each answer
    held to its solo generate (greedy) or to the solo generate at seed 100
    + seq, seq the request's dispatch ordinal from its flight record
    (sampled), up to the near-tie rule; the books reconciled. Prints the
    frontend's tokens/s beside the bare decode_session's on the same
    requests, TTFT and queue_wait p50 / p99 from the flight records, the
    mean batch occupancy and the busy share of a profiled run; then a flood
    of 32 at once against a queue of 4 (at least one ERR busy queue, one
    answer each) and a drain with requests in flight (one line each).
    Returns (uniform_rows launches, flash_fwd launches) of the three
    served runs, the main path."""
    log("phase lm_serve_frontend (bench.py LM, bf16, %d requests, %d TCP "
        "clients, buckets %s, %d new tokens)"
        % (SESS_REQUESTS, FE_CLIENTS, FE_BUCKETS, SESS_NEW))
    t_phase = time.perf_counter()
    vocab, nlayer = LM_ARGS["vocab"], LM_ARGS["nlayer"]
    net = api.Net(dev=NET_DEV, cfg=bf16_cfg(lm_cfg(models, LM_SEQ,
                                                   LM_BATCH)))
    net.init_model()
    tr = net.net_
    prompts, _ = serve_requests(np.random.RandomState(SEED + 14), vocab)
    lines = ["TRACE r%d %s" % (i, " ".join(map(str, p)))
             for i, p in enumerate(prompts)]
    n_tok = SESS_REQUESTS * SESS_NEW
    opts = dict(port=0, n_new=SESS_NEW, seed=100, buckets=FE_BUCKETS,
                batch_max=max(FE_BUCKETS), batch_window_ms=FE_WINDOW_MS,
                drain_ms=60000.0)

    # warm-up before any timing: the decode nets of every prompt length
    # and of every bucket's step
    run_solo(net, prompts, 2, SESS_SAMPLING, 100)
    for b in FE_BUCKETS:
        drive_session(tr.decode_session(b, 2), prompts[:b], 100)
    bare = {}
    for what, kv_block in (("dense", 0), ("paged", SESS_BLOCK)):
        pool = tr.decode_kv_pool(SESS_BLOCK, pool_tokens=max(
            FE_BUCKETS) * LM_SEQ) if kv_block else None
        sess = tr.decode_session(SESS_SLOTS, SESS_NEW, kv_pool=pool)
        steps = [0]
        step = sess.step

        def counted(step=step, steps=steps):
            steps[0] += 1
            return step()
        sess.step = counted
        torch.cuda.synchronize()
        t = time.perf_counter()
        drive_session(sess, prompts, 100)
        torch.cuda.synchronize()
        bare[what] = (time.perf_counter() - t, steps[0])
        sess.close()
        tr.release_kv_pool()
    solo = run_solo(net, prompts, SESS_NEW, (0.0, 0), 100)

    def serve(what, temperature=0.0, top_k=0, kv_block=0):
        fe = net.serve(temperature=temperature, top_k=top_k,
                       kv_block=kv_block, **opts)
        try:
            answers, wall = serve_clients(fe.port, lines, FE_CLIENTS)
        finally:
            stats = fe.drain()
        reconciled(what, stats)
        got = [answer_tokens("%s request %d" % (what, i), a, SESS_NEW,
                             vocab) for i, a in enumerate(answers)]
        recs = [fe.flight.get("r%d" % i) for i in range(SESS_REQUESTS)]
        if stats["served"] != SESS_REQUESTS or any(
                r is None or r["outcome"] != "served" for r in recs):
            raise AssertionError("%s: not every request was served" % what)
        buckets = sorted({r["bucket"] for r in recs})
        return (got, wall, recs, fe.mean_occupancy(),
                fe.batch_flight.iterations, buckets)

    # the main path: the counts start at 0 here and are read right after
    rnd.rows_launches = 0
    flash.launches = 0
    runs = {}
    runs["dense greedy"] = serve("dense greedy")
    tr.release_kv_pool()
    runs["paged greedy"] = serve("paged greedy", kv_block=SESS_BLOCK)
    pool_acct = tr._kv_pool.account() if tr._kv_pool is not None else None
    tr.release_kv_pool()
    runs["dense sampled"] = serve("dense sampled", *SESS_SAMPLING)
    torch.cuda.synchronize()
    rows_launches, flash_launches = rnd.rows_launches, flash.launches
    n_adm = len(runs) * SESS_REQUESTS
    log("  launches over the 3 served runs: flash_fwd %d (%d per admission "
        "over %d admissions; %d expected), uniform_rows %d (the sampled "
        "run's steps and admissions)"
        % (flash_launches, flash_launches // n_adm, n_adm, nlayer * n_adm,
           rows_launches))
    if flash_launches != nlayer * n_adm or rows_launches == 0:
        raise AssertionError("the frontend's path did not launch flash_fwd "
                             "%d times or uniform_rows at all"
                             % (nlayer * n_adm))
    if pool_acct is not None:
        log("  paged pool after the paged run: %d blocks, prefix hits %d of "
            "%d admissions" % (pool_acct["blocks_total"],
                               pool_acct["prefix_hits"],
                               pool_acct["prefix_queries"]))

    seeds0 = [100 + i for i in range(SESS_REQUESTS)]
    rows0 = [0] * SESS_REQUESTS
    for what in ("dense greedy", "paged greedy"):
        hold_tokens("frontend %s vs solo" % what, rnd, net, runs[what][0],
                    solo, prompts, (0.0, 0), seeds0, rows0, NEAR_TIE)
    got, recs = runs["dense sampled"][0], runs["dense sampled"][2]
    seqs = [r["seq"] for r in recs]
    if sorted(seqs) != list(range(SESS_REQUESTS)):
        raise AssertionError("sampled: dispatch ordinals %s" % seqs)
    ref = [list(net.generate(np.asarray([p]), SESS_NEW,
                             temperature=SESS_SAMPLING[0],
                             top_k=SESS_SAMPLING[1], seed=100 + q)[0])
           for p, q in zip(prompts, seqs)]
    hold_tokens("frontend dense sampled vs solo at seed 100 + seq", rnd,
                net, got, ref, prompts, SESS_SAMPLING,
                [100 + q for q in seqs], rows0, NEAR_TIE)

    for what, (bare_s, steps) in bare.items():
        log("  bare %s decode_session(%d, %d) over the 24 requests (each "
            "admitted as a slot frees): %.1f tokens/s (%.3f s, %d steps, "
            "%.3f ms a step)" % (what, SESS_SLOTS, SESS_NEW, n_tok / bare_s,
                                 bare_s, steps, 1e3 * bare_s / steps))
    for what, (got, wall, recs, occ, iters, buckets) in runs.items():
        bare_s, steps = bare["paged" if what.startswith("paged")
                             else "dense"]
        ttft = [r["ttft_s"] * 1e3 for r in recs]
        qw = [r["phases"]["queue_wait"] * 1e3 for r in recs]
        log("  frontend %s: %.1f tokens/s (%.3f s for %d tokens; frontend / "
            "bare session %.3f); TTFT p50 %.2f ms p99 %.2f ms; queue_wait "
            "p50 %.2f ms p99 %.2f ms; mean batch occupancy %.3f over %d "
            "iterations (%.3f ms an iteration against the bare session's "
            "%.3f a step); buckets used %s"
            % (what, n_tok / wall, wall, n_tok, bare_s / wall,
               pct(ttft, 50), pct(ttft, 99), pct(qw, 50), pct(qw, 99),
               occ or 0.0, iters, 1e3 * wall / iters, 1e3 * bare_s / steps,
               buckets))

    log(" profile: the frontend serving %d of the requests (dense greedy)"
        % FE_CLIENTS)
    fe = net.serve(**opts)
    try:
        profile_forward(lambda: serve_clients(fe.port, lines[:FE_CLIENTS],
                                              FE_CLIENTS),
                        iters=1, warmup=False, unit="frontend run",
                        shares=("flash_fwd",))
    finally:
        reconciled("profiled run", fe.drain())

    # flood: 32 at once, one connection each, against a queue of 4
    flood = [lines[i % SESS_REQUESTS].replace("TRACE r", "TRACE f%d-r" % i,
                                              1) for i in range(FE_FLOOD)]
    fe = net.serve(queue_size=FE_FLOOD_QUEUE, **opts)
    try:
        answers, wall = serve_clients(fe.port, flood, FE_FLOOD)
    finally:
        stats = fe.drain()
    reconciled("flood", stats)
    busy = sum(1 for a in answers if a and a.startswith("ERR busy queue"))
    served = [i for i, a in enumerate(answers)
              if a and not a.startswith("ERR")]
    log("  flood of %d at once, queue %d: %d served, %d ERR busy queue, %d "
        "other, %d unanswered (%.2f s)"
        % (FE_FLOOD, FE_FLOOD_QUEUE, len(served), busy,
           FE_FLOOD - len(served) - busy,
           sum(1 for a in answers if a is None), wall))
    if busy == 0 or any(a is None for a in answers) \
            or stats["accepted"] != FE_FLOOD \
            or stats["served"] != len(served):
        raise AssertionError("flood: every request must be answered once "
                             "and at least one shed ERR busy queue")
    hold_tokens("flood's served answers vs solo", rnd, net,
                [answer_tokens("flood", answers[i], SESS_NEW, vocab)
                 for i in served], [solo[i % SESS_REQUESTS] for i in served],
                [prompts[i % SESS_REQUESTS] for i in served], (0.0, 0),
                [0] * len(served), [0] * len(served), NEAR_TIE)

    # drain with requests in flight
    dr = [lines[i].replace("TRACE r", "TRACE d", 1)
          for i in range(FE_DRAIN_REQUESTS)]
    fe = net.serve(**dict(opts, drain_ms=FE_DRAIN_MS))
    out = {}
    ts = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, serve_clients(fe.port, [dr[i]], 1, timeout=120)[0][0]))
        for i in range(FE_DRAIN_REQUESTS)]
    for th in ts:
        th.start()
    t = time.perf_counter() + 60
    while (fe.stats()["accepted"] < FE_DRAIN_REQUESTS
           or fe.stats()["served"] < 1) and time.perf_counter() < t:
        time.sleep(0.001)
    before = fe.stats()
    stats = fe.drain()
    for th in ts:
        th.join()
    reconciled("drain", stats)
    answers = [out.get(i) for i in range(FE_DRAIN_REQUESTS)]
    errs = [a for a in answers if a and a.startswith("ERR draining")]
    log("  drain (budget %.0f ms) with %d accepted, %d served before it: "
        "%d served, %d ERR draining (%s), %d unanswered"
        % (FE_DRAIN_MS, before["accepted"], before["served"],
           stats["served"], len(errs),
           sorted({" ".join(e.split()[:3]) for e in errs}),
           sum(1 for a in answers if a is None)))
    if before["accepted"] != FE_DRAIN_REQUESTS or any(
            a is None for a in answers) \
            or stats["accepted"] != FE_DRAIN_REQUESTS \
            or stats["served"] + len(errs) != FE_DRAIN_REQUESTS:
        raise AssertionError("drain: every accepted request must get "
                             "exactly one line")
    del net, tr, fe
    torch.cuda.empty_cache()
    log("  phase wall %.1f s" % (time.perf_counter() - t_phase))
    return rows_launches, flash_launches


class PacedStdin:
    """Lines for a serve run's stdin pump, waiting ``pause`` seconds before
    each ADMIN line (and before the line after it) so the dispatcher has
    published its books, or run a reload, in between; ``hooks[i]`` runs
    just before line i is handed out."""

    def __init__(self, lines, pause=0.5, hooks=None):
        self.lines, self.pause, self.hooks = lines, pause, hooks or {}

    def __iter__(self):
        for i, line in enumerate(self.lines):
            if line.startswith("ADMIN") or (
                    i and self.lines[i - 1].startswith("ADMIN")):
                time.sleep(self.pause)
            if i in self.hooks:
                self.hooks[i]()
            yield line + "\n"


# seconds cli_serve_reload waits for the scheduled reload to have run
RELOAD_WAIT_S = 120


def cli_serve_reload(learn_task, api, d, cfg, net, prompt, first):
    """ADMIN reload in a paged, batched task = serve: the newer checkpoint
    (another seed's weights) answers after it, and the old model's KV pool
    and weights leave the card's memory with it."""
    models_dir = os.path.join(d, "models")
    os.makedirs(models_dir)
    net.save_model(os.path.join(models_dir, "0001.model"))
    newer = api.Net(dev=NET_DEV, cfg=cfg.replace("seed = %d\n" % SEED,
                                                 "seed = %d\n" % (SEED + 1)))
    newer.init_model()
    line = " ".join(map(str, prompt))
    mem = {}

    def before_reload():
        newer.save_model(os.path.join(models_dir, "0002.model"))
        mem["with_pool"] = torch.cuda.memory_allocated()

    # the dispatcher reloads between batches, after the request in flight:
    # the memory "after" is read once its reload has returned
    from cxxnet_tpu_torch.utils import servd
    do_reload = servd.ServeFrontend._do_reload
    reloaded = threading.Event()

    def signalled_reload(fe):
        try:
            do_reload(fe)
        finally:
            reloaded.set()

    def after_reload():
        if not reloaded.wait(RELOAD_WAIT_S):
            raise AssertionError("ADMIN reload did not run within %d s"
                                 % RELOAD_WAIT_S)
        mem["reloaded"] = torch.cuda.memory_allocated()
    conf = os.path.join(d, "reload.conf")
    with open(conf, "w") as f:
        f.write(cfg + "task = serve\nmodel_in = models/0001.model\n"
                "model_dir = models\ngen_new = %d\nserve_buckets = 1,4\n"
                "serve_kv_block = %d\n" % (CLI_SERVE_NEW, SESS_BLOCK))
    old_stdin = sys.stdin
    sys.stdin = PacedStdin([line, "ADMIN reload", line, "ADMIN stats"],
                           pause=1.0, hooks={1: before_reload,
                                             2: after_reload})
    servd.ServeFrontend._do_reload = signalled_reload
    try:
        out, _ = run_cli(learn_task, d, [conf], echo=("serve:",))
    finally:
        sys.stdin = old_stdin
        servd.ServeFrontend._do_reload = do_reload
    got = out.splitlines()
    want = [int(t) for t in first.split()]
    want_new = list(newer.generate(np.asarray([prompt]), CLI_SERVE_NEW)[0])
    freed = mem["with_pool"] - mem["reloaded"]
    pool_bytes = 2 * LM_ARGS["nlayer"] * 4 * LM_SEQ * LM_ARGS["dim"] * 2
    log("  ADMIN reload (serve_buckets = 1,4, serve_kv_block = %d): %s; "
        "card memory %d bytes with the old model's pool, %d after the "
        "reload (%d freed; the pool alone %d)"
        % (SESS_BLOCK, " | ".join(ln[:40] for ln in got),
           mem["with_pool"], mem["reloaded"], freed, pool_bytes))
    toks = [answer_tokens("before reload", got[0], CLI_SERVE_NEW,
                          LM_ARGS["vocab"]),
            answer_tokens("after reload", got[2], CLI_SERVE_NEW,
                          LM_ARGS["vocab"])]
    for what, model, got_toks, ref in (("before", net, toks[0], want),
                                       ("after", newer, toks[1], want_new)):
        hold_tokens("reload: the answer %s it vs its model's solo generate"
                    % what, None, model, [got_toks], [ref], [prompt],
                    (0.0, 0), [0], [0], NEAR_TIE)
    if got[1] != "OK reload scheduled" or "reloads=1 " not in got[3] \
            or toks[0] == toks[1] or freed < pool_bytes:
        raise AssertionError("ADMIN reload did not swap the model or did "
                             "not free the old pool")
    del newer

# requests in flight at cli_lm_serve's SIGTERM
CLI_SERVE_FLOOD = 8
# seconds at most of bursts that warm the served LM's grid (buckets 1 and
# 4, every prompt length) and span the 1 s /profilez capture
WARM_SECS = 120


def serve_clients_async(port, lines, timeout=300.0):
    """One TCP client a line, started now; the returned call joins them
    and gives the answers in order (None for a connection closed
    unanswered)."""
    out = [None] * len(lines)

    def one(i):
        try:
            out[i] = serve_clients(port, [lines[i]], 1,
                                   timeout=timeout)[0][0]
        except (OSError, AssertionError):
            out[i] = None
    ts = [threading.Thread(target=one, args=(i,), daemon=True)
          for i in range(len(lines))]
    for t in ts:
        t.start()

    def join():
        for t in ts:
            t.join(timeout)
        return out
    return join


def healthz_during_drain(sport, proc, timeout=60.0):
    """Poll /healthz from the moment of a SIGTERM until the process ends:
    (the first code other than 200, its body), or (None, ...) if the
    pages went away without one."""
    deadline = time.time() + timeout
    while time.time() < deadline and proc.poll() is None:
        try:
            code, body = scrape(sport, "/healthz", timeout=5)
        except OSError:
            break
        if code != 200:
            return code, body.strip().replace("\n", "; ")
        time.sleep(0.002)
    return None, "no answer other than 200 before the pages closed"


def status_pages(sport, port):
    """Scrape a serving process's status pages once, at rest after its
    first answer: each must answer 200 and parse (Prometheus text, JSON
    or HTML), and the decode account on /metrics and /batchz must agree
    with ADMIN stats. Returns a summary line."""
    status = {}
    code, text = scrape(sport, "/metrics")
    series = prom_series(text)
    status["/metrics"] = (code, "%d series" % len(series))
    for path in ("/healthz", "/livez"):
        code, body = scrape(sport, path)
        status[path] = (code, body.strip())
    code, page = scrape(sport, "/batchz")
    status["/batchz"] = (code, "html" if "decode batch scheduler" in page
                         else "?")
    code, body = scrape(sport, "/batchz?json=1")
    batch = json.loads(body)
    code, body = scrape(sport, "/requestz?json=1")
    recs = json.loads(body)["requests"]
    status["/requestz"] = (code, "%d records" % len(recs))
    rid = [r["id"] for r in recs if r.get("outcome") == "served"][0]
    code, body = scrape(sport, "/trace?request=%s" % rid)
    phases = [e["name"] for e in json.loads(body)["traceEvents"]
              if e.get("ph") == "X"]
    status["/trace"] = (code, "request %s: %s" % (rid, ",".join(
        sorted(set(phases) & {"queue_wait", "dispatch", "prefill",
                              "decode"}))))
    code, body = scrape(sport, "/eventz?json=1")
    status["/eventz"] = (code, "%d rows" % json.loads(body)["shown"])
    code, page = scrape(sport, "/eventz")
    admin = serve_clients(port, ["ADMIN stats"], 1, timeout=60)[0][0]
    kv = dict(t.split("=", 1) for t in admin.split()[1:])
    bad = [p for p, (c, _) in status.items() if c != 200]
    if bad or code != 200 or "queue_wait" not in status["/trace"][1]:
        raise AssertionError("status pages did not answer 200 and parse: "
                             "%s" % status)
    # the decode account: /batchz (the source of the cxxnet_decode_*
    # series) and /metrics against ADMIN stats, at rest
    pairs = [("free_slots", batch["free_slots"], int(kv["free_slots"]))]
    for b, bs in batch["buckets"].items():
        pairs.append(("bucket.%s.warm" % b, bs["warm"],
                      int(kv["bucket.%s.warm" % b])))
        pairs.append(("bucket.%s.active" % b, bs["active"],
                      int(kv["bucket.%s.active" % b])))
        pairs.append(("cxxnet_decode_kv_bytes{bucket=%s}" % b,
                      series['cxxnet_decode_kv_bytes{process="0",'
                             'bucket="%s"}' % b], bs["kv_bytes"]))
    pairs.append(("cxxnet_progress_served vs served",
                  series.get('cxxnet_progress_served{process="0"}'),
                  float(kv["served"])))
    off = [p for p in pairs if p[1] != p[2]]
    if off:
        raise AssertionError("the decode gauges disagree with ADMIN "
                             "stats: %s" % off)
    return "; ".join("%s %d %s" % (p, c, d) for p, (c, d)
                     in status.items()) + "; decode account = ADMIN stats" \
        " on %d keys (%s)" % (len(pairs), ", ".join(
            "%s=%s" % (n, g) for n, g, _ in pairs))


def warming_gate(sport, timeout=60.0):
    """/healthz of a replica whose warm grid is cold: polled from the
    moment its pages are up until it answers 503 (its serving probe is
    registered just after its port opens); returns (code, body, the
    cxxnet_ready_programs_pct gauge)."""
    deadline = time.time() + timeout
    code, body = scrape(sport, "/healthz")
    while code == 200 and time.time() < deadline:
        time.sleep(0.01)
        code, body = scrape(sport, "/healthz")
    series = prom_series(scrape(sport, "/metrics")[1])
    return code, body.strip(), series.get(
        'cxxnet_ready_programs_pct{process="0"}')


def trace_complete(path):
    """Whether a Chrome trace file has been written whole."""
    try:
        with open(path) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def warm_the_grid(sport, port, prompts, pdir, vocab):
    """Traffic until the warm grid is whole: bursts of every prompt from as
    many clients at once (a bucket-4 session), from the start of a 1 s
    /profilez capture until that capture has been written. Returns (the answers, the capture's trace.json
    path)."""
    lines = [" ".join(map(str, p)) for p in prompts]
    code, body = scrape(sport, "/profilez?secs=1")
    if code != 200:
        raise AssertionError("/profilez?secs=1 answered %d: %s"
                             % (code, body))
    trace = os.path.join(pdir, "capture_001", "trace.json")
    # bursts go on until the capture has ended as well: the profiler's
    # start (CUPTI's) can take longer than a few bursts, and a window
    # with no traffic in it would hold no kernel
    answers = []
    deadline = time.time() + WARM_SECS
    while True:
        answers += serve_clients(port, lines, len(lines), timeout=300)[0]
        rd = json.loads(scrape(sport, "/compilez?json=1")[1])["readiness"]
        if rd["ready_pct"] == 100.0 and trace_complete(trace):
            break
        if time.time() > deadline:
            raise AssertionError(
                "after %d bursts in %d s: ready %s%%, the /profilez trace "
                "%s" % (len(answers) // len(lines), WARM_SECS,
                        rd["ready_pct"], "written" if os.path.exists(trace)
                        else "not written"))
    for a in answers:
        answer_tokens("warm-up burst", a, CLI_SERVE_NEW, vocab)
    return answers, trace


def ledger_pages(sport, plens):
    """A warm replica's ledger: /healthz 200 and the readiness gauge at
    100; /compilez lists every expected key once, compiled as
    new_signature; /programz has ready prefill and step cards with flops,
    a prediction and a measured p50, at no more than 105% roofline
    efficiency (their spans wait for the card); every served flight
    record carries the decode bound, at or above its measured rate.
    Returns the summary lines."""
    code, body = scrape(sport, "/healthz")
    series = prom_series(scrape(sport, "/metrics")[1])
    gauge = series.get('cxxnet_ready_programs_pct{process="0"}')
    if code != 200 or gauge != 100.0:
        raise AssertionError("a warm replica: /healthz %d %r, "
                             "cxxnet_ready_programs_pct %s"
                             % (code, body, gauge))
    cz = json.loads(scrape(sport, "/compilez?json=1&n=0")[1])
    want = [str(("sess_prefill", p, 0.0, 0)) for p in plens]
    for b in (1, 4):
        want += [str(("sess_admit", b)), str(("sess_step", b, 0.0, 0))]
    keys = [r["key"] for r in cz["compiles"]]
    bad = [k for k in want if keys.count(k) != 1] + [
        r["key"] for r in cz["compiles"]
        if r["key"] in want and r["cause"] != "new_signature"]
    if bad or cz["readiness"]["ready_pct"] != 100.0:
        raise AssertionError("/compilez: keys not compiled once as "
                             "new_signature: %s" % bad)
    pz = json.loads(scrape(sport, "/programz?json=1")[1])
    lines = ["spec %s: %.0f TFLOP/s, %.0f GB/s, %d bytes; hbm peak %s, "
             "headroom %s, decode kv %s"
             % (pz["spec"]["name"], pz["spec"]["peak_flops"] / 1e12,
                pz["spec"]["hbm_bw"] / 1e9, pz["spec"]["hbm_capacity"],
                pz["hbm"]["peak_bytes"], pz["hbm"]["headroom_bytes"],
                pz["hbm"]["decode_kv_bytes"])]
    for c in pz["cards"]:
        lines.append(
            "%s %s: %s, flops %.4g, bytes %.4g, predicted %.6f ms, "
            "measured p50 %s ms (n %d, %s), eff %s%%, MFU %s%%, peak %s, "
            "compile %.3f s" % (
                c["name"], c["key"], c["status"], c["flops"] or 0,
                c["bytes_accessed"] or 0, 1e3 * (c["predicted_s"] or 0),
                c["measured_p50_ms"], c["measured_n"], c["measured_series"],
                c["roofline_eff_pct"], c["mfu_pct"], c["peak_bytes"],
                c["compile_s"]))
        if c["status"] != "ready":
            raise AssertionError("card not ready: %s" % c)
        if c["name"] in ("jit.decode_prefill", "jit.decode_step") and (
                not c["flops"] or not c["predicted_s"]
                or c["measured_p50_ms"] is None
                or c["roofline_eff_pct"] is None
                or c["roofline_eff_pct"] > 105.0):
            raise AssertionError("a decode card without flops, prediction "
                                 "or measurement, or above 105%% of its "
                                 "roofline: %s" % c)
    recs = [r for r in json.loads(scrape(
        sport, "/requestz?json=1&n=0")[1])["requests"]
        if r.get("outcome") == "served"]
    low = [r["id"] for r in recs
           if r.get("roofline_bound_tokens_per_s") is None
           or r["roofline_bound_tokens_per_s"] < (r.get("tokens_per_s")
                                                  or 0.0)]
    if low or not recs:
        raise AssertionError("flight records without the decode bound or "
                             "under their measured rate: %s" % low[:5])
    bounds = [r["roofline_bound_tokens_per_s"] for r in recs]
    rates = [r["tokens_per_s"] for r in recs if r.get("tokens_per_s")]
    lines.append("%d served flight records: roofline_bound_tokens_per_s "
                 "%.1f-%.1f, measured tokens/s %.1f-%.1f"
                 % (len(recs), min(bounds), max(bounds), min(rates),
                    max(rates)))
    return lines


def phase_cli_lm_serve(flash, learn_task, api, models):
    """task = serve from the command line on a model file of the bench.py
    LM in bf16 written here: stdin holds 8 prompts, a DEADLINE prompt, an
    out-of-vocab line, an empty line and ADMIN stats; stdout has exactly one
    line per input and the prompts' lines equal task = generate's for the
    same prompts. Then bin/cxxnet_torch in a process of its own with
    serve_port = 0, serve_buckets = 1,4, status_port = 0 and the warm grid
    (perf_ledger = 1, serve_plen_buckets = the prompts' lengths,
    serve_warm_ready_pct = 100): /healthz 503 "warming" before the first
    request; one TCP answer held to the solo generate; bursts until the
    grid is warm, the first under a /profilez capture whose trace names
    the flash forward kernel; the ledger's pages (ledger_pages);
    /metrics, /healthz, /livez, /batchz, /requestz, /trace?request=<id>
    and /eventz scraped (each answers 200 and parses; the decode account
    of /metrics and /batchz agrees with ADMIN stats); a flood in flight,
    SIGTERM, /healthz 503 while the drain answers it, exit 0. Returns the
    flash_fwd launches of the stdin run and the process."""
    log("phase cli_lm_serve")
    t_phase = time.perf_counter()
    vocab = LM_ARGS["vocab"]
    cfg = bf16_cfg(lm_cfg(models, LM_SEQ, LM_BATCH))
    rng = np.random.RandomState(SEED + 16)
    prompts = [rng.randint(0, vocab, n).tolist() for n in CLI_SERVE_LENS]
    stdin = [" ".join(map(str, p)) for p in prompts[:-1]]
    stdin += ["DEADLINE 60000 " + " ".join(map(str, prompts[-1])),
              "1 %d 3" % vocab, "", "ADMIN stats"]
    with scratch_dir("cli_lm_serve") as d:
        net = api.Net(dev=NET_DEV, cfg=cfg)
        net.init_model()
        net.save_model(os.path.join(d, "lm.model"))
        gen = []
        for i, p in enumerate(prompts):
            with open(os.path.join(d, "p%d.txt" % i), "w") as f:
                f.write(" ".join(map(str, p)) + "\n")
            with open(os.path.join(d, "gen%d.conf" % i), "w") as f:
                f.write(cfg + "task = generate\nmodel_in = lm.model\n"
                        "prompt_in = p%d.txt\ngen_out = g%d.txt\n"
                        "gen_new = %d\nsilent = 1\n" % (i, i, CLI_SERVE_NEW))
            run_cli(learn_task, d, [os.path.join(d, "gen%d.conf" % i)],
                    echo=())
            with open(os.path.join(d, "g%d.txt" % i)) as f:
                gen.append(f.read().strip())
        conf = os.path.join(d, "serve.conf")
        with open(conf, "w") as f:
            f.write(cfg + "task = serve\nmodel_in = lm.model\n"
                    "gen_new = %d\n" % CLI_SERVE_NEW)
        old_stdin = sys.stdin
        sys.stdin = PacedStdin(stdin)
        flash.launches = 0
        try:
            out, err = run_cli(learn_task, d, [conf],
                               echo=("served", "serve:", "servd:"))
        finally:
            sys.stdin = old_stdin
        torch.cuda.synchronize()
        launches = flash.launches
        got = out.splitlines()
        log("  stdin: %d lines in, %d out; flash_fwd launches %d (%d "
            "expected: %d a served prompt)"
            % (len(stdin), len(got), launches,
               LM_ARGS["nlayer"] * len(prompts), LM_ARGS["nlayer"]))
        same = got[:len(prompts)] == gen
        log("  the %d prompts' lines (the DEADLINE one included) vs task = "
            "generate's: %s; then %r, %r, %r"
            % (len(prompts), "EQUAL" if same else "DIFFERENT",
               *(ln[:60] for ln in got[len(prompts):])))
        if len(got) != len(stdin) or not same \
                or not got[-3].startswith("ERR parse") \
                or not got[-2].startswith("ERR empty") \
                or not got[-1].startswith("OK accepted=11 ") \
                or "served=9 " not in got[-1] \
                or launches != LM_ARGS["nlayer"] * len(prompts):
            raise AssertionError("task = serve's stdout is not one line "
                                 "per input equal to task = generate's")

        # TCP in a process of its own with the status pages and the warm
        # grid, then SIGTERM
        plens = sorted(set(CLI_SERVE_LENS))
        pdir = os.path.join(d, "profilez")
        proc = CliProcess(d, [conf, "serve_port=0", "serve_buckets=1,4",
                              "status_port=0", "perf_ledger=1",
                              "serve_plen_buckets=%s"
                              % ",".join(map(str, plens)),
                              "serve_warm_ready_pct=100",
                              "profilez_dir=" + pdir],
                          stdin=subprocess.PIPE)
        try:
            sport = int(proc.wait_for("err", r"statusd: live introspection "
                                      r"on port (\d+)", 300).group(1))
            port = int(proc.wait_for("err", r"servd: serving on port "
                                     r"(\d+)", 300).group(1))
            cold = warming_gate(sport)
            log("  before the first request: /healthz %d %r, "
                "cxxnet_ready_programs_pct %s" % cold)
            if cold[0] != 503 or "warming" not in cold[1] \
                    or not cold[2] < 100.0:
                raise AssertionError("a cold replica is not 503 warming "
                                     "below 100%% ready: %s" % (cold,))
            answer = serve_clients(port, [stdin[0]], 1, timeout=300)[0][0]
            toks = answer_tokens("cli tcp", answer, CLI_SERVE_NEW, vocab)
            want = [int(t) for t in gen[0].split()]
            log("  TCP answer (serve_port = 0, serve_buckets = 1,4) vs the "
                "solo generate: %s" % ("EQUAL" if toks == want
                                       else "DIFFERENT"))
            hold_tokens("cli tcp vs solo", None, net, [toks], [want],
                        [prompts[0]], (0.0, 0), [0], [0], NEAR_TIE)
            warm, trace = warm_the_grid(sport, port, prompts, pdir, vocab)
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            sym = KERNEL_SYMBOLS["flash_fwd"]
            n_flash = sum(1 for e in events
                          if sym in str(e.get("name", "")))
            log("  warm-up: %d bursts of %d prompts; /profilez?secs=1 "
                "during them: %s, %d events, %d naming %s"
                % (len(warm) // len(CLI_SERVE_LENS), len(CLI_SERVE_LENS),
                   os.path.relpath(trace, d), len(events), n_flash, sym))
            if not n_flash:
                raise AssertionError("the /profilez trace names no flash "
                                     "forward kernel (%s)" % sym)
            for ln in ledger_pages(sport, plens):
                log("  ledger: " + ln)
            pages = status_pages(sport, port)
            flood = serve_clients_async(port, stdin[:CLI_SERVE_FLOOD])
            proc.proc.stdin.close()
            time.sleep(0.05)      # the flood accepted and in flight
            proc.proc.send_signal(signal.SIGTERM)
            drain = healthz_during_drain(sport, proc.proc)
            rc = proc.finish(120)
            answers = flood()
        finally:
            proc.kill()
        served = 1 + len(warm) + sum(1 for a in answers
                                     if a and not a.startswith("ERR"))
        tail = proc.text("err")
        log("  SIGTERM with %d requests in flight: /healthz during the "
            "drain %s; %d answered (%d served); exit %d; %s"
            % (CLI_SERVE_FLOOD, drain, sum(1 for a in answers if a),
               served - 1, rc, " | ".join(
                   ln for ln in tail.splitlines()
                   if ln.startswith(("served", "serve:")))))
        if rc != 0 or "served %d prompts" % served not in tail \
                or not all(answers) or drain[0] != 503:
            raise AssertionError("bin/cxxnet_torch did not answer every "
                                 "request, turn /healthz 503 while "
                                 "draining, and exit 0 on SIGTERM")
        sub = proc.launches()["flash_fwd"]
        log("  flash_fwd launches in that process: %d (%d a served "
            "request's admission: %d requests)"
            % (sub, LM_ARGS["nlayer"], served))
        if sub != LM_ARGS["nlayer"] * served:
            raise AssertionError("the served process's flash launches are "
                                 "not %d a request" % LM_ARGS["nlayer"])
        launches += sub
        log("  status pages while serving: %s" % pages)
        cli_serve_reload(learn_task, api, d, cfg, net, prompts[0], gen[0])
        del net
    torch.cuda.empty_cache()
    log("  phase wall %.1f s" % (time.perf_counter() - t_phase))
    return launches


# requests in flight through the router when a replica is killed
ROUTE_KILL_INFLIGHT = 16
# the router's probe period (ms) and the longest wait for a fleet state
ROUTE_PROBE_MS, ROUTE_WAIT_S = 100, 120


def burst(port, lines, timeout=600.0):
    """Every line at once: one connection a line, all opened first, then
    the lines sent back to back, so that the dispatcher gathers them into
    one batch. Returns the answers in order."""
    socks = [socket.create_connection(("127.0.0.1", port), timeout=timeout)
             for _ in lines]
    try:
        for s, line in zip(socks, lines):
            s.sendall((line + "\n").encode("utf-8"))
        return [s.makefile("r", encoding="utf-8").readline().rstrip("\n")
                or None for s in socks]
    finally:
        for s in socks:
            s.close()


def admin_stats(port):
    """A frontend's ADMIN stats as a dict."""
    line = serve_clients(port, ["ADMIN stats"], 1, timeout=60)[0][0]
    if not line or not line.startswith("OK "):
        raise AssertionError("ADMIN stats answered %r" % line)
    out = {}
    for kv in line.split()[1:]:
        k, _, v = kv.partition("=")
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = v
    return out


def fleetz(sport):
    code, body = scrape(sport, "/fleetz?json=1")
    if code != 200:
        raise AssertionError("/fleetz?json=1 answered %d: %s" % (code, body))
    return json.loads(body)


def wait_fleet(sport, pred, what, timeout=ROUTE_WAIT_S):
    """Poll the router's /fleetz until ``pred(snapshot)``; the snapshot."""
    deadline = time.time() + timeout
    while True:
        snap = fleetz(sport)
        if pred(snap):
            return snap
        if time.time() > deadline:
            raise AssertionError("the router's /fleetz never showed %s: %s"
                                 % (what, [(r["name"], r["state"])
                                           for r in snap["replicas"]]))
        time.sleep(0.05)


def warm_replica(sport, port, prompts, vocab):
    """Traffic straight to one replica until its warm grid is whole: every
    prompt once, in bursts of the largest bucket, then for the keys
    /compilez still lists as cold, their prompt lengths again and a burst
    of each cold bucket's size (one batch a burst), until it reads ready
    100%. Returns the number of requests served."""
    import ast
    lines = [" ".join(map(str, p)) for p in prompts]
    by_len = {len(p): ln for p, ln in zip(prompts, lines)}
    top = max(FE_BUCKETS)
    bursts = [lines[k:k + top] for k in range(0, len(lines), top)]
    sent = 0
    deadline = time.time() + WARM_SECS
    while True:
        for chunk in bursts:
            for a in burst(port, chunk):
                answer_tokens("warm-up", a, SESS_NEW, vocab)
            sent += len(chunk)
        rd = json.loads(scrape(sport, "/compilez?json=1")[1])["readiness"]
        if rd["ready_pct"] == 100.0:
            return sent
        if time.time() > deadline:
            raise AssertionError("replica on port %d: ready %s%% after %d "
                                 "requests in %d s" % (port, rd["ready_pct"],
                                                       sent, WARM_SECS))
        cold = [ast.literal_eval(k) for k in rd["cold_keys"]]
        again = [by_len[k[1]] for k in cold if k[0] == "sess_prefill"]
        bursts = [again[k:k + top] for k in range(0, len(again), top)]
        bursts += [lines[:b] for b in sorted({k[1] for k in cold
                                              if k[0] != "sess_prefill"})]


def flight_join(sports, ids):
    """The replicas' flight records of the requests ``ids``, found by id
    (the trace id the router forwards): (TTFT ms of each, {bucket: the
    requests decoded in it})."""
    want, ttft, buckets = set(ids), [], {}
    for sp in sports:
        recs = json.loads(scrape(sp, "/requestz?json=1&n=0")[1])["requests"]
        for r in recs:
            if r.get("id") in want and r.get("outcome") == "served" \
                    and r.get("ttft_s") is not None:
                ttft.append(1e3 * r["ttft_s"])
                buckets[r["bucket"]] = buckets.get(r["bucket"], 0) + 1
    if len(ttft) != len(want):
        raise AssertionError("the flight-record join found %d of %d "
                             "requests" % (len(ttft), len(want)))
    return ttft, buckets


def route_rates(what, card, n_tok, lat, wall, joined):
    ttft, buckets = joined
    lat_ms = [1e3 * x for x in lat]
    log("  %s: %.1f tokens/s (%.3f s for %d tokens), end to end p50 %.2f "
        "ms p99 %.2f ms, TTFT p50 %.2f ms p99 %.2f ms; requests by the "
        "bucket they decoded in %s [%s]"
        % (what, n_tok / wall, wall, n_tok, pct(lat_ms, 50),
           pct(lat_ms, 99), pct(ttft, 50), pct(ttft, 99),
           dict(sorted(buckets.items())), card))
    return n_tok / wall


def process_launches(proc, timeout=60.0):
    """A CliProcess's launch counts now: SIGUSR2 makes its runner print
    them (the line it prints at exit)."""
    n = sum(1 for ln in proc.lines["err"] if ln.startswith("launches "))
    proc.proc.send_signal(signal.SIGUSR2)
    deadline = time.time() + timeout
    while sum(1 for ln in proc.lines["err"]
              if ln.startswith("launches ")) <= n:
        if time.time() > deadline or proc.proc.poll() is not None:
            raise AssertionError("no launch counts after SIGUSR2")
        time.sleep(0.02)
    return proc.launches()


def phase_cli_lm_route(learn_task, api, models):
    """task = route from the command line over two task = serve replicas
    of the bench.py LM in bf16, each bin/cxxnet_torch in a process of its
    own on the card (serve_buckets = 1,2,4,8, the warm grid of the 24
    requests' prompt lengths at serve_warm_ready_pct = 100), the router a
    third (route_probe_ms = 100, status_port = 0). Warm-up: the router's
    /fleetz shows both replicas warming and sheds a request itself; each
    replica's grid warmed straight, then both read up at warm_pct 100.
    Traffic: lm_serve_frontend's 24 requests (seed 14, 64 new tokens,
    greedy) by 8 closed-loop TCP clients through the router, each answer
    held to its solo generate up to the near-tie rule, both replicas
    serving, the books reconciled; tokens/s, end-to-end and TTFT (joined
    by trace id) p50 / p99 beside the same 24 sent straight to one
    replica. Pages: /fleetz, /metrics (cxxnet_fleet_*), the stitched
    /trace and /why of a routed request, /eventz. A rolling ADMIN reload
    to the LM after one Adam step (eta 3e-4) while requests stream: none
    fails, the drain windows never overlap, the 24 then equal the new
    model's generate. SIGKILL of one replica with 16 requests in flight:
    each answered once, equal to its solo generate, the replica dead, the
    failover counted. SIGTERM drains the router (exit 0) and the
    survivor. Each replica launches flash_fwd 4 times an admission; the
    router launches nothing and makes no CUDA context. Returns the
    replicas' flash_fwd launches."""
    from cxxnet_tpu_torch.utils.autopsy import CAUSES
    log("phase cli_lm_route (bench.py LM, bf16, 2 replicas + task = route)")
    t_phase = time.perf_counter()
    card = nvidia_smi()
    vocab, nlayer = LM_ARGS["vocab"], LM_ARGS["nlayer"]
    cfg = bf16_cfg(lm_cfg(models, LM_SEQ, LM_BATCH))
    prompts, _ = serve_requests(np.random.RandomState(SEED + 14), vocab)
    n_tok = SESS_REQUESTS * SESS_NEW
    plens = sorted({len(p) for p in prompts})

    def lines(tag):
        return ["TRACE %s%d %s" % (tag, i, " ".join(map(str, p)))
                for i, p in enumerate(prompts)]

    def stage(what):
        log("  [%.1f s] %s" % (time.perf_counter() - t_phase, what))
    with scratch_dir("cli_lm_route") as d:
        mdir = os.path.join(d, "models")
        os.makedirs(mdir)
        net = api.Net(dev=NET_DEV, cfg=cfg)
        net.init_model()
        net.save_model(os.path.join(mdir, "0001.model"))
        conf = os.path.join(d, "serve.conf")
        with open(conf, "w") as f:
            f.write(cfg + "task = serve\nmodel_in = models/0001.model\n"
                    "model_dir = models\ngen_new = %d\n" % SESS_NEW)
        reps, router = [], None
        try:
            for _ in range(2):
                reps.append(CliProcess(d, [
                    conf, "serve_port=0", "status_port=0",
                    "serve_buckets=%s" % ",".join(map(str, FE_BUCKETS)),
                    "perf_ledger=1",
                    "serve_plen_buckets=%s" % ",".join(map(str, plens)),
                    "serve_warm_ready_pct=100"]))
            # while the replicas start: both models' solo answers, the
            # second model the LM after one Adam step on a fixed batch,
            # kept out of model_dir until the reload
            solo = run_solo(net, prompts, SESS_NEW, (0.0, 0), 0)
            newer = api.Net(dev=NET_DEV, cfg=cfg + "eta = %g\n" % LM_LOSS_ETA)
            newer.init_model()
            rng = np.random.RandomState(SEED + 18)
            newer.update(rng.randint(0, vocab, (LM_BATCH, 1, 1, LM_SEQ))
                         .astype(np.float32),
                         rng.randint(0, vocab, (LM_BATCH, LM_SEQ))
                         .astype(np.float32))
            nxt = os.path.join(d, "next.model")
            newer.save_model(nxt)
            del newer
            fresh = api.Net(dev=NET_DEV, cfg=cfg)
            fresh.load_model(nxt)
            solo_new = run_solo(fresh, prompts, SESS_NEW, (0.0, 0), 0)
            stage("solo answers of both models")
            ports, sports = [], []
            for r in reps:
                sports.append(int(r.wait_for(
                    "err", r"statusd: live introspection on port (\d+)",
                    300).group(1)))
                ports.append(int(r.wait_for(
                    "err", r"servd: serving on port (\d+)", 300).group(1)))
            rconf = os.path.join(d, "route.conf")
            with open(rconf, "w") as f:
                f.write("task = route\nroute_replicas = %s\n"
                        "route_probe_ms = %d\nroute_replay = 1\n"
                        "status_port = 0\n"
                        % (",".join("127.0.0.1:%d:%d" % ps for ps in
                                    zip(ports, sports)), ROUTE_PROBE_MS))
            router = CliProcess(d, [rconf])
            rsport = int(router.wait_for(
                "err", r"statusd: live introspection on port (\d+)",
                120).group(1))
            rport = int(router.wait_for(
                "err", r"routerd: routing on port (\d+)", 120).group(1))
            stage("three processes up")

            # 1. warm-up: the router routes nothing to a warming replica
            snap = wait_fleet(rsport, lambda s: [r["state"] for r in
                                                 s["replicas"]]
                              == ["warming"] * 2, "both replicas warming")
            early = serve_clients(rport, [lines("w")[0]], 1,
                                  timeout=60)[0][0]
            cold = [admin_stats(p)["accepted"] for p in ports]
            log("  before warm-up: /fleetz %s, eligible %d; a request to "
                "the router: %r; replicas' accepted %s"
                % ([(r["state"], r["warm_pct"]) for r in snap["replicas"]],
                   snap["eligible"], early, cold))
            if not (early or "").startswith("ERR busy fleet") \
                    or cold != [0, 0] or snap["eligible"] != 0:
                raise AssertionError("the router routed to a warming "
                                     "replica")
            t = time.perf_counter()
            warmed = [None, None]
            ths = [threading.Thread(target=lambda i=i: warmed.__setitem__(
                i, warm_replica(sports[i], ports[i], prompts, vocab)))
                for i in range(2)]
            for th in ths:
                th.start()
            for th in ths:
                th.join()
            if None in warmed:
                raise AssertionError("a replica's warm-up failed")
            snap = wait_fleet(rsport, lambda s: all(
                r["state"] == "up" and r["warm_pct"] == 100.0
                for r in s["replicas"]), "both replicas up at 100%")
            stage("warm-up: %s requests straight to the replicas in %.1f "
                  "s; then /fleetz %s" % (warmed, time.perf_counter() - t,
                                          [(r["state"], r["warm_pct"])
                                           for r in snap["replicas"]]))

            # 2. traffic through the router, then straight to replica 0
            before = [admin_stats(p) for p in ports]
            lat = [None] * SESS_REQUESTS
            got, wall = serve_clients(rport, lines("rt"), FE_CLIENTS,
                                      lat=lat)
            after = [admin_stats(p) for p in ports]
            served = [a["served"] - b["served"]
                      for a, b in zip(after, before)]
            toks = [answer_tokens("routed request %d" % i, a, SESS_NEW,
                                  vocab) for i, a in enumerate(got)]
            hold_tokens("routed vs solo", None, net, toks, solo, prompts,
                        (0.0, 0), [0] * SESS_REQUESTS, [0] * SESS_REQUESTS,
                        NEAR_TIE)
            log("  routed: replicas served %s of the %d" % (served,
                                                            SESS_REQUESTS))
            if sum(served) != SESS_REQUESTS or min(served) < 1:
                raise AssertionError("the routed requests were not served "
                                     "by both replicas exactly once")
            reconciled("router", fleetz(rsport)["stats"])
            for i, p in enumerate(ports):
                reconciled("replica %d" % i, admin_stats(p))
            rate = route_rates("through the router", card, n_tok, lat, wall,
                               flight_join(sports, ["rt%d" % i for i in
                                                  range(SESS_REQUESTS)]))
            dlat = [None] * SESS_REQUESTS
            dgot, dwall = serve_clients(ports[0], lines("dr"), FE_CLIENTS,
                                        lat=dlat)
            hold_tokens("straight to replica 0 vs solo", None, net,
                        [answer_tokens("direct request %d" % i, a, SESS_NEW,
                                       vocab) for i, a in enumerate(dgot)],
                        solo, prompts, (0.0, 0), [0] * SESS_REQUESTS,
                        [0] * SESS_REQUESTS, NEAR_TIE)
            drate = route_rates("straight to replica 0", card, n_tok, dlat,
                                dwall, flight_join(sports[:1],
                                                 ["dr%d" % i for i in
                                                  range(SESS_REQUESTS)]))
            log("  router / direct tokens/s %.3f" % (rate / drate))

            # 3. the router's pages
            code, page = scrape(rsport, "/fleetz")
            series = prom_series(scrape(rsport, "/metrics")[1])
            fleet_series = sorted({k.split("{")[0] for k in series
                                   if k.startswith("cxxnet_fleet_")})
            code_t, body = scrape(rsport, "/trace?request=rt0")
            ev = json.loads(body)["traceEvents"] if code_t == 200 else []
            attempts = [e for e in ev if e.get("ph") == "X"
                        and e.get("pid") == 0 and e.get("tid") == 1]
            phases = sorted({e["name"] for e in ev if e.get("ph") == "X"
                             and e.get("pid", 0) >= 1} & {
                "queue_wait", "dispatch", "prefill", "decode"})
            code_w, body = scrape(rsport, "/why?request=rt0&json=1")
            why = json.loads(body) if code_w == 200 else {}
            primary = (why.get("autopsy") or {}).get("primary")
            code_e, body = scrape(rsport, "/eventz?json=1")
            log("  router pages: /fleetz %d (%s), /metrics %d series (%d "
                "cxxnet_fleet_* families: %s), /trace?request=rt0 %d (%d "
                "attempt spans, replica phases %s), /why %d (primary %s, "
                "hops %s), /eventz %d (%s rows)"
                % (code, "html" if "serving fleet" in page else "?",
                   len(series), len(fleet_series), ", ".join(fleet_series),
                   code_t, len(attempts), phases, code_w, primary,
                   sorted(why.get("hops") or {}), code_e,
                   json.loads(body).get("shown") if code_e == 200
                   else None))
            if code != 200 or "serving fleet" not in page \
                    or "cxxnet_fleet_replicas" not in fleet_series \
                    or code_t != 200 or not attempts \
                    or "prefill" not in phases or code_w != 200 \
                    or primary not in CAUSES or code_e != 200:
                raise AssertionError("the router's pages did not answer "
                                     "and parse")

            # 4. rolling reload under streaming traffic
            stage("traffic and pages")
            os.replace(nxt, os.path.join(mdir, "0002.model"))
            stop, streamed = threading.Event(), []

            def stream():
                k = 0
                while not stop.is_set():
                    streamed.extend(serve_clients(
                        rport, lines("s%d-" % k), FE_CLIENTS)[0])
                    k += 1
            th = threading.Thread(target=stream)
            th.start()
            time.sleep(0.5)
            ack = serve_clients(rport, ["ADMIN reload"], 1, timeout=60)[0][0]
            t = time.perf_counter()
            try:
                snap = wait_fleet(rsport, lambda s: not s["reloading"]
                                  and len(s["windows"]) >= 2,
                                  "the rolling reload done")
            finally:
                stop.set()
                th.join()
            reload_s = time.perf_counter() - t
            wins = sorted(snap["windows"], key=lambda w: w["out_s"])
            overlap = any(b["out_s"] < a["back_s"]
                          for a, b in zip(wins, wins[1:]))
            bad = [a for a in streamed if a is None or a.startswith("ERR")]
            # a replica rejoins once it has taken the reload (its
            # reload_seen moved), and may still be loading the model then
            deadline = time.time() + ROUTE_WAIT_S
            reloads = [admin_stats(p)["reloads"] for p in ports]
            while reloads != [1, 1] and time.time() < deadline:
                time.sleep(0.1)
                reloads = [admin_stats(p)["reloads"] for p in ports]
            log("  ADMIN reload -> %r; rolled in %.2f s with %d requests "
                "streaming (%d not served); drain windows %s (%s); "
                "replicas' reloads %s [%s]"
                % (ack, reload_s, len(streamed), len(bad),
                   ["%s %.3f-%.3f s" % (w["replica"], w["out_s"],
                                        w["back_s"]) for w in wins],
                   "never overlapping" if not overlap else "OVERLAPPING",
                   reloads, card))
            if not (ack or "").startswith("OK fleet reload") or bad \
                    or overlap or len(wins) != 2 or reloads != [1, 1]:
                raise AssertionError("the rolling reload lost a request, "
                                     "held two replicas out at once or "
                                     "did not reload both")
            for a in streamed:
                answer_tokens("streamed during the reload", a, SESS_NEW,
                              vocab)
            got = serve_clients(rport, lines("nw"), FE_CLIENTS)[0]
            toks = [answer_tokens("after the reload %d" % i, a, SESS_NEW,
                                  vocab) for i, a in enumerate(got)]
            hold_tokens("routed after the reload vs the new model's solo",
                        None, fresh, toks, solo_new, prompts, (0.0, 0),
                        [0] * SESS_REQUESTS, [0] * SESS_REQUESTS, NEAR_TIE)
            moved = sum(1 for g, o in zip(toks, solo) if g != o)
            log("  after the reload: %d of %d answers differ from the old "
                "model's" % (moved, SESS_REQUESTS))
            if not moved:
                raise AssertionError("the reloaded fleet still serves the "
                                     "old model")

            # 5. SIGKILL of replica 1 with requests in flight
            stage("rolling reload")
            victim = 1
            pre = process_launches(reps[victim])["flash_fwd"]
            pre_served = admin_stats(ports[victim])["served"]
            if pre != nlayer * pre_served:
                raise AssertionError(
                    "replica %d launched flash_fwd %d times for %d "
                    "admissions" % (victim, pre, pre_served))
            join = serve_clients_async(rport,
                                       lines("k")[:ROUTE_KILL_INFLIGHT])
            name = snap["replicas"][victim]["name"]
            wait_fleet(rsport, lambda s: s["replicas"][victim]
                       ["outstanding"] >= 1, "requests at the victim", 60)
            inflight = fleetz(rsport)["replicas"][victim]["outstanding"]
            reps[victim].proc.kill()
            answers = join()
            snap = wait_fleet(rsport, lambda s: s["replicas"][victim]
                              ["state"] == "dead", "the victim dead", 30)
            st = snap["stats"]
            kidx = range(ROUTE_KILL_INFLIGHT)
            toks = [answer_tokens("killed-fleet request %d" % i, a, SESS_NEW,
                                  vocab) for i, a in enumerate(answers)]
            hold_tokens("answers across the kill vs the new model's solo",
                        None, fresh, toks, [solo_new[i] for i in kidx],
                        [prompts[i] for i in kidx], (0.0, 0),
                        [0] * len(kidx), [0] * len(kidx), NEAR_TIE)
            log("  SIGKILL of %s with %d of %d requests outstanding there: "
                "%d answered once each; /fleetz %s; lost_contact %d, "
                "replays %d, retries %d, discarded_late %d"
                % (name, inflight, ROUTE_KILL_INFLIGHT, len(answers),
                   [(r["name"], r["state"]) for r in snap["replicas"]],
                   st["lost_contact"], st["replays"], st["retries"],
                   st["discarded_late"]))
            if st["replays"] + st["retries"] < 1:
                raise AssertionError("the kill left no failover count")
            reconciled("router after the kill", st)

            # 6. drain the router, then the survivor
            stage("kill")
            router.proc.send_signal(signal.SIGTERM)
            rrc = router.finish(120)
            tail = [ln for ln in router.lines["err"]
                    if ln.startswith("routed ")]
            want = "routed %d requests (%d served, 0 errors, 1 shed, " \
                "0 deadline" % (st["accepted"], st["accepted"] - 1)
            log("  router SIGTERM: exit %d, %s" % (rrc, tail))
            if rrc != 0 or not tail or not tail[-1].startswith(want):
                raise AssertionError("the router did not drain to %r and "
                                     "exit 0" % want)
            survivor = reps[1 - victim]
            s_served = admin_stats(ports[1 - victim])["served"]
            survivor.proc.send_signal(signal.SIGTERM)
            src = survivor.finish(120)
            s_tail = survivor.text("err")
            post = survivor.launches()["flash_fwd"]
            log("  survivor SIGTERM: exit %d, %s" % (src, " | ".join(
                ln for ln in s_tail.splitlines()
                if ln.startswith("served "))))

            # 7. the processes' kernels
            stage("drains")
            rl = router.launches()
            log("  flash_fwd launches: replica %d %d for %d admissions "
                "(read before its kill), replica %d %d for %d admissions; "
                "the router %s, CUDA initialized at its exit: %s"
                % (victim, pre, pre_served, 1 - victim, post, s_served,
                   rl["flash_fwd"], rl.get("cuda_initialized")))
            if src != 0 or "served %d prompts" % s_served not in s_tail \
                    or post != nlayer * s_served or rl["flash_fwd"] != 0 \
                    or rl.get("cuda_initialized") is not False:
                raise AssertionError("a replica's flash launches are not %d "
                                     "an admission, or the router touched "
                                     "the card" % nlayer)
        finally:
            for p in reps + [router]:
                if p is not None:
                    p.kill()
        del net, fresh
    torch.cuda.empty_cache()
    log("  phase wall %.1f s" % (time.perf_counter() - t_phase))
    return pre + post


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


def tensor_core_instructions(names):
    """HMMA (tensor-core) instructions in the built libraries ``names``,
    counted in cuobjdump's SASS; raises if any has none (its kernels would
    then run outside the tensor cores)."""
    from cxxnet_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    paths = _build.build_kernels(names)
    # one cuobjdump per library, all started together
    procs = {name: subprocess.Popen([tool, "-sass", paths[name]],
                                    stdout=subprocess.PIPE, text=True)
             for name in names}
    counts = {}
    for name, proc in procs.items():
        sass, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError("cuobjdump -sass %s exited %d"
                                 % (paths[name], proc.returncode))
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
    one fp32 launch each), the only default shape that is timed. The plain and library times are those of the
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
            if len(shapes) > 1 and name != shapes[0][0]:
                # an edge shape: checked, not timed (a cut of depth)
                if dtype == torch.float32:
                    for key in recs:
                        recs[key]["max_abs_err"] = max(
                            recs[key]["max_abs_err"], err)
                del q, k, v, dout, out, lse, delta, dq, dk, dv, ref
                continue
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
                if name == shapes[0][0] and dtype == torch.bfloat16:
                    recs[key]["bf16"] = dict(_new_rec(), max_abs_err=err,
                                             at=name)
                    _add_fp32(recs[key]["bf16"], ms, plain_ms, library_ms,
                              bound_ms, bound_by)
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


def data_batch(x, y, dev):
    """A DataBatch of (x, y) on ``dev`` (1-D labels as a column)."""
    from cxxnet_tpu_torch.io import DataBatch
    b = DataBatch()
    b.data = torch.from_numpy(x).to(dev)
    b.label = torch.from_numpy(y.reshape(y.shape[0], -1)).to(dev)
    b.batch_size = x.shape[0]
    return b


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
    loss_c, grads_c = cpu.net_.loss_and_grads(data_batch(x, y, "cpu"))
    cpu_s = time.time() - t
    loss_g, grads_g = net.net_.loss_and_grads(data_batch(x, y, DEV))
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
    batch_dev = data_batch(x, y, DEV)
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
    bound_ms, bound_by, bytes_ms, ops_ms = _bound(n, _random_ops.work(n)[1],
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
# synchronized AlexNet steps timed for cli_imagenet_train's MFU
MFU_STEPS = 5
# rounds of each io-only (test_io) run of the ImageNet pack: the loader's
# start (the first round) and two rounds in its steady state
IO_ROUNDS = 3
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
# cli_imagenet_train's round rates on the PPM pack, for cli_imagenet_jpeg
PPM_ROUND_RATES = []
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


# the host-side inputs of the CLI phases (image records), made by a thread
# while the kernels build (prepare_host_inputs) and taken from here after
# it has ended
_HOST_INPUTS = {}
_HOST_THREAD = []


def ppm_records(n, hw, n_class, seed):
    """(label, PPM bytes) of a synthetic image pack (io.synth.images)."""
    from cxxnet_tpu_torch.io import synth
    return [(lab, synth.ppm_bytes(img))
            for lab, img in synth.images(n, hw, n_class, seed)]


def bowl_records():
    from cxxnet_tpu_torch.io import synth
    return list(synth.jpeg_records(BOWL_TRAIN + BOWL_VAL, BOWL_HW,
                                   BOWL_CLASSES, SEED, quality=90,
                                   subsampling="420"))


def prepare_host_inputs():
    """Make the image records the CLI phases write as packs (ImageNet.conf
    and GoogLeNet.conf's PPM pack, the JPEG pack, bowl.conf's) on a thread
    of its own while the kernels build: host work moved off the run's
    critical path. ``host_input`` waits for it."""
    def run():
        t = time.perf_counter()
        try:
            _HOST_INPUTS["ppm_train"] = ppm_records(CLI_TRAIN_IMAGES, CLI_HW,
                                                    1000, SEED)
            _HOST_INPUTS["ppm_test"] = ppm_records(CLI_TEST_IMAGES, CLI_HW,
                                                   1000, SEED + 1)
            for part in ("train", "test"):
                jpeg_pack_records(part)
            _HOST_INPUTS["bowl"] = bowl_records()
        except BaseException as e:   # re-raised by host_input
            _HOST_INPUTS["error"] = e
            raise
        _HOST_INPUTS["seconds"] = time.perf_counter() - t
    th = threading.Thread(target=run, daemon=True)
    th.start()
    _HOST_THREAD.append(th)


def host_input(key):
    """A record list of prepare_host_inputs (made here if it was not
    started, as a phase run alone finds it)."""
    for th in _HOST_THREAD:
        th.join()
    if "error" in _HOST_INPUTS:
        raise AssertionError("making the image records failed: %r"
                             % _HOST_INPUTS["error"])
    if key not in _HOST_INPUTS:
        _HOST_INPUTS[key] = {
            "ppm_train": lambda: ppm_records(CLI_TRAIN_IMAGES, CLI_HW, 1000,
                                             SEED),
            "ppm_test": lambda: ppm_records(CLI_TEST_IMAGES, CLI_HW, 1000,
                                            SEED + 1),
            "bowl": bowl_records}[key]()
    return _HOST_INPUTS[key]


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
    from cxxnet_tpu_torch.io import synth
    t = time.perf_counter()
    synth.write_pack(host_input("ppm_train"),
                     os.path.join(root, "NameList.train"),
                     os.path.join(root, "TRAIN.BIN"))
    synth.write_pack(host_input("ppm_test"),
                     os.path.join(root, "NameList.test"),
                     os.path.join(root, "TEST.BIN"))
    cwd = os.path.join(root, "a", "b")
    os.makedirs(cwd)
    log("  pack: %d + %d PPM images %dx%d (seed %d) in %.2f s"
        % (CLI_TRAIN_IMAGES, CLI_TEST_IMAGES, CLI_HW, CLI_HW, SEED,
           time.perf_counter() - t))
    return cwd


def conf_section(path, name, extra, shape, batch):
    """The ``name`` iterator section of a conf file as a DataIter string,
    with the global keys that the CLI applies to every chain and that the
    image chain reads."""
    text = open(path).read()
    start = text.index("%s\niter = imgbin" % name)
    body = text[start + len(name) + 1: text.index("iter = end", start)]
    return body + extra + "input_shape = %s\nbatch_size = %d\n" \
        "iter = end\n" % (shape, batch)


def imagenet_section(name, extra=""):
    """ImageNet.conf's ``name`` iterator section as a DataIter string."""
    return conf_section(os.path.join(REPO, "example/ImageNet/ImageNet.conf"),
                        name, extra, "3,227,227", BATCH)

# bin/cxxnet_torch in a process of its own: the runner turns cuDNN off when
# asked, runs the entry script, and prints the kernels' launch counts of
# that process (each starts at 0 with it) on stderr as it exits
CLI_RUNNER = """
import atexit, json, runpy, signal, sys
sys.path.insert(0, %(repo)r)
import torch
torch.backends.cudnn.enabled = %(cudnn)r
from cxxnet_tpu_torch.ops import flash_attn, lrn


def counts(*_):
    print("launches " + json.dumps({
        "lrn_fwd": lrn.launches, "lrn_fwd_no_norm": lrn.no_norm_launches,
        "lrn_bwd": lrn.bwd_launches, "flash_fwd": flash_attn.launches,
        "cuda_initialized": torch.cuda.is_initialized()}),
        file=sys.stderr, flush=True)


atexit.register(counts)
signal.signal(signal.SIGUSR2, counts)     # the counts so far, on demand
sys.argv = [%(entry)r] + %(argv)r
runpy.run_path(%(entry)r, run_name="__main__")
"""


class CliProcess:
    """bin/cxxnet_torch ``argv`` in a process of its own (through
    CLI_RUNNER) in ``cwd``, its stdout and stderr read line by line on
    threads; ``wait_for`` blocks until a line matches."""

    def __init__(self, cwd, argv, cudnn=True, stdin=subprocess.DEVNULL):
        code = CLI_RUNNER % {"repo": REPO, "cudnn": bool(cudnn),
                             "entry": os.path.join(REPO, "bin",
                                                   "cxxnet_torch"),
                             "argv": list(argv)}
        log("  bin/cxxnet_torch %s (a process of its own%s)"
            % (" ".join(os.path.relpath(a, REPO) if a.startswith(REPO)
                        else a for a in argv),
               "" if cudnn else ", cuDNN off"))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=cwd, stdin=stdin,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONUNBUFFERED="1"))
        self.lines = {"out": [], "err": []}
        self._cv = threading.Condition()
        self._pumps = [threading.Thread(target=self._pump, args=(k, f),
                                        daemon=True)
                       for k, f in (("out", self.proc.stdout),
                                    ("err", self.proc.stderr))]
        for t in self._pumps:
            t.start()

    def _pump(self, key, f):
        for ln in f:
            with self._cv:
                self.lines[key].append(ln.rstrip("\n"))
                self._cv.notify_all()
        with self._cv:
            self._cv.notify_all()

    def wait_for(self, key, regex, timeout):
        pat = re.compile(regex)
        deadline = time.time() + timeout
        i = 0
        with self._cv:
            while True:
                while i < len(self.lines[key]):
                    m = pat.search(self.lines[key][i])
                    i += 1
                    if m:
                        return m
                if not any(t.is_alive() for t in self._pumps):
                    raise AssertionError(
                        "bin/cxxnet_torch ended (rc %s) without a line "
                        "matching %r; stderr tail: %s"
                        % (self.proc.poll(), regex,
                           " | ".join(self.lines["err"][-8:])))
                left = deadline - time.time()
                if left <= 0:
                    raise AssertionError("no line matching %r within %d s"
                                         % (regex, timeout))
                self._cv.wait(min(left, 0.5))

    def finish(self, timeout):
        rc = self.proc.wait(timeout=timeout)
        for t in self._pumps:
            t.join(10)
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def text(self, key):
        return "\n".join(self.lines[key])

    def launches(self):
        """The process's kernel launch counts, from the runner's line."""
        for ln in reversed(self.lines["err"]):
            if ln.startswith("launches "):
                return json.loads(ln[len("launches "):])
        raise AssertionError("no launch counts from the process")


def scrape(port, path, timeout=10.0):
    """(status, body) of a status page; 4xx/5xx come back as values."""
    from urllib.error import HTTPError
    from urllib.request import urlopen
    try:
        r = urlopen("http://127.0.0.1:%d%s" % (port, path), timeout=timeout)
        return r.status, r.read().decode()
    except HTTPError as e:
        return e.code, e.read().decode()


def prom_series(text):
    """{series with its labels: value} of a /metrics page; fails on a line
    outside the Prometheus text grammar (statusd.PROM_LINE_RE)."""
    from cxxnet_tpu_torch.utils import statusd
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        if not statusd.PROM_LINE_RE.match(ln):
            raise AssertionError("invalid Prometheus line %r" % ln)
        key, val = ln.rsplit(" ", 1)
        out[key] = float(val)
    return out


def telemetry_events(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def phase_cli_imagenet_resume(cwd, conf, det_err):
    """ImageNet.conf from bin/cxxnet_torch in processes of their own, with
    cuDNN off as in the uninterrupted run that wrote models_det: SIGTERM
    after the first batch of round 1, the emergency file's cursor, then
    continue = 1 (with status_port = 0, scraped while the round runs) to
    the end of round 2, whose model file must equal the uninterrupted
    run's bit for bit, and whose eval line must equal its eval line; the
    LRN launches of the resumed run: only the batches it trains. Then the
    newest file truncated: a second continue = 1 (ckpt_keep_last = 1)
    quarantines it, falls back to round 1's file, writes the round-2 file
    again (bit for bit once more) and keeps only it. Returns the LRN
    (forward, backward) launches of the two continued runs."""
    log("phase cli_imagenet_resume")
    t0 = time.perf_counter()
    from cxxnet_tpu_torch.utils import checkpoint as ckpt
    per_round = CLI_TRAIN_IMAGES // BATCH
    evals = CLI_TEST_IMAGES // BATCH
    det = open(os.path.join(cwd, "models_det", "%04d.model" % CLI_ROUNDS),
               "rb").read()
    det_line = [ln for ln in det_err.splitlines()
                if ln.startswith("[%d]" % CLI_ROUNDS)]
    models = os.path.join(cwd, "models_res")
    base = [conf, "num_round=%d" % CLI_ROUNDS, "max_round=%d" % CLI_ROUNDS,
            "dev=" + NET_DEV, "batch_size=%d" % BATCH,
            "model_dir=models_res", "image_mean=models_res/mean"]

    # the preempted run: SIGTERM once round 1's first batch is trained
    t = time.perf_counter()
    a = CliProcess(cwd, base + ["print_step=1",
                                "telemetry_log=models_res/a.jsonl"],
                   cudnn=False)
    try:
        a.wait_for("out", r"^round\s+1:\[\s+1\]", 900)
        a.proc.send_signal(signal.SIGTERM)
        rc = a.finish(600)
    finally:
        a.kill()
    m = re.search(r"preemption: emergency checkpoint -> \S+ \(round 1, "
                  r"batch (\d+)\)", a.text("out"))
    epath = os.path.join(models, ckpt.EMERGENCY_NAME)
    if rc != 0 or m is None or not os.path.exists(epath):
        raise AssertionError("the preempted run did not write its emergency "
                             "file and exit 0 (rc %s)" % rc)
    k = int(m.group(1))
    st = ckpt.peek_state(ckpt.read_verified(epath)[0])
    cursor = (st["start_counter"], st["batches_done"])
    save = [e for e in telemetry_events(os.path.join(models, "a.jsonl"))
            if e["ev"] == "ckpt_save" and e["path"].endswith(
                ckpt.EMERGENCY_NAME)][0]
    log("  SIGTERM after round 1's first batch: the run stopped at batch "
        "%d of %d (%.2f s wall); emergency.model cursor %s, rng_counter "
        "%d; its ckpt_save %.4f s for %d bytes"
        % (k, per_round, time.perf_counter() - t, cursor,
           st["rng_counter"], save["seconds"], save["bytes"]))
    if cursor != (2, k) or not 0 < k < per_round:
        raise AssertionError("the emergency cursor %s is not (2, %d) with "
                             "0 < %d < %d" % (cursor, k, k, per_round))

    # continue = 1, the status pages scraped while round 1 runs
    t = time.perf_counter()
    b = CliProcess(cwd, base + ["continue=1", "status_port=0",
                                "telemetry_log=models_res/b.jsonl"],
                   cudnn=False)
    try:
        sport = int(b.wait_for("err", r"statusd: live introspection on "
                               r"port (\d+)", 600).group(1))
        b.wait_for("out", r"^update round 1$", 600)
        mcode, text = scrape(sport, "/metrics")
        hcode, hbody = scrape(sport, "/healthz")
        rc = b.finish(600)
    finally:
        b.kill()
    series = prom_series(text)
    got = (series.get('cxxnet_progress_round{process="0"}'),
           series.get('cxxnet_progress_num_round{process="0"}'))
    log("  continue = 1 with status_port = 0 (%.2f s wall): /metrics %d "
        "(%d series, Prometheus text) with progress round %s of %s, "
        "/healthz %d %r" % (time.perf_counter() - t, mcode, len(series),
                            got[0], got[1], hcode, hbody.strip()))
    if rc != 0 or mcode != 200 or hcode != 200 \
            or got != (1.0, float(CLI_ROUNDS)):
        raise AssertionError("the resumed run's status pages did not "
                             "report round 1 in progress and ready")
    if "resume: fast-forwarded %d batches into round 1" % k \
            not in b.text("out"):
        raise AssertionError("the resumed run did not skip %d batches" % k)
    evs = telemetry_events(os.path.join(models, "b.jsonl"))
    skip = [e for e in evs if e["ev"] == "span"
            and e["name"] == "resume.skip"]
    save = [e for e in evs if e["ev"] == "ckpt_save"]
    log("  resume.skip: %d batches in %.4f s; round-2 ckpt_save %.4f s for "
        "%d bytes" % (k, skip[0]["dur"], save[-1]["seconds"],
                      save[-1]["bytes"]))
    res = open(os.path.join(models, "%04d.model" % CLI_ROUNDS), "rb").read()
    line = [ln for ln in b.text("err").splitlines()
            if ln.startswith("[%d]" % CLI_ROUNDS)]
    rst = ckpt.peek_state(ckpt.read_verified(
        os.path.join(models, "%04d.model" % CLI_ROUNDS))[0])
    dst = ckpt.peek_state(ckpt.read_verified(
        os.path.join(cwd, "models_det", "%04d.model" % CLI_ROUNDS))[0])
    log("  round-%d model of the resumed run vs the uninterrupted run's: "
        "%s (%d bytes: weights, optimizer state, rng_counter %d / %d); "
        "eval line %r vs %r"
        % (CLI_ROUNDS, "BITWISE EQUAL" if res == det else "DIFFERENT",
           len(res), rst["rng_counter"], dst["rng_counter"], line, det_line))
    if res != det or line != det_line or len(line) != 1 \
            or os.path.exists(epath):
        raise AssertionError("the resumed run's round-%d model or eval "
                             "line differs from the uninterrupted run's"
                             % CLI_ROUNDS)
    got_b = b.launches()
    want_b = {"lrn_fwd": 2 * (per_round - k) + 2 * 2 * evals,
              "lrn_fwd_no_norm": 2 * 2 * evals,
              "lrn_bwd": 2 * (per_round - k)}
    log("  LRN launches of the resumed run: %s (expected %s: 2 + 2 for "
        "each of the %d trained batches, none for the %d skipped, 2 "
        "without the norm in each of %d eval batches)"
        % ({n: got_b[n] for n in want_b}, want_b, per_round - k, k,
           2 * evals))
    if {n: got_b[n] for n in want_b} != want_b:
        raise AssertionError("the resumed run's LRN launches are not those "
                             "of the batches it trained")

    # the newest file torn: quarantined, the fallback, and retention
    newest = os.path.join(models, "%04d.model" % CLI_ROUNDS)
    with open(newest, "rb+") as f:
        f.truncate(len(res) // 2)
    t = time.perf_counter()
    # in this process (no signal to send it; one fresh process fewer)
    from cxxnet_tpu_torch import learn_task
    from cxxnet_tpu_torch.ops import lrn
    before = (lrn.launches, lrn.bwd_launches)
    with cudnn_off():
        out_c, err_c = run_cli(learn_task, cwd,
                               base + ["continue=1", "ckpt_keep_last=1"])
    torch.cuda.synchronize()
    got_c = {"lrn_fwd": lrn.launches - before[0],
             "lrn_bwd": lrn.bwd_launches - before[1]}
    left = sorted(nm for nm in os.listdir(models)
                  if nm.endswith((".model", ".corrupt")))
    again = open(newest, "rb").read()
    log("  %04d.model truncated to %d bytes, continue = 1 with "
        "ckpt_keep_last = 1 in this process (%.2f s wall): %s; files left "
        "%s; the new round-%d model vs the uninterrupted run's: %s"
        % (CLI_ROUNDS, len(res) // 2, time.perf_counter() - t,
           " | ".join(ln for ln in err_c.splitlines()
                      if "quarantined" in ln),
           left, CLI_ROUNDS, "BITWISE EQUAL" if again == det
           else "DIFFERENT"))
    if "Init: Continue training from round 2" not in out_c \
            or left != ["%04d.model" % CLI_ROUNDS,
                        "%04d.model.corrupt" % CLI_ROUNDS] \
            or again != det:
        raise AssertionError("the torn file was not quarantined, or the "
                             "fallback or the retention failed")
    want_c = {"lrn_fwd": 2 * per_round + 2 * 2 * evals,
              "lrn_bwd": 2 * per_round}
    if {n: got_c[n] for n in want_c} != want_c:
        raise AssertionError("the fallback run's LRN launches %s are not "
                             "%s" % (got_c, want_c))
    log("  phase wall %.1f s" % (time.perf_counter() - t0))
    return (got_b["lrn_fwd"] + got_c["lrn_fwd"],
            got_b["lrn_bwd"] + got_c["lrn_bwd"])


def round2_lrn_launches(path):
    """(lrn_fwd, lrn_bwd) kernel launches in a torch.profiler Chrome trace
    (the kernels' events of the device's timeline)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [str(e.get("name", "")) for e in events
             if e.get("cat") == "kernel"]
    return (sum(1 for n in names if "lrn_fwd_kernel" in n),
            sum(1 for n in names if "lrn_bwd_kernel" in n))


def run_tool(name, args):
    """The port's offline tool ``cxxnet_tpu_torch.tools.<name>`` on
    ``args``, as ``python -m`` runs it but in this process: (exit code,
    stdout, stderr)."""
    import importlib
    mod = importlib.import_module("cxxnet_tpu_torch.tools." + name)
    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = mod.main(list(args)) or 0
        except SystemExit as e:
            rc = e.code
    log("  python -m cxxnet_tpu_torch.tools.%s %s: exit %d, %.2f s wall"
        % (name, " ".join(os.path.relpath(a, REPO) if a.startswith(REPO)
                          else a for a in args), rc,
           time.perf_counter() - t))
    return rc, out.getvalue(), err.getvalue()


def trace_table(out):
    """{op: (total ms, calls)} of summarize_trace's profiler table."""
    rows = {}
    for ln in out.splitlines()[3:]:
        parts = ln.rsplit(None, 3)
        if len(parts) == 4 and parts[3].endswith("%"):
            rows[parts[0]] = (float(parts[1]), int(parts[2]))
    return rows


def phase_tools_offline(cwd, conf, per_round):
    """The port's offline tools on this run's own outputs in ``cwd``:
    summarize_trace on profile_dir's round-2 trace (its table must count
    that round's LRN launches, ``per_round`` = (forward, backward)),
    telemetry_report on the training run's train.jsonl (exit 0, its round
    spans and the program-ledger section present), ckpt_fsck --deep over
    cli_imagenet_resume's model files and the torn file's quarantined
    copy (that copy bad, the other good; loaded through the port's net
    with ``conf``, the config they were trained with, whose pooling sizes
    a model file does not carry), and roofline's H100 tables."""
    log("phase tools_offline")
    t0 = time.perf_counter()
    rc, out, err = run_tool("summarize_trace", [os.path.join(cwd, "prof"),
                                                "500"])
    rows = trace_table(out)
    if rc != 0 or not rows:
        raise AssertionError("summarize_trace failed on the round-2 trace: "
                             "%s" % err[-2000:])
    for ln in out.splitlines()[:11]:
        log("    | " + ln)
    got = tuple(sum(c for n, (_, c) in rows.items() if k in n)
                for k in ("lrn_fwd_kernel", "lrn_bwd_kernel"))
    for n, (ms, c) in rows.items():
        if "lrn_" in n:
            log("    | %s ... %.2f ms, %d calls" % (n[:40], ms, c))
    log("  summarize_trace: lrn_fwd_kernel %d, lrn_bwd_kernel %d calls "
        "(%d and %d launched in round 2)" % (got + per_round))
    if got != per_round:
        raise AssertionError("summarize_trace's table does not count round "
                             "2's LRN launches")

    rc, out, err = run_tool("telemetry_report",
                            [os.path.join(cwd, "train.jsonl")])
    spans = [ln for ln in out.splitlines() if re.match(r"round\s+\d", ln)]
    lines = out.splitlines()
    for head in ("== rounds ==", "== program ledger"):
        at = [i for i, ln in enumerate(lines) if ln.startswith(head)]
        for ln in lines[at[0]:at[0] + 6] if at else []:
            log("    | " + ln)
    if rc != 0 or not spans or "== rounds ==" not in out \
            or "== program ledger" not in out:
        raise AssertionError("telemetry_report on train.jsonl: exit %d, "
                             "round spans %s, sections missing\n%s"
                             % (rc, spans, (out + err)[-3000:]))
    log("  telemetry_report: exit 0; the round span's row (count %s, total "
        "%s s), the rounds and the program-ledger sections present"
        % tuple(spans[0].split()[1:3]))

    res = os.path.join(cwd, "models_res")
    torn = os.path.join(res, "%04d.model.corrupt" % CLI_ROUNDS)
    rc, out, err = run_tool("ckpt_fsck", ["--deep", "--json", "--conf",
                                          conf, res, torn])
    rep = json.loads(out)
    verdicts = {os.path.relpath(r["path"], cwd): (r["status"], r["reason"])
                for r in rep["checkpoints"]}
    for path, (st, why) in sorted(verdicts.items()):
        log("    | %-8s %s%s" % (st.upper(), path,
                                 "  [%s]" % why if why else ""))
    bad = {p for p, (st, _) in verdicts.items() if st != "ok"}
    if rc != 1 or bad != {os.path.relpath(torn, cwd)} or len(verdicts) < 2:
        raise AssertionError("ckpt_fsck --deep: exit %d, bad %s; want exit "
                             "1 with the quarantined copy alone bad"
                             % (rc, sorted(bad)))
    log("  ckpt_fsck --deep: the quarantined copy bad, the other %d good "
        "(each loaded through the port's net)" % (len(verdicts) - 1))

    for args in ([], ["--decode"]):
        rc, out, err = run_tool("roofline", args)
        for ln in (out + err).splitlines():
            log("    | " + ln)
        if rc != 0 or ("989T peak" not in out and not args) \
                or ("HBM 3350 GB/s" not in out and args):
            raise AssertionError("roofline %s failed" % " ".join(args))
    log("  phase wall %.1f s" % (time.perf_counter() - t0))


# a fresh process that imports torch, numpy and the port's op library only,
# loads the CXTF artifacts of export_forward and export_decode with
# torch.export.load, runs them and reads the launches of the kernels they
# run
EXPORT_RUNNER = """
import io, json, struct, sys, time
import numpy as np
import torch
sys.path.insert(0, %(repo)r)
import cxxnet_tpu_torch.ops.library  # noqa: F401  (the cxxnet:: ops)
from cxxnet_tpu_torch.ops import flash_attn, lrn
job = json.load(open(%(job)r))
res = {}


def load(path, kind):
    data = open(path, "rb").read()
    ver, hlen = struct.unpack("<II", data[4:12])
    meta = json.loads(data[12:12 + hlen])
    assert data[:4] == b"CXTF" and ver == 1 and meta["kind"] == kind
    return meta, torch.export.load(io.BytesIO(data[12 + hlen:])).module()


def kernel_calls(fn, names):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return {n: sum(e.count for e in prof.key_averages() if n in e.key)
            for n in names}


def cuda_ms(fn, iters=10):
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# export_forward: the fixed-batch and the symbolic-batch program
t0 = time.perf_counter()
fw = job["forward"]
x = torch.from_numpy(np.load(fw["x"])).cuda()
_, fixed = load(fw["fixed"], "forward")
_, sym = load(fw["sym"], "forward")
res["forward_load_s"] = time.perf_counter() - t0
lrn.launches = 0       # the main path's count starts here
outs = {}
with torch.no_grad():
    outs["fixed_%%d" %% len(x)] = fixed(x)
    for n in fw["ns"]:
        outs["sym_%%d" %% n] = sym(x[:n])
    torch.cuda.synchronize()
res["forward"] = {"launches": lrn.launches, "calls": len(outs),
                  "per_call": kernel_calls(lambda: sym(x),
                                           ["lrn_fwd_kernel"]),
                  "ms": {"fixed": cuda_ms(lambda: fixed(x)),
                         "sym": cuda_ms(lambda: sym(x))}}
np.savez(fw["out"], **{k: v.float().cpu().numpy() for k, v in outs.items()})
del fixed, sym, outs, x
torch.cuda.empty_cache()

# export_decode: each prefill / step pair, driven by the greedy loop of
# api.load_decode
res["decode"] = []
for pair in job["decode"]:
    t0 = time.perf_counter()
    meta, pre = load(pair["pre"], "decode_prefill")
    smeta, step = load(pair["step"], "decode_step")
    assert meta["cache_fingerprint"] == smeta["cache_fingerprint"]
    load_s = time.perf_counter() - t0
    prompts = torch.from_numpy(np.load(pair["prompts"])).cuda()
    plen, n_new = meta["prompt_len"], pair["n_new"]

    pos = torch.arange(plen, plen + n_new - 1, dtype=torch.int32,
                       device="cuda")

    def greedy():
        probs, caches = pre(prompts)
        tok = probs.argmax(1).to(torch.int32)
        out = [tok]
        for i in range(n_new - 1):
            probs, caches = step(tok, pos[i], caches)
            tok = probs.argmax(1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, 1)

    flash_attn.launches = 0    # the main path's count starts here
    with torch.no_grad():
        toks = greedy()
        torch.cuda.synchronize()
    res["decode"].append({
        "load_s": load_s, "launches": flash_attn.launches,
        "prefill_calls": kernel_calls(lambda: pre(prompts),
                                      ["FlashFwdOut"]),
        "prefill_ms": cuda_ms(lambda: pre(prompts)),
        "loop_ms": cuda_ms(greedy, iters=3)})
    np.save(pair["out"], toks.cpu().numpy())
res["modules"] = sorted(m for m in sys.modules if m.startswith(
    ("jax", "cxxnet_tpu.", "cxxnet_tpu_torch.nnet", "cxxnet_tpu_torch.layer",
     "cxxnet_tpu_torch.api", "cxxnet_tpu_torch.learn_task")))
print("result " + json.dumps(res), flush=True)
"""


def run_export_child(job):
    """EXPORT_RUNNER in a process of its own on ``job`` (the artifacts and
    inputs of both export phases): its result."""
    path = scratch_file("export_job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c",
                          EXPORT_RUNNER % {"repo": REPO, "job": path}],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    m = re.search(r"^result (.*)$", out.stdout, re.M)
    if out.returncode != 0 or m is None:
        raise AssertionError("the loading process failed (exit %d):\n%s"
                             % (out.returncode, out.stderr[-4000:]))
    res = json.loads(m.group(1))
    log("phase export_load")
    log("  a fresh process (torch and cxxnet_tpu_torch.ops.library only) "
        "loaded and ran the artifacts of export_forward and export_decode: "
        "%.2f s wall; the forward programs loaded in %.2f s, the decode "
        "pairs in %s s; other modules of the port or JAX loaded: %s"
        % (time.perf_counter() - t, res["forward_load_s"],
           " / ".join("%.2f" % r["load_s"] for r in res["decode"]),
           res["modules"]))
    if res["modules"]:
        raise AssertionError("the loading process imported %s"
                             % res["modules"])
    return res


EXPORT_NS = (1, 7, BATCH)


def phase_export_forward(api, d):
    """task = export's program of ImageNet.conf at batch 256 (weights from
    SEED), exported into ``d`` at the fixed batch and at a symbolic one,
    for the fresh process of export_load. Returns the job of that process
    and the check to make on its result: the loaded output held to
    api.Net.extract's last node (the pred_raw surface) and its argmax to
    api.Net.predict at n = 1, 7 and 256, and the profiler of that process
    seeing the LRN forward kernel 2 times a call."""
    log("phase export_forward")
    t0 = time.perf_counter()
    net = api.Net(dev=NET_DEV, cfg=imagenet_cfg())
    net.init_model()
    x = np.random.RandomState(SEED + 7).randn(BATCH, 3, 227, 227) \
        .astype(np.float32)
    job = {"x": os.path.join(d, "x.npy"), "ns": list(EXPORT_NS),
           "out": os.path.join(d, "y.npz")}
    for tag, b in (("fixed", 0), ("sym", -1)):
        t = time.perf_counter()
        job[tag] = os.path.join(d, "imagenet.%s.pt2" % tag)
        net.export(job[tag], batch_size=b)
        log("  Net.export(batch_size=%d): %.2f s, %d bytes"
            % (b, time.perf_counter() - t, os.path.getsize(job[tag])))
    np.save(job["x"], x)
    want = torch.from_numpy(net.extract(x, "top[-1]")).reshape(BATCH, -1)
    pred = net.predict(x)
    xd = torch.from_numpy(x).to(DEV)
    plain_ms = time_ms(lambda: net.net_.extract_feature_device(
        xd, "top[-1]"), iters=10)
    del xd
    log("  phase wall %.1f s (the load and the checks come in export_load)"
        % (time.perf_counter() - t0))
    del net
    torch.cuda.empty_cache()

    def check(res):
        got = dict(np.load(job["out"]))
        for key, g in sorted(got.items()):
            n = int(key.split("_")[1])
            g = torch.from_numpy(g).reshape(n, -1)
            check_close("export_forward: the loaded %s program at n = %d vs "
                        "api.Net.extract (bitwise: %s)"
                        % (key.split("_")[0], n,
                           bool(torch.equal(g, want[:n]))),
                        g, want[:n], 1e-5)
            top = g.argmax(1).numpy()
            rows = np.nonzero(top != pred[:n])[0]
            ties = [r for r in rows if float(want[r, top[r]]) >=
                    float(want[r, int(pred[r])]) * (1 - 1e-5)]
            if len(ties) != len(rows):
                raise AssertionError("the loaded program's classes differ "
                                     "from api.Net.predict beyond near-ties")
        log("  export_forward: the argmax of every loaded output equals "
            "api.Net.predict")
        r = res["forward"]
        per = r["per_call"]["lrn_fwd_kernel"]
        log("  export_forward: lrn_fwd launches of the loaded programs: %d "
            "over %d calls; the profiler's capture of one call at n = %d "
            "holds lrn_fwd_kernel %d times" % (r["launches"], r["calls"],
                                               BATCH, per))
        # the launch count is the wrapper's, exact; a capture shows the
        # kernel but has been seen to miss one of a call's launches
        if not 0 < per <= 2 or r["launches"] != 2 * r["calls"]:
            raise AssertionError("the loaded forward does not launch the "
                                 "LRN forward kernel 2 times a call")
        log("  export_forward: the loaded program at batch %d on a batch on "
            "the card: fixed %.3f ms, symbolic %.3f ms a call; the eager "
            "forward (Trainer.extract_feature_device, last node) %.3f ms "
            "(CUDA events)" % (BATCH, r["ms"]["fixed"], r["ms"]["sym"],
                                plain_ms))
        return r["launches"]
    return job, check


# (batch, prompt length) of the exported decode pairs: the prompt length
# of the serving recipe, and the shortest prefill the flash kernel takes
# (ops.flash_attn.supports: L >= 128)
EXPORT_DECODE = ((LM_BATCH, 64), (LM_BATCH, 128))


def phase_export_decode(flash, api, models, d):
    """The bench.py LM in bf16 at full width, its decode loop exported as
    a prefill and a step program (api.save_decode) into ``d`` at each of
    EXPORT_DECODE: api.load_decode's greedy loop generates LM_NEW tokens
    equal to api.Net.generate's, token for token, with one flash forward
    launch a layer in a prefill the kernel takes. Returns the job of
    export_load's fresh process and the check to make on its result: the
    same tokens from the same loop there, and its profiler seeing the
    flash forward kernel in the prefill where the prompt takes it."""
    log("phase export_decode")
    t0 = time.perf_counter()
    net = api.Net(dev=NET_DEV, cfg=bf16_cfg(lm_cfg(models, LM_SEQ,
                                                   LM_BATCH)))
    net.init_model()
    nlayer = LM_ARGS["nlayer"]
    jobs, wants, launches = [], [], 0
    for b, plen in EXPORT_DECODE:
        prompts = np.random.RandomState(SEED + plen).randint(
            0, LM_ARGS["vocab"], (b, plen))
        job = {k: os.path.join(d, "%s%d.%s" % (k, plen, ext)) for k, ext in
               (("pre", "pt2"), ("step", "pt2"), ("prompts", "npy"),
                ("out", "npy"))}
        job["n_new"] = LM_NEW
        t = time.perf_counter()
        api.save_decode(net, job["pre"], job["step"], batch_size=b,
                        prompt_len=plen)
        log("  save_decode(%d, %d): %.2f s, prefill %d bytes, step %d bytes"
            % (b, plen, time.perf_counter() - t,
               os.path.getsize(job["pre"]), os.path.getsize(job["step"])))
        np.save(job["prompts"], prompts.astype(np.int32))
        want = net.generate(prompts, LM_NEW)
        gen_ms = time_ms(lambda: net.generate(prompts, LM_NEW), iters=3,
                         warmup=0)
        flash.launches = 0
        got = api.load_decode(job["pre"], job["step"])(prompts, LM_NEW)
        mine = flash.launches
        flash_in = flash.supports(plen, LM_ARGS["dim"] // LM_ARGS["nhead"])
        log("  (%d, %d): api.load_decode's %d tokens a row %s "
            "api.Net.generate's; flash_fwd launches %d (%s)"
            % (b, plen, LM_NEW, "EQUAL to" if (got == want).all()
               else "DIFFERENT from", mine,
               "one a layer" if flash_in else
               "the prompt is below the flash kernel's 128"))
        want_per = nlayer if flash_in else 0
        if not (got == want).all() or mine != want_per:
            raise AssertionError("api.load_decode's tokens or its flash "
                                 "launches are wrong")
        launches += mine
        jobs.append(job)
        wants.append((b, plen, want, want_per, gen_ms))
    log("  phase wall %.1f s (the fresh process's load and checks come in "
        "export_load)" % (time.perf_counter() - t0))
    del net
    torch.cuda.empty_cache()

    def check(res):
        total = launches
        for job, r, (b, plen, want, want_per, gen_ms) in zip(
                jobs, res["decode"], wants):
            child = np.load(job["out"])
            per = r["prefill_calls"]["FlashFwdOut"]
            log("  export_decode (%d, %d): the fresh process's %d tokens a "
                "row %s api.Net.generate's; flash_fwd launches %d, "
                "FlashFwdOut %d times in one prefill; its loaded prefill "
                "%.3f ms, its greedy loop (the prefill and %d steps) %.1f "
                "ms against api.Net.generate's %.1f ms (CUDA events)"
                % (b, plen, LM_NEW, "EQUAL to" if (child == want).all()
                   else "DIFFERENT from", r["launches"], per,
                   r["prefill_ms"], LM_NEW - 1, r["loop_ms"], gen_ms))
            if not (child == want).all() or r["launches"] != want_per \
                    or not (0 < per <= want_per or per == want_per == 0):
                raise AssertionError("the loaded decode pair's tokens or "
                                     "its flash launches are wrong")
            total += r["launches"]
        return total
    return {"decode": jobs}, check


def phase_exports(flash, api, models):
    """export_forward and export_decode, then export_load: one fresh
    process loads and runs both phases' artifacts, and each phase's
    checks are made on its result. Returns the LRN forward and the flash
    forward launches of the exported programs (in both processes)."""
    t0 = time.perf_counter()
    with scratch_dir("export") as d:
        fjob, fcheck = phase_export_forward(api, d)
        djob, dcheck = phase_export_decode(flash, api, models, d)
        res = run_export_child(dict(djob, forward=fjob))
        got = fcheck(res), dcheck(res)
    log("  export phases wall %.1f s" % (time.perf_counter() - t0))
    return got


def phase_cli_imagenet(lrn, learn_task, api):
    """example/ImageNet/ImageNet.conf through the CLI on the card at full
    width (imgbin + threadbuffer, random crops and mirrors, the mean image
    created on first use): two training rounds held to the same batches
    driven through api.Net.update, the input pipeline's rates, then
    task=pred / extract / pred_raw from the round-2 model held to
    api.Net.predict / extract; between the two, cli_imagenet_resume. The
    training run writes a telemetry log and profile_dir's torch.profiler
    trace of round 2, which must hold exactly that round's LRN launches;
    its performance ledger's jit.train_step card must be ready with the
    work account's flops (a wiring check: the card takes its flops from
    nnet/cost.py through Program.cost, so this shows the card is present,
    ready and fed by the account; the account itself is held to XLA's
    count in tests/test_torch_cost.py), and the phase prints the step's
    MFU against its own synchronized step time beside the card's mfu_pct.
    The main run's second round (round 1 in its lines) runs under the
    profiler, so only its first round's rate is a plain one. Returns the LRN
    (forward, backward) launches counted on the training path, the forward
    launches on the prediction path and the (forward, backward) launches
    of the resumed runs."""
    from cxxnet_tpu_torch.nnet import cost
    from cxxnet_tpu_torch.utils import perf
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
        perf.reset()
        lrn.launches = lrn.no_norm_launches = lrn.bwd_launches = 0
        t = time.perf_counter()
        out, err = run_cli(learn_task, cwd, args + [
            "profile_dir=prof", "telemetry_log=train.jsonl"])
        wall = time.perf_counter() - t
        train = (lrn.launches, lrn.bwd_launches, lrn.no_norm_launches)
        # the ledger's snapshot joins the run's train.step histogram,
        # which stays in the registry until telemetry is enabled again
        card = [c for c in perf.ledger().snapshot()["cards"]
                if c["name"] == "jit.train_step"]
        round2 = round2_lrn_launches(os.path.join(cwd, "prof",
                                                  "trace.json"))
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
        PPM_ROUND_RATES[:] = rates
        log("  rounds (input-wait %%, io img/s when blocked, step img/s; "
            "round 1 under profile_dir's torch.profiler): %s" % rates)
        per_round = (2 * (steps + evals) // CLI_ROUNDS,
                     2 * steps // CLI_ROUNDS)
        log("  profile_dir trace of round 2: lrn_fwd_kernel %d, "
            "lrn_bwd_kernel %d launches (%d and %d expected: 2 + 2 a step, "
            "2 without the norm an eval batch)" % (round2 + per_round))
        if round2 != per_round:
            raise AssertionError("the round-2 trace does not hold exactly "
                                 "that round's LRN launches")

        # the CLI again and the same batches through api.Net.update, both
        # with cuDNN off: cuDNN's algorithms need not sum in one order from
        # call to call, and over these 8 steps (random labels, dropout on)
        # such differences grew to 8% of the largest update (run 1), while
        # PyTorch's native convolutions repeat bit for bit. The same seed
        # gives the same initial weights; each side makes its own mean
        # image (image_mean), drawing the crops and mirrors of that pass
        net = api.Net(dev=NET_DEV, cfg=conf_text)
        with cudnn_off():
            _, det_err = run_cli(learn_task, cwd, args + [
                "model_dir=models_det", "image_mean=models_det/mean",
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
        # a wiring check: the card's flops come from this same account
        # (Program.cost); the account is held to XLA's in test_torch_cost.py
        want = cost.train_step_cost(net.net_.net, net.net_.params,
                                    net.net_.updaters)
        if len(card) != 1 or card[0]["status"] != "ready" \
                or card[0]["flops"] != want["flops"]:
            raise AssertionError("the jit.train_step card is not ready with "
                                 "the work account's flops (%s, want %r)"
                                 % (card, want["flops"]))
        card = card[0]
        log("  jit.train_step card: flops %.6g (nnet/cost.py: %.6g), bytes "
            "%.6g, predicted %.4f ms, compile %.3f s, peak %s bytes, "
            "measured p50 %s ms over %d steps (the step's dispatch), "
            "mfu_pct %s" % (card["flops"], want["flops"],
                            card["bytes_accessed"],
                            1e3 * card["predicted_s"], card["compile_s"],
                            card["peak_bytes"], card["measured_p50_ms"],
                            card["measured_n"], card["mfu_pct"]))
        cli_net = api.Net(dev=NET_DEV, cfg=conf_text)
        cli_net.load_model(os.path.join(cwd, "models_det/%04d.model"
                                        % CLI_ROUNDS))
        compare_params("round-%d model of the CLI vs the same batches "
                       "through api.Net.update (cuDNN off on both)"
                       % CLI_ROUNDS, _params(cli_net), _params(net), start,
                       STEP_RTOL, STEP_ATOL_UPDATE)
        del cli_net, start
        torch.cuda.empty_cache()
        log("  phase wall %.1f s" % (time.perf_counter() - t0))
        resume = phase_cli_imagenet_resume(cwd, conf, det_err)
        phase_tools_offline(cwd, conf, per_round)
        health = phase_cli_imagenet_health(lrn, learn_task, api, cwd, conf)
        t0 = time.perf_counter()
        log("phase cli_imagenet_train (continued)")

        # the host pipeline alone (test_io), with one and four decode
        # threads (imgbinx's pool), IO_ROUNDS rounds a run, the
        # first round of each run (the loader's start) set apart; then
        # four trained under the profiler; none of these runs saves a model
        io_only = {1: [], 4: []}
        for threads in (1, 4):
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
        batch = data_batch(x, y, DEV)
        step_s = BATCH / per_s(lambda: net.net_.update(batch), BATCH,
                               iters=MFU_STEPS)
        log("  MFU of the step: card flops %.6g / (%.3f ms synchronized "
            "step, %d steps on the card's batch x %.0f TFLOP/s) = %.3f%%; "
            "the card's mfu_pct (its p50 times the dispatch) %s"
            % (card["flops"], 1e3 * step_s, MFU_STEPS,
               H100.peak_flops / 1e12,
               100.0 * card["flops"] / (step_s * H100.peak_flops),
               card["mfu_pct"]))
        del net, batch
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
    return train, pred, resume, health


# cli_imagenet_health: the batch tests/test_health_faults.py tampers with,
# the second batch (position 1) of the trainer's round 2 (learn-task round
# 1), mid-run after a good checkpoint exists
HEALTH_TARGET = (2, 1)
# every run of the phase: ImageNet.conf's 2 rounds on cli_imagenet_train's
# pack, a model saved each round (a rollback needs the round-1 file), the
# round budget one larger for the rollback's replay; checkpoints unsynced
HEALTH_EXTRA = ["max_round=%d" % (CLI_ROUNDS + 1), "ckpt_fsync=0"]
HEALTH_WATCHDOG_S = 30


def health_run(lrn, learn_task, cwd, args, name, extra, step):
    """One ImageNet.conf training run through learn_task.main with every
    ``Trainer.update`` call replaced by ``step(trainer, batch, orig)``
    (True where it trained) and timed between two synchronizations. The
    LRN counts start at 0 here and are read right after. Returns (step ms
    of the trained calls, LRN counts, stdout and stderr, model dir)."""
    from cxxnet_tpu_torch.nnet.trainer import Trainer
    orig = Trainer.update
    ms = []

    def timed(self, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trained = step(self, batch, orig)
        torch.cuda.synchronize()
        if trained:
            ms.append(1e3 * (time.perf_counter() - t))

    lrn.launches = lrn.no_norm_launches = lrn.bwd_launches = 0
    Trainer.update = timed
    try:
        out, err = run_cli(learn_task, cwd, args + ["model_dir=" + name]
                           + extra, echo=("[", "health", "update round"))
    finally:
        Trainer.update = orig
    counts = (lrn.launches, lrn.bwd_launches, lrn.no_norm_launches)
    d = os.path.join(cwd, name)
    for f in os.listdir(d):              # keep the last round's file only
        if f != "%04d.model" % CLI_ROUNDS:
            os.remove(os.path.join(d, f))
    evals = len(re.findall(r"^round \d+: input-wait", out, re.M)) \
        * (CLI_TEST_IMAGES // BATCH)
    log("  %s: %d steps, step ms median %.3f (%.3f-%.3f, each between two "
        "synchronizations); lrn_fwd %d (%d storing no norm), lrn_bwd %d"
        % (name, len(ms), float(np.median(ms)), min(ms), max(ms),
           counts[0], counts[2], counts[1]))
    if counts != (2 * len(ms) + 2 * evals, 2 * len(ms), 2 * evals):
        raise AssertionError(
            "%s: expected 2 + 2 LRN launches in each of %d steps and 2 "
            "without a norm in each of %d eval batches; counted %s"
            % (name, len(ms), evals, counts))
    return ms, counts, out + err, d


def phase_cli_imagenet_health(lrn, learn_task, api, cwd, conf):
    """ImageNet.conf's training under the health monitor on the card, at
    full width, on cli_imagenet_train's pack (2 rounds, a model saved each
    round), all in process with cuDNN off (its algorithms need not sum in
    one order from run to run; the native convolutions repeat bit for
    bit): a control run that records every batch's key (trainer round,
    first instance id, tests/faultinject.py's ``recording_update``) and
    drops HEALTH_TARGET's batch; a counted control that drops it but
    counts the step (the rng stream and the epoch counter move, as a
    suppressed step moves them); a run whose target batch is NaN with
    ``health_monitor = 1``, which must roll back, replay without it and
    end on the control's model file bit for bit; the same with
    ``nonfinite_action = skip``, every update under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in the
    guarded step raises), which must not roll back and must end on the
    counted control's file bit for bit; the skip run also runs the
    watchdog (``watchdog_timeout = 30``, ``watchdog_action = abort``, the
    LRN libraries loaded again at their first use in the run), which must
    record no stall (a stall would end this process with exit code 70).
    Prints the step's median time with the monitor off, on, and on with
    the skip guard, and the health vector's and the guard's cost alone.
    Returns {run: (lrn_fwd, lrn_bwd, no-norm)}."""
    from cxxnet_tpu_torch.ops import _build
    from cxxnet_tpu_torch.utils import checkpoint as ckpt
    log("phase cli_imagenet_health")
    t0 = time.perf_counter()
    args = [conf, "num_round=%d" % CLI_ROUNDS, "dev=" + NET_DEV] \
        + HEALTH_EXTRA
    # every run must find the mean image made: a run that makes it draws
    # crops and mirrors for it, and its batches then differ from the others'
    if not os.path.isfile(os.path.join(cwd, "models", "image_net_mean.bin")):
        raise AssertionError("cli_imagenet_health runs after a run that "
                             "made the pack's mean image")
    launches = {}
    keys = []
    rnd, pos = HEALTH_TARGET
    target = None

    def control(tr, batch, orig):
        here = sum(1 for r, _ in keys if r == tr.round)
        keys.append((tr.round, int(batch.inst_index[0])))
        if (tr.round, here) == HEALTH_TARGET:
            return False
        orig(tr, batch)
        return True

    def hit(tr, batch):
        return tr.round == rnd and int(batch.inst_index[0]) == target

    def counted(tr, batch, orig):
        if hit(tr, batch):
            # what update does on the host around a step (update_period 1)
            tr._rng_counter += 1
            tr.epoch_counter += 1
            return False
        orig(tr, batch)
        return True

    def nan(tr, batch, orig):
        if hit(tr, batch):
            batch = batch.shallow_copy()
            batch.data = np.full(tuple(np.shape(batch.data)), np.nan,
                                 np.float32)
        orig(tr, batch)
        return True

    def no_sync(tr, batch, orig):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return nan(tr, batch, orig)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    with cudnn_off():
        ms_off, launches["control"], _, ctl = health_run(
            lrn, learn_task, cwd, args, "health_control", [], control)
        target = [k for r, k in keys if r == rnd][pos]
        log("  HEALTH_TARGET %s: first instance id %d (recorded by the "
            "control run, which dropped it)" % (HEALTH_TARGET, target))
        _, launches["counted_control"], _, cnt = health_run(
            lrn, learn_task, cwd, args, "health_counted", [], counted)
        ms_on, launches["nan_rollback"], out, roll = health_run(
            lrn, learn_task, cwd, args, "health_rollback",
            ["health_monitor=1"], nan)
        if "health: rolled back to round" not in out \
                or "nonfinite at round %d batch %d" % (rnd - 1, pos) \
                not in out:
            raise AssertionError("the NaN run did not roll back from its "
                                 "target batch")
        _build._libs.clear()     # the run loads the kernels at first use
        ms_skip, launches["nan_skip"], out, skip = health_run(
            lrn, learn_task, cwd, args, "health_skip",
            ["health_monitor=1", "nonfinite_action=skip",
             "watchdog_timeout=%d" % HEALTH_WATCHDOG_S,
             "watchdog_action=abort"], no_sync)
        if "skip (update suppressed on device)" not in out \
                or "rolled back" in out:
            raise AssertionError("the skip run did not suppress its target "
                                 "step on the card without a rollback")
        if "WATCHDOG" in out:
            raise AssertionError("the watchdog recorded a stall")
        log("  the skip run's watchdog (timeout %d s, abort): no stall"
            % HEALTH_WATCHDOG_S)
    # a file's framing is a function of its payload: equal verified
    # payloads are equal files
    files = {n: ckpt.read_verified(os.path.join(
        d, "%04d.model" % CLI_ROUNDS))[0] for n, d in (
            ("control", ctl), ("counted", cnt), ("rollback", roll),
            ("skip", skip))}
    states = {n: ckpt.peek_state(p) for n, p in files.items()}
    for got, want in (("rollback", "control"), ("skip", "counted")):
        if files[got] != files[want]:
            raise AssertionError("the %s run's round-%d model file is not "
                                 "bitwise the %s run's" % (got, CLI_ROUNDS,
                                                            want))
        log("  %s run's round-%d model file (a %d-byte payload) bitwise "
            "the %s run's; rng_counter %d = %d" % (
                got, CLI_ROUNDS, len(files[got]), want,
                states[got]["rng_counter"], states[want]["rng_counter"]))
    log("  the skip run against the plain control: files %s, rng_counter "
        "%d against %d (the suppressed step took its dropout draw and its "
        "epoch, which the plain control never took)"
        % ("equal" if files["skip"] == files["control"] else "differ",
           states["skip"]["rng_counter"], states["control"]["rng_counter"]))
    log("  step ms medians at batch %d (cuDNN off): health_monitor = 0 "
        "%.3f, health_monitor = 1 %.3f (%+.3f), + nonfinite_action = skip "
        "%.3f (%+.3f)" % (BATCH, float(np.median(ms_off)),
                          float(np.median(ms_on)),
                          float(np.median(ms_on) - np.median(ms_off)),
                          float(np.median(ms_skip)),
                          float(np.median(ms_skip) - np.median(ms_off))))
    health_costs(api)
    log("  phase wall %.1f s" % (time.perf_counter() - t0))
    return launches


def health_costs(api):
    """The health vector and the skip guard alone on ImageNet.conf's
    trainer at batch BATCH (CUDA events, the gradients of one step): the
    guard copies the stepped weights and the momentum into its shadow and
    selects them back, five passes over their bytes."""
    net = api.Net(dev=NET_DEV, cfg=imagenet_cfg())
    net.init_model()
    tr = net.net_
    x = np.random.RandomState(SEED + 5).randn(BATCH, 3, 227, 227) \
        .astype(np.float32)
    y = np.random.RandomState(SEED + 6).randint(0, 1000, BATCH) \
        .astype(np.float32)
    loss, grads = tr.loss_and_grads(data_batch(x, y, DEV))
    keys = tr._update_keys()
    flat = [grads[i][k] for i, k in keys]
    vec_ms = time_ms(lambda: tr._health_vector(loss, flat))
    ok = torch.ones((), dtype=torch.bool, device=DEV)
    guard_ms = time_ms(lambda: tr._guard_end(tr._guard_begin(keys), ok))
    nbytes = sum(t.numel() * t.element_size() for t in tr._guard_live(keys))
    grad_bytes = sum(g.numel() * g.element_size() for g in flat)
    log("  alone at batch %d: the health vector %.4f ms (bound %.4f ms: "
        "the gradients' %d bytes read once); the skip guard %.4f ms over "
        "%d bytes of weights and momentum (bound %.4f ms: 5 passes)"
        % (BATCH, vec_ms, 1e3 * grad_bytes / HBM_BYTES_PER_S, grad_bytes,
           guard_ms, nbytes, 1e3 * 5 * nbytes / HBM_BYTES_PER_S))
    del net, tr, grads, flat
    torch.cuda.empty_cache()


C_ABI_UPDATES = 2
C_ABI_TIMED = 3
C_ABI_NODE = "top[-1]"


def c_abi_bind(lib):
    """Argument and result types of the C ABI entry points this script
    calls; returns the float and uint32 pointer types."""
    import ctypes
    F = ctypes.POINTER(ctypes.c_float)
    U = ctypes.POINTER(ctypes.c_uint32)
    vp = ctypes.c_void_p
    for name, res, argt in (
            ("CXNGetLastError", ctypes.c_char_p, []),
            ("CXNNetCreate", vp, [ctypes.c_char_p, ctypes.c_char_p]),
            ("CXNNetFree", None, [vp]),
            ("CXNNetInitModel", ctypes.c_int, [vp]),
            ("CXNNetUpdateBatch", ctypes.c_int, [vp, F, U, F, U]),
            ("CXNNetPredictBatch", F, [vp, F, U, U]),
            ("CXNNetExtractBatch", F, [vp, F, U, ctypes.c_char_p, U])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = argt
    return F, U


def phase_c_abi_imagenet(lrn, api):
    """The port's C ABI (csrc/wrapper/cxxnet_wrapper.cc, built by
    ``native.wrapper_library()``): the unchanged wrapper/test_wrapper.c
    compiled against it and run in a process of its own (its legs ask for
    "cpu"); then the library loaded with ctypes into this process drives
    ImageNet.conf's net on "gpu" at batch BATCH (CXNNetCreate, InitModel,
    C_ABI_UPDATES UpdateBatch calls on one seeded batch, PredictBatch,
    ExtractBatch of C_ABI_NODE) held bitwise to api.Net driven the same
    way in this process, cuDNN off on both; the LRN launches of the C
    ABI's calls counted; the wall of an UpdateBatch against api.Net.update
    (C_ABI_TIMED more calls each, between two synchronizations). Returns
    the C ABI's (lrn_fwd, lrn_bwd, no-norm) launches."""
    import ctypes
    import sysconfig
    from cxxnet_tpu_torch.utils import native
    log("phase c_abi_imagenet")
    t0 = time.perf_counter()
    path = native.wrapper_library()
    log("  C ABI %s built in %.2f s (libpython shared: %s)"
        % (os.path.relpath(path, REPO), time.perf_counter() - t0,
           sysconfig.get_config_var("Py_ENABLE_SHARED")))
    with scratch_dir("c_abi") as d:
        exe = os.path.join(d, "test_wrapper_c")
        subprocess.run([os.environ.get("CC") or "gcc", "-O2", "-Wall",
                        "-pthread", "-I", native.WRAPPER_SRC, "-o", exe,
                        os.path.join(REPO, "wrapper", "test_wrapper.c"),
                        path, "-Wl,-rpath," + os.path.dirname(path),
                        *native.embed_ldflags()],
                       check=True, capture_output=True, timeout=300)
        env = dict(os.environ)
        env.pop("CXXNET_TPU_ROOT", None)
        t = time.perf_counter()
        r = subprocess.run([exe], cwd=d, env=env, capture_output=True,
                           text=True, timeout=600)
        passed = [ln for ln in r.stderr.splitlines() if "PASSED" in ln]
        log("  wrapper/test_wrapper.c against the twin: exit %d in %.2f s; "
            "%s" % (r.returncode, time.perf_counter() - t,
                    "; ".join(passed)))
        if r.returncode != 0 or len(passed) != 3:
            raise AssertionError("test_wrapper.c failed against the C ABI: "
                                 + r.stderr[-2000:])

    lib = ctypes.CDLL(path)
    F, U = c_abi_bind(lib)
    cfg = imagenet_cfg()
    x = np.ascontiguousarray(np.random.RandomState(SEED + 7).randn(
        BATCH, 3, 227, 227).astype(np.float32))
    y = np.random.RandomState(SEED + 8).randint(0, 1000, (BATCH, 1)) \
        .astype(np.float32)
    ds = (ctypes.c_uint32 * 4)(*x.shape)
    ls = (ctypes.c_uint32 * 2)(*y.shape)
    xp, yp = x.ctypes.data_as(F), y.ctypes.data_as(F)
    h = None

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    def c_update():
        if lib.CXNNetUpdateBatch(h, xp, ds, yp, ls) != 0:
            raise AssertionError("CXNNetUpdateBatch: "
                                 + lib.CXNGetLastError().decode())

    with cudnn_off():
        lrn.launches = lrn.no_norm_launches = lrn.bwd_launches = 0
        h = lib.CXNNetCreate(NET_DEV.encode(), cfg.encode())
        if not h or lib.CXNNetInitModel(h) != 0:
            raise AssertionError("CXNNetCreate / InitModel on %s: %s"
                                 % (NET_DEV, lib.CXNGetLastError().decode()))
        c_ms = [timed(c_update) for _ in range(C_ABI_UPDATES)]
        n = ctypes.c_uint32()
        p = lib.CXNNetPredictBatch(h, xp, ds, ctypes.byref(n))
        c_pred = np.ctypeslib.as_array(p, (n.value,)).copy()
        es = (ctypes.c_uint32 * 2)()
        e = lib.CXNNetExtractBatch(h, xp, ds, C_ABI_NODE.encode(), es)
        c_ext = np.ctypeslib.as_array(e, (es[0], es[1])).copy()
        counts = (lrn.launches, lrn.bwd_launches, lrn.no_norm_launches)
        c_ms += [timed(c_update) for _ in range(C_ABI_TIMED)]
        lib.CXNNetFree(h)
        torch.cuda.empty_cache()
        net = api.Net(dev=NET_DEV, cfg=cfg)
        net.init_model()
        py_ms = [timed(lambda: net.update(x, y))
                 for _ in range(C_ABI_UPDATES)]
        want_pred = net.predict(x)
        want_ext = net.extract(x, C_ABI_NODE).reshape(BATCH, -1)
        py_ms += [timed(lambda: net.update(x, y))
                  for _ in range(C_ABI_TIMED)]
        del net
        torch.cuda.empty_cache()
    log("  C ABI on %s at batch %d: lrn_fwd %d (%d storing no norm), "
        "lrn_bwd %d over %d UpdateBatch, PredictBatch and ExtractBatch"
        % (NET_DEV, BATCH, counts[0], counts[2], counts[1], C_ABI_UPDATES))
    want = (2 * C_ABI_UPDATES + 4, 2 * C_ABI_UPDATES, 4)
    if counts != want:
        raise AssertionError("C ABI LRN launches %s, expected %s"
                             % (counts, want))
    if not (np.array_equal(c_pred, want_pred)
            and np.array_equal(c_ext, want_ext)):
        raise AssertionError(
            "the C ABI's PredictBatch / ExtractBatch after %d UpdateBatch "
            "differ from api.Net's (max |diff| %g)"
            % (C_ABI_UPDATES, float(np.abs(c_ext - want_ext).max())))
    log("  PredictBatch (%d rows) and ExtractBatch %s %s after %d "
        "UpdateBatch: bitwise api.Net's" % (len(c_pred), C_ABI_NODE,
                                           c_ext.shape, C_ABI_UPDATES))
    log("  wall per update (ms, between two synchronizations): "
        "CXNNetUpdateBatch %s, median of the last %d %.3f; api.Net.update "
        "%s, %.3f" % (" ".join("%.3f" % v for v in c_ms), C_ABI_TIMED,
                      float(np.median(c_ms[-C_ABI_TIMED:])),
                      " ".join("%.3f" % v for v in py_ms),
                      float(np.median(py_ms[-C_ABI_TIMED:]))))
    log("  phase wall %.1f s" % (time.perf_counter() - t0))
    return counts


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

# ---------------------------------------------------------------- JPEG
# the committed fixtures (tests/data/jpeg) and their libjpeg-turbo hashes
JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
# the warp held to warp_affine_ref: bowl.conf's draws at these sizes
WARP_SIZES, WARP_CASES = (48, 256), 20
BOWL_KEYS = dict(max_rotate_angle=180, max_aspect_ratio=0.5,
                 max_shear_ratio=0.3)
# the JPEG ImageNet pack (cli_imagenet_jpeg): 256x256 4:2:0 at quality 90,
# every 4th record with a restart marker every 4 MCUs; the numpy encoder
# takes ~0.1 s a record on the card machine's host, so JPEG_DISTINCT
# images are encoded and repeat under their own labels
JPEG_TRAIN, JPEG_TEST, JPEG_HW, JPEG_DISTINCT = 1024, 256, 256, 64
JPEG_ROUNDS = 1
# decoder-alone images/s: this many records of the pack, in turns at 1 and
# 4 threads
DECODE_RATE_RECORDS = 160
# bowl.conf (cli_bowl_train): 1,210 48x48 JPEG images in 121 classes,
# split as example/kaggle_bowl/run.sh splits its synthetic corpus
BOWL_TRAIN, BOWL_VAL, BOWL_ROUNDS = 1100, 110, 2
# extra command-line keys of cli_imagenet_jpeg's runs (none on the card;
# a CPU rehearsal shrinks the batch)
JPEG_CLI_EXTRA = []
_JPEG_RECORDS = {}


def jpeg_pack_records(name):
    """(label, bytes) of the JPEG ImageNet pack's train or test part, made
    once per process."""
    from cxxnet_tpu_torch.io import synth
    for th in _HOST_THREAD:
        if th is not threading.current_thread():
            th.join()
    if name not in _JPEG_RECORDS:
        n, seed = (JPEG_TRAIN, SEED) if name == "train" \
            else (JPEG_TEST, SEED + 1)
        t = time.perf_counter()
        _JPEG_RECORDS[name] = list(synth.jpeg_records(
            n, JPEG_HW, 1000, seed, quality=90, subsampling="420",
            restart=4, restart_every=4, distinct=JPEG_DISTINCT))
        log("  JPEG %s records: %d of %dx%d 4:2:0 (%d encoded, %.1f KB "
            "mean) in %.2f s" % (name, n, JPEG_HW, JPEG_HW,
                                 min(n, JPEG_DISTINCT),
                                 np.mean([len(r) for _, r in
                                          _JPEG_RECORDS[name]]) / 1e3,
                                 time.perf_counter() - t))
    return _JPEG_RECORDS[name]


def decode_rates(native, recs, threads):
    """Images/s of the decoder alone over ``recs`` on ``threads``
    threads."""
    from concurrent.futures import ThreadPoolExecutor
    t = time.perf_counter()
    if threads == 1:
        for r in recs:
            native.decode_jpeg_chw(r)
    else:
        with ThreadPoolExecutor(threads) as pool:
            for _ in pool.map(native.decode_jpeg_chw, recs):
                pass
    return len(recs) / (time.perf_counter() - t)


def phase_jpeg_decode():
    """The host library built from csrc/host on the card's machine; the
    committed fixtures decoded to libjpeg-turbo's hashes; the C++ warp
    bitwise warp_affine_ref on bowl.conf's draws; the decoder's images/s
    alone at 1 and 4 threads."""
    import hashlib
    from cxxnet_tpu_torch.io import iter_image, warp
    from cxxnet_tpu_torch.utils import native
    log("phase jpeg_decode")
    t0 = time.perf_counter()
    path = native.build()
    native.load()
    log("  host library %s built in %s s (%s %s)"
        % (os.path.relpath(path, REPO),
           "%.2f" % native.build_seconds if native.build_seconds is not None
           else "0 (built already)", native._compiler(),
           " ".join(native.CXX_FLAGS)))
    expected = json.load(open(os.path.join(JPEG_FIXTURES, "expected.json")))
    for name in sorted(expected):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            out = native.decode_jpeg_chw(f.read())
        hwc = np.ascontiguousarray(out.transpose(1, 2, 0).astype(np.uint8))
        if list(hwc.shape) != expected[name]["shape"] or \
                hashlib.sha256(hwc.tobytes()).hexdigest() \
                != expected[name]["sha256"]:
            raise AssertionError("fixture %s does not decode to "
                                 "libjpeg-turbo's pixels" % name)
    log("  %d fixtures (%s): every decode's SHA-256 libjpeg-turbo's"
        % (len(expected), ", ".join(n[:-4] for n in sorted(expected))))
    aug = iter_image.GeometricAugmenter()
    for k, v in BOWL_KEYS.items():
        aug.set_param(k, str(v))
    rs = np.random.RandomState(SEED + 20)
    for hw in WARP_SIZES:
        for k in range(WARP_CASES):
            src = rs.randint(0, 256, (hw, hw, 3), np.uint8)
            M, out_hw = aug.draw_matrix(hw, hw, rs)
            inv = warp.inverse_map(M)
            fill = (255, 0, 17)[k % 3]
            if not np.array_equal(native.warp_affine(src, inv, out_hw, fill),
                                  warp.warp_affine_ref(src, inv, out_hw,
                                                       fill)):
                raise AssertionError("the C++ warp differs from "
                                     "warp_affine_ref at %dx%d, case %d"
                                     % (hw, hw, k))
    log("  warp: the C++ warp bitwise warp_affine_ref on %d matrices of "
        "bowl.conf's draws at each of %s" % (WARP_CASES, WARP_SIZES))
    recs = [r for _, r in jpeg_pack_records("train")[:DECODE_RATE_RECORDS]]
    rates = {1: [], 4: []}
    for threads in (1, 4, 1, 4):
        rates[threads].append(decode_rates(native, recs, threads))
    log("  decoder alone, %d records of %dx%d 4:2:0, images/s in turns: 1 "
        "thread %s, 4 threads %s (%d host cores)"
        % (len(recs), JPEG_HW, JPEG_HW,
           " / ".join("%.1f" % r for r in rates[1]),
           " / ".join("%.1f" % r for r in rates[4]), os.cpu_count()))
    log("  phase wall %.1f s" % (time.perf_counter() - t0))


def routes_since(iter_image, before):
    return {k: iter_image.decode_routes[k] - before[k] for k in before}


def host_passes(iter_image, mean_path, n=64):
    """The host's passes of one record of the JPEG pack, timed one by one
    on this thread: the decode (C++, off the GIL, in the pool on the CLI's
    path) and ImageNet.conf's augmentation (random crop to 227, mirror,
    the mean image subtracted: numpy on the loader thread, under the
    GIL)."""
    from cxxnet_tpu_torch.io.data import DataInst
    from cxxnet_tpu_torch.utils import serializer
    recs = [r for _, r in jpeg_pack_records("train")[:n]]
    n = len(recs)
    t = time.perf_counter()
    imgs = [iter_image.decode_image(r) for r in recs]
    dec = (time.perf_counter() - t) / n
    aug = iter_image.AugmentIterator(iter_image.ImagePageIterator())
    for k, v in (("input_shape", "3,227,227"), ("rand_crop", "1"),
                 ("rand_mirror", "1"), ("silent", "1")):
        aug.set_param(k, v)
    with open(mean_path, "rb") as f:
        f.read(len(aug._MEAN_MAGIC))
        aug.meanimg = serializer.Reader(f).read_tensor()
    aug.name_meanimg, aug.meanfile_ready = mean_path, True
    t = time.perf_counter()
    for i, img in enumerate(imgs):
        aug._set_data(DataInst(img, np.zeros(1, np.float32), i))
    log("  host passes of a %dx%d record, one at a time (%d records): "
        "decode %.3f ms (C++, off the GIL), crop + mirror + mean image "
        "%.3f ms (numpy, under the GIL)"
        % (JPEG_HW, JPEG_HW, n, 1e3 * dec,
           1e3 * (time.perf_counter() - t) / n))


def phase_cli_imagenet_jpeg(lrn, learn_task, api):
    """example/ImageNet/ImageNet.conf read unchanged, from the CLI, for one
    round at full width on a JPEG pack (the port's decoder, decode_thread=4
    decode_timeout=30), then again with cuDNN off against the same batches
    through api.Net.update. Returns the LRN (forward, backward) launches of
    the main run."""
    from cxxnet_tpu_torch.io import iter_image
    log("phase cli_imagenet_jpeg")
    t0 = time.perf_counter()
    conf = os.path.join(REPO, "example/ImageNet/ImageNet.conf")
    with scratch_dir("cli_imagenet_jpeg") as root:
        from cxxnet_tpu_torch.io import synth
        for lst, binp, part in (("NameList.train", "TRAIN.BIN", "train"),
                                ("NameList.test", "TEST.BIN", "test")):
            synth.write_pack(jpeg_pack_records(part),
                             os.path.join(root, lst),
                             os.path.join(root, binp))
        cwd = os.path.join(root, "a", "b")
        os.makedirs(cwd)
        args = [conf, "num_round=%d" % JPEG_ROUNDS,
                "max_round=%d" % JPEG_ROUNDS, "dev=" + NET_DEV,
                "decode_thread=4", "decode_timeout=30"] + JPEG_CLI_EXTRA
        steps = JPEG_ROUNDS * (JPEG_TRAIN // BATCH)
        evals = JPEG_ROUNDS * (JPEG_TEST // BATCH)
        # the main path: the counts start at 0 here and are read right after
        before = dict(iter_image.decode_routes)
        lrn.launches = lrn.no_norm_launches = lrn.bwd_launches = 0
        t = time.perf_counter()
        out, err = run_cli(learn_task, cwd, args)
        wall = time.perf_counter() - t
        train = (lrn.launches, lrn.bwd_launches, lrn.no_norm_launches)
        routes = routes_since(iter_image, before)
        log("  %d round in %.2f s wall (mean image, init and eval "
            "included); lrn_fwd launches %d (%d storing no norm), lrn_bwd "
            "launches %d; records decoded by route %s"
            % (JPEG_ROUNDS, wall, train[0], train[2], train[1], routes))
        if train != (2 * steps + 2 * evals, 2 * steps, 2 * evals):
            raise AssertionError(
                "expected 2 + 2 LRN launches in each of %d steps and 2 "
                "without a norm in each of %d eval batches; counted %s"
                % (steps, evals, train))
        if routes["cv2"] or routes["pnm"] or \
                routes["jpeg"] < JPEG_TRAIN * (JPEG_ROUNDS + 1) + JPEG_TEST:
            raise AssertionError("the JPEG records did not all go through "
                                 "the port's decoder: %s" % routes)
        if len([ln for ln in err.splitlines() if ln.startswith("[")]) \
                != JPEG_ROUNDS:
            raise AssertionError("expected %d eval line" % JPEG_ROUNDS)
        rates = round_rates(out)
        log("  round (input-wait %%, io img/s when blocked, step img/s): "
            "JPEG %s; cli_imagenet_train's PPM rounds %s"
            % (rates, PPM_ROUND_RATES))
        host_passes(iter_image, os.path.join(cwd, "models",
                                             "image_net_mean.bin"))
        # the same batches through api.Net.update, both with cuDNN off (as
        # cli_imagenet_train: cuDNN's algorithms need not repeat)
        cfg = open(conf).read() + "\nbatch_size = %d\nseed = %d\n" \
            % (BATCH, SEED)
        net = api.Net(dev=NET_DEV, cfg=cfg)
        with cudnn_off():
            run_cli(learn_task, cwd, args + [
                "model_dir=models_det", "image_mean=models_det/mean",
                "save_model=%d" % JPEG_ROUNDS])
            net.init_model()
            start = _params(net)
            with in_dir(cwd):
                it = api.DataIter(conf_section(
                    conf, "data = train", 'image_mean = "mean_api"\n'
                    'decode_thread = 4\n', "3,227,227", BATCH))
                if open("models_det/mean", "rb").read() != \
                        open("mean_api", "rb").read():
                    raise AssertionError("the DataIter's mean image differs "
                                         "from the CLI's")
                for r in range(JPEG_ROUNDS):
                    net.start_round(r + 1)
                    it.before_first()
                    while it.next():
                        net.update(it)
                it.close()
        cli_net = api.Net(dev=NET_DEV, cfg=cfg)
        cli_net.load_model(os.path.join(cwd, "models_det/%04d.model"
                                        % JPEG_ROUNDS))
        compare_params("round-%d model of the CLI on the JPEG pack vs the "
                       "same batches through api.Net.update (cuDNN off on "
                       "both)" % JPEG_ROUNDS, _params(cli_net), _params(net),
                       start, STEP_RTOL, STEP_ATOL_UPDATE)
        del net, cli_net, start
        torch.cuda.empty_cache()
    log("  phase wall %.1f s" % (time.perf_counter() - t0))
    return train[:2]


def phase_cli_bowl_train(learn_task, api):
    """example/kaggle_bowl/bowl.conf, read unchanged but for dev, num_round
    and max_round on the command line, trained for 2 rounds on a JPEG pack
    with every geometric key of the file; then again with cuDNN off against
    api.Net.update over the same chain."""
    from cxxnet_tpu_torch.io import iter_image, synth
    log("phase cli_bowl_train")
    t0 = time.perf_counter()
    conf = os.path.join(REPO, "example/kaggle_bowl/bowl.conf")
    with scratch_dir("cli_bowl_train") as d:
        t = time.perf_counter()
        recs = host_input("bowl")
        synth.write_pack(recs[:BOWL_TRAIN], os.path.join(d, "tr.lst"),
                         os.path.join(d, "tr.bin"))
        synth.write_pack(recs[BOWL_TRAIN:], os.path.join(d, "va.lst"),
                         os.path.join(d, "va.bin"))
        log("  pack: %d + %d JPEG images %dx%d, %d classes, in %.2f s"
            % (BOWL_TRAIN, BOWL_VAL, BOWL_HW, BOWL_HW, BOWL_CLASSES,
               time.perf_counter() - t))
        args = [conf, "dev=" + NET_DEV, "num_round=%d" % BOWL_ROUNDS,
                "max_round=%d" % BOWL_ROUNDS]
        before = dict(iter_image.decode_routes)
        iter_image.warp_calls, iter_image.warp_seconds = 0, 0.0
        t = time.perf_counter()
        out, err = run_cli(learn_task, d, args)
        wall = time.perf_counter() - t
        routes = routes_since(iter_image, before)
        lines = [ln for ln in err.splitlines() if ln.startswith("[")]
        vals = [float(v) for ln in lines
                for v in re.findall(r":([-\d.e+]+|nan|inf)", ln)]
        if len(lines) != BOWL_ROUNDS or not vals or \
                not np.all(np.isfinite(vals)):
            raise AssertionError("expected %d eval lines of finite values: "
                                 "%r" % (BOWL_ROUNDS, lines))
        log("  %d rounds in %.2f s wall; %d records decoded (%s), %d warped "
            "(share %.3f), the warp %.4f ms a record; round lines %s"
            % (BOWL_ROUNDS, wall, sum(routes.values()), routes,
               iter_image.warp_calls,
               iter_image.warp_calls / max(1, sum(routes.values())),
               1e3 * iter_image.warp_seconds / max(1, iter_image.warp_calls),
               round_rates(out)))
        if routes["cv2"] or not iter_image.warp_calls:
            raise AssertionError("cv2 decoded a record, or nothing was "
                                 "warped: %s" % routes)
        cfg = open(conf).read().replace("dev = gpu:1", "") \
            + "\nseed = %d\n" % SEED
        net = api.Net(dev=NET_DEV, cfg=cfg)
        net.load_model(os.path.join(d, "models/%04d.model" % BOWL_ROUNDS))
        check_params_finite(net)
        net = api.Net(dev=NET_DEV, cfg=cfg)
        batch = int(re.search(r"\nbatch_size = (\d+)", cfg).group(1))
        with cudnn_off():
            run_cli(learn_task, d, args + [
                "model_dir=models_det", "image_mean=models_det/mean.bin",
                "save_model=%d" % BOWL_ROUNDS])
            net.init_model()
            start = _params(net)
            with in_dir(d):
                it = api.DataIter(conf_section(
                    conf, "data = train", 'image_mean = "mean_api"\n',
                    "3,40,40", batch))
                for r in range(BOWL_ROUNDS):
                    net.start_round(r + 1)
                    it.before_first()
                    while it.next():
                        net.update(it)
                it.close()
        cli_net = api.Net(dev=NET_DEV, cfg=cfg)
        cli_net.load_model(os.path.join(d, "models_det/%04d.model"
                                        % BOWL_ROUNDS))
        compare_params("round-%d model of bowl.conf's CLI vs the same chain "
                       "through api.Net.update (cuDNN off on both)"
                       % BOWL_ROUNDS, _params(cli_net), _params(net), start,
                       STEP_RTOL, STEP_ATOL_UPDATE)
        del net, cli_net, start
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
    batch_dev = data_batch(x, y, DEV)
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


def ring_step_case(rf, case, dtype, rng, timed=True):
    """The three step kernels against their plain versions at one step's
    shape and offsets, from the same carries; a step that keeps no pair
    leaves every carry bitwise as it was. Returns the largest absolute
    error and {kernel: (kernel ms, plain ms, bound ms, what bounds it)}
    ({} when not ``timed``)."""
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
    if not timed:
        return err, {}
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
    batch_dev = data_batch(x, y, DEV)
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
                    iters=1,
                    shares=("ring_fwd_step", "ring_dq_step", "ring_dkv_step")
                    if ring_path else ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv"))
    del one, sp, batch_dev
    torch.cuda.empty_cache()
    return tuple(a + b for a, b in zip(pred, steps))


def bf16_cfg(cfg: str) -> str:
    """``cfg`` computing in bf16 (explicit casts over float32 masters)."""
    return cfg + BF16


def image_batch(n, hw, seed, n_class=1000):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, hw, hw).astype(np.float32),
            rng.randint(0, n_class, n).astype(np.float32))


def no_dropout(cfg: str) -> str:
    """``cfg`` with every dropout threshold 0: two runs that draw in
    different dtypes (bf16 and f32 masks differ) compare the same net."""
    return re.sub(r"threshold = [0-9.]+", "threshold = 0", cfg)


@contextlib.contextmanager
def capture_calls(mod, name, keep):
    """Wrap mod.<name> (a kernel wrapper, looked up by the port at call
    time): every call's tensor dtypes are recorded, and the arguments of
    the first ``keep`` calls are kept, tensors cloned. Yields
    (dtypes, kept)."""
    fn = getattr(mod, name)
    dtypes, kept = [], []

    def wrapper(*args, **kw):
        dtypes.append(next(a.dtype for a in args if torch.is_tensor(a)))
        if len(kept) < keep:
            kept.append(([a.detach().clone() if torch.is_tensor(a) else a
                          for a in args], dict(kw)))
        return fn(*args, **kw)
    setattr(mod, name, wrapper)
    try:
        yield dtypes, kept
    finally:
        setattr(mod, name, fn)


def require_dtype(what, dtypes, want):
    got = sorted(set(str(d)[6:] for d in dtypes))
    log("  %s: %d calls, input dtypes %s" % (what, len(dtypes), got))
    if not dtypes or got != [str(want)[6:]]:
        raise AssertionError("%s: expected %s inputs, got %s"
                             % (what, want, got))


def lrn_layers_vs_plain(lrn, calls):
    """The LRN kernels against their plain versions on the inputs a net's
    LRN layers took (captured lrn_fwd_cuda calls, bf16): out and the f32
    norm, then the backward with a seeded upstream gradient."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    worst = 0.0
    for i, (args, kw) in enumerate(calls):
        x, nsize, alpha, beta, knorm = args[:5]
        dt = x.dtype
        out, norm = lrn.lrn_fwd_cuda(x, nsize, alpha, beta, knorm)
        ref_out, ref_norm = lrn.lrn_ref_with_norm(x, nsize, alpha, beta,
                                                  knorm)
        tag = "layer input %d %s %s" % (i, tuple(x.shape), str(dt)[6:])
        worst = max(worst, check_close(tag + " out vs lrn_ref", out,
                                       ref_out, RTOL[dt]))
        check_close(tag + " norm vs lrn_ref", norm, ref_norm, NORM_RTOL)
        g = torch.randn(x.shape, generator=gen, device=DEV).to(dt)
        dx = lrn.lrn_bwd_cuda(x, norm, g, nsize, alpha, beta)
        ref = lrn.lrn_bwd_ref(x, norm, g, nsize, alpha, beta)
        atol = BWD_ATOL_EPS * torch.finfo(torch.float32).eps \
            * float(ref.float().abs().max())
        check_close(tag + " dx vs lrn_bwd_ref", dx, ref, RTOL[dt], atol)
        del out, norm, ref_out, ref_norm, g, dx, ref
    return worst


def flash_layers_vs_plain(flash, calls):
    """The flash kernels against their plain versions on the q, k, v a
    net's attention layers took (captured flash_fwd_cuda calls, bf16):
    out and lse, then the backward with a seeded upstream gradient."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    eps = torch.finfo(torch.float32).eps
    for i, (args, kw) in enumerate(calls):
        q, k, v = args[:3]
        rest = tuple(args[3:])
        dt = q.dtype
        tag = "layer input %d q %s %s" % (i, tuple(q.shape), str(dt)[6:])
        out, lse = flash.flash_fwd_cuda(q, k, v, *rest, **kw)
        ref_out, ref_lse = flash.flash_fwd_ref(q, k, v, *rest, **kw)
        check_close(tag + " out vs flash_fwd_ref", out, ref_out, RTOL[dt],
                    FLASH_ATOL_EPS * eps * float(ref_out.float().abs().max()))
        check_close(tag + " lse vs flash_fwd_ref", lse, ref_lse, NORM_RTOL,
                    FLASH_ATOL_EPS * eps * float(ref_lse.abs().max()))
        dout = torch.randn(q.shape, generator=gen, device=DEV).to(dt)
        got = flash.flash_bwd_cuda(q, k, v, out, lse, dout, *rest, **kw)
        want = flash.flash_bwd_ref(q, k, v, out, lse, dout, *rest, **kw)
        for nm, a, b in zip(("dq", "dk", "dv"), got, want):
            check_close(tag + " %s vs flash_bwd_ref" % nm, a, b, 0.0,
                        FLASH_BWD_TOL[dt] * float(b.float().abs().max()))
        del out, lse, ref_out, ref_lse, dout, got, want


def bf16_gap(api, cfg, fname, x, y, feat, dev):
    """The net of ``cfg`` loaded from ``fname`` on ``dev`` in float32 and
    in bf16, on the batch (x, y): {"features": max |bf16 - f32| over max
    |f32| of node ``feat`` (eval forward), "gradients": the L2 norm of the
    difference over the L2 norm of the f32 gradients, all weights
    together, "loss": (f32, bf16) losses}."""
    res = {}
    for tag, c in (("f32", cfg), ("bf16", bf16_cfg(cfg))):
        net = api.Net(dev=dev, cfg=c)
        net.load_model(fname)
        feats = torch.from_numpy(net.extract(x, feat)).double()
        loss, grads = net.net_.loss_and_grads(
            data_batch(x, y, "cpu" if dev == "cpu" else DEV))
        flat = [g.double() for p in grads for g in p.values()]
        if tag == "f32":
            res["f32"] = (feats, float(loss), flat)
        else:
            f_feats, f_loss, f_flat = res.pop("f32")
            res["features"] = float((feats - f_feats).abs().max()
                                    / f_feats.abs().max())
            num = sum(float(((a - b) ** 2).sum()) for a, b in zip(flat,
                                                                  f_flat))
            den = sum(float((b ** 2).sum()) for b in f_flat)
            res["gradients"] = (num / den) ** 0.5
            res["loss"] = (f_loss, float(loss))
            finite = all(bool(torch.isfinite(a).all()) for a in flat)
            if not finite or not np.isfinite(float(loss)):
                raise AssertionError("bf16 loss or gradients not finite")
        del net, grads, flat
        if dev != "cpu":
            torch.cuda.empty_cache()
    return res


def log_gap(what, gap):
    log("  %s: bf16 vs f32 features %.4e of their largest, gradients %.4e "
        "(L2, all weights), loss %.6f vs %.6f"
        % (what, gap["features"], gap["gradients"], gap["loss"][0],
           gap["loss"][1]))


def full_size_gap(api, cfg, fname, x, y, feat):
    """The card's bf16 run against its f32 run at full size, dropout off:
    the features and the loss within FULL_GAP (a sanity bar that catches
    a wrong cast or a broken layer; the precision rule is gap_rule's)."""
    gap = bf16_gap(api, no_dropout(cfg), fname, x, y, feat, NET_DEV)
    log_gap("full size on the card", gap)
    lf, lb = gap["loss"]
    if gap["features"] > FULL_GAP or abs(lb - lf) > FULL_GAP * abs(lf):
        raise AssertionError("bf16 run beyond the sanity bar %g of the f32 "
                             "run" % FULL_GAP)
    return gap


def gap_cases(models):
    """(cfg, x, y, node) of every gap_rule of the run, in its order: the
    reduced sizes of googlenet_bf16_train, googlenet_bf16_pred,
    vgg16_bf16_remat, resnet18_bf16_train, bench_bf16's AlexNet and LM,
    mobilenet_bf16_train and vit_s16_bf16_train."""
    rng = np.random.RandomState(SEED + 29)
    tx = rng.randint(0, LM_ARGS["vocab"], (LM_BATCH, 1, 1, LM_SEQ)).astype(
        np.float32)
    ty = rng.randint(0, LM_ARGS["vocab"], (LM_BATCH, LM_SEQ)).astype(
        np.float32)
    return [
        (gnet_cfg(models, 4, 64), *image_batch(4, 64, SEED + 21), "gp"),
        (gnet_cfg(models, 4, 64), *image_batch(4, 64, SEED + 30), "gp"),
        (vgg_cfg(models, 4, 32, 1, fc_dim=64),
         *image_batch(4, 32, SEED + 24), "pool5"),
        (models.resnet_config(batch_size=8, input_hw=32, dev=NET_DEV)
         + "seed = %d\n" % SEED, *image_batch(8, 32, SEED + 26), "gap"),
        (imagenet_cfg().replace("batch_size = %d" % BATCH, "batch_size = 4"),
         *image_batch(4, 227, SEED + 28), "17"),
        (lm_cfg(models, 256, 2), tx[:2, :, :, :256].copy(),
         ty[:2, :256].copy(), "top[-1]"),
        (models.mobilenet_config(dev=NET_DEV, **MN_SMALL)
         + "seed = %d\n" % SEED,
         *image_batch(MN_SMALL["batch_size"], MN_SMALL["input_hw"],
                      SEED + 42), "gap"),
        (models.vit_config(dev=NET_DEV, **VIT_SMALL) + "seed = %d\n" % SEED,
         *image_batch(VIT_SMALL["batch_size"], VIT_SMALL["image_hw"],
                      SEED + 45, VIT_SMALL["n_class"]), "gp")]


def gap_key(cfg, x, feat) -> str:
    import hashlib
    return hashlib.sha1(no_dropout(cfg).encode() + np.ascontiguousarray(
        x).tobytes() + feat.encode()).hexdigest()


def cpu_gap(api, cfg, x, y, feat):
    """bf16_gap on the port's CPU path from the weights of ``cfg``'s seed
    (every init from one seed is the same weights)."""
    cfg = no_dropout(cfg)
    init = api.Net(dev="cpu", cfg=cfg)
    init.init_model()
    fname = scratch_file("chip_smoke_gap_cpu_%d.model" % os.getpid())
    init.save_model(fname)
    try:
        return bf16_gap(api, cfg, fname, x, y, feat, "cpu")
    finally:
        os.remove(fname)


# the CPU halves of every gap_rule, in a process of its own that runs
# beside the card's phases (start_cpu_gaps); {key: result} once read
GAP_RUNNER = r"""
import json, pickle, sys, time
sys.path.insert(0, %(repo)r)
import torch
torch.set_num_threads(%(threads)d)
import chip_smoke as cs
from cxxnet_tpu_torch import api
cases = pickle.load(open(%(cases)r, "rb"))
out = {}
t = time.perf_counter()
for key, cfg, x, y, feat in cases:
    out[key] = cs.cpu_gap(api, cfg, x, y, feat)
out["seconds"] = time.perf_counter() - t
json.dump(out, open(%(out)r + ".tmp", "w"))
import os
os.replace(%(out)r + ".tmp", %(out)r)
"""
# the CPU-gap process's threads (of the host's 8 cores)
GAP_THREADS = 2
_GAPS = {}


def start_cpu_gaps(models):
    """Start the CPU halves of the run's gap_rules (gap_cases) in a
    process of its own, which computes them while the card runs the
    phases before them: host work moved off the critical path."""
    import pickle
    path = scratch_file("chip_smoke_gaps")
    cases = [(gap_key(cfg, x, feat), cfg, x, y, feat)
             for cfg, x, y, feat in gap_cases(models)]
    with open(path + ".pkl", "wb") as f:
        pickle.dump(cases, f)
    code = GAP_RUNNER % {"repo": REPO, "threads": GAP_THREADS,
                         "cases": path + ".pkl", "out": path + ".json"}
    _GAPS["proc"] = subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    _GAPS["path"] = path + ".json"


def gap_of_cpu(api, cfg, x, y, feat):
    """The CPU half of a gap_rule: from the CPU-gap process when it made
    it (waiting for it to end), else computed here."""
    proc = _GAPS.pop("proc", None)
    if proc is not None:
        t = time.perf_counter()
        out, _ = proc.communicate(timeout=1200)
        if proc.returncode != 0:
            raise AssertionError("the CPU-gap process exited %d:\n%s"
                                 % (proc.returncode, out[-4000:]))
        res = json.load(open(_GAPS["path"]))
        log("  the CPU halves of the run's %d gap rules: %.1f s in a "
            "process beside the card (waited %.1f s for it here)"
            % (len(res) - 1, res.pop("seconds"), time.perf_counter() - t))
        _GAPS["results"] = res
    res = _GAPS.get("results", {}).get(gap_key(cfg, x, feat))
    if res is not None:
        return dict(res, loss=tuple(res["loss"]))
    return cpu_gap(api, cfg, x, y, feat)


def gap_rule(api, cfg, x, y, feat):
    """At a reduced size (``cfg`` on the card, weights from SEED), the
    card's bf16-versus-f32 gap against the port's CPU path's on the same
    weights and batch: features and gradients within GAP_FACTOR times the
    CPU's plus GAP_SLACK. The CPU's half comes from the CPU-gap process
    where it ran (gap_of_cpu)."""
    cpu = gap_of_cpu(api, cfg, x, y, feat)
    cfg = no_dropout(cfg)
    init = api.Net(dev="cpu", cfg=cfg)
    init.init_model()
    fname = scratch_file("chip_smoke_gap.model")
    init.save_model(fname)
    t = time.perf_counter()
    card = bf16_gap(api, cfg, fname, x, y, feat, NET_DEV)
    os.remove(fname)
    log_gap("reduced size (batch %d, %dx%d) on the card (%.1f s)"
            % (x.shape[0], x.shape[2], x.shape[3], time.perf_counter() - t),
            card)
    log_gap("the same on the CPU path", cpu)
    for key in ("features", "gradients"):
        bar = GAP_FACTOR * cpu[key] + GAP_SLACK
        ok = card[key] <= bar
        log("  %s gap: card %.4e, bar %.4e (%g x the CPU's + %g) %s"
            % (key, card[key], bar, GAP_FACTOR, GAP_SLACK,
               "ok" if ok else "FAILED"))
        if not ok:
            raise AssertionError("the card's bf16 %s gap exceeds the CPU "
                                 "rule" % key)


def per_s(step, units, iters=5, warmup=2):
    """units per second of ``step`` (each call synchronised)."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        step()
        torch.cuda.synchronize()
    return units * iters / (time.perf_counter() - t)


def numpy_card_rates(what, numpy_step, card_step, units, unit="images",
                     iters=5):
    """units/s of ``numpy_step`` (fed from numpy) and ``card_step`` (the
    batch already on the card), in turns numpy, card, card, numpy."""
    rates = {"numpy": [], "card": []}
    for which in ("numpy", "card", "card", "numpy"):
        rates[which].append(per_s(card_step if which == "card"
                                  else numpy_step, units, iters))
    log("  %s: %s %s/s fed from numpy, %s with the batch on the card (in "
        "turns)" % (what, " / ".join("%.1f" % r for r in rates["numpy"]),
                    unit, " / ".join("%.1f" % r for r in rates["card"])))


def image_rates(what, net, x, y):
    """Training images/s from numpy (Net.update: the staging ring) and with
    the batch on the card; returns the on-card step."""
    resident = data_batch(x, y, DEV)

    def card_step():
        net.net_.update(resident)
    numpy_card_rates(what, lambda: net.update(x, y), card_step, x.shape[0])
    return card_step


def check_params_finite(net):
    for i, p in enumerate(net.net_.params):
        for k, v in p.items():
            if v.dtype != torch.float32 or not bool(torch.isfinite(v).all()):
                raise AssertionError("layer %d %s: %s master not finite"
                                     % (i, k, v.dtype))
    log("  every master weight float32 and finite")


def image_train_phase(phase, api, cfg, x, y, feat, small_cfg, small,
                      lrn=None, loss_must_fall=True):
    """One bf16 image net through api.Net(dev="gpu").update: BF16_STEPS
    steps (LRN launches counted and their inputs bf16, where the net has
    LRN layers), the loss, the full-size bf16-vs-f32 gap, the reduced-size
    rule, the LRN layers against the plain versions, images/s and a step
    profile; returns the LRN (forward, backward) launches of the main
    path."""
    t0 = time.perf_counter()
    net = api.Net(dev=NET_DEV, cfg=bf16_cfg(cfg))
    net.init_model()
    if net.net_.net.compute_dtype != torch.bfloat16:
        raise AssertionError("the net does not compute in bf16")
    fname = scratch_file("chip_smoke_%s.model" % phase)
    net.save_model(fname)
    loss0 = cross_entropy(net.extract(x, "top[-1]"), y)
    fwd = bwd = 0
    ctx = capture_calls(lrn, "lrn_fwd_cuda", 2) if lrn is not None \
        else contextlib.nullcontext((None, None))
    torch.cuda.reset_peak_memory_stats()
    with ctx as (dtypes, kept):
        # the main path: the counts start at 0 here and are read right after
        if lrn is not None:
            lrn.launches = lrn.bwd_launches = 0
        t = time.perf_counter()
        for _ in range(BF16_STEPS):
            net.update(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if lrn is not None:
            fwd, bwd = lrn.launches, lrn.bwd_launches
    log("  %d bf16 update steps in %.2f s (first steps included); peak "
        "memory %.2f GB" % (BF16_STEPS, wall,
                            torch.cuda.max_memory_allocated() / 1e9))
    if lrn is not None:
        log("  lrn_fwd launches %d, lrn_bwd launches %d (2 + 2 per step "
            "expected)" % (fwd, bwd))
        if (fwd, bwd) != (2 * BF16_STEPS,) * 2:
            raise AssertionError("expected 2 + 2 LRN launches per step")
        require_dtype("lrn_fwd_cuda on the main path", dtypes,
                      torch.bfloat16)
    loss1 = cross_entropy(net.extract(x, "top[-1]"), y)
    log("  fixed-batch cross-entropy %.6f before, %.6f after %d steps"
        % (loss0, loss1, BF16_STEPS))
    if not np.isfinite(loss1) or (loss_must_fall and not loss1 < loss0):
        raise AssertionError("bf16 training loss did not fall: %r -> %r"
                             % (loss0, loss1))
    check_params_finite(net)
    if lrn is not None:
        lrn_layers_vs_plain(lrn, kept)
    del kept
    step = image_rates("%s bf16 training batch %d" % (phase, x.shape[0]),
                          net, x, y)
    profile_forward(step, unit="step", top=8,
                    shares=("lrn_fwd", "lrn_bwd") if lrn else ())
    del net, step
    torch.cuda.empty_cache()
    full_size_gap(api, cfg, fname, x, y, feat)
    os.remove(fname)
    gap_rule(api, small_cfg, *small, feat)
    log("  phase wall %.1f s" % (time.perf_counter() - t0))
    return fwd, bwd


def gnet_cfg(models, batch, hw, dev=None):
    return models.googlenet_config(batch_size=batch, input_hw=hw,
                                   dev=dev or NET_DEV) + "seed = %d\n" % SEED


def phase_googlenet_bf16_train(lrn, api, models):
    """GoogLeNet (models.googlenet_config: bench.py's recipe, 224x224, 1000
    classes) trained in bf16 at batch 128 (image_train_phase)."""
    log("phase googlenet_bf16_train")
    x, y = image_batch(GNET_BATCH, IMG_HW, SEED + 20)
    return image_train_phase(
        "googlenet", api, gnet_cfg(models, GNET_BATCH, IMG_HW), x, y, "gp",
        gnet_cfg(models, 4, 64), image_batch(4, 64, SEED + 21), lrn=lrn)


def phase_googlenet_bf16_pred(lrn, api, models):
    """GoogLeNet in bf16 served at batch 128 through predict / extract: 2
    LRN launches per forward without the norm, on bf16 inputs; the softmax
    against the f32 net's on the same weights; the LRN layers against the
    plain versions; images/s and a profile. Returns the main path's LRN
    launches."""
    log("phase googlenet_bf16_pred")
    cfg = gnet_cfg(models, GNET_BATCH, IMG_HW)
    net = api.Net(dev=NET_DEV, cfg=bf16_cfg(cfg))
    net.init_model()
    x, _ = image_batch(GNET_BATCH, IMG_HW, SEED + 22)
    with capture_calls(lrn, "lrn_fwd_cuda", 2) as (dtypes, kept):
        # the main path: the counts start at 0 here and are read right after
        lrn.launches = lrn.no_norm_launches = 0
        pred = net.predict(x)
        top = net.extract(x, "top[-1]")
        torch.cuda.synchronize()
        launches, no_norm = lrn.launches, lrn.no_norm_launches
    log("  lrn_fwd launches %d over 2 forwards, %d storing no norm"
        % (launches, no_norm))
    if (launches, no_norm) != (4, 4):
        raise AssertionError("expected 2 LRN launches per forward without "
                             "the norm")
    require_dtype("lrn_fwd_cuda on the main path", dtypes, torch.bfloat16)
    if top.dtype != np.float32 or pred.shape != (GNET_BATCH,) \
            or top.shape != (GNET_BATCH, 1, 1, 1000):
        raise AssertionError("outputs %s %s %s" % (top.dtype, pred.shape,
                                                   top.shape))
    row_err = float(np.abs(top.sum(axis=3) - 1.0).max())
    log("  softmax rows (float32 over the bf16 logits) sum to 1 within "
        "%.3e (tolerance 1e-5)" % row_err)
    if row_err > 1e-5 or not (pred == top.reshape(GNET_BATCH, -1)
                              .argmax(axis=1)).all():
        raise AssertionError("softmax rows or predict vs argmax")
    lrn_layers_vs_plain(lrn, kept)
    del kept
    fname = scratch_file("chip_smoke_gnet_pred.model")
    net.save_model(fname)
    f32 = api.Net(dev=NET_DEV, cfg=cfg)
    f32.load_model(fname)
    os.remove(fname)
    top32 = f32.extract(x, "top[-1]")
    agree = float((f32.predict(x) == pred).mean())
    gap = float(np.abs(top - top32).max() / np.abs(top32).max())
    log("  bf16 vs f32 on the same weights: softmax %.4e of its largest, "
        "top-1 agreement %.4f" % (gap, agree))
    if gap > FULL_GAP:
        raise AssertionError("bf16 softmax beyond the sanity bar")
    del f32
    xs = torch.from_numpy(x).to(DEV)
    numpy_card_rates("GoogLeNet bf16 inference batch %d" % GNET_BATCH,
                     lambda: net.predict(x), lambda: net.predict_device(xs),
                     GNET_BATCH, iters=10)
    profile_forward(lambda: net.predict_device(xs), top=8)
    del net, xs
    torch.cuda.empty_cache()
    gap_rule(api, gnet_cfg(models, 4, 64), *image_batch(4, 64, SEED + 30),
             "gp")
    return launches


def phase_cli_googlenet(lrn, learn_task, api):
    """example/ImageNet/GoogLeNet.conf read unchanged by the CLI (its own
    dev and compute_dtype = bfloat16): one round (num_round and max_round
    cut on the command line) from a synthetic PPM pack through imgbinx,
    threadbuffer and the mean image, then task=pred from the saved model
    held to api.Net.predict on the same iterator. Returns the LRN
    (forward, backward) launches of training and the forward launches of
    pred."""
    log("phase cli_googlenet")
    t0 = time.perf_counter()
    conf = os.path.join(REPO, "example/ImageNet/GoogLeNet.conf")
    batches, evals = CLI_TRAIN_IMAGES // GNET_CONF_BATCH, \
        CLI_TEST_IMAGES // GNET_CONF_BATCH
    with scratch_dir("cli_googlenet") as root:
        cwd = imagenet_pack(root)
        with capture_calls(lrn, "lrn_fwd_cuda", 2) as (dtypes, kept):
            # the main path: the counts start at 0 here, read right after
            lrn.launches = lrn.no_norm_launches = lrn.bwd_launches = 0
            out, err = run_cli(learn_task, cwd, [conf, "num_round=1",
                                                 "max_round=1"])
            train = (lrn.launches, lrn.bwd_launches, lrn.no_norm_launches)
        log("  lrn_fwd launches %d (%d storing no norm), lrn_bwd %d"
            % (train[0], train[2], train[1]))
        if train != (2 * batches + 2 * evals, 2 * batches, 2 * evals):
            raise AssertionError("expected 2 + 2 LRN launches in each of %d "
                                 "steps and 2 in each of %d eval batches"
                                 % (batches, evals))
        require_dtype("lrn_fwd_cuda on the CLI's path", dtypes,
                      torch.bfloat16)
        lrn_layers_vs_plain(lrn, kept)
        del kept
        if len([ln for ln in err.splitlines() if ln.startswith("[")]) != 1:
            raise AssertionError("expected one eval line")
        log("  round (input-wait %%, io img/s when blocked, step img/s): %s"
            % round_rates(out))
        model = os.path.join(cwd, "models/0001.model")
        section = ["iter=imgbinx", "image_list=../../NameList.test",
                   "image_bin=../../TEST.BIN",
                   "image_mean=models/image_net_mean.bin", "iter=end"]
        lrn.launches = lrn.no_norm_launches = 0
        run_cli(learn_task, cwd, [conf, "task=pred", "model_in=" + model,
                                  "pred=pred.txt"] + section)
        pred_launches = (lrn.launches, lrn.no_norm_launches)
        if pred_launches != (2 * evals,) * 2:
            raise AssertionError("pred: expected 2 LRN launches without the "
                                 "norm per batch, counted %s"
                                 % (pred_launches,))
        text = open(conf).read()
        net = api.Net(dev=NET_DEV, cfg=text)
        net.load_model(model)
        if net.net_.compute_dtype != torch.bfloat16:
            raise AssertionError("GoogLeNet.conf's model is not bf16")
        want = []
        with in_dir(cwd):
            it = api.DataIter("\n".join(section[:-1]) +
                              "\ninput_shape = 3,224,224\nbatch_size = %d\n"
                              "iter = end\n" % GNET_CONF_BATCH)
            it.before_first()
            while it.next():
                want.append(net.predict(it))
            it.close()
        want = np.concatenate(want)
        got = np.array([float(v) for v in
                        open(os.path.join(cwd, "pred.txt")).read().split()])
        if not np.array_equal(got, want):
            raise AssertionError("task=pred differs from api.Net.predict")
        log("  task=pred: %d rows, bitwise api.Net.predict" % len(got))
        # the CLI's model in f32 on the first test batch of the same chain
        f32 = api.Net(dev=NET_DEV, cfg=text)
        f32.set_param("compute_dtype", "float32")
        f32.load_model(model)
        with in_dir(cwd):
            it = api.DataIter("\n".join(section[:-1]) +
                              "\ninput_shape = 3,224,224\nbatch_size = %d\n"
                              "iter = end\n" % GNET_CONF_BATCH)
            it.before_first()
            it.next()
            xb = np.array(it.check_valid().data)
            it.close()
        top, top32 = net.extract(xb, "top[-1]"), f32.extract(xb, "top[-1]")
        gap = float(np.abs(top - top32).max() / np.abs(top32).max())
        agree = float((net.predict(xb) == f32.predict(xb)).mean())
        log("  the CLI's model, bf16 vs f32 on a test batch: softmax %.4e "
            "of its largest, top-1 agreement %.4f" % (gap, agree))
        if gap > FULL_GAP:
            raise AssertionError("bf16 softmax beyond the sanity bar")
        xs = torch.from_numpy(xb).to(DEV)
        log("  GoogLeNet.conf's model, bf16 inference batch %d: %.1f "
            "images/s from numpy, %.1f with the batch on the card"
            % (GNET_CONF_BATCH, per_s(lambda: net.predict(xb),
                                      GNET_CONF_BATCH, iters=10),
               per_s(lambda: net.predict_device(xs), GNET_CONF_BATCH,
                     iters=10)))
        profile_forward(lambda: net.predict_device(xs), top=6)
        del net, f32, xs
        torch.cuda.empty_cache()
    log("  phase wall %.1f s" % (time.perf_counter() - t0))
    return train, pred_launches[0]


def vgg_cfg(models, batch, hw, remat, fc_dim=4096, dev=None):
    return models.vgg_config(batch_size=batch, input_hw=hw, remat=remat,
                             fc_dim=fc_dim, dev=dev or NET_DEV) \
        + "seed = %d\n" % SEED


def phase_vgg16_bf16_remat(api, models):
    """VGG-16 (VGG.conf's net: vgg_config(remat=1), batch 64, 224x224) in
    bf16: steps with remat on, the peak device memory of a step with
    remat on and off from the same weights and batch (remat must lower
    it), the gradients of the two against each other, the bf16-vs-f32
    gaps, images/s and a profile."""
    log("phase vgg16_bf16_remat")
    t0 = time.perf_counter()
    x, y = image_batch(VGG_BATCH, IMG_HW, SEED + 23)
    cfg = vgg_cfg(models, VGG_BATCH, IMG_HW, 1)
    net = api.Net(dev=NET_DEV, cfg=bf16_cfg(cfg))
    net.init_model()
    if not all(lay.remat for lay in net.net_.net.layers):
        raise AssertionError("remat is not on in every layer")
    fname = scratch_file("chip_smoke_vgg.model")
    net.save_model(fname)
    loss0 = cross_entropy(net.extract(x, "top[-1]"), y)
    t = time.perf_counter()
    for _ in range(BF16_STEPS):
        net.update(x, y)
    torch.cuda.synchronize()
    loss1 = cross_entropy(net.extract(x, "top[-1]"), y)
    log("  %d bf16 update steps with remat in %.2f s; fixed-batch "
        "cross-entropy %.6f before, %.6f after"
        % (BF16_STEPS, time.perf_counter() - t, loss0, loss1))
    if not (np.isfinite(loss1) and loss1 < loss0):
        raise AssertionError("VGG bf16 training loss did not fall")
    check_params_finite(net)
    step = image_rates("VGG-16 bf16 remat training batch %d"
                          % VGG_BATCH, net, x, y)
    profile_forward(step, unit="step", top=8, shares=())
    del net, step
    torch.cuda.empty_cache()

    # remat on and off: one step's peak memory and gradients, same weights,
    # batch and dropout draw, cuDNN in its deterministic mode so that the
    # recompute repeats the forward's sums; then the rate of each (on, then
    # off: one pass each keeps the script inside its time limit)
    peak, grads, rates = {}, {}, {}
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (1, 0):
            n = api.Net(dev=NET_DEV, cfg=bf16_cfg(
                vgg_cfg(models, VGG_BATCH, IMG_HW, remat)))
            n.load_model(fname)
            b = data_batch(x, y, DEV)
            n.net_.loss_and_grads(b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _, g = n.net_.loss_and_grads(b)
            torch.cuda.synchronize()
            peak.setdefault(remat, []).append(
                (torch.cuda.max_memory_allocated() - base) / 1e9)
            grads.setdefault(remat, g)
            del g
            rates.setdefault(remat, []).append(
                per_s(lambda: n.net_.update(b), VGG_BATCH, iters=3))
            del n, b
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = was
    log("  peak device memory of a forward and backward above the resident "
        "state: remat on %s GB, off %s GB; training %s images/s with remat "
        "on, %s off (on, then off; cuDNN deterministic)"
        % (" / ".join("%.2f" % p for p in peak[1]),
           " / ".join("%.2f" % p for p in peak[0]),
           " / ".join("%.1f" % r for r in rates[1]),
           " / ".join("%.1f" % r for r in rates[0])))
    if max(peak[1]) >= min(peak[0]):
        raise AssertionError("remat saved no device memory")
    same = all(torch.equal(a[k], b[k]) for a, b in zip(grads[1], grads[0])
               for k in a)
    worst = max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(
        1e-30)) for a, b in zip(grads[1], grads[0]) for k in a)
    log("  gradients remat on vs off: bitwise equal %s, worst %.3e of a "
        "tensor's largest (bar %.0e)" % (same, worst, RTOL[torch.bfloat16]))
    if worst > RTOL[torch.bfloat16]:
        raise AssertionError("remat: gradients on and off differ")
    del grads
    torch.cuda.empty_cache()
    full_size_gap(api, cfg, fname, x, y, "pool5")
    os.remove(fname)
    gap_rule(api, vgg_cfg(models, 4, 32, 1, fc_dim=64),
             *image_batch(4, 32, SEED + 24), "pool5")
    log("  phase wall %.1f s" % (time.perf_counter() - t0))


def phase_resnet18_bf16_train(api, models):
    """ResNet-18 (models.resnet_config: bench.py's recipe, batch 128,
    224x224, batch_norm) trained in bf16 (image_train_phase); the recipe's
    eta 0.1 on a saturated softmax need not lower a fixed batch's loss in
    3 steps, so the loss is reported, not required to fall."""
    log("phase resnet18_bf16_train")
    x, y = image_batch(RESNET_BATCH, IMG_HW, SEED + 25)
    cfg = models.resnet_config(batch_size=RESNET_BATCH, input_hw=IMG_HW,
                               dev=NET_DEV) + "seed = %d\n" % SEED
    small = models.resnet_config(batch_size=8, input_hw=32, dev=NET_DEV) \
        + "seed = %d\n" % SEED
    image_train_phase("resnet18", api, cfg, x, y, "gap", small,
                      image_batch(8, 32, SEED + 26), loss_must_fall=False)


def phase_bench_bf16(lrn, flash, api, models):
    """bench.py's bf16 AlexNet (ImageNet.conf, batch 256) and bf16 LM
    (8 x 2048): AlexNet trained (image_train_phase) and served; the LM
    trained (4 + 4 + 4 flash launches a step on bf16 inputs, the flash
    layers against the plain versions, the gaps, tokens/s) and served
    (4 flash launches a request, time to first token, decode tokens/s).
    Returns {path: launches} for the LRN and flash kernels."""
    log("phase bench_bf16")
    t0 = time.perf_counter()
    cfg = imagenet_cfg()
    x, y = image_batch(BATCH, 227, SEED + 27)
    small_cfg = cfg.replace("batch_size = %d" % BATCH, "batch_size = 4")
    alex_fwd, alex_bwd = image_train_phase(
        "alexnet", api, cfg, x, y, "17", small_cfg,
        image_batch(4, 227, SEED + 28), lrn=lrn)
    net = api.Net(dev=NET_DEV, cfg=bf16_cfg(cfg))
    net.init_model()
    xs = torch.from_numpy(x).to(DEV)
    lrn.launches = lrn.no_norm_launches = 0
    net.predict_device(xs)
    torch.cuda.synchronize()
    alex_pred = lrn.launches
    if (alex_pred, lrn.no_norm_launches) != (2, 2):
        raise AssertionError("AlexNet bf16 predict: 2 LRN launches without "
                             "the norm expected")
    numpy_card_rates("AlexNet bf16 inference batch %d" % BATCH,
                     lambda: net.predict(x), lambda: net.predict_device(xs),
                     BATCH, iters=10)
    profile_forward(lambda: net.predict_device(xs), top=6)
    del net, xs
    torch.cuda.empty_cache()

    # the LM
    vocab, nlayer = LM_ARGS["vocab"], LM_ARGS["nlayer"]
    lcfg = bf16_cfg(lm_cfg(models, LM_SEQ, LM_BATCH))
    net = api.Net(dev=NET_DEV, cfg=lcfg)
    net.init_model()
    rng = np.random.RandomState(SEED + 29)
    tx = rng.randint(0, vocab, (LM_BATCH, 1, 1, LM_SEQ)).astype(np.float32)
    ty = rng.randint(0, vocab, (LM_BATCH, LM_SEQ)).astype(np.float32)
    fname = scratch_file("chip_smoke_lm_bf16.model")
    net.save_model(fname)
    with capture_calls(flash, "flash_fwd_cuda", 1) as (dtypes, kept):
        # the main path: the counts start at 0 here and are read right after
        flash.launches = flash.dq_launches = flash.dkv_launches = 0
        for _ in range(BF16_STEPS):
            net.update(tx, ty)
        torch.cuda.synchronize()
        lm_train = (flash.launches, flash.dq_launches, flash.dkv_launches)
    log("  LM bf16: flash_fwd, flash_bwd_dq, flash_bwd_dkv launches %s over "
        "%d steps (%d each per step expected)"
        % (lm_train, BF16_STEPS, nlayer))
    if lm_train != (nlayer * BF16_STEPS,) * 3:
        raise AssertionError("LM bf16 flash launches")
    require_dtype("flash_fwd_cuda on the LM's training path", dtypes,
                  torch.bfloat16)
    check_params_finite(net)
    flash_layers_vs_plain(flash, kept)
    del kept
    resident = data_batch(tx, ty, DEV)
    resident.data = resident.data.long()
    numpy_card_rates("LM bf16 training %d x %d" % (LM_BATCH, LM_SEQ),
                     lambda: net.update(tx, ty),
                     lambda: net.net_.update(resident), LM_BATCH * LM_SEQ,
                     unit="tokens")
    profile_forward(lambda: net.net_.update(resident), unit="step",
                    shares=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    del resident
    prompts = rng.randint(0, vocab, (LM_BATCH, LM_PROMPT))
    with capture_calls(flash, "flash_fwd_cuda", 0) as (dtypes, _):
        flash.launches = 0
        got = net.generate(prompts, LM_NEW)
        torch.cuda.synchronize()
        lm_serve = flash.launches
    if lm_serve != nlayer or got.shape != (LM_BATCH, LM_NEW) \
            or got.min() < 0 or got.max() >= vocab:
        raise AssertionError("LM bf16 generate: %d flash launches, tokens "
                             "%s" % (lm_serve, got.shape))
    require_dtype("flash_fwd_cuda on the LM's serving path", dtypes,
                  torch.bfloat16)
    caches = net.net_._net_for(LM_BATCH, 1)._last_cache_updates
    cache_dtypes = sorted(set(str(c.dtype)[6:] for c in caches.values()))
    log("  LM bf16 request: %d flash_fwd launches, %d tokens in range; %d "
        "KV caches in %s" % (lm_serve, got.size, len(caches), cache_dtypes))
    if cache_dtypes != ["bfloat16"]:
        raise AssertionError("the KV caches are not bf16")
    ttft = min(time_generate(net, prompts, None, 1))
    full = min(time_generate(net, prompts, None, LM_NEW))
    log("  LM bf16 serving batch %d, prompts %d: time to first token %.2f "
        "ms, request of %d tokens %.2f ms, decode %.1f tokens/s (best of 2)"
        % (LM_BATCH, LM_PROMPT, ttft * 1e3, LM_NEW, full * 1e3,
           LM_BATCH * (LM_NEW - 1) / (full - ttft)))
    del net
    torch.cuda.empty_cache()
    gap = bf16_gap(api, lm_cfg(models, LM_SEQ, LM_BATCH), fname, tx, ty,
                   "top[-1]", NET_DEV)
    log_gap("LM full size on the card", gap)
    if gap["features"] > FULL_GAP:
        raise AssertionError("LM bf16 beyond the sanity bar")
    os.remove(fname)
    sx = tx[:2, :, :, :256].copy()
    sy = ty[:2, :256].copy()
    gap_rule(api, lm_cfg(models, 256, 2), sx, sy, "top[-1]")
    log("  phase wall %.1f s" % (time.perf_counter() - t0))
    return ({"bench_bf16_alexnet_train": alex_fwd,
             "bench_bf16_alexnet_pred": alex_pred},
            {"bench_bf16_alexnet_train": alex_bwd},
            {"bench_bf16_lm_train": lm_train[0],
             "bench_bf16_lm_serve": lm_serve},
            {"bench_bf16_lm_train": lm_train[1]},
            {"bench_bf16_lm_train": lm_train[2]})


def phase_mobilenet_bf16_train(api, models, ops):
    """bench.py's MobileNet (models.mobilenet_config: batch 256, 224x224,
    MOBILENET_BLOCKS, base 32, the JAX mobilenet_trainer's SGD keys) in
    bf16 through api.Net(dev="gpu"): first the batched depthwise weight
    gradient (ops.conv2d_weight) held to float64 on MN_DW_CHECK's shapes
    in fp32 and timed beside cuDNN's torch.nn.grad.conv2d_weight (a
    yardstick the port does not call), in fp32 and bf16; then 1 warm-up
    and MISC_TIMED_STEPS timed update steps with the batch on the card
    (images/s), a profile of 2 steps (device-busy share), the weights
    finite, the reduced-size bf16 gap rule. Returns {"images_per_s",
    "busy_share", "dw": [(layer, port ms, cuDNN ms, bf16 port ms, bf16
    cuDNN ms, error)]}."""
    log("phase mobilenet_bf16_train")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 40)
    dw_rows = []
    for name, shape, stride in MN_DW_CHECK:
        c = shape[1]
        w_shape = (c, 1, 3, 3)
        oh = (shape[2] + 2 - 3) // stride + 1
        x = torch.randn(shape, generator=gen, device=DEV)
        g = torch.randn((shape[0], c, oh, oh), generator=gen, device=DEV)
        args = (stride, (1, 1), c)
        got = ops.conv2d_weight(x, w_shape, g, *args)
        want = cudnn_conv2d_weight(x.double(), w_shape, g.double(), *args)
        err = float((got.double() - want).abs().max() / want.abs().max())
        cudnn_err = float((cudnn_conv2d_weight(x, w_shape, g, *args)
                           .double() - want).abs().max() / want.abs().max())
        del want
        port_ms = time_ms(lambda: ops.conv2d_weight(x, w_shape, g, *args),
                          iters=5)
        cudnn_ms = time_ms(lambda: cudnn_conv2d_weight(x, w_shape, g, *args),
                           iters=5)
        xb, gb = x.bfloat16(), g.bfloat16()
        port_bf16 = time_ms(lambda: ops.conv2d_weight(xb, w_shape, gb,
                                                      *args), iters=5)
        cudnn_bf16 = time_ms(lambda: cudnn_conv2d_weight(xb, w_shape, gb,
                                                         *args), iters=5)
        ok = err <= WGRAD_TOL
        log("  depthwise %s input %s stride %d, %d groups: port weight grad "
            "vs float64 max_err/max %.3e (tolerance %.0e) %s; cuDNN's %.3e "
            "(yardstick); fp32 port %.3f ms, cuDNN %.3f ms (yardstick); "
            "bf16 port %.3f ms, cuDNN %.3f ms (yardstick)"
            % (name, shape, stride, c, err, WGRAD_TOL,
               "ok" if ok else "FAILED", cudnn_err, port_ms, cudnn_ms,
               port_bf16, cudnn_bf16))
        if not ok:
            raise AssertionError("depthwise weight gradient off float64")
        dw_rows.append((name, port_ms, cudnn_ms, port_bf16, cudnn_bf16, err))
        del x, g, xb, gb, got
        torch.cuda.empty_cache()

    cfg = models.mobilenet_config(batch_size=MN_BATCH, input_hw=IMG_HW,
                                  dev=NET_DEV) + "seed = %d\n" % SEED
    net = api.Net(dev=NET_DEV, cfg=bf16_cfg(cfg))
    net.init_model()
    if net.net_.net.compute_dtype != torch.bfloat16:
        raise AssertionError("the net does not compute in bf16")
    x, y = image_batch(MN_BATCH, IMG_HW, SEED + 41)
    resident = data_batch(x, y, DEV)
    loss0 = step_loss(net, resident)
    t = time.perf_counter()
    net.update(x, y)
    torch.cuda.synchronize()
    log("  warm-up step from numpy %.2f s" % (time.perf_counter() - t))
    t = time.perf_counter()
    for _ in range(MISC_TIMED_STEPS):
        net.net_.update(resident)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rate = MISC_TIMED_STEPS * MN_BATCH / wall
    log("  MobileNet bf16 training batch %d: %d steps in %.4f s, %.1f "
        "images/s (the batch on the card)"
        % (MN_BATCH, MISC_TIMED_STEPS, wall, rate))
    loss1 = step_loss(net, resident)
    log("  the step's loss on the fixed batch %.6f before, %.6f after %d "
        "steps" % (loss0, loss1, 1 + MISC_TIMED_STEPS))
    if not np.isfinite(loss1):
        raise AssertionError("MobileNet bf16 loss not finite")
    check_params_finite(net)
    busy = step_profile(lambda: net.net_.update(resident),
                        wall * 1e3 / MISC_TIMED_STEPS)
    del net, resident
    torch.cuda.empty_cache()
    small = models.mobilenet_config(dev=NET_DEV, **MN_SMALL) \
        + "seed = %d\n" % SEED
    gap_rule(api, small, *image_batch(MN_SMALL["batch_size"],
                                      MN_SMALL["input_hw"], SEED + 42),
             "gap")
    log("  phase wall %.1f s" % (time.perf_counter() - t0))
    return {"images_per_s": rate, "busy_share": busy, "dw": dw_rows}


def step_loss(net, batch):
    """The loss a training step on ``batch`` takes (the trainer's own,
    from log-softmax: finite where a bf16 net's softmax underflows to 0),
    without stepping."""
    return float(net.net_.loss_and_grads(batch)[0])


def step_profile(step, step_ms, iters=2, shares=()):
    """The device-busy share of a training step: its kernel time a step,
    from a profile of ``iters`` calls (profile_forward, no warm-up: the
    step is warm), over ``step_ms``, the wall a step of the timed run
    without the profiler. None where the profile recorded no device
    time."""
    busy_ms = profile_forward(step, iters=iters, unit="step", top=6,
                              warmup=False, shares=shares)
    if busy_ms is None:
        return None
    log("  device-busy share %.3f: %.3f ms of kernels a step over %.3f ms "
        "of wall a step in the timed steps" % (busy_ms / step_ms, busy_ms,
                                               step_ms))
    return busy_ms / step_ms


def vit_flash_rows(flash, q, k, v, causal, scale, window):
    """Rows 4-6 at the ViT step's own attention input (bf16, not causal):
    each kernel timed against its bf16 bound (flash_work / flash_bwd_work
    at BF16_OPS_PER_S, or the bytes), the plain versions' times, and SDPA
    and its autograd as the library yardstick. Returns {kernel: record}."""
    import torch.nn.functional as F
    args = (causal, scale, window)
    b, h, L, d = q.shape
    nkv = k.shape[1]
    out, lse = flash.flash_fwd_cuda(q, k, v, *args)
    ref_out, _ = flash.flash_fwd_ref(q, k, v, *args)
    fwd_err = float((out.float() - ref_out.float()).abs().max())
    gen = torch.Generator(device=DEV).manual_seed(SEED + 43)
    dout = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    delta = flash.bwd_delta(out, dout)
    ref = flash.flash_bwd_ref(q, k, v, out, lse, dout, *args)
    dq = flash.flash_bwd_dq_cuda(q, k, v, dout, lse, delta, *args)
    dk, dv = flash.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, *args)
    errs = {"dq": float((dq.float() - ref[0].float()).abs().max()),
            "dkv": max(float((dk.float() - ref[1].float()).abs().max()),
                       float((dv.float() - ref[2].float()).abs().max()))}
    times = {
        "flash_fwd": time_ms(lambda: flash.flash_fwd_cuda(q, k, v, *args)),
        "flash_bwd_dq": time_ms(lambda: flash.flash_bwd_dq_cuda(
            q, k, v, dout, lse, delta, *args)),
        "flash_bwd_dkv": time_ms(lambda: flash.flash_bwd_dkv_cuda(
            q, k, v, dout, lse, delta, *args))}
    plain_fwd = time_ms(lambda: flash.flash_fwd_ref(q, k, v, *args), iters=5)
    plain_bwd = time_ms(lambda: flash.flash_bwd_ref(q, k, v, out, lse, dout,
                                                    *args), iters=3,
                        warmup=1)
    sdpa = sdpa_ms(F, q, k, v, causal, window, ref_out)
    sdpa_bwd = sdpa_bwd_ms(F, q, k, v, dout, causal, window, ref)
    works = {"flash_fwd": flash_work(b, h, nkv, L, d, causal, window,
                                     q.element_size())}
    works["flash_bwd_dq"], works["flash_bwd_dkv"] = flash_bwd_work(
        b, h, nkv, L, d, causal, window, q.element_size())
    recs = {}
    for name, ms in times.items():
        ops_n, nbytes = works[name]
        ops_ms = ops_n / BF16_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        fwd = name == "flash_fwd"
        recs[name] = {
            "ms": ms, "plain_ms": plain_fwd if fwd else plain_bwd,
            "library_ms": sdpa if fwd else sdpa_bwd, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "max_abs_err": fwd_err if fwd else errs[name[10:]],
            "at": "the ViT-S/16 step's attention (%d, %d, %d, %d) bf16, not "
                  "causal" % (b, h, L, d)}
        log("  %s at the ViT shape: kernel_ms %.4f bound_ms %.4f (%s: %.3e "
            "operations at %.0f TFLOP/s, %d bytes) kernel/bound %.2f; "
            "plain_ms %.4f library_ms %.4f%s"
            % (name, ms, bound_ms, recs[name]["bound_by"], ops_n,
               BF16_OPS_PER_S / 1e12, nbytes, ms / bound_ms,
               recs[name]["plain_ms"], recs[name]["library_ms"],
               "" if fwd else " (plain and library: the whole backward)"))
    del out, lse, ref_out, dout, delta, ref, dq, dk, dv
    return recs


def phase_vit_s16_bf16_train(flash, api, models):
    """bench.py's ViT-S/16 (models.vit_config: batch 128, 224x224, patch
    16, dim 384, 6 heads, 12 blocks, FFN x4, AdamW) in bf16 through
    api.Net(dev="gpu"): the flash launches of 1 warm-up and
    MISC_TIMED_STEPS timed update steps (12 forward, 12 dQ and 12 dK/dV a
    step: one attention layer a block, 196 positions and head dim 64 take
    the flash route, not causal), their inputs bf16; images/s with the
    batch on the card; a profile (device-busy share); the flash kernels
    against their plain versions on the step's own attention input
    (flash_layers_vs_plain) and rows 4-6 timed there (vit_flash_rows);
    the weights finite; the reduced-size bf16 gap rule. Returns
    ((fwd, dq, dkv) launches of the main path, {"images_per_s",
    "busy_share", "rows": {kernel: record}})."""
    log("phase vit_s16_bf16_train")
    t0 = time.perf_counter()
    nlayer = VIT_ARGS["nlayer"]
    cfg = models.vit_config(batch_size=VIT_BATCH, dev=NET_DEV, **VIT_ARGS) \
        + "seed = %d\n" % SEED
    net = api.Net(dev=NET_DEV, cfg=bf16_cfg(cfg))
    net.init_model()
    x, y = image_batch(VIT_BATCH, IMG_HW, SEED + 44)
    resident = data_batch(x, y, DEV)
    loss0 = step_loss(net, resident)
    steps = 1 + MISC_TIMED_STEPS
    with capture_calls(flash, "flash_fwd_cuda", 1) as (dtypes, kept):
        # the main path: the counts start at 0 here and are read right after
        flash.launches = flash.dq_launches = flash.dkv_launches = 0
        t = time.perf_counter()
        net.update(x, y)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(MISC_TIMED_STEPS):
            net.net_.update(resident)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = (flash.launches, flash.dq_launches, flash.dkv_launches)
    rate = MISC_TIMED_STEPS * VIT_BATCH / wall
    log("  warm-up step from numpy %.2f s; ViT-S/16 bf16 training batch %d: "
        "%d steps in %.4f s, %.1f images/s (the batch on the card)"
        % (warm, VIT_BATCH, MISC_TIMED_STEPS, wall, rate))
    log("  flash_fwd, flash_bwd_dq, flash_bwd_dkv launches %s over %d steps: "
        "%s a step (%d each expected: one attention layer a block)"
        % (launches, steps, tuple(n // steps for n in launches), nlayer))
    if launches != (nlayer * steps,) * 3:
        raise AssertionError("ViT flash launches")
    require_dtype("flash_fwd_cuda on the ViT's training path", dtypes,
                  torch.bfloat16)
    q = kept[0][0][0]
    log("  the step's attention input q %s %s, causal %s"
        % (tuple(q.shape), str(q.dtype)[6:], kept[0][0][3:4]))
    if tuple(q.shape) != (VIT_BATCH, VIT_ARGS["nhead"], 196, 64) \
            or kept[0][0][3]:
        raise AssertionError("the ViT attention is not (128, 6, 196, 64) "
                             "non-causal")
    loss1 = step_loss(net, resident)
    log("  the step's loss on the fixed batch %.6f before, %.6f after %d "
        "steps" % (loss0, loss1, steps))
    if not np.isfinite(loss1):
        raise AssertionError("ViT bf16 loss not finite")
    check_params_finite(net)
    busy = step_profile(lambda: net.net_.update(resident),
                        wall * 1e3 / MISC_TIMED_STEPS,
                        shares=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    del net, resident
    torch.cuda.empty_cache()
    flash_layers_vs_plain(flash, kept)
    args, kw = kept[0]
    rows = vit_flash_rows(flash, *args[:3], *args[3:], **kw)
    del kept, args
    torch.cuda.empty_cache()
    small = models.vit_config(dev=NET_DEV, **VIT_SMALL) + "seed = %d\n" % SEED
    gap_rule(api, small, *image_batch(VIT_SMALL["batch_size"],
                                      VIT_SMALL["image_hw"], SEED + 45,
                                      VIT_SMALL["n_class"]), "gp")
    log("  phase wall %.1f s" % (time.perf_counter() - t0))
    return launches, {"images_per_s": rate, "busy_share": busy,
                      "rows": rows}


MISC_NET = """netconfig = start
layer[0->t] = tanh
layer[t->m] = maxout
  ngroup = 2
layer[m->sq] = im2seq
layer[sq->ex] = extern:ex
  op = chip_scale_shift
  gain = 1.5
layer[ex->f] = flatten
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
batch_size = 8
label_vec[0,5) = ml
label_vec[5,8) = l2
eta = 0.1
momentum = 0.9
wd = 0.0001
seed = %d
"""


class ChipScaleShift:
    """layers_misc's extern op: y = x * scale + shift per channel, its
    weights drawn from the layer's init generator."""

    def infer_shape(self, in_shapes, setting):
        return [in_shapes[0]]

    def init_params(self, gen, in_shapes, setting):
        c = in_shapes[0][1]
        return {"scale": torch.full((c,), float(setting.get("gain", 1.0)))
                + torch.rand(c, generator=gen),
                "shift": torch.randn(c, generator=gen) * 0.1}

    def apply(self, params, inputs, *, train, generator):
        return [inputs[0] * params["scale"][:, None, None]
                + params["shift"][:, None, None]]


def misc_step(api, cfg, fname, x, y, dev):
    """(loss, gradients, weights after one update) of the layers_misc net
    loaded from ``fname`` on ``dev``, as float64 host tensors."""
    net = api.Net(dev=dev, cfg=cfg)
    net.load_model(fname)
    loss, grads = net.net_.loss_and_grads(
        data_batch(x, y, "cpu" if dev == "cpu" else DEV))
    grads = [{k: v.detach().double().cpu() for k, v in p.items()}
             for p in grads]
    net.update(x, y)
    return float(loss), grads, [{k: v.detach().double().cpu()
                                 for k, v in p.items()}
                                for p in net.net_.params]


def phase_layers_misc(api):
    """A small net of every layer type that slice 19 added (tanh, maxout,
    im2seq, a registered extern op, moe with top_k, softplus, fixconn from
    a file written here, bias, multi_logistic, l2_loss) trained one step
    on the card, held to the same step on the port's CPU path in fp32:
    the loss within relative MISC_RTOL, every gradient within MISC_RTOL of
    its layer's largest, every weight after the step within MISC_RTOL of
    its tensor's largest magnitude."""
    from cxxnet_tpu_torch.layer import register_extern
    log("phase layers_misc")
    t0 = time.perf_counter()
    register_extern("chip_scale_shift", ChipScaleShift)
    with scratch_dir("chip_smoke_layers_misc") as d:
        rng = np.random.RandomState(SEED + 46)
        cells = sorted({(int(rng.randint(12)), int(rng.randint(16)))
                        for _ in range(40)})
        fx = os.path.join(d, "fixconn.txt")
        with open(fx, "w") as f:
            f.write("12 16 %d\n" % len(cells))
            for r, c in cells:
                f.write("%d %d %r\n"
                        % (r, c, float(np.float32(rng.randn()))))
        cfg = MISC_NET % (fx, SEED)
        init = api.Net(dev="cpu", cfg=cfg)
        init.init_model()
        fname = os.path.join(d, "misc.model")
        init.save_model(fname)
        types = sorted({lay.type_name for lay in init.net_.net.layers})
        log("  layer types: %s" % ", ".join(types))
        x = rng.randn(8, 4, 6, 6).astype(np.float32)
        y = np.concatenate([rng.randint(0, 2, (8, 5)), rng.randn(8, 3)],
                           axis=1).astype(np.float32)
        card = misc_step(api, cfg, fname, x, y, NET_DEV)
        cpu = misc_step(api, cfg, fname, x, y, "cpu")
        lerr = abs(card[0] - cpu[0]) / abs(cpu[0])
        gerr = werr = 0.0
        for g_card, g_cpu in zip(card[1], cpu[1]):
            largest = max([float(v.abs().max()) for v in g_cpu.values()]
                          + [0.0])
            for k, v in g_cpu.items():
                if largest > 0:
                    gerr = max(gerr, float((g_card[k] - v).abs().max())
                               / largest)
        for w_card, w_cpu in zip(card[2], cpu[2]):
            for k, v in w_cpu.items():
                werr = max(werr, float((w_card[k] - v).abs().max()
                                       / v.abs().max().clamp_min(1e-30)))
        ok = max(lerr, gerr, werr) <= MISC_RTOL
        log("  one fp32 step, card vs CPU: loss %.6f vs %.6f (rel %.3e), "
            "gradients max_err/layer's max %.3e, weights after the step "
            "max_err/max %.3e (tolerance %.0e) %s"
            % (card[0], cpu[0], lerr, gerr, werr, MISC_RTOL,
               "ok" if ok else "FAILED"))
        if not ok:
            raise AssertionError("layers_misc: the card's step departs from "
                                 "the CPU's")
    log("  phase wall %.1f s" % (time.perf_counter() - t0))


# ----------------------------------------------------------------------
# the modes over ranks: DIST_N processes on the one card, over gloo
DIST_N = 4
DIST_STEPS = 2
# (phase, case, the mode's keys, net): each case trains DIST_STEPS steps of
# one batch from the config's seed, in the same DIST_N processes in turn
DIST_CASES = [
    ("dist_imagenet", "zero1_dp4", "update_on_server = 1\n", "imagenet"),
    ("dist_imagenet", "fsdp_dp4", "fsdp = 1\n", "imagenet"),
    ("dist_imagenet", "dp2_tp2", "model_parallel = 2\n", "imagenet"),
    ("dist_lm", "lm_bf16_dp2_tp2", "model_parallel = 2\n", "lm"),
    ("dist_lm", "moe_dp2_ep2", "expert_parallel = 2\n", "moe"),
    # the pipeline (GPipe over a pipe axis, pipeline_micro 0: one
    # microbatch a stage) and seq_parallel over a real sp axis
    ("dist_pipe", "lm_bf16_pp2_tp2",
     "pipeline_parallel = 2\nmodel_parallel = 2\n", "lm"),
    ("dist_pipe", "lm_bf16_pp2_sp2",
     "pipeline_parallel = 2\nseq_parallel = 2\n", "lm"),
    ("dist_pipe", "imagenet_pp2_dp2_zero1", "pipeline_parallel = 2\nfsdp = "
     "1\n", "imagenet"),
    # held to the single rank's seq_parallel = 2, the same two ring shards
    # as virtual ranks in one process: the ranks' ring is the virtual
    # ring's, step for step, where against one flash pass the ring's bf16
    # rounding, amplified by Adam, stood at 0.131 / 0.084 (worst / median
    # on the H100) over the bar
    ("dist_sp", "lm_bf16_dp2_sp2", "", "lm_sp2"),
]
# the ring-step kernels at the sequence-parallel ranks' own shapes (b 4,
# h 8, d 64 of the bf16 LM): a stage's query chunk of 1,024 against the
# whole 2,048 at each chunk's offset (lm_bf16_pp2_sp2), and the two-rank
# ring's shards of 1,024 in each class of offsets (lm_bf16_dp2_sp2);
# checked against the plain versions before the ranks run, not timed:
# (name, bh, bkv, sq, skv, d, q_off, kv_off, causal, window)
DIST_RING_SHAPES = [
    ("dist_pp_sp_chunk0", 32, 32, 1024, 2048, 64, 0, 0, True, 0),
    ("dist_pp_sp_chunk1", 32, 32, 1024, 2048, 64, 1024, 0, True, 0),
    ("dist_sp_diagonal", 32, 32, 1024, 1024, 64, 1024, 1024, True, 0),
    ("dist_sp_visible", 32, 32, 1024, 1024, 64, 1024, 0, True, 0),
    ("dist_sp_masked", 32, 32, 1024, 1024, 64, 0, 1024, True, 0),
]
# the n-rank step against the single rank's, as the L2 norm of the
# difference of the weights after the steps over the L2 norm of the single
# rank's change, per tensor. The ranks sum the batch's gradient per rank
# and then over the ranks, in another order than one rank's (cuDNN off on
# both sides): the first step differs by float32 rounding (7e-6 at most in
# the CPU rehearsal), and from the second step on an activation within
# rounding of a max-pooling tie or of ReLU's zero can fall the other way
# and route a gradient elsewhere (1e-3 in the rehearsal at 2 steps, 5e-3
# at 3). fp32 (ImageNet.conf and its moe trunk): 1e-2. bf16 (the LM): 1e-1,
# the bf16 matmuls of rows split otherwise round a bf16 ulp (2^-8) apart,
# and Adam's first steps move each weight by about eta whatever the size
# of its gradient. A wrong gather order or a gradient summed once too often
# moves a tensor by its whole step or more (a ratio of order 1)
DIST_STEP_TOL = {"imagenet": 1e-2, "moe": 1e-2, "lm": 1e-1, "lm_sp2": 1e-1}
# the LRN inputs of a rank of the ImageNet.conf cases: batch 64 at dp 4,
# 128 at dp 2 (after tensor parallelism's gather of the conv channels);
# checked against the plain versions, not timed, before the ranks run
DIST_LRN_SHAPES = {"%s_b%d" % (name, b): (b,) + shape[1:]
                   for b in (BATCH // DIST_N, BATCH // 2)
                   for name, shape in LRN_SHAPES.items()}
# a rank's bytes against the single rank's. ZeRO-1's optimizer state: its
# rule (zero_sharding, the JAX package's) splits dimension 0 alone, which
# is ngroup (1 or 2) for every conv weight of AlexNet, so the convs' state
# (3.8% of the weights) stays whole and the rest is a quarter: 0.28 by the
# rule, at most 0.3. fsdp's weights and state: a quarter, plus the 1-D
# biases it leaves whole (0.02% of AlexNet's weights): at most 1.01 / 4
DIST_ZERO1_OPT_MAX = 0.3
DIST_FSDP_MAX = 1.01 / 4

DIST_WORKER = r"""
import json, sys, time
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
import torch.distributed as dist
torch.backends.cudnn.enabled = False
from cxxnet_tpu_torch import api
from cxxnet_tpu_torch.ops import flash_attn, lrn, ring_flash
from cxxnet_tpu_torch.parallel import collectives, multihost
rank = int(sys.argv[1])
# started as a user starts a rank: coordinator / num_worker / worker_rank
multihost.init_distributed(%(coord)r, %(n)d, rank,
                           dev="%(kind)s:0-%(last)d")
card = torch.cuda.is_available()
sync = torch.cuda.synchronize if card else (lambda: None)
# the collectives on the card's tensors: gloo's own all_reduce,
# all_gather and reduce_scatter (not staged), values checked; gloo's
# all_to_all raises (a send would abort the process, so it is not
# tried); the port's all_to_all and ring_shift, staged through host
# memory (collectives._STAGED), values checked
n = %(n)d
probe = {}
t = torch.full((2 * n,), float(rank + 1), device=%(tdev)r)
def _ar():
    u = t.clone()
    dist.all_reduce(u)
    return bool((u == n * (n + 1) / 2).all())
def _ag():
    out = [torch.empty(2 * n, device=%(tdev)r) for _ in range(n)]
    dist.all_gather(out, t)
    return all(bool((o == r + 1).all()) for r, o in enumerate(out))
def _rs():
    out = torch.empty(2, device=%(tdev)r)
    dist.reduce_scatter(out, list(t.chunk(n)))
    return bool((out == n * (n + 1) / 2).all())
def _a2a_raw():
    dist.all_to_all([torch.empty(2, device=%(tdev)r) for _ in range(n)],
                    list(t.chunk(n)))
    return True
x = torch.arange(n * 2, dtype=torch.float32, device=%(tdev)r) + 10 * rank
def _a2a():
    y = collectives.all_to_all(x, split_axis=0, concat_axis=0)
    want = torch.tensor([10 * r + 2 * rank + k for r in range(n)
                         for k in range(2)], dtype=torch.float32)
    return y.is_cuda == x.is_cuda and torch.equal(y.cpu(), want)
def _shift():
    y = collectives.ring_shift(x, shift=1)
    return torch.equal(y.cpu(), x.cpu() - 10 * rank + 10 * ((rank - 1) %% n))
for name, fn in (("all_reduce", _ar), ("all_gather", _ag),
                 ("reduce_scatter", _rs), ("gloo_all_to_all", _a2a_raw),
                 ("port_all_to_all", _a2a), ("port_ring_shift", _shift)):
    try:
        probe[name] = "ok" if fn() else "wrong values"
    except Exception as e:
        probe[name] = type(e).__name__ + ": " + str(e).splitlines()[0][:120]
    dist.barrier()
print("DISTREC " + json.dumps({"rank": rank, "probe": probe,
                               "backend": dist.get_backend()}), flush=True)
for job in json.load(open(%(jobs)r)):
    net = api.Net(dev="%(kind)s:0-%(last)d", cfg=job["cfg"])
    t0 = time.perf_counter()
    net.init_model()
    tr = net.net_
    d = np.load(job["batch"])
    x, y = d["x"], d["y"]
    sync()
    init_s = time.perf_counter() - t0
    # the main path's counts start at 0 here and are read right after
    lrn.launches = lrn.bwd_launches = 0
    flash_attn.launches = flash_attn.dq_launches = flash_attn.dkv_launches = 0
    ring_flash.fwd_launches = ring_flash.dq_launches = 0
    ring_flash.dkv_launches = 0
    collectives.hops = collectives.hop_bytes = 0
    walls = []
    for _ in range(job["steps"]):
        t0 = time.perf_counter()
        net.update(x, y)
        sync()
        walls.append(time.perf_counter() - t0)
    counts = {"lrn_fwd": lrn.launches, "lrn_bwd": lrn.bwd_launches,
              "flash_fwd": flash_attn.launches,
              "flash_bwd_dq": flash_attn.dq_launches,
              "flash_bwd_dkv": flash_attn.dkv_launches,
              "ring_fwd_step": ring_flash.fwd_launches,
              "ring_dq_step": ring_flash.dq_launches,
              "ring_dkv_step": ring_flash.dkv_launches,
              "hops": collectives.hops, "hop_bytes": collectives.hop_bytes}
    rec = {"rank": rank, "case": job["case"], "counts": counts,
           "walls": walls, "init_s": init_s, "mesh": tr.mesh.shape,
           "param_bytes": tr.param_bytes(), "opt_bytes": tr.opt_bytes(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if card
           else 0.0}
    t0 = time.perf_counter()
    net.save_model(job["model"])
    rec["save_s"] = time.perf_counter() - t0
    print("DISTREC " + json.dumps(rec), flush=True)
    del net, tr
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
dist.destroy_process_group()
"""


def dist_cfg(models, net, keys=""):
    """The config of a dist case's net on one rank, with the mode keys."""
    if net.startswith("lm"):
        cfg = bf16_cfg(lm_cfg(models, LM_SEQ, LM_BATCH))
        if net == "lm_sp2":
            cfg += "seq_parallel = 2\n"
    else:
        cfg = imagenet_cfg()
        if net == "moe":
            # fc7 as a mixture of 8 experts of its width
            cfg = cfg.replace("layer[18->19] = fullc\n",
                              "layer[18->19] = moe\n  nexpert = 8\n", 1)
            assert "= moe" in cfg, "ImageNet.conf's fc7 not found"
    return cfg + keys


DIST_KERNELS = ("lrn_fwd", "lrn_bwd", "flash_fwd", "flash_bwd_dq",
                "flash_bwd_dkv", "ring_fwd_step", "ring_dq_step",
                "ring_dkv_step")


def dist_expect(models, keys, net):
    """What each of the DIST_N ranks of a case should show, from the
    port's own plan of it (the trainer's mesh, stage plan and placements,
    built shape-only on the host: no weights, no process group): per rank
    {"steps": {kernel or "hops" / "hop_bytes": count a step}, "param_bytes":
    the weight bytes it holds, "opt_bytes": its optimizer state's (None
    where the older cases' fractions hold it instead)}. A stage runs each
    microbatch's forward twice (the forward, the backward's recompute)
    and its backward once; the ring over an sp axis of n ranks n steps a
    layer each way; a stage's query chunk one ring step each way."""
    from cxxnet_tpu_torch.nnet import trainer as ttrainer
    from cxxnet_tpu_torch.parallel import mesh as tmesh
    from cxxnet_tpu_torch.parallel import sharding
    from cxxnet_tpu_torch.updater import create_updater
    from cxxnet_tpu_torch.utils.config import parse_config_string
    out = []
    for r in range(DIST_N):
        tr = ttrainer.Trainer()
        for k, v in parse_config_string(dist_cfg(models, net, keys)):
            tr.set_param(k, v)
        tr.set_param("dev", "cpu")
        tr.mesh = tmesh.create_mesh(
            tr.model_parallel, tr.expert_parallel, tr.batch_size, n=DIST_N,
            rank=r, groups=False, pipeline_parallel=tr.pipeline_parallel,
            seq_parallel=tr.seq_parallel, pipeline_micro=tr.pipeline_micro)
        tr.net_cfg.configure(tr.cfg_pairs)
        tnet = tr.net = tr._new_net(tr.net_cfg, tr.batch_size, True)
        tr._setup_pipeline()
        tr._setup_layout()
        mesh, pp = tr.mesh, tr._pp
        kinds = [lay.type_name for lay in tnet.layers]
        n_att = kinds.count("attention")
        sp, dp = mesh.axis_size("sp"), mesh.axis_size("data")
        steps = dict.fromkeys(DIST_KERNELS + ("hops", "hop_bytes"), 0)
        shapes = tnet.param_shapes()

        def block(i, k):
            return int(np.prod(sharding.shard_shape(
                shapes[i][k], mesh, tr._store_spec[i][k])))
        if pp is None:
            if "lrn" in kinds:
                steps["lrn_fwd"] = steps["lrn_bwd"] = kinds.count("lrn")
            if sp > 1:
                for k in ("ring_fwd_step", "ring_dq_step", "ring_dkv_step"):
                    steps[k] = sp * n_att
            else:
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                    steps[k] = n_att
            out.append({"steps": steps, "param_bytes": None,
                        "opt_bytes": None})
            continue
        s, k_, nm = pp["stage"], pp["k"], pp["n_micro"]
        lo, hi = pp["stages"][s]
        stage = kinds[lo:hi]
        steps["lrn_fwd"] = 2 * nm * stage.count("lrn")
        steps["lrn_bwd"] = nm * stage.count("lrn")
        att = ("ring_fwd_step", "ring_dq_step", "ring_dkv_step") if sp > 1 \
            else ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        steps[att[0]] = 2 * nm * stage.count("attention")
        steps[att[1]] = steps[att[2]] = nm * stage.count("attention")
        bounds = tnet.pipeline_boundaries(pp["stages"], pp["first_loss"])
        rows = tr.batch_size // dp // nm

        def nbytes(n):
            esize = 4 if (n in tnet.id_nodes or tr.compute_dtype is None) \
                else 2
            return rows * int(np.prod(tnet.node_shapes[n][1:])) * esize
        if s < k_ - 1:      # the forward's sends, a microbatch each
            steps["hops"] += nm * len(bounds[s + 1])
            steps["hop_bytes"] += nm * sum(nbytes(n) for n in bounds[s + 1])
        if s > 0:           # the backward's, the inputs' gradients
            steps["hops"] += nm * len(bounds[s])
            steps["hop_bytes"] += nm * sum(nbytes(n) for n in bounds[s])
        owned = [(i, k) for i in range(len(shapes)) if tr._owns(i)
                 for k in shapes[i]]
        # the weights an updater steps: each layer's visited tensors
        stepped = [(i, k) for i, k in owned if k in
                   {key for _, key in tnet.layers[i].visit_order()}]
        n_state = len(create_updater(tr.net_cfg.updater_type, "wmat")
                      .init_state(torch.zeros(1)))
        elems = sum(block(i, k) for i, k in stepped)
        if tr.fsdp and dp > 1:
            c = -(-elems // dp)
            d = mesh.coords["data"]
            elems = max(0, min(c, elems - d * c))
        out.append({"steps": steps,
                    "param_bytes": 4 * sum(block(i, k) for i, k in owned),
                    "opt_bytes": 4 * n_state * elems})
    return out


def dist_batch(net, path):
    """One batch of the case's net from SEED, written to ``path``."""
    if net.startswith("lm"):
        rng = np.random.RandomState(SEED + 23)
        v = LM_ARGS["vocab"]
        x = rng.randint(0, v, (LM_BATCH, 1, 1, LM_SEQ)).astype(np.float32)
        y = rng.randint(0, v, (LM_BATCH, LM_SEQ)).astype(np.float32)
    else:
        x, y = image_batch(BATCH, 227, SEED + 23)
    np.savez(path, x=x, y=y)


def dist_single(api, cfg, path, steps):
    """The single rank's weights before and after ``steps`` updates on the
    batch at ``path``, its bytes and its step walls."""
    net = api.Net(dev=NET_DEV, cfg=cfg)
    net.init_model()
    d = np.load(path)
    before = [{k: np.array(v) for k, v in p.items()}
              for p in net.net_.canonical_params()]
    walls = []
    for _ in range(steps):
        t = time.perf_counter()
        net.update(d["x"], d["y"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    out = {"before": before, "after": net.net_.canonical_params(),
           "param_bytes": net.net_.param_bytes(),
           "opt_bytes": net.net_.opt_bytes(), "walls": walls}
    del net
    torch.cuda.empty_cache()
    return out


def dist_step_errors(got, single):
    """Per tensor, |w_n - w_1|_2 / |w_1 - w_0|_2 (0 where the single rank
    did not move the tensor and neither did the n ranks)."""
    out = {}
    for i, (g, a, b) in enumerate(zip(got, single["after"],
                                      single["before"])):
        for k in a:
            diff = float(np.linalg.norm((g[k] - a[k]).ravel()))
            step = float(np.linalg.norm((a[k] - b[k]).ravel()))
            out["%d/%s" % (i, k)] = diff / step if step else (
                0.0 if diff == 0 else float("inf"))
    return out


def phase_dist(api, models):
    """dist_imagenet, dist_lm, dist_pipe and dist_sp: DIST_N ranks,
    processes of their own on the one card over gloo
    (CXXNET_DIST_BACKEND=gloo: NCCL refuses two ranks on one card),
    started through coordinator / num_worker / worker_rank, run every case
    of DIST_CASES in turn; each case's model file (rank 0's, the whole
    model) is held to the single-process run of the same steps and loads
    in a one-rank api.Net; the ranks' bytes, kernel launches and the
    pipeline's hops are read, each against what the port's own plan of the
    case predicts (``dist_expect``). The single-process runs go while the
    ranks start, and each case's file is checked while the ranks run the
    next case. Returns {phase: {kernel: launches over the ranks}}."""
    log("phase dist_imagenet + dist_lm + dist_pipe + dist_sp (%d ranks "
        "on one card over gloo, "
        "one spawn, the cases in turn)" % DIST_N)
    torch.cuda.empty_cache()
    launches = {}
    with scratch_dir("dist") as d:
        nets = sorted({c[3] for c in DIST_CASES})
        for net in nets:
            dist_batch(net, os.path.join(d, net + ".npz"))
        jobs = [{"case": case, "cfg": dist_cfg(models, net, keys),
                 "batch": os.path.join(d, net + ".npz"),
                 "model": os.path.join(d, case + ".model"),
                 "steps": DIST_STEPS} for _, case, keys, net in DIST_CASES]
        with open(os.path.join(d, "jobs.json"), "w") as f:
            json.dump(jobs, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        code = DIST_WORKER % {"repo": REPO, "n": DIST_N, "last": DIST_N - 1,
                              "coord": "127.0.0.1:%d" % port,
                              "kind": "cpu" if NET_DEV == "cpu" else "gpu",
                              "tdev": DEV,
                              "jobs": os.path.join(d, "jobs.json")}
        env = dict(os.environ, CXXNET_DIST_BACKEND="gloo",
                   PYTHONUNBUFFERED="1")
        t = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env) for r in range(DIST_N)]
        outs = [[] for _ in procs]
        pumps = [threading.Thread(target=lambda p=p, o=o: o.extend(p.stdout),
                                  daemon=True)
                 for p, o in zip(procs[1:], outs[1:])]
        for th in pumps:
            th.start()
        try:
            expects = {case: dist_expect(models, keys, net)
                       for _, case, keys, net in DIST_CASES}
            single = {}
            for net in nets:
                ts = time.perf_counter()
                old = torch.backends.cudnn.enabled
                torch.backends.cudnn.enabled = False
                try:
                    single[net] = dist_single(api, dist_cfg(models, net),
                                              os.path.join(d, net + ".npz"),
                                              DIST_STEPS)
                finally:
                    torch.cuda.synchronize()
                    torch.backends.cudnn.enabled = old
                log("  single rank %s: %d steps, walls %s s (%.1f s with "
                    "init; the ranks start meanwhile)"
                    % (net, DIST_STEPS, " ".join(
                        "%.3f" % w for w in single[net]["walls"]),
                       time.perf_counter() - ts))
            errs = {}
            net_of = {case: net for _, case, _, net in DIST_CASES}
            for ln in procs[0].stdout:
                outs[0].append(ln)
                if ln.startswith("DISTREC ") and '"case"' in ln:
                    case = json.loads(ln[len("DISTREC "):])["case"]
                    errs[case] = dist_file_errors(
                        api, models, net_of[case], single[net_of[case]],
                        os.path.join(d, case + ".model"))
            for p in procs:
                p.wait(timeout=600)
            for th in pumps:
                th.join(timeout=60)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        spawn_s = time.perf_counter() - t
        outs = ["".join(o) for o in outs]
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError("rank %d exited %d:\n%s"
                                     % (r, p.returncode, out[-4000:]))
        recs = [json.loads(ln[len("DISTREC "):]) for out in outs
                for ln in out.splitlines() if ln.startswith("DISTREC ")]
        probe = [r for r in recs if "probe" in r]
        log("  %d ranks, backend %s; the collectives on the card's tensors "
            "(gloo's own, and the port's staged through host memory: %s): "
            "%s" % (len(probe), probe[0]["backend"],
                    sorted(collectives_staged()), probe[0]["probe"]))
        for r in probe:
            bad = {k: v for k, v in r["probe"].items()
                   if (v != "ok") != (k == "gloo_all_to_all"
                                      and DEV == "cuda")}
            if bad:
                raise AssertionError("rank %d: collectives on the card: %s"
                                     % (r["rank"], bad))
        log("  the spawn: %.1f s wall, the single-process runs and every "
            "case's check included" % spawn_s)
        for phase, case, keys, net in DIST_CASES:
            rows = sorted((r for r in recs if r.get("case") == case),
                          key=lambda r: r["rank"])
            if len(rows) != DIST_N:
                raise AssertionError("%s: %d rank records" % (case,
                                                              len(rows)))
            log("  %s %s (mesh %s):" % (phase, case, rows[0]["mesh"]))
            s1 = single[net]
            for r in rows:
                log("    rank %d: step walls %s s (4 processes share one "
                    "card, collectives through host memory: no scaling "
                    "figure); init %.1f s, save %.1f s, peak %.2f GB; "
                    "launches %s; weight bytes %d (%.4f of one rank's), "
                    "optimizer bytes %d (%.4f)"
                    % (r["rank"], " ".join("%.3f" % w for w in r["walls"]),
                       r["init_s"], r["save_s"], r["peak_gb"], r["counts"],
                       r["param_bytes"], r["param_bytes"]
                       / s1["param_bytes"], r["opt_bytes"],
                       r["opt_bytes"] / s1["opt_bytes"]))
            # the launches, hops and a pipe rank's bytes the plan predicts
            for r in rows:
                e = expects[case][r["rank"]]
                for k, v in e["steps"].items():
                    if r["counts"][k] != v * DIST_STEPS:
                        raise AssertionError(
                            "%s rank %d: %d %s, the plan predicts %d"
                            % (case, r["rank"], r["counts"][k], k,
                               v * DIST_STEPS))
                for k in ("param_bytes", "opt_bytes"):
                    if e[k] is not None and r[k] != e[k]:
                        raise AssertionError(
                            "%s rank %d: %s %d, its stage's %d"
                            % (case, r["rank"], k, r[k], e[k]))
                if e["param_bytes"] is not None:
                    log("    rank %d holds its stage: weights %d bytes, "
                        "optimizer %d (%.4f of the stage's weights'); "
                        "hops %d, %d bytes over %d steps (as planned)"
                        % (r["rank"], r["param_bytes"], r["opt_bytes"],
                           r["opt_bytes"] / r["param_bytes"],
                           r["counts"]["hops"], r["counts"]["hop_bytes"],
                           DIST_STEPS))
            for k in DIST_KERNELS:
                n_k = sum(r["counts"][k] for r in rows)
                if n_k:
                    launches.setdefault(phase, {}).setdefault(k, 0)
                    launches[phase][k] += n_k
            frac_w = max(r["param_bytes"] for r in rows) / s1["param_bytes"]
            frac_o = max(r["opt_bytes"] for r in rows) / s1["opt_bytes"]
            if case.startswith("zero1") and frac_o > DIST_ZERO1_OPT_MAX:
                raise AssertionError("ZeRO-1 optimizer bytes %.4f of one "
                                     "rank's" % frac_o)
            if case.startswith("fsdp") and max(frac_w, frac_o) \
                    > DIST_FSDP_MAX:
                raise AssertionError("fsdp bytes %.4f / %.4f of one rank's"
                                     % (frac_w, frac_o))
            e = errs[case]
            worst = max(e, key=e.get)
            log("    the model file (rank 0's) in a one-rank api.Net vs "
                "the single-process run: |w_n - w_1| / |w_1 - w_0| worst "
                "%.3g (%s), median %.3g (bar %g)"
                % (e[worst], worst, float(np.median(list(e.values()))),
                   DIST_STEP_TOL[net]))
            if e[worst] > DIST_STEP_TOL[net]:
                raise AssertionError("%s: the %d-rank step is off the "
                                     "single rank's: %s %.3g"
                                     % (case, DIST_N, worst, e[worst]))
    return launches


def dist_file_errors(api, models, net, single, path):
    """dist_step_errors of the model file at ``path`` loaded in a one-rank
    api.Net on the card; the file is removed after."""
    one = api.Net(dev=NET_DEV, cfg=dist_cfg(models, net))
    one.load_model(path)
    errs = dist_step_errors(one.net_.canonical_params(), single)
    del one
    os.remove(path)
    torch.cuda.empty_cache()
    return errs


def collectives_staged():
    from cxxnet_tpu_torch.parallel import collectives
    return collectives._STAGED


def phase_dist_nccl_1():
    """One rank through multihost.init_distributed with no backend named,
    in this process, last: NCCL on the card, three collectives run."""
    import torch.distributed as dist
    from cxxnet_tpu_torch.parallel import multihost
    log("phase dist_nccl_1")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.pop("CXXNET_DIST_BACKEND", None)
    multihost.init_distributed("127.0.0.1:%d" % port, 1, 0, dev="gpu")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError("backend %s" % dist.get_backend())
        t = torch.arange(8, dtype=torch.float32, device=DEV)
        dist.all_reduce(t)
        g = torch.empty(8, device=DEV)
        dist.all_gather_into_tensor(g, t)
        r = torch.empty(8, device=DEV)
        dist.reduce_scatter_tensor(r, t)
        torch.cuda.synchronize()
        if not (torch.equal(g, t) and torch.equal(r, t)):
            raise AssertionError("nccl collectives: %s %s" % (g, r))
        log("  nccl %s: all_reduce, all_gather_into_tensor, "
            "reduce_scatter_tensor on %s" % (
                ".".join(map(str, torch.cuda.nccl.version())),
                torch.cuda.get_device_name(0)))
    finally:
        dist.destroy_process_group()


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
    prepare_host_inputs()
    libs = _build.build_kernels()
    t1 = time.time()
    log("build: %d kernels in %.2f s" % (len(libs), t1 - t0))
    host_input("ppm_train")
    log("the CLI phases' image records made beside the build in %.2f s "
        "(waited %.2f s for them after it)"
        % (_HOST_INPUTS["seconds"], time.time() - t1))
    start_cpu_gaps(models)
    for name, path in libs.items():
        with open(path[:-3] + ".log") as f:
            log("  %s: %s" % (name, ptxas_summary(f.read())))

    fwd_rec = phase_lrn_kernel(lrn)
    pred_launches = phase_alexnet_pred(lrn, api)
    bwd_rec = phase_lrn_bwd_kernel(lrn)
    train_fwd, train_bwd = phase_alexnet_train(lrn, api, ops)
    uniform_rec = phase_uniform_kernel(rnd)
    rows_rec = phase_uniform_rows_kernel(rnd)
    rrelu = phase_rrelu_alexnet_train(rnd, lrn, api, ops, models)
    phase_cli_mnist_conv(learn_task)
    cli_train, cli_pred, cli_resume, cli_health = phase_cli_imagenet(
        lrn, learn_task, api)
    c_abi = phase_c_abi_imagenet(lrn, api)
    phase_cli_bowl_pred_raw(learn_task, api)
    phase_jpeg_decode()
    cli_jpeg = phase_cli_imagenet_jpeg(lrn, learn_task, api)
    phase_cli_bowl_train(learn_task, api)
    export_fwd, export_flash = phase_exports(flash_attn, api, models)
    gnet_fwd_rec = phase_lrn_kernel(lrn, GNET_LRN_SHAPES, GNET_LRN_ARGS,
                                    "lrn_kernel_googlenet")
    gnet_bwd_rec = phase_lrn_bwd_kernel(lrn, GNET_LRN_SHAPES, GNET_LRN_ARGS,
                                        "lrn_bwd_kernel_googlenet")
    gnet_train = phase_googlenet_bf16_train(lrn, api, models)
    gnet_pred = phase_googlenet_bf16_pred(lrn, api, models)
    gnet_cli_train, gnet_cli_pred = phase_cli_googlenet(lrn, learn_task, api)
    phase_vgg16_bf16_remat(api, models)
    phase_resnet18_bf16_train(api, models)
    bench = phase_bench_bf16(lrn, flash_attn, api, models)
    phase_layers_misc(api)
    phase_mobilenet_bf16_train(api, models, ops)
    vit_launches, vit = phase_vit_s16_bf16_train(flash_attn, api, models)
    flash_rec = phase_flash_fwd_kernel(flash_attn)
    serve_launches = phase_lm_serve(flash_attn, api, models)
    long_launches = phase_lm_serve_long(flash_attn, api, models)
    sess_rows, sess_flash = phase_lm_serve_session(flash_attn, rnd, api,
                                                   models)
    phase_cli_lm_generate(learn_task, api, models)
    fe_rows, fe_flash = phase_lm_serve_frontend(flash_attn, rnd, api, models)
    cli_serve_flash = phase_cli_lm_serve(flash_attn, learn_task, api, models)
    cli_route_flash = phase_cli_lm_route(learn_task, api, models)
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
    for rec, check_fn in ((fwd_rec, phase_lrn_kernel),
                          (bwd_rec, phase_lrn_bwd_kernel)):
        err = check_fn(lrn, DIST_LRN_SHAPES, phase="%s at the ranks' shapes"
                       % check_fn.__name__[len("phase_"):],
                       timed=False)["max_abs_err"]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    log("phase ring_step_kernels at the sequence-parallel ranks' shapes "
        "(checked, not timed)")
    rng = np.random.RandomState(SEED + 29)
    for case in DIST_RING_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            err, _ = ring_step_case(ring_flash, case, dtype, rng, timed=False)
            if dtype == torch.float32:
                for rec in ring_recs.values():
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    torch.cuda.empty_cache()
    dist = phase_dist(api, models)
    phase_dist_nccl_1()

    def dist_by(name):
        return {p: c[name] for p, c in dist.items() if name in c}
    per_step = {"train_step": LM_ARGS["nlayer"]}
    vit_per = {"vit_s16_train_step": VIT_ARGS["nlayer"]}
    ring_per = {"layer_and_direction": SP_N * SP_N,
                "train_step": SP_N * SP_N * LM_ARGS["nlayer"],
                "dist_sp_rank_step": 2 * LM_ARGS["nlayer"],
                "dist_pipe_sp_rank_step_of_a_stage":
                    "2 x microbatches x its layers (forward), microbatches "
                    "x its layers (dQ, dK/dV)"}
    log("wall time %.1f s" % (time.time() - t0))
    kernels = []
    for name, rec, replaces, by_path, per in (
            ("lrn_fwd", fwd_rec, "cxxnet_tpu/ops/pallas_kernels.py:78",
             {"alexnet_pred": pred_launches, "alexnet_train": train_fwd,
              "rrelu_alexnet_train": rrelu[1],
              "cli_imagenet_train": cli_train[0],
              "cli_imagenet_resume": cli_resume[0],
              "cli_imagenet_health": sum(c[0] for c in cli_health.values()),
              "c_abi_imagenet": c_abi[0],
              "cli_imagenet_pred": cli_pred[0],
              "cli_imagenet_jpeg": cli_jpeg[0],
              "googlenet_bf16_train": gnet_train[0],
              "googlenet_bf16_pred": gnet_pred,
              "cli_googlenet_train": gnet_cli_train[0],
              "cli_googlenet_pred": gnet_cli_pred,
              "export_forward": export_fwd, **bench[0],
              **dist_by("lrn_fwd")},
             {"train_step": train_fwd // TRAIN_STEPS,
              "exported_imagenet_forward": 2}),
            ("lrn_bwd", bwd_rec, "cxxnet_tpu/ops/pallas_kernels.py:98",
             {"alexnet_train": train_bwd, "rrelu_alexnet_train": rrelu[2],
              "cli_imagenet_train": cli_train[1],
              "cli_imagenet_resume": cli_resume[1],
              "cli_imagenet_health": sum(c[1] for c in cli_health.values()),
              "c_abi_imagenet": c_abi[1],
              "cli_imagenet_jpeg": cli_jpeg[1],
              "googlenet_bf16_train": gnet_train[1],
              "cli_googlenet_train": gnet_cli_train[1], **bench[1],
              **dist_by("lrn_bwd")},
             {"train_step": train_bwd // TRAIN_STEPS}),
            ("uniform", uniform_rec, "cxxnet_tpu/ops/pallas_kernels.py:169",
             {"rrelu_alexnet_train": rrelu[0],
              "lm_serve_session": sess_rows,
              "lm_serve_frontend": fe_rows},
             {"train_step": rrelu[0] // TRAIN_STEPS,
              "sampled_step_or_admission": 1}),
            ("flash_fwd", flash_rec, "cxxnet_tpu/ops/flash_attn.py:284",
             {"lm_serve": serve_launches, "lm_serve_long": long_launches,
              "lm_serve_session": sess_flash,
              "lm_serve_frontend": fe_flash,
              "cli_lm_serve": cli_serve_flash,
              "cli_lm_route": cli_route_flash,
              "export_decode": export_flash, **serve_wide,
              **{p: c[0] for p, c in train.items()}, **bench[2],
              "vit_s16_bf16_train": vit_launches[0],
              **dist_by("flash_fwd")},
             {"generate_request": LM_ARGS["nlayer"],
              "session_admission": LM_ARGS["nlayer"],
              "frontend_admission": LM_ARGS["nlayer"],
              "full_sequence_forward": LM_ARGS["nlayer"],
              "exported_prefill_of_128_or_more": LM_ARGS["nlayer"],
              **per_step, **vit_per}),
            ("flash_bwd_dq", bwd_recs["dq"],
             "cxxnet_tpu/ops/flash_attn.py:337",
             {**{p: c[1] for p, c in train.items()}, **bench[3],
              "vit_s16_bf16_train": vit_launches[1],
              **dist_by("flash_bwd_dq")},
             {**per_step, **vit_per}),
            ("flash_bwd_dkv", bwd_recs["dkv"],
             "cxxnet_tpu/ops/flash_attn.py:363",
             {**{p: c[2] for p, c in train.items()}, **bench[4],
              "vit_s16_bf16_train": vit_launches[2],
              **dist_by("flash_bwd_dkv")},
             {**per_step, **vit_per}),
            ("ring_fwd_step", ring_recs["fwd"],
             "cxxnet_tpu/ops/ring_flash.py:191",
             {**{p: c[0] for p, c in ring_paths.items()},
              **dist_by("ring_fwd_step")}, ring_per),
            ("ring_dq_step", ring_recs["dq"],
             "cxxnet_tpu/ops/ring_flash.py:224",
             {**{p: c[1] for p, c in ring_paths.items()},
              **dist_by("ring_dq_step")}, ring_per),
            ("ring_dkv_step", ring_recs["dkv"],
             "cxxnet_tpu/ops/ring_flash.py:248",
             {**{p: c[2] for p, c in ring_paths.items()},
              **dist_by("ring_dkv_step")}, ring_per)):
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
        bf16 = {"lrn_fwd": gnet_fwd_rec["bf16"],
                "lrn_bwd": gnet_bwd_rec["bf16"]}.get(name, rec.get("bf16"))
        if bf16 is not None:
            kernels[-1]["bf16"] = dict(
                {k: bf16[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "max_abs_err")},
                at=("GoogLeNet's two LRN inputs at batch 128, summed"
                    if name.startswith("lrn") else
                    "the bench.py LM's bf16 step (b 8, h 8, L 2048, d 64)"))
        if name == "lrn_fwd":
            kernels[-1]["inference"] = {
                "ms": rec["no_norm_ms"], "bound_ms": rec["no_norm_bound_ms"],
                "bound_by": rec["no_norm_bound_by"],
                "covers": "the forward storing no norm (predict's path)"}
        if name.startswith("flash_bwd"):
            kernels[-1]["plain_and_library_cover"] = \
                "the whole backward: dq, dk and dv in one call"
        if name in vit["rows"]:
            kernels[-1]["vit_s16"] = vit["rows"][name]
        for phase, recs in wide.items():
            if name in recs:
                kernels[-1]["head_dim_" + phase[len("lm_hd"):]] = {
                    k: recs[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms",
                                               "max_abs_err")}
        if name == "uniform":
            kernels[-1]["uniform_rows"] = dict(
                {k: rows_rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "max_abs_err", "device_ms",
                                          "library_device_ms")},
                entry="cxxnet_uniform_rows", launches=sess_rows + fe_rows,
                at="a sampling step's draw, (%d, %d)" % UNIFORM_ROWS[0][1:],
                covers="the per-row entry point; launches on "
                       "lm_serve_session and lm_serve_frontend only")
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
