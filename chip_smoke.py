"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels from cxxnet_tpu_torch/csrc, holds each kernel
against its plain PyTorch version at the shapes of the main path, then
drives the main paths through ``cxxnet_tpu_torch.api.Net(dev="gpu")`` on
AlexNet (example/ImageNet/ImageNet.conf at full width, 3x227x227 -> 1000,
batch 256, random weights from a seed): inference (``predict`` /
``extract``), then training (``update`` steps with the config's own SGD
settings and dropout on). Exits non-zero, with no result, when there is no
card or any phase fails.

Output, in order: the card's name and power limit (nvidia-smi), the build
time, the phases ``lrn_kernel``, ``alexnet_pred``, ``lrn_bwd_kernel`` and
``alexnet_train`` (kernel checks, the main paths' checks, throughput and
profiles), then a JSON line ``{"kernels": [...]}`` and, last, the JSON
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
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
# kernel sums the window in double, the plain version in f32) are a large
# relative error but a tiny absolute one
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
# The two one-step comparisons below run with cuDNN off (PyTorch's native
# convolutions). cuDNN's fp32 weight gradient of conv2 (5x5, pad 2, two
# groups) is off from float64 by several 1e-3 of its largest element, the
# native one by about 1e-6 (the "conv layer ... vs float64" lines), which
# would swamp what they compare.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip()


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
    bf16; returns the per-kernel record (sums over the two fp32 main-path
    shapes, i.e. one forward's worth of LRN work)."""
    import torch.nn.functional as F
    log("phase lrn_kernel")
    rec = _new_rec()
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
            if dtype == torch.float32:
                _add_fp32(rec, kernel_ms, plain_ms, library_ms, bound_ms,
                          bound_by)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            del x, out, norm, ref_out, ref_norm
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
    lrn.launches = 0
    pred = net.predict(x)
    top = net.extract(x, "top[-1]")
    torch.cuda.synchronize()
    launches = lrn.launches
    log("  lrn_fwd launches: %d over 2 forwards" % launches)
    if launches != 4:
        raise AssertionError("expected 2 LRN kernel launches per forward, "
                             "counted %d over 2" % launches)
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


def compare_params(what, got, want, start, rtol, atol_update, check=True):
    """Hold every parameter tensor to |got - want| <= rtol |want| +
    atol_update * (the tensor's largest |want - start|, its largest
    update); print the worst ratio of error to bound. ``check=False``
    only reports it."""
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
                                verdict if check else "(report only)"))
    if check and worst > 1.0:
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


def conv_vs_f64(net, x, y):
    """Report each conv's output, data gradient and weight gradient as
    cuDNN computes them on the main path (fp32) against the same values in
    float64, on the main path's own conv inputs, weights and output
    gradients of one training forward: the largest error over the largest
    element, and the norm-wise error. The weight gradient is also reported
    with cuDNN in its deterministic mode and with cuDNN off."""
    from torch.nn.grad import conv2d_input, conv2d_weight
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

    def err(got, want):
        e = (got.double() - want).abs()
        return "max_err/max %.3e norm-wise %.3e" % (
            float(e.max() / want.abs().max()), float(e.norm() / want.norm()))
    for i, dout in zip(convs, douts):
        p = t.net.layers[i].param
        inp = values[infos[i].nindex_in[0]].detach()
        w = params[i]["wmat"].detach().reshape(
            p.num_channel, p.num_input_channel // p.num_group,
            p.kernel_height, p.kernel_width)
        kw = dict(stride=p.stride, padding=(p.pad_y, p.pad_x),
                  groups=p.num_group)
        line = []
        for what, fn, args in (
                ("output", torch.nn.functional.conv2d, (inp, w)),
                ("data grad", lambda a, b, **k: conv2d_input(
                    inp.shape, a, b, **k), (w, dout)),
                ("weight grad", lambda a, b, **k: conv2d_weight(
                    a, w.shape, b, **k), (inp, dout))):
            want = fn(*(a.double() for a in args), **kw)
            line.append("%s %s" % (what, err(fn(*args, **kw), want)))
            if what == "weight grad":
                torch.backends.cudnn.deterministic = True
                try:
                    line.append("weight grad (cuDNN deterministic) %s"
                                % err(fn(*args, **kw), want))
                finally:
                    torch.backends.cudnn.deterministic = False
                with cudnn_off():
                    line.append("weight grad (cuDNN off) %s"
                                % err(fn(*args, **kw), want))
            del want
        log("  conv layer %d %s vs float64 (a report): %s"
            % (i, tuple(w.shape), "; ".join(line)))


def phase_alexnet_train(lrn, api):
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

    conv_vs_f64(net, x, y)

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
    # dropout off (threshold 0) on both sides; held with cuDNN off, and
    # reported with cuDNN on (the main path's setting)
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
                   on_cpu, p0, CPU_STEP_RTOL, CPU_STEP_ATOL_UPDATE,
                   check=False)
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
    profile_forward(device_step, unit="step")
    return fwd, bwd


def profile_forward(forward, iters: int = 3, top: int = 8,
                    unit: str = "forward") -> None:
    """Where a forward's (or a training step's) device time goes:
    torch.profiler over ``iters`` synchronised calls; prints kernel time
    per call, the device's busy share of the wall time (the profiler's own
    overhead included), the largest kernels by self device time, and the
    LRN kernels' share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / iters

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else e.self_cuda_time_total

    kernels = [(dev_us(e) / 1e3 / iters, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not kernels:
        log("  profile: no device time recorded (not measured)")
        return
    kernels.sort(reverse=True)
    busy_ms = sum(ms for ms, _ in kernels)
    log("  profile over %d %ss: device kernel time %.3f ms/%s, "
        "wall %.3f ms/%s, device busy share %.3f"
        % (iters, unit, busy_ms, unit, wall_ms, unit, busy_ms / wall_ms))
    for ms, name in kernels[:top]:
        log("    %8.3f ms %5.1f%%  %s" % (ms, 100 * ms / busy_ms, name[:90]))
    for kernel in ("lrn_fwd", "lrn_bwd") if unit == "step" else ("lrn_fwd",):
        lrn_ms = sum(ms for ms, name in kernels if kernel in name)
        log("    %s kernels: %.3f ms/%s, %.1f%% of device time"
            % (kernel, lrn_ms, unit, 100 * lrn_ms / busy_ms))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from cxxnet_tpu_torch import api
    from cxxnet_tpu_torch.ops import _build, lrn

    log(nvidia_smi())
    log("torch %s cuda %s, %s" % (torch.__version__, torch.version.cuda,
                                  torch.cuda.get_device_name(0)))
    t0 = time.time()
    libs = _build.build_kernels()
    log("build: %d kernels in %.2f s" % (len(libs), time.time() - t0))
    for name, path in libs.items():
        with open(path[:-3] + ".log") as f:
            log("  %s: %s" % (name, " | ".join(
                ln.strip() for ln in f if "registers" in ln or "spill" in ln)))

    fwd_rec = phase_lrn_kernel(lrn)
    pred_launches = phase_alexnet_pred(lrn, api)
    bwd_rec = phase_lrn_bwd_kernel(lrn)
    train_fwd, train_bwd = phase_alexnet_train(lrn, api)
    kernels = []
    for name, rec, replaces, by_path in (
            ("lrn_fwd", fwd_rec, "cxxnet_tpu/ops/pallas_kernels.py:78",
             {"alexnet_pred": pred_launches, "alexnet_train": train_fwd}),
            ("lrn_bwd", bwd_rec, "cxxnet_tpu/ops/pallas_kernels.py:98",
             {"alexnet_train": train_bwd})):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "cxxnet_tpu_torch/csrc/%s.cu" % name,
            "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_per_train_step": by_path["alexnet_train"] // TRAIN_STEPS,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
