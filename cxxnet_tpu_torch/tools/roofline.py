"""Analytic FLOPs + MFU accounting for the port's model zoo: the port's
twin of tools/roofline.py.

Counts matmul-class FLOPs per image/token from each net's weight shapes and
node geometry (the counting rule of the scaling literature: 2*MACs
forward; training = 3x forward for the fwd + dgrad + wgrad passes), then
converts a measured images/sec rate into MFU% against the card's bf16 peak.
The nets are built from ``cxxnet_tpu_torch.models`` and the repo's configs
(AlexNet is example/ImageNet/ImageNet.conf's net), as shapes only: no
weights are made and no device is touched.

Usage:
  python -m cxxnet_tpu_torch.tools.roofline              # FLOPs/img table
  python -m cxxnet_tpu_torch.tools.roofline --bench f.json  # + MFU% from
                                          # bench JSON lines
  python -m cxxnet_tpu_torch.tools.roofline --rate googlenet=4700
  python -m cxxnet_tpu_torch.tools.roofline --decode  # decode bound table

The peaks are the port's shared table (``perf.DEVICE_SPECS["h100"]``, the
one the live program ledger reads) with its env overrides
(``CXXNET_PEAK_TFLOPS``, ``CXXNET_PEAK_HBM_GBS``). The elementwise / pool /
norm ops are NOT counted (sub-1% of FLOPs on every zoo model); their cost
shows up as the gap between MFU% and 100%, which is the point of the
metric.
"""

import argparse
import json
import os
import sys

import numpy as np

from .. import models as M
from ..nnet.trainer import Trainer
from ..utils import perf
from ..utils.config import parse_config_file, parse_config_string

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
IMAGENET_CONF = os.path.join(REPO, "example", "ImageNet", "ImageNet.conf")


def peak_flops() -> float:
    return perf.device_spec("h100").peak_flops


def peak_hbm_bytes() -> float:
    return perf.device_spec("h100").hbm_bw


def _param_shapes(tr):
    """Per-connection {key: shape} of the trainer's net (its params when it
    has them, else the layers' declared shapes)."""
    if tr.params is not None:
        return [{k: tuple(v.shape) for k, v in p.items()} for p in tr.params]
    return tr.net.param_shapes()


def net_flops_per_sample(tr) -> float:
    """Forward matmul-class FLOPs for ONE sample of the trainer's net.

    conv:   2 * prod(wmat.shape) * Ho * Wo
    fullc:  2 * prod(wmat.shape)
    attention: 4 * L * W * d_model score+AV FLOPs (W = attn_window or L;
               causal halves it) + 2 * L * prod per projection weight
               (applied per position)
    embed:  0 (gather).  Shared layers count once per APPLICATION.
    """
    net, cfg = tr.net, tr.net.cfg
    shapes = _param_shapes(tr)
    total = 0.0
    for i, lay in enumerate(net.layers):
        info = cfg.layers[i]
        pidx = info.primary_layer_index if net.is_shared[i] else i
        tname = lay.type_name
        if tname == "embed":
            continue
        f = 0.0
        for key, shape in shapes[pidx].items():
            if key in lay.state_keys() or len(shape) < 2:
                continue
            f += 2.0 * float(np.prod(shape))
        if tname == "conv" and info.nindex_out:
            b, c, h, w_ = net.node_shapes[info.nindex_out[0]]
            f *= h * w_
        if tname == "attention":
            b, d, _, L = net.node_shapes[info.nindex_in[0]]
            win = lay.attn_window or L
            span = min(win, L)
            # wqkv/wo projections apply per position, like conv's Ho*Wo
            f *= L
            # scores + AV: 2 ops each over (L x span x d); causal halves
            f += (2.0 if lay.causal else 4.0) * L * span * d
        total += f
    return total


def shape_trainer(cfg: str, dev: str = "cpu") -> Trainer:
    """A trainer of the config text with its net built (shapes inferred)
    and no weights made."""
    tr = Trainer()
    for k, v in parse_config_string(cfg):
        tr.set_param(k, v)
    tr.set_param("dev", dev)
    tr.net_cfg.configure(tr.cfg_pairs)
    tr.net = tr._new_net(tr.net_cfg, tr.batch_size, True)
    return tr


def imagenet_config(batch_size: int = 8) -> str:
    """example/ImageNet/ImageNet.conf without its iterator sections, at
    ``batch_size`` (its net is AlexNet at 227x227)."""
    lines, in_section = [], False
    for k, v in parse_config_file(IMAGENET_CONF):
        if k in ("data", "eval", "pred"):
            in_section = True
            continue
        if in_section:
            in_section = not (k == "iter" and v == "end")
            continue
        if k in ("dev", "batch_size"):
            continue
        lines.append("%s = %s" % (k, v))
    return "\n".join(lines) + "\nbatch_size = %d\n" % batch_size


def _lm(L, extra=""):
    return lambda: shape_trainer(M.transformer_lm_config(
        vocab=8192, seq=L, batch_size=2, dim=512, nhead=8, nlayer=4,
        dev="cpu", extra_cfg="eval_train = 0\n" + extra))


def zoo(models=None):
    """(name, FLOPs per sample or token, unit) for the bench rows. Built
    as shapes on the CPU — FLOPs are shape arithmetic; no card needed."""
    table = [
        ("alexnet", lambda: shape_trainer(imagenet_config(8)), "img"),
        ("googlenet", lambda: shape_trainer(M.googlenet_config(8, 224)),
         "img"),
        ("resnet18", lambda: shape_trainer(M.resnet_config(8, 224)), "img"),
        ("vgg16", lambda: shape_trainer(M.vgg_config(8, 224)), "img"),
        ("mobilenet", lambda: shape_trainer(M.mobilenet_config(8, 224)),
         "img"),
        ("vit_s16", lambda: shape_trainer(M.vit_config(
            n_class=1000, image_hw=224, patch=16, batch_size=8, dim=384,
            nhead=6, nlayer=12, ffn_mult=4)), "img"),
        ("transformer_lm_L2048", _lm(2048), "token"),
        ("transformer_lm_L8192_gqa_window",
         _lm(8192, "nkvhead = 2\nattn_window = 1024\nrope = 1\n"), "token"),
    ]
    out = []
    for name, build, unit in table:
        if models and name not in models:
            continue
        try:
            tr = build()
        except Exception as e:   # model not constructible here: skip, say so
            print("# %s: skipped (%s)" % (name, e), file=sys.stderr)
            continue
        f = net_flops_per_sample(tr)
        if unit == "token":
            f /= tr.net.cfg.param.input_shape[2]   # per-token, not per-seq
        out.append((name, f, unit))
    return out


def decode_bound(tr, batch, prompt_len, gen_to, dtype_bytes=2):
    """Analytic tokens/sec bound for KV-cached greedy decode.

    Decode is HBM-bandwidth-bound, not FLOPs-bound: every step must read
    the full parameter set once (shared by the batch) plus each stream's
    KV cache up to the current position. bytes/step =
      params*dtype + B * sum_layers 2*kv_dim*min(t, window)*dtype,
    averaged over t in [prompt_len, gen_to). Bound = B * BW / avg_bytes.
    Embedding tables are a GATHER at decode — B rows read per step, not
    the whole table — so they are excluded from the params term and
    charged per-row instead. Weight-shared attention applications each
    keep their own cache (decode keys caches by connection), so shared
    layers count per application here, unlike the params term."""
    net = tr.net
    shapes = _param_shapes(tr)
    seen = set()
    param_bytes = 0.0
    embed_row_bytes = 0.0
    for i, lay in enumerate(net.layers):
        pidx = net.cfg.layers[i].primary_layer_index \
            if net.is_shared[i] else i
        if pidx in seen:
            continue
        seen.add(pidx)
        for sh in shapes[pidx].values():
            if lay.type_name == "embed":
                # gather: one (d,)-row per stream per step
                embed_row_bytes += float(sh[-1] if sh else 1) * dtype_bytes
            else:
                param_bytes += float(np.prod(sh)) * dtype_bytes
    ts = np.arange(prompt_len, gen_to, dtype=np.float64)
    kv_read = np.zeros_like(ts)
    for i, lay in enumerate(net.layers):
        if lay.type_name != "attention":
            continue
        b, d, _, L = net.node_shapes[net.cfg.layers[i].nindex_in[0]]
        nkv = lay.nkvhead or lay.nhead
        kv_dim = nkv * (d // lay.nhead)
        win = lay.attn_window or gen_to
        kv_read += 2.0 * kv_dim * np.minimum(ts, win) * dtype_bytes
    avg_step_bytes = param_bytes + batch * (float(kv_read.mean())
                                            + embed_row_bytes)
    return batch * peak_hbm_bytes() / avg_step_bytes, param_bytes


def decode_zoo():
    """(name, build, batch, prompt, gen_to) — the serving configs whose
    measured tokens/sec the bound judges."""
    return [
        ("lm_decode", _lm(2048), 8, 64, 2048),
        ("lm_decode_b1", _lm(2048), 1, 64, 2048),
        ("lm_decode_L8192_gqa_window",
         _lm(8192, "nkvhead = 2\nattn_window = 1024\nrope = 1\n"),
         8, 64, 8192),
    ]


def decode_table(rates):
    bw = peak_hbm_bytes()
    print("| config | params MiB (bf16) | avg bytes/token | bound tok/s "
          "| measured tok/s | % of bound |")
    print("|---|---|---|---|---|---|")
    for name, build, batch, plen, gen_to in decode_zoo():
        try:
            tr = build()
        except Exception as e:
            print("# %s: skipped (%s)" % (name, e), file=sys.stderr)
            continue
        bound, pbytes = decode_bound(tr, batch, plen, gen_to)
        r = rates.get(name)
        meas = ("%.0f" % r) if r else "queued"
        pct = ("%.1f%%" % (100.0 * r / bound)) if r else "—"
        print("| %s (b%d, %d->%d) | %.1f | %.2fM | %.0f | %s | %s |"
              % (name, batch, plen, gen_to, pbytes / 2**20,
                 bw / bound / 1e6, bound, meas, pct))
    print("\n(bytes/token = bytes/step / batch; "
          "bound = B * HBM_BW / (params + B*avg KV read) bytes/step; "
          "HBM %.0f GB/s. MFU-style FLOPs are the wrong decode yardstick "
          "— a batch-8 decode reads ~all params per token.)"
          % (bw / 1e9))


_RATE_KEYS = {
    "lm_decode_tokens_per_sec": "lm_decode",
    "lm_decode_b1_tokens_per_sec": "lm_decode_b1",
    "lm_decode_L8192_tokens_per_sec": "lm_decode_L8192_gqa_window",
    "alexnet_imagenet_b1024": "alexnet",
    "alexnet_imagenet": "alexnet",
    "googlenet_imagenet": "googlenet",
    "resnet18_imagenet": "resnet18",
    "vgg16_imagenet": "vgg16",
    "mobilenet_imagenet": "mobilenet",
    "vit_s16": "vit_s16",
    "transformer_lm_L2048": "transformer_lm_L2048",
    "transformer_lm_L8192_gqa_window": "transformer_lm_L8192_gqa_window",
}


def _iter_bench_rows(raw):
    """Every {metric, ...} row in a bench capture, BOTH shapes: the
    wrapper of the repo's BENCH_r*.json files ({"parsed": ..., "tail":
    "<JSONL>"}) and raw bench JSONL. No dedup — repeated rounds of one
    metric in one log all come through (the caller keeps the best rate
    per model)."""
    try:
        doc = json.loads(raw)
    except ValueError:
        doc = None
    blobs = [raw]
    if isinstance(doc, dict):
        blobs = [doc.get("tail") or ""]
        if "metric" in doc:
            yield doc
        parsed = doc.get("parsed")
        if isinstance(parsed, dict) and "metric" in parsed:
            yield parsed
    elif isinstance(doc, list):
        blobs = []
        for d in doc:
            if isinstance(d, dict) and "metric" in d:
                yield d
    for blob in blobs:
        for line in blob.splitlines():
            line = line.strip()
            if not (line.startswith("{") and '"metric"' in line):
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if isinstance(d, dict) and "metric" in d:
                yield d


def rates_from_bench(paths):
    """Parse {metric, value} bench rows (wrapper files or raw JSONL); keep
    the BEST rate per model across every occurrence. Returns ``(rates,
    n_null)`` — n_null counts the metrics whose every occurrence carried a
    null value (a structured non-result; a metric that also measured
    somewhere is not "skipped"), and main() prints it: the MFU table must
    say how much of the trajectory it is not seeing, not silently render
    em-dashes."""
    rates = {}
    null_metrics = set()
    measured = set()
    for path in paths:
        with open(path) as f:
            raw = f.read()
        for row in _iter_bench_rows(raw):
            name = str(row.get("metric", ""))
            v = row.get("value")
            if v is None:
                null_metrics.add(name)
                continue
            if not v:
                continue
            measured.add(name)
            for prefix, model in _RATE_KEYS.items():
                if name.startswith(prefix):
                    rates[model] = max(rates.get(model, 0.0), float(v))
                    break
    return rates, len(null_metrics - measured)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", action="append", default=[],
                    help="bench JSON-lines file(s) to pull measured rates")
    ap.add_argument("--rate", action="append", default=[],
                    help="model=samples_per_sec override")
    ap.add_argument("--decode", action="store_true",
                    help="print the decode bandwidth-bound table instead")
    ap.add_argument("models", nargs="*")
    args = ap.parse_args(argv)

    rates, n_null = rates_from_bench(args.bench)
    if n_null:
        print("# %d bench row(s) skipped: value null (backend "
              "unreachable) — measured/s and MFU%% columns cover only "
              "the remaining rows" % n_null)
    for spec in args.rate:
        k, v = spec.split("=")
        rates[k] = float(v)

    if args.decode:
        decode_table(rates)
        return

    peak = peak_flops()
    print("| model | fwd GFLOPs/%s | train GFLOPs/%s | measured/s | MFU%% |"
          % ("sample", "sample"))
    print("|---|---|---|---|---|")
    for name, f, unit in zoo(args.models or None):
        train_f = 3.0 * f
        r = rates.get(name)
        mfu = "%.1f%%" % (100.0 * r * train_f / peak) if r else "—"
        rs = ("%.0f" % r) if r else "—"
        print("| %s | %.2f | %.2f | %s | %s |"
              % (name, f / 1e9, train_f / 1e9, rs, mfu))
    if not rates:
        print("\n(no measured rates given: pass --bench f.json or "
              "--rate model=N; MFU = rate * train_flops / %.0fT peak, %s)"
              % (peak / 1e12, perf.device_spec("h100").name))


if __name__ == "__main__":
    main()
