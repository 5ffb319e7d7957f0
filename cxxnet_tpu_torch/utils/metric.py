"""Evaluation metrics: error / rmse / logloss / rec@n, and MetricSet.

The port's counterpart of cxxnet_tpu/utils/metric.py (the reference's
src/utils/metric.h):
* error   — argmax mismatch; 1-wide predictions threshold at 0
* rmse    — mean over rows of the per-row sum of squared differences (no
  square root, as the reference)
* logloss — -log of the target class's probability, clipped to
  [1e-15, 1-1e-15]; non-finite rows are left out of sum and count
* rec@n   — fraction of the row's label set found in the top-n scores

MetricSet binds each metric to a label field (``metric[field] = name``)
and prints ``\\t{evname}-{metric}[{field}]:{value}`` per metric, the same
string as the JAX package's.

Two paths, as in the JAX package: ``add_eval`` on numpy (the eval loop,
which fetches predictions anyway) and ``device_stats`` on torch tensors,
which reduces a batch to (sum, count) pairs that stay on the device; the
trainer accumulates them and the host reads them once, at ``absorb``.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np
import torch

from . import health


class IMetric:
    name = "none"

    def clear(self) -> None:
        self.sum_metric = 0.0
        self.cnt_inst = 0

    def add_eval(self, pred: np.ndarray, labels: np.ndarray) -> None:
        """pred: (n, k) scores; labels: (n, label_width) label field."""
        raise NotImplementedError

    def device_stats(self, pred: torch.Tensor, labels: torch.Tensor):
        """(sum_metric, cnt_inst) of one batch as f32 tensors on pred's
        device; the same numerics as add_eval."""
        raise NotImplementedError

    def get(self) -> float:
        return self.sum_metric / max(self.cnt_inst, 1)


def _count(pred: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(pred.shape[0]), dtype=torch.float32,
                      device=pred.device)


class MetricError(IMetric):
    name = "error"

    def __init__(self):
        self.clear()

    def add_eval(self, pred, labels):
        pred = np.asarray(pred)
        if pred.shape[1] != 1:
            maxidx = np.argmax(pred, axis=1)
        else:
            maxidx = (pred[:, 0] > 0.0).astype(np.int64)
        self.sum_metric += float(np.sum(maxidx != labels[:, 0].astype(np.int64)))
        self.cnt_inst += pred.shape[0]

    def device_stats(self, pred, labels):
        if pred.shape[1] != 1:
            maxidx = torch.argmax(pred, dim=1)
        else:
            maxidx = (pred[:, 0] > 0.0).long()
        wrong = (maxidx != labels[:, 0].long()).sum()
        return wrong.float(), _count(pred)


class MetricRMSE(IMetric):
    name = "rmse"

    def __init__(self):
        self.clear()

    def add_eval(self, pred, labels):
        pred = np.asarray(pred)
        if pred.shape != labels.shape:
            raise ValueError("rmse: pred and label shape mismatch")
        diff = np.sum((pred - labels) ** 2, axis=1)
        self.sum_metric += float(np.sum(diff))
        self.cnt_inst += pred.shape[0]

    def device_stats(self, pred, labels):
        if pred.shape != labels.shape:
            raise ValueError("rmse: pred and label shape mismatch")
        return (pred - labels).square().sum().float(), _count(pred)


class MetricLogloss(IMetric):
    name = "logloss"

    def __init__(self):
        self.clear()

    def add_eval(self, pred, labels):
        pred = np.asarray(pred)
        n = pred.shape[0]
        if pred.shape[1] != 1:
            tgt = labels[:, 0].astype(np.int64)
            p = np.clip(pred[np.arange(n), tgt], 1e-15, 1.0 - 1e-15)
            res = -np.log(p)
        else:
            p = np.clip(pred[:, 0], 1e-15, 1.0 - 1e-15)
            y = labels[:, 0]
            res = -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))
        bad = ~np.isfinite(res)
        if bad.any():
            # non-finite rows (NaN predictions or labels) are left out of
            # sum and count and surface as a health event (warned once,
            # counted in health/nonfinite_metric), as the device path does
            health.note_nonfinite("logloss", int(bad.sum()))
            res = res[~bad]
        self.sum_metric += float(np.sum(res))
        self.cnt_inst += int(res.shape[0])

    def device_stats(self, pred, labels):
        n = pred.shape[0]
        if pred.shape[1] != 1:
            tgt = labels[:, 0].long()
            p = pred[torch.arange(n, device=pred.device), tgt] \
                .clamp(1e-15, 1.0 - 1e-15)
            s = -p.log().sum()
        else:
            p = pred[:, 0].clamp(1e-15, 1.0 - 1e-15)
            y = labels[:, 0]
            s = -(y * p.log() + (1.0 - y) * (1.0 - p).log()).sum()
        return s.float(), _count(pred)


class MetricRecall(IMetric):
    def __init__(self, name: str):
        m = re.match(r"rec@(\d+)$", name)
        if not m:
            raise ValueError("must specify n for rec@n")
        self.topn = int(m.group(1))
        self.name = name
        self.clear()

    def _check_width(self, k: int) -> None:
        if k < self.topn:
            raise ValueError(
                "rec@%d meaningless for prediction list of length %d"
                % (self.topn, k))

    def add_eval(self, pred, labels):
        pred = np.asarray(pred)
        n, k = pred.shape
        self._check_width(k)
        top = np.argpartition(-pred, self.topn - 1, axis=1)[:, : self.topn]
        for i in range(n):
            lab = labels[i].astype(np.int64)
            hit = np.isin(lab, top[i]).sum()
            self.sum_metric += float(hit) / lab.shape[0]
        self.cnt_inst += n

    def device_stats(self, pred, labels):
        self._check_width(pred.shape[1])
        # tied scores rank by ascending index, as jax.lax.top_k ranks them
        # (a row of equal scores, e.g. behind dead ReLUs, is common early)
        top = torch.sort(pred, dim=1, descending=True,
                         stable=True).indices[:, :self.topn]      # (n, topn)
        lab = labels.long()                                       # (n, lw)
        hit = (lab[:, :, None] == top[:, None, :]).any(-1)        # (n, lw)
        return hit.float().mean(dim=1).sum(), _count(pred)


def create_metric(name: str) -> Optional[IMetric]:
    if name == "rmse":
        return MetricRMSE()
    if name == "error":
        return MetricError()
    if name == "logloss":
        return MetricLogloss()
    if name.startswith("rec@"):
        return MetricRecall(name)
    return None


class MetricSet:
    """A set of evaluators, each bound to a label field name."""

    def __init__(self):
        self.evals: List[IMetric] = []
        self.label_fields: List[str] = []

    def add_metric(self, name: str, field: str = "label") -> None:
        m = create_metric(name)
        if m is None:
            raise ValueError("Metric: unknown metric name: %s" % name)
        self.evals.append(m)
        self.label_fields.append(field)

    def clear(self) -> None:
        for e in self.evals:
            e.clear()

    def _check_count(self, predscores) -> None:
        if len(predscores) != len(self.evals):
            raise ValueError("number of predict scores must equal number "
                             "of metrics")

    def add_eval(self, predscores: List[np.ndarray], label_info) -> None:
        """predscores: one prediction array per metric; label_info:
        LabelInfo of numpy fields."""
        self._check_count(predscores)
        for i, e in enumerate(self.evals):
            e.add_eval(predscores[i], label_info.field(self.label_fields[i]))

    def device_stats(self, predscores, label_info) -> torch.Tensor:
        """(n_metrics, 2) f32 tensor of (sum_metric, cnt_inst) per metric,
        on the predictions' device."""
        self._check_count(predscores)
        rows = [torch.stack(e.device_stats(
            predscores[i], label_info.field(self.label_fields[i])))
            for i, e in enumerate(self.evals)]
        return torch.stack(rows)

    def absorb(self, stats) -> None:
        """Fold a fetched (n_metrics, 2) stats array (the on-device
        accumulator) into the host counters. A non-finite sum is kept, so
        the printed value shows it, and routed through the health event
        the host path emits (``health.note_nonfinite``)."""
        stats = np.asarray(stats)
        for i, e in enumerate(self.evals):
            s = float(stats[i, 0])
            if not np.isfinite(s):
                health.note_nonfinite("train-metric:%s" % e.name)
            e.sum_metric += s
            e.cnt_inst += int(round(float(stats[i, 1])))

    def print_str(self, evname: str) -> str:
        out = []
        for i, e in enumerate(self.evals):
            s = "\t%s-%s" % (evname, e.name)
            if self.label_fields[i] != "label":
                s += "[%s]" % self.label_fields[i]
            s += ":%g" % e.get()
            out.append(s)
        return "".join(out)

    def __len__(self):
        return len(self.evals)
