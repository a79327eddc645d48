"""Metrics (port of paddle_tpu's `metric/__init__.py`: Metric, Accuracy,
Precision, Recall, Auc, accuracy).

`compute` (Accuracy's top-k hits, the functional `accuracy`) runs on
tensors where they are, on the device. `update` and `accumulate` run on
host numpy, as the JAX package's do, so the totals are the same numbers
in both packages; a tensor handed to `update` is copied to the host
(a device sync), which is why `hapi.Model` updates metrics only where the
JAX package does (evaluate, and fit without a strategy).
"""
from __future__ import annotations

import sys as _sys

import numpy as np
import torch

from ..core.arrays import to_numpy

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


def _topk_hits(pred, label, k):
    """[..., k] float32 hits of the k best predictions against `label`
    (class ids, a trailing size-1 axis, or one-hot), on pred's device."""
    pred = _tensor(pred)
    label = _tensor(label).to(pred.device)
    order = torch.argsort(-pred, dim=-1, stable=True)[..., :k]
    if label.dim() == pred.dim():         # one-hot or column label
        label = label.squeeze(-1) if label.shape[-1] == 1 \
            else torch.argmax(label, dim=-1)
    return (order == label[..., None].to(order.dtype)).to(torch.float32)


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        return _topk_hits(pred, label, self.maxk)

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        for k in self.topk:
            num = correct[..., :k].sum()
            tot = int(np.prod(correct.shape[:-1]))
            self.total[self.topk.index(k)] += num
            self.count[self.topk.index(k)] += tot
            accs.append(num / max(tot, 1))
        return np.array(accs[0] if len(accs) == 1 else accs)

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Thresholded-histogram AUC (reference: metrics.py Auc / auc_op)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        idx = np.minimum((pos_prob * self._num_thresholds).astype(np.int64),
                         self._num_thresholds - 1)
        pos = labels.astype(bool)
        np.add.at(self._stat_pos, idx[pos], 1)
        np.add.at(self._stat_neg, idx[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds, np.int64)
        self._stat_neg = np.zeros(self._num_thresholds, np.int64)

    def accumulate(self):
        tot_pos = float(self._stat_pos.sum())
        tot_neg = float(self._stat_neg.sum())
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # integrate TPR over FPR from the high-score end
        pos_cum = np.cumsum(self._stat_pos[::-1])
        neg_cum = np.cumsum(self._stat_neg[::-1])
        tpr = pos_cum / tot_pos
        fpr = neg_cum / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy, a 0-d float32 tensor on input's device
    (reference: metric/metrics.py accuracy)."""
    return _topk_hits(input, label, k).amax(dim=-1).mean()


metrics = _sys.modules[__name__]   # reference alias: paddle.metric.metrics
