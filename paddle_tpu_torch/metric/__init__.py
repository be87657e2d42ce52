"""Metrics (counterpart of paddle_tpu/metric/__init__.py; ref:
python/paddle/metric/metrics.py).

``Accuracy.compute`` and ``accuracy`` take their top k with
``torch.topk`` on the predictions' device (the reference sorts on the
host with numpy, and ``accuracy`` with ``lax.top_k``), so a training
step on the card copies only the [..., k] hits back for ``update``. The
other metrics count on the host, as the reference's do."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _torch(x) -> torch.Tensor:
    if isinstance(x, Tensor):
        return x._data
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _numpy(x) -> np.ndarray:
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x.detach()).numpy()
    return np.asarray(x)


class Metric:
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


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label):
        """[..., maxk] bools on the predictions' device: whether each of
        the top maxk classes (best first) is the label. The top 1 is an
        argmax (a plain reduction, the first of equal maxima); topk
        only for maxk > 1."""
        pred, label = _torch(pred), _torch(label)
        label = label.to(pred.device)
        if label.dim() == pred.dim():
            label = label.squeeze(-1)
        if self.maxk == 1:
            top = pred.argmax(-1, keepdim=True)
        else:
            top = torch.topk(pred, self.maxk, dim=-1).indices
        return Tensor._wrap(top == label[..., None])

    def update(self, correct):
        correct = _numpy(correct)
        accs = []
        for i, k in enumerate(self.topk):
            c = correct[..., :k].any(axis=-1)
            self.total[i] += float(c.sum())
            self.count[i] += int(c.size)
            accs.append(self.total[i] / max(self.count[i], 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = _numpy(preds) > 0.5
        labels = _numpy(labels).astype(bool)
        self.tp += int((preds & labels).sum())
        self.fp += int((preds & ~labels).sum())

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = _numpy(preds) > 0.5
        labels = _numpy(labels).astype(bool)
        self.tp += int((preds & labels).sum())
        self.fn += int((~preds & labels).sum())

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _numpy(preds)
        labels = _numpy(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bins = (pos_prob * self.num_thresholds).astype(int)
        pos = labels.astype(bool)
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2.0
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """The share of rows whose top `k` classes hold the label, as an f32
    scalar Tensor on the input's device."""
    pred, lab = _torch(input), _torch(label)
    lab = lab.to(pred.device)
    if lab.dim() == pred.dim():
        lab = lab.squeeze(-1)
    top = torch.topk(pred, k, dim=-1).indices
    correct = (top == lab[..., None]).any(dim=-1)
    return Tensor._wrap(correct.float().mean())
