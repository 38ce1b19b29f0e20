"""``paddle.metric``: streaming evaluation metrics (port of the
reference package's ``metric``): the ``Metric`` base with
``compute`` / ``update`` / ``reset`` / ``accumulate``, ``Accuracy``,
``Precision``, ``Recall``, ``Auc``, and the batch functions ``accuracy``
and ``auc``.

The metrics accumulate on the host in numpy, outside the compiled step,
fed by its outputs. They take torch tensors, on the card or not, and
numpy arrays: a tensor is read to the host once, bfloat16 widened to f32
(numpy has no bfloat16; the values are exact). ``Auc`` scales a tensor's
scores into bins in the tensor's own dtype first, as the reference's
bfloat16 arrays are scaled, so both bin the same. ``accuracy`` and
``auc`` are torch ops that return 0-d f32 tensors on the input's device.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "auc"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    """Base metric (reference metrics.py Metric)."""

    def __init__(self, name=None):
        self._name = name or self.__class__.__name__.lower()

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    def name(self):
        return self._name

    def compute(self, *args):
        """Optional pre-processing of (pred, label) before ``update``;
        default passthrough (reference: Metric.compute)."""
        return args


class Accuracy(Metric):
    """Top-k accuracy (reference metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        super().__init__(name or "acc")
        self.reset()

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        maxk = max(self.topk)
        order = np.argsort(-pred, axis=-1)[..., :maxk]
        if label.ndim == pred.ndim:
            if label.shape[-1] == 1:       # paddle's [B, 1] index labels
                label = label[..., 0]
            else:                          # one-hot / soft labels
                label = label.argmax(-1)
        correct = (order == label[..., None]).astype(np.float32)
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        flat = correct.reshape(-1, correct.shape[-1])
        res = []
        for k in self.topk:
            hit = flat[:, :k].sum(-1).clip(max=1.0)
            self.total[self.topk.index(k)] += float(hit.sum())
            self.count[self.topk.index(k)] += hit.shape[0]
            res.append(float(hit.mean()))
        return res[0] if len(res) == 1 else res

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision (reference metrics.py Precision)."""

    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def update(self, preds, labels):
        preds = (_np(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = _np(labels).reshape(-1).astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    """Binary recall (reference metrics.py Recall)."""

    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def update(self, preds, labels):
        preds = (_np(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = _np(labels).reshape(-1).astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    """Binned ROC-AUC (reference metrics.py Auc, trapezoid over
    ``num_thresholds`` bins)."""

    def __init__(self, num_thresholds=4095, name=None):
        self.num_thresholds = num_thresholds
        super().__init__(name or "auc")
        self.reset()

    def update(self, preds, labels):
        if not isinstance(preds, torch.Tensor):
            preds = _np(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        # scaled in the scores' own dtype (a 16-bit tensor's product
        # rounds to 16 bits, as the reference's arrays do)
        scaled = _np(preds.reshape(-1) * self.num_thresholds)
        labels = _np(labels).reshape(-1).astype(np.int64)
        idx = np.clip(scaled.astype(np.int64), 0, self.num_thresholds)
        np.add.at(self._stat_pos, idx, labels == 1)
        np.add.at(self._stat_neg, idx, labels == 0)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.float64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.float64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # sweep thresholds high->low, trapezoid on the ROC curve
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(np.trapezoid(tpr, fpr))


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy of a prediction batch (the reference's op
    ``accuracy``): ``input [N, C]`` scores, ``label [N, 1]`` or ``[N]``;
    returns a 0-d f32 fraction (ties keep the lower index first, a
    stable sort as the reference's)."""
    with torch.no_grad():
        topk = torch.argsort(-input, dim=1, stable=True)[:, :int(k)]
        hit = (topk == label.reshape(-1, 1)).any(dim=1)
        return hit.to(torch.float32).mean()


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Batch AUC (the reference's op ``auc``): the positive-class scores
    histogrammed into ``num_thresholds`` bins for positives and
    negatives, then a trapezoid over the implied curve, ROC (TPR against
    FPR) or PR (precision against recall). Returns a 0-d f32 tensor."""
    if curve not in ("ROC", "PR"):
        raise ValueError(f"curve must be 'ROC' or 'PR', got {curve!r}")
    nbins = int(num_thresholds)
    with torch.no_grad():
        score = input[:, 1] if input.ndim == 2 else input.reshape(-1)
        y = label.reshape(-1).to(torch.float32)
        bins = torch.clamp((score * nbins).to(torch.int32), 0,
                           nbins - 1).long()
        pos = torch.zeros(nbins, device=input.device).index_add_(0, bins, y)
        neg = torch.zeros(nbins, device=input.device).index_add_(
            0, bins, 1.0 - y)
        # sweep thresholds high -> low: cumulative TP/FP
        tp = torch.cumsum(pos.flip(0), 0)
        fp = torch.cumsum(neg.flip(0), 0)
        tot_p = torch.clamp_min(tp[-1], 1e-12)
        tot_n = torch.clamp_min(fp[-1], 1e-12)
        recall = tp / tot_p
        if curve == "PR":
            precision = tp / torch.clamp_min(tp + fp, 1e-12)
            rec = torch.cat([recall.new_zeros(1), recall])
            prec = torch.cat([recall.new_ones(1), precision])
            return torch.trapezoid(prec, rec)
        tpr = torch.cat([recall.new_zeros(1), recall])
        fpr = torch.cat([recall.new_zeros(1), fp / tot_n])
        return torch.trapezoid(tpr, fpr)
