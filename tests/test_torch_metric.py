"""The port's ``metric`` against the reference package's, on the same
seeded numpy predictions and labels.

Tolerances: exact for the streaming metrics (``Accuracy``, ``Precision``,
``Recall``, ``Auc``: host numpy on equal inputs; torch inputs, f32 or
bf16, give the numpy inputs' values) and for ``accuracy``; 1e-6 absolute
for the batch ``auc`` (f32 trapezoid sums, added in another order).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as rm

from paddle_tpu_torch import metric as tm

torch.set_num_threads(1)


def _preds(seed, n=64, c=10):
    rng = np.random.RandomState(seed)
    pred = rng.rand(n, c).astype(np.float32)
    pred[::7, 3] = pred[::7, 4]          # ties within a row
    return pred, rng.randint(0, c, (n, 1)).astype(np.int64)


@pytest.mark.parametrize("label_form", ["index", "flat", "onehot"])
def test_accuracy_streams_as_the_reference(label_form):
    r, t = rm.Accuracy(topk=(1, 5)), tm.Accuracy(topk=(1, 5))
    assert t.name() == r.name() == ["acc_top1", "acc_top5"]
    for seed in range(3):
        pred, lab = _preds(seed)
        if label_form == "flat":
            lab = lab[:, 0]
        elif label_form == "onehot":
            lab = np.eye(10, dtype=np.float32)[lab[:, 0]]
        want = r.update(r.compute(paddle.to_tensor(pred),
                                  paddle.to_tensor(lab)))
        got = t.update(t.compute(torch.from_numpy(pred),
                                 torch.from_numpy(lab)))
        assert got == want
        assert t.accumulate() == r.accumulate()
        assert t.count == r.count and t.total == r.total
    t.reset()
    assert t.accumulate() == [0.0, 0.0]
    one = tm.Accuracy()
    assert one.name() == "acc"
    pred, lab = _preds(9)
    one.update(one.compute(pred, lab))
    r1 = rm.Accuracy()
    r1.update(r1.compute(pred, lab))
    assert one.accumulate() == r1.accumulate()


def test_precision_recall_auc_match_reference():
    rng = np.random.RandomState(4)
    for cls in ("Precision", "Recall", "Auc"):
        r, t = getattr(rm, cls)(), getattr(tm, cls)()
        for _ in range(3):
            score = rng.rand(50).astype(np.float32)
            lab = (rng.rand(50) < score).astype(np.int64)
            if cls == "Auc":
                score = np.stack([1 - score, score], axis=1)
            r.update(paddle.to_tensor(score), paddle.to_tensor(lab))
            t.update(torch.from_numpy(score), torch.from_numpy(lab))
            assert t.accumulate() == r.accumulate(), cls
        assert t.name() == r.name()
    empty = tm.Auc()
    assert empty.accumulate() == 0.0 == tm.Precision().accumulate()


def test_auc_bins_a_bf16_tensor_as_the_reference_bins_bf16():
    """A 16-bit tensor's scores are scaled into bins in its own dtype, as
    the reference scales its bfloat16 arrays."""
    rng = np.random.RandomState(5)
    score = rng.rand(200).astype(np.float32)
    lab = (rng.rand(200) < score).astype(np.int64)
    r, t = rm.Auc(num_thresholds=255), tm.Auc(num_thresholds=255)
    r.update(paddle.to_tensor(score).astype("bfloat16"),
             paddle.to_tensor(lab))
    t.update(torch.from_numpy(score).to(torch.bfloat16),
             torch.from_numpy(lab))
    np.testing.assert_array_equal(t._stat_pos, r._stat_pos)
    np.testing.assert_array_equal(t._stat_neg, r._stat_neg)
    assert t.accumulate() == r.accumulate()


def test_batch_accuracy_and_auc_ops():
    pred, lab = _preds(6)
    for k in (1, 3):
        want = float(rm.accuracy(paddle.to_tensor(pred),
                                 paddle.to_tensor(lab), k=k))
        got = tm.accuracy(torch.from_numpy(pred), torch.from_numpy(lab), k=k)
        assert got.dtype == torch.float32 and got.item() == want
    rng = np.random.RandomState(7)
    score = rng.rand(80).astype(np.float32)
    lab = (rng.rand(80) < score).astype(np.int64)
    two = np.stack([1 - score, score], axis=1)
    for curve in ("ROC", "PR"):
        for inp in (score, two):
            want = float(rm.auc(paddle.to_tensor(inp), paddle.to_tensor(lab),
                                curve=curve, num_thresholds=200))
            got = tm.auc(torch.from_numpy(inp), torch.from_numpy(lab),
                         curve=curve, num_thresholds=200)
            assert abs(got.item() - want) <= 1e-6, curve
    with pytest.raises(ValueError):
        tm.auc(torch.from_numpy(score), torch.from_numpy(lab), curve="XY")


def test_metric_base_and_inputs():
    class Count(tm.Metric):
        def update(self, *args):
            self.n = getattr(self, "n", 0) + 1

        def reset(self):
            self.n = 0

        def accumulate(self):
            return self.n
    c = Count()
    assert c.name() == "count" and c.compute(1, 2) == (1, 2)
    with pytest.raises(TypeError):
        tm.Metric()
    # numpy and torch inputs give one result; a bf16 tensor the
    # reference's bf16 tensor's
    pred, lab = _preds(8)
    got = []
    for p in (pred, torch.from_numpy(pred)):
        a = tm.Accuracy(topk=(1, 2))
        a.update(a.compute(p, torch.from_numpy(lab)))
        got.append(a.accumulate())
    assert got[0] == got[1]
    a, r = tm.Accuracy(topk=(1, 2)), rm.Accuracy(topk=(1, 2))
    a.update(a.compute(torch.from_numpy(pred).to(torch.bfloat16),
                       torch.from_numpy(lab)))
    r.update(r.compute(paddle.to_tensor(pred).astype("bfloat16"),
                       paddle.to_tensor(lab)))
    assert a.accumulate() == r.accumulate()
