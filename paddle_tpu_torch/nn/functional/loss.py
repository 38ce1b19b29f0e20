"""Loss functionals (port of ``cross_entropy`` from the reference
package's ``nn/functional/loss.py``). Under ``amp.auto_cast`` the loss
is on the black list: its inputs are cast to f32."""

from __future__ import annotations

import torch

from ... import amp

__all__ = ["cross_entropy"]


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Cross entropy of ``input`` (logits, or probabilities when
    ``use_softmax=False``) against hard class ids or soft labels, in
    f32. With hard labels, ``reduction='mean'`` averages over the rows
    whose label is not ``ignore_index`` (or by the summed class
    ``weight`` of those rows), and returns 0 when none is left."""
    (input,) = amp.cast_inputs("cross_entropy", input)
    with torch.autocast(input.device.type, enabled=False):
        axis = int(axis) % input.dim()
        c = input.shape[axis]
        x = input.float()
        if use_softmax:
            logp = torch.log_softmax(x, dim=axis)
        else:
            logp = torch.log(x.clamp(1e-15, 1.0))
        if soft_label:
            soft = label.float()
            if label_smoothing > 0.0:
                soft = (1 - label_smoothing) * soft + label_smoothing / c
            loss = -(soft * logp).sum(dim=axis)
            if weight is not None:
                shape = [1] * logp.dim()
                shape[axis] = -1
                loss = loss * (soft * weight.float().reshape(shape)) \
                    .sum(dim=axis)
            return _reduce(loss, reduction)
        lbl = label
        if lbl.dim() == logp.dim():          # [N, 1] style labels
            lbl = lbl.squeeze(axis)
        lbl = lbl.long()
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, torch.zeros_like(lbl))
        picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0.0:
            nll = -(1 - label_smoothing) * picked \
                - label_smoothing * logp.mean(dim=axis)
        else:
            nll = -picked
        zero = torch.zeros_like(nll)
        nll = torch.where(valid, nll, zero)
        if weight is not None:
            w = torch.where(valid, weight.float()[safe], zero)
            nll = nll * w
            if reduction == "mean":
                return nll.sum() / w.sum().clamp_min(1e-12)
        if reduction == "mean":
            return nll.sum() / valid.float().sum().clamp_min(1.0)
        return _reduce(nll, reduction)
