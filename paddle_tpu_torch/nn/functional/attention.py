"""Attention functionals (port of the reference package's
``nn/functional/attention.py``). Layout ``[batch, seq, heads,
head_dim]``.

``scaled_dot_product_attention`` takes the flash path
(:mod:`paddle_tpu_torch.ops.flash_attention`) exactly where its
``supported`` holds, and the plain composition otherwise: the
reference's own dispatch rule for shapes its kernel does not take. The
reference's ``use_pallas_kernels`` flag and kernel autotuning have no
counterpart: the flash path is always taken where it applies.
"""

from __future__ import annotations

import math

import torch

from ... import amp
from ...ops import flash_attention as fa

__all__ = ["scaled_dot_product_attention", "flash_attention"]


def _naive_attention(q, k, v, mask, is_causal, scale=None):
    """``[B, S, H, D]`` attention as plain tensor code: f32 scores and
    softmax, probabilities cast to the inputs' dtype for the product
    with V (GQA: kv heads repeated over their query group)."""
    with torch.autocast(q.device.type, enabled=False):
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if kh.shape[1] != qh.shape[1]:
            group = qh.shape[1] // kh.shape[1]
            kh = kh.repeat_interleave(group, dim=1)
            vh = vh.repeat_interleave(group, dim=1)
        s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * s
        ninf = torch.full_like(scores, float("-inf"))
        if is_causal:
            ql, kl = scores.shape[-2], scores.shape[-1]
            causal = torch.ones(ql, kl, dtype=torch.bool,
                                device=q.device).tril(kl - ql)
            scores = torch.where(causal, scores, ninf)
        if mask is not None:
            if mask.dtype == torch.bool:
                scores = torch.where(mask, scores, ninf)
            else:
                scores = scores + mask.float()
        probs = torch.softmax(scores, dim=-1).to(qh.dtype)
        return torch.matmul(probs, vh).transpose(1, 2)


def _no_dropout(dropout_p, training):
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP queue A, item 9: "
            "flash dropout)")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention on ``[B, S, H, D]`` q and ``[B, S, Hk, D]`` k/v: the
    flash kernels where :func:`ops.flash_attention.supported` holds,
    the plain composition otherwise."""
    _no_dropout(dropout_p, training)
    if fa.supported(query, key, value, attn_mask, is_causal):
        q, k, v = amp.cast_inputs("flash_attention", query, key, value)
        return fa.flash_attention(q, k, v, causal=is_causal)
    q, k, v = amp.cast_inputs("scaled_dot_product_attention", query, key,
                              value)
    return _naive_attention(q, k, v, attn_mask, is_causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """The reference's ``flash_attention`` signature: returns ``(out,
    None)`` (no softmax is ever materialised)."""
    out = scaled_dot_product_attention(query, key, value, attn_mask=None,
                                       dropout_p=dropout, is_causal=causal,
                                       training=training)
    return out, None
