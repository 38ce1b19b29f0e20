"""Attention functionals (port of the reference package's
``nn/functional/attention.py``). Layout ``[batch, seq, heads,
head_dim]``.

``scaled_dot_product_attention`` takes the flash path
(:mod:`paddle_tpu_torch.ops.flash_attention`) exactly where its
``supported`` holds, and the plain composition otherwise: the
reference's own dispatch rule for shapes its kernel does not take. The
reference's ``use_pallas_kernels`` flag and kernel autotuning have no
counterpart: the flash path is always taken where it applies.

Attention dropout (``dropout_p > 0`` while ``training``) takes the plain
composition, as the reference's does: no kernel of either package drops.
The keep mask is the reference's ``bernoulli(key, 1 - p, probs.shape)``:
element ``i`` of the ``[B, H, Sq, Sk]`` probabilities is kept where the
f32 uniform of the threefry bits at counter ``i`` under ``key``
(:mod:`paddle_tpu_torch.ops.sampling`) is below ``float32(1 - p)``, so for
a given key the mask is the reference's bit for bit; kept probabilities
are divided by ``1 - p``. The public entry draws the key's two words from
torch's generator on the inputs' device, where the reference takes the
next key of its own global stream (ROADMAP, stated differences).
"""

from __future__ import annotations

import math

import torch

from ... import amp
from ...framework import dispatch as _dispatch
from ...ops import flash_attention as fa
from ...ops import sampling as _rng

__all__ = ["scaled_dot_product_attention", "flash_attention"]


#: counters a pass of the plain threefry takes: its int64 temporaries stay
#: small at any attention shape
_MASK_CHUNK = 1 << 24


def dropout_keep_mask(key, shape, dropout_p, device):
    """The reference's ``bernoulli(key, 1 - dropout_p, shape)``: a bool
    tensor, True where kept. ``key`` is the threefry key's two 32-bit
    words (ints or 0-d integer tensors on ``device``)."""
    k0, k1 = (torch.as_tensor(w, device=device).long() for w in key)
    p_keep = torch.full((), 1.0 - dropout_p, dtype=torch.float32,
                        device=device)
    n = math.prod(shape)
    keep = torch.empty(n, dtype=torch.bool, device=device)
    for lo in range(0, n, _MASK_CHUNK):
        hi = min(n, lo + _MASK_CHUNK)
        bits = _rng.random_bits(k0, k1, torch.arange(lo, hi, device=device))
        u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0
        keep[lo:hi] = u < p_keep
    return keep.reshape(shape)


def _naive_attention(q, k, v, mask, is_causal, scale=None, dropout_p=0.0,
                     key=None):
    """``[B, S, H, D]`` attention as plain tensor code: f32 scores and
    softmax, probabilities cast to the inputs' dtype for the product
    with V (GQA: kv heads repeated over their query group). With
    ``dropout_p > 0`` and a ``key``, the f32 probabilities are dropped by
    :func:`dropout_keep_mask` first, as the reference's are."""
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
        probs = torch.softmax(scores, dim=-1)
        if dropout_p > 0.0 and key is not None:
            keep = dropout_keep_mask(key, probs.shape, dropout_p, q.device)
            # a device divisor: a host scalar's division may become a
            # product by its reciprocal on the card
            kept = probs / torch.full((), 1.0 - dropout_p,
                                      dtype=torch.float32, device=q.device)
            probs = torch.where(keep, kept, torch.zeros_like(probs))
        probs = probs.to(qh.dtype)
        return torch.matmul(probs, vh).transpose(1, 2)


def dropout_key(device):
    """A fresh dropout key: two 32-bit words drawn on ``device`` from
    torch's generator (graph-safe on the card)."""
    return tuple(torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                               device=device).unbind())


@_dispatch.op("scaled_dot_product_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention on ``[B, S, H, D]`` q and ``[B, S, Hk, D]`` k/v: with
    dropout on (``dropout_p > 0`` and ``training``) the plain composition
    under a fresh key; otherwise the flash kernels where
    :func:`ops.flash_attention.supported` holds, the plain composition
    elsewhere."""
    if dropout_p > 0.0 and training:
        q, k, v = amp.cast_inputs("scaled_dot_product_attention", query,
                                  key, value)
        return _naive_attention(q, k, v, attn_mask, is_causal,
                                dropout_p=dropout_p,
                                key=dropout_key(q.device))
    if fa.supported(query, key, value, attn_mask, is_causal):
        q, k, v = amp.cast_inputs("flash_attention", query, key, value)
        return fa.flash_attention(q, k, v, causal=is_causal)
    q, k, v = amp.cast_inputs("scaled_dot_product_attention", query, key,
                              value)
    return _naive_attention(q, k, v, attn_mask, is_causal)


@_dispatch.op("flash_attention")
def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """The reference's ``flash_attention`` signature: returns ``(out,
    None)`` (no softmax is ever materialised)."""
    out = scaled_dot_product_attention(query, key, value, attn_mask=None,
                                       dropout_p=dropout, is_causal=causal,
                                       training=training)
    return out, None
