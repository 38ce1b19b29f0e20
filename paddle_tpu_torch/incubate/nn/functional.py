"""Fused transformer functionals (port of
``paddle_tpu/incubate/nn/functional/__init__.py``).

Plain tensor functions with the reference package's semantics: the
normalisation accumulates in f32 and casts back to the input dtype, and
the rotation of rotary embeddings runs in f32 and casts back, so bf16
activations stay bf16. None of these is a kernel of the reference
package (there each is an elementwise chain the compiler fuses), so
here each is plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...framework import dispatch as _dispatch

__all__ = ["swiglu", "fused_rms_norm", "fused_rotary_position_embedding"]


@_dispatch.op("swiglu")
def swiglu(x, y=None):
    """``silu(x) * y``; with ``y=None``, ``x`` is split in half on the
    last axis."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


@_dispatch.op("rms_norm")
def rms_norm(x, weight=None, epsilon=1e-6, bias=None, dim=-1):
    """RMSNorm with f32 accumulation: ``x * rsqrt(mean(x^2) + eps)``
    cast back to ``x.dtype``, then the optional weight and bias."""
    xf = x.float()
    ms = xf.square().mean(dim=dim, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@_dispatch.op("fused_rms_norm")
def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None):
    """``rms_norm(x + bias + residual)``; returns ``out``, or ``(out,
    residual_out)`` when ``residual`` is given (``residual_out`` is the
    pre-norm sum, cast to ``x.dtype``)."""
    h = x
    if bias is not None:
        h = h + bias
    if residual is not None:
        h = h + residual
    axis = begin_norm_axis
    dim = -1 if axis in (-1, h.ndim - 1) else tuple(range(axis, h.ndim))
    out = rms_norm(h, norm_weight, epsilon, norm_bias, dim)
    if residual is not None:
        return out, h.to(x.dtype)
    return out


def _default_sin_cos(seq_len, head_dim, base, device):
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                  # [S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)           # [S, D]
    return emb.sin(), emb.cos()


def _rotate_half(x):
    a, b = torch.chunk(x, 2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _apply_rope(x, sin_e, cos_e, neox):
    """``x`` [B, S, H, D]; ``sin_e``/``cos_e`` f32, broadcastable
    against it. The rotation runs in f32 and casts back to
    ``x.dtype``."""
    xf = x.float()
    if neox:
        out = xf * cos_e + _rotate_half(xf) * sin_e
    else:
        # GPT-J interleaved pairs (x0,x1),(x2,x3),...
        half = sin_e.shape[-1] // 2
        s_, c_ = sin_e[..., :half], cos_e[..., :half]
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c_ - x2 * s_, x2 * c_ + x1 * s_],
                          dim=-1).reshape(x.shape)
    return out.to(x.dtype)


@_dispatch.op("fused_rotary_position_embedding")
def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """Rotary position embedding on batch-major ``[B, S, H, D]`` q/k;
    ``v`` passes through untouched. Returns ``(q, k, v)`` with None for
    the inputs not given.

    ``sin``/``cos`` are tables with one row per position (any shape
    that flattens to ``[S, D]``); with ``position_ids`` [B, S] the rows
    are gathered per batch, and without tables the angles come straight
    from the positions. Without either, positions are ``0..S-1``."""
    if time_major:
        raise NotImplementedError(
            "fused_rotary_position_embedding: time_major=True is not "
            "supported; pass batch-major [B, S, H, D] inputs")
    neox = bool(use_neox_rotary_style)
    base = float(rotary_emb_base)
    seq_len, head_dim = q.shape[1], q.shape[3]
    dev = q.device
    if position_ids is not None and (sin is None or cos is None):
        inv = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                           dtype=torch.float32,
                                           device=dev) / head_dim))
        ang = position_ids.float()[..., None] * inv        # [B, S, D/2]
        emb = torch.cat([ang, ang], dim=-1)                 # [B, S, D]
        sin_e, cos_e = emb.sin()[:, :, None], emb.cos()[:, :, None]
    elif position_ids is not None:
        sin_t = sin.reshape(-1, sin.shape[-1])
        cos_t = cos.reshape(-1, cos.shape[-1])
        sin_e = sin_t[position_ids].float()[:, :, None]     # [B, S, 1, D]
        cos_e = cos_t[position_ids].float()[:, :, None]
    else:
        if sin is None or cos is None:
            sin, cos = _default_sin_cos(seq_len, head_dim, base, dev)
        sin_t = sin.reshape(-1, sin.shape[-1])
        cos_t = cos.reshape(-1, cos.shape[-1])
        sin_e = sin_t[:seq_len].float()[None, :, None]
        cos_e = cos_t[:seq_len].float()[None, :, None]
    q_out = _apply_rope(q, sin_e, cos_e, neox)
    k_out = _apply_rope(k, sin_e, cos_e, neox) if k is not None else None
    return q_out, k_out, v
