"""The quantized weight format and model-level quantize APIs (port of
``paddle_tpu/quant/format.py``).

Format (one weight ``w [K, N]``, contraction axis K, the reference
layout ``[in, out]``; a ``torch.nn.Linear`` weight ``[out, in]`` is
transposed first):

- ``q      [K, N]  int8``: the quantized values, same layout as ``w``;
- ``scales [ceil(K/B), N]  f32``: per-(row-block, column) absmax
  scales, ``scales[kb, n] = max(|w[kb*B:(kb+1)*B, n]|) / 127``, so
  ``w[k, n] ~= q[k, n] * scales[k // B, n]``.

B, the block size, is the knob: ``PADDLE_TPU_WEIGHT_BLOCK`` fleet-wide,
or per call. A tile of B weight rows carries exactly one contiguous
scale row, so a kernel streams ``(int8 rows, their scale row)`` pairs
without a gather. Stacked MoE expert weights ``[E, K, N]`` quantize per
expert to ``[E, K, N]`` int8 + ``[E, ceil(K/B), N]`` scales.

``quantize_model`` swaps every ``nn.Linear`` under the model for a
:class:`~paddle_tpu_torch.quant.layers.WeightOnlyLinear` and asks
modules that expose ``quantize_weights(block)`` (the stacked-expert MoE
FFN) to quantize themselves. ``lm_head`` is skipped by default, and
embeddings are lookups that stay float too.
"""

from __future__ import annotations

import os

import torch
from torch import nn

__all__ = ["DEFAULT_BLOCK", "default_block", "effective_block",
           "quantize_weight", "dequant_blocks", "dequantize_weight",
           "quantize_model", "is_quantized", "model_weight_block",
           "serving_weight_bytes"]

#: default rows of K covered by one scale row
DEFAULT_BLOCK = 128


def default_block():
    """Fleet default block size (``PADDLE_TPU_WEIGHT_BLOCK`` wins)."""
    env = os.environ.get("PADDLE_TPU_WEIGHT_BLOCK", "")
    return int(env) if env else DEFAULT_BLOCK


def effective_block(k, block=None):
    """The block size used for a contraction dim of ``k``: the
    requested (or default) block, clamped to ``k``."""
    b = int(block) if block else default_block()
    if b <= 0:
        raise ValueError(f"weight block must be positive, got {b}")
    return min(b, int(k))


@torch.no_grad()
def quantize_weight(w, block=None):
    """``[*, K, N]`` float -> ``([*, K, N] int8, [*, ceil(K/B), N] f32)``,
    bit for bit the reference's: symmetric per-block absmax, each scale
    ``absmax / 127``, values rounded half to even and clipped to
    ``[-127, 127]``; an all-zero block gets scale 0 and dequantizes to
    zeros."""
    arr = torch.as_tensor(w).detach().float()
    if arr.dim() < 2:
        raise ValueError(f"weight must be at least 2-D, got "
                         f"{tuple(arr.shape)}")
    k, n = arr.shape[-2], arr.shape[-1]
    b = effective_block(k, block)
    kb = -(-k // b)
    pad = kb * b - k
    if pad:
        arr = torch.nn.functional.pad(arr, (0, 0, 0, pad))
    blocked = arr.reshape(arr.shape[:-2] + (kb, b, n))
    scales = blocked.abs().amax(dim=-2) / 127.0
    q = torch.clamp(torch.round(
        blocked / torch.clamp(scales, min=1e-12)[..., None, :]), -127, 127)
    q = q.to(torch.int8).reshape(arr.shape[:-2] + (kb * b, n))[..., :k, :]
    return q.contiguous(), scales


def dequant_blocks(q, scales, block):
    """``q.f32 * scales`` broadcast over row blocks of ``block``: the
    format's dequant expression (the plain versions of the int8 kernels
    use it), a ragged last block included."""
    k, n = q.shape[-2], q.shape[-1]
    kb = scales.shape[-2]
    w = q.float()
    if kb * block == k:
        shape = q.shape[:-2] + (kb, block, n)
        return (w.reshape(shape)
                * scales.float()[..., :, None, :]).reshape(q.shape)
    s = scales.float().repeat_interleave(block, dim=-2)[..., :k, :]
    return w * s


def dequantize_weight(q, scales, block=None):
    """Inverse map of the format: ``q * scales`` broadcast over row
    blocks, f32 out. ``block`` must be the value quantization used."""
    q, s = torch.as_tensor(q), torch.as_tensor(scales)
    k = q.shape[-2]
    b = effective_block(k, block)
    if s.shape[-2] != -(-k // b):
        raise ValueError(
            f"scales rows {s.shape[-2]} do not match ceil({k}/{b}); pass "
            "the block size the weight was quantized with")
    return dequant_blocks(q, s, b)


def quantize_model(model, block=None, skip=("lm_head",)):
    """Swap every quantizable module under ``model`` (in place) for its
    weight-only int8 serving form and return the model; raise if
    nothing was quantizable.

    - ``nn.Linear`` -> :class:`WeightOnlyLinear`;
    - modules exposing ``quantize_weights(block)`` (the stacked-expert
      ``LlamaMoEMLP``) quantize themselves in place;
    - child names in ``skip`` (default ``lm_head``) stay float."""
    from .layers import WeightOnlyLinear

    count = 0

    def walk(module):
        nonlocal count
        for name, sub in list(module.named_children()):
            if name in skip:
                continue
            if isinstance(sub, WeightOnlyLinear):
                count += 1
            elif isinstance(sub, nn.Linear):
                setattr(module, name,
                        WeightOnlyLinear.from_linear(sub, block=block))
                count += 1
            elif hasattr(sub, "quantize_weights"):
                if not getattr(sub, "weight_block", None):
                    sub.quantize_weights(block)
                count += 1
            else:
                walk(sub)

    walk(model)
    if count == 0:
        raise ValueError(
            "quantize_model found no quantizable layers (nn.Linear or "
            "quantize_weights-capable) under the model")
    return model


def is_quantized(model):
    """True when any module under ``model`` is in the weight-only
    form."""
    from .layers import WeightOnlyLinear

    return any(isinstance(m, WeightOnlyLinear)
               or getattr(m, "weight_block", None) for m in model.modules())


def model_weight_block(model):
    """The block size of a quantized model (first quantized module
    found), or None when the model is float."""
    from .layers import WeightOnlyLinear

    for m in model.modules():
        if isinstance(m, WeightOnlyLinear):
            return m.weight_block
        b = getattr(m, "weight_block", None)
        if b:
            return int(b)
    return None


def serving_weight_bytes(model):
    """``(actual_bytes, bf16_baseline_bytes, weight_elems)`` over the
    model's state (parameters and buffers): ``actual_bytes`` as stored
    (int8 weights, f32 scales, float leftovers), the baseline what the
    same weights would take in bf16 (the ``*_scale`` sidecars excluded:
    a float model has none)."""
    actual = baseline = elems = 0
    for name, t in model.state_dict().items():
        actual += t.numel() * t.element_size()
        if name.rsplit(".", 1)[-1].endswith("_scale"):
            continue
        elems += t.numel()
        baseline += 2 * t.numel()
    return actual, baseline, elems
