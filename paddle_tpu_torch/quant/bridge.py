"""Bridge from the QAT/PTQ module's deployed form to serving weights
(port of the reference package's ``quant/bridge.py``).

:mod:`paddle_tpu_torch.quantization`'s ``convert`` emits
``ConvertedLinear``: int8 weights ``[in, out]`` and ONE per-tensor
absmax scale, dequantized as ``w = q * (scale / 127)``. The serving
format (:mod:`.format`) is the per-block generalisation of exactly that,
so a QAT'd model deploys without requantization: the int8 values are
reused verbatim and ``scale / 127`` fills every slot of the per-block
sidecar. The bridged layer's dequantized weight is bitwise the
source's.

PTQ models that calibrated an activation scale carry semantics the
weight-only serving path drops (inputs snapped to the int8 grid):
``strict=True`` (the default) refuses them, ``strict=False`` bridges
weight-only and discards the activation scale.
"""

from __future__ import annotations

import torch

from ..quantization import ConvertedLinear
from .format import effective_block
from .layers import WeightOnlyLinear

__all__ = ["bridge_linear", "bridge_model"]


def bridge_linear(converted, block=None, strict=True):
    """One ``ConvertedLinear`` -> :class:`WeightOnlyLinear`, lossless
    (the same int8 values, the scale replicated into the sidecar)."""
    if not isinstance(converted, ConvertedLinear):
        raise TypeError(
            f"expected quantization.ConvertedLinear, got "
            f"{type(converted).__name__}")
    if converted.act_scale is not None and strict:
        raise ValueError(
            "ConvertedLinear carries a calibrated act_scale; the "
            "weight-only serving path drops activation snapping — "
            "pass strict=False to bridge weight-only anyway")
    q = converted.weight_int8
    k, n = q.shape
    b = effective_block(k, block)
    # ConvertedLinear dequantizes w = q * (scale / 127): that value in
    # every [kb, n] slot reproduces the same products
    per_block = float(converted.weight_scale) / 127.0
    scales = torch.full((-(-k // b), n), per_block, dtype=torch.float32,
                        device=q.device)
    return WeightOnlyLinear(q, scales, bias=converted.bias, block=b)


def bridge_model(model, block=None, strict=True):
    """Swap every ``ConvertedLinear`` under ``model`` (in place) for its
    bridged serving form; returns the number swapped."""
    count = 0

    def walk(module):
        nonlocal count
        for name, sub in list(module._modules.items()):
            if isinstance(sub, ConvertedLinear):
                module._modules[name] = bridge_linear(sub, block=block,
                                                      strict=strict)
                count += 1
            elif sub is not None:
                walk(sub)

    walk(model)
    return count
