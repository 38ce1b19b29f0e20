"""``WeightOnlyLinear``, the serving form of ``nn.Linear`` (port of
``paddle_tpu/quant/layers.py``).

The weight lives as int8 + per-block f32 scales in buffers (they ride
``state_dict``), in the reference layout ``[in, out]``, and the forward
dequantizes on use through :func:`~.kernels.dequant_matmul`. A bias,
where the source layer had one, stays a float parameter.
"""

from __future__ import annotations

import torch
from torch import nn

from .format import effective_block, quantize_weight
from .kernels import dequant_matmul

__all__ = ["WeightOnlyLinear", "keep_f32"]


def keep_f32(module, fn, recurse, names):
    """``nn.Module._apply`` for a module whose buffers ``names`` are f32
    scales: they follow the module's device moves but never its dtype
    casts (``model.to(torch.bfloat16)`` would change the dequant
    products). The device is the one ``fn`` gives a probe tensor."""
    kept = {n: module._buffers[n] for n in names}
    order = list(module._buffers)
    for n in names:
        del module._buffers[n]
    try:
        nn.Module._apply(module, fn, recurse)
    finally:
        probe = fn(torch.empty(0, dtype=torch.int8,
                               device=next(iter(kept.values())).device))
        moved = {n: t.to(probe.device) for n, t in kept.items()}
        rest = dict(module._buffers)
        module._buffers.clear()
        for n in order:
            module._buffers[n] = moved[n] if n in moved else rest[n]
    return module


class WeightOnlyLinear(nn.Module):
    """Drop-in dequant-on-use linear: ``y = x @ (q * scales) (+ b)``.

    Built from pre-quantized data (``weight_int8 [in, out]`` int8,
    ``weight_scale [ceil(in/B), out]`` f32) or by :meth:`from_linear`.
    The block size is part of the layer."""

    def __init__(self, weight_int8, weight_scale, bias=None, block=None):
        super().__init__()
        q, s = torch.as_tensor(weight_int8), torch.as_tensor(weight_scale)
        if q.dim() != 2 or s.dim() != 2:
            raise ValueError(f"expected 2-D weight + scales, got "
                             f"{tuple(q.shape)} / {tuple(s.shape)}")
        self.in_features, self.out_features = int(q.shape[0]), \
            int(q.shape[1])
        self.weight_block = effective_block(self.in_features, block)
        kb = -(-self.in_features // self.weight_block)
        if tuple(s.shape) != (kb, self.out_features):
            raise ValueError(
                f"scales {tuple(s.shape)} do not match ceil("
                f"{self.in_features}/{self.weight_block}) x "
                f"{self.out_features}")
        self.register_buffer("weight_int8", q.to(torch.int8).contiguous())
        self.register_buffer("weight_scale", s.to(
            device=q.device, dtype=torch.float32).contiguous())
        if bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = bias if isinstance(bias, nn.Parameter) \
                else nn.Parameter(torch.as_tensor(bias))

    @classmethod
    def from_linear(cls, linear, block=None):
        """Quantize a float ``nn.Linear`` (its ``[out, in]`` weight
        transposed to the format's ``[in, out]``); the float weight is
        dropped, the bias carried over as it is."""
        w = linear.weight.detach().t()
        b = effective_block(w.shape[0], block)
        q, s = quantize_weight(w, b)
        return cls(q, s, bias=linear.bias, block=b)

    def forward(self, x):
        y = dequant_matmul(x, self.weight_int8, self.weight_scale,
                           self.weight_block)
        if self.bias is not None:
            y = y + self.bias
        return y

    def _apply(self, fn, recurse=True):
        return keep_f32(self, fn, recurse, ("weight_scale",))

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"block={self.weight_block}, "
                f"bias={self.bias is not None}")
