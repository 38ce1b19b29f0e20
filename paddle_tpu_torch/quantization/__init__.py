"""QAT / PTQ (port of the reference package's ``quantization``).

- ``quant_dequant``: fake quantization onto the int8 grid with a
  straight-through gradient (an ``autograd.Function``: the gradient of
  the rounding is taken as 1, none flows to the scale);
- observers (``AbsmaxObserver``, ``PerChannelAbsmaxObserver``) and the
  quanter ``FakeQuanterWithAbsMax``;
- ``QuantConfig``, ``QuantedLinear`` (fake-quantized weights and
  activations, the QAT form) and ``ConvertedLinear`` (int8 weights and
  one f32 per-tensor scale, dequantized on use: the deployed form);
- ``QAT`` and ``PTQ``: wrap every matched linear layer, then ``convert``;
- the weight-only ops ``weight_quantize`` / ``weight_dequantize`` /
  ``weight_only_linear`` / ``llm_int8_linear``.

The reference's config matches its own ``nn.Linear``, whose weight is
``[in, out]``; the port's matches ``torch.nn.Linear`` (weight ``[out,
in]``; the port has no Paddle-style ``nn.Linear`` yet, ROADMAP item
14d). ``QuantedLinear`` keeps the torch layout; ``convert`` transposes
once, so ``ConvertedLinear.weight_int8`` is ``[in, out]``, the
reference's buffer and the serving format's ``[K, N]`` (what
:mod:`paddle_tpu_torch.quant.bridge` reuses verbatim). The weight-only
ops take a 2-D weight tensor as the reference's do, ``[in, out]``.

The products here are plain ``torch.matmul``, as the reference's are
plain matmuls outside any kernel.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..framework import dispatch as _dispatch

__all__ = ["BaseObserver", "AbsmaxObserver", "PerChannelAbsmaxObserver",
           "FakeQuanterWithAbsMax", "QuantConfig", "QAT", "PTQ",
           "QuantedLinear", "ConvertedLinear", "quant_dequant",
           "weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear"]


# ---------------------------------------------------------------------------
# fake quant with a straight-through estimator
# ---------------------------------------------------------------------------
class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bits):
        qmax = float(2 ** (bits - 1) - 1)
        s = torch.clamp_min(scale, 1e-9)
        return torch.clamp(torch.round(x / s * qmax), -qmax, qmax) * s / qmax

    @staticmethod
    def backward(ctx, g):
        return g, None, None        # straight-through: d(fq)/dx ~= 1


def _fake_quant(x, scale, bits=8):
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return _FakeQuant.apply(x, scale, int(bits))


@_dispatch.op("quant_dequant")
def quant_dequant(x, scale, bits=8):
    """Fake quantization onto the ``bits``-bit grid of ``scale`` (STE
    gradient)."""
    return _fake_quant(x, scale, bits)


# ---------------------------------------------------------------------------
# observers (reference observers/abs_max.py)
# ---------------------------------------------------------------------------
def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class BaseObserver:
    def __init__(self, quant_bits=8):
        self.quant_bits = quant_bits
        self._scale = None

    def observe(self, x):
        raise NotImplementedError

    def scale(self):
        if self._scale is None:
            raise RuntimeError("observer has seen no data")
        return self._scale


class AbsmaxObserver(BaseObserver):
    """Running per-tensor absmax (read to the host per call)."""

    def observe(self, x):
        arr = _host(x)
        m = float(np.abs(arr).max()) if arr.size else 0.0
        self._scale = m if self._scale is None else max(self._scale, m)
        return self._scale


class PerChannelAbsmaxObserver(BaseObserver):
    """Per-output-channel absmax (channel axis the last by default)."""

    def __init__(self, quant_bits=8, channel_axis=-1):
        super().__init__(quant_bits)
        self.channel_axis = channel_axis

    def observe(self, x):
        arr = _host(x)
        axes = tuple(i for i in range(arr.ndim)
                     if i != (self.channel_axis % arr.ndim))
        m = np.abs(arr).max(axis=axes)
        self._scale = m if self._scale is None \
            else np.maximum(self._scale, m)
        return self._scale


class FakeQuanterWithAbsMax:
    """Quanter factory used by QuantConfig (reference
    quanters/abs_max.py): the absmax of each call's tensor is its
    scale."""

    def __init__(self, quant_bits=8):
        self.quant_bits = quant_bits

    @_dispatch.op("fake_quant_absmax")
    def __call__(self, x):
        return _fake_quant(x, x.detach().abs().max(), self.quant_bits)


# ---------------------------------------------------------------------------
# config + quantized layers
# ---------------------------------------------------------------------------
class QuantConfig:
    """Reference quantization/config.py. ``activation`` / ``weight`` are
    quanter factories applied to every matched layer
    (``torch.nn.Linear`` and its subclasses)."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation or FakeQuanterWithAbsMax(8)
        self.weight = weight or FakeQuanterWithAbsMax(8)
        self._types = (nn.Linear,)
        self._per_type = {}   # layer type -> (activation, weight)

    def add_type_config(self, layer_types, activation=None, weight=None):
        if not isinstance(layer_types, (list, tuple)):
            layer_types = [layer_types]
        for t in layer_types:
            if not (isinstance(t, type) and issubclass(t, nn.Linear)):
                raise NotImplementedError(
                    f"quantization of {getattr(t, '__name__', t)} is not "
                    "supported yet (only Linear-family layers); the "
                    "QuantedLinear wrapper computes F.linear")
            self._per_type[t] = (activation, weight)
        self._types = tuple(set(self._types) | set(layer_types))

    def quanters_for(self, layer):
        for t, (a, w) in self._per_type.items():
            if isinstance(layer, t):
                return (a or self.activation, w or self.weight)
        return (self.activation, self.weight)


class QuantedLinear(nn.Module):
    """Linear with fake-quantized weights and activations (QAT form);
    the weight stays ``torch.nn.Linear``'s ``[out, in]``."""

    def __init__(self, linear, config):
        super().__init__()
        self.weight = linear.weight
        self.bias = linear.bias
        self._act_q, self._w_q = config.quanters_for(linear)

    def forward(self, x):
        return F.linear(self._act_q(x), self._w_q(self.weight), self.bias)


class ConvertedLinear(nn.Module):
    """Deployed int8 form: ``weight_int8 [in, out]`` and one f32
    ``weight_scale``, dequantized on use as ``q * (scale / 127)``. With
    a calibrated ``act_scale`` (PTQ) the inputs are snapped to the int8
    grid too, as the deployed runtime computes them."""

    def __init__(self, weight_i8, scale, bias, act_scale=None):
        super().__init__()
        q = torch.as_tensor(weight_i8)
        self.register_buffer("weight_int8", q.to(torch.int8))
        self.register_buffer("weight_scale", torch.as_tensor(
            scale, dtype=torch.float32, device=q.device))
        self.bias = bias
        self.act_scale = None if act_scale is None else torch.tensor(
            np.float32(act_scale), device=q.device)

    @_dispatch.op("int8_linear")
    def forward(self, x):
        if self.act_scale is not None:
            x = _fake_quant(x, self.act_scale, 8)
        w = self.weight_int8.float() * (self.weight_scale / 127.0)
        y = torch.matmul(x, w)
        return y + self.bias if self.bias is not None else y


def _replace_sublayers(model, predicate, build):
    for name, sub in list(model._modules.items()):
        if sub is None:
            continue
        if predicate(sub):
            model._modules[name] = build(sub)
        else:
            _replace_sublayers(sub, predicate, build)
    return model


def _maybe_copy(model, inplace):
    return model if inplace else copy.deepcopy(model)


class QAT:
    """Quantization-aware training: wrap the linear layers, then convert
    (reference qat.py)."""

    def __init__(self, config: QuantConfig):
        self.config = config

    def quantize(self, model, inplace=False):
        cfg = self.config
        return _replace_sublayers(
            _maybe_copy(model, inplace),
            lambda m: isinstance(m, cfg._types),
            lambda m: QuantedLinear(m, cfg))

    def convert(self, model, inplace=False):
        return _convert(_maybe_copy(model, inplace))


class PTQ:
    """Post-training quantization: calibrate observers (forward pre-hooks
    on every matched layer), then convert: ``convert`` bakes each
    observed layer's activation scale into its deployed form."""

    def __init__(self, config: QuantConfig = None):
        self.config = config or QuantConfig()
        self._observers = {}

    def quantize(self, model, inplace=False):
        model = _maybe_copy(model, inplace)
        for name, sub in model.named_modules():
            if name and isinstance(sub, self.config._types):
                obs = AbsmaxObserver()
                self._observers[name] = obs

                def hook(mod, inputs, o=obs):
                    o.observe(inputs[0])
                    return None   # observe only, never replace inputs

                sub.register_forward_pre_hook(hook)
        return model

    def convert(self, model, inplace=False):
        model = _maybe_copy(model, inplace)
        scales = {}
        for name, obs in self._observers.items():
            try:
                scales[name] = float(obs.scale())
            except RuntimeError:
                pass  # never calibrated: weight-only for this layer
        return _convert(model, act_scales=scales)


@torch.no_grad()
def _convert(model, act_scales=None):
    act_scales = act_scales or {}
    names = {id(sub): name for name, sub in model.named_modules() if name}

    def build(m):
        w = m.weight.detach().t()                       # [in, out]
        scale = w.abs().max()
        if not bool(scale):
            scale = torch.ones_like(scale)
        wi8 = torch.clamp(torch.round(w / scale * 127.0), -127, 127) \
            .to(torch.int8).contiguous()
        return ConvertedLinear(wi8, scale, m.bias,
                               act_scale=act_scales.get(names.get(id(m))))

    return _replace_sublayers(
        model, lambda m: isinstance(m, (nn.Linear, QuantedLinear)), build)


# ---------------------------------------------------------------------------
# weight-only quant ops (reference ops weight_quantize, weight_dequantize,
# weight_only_linear, llm_int8_linear)
# ---------------------------------------------------------------------------
@_dispatch.op("weight_quantize")
@torch.no_grad()
def weight_quantize(x, algo="weight_only_int8"):
    """Per-out-channel absmax int8 quantization of an ``[in, out]``
    weight. Returns ``(int8 weight, f32 scale [out])``."""
    if algo not in ("weight_only_int8", "llm.int8"):
        raise ValueError(f"unsupported algo {algo!r}")
    scale = x.abs().amax(dim=0) / 127.0
    q = torch.clamp(torch.round(x / torch.clamp_min(scale, 1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale.float()


@_dispatch.op("weight_dequantize")
def weight_dequantize(x, scale, algo="weight_only_int8"):
    return x.float() * scale[None, :]


@_dispatch.op("weight_only_linear")
def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8"):
    """``y = x @ dequant(W) (+ b)`` with ``W [in, out]`` int8 and a
    per-column scale."""
    w = weight.to(x.dtype)
    y = torch.matmul(x, w)
    if weight_scale is not None:
        y = y * weight_scale[None, :].to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


@_dispatch.op("llm_int8_linear")
def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0):
    """LLM.int8() linear: with the weight dequantized to f32 the outlier
    split (int8 for calm columns, float for outliers) is one product."""
    w = weight.float()
    if weight_scale is not None:
        w = w * weight_scale[None, :]
    y = torch.matmul(x.float(), w).to(x.dtype)
    if bias is not None:
        y = y + bias
    return y
