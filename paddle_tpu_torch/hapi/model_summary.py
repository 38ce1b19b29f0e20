"""``paddle.summary`` / ``paddle.flops`` (port of the reference package's
``hapi/model_summary.py``).

Both run one forward pass with forward hooks on every leaf module,
collecting output shapes and parameter counts (summary) and applying
per-layer-type FLOP rules (flops): conv, linear, the norms (the port's
``RMSNorm`` among them) and pooling; every other leaf counts 0 but
still prints. The hooks are removed afterwards and the network's
training flag restored. The probe input is zeros of ``input_size`` on
the network's device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["summary", "flops"]


def _num_params(layer):
    return sum(int(np.prod(p.shape)) for p in layer.parameters(recurse=False))


def _device(net):
    for t in list(net.parameters()) + list(net.buffers()):
        return t.device
    return torch.device("cpu")


def _dtype(dtype):
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _run_with_hooks(net, input_size, dtype, per_layer):
    """Forward zeros of ``input_size`` through ``net`` with a forward hook
    on each leaf module calling ``per_layer(layer, name, inputs,
    outputs)``."""
    if isinstance(input_size, (list, tuple)) and input_size \
            and isinstance(input_size[0], (list, tuple)):
        shapes = list(input_size)
    else:
        shapes = [tuple(input_size)]
    dev = _device(net)
    xs = [torch.zeros(tuple(s), dtype=_dtype(dtype), device=dev)
          for s in shapes]
    handles = []
    try:
        for name, sub in net.named_modules():
            if sub is net or list(sub.children()):
                continue  # hook leaves only

            def hook(layer, inputs, outputs, _name=name):
                per_layer(layer, _name, inputs, outputs)

            handles.append(sub.register_forward_hook(hook))
        was_training = net.training
        net.eval()
        try:
            with torch.no_grad():
                net(*xs)
        finally:
            if was_training:
                net.train()
    finally:
        for h in handles:
            h.remove()


def summary(net, input_size, dtypes=None, input=None):
    """Print a per-layer table (type, output shape, params); returns
    ``{'total_params': ..., 'trainable_params': ...}``."""
    rows = []

    def per_layer(layer, name, inputs, outputs):
        out = outputs[0] if isinstance(outputs, (list, tuple)) \
            else outputs
        shape = list(out.shape) if hasattr(out, "shape") else "-"
        rows.append((f"{type(layer).__name__}-{len(rows) + 1}",
                     str(shape), _num_params(layer)))

    if input is not None:
        raise NotImplementedError(
            "summary(input=...) is not supported; pass input_size")
    _run_with_hooks(net, input_size, dtypes, per_layer)

    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if p.requires_grad)
    w1 = max([len(r[0]) for r in rows] + [12])
    w2 = max([len(r[1]) for r in rows] + [14])
    sep = "-" * (w1 + w2 + 14)
    print(sep)
    print(f"{'Layer (type)':<{w1}}  {'Output Shape':<{w2}}  {'Params':>10}")
    print("=" * (w1 + w2 + 14))
    for r in rows:
        print(f"{r[0]:<{w1}}  {r[1]:<{w2}}  {r[2]:>10,}")
    print(sep)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print(sep)
    return {"total_params": total, "trainable_params": trainable}


def _conv_flops(layer, inputs, out):
    # MACs = out_elems * (Cin/groups) * prod(kernel); FLOPs = 2 * MACs
    k = int(np.prod(layer.kernel_size))
    cin = layer.weight.shape[1]  # already Cin/groups in the weight
    out_elems = int(np.prod(out.shape))
    return 2 * out_elems * int(cin) * k


def _linear_flops(layer, inputs, out):
    out_f, in_f = layer.weight.shape        # torch's [out, in]
    batch = int(np.prod(out.shape)) // int(out_f)
    return 2 * batch * int(in_f) * int(out_f)


def _norm_flops(layer, inputs, out):
    return 2 * int(np.prod(out.shape))


def _pool_flops(layer, inputs, out):
    return int(np.prod(out.shape))


def _flop_rules():
    from ..models.llama import RMSNorm
    norms = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d, nn.LayerNorm,
             nn.GroupNorm, RMSNorm) + ((nn.RMSNorm,) if hasattr(
                 nn, "RMSNorm") else ())
    return [((nn.Conv1d, nn.Conv2d, nn.Conv3d), _conv_flops),
            ((nn.Linear,), _linear_flops),
            (norms, _norm_flops),
            ((nn.MaxPool2d, nn.AvgPool2d, nn.AdaptiveAvgPool2d),
             _pool_flops)]


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Total forward FLOPs for one batch of ``input_size``. ``custom_ops``
    maps a module TYPE to ``fn(layer, inputs, output) -> flops``."""
    total = [0]
    detail = []
    rules = _flop_rules()

    def per_layer(layer, name, inputs, outputs):
        out = outputs[0] if isinstance(outputs, (list, tuple)) \
            else outputs
        fn = custom_ops.get(type(layer)) if custom_ops else None
        if fn is None:
            for types, rule in rules:
                if isinstance(layer, types):
                    fn = rule
                    break
        n = int(fn(layer, inputs, out)) if fn else 0
        total[0] += n
        detail.append((name, type(layer).__name__, n))

    _run_with_hooks(net, input_size, None, per_layer)
    if print_detail:
        for name, t, n in detail:
            print(f"{name:<40} {t:<20} {n:>14,}")
        print(f"{'Total':<61} {total[0]:>14,}")
    return total[0]
