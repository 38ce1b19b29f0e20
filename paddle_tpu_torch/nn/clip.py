"""Gradient clipping (port of the reference package's ``nn/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm`` and
the torch-style ``clip_grad_norm_`` / ``clip_grad_value_``.

A strategy maps ``[(param, grad)]`` to clipped gradients, which the
optimizer uses for its update; ``p.grad`` itself is left as it was, as in
the reference. A parameter whose ``need_clip`` attribute is False keeps
its gradient. Nothing here reads a value on the host: norms and scales
stay 0-d f32 device tensors, so a CUDA-graph train step
(:mod:`paddle_tpu_torch.jit`) captures the clip with the rest of the
step. The global norm sums the squared norms with a Python ``sum`` over
the parameters in list order, the reference's order of additions.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _scaled(g, scale):
    """``g`` times the f32 ``scale``, computed in f32 and rounded back to
    ``g``'s dtype."""
    return (g.float() * scale).to(g.dtype)


def _const(value, like):
    """A 0-d f32 tensor holding ``value`` on ``like``'s device (a fill
    kernel, no host-to-device copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def _clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            norm = torch.linalg.vector_norm(g.float())
            scale = torch.minimum(
                _const(self.clip_norm, norm).div_(
                    torch.clamp_min(norm, 1e-12)), _const(1.0, norm))
            out.append((p, _scaled(g, scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @torch.no_grad()
    def _clip(self, params_grads):
        sq = [torch.sum(torch.square(g.float()))
              for p, g in params_grads if _clipped(p, g)]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(sum(sq))
        scale = _const(self.clip_norm, global_norm).div_(
            torch.clamp_min(global_norm, self.clip_norm))
        return [(p, _scaled(g, scale) if _clipped(p, g) else g)
                for p, g in params_grads]


def _param_list(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place so that their joint ``norm_type``
    norm is at most ``max_norm``; returns the norm before clipping (a
    0-d f32 device tensor)."""
    parameters = _param_list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.max(torch.stack(
            [torch.max(torch.abs(g)).float() for g in grads]))
    else:
        total = torch.pow(
            sum(torch.sum(torch.pow(torch.abs(g.float()), norm_type))
                for g in grads), 1.0 / norm_type)
    scale = torch.minimum(
        _const(float(max_norm), total).div_(torch.clamp_min(total, 1e-6)),
        _const(1.0, total))
    for g in grads:
        g.copy_(_scaled(g, scale))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every ``p.grad`` in place to ``[-clip_value, clip_value]``."""
    for p in _param_list(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
