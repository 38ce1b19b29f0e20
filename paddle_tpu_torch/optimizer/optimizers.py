"""Adam and AdamW (port of the reference package's
``optimizer/optimizers.py``), with the reference's recurrence op for op:
f32 beta-power accumulators, ``lr_t = lr sqrt(1 - beta2^t) / (1 -
beta1^t)``, epsilon scaled by ``sqrt(1 - beta2^t)``, and AdamW's
decoupled decay ``p * (1 - lr coeff)`` applied before the Adam step.
Each operation is rounded where the reference rounds it; the port
updates parameters and moments in place, which keeps at most three
parameter-sized temporaries alive.
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    """Bias-corrected through beta-power accumulators (the reference's
    phi adam kernel recurrence)."""

    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            if self._amsgrad:
                self._add_accumulator("moment2_max", p)
            self._add_accumulator("beta1_pow_acc", p, dtype=torch.float32,
                                  fill_value=1.0, shape=())
            self._add_accumulator("beta2_pow_acc", p, dtype=torch.float32,
                                  fill_value=1.0, shape=())

    def _adam_moments(self, p, g):
        b1, b2 = self._beta1, self._beta2
        m = self._get_accumulator("moment1", p)
        v = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p).mul_(b1)
        b2p = self._get_accumulator("beta2_pow_acc", p).mul_(b2)
        g = g.to(m.dtype)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_((g * (1 - b2)).mul_(g))
        if self._amsgrad:
            v_max = self._get_accumulator("moment2_max", p)
            torch.maximum(v_max, v, out=v_max)
            v = v_max
        return m, v, b1p, b2p

    def _single_update(self, p, g, lr):
        m, v, b1p, b2p = self._adam_moments(p, g)
        lr32 = torch.tensor(lr, dtype=torch.float32, device=p.device)
        lr_t = lr32 * torch.sqrt(1 - b2p) / (1 - b1p)
        # epsilon scales with sqrt(1 - beta2^t), as in the reference:
        # m / (sqrt(v) + eps sqrt(1 - beta2_pow))
        upd = torch.sqrt(v).add_(self._epsilon * torch.sqrt(1 - b2p))
        torch.div(m, upd, out=upd)
        p.sub_(upd.mul_(lr_t.to(p.dtype)).to(p.dtype))


class AdamW(Adam):
    """Decoupled weight decay: ``p * (1 - lr coeff)`` on the parameter
    itself, then the Adam step. ``lr_ratio(p)`` scales the learning rate
    per parameter; ``apply_decay_param_fun(name)`` returning False skips
    the decay of that parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 amsgrad=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, amsgrad=amsgrad, name=name)
        self._coeff = float(getattr(weight_decay, "coeff", weight_decay))
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_regularization(self, p, g):
        return g  # decay is decoupled

    def _single_update(self, p, g, lr):
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        decay = self._apply_decay_param_fun is None or \
            self._apply_decay_param_fun(self._names[id(p)])
        if decay and self._coeff != 0.0:
            lr32 = torch.tensor(lr, dtype=torch.float32, device=p.device)
            p.mul_((1.0 - lr32 * self._coeff).to(p.dtype))
        super()._single_update(p, g, lr)
