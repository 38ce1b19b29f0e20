"""The optimizers (port of the reference package's
``optimizer/optimizers.py``): ``SGD``, ``Momentum``, ``Adagrad``,
``Adam``, ``AdamW``, ``Adamax``, ``RMSProp``, ``Adadelta`` and ``Lamb``,
each with the reference's recurrence op for op: the same accumulators
(so the same ``state_dict`` keys), f32 beta-power accumulators, and each
operation rounded where the reference rounds it. Adam's ``lr_t = lr
sqrt(1 - beta2^t) / (1 - beta1^t)`` scales its epsilon by ``sqrt(1 -
beta2^t)``; AdamW applies its decoupled decay ``p * (1 - lr coeff)``
before the Adam step. The port updates parameters and accumulators in
place, which keeps a few parameter-sized temporaries alive at most.
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adagrad", "Adam", "AdamW", "Adamax",
           "RMSProp", "Adadelta", "Lamb"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _single_update(self, p, g, lr, value):
        value.sub_(lr.to(value.dtype) * g.to(value.dtype))


class Momentum(Optimizer):
    """The velocity form ``v = mu v + g``, Nesterov optional."""

    _accum_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _single_update(self, p, g, lr, value):
        v = self._get_accumulator("velocity", p)
        g = g.to(v.dtype)
        mu = self._const(self._momentum, v.dtype, v.device)
        v.mul_(mu).add_(g)
        lr = lr.to(value.dtype)
        if self._use_nesterov:
            value.sub_(lr * (g + mu * v).to(value.dtype))
        else:
            value.sub_(lr * v.to(value.dtype))


class Adagrad(Optimizer):
    _accum_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._initial_accumulator_value = initial_accumulator_value

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment", p,
                                  fill_value=self._initial_accumulator_value)

    def _single_update(self, p, g, lr, value):
        m = self._get_accumulator("moment", p)
        g = g.to(m.dtype)
        m.add_(g * g)
        upd = g / (torch.sqrt(m) + self._epsilon)
        value.sub_(lr.to(value.dtype) * upd.to(value.dtype))


class Adam(Optimizer):
    """Bias-corrected through beta-power accumulators (the reference's
    phi adam kernel recurrence)."""

    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
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

    def _single_update(self, p, g, lr, value):
        m, v, b1p, b2p = self._adam_moments(p, g)
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        # epsilon scales with sqrt(1 - beta2^t), as in the reference:
        # m / (sqrt(v) + eps sqrt(1 - beta2_pow))
        upd = torch.sqrt(v).add_(self._epsilon * torch.sqrt(1 - b2p))
        torch.div(m, upd, out=upd)
        value.sub_(upd.to(value.dtype).mul_(lr_t.to(value.dtype)))


class AdamW(Adam):
    """Decoupled weight decay: ``p * (1 - lr coeff)`` on the parameter
    itself, then the Adam step. ``lr_ratio(p)`` scales the learning rate
    per parameter; ``apply_decay_param_fun(name)`` returning False skips
    the decay of that parameter; a group's ``weight_decay`` replaces the
    coefficient for its parameters."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._coeff = float(getattr(weight_decay, "coeff", weight_decay))
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_regularization(self, p, g):
        return g  # decay is decoupled

    def _single_update(self, p, g, lr, value):
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        decay = self._apply_decay_param_fun is None or \
            self._apply_decay_param_fun(self._names[id(p)])
        coeff = self._coeff
        if self._group_weight_decay is not None:
            gw = self._group_weight_decay
            coeff = float(getattr(gw, "coeff", gw))
        if decay and coeff != 0.0:
            value.mul_((1.0 - lr * coeff).to(value.dtype))
        super()._single_update(p, g, lr, value)


class Adamax(Optimizer):
    _accum_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, dtype=torch.float32,
                                  fill_value=1.0, shape=())

    def _single_update(self, p, g, lr, value):
        m = self._get_accumulator("moment", p)
        u = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow_acc", p).mul_(self._beta1)
        g = g.to(m.dtype)
        m.mul_(self._beta1).add_(g * (1 - self._beta1))
        torch.maximum(u.mul_(self._beta2), g.abs().add_(self._epsilon),
                      out=u)
        lr_t = lr / (1 - b1p)
        value.sub_((lr_t * (m / u)).to(value.dtype))


class RMSProp(Optimizer):
    _accum_names = ("mean_square", "mean_grad", "momentum_acc")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _single_update(self, p, g, lr, value):
        rho = self._rho
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("momentum_acc", p)
        g = g.to(ms.dtype)
        ms.mul_(rho).add_((g * (1 - rho)).mul_(g))
        denom = ms
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            mg.mul_(rho).add_(g * (1 - rho))
            denom = ms - mg * mg
        lr = lr.to(ms.dtype)
        mom.mul_(self._momentum).add_(
            (lr * g).div_(torch.sqrt(denom + self._epsilon)))
        value.sub_(mom.to(value.dtype))


class Adadelta(Optimizer):
    _accum_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._rho = rho

    def _single_update(self, p, g, lr, value):
        rho, eps = self._rho, self._epsilon
        ag = self._get_accumulator("avg_squared_grad", p)
        au = self._get_accumulator("avg_squared_update", p)
        g = g.to(ag.dtype)
        ag.mul_(rho).add_((g * (1 - rho)).mul_(g))
        upd = (torch.sqrt(au + eps) / torch.sqrt(ag + eps)).mul_(g)
        au.mul_(rho).add_((upd * (1 - rho)).mul_(upd))
        value.sub_(lr.to(value.dtype) * upd.to(value.dtype))


class Lamb(Optimizer):
    """Layer-wise adaptive moments: the Adam direction plus decay, scaled
    by the trust ratio ``||w|| / ||r||``."""

    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lamb_weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, dtype=torch.float32,
                                  fill_value=1.0, shape=())
            self._add_accumulator("beta2_pow_acc", p, dtype=torch.float32,
                                  fill_value=1.0, shape=())

    def _single_update(self, p, g, lr, value):
        b1, b2 = self._beta1, self._beta2
        m = self._get_accumulator("moment1", p)
        v = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p).mul_(b1)
        b2p = self._get_accumulator("beta2_pow_acc", p).mul_(b2)
        g = g.to(torch.float32)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_((g * (1 - b2)).mul_(g))
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        wd = self._lamb_weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        val32 = value.to(torch.float32)
        r = m_hat.div_(torch.sqrt(v_hat).add_(self._epsilon)).add_(
            wd * val32)
        w_norm = torch.linalg.vector_norm(val32)
        r_norm = torch.linalg.vector_norm(r)
        one = self._const(1.0, torch.float32, value.device)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            one)
        value.copy_((val32 - lr * trust * r).to(value.dtype))
