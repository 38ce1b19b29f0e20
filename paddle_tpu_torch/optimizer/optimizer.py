"""Optimizer base class (port of the reference package's
``optimizer/optimizer.py``): accumulators per parameter, ``step`` /
``clear_grad`` / ``state_dict``, a float learning rate.

Parameters come as an iterable of tensors or of ``(name, tensor)``
pairs (``model.named_parameters()``); a name is what
``apply_decay_param_fun`` sees and what keys the state dict, and an
unnamed parameter ``i`` is ``param_{i}``, as in the reference.
Updates happen in place on the parameters and accumulators, under
``torch.no_grad``. LR schedulers and ``grad_clip`` are not ported yet
(ROADMAP queue A, item 9).
"""

from __future__ import annotations

import collections

import torch

__all__ = ["Optimizer"]


class Optimizer:
    """Base optimizer. Subclasses implement ``_create_accumulators`` and
    ``_single_update(p, g, lr)``, which updates ``p`` in place."""

    _accum_names: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters is required: pass "
                             "model.parameters() or model.named_parameters()")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP queue A, item 9)")
        items = list(parameters)
        self._names = {}
        self._parameter_list = []
        for i, item in enumerate(items):
            name_i, p = item if isinstance(item, tuple) else (f"param_{i}",
                                                              item)
            self._names[id(p)] = name_i
            self._parameter_list.append(p)
        self._learning_rate = self._as_lr(learning_rate)
        self.regularization = weight_decay
        self._name = name or type(self).__name__.lower()
        # accumulators: name -> {id(param): tensor}
        self._accumulators = collections.defaultdict(dict)

    @staticmethod
    def _as_lr(value):
        if not isinstance(value, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet (ROADMAP queue "
                "A, item 9); pass a float")
        return float(value)

    # -- learning rate ------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = self._as_lr(value)

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        per = self._accumulators[name]
        if id(param) not in per:
            shape = tuple(param.shape) if shape is None else shape
            per[id(param)] = torch.full(shape, fill_value,
                                        dtype=dtype or param.dtype,
                                        device=param.device)
        return per[id(param)]

    def _get_accumulator(self, name, param):
        try:
            return self._accumulators[name][id(param)]
        except KeyError:
            raise RuntimeError(
                f"accumulator {name!r} for parameter "
                f"{self._names.get(id(param))} not created yet") from None

    def _create_accumulators(self, params):
        for name in self._accum_names:
            for p in params:
                self._add_accumulator(name, p)

    # -- the update ---------------------------------------------------------
    def _apply_regularization(self, p, g):
        """L2 decay folded into the gradient (a float weight_decay, or an
        object with ``coeff``)."""
        reg = self.regularization
        if reg is None:
            return g
        coeff = float(getattr(reg, "coeff", reg))
        return g + torch.tensor(coeff, dtype=g.dtype, device=g.device) * p

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        # idempotent: parameters whose grads first appear later get state
        self._create_accumulators([p for p, _ in params_grads])
        for p, g in params_grads:
            g = self._apply_regularization(p, g.to(p.dtype))
            self._single_update(p, g, self.get_lr())

    def _single_update(self, p, g, lr):
        raise NotImplementedError

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # -- bookkeeping --------------------------------------------------------
    def state_dict(self):
        """Accumulators keyed ``'{param_name}_{accumulator}'``, as in
        the reference."""
        return {f"{self._names[pid]}_{name}": acc
                for name, per in self._accumulators.items()
                for pid, acc in per.items()}

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        self._create_accumulators(
            [p for p in self._parameter_list if p.requires_grad])
        for name, per in self._accumulators.items():
            for pid, acc in per.items():
                key = f"{self._names[pid]}_{name}"
                if key in state_dict:
                    acc.copy_(torch.as_tensor(state_dict[key]))
