"""Optimizer base class (port of the reference package's
``optimizer/optimizer.py``): accumulators per parameter, param groups,
``multi_precision`` master weights, L1/L2 decay, ``grad_clip``, a float
or scheduled learning rate, ``step`` / ``minimize`` / ``clear_grad`` /
``state_dict``.

Parameters come as an iterable of tensors, of ``(name, tensor)`` pairs
(``model.named_parameters()``), or of group dicts ``{"params": [...],
"learning_rate": scale, "weight_decay": decay}``. A name is what
``apply_decay_param_fun`` sees and what keys the state dict; an unnamed
parameter ``i`` is ``param_{i}``, as in the reference. A parameter's
``optimize_attr["learning_rate"]`` scales its learning rate and its
``regularizer`` overrides the group's and the optimizer's decay.

Updates happen in place on the parameters and accumulators, under
``torch.no_grad``, each rounded where the reference rounds it. The
learning rate lives in one 0-d f32 device tensor per optimizer:
``step()`` writes ``get_lr()`` into it before the update, except under a
CUDA-graph capture, where the captured update reads the tensor and the
compiled step (:mod:`paddle_tpu_torch.jit`) refills it before each
replay, so a schedule never needs a new capture. A masked
``GradScaler`` step sets ``_lr_mask``, a 0-d bool device flag, and the
update then reads ``where(flag, 0, lr)``. ``multi_precision`` may be
switched on after construction (``amp.decorate`` does), until the first
step makes the state. The state of a parameter placed over a mesh (a
``DTensor``) takes the parameter's layout. Every other constant
of an update is a device scalar made once outside any capture, and no
update reads a value on the host. Optimizer state made under a capture
would be refilled at every replay, so making it there raises: a compiled
step runs its first step eagerly.
"""

from __future__ import annotations

import collections

import torch

from . import lr as lr_mod

__all__ = ["Optimizer"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _full(param, shape, fill_value, dtype):
    """A state tensor of ``shape`` for ``param``: one of the parameter's
    shape and a placed (``DTensor``) parameter's layout, so the update
    runs shard by shard; any other shape a plain tensor on its device."""
    if type(param).__name__ == "DTensor" and \
            tuple(shape) == tuple(param.shape):
        from torch.distributed.tensor import full
        return full(shape, fill_value, dtype=dtype,
                    device_mesh=param.device_mesh,
                    placements=param.placements)
    return torch.full(shape, fill_value, dtype=dtype, device=param.device)


def _capturing(device):
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class Optimizer:
    """Base optimizer. Subclasses implement ``_create_accumulators`` and
    ``_single_update(p, g, lr, value)``, which updates ``value`` (the
    parameter, or its f32 master weight) in place; ``lr`` is a 0-d f32
    device tensor."""

    _accum_names: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters is required: pass "
                             "model.parameters() or model.named_parameters()")
        self._names = {}
        self._parameter_list = []
        self._param_groups = []
        items = list(parameters)
        if items and isinstance(items[0], dict):
            for group in items:
                g = dict(group)
                g["params"] = self._add_params(g["params"])
                self._param_groups.append(g)
        else:
            self._param_groups.append({"params": self._add_params(items)})
        self._learning_rate = self._as_lr(learning_rate)
        self._lr_tensor = None
        # a 0-d bool device flag set by a masked GradScaler step: the
        # update reads lr 0 where it holds
        self._lr_mask = None
        self.regularization = weight_decay
        self._group_weight_decay = None    # set per group during step()
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._name = name or type(self).__name__.lower()
        # accumulators: name -> {id(param): tensor}
        self._accumulators = collections.defaultdict(dict)
        self._accumulators_created = False
        self._consts = {}

    def _add_params(self, items):
        params = []
        for item in items:
            name, p = item if isinstance(item, tuple) else (None, item)
            self._names[id(p)] = name or f"param_{len(self._parameter_list)}"
            self._parameter_list.append(p)
            params.append(p)
        return params

    @staticmethod
    def _as_lr(value):
        if isinstance(value, lr_mod.LRScheduler):
            return value
        if not isinstance(value, (int, float)):
            raise TypeError("learning_rate must be a float or an "
                            f"LRScheduler, got {type(value).__name__}")
        return float(value)

    # -- learning rate ------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, lr_mod.LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, lr_mod.LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        if not isinstance(scheduler, lr_mod.LRScheduler):
            raise TypeError("expected an LRScheduler")
        self._learning_rate = scheduler

    def lr_tensor(self):
        """The 0-d f32 device tensor the updates read the learning rate
        from (None before the first step)."""
        return self._lr_tensor

    def refresh_lr(self):
        """Write ``get_lr()`` into the device learning rate (a fill
        kernel; never call it under a capture)."""
        if self._lr_tensor is not None:
            self._lr_tensor.fill_(self.get_lr())

    def _step_lr(self, device):
        if _capturing(device):
            if self._lr_tensor is None:
                raise RuntimeError(
                    "the optimizer's learning-rate tensor would be made "
                    "under a CUDA-graph capture: run one eager step first")
        elif self._lr_tensor is None:
            self._lr_tensor = torch.full((), self.get_lr(),
                                         dtype=torch.float32, device=device)
        else:
            self._lr_tensor.fill_(self.get_lr())
        if self._lr_mask is None:
            return self._lr_tensor
        # a device select, so the flag is never read on the host
        return torch.where(self._lr_mask,
                           self._const(0.0, torch.float32, device),
                           self._lr_tensor)

    def _const(self, value, dtype, device):
        """``value`` as a 0-d ``dtype`` tensor on ``device``, made once
        (a fill kernel) and kept; under a capture one that is not made
        yet is made for the graph alone."""
        key = (float(value), dtype, device)
        t = self._consts.get(key)
        if t is None:
            t = torch.full((), value, dtype=dtype, device=device)
            if not _capturing(device):
                self._consts[key] = t
        return t

    # -- accumulators -------------------------------------------------------
    def _new_state(self, param, make):
        if _capturing(param.device):
            raise RuntimeError(
                f"optimizer state for parameter {self._names[id(param)]} "
                "would be made under a CUDA-graph capture (and refilled at "
                "every replay): run one eager step first")
        return make()

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        per = self._accumulators[name]
        if id(param) not in per:
            shape = tuple(param.shape) if shape is None else shape
            dt = dtype or param.dtype
            if self._multi_precision and param.dtype in _LOW_PRECISION \
                    and dtype is None:
                dt = torch.float32
            per[id(param)] = self._new_state(
                param, lambda: _full(param, shape, fill_value, dt))
        return per[id(param)]

    def _get_accumulator(self, name, param):
        try:
            return self._accumulators[name][id(param)]
        except KeyError:
            raise RuntimeError(
                f"accumulator {name!r} for parameter "
                f"{self._names.get(id(param))} not created yet") from None

    def _master_weight(self, param):
        """The f32 master copy of a low-precision parameter under
        ``multi_precision``, else None."""
        if not (self._multi_precision and param.dtype in _LOW_PRECISION):
            return None
        per = self._accumulators["master_weight"]
        if id(param) not in per:
            per[id(param)] = self._new_state(
                param, lambda: param.detach().to(torch.float32))
        return per[id(param)]

    def _create_accumulators(self, params):
        for name in self._accum_names:
            for p in params:
                self._add_accumulator(name, p)

    # -- the update ---------------------------------------------------------
    def _apply_regularization(self, p, g):
        """L2 (``coeff * p``) or L1 (``coeff * sign(p)``) decay folded into
        the gradient. The parameter's own regularizer wins over its
        group's, which wins over the optimizer's; a float is L2."""
        if getattr(p, "regularizer", None) is not None:
            reg = p.regularizer
        elif self._group_weight_decay is not None:
            reg = self._group_weight_decay
        else:
            reg = self.regularization
        if reg is None:
            return g
        coeff = getattr(reg, "coeff", None)
        if coeff is None:
            coeff = float(reg)
        c = self._const(coeff, g.dtype, g.device)
        if getattr(reg, "_l1", False):
            return g + c * torch.sign(p).to(g.dtype)
        return g + c * p.to(g.dtype)

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if not params_grads:
            return
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        # idempotent: parameters whose grads first appear later get state
        self._create_accumulators([p for p, _ in params_grads])
        self._accumulators_created = True
        lr = self._step_lr(params_grads[0][0].device)
        for group in self._param_groups:
            group_scale = group.get("learning_rate", 1.0)
            self._group_weight_decay = group.get("weight_decay")
            members = {id(p) for p in group["params"]}
            for p, g in params_grads:
                if id(p) not in members:
                    continue
                scale = group_scale * getattr(p, "optimize_attr", {}).get(
                    "learning_rate", 1.0)
                lr_p = lr if scale == 1.0 else lr * scale
                master = self._master_weight(p)
                if master is not None:
                    g = self._apply_regularization(p, g.to(torch.float32))
                    self._single_update(p, g, lr_p, master)
                    p.copy_(master)
                else:
                    g = self._apply_regularization(p, g.to(p.dtype))
                    self._single_update(p, g, lr_p, p)
        self._group_weight_decay = None

    def _single_update(self, p, g, lr, value):
        raise NotImplementedError

    minimize_step = step

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then :meth:`step`, as the reference's
        ``Optimizer.minimize``."""
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- bookkeeping --------------------------------------------------------
    def state_dict(self):
        """Accumulators keyed ``'{param_name}_{accumulator}'`` and the
        scheduler's state under ``'LR_Scheduler'``, as in the
        reference."""
        state = {f"{self._names[pid]}_{name}": acc
                 for name, per in self._accumulators.items()
                 for pid, acc in per.items()}
        if isinstance(self._learning_rate, lr_mod.LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        return state

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        sched = state_dict.pop("LR_Scheduler", None)
        if sched is not None and isinstance(self._learning_rate,
                                            lr_mod.LRScheduler):
            self._learning_rate.set_state_dict(sched)
        if not self._accumulators_created:
            self._create_accumulators(
                [p for p in self._parameter_list if p.requires_grad])
            self._accumulators_created = True
        for name, per in self._accumulators.items():
            for pid, acc in per.items():
                key = f"{self._names[pid]}_{name}"
                if key in state_dict:
                    acc.copy_(torch.as_tensor(state_dict[key]))
