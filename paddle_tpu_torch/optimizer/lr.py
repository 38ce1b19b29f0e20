"""Learning-rate schedules (a copy of the reference package's
``optimizer/lr.py``: ``LRScheduler`` and its 17 schedules, host Python
with ``math`` only).

A schedule is host state. The optimizer writes its current value into
one f32 device tensor before each update, so a CUDA-graph train step
(:mod:`paddle_tpu_torch.jit`) reads every step's value from that tensor
and a changing learning rate never needs a new capture.
"""

from __future__ import annotations

import math

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "ExponentialDecay",
    "MultiStepDecay", "StepDecay", "LambdaDecay", "ReduceOnPlateau",
    "CosineAnnealingDecay", "MultiplicativeDecay", "OneCycleLR", "CyclicLR",
    "LinearLR", "CosineAnnealingWarmRestarts",
]


class LRScheduler:
    """Base class (reference lr.py ``LRScheduler``): subclasses implement
    ``get_lr()``; ``step()`` advances ``last_epoch`` and refreshes
    ``last_lr``."""

    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        if not isinstance(learning_rate, (float, int)):
            raise TypeError(
                f"learning_rate must be float, got {type(learning_rate)}")
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: {type(self).__name__} "
                  f"set learning rate to {self.last_lr}.")

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        """Host-side schedule state (reference lr.py state_dict): every
        non-callable instance attribute."""
        state = {}
        for k, v in self.__dict__.items():
            if k == "verbose" or callable(v):
                continue
            state[k] = v
        return state

    def set_state_dict(self, state_dict):
        for k, v in state_dict.items():
            if k in self.__dict__:
                self.__dict__[k] = v
        self.last_lr = self.get_lr()

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        if len(values) != len(boundaries) + 1:
            raise ValueError("values must have one more element than boundaries")
        self.boundaries = list(boundaries)
        self.values = [float(v) for v in values]
        super().__init__(self.values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[-1]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    """Linear warmup from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then follow the wrapped schedule (or constant)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.learning_rate = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            if self.warmup_steps == 0:
                return self.end_lr
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / self.warmup_steps) + self.start_lr
        if isinstance(self.learning_rate, LRScheduler):
            self.learning_rate.step(self.last_epoch - self.warmup_steps)
            return self.learning_rate()
        return float(self.learning_rate)

    def state_dict(self):
        state = super().state_dict()
        inner = state.pop("learning_rate", None)
        if isinstance(inner, LRScheduler):
            state["LinearWarmup_LR"] = inner.state_dict()
        return state

    def set_state_dict(self, state_dict):
        inner = state_dict.pop("LinearWarmup_LR", None)
        if inner is not None and isinstance(self.learning_rate, LRScheduler):
            self.learning_rate.set_state_dict(inner)
        super().set_state_dict(state_dict)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        if not all(milestones[i] < milestones[i + 1]
                   for i in range(len(milestones) - 1)):
            raise ValueError("milestones must be increasing")
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        if step_size <= 0:
            raise ValueError("step_size must be positive")
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        cur = self.base_lr
        for e in range(1, self.last_epoch + 1):
            cur *= self.lr_lambda(e)
        return cur


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = float(eta_min)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        if T_0 <= 0 or T_mult < 1:
            raise ValueError("T_0 must be > 0 and T_mult >= 1")
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = float(eta_min)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        epoch = max(self.last_epoch, 0)
        t_i = self.T_0
        t_cur = epoch
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)) / 2


class ReduceOnPlateau(LRScheduler):
    """Reduce lr when a metric has stopped improving (reference lr.py
    ``ReduceOnPlateau``); ``step(metric)`` takes the monitored value."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError("threshold_mode must be 'rel' or 'abs'")
        if factor >= 1.0:
            raise ValueError("factor must be < 1.0")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.verbose = verbose
        self.base_lr = float(learning_rate)
        self.last_lr = float(learning_rate)
        self.cooldown_counter = 0
        self.best = None
        self.num_bad_epochs = 0
        self.last_epoch = 0

    def step(self, metrics, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        try:
            current = float(metrics)
        except (TypeError, ValueError):
            current = float(getattr(metrics, "item")())
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            if self.best is None or self._is_better(current):
                self.best = current
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.cooldown_counter = self.cooldown
                self.num_bad_epochs = 0
                new_lr = max(self.last_lr * self.factor, self.min_lr)
                if self.last_lr - new_lr > self.epsilon:
                    self.last_lr = new_lr
                    if self.verbose:
                        print(f"Epoch {self.last_epoch}: ReduceOnPlateau "
                              f"set learning rate to {self.last_lr}.")

    def _is_better(self, current):
        best = self.best
        if self.mode == "min":
            thr = best - self.threshold * abs(best) \
                if self.threshold_mode == "rel" else best - self.threshold
            return current < thr
        thr = best + self.threshold * abs(best) \
            if self.threshold_mode == "rel" else best + self.threshold
        return current > thr

    def get_lr(self):
        return self.last_lr


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = float(max_learning_rate)
        self.total_steps = total_steps
        self.initial_lr = self.max_lr / divide_factor
        self.end_lr = float(end_learning_rate)
        self.three_phase = three_phase
        if anneal_strategy not in ("cos", "linear"):
            raise ValueError("anneal_strategy must be 'cos' or 'linear'")
        self.anneal_strategy = anneal_strategy
        up = float(phase_pct * total_steps) - 1
        if three_phase:
            self._phases = [
                (up, self.initial_lr, self.max_lr),
                (2 * up, self.max_lr, self.initial_lr),
                (total_steps - 1, self.initial_lr, self.end_lr),
            ]
        else:
            self._phases = [
                (up, self.initial_lr, self.max_lr),
                (total_steps - 1, self.max_lr, self.end_lr),
            ]
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _anneal(self, start, end, pct):
        if self.anneal_strategy == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def get_lr(self):
        step = self.last_epoch
        start_step = 0.0
        for end_step, start_lr, end_lr in self._phases:
            if step <= end_step or end_step == self._phases[-1][0]:
                span = end_step - start_step
                pct = 0.0 if span == 0 else min((step - start_step) / span, 1.0)
                return self._anneal(start_lr, end_lr, pct)
            start_step = end_step
        return self.end_lr


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = float(max_learning_rate)
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down or step_size_up
        self.cycle_size = self.step_size_up + self.step_size_down
        self.exp_gamma = exp_gamma
        self.mode = mode
        if scale_fn is not None:
            self._scale_fn = scale_fn
            self.scale_mode = scale_mode
        elif mode == "triangular":
            self._scale_fn = lambda x: 1.0
            self.scale_mode = "cycle"
        elif mode == "triangular2":
            self._scale_fn = lambda x: 1 / (2.0 ** (x - 1))
            self.scale_mode = "cycle"
        elif mode == "exp_range":
            self._scale_fn = lambda x: self.exp_gamma ** x
            self.scale_mode = "iterations"
        else:
            raise ValueError(f"invalid mode {mode!r}")
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        it = self.last_epoch
        cycle = math.floor(1 + it / self.cycle_size)
        pos = it - (cycle - 1) * self.cycle_size
        if pos <= self.step_size_up:
            pct = pos / self.step_size_up
        else:
            pct = 1 - (pos - self.step_size_up) / self.step_size_down
        amp = (self.max_lr - self.base_lr) * pct
        x = cycle if self.scale_mode == "cycle" else it
        return self.base_lr + amp * self._scale_fn(x)

    def state_dict(self):
        state = super().state_dict()
        state.pop("_scale_fn", None)
        return state


class LinearLR(LRScheduler):
    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        factor = self.start_factor + (
            self.end_factor - self.start_factor) * step / self.total_steps
        return self.base_lr * factor
