"""The port's learning-rate schedules against the reference's: every
schedule's value over 60 steps equal as Python floats (the port's module
is a copy), a ``state_dict`` round trip into a fresh schedule that then
goes on equal, and the schedule inside an optimizer's ``state_dict``."""

import pytest
import torch

import paddle_tpu.optimizer.lr as jlr

from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(1)

STEPS = 60

# name -> (positional args, keyword args); the wrapped schedule of
# LinearWarmup is built per module
CASES = {
    "NoamDecay": ((64, 10), {}),
    "PiecewiseDecay": (([10, 30], [0.1, 0.05, 0.01]), {}),
    "NaturalExpDecay": ((0.5, 0.1), {}),
    "InverseTimeDecay": ((0.5, 0.1), {}),
    "PolynomialDecay": ((0.5, 20), dict(end_lr=0.01, power=2.0)),
    "PolynomialDecay_cycle": ((0.5, 20), dict(end_lr=0.01, cycle=True)),
    "LinearWarmup": ((None, 10, 0.0, 0.5), {}),
    "LinearWarmup_float": ((0.3, 10, 0.0, 0.5), {}),
    "ExponentialDecay": ((0.5, 0.9), {}),
    "MultiStepDecay": ((0.5, [10, 25, 40]), dict(gamma=0.5)),
    "StepDecay": ((0.5, 7), dict(gamma=0.7)),
    "LambdaDecay": ((0.5, lambda e: 0.95 ** e), {}),
    "MultiplicativeDecay": ((0.5, lambda e: 0.97), {}),
    "CosineAnnealingDecay": ((0.5, 20), dict(eta_min=0.01)),
    "CosineAnnealingWarmRestarts": ((0.5, 8), dict(T_mult=2,
                                                   eta_min=0.001)),
    "OneCycleLR": ((0.5, STEPS + 5), {}),
    "OneCycleLR_three_phase": ((0.5, STEPS + 5),
                               dict(three_phase=True,
                                    anneal_strategy="linear")),
    "CyclicLR": ((0.01, 0.5, 6), {}),
    "CyclicLR_exp": ((0.01, 0.5, 6), dict(mode="exp_range",
                                          exp_gamma=0.98)),
    "LinearLR": ((0.5, 30), dict(start_factor=0.2)),
}


def _make(mod, case):
    name = case.split("_")[0]
    args, kw = CASES[case]
    if case == "LinearWarmup":
        args = (mod.CosineAnnealingDecay(0.5, 20),) + args[1:]
    return getattr(mod, name)(*args, **kw)


def _values(sched, n, metric=None):
    out = []
    for i in range(n):
        out.append(sched())
        if metric is None:
            sched.step()
        else:
            sched.step(metric(i))
    return out


def test_every_schedule_is_covered():
    names = {c.split("_")[0] for c in CASES} | {"ReduceOnPlateau"}
    assert names == set(jlr.__all__) - {"LRScheduler"}
    assert tlr.__all__ == jlr.__all__


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_reference(case):
    want = _values(_make(jlr, case), STEPS)
    got = _values(_make(tlr, case), STEPS)
    assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_round_trip(case):
    a = _make(tlr, case)
    _values(a, 23)
    state = a.state_dict()
    b = _make(tlr, case)
    b.set_state_dict(dict(state))
    assert b() == a()
    assert _values(b, 20) == _values(a, 20)
    ref = _make(jlr, case)
    _values(ref, 23)
    assert sorted(ref.state_dict()) == sorted(state)


def test_reduce_on_plateau_matches_reference():
    def metric(i):
        return 1.0 if i < 5 else 1.0 + 0.01 * (i % 3)
    kw = dict(factor=0.5, patience=2, cooldown=1, min_lr=1e-3)
    want = _values(jlr.ReduceOnPlateau(0.4, **kw), STEPS, metric)
    got = _values(tlr.ReduceOnPlateau(0.4, **kw), STEPS, metric)
    assert got == want and got[-1] < got[0]
    a = tlr.ReduceOnPlateau(0.4, **kw)
    _values(a, 11, metric)
    b = tlr.ReduceOnPlateau(0.4, **kw)
    b.set_state_dict(a.state_dict())
    assert _values(b, 10, metric) == _values(a, 10, metric)


def test_schedule_in_optimizer_state_dict():
    p = torch.nn.Parameter(torch.ones(3))
    sched = tlr.StepDecay(0.5, 2, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=[p])
    for _ in range(3):
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    state = opt.state_dict()
    assert state["LR_Scheduler"]["last_epoch"] == 3
    fresh_sched = tlr.StepDecay(0.5, 2, gamma=0.5)
    fresh = AdamW(learning_rate=fresh_sched, parameters=[p])
    fresh.set_state_dict(state)
    assert fresh.get_lr() == opt.get_lr() == 0.25
    with pytest.raises(RuntimeError, match="LRScheduler"):
        fresh.set_lr(0.1)
