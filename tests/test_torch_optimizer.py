"""The port's Adam/AdamW against the reference optimizers: identical
numpy parameters and per-step gradients, 5 steps, every parameter and
the state dict within rtol 1e-6 (both run the same f32 recurrence, op
for op)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.framework.tensor import Parameter

from paddle_tpu_torch import optimizer as topt

SHAPES = {"linear.weight": (4, 3), "linear.bias": (3,),
          "norm.weight": (5,), "conv.weight": (2, 2, 3)}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}


def _run(kind, steps=5, **kw):
    init = _params()
    jp = {n: Parameter(a.copy(), name=n) for n, a in init.items()}
    tp = {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
          for n, a in init.items()}
    lr_ratio = kw.pop("lr_ratio", None)
    jo = getattr(jopt, kind)(
        parameters=list(jp.values()),
        lr_ratio=(lambda p: lr_ratio(p.name)) if lr_ratio else None, **kw) \
        if kind == "AdamW" else getattr(jopt, kind)(
            parameters=list(jp.values()), **kw)
    names = {id(p): n for n, p in tp.items()}
    to = getattr(topt, kind)(
        parameters=list(tp.items()),
        lr_ratio=(lambda p: lr_ratio(names[id(p)])) if lr_ratio else None,
        **kw) if kind == "AdamW" else getattr(topt, kind)(
            parameters=list(tp.items()), **kw)
    for step in range(steps):
        g = _grads(step)
        for n in SHAPES:
            jp[n].grad = paddle.to_tensor(g[n])
            tp[n].grad = torch.from_numpy(g[n])
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    return jp, tp, jo, to


CASES = {
    "adam": ("Adam", dict(learning_rate=0.01)),
    "adam_l2": ("Adam", dict(learning_rate=0.01, weight_decay=0.05)),
    "adam_amsgrad": ("Adam", dict(learning_rate=0.01, amsgrad=True,
                                  beta1=0.8, beta2=0.95, epsilon=1e-6)),
    "adamw": ("AdamW", dict(learning_rate=3e-3, weight_decay=0.1)),
    "adamw_decay_fun": ("AdamW", dict(
        learning_rate=3e-3, weight_decay=0.1,
        apply_decay_param_fun=lambda name: "norm" not in name
        and "bias" not in name)),
    "adamw_lr_ratio": ("AdamW", dict(
        learning_rate=3e-3, weight_decay=0.1,
        lr_ratio=lambda name: 0.5 if "conv" in name else 1.0)),
    "adamw_amsgrad": ("AdamW", dict(learning_rate=3e-3, weight_decay=0.01,
                                    amsgrad=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_reference(case):
    kind, kw = CASES[case]
    jp, tp, jo, to = _run(kind, **dict(kw))
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].detach().numpy(),
                                   np.asarray(jp[n].numpy()), rtol=1e-6,
                                   atol=0, err_msg=n)
        assert tp[n].grad is None
    js, ts = jo.state_dict(), to.state_dict()
    assert sorted(js) == sorted(ts)
    for key in js:
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key].numpy()),
                                   rtol=1e-6, atol=0, err_msg=key)


def test_state_dict_roundtrip_and_lr():
    _, tp, _, to = _run("AdamW", steps=2, learning_rate=1e-3)
    state = {k: v.clone() for k, v in to.state_dict().items()}
    fresh = topt.AdamW(learning_rate=1e-3, parameters=list(tp.items()))
    fresh.set_state_dict(state)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert state["linear.weight_beta1_pow_acc"].dtype == torch.float32
    fresh.set_lr(5e-4)
    assert fresh.get_lr() == 5e-4


def test_unnamed_params_and_unported_options():
    p = torch.nn.Parameter(torch.ones(3))
    o = topt.Adam(learning_rate=0.1, parameters=[p])
    p.grad = torch.ones(3)
    o.step()
    assert sorted(o.state_dict()) == sorted(
        f"param_0_{n}" for n in ("moment1", "moment2", "beta1_pow_acc",
                                 "beta2_pow_acc"))
    o.clear_grad(set_to_zero=True)
    assert torch.equal(p.grad, torch.zeros(3))
    with pytest.raises(NotImplementedError, match="item 9"):
        topt.AdamW(parameters=[p], grad_clip=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        topt.AdamW(learning_rate=lambda: 0.1, parameters=[p])
    with pytest.raises(ValueError, match="parameters"):
        topt.Adam()
