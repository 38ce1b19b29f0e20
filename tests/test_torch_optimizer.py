"""The port's optimizers against the reference's: identical numpy
parameters and per-step gradients, every parameter and the state dict
within rtol 1e-6 (both run the same f32 recurrence, op for op). Adam
and AdamW over 5 steps with their options; each of the nine optimizers
over 3 steps plain, with L2 decay, with ``grad_clip``, with a schedule,
with param groups and with ``multi_precision`` bf16 parameters."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.clip as jclip
import paddle_tpu.optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.framework.tensor import Parameter

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import clip as tclip

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)

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
    # grad_clip and a scheduled learning rate: ported, and equal to the
    # reference's
    for kw in (dict(grad_clip="clip"), dict(learning_rate="sched")):
        jp, tp, jo, to = _run_kind("AdamW", steps=3, **kw)
        _check(jp, tp, jo, to)
    with pytest.raises(TypeError, match="LRScheduler"):
        topt.AdamW(learning_rate=lambda: 0.1, parameters=[p])
    with pytest.raises(ValueError, match="parameters"):
        topt.Adam()


# every optimizer, its learning rate and options in both packages
KINDS = {
    "SGD": dict(learning_rate=0.1),
    "Momentum": dict(learning_rate=0.05, momentum=0.8, use_nesterov=True),
    "Adagrad": dict(learning_rate=0.05, initial_accumulator_value=0.1),
    "Adam": dict(learning_rate=0.01),
    "AdamW": dict(learning_rate=3e-3, weight_decay=0.1),
    "Adamax": dict(learning_rate=0.01),
    "RMSProp": dict(learning_rate=0.01, centered=True, momentum=0.5),
    "Adadelta": dict(learning_rate=1.0),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.02),
}
VARIANTS = ("plain", "l2", "l1", "clip", "sched", "groups", "bf16_mp")
BF16 = 2.0 ** -8    # one bf16 ulp, relative


def _run_kind(kind, steps=3, variant="plain", grad_clip=None,
              learning_rate=None):
    """``kind`` stepped ``steps`` times in both packages on the same
    numpy parameters and gradients, with ``variant``'s option."""
    kw = dict(KINDS[kind])
    bf16 = variant == "bf16_mp"
    init = _params()
    if bf16:
        jp = {n: Parameter(jnp.asarray(a, jnp.bfloat16), name=n)
              for n, a in init.items()}
        tp = {n: torch.nn.Parameter(torch.from_numpy(a).to(torch.bfloat16))
              for n, a in init.items()}
        kw["multi_precision"] = True
    else:
        jp = {n: Parameter(a.copy(), name=n) for n, a in init.items()}
        tp = {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
              for n, a in init.items()}
    jkw, tkw = dict(kw), dict(kw)
    if variant in ("l2", "l1"):
        key = "lamb_weight_decay" if kind == "Lamb" else "weight_decay"
        if variant == "l1" and kind not in ("Lamb", "AdamW"):
            jkw[key], tkw[key] = jreg.L1Decay(0.02), treg.L1Decay(0.02)
        else:
            jkw[key] = tkw[key] = 0.05
    if variant == "clip" or grad_clip:
        jkw["grad_clip"] = jclip.ClipGradByGlobalNorm(0.5)
        tkw["grad_clip"] = tclip.ClipGradByGlobalNorm(0.5)
    scheds = []
    if variant == "sched" or learning_rate:
        base = kw["learning_rate"]
        scheds = [jopt.lr.LinearWarmup(jopt.lr.StepDecay(base, 1, 0.5), 2,
                                       base / 10, base),
                  topt.lr.LinearWarmup(topt.lr.StepDecay(base, 1, 0.5), 2,
                                       base / 10, base)]
        jkw["learning_rate"], tkw["learning_rate"] = scheds
    if variant == "groups":
        names = list(SHAPES)
        jparams = [{"params": [jp[n] for n in names[:2]],
                    "learning_rate": 0.5, "weight_decay": 0.01},
                   {"params": [jp[n] for n in names[2:]]}]
        tparams = [{"params": [(n, tp[n]) for n in names[:2]],
                    "learning_rate": 0.5, "weight_decay": 0.01},
                   {"params": [(n, tp[n]) for n in names[2:]]}]
    else:
        jparams, tparams = list(jp.values()), list(tp.items())
    jo = getattr(jopt, kind)(parameters=jparams, **jkw)
    to = getattr(topt, kind)(parameters=tparams, **tkw)
    for step in range(steps):
        g = _grads(step)
        for n in SHAPES:
            if bf16:
                jp[n].grad = paddle.to_tensor(
                    jnp.asarray(g[n], jnp.bfloat16))
                tp[n].grad = torch.from_numpy(g[n]).to(torch.bfloat16)
            else:
                jp[n].grad = paddle.to_tensor(g[n])
                tp[n].grad = torch.from_numpy(g[n])
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        for sc in scheds:
            sc.step()
    return jp, tp, jo, to


def _as_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


def _check(jp, tp, jo, to, rtol=1e-6, atol=1e-7):
    for n in SHAPES:
        want = _as_f32(jp[n]._data)
        if tp[n].dtype == torch.bfloat16:
            # a bf16 parameter is its f32 master rounded once: equal
            # masters round alike, and masters 1e-6 apart may straddle a
            # rounding boundary by one bf16 ulp
            np.testing.assert_allclose(_as_f32(tp[n]), want, rtol=BF16,
                                       atol=0, err_msg=n)
        else:
            np.testing.assert_allclose(_as_f32(tp[n]), want, rtol=rtol,
                                       atol=atol, err_msg=n)
    js, ts = jo.state_dict(), to.state_dict()
    assert sorted(js) == sorted(ts)
    for key, v in js.items():
        if key == "LR_Scheduler":
            assert ts[key]["last_epoch"] == v["last_epoch"]
            continue
        np.testing.assert_allclose(_as_f32(ts[key]), _as_f32(v._data),
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_optimizer_matches_reference(kind, variant):
    jp, tp, jo, to = _run_kind(kind, variant=variant)
    _check(jp, tp, jo, to)
    if variant == "bf16_mp":
        assert any(k.endswith("_master_weight") for k in to.state_dict())
        for n in SHAPES:
            assert tp[n].dtype == torch.bfloat16
    assert to.lr_tensor().dtype == torch.float32
    if variant != "sched":      # the schedule moved on after the step
        assert to.lr_tensor().item() == np.float32(to.get_lr())


def test_minimize_and_optimize_attr():
    """``minimize`` is backward then step; a parameter's
    ``optimize_attr["learning_rate"]`` scales its learning rate, as in
    the reference."""
    w0 = np.arange(6, dtype=np.float32).reshape(2, 3) / 10
    x = np.ones((4, 2), np.float32)
    jw = Parameter(w0.copy())
    jw.optimize_attr = {"learning_rate": 0.25}
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tw.optimize_attr = {"learning_rate": 0.25}
    jo = jopt.SGD(learning_rate=0.5, parameters=[jw])
    to = topt.SGD(learning_rate=0.5, parameters=[tw])
    jo.minimize(paddle.matmul(paddle.to_tensor(x), jw).sum())
    _, pg = to.minimize((torch.from_numpy(x) @ tw).sum())
    assert pg[0][0] is tw
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw.numpy()),
                               rtol=1e-6)
    assert not np.allclose(tw.detach().numpy(), w0)


def test_state_made_under_capture_raises(monkeypatch):
    """Optimizer state made under a CUDA-graph capture would be refilled at
    every replay: the port refuses to make it there."""
    from paddle_tpu_torch.optimizer import optimizer as base
    p = torch.nn.Parameter(torch.ones(3))
    o = topt.Adam(learning_rate=0.1, parameters=[p])
    p.grad = torch.ones(3)
    monkeypatch.setattr(base, "_capturing", lambda device: True)
    with pytest.raises(RuntimeError, match="eager step first"):
        o.step()
