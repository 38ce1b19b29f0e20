"""``jit.to_static`` on the CPU, the reference's ``tests/test_jit.py``
cases that apply to a CUDA-graph step: a compiled step equal to the
eager one, the warm-up per signature or once, a failed warm-up not
marked warm, state found through closures, holders and globals, a module
wrapped, the kill switch, and a schedule that changes the learning rate
without a new graph. On the CPU every call after the warm-up runs the
function on the same static buffers, so each call is exactly one step;
the capture itself is held on the card by ``chip_smoke.py`` (phase 18).
The numbers match the reference's compiled step too (rtol 1e-5)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as pjit
import paddle_tpu.nn as pnn
import paddle_tpu.optimizer as popt

from paddle_tpu_torch import jit
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.observability import compile_watch as cw

torch.set_num_threads(1)

X = np.random.RandomState(0).randn(16, 4).astype("float32")
Y = (X @ np.ones((4, 1), "float32")).astype("float32")


def make_model(seed, kind="AdamW", lr=0.05):
    torch.manual_seed(seed)
    m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                            torch.nn.Linear(8, 1))
    return m, getattr(optim, kind)(learning_rate=lr,
                                   parameters=m.named_parameters())


def _step_of(m, o):
    def step(x, y):
        loss = ((m(x) - y) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        return loss
    return step


def _xy(n=16):
    return torch.from_numpy(X[:n]), torch.from_numpy(Y[:n])


def test_matches_eager_numerics():
    m1, o1 = make_model(7)
    m2, o2 = make_model(7)
    eager, compiled = _step_of(m1, o1), jit.to_static(_step_of(m2, o2),
                                                      state=[m2, o2])
    x, y = _xy()
    for i in range(6):
        le, lc = eager(x, y), compiled(x, y)
        assert le.item() == lc.item(), i
        assert lc.grad_fn is None and not lc.requires_grad
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    assert len(compiled._cache) == 1


def test_matches_reference_compiled_step():
    """The port's compiled loop against the reference's ``to_static``
    loop from the same weights (the linear weights transposed)."""
    paddle.seed(7)
    jm = pnn.Sequential(pnn.Linear(4, 8), pnn.Tanh(), pnn.Linear(8, 1))
    jo = popt.AdamW(learning_rate=0.05, parameters=jm.parameters())
    tm, to = make_model(0)
    with torch.no_grad():
        for (_, jp), (_, tp) in zip(jm.named_parameters(),
                                    tm.named_parameters()):
            a = np.array(jp.numpy())
            tp.copy_(torch.from_numpy(a.T.copy() if a.ndim == 2 else a))

    @pjit.to_static(state=[jm, jo])
    def jstep(x, y):
        loss = ((jm(x) - y) ** 2).mean()
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss
    tstep = jit.to_static(_step_of(tm, to), state=[tm, to])
    x, y = _xy()
    for i in range(5):
        want = float(jstep(paddle.to_tensor(X), paddle.to_tensor(Y)))
        got = tstep(x, y).item()
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=str(i))


def test_closure_discovery_and_no_leak():
    m, o = make_model(3)

    @jit.to_static
    def step(x, y):
        loss = ((m(x) - y) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        return loss

    x, y = _xy()
    losses = [step(x, y).item() for _ in range(6)]
    assert losses[-1] < losses[0]
    assert step._layers == [m] and step._optimizers == [o]


def test_new_shape_warms_up_then_compiles():
    m, o = make_model(4)

    @jit.to_static(state=[m, o])
    def step(x):
        loss = m(x).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        return loss

    a, b = torch.zeros(8, 4), torch.zeros(16, 4)
    for t in (a, a, b, b):
        step(t)
    assert len(step._cache) == 2          # one graph per shape
    assert len(step._warm) >= 2           # each shape warmed up eagerly


def test_layer_wrap_forward_only():
    torch.manual_seed(0)
    layer = torch.nn.Linear(4, 2)
    want = layer(torch.from_numpy(X)).detach()
    wrapped = jit.to_static(layer)
    assert wrapped is layer
    y1 = wrapped(torch.from_numpy(X))
    y2 = wrapped(torch.from_numpy(X))         # on the static buffers
    assert torch.equal(y1, want) and torch.equal(y2, want)


def test_kill_switch():
    m, o = make_model(5)
    calls = []

    @jit.to_static(state=[m, o])
    def step(x):
        calls.append(1)
        return m(x).mean()

    jit.enable_to_static(False)
    try:
        for _ in range(3):
            step(torch.from_numpy(X))
        assert len(calls) == 3 and not step._cache and not step._warm
    finally:
        jit.enable_to_static(True)


def test_lr_schedule_no_recapture():
    m, _ = make_model(6)
    sched = optim.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    o = optim.SGD(learning_rate=sched, parameters=m.named_parameters())
    m2, _ = make_model(6)
    sched2 = optim.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    o2 = optim.SGD(learning_rate=sched2, parameters=m2.named_parameters())
    step = jit.to_static(_step_of(m, o), state=[m, o])
    eager = _step_of(m2, o2)
    x, y = _xy()
    for i in range(5):
        assert step(x, y).item() == eager(x, y).item(), i
        assert o.lr_tensor().item() == np.float32(sched())
        sched.step()
        sched2.step()
    assert len(step._cache) == 1


def test_warmup_once_compiles_new_shapes_directly():
    m1, o1 = make_model(9)
    m2, o2 = make_model(9)
    calls = {"n": 0}

    def _step(x, y):
        calls["n"] += 1
        return _step_of(m2, o2)(x, y)

    eager = _step_of(m1, o1)
    compiled = jit.to_static(_step, state=[m2, o2], warmup="once")
    xs, ys = _xy(4)
    xb, yb = _xy()
    compiled(xs, ys)                 # the eager warm-up (small shape)
    eager(xs, ys)
    assert calls["n"] == 1 and len(compiled._warm) >= 1
    for _ in range(3):
        assert compiled(xb, yb).item() == eager(xb, yb).item()
    assert len(compiled._cache) == 1
    assert all(s[0][0][0] == (4, 4) for s in compiled._warm)


def test_failed_warmup_not_marked_warm():
    m, o = make_model(11)
    boom = {"on": True}

    def _step(x, y):
        if boom["on"]:
            raise RuntimeError("injected warm-up failure")
        return _step_of(m, o)(x, y)

    step = jit.to_static(_step, state=[m, o], warmup="once")
    x, y = _xy()
    with pytest.raises(RuntimeError, match="injected"):
        step(x, y)
    assert not step._warm and not step._warmed_any
    boom["on"] = False
    first = step(x, y).item()          # the warm-up again
    assert not step._cache
    second = step(x, y).item()
    assert np.isfinite(first) and np.isfinite(second)
    assert len(step._cache) == 1


def test_state_behind_object_attributes():
    class Trainer:
        def __init__(self):
            self.model, self.opt = make_model(13)

    tr = Trainer()
    m_ref, o_ref = make_model(13)

    def step(x, y):
        loss = ((tr.model(x) - y) ** 2).mean()
        loss.backward()
        tr.opt.step()
        tr.opt.clear_grad()
        return loss

    compiled = jit.to_static(step)
    x, y = _xy()
    for _ in range(4):
        assert compiled(x, y).item() == _step_of(m_ref, o_ref)(x, y).item()
    assert compiled._layers == [tr.model]
    assert compiled._optimizers == [tr.opt]


_holder = None


def test_module_level_holder_and_containers():
    global _holder
    w = torch.nn.Parameter(torch.tensor([[1.0], [2.0]]))
    opt = optim.SGD(learning_rate=0.1, parameters=[w])
    _holder = [w, opt]

    def step(x):
        loss = (x @ _holder[0]).pow(2).mean()
        loss.backward()
        _holder[1].step()
        _holder[1].clear_grad()
        return loss

    compiled = jit.to_static(step)
    x = torch.ones(4, 2)
    losses = [compiled(x).item() for _ in range(4)]
    assert losses[-1] < losses[0]
    assert compiled._optimizers == [opt]
    _holder = None


def test_capture_reported_once_per_signature(monkeypatch):
    """On the card each capture reports one compile of the callable to
    the compile watcher; with the capture stubbed, the step's graph set is
    asked to capture once per signature and replays after."""
    from paddle_tpu_torch.ops import _graphs
    captured, replayed = [], []

    class Graphs(_graphs.StepGraphs):
        def __init__(self, device, name="graphs"):
            super().__init__(device, name)
            self.cuda = True

        def capture(self, key, fn, signature=None, before_capture=None):
            fn()
            before_capture()
            fn()
            captured.append(signature)
            cw.note_capture(self.name, signature, 0.0)

        def replay(self, key):
            replayed.append(key)

    monkeypatch.setattr(jit, "StepGraphs", Graphs)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    cw.reset()
    m, o = make_model(2)
    step = jit.to_static(_step_of(m, o), state=[m, o], name="test.step")
    x, y = _xy()
    for _ in range(5):
        step(x, y)
    assert len(captured) == 1 and len(replayed) == 3
    assert "arg0=float32[16,4]" in captured[0]
    events = [e for e in cw.recent_compile_events()
              if e.get("name") == "test.step"]
    assert len(events) == 1


def test_save_and_load_raise_naming_a14():
    with pytest.raises(NotImplementedError, match="A14"):
        jit.save(torch.nn.Linear(2, 2), "x")
    with pytest.raises(NotImplementedError, match="A14"):
        jit.load("x")
