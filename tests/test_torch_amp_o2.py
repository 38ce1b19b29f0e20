"""The port's O2 ``amp.decorate`` and ``GradScaler`` against the reference
package's.

Tolerances: exact for the set of parameters ``decorate`` casts, for the
scaler's scale / growth / bad sequence and its overflow flags, and for a
skipped step's parameters (bitwise unchanged); the O2 tiny-Llama 5-step
AdamW curve within the O1 curve tolerance (2e-2 absolute,
``tests/test_torch_training.py``: bf16 rounding of the activations differs
in place); the toy Linear's losses and weights under the scaler within
1e-5 relative (the frameworks sum in different orders).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as pnn
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny

from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.amp import grad_scaler as GS
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.optimizer import SGD, AdamW

torch.set_num_threads(1)

B, S = 2, 128


def _llama_pair(seed):
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(tiny_llama_config(num_hidden_layers=2),
                          device="cpu")
    return jm, load_numpy_state(tm, arrays)


def _batch(seed):
    ids = np.random.RandomState(seed).randint(0, 128, (B, S + 1))
    return ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)


def test_decorate_casts_the_references_parameters():
    jm, tm = _llama_pair(0)
    jopt = paddle.optimizer.AdamW(parameters=jm.parameters())
    topt = AdamW(parameters=tm.named_parameters())
    params = {n: p for n, p in tm.named_parameters()}
    jm2, jopt2 = paddle.amp.decorate(jm, jopt, level="O2")
    tm2, topt2 = amp.decorate(tm, topt, level="O2")
    assert tm2 is tm and topt2 is topt and jm2 is jm
    want = sorted(n for n, p in jm.named_parameters()
                  if p.dtype.name == "bfloat16")
    got = sorted(n for n, p in tm.named_parameters()
                 if p.dtype == torch.bfloat16)
    assert got == want and len(got) == 16
    assert all(p.dtype == torch.float32 for n, p in tm.named_parameters()
               if "norm" in n)
    # the Parameter objects stay: optimizers and graphs hold them
    assert all(params[n] is p for n, p in tm.named_parameters())
    assert topt._multi_precision and jopt._multi_precision
    # O1 changes nothing; a list in, a list out; master_weight=False
    lin = torch.nn.Linear(3, 3)
    assert amp.decorate([lin], level="O1")[0].weight.dtype == torch.float32
    o = SGD(parameters=lin.parameters())
    amp.decorate(lin, o, level="O2", dtype="float16", master_weight=False)
    assert lin.weight.dtype == torch.float16 and not o._multi_precision
    with pytest.raises(ValueError):
        amp.decorate(lin, level="O3")
    with pytest.raises(TypeError):
        amp.decorate(object(), level="O2")


def test_decorate_keeps_torch_norm_layers():
    net = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.LayerNorm(4),
                              torch.nn.BatchNorm1d(4),
                              torch.nn.GroupNorm(2, 4),
                              torch.nn.Linear(4, 2))
    amp.decorate(net, level="O2")
    kept = [n for n, p in net.named_parameters() if p.dtype == torch.float32]
    assert kept == ["1.weight", "1.bias", "2.weight", "2.bias", "3.weight",
                    "3.bias"]


def test_master_weight_comes_from_the_cast_parameter():
    """The reference makes the master weight at the first step from the
    16-bit parameter, not from the f32 value before ``decorate``."""
    lin = torch.nn.Linear(8, 8)
    with torch.no_grad():
        lin.weight.copy_(torch.linspace(-1, 1, 64).reshape(8, 8) / 3)
    opt = SGD(learning_rate=0.0, parameters=lin.parameters())
    amp.decorate(lin, opt, level="O2")
    cast = lin.weight.detach().clone()
    lin(torch.ones(2, 8, dtype=torch.bfloat16)).float().sum().backward()
    opt.step()
    master = opt._accumulators["master_weight"][id(lin.weight)]
    assert master.dtype == torch.float32
    assert torch.equal(master, cast.float())


def _curve_ref(jm, batches):
    opt = paddle.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.1,
                                 parameters=jm.parameters())
    jm, opt = paddle.amp.decorate(jm, opt, level="O2")
    out = []
    for x, y in batches:
        with paddle.amp.auto_cast(level="O2"):
            loss, _ = jm(paddle.to_tensor(x), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss))
    return out, opt


def _curve_port(tm, batches):
    opt = AdamW(learning_rate=1e-3, weight_decay=0.1,
                parameters=tm.named_parameters())
    tm, opt = amp.decorate(tm, opt, level="O2")
    out = []
    for x, y in batches:
        with amp.auto_cast(level="O2"):
            loss, _ = tm(torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(loss.item())
    return out, opt


def test_o2_llama_curve_matches_reference():
    jm, tm = _llama_pair(3)
    batches = [_batch(10 + i) for i in range(5)]
    want, _ = _curve_ref(jm, batches)
    got, opt = _curve_port(tm, batches)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert got[-1] < got[0]
    for n, p in tm.named_parameters():
        master = opt._accumulators["master_weight"].get(id(p))
        if "norm" in n:
            assert p.dtype == torch.float32 and master is None
        else:
            assert p.dtype == torch.bfloat16 and master.dtype == \
                torch.float32
            assert torch.equal(p, master.to(torch.bfloat16)), n


# -- GradScaler ------------------------------------------------------------

def _toy_pair(kind, init, seed=5):
    paddle.seed(seed)
    jm = pnn.Linear(4, 1)
    jo = getattr(paddle.optimizer, kind)(learning_rate=0.05,
                                         parameters=jm.parameters())
    js = paddle.amp.GradScaler(init_loss_scaling=init, incr_every_n_steps=3)
    tm = torch.nn.Linear(4, 1)
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.asarray(jm.weight.numpy()).T))
        tm.bias.copy_(torch.tensor(np.asarray(jm.bias.numpy())))
    to = (SGD if kind == "SGD" else AdamW)(learning_rate=0.05,
                                          parameters=tm.parameters())
    ts = amp.GradScaler(init_loss_scaling=init, incr_every_n_steps=3)
    return (jm, jo, js), (tm, to, ts)


def _toy_inputs():
    rng = np.random.RandomState(0)
    # the third batch overflows the scaled f32 gradients
    return [rng.randn(8, 4).astype(np.float32) * (1e20 if i == 2 else 1)
            for i in range(6)]


def _state(scaler):
    g = scaler._growth
    return (float(scaler.get_loss_scaling()),
            int(np.asarray(g.numpy() if hasattr(g, "numpy") else g)),
            int(np.asarray(scaler._bad.numpy())))


def _weights(m):
    w = m.weight
    return np.asarray(w.numpy()).T if hasattr(w, "_data") \
        else w.detach().numpy()


@pytest.mark.parametrize("kind", ["SGD", "AdamW"])
@pytest.mark.parametrize("compiled", [False, True])
def test_scaler_loop_matches_reference(kind, compiled):
    """Six steps, the third overflowing: eager, both packages skip it
    (the hard skip); compiled (``to_static`` after its eager warm-up,
    the port's capture call included), both mask it, and AdamW's moments
    decay on the masked step in both."""
    (jm, jo, js), (tm, to, ts) = _toy_pair(kind, 256.0)

    def jstep(x):
        loss = (jm(x) ** 2).mean()
        js.scale(loss).backward()
        js.step(jo)
        js.update()
        jo.clear_grad()
        return loss

    def tstep(x):
        loss = (tm(x) ** 2).mean()
        ts.scale(loss).backward()
        ts.step(to)
        ts.update()
        to.clear_grad()
        return loss
    if compiled:
        jstep = paddle.jit.to_static(jstep, state=[jm, jo, js])
        tstep = jit.to_static(tstep, state=[tm, to, ts])
    for i, x in enumerate(_toy_inputs()):
        w0 = _weights(tm).copy()
        lj = float(jstep(paddle.to_tensor(x)))
        lt = tstep(torch.from_numpy(x)).item()
        if i == 2:
            assert lj == lt == float("inf")
            np.testing.assert_array_equal(_weights(tm), w0)
        else:
            np.testing.assert_allclose(lt, lj, rtol=1e-5)
        assert _state(ts) == _state(js), i
        np.testing.assert_allclose(_weights(tm), _weights(jm), rtol=1e-5,
                                   atol=1e-7)
    if kind == "AdamW":
        m1 = to._accumulators["moment1"][id(tm.weight)].numpy()
        jm1 = np.asarray(jo._accumulators["moment1"][id(jm.weight)]._data)
        np.testing.assert_allclose(m1, jm1.T, rtol=1e-5, atol=1e-9)


def test_scaler_calls_one_by_one_over_an_overflow_step():
    """Eager, call by call, against the reference: ``scale`` (the scaled
    loss), ``unscale_`` (the gradients and the flag), ``step`` (skipped:
    parameters bitwise), ``update`` (scale halved, growth and bad reset)."""
    (jm, jo, js), (tm, to, ts) = _toy_pair("SGD", 1e38)
    x = _toy_inputs()[0] * 100
    jl = (jm(paddle.to_tensor(x)) ** 2).mean()
    tl = (tm(torch.from_numpy(x)) ** 2).mean()
    js_l, ts_l = js.scale(jl), ts.scale(tl)
    np.testing.assert_allclose(float(ts_l), float(js_l), rtol=1e-5)
    js_l.backward()
    ts_l.backward()
    js.unscale_(jo)
    ts.unscale_(to)
    assert bool(ts._found_inf) == bool(js._found_inf) is True
    assert ts._found_inf.dtype == torch.bool and ts._found_inf.dim() == 0
    w0 = tm.weight.detach().clone()
    js.step(jo)
    ts.step(to)
    assert torch.equal(tm.weight, w0)
    assert np.isinf(np.asarray(jm.weight.grad.numpy())).any() == \
        bool(torch.isinf(tm.weight.grad).any())     # eager: grads kept
    js.update()
    ts.update()
    assert _state(ts) == _state(js) == (float(np.float32(1e38)) / 2, 0, 0)


def test_masked_step_through_the_capture_predicate():
    """The masked path as it runs under a capture (the predicate forced):
    gradients zeroed by a select, the device lr selected to 0, parameters
    bitwise, the moments decayed, the flag never read on the host; the
    state then equals the reference's compiled overflow step's."""
    (jm, jo, js), (tm, to, ts) = _toy_pair("AdamW", 1e38)
    x = _toy_inputs()[0] * 100

    def jstep(x):
        loss = (jm(x) ** 2).mean()
        js.scale(loss).backward()
        js.step(jo)
        js.update()
        jo.clear_grad()
        return loss
    jf = paddle.jit.to_static(jstep, state=[jm, jo, js])
    js.set_init_loss_scaling(256.0)
    ts.set_init_loss_scaling(256.0)
    jf(paddle.to_tensor(_toy_inputs()[1]))      # the reference's warm-up
    loss = (tm(torch.from_numpy(_toy_inputs()[1])) ** 2).mean()
    ts.scale(loss).backward()
    ts.step(to)
    ts.update()
    to.clear_grad()
    js.set_init_loss_scaling(1e38)
    ts.set_init_loss_scaling(1e38)
    m1 = to._accumulators["moment1"][id(tm.weight)].clone()
    w0 = tm.weight.detach().clone()
    reads = []
    orig_bool = torch.Tensor.__bool__

    def spy_bool(t):
        reads.append(t)
        return orig_bool(t)
    saved = GS._masked
    GS._masked = lambda device: True
    torch.Tensor.__bool__ = spy_bool
    try:
        loss = (tm(torch.from_numpy(x)) ** 2).mean()
        ts.scale(loss).backward()
        ts.unscale_(to)
        ts.step(to)
        assert torch.equal(tm.weight.grad, torch.zeros_like(tm.weight))
        ts.update()
        to.clear_grad()
    finally:
        torch.Tensor.__bool__ = orig_bool
        GS._masked = saved
    assert not reads
    assert to._lr_mask is None
    assert torch.equal(tm.weight, w0)
    m1_after = to._accumulators["moment1"][id(tm.weight)]
    assert torch.equal(m1_after, m1 * 0.9)        # beta1 decay, zero grad
    jf(paddle.to_tensor(x))                       # the reference, masked
    assert _state(ts) == _state(js)
    np.testing.assert_allclose(m1_after.numpy(), np.asarray(
        jo._accumulators["moment1"][id(jm.weight)]._data).T, rtol=1e-6)


def test_capture_call_step_is_masked():
    """The port's ``to_static`` runs one real step at its capture call (on
    the CPU: every call after the warm-up): that step takes the masked
    path, as the reference's first compiled call does, and the counters
    read nothing there."""
    (_, _, _), (tm, to, ts) = _toy_pair("SGD", 1e38)
    x = torch.from_numpy(_toy_inputs()[0] * 100)
    seen = []

    def step(x):
        loss = (tm(x) ** 2).mean()
        ts.scale(loss).backward()
        seen.append(GS._masked(x.device))
        ts.step(to)
        ts.update()
        to.clear_grad()
        return loss
    f = jit.to_static(step, state=[tm, to, ts])
    assert not jit.in_compiled_step()
    for _ in range(3):
        f(x)
    assert seen == [False, True, True]
    assert _state(ts) == (float(np.float32(1e38)) / 8, 0, 0)


def test_counters_count_eager_overflows_only():
    if not om.enabled():
        pytest.skip("metrics are off in this environment")
    (_, _, _), (tm, to, ts) = _toy_pair("SGD", 1e38)
    fam = om.default_registry().get("amp_found_inf_total")
    back = om.default_registry().get("amp_scale_backoff_total")
    f0, b0 = fam.value, back.value
    x = torch.from_numpy(_toy_inputs()[0] * 100)

    def step(x):
        loss = (tm(x) ** 2).mean()
        ts.scale(loss).backward()
        ts.step(to)
        ts.update()
        to.clear_grad()
        return loss
    step(x)
    assert (fam.value - f0, back.value - b0) == (1, 1)
    f = jit.to_static(step, state=[tm, to, ts])
    f(x)                                  # eager warm-up: counted
    f(x)                                  # compiled: masked, not read
    assert (fam.value - f0, back.value - b0) == (2, 2)


def test_scaler_api_and_state_dict():
    s = amp.GradScaler(init_loss_scaling=64.0)
    held = s.get_loss_scaling()
    s.set_init_loss_scaling(32.0)
    assert s.get_loss_scaling() is held and float(held) == 32.0
    state = s.state_dict()
    r = paddle.amp.GradScaler(init_loss_scaling=32.0)
    want = r.state_dict()
    assert set(state) == set(want)
    for k in state:
        np.testing.assert_array_equal(np.asarray(state[k]),
                                      np.asarray(want[k]))
    s2 = amp.GradScaler()
    keep = s2.__state_tensors__()
    s2.load_state_dict(state)
    assert float(s2.get_loss_scaling()) == 32.0
    assert [a is b for a, b in zip(keep, s2.__state_tensors__())] == [True] * 3
    off = amp.GradScaler(enable=False)
    loss = torch.tensor(2.0)
    assert off.scale(loss) is loss and off.state_dict() == {}
    assert not off.is_use_dynamic_loss_scaling() and s.is_enable()
    assert amp.AmpScaler is amp.GradScaler and amp.amp_guard is amp.auto_cast
    assert amp.amp_decorate is amp.decorate


def test_supported_flags(monkeypatch):
    """bf16 is supported everywhere; float16 where a card is present. The
    reference answers float16 for its TPU backend: False here, as the
    port on the CPU; on the card the port says True (stated
    difference)."""
    assert amp.is_bfloat16_supported() is paddle.amp.is_bfloat16_supported()
    assert amp.is_float16_supported() is False
    assert paddle.amp.is_float16_supported() is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert amp.is_float16_supported() is True


def test_float16_o2_step_with_the_scaler():
    """float16 O2 on the CPU: f16 parameters, f32 masters, one scaled step
    that lands, one that overflows (parameters bitwise, scale halved)."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.LayerNorm(16),
                              torch.nn.Linear(16, 4))
    opt = AdamW(learning_rate=1e-2, parameters=net.parameters())
    amp.decorate(net, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 16)
    x = torch.randn(4, 8)

    def step():
        with amp.auto_cast(level="O2", dtype="float16"):
            loss = net(x).float().pow(2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss.item()
    w0 = net[0].weight.detach().clone()
    step()
    assert not torch.equal(net[0].weight, w0)
    assert net[0].weight.dtype == torch.float16
    scaler.set_init_loss_scaling(2.0 ** 126)     # past f16's range
    w1 = net[0].weight.detach().clone()
    step()
    assert torch.equal(net[0].weight, w1)
    assert float(scaler.get_loss_scaling()) == 2.0 ** 125
