"""The port's ``MoELayer``, gates and ``top_k_gating`` against the
reference package's ``incubate/moe``, and the compile watch of the MoE
forwards (``moe_layer``, ``moe_mlp``).

Inputs are seeded numpy arrays, weights drawn by the reference and
carried across by ``load_numpy_state``. Tolerances: dispatch masks,
dropped counts and compile accounting exact; combine weights within 1e-6
relative; outputs, ``l_aux`` and the gradient of every parameter and of
the input within rtol 1e-5 (and 1e-6 of the tensor's largest value, for
entries that cancel to near zero).

The reference's ``watched_jit`` asks ``jax.core.trace_state_clean``
whether it runs inside an outer trace; the installed JAX has no such
function, so there every call counts as traced and nothing is counted.
The accounting tests give the reference the answer a trace-free call
has (``_in_outer_trace() -> False``) and compare the eager, no-grad
calls its counting covers.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import moe as jmoe
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.observability import compile_watch as jcw
from paddle_tpu.observability import metrics as jom

import paddle_tpu_torch.incubate as tincubate
from paddle_tpu_torch.incubate import moe as tmoe
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.observability import compile_watch as tcw
from paddle_tpu_torch.observability import metrics as tom

torch.set_num_threads(1)

D, H, E = 16, 32, 4


@pytest.fixture(autouse=True)
def _fresh_watches(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_METRICS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_RECOMPILE_STORM_SIGS", raising=False)
    jcw.reset()
    tcw.reset()
    yield
    jcw.reset()
    tcw.reset()


@pytest.mark.parametrize("n,e,k,capacity,normalize", [
    (13, 4, 2, 13, True),       # ample capacity
    (13, 4, 2, 4, True),        # drops
    (9, 8, 1, 2, False),        # switch
    (16, 4, 3, 5, True),
    (1, 4, 2, 1, True)])
def test_top_k_gating_matches_reference(n, e, k, capacity, normalize):
    logits = np.random.RandomState(n + e).randn(n, e).astype(np.float32)
    logits[0, :2] = 0.5         # a tie: the lower expert first
    want = jmoe.top_k_gating(paddle.to_tensor(logits)._data, k, capacity,
                             normalize)
    got = tmoe.top_k_gating(torch.from_numpy(logits), k, capacity,
                            normalize)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


def test_gates_match_reference():
    for name in ("naive", "gshard", "switch"):
        jg, tg = jmoe._GATES[name](), tmoe._GATES[name]()
        assert (tg.top_k, tg.normalize) == (jg.top_k, jg.normalize), name
        assert type(tg).__name__ == type(jg).__name__
        assert tmoe._GATES[name](3).top_k == 3
    own = tmoe.SwitchGate()
    layer = tmoe.MoELayer(D, H, E, gate=own, top_k=2, device="cpu")
    assert own.top_k == 1 and layer.gate.top_k == 2
    assert layer.gate.normalize is False     # carried from the instance


def _pair(gate, mode, cf, seed=7):
    paddle.seed(seed)
    jm = jmoe.MoELayer(D, H, E, gate=gate, capacity_factor=cf,
                       dispatch_mode=mode)
    tm = tmoe.MoELayer(D, H, E, gate=gate, capacity_factor=cf,
                       dispatch_mode=mode, device="cpu")
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    return jm, load_numpy_state(tm, arrays)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6 * max(float(np.abs(want).max()),
                                              1e-30))


@pytest.mark.parametrize("mode", ["ragged", "dense"])
@pytest.mark.parametrize("gate,cf", [("gshard", 1.25), ("gshard", 0.5),
                                     ("switch", 1.0), ("naive", 2.0)])
def test_moe_layer_forward_and_grads_match_reference(gate, cf, mode):
    jm, tm = _pair(gate, mode, cf)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 12, D).astype(np.float32)
    cot = rng.randn(2, 12, D).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jm(jx)
    (jout * paddle.to_tensor(cot)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tm(tx)
    (tout * torch.from_numpy(cot)).sum().backward()
    _close(tout.detach().numpy(), jout.numpy())
    _close(float(tm.l_aux), float(jm.l_aux))
    _close(tx.grad.numpy(), jx.grad.numpy())
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), jparams[name].grad.numpy())
    # the dropped count (the reference returns it from the same fn)
    _, _, want_dropped = jm.build_fn(24)(
        x.reshape(24, D), *(np.asarray(v._data) for v in (
            jm.gate_weight, jm.w1, jm.b1, jm.w2, jm.b2)))
    assert int(tm.dropped) == int(np.asarray(want_dropped))


def test_ragged_equals_dense_in_the_port():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(24, D).astype(np.float32))
    outs = []
    for mode in ("ragged", "dense"):
        _, tm = _pair("gshard", mode, 0.75, seed=2)
        outs.append((tm(x), int(tm.dropped)))
    _close(outs[0][0].detach().numpy(), outs[1][0].detach().numpy())
    assert outs[0][1] == outs[1][1] > 0


def test_mesh_raises_naming_item_13():
    """Expert parallelism (item 13) is ported: ``mesh=`` takes a
    ``ProcessMesh`` (``tests/test_torch_distributed.py`` runs it) and
    refuses anything else."""
    with pytest.raises(TypeError, match="ProcessMesh"):
        tmoe.MoELayer(D, H, E, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="dispatch_mode"):
        tmoe.MoELayer(D, H, E, dispatch_mode="sparse", device="cpu")


def test_incubate_exports_moe():
    assert tincubate.moe is tmoe and tincubate.__all__ == ["nn", "moe"]
    assert set(jmoe.__all__) <= set(tmoe.__all__)


def _compiles(om, name):
    return om.counter("paddle_tpu_xla_compile_total", "",
                      labelnames=("callable",)).labels(name).value


def _storms(om, name):
    return om.counter("paddle_tpu_xla_recompile_storm_total", "",
                      labelnames=("callable",)).labels(name).value


# token counts: 11 distinct (past the LRU of 8 and the storm threshold of
# 8), repeats that hit the cache, and evicted counts coming back
_SEQUENCE = (3, 3, 5, 1, 2, 4, 6, 7, 8, 9, 10, 11, 9, 3, 5, 11, 1)


def test_moe_layer_compile_accounting_matches_reference(monkeypatch):
    monkeypatch.setattr(jcw, "_in_outer_trace", lambda: False)
    jm, tm = _pair("switch", "ragged", 1.25, seed=9)
    c0 = (_compiles(jom, "moe_layer"), _compiles(tom, "moe_layer"))
    s0 = (_storms(jom, "moe_layer"), _storms(tom, "moe_layer"))
    got, want = [], []
    for n in _SEQUENCE:
        x = np.random.RandomState(n).randn(n, D).astype(np.float32)
        with paddle.no_grad():
            jm(paddle.to_tensor(x))
        with torch.no_grad():
            tm(torch.from_numpy(x))
        want.append((_compiles(jom, "moe_layer") - c0[0], list(jm._fns)))
        got.append((_compiles(tom, "moe_layer") - c0[1], list(tm._fns)))
    assert got == want
    assert len(tm._fns) == tmoe.MoELayer.FN_CACHE_SIZE
    jw, tw = jcw.watch("moe_layer"), tcw.watch("moe_layer")
    assert len(tw._sigs) == len(jw._sigs) == 11
    assert _storms(tom, "moe_layer") - s0[1] \
        == _storms(jom, "moe_layer") - s0[0] == 3
    assert tw.last_diagnosis == jw.last_diagnosis
    assert "arg0 churns 11 variants" in tw.last_diagnosis
    assert all(getattr(f, "_watch_name", None) == "moe_layer"
               for f in tm._fns.values())


def test_moe_mlp_compile_accounting_matches_reference(monkeypatch):
    monkeypatch.setattr(jcw, "_in_outer_trace", lambda: False)
    monkeypatch.setenv("PADDLE_TPU_RECOMPILE_STORM_SIGS", "3")
    cfg = dict(moe_num_experts=4, moe_top_k=2, num_hidden_layers=1)
    paddle.seed(1)
    jm = JaxLlama(jax_tiny(**cfg))
    tm = load_numpy_state(
        LlamaForCausalLM(tiny_llama_config(**cfg), device="cpu"),
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    jmlp, tmlp = jm.model.layers[0].mlp, tm.model.layers[0].mlp
    before = (_compiles(jom, "moe_mlp"), _compiles(tom, "moe_mlp"))
    hidden = jm.config.hidden_size
    for n in (1, 5, 5, 2, 7, 1):
        x = np.random.RandomState(n).randn(n, hidden).astype(np.float32)
        with paddle.no_grad():
            want = jmlp(paddle.to_tensor(x)).numpy()
        with torch.no_grad():
            got = tmlp(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert list(tmlp._fns) == list(jmlp._fns)
        assert _compiles(tom, "moe_mlp") - before[1] \
            == _compiles(jom, "moe_mlp") - before[0]
    jw, tw = jcw.watch("moe_mlp"), tcw.watch("moe_mlp")
    assert len(tw._sigs) == len(jw._sigs) == 4
    assert tw.last_diagnosis == jw.last_diagnosis
    assert "arg0 churns 4 variants" in tw.last_diagnosis


def test_compile_not_counted_in_a_compiled_step(monkeypatch):
    """A call inside a compiled step is the outer program's (its capture
    is counted as itself), as a call inside the reference's outer trace;
    and the dropped-token metrics read nothing to the host there."""
    from paddle_tpu_torch import jit
    _, tm = _pair("gshard", "ragged", 0.5, seed=4)
    x = torch.from_numpy(np.random.RandomState(0).randn(8, D)
                         .astype(np.float32))
    drops = tom.counter("moe_dropped_tokens_total", "")
    c0, d0 = _compiles(tom, "moe_layer"), drops.value
    monkeypatch.setattr(jit, "in_compiled_step", lambda: True)
    with torch.no_grad():
        tm(x)
    assert (_compiles(tom, "moe_layer"), drops.value) == (c0, d0)
    monkeypatch.undo()
    with torch.no_grad():
        tm(x)
    assert _compiles(tom, "moe_layer") == c0 + 1
    assert drops.value == d0 + int(tm.dropped) and int(tm.dropped) > 0
    frac = tom.gauge("moe_drop_fraction", "").value
    assert frac == int(tm.dropped) / (8 * tm.gate.top_k)


def test_metrics_off_counts_nothing(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
    _, tm = _pair("switch", "dense", 0.25, seed=12)
    out = tm(torch.from_numpy(np.random.RandomState(3).randn(32, D)
                              .astype(np.float32)))
    assert tuple(out.shape) == (32, D) and int(tm.dropped) > 0
    assert tcw.watch("moe_layer") is tcw.NULL_WATCH


def test_watched_jit_static_args_and_describe_args():
    calls = []

    def f(x, k):
        calls.append(k)
        return x * k

    wf = tcw.watched_jit(f, name="unit.static", static_argnums=(1,))
    c0 = _compiles(tom, "unit.static")
    for k in (2, 2, 3):
        wf(torch.ones(2), k)
    assert _compiles(tom, "unit.static") == c0 + 2 and calls == [2, 2, 3]
    want = jcw.describe_args((np.ones((4, 8), np.float32), 1.5, "s"))
    got = tcw.describe_args((torch.ones(4, 8), 1.5, "s"))
    assert got[1:] == want[1:]


def test_grouped_gemms_see_the_reference_dtypes_under_o1(monkeypatch):
    """Under O1 (bf16 ``auto_cast``) the MoE FFN is on neither AMP list
    in either package: each of its three grouped GEMMs takes the f32
    norm output and the f32 expert weights, forward and backward."""
    from paddle_tpu.ops import grouped_gemm as jgg
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import grouped_gemm as tgg
    seen = {"ref": [], "port": []}
    jorig, torig = jgg._grouped, tgg._grouped

    def jspy(x, w, gs, **kw):
        seen["ref"].append((str(x.dtype), str(w.dtype)))
        return jorig(x, w, gs, **kw)

    def tspy(x, w, gs):
        seen["port"].append((str(x.dtype).replace("torch.", ""),
                             str(w.dtype).replace("torch.", "")))
        return torig(x, w, gs)
    monkeypatch.setattr(jgg, "_grouped", jspy)
    monkeypatch.setattr(tgg, "_grouped", tspy)
    cfg = dict(moe_num_experts=4, moe_top_k=2, num_hidden_layers=1)
    paddle.seed(3)
    jm = JaxLlama(jax_tiny(**cfg))
    tm = load_numpy_state(
        LlamaForCausalLM(tiny_llama_config(**cfg), device="cpu"),
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(0).randint(0, 128, (2, 9))
    with paddle.amp.auto_cast(dtype="bfloat16"):
        loss, _ = jm(paddle.to_tensor(ids[:, :-1]),
                     paddle.to_tensor(ids[:, 1:]))
    loss.backward()
    with amp.auto_cast(dtype="bfloat16"):
        tloss, _ = tm(torch.from_numpy(ids[:, :-1]),
                      torch.from_numpy(ids[:, 1:]))
    tloss.backward()
    assert set(seen["ref"]) == {("float32", "float32")}
    # three forward products, then dx of each through the same kernel
    assert seen["port"] == [("float32", "float32")] * 6
