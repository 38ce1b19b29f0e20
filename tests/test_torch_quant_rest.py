"""The rest of the port's weight quantization against the reference
package: QAT / PTQ (``paddle_tpu_torch.quantization``: fake quant and its
straight-through gradient, ``convert``'s int8 values and scales), the
bridge to the serving format, quantized checkpoints across packages, the
quality gate and ``fit_on_prompts``.

Inputs are seeded numpy arrays; weights are drawn by the reference and
carried across by ``load_numpy_state`` (``[in, out]`` to ``torch.nn
.Linear``'s ``[out, in]``). Tolerances: int8 values, scales, bridged and
checkpointed tensors bitwise; fake-quant outputs and gradients of one
layer within 1e-6 of the tensor's largest value (the same grid values,
other sum orders); a two-layer stack within 1e-5; ``logits_quality``'s
errors within 1e-5 with ``greedy_match`` and ``passes`` equal;
``fit_on_prompts``' loss after 5 steps within 1e-4.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import quantization as jqz
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.quant import bridge as jbridge
from paddle_tpu.quant import checkpoint as jckpt
from paddle_tpu.quant import quality as jquality
from paddle_tpu.quant import quantize_model as jquantize

import paddle_tpu_torch.quant as tquant
from paddle_tpu_torch import quantization as tqz
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.quant import bridge as tbridge
from paddle_tpu_torch.quant import checkpoint as tckpt
from paddle_tpu_torch.quant import quality as tquality
from paddle_tpu_torch.quant.format import dequantize_weight

torch.set_num_threads(1)

DIMS = (16, 32, 8)


def _arrays(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _stacks(seed=0, bias=True):
    """A two-layer linear stack in each package, the same weights."""
    paddle.seed(seed)
    jm = paddle.nn.Sequential(
        paddle.nn.Linear(DIMS[0], DIMS[1], bias_attr=None if bias else False),
        paddle.nn.Linear(DIMS[1], DIMS[2], bias_attr=None if bias else False))
    rng = np.random.RandomState(seed)
    for p in jm.parameters():          # nonzero biases too
        p.set_value(paddle.to_tensor(
            rng.randn(*p.shape).astype(np.float32) * 0.3))
    tm = torch.nn.Sequential(torch.nn.Linear(DIMS[0], DIMS[1], bias=bias),
                             torch.nn.Linear(DIMS[1], DIMS[2], bias=bias))
    return jm, load_numpy_state(tm, _arrays(jm))


def _x(n=6, seed=1):
    return np.random.RandomState(seed).randn(n, DIMS[0]).astype(np.float32)


def _near(got, want, rel):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def test_quant_dequant_and_its_straight_through_gradient():
    x = _x(5, 3) * 3
    cot = _x(5, 4)
    for bits, scale in ((8, 2.5), (4, 1.0), (8, 0.0)):
        jx = paddle.to_tensor(x, stop_gradient=False)
        jy = jqz.quant_dequant(jx, paddle.to_tensor(np.float32(scale)),
                               bits)
        (jy * paddle.to_tensor(cot)).sum().backward()
        tx = torch.from_numpy(x).requires_grad_()
        ty = tqz.quant_dequant(tx, torch.tensor(scale), bits)
        (ty * torch.from_numpy(cot)).sum().backward()
        assert np.array_equal(ty.detach().numpy(), jy.numpy()), bits
        assert np.array_equal(tx.grad.numpy(), cot)
        assert np.array_equal(jx.grad.numpy(), cot)


def test_qat_forward_and_gradients_match_reference():
    jm, tm = _stacks()
    cfg_j, cfg_t = jqz.QuantConfig(), tqz.QuantConfig()
    jq = jqz.QAT(cfg_j).quantize(jm)
    tq = tqz.QAT(cfg_t).quantize(tm)
    assert [type(m).__name__ for m in tq] == ["QuantedLinear"] * 2
    assert isinstance(tm[0], torch.nn.Linear)       # not in place
    x = _x()
    # one layer: the fake-quantized operands are the same grid values
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = jq[0](jx)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tq[0](tx)
    _near(ty.detach().numpy(), jy.numpy(), 1e-6)
    c1 = np.random.RandomState(5).randn(6, DIMS[1]).astype(np.float32)
    (jy * paddle.to_tensor(c1)).sum().backward()
    (ty * torch.from_numpy(c1)).sum().backward()
    _near(tx.grad.numpy(), jx.grad.numpy(), 1e-6)
    _near(tq[0].weight.grad.numpy().T, jq[0].weight.grad.numpy(), 1e-6)
    _near(tq[0].bias.grad.numpy(), jq[0].bias.grad.numpy(), 1e-6)
    # the stack
    _near(tq(torch.from_numpy(x)).detach().numpy(),
          jq(paddle.to_tensor(x)).numpy(), 1e-5)


def _converted_equal(tc, jc):
    assert isinstance(tc, tqz.ConvertedLinear)
    assert np.array_equal(tc.weight_int8.numpy(), jc.weight_int8.numpy())
    assert tc.weight_int8.dtype == torch.int8
    assert np.array_equal(tc.weight_scale.numpy(),
                          np.asarray(jc.weight_scale.numpy(), np.float32))
    if jc.act_scale is None:
        assert tc.act_scale is None
    else:
        assert float(tc.act_scale) == float(jc.act_scale.numpy())


def test_qat_convert_is_bitwise_the_reference():
    jm, tm = _stacks(seed=3)
    jc = jqz.QAT(jqz.QuantConfig()).convert(
        jqz.QAT(jqz.QuantConfig()).quantize(jm))
    tc = tqz.QAT(tqz.QuantConfig()).convert(
        tqz.QAT(tqz.QuantConfig()).quantize(tm))
    for a, b in zip(tc, jc):
        _converted_equal(a, b)
    x = _x(7, 8)
    _near(tc(torch.from_numpy(x)).detach().numpy(),
          jc(paddle.to_tensor(x)).numpy(), 1e-5)
    # a zero weight takes scale 1.0, as the reference's
    zero = torch.nn.Linear(4, 3, bias=False)
    torch.nn.init.zeros_(zero.weight)
    (zc,) = tqz.QAT(tqz.QuantConfig()).convert(torch.nn.Sequential(zero))
    assert float(zc.weight_scale) == 1.0


def test_ptq_calibrates_and_converts_as_the_reference():
    jm, tm = _stacks(seed=4)
    jptq, tptq = jqz.PTQ(), tqz.PTQ()
    jcal, tcal = jptq.quantize(jm), tptq.quantize(tm)
    for s in (11, 12, 13):
        x = _x(4, s) * (s - 10)
        jcal(paddle.to_tensor(x))
        tcal(torch.from_numpy(x))
    assert sorted(tptq._observers) == sorted(jptq._observers) == ["0", "1"]
    for name in jptq._observers:
        assert tptq._observers[name].scale() \
            == pytest.approx(jptq._observers[name].scale(), rel=1e-6)
    jc, tc = jptq.convert(jcal), tptq.convert(tcal)
    for a, b in zip(tc, jc):
        assert np.array_equal(a.weight_int8.numpy(), b.weight_int8.numpy())
        assert float(a.act_scale) == pytest.approx(float(b.act_scale.numpy()),
                                                   rel=1e-6)
    x = _x(6, 20)
    _near(tc(torch.from_numpy(x)).detach().numpy(),
          jc(paddle.to_tensor(x)).numpy(), 1e-5)


def test_add_type_config_and_weight_only_ops():
    cfg = tqz.QuantConfig()

    class Sub(torch.nn.Linear):
        pass

    act = tqz.FakeQuanterWithAbsMax(4)
    cfg.add_type_config(Sub, activation=act)
    assert cfg.quanters_for(Sub(2, 2))[0] is act
    assert cfg.quanters_for(torch.nn.Linear(2, 2))[0] is cfg.activation
    with pytest.raises(NotImplementedError):
        cfg.add_type_config(torch.nn.Conv2d)
    w = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    w[:, 3] = 0.0
    jqw, jsc = jqz.weight_quantize(paddle.to_tensor(w))
    tqw, tsc = tqz.weight_quantize(torch.from_numpy(w))
    assert np.array_equal(tqw.numpy(), jqw.numpy())
    assert np.array_equal(tsc.numpy(), jsc.numpy())
    assert np.array_equal(
        tqz.weight_dequantize(tqw, tsc).numpy(),
        jqz.weight_dequantize(jqw, jsc).numpy())
    x = _x(3, 9)
    b = np.arange(8, dtype=np.float32)
    for name in ("weight_only_linear", "llm_int8_linear"):
        want = getattr(jqz, name)(paddle.to_tensor(x), jqw,
                                  paddle.to_tensor(b), jsc).numpy()
        got = getattr(tqz, name)(torch.from_numpy(x), tqw,
                                 torch.from_numpy(b), tsc).numpy()
        _near(got, want, 1e-6)
    with pytest.raises(ValueError):
        tqz.weight_quantize(torch.ones(2, 2), algo="int4")


@pytest.mark.parametrize("block", [None, 4, 7])
def test_bridge_is_bitwise_and_strict_refuses(block):
    jm, tm = _stacks(seed=6)
    jc = jqz.QAT(jqz.QuantConfig()).convert(jm)
    tc = tqz.QAT(tqz.QuantConfig()).convert(tm)
    src = [(c.weight_int8.float() * (c.weight_scale / 127.0)).numpy()
           for c in tc]
    assert tbridge.bridge_model(tc, block=block) == 2
    assert jbridge.bridge_model(jc, block=block) == 2
    for i, (t, j) in enumerate(zip(tc, jc)):
        assert type(t).__name__ == "WeightOnlyLinear"
        assert t.weight_block == j.weight_block
        assert np.array_equal(t.weight_int8.numpy(), j.weight_int8.numpy())
        assert np.array_equal(t.weight_scale.numpy(), j.weight_scale.numpy())
        deq = dequantize_weight(t.weight_int8, t.weight_scale,
                                t.weight_block).numpy()
        assert np.array_equal(deq, src[i])       # bitwise the source's
    x = _x(5, 2)
    _near(tc(torch.from_numpy(x)).detach().numpy(),
          jc(paddle.to_tensor(x)).numpy(), 1e-5)
    # PTQ's activation scale: strict refuses, strict=False drops it
    ptq = tqz.PTQ()
    cal = ptq.quantize(tm)
    cal(torch.from_numpy(x))
    conv = ptq.convert(cal)
    with pytest.raises(ValueError, match="act_scale"):
        tbridge.bridge_linear(conv[0])
    assert tbridge.bridge_linear(conv[0], strict=False).weight_block \
        == tquant.effective_block(DIMS[0], None)
    with pytest.raises(TypeError):
        tbridge.bridge_linear(torch.nn.Linear(2, 2))


def _tiny_pair(seed=0, fit=0):
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny())
    if fit:
        jquality.fit_on_prompts(jm, steps=fit)
    jm.eval()
    tm = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    return jm, load_numpy_state(tm, _arrays(jm))


def _states_equal(tm, jm):
    want = _arrays(jm)
    linear = {n + ".weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        a = v.numpy().T if k in linear else v.numpy()
        assert a.dtype == want[k].dtype and np.array_equal(a, want[k]), k


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_quantized_checkpoint_loads_in_the_other_package(tmp_path, writer):
    jm, tm = _tiny_pair(seed=2)
    if writer == "port":
        d = tckpt.save_quantized(tm, str(tmp_path), step=3, block=32)
        jfresh = JaxLlama(jax_tiny())
        assert jckpt.load_quantized(jfresh, str(tmp_path)) == 3
        _states_equal(tm, jfresh)
    else:
        d = jckpt.save_quantized(jm, str(tmp_path), step=3, block=32)
        tfresh = LlamaForCausalLM(tiny_llama_config(), device="cpu")
        assert tckpt.load_quantized(tfresh, str(tmp_path)) == 3
        _states_equal(tfresh, jm)
        assert tquant.model_weight_block(tfresh) == 32
    name = str(d).rstrip("/").rsplit("/", 1)[-1]
    assert name.startswith("step_") and int(name[5:]) == 3


def test_quantized_checkpoint_roundtrip_and_block_mismatch(tmp_path):
    _, tm = _tiny_pair(seed=3)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (1, 9)))
    tckpt.save_quantized(tm, str(tmp_path / "a"), block=16)
    back = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    assert tckpt.load_quantized(back, str(tmp_path / "a")) == 0
    with torch.no_grad():
        assert torch.equal(back(ids), tm(ids))
    assert tckpt.load_quantized(LlamaForCausalLM(
        tiny_llama_config(), device="cpu"), str(tmp_path / "none")) is None
    # a model quantized at another block cannot take the sidecars: both
    # packages raise the same type
    jm, _ = _tiny_pair(seed=3)
    jquantize(jm, block=8)
    with pytest.raises(Exception) as want:
        jckpt.load_quantized(jm, str(tmp_path / "a"))
    other = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    tquant.quantize_model(other, block=8)
    with pytest.raises(Exception) as got:
        tckpt.load_quantized(other, str(tmp_path / "a"))
    assert type(got.value) is type(want.value)


def test_logits_quality_matches_reference():
    jm, tm = _tiny_pair(seed=5, fit=20)
    jq = JaxLlama(jax_tiny())
    jq.set_state_dict(jm.state_dict())
    jq.eval()
    tq = load_numpy_state(LlamaForCausalLM(tiny_llama_config(),
                                           device="cpu"), _arrays(jm))
    jquantize(jq, block=16)
    tquant.quantize_model(tq, block=16)
    want = jquality.logits_quality(jm, jq)
    got = tquality.logits_quality(tm, tq)
    assert set(got) == set(want)
    for k in ("max_err", "mean_err", "ref_scale"):
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k
    for k in ("greedy_match", "positions", "passes"):
        assert got[k] == want[k], k
    assert got["passes"] and got["positions"] == sum(
        len(p) for p in tquality.bundled_prompts())
    from paddle_tpu_torch.observability import metrics as om
    assert om.gauge("quant_greedy_match_rate", "").value \
        == got["greedy_match"]
    assert tquality.bundled_prompt_ids(100)[0][0] == ord("T") % 100
    assert tquality.bundled_prompts() == jquality.bundled_prompts()


def test_fit_on_prompts_matches_reference():
    jm, tm = _tiny_pair(seed=7)
    want = jquality.fit_on_prompts(jm, steps=5)
    got = tquality.fit_on_prompts(tm, steps=5)
    assert abs(got - want) <= 1e-4
    assert np.isnan(tquality.fit_on_prompts(tm, steps=0))


def test_quant_package_exports_the_reference_names():
    from paddle_tpu import quant as jquant
    renamed = {"dequant_matmul_xla": "dequant_matmul_ref"}
    for name in jquant.__all__:
        assert renamed.get(name, name) in tquant.__all__, name
        assert hasattr(tquant, renamed.get(name, name)), name
    assert tquant.quality is tquality
