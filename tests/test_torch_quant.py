"""The port's weight-only int8 quantization against the reference
package (``paddle_tpu/quant``): the format bit for bit, the dequant
matmul's plain version against ``dequant_matmul_xla`` and the Pallas
kernel in interpret mode, ``WeightOnlyLinear``, ``quantize_model`` on a
Llama model with a mixture-of-experts FFN, the byte accounting, and the
f32 scales surviving a bf16 cast.

Inputs are seeded numpy arrays handed to both. Tolerances: quantized
values and scales exact; f32 products within 1e-5 (other sum orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.quant import WeightOnlyLinear as JaxWOL
from paddle_tpu.quant import format as JF
from paddle_tpu.quant.kernels import _dequant_matmul, dequant_matmul_xla

from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.quant import (WeightOnlyLinear, dequant_matmul,
                                    dequantize_weight, is_quantized,
                                    model_weight_block, quantize_model,
                                    quantize_weight, serving_weight_bytes)
from paddle_tpu_torch.quant import kernels as QK

TOL = dict(rtol=1e-5, atol=1e-5)


def _weight(shape, seed=0, zero_rows=0):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    w[..., :zero_rows, :] = 0.0
    return w


@pytest.mark.parametrize("shape,block,zero_rows", [
    ((64, 48), 32, 0),
    ((100, 24), 32, 0),          # ragged last block
    ((3, 64, 16), 16, 0),        # stacked experts
    ((64, 48), 32, 32),          # an all-zero block: scale 0
    ((20, 8), 128, 0)])          # block clamped to K
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_is_bitwise(shape, block, zero_rows, dtype):
    w = _weight(shape, zero_rows=zero_rows)
    wt = torch.from_numpy(w).to(getattr(torch, dtype))
    wj = jnp.asarray(wt.float().numpy()).astype(getattr(jnp, dtype))
    q, s = quantize_weight(wt, block)
    qj, sj = JF.quantize_weight(wj, block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(s.numpy(), np.asarray(sj))
    if zero_rows:
        assert not s[0].any() and not q[:zero_rows].any()
    assert np.array_equal(dequantize_weight(q, s, block).numpy(),
                          np.asarray(JF.dequantize_weight(qj, sj, block)))


@pytest.mark.parametrize("lead,k,n,block", [
    ((5,), 64, 48, 32), ((2, 3), 128, 16, 64), ((7,), 96, 24, 32),
    ((5,), 100, 24, 32),         # K % B != 0: a ragged last block
    # the general instance's points: B 8, 24 and 40, N 24, K 40, and K
    # or N off multiples of 8
    ((5,), 96, 64, 24), ((3,), 40, 64, 8), ((4,), 120, 24, 40),
    ((6,), 37, 29, 16), ((2, 3), 44, 20, 12), ((3,), 40, 24, 128)])
def test_dequant_matmul_matches_reference(lead, k, n, block):
    rng = np.random.RandomState(k + n)
    x = rng.randn(*lead, k).astype(np.float32)
    q, s = (np.array(a) for a in JF.quantize_weight(
        jnp.asarray(_weight((k, n), seed=1)), block))
    before = QK.launches
    got = dequant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                         torch.from_numpy(s), block).numpy()
    assert QK.launches == before                 # the CPU runs no kernel
    assert got.shape == lead + (n,)
    want = np.asarray(dequant_matmul_xla(x, q, s, block).numpy())
    np.testing.assert_allclose(got, want, **TOL)
    if k % block == 0 and k % 8 == 0 and n % 8 == 0:
        pallas = np.asarray(_dequant_matmul(
            jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), block,
            use_kernel=True))
        np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("k,n,block,dtype", [
    (96, 64, 24, torch.float16), (40, 64, 8, torch.bfloat16),
    (120, 24, 40, torch.float32), (37, 29, 16, torch.bfloat16)])
def test_dequant_matmul_f16_and_odd_shapes_match_reference(k, n, block,
                                                          dtype):
    """16-bit x (the kernels read f16 and bf16 as they are) at points of
    the general instance: the plain version against the reference's
    formulation fed the same 16-bit x. Both sum in f32 in other orders
    and round to x's dtype: within 1 ulp of it."""
    rng = np.random.RandomState(k + n)
    x = torch.from_numpy(rng.randn(4, k).astype(np.float32)).to(dtype)
    q, s = (np.array(a) for a in JF.quantize_weight(
        jnp.asarray(_weight((k, n), seed=2)), block))
    got = dequant_matmul(x, torch.from_numpy(q), torch.from_numpy(s),
                         block).float().numpy()
    xj = jnp.asarray(x.float().numpy()).astype(
        jnp.float16 if dtype == torch.float16 else
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(dequant_matmul_xla(xj, q, s, block).numpy()) \
        .astype(np.float32)
    ulp = {torch.float16: 2 ** -10, torch.bfloat16: 2 ** -7,
           torch.float32: 1e-5}[dtype]
    np.testing.assert_allclose(got, want, rtol=ulp, atol=ulp)


@pytest.mark.parametrize("k,n,block,dtype,ok", [
    (256, 64, 128, torch.bfloat16, True),
    (248, 64, 128, torch.bfloat16, True),    # a ragged last scale block
    (200, 48, 64, torch.float32, True),
    (100, 24, 32, torch.float32, False),     # K % 8 != 0
    (104, 32, 128, torch.float32, True),     # B clamps to K = 104
    (64, 32, 32, torch.float16, True),       # f16 x
    (64, 20, 32, torch.bfloat16, False),     # N % 8 != 0
    (96, 24, 24, torch.bfloat16, True),      # N % 16 != 0, B % 32 != 0
    (64, 32, 32, torch.float64, False)])     # not a kernel dtype
def test_supported_is_the_kernels_shape_rule(k, n, block, dtype, ok):
    w = torch.from_numpy(_weight((k, n), seed=k))
    q, s = quantize_weight(w, block)
    assert QK.supported(torch.zeros(3, k, dtype=dtype), q, s, block) is ok


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("k,n", [(64, 64), (96, 24), (100, 64), (40, 20),
                                 (128, 48)])
@pytest.mark.parametrize("block", [8, 24, 32, 128])
def test_supported_matches_the_reference_rule(monkeypatch, dtype, k, n,
                                              block):
    """``supported`` is the reference's kernel rule without its TPU and
    VMEM clauses (its backend test forced to a TPU here; the VMEM
    budget holds at these shapes), but takes a ragged last block."""
    import paddle_tpu.quant.kernels as RK
    monkeypatch.setattr(RK, "_interpret", lambda: False)
    w = _weight((k, n), seed=1)
    q, s = quantize_weight(torch.from_numpy(w), block)
    x = np.zeros((3, k), np.float32)
    ref = RK.supported(jnp.asarray(x).astype(getattr(jnp, dtype)),
                       jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), block)
    got = QK.supported(torch.zeros(3, k, dtype=getattr(torch, dtype)), q, s,
                       block)
    b = min(block, k)
    assert got is (ref if k % b == 0 else k % 8 == 0 and n % 8 == 0)


@pytest.mark.parametrize("kernel,dtype,k,n,block,want", [
    ("dequant_matmul", torch.bfloat16, 4096, 4096, 128, "cluster"),
    ("dequant_matmul", torch.float16, 4096, 1024, 48, "cluster"),
    ("dequant_matmul", torch.bfloat16, 96, 64, 24, "general"),
    ("dequant_matmul", torch.bfloat16, 96, 24, 32, "general"),
    ("dequant_matmul", torch.float32, 4096, 1024, 128, "tile"),
    ("dequant_matmul", torch.float32, 4096, 1024, 48, "general"),
    ("dequant_matmul", torch.bfloat16, 36, 64, 16, "general"),
    ("grouped_gemm", torch.bfloat16, 4096, 14336, None, "cluster"),
    ("grouped_gemm", torch.float32, 40, 24, None, "tile"),
    ("grouped_gemm", torch.float16, 64, 64, None, "cluster"),
    ("grouped_gemm", torch.bfloat16, 37, 64, None, "general"),
    ("grouped_gemm_q8", torch.bfloat16, 4096, 14336, 128, "cluster"),
    ("grouped_gemm_q8", torch.bfloat16, 96, 64, 24, "general"),
    ("grouped_gemm_q8", torch.bfloat16, 64, 24, 32, "general"),
    ("grouped_gemm_q8", torch.float16, 64, 64, 32, "cluster"),
    ("grouped_gemm_q8", torch.float16, 14336, 4096, 128, "cluster"),
    ("grouped_gemm_q8", torch.bfloat16, 40, 32, 16, "cluster"),
    ("grouped_gemm_q8", torch.float16, 36, 32, 16, "general"),
    ("grouped_gemm_q8", torch.float32, 4096, 1024, 128, "tile"),
    ("grouped_gemm_q8", torch.float32, 4096, 1024, 48, "general")])
def test_gemm_instance_rule(kernel, dtype, k, n, block, want):
    from paddle_tpu_torch.ops._tile_gemm import gemm_instance
    assert gemm_instance(kernel, dtype, k, n, block) == want


def test_dequant_launch_raises_only_for_what_no_instance_takes():
    """The CUDA wrapper refuses dtypes and scale shapes no instance
    takes, and misaligned operands of the cluster instance, before any
    launch (so the checks run on the CPU too)."""
    from paddle_tpu_torch.ops._tile_gemm import gemm_instance
    q, s = quantize_weight(torch.from_numpy(_weight((64, 32), seed=3)), 32)
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        QK._launch(torch.zeros(2, 64, dtype=torch.int32), q, s, 32)
    with pytest.raises(ValueError, match="int8 q and f32 scales"):
        QK._launch(torch.zeros(2, 64), q.float(), s, 32)
    with pytest.raises(ValueError, match="int8 q and f32 scales"):
        QK._launch(torch.zeros(2, 64), q, s[:1], 32)
    odd = torch.zeros(1 + 2 * 64, dtype=torch.bfloat16)[1:].view(2, 64)
    with pytest.raises(ValueError, match="cluster instance takes 16-byte"):
        QK._launch(odd, q, s, 32)
    with pytest.raises(ValueError, match="unknown GEMM kernel"):
        gemm_instance("matmul", torch.float32, 8, 8)
    assert QK.launches == 0 and not any(QK.instance_launches.values())


@pytest.mark.parametrize("bias", [False, True])
def test_weight_only_linear_from_linear(bias):
    paddle.seed(0)
    jl = paddle.nn.Linear(64, 40, bias_attr=None if bias else False)
    w = np.array(jl.weight._data)                            # [in, out]
    tl = torch.nn.Linear(64, 40, bias=bias)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T))
        if bias:
            tl.bias.copy_(torch.from_numpy(np.array(jl.bias._data)))
    jq, tq = JaxWOL.from_linear(jl, block=32), \
        WeightOnlyLinear.from_linear(tl, block=32)
    assert np.array_equal(tq.weight_int8.numpy(),
                          np.asarray(jq.weight_int8._data))
    assert np.array_equal(tq.weight_scale.numpy(),
                          np.asarray(jq.weight_scale._data))
    assert tq.weight_block == jq.weight_block == 32
    assert "block=32" in repr(tq) and f"bias={bias}" in repr(tq)
    x = np.random.RandomState(3).randn(6, 64).astype(np.float32)
    with torch.no_grad():
        got = tq(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq(paddle.to_tensor(x))
                                               .numpy()), **TOL)


def _pair(**cfg):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**cfg))
    jm.eval()
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(tiny_llama_config(**cfg), device="cpu")
    return jm, load_numpy_state(tm, arrays)


@pytest.mark.parametrize("cfg", [{}, {"moe_num_experts": 4}])
def test_quantize_model_matches_reference(cfg):
    jm, tm = _pair(**cfg)
    assert serving_weight_bytes(tm) == JF.serving_weight_bytes(jm)
    assert not is_quantized(tm) and model_weight_block(tm) is None
    JF.quantize_model(jm)
    assert quantize_model(tm) is tm
    assert is_quantized(tm)
    assert model_weight_block(tm) == JF.model_weight_block(jm)
    assert serving_weight_bytes(tm) == JF.serving_weight_bytes(jm)
    assert isinstance(tm.lm_head, torch.nn.Linear)          # skipped
    want = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        b = got[name].T if name == "lm_head.weight" else got[name]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    mlp = tm.model.layers[0].mlp
    if cfg:
        assert mlp.weight_block == jm.model.layers[0].mlp.weight_block
        assert mlp.gate_proj.dtype == torch.int8
        assert mlp.gate_proj_scale.shape == (4, 1, 128)
    # quantizing again changes nothing
    quantize_model(tm)
    assert all(np.array_equal(v.numpy(), got[k])
               for k, v in tm.state_dict().items())


def test_quantize_model_raises_on_nothing_to_quantize():
    with pytest.raises(ValueError, match="no quantizable"):
        quantize_model(torch.nn.Sequential(torch.nn.ReLU()))
    lin = torch.nn.Sequential(torch.nn.Linear(8, 8))
    with pytest.raises(ValueError, match="no quantizable"):
        quantize_model(lin, skip=("0",))


def test_scales_stay_f32_under_bf16_cast():
    _, tm = _pair(moe_num_experts=4)
    quantize_model(tm)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.to(torch.bfloat16)
    state = tm.state_dict()
    assert list(state) == list(before)
    for name, t in state.items():
        if name.endswith("_scale"):
            assert t.dtype == torch.float32 and torch.equal(t, before[name])
        elif before[name].dtype == torch.int8:
            assert torch.equal(t, before[name])
        else:                                   # the router gate casts too
            assert t.dtype == torch.bfloat16, name
    tm.float()
    assert tm.model.layers[1].self_attn.o_proj.weight_scale.dtype \
        == torch.float32
    assert tm.model.layers[1].mlp.down_proj_scale.dtype == torch.float32
