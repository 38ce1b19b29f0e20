"""The port's mixture-of-experts path against the reference package:
``top_k_routing`` (exact integers, ties included), the fixed-order
router logits, ``LlamaMoEMLP`` float and int8, packing invariance, a tiny MoE ``LlamaForCausalLM`` (logits,
loss and every gradient) and ``load_numpy_state`` with stacked experts
and quantized buffers.

Inputs are seeded numpy arrays (or the reference's seeded weights,
carried across). Tolerances: routing integers exact, routing weights
within 1e-6; f32 outputs and logits within 1e-4 absolute (other sum
orders); loss and gradients within 1e-4 of the tensor's largest value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.moe import top_k_routing as jax_routing
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.quant import quantize_model as jax_quantize_model

from paddle_tpu_torch.incubate.moe import top_k_routing
from paddle_tpu_torch.models import (LlamaForCausalLM, LlamaMoEMLP,
                                     load_numpy_state, tiny_llama_config)
from paddle_tpu_torch.models.llama import LlamaMLP, router_logits
from paddle_tpu_torch.quant import quantize_model

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)

MOE = dict(moe_num_experts=4, moe_top_k=2)


def _check_routing(logits, k, capacity):
    want = jax_routing(jnp.asarray(logits), k, capacity)
    got = top_k_routing(torch.from_numpy(logits), k, capacity)
    for i, (a, b) in enumerate(zip(want, got)):
        a, b = np.asarray(a), b.numpy()
        if i in (4, 5):                      # weights, aux
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        else:
            assert np.array_equal(a, b), i


@pytest.mark.parametrize("n,e,k,capacity", [
    (13, 4, 2, 13),          # dropless, as the model routes
    (13, 4, 2, 5),           # capacity drops
    (7, 8, 1, 7),
    (1, 8, 2, 1),            # one token
    (32, 8, 3, 4)])
def test_top_k_routing_matches_reference(n, e, k, capacity):
    logits = np.random.RandomState(n + e).randn(n, e).astype(np.float32)
    _check_routing(logits, k, capacity)


def test_top_k_routing_ties_pick_the_lower_expert():
    logits = np.random.RandomState(1).randn(9, 6).astype(np.float32)
    logits[0] = 0.25                          # all six tied
    logits[1, :3] = 3.0                       # three tied at the top
    logits[2, 2:5] = 5.0
    logits[3] = [1, 2, 2, 1, 2, 0]
    _check_routing(logits, 2, 9)
    _, expert_of, *_ = top_k_routing(torch.from_numpy(logits), 2, 9)
    assert expert_of[0].tolist() == [0, 1]
    assert expert_of[2].tolist() == [2, 3]
    assert expert_of[3].tolist() == [1, 2]


def _pair(quantized=False, **cfg):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**MOE, **cfg))
    jm.eval()
    tm = LlamaForCausalLM(tiny_llama_config(**MOE, **cfg), device="cpu")
    if quantized:
        jax_quantize_model(jm)
        quantize_model(tm)
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    return jm, load_numpy_state(tm, arrays), arrays


def test_config_selects_moe_mlp():
    _, tm, _ = _pair()
    mlp = tm.model.layers[0].mlp
    assert isinstance(mlp, LlamaMoEMLP)
    assert (mlp.num_experts, mlp.top_k, mlp.d_ff) == (4, 2, 128)
    assert tuple(mlp.gate.shape) == (64, 4) and mlp.gate.dtype \
        == torch.float32
    assert tuple(mlp.gate_proj.shape) == (4, 64, 128)
    assert tuple(mlp.down_proj.shape) == (4, 128, 64)
    dense = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    assert isinstance(dense.model.layers[0].mlp, LlamaMLP)


@pytest.mark.parametrize("quantized", [False, True])
def test_moe_mlp_matches_reference(quantized):
    jm, tm, _ = _pair(quantized)
    x = np.random.RandomState(2).randn(3, 5, 64).astype(np.float32)
    jmlp, tmlp = jm.model.layers[1].mlp, tm.model.layers[1].mlp
    want = np.asarray(jmlp(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tmlp(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 5, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tmlp.l_aux), float(jmlp.l_aux._data),
                               rtol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_moe_mlp_packing_invariance(quantized):
    """A token's output does not depend on what else is packed beside
    it (bit for bit on the card, where the kernels fix the order of
    every sum; the CPU's library products may block by size)."""
    _, tm, _ = _pair(quantized)
    mlp = tm.model.layers[0].mlp
    x = torch.from_numpy(
        np.random.RandomState(3).randn(64, 64).astype(np.float32))
    with torch.no_grad():
        alone = mlp(x[:1])
        packed = mlp(x)
    np.testing.assert_allclose(alone[0].numpy(), packed[0].numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,d,e", [(64, 64, 4), (9, 100, 8), (600, 96, 3)])
def test_router_logits_are_row_independent(n, d, e):
    """Each router logit is one sum in a fixed order: bit for bit the
    same for a row alone and packed (at every token count; 600 rows
    pass the f64 temporary's 512-row bound), and within f32 rounding of
    the plain product."""
    rng = np.random.RandomState(n + d)
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    gate = torch.from_numpy(rng.randn(d, e).astype(np.float32))
    packed = router_logits(x, gate)
    assert packed.shape == (n, e) and packed.dtype == torch.float32
    for i in (0, n // 2, n - 1):
        assert torch.equal(router_logits(x[i:i + 1], gate)[0], packed[i])
    np.testing.assert_allclose(packed.numpy(), x.numpy() @ gate.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_moe_model_logits_match_reference(quantized):
    jm, tm, _ = _pair(quantized)
    ids = np.random.RandomState(0).randint(0, 128, (2, 19)).astype(np.int64)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_moe_model_loss_and_grads_match_reference():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**MOE))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = load_numpy_state(
        LlamaForCausalLM(tiny_llama_config(**MOE), device="cpu"), arrays)
    ids = np.random.RandomState(1).randint(0, 128, (2, 65))
    x, y = ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)
    loss_j, _ = jm(paddle.to_tensor(x), paddle.to_tensor(y))
    loss_j.backward()
    loss_t, _ = tm(torch.from_numpy(x), torch.from_numpy(y))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    linear = {n + ".weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    tparams = dict(tm.named_parameters())
    assert sorted(n for n, _ in jm.named_parameters()) == sorted(tparams)
    for name, p in jm.named_parameters():
        want = np.asarray(p.grad.numpy())
        got = tparams[name].grad.numpy()
        if name in linear:
            got = got.T
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("quantized", [False, True])
def test_load_numpy_state_moe(quantized):
    _, tm, arrays = _pair(quantized)
    state = tm.state_dict()
    for name in ("model.layers.0.mlp.gate", "model.layers.0.mlp.up_proj",
                 "model.layers.1.mlp.down_proj"):
        assert np.array_equal(state[name].numpy(), arrays[name])
        assert state[name].numpy().dtype == arrays[name].dtype
    if quantized:
        for name in ("model.layers.0.mlp.gate_proj_scale",
                     "model.layers.0.self_attn.q_proj.weight_int8",
                     "model.layers.0.self_attn.q_proj.weight_scale"):
            assert np.array_equal(state[name].numpy(), arrays[name])
            assert state[name].numpy().dtype == arrays[name].dtype
    for fault in ("missing", "extra", "shape"):
        bad = dict(arrays)
        key = "model.layers.1.mlp.down_proj_scale" if quantized \
            else "model.layers.1.mlp.down_proj"
        if fault == "missing":
            bad.pop(key)
        elif fault == "extra":
            bad["model.layers.1.mlp.bogus_scale"] = np.zeros(2, np.float32)
        else:
            bad[key] = np.swapaxes(bad[key], 1, 2)
        with pytest.raises(ValueError):
            load_numpy_state(tm, bad)
