"""The port's serving engine on a mixture-of-experts model and on int8
weights, against the reference engine.

Each tiny model is fitted first (``quant.quality.fit_on_prompts``, as
``test_torch_serving.py`` does: a random-init model's logits are
near-ties) and its weights are carried into the port. Both engines then
serve the same prompts: the reference on its two-op path
(``fused_kv=False``) with the prefix cache and sampling off, each
quantizing its own model in place for ``weight_dtype="int8"``. Greedy
tokens must be identical, and so must the two quantized states. The
engine itself needs no change for MoE: dropless routing makes the FFN
a function of each token alone.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import LlamaServingEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.quant import quality

from paddle_tpu_torch.inference.serving import LlamaServingEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.quant import WeightOnlyLinear

GEOM = dict(max_batch=4, page_size=8, num_pages=64, chunk_block=8,
            chunk_budget=16)
CONFIGS = {"moe": dict(moe_num_experts=4, moe_top_k=2), "dense": {}}


@pytest.fixture(scope="module")
def fitted():
    """Fitted float weights of each config, as numpy arrays."""
    out = {}
    for name, cfg in CONFIGS.items():
        paddle.seed(0)
        jm = JaxLlama(jax_tiny(**cfg))
        quality.fit_on_prompts(jm, steps=30)
        out[name] = {k: np.array(v._data) for k, v in jm.state_dict().items()}
    return out


def _models(fitted, name):
    cfg = CONFIGS[name]
    jm = JaxLlama(jax_tiny(**cfg))
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in fitted[name].items()})
    jm.eval()
    tm = LlamaForCausalLM(tiny_llama_config(**cfg), device="cpu")
    return jm, load_numpy_state(tm, fitted[name])


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).tolist() for n in lens]


@pytest.mark.parametrize("name,weight_dtype", [
    ("moe", None), ("dense", "int8"), ("moe", "int8")])
def test_generate_matches_reference_engine(fitted, name, weight_dtype):
    jm, tm = _models(fitted, name)
    prompts = _prompts(7, (21, 5, 30, 12, 9))
    je = JaxEngine(jm, fused_kv=False, prefix_cache=False, sampling=False,
                   weight_dtype=weight_dtype, **GEOM)
    want = je.generate(prompts, max_new_tokens=8)
    je.close()
    te = LlamaServingEngine(tm, weight_dtype=weight_dtype, **GEOM)
    assert (te.weight_quant, te.weight_block) \
        == (je.weight_quant, je.weight_block)
    assert te.weight_bytes_per_param == pytest.approx(
        je.weight_bytes_per_param, rel=1e-12)
    got = te.generate(prompts, max_new_tokens=8)
    assert got == want
    assert len({t for o in got for t in o}) > 1      # not one stuck token
    assert te.alloc.free_pages == te.alloc.num_pages
    if weight_dtype:
        ref = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
        for k, v in tm.state_dict().items():
            if k != "lm_head.weight":
                assert np.array_equal(v.numpy(), ref[k]), k


def test_weight_dtype_knobs(fitted, monkeypatch):
    _, tm = _models(fitted, "dense")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    te = LlamaServingEngine(tm, weight_dtype="bf16", **GEOM)
    assert not te.weight_quant and te.weight_block == 0
    state = tm.state_dict()
    assert list(state) == list(before)
    assert all(torch.equal(state[k], v) for k, v in before.items())
    with pytest.raises(ValueError, match="weight_dtype"):
        LlamaServingEngine(tm, weight_dtype="fp8", **GEOM)
    # int8 KV pages combine with either weight dtype; other KV dtypes
    # are refused
    assert LlamaServingEngine(tm, kv_dtype="int8", **GEOM).kv_quant
    with pytest.raises(ValueError, match="kv_dtype"):
        LlamaServingEngine(tm, kv_dtype="fp8", **GEOM)
    # the fleet knob quantizes in place; a quantized model is served as
    # it is
    monkeypatch.setenv("PADDLE_TPU_WEIGHT_DTYPE", "int8")
    te = LlamaServingEngine(tm, weight_block=32, **GEOM)
    assert te.weight_quant and te.weight_block == 32
    q = tm.model.layers[0].self_attn.q_proj
    assert isinstance(q, WeightOnlyLinear)
    te = LlamaServingEngine(tm, weight_dtype="int8", weight_block=64, **GEOM)
    assert tm.model.layers[0].self_attn.q_proj is q and te.weight_block == 32
    monkeypatch.delenv("PADDLE_TPU_WEIGHT_DTYPE")
    assert LlamaServingEngine(tm, **GEOM).weight_quant
