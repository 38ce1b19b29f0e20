"""``LlamaForCausalLM.generate`` over a static KV cache against the
reference's.

The cache pieces (``_kv_cache_update``, ``_decode_mask``) are held
against the reference's on the same numpy inputs; a cached forward's
logits against the port's own uncached forward. ``generate`` runs on
tiny models fitted with ``fit_on_prompts`` (a random-init model's logits
are near-ties) whose weights reach the port through
``models/convert.py``: greedy and seeded ``do_sample`` tokens (top-k,
top-p, temperature) must equal the reference's, dense and MoE. The seeds
were fixed before the first run.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.quant import quality

from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.models import llama as tllama

CONFIGS = {"dense": {}, "moe": dict(moe_num_experts=4, moe_top_k=2)}


@pytest.fixture(scope="module")
def fitted():
    out = {}
    for name, cfg in CONFIGS.items():
        paddle.seed(0)
        jm = JaxLlama(jax_tiny(**cfg))
        quality.fit_on_prompts(jm, steps=20)
        jm.eval()
        arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
        tm = LlamaForCausalLM(tiny_llama_config(**cfg), device="cpu")
        out[name] = (jm, load_numpy_state(tm, arrays).eval())
    return out


def _ids(seed, b, s):
    return np.random.RandomState(seed).randint(0, 128, (b, s))


@pytest.mark.parametrize("start,s", [(0, 5), (3, 4), (12, 4)])
def test_kv_cache_update_as_reference(start, s):
    rng = np.random.RandomState(start)
    buf = rng.randn(2, 16, 2, 8).astype(np.float32)
    new = rng.randn(2, s, 2, 8).astype(np.float32)
    want = jllama._kv_cache_update(paddle.to_tensor(buf),
                                   paddle.to_tensor(new),
                                   paddle.to_tensor(np.int32(start)))
    tbuf = torch.from_numpy(buf.copy())
    got = tllama._kv_cache_update(tbuf, torch.from_numpy(new),
                                  torch.tensor(start))
    assert got is tbuf                      # written in place
    assert np.array_equal(got.numpy(), np.asarray(want._data))
    # bf16 buffer: the new values are cast into it
    bb = torch.zeros((2, 16, 2, 8), dtype=torch.bfloat16)
    tllama._kv_cache_update(bb, torch.from_numpy(new), start)
    assert torch.equal(bb[:, start:start + s],
                       torch.from_numpy(new).bfloat16())


def test_kv_cache_overflow_raises_as_reference():
    buf, new = np.zeros((1, 8, 2, 4), np.float32), np.ones((1, 3, 2, 4),
                                                            np.float32)
    with pytest.raises(ValueError) as want:
        jllama._kv_cache_update(paddle.to_tensor(buf), paddle.to_tensor(new),
                                paddle.to_tensor(np.int32(6)))
    with pytest.raises(ValueError) as got:
        tllama._kv_cache_update(torch.from_numpy(buf), torch.from_numpy(new),
                                6)
    assert str(got.value) == str(want.value)
    assert "KV cache overflow" in str(got.value)


@pytest.mark.parametrize("length,s,max_len", [(0, 5, 8), (3, 1, 64),
                                              (7, 4, 11), (63, 1, 64)])
def test_decode_mask_as_reference(length, s, max_len):
    want = np.asarray(jllama._decode_mask(
        paddle.to_tensor(np.int32(length)), s, max_len)._data)
    for ln in (length, torch.tensor(length)):
        got = tllama._decode_mask(ln, s, max_len)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cached_forward_equals_uncached(fitted, name):
    """A prefill of 7 tokens into empty buffers, then 5 more at
    cache_len 7: each position's logits are the uncached forward's."""
    _, tm = fitted[name]
    ids = torch.from_numpy(_ids(3, 2, 12))
    with torch.no_grad():
        want = tm(ids)
        caches = tm._empty_caches(2, 64)
        h1, caches = tm.model(ids[:, :7], caches=caches, cache_len=0)
        h2, caches = tm.model(ids[:, 7:], caches=caches, cache_len=7)
        got = tm._logits(torch.cat([h1, h2], dim=1))
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    assert all(torch.count_nonzero(k[:, 12:]) == 0 for k, _ in caches)
    with pytest.raises(ValueError, match="cache_len"):
        tm.model(ids, caches=tm._empty_caches(2, 64))
    with pytest.raises(ValueError, match="cache_len"):
        tm.model.layers[0].self_attn(
            torch.zeros(2, 3, 64), cache=tm._empty_caches(2, 8)[0])


SAMPLERS = [dict(), dict(do_sample=True, seed=5),
            dict(do_sample=True, top_k=8, temperature=0.8, seed=7),
            dict(do_sample=True, top_p=0.9, seed=9),
            dict(do_sample=True, top_k=20, top_p=0.8, temperature=1.3,
                 seed=2 ** 31 - 1),
            dict(do_sample=True, top_k=1, seed=3)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("kw", SAMPLERS,
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in
                                                 kw.items()) or "greedy")
def test_generate_matches_reference(fitted, name, kw):
    jm, tm = fitted[name]
    ids = _ids(11, 3, 9)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=10,
                                  **kw)._data)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=10, **kw)
    assert got.dtype == torch.int64 and got.shape == (3, 19)
    assert np.array_equal(got.numpy(), want)
    if kw.get("top_k") == 1 or not kw:
        greedy = tm.generate(torch.from_numpy(ids), max_new_tokens=10)
        assert torch.equal(got, greedy)


def test_generate_bucketing_and_max_length(fitted, monkeypatch):
    jm, tm = fitted["dense"]
    lens = []
    real = tm._empty_caches
    monkeypatch.setattr(tm, "_empty_caches",
                        lambda b, n: lens.append(n) or real(b, n))
    ids = torch.from_numpy(_ids(2, 2, 60))
    tm.generate(ids, max_new_tokens=4)
    tm.generate(ids, max_new_tokens=5)
    tm.generate(ids, max_new_tokens=2, max_length=70)
    assert lens == [64, 128, 70]
    with pytest.raises(ValueError) as want:
        jm.generate(paddle.to_tensor(ids.numpy()), max_new_tokens=8,
                    max_length=64)
    with pytest.raises(ValueError) as got:
        tm.generate(ids, max_new_tokens=8, max_length=64)
    assert str(got.value) == str(want.value)


def test_generate_seed_from_generator(fitted):
    """``seed=None`` draws the seed from the given generator: the same
    generator state gives the same draw, and the draw is that seed's."""
    _, tm = fitted["dense"]
    ids = torch.from_numpy(_ids(4, 2, 6))
    kw = dict(max_new_tokens=8, do_sample=True, temperature=1.5)
    a = tm.generate(ids, generator=torch.Generator().manual_seed(1), **kw)
    b = tm.generate(ids, generator=torch.Generator().manual_seed(1), **kw)
    seed = int(torch.randint(0, 2 ** 31, (1,),
                             generator=torch.Generator().manual_seed(1)))
    assert torch.equal(a, b)
    assert torch.equal(a, tm.generate(ids, seed=seed, **kw))
    with pytest.raises(ValueError, match="seed"):
        tm.generate(ids, seed=2 ** 31, **kw)
