"""The port's Llama model against the reference package: the same
numpy weights (carried across by ``load_numpy_state``) and the same
token ids must give the same logits, f32 at atol 1e-4 (the two
frameworks sum the matmuls and softmax in different orders)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny

from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.models.llama import llama3_8b_config

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)


def _pair(seed=0, **cfg):
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(**cfg))
    jm.eval()
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(tiny_llama_config(**cfg), device="cpu")
    return jm, load_numpy_state(tm, arrays), arrays


@pytest.mark.parametrize("cfg", [
    {}, {"tie_word_embeddings": True}, {"num_key_value_heads": 4},
    {"num_hidden_layers": 3, "rope_theta": 500000.0}])
def test_logits_match_reference(cfg):
    jm, tm, _ = _pair(**cfg)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (2, 19)).astype(np.int64)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (2, 19, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert tm.num_params() == jm.num_params()


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_numpy_state_rejects_mismatch(fault):
    _, tm, arrays = _pair()
    arrays = dict(arrays)
    if fault == "missing":
        arrays.pop("model.norm.weight")
    elif fault == "extra":
        arrays["model.bogus.weight"] = np.zeros(3, np.float32)
    else:
        w = arrays["model.layers.0.self_attn.k_proj.weight"]
        arrays["model.layers.0.self_attn.k_proj.weight"] = w.T
    with pytest.raises(ValueError):
        load_numpy_state(tm, arrays)


def test_linear_weights_are_transposed():
    _, tm, arrays = _pair()
    w = arrays["model.layers.1.mlp.gate_proj.weight"]       # [in, out]
    got = tm.model.layers[1].mlp.gate_proj.weight.detach().numpy()
    assert np.array_equal(got, w.T)


def test_unported_features_raise():
    """``recompute="dots"``, which raised until it was ported, now trains:
    its loss is the plain model's; an unknown policy still raises."""
    g = torch.Generator().manual_seed(0)
    tm = LlamaForCausalLM(tiny_llama_config(recompute="dots"), device="cpu",
                          generator=g)
    plain = LlamaForCausalLM(tiny_llama_config(), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    ids = torch.randint(0, 128, (1, 8), generator=g)
    assert tm(ids, labels=ids)[0].item() == plain(ids, labels=ids)[0].item()
    from paddle_tpu_torch.distributed.recompute import recompute
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(plain.model.layers[0], torch.zeros(1, 4, 64),
                  policy="offload")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(tiny_llama_config())


def test_seeded_init_and_8b_geometry():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = LlamaForCausalLM(tiny_llama_config(), device="cpu", generator=g1)
    b = LlamaForCausalLM(tiny_llama_config(), device="cpu", generator=g2)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert torch.all(a.model.norm.weight == 1.0)
    assert abs(float(a.lm_head.weight.detach().std()) - 0.02) < 2e-3
    c = llama3_8b_config()
    assert (c.head_dim, c.num_key_value_heads, c.vocab_size) \
        == (128, 8, 128256)
