"""Llama decoder family (port of ``paddle_tpu/models/llama.py``).

Pre-norm decoder blocks: RMSNorm -> GQA attention with rotary
embeddings -> RMSNorm -> SwiGLU MLP, as ``nn.Module``s whose parameter
names match the reference package's state dict, so one checkpoint
dictionary fills either (see :mod:`paddle_tpu_torch.models.convert`).

This slice ports the dense model and its logits. The attention of the
plain (no-cache) forward is plain PyTorch math (matmul, causal mask,
softmax in f32): the serving engine never runs it, it is the model's
own reference. Training losses and the mixture-of-experts FFN are
later slices (ROADMAP queue A, items 7 and 8).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..device import resolve_device
from ..incubate.nn import functional as FI

__all__ = ["LlamaConfig", "LlamaMLP", "LlamaAttention", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "RMSNorm", "llama3_8b_config",
           "tiny_llama_config"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    recompute: bool = False
    #: > 0 selects the mixture-of-experts FFN, not ported yet
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_intermediate_size: int | None = None

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def llama3_8b_config():
    """Llama-3-8B: GQA 32q/8kv, 128k vocab, rope theta 500k."""
    return LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=8192, rms_norm_eps=1e-5, rope_theta=500000.0)


def tiny_llama_config(**kw):
    """A few-thousand-param config for tests and dry runs."""
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256,
                rope_theta=10000.0)
    base.update(kw)
    return LlamaConfig(**base)


class RMSNorm(nn.Module):
    """RMS normalisation, weight only, f32 accumulation."""

    def __init__(self, hidden_size, epsilon=1e-6, **factory):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, **factory))

    def forward(self, x):
        return FI.rms_norm(x, self.weight, self.epsilon)


def _linear(n_in, n_out, factory):
    return nn.Linear(n_in, n_out, bias=False, **factory)


class LlamaMLP(nn.Module):
    """SwiGLU MLP: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, i, factory)
        self.up_proj = _linear(h, i, factory)
        self.down_proj = _linear(i, h, factory)

    def forward(self, x):
        return self.down_proj(FI.swiglu(self.gate_proj(x), self.up_proj(x)))


def plain_attention(q, k, v):
    """Causal GQA attention on ``[B, S, H(k), D]`` in plain PyTorch:
    f32 scores and softmax, probabilities cast back to ``q.dtype``
    before the product with V."""
    group = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(group, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(group, dim=2).transpose(1, 2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    s_q, s_k = scores.shape[-2], scores.shape[-1]
    causal = torch.ones(s_q, s_k, dtype=torch.bool,
                        device=q.device).tril(s_k - s_q)
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


class LlamaAttention(nn.Module):
    """GQA attention with rotary embeddings, ``[B, S, H, D]``
    throughout."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        n = config.hidden_size
        self.q_proj = _linear(n, h * d, factory)
        self.k_proj = _linear(n, hk * d, factory)
        self.v_proj = _linear(n, hk * d, factory)
        self.o_proj = _linear(h * d, n, factory)

    def forward(self, x, position_ids=None):
        b, s = x.shape[0], x.shape[1]
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(x).reshape(b, s, h, d)
        k = self.k_proj(x).reshape(b, s, hk, d)
        v = self.v_proj(x).reshape(b, s, hk, d)
        q, k, v = FI.fused_rotary_position_embedding(
            q, k, v, position_ids=position_ids,
            rotary_emb_base=self.config.rope_theta)
        out = plain_attention(q, k, v)
        return self.o_proj(out.reshape(b, s, h * d))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        if config.moe_num_experts:
            raise NotImplementedError(
                "moe_num_experts > 0: the mixture-of-experts FFN is not "
                "ported yet (ROADMAP queue A, item 8)")
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **factory)
        self.self_attn = LlamaAttention(config, **factory)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, **factory)
        self.mlp = LlamaMLP(config, **factory)

    def forward(self, x, position_ids=None):
        x = x + self.self_attn(self.input_layernorm(x), position_ids)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **factory)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **factory)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            **factory)

    def forward(self, input_ids, position_ids=None):
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, position_ids)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Decoder LM; ``forward(input_ids)`` returns logits ``[B, S, V]``.

    The parameters are allocated on ``device`` (default ``cuda``; the
    CPU only when asked for by name) in ``dtype`` and initialised once:
    linear and embedding weights from ``N(0, initializer_range)`` drawn
    from ``generator`` (a :class:`torch.Generator` on that device),
    RMSNorm weights to ones."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        # allocate once on the target device, without the default
        # initialisers (an 8B model would pay for them twice)
        factory = dict(device="meta", dtype=dtype)
        self.model = LlamaModel(config, **factory)
        self.lm_head = None if config.tie_word_embeddings \
            else _linear(config.hidden_size, config.vocab_size, factory)
        self.to_empty(device=dev)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        std = self.config.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    def _logits(self, hidden):
        if self.lm_head is not None:
            return self.lm_head(hidden)
        return torch.matmul(hidden, self.model.embed_tokens.weight.t())

    def forward(self, input_ids, labels=None, position_ids=None):
        if labels is not None:
            raise NotImplementedError(
                "training losses are not ported yet (ROADMAP queue A, "
                "item 7); call forward(input_ids) for logits")
        return self._logits(self.model(input_ids, position_ids))

    def num_params(self):
        return sum(p.numel() for p in self.parameters())
