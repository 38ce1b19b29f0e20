"""Llama decoder family (port of ``paddle_tpu/models/llama.py``).

Pre-norm decoder blocks: RMSNorm -> GQA attention with rotary
embeddings -> RMSNorm -> SwiGLU MLP, as ``nn.Module``s whose parameter
names match the reference package's state dict, so one checkpoint
dictionary fills either (see :mod:`paddle_tpu_torch.models.convert`).

The no-cache forward is the training path: its attention is
:func:`nn.functional.scaled_dot_product_attention` (the flash kernels
where their preconditions hold), and ``forward(input_ids, labels)``
returns the loss, by default through the fused linear cross-entropy.
The serving engine never runs this forward; :func:`plain_attention`
stays beside it as the model's own plain reference. The
mixture-of-experts FFN is a later slice (ROADMAP queue A, item 8).
"""

from __future__ import annotations

import dataclasses
import os

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.recompute import recompute
from ..incubate.nn import functional as FI
from ..nn import functional as F
from ..ops.fused_linear_cross_entropy import fused_linear_cross_entropy

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
    #: True checkpoints every decoder layer; "dots" is not ported yet
    recompute: bool | str = False
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
    return F.attention._naive_attention(q, k, v, None, is_causal=True)


def causal_attention(q, k, v):
    """The no-cache forward's attention: the port's
    ``scaled_dot_product_attention`` (flash kernels where supported)."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=True)


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
        out = causal_attention(q, k, v)
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
        remat = self.config.recompute and torch.is_grad_enabled() \
            and x.requires_grad
        policy = "dots" if self.config.recompute == "dots" else None
        for layer in self.layers:
            if remat:
                x = recompute(layer, x, position_ids, policy=policy)
            else:
                x = layer(x, position_ids)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Decoder LM. ``forward(input_ids)`` returns logits ``[B, S, V]``;
    with next-token ``labels`` (the input shifted by the caller,
    ignore_index -100) it returns ``(loss, None)`` on the default fused
    cross-entropy path, where the logits are never built, or ``(loss,
    logits)`` under ``PADDLE_TPU_FUSED_CE=0`` or tied embeddings (the
    materialized path).

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

    def _fused_ce_enabled(self):
        """The fused linear cross-entropy is the default loss path;
        ``PADDLE_TPU_FUSED_CE=0`` restores the materialized one, which
        the tied-embedding model always takes."""
        if self.lm_head is None:
            return False
        return os.environ.get("PADDLE_TPU_FUSED_CE", "1") != "0"

    def forward(self, input_ids, labels=None, position_ids=None):
        hidden = self.model(input_ids, position_ids)
        if labels is not None and self._fused_ce_enabled():
            loss = fused_linear_cross_entropy(
                hidden, self.lm_head.weight, labels, ignore_index=-100)
            return loss, None
        logits = self._logits(hidden)
        if labels is None:
            return logits
        v = self.config.vocab_size
        loss = F.cross_entropy(logits.reshape(-1, v).float(),
                               labels.reshape(-1), ignore_index=-100)
        return loss, logits

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len):
        """Approximate training FLOPs per token: 6 x the matmul
        parameters plus the attention term (the usual MFU accounting).
        The embedding lookup is a gather, so its table counts only when
        it is tied and doubles as the output projection."""
        cfg = self.config
        n = self.num_params()
        if not cfg.tie_word_embeddings:
            n -= cfg.vocab_size * cfg.hidden_size
        attn = 12 * cfg.num_hidden_layers * cfg.hidden_size * seq_len
        return 6 * n + attn
