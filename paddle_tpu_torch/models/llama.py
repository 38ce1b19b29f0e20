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
stays beside it as the model's own plain reference.

``LlamaForCausalLM.generate`` decodes over static ``[B, max_len, Hk, D]``
KV buffers (the ``cache`` / ``cache_len`` arguments of the attention,
layer and model forwards): each step writes its K/V in place at
``cache_len`` and attends the valid prefix under a bool mask, through the
plain masked attention (:func:`masked_attention`), as the reference's
masked attention takes XLA. Sampled steps draw with the reference's
threefry key ``fold_in(key(seed), step)`` through one launch of
:func:`~paddle_tpu_torch.ops.sampling.gumbel_argmax`. The prefill runs
eagerly; every later step is one function of static buffers (``cache_len``
and the step index are device scalars), which on the card is a CUDA graph
captured once per (parameters, sampler, batch, max_len), as the reference
compiles its step once per shape, and replayed each step.

``moe_num_experts > 0`` selects the mixture-of-experts FFN
(:class:`LlamaMoEMLP`, Mixtral-style): dropless top-k routing and three
grouped GEMMs over the stacked expert weights, float or, after
``quantize_weights``, int8 with per-block scales.
"""

from __future__ import annotations

import dataclasses
import os

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.recompute import recompute
from ..incubate.moe import top_k_routing
from ..incubate.nn import functional as FI
from ..nn import functional as F
from ..ops._graphs import StepGraphs
from ..ops.fused_linear_cross_entropy import fused_linear_cross_entropy
from ..ops.grouped_gemm import grouped_gemm, grouped_gemm_q8
from ..ops.sampling import gumbel_argmax
from ..quant.format import effective_block, quantize_weight
from ..quant.layers import keep_f32

__all__ = ["LlamaConfig", "LlamaMLP", "LlamaMoEMLP", "LlamaAttention",
           "LlamaDecoderLayer",
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
    #: > 0 selects the mixture-of-experts FFN (LlamaMoEMLP)
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


def _check_cache_room(start, s, max_len):
    """The reference's overflow check of a cache write, on a host int."""
    if start + s > max_len:
        raise ValueError(
            f"KV cache overflow: writing {s} tokens at offset "
            f"{start} exceeds the static buffer ({max_len})")


def _kv_cache_update(buf, new, start):
    """Write ``new [B, s, Hk, D]`` into the static buffer ``buf [B,
    max_len, Hk, D]`` at sequence offset ``start``, IN PLACE, cast to the
    buffer's dtype; returns ``buf``. An int ``start`` is checked first (a
    write past the buffer raises). A tensor ``start`` (one integer, on the
    buffer's device) is never read on the host, as the reference's traced
    offset is not: the write is an index copy at ``start + arange(s)``,
    and its caller checks the room on its own host counter (an index past
    the buffer is an indexing error)."""
    s, max_len = new.shape[1], buf.shape[1]
    if isinstance(start, torch.Tensor):
        idx = start.reshape(()).long() + torch.arange(s, device=buf.device)
        buf.index_copy_(1, idx, new.to(buf.dtype))
        return buf
    st = int(start)
    _check_cache_room(st, s, max_len)
    buf[:, st:st + s] = new.to(buf.dtype)
    return buf


def _row_ints(x, b, device):
    """``[b]`` int32 copies of ``x``: an int, or a one-element integer
    tensor, read on the device."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(torch.int32).expand(b)
    return torch.full((b,), x, dtype=torch.int32, device=device)


def _decode_mask(length, s, max_len, device=None):
    """Bool ``[1, 1, s, max_len]``: query i (absolute position
    ``length + i``) sees key j iff ``j <= length + i`` — causal over the
    valid prefix of a static buffer."""
    qpos = torch.arange(s, device=device) + length
    kpos = torch.arange(max_len, device=device)
    return (kpos[None, :] <= qpos[:, None])[None, None]


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


_ROUTER_ROWS = 512      # rows per [rows, E, D] f64 temporary of the router


def router_logits(x2d, gate):
    """The f32 router logits ``x2d [n, D] @ gate [D, E]``, each a sum over
    D in one fixed order whatever the token count: the f64 products
    (exact for f32 inputs) are halved by elementwise adds, the last half
    onto the first, until one term is left, then rounded to f32 once. A
    library product picks its order of sums by the shape, which would
    let one token's routing depend on how many others are packed beside
    it."""
    g = gate.double().t()[None]                              # [1, E, D]
    out = []
    for x in x2d.split(_ROUTER_ROWS):
        t = x.double()[:, None, :] * g
        while t.shape[-1] > 1:
            if t.shape[-1] % 2:
                t = nn.functional.pad(t, (0, 1))
            h = t.shape[-1] // 2
            t = t[..., :h] + t[..., h:]
        out.append(t[..., 0].float())
    return out[0] if len(out) == 1 else torch.cat(out)


class LlamaMoEMLP(nn.Module):
    """Mixture-of-experts SwiGLU FFN (Mixtral-style), selected by
    ``config.moe_num_experts > 0``.

    Per token: a softmax router over E experts, top-k with renormalized
    weights, each expert a bias-free SwiGLU MLP with stacked weights
    ``gate_proj``/``up_proj [E, D, F]`` and ``down_proj [E, F, D]`` (the
    reference layout), router ``gate [D, E]`` in f32. Routing is
    dropless (capacity = the token count), so a token's output is a
    function of its own hidden state only: on the card, bit for bit
    whatever else is packed beside it, which is what lets the serving
    engine pack any rows into one dispatch. The three products are the
    grouped GEMM kernels; ``quantize_weights`` turns the stacked weights
    into int8 buffers (same names) plus f32 ``*_scale`` buffers, and the
    products into the int8 grouped GEMM. ``l_aux`` keeps the last
    forward's load-balancing loss (the model's loss never adds it)."""

    _WEIGHTS = ("gate_proj", "up_proj", "down_proj")

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        e = int(config.moe_num_experts)
        if e <= 0:
            raise ValueError("LlamaMoEMLP needs config.moe_num_experts "
                             f"> 0, got {e}")
        self.num_experts = e
        self.top_k = max(1, min(int(config.moe_top_k), e))
        self.d_model = d = config.hidden_size
        self.d_ff = f = config.moe_intermediate_size \
            or config.intermediate_size
        self.gate = nn.Parameter(torch.empty(
            d, e, device=factory.get("device"), dtype=torch.float32))
        self.gate_proj = nn.Parameter(torch.empty(e, d, f, **factory))
        self.up_proj = nn.Parameter(torch.empty(e, d, f, **factory))
        self.down_proj = nn.Parameter(torch.empty(e, f, d, **factory))
        self.l_aux = None
        #: the int8 weights' block size once quantized (None: float)
        self.weight_block = None

    @torch.no_grad()
    def reset_parameters(self, std, generator=None):
        for p in self.parameters():
            p.normal_(0.0, std, generator=generator)

    @torch.no_grad()
    def quantize_weights(self, block=None):
        """Swap the stacked expert weights (in place) for int8 buffers
        of the same names and shapes plus ``[E, ceil(K/B), N]`` f32
        ``<name>_scale`` buffers, one expert at a time (the f32
        temporaries of one expert, not of the stack). The router gate
        stays float."""
        if self.weight_block:
            return
        # one nominal block; each weight clamps it to its own K
        block = effective_block(max(self.d_model, self.d_ff), block)
        for name in self._WEIGHTS:
            p = getattr(self, name)
            e, k, n = p.shape
            b = min(block, k)
            q = torch.empty((e, k, n), dtype=torch.int8, device=p.device)
            s = torch.empty((e, -(-k // b), n), dtype=torch.float32,
                            device=p.device)
            for i in range(e):
                q[i], s[i] = quantize_weight(p[i], b)
            delattr(self, name)
            self.register_buffer(name, q)
            self.register_buffer(name + "_scale", s)
        self.weight_block = int(block)

    def _apply(self, fn, recurse=True):
        if not self.weight_block:
            return super()._apply(fn, recurse)
        return keep_f32(self, fn, recurse,
                        tuple(n + "_scale" for n in self._WEIGHTS))

    def _products(self, x, gs):
        """The three grouped GEMMs with SwiGLU between them."""
        if not self.weight_block:
            g = grouped_gemm(x, self.gate_proj, gs)
            u = grouped_gemm(x, self.up_proj, gs)
            return grouped_gemm(FI.swiglu(g, u), self.down_proj, gs)
        bg = min(self.weight_block, self.d_model)   # gate/up: K = d_model
        bd = min(self.weight_block, self.d_ff)      # down: K = d_ff
        g = grouped_gemm_q8(x, self.gate_proj, self.gate_proj_scale, gs, bg)
        u = grouped_gemm_q8(x, self.up_proj, self.up_proj_scale, gs, bg)
        return grouped_gemm_q8(FI.swiglu(g, u), self.down_proj,
                               self.down_proj_scale, gs, bd)

    def route(self, x2d):
        """Dropless top-k routing of ``x2d [n, D]``: the outputs of
        :func:`top_k_routing` (capacity n) and the real rows of each
        expert ``[E]`` int32, all on x's device."""
        n, e = x2d.shape[0], self.num_experts
        logits = router_logits(x2d, self.gate)
        routing = top_k_routing(logits, self.top_k, n, normalize=True)
        expert_of, keep = routing[1], routing[3]
        gs = ((expert_of.reshape(-1, 1) == torch.arange(e, device=x2d.device))
              & keep.reshape(-1, 1)).sum(dim=0, dtype=torch.int32)
        return routing + (gs,)

    def forward(self, x):
        shape = x.shape
        x2d = x.reshape(-1, shape[-1])
        n, k = x2d.shape[0], self.top_k
        slot_token, expert_of, pos_of, keep, weights, self.l_aux, gs = \
            self.route(x2d)
        y = self._products(x2d[slot_token.clamp_min(0)], gs)   # [E*n, D]
        picked = y[expert_of * n + pos_of.clamp(0, n - 1)]     # [n, k, D]
        wk = (weights * keep).to(x2d.dtype).float()
        # the combine, one fixed order per token
        out = wk[:, 0, None] * picked[:, 0].float()
        for j in range(1, k):
            out = out + wk[:, j, None] * picked[:, j].float()
        return out.to(x2d.dtype).reshape(shape)


def plain_attention(q, k, v):
    """Causal GQA attention on ``[B, S, H(k), D]`` in plain PyTorch:
    f32 scores and softmax, probabilities cast back to ``q.dtype``
    before the product with V."""
    return F.attention._naive_attention(q, k, v, None, is_causal=True)


def causal_attention(q, k, v):
    """The no-cache forward's attention: the port's
    ``scaled_dot_product_attention`` (flash kernels where supported)."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=True)


def masked_attention(q, k, v, mask):
    """The cached forward's attention: ``[B, s, H, D]`` q over the whole
    static ``[B, max_len, Hk, D]`` buffers under the bool ``mask``, the
    plain composition (a masked call never takes the flash kernels)."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


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

    def forward(self, x, position_ids=None, cache=None, cache_len=None,
                attn_mask=None):
        """Without ``cache``: causal attention over ``x``'s own tokens.
        With ``cache = (k_buf, v_buf)`` (static ``[B, max_len, Hk, D]``)
        and ``cache_len`` (the tokens cached before ``x``): writes x's
        K/V at ``cache_len`` in place, attends the buffers under
        ``attn_mask`` (default :func:`_decode_mask`) and returns ``(out,
        (k_buf, v_buf))``."""
        b, s = x.shape[0], x.shape[1]
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(x).reshape(b, s, h, d)
        k = self.k_proj(x).reshape(b, s, hk, d)
        v = self.v_proj(x).reshape(b, s, hk, d)
        if cache is not None and cache_len is None:
            raise ValueError(
                "cache_len (scalar int Tensor) is required when a KV "
                "cache is passed — the static buffer needs the write "
                "offset")
        if position_ids is None and cache is not None:
            # rope continues after the cached prefix
            position_ids = (torch.arange(s, device=x.device)
                            + cache_len)[None]
        q, k, v = FI.fused_rotary_position_embedding(
            q, k, v, position_ids=position_ids,
            rotary_emb_base=self.config.rope_theta)
        if cache is None:
            out = causal_attention(q, k, v)
            return self.o_proj(out.reshape(b, s, h * d))
        k_buf = _kv_cache_update(cache[0], k, cache_len)
        v_buf = _kv_cache_update(cache[1], v, cache_len)
        if attn_mask is None:
            attn_mask = _decode_mask(cache_len, s, k_buf.shape[1], x.device)
        out = masked_attention(q, k_buf, v_buf, attn_mask)
        return self.o_proj(out.reshape(b, s, h * d)), (k_buf, v_buf)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **factory)
        self.self_attn = LlamaAttention(config, **factory)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, **factory)
        self.mlp = LlamaMoEMLP(config, **factory) if config.moe_num_experts \
            else LlamaMLP(config, **factory)

    def forward(self, x, position_ids=None, cache=None, cache_len=None,
                attn_mask=None):
        h = self.input_layernorm(x)
        if cache is not None:
            attn, cache = self.self_attn(h, position_ids, cache, cache_len,
                                         attn_mask)
        else:
            attn = self.self_attn(h, position_ids)
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x if cache is None else (x, cache)


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

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_len=None):
        """``[B, S]`` ids -> the final hidden states; with ``caches`` (one
        ``(k_buf, v_buf)`` per layer) and ``cache_len``, ``(hidden,
        caches)``, the buffers written in place."""
        x = self.embed_tokens(input_ids)
        if caches is not None:
            if cache_len is None:
                raise ValueError(
                    "cache_len is required when caches are passed")
            s = input_ids.shape[1]
            if position_ids is None:
                position_ids = (torch.arange(s, device=x.device)
                                + cache_len)[None]
            # the same for every layer: built once
            mask = _decode_mask(cache_len, s, caches[0][0].shape[1],
                                x.device)
            new_caches = []
            for layer, cache in zip(self.layers, caches):
                x, cache = layer(x, position_ids, cache, cache_len, mask)
                new_caches.append(cache)
            return self.norm(x), new_caches
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
    linear, embedding, router and expert weights from ``N(0,
    initializer_range)`` drawn from ``generator`` (a
    :class:`torch.Generator` on that device), RMSNorm weights to ones."""

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
            elif isinstance(mod, LlamaMoEMLP):
                mod.reset_parameters(std, generator)

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

    @staticmethod
    def _pick_token(logits, key, sampler):
        """The next-token rule on ``[B, 1, V]`` logits: the argmax, or
        with ``do_sample`` temperature, then top-k, then top-p (a stable
        sort of the probabilities), then a categorical draw: one launch
        of :func:`gumbel_argmax` under ``key = (seed, fold)`` (ints, or
        one-element tensors read on the device), counters ``b * V + j``.
        ``sampler`` is ``(do_sample, top_k, top_p, temperature)``. Returns
        int64 ``[B, 1]``."""
        do_sample, top_k, top_p, temperature = sampler
        if not do_sample:
            return logits.argmax(dim=-1)
        b, _, v = logits.shape
        dev = logits.device
        # an elementwise division (a scalar divisor may become a product
        # by its reciprocal)
        temp = torch.full((b, 1), max(float(temperature), 1e-6),
                          dtype=torch.float32, device=dev)
        lg = logits[:, 0, :].float() / temp
        masked = torch.full_like(lg, -1e30)
        if top_k:   # None or 0 disables the filter
            k = min(int(top_k), v)
            kth = torch.sort(lg, dim=-1).values[:, v - k, None]
            lg = torch.where(lg >= kth, lg, masked)
        if top_p is not None:
            # nucleus over the (possibly top-k-restricted) softmax
            probs = torch.softmax(lg, dim=-1)
            order = torch.argsort(-probs, dim=-1, stable=True)
            sp = probs.gather(1, order)
            cum_before = torch.cumsum(sp, dim=-1) - sp
            keep = torch.zeros_like(lg, dtype=torch.bool).scatter(
                1, order, cum_before < float(top_p))
            lg = torch.where(keep, lg, masked)
        seed, fold = key
        rows = torch.arange(b, device=dev)
        nxt = gumbel_argmax(
            lg, _row_ints(seed, b, dev), _row_ints(fold, b, dev), rows * v,
            torch.full((b,), float("-inf"), device=dev))
        return nxt[:, None]

    def _decode_step(self, tokens, cache_len, caches, key=None,
                     sampler=(False, None, None, 1.0)):
        """One generation step: ``(next_token [B, 1], new_cache_len,
        caches)``; the buffers are written in place."""
        hidden, caches = self.model(tokens, None, caches, cache_len)
        logits = self._logits(hidden[:, -1:])
        nxt = self._pick_token(logits, key, sampler)
        return nxt, cache_len + tokens.shape[1], caches

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=16, max_length=None,
                 do_sample=False, top_k=None, top_p=None, temperature=1.0,
                 seed=None, generator=None):
        """Decode ``max_new_tokens`` after ``input_ids [B, S]`` over a
        static KV cache of ``max_length`` positions (default: prompt +
        new tokens rounded up to a multiple of 64). Greedy by default;
        ``do_sample=True`` draws each step (temperature -> top-k -> top-p
        -> categorical) under the key ``fold_in(key(seed), step)``, the
        reference's. With ``seed=None`` the seed is drawn from
        ``generator`` (a CPU :class:`torch.Generator`; torch's default one
        if None), where the reference takes the next key of its global
        stream. The prefill runs eagerly; the decode steps replay the
        step's CUDA graph on the card (see the module docstring). Returns
        int64 ``[B, S + max_new_tokens]``."""
        b, s = input_ids.shape
        need = s + max_new_tokens
        max_len = max_length if max_length is not None \
            else ((need + 63) // 64) * 64
        if max_len < need:
            raise ValueError(
                f"max_length={max_len} < prompt + max_new_tokens "
                f"({need})")
        if seed is None:
            seed = int(torch.randint(0, 2 ** 31, (1,), generator=generator))
        # any int keys on its low 32 bits, as the reference's key does:
        # the int32 with those bits
        seed = (int(seed) + 2 ** 31) % 2 ** 32 - 2 ** 31
        sampler = (bool(do_sample), top_k, top_p, float(temperature))
        steps = self._decode_graph(b, max_len, sampler)
        g = steps.buffers
        for name, buf in g.items():
            if name == "seed":
                buf.fill_(int(seed))
            else:
                buf.zero_()
        # the prefill: eager, once a call (the prompt's own shape)
        self._graph_step(steps, sampler, input_ids)
        length = s
        for _ in range(1, max_new_tokens):
            _check_cache_room(length, 1, max_len)
            if steps.cuda:
                steps.replay("step")
            else:
                self._graph_step(steps, sampler)
            length += 1
        return torch.cat([input_ids.long(), g["out"][:, :max_new_tokens]],
                         dim=1)

    def _graph_step(self, steps, sampler, tokens=None):
        """One step of ``generate`` on its static buffers: the cached
        forward of ``tokens`` (default: the buffer of the last step's
        tokens) at the device offset ``cache_len``, the next token under
        the key ``(seed, fold)`` written at ``out[:, fold]`` and into the
        tokens buffer, then ``cache_len`` and ``fold`` advance. Nothing
        is read back to the host."""
        g = steps.buffers
        tokens = g["tokens"] if tokens is None else tokens
        caches = [(g[f"k{i}"], g[f"v{i}"])
                  for i in range(self.config.num_hidden_layers)]
        nxt, _, _ = self._decode_step(tokens, g["cache_len"], caches,
                                      (g["seed"], g["fold"]), sampler)
        g["out"].index_copy_(1, g["fold"], nxt)
        g["tokens"].copy_(nxt)
        g["cache_len"].add_(tokens.shape[1])
        g["fold"].add_(1)

    def _decode_graph(self, batch, max_len, sampler):
        """The :class:`~paddle_tpu_torch.ops._graphs.StepGraphs` of
        ``generate``'s decode step at (weights, sampler, batch, max_len),
        the reference's ``param_key`` and shape: the KV caches
        (:meth:`_empty_caches`), the tokens, the out buffer ``[batch,
        max_len]`` and the ``cache_len``, ``fold`` and ``seed`` scalars,
        and on the card the step's graph, captured when the set is made
        (its warm-up writes the zeroed buffers, which each call zeroes
        again). A graph reads the weights at the addresses it was
        captured with, so the key holds every parameter's and buffer's
        storage (address, dtype, device, shape), not the objects: after
        ``model.half()``, ``.to(...)`` or ``p.data = ...`` the next call
        captures anew. One set is kept a model, the last one used: a call
        at another key frees the old set's caches and graph."""
        key = (tuple((t.data_ptr(), t.dtype, t.device, tuple(t.shape))
                     for t in (*self.parameters(), *self.buffers())),
               sampler, batch, max_len)
        kept = self.__dict__.get("_decode_state")
        if kept is not None and kept[0] == key:
            return kept[1]
        self.__dict__.pop("_decode_state", None)   # frees the old set
        w = self.model.embed_tokens.weight
        steps = StepGraphs(w.device, name="generate.decode_step")
        for i, (kb, vb) in enumerate(self._empty_caches(batch, max_len)):
            steps.buffers[f"k{i}"], steps.buffers[f"v{i}"] = kb, vb
        steps.buffer("tokens", (batch, 1), torch.int64)
        steps.buffer("out", (batch, max_len), torch.int64)
        steps.buffer("cache_len", (1,), torch.int64)
        steps.buffer("fold", (1,), torch.int64)
        steps.buffer("seed", (1,), torch.int64)
        if steps.cuda:
            steps.capture("step", lambda: self._graph_step(steps, sampler),
                          signature=(sampler, batch, max_len))
        self.__dict__["_decode_state"] = (key, steps)
        return steps

    def _empty_caches(self, batch, max_len):
        """One zeroed ``(k_buf, v_buf)`` pair ``[batch, max_len, Hk, D]``
        per layer, in the embedding's dtype and on its device."""
        cfg = self.config
        w = self.model.embed_tokens.weight
        shape = (batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
        return [(torch.zeros(shape, dtype=w.dtype, device=w.device),
                 torch.zeros(shape, dtype=w.dtype, device=w.device))
                for _ in range(cfg.num_hidden_layers)]

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
