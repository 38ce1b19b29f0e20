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

:func:`shard_llama` places the weights over a mesh (tensor, fsdp and
expert parallelism) and the forward then runs on each rank's shards with
the Megatron collectives written out (:mod:`paddle_tpu_torch.distributed
.plan`): the flash kernels on the rank's own heads, the loss kernel on
its vocab shard, the grouped GEMM on its experts.
"""

from __future__ import annotations

import collections
import dataclasses
import os

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.recompute import recompute
from ..incubate.moe import _watched_fn_cache, group_sizes, top_k_routing
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
           "tiny_llama_config", "shard_llama"]


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
    #: True checkpoints every decoder layer; "dots" keeps the outputs of
    #: its products without batch dimensions and recomputes the rest
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

    #: the :class:`~paddle_tpu_torch.distributed.plan.ParallelPlan` of a
    #: placed weight (set by :func:`shard_llama`)
    plan = None

    def __init__(self, hidden_size, epsilon=1e-6, **factory):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, **factory))

    def forward(self, x):
        w = self.weight if self.plan is None else self.plan.local(self.weight)
        return FI.rms_norm(x, w, self.epsilon)


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
    forward's load-balancing loss (the model's loss never adds it).

    Each token count's forward is kept in a bounded LRU
    (:meth:`build_fn`), watched under ``moe_mlp`` as in the reference.

    Placed by :func:`shard_llama` (``plan``), every rank routes every
    token with the replicated router; with ``ep`` rank ``r`` holds experts
    ``[r E/ep, (r + 1) E/ep)`` and runs the grouped GEMM kernel over those
    experts' row groups only, with ``tp`` each expert's FFN width is
    split, and one ``all_reduce`` sums the ranks' partial outputs
    (:meth:`_forward2d`). The reference demotes a sharded expert
    stack to its XLA formulation, as GSPMD cannot partition its kernel;
    the port keeps the kernel on each rank's shard."""

    _WEIGHTS = ("gate_proj", "up_proj", "down_proj")
    #: set by :func:`shard_llama`
    plan = None
    #: bound on the per-token-count forward cache (LRU)
    FN_CACHE_SIZE = 8

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
        self._fns: "collections.OrderedDict[int, object]" = \
            collections.OrderedDict()

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
        self._fns.clear()

    def _apply(self, fn, recurse=True):
        if not self.weight_block:
            return super()._apply(fn, recurse)
        return keep_f32(self, fn, recurse,
                        tuple(n + "_scale" for n in self._WEIGHTS))

    def _local(self, t):
        """``t``'s compute view on this rank (itself unplaced)."""
        return t if self.plan is None else self.plan.local(t)

    def _products(self, x, gs):
        """The three grouped GEMMs with SwiGLU between them, over this
        rank's experts."""
        if not self.weight_block:
            wg, wu, wd = (self._local(getattr(self, n))
                          for n in self._WEIGHTS)
            g = grouped_gemm(x, wg, gs)
            u = grouped_gemm(x, wu, gs)
            return grouped_gemm(FI.swiglu(g, u), wd, gs)
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
        n = x2d.shape[0]
        logits = router_logits(x2d, self._local(self.gate))
        routing = top_k_routing(logits, self.top_k, n, normalize=True)
        return routing + (group_sizes(routing[1], routing[3],
                                      self.num_experts),)

    def _forward2d(self, x2d, *_weights):
        """Route every token, run this rank's experts' rows (all experts
        unplaced) through the three grouped GEMMs, and combine each
        token's terms in one fixed order. Placed, the input's and the
        routing weights' gradients and the output are summed over the tp
        and ep groups (class docstring)."""
        plan, n, k = self.plan, x2d.shape[0], self.top_k
        e = self.num_experts
        slot_token, expert_of, pos_of, keep, weights, aux, gs = \
            self.route(x2d)
        el, e0, axes = e, 0, ()
        if plan is not None:
            el = e // plan.size(plan.ep)
            e0 = plan.rank(plan.ep) * el
            axes = tuple(a for a in (plan.tp, plan.ep) if a is not None)
        for a in axes:
            x2d = plan.copy_to(x2d, a)
            weights = plan.copy_to(weights, a)
        if el < e:      # this rank's experts' rows and terms only
            gs = gs[e0:e0 + el]
            slot_token = slot_token[e0 * n:(e0 + el) * n]
            keep = keep & (expert_of >= e0) & (expert_of < e0 + el)
            expert_of = (expert_of - e0).clamp(0, el - 1)
        y = self._products(x2d[slot_token.clamp_min(0)], gs)   # [el*n, D]
        picked = y[expert_of * n + pos_of.clamp(0, n - 1)]     # [n, k, D]
        wk = (weights * keep).to(x2d.dtype).float()
        # the combine, one fixed order per token
        out = wk[:, 0, None] * picked[:, 0].float()
        for j in range(1, k):
            out = out + wk[:, j, None] * picked[:, j].float()
        for a in axes:
            out = plan.reduce_from(out, a)
        return out.to(x2d.dtype), aux

    def _state(self):
        """The tensors the forward reads, in the reference's argument
        order (they key its signature)."""
        names = ("gate",) + (self._WEIGHTS if not self.weight_block else
                             tuple(n + s for n in self._WEIGHTS
                                   for s in ("", "_scale")))
        return tuple(getattr(self, n) for n in names)

    def build_fn(self, n_tokens):
        """The forward for ``n_tokens`` tokens, ``fn(x2d, gate, *weights)
        -> (out, aux)`` (the int8 form passes each weight's scales after
        it), watched under ``moe_mlp``; the cache keeps the most recent
        :attr:`FN_CACHE_SIZE` token counts (LRU)."""
        return _watched_fn_cache(self._fns, int(n_tokens),
                                 lambda n: self._forward2d, "moe_mlp",
                                 self.FN_CACHE_SIZE)

    def forward(self, x):
        shape = x.shape
        x2d = x.reshape(-1, shape[-1])
        out, self.l_aux = self.build_fn(x2d.shape[0])(x2d, *self._state())
        return out.reshape(shape)


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

    #: the :class:`~paddle_tpu_torch.distributed.plan.ParallelPlan` of a
    #: model placed by :func:`shard_llama`
    plan = None

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
        w = self.model.embed_tokens.weight
        if self.plan is not None:
            plan = self.plan
            y = F.linear(plan.copy_to(hidden, plan.tp), plan.local(w))
            return plan.gather_from(y, plan.tp, -1)
        return torch.matmul(hidden, w.t())

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
            if self.plan is not None:
                # this rank's rows; the vocab shards merged over tp
                return self.plan.loss(hidden, self.lm_head.weight,
                                      labels), None
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
        # the attention's own head count: a tp rank's share when placed
        hk = self.model.layers[0].self_attn.num_kv_heads \
            if cfg.num_hidden_layers else cfg.num_key_value_heads
        shape = (batch, max_len, hk, cfg.head_dim)
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


def shard_llama(model: LlamaForCausalLM, mesh, tp_axis="mp", fsdp_axis=None,
                ep_axis=None):
    """Place a :class:`LlamaForCausalLM`'s weights over ``mesh`` (a
    :class:`~paddle_tpu_torch.distributed.ProcessMesh` of the started
    world) with the reference's placements, and make its forward run on
    each rank's shards:

    - attention q/k/v and the MLP's gate/up: column-parallel over
      ``tp_axis`` (each rank holds ``h / tp`` query and ``hk / tp`` kv
      heads, and the flash kernels run on those); o and down:
      row-parallel (the output summed over tp);
    - the embedding and the lm head: vocab-parallel; the loss kernel runs
      on each rank's vocab shard and the shards merge exactly;
    - ``fsdp_axis`` shards each matrix's other dimension (norms on it
      alone), gathered before use, the gradient reduce-scattered: ZeRO-3;
    - ``ep_axis`` (MoE models) shards the stacked ``[E, ...]`` expert
      weights on the expert dim; the router stays replicated.

    Every other mesh axis splits the batch (dp): each rank's loss is the
    mean over its own rows and each gradient is averaged over those axes
    once. A ``torch.nn.Linear`` weight is ``[out, in]`` where the
    reference's is ``[in, out]``, so each linear weight's tp and fsdp
    dims are the reference's swapped. The layers keep their parameter
    names (``state_dict`` keys and global shapes are the unplaced
    model's); build the optimizer after this call. A tp that does not
    divide the kv heads is refused, as the reference's placement would
    fail; so is any other dimension that a degree does not divide, and a
    quantized model."""
    from ..distributed import Replicate, Shard, shard_tensor
    from ..distributed.mp_layers import ShardedEmbedding, ShardedLinear
    from ..distributed.plan import ParallelPlan

    cfg = model.config
    if ep_axis and not cfg.moe_num_experts:
        raise ValueError(
            "ep_axis shards stacked expert weights, but this config has "
            "moe_num_experts == 0 (dense FFN) — nothing to shard")
    if model.plan is not None:
        raise ValueError("this model is placed over a mesh already")
    for axis in (tp_axis, fsdp_axis, ep_axis):
        if axis is not None and axis not in mesh.dim_names:
            raise ValueError(f"mesh {mesh} has no axis {axis!r}")
    tp, fs, ep = (1 if a is None else mesh.get_dim_size(a)
                  for a in (tp_axis, fsdp_axis, ep_axis))
    ffn = (cfg.moe_intermediate_size or cfg.intermediate_size) \
        if cfg.moe_num_experts else cfg.intermediate_size
    need = [("num_key_value_heads", cfg.num_key_value_heads, tp),
            ("num_attention_heads", cfg.num_attention_heads, tp),
            ("vocab_size", cfg.vocab_size, tp),
            ("the FFN width", ffn, tp),
            ("hidden_size", cfg.hidden_size, fs)]
    if cfg.moe_num_experts:
        need.append(("moe_num_experts", cfg.moe_num_experts, ep))
    for what, n, degree in need:
        if n % degree:
            raise ValueError(f"{what} = {n} does not split over {degree} "
                             "ranks")
    plan = ParallelPlan(mesh, tp=tp_axis, ep=ep_axis, fsdp=fsdp_axis)
    names = mesh.dim_names
    tp_dim = names.index(tp_axis) if tp_axis else None
    fs_dim = names.index(fsdp_axis) if fsdp_axis else None
    ep_dim = names.index(ep_axis) if ep_axis else None

    def place(t, tp_tensor_dim, fsdp_tensor_dim, ep_tensor_dim=None):
        p = [Replicate()] * mesh.ndim
        if tp_dim is not None and tp_tensor_dim is not None:
            p[tp_dim] = Shard(tp_tensor_dim)
        if fs_dim is not None and fsdp_tensor_dim is not None:
            p[fs_dim] = Shard(fsdp_tensor_dim)
        if ep_dim is not None and ep_tensor_dim is not None:
            p[ep_dim] = Shard(ep_tensor_dim)
        return shard_tensor(t, mesh, p)

    def linear(lin, style, gather_output=False):
        # [out, in]: column splits out (dim 0) over tp, fsdp the other
        dims = (0, 1) if style == "column" else (1, 0)
        return ShardedLinear(place(lin.weight, *dims), plan, style,
                             gather_output=gather_output)

    def norm(mod):
        mod.weight = place(mod.weight, None, 0)
        mod.plan = plan

    m = model.model
    m.embed_tokens = ShardedEmbedding(place(m.embed_tokens.weight, 0, 1),
                                      plan)
    if model.lm_head is not None:
        model.lm_head = linear(model.lm_head, "column", gather_output=True)
    for layer in m.layers:
        a, mlp = layer.self_attn, layer.mlp
        a.q_proj = linear(a.q_proj, "column")
        a.k_proj = linear(a.k_proj, "column")
        a.v_proj = linear(a.v_proj, "column")
        a.o_proj = linear(a.o_proj, "row")
        a.num_heads = cfg.num_attention_heads // tp
        a.num_kv_heads = cfg.num_key_value_heads // tp
        if isinstance(mlp, LlamaMoEMLP):
            if mlp.weight_block:
                raise ValueError("shard_llama places float weights; "
                                 "quantize after training")
            # stacked [E, in, out] (the reference's layout): tp splits the
            # FFN width, fsdp the model width, ep the experts
            mlp.gate = place(mlp.gate, None, 0)
            mlp.gate_proj = place(mlp.gate_proj, 2, 1, 0)
            mlp.up_proj = place(mlp.up_proj, 2, 1, 0)
            mlp.down_proj = place(mlp.down_proj, 1, 2, 0)
            mlp.plan = plan
            mlp._fns.clear()
        else:
            mlp.gate_proj = linear(mlp.gate_proj, "column")
            mlp.up_proj = linear(mlp.up_proj, "column")
            mlp.down_proj = linear(mlp.down_proj, "row")
        norm(layer.input_layernorm)
        norm(layer.post_attention_layernorm)
    norm(m.norm)
    model.plan = plan
    return model
