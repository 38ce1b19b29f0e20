"""Continuous-batching serving engine for the Llama family (port of
``paddle_tpu/inference/serving.py``).

Every engine step is ONE mixed dispatch over a token-packed batch:
prefill chunks of at most ``chunk_block`` tokens and single-token
decode rows share a ``chunk_budget``-token step (decode rows first,
then prompt chunks FIFO by admission; a long prompt may take several
chunk rows of one dispatch). Per layer the dispatch runs the attention
of :mod:`~paddle_tpu_torch.ops.ragged_paged_attention` by one of three
paths, which give bitwise the same pools and greedy tokens:

- rope-fused (the default): ONE call of ``fused_ragged_paged_attention``
  with the rope tables: rope on the packed pre-rope q/k, the write of
  the step's K/V into the shared page pools, and ragged paged attention;
- ``fused_rope=False`` (``PADDLE_TPU_FUSED_ROPE=0``): rope as its own
  op (``fused_rotary_position_embedding`` from the shared per-dispatch
  tables), q gathered into row blocks, then ``fused_ragged_paged_attention``
  on post-rope q and K (write + attention);
- ``fused_kv=False`` (``PADDLE_TPU_FUSED_KV=0``): the two-op path, rope
  as above, a scatter of the step's K/V into the pools (plain PyTorch
  indexing, :func:`_page_write` / :func:`_page_write_q8`), then the
  read-only ``ragged_paged_attention``.

``fused_rope`` needs ``fused_kv`` and an even head_dim; otherwise it is
demoted to the fused-KV path. Everything around the attention
(embedding, RMSNorm, projections, SwiGLU, the lm head at each row's last
token) is plain PyTorch, and so is the next-token rule: the greedy argmax
or, where a dispatch holds a sampled, biased or constrained row,
:func:`~paddle_tpu_torch.inference.sampling.sampled_next_tokens`, whose
Gumbel-max pass is one kernel launch.

Int8 KV pages: ``kv_dtype="int8"`` (or ``PADDLE_TPU_KV_DTYPE=int8``)
stores the pools as int8 with one f32 scale per (page, head, slot) in
``[P, Hk, page, 1]`` sidecars (:func:`.paged_cache.quantize_kv_int8` on
write, ``int8 * scale`` on read): a cached token costs about half its
bf16 bytes, so the same pool holds about twice the batch or context.

The row metadata is built on the host in numpy and copied to the device
once per dispatch, the sampler's per-row arrays with it (f32 fields as
their raw bits). The scheduler and its geometry (``chunk_block``
rounding, ``chunk_budget``, ``rows_cap``, the trash page) match the
reference engine, so both schedule the same rows.

Sampling (:class:`~paddle_tpu_torch.inference.sampling.SamplingParams`
on a :class:`Request`): each row's draw is keyed by (request seed, the
sampled token's position), so it does not depend on what else a dispatch
holds, and a request without a seed gets one from the engine's LCG at
admission, recorded on the request (``_seed``). A dispatch whose rows are
all greedy, with no bias and no constraint, runs the greedy argmax alone;
one with bias or constraint rows but no sampled row skips the sort and the
Gumbel pass. Constraint hooks run on the host once per request per
dispatch; a raising hook or an empty allowed set leaves the row
unconstrained, and an allowed set wider than ``sample_slots`` is cut to
its first ``sample_slots`` ids.

Weight-only int8 serving: ``weight_dtype="int8"`` (or
``PADDLE_TPU_WEIGHT_DTYPE=int8``) quantizes the model in place with
:func:`~paddle_tpu_torch.quant.format.quantize_model` unless it is
quantized already; the mixed step calls the projections and the MLP as
modules, so the int8 layers and the mixture-of-experts FFN need nothing
else from the engine.

Not in this slice (ROADMAP queue A, in order): the prefix cache, the
request lifecycle (deadlines, cancel, drain, the degradation ladder, the
watchdog), speculative decoding, CUDA-graph decode, the host KV tier.
Admission therefore reserves each request's worst-case pages up front
and raises :class:`AdmissionError` when they do not fit, and the engine
is driven from one thread.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from ..incubate.nn.functional import fused_rotary_position_embedding
from ..ops.ragged_paged_attention import (check_geometry,
                                          fused_ragged_paged_attention,
                                          fused_rope_geometry_ok,
                                          ragged_paged_attention, rope_tables)
from ..quant.format import (is_quantized, model_weight_block,
                            quantize_model, serving_weight_bytes)
from .paged_cache import PageAllocator, quantize_kv_int8
from .sampling import SamplingParams, sampled_next_tokens

__all__ = ["LlamaServingEngine", "Request", "AdmissionError"]


def _env_flag(name, default):
    """A boolean knob from the environment: anything but 0/false/off
    (any case) is on."""
    return os.environ.get(name, default).lower() not in ("0", "false", "off")


def _last_writer_index(page_ids, offs, page_slots):
    """For a scatter whose (page, slot) targets may repeat within one
    dispatch: each packed token's last writer, the greatest index with
    the same target. O(T^2) integer compares on the packed token axis."""
    t = page_ids.shape[0]
    key = page_ids.long() * page_slots + offs.long()
    eq = key[:, None] == key[None, :]
    ar = torch.arange(t, device=page_ids.device)
    return torch.where(eq, ar[None, :], -1).argmax(dim=1)


def _last_writer_values(new, page_ids, offs, page_slots):
    """Last-writer-wins: every duplicate's value is replaced by the last
    writer's, so the scatter's order among duplicates cannot matter."""
    return new[_last_writer_index(page_ids, offs, page_slots)]


def _page_write(pages, new, page_ids, offs, last=None):
    """Scatter ``new [T, Hk, D]`` into head-major ``pages [P, Hk, page,
    D]`` at ``(page_ids[t], h, offs[t])``, IN PLACE, cast to the pool
    dtype; duplicate targets resolve last-writer-wins (``last``: their
    :func:`_last_writer_index`, if the caller has it)."""
    if last is None:
        last = _last_writer_index(page_ids, offs, pages.shape[2])
    hidx = torch.arange(pages.shape[1], device=pages.device)[None, :]
    pages[page_ids.long()[:, None], hidx, offs.long()[:, None]] = \
        new[last].to(pages.dtype)
    return pages


def _page_write_q8(pages, scales, new, page_ids, offs, last=None):
    """Quantizing scatter for int8 pools, IN PLACE: ``new [T, Hk, D]``
    float goes through :func:`quantize_kv_int8`; the int8 values land in
    ``pages [P, Hk, page, D]`` and the per-(token, head) scale in
    ``scales [P, Hk, page, 1]`` at the same (page, head, slot). A slot's
    (int8, scale) pair is always one writer's (last-writer-wins, as in
    :func:`_page_write`)."""
    if last is None:
        last = _last_writer_index(page_ids, offs, pages.shape[2])
    q, sc = quantize_kv_int8(new[last])              # [T, Hk, D], [T, Hk]
    hidx = torch.arange(pages.shape[1], device=pages.device)[None, :]
    pi, oi = page_ids.long()[:, None], offs.long()[:, None]
    pages[pi, hidx, oi] = q
    scales[pi, hidx, oi, 0] = sc
    return pages, scales


class AdmissionError(MemoryError):
    """Typed admission rejection carrying queue/pool stats so callers
    can shed load or retry once capacity frees up."""

    def __init__(self, reason, live, max_batch, free_pages, num_pages,
                 retries=0, retry_after=None):
        msg = (f"{reason} (live={live}/{max_batch}, "
               f"free_pages={free_pages}/{num_pages}, retries={retries})")
        super().__init__(msg)
        self.reason = reason
        self.live = live
        self.max_batch = max_batch
        self.free_pages = free_pages
        self.num_pages = num_pages
        self.retries = retries
        self.retry_after = retry_after

    def __reduce__(self):
        return (type(self), (self.reason, self.live, self.max_batch,
                             self.free_pages, self.num_pages, self.retries,
                             self.retry_after))


class Request:
    """One generation request (``seq_id`` is assigned by the engine). The
    reference's signature and argument order.

    Args:
        prompt_ids: non-empty 1-D sequence of prompt token ids.
        max_new_tokens: generation budget, >= 1.
        eos_token_id: optional early-stop token (kept in the output).
        deadline, token_budget, priority, retry_budget: the reference's
            lifecycle knobs; validated as the reference validates them,
            and accepted only at their defaults (``None``, ``None``,
            ``0``, ``1``): deadlines, priorities and retries are ROADMAP
            item A5.
        sampling: ``None`` (greedy) or a
            :class:`~paddle_tpu_torch.inference.sampling.SamplingParams`,
            whose ``stop`` ids merge with ``stop``.
        stop: token ids that end generation before being appended.
        on_token: optional ``fn(request, token)`` fired after each
            appended token (the streaming hook); it runs on the engine's
            dispatch thread, and what it raises is swallowed.
    """

    def __init__(self, prompt_ids, max_new_tokens=16, eos_token_id=None,
                 deadline=None, token_budget=None, priority=0,
                 retry_budget=1, sampling=None, stop=(), on_token=None):
        self.prompt_ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        if self.prompt_ids.size == 0:
            raise ValueError(
                "prompt_ids is empty: a request needs at least one "
                "prompt token")
        if int(max_new_tokens) <= 0:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if deadline is not None and float(deadline) <= 0:
            raise ValueError(f"deadline must be > 0 seconds, "
                             f"got {deadline}")
        if token_budget is not None and float(token_budget) <= 0:
            raise ValueError(f"token_budget must be > 0 seconds/token, "
                             f"got {token_budget}")
        if int(retry_budget) < 0:
            raise ValueError(
                f"retry_budget must be >= 0, got {retry_budget}")
        lifecycle = {"deadline": deadline is not None,
                     "token_budget": token_budget is not None,
                     "priority": int(priority) != 0,
                     "retry_budget": int(retry_budget) != 1}
        asked = [k for k, v in lifecycle.items() if v]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: request deadlines, priorities and "
                f"retries are not ported yet (ROADMAP item A5)")
        if sampling is not None and not isinstance(sampling,
                                                  SamplingParams):
            raise ValueError(
                f"sampling must be a SamplingParams, got "
                f"{type(sampling).__name__}")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.deadline = None
        self.token_budget = None
        self.priority = 0
        self.retry_budget = 1
        self.sampling = sampling
        self.stop_set = frozenset(int(t) for t in (stop or ())) \
            | frozenset(sampling.stop if sampling else ())
        self.on_token = on_token
        self._seed = None             # resolved at first admission
        self.output_ids: list[int] = []
        self.seq_id = None
        self.done = False
        self.status = "pending"
        self.ttft = None              # seconds from admission to 1st token
        self._t_admit = None
        self._prefilled = 0           # prompt tokens written to pages


class LlamaServingEngine:
    """Continuous-batching engine over a
    :class:`~paddle_tpu_torch.models.llama.LlamaForCausalLM`; it runs on
    the model's device, with page pools in the model's dtype, or int8
    with f32 scale sidecars. The geometry arguments, ``weight_dtype``
    (None/"bf16": the model as it is; "int8": weight-only int8),
    ``weight_block``, ``kv_dtype`` (None: the model's dtype; "int8"),
    ``fused_kv`` and ``fused_rope`` (see the module docstring) mean what
    they mean in the reference engine, environment knobs included. The
    arguments are the reference's, in its order; ``burst`` is its alias
    of ``decode_ticks``. ``sampling`` (None: ``PADDLE_TPU_SAMPLING``,
    default on; off, sampled requests are refused) and ``sample_slots``
    (the bias/constraint slots of a row) are the reference's. The knobs
    of later slices (``prewarm``, the prefix cache's, ``admit_retries``,
    ``admit_backoff``, ``stuck_*``, the speculative decoder's and the KV
    tier's, with the reference's env knobs
    ``PADDLE_TPU_SERVING_PREWARM``, ``PADDLE_TPU_SPEC_K``,
    ``PADDLE_TPU_KV_TIER``) raise :class:`NotImplementedError` naming
    their ROADMAP A item when set off their defaults; ``prefix_cache``
    defaults off here until the prefix cache is ported (A4)."""

    #: decode steps between admission checks while prompts are pending
    DECODE_TICKS = 16

    def __init__(self, model, max_batch=16, page_size=16, num_pages=None,
                 max_pages_per_seq=None, chunk_budget=None,
                 chunk_block=None, decode_ticks=None, burst=None,
                 admit_retries=0, admit_backoff=0.005, stuck_factor=8.0,
                 stuck_min_timeout=30.0, prefix_cache=False,
                 prefix_cache_pages=None, prewarm=None, kv_dtype=None,
                 spec_k=None, spec_ngram=3, drafter_factory=None,
                 sampling=None, sample_slots=8, fused_kv=None,
                 fused_rope=None, weight_dtype=None, weight_block=None,
                 kv_tier=None, kv_tier_bytes=None):
        # the reference's fleet knobs, read as it reads them: a fleet that
        # sets them is told, not silently served without the feature
        if spec_k is None:
            spec_k = int(os.environ.get("PADDLE_TPU_SPEC_K", "0") or 0)
        if kv_tier is None:
            kv_tier = os.environ.get(
                "PADDLE_TPU_KV_TIER", "0").lower() in ("1", "true", "on")
        if prewarm is None:
            prewarm = os.environ.get(
                "PADDLE_TPU_SERVING_PREWARM", "0").lower() \
                in ("1", "true", "on", "auto")
        later = {"prewarm / PADDLE_TPU_SERVING_PREWARM": (prewarm, "A3"),
                 "prefix_cache": (prefix_cache, "A4"),
                 "prefix_cache_pages": (prefix_cache_pages is not None,
                                        "A4"),
                 "admit_retries": (admit_retries != 0, "A5"),
                 "admit_backoff": (admit_backoff != 0.005, "A5"),
                 "stuck_factor": (stuck_factor != 8.0, "A5"),
                 "stuck_min_timeout": (stuck_min_timeout != 30.0, "A5"),
                 "spec_k / PADDLE_TPU_SPEC_K": (int(spec_k) > 0, "A6"),
                 "spec_ngram": (spec_ngram != 3, "A6"),
                 "drafter_factory": (drafter_factory is not None, "A6"),
                 "kv_tier / PADDLE_TPU_KV_TIER": (kv_tier, "A7"),
                 "kv_tier_bytes": (kv_tier_bytes is not None, "A7")}
        asked = [f"{k} (ROADMAP item {item})"
                 for k, (on, item) in later.items() if on]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: not ported yet (ROADMAP queue A)")
        # the reference's sampling switch: off, sampled requests are
        # refused at admission (_validate)
        if sampling is None:
            sampling = _env_flag("PADDLE_TPU_SAMPLING", "1")
        self.sample_enabled = bool(sampling)
        # bias/constraint slots per row
        self.sample_slots = max(1, int(sample_slots))
        # auto-seed LCG for sampled requests that didn't pin a seed
        # (recorded on the request so the draw stays reproducible)
        self._auto_seed = int.from_bytes(os.urandom(4), "little") \
            % (2 ** 31)
        if weight_dtype is None:
            weight_dtype = os.environ.get("PADDLE_TPU_WEIGHT_DTYPE",
                                          "") or None
        if weight_dtype == "bf16":
            weight_dtype = None
        if weight_dtype not in (None, "int8"):
            raise ValueError(f"weight_dtype must be 'bf16' (model dtype) or "
                             f"'int8', got {weight_dtype!r}")
        # in place; a model quantized already is served as it is
        if weight_dtype == "int8" and not is_quantized(model):
            quantize_model(model, block=weight_block)
        self.weight_quant = bool(weight_dtype == "int8"
                                 or is_quantized(model))
        self.weight_block = model_weight_block(model) or 0
        wbytes, _, welems = serving_weight_bytes(model)
        self.weight_bytes_per_param = wbytes / max(welems, 1)
        if num_pages is None:
            num_pages = max_batch * 24 + 8
        self.model = model
        cfg = model.config
        self.max_batch = max_batch
        self.page_size = page_size
        # the reference rounds chunk_block so its [QB*group] query tile
        # stays sublane-aligned on the TPU; kept so both engines
        # schedule the same rows
        group = max(1, cfg.num_attention_heads
                    // max(1, cfg.num_key_value_heads))
        align = 8 // math.gcd(group, 8)
        qb = int(chunk_block) if chunk_block else min(
            32, max(8, 2 * page_size))
        self.chunk_block = -(-qb // align) * align
        budget = int(chunk_budget) if chunk_budget \
            else max(64, 4 * max_batch)
        self.chunk_budget = max(budget, 2 * max_batch, self.chunk_block)
        if decode_ticks is None and burst is not None:
            decode_ticks = burst      # the reference's legacy alias
        self.decode_ticks = int(decode_ticks) if decode_ticks \
            else self.DECODE_TICKS
        # every live sequence may hold one decode row; the remaining
        # budget splits into chunk rows
        self.rows_cap = max_batch + -(-self.chunk_budget
                                      // self.chunk_block)
        # page num_pages-1 is the trash page no table references
        self.alloc = PageAllocator(num_pages - 1, page_size,
                                   max_pages_per_seq)
        self.width = self.alloc.max_pages_per_seq
        self.trash_page = num_pages - 1
        param = next(model.parameters())
        self.device = param.device
        # int8 KV pages: quantize on write, dequantize in the attention's
        # page loop; the engine argument wins over PADDLE_TPU_KV_DTYPE
        if kv_dtype is None:
            kv_dtype = os.environ.get("PADDLE_TPU_KV_DTYPE", "") or None
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None (model dtype) or "
                             f"'int8', got {kv_dtype!r}")
        self.kv_quant = kv_dtype == "int8"
        # the fallback paths (module docstring); the rope-fused path
        # rides the fused KV write and needs an even head_dim
        if fused_kv is None:
            fused_kv = _env_flag("PADDLE_TPU_FUSED_KV", "1")
        self.fused_kv = bool(fused_kv)
        if fused_rope is None:
            fused_rope = _env_flag("PADDLE_TPU_FUSED_ROPE", "1")
        self.fused_rope = bool(fused_rope) and self.fused_kv \
            and fused_rope_geometry_ok(cfg.head_dim)
        hk, n_layers = cfg.num_key_value_heads, cfg.num_hidden_layers
        if self.device.type == "cuda":
            # a geometry the attention kernels cannot take fails here, not
            # at the first dispatch
            check_geometry(page_size, cfg.head_dim, param.dtype,
                           self.kv_quant)
        shape = (num_pages, hk, page_size, cfg.head_dim)
        pool_dt = torch.int8 if self.kv_quant else param.dtype
        self.k_pools = [torch.zeros(shape, dtype=pool_dt, device=self.device)
                        for _ in range(n_layers)]
        self.v_pools = [torch.zeros_like(k) for k in self.k_pools]
        # one f32 scale per (page, head, slot), indexed by the same page
        # ids as the pools
        sshape = (num_pages, hk, page_size, 1)
        self.k_scales = [torch.zeros(sshape, dtype=torch.float32,
                                     device=self.device)
                         for _ in range(n_layers)] if self.kv_quant else []
        self.v_scales = [torch.zeros_like(s) for s in self.k_scales]
        itemsize = torch.tensor([], dtype=pool_dt).element_size()
        tok_bytes = 2 * hk * cfg.head_dim * itemsize * n_layers
        if self.kv_quant:
            tok_bytes += 2 * hk * 4 * n_layers       # the scale sidecars
        self.kv_bytes_per_token = tok_bytes
        self._live: dict[int, Request] = {}
        self._next_id = 0
        self._dispatch_count = 0

    # ------------------------------------------------------------------
    # the mixed step: prefill chunks + decode rows, one dispatch
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _mixed_forward(self, tokens, pos, flat_idx, last_idx, tables,
                       kv_lens, q_starts, q_lens, w_starts, w_flats,
                       w_ends, page_ids, offs, row_tok, qb, sample=None):
        """ONE token-packed model step over ``T`` real tokens (prefill
        chunks and decode tokens back to back) and ``R`` rows; returns
        the next token of each row ``[R]`` at the row's last position.
        tokens/pos/flat_idx [T]; tables [R, W]; last_idx and the row
        metadata [R]; page_ids/offs [T] (the two-op scatter's targets)
        and row_tok [R, qb] (each row-block entry's packed token), which
        the rope-fused path leaves empty. ``sample``: None (every row
        greedy, no bias: the argmax) or ``(arrays, any_sampled)``, the
        per-row arguments of :func:`sampled_next_tokens` after the
        logits and whether a row is sampled."""
        m = self.model.model
        cfg = self.model.config
        t, r_rows = tokens.shape[0], tables.shape[0]
        x = m.embed_tokens(tokens.long())                  # [T, hidden]
        # rotary tables computed once per dispatch, shared by all layers
        rsin, rcos = rope_tables(pos, cfg.head_dim, float(cfg.rope_theta))
        flat = flat_idx.long()
        # the two-op scatter's last writers, the same in every layer
        last = None if self.fused_kv else _last_writer_index(
            page_ids, offs, self.page_size)
        for li, layer in enumerate(m.layers):
            h = layer.input_layernorm(x)
            att = layer.self_attn
            q = att.q_proj(h).reshape(t, att.num_heads, att.head_dim)
            k = att.k_proj(h).reshape(t, att.num_kv_heads, att.head_dim)
            v = att.v_proj(h).reshape(t, att.num_kv_heads, att.head_dim)
            kp, vp = self.k_pools[li], self.v_pools[li]
            sc = dict(k_scale=self.k_scales[li],
                      v_scale=self.v_scales[li]) if self.kv_quant else {}
            if self.fused_rope:
                attn4 = fused_ragged_paged_attention(
                    q, k, v, kp, vp, tables, kv_lens, q_starts, q_lens,
                    w_starts, w_flats, w_ends, self.trash_page,
                    rope_sin=rsin, rope_cos=rcos, qblock=qb, **sc)
            else:
                # rope as its own op, from the shared tables, then q
                # packed into the [R, qb] row blocks
                q, k, _ = fused_rotary_position_embedding(
                    q[None], k[None], sin=rsin, cos=rcos)
                q, k = q[0], k[0]
                q4 = q[row_tok]
                if self.fused_kv:
                    attn4 = fused_ragged_paged_attention(
                        q4, k, v, kp, vp, tables, kv_lens, q_starts,
                        q_lens, w_starts, w_flats, w_ends, self.trash_page,
                        **sc)
                else:
                    # two ops: scatter every row's K/V, then attend (a
                    # later chunk of a sequence reads what this wrote)
                    if self.kv_quant:
                        _page_write_q8(kp, sc["k_scale"], k, page_ids, offs,
                                       last)
                        _page_write_q8(vp, sc["v_scale"], v, page_ids, offs,
                                       last)
                    else:
                        _page_write(kp, k, page_ids, offs, last)
                        _page_write(vp, v, page_ids, offs, last)
                    attn4 = ragged_paged_attention(
                        q4, kp, vp, tables, kv_lens, q_starts, q_lens, **sc)
            attn = attn4.reshape(r_rows * qb, att.num_heads,
                                 att.head_dim)[flat]
            x = x + att.o_proj(attn.reshape(t, -1))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        x = m.norm(x)
        logits = self.model._logits(x[last_idx.long()])    # [R, V]
        if sample is None:
            return logits.argmax(dim=-1)
        arrays, any_sampled = sample
        return sampled_next_tokens(logits, *arrays, any_sampled=any_sampled)

    def _schedule_rows(self):
        """One mixed step's rows: a decode row for every fully
        prefilled live sequence, then prompt chunks of at most
        ``chunk_block`` tokens FIFO by admission until the
        ``chunk_budget`` (or ``rows_cap``) is spent. Each row is
        ``(req, sid, start, n, toks, is_decode)``."""
        live = [r for r in self._live.values() if not r.done]
        decode = [r for r in live if r._prefilled >= len(r.prompt_ids)]
        prefill = [r for r in live if r._prefilled < len(r.prompt_ids)]
        rows = []
        budget = self.chunk_budget
        for r in decode:
            # admission reserved this token's page (see _admit)
            prev = self.alloc.extend(r.seq_id, 1)
            tok = r.output_ids[-1] if r.output_ids \
                else int(r.prompt_ids[-1])
            rows.append((r, r.seq_id, prev, 1, (tok,), True))
            budget -= 1
        for r in prefill:
            if budget <= 0 or len(rows) >= self.rows_cap:
                break
            off = int(r._prefilled)
            n_total = len(r.prompt_ids)
            while off < n_total and budget > 0 \
                    and len(rows) < self.rows_cap:
                n = min(self.chunk_block, n_total - off, budget)
                toks = tuple(int(x) for x in r.prompt_ids[off:off + n])
                rows.append((r, r.seq_id, off, n, toks, False))
                off += n
                budget -= n
        return rows

    def _sample_arrays(self, rows):
        """The sampler's per-row arrays of one dispatch (numpy: temps,
        top_ps, top_ks, seeds, positions, slot_ids, slot_vals, cmodes)
        and whether any row is sampled, or None when every row is greedy
        with no bias and no constraint (as is every dispatch of an engine
        built with ``sampling=False``, which admits greedy requests only
        and ignores their bias, as the reference does). Constraint hooks
        run HERE, once per request: a raising hook or an empty allowed set
        leaves the row unconstrained, an allowed set wider than
        ``sample_slots`` is cut to its first ``sample_slots`` ids."""
        reqs = [row[0] for row in rows]
        if not self.sample_enabled or not any(r.sampling is not None and (
                r.sampling.temperature > 0 or r.sampling.logit_bias
                or r.sampling.constraint is not None) for r in reqs):
            return None
        r_n, b = len(rows), self.sample_slots
        temps = np.zeros((r_n,), np.float32)
        top_ps = np.ones((r_n,), np.float32)
        top_ks = np.zeros((r_n,), np.int32)
        seeds = np.zeros((r_n,), np.int32)
        # the sampled token's position: the row's last position + 1
        positions = np.array([start + n for _, _, start, n, _, _ in rows],
                             np.int32)
        slot_ids = np.full((r_n, b), -1, np.int32)
        slot_vals = np.zeros((r_n, b), np.float32)
        cmodes = np.zeros((r_n,), np.int32)
        allowed_of = {}
        for i, r in enumerate(reqs):
            sp = r.sampling
            if sp is None:
                continue
            temps[i] = sp.temperature
            top_ps[i] = sp.top_p
            top_ks[i] = sp.top_k
            seeds[i] = r._seed or 0
            bias = sp.logit_bias or {}
            if sp.constraint is not None and id(r) not in allowed_of:
                try:
                    allowed = sp.constraint(r.prompt_ids,
                                            tuple(r.output_ids))
                    allowed = None if allowed is None \
                        else [int(tk) for tk in allowed][:b]
                except Exception:
                    allowed = None       # the hook never kills a dispatch
                allowed_of[id(r)] = allowed
            ids = allowed_of.get(id(r))
            if ids:
                cmodes[i] = 1
                slot_ids[i, :len(ids)] = ids
                slot_vals[i, :len(ids)] = [bias.get(tk, 0.0) for tk in ids]
            elif bias:
                items = list(bias.items())[:b]
                slot_ids[i, :len(items)] = [tk for tk, _ in items]
                slot_vals[i, :len(items)] = [v for _, v in items]
        arrays = (temps, top_ps, top_ks, seeds, positions, slot_ids,
                  slot_vals, cmodes)
        return arrays, bool((temps > 0).any())

    def _dispatch_rows(self, rows):
        """Dispatch ONE mixed step over a scheduled row list and apply
        the results: prefill progress and emitted tokens. Returns tokens
        emitted."""
        needs_mixed = any(n > 1 or not is_dec
                          for _, _, _, n, _, is_dec in rows)
        qb = self.chunk_block if needs_mixed else 1
        r_n = len(rows)
        t_n = sum(n for _, _, _, n, _, _ in rows)
        tokens = np.zeros((t_n,), np.int32)
        pos = np.zeros((t_n,), np.int32)
        flat_idx = np.zeros((t_n,), np.int32)
        last_idx = np.zeros((r_n,), np.int32)
        tables = np.full((r_n, self.width), self.trash_page, np.int32)
        # kv_lens, q_starts, q_lens, w_starts, w_flats, w_ends
        meta = np.zeros((6, r_n), np.int32)
        # per sequence: the first position this dispatch writes and its
        # packed index, and the final kv_len (rows of one sequence are
        # consecutive)
        seq_first: dict[int, tuple] = {}
        seq_last: dict[int, int] = {}
        # the fallback paths' metadata: each token's page and slot, each
        # row-block entry's packed token (padding: token 0)
        fallback = not self.fused_rope
        page_ids = np.zeros((t_n if fallback else 0,), np.int32)
        offs = np.zeros_like(page_ids)
        row_tok = np.zeros((r_n if fallback else 0, qb), np.int32)
        t = 0
        for i, (r, sid, start, n, toks, is_dec) in enumerate(rows):
            tb = self.alloc._tables[sid]
            tables[i, :len(tb)] = tb
            meta[0:3, i] = (start + n, start, n)
            tokens[t:t + n] = toks
            pos[t:t + n] = start + np.arange(n)
            flat_idx[t:t + n] = i * qb + np.arange(n)
            if fallback:
                page_ids[t:t + n], offs[t:t + n] = \
                    self.alloc.page_positions(sid, start, n)
                row_tok[i, :n] = np.arange(t, t + n)
            seq_first.setdefault(sid, (start, t))
            seq_last[sid] = start + n
            t += n
            last_idx[i] = t - 1
        for i, (_, sid, *_) in enumerate(rows):
            meta[3:5, i] = seq_first[sid]
            meta[5, i] = seq_last[sid]
        parts = [tokens, pos, flat_idx, last_idx, tables.reshape(-1),
                 meta.reshape(-1), page_ids, offs, row_tok.reshape(-1)]
        samp = self._sample_arrays(rows)
        if samp is not None:
            # the sampler's rows ride the same copy, f32 fields as bits
            parts += [a.reshape(-1).view(np.int32) for a in samp[0]]
        dev = torch.from_numpy(np.concatenate(parts)).to(self.device)
        (tok_d, pos_d, flat_d, last_d, tables_d, meta_d, pid_d, off_d,
         rt_d, *samp_d) = dev.split([p.size for p in parts])
        tables_d = tables_d.view(r_n, self.width)
        kv_d, qs_d, ql_d, ws_d, wf_d, we_d = meta_d.view(6, r_n).unbind(0)
        rt_d = rt_d.view(-1, qb).long()
        sample = None
        if samp is not None:
            t_d, p_d, k_d, s_d, ps_d, si_d, sv_d, c_d = samp_d
            sample = ((t_d.view(torch.float32), p_d.view(torch.float32), k_d,
                       s_d, ps_d, si_d.view(r_n, -1),
                       sv_d.view(torch.float32).view(r_n, -1), c_d),
                      samp[1])
        nxt = self._mixed_forward(tok_d, pos_d, flat_d, last_d, tables_d,
                                  kv_d, qs_d, ql_d, ws_d, wf_d, we_d, pid_d,
                                  off_d, rt_d, qb, sample)
        out = nxt.tolist()
        for r, sid, start, n, _, is_dec in rows:
            if not is_dec and r.seq_id == sid:
                r._prefilled = max(r._prefilled, start + n)
        emitted = 0
        for i, (r, sid, start, n, _, is_dec) in enumerate(rows):
            if r.done or r.seq_id != sid:
                continue
            # decode rows emit; a prompt's FINAL chunk emits its first
            # token; a mid-prompt chunk's argmax is discarded
            if is_dec or start + n >= len(r.prompt_ids):
                self._emit(r, int(out[i]))
                emitted += 1
        return emitted

    # ------------------------------------------------------------------
    # admission, emission, driving
    # ------------------------------------------------------------------
    def _pages_needed(self, req):
        """Worst-case pages of a request: its prompt plus every decode
        token it may write (the last emitted token is never written)."""
        n = len(req.prompt_ids) + req.max_new_tokens - 1
        return max(1, -(-n // self.page_size))

    def _validate(self, req):
        """The reference's sampling checks: a sampled request needs
        ``sampling`` on, and its bias must fit ``sample_slots``."""
        sp = req.sampling
        if sp is not None:
            if not sp.is_greedy and not self.sample_enabled:
                raise ValueError(
                    "request asks for sampled decoding but this engine "
                    "was built with sampling=False; rebuild with "
                    "sampling=True (or unset PADDLE_TPU_SAMPLING=0)")
            if sp.logit_bias and len(sp.logit_bias) > self.sample_slots:
                raise ValueError(
                    f"logit_bias has {len(sp.logit_bias)} entries but "
                    f"this engine packs sample_slots={self.sample_slots}"
                    f" per row; raise sample_slots or trim the bias")

    def _seed(self, req):
        """Resolve the request's seed once: its own, else the next draw
        of the engine's LCG (recorded on the request)."""
        if req._seed is None:
            sp = req.sampling
            if sp is not None and sp.seed is not None:
                req._seed = sp.seed
            else:
                self._auto_seed = (self._auto_seed * 1103515245
                                   + 12345) % (2 ** 31)
                req._seed = self._auto_seed

    def _admit(self, req):
        """Admit one request, reserving its worst-case pages against
        what the live set may still draw. Raises :class:`ValueError`
        for a request that can never fit and :class:`AdmissionError`
        when it does not fit now."""
        if req.done:
            return req.seq_id
        self._validate(req)
        self._seed(req)
        need = self._pages_needed(req)
        cap = min(self.alloc.max_pages_per_seq, self.alloc.num_pages)
        if need > cap:
            raise ValueError(
                f"prompt of {len(req.prompt_ids)} tokens + "
                f"{req.max_new_tokens} new tokens needs {need} pages, "
                f"beyond this engine's {cap} pages per sequence; size "
                f"the pool up (num_pages/max_pages_per_seq)")
        live = [r for r in self._live.values() if not r.done]
        owed = sum(self._pages_needed(r)
                   - len(self.alloc._tables[r.seq_id]) for r in live)
        reason = None
        if len(live) >= self.max_batch:
            reason = "engine full"
        elif need + owed > self.alloc.free_pages:
            reason = "KV page pool exhausted"
        if reason:
            raise AdmissionError(reason, live=len(live),
                                 max_batch=self.max_batch,
                                 free_pages=self.alloc.free_pages,
                                 num_pages=self.alloc.num_pages)
        req.seq_id = self._next_id
        self._next_id += 1
        self.alloc.admit(req.seq_id, len(req.prompt_ids))
        req._prefilled = 0
        req.status = "live"
        req._t_admit = time.perf_counter()
        self._live[req.seq_id] = req
        return req.seq_id

    def _retire(self, req, status):
        if req.done:
            return
        req.done = True
        req.status = status
        if self._live.pop(req.seq_id, None) is not None:
            self.alloc.release(req.seq_id)

    def add_request(self, req):
        """Admit a request and drive its chunked prefill through to its
        first emitted token (live decodes ride along in the same
        dispatches). Returns its seq_id."""
        sid = self._admit(req)
        while not req.done and req._prefilled < len(req.prompt_ids):
            if self.step() == 0:
                break
        return sid

    def _emit(self, req, token):
        if not req.output_ids and req._t_admit is not None:
            req.ttft = time.perf_counter() - req._t_admit
        # stop tokens end generation before they are appended; eos is
        # appended, then ends it
        if token in req.stop_set:
            self._retire(req, "completed")
            return
        req.output_ids.append(token)
        if req.on_token is not None:
            try:
                req.on_token(req, token)
            except Exception:
                pass        # a streaming hook never kills a dispatch
        if (req.eos_token_id is not None and token == req.eos_token_id) \
                or len(req.output_ids) >= req.max_new_tokens:
            self._retire(req, "completed")

    def step(self):
        """Advance the engine by ONE mixed dispatch. Returns the number
        of rows dispatched (0 = nothing live)."""
        return self._mixed_step()[0]

    def _mixed_step(self):
        if not any(not r.done for r in self._live.values()):
            return 0, 0
        self._dispatch_count += 1
        rows = self._schedule_rows()
        if not rows:
            return 0, 0
        return len(rows), self._dispatch_rows(rows)

    def decode_many(self, n):
        """``n`` mixed steps for the current live set (chunks of
        still-prefilling prompts ride along). Returns tokens emitted."""
        served = 0
        while n > 0:
            rows, emitted = self._mixed_step()
            if rows == 0:
                break
            served += emitted
            n -= 1
        return served

    def generate(self, prompts, max_new_tokens=16, eos_token_id=None):
        """Admit all prompts (continuous batching handles ragged finish
        times), run to completion, return output id lists in order. A
        prompt that does not fit yet waits for live requests to retire;
        one that does not fit an idle engine raises. An entry of
        ``prompts`` may also be a :class:`Request` (its own budget
        applies), so the caller can read its ``ttft`` afterwards."""
        reqs = [p if isinstance(p, Request)
                else Request(p, max_new_tokens, eos_token_id)
                for p in prompts]
        pending = list(reqs)
        while pending or any(not r.done for r in reqs):
            while pending and len(self._live) < self.max_batch:
                try:
                    self._admit(pending[0])
                except AdmissionError:
                    if not self._live:
                        raise
                    break
                pending.pop(0)
            live = [r for r in self._live.values() if not r.done]
            if not live:
                continue
            if any(r._prefilled < len(r.prompt_ids) for r in live):
                self.step()
                continue
            # decode until the earliest possible retirement; with EOS or
            # pending admissions, re-check admission every decode_ticks
            run = min(r.max_new_tokens - len(r.output_ids) for r in live)
            if pending or eos_token_id is not None:
                run = min(run, self.decode_ticks)
            self.decode_many(max(1, run))
        return [r.output_ids for r in reqs]
