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

Decode scans (the reference's ``lax.scan`` decode): once no live prompt
is still prefilling, :meth:`LlamaServingEngine.decode_many` runs scans of
``decode_ticks`` ticks, then of ``max(decode_ticks // 4, 2)``, then single
mixed steps, as the reference does. A tick is :meth:`_mixed_forward` at the
decode-only shape (``max_batch`` rows of one token, rows past the live ones
padded as the reference pads them: tables full of the trash page, ``lens``
1, token 0) over static buffers, with its write positions, rope tables and
the sampler's positions derived on the device from the carry (tokens,
lens). On the card each tick mode (greedy argmax, bias only, sampled) is
one CUDA graph (:mod:`paddle_tpu_torch.ops._graphs`), captured once and
replayed every tick; a scan reads its tokens back once. The scan's inputs
go to the card in one copy. ``decode_ticks=1`` takes single
steps only. ``prewarm`` captures the tick graphs and runs a dummy mixed
dispatch ahead of traffic.

Shared-prefix KV cache (``prefix_cache=True``, the default): page-aligned
prompt prefixes are content-addressed (:mod:`.prefix_cache`). A prompt's
full pages are pinned once its prefill completes, and a later prompt
sharing that prefix admits against the cached pages (refcounted in
:class:`~.paged_cache.PageAllocator`, copied on write into a shared page
by :meth:`LlamaServingEngine._copy_page`), so only the un-cached suffix
runs through the model. Under pool pressure cached pages go back to the
pool before the degradation ladder touches a live request.

Request lifecycle: ``status`` moves ``pending`` -> ``live`` -> one of
``completed`` / ``deadline_exceeded`` / ``cancelled`` / ``requeued``
(evicted under pressure, will retry) / ``evicted`` (retry budget spent);
a terminal failure carries a typed error in ``req.error``. Deadlines
(``Request(deadline=, token_budget=)``) are enforced at step and scan
boundaries; :meth:`LlamaServingEngine.cancel` is thread-safe and
idempotent; admission walks the degradation ladder (cache reclaim, trim,
evict / requeue, backoff, shed with a ``retry_after`` hint) and decode
boundaries relieve pressure the same way (:meth:`_relieve_pressure`);
:meth:`drain` stops admission and finishes or expires the in-flight set;
a stuck-dispatch watchdog guards warm dispatches. Fault points
``serve.admit`` / ``serve.decode`` / ``serve.drain``
(:mod:`~paddle_tpu_torch.testing.faults`) make each path reproducible.

Page releases requested while a dispatch is in flight (a cancel from
another thread, an expiry or eviction) are deferred past it. On the card
the pools are written in place by kernels queued on one stream (the
current stream, which the tick graphs' replays use too), so a released
page handed to a new owner is only ever written after the old owner's
kernels in stream order.

Speculative decoding (``spec_k > 0``, or ``PADDLE_TPU_SPEC_K``): every
fully prefilled decoder may carry up to ``spec_k`` draft tokens from a
per-sequence drafter (:class:`~.speculative.NGramDrafter` over the
request's own prompt and output, or ``drafter_factory``'s). The scheduler
packs the row into the mixed step as a ``q_len = 1 + drafts`` decode row,
written through the ragged kernels like a prefill chunk; the dispatch
reads the next token at EVERY packed position (the greedy argmax, or the
draw keyed by that position, so speculation never changes a seeded draw)
and accepts the longest prefix of drafts that equals it. The rejected
tail's pages roll back on the host (:meth:`.paged_cache.PageAllocator
.rollback`): its slots stay written in kept pages, masked by ``kv_len``
until the next dispatch overwrites them. :meth:`LlamaServingEngine
.decode_many` rides speculation on single mixed steps while the drafter
proposes and falls back to short, then full decode scans when it does
not.

Not in this slice (ROADMAP queue A, in order): the host KV tier (and
with it the ladder's pause rung), the metrics.
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
import signal as _signal
import threading
import time

import numpy as np
import torch

from ..incubate.nn.functional import fused_rotary_position_embedding
from ..ops._graphs import StepGraphs
from ..ops.ragged_paged_attention import (check_geometry,
                                          fused_ragged_paged_attention,
                                          fused_rope_geometry_ok,
                                          ragged_paged_attention, rope_tables)
from ..quant.format import (is_quantized, model_weight_block,
                            quantize_model, serving_weight_bytes)
from ..testing import faults as _faults
from .paged_cache import PageAllocator, quantize_kv_int8
from .prefix_cache import PrefixCache
from .sampling import SamplingParams, sampled_next_tokens
from .speculative import NGramDrafter

__all__ = ["LlamaServingEngine", "Request", "AdmissionError",
           "DeadlineExceeded"]

#: Cross-ENGINE dispatch serializer: each dispatch body takes it inside its
#: own ``_dispatch_lock`` (own lock first, this one second: no cycle), as
#: the reference does, so engine instances driven from different threads
#: never interleave their dispatches. Re-entrant because a step's requeue
#: pump may prefill.
_CROSS_ENGINE_LOCK = threading.RLock()


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
    can shed load or retry once capacity frees up. ``retry_after``
    (seconds, may be None) estimates when capacity frees up: the live
    set's shortest remaining token budget times the recent per-token
    latency."""

    def __init__(self, reason, live, max_batch, free_pages, num_pages,
                 retries=0, retry_after=None):
        msg = (f"{reason} (live={live}/{max_batch}, "
               f"free_pages={free_pages}/{num_pages}, retries={retries})")
        if retry_after is not None:
            msg += f" — retry after {retry_after:.3f}s"
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


class DeadlineExceeded(TimeoutError):
    """Typed terminal result of a request that ran out of wall-clock
    budget (TTL, per-token budget, or the drain grace window). The
    partial output stays on ``request.output_ids``; this error on
    ``request.error`` says why it is partial."""

    def __init__(self, msg, seq_id=None, elapsed=None, tokens_emitted=0,
                 reason="deadline"):
        super().__init__(msg)
        self.seq_id = seq_id
        self.elapsed = elapsed
        self.tokens_emitted = tokens_emitted
        self.reason = reason

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",
                             self.seq_id, self.elapsed,
                             self.tokens_emitted, self.reason))


class Request:
    """One generation request (``seq_id`` is assigned by the engine). The
    reference's signature and argument order.

    Args:
        prompt_ids: non-empty 1-D sequence of prompt token ids.
        max_new_tokens: generation budget, >= 1.
        eos_token_id: optional early-stop token (kept in the output).
        deadline: wall-clock TTL in seconds, measured from admission.
            Past it the request is expired at the next step/scan
            boundary: its pages are released and ``error`` is set to a
            :class:`DeadlineExceeded` (partial output kept).
        token_budget: seconds allowed per generated token, an
            alternative deadline of ``token_budget * max_new_tokens``
            from admission; the tighter of the two wins.
        priority: higher values win under pressure; the degradation
            ladder only trims/evicts strictly lower-priority requests.
        retry_budget: how many times the request may be evicted and
            re-queued before it fails for good (status ``evicted``).
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
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.deadline = None if deadline is None else float(deadline)
        self.token_budget = None if token_budget is None \
            else float(token_budget)
        self.priority = int(priority)
        self.retry_budget = int(retry_budget)
        if sampling is not None and not isinstance(sampling,
                                                  SamplingParams):
            raise ValueError(
                f"sampling must be a SamplingParams, got "
                f"{type(sampling).__name__}")
        self.sampling = sampling
        self.stop_set = frozenset(int(t) for t in (stop or ())) \
            | frozenset(sampling.stop if sampling else ())
        self.on_token = on_token
        self._seed = None             # resolved at first admission
        self.output_ids: list[int] = []
        self.seq_id = None
        self.done = False
        self.status = "pending"
        self.error = None             # typed terminal failure, or None
        self.trimmed = False          # budget cut by the ladder
        self.ttft = None              # seconds from admission to 1st token
        self._t_admit = None          # set at admission; drives TTFT
        self._expires_at = None       # perf_counter stamp, or None
        self._cancel_requested = False  # honored at (re-)admission
        self._cached_tokens = 0       # prefix tokens served from cache
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
    (the bias/constraint slots of a row) are the reference's.
    ``prewarm`` (None: ``PADDLE_TPU_SERVING_PREWARM``, on for 1, true,
    on or auto) calls :meth:`prewarm` at the end of construction, as the
    reference does. ``prefix_cache`` (default on) and
    ``prefix_cache_pages`` (a cap on cached pages) are the shared-prefix
    cache's; ``admit_retries`` / ``admit_backoff`` bound admission's
    backoff before a shed; ``stuck_factor`` / ``stuck_min_timeout`` set
    the stuck-dispatch watchdog's timeout (``stuck_factor`` x the warm
    dispatches' P99, at least ``stuck_min_timeout``; 0 or None disables
    it). ``spec_k`` (None: ``PADDLE_TPU_SPEC_K``, default 0 = off; capped
    at ``chunk_block - 1``) is the most draft tokens a decode row carries,
    ``spec_ngram`` the n of the default :class:`~.speculative.NGramDrafter`
    and ``drafter_factory`` a zero-argument callable making one drafter a
    sequence in its place (see the module docstring). The KV tier's knobs
    (``kv_tier``, with the reference's env knob ``PADDLE_TPU_KV_TIER``,
    and ``kv_tier_bytes``) raise :class:`NotImplementedError` naming their
    ROADMAP A item when set off their defaults."""

    #: decode steps between admission checks while prompts are pending
    DECODE_TICKS = 16

    def __init__(self, model, max_batch=16, page_size=16, num_pages=None,
                 max_pages_per_seq=None, chunk_budget=None,
                 chunk_block=None, decode_ticks=None, burst=None,
                 admit_retries=0, admit_backoff=0.005, stuck_factor=8.0,
                 stuck_min_timeout=30.0, prefix_cache=True,
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
        later = {"kv_tier / PADDLE_TPU_KV_TIER": (kv_tier, "A7"),
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
        self._drafter_factory = drafter_factory or \
            (lambda: NGramDrafter(n=spec_ngram))
        self._spec_state: dict[int, object] = {}   # seq_id -> drafter
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_idle = 0     # consecutive no-proposal probes
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
        # a verify row (one guaranteed token + drafts) fits one row block
        self.spec_k = max(0, min(int(spec_k), self.chunk_block - 1))
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
        # admission backpressure: this many retries (exponential backoff
        # from admit_backoff seconds) before a typed rejection; they help
        # only when another thread drives the engine meanwhile
        self.admit_retries = int(admit_retries)
        self.admit_backoff = float(admit_backoff)
        # the stuck-dispatch watchdog (_arm_watchdog)
        self.stuck_factor = stuck_factor
        self.stuck_min_timeout = float(stuck_min_timeout)
        # page num_pages-1 is the trash page no table references
        self.alloc = PageAllocator(num_pages - 1, page_size,
                                   max_pages_per_seq)
        self.width = self.alloc.max_pages_per_seq
        self.trash_page = num_pages - 1
        # page-aligned prompt prefixes prefilled once, later admissions
        # referencing the cached pages (refcounted in the allocator)
        self.prefix = PrefixCache(self.alloc, page_size,
                                  max_pages=prefix_cache_pages) \
            if prefix_cache else None
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
        # lifecycle state: one re-entrant lock guards _live, the requeue,
        # deferred releases and entry accounting, so cancel() and drain
        # handlers may fire from any thread; the dispatch lock serializes
        # step / scan bodies (re-entrant: a step's requeue pump prefills)
        self._lock = threading.RLock()
        self._dispatch_lock = threading.RLock()
        self._requeue: collections.deque[Request] = collections.deque()
        self._deferred_release: list[int] = []
        self._in_dispatch = False
        self._entry_depth = 0
        self._entry_threads: dict[object, int] = {}   # thread -> depth
        self._flushing = False
        self._draining = False
        self._drain_active = False
        self._pending_drain = None    # (grace, exit_code, on_drained)
        self._dispatch_count = 0
        self._warmed_keys: set = set()  # ("mixed", T) / ("scan", n) run
        self._dispatch_times: collections.deque[float] = \
            collections.deque(maxlen=256)
        self._token_times: collections.deque[float] = \
            collections.deque(maxlen=512)
        self._wd = None
        self._closed = False
        # the decode scan's static buffers and, on the card, its tick graphs
        self._graphs = StepGraphs(self.device)
        self.prewarmed = None         # prewarm() summary, or None
        if prewarm is None:
            prewarm = os.environ.get(
                "PADDLE_TPU_SERVING_PREWARM", "0").lower() \
                in ("1", "true", "on", "auto")
        if prewarm:
            self.prewarm()

    # ------------------------------------------------------------------
    # lifecycle plumbing
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _entry(self):
        """Depth accounting around public entry points. A SIGTERM that
        lands while an entry is in flight defers its drain to the moment
        the outermost entry returns; and every thread inside an entry is
        recorded, so page releases requested while a DIFFERENT thread is
        mid-entry are deferred past the whole entry (its step may still
        read the allocator's tables for those sequences)."""
        me = threading.current_thread()
        with self._lock:
            self._entry_depth += 1
            self._entry_threads[me] = self._entry_threads.get(me, 0) + 1
        try:
            yield
        finally:
            with self._lock:
                self._entry_depth -= 1
                c = self._entry_threads.get(me, 1) - 1
                if c:
                    self._entry_threads[me] = c
                else:
                    self._entry_threads.pop(me, None)
                at_boundary = self._entry_depth == 0
                if at_boundary:
                    # the SIGTERM handler keeps deferring its drain past
                    # the flush below
                    self._flushing = True
            if at_boundary:
                try:
                    self._flush_deferred()
                finally:
                    with self._lock:
                        self._flushing = False
                        pending = None
                        # a manual drain mid-flight runs it in its epilogue
                        if self._entry_depth == 0 \
                                and not self._drain_active:
                            pending = self._pending_drain
                            if pending is not None:
                                self._pending_drain = None
                    if pending is not None:
                        grace, exit_code, on_drained = pending
                        self._run_drain_and_exit(grace, exit_code,
                                                 on_drained)

    def _release_pages(self, seq_id):
        """Release a sequence's pages, deferred while a dispatch is in
        flight (its kernels, or a scan's tick tables, may still address
        them) and while ANOTHER thread is inside an engine entry (its
        setup may still read the allocator for this sequence)."""
        if seq_id is None:
            return
        me = threading.current_thread()
        with self._lock:
            others_in_entry = any(t is not me for t in self._entry_threads)
            if self._in_dispatch or others_in_entry:
                self._deferred_release.append(seq_id)
            else:
                self.alloc.release(seq_id)

    def _flush_deferred(self):
        """Release the deferred sequences. Their pages may go to a new
        owner at once: every later write into them (a copy-on-write copy,
        a prefill chunk, a tick replay) is queued on the same stream after
        the kernels that last used them, so stream order, not this host
        call, keeps the old owner's reads whole."""
        with self._lock:
            if self._in_dispatch:
                return      # the dispatch's own epilogue will flush
            pending, self._deferred_release = self._deferred_release, []
        for sid in pending:
            # idempotent: racing a natural completion is a no-op
            self.alloc.release(sid)

    def _retire(self, req, status, error=None):
        """Terminal transition: remove from the live set, free pages,
        stamp status/error. Idempotent under the engine lock."""
        with self._lock:
            if req.done:
                return False
            req.done = True
            req.status = status
            req.error = error
            self._spec_state.pop(req.seq_id, None)
            if req.seq_id in self._live:
                del self._live[req.seq_id]
                self._release_pages(req.seq_id)
            return True

    def _expire(self, req, reason="deadline", now=None):
        now = time.perf_counter() if now is None else now
        elapsed = None if req._t_admit is None else now - req._t_admit
        err = DeadlineExceeded(
            f"request {req.seq_id} exceeded its {reason} after "
            f"{0.0 if elapsed is None else elapsed:.3f}s "
            f"({len(req.output_ids)}/{req.max_new_tokens} tokens "
            f"emitted)", seq_id=req.seq_id, elapsed=elapsed,
            tokens_emitted=len(req.output_ids), reason=reason)
        self._retire(req, "deadline_exceeded", err)

    def _expire_deadlines(self):
        """Expire every live request past its deadline; called at step
        and scan boundaries (the granularity that exists once a dispatch
        is on the card)."""
        now = time.perf_counter()
        with self._lock:
            expired = [r for r in self._live.values()
                       if not r.done and r._expires_at is not None
                       and now >= r._expires_at]
        for r in expired:
            self._expire(r, now=now)

    def cancel(self, req):
        """Cancel a live request (by :class:`Request` or seq_id).

        Thread-safe and idempotent: wire it to a client-abandon callback.
        The request retires with status ``"cancelled"`` and its partial
        output intact; its pages return to the allocator (deferred past
        any in-flight dispatch). Reaches requests parked on the eviction
        requeue too, and one popped mid re-admission (the sticky flag is
        honored there). Returns True if this call did the cancellation,
        False if the request was already terminal or unknown."""
        with self._entry():
            with self._lock:
                if isinstance(req, Request):
                    r = req
                    if r.done:
                        return False
                    r._cancel_requested = True
                    if r in self._requeue:
                        self._requeue.remove(r)
                        r.done = True
                        r.status = "cancelled"
                        return True
                    if r.seq_id is None \
                            or self._live.get(r.seq_id) is not r:
                        if r.status == "pending":
                            # never admitted: terminal right away
                            r.done = True
                            r.status = "cancelled"
                        # else: popped by the requeue pump mid
                        # re-admission; the flag is honored there
                        return True
                else:
                    r = self._live.get(req)
                    if r is None or r.done:
                        return False
                return self._retire(r, "cancelled")

    # ------------------------------------------------------------------
    # the mixed step: prefill chunks + decode rows, one dispatch
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _mixed_forward(self, tokens, pos, flat_idx, last_idx, tables,
                       kv_lens, q_starts, q_lens, w_starts, w_flats,
                       w_ends, page_ids, offs, row_tok, qb, sample=None):
        """ONE token-packed model step over ``T`` real tokens (prefill
        chunks, decode and verify tokens back to back) and ``R`` rows;
        returns the next token of each row ``[R]`` at the row's last
        position or, on a speculative engine's chunk-shaped dispatch
        (``spec_k > 0`` and ``qb > 1``), the next token after EVERY
        packed position ``[T]``, what verification compares drafts
        against. tokens/pos/flat_idx [T]; tables [R, W]; last_idx and the
        row metadata [R]; page_ids/offs [T] (the two-op scatter's targets)
        and row_tok [R, qb] (each row-block entry's packed token), which
        the rope-fused path leaves empty. ``sample``: None (every row
        greedy, no bias: the argmax) or ``(arrays, any_sampled)``, the
        per-row arguments of :func:`sampled_next_tokens` after the
        logits and whether a row is sampled; by position, each token's
        row parameters are gathered through ``flat_idx // qb`` and the
        positions are per token ``[T]``."""
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
        by_pos = bool(self.spec_k) and qb > 1
        # verification reads every position; otherwise the lm head runs
        # at each row's last token only
        logits = self.model._logits(x if by_pos else x[last_idx.long()])
        if sample is None:
            return logits.argmax(dim=-1)
        arrays, any_sampled = sample
        if by_pos:
            # token t belongs to row flat_idx[t] // qb; the positions are
            # per token already
            row = flat // qb
            arrays = tuple(a if j == 4 else a[row]
                           for j, a in enumerate(arrays))
        return sampled_next_tokens(logits, *arrays, any_sampled=any_sampled)

    def _prefix_insert(self, reqs, sids):
        """Pin freshly written full prompt pages in the prefix cache (one
        allocator reference each) so they outlive the requests."""
        with self._lock:
            for r, sid in zip(reqs, sids):
                if r.done or r.seq_id != sid:
                    continue
                table = self.alloc._tables.get(sid)
                if table:
                    self.prefix.insert(r.prompt_ids, table)

    def _copy_page(self, old, new):
        """Copy one page's K/V in every layer, the payload of a
        :meth:`PageAllocator.ensure_writable` copy-on-write; int8 pools
        copy their scale sidecars with the page. In place, on the current
        stream: the tick graphs baked the pools' addresses, so a pool is
        never rebound."""
        for pools in (self.k_pools, self.v_pools, self.k_scales,
                      self.v_scales):
            for pool in pools:
                pool[new].copy_(pool[old])

    def _draft(self, r, kcap):
        """Up to ``kcap`` draft tokens for a live decoder from its
        per-sequence drafter (made lazily, synced to the committed prompt
        and output only, never to rejected drafts). A proposal outside
        the vocabulary stops the drafts at the first offender.
        Constrained requests never draft: the hook runs once per
        dispatch, so it cannot be consulted at draft positions."""
        if r.sampling is not None and r.sampling.constraint is not None:
            return ()
        st = self._spec_state.get(r.seq_id)
        if st is None:
            st = self._spec_state[r.seq_id] = self._drafter_factory()
        st.sync(r.prompt_ids, r.output_ids)
        v = self.model.config.vocab_size
        out = []
        for t in st.propose(kcap):
            t = int(t)
            if not 0 <= t < v:
                break
            out.append(t)
        return tuple(out[:int(kcap)])

    def _spec_worth(self, live):
        """Probe (caller holds the engine lock): does a live decoder have
        at least one draft to verify? A proposal is pure (``sync`` folds
        committed tokens only), so a probe never skews the drafter. When
        nothing proposes, a speculative step would be a one-token step,
        and :meth:`decode_many` scans instead."""
        for r in live:
            if r.max_new_tokens - len(r.output_ids) <= 1:
                continue
            if self._draft(r, 1):
                return True
        return False

    def spec_stats(self):
        """Cumulative speculative-decoding counters: draft tokens
        proposed and accepted, and the acceptance rate."""
        with self._lock:
            p, a = self._spec_proposed, self._spec_accepted
        return {"k": self.spec_k, "proposed": p, "accepted": a,
                "accept_rate": a / p if p else 0.0}

    def _schedule_rows(self):
        """One mixed step's rows (caller holds the engine lock): a decode
        row for every fully prefilled live sequence that the pool can
        grow (:meth:`_relieve_pressure`), with up to ``spec_k`` drafts
        where the drafter proposes and pages and budget allow (a verify
        row of ``1 + drafts`` tokens), then prompt chunks of at most
        ``chunk_block`` tokens FIFO by admission until the
        ``chunk_budget`` (or ``rows_cap``) is spent. Returns ``(rows,
        cow)``: each row is ``(req, sid, start, n, toks, is_decode)``,
        ``cow`` the ``(old, new)`` page copies the rows' first write
        positions need (a shared page is never written)."""
        live = [r for r in self._live.values() if not r.done]
        decode = [r for r in live if r._prefilled >= len(r.prompt_ids)]
        prefill = [r for r in live if r._prefilled < len(r.prompt_ids)]
        decode = self._relieve_pressure(decode, 1)
        rows, cow = [], []
        budget = self.chunk_budget
        page = self.page_size
        # page headroom for drafts: _relieve_pressure proved ONE token a
        # decode row fits; drafts spend only what is left after that, so
        # speculation never evicts or sheds
        spare = 0
        if self.spec_k:
            reserved = sum(
                max(0, -(-(self.alloc._lens[r.seq_id] + 1) // page)
                    - len(self.alloc._tables[r.seq_id]))
                for r in decode)
            spare = self.alloc.free_pages - reserved
        n_dec = len(decode)
        # drafts never starve waiting prompts: a chunk_block of budget
        # stays theirs
        reserve = self.chunk_block if prefill else 0
        for i, r in enumerate(decode):
            sid = r.seq_id
            drafts = ()
            if self.spec_k:
                # one budget token for every remaining decode row, and
                # never past the request's own budget
                kcap = min(self.spec_k, self.chunk_block - 1,
                           budget - reserve - (n_dec - i),
                           r.max_new_tokens - len(r.output_ids) - 1)
                if kcap > 0:
                    drafts = self._draft(r, kcap)
                if drafts:
                    # cut drafts from the end until their pages fit
                    ln = self.alloc._lens[sid]
                    cur = len(self.alloc._tables[sid])
                    base = max(0, -(-(ln + 1) // page) - cur)
                    while drafts:
                        need = max(0, -(-(ln + 1 + len(drafts)) // page)
                                   - cur)
                        if need - base <= spare and cur + need \
                                <= self.alloc.max_pages_per_seq:
                            spare -= need - base
                            break
                        drafts = drafts[:-1]
            n = 1 + len(drafts)
            prev = self.alloc.extend(sid, n)
            # copy-on-write backstop: the write position must never land
            # in a page shared with the prefix cache (positions past
            # ``prev`` sit in the same page or in pages just allocated)
            cp = self.alloc.ensure_writable(sid, prev)
            if cp is not None:
                cow.append(cp)
            tok = r.output_ids[-1] if r.output_ids \
                else int(r.prompt_ids[-1])
            rows.append((r, sid, prev, n, (tok,) + drafts, True))
            budget -= n
        for r in prefill:
            if budget <= 0 or len(rows) >= self.rows_cap:
                break
            off = int(r._prefilled)
            n_total = len(r.prompt_ids)
            # page-aligned prefix matches continue into pages this
            # sequence owns; a shared page stays immutable regardless
            cp = self.alloc.ensure_writable(r.seq_id, off)
            if cp is not None:
                cow.append(cp)
            while off < n_total and budget > 0 \
                    and len(rows) < self.rows_cap:
                n = min(self.chunk_block, n_total - off, budget)
                toks = tuple(int(x) for x in r.prompt_ids[off:off + n])
                rows.append((r, r.seq_id, off, n, toks, False))
                off += n
                budget -= n
        return rows, cow

    def _sample_mode(self, reqs):
        """The next-token rule a dispatch or scan of ``reqs`` needs:
        ``"greedy"`` (every row greedy with no bias and no constraint, as
        is every row of an engine built with ``sampling=False``, which
        admits greedy requests only and ignores their bias, as the
        reference does: the argmax alone), ``"sampled"`` (a row samples)
        or ``"bias"`` (bias or constraint rows, none sampled: no sort and
        no Gumbel pass)."""
        sps = [r.sampling for r in reqs if r.sampling is not None] \
            if self.sample_enabled else []
        if any(sp.temperature > 0 for sp in sps):
            return "sampled"
        if any(sp.logit_bias or sp.constraint is not None for sp in sps):
            return "bias"
        return "greedy"

    def _sample_params(self, reqs, r_cap):
        """The sampler's per-row arrays of ``reqs`` (numpy: temps, top_ps,
        top_ks, seeds, slot_ids, slot_vals, cmodes), ``r_cap`` rows, the
        rows past ``reqs`` inert greedy ones as the reference pads them.
        Constraint hooks run HERE, once per request: a raising hook or an
        empty allowed set leaves the row unconstrained, an allowed set
        wider than ``sample_slots`` is cut to its first ``sample_slots``
        ids."""
        b = self.sample_slots
        temps = np.zeros((r_cap,), np.float32)
        top_ps = np.ones((r_cap,), np.float32)
        top_ks = np.zeros((r_cap,), np.int32)
        seeds = np.zeros((r_cap,), np.int32)
        slot_ids = np.full((r_cap, b), -1, np.int32)
        slot_vals = np.zeros((r_cap, b), np.float32)
        cmodes = np.zeros((r_cap,), np.int32)
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
        return temps, top_ps, top_ks, seeds, slot_ids, slot_vals, cmodes

    def _sample_arrays(self, rows, by_pos=False):
        """The sampler's per-row arrays of one dispatch (numpy: temps,
        top_ps, top_ks, seeds, positions, slot_ids, slot_vals, cmodes)
        and whether any row is sampled, or None where
        :meth:`_sample_mode` says greedy (:meth:`_sample_params` runs the
        constraint hooks). ``by_pos``: every packed token is sampled (a
        speculative engine's chunk-shaped dispatch), so the positions
        are per token, in packed order."""
        reqs = [row[0] for row in rows]
        mode = self._sample_mode(reqs)
        if mode == "greedy":
            return None
        temps, top_ps, top_ks, seeds, slot_ids, slot_vals, cmodes = \
            self._sample_params(reqs, len(rows))
        # the sampled token's position: the sampled-after token's + 1,
        # so a draw never depends on how it was dispatched
        if by_pos:
            positions = np.concatenate(
                [start + 1 + np.arange(n) for _, _, start, n, _, _ in rows]
            ).astype(np.int32)
        else:
            positions = np.array(
                [start + n for _, _, start, n, _, _ in rows], np.int32)
        arrays = (temps, top_ps, top_ks, seeds, positions, slot_ids,
                  slot_vals, cmodes)
        return arrays, mode == "sampled"

    def _dispatch_rows(self, rows, cow=()):
        """Dispatch ONE mixed step over a scheduled row list (caller
        holds the dispatch locks) after its copy-on-write page copies,
        and apply the results: prefill progress, prefix-cache pins of
        finished prompts, speculative verification (the longest prefix
        of drafts equal to the model's tokens accepted, the rejected
        tail's pages rolled back), emitted tokens. Returns tokens
        emitted."""
        # verify rows are multi-token decode rows: chunk-shaped, as
        # prefill chunks are
        needs_mixed = any(n > 1 or not is_dec
                          for _, _, _, n, _, is_dec in rows)
        qb = self.chunk_block if needs_mixed else 1
        # a speculative engine's chunk-shaped dispatch gives a token at
        # every packed position ([T]); otherwise one a row ([R])
        by_pos = bool(self.spec_k) and needs_mixed
        for old, new in cow:
            self._copy_page(old, new)
        key = ("mixed", self.chunk_budget if needs_mixed
               else self.max_batch)
        cold = key not in self._warmed_keys
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
        flat_start = []         # each row's first packed index
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
            flat_start.append(t)
            t += n
            last_idx[i] = t - 1
        for i, (_, sid, *_) in enumerate(rows):
            meta[3:5, i] = seq_first[sid]
            meta[5, i] = seq_last[sid]
        parts = [tokens, pos, flat_idx, last_idx, tables.reshape(-1),
                 meta.reshape(-1), page_ids, offs, row_tok.reshape(-1)]
        samp = self._sample_arrays(rows, by_pos)
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
        self._arm_watchdog(cold)
        with self._lock:
            self._in_dispatch = True
        t0 = time.perf_counter()
        try:
            nxt = self._mixed_forward(tok_d, pos_d, flat_d, last_d,
                                      tables_d, kv_d, qs_d, ql_d, ws_d,
                                      wf_d, we_d, pid_d, off_d, rt_d, qb,
                                      sample)
            out = nxt.tolist()          # the read-back: the step is done
        finally:
            with self._lock:
                self._in_dispatch = False
            dur = time.perf_counter() - t0
            self._disarm_watchdog(dur, cold=cold)
            self._warmed_keys.add(key)
        # a request cancelled, expired or evicted mid-dispatch is released
        # here, once; verification below skips its row (no rollback of a
        # released table)
        self._flush_deferred()
        if not cold and not needs_mixed:
            # a decode-only dispatch is one token per live row
            self._token_times.append(dur)
        finished, fin_sids = [], []
        with self._lock:
            for r, sid, start, n, _, is_dec in rows:
                # the seq_id check drops rows whose request was evicted
                # and requeued mid-dispatch
                if is_dec or r.done or r.seq_id != sid:
                    continue
                r._prefilled = max(r._prefilled, start + n)
                if r._prefilled >= len(r.prompt_ids) \
                        and r not in finished:
                    finished.append(r)
                    fin_sids.append(sid)
        # pin finished prompts' pages BEFORE emitting: a request with one
        # new token retires (and releases) at emit
        if finished and self.prefix is not None:
            self._prefix_insert(finished, fin_sids)
        # verification BEFORE any emission: out[f + j] is the token after
        # packed token f + j (the argmax, or the draw keyed by its
        # position), so a verify row's window holds what the sequential
        # engine would emit after the pending token and after each draft.
        # Accepting the longest prefix where draft j + 1 equals out[f + j]
        # is rejection sampling for a point-mass drafter and keeps seeded
        # draws the same with speculation on or off. The rejected tail
        # rolls back now, while the sequence is live (an emission below
        # may retire it and release everything)
        accepted: dict[int, int] = {}
        if any(is_dec and n > 1 for _, _, _, n, _, is_dec in rows):
            with self._lock:
                for i, (r, sid, start, n, toks, is_dec) in enumerate(rows):
                    if not is_dec or n <= 1:
                        continue
                    f = flat_start[i]
                    acc = 0
                    while acc < n - 1 \
                            and int(toks[1 + acc]) == int(out[f + acc]):
                        acc += 1
                    accepted[i] = acc
                    self._spec_proposed += n - 1
                    self._spec_accepted += acc
                    rejected = (n - 1) - acc
                    if rejected and not r.done and r.seq_id == sid:
                        # a request that turned terminal or was requeued
                        # mid-dispatch is released wholesale instead
                        self.alloc.rollback(sid, rejected)
        emitted = dec_tokens = 0
        for i, (r, sid, start, n, _, is_dec) in enumerate(rows):
            if r.done or r.seq_id != sid:
                continue
            f = flat_start[i]
            if is_dec:
                # the guaranteed token plus every accepted draft; _emit
                # retires at EOS, a stop token or max_new_tokens, and the
                # rest is dropped
                for j in range(accepted.get(i, 0) + 1):
                    if r.done:
                        break
                    self._emit(r, int(out[f + j] if by_pos else out[i]))
                    emitted += 1
                    dec_tokens += 1
            elif start + n >= len(r.prompt_ids):
                # a prompt's FINAL chunk emits its first token; a
                # mid-prompt chunk's tokens are discarded
                self._emit(r, int(out[f + n - 1] if by_pos else out[i]))
                emitted += 1
        if not cold and needs_mixed and dec_tokens \
                and all(is_dec for _, _, _, _, _, is_dec in rows):
            # a pure decode and verify dispatch: its time over what it
            # committed, as a scan's, keeps _retry_after live
            self._token_times.append(dur / dec_tokens)
        return emitted

    # ------------------------------------------------------------------
    # the stuck-dispatch watchdog
    # ------------------------------------------------------------------
    def _arm_watchdog(self, cold):
        """Arm the watchdog for one dispatch: timeout = max(
        stuck_min_timeout, stuck_factor x P99 of the warm dispatches).
        The first dispatch of a shape (building kernels, capturing
        graphs) never arms, nor any before 8 warm samples."""
        if cold or not self.stuck_factor or self._closed:
            return
        times = self._dispatch_times
        if len(times) < 8:
            return
        s = sorted(times)
        p99 = s[min(len(s) - 1, int(math.ceil(0.99 * len(s))) - 1)]
        if self._wd is None:
            from ..distributed.watchdog import StepWatchdog
            self._wd = StepWatchdog(timeout=float("inf"),
                                    name="serving.decode").start()
        self._wd.arm(max(self.stuck_min_timeout, self.stuck_factor * p99))

    def _disarm_watchdog(self, duration=None, cold=False):
        if duration is not None and not cold:
            self._dispatch_times.append(duration)
        if self._wd is not None:
            self._wd.disarm()

    def close(self):
        """Stop the watchdog's thread. Idempotent; the engine stays
        usable but unwatched (later dispatches do not restart it)."""
        self._closed = True
        if self._wd is not None:
            self._wd.stop()
            self._wd = None

    # ------------------------------------------------------------------
    # admission: prefix match, the degradation ladder
    # ------------------------------------------------------------------
    def prefill_backlog(self):
        """Prompt tokens admitted but not yet written to pages: the
        chunked scheduler's pending prefill work (a load signal)."""
        with self._lock:
            return sum(max(0, len(r.prompt_ids) - r._prefilled)
                       for r in self._live.values() if not r.done)

    def _validate(self, req):
        """The reference's checks: a prompt must fit one sequence's KV
        capacity; a sampled request needs ``sampling`` on, and its bias
        must fit ``sample_slots``."""
        cap_pages = min(self.alloc.max_pages_per_seq, self.alloc.num_pages)
        max_prompt = cap_pages * self.page_size
        n = len(req.prompt_ids)
        if n > max_prompt:
            raise ValueError(
                f"prompt of {n} tokens exceeds this engine's KV capacity "
                f"of {max_prompt} tokens ({cap_pages} pages x "
                f"{self.page_size} slots); split the prompt or size the "
                f"pool up (num_pages/max_pages_per_seq)")
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

    def _retry_after(self):
        """Seconds until capacity plausibly frees: the live set's
        shortest remaining token budget x the recent median per-token
        latency; one backoff quantum without history."""
        with self._lock:
            live = [r for r in self._live.values() if not r.done]
            times = sorted(self._token_times)
        if not live or not times:
            return max(self.admit_backoff, 0.005)
        remaining = min(max(1, r.max_new_tokens - len(r.output_ids))
                        for r in live)
        return round(remaining * times[len(times) // 2], 4)

    def _try_reserve(self, req):
        """One admission attempt: capacity check, prefix match, page
        reservation and live-set insertion as ONE transition under the
        engine lock (two admitting threads never push the live set past
        ``max_batch``). Returns a failure reason or None."""
        try:
            # outside the lock: a hang fault must not wedge it; an
            # injected MemoryError takes the pool-exhausted path
            _faults.fire("serve.admit", step=self._dispatch_count)
        except MemoryError:
            return "KV page pool exhausted"
        with self._lock:
            if self._draining:
                return "draining"
            if len(self._live) >= self.max_batch:
                return "engine full"
            n = len(req.prompt_ids)
            cached = 0
            val_retries = 0
            evicted_cache = False
            recorded = False
            while True:
                shared, cached = ([], 0)
                if self.prefix is not None:
                    # stats recorded once per admission, not per retry
                    shared, cached = self.prefix.match(
                        req.prompt_ids, record=not recorded)
                    recorded = True
                try:
                    self.alloc.admit(req.seq_id, n, shared_pages=shared)
                    break
                except ValueError:
                    # a concurrent eviction freed the matched pages
                    # between match and admit: re-match (with NO shared
                    # pages it is a real validation error)
                    if shared and val_retries < 2:
                        val_retries += 1
                        continue
                    raise
                except MemoryError:
                    # cached prefixes are never a reason to shed: give
                    # cold cache pages back and retry once (re-matching)
                    if evicted_cache or self.prefix is None:
                        return "KV page pool exhausted"
                    evicted_cache = True
                    need = max(1, math.ceil(n / self.page_size))
                    while self.alloc.free_pages < need \
                            and self.prefix.pages:
                        self.prefix.evict_pages(need
                                                - self.alloc.free_pages)
                    if self.alloc.free_pages < need:
                        return "KV page pool exhausted"
            req._cached_tokens = cached
            # the prefill cursor is stamped BEFORE the request is visible
            # in _live: no dispatch may see a warm request at 0 and write
            # chunks over its shared prefix pages
            req._prefilled = cached
            self._live[req.seq_id] = req
            req.status = "live"
        return None

    def _degrade_trim(self, req, tried):
        """Ladder rung 1: retire the lowest-priority victim that has
        output NOW, its budget cut to what it produced (``completed``,
        ``trimmed=True``)."""
        with self._lock:
            victims = [r for r in self._live.values()
                       if not r.done and r.priority < req.priority
                       and r.output_ids and r.seq_id not in tried]
            if not victims:
                return False
            v = min(victims, key=lambda r: (r.priority, len(r.output_ids)))
            tried.add(v.seq_id)
            self._trim(v)
        return True

    def _trim(self, v):
        """Truncate the victim's budget to what it produced and retire it
        (partial output kept, ``trimmed=True``). Caller holds the lock."""
        v.max_new_tokens = max(1, len(v.output_ids))
        v.trimmed = True
        self._retire(v, "completed")

    def _evict(self, v):
        """Reclaim the victim's pages and re-queue it against its
        ``retry_budget`` (re-admission restarts it from scratch) or fail
        it typed. A victim that turned terminal or was requeued since
        selection is left alone."""
        with self._lock:
            if v.done or v.seq_id is None:
                return
            if v.seq_id in self._live:
                del self._live[v.seq_id]
            self._spec_state.pop(v.seq_id, None)
            self._release_pages(v.seq_id)
            self._requeue_or_fail(v)

    def _requeue_or_fail(self, v):
        """Park the victim for a from-scratch retry, or fail it typed
        when its retry budget is spent. Caller holds the lock and has
        released the victim's pages."""
        if v.retry_budget > 0:
            v.retry_budget -= 1
            v.output_ids = []
            v.status = "requeued"
            v._t_admit = None
            v._expires_at = None
            v._cached_tokens = 0    # re-matched at re-admission
            v._prefilled = 0        # KV is gone; prefill restarts
            # a fresh seq_id on re-admission: the old id may still have
            # a deferred page release in flight
            v.seq_id = None
            self._requeue.append(v)
        else:
            v.done = True
            v.status = "evicted"
            v.error = AdmissionError(
                "evicted under pressure; retry budget exhausted",
                live=len(self._live), max_batch=self.max_batch,
                free_pages=self.alloc.free_pages,
                num_pages=self.alloc.num_pages, retries=0)

    def _degrade_evict(self, req):
        """Ladder rung 2: evict the lowest-priority victim (then the
        least progressed)."""
        with self._lock:
            victims = [r for r in self._live.values()
                       if not r.done and r.priority < req.priority]
            if not victims:
                return False
            v = min(victims, key=lambda r: (r.priority, len(r.output_ids)))
            self._evict(v)
        return True

    def _degrade_pause(self, req):
        """The pause rung between cache reclaim and trim needs the host
        KV tier (ROADMAP A7); without one it frees nothing."""
        del req
        return False

    def _relieve_pressure(self, live, n):
        """Decode-boundary rung of the ladder: when the pool cannot hold
        the next ``n`` tokens of every live sequence, give cold prefix
        pages back, then evict the lowest-priority (then least
        progressed) victim until the rest fit; a sequence at its per-seq
        table cap is trimmed. Returns the surviving list. Caller holds
        the engine lock."""
        page = self.page_size
        live = list(live)
        for r in list(live):
            need_pages = -(-(self.alloc._lens[r.seq_id] + n) // page)
            if need_pages > self.alloc.max_pages_per_seq:
                live.remove(r)
                self._trim(r)
        # while another thread is mid-entry, victim releases would be
        # deferred and free nothing: victims are only POSTPONED from
        # this dispatch (no state change)
        me = threading.current_thread()
        deferrals_blocked = self._in_dispatch \
            or any(t is not me for t in self._entry_threads)
        while live:
            need = sum(
                max(0, -(-(self.alloc._lens[r.seq_id] + n) // page)
                    - len(self.alloc._tables[r.seq_id]))
                for r in live)
            if need <= self.alloc.free_pages:
                break
            if self.prefix is not None and self.prefix.pages \
                    and self.prefix.evict_pages(
                        need - self.alloc.free_pages):
                continue
            v = min(live, key=lambda r: (r.priority, len(r.output_ids)))
            live.remove(v)
            if not deferrals_blocked:
                self._evict(v)
        return live

    def _pump_requeue(self):
        """Re-admission at step boundaries: requests the ladder parked
        rejoin the batch as capacity allows; their prompts prefill as
        ordinary chunks of the next dispatches."""
        while True:
            with self._lock:
                if self._draining or not self._requeue \
                        or len(self._live) >= self.max_batch:
                    break
                nxt = self._requeue.popleft()
            if nxt.done:
                continue
            try:
                # no backoff sleeps inside the dispatch lock
                self._admit_locked(nxt, quiet_retry=True)
            except AdmissionError:
                with self._lock:
                    self._requeue.appendleft(nxt)
                break

    def _admit(self, req):
        """Admit one request, walking the degradation ladder under
        pressure: trim -> evict -> (bounded backoff) -> shed with a
        ``retry_after`` hint. Raises :class:`ValueError` for a request
        that can never fit and :class:`AdmissionError` for transient
        pressure."""
        with self._entry():
            return self._admit_locked(req)

    def _admit_locked(self, req, quiet_retry=False):
        with self._lock:
            if req._cancel_requested and not req.done:
                # a client abandon raced an eviction / re-admission
                req.done = True
                req.status = "cancelled"
                return req.seq_id
        if req.done:
            return req.seq_id
        self._validate(req)
        self._expire_deadlines()      # expired requests free capacity
        with self._lock:
            if req.seq_id is None:
                req.seq_id = self._next_id
                self._next_id += 1
            if req._seed is None:
                sp = req.sampling
                if sp is not None and sp.seed is not None:
                    req._seed = sp.seed
                else:
                    # once per request (stable across re-admissions) and
                    # recorded, so the draw is reproducible
                    self._auto_seed = (self._auto_seed * 1103515245
                                       + 12345) % (2 ** 31)
                    req._seed = self._auto_seed
        attempt = 0
        trim_tried: set[int] = set()
        while True:
            reason = self._try_reserve(req)
            if reason is None:
                break
            # while a dispatch is in flight or another thread is
            # mid-entry, victim releases are deferred: trimming or
            # evicting could free no page, so fall through to backoff
            me = threading.current_thread()
            with self._lock:
                pages_blocked = (
                    reason == "KV page pool exhausted"
                    and (self._in_dispatch
                         or any(t is not me
                                for t in self._entry_threads)))
            if reason != "draining" and not pages_blocked:
                # rung order: cache reclaim (in _try_reserve), pause,
                # trim, evict, backoff, shed
                if self._degrade_pause(req):
                    continue
                if self._degrade_trim(req, trim_tried):
                    continue
                if self._degrade_evict(req):
                    continue
            if reason != "draining" and not quiet_retry \
                    and attempt < self.admit_retries:
                # bounded backoff: another thread's step may retire a
                # request and release its pages meanwhile
                attempt += 1
                time.sleep(self.admit_backoff * (2 ** (attempt - 1)))
                continue
            raise AdmissionError(
                reason, live=len(self._live),
                max_batch=self.max_batch,
                free_pages=self.alloc.free_pages,
                num_pages=self.alloc.num_pages, retries=attempt,
                retry_after=self._retry_after())
        # _try_reserve made the request live; stamp the clocks
        now = time.perf_counter()
        with self._lock:
            req._t_admit = now
            ttl = None
            if req.deadline is not None:
                ttl = req.deadline
            if req.token_budget is not None:
                budget = req.token_budget * req.max_new_tokens
                ttl = budget if ttl is None else min(ttl, budget)
            req._expires_at = None if ttl is None else now + ttl
        return req.seq_id

    def add_request(self, req):
        """Admit a request and drive its chunked prefill through to its
        first emitted token (live decodes ride along in the same
        dispatches). Returns its seq_id."""
        sid = self._admit(req)
        while not req.done and req._prefilled < len(req.prompt_ids):
            if self.step() == 0:
                break       # nothing dispatchable (drained / expired)
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
        """One mixed dispatch. Returns (rows dispatched, tokens
        emitted)."""
        with self._entry(), self._dispatch_lock, _CROSS_ENGINE_LOCK:
            self._expire_deadlines()
            self._pump_requeue()
            with self._lock:
                if not any(not r.done for r in self._live.values()):
                    return 0, 0
            # before any allocator change: an injected raise aborts the
            # dispatch cleanly
            _faults.fire("serve.decode", step=self._dispatch_count)
            self._dispatch_count += 1
            with self._lock:
                # rows snapshotted, and the decode extends made, under
                # the lock: no concurrent admission takes the pages
                # _relieve_pressure proved free
                rows, cow = self._schedule_rows()
            if not rows:
                return 0, 0
            emitted = self._dispatch_rows(rows, cow)
            self._expire_deadlines()
            return len(rows), emitted
    # ------------------------------------------------------------------
    # decode scan: n all-decode ticks, one read-back
    # ------------------------------------------------------------------
    def _scan_width(self):
        """The most ticks one scan takes: decode_many's longest chunk,
        ``decode_ticks`` or ``max(decode_ticks // 4, 2)``."""
        return max(self.decode_ticks, 2)

    # the scan's inputs, packed in this order into one int32 buffer (f32
    # fields as bits); a greedy scan fills the first three only
    _SCAN_IN = ("tables", "lens", "tokens", "temps", "top_ps", "top_ks",
                "seeds", "slot_ids", "slot_vals", "cmodes")
    _SCAN_F32 = ("temps", "top_ps", "slot_vals")

    def _scan_shapes(self):
        b, w, s = self.max_batch, self.width, self.sample_slots
        return {"tables": (b, w), "slot_ids": (b, s), "slot_vals": (b, s)}

    def _scan_buffers(self):
        """The scan's static buffers (allocated once; the tick graphs bake
        their addresses): the inputs, views of one int32 buffer
        ``scan_in`` that :meth:`_load_scan` fills in one copy (the carry:
        tables, lens, tokens; then the sampler's arrays), the tokens out
        ``[max_batch, scan width]`` and the tick counter, with the row
        ids and ones a tick reads."""
        g = self._graphs
        if "scan_in" not in g.buffers:
            b, i32 = self.max_batch, torch.int32
            shapes = self._scan_shapes()
            sizes = [math.prod(shapes.get(n, (b,))) for n in self._SCAN_IN]
            packed = g.buffer("scan_in", (sum(sizes),), i32)
            for name, part in zip(self._SCAN_IN, packed.split(sizes)):
                part = part.view(shapes.get(name, (b,)))
                g.buffers[name] = part.view(torch.float32) \
                    if name in self._SCAN_F32 else part
            g.buffer("out", (b, self._scan_width()), torch.int64)
            g.buffer("tick", (1,), torch.int64)
            g.buffer("rows", (b,), i32).copy_(torch.arange(b))
            g.buffer("ones", (b,), i32).fill_(1)
            g.buffer("row_tok", (b, 1), torch.int64).copy_(
                torch.arange(b)[:, None])
        return g.buffers

    @torch.no_grad()
    def _tick(self, mode):
        """ONE decode tick on the scan's static buffers (the body of the
        reference's ``_decode_scan_fn``): :meth:`_mixed_forward` at the
        decode-only shape, ``T == R == max_batch``, qblock 1. From the
        carry, on the device: each row writes its token at ``start = lens -
        1`` (page and slot from the row's table for the two-op scatter),
        attends ``lens`` keys, and samples at position ``lens``; the next
        token lands in ``out[:, tick]``, then ``tokens``, ``lens`` and
        ``tick`` advance. ``mode`` is the next-token rule
        (:meth:`_sample_mode`); the sampler's arrays are the scan's
        invariants. Nothing is read back to the host."""
        g = self._scan_buffers()
        lens, tables, rows = g["lens"], g["tables"], g["rows"]
        start = lens - 1
        if self.fused_kv:
            page_ids = offs = start[:0]       # the fused calls write
        else:
            col = torch.div(start, self.page_size, rounding_mode="floor")
            page_ids = tables.gather(
                1, col.clamp(0, self.width - 1).long()[:, None])[:, 0]
            offs = start % self.page_size
        sample = None
        if mode != "greedy":
            sample = ((g["temps"], g["top_ps"], g["top_ks"], g["seeds"],
                       lens, g["slot_ids"], g["slot_vals"], g["cmodes"]),
                      mode == "sampled")
        # the fused write of a decode tick: each row writes exactly its own
        # token, so its span starts at the token's position, its packed
        # index is the row's, and every row is its sequence's last
        nxt = self._mixed_forward(g["tokens"], start, rows, rows, tables,
                                  lens, start, g["ones"], start, rows, lens,
                                  page_ids, offs, g["row_tok"], 1, sample)
        g["out"].index_copy_(1, g["tick"], nxt[:, None])
        g["tokens"].copy_(nxt)
        lens.add_(1)
        g["tick"].add_(1)

    @staticmethod
    def _scan_rows(live):
        """The seq ids and last tokens of a scan's rows ``live``, as the
        scan snapshots them under the lock."""
        return ([r.seq_id for r in live],
                [r.output_ids[-1] if r.output_ids else int(r.prompt_ids[-1])
                 for r in live])

    def _load_scan(self, live, starts, mode, sids, last):
        """Fill the scan's input buffers in place for ``live``, whose next
        tokens land at positions ``starts`` (rows past them padded:
        tables of the trash page, lens 1, token 0, inert greedy sampler
        rows), in ONE host-to-device copy, and zero the tick counter.
        ``sids`` / ``last``: the rows' seq ids and last tokens
        (:meth:`_scan_rows`, snapshotted by the scan)."""
        b = self.max_batch
        tables = np.full((b, self.width), self.trash_page, np.int32)
        lens = np.ones((b,), np.int32)
        tokens = np.zeros((b,), np.int32)
        for i, (sid, start) in enumerate(zip(sids, starts)):
            t = self.alloc._tables[sid]
            tables[i, :len(t)] = t
            lens[i] = start + 1                # first new token included
            tokens[i] = last[i]
        parts = [tables, lens, tokens]
        if mode != "greedy":
            parts += self._sample_params(live, b)
        host = np.concatenate([a.reshape(-1).view(np.int32) for a in parts])
        g = self._scan_buffers()
        g["scan_in"][:host.size].copy_(torch.from_numpy(host))
        g["tick"].zero_()

    def _ensure_tick(self, mode):
        """On the card, capture the tick graph of ``mode`` unless it is
        captured: on the padding state, whose writes land in the trash
        page only, so the warm-up and the capture touch no request."""
        if not self._graphs.cuda or mode in self._graphs:
            return
        self._load_scan([], [], mode, [], [])
        self._graphs.capture(mode, lambda: self._tick(mode))

    def _run_tick(self, mode):
        """One tick: the captured graph on the card, the tick function
        itself on the CPU."""
        if self._graphs.cuda:
            self._graphs.replay(mode)
        else:
            self._tick(mode)

    def _decode_scan(self, n):
        """Decode ``n`` tokens for every live, fully prefilled request:
        ``n`` ticks and one read-back. Pages for all ``n`` tokens are
        reserved first (the ladder makes room, :meth:`_relieve_pressure`),
        and a scan's first write position is made private
        (copy-on-write); tokens a request emits after it retires mid-scan
        (EOS, stop, budget, cancel, deadline) are discarded. Pages
        released mid-scan are released after its read-back: the tick
        tables still address them."""
        if n > self._scan_width():
            raise ValueError(f"a scan takes at most {self._scan_width()} "
                             f"ticks (decode_ticks), got {n}")
        with self._entry(), self._dispatch_lock, _CROSS_ENGINE_LOCK:
            self._expire_deadlines()
            self._pump_requeue()
            with self._lock:
                if n <= 0 or not any(not r.done
                                     for r in self._live.values()):
                    return 0
            # as in a step: fire before any allocator change
            _faults.fire("serve.decode", step=self._dispatch_count)
            self._dispatch_count += 1
            with self._lock:
                live = [r for r in self._live.values() if not r.done
                        and r._prefilled >= len(r.prompt_ids)]
                live = self._relieve_pressure(live, n)
                sids, last = self._scan_rows(live)
                # the whole scan reserved under the lock (see a step)
                starts = [self.alloc._lens[sid] for sid in sids]
                cow = []
                for sid, start in zip(sids, starts):
                    self.alloc.extend(sid, n)
                    # only the scan's FIRST write position can sit in a
                    # pre-existing (possibly shared) page
                    cp = self.alloc.ensure_writable(sid, start)
                    if cp is not None:
                        cow.append(cp)
            if not live:
                return 0
            for old, new in cow:
                self._copy_page(old, new)
            mode = self._sample_mode(live)
            self._ensure_tick(mode)
            self._load_scan(live, starts, mode, sids, last)
            key = ("scan", n)
            cold = key not in self._warmed_keys
            self._arm_watchdog(cold)
            with self._lock:
                self._in_dispatch = True
            t0 = time.perf_counter()
            try:
                for _ in range(n):
                    self._run_tick(mode)
                all_tokens = self._graphs.buffers["out"][
                    :len(live), :n].tolist()       # one read-back
            finally:
                with self._lock:
                    self._in_dispatch = False
                dur = time.perf_counter() - t0
                self._disarm_watchdog(dur, cold=cold)
                self._warmed_keys.add(key)
            self._flush_deferred()
            if not cold:
                self._token_times.append(dur / n)
            served = 0
            for i, r in enumerate(live):
                for t in range(n):
                    # retired mid-scan, or evicted and requeued under a
                    # fresh seq_id: the tail is discarded
                    if r.done or r.seq_id != sids[i]:
                        break
                    self._emit(r, int(all_tokens[i][t]))
                    served += 1
            self._expire_deadlines()
            return served

    def _scan_fits(self, live, n):
        """Largest scan <= n whose page reservations fit the pool and no
        sequence's per-seq table cap, as the reference sizes it."""
        page = self.page_size
        for r in live:
            headroom = self.alloc.max_pages_per_seq * page \
                - self.alloc._lens[r.seq_id]
            if headroom < n:
                # a fully capped sequence (headroom <= 0) is trimmed at
                # the next boundary by _relieve_pressure
                n = max(1, headroom)
        while n > 1:
            need = sum(
                max(0, -(-(self.alloc._lens[r.seq_id] + n) // page)
                    - len(self.alloc._tables[r.seq_id]))
                for r in live)
            if need <= self.alloc.free_pages:
                break
            n //= 2
        return n

    def decode_many(self, n, exact=True):
        """``n`` decode steps for the current live set. While a live
        prompt still has chunks to prefill, or a live request has a
        constraint hook (host work each step), the engine takes single
        mixed steps; otherwise scans of :attr:`decode_ticks` ticks, then
        of ``max(decode_ticks // 4, 2)``, then single steps, as the
        reference does. A speculative engine probes its drafters first:
        while one proposes, it takes single mixed steps (verify rows);
        else it scans, short scans until two probes in a row found
        nothing. With ``exact=False`` the tail may overshoot by up
        to ``decode_ticks // 4 - 1`` ticks (callers use it when every live
        request retires by step ``n``; the overshot tokens are
        discarded). Requests parked on the requeue are pumped back in by
        the steps. Returns tokens served."""
        served = 0
        small = max(self.decode_ticks // 4, 2)
        while n > 0:
            with self._lock:
                # _scan_fits reads the allocator's per-seq state: under
                # the lock, so a concurrent evict cannot null a seq_id
                live = [r for r in self._live.values() if not r.done]
                if not live and not self._requeue:
                    break
                prefilling = any(r._prefilled < len(r.prompt_ids)
                                 for r in live)
                constrained = any(r.sampling is not None
                                  and r.sampling.constraint is not None
                                  for r in live)
                spec_now = False
                if self.spec_k and not prefilling and live:
                    spec_now = self._spec_worth(live)
                    # the probe paces the scans' escalation below
                    self._spec_idle = 0 if spec_now \
                        else self._spec_idle + 1
                if not live or prefilling or constrained:
                    chunk = 1       # (with nothing live: pump the requeue)
                elif spec_now:
                    # speculation rides single mixed steps: one dispatch
                    # verifies 1 + drafts tokens a row, where a tick
                    # takes one
                    chunk = 1
                elif n >= self.decode_ticks and (not self.spec_k
                                                 or self._spec_idle >= 2):
                    # a speculative engine starts with SHORT scans, so a
                    # repetition's onset is caught within ticks/4
                    # tokens; two empty probes in a row escalate to full
                    # scans
                    chunk = self._scan_fits(live, self.decode_ticks)
                elif n >= small or not exact:
                    chunk = self._scan_fits(live, small)
                else:
                    chunk = 1
            if chunk > 1:
                served += self._decode_scan(chunk)
                n -= chunk
            else:
                rows, emitted = self._mixed_step()
                if rows == 0:
                    break
                served += emitted
                n -= 1
        return served

    # ------------------------------------------------------------------
    # prewarm: build, load and capture ahead of traffic
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _warm_mixed(self, t_cap):
        """One mixed dispatch of ``t_cap`` tokens with every row inactive
        (kv_len 0: nothing is written, the attention gives zeros; the
        two-op scatter writes the trash page only) and its tokens
        discarded, so no request state is touched: it builds and loads the
        kernels' libraries and the library handles of the shape. On a
        speculative engine the chunk shape's lm head and sampler run over
        every one of its ``t_cap`` positions, as a verify dispatch does,
        so warm-ups differ with ``spec_k``. Returns False for a token
        count that is not one of this engine's two dispatch shapes."""
        t_cap = int(t_cap)
        if t_cap == self.chunk_budget:
            r_cap, qb = self.rows_cap, self.chunk_block
        elif t_cap == self.max_batch:
            r_cap, qb = self.max_batch, 1
        else:
            return False
        dev, i32 = self.device, torch.int32
        z_t = torch.zeros((t_cap,), dtype=i32, device=dev)
        z_r = torch.zeros((r_cap,), dtype=i32, device=dev)
        tables = torch.full((r_cap, self.width), self.trash_page, dtype=i32,
                            device=dev)
        fallback = not self.fused_rope
        page_ids = torch.full((t_cap if fallback else 0,), self.trash_page,
                              dtype=i32, device=dev)
        offs = torch.zeros_like(page_ids)
        row_tok = torch.zeros((r_cap if fallback else 0, qb),
                              dtype=torch.int64, device=dev)
        sample = None
        if self.sample_enabled:
            # the sampled tail, on inert rows: the sampler's kernel loads too
            arrays = self._sample_params([], r_cap)
            n_pos = t_cap if self.spec_k and qb > 1 else r_cap
            arrays = arrays[:4] + (np.zeros((n_pos,), np.int32),) \
                + arrays[4:]
            sample = (tuple(torch.from_numpy(a).to(dev) for a in arrays),
                      True)
        self._mixed_forward(z_t, z_t, z_t, z_r, tables, z_r, z_r, z_r, z_r,
                            z_r, z_r, page_ids, offs, row_tok, qb, sample)
        return True

    def _warm_scan(self, n):
        """Make the decode scan ready: on the card, capture the tick
        graph of every mode this engine can run (greedy, and with
        ``sampling`` on, bias only and sampled); on the CPU, run one tick
        of each on the padding state. One tick graph serves every scan
        length ``n``."""
        del n
        modes = ("greedy", "bias", "sampled") if self.sample_enabled \
            else ("greedy",)
        for mode in modes:
            if self._graphs.cuda:
                self._ensure_tick(mode)
            else:
                self._load_scan([], [], mode, [], [])
                self._tick(mode)

    def prewarm(self, mixed=None, scans=None):
        """Build, load and capture this engine's dispatch programs before
        traffic arrives: ``mixed`` token counts (``chunk_budget`` and
        ``max_batch`` are this engine's; others are skipped) by a dummy
        dispatch each, and ``scans`` (tick counts) by capturing the tick
        graphs. With no arguments the recipe is empty: the reference reads
        it from its compile cache's shape registry, empty without a cache
        directory, and the port has no registry yet (``compile_watch``,
        ROADMAP A8). Returns ``{"mixed": [...], "scan": [...]}``, what was
        warmed (also kept on ``self.prewarmed``)."""
        done = {"mixed": [], "scan": []}
        for t_cap in sorted(set(mixed or ())):
            if self._warm_mixed(int(t_cap)):
                done["mixed"].append(int(t_cap))
        for n in sorted(set(scans or ())):
            self._warm_scan(int(n))
            done["scan"].append(int(n))
        self.prewarmed = done
        return done

    def generate(self, prompts, max_new_tokens=16, eos_token_id=None):
        """Admit all prompts (continuous batching handles ragged finish
        times), run to completion, return output id lists in order. Every
        pending request that fits is admitted; requests the ladder
        re-queued are re-admitted ahead of new ones; a shed admission of
        a new request raises its :class:`AdmissionError`, as the
        reference's does. An entry of ``prompts`` may also be a
        :class:`Request` (its own budget applies), so the caller can read
        its ``ttft`` afterwards."""
        reqs = [p if isinstance(p, Request)
                else Request(p, max_new_tokens, eos_token_id)
                for p in prompts]
        pending = list(reqs)
        while pending or any(not r.done for r in reqs):
            while True:
                with self._lock:
                    if len(self._live) >= self.max_batch:
                        break
                    # decide AND pop under the lock: a second stepping
                    # thread's requeue pump races these pops
                    from_requeue = bool(self._requeue)
                    nxt = self._requeue.popleft() if from_requeue \
                        else (pending.pop(0) if pending else None)
                if nxt is None:
                    break
                if nxt.done:
                    continue
                try:
                    self._admit(nxt)
                except AdmissionError:
                    if from_requeue:
                        # still under pressure: park it again, never
                        # stranded in a non-terminal 'requeued'
                        with self._lock:
                            self._requeue.appendleft(nxt)
                        break
                    raise
            with self._lock:
                live = [r for r in self._live.values() if not r.done]
                prefilling = any(r._prefilled < len(r.prompt_ids)
                                 for r in live)
            if live:
                if prefilling:
                    # mixed steps until every admitted prompt is in
                    self.step()
                    continue
                # scan until the earliest possible retirement; with EOS
                # or pending admissions, re-check admission every
                # decode_ticks. The tail may overshoot (exact=False):
                # every live request retires by then, so overshot ticks
                # are discarded
                run = min(r.max_new_tokens - len(r.output_ids)
                          for r in live)
                if pending or eos_token_id is not None:
                    run = min(run, self.decode_ticks)
                self.decode_many(max(1, run), exact=False)
                continue
            if not pending and all(r.done for r in reqs):
                break
        return [r.output_ids for r in reqs]

    # ------------------------------------------------------------------
    # graceful drain and readiness
    # ------------------------------------------------------------------
    def drain(self, timeout=30.0):
        """Stop admission and retire the in-flight set: decode until
        every live request completes or the grace ``timeout`` elapses,
        then expire the stragglers with a :class:`DeadlineExceeded` and
        release their pages. Admission stays closed afterwards
        (:class:`AdmissionError` reason ``"draining"``) until
        :meth:`resume_admission`. Returns ``{"seconds", "completed",
        "expired"}`` over the requests live at entry."""
        with self._lock:
            self._draining = True
            already = self._drain_active
            if not already:
                self._drain_active = True
        if already:
            # another thread's drain is mid-flight: wait it out within
            # this call's own budget
            t0 = time.perf_counter()
            while self._drain_active \
                    and time.perf_counter() - t0 < timeout:
                time.sleep(0.01)
            return {"seconds": time.perf_counter() - t0,
                    "completed": 0, "expired": 0}
        t0 = time.perf_counter()
        try:
            _faults.fire("serve.drain")
            with self._lock:
                start = [r for r in self._live.values() if not r.done]
            while True:
                self._expire_deadlines()
                with self._lock:
                    live = [r for r in self._live.values() if not r.done]
                if not live:
                    break
                if time.perf_counter() - t0 >= timeout:
                    for r in live:
                        self._expire(r, reason="drain grace window")
                    break
                self.step()
            # admission is closed, so requeued requests can never run
            # again: expire them typed rather than strand them
            with self._lock:
                requeued = list(self._requeue)
                self._requeue.clear()
            for r in requeued:
                if not r.done:
                    self._expire(r, reason="drain grace window")
            dur = time.perf_counter() - t0
            completed = sum(1 for r in start if r.status == "completed")
            expired = sum(1 for r in start
                          if r.status == "deadline_exceeded")
            return {"seconds": dur, "completed": completed,
                    "expired": expired}
        finally:
            with self._lock:
                self._drain_active = False
                pending = self._pending_drain
                self._pending_drain = None
            if pending is not None:
                # a preemption signal arrived while this drain ran
                self._run_drain_and_exit(*pending)

    def resume_admission(self):
        """Reopen admission after a :meth:`drain`."""
        with self._lock:
            self._draining = False

    def is_ready(self):
        """Readiness (not liveness): False while draining or closed, so
        a load balancer stops sending before :meth:`drain` finishes."""
        with self._lock:
            return not (self._draining or self._closed)

    def _run_drain_and_exit(self, grace, exit_code, on_drained):
        stats = self.drain(grace)
        if on_drained is not None:
            try:
                on_drained(stats)
            except Exception:
                pass        # exiting anyway; the drain itself succeeded
        os._exit(exit_code)

    def install_drain_handler(self, grace=30.0,
                              signals=(_signal.SIGTERM,), exit_code=0,
                              on_drained=None):
        """Hook preemption signals (default SIGTERM) for a graceful
        drain: admission stops at once; in-flight requests finish or
        expire within ``grace`` seconds; then the process exits with
        ``exit_code``. A signal landing while an entry is in flight
        defers the drain to the entry's boundary, so engine state is
        never torn mid-update. ``on_drained(stats)`` runs just before
        exit. Must be called from the main thread (CPython's signal
        rule). Returns ``{signum: previous_handler}``."""
        prev = {}

        def _handler(signum, frame):
            with self._lock:
                self._draining = True
                if self._drain_active or self._entry_depth > 0 \
                        or self._flushing:
                    self._pending_drain = (grace, exit_code, on_drained)
                    return
            self._run_drain_and_exit(grace, exit_code, on_drained)

        for s in signals:
            prev[s] = _signal.signal(s, _handler)
        return prev
