"""Per-request sampling for the serving engine (port of the reference's
``inference/sampling.py``).

Every sampler knob is runtime data: the engine packs one row of ``[R]``
arrays per dispatched row (temperature, top_p, top_k, seed, the sampled
token's position, bias/constraint slots), so greedy, temperature, top-k
and top-p rows ride one dispatch. Greedy rows (``temperature == 0``) take
the argmax of the same f32 logits the greedy engine argmaxes, bias added:
with no bias, bit for bit today's argmax.

Randomness is counter-based and the reference's: a row's key is
``fold_in(key(seed), position)``, a function of (request seed, absolute
position) only, never of the dispatch's shape or its other rows. The
Gumbel-max draw over the kept tokens is one launch of
:func:`~paddle_tpu_torch.ops.sampling.gumbel_argmax` on the card (its plain
version on the CPU). The keys, bits and uniforms are the reference's bit for
bit; ``g`` may differ in its last bits (``ops.sampling.GUMBEL_REL``), and the
softmax and cumulative sum at the top-p boundary sum in another order than
the reference's, so a sampled token can differ from the reference's only
where two perturbed scores, or a token's mass and the top-p boundary, lie
that close.

:func:`sampled_next_tokens` reads nothing back to the host: what the host
knows of the rows (whether any is sampled) it passes in.
"""

from __future__ import annotations

import math

import torch

from ..ops.sampling import gumbel_argmax

__all__ = ["SamplingParams", "GREEDY", "sampled_next_tokens"]

#: Sentinel large-negative logit used to mask tokens out of the
#: sampled distribution (finite so softmax/cumsum stay NaN-free).
_MASKED = -1e30


class SamplingParams:
    """Per-request sampling spec. All fields are runtime data — two
    requests with different params share one dispatch.

    Args:
        temperature: 0 (default) = greedy argmax, bitwise-identical to
            the pre-sampling engine. > 0 scales logits before sampling.
        top_p: nucleus mass in (0, 1]; 1.0 disables.
        top_k: keep the k highest-probability tokens; 0 disables.
        seed: per-request RNG seed (int). ``None`` lets the engine
            assign one at admission (recorded on the request so the
            draw is reproducible after the fact). The sampled sequence
            is a pure function of (model, prompt, params, seed) —
            independent of batch composition.
        stop: iterable of *token ids*; generation retires as
            ``completed`` right before any of them would be appended
            (the stop token is excluded from the output).
        logit_bias: ``{token_id: additive_logit_bias}`` applied every
            step (OpenAI semantics). Bounded by the engine's
            ``sample_slots`` width.
        constraint: optional hook for structured decoding:
            ``fn(prompt_ids, output_ids) -> allowed_token_ids | None``.
            Called once per dispatch on the host; a non-None return
            masks every OTHER token to -inf, so the next token is
            sampled (or argmaxed) from the allowed set only. Return
            ``None`` for "unconstrained this step". The allowed set is
            bounded by ``sample_slots``.
    """

    __slots__ = ("temperature", "top_p", "top_k", "seed", "stop",
                 "logit_bias", "constraint")

    def __init__(self, temperature=0.0, top_p=1.0, top_k=0, seed=None,
                 stop=(), logit_bias=None, constraint=None):
        temperature = float(temperature)
        if not math.isfinite(temperature) or temperature < 0:
            raise ValueError(
                f"temperature must be finite and >= 0, got {temperature}")
        top_p = float(top_p)
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        top_k = int(top_k)
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {top_k}")
        if seed is not None:
            seed = int(seed)
            if not 0 <= seed < 2 ** 31:
                raise ValueError(
                    f"seed must be in [0, 2**31), got {seed}")
        stop = tuple(int(t) for t in (stop or ()))
        if logit_bias:
            logit_bias = {int(k): float(v)
                          for k, v in dict(logit_bias).items()}
            for v in logit_bias.values():
                if not math.isfinite(v):
                    raise ValueError("logit_bias values must be finite")
        else:
            logit_bias = None
        if constraint is not None and not callable(constraint):
            raise ValueError("constraint must be callable "
                             "(prompt_ids, output_ids) -> ids | None")
        self.temperature = temperature
        self.top_p = top_p
        self.top_k = top_k
        self.seed = seed
        self.stop = stop
        self.logit_bias = logit_bias
        self.constraint = constraint

    @property
    def is_greedy(self):
        return self.temperature == 0.0

    def __repr__(self):
        return (f"SamplingParams(temperature={self.temperature}, "
                f"top_p={self.top_p}, top_k={self.top_k}, "
                f"seed={self.seed}, stop={self.stop}, "
                f"logit_bias={self.logit_bias}, "
                f"constraint={'set' if self.constraint else None})")

    # -- rpc plumbing ---------------------------------------------------
    def to_spec(self):
        """JSON-able dict for the subprocess-replica submit spec.
        Constraint hooks are host callables and cannot cross the
        process boundary — typed error, never a silent drop."""
        if self.constraint is not None:
            raise ValueError(
                "SamplingParams.constraint is a host callable and "
                "cannot cross a subprocess-replica boundary; use an "
                "in-process engine/replica for constrained decoding")
        return {"temperature": self.temperature, "top_p": self.top_p,
                "top_k": self.top_k, "seed": self.seed,
                "stop": list(self.stop),
                "logit_bias": {str(k): v for k, v
                               in (self.logit_bias or {}).items()}}

    @classmethod
    def from_spec(cls, spec):
        if spec is None:
            return None
        return cls(temperature=spec.get("temperature", 0.0),
                   top_p=spec.get("top_p", 1.0),
                   top_k=spec.get("top_k", 0),
                   seed=spec.get("seed"),
                   stop=spec.get("stop") or (),
                   logit_bias={int(k): float(v) for k, v in
                               (spec.get("logit_bias") or {}).items()})


#: Shared default: plain greedy decode, no stops, no bias.
GREEDY = SamplingParams()


def biased_logits(logits, slot_ids, slot_vals, cmodes):
    """The f32 logits ``[N, V]`` after each row's bias slots are added
    (empty slots, id -1, add +0.0 to token 0, which changes no comparison)
    and, on constraint rows (``cmodes == 1``), every token outside the
    row's non-negative slot ids masked to ``-1e30``."""
    n, v = logits.shape
    ids = slot_ids.long()
    lg = logits.float().scatter_add(1, ids.clamp(0, v - 1), slot_vals.float())
    # allowed tokens: every listed id in [0, V); empty slots and ids past
    # the vocabulary go to a spare column (all writes are True, so their
    # order cannot matter)
    allowed = torch.zeros((n, v + 1), dtype=torch.bool, device=logits.device)
    allowed.scatter_(1, torch.where((ids >= 0) & (ids < v), ids, v),
                     torch.ones_like(ids, dtype=torch.bool))
    masked = (cmodes[:, None] == 1) & ~allowed[:, :v]
    return torch.where(masked, torch.full_like(lg, _MASKED), lg)


def keep_thresholds(ls, top_ps, top_ks):
    """Per row of the temperature-scaled logits ``ls [N, V]``: the least
    kept value, ``max(kth, pth)`` — the k-th largest (top-k, all for 0)
    and the last value of the shortest sorted prefix whose mass before it
    stays under top_p (at least one)."""
    v = ls.shape[1]
    sl = torch.sort(ls, dim=-1, descending=True).values
    kk = torch.where(top_ks > 0, top_ks.clamp(max=v), v).long()
    kth = sl.gather(1, (kk - 1)[:, None])
    sp = torch.softmax(sl, dim=-1)
    cum_before = torch.cumsum(sp, dim=-1) - sp
    n_keep = (cum_before < top_ps[:, None]).sum(dim=-1).clamp_min(1)
    pth = sl.gather(1, (n_keep - 1)[:, None])
    return torch.maximum(kth, pth)[:, 0]


def scaled_scores(lg, temps, top_ps, top_ks):
    """The temperature-scaled scores ``lg / max(temps, 1e-6)`` of the
    biased logits ``lg [N, V]`` and their keep thresholds
    (:func:`keep_thresholds`): what the Gumbel-max pass takes."""
    ls = lg / torch.clamp_min(temps.float(), 1e-6)[:, None]
    return ls, keep_thresholds(ls, top_ps.float(), top_ks)


def sampled_next_tokens(logits, temps, top_ps, top_ks, seeds, positions,
                        slot_ids, slot_vals, cmodes, any_sampled=True):
    """Vectorized per-row next-token rule.

    Args (tensors on the logits' device):
        logits:    [N, V] model logits (any float dtype).
        temps:     [N] f32, 0 = greedy (bitwise argmax of ``logits``).
        top_ps:    [N] f32 in (0, 1].
        top_ks:    [N] int, 0 = off.
        seeds:     [N] int per-request seeds.
        positions: [N] int absolute position of the token being
            sampled — the counter folded into the threefry key.
        slot_ids:  [N, B] int bias/constraint token ids (-1 = empty).
        slot_vals: [N, B] f32 additive logit bias per slot.
        cmodes:    [N] int; 0 = bias-only, 1 = constraint row (tokens
            outside the row's non-negative slot ids are masked out).
        any_sampled: whether some row has ``temps > 0``, as the host
            that packed ``temps`` knows; False skips the sort and the
            Gumbel pass, whose rows would all be discarded.

    Returns [N] int64 next-token ids.
    """
    lg = biased_logits(logits, slot_ids, slot_vals, cmodes)
    greedy = lg.argmax(dim=-1)
    if not any_sampled:
        return greedy
    ls, thr = scaled_scores(lg, temps, top_ps, top_ks)
    sampled = gumbel_argmax(ls, seeds, positions,
                            torch.zeros_like(positions, dtype=torch.int64),
                            thr)
    return torch.where(temps > 0, sampled, greedy)
