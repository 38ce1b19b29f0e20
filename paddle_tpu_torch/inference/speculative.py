"""Self-speculative decoding: n-gram / prompt-lookup drafting (port of
``paddle_tpu/inference/speculative.py``; host Python only).

Speculative decoding spreads one dispatch over several tokens: a cheap
*drafter* proposes ``k`` tokens, the model verifies all ``k+1`` positions
in ONE mixed dispatch (a verify row is a ``q_len = k+1`` decode row of
the ragged kernels), and the longest prefix of drafts that equals the
model's own continuation is accepted. Greedy outputs are token-exact by
construction: position ``i`` of the verify row computes the next token
the sequential engine would have computed over the same KV prefix, so
acceptance only commits tokens the non-speculative engine would have
emitted, and the pages of rejected drafts are rolled back through
:meth:`~paddle_tpu_torch.inference.paged_cache.PageAllocator.rollback`
before the next step.

This module is the drafter side. :class:`NGramDrafter` is
*self-speculative*: no extra model, no extra weights, a hashed n-gram
table over the request's own prompt + committed output (prompt-lookup
decoding). It wins where traffic repeats itself: code, few-shot
scaffolding, retrieval-stuffed prompts, and the short cycles greedy
decoding settles into. Where the history has no signal it proposes
nothing and the engine decodes one token a step as without speculation.

Engine integration lives in :mod:`paddle_tpu_torch.inference.serving`
(``LlamaServingEngine(spec_k=...)``); any object with this class's
``sync(prompt_ids, output_ids)`` / ``propose(k)`` surface can be plugged
in via ``drafter_factory`` (one drafter instance per live sequence).
"""

from __future__ import annotations

__all__ = ["NGramDrafter"]


class NGramDrafter:
    """Hashed n-gram prompt-lookup drafter for ONE sequence.

    The table maps every context of length ``1..n`` seen in the
    committed history (prompt + emitted output) to the token that
    followed it, most recent occurrence winning. A proposal walks the
    table greedily: look up the longest matching suffix of the current
    history, append the predicted token, repeat, up to ``k`` drafts or
    the first unseen context.

    Args:
        n: max context length (the "n" of the n-gram). Longer contexts
            are tried first, so a bigger ``n`` only ever sharpens
            proposals; 2-4 covers the repetition serving traffic shows.
        max_history: hard cap on indexed tokens (memory bound for
            pathological request lengths). Past it the table stops
            growing and the history keeps only the rolling n-token
            tail proposals need; what was indexed keeps proposing.
    """

    def __init__(self, n=3, max_history=65536):
        self.n = max(1, int(n))
        self.max_history = int(max_history)
        self._table: dict[tuple, int] = {}
        self._hist: list[int] = []
        self._seen = 0
        self._n_prompt = 0
        self._n_out = 0

    def _extend(self, tokens):
        h = self._hist
        for t in tokens:
            t = int(t)
            h.append(t)
            self._seen += 1
            if self._seen > self.max_history:
                # table frozen; only the last n tokens matter for
                # proposals, so the history stays bounded too
                del h[:-self.n]
                continue
            ln = len(h)
            for cl in range(1, self.n + 1):
                if ln - 1 - cl < 0:
                    break
                self._table[tuple(h[ln - 1 - cl:ln - 1])] = t

    def sync(self, prompt_ids, output_ids):
        """Fold the committed history (prompt once, then every output
        token not yet consumed) into the table. Idempotent and
        incremental: the engine calls this before each proposal, so the
        drafter never sees rejected drafts, only committed tokens."""
        n_out = len(output_ids)
        if self._n_prompt == 0 and len(prompt_ids):
            self._extend(prompt_ids)
            self._n_prompt = len(prompt_ids)
        if n_out < self._n_out:
            # history rewound under us (a caller reusing one drafter
            # across restarts): rebuild from scratch rather than serve
            # stale continuations
            self._table.clear()
            self._hist = []
            self._seen = 0
            self._n_prompt = 0
            self._n_out = 0
            self.sync(prompt_ids, output_ids)
            return
        if n_out > self._n_out:
            self._extend(output_ids[self._n_out:])
            self._n_out = n_out

    def propose(self, k):
        """Up to ``k`` draft tokens continuing the synced history
        (longest-context match first; stops at the first context the
        table has never seen). The drafts are predictions for the NEXT
        ``k`` engine outputs, in order."""
        sim = list(self._hist[-self.n:])
        out = []
        for _ in range(int(k)):
            t = None
            for cl in range(min(self.n, len(sim)), 0, -1):
                t = self._table.get(tuple(sim[-cl:]))
                if t is not None:
                    break
            if t is None:
                break
            out.append(t)
            sim.append(t)
        return out
