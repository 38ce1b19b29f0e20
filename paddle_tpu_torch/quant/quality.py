"""Quality gate: a quantized model against its float model on bundled
prompts (port of the reference package's ``quant/quality.py``).

- ``greedy_match``: teacher-forced position-wise argmax agreement of the
  two models over every prompt position (both read the same prefix at
  every position, so it measures per-step decision flips, not
  compounding divergence); bar :data:`GREEDY_MATCH_BAR`.
- ``max_err`` / ``mean_err``: absolute logits error, judged against the
  float model's largest logit; bars :data:`LOGITS_MAX_ERR_REL` /
  :data:`LOGITS_MEAN_ERR_REL`.

The prompts are real ASCII text, byte-tokenized (token id = byte value,
the serving front door's ``ByteTokenizer``), bundled here so the gate
needs no download and every environment measures the same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..observability import metrics as _om

__all__ = ["GREEDY_MATCH_BAR", "LOGITS_MAX_ERR_REL",
           "LOGITS_MEAN_ERR_REL", "bundled_prompts",
           "bundled_prompt_ids", "fit_on_prompts", "logits_quality"]

#: fraction of teacher-forced positions whose argmax must agree
GREEDY_MATCH_BAR = 0.99

#: max abs logits error budget, as a fraction of max |float logit|
LOGITS_MAX_ERR_REL = 0.05

#: mean abs logits error budget, as a fraction of max |float logit|
LOGITS_MEAN_ERR_REL = 0.01

#: real-text ASCII prompts (byte-tokenizable under any vocab >= 128)
_PROMPTS = (
    "The quick brown fox jumps over the lazy dog.",
    "In the beginning the framework compiled one program per shape.",
    "Weight-only quantization halves the bytes a decode step moves.",
    "A page table maps each sequence to its cached key-value pages.",
    "def attention(q, k, v):\n    return softmax(q @ k.T) @ v\n",
    "To be, or not to be, that is the question.",
)


def bundled_prompts():
    """The raw bundled prompt strings."""
    return list(_PROMPTS)


def bundled_prompt_ids(vocab_size=None):
    """Byte-encode the bundled prompts (id = byte value). ``vocab_size``
    (when given) wraps ids into range for sub-byte vocabularies."""
    out = []
    for p in _PROMPTS:
        ids = list(p.encode("utf-8"))
        if vocab_size:
            ids = [i % int(vocab_size) for i in ids]
        out.append(ids)
    return out


def _device(model):
    return next(model.parameters()).device


def fit_on_prompts(model, steps=40, lr=1e-2):
    """Briefly fit ``model`` on next-token prediction of the bundled
    prompts (the port's ``Adam``, on the model's device).

    A random-init model's logits are near-iid, so its argmax margins are
    ties and greedy-match would measure tie-breaking noise instead of
    quantization damage; a few fitting steps give decisive margins.
    Returns the final loss."""
    from ..optimizer import Adam

    ids = bundled_prompt_ids(model.config.vocab_size)
    width = max(len(i) for i in ids)
    x = np.zeros((len(ids), width), np.int64)
    y = np.full((len(ids), width), -100, np.int64)
    for row, seq in enumerate(ids):
        x[row, :len(seq)] = seq
        y[row, :len(seq) - 1] = seq[1:]
    dev = _device(model)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    opt = Adam(learning_rate=lr, parameters=model.parameters())
    loss = None
    for _ in range(int(steps)):
        loss, _ = model(xt, labels=yt)
        loss.backward()
        opt.step()
        opt.clear_grad()
    return float(loss.detach()) if loss is not None else float("nan")


@torch.no_grad()
def logits_quality(model_fp, model_q, prompts=None):
    """Teacher-forced comparison of two ``LlamaForCausalLM``-shaped
    models (``model(ids) -> logits``) over the bundled prompts.

    Returns ``{"max_err", "mean_err", "ref_scale" (max |float logit|),
    "greedy_match", "positions", "passes" (all bars hold)}`` and
    publishes the three quality-gate gauges."""
    vocab = getattr(getattr(model_fp, "config", None), "vocab_size", None)
    if prompts is None:
        prompts = bundled_prompt_ids(vocab)
    dev = _device(model_fp)
    max_err = 0.0
    err_sum = 0.0
    ref_scale = 0.0
    count = 0
    match = 0
    total = 0
    for ids in prompts:
        x = torch.tensor([ids], dtype=torch.long, device=dev)
        lf = model_fp(x).float().cpu().numpy()[0]        # [T, V]
        lq = model_q(x).float().cpu().numpy()[0]
        d = np.abs(lf - lq)
        max_err = max(max_err, float(d.max()))
        err_sum += float(d.sum())
        count += d.size
        ref_scale = max(ref_scale, float(np.abs(lf).max()))
        match += int((lf.argmax(-1) == lq.argmax(-1)).sum())
        total += lf.shape[0]
    mean_err = err_sum / max(count, 1)
    greedy = match / max(total, 1)
    scale = max(ref_scale, 1.0)
    report = {
        "max_err": max_err,
        "mean_err": mean_err,
        "ref_scale": ref_scale,
        "greedy_match": greedy,
        "positions": total,
        "passes": bool(greedy >= GREEDY_MATCH_BAR
                       and max_err <= LOGITS_MAX_ERR_REL * scale
                       and mean_err <= LOGITS_MEAN_ERR_REL * scale),
    }
    _om.gauge(
        "quant_greedy_match_rate",
        "teacher-forced argmax agreement of the weight-quantized "
        "model vs float on the bundled prompts (bar 0.99)"
    ).set(greedy)
    _om.gauge(
        "quant_logits_max_err",
        "max abs logits error of the weight-quantized model vs float "
        "on the bundled prompts").set(max_err)
    _om.gauge(
        "quant_logits_mean_err",
        "mean abs logits error of the weight-quantized model vs float "
        "on the bundled prompts").set(mean_err)
    return report
