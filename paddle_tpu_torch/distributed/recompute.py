"""Activation recomputation (port of the reference package's
``distributed/recompute.py``): the segment's forward re-runs in the
backward instead of keeping its activations, through
``torch.utils.checkpoint`` (non-reentrant). RNG state is replayed, as
the reference's ``preserve_rng_state=True`` does.

``policy="dots"`` is the reference's ``dots_with_no_batch_dims_saveable``
policy as a selective checkpoint: the outputs of the products without
batch dimensions (``aten.mm``, ``aten.addmm``: every ``nn.Linear``) are
saved, everything else is recomputed in the backward: the batched
products (``aten.bmm``), the attention kernels' autograd functions, the
norms and the elementwise ops.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint

__all__ = ["recompute", "DOTS_SAVED"]

#: the ops whose outputs ``policy="dots"`` keeps
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in DOTS_SAVED:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return checkpoint.create_selective_checkpoint_contexts(_dots_policy)


def recompute(function, *args, preserve_rng_state=True, policy=None,
              **kwargs):
    """``function(*args, **kwargs)`` with activation checkpointing.
    ``function`` may be an ``nn.Module`` (its parameters keep their
    gradients) or any callable. ``policy=None`` recomputes the whole
    segment; ``policy="dots"`` keeps the outputs of the products without
    batch dimensions (see the module docstring)."""
    extra = {}
    if policy == "dots":
        extra["context_fn"] = _dots_context
    elif policy is not None:
        raise ValueError(f"unknown recompute policy {policy!r}")
    return checkpoint.checkpoint(function, *args, use_reentrant=False,
                                 preserve_rng_state=preserve_rng_state,
                                 **extra, **kwargs)
