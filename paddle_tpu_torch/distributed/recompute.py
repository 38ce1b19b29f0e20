"""Activation recomputation (port of the reference package's
``distributed/recompute.py``): the segment's forward re-runs in the
backward instead of keeping its activations, through
``torch.utils.checkpoint`` (non-reentrant). RNG state is replayed, as
the reference's ``preserve_rng_state=True`` does.
"""

from __future__ import annotations

from torch.utils import checkpoint

__all__ = ["recompute"]


def recompute(function, *args, preserve_rng_state=True, policy=None,
              **kwargs):
    """``function(*args, **kwargs)`` with activation checkpointing.
    ``function`` may be an ``nn.Module`` (its parameters keep their
    gradients) or any callable. ``policy="dots"`` (keep the matmul
    outputs) is not ported yet and raises."""
    if policy == "dots":
        raise NotImplementedError(
            "recompute policy 'dots' is not ported yet (ROADMAP queue A, "
            "item 9)")
    if policy is not None:
        raise ValueError(f"unknown recompute policy {policy!r}")
    return checkpoint.checkpoint(function, *args, use_reentrant=False,
                                 preserve_rng_state=preserve_rng_state,
                                 **kwargs)
