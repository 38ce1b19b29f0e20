"""Quantized checkpoints on the ``CheckpointManager`` contract (port of
the reference package's ``quant/checkpoint.py``).

``save_quantized`` writes the int8 weights and f32 scale sidecars
through the same two-phase commit ``CheckpointManager`` gives training
state (a ``step_N.tmp`` directory, fsync, a ``COMMITTED`` marker with
each file's size and CRC-32, an atomic rename), so a torn quantized
checkpoint cannot be read and ``verify_step`` audits it like any other.
npz stores int8 as one byte an element and the sidecars as f32.

``load_quantized`` restores into a model: a float model is first
quantized (``quantize_model``) so every target tensor exists with the
saved dtype and shape, then ``restore_latest`` verifies the CRCs and
loads over it. The block size must match the one the checkpoint was
saved with (the sidecars' shapes are part of the format); it is read
from the checkpoint when not given.

The files are the reference's: a float ``torch.nn.Linear`` left in the
model (``lm_head`` stays float) is written in the reference's ``[in,
out]`` layout and read back transposed, so a checkpoint written by
either package loads in the other.
"""

from __future__ import annotations

import glob
import json
import os

from torch import nn

from ..distributed.checkpoint_manager import CheckpointManager
from .format import is_quantized, model_weight_block, quantize_model

__all__ = ["save_quantized", "load_quantized"]


def _reference_layout(model):
    """The model's state as the reference names and lays it out: each
    ``nn.Linear`` weight as a transposed view (a load writes through
    it)."""
    state = dict(model.state_dict())
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            key = f"{name}.weight" if name else "weight"
            state[key] = state[key].t()
    return state


def save_quantized(model, root, step=0, block=None, max_to_keep=5):
    """Quantize ``model`` in place (if not already) and commit its state
    under ``root``; returns the committed step directory."""
    if not is_quantized(model):
        quantize_model(model, block=block)
    mgr = CheckpointManager(root, max_to_keep=max_to_keep, async_save=False)
    # the block size rides along as a checkpoint object, so a cold
    # restore does not need it out of band (ceil(K/b) does not determine b)
    state = _reference_layout(model)
    state["quant_meta"] = {"block": int(model_weight_block(model))}
    mgr.save(state, step, blocking=True)
    return mgr.step_dir(step)


def _saved_block(mgr):
    """The block size ``save_quantized`` recorded in the newest committed
    step, or None (no checkpoint, or one without it)."""
    steps = mgr.committed_steps()
    if not steps:
        return None
    d = mgr.step_dir(steps[-1])
    for mf in sorted(glob.glob(os.path.join(d, "metadata_p*.json"))):
        try:
            with open(mf) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue
        b = meta.get("objects", {}).get("quant_meta.block")
        if b is not None:
            return int(b)
    return None


def load_quantized(model, root, block=None):
    """Restore the latest quantized checkpoint under ``root`` into
    ``model`` (quantizing a float model first); returns the restored
    step, or None when no committed checkpoint exists. ``block=`` only
    matters for a checkpoint that does not record its block."""
    mgr = CheckpointManager(root, async_save=False)
    if not is_quantized(model):
        if block is None:
            block = _saved_block(mgr)
        quantize_model(model, block=block)
    # the model's own keys; the checkpoint's quant_meta is peek-only
    return mgr.restore_latest(_reference_layout(model))
