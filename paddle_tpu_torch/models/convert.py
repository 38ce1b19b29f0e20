"""Fill a port model from the reference package's parameters.

The reference stores a linear layer's weight as ``[in, out]``; a
``torch.nn.Linear`` weight is ``[out, in]``. Everything else (embedding
tables, norm weights) keeps its layout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_numpy_state"]


@torch.no_grad()
def load_numpy_state(model, arrays):
    """Copy ``arrays`` (``{state_dict name: np.ndarray}`` in the
    reference layout) into ``model``'s parameters, transposing linear
    weights and casting to each parameter's dtype and device. Raises
    :class:`ValueError` on any missing, extra or misshapen key."""
    linear = {name + ".weight" for name, mod in model.named_modules()
              if isinstance(mod, nn.Linear)}
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise ValueError(f"state mismatch: missing {missing}, "
                         f"unexpected {extra}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if name in linear:
            a = a.T
        if tuple(a.shape) != tuple(p.shape):
            want = tuple(p.shape)[::-1] if name in linear else tuple(p.shape)
            raise ValueError(
                f"{name}: got shape {tuple(np.asarray(arrays[name]).shape)}"
                f", expected {want}")
        p.copy_(torch.from_numpy(np.array(a)).to(p.dtype))
    return model
