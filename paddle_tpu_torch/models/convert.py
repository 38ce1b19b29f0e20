"""Fill a port module from the reference package's state.

The reference stores a linear layer's weight as ``[in, out]``; a
``torch.nn.Linear`` weight is ``[out, in]``, and so is the weight of a
``quantization.QuantedLinear`` (the QAT form keeps the torch layout).
Everything else keeps its layout: embedding tables, norm weights, the
router ``gate [D, E]`` and stacked expert weights ``[E, K, N]`` of the
Llama MoE FFN, ``MoELayer``'s ``gate_weight [D, E]``, ``w1``, ``b1``,
``w2`` and ``b2`` (parameters, not linear layers), and the int8 buffers
(``weight_int8``/``weight_scale`` of a ``WeightOnlyLinear`` or a
``quantization.ConvertedLinear``, ``*_proj``/``*_proj_scale`` of a
quantized MoE FFN), which are stored in the reference layout already.
So one loader takes a whole model, a lone ``MoELayer`` and a stack of
QAT or converted linears alike. A model placed over a mesh
(``shard_llama``, the tensor-parallel layers) takes the same global
arrays: each rank copies its own shard.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_numpy_state"]


@torch.no_grad()
def load_numpy_state(model, arrays):
    """Copy ``arrays`` (``{state_dict name: np.ndarray}`` in the
    reference layout) into ``model``'s parameters and buffers,
    transposing linear weights and casting to each tensor's dtype (int8
    buffers stay int8) and device. Raises :class:`ValueError` on any
    missing, extra or misshapen key. A quantized reference state needs
    a port model quantized with the same block first."""
    from ..distributed.mp_layers import ShardedLinear
    from ..quantization import QuantedLinear

    linear = {f"{name}.weight" if name else "weight"
              for name, mod in model.named_modules()
              if isinstance(mod, (nn.Linear, QuantedLinear, ShardedLinear))}
    targets = model.state_dict(keep_vars=True)
    missing = sorted(set(targets) - set(arrays))
    extra = sorted(set(arrays) - set(targets))
    if missing or extra:
        raise ValueError(f"state mismatch: missing {missing}, "
                         f"unexpected {extra}")
    for name, t in targets.items():
        a = np.asarray(arrays[name])
        if name in linear:
            a = a.T
        if tuple(a.shape) != tuple(t.shape):
            want = tuple(t.shape)[::-1] if name in linear else tuple(t.shape)
            raise ValueError(
                f"{name}: got shape {tuple(np.asarray(arrays[name]).shape)}"
                f", expected {want}")
        src = torch.from_numpy(np.array(a)).to(t.dtype)
        if type(t).__name__ == "DTensor":
            # a placed tensor takes this rank's shard of the global array
            from torch.distributed.tensor import distribute_tensor
            src = distribute_tensor(src.to(t.device), t.device_mesh,
                                    t.placements, src_data_rank=None)
            t.to_local().copy_(src.to_local())
        else:
            t.copy_(src)
    return model
