"""``paddle.save`` / ``paddle.load`` (port of the reference package's
``framework/io.py``).

Pickle-based object serialization in the reference's layout: every
tensor of a nested dict, list or tuple becomes a :class:`_TensorPayload`
holding its numpy buffer, dtype string, shape, ``stop_gradient``,
``is_param`` and name, with bfloat16 stored as its uint16 view; every
other value is pickled as it is.

:func:`load` reads the files the reference package writes too: its
payload class is mapped onto this module's by the unpickler
(:meth:`_Unpickler.find_class`), so the reference package is never
imported. The tensors come back on the host (CPU), as the file holds
them; ``Model.load`` and ``set_state_dict`` copy them into parameters
wherever those live. A file this module writes names this module's
payload class, so the reference's ``load`` returns its payloads
unconverted (ROADMAP, stated differences).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

_PROTO = 4

#: the module that holds the payload class in files the reference writes
_REFERENCE_MODULE = ".".join(("paddle_tpu", "framework", "io"))


def to_numpy(t):
    """A host copy of ``t`` that later changes of ``t`` leave alone, as
    ``(array, dtype name)``; bfloat16, which numpy lacks, as its uint16
    view. The one encoding of tensors on disk: :func:`save` and the
    sharded checkpoints (``distributed.checkpoint``) both write it."""
    t = t.detach()
    bf16 = t.dtype == torch.bfloat16
    if bf16:
        t = t.view(torch.int16)
    # from the card .cpu() copies; on the CPU it is the tensor itself
    a = t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
    if bf16:
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def from_numpy(a, dtype):
    """A tensor over ``a``, an array :func:`to_numpy` made (or the
    reference package wrote) with dtype name ``dtype``."""
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


class _TensorPayload:
    """Pickle-stable tensor container (numpy buffer + dtype string +
    flags), slot for slot the reference's."""

    __slots__ = ("buffer", "dtype", "shape", "stop_gradient", "is_param",
                 "name")

    def __init__(self, t: torch.Tensor):
        self.is_param = isinstance(t, torch.nn.Parameter)
        self.stop_gradient = not t.requires_grad
        self.name = getattr(t, "name", None)
        self.buffer, self.dtype = to_numpy(t)
        self.shape = tuple(t.shape)

    def restore(self, return_numpy=False):
        t = from_numpy(np.array(self.buffer, copy=True), self.dtype)
        if return_numpy:
            # numpy has no bfloat16: the values widened exactly
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        t = t.reshape(self.shape)
        trainable = not self.stop_gradient and t.is_floating_point()
        if self.is_param:
            return torch.nn.Parameter(t, requires_grad=trainable)
        return t.requires_grad_(trainable)


class _Unpickler(pickle.Unpickler):
    """Reads this module's files and the reference's: the reference's
    payload class resolves to :class:`_TensorPayload`."""

    def find_class(self, module, name):
        if module == _REFERENCE_MODULE and name == "_TensorPayload":
            return _TensorPayload
        return super().find_class(module, name)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        return obj.restore(return_numpy)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=_PROTO, **configs):
    """Save a tensor, a state dict or a nested object to ``path``. A
    module or optimizer is saved as its ``state_dict()`` (a module's with
    its parameters themselves, so ``is_param`` holds as in the
    reference)."""
    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict(keep_vars=True)
    elif hasattr(obj, "state_dict") and not isinstance(obj, dict):
        obj = obj.state_dict()
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """Load an object saved by :func:`save` or by the reference's
    ``save``; tensors come back on the host."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy=return_numpy)
