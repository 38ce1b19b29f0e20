"""The port's op dispatch seam (counterpart of the reference package's
``run_op`` observers and its ``FLAGS_check_nan_inf`` check, which sit in
its one eager-op executor).

The port runs torch's own ops, so its seam is a
``torch.utils._python_dispatch.TorchDispatchMode`` (:class:`OpSeam`): it
sees every aten op below autograd and autocast, on this thread and in the
backward the autograd engine runs for it. It is pushed onto the thread's
mode stack only while an observer is registered or
``FLAGS_check_nan_inf`` is set (:func:`sync`), and popped when neither
is: with both off no mode is installed and an op dispatches exactly as
it would without this module.

The port's own kernels launch through their libraries, not through aten,
so the seam would not see them. Their public wrappers (flash attention,
the fused cross-entropy, the grouped GEMMs, the dequant matmul, the
paged and ragged attention) and the fused incubate ops are marked with
:func:`op`: while the seam is installed such a call is one op under the
reference's name, its outputs observed and checked, and the aten ops
inside it are not seen. Without the seam the mark costs one global read
and a look at each positional argument's type: a ``DTensor`` is refused
(the kernels have no sharding rule; a placed layer takes them its local
shards on purpose).
"""

from __future__ import annotations

import functools
import threading

import torch
from torch.utils._python_dispatch import (TorchDispatchMode, _pop_mode,
                                          _push_mode)

from .. import flags

__all__ = ["OpSeam", "op", "observers", "sync", "installed",
           "check_outputs"]

#: callables ``observer(op_name, outputs)``, called after each op the
#: seam sees (outputs a tuple)
observers = []

_lock = threading.Lock()
_local = threading.local()
#: the installed seam (one a process) and the thread it is installed on
_seam = None
_seam_thread = None


def installed():
    """True when the seam is on this thread's mode stack."""
    return _seam is not None and _seam_thread == threading.get_ident()


def _skip_check():
    """The checker syncs nothing while a CUDA graph is being captured or
    while a compiled step runs (the reference skips tracers). The second
    is read process-wide: the backward of a step on the card runs on the
    autograd engine's device threads."""
    if torch.cuda.is_available() and torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        return True
    from ..jit import compiled_steps_running
    return compiled_steps_running() > 0


#: aten ops whose outputs are memory nobody has written yet (the
#: reference's ops have none): their bits are whatever the allocator held,
#: NaN as often as not, so the checker skips them
UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided",
                           "empty_permuted", "new_empty",
                           "new_empty_strided", "resize_"})


def check_outputs(name, outs):
    """Raise :class:`FloatingPointError` when a floating output of op
    ``name`` holds a NaN or an Inf (one host read per output); the
    outputs of an op in :data:`UNINITIALIZED` are not read."""
    if name in UNINITIALIZED or _skip_check():
        return
    for o in outs:
        if isinstance(o, torch.Tensor) and o.is_floating_point() \
                and o.numel() and not bool(torch.isfinite(o).all()):
            raise FloatingPointError(
                f"Operator '{name}' output contains NaN/Inf "
                f"(FLAGS_check_nan_inf is set).")


def _flat(out):
    if isinstance(out, (tuple, list)):
        return tuple(out)
    return (out,)


def _seen(name, out):
    outs = _flat(out)
    if flags.flag("check_nan_inf"):
        check_outputs(name, outs)
    for obs in list(observers):
        obs(name, outs)


class OpSeam(TorchDispatchMode):
    """Every aten op under it is observed by its overload packet's name
    (``mm``, ``add``, ``_softmax``, ``_to_copy``); ops inside a call
    marked with :func:`op` are not."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(_local, "depth", 0):
            _seen(func.overloadpacket.__name__, out)
        return out


def sync():
    """Install the seam on this thread when an observer is registered or
    ``FLAGS_check_nan_inf`` is set, and remove it when neither is.
    Returns whether it is installed."""
    global _seam, _seam_thread
    want = bool(observers) or bool(flags.flag("check_nan_inf"))
    with _lock:
        if want and _seam is None:
            _seam = OpSeam()
            _push_mode(_seam)
            _seam_thread = threading.get_ident()
        elif not want and _seam is not None:
            if _seam_thread != threading.get_ident():
                raise RuntimeError("the op seam is removed on the thread "
                                   "that installed it")
            popped = _pop_mode()
            if popped is not _seam:
                _push_mode(popped)
                raise RuntimeError("another dispatch mode was entered "
                                   "above the op seam and is still active")
            _seam = _seam_thread = None
    return _seam is not None


def _refuse_dtensor(name):
    raise TypeError(
        f"{name} takes plain tensors, not a DTensor: the port's ops have "
        "no sharding rule, so a placed layer runs them on its local shards "
        "(DTensor.to_local(), see paddle_tpu_torch.distributed.plan)")


def op(name):
    """Mark a function as one op ``name`` of the seam (module
    docstring)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            for a in args:
                if type(a).__name__ == "DTensor":
                    _refuse_dtensor(name)
            if _seam is None or _seam_thread != threading.get_ident():
                return fn(*args, **kwargs)
            depth = getattr(_local, "depth", 0)
            _local.depth = depth + 1
            try:
                out = fn(*args, **kwargs)
                if not depth:       # the check's own ops are not seen
                    _seen(name, out)
            finally:
                _local.depth = depth
            return out
        return wrapper
    return deco
