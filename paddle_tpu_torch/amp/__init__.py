"""Automatic mixed precision, level O1 (port of the reference package's
``amp.auto_cast`` and its op lists).

Inside ``auto_cast`` each op runs in the reference's dtype: white-list
ops (matmul class, attention) in the autocast dtype, bf16 by default;
black-list ops (losses, the log/exp family, long reductions) in f32;
every other op in its inputs' dtype. The reference applies the policy at
its one dispatch seam. Here it takes two routes:

- ``nn.Linear`` and ``torch.matmul`` get it from ``torch.autocast``,
  entered on the CPU and, where there is one, on the card, while both
  ``linear`` and ``matmul`` stay on the white list;
- the port's own ops (flash attention, ``scaled_dot_product_attention``,
  the loss functions) cast their inputs with :func:`cast_inputs` and run
  with ``torch.autocast`` off inside.

The fused linear cross-entropy is on neither list, so it runs on the f32
final-norm output and the f32 lm head, as in the reference. O2
``decorate`` and ``GradScaler`` are not ported yet (ROADMAP queue A,
item 9).
"""

from __future__ import annotations

import functools
import threading

import torch

from .amp_lists import BLACK_LIST, WHITE_LIST, black_list, white_list

__all__ = ["auto_cast", "cast_inputs", "op_dtype", "WHITE_LIST",
           "BLACK_LIST"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_local = threading.local()     # the active policies, innermost last


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


class _Policy:
    __slots__ = ("dtype", "white", "black")

    def __init__(self, dtype, white, black):
        self.dtype = dtype
        self.white = frozenset(white)
        self.black = frozenset(black)


def op_dtype(name):
    """The dtype op ``name`` runs in under the active policy, or None
    when its inputs keep theirs (no policy, or a gray op)."""
    st = _stack()
    if not st:
        return None
    pol = st[-1]
    if name in pol.white:
        return pol.dtype
    if name in pol.black:
        return torch.float32
    return None


def cast_inputs(name, *tensors):
    """``tensors`` with each floating one cast to :func:`op_dtype`
    ``(name)`` (unchanged when that is None)."""
    target = op_dtype(name)
    if target is None:
        return tensors
    return tuple(t.to(target) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != target else t
                 for t in tensors)


class auto_cast:
    """Context manager (or decorator) enabling autocast inside the
    region: ``auto_cast(enable=True, custom_white_list=None,
    custom_black_list=None, level='O1', dtype='bfloat16')``, the
    reference's signature. Nesting works; ``enable=False`` (or level
    ``O0``) turns autocast off inside an enabled region. Level ``O2``
    applies the same op policy (its model decoration is not ported)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"level must be O0/O1/O2, got {level!r}")
        if str(dtype) not in _DTYPES:
            raise ValueError(
                f"auto_cast dtype must be float16/bfloat16, got {dtype}")
        self._enable = bool(enable) and level != "O0"
        dt = _DTYPES[str(dtype)]
        if self._enable:
            self._policy = _Policy(
                dt, white_list(custom_white_list, custom_black_list),
                black_list(custom_white_list, custom_black_list))
        else:
            # explicit disable: a no-op policy shadowing any outer one
            self._policy = _Policy(torch.float32, (), ())
        self._torch_on = self._enable and \
            {"linear", "matmul"} <= self._policy.white
        self._dtype = dt
        self._ctx = []

    def __enter__(self):
        _stack().append(self._policy)
        devs = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
        for dev in devs:
            ctx = torch.autocast(dev, dtype=self._dtype,
                                 enabled=self._torch_on)
            ctx.__enter__()
            self._ctx.append(ctx)
        return self

    def __exit__(self, *exc):
        while self._ctx:
            self._ctx.pop().__exit__(*exc)
        _stack().pop()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return wrapped
