"""Global runtime flag registry (a copy of the reference package's
``flags.py``, which the port cannot import: importing any module of that
package loads its runtime).

The analog of the exported-flag system of Paddle (``paddle/common/
flags.h``, surfaced in Python as ``paddle.set_flags`` /
``paddle.get_flags``). Flags are plain Python values; each may be seeded
from an environment variable ``FLAGS_<name>`` when it is defined.

The port registers the reference's flags under the same names and
defaults. It reads those whose readers it has ported:

- ``check_nan_inf``: the tensor checker of
  :mod:`paddle_tpu_torch.amp.debugging` (``enable_tensor_checker``);
- ``comm_timeout_seconds``: the bound that
  :func:`paddle_tpu_torch.distributed.init_parallel_env` gives the
  rendezvous and every collective.

The rest are accepted, stored and returned, and have no effect in the
port: ``benchmark``, ``low_precision_op_list``, the compat labels
``eager_delete_tensor_gb`` and ``allocator_strategy``, and
``use_pallas_kernels``: every hand-written kernel of the port runs on a
CUDA tensor, and no flag switches one off for its plain version.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

__all__ = ["define_flag", "set_flags", "get_flags", "flag"]

_lock = threading.Lock()


class _Flag:
    __slots__ = ("name", "value", "default", "help", "type", "on_change")

    def __init__(self, name, default, help_str, typ, on_change=None):
        self.name = name
        self.default = default
        self.help = help_str
        self.type = typ
        self.on_change = on_change
        self.value = self._from_env(default)

    def _from_env(self, default):
        env = os.environ.get("FLAGS_" + self.name)
        if env is None:
            return default
        return _parse(env, self.type)


def _parse(text: str, typ: type) -> Any:
    if typ is bool:
        return text.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(text)
    if typ is float:
        return float(text)
    return text


_REGISTRY: dict[str, _Flag] = {}


def define_flag(name: str, default: Any, help_str: str = "",
                on_change: Callable[[Any], None] | None = None) -> None:
    """Register a runtime flag (analog of ``PHI_DEFINE_EXPORTED_*``)."""
    with _lock:
        if name in _REGISTRY:
            raise KeyError(f"flag '{name}' already defined")
        _REGISTRY[name] = _Flag(name, default, help_str, type(default),
                                on_change)


def set_flags(flags: dict[str, Any]) -> None:
    """Set one or more flags (``paddle.set_flags`` equivalent)."""
    with _lock:
        for name, value in flags.items():
            key = name[6:] if name.startswith("FLAGS_") else name
            if key not in _REGISTRY:
                raise KeyError(f"unknown flag '{name}'")
            f = _REGISTRY[key]
            if isinstance(value, str) and f.type is not str:
                value = _parse(value, f.type)
            f.value = value
            if f.on_change is not None:
                f.on_change(value)


def get_flags(flags: list[str] | str | None = None) -> dict[str, Any]:
    """Read flags (``paddle.get_flags`` equivalent)."""
    if flags is None:
        names = list(_REGISTRY)
    elif isinstance(flags, str):
        names = [flags]
    else:
        names = list(flags)
    out = {}
    for name in names:
        key = name[6:] if name.startswith("FLAGS_") else name
        if key not in _REGISTRY:
            raise KeyError(f"unknown flag '{name}'")
        out["FLAGS_" + key] = _REGISTRY[key].value
    return out


def flag(name: str) -> Any:
    """Fast internal accessor for a single flag value."""
    return _REGISTRY[name].value


# ---------------------------------------------------------------------------
# Core flags: the reference's set, names and defaults as they are (the
# module docstring says which the port reads).
# ---------------------------------------------------------------------------
define_flag("check_nan_inf", False,
            "Check outputs of every op for NaN/Inf in eager mode "
            "(reference: FLAGS_check_nan_inf).")
define_flag("benchmark", False, "Compat: no effect in the port.")
define_flag("low_precision_op_list", 0, "Compat: no effect in the port.")
define_flag("use_pallas_kernels", True,
            "Compat: no effect in the port (no flag switches a hand-written "
            "kernel off for its plain version).")
define_flag("comm_timeout_seconds", 1800,
            "Collective timeout: bounds init_parallel_env's rendezvous "
            "and every collective of its world.")
define_flag("eager_delete_tensor_gb", 0.0, "Compat: no effect in the port.")
define_flag("allocator_strategy", "auto_growth",
            "Compat: allocator strategy label (no effect in the port).")
