"""AMP debugging tools (port of the reference package's
``amp/debugging.py``: operator stats, the tensor checker, accuracy
comparison).

- ``collect_operator_stats``: a context manager counting op executions
  by output dtype, printed as the reference's four-column table. The
  reference counts at its ``run_op`` observers; the port counts at its
  dispatch seam (:mod:`paddle_tpu_torch.framework.dispatch`), so the
  names are torch's aten ops (``mm``, ``add``, ``_softmax``,
  ``_to_copy``), plus one op under the reference's name for each call of
  the port's own kernels and fused ops (``flash_attention``,
  ``fused_linear_cross_entropy``, ``grouped_gemm``, ``rms_norm``, ...).
  The seam also counts the ops of the backward (the reference counts
  only the forward's eager ops): on the CPU the backward runs on the
  caller's thread, and on the card torch carries the caller's dispatch
  modes to the autograd engine's threads.
- ``enable_tensor_checker`` / ``disable_tensor_checker``: the
  ``FLAGS_check_nan_inf`` switch. Every floating output of an op is
  checked for NaN and Inf, and a hit raises :class:`FloatingPointError`
  naming the op. The check syncs nothing while a CUDA graph is being
  captured or a compiled step (``jit.to_static``) runs, where the
  reference skips its tracers.
- ``check_numerics``: count NaN and Inf in one tensor on its device.
- ``compare_accuracy``: run a function under two dtypes and report the
  per-output max abs / rel error.

The seam is installed only while stats collection or the checker is on,
on the thread that turned it on; with both off no dispatch mode is
installed and nothing syncs.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from .. import flags
from ..framework import dispatch as _dispatch

__all__ = ["collect_operator_stats", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "enable_tensor_checker",
           "disable_tensor_checker", "check_numerics", "compare_accuracy"]

_op_stats = None
_COLUMNS = {torch.float16: "fp16", torch.bfloat16: "bf16",
            torch.float32: "fp32"}


def _observer(name, outs):
    if _op_stats is None:
        return
    for o in outs:
        col = _COLUMNS.get(getattr(o, "dtype", None), "other")
        _op_stats[name][col] += 1


def enable_operator_stats_collection():
    """Start counting op calls by output dtype (reference
    ``enable_operator_stats_collection``)."""
    global _op_stats
    _op_stats = collections.defaultdict(
        lambda: {"fp16": 0, "bf16": 0, "fp32": 0, "other": 0})
    if _observer not in _dispatch.observers:
        _dispatch.observers.append(_observer)
    _dispatch.sync()


def disable_operator_stats_collection():
    """Stop collecting and print the dtype table; returns ``{op: {"fp16",
    "bf16", "fp32", "other"}}``."""
    global _op_stats
    if _op_stats is None:
        return {}
    try:
        _dispatch.observers.remove(_observer)
    except ValueError:
        pass
    _dispatch.sync()
    stats, _op_stats = dict(_op_stats), None
    w = max([len(k) for k in stats] + [8])
    print("<------------------------------ op list "
          "------------------------------->")
    print(f"{'op':<{w}}  {'fp16':>6} {'bf16':>6} {'fp32':>6} {'other':>6}")
    for name in sorted(stats):
        s = stats[name]
        print(f"{name:<{w}}  {s['fp16']:>6} {s['bf16']:>6} {s['fp32']:>6} "
              f"{s['other']:>6}")
    print("<----------------------------------- end "
          "---------------------------------->")
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def enable_tensor_checker():
    """NaN / Inf checking of every op's outputs (the reference's debug
    mode: ``FLAGS_check_nan_inf``)."""
    flags.set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    flags.set_flags({"FLAGS_check_nan_inf": False})


def _on_flag(_value):
    _dispatch.sync()


# setting the flag directly (``set_flags``) installs or removes the seam
flags._REGISTRY["check_nan_inf"].on_change = _on_flag
if flags.flag("check_nan_inf"):         # FLAGS_check_nan_inf=1 at start
    _dispatch.sync()


def check_numerics(tensor, op_name="", var_name=""):
    """Returns ``(num_nan, num_inf)`` as Python ints, counted on the
    tensor's own device (one read of two numbers). A hit prints the
    reference's line, increments ``paddle_tpu_nan_inf_detected_total{op,
    var}`` and triggers the flight recorder when one is installed."""
    t = tensor if isinstance(tensor, torch.Tensor) else torch.as_tensor(
        np.asarray(tensor))
    if t.is_floating_point() or t.is_complex():
        n_nan, n_inf = (int(v) for v in torch.stack(
            [torch.isnan(t).sum(), torch.isinf(t).sum()]).tolist())
    else:
        n_nan = n_inf = 0
    if n_nan or n_inf:
        print(f"[check_numerics] op={op_name} var={var_name} "
              f"num_nan={n_nan} num_inf={n_inf}")
        from ..observability import flight_recorder as _fr
        from ..observability import metrics as _om
        _om.counter("paddle_tpu_nan_inf_detected_total",
                    "non-finite values caught by check_numerics",
                    labelnames=("op", "var")) \
            .labels(op_name or "(unknown)", var_name or "(unknown)").inc()
        _fr.on_fatal("check_numerics", op=op_name, var=var_name,
                     num_nan=n_nan, num_inf=n_inf)
    return n_nan, n_inf


def _dtype(dt):
    return getattr(torch, dt) if isinstance(dt, str) else dt


def compare_accuracy(fn, args, dtypes=("float32", "bfloat16"), atol=None):
    """Run ``fn(*args)`` once per dtype (floating tensor arguments cast)
    and report per-output max-abs / max-rel deltas against the first
    dtype: ``{dtype: [{"max_abs_err", "max_rel_err"}, ...]}``."""
    def cast_all(dt):
        return [a.to(_dtype(dt)) if isinstance(a, torch.Tensor)
                and a.is_floating_point() else a for a in args]

    results = {}
    for dt in dtypes:
        r = fn(*cast_all(dt))
        results[dt] = [o.detach().to(torch.float64).cpu().numpy()
                       for o in (r if isinstance(r, (tuple, list))
                                 else (r,))]
    base = results[dtypes[0]]
    report = {}
    for dt in dtypes[1:]:
        per_out = []
        for a, b in zip(base, results[dt]):
            diff = np.abs(a - b)
            per_out.append({
                "max_abs_err": float(diff.max()) if diff.size else 0.0,
                "max_rel_err": float(
                    (diff / (np.abs(a) + 1e-12)).max()) if diff.size
                else 0.0,
            })
        report[dt] = per_out
    return report
