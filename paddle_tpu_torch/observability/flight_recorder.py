"""Crash flight recorder: a bounded ring of recent telemetry + a
post-mortem bundle dumped on fatal errors (the port of
``paddle_tpu/observability/flight_recorder.py``, its device queries
rebuilt on ``torch.cuda``).

A serving engine that dies on a device error, a stalled dispatch under
the step watchdog, or a perf regression leaves nothing behind but a
stack trace. The flight recorder keeps the last few minutes of cheap
telemetry — host spans (the trace ring), compile events (the compile
watcher's ring: kernel builds and loads, CUDA-graph captures), and
periodic metric snapshots — and on a fatal signal writes a post-mortem
bundle under ``<log_dir>/postmortem/<run>/``:

- ``trace.json`` — chrome trace (spans + compile events); loads in
  Perfetto / ``chrome://tracing``.
- ``metrics.json`` — strict-JSON registry snapshot plus the ring of
  periodic snapshots (round-trips through ``json.loads``).
- ``compile_log.txt`` — one line per recent compile event.
- ``env.json`` — the reason, environment/config (PADDLE*, TORCH*,
  PYTORCH*, CUDA*, NCCL* env vars), torch and CUDA versions, the cards,
  the caching allocator's ``torch.cuda.memory_stats()`` and
  ``torch.cuda.mem_get_info()``, argv, pid.
- ``error.txt`` — the traceback, when an exception triggered the dump.

A bundle is written after a sticky CUDA error too (an illegal address, a
device-side assert): the dumper calls nothing that synchronises the
device, reads the card only where CUDA was initialised already, and
guards each device query on its own, so a failing query costs its key,
never the bundle.

:func:`install` hooks ``sys.excepthook``; the step watchdog's timeout
path, the perf sentinel and the serving engine's fatal paths call
:func:`on_fatal`. The module-level :func:`dump` is the manual trigger.
All of it obeys the metrics kill switch: under ``PADDLE_TPU_METRICS=0``
``install()`` is a no-op and no files are ever written.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque

from . import trace as otrace
from .export import _json_value, json_snapshot
from .metrics import default_registry, enabled

__all__ = ["FlightRecorder", "install", "uninstall", "installed", "dump",
           "on_fatal", "periodic_snapshot"]

#: dump ceiling per process — repeated NaN hits must not fill the disk
MAX_DUMPS = 8

#: minimum seconds between exception-less dumps from the SAME origin
#: (a NaN storm across ops in one bad step must not burn the whole
#: MAX_DUMPS budget before a genuinely distinct fatal gets its bundle)
ORIGIN_DUMP_INTERVAL = 30.0

_installed: "FlightRecorder | None" = None
_install_lock = threading.Lock()
_last_origin_dump: dict = {}


def _json_safe(obj):
    """Recursively make ``obj`` strict-JSON serializable: non-finite
    floats become their Prometheus markers (a NaN span arg — the very
    blow-up the recorder exists for — must not make trace.json
    unloadable) and unknown types stringify instead of aborting the
    dump."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        # one marker convention for the whole package: the exporter's
        # "+Inf"/"-Inf"/"NaN" rendering (export._json_value)
        return _json_value(obj)
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return str(obj)


class FlightRecorder:
    """Bounded telemetry ring + post-mortem dumper for one process."""

    def __init__(self, log_dir="./paddle_tpu_log", snapshot_interval=15.0,
                 snapshot_capacity=32, registry=None, trace_buffer=None):
        self.log_dir = str(log_dir)
        self.snapshot_interval = float(snapshot_interval)
        self._registry = registry
        self._trace_buffer = trace_buffer
        self._snapshots: deque = deque(maxlen=int(snapshot_capacity))
        self._last_snapshot = 0.0
        self._snap_lock = threading.Lock()
        self._dump_lock = threading.Lock()
        self._dumps = 0
        self._prev_excepthook = None
        self._hooked = False

    # -- periodic telemetry ---------------------------------------------
    def note_snapshot(self, force=False):
        """Append a metrics snapshot to the ring, rate-limited to one per
        ``snapshot_interval`` seconds (cheap enough for per-step call
        sites). No-op under ``PADDLE_TPU_METRICS=0``."""
        if not enabled():
            return False
        now = time.monotonic()
        with self._snap_lock:
            if not force and now - self._last_snapshot \
                    < self.snapshot_interval:
                return False
            self._last_snapshot = now
        reg = self._registry if self._registry is not None \
            else default_registry()
        entry = {"unix_time": time.time(), "snapshot": json_snapshot(reg)}
        # append under the lock: a crash dump snapshots the ring with
        # list() from another thread (watchdog/excepthook), and a
        # concurrent unlocked append would raise mid-iteration and cost
        # the bundle its metrics.json
        with self._snap_lock:
            self._snapshots.append(entry)
        return True

    # -- hooks ----------------------------------------------------------
    def install(self):
        """Hook ``sys.excepthook`` (chains to the previous hook) and
        register as the process's active recorder."""
        global _installed
        if not self._hooked:
            self._hooked = True
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._excepthook
        _installed = self
        return self

    def uninstall(self):
        global _installed
        if self._hooked:
            self._hooked = False
            # only unhook if nobody hooked after us
            if sys.excepthook is self._excepthook:
                sys.excepthook = self._prev_excepthook \
                    or sys.__excepthook__
        if _installed is self:
            _installed = None

    def _excepthook(self, exc_type, exc, tb):
        # _hooked check: when another library layered its hook over ours
        # and uninstall() therefore couldn't unhook, we stay in its
        # chain — chain through, but an uninstalled recorder must not
        # keep writing bundles
        if self._hooked \
                and not issubclass(exc_type,
                                   (KeyboardInterrupt, SystemExit)) \
                and not getattr(exc, "_paddle_tpu_fr_dumped", False):
            try:
                self.dump(reason="excepthook", exc=(exc_type, exc, tb))
            except Exception:
                pass            # the original error must still surface
        prev = self._prev_excepthook or sys.__excepthook__
        prev(exc_type, exc, tb)

    # -- the bundle -----------------------------------------------------
    def dump(self, reason="manual", exc=None, info=None):
        """Write one post-mortem bundle; returns its directory, or None
        when disabled / over the per-process dump ceiling."""
        if not enabled():
            return None
        with self._dump_lock:
            if self._dumps >= MAX_DUMPS:
                return None
            self._dumps += 1
            out_dir = os.path.join(self.log_dir, "postmortem",
                                   otrace.unique_run_name())
            os.makedirs(out_dir, exist_ok=True)
            # each artifact independently: one bad writer must not cost
            # the rest of the bundle (the budget is already spent)
            for write in (self._write_trace, self._write_metrics,
                          self._write_compile_log,
                          lambda d: self._write_env(d, reason, info)):
                try:
                    write(out_dir)
                except Exception:
                    pass
            if exc is not None:
                try:
                    self._write_error(out_dir, exc)
                except Exception:
                    pass
            return out_dir

    def _write_trace(self, out_dir):
        from . import compile_watch

        buf = self._trace_buffer if self._trace_buffer is not None \
            else otrace.default_buffer()
        events = buf.events()
        for ev in compile_watch.recent_compile_events():
            events.append({
                "name": f"xla_compile:{ev.get('name', '?')}",
                "cat": "xla_compile",
                "ph": "X",
                "ts": ev.get("ts", 0.0),
                "dur": ev.get("dur", 0.0),
                "pid": os.getpid(),
                "tid": 0,
                "args": {k: v for k, v in ev.items()
                         if k not in ("ts", "dur", "name")},
            })
        events.sort(key=lambda e: e.get("ts", 0.0))
        with open(os.path.join(out_dir, "trace.json"), "w") as f:
            json.dump(_json_safe({"traceEvents": events,
                                  "displayTimeUnit": "ms"}), f,
                      allow_nan=False)

    def _write_metrics(self, out_dir):
        reg = self._registry if self._registry is not None \
            else default_registry()
        with self._snap_lock:
            history = list(self._snapshots)
        doc = {"snapshot": json_snapshot(reg), "history": history}
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            # allow_nan=False proves the strict-JSON guarantee at write
            # time instead of at the consumer
            json.dump(doc, f, allow_nan=False)

    def _write_compile_log(self, out_dir):
        from . import compile_watch

        lines = []
        for ev in compile_watch.recent_compile_events():
            parts = [f"{ev.get('kind', 'compile')}",
                     f"name={ev.get('name', '?')}",
                     f"dur_ms={ev.get('dur', 0.0) / 1e3:.1f}"]
            for k in ("flops", "bytes_accessed", "peak_temp_bytes",
                      "signature"):
                if k in ev:
                    parts.append(f"{k}={ev[k]}")
            lines.append("  ".join(str(p) for p in parts))
        with open(os.path.join(out_dir, "compile_log.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))

    def _write_env(self, out_dir, reason, info):
        doc = {
            "reason": reason,
            "unix_time": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "python": sys.version.split()[0],
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(("PADDLE", "TORCH", "PYTORCH", "CUDA",
                                     "NCCL", "FLAGS_"))},
        }
        if info:
            doc["info"] = info
        doc.update(_device_doc())
        with open(os.path.join(out_dir, "env.json"), "w") as f:
            # _json_safe: on_fatal(**info) may carry the very NaN the
            # dump is about — a bare NaN token would break the strict-
            # JSON guarantee on exactly the bundle it matters for
            json.dump(_json_safe(doc), f, indent=2, sort_keys=True)

    @staticmethod
    def _write_error(out_dir, exc):
        if isinstance(exc, BaseException):
            exc = (type(exc), exc, exc.__traceback__)
        with open(os.path.join(out_dir, "error.txt"), "w") as f:
            f.write("".join(traceback.format_exception(*exc)))


def _device_doc():
    """The torch build and, where CUDA is initialised in this process,
    the cards and the caching allocator's state. Host-side reads only
    (``memory_stats`` and the byte counters are the allocator's own
    books; ``mem_get_info`` is one ``cudaMemGetInfo``, which does not
    synchronise), each guarded on its own: after a sticky CUDA error a
    failing query costs its key, not the bundle."""
    out = {"memory_stats": {}}
    try:
        import torch
    except Exception:
        return out
    out["torch_version"] = torch.__version__
    out["cuda_version"] = torch.version.cuda
    try:
        if not torch.cuda.is_initialized():
            out["backend"] = "cpu"
            return out
    except Exception:
        return out
    out["backend"] = "cuda"
    queries = {
        "devices": lambda: [torch.cuda.get_device_name(i)
                            for i in range(torch.cuda.device_count())],
        "memory_stats": lambda: dict(torch.cuda.memory_stats()),
        "memory_allocated": torch.cuda.memory_allocated,
        "memory_reserved": torch.cuda.memory_reserved,
        "max_memory_allocated": torch.cuda.max_memory_allocated,
        "mem_get_info": lambda: list(torch.cuda.mem_get_info()),
    }
    for key, query in queries.items():
        try:
            out[key] = query()
        except Exception as e:
            out[f"{key}_error"] = f"{type(e).__name__}: {e}"
    return out


# ---------------------------------------------------------------------------
# module-level lifecycle — what the serving engine, the watchdog and the
# perf sentinel call without holding a recorder reference
# ---------------------------------------------------------------------------
def install(log_dir="./paddle_tpu_log", **kwargs):
    """Create + install the process flight recorder. Returns it, or None
    under ``PADDLE_TPU_METRICS=0`` (nothing hooked, no files ever).
    Installing again re-points the existing recorder's ``log_dir`` (and
    any other passed settings) rather than silently keeping the old
    destination."""
    if not enabled():
        return None
    with _install_lock:
        rec = _installed
        if rec is not None:
            rec.log_dir = str(log_dir)
            for key, value in kwargs.items():
                if key == "snapshot_interval":
                    rec.snapshot_interval = float(value)
                elif key == "snapshot_capacity":
                    rec._snapshots = deque(rec._snapshots,
                                           maxlen=int(value))
                elif key == "registry":
                    rec._registry = value
                elif key == "trace_buffer":
                    rec._trace_buffer = value
                else:
                    raise TypeError(
                        f"install() got an unexpected keyword {key!r}")
            return rec
        return FlightRecorder(log_dir, **kwargs).install()


def uninstall():
    rec = _installed
    if rec is not None:
        rec.uninstall()
    _last_origin_dump.clear()


def installed():
    """The active recorder, or None."""
    return _installed


def dump(reason="manual", exc=None, info=None):
    """Dump a post-mortem bundle through the installed recorder (None
    when none is installed or metrics are disabled)."""
    rec = _installed
    if rec is None or not enabled():
        return None
    return rec.dump(reason=reason, exc=exc, info=info)


def on_fatal(origin, exc=None, **info):
    """Fatal-path hook for the serving engine, watchdog timeouts and the
    perf sentinel: dumps when a recorder is installed, never raises,
    never blocks the caller's own error. An exception is dumped once,
    however many nested fatal paths (and finally the excepthook) see it
    on the way out."""
    rec = _installed
    if rec is None or not enabled():
        return None
    if exc is not None and getattr(exc, "_paddle_tpu_fr_dumped", False):
        return None
    # rate-limit per origin — with or without an exception object: a
    # storm of same-origin hits (NaNs on every op of one bad step, a
    # too-large prompt rejected with a FRESH MemoryError per request)
    # must not exhaust the MAX_DUMPS budget before a genuinely distinct
    # fatal gets its bundle
    now = time.monotonic()
    if now - _last_origin_dump.get(origin, -ORIGIN_DUMP_INTERVAL) \
            < ORIGIN_DUMP_INTERVAL:
        # skipped, NOT marked dumped: if this exception still kills the
        # process, the excepthook bundle (a different origin) proceeds
        return None
    _last_origin_dump[origin] = now
    try:
        out = rec.dump(reason=origin, exc=exc, info=info or None)
    except Exception:
        return None
    if exc is not None:
        try:
            exc._paddle_tpu_fr_dumped = True
        except Exception:
            pass
    return out


def periodic_snapshot(force=False):
    """Rate-limited metric snapshot into the installed recorder's ring
    (call sites: hapi step, serving wave). No-op when uninstalled."""
    rec = _installed
    if rec is None:
        return False
    return rec.note_snapshot(force=force)
