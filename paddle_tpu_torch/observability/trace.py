"""Structured host-span tracing: a ring buffer + chrome-trace export
(a copy of ``paddle_tpu/observability/trace.py``: it needs no device).

``span(name)`` is a context manager AND a decorator that records a
wall-time host span (complete event) into a bounded ring buffer — cheap
enough for scheduler/launcher hot paths where the device profiler
(``torch.profiler``) is too heavy. Export writes chrome-trace JSON
under the same ``<log_dir>/plugins/profile/<run>/`` layout the profiler
uses, so TensorBoard's profile plugin and Perfetto load host spans next
to device traces.

Tracing obeys the same kill switch as metrics: ``PADDLE_TPU_METRICS=0``
makes ``span`` a no-op and records nothing.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
from collections import deque

from . import tracing as _tracing
from .metrics import enabled

__all__ = ["span", "TraceBuffer", "default_buffer", "get_events", "clear",
           "export_chrome_trace", "unique_run_name", "epoch_unix"]

#: process epoch — span timestamps are microseconds since this point.
#: Spans are stamped off the MONOTONIC clock (an NTP step mid-run must
#: not make a trace jump backwards); ``_EPOCH_UNIX`` records where that
#: monotonic epoch sits on the shared unix clock — the offset the
#: cross-process merge (`tracing.merge_shards`) aligns shards on.
_EPOCH = time.perf_counter()
_EPOCH_UNIX = time.time() - (time.perf_counter() - _EPOCH)


def epoch_unix():
    """Unix time (seconds) at which this process's span clock reads 0 —
    the recorded monotonic<->epoch clock offset."""
    return _EPOCH_UNIX


class TraceBuffer:
    """Bounded, thread-safe ring of chrome-trace events (oldest spans
    fall off the back once ``capacity`` is reached)."""

    def __init__(self, capacity=4096):
        self._events = deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def add(self, event):
        with self._lock:
            self._events.append(event)

    def events(self):
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()

    def __len__(self):
        with self._lock:
            return len(self._events)


_default_buffer = TraceBuffer()


def default_buffer():
    return _default_buffer


def get_events():
    return _default_buffer.events()


def clear():
    _default_buffer.clear()


class span:
    """Record a named host span.

    Context manager::

        with span("serving.prefill", batch=4):
            ...

    Decorator (a fresh span per call)::

        @span("engine.step")
        def step(...): ...

    When a distributed :class:`~.tracing.TraceContext` is active (see
    ``tracing.activate``), the span becomes a node of that trace: it
    mints a child context for its own duration (so nested spans chain
    to it) and records ``trace_id`` / ``span_id`` / ``parent_id`` in
    its args. ``trace_ctx=`` installs a pre-allocated context verbatim
    instead — how rpc records its call span under the exact identity
    the envelope carried across the process boundary.
    """

    __slots__ = ("name", "args", "buffer", "_t0", "_trace_ctx_in",
                 "_trace_ctx", "_trace_token")

    def __init__(self, name, buffer=None, trace_ctx=None, **args):
        self.name = name
        self.args = args or None
        self.buffer = buffer
        self._t0 = None
        self._trace_ctx_in = trace_ctx
        self._trace_ctx = None
        self._trace_token = None

    def __enter__(self):
        if enabled():
            self._trace_ctx, self._trace_token = \
                _tracing._enter_span(self._trace_ctx_in)
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        if t0 is None:
            return False
        now = time.perf_counter()
        event = {
            "name": self.name,
            "ph": "X",
            "ts": (t0 - _EPOCH) * 1e6,
            "dur": (now - t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        ctx = self._trace_ctx
        if ctx is not None:
            event["args"] = dict(self.args or ())
            event["args"].update(ctx.to_wire())
            _tracing._exit_span(self._trace_token)
            self._trace_ctx = None
            self._trace_token = None
        elif self.args:
            event["args"] = dict(self.args)
        # explicit None-check: an empty TraceBuffer is falsy (__len__)
        buf = self.buffer if self.buffer is not None else _default_buffer
        buf.add(event)
        self._t0 = None
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(self.name, buffer=self.buffer, **(self.args or {})):
                return fn(*a, **kw)

        return wrapper


#: per-process run sequence: two runs within one strftime second must
#: not collide on the run dir and silently overwrite each other
_RUN_SEQ = itertools.count()


def unique_run_name():
    """Collision-proof run-directory name: wall-clock timestamp plus a
    pid + per-process monotonic suffix (shared by chrome-trace exports
    and flight-recorder bundles)."""
    return (f"{time.strftime('%Y_%m_%d_%H_%M_%S')}"
            f"_pid{os.getpid()}_{next(_RUN_SEQ)}")


def export_chrome_trace(dir_name, worker_name=None, buffer=None):
    """Write buffered spans as chrome-trace JSON into the profiler's
    output layout: ``<dir_name>/plugins/profile/<run>/<worker>.
    host_spans.trace.json``. Returns the written path."""
    # explicit None-check: an empty TraceBuffer is falsy (__len__)
    buf = buffer if buffer is not None else _default_buffer
    run = unique_run_name()
    out_dir = os.path.join(dir_name, "plugins", "profile", run)
    os.makedirs(out_dir, exist_ok=True)
    worker = worker_name or f"host_{os.getpid()}"
    path = os.path.join(out_dir, f"{worker}.host_spans.trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": buf.events(),
                   "displayTimeUnit": "ms",
                   # where this process's span clock (ts=0) sits on the
                   # unix clock — lets offline tooling align single-
                   # process exports the same way the cluster collector
                   # aligns shards
                   "metadata": {"epoch_unix": _EPOCH_UNIX,
                                "pid": os.getpid()}}, f)
    return path
