"""Cross-process trace-context propagation + multi-process trace merge
(a copy of ``paddle_tpu/observability/tracing.py``: it needs no device).

The span tracer (`trace.py`) is strictly per-process: every event
lands in this process's ring with this process's monotonic clock. Since
the serving stack became a multi-process cluster (HTTP front door ->
router -> rpc -> subprocess replica workers), one slow request's time is
smeared invisibly across three processes. This module is the glue that
makes it ONE timeline:

- :class:`TraceContext` — W3C-trace-context-shaped identity
  (``trace_id`` / ``span_id`` / ``parent_id``), carried in a
  ``contextvars.ContextVar`` so nested :class:`~.trace.span`\\ s link
  into a parent-chained tree automatically. Minted at the HTTP front
  door (or adopted from an incoming ``traceparent`` header), injected
  into rpc envelopes by ``distributed.rpc``, restored in dispatcher
  handlers.
- Span shards — each worker periodically flushes its span ring to one
  bounded, atomically-replaced JSON file under the shared log dir
  (``trace_shards/<worker>.trace.json``), stamped with the worker's
  monotonic<->epoch clock offset.
- :func:`merge_shards` — the collector's alignment step: shifts every
  shard's monotonic timestamps onto one common base using the recorded
  offsets and emits a single Perfetto/chrome-trace-loadable document.
- :func:`span_tree` — one request's spans (by ``trace_id``) as a
  parent-nested JSON tree, what ``GET /v1/requests/<id>/trace`` serves.

Everything obeys the metrics kill switch: under ``PADDLE_TPU_METRICS=0``
:func:`mint` / :func:`adopt` / :func:`inject` return ``None``, no shard
file is ever written, and rpc envelopes stay byte-for-byte on the
pre-trace path.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading

from .metrics import enabled

__all__ = ["TraceContext", "current", "mint", "adopt", "activate",
           "inject", "extract", "parse_traceparent", "format_traceparent",
           "write_span_shard", "harvest_shards", "local_shard",
           "merge_shards", "span_tree", "record_clock_handshake",
           "read_clock_handshakes", "SHARD_DIR"]

#: subdirectory of a cluster log dir where workers flush span shards
SHARD_DIR = "trace_shards"

_HEX = set("0123456789abcdef")

_current: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_trace_context", default=None)


def _new_trace_id():
    return os.urandom(16).hex()


def _new_span_id():
    return os.urandom(8).hex()


class TraceContext:
    """One node of a distributed trace: which trace this work belongs
    to (``trace_id``), which span it is (``span_id``) and which span
    caused it (``parent_id``, ``None`` at the root)."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id, span_id=None, parent_id=None):
        self.trace_id = trace_id
        self.span_id = span_id or _new_span_id()
        self.parent_id = parent_id

    def child(self):
        """A fresh span under this one (same trace, new span id)."""
        return TraceContext(self.trace_id, _new_span_id(), self.span_id)

    def to_wire(self):
        """Compact dict for rpc envelopes (consumed by :func:`extract`)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id}

    def __repr__(self):
        return (f"TraceContext(trace={self.trace_id}, "
                f"span={self.span_id}, parent={self.parent_id})")


# ---------------------------------------------------------------------------
# contextvar plumbing
# ---------------------------------------------------------------------------
def current():
    """The active :class:`TraceContext`, or ``None`` (also ``None``
    whenever metrics are disabled — the kill switch wins even over an
    explicitly activated context)."""
    if not enabled():
        return None
    return _current.get()


def mint():
    """A brand-new root context (``None`` under the kill switch)."""
    if not enabled():
        return None
    return TraceContext(_new_trace_id())


def parse_traceparent(header):
    """Parse a W3C ``traceparent`` header
    (``version-traceid-spanid-flags``). Returns a :class:`TraceContext`
    whose ``span_id`` is the CALLER's span (i.e. our parent), or
    ``None`` on anything malformed — an invalid header must start a
    fresh trace, never crash a request."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or not set(version) <= _HEX or version == "ff":
        return None
    if len(trace_id) != 32 or not set(trace_id) <= _HEX \
            or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not set(span_id) <= _HEX \
            or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id)


def format_traceparent(ctx):
    """Render a context as an outgoing ``traceparent`` header."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def adopt(traceparent=None):
    """The front-door entry point: continue the caller's trace when a
    valid ``traceparent`` header arrives (our root span becomes a child
    of the remote span), else mint a fresh root. ``None`` under the
    kill switch."""
    if not enabled():
        return None
    remote = parse_traceparent(traceparent)
    if remote is not None:
        return remote.child()
    return TraceContext(_new_trace_id())


@contextlib.contextmanager
def activate(ctx):
    """Make ``ctx`` the current context for the ``with`` body (no-op
    for ``ctx=None``, so call sites don't need their own branching)."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def inject():
    """Wire fields for an rpc envelope: the current context's
    :meth:`~TraceContext.to_wire` dict, or ``None`` when there is
    nothing to propagate (no active trace, or kill switch) — ``None``
    means the envelope must stay on the pre-trace byte layout."""
    ctx = current()
    return None if ctx is None else ctx.to_wire()


def extract(wire):
    """Rebuild a context from envelope wire fields; tolerant of
    ``None``, foreign, or partial dicts (missing keys degrade to a
    fresh id rather than KeyError-ing the dispatcher)."""
    if not wire or not isinstance(wire, dict) or not enabled():
        return None
    trace_id = wire.get("trace_id")
    if not trace_id:
        return None
    return TraceContext(trace_id, wire.get("span_id"),
                        wire.get("parent_id"))


# used by trace.span: mint a child of the ambient context (if any) for
# the span being opened, or install a caller-provided context verbatim
def _enter_span(explicit=None):
    if explicit is not None:
        return explicit, _current.set(explicit)
    ctx = _current.get()
    if ctx is None:
        return None, None
    child = ctx.child()
    return child, _current.set(child)


def _exit_span(token):
    if token is not None:
        _current.reset(token)


# ---------------------------------------------------------------------------
# span shards: per-worker bounded files the cluster collector harvests
# ---------------------------------------------------------------------------
_shard_lock = threading.Lock()


def local_shard(worker_name):
    """This process's span ring as a shard document (what a worker
    writes to disk, and what the collector uses for its OWN process
    without a file round-trip)."""
    from . import trace as _trace

    return {"worker": str(worker_name), "pid": os.getpid(),
            "epoch_unix": _trace.epoch_unix(),
            "events": _trace.get_events()}


def write_span_shard(dir_name, worker_name, buffer=None):
    """Flush this process's spans to
    ``<dir_name>/trace_shards/<worker>.trace.json`` (atomic replace —
    a collector never reads a torn file; repeated flushes overwrite, so
    disk usage stays bounded by the ring capacity). Returns the path,
    or ``None`` under ``PADDLE_TPU_METRICS=0`` (no file is created)."""
    if not enabled():
        return None
    from . import trace as _trace

    doc = local_shard(worker_name)
    if buffer is not None:
        doc["events"] = buffer.events()
    del _trace  # only needed transitively via local_shard
    out_dir = os.path.join(str(dir_name), SHARD_DIR)
    path = os.path.join(out_dir, f"{worker_name}.trace.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with _shard_lock:
        os.makedirs(out_dir, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    return path


def harvest_shards(dir_name):
    """All readable shard documents under ``dir_name`` (a torn or
    half-dead worker's unreadable shard is skipped, not fatal)."""
    out = []
    shard_dir = os.path.join(str(dir_name), SHARD_DIR)
    try:
        names = sorted(os.listdir(shard_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".trace.json"):
            continue
        try:
            with open(os.path.join(shard_dir, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("events"), list):
            out.append(doc)
    return out


def merge_shards(shards):
    """One Perfetto-loadable chrome-trace document from many per-process
    shards, timestamp-aligned onto a common base.

    Every process stamps spans in microseconds since ITS OWN monotonic
    epoch; each shard records where that epoch sits on the (shared)
    unix clock (``epoch_unix``, the clock-offset handshake). The
    merge shifts each shard by ``(its epoch - earliest epoch)`` so a
    child span can never appear to start before its cross-process
    parent from clock-base mismatch alone."""
    shards = [s for s in shards if s.get("events")]
    if not shards:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(float(s.get("epoch_unix") or 0.0) for s in shards)
    events = []
    seen_pids = set()
    for shard in shards:
        shift_us = (float(shard.get("epoch_unix") or 0.0) - base) * 1e6
        pid = shard.get("pid", 0)
        worker = shard.get("worker", f"pid{pid}")
        if pid not in seen_pids:
            seen_pids.add(pid)
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": str(worker)}})
        for ev in shard["events"]:
            ev = dict(ev)
            ev["ts"] = float(ev.get("ts", 0.0)) + shift_us
            ev.setdefault("pid", pid)
            events.append(ev)
    events.sort(key=lambda e: (e.get("ph") != "M",
                               float(e.get("ts", 0.0))))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def span_tree(events, trace_id):
    """The spans of ONE trace as a parent-nested tree (list of roots,
    each ``{"name", "ts", "dur", "pid", "tid", "span_id", "parent_id",
    "args", "children"}``). Input is merged (aligned) chrome-trace
    events; spans carry their identity in ``args``."""
    nodes = {}
    order = []
    for ev in events:
        args = ev.get("args") or {}
        if args.get("trace_id") != trace_id:
            continue
        sid = args.get("span_id")
        if not sid:
            continue
        extra = {k: v for k, v in args.items()
                 if k not in ("trace_id", "span_id", "parent_id")}
        nodes[sid] = {"name": ev.get("name"),
                      "ts": ev.get("ts"), "dur": ev.get("dur"),
                      "pid": ev.get("pid"), "tid": ev.get("tid"),
                      "span_id": sid,
                      "parent_id": args.get("parent_id"),
                      "args": extra, "children": []}
        order.append(sid)
    roots = []
    for sid in order:
        node = nodes[sid]
        parent = nodes.get(node["parent_id"])
        if parent is not None:
            parent["children"].append(node)
        else:
            # the parent span may live in a shard that wasn't flushed
            # yet (or was trimmed off the ring) — surface as a root
            # rather than dropping the subtree
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda n: (n["ts"] is None, n["ts"]))
    roots.sort(key=lambda n: (n["ts"] is None, n["ts"]))
    return roots


# ---------------------------------------------------------------------------
# clock-offset handshake: recorded at replica registration so the
# collector can align a worker's monotonic span clock even before (or
# without) its first shard flush
# ---------------------------------------------------------------------------
def record_clock_handshake(dir_name, worker_name):
    """Write ``<dir_name>/.traceclock.<worker>`` with this process's
    monotonic<->epoch offset (dot-prefixed: FileStore membership scans
    ignore it). Returns the path, or ``None`` under the kill switch."""
    if not enabled():
        return None
    from . import trace as _trace

    path = os.path.join(str(dir_name), f".traceclock.{worker_name}")
    doc = {"worker": str(worker_name), "pid": os.getpid(),
           "epoch_unix": _trace.epoch_unix()}
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError:
        return None
    return path


def read_clock_handshakes(dir_name):
    """``{worker: handshake doc}`` for every readable handshake file."""
    out = {}
    try:
        names = os.listdir(str(dir_name))
    except OSError:
        return out
    for name in names:
        if not name.startswith(".traceclock.") or ".tmp." in name:
            continue
        try:
            with open(os.path.join(str(dir_name), name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and doc.get("worker"):
            out[str(doc["worker"])] = doc
    return out
