"""Compile and device-memory observability (the port of
``paddle_tpu/observability/compile_watch.py``, rebuilt for the card).

The port compiles no XLA program. Its compile-like events are the two
things that make a first dispatch slow and a restarted replica pay under
traffic:

- a kernel library's build or load (:mod:`~paddle_tpu_torch.ops._build`):
  ``nvcc`` compiles each ``csrc/*.cu`` into a shared library under the
  build directory, keyed by the hash of its sources and flags. That
  directory plays the role of the reference's persistent compilation
  cache: a library found already built when this process first asks for
  it is a ``compile_cache_hit_total``, one that ``nvcc`` compiles is a
  ``compile_cache_miss_total``;
- a CUDA-graph capture (:meth:`~paddle_tpu_torch.ops._graphs.StepGraphs
  .capture`): the serving engine's decode ticks, ``generate``'s decode
  step.

:class:`CompileWatch` counts them per callable and per signature under
the reference's family names and labels, so one dashboard reads both
packages:

- ``paddle_tpu_xla_compile_total{callable}`` — libraries loaded (the
  callable ``kernel:<library>``, its build included) and graphs captured
  (the callable is the graph set's name, e.g. ``serving.decode_tick``);
- ``paddle_tpu_xla_compile_seconds{callable}`` — the wall time of each:
  build plus ``dlopen``, or the capture's warm-up run plus the capture;
- ``paddle_tpu_xla_distinct_signatures{callable}`` — distinct signatures
  (a library's source hash, a graph's key);
- ``paddle_tpu_xla_recompile_storm_total{callable}`` — new signatures
  past ``PADDLE_TPU_RECOMPILE_STORM_SIGS`` (default 8), with a one-line
  diagnosis naming what churns: a graph set that keeps capturing new
  keys (``generate`` called at ever new batch or length) fires it as a
  jit that keeps recompiling does in the reference;
- ``paddle_tpu_xla_backend_compile_total`` / ``_seconds`` — every
  ``nvcc`` run of the process, whoever asked for it.

:func:`sample_device_memory` publishes the reference's memory gauges from
the caching allocator (``torch.cuda.memory_allocated``,
``memory_reserved``, ``max_memory_allocated``) and ``mem_get_info``
(``cudaMemGetInfo``), throttled per registry. It never runs under a
capture: it skips while another thread holds
:data:`~paddle_tpu_torch.ops._graphs.CAPTURE_LOCK` or this thread's
stream is capturing.

The persistent shape registry (:class:`SignatureRegistry`,
:func:`shape_registry`, :func:`default_cache_dir`, ``PADDLE_TPU_COMPILE_
CACHE=0``) is plain host code, ported as it is: the serving engine
records the dispatch shapes it ran so that a restarted replica's
``prewarm()`` warms them before traffic.

``watched_jit`` wraps a per-shape callable as the reference wraps its
compiled functions, and ``watch`` returns a callable's
:class:`CompileWatch`. In the port a "compile" of such a callable is the
first call of each signature (the shapes and dtypes of its tensor
arguments, static arguments by value), timed on the host clock; later
calls of that signature go straight through. Its callers are the MoE
layers' per-token-count forwards (``moe_layer``, ``moe_mlp``); the
pipeline schedule's compiled steps come with ROADMAP item 13 (part 2). A call
while a CUDA graph is being captured or inside a compiled step is not
counted: the capture, the reference's outer program, is counted as
itself.

Everything honours the metrics kill switch: under
``PADDLE_TPU_METRICS=0`` nothing is counted or registered and no memory
is sampled; the shape registry and the cache tallies stay on, as in the
reference.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import weakref
from collections import deque

from . import metrics as om
from .metrics import enabled
from .trace import _EPOCH

__all__ = [
    "CompileWatch", "NULL_WATCH", "watch", "watched_jit",
    "sample_device_memory", "recent_compile_events", "reset",
    "COMPILE_BUCKETS", "DEFAULT_STORM_THRESHOLD",
    "enable_persistent_cache", "persistent_cache_stats",
    "SignatureRegistry", "shape_registry", "default_cache_dir",
    "note_library", "note_build", "note_capture", "describe_args",
]

#: compile-duration buckets: 10ms (a cached library's load) .. 300s (a
#: cold ``nvcc`` of a large kernel source)
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0,
                   60.0, 300.0)

DEFAULT_STORM_THRESHOLD = 8

_lock = threading.Lock()
_watches: dict[str, "CompileWatch"] = {}
#: bounded ring of recent compile events (dicts) for the flight recorder
_events: deque = deque(maxlen=512)


def storm_threshold():
    """Distinct-signature count past which a callable is a recompile
    storm (env ``PADDLE_TPU_RECOMPILE_STORM_SIGS``, checked per compile
    so tests can tune it)."""
    try:
        return int(os.environ.get("PADDLE_TPU_RECOMPILE_STORM_SIGS",
                                  DEFAULT_STORM_THRESHOLD))
    except ValueError:
        return DEFAULT_STORM_THRESHOLD


def _note_event(event):
    # locked: the flight recorder snapshots the ring with list() mid-crash
    with _lock:
        _events.append(event)


def recent_compile_events():
    """Recent compile events (newest last) — the flight recorder's
    compile log."""
    with _lock:
        return list(_events)


def reset():
    """Drop all per-callable signature state, the event ring, the cache
    tallies and the memory-sample throttle/high-water (test isolation;
    production code never needs this)."""
    global _mem_peak
    with _lock:
        _watches.clear()
        _events.clear()
        _seen_libraries.clear()
    _cache_counts.update(hits=0, misses=0)
    _mem_last.clear()
    _mem_peak = 0


# ---------------------------------------------------------------------------
# the persistent cache: the kernel build directory, the shape registry
# ---------------------------------------------------------------------------
#: raw cache tallies — plain ints beside the metric counters, so a
#: replica can report its warm-start hit rate even under
#: ``PADDLE_TPU_METRICS=0``
_cache_counts = {"hits": 0, "misses": 0}
#: libraries already tallied in this process (each counts once: a hit if
#: it was on disk when first asked for, a miss if nvcc built it)
_seen_libraries: set = set()


def _cache_counter(hit):
    if hit:
        return om.counter("compile_cache_hit_total",
                          "XLA programs served from the persistent "
                          "compilation cache")
    return om.counter("compile_cache_miss_total",
                      "XLA programs compiled from scratch (persistent "
                      "cache lookup missed)")


def note_library(name, built):
    """Tally one kernel library in the cache counters, once per process:
    ``built`` (``nvcc`` compiled it now) is a miss, else a hit."""
    with _lock:
        if name in _seen_libraries:
            return
        _seen_libraries.add(name)
    _cache_counts["misses" if built else "hits"] += 1
    if enabled():
        _cache_counter(not built).inc()


def note_build(name, duration):
    """One ``nvcc`` run (the backend compile): the process-wide totals and
    the flight recorder's ring."""
    if not enabled():
        return
    om.counter("paddle_tpu_xla_backend_compile_total",
               "XLA backend compiles in this process (all sources)").inc()
    om.histogram("paddle_tpu_xla_backend_compile_seconds",
                 "XLA backend compile duration (all sources)",
                 buckets=COMPILE_BUCKETS).observe(duration)
    _note_event({
        "kind": "backend_compile",
        "name": f"kernel:{name}",
        "ts": (time.perf_counter() - _EPOCH) * 1e6 - duration * 1e6,
        "dur": duration * 1e6,
    })


def note_capture(name, key, duration):
    """One CUDA-graph capture of graph ``key`` in the graph set ``name``
    (``duration``: its warm-up run plus the capture)."""
    desc = key if isinstance(key, str) else repr(key)
    _watch(name).record_compile(duration, desc=(("graph", desc),))


def persistent_cache_stats():
    """``{"hits", "misses", "dir"}`` for this process — independent of
    the metrics kill switch so workers can report warm-start health."""
    return {"hits": _cache_counts["hits"],
            "misses": _cache_counts["misses"],
            "dir": _cache_dir}


_cache_dir = None
_cache_lock = threading.Lock()


def default_cache_dir():
    """Default persistent-cache location: ``PADDLE_TPU_COMPILE_CACHE_DIR``
    or ``~/.cache/paddle_tpu/xla_cache``."""
    return os.environ.get("PADDLE_TPU_COMPILE_CACHE_DIR") \
        or os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu",
                        "xla_cache")


def enable_persistent_cache(path=None):
    """The process's cache directory (``path`` or :func:`default_cache_dir`,
    created), where the serving engine's shape registry lives beside the
    reference's, or None under ``PADDLE_TPU_COMPILE_CACHE=0`` (or when
    the directory cannot be made). The kernels' own build directory
    (``ops._build.BUILD``) is the port's compiled-program cache and is
    always on. Idempotent."""
    global _cache_dir
    if os.environ.get("PADDLE_TPU_COMPILE_CACHE", "1").lower() \
            in ("0", "off", "false"):
        return None
    with _cache_lock:
        if _cache_dir is not None:
            return _cache_dir
        cache = path or default_cache_dir()
        try:
            os.makedirs(cache, exist_ok=True)
        except OSError:
            return None
        _cache_dir = cache
    return _cache_dir


class SignatureRegistry:
    """Durable record of the shape signatures a named callable compiled
    — persisted so the NEXT process knows what to pre-warm before
    traffic arrives.

    The file is JSON ``{key: {kind: [values]}}`` where ``key`` names one
    compile surface (the serving engine hashes its model dims + batch
    geometry into it) and each ``kind`` collects the distinct values
    seen (mixed-dispatch token shapes, decode-scan tick counts, ...).
    Writes are read-merge-replace with a write-aside temp file, so
    concurrent replicas on one host can record without tearing the file
    (a lost race drops one record until its next dispatch re-records it
    — never corruption)."""

    def __init__(self, path):
        self.path = path
        self._lock = threading.Lock()

    def _load(self):
        try:
            with open(self.path) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else {}
        except (OSError, ValueError):
            return {}

    def record(self, key, kind, value):
        """Merge one (key, kind, value) into the registry. Returns True
        when the value was new for that key/kind."""
        with self._lock:
            doc = self._load()
            kinds = doc.setdefault(str(key), {})
            vals = kinds.setdefault(str(kind), [])
            if value in vals:
                return False
            vals.append(value)
            vals.sort()
            tmp = f"{self.path}.{os.getpid()}.tmp"
            try:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=0, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return False
            return True

    def lookup(self, key):
        """``{kind: [values]}`` recorded for ``key`` (empty when none)."""
        with self._lock:
            return self._load().get(str(key), {})


_shape_registry = None


def shape_registry():
    """The process-default :class:`SignatureRegistry`
    (``PADDLE_TPU_SHAPE_REGISTRY`` or ``<cache_dir>/serving_shapes.json``,
    so replicas sharing the cache directory share the warm-up recipe)."""
    global _shape_registry
    with _cache_lock:
        if _shape_registry is None:
            path = os.environ.get("PADDLE_TPU_SHAPE_REGISTRY") \
                or os.path.join(default_cache_dir(), "serving_shapes.json")
            _shape_registry = SignatureRegistry(path)
        return _shape_registry


# ---------------------------------------------------------------------------
# per-callable accounting
# ---------------------------------------------------------------------------
class _NullWatch:
    """Shared no-op watch returned when metrics are disabled."""

    __slots__ = ()

    def observe_signature(self, desc):
        pass

    def record_compile(self, duration, desc=None):
        pass

    @property
    def last_diagnosis(self):
        return None


NULL_WATCH = _NullWatch()


class CompileWatch:
    """Compile accounting for ONE named callable (a kernel library, a
    graph set). Its metric families (all labeled ``callable``) are
    created on the default registry at record time, so registry clears
    between tests cannot orphan children: ``paddle_tpu_xla_compile_total``,
    ``paddle_tpu_xla_compile_seconds``, ``paddle_tpu_xla_distinct_
    signatures`` and ``paddle_tpu_xla_recompile_storm_total``."""

    def __init__(self, name):
        self.name = name
        self._sigs: dict[tuple, int] = {}
        self._storm_announced = False
        self.last_diagnosis = None
        self._lock = threading.Lock()

    def _m(self, kind):
        if kind == "compiles":
            fam = om.counter("paddle_tpu_xla_compile_total",
                             "XLA programs compiled per callable",
                             labelnames=("callable",))
        elif kind == "seconds":
            fam = om.histogram("paddle_tpu_xla_compile_seconds",
                               "XLA compile duration per callable",
                               labelnames=("callable",),
                               buckets=COMPILE_BUCKETS)
        elif kind == "sigs":
            fam = om.gauge("paddle_tpu_xla_distinct_signatures",
                           "distinct compile signatures per callable",
                           labelnames=("callable",))
        else:
            fam = om.counter(
                "paddle_tpu_xla_recompile_storm_total",
                "new signatures past the recompile-storm threshold",
                labelnames=("callable",))
        return fam.labels(self.name)

    def observe_signature(self, desc):
        """Track one (possibly new) signature; fires the storm counter +
        one-line diagnosis when the callable exceeds the threshold."""
        if desc is None:
            return
        announce = None
        with self._lock:
            if desc in self._sigs:
                self._sigs[desc] += 1
                return
            self._sigs[desc] = 1
            n = len(self._sigs)
            self._m("sigs").set(n)
            if n > storm_threshold():
                self._m("storms").inc()
                self.last_diagnosis = self._diagnose(n)
                if not self._storm_announced:
                    self._storm_announced = True
                    announce = self.last_diagnosis
        if announce:
            print(announce, file=sys.stderr)

    def _diagnose(self, n):
        """One line naming the churning parts of the signature."""
        by_label: dict[str, set] = {}
        order: list[str] = []
        for desc in self._sigs:
            for label, value in desc:
                if label not in by_label:
                    by_label[label] = set()
                    order.append(label)
                by_label[label].add(value)
        churn = ", ".join(
            f"{label} churns {len(by_label[label])} variants "
            f"({' | '.join(sorted(by_label[label])[:4])}"
            f"{', ...' if len(by_label[label]) > 4 else ''})"
            for label in order if len(by_label[label]) > 1)
        return (f"[compile_watch] recompile storm: {self.name!r} has "
                f"{n} distinct signatures "
                f"(threshold {storm_threshold()}); "
                f"{churn or 'churn outside tracked args'}")

    def record_compile(self, duration, desc=None):
        """Record one compile-like event of this callable: its signature,
        the counter, the duration histogram and the flight recorder's
        ring."""
        self.observe_signature(desc)
        self._m("compiles").inc()
        self._m("seconds").observe(duration)
        event = {
            "kind": "compile",
            "name": self.name,
            "ts": (time.perf_counter() - _EPOCH) * 1e6 - duration * 1e6,
            "dur": duration * 1e6,
        }
        if desc:
            event["signature"] = "; ".join(f"{k}={v}" for k, v in desc)
        _note_event(event)


def _watch(name):
    """The process-wide :class:`CompileWatch` for ``name`` (the shared
    no-op under ``PADDLE_TPU_METRICS=0``, checked per call)."""
    if not enabled():
        return NULL_WATCH
    with _lock:
        w = _watches.get(name)
        if w is None:
            w = _watches[name] = CompileWatch(name)
        return w


def watch(name):
    """The process-wide :class:`CompileWatch` for ``name`` (a no-op watch
    under ``PADDLE_TPU_METRICS=0``, checked per call)."""
    return _watch(name)


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _arg_key(args, kwargs=None):
    """Hashable key of a call: the pytree structure plus ``(shape,
    dtype)`` per tensor leaf, the type of a Python scalar (one compile a
    type, as a traced scalar), a hashable static leaf by value. None
    when a leaf is unhashable (the call is not watched). Tensors alone,
    by position, take a short path: the key runs on every call."""
    import torch

    if not kwargs and all(isinstance(a, torch.Tensor) for a in args):
        return (("~tree", f"{len(args)} tensors"),) + tuple(
            (tuple(a.shape), a.dtype) for a in args)
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten((args, kwargs or {}))
    out = [("~tree", spec)]
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            out.append((tuple(shape), dtype))
        elif isinstance(leaf, (bool, int, float, complex)):
            out.append(("~weak", type(leaf).__name__))
        else:
            try:
                hash(leaf)
            except TypeError:
                return None
            out.append(("~static", leaf))
    return tuple(out)


def _key_desc(key):
    """Render an :func:`_arg_key` into the labeled descriptor the storm
    diagnosis names arguments by (built only on a compile)."""
    out = []
    for i, (tag, val) in enumerate(key):
        if tag == "~tree":
            out.append(("tree", str(val)))
        elif tag == "~weak":
            out.append((f"arg{i - 1}", f"weak_{val}"))
        elif tag == "~static":
            out.append((f"arg{i - 1}", f"{type(val).__name__}={val!r}"))
        else:
            out.append((f"arg{i - 1}", f"{_dtype_name(val)}"
                        f"[{','.join(str(int(s)) for s in tag)}]"))
    return tuple(out)


def describe_args(args, kwargs=None):
    """Labeled signature descriptor for the storm diagnosis: ``("arg0",
    "float32[4,8]")`` for tensors, ``("arg1", "weak_float")`` for Python
    scalars. None when a leaf is unhashable."""
    key = _arg_key(args, kwargs)
    return None if key is None else _key_desc(key)


def _static_arg_key(args, kwargs, static_nums, static_names):
    """The key of a call with static arguments: those by value, the
    others as :func:`_arg_key`. None when a static value is
    unhashable."""
    key = []
    for i, a in enumerate(args):
        if i in static_nums:
            try:
                hash(a)
            except TypeError:
                return None
            key.append(("~staticval", a))
        else:
            sub = _arg_key((a,))
            if sub is None:
                return None
            key.append(sub)
    for k in sorted(kwargs):
        v = kwargs[k]
        if k in static_names:
            try:
                hash(v)
            except TypeError:
                return None
            key.append((k, "~staticval", v))
        else:
            sub = _arg_key((v,))
            if sub is None:
                return None
            key.append((k, sub))
    return tuple(key)


def _in_outer_step():
    """A call inside a CUDA-graph capture or a compiled step: the outer
    program is counted as itself (the reference's outer trace)."""
    from ..jit import in_compiled_step
    return in_compiled_step() or _capturing()


def watched_jit(fun, name=None, **jit_kwargs):
    """``fun`` with compile observability (the module docstring): the
    first call of each signature is a compile of ``name`` (default: the
    function's qualified name), counted and timed; with
    ``static_argnums`` / ``static_argnames`` those arguments key by value.
    Under ``PADDLE_TPU_METRICS=0``, under a capture and inside a
    compiled step every call goes straight to ``fun``."""
    import functools

    watch_name = name or getattr(fun, "__qualname__", None) or repr(fun)
    seen: set = set()
    nums = jit_kwargs.get("static_argnums")
    names = jit_kwargs.get("static_argnames")
    static_nums = frozenset((nums,) if isinstance(nums, int)
                            else nums or ())
    static_names = frozenset((names,) if isinstance(names, str)
                             else names or ())
    has_statics = bool(static_nums or static_names)

    @functools.wraps(fun)
    def wrapper(*args, **kwargs):
        if not enabled() or _in_outer_step():
            return fun(*args, **kwargs)
        if has_statics:
            key = _static_arg_key(args, kwargs, static_nums, static_names)
            desc = None if key is None else tuple(
                (f"arg{i}", repr(k)) for i, k in enumerate(key))
        else:
            key = _arg_key(args, kwargs)
            desc = None if key is None else _key_desc(key)
        if key is None or key in seen:
            return fun(*args, **kwargs)
        seen.add(key)
        t0 = time.perf_counter()
        out = fun(*args, **kwargs)
        _watch(watch_name).record_compile(time.perf_counter() - t0,
                                          desc=desc)
        return out

    wrapper._watch_name = watch_name
    return wrapper


# ---------------------------------------------------------------------------
# device-memory accounting
# ---------------------------------------------------------------------------
_mem_seq = itertools.count()
#: per-registry throttle clocks (weak keys: a GC'd registry neither leaks
#: its entry nor bequeaths its clock to a new one at the same address)
_mem_last: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#: sampler high-water of the host's resident bytes (the CPU's peak)
_mem_peak = 0


def _capturing():
    """True when a CUDA-graph capture is running: on this thread's
    stream, or on another thread (which holds CAPTURE_LOCK)."""
    import torch

    from ..ops._graphs import CAPTURE_LOCK
    if torch.cuda.is_available() and torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        return True
    if not CAPTURE_LOCK.acquire(blocking=False):
        return True
    CAPTURE_LOCK.release()
    return False


def _host_stats():
    """The CPU's stand-in for an allocator: this process's resident
    bytes (``/proc/self/statm``), or None where that is not readable."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def sample_device_memory(registry=None, device=None, min_interval=0.0):
    """Publish the reference's memory gauges for the card: bytes in use
    (``torch.cuda.memory_allocated``, what live tensors hold; also the
    live-tensor bytes), the peak (``max_memory_allocated``), the live
    allocations (``memory_stats()["allocation.all.current"]``) and the
    card's total (``mem_get_info``), with the allocator's reserved bytes
    and the card's free bytes in the returned sample. The allocator's
    numbers are host-side books and ``mem_get_info`` is one
    ``cudaMemGetInfo``: nothing synchronises the device. On a process
    with no CUDA context the CPU stands in: its resident bytes and their
    high-water. Returns
    the sampled dict, or None under ``PADDLE_TPU_METRICS=0``, when
    throttled (``min_interval`` seconds per registry; the first call per
    registry always samples) or while a CUDA-graph capture runs."""
    if not enabled():
        return None
    global _mem_peak
    reg = registry if registry is not None else om.default_registry()
    if min_interval:
        now = time.monotonic()
        if now - _mem_last.get(reg, -float(min_interval)) \
                < min_interval:
            return None
        _mem_last[reg] = now
    import torch
    on_card = torch.cuda.is_available() and torch.cuda.is_initialized() \
        and (device is None or torch.device(device).type == "cuda")
    if _capturing():
        return None
    sample = {"sample_seq": next(_mem_seq)}
    if on_card:
        dev = device if device is not None else torch.cuda.current_device()
        in_use = int(torch.cuda.memory_allocated(dev))
        peak = int(torch.cuda.max_memory_allocated(dev))
        count = int(torch.cuda.memory_stats(dev).get(
            "allocation.all.current", 0))
        sample.update(source="cuda_caching_allocator",
                      bytes_reserved=int(torch.cuda.memory_reserved(dev)))
        try:
            free, total = torch.cuda.mem_get_info(dev)
            sample.update(bytes_free=int(free), bytes_limit=int(total))
        except RuntimeError:
            pass
    else:
        rss = _host_stats()
        if rss is None:
            return None
        in_use, count = rss, 0
        _mem_peak = max(_mem_peak, rss)
        peak = _mem_peak
        sample["source"] = "host_rss"
    sample.update(bytes_in_use=in_use, live_array_bytes=in_use,
                  live_array_count=count, peak_bytes_in_use=peak)
    reg.gauge("paddle_tpu_device_bytes_in_use",
              "allocator bytes in use on the default device").set(in_use)
    reg.gauge("paddle_tpu_live_array_bytes",
              "total bytes of live tensors on the default device") \
        .set(in_use)
    reg.gauge("paddle_tpu_live_array_count",
              "live allocations on the default device").set(count)
    reg.gauge("paddle_tpu_device_peak_bytes_in_use",
              "allocator peak bytes in use (sampler high-water when the "
              "backend does not report a peak)").set(peak)
    if "bytes_limit" in sample:
        reg.gauge("paddle_tpu_device_bytes_limit",
                  "allocator byte limit reported by the backend") \
            .set(sample["bytes_limit"])
    return sample
