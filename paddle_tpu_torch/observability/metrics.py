"""Thread-safe runtime metrics: Counter / Gauge / Histogram + registry
(a copy of ``paddle_tpu/observability/metrics.py``: it needs no device).

Reference capability: the serving/trainer metric surfaces of production
TPU stacks (TTFT/TPOT histograms, KV-page utilization gauges, per-step
MFU — see PAPERS.md: "Ragged Paged Attention", arXiv:2604.15464).
The reference framework itself exposes no runtime counters; this module
is the measurement substrate every perf PR reports against.

Design:

- :class:`Counter` (monotonic), :class:`Gauge` (set/inc/dec or callback
  via ``set_function``), :class:`Histogram` (fixed upper-bound buckets,
  mergeable across processes/registries) — all guarded by a per-metric
  lock, all supporting labeled children (``m.labels("GET")``).
- :class:`MetricsRegistry` — name -> metric map with idempotent
  get-or-create factories; a process-global default registry behind
  :func:`default_registry` plus module-level :func:`counter` /
  :func:`gauge` / :func:`histogram` helpers.
- Zero-cost no-op mode: with ``PADDLE_TPU_METRICS=0`` in the environment
  every factory returns the shared :data:`NULL` metric whose methods do
  nothing, and the registry records nothing — instrumented hot paths pay
  one no-op method call and produce byte-identical outputs.
"""

from __future__ import annotations

import bisect
import math
import os
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL",
    "DEFAULT_BUCKETS", "default_registry", "counter", "gauge", "histogram",
    "enabled",
]


def enabled():
    """Metrics are on unless ``PADDLE_TPU_METRICS=0`` (checked per
    factory call so tests can toggle the environment)."""
    return os.environ.get("PADDLE_TPU_METRICS", "1") != "0"


class _NullMetric:
    """Shared do-nothing metric returned by every factory in no-op mode;
    also its own ``labels`` child so call chains stay valid."""

    __slots__ = ()

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, value):
        pass

    def set_function(self, fn):
        pass

    def observe(self, value):
        pass

    def merge(self, other):
        pass

    def snapshot(self):
        return [], 0.0

    def labels(self, *values, **labelkw):
        return self

    def remove(self, *values):
        pass

    @property
    def value(self):
        return 0.0

    @property
    def count(self):
        return 0

    @property
    def sum(self):
        return 0.0


NULL = _NullMetric()


class _Metric:
    """Base: name/help/labels plumbing. A labelless metric carries its
    own value; a labeled one only owns children keyed by label values."""

    kind = "untyped"

    def __init__(self, name, help="", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, _Metric] = {}
        self._lock = threading.Lock()

    def _new_child(self):
        return type(self)(self.name, self.help)

    def labels(self, *values, **labelkw):
        """Child metric for one label-value combination (created on
        first use). Accepts positional values or keyword form."""
        if labelkw:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                values = tuple(labelkw[k] for k in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e.args[0]!r} for "
                                 f"{self.name}") from None
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{len(values)} value(s)")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._new_child()
                self._children[values] = child
            return child

    def peek(self, *values):
        """Child metric for one label-value combination, or None when it
        was never created — a read that, unlike :meth:`labels`, never
        mints an empty child into the export."""
        values = tuple(str(v) for v in values)
        with self._lock:
            return self._children.get(values)

    def remove(self, *values):
        """Drop the child for one label-value combination (no-op when
        absent) — lets short-lived instruments bound label cardinality
        and stop exporting stale samples."""
        values = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(values, None)

    def _check_unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call "
                f".labels(...) first")

    def samples(self):
        """[(label_values, leaf_metric)] — () -> self when unlabeled."""
        if self.labelnames:
            with self._lock:
                return sorted(self._children.items())
        return [((), self)]


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def inc(self, n=1):
        self._check_unlabeled()
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge(_Metric):
    """Instantaneous value; settable or backed by a callback."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0
        self._fn = None

    def set(self, value):
        self._check_unlabeled()
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, n=1):
        self._check_unlabeled()
        with self._lock:
            self._value += n

    def dec(self, n=1):
        self._check_unlabeled()
        with self._lock:
            self._value -= n

    def set_function(self, fn):
        """Read the gauge from ``fn()`` at collection time (e.g. pool
        utilization derived from an allocator)."""
        self._check_unlabeled()
        with self._lock:
            self._fn = fn

    @property
    def value(self):
        fn = self._fn
        return float(fn()) if fn is not None else self._value


#: Prometheus' classic latency buckets (seconds).
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


def _normalize_buckets(buckets):
    """Sorted finite upper bounds. Explicit +/-Inf bounds are dropped:
    the +Inf bucket is implicit, and non-finite bounds would break the
    JSON snapshot (json.dumps emits non-standard Infinity) and the text
    exporter."""
    return tuple(sorted(float(b) for b in buckets if math.isfinite(b)))


class Histogram(_Metric):
    """Fixed-bucket histogram: ``buckets`` are inclusive upper bounds;
    an implicit +Inf bucket catches the tail. Mergeable: two histograms
    with identical buckets add elementwise (cross-process aggregation)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = _normalize_buckets(buckets)
        if not self.buckets:
            raise ValueError("histogram needs at least one finite bucket")
        self._counts = [0] * (len(self.buckets) + 1)  # + the +Inf bucket
        self._sum = 0.0

    def _new_child(self):
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, value):
        self._check_unlabeled()
        value = float(value)
        if math.isnan(value):
            # bisect_left(NaN) returns 0 (all comparisons false), which
            # would misclassify it as <= the smallest bound; +Inf is the
            # only bucket a NaN observation can honestly land in
            i = len(self.buckets)
        else:
            i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value

    def merge(self, other):
        """Add another histogram's observations into this one."""
        if tuple(other.buckets) != self.buckets:
            raise ValueError("cannot merge histograms with different "
                             "buckets")
        counts, total = other.snapshot()
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += total
        return self

    def snapshot(self):
        """``(raw_counts, sum)`` captured atomically — an exporter that
        read them as separate unlocked properties could race observe()
        and emit count != cumulative +Inf (invalid Prometheus output)."""
        with self._lock:
            return list(self._counts), self._sum

    @property
    def raw_counts(self):
        """Per-bucket (non-cumulative) counts, last entry = +Inf."""
        return list(self._counts)

    def cumulative_counts(self):
        """Prometheus-style cumulative ``le`` counts incl. +Inf."""
        out, acc = [], 0
        for c in self._counts:
            acc += c
            out.append(acc)
        return out

    @property
    def count(self):
        return sum(self._counts)

    @property
    def sum(self):
        return self._sum


class MetricsRegistry:
    """Name -> metric map. Factories are get-or-create and idempotent;
    re-registering a name as a different kind, with different labels,
    or with different buckets is an error (a silent return of the first
    registration would discard the caller's spec)."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.RLock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        if not enabled():
            return NULL
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            elif m.labelnames != labelnames:
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{m.labelnames}, not {labelnames}")
            elif cls is Histogram:
                want = _normalize_buckets(kw.get("buckets",
                                                 DEFAULT_BUCKETS))
                if want != m.buckets:
                    raise ValueError(
                        f"metric {name!r} already registered with "
                        f"buckets {m.buckets}, not {want}")
            return m

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name):
        with self._lock:
            return self._metrics.pop(name, None)

    def clear(self):
        with self._lock:
            self._metrics.clear()

    def collect(self):
        """Registered metrics sorted by name (a stable snapshot list)."""
        with self._lock:
            return [m for _, m in sorted(self._metrics.items())]


_default = MetricsRegistry()


def default_registry():
    """The process-global registry all built-in instrumentation uses."""
    return _default


def counter(name, help="", labelnames=()):
    return _default.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return _default.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
    return _default.histogram(name, help, labelnames, buckets=buckets)
