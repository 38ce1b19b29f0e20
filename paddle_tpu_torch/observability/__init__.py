"""Runtime metrics of the port (``paddle_tpu/observability`` in part).

So far the thread-safe metric registry alone (:mod:`.metrics`, a copy of
the reference's: counters, gauges, histograms, labeled children, the
shared no-op :data:`~.metrics.NULL` metric under ``PADDLE_TPU_METRICS=0``).
The tracer, the exporters, the compile watcher, the flight recorder, the
SLO engine and the perf attribution layer are ROADMAP item A8.
"""

from . import metrics  # noqa: F401
from .metrics import (  # noqa: F401
    NULL, Counter, Gauge, Histogram, MetricsRegistry, counter,
    default_registry, enabled, gauge, histogram,
)

__all__ = [
    "metrics", "NULL", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "default_registry", "enabled",
]
