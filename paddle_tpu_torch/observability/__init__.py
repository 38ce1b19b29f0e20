"""Runtime observability of the port (``paddle_tpu/observability``).

The measurement substrate of the serving engine: a thread-safe metric
registry (:mod:`.metrics`), a host-span tracer with chrome-trace export
(:mod:`.trace`), distributed trace-context propagation and cross-process
trace merging (:mod:`.tracing`), Prometheus/JSON/HTTP exporters
(:mod:`.export`), the SLO burn-rate engine (:mod:`.slo`) — copies of the
reference's, which need no device — and, rebuilt for the card, the
compile watcher and device-memory gauges (:mod:`.compile_watch`: kernel
builds and loads, CUDA-graph captures, the caching allocator), the crash
flight recorder (:mod:`.flight_recorder`) and the perf attribution layer
(:mod:`.perf`: roofline gauges from CUDA-event-fenced device time, the
EWMA perf sentinel). ``PADDLE_TPU_METRICS=0`` turns the whole layer into
no-ops. README's port section lists the metric names.

Deferred, each raising with its ROADMAP item: ``watch`` / ``watched_jit``
(A11, A13) and ``capture_local`` / ``capture_bundle`` (A9).
"""

from . import (  # noqa: F401
    compile_watch, export, flight_recorder, metrics, perf, slo, trace,
    tracing,
)
from .compile_watch import (  # noqa: F401
    sample_device_memory, watch, watched_jit,
)
from .export import (  # noqa: F401
    json_snapshot, prometheus_text, snapshot_to_prometheus,
    start_http_server,
)
from .metrics import (  # noqa: F401
    NULL, Counter, Gauge, Histogram, MetricsRegistry, counter,
    default_registry, enabled, gauge, histogram,
)
from .perf import (  # noqa: F401
    build_info, capture_bundle, capture_local, device_peaks,
    ensure_build_info,
)
from .slo import SloEngine, SloSpec, histogram_quantile  # noqa: F401
from .trace import export_chrome_trace, span  # noqa: F401
from .tracing import (  # noqa: F401
    TraceContext, activate, adopt, current, format_traceparent,
    parse_traceparent,
)

__all__ = [
    "metrics", "trace", "tracing", "export", "compile_watch",
    "flight_recorder", "slo", "perf",
    "TraceContext", "current", "activate", "adopt",
    "parse_traceparent", "format_traceparent",
    "SloEngine", "SloSpec", "histogram_quantile",
    "device_peaks", "build_info", "ensure_build_info",
    "capture_local", "capture_bundle",
    "NULL", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "default_registry", "enabled",
    "span", "export_chrome_trace",
    "prometheus_text", "json_snapshot", "snapshot_to_prometheus",
    "start_http_server",
    "watch", "watched_jit", "sample_device_memory",
]
