"""SLO burn-rate engine: multi-window TTFT/TPOT burn rates from
cumulative histogram snapshots (a copy of
``paddle_tpu/observability/slo.py``: it needs no device).

The autoscaler-ready cluster signal: given a latency
SLO ("99% of first tokens within 0.5 s"), the *burn rate* over a window
is how fast the error budget is being spent — ``bad_fraction /
(1 - objective)``. Burn rate 1.0 means the budget is being consumed
exactly at the sustainable pace; 10x+ over a short window is the page,
1x+ over a long window is the slow leak (the standard multi-window
multi-burn alerting shape).

:class:`SloEngine` is fed *cumulative* histogram snapshots (bucket
counts as scraped — exactly what ``ServingCluster.scrape()`` merges
from the replicas, or a local registry's histogram) and keeps a small
time-indexed ring per SLO so each window's burn rate is computed from
the *delta* of observations inside that window: ``bad = observations
above the threshold bucket``, ``burn = (bad/total) / (1 - objective)``.
A window with no observations reports burn 0.0 (no traffic burns no
budget).

Results surface as the ``serving_slo_burn_rate{slo,window}`` gauge and
on ``ServingCluster.membership_info()``. Obeys the standard
``PADDLE_TPU_METRICS=0`` kill switch.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque

from . import metrics as _om
from .metrics import enabled

__all__ = ["SloSpec", "SloEngine", "DEFAULT_WINDOWS",
           "histogram_quantile"]

#: multi-window shape: fast page / mid alert / slow leak (seconds)
DEFAULT_WINDOWS = (60.0, 300.0, 1800.0)


class SloSpec:
    """One latency SLO: ``objective`` of observations of histogram
    ``metric`` must land at or under ``threshold`` seconds."""

    __slots__ = ("name", "metric", "threshold", "objective")

    def __init__(self, name, metric, threshold, objective=0.99):
        self.name = str(name)
        self.metric = str(metric)
        self.threshold = float(threshold)
        if not 0.0 < float(objective) < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective}")
        self.objective = float(objective)

    def __repr__(self):
        return (f"SloSpec({self.name!r}, metric={self.metric!r}, "
                f"threshold={self.threshold}, "
                f"objective={self.objective})")


def default_slos(ttft=0.5, tpot=0.1, objective=0.99):
    """The serving pair: TTFT against ``serving_ttft_seconds``, TPOT
    against ``serving_token_latency_seconds``."""
    return (SloSpec("ttft", "serving_ttft_seconds", ttft, objective),
            SloSpec("tpot", "serving_token_latency_seconds", tpot,
                    objective))


def _split_counts(buckets, counts, threshold):
    """(good, bad) observation counts for one cumulative-bucket
    snapshot: ``bad`` = observations in buckets whose upper bound
    exceeds ``threshold`` (the +Inf bucket is always bad unless the
    threshold is infinite). Bucket granularity bounds the error — a
    threshold inside a bucket counts that whole bucket as good."""
    buckets = list(buckets)
    # rightmost bucket bound <= threshold is still "good"
    k = bisect.bisect_right(buckets, float(threshold))
    good = sum(counts[:k])
    bad = sum(counts[k:])
    return good, bad


def histogram_quantile(buckets, counts, q):
    """Prometheus-style quantile estimate from one histogram snapshot:
    finite bucket upper bounds ``buckets`` plus per-bucket
    (non-cumulative) ``counts`` with the +Inf bucket last (``len(counts)
    == len(buckets) + 1``). Works on raw snapshots and equally on the
    *delta* of two cumulative snapshots — the window shape the burn-rate
    ring keeps.

    Linear interpolation inside the landing bucket (lower bound 0.0 for
    the first bucket — the latency domain is non-negative); a quantile
    landing in the +Inf bucket clamps to the highest finite bound, as
    Prometheus does. Returns None when there are no observations or any
    count is negative (a counter reset between the two snapshots of a
    delta)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    buckets = [float(b) for b in buckets]
    counts = [float(c) for c in counts]
    if len(counts) != len(buckets) + 1:
        raise ValueError(
            f"need len(buckets)+1 counts (+Inf last), got "
            f"{len(counts)} counts for {len(buckets)} buckets")
    total = sum(counts)
    if total <= 0 or any(c < 0 for c in counts):
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev = cum
        cum += c
        if cum >= rank and c > 0:
            if i >= len(buckets):       # +Inf bucket: clamp
                return buckets[-1] if buckets else None
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i]
            return lo + (hi - lo) * max(0.0, rank - prev) / c
    return buckets[-1] if buckets else None


class SloEngine:
    """Burn-rate computation over periodic cumulative snapshots.

    Feed it with :meth:`observe` (one call per SLO per scrape tick,
    cumulative bucket counts); read :meth:`burn_rates`. Ticks land in a
    bounded ring sized to the longest window, so memory stays O(windows
    / tick interval)."""

    def __init__(self, slos=None, windows=DEFAULT_WINDOWS,
                 max_points=512, registry=None):
        self.slos = tuple(slos if slos is not None else default_slos())
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows:
            raise ValueError("at least one window required")
        self._points = {s.name: deque(maxlen=int(max_points))
                        for s in self.slos}
        self._lock = threading.Lock()
        reg = registry if registry is not None else _om.default_registry()
        self._gauge = reg.gauge(
            "serving_slo_burn_rate",
            "error-budget burn rate per SLO and window (1.0 = budget "
            "spent exactly at the sustainable pace)",
            labelnames=("slo", "window"))

    def spec(self, name):
        for s in self.slos:
            if s.name == name:
                return s
        raise KeyError(name)

    def observe(self, slo_name, buckets, counts, now=None):
        """Record one cumulative snapshot for ``slo_name``: the
        histogram's bucket bounds + per-bucket (non-cumulative) counts
        as scraped. No-op under ``PADDLE_TPU_METRICS=0``."""
        if not enabled():
            return
        spec = self.spec(slo_name)
        good, bad = _split_counts(buckets, counts, spec.threshold)
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._points[spec.name].append((t, good + bad, bad))

    def observe_histogram(self, slo_name, hist, now=None):
        """Convenience: snapshot a live
        :class:`~.metrics.Histogram` leaf."""
        counts, _ = hist.snapshot()
        self.observe(slo_name, hist.buckets, counts, now=now)

    def _window_burn(self, spec, points, window, now):
        """Burn over [now - window, now] from the cumulative points."""
        if not points:
            return 0.0
        cutoff = now - window
        # baseline: the newest point at or before the cutoff; if every
        # point is inside the window, delta from zero (the ring covers
        # the whole history we have)
        base_total = base_bad = 0
        end_total = end_bad = None
        for t, total, bad in points:
            if t <= cutoff:
                base_total, base_bad = total, bad
            end_total, end_bad = total, bad
        d_total = end_total - base_total
        d_bad = end_bad - base_bad
        if d_total <= 0 or d_bad < 0:
            # no traffic in the window (or a counter reset behind us —
            # a replica restart zeroes its histograms): report no burn
            # rather than a negative/undefined rate
            return 0.0
        budget = 1.0 - spec.objective
        return (d_bad / d_total) / budget

    def burn_rates(self, now=None):
        """``{slo: {window_label: burn}}`` over every configured
        window, and publish each value on
        ``serving_slo_burn_rate{slo,window}``. Window labels are
        humanized seconds (``"60s"``, ``"300s"``, ...)."""
        t = time.monotonic() if now is None else float(now)
        out = {}
        with self._lock:
            snap = {name: list(pts) for name, pts in self._points.items()}
        for spec in self.slos:
            per = {}
            for w in self.windows:
                label = f"{int(w) if w == int(w) else w}s"
                burn = self._window_burn(spec, snap[spec.name], w, t)
                per[label] = round(burn, 6)
                self._gauge.labels(spec.name, label).set(per[label])
            out[spec.name] = per
        return out
