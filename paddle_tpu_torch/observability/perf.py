"""Performance attribution: per-callable roofline gauges and an EWMA perf
sentinel (the port of ``paddle_tpu/observability/perf.py``, rebuilt for
the card).

The serving engine feeds every dispatch it times to :func:`note_dispatch`
under the reference's callable names (``serving.mixed_step``,
``serving.mixed_scan[n]``) with the dispatch's analytic cost (FLOPs of
its products, bytes of its weights, activations and KV writes):

- every dispatch folds its host wall time into
  ``paddle_tpu_perf_host_ms{callable}``;
- on a per-callable throttle (``PADDLE_TPU_PERF_FENCE_INTERVAL``
  seconds, default 0.5; ``0`` fences every dispatch) :func:`fence`
  brackets the dispatch with a pair of CUDA events on the current
  stream, read once the caller's own read-back has ended the dispatch:
  a true device-time sample that costs no ``synchronize`` of its own
  (on the CPU the host clock is the device clock);
- each fenced sample publishes the roofline gauges against the card's
  peaks (:func:`device_peaks`): ``paddle_tpu_perf_device_ms{callable}``,
  ``paddle_tpu_perf_attained_flops_frac{callable}`` and
  ``paddle_tpu_perf_attained_hbm_bw_frac{callable}``;
- an EWMA perf sentinel per callable (fast vs slow EWMA of fenced device
  time) counts sustained regressions on
  ``paddle_tpu_perf_regressions_total{callable}`` and flight-records a
  diagnosis bundle (rate-limited).

No event is recorded while a CUDA-graph capture runs (this thread's
stream capturing, or another thread holding
:data:`~paddle_tpu_torch.ops._graphs.CAPTURE_LOCK`).

Everything obeys ``PADDLE_TPU_METRICS=0``; ``PADDLE_TPU_PERF=0`` turns
off just the attribution layer while the rest of observability stays on.

:func:`capture_local` / :func:`capture_bundle` (on-demand profiler
capture) serve the cluster's ``/debug/profile``, which comes with the
serving stack over the engine (ROADMAP A9): both raise naming it.
"""

from __future__ import annotations

import os
import threading
import time

from . import metrics as _om
from .metrics import enabled as _metrics_enabled

__all__ = [
    "PEAKS", "enabled", "device_peaks", "fence", "note_dispatch",
    "observe", "recorders", "reset", "build_info", "ensure_build_info",
    "capture_local", "capture_bundle",
]

#: (peak FLOP/s, peak HBM bytes/s) per card by device name: the bf16
#: tensor-core peak (dense) and the published memory rate. The CPU gets a
#: nominal entry so the roofline fractions stay meaningful (tiny) rather
#: than absent in CPU runs.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
    "NVIDIA H100 SXM": (989e12, 3.35e12),
    "cpu": (1e12, 50e9),
}

#: fallbacks: an unknown Hopper card takes the H100 SXM's row, anything
#: else the nominal one
_DEFAULT_GPU_PEAKS = (989e12, 3.35e12)
_DEFAULT_PEAKS = (1e12, 50e9)

#: EWMA smoothing: fast tracks the last few fenced samples, slow is the
#: baseline the sentinel compares against
_ALPHA_FAST = 0.5
_ALPHA_SLOW = 0.05
#: fenced samples before the sentinel arms
_SENTINEL_MIN = 8
#: seconds between flight-recorder dumps per callable (the counter
#: still ticks every sustained regression)
_DUMP_INTERVAL = 60.0


def enabled():
    """Attribution is on when metrics are on, unless ``PADDLE_TPU_PERF=0``
    (checked per call so tests and benches can toggle the environment)."""
    return (_metrics_enabled()
            and os.environ.get("PADDLE_TPU_PERF", "1") != "0")


def _fence_interval():
    raw = os.environ.get("PADDLE_TPU_PERF_FENCE_INTERVAL")
    if not raw:
        return 0.5
    try:
        return max(0.0, float(raw))
    except ValueError:
        return 0.5


def _sentinel_ratio():
    raw = os.environ.get("PADDLE_TPU_PERF_SENTINEL_RATIO")
    try:
        return float(raw) if raw else 1.5
    except ValueError:
        return 1.5


def _sentinel_k():
    raw = os.environ.get("PADDLE_TPU_PERF_SENTINEL_K")
    try:
        return max(1, int(raw)) if raw else 4
    except ValueError:
        return 4


# ---------------------------------------------------------------------------
# peak table
# ---------------------------------------------------------------------------
_peaks_lock = threading.Lock()
_peaks_cache = None


def device_peaks():
    """``(peak_flops_per_s, peak_hbm_bytes_per_s, device_kind)`` of the
    current card (``torch.cuda.get_device_properties``: its name, and its
    SM count in the kind), else the CPU's nominal row.
    ``PADDLE_TPU_PEAK_FLOPS`` (FLOP/s) and ``PADDLE_TPU_PEAK_HBM_GBS``
    (GB/s) override per entry. Cached after the first call; it creates
    no CUDA context where none exists."""
    global _peaks_cache
    with _peaks_lock:
        if _peaks_cache is None:
            kind = "cpu"
            flops, bw = _DEFAULT_PEAKS
            final = True
            try:
                import torch

                if torch.cuda.is_available() \
                        and not torch.cuda.is_initialized():
                    final = False       # ask again once a card is in use
                elif torch.cuda.is_available():
                    props = torch.cuda.get_device_properties(
                        torch.cuda.current_device())
                    kind = f"{props.name} ({props.multi_processor_count} SMs)"
                    flops, bw = PEAKS.get(props.name, _DEFAULT_GPU_PEAKS
                                          if props.major >= 9
                                          else _DEFAULT_PEAKS)
            except Exception:
                pass
            env_flops = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
            env_bw = os.environ.get("PADDLE_TPU_PEAK_HBM_GBS")
            try:
                if env_flops:
                    flops = float(env_flops)
                if env_bw:
                    bw = float(env_bw) * 1e9
            except ValueError:
                pass
            if not final:
                return (flops, bw, str(kind))
            _peaks_cache = (flops, bw, str(kind))
        return _peaks_cache


# ---------------------------------------------------------------------------
# per-callable state
# ---------------------------------------------------------------------------
def _perf_metrics():
    return {
        "host_ms": _om.gauge(
            "paddle_tpu_perf_host_ms",
            "EWMA host-side dispatch wall time per watched callable "
            "(returns at enqueue — NOT device time; see "
            "paddle_tpu_perf_device_ms)", labelnames=("callable",)),
        "device_ms": _om.gauge(
            "paddle_tpu_perf_device_ms",
            "EWMA device time per watched callable from "
            "CUDA-event-fenced samples", labelnames=("callable",)),
        "flops_frac": _om.gauge(
            "paddle_tpu_perf_attained_flops_frac",
            "measured FLOP/s of the callable as a fraction of the "
            "device's peak (per-callable MFU; analytic FLOPs over "
            "fenced device time)", labelnames=("callable",)),
        "hbm_frac": _om.gauge(
            "paddle_tpu_perf_attained_hbm_bw_frac",
            "attained HBM bandwidth of the callable as a fraction of "
            "the device's peak (analytic bytes over fenced device "
            "time)", labelnames=("callable",)),
        "fenced": _om.counter(
            "paddle_tpu_perf_fenced_samples_total",
            "CUDA-event-fenced device-time samples taken",
            labelnames=("callable",)),
        "regressions": _om.counter(
            "paddle_tpu_perf_regressions_total",
            "sustained perf regressions the EWMA sentinel detected "
            "(fast EWMA above ratio x slow EWMA for K consecutive "
            "fenced samples)", labelnames=("callable",)),
    }


class _CallableState:
    """Rolling perf state for one named callable."""

    __slots__ = ("name", "host_ewma_ms", "device_ewma_ms", "fast_ms",
                 "slow_ms", "samples", "streak", "regressions",
                 "last_fence", "last_dump", "last_flops", "last_nbytes",
                 "_lock")

    def __init__(self, name):
        self.name = str(name)
        self.host_ewma_ms = None
        self.device_ewma_ms = None
        self.fast_ms = None
        self.slow_ms = None
        self.samples = 0
        self.streak = 0
        self.regressions = 0
        self.last_fence = None
        self.last_dump = None
        self.last_flops = None
        self.last_nbytes = None
        self._lock = threading.Lock()

    def note_host(self, host_s, metrics):
        ms = host_s * 1e3
        with self._lock:
            prev = self.host_ewma_ms
            self.host_ewma_ms = ms if prev is None else \
                prev + _ALPHA_FAST * (ms - prev)
            val = self.host_ewma_ms
        metrics["host_ms"].labels(self.name).set(val)

    def fence_due(self, now_mono):
        """Claim the next fenced sample slot if the throttle allows (the
        claim happens before the dispatch, so concurrent dispatch threads
        can't pile up fences)."""
        interval = _fence_interval()
        with self._lock:
            if (self.last_fence is not None
                    and now_mono - self.last_fence < interval):
                return False
            self.last_fence = now_mono
            return True

    def observe_device(self, device_s, flops, nbytes, metrics):
        """Fold one fenced device-time sample in; publish the roofline
        gauges and run the sentinel. Returns the sample summary."""
        ratio = _sentinel_ratio()
        k = _sentinel_k()
        ms = device_s * 1e3
        regression = False
        with self._lock:
            self.samples += 1
            if flops is not None:
                self.last_flops = flops
            if nbytes is not None:
                self.last_nbytes = nbytes
            self.device_ewma_ms = ms if self.device_ewma_ms is None \
                else self.device_ewma_ms \
                + _ALPHA_FAST * (ms - self.device_ewma_ms)
            self.fast_ms = ms if self.fast_ms is None else \
                self.fast_ms + _ALPHA_FAST * (ms - self.fast_ms)
            self.slow_ms = ms if self.slow_ms is None else \
                self.slow_ms + _ALPHA_SLOW * (ms - self.slow_ms)
            if (self.samples > _SENTINEL_MIN and self.slow_ms > 0
                    and self.fast_ms > ratio * self.slow_ms):
                self.streak += 1
            else:
                self.streak = 0
            if self.streak >= k:
                # sustained: count it, re-baseline the slow EWMA on the
                # new level (one regression = one event), reset
                regression = True
                self.regressions += 1
                self.streak = 0
                slow_before = self.slow_ms
                self.slow_ms = self.fast_ms
            device_ms = self.device_ewma_ms
            ewma_s = device_ms / 1e3
        peak_flops, peak_bw, kind = device_peaks()
        sample = {"callable": self.name, "device_ms": device_ms,
                  "device_kind": kind, "flops": flops, "bytes": nbytes,
                  "regression": regression}
        metrics["device_ms"].labels(self.name).set(device_ms)
        metrics["fenced"].labels(self.name).inc()
        if flops and flops > 0 and ewma_s > 0 and peak_flops > 0:
            frac = min(1.0, flops / (ewma_s * peak_flops))
            sample["attained_flops_frac"] = frac
            metrics["flops_frac"].labels(self.name).set(frac)
        if nbytes and nbytes > 0 and ewma_s > 0 and peak_bw > 0:
            frac = min(1.0, nbytes / (ewma_s * peak_bw))
            sample["attained_hbm_bw_frac"] = frac
            metrics["hbm_frac"].labels(self.name).set(frac)
        if regression:
            metrics["regressions"].labels(self.name).inc()
            self._flight_record(ms, slow_before, ratio, k, sample)
        return sample

    def _flight_record(self, ms, slow_before, ratio, k, sample):
        """One postmortem bundle per sustained regression, rate-limited
        per callable (the counter still ticks every event)."""
        now = time.monotonic()
        with self._lock:
            if (self.last_dump is not None
                    and now - self.last_dump < _DUMP_INTERVAL):
                return
            self.last_dump = now
        from . import flight_recorder as _fr

        try:
            _fr.dump(reason="perf_regression", info={
                "callable": self.name,
                "device_ms_last": round(ms, 3),
                "device_ms_baseline": round(slow_before, 3),
                "slowdown_x": round(ms / max(slow_before, 1e-9), 3),
                "sentinel_ratio": ratio, "sentinel_k": k,
                "sample": {kk: vv for kk, vv in sample.items()
                           if kk != "regression"},
            })
        except Exception:
            pass    # telemetry must never break the dispatch path

    def snapshot(self):
        with self._lock:
            return {"callable": self.name,
                    "host_ewma_ms": self.host_ewma_ms,
                    "device_ewma_ms": self.device_ewma_ms,
                    "fast_ms": self.fast_ms, "slow_ms": self.slow_ms,
                    "samples": self.samples, "streak": self.streak,
                    "regressions": self.regressions,
                    "flops": self.last_flops,
                    "bytes_accessed": self.last_nbytes}


_state_lock = threading.Lock()
_states: dict[str, _CallableState] = {}
_metrics_cache = None


def _metrics():
    global _metrics_cache
    if _metrics_cache is None or isinstance(
            _metrics_cache["host_ms"], _om._NullMetric):
        # rebuilt when the kill switch flips back on mid-process (tests)
        _metrics_cache = _perf_metrics()
    return _metrics_cache


def _state(name):
    with _state_lock:
        st = _states.get(name)
        if st is None:
            st = _states[name] = _CallableState(name)
        return st


def recorders():
    """``{callable: state snapshot}`` — the sentinel/roofline state per
    callable (diagnostics; the gauges are the stable API)."""
    with _state_lock:
        states = list(_states.values())
    return {st.name: st.snapshot() for st in states}


def reset():
    """Drop all per-callable state and caches (tests)."""
    global _peaks_cache, _metrics_cache, _build_info_cache
    with _state_lock:
        _states.clear()
    with _peaks_lock:
        _peaks_cache = None
    _metrics_cache = None
    _build_info_cache = None


# ---------------------------------------------------------------------------
# the dispatch hook
# ---------------------------------------------------------------------------
class _Fence:
    """One fenced sample's clock: a CUDA event pair on the current stream
    (read after the caller's read-back), or the host clock on the CPU."""

    __slots__ = ("events", "t0")

    def __init__(self, cuda):
        self.t0 = time.perf_counter()
        self.events = None
        if cuda:
            import torch
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()

    def stop(self):
        """Mark the end of the dispatch's device work (call right after
        its launches, before its read-back)."""
        if self.events is not None:
            self.events[1].record()

    def seconds(self):
        """The fenced device time, or None while its end is not done (no
        wait: the caller's read-back has finished it)."""
        if self.events is None:
            return time.perf_counter() - self.t0
        start, end = self.events
        if not end.query():
            return None
        return start.elapsed_time(end) / 1e3


def fence(name, device=None):
    """Claim a fenced device-time sample for this dispatch of ``name``
    when the throttle allows: returns a fence to :meth:`~_Fence.stop`
    after the dispatch's launches and hand to :func:`note_dispatch`, or
    None (attribution off, not due, or a CUDA-graph capture running)."""
    if not enabled():
        return None
    try:
        st = _state(name)
        if not st.fence_due(time.monotonic()):
            return None
        cuda = device is not None and getattr(device, "type", device) \
            == "cuda"
        if cuda:
            from .compile_watch import _capturing
            if _capturing():
                return None
        return _Fence(cuda)
    except Exception:
        return None


def note_dispatch(name, t0, fenced=None, flops=None, bytes_accessed=None):
    """Account one dispatch of ``name`` that started at
    ``time.perf_counter()`` value ``t0`` and has ended (its read-back is
    done): its host wall time into the per-callable EWMA and, with a
    ``fenced`` sample (:func:`fence`), its device time into the roofline
    gauges and the sentinel. Never raises; returns the fenced sample
    dict when one was taken, else None."""
    if not enabled():
        return None
    try:
        now = time.perf_counter()
        st = _state(name)
        m = _metrics()
        st.note_host(now - t0, m)
        if fenced is None:
            return None
        device_s = fenced.seconds()
        if device_s is None:
            return None
        return st.observe_device(device_s, flops, bytes_accessed, m)
    except Exception:
        return None


def observe(name, device_s, flops=None, bytes_accessed=None):
    """Feed one measured device-time sample for ``name`` directly — the
    fenced dispatch path's internal entry point; also the injection point
    for tests and external harnesses. Returns the sample dict, or None
    when disabled."""
    if not enabled():
        return None
    return _state(name).observe_device(
        float(device_s), flops, bytes_accessed, _metrics())


# ---------------------------------------------------------------------------
# build-info gauge
# ---------------------------------------------------------------------------
_build_info_cache = None


def build_info():
    """``{"git_commit", "torch_version", "device_kind"}`` for this process
    — what a merged cluster pane needs to identify what each replica
    runs. Cached; ``PADDLE_TPU_BUILD_COMMIT`` overrides the git lookup
    (set it in images built without a .git dir)."""
    global _build_info_cache
    if _build_info_cache is not None:
        return _build_info_cache
    commit = os.environ.get("PADDLE_TPU_BUILD_COMMIT")
    if not commit:
        try:
            import subprocess

            commit = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__)))),
                capture_output=True, text=True,
                timeout=5).stdout.strip() or "unknown"
        except Exception:
            commit = "unknown"
    try:
        import torch

        torch_version = torch.__version__
    except Exception:
        torch_version = "unknown"
    _build_info_cache = {"git_commit": commit,
                         "torch_version": torch_version,
                         "device_kind": device_peaks()[2]}
    return _build_info_cache


def ensure_build_info(registry=None):
    """Register/refresh ``paddle_tpu_build_info`` (value 1, identity in
    the labels: git commit, torch version, device kind) on ``registry``
    (the default registry when None) so every ``/metrics`` scrape carries
    it. No-op under ``PADDLE_TPU_METRICS=0``."""
    if not _metrics_enabled():
        return None
    reg = registry if registry is not None else _om.default_registry()
    g = reg.gauge(
        "paddle_tpu_build_info",
        "build/runtime identity (git commit, torch version, device kind "
        "as labels; value is always 1)",
        labelnames=("git_commit", "torch_version", "device_kind"))
    info = build_info()
    g.labels(info["git_commit"], info["torch_version"],
             info["device_kind"]).set(1)
    return g


# ---------------------------------------------------------------------------
# on-demand profiler capture: the serving stack's (ROADMAP A9)
# ---------------------------------------------------------------------------
def capture_local(seconds, worker_name=None):
    """The per-process half of the cluster's on-demand profiler capture,
    whose callers (``ServingCluster.capture_profile``, the replica
    worker) come with ROADMAP A9."""
    raise NotImplementedError(
        "perf.capture_local comes with the serving stack over the engine "
        "(ROADMAP A9)")


def capture_bundle(seconds, worker_name=None):
    """The local ``/debug/profile`` capture: None under
    ``PADDLE_TPU_METRICS=0`` (the route's 503), else it raises: it comes
    with the serving stack over the engine (ROADMAP A9)."""
    if not _metrics_enabled():
        return None
    raise NotImplementedError(
        "perf.capture_bundle comes with the serving stack over the engine "
        "(ROADMAP A9)")
