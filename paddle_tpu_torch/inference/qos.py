"""Multi-tenant QoS: fair-share admission ahead of the serving tier.

The degradation ladder already arbitrates *inside* the engine by
per-request ``priority``; what it cannot do is keep one tenant's flood
from consuming the whole admission pipe before priorities ever apply.
This module is that missing front gate:

- Tenants are declared with a **priority class** (mapped onto the
  ladder's integer ``priority``, so under pool pressure the engine
  trims/evicts the flooding low-class tenant first), a **token-rate
  share** (a token bucket refilled at ``rate`` tokens/sec up to
  ``burst``), and optional **TTFT/TPOT SLOs** (tracked per tenant;
  breaches counted, never enforced by killing requests).
- :meth:`QosGate.admit` runs BEFORE the cluster router: a tenant whose
  bucket is empty (it consumed its share and hasn't paid it back) is
  shed with a typed
  :class:`~paddle_tpu_torch.inference.serving.AdmissionError` carrying a
  ``retry_after`` derived from the bucket deficit and refill rate —
  the frontend turns it into ``429 + Retry-After``.
- The bucket is **debited from completed-token counts**
  (:meth:`QosGate.settle`), not reserved up front: admission stays
  optimistic (a request that sheds server-side costs its tenant
  nothing), the flood pays for what it actually burned, and a bucket
  driven negative keeps the tenant shed until the refill catches up.
- Everything is exported per tenant label:
  ``serving_tenant_admitted_total`` / ``serving_tenant_shed_total`` /
  ``serving_tenant_completed_tokens_total`` /
  ``serving_tenant_inflight`` / ``serving_tenant_ttft_seconds`` /
  ``serving_tenant_tpot_seconds`` /
  ``serving_tenant_slo_breaches_total{tenant,slo}``.
"""

from __future__ import annotations

import math
import threading
import time

from ..observability import metrics as _om
from .serving import AdmissionError

__all__ = ["Tenant", "QosGate", "CLASS_PRIORITY"]

#: Priority classes -> the engine ladder's integer ``priority``. The
#: ladder only ever trims/evicts strictly LOWER priorities, so a
#: premium request can displace standard/batch work but never the
#: other way around — degradation evicts the flooding tenant first.
CLASS_PRIORITY = {"batch": 0, "standard": 1, "premium": 2}

_LAT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _qos_metrics():
    return {
        "admitted": _om.counter(
            "serving_tenant_admitted_total",
            "requests admitted through the QoS gate",
            labelnames=("tenant",)),
        "shed": _om.counter(
            "serving_tenant_shed_total",
            "requests shed by the QoS gate (token bucket empty or "
            "tenant concurrency cap)", labelnames=("tenant",)),
        "tokens": _om.counter(
            "serving_tenant_completed_tokens_total",
            "tokens completed and debited against the tenant's bucket",
            labelnames=("tenant",)),
        "inflight": _om.gauge(
            "serving_tenant_inflight",
            "requests admitted through the gate and not yet settled",
            labelnames=("tenant",)),
        "bucket": _om.gauge(
            "serving_tenant_bucket_tokens",
            "current token-bucket balance (negative = in debt, shed "
            "until refill catches up)", labelnames=("tenant",)),
        "ttft": _om.histogram(
            "serving_tenant_ttft_seconds",
            "admission -> first token, per tenant",
            labelnames=("tenant",), buckets=_LAT_BUCKETS),
        "tpot": _om.histogram(
            "serving_tenant_tpot_seconds",
            "mean per-token latency of a settled request, per tenant",
            labelnames=("tenant",), buckets=_LAT_BUCKETS),
        "breaches": _om.counter(
            "serving_tenant_slo_breaches_total",
            "settled requests whose TTFT/TPOT exceeded the tenant's "
            "declared SLO", labelnames=("tenant", "slo")),
    }


class Tenant:
    """One tenant's declared share and service objectives.

    Args:
        name: label value on every per-tenant metric.
        tier: priority class (``"batch"`` / ``"standard"`` /
            ``"premium"``) mapped onto the engine ladder via
            :data:`CLASS_PRIORITY`; or pass ``priority`` explicitly.
        rate: token-bucket refill in completed tokens/second
            (``None`` = unmetered).
        burst: bucket capacity (default: 4 seconds of ``rate``).
        max_inflight: optional concurrency cap at the gate.
        ttft_slo / tpot_slo: optional latency objectives in seconds;
            settled requests past them count
            ``serving_tenant_slo_breaches_total{tenant,slo}``.
    """

    def __init__(self, name, tier="standard", priority=None, rate=None,
                 burst=None, max_inflight=None, ttft_slo=None,
                 tpot_slo=None):
        if priority is None:
            if tier not in CLASS_PRIORITY:
                raise ValueError(
                    f"unknown tier {tier!r}; pick one of "
                    f"{sorted(CLASS_PRIORITY)} or pass priority=")
            priority = CLASS_PRIORITY[tier]
        self.name = str(name)
        self.tier = tier
        self.priority = int(priority)
        self.rate = None if rate is None else float(rate)
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/sec, got {rate}")
        if burst is None:
            burst = 4.0 * self.rate if self.rate is not None \
                else float("inf")
        self.burst = float(burst)
        self.max_inflight = None if max_inflight is None \
            else int(max_inflight)
        self.ttft_slo = None if ttft_slo is None else float(ttft_slo)
        self.tpot_slo = None if tpot_slo is None else float(tpot_slo)
        # bucket state (guarded by the gate's lock)
        self._level = self.burst if math.isfinite(self.burst) else 0.0
        self._last_refill = None
        self._inflight = 0


class QosGate:
    """Fair-share admission gate ahead of the cluster router.

    Usage::

        gate = QosGate([Tenant("api", tier="premium", rate=500,
                               ttft_slo=0.5),
                        Tenant("batch", tier="batch", rate=100)])
        grant = gate.admit("api", max_tokens=64)   # AdmissionError: shed
        creq = cluster.submit(ids, priority=grant.priority, ...)
        ...
        gate.settle(grant, completed_tokens=len(out), ttft=t1, tpot=tp)

    Unknown tenant names get a lazily-created default-spec tenant, so
    the gate never turns a typo into a crash — give ``default_spec``
    a restrictive rate to make "unknown tenant" mean "tiny share".
    """

    class Grant:
        __slots__ = ("tenant", "priority", "t_admit", "settled")

        def __init__(self, tenant, t_admit):
            self.tenant = tenant
            self.priority = tenant.priority
            self.t_admit = t_admit
            self.settled = False

    def __init__(self, tenants=(), default_spec=None,
                 clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, Tenant] = {}
        self._default_spec = dict(default_spec or {})
        self._m = _qos_metrics()
        for t in tenants:
            self.add_tenant(t)

    def add_tenant(self, tenant):
        with self._lock:
            self._tenants[tenant.name] = tenant
        return tenant

    def tenant(self, name):
        """Get-or-create (default spec) the named tenant."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = Tenant(
                    name, **self._default_spec)
            return t

    def _refill(self, t, now):
        """Advance the bucket to ``now`` (caller holds the lock)."""
        if t.rate is None:
            return
        if t._last_refill is None:
            t._last_refill = now
            return
        dt = max(0.0, now - t._last_refill)
        t._last_refill = now
        t._level = min(t.burst, t._level + dt * t.rate)

    def admit(self, name, max_tokens=0):
        """One admission decision. Returns a :class:`Grant` (carrying
        the ladder ``priority`` to submit with) or raises a typed
        :class:`AdmissionError` whose ``retry_after`` estimates when
        the bucket climbs back above zero."""
        t = self.tenant(name)
        now = self._clock()
        with self._lock:
            self._refill(t, now)
            if t.max_inflight is not None \
                    and t._inflight >= t.max_inflight:
                self._m["shed"].labels(t.name).inc()
                raise AdmissionError(
                    f"tenant {t.name!r} at its concurrency cap "
                    f"({t.max_inflight})", live=t._inflight,
                    max_batch=t.max_inflight, free_pages=0, num_pages=0,
                    retries=0, retry_after=0.05)
            if t.rate is not None and t._level <= 0:
                # in debt: shed until the refill pays it back (plus
                # one step of headroom so a retry isn't instantly shed)
                retry_after = round((-t._level + 1.0) / t.rate, 4)
                self._m["shed"].labels(t.name).inc()
                self._m["bucket"].labels(t.name).set(t._level)
                raise AdmissionError(
                    f"tenant {t.name!r} exhausted its token-rate share",
                    live=t._inflight, max_batch=0, free_pages=0,
                    num_pages=0, retries=0, retry_after=retry_after)
            t._inflight += 1
            self._m["admitted"].labels(t.name).inc()
            self._m["inflight"].labels(t.name).set(t._inflight)
            if t.rate is not None:
                self._m["bucket"].labels(t.name).set(t._level)
        return self.Grant(t, now)

    def settle(self, grant, completed_tokens=0, ttft=None, tpot=None):
        """Close out one granted request: debit the bucket by what the
        request actually completed, drop the in-flight slot, record
        latency + SLO accounting. Idempotent per grant; safe for shed/
        errored requests (``completed_tokens=0``)."""
        t = grant.tenant
        now = self._clock()
        with self._lock:
            if grant.settled:
                return
            grant.settled = True
            self._refill(t, now)
            t._inflight = max(0, t._inflight - 1)
            if t.rate is not None and completed_tokens:
                t._level -= float(completed_tokens)
            self._m["inflight"].labels(t.name).set(t._inflight)
            if t.rate is not None:
                self._m["bucket"].labels(t.name).set(t._level)
        if completed_tokens:
            self._m["tokens"].labels(t.name).inc(int(completed_tokens))
        if ttft is not None:
            self._m["ttft"].labels(t.name).observe(float(ttft))
            if t.ttft_slo is not None and ttft > t.ttft_slo:
                self._m["breaches"].labels(t.name, "ttft").inc()
        if tpot is not None:
            self._m["tpot"].labels(t.name).observe(float(tpot))
            if t.tpot_slo is not None and tpot > t.tpot_slo:
                self._m["breaches"].labels(t.name, "tpot").inc()

    def snapshot(self):
        """Per-tenant state dump for tests/benches/dashboards."""
        now = self._clock()
        out = {}
        with self._lock:
            for name, t in self._tenants.items():
                self._refill(t, now)
                out[name] = {
                    "tier": t.tier, "priority": t.priority,
                    "rate": t.rate,
                    "bucket": t._level if t.rate is not None else None,
                    "inflight": t._inflight,
                }
        return out
