"""Host-side hang detection (port of ``StepWatchdog`` from
``paddle_tpu/distributed/watchdog.py``).

Reference: the NCCL comm watchdog (`phi/core/distributed/
comm_task_manager.h:37`, timeout detection `comm_task.h:127`): a
background loop that flags an operation that never completes. The
serving engine arms one instance around each warm dispatch with a
timeout that tracks the dispatch-latency P99 (its stuck-dispatch
detector).

Each instance exports ``watchdog_timeouts_total{watchdog}`` and
``watchdog_heartbeat_age_seconds{watchdog}`` under its name (an unnamed
one gets a unique ``wd<N>``); a stopped instance drops its age series,
and its timeout series when that never counted, unless a same-named
sibling still runs. A timeout dumps a flight-recorder post-mortem (when
a recorder is installed) and logs one warning naming the watchdog (a
stall is seen without a recorder too) before the callback runs.
The membership pieces of the reference module (``ElasticManager``,
``FileStore``, ``StaleEpochError``) come with the serving stack over the
engine (ROADMAP A9).
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time

from ..observability import flight_recorder as _fr
from ..observability import metrics as _om

__all__ = ["StepWatchdog"]

_WATCHDOG_IDS = itertools.count()
# live instances per label value: two watchdogs given the SAME explicit
# name share one exported child, and the first stop() must not remove a
# series the survivor still updates
_WATCHDOG_REFS_LOCK = threading.Lock()
_WATCHDOG_REFS: dict[str, int] = {}
_log = logging.getLogger(__name__)


class StepWatchdog:
    """Host-side hang detector. ``beat()`` after every step; if no beat
    arrives within ``timeout`` seconds, ``on_timeout(gap)`` fires (once
    per stall). Reference analog: CommTaskManager's timeout loop."""

    def __init__(self, timeout=300.0, on_timeout=None, poll=None,
                 abort=False, name=None):
        self.timeout = float(timeout)
        self.on_timeout = on_timeout
        self.abort = abort
        self._poll = poll or min(1.0, self.timeout / 4)
        self._last = None
        self._fired = False
        self._stop = threading.Event()
        self._thread = None
        self.timeouts = 0
        # per-instance label: two watchdogs in one process (train step +
        # data loader) must not zero each other's exported age, so an
        # unnamed instance gets a unique auto label
        self.name = str(name) if name is not None \
            else f"wd{next(_WATCHDOG_IDS)}"
        self._m_timeouts_family = _om.counter(
            "watchdog_timeouts_total", "step-heartbeat stalls detected",
            labelnames=("watchdog",))
        self._m_age_family = _om.gauge(
            "watchdog_heartbeat_age_seconds",
            "seconds since the last step heartbeat",
            labelnames=("watchdog",))
        self._m_timeouts = self._m_timeouts_family.labels(self.name)
        self._m_age = self._m_age_family.labels(self.name)
        self._started = False
        self._stopped = False

    def start(self):
        # the ref is taken here, not in __init__: a constructed-but-
        # abandoned instance must not pin the name forever and block a
        # later same-named watchdog's stop()-time series removal
        if not self._started:
            self._started = True
            with _WATCHDOG_REFS_LOCK:
                _WATCHDOG_REFS[self.name] = \
                    _WATCHDOG_REFS.get(self.name, 0) + 1
            # re-resolve the children: a same-named sibling's stop() may
            # have removed the ones bound at construction, and updates to
            # an orphaned child would never be exported
            self._m_timeouts = self._m_timeouts_family.labels(self.name)
            self._m_age = self._m_age_family.labels(self.name)
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()
        self._fired = False
        self._m_age.set(0.0)

    def arm(self, timeout):
        """Re-aim the running watchdog at one bounded operation: restart
        the clock, THEN set the fresh ``timeout`` — the other order
        lets the poll thread compare the new (small) timeout against a
        stale idle-period heartbeat and fire spuriously. Lets a single
        long-lived instance guard operations whose budget varies call
        to call (e.g. the serving engine's stuck-dispatch detector,
        whose timeout tracks the dispatch-latency P99)."""
        self.beat()
        self.timeout = float(timeout)

    def disarm(self):
        """Stand down between operations: an infinite timeout never
        fires, so idle gaps (an engine waiting for traffic) are not
        stalls. The heartbeat-age gauge keeps exporting."""
        self.timeout = float("inf")
        self.beat()

    def _loop(self):
        while not self._stop.wait(self._poll):
            if self._last is None:
                continue
            gap = time.monotonic() - self._last
            self._m_age.set(gap)
            if self._fired:
                continue
            if gap > self.timeout:
                self._fired = True
                self.timeouts += 1
                self._m_timeouts.inc()
                # post-mortem BEFORE the user callback / abort: a hung
                # dispatch's last spans, compiles, and metrics are exactly
                # what the stall diagnosis needs
                _fr.on_fatal(f"watchdog_timeout:{self.name}",
                             gap_seconds=gap, timeout=self.timeout)
                _log.warning("watchdog %s: no beat for %.3fs (timeout "
                             "%.3fs)", self.name, gap, self.timeout)
                if self.on_timeout is not None:
                    self.on_timeout(gap)
                if self.abort:
                    os._exit(124)   # the reference aborts hung workers

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._stopped:
            return
        self._stopped = True
        with _WATCHDOG_REFS_LOCK:
            if self._started:
                remaining = _WATCHDOG_REFS[self.name] = \
                    _WATCHDOG_REFS.get(self.name, 1) - 1
                if remaining <= 0:
                    _WATCHDOG_REFS.pop(self.name, None)
            else:
                remaining = _WATCHDOG_REFS.get(self.name, 0)
        if remaining > 0:
            return      # a same-named sibling still exports this series
        # a stopped watchdog must not keep exporting a frozen heartbeat
        # age (an age > timeout would alert forever); drop zero-count
        # timeout children too so per-fit auto-named instances don't
        # grow label cardinality without bound
        self._m_age_family.remove(self.name)
        if self._m_timeouts.value == 0:
            self._m_timeouts_family.remove(self.name)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
