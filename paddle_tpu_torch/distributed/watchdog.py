"""Host-side hang detection (port of ``StepWatchdog`` from
``paddle_tpu/distributed/watchdog.py``).

Reference: the NCCL comm watchdog (`phi/core/distributed/
comm_task_manager.h:37`, timeout detection `comm_task.h:127`): a
background loop that flags an operation that never completes. The
serving engine arms one instance around each warm dispatch with a
timeout that tracks the dispatch-latency P99 (its stuck-dispatch
detector).

Not in this port yet: the watchdog's metrics (``watchdog_timeouts_total``,
``watchdog_heartbeat_age_seconds``) and the flight-recorder post-mortem a
timeout dumps; both come with the observability modules (ROADMAP item A8).
Until then a timeout logs a warning where the reference dumps the
post-mortem, so a stall is seen without a callback.
The membership pieces of the reference module (``ElasticManager``,
``FileStore``) come with the serving stack over the engine (A9).
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time

__all__ = ["StepWatchdog"]

_WATCHDOG_IDS = itertools.count()
_log = logging.getLogger(__name__)


class StepWatchdog:
    """Host-side hang detector. ``beat()`` after every step; if no beat
    arrives within ``timeout`` seconds, ``on_timeout(gap)`` fires (once
    per stall) and ``timeouts`` counts it. Reference analog:
    CommTaskManager's timeout loop."""

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
        self.name = str(name) if name is not None \
            else f"wd{next(_WATCHDOG_IDS)}"

    def start(self):
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()
        self._fired = False

    def arm(self, timeout):
        """Re-aim the running watchdog at one bounded operation: restart
        the clock, THEN set the fresh ``timeout`` (the other order lets
        the poll thread compare the new, small timeout against a stale
        idle-period heartbeat and fire spuriously)."""
        self.beat()
        self.timeout = float(timeout)

    def disarm(self):
        """Stand down between operations: an infinite timeout never
        fires, so idle gaps (an engine waiting for traffic) are not
        stalls."""
        self.timeout = float("inf")
        self.beat()

    def _loop(self):
        while not self._stop.wait(self._poll):
            if self._last is None:
                continue
            gap = time.monotonic() - self._last
            if self._fired:
                continue
            if gap > self.timeout:
                self._fired = True
                self.timeouts += 1
                # before the user callback / abort, as the reference's
                # post-mortem
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

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
