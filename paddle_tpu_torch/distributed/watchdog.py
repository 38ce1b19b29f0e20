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

The membership half (copied from the reference module): ``FileStore``,
a shared-filesystem membership store with TTL stamps, per-name epochs and
fencing, ``ElasticManager``, which watches it for scale events, and
``StaleEpochError``, what a fenced-out incarnation is told.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time

from ..observability import flight_recorder as _fr
from ..observability import metrics as _om
from ..testing import faults as _faults

__all__ = ["StepWatchdog", "ElasticManager", "FileStore",
           "StaleEpochError"]


class StaleEpochError(RuntimeError):
    """A membership action (heartbeat, registration, request submit or
    completion report) was stamped with an epoch older than the store's
    current epoch for that name: the acting incarnation has been fenced
    out by its supervisor-spawned replacement and must stop — a
    partitioned-but-alive old replica can never race the new one.
    Picklable with its typed fields intact (travels in rpc error
    replies)."""

    def __init__(self, host_id=None, epoch=None, current=None):
        super().__init__(
            f"stale epoch {epoch} for {host_id!r}: the store's current "
            f"epoch is {current} — this incarnation is fenced out by "
            f"its replacement")
        self.host_id = host_id
        self.epoch = epoch
        self.current = current

    def __reduce__(self):
        return (type(self), (self.host_id, self.epoch, self.current))

_WATCHDOG_IDS = itertools.count()

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


class FileStore:
    """Shared-filesystem membership store (the test/simple deployment
    analog of the reference's ETCD registry, which expires leases the
    same way — `fleet/elastic/manager.py` np_etcd lease TTL).

    ``register()`` stamps the current time; with a ``ttl`` (seconds), a
    host whose stamp ages past it stops appearing in :meth:`hosts` — a
    crashed host that never deregistered is treated as dead, and an
    :class:`ElasticManager` watching the store reports ``scale_down``.
    Re-registering (:meth:`heartbeat`) refreshes the stamp.

    Staleness is judged by the stamp file's **mtime** against the fs
    server's own "now" (probed via :meth:`_fs_now`) — one clock every
    writer AND reader agrees on, so neither a skewed writer nor a
    skewed reader (NTP step, drifting VM) can mass-expire perfectly
    healthy hosts. The embedded ``time.time()`` value is kept only as
    a fallback for stores where mtime is unavailable.

    **Epoch fencing.** Each host name owns a monotonically
    increasing epoch counter (``.epoch.<host>``, bumped atomically by
    :meth:`next_epoch`). A registration/heartbeat stamped with an
    epoch OLDER than the counter raises a typed
    :class:`StaleEpochError` (and counts
    ``cluster_stale_epoch_rejections_total``): a partitioned-but-alive
    old incarnation whose supervisor already spawned a replacement can
    never resurrect its membership stamp or race the new incarnation —
    the counter survives deregistration, so the fence holds across the
    death/replace window. Heartbeats additionally pass through the
    ``store.heartbeat`` network fault point, so a chaos plan can drop
    or delay them deterministically."""

    #: seconds between fs-clock probes (hosts() scans between probes
    #: reuse the cached offset)
    CLOCK_PROBE_INTERVAL = 5.0

    def __init__(self, path, ttl=None):
        self.path = path
        self.ttl = None if ttl is None else float(ttl)
        os.makedirs(path, exist_ok=True)
        self._clock_probe_at = None     # monotonic stamp of last probe
        self._clock_offset = 0.0        # fs-server now - reader now
        self._m_stale = _om.counter(
            "cluster_stale_epoch_rejections_total",
            "membership/submission actions rejected because their "
            "epoch was fenced out by a newer incarnation")

    def _fs_now(self):
        """The filesystem server's idea of "now". Stamp mtimes come
        from the fs server's clock, so aging must compare them against
        the SAME clock — a reader whose local clock runs ahead would
        otherwise mass-expire every healthy host. Measured by touching
        a hidden probe file and reading its mtime back; the offset is
        cached for CLOCK_PROBE_INTERVAL. Falls back to the local clock
        when the store is not writable."""
        mono = time.monotonic()
        if self._clock_probe_at is None \
                or mono - self._clock_probe_at >= \
                self.CLOCK_PROBE_INTERVAL:
            probe = os.path.join(self.path, f".clock.{os.getpid()}")
            try:
                with open(probe, "w") as f:
                    f.write("x")
                self._clock_offset = os.path.getmtime(probe) \
                    - time.time()
            except OSError:
                self._clock_offset = 0.0
            self._clock_probe_at = mono
        return time.time() + self._clock_offset

    # -- epoch fencing --------------------------------------------------
    def _epoch_path(self, host_id):
        return os.path.join(self.path, f".epoch.{host_id}")

    def epoch_of(self, host_id):
        """The store's current epoch for ``host_id`` (None before the
        first :meth:`next_epoch`)."""
        try:
            with open(self._epoch_path(host_id)) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return None

    def next_epoch(self, host_id, timeout=5.0):
        """Atomically bump and return ``host_id``'s epoch — the fresh
        incarnation's fencing token. Mutual exclusion rides a mkdir
        lock (atomic on shared filesystems). A lock abandoned by a
        crashed bumper is broken only when the lock DIRECTORY itself
        has aged past ``timeout`` (its mtime, not the waiter's
        patience), and breaking is an atomic ``rename`` aside — so two
        impatient waiters can never each remove the other's freshly
        acquired lock and both enter the critical section (which would
        hand out a duplicated epoch and silently defeat the fence)."""
        lock = self._epoch_path(host_id) + ".lock"
        token = f"{os.getpid()}.{time.monotonic_ns()}"
        deadline = time.monotonic() + float(timeout) * 4
        while True:
            try:
                os.mkdir(lock)
                # stamp ownership: a holder stalled past the break
                # timeout must not release a SUCCESSOR's lock from its
                # finally — only the stamped owner may rmdir
                try:
                    with open(os.path.join(lock, "owner"), "w") as f:
                        f.write(token)
                except OSError:
                    pass
                break
            except FileExistsError:
                try:
                    # fs-server clock vs fs mtime: a reader whose local
                    # clock runs ahead of the store must not judge a
                    # LIVE holder's lock stale and break it (two
                    # bumpers in the critical section = one duplicated
                    # epoch = no fence) — same skew discipline as the
                    # heartbeat stamps
                    age = self._fs_now() - os.path.getmtime(lock)
                except OSError:
                    age = 0.0       # vanished: retry the mkdir
                if age > float(timeout):
                    # the holder crashed mid-bump: exactly ONE breaker
                    # wins this atomic rename; everyone (winner
                    # included) then re-competes via mkdir
                    try:
                        os.rename(lock, f"{lock}.stale.{os.getpid()}"
                                        f".{time.monotonic_ns()}")
                    except OSError:
                        pass
                elif time.monotonic() > deadline:
                    break   # wedged store: best-effort bump wins out
                time.sleep(0.01)
            except OSError:
                # read-only store: fall back to a best-effort bump
                break
        try:
            new = (self.epoch_of(host_id) or 0) + 1
            tmp = self._epoch_path(host_id) + f".{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(str(new))
            os.replace(tmp, self._epoch_path(host_id))
            return new
        finally:
            # release ONLY if the lock is still ours: a holder that
            # stalled past the break timeout (its lock renamed aside)
            # or a waiter that gave up without acquiring must not
            # remove a successor's lock
            try:
                owner = os.path.join(lock, "owner")
                with open(owner) as f:
                    still_ours = f.read() == token
                if still_ours:
                    os.remove(owner)
                    os.rmdir(lock)
            except OSError:
                pass
            # sweep locks renamed aside by breakers (dead by
            # definition; best-effort hygiene)
            try:
                for name in os.listdir(self.path):
                    if name.startswith(
                            os.path.basename(lock) + ".stale."):
                        d = os.path.join(self.path, name)
                        try:
                            os.remove(os.path.join(d, "owner"))
                        except OSError:
                            pass
                        os.rmdir(d)
            except OSError:
                pass

    def check_epoch(self, host_id, epoch):
        """Raise :class:`StaleEpochError` (and count the rejection) if
        ``epoch`` has been fenced out by a newer incarnation."""
        if epoch is None:
            return
        current = self.epoch_of(host_id)
        if current is not None and int(epoch) < current:
            self._m_stale.inc()
            raise StaleEpochError(str(host_id), int(epoch), current)

    def register(self, host_id, epoch=None):
        """Stamp ``host_id`` live. With an ``epoch``, the registration
        is FENCED: a stale incarnation raises
        :class:`StaleEpochError` instead of resurrecting its stamp."""
        self.check_epoch(host_id, epoch)
        # stamp atomically (write-aside + replace): open(.., "w") would
        # truncate first, and a concurrent hosts() scan reading the
        # empty file would expire a perfectly healthy host
        final = os.path.join(self.path, str(host_id))
        tmp = os.path.join(self.path, f".stamp.{host_id}.{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(str(time.time()) if epoch is None
                    else f"{time.time()}:{int(epoch)}")
        os.replace(tmp, final)

    def heartbeat(self, host_id, epoch=None):
        """Refresh a live host's timestamp so it outlives the ttl.
        Passes the ``store.heartbeat`` network fault point first — a
        chaos plan can drop (returns False: the beat was lost in the
        network, silently) or delay it. A fenced-out incarnation's
        refresh raises :class:`StaleEpochError`."""
        verdict = _faults.fire_network("store.heartbeat",
                                       src=str(host_id), dst="store")
        if verdict.delay or verdict.hold:
            time.sleep(verdict.delay + verdict.hold)
        if verdict.drop:
            return False
        self.register(host_id, epoch=epoch)
        return True

    def heartbeat_age(self, host_id):
        """Seconds since ``host_id`` last stamped (fs-server clock), or
        None when it has no stamp — the /healthz surface an operator
        reads to spot a fenced-out or silently-aged replica."""
        try:
            stamp = os.path.getmtime(os.path.join(self.path,
                                                  str(host_id)))
        except OSError:
            return None
        return max(0.0, self._fs_now() - stamp)

    def deregister(self, host_id):
        try:
            os.remove(os.path.join(self.path, str(host_id)))
        except FileNotFoundError:
            pass

    def hosts(self):
        now = self._fs_now() if self.ttl is not None else time.time()
        out = []
        for name in sorted(os.listdir(self.path)):
            if name.startswith("."):
                continue            # in-flight stamp writes
            if self.ttl is not None:
                p = os.path.join(self.path, name)
                # age by the stamp file's MTIME first — on a shared
                # filesystem that is the fs server's clock, the one
                # reference all hosts see. The embedded time.time()
                # stamp is the WRITER's clock: cross-host skew or an
                # NTP step there would mass-expire (or immortalize)
                # perfectly healthy replicas, so it is only a fallback
                # for stores where mtime is unavailable/untrustworthy.
                try:
                    stamp = os.path.getmtime(p)
                except OSError:
                    try:
                        with open(p) as f:
                            # stamp content is "ts" or "ts:epoch"
                            stamp = float((f.read().strip() or "0")
                                          .split(":")[0])
                    except (OSError, ValueError):
                        continue        # vanished mid-scan
                if now - stamp > self.ttl:
                    continue
            out.append(name)
        return out


class ElasticManager:
    """Membership watch-loop (reference elastic/manager.py:124).

    ``watch_once()`` compares live membership against the expected world
    and returns one of "normal" / "scale_down" / "scale_up"; ``watch``
    loops until a scale event or stop. A store with a ``ttl`` ages out
    crashed hosts that never deregistered, so a stale registration
    surfaces here as ``scale_down`` rather than a live host forever. A
    supervisor reacts by checkpointing
    (distributed.checkpoint_manager) and relaunching with the new world
    size — the reference's recovery model.
    """

    def __init__(self, store, host_id, expected_hosts,
                 on_scale_event=None):
        self.store = store
        self.host_id = str(host_id)
        self.expected = int(expected_hosts)
        self.on_scale_event = on_scale_event
        self._stop = threading.Event()
        self._m_events = _om.counter(
            "elastic_scale_events_total",
            "membership deviations observed", labelnames=("kind",))
        self._m_live = _om.gauge(
            "elastic_live_hosts", "hosts currently registered")

    def register(self):
        self.store.register(self.host_id)
        return self

    def deregister(self):
        self.store.deregister(self.host_id)

    def watch_once(self):
        live = self.store.hosts()
        self._m_live.set(len(live))
        if len(live) < self.expected:
            self._m_events.labels("scale_down").inc()
            return "scale_down"
        if len(live) > self.expected:
            self._m_events.labels("scale_up").inc()
            return "scale_up"
        return "normal"

    def watch(self, interval=1.0, max_iters=None):
        i = 0
        while not self._stop.is_set():
            state = self.watch_once()
            if state != "normal":
                if self.on_scale_event is not None:
                    self.on_scale_event(state, self.store.hosts())
                return state
            i += 1
            if max_iters is not None and i >= max_iters:
                return "normal"
            time.sleep(interval)
        return "stopped"

    def stop(self):
        self._stop.set()
