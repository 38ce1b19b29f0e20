"""Multi-replica serving tier: load-aware routing, membership, rolling
restart (a copy of the reference's ``inference/cluster.py``; the replica
profiling rides ``torch.profiler``).

One :class:`~paddle_tpu_torch.inference.serving.LlamaServingEngine` is a
single continuous batch on a single card; this module is the layer that
makes N of them look like one service:

- :class:`EngineReplica` — one engine driven by its own worker thread,
  registered in the shared :class:`~paddle_tpu_torch.distributed.watchdog
  .FileStore` membership store with TTL heartbeats (the elastic
  launcher's liveness mechanism, reused for serving). A replica that
  dies — fault-injected via the ``replica.dead`` point, or a simulated
  SIGKILL via :meth:`EngineReplica.kill` — simply stops heartbeating
  and ages out of membership.
- :class:`ClusterRequest` — the router-level request handle. It
  survives its replica: if the replica dies before the request
  finishes, the router re-submits it elsewhere (bounded by
  ``failover_budget``), and a cluster-level ``deadline`` keeps ticking
  across attempts — a request always ends terminal (completed or a
  typed error), never lost.
- :class:`ServingCluster` — the routing frontend. ``submit()`` picks
  the least-loaded ready replica from the engines' own queue-depth /
  KV-page-utilization gauges; when every replica sheds, the typed
  :class:`~paddle_tpu_torch.inference.serving.AdmissionError` propagates with
  the smallest ``retry_after`` hint (backpressure, not a drop). A
  monitor thread watches membership through an
  :class:`~paddle_tpu_torch.distributed.watchdog.ElasticManager`, fails over
  the requests of dead replicas and (``auto_replace=True``) rebuilds
  them. :meth:`ServingCluster.rolling_restart` cycles replicas through
  ``drain()`` one at a time — the router stops routing to a draining
  replica, its backlog is re-routed, in-flight requests finish or
  expire typed inside the grace window, and a fresh engine takes over.

Each replica's engine keeps its own shared-prefix KV cache, so a hot
system prompt is prefilled once per replica. In tests replicas are
in-process engines; a subprocess deployment drives the same surface
(the worker loop maps 1:1 onto a process main loop with the store on a
shared filesystem).

Several in-process engines share one card. Their dispatches are
serialized by the engines' cross-engine lock, and a tick graph is
captured inside a dispatch, in CUDA's global capture mode, where another
thread's allocation or synchronize breaks the capture. So an engine is
built (its pools allocated, its prewarm captured) holding that lock and
:data:`~paddle_tpu_torch.ops._graphs.CAPTURE_LOCK`
(:func:`_build_engine`); the heartbeat sidecars, the monitor, ``load()``
and the scrape stay on the host.

Fault points: ``router.route`` fires per routing decision and
``replica.dead`` fires per worker-loop tick, so a ``PADDLE_TPU_FAULTS``
plan can inject routing errors or kill replica N at tick K
deterministically in CI. Network rules at ``store.heartbeat`` /
``rpc.send`` / ``rpc.reply`` drop, delay, duplicate, or partition the
control-plane messages themselves.

Partition tolerance: every replica incarnation registers
under a fresh monotonic EPOCH from the store; heartbeats and request
submissions stamped with a fenced-out epoch raise a typed
:class:`~paddle_tpu_torch.distributed.watchdog.StaleEpochError`, so a
partitioned-but-alive old incarnation can never race its supervisor-
spawned replacement — and a request that completes on both emits
exactly once (first terminal report wins, token-exact;
``cluster_duplicate_completions_suppressed_total``).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import random
import tempfile
import threading
import time

import numpy as np

from ..distributed.net_store import LeaseStore, StoreUnavailableError
from ..distributed.watchdog import (ElasticManager, FileStore,
                                    StaleEpochError)
from ..observability import metrics as _om
from ..observability import slo as _slo
from ..observability import tracing as _tracing
from ..observability.export import (aggregate_snapshot, json_snapshot,
                                    merge_snapshots)
from ..observability.trace import span as _span
from ..testing import faults as _faults
from .sampling import SamplingParams
from ..ops._graphs import CAPTURE_LOCK
from .serving import (_CROSS_ENGINE_LOCK, AdmissionError, DeadlineExceeded,
                      LlamaServingEngine, Request)

__all__ = ["ClusterRequest", "EngineReplica", "SubprocessReplica",
           "ServingCluster", "ReplicaLostError", "StaleEpochError"]


def _m_stale():
    return _om.counter(
        "cluster_stale_epoch_rejections_total",
        "membership/submission actions rejected because their epoch "
        "was fenced out by a newer incarnation")


def _m_dup_completions():
    return _om.counter(
        "cluster_duplicate_completions_suppressed_total",
        "terminal reports for an already-finished cluster request "
        "(split-brain / failover double completion) suppressed — the "
        "first terminal state won, token-exact")


#: how long a restart waits for the previous incarnation's worker loop
#: to leave its dispatch (one decode burst) before the attempt fails
_RESTART_JOIN_S = 60.0


def _build_engine(factory):
    """``factory()`` holding the cross-engine dispatch lock and the
    capture lock (in that order, the dispatches' own): an engine built
    while another replica's thread dispatches or captures a tick graph
    allocates its pools (and prewarms) only between that thread's
    dispatches, so no allocation lands inside a capture."""
    with _CROSS_ENGINE_LOCK, CAPTURE_LOCK:
        return factory()


class ReplicaLostError(RuntimeError):
    """Terminal cluster-level failure: the request's replica died and
    its failover budget is spent. Carries enough to alert on."""

    def __init__(self, msg, replica_id=None, failovers=0):
        super().__init__(msg)
        self.replica_id = replica_id
        self.failovers = failovers

    def __reduce__(self):
        # survives the rpc error-reply round trip with its typed fields
        # (default exception pickling keeps __dict__, but rebuilding
        # from fields is the explicit contract the tests pin down)
        return (type(self), (self.args[0] if self.args else "",
                             self.replica_id, self.failovers))


def _router_metrics():
    return {
        "routed": _om.counter(
            "router_requests_routed_total",
            "requests routed to a replica", labelnames=("replica",)),
        "backpressure": _om.counter(
            "router_backpressure_total",
            "submissions rejected because every replica shed"),
        "failover": _om.counter(
            "router_failovers_total",
            "requests re-submitted after their replica died"),
        "lost": _om.counter(
            "router_requests_lost_total",
            "requests that exhausted their failover budget"),
        "replaced": _om.counter(
            "router_replicas_replaced_total",
            "dead replicas rebuilt by the monitor"),
        "restarts": _om.counter(
            "router_rolling_restarts_total",
            "replicas cycled through a rolling restart"),
        "ready": _om.gauge(
            "router_replicas_ready",
            "replicas currently routable (alive, registered, not "
            "draining)"),
        "quarantined": _om.counter(
            "cluster_replica_quarantined_total",
            "replicas quarantined by the crash-loop circuit breaker"),
        "quarantined_now": _om.gauge(
            "cluster_replicas_quarantined",
            "replicas currently held out by the circuit breaker"),
        "affinity_hits": _om.counter(
            "serving_prefix_affinity_hits_total",
            "requests routed to a replica advertising their prompt's "
            "prefix in its hot-prefix set"),
        "scrape_failures": _om.counter(
            "cluster_scrape_failures_total",
            "per-replica metric-scrape rpcs that failed",
            labelnames=("replica",)),
    }


class ClusterRequest:
    """One generation request at the routing tier.

    Holds the *intent* (prompt, budgets, priority); each submission to
    a replica materializes a fresh engine-level
    :class:`~paddle_tpu_torch.inference.serving.Request` so a failover
    restarts cleanly. ``deadline`` is a cluster-level wall-clock TTL
    measured from the first ``submit()`` — it keeps ticking across
    failovers, so a request bouncing between dying replicas still ends
    in a typed :class:`DeadlineExceeded` rather than living forever.
    """

    def __init__(self, prompt_ids, max_new_tokens=16, eos_token_id=None,
                 deadline=None, token_budget=None, priority=0,
                 retry_budget=1, failover_budget=3, sampling=None,
                 stop=(), on_token=None):
        self.prompt_ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.deadline = None if deadline is None else float(deadline)
        self.token_budget = token_budget
        self.priority = int(priority)
        self.retry_budget = int(retry_budget)
        self.failover_budget = int(failover_budget)
        if sampling is not None and sampling.seed is None \
                and not sampling.is_greedy:
            # pin the auto-seed at the CLUSTER request level: engine
            # auto-seeds are per-attempt, so a failover's fresh engine
            # Request would otherwise resample a DIFFERENT sequence —
            # a streaming client could receive a spliced output the
            # stream's shrink check cannot detect
            sampling = SamplingParams(
                temperature=sampling.temperature,
                top_p=sampling.top_p, top_k=sampling.top_k,
                seed=int.from_bytes(os.urandom(4), "little") % (2**31),
                stop=sampling.stop, logit_bias=sampling.logit_bias,
                constraint=sampling.constraint)
        self.sampling = sampling
        self.stop = tuple(int(t) for t in (stop or ()))
        #: optional streaming hook ``fn(token)`` — fired per appended
        #: token by an IN-PROCESS engine attempt (subprocess replicas
        #: surface partials through :meth:`partial_output` instead)
        self.on_token = on_token
        #: the distributed trace node this request belongs to, captured
        #: from the ambient context at construction (the frontend's
        #: request span, or the rpc.handle span in a subprocess worker)
        #: so replica-side spans can chain to it from other threads
        self._trace = _tracing.current()
        self.failovers = 0
        self.request: Request | None = None   # current engine attempt
        self.replica_id = None
        self.status = "pending"
        self.error = None
        self.output_ids: list[int] = []
        self._partial: list[int] = []   # poller-mirrored live output
        self._t_submit = None
        self._finished = threading.Event()
        self._lock = threading.Lock()
        # constructing the engine request up front validates the args
        # at submit() time, not on a replica's worker thread
        Request(self.prompt_ids, self.max_new_tokens, eos_token_id,
                deadline, token_budget, priority, retry_budget,
                sampling=sampling, stop=self.stop)

    # ------------------------------------------------------------------
    @property
    def done(self):
        return self._finished.is_set()

    def wait(self, timeout=None):
        """Block until terminal; True if it finished in time."""
        return self._finished.wait(timeout)

    def result(self, timeout=None):
        """Output ids, or raises the typed terminal error (or
        :class:`TimeoutError` if still running past ``timeout``)."""
        if not self._finished.wait(timeout):
            raise TimeoutError(
                f"request not finished within {timeout}s "
                f"(status={self.status})")
        if self.error is not None:
            raise self.error
        return self.output_ids

    # -- replica-side hooks --------------------------------------------
    def _remaining_ttl(self, now=None):
        if self.deadline is None:
            return None
        now = time.perf_counter() if now is None else now
        return self.deadline - (now - self._t_submit)

    def _new_attempt(self, replica_id):
        """Engine-level request for one submission attempt, or None if
        the cluster deadline already lapsed (the request is finished
        typed here — never silently dropped)."""
        with self._lock:
            if self._finished.is_set():
                return None
            ttl = self._remaining_ttl()
            if ttl is not None and ttl <= 0:
                self._finish_locked(
                    "deadline_exceeded",
                    DeadlineExceeded(
                        f"cluster deadline of {self.deadline}s lapsed "
                        f"before the request reached a live replica",
                        tokens_emitted=len(self.output_ids),
                        reason="cluster deadline"))
                return None
            r = Request(self.prompt_ids, self.max_new_tokens,
                        self.eos_token_id, ttl, self.token_budget,
                        self.priority, self.retry_budget,
                        sampling=self.sampling, stop=self.stop,
                        on_token=self._attempt_token)
            self.request = r
            self.replica_id = replica_id
            self.status = "live"
            return r

    def _finish_locked(self, status, error):
        self.status = status
        self.error = error
        self._finished.set()

    def _attempt_spec(self, replica_id):
        """JSON-able engine-request spec for one submission attempt to a
        SUBPROCESS replica (deadline already reduced to the remaining
        cluster TTL), or None when the request finished typed first."""
        req = self._new_attempt(replica_id)
        if req is None:
            return None
        return {"prompt_ids": [int(t) for t in self.prompt_ids],
                "max_new_tokens": self.max_new_tokens,
                "eos_token_id": self.eos_token_id,
                "deadline": req.deadline,
                "token_budget": self.token_budget,
                "priority": self.priority,
                "retry_budget": self.retry_budget,
                "sampling": None if self.sampling is None
                else self.sampling.to_spec(),
                "stop": list(self.stop)}

    # -- streaming hooks -----------------------------------------------
    def _attempt_token(self, req, token):
        """Engine-side per-token hook of the CURRENT in-process
        attempt; forwards to the caller's ``on_token``."""
        cb = self.on_token
        if cb is not None:
            try:
                cb(int(token))
            except Exception:
                pass        # streaming hooks must never kill a dispatch

    def _mirror_partial(self, output_ids):
        """Adopt a subprocess replica's non-terminal output snapshot
        (poller thread). Terminal adoption still goes through
        :meth:`_finish_remote` exactly once."""
        with self._lock:
            if not self._finished.is_set():
                self._partial = list(output_ids or [])

    def partial_output(self):
        """Best-effort live output snapshot for streaming: the current
        in-process attempt's tokens, the poller's last mirror for a
        subprocess attempt, or the terminal output once finished. May
        SHRINK across a failover (the replacement attempt restarts
        generation) — streaming frontends treat a shrink as a stream
        error."""
        with self._lock:
            if self._finished.is_set():
                return list(self.output_ids)
            r = self.request
            partial = list(self._partial)
        if r is not None and r.status != "pending" \
                and len(r.output_ids) >= len(partial):
            # in-process live attempt: the engine request IS the truth
            return list(r.output_ids)
        return partial

    def _finish_from(self, req):
        """Adopt an engine request's terminal state. Exactly-once: a
        second terminal report (the request completed on BOTH an
        orphaned incarnation and its failover target) is suppressed —
        the first emission won, token-exact — and counted. Returns
        whether the report was adopted."""
        with self._lock:
            if self._finished.is_set():
                _m_dup_completions().inc()
                return False
            self.output_ids = list(req.output_ids)
            self._finish_locked(req.status, req.error)
            return True

    def _finish_remote(self, status, output_ids, error):
        """Adopt a terminal state reported by a subprocess replica over
        rpc (the error arrives pickled — typed, fields intact). Same
        exactly-once contract as :meth:`_finish_from`."""
        with self._lock:
            if self._finished.is_set():
                _m_dup_completions().inc()
                return False
            self.output_ids = list(output_ids or [])
            self._finish_locked(status, error)
            return True

    def _fail(self, status, error):
        with self._lock:
            if not self._finished.is_set():
                self._finish_locked(status, error)

    def cancel(self):
        """Best-effort cancel: marks the handle terminal and cancels
        the current engine attempt if one is live."""
        with self._lock:
            req = self.request
            if not self._finished.is_set():
                self._finish_locked("cancelled", None)
        return req


class EngineReplica:
    """One serving replica: an engine plus the worker thread that
    drives it (admission from a backlog queue, decode steps, completion
    reaping, membership heartbeats). The worker thread is the ONLY
    thread that touches the engine's dispatch path; the router merely
    appends to the backlog, so replica-internal state never races.

    ``kill()`` simulates a SIGKILL: the worker stops mid-loop without
    draining or deregistering — exactly what a preempted host looks
    like to the membership store (its stamp ages out after ``ttl``).
    """

    def __init__(self, replica_id, engine_factory, store=None,
                 ttl=None, heartbeat_interval=None, max_backlog=None,
                 idle_sleep=0.002, burst=None, spawn_fault=True):
        self.replica_id = str(replica_id)
        # replica_main() passes False: for a subprocess worker the
        # SUPERVISOR's Popen is the spawn — the inherited fault plan
        # must not fire the same serve.spawn rule a second time inside
        # the worker it already allowed to spawn
        self._spawn_fault = bool(spawn_fault)
        self._factory = engine_factory
        self.engine: LlamaServingEngine | None = None
        self.store = store
        self.ttl = ttl
        self._hb_interval = heartbeat_interval or (
            ttl / 3.0 if ttl else 0.5)
        self.max_backlog = max_backlog
        self.idle_sleep = float(idle_sleep)
        self.burst = burst                  # decode chunk per loop tick
        self._backlog: collections.deque[ClusterRequest] = \
            collections.deque()
        self._tracked: dict[Request, ClusterRequest] = {}
        # requests popped from the backlog but not yet admitted: the
        # worker can die (fault injection) mid-admission, and a
        # request in that window must still be found by failover
        self._pending_admit: list[ClusterRequest] = []
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread = None
        self._hb_thread = None
        self._draining = False
        self._dead = False
        self._fenced = False
        self._death_reason = None
        self._last_beat = 0.0
        self._ticks = 0
        self._beats = 0
        self._spawns = 0
        #: membership fencing token of the CURRENT incarnation (bumped
        #: by every start/restart through the store's epoch counter)
        self.epoch = 0
        self._m_dead = _om.counter(
            "replica_deaths_total",
            "replica worker loops that died uncleanly")

    # ------------------------------------------------------------------
    def start(self):
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
        # retire the previous incarnation's threads: each incarnation
        # owns its stop event + epoch (closure args), so a straggler
        # that outlives the bounded join below — a sidecar stuck in a
        # slow/faulted heartbeat — is HARMLESS: its next stamp attempt
        # carries the old epoch and the store fences it out with a
        # typed StaleEpochError instead of resurrecting a ghost. The
        # join is hygiene, not correctness, so it must not block a
        # replacement behind a wedged old thread for long.
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        t = self._hb_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=1.0)
        # deterministic spawn failure for chaos plans: a raise rule at
        # serve.spawn (path = replica id, step = spawn ordinal) fails
        # this start/restart the way a full host or a bad image fails a
        # process spawn — the supervisor's backoff + breaker take over.
        # The ordinal advances even when the fault raises, so a
        # step-keyed rule fails only the attempt it names.
        spawn = self._spawns
        self._spawns += 1
        if self._spawn_fault:
            _faults.fire("serve.spawn", step=spawn,
                         path=self.replica_id)
        with self._lock:
            # fresh per-incarnation stop event: a straggler thread of
            # the old incarnation keeps ITS event (closure arg) and can
            # never be resurrected by this clear
            stop = self._stop = threading.Event()
            self._draining = False
            self._dead = False
            self._fenced = False
            self._death_reason = None
        if self.engine is None:
            self.engine = _build_engine(self._factory)
        if self.max_backlog is None:
            self.max_backlog = self.engine.max_batch * 4
        self._register()
        epoch = self.epoch
        self._thread = threading.Thread(
            target=self._run, args=(stop,), daemon=True,
            name=f"replica-{self.replica_id}")
        self._thread.start()
        if self.store is not None:
            # heartbeats ride a sidecar thread: a worker mid-compile
            # (seconds of kernel loads and graph captures) must not age out;
            # a DEAD worker stops the sidecar, so death still surfaces
            # as TTL expiry
            self._hb_thread = threading.Thread(
                target=self._hb_loop, args=(stop, epoch), daemon=True,
                name=f"replica-{self.replica_id}-hb")
            self._hb_thread.start()
        return self

    def _register(self):
        if self.store is not None:
            # registration carries a FRESH epoch from the store: the
            # supervisor's kill-and-replace and rolling_restart() both
            # come through here, so every replacement incarnation
            # fences out its predecessor by construction
            self.epoch = self.store.next_epoch(self.replica_id)
            self.store.register(self.replica_id, epoch=self.epoch)
            self._last_beat = time.monotonic()

    def _hb_loop(self, stop, epoch):
        gen = getattr(self.store, "restarts", None)
        seen_gen = gen() if gen is not None else 0
        while not stop.wait(self._hb_interval):
            if self._dead or not self.alive():
                return      # a crashed host never says goodbye
            # chaos hook: a hang/sleep rule at replica.heartbeat (path =
            # replica id, step = beat ordinal) freezes this sidecar so
            # the replica silently ages out of membership — the TTL
            # detection + circuit-breaker path, driven deterministically
            _faults.fire("replica.heartbeat", step=self._beats,
                         path=self.replica_id)
            self._beats += 1
            try:
                self.store.heartbeat(self.replica_id, epoch=epoch)
            except StaleEpochError:
                # fenced out: a replacement incarnation owns this name
                # now. If WE are still the current incarnation (an
                # external same-named replica replaced us), stop
                # serving; an old straggler sidecar just exits.
                if self.epoch == epoch:
                    self._fenced = True
                return
            except StoreUnavailableError:
                continue    # store outage, not OUR death: keep
                # beating — the client reconnects by itself and the
                # router's outage credit suppresses the age-out
            except OSError:
                pass
            if gen is not None and gen() != seen_gen:
                # the store came back from a RESTART: its leases and
                # epoch counters are gone, so re-register under a
                # FRESH epoch (the server's adopt-max fence heals at
                # it; _worker_poll mirrors the bump to the router).
                # Only the current incarnation may — a straggler
                # sidecar minting epochs would fence out its OWN
                # replacement.
                if self.epoch != epoch:
                    seen_gen = gen()    # straggler: nothing to mint
                else:
                    try:
                        epoch = self.epoch = \
                            self.store.next_epoch(self.replica_id)
                        self.store.register(self.replica_id,
                                            epoch=epoch)
                        seen_gen = gen()
                    except OSError:
                        pass    # still flapping: next beat retries

    # -- router-facing surface -----------------------------------------
    def alive(self):
        t = self._thread
        return (not self._dead) and t is not None and t.is_alive()

    def is_dead(self, registered):
        """Supervisor's death verdict given this sweep's membership
        observation: a dead worker thread, or a live thread whose stamp
        aged out (frozen heartbeats — as good as dead for routing)."""
        return (not self.alive()) or (not registered
                                      and not self._draining)

    def cancel_attempt(self, creq):
        """Cancel the engine-level attempt of a cluster request."""
        req = creq.request
        if req is not None and self.engine is not None:
            self.engine.cancel(req)

    def ready(self):
        return (self.alive() and not self._draining
                and not self._fenced
                and self.engine is not None and self.engine.is_ready())

    def load(self):
        """Load score from the engine's own admission gauges: live
        batch occupancy + backlog depth (normalized to max_batch) +
        KV-page utilization + pending prefill work. Lower is better.

        The prefill-backlog term (prompt tokens admitted but not yet
        chunk-prefilled, normalized to the engine's per-step
        ``chunk_budget``) makes a replica chewing through a long prompt
        look busier than its live count alone suggests — its decode
        budget is partly spoken for over the next
        ``backlog / chunk_budget`` steps.

        The advertised hot-prefix set (``prefix_keys``: hex chain keys
        of the engine's most recently used cached prefix pages, plus
        the ``page_size`` they were hashed at) piggybacks on this same
        gauge snapshot so the router's prefix-affinity scoring costs no
        extra rpc — a subprocess replica's poll reply carries it the
        same way."""
        e = self.engine
        with self._lock:
            backlog = len(self._backlog)
        if e is None:
            return {"score": float("inf"), "live": 0, "backlog": backlog,
                    "kv_util": 1.0, "prefill_backlog": 0}
        live = len(e._live)
        kv_util = 1.0 - e.alloc.free_pages / e.alloc.num_pages
        pb = e.prefill_backlog()
        score = (live + backlog) / max(1, e.max_batch) + kv_util \
            + pb / max(1, e.chunk_budget)
        out = {"score": score, "live": live, "backlog": backlog,
               "kv_util": kv_util, "prefill_backlog": pb}
        if e.prefix is not None:
            out["prefix_keys"] = e.prefix.hot_keys()
            out["page_size"] = e.page_size
        return out

    def submit(self, creq, epoch=None):
        """Queue a request for this replica's worker. Raises a typed
        :class:`AdmissionError` (with the engine's ``retry_after``
        estimate) when the replica is not accepting or its backlog is
        full — the router's cue to pick another replica. A submission
        stamped with an ``epoch`` other than this incarnation's is
        rejected with a typed :class:`StaleEpochError`: neither a
        stale router view nor a fenced-out old incarnation may accept
        work addressed to its successor."""
        if epoch is not None and int(epoch) != self.epoch:
            _m_stale().inc()
            raise StaleEpochError(self.replica_id, int(epoch),
                                  self.epoch)
        e = self.engine
        with self._lock:
            if self._dead or self._draining or e is None:
                raise AdmissionError(
                    f"replica {self.replica_id} not accepting "
                    f"({'dead' if self._dead else 'draining'})",
                    live=0 if e is None else len(e._live),
                    max_batch=0 if e is None else e.max_batch,
                    free_pages=0 if e is None else e.alloc.free_pages,
                    num_pages=0 if e is None else e.alloc.num_pages,
                    retries=0)
            if len(self._backlog) >= self.max_backlog:
                raise AdmissionError(
                    f"replica {self.replica_id} backlog full",
                    live=len(e._live), max_batch=e.max_batch,
                    free_pages=e.alloc.free_pages,
                    num_pages=e.alloc.num_pages, retries=0,
                    retry_after=e._retry_after())
            self._backlog.append(creq)

    # -- worker loop ----------------------------------------------------
    def _run(self, stop):
        try:
            while not stop.is_set():
                # deterministic kill switch for CI plans: a rule at
                # replica.dead (action raise/hang) takes this worker
                # down as a crash, not a drain
                _faults.fire("replica.dead", step=self._ticks,
                             path=self.replica_id)
                self._ticks += 1
                self._admit_from_backlog()
                served = 0
                e = self.engine
                if e is not None \
                        and any(not r.done for r in e._live.values()):
                    served = e.decode_many(self.burst) if self.burst \
                        else e.step()
                self._reap_completed()
                with self._lock:
                    idle = not served and not self._backlog
                if idle:
                    time.sleep(self.idle_sleep)
        except BaseException as exc:     # noqa: BLE001 — death IS the event
            with self._lock:
                self._dead = True
                self._death_reason = exc
            self._m_dead.inc()
            # no deregister: a crashed host never says goodbye — the
            # membership TTL is what detects it

    def _admit_from_backlog(self):
        e = self.engine
        admitted = []
        while True:
            with self._lock:
                if (self._draining or not self._backlog
                        or len(e._live) >= e.max_batch):
                    break
                creq = self._backlog.popleft()
                self._pending_admit.append(creq)
            # removal from _pending_admit happens ONLY on the normal
            # paths below: a crash anywhere in between leaves the
            # request discoverable by take_unfinished()
            if creq.done:
                self._unpend(creq)
                continue
            req = creq._new_attempt(self.replica_id)
            if req is None:
                self._unpend(creq)
                continue        # finished typed (cluster deadline)
            # thread the request's trace context onto the worker
            # thread: the admit span chains to the submitter's span
            # tree, and the engine request carries the context so the
            # first-token emit can tag itself too
            req._trace = creq._trace
            try:
                if creq._trace is not None:
                    with _tracing.activate(creq._trace), \
                            _span("serving.admit",
                                  replica=self.replica_id,
                                  prompt_len=len(creq.prompt_ids)):
                        e._admit(req)
                else:
                    e._admit(req)
            except AdmissionError:
                with self._lock:
                    self._backlog.appendleft(creq)
                    self._pending_admit.remove(creq)
                break
            except ValueError as exc:
                # never-fitting prompt: typed terminal, not a retry
                creq._fail("evicted", exc)
                self._unpend(creq)
                continue
            with self._lock:
                self._tracked[req] = creq
                self._pending_admit.remove(creq)
            admitted.append(req)
        # no explicit prefill here: admitted prompts chunk-prefill
        # inside the worker tick's very next mixed dispatch
        # (engine.step()/decode_many), interleaved with live decodes
        return admitted

    def _unpend(self, creq):
        with self._lock:
            if creq in self._pending_admit:
                self._pending_admit.remove(creq)

    def _reap_completed(self):
        with self._lock:
            finished = [(r, c) for r, c in self._tracked.items()
                        if r.done]
            for r, _ in finished:
                del self._tracked[r]
        for r, c in finished:
            c._finish_from(r)

    # -- lifecycle ------------------------------------------------------
    def begin_drain(self):
        """Stop accepting routes; the worker finishes what's admitted."""
        with self._lock:
            self._draining = True

    def take_backlog(self):
        """Pull every queued-but-unadmitted request (the router
        re-routes them before a drain or after a death)."""
        with self._lock:
            out = list(self._backlog)
            self._backlog.clear()
        return out

    def take_unfinished(self):
        """Backlog + mid-admission + tracked in-flight requests that
        are not terminal — the failover set after this replica died."""
        with self._lock:
            out = [c for c in self._backlog if not c.done]
            self._backlog.clear()
            out += [c for c in self._pending_admit if not c.done]
            self._pending_admit.clear()
            out += [c for r, c in self._tracked.items() if not c.done]
            self._tracked.clear()
        return out

    def stop_worker(self, timeout=10.0):
        """Ask the worker loop to exit and join it — the heartbeat
        sidecar too, so a stopped incarnation can never keep stamping
        membership (the ghost a later restart would resurrect). The
        engine itself stays usable — rolling restart drains it next."""
        self._stop.set()
        for t in (self._thread, self._hb_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout)

    def drain(self, grace=30.0):
        """Drain the engine (worker must be stopped first so only one
        thread drives dispatches), then reap terminal requests."""
        stats = self.engine.drain(grace) if self.engine is not None \
            else {"seconds": 0.0, "completed": 0, "expired": 0}
        self._reap_completed()
        return stats

    def restart(self):
        """Replace the engine via the factory and rejoin the cluster —
        the second half of a rolling restart (or a kill-and-replace).
        Unfinished requests are NOT carried over; the caller fails
        them over first."""
        # a killed incarnation's worker may still be inside a dispatch
        # (the death handler's join is short): wait for it, or the old
        # engine closes under it and start() finds its thread alive,
        # keeps the dead flag and returns, so the supervisor counts a
        # second death and a second replacement (ROADMAP C13). A worker
        # still running after the wait fails this attempt, which the
        # supervisor backs off and retries.
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(_RESTART_JOIN_S)
            if t.is_alive():
                raise RuntimeError(
                    f"replica {self.replica_id}: the previous worker is "
                    f"still running {_RESTART_JOIN_S} s after its stop")
        old = self.engine
        if old is not None:
            try:
                old.close()
            except Exception:
                pass
        self.engine = _build_engine(self._factory)
        with self._lock:
            self._tracked.clear()
            self._backlog.clear()
            self._pending_admit.clear()
        return self.start()

    def kill(self):
        """Simulate a SIGKILL: stop the worker abruptly, no drain, no
        deregistration — detected only by membership TTL expiry (or
        the monitor noticing the dead thread)."""
        with self._lock:
            self._dead = True
            self._death_reason = RuntimeError("killed")
        self._m_dead.inc()
        self._stop.set()

    def stop(self, timeout=10.0):
        """Clean shutdown: stop the worker and leave membership."""
        self.stop_worker(timeout)
        if self.store is not None:
            try:
                self.store.deregister(self.replica_id)
            except OSError:
                pass
        if self.engine is not None:
            self.engine.close()


class SubprocessReplica:
    """One serving replica in its OWN process — the crash-containment
    unit. A segfault, OOM, or wedged dispatch inside the worker
    kills that process and nothing else; the supervisor sees the exit
    code (or the heartbeat stamp aging out) and replaces it, warm via
    its built kernels and the shape registry.

    The process runs :func:`paddle_tpu_torch.inference.replica_worker
    .replica_main`: it builds its engine from a JSON ``spec``,
    registers in the shared :class:`FileStore` with TTL heartbeats once
    the engine is ready (pre-warm included — registration IS the
    readiness signal), and serves requests over the
    :class:`~paddle_tpu_torch.distributed.rpc.RpcEndpoint` transport. On this
    side, a poller thread mirrors request state back into the router's
    :class:`ClusterRequest` handles and keeps the last-seen load/ready
    snapshot for routing — no rpc on the routing hot path.

    Fault points: ``serve.spawn`` fires before each process spawn
    (path = replica id, step = spawn ordinal) so a chaos plan can fail
    spawns deterministically and drive the supervisor's circuit
    breaker.
    """

    def __init__(self, replica_id, spec, endpoint, store, store_path,
                 ttl=None, max_backlog=None, burst=None,
                 spawn_grace=180.0, poll_interval=0.05,
                 submit_timeout=15.0, env=None, on_orphan=None,
                 prewarm=True, log_dir=None, store_addr=None):
        self.replica_id = str(replica_id)
        self.spec = spec
        self.endpoint = endpoint
        self.store = store
        self.store_path = store_path
        self.store_addr = store_addr
        self.ttl = ttl
        self.max_backlog = max_backlog
        self.burst = burst
        self.spawn_grace = float(spawn_grace)
        self.poll_interval = float(poll_interval)
        self.submit_timeout = float(submit_timeout)
        self.on_orphan = on_orphan
        self.log_dir = log_dir
        self._prewarm = prewarm
        self._extra_env = dict(env or {})
        self.engine = None            # interface parity: never local
        self._proc = None
        self._log_file = None
        self._tracked: dict[str, ClusterRequest] = {}
        self._ids: dict[ClusterRequest, str] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._poller = None
        self._load = None             # last load dict seen by the poller
        self._remote_ready = False
        self._registered_seen = False
        #: the worker's membership epoch, mirrored from its poll reply;
        #: stamped onto submissions so a fenced-out old incarnation
        #: sharing the rpc mailbox name can never accept them
        self.epoch = None
        self._spawn_t = None
        self._draining = False
        self._dead = False
        self.exit_code = None
        self.restart_ttft = None      # worker-reported restart -> token
        self.cache_stats = None       # worker-reported compile cache
        self._spawns = 0
        self._m_dead = _om.counter(
            "replica_deaths_total",
            "replica worker loops that died uncleanly")

    # ------------------------------------------------------------------
    def start(self):
        import subprocess
        import sys

        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                return self
        self._retire_poller()
        # the chaos hook a crash-loop plan drives: raising here IS the
        # failed spawn (bad image, full host); the supervisor backs
        # off. The ordinal advances even when the fault raises, so a
        # step-keyed rule fails exactly the attempt it names and the
        # supervisor's NEXT retry can succeed (the recovery path).
        spawn = self._spawns
        self._spawns += 1
        _faults.fire("serve.spawn", step=spawn, path=self.replica_id)
        env = dict(os.environ)
        env.update(self._extra_env)
        # the worker must import THIS package, wherever the router
        # imported it from (repo checkout, wheel, editable install) —
        # python -m resolves via PYTHONPATH, not the router's sys.path
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        env["PADDLE_TPU_REPLICA_ID"] = self.replica_id
        if self.store_addr is not None:
            # TCP-only control plane: the worker joins membership AND
            # its rpc mailbox through the lease server — no shared
            # filesystem path travels to it at all
            env["PADDLE_TPU_REPLICA_STORE_ADDR"] = str(self.store_addr)
            env.pop("PADDLE_TPU_REPLICA_STORE", None)
        else:
            env["PADDLE_TPU_REPLICA_STORE"] = str(self.store_path)
        env["PADDLE_TPU_REPLICA_RPC"] = \
            f"{self.endpoint.host}:{self.endpoint.port}"
        env["PADDLE_TPU_REPLICA_SPEC"] = json.dumps(self.spec)
        env["PADDLE_TPU_REPLICA_T0"] = repr(time.time())
        if self.ttl is not None:
            env["PADDLE_TPU_REPLICA_TTL"] = repr(float(self.ttl))
        if self.max_backlog is not None:
            env["PADDLE_TPU_REPLICA_BACKLOG"] = str(self.max_backlog)
        if self.burst is not None:
            env["PADDLE_TPU_REPLICA_BURST"] = str(self.burst)
        # prewarm on by default in workers: a replacement's first
        # request must hit compiled programs, not the compile bill
        env.setdefault("PADDLE_TPU_SERVING_PREWARM",
                       "1" if self._prewarm else "0")
        if self.log_dir is not None:
            # the worker flushes trace shards + flight-recorder
            # postmortems under the shared log dir
            env["PADDLE_TPU_REPLICA_LOG_DIR"] = str(self.log_dir)
        out = subprocess.DEVNULL
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._log_file = open(os.path.join(
                self.log_dir,
                f"{self.replica_id}.{self._spawns - 1}.log"), "w")
            out = self._log_file
        with self._lock:
            self._dead = False
            self._draining = False
            self.exit_code = None
            self._remote_ready = False
            self._registered_seen = False
            self._stop = threading.Event()   # fresh: old poller owns its own
            self._spawn_t = time.monotonic()
            self._proc = subprocess.Popen(
                [sys.executable, "-m",
                 "paddle_tpu_torch.inference.replica_worker"],
                env=env, stdout=out, stderr=subprocess.STDOUT)
        self._poller = threading.Thread(
            target=self._poll_loop,
            args=(self._stop, self._proc), daemon=True,
            name=f"replica-{self.replica_id}-poll")
        self._poller.start()
        return self

    def _retire_poller(self):
        self._stop.set()
        t = self._poller
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        if self._log_file is not None:
            try:
                self._log_file.close()
            except OSError:
                pass
            self._log_file = None

    # -- the result pump ------------------------------------------------
    def _poll_loop(self, stop, proc):
        from . import replica_worker as _rw

        misses: dict[str, int] = {}
        interval = self.poll_interval
        while not stop.wait(interval):
            if proc.poll() is not None:
                with self._lock:
                    if not self._dead:
                        self._dead = True
                        self._m_dead.inc()
                    self.exit_code = proc.returncode
                return
            with self._lock:
                ids = list(self._tracked)
            # idle polls only refresh load/readiness — ease off so the
            # router is not churning a connection per 50 ms per replica
            # (each call opens a fresh store connection + waiter
            # thread); with requests in flight, poll at full rate
            interval = self.poll_interval if ids \
                else max(self.poll_interval, 0.25)
            try:
                rsp = self.endpoint.call_sync(
                    self.replica_id, _rw._worker_poll, (ids,),
                    timeout=2.0, retries=1)
            except Exception:
                continue    # starting or wedged: proc + TTL judge that
            self._remote_ready = bool(rsp.get("ready"))
            if rsp.get("epoch") is not None:
                self.epoch = rsp["epoch"]
            # NOTE: rpc reachability is NOT membership — the worker's
            # dispatcher is up before it registers, and latching
            # _registered_seen here would turn "still starting" into
            # "silently aged out" at the next sweep (a spurious death
            # per warm restart, phantom breaker counts). Only the
            # supervisor's own membership observation (is_dead) sets it.
            self._load = rsp.get("load")
            if rsp.get("restart_ttft") is not None:
                self.restart_ttft = rsp["restart_ttft"]
            if rsp.get("cache") is not None:
                self.cache_stats = rsp["cache"]
            for req_id, state in (rsp.get("requests") or {}).items():
                with self._lock:
                    creq = self._tracked.get(req_id)
                if creq is None:
                    continue
                if state is None:
                    # the worker does not know this request (reply to
                    # its submit was lost, or a restart raced us):
                    # after a few confirmations, orphan it back to the
                    # router for failover — never strand the handle
                    misses[req_id] = misses.get(req_id, 0) + 1
                    if misses[req_id] >= 3:
                        misses.pop(req_id, None)
                        self._untrack(creq)
                        if self.on_orphan is not None:
                            self.on_orphan(creq, self.replica_id)
                    continue
                misses.pop(req_id, None)
                if state.get("done"):
                    self._untrack(creq)
                    creq._finish_remote(state.get("status"),
                                        state.get("output_ids"),
                                        state.get("error"))
                else:
                    # live request: mirror the partial output so a
                    # streaming frontend can push tokens while the
                    # request is still decoding on the worker
                    creq._mirror_partial(state.get("output_ids"))

    def _untrack(self, creq):
        with self._lock:
            req_id = self._ids.pop(creq, None)
            if req_id is not None:
                self._tracked.pop(req_id, None)

    # -- router-facing surface -----------------------------------------
    def alive(self):
        p = self._proc
        return (not self._dead) and p is not None and p.poll() is None

    def is_dead(self, registered):
        """Death verdict: exited process (any exit code), a registered
        replica whose stamp aged out (frozen heartbeats / SIGKILL), or
        a spawn that never reached membership within ``spawn_grace``
        (wedged startup)."""
        p = self._proc
        if p is None or self._dead or p.poll() is not None:
            return True
        if registered:
            self._registered_seen = True
            return False
        if self._draining:
            return False
        if self._registered_seen:
            return True         # was in membership, silently aged out
        return (time.monotonic() - self._spawn_t) > self.spawn_grace

    def ready(self):
        return self.alive() and not self._draining and self._remote_ready

    def load(self):
        l = self._load
        if not self.alive() or l is None:
            return {"score": float("inf"), "live": 0, "backlog": 0,
                    "kv_util": 1.0, "prefill_backlog": 0}
        return l

    def submit(self, creq):
        from . import replica_worker as _rw

        with self._lock:
            if self._dead or self._draining or not self._remote_ready:
                state = "dead" if self._dead else \
                    "draining" if self._draining else "starting"
                raise AdmissionError(
                    f"replica {self.replica_id} not accepting ({state})",
                    live=0, max_batch=0, free_pages=0, num_pages=0,
                    retries=0)
        spec = creq._attempt_spec(self.replica_id)
        if spec is None:
            return          # finished typed (cluster deadline) already
        # fence the submission with the epoch this router observed: if
        # the call lands in a partitioned OLD incarnation's dispatcher
        # (both incarnations share the name-keyed mailbox), that
        # incarnation rejects it typed instead of serving as a ghost
        spec["epoch"] = self.epoch
        try:
            req_id = self.endpoint.call_sync(
                self.replica_id, _rw._worker_submit, (spec,),
                timeout=self.submit_timeout)
        except AdmissionError:
            raise           # typed backpressure, fields intact (pickled)
        except StaleEpochError as e:
            # OUR view of the epoch is stale (the worker restarted
            # under a newer one): not accepting right now — the poller
            # refreshes the epoch and the router retries a peer
            raise AdmissionError(
                f"replica {self.replica_id} rejected a stale-epoch "
                f"submission ({e})", live=0, max_batch=0, free_pages=0,
                num_pages=0, retries=0) from e
        except Exception as e:
            # transport failure == not accepting: the router's cue to
            # try a peer; liveness is the supervisor's job, not submit's
            raise AdmissionError(
                f"replica {self.replica_id} unreachable "
                f"({type(e).__name__})", live=0, max_batch=0,
                free_pages=0, num_pages=0, retries=0) from e
        with self._lock:
            self._tracked[req_id] = creq
            self._ids[creq] = req_id

    def cancel_attempt(self, creq):
        from . import replica_worker as _rw

        with self._lock:
            req_id = self._ids.get(creq)
        if req_id is None:
            return
        try:
            self.endpoint.call_sync(self.replica_id, _rw._worker_cancel,
                                    (req_id,), timeout=5.0, retries=1)
        except Exception:
            pass            # dead replica: the monitor reaps it anyway

    # -- lifecycle ------------------------------------------------------
    def begin_drain(self):
        from . import replica_worker as _rw

        with self._lock:
            self._draining = True
        try:
            self.endpoint.call_sync(self.replica_id,
                                    _rw._worker_begin_drain, (),
                                    timeout=5.0, retries=1)
        except Exception:
            pass

    def take_backlog(self):
        """Pull queued-but-unadmitted requests back from the worker (the
        router re-routes them before a drain)."""
        from . import replica_worker as _rw

        try:
            ids = self.endpoint.call_sync(
                self.replica_id, _rw._worker_take_backlog, (),
                timeout=5.0, retries=1)
        except Exception:
            return []
        out = []
        with self._lock:
            for req_id in ids:
                creq = self._tracked.pop(req_id, None)
                if creq is not None:
                    self._ids.pop(creq, None)
                    if not creq.done:
                        out.append(creq)
        return out

    def take_unfinished(self):
        """Every tracked non-terminal request — the failover set after
        this replica's process died."""
        with self._lock:
            out = [c for c in self._tracked.values() if not c.done]
            self._tracked.clear()
            self._ids.clear()
        return out

    def stop_worker(self, timeout=10.0):
        """In-process replicas stop their worker thread here; for a
        subprocess the worker loop is stopped by :meth:`drain` inside
        the worker itself. A DEAD process is reaped and its poller
        retired."""
        if not self.alive():
            self._retire_poller()

    def drain(self, grace=30.0):
        from . import replica_worker as _rw

        try:
            # retries=0: the per-attempt budget already covers a full
            # worker-side drain (grace + slack), so a timeout means a
            # dead/partitioned worker — retrying would stall a rolling
            # restart by another grace+30 for a benign fallback (the
            # reap + failover paths own the requests either way)
            stats = self.endpoint.call_sync(
                self.replica_id, _rw._worker_drain, (grace,),
                timeout=grace + 30.0, retries=0)
        except Exception:
            stats = {"seconds": 0.0, "completed": 0, "expired": 0}
        # mirror the drained requests' terminal states NOW (the
        # in-process drain ends with a synchronous _reap_completed):
        # a restart right after this would kill the worker — and with
        # it the results — before the 50ms poller's next pass
        self._reap_tracked()
        return stats

    def _reap_tracked(self):
        """One synchronous poll that adopts every tracked request's
        terminal state — the subprocess analog of
        :meth:`EngineReplica._reap_completed`."""
        from . import replica_worker as _rw

        with self._lock:
            ids = list(self._tracked)
        if not ids:
            return
        try:
            rsp = self.endpoint.call_sync(
                self.replica_id, _rw._worker_poll, (ids,), timeout=10.0,
                retries=1)
        except Exception:
            return          # dead/unreachable: failover owns these
        for req_id, state in (rsp.get("requests") or {}).items():
            with self._lock:
                creq = self._tracked.get(req_id)
            if creq is None or state is None or not state.get("done"):
                continue
            self._untrack(creq)
            creq._finish_remote(state.get("status"),
                                state.get("output_ids"),
                                state.get("error"))

    def restart(self):
        """Replace the process: clean-exit the old one if it is still
        up, then spawn fresh. Requests whose terminal state was never
        mirrored back (and are not yet done) are handed to
        ``on_orphan`` for failover — a restart must never strand a
        handle in limbo."""
        self._request_exit(timeout=5.0)
        self._retire_poller()
        with self._lock:
            leftovers = [c for c in self._tracked.values()
                         if not c.done]
            self._tracked.clear()
            self._ids.clear()
        for creq in leftovers:
            if self.on_orphan is not None:
                self.on_orphan(creq, self.replica_id)
        return self.start()

    def _request_exit(self, timeout=5.0):
        from . import replica_worker as _rw

        p = self._proc
        if p is None:
            return
        if p.poll() is None:
            for _ in range(2):      # a lost first ask is retried once
                try:
                    # retries=0: this loop IS the retry policy — the
                    # rpc layer doubling it would block stop() for up
                    # to 6 attempts against an already-exiting worker
                    self.endpoint.call_sync(self.replica_id,
                                            _rw._worker_exit, (),
                                            timeout=timeout, retries=0)
                    break
                except Exception:
                    continue
            try:
                p.wait(timeout=timeout)
            except Exception:
                p.terminate()
                try:
                    p.wait(timeout=timeout)
                except Exception:
                    p.kill()
                    p.wait()
        self.exit_code = p.returncode

    def kill(self):
        """SIGKILL the worker process: no drain, no deregistration —
        membership TTL (or the exit code) is what detects it."""
        with self._lock:
            self._dead = True
        self._m_dead.inc()
        p = self._proc
        if p is not None and p.poll() is None:
            p.kill()

    def stop(self, timeout=10.0):
        """Clean shutdown: the worker drains nothing but deregisters
        from membership and exits 0."""
        self._request_exit(timeout=timeout)
        self._retire_poller()


class _RestartState:
    """Supervisor bookkeeping for ONE replica id: when it died, whether
    its death has been processed, when the next (backed-off) restart is
    due, and whether the crash-loop breaker holds it out."""

    __slots__ = ("deaths", "down", "restart_at", "quarantined",
                 "postmortem")

    def __init__(self):
        self.deaths = collections.deque(maxlen=64)  # monotonic stamps
        self.down = False
        self.restart_at = None
        self.quarantined = False
        self.postmortem = None      # newest harvested postmortem dir


class ServingCluster:
    """Routing frontend + supervisor over N replicas.

    Replicas are in-process :class:`EngineReplica` threads (tests,
    single-tenant embedding) or — with ``engine_spec`` — real
    :class:`SubprocessReplica` processes: crash containment, exit-code
    liveness, and warm restart via the persistent compile cache.

    The supervisor (the monitor thread's sweep) restarts dead replicas
    with exponential backoff + jitter, bounded by a crash-loop circuit
    breaker: ``breaker_threshold`` deaths inside ``breaker_window``
    seconds quarantine the replica (``cluster_replica_quarantined_
    total``) — capacity shrinks and the tier sheds with typed
    backpressure instead of burning a restart storm. A dead replica's
    membership stamp is swept immediately so membership never shows a
    ghost, and its unfinished requests fail over to its peers.

    Args:
        engine_factory: zero-arg callable building a fresh
            :class:`LlamaServingEngine` (in-process replicas; ignored
            when ``engine_spec`` is given).
        num_replicas: replica count at start().
        store_path: membership directory (a shared filesystem in a
            real deployment); default: a private temp dir.
        store_addr: ``"host:port"`` of a
            :class:`~paddle_tpu_torch.distributed.net_store
            .LeaseStoreServer` — switches the WHOLE control plane
            (membership + rpc mailboxes) to TCP, no shared filesystem
            anywhere; overrides ``store_path``.
        ttl: membership TTL in seconds — a replica whose heartbeat is
            older ages out and is treated as dead.
        monitor_interval: seconds between membership sweeps.
        store_outage_grace: seconds of store unreachability after
            which NEW admissions are rejected typed (``retry_after``).
            In-flight requests always run to completion from the
            last-known-membership cache, and store silence alone never
            fails a replica over.
        auto_replace: rebuild dead replicas automatically
            (kill-and-replace).
        failover_budget: default per-request failover budget.
        engine_spec: JSON-able spec for subprocess replicas (see
            :mod:`paddle_tpu_torch.inference.replica_worker`); switches the
            cluster to process-isolated mode.
        restart_backoff / restart_backoff_max / restart_jitter:
            supervisor restart delay: ``min(max, backoff * 2**(deaths
            in window - 1)) * (1 + jitter*rand)``.
        breaker_threshold / breaker_window: crash-loop circuit breaker
            (N deaths in window seconds -> quarantine).
        spawn_grace: seconds a subprocess may spend starting (imports +
            compiles) before a missing membership stamp means "wedged".
        subprocess_env: extra environment for worker processes (e.g.
            ``PADDLE_TPU_COMPILE_CACHE_DIR`` so replicas share a warm
            cache).
        log_dir: per-worker stdout/stderr log files (default: discard).
    """

    def __init__(self, engine_factory=None, num_replicas=2,
                 store_path=None, store_addr=None, ttl=2.0,
                 monitor_interval=0.05, store_outage_grace=5.0,
                 auto_replace=True, failover_budget=3, max_backlog=None,
                 burst=None, engine_spec=None, subprocess_env=None,
                 restart_backoff=0.1, restart_backoff_max=30.0,
                 restart_jitter=0.25, breaker_threshold=5,
                 breaker_window=30.0, spawn_grace=180.0,
                 submit_timeout=15.0, log_dir=None, prewarm=True,
                 affinity_weight=1.0, slo_interval=5.0, slos=None):
        if engine_factory is None and engine_spec is None:
            raise ValueError(
                "ServingCluster needs engine_factory (in-process "
                "replicas) or engine_spec (subprocess replicas)")
        self._factory = engine_factory
        self._spec = engine_spec
        self.num_replicas = int(num_replicas)
        self.ttl = ttl
        if store_addr is not None:
            # TCP-only control plane: membership AND the rpc mailboxes
            # ride one LeaseStoreServer at store_addr — no shared
            # filesystem anywhere (replicas may span hosts)
            self.store_addr = str(store_addr)
            self._store_path = None
            self.store = LeaseStore(store_addr, ttl=ttl)
        else:
            self.store_addr = None
            self._store_path = store_path \
                or tempfile.mkdtemp(prefix="paddle_tpu_cluster_")
            self.store = FileStore(self._store_path, ttl=ttl)
        # store-outage degradation (see _live_hosts/submit): routing
        # serves from the last-known-membership cache for the whole
        # outage, but NEW admissions are rejected typed (retry_after)
        # once the outage exceeds this grace window
        self.store_outage_grace = float(store_outage_grace)
        self._member_cache: set = set()
        self._member_cache_t = None
        self._outage_since = None
        self._lenient_until = 0.0
        self._store_gen = 0
        self._m_cache_age = _om.gauge(
            "cluster_membership_cache_age_seconds",
            "age of the membership view routing decisions are based "
            "on (0 while the store is reachable)")
        self.monitor_interval = float(monitor_interval)
        self.auto_replace = auto_replace
        self.failover_budget = int(failover_budget)
        self.max_backlog = max_backlog
        self.burst = burst
        self.subprocess_env = dict(subprocess_env or {})
        self.restart_backoff = float(restart_backoff)
        self.restart_backoff_max = float(restart_backoff_max)
        self.restart_jitter = float(restart_jitter)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_window = float(breaker_window)
        self.spawn_grace = float(spawn_grace)
        self.submit_timeout = float(submit_timeout)
        self.log_dir = log_dir
        self.prewarm = prewarm
        # prefix-affinity routing: a full chain-hash
        # overlap between a prompt's page-aligned prefix and a
        # replica's advertised hot-prefix set discounts that replica's
        # load score by this much — enough to beat modest load deltas,
        # never enough to pile every request on one replica (a full
        # batch of load outweighs it). 0 disables (load-only routing).
        self.affinity_weight = float(affinity_weight)
        self._endpoint = None
        self._replicas: dict[str, object] = {}
        self._restarts: dict[str, _RestartState] = {}
        self._maintenance: set[str] = set()   # ids mid-rolling-restart
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._monitor_thread = None
        self._elastic = None
        self._m = _router_metrics()
        self._route_count = 0
        self._started = False
        # SLO burn-rate engine: fed cluster-aggregated TTFT/TPOT
        # histograms by the sweep every ``slo_interval`` seconds;
        # surfaces on membership_info() and the
        # serving_slo_burn_rate{slo,window} gauge
        self.slo_interval = float(slo_interval)
        self.slo = _slo.SloEngine(slos=slos)
        self._slo_last = 0.0
        self._slo_burn = {}

    # ------------------------------------------------------------------
    def _make_replica(self, rid):
        if self._spec is not None:
            return SubprocessReplica(
                rid, self._spec, self._endpoint, self.store,
                self._store_path, ttl=self.ttl,
                max_backlog=self.max_backlog, burst=self.burst,
                spawn_grace=self.spawn_grace,
                submit_timeout=self.submit_timeout,
                env=self.subprocess_env, on_orphan=self._orphaned,
                prewarm=self.prewarm, log_dir=self.log_dir,
                store_addr=self.store_addr)
        return EngineReplica(rid, self._factory, store=self.store,
                             ttl=self.ttl, max_backlog=self.max_backlog,
                             burst=self.burst)

    def _restart_state(self, rid):
        with self._lock:
            st = self._restarts.get(rid)
            if st is None:
                st = self._restarts[rid] = _RestartState()
            return st

    def start(self):
        with self._lock:
            if self._started:
                return self
            self._started = True
        if self._spec is not None and self._endpoint is None:
            from ..distributed.rpc import RpcEndpoint

            if self.store_addr is not None:
                # TCP-only mode: the router mailbox rides the SAME
                # lease server as membership (its own session), so a
                # store restart is the only control-plane failure
                # domain and the mailboxes resync through it
                self._endpoint = RpcEndpoint(
                    "router", store=self.store.clone())
            else:
                self._endpoint = RpcEndpoint("router", is_master=True,
                                             port=0)
        for i in range(self.num_replicas):
            rid = f"replica-{i}"
            rep = self._make_replica(rid)
            try:
                rep.start()
            except Exception:
                # a failed first spawn is a death like any other: the
                # same bookkeeping backs off, counts toward the
                # breaker, and quarantines — the cluster comes up on
                # the replicas that did start
                st = self._restart_state(rid)
                st.down = True
                self._record_death(rid, st)
            self._replicas[rid] = rep
        self._elastic = ElasticManager(self.store, "router",
                                       self.num_replicas)
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="cluster-monitor")
        self._monitor_thread.start()
        return self

    def _orphaned(self, creq, rid):
        """A subprocess replica forgot a tracked request (lost submit
        reply, mid-restart race): fail it over like a death would."""
        self._failover(creq, dead_rid=rid)

    def replicas(self):
        with self._lock:
            return dict(self._replicas)

    def ready(self):
        """Cluster readiness: at least one routable replica (wire to
        ``start_http_server(ready=cluster.ready)`` for ``/readyz``)."""
        return any(r.ready() for r in self.replicas().values())

    def membership_info(self):
        """Per-replica membership view for /healthz: current epoch,
        last-heartbeat age (fs-server clock), and liveness — what an
        operator reads to spot a fenced-out stale incarnation without
        grepping logs."""
        out = {}
        quarantined = self.quarantined()
        with self._lock:
            postmortems = {rid: st.postmortem
                           for rid, st in self._restarts.items()}
        for rid, rep in self.replicas().items():
            try:
                hb_age = self.store.heartbeat_age(rid)
            except OSError:
                hb_age = None   # store outage: age unknown, not 0
            out[rid] = {
                "epoch": getattr(rep, "epoch", None),
                "heartbeat_age_seconds": hb_age,
                "alive": rep.alive(),
                "ready": rep.ready(),
                "quarantined": rid in quarantined,
                "postmortem": postmortems.get(rid),
            }
        info = {"membership": out}
        if _om.enabled():
            info["slo_burn_rates"] = self._slo_tick()
        return info

    def start_http_server(self, port=0, addr="127.0.0.1"):
        """One-pane endpoint for the whole tier: ``/metrics`` and
        ``/metrics.json`` render the *merged* cluster scrape (every
        replica's registry under a ``replica`` label — see
        :meth:`scrape`), ``/healthz`` carries :meth:`membership_info`
        (epochs + heartbeat ages + SLO burn rates)."""
        from ..observability.export import start_http_server
        return start_http_server(port=port, addr=addr, ready=self.ready,
                                 health_info=self.membership_info,
                                 snapshot_fn=self.scrape,
                                 profile_fn=self.capture_profile)

    # -- one-pane observability ----------------------------------------
    def scrape(self):
        """Cluster-wide metrics snapshot: every subprocess replica's
        registry (pulled over the rpc path) plus this router process's
        own, merged under a ``replica`` label (``replica="router"`` for
        the local registry). In-process replicas share the router's
        registry, so they are already covered by the local snapshot.
        A replica whose scrape rpc fails is skipped (and counted on
        ``cluster_scrape_failures_total``) — one sick replica must not
        blank the pane."""
        sources = []
        if self._spec is not None and self._endpoint is not None:
            from . import replica_worker as _rw
            for rid, rep in self.replicas().items():
                if not rep.alive():
                    continue
                try:
                    rsp = self._endpoint.call_sync(
                        rid, _rw._worker_scrape, (),
                        timeout=2.0, retries=1)
                    sources.append((rid, rsp.get("snapshot") or []))
                except Exception:
                    self._m["scrape_failures"].labels(rid).inc()
        sources.append(("router", json_snapshot()))
        return merge_snapshots(sources)

    def _slo_tick(self, force=False):
        """Feed the SLO engine one cumulative TTFT/TPOT point from the
        cluster-aggregated scrape (rate-limited to ``slo_interval``)."""
        if not _om.enabled():
            return self._slo_burn
        now = time.monotonic()
        if not force and now - self._slo_last < self.slo_interval:
            return self._slo_burn
        self._slo_last = now
        agg = {e["name"]: e for e in aggregate_snapshot(self.scrape())}
        for spec in self.slo.slos:
            entry = agg.get(spec.metric)
            if entry is None or entry.get("type") != "histogram":
                continue
            buckets = counts = None
            for sample in entry.get("samples", ()):
                if buckets is None:
                    buckets = list(sample["buckets"])
                    counts = list(sample["counts"])
                elif list(sample["buckets"]) == buckets:
                    counts = [a + b for a, b
                              in zip(counts, sample["counts"])]
            if buckets is not None:
                self.slo.observe(spec.name, buckets, counts, now=now)
        self._slo_burn = self.slo.burn_rates(now=now)
        return self._slo_burn

    def collect_trace(self, path=None):
        """Harvest every worker's span shard from ``log_dir`` plus this
        process's own live span ring and merge them into ONE Perfetto-
        loadable chrome-trace document, shard timestamps shifted onto a
        common clock via each process's recorded monotonic<->epoch
        offset (see ``tracing.merge_shards``). ``path`` additionally
        writes the JSON there. Returns the merged document (``None``
        under ``PADDLE_TPU_METRICS=0``)."""
        if not _om.enabled():
            return None
        shards = []
        if self.log_dir is not None:
            shards.extend(_tracing.harvest_shards(self.log_dir))
        shards.append(_tracing.local_shard("router"))
        merged = _tracing.merge_shards(shards)
        if path is not None:
            with open(path, "w") as f:
                json.dump(merged, f)
        return merged

    def capture_profile(self, seconds=1.0, path=None):
        """Cluster-wide on-demand profiler capture: fan
        ``_worker_capture_profile`` out to every live subprocess
        replica over the rpc path — each runs a ``torch.profiler``
        window of ``seconds`` while it keeps serving — capture the
        router's own window concurrently, and merge all shards with
        the span-clock machinery into ONE Perfetto-loadable bundle
        (``/debug/profile?seconds=N`` on :meth:`start_http_server`
        serves exactly this). A replica whose capture rpc fails is
        skipped (counted on ``cluster_scrape_failures_total``) — one
        sick replica must not blank the capture. ``path`` additionally
        writes the JSON there. Returns the merged document (``None``
        under ``PADDLE_TPU_METRICS=0``)."""
        from ..observability import perf as _perf

        if not _om.enabled():
            return None
        seconds = min(max(float(seconds), 0.0), 30.0)
        shards = []
        shard_lock = threading.Lock()

        def _pull(rid):
            from . import replica_worker as _rw
            try:
                shard = self._endpoint.call_sync(
                    rid, _rw._worker_capture_profile, (seconds,),
                    timeout=seconds + 30.0, retries=0)
                with shard_lock:
                    shards.append(shard)
            except Exception:
                self._m["scrape_failures"].labels(rid).inc()

        pullers = []
        if self._spec is not None and self._endpoint is not None:
            for rid, rep in self.replicas().items():
                if not rep.alive():
                    continue
                t = threading.Thread(target=_pull, args=(rid,),
                                     name=f"profile-{rid}", daemon=True)
                t.start()
                pullers.append(t)
        # the router's own window runs concurrently with the fan-out
        shards.append(_perf.capture_local(seconds, worker_name="router"))
        for t in pullers:
            t.join(timeout=seconds + 35.0)
        merged = _tracing.merge_shards(shards)
        merged["capture"] = {
            "seconds": seconds,
            "workers": [s.get("worker") for s in shards],
            "pids": sorted({s.get("pid") for s in shards
                            if s.get("pid") is not None}),
            "profiler": {s.get("worker"): s.get("profiler")
                         for s in shards},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(merged, f)
        return merged

    def request_trace(self, trace_id):
        """One request's cross-process timeline: the parent-linked span
        tree for ``trace_id`` assembled from the merged cluster trace
        (what ``GET /v1/requests/<id>/trace`` serves)."""
        merged = self.collect_trace()
        if merged is None:
            return {"trace_id": trace_id, "spans": []}
        return {"trace_id": trace_id,
                "spans": _tracing.span_tree(merged["traceEvents"],
                                            trace_id)}

    # -- routing --------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=16, eos_token_id=None,
               deadline=None, token_budget=None, priority=0,
               retry_budget=1, failover_budget=None, sampling=None,
               stop=(), on_token=None):
        """Route one request to the least-loaded ready replica.
        Returns a :class:`ClusterRequest`; raises a typed
        :class:`AdmissionError` carrying the smallest ``retry_after``
        across replicas when the whole tier is at capacity.
        ``sampling``/``stop``/``on_token`` ride the request to the
        engine (see :class:`ClusterRequest`)."""
        outage = self._store_outage_age()
        if outage > self.store_outage_grace:
            # degraded mode: in-flight work keeps running off the
            # membership cache, but admitting NEW work against a view
            # this stale risks routing onto corpses — reject typed,
            # with a retry_after sized to one lease period
            self._m["backpressure"].inc()
            raise AdmissionError(
                f"control-plane store {getattr(self, 'store_addr', None)} "
                f"unreachable for {outage:.1f}s (grace "
                f"{self.store_outage_grace:.1f}s): new admissions "
                "rejected until it reconnects",
                live=0, max_batch=0, free_pages=0, num_pages=0,
                retries=0,
                retry_after=min(5.0, max(0.5, float(self.ttl or 1.0))))
        creq = ClusterRequest(
            prompt_ids, max_new_tokens, eos_token_id, deadline,
            token_budget, priority, retry_budget,
            self.failover_budget if failover_budget is None
            else failover_budget, sampling=sampling, stop=stop,
            on_token=on_token)
        creq._t_submit = time.perf_counter()
        self._route(creq)
        return creq

    def _live_hosts(self):
        """Membership scan that tolerates store outages. A successful
        scan refreshes the last-known-membership cache; an unreachable
        store serves the cache instead, age-stamped on the
        ``cluster_membership_cache_age_seconds`` gauge — a store
        outage is NOT a replica death, so routing and the sweep keep
        working from the cached view (process death via ``alive()``
        still surfaces). On reconnect, a lenient window of
        ttl + outage credit unions the cache into the live set while
        replicas re-register their leases against the (possibly
        restarted) server."""
        now = time.monotonic()
        gen = getattr(self.store, "restarts", None)
        try:
            hosts = set(self.store.hosts())
        except StoreUnavailableError:
            if self._outage_since is None:
                self._outage_since = now
            if self._member_cache_t is not None:
                self._m_cache_age.set(now - self._member_cache_t)
            return set(self._member_cache)
        # a server RESTART can be invisible to this thread's exception
        # bookkeeping (a short outage may be fully absorbed by other
        # threads' retry envelopes on the shared client) — but the
        # session's boot-nonce generation can't miss it
        cur_gen = gen() if gen is not None else 0
        restarted = cur_gen != getattr(self, "_store_gen", 0)
        self._store_gen = cur_gen
        if self._outage_since is not None or restarted:
            outage = 0.0 if self._outage_since is None \
                else now - self._outage_since
            self._outage_since = None
            # outage credit: cached heartbeats could not refresh while
            # the server was down, and a restarted server holds no
            # leases until replicas re-register — suppress age-out
            # verdicts for ttl + credit while membership reconverges
            credit = min(30.0, max(outage, 1.0 if restarted else 0.0))
            self._lenient_until = now + float(self.ttl or 0.0) + credit
        if now < self._lenient_until:
            hosts |= self._member_cache
        else:
            self._member_cache = set(hosts)
        self._member_cache_t = now
        self._m_cache_age.set(0.0)
        return hosts

    def _store_outage_age(self):
        # the store client stamps its outage at the FIRST unanswered
        # attempt — earlier (and so more honest for the admission
        # grace) than the sweep noticing a whole scan's retry
        # envelope failed
        age = getattr(self.store, "outage_age", None)
        if age is not None:
            return age()
        if self._outage_since is None:
            return 0.0
        return time.monotonic() - self._outage_since

    def _routable(self, exclude=()):
        live_hosts = self._live_hosts()
        with self._lock:
            reps = [r for rid, r in self._replicas.items()
                    if rid not in exclude
                    and rid not in self._maintenance
                    and r.ready() and rid in live_hosts]
        return reps

    def _route(self, creq, exclude=()):
        with self._lock:
            step = self._route_count
            self._route_count += 1
        # deterministic routing-error injection for CI plans
        _faults.fire("router.route", step=step)
        # score = load - affinity_weight * prefix overlap: replicas
        # whose advertised hot-prefix set chain-hashes over this
        # prompt's page-aligned prefix are preferred (their cache
        # already holds the K/V), falling back to pure load when no
        # replica advertises keys or nothing overlaps
        candidates = []
        key_cache: dict[int, set] = {}
        for rep in self._routable(exclude):
            l = rep.load()
            score = l.get("score", float("inf"))
            overlap = 0
            adv = l.get("prefix_keys")
            page = int(l.get("page_size") or 0)
            if adv and page > 0 and self.affinity_weight:
                keys = key_cache.get(page)
                if keys is None:
                    from .prefix_cache import chain_keys
                    keys = key_cache[page] = {
                        k.hex() for k in chain_keys(
                            creq.prompt_ids, page, limit=8)}
                if keys:
                    overlap = len(keys & set(adv))
                    score -= self.affinity_weight * overlap / len(keys)
            candidates.append((score, overlap, rep))
        candidates.sort(key=lambda t: t[0])
        retry_after = None
        stats = {"live": 0, "max_batch": 0, "free_pages": 0,
                 "num_pages": 0}
        for score, overlap, rep in candidates:
            try:
                with _span("cluster.route", replica=rep.replica_id):
                    rep.submit(creq)
            except AdmissionError as e:
                if e.retry_after is not None:
                    retry_after = e.retry_after if retry_after is None \
                        else min(retry_after, e.retry_after)
                for k in stats:
                    stats[k] += getattr(e, k, 0)
                continue
            creq.replica_id = rep.replica_id
            self._m["routed"].labels(rep.replica_id).inc()
            if overlap:
                self._m["affinity_hits"].inc()
            return rep

        self._m["backpressure"].inc()
        raise AdmissionError(
            f"no replica accepted the request "
            f"({len(candidates)} routable of {len(self._replicas)})",
            retries=0, retry_after=retry_after, **stats)

    def cancel(self, creq):
        """Cancel a cluster request: the handle turns terminal and the
        current attempt (if any) is cancelled on its replica — in
        process directly, over rpc for a subprocess replica."""
        req = creq.cancel()
        rep = self._replicas.get(creq.replica_id)
        if req is not None and rep is not None:
            rep.cancel_attempt(creq)

    # -- membership monitor --------------------------------------------
    def _monitor(self):
        while not self._stop.wait(self.monitor_interval):
            try:
                self._sweep()
            except Exception:
                # the monitor must survive transient store errors; the
                # next sweep retries
                pass

    def _claim(self, rid, rep=None):
        """Atomically claim a replica for exclusive maintenance (the
        monitor's death handling vs rolling_restart — whoever claims
        first proceeds; the other skips or waits). Returns False when
        already claimed, or when ``rep`` no longer IS the registered
        replica (a stale snapshot)."""
        with self._lock:
            if rid in self._maintenance:
                return False
            if rep is not None and self._replicas.get(rid) is not rep:
                return False
            self._maintenance.add(rid)
            return True

    def _release_claim(self, rid):
        with self._lock:
            self._maintenance.discard(rid)

    def _sweep(self):
        if self._elastic is not None:
            try:
                self._elastic.watch_once()  # live-host gauge + events
            except OSError:
                pass    # store outage: membership events pause
        live_hosts = self._live_hosts()
        now = time.monotonic()
        with self._lock:
            reps = [(rid, r) for rid, r in self._replicas.items()
                    if rid not in self._maintenance]
        ready = 0
        for rid, rep in reps:
            st = self._restart_state(rid)
            if st.quarantined:
                continue        # held out by the breaker; capacity down
            if st.down:
                # death already processed — restart when the backoff
                # delay is up (never block the sweep sleeping on it)
                if self.auto_replace and st.restart_at is not None \
                        and now >= st.restart_at \
                        and self._claim(rid, rep):
                    try:
                        self._try_restart(rid, rep, st)
                    finally:
                        self._release_claim(rid)
                continue
            if rep.is_dead(rid in live_hosts):
                # claim BEFORE touching the replica: rolling_restart
                # may have started on it since the snapshot (its
                # stop_worker looks like a death), and two rebuilders
                # racing one replica would tear its engine
                if not self._claim(rid, rep):
                    continue
                try:
                    self._handle_death(rid, rep, st)
                finally:
                    self._release_claim(rid)
            elif rep.ready():
                ready += 1
        self._m["ready"].set(ready)
        with self._lock:
            quarantined = sum(1 for s in self._restarts.values()
                              if s.quarantined)
        self._m["quarantined_now"].set(quarantined)
        self._slo_tick()

    def _backoff_delay(self, st, now):
        """Restart delay from the deaths inside the breaker window:
        exponential from ``restart_backoff``, capped, jittered so a
        correlated mass failure does not respawn in lockstep."""
        recent = sum(1 for t in st.deaths
                     if now - t <= self.breaker_window)
        delay = min(self.restart_backoff_max,
                    self.restart_backoff * (2 ** max(0, recent - 1)))
        return delay * (1.0 + self.restart_jitter * random.random())

    def _record_death(self, rid, st):
        """Append one death; trip the breaker when the window fills.
        Returns True when the replica is now quarantined."""
        now = time.monotonic()
        st.deaths.append(now)
        recent = sum(1 for t in st.deaths
                     if now - t <= self.breaker_window)
        if recent >= self.breaker_threshold:
            st.quarantined = True
            st.restart_at = None
            self._m["quarantined"].inc()
            return True
        if self.auto_replace:
            st.restart_at = now + self._backoff_delay(st, now)
        return False

    def _handle_death(self, rid, rep, st):
        """Fail over a dead replica's requests and schedule its
        (backed-off) rebuild. Caller holds the maintenance claim."""
        orphans = rep.take_unfinished()
        rep.stop_worker(timeout=1.0)
        # ghost sweep: a confirmed-dead replica leaves membership NOW —
        # the TTL detects silent death, it is not a grace period during
        # which routing peers may still see the ghost
        try:
            self.store.deregister(rid)
        except OSError:
            pass
        for creq in orphans:
            self._failover(creq, dead_rid=rid)
        self._harvest_postmortem(rid, rep, st)
        st.down = True
        self._record_death(rid, st)

    def _harvest_postmortem(self, rid, rep, st):
        """A subprocess worker's fatal handler dumps a flight-recorder
        bundle under ``<log_dir>/<rid>/postmortem/<run>``; record the
        newest one on the replica's restart state so an operator (or
        ``stats()``) finds it without grepping the log dir. Run names
        sort lexicographically ~= chronologically."""
        log_dir = getattr(rep, "log_dir", None)
        if log_dir is None:
            return
        pm_dir = os.path.join(str(log_dir), rid, "postmortem")
        try:
            bundles = sorted(os.listdir(pm_dir))
        except OSError:
            return
        if not bundles:
            return
        path = os.path.join(pm_dir, bundles[-1])
        if path == st.postmortem:
            return              # same bundle as the previous death
        st.postmortem = path
        logging.getLogger(__name__).warning(
            "replica %s died; postmortem bundle at %s", rid, path)

    def _try_restart(self, rid, rep, st):
        """One backed-off restart attempt. A failed spawn (serve.spawn
        fault, OS error) counts as another death — backoff grows, and
        the breaker quarantines a crash loop."""
        try:
            rep.restart()
        except Exception:
            self._record_death(rid, st)
            return
        st.down = False
        st.restart_at = None
        self._m["replaced"].inc()

    def quarantined(self):
        """Replica ids currently held out by the circuit breaker."""
        with self._lock:
            return {rid for rid, st in self._restarts.items()
                    if st.quarantined}

    def rehabilitate(self, rid):
        """Operator override: clear a quarantined replica's breaker
        state and schedule an immediate restart attempt."""
        st = self._restart_state(rid)
        with self._lock:
            st.quarantined = False
            st.deaths.clear()
            st.down = True
            st.restart_at = time.monotonic()

    def _failover(self, creq, dead_rid):
        if creq.done:
            return
        creq.failovers += 1
        if creq.failovers > creq.failover_budget:
            self._m["lost"].inc()
            creq._fail("evicted", ReplicaLostError(
                f"replica {dead_rid} died and the failover budget "
                f"({creq.failover_budget}) is exhausted",
                replica_id=dead_rid, failovers=creq.failovers))
            return
        self._m["failover"].inc()
        try:
            self._route(creq, exclude=(dead_rid,))
        except AdmissionError as e:
            # the tier is saturated right now — typed terminal rather
            # than a silent drop; callers see the backpressure reason
            self._m["lost"].inc()
            creq._fail("evicted", e)

    # -- rolling restart ------------------------------------------------
    def rolling_restart(self, grace=30.0):
        """Cycle every replica through drain -> replace, one at a time,
        with the router live the whole way: a draining replica takes no
        new routes, its backlog re-routes to its peers, its in-flight
        requests finish (or expire typed) inside ``grace``, then a
        fresh engine rejoins membership before the next replica starts.
        Returns per-replica drain stats."""
        results = {}
        for rid in list(self.replicas()):
            rep = self._replicas.get(rid)
            if rep is None or self._restart_state(rid).quarantined:
                continue        # the breaker owns quarantined replicas
            # wait out a monitor-side rebuild of this replica (it ends
            # with a fresh engine anyway — but the restart must still
            # cycle it deliberately, so claim rather than skip)
            claimed = self._claim(rid)
            t0 = time.monotonic()
            while not claimed and time.monotonic() - t0 < grace:
                time.sleep(0.02)
                claimed = self._claim(rid)
            if not claimed:
                continue            # could not get exclusive access
            rep = self._replicas.get(rid, rep)
            try:
                with _span("cluster.rolling_restart", replica=rid):
                    rep.begin_drain()
                    for creq in rep.take_backlog():
                        if creq.done:
                            continue
                        try:
                            self._route(creq, exclude=(rid,))
                        except AdmissionError as e:
                            creq._fail("evicted", e)
                    rep.stop_worker()
                    stats = rep.drain(grace)
                    rep.restart()
                    st = self._restart_state(rid)
                    st.down = False     # a deliberate cycle is not a
                    st.restart_at = None    # death the supervisor owns
                    # hold the next cycle until THIS replacement can
                    # take routes again — an in-process restart is
                    # ready immediately, but a subprocess replacement
                    # pays import + (cached) compile first, and cycling
                    # on without it would walk the tier down to zero
                    # routable capacity
                    t_up = time.monotonic()
                    while not rep.ready() \
                            and time.monotonic() - t_up < grace:
                        time.sleep(0.05)
                    results[rid] = stats
                    self._m["restarts"].inc()
            finally:
                with self._lock:
                    self._maintenance.discard(rid)
        return results

    # -- shutdown -------------------------------------------------------
    def drain(self, grace=30.0):
        """Drain the whole tier (no restarts): stop routing, drain each
        replica, leave admission closed."""
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)
        stats = {}
        for rid, rep in self.replicas().items():
            rep.begin_drain()
            for creq in rep.take_backlog():
                if not creq.done:
                    creq._fail("evicted", AdmissionError(
                        "cluster draining", live=0, max_batch=0,
                        free_pages=0, num_pages=0, retries=0))
            rep.stop_worker()
            stats[rid] = rep.drain(grace)
        return stats

    def stop(self):
        """Stop monitor + replicas (graceful; engines closed / worker
        processes clean-exited) and the rpc endpoint."""
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)
        for rep in self.replicas().values():
            rep.stop()
        if self._endpoint is not None:
            self._endpoint.stop()
            self._endpoint = None

    def stats(self):
        out = {}
        for rid, rep in self.replicas().items():
            d = rep.load()
            d["alive"] = rep.alive()
            d["ready"] = rep.ready()
            e = rep.engine
            if e is not None and e.prefix is not None:
                d["prefix"] = e.prefix.stats()
            out[rid] = d
        return out
