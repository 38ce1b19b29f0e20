"""Subprocess serving replica: ``replica_main()`` (the reference's
``inference/replica_worker.py``, its model built by PyTorch on the card).

The :class:`~paddle_tpu_torch.inference.cluster.EngineReplica` worker
loop was designed to map 1:1 onto a process main loop — this module IS
that process. ``python -m paddle_tpu_torch.inference.replica_worker`` (the
supervisor's spawn command) reads its configuration from the
environment, builds the engine from a JSON spec, and runs the exact
same ``EngineReplica`` the in-process cluster uses, with three
process-native twists:

- **Crash containment.** The engine, its compiled programs, and every
  dispatch live in THIS process. A segfault, OOM, or wedged dispatch
  takes down one replica; the supervisor sees the exit code (or the
  heartbeat stamp aging out of the FileStore) and spawns a
  replacement. A worker whose loop dies uncleanly exits ``17`` without
  deregistering — a crashed host never says goodbye; membership TTL is
  the detector.
- **Warm restart.** The kernels' build directory
  (``ops._build``) is the persistent compile cache: a worker loads the
  libraries an earlier process built (``cache`` in the poll reply counts
  them as hits). The engine pre-warms the dispatch shapes and tick counts
  the shape registry (``compile_watch.shape_registry()``) recorded for
  engines of identical geometry (``PADDLE_TPU_SERVING_PREWARM=1`` is the
  supervisor's default for workers), capturing the tick graphs, then a
  one-token self-probe runs — so registration in membership means
  "built and serving", and the reported ``restart_ttft`` (process start
  to first emitted token) of a replacement pays no build and no
  first-use warm-up.
- **Transport.** Requests arrive over the
  :class:`~paddle_tpu_torch.distributed.rpc.RpcEndpoint` dynamic mesh: the
  router hosts the master TCPStore; this worker joins as
  ``PADDLE_TPU_REPLICA_ID`` with no barrier and serves the module-level
  ``_worker_*`` handlers below (pickled by reference, so both sides
  import this module). Typed errors — :class:`AdmissionError` with
  ``retry_after``, :class:`DeadlineExceeded` with its carried fields —
  travel pickled in the rpc error reply, intact.

Environment contract (set by :class:`SubprocessReplica`):

- ``PADDLE_TPU_REPLICA_ID`` — replica name (rpc address + membership id)
- ``PADDLE_TPU_REPLICA_STORE`` — FileStore membership directory
- ``PADDLE_TPU_REPLICA_STORE_ADDR`` — ``host:port`` of a
  :class:`~paddle_tpu_torch.distributed.net_store.LeaseStoreServer`;
  replaces ``PADDLE_TPU_REPLICA_STORE`` in TCP-only deployments
  (membership AND the rpc mailbox ride the lease server — no shared
  filesystem is touched)
- ``PADDLE_TPU_REPLICA_RPC`` — ``host:port`` of the router's TCPStore
- ``PADDLE_TPU_REPLICA_SPEC`` — JSON engine spec (below)
- ``PADDLE_TPU_REPLICA_TTL`` — membership TTL seconds (optional)
- ``PADDLE_TPU_REPLICA_T0`` — supervisor's spawn wall-clock stamp; the
  base of the reported ``restart_ttft``
- ``PADDLE_TPU_REPLICA_BACKLOG`` / ``PADDLE_TPU_REPLICA_BURST`` —
  worker-loop knobs (optional)
- ``PADDLE_TPU_REPLICA_HEALTH_PORT`` — serve ``/metrics`` +
  ``/healthz`` + ``/readyz`` on this port (optional; the actual port is
  written to ``<store>/.http.<id>`` so ``port=0`` works)
- ``PADDLE_TPU_REPLICA_LOG_DIR`` — the cluster log dir (optional).
  When set, the worker (a) installs the crash flight recorder with its
  bundles under ``<log_dir>/<id>/postmortem/`` (the supervisor's death
  path harvests them), and (b) flushes its span ring to a bounded
  trace shard ``<log_dir>/trace_shards/<id>.trace.json`` every
  ``PADDLE_TPU_TRACE_FLUSH`` seconds (default 0.5) for the cluster's
  merged-trace collector. Both are no-ops under
  ``PADDLE_TPU_METRICS=0``.

Spec format::

    {"model": {"kind": "tiny_llama", "seed": 0, "config": {...},
               "device": "cuda", "dtype": "bfloat16"},
     "engine": {"max_batch": 8, "page_size": 16, ...}}

``kind`` is ``tiny_llama`` / ``llama`` (config kwargs into
:func:`tiny_llama_config` / :class:`LlamaConfig`), or ``{"model":
{"factory": "my_pkg.serving:build_model"}}`` imports a zero-arg model
builder. ``device`` (default: the card, through ``resolve_device``,
which raises where there is none) and ``dtype`` (a ``torch`` dtype name,
default ``float32``) place the weights; with ``seed`` they are drawn
from ``torch.Generator(device).manual_seed(seed)``, so one seed, config,
dtype and device give the same weights in every process. The worker
prints a checksum of its weights to its log
(``weights_sha256=<hex>``, :func:`weights_digest`). Fault plans (``PADDLE_TPU_FAULTS``) ride the inherited
environment, so ``replica.dead`` / ``replica.heartbeat`` rules fire
inside the worker process exactly as they do in-process.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

__all__ = ["replica_main"]

#: the live worker state in a replica process (None in the router)
_WORKER = None


#: seconds a TERMINAL request waits to be polled before the worker
#: forgets it — a submit whose rpc reply was lost leaves an entry the
#: router never learned the id of (it re-routed on timeout), and those
#: must not accumulate for the life of the process
_UNCLAIMED_TTL = 60.0


class _WorkerState:
    def __init__(self, replica_id, rep):
        self.replica_id = replica_id
        self.rep = rep
        self.restart_ttft = None
        self._reqs = {}                   # req_id -> ClusterRequest
        self._done_at = {}                # req_id -> monotonic stamp
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self.stop = threading.Event()

    def _reap_unclaimed(self, polled_ids):
        """Forget terminal entries nobody has polled for
        ``_UNCLAIMED_TTL`` seconds (caller holds the lock). Entries the
        router knows are deleted on first poll; what lands here is the
        lost-submit-reply orphan the router already failed over."""
        now = time.monotonic()
        for req_id, creq in list(self._reqs.items()):
            if req_id in polled_ids or not creq.done:
                continue
            t0 = self._done_at.setdefault(req_id, now)
            if now - t0 > _UNCLAIMED_TTL:
                del self._reqs[req_id]
                self._done_at.pop(req_id, None)


def _require():
    if _WORKER is None:
        raise RuntimeError(
            "not a replica worker process (replica_main() not running)")
    return _WORKER


# ---------------------------------------------------------------------
# rpc handlers — module-level so they pickle by reference; they run on
# the worker's rpc dispatcher thread
# ---------------------------------------------------------------------
def _worker_submit(spec):
    """Admit one request spec into the replica's backlog. Returns a
    request id the router polls; raises a typed (picklable)
    AdmissionError when the replica is draining or its backlog is
    full — the rpc error reply carries it back intact. A spec stamped
    with an ``epoch`` other than this incarnation's membership epoch
    is rejected with a typed StaleEpochError: a submission addressed
    to the replacement must never be served by a partitioned old
    incarnation consuming the same name-keyed mailbox (and vice
    versa). Retried submits (at-least-once rpc) are deduped by the
    dispatcher's reply cache, so admission stays exactly-once."""
    from .cluster import ClusterRequest
    from .sampling import SamplingParams

    w = _require()
    creq = ClusterRequest(
        spec["prompt_ids"], spec["max_new_tokens"],
        spec.get("eos_token_id"), spec.get("deadline"),
        spec.get("token_budget"), spec.get("priority", 0),
        spec.get("retry_budget", 1),
        sampling=SamplingParams.from_spec(spec.get("sampling")),
        stop=spec.get("stop") or ())
    creq._t_submit = time.perf_counter()
    w.rep.submit(creq, epoch=spec.get("epoch"))
    req_id = f"{w.replica_id}:{next(w._seq)}"
    with w._lock:
        w._reqs[req_id] = creq
    return req_id


def _worker_poll(req_ids):
    """Batched status poll: per-request state (terminal entries are
    handed over once, then forgotten) plus the replica-level snapshot
    the router routes on (ready, load, restart TTFT, compile-cache
    hit/miss)."""
    from ..observability import compile_watch as _cw

    w = _require()
    reqs = {}
    with w._lock:
        for req_id in req_ids:
            c = w._reqs.get(req_id)
            if c is None:
                reqs[req_id] = None       # unknown: router fails over
            elif c.done:
                reqs[req_id] = {"done": True, "status": c.status,
                                "output_ids": list(c.output_ids),
                                "error": c.error}
                del w._reqs[req_id]
                w._done_at.pop(req_id, None)
            else:
                # a live request's tokens so far (its engine attempt's),
                # what the router's poller mirrors for streaming; the
                # reference sends ``output_ids`` here, empty until the
                # request ends
                reqs[req_id] = {"done": False, "status": c.status,
                                "output_ids": c.partial_output(),
                                "error": None}
        w._reap_unclaimed(set(req_ids))
    # ready only once the self-probe finished: "compiled AND proven
    # serving", not merely "registered" — the router must never route
    # to a replica whose restart_ttft (and first real dispatch) is
    # still in flight
    return {"ready": w.rep.ready() and w.restart_ttft is not None,
            "load": w.rep.load(), "restart_ttft": w.restart_ttft,
            "epoch": w.rep.epoch,
            "cache": _cw.persistent_cache_stats(), "requests": reqs}


def _worker_cancel(req_id):
    w = _require()
    with w._lock:
        creq = w._reqs.get(req_id)
    if creq is None:
        return False
    req = creq.cancel()
    if req is not None and w.rep.engine is not None:
        w.rep.engine.cancel(req)
    return True


def _worker_begin_drain():
    w = _require()
    w.rep.begin_drain()
    return True


def _worker_take_backlog():
    """Hand queued-but-unadmitted requests back to the router (their
    ids); the router re-routes its own handles to peer replicas."""
    w = _require()
    backlog = w.rep.take_backlog()
    taken = []
    with w._lock:
        ids = {c: i for i, c in w._reqs.items()}
        for c in backlog:
            req_id = ids.get(c)
            if req_id is not None:
                del w._reqs[req_id]
                taken.append(req_id)
    return taken


def _worker_drain(grace=30.0):
    """Stop the worker loop and drain the engine:
    in-flight requests finish or expire typed inside the grace."""
    w = _require()
    w.rep.stop_worker()
    return w.rep.drain(grace)


def _worker_scrape():
    """This replica's full registry snapshot (the one-pane metrics
    feed): the supervisor's ``ServingCluster.scrape()`` pulls these
    over the existing rpc path and merges them under a ``replica``
    label. Returns an empty snapshot under ``PADDLE_TPU_METRICS=0``."""
    from ..observability import metrics as _om
    from ..observability import perf as _perf
    from ..observability.export import json_snapshot

    w = _require()
    _perf.ensure_build_info()   # identity labels ride every scrape
    snapshot = json_snapshot() if _om.enabled() else []
    return {"replica": w.replica_id, "pid": os.getpid(),
            "snapshot": snapshot}


def _worker_capture_profile(seconds=1.0):
    """One on-demand profiler window in this replica process (the
    fan-out target of ``ServingCluster.capture_profile()``): runs on
    the rpc dispatcher thread while the engine keeps serving, returns
    this process's span shard + device-trace events for the
    supervisor's merge. Empty-events shard under
    ``PADDLE_TPU_METRICS=0``."""
    from ..observability import perf as _perf

    w = _require()
    return _perf.capture_local(seconds, worker_name=w.replica_id)


def _worker_exit():
    """Clean shutdown: the main loop deregisters from membership and
    exits 0 (the reply is published before the dispatcher yields)."""
    w = _require()
    w.stop.set()
    return True


# ---------------------------------------------------------------------
# process entrypoint
# ---------------------------------------------------------------------
def _build_model(model_spec):
    import torch

    from ..device import resolve_device
    from ..models import LlamaForCausalLM, tiny_llama_config
    from ..models.llama import LlamaConfig

    factory = model_spec.get("factory")
    if factory:
        mod, _, attr = factory.partition(":")
        import importlib

        fn = getattr(importlib.import_module(mod), attr)
        return fn()
    kind = model_spec.get("kind", "tiny_llama")
    cfg_kw = model_spec.get("config", {})
    if kind == "tiny_llama":
        cfg = tiny_llama_config(**cfg_kw)
    elif kind == "llama":
        cfg = LlamaConfig(**cfg_kw)
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    dev = resolve_device(model_spec.get("device"))
    dtype = getattr(torch, model_spec.get("dtype", "float32"))
    seed = model_spec.get("seed")
    gen = None if seed is None \
        else torch.Generator(dev).manual_seed(int(seed))
    m = LlamaForCausalLM(cfg, device=dev, dtype=dtype, generator=gen)
    m.eval()
    return m


def weights_digest(model, n=4096):
    """SHA-256 over each parameter's name, shape, dtype and its first
    ``n`` and last ``n`` values' bytes, in ``state_dict`` order: equal
    digests mean two processes built the same weights (what a parent
    holding its own copy of a worker's model checks before comparing
    tokens)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, p in model.state_dict().items():
        flat = p.detach().reshape(-1)
        part = torch.cat([flat[:n], flat[-n:]]) if flat.numel() > 2 * n \
            else flat
        h.update(f"{name}:{tuple(p.shape)}:{p.dtype}".encode())
        h.update(part.view(torch.uint8).cpu().numpy().tobytes()
                 if part.element_size() > 0 else b"")
    return h.hexdigest()


def replica_main():
    """Run one subprocess serving replica until a clean ``_worker_exit``
    (exit 0, deregistered) or an unclean worker-loop death (exit 17, no
    goodbye — membership TTL detects it)."""
    global _WORKER

    t0 = float(os.environ.get("PADDLE_TPU_REPLICA_T0") or time.time())
    replica_id = os.environ["PADDLE_TPU_REPLICA_ID"]
    store_path = os.environ.get("PADDLE_TPU_REPLICA_STORE")
    store_addr = os.environ.get("PADDLE_TPU_REPLICA_STORE_ADDR")
    if store_path is None and store_addr is None:
        raise RuntimeError(
            "replica worker needs PADDLE_TPU_REPLICA_STORE (FileStore "
            "dir) or PADDLE_TPU_REPLICA_STORE_ADDR (LeaseStore "
            "host:port)")
    rpc_addr = os.environ["PADDLE_TPU_REPLICA_RPC"]
    spec = json.loads(os.environ["PADDLE_TPU_REPLICA_SPEC"])
    ttl_env = os.environ.get("PADDLE_TPU_REPLICA_TTL")
    ttl = float(ttl_env) if ttl_env else None
    backlog = os.environ.get("PADDLE_TPU_REPLICA_BACKLOG")
    burst = os.environ.get("PADDLE_TPU_REPLICA_BURST")

    from ..distributed.rpc import RpcEndpoint
    from ..distributed.watchdog import FileStore
    from ..observability import flight_recorder as _fr
    from ..observability import tracing as _tracing
    from .cluster import ClusterRequest, EngineReplica
    from .serving import LlamaServingEngine

    log_dir = os.environ.get("PADDLE_TPU_REPLICA_LOG_DIR")
    if log_dir:
        # install BEFORE the engine builds: a crash mid-compile leaves
        # a postmortem bundle too. Per-replica subdir, so the
        # supervisor's death path knows exactly whose bundle it found.
        _fr.install(log_dir=os.path.join(log_dir, replica_id))

    model = _build_model(spec.get("model", {}))
    print(f"replica {replica_id} pid {os.getpid()} weights_sha256="
          f"{weights_digest(model)}", flush=True)
    engine_kw = dict(spec.get("engine", {}))

    def factory():
        # prewarm rides the engine default (PADDLE_TPU_SERVING_PREWARM,
        # which the supervisor sets to 1 for workers): registry-recorded
        # dispatch shapes / decode-scan ticks warm up (and the tick graphs
        # capture) here — BEFORE this replica enters membership
        return LlamaServingEngine(model, **engine_kw)

    if store_addr is not None:
        # TCP-only control plane: membership leases live on the
        # LeaseStoreServer — nothing in this process touches a shared
        # filesystem (replica and router may be on different hosts)
        from ..distributed.net_store import LeaseStore

        store = LeaseStore(store_addr, ttl=ttl)
    else:
        store = FileStore(store_path, ttl=ttl)
    rep = EngineReplica(
        replica_id, factory, store=store, ttl=ttl,
        max_backlog=int(backlog) if backlog else None,
        burst=int(burst) if burst else None,
        spawn_fault=False)      # the supervisor's Popen was the spawn
    state = _WorkerState(replica_id, rep)
    _WORKER = state

    # rpc FIRST, membership second: the dispatcher resumes this name's
    # mailbox at the store's current seq counter, so every seq claimed
    # after this point IS served — and because a caller only trusts a
    # replica it has seen in membership (or polled ready), nothing it
    # sends to a registered replica can fall into the resume gap.
    # Pre-engine polls simply report ready=False while compiles run.
    if store_addr is not None:
        # mailbox on the SAME lease server as membership (its own
        # session): outage tolerance + post-restart seq resync come
        # from the LeaseStore client, not the native TCPStore
        endpoint = RpcEndpoint(replica_id, store=store.clone())
    else:
        endpoint_host, _, endpoint_port = rpc_addr.rpartition(":")
        endpoint = RpcEndpoint(replica_id, host=endpoint_host,
                               port=int(endpoint_port))

    # start() builds the engine (prewarm included), registers in
    # membership, then starts the worker loop + heartbeat sidecar —
    # registration IS the readiness signal the supervisor waits on
    rep.start()

    # monotonic<->epoch clock-offset handshake AT registration: the
    # collector needs this process's span-clock base to align its
    # shard with the other processes' timelines (dot-prefixed file:
    # membership hosts() scans ignore it). No file under METRICS=0,
    # and no file at all in TCP-only mode (no shared dir to put it in)
    if store_path is not None:
        _tracing.record_clock_handshake(store_path, replica_id)

    # restart -> serving self-probe: one trivial request through the
    # real admission + prefill + decode path proves every serving
    # program compiles and works — so a COLD worker pays exactly the
    # program set a warm worker pre-warms from the registry, and the
    # stamped restart_ttft numbers (what the warm-restart checks
    # compare) measure warm against cold, not differing work
    probe = ClusterRequest([1], max_new_tokens=2)
    probe._t_submit = time.perf_counter()
    rep.submit(probe)
    probe.wait(timeout=600)
    state.restart_ttft = time.time() - t0

    srv = None
    health_port = os.environ.get("PADDLE_TPU_REPLICA_HEALTH_PORT")
    if health_port:
        from ..observability.export import start_http_server

        def _health_info():
            # /healthz names the membership epoch + heartbeat age so
            # an operator can spot a fenced-out stale incarnation from
            # the probe alone 
            try:
                hb_age = store.heartbeat_age(replica_id)
            except OSError:
                hb_age = None   # store outage: age unknown — the
                # probe itself must keep answering
            return {"replica_id": replica_id, "epoch": rep.epoch,
                    "fenced": rep._fenced,
                    "membership_heartbeat_age_seconds": hb_age}

        srv = start_http_server(port=int(health_port), ready=rep.ready,
                                health_info=_health_info)
        # port=0 picks a free port; publish it next to the membership
        # stamps (dot-prefixed: hosts() ignores it). TCP-only mode has
        # no shared dir — publish through the lease store's KV instead
        if store_path is not None:
            with open(os.path.join(store_path, f".http.{replica_id}"),
                      "w") as f:
                f.write(str(srv.port))
        else:
            store.set(f"http/{replica_id}", str(srv.port).encode())

    flush_every = float(os.environ.get("PADDLE_TPU_TRACE_FLUSH")
                        or 0.5)
    last_flush = 0.0

    def _flush_shard():
        if log_dir:
            try:
                _tracing.write_span_shard(log_dir, replica_id)
            except Exception:
                pass    # telemetry must never kill a serving worker

    try:
        while not state.stop.wait(0.1):
            now = time.monotonic()
            if now - last_flush >= flush_every:
                last_flush = now
                _flush_shard()
            if rep._dead:
                # the worker loop DIED (fault injection, a crash the
                # fatal-guard re-raised) — as opposed to a deliberate
                # stop_worker() during a drain, which keeps this
                # process serving rpc until _worker_exit. Exit unclean
                # WITHOUT deregistering: a crashed host never says
                # goodbye; membership TTL is the detector. The final
                # shard flush below still happens: the dying worker's
                # spans are exactly the ones worth merging.
                _flush_shard()
                os._exit(17)
            if rep._fenced:
                # fenced out by a replacement incarnation (stale-epoch
                # heartbeat rejection): stop serving immediately and —
                # critically — do NOT deregister: the stamp belongs to
                # the replacement now, and removing it would knock the
                # HEALTHY successor out of membership
                os._exit(19)
    finally:
        # clean exit: give the dispatcher a beat to flush the
        # _worker_exit reply, then say goodbye properly
        time.sleep(0.3)
        _flush_shard()
        rep.stop()
        endpoint.stop()
        if srv is not None:
            srv.stop()
    return 0


if __name__ == "__main__":
    # run the CANONICAL module's replica_main, not __main__'s copy:
    # ``python -m`` loads this file as __main__, but the rpc dispatcher
    # unpickles handlers against ``paddle_tpu_torch.inference.replica_worker``
    # — two module objects, two _WORKER globals, and the handlers would
    # see None forever
    from paddle_tpu_torch.inference.replica_worker import replica_main as _rm

    raise SystemExit(_rm() or 0)
