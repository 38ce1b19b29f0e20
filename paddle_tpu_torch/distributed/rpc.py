"""``paddle.distributed.rpc`` (reference:
`python/paddle/distributed/rpc/rpc.py` — brpc-backed init_rpc /
rpc_sync / rpc_async / shutdown between named workers).

TPU-native transport: the native C++ TCPStore (the control plane's
rendezvous store) instead of brpc — each worker runs a dispatcher
thread that serves requests addressed to its name; calls are pickled
``(caller, call_id, fn, args, kwargs)`` like the reference (plus the
dedup identity). The data plane never touches this path (collectives
ride ICI/DCN inside compiled programs); RPC is for control messages,
metrics, and orchestration — latency budgets where a KV-store
transport is fine.

Partition tolerance: the network between caller and callee
is assumed to drop, delay, and duplicate. Delivery is therefore
AT-LEAST-ONCE — a call that times out is retried (bounded, exponential
backoff + jitter) under the SAME ``(caller, call_id)`` identity — and
the dispatcher makes redelivery exactly-once-EFFECTIVE: it remembers
the replies of recently served calls in a bounded cache keyed by that
identity, so a redelivered request republishes the cached reply
instead of executing the handler again (``rpc_duplicate_deliveries_
total`` counts the hits; ``rpc_retries_total`` counts resends).
Deterministic chaos rides :func:`paddle_tpu_torch.testing.faults
.fire_network` at the ``rpc.send`` / ``rpc.reply`` message points.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import pickle
import random
import threading
import time

from ..observability import trace as _otrace
from ..observability import tracing as _tracing
from ..testing import faults as _faults
from .net_store import LeaseStore, StoreUnavailableError

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_current_worker_info", "get_worker_info",
           "get_all_worker_infos", "WorkerInfo", "RpcTimeoutError",
           "RpcEndpoint", "DEFAULT_TIMEOUT_ENV", "IDLE_WAIT_ENV"]

#: env var capping a ``wait(timeout=None)`` on a call that was itself
#: made with ``timeout=None`` — the docstring's "never an indefinite
#: block on a dead peer" holds even when nobody passed a budget
DEFAULT_TIMEOUT_ENV = "PADDLE_TPU_RPC_DEFAULT_TIMEOUT"
_DEFAULT_TIMEOUT = 120.0

#: env var for the default retry budget of rpc_sync / RpcEndpoint.call
#: (attempts = retries + 1); dedup makes retried calls exactly-once-
#: effective, so retrying is safe by default
RETRIES_ENV = "PADDLE_TPU_RPC_RETRIES"
_DEFAULT_RETRIES = 2

#: env var bounding the dispatcher's reply cache (dedup window)
REPLY_CACHE_ENV = "PADDLE_TPU_RPC_REPLY_CACHE"
_DEFAULT_REPLY_CACHE = 512

#: env var for the dispatcher's idle blocking-wait budget per wake.
#: The old idle poll issued a fresh 0.25 s ``get`` four times a second
#: per mailbox; one blocking ``wait`` per budget cuts that control-
#: plane churn ~8x (``store_ops_total{op}`` meters it). Clamped to
#: 2 s so ``stop()`` stays responsive — the wait blocks server-side
#: and can only be abandoned between wakes.
IDLE_WAIT_ENV = "PADDLE_TPU_RPC_IDLE_WAIT"
_DEFAULT_IDLE_WAIT = 2.0


def _env_float(name, default):
    raw = os.environ.get(name)
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _default_rpc_timeout():
    return _env_float(DEFAULT_TIMEOUT_ENV, _DEFAULT_TIMEOUT)


def _default_retries():
    return max(0, int(_env_float(RETRIES_ENV, _DEFAULT_RETRIES)))


def _metrics():
    from ..observability import metrics as _om

    return (_om.counter("rpc_retries_total",
                        "rpc attempts re-sent after a typed timeout"),
            _om.counter("rpc_duplicate_deliveries_total",
                        "redelivered requests answered from the "
                        "dispatcher's reply cache (handler NOT re-run)"))


class RpcTimeoutError(TimeoutError):
    """A synchronous wait on an RPC reply exceeded its ``timeout`` —
    the peer is dead, unreachable, or its handler is stuck. Carries the
    peer name, sequence number and budget so a supervisor can decide to
    retry, reroute, or declare the worker failed instead of blocking
    forever."""

    def __init__(self, to=None, seq=None, timeout=None):
        super().__init__(
            f"rpc to worker {to!r} (seq {seq}) timed out after "
            f"{timeout}s — peer dead or handler stuck")
        self.to = to
        self.seq = seq
        self.timeout = timeout

    def __reduce__(self):
        # a handler's own nested rpc timeout travels back pickled in
        # the error reply; reconstruct from the typed fields, not the
        # formatted message
        return (type(self), (self.to, self.seq, self.timeout))


class WorkerInfo:
    def __init__(self, name, rank):
        self.name = name
        self.rank = rank

    def __repr__(self):
        return f"WorkerInfo(name={self.name!r}, rank={self.rank})"


class _FutureReply:
    def __init__(self, to=None, seq=None, timeout=None):
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._to = to
        self._seq = seq
        self._timeout = timeout

    def _set(self, value, error):
        self._value, self._error = value, error
        self._event.set()

    def wait(self, timeout=None):
        """Block for the reply. ``timeout=None`` falls back to the
        call's own (total, retries-included) timeout; if THAT is also
        None, a default cap (``PADDLE_TPU_RPC_DEFAULT_TIMEOUT``,
        120 s) applies — expiry raises :class:`RpcTimeoutError` (typed
        — never an indefinite block on a dead peer)."""
        if timeout is None:
            timeout = self._timeout
        if timeout is None:
            timeout = _default_rpc_timeout()
        if not self._event.wait(timeout):
            raise RpcTimeoutError(self._to, self._seq, timeout)
        if self._error is not None:
            raise self._error
        return self._value


class _RpcAgent:
    def __init__(self, name, rank, world_size, store, dynamic=False):
        self.name = name
        self.rank = rank
        self.world_size = world_size
        self.store = store
        self._stop = threading.Event()
        self._req_seq = 0
        self._serve_from = 0
        # at-least-once identity: every logical call gets one id; a
        # retry reuses it, so the dispatcher can dedup redelivery. The
        # per-agent nonce makes the identity unique ACROSS incarnations
        # of one caller name — a replacement caller's counter restarts
        # at 0, and without the nonce its first calls would hit the
        # dead predecessor's cached replies
        self._incarnation = os.urandom(6).hex()
        self._call_ids = itertools.count()
        # (caller, call_id) -> [reply bytes, last published seq or
        # None]; bounded FIFO — the dedup window
        self._reply_cache: collections.OrderedDict = \
            collections.OrderedDict()
        self._reply_cache_cap = max(
            8, int(_env_float(REPLY_CACHE_ENV, _DEFAULT_REPLY_CACHE)))
        self._m_retries, self._m_dups = _metrics()
        # LeaseStore meters its own store_ops_total{op}; the native
        # TCPStore is ctypes and can't, so the dispatcher counts its
        # idle-loop ops itself — same counter, either backend
        self._m_store_ops = None
        if not isinstance(store, LeaseStore):
            from ..observability import metrics as _om
            self._m_store_ops = _om.counter(
                "store_ops_total",
                "control-plane store client operations",
                labelnames=("op",))
        if dynamic:
            # a REPLACEMENT incarnation of this name must resume the
            # mailbox where the store's seq counter stands — starting at
            # 0 would wait forever on seqs the dead incarnation already
            # consumed (calls addressed to the corpse are lost; their
            # callers time out typed and retry, which is the contract)
            try:
                raw = store.get(f"rpc/seq/{name}", timeout=0.25)
                self._serve_from = int.from_bytes(raw, "little")
            except TimeoutError:
                pass                  # never called: fresh mailbox
            except StoreUnavailableError:
                pass    # store down at join: start at 0; the serve
                # loop resyncs the cursor once the store is back
        self._served = self._serve_from   # dispatcher's next-unserved seq
        if not dynamic:
            store.set(f"rpc/worker/{rank}", name.encode())
        # DEDICATED connection for the dispatcher: a TCPStore client
        # serializes requests on its single socket, so a blocking
        # reply-wait elsewhere must never share the dispatcher's
        # connection — two agents each starving their own dispatcher
        # while waiting on the other is a distributed deadlock
        self._dispatch_store = self._connect()
        self._dispatcher = threading.Thread(target=self._serve, daemon=True)
        self._dispatcher.start()
        self.workers = {}
        if not dynamic:
            # barrier: everyone registered before calls start flying
            store.barrier(world_size, tag="rpc_init")
            for r in range(world_size):
                wname = store.get(f"rpc/worker/{r}", timeout=30).decode()
                self.workers[wname] = WorkerInfo(wname, r)

    def _connect(self):
        # a LeaseStore clones a fresh session to the same lease
        # server; the native TCPStore gets a fresh socket the old way
        clone = getattr(self.store, "clone", None)
        if clone is not None:
            return clone()
        from ..native import TCPStore

        return TCPStore(host=self.store.host, port=self.store.port,
                        timeout=self.store.timeout)

    def _count_op(self, op):
        if self._m_store_ops is not None:
            self._m_store_ops.labels(op).inc()

    def _resync(self, st, seq, streak):
        """The idle wait expired with no message at ``seq``: reconcile
        the cursor against the store's authoritative ``rpc/seq``
        counter. Counter BELOW us -> the store restarted and lost its
        state (new claims start at 0): resume at 0 so the post-restart
        mailbox drains from its bottom — anything re-delivered from
        before the restart hits the dedup cache. Counter ABOVE us with
        our slot still empty across consecutive wakes -> a sender
        claimed the slot and died before publishing: skip the hole
        (safe under at-least-once — its caller times out typed and
        retries under a fresh seq)."""
        try:
            raw = st.get(f"rpc/seq/{self.name}", timeout=0.25)
            claimed = int.from_bytes(raw, "little")
        except StoreUnavailableError:
            return seq, 0
        except TimeoutError:
            return seq, 0       # counter absent: nothing ever claimed
        if claimed < seq:
            return 0, 0
        if claimed > seq:
            streak += 1
            if streak >= 2:
                return seq + 1, 0
            return seq, streak
        return seq, 0

    def _serve(self):
        seq = self._serve_from
        st = self._dispatch_store
        idle_cap = min(2.0, max(0.1, _env_float(IDLE_WAIT_ENV,
                                                _DEFAULT_IDLE_WAIT)))
        missing_streak = 0
        while not self._stop.is_set():
            key = f"rpc/to/{self.name}/{seq}"
            try:
                # one blocking wait per wake replaces the old fresh-
                # 0.25s get poll (see IDLE_WAIT_ENV)
                self._count_op("wait")
                st.wait(key, timeout=idle_cap)
                self._count_op("get")
                payload = st.get(key, timeout=0.25)
            except StoreUnavailableError:
                # store outage: hold the cursor and re-poll — no
                # mailbox slot is skipped, service resumes with the
                # reconnected session
                time.sleep(0.2)
                continue
            except TimeoutError:
                seq, missing_streak = self._resync(st, seq,
                                                   missing_streak)
                continue
            missing_streak = 0
            try:
                st.delete_key(key)
            except StoreUnavailableError:
                pass    # request key leaks until the store's restart
            reply = None
            call_key = None
            caller = None
            try:
                msg = pickle.loads(payload)
                tr = None
                if len(msg) >= 5:
                    # dedup envelope: a redelivered request (network
                    # duplicate, or a retry whose original executed
                    # but whose reply was lost) must NOT run the
                    # handler again — republish the cached reply.
                    # A 6th element is the optional trace context
                    # (absent entirely when the caller traced nothing
                    # — the envelope stays on the pre-trace layout).
                    caller, cid, fn, args, kwargs = msg[:5]
                    tr = msg[5] if len(msg) > 5 else None
                    call_key = (caller, cid)
                    cached = self._reply_cache.get(call_key)
                    if cached is not None:
                        self._m_dups.inc()
                        reply = cached[0]
                        rctx = _tracing.extract(tr)
                        if rctx is not None:
                            # tag the suppressed redelivery in the
                            # trace: a zero-width child of the call
                            # span, so retries that hit the dedup
                            # cache are visible on the timeline
                            with _otrace.span("rpc.dedup",
                                              trace_ctx=rctx.child(),
                                              caller=str(caller),
                                              suppressed=True):
                                pass
                else:
                    fn, args, kwargs = msg      # legacy envelope
                if reply is None:
                    rctx = _tracing.extract(tr)
                    if rctx is None:
                        reply = b"ok:" + pickle.dumps(
                            fn(*args, **kwargs))
                    else:
                        # restore the caller's context: the handler
                        # span (and anything the handler itself
                        # spans or injects downstream) chains to the
                        # remote call span
                        with _tracing.activate(rctx), \
                                _otrace.span(
                                    "rpc.handle",
                                    fn=getattr(fn, "__name__",
                                               str(fn)),
                                    endpoint=str(self.name)):
                            reply = b"ok:" + pickle.dumps(
                                fn(*args, **kwargs))
            except Exception as e:
                reply = b"er:" + pickle.dumps(e)
            if call_key is not None:
                # cache BEFORE the tombstone check: even when a timed-
                # out caller suppressed this publication, its retry
                # must find the result here (exactly-once-effective)
                for stale in self._cache_reply(call_key, reply, seq):
                    try:
                        st.delete_key(f"rpc/reply/{self.name}/{stale}")
                    except StoreUnavailableError:
                        pass
            # (rpc.reply faults fire on the WAITER side — the receiving
            # end of the reply path — where a simulated loss can be
            # cleaned up without leaking tombstones)
            # Tombstone protocol: a timed-out caller plants
            # rpc/dead/{name}/{seq}; consuming it means "don't publish,
            # nobody is waiting" — otherwise a late reply would leak in
            # the master store forever. Re-check after publishing to
            # close the set-between-check-and-publish race (the waiter
            # symmetrically deletes the reply if it was already out).
            reply_key = f"rpc/reply/{self.name}/{seq}"
            tomb_key = f"rpc/dead/{self.name}/{seq}"
            try:
                if not st.delete_key(tomb_key):
                    st.set(reply_key, reply)
                    if st.delete_key(tomb_key):
                        st.delete_key(reply_key)
            except StoreUnavailableError:
                # outage between serve and publish: the reply stays in
                # the dedup cache, so the caller's retry (under the
                # same identity) republishes it — advance the cursor
                pass
            seq += 1
            self._served = seq

    def _cache_reply(self, call_key, reply, seq):
        """Remember a served call's reply for the dedup window and the
        seqs it was published under; returns seqs whose publications
        are now STALE and safe to reap. A publication is never reaped
        right after a newer one lands (the primary's waiter may still
        be mid-read) — only with generations of slack, plus whole
        entries the bounded cache evicts. Dispatcher thread only."""
        stale = []
        entry = self._reply_cache.get(call_key)
        if entry is None:
            self._reply_cache[call_key] = [reply, [seq]]
        else:
            entry[1].append(seq)
            if len(entry[1]) > 4:
                stale.append(entry[1].pop(0))
        self._reply_cache.move_to_end(call_key)
        if len(self._reply_cache) > self._reply_cache_cap:
            _, (_, seqs) = self._reply_cache.popitem(last=False)
            stale.extend(seqs)
        return stale

    def call(self, to, fn, args, kwargs, timeout, retries=None,
             backoff=0.05, backoff_max=2.0):
        """At-least-once call: up to ``retries`` resends (exponential
        backoff + jitter) of the SAME ``(caller, call_id)`` envelope on
        :class:`RpcTimeoutError`; the peer's dedup cache makes the
        retried call exactly-once-effective. ``timeout`` is the
        PER-ATTEMPT reply budget; the returned future's own timeout is
        the total across attempts. Handler exceptions are terminal —
        only transport timeouts retry."""
        if retries is None:
            retries = _default_retries()
        attempts = max(1, int(retries) + 1)
        if timeout is None:
            # defaulting here (not per attempt) keeps the retry
            # contract intact for timeout=None calls: the future's
            # total below covers every attempt, so a sync wait(None)
            # outlives the retries instead of expiring at one
            # attempt's default budget
            timeout = _default_rpc_timeout()
        cid = (self._incarnation, next(self._call_ids))
        env = (self.name, cid, fn, args or (), kwargs or {})
        # trace propagation: with an active context, mint ONE child
        # span for the logical call and append its wire fields as a
        # 6th envelope element. The SAME envelope is re-sent on every
        # retry, so however many deliveries happen, the callee's spans
        # all chain to this one call node. With no active trace (or
        # under PADDLE_TPU_METRICS=0) the envelope stays byte-for-byte
        # on the 5-element pre-trace layout.
        call_ctx = None
        tctx = _tracing.current()
        if tctx is not None:
            call_ctx = tctx.child()
            env = env + (call_ctx.to_wire(),)
        payload = pickle.dumps(env)
        # per-attempt budget + worst-case backoff + slack: the driver
        # thread decides the typed error, wait() is a backstop
        total = attempts * timeout + sum(
            min(backoff_max, backoff * (2 ** i))
            for i in range(attempts - 1)) + 5.0
        fut = _FutureReply(to=to, seq=None, timeout=total)
        fname = getattr(fn, "__name__", str(fn))

        def driver():
            delay = backoff
            last_err = None
            # the driver runs on its own thread (fresh contextvars):
            # record the call span under the exact identity the
            # envelope carries, with per-attempt child spans so
            # retries are visible on the timeline
            call_span = _otrace.span("rpc.call", trace_ctx=call_ctx,
                                     to=str(to), fn=fname) \
                if call_ctx is not None else contextlib.nullcontext()
            try:
                with call_span:
                    for attempt in range(attempts):
                        if attempt:
                            self._m_retries.inc()
                            time.sleep(
                                delay * (1.0 + 0.25 * random.random()))
                            delay = min(backoff_max, delay * 2.0)
                        att_span = _otrace.span(
                            "rpc.attempt", to=str(to),
                            attempt=attempt, retry=bool(attempt)) \
                            if call_ctx is not None \
                            else contextlib.nullcontext()
                        with att_span:
                            err = self._attempt(to, payload, timeout,
                                                fut)
                        if err is None:
                            return      # fut already resolved
                        last_err = err
                        if not isinstance(err, (RpcTimeoutError,
                                                StoreUnavailableError)):
                            break       # terminal: neither a loss nor
                            # a store outage (both of which retry —
                            # the backoff rides out a store restart)
            except Exception as e:      # noqa: BLE001 — a dying driver
                last_err = e            # must resolve, never strand
            fut._set(None, last_err)

        threading.Thread(target=driver, daemon=True).start()
        return fut

    def _attempt(self, to, payload, timeout, fut):
        """One send + reply wait. Resolves ``fut`` and returns None on
        a reply (ok or handler error); returns the transport error
        (``RpcTimeoutError`` = retryable loss) otherwise. Runs on the
        call's driver thread."""
        verdict = _faults.fire_network("rpc.send", src=self.name,
                                       dst=to)
        if timeout is None:
            timeout = _default_rpc_timeout()
        if verdict.drop:
            # the envelope never left this process: no seq claimed, no
            # keys to clean — the loss surfaces as a typed timeout
            return RpcTimeoutError(to, None, timeout)
        deadline = time.monotonic() + timeout
        # per-attempt connection: the blocking reply-get must not pin
        # the shared client (see _dispatch_store note)
        conn = None
        seq = None
        try:
            if verdict.delay:
                time.sleep(verdict.delay)   # in-flight latency: sleep,
                # then claim the mailbox slot (no hole in the mailbox)
            seq = self.store.add(f"rpc/seq/{to}", 1) - 1
            fut._seq = seq
            if verdict.hold:
                # reorder: the slot is claimed but the payload lands
                # late — later messages already queue behind this seq
                time.sleep(verdict.hold)
            self.store.set(f"rpc/to/{to}/{seq}", payload)
            for _ in range(verdict.copies):
                # duplicate delivery: same envelope, its own mailbox
                # slot; the peer's dedup cache suppresses re-execution
                dup = self.store.add(f"rpc/seq/{to}", 1) - 1
                self.store.set(f"rpc/to/{to}/{dup}", payload)
            conn = self._connect()
            remaining = max(0.05, deadline - time.monotonic())
            rsp = conn.get(f"rpc/reply/{to}/{seq}", timeout=remaining)
            conn.delete_key(f"rpc/reply/{to}/{seq}")
            rv = _faults.fire_network("rpc.reply", src=to,
                                      dst=self.name)
            if rv.delay or rv.hold:
                time.sleep(rv.delay + rv.hold)
            if rv.drop:
                # the reply was lost in the network: the handler ran
                # (and cached its reply), we never saw it — retry will
                # hit the peer's dedup cache
                return RpcTimeoutError(to, seq, timeout)
            if rsp[:3] == b"er:":
                fut._set(None, pickle.loads(rsp[3:]))
            else:
                fut._set(pickle.loads(rsp[3:]), None)
            return None
        except Exception as e:
            if isinstance(e, TimeoutError) \
                    and not isinstance(e, RpcTimeoutError):
                # the store's bare TimeoutError means no reply
                # appeared within budget: surface it typed
                e = RpcTimeoutError(to, seq, timeout)
            # Plant a tombstone so the (probably still running)
            # handler skips publishing its reply; if the reply beat
            # the tombstone, reap both keys ourselves. Nothing to
            # plant when the claim itself failed (seq None: no message
            # ever entered the mailbox).
            if conn is not None and seq is not None:
                try:
                    conn.set(f"rpc/dead/{to}/{seq}", b"1")
                    if conn.delete_key(f"rpc/reply/{to}/{seq}"):
                        conn.delete_key(f"rpc/dead/{to}/{seq}")
                except Exception:
                    pass
            return e
        finally:
            if conn is not None:
                conn.close()

    def stop(self):
        self._stop.set()
        self._dispatcher.join(timeout=5)
        # Sweep own tombstones: a timed-out caller plants
        # rpc/dead/{name}/{seq}; the dispatcher consumes it when (not)
        # publishing that seq's reply, so only seqs it never reached —
        # [_served, claimed): shutdown raced the dispatcher, or a
        # crashed caller claimed a seq and never sent — can leak one in
        # the master store forever. Fresh connection: the dispatcher may
        # outlive join(timeout) and still own _dispatch_store's socket.
        start = self._served
        if self._dispatcher.is_alive():
            # the join timed out, so the dispatcher is stuck inside a
            # slow handler for seq _served (after stop() its idle wait
            # can only block ~2s) and will run that seq's tombstone
            # protocol itself when the handler returns — sweeping it
            # here would let the late reply leak instead
            start += 1
        conn = None
        try:
            conn = self._connect()
            try:
                # read-only probe: add(key, 0) would CREATE the seq key
                # for an agent nobody ever called — its own leak
                raw = conn.get(f"rpc/seq/{self.name}", timeout=0.25)
                claimed = int.from_bytes(raw, "little")
            except TimeoutError:
                claimed = start     # never called: nothing to sweep
            for seq in range(start, claimed):
                conn.delete_key(f"rpc/dead/{self.name}/{seq}")
                # the orphaned request payload for an unserved seq is
                # the bigger leak (arbitrary pickled args vs 1 byte)
                conn.delete_key(f"rpc/to/{self.name}/{seq}")
            # reap unconsumed publications the dedup cache still
            # tracks: a duplicate-delivery republish whose waiter was
            # long gone would otherwise leak its reply forever
            for _, pseqs in list(self._reply_cache.values()):
                for pseq in pseqs:
                    conn.delete_key(f"rpc/reply/{self.name}/{pseq}")
        except Exception:
            pass    # best-effort: the store may already be gone
        finally:
            if conn is not None:
                conn.close()
        self._dispatch_store.close()


class RpcEndpoint:
    """A named RPC mailbox with DYNAMIC membership — the serving tier's
    sibling of :func:`init_rpc`'s fixed-world agent.

    ``init_rpc`` assumes a training job: every rank known up front, a
    barrier before the first call, one global agent per process. A
    serving cluster is the opposite — replica processes join when they
    finish compiling, die without notice, and are replaced under a new
    incarnation of the same name — so an endpoint skips the barrier and
    the rank enumeration entirely: the name IS the address (the store
    key-space is already name-keyed: ``rpc/to/{name}/{seq}``), late
    joiners serve as soon as their dispatcher is up, and any number of
    endpoints may live in one process (no global singleton).

    The router hosts the master store (``is_master=True, port=0`` picks
    a free port — read it back from :attr:`port`); workers connect as
    clients. Everything else — the dedicated dispatcher connection, the
    tombstone protocol for timed-out calls, the typed
    :class:`RpcTimeoutError` — is the proven ``_RpcAgent`` machinery,
    reused as-is.
    """

    def __init__(self, name, host="127.0.0.1", port=0, is_master=False,
                 timeout=60.0, store=None):
        self.name = name
        if store is None:
            from ..native import TCPStore

            store = TCPStore(host=host, port=int(port),
                             is_master=is_master, timeout=timeout)
            self.host = host
        else:
            # ride a caller-provided store session — how a TCP-only
            # cluster puts every mailbox on the one LeaseStoreServer
            # (cross-host reachable, outage-tolerant) instead of a
            # per-router native master store
            self.host = store.host
        self.port = store.port
        self._agent = _RpcAgent(name, rank=None, world_size=None,
                                store=store, dynamic=True)
        self._closed = False

    def call(self, to, fn, args=None, kwargs=None, timeout=30.0,
             retries=None):
        """Async call of ``fn(*args, **kwargs)`` on endpoint ``to``;
        returns a future whose ``wait()`` raises the peer's pickled
        exception or a typed :class:`RpcTimeoutError`. ``timeout`` is
        the per-attempt reply budget; a lost request or reply is
        re-sent up to ``retries`` times (default
        ``PADDLE_TPU_RPC_RETRIES``, 2) with exponential backoff +
        jitter — the peer dedups redelivery, so the call stays
        exactly-once-effective."""
        return self._agent.call(to, fn, args, kwargs, timeout,
                                retries=retries)

    def call_sync(self, to, fn, args=None, kwargs=None, timeout=30.0,
                  retries=None):
        # wait(None): the future's own timeout is the retry-inclusive
        # total — bounding the wait by one attempt's budget would kill
        # the call before its retries ran
        return self.call(to, fn, args, kwargs, timeout,
                         retries=retries).wait(None)

    def stop(self):
        """Stop serving and sweep this endpoint's own tombstones.
        Idempotent; the underlying store connection is closed."""
        if self._closed:
            return
        self._closed = True
        self._agent.stop()
        try:
            self._agent.store.close()
        except Exception:
            pass


_agent: _RpcAgent | None = None


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """Join the RPC mesh (reference `rpc.py:init_rpc`). Rank 0 hosts the
    store; ``master_endpoint`` is ``"host:port"``."""
    global _agent
    if _agent is not None:
        raise RuntimeError("rpc already initialized")
    import os

    from ..native import TCPStore

    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None \
        else rank
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", 1)) \
        if world_size is None else world_size
    endpoint = master_endpoint \
        or os.environ.get("PADDLE_MASTER", "127.0.0.1:0")
    host, port = endpoint.rsplit(":", 1)
    store = TCPStore(host=host, port=int(port), is_master=(rank == 0),
                     timeout=60)
    _agent = _RpcAgent(name, rank, world_size, store)
    return _agent.store.port


def rpc_sync(to, fn, args=None, kwargs=None, timeout=30.0,
             retries=None):
    """Blocking call of ``fn(*args, **kwargs)`` on worker ``to``.

    ``timeout`` (seconds) bounds each delivery attempt; a lost request
    or reply is re-sent up to ``retries`` times (default
    ``PADDLE_TPU_RPC_RETRIES``, 2) with exponential backoff + jitter —
    redelivery is deduped by the peer, so the call stays exactly-once-
    effective. A peer that never answers raises
    :class:`RpcTimeoutError` (a :class:`TimeoutError` subclass naming
    peer/seq/budget) after the bounded total instead of blocking
    forever."""
    return rpc_async(to, fn, args, kwargs, timeout,
                     retries=retries).wait(None)


def rpc_async(to, fn, args=None, kwargs=None, timeout=30.0,
              retries=None):
    """Returns a future with ``.wait()`` (reference returns FutureWrapper)."""
    if _agent is None:
        raise RuntimeError("call init_rpc first")
    return _agent.call(to, fn, args, kwargs, timeout, retries=retries)


def get_current_worker_info():
    return _agent.workers[_agent.name]


def get_worker_info(name):
    return _agent.workers[name]


def get_all_worker_infos():
    return sorted(_agent.workers.values(), key=lambda w: w.rank)


def shutdown():
    """Stop serving (reference `rpc.py:shutdown` barriers first so no
    in-flight call is dropped)."""
    global _agent
    if _agent is None:
        return
    _agent.store.barrier(_agent.world_size, tag="rpc_shutdown")
    _agent.stop()
    _agent.store.close()
    _agent = None
