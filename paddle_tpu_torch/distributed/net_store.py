"""TCP-native control plane: lease membership + KV over one socket
server.

:class:`~paddle_tpu_torch.distributed.watchdog.FileStore` keeps membership
on a shared filesystem — mtime leases, mkdir-locked epoch counters —
which dies with the mount and cannot span hosts that share nothing.
This module is the cross-host replacement:

- :class:`LeaseStoreServer` — a pure-Python threaded socket server
  speaking 4-byte length-prefixed pickled frames, so tier-1 never
  needs g++. It owns the authoritative state: **server-side TTL
  leases** (stamped from the SERVER's monotonic clock — one clock
  every writer and reader agrees on, the TCP analog of FileStore's
  fs-server mtime discipline), **server-fenced epochs** (a
  registration/heartbeat stamped with an epoch older than the
  server's counter is rejected with the same typed, picklable
  :class:`~paddle_tpu_torch.distributed.watchdog.StaleEpochError` — the
  stale-incarnation contract carries over verbatim), and the
  ``set``/``get``/``add``/``delete_key``/``wait`` KV surface the rpc
  mailboxes ride (``add`` keys hold a little-endian int64, matching
  the native ``TCPStore``). Each boot mints a nonce that travels in
  the session handshake, so clients can tell a reconnect to the same
  server from a reconnect to a RESTARTED one (whose leases, epochs
  and counters are gone). When :func:`paddle_tpu_torch.native.available`,
  the server can additionally front the C++ ``TCPStore`` for the pure
  KV ops (``native_kv=True``): the handshake advertises its port and
  every client routes ``set``/``get``/``add``/``delete_key``/``wait``
  to the C++ fast path while membership stays on the lease server.
  ``python -m paddle_tpu_torch.distributed.net_store --port N`` runs a
  standalone server process (what the chaos tests SIGKILL and restart
  on the same port).

- :class:`LeaseStore` — the client, implementing the full FileStore
  membership contract (``register``/``heartbeat(epoch=)``/``hosts``/
  ``heartbeat_age``/``deregister``/``next_epoch``/``epoch_of``) plus
  the KV surface, so :class:`~paddle_tpu_torch.inference.cluster
  .ServingCluster` and the rpc agents ride either store unchanged.
  Every transport failure maps to a typed, picklable
  :class:`StoreUnavailableError` carrying the server address and the
  op — no bare socket error reaches a serving dispatch path.
  Idempotent ops retry with exponential backoff + jitter;
  non-idempotent ops (``add``, ``next_epoch`` — a blind retry could
  double-claim a mailbox seq or hand out two epochs) fail fast after
  one attempt. A reconnect re-runs the session handshake; a changed
  boot nonce bumps :meth:`restarts` (the signal a replica's heartbeat
  sidecar uses to re-register under a fresh epoch) and counts
  ``store_reconnects_total``. ``store_outage_seconds`` gauges how
  long the server has been continuously unreachable (0 when healthy)
  and ``store_ops_total{op}`` counts every client op — the idle-churn
  meter the rpc dispatcher's blocking-wait satellite is judged by.

Chaos rides the ``store.connect`` / ``store.frame`` socket points
(:func:`paddle_tpu_torch.testing.faults.fire_store`): refuse, reset, hang,
slow, and torn-frame verdicts are applied client-side, so a seeded
plan replays identically and every injected failure takes the same
typed path a real one would.
"""

from __future__ import annotations

import os
import pickle
import random
import socket
import struct
import threading
import time

from ..observability import metrics as _om
from ..testing import faults as _faults
from .watchdog import StaleEpochError

__all__ = ["LeaseStore", "LeaseStoreServer", "StoreUnavailableError",
           "parse_addr"]

#: wire format: 4-byte big-endian frame length, then a pickled tuple
_LEN = struct.Struct("!I")
_MAX_FRAME = 64 * 1024 * 1024

#: env knobs for the client's retry envelope
RETRIES_ENV = "PADDLE_TPU_STORE_RETRIES"
_DEFAULT_RETRIES = 4
_CONNECT_TIMEOUT = 2.0


class StoreUnavailableError(ConnectionError):
    """The control-plane store could not be reached (or the session
    broke mid-operation) after the client's retry budget. Carries the
    server address and the op so a supervisor can tell a store outage
    from a peer death; subclasses :class:`ConnectionError` (hence
    ``OSError``), so existing transport-tolerant ``except OSError``
    paths degrade instead of crashing. Picklable with its typed
    fields intact (travels in rpc error replies)."""

    def __init__(self, addr=None, op=None, detail=None):
        msg = f"store at {addr} unavailable (op {op!r})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.addr = addr
        self.op = op
        self.detail = detail

    def __reduce__(self):
        return (type(self), (self.addr, self.op, self.detail))


def parse_addr(addr):
    """``"host:port"`` (or a ``(host, port)`` pair) -> ``(host, int)``."""
    if isinstance(addr, (tuple, list)):
        host, port = addr
        return str(host), int(port)
    host, _, port = str(addr).rpartition(":")
    return host or "127.0.0.1", int(port)


def _client_metrics():
    return (_om.counter("store_ops_total",
                        "control-plane store client operations",
                        labelnames=("op",)),
            _om.counter("store_reconnects_total",
                        "store sessions re-established after a "
                        "transport failure"),
            _om.gauge("store_outage_seconds",
                      "seconds the control-plane store has been "
                      "continuously unreachable (0 when healthy)"))


def _m_stale():
    return _om.counter(
        "cluster_stale_epoch_rejections_total",
        "membership/submission actions rejected because their epoch "
        "was fenced out by a newer incarnation")


# ---------------------------------------------------------------------
# server
# ---------------------------------------------------------------------
class LeaseStoreServer:
    """Authoritative lease/epoch/KV state behind one listening socket.

    One handler thread per connection; every op runs under one lock
    against plain dicts, with a condition variable waking blocking
    ``get``/``wait`` ops when a key lands — the whole server is a few
    hundred lines of stdlib, deliberately, so the pure-Python path is
    what tier-1 exercises everywhere. Lease stamps and ages come from
    ``time.monotonic()`` IN THIS PROCESS: a skewed client clock can
    neither expire a healthy host nor immortalize a dead one.
    """

    def __init__(self, port=0, host="127.0.0.1", native_kv=False):
        self.host = host
        self._boot = os.urandom(8).hex()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._kv: dict[str, bytes] = {}
        self._leases: dict[str, float] = {}     # host -> monotonic stamp
        self._epochs: dict[str, int] = {}       # survives deregister
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._native = None
        self.native_port = None
        if native_kv:
            from .. import native
            if native.available():
                # the C++ TCPStore fronts the pure KV ops; membership
                # stays here (leases/epochs need the fence + TTL the
                # native server does not implement)
                self._native = native.TCPStore(is_master=True, port=0)
                self.native_port = self._native.port
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"lease-store-{self.port}")
        self._accept_thread.start()

    # -- plumbing -------------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return              # closed
            with self._lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                hdr = self._recv_exact(conn, _LEN.size)
                if hdr is None:
                    return
                (n,) = _LEN.unpack(hdr)
                if n > _MAX_FRAME:
                    return
                body = self._recv_exact(conn, n)
                if body is None:
                    return
                try:
                    req = pickle.loads(body)
                    rsp = ("ok", self._dispatch(req))
                except TimeoutError:
                    rsp = ("timeout", None)
                except Exception as e:  # noqa: BLE001 — typed to client
                    rsp = ("err", e)
                out = pickle.dumps(rsp, protocol=pickle.HIGHEST_PROTOCOL)
                conn.sendall(_LEN.pack(len(out)) + out)
        except OSError:
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _recv_exact(conn, n):
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    # -- ops ------------------------------------------------------------
    def _dispatch(self, req):
        op, args = req[0], req[1:]
        return getattr(self, f"_op_{op}")(*args)

    def _op_hello(self):
        return {"boot": self._boot, "native_port": self.native_port}

    def _op_ping(self):
        return True

    def _op_set(self, key, value):
        with self._cond:
            self._kv[str(key)] = bytes(value)
            self._cond.notify_all()
        return True

    def _op_get(self, key, timeout):
        key = str(key)
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self._cond:
            while key not in self._kv:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(key)
                self._cond.wait(remaining)
            return self._kv[key]

    def _op_wait(self, key, timeout):
        self._op_get(key, timeout)
        return True

    def _op_add(self, key, delta):
        key = str(key)
        with self._cond:
            cur = int.from_bytes(self._kv.get(key, b"\0" * 8),
                                 "little", signed=True)
            new = cur + int(delta)
            self._kv[key] = new.to_bytes(8, "little", signed=True)
            self._cond.notify_all()
            return new

    def _op_del(self, key):
        with self._cond:
            return self._kv.pop(str(key), None) is not None

    def _op_numkeys(self):
        with self._lock:
            return len(self._kv)

    def _check_epoch(self, host_id, epoch):
        if epoch is None:
            return
        current = self._epochs.get(host_id)
        if current is not None and int(epoch) < current:
            raise StaleEpochError(host_id, int(epoch), current)

    def _op_register(self, host_id, epoch):
        host_id = str(host_id)
        with self._lock:
            self._check_epoch(host_id, epoch)
            if epoch is not None:
                # adopt-max healing: after a server restart the
                # counter is gone, so the first fenced stamp that
                # arrives re-establishes the fence at ITS epoch — a
                # later beat from an older incarnation is still
                # rejected, exactly as before the restart
                self._epochs[host_id] = max(
                    self._epochs.get(host_id, 0), int(epoch))
            self._leases[host_id] = time.monotonic()
        return True

    def _op_heartbeat(self, host_id, epoch):
        return self._op_register(host_id, epoch)

    def _op_hb_age(self, host_id):
        with self._lock:
            stamp = self._leases.get(str(host_id))
        if stamp is None:
            return None
        return max(0.0, time.monotonic() - stamp)

    def _op_dereg(self, host_id):
        with self._lock:
            self._leases.pop(str(host_id), None)
        return True

    def _op_hosts(self, ttl):
        now = time.monotonic()
        with self._lock:
            if ttl is None:
                return sorted(self._leases)
            return sorted(h for h, stamp in self._leases.items()
                          if now - stamp <= float(ttl))

    def _op_next_epoch(self, host_id):
        host_id = str(host_id)
        with self._lock:
            new = self._epochs.get(host_id, 0) + 1
            self._epochs[host_id] = new
            return new

    def _op_epoch_of(self, host_id):
        with self._lock:
            return self._epochs.get(str(host_id))

    # -- lifecycle ------------------------------------------------------
    def stop(self):
        self._stop.set()
        try:
            # shutdown BEFORE close: close() alone leaves the accept
            # thread blocked in its syscall, which keeps the LISTEN
            # socket alive kernel-side — and a same-port restart (the
            # chaos drill) would fail its bind until the next
            # connection attempt happened to wake it
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            # active sessions must see the death too — a handler
            # blocked in recv would otherwise serve one more op. RST
            # (linger 0) rather than FIN: a graceful close would park
            # the port in FIN_WAIT until every client noticed, and a
            # same-port restart — the whole point of the chaos drills —
            # would fail its bind
            try:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        with self._cond:
            self._cond.notify_all()
        if self._native is not None:
            self._native.close()
            self._native = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


# ---------------------------------------------------------------------
# client
# ---------------------------------------------------------------------
#: ops safe to retry blindly — re-running them converges to the same
#: state. ``add`` / ``next_epoch`` are NOT here: the op may have
#: executed before the reply was lost, and a blind resend would
#: double-claim a seq / hand out a second epoch.
_IDEMPOTENT = frozenset({
    "hello", "ping", "set", "get", "wait", "del", "numkeys",
    "register", "heartbeat", "hb_age", "dereg", "hosts", "epoch_of",
})


class LeaseStore:
    """Client for a :class:`LeaseStoreServer` — the TCP drop-in for
    :class:`~paddle_tpu_torch.distributed.watchdog.FileStore` (membership)
    plus the native ``TCPStore`` (KV), behind one reconnecting
    session. See the module docstring for the failure model.

    Args:
        addr: ``"host:port"`` of the server (or a ``(host, port)``
            pair).
        ttl: membership TTL seconds — sent with each :meth:`hosts`
            scan; AGING is judged by the server's clock.
        timeout: default budget for blocking ``get``/``wait``.
        retries: resend budget for idempotent ops (attempts =
            retries + 1); default ``PADDLE_TPU_STORE_RETRIES`` (4).
    """

    def __init__(self, addr, ttl=None, timeout=30.0, retries=None,
                 backoff=0.05, backoff_max=1.0):
        self.host, self.port = parse_addr(addr)
        self.addr = f"{self.host}:{self.port}"
        self.ttl = None if ttl is None else float(ttl)
        self.timeout = float(timeout)
        if retries is None:
            raw = os.environ.get(RETRIES_ENV)
            retries = int(raw) if raw else _DEFAULT_RETRIES
        self.retries = max(0, int(retries))
        self.backoff = float(backoff)
        self.backoff_max = float(backoff_max)
        self._lock = threading.RLock()
        self._sock = None
        self._boot = None           # server boot nonce of this session
        self._restarts = 0          # distinct server boots seen - 1
        self._native = None         # native KV offload client
        self._native_port = None
        self._op_seq = 0
        self._outage_t0 = None
        self._m_ops, self._m_reconnects, self._m_outage = \
            _client_metrics()
        self._m_stale = _m_stale()

    # -- session --------------------------------------------------------
    def clone(self):
        """A fresh client session to the same server (its own socket —
        what the rpc agents use for their dedicated dispatcher /
        per-attempt connections)."""
        return LeaseStore((self.host, self.port), ttl=self.ttl,
                          timeout=self.timeout, retries=self.retries,
                          backoff=self.backoff,
                          backoff_max=self.backoff_max)

    def restarts(self):
        """How many times this client has observed the server come up
        with a NEW boot nonce (0 until the first restart) — the
        replica heartbeat sidecar's cue to re-register under a fresh
        epoch."""
        with self._lock:
            return self._restarts

    def outage_age(self):
        """Seconds since this client's first unanswered transport
        attempt of the CURRENT outage (0 while healthy). Lock-free
        read: the router's admission gate polls it while other threads
        are mid-retry inside the session lock."""
        t0 = self._outage_t0
        return 0.0 if t0 is None else max(0.0, time.monotonic() - t0)

    def _apply_verdict(self, verdict, what):
        if verdict.slow:
            time.sleep(verdict.slow)
        if verdict.hang:
            time.sleep(verdict.hang)
            raise socket.timeout(f"fault injected: {what} hang")
        if verdict.refuse:
            raise ConnectionRefusedError(
                f"fault injected: {what} refused")
        if verdict.reset:
            raise ConnectionResetError(f"fault injected: {what} reset")
        if verdict.torn:
            raise ConnectionResetError(
                f"fault injected: torn frame at {what}")

    def _ensure_session(self):
        """Connect + handshake (caller holds the lock). Raises OSError
        family on failure; the retry loop owns mapping/backoff."""
        if self._sock is not None:
            return
        self._apply_verdict(
            _faults.fire_store("store.connect", path=self.addr),
            "connect")
        sock = socket.create_connection(
            (self.host, self.port),
            timeout=min(_CONNECT_TIMEOUT, self.timeout))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        try:
            hello = self._roundtrip("hello", (), self.timeout)
        except BaseException:
            self._drop_session()
            raise
        reconnected = self._boot is not None
        if hello["boot"] != self._boot:
            if self._boot is not None:
                # a NEW boot: leases, epochs and counters are gone —
                # the owner of this session must re-register
                self._restarts += 1
            self._boot = hello["boot"]
        self._native_port = hello.get("native_port")
        if reconnected:
            self._m_reconnects.inc()
        if self._outage_t0 is not None:
            self._outage_t0 = None
            self._m_outage.set(0.0)
        if self._native_port is not None and self._native is None:
            from .. import native
            if native.available():
                self._native = native.TCPStore(
                    host=self.host, port=self._native_port,
                    timeout=self.timeout)

    def _drop_session(self):
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        native, self._native = self._native, None
        if native is not None:
            try:
                native.close()
            except Exception:
                pass

    def _roundtrip(self, op, args, timeout):
        """One framed request/response on the live socket (caller
        holds the lock; session established)."""
        self._apply_verdict(
            _faults.fire_store("store.frame", step=self._op_seq,
                               path=op), op)
        self._op_seq += 1
        payload = pickle.dumps((op,) + tuple(args),
                               protocol=pickle.HIGHEST_PROTOCOL)
        sock = self._sock
        # the server may legitimately hold a blocking get/wait for the
        # full requested timeout; pad the socket budget past it
        sock.settimeout(max(0.1, float(timeout)) + 5.0)
        sock.sendall(_LEN.pack(len(payload)) + payload)
        hdr = self._recv_exact(sock, _LEN.size)
        (n,) = _LEN.unpack(hdr)
        if n > _MAX_FRAME:
            raise ConnectionResetError(f"oversized frame ({n} bytes)")
        status, value = pickle.loads(self._recv_exact(sock, n))
        if status == "timeout":
            raise TimeoutError(
                f"store op {op!r} timed out after {timeout}s")
        if status == "err":
            if isinstance(value, StaleEpochError):
                self._m_stale.inc()
            raise value
        return value

    @staticmethod
    def _recv_exact(sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionResetError("store connection closed")
            buf += chunk
        return buf

    def _call(self, op, *args, timeout=None):
        """Run one op with the retry/reconnect envelope. Transport
        failures surface as :class:`StoreUnavailableError`; a blocking
        op that merely found no key raises bare ``TimeoutError``
        (matching the native store); server-side typed errors
        (:class:`StaleEpochError`) propagate as themselves."""
        if _om.enabled():
            self._m_ops.labels(op).inc()
        if timeout is None:
            timeout = self.timeout
        attempts = (self.retries + 1) if op in _IDEMPOTENT else 1
        delay = self.backoff
        last = None
        with self._lock:
            for attempt in range(attempts):
                if attempt:
                    time.sleep(delay * (1.0 + 0.25 * random.random()))
                    delay = min(self.backoff_max, delay * 2.0)
                try:
                    self._ensure_session()
                    return self._roundtrip(op, args, timeout)
                except (StaleEpochError, TimeoutError):
                    raise       # typed/terminal — not a transport loss
                except (OSError, EOFError, pickle.UnpicklingError,
                        struct.error) as e:
                    last = e
                    self._drop_session()
                    if self._outage_t0 is None:
                        self._outage_t0 = time.monotonic()
                    self._m_outage.set(
                        time.monotonic() - self._outage_t0)
            raise StoreUnavailableError(self.addr, op,
                                        detail=repr(last)) from last

    # -- KV surface (native TCPStore parity) ----------------------------
    def _kv_call(self, op, *args, timeout=None):
        """KV ops prefer the server's advertised native offload (the
        C++ fast path) when one exists; transport failures there drop
        the whole session and fall back through the retry envelope."""
        with self._lock:
            native = self._native
        if native is None:
            return self._call(op, *args, timeout=timeout)
        if _om.enabled():
            self._m_ops.labels(op).inc()
        try:
            if op == "set":
                native.set(args[0], args[1])
                return True
            if op == "get":
                return native.get(args[0], timeout=timeout)
            if op == "add":
                return native.add(args[0], args[1])
            if op == "del":
                return native.delete_key(args[0])
            if op == "wait":
                native.wait(args[0], timeout=timeout)
                return True
            if op == "numkeys":
                return native.num_keys()
        except TimeoutError:
            raise
        except (OSError, RuntimeError) as e:
            with self._lock:
                self._drop_session()
            raise StoreUnavailableError(self.addr, op,
                                        detail=repr(e)) from e
        raise ValueError(f"not a KV op: {op!r}")

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        self._kv_call("set", key, bytes(value))

    def get(self, key, timeout=None):
        return self._kv_call(
            "get", key, self.timeout if timeout is None else timeout,
            timeout=self.timeout if timeout is None else timeout)

    def add(self, key, delta=1):
        return self._kv_call("add", key, int(delta))

    def delete_key(self, key):
        return self._kv_call("del", key)

    def wait(self, keys, timeout=None):
        t = self.timeout if timeout is None else timeout
        if isinstance(keys, str):
            keys = [keys]
        for k in keys:
            self._kv_call("wait", k, t, timeout=t)

    def num_keys(self):
        return self._kv_call("numkeys")

    def barrier(self, world_size, tag="barrier", timeout=None):
        arrived = self.add(f"_{tag}/count", 1)
        if arrived == world_size:
            self.set(f"_{tag}/done", b"1")
        self.wait(f"_{tag}/done", timeout)

    # -- membership surface (FileStore parity) --------------------------
    def register(self, host_id, epoch=None):
        self._call("register", str(host_id),
                   None if epoch is None else int(epoch))

    def heartbeat(self, host_id, epoch=None):
        """Refresh a live host's lease. Same chaos surface as
        FileStore: the ``store.heartbeat`` NETWORK point fires first
        (drop -> the beat is silently lost, returns False;
        delay/hold -> in-flight latency), so partition plans
        drive either backend unchanged."""
        verdict = _faults.fire_network("store.heartbeat",
                                       src=str(host_id), dst="store")
        if verdict.delay or verdict.hold:
            time.sleep(verdict.delay + verdict.hold)
        if verdict.drop:
            return False
        self._call("heartbeat", str(host_id),
                   None if epoch is None else int(epoch))
        return True

    def heartbeat_age(self, host_id):
        return self._call("hb_age", str(host_id))

    def deregister(self, host_id):
        self._call("dereg", str(host_id))

    def hosts(self):
        return self._call("hosts", self.ttl)

    def next_epoch(self, host_id, timeout=5.0):
        return self._call("next_epoch", str(host_id))

    def epoch_of(self, host_id):
        return self._call("epoch_of", str(host_id))

    def check_epoch(self, host_id, epoch):
        """Client-side convenience probe of the server's fence (the
        authoritative check runs server-side on every fenced op)."""
        if epoch is None:
            return
        current = self.epoch_of(host_id)
        if current is not None and int(epoch) < current:
            self._m_stale.inc()
            raise StaleEpochError(str(host_id), int(epoch), current)

    def ping(self, timeout=None):
        """One round trip; raises :class:`StoreUnavailableError` when
        the server is unreachable."""
        return self._call("ping", timeout=timeout)

    def close(self):
        with self._lock:
            self._drop_session()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------
# standalone server process (the chaos tests' SIGKILL target)
# ---------------------------------------------------------------------
def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="run a standalone LeaseStoreServer")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--native-kv", action="store_true",
                    help="front the C++ TCPStore for KV ops when the "
                         "native build is available")
    args = ap.parse_args(argv)
    srv = LeaseStoreServer(port=args.port, host=args.host,
                           native_kv=args.native_kv)
    print(f"lease-store listening on {srv.host}:{srv.port}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
