"""The port's C++ control-plane pieces (a copy of the reference's
``native`` package, its TCP store only).

:class:`TCPStore` is the rendezvous key-value store (master and
clients) with blocking get/wait, atomic add and a counter-based barrier:
the rpc mailboxes of the serving cluster ride it. The library is built
with g++ on first use (``build.py``) into ``lib/`` and bound with ctypes.
``available()`` is False when it cannot be built or loaded
(``PADDLE_TPU_DISABLE_NATIVE=1`` too); callers then take their
pure-Python paths. The reference's token feed (``data_feed.cc``) comes
with the rest of the training path.
"""

from __future__ import annotations

import ctypes

from . import build as _build

__all__ = ["available", "TCPStore"]


def available():
    return _build.load() is not None


def _lib():
    lib = _build.load()
    if lib is None:
        raise RuntimeError(
            f"native control-plane library unavailable: "
            f"{_build.load_error()}")
    return lib


class TCPStore:
    """Bootstrap/rendezvous store (reference ``TCPStore``).

    ``is_master=True`` starts the serving thread in this process (rank 0)
    and connects a client to it; workers connect to ``host:port``. All
    values are bytes; ``add`` keys hold a little-endian int64 counter.
    """

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 timeout=30.0):
        lib = _lib()
        self._lib = lib
        self._server = None
        if is_master:
            self._server = lib.pts_store_server_start(port)
            if not self._server:
                raise RuntimeError(f"TCPStore: cannot bind port {port}")
            port = lib.pts_store_server_port(self._server)
        self.host, self.port = host, port
        self.timeout = timeout
        self._client = lib.pts_store_connect(
            host.encode(), port, int(timeout * 1000))
        if not self._client:
            if self._server:
                srv, self._server = self._server, None
                lib.pts_store_server_stop(srv)
            raise TimeoutError(
                f"TCPStore: cannot reach master at {host}:{port}")

    @property
    def is_master(self):
        return self._server is not None

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        buf = (ctypes.c_uint8 * len(value)).from_buffer_copy(value) \
            if value else None
        if self._lib.pts_store_set(self._client, key.encode(), buf,
                                   len(value)) != 0:
            raise self._unavailable("set")

    def get(self, key, timeout=None):
        t = self.timeout if timeout is None else timeout
        n = ctypes.c_uint64()
        p = self._lib.pts_store_get(self._client, key.encode(),
                                    ctypes.byref(n), int(t * 1000))
        if not p:
            raise TimeoutError(f"TCPStore.get({key!r}) timed out after {t}s")
        try:
            return ctypes.string_at(p, n.value)
        finally:
            self._lib.pts_buf_free(p)

    def add(self, key, delta=1):
        v = self._lib.pts_store_add(self._client, key.encode(), delta)
        if v == -(2 ** 63):
            raise self._unavailable("add")
        return v

    def _unavailable(self, op):
        # typed so no bare transport RuntimeError can reach a serving
        # dispatch path; lazy import avoids a module cycle (net_store
        # imports this package for the optional KV offload)
        from ..distributed.net_store import StoreUnavailableError
        return StoreUnavailableError(f"{self.host}:{self.port}", op,
                                     detail="connection lost")

    def wait(self, keys, timeout=None):
        t = self.timeout if timeout is None else timeout
        if isinstance(keys, str):
            keys = [keys]
        for k in keys:
            if self._lib.pts_store_wait(self._client, k.encode(),
                                        int(t * 1000)) != 0:
                raise TimeoutError(
                    f"TCPStore.wait({k!r}) timed out after {t}s")

    def delete_key(self, key):
        return self._lib.pts_store_del(self._client, key.encode()) == 0

    def num_keys(self):
        return self._lib.pts_store_numkeys(self._client)

    def barrier(self, world_size, tag="barrier", timeout=None):
        """All ``world_size`` participants block until everyone arrived.
        ``tag`` must be fresh per barrier round (callers use an epoch
        counter)."""
        arrived = self.add(f"_{tag}/count", 1)
        if arrived == world_size:
            self.set(f"_{tag}/done", b"1")
        self.wait(f"_{tag}/done", timeout)

    def close(self):
        if getattr(self, "_client", None):
            self._lib.pts_store_disconnect(self._client)
            self._client = None
        if getattr(self, "_server", None):
            self._lib.pts_store_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
