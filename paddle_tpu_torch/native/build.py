"""Build and load the port's native control-plane library.

The C++ sources under ``src/`` (the TCP store, ``src/tcp_store.cc``)
compile into one shared object in ``lib/``, named by a hash of their
content, so the library is rebuilt exactly when a source changes. One
``g++ -shared`` call is the whole build: the library includes no PyTorch
or CUDA header and takes seconds to build, at first use in a process
(never at import).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "src")
_LIB_DIR = os.path.join(_HERE, "lib")

_lib = None
_lib_err = None


def _sources():
    return sorted(
        os.path.join(_SRC_DIR, f)
        for f in os.listdir(_SRC_DIR)
        if f.endswith(".cc"))


def _content_hash(srcs):
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose=False):
    """Compile (if needed) and return the path to the .so.

    Raises ``RuntimeError`` with the compiler output on failure.
    """
    srcs = _sources()
    out = os.path.join(_LIB_DIR, f"_native_{_content_hash(srcs)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_LIB_DIR, exist_ok=True)
    # build into a temp file then atomically rename, so a concurrent
    # builder (another worker process) never loads a half-written .so
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-Wall", *srcs, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if verbose:
        print(f"built {out}")
    return out


def load():
    """ctypes.CDLL for the native library, or None if unbuildable.

    Memoized; set ``PADDLE_TPU_DISABLE_NATIVE=1`` to force the pure-
    Python fallbacks.
    """
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    if os.environ.get("PADDLE_TPU_DISABLE_NATIVE") == "1":
        _lib_err = "disabled by PADDLE_TPU_DISABLE_NATIVE"
        return None
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError) as e:
        _lib_err = str(e)
        return None
    _declare(lib)
    _lib = lib
    return lib


def load_error():
    return _lib_err


def _declare(lib):
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.pts_store_server_start.restype = c.c_void_p
    lib.pts_store_server_start.argtypes = [c.c_int]
    lib.pts_store_server_port.restype = c.c_int
    lib.pts_store_server_port.argtypes = [c.c_void_p]
    lib.pts_store_server_stop.restype = None
    lib.pts_store_server_stop.argtypes = [c.c_void_p]
    lib.pts_store_connect.restype = c.c_void_p
    lib.pts_store_connect.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.pts_store_disconnect.restype = None
    lib.pts_store_disconnect.argtypes = [c.c_void_p]
    lib.pts_store_set.restype = c.c_int
    lib.pts_store_set.argtypes = [c.c_void_p, c.c_char_p, u8p, c.c_uint64]
    lib.pts_store_get.restype = u8p
    lib.pts_store_get.argtypes = [c.c_void_p, c.c_char_p,
                                  c.POINTER(c.c_uint64), c.c_int64]
    lib.pts_store_add.restype = c.c_int64
    lib.pts_store_add.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.pts_store_wait.restype = c.c_int
    lib.pts_store_wait.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.pts_store_del.restype = c.c_int
    lib.pts_store_del.argtypes = [c.c_void_p, c.c_char_p]
    lib.pts_store_numkeys.restype = c.c_int64
    lib.pts_store_numkeys.argtypes = [c.c_void_p]
    lib.pts_buf_free.restype = None
    lib.pts_buf_free.argtypes = [u8p]
