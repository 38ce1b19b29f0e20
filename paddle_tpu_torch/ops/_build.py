"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`. Builds
happen at first use, all sources at once (one ``nvcc`` process each),
into ``paddle_tpu_torch/build/<hash>/``, keyed by a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source rebuilds and an unchanged one is reused. A missing ``nvcc`` or a failed build raises.
Each build keeps the compiler's output (``ptxas -v``: registers, shared
memory and spills of every kernel) beside its library; :func:`ptxas_report`
reads it back.

Builds and loads report to the compile watcher
(:mod:`~paddle_tpu_torch.observability.compile_watch`): the build
directory is the port's persistent compile cache, so a library found
built when this process first asks for it is a cache hit and one that
``nvcc`` compiles a miss (and a backend compile); each library's first
load (its build included) is one compile of the callable
``kernel:<library>``, its source hash the signature.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

from ..observability import compile_watch as _cw

__all__ = ["COUNTERS", "NVCC_FLAGS", "SOURCES", "build_all", "counter",
           "data_ptr", "load", "ptxas_report", "sm_count", "tickets"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-ldl"]
#: library name -> source file under csrc/
SOURCES = {"ragged_paged_attention": "ragged_paged_attention.cu",
           "flash_attention": "flash_attention.cu",
           "fused_linear_cross_entropy": "fused_linear_cross_entropy.cu",
           "grouped_gemm": "grouped_gemm.cu",
           "dequant_matmul": "dequant_matmul.cu",
           "paged_attention": "paged_attention.cu",
           "sampling": "sampling.cu"}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_SMS: dict = {}             # device -> its SM count
_TICKETS: dict = {}         # (device, stream) -> the zeroed ticket buffer
#: every launch counter of the kernels' wrappers (:func:`counter`), in
#: the order they were made
COUNTERS: list[dict] = []


def counter(keys):
    """A launch counter ``{key: 0}`` of a kernel module, registered in
    :data:`COUNTERS`. A wrapper adds one to it where it launches its
    kernel; a CUDA-graph capture (``ops._graphs``) launches nothing, so
    it takes back what every registered counter counted and adds it
    again at each replay."""
    c = dict.fromkeys(keys, 0)
    COUNTERS.append(c)
    return c


def _nvcc():
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _lib_path(name):
    # the key covers the source and every shared header beside it
    parts = [SOURCES[name]] + sorted(f for f in os.listdir(CSRC)
                                     if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in parts:
        with open(os.path.join(CSRC, part), "rb") as f:
            h.update(f.read())
    h = h.hexdigest()
    return os.path.join(BUILD, h[:16], f"lib{name}.so")


def build_all(names=None):
    """Compile every library in ``names`` (default: all) that is not
    built yet, one ``nvcc`` each, all started together. Returns
    ``{name: path}``; raises :class:`RuntimeError` naming the source
    and the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    for n in names:
        if n not in todo:
            _cw.note_library(n, built=False)
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        os.makedirs(os.path.dirname(paths[n]), exist_ok=True)
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]} (exit {proc.returncode}):\n{log}")
        else:
            with open(paths[n] + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, paths[n])
            _cw.note_library(n, built=True)
            _cw.note_build(n, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("CUDA kernel build failed: "
                           + "\n".join(failed))
    return paths


def ptxas_report(name):
    """``{kernel (mangled): "N registers, spill stores S B, loads L B"}``
    from library ``name``'s build log (``ptxas -v``), building it first
    if needed."""
    with open(build_all([name])[name] + ".log") as f:
        log = f.read()
    report, kernel, spills = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            report[kernel] = f"{m.group(1)} registers, {spills}"
    return report


def data_ptr(t):
    """A tensor's device address for a C entry, None for no tensor."""
    return None if t is None else t.data_ptr()


def sm_count(device):
    """The SM count of CUDA ``device``."""
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def tickets(device, need):
    """At least ``need`` int32 tickets of ``device``'s current stream for
    the kernels whose last block to finish merges partial results. Every
    such kernel finds them zero and leaves them zero, and launches on one
    stream run in order, so one buffer per device and stream serves every
    launch there."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < need:
        buf = _TICKETS[key] = torch.zeros((max(need, 4096),),
                                          dtype=torch.int32, device=device)
    return buf


def load(name):
    """The loaded :class:`ctypes.CDLL` of library ``name``, building it
    first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            path = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(path)
            _cw._watch(f"kernel:{name}").record_compile(
                time.perf_counter() - t0,
                desc=(("source", os.path.basename(os.path.dirname(path))),))
        return lib
