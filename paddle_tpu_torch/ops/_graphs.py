"""CUDA-graph capture for the decode loops and the train step (the
counterpart of the reference's compiled programs: the serving engine's
scanned decode tick, ``LlamaForCausalLM.generate``'s decode step, and
``jit.to_static``'s train step, :mod:`paddle_tpu_torch.jit`).

One :class:`StepGraphs` serves one engine, one model's ``generate``, or
one compiled function: it holds the static buffers its steps read and
write, a memory pool (``torch.cuda.graph_pool_handle()``) that all its
graphs share, and the stream they are captured on. A step is a function of those buffers alone,
with no host read on its path. :meth:`StepGraphs.capture` runs it once on
the capture stream first (every lazy piece of state, a kernel library's
build and load, a ``cudaFuncSetAttribute``, cuBLAS's workspace, the
kernels' ticket buffer, is made there, outside the graph), then captures
it; :meth:`StepGraphs.replay` launches the captured kernels on the current
stream. Graphs of one set replay one at a time on one stream, so their
pool's scratch never holds two live graphs' values.

Addresses are baked into a graph: the kernels' pointers and tensor maps
point at the static buffers and at the pool's scratch, so a caller refills
a buffer with ``copy_`` and never rebinds it. A failed capture raises; no
caller falls back to the eager step.

The kernels' launch counters (``_build.COUNTERS``, every wrapper's
``launches`` / ``instance_launches``) count launches: a capture launches
nothing, so what it counted is taken back and added again at every
replay.

On the CPU there is nothing to capture: the callers run the step
function itself on the same buffers.

Each capture reports to the compile watcher
(:mod:`~paddle_tpu_torch.observability.compile_watch`): one compile of
the callable named by the set (``name``), its wall time the warm-up run
plus the capture, its signature the graph's (the key, or what the caller
gives), so a set that keeps capturing new graphs trips the recompile-storm
counter.

Every capture holds :data:`CAPTURE_LOCK`. PyTorch captures in CUDA's
global capture mode, in which another thread's allocation, synchronize
or legacy-stream launch breaks the capture (or fails itself); device
work made from another thread than the dispatching one (the host KV
tier's page export, restore and staging) holds the same lock, so it
never overlaps a capture.
"""

from __future__ import annotations

import threading
import time

import torch

from ..observability import compile_watch as _cw
from . import _build

__all__ = ["StepGraphs", "CAPTURE_LOCK"]

#: held by every capture, and by device work that may run on another
#: thread than the captures' (see the module docstring)
CAPTURE_LOCK = threading.RLock()


def _take_back(before):
    """Restore every launch counter to ``before`` (a copy of
    ``_build.COUNTERS``); returns what was counted since, the launches a
    capture recorded, as ``[(counter, {key: n})]``. A counter made since
    (a module first imported under the capture) started at 0."""
    delta = []
    for i, c in enumerate(_build.COUNTERS):
        old = before[i] if i < len(before) else dict.fromkeys(c, 0)
        d = {k: v - old[k] for k, v in c.items() if v != old[k]}
        if d:
            delta.append((c, d))
        c.update(old)
    return delta


def _add(delta):
    for c, d in delta:
        for k, v in d.items():
            c[k] += v


class StepGraphs:
    """Static buffers, and on CUDA the captured graphs, of one engine's or
    one model's decode steps (see the module docstring)."""

    def __init__(self, device, name="graphs"):
        self.device = torch.device(device)
        self.name = name
        self.buffers: dict[str, torch.Tensor] = {}
        self._graphs = {}              # key -> (CUDAGraph, counts, kept)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
            self._broken = []          # graphs of failed captures

    def buffer(self, name, shape, dtype):
        """The static buffer ``name``, zeroed when first made. A buffer is
        never reallocated: asking for it again at another shape or dtype
        raises."""
        buf = self.buffers.get(name)
        if buf is None:
            buf = self.buffers[name] = torch.zeros(
                shape, dtype=dtype, device=self.device)
        elif tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            raise ValueError(
                f"static buffer {name!r} is {tuple(buf.shape)} {buf.dtype}; "
                f"asked for {tuple(shape)} {dtype}")
        return buf

    def __contains__(self, key):
        return key in self._graphs

    def capture(self, key, fn, signature=None, before_capture=None):
        """Run ``fn`` once on the capture stream, then capture it as the
        graph ``key``. ``fn`` runs twice on the buffers' current values
        (the warm-up really runs, the capture records), so the caller puts
        them in a state where a step's writes do no harm. Raises what the
        capture raised. ``signature`` (default ``key``) is what the compile
        watcher tells this set's captures apart by. ``before_capture``,
        when given, is called between the warm-up (synchronized) and the
        capture: a train step frees the warm-up's cached blocks there and
        checks what the capture needs."""
        if not self.cuda:
            raise RuntimeError("CUDA graphs need a CUDA device; on the CPU "
                               "the step function runs as it is")
        t0 = time.perf_counter()
        with CAPTURE_LOCK:
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                fn()
            torch.cuda.synchronize(self.device)
            if before_capture is not None:
                before_capture()
            graph = torch.cuda.CUDAGraph()
            before = [dict(c) for c in _build.COUNTERS]
            try:
                with torch.cuda.stream(self.stream):
                    graph.capture_begin(self.pool)
                    try:
                        fn()
                    except BaseException:
                        self._abandon(graph)
                        raise
                    graph.capture_end()
            finally:
                counts = _take_back(before)
            cur.wait_stream(self.stream)
        # the kernels' ticket buffers of the capture stream, as the graph
        # knows them: a later launch there may replace one with a larger
        # buffer, and this graph keeps writing the old one
        kept = [buf for (_, s), buf in _build._TICKETS.items()
                if s == self.stream.cuda_stream]
        self._graphs[key] = (graph, counts, kept)
        _cw.note_capture(self.name, key if signature is None else signature,
                         time.perf_counter() - t0)

    def _abandon(self, graph):
        """End a capture that ``fn`` broke; the caller raises ``fn``'s
        error. An invalidated capture may leave the allocator routing the
        pool's allocations for it (PyTorch ends that only after a
        successful end of capture), and a later capture into the same pool
        would be refused: that routing is ended here where it can be, the
        broken graph is kept alive (the allocator's routing rule refers to
        it) and the set's later captures go to a fresh pool."""
        try:
            graph.capture_end()
        except RuntimeError:
            pass            # the capture is void; fn's error is raised
        dev = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        try:
            torch._C._cuda_endAllocateToPool(dev, self.pool)
        except RuntimeError:
            pass            # nothing was left routing
        self._broken.append(graph)
        self.pool = torch.cuda.graph_pool_handle()

    def replay(self, key):
        """Launch graph ``key`` on the current stream."""
        graph, counts, _ = self._graphs[key]
        graph.replay()
        _add(counts)
