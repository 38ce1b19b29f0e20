"""The pretraining input path (port of the reference package's
``io/token_feed.py``): the token-corpus feed and the asynchronous
host-to-device prefetch.

``TokenFeed(path, sample_elems, batch_size)`` iterates ``[batch,
sample_elems]`` numpy batches over a flat binary corpus of fixed-size
samples: the native C++ feed (:class:`paddle_tpu_torch.native.TokenFeed`,
``native/src/data_feed.cc``) when its library builds, else
:class:`PyTokenFeed`, which serves the same contract from ``np.memmap``.
Both visit each full sample once an epoch, drop the last partial batch,
stop after ``epochs`` epochs when it is positive, and shuffle per epoch
from ``seed`` (the native feed with mt19937, the numpy one with
``RandomState(seed + epoch)``, so the two orders differ).

:class:`DevicePrefetcher` moves the batches onto the card from a worker
thread. Its device work (pinning, the copy, the event) holds
:data:`paddle_tpu_torch.ops._graphs.CAPTURE_LOCK`, as the host KV tier's
does: a CUDA-graph capture (a compiled train step's first full-shape
call) holds the same lock, so no allocation or copy of the worker's
lands inside a capture in CUDA's global capture mode.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from .. import native as _native
from ..device import resolve_device

__all__ = ["TokenFeed", "PyTokenFeed", "DevicePrefetcher"]


class PyTokenFeed:
    """Pure-numpy feed with the native feed's contract (each full sample
    once an epoch, drop-last, ``epochs``, a per-epoch order from
    ``seed``); its shuffle is ``RandomState(seed + epoch)``, not the
    native feed's mt19937."""

    def __init__(self, path, sample_elems, batch_size, dtype=np.int32,
                 shuffle=True, seed=0, prefetch_depth=4, epochs=-1):
        self.dtype = np.dtype(dtype)
        self.sample_elems = int(sample_elems)
        self.batch_size = int(batch_size)
        data = np.memmap(path, dtype=self.dtype, mode="r")
        n = data.size // self.sample_elems
        if n < self.batch_size:
            raise ValueError(
                f"TokenFeed: cannot open {path!r} (too small for one "
                f"batch of {batch_size} x {sample_elems} {self.dtype})")
        self._data = data[:n * self.sample_elems].reshape(
            n, self.sample_elems)
        self.shuffle, self.seed = shuffle, seed
        self.epochs = epochs
        self._epoch = 0
        self._step = 0
        self._order = self._epoch_order()

    @property
    def num_samples(self):
        return self._data.shape[0]

    @property
    def batches_per_epoch(self):
        return self.num_samples // self.batch_size

    def _epoch_order(self):
        if not self.shuffle:
            return np.arange(self.num_samples)
        return np.random.RandomState(
            self.seed + self._epoch).permutation(self.num_samples)

    def __iter__(self):
        return self

    def __next__(self):
        if self._step >= self.batches_per_epoch:
            self._epoch += 1
            if self.epochs > 0 and self._epoch >= self.epochs:
                raise StopIteration
            self._step = 0
            self._order = self._epoch_order()
        idx = self._order[self._step * self.batch_size:
                          (self._step + 1) * self.batch_size]
        self._step += 1
        return np.ascontiguousarray(self._data[idx])

    def close(self):
        pass


def TokenFeed(path, sample_elems, batch_size, dtype=np.int32, shuffle=True,
              seed=0, prefetch_depth=4, epochs=-1):
    """The native prefetching feed when its library builds, else
    :class:`PyTokenFeed`. Both yield ``[batch_size, sample_elems]``
    arrays."""
    cls = _native.TokenFeed if _native.available() else PyTokenFeed
    return cls(path, sample_elems, batch_size, dtype=dtype, shuffle=shuffle,
               seed=seed, prefetch_depth=prefetch_depth, epochs=epochs)


def _map_arrays(fn, item):
    if isinstance(item, np.ndarray):
        return fn(item)
    if isinstance(item, (tuple, list)):
        return type(item)(_map_arrays(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _map_arrays(fn, v) for k, v in item.items()}
    return item


def _tensors(item):
    if isinstance(item, torch.Tensor):
        return [item]
    if isinstance(item, (tuple, list)):
        return [t for x in item for t in _tensors(x)]
    if isinstance(item, dict):
        return [t for x in item.values() for t in _tensors(x)]
    return []


class DevicePrefetcher:
    """Double-buffered host-to-device prefetch over any iterator of host
    batches (numpy arrays, or tuples, lists and dicts of them).

    A worker thread pulls the next batch from ``source``, applies
    ``transform`` (e.g. split ``[B, S+1]`` ids into ``(ids, labels)``),
    and moves every array onto ``device`` (default ``cuda``). On the
    card each array is staged in pinned host memory and copied with
    ``non_blocking`` on a side stream; the consumer's stream waits on
    the copy's event before it touches the batch, so the next batch's
    host work and copy overlap the current step. On the CPU the arrays
    become tensors directly.

    ``depth`` bounds the queue (default 2). Iteration ends when
    ``source`` does; a source or transform exception re-raises in the
    consumer, and every later ``next`` raises it again.

    :meth:`mark` returns ``(stall_seconds, wall_seconds)`` since the
    previous mark: the time the consumer spent blocked waiting for a
    batch against wall time.
    """

    def __init__(self, source, transform=None, depth=2, device=None):
        self._device = resolve_device(device)
        self._stream = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" else None
        self._transform = transform
        self._src = iter(source)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._stall = 0.0
        self._mark_stall = 0.0
        self._mark_t = time.perf_counter()
        self._terminal = None   # sticky: StopIteration or the source error
        self.batches = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def _to_device(self, item):
        if self._stream is None:
            return _map_arrays(
                lambda a: torch.from_numpy(np.array(a, copy=True)), item), None
        from ..ops._graphs import CAPTURE_LOCK
        with CAPTURE_LOCK, torch.cuda.stream(self._stream):
            out = _map_arrays(
                lambda a: torch.from_numpy(np.ascontiguousarray(a))
                .pin_memory().to(self._device, non_blocking=True), item)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _enqueue(self, entry):
        """put with a stop-aware timeout, so close() never deadlocks on a
        full queue with no consumer."""
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            while not self._stop.is_set():
                try:
                    item = next(self._src)
                except StopIteration:
                    self._enqueue(("end", None))
                    return
                if self._transform is not None:
                    item = self._transform(item)
                if not self._enqueue(("ok", self._to_device(item))):
                    return
        except Exception as e:  # surface in the consumer, not the log
            self._enqueue(("err", e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._terminal is not None:
            raise self._terminal
        if self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        kind, payload = self._q.get()
        self._stall += time.perf_counter() - t0
        if kind == "end":
            self._terminal = StopIteration()
            raise self._terminal
        if kind == "err":
            self._terminal = payload
            raise payload
        batch, ready = payload
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            # memory made on the side stream is now used on this one
            for t in _tensors(batch):
                t.record_stream(consumer)
        self.batches += 1
        return batch

    def mark(self):
        """``(stall_seconds, wall_seconds)`` since the previous mark."""
        now = time.perf_counter()
        stall = self._stall - self._mark_stall
        wall = max(now - self._mark_t, 1e-9)
        self._mark_stall = self._stall
        self._mark_t = now
        return stall, wall

    def close(self):
        self._stop.set()
        # drain so a worker blocked on put can observe the stop
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        src_close = getattr(self._src, "close", None)
        if callable(src_close):
            src_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
