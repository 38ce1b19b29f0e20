"""DataLoader (port of the reference package's ``io/dataloader.py``):
``default_collate_fn``, the thread prefetcher ``_PrefetchIter`` and
``DataLoader``.

The loader yields host batches, numpy arrays as in the reference; the
consumer moves each batch to its device once a step (``hapi.Model`` does,
to the network's device). ``num_workers > 0`` fetches batches on a pool
of threads, in order. Torch tensors among the samples are stacked as
numpy, but bfloat16 ones, which numpy cannot hold, as one host torch
tensor.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch):
    """Stack samples into batch arrays (reference:
    `io/dataloader/collate.py` ``default_collate_fn``)."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch, axis=0)
    if isinstance(sample, torch.Tensor):
        stacked = torch.stack([s.detach().cpu() for s in batch], dim=0)
        return stacked if stacked.dtype == torch.bfloat16 \
            else stacked.numpy()
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(fields))
                            for fields in zip(*batch))
    raise TypeError(f"batch data can't be collated: {type(sample)}")


class _PrefetchIter:
    """Thread-pool prefetching iterator (num_workers > 0)."""

    def __init__(self, loader, index_iter):
        self._loader = loader
        self._index_queue = queue.Queue()
        self._data_queue = queue.Queue(maxsize=max(
            2, loader.num_workers * loader.prefetch_factor))
        self._n_batches = 0
        for i, idxs in enumerate(index_iter):
            self._index_queue.put((i, idxs))
            self._n_batches += 1
        self._results = {}
        self._next = 0
        self._stop = threading.Event()
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True)
            for _ in range(loader.num_workers)]
        for w in self._workers:
            w.start()

    def _worker_loop(self):
        while not self._stop.is_set():
            try:
                i, idxs = self._index_queue.get_nowait()
            except queue.Empty:
                return
            try:
                item = (i, self._loader._fetch(idxs), None)
            except Exception as e:  # propagate to consumer
                item = (i, None, e)
            # bounded put must stay interruptible: a worker stuck in a
            # blocking put outlives an abandoned iterator and crashes
            # interpreter teardown (runtime destructors vs live threads)
            while not self._stop.is_set():
                try:
                    self._data_queue.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self):
        """Stop workers; safe to call repeatedly (StopIteration, __del__,
        and abandoned partially-consumed iterators all land here)."""
        self._stop.set()
        while True:  # unblock any worker parked on a full queue
            try:
                self._data_queue.get_nowait()
            except queue.Empty:
                break
        for w in self._workers:
            if w.is_alive():
                w.join(timeout=1.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        if self._next >= self._n_batches:
            self.close()
            raise StopIteration
        while self._next not in self._results:
            i, batch, err = self._data_queue.get()
            if err is not None:
                self.close()
                raise err
            self._results[i] = batch
        out = self._results.pop(self._next)
        self._next += 1
        return out


class DataLoader:
    """The reference's ``DataLoader`` signature; ``places``,
    ``use_buffer_reader``, ``use_shared_memory``, ``timeout``,
    ``worker_init_fn`` and ``persistent_workers`` are accepted and change
    nothing, as in the reference."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = prefetch_factor
        self.return_list = return_list
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            if batch_sampler is not None or shuffle:
                raise ValueError(
                    "IterableDataset does not support batch_sampler/shuffle")
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
            self.drop_last = batch_sampler.drop_last
        else:
            if batch_size is None:
                self.batch_sampler = None
                self.batch_size = None
                self.drop_last = False
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)
                self.batch_size = batch_size
                self.drop_last = drop_last

    def _fetch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            if self.batch_size is None:
                yield sample
                continue
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.batch_sampler is None:  # unbatched indexing
            return (self.dataset[i] for i in range(len(self.dataset)))
        if self.num_workers > 0:
            return _PrefetchIter(self, iter(self.batch_sampler))
        return (self._fetch(idxs) for idxs in self.batch_sampler)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)
