"""Samplers (port of the reference package's ``io/sampler.py``):
``Sampler``, ``SequenceSampler``, ``RandomSampler``,
``WeightedRandomSampler``, ``SubsetRandomSampler``, ``BatchSampler``,
``DistributedBatchSampler``.

A copy but for two seeds. ``RandomSampler`` shuffles with numpy seeded by
an int ``generator``, as the reference does, so the orders are equal for
an int; otherwise its seed is drawn from the ``torch.Generator`` passed
as ``generator`` or from torch's default generator (so ``torch.manual_seed``
governs the order), where the reference takes the next key of its own
global stream (ROADMAP, stated differences). ``DistributedBatchSampler``
without ``num_replicas`` / ``rank`` reads them from an initialized
``torch.distributed`` process group, else from ``PADDLE_TRAINERS_NUM`` /
``PADDLE_TRAINER_ID`` (default one process, rank 0).
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "SubsetRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]


def _process_env():
    """``(world size, rank)`` of this process."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return (int(os.environ.get("PADDLE_TRAINERS_NUM", "1")),
            int(os.environ.get("PADDLE_TRAINER_ID", "0")))


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        if not replacement and num_samples is not None and \
                num_samples > len(data_source):
            raise ValueError(
                "num_samples cannot exceed dataset size without replacement")

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None \
            else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if isinstance(self.generator, int):
            seed = self.generator
        else:
            g = self.generator
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=g,
                                     device=None if g is None else g.device))
        rng = np.random.default_rng(seed)
        if self.replacement:
            yield from rng.integers(0, n, size=self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        if (self.weights < 0).any():
            raise ValueError("weights must be non-negative")
        self.num_samples = num_samples
        self.replacement = replacement
        if not replacement and num_samples > len(self.weights):
            raise ValueError(
                "num_samples cannot exceed len(weights) without replacement")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), size=self.num_samples,
                               replace=self.replacement, p=p)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        super().__init__(None)
        self.indices = list(indices)

    def __iter__(self):
        for i in np.random.permutation(len(self.indices)).tolist():
            yield self.indices[i]

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    """Reference: batch_sampler.py ``BatchSampler``."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if dataset is None and sampler is None:
            raise ValueError("either dataset or sampler must be given")
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        if batch_size <= 0:
            raise ValueError("batch_size should be a positive integer")
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-sliced batch sampler (reference: batch_sampler.py
    ``DistributedBatchSampler``): pads the index list so every rank sees the
    same number of batches, then strides by rank."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        if batch_size <= 0:
            raise ValueError("batch_size should be a positive integer")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            world, me = _process_env()
            num_replicas = num_replicas or world
            rank = rank if rank is not None else me
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(len(indices)).tolist()
        # pad to be evenly divisible across ranks
        indices += indices[:(self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
