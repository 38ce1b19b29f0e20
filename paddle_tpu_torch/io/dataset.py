"""Datasets (port of the reference package's ``io/dataset.py``, a
copy): ``Dataset``, ``IterableDataset``, ``TensorDataset``,
``ComposeDataset``, ``ChainDataset``, ``ConcatDataset``, ``Subset``,
``random_split``. A ``TensorDataset`` takes torch tensors or numpy
arrays alike.
"""

from __future__ import annotations

import bisect
import itertools

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    """Map-style dataset: implement ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError(
            "'{}' not implement in class {}".format("__getitem__",
                                                    self.__class__.__name__))

    def __len__(self):
        raise NotImplementedError(
            "'{}' not implement in class {}".format("__len__",
                                                    self.__class__.__name__))


class IterableDataset(Dataset):
    """Iterable-style dataset: implement ``__iter__``."""

    def __iter__(self):
        raise NotImplementedError(
            "'{}' not implement in class {}".format("__iter__",
                                                    self.__class__.__name__))

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset does not support len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lengths = {len(t) for t in tensors}
        if len(lengths) > 1:
            raise ValueError("tensors must have the same first dimension")
        self.tensors = tensors

    def __getitem__(self, index):
        return tuple(t[index] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    """Zip datasets: sample i is the concatenation of each dataset's sample i."""

    def __init__(self, datasets):
        if not datasets:
            raise ValueError("datasets must not be empty")
        self.datasets = list(datasets)
        lengths = {len(d) for d in self.datasets}
        if len(lengths) > 1:
            raise ValueError("datasets must have the same length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            s = d[idx]
            sample.extend(s if isinstance(s, (list, tuple)) else [s])
        return tuple(sample)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets should not be an empty iterable")
        sizes = [len(d) for d in self.datasets]
        self.cumulative_sizes = list(itertools.accumulate(sizes))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            if -idx > len(self):
                raise ValueError("index out of range")
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        if ds_idx > 0:
            idx = idx - self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Reference: dataset.py ``random_split``; fractional lengths supported."""
    if all(isinstance(l, float) for l in lengths) and \
            abs(sum(lengths) - 1.0) < 1e-6:
        n = len(dataset)
        sizes = [int(np.floor(n * frac)) for frac in lengths]
        for i in range(n - sum(sizes)):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    if sum(lengths) != len(dataset):
        raise ValueError(
            "Sum of input lengths does not equal the length of the dataset!")
    rng = np.random.default_rng(
        generator if isinstance(generator, (int, type(None))) else None)
    perm = rng.permutation(sum(lengths)).tolist()
    out, offset = [], 0
    for length in lengths:
        out.append(Subset(dataset, perm[offset:offset + length]))
        offset += length
    return out
