"""``io``: datasets, samplers, the ``DataLoader`` and the token feeds
(port of the reference package's ``io``)."""

from .dataloader import DataLoader, default_collate_fn
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
from .token_feed import DevicePrefetcher, PyTokenFeed, TokenFeed


class WorkerInfo:
    """The reference's ``WorkerInfo``. The thread-pool loader has no
    per-worker dataset copies, so a single-worker view is always
    reported (id 0 of ``num_workers``)."""

    def __init__(self, id=0, num_workers=1, dataset=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def get_worker_info():
    """None in the main process (always: the workers are threads sharing
    the dataset object)."""
    return None


__all__ = [
    "TokenFeed", "PyTokenFeed", "DevicePrefetcher",
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "SubsetRandomSampler", "BatchSampler", "DistributedBatchSampler",
    "DataLoader", "default_collate_fn", "get_worker_info", "WorkerInfo",
]
