from .paged_cache import PageAllocator, PagedKVCache
from .prefix_cache import PrefixCache
from .sampling import GREEDY, SamplingParams
from .serving import (AdmissionError, DeadlineExceeded, LlamaServingEngine,
                      Request)
from .speculative import NGramDrafter

__all__ = ["PageAllocator", "PagedKVCache", "PrefixCache", "GREEDY",
           "SamplingParams", "AdmissionError", "DeadlineExceeded",
           "LlamaServingEngine", "Request", "NGramDrafter",
           "ServingCluster", "EngineReplica", "SubprocessReplica",
           "ClusterRequest", "ReplicaLostError", "StaleEpochError",
           "ServingFrontend", "ByteTokenizer", "QosGate", "Tenant",
           "replica_main"]

#: the serving stack over the engine, loaded on first use (as the
#: reference's package does)
_LAZY = {
    "ServingCluster": "cluster", "EngineReplica": "cluster",
    "SubprocessReplica": "cluster", "ReplicaLostError": "cluster",
    "StaleEpochError": "cluster", "ClusterRequest": "cluster",
    "replica_main": "replica_worker",
    "ServingFrontend": "frontend", "ByteTokenizer": "frontend",
    "QosGate": "qos", "Tenant": "qos",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
