from . import rpc  # noqa: F401  (control-plane RPC over TCPStore)
from ..native import TCPStore  # noqa: F401  (C++ rendezvous store)
from .recompute import recompute
from .watchdog import (  # noqa: F401
    ElasticManager, FileStore, StaleEpochError, StepWatchdog,
)

__all__ = ["recompute", "TCPStore", "StepWatchdog", "ElasticManager",
           "FileStore", "StaleEpochError"]
