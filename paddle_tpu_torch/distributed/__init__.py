from . import rpc  # noqa: F401  (control-plane RPC over TCPStore)
from ..native import TCPStore  # noqa: F401  (C++ rendezvous store)
from .checkpoint import load_state_dict, save_state_dict
from .checkpoint_manager import CheckpointManager
from .recompute import recompute
from .watchdog import (  # noqa: F401
    ElasticManager, FileStore, StaleEpochError, StepWatchdog,
)

__all__ = ["recompute", "save_state_dict", "load_state_dict",
           "CheckpointManager", "TCPStore", "StepWatchdog", "ElasticManager",
           "FileStore", "StaleEpochError"]
