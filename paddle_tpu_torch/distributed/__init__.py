"""``paddle_tpu_torch.distributed``: one process per rank over
``torch.distributed``, with the reference's global-view API (meshes,
placements, collectives, tensor / data / expert parallelism, fleet) on
``DTensor`` and ``DeviceMesh``; plus the checkpoint, rpc, store and
watchdog pieces."""

from . import rpc  # noqa: F401  (control-plane RPC over TCPStore)
from ..native import TCPStore  # noqa: F401  (C++ rendezvous store)
from .process_mesh import ProcessMesh, get_mesh, set_mesh, init_mesh
from .placement import Placement, Shard, Replicate, Partial
from .api import (shard_tensor, dtensor_from_fn, reshard, shard_layer,
                  shard_optimizer, unshard_dtensor, to_partition_spec)
from .collective import (ReduceOp, Group, new_group, get_group, all_reduce,
                         all_gather, all_gather_object, reduce_scatter,
                         alltoall, broadcast, reduce, scatter, barrier, send,
                         recv, isend, irecv, wait)
from .env import (init_parallel_env, get_rank, get_world_size, ParallelEnv,
                  is_initialized)
from .mp_layers import (ColumnSequenceParallelLinear,
                        RowSequenceParallelLinear, ColumnParallelLinear,
                        RowParallelLinear, VocabParallelEmbedding,
                        ParallelCrossEntropy)
from . import collective  # noqa: F401
from . import p2p  # noqa: F401
from . import fleet  # noqa: F401
from .parallel import DataParallel, shard_dataloader, ShardDataloader
from .checkpoint import load_state_dict, save_state_dict
from .checkpoint_manager import CheckpointManager
from .recompute import recompute
from .watchdog import (  # noqa: F401
    ElasticManager, FileStore, StaleEpochError, StepWatchdog,
)

__all__ = [
    "TCPStore",
    "ProcessMesh", "get_mesh", "set_mesh", "init_mesh",
    "Placement", "Shard", "Replicate", "Partial",
    "shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
    "shard_optimizer", "unshard_dtensor", "to_partition_spec",
    "ReduceOp", "Group", "new_group", "get_group", "all_reduce",
    "all_gather", "all_gather_object", "reduce_scatter", "alltoall",
    "broadcast", "reduce", "scatter", "barrier", "send", "recv",
    "isend", "irecv", "wait",
    "init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
    "is_initialized", "CheckpointManager",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelCrossEntropy", "p2p",
    "recompute", "save_state_dict", "load_state_dict", "StepWatchdog",
    "ElasticManager", "FileStore", "StaleEpochError", "DataParallel",
    "shard_dataloader", "ShardDataloader", "ColumnSequenceParallelLinear",
    "RowSequenceParallelLinear", "fleet", "collective",
]
