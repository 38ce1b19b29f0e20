"""``fleet``, the hybrid-parallel orchestration API (port of the
reference package's ``distributed/fleet/__init__.py``).

The N-D rank topology is a :class:`~paddle_tpu_torch.distributed
.ProcessMesh` in the reference's axis order (pp, mp, sep, sharding, dp),
each axis of more than one rank kept. ``fleet.init`` starts this rank's
process group (:func:`~paddle_tpu_torch.distributed.init_parallel_env`),
builds the mesh from the strategy's degrees over the world and sets it
as the global mesh; :class:`HybridCommunicateGroup` answers where this
rank sits on each axis and hands out each axis's process group.
``distributed_model`` wraps the model in ``DataParallel`` when the
topology has a dp axis of more than one rank; ``distributed_optimizer``
is ``shard_optimizer``.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ..env import get_rank, get_world_size, init_parallel_env
from ..process_mesh import ProcessMesh, set_mesh
from ..recompute import recompute as _recompute_fn

__all__ = ["DistributedStrategy", "HybridCommunicateGroup", "Fleet",
           "init", "fleet", "build_topology", "utils", "recompute"]


class utils:
    """The ``fleet.utils`` namespace: ``recompute`` lives here in the
    reference's public API."""
    recompute = staticmethod(_recompute_fn)


recompute = _recompute_fn


class DistributedStrategy:
    """The parallel degrees and the reference's other knobs (accepted and
    kept; only the degrees shape the topology)."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 0,   # 0 = the rest of the world
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.gradient_merge = False
        self.pipeline = False
        self.find_unused_parameters = False


def build_topology(strategy=None, world_size=None):
    """The strategy's degrees -> a ProcessMesh over ``world_size`` ranks
    (default: the started world) in the reference's axis order, size-1
    axes dropped; an unset dp degree takes the rest of the world."""
    if world_size is not None:
        world = world_size
    else:
        world = dist.get_world_size() if dist.is_initialized() else 1
    cfg = (strategy or DistributedStrategy()).hybrid_configs
    degrees = [("pp", cfg.get("pp_degree", 1)),
               ("mp", cfg.get("mp_degree", 1)),
               ("sep", cfg.get("sep_degree", 1)),
               ("sharding", cfg.get("sharding_degree", 1)),
               ("dp", cfg.get("dp_degree", 0) or 0)]
    known = 1
    for name, d in degrees[:-1]:
        known *= max(1, d)
    dp = degrees[-1][1]
    if not dp:
        if world % known:
            raise ValueError(
                f"world size {world} not divisible by configured degrees "
                f"(product {known})")
        dp = world // known
    total = known * dp
    if total != world:
        raise ValueError(
            f"degrees multiply to {total} but world size is {world}")
    names, shape = [], []
    for name, d in degrees[:-1] + [("dp", dp)]:
        d = max(1, d)
        if d > 1:
            names.append(name)
            shape.append(d)
    if not names:
        names, shape = ["dp"], [1]
    return ProcessMesh(np.arange(world).reshape(shape), dim_names=names)


class HybridCommunicateGroup:
    """Where this rank sits on each axis of the mesh, and each axis's
    process group (None without a world)."""

    def __init__(self, mesh: ProcessMesh):
        self._mesh = mesh

    @property
    def topology(self):
        return self._mesh

    def _axis_rank(self, axis):
        if axis not in self._mesh.dim_names:
            return 0
        return max(0, self._mesh.axis_rank(axis))

    def _axis_size(self, axis):
        if axis not in self._mesh.dim_names:
            return 1
        return self._mesh.get_dim_size(axis)

    def _axis_group(self, axis):
        if axis not in self._mesh.dim_names or not dist.is_initialized():
            return None
        return self._mesh.get_group(axis)

    def get_data_parallel_rank(self):
        return self._axis_rank("dp")

    def get_data_parallel_world_size(self):
        return self._axis_size("dp")

    def get_data_parallel_group(self):
        return self._axis_group("dp")

    def get_model_parallel_rank(self):
        return self._axis_rank("mp")

    def get_model_parallel_world_size(self):
        return self._axis_size("mp")

    def get_model_parallel_group(self):
        return self._axis_group("mp")

    def get_stage_id(self):
        return self._axis_rank("pp")

    def get_pipe_parallel_world_size(self):
        return self._axis_size("pp")

    def get_sharding_parallel_rank(self):
        return self._axis_rank("sharding")

    def get_sharding_parallel_world_size(self):
        return self._axis_size("sharding")


class Fleet:
    """The reference's ``Fleet``."""

    def __init__(self):
        self._strategy = None
        self._hcg = None
        self._mesh = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             device=None):
        """Start the world if it is not (``device`` picks the backend, as
        ``init_parallel_env``'s does), build and set the mesh."""
        self._strategy = strategy or DistributedStrategy()
        init_parallel_env(device=device)
        self._mesh = build_topology(self._strategy)
        set_mesh(self._mesh)
        self._hcg = HybridCommunicateGroup(self._mesh)
        return self

    @property
    def strategy(self):
        return self._strategy

    def get_hybrid_communicate_group(self):
        return self._hcg

    def mesh(self):
        return self._mesh

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_first_worker(self):
        return get_rank() == 0

    def distributed_model(self, model):
        from ..parallel import DataParallel
        if self._mesh is not None and "dp" in self._mesh.dim_names \
                and self._mesh.get_dim_size("dp") > 1:
            return DataParallel(model, mesh=self._mesh, dp_axis="dp")
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        from ..api import shard_optimizer
        return shard_optimizer(optimizer)

    def is_worker(self):
        """Collective mode has no parameter-server roles."""
        return True

    def barrier_worker(self):
        from ..collective import barrier
        barrier()


fleet = Fleet()


def init(role_maker=None, is_collective=True, strategy=None, device=None):
    return fleet.init(role_maker, is_collective, strategy, device)


def distributed_model(model):
    return fleet.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def get_hybrid_communicate_group():
    return fleet.get_hybrid_communicate_group()


def worker_index():
    return fleet.worker_index()


def worker_num():
    return fleet.worker_num()


def is_first_worker():
    return fleet.is_first_worker()


def is_worker():
    return fleet.is_worker()


def barrier_worker():
    return fleet.barrier_worker()


class PaddleCloudRoleMaker:
    """The reference's role marker: collective mode reads ranks from the
    environment, so it only carries ``is_collective``."""

    def __init__(self, is_collective=True, **kwargs):
        self.is_collective = is_collective


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective=True, init_gloo=False, **kwargs):
        super().__init__(is_collective)


__all__ += ["distributed_model", "distributed_optimizer",
            "get_hybrid_communicate_group", "worker_index", "worker_num",
            "is_first_worker", "is_worker", "barrier_worker",
            "PaddleCloudRoleMaker", "UserDefinedRoleMaker"]
