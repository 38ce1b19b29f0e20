"""``ProcessMesh`` over torch's ``DeviceMesh`` (port of the reference
package's ``distributed/process_mesh.py``).

A mesh is an integer array of ranks with a name per axis ('dp', 'fsdp',
'mp', 'ep', ...). Its metadata needs no process group. The reference's
method that materializes its device mesh becomes
:meth:`ProcessMesh.to_device_mesh`: the ``DeviceMesh`` of the started
world (``cuda`` under NCCL, ``cpu`` under
gloo), with one process group per axis, cached on the world as the
reference caches its mesh on the visible devices. Building it is a
collective call: every rank of the world builds the same meshes in the
same order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ProcessMesh", "get_mesh", "set_mesh", "init_mesh"]

_global_mesh = None


def _world_key():
    if not dist.is_initialized():
        return None
    return (id(dist.group.WORLD), dist.get_world_size(), dist.get_backend())


class ProcessMesh:
    def __init__(self, mesh, dim_names=None, process_ids=None):
        arr = np.asarray(mesh)
        if arr.dtype.kind not in "iu":
            raise TypeError("mesh must be an integer array of process ids")
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(
                f"dim_names {dim_names} does not match mesh rank {arr.ndim}")
        self._ids = arr
        self._dim_names = list(dim_names)
        self._device_mesh = None
        self._device_mesh_key = None

    # -- the reference's surface --------------------------------------------
    @property
    def shape(self):
        return list(self._ids.shape)

    @property
    def ndim(self):
        return self._ids.ndim

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return self._ids.reshape(-1).tolist()

    @property
    def mesh(self):
        return self._ids

    def get_dim_size(self, name):
        return self._ids.shape[self._dim_names.index(name)]

    def get_rank_by_dim_and_process_id(self, dim, process_id):
        axis = self._dim_names.index(dim) if isinstance(dim, str) else dim
        pos = np.argwhere(self._ids == process_id)
        return int(pos[0][axis]) if len(pos) else -1

    def __eq__(self, other):
        return isinstance(other, ProcessMesh) and \
            np.array_equal(self._ids, other._ids) and \
            self._dim_names == other._dim_names

    def __hash__(self):
        return hash((self._ids.tobytes(), tuple(self._dim_names)))

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, "
                f"dim_names={self._dim_names})")

    # -- the torch bridge ---------------------------------------------------
    def to_device_mesh(self):
        """The ``DeviceMesh`` of this mesh over the started world, where
        the reference materializes its own device mesh. Rebuilt when the
        world changes; raises with no process group or past the world's
        ranks."""
        key = _world_key()
        if key is None:
            raise RuntimeError(
                "a ProcessMesh needs a process group: call "
                "paddle_tpu_torch.distributed.init_parallel_env() first")
        if self._device_mesh is None or self._device_mesh_key != key:
            from torch.distributed.device_mesh import DeviceMesh
            world = key[1]
            flat = self._ids.reshape(-1)
            if flat.max() >= world or flat.min() < 0:
                raise RuntimeError(
                    f"mesh references process id {int(flat.max())} but the "
                    f"world has {world} ranks")
            dev = "cuda" if key[2] == "nccl" else "cpu"
            self._device_mesh = DeviceMesh(
                dev, torch.as_tensor(self._ids, dtype=torch.int64),
                mesh_dim_names=tuple(self._dim_names))
            self._device_mesh_key = key
        return self._device_mesh

    def get_group(self, name):
        """The process group of axis ``name`` that holds this rank."""
        return self.to_device_mesh().get_group(name)

    def axis_rank(self, name):
        """This rank's coordinate on axis ``name`` (0 with no world)."""
        if not dist.is_initialized():
            return 0
        return self.get_rank_by_dim_and_process_id(name, dist.get_rank())

    def __enter__(self):
        self._saved = get_mesh()
        set_mesh(self)
        return self

    def __exit__(self, *exc):
        set_mesh(self._saved)
        return False


def init_mesh(shape, dim_names):
    """A ProcessMesh over ranks ``0 .. prod(shape) - 1``."""
    n = int(np.prod(shape))
    return ProcessMesh(np.arange(n).reshape(shape), dim_names)


def set_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh


def get_mesh():
    return _global_mesh
