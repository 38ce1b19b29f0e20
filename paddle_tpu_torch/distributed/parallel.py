"""``DataParallel`` and ``shard_dataloader`` (port of the reference
package's ``distributed/parallel.py``).

The reference's ``DataParallel`` commits each input's batch dim to the
dp axis and lets GSPMD keep the activations sharded and emit one
gradient reduction per parameter. The port keeps the same global view
with one process per rank: each rank runs the wrapped layer on its block
of the batch, the output is gathered back to the global batch (so the
caller's loss, written for the whole batch, is the same value on every
rank), and each parameter's gradient, this rank's rows' term of the
global loss's gradient, is summed over the dp group exactly once, by a
hook that runs when backward has accumulated it. The optimizer then
steps on the global batch's gradient on every rank.

``shard_dataloader`` lays each batch out over the mesh (a ``DTensor``
split on dim 0 over the chosen axis), as the reference commits it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .api import is_dtensor, shard_tensor
from .placement import Replicate, Shard
from .plan import _block, _gather_dim
from .process_mesh import ProcessMesh

__all__ = ["DataParallel", "shard_dataloader", "ShardDataloader"]


def _default_mesh():
    world = dist.get_world_size() if dist.is_initialized() else 1
    return ProcessMesh(np.arange(world), dim_names=["dp"])


class _GatherBatch(torch.autograd.Function):
    """The dp ranks' output blocks concatenated on dim 0; backward, this
    rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, y, pg):
        ctx.pg = pg
        return _gather_dim(y, 0, pg)

    @staticmethod
    def backward(ctx, g):
        return _block(g, 0, ctx.pg), None


class DataParallel:
    """Wraps a layer: forward inputs split on the batch dim over
    ``dp_axis``, outputs gathered back, gradients summed over the dp
    group once each (module docstring). Attributes the wrapper lacks come
    from the wrapped layer (``parameters()``, ``train()``,
    ``state_dict()``, ...), as in the reference."""

    def __init__(self, layers, mesh=None, dp_axis="dp",
                 find_unused_parameters=False, **kwargs):
        self._layers = layers
        self._mesh = mesh if mesh is not None else _default_mesh()
        self._dp_axis = dp_axis
        if dp_axis not in self._mesh.dim_names:
            raise ValueError(f"mesh has no axis {dp_axis!r}")
        self._pg = None
        if dist.is_initialized():
            self._pg = self._mesh.get_group(dp_axis)
            if dist.get_world_size(self._pg) > 1:
                for p in layers.parameters():
                    if p.requires_grad:
                        p.register_post_accumulate_grad_hook(self._sum_grad)

    def _sum_grad(self, p):
        dist.all_reduce(p.grad, group=self._pg)

    def _local_input(self, x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0 or \
                self._pg is None:
            return x
        if is_dtensor(x):
            return x.to_local()
        return _block(x, 0, self._pg)

    def forward(self, *inputs, **kwargs):
        inputs = tuple(self._local_input(i) for i in inputs)
        kwargs = {k: self._local_input(v) for k, v in kwargs.items()}
        out = self._layers(*inputs, **kwargs)
        if self._pg is None or dist.get_world_size(self._pg) == 1:
            return out
        if isinstance(out, torch.Tensor) and out.dim() > 0:
            return _GatherBatch.apply(out, self._pg)
        return out

    __call__ = forward

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def scale_loss(self, loss):
        """The reference's ``scale_loss``: the identity, the loss being
        the global batch's already."""
        return loss


class ShardDataloader:
    """Iterates a DataLoader, each batch laid out over the mesh (split on
    dim 0 over the chosen axis)."""

    def __init__(self, dataloader, meshes, shard_dims=0, input_keys=None):
        self._loader = dataloader
        self._mesh = meshes if isinstance(meshes, ProcessMesh) \
            else meshes[0]
        if isinstance(shard_dims, str):
            axis = shard_dims
        else:
            axis = self._mesh.dim_names[int(shard_dims)]
        self._input_keys = input_keys
        self._placements = [
            Shard(0) if n == axis else Replicate()
            for n in self._mesh.dim_names]

    def __len__(self):
        return len(self._loader)

    def _commit(self, item, key=None):
        if isinstance(item, dict):
            return {k: self._commit(v, key=k) for k, v in item.items()}
        if isinstance(item, (list, tuple)):
            elems = [self._commit(e, key=key) for e in item]
            if hasattr(item, "_fields"):     # namedtuple
                return type(item)(*elems)
            return type(item)(elems)
        t = item if isinstance(item, torch.Tensor) \
            else torch.as_tensor(np.asarray(item))
        if t.dim() == 0:
            return t
        if key is not None and self._input_keys is not None \
                and key not in self._input_keys:
            return t   # entries that are not inputs stay as they are
        return shard_tensor(t, self._mesh, self._placements,
                            stop_gradient=True)

    def __iter__(self):
        for batch in self._loader:
            yield self._commit(batch)


def shard_dataloader(dataloader, meshes, shard_dims=0, is_dataset=False,
                     input_keys=None):
    return ShardDataloader(dataloader, meshes, shard_dims, input_keys)
