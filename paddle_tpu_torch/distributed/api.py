"""The placement API: ``shard_tensor`` / ``reshard`` / ``shard_layer`` /
``shard_optimizer`` (port of the reference package's
``distributed/api.py``).

The reference commits a global array to a layout and GSPMD places every
op after it. The port keeps the global view with torch's ``DTensor``:
a placed tensor is a ``DTensor`` over the mesh's ``DeviceMesh``, whose
``shape`` is the global shape and whose local tensor is this rank's
shard. Every rank passes the same global value (the programs are SPMD),
and each keeps its own shard of it without communication. A placed
parameter stays an ``nn.Parameter``, so ``state_dict``, the optimizers
and :func:`shard_optimizer` see its global shape, as in the reference.
Ops that torch has a sharding rule for run on DTensors directly; the
port's hand-written kernels have none and refuse a DTensor: a layer runs
them on its local shards (see :mod:`~paddle_tpu_torch.distributed
.mp_layers`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .placement import Partial, Replicate, Shard, to_torch
from .process_mesh import ProcessMesh

__all__ = ["shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
           "shard_optimizer", "unshard_dtensor", "to_partition_spec"]


def is_dtensor(t):
    return type(t).__name__ == "DTensor"


def to_partition_spec(ndim, mesh, placements):
    """placements (one per MESH axis) -> the axis names per TENSOR
    dimension: a tuple whose entry is None, an axis name, or a tuple of
    names (two axes splitting one dimension), the reference's
    ``PartitionSpec`` as a tuple."""
    if len(placements) != mesh.ndim:
        raise ValueError(
            f"placements length {len(placements)} != mesh rank {mesh.ndim}")
    spec = [None] * ndim
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.get_dim()
            if d >= ndim:
                raise ValueError(
                    f"Shard(dim={d}) out of range for {ndim}-D tensor")
            name = mesh.dim_names[mesh_dim]
            if spec[d] is None:
                spec[d] = name
            elif isinstance(spec[d], tuple):
                spec[d] = spec[d] + (name,)
            else:
                spec[d] = (spec[d], name)
    return tuple(spec)


def _annotate(t, mesh, placements):
    t.is_dist = True
    t._process_mesh = mesh
    t._placements = list(placements)
    return t


def _as_tensor(data, dtype=None):
    if isinstance(data, torch.Tensor):
        return data if dtype is None else data.to(dtype)
    t = torch.as_tensor(np.asarray(data))
    return t if dtype is None else t.to(dtype)


def shard_tensor(data, mesh, placements, dtype=None, place=None,
                 stop_gradient=None):
    """A ``DTensor`` of ``data`` (the same global value on every rank)
    laid out over ``mesh`` by ``placements``; a parameter stays a
    parameter. ``Partial`` is refused: it comes only out of ops."""
    if not isinstance(mesh, ProcessMesh):
        raise TypeError("mesh must be a ProcessMesh")
    for p in placements:
        if isinstance(p, Partial):
            raise ValueError(
                "shard_tensor cannot materialize Partial placements; "
                "Partial arises only from op outputs")
    from torch.distributed.tensor import distribute_tensor
    src = _as_tensor(data, dtype)
    dm = mesh.to_device_mesh()
    local = src.detach().to(dm.device_type)
    if is_dtensor(local):
        local = local.full_tensor()
    out = distribute_tensor(local, dm, to_torch(placements),
                            src_data_rank=None)
    if isinstance(data, nn.Parameter):
        out = nn.Parameter(out, requires_grad=data.requires_grad)
    else:
        grad = src.requires_grad if stop_gradient is None \
            else not stop_gradient
        out.requires_grad_(grad and out.is_floating_point())
    return _annotate(out, mesh, placements)


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    """``fn(*args, **kwargs)`` placed by :func:`shard_tensor`."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def reshard(dist_tensor, mesh, placements):
    """``dist_tensor`` laid out anew (the collectives torch's
    ``redistribute`` picks); differentiable."""
    t = dist_tensor
    dm = mesh.to_device_mesh()
    if not is_dtensor(t):
        return shard_tensor(t, mesh, placements)
    if t.device_mesh is not dm:
        return shard_tensor(t.full_tensor(), mesh, placements)
    out = t.redistribute(dm, to_torch(placements))
    return _annotate(out, mesh, placements)


def unshard_dtensor(dist_tensor):
    """The whole global value as a plain tensor on every rank."""
    t = dist_tensor
    if not is_dtensor(t):
        return t
    return t.full_tensor()


def shard_layer(layer, process_mesh, shard_fn=None, input_fn=None,
                output_fn=None):
    """``shard_fn(name, sublayer, mesh)`` places each sublayer's
    parameters; whatever it leaves unplaced is replicated. ``input_fn``
    and ``output_fn`` become the layer's forward pre- and post-hooks."""
    if not isinstance(layer, nn.Module):
        raise TypeError("layer must be a torch.nn.Module")

    def _replicate_params(sub):
        repl = [Replicate()] * process_mesh.ndim
        for key, p in list(sub._parameters.items()):
            if p is not None and not is_dtensor(p):
                sub._parameters[key] = shard_tensor(p, process_mesh, repl)

    for name, sub in layer.named_modules():
        if shard_fn is not None:
            shard_fn(name, sub, process_mesh)
        _replicate_params(sub)

    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lay, inputs: input_fn(inputs, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda lay, inputs, outputs: output_fn(outputs, process_mesh))
    return layer


def shard_optimizer(optimizer, shard_fn=None):
    """Each accumulator of a placed parameter takes the parameter's
    layout (the port's optimizers already make them so, the way the
    reference's state inherits its parameter's sharding);
    ``shard_fn(acc_name, param, acc)`` may return another accumulator to
    use instead. Idempotent: a second call replaces ``shard_fn``."""
    from ..optimizer import Optimizer
    if not isinstance(optimizer, Optimizer):
        raise TypeError("expected a paddle_tpu_torch Optimizer")
    if getattr(optimizer, "_shard_fn_installed", False):
        optimizer._shard_fn = shard_fn
        return optimizer
    orig_add = optimizer._add_accumulator
    optimizer._shard_fn = shard_fn
    optimizer._shard_fn_installed = True

    def _add(name, param, **kw):
        acc = orig_add(name, param, **kw)
        if is_dtensor(param) and not is_dtensor(acc) and \
                tuple(acc.shape) == tuple(param.shape):
            from torch.distributed.tensor import distribute_tensor
            acc = distribute_tensor(acc, param.device_mesh, param.placements,
                                    src_data_rank=None)
            optimizer._accumulators[name][id(param)] = acc
        fn = optimizer._shard_fn
        if fn is not None:
            new = fn(name, param, acc)
            if new is not None:
                optimizer._accumulators[name][id(param)] = new
                return new
        return acc

    optimizer._add_accumulator = _add
    return optimizer
