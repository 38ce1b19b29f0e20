"""The collective API (port of the reference package's
``distributed/collective.py``).

In the reference a collective called inside ``shard_map`` over mesh axis
``a`` reduces over ``a``, and called eagerly it is the identity, the
array being global already. The port runs one process per rank: rank
``i`` of a started world runs the real collective over the group, and
its output is what the reference's ``shard_map`` body gives on device
``i``. With no process group, or a group of one rank, each function
returns what the reference returns eagerly (the identity, the list
forms filled with the input).

``group`` is a :class:`Group` (:func:`new_group`), a mesh-axis name
resolved through :func:`~paddle_tpu_torch.distributed.set_mesh`, or
None for the world. ``broadcast``'s and ``scatter``'s ``src`` count
within the group, as the reference's axis index does; ``reduce`` leaves
the result on every rank, as the reference's does. ``send`` / ``recv`` /
``isend`` / ``irecv`` raise, as the reference's do: point-to-point is
collective here too (:mod:`~paddle_tpu_torch.distributed.p2p`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ReduceOp", "Group", "new_group", "all_reduce", "all_gather",
           "all_gather_object", "reduce_scatter", "alltoall", "broadcast",
           "reduce", "scatter", "barrier", "send", "recv", "isend", "irecv",
           "wait", "get_group"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
              "avg": dist.ReduceOp.AVG}


def _torch_op(op):
    return _TORCH_OPS[op] if isinstance(op, str) else op


class Group:
    """A communication scope: a mesh axis (``axis_name``, resolved
    through the global mesh) or an explicit rank list with its own
    process group."""

    def __init__(self, axis_name=None, ranks=None, id=0, process_group=None):
        self.axis_name = axis_name
        self.ranks = list(ranks or [])
        self.id = id
        self.process_group = process_group

    @property
    def nranks(self):
        if self.ranks:
            return len(self.ranks)
        pg = _process_group(self)
        if pg is not None:
            return dist.get_world_size(pg)
        return dist.get_world_size() if dist.is_initialized() else 1

    def __repr__(self):
        return f"Group(axis={self.axis_name}, ranks={self.ranks})"


_groups = {0: Group(axis_name=None, ranks=[0], id=0)}
_next_gid = 1


def new_group(ranks=None, backend=None, timeout=None, axis_name=None):
    """A :class:`Group`. With ``ranks`` in a started world it creates the
    process group of those ranks, a collective call every rank of the
    world makes; with ``axis_name`` it names a mesh axis."""
    global _next_gid
    pg = None
    if ranks and dist.is_initialized() and axis_name is None:
        pg = dist.new_group(sorted(ranks), backend=backend)
    g = Group(axis_name=axis_name, ranks=ranks or [], id=_next_gid,
              process_group=pg)
    _groups[_next_gid] = g
    _next_gid += 1
    return g


def get_group(gid=0):
    if gid == 0 and dist.is_initialized():
        world = dist.get_world_size()
        if _groups[0].ranks != list(range(world)):
            _groups[0] = Group(ranks=list(range(world)), id=0)
    return _groups.get(gid)


def _process_group(group):
    """The torch process group of ``group`` (None: the world)."""
    if group is None:
        return None
    if isinstance(group, Group):
        if group.process_group is not None:
            return group.process_group
        if group.axis_name is None:
            return None
        group = group.axis_name
    if isinstance(group, str):
        from .process_mesh import get_mesh
        mesh = get_mesh()
        if mesh is None or group not in mesh.dim_names:
            raise ValueError(
                f"group {group!r} names no axis of the global mesh "
                f"({mesh}): call set_mesh(ProcessMesh(..., dim_names=[...]))")
        return mesh.get_group(group)
    return group      # a torch ProcessGroup


def _resolve(group):
    """``(process group, its size, this rank's index in it)``, or None
    where the collective is the identity (no world, or one rank)."""
    if not dist.is_initialized():
        return None
    pg = _process_group(group)
    n = dist.get_world_size(pg)
    if n == 1:
        return None
    return pg, n, dist.get_rank(pg)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group, in place; returns it."""
    ctx = _resolve(group)
    if ctx is not None:
        dist.all_reduce(tensor, op=_torch_op(op), group=ctx[0])
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Append every rank's ``tensor`` to ``tensor_list`` in group order;
    returns them stacked ``[n, ...]``."""
    ctx = _resolve(group)
    if ctx is None:
        tensor_list.append(tensor)
        return tensor
    out = [torch.empty_like(tensor) for _ in range(ctx[1])]
    dist.all_gather(out, tensor.contiguous(), group=ctx[0])
    tensor_list.extend(out)
    return torch.stack(out)


def all_gather_object(object_list, obj, group=None):
    ctx = _resolve(group)
    if ctx is None:
        object_list.append(obj)
        return
    out = [None] * ctx[1]
    dist.all_gather_object(out, obj, group=ctx[0])
    object_list.extend(out)


def reduce_scatter(tensor, tensor_list_or_input, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Rank ``i`` of ``n`` takes block ``i`` (of ``n`` along dim 0) of the
    group's reduction of the input (a tensor, or a list concatenated
    along dim 0) into ``tensor``; returns ``tensor``."""
    src = tensor_list_or_input
    if isinstance(src, (list, tuple)):
        src = torch.cat(list(src), dim=0)
    ctx = _resolve(group)
    if ctx is None:
        tensor.data = src.detach().clone()
        return tensor
    dist.reduce_scatter_tensor(tensor, src.contiguous(), op=_torch_op(op),
                               group=ctx[0])
    return tensor


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank ``j`` receives element ``j`` of every rank's list (or of the
    stacked tensor's dim 0), in group order; returns them stacked."""
    if isinstance(in_tensor_list, (list, tuple)):
        stacked = torch.stack(list(in_tensor_list), dim=0)
    else:
        stacked = in_tensor_list
    ctx = _resolve(group)
    if ctx is None:
        out_tensor_list.extend(
            in_tensor_list if isinstance(in_tensor_list, (list, tuple))
            else [in_tensor_list])
        return stacked
    out = torch.empty_like(stacked)
    dist.all_to_all_single(out, stacked.contiguous(), group=ctx[0])
    out_tensor_list.extend(out.unbind(0))
    return out


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Every rank takes the value of the group's rank ``src``, in place."""
    ctx = _resolve(group)
    if ctx is not None:
        dist.broadcast(tensor, group=ctx[0], group_src=int(src))
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reference's ``reduce``: the reduction lands on every rank."""
    return all_reduce(tensor, op=op, group=group)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``i`` takes element ``i`` of the group's rank ``src``'s
    ``tensor_list`` into ``tensor``; one element per rank."""
    if not tensor_list:
        return tensor
    ctx = _resolve(group)
    if ctx is None:
        tensor.data = tensor_list[0].detach().clone()
        return tensor
    pg, n, me = ctx
    if len(tensor_list) != n:
        raise ValueError(
            f"scatter got {len(tensor_list)} tensors for a {n}-rank group; "
            "one slice per rank is required")
    parts = [t.contiguous() for t in tensor_list] if me == int(src) else None
    dist.scatter(tensor, scatter_list=parts, group=pg, group_src=int(src))
    return tensor


def barrier(group=None):
    ctx = _resolve(group)
    if ctx is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    if dist.get_backend(ctx[0]) == "nccl":
        dist.barrier(group=ctx[0], device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=ctx[0])


def send(tensor, dst=0, group=None, sync_op=True):
    """One-sided point-to-point is not offered, as in the reference:
    every rank of the axis calls :mod:`~paddle_tpu_torch.distributed.p2p`
    (``shift`` / ``send_forward`` / ``send_backward`` / ``ppermute``)
    together."""
    raise NotImplementedError(
        "one-sided send/recv is not offered: p2p is collective (both sides "
        "participate): use paddle_tpu_torch.distributed.p2p.shift / "
        "send_forward / send_backward / ppermute from every rank of the "
        "axis")


recv = isend = irecv = send


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until ``tensor``'s pending work is done."""
    if isinstance(tensor, torch.Tensor) and tensor.device.type == "cuda":
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor
