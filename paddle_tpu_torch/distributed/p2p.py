"""Point-to-point over a mesh axis (port of the reference package's
``distributed/p2p.py``).

The reference's transfers are ``lax.ppermute`` inside ``shard_map``:
every rank of the axis calls together. The port does the same with
``torch.distributed.batch_isend_irecv`` over the axis's process group:
each rank posts the send its ``(src, dst)`` pair names and the receive
of the pair that names it as ``dst``. A rank that no pair names as
``dst`` receives zeros, as in the reference. ``axis_name`` is a mesh-axis
name (through the global mesh) or a
:class:`~paddle_tpu_torch.distributed.Group`; with no process group the
axis has one rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["shift", "send_forward", "send_backward", "ppermute",
           "axis_rank", "axis_size"]


def _axis(axis_name):
    """``(process group, size, this rank's index)`` of the axis."""
    if not dist.is_initialized():
        return None, 1, 0
    from .collective import _process_group
    pg = _process_group(axis_name)
    return pg, dist.get_world_size(pg), dist.get_rank(pg)


def ppermute(x, axis_name, perm):
    """Collective permute: ``perm`` lists ``(src, dst)`` pairs of axis
    indices; returns what this rank receives (zeros if nothing)."""
    pg, n, me = _axis(axis_name)
    out = torch.zeros_like(x)
    sends = [d for s, d in perm if s == me]
    recvs = [s for s, d in perm if d == me]
    if len(recvs) > 1 or len(sends) > 1:
        raise ValueError(f"perm {perm} names axis index {me} more than "
                         "once as a source or a destination")
    ops = []
    for d in sends:
        if d == me:
            out.copy_(x)
        else:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  group=pg, group_peer=d))
    for s in recvs:
        if s != me:
            ops.append(dist.P2POp(dist.irecv, out, group=pg, group_peer=s))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def shift(x, axis_name, offset=1, wrap=False):
    """Every rank ``i`` sends ``x`` to ``i + offset``. ``wrap=False``:
    the edge ranks receive zeros (a pipeline); ``wrap=True``: indices mod
    n (a ring)."""
    n = axis_size(axis_name)
    if wrap:
        perm = [(i, (i + offset) % n) for i in range(n)]
    else:
        perm = [(i, i + offset) for i in range(n) if 0 <= i + offset < n]
    return ppermute(x, axis_name, perm)


def send_forward(x, axis_name):
    """Stage i -> stage i + 1."""
    return shift(x, axis_name, offset=1, wrap=False)


def send_backward(x, axis_name):
    """Stage i -> stage i - 1."""
    return shift(x, axis_name, offset=-1, wrap=False)


def axis_rank(axis_name):
    return _axis(axis_name)[2]


def axis_size(axis_name):
    return _axis(axis_name)[1]
