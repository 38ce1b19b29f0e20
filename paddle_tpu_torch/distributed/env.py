"""The process environment (port of the reference package's
``distributed/env.py``).

The reference is one controller per host: GSPMD drives every chip it
sees, so a single process needs no setup. The port is one process per
rank over ``torch.distributed``: :func:`init_parallel_env` starts the
process group from the reference's variables (``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` / ``PADDLE_MASTER``, ``host:port``) or torch's
(``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``). With
neither it starts a world of one over an in-process store, which a mesh
of one rank needs and which opens no port. The backend is ``nccl`` on the
card and ``gloo`` when the caller passes ``device="cpu"``. The
rendezvous and every collective wait at most the reference's
``FLAGS_comm_timeout_seconds``. With no process group, ``get_rank``
and ``get_world_size`` give 0 and 1, as the reference's single process
does.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .. import flags
from ..device import resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "is_initialized"]

def _env_int(*names):
    for name in names:
        v = os.environ.get(name)
        if v not in (None, ""):
            return int(v)
    return None


def _init_method():
    master = os.environ.get("PADDLE_MASTER")
    if master:
        return f"tcp://{master}"
    if os.environ.get("MASTER_ADDR"):
        port = os.environ.get("MASTER_PORT", "29500")
        return f"tcp://{os.environ['MASTER_ADDR']}:{port}"
    return None


def backend_for(device):
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_parallel_env(device=None):
    """Start this process's rank of the world, once; later calls return
    the :class:`ParallelEnv` of the world already started.

    ``device`` (default the card) picks the backend; on the card each
    rank takes ``local_rank % device_count``. The flag
    ``comm_timeout_seconds`` bounds the rendezvous and every
    collective."""
    if dist.is_initialized():
        return ParallelEnv()
    dev = resolve_device(device)
    backend = backend_for(dev)
    rank = _env_int("PADDLE_TRAINER_ID", "RANK")
    world = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE")
    td = datetime.timedelta(
        seconds=float(flags.flag("comm_timeout_seconds")))
    if dev.type == "cuda":
        local = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK") or rank or 0
        torch.cuda.set_device(local % torch.cuda.device_count())
    if world is None or world == 1:
        # a world of one: an in-process store, no port and no file
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=td)
        return ParallelEnv()
    method = _init_method()
    if rank is None or method is None:
        raise RuntimeError(
            f"a world of {world} ranks needs this rank (PADDLE_TRAINER_ID "
            "or RANK) and the master's address (PADDLE_MASTER, or "
            "MASTER_ADDR and MASTER_PORT)")
    dist.init_process_group(backend, init_method=method, rank=rank,
                            world_size=world, timeout=td)
    return ParallelEnv()


def is_initialized():
    return dist.is_initialized()


def get_rank(group=None):
    """This process's rank in ``group`` (default the world); 0 with no
    process group."""
    if not dist.is_initialized():
        return 0
    from .collective import _process_group
    pg = _process_group(group)
    return dist.get_rank(pg) if pg is not None else dist.get_rank()


def get_world_size(group=None):
    """The ranks of ``group`` (default the world); 1 with no process
    group."""
    if not dist.is_initialized():
        return 1
    from .collective import _process_group
    pg = _process_group(group)
    return dist.get_world_size(pg) if pg is not None \
        else dist.get_world_size()


class ParallelEnv:
    """The reference's ``ParallelEnv``: this rank, the world's size, and
    the card this rank drives."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        local = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK")
        if local is not None:
            return local
        if torch.cuda.is_available() and dist.is_initialized() and \
                dist.get_backend() == "nccl":
            return torch.cuda.current_device()
        return 0

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        local = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK")
        return get_rank() if local is None else local
