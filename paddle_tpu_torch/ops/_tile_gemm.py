"""Launch geometry shared by the kernels of ``csrc/tile_gemm.cuh`` (the
grouped GEMMs and the dequant matmul): their tile sizes, the split of K
and its scratch buffers."""

from __future__ import annotations

import torch

__all__ = ["TILE_K", "TILE_M", "TILE_N", "MAX_SPLITS", "split_count",
           "split_scratch"]

TILE_K = 32                 # the K tile: a scale block holds whole tiles
TILE_M, TILE_N = 32, 128    # the out tile
MAX_SPLITS = 8

_SMS: dict = {}             # device -> its SM count
_TICKETS: dict = {}         # (device, stream) -> the zeroed ticket buffer


def split_count(device, e, k, n, unit):
    """K splits of the tensor-core tile kernel: when the groups' column
    tiles alone give fewer than ~4 blocks per SM (a projection's narrow
    N), K is cut into whole ``unit``s (scale blocks, or K tiles) over
    more blocks, at most 8, whose f32 partial sums the last block adds
    in split order. A function of the weight's shape and the card only,
    never of the rows: every out row stays one fixed-order sum."""
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    blocks = e * -(-n // TILE_N)
    return max(1, min(MAX_SPLITS, -(-k // unit), 4 * sms // blocks))


def split_scratch(x, splits, e, c, n):
    """The ``(partial, tickets)`` buffers of a launch with ``splits`` K
    splits (None, None without). The tickets are zero before a launch
    and the kernel leaves them zero, so one buffer per device and
    stream serves every launch in that stream's order."""
    if splits == 1:
        return None, None
    partial = torch.empty((splits, e * c, n), dtype=torch.float32,
                          device=x.device)
    need = e * -(-c // TILE_M) * -(-n // TILE_N)
    key = (x.device, torch.cuda.current_stream(x.device).cuda_stream)
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < need:
        tickets = _TICKETS[key] = torch.zeros(
            (max(need, 4096),), dtype=torch.int32, device=x.device)
    return partial, tickets
