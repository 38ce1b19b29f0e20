"""Routing and launch geometry of the GEMM kernels (the grouped GEMMs of
``csrc/grouped_gemm.cu`` and the dequant matmul of
``csrc/dequant_matmul.cu``): which instance takes an input
(:func:`gemm_instance`, the one rule), and the split of K of each."""

from __future__ import annotations

import torch

__all__ = ["TILE_K", "TILE_M", "TILE_N", "MAX_SPLITS", "INSTANCES",
           "gemm_instance", "split_count", "cluster_splits",
           "split_scratch"]

TILE_K = 32                 # the tile instance's K tile: a scale block
                            # holds whole tiles
TILE_M, TILE_N = 32, 128    # the tile instance's out tile
CLUSTER_N = 128             # the cluster instance's out columns a block
CLUSTER_BLOCK = 16          # its scale blocks hold whole 16-deep MMA steps
MAX_SPLITS = 8

#: the instances of each kernel, in the C entries' codes
INSTANCES = {"grouped_gemm": {"tile": 0, "general": 1},
             "grouped_gemm_q8": {"tile": 0, "general": 1},
             "dequant_matmul": {"cluster": 0, "tile": 1, "general": 2}}

_SMS: dict = {}             # device -> its SM count
_TICKETS: dict = {}         # (device, stream) -> the zeroed ticket buffer


def gemm_instance(kernel, dtype, k, n, block=None):
    """The CUDA instance of ``kernel`` ("grouped_gemm", "grouped_gemm_q8"
    or "dequant_matmul") that takes x of ``dtype`` at K = ``k``, N =
    ``n`` (int8 kernels: scale block ``block``, already clamped to K;
    the float grouped GEMM gets its weight in x's dtype, operands of two
    dtypes being widened to f32 first):

    - ``"cluster"`` (the dequant matmul only): bf16 or f16 x, K % 8 == 0,
      N % 16 == 0, B % 16 == 0; the K split over a thread-block cluster;
    - ``"tile"``: bf16 or f32 x (the dequant matmul: f32 only), K % 8 ==
      0 and N % 8 == 0; int8 weights also need B % 32 == 0 and N % 16 ==
      0;
    - ``"general"``: everything else, f32, f16 or bf16 x at any K, N >= 1
      and any B >= 1 (f32 FMAs, scalar loads; slow).

    The first two are the fast instances: the shapes that the serving
    and training paths give. Raises for any other x dtype."""
    if dtype not in (torch.float32, torch.float16, torch.bfloat16):
        raise ValueError(f"the CUDA {kernel} kernels take float32, float16 "
                         f"or bfloat16 x, got {dtype}")
    aligned = k % 8 == 0 and n % 8 == 0
    if kernel == "dequant_matmul":
        if dtype != torch.float32 and k % 8 == 0 and n % 16 == 0 \
                and block % CLUSTER_BLOCK == 0:
            return "cluster"
        if dtype == torch.float32 and k % 8 == 0 and n % 16 == 0 \
                and block % TILE_K == 0:
            return "tile"
        return "general"
    if kernel not in INSTANCES:
        raise ValueError(f"unknown GEMM kernel {kernel!r}")
    if dtype == torch.float16 or not aligned:
        return "general"
    if kernel == "grouped_gemm_q8" and (block % TILE_K or n % 16):
        return "general"
    return "tile"


def _sms(device):
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def split_count(device, e, k, n, unit):
    """K splits of the tile instance's tensor-core kernel: when the
    groups' column tiles alone give fewer than ~4 blocks per SM (a
    projection's narrow N), K is cut into whole ``unit``s (scale blocks,
    or K tiles) over more blocks, at most 8, whose f32 partial sums the
    last block adds in split order. A function of the weight's shape and
    the card only, never of the rows: every out row stays one
    fixed-order sum."""
    blocks = e * -(-n // TILE_N)
    return max(1, min(MAX_SPLITS, -(-k // unit), 4 * _sms(device) // blocks))


def cluster_splits(device, k, n, block):
    """K splits of the dequant matmul's cluster instance: the blocks of
    one thread-block cluster (at most 8) that share an out tile, so that
    the column tiles times the splits give about two blocks per SM; each
    split takes whole scale blocks. A function of K, N, the block and
    the card only, never of the rows."""
    tiles = -(-n // CLUSTER_N)
    want = -(-2 * _sms(device) // tiles)
    return max(1, min(MAX_SPLITS, -(-k // block), want))


def split_scratch(x, splits, e, c, n):
    """The ``(partial, tickets)`` buffers of a tile-instance launch with
    ``splits`` K splits (None, None without). The tickets are zero
    before a launch and the kernel leaves them zero, so one buffer per
    device and stream serves every launch in that stream's order."""
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
