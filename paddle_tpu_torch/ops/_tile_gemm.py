"""Routing and launch geometry of the GEMM kernels (the grouped GEMMs of
``csrc/grouped_gemm.cu`` and the dequant matmul of
``csrc/dequant_matmul.cu``): which instance takes an input
(:func:`gemm_instance`, the one rule), and the split of K of each."""

from __future__ import annotations

import torch

from ._build import sm_count

__all__ = ["TILE_K", "TILE_N", "CLUSTER_DEPTH", "MAX_SPLITS", "INSTANCES",
           "gemm_instance", "split_count", "cluster_splits"]

TILE_K = 32                 # the tile instance's K tile: a scale block
                            # holds whole tiles
TILE_N = 128                # the tile and cluster instances' out columns
CLUSTER_BLOCK = 16          # int8 scale blocks hold whole 16-deep MMA steps
CLUSTER_DEPTH = 64          # the float cluster instance's K stage
MAX_SPLITS = 8

#: the instances of each kernel, in the C entries' codes
INSTANCES = {"grouped_gemm": {"cluster": 2, "tile": 0, "general": 1},
             "grouped_gemm_q8": {"cluster": 2, "tile": 0, "general": 1},
             "dequant_matmul": {"cluster": 0, "tile": 1, "general": 2}}


def gemm_instance(kernel, dtype, k, n, block=None):
    """The CUDA instance of ``kernel`` ("grouped_gemm", "grouped_gemm_q8"
    or "dequant_matmul") that takes x of ``dtype`` at K = ``k``, N =
    ``n`` (int8 kernels: scale block ``block``, already clamped to K;
    the float grouped GEMM gets its weight in x's dtype, operands of two
    dtypes being widened to f32 first):

    - ``"cluster"``: bf16 or f16 x; the float grouped GEMM at K % 8 ==
      0 and N % 8 == 0 (16-bit weights by TMA, no conversion), the int8
      kernels at K % 8 == 0, N % 16 == 0 and B % 16 == 0 (int8
      converted in registers); the K split over a thread-block cluster;
    - ``"tile"``: f32 x; the float grouped GEMM at K % 8 == 0 and N % 8
      == 0, the int8 kernels at K % 8 == 0, N % 16 == 0 and B % 32 == 0
      (f32 FMAs, 16-byte loads);
    - ``"general"``: everything else, f32, f16 or bf16 x at any K, N >= 1
      and any B >= 1 (f32 FMAs, scalar loads; slow).

    The first is the serving and training paths' instance. Raises for
    any other x dtype."""
    if dtype not in (torch.float32, torch.float16, torch.bfloat16):
        raise ValueError(f"the CUDA {kernel} kernels take float32, float16 "
                         f"or bfloat16 x, got {dtype}")
    if kernel not in INSTANCES:
        raise ValueError(f"unknown GEMM kernel {kernel!r}")
    if kernel == "grouped_gemm":
        if k % 8 or n % 8:
            return "general"
        return "tile" if dtype == torch.float32 else "cluster"
    if dtype != torch.float32 and k % 8 == 0 and n % 16 == 0 \
            and block % CLUSTER_BLOCK == 0:
        return "cluster"
    if dtype == torch.float32 and k % 8 == 0 and n % 16 == 0 \
            and block % TILE_K == 0:
        return "tile"
    return "general"


def split_count(device, e, k, n, unit):
    """K splits of the grouped GEMMs' cluster instances: when the
    groups' column tiles alone give fewer than ~4 blocks per SM (a
    projection's narrow N), K is cut into whole ``unit``s (scale blocks
    of the int8 kernel, 64-deep stages of the float one) over the
    blocks of one thread-block cluster, at most 8, whose f32 partial
    tiles are added in rank order through distributed shared memory. A
    function of the weight's shape and the card only, never of the
    rows: every out row stays one fixed-order sum."""
    blocks = e * -(-n // TILE_N)
    return max(1, min(MAX_SPLITS, -(-k // unit),
                      4 * sm_count(device) // blocks))


def cluster_splits(device, k, n, block):
    """K splits of the dequant matmul's cluster instance: the blocks of
    one thread-block cluster (at most 8) that share an out tile, so that
    the column tiles times the splits give about two blocks per SM; each
    split takes whole scale blocks. A function of K, N, the block and
    the card only, never of the rows."""
    tiles = -(-n // TILE_N)
    want = -(-2 * sm_count(device) // tiles)
    return max(1, min(MAX_SPLITS, -(-k // block), want))
