from . import (flash_attention, fused_linear_cross_entropy, grouped_gemm,
               paged_attention, ragged_paged_attention, sampling)

__all__ = ["flash_attention", "fused_linear_cross_entropy", "grouped_gemm",
           "paged_attention", "ragged_paged_attention", "sampling"]
