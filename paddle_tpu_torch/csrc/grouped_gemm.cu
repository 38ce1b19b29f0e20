// Grouped GEMM over ragged per-expert row blocks for Hopper (sm_90a), float
// weights (bf16 or f32) and int8 weights with per-block f32 scales.
//
// Replaces two TPU kernels of paddle_tpu/ops/grouped_gemm.py:
// - `_gg_kernel`, built by `_make_grouped` (pallas_call at :175): grid
//   (expert, row tile, column tile) with the group sizes prefetched as
//   scalars; a tile past the expert's last real row writes zeros and skips
//   the MXU, ragged tails are masked inside the tile. It also serves the
//   backward's dx, the same product against the transposed weight.
// - `_gg_q8_kernel`, built by `_make_grouped_q8` (pallas_call at :405): the
//   same over int8 [E, K, N] weights and f32 [E, K/B, N] scales, dequantized
//   in VMEM just before the dot.
//
// The tile code is csrc/tile_gemm.cuh (its two instances, grid, masking,
// numbers and bound are described there). Here the grid's third axis is the
// expert and the group sizes are read on the device, so routing never syncs
// with the host.

#define TILE_GEMM_NS grouped_gemm
#include "tile_gemm.cuh"

using grouped_gemm::Args;

// C interface, loaded with ctypes. x [E*C, K] and y [E*C, N] contiguous, in
// the type `dtype` (0 f32, 1 bf16, 2 f16); gs [E] int32 on the device.
// `instance` 0 is the tile instance (bf16 or f32; K % 8 == 0, N % 8 == 0),
// 1 the general one (any K, N >= 1). `splits` K splits (tile instance, bf16
// only; 1 = none) need `partial`, f32 [splits, E*C, N], and `tickets`, int32
// [E, ceil(C/32), ceil(N/128)] zeroed (the kernel leaves them zeroed).
// Launches on `stream`, does not synchronise, returns the cudaGetLastError()
// code.
extern "C" {

const char* gg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// w: [E, K, N] in the x type with element strides (se, sk, sn); on the tile
// instance sn == 1 (the stored weight) or sk == 1 (its transpose, read in
// place), the general one takes any strides.
int gg_forward(int instance, const void* x, const void* w, const void* gs,
               void* y, int E, int C, int K, int N, long long se, long long sk,
               long long sn, int splits, void* partial, void* tickets,
               int dtype, void* stream) {
  Args a{x, w, nullptr, (const int*)gs, y, C, K, N, 0, se, sk, sn,
         splits, (float*)partial, (int*)tickets};
  return grouped_gemm::launch(a, E, dtype, grouped_gemm::kWeightFloat,
                              instance, stream);
}

// w: contiguous int8 [E, K, N]; scales: contiguous f32 [E, ceil(K / block),
// N] (a ragged last scale block is fine); on the tile instance block % 32 ==
// 0 and N % 16 == 0, the general one takes any block >= 1.
int gg_q8_forward(int instance, const void* x, const void* w,
                  const void* scales, const void* gs, void* y, int E, int C,
                  int K, int N, int block, int splits, void* partial,
                  void* tickets, int dtype, void* stream) {
  Args a{x, w, (const float*)scales, (const int*)gs, y, C, K, N, block,
         (long long)K * N, N, 1, splits, (float*)partial, (int*)tickets};
  return grouped_gemm::launch(a, E, dtype, grouped_gemm::kWeightInt8,
                              instance, stream);
}

}  // extern "C"
