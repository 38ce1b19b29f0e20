// Weight-only int8 matmul for Hopper (sm_90a): y = x @ (q * scales[k / B]).
//
// Replaces the TPU kernel `_dq_kernel` of paddle_tpu/quant/kernels.py (built
// by `_make_dq`, pallas_call at :132): a grid of (row tiles, column tiles)
// whose blocks hold the whole K, dequantize the int8 weight tile with its
// scale rows in VMEM and run one f32-accumulated dot.
//
// Here it is the tile product of csrc/tile_gemm.cuh with one group of all M
// rows: K streams in 32-deep tiles, each int8 tile goes exactly into bf16 (or
// f32) shared memory, and every scale block's partial sum is scaled once by
// its scale row (the format keeps one scale row per B weight rows for this).
// Each weight byte is read once per 32-row tile; at decode (M <= 32) that is
// once, so the weight bytes bound it. A projection gives few column tiles
// (N = 1024: 8), so K is split over blocks as well (see split_count in
// paddle_tpu_torch/ops/_tile_gemm.py).

#define TILE_GEMM_NS dequant_matmul
#include "tile_gemm.cuh"

using dequant_matmul::Args;

// C interface, loaded with ctypes. x [M, K] and y [M, N] contiguous in the
// type `dtype` (0 f32, 1 bf16), q contiguous int8 [K, N], scales contiguous
// f32 [ceil(K / block), N]; block % 32 == 0, N % 16 == 0 (the last scale
// block may be ragged: the TPU kernel needs K % block == 0). `splits`
// K splits (bf16 only; 1 = none) need `partial`, f32 [splits, M, N], and
// `tickets`, int32 [ceil(M/32), ceil(N/128)] zeroed. Launches on `stream`,
// does not synchronise, returns the cudaGetLastError() code.
extern "C" {

const char* dq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int dq_forward(const void* x, const void* q, const void* scales, void* y,
               int M, int K, int N, int block, int splits, void* partial,
               void* tickets, int dtype, void* stream) {
  Args a{x, q, (const float*)scales, nullptr, y, M, K, N, block,
         (long long)K * N, N, 1, splits, (float*)partial, (int*)tickets};
  return dequant_matmul::launch(a, 1, dtype, dequant_matmul::kWeightInt8,
                                stream);
}

}  // extern "C"
