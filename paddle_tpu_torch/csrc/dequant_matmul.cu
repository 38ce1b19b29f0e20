// Weight-only int8 matmul for Hopper (sm_90a): y = x @ (q * scales[k / B]).
//
// Replaces the TPU kernel `_dq_kernel` of paddle_tpu/quant/kernels.py (built
// by `_make_dq`, pallas_call at :132): a grid of (row tiles, column tiles)
// whose blocks hold the whole K, dequantize the int8 weight tile with its
// scale rows in VMEM and run one f32-accumulated dot.
//
// Three instances; paddle_tpu_torch/ops/_tile_gemm.py picks one by one rule
// (`gemm_instance`), and the C entry refuses any other pairing:
//
//   cluster  bf16 or f16 x, K % 8 == 0, N % 16 == 0, B % 16 == 0: the kernel
//            below, written for the serving shapes (M <= 64 rows).
//   tile     f32 x, K % 8 == 0, N % 16 == 0, B % 32 == 0: the f32 FMA tile
//            kernel of csrc/tile_gemm.cuh with one group of all M rows.
//   general  everything else (f32, f16 or bf16 x; any K, N >= 1; any B >= 1):
//            the general kernel of tile_gemm.cuh, f32 FMAs, scalar loads.
//
// Bound (the cluster instance). At M <= 64 rows the product does at most
// 128 flops per weight byte, under the card's ~295 for bf16, so the weight
// bytes bound it: the design reads each weight byte once per launch, keeps
// enough bytes in flight, and spends no barrier or shared-memory round trip
// on the conversion.
//
// - One read per byte. All rows of x (up to 64) form one row tile, so every
//   int8 weight byte and every scale is read from device memory once per
//   launch. M > 64 walks row chunks of 64 in other blocks of the grid, each
//   the same sums in the same K order.
// - Streaming. One producer warp keeps a ring of kStages stages full through
//   TMA (2-D tensor maps, 128-byte swizzle, mbarriers): a stage is a
//   [64 k][128 n] int8 weight tile (8 KB) and the x rows' [M][64 k] slice
//   beside it, so a block has 48 KB of weights in flight.
// - Conversion in registers. Four consumer warps each own 32 of the block's
//   128 columns and compute with mma.sync m16n8k16 (x the A operand from
//   shared memory by ldmatrix, the weight the B operand). A thread's B
//   fragment needs two consecutive k of one column; it reads four 32-bit
//   words of the tile, rows 2t, 2t+1, 2t+8, 2t+9 at columns 4g .. 4g+3, and
//   pairs rows with __byte_perm, so mma tile j of the warp takes columns
//   4g + j (g = lane / 4): the order is undone at the store. int8 turns into
//   bf16 or f16 exactly by bit tricks (no conversion instruction): for bf16,
//   (0x4300 | (b & 0x7f)) - (0x4300 | (b & 0x80)) = 128 + (b & 127) minus
//   128 or 256; for f16, (0x6400 | (b ^ 0x80)) - 0x6480.
//   mma.sync (not wgmma swap-AB) because M is as small as 1: a wgmma B
//   operand of n = 8 rows would still cost a 64-column A tile in registers
//   per warpgroup, where mma.sync's m16 tiles of x waste at most 15 rows.
// - K split over a thread-block cluster. K is cut in whole scale blocks over
//   the S (<= 8) blocks of a cluster, S a function of K, N, B and the SM
//   count only (`cluster_splits`). Each block leaves its f32 partial tile in
//   its own shared memory; after a cluster barrier each block sums a slice
//   of the tile over the S partials in rank order, read through distributed
//   shared memory, and writes it. No partial goes to device memory; every
//   out element is one sum in one fixed order whatever M, so a row alone is
//   bitwise the same as among other rows.
// - Scales. Each scale block's partial sum (B rows of K, exact products of
//   16-bit x and int8 q in f32) is scaled once: acc += partial * scale[n].

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "mma_sync.cuh"
#include "tma.cuh"

#define TILE_GEMM_NS dequant_matmul
#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 128;             // out columns of a block
constexpr int kDepth = 64;             // K rows of a stage
constexpr int kStages = 6;             // stages in flight
constexpr int kConsumerWarps = 4;      // warp w owns columns 32w .. 32w + 31
constexpr int kMaxSplits = 8;          // blocks of a cluster
constexpr int kThreads = 32 * (kConsumerWarps + 1);   // + the producer warp
constexpr int kChunk = 64;             // rows of x of a block
constexpr int kLdPart = kCols + 4;     // f32 partial tile row stride

// shared memory of the MT-tile instance (16 MT rows of x): the ring of
// stages (weights, then x), then the mbarriers; the partial tile reuses the
// ring. The base is aligned to 1024 bytes (the swizzle repeats every 8 rows).
template <int MT>
struct Smem {
  static constexpr int kW = kDepth * kCols;             // 8 KB of int8
  static constexpr int kX = 16 * MT * kDepth * 2;       // [16 MT][64] 16-bit
  static constexpr int kStage = kW + kX;
  static constexpr int kBar = kStages * kStage;
  static constexpr int kBytes = kBar + 16 * kStages + 1024;
  static_assert(kStage % 1024 == 0, "stages keep the swizzle's alignment");
  static_assert(16 * MT * kLdPart * 4 <= kBar, "the partial tile fits");
};

template <typename XT>
__device__ __forceinline__ void store4(XT* dst, float4 v);
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(dst) = u;
}
template <>
__device__ __forceinline__ void store4<__half>(__half* dst, float4 v) {
  __half2 a = __floats2half2_rn(v.x, v.y);
  __half2 b = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Grid (column tiles, row chunks, S), clusters of (1, 1, S): block (n, m, r)
// computes the partial sums of out rows [64 m, 64 m + 16 MT) and columns
// [128 n, 128 n + 128) over the r-th share of the scale blocks.
template <typename XT, int MT>
__global__ void __launch_bounds__(kThreads)
    dq_cluster_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      const float* __restrict__ scales, XT* __restrict__ y,
                      int M, int K, int N, int block) {
  using SM = Smem<MT>;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + SM::kBar, empty = full + 8 * kStages;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * kChunk;
  // this rank's K rows [k_lo, k_hi): whole scale blocks
  const int units = (K + block - 1) / block;
  const int k_lo = rank * units / S * block;
  const int k_hi = min((rank + 1) * units / S * block, K);
  const int n_st = (k_hi - k_lo + kDepth - 1) / kDepth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  if (warp == kConsumerWarps) {
    // producer warp: one lane keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < n_st; ++i) {
        const int s = i % kStages, k = k_lo + i * kDepth;
        const uint32_t st = base + s * SM::kStage;
        mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, SM::kStage);
        tma_load_2d(st, &tw, full + 8 * s, n0, k);
        tma_load_2d(st + SM::kW, &tx, full + 8 * s, k, m0);
      }
    }
  } else {
    // consumer warp: columns 32 cw .. 32 cw + 31 of the block
    const int cw = warp;
    float acc[MT][4][4], part[MT][4][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][j][c] = part[mi][j][c] = 0.f;
    // the thread's columns: 32 cw + 8 t + 4 e + j (e = accumulator
    // register & 1, j = the mma tile)
    const int col0 = n0 + 32 * cw + 8 * t;
    float sc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int blk_end = k_lo;  // the end of the scale block `part` belongs to
    // part's scale block is over: acc += part * scale; then the scales of
    // the block that holds row k
    auto next_block = [&](int k) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[mi][j][c] =
                fmaf(part[mi][j][c], sc[(c & 1) * 4 + j], acc[mi][j][c]);
            part[mi][j][c] = 0.f;
          }
      if (k < k_hi) {
        const int kb = k / block;
        blk_end = (kb + 1) * block;
        const float* row = scales + (size_t)kb * N;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sc[i] = col0 + i < N ? __ldg(row + col0 + i) : 0.f;
      }
    };
    // one 16-deep step at stage row 16 kk (row k of the weight)
    auto step = [&](const unsigned char* ws, uint32_t st, int kk, int k) {
      if (k >= blk_end) next_block(k);
      // weights: rows 16 kk + 2t (+1, +8, +9), bytes 32 cw + 4g of the
      // 128-byte rows, 16-byte chunks XOR-swizzled by the row
      uint32_t r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 16 * kk + 2 * t + (q & 1) + 8 * (q >> 1);
        const int chunk = (2 * cw + (g >> 2)) ^ (row & 7);
        r[q] = *reinterpret_cast<const uint32_t*>(ws + row * 128 +
                                                  chunk * 16 + (g & 3) * 4);
      }
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
        b[j][0] = int8_pair<XT>(__byte_perm(r[0], r[1], sel));
        b[j][1] = int8_pair<XT>(__byte_perm(r[2], r[3], sel));
      }
      // x: the m16k16 A fragments by ldmatrix from the swizzled rows
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int mat = lane >> 3;
        const int row = mi * 16 + (mat & 1) * 8 + (lane & 7);
        const int kc = kk * 2 + (mat >> 1);
        uint32_t a[4];
        ldmatrix_x4(a, st + SM::kW + row * 128 + ((kc ^ (row & 7)) * 16));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16816<XT>(part[mi][j], a, b[j][0], b[j][1]);
      }
    };
    for (int i = 0; i < n_st; ++i) {
      const int s = i % kStages, k = k_lo + i * kDepth;
      const uint32_t st = base + s * SM::kStage;
      const unsigned char* ws = smem + s * SM::kStage;
      mbar_wait(full + 8 * s, (i / kStages) & 1);
      if (k + kDepth <= k_hi) {  // a whole stage: no test between steps
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk) step(ws, st, kk, k + 16 * kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk)
          if (k + 16 * kk < k_hi) step(ws, st, kk, k + 16 * kk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    next_block(k_hi);
    // the partial tile in natural order over the ring, once every consumer
    // is past its last stage
    named_sync(1, 32 * kConsumerWarps);
    float* part_s = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part_s[(mi * 16 + g + 8 * (c >> 1)) * kLdPart + 32 * cw + 8 * t +
                 4 * (c & 1) + j] = acc[mi][j][c];
  }
  __syncwarp();
  cluster.sync();  // every rank's partial tile is in its shared memory

  // this rank's slice of the tile: the S partials added in rank order
  const int rows = min(16 * MT, M - m0);
  const int vecs = rows * (kCols / 4);
  const int v_hi = (rank + 1) * vecs / S;
  float* part_s = reinterpret_cast<float*>(smem);
  for (int v = rank * vecs / S + threadIdx.x; v < v_hi; v += kThreads) {
    const int r = v / (kCols / 4), c = (v % (kCols / 4)) * 4;
    if (n0 + c >= N) continue;  // N % 16 == 0: a vector is whole or out
    const int at = r * kLdPart + c;
    float4 p[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < S)
        p[j] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part_s, j) + at);
    float4 sum = p[0];
#pragma unroll
    for (int j = 1; j < kMaxSplits; ++j)
      if (j < S) {
        sum.x += p[j].x;
        sum.y += p[j].y;
        sum.z += p[j].z;
        sum.w += p[j].w;
      }
    store4<XT>(y + (size_t)(m0 + r) * N + n0 + c, sum);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

template <typename XT, int MT>
int launch_cluster(const void* x, const void* q, const float* scales, void* y,
                   int M, int K, int N, int block, int splits,
                   cudaStream_t stream) {
  using SM = Smem<MT>;
  const CUtensorMapDataType xt = std::is_same<XT, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tx, tw;
  if (int e = map_2d(&tx, xt, x, M, K, (long long)K * 2, 16 * MT, kDepth))
    return e;
  if (int e = map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, N, kDepth,
                     kCols))
    return e;
  auto kernel = dq_cluster_kernel<XT, MT>;
  static bool sized = false;  // above 48 KB a kernel must ask, once
  if (!sized) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::kBytes))
      return (int)e;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kCols - 1) / kCols, (M + kChunk - 1) / kChunk,
                     splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = SM::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, tx, tw, scales,
                                         (XT*)y, M, K, N, block))
    return (int)e;
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_cluster_rows(const void* x, const void* q, const float* scales,
                        void* y, int M, int K, int N, int block, int splits,
                        cudaStream_t stream) {
  // row tiles of 16 MT rows: 1, 2 or 4 m16 tiles (M > 64: chunks of 64)
  if (M <= 16)
    return launch_cluster<XT, 1>(x, q, scales, y, M, K, N, block, splits,
                                 stream);
  if (M <= 32)
    return launch_cluster<XT, 2>(x, q, scales, y, M, K, N, block, splits,
                                 stream);
  return launch_cluster<XT, 4>(x, q, scales, y, M, K, N, block, splits,
                               stream);
}

}  // namespace

using dequant_matmul::Args;

// C interface, loaded with ctypes. x [M, K] and y [M, N] contiguous in the
// type `dtype` (0 f32, 1 bf16, 2 f16), q contiguous int8 [K, N], scales
// contiguous f32 [ceil(K / block), N] (the last scale block may be ragged:
// the TPU kernel needs K % block == 0). `instance` 0 is the cluster kernel
// (bf16 or f16; K % 8, N % 16 and block % 16 zero; `splits` K splits, 1 to 8,
// at most ceil(K / block)), 1 the f32 tile kernel (K % 8, N % 16, block % 32
// zero), 2 the general kernel (any K, N >= 1, block >= 1). Launches on
// `stream`, does not synchronise, returns the cudaGetLastError() code
// (cudaErrorInvalidValue for a pairing no instance takes).
extern "C" {

const char* dq_error_string(int code) { return tma_error_string(code); }

int dq_forward(int instance, const void* x, const void* q, const void* scales,
               void* y, int M, int K, int N, int block, int splits, int dtype,
               void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || K <= 0 || N <= 0 || block <= 0 || !scales)
    return (int)cudaErrorInvalidValue;
  if (instance == 0) {
    const int units = (K + block - 1) / block;
    if (K % 8 || N % 16 || block % 16 || splits < 1 || splits > 8 ||
        splits > units)
      return (int)cudaErrorInvalidValue;
    if (dtype == dequant_matmul::kBF16)
      return launch_cluster_rows<__nv_bfloat16>(x, q, (const float*)scales, y,
                                                M, K, N, block, splits, st);
    if (dtype == dequant_matmul::kF16)
      return launch_cluster_rows<__half>(x, q, (const float*)scales, y, M, K,
                                         N, block, splits, st);
    return (int)cudaErrorInvalidValue;
  }
  Args a{x, q, (const float*)scales, nullptr, y, M, K, N, block,
         (long long)K * N, N, 1};
  if (instance == 1) {
    if (dtype != dequant_matmul::kF32) return (int)cudaErrorInvalidValue;
    return dequant_matmul::launch(a, 1, dtype, dequant_matmul::kWeightInt8,
                                  dequant_matmul::kTileInstance, stream);
  }
  if (instance == 2)
    return dequant_matmul::launch(a, 1, dtype, dequant_matmul::kWeightInt8,
                                  dequant_matmul::kGeneralInstance, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
