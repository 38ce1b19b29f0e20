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
// The float kernel and the f32 and general int8 instances are
// csrc/tile_gemm.cuh (their grid, masking, numbers and bound are described
// there). Here the grid's third axis is the expert and the group sizes are
// read on the device, so routing never syncs with the host.
//
// The int8 kernel's cluster instance (16-bit x, K % 8, N % 16, B % 16: the
// serving path) is `q8_cluster_kernel` below. At serving shapes (an expert's
// live rows <= 64) it is bound by the weight bytes (Mixtral-8x7B's gate/up
// at 64 tokens: 0.149 ms; it reads 0.236 device ms there, NVIDIA H100 80GB
// HBM3, 700 W, PERF.md), and its design is about reading each of them once,
// with enough in flight, and spending no barrier or shared-memory pass on
// the int8 -> 16-bit conversion:
// - One weight read per expert. Grid (N / 128 column tiles, E x ceil(C / 64)
//   row chunks, S K splits): a block covers all of an expert's live rows up
//   to 64, and its m16 sub-tiles past the live rows are skipped (neither
//   copied nor multiplied), so each weight byte is read once per expert. A
//   chunk with no live row writes its zeros and reads nothing.
// - Streaming. A ring of 6 stages is kept full through TMA (2-D maps,
//   128-byte swizzle, mbarriers): a stage is a raw [64 k][128 n] int8 weight
//   tile (8 KB) and the live rows' [16][64 k] x boxes. There is no producer
//   warp: one lane of consumer warp 0 fills the ring first and then refills
//   each slot once every warp has released it, so a block is 8 warps.
// - Conversion in registers. Eight consumer warps each own 16 of the block's
//   128 columns and compute with mma.sync m16n8k16 (x the A operand by
//   ldmatrix). The B fragments come by ldmatrix.trans straight from the raw
//   tile: a lane gets 16-bit pairs of two consecutive k of one column pair,
//   so int8_pair of the word and of the word >> 8 are the B fragments of the
//   even and of the odd columns (csrc/mma_sync.cuh; the order is undone at
//   the store). One mbarrier wait a stage, no conversion pass.
// - Occupancy. The live m16 tile count is a compile-time constant of the
//   stage loop (one specialisation per count), so dead tiles issue nothing;
//   16 columns a warp keep a 64-row block's sums at 64 registers a thread,
//   and 8 warps a block keep two blocks an SM within 128 registers a thread
//   (an SM sub-partition holds 4 of their warps). (With four warps of 32
//   columns and the tile test at run time, the 64-row instance took 0.42
//   device ms where the 16-row one took 0.19 on the same rows; with a ninth,
//   producer warp, five warps share a sub-partition and two blocks an SM
//   cap a thread at 96 registers. NVIDIA H100 80GB HBM3, 700 W.)
// - Scales. Each scale block's partial sum (B rows of K, exact products of
//   16-bit x and int8 q in f32) is scaled once: acc += partial * scale[n].
// - K split over a thread-block cluster, S a function of the shape and the
//   SM count (`split_count`); the ranks' partial tiles meet in distributed
//   shared memory and are added in rank order. Every out element is one sum
//   in one fixed order whatever the other rows, so a row alone is bitwise
//   the same as among others.

#include <cooperative_groups.h>
#include <cuda.h>

#include <type_traits>

#include "mma_sync.cuh"
#include "tma.cuh"

#define TILE_GEMM_NS grouped_gemm
#include "tile_gemm.cuh"

namespace grouped_gemm {
namespace {

namespace cg = cooperative_groups;

constexpr int kQCols = 128;            // out columns of a block
constexpr int kQDepth = 64;            // K rows of a stage
constexpr int kQStages = 6;            // stages in flight
constexpr int kQWarps = 8;             // warp w owns columns 16w .. 16w + 15
constexpr int kQThreads = 32 * kQWarps;
constexpr int kQChunk = 64;            // rows of an expert a block covers
constexpr int kQMaxSplits = 8;         // blocks of a cluster
constexpr int kQLdPart = kQCols + 4;   // f32 partial tile row stride

// shared memory of the MT-tile instance (up to 16 MT live rows): the ring of
// stages (weights, then x), then the mbarriers; the partial tile reuses the
// ring. The base is aligned to 1024 bytes (the swizzle repeats every 8 rows).
template <int MT>
struct QSmem {
  static constexpr int kW = kQDepth * kQCols;           // 8 KB of int8
  static constexpr int kXBox = 16 * kQDepth * 2;        // [16][64] 16-bit
  static constexpr int kStage = kW + MT * kXBox;
  static constexpr int kBar = kQStages * kStage;
  static constexpr int kBytes = kBar + 16 * kQStages + 1024;
  static_assert(kStage % 1024 == 0, "stages keep the swizzle's alignment");
  static_assert(16 * MT * kQLdPart * 4 <= kBar, "the partial tile fits");
};

// four columns of an out row (8-byte aligned: N % 16 == 0) in one store
template <typename XT>
__device__ __forceinline__ void store4(XT* dst, float4 v) {
  uint2 u;
  XT* h = reinterpret_cast<XT*>(&u);
  h[0] = from_f<XT>(v.x);
  h[1] = from_f<XT>(v.y);
  h[2] = from_f<XT>(v.z);
  h[3] = from_f<XT>(v.w);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Grid (column tiles, E * chunks, S), clusters of (1, 1, S): block (n, e *
// chunks + m, r) computes the partial sums of expert e's out rows [64 m, 64 m
// + 64) (its live ones) and columns [128 n, 128 n + 128) over the r-th share
// of the scale blocks.
template <typename XT, int MT>
__global__ void __launch_bounds__(kQThreads, 2)
    q8_cluster_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      const float* __restrict__ scales,
                      const int* __restrict__ gs, XT* __restrict__ y, int C,
                      int K, int N, int block) {
  using SM = QSmem<MT>;
  const int chunks = (C + kQChunk - 1) / kQChunk;
  const int e = blockIdx.y / chunks, m0 = (blockIdx.y % chunks) * kQChunk;
  const int n0 = blockIdx.x * kQCols;
  const int rows_out = min(kQChunk, C - m0);   // out rows of the block
  const int live = min(max(min(gs[e], C) - m0, 0), rows_out);
  XT* yb = y + ((size_t)e * C + m0) * N + n0;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  if (live == 0) {
    // no live row (every rank of the cluster agrees): zeros, no weight read
    const int vecs = rows_out * (kQCols / 4);
    for (int v = rank * vecs / S + threadIdx.x; v < (rank + 1) * vecs / S;
         v += kQThreads) {
      const int r = v / (kQCols / 4), c = (v % (kQCols / 4)) * 4;
      if (n0 + c < N)
        store4<XT>(yb + (size_t)r * N + c, make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }
  const int mt_live = (live + 15) / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + SM::kBar, empty = full + 8 * kQStages;
  // this rank's K rows [k_lo, k_hi): whole scale blocks
  const int units = (K + block - 1) / block;
  const int k_lo = rank * units / S * block;
  const int k_hi = min((rank + 1) * units / S * block, K);
  const int n_st = (k_hi - k_lo + kQDepth - 1) / kQDepth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kQWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage i into ring slot i % kQStages: the weight tile and the live
  // rows' x boxes. The weight map is [E K, N]: past expert e's K rows it
  // reads the next expert's, which meet x's zero-filled columns past K and
  // add nothing.
  auto issue = [&](int i) {
    const int s = i % kQStages, k = k_lo + i * kQDepth;
    const uint32_t st = base + s * SM::kStage;
    mbar_expect_tx(full + 8 * s, SM::kW + mt_live * SM::kXBox);
    tma_load_2d(st, &tw, full + 8 * s, n0, e * K + k);
    for (int mi = 0; mi < mt_live; ++mi)
      tma_load_2d(st + SM::kW + mi * SM::kXBox, &tx, full + 8 * s, k,
                  e * C + m0 + 16 * mi);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(n_st, kQStages); ++i) issue(i);

  const int g = lane >> 2, t = lane & 3;
  {
    // warp cw: columns 16 cw .. 16 cw + 15 of the block
    const int cw = warp;
    float acc[MT][2][4], part[MT][2][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][j][c] = part[mi][j][c] = 0.f;
    // mma tile j holds the even (0) or odd (1) columns: its n index i is
    // column 16 cw + 2 i + j, so the accumulator's (c & 1) picks column
    // 16 cw + 4 t + 2 (c & 1) + j of row g + 8 (c >> 1): a thread holds
    // columns 4t .. 4t + 3 of the warp's 16
    const int col0 = n0 + 16 * cw + 4 * t;
    const float* srow = scales + (size_t)e * units * N;
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    int blk_end = k_lo;  // the end of the scale block `part` belongs to
    auto next_block = [&](int k) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[mi][j][c] =
                fmaf(part[mi][j][c], sc[2 * (c & 1) + j], acc[mi][j][c]);
            part[mi][j][c] = 0.f;
          }
      if (k < k_hi) {
        const int kb = k / block;
        blk_end = (kb + 1) * block;
        if (col0 < N) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              srow + (size_t)kb * N + col0));
          sc[0] = v.x;
          sc[1] = v.y;
          sc[2] = v.z;
          sc[3] = v.w;
        }
      }
    };
    // one 16-deep step at stage row 16 kk (row k of the weight) over the
    // first L m16 tiles (the live ones)
    auto step = [&](auto live_tiles, uint32_t st, int kk, int k) {
      constexpr int L = decltype(live_tiles)::value;
      if (k >= blk_end) next_block(k);
      // weights: rows 16 kk + (lane & 15), the warp's 16-byte chunk cw of
      // the 128-byte rows, XOR-swizzled by the row
      const int wr = 16 * kk + (lane & 15);
      uint32_t b[2];
      ldmatrix_x2_trans(b, st + wr * 128 + ((cw ^ (wr & 7)) << 4));
      const uint32_t bf[2][2] = {
          {int8_pair<XT>(b[0]), int8_pair<XT>(b[1])},
          {int8_pair<XT>(b[0] >> 8), int8_pair<XT>(b[1] >> 8)}};
      // x: the m16k16 A fragments by ldmatrix from the swizzled rows
#pragma unroll
      for (int mi = 0; mi < L; ++mi) {
        const int mat = lane >> 3;
        const int row = mi * 16 + (mat & 1) * 8 + (lane & 7);
        const int kc = kk * 2 + (mat >> 1);
        uint32_t a[4];
        ldmatrix_x4(a, st + SM::kW + row * 128 + ((kc ^ (row & 7)) * 16));
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma16816<XT>(part[mi][j], a, bf[j][0], bf[j][1]);
      }
    };
    // the stages, with the live m16 tile count fixed at compile time
    auto stages = [&](auto live_tiles) {
      for (int i = 0; i < n_st; ++i) {
        const int s = i % kQStages, k = k_lo + i * kQDepth;
        const uint32_t st = base + s * SM::kStage;
        mbar_wait(full + 8 * s, (i / kQStages) & 1);
        if (k + kQDepth <= k_hi) {  // a whole stage: no test between steps
#pragma unroll
          for (int kk = 0; kk < kQDepth / 16; ++kk)
            step(live_tiles, st, kk, k + 16 * kk);
        } else {
#pragma unroll
          for (int kk = 0; kk < kQDepth / 16; ++kk)
            if (k + 16 * kk < k_hi) step(live_tiles, st, kk, k + 16 * kk);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
        // warp 0 refills the slot once every warp is done with it
        if (warp == 0 && lane == 0 && i + kQStages < n_st) {
          mbar_wait(empty + 8 * s, (i / kQStages) & 1);
          issue(i + kQStages);
        }
        __syncwarp();
      }
    };
    if (mt_live == 1) {
      stages(std::integral_constant<int, 1>{});
    } else if constexpr (MT == 2) {
      stages(std::integral_constant<int, 2>{});
    } else if constexpr (MT == 4) {
      if (mt_live == 2)
        stages(std::integral_constant<int, 2>{});
      else if (mt_live == 3)
        stages(std::integral_constant<int, 3>{});
      else
        stages(std::integral_constant<int, 4>{});
    }
    next_block(k_hi);
    // the partial tile in natural order over the ring, once every warp is
    // past its last stage
    named_sync(1, 32 * kQWarps);
    float* part_s = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part_s[(mi * 16 + g + 8 * (c >> 1)) * kQLdPart + 16 * cw + 4 * t +
                 2 * (c & 1) + j] = acc[mi][j][c];
  }
  __syncwarp();
  cluster.sync();  // every rank's partial tile is in its shared memory

  // this rank's slice of the out rows: the S partials added in rank order
  // for the live rows, zeros past them
  const int vecs = rows_out * (kQCols / 4);
  const int v_hi = (rank + 1) * vecs / S;
  float* part_s = reinterpret_cast<float*>(smem);
  for (int v = rank * vecs / S + threadIdx.x; v < v_hi; v += kQThreads) {
    const int r = v / (kQCols / 4), c = (v % (kQCols / 4)) * 4;
    if (n0 + c >= N) continue;  // N % 16 == 0: a vector is whole or out
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < live) {
      const int at = r * kQLdPart + c;
      float4 p[kQMaxSplits];
#pragma unroll
      for (int j = 0; j < kQMaxSplits; ++j)
        if (j < S)
          p[j] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part_s, j) + at);
      sum = p[0];
#pragma unroll
      for (int j = 1; j < kQMaxSplits; ++j)
        if (j < S) {
          sum.x += p[j].x;
          sum.y += p[j].y;
          sum.z += p[j].z;
          sum.w += p[j].w;
        }
    }
    store4<XT>(yb + (size_t)r * N + c, sum);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

template <typename XT, int MT>
int launch_q8_cluster(const void* x, const void* q, const float* scales,
                      const int* gs, void* y, int E, int C, int K, int N,
                      int block, int splits, cudaStream_t stream) {
  using SM = QSmem<MT>;
  const CUtensorMapDataType xt = std::is_same<XT, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tx, tw;
  if (int e = map_2d(&tx, xt, x, E * C, K, (long long)K * 2, 16, kQDepth))
    return e;
  if (int e = map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, E * K, N, N,
                     kQDepth, kQCols))
    return e;
  auto kernel = q8_cluster_kernel<XT, MT>;
  static bool sized = false;  // above 48 KB a kernel must ask, once
  if (!sized) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::kBytes))
      return (int)e;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kQCols - 1) / kQCols,
                     E * ((C + kQChunk - 1) / kQChunk), splits);
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes = SM::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, tx, tw, scales, gs,
                                         (XT*)y, C, K, N, block))
    return (int)e;
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_q8_cluster_rows(const void* x, const void* q, const float* scales,
                           const int* gs, void* y, int E, int C, int K, int N,
                           int block, int splits, cudaStream_t stream) {
  // m16 tiles a block holds: 1, 2 or 4 (C > 64: chunks of 64)
  if (C <= 16)
    return launch_q8_cluster<XT, 1>(x, q, scales, gs, y, E, C, K, N, block,
                                    splits, stream);
  if (C <= 32)
    return launch_q8_cluster<XT, 2>(x, q, scales, gs, y, E, C, K, N, block,
                                    splits, stream);
  return launch_q8_cluster<XT, 4>(x, q, scales, gs, y, E, C, K, N, block,
                                  splits, stream);
}

}  // namespace
}  // namespace grouped_gemm

using grouped_gemm::Args;

// C interface, loaded with ctypes. x [E*C, K] and y [E*C, N] contiguous, in
// the type `dtype` (0 f32, 1 bf16, 2 f16); gs [E] int32 on the device.
// Launches on `stream`, does not synchronise, returns the cudaGetLastError()
// code (cudaErrorInvalidValue for a pairing no instance takes; 10001 / 10002
// for a tensor map).
extern "C" {

const char* gg_error_string(int code) { return tma_error_string(code); }

// w: [E, K, N] in the x type with element strides (se, sk, sn). `instance` 0
// is the tile instance (bf16 or f32; K % 8 == 0, N % 8 == 0; sn == 1, the
// stored weight, or sk == 1, its transpose read in place), 1 the general one
// (any K, N >= 1, any strides). `splits` K splits (tile instance, bf16 only;
// 1 = none) need `partial`, f32 [splits, E*C, N], and `tickets`, int32 [E,
// ceil(C/32), ceil(N/128)] zeroed (the kernel leaves them zeroed).
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
// N] (a ragged last scale block is fine). `instance` 2 is the cluster
// instance (bf16 or f16 x; K % 8, N % 16 and block % 16 zero; 16-byte
// aligned operands; `splits` K splits, 1 to 8, at most ceil(K / block)), 0
// the tile instance (f32 x; block % 32 == 0, N % 16 == 0), 1 the general
// one (any block >= 1).
int gg_q8_forward(int instance, const void* x, const void* w,
                  const void* scales, const void* gs, void* y, int E, int C,
                  int K, int N, int block, int splits, int dtype,
                  void* stream) {
  if (instance == 2) {
    (void)cudaGetLastError();  // report this launch's error, not a stale one
    const int units = block > 0 ? (K + block - 1) / block : 0;
    if (E <= 0 || C <= 0 || K <= 0 || N <= 0 || block <= 0 || !scales ||
        K % 8 || N % 16 || block % 16 || splits < 1 || splits > 8 ||
        splits > units)
      return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == grouped_gemm::kBF16)
      return grouped_gemm::launch_q8_cluster_rows<__nv_bfloat16>(
          x, w, (const float*)scales, (const int*)gs, y, E, C, K, N, block,
          splits, st);
    if (dtype == grouped_gemm::kF16)
      return grouped_gemm::launch_q8_cluster_rows<__half>(
          x, w, (const float*)scales, (const int*)gs, y, E, C, K, N, block,
          splits, st);
    return (int)cudaErrorInvalidValue;
  }
  if (instance == 0 && dtype != grouped_gemm::kF32)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, (const float*)scales, (const int*)gs, y, C, K, N, block,
         (long long)K * N, N, 1, 1, nullptr, nullptr};
  return grouped_gemm::launch(a, E, dtype, grouped_gemm::kWeightInt8,
                              instance, stream);
}

}  // extern "C"
