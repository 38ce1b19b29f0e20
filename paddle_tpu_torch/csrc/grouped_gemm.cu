// Grouped GEMM over ragged per-expert row blocks for Hopper (sm_90a), float
// weights (bf16, f16 or f32) and int8 weights with per-block f32 scales.
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
// Both kernels' f32 x and general instances are csrc/tile_gemm.cuh (their
// grid, masking, numbers and bound are described there). Here the grid's
// third axis is the expert and the group sizes are read on the device, so
// routing never syncs with the host. 16-bit x runs the two cluster
// instances below, one design for both weight kinds: at serving shapes (an
// expert's live rows <= 64) each is bound by its weight bytes, and the design
// is about reading each of them once, with enough in flight, and spending no
// barrier or shared-memory pass on the weights between their landing and the
// products.
//
// The float kernel's cluster instance (`float_cluster_kernel`: bf16 or f16 x
// and weights of one type, K % 8, N % 8; the MoE FFN in bf16 and its dx).
// Mixtral-8x7B's gate/up at 64 tokens reads 940 MB of weights: with x and
// the out, 0.285 ms at 3.35 TB/s (H100 SXM); it reads 0.3245 device ms there,
// `torch.bmm` 0.3097 in the same call, and 0.3096 at 8 tokens (NVIDIA H100
// 80GB HBM3, 700 W, PERF.md).
// - No conversion at all: a 16-bit weight tile is already the MMA's operand.
//   Raw tiles land by TMA (3-D maps over the strided [E, K, N] weight, so a
//   view's expert stride is its own, 128-byte swizzle, mbarriers): a
//   [64 k][128 n] tile as two [64][64] boxes for the stored weight, a
//   [128 n][64 k] box for its transpose (the backward's dx, read in place
//   through its strides). B fragments come straight from the raw tile, by
//   ldmatrix.trans from the N-contiguous one and by ldmatrix from the
//   K-contiguous one; x by ldmatrix from [16][64] boxes. One mbarrier wait a
//   stage, no shared-memory pass.
// - Streaming. The ring (110 KB a block, two blocks an SM) holds as many
//   stages of 16 KB of weights and the live rows' x boxes as fit: 6, 5, 5
//   or 4 at 1-4 live m16 tiles, the count fixed per block at run time, so
//   128-192 KB of weights an SM are in flight. Warp 0 refills each slot
//   once every warp has released it, as in the int8 instance.
// - One weight read per expert, the live tile count at compile time, the K
//   split over a cluster and its rank-order merge, 8 warps of 16 columns:
//   the int8 instance's design, below.
// - K and N tails are the maps' zero fill: a stage past K reads zeros in x
//   and in the weight, and a column tile past N is never stored.
//
// The int8 kernel's cluster instance (`q8_cluster_kernel`: 16-bit x, K % 8,
// N % 16, B % 16: the serving path). Mixtral-8x7B's gate/up at 64 tokens is
// bound at 0.149 ms; it reads 0.236 device ms there (NVIDIA H100 80GB HBM3,
// 700 W, PERF.md). Its design, which the float instance shares:
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

constexpr int kCCols = 128;            // out columns of a block
constexpr int kQDepth = 64;            // K rows of a stage
constexpr int kQStages = 6;            // stages in flight
constexpr int kCWarps = 8;             // warp w owns columns 16w .. 16w + 15
constexpr int kCThreads = 32 * kCWarps;
constexpr int kCChunk = 64;            // rows of an expert a block covers
constexpr int kCMaxSplits = 8;         // blocks of a cluster
constexpr int kCLdPart = kCCols + 4;   // f32 partial tile row stride

// shared memory of the MT-tile instance (up to 16 MT live rows): the ring of
// stages (weights, then x), then the mbarriers; the partial tile reuses the
// ring. The base is aligned to 1024 bytes (the swizzle repeats every 8 rows).
template <int MT>
struct QSmem {
  static constexpr int kW = kQDepth * kCCols;           // 8 KB of int8
  static constexpr int kXBox = 16 * kQDepth * 2;        // [16][64] 16-bit
  static constexpr int kStage = kW + MT * kXBox;
  static constexpr int kBar = kQStages * kStage;
  static constexpr int kBytes = kBar + 16 * kQStages + 1024;
  static_assert(kStage % 1024 == 0, "stages keep the swizzle's alignment");
  static_assert(16 * MT * kCLdPart * 4 <= kBar, "the partial tile fits");
};

// four columns of an out row (8-byte aligned: N % 8 == 0) in one store
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

// The two cluster kernels' chunk with no live row: this rank's share of the
// block's zeros (out rows [0, rows_out) of `yb`, its 128 columns), and no
// read. Every rank of the cluster agrees that the chunk is dead.
template <typename XT>
__device__ __forceinline__ void zero_chunk(XT* yb, int rows_out, int n0,
                                           int N, int rank, int S) {
  const int vecs = rows_out * (kCCols / 4);
  for (int v = rank * vecs / S + threadIdx.x; v < (rank + 1) * vecs / S;
       v += kCThreads) {
    const int r = v / (kCCols / 4), c = (v % (kCCols / 4)) * 4;
    if (n0 + c < N)
      store4<XT>(yb + (size_t)r * N + c, make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// The two cluster kernels' epilogue, once every rank's f32 partial tile
// (row stride kCLdPart) is at the start of its shared memory: this rank's
// slice of the out rows, the S partials added in rank order through
// distributed shared memory for the live rows, zeros past them. Every out
// element is one sum in one fixed order, whatever the other rows.
template <typename XT>
__device__ __forceinline__ void merge_ranks(cg::cluster_group& cluster,
                                            float* part_s, XT* yb, int live,
                                            int rows_out, int n0, int N,
                                            int rank, int S) {
  __syncwarp();
  cluster.sync();  // every rank's partial tile is in its shared memory
  const int vecs = rows_out * (kCCols / 4);
  const int v_hi = (rank + 1) * vecs / S;
  for (int v = rank * vecs / S + threadIdx.x; v < v_hi; v += kCThreads) {
    const int r = v / (kCCols / 4), c = (v % (kCCols / 4)) * 4;
    if (n0 + c >= N) continue;  // N % 8 == 0: a vector is whole or out
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < live) {
      const int at = r * kCLdPart + c;
      float4 p[kCMaxSplits];
#pragma unroll
      for (int j = 0; j < kCMaxSplits; ++j)
        if (j < S)
          p[j] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part_s, j) + at);
      sum = p[0];
#pragma unroll
      for (int j = 1; j < kCMaxSplits; ++j)
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

// f(integral_constant<L>) for the live m16 tile count L = mt_live of an
// MT-tile instance (1 <= mt_live <= MT; MT is 1, 2 or 4), so that a stage
// loop specialised on L issues nothing for dead tiles
template <int MT, typename F>
__device__ __forceinline__ void with_live_tiles(int mt_live, F&& f) {
  if (mt_live == 1) {
    f(std::integral_constant<int, 1>{});
  } else if constexpr (MT == 2) {
    f(std::integral_constant<int, 2>{});
  } else if constexpr (MT == 4) {
    if (mt_live == 2)
      f(std::integral_constant<int, 2>{});
    else if (mt_live == 3)
      f(std::integral_constant<int, 3>{});
    else
      f(std::integral_constant<int, 4>{});
  }
}

// Grid (column tiles, E * chunks, S), clusters of (1, 1, S): block (n, e *
// chunks + m, r) computes the partial sums of expert e's out rows [64 m, 64 m
// + 64) (its live ones) and columns [128 n, 128 n + 128) over the r-th share
// of the scale blocks.
template <typename XT, int MT>
__global__ void __launch_bounds__(kCThreads, 2)
    q8_cluster_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      const float* __restrict__ scales,
                      const int* __restrict__ gs, XT* __restrict__ y, int C,
                      int K, int N, int block) {
  using SM = QSmem<MT>;
  const int chunks = (C + kCChunk - 1) / kCChunk;
  const int e = blockIdx.y / chunks, m0 = (blockIdx.y % chunks) * kCChunk;
  const int n0 = blockIdx.x * kCCols;
  const int rows_out = min(kCChunk, C - m0);   // out rows of the block
  const int live = min(max(min(gs[e], C) - m0, 0), rows_out);
  XT* yb = y + ((size_t)e * C + m0) * N + n0;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  if (live == 0) {  // zeros, no weight read
    zero_chunk<XT>(yb, rows_out, n0, N, rank, S);
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
      mbar_init(empty + 8 * s, kCWarps);
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
    with_live_tiles<MT>(mt_live, stages);
    next_block(k_hi);
    // the partial tile in natural order over the ring, once every warp is
    // past its last stage
    named_sync(1, 32 * kCWarps);
    float* part_s = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part_s[(mi * 16 + g + 8 * (c >> 1)) * kCLdPart + 16 * cw + 4 * t +
                 2 * (c & 1) + j] = acc[mi][j][c];
  }
  merge_ranks<XT>(cluster, reinterpret_cast<float*>(smem), yb, live,
                  rows_out, n0, N, rank, S);
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
                     kQDepth, kCCols))
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
  cfg.gridDim = dim3((N + kCCols - 1) / kCCols,
                     E * ((C + kCChunk - 1) / kCChunk), splits);
  cfg.blockDim = dim3(kCThreads);
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

// ---------------------------------------------------------------------------
// The float kernel's cluster instance: 16-bit x and weights of one type.
// ---------------------------------------------------------------------------

constexpr int kFDepth = 64;             // K rows of a stage: 128 bytes of x
constexpr int kFRing = 110 * 1024;      // ring bytes a block: two an SM

// shared memory of every instance: a ring of kFRing bytes, then the
// mbarriers of up to kFMaxStages stages. A stage is a [64 k][128 n] weight
// tile (two [64][64] boxes) or a [128 n][64 k] one (its transpose), 16 KB
// either way, then the block's live [16][64 k] x boxes, so the ring holds
// as many stages as the live rows leave room for (6, 5, 5 and 4 at 1-4
// live m16 tiles); the partial tile reuses the ring.
constexpr int kFW = kFDepth * kCCols * 2;
constexpr int kFXBox = 16 * kFDepth * 2;
constexpr int kFMaxStages = 8;
constexpr int kFBytes = kFRing + 16 * kFMaxStages + 1024;
static_assert(kFW % 1024 == 0 && kFXBox % 1024 == 0,
              "stages keep the swizzle's alignment");
static_assert(16 * 4 * kCLdPart * 4 <= kFRing, "the partial tile fits");

// Grid (column tiles, E * chunks, S), clusters of (1, 1, S): block (n, e *
// chunks + m, r) computes the partial sums of expert e's out rows [64 m, 64 m
// + 64) (its live ones) and columns [128 n, 128 n + 128) over the r-th share
// of K's 64-deep stages. KMAJ: the weight is read K-contiguous (the
// backward's transposed view), else N-contiguous (the stored [E, K, N]).
template <typename XT, int MT, bool KMAJ>
__global__ void __launch_bounds__(kCThreads, 2)
    float_cluster_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const int* __restrict__ gs, XT* __restrict__ y,
                         int C, int K, int N) {
  const int chunks = (C + kCChunk - 1) / kCChunk;
  const int e = blockIdx.y / chunks, m0 = (blockIdx.y % chunks) * kCChunk;
  const int n0 = blockIdx.x * kCCols;
  const int rows_out = min(kCChunk, C - m0);   // out rows of the block
  const int live = min(max(min(gs[e], C) - m0, 0), rows_out);
  XT* yb = y + ((size_t)e * C + m0) * N + n0;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  if (live == 0) {  // zeros, no weight read
    zero_chunk<XT>(yb, rows_out, n0, N, rank, S);
    return;
  }
  const int mt_live = (live + 15) / 16;
  const int stage_bytes = kFW + mt_live * kFXBox;
  const int kS = min(kFMaxStages, kFRing / stage_bytes);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + kFRing, empty = full + 8 * kFMaxStages;
  // this rank's K rows [k_lo, k_hi): whole stages but the last rank's tail,
  // which the maps zero-fill past K in x and in the weight
  const int units = (K + kFDepth - 1) / kFDepth;
  const int k_lo = rank * units / S * kFDepth;
  const int k_hi = min((rank + 1) * units / S * kFDepth, K);
  const int n_st = (k_hi - k_lo + kFDepth - 1) / kFDepth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kCWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage i into ring slot s: the weight tile and the live rows' x boxes
  auto issue = [&](int i, int s) {
    const int k = k_lo + i * kFDepth;
    const uint32_t st = base + s * stage_bytes;
    mbar_expect_tx(full + 8 * s, stage_bytes);
    if constexpr (KMAJ) {
      tma_load_3d(st, &tw, full + 8 * s, k, n0, e);
    } else {
      tma_load_3d(st, &tw, full + 8 * s, n0, k, e);
      tma_load_3d(st + kFW / 2, &tw, full + 8 * s, n0 + 64, k, e);
    }
    for (int mi = 0; mi < mt_live; ++mi)
      tma_load_2d(st + kFW + mi * kFXBox, &tx, full + 8 * s, k,
                  e * C + m0 + 16 * mi);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(n_st, kS); ++i) issue(i, i);

  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
  // warp w: columns 16 w .. 16 w + 15 of the block, mma tile j the 8 from
  // 16 w + 8 j; a thread holds columns 2t, 2t + 1 of each tile
  float acc[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][j][c] = 0.f;
  // one 16-deep step at stage row 16 kk over the first L m16 tiles
  auto step = [&](auto live_tiles, uint32_t st, int kk) {
    constexpr int L = decltype(live_tiles)::value;
    // B fragments of both mma tiles straight from the swizzled raw tile:
    // matrix `mat` is k half (mat & 1) of column half (mat >> 1)
    uint32_t b[4];
    if constexpr (KMAJ) {
      // rows n of 64 k (128 bytes): ldmatrix gives a lane (n, k pair)
      const int n = 16 * warp + (mat >> 1) * 8 + (lane & 7);
      const int ch = 2 * kk + (mat & 1);
      ldmatrix_x4(b, st + n * 128 + ((ch ^ (n & 7)) << 4));
    } else {
      // rows k of 64 n (128 bytes) in the warp's box: .trans gives the same
      const int k = 16 * kk + (mat & 1) * 8 + (lane & 7);
      const int ch = 2 * (warp & 3) + (mat >> 1);
      ldmatrix_x4_trans(b, st + (warp >> 2) * (kFW / 2) + k * 128 +
                               ((ch ^ (k & 7)) << 4));
    }
#pragma unroll
    for (int mi = 0; mi < L; ++mi) {
      const int row = mi * 16 + (mat & 1) * 8 + (lane & 7);
      const int kc = kk * 2 + (mat >> 1);
      uint32_t a[4];
      ldmatrix_x4(a, st + kFW + row * 128 + ((kc ^ (row & 7)) * 16));
      mma16816<XT>(acc[mi][0], a, b[0], b[1]);
      mma16816<XT>(acc[mi][1], a, b[2], b[3]);
    }
  };
  auto stages = [&](auto live_tiles) {
    int s = 0, phase = 0;  // stage i's slot and its barriers' parity
    for (int i = 0; i < n_st; ++i) {
      const uint32_t st = base + s * stage_bytes;
      mbar_wait(full + 8 * s, phase);
#pragma unroll
      for (int kk = 0; kk < kFDepth / 16; ++kk) step(live_tiles, st, kk);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      // warp 0 refills the slot once every warp is done with it
      if (warp == 0 && lane == 0 && i + kS < n_st) {
        mbar_wait(empty + 8 * s, phase);
        issue(i + kS, s);
      }
      __syncwarp();
      if (++s == kS) {
        s = 0;
        phase ^= 1;
      }
    }
  };
  with_live_tiles<MT>(mt_live, stages);
  // the partial tile in natural order over the ring, once every warp is past
  // its last stage (every stage issued has been waited for)
  named_sync(1, kCThreads);
  float* part_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part_s[(mi * 16 + g + 8 * (c >> 1)) * kCLdPart + 16 * warp + 8 * j +
               2 * t + (c & 1)] = acc[mi][j][c];
  merge_ranks<XT>(cluster, part_s, yb, live, rows_out, n0, N, rank, S);
}

template <typename XT, int MT, bool KMAJ>
int launch_float_cluster(const void* x, const void* w, const int* gs, void* y,
                         int E, int C, int K, int N, long long se,
                         long long sk, long long sn, int splits,
                         cudaStream_t stream) {
  const CUtensorMapDataType dt = std::is_same<XT, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tx, tw;
  if (int e = map_2d(&tx, dt, x, E * C, K, (long long)K * 2, 16, kFDepth))
    return e;
  // [E][N][K] boxes of [128 n][64 k], or [E][K][N] boxes of [64 k][64 n]
  if (int e = KMAJ ? map_3d(&tw, dt, w, K, N, E, sn * 2, se * 2, kFDepth,
                            kCCols)
                   : map_3d(&tw, dt, w, N, K, E, sk * 2, se * 2, 64,
                            kFDepth))
    return e;
  auto kernel = float_cluster_kernel<XT, MT, KMAJ>;
  static bool sized = false;  // above 48 KB a kernel must ask, once
  if (!sized) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFBytes))
      return (int)e;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kCCols - 1) / kCCols,
                     E * ((C + kCChunk - 1) / kCChunk), splits);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = kFBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, tx, tw, gs, (XT*)y, C,
                                         K, N))
    return (int)e;
  return (int)cudaGetLastError();
}

template <typename XT, bool KMAJ>
int launch_float_cluster_rows(const void* x, const void* w, const int* gs,
                              void* y, int E, int C, int K, int N,
                              long long se, long long sk, long long sn,
                              int splits, cudaStream_t stream) {
  // m16 tiles a block holds: 1, 2 or 4 (C > 64: chunks of 64)
  if (C <= 16)
    return launch_float_cluster<XT, 1, KMAJ>(x, w, gs, y, E, C, K, N, se, sk,
                                             sn, splits, stream);
  if (C <= 32)
    return launch_float_cluster<XT, 2, KMAJ>(x, w, gs, y, E, C, K, N, se, sk,
                                             sn, splits, stream);
  return launch_float_cluster<XT, 4, KMAJ>(x, w, gs, y, E, C, K, N, se, sk,
                                           sn, splits, stream);
}

template <typename XT>
int launch_float_cluster_layout(const void* x, const void* w, const int* gs,
                                void* y, int E, int C, int K, int N,
                                long long se, long long sk, long long sn,
                                int splits, cudaStream_t stream) {
  if (sn == 1)
    return launch_float_cluster_rows<XT, false>(x, w, gs, y, E, C, K, N, se,
                                                sk, sn, splits, stream);
  return launch_float_cluster_rows<XT, true>(x, w, gs, y, E, C, K, N, se, sk,
                                             sn, splits, stream);
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

// w: [E, K, N] in the x type with element strides (se, sk, sn). `instance`
// 2 is the cluster instance (bf16 or f16; K % 8 == 0, N % 8 == 0; sn == 1,
// the stored weight, or sk == 1, its transpose read in place; the other
// strides multiples of 8 and 16-byte aligned operands; `splits` K splits, 1
// to 8, at most ceil(K / 64)), 0 the tile instance (f32; K % 8 == 0, N % 8
// == 0, sn == 1 or sk == 1), 1 the general one (any K, N >= 1, any strides).
int gg_forward(int instance, const void* x, const void* w, const void* gs,
               void* y, int E, int C, int K, int N, long long se, long long sk,
               long long sn, int splits, int dtype, void* stream) {
  if (instance == 2) {
    (void)cudaGetLastError();  // report this launch's error, not a stale one
    const bool n_major = sn == 1, k_major = sk == 1;
    const long long other = n_major ? sk : sn;
    if (E <= 0 || C <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 ||
        !(n_major || k_major) || other % 8 || se % 8 || splits < 1 ||
        splits > 8 || splits > (K + 63) / 64)
      return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == grouped_gemm::kBF16)
      return grouped_gemm::launch_float_cluster_layout<__nv_bfloat16>(
          x, w, (const int*)gs, y, E, C, K, N, se, sk, sn, splits, st);
    if (dtype == grouped_gemm::kF16)
      return grouped_gemm::launch_float_cluster_layout<__half>(
          x, w, (const int*)gs, y, E, C, K, N, se, sk, sn, splits, st);
    return (int)cudaErrorInvalidValue;
  }
  Args a{x, w, nullptr, (const int*)gs, y, C, K, N, 0, se, sk, sn};
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
         (long long)K * N, N, 1};
  return grouped_gemm::launch(a, E, dtype, grouped_gemm::kWeightInt8,
                              instance, stream);
}

}  // extern "C"
