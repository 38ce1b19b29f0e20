// Fused linear cross-entropy forward for Hopper (sm_90a): per-row log-sum-exp
// and label logit of h . W^T without the [N, V] logits.
//
// Replaces the TPU kernel `_ce_kernel` of
// paddle_tpu/ops/fused_linear_cross_entropy.py (built by `_make_ce_call`,
// pallas_call at :220): a grid of (row tiles, vocab tiles) whose vocab index
// carries each row tile's running (max, sumexp, label logit) in VMEM scratch.
// Its body casts whatever float blocks it gets to f32; so do both instances
// here: h [N, D] and W [V, D] (the nn.Linear layout) in f32, bf16 or f16, in
// any mix, converted to f32 on load, labels int64, outputs lse [N] and pick
// [N] f32. A label outside [0, V) matches no column and leaves pick 0.
//
// Two instances; ops/fused_linear_cross_entropy.py picks one by one rule
// (`kernel_instance`), and the C entry refuses any other pairing:
//
//   tensor-core  D % 8 == 0 (16-byte rows for the tensor maps), any dtypes.
//     3xTF32 on wgmma: each f32 operand x is split into hi = x rounded to
//     TF32 and lo = x - hi (exact in f32) rounded to TF32 (`tf32`), and
//     h W^T = h_hi W_hi + h_hi W_lo + h_lo W_hi in f32 accumulators: each
//     product to ~2^-22 of itself, unbiased (clearing bits in place of the
//     rounding biased every product toward zero and left 1.1e-5 of max(|x|,
//     1) between lse or pick and the f32 plain version at D = 4096 on the
//     card, NVIDIA H100 80GB HBM3, 700 W). A 16-bit operand is
//     exact in TF32: its lo is zero and its products are skipped (two
//     products where one side is 16-bit, one where both are).
//     Grid (row tiles of 128, vocab splits); block = a producer warpgroup and
//     two consumer warpgroups of 64 rows (setmaxnreg: 40 / 232 registers).
//     - Copies: one producer lane keeps a ring of 4 stages full through TMA
//       (2-D maps, 32 columns of D a stage): h [128 rows] and W [128 vocab
//       rows], 128-byte swizzle for f32 (no swizzle for 16-bit).
//     - The W pass: the producer's other three warps turn each landed W tile
//       into the B operands in a ring of 3: an f32 tile becomes hi in place
//       and its lo in the ring, a 16-bit tile its f32 value in the ring
//       (wgmma reads TF32 only from 32-bit words). Raw words are never read
//       as TF32, so the result does not rest on how the tensor cores treat a
//       word's low 13 bits.
//     - Products: each consumer warpgroup loads its 64 rows of h from the
//       stage into registers (the A fragment of m64n128k8), splits them in
//       registers, and issues wgmma m64n128k8 against W read K-major from
//       shared memory. One k-step's products are a commit group; two
//       register sets of A alternate, one group in flight while the next is
//       prepared.
//     - Sums in two levels. The tensor cores accumulate one stage (32 of D)
//       from zero in 64 f32 registers a thread; the CUDA cores add each
//       stage's tile into another 64 in order, with rounding. The tensor
//       cores' own f32 accumulation truncates: over all of D (1536 products
//       into one accumulator at D = 4096) it biased every logit low, by
//       ~2.5e-5 of the logit (an lse of ~40 sat 0.001 under the f32 plain
//       version, NVIDIA H100 80GB HBM3, 700 W). This is why a tile is 128
//       columns, not 256: the second level takes the registers.
//     - Online update on the summed fragment once a vocab tile's D loop is
//       done: columns past V become -inf, each row's max and sum of exp by
//       quad shuffles (a row lives in one quad of one warp), the label logit
//       picked where its column is.
//     - Vocab split: split y walks `per` consecutive tiles of 128 columns;
//       the plan is a function of V and the SM count only (`split_plan`), so
//       a row's lse and pick do not depend on N or on the other rows. Each
//       split leaves its rows' (max, sum, pick) partials in device memory;
//       the row tile's last split to finish (a ticket counter, zero before
//       and after the launch) merges them in split order. One launch, no
//       atomics on values, two calls bitwise equal.
//   general      every other D (any D >= 1): the FMA kernel below, one block
//     of 256 threads per 32 rows sweeping every vocab tile of 512 in order,
//     scalar loads converted to f32, f32 FMAs (never TF32).
//
// Bound. 2 N D V flops: at N = D = 4096, V = 128256, 4.30e12, which is 64.2
// ms on the CUDA cores' 67 TFLOP/s of f32 and, as three TF32 products on the
// tensor cores' 494.7 TFLOP/s, 26.1 ms; the bytes (h and W read once, ~2.2
// GB) take ~0.65 ms. h is re-read from L2 for every vocab tile and W by every
// row tile: the grid runs row tiles fastest, so the blocks on the card at
// one time share their W tiles (and each h tile among the splits in flight).
// The tensor-core instance reads 45.0-45.6 device ms at that shape in f32
// (57-58% of the 3xTF32 rate) and 27.7 with bf16 hidden and weight (one
// product, bound 8.7 ms), NVIDIA H100 80GB HBM3, 700 W (PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// 16-bit word -> f32 (exact): bf16 by a shift, f16 by the conversion
__device__ __forceinline__ float from16(uint32_t u, bool bf16) {
  return bf16 ? __uint_as_float(u << 16)
              : __half2float(__ushort_as_half((unsigned short)u));
}

// ---------------------------------------------------------------------------
// tensor-core instance
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 128;            // h rows of a block: 2 warpgroups x 64
constexpr int kCols = 128;            // vocab columns of a tile (wgmma N)
constexpr int kDepth = 32;            // D columns of a stage (128 f32 bytes)
constexpr int kRaw = 4;               // TMA stages in flight
constexpr int kConv = 3;              // converted W stages
constexpr int kThreads = 384;         // producer warpgroup + 2 consumers
constexpr int kPass = 96;             // producer threads of the W pass
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;    // 2 x 128 x 232 + 128 x 40 <= 65536

// shared memory, from a 1024-aligned base: raw stage s at s * kStage (h
// [128][32] then W [128][32], f32-sized slots), converted stage j at kConvAt
// + j * kConvTile, then the mbarriers and the last-split flag
constexpr int kHSlot = kRows * kDepth * 4;          // 16 KB
constexpr int kWSlot = kCols * kDepth * 4;          // 16 KB
constexpr int kStage = kHSlot + kWSlot;
constexpr int kConvAt = kRaw * kStage;
constexpr int kConvTile = kWSlot;
constexpr int kBar = kConvAt + kConv * kConvTile;
// full, empty (kRaw each), conv, conv_empty (kConv each), the flag
constexpr int kBytes = kBar + 8 * (2 * kRaw + 2 * kConv) + 16 + 1024;
static_assert(kBytes <= 232448, "one block's shared memory");

// finite x rounded to TF32, to nearest with ties away from zero (the rule
// of cvt.rna.tf32.f32, in two integer operations: the conversion runs at a
// fraction of their rate, and with it the kernel took 52.5-52.8 device ms
// against 41-43 at phase 3b's shape, NVIDIA H100 80GB HBM3, 700 W): an f32
// word whose low 13 mantissa bits are zero
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a K-major shared-memory matrix descriptor with the 128-byte swizzle (8-row
// groups 1024 bytes apart)
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] (+)= A[64 x 8] B[8 x 128]: A from registers (TF32 words a[4]), B
// K-major in shared memory; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator layout of m64nNk8 (f32): warp w of the warpgroup owns rows
// 16w + lane/4 (+8); register i holds row +8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2 * (lane & 3) + (i & 1). The A fragment (TF32) of the same
// warp: a0 (row lane/4, k lane%4), a1 (row + 8, same k), a2 (row, k + 4),
// a3 (row + 8, k + 4).
//
// H32 / W32: h / W in f32 (else 16-bit, bf16 where h_bf16 / w_bf16).
template <bool H32, bool W32>
__global__ void __launch_bounds__(kThreads, 1)
    linear_ce_fwd_tc(const __grid_constant__ CUtensorMap th,
                     const __grid_constant__ CUtensorMap tw,
                     const long long* __restrict__ labels,
                     float* __restrict__ lse_out, float* __restrict__ pick_out,
                     float* __restrict__ partial, int* __restrict__ tickets,
                     int N, int D, int V, int per, int h_bf16, int w_bf16) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + kBar, empty = full + 8 * kRaw;
  const uint32_t conv = empty + 8 * kRaw, conv_empty = conv + 8 * kConv;
  int* last_flag = reinterpret_cast<int*>(smem + kBar + 8 * (2 * kRaw +
                                                             2 * kConv));

  const int row0 = blockIdx.x * kRows, split = blockIdx.y;
  const int n_tiles = (V + kCols - 1) / kCols;
  const int t0 = split * per, t1 = min(t0 + per, n_tiles);
  const int n_k = (D + kDepth - 1) / kDepth;
  const int n_stages = (t1 - t0) * n_k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr uint32_t kHBytes = kRows * kDepth * (H32 ? 4 : 2);
  constexpr uint32_t kWBytes = kCols * kDepth * (W32 ? 4 : 2);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRaw; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    for (int j = 0; j < kConv; ++j) {
      mbar_init(conv + 8 * j, kPass);
      mbar_init(conv_empty + 8 * j, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == 8) {
      // the copies: h and W of every stage, in the consumers' order
      if (lane == 0) {
        for (int i = 0; i < n_stages; ++i) {
          const int s = i % kRaw, tile = t0 + i / n_k, k0 = (i % n_k) * kDepth;
          const uint32_t st = base + s * kStage;
          mbar_wait(empty + 8 * s, ((i / kRaw) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, kHBytes + kWBytes);
          tma_load_2d(st, &th, full + 8 * s, k0, row0);
          tma_load_2d(st + kHSlot, &tw, full + 8 * s, k0, tile * kCols);
        }
      }
      return;
    }
    // the W pass: B operands in f32 words, TF32-exact hi (in place) and lo
    const int p = threadIdx.x - 288;
    for (int i = 0; i < n_stages; ++i) {
      const int s = i % kRaw, j = i % kConv;
      unsigned char* wraw = smem + s * kStage + kHSlot;
      unsigned char* wconv = smem + kConvAt + j * kConvTile;
      mbar_wait(full + 8 * s, (i / kRaw) & 1);
      mbar_wait(conv_empty + 8 * j, ((i / kConv) & 1) ^ 1);
      if constexpr (W32) {
        // the same byte offsets in both tiles: the swizzle carries over
        for (int v = p; v < kCols * kDepth / 4; v += kPass) {
          const float4 x = reinterpret_cast<const float4*>(wraw)[v];
          const uint4 hi = make_uint4(tf32(x.x), tf32(x.y), tf32(x.z),
                                      tf32(x.w));
          const uint4 lo = make_uint4(tf32(x.x - __uint_as_float(hi.x)),
                                      tf32(x.y - __uint_as_float(hi.y)),
                                      tf32(x.z - __uint_as_float(hi.z)),
                                      tf32(x.w - __uint_as_float(hi.w)));
          reinterpret_cast<uint4*>(wraw)[v] = hi;
          reinterpret_cast<uint4*>(wconv)[v] = lo;
        }
      } else {
        // [128][32] 16-bit rows of 64 bytes -> f32 rows of 128 bytes in the
        // 128-byte swizzle: 16-byte chunk c of row r at (c ^ (r & 7))
        const bool bf = w_bf16;
        for (int v = p; v < kCols * kDepth / 8; v += kPass) {
          const int r = v >> 2, c8 = v & 3;
          const uint4 x = reinterpret_cast<const uint4*>(wraw)[v];
          const float4 f0 = make_float4(
              from16(x.x & 0xffffu, bf), from16(x.x >> 16, bf),
              from16(x.y & 0xffffu, bf), from16(x.y >> 16, bf));
          const float4 f1 = make_float4(
              from16(x.z & 0xffffu, bf), from16(x.z >> 16, bf),
              from16(x.w & 0xffffu, bf), from16(x.w >> 16, bf));
          float4* row = reinterpret_cast<float4*>(wconv + r * 128);
          row[(2 * c8) ^ (r & 7)] = f0;
          row[(2 * c8 + 1) ^ (r & 7)] = f1;
        }
      }
      // generic-proxy writes, read next by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(conv + 8 * j);
    }
    return;
  }

  // consumers: warpgroup `grp` owns rows 64 grp .. 64 grp + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int grp = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r_loc = 64 * grp + 16 * (warp & 3) + g;   // and r_loc + 8
  int lab[2];
  float m[2], ssum[2], pk[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + r_loc + 8 * hr;
    const long long l = r < N ? labels[r] : -1;
    lab[hr] = l >= 0 && l < V ? (int)l : -1;
    m[hr] = -INFINITY;
    ssum[hr] = 0.f;
    pk[hr] = 0.f;
  }
  // acc: one stage's products on the tensor cores, from zero; sum: every
  // stage's, added in f32 by the CUDA cores (the tensor cores' own f32
  // accumulation truncates, which over all of D biases a logit)
  float acc[64], sum[64];
  uint32_t ahi[2][4], alo[2][4];

  // the A fragment of k-step kk of stage s: h rows r_loc (+8), columns
  // 8 kk + t (+4), split into TF32 hi and lo (16-bit h: exact, no lo)
  auto load_a = [&](int s, int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const unsigned char* hs = smem + s * kStage;
    float x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r_loc + 8 * (q & 1), k = 8 * kk + t + 4 * (q >> 1);
      if constexpr (H32) {
        x[q] = *reinterpret_cast<const float*>(
            hs + r * 128 + ((((k >> 2) ^ (r & 7)) << 4) | ((k & 3) << 2)));
      } else {
        x[q] = from16(*reinterpret_cast<const unsigned short*>(
                          hs + r * 64 + k * 2),
                      h_bf16);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[q] = H32 ? tf32(x[q]) : __float_as_uint(x[q]);
      if constexpr (H32) lo[q] = tf32(x[q] - __uint_as_float(hi[q]));
    }
  };
  auto release = [&](int i) {
    mbar_arrive(empty + 8 * (i % kRaw));
    mbar_arrive(conv_empty + 8 * (i % kConv));
  };

  int i = 0;
  for (int tile = t0; tile < t1; ++tile) {
    for (int ks = 0; ks < n_k; ++ks, ++i) {
      const int s = i % kRaw, j = i % kConv;
      mbar_wait(conv + 8 * j, (i / kConv) & 1);
      mbar_wait(full + 8 * s, (i / kRaw) & 1);
      const uint32_t wconv = base + kConvAt + j * kConvTile;
      const uint32_t bhi = W32 ? base + s * kStage + kHSlot : wconv;
#pragma unroll
      for (int kk = 0; kk < kDepth / 8; ++kk) {
        // the set kk & 1 was read by the group before last, now done
        wgmma_wait<1>();
        load_a(s, kk, ahi[kk & 1], alo[kk & 1]);
        wgmma_fence();
        wgmma_tf32(acc, ahi[kk & 1], desc_k128(bhi + 32 * kk), kk > 0);
        if constexpr (W32)
          wgmma_tf32(acc, ahi[kk & 1], desc_k128(wconv + 32 * kk), 1);
        if constexpr (H32)
          wgmma_tf32(acc, alo[kk & 1], desc_k128(bhi + 32 * kk), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(acc);   // the reads of acc below stay after the wait
      release(i);
#pragma unroll
      for (int q = 0; q < 64; ++q) sum[q] = ks > 0 ? sum[q] + acc[q] : acc[q];
    }

    // the online update over this vocab tile
    const int cbase = tile * kCols + 2 * t;
    const bool tail = (tile + 1) * kCols > V;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int ai = 4 * (c >> 1) + 2 * hr + (c & 1);
        const int col = cbase + 8 * (c >> 1) + (c & 1);
        if (tail && col >= V) sum[ai] = -INFINITY;
        mx = fmaxf(mx, sum[ai]);
      }
      const float m_new = fmaxf(m[hr], quad_max(mx));
      float es = 0.f, pick = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int ai = 4 * (c >> 1) + 2 * hr + (c & 1);
        const int col = cbase + 8 * (c >> 1) + (c & 1);
        es += expf(sum[ai] - m_new);
        pick += col == lab[hr] ? sum[ai] : 0.f;   // one column, one thread
      }
      // the first tile: m == -inf, s == 0, so the rescale term is 0 * 0
      ssum[hr] = ssum[hr] * expf(m[hr] - m_new) + quad_sum(es);
      m[hr] = m_new;
      pk[hr] += pick;
    }
  }

  // this split's partials, then the row tile's last split merges them
  float* pm = partial + (size_t)split * 3 * N;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float p = quad_sum(pk[hr]);
    const int r = row0 + r_loc + 8 * hr;
    if (t == 0 && r < N) {
      pm[r] = m[hr];
      pm[N + r] = ssum[hr];
      pm[2 * N + r] = p;
    }
  }
  __threadfence();
  named_sync(1, 256);
  if (threadIdx.x == 0)
    *last_flag = atomicAdd(&tickets[blockIdx.x], 1) == (int)gridDim.y - 1;
  named_sync(1, 256);
  if (!*last_flag) return;
  __threadfence();
  const int r = row0 + threadIdx.x;
  if (threadIdx.x < kRows && r < N) {
    const int S = gridDim.y;
    float mx = -INFINITY;
    for (int y = 0; y < S; ++y)
      mx = fmaxf(mx, __ldcg(partial + (size_t)y * 3 * N + r));
    float sum = 0.f, pick = 0.f;
    for (int y = 0; y < S; ++y) {
      const float* py = partial + (size_t)y * 3 * N;
      sum += __ldcg(py + N + r) * expf(__ldcg(py + r) - mx);
      pick += __ldcg(py + 2 * N + r);
    }
    lse_out[r] = mx + logf(sum);
    pick_out[r] = pick;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;  // ready for the next call
}

CUtensorMapDataType map_type(int dtype) {
  return dtype == kF32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

template <bool H32, bool W32>
int launch(const void* h, const void* w, const long long* labels, float* lse,
           float* pick, float* partial, int* tickets, int N, int D, int V,
           int splits, int per, int h_bf16, int w_bf16, cudaStream_t stream) {
  CUtensorMap th, tw;
  const int hs = H32 ? 4 : 2, ws = W32 ? 4 : 2;
  const CUtensorMapSwizzle sh = H32 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUtensorMapSwizzle sw = W32 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (int e = map_2d(&th, map_type(H32 ? kF32 : h_bf16 ? kBF16 : kF16), h, N,
                     D, (long long)D * hs, kRows, kDepth, sh))
    return e;
  if (int e = map_2d(&tw, map_type(W32 ? kF32 : w_bf16 ? kBF16 : kF16), w, V,
                     D, (long long)D * ws, kCols, kDepth, sw))
    return e;
  auto kernel = linear_ce_fwd_tc<H32, W32>;
  static bool sized = false;  // above 48 KB a kernel must ask, once
  if (!sized) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes))
      return (int)e;
    sized = true;
  }
  kernel<<<dim3((N + kRows - 1) / kRows, splits), kThreads, kBytes, stream>>>(
      th, tw, labels, lse, pick, partial, tickets, N, D, V, per, h_bf16,
      w_bf16);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// general instance: f32 FMAs on the CUDA cores, any D >= 1
// ---------------------------------------------------------------------------
namespace gen {

constexpr int kRows = 32;            // rows per block
constexpr int kCols = 512;           // vocab columns per tile
constexpr int kStep = 8;             // depth of one staged slab of D
constexpr int kThreads = 256;        // 64 (tx) x 4 (ty)
constexpr int kLdA = kRows + 4;      // As[kStep][kLdA], h transposed
constexpr int kLdB = kCols + 4;      // Bs[kStep][kLdB], W transposed

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// element i of an f32 (F32) or 16-bit array, as f32
template <bool F32>
__device__ __forceinline__ float load(const void* p, size_t i, bool bf16) {
  if constexpr (F32) return __ldg(reinterpret_cast<const float*>(p) + i);
  return from16(__ldg(reinterpret_cast<const unsigned short*>(p) + i), bf16);
}

// four consecutive elements k .. k + 3 of a row (zeros past D or a dead row)
template <bool F32>
__device__ __forceinline__ float4 load4(const void* p, size_t row_at, int k,
                                        int D, bool live, bool bf16) {
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = live && k + q < D ? load<F32>(p, row_at + k + q, bf16) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// One block per tile of 32 rows sweeps every vocab tile of 512 columns in
// order, so the running state of its rows never leaves the block. Each vocab
// tile is an f32 [32 x D] . [D x 512] product: h and W are staged through
// double-buffered shared memory 8 columns of D at a time (the next slab is
// fetched into registers while the current one computes), and each of the
// 256 threads keeps an 8 x 8 block of logits in registers (rows 8 ty .. 8 ty
// + 7, columns 4 tx .. 4 tx + 3 and 256 + 4 tx .. 256 + 4 tx + 3). Then the
// tile's columns past V become -inf and the online update runs per row.
template <bool H32, bool W32>
__global__ void __launch_bounds__(kThreads)
    linear_ce_fwd_general(const void* __restrict__ h,
                          const void* __restrict__ w,
                          const long long* __restrict__ labels,
                          float* __restrict__ lse_out,
                          float* __restrict__ pick_out, int N, int D, int V,
                          int h_bf16, int w_bf16) {
  __shared__ __align__(16) float As[2][kStep][kLdA];
  __shared__ __align__(16) float Bs[2][kStep][kLdB];
  __shared__ float red_max[2][kRows];  // per half of a row's 64 threads
  __shared__ float red_sum[2][kRows];
  __shared__ float m_run[kRows], s_run[kRows], p_run[kRows];
  __shared__ long long lab_s[kRows];

  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const int lane = tid & 31, half = tx >> 5;
  const int n0 = blockIdx.x * kRows;
  if (tid < kRows) {
    m_run[tid] = -INFINITY;
    s_run[tid] = 0.f;
    p_run[tid] = 0.f;
    lab_s[tid] = n0 + tid < N ? labels[n0 + tid] : -1;
  }
  // this thread's slab loads: four h values (threads < 64), 4 x 4 of W
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const bool a_live = tid < 2 * kRows && n0 + a_row < N;
  const size_t a_at = (size_t)(n0 + a_row) * D;
  const int n_steps = (D + kStep - 1) / kStep;
  const int n_vt = (V + kCols - 1) / kCols;

  for (int vt = 0; vt < n_vt; ++vt) {
    const int v0 = vt * kCols;
    float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rb[4];
    auto fetch = [&](int st) {
      const int k0 = st * kStep;
      ra = load4<H32>(h, a_at, k0 + a_k, D, a_live, h_bf16);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = tid + u * kThreads, c = idx >> 1;
        rb[u] = load4<W32>(w, (size_t)(v0 + c) * D, k0 + (idx & 1) * 4, D,
                           v0 + c < V, w_bf16);
      }
    };
    auto stash = [&](int buf) {
      if (tid < 2 * kRows) {
        As[buf][a_k + 0][a_row] = ra.x;
        As[buf][a_k + 1][a_row] = ra.y;
        As[buf][a_k + 2][a_row] = ra.z;
        As[buf][a_k + 3][a_row] = ra.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = tid + u * kThreads, c = idx >> 1, k = (idx & 1) * 4;
        Bs[buf][k + 0][c] = rb[u].x;
        Bs[buf][k + 1][c] = rb[u].y;
        Bs[buf][k + 2][c] = rb[u].z;
        Bs[buf][k + 3][c] = rb[u].w;
      }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int st = 0; st < n_steps; ++st) {
      const int buf = st & 1;
      if (st + 1 < n_steps) fetch(st + 1);
#pragma unroll
      for (int kk = 0; kk < kStep; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 8]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[buf][kk][ty * 8 + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][256 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (st + 1 < n_steps) stash(buf ^ 1);
      __syncthreads();
    }

    // the online update over this vocab tile
    int col[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      col[j] = v0 + (j < 4 ? tx * 4 + j : 256 + tx * 4 + j - 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (col[j] >= V) acc[i][j] = -INFINITY;  // ragged vocab tail
        mx = fmaxf(mx, acc[i][j]);
      }
      mx = warp_max(mx);
      if (lane == 0) red_max[half][ty * 8 + i] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty * 8 + i;
      const float m_new =
          fmaxf(m_run[row], fmaxf(red_max[0][row], red_max[1][row]));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sum += expf(acc[i][j] - m_new);
        // one column per row can hold the label: a single writer
        if (col[j] == lab_s[row] && col[j] < V) p_run[row] += acc[i][j];
      }
      sum = warp_sum(sum);
      if (lane == 0) red_sum[half][row] = sum;
    }
    __syncthreads();
    if (tid < kRows) {
      const float m_old = m_run[tid];
      const float m_new =
          fmaxf(m_old, fmaxf(red_max[0][tid], red_max[1][tid]));
      s_run[tid] = s_run[tid] * expf(m_old - m_new) +
                   (red_sum[0][tid] + red_sum[1][tid]);
      m_run[tid] = m_new;
    }
    __syncthreads();
  }
  if (tid < kRows && n0 + tid < N) {
    lse_out[n0 + tid] = m_run[tid] + logf(s_run[tid]);
    pick_out[n0 + tid] = p_run[tid];
  }
}

template <bool H32, bool W32>
void launch(const void* h, const void* w, const long long* labels, float* lse,
            float* pick, int N, int D, int V, int h_bf16, int w_bf16,
            cudaStream_t stream) {
  linear_ce_fwd_general<H32, W32><<<(N + kRows - 1) / kRows, kThreads, 0,
                                    stream>>>(h, w, labels, lse, pick, N, D,
                                              V, h_bf16, w_bf16);
}

}  // namespace gen

template <bool H32, bool W32>
int dispatch(int instance, const void* h, const void* w,
             const long long* labels, float* lse, float* pick, float* partial,
             int* tickets, int N, int D, int V, int splits, int per,
             int h_bf16, int w_bf16, cudaStream_t stream) {
  if (instance == 0) {
    // every split takes at least one vocab tile, and the splits all of them
    const long long tiles = (V + tc::kCols - 1) / tc::kCols;
    if (D % 8 || splits < 1 || per < 1 || !partial || !tickets ||
        (long long)(splits - 1) * per >= tiles ||
        (long long)splits * per < tiles)
      return (int)cudaErrorInvalidValue;
    return tc::launch<H32, W32>(h, w, labels, lse, pick, partial, tickets, N,
                                D, V, splits, per, h_bf16, w_bf16, stream);
  }
  gen::launch<H32, W32>(h, w, labels, lse, pick, N, D, V, h_bf16, w_bf16,
                        stream);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. h [N, D] and w [V, D] contiguous, of the
// types `h_type` / `w_type` (0 f32, 1 bf16, 2 f16), labels [N] int64, outputs
// lse [N] and pick [N] f32. `instance` 0 is the tensor-core kernel (D % 8 ==
// 0, 16-byte aligned h and w; vocab split y of `splits` takes tiles of 256
// columns [y per, (y + 1) per), every split at least one; `partial` f32 [3
// splits N] scratch; `tickets` int32 [ceil(N / 128)] zeroed, left zeroed), 1
// the general one (any D >= 1). Launches on `stream`, does not synchronise,
// returns the cudaGetLastError() code (cudaErrorInvalidValue for a pairing
// no instance takes; 10001 / 10002 for a tensor map).
extern "C" {

const char* ce_error_string(int code) { return tma_error_string(code); }

int ce_forward(int instance, const void* h, const void* w, const void* labels,
               void* lse, void* pick, int N, int D, int V, int h_type,
               int w_type, int splits, int per, void* partial, void* tickets,
               void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  if (N <= 0 || V <= 0 || D <= 0 || (instance != 0 && instance != 1) ||
      h_type < kF32 || h_type > kF16 || w_type < kF32 || w_type > kF16)
    return (int)cudaErrorInvalidValue;
  const bool h32 = h_type == kF32, w32 = w_type == kF32;
  const int hb = h_type == kBF16, wb = w_type == kBF16;
  auto* lab = (const long long*)labels;
  auto* l = (float*)lse;
  auto* p = (float*)pick;
  auto* part = (float*)partial;
  auto* tk = (int*)tickets;
  cudaStream_t s = (cudaStream_t)stream;
  if (h32 && w32)
    return dispatch<true, true>(instance, h, w, lab, l, p, part, tk, N, D, V,
                                splits, per, hb, wb, s);
  if (h32)
    return dispatch<true, false>(instance, h, w, lab, l, p, part, tk, N, D, V,
                                 splits, per, hb, wb, s);
  if (w32)
    return dispatch<false, true>(instance, h, w, lab, l, p, part, tk, N, D, V,
                                 splits, per, hb, wb, s);
  return dispatch<false, false>(instance, h, w, lab, l, p, part, tk, N, D, V,
                                splits, per, hb, wb, s);
}

}  // extern "C"
