// Decode-step paged attention for Hopper (sm_90a), replacing the TPU kernel
// paddle_tpu/ops/paged_attention.py `_make_paged` (pallas_call at :153, body
// `_decode_kernel` at :84): one query token per sequence, GQA, over a
// head-major paged pool [P, Hk, page, D] read through per-sequence block
// tables, with an f32 online softmax.
//
// The TPU kernel runs grid (B, Hk, max_pages) and carries (m, l, acc) in VMEM
// scratch from one page's grid step to the next. What both instances here
// compute is the same: row b's query heads of kv head hk attend the first
// n = min(context_len, W * page) keys (only the first ceil(n / page) table
// entries are read, live entries clamped into [0, P) as the reference clamps
// them), scores in f32, the finite -1e30 mask, the online softmax with expf,
// and a row with context_len 0 writes zeros (the reference's Pallas kernel
// divides 0 / 0 there).
//
// Bound. Decode is memory-bound: the least time is the live K/V pages + q +
// out + the table entries over 3.35 TB/s (H100 SXM); 4 * D flops per (query
// head, key) pair are far below the tensor cores' rate. The design keeps the
// card's memory busy:
//
// - Split over the sequence, planned on the device from the row alone. A
//   block takes one (row, kv head, tile of the group's query heads, split of
//   the row's keys). A split holds kSplitUnit keys, half that where the row
//   attends at most kLongKeys / 2 and twice that past kLongKeys (`plan`;
//   halving the short rows' splits took 8 decode rows of 64-544 keys from
//   0.0156 to 0.0125 device ms, NVIDIA H100 80GB HBM3 at 700 W; mirrored by
//   `split_plan` in ops/paged_attention.py): a function of the row's own
//   context and the table's capacity, so the grid (B, Hk, tiles x
//   grid_splits(W * page)) is fixed by the shapes and needs no copy of the
//   lengths to the host; blocks past their row's split count exit at once.
//   A row with one split writes its output; otherwise each split leaves its
//   unnormalised (acc, max, sum) in scratch, and the last split of the (row,
//   kv head, tile) to finish (one ticket counter each, the only atomic, left
//   at zero) merges them in split order. Every sum's order depends on the
//   row's context and the shapes alone: a row is bitwise the same alone and
//   among others, and two calls agree bit for bit.
// - Tensor cores for 16-bit pools (namespace tc). A tile is the m16 of
//   mma.sync m16n8k16: 16 query heads of the group (G = 4 fills a quarter,
//   which costs nothing in a memory-bound kernel; larger groups take more
//   tiles). S = Q K^T and O += P V accumulate in f32 registers; K reaches the
//   mma by ldmatrix, V by ldmatrix.trans. q of the pools' dtype goes in as it
//   is and the softmax scale multiplies the f32 scores; an f32 q goes in as
//   the 16-bit parts that sum to it (three for bf16, two for f16), and so
//   does P. The result is f32-grade against the plain version, not bitwise.
// - Whole 8-key boxes per copy. A (page, kv head) of K or V is contiguous, so
//   the pool is one 2-D tensor of [P * Hk * page] rows of D values: each
//   step of 16 keys is 2 x ceil(D / 64) TMA boxes of 8 rows x 64 values
//   (128-byte swizzle, so ldmatrix reads no bank twice; columns past D read
//   as zeros), issued by one lane into its warp's own ring of kStages steps
//   and completed on an mbarrier. Each of the 4 warps walks every 4th step
//   of the split, keeps kStages steps in flight, and the warps' states meet
//   in shared memory at the end, in warp order. A step whose second 8 keys
//   lie past the split re-reads its first 8 (masked, never summed), so every
//   key a sum touches came from the pool.
//
// The general instance (f32 and raw int8 pools; namespace gen) keeps the
// CUDA cores: q scaled in f32 as the reference scales it, one lane per (head,
// key) score, P.V one lane per column, each warp's (m, l, acc) in shared
// memory, 8-key tiles by cp.async into a ring of 3 per warp; it takes the
// same split plan, tiles of up to 8 query heads, and the same merge.
//
// What is left on the table: the group's 4 heads fill a quarter of each m16
// tile; the splits' partials go through device memory; a row's first split
// waits for its page ids and q before its first copy.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"
#include "tma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kSplitUnit = 256;    // keys of a split
constexpr int kLongKeys = 1024;    // past it, splits of twice that; up to
                                   // half of it, splits of half
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

}  // namespace

#include "split_merge.cuh"

namespace {

__device__ __forceinline__ int clamp_page(int p, int num_pages) {
  return p < 0 ? 0 : (p >= num_pages ? num_pages - 1 : p);
}

// The keys a row attends and their split: a function of the row's context
// and the table's capacity `cap` = W * page alone, never of the other rows
// or the card (ops/paged_attention.py `split_plan` applies the same rule).
struct Plan {
  int n_keys;    // keys [0, n_keys): the context, at most the table's
  int split;     // keys of a split
  int n_splits;
};

__host__ __device__ __forceinline__ Plan plan(int ctx, int cap) {
  Plan p;
  p.n_keys = ctx <= 0 ? 0 : imin(ctx, cap);
  p.split = p.n_keys > kLongKeys
                ? 2 * kSplitUnit
                : (p.n_keys > kLongKeys / 2 ? kSplitUnit : kSplitUnit / 2);
  p.n_splits = (p.n_keys + p.split - 1) / p.split;
  return p;
}

// the grid's splits: the most that any row of a `cap`-slot table takes
inline int grid_splits(int cap) {
  const int shortest = (imin(cap, kLongKeys / 2) + kSplitUnit / 2 - 1) /
                       (kSplitUnit / 2);
  const int short_rows = (imin(cap, kLongKeys) + kSplitUnit - 1) / kSplitUnit;
  const int long_rows = (cap + 2 * kSplitUnit - 1) / (2 * kSplitUnit);
  return imax(imax(1, shortest), imax(short_rows, long_rows));
}

// The launch's scratch: the splits' partial rows (f32 [slabs, slab_rows, D]
// and [slabs, slab_rows, 2]) and one ticket per slab, a slab being one (row,
// kv head, tile); split s of a slab keeps its n_rows rows at s * n_rows.
struct Scratch {
  float* part_o;
  float* part_ml;
  int* tickets;
  int slab_rows;
};

// The block's share of a slab's end: when the row has more than one split,
// the slab's last split to finish (its ticket, a counter left at zero for
// the next launch) merges the n_rows rows of every split, one warp a row.
// Called by every thread of the block after its partial rows are written.
template <typename T>
__device__ void finish_slab(const Scratch& sc, size_t slab, int n_rows,
                            int n_splits, T* out_rows, int D, int* flag,
                            int n_warps) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __threadfence();
  __syncthreads();
  int* ticket = sc.tickets + slab;
  if (tid == 0) flag[0] = atomicAdd(ticket, 1) == n_splits - 1;
  __syncthreads();
  if (!flag[0]) return;
  __threadfence();
  for (int i = warp; i < n_rows; i += n_warps)
    merge_row(sc.part_o, sc.part_ml, out_rows + (size_t)i * D,
              slab * sc.slab_rows + i, n_rows, n_splits, D, lane);
  if (tid == 0) *ticket = 0;
}

// A tile's rows of out as zeros, 16 bytes a thread (a row's D * sizeof(T)
// bytes are a multiple of 16)
template <typename T>
__device__ void zero_rows(T* dst, int n_rows, int D) {
  const int vecs = D * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < n_rows * vecs; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// ---------------------------------------------------------------------------
// The tensor-core instance: bf16 or f16 pools (TP), q and out in TP or f32
// (TQ), head_dim % 8 == 0 up to 256, any page % 8 == 0.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;      // query heads of a tile: the mma's m
constexpr int kKeys = 16;      // keys of a step: one k-step of P V
constexpr int kBoxCols = 64;   // 16-bit values of a box row: 128 bytes
constexpr int kBoxBytes = 8 * kBoxCols * 2;   // a box: 8 key rows
constexpr int kMaxTab = 2 * kSplitUnit / 8 + 1;  // pages a split spans

// steps in flight per warp: three at head_dim <= 128, two above
__host__ __device__ constexpr int stages(int DB) { return DB <= 128 ? 3 : 2; }
__host__ __device__ __forceinline__ int col_boxes(int D) {
  return (D + kBoxCols - 1) / kBoxCols;
}
// bytes of one step's K (or V): two 8-key row groups of col_boxes boxes
__host__ __device__ __forceinline__ int step_bytes(int D) {
  return 2 * col_boxes(D) * kBoxBytes;
}
// the warps' exchange after the key walk (in the ring): each warp's
// accumulator fragments and its rows' (max, sum)
__host__ __device__ constexpr int red_bytes(int DB) {
  return kWarps * (DB / 2 + 4) * 32 * 4;
}
// a q row of 16-bit values in shared memory (ceil(D / 16) k-steps), padded
// by 16 bytes where its 16-byte units are even: 8 rows of an ldmatrix then
// hit 32 banks
__host__ __device__ __forceinline__ int q_stride(int D) {
  const int units = (D + 15) / 16 * 2;
  return 16 * (units % 2 ? units : units + 1);
}

template <typename T>
constexpr int kParts = std::is_same<T, bf16>::value ? 3 : 2;
template <typename TP, typename TQ>
constexpr int kQParts = std::is_same<TP, TQ>::value ? 1 : kParts<TP>;

__host__ __device__ __forceinline__ size_t ring_bytes(int D, int DB) {
  const size_t ring = (size_t)kWarps * stages(DB) * 2 * step_bytes(D);
  return ring > (size_t)red_bytes(DB) ? ring : (size_t)red_bytes(DB);
}

// the block's shared memory: [ring (1024-aligned)][q parts][page ids]
// [barriers][flag], + 1024 bytes to align the ring's start
__host__ __device__ __forceinline__ size_t smem_bytes(int D, int DB,
                                                      int q_parts) {
  return 1024 + ring_bytes(D, DB) + (size_t)q_parts * kRows * q_stride(D) +
         4 * kMaxTab + 8 * kWarps * stages(DB) + 16;
}

// byte offset of 16-byte chunk c of key row j of a step's K or V, where the
// TMA wrote it: box (j / 8, c / 8), row j % 8 of 128 bytes, the chunk XORed
// with the row (the 128-byte swizzle; the ring is 1024-byte aligned)
__device__ __forceinline__ uint32_t swz(int j, int c, int ncb) {
  return ((j >> 3) * ncb + (c >> 3)) * kBoxBytes + (j & 7) * 128 +
         (((c & 7) ^ (j & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack2(float a, float b, bf16*) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half*) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t u, bf16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float2 unpack2(uint32_t u, __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// (x0, x1) as pairs of T whose sum is x to about f32's precision: hi = T(x),
// then the rest rounded again, N parts
template <typename T, int N>
__device__ __forceinline__ void split_parts(float x0, float x1,
                                            uint32_t (&parts)[3]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t u = pack2(x0, x1, (T*)nullptr);
    parts[k] = u;
    const float2 f = unpack2(u, (T*)nullptr);
    x0 -= f.x;
    x1 -= f.y;
  }
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  dst[0] = from_f32<T>(a);
  dst[1] = from_f32<T>(b);
}

// Grid (tiles x splits, Hk, B): block (tile + tiles * s, hk, b) takes query
// heads hk * G + 16 tile .. + 15 (n_rows of them valid) of row b over the
// keys of split s. Accumulator layout of m16n8k16 (f32): c0, c1 are row g =
// lane / 4, columns 2t, 2t + 1 (t = lane % 4) of the n-tile; c2, c3 row g +
// 8. S's two n-tiles are the A fragment of P V for the step's 16 keys; O's
// n-tile n is columns 8n .. 8n + 7 of D.
template <typename TP, typename TQ, int DB>
__global__ void __launch_bounds__(kThreads) decode_tc(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const TQ* __restrict__ q,
    const int* __restrict__ tables, const int* __restrict__ lens,
    TQ* __restrict__ out, Scratch sc, int H, int Hk, int D, int P, int page,
    int W, int tiles, float scale) {
  constexpr int kStages = stages(DB);
  constexpr int kQp = kQParts<TP, TQ>;
  constexpr bool kQRegs = kQp == 1 && DB <= 128;  // q fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const int ncb = col_boxes(D), sb = step_bytes(D), qs = q_stride(D);
  const size_t rb = ring_bytes(D, DB);
  unsigned char* q_s = smem + rb;   // [kQp][kRows][qs]
  int* tab_s = reinterpret_cast<int*>(q_s + (size_t)kQp * kRows * qs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uintptr_t>(tab_s + kMaxTab + 1) & ~(uintptr_t)7);
  int* flag = reinterpret_cast<int*>(bars + kWarps * kStages);

  const int b = blockIdx.z, hk = blockIdx.y;
  const int tile = blockIdx.x % tiles, split_idx = blockIdx.x / tiles;
  const int G = H / Hk;
  const int n_rows = imin(kRows, G - tile * kRows);
  const size_t head0 = (size_t)b * H + hk * G + tile * kRows;
  const Plan pl = plan(lens[b], W * page);
  if (pl.n_splits == 0) {
    if (split_idx == 0) zero_rows(out + head0 * D, n_rows, D);
    return;
  }
  if (split_idx >= pl.n_splits) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k_lo = split_idx * pl.split;
  const int k_hi = imin(k_lo + pl.split, pl.n_keys);
  const int n_steps = (k_hi - k_lo + kKeys - 1) / kKeys;
  const int pg_lo = k_lo / page;
  const int n_pg = (k_hi - 1) / page - pg_lo + 1;
  const uint32_t ring = smem_u32(smem);
  const uint32_t bar0 = smem_u32(bars);

  if (tid == 0) {
    for (int i = 0; i < kWarps * kStages; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < n_pg; i += kThreads)
    tab_s[i] = clamp_page(tables[(size_t)b * W + pg_lo + i], P);
  __syncthreads();   // barriers and page ids are ready

  // warp w walks steps w, w + 4, ...; its i-th into ring slot i % kStages.
  // Each 8-key row group is one box per 64 columns of K and of V; a row
  // group past the split re-reads the step's first (its keys are masked).
  const int my_steps = warp < n_steps ? (n_steps - warp + kWarps - 1) / kWarps
                                      : 0;
  auto slot_k = [&](int i) {
    return ring + (uint32_t)((warp * kStages + i % kStages) * 2) * sb;
  };
  auto bar = [&](int i) { return bar0 + 8 * (warp * kStages + i % kStages); };
  auto issue = [&](int i) {
    const int k0 = k_lo + (warp + i * kWarps) * kKeys;
    const uint32_t kd = slot_k(i), vd = kd + sb, br = bar(i);
    mbar_expect_tx(br, 2 * sb);
#pragma unroll
    for (int rg = 0; rg < 2; ++rg) {
      const int key = k0 + 8 * rg < k_hi ? k0 + 8 * rg : k0;
      const int pi = key / page;
      const int row = (tab_s[pi - pg_lo] * Hk + hk) * page + key - pi * page;
      for (int cb = 0; cb < ncb; ++cb) {
        const uint32_t off = (rg * ncb + cb) * kBoxBytes;
        tma_load_2d(kd + off, &kmap, br, cb * kBoxCols, row);
        tma_load_2d(vd + off, &vmap, br, cb * kBoxCols, row);
      }
    }
  };
  if (lane == 0)
    for (int i = 0; i < imin(kStages, my_steps); ++i) issue(i);

  // q rows of the tile as 16-bit parts (columns past D and rows past n_rows
  // zero), 8 columns a thread
  const int chunks = (D + 15) / 16 * 2;
  for (int idx = tid; idx < kRows * chunks; idx += kThreads) {
    const int i = idx / chunks, d0 = 8 * (idx - i * chunks);
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.f;
    if (i < n_rows && d0 < D) {
      const TQ* src = q + (head0 + i) * D + d0;
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = to_f32(src[e]);
    }
#pragma unroll
    for (int p = 0; p < kQp; ++p) {
      TP* dst = reinterpret_cast<TP*>(q_s + (p * kRows + i) * qs) + d0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const TP v = from_f32<TP>(x[e]);
        dst[e] = v;
        x[e] -= to_f32(v);
      }
    }
  }
  __syncthreads();

  // A fragments of the tile's 16 rows: ldmatrix row lane & 15, columns
  // 8 (lane >> 4) of each 16-column k-step
  const uint32_t qa = smem_u32(q_s) + (lane & 15) * qs + (lane >> 4) * 16;
  uint32_t qf[kQRegs ? DB / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int c = 0; c < DB / 16; ++c)
      if (16 * c < D) ldmatrix_x4(qf[c], qa + c * 32);
  }
  float o[DB / 8][4];
#pragma unroll
  for (int n = 0; n < DB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int i = 0; i < my_steps; ++i) {
    mbar_wait(bar(i), (i / kStages) & 1);
    const uint32_t kb = slot_k(i), vb = kb + sb;
    const int k0 = k_lo + (warp + i * kWarps) * kKeys;

    // S = Q K^T: two n-tiles of 8 keys; an ldmatrix.x4 of K covers two
    // k-steps
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < DB / 16; c += 2) {
      if (16 * c >= D) break;
      const bool two = 16 * (c + 1) < D;
      uint32_t af[kQp][2][4];
#pragma unroll
      for (int p = 0; p < kQp; ++p)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !two) break;
          if constexpr (kQRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) af[p][u][e] = qf[c + u][e];
          } else {
            ldmatrix_x4(af[p][u], qa + p * kRows * qs + (c + u) * 32);
          }
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kb + swz(8 * j + (lane & 7), 2 * c + (lane >> 3), ncb));
#pragma unroll
        for (int p = 0; p < kQp; ++p) {
          mma16816<TP>(s[j], af[p][0], bk[0], bk[1]);
          if (two) mma16816<TP>(s[j], af[p][1], bk[2], bk[3]);
        }
      }
    }

    // the online softmax on the registers, as the plain version computes it
    // (expf of the f32 score less the running max; masked keys contribute 0)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * t + (e & 1);
        const float x = k0 + kj < k_hi ? s[j][e] * scale : kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      alpha[hr] = expf(m[hr] - mx[hr]);
      m[hr] = mx[hr];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * t + (e & 1), hr = e >> 1;
        const float p = k0 + kj < k_hi ? expf(s[j][e] - m[hr]) : 0.f;
        ps[hr] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + ps[hr];
#pragma unroll
    for (int n = 0; n < DB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += (P_1 + P_2 [+ P_3]) V; V rows by ldmatrix.trans
    uint32_t pa[3][4];
    {
      uint32_t p4[4][3];
      split_parts<TP, kParts<TP>>(s[0][0], s[0][1], p4[0]);
      split_parts<TP, kParts<TP>>(s[0][2], s[0][3], p4[1]);
      split_parts<TP, kParts<TP>>(s[1][0], s[1][1], p4[2]);
      split_parts<TP, kParts<TP>>(s[1][2], s[1][3], p4[3]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int a = 0; a < 4; ++a) pa[k][a] = p4[a][k];
    }
#pragma unroll
    for (int n = 0; n < DB / 8; n += 2) {
      if (8 * n >= D) break;
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vb + swz(lane & 15, n + (lane >> 4), ncb));
#pragma unroll
      for (int k = 0; k < kParts<TP>; ++k) {
        mma16816<TP>(o[n], pa[k], bv[0], bv[1]);
        if (8 * (n + 1) < D) mma16816<TP>(o[n + 1], pa[k], bv[2], bv[3]);
      }
    }
    // every lane is done with the slot before its lane 0 refills it
    __syncwarp();
    if (lane == 0 && i + kStages < my_steps) issue(i + kStages);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  // the warps meet in shared memory (the ring, drained: every warp waited
  // for every copy it issued): warps 1-3 leave their state in their
  // fragment layout, and warp 0 adds them in warp order
  __syncthreads();
  constexpr int kRegs = DB / 2;   // o values a thread
  float* red = reinterpret_cast<float*>(smem);   // [warp][reg][lane]
  float* red_ml = red + kWarps * kRegs * 32;     // [warp][m, m, l, l][lane]
  if (warp > 0) {
#pragma unroll
    for (int n = 0; n < DB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * kRegs + 4 * n + e) * 32 + lane] = o[n][e];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      red_ml[(warp * 4 + hr) * 32 + lane] = m[hr];
      red_ml[(warp * 4 + 2 + hr) * 32 + lane] = l[hr];
    }
  }
  __syncthreads();
  const size_t slab = ((size_t)b * Hk + hk) * tiles + tile;
  if (warp == 0) {
    float wq[kWarps][2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt = m[hr];
#pragma unroll
      for (int u = 1; u < kWarps; ++u)
        mt = fmaxf(mt, red_ml[(u * 4 + hr) * 32 + lane]);
      float lt = 0.f;
#pragma unroll
      for (int u = 0; u < kWarps; ++u) {
        const float mu = u == 0 ? m[hr] : red_ml[(u * 4 + hr) * 32 + lane];
        const float lu =
            u == 0 ? l[hr] : red_ml[(u * 4 + 2 + hr) * 32 + lane];
        wq[u][hr] = expf(mu - mt);
        lt += wq[u][hr] * lu;
      }
      m[hr] = mt;
      l[hr] = lt;
    }
#pragma unroll
    for (int n = 0; n < DB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = o[n][e] * wq[0][e >> 1];
#pragma unroll
        for (int u = 1; u < kWarps; ++u)
          x += wq[u][e >> 1] * red[(u * kRegs + 4 * n + e) * 32 + lane];
        o[n][e] = x;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = g + 8 * hr;
      if (i >= n_rows) continue;
      float* po = nullptr;
      TQ* dst = out + (head0 + i) * D;
      const size_t prow =
          slab * sc.slab_rows + (size_t)split_idx * n_rows + i;
      if (pl.n_splits > 1) po = sc.part_o + prow * D;
#pragma unroll
      for (int n = 0; n < DB / 8; ++n) {
        if (8 * n >= D) break;
        if (po)
          store2(po + 8 * n + 2 * t, o[n][2 * hr], o[n][2 * hr + 1]);
        else
          store2(dst + 8 * n + 2 * t, over(o[n][2 * hr], l[hr]),
                 over(o[n][2 * hr + 1], l[hr]));
      }
      if (po && t == 0) {
        sc.part_ml[2 * prow] = m[hr];
        sc.part_ml[2 * prow + 1] = l[hr];
      }
    }
  }
  if (pl.n_splits > 1)
    finish_slab(sc, slab, n_rows, pl.n_splits, out + head0 * D, D, flag,
                kWarps);
}

template <typename TP>
constexpr CUtensorMapDataType kMapType =
    std::is_same<TP, bf16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;

template <typename TP, typename TQ, int DB>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lens, void* out, const Scratch& sc,
           int B, int H, int Hk, int D, int P, int page, int W, float scale,
           cudaStream_t stream) {
  // the pools as [P * Hk * page] rows of D values, boxes of 8 rows x 64
  // values (columns past D read as zeros)
  const long long rows = (long long)P * Hk * page;
  CUtensorMap kmap, vmap;
  if (int rc = map_2d(&kmap, kMapType<TP>, k_pages, (int)rows, D, 2LL * D, 8,
                      kBoxCols))
    return rc;
  if (int rc = map_2d(&vmap, kMapType<TP>, v_pages, (int)rows, D, 2LL * D, 8,
                      kBoxCols))
    return rc;
  const size_t smem = smem_bytes(D, DB, kQParts<TP, TQ>);
  auto kernel = decode_tc<TP, TQ, DB>;
  if (smem > 48 * 1024) {
    // above 48 KB only after an explicit opt-in; a refused launch never
    // runs and is reported only by cudaGetLastError
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // the largest shared-memory carveout, so two blocks share a SM
  if (const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared))
    return (int)e;
  const int tiles = (H / Hk + kRows - 1) / kRows;
  kernel<<<dim3(tiles * grid_splits(W * page), Hk, B), kThreads, smem,
           stream>>>(kmap, vmap, (const TQ*)q, (const int*)tables,
                     (const int*)lens, (TQ*)out, sc, H, Hk, D, P, page, W,
                     tiles, scale);
  return (int)cudaGetLastError();
}

template <typename TP, typename TQ>
int launch_d(const void* q, const void* k_pages, const void* v_pages,
             const void* tables, const void* lens, void* out,
             const Scratch& sc, int B, int H, int Hk, int D, int P, int page,
             int W, float scale, cudaStream_t s) {
  if (D <= 128)
    return launch<TP, TQ, 128>(q, k_pages, v_pages, tables, lens, out, sc, B,
                               H, Hk, D, P, page, W, scale, s);
  return launch<TP, TQ, 256>(q, k_pages, v_pages, tables, lens, out, sc, B,
                             H, Hk, D, P, page, W, scale, s);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The general instance: f32 or int8 pools (TKV), q and out in f32, on the
// CUDA cores.
// ---------------------------------------------------------------------------
namespace gen {

constexpr int kRows = 8;       // query heads of a tile
constexpr int kTile = 8;       // keys of a copy
constexpr int kStages = 3;     // tiles of a warp's ring
constexpr int kMaxWarps = 8;

// four consecutive elements widened to f32 (16-byte aligned for f32, 4 for
// int8)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// `bytes` (16 or 8) bytes global -> shared
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Padded strides: q rows (f32) at 8 (mod 32) words and K/V tile rows at 16
// (mod 128) bytes, so the lanes of one score step, 4 heads x 8 keys, hit
// distinct banks.
__host__ __device__ inline int q_stride(int D) {
  return D + (40 - D % 32) % 32;
}
__host__ __device__ inline int row_bytes(int D, int esize) {
  const int b = D * esize;
  return b + (144 - b % 128) % 128;
}

// Shared memory of one block for tiles of rt = min(G, kRows) heads: [q: rt
// x QS f32][rings: NW x kStages x (K, V) x kTile rows][acc: NW x rt x D
// f32][p: NW x rt x kTile][m, l, alpha: NW x rt][flag]
__host__ __device__ inline size_t smem_bytes(int rt, int D, int esize,
                                             int nw) {
  return sizeof(float) * (size_t)rt * q_stride(D) +
         (size_t)nw * kStages * 2 * kTile * row_bytes(D, esize) +
         sizeof(float) * (size_t)nw * rt * (D + kTile + 3) + 16;
}

// the most warps (8, 4, 2 or 1) whose block fits the card's shared memory
inline int pick_warps(int rt, int D, int esize) {
  for (int nw = kMaxWarps; nw > 1; nw /= 2)
    if (smem_bytes(rt, D, esize, nw) <= (size_t)kMaxSmem) return nw;
  return 1;
}

// Grid (tiles x splits, Hk, B): block (tile + tiles * s, hk, b) takes query
// heads hk * G + 8 tile .. (n_rows of them) of row b over the keys of split
// s. Its NW warps take the split's 8-key tiles (page % 8 == 0, so a tile
// never straddles a page) in a fixed interleave: warp w takes tiles w, w +
// NW, ..., streamed with cp.async into its own ring, and keeps its own f32
// (m, l, acc[n_rows, D]) in shared memory: scores one lane per (head, key),
// the softmax update by shuffles within each head's 8 lanes, P.V one lane
// per output column. Key slots of a tile past the split are copied (they
// lie in the same page) but never enter a sum.
template <typename TKV>
__global__ void __launch_bounds__(kMaxWarps * 32) decode_general(
    const float* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lens, float* __restrict__ out, Scratch sc,
    int H, int Hk, int D, int P, int page, int W, int tiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, hk = blockIdx.y;
  const int tile = blockIdx.x % tiles, split_idx = blockIdx.x / tiles;
  const int G = H / Hk;
  const int rt = imin(kRows, G);   // rows of a tile's per-warp state
  const int n_rows = imin(kRows, G - tile * kRows);
  const size_t head0 = (size_t)b * H + hk * G + tile * kRows;
  const Plan pl = plan(lens[b], W * page);
  if (pl.n_splits == 0) {
    if (split_idx == 0) zero_rows(out + head0 * D, n_rows, D);
    return;
  }
  if (split_idx >= pl.n_splits) return;
  const int nw = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int QS = q_stride(D);
  const int RB = row_bytes(D, (int)sizeof(TKV));
  const int tile_bytes = kTile * RB;

  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* rings = smem + sizeof(float) * (size_t)rt * QS;
  float* acc_all = reinterpret_cast<float*>(
      rings + (size_t)nw * kStages * 2 * tile_bytes);
  float* p_all = acc_all + (size_t)nw * rt * D;
  float* m_all = p_all + (size_t)nw * rt * kTile;
  float* l_all = m_all + (size_t)nw * rt;
  float* a_all = l_all + (size_t)nw * rt;
  int* flag = reinterpret_cast<int*>(a_all + (size_t)nw * rt);
  unsigned char* ring = rings + (size_t)w * kStages * 2 * tile_bytes;
  float* acc = acc_all + (size_t)w * rt * D;
  float* p_s = p_all + (size_t)w * rt * kTile;
  float* m_s = m_all + (size_t)w * rt;
  float* l_s = l_all + (size_t)w * rt;
  float* a_s = a_all + (size_t)w * rt;

  for (int i = tid; i < n_rows * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    q_s[g * QS + d] = q[(head0 + g) * D + d] * scale;
  }
  for (int i = lane; i < n_rows * D; i += 32) acc[i] = 0.f;
  for (int i = lane; i < n_rows; i += 32) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int k_lo = split_idx * pl.split;
  const int k_hi = imin(k_lo + pl.split, pl.n_keys);
  const int n_tiles = (k_hi - k_lo + kTile - 1) / kTile;
  const int my_tiles = w < n_tiles ? (n_tiles - w + nw - 1) / nw : 0;
  // 16-byte vectors of a row (8 for int8 rows of an odd number of 16)
  const int row_b = D * (int)sizeof(TKV);
  const int vb = row_b % 16 ? 8 : 16;
  const int row_vecs = row_b / vb;
  const int vecs = kTile * row_vecs;

  // the i-th tile of this warp into ring slot i % kStages
  auto issue = [&](int i) {
    const int key0 = k_lo + (w + i * nw) * kTile;
    const int pi = key0 / page;
    const int pid = clamp_page(tables[(size_t)b * W + pi], P);
    const size_t slot0 = ((size_t)pid * Hk + hk) * page + (key0 - pi * page);
    const unsigned char* kg =
        reinterpret_cast<const unsigned char*>(k_pages + slot0 * D);
    const unsigned char* vg =
        reinterpret_cast<const unsigned char*>(v_pages + slot0 * D);
    unsigned char* ks = ring + (size_t)(i % kStages) * 2 * tile_bytes;
    unsigned char* vs = ks + tile_bytes;
    for (int v = lane; v < vecs; v += 32) {
      const int j = v / row_vecs, c = v - j * row_vecs;
      cp_async(ks + j * RB + c * vb, kg + (size_t)v * vb, vb);
      cp_async(vs + j * RB + c * vb, vg + (size_t)v * vb, vb);
    }
  };

  // one group per step, empty or not, so wait_group counts stay aligned
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < my_tiles) issue(i);
    cp_async_commit();
  }
  const int slices = (n_rows * kTile + 31) / 32;  // 4 heads x 8 keys a slice
  for (int i = 0; i < my_tiles; ++i) {
    if (i + kStages - 1 < my_tiles) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* ks = ring + (size_t)(i % kStages) * 2 * tile_bytes;
    const unsigned char* vs = ks + tile_bytes;
    const int key0 = k_lo + (w + i * nw) * kTile;
    const int n_valid = imin(kTile, k_hi - key0);

    // scores and the softmax update: lane = (head within slice, key)
    for (int sl = 0; sl < slices; ++sl) {
      const int g = sl * 4 + (lane >> 3), j = lane & 7;
      const bool live = g < n_rows;
      float s = kNegInf;
      if (live && j < n_valid) {
        const float* qr = q_s + g * QS;
        const TKV* kr = reinterpret_cast<const TKV*>(ks + j * RB);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + d);
          const float4 k4 = load4(kr + d);
          s0 += a.x * k4.x;
          s1 += a.y * k4.y;
          s2 += a.z * k4.z;
          s3 += a.w * k4.w;
        }
        s = (s0 + s1) + (s2 + s3);
      }
      float m_cur = s;
      for (int o = 4; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = live ? m_s[g] : kNegInf;
      const float m_new = fmaxf(m_prev, m_cur);
      const float pe = (live && j < n_valid) ? expf(s - m_new) : 0.f;
      float sum = pe;
      for (int o = 4; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (live) {
        p_s[g * kTile + j] = pe;
        if (j == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
          a_s[g] = alpha;
        }
      }
    }
    __syncwarp();
    // P.V: lane owns columns d = lane + 32c of every head
    for (int d = lane; d < D; d += 32) {
      float vr[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        vr[j] = j < n_valid
                    ? to_f32(reinterpret_cast<const TKV*>(vs + j * RB)[d])
                    : 0.f;
      for (int g = 0; g < n_rows; ++g) {
        const float4 p0 = *reinterpret_cast<const float4*>(p_s + g * kTile);
        const float4 p1 =
            *reinterpret_cast<const float4*>(p_s + g * kTile + 4);
        float a = acc[g * D + d] * a_s[g];
        a += p0.x * vr[0];
        a += p0.y * vr[1];
        a += p0.z * vr[2];
        a += p0.w * vr[3];
        a += p1.x * vr[4];
        a += p1.y * vr[5];
        a += p1.z * vr[6];
        a += p1.w * vr[7];
        acc[g * D + d] = a;
      }
    }
    // every lane is done with this ring slot before it is refilled
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps' states in warp order: the output (l == 0, no key,
  // writes zeros) or the split's partial rows
  const size_t slab = ((size_t)b * Hk + hk) * tiles + tile;
  for (int i = tid; i < n_rows * D; i += blockDim.x) {
    const int g = i / D;
    float m = kNegInf;
    for (int u = 0; u < nw; ++u) m = fmaxf(m, m_all[u * rt + g]);
    float l = 0.f, a = 0.f;
    for (int u = 0; u < nw; ++u) {
      const float f = expf(m_all[u * rt + g] - m);
      l += l_all[u * rt + g] * f;
      a += acc_all[((size_t)u * rt) * D + i] * f;
    }
    if (pl.n_splits == 1) {
      out[head0 * D + i] = l > 0.f ? a / l : 0.f;
    } else {
      const size_t prow = slab * sc.slab_rows + (size_t)split_idx * n_rows + g;
      sc.part_o[prow * D + (i - g * D)] = a;
      if (i == g * D) {
        sc.part_ml[2 * prow] = m;
        sc.part_ml[2 * prow + 1] = l;
      }
    }
  }
  if (pl.n_splits > 1)
    finish_slab(sc, slab, n_rows, pl.n_splits, out + head0 * D, D, flag, nw);
}

template <typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lens, void* out, const Scratch& sc,
           int B, int H, int Hk, int D, int P, int page, int W, float scale,
           cudaStream_t stream) {
  const int rt = imin(kRows, H / Hk);
  const int nw = pick_warps(rt, D, (int)sizeof(TKV));
  const size_t smem = smem_bytes(rt, D, (int)sizeof(TKV), nw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_general<TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (H / Hk + kRows - 1) / kRows;
  decode_general<TKV><<<dim3(tiles * grid_splits(W * page), Hk, B), nw * 32,
                        smem, stream>>>(
      (const float*)q, (const TKV*)k_pages, (const TKV*)v_pages,
      (const int*)tables, (const int*)lens, (float*)out, sc, H, Hk, D, P,
      page, W, tiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace gen

}  // namespace

// C interface, loaded with ctypes. `instance` 0 is the tensor-core kernel
// (kv_dtype 0 bf16 or 1 f16 pools; q and out in the pools' dtype, or f32
// when q_f32 = 1), 1 the general one (kv_dtype 2 f32 or 3 int8 pools; q and
// out f32). tables [B, W] and lens [B] are int32; q, pools and out 16-byte
// aligned and contiguous. The scratch: `part_o` f32 [B, Hk, tiles,
// slab_rows, D], `part_ml` f32 [B, Hk, tiles, slab_rows, 2] and `tickets`
// int32 [B, Hk, tiles] (zero before the launch, left zero by it), with tiles
// = ceil(G / 16) (tensor-core) or ceil(G / 8) (general) and slab_rows >=
// pa_grid_splits(W * page) x min(G, 16 or 8). pa_attention launches on
// `stream`, does not synchronise, and returns the cudaGetLastError() code of
// its launch (0 on success), cudaErrorInvalidValue for a code or geometry no
// kernel takes, or a tensor map's error.
extern "C" {

const char* pa_error_string(int code) { return tma_error_string(code); }

int pa_grid_splits(int cap) { return grid_splits(cap); }

int pa_attention(int instance, int kv_dtype, int q_f32, const void* q,
                 const void* k_pages, const void* v_pages, const void* tables,
                 const void* lens, void* out, void* part_o, void* part_ml,
                 void* tickets, int B, int H, int Hk, int D, int P, int page,
                 int W, int slab_rows, float scale, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  if (D % 8 || D > 256 || page % 8 || Hk < 1 || H % Hk || W < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const int rows = instance == 0 ? tc::kRows : gen::kRows;
  if (slab_rows < grid_splits(W * page) * imin(rows, H / Hk))
    return (int)cudaErrorInvalidValue;
  const Scratch sc{(float*)part_o, (float*)part_ml, (int*)tickets, slab_rows};
  const cudaStream_t s = (cudaStream_t)stream;
  if (instance == 0) {
    if (kv_dtype == 0)
      return q_f32 ? tc::launch_d<bf16, float>(q, k_pages, v_pages, tables,
                                               lens, out, sc, B, H, Hk, D, P,
                                               page, W, scale, s)
                   : tc::launch_d<bf16, bf16>(q, k_pages, v_pages, tables,
                                              lens, out, sc, B, H, Hk, D, P,
                                              page, W, scale, s);
    if (kv_dtype == 1)
      return q_f32 ? tc::launch_d<__half, float>(q, k_pages, v_pages, tables,
                                                 lens, out, sc, B, H, Hk, D,
                                                 P, page, W, scale, s)
                   : tc::launch_d<__half, __half>(q, k_pages, v_pages, tables,
                                                  lens, out, sc, B, H, Hk, D,
                                                  P, page, W, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (instance != 1 || !q_f32) return (int)cudaErrorInvalidValue;
  if (kv_dtype == 2)
    return gen::launch<float>(q, k_pages, v_pages, tables, lens, out, sc, B,
                              H, Hk, D, P, page, W, scale, s);
  if (kv_dtype == 3)
    return gen::launch<int8_t>(q, k_pages, v_pages, tables, lens, out, sc, B,
                               H, Hk, D, P, page, W, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
