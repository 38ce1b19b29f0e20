// Flash attention forward and backward (dQ, dK/dV) with GQA, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/flash_attention.py: the forward
// `_fwd_kernel` (pallas_call at :155), the dQ kernel `_bwd_dq_kernel` (:279)
// and the dK/dV kernel `_bwd_dkv_kernel` (:299).
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, Hk, D], read through their (batch,
// seq, head) strides with unit stride along D (no transposes on the host);
// query head h reads kv head h / (H / Hk). Outputs are contiguous: out and
// dq [B, Sq, H, D], dk/dv [B, Sk, Hk, D], lse [B, H, Sq] f32. Causal
// alignment is bottom-right: query i sees keys j <= i + (Sk - Sq).
//
// Design. Every kernel works on 64-row tiles of q and k with 4 warps; a warp
// owns 16 rows of its block's tile. The products run on the tensor cores
// through WMMA (16x16x16 bf16, f32 accumulation); the softmax and the
// elementwise backward run in f32 on scores stored to shared memory, where
// each warp touches only its own rows. Probabilities P and the score
// gradient dS are f32 values that the products need in bf16: each is split
// into hi = bf16(x) and lo = bf16(x - hi) and multiplied twice, so the
// products see ~16 bits of mantissa and the kernels agree with the f32 plain
// version to f32 summation order (the bf16 inputs are exact operands).
//   forward  one block per (q tile, head, batch): Q fragments in registers,
//            K/V tiles streamed to the causal horizon, online softmax with a
//            finite -1e30 running max, the output accumulator in shared
//            memory (rescaled by each tile's alpha); lse = m + log l.
//   dQ       one block per (q tile, head, batch): Q and dO fragments in
//            registers, P = exp(S scale - lse) recomputed from the saved lse,
//            dS = P (dP - delta) scale, dQ += dS K in register accumulators.
//   dK/dV    one block per (k tile, kv head, batch): loops over the group's
//            query heads and the q tiles from the causal start block
//            max(0, (k0 - offset) / 64), streaming Q and dO tiles through
//            shared memory (the TPU kernel held the group's whole Q and dO in
//            VMEM); computes S^T = K Q^T and dP^T = V dO^T, so dV += P^T dO
//            and dK += dS^T Q need no transposed copies. The group's sum
//            stays in the block's register accumulators: no atomics, and
//            the result does not depend on scheduling.
//
// Bound. At training shapes (S = 2048, D = 128) the kernels are bound by
// operations: 4 D flops per unmasked (query, key) pair forward, 6 D for dQ,
// 8 D for dK/dV, against 989 TFLOP/s of dense bf16; the bytes (q, k, v, dO
// and the outputs, once each) are far below that line.
//
// What the simple design leaves on the table: WMMA through shared memory
// instead of wgmma with register-resident accumulators, scores and the
// output accumulator round-tripping through shared memory, one softmax row
// per warp step with shuffles, no cp.async/TMA pipelining of the K/V (or
// Q/dO) tiles, and the hi/lo split doubling the P and dS products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;              // q rows and k rows per tile
constexpr int kWarps = 4;              // a warp owns 16 rows of a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kPadH = 8;               // bf16 row padding: 16 bytes
constexpr int kPadF = 4;               // f32 row padding: 16 bytes
constexpr int kLdS = kTile + kPadF;    // f32 [64][68] score tiles
constexpr int kLdP = kTile + kPadH;    // bf16 [64][72] probability tiles
constexpr float kNegInf = -1e30f;      // the reference's finite mask value

struct Strides {
  long long b, s, h;  // element strides of batch, sequence, head
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
// B = X from a row-major [k][n] tile, and B = X^T from a row-major [n][k] one
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int D>
struct Dims {
  static constexpr int kLdH = D + kPadH;       // bf16 [64][D+8] q/k/v tiles
  static constexpr int kLdO = D + kPadF;       // f32 [64][D+4] accumulators
  static constexpr int kTileH = kTile * kLdH;  // elements of one tile
  static constexpr int kTileS = kTile * kLdS;
  static constexpr int kTileP = kTile * kLdP;
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static_assert(kTileH * 2 <= kTileS * 4, "a bf16 tile stages in a score tile");
  static_assert(kTile * kLdO * 4 <= 2 * kTileS * 4,
                "an f32 [64][D] tile stages in two score tiles");
};

// rows [row0, row0 + 64) of head `head` of a strided [B, S, H, D] tensor into
// a padded shared [64][D + 8] tile, as 16-byte vectors
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          Strides st, int b, int row0,
                                          int head) {
  constexpr int kVec = D / 8;
  const bf16* base = src + b * st.b + row0 * st.s + head * st.h;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i - r * kVec) * 8;
    *reinterpret_cast<uint4*>(dst + r * Dims<D>::kLdH + c) =
        *reinterpret_cast<const uint4*>(base + r * st.s + c);
  }
}

// 64 consecutive f32 values (one tile's lse or delta rows)
__device__ __forceinline__ void load_rows(float* dst, const float* src) {
  if (threadIdx.x < kTile) dst[threadIdx.x] = src[threadIdx.x];
}

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

// x = hi + lo to ~16 bits of mantissa, both bf16
__device__ __forceinline__ void split_bf16(float x, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
}

// acc (+)= A[16 rows of a][0:16*KS] . B where the operands come from shared
// tiles: a row-major [rows][lda], b as FragB/FragBt at b + kk * b_step
template <int KS, typename FB>
__device__ __forceinline__ void mma_row(FragC& acc, const bf16* a, int lda,
                                        const bf16* b, int ldb, int b_step) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    FragA fa;
    FB fb;
    wmma::load_matrix_sync(fa, a + kk * 16, lda);
    wmma::load_matrix_sync(fb, b + kk * b_step, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// the warp's 16 rows of an f32 [64][D] accumulator to a contiguous bf16
// output whose row r starts at out + r * row_stride
template <int D>
__device__ __forceinline__ void write_rows(bf16* out, long long row_stride,
                                           const float* acc, int wr,
                                           int lane) {
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i - r * D;
    out[(wr + r) * row_stride + c] =
        __float2bfloat16_rn(acc[(wr + r) * Dims<D>::kLdO + c]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, Strides qs, Strides ks,
                     Strides vs, int H, int Hk, int Sq, int Sk, int causal,
                     float scale) {
  using T = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                 // [64][D+8]
  bf16* v_s = k_s + T::kTileH;                               // [64][D+8]
  float* s_s = reinterpret_cast<float*>(v_s + T::kTileH);    // [64][68]
  bf16* ph_s = reinterpret_cast<bf16*>(s_s + T::kTileS);     // [64][72]
  bf16* pl_s = ph_s + T::kTileP;                             // [64][72]
  float* o_s = reinterpret_cast<float*>(pl_s + T::kTileP);   // [64][D+4]
  float* m_s = o_s + kTile * T::kLdO;                        // [64]
  float* l_s = m_s + kTile;                                  // [64]
  float* a_s = l_s + kTile;                                  // [64]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = qt * kTile, offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * 16;

  // Q stages through the score tile into the warp's register fragments
  bf16* q_stage = reinterpret_cast<bf16*>(s_s);
  load_tile<D>(q_stage, q, qs, b, q0, h);
  for (int i = threadIdx.x; i < kTile * T::kLdO; i += kThreads) o_s[i] = 0.f;
  if (threadIdx.x < kTile) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();
  FragA qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], q_stage + wr * T::kLdH + kk * 16,
                           T::kLdH);
  __syncthreads();

  int n_kt = Sk / kTile;
  // keys past the tile's last query (q0 + 63 + offset) are all masked
  if (causal) n_kt = min(n_kt, (q0 + 2 * kTile - 1 + offset) / kTile);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    load_tile<D>(k_s, k, ks, b, k0, hk);
    load_tile<D>(v_s, v, vs, b, k0, hk);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {  // S = Q K^T, the warp's rows
      FragC c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBt kb;
        wmma::load_matrix_sync(kb, k_s + n * 16 * T::kLdH + kk * 16, T::kLdH);
        wmma::mma_sync(c, qf[kk], kb, c);
      }
      wmma::store_matrix_sync(s_s + wr * kLdS + n * 16, c, kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();
    // online softmax, one row per step; lane owns columns lane, lane + 32
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r, qpos = q0 + row + offset;
      float s0 = s_s[row * kLdS + lane] * scale;
      float s1 = s_s[row * kLdS + lane + 32] * scale;
      if (causal) {
        if (k0 + lane > qpos) s0 = kNegInf;
        if (k0 + lane + 32 > qpos) s1 = kNegInf;
      }
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      split_bf16(p0, ph_s + row * kLdP + lane, pl_s + row * kLdP + lane);
      split_bf16(p1, ph_s + row * kLdP + lane + 32,
                 pl_s + row * kLdP + lane + 32);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
        a_s[row] = alpha;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = i / D, c = i - r * D;
      o_s[(wr + r) * T::kLdO + c] *= a_s[wr + r];
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {  // O += (P_hi + P_lo) V
      FragC c;
      float* o_tile = o_s + wr * T::kLdO + n * 16;
      wmma::load_matrix_sync(c, o_tile, T::kLdO, wmma::mem_row_major);
      mma_row<kTile / 16, FragB>(c, ph_s + wr * kLdP, kLdP, v_s + n * 16,
                                 T::kLdH, 16 * T::kLdH);
      mma_row<kTile / 16, FragB>(c, pl_s + wr * kLdP, kLdP, v_s + n * 16,
                                 T::kLdH, 16 * T::kLdH);
      wmma::store_matrix_sync(o_tile, c, T::kLdO, wmma::mem_row_major);
    }
    __syncthreads();  // k_s / v_s are reloaded next
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i - r * D, row = wr + r;
    out[(((long long)b * Sq + q0 + row) * H + h) * D + c] =
        __float2bfloat16_rn(o_s[row * T::kLdO + c] / l_s[row]);
  }
  if (lane < 16) {
    const int row = wr + lane;
    lse[((long long)b * H + h) * Sq + q0 + row] = m_s[row] + logf(l_s[row]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides dos, int H,
                    int Hk, int Sq, int Sk, int causal, float scale) {
  using T = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                 // [64][D+8]
  bf16* v_s = k_s + T::kTileH;                               // [64][D+8]
  float* s_s = reinterpret_cast<float*>(v_s + T::kTileH);    // [64][68]
  float* dp_s = s_s + T::kTileS;                             // [64][68]
  bf16* dsh_s = reinterpret_cast<bf16*>(dp_s + T::kTileS);   // [64][72]
  bf16* dsl_s = dsh_s + T::kTileP;                           // [64][72]
  float* lse_s = reinterpret_cast<float*>(dsl_s + T::kTileP);  // [64]
  float* dl_s = lse_s + kTile;                               // [64]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = qt * kTile, offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * 16;

  bf16* q_stage = reinterpret_cast<bf16*>(s_s);
  bf16* do_stage = reinterpret_cast<bf16*>(dp_s);
  load_tile<D>(q_stage, q, qs, b, q0, h);
  load_tile<D>(do_stage, dout, dos, b, q0, h);
  const long long row_base = ((long long)b * H + h) * Sq + q0;
  load_rows(lse_s, lse + row_base);
  load_rows(dl_s, delta + row_base);
  __syncthreads();
  FragA qf[D / 16], dof[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], q_stage + wr * T::kLdH + kk * 16, T::kLdH);
    wmma::load_matrix_sync(dof[kk], do_stage + wr * T::kLdH + kk * 16,
                           T::kLdH);
  }
  __syncthreads();
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  int n_kt = Sk / kTile;
  if (causal) n_kt = min(n_kt, (q0 + 2 * kTile - 1 + offset) / kTile);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    load_tile<D>(k_s, k, ks, b, k0, hk);
    load_tile<D>(v_s, v, vs, b, k0, hk);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {  // S = Q K^T, dP = dO V^T
      FragC cs, cp;
      wmma::fill_fragment(cs, 0.f);
      wmma::fill_fragment(cp, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBt kb;
        wmma::load_matrix_sync(kb, k_s + n * 16 * T::kLdH + kk * 16, T::kLdH);
        wmma::mma_sync(cs, qf[kk], kb, cs);
        wmma::load_matrix_sync(kb, v_s + n * 16 * T::kLdH + kk * 16, T::kLdH);
        wmma::mma_sync(cp, dof[kk], kb, cp);
      }
      wmma::store_matrix_sync(s_s + wr * kLdS + n * 16, cs, kLdS,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dp_s + wr * kLdS + n * 16, cp, kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * kTile; i += 32) {
      const int r = i / kTile, c = i - r * kTile, row = wr + r;
      float p = 0.f;
      if (!causal || k0 + c <= q0 + row + offset)
        p = expf(s_s[row * kLdS + c] * scale - lse_s[row]);
      const float ds = p * (dp_s[row * kLdS + c] - dl_s[row]) * scale;
      split_bf16(ds, dsh_s + row * kLdP + c, dsl_s + row * kLdP + c);
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {  // dQ += (dS_hi + dS_lo) K
      mma_row<kTile / 16, FragB>(acc[n], dsh_s + wr * kLdP, kLdP,
                                 k_s + n * 16, T::kLdH, 16 * T::kLdH);
      mma_row<kTile / 16, FragB>(acc[n], dsl_s + wr * kLdP, kLdP,
                                 k_s + n * 16, T::kLdH, 16 * T::kLdH);
    }
    __syncthreads();
  }

  // the accumulators stage through the two score tiles as f32 [64][D+4]
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s_s + wr * T::kLdO + n * 16, acc[n], T::kLdO,
                            wmma::mem_row_major);
  __syncwarp();
  write_rows<D>(dq + (((long long)b * Sq + q0) * H + h) * D, (long long)H * D,
                s_s, wr, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Strides qs, Strides ks,
                     Strides vs, Strides dos, int H, int Hk, int Sq, int Sk,
                     int causal, float scale) {
  using T = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                 // [64][D+8]
  bf16* v_s = k_s + T::kTileH;
  bf16* q_s = v_s + T::kTileH;
  bf16* do_s = q_s + T::kTileH;
  float* st_s = reinterpret_cast<float*>(do_s + T::kTileH);  // [64][68]
  float* dpt_s = st_s + T::kTileS;                           // [64][68]
  bf16* pth_s = reinterpret_cast<bf16*>(dpt_s + T::kTileS);  // [64][72]
  bf16* ptl_s = pth_s + T::kTileP;
  bf16* dsth_s = ptl_s + T::kTileP;
  bf16* dstl_s = dsth_s + T::kTileP;
  float* lse_s = reinterpret_cast<float*>(dstl_s + T::kTileP);  // [64]
  float* dl_s = lse_s + kTile;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hk, k0 = kt * kTile, offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * 16;

  load_tile<D>(k_s, k, ks, b, k0, hk);
  load_tile<D>(v_s, v, vs, b, k0, hk);
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }
  // q tiles whose last query precedes this k tile never see it
  const int qt0 = causal ? max(0, (k0 - offset) / kTile) : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = qt0; qt < Sq / kTile; ++qt) {
      const int q0 = qt * kTile;
      load_tile<D>(q_s, q, qs, b, q0, h);
      load_tile<D>(do_s, dout, dos, b, q0, h);
      const long long row_base = ((long long)b * H + h) * Sq + q0;
      load_rows(lse_s, lse + row_base);
      load_rows(dl_s, delta + row_base);
      __syncthreads();
#pragma unroll
      for (int n = 0; n < kTile / 16; ++n) {  // S^T = K Q^T, dP^T = V dO^T
        FragC cs, cp;
        wmma::fill_fragment(cs, 0.f);
        wmma::fill_fragment(cp, 0.f);
        mma_row<D / 16, FragBt>(cs, k_s + wr * T::kLdH, T::kLdH,
                                q_s + n * 16 * T::kLdH, T::kLdH, 16);
        mma_row<D / 16, FragBt>(cp, v_s + wr * T::kLdH, T::kLdH,
                                do_s + n * 16 * T::kLdH, T::kLdH, 16);
        wmma::store_matrix_sync(st_s + wr * kLdS + n * 16, cs, kLdS,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(dpt_s + wr * kLdS + n * 16, cp, kLdS,
                                wmma::mem_row_major);
      }
      __syncwarp();
      // rows are keys, columns queries
      for (int i = lane; i < 16 * kTile; i += 32) {
        const int r = i / kTile, c = i - r * kTile, row = wr + r;
        float p = 0.f;
        if (!causal || k0 + row <= q0 + c + offset)
          p = expf(st_s[row * kLdS + c] * scale - lse_s[c]);
        const float ds = p * (dpt_s[row * kLdS + c] - dl_s[c]) * scale;
        split_bf16(p, pth_s + row * kLdP + c, ptl_s + row * kLdP + c);
        split_bf16(ds, dsth_s + row * kLdP + c, dstl_s + row * kLdP + c);
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {  // dV += P^T dO, dK += dS^T Q
        const int step = 16 * T::kLdH;
        mma_row<kTile / 16, FragB>(dv_acc[n], pth_s + wr * kLdP, kLdP,
                                   do_s + n * 16, T::kLdH, step);
        mma_row<kTile / 16, FragB>(dv_acc[n], ptl_s + wr * kLdP, kLdP,
                                   do_s + n * 16, T::kLdH, step);
        mma_row<kTile / 16, FragB>(dk_acc[n], dsth_s + wr * kLdP, kLdP,
                                   q_s + n * 16, T::kLdH, step);
        mma_row<kTile / 16, FragB>(dk_acc[n], dstl_s + wr * kLdP, kLdP,
                                   q_s + n * 16, T::kLdH, step);
      }
      __syncthreads();  // q_s / do_s / lse_s are reloaded next
    }
  }

  const long long row_stride = (long long)Hk * D;
  const long long base = (((long long)b * Sk + k0) * Hk + hk) * D;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(st_s + wr * T::kLdO + n * 16, dk_acc[n], T::kLdO,
                            wmma::mem_row_major);
  __syncwarp();
  write_rows<D>(dk + base, row_stride, st_s, wr, lane);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(st_s + wr * T::kLdO + n * 16, dv_acc[n], T::kLdO,
                            wmma::mem_row_major);
  __syncwarp();
  write_rows<D>(dv + base, row_stride, st_s, wr, lane);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  // above 48 KB only after an explicit opt-in; a refused launch never runs
  // and is reported only by cudaGetLastError
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int forward(const void* q, const void* k, const void* v, void* out, void* lse,
            Strides qs, Strides ks, Strides vs, int B, int H, int Hk, int Sq,
            int Sk, int causal, float scale, cudaStream_t stream) {
  using T = Dims<D>;
  const size_t smem = 2 * T::kTileH * 2 + T::kTileS * 4 + 2 * T::kTileP * 2 +
                      kTile * T::kLdO * 4 + 3 * kTile * 4;
  if (int e = prepare(flash_fwd_kernel<D>, smem)) return e;
  flash_fwd_kernel<D><<<dim3(Sq / kTile, H, B), kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse,
      qs, ks, vs, H, Hk, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int backward_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, Strides qs,
                Strides ks, Strides vs, Strides dos, int B, int H, int Hk,
                int Sq, int Sk, int causal, float scale,
                cudaStream_t stream) {
  using T = Dims<D>;
  const size_t smem = 2 * T::kTileH * 2 + 2 * T::kTileS * 4 +
                      2 * T::kTileP * 2 + 2 * kTile * 4;
  if (int e = prepare(flash_dq_kernel<D>, smem)) return e;
  flash_dq_kernel<D><<<dim3(Sq / kTile, H, B), kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, qs, ks, vs, dos, H,
      Hk, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int backward_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, Strides qs, Strides ks, Strides vs,
                 Strides dos, int B, int H, int Hk, int Sq, int Sk,
                 int causal, float scale, cudaStream_t stream) {
  using T = Dims<D>;
  const size_t smem = 4 * T::kTileH * 2 + 2 * T::kTileS * 4 +
                      4 * T::kTileP * 2 + 2 * kTile * 4;
  if (int e = prepare(flash_dkv_kernel<D>, smem)) return e;
  flash_dkv_kernel<D><<<dim3(Sk / kTile, Hk, B), kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, qs, ks, vs,
      dos, H, Hk, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. q/k/v/dout/out/dq/dk/dv are bf16, lse and
// delta f32 [B, H, Sq]. Strides are (batch, seq, head) element strides of
// each input. Each entry launches on `stream`, does not synchronise, and
// returns the cudaGetLastError() code of its launch (0 on success);
// head_dim must be 64 or 128 and both sequence lengths multiples of 64.
extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fa_forward(const void* q, const void* k, const void* v, void* out,
               void* lse, long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh, long long vsb,
               long long vss, long long vsh, int D, int B, int H, int Hk,
               int Sq, int Sk, int causal, float scale, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return forward<64>(q, k, v, out, lse, qs, ks, vs, B, H, Hk, Sq, Sk,
                       causal, scale, st);
  if (D == 128)
    return forward<128>(q, k, v, out, lse, qs, ks, vs, B, H, Hk, Sq, Sk,
                        causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

int fa_backward_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh, long long vsb,
                   long long vss, long long vsh, long long dsb, long long dss,
                   long long dsh, int D, int B, int H, int Hk, int Sq, int Sk,
                   int causal, float scale, void* stream) {
  (void)cudaGetLastError();
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dsb, dss, dsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return backward_dq<64>(q, k, v, dout, lse, delta, dq, qs, ks, vs, dos, B,
                           H, Hk, Sq, Sk, causal, scale, st);
  if (D == 128)
    return backward_dq<128>(q, k, v, dout, lse, delta, dq, qs, ks, vs, dos, B,
                            H, Hk, Sq, Sk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

int fa_backward_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, long long qsb, long long qss,
                    long long qsh, long long ksb, long long kss,
                    long long ksh, long long vsb, long long vss,
                    long long vsh, long long dsb, long long dss,
                    long long dsh, int D, int B, int H, int Hk, int Sq,
                    int Sk, int causal, float scale, void* stream) {
  (void)cudaGetLastError();
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dsb, dss, dsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return backward_dkv<64>(q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, dos,
                            B, H, Hk, Sq, Sk, causal, scale, st);
  if (D == 128)
    return backward_dkv<128>(q, k, v, dout, lse, delta, dk, dv, qs, ks, vs,
                             dos, B, H, Hk, Sq, Sk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
