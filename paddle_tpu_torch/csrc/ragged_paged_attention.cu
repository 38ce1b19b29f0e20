// Rope-fused ragged paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_rope_kernel`
// (paddle_tpu/ops/ragged_paged_attention.py:732, built by `_make_fused_rope`,
// pallas_call at :1060): rope on the packed pre-rope q/k from per-dispatch
// sin/cos tables, the write of the dispatch's fresh K/V into their pages, and
// ragged causal GQA attention with an f32 online softmax over the page table.
//
// Design. The TPU kernel replays the dispatch's fresh K/V from the packed rows
// on every read, because a Pallas grid cannot order a page write before
// another grid step's read. Here the work is two launches on one stream, which
// gives that order for free:
//   (a) rope_kv_write_kernel, one block per (row, kv-head): positions
//       [q_start, q_start + q_len) of each active row, packed index
//       w_flat + p - w_start; K is roped in f32, cast to the model dtype and
//       stored, V is stored as is. Each fresh position belongs to exactly one
//       row, so no slot is written twice; the dump page is never touched.
//   (b) ragged_attention_rope_kernel, one block per (row, kv-head, tile of 16
//       flattened (query token, group head) rows): ropes its q rows (f32, cast
//       through the model dtype, times scale), then walks the row's live pages
//       up to the tile's causal horizon with the reference softmax update:
//       mask kpos <= qpos & kpos < kv_len & qrow < q_len, finite -1e30 running
//       max, masked lanes contribute 0, rows with l == 0 (padding, inactive
//       rows with kv_len 0) emit zeros. Table entries are clamped into [0, P).
// The rope products and sum are rounded separately (__fmul_rn/__fadd_rn), the
// same operations the plain PyTorch version performs, so the written K slots
// agree with it bit for bit.
//
// Bound. At decode the kernel is memory-bound: the least time is the bytes of
// the live K/V pages + q + out + the fresh K/V it writes, over 3.35 TB/s (H100
// SXM). The arithmetic (2 * 2 * D flops per unmasked (query, key) pair) is far
// below the tensor cores' rate at these shapes.
//
// Each page of K and V is fetched as 16-byte vectors into registers one page
// ahead of its use, so one page's loads are in flight while the previous
// page computes; q . k runs one thread per (query row, key slot) pair over
// padded shared-memory rows (no bank conflicts); P.V keeps each thread's
// output column of the tile's rows in registers (head_dim <= 128).
//
// What the simple design leaves on the table: the dot products and the P.V
// update run on CUDA cores in f32 (no mma.sync / wgmma); the prefetch is one
// page deep through registers (no cp.async/TMA ring); a decode row's pages
// are walked by one block (no split over the sequence, so long contexts leave
// most SMs idle at small batch); tiles of a prefill row each re-read the
// row's pages; and q-tiles past a decode row's single token are launched only
// to write zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kQTile = 16;         // flattened (token, group head) rows/block
constexpr int kThreads = 128;
// 16-byte vectors of one page's K (and of its V) per thread: pages of up
// to kThreads * kVecPerThread * 16 bytes = 8 KB per head
constexpr int kVecPerThread = 4;

using bf16 = __nv_bfloat16;  // the pools' and the model's dtype

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}

// Element d of x * cos + rotate_half(x) * sin for one head row of length D
// (neox duplicated-half layout), in f32 with no FMA contraction.
__device__ __forceinline__ float rope_elem(const bf16* row, int d, int D,
                                           const float* sin_row,
                                           const float* cos_row) {
  const int half = D / 2;
  const float x = to_f32(row[d]);
  const float partner =
      d < half ? -to_f32(row[d + half]) : to_f32(row[d - half]);
  return __fadd_rn(__fmul_rn(x, cos_row[d]), __fmul_rn(partner, sin_row[d]));
}

__device__ __forceinline__ int clamp_page(int p, int num_pages) {
  return p < 0 ? 0 : (p >= num_pages ? num_pages - 1 : p);
}

__global__ void __launch_bounds__(kThreads)
    rope_kv_write_kernel(const bf16* __restrict__ new_k,
                         const bf16* __restrict__ new_v,
                         bf16* __restrict__ k_pages,
                         bf16* __restrict__ v_pages,
                         const float* __restrict__ sin_tab,
                         const float* __restrict__ cos_tab,
                         const int* __restrict__ tables,
                         const int* __restrict__ kv_lens,
                         const int* __restrict__ q_starts,
                         const int* __restrict__ q_lens,
                         const int* __restrict__ w_starts,
                         const int* __restrict__ w_flats, int n_tok, int Hk,
                         int D, int P, int page, int W) {
  const int r = blockIdx.x, hk = blockIdx.y;
  const int qlen = q_lens[r];
  if (qlen <= 0 || kv_lens[r] <= 0) return;
  const int qstart = q_starts[r];
  const int f_base = w_flats[r] + qstart - w_starts[r];
  for (int idx = threadIdx.x; idx < qlen * D; idx += blockDim.x) {
    const int t = idx / D, d = idx - t * D;
    const int pos = qstart + t, f = f_base + t, pi = pos / page;
    if (f < 0 || f >= n_tok || pi >= W) continue;
    const int pid = clamp_page(tables[(size_t)r * W + pi], P);
    const size_t src = ((size_t)f * Hk + hk) * D;
    const size_t dst =
        (((size_t)pid * Hk + hk) * page + (pos - pi * page)) * D + d;
    k_pages[dst] = to_bf16(rope_elem(new_k + src, d, D,
                                     sin_tab + (size_t)f * D,
                                     cos_tab + (size_t)f * D));
    v_pages[dst] = new_v[src + d];
  }
}

// 16 bytes of bf16 unpacked to 8 f32 values
__device__ __forceinline__ void unpack16(const uint4& raw, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    dst[2 * k] = f.x;
    dst[2 * k + 1] = f.y;
  }
}

__global__ void __launch_bounds__(kThreads) ragged_attention_rope_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, const int* __restrict__ q_starts,
    const int* __restrict__ q_lens, const int* __restrict__ w_starts,
    const int* __restrict__ w_flats, bf16* __restrict__ out, int n_tok, int H,
    int Hk, int D, int P, int page, int W, int QB, float scale) {
  constexpr int E = 16 / sizeof(bf16);  // elements per 16-byte vector
  const int KS = D + 1;                 // padded row stride of q_s and k_s
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kQTile, KS] roped, scaled q
  float* k_s = q_s + kQTile * KS;     // [page, KS]
  float* v_s = k_s + page * KS;       // [page, D]
  float* p_s = v_s + page * D;        // [kQTile, page] scores, then probs
  float* m_s = p_s + kQTile * page;   // [kQTile] running max
  float* l_s = m_s + kQTile;          // [kQTile] running sum
  float* a_s = l_s + kQTile;          // [kQTile] this page's rescale

  const int r = blockIdx.x, hk = blockIdx.y, row0 = blockIdx.z * kQTile;
  const int G = H / Hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads >> 5;
  const int ctx = kv_lens[r], qlen = q_lens[r], qstart = q_starts[r];
  const int tile_rows = min(kQTile, QB * G - row0);
  const int n_valid =
      (ctx > 0 && qlen > 0) ? max(0, min(tile_rows, qlen * G - row0)) : 0;
  const int f0q = w_flats[r] + qstart - w_starts[r];

#pragma unroll 4
  for (int idx = tid; idx < n_valid * D; idx += kThreads) {
    const int i = idx / D, d = idx - i * D;
    const int flat = row0 + i, qi = flat / G, h = hk * G + flat % G;
    const int f = f0q + qi;
    float v = 0.f;
    if (f >= 0 && f < n_tok) {
      const float rot =
          rope_elem(q + ((size_t)f * H + h) * D, d, D,
                    sin_tab + (size_t)f * D, cos_tab + (size_t)f * D);
      v = to_f32(to_bf16(rot)) * scale;
    }
    q_s[i * KS + d] = v;
  }
  for (int i = tid; i < n_valid; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  // thread d < D owns output column d of every row of the tile: the
  // unnormalised accumulator lives in registers across the page loop
  float acc[kQTile];
#pragma unroll
  for (int i = 0; i < kQTile; ++i) acc[i] = 0.f;
  // keys past the causal horizon of the tile's last query are all masked
  const int kv_end =
      n_valid > 0 ? min(ctx, qstart + (row0 + n_valid - 1) / G + 1) : 0;
  const int n_pages = (kv_end + page - 1) / page;

  // a page's K and V as 16-byte vectors, fetched into registers one page
  // ahead so the loads of page pg+1 are in flight while page pg computes
  const int nvec = page * D / E;
  uint4 kreg[kVecPerThread], vreg[kVecPerThread];
  auto fetch = [&](int pg) {
    const int pid = clamp_page(tables[(size_t)r * W + pg], P);
    const size_t base = ((size_t)pid * Hk + hk) * page * D;
    const uint4* kb = reinterpret_cast<const uint4*>(k_pages + base);
    const uint4* vb = reinterpret_cast<const uint4*>(v_pages + base);
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const int v = tid + u * kThreads;
      if (v < nvec) {
        kreg[u] = kb[v];
        vreg[u] = vb[v];
      }
    }
  };
  if (n_pages > 0) fetch(0);
  __syncthreads();

  for (int pg = 0; pg < n_pages; ++pg) {
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const int v = tid + u * kThreads;
      if (v < nvec) {
        const int e0 = v * E, j = e0 / D, d0 = e0 - j * D;
        float tmp[E];
        unpack16(kreg[u], tmp);
#pragma unroll
        for (int e = 0; e < E; ++e) k_s[j * KS + d0 + e] = tmp[e];
        unpack16(vreg[u], v_s + e0);
      }
    }
    __syncthreads();
    if (pg + 1 < n_pages) fetch(pg + 1);
    // scores: one thread per (query row, key slot) pair
    for (int pair = tid; pair < n_valid * page; pair += kThreads) {
      const int i = pair / page, j = pair - i * page;
      const float* qr = q_s + i * KS;
      const float* kr = k_s + j * KS;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int d = 0; d < D; d += 4) {
        s0 += qr[d] * kr[d];
        s1 += qr[d + 1] * kr[d + 1];
        s2 += qr[d + 2] * kr[d + 2];
        s3 += qr[d + 3] * kr[d + 3];
      }
      const float s = (s0 + s1) + (s2 + s3);
      const int kpos = pg * page + j;
      const int qpos = qstart + (row0 + i) / G;
      p_s[pair] = (kpos <= qpos && kpos < ctx) ? s : -INFINITY;
    }
    __syncthreads();
    // online softmax: one warp per query row, lane j = key slot j
    for (int i = warp; i < n_valid; i += nwarps) {
      const float s = lane < page ? p_s[i * page + lane] : -INFINITY;
      const bool valid = s > -INFINITY;
      float m_cur = valid ? s : kNegInf;
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, m_cur);
      const float pe = valid ? expf(s - m_new) : 0.f;
      float sum = pe;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < page) p_s[i * page + lane] = pe;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
        a_s[i] = alpha;
      }
    }
    __syncthreads();
    // P.V; rows past n_valid hold stale values and are never emitted
    if (tid < D) {
#pragma unroll
      for (int i = 0; i < kQTile; ++i) acc[i] *= a_s[i];
      for (int j = 0; j < page; ++j) {
        const float vj = v_s[j * D + tid];
#pragma unroll
        for (int i = 0; i < kQTile; ++i) acc[i] += p_s[i * page + j] * vj;
      }
    }
    __syncthreads();
  }

  if (tid < D) {
#pragma unroll
    for (int i = 0; i < kQTile; ++i) {
      if (i < tile_rows) {
        const int flat = row0 + i, qi = flat / G, h = hk * G + flat % G;
        const float v =
            (i < n_valid && l_s[i] > 0.f) ? acc[i] / l_s[i] : 0.f;
        out[(((size_t)r * QB + qi) * H + h) * D + tid] = to_bf16(v);
      }
    }
  }
}

}  // namespace

// C interface, loaded with ctypes; every tensor is bf16 except the f32 rope
// tables and the int32 metadata. Each entry launches on `stream`, does not
// synchronise, and returns the cudaGetLastError() code of its launch (0 on
// success).
extern "C" {

const char* rpa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int rpa_rope_kv_write(const void* new_k, const void* new_v, void* k_pages,
                      void* v_pages, const void* sin_tab, const void* cos_tab,
                      const void* tables, const void* kv_lens,
                      const void* q_starts, const void* q_lens,
                      const void* w_starts, const void* w_flats, int R,
                      int n_tok, int Hk, int D, int P, int page, int W,
                      void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  rope_kv_write_kernel<<<dim3(R, Hk), kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)new_k, (const bf16*)new_v, (bf16*)k_pages, (bf16*)v_pages,
      (const float*)sin_tab, (const float*)cos_tab, (const int*)tables,
      (const int*)kv_lens, (const int*)q_starts, (const int*)q_lens,
      (const int*)w_starts, (const int*)w_flats, n_tok, Hk, D, P, page, W);
  return (int)cudaGetLastError();
}

int rpa_rope_attention(const void* q, const void* k_pages, const void* v_pages,
                       const void* sin_tab, const void* cos_tab,
                       const void* tables, const void* kv_lens,
                       const void* q_starts, const void* q_lens,
                       const void* w_starts, const void* w_flats, void* out,
                       int R, int n_tok, int H, int Hk, int D, int P, int page,
                       int W, int QB, float scale, void* stream) {
  (void)cudaGetLastError();
  const size_t smem =
      sizeof(float) * ((kQTile + page) * (D + 1) + page * D + kQTile * page +
                       3 * kQTile);
  if (smem > 48 * 1024) {
    // above 48 KB only after an explicit opt-in; a refused launch never
    // runs and is reported only by cudaGetLastError
    const cudaError_t e = cudaFuncSetAttribute(
        ragged_attention_rope_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (QB * (H / Hk) + kQTile - 1) / kQTile;
  ragged_attention_rope_kernel<<<dim3(R, Hk, tiles), kThreads, smem,
                                 (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_pages, (const bf16*)v_pages,
      (const float*)sin_tab, (const float*)cos_tab, (const int*)tables,
      (const int*)kv_lens, (const int*)q_starts, (const int*)q_lens,
      (const int*)w_starts, (const int*)w_flats, (bf16*)out, n_tok, H, Hk, D,
      P, page, W, QB, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
