// Fused linear cross-entropy forward for Hopper (sm_90a): per-row log-sum-exp
// and label logit of h . W^T without the [N, V] logits.
//
// Replaces the TPU kernel `_ce_kernel` of
// paddle_tpu/ops/fused_linear_cross_entropy.py (built by `_make_ce_call`,
// pallas_call at :220): a grid of (row tiles, vocab tiles) whose vocab index
// carries each row tile's running (max, sumexp, label logit) in VMEM scratch.
//
// Design. One block per tile of 32 rows sweeps every vocab tile of 512
// columns in order, so the running state of its rows never leaves the block
// (the loop inside the block takes the place of the TPU's sequential vocab
// grid axis). Each vocab tile is an f32 [32 x D] . [D x 512] product computed
// in the block's own body: h and W are staged through double-buffered shared
// memory 8 columns of D at a time (the next slab is fetched into registers
// while the current one computes), and each of the 256 threads keeps an 8 x 8
// block of logits in registers (rows 8 ty .. 8 ty + 7, columns 4 tx .. 4 tx +
// 3 and 256 + 4 tx .. 256 + 4 tx + 3, so its shared-memory reads are
// conflict-free 16-byte vectors). Then the tile's columns past V (the ragged
// tail: 128256 is not a multiple of 512) become -inf, and the online update
// of the reference runs per row:
//   m_new = max(m, max_tile), s = s * exp(m - m_new) + sum exp(l - m_new),
//   pick += the logit whose column equals the label.
// A label outside [0, V) (ignore_index among them) matches no column and
// leaves pick 0, as in the chunked reference. Rows of a ragged last row tile
// read zeros and are never written.
//
// Numbers: f32 inputs, f32 FMA accumulation, no TF32 (what the training path
// hands the loss: the f32 final-norm output and the f32 lm-head weight).
//
// Bound. 2 N D V flops on the CUDA cores, against 67 TFLOP/s of f32 outside
// the tensor cores: at N = D = 4096, V = 128256 that is ~64 ms, far above the
// bytes (W and h read once, ~2.2 GB, ~0.65 ms). W streams through L2 once per
// row tile (128 row tiles read the same vocab tile at about the same time).
//
// What the simple design leaves on the table: no TF32/3xTF32 tensor-core
// path, no cp.async/TMA ring (one slab of prefetch through registers), and
// the h tile is re-read from L2 for every vocab tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

__global__ void __launch_bounds__(kThreads)
    linear_ce_fwd_kernel(const float* __restrict__ h,
                         const float* __restrict__ w,
                         const long long* __restrict__ labels,
                         float* __restrict__ lse_out,
                         float* __restrict__ pick_out, int N, int D, int V) {
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
  // this thread's slab loads: one float4 of h (threads < 64), four of W
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const bool a_live = tid < 2 * kRows && n0 + a_row < N;
  const float* a_src = h + (size_t)(n0 + a_row) * D + a_k;
  const int n_steps = D / kStep;
  const int n_vt = (V + kCols - 1) / kCols;

  for (int vt = 0; vt < n_vt; ++vt) {
    const int v0 = vt * kCols;
    float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rb[4];
    auto fetch = [&](int st) {
      const int k0 = st * kStep;
      if (a_live) ra = *reinterpret_cast<const float4*>(a_src + k0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = tid + u * kThreads, c = idx >> 1;
        rb[u] = v0 + c < V ? *reinterpret_cast<const float4*>(
                                 w + (size_t)(v0 + c) * D + k0 + (idx & 1) * 4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
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

}  // namespace

// C interface, loaded with ctypes: h [N, D] f32, w [V, D] f32 (the nn.Linear
// layout), labels [N] int64, outputs lse [N] and pick [N] f32, all
// contiguous with 16-byte aligned rows (D % 8 == 0). Launches on `stream`,
// does not synchronise, returns the cudaGetLastError() code of the launch.
extern "C" {

const char* ce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ce_forward(const void* h, const void* w, const void* labels, void* lse,
               void* pick, int N, int D, int V, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  if (N <= 0 || V <= 0 || D <= 0 || D % kStep) return (int)cudaErrorInvalidValue;
  linear_ce_fwd_kernel<<<(N + kRows - 1) / kRows, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)h, (const float*)w, (const long long*)labels, (float*)lse,
      (float*)pick, N, D, V);
  return (int)cudaGetLastError();
}

}  // extern "C"
