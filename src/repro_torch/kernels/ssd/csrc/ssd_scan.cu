// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::ssd_pallas
// (body _ssd_kernel): per (batch, head) row the sequence is cut into
// chunks of Q steps; inside a chunk
//
//     a_cum  = cumsum(dt * A)                                 (Q,)
//     y_i    = sum_{j <= i} (C_i . B_j) exp(a_cum_i - a_cum_j) dt_j x_j
//            + exp(a_cum_i) (C_i . state^T)                   (Q, P)
//     state  = state exp(a_cum_last)
//            + sum_j exp(a_cum_last - a_cum_j) dt_j x_j B_j^T (P, N)
//
// with the (P, N) float32 state carried from chunk to chunk.  It is the
// SSD core of every Mamba2 block's prefill (models/mamba2.py::
// ssd_chunked), so beyond the TPU kernel it also starts from an optional
// initial state and writes the state after the last chunk (the decode
// cache's SSM state).  y is written in float32, as the model consumes it.
//
// What bounds it on this card: a chunk of Zamba2-7B (P = N = 64,
// Q = 128) is ~2.1 M multiply-adds on ~50 KB of inputs, so the work is
// operations, and with the products on CUDA cores out of shared memory
// (two shared loads per multiply-add) the shared-memory port bounds it
// well before the float32 peak does.  Tensor-core chunk products are
// later work.  The design is the plain translation of the TPU grid:
// the Pallas grid's sequential chunk axis becomes a loop inside one block
// per (batch, head) row, and the state lives in shared memory for the
// whole row.  Each chunk's x, B, C (as float32), dt, a_cum and the
// per-step weights are staged in shared memory, rows padded by one value
// so that no product has a bank conflict; the (Q, Q) score tile is built
// QB query rows at a time.  Where a chunk does not fit in the 227 KB a
// block may use (N = 128 at Q = 128, as in Mamba2-370M), the plan
// (kernel.py::ssd_plan) shrinks QB.
//
// Only j <= i is evaluated: exp(a_cum_i - a_cum_j) is taken where it is
// <= 1 and never above the diagonal (the TPU kernel takes exp first and
// masks after).  A ragged last chunk is padded in shared memory with
// dt = x = B = C = 0, which is what padding L to a chunk multiple does:
// padded steps leave the state unchanged and their y is not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x (b, L, H, P), B/C (b, L, G, N) of type T; dt (b, L, H), A (H,),
// init (b, H, P, N) or nullptr, y (b, L, H, P), fin (b, H, P, N) float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bg,
                const T* __restrict__ Cg, const float* __restrict__ init,
                float* __restrict__ y, float* __restrict__ fin, int L, int H,
                int P, int G, int N, int Q, int QB) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x;  // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const int g = h / (H / G);
  const float a_h = A[h];
  const int tid = threadIdx.x;
  const int sn = N + 1;  // padded row strides (no bank conflicts)
  const int sp = P + 1;
  const int sq = Q + 1;

  float* s_state = smem;               // (P, N + 1)
  float* s_x = s_state + P * sn;       // (Q, P + 1)
  float* s_dt = s_x + Q * sp;          // (Q,)
  float* s_cum = s_dt + Q;             // (Q,) a_cum
  float* s_ecum = s_cum + Q;           // (Q,) exp(a_cum)
  float* s_w = s_ecum + Q;             // (Q,) exp(last - a_cum) * dt
  float* s_s = s_w + Q;                // (QB, Q + 1) scores
  float* s_b = s_s + QB * sq;          // (Q, N + 1)
  float* s_c = s_b + Q * sn;           // (Q, N + 1)

  const size_t pn = static_cast<size_t>(P) * N;
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N;
    const int n = idx - p * N;
    s_state[p * sn + n] = init != nullptr ? init[row * pn + idx] : 0.0f;
  }

  const int nc = (L + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int l0 = c * Q;
    // element (i, n) of a staged (Q, N + 1) array.  The score loop reads
    // B and C through it: on the H100, nvcc's code for that loop is then
    // faster than with the same index written inline (PERF.md, Findings).
    auto at = [&](const float* s, int i, int n) -> float {
      return s[i * sn + n];
    };
    for (int i = tid; i < Q; i += kThreads) {
      const int l = l0 + i;
      s_dt[i] = l < L ? dt[(static_cast<size_t>(b) * L + l) * H + h] : 0.0f;
    }
    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int i = idx / P;
      const int p = idx - i * P;
      const int l = l0 + i;
      s_x[i * sp + p] =
          l < L ? to_float(x[((static_cast<size_t>(b) * L + l) * H + h) * P + p])
                : 0.0f;
    }
    for (int idx = tid; idx < Q * N; idx += kThreads) {
      const int i = idx / N;
      const int n = idx - i * N;
      const int l = l0 + i;
      const size_t at = ((static_cast<size_t>(b) * L + l) * G + g) * N + n;
      s_b[i * sn + n] = l < L ? to_float(Bg[at]) : 0.0f;
      s_c[i * sn + n] = l < L ? to_float(Cg[at]) : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {  // in-chunk cumsum of the log decay, in order
      float acc = 0.0f;
      for (int i = 0; i < Q; ++i) {
        acc = acc + s_dt[i] * a_h;
        s_cum[i] = acc;
      }
    }
    __syncthreads();
    const float last = s_cum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      s_ecum[i] = expf(s_cum[i]);
      s_w[i] = expf(last - s_cum[i]) * s_dt[i];
    }
    __syncthreads();

    for (int i0 = 0; i0 < Q; i0 += QB) {
      const int rows = min(QB, Q - i0);
      // scores (C_i . B_j) exp(a_cum_i - a_cum_j) dt_j for j <= i
      for (int idx = tid; idx < rows * Q; idx += kThreads) {
        const int ii = idx / Q;
        const int j = idx - ii * Q;
        const int i = i0 + ii;
        if (j > i) continue;
        float dot = 0.0f;
        for (int n = 0; n < N; ++n)
          dot = dot + at(s_c, i, n) * at(s_b, j, n);
        s_s[ii * sq + j] = dot * expf(s_cum[i] - s_cum[j]) * s_dt[j];
      }
      __syncthreads();
      for (int idx = tid; idx < rows * P; idx += kThreads) {
        const int ii = idx / P;
        const int p = idx - ii * P;
        const int i = i0 + ii;
        const int l = l0 + i;
        float intra = 0.0f;
        for (int j = 0; j <= i; ++j)
          intra = intra + s_s[ii * sq + j] * s_x[j * sp + p];
        float inter = 0.0f;
        for (int n = 0; n < N; ++n)
          inter = inter + s_c[i * sn + n] * s_state[p * sn + n];
        if (l < L)
          y[((static_cast<size_t>(b) * L + l) * H + h) * P + p] =
              intra + inter * s_ecum[i];
      }
      __syncthreads();  // s_s is rewritten by the next row block
    }

    // state = state exp(last) + sum_j (x_j w_j) B_j^T
    const float decay = expf(last);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N;
      const int n = idx - p * N;
      float acc = 0.0f;
      for (int j = 0; j < Q; ++j)
        acc = acc + (s_x[j * sp + p] * s_w[j]) * s_b[j * sn + n];
      s_state[p * sn + n] = s_state[p * sn + n] * decay + acc;
    }
    __syncthreads();  // the next chunk overwrites s_x, s_b, s_c, s_dt
  }

  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N;
    const int n = idx - p * N;
    fin[row * pn + idx] = s_state[p * sn + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* init, void* y, void* fin, int rows,
           int L, int H, int P, int G, int N, int Q, int QB, int smem,
           void* stream) {
  if (static_cast<size_t>(smem) > kDefaultSmem) {  // opt in above 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_scan_kernel<T><<<rows, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<float*>(y), static_cast<float*>(fin), L, H, P, G, N, Q, QB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Contiguous device buffers: x (b, L, H, P) and B, C (b, L, G, N) in the
// function's type; dt (b, L, H), A (H,), init (b, H, P, N) or NULL,
// y (b, L, H, P) and fin (b, H, P, N) in float32.  rows = b * H; QB and
// smem (bytes) as kernel.py::ssd_plan gives them.  Enqueued
// on `stream`; returns the cudaError_t of the launch (0 = launched).
int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* init, void* y, void* fin,
                 int rows, int L, int H, int P, int G, int N, int Q, int QB,
                 int smem, void* stream) {
  return launch<float>(x, dt, A, B, C, init, y, fin, rows, L, H, P, G, N, Q,
                       QB, smem, stream);
}

int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, const void* init, void* y, void* fin,
                  int rows, int L, int H, int P, int G, int N, int Q, int QB,
                  int smem, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, init, y, fin, rows, L, H, P,
                               G, N, Q, QB, smem, stream);
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
