// One banded min-plus DP slot for Hopper (sm_90a), with its first-index
// argmin.
//
// Replaces the TPU kernel src/repro/kernels/minplus/kernel.py::
// minplus_pallas (body _minplus_kernel):
//
//     new[d] = min_{j <= min(DC, d)} row[j] + prev[d - j]
//     arg[d] = the first j that attains the minimum (0 where all are +inf)
//
// It is the chain step of the tiled decision core: one launch per live
// slot the core visits, writing straight into that slot's row of the
// core's (T_pad, D+1) cost table.
//
// What bounds it on this card: at the core's shapes (DC+1 <= 640,
// D+1 = 1280) a launch does under 2 * 1280 * 640 adds and compares on
// ~2 * 1280 values, so the launch latency (a few microseconds) floors it
// long before operations or bytes do.  The design is the plain one the
// TPU kernel's 512-lane output blocks translate to: a grid over blocks of
// kBlock outputs, one thread per output, the block's window of the carry
// (prev[d0 - DC .. d0 + kBlock - 1], +inf left of 0) and the row staged in
// shared memory, so every candidate is two shared loads, one add and one
// compare.  Where the row and window do not fit in the 227 KB a block may
// use (DC+1 above ~9,000 in f64), the plan (kernel.py::slot_plan) reads
// them from global memory instead, through L1.
//
// Exactness: each candidate is one IEEE add (no multiply, so no FMA), the
// strict '<' in increasing j keeps the first index of the minimum, and
// skipping j > d drops only +inf candidates, so cost and argmin equal the
// plain PyTorch version (kernels/minplus/ref.py::minplus_ref) bit for bit
// in f32 and f64.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;  // outputs (and threads) per block
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kBlock)
minplus_slot_kernel(const T* __restrict__ row, const T* __restrict__ prev,
                    T* __restrict__ out, int32_t* __restrict__ arg, int dc1,
                    int d1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d0 = blockIdx.x * kBlock;
  const int d = d0 + static_cast<int>(threadIdx.x);
  const T inf = pos_inf<T>();
  // candidate j of output d reads rowp[j] and winp[d - j - woff]
  const T* rowp = row;
  const T* winp = prev;
  int woff = 0;
  if constexpr (kStaged) {
    T* s_row = reinterpret_cast<T*>(smem_raw);   // (dc1,)
    T* s_win = s_row + dc1;                      // (kBlock + dc1 - 1,)
    // s_win[i] = prev[d0 - (dc1 - 1) + i], +inf outside [0, d1)
    const int lw = kBlock + dc1 - 1;
    const int base = d0 - (dc1 - 1);
    for (int j = threadIdx.x; j < dc1; j += kBlock) s_row[j] = row[j];
    for (int i = threadIdx.x; i < lw; i += kBlock) {
      const int p = base + i;
      s_win[i] = (p >= 0 && p < d1) ? prev[p] : inf;
    }
    __syncthreads();
    rowp = s_row;
    winp = s_win;
    woff = base;
  }
  if (d >= d1) return;
  T best = inf;
  int32_t a = 0;
  const int jmax = min(dc1 - 1, d);
  for (int j = 0; j <= jmax; ++j) {
    const T cand = rowp[j] + winp[d - j - woff];
    if (cand < best) {
      best = cand;
      a = j;
    }
  }
  out[d] = best;
  if (arg != nullptr) arg[d] = a;
}

template <typename T, bool kStaged>
int launch_staged(const void* row, const void* prev, void* out, void* arg,
                  int dc1, int d1, void* stream) {
  const size_t smem =
      kStaged ? (2 * static_cast<size_t>(dc1) + kBlock - 1) * sizeof(T) : 0;
  if (smem > kDefaultSmem) {  // opt in above the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        minplus_slot_kernel<T, kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (d1 + kBlock - 1) / kBlock;
  minplus_slot_kernel<T, kStaged><<<grid, kBlock, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(row), static_cast<const T*>(prev),
      static_cast<T*>(out), static_cast<int32_t*>(arg), dc1, d1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* row, const void* prev, void* out, void* arg, int dc1,
           int d1, int staged, void* stream) {
  return staged ? launch_staged<T, true>(row, prev, out, arg, dc1, d1, stream)
                : launch_staged<T, false>(row, prev, out, arg, dc1, d1,
                                          stream);
}

}  // namespace

extern "C" {

// row (dc1,), prev (d1,), out (d1,) contiguous on the device; arg (d1,)
// int32 or NULL for cost only; staged as in kernel.py::slot_plan.
// Enqueued on `stream`; returns the cudaError_t of the launch (0 =
// launched).
int minplus_slot_f32(const void* row, const void* prev, void* out, void* arg,
                     int dc1, int d1, int staged, void* stream) {
  return launch<float>(row, prev, out, arg, dc1, d1, staged, stream);
}

int minplus_slot_f64(const void* row, const void* prev, void* out, void* arg,
                     int dc1, int d1, int staged, void* stream) {
  return launch<double>(row, prev, out, arg, dc1, d1, staged, stream);
}

const char* minplus_slot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
