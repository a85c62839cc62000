// Whole-horizon banded min-plus DP sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/minplus/kernel.py::
// minplus_sweep_pallas (body _minplus_sweep_kernel):
//
//     cost_t[d]  = min_{j <= min(DC, d)} rows[t, j] + cost_{t-1}[d - j]
//     split_t[d] = the first j that attains the minimum
//
// from the carry cost_{-1} = [0, inf, ...], all T slots in ONE launch.
//
// What bounds it on this card: operations.  A sweep does about
// 2 * T * (D+1) * (DC+1) adds and compares on T * (DC+1 + D+1) values read
// or written once, so its arithmetic intensity is ~DC/8 per byte in f64;
// there is no multiply, so the tensor cores cannot help.  The slot
// recurrence is sequential, so this first design runs one block per sweep
// and keeps the carry close to the SM across the slot loop: two ping-pong
// carry buffers of D+1 values and the current row, threads striding over
// d, one __syncthreads() pair between the slots.  It uses one SM of 132;
// spreading a sweep over several blocks (clusters, DSMEM carry) is later
// work.  Where the buffers live is the wrapper's plan (kernel.py::
// sweep_plan), by size:
//
//   kShared      carries and row in dynamic shared memory (opted in above
//                48 KB with cudaFuncSetAttribute) -- every shape whose
//                (2 (D+1) + DC+1) values fit in the 227 KB a block may use;
//   kGlobalCarry the two carries in a (2, D+1) global scratch tensor the
//                wrapper allocates (at D+1 = 20480 f64 that is 320 KB, which
//                stays in the 50 MB L2), the row still in shared memory;
//   kGlobal      carries and row read from global memory (a row wider than
//                shared memory; no bucket of the repo's traces needs it).
//
// __syncthreads() orders a block's global writes before its later reads as
// it does for shared memory, so the three differ only in where the loads go.
//
// Exactness: each cost is one IEEE add of two inputs (no FMA can form:
// there is no multiply), and the strict '<' in increasing j keeps the
// first index of the minimum, so the result equals the plain PyTorch
// version (kernels/minplus/ref.py) bit for bit in f32 and f64.  Skipping
// j > d is exact: those candidates read the +inf left pad, and
// x + inf is never '<' anything.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

// buffer placement (kernel.py::sweep_plan's modes)
constexpr int kShared = 0;
constexpr int kGlobalCarry = 1;
constexpr int kGlobal = 2;

template <typename T, int kMode>
__global__ void __launch_bounds__(1024)
minplus_sweep_kernel(const T* __restrict__ rows, T* __restrict__ cost,
                     int32_t* __restrict__ split, T* carry, int n_slots,
                     int dc1, int d1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* prev;       // carry cost_{t-1}, (d1,)
  T* next;       // carry being built, (d1,)
  T* row;        // rows[t] staged in shared memory, (dc1,); kGlobal: unused
  if constexpr (kMode == kShared) {
    prev = reinterpret_cast<T*>(smem_raw);
    next = prev + d1;
    row = next + d1;
  } else {
    prev = carry;
    next = carry + d1;
    row = reinterpret_cast<T*>(smem_raw);
  }
  const T inf = pos_inf<T>();

  for (int d = threadIdx.x; d < d1; d += blockDim.x)
    prev[d] = d == 0 ? T(0) : inf;

  for (int t = 0; t < n_slots; ++t) {
    const T* row_g = rows + static_cast<int64_t>(t) * dc1;
    const T* row_t = row_g;
    if constexpr (kMode != kGlobal) {
      for (int j = threadIdx.x; j < dc1; j += blockDim.x) row[j] = row_g[j];
      row_t = row;
    }
    __syncthreads();  // row t and the carry of slot t-1 are in place

    T* cost_t = cost + static_cast<int64_t>(t) * d1;
    int32_t* split_t =
        split == nullptr ? nullptr : split + static_cast<int64_t>(t) * d1;
    for (int d = threadIdx.x; d < d1; d += blockDim.x) {
      T best = inf;
      int32_t arg = 0;
      const int jmax = min(dc1 - 1, d);
      for (int j = 0; j <= jmax; ++j) {
        const T cand = row_t[j] + prev[d - j];
        if (cand < best) {
          best = cand;
          arg = j;
        }
      }
      next[d] = best;
      cost_t[d] = best;
      if (split_t != nullptr) split_t[d] = arg;
    }
    __syncthreads();  // every read of row and prev is done
    T* tmp = prev;
    prev = next;
    next = tmp;
  }
}

template <typename T, int kMode>
int launch_mode(const void* rows, void* cost, void* split, void* carry,
                int n_slots, int dc1, int d1, void* stream) {
  const size_t smem =
      kMode == kShared   ? (2 * static_cast<size_t>(d1) + dc1) * sizeof(T)
      : kMode == kGlobal ? 0
                         : static_cast<size_t>(dc1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      minplus_sweep_kernel<T, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // columns per thread so that a block has at most 1024 threads, then as
  // few threads as give every thread that many columns
  const int cols = (d1 + 1023) / 1024;
  const int threads = ((d1 + cols - 1) / cols + 31) / 32 * 32;
  minplus_sweep_kernel<T, kMode><<<1, threads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<T*>(cost),
      static_cast<int32_t*>(split), static_cast<T*>(carry), n_slots, dc1,
      d1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* rows, void* cost, void* split, void* carry,
           int n_slots, int dc1, int d1, int mode, void* stream) {
  switch (mode) {
    case kShared:
      return launch_mode<T, kShared>(rows, cost, split, carry, n_slots, dc1,
                                     d1, stream);
    case kGlobalCarry:
      return launch_mode<T, kGlobalCarry>(rows, cost, split, carry, n_slots,
                                          dc1, d1, stream);
    case kGlobal:
      return launch_mode<T, kGlobal>(rows, cost, split, carry, n_slots, dc1,
                                     d1, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// rows (n_slots, dc1), cost (n_slots, d1) contiguous on the device;
// split (n_slots, d1) int32 or NULL for a cost-only sweep; carry a
// (2, d1) scratch for modes kGlobalCarry and kGlobal (NULL for kShared);
// mode as in kernel.py::sweep_plan.  Enqueued on `stream`; returns the
// cudaError_t of the launch (0 = launched).
int minplus_sweep_f32(const void* rows, void* cost, void* split, void* carry,
                      int n_slots, int dc1, int d1, int mode, void* stream) {
  return launch<float>(rows, cost, split, carry, n_slots, dc1, d1, mode,
                       stream);
}

int minplus_sweep_f64(const void* rows, void* cost, void* split, void* carry,
                      int n_slots, int dc1, int d1, int mode, void* stream) {
  return launch<double>(rows, cost, split, carry, n_slots, dc1, d1, mode,
                        stream);
}

const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
