// Run-compressed (plateau) min-plus DP slot for Hopper (sm_90a), cost
// only.
//
// Replaces the TPU kernel src/repro/kernels/minplus/kernel.py::
// minplus_plateau_pallas (body _minplus_plateau_kernel):
//
//     new[d] = min_{j <= min(DC, d)} row[j] + prev[d - j]
//
// computed per run of bitwise-equal row values: within a run [s, e] the
// row is one constant c, and rounding is monotone, so
// min_{j in run} fl(c + prev[d - j]) == fl(c + min_{j in run} prev[d - j]).
// The window minimum comes from a doubling table over the carry,
// tab[k][i] = min prev[i .. i + 2^k - 1], as the minimum of two
// overlapping power-of-two windows.  Min is exact, so the result equals
// the chain (kernels/minplus/tiled.py::minplus_chain_step) and the plain
// version (monotone.py::plateau_step) bit for bit, in f32 and f64.
//
// It is the plateau step of the tiled decision core: one launch per live
// slot of a tile whose rows all have at most r_max runs.
//
// What bounds it on this card: at the core's shapes (DC+1 = 64,
// D+1 >= 1280) a launch does ~(D+1) * (log2(DC+1) + 2 * runs) minimum
// operations, so the launch latency floors it.  Design: a grid over
// blocks of outputs [d0, d0 + blockDim), one thread per output.  Each
// block
//   1. finds the row's runs: per-thread counts of run starts over
//      contiguous chunks of the row, a block prefix sum, and a compacted
//      list of at most r_max (start, end, constant) triples;
//   2. builds the doubling table over ITS window of the carry,
//      prev[d0 - DC .. d0 + blockDim - 1] (+inf left of 0), only up to the
//      level the longest run needs;
//   3. answers its outputs with two table reads per run.
// The table sits in shared memory when it fits in the 227 KB a block may
// use (DC+1 up to ~1,000 in f64 at 256 outputs a block); above that the
// plan (kernel.py::plateau_plan) gives each block of 1024 outputs its own
// region of a global scratch tensor the wrapper allocates (levels x
// (1024 + DC) values per block: 22 MB in f64 at DC+1 = 8960,
// D+1 = 20480), which __syncthreads() orders as it does shared memory.
//
// The TPU kernel pads the row to 128 lanes with +inf, which can add one
// run, and is sound only for at most r_max runs.  This kernel pads
// nothing, so the caller's run count is its own; a row with more than
// r_max runs (never passed by the decision core, whose per-tile gate
// checks the count) takes the direct loop over every j instead, so the
// result is right for any row free of NaN.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

template <typename T>
__device__ __forceinline__ T min2(T a, T b) {
  return b < a ? b : a;
}

template <typename T, bool kTableShared>
__global__ void __launch_bounds__(1024)
minplus_plateau_kernel(const T* __restrict__ row, const T* __restrict__ prev,
                       T* __restrict__ out, T* scratch, int dc1, int d1,
                       int r_max, int kmax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lw = nt + dc1 - 1;            // table width (window length)
  // shared layout: values first (8-byte aligned), then ints
  T* s_c = reinterpret_cast<T*>(smem_raw);                  // (r_max,)
  T* tab = kTableShared ? s_c + r_max                       // (kmax, lw)
                        : scratch + static_cast<int64_t>(blockIdx.x) *
                                        kmax * lw;
  int* s_scan = reinterpret_cast<int*>(
      s_c + r_max + (kTableShared ? kmax * lw : 0));        // (nt,)
  int* s_start = s_scan + nt;                               // (r_max,)
  int* s_end = s_start + r_max;                             // (r_max,)
  int* s_kw = s_end + r_max;                                // (1,)
  const T inf = pos_inf<T>();
  const int d0 = blockIdx.x * nt;
  const int d = d0 + tid;

  // 1. the row's runs, in order
  if (tid == 0) *s_kw = 0;
  const int chunk = (dc1 + nt - 1) / nt;
  const int j0 = min(tid * chunk, dc1);
  const int j1 = min(j0 + chunk, dc1);
  int cnt = 0;
  for (int j = j0; j < j1; ++j) cnt += (j == 0 || row[j] != row[j - 1]);
  s_scan[tid] = cnt;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {   // inclusive prefix sum
    const int v = tid >= off ? s_scan[tid - off] : 0;
    __syncthreads();
    s_scan[tid] += v;
    __syncthreads();
  }
  const int n_runs = s_scan[nt - 1];
  int w = s_scan[tid] - cnt;
  for (int j = j0; j < j1; ++j) {
    if (j == 0 || row[j] != row[j - 1]) {
      if (w < r_max) s_start[w] = j;
      ++w;
    }
  }
  __syncthreads();

  if (n_runs > r_max) {   // uniform over the block: the direct loop
    if (d < d1) {
      T best = inf;
      const int jmax = min(dc1 - 1, d);
      for (int j = 0; j <= jmax; ++j) best = min2(best, row[j] + prev[d - j]);
      out[d] = best;
    }
    return;
  }
  for (int r = tid; r < n_runs; r += nt) {
    const int s = s_start[r];
    const int e = (r + 1 < n_runs ? s_start[r + 1] : dc1) - 1;
    s_end[r] = e;
    s_c[r] = row[s];
    atomicMax(s_kw, 31 - __clz(e - s + 1));
  }

  // 2. doubling table over prev[base .. base + lw - 1], base = d0 - DC
  const int base = d0 - (dc1 - 1);
  for (int i = tid; i < lw; i += nt) {
    const int p = base + i;
    tab[i] = (p >= 0 && p < d1) ? prev[p] : inf;
  }
  __syncthreads();
  const int kw_max = *s_kw;
  for (int k = 1; k <= kw_max; ++k) {
    const int half = 1 << (k - 1);
    const T* lvl = tab + static_cast<int64_t>(k - 1) * lw;
    T* nxt = tab + static_cast<int64_t>(k) * lw;
    for (int i = tid; i < lw; i += nt)
      nxt[i] = min2(lvl[i], i + half < lw ? lvl[i + half] : inf);
    __syncthreads();
  }

  // 3. per run, the constant plus the window minimum of
  //    prev[d - e .. d - s] from two windows of 2^kw values
  if (d >= d1) return;
  T best = inf;
  for (int r = 0; r < n_runs; ++r) {
    const int s = s_start[r];
    const int e = s_end[r];
    const int kw = 31 - __clz(e - s + 1);
    const T* lvl = tab + static_cast<int64_t>(kw) * lw;
    const T lo = lvl[d - e - base];
    const T hi = lvl[d - s - (1 << kw) + 1 - base];
    best = min2(best, s_c[r] + min2(lo, hi));
  }
  out[d] = best;
}

template <typename T, bool kTableShared>
int launch_table(const void* row, const void* prev, void* out, void* scratch,
                 int dc1, int d1, int r_max, int kmax, int block,
                 size_t smem, void* stream) {
  if (smem > kDefaultSmem) {  // opt in above the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        minplus_plateau_kernel<T, kTableShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (d1 + block - 1) / block;
  minplus_plateau_kernel<T, kTableShared>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(row), static_cast<const T*>(prev),
          static_cast<T*>(out), static_cast<T*>(scratch), dc1, d1, r_max,
          kmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* row, const void* prev, void* out, void* scratch,
           int dc1, int d1, int r_max, int kmax, int block, int table_shared,
           long long smem, void* stream) {
  if (block < 32 || block > 1024 || (block & (block - 1)) != 0 || r_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return table_shared
             ? launch_table<T, true>(row, prev, out, scratch, dc1, d1, r_max,
                                     kmax, block, smem, stream)
             : launch_table<T, false>(row, prev, out, scratch, dc1, d1, r_max,
                                      kmax, block, smem, stream);
}

}  // namespace

extern "C" {

// row (dc1,), prev (d1,), out (d1,) contiguous on the device; scratch
// (grid, kmax, block + dc1 - 1) values when the table is not in shared
// memory (else NULL); kmax, block, table_shared and smem (bytes) from
// kernel.py::plateau_plan.  Enqueued on `stream`; returns the cudaError_t
// of the launch (0 = launched).
int minplus_plateau_f32(const void* row, const void* prev, void* out,
                        void* scratch, int dc1, int d1, int r_max, int kmax,
                        int block, int table_shared, long long smem,
                        void* stream) {
  return launch<float>(row, prev, out, scratch, dc1, d1, r_max, kmax, block,
                       table_shared, smem, stream);
}

int minplus_plateau_f64(const void* row, const void* prev, void* out,
                        void* scratch, int dc1, int d1, int r_max, int kmax,
                        int block, int table_shared, long long smem,
                        void* stream) {
  return launch<double>(row, prev, out, scratch, dc1, d1, r_max, kmax, block,
                        table_shared, smem, stream);
}

const char* minplus_plateau_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
