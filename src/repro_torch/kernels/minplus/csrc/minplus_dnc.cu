// Convex divide-and-conquer min-plus DP tile for Hopper (sm_90a), cost
// only: the live slots of one D&C tile in ONE launch of one thread block,
// from a carry-in.
//
// The counterpart of src/repro/kernels/minplus/monotone.py::
// monotone_dnc_step (a jnp function, not a Pallas kernel) as the tiled
// route runs it, once per slot inside the tile's slot scan when the
// REPRO_MONOTONE_DNC switch is on and every row of the tile is certified
// convex (src/repro/core/schedule_jax.py's tile body):
//
//     cost_t[d] = min_{j <= min(DC, d)} rows[t, j] + cost_{t-1}[d - j]
//
// for t = 0 .. n_slots-1, with cost_{-1} the carry given in device memory.
// For a convex row the candidate matrix A[d][i] = cost_{t-1}[i] +
// row[d - i] is Monge, so its argmin per row d is nondecreasing in d.
// The columns are taken level by level of a static binary recursion over
// [0, d1) (monotone.py::_dnc_levels, a table of (s, e) segments per
// level; each d is the midpoint (s + e) / 2 of exactly one segment):
// midpoint d scans the candidates i in [max(lo_d, d - m', 0), min(hi_d,
// d, P)] (m', P: the last finite index of the row and of the carry),
// keeping the minimum and its leftmost and rightmost argmin over equal
// values; the left child's bounds are (lo_d, min(hi_d, rightmost)), the
// right child's (max(lo_d, leftmost), hi_d), and a midpoint whose range
// is empty or all +inf passes its range on unshrunk.  The row's exact
// convexity certificate (monotone.py::convex_certificate, checked by the
// caller's gate) makes every scanned range hold an exact argmin, and the
// rounded minimum over such a range is the chain's: each candidate is one
// IEEE add (built with -fmad=false; there is no multiply) and min is
// exact, so the columns equal the plain version (monotone_dnc_step,
// chained) and the chain (minplus_sweep.cu from the same carry) bit for
// bit, in f32 and f64, wherever the carry holds no -0.  Unlike the
// reference's jnp step, which flattens a level's candidates into a
// buffer of d1 + segments + 64 cells and falls back to the chain when it
// spills, the kernel keeps no candidate buffer and never spills.
//
// The design, and what it does about each constraint:
// * The slots are a sequential chain and the levels of a slot are too,
//   so one block does the whole tile: one __syncthreads per level and two
//   per slot, no cross-block handoff.  The carry, the new column and the
//   per-midpoint bounds (2 d1 values and 2 d1 ints: ~30 KB at d1 = 1280
//   in f64) live in shared memory where they fit (kernel.py::dnc_plan),
//   else in global memory (the carry and the new column are rows of the
//   output, the bounds a scratch tensor the wrapper allocates), which
//   __syncthreads orders as it does shared memory within the block (the
//   carry and the output are not declared __restrict__: in global memory
//   the carry is the output's previous row, which must not be read
//   through the read-only cache).
// * A level of n midpoints gives each a group of G = min(pow2 <= threads
//   / n, threads) lanes (whole warps or parts of one): the top levels,
//   with few midpoints and wide ranges, scan each range with many lanes
//   and reduce (min, leftmost, rightmost) by warp shuffles and, for a
//   group of several warps, one pass through shared memory; the deep
//   levels, with many midpoints and ranges of a few candidates, take a
//   lane each.
// * m' and P are found per slot by a max over the row and the carry,
//   while the row is staged in shared memory: a warp reduction, then one
//   shared atomicMax per warp.
//
// What bounds it: a slot's candidates are ~d1 + n_seg per level (the
// ranges of a level overlap only at their ends when no ties widen them),
// ~log2(d1) levels, an add and a compare each: ~30 k operations at d1 =
// 1280, nanoseconds of the card's rates; the levels' barriers and the
// sequential scans of the top levels set the time.

#include <cuda_runtime.h>

#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;

template <typename T>
__device__ __forceinline__ T inf_value();
template <>
__device__ __forceinline__ float inf_value<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double inf_value<double>() { return CUDART_INF; }

// (v, l, r) <- the min of two partial scans, with the leftmost and the
// rightmost index of the minimum over equal values
template <typename T>
__device__ __forceinline__ void combine(T& v, int& l, int& r, T v2, int l2,
                                        int r2) {
  if (v2 < v) {
    v = v2;
    l = l2;
    r = r2;
  } else if (v2 == v) {
    l = min(l, l2);
    r = max(r, r2);
  }
}

template <typename T>
__device__ __forceinline__ void shuffle_reduce(T& v, int& l, int& r,
                                               int width) {
  for (int off = width / 2; off > 0; off /= 2) {
    T v2 = __shfl_xor_sync(0xffffffffu, v, off);
    int l2 = __shfl_xor_sync(0xffffffffu, l, off);
    int r2 = __shfl_xor_sync(0xffffffffu, r, off);
    combine(v, l, r, v2, l2, r2);
  }
}

// Dynamic shared memory, in this order: with kShared the carry and the
// new column (d1 values each), the staged row (dc1 values), the bounds
// lo_b and hi_b (d1 ints each); always the per-warp partials of a group
// of several warps (threads / 32 values and 2 x threads / 32 ints), the
// two per-slot maxima and the levels' offsets (n_levels + 1 ints).
template <typename T, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
    minplus_dnc_kernel(const T* __restrict__ rows,
                       const T* carry_in, T* out, int* scratch,
                       const int2* __restrict__ segs,
                       const int* __restrict__ level_off, int n_levels,
                       int n_slots, int dc1, int d1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int nw = nt / kWarp;
  T* base = reinterpret_cast<T*>(smem_raw);
  T* buf0 = base;
  T* buf1 = kShared ? base + d1 : base;
  T* srow = kShared ? base + 2 * d1 : base;
  T* pv = kShared ? base + 2 * d1 + dc1 : base;
  int* ip = reinterpret_cast<int*>(pv + nw);
  int* lo_b = kShared ? ip : scratch;
  int* hi_b = kShared ? ip + d1 : scratch + d1;
  int* pl = kShared ? ip + 2 * d1 : ip;
  int* pr = pl + nw;
  int* s_max = pr + nw;  // [0] m', [1] P
  int* s_off = s_max + 2;  // the levels' offsets, n_levels + 1
  const T inf = inf_value<T>();
  for (int k = tid; k <= n_levels; k += nt) s_off[k] = level_off[k];

  const T* carry = carry_in;
  if (kShared) {
    for (int i = tid; i < d1; i += nt) buf0[i] = carry_in[i];
    carry = buf0;
  }
  for (int t = 0; t < n_slots; ++t) {
    const T* row = rows + static_cast<int64_t>(t) * dc1;
    T* out_t = out + static_cast<int64_t>(t) * d1;
    T* nxt = kShared ? (t % 2 ? buf0 : buf1) : out_t;
    if (tid == 0) {
      s_max[0] = -1;
      s_max[1] = -1;
      const int root = d1 / 2;  // the first level's (0, d1)
      lo_b[root] = 0;
      hi_b[root] = d1 - 1;
    }
    __syncthreads();
    int last_r = -1, last_p = -1;
    for (int j = tid; j < dc1; j += nt) {
      const T x = row[j];
      if (kShared) srow[j] = x;
      if (isfinite(x)) last_r = j;
    }
    for (int i = tid; i < d1; i += nt)
      if (isfinite(carry[i])) last_p = i;
    // one atomic per warp: the same-address atomics of every thread
    // would serialize
    last_r = __reduce_max_sync(0xffffffffu, last_r);
    last_p = __reduce_max_sync(0xffffffffu, last_p);
    if (tid % kWarp == 0) {
      atomicMax(&s_max[0], last_r);
      atomicMax(&s_max[1], last_p);
    }
    __syncthreads();
    const T* rw = kShared ? srow : row;
    const int mp = s_max[0];
    const int pm = s_max[1];

    for (int lev = 0; lev < n_levels; ++lev) {
      const int off0 = s_off[lev];
      const int n = s_off[lev + 1] - off0;
      int g = 1;
      while (2 * g * n <= nt && g < nt) g *= 2;
      const int groups = nt / g;
      const int grp = tid / g;
      const int glane = tid % g;
      for (int q0 = 0; q0 < n; q0 += groups) {
        const int q = q0 + grp;
        const bool active = q < n;
        int s = 0, e = 0, mid = 0, lo = 0, hi = -1;
        if (active) {
          const int2 se = segs[off0 + q];
          s = se.x;
          e = se.y;
          mid = (s + e) / 2;
          lo = max(max(lo_b[mid], mid - mp), 0);
          hi = min(min(hi_b[mid], mid), pm);
        }
        T v = inf;
        int l = d1, r = -1;
        for (int i = lo + glane; i <= hi; i += g) {
          const T c = rw[mid - i] + carry[i];
          if (c < v) {
            v = c;
            l = i;
            r = i;
          } else if (c == v) {
            r = i;
          }
        }
        shuffle_reduce(v, l, r, g < kWarp ? g : kWarp);
        if (g > kWarp) {
          // one group of several warps per midpoint: a single pass over
          // q0 (n <= threads / 64), so the partials are written once
          const int warp = tid / kWarp;
          if (tid % kWarp == 0) {
            pv[warp] = v;
            pl[warp] = l;
            pr[warp] = r;
          }
          __syncthreads();
          if (glane == 0)
            for (int k = warp + 1; k < warp + g / kWarp; ++k)
              combine(v, l, r, pv[k], pl[k], pr[k]);
        }
        if (active && glane == 0) {
          nxt[mid] = v;
          if (kShared) out_t[mid] = v;
          if (!(hi >= lo && isfinite(v))) {
            l = lo;
            r = hi;
          }
          const int lo_p = lo_b[mid];
          const int hi_p = hi_b[mid];
          if (s < mid) {
            const int lm = (s + mid) / 2;
            lo_b[lm] = lo_p;
            hi_b[lm] = min(hi_p, r);
          }
          if (mid + 1 < e) {
            const int rm = (mid + 1 + e) / 2;
            lo_b[rm] = max(lo_p, l);
            hi_b[rm] = hi_p;
          }
        }
      }
      __syncthreads();
    }
    carry = nxt;
  }
}

template <typename T, bool kShared>
cudaError_t launch_mode(const void* rows, const void* carry, void* out,
                        void* scratch, const void* segs,
                        const void* level_off, int n_levels, int n_slots,
                        int dc1, int d1, int threads, size_t smem,
                        void* stream) {
  auto kern = minplus_dnc_kernel<T, kShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const T*>(carry),
      static_cast<T*>(out), static_cast<int*>(scratch),
      static_cast<const int2*>(segs), static_cast<const int*>(level_off),
      n_levels, n_slots, dc1, d1);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* rows, const void* carry, void* out, void* scratch,
           const void* segs, const void* level_off, int n_levels,
           int n_slots, int dc1, int d1, int threads, int shared,
           int smem_bytes, void* stream) {
  // the plan's invariants (kernel.py::dnc_plan); anything else is refused
  if (n_slots < 1 || dc1 < 1 || d1 < 1 || n_levels < 1 ||
      threads < kWarp || threads > kMaxThreads || threads % kWarp != 0 ||
      (threads & (threads - 1)) != 0 || smem_bytes < 0 || n_levels > 32 ||
      (!shared && scratch == nullptr) || segs == nullptr ||
      level_off == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes);
  return static_cast<int>(
      shared ? launch_mode<T, true>(rows, carry, out, scratch, segs,
                                    level_off, n_levels, n_slots, dc1, d1,
                                    threads, smem, stream)
             : launch_mode<T, false>(rows, carry, out, scratch, segs,
                                     level_off, n_levels, n_slots, dc1, d1,
                                     threads, smem, stream));
}

}  // namespace

extern "C" {

// rows (n_slots, dc1), carry (d1,), out (n_slots, d1) contiguous on the
// device (out may be rows of a larger table); scratch 2 d1 ints when the
// columns and bounds are not in shared memory (else NULL); segs (d1, 2)
// int32 (s, e) of each level's segments in level order and level_off
// (n_levels + 1,) int32 their offsets (kernel.py::dnc_levels); the launch
// plan (kernel.py::dnc_plan): threads, placement, dynamic shared bytes.
// Enqueued on `stream`; returns the cudaError_t of the launch (0 =
// launched).
int minplus_dnc_f32(const void* rows, const void* carry, void* out,
                    void* scratch, const void* segs, const void* level_off,
                    int n_levels, int n_slots, int dc1, int d1, int threads,
                    int shared, int smem_bytes, void* stream) {
  return launch<float>(rows, carry, out, scratch, segs, level_off, n_levels,
                       n_slots, dc1, d1, threads, shared, smem_bytes, stream);
}

int minplus_dnc_f64(const void* rows, const void* carry, void* out,
                    void* scratch, const void* segs, const void* level_off,
                    int n_levels, int n_slots, int dc1, int d1, int threads,
                    int shared, int smem_bytes, void* stream) {
  return launch<double>(rows, carry, out, scratch, segs, level_off,
                        n_levels, n_slots, dc1, d1, threads, shared,
                        smem_bytes, stream);
}

const char* minplus_dnc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
