// Run-compressed (plateau) min-plus DP tile for Hopper (sm_90a), cost
// only: the live slots of one plateau tile in ONE launch of one
// thread-block cluster, from a carry-in.
//
// Replaces the TPU kernel src/repro/kernels/minplus/kernel.py::
// minplus_plateau_pallas (body _minplus_plateau_kernel) as the tiled
// route runs it, once per slot inside the tile's slot scan
// (src/repro/core/schedule_jax.py's tile body, plateau_step_unrolled):
//
//     cost_t[d] = min_{j <= min(DC, d)} rows[t, j] + cost_{t-1}[d - j]
//
// for t = 0 .. n_slots-1, with cost_{-1} the carry given in device memory.
// Each slot is computed per run of equal row values: within a run [s, e]
// the row is one constant c, and rounding is monotone, so
// min_{j in run} fl(c + prev[d - j]) == fl(c + min_{j in run} prev[d - j]).
// The window minimum comes from a doubling table over the carry,
// tab[k][i] = min prev[i .. i + 2^k - 1], as the minimum of two
// overlapping power-of-two windows.  Min is exact, so each column equals
// the plain version (monotone.py::plateau_step, chained) and the chain
// (minplus_sweep.cu from the same carry) bit for bit, in f32 and f64.
// n_slots = 1 is the one-slot entry (ops.minplus_monotone).
//
// What bounds it on this card.  A slot reads a row of DC+1 values and
// writes D+1; its work is the table's minima up to the level the longest
// run needs, then an add and two minima per run and output: at the
// route's shape (DC+1 = 64, D+1 = 1280, <= 16 runs) ~50 k operations and
// ~21 KB, nanoseconds of the card's rates.  The slots form a sequential
// chain, so what is left is the per-slot cost of handing the carry from
// one slot to the next across the SMs, as in the sweep; the kernel this
// one replaces paid a whole launch for it, once per slot.  Timed at the
// route's shape (tools/plateau_tile_probe.py, NVIDIA H100 80GB HBM3,
// 700 W): ~3.6 us a launch and ~1.3 us a slot, of which the handoff alone
// is ~1.0; the chain kernel takes ~3.3 and ~1.34 on the same tiles.
//
// The design, and what it does about each:
// * The sweep's carry handoff as it stands (minplus_sweep.cu): one
//   cluster of C blocks (kernel.py::plateau_plan; 16, beyond the portable
//   size, only where the card can place it), block r owning the columns
//   [r w, (r+1) w) with its slice of cost_{t-1} and cost_t ping-ponged in
//   shared memory; at each slot the halo cost_{t-1}[r w - JP, r w) (+inf
//   left of 0; JP = DC+1 rounded up to 4) copied out of the lower ranks'
//   slices through DSMEM in 16-byte loads, with the block's own slice,
//   into one window; one relaxed cluster barrier per slot, one fence, the
//   slot's global stores between the arrive and the wait.
// * The window IS level 0 of the doubling table (JP + w values); levels
//   1 .. k are built from it in shared memory, only up to the level this
//   row's runs need, each entry one min of two entries of the level below,
//   each level a pass and a __syncthreads.  A run of len values takes
//   level floor(log2(len - 1)): two windows of that power of two cover it
//   (the plain version's floor(log2(len)) is a level higher where len is
//   a power of two), so at most 5 levels at DC+1 = 64.  Each output then
//   takes two table reads and one add per run, at offsets fixed per run:
//   every thread reads the run list as a broadcast, the loop over runs
//   unrolled so that several runs' reads are in flight at once.
// * The runs: a tile's rows are staged in shared memory up front, in
//   chunks of as many slots as shared memory holds (the whole tile, 64
//   slots, at the route's shape): each warp copies its share of the rows
//   with cp.async and scans each of them with warp ballots over
//   row[j] != row[j-1], compacting at most r_max run starts, then writes
//   each finite run's constant, the offsets of its two table reads and
//   the top level over them.  So a slot neither loads nor scans its row;
//   a version that copied and scanned each row inside its slot took ~1.96
//   us a slot on 47-slot tiles of route-like rows, the chain 1.41.  A
//   +inf run cannot lower a minimum and is left out: at the route's band
//   COST rows end in a +inf run of ~60 values, which alone would set 5
//   table levels.  Every block scans the same rows, so a branch on a
//   row's run count is uniform over the cluster.  A later chunk is staged
//   between the arrive and the wait of the slot before it, where the
//   block only waits for the other blocks.
// * 256 threads a block at least, though a block has 80 columns at the
//   route's shape: measured ~0.1 us a slot faster than 128 (the level
//   passes and the staging have more hands).
// * A row with more than r_max runs (never passed by the tiled route,
//   whose per-tile gate checks the count) takes the direct loop over
//   every j on the same window, so the result is right for any row free
//   of NaN and -inf.
// * Where the table does not fit the 227 KB a block may use (DC+1 in the
//   thousands), it lives in a global scratch tensor the wrapper
//   allocates, one region of kmax (JP + w) values per block, which
//   __syncthreads orders as it does shared memory; the slices, rows and
//   run lists stay in shared memory, in chunks of fewer slots.  Only the
//   one-slot entry and the tests reach such bands.
//
// Exactness: each value is one IEEE add of a run constant and an exact
// minimum of carry values.  min picks either zero of a +0/-0 tie, and the
// result equals the chain only where no such tie arises: the carry holds
// no -0 (the identity starts at +0, and a sum is -0 only when both
// addends are, so a DP column started from it never holds one), as the
// chain's cost-only path assumes too.  Runs are split where row[j] !=
// row[j-1], as the plain version splits them, so +0 and -0 share a run;
// c + x equals c' + x for c == c' whenever x is not -0.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <mutex>
#include <set>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxPortableCluster = 8;
constexpr int kMaxCluster = 16;
// w and JP are multiples of 4 values (kernel.py::SWEEP_K), so a 16-byte
// halo load never straddles two slices
constexpr int kAlign = 4;

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

// a compare and a select: in float64 faster than DMNMX (minplus_sweep.cu)
template <typename T>
__device__ __forceinline__ T min2(T a, T b) {
  return b < a ? b : a;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

// The cluster barrier of a slot in two halves, as in minplus_sweep.cu.
__device__ __forceinline__ void cluster_arrive() {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A warp's scan of one row (the whole warp calls it): the starts of its
// runs of equal consecutive values, by ballots over 32 values at a time,
// into off_lo; then, compacted in place by a second round of ballots,
// each run whose constant is finite, with the offsets of its two table
// reads (relative to the output's local column c):
//   lo at level kw, entry c + JP - e;  hi at entry c + JP - s - 2^kw + 1,
// level kw at kw * lw, with kw = floor(log2(len - 1)) for a run of len >=
// 2 values (0 for one): two windows of 2^kw cover len <= 2^(kw+1) values
// and neither leaves the run, since 2^kw < len; one level lower than
// floor(log2(len)) where len is a power of two.  A +inf run is left
// out: +inf + x is +inf for every carry value x (no -inf, no NaN), which
// never lowers a minimum, so the result keeps its bits.  meta = (runs
// kept, top level over them), or (run count, 0) for a row of more than
// r_max runs, whose scan stops early and which the direct loop takes.
// off_lo holds r_max + 1 entries (the last run's end).
template <typename T>
__device__ void scan_runs(const T* row, int dc1, int r_max, int jpad, int lw,
                          int* off_lo, int* off_hi, T* cst, int* meta) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* start = off_lo;
  int count = 0;
  for (int base = 0; base < dc1; base += 32) {
    const int j = base + lane;
    const bool first = j < dc1 && (j == 0 || row[j] != row[j - 1]);
    const unsigned m = __ballot_sync(0xffffffffu, first);
    if (first) {
      const int idx = count + __popc(m & below);
      if (idx < r_max) start[idx] = j;
    }
    count += __popc(m);
    if (count > r_max) break;  // uniform over the warp
  }
  int kept = count;
  int top = 0;
  if (count <= r_max) {
    if (lane == 0) start[count] = dc1;
    __syncwarp();
    kept = 0;
    for (int base = 0; base < count; base += 32) {
      const int r = base + lane;
      int s = 0, e = 0;
      T c = pos_inf<T>();
      if (r < count) {
        s = start[r];
        e = start[r + 1] - 1;
        c = row[s];
      }
      // every lane's starts are read before any lane writes over them:
      // a run kept lands at an index no later than its own
      __syncwarp();
      const bool live = c < pos_inf<T>();
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int idx = kept + __popc(m & below);
        const int len = e - s + 1;
        const int kw = len > 1 ? 31 - __clz(len - 1) : 0;
        off_lo[idx] = kw * lw + jpad - e;
        off_hi[idx] = kw * lw + jpad - s - (1 << kw) + 1;
        cst[idx] = c;
        top = max(top, kw);
      }
      kept += __popc(m);
      __syncwarp();
    }
    top = __reduce_max_sync(0xffffffffu, top);
  }
  if (lane == 0) {
    meta[0] = kept;
    meta[1] = top;
  }
}

// Stage the rows [t0, t0 + n) of a chunk and their run lists: warp v
// copies rows v, v + warps, ... (cp.async, one 4- or 8-byte copy per
// value), waits for its own copies and scans each of them into its slot
// of the lists; the block's next __syncthreads publishes them.
template <typename T>
__device__ void stage_chunk(const T* rows, int t0, int n, int dc1, int r_max,
                            int jpad, int lw, T* row_buf, T* cst, int* off_lo,
                            int* off_hi, int* meta) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32;
  for (int i = warp; i < n; i += warps) {
    const T* src = rows + static_cast<int64_t>(t0 + i) * dc1;
    T* dst = row_buf + static_cast<int64_t>(i) * jpad;
    for (int j = lane; j < dc1; j += 32) {
      const unsigned addr =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + j));
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(addr),
                   "l"(src + j), "n"(sizeof(T)));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  cp_async_wait_all();
  __syncwarp();
  for (int i = warp; i < n; i += warps)
    scan_runs(row_buf + static_cast<int64_t>(i) * jpad, dc1, r_max, jpad, lw,
              off_lo + i * (r_max + 1), off_hi + i * r_max, cst + i * r_max,
              meta + 2 * i);
}

// Shared memory of a block, values of T first, then int32; a chunk holds
// up to `stage` slots (kernel.py::plateau_plan, 64 at the route's shape):
//   slice[2][w]               its columns of cost_{t-1} / cost_t
//   row[stage][jpad]          the chunk's rows
//   cst[stage][r_max]         their finite runs' constants
//   tab[kmax][jpad + w]       the doubling table (table in shared memory)
//   off_lo[stage][r_max + 1]  (run starts while a warp scans the row)
//   off_hi[stage][r_max], meta[stage][2]
template <typename T, bool kTableShared>
__global__ void __launch_bounds__(kMaxThreads, 1)
minplus_plateau_kernel(const T* __restrict__ rows, const T* __restrict__ carry,
                       T* __restrict__ out, T* scratch, int n_slots, int dc1,
                       int d1, int r_max, int w, int jpad, int kmax,
                       int stage) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lw = jpad + w;
  T* slice = reinterpret_cast<T*>(smem_raw);
  T* row_buf = slice + 2 * w;
  T* cst = row_buf + static_cast<int64_t>(stage) * jpad;
  T* tab = kTableShared
               ? cst + static_cast<int64_t>(stage) * r_max
               : scratch + static_cast<int64_t>(blockIdx.x) * kmax * lw;
  int* off_lo = reinterpret_cast<int*>(
      cst + static_cast<int64_t>(stage) * r_max +
      (kTableShared ? static_cast<int64_t>(kmax) * lw : 0));
  int* off_hi = off_lo + stage * (r_max + 1);
  int* meta = off_hi + stage * r_max;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int col0 = static_cast<int>(cluster.block_rank()) * w;
  const T inf = pos_inf<T>();

  // cost_{-1}: the carry-in, +inf past D (never read by a column below
  // D+1); the first chunk's rows and runs
  for (int c = tid; c < w; c += nt) {
    const int col = col0 + c;
    slice[c] = col < d1 ? carry[col] : inf;
  }
  stage_chunk(rows, 0, min(stage, n_slots), dc1, r_max, jpad, lw, row_buf,
              cst, off_lo, off_hi, meta);
  cluster.sync();  // every block's slice of the carry, the chunk in place

  for (int t = 0, i = 0; t < n_slots; ++t, ++i) {
    if (i == stage) i = 0;  // the chunk staged at the end of slot t-1
    const T* prev = slice + (t & 1) * w;
    T* next = slice + ((t + 1) & 1) * w;
    const T* row = row_buf + static_cast<int64_t>(i) * jpad;
    const int* lo_i = off_lo + i * (r_max + 1);
    const int* hi_i = off_hi + i * r_max;
    const T* cst_i = cst + i * r_max;

    // level 0: window value x is cost_{t-1}[col0 - jpad + x], the halo
    // from the lower ranks' slices, then this block's own, through DSMEM
    using V = typename Vec16<T>::type;
    constexpr int kV = Vec16<T>::n;
    for (int x = tid * kV; x < lw; x += nt * kV) {
      const int gx = col0 - jpad + x;
      V vec;
      const T* v = reinterpret_cast<const T*>(&vec);
      if (gx < 0) {
#pragma unroll
        for (int e = 0; e < kV; ++e) reinterpret_cast<T*>(&vec)[e] = inf;
      } else {
        const int q = gx / w;
        vec = *reinterpret_cast<const V*>(cluster.map_shared_rank(prev, q) +
                                          gx - q * w);
      }
#pragma unroll
      for (int e = 0; e < kV; ++e) tab[x + e] = v[e];
    }
    __syncthreads();  // the window is in place

    const int n_runs = meta[2 * i];  // finite runs, or > r_max: direct loop
    if (n_runs > r_max) {
      // the direct loop: candidate j of column c reads window c + JP - j
      // (+inf where d - j < 0)
      for (int c = tid; c < w; c += nt) {
        const T* win = tab + c + jpad;
        T best = inf;
        for (int j = 0; j < dc1; ++j) best = min2(best, row[j] + win[-j]);
        next[c] = best;
      }
    } else {
      const int top = meta[2 * i + 1];
      for (int k = 1; k <= top; ++k) {
        // entries whose 2^k-window lies inside the table: the only ones
        // a run of length >= 2^k reads
        const int half = 1 << (k - 1);
        const int n_k = lw - (1 << k) + 1;
        const T* lvl = tab + static_cast<int64_t>(k - 1) * lw;
        T* nxt = tab + static_cast<int64_t>(k) * lw;
        for (int j = tid; j < n_k; j += nt) nxt[j] = min2(lvl[j], lvl[j + half]);
        __syncthreads();
      }
      for (int c = tid; c < w; c += nt) {
        T best = inf;
        // unrolled, so that the reads of several runs are in flight at once
#pragma unroll 4
        for (int r = 0; r < n_runs; ++r)
          best = min2(best, cst_i[r] + min2(tab[c + lo_i[r]], tab[c + hi_i[r]]));
        next[c] = best;
      }
    }

    // publish this slot's slice, then store it; at the end of a chunk,
    // stage the next while the other blocks reach the barrier: every read
    // of the chunk's rows and run lists ended before the arrive
    cluster_arrive();
    T* out_t = out + static_cast<int64_t>(t) * d1;
    for (int c = tid; c < w; c += nt)
      if (col0 + c < d1) out_t[col0 + c] = next[c];
    if (i + 1 == stage && t + 1 < n_slots)
      stage_chunk(rows, t + 1, min(stage, n_slots - t - 1), dc1, r_max, jpad,
                  lw, row_buf, cst, off_lo, off_hi, meta);
    // every block's slot-t slice is in place, and no slice of slot t-1 is
    // read again; after the last slot, no block's shared memory is read
    // again
    cluster_wait();
  }
}

template <typename T>
size_t smem_bytes(int w, int jpad, int r_max, int kmax, int stage,
                  bool table_shared) {
  const size_t lw = static_cast<size_t>(jpad) + w;
  const size_t st = static_cast<size_t>(stage);
  return sizeof(T) * (2 * static_cast<size_t>(w) + st * (jpad + r_max) +
                      (table_shared ? kmax * lw : 0)) +
         sizeof(int) * st * (2 * static_cast<size_t>(r_max) + 3);
}

// The kernel's attributes, set once per (device, shared memory, cluster,
// block size), as in minplus_sweep.cu: the largest dynamic shared memory
// the card allows a block and, beyond the portable cluster size, the
// non-portable size allowed and the card checked to place such a cluster.
template <typename T, bool kTableShared>
cudaError_t prepare(const cudaLaunchConfig_t& cfg, int cluster) {
  auto kern = minplus_plateau_kernel<T, kTableShared>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::set<std::tuple<int, size_t, int, int>> ready;
  const auto key = std::make_tuple(device, cfg.dynamicSmemBytes, cluster,
                                   static_cast<int>(cfg.blockDim.x));
  std::lock_guard<std::mutex> lock(mu);
  if (ready.count(key) != 0) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (cfg.dynamicSmemBytes > static_cast<size_t>(optin))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  if (cluster > kMaxPortableCluster) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
  }
  ready.insert(key);
  return cudaSuccess;
}

template <typename T, bool kTableShared>
int launch_table(const void* rows, const void* carry, void* out, void* scratch,
                 int n_slots, int dc1, int d1, int r_max, int cluster, int w,
                 int jpad, int threads, int kmax, int stage, void* stream) {
  auto kern = minplus_plateau_kernel<T, kTableShared>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes =
      smem_bytes<T>(w, jpad, r_max, kmax, stage, kTableShared);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = prepare<T, kTableShared>(cfg, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(rows),
                           static_cast<const T*>(carry), static_cast<T*>(out),
                           static_cast<T*>(scratch), n_slots, dc1, d1, r_max,
                           w, jpad, kmax, stage);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* rows, const void* carry, void* out, void* scratch,
           int n_slots, int dc1, int d1, int r_max, int cluster, int w,
           int jpad, int threads, int kmax, int stage, int table_shared,
           void* stream) {
  // the plan's invariants (kernel.py::plateau_plan); anything else is
  // refused
  if (n_slots < 1 || dc1 < 1 || d1 < 1 || r_max < 1 || cluster < 1 ||
      cluster > kMaxCluster || w < kAlign || w % kAlign != 0 || jpad < dc1 ||
      jpad % kAlign != 0 || static_cast<int64_t>(cluster) * w < d1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      kmax < 1 || kmax > 30 || (dc1 >> kmax) != 0 || stage < 1 ||
      (!table_shared && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return table_shared
             ? launch_table<T, true>(rows, carry, out, scratch, n_slots, dc1,
                                     d1, r_max, cluster, w, jpad, threads,
                                     kmax, stage, stream)
             : launch_table<T, false>(rows, carry, out, scratch, n_slots, dc1,
                                      d1, r_max, cluster, w, jpad, threads,
                                      kmax, stage, stream);
}

}  // namespace

extern "C" {

// rows (n_slots, dc1), carry (d1,), out (n_slots, d1) contiguous on the
// device (out may be rows of a larger table); scratch (cluster, kmax,
// jpad + w) values when the table is not in shared memory (else NULL);
// the launch plan (kernel.py::plateau_plan): cluster size, columns per
// block w, padded band jpad, threads per block, table levels kmax, slots
// staged at once, table placement.  Enqueued on `stream`; returns the cudaError_t of the launch
// (0 = launched).
int minplus_plateau_f32(const void* rows, const void* carry, void* out,
                        void* scratch, int n_slots, int dc1, int d1,
                        int r_max, int cluster, int w, int jpad, int threads,
                        int kmax, int stage, int table_shared, void* stream) {
  return launch<float>(rows, carry, out, scratch, n_slots, dc1, d1, r_max,
                       cluster, w, jpad, threads, kmax, stage, table_shared,
                       stream);
}

int minplus_plateau_f64(const void* rows, const void* carry, void* out,
                        void* scratch, int n_slots, int dc1, int d1,
                        int r_max, int cluster, int w, int jpad, int threads,
                        int kmax, int stage, int table_shared, void* stream) {
  return launch<double>(rows, carry, out, scratch, n_slots, dc1, d1, r_max,
                        cluster, w, jpad, threads, kmax, stage, table_shared,
                        stream);
}

const char* minplus_plateau_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
