// Banded min-plus DP over consecutive slots for Hopper (sm_90a): one
// thread-block cluster per launch, the carry in distributed shared memory.
//
//     cost_t[d]  = min_{j <= min(DC, d)} rows[t, j] + cost_{t-1}[d - j]
//     split_t[d] = the first j that attains the minimum
//
// for t = 0 .. n_slots-1 in ONE launch, from a carry cost_{-1} that is
// either the identity [0, inf, ...] (carry == NULL) or a column given in
// device memory.  Two callers, two TPU kernels:
//
// * the whole-horizon sweep (kernel.py::minplus_sweep_cuda, NULL carry)
//   replaces src/repro/kernels/minplus/kernel.py::minplus_sweep_pallas
//   (body _minplus_sweep_kernel): all T slots of a decision;
// * the tiled route's chain tile (the same wrapper given `prev`, through
//   ops.minplus_chain; cost only, from the carry the previous tile left)
//   replaces ::minplus_pallas (body _minplus_kernel) as that route runs
//   it: the reference scans a tile's
//   slots inside one device program (core/schedule_jax.py's tile body), and
//   here a tile's live slots are one launch, where the port used to make
//   one launch of csrc/minplus_slot.cu per slot.  minplus_slot.cu stays the
//   one-slot entry with its argmin (ops.minplus).
//
// Lanes.  The tiled route decides a burst's jobs of one shape bucket
// together (core/schedule_torch.py::_decide_jobs), and a chain tile then
// steps B lanes' slots from B carries in one launch: a grid of (C, B)
// blocks in clusters of (C, 1, 1), one cluster per lane, each offsetting
// rows, carry and cost by its lane's strides (blockIdx.y).  The lanes
// share nothing, so each cluster runs the one-lane recurrence below; at
// the 10x buckets C = 16, and 8 lanes fill 128 of an H100's 132 SMs.
// The lanes of a burst share the arrival slot's tile range: a lane's own
// dead slots carry identity rows [0, inf, ...], which step its carry
// unchanged (0 + x == x; inf + x == inf), so every lane steps the same
// slots.
//
// Why the tile is this kernel with a carry-in and not a minplus_tile.cu of
// its own: a tile is this recurrence over at most 64 slots from a given
// column; the cluster design below was measured best for it (PERF.md),
// and the carry-in costs one branch in the prologue, where a second
// kernel would repeat the whole handoff and be longer.  The tile's launch
// plan (kernel.py::sweep_plan) was timed on its own at C = 4, 8 and 16
// blocks (tools/tile_cluster_probe.py): 16 won at every 10x bucket, as for
// the sweep.  On the card a 64-slot float64 tile takes 1.39-3.36 us a slot
// at m_pad 64-640 (NVIDIA H100 80GB HBM3, 700 W), a 500-slot sweep's
// rate, where one one-slot launch per slot took 3.6-12.2 us.
//
// What bounds it on this card.  A slot evaluates the band's
// (DC+1)(D+1) - DC(DC+1)/2 candidates, an add and a min each, on values
// that stay on chip, so operations bound it: the FP64 (or FP32)
// instruction rate of the SMs that run the sweep.  Tensor cores cannot
// help, since min-plus has no multiply.  The slots form a sequential
// chain, so what is left is the per-slot cost of handing the carry from
// one slot to the next across the SMs: a cluster barrier, with the fence
// that publishes the carry, and a read of the neighbours' carry (the
// halo), T times.
//
// The design, and what it does about each:
// * One cluster of C blocks (C in {1, 2, 4, 8, 16}, kernel.py::sweep_plan;
//   16, beyond the portable size, only where the card can place it) on C
//   SMs.  Block r owns the columns [r w, (r+1) w) and keeps its slice of
//   cost_{t-1} and cost_t (ping-pong) in its shared memory.
// * At each slot a block copies the halo it needs, cost_{t-1}[r w - JP ..
//   r w) (+inf left of 0; JP = DC+1 rounded up to K), out of the lower
//   ranks' slices through DSMEM in 16-byte loads, and its own slice, into
//   one local window, once: the j loop reads only local memory.
// * One cluster barrier per slot publishes slot t's slices before any
//   block copies its halo for slot t+1.  With the slices ping-ponged it
//   also orders every read of a slice before the write that reuses it two
//   slots later; the barrier after the last slot is the one every block
//   passes before it exits, so no block's shared memory goes away while a
//   neighbour may still read it.  A release by every thread would cost a
//   cluster-scope fence each (several times the relaxed barrier itself,
//   measured on the card), so the block's writes are gathered by
//   __syncthreads, one thread fences
//   them, every thread arrives relaxed and waits with acquire; the slot's
//   global stores go out between the arrive and the wait, where no fence
//   waits for them.
// * Register tiling: a thread owns K = 4 consecutive columns and walks j in
//   steps of K with a 2K-value sliding window of the carry in registers:
//   per K*K candidates, K broadcast loads of the row and K new carry
//   loads.  The window is stored as K planes (value x at plane x mod K,
//   position x / K), so the K loads of a warp hit consecutive addresses.
// * Where a block has too few column groups to fill its warps, the j range
//   is split over S thread groups too; their (value, j) partials are
//   merged in increasing j, a lower j winning a tie.
// * A slot's row comes in with cp.async (one 4- or 8-byte copy per
//   value: rows + t (DC+1) is not 16-byte aligned for odd DC+1), issued
//   before the halo copy so that the two overlap.  A second row buffer,
//   filled during the previous slot, measured no faster at any 10x bucket
//   (PERF.md), and the widest float64 band has no room for it, so there
//   is one.
//
// Exactness: each candidate is one IEEE add of two inputs (no multiply,
// so nothing can contract into an FMA).  With the split, each thread takes
// the strict '<' in increasing j and the merge keeps the lower j on a tie.
// Cost only, a thread takes the min (FMNMX in f32; in f64 a compare and a
// select, which run faster than DMNMX): min and the first-index select
// differ only on a tie of +0 and -0, and no candidate is -0, since the
// carry holds no -0 and a sum is -0 only when both addends are.  The
// identity carry starts at +0; a carry-in that the tiled route passes is
// always a DP column of this recurrence started from the identity (the
// previous tile's last column), so by the same argument it holds no -0
// either, and each new column inherits that.  So
// cost and split equal the plain PyTorch version (kernels/minplus/ref.py)
// bit for bit in f32 and f64, for rows without NaN.  Candidates with
// j > d read the window's +inf left pad and those with j > DC the row's
// +inf right pad: x + inf is never below anything, so evaluating them
// changes nothing.
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
// consecutive columns a thread owns (kernel.py::SWEEP_K); 8 measured
// slower on every 10x bucket and on the wide jobs' bands
constexpr int K = 4;
// columns a thread merges: with the j range split over S >= 2 groups a
// block has w / K * S >= w / 2 threads, so w <= kMergeCols * threads
constexpr int kMergeCols = 2;

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

template <typename T>
__device__ __forceinline__ void copy_row_async(T* dst, const T* src, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const unsigned addr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + j));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(addr),
                 "l"(src + j), "n"(sizeof(T)));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16 bytes of values: the unit of the halo copy
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

// The cluster barrier of a slot, in two halves (see the note at the top):
// the block's writes gathered by __syncthreads and fenced to cluster scope
// by one thread, a relaxed arrive; then a wait that acquires the other
// blocks' writes.
__device__ __forceinline__ void cluster_arrive() {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T min_of(T a, T b);
template <>
__device__ __forceinline__ float min_of<float>(float a, float b) {
  return fminf(a, b);
}
// in float64 a compare and a select run faster than DMNMX (measured on
// the card)
template <>
__device__ __forceinline__ double min_of<double>(double a, double b) {
  return b < a ? b : a;
}

// Shared memory of a block, in values of T (then int32 split partials):
//   slice[2][w]      its columns of cost_{t-1} / cost_t (ping-pong)
//   win[jpad + w]    halo + own carry, K planes of (jpad + w) / K
//   row[jpad]
//   part[S][K][w/K]  per-j-group partial minima (S > 1 only)
//   part_arg[S][K][w/K]  their first argmins (S > 1 and split only)
template <typename T, bool kSplit>
__global__ void __launch_bounds__(kMaxThreads, 1)
minplus_sweep_kernel(const T* __restrict__ rows, const T* __restrict__ carry,
                     T* __restrict__ cost, int32_t* __restrict__ split,
                     int n_slots, int dc1, int d1, int w, int jpad,
                     int n_jgroups, int64_t rows_ls, int64_t carry_ls,
                     int64_t cost_ls) {
  cg::cluster_group cluster = cg::this_cluster();
  // this cluster's lane (the split is one lane's: rows_ls == cost_ls == 0)
  const int64_t lane = blockIdx.y;
  rows += lane * rows_ls;
  if (carry != nullptr) carry += lane * carry_ls;
  cost += lane * cost_ls;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slice = reinterpret_cast<T*>(smem_raw);
  T* win = slice + 2 * w;
  T* row_buf = win + jpad + w;
  T* part = row_buf + jpad;
  int32_t* part_arg = reinterpret_cast<int32_t*>(part + n_jgroups * w);
  const int plane = (jpad + w) / K;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int col0 = static_cast<int>(cluster.block_rank()) * w;
  const T inf = pos_inf<T>();

  // this thread's columns [col0 + c0, col0 + c0 + K) and j range
  // [jlo, jhi): group s of n_jgroups over the block's j extent
  const int groups = w / K;
  const int g = tid % groups;
  const int c0 = g * K;
  const int s = tid / groups;
  const int j_block = min(jpad, col0 + w);
  const int j_step = ((j_block + n_jgroups - 1) / n_jgroups + K - 1) / K * K;
  const int jlo = s * j_step;
  const int jhi = min(min(jlo + j_step, j_block), col0 + c0 + K);

  // cost_{-1}: the carry-in, or the identity; +inf past D (never read by
  // a column below D+1)
  for (int c = tid; c < w; c += nthreads) {
    const int col = col0 + c;
    if (carry != nullptr)
      slice[c] = col < d1 ? carry[col] : inf;
    else
      slice[c] = col == 0 ? T(0) : inf;
  }
  for (int j = dc1 + tid; j < jpad; j += nthreads) row_buf[j] = inf;
  cluster.sync();  // every block's slice of the carry is in place

  for (int t = 0; t < n_slots; ++t) {
    const T* prev = slice + (t & 1) * w;
    T* next = slice + ((t + 1) & 1) * w;
    // row t, over the buffer slot t-1 read, whose reads ended before the
    // last barrier
    const T* row = row_buf;
    copy_row_async(row_buf, rows + static_cast<int64_t>(t) * dc1, dc1);

    // window value x is cost_{t-1}[col0 - jpad + x]: the halo from the
    // lower ranks' slices, then this block's own, through DSMEM in
    // 16-byte loads (jpad, w and col0 are multiples of K >= 4 values, so
    // a load never straddles two slices)
    using V = typename Vec16<T>::type;
    constexpr int kV = Vec16<T>::n;
    for (int x = tid * kV; x < jpad + w; x += nthreads * kV) {
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
      for (int e = 0; e < kV; ++e)
        win[((x + e) % K) * plane + (x + e) / K] = v[e];
    }
    cp_async_wait_all();
    __syncthreads();  // window and row t are in place

    // candidate (k, j) reads window value jpad + c0 + k - j.  For the
    // chunk j in [jb, jb + K), with base = jpad + c0 - jb (a multiple of
    // K), hi[i] = win(base + i) and lo[i] = win(base - K + i).
    T best[K];
    int32_t arg[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      best[k] = inf;
      arg[k] = 0;
    }
    if (jlo < jhi) {
      int pos = (jpad + c0 - jlo) / K;
      T hi[K], lo[K];
#pragma unroll
      for (int i = 0; i < K; ++i) hi[i] = win[i * plane + pos];
      for (int jb = jlo; jb < jhi; jb += K) {
        --pos;
        T r[K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
          lo[i] = win[i * plane + pos];
          r[i] = row[jb + i];
        }
#pragma unroll
        for (int jj = 0; jj < K; ++jj) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const T cand = r[jj] + (k >= jj ? hi[k - jj] : lo[K + k - jj]);
            if constexpr (kSplit) {
              if (cand < best[k]) {
                best[k] = cand;
                arg[k] = jb + jj;
              }
            } else {
              best[k] = min_of(best[k], cand);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < K; ++i) hi[i] = lo[i];
      }
    }

    // this slot's values go to the block's next slice, are published by
    // the barrier's arrive, and only then stored to cost (and split), so
    // that no fence waits for global stores
    T* cost_t = cost + static_cast<int64_t>(t) * d1;
    int32_t* split_t = kSplit ? split + static_cast<int64_t>(t) * d1 : nullptr;
    if (n_jgroups == 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) next[c0 + k] = best[k];
      cluster_arrive();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (col0 + c0 + k < d1) {
          cost_t[col0 + c0 + k] = best[k];
          if constexpr (kSplit) split_t[col0 + c0 + k] = arg[k];
        }
      }
    } else {
      // partials as K planes of the column groups, so that a warp's
      // stores and the merge's loads hit consecutive addresses
#pragma unroll
      for (int k = 0; k < K; ++k) {
        part[(s * K + k) * groups + g] = best[k];
        if constexpr (kSplit) part_arg[(s * K + k) * groups + g] = arg[k];
      }
      __syncthreads();
      // merge in increasing j group: strict '<' keeps the lower j on a
      // tie; a thread merges the columns c = tid + i * nthreads
      T b[kMergeCols];
      int32_t a[kMergeCols];
#pragma unroll
      for (int i = 0; i < kMergeCols; ++i) {
        const int c = tid + i * nthreads;
        if (c >= w) break;
        const int at = (c % K) * groups + c / K;
        b[i] = part[at];
        a[i] = kSplit ? part_arg[at] : 0;
#pragma unroll 4
        for (int q = 1; q < n_jgroups; ++q) {
          const T v = part[q * w + at];
          if (v < b[i]) {
            b[i] = v;
            if constexpr (kSplit) a[i] = part_arg[q * w + at];
          }
        }
        next[c] = b[i];
      }
      cluster_arrive();
#pragma unroll
      for (int i = 0; i < kMergeCols; ++i) {
        const int c = tid + i * nthreads;
        if (c >= w) break;
        if (col0 + c < d1) {
          cost_t[col0 + c] = b[i];
          if constexpr (kSplit) split_t[col0 + c] = a[i];
        }
      }
    }
    // every read of window, rows, partials and of the slices of slot t-1
    // (here and in the neighbours) is done, and slot t's slices are in
    // place; after the last slot, no block's shared memory is read again
    cluster_wait();
  }
}

template <typename T>
size_t smem_bytes(int w, int jpad, int n_jgroups, bool split) {
  const size_t part = n_jgroups > 1 ? static_cast<size_t>(n_jgroups) * w : 0;
  return sizeof(T) * (3 * static_cast<size_t>(w) +
                      2 * static_cast<size_t>(jpad) + part) +
         (split ? sizeof(int32_t) * part : 0);
}

// The kernel's attributes, set once per (device, shared memory, cluster,
// block size) on its first launch, not on every launch of a decision:
// the largest dynamic shared memory the card allows a block (one value
// for every plan, so no later setting can undercut an earlier plan) and,
// beyond the portable cluster size, the non-portable size allowed and
// the card checked to place one such cluster.
template <typename T, bool kSplit>
cudaError_t prepare(const cudaLaunchConfig_t& cfg, int cluster) {
  auto kern = minplus_sweep_kernel<T, kSplit>;
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

template <typename T, bool kSplit>
int launch_split(const void* rows, const void* carry, void* cost, void* split,
                 int n_slots, int dc1, int d1, int cluster, int w, int jpad,
                 int n_jgroups, int n_lanes, int64_t rows_ls,
                 int64_t carry_ls, int64_t cost_ls, void* stream) {
  auto kern = minplus_sweep_kernel<T, kSplit>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_lanes, 1);
  cfg.blockDim = dim3((w / K) * n_jgroups, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<T>(w, jpad, n_jgroups, kSplit);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = prepare<T, kSplit>(cfg, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(rows),
                           static_cast<const T*>(carry), static_cast<T*>(cost),
                           static_cast<int32_t*>(split), n_slots, dc1, d1, w,
                           jpad, n_jgroups, rows_ls, carry_ls, cost_ls);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* rows, const void* carry, void* cost, void* split,
           int n_slots, int dc1, int d1, int cluster, int w, int jpad,
           int n_jgroups, int n_lanes, int64_t rows_ls, int64_t carry_ls,
           int64_t cost_ls, void* stream) {
  // the plan's invariants (kernel.py::sweep_plan); anything else is
  // refused, as is a split of more than one lane
  if (cluster < 1 || cluster > kMaxCluster || w < K || w % K != 0 ||
      jpad < dc1 || jpad % K != 0 ||
      static_cast<int64_t>(cluster) * w < d1 || n_jgroups < 1 ||
      (w / K) * n_jgroups > kMaxThreads || n_lanes < 1 || n_lanes > 65535 ||
      (split != nullptr && n_lanes != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (split != nullptr)
    return launch_split<T, true>(rows, carry, cost, split, n_slots, dc1, d1,
                                 cluster, w, jpad, n_jgroups, 1, 0, 0, 0,
                                 stream);
  return launch_split<T, false>(rows, carry, cost, split, n_slots, dc1, d1,
                                cluster, w, jpad, n_jgroups, n_lanes, rows_ls,
                                carry_ls, cost_ls, stream);
}

}  // namespace

extern "C" {

// For each of n_lanes lanes: rows (n_slots, dc1) and cost (n_slots, d1)
// row-major on the device (cost may be rows of a larger table); carry
// (d1,) the column entering slot 0, or NULL for the identity
// [0, inf, ...]; lane l's tensors start rows_ls, carry_ls and cost_ls
// values after lane l-1's.  split (n_slots, d1) int32, one lane only, or
// NULL for cost only; the launch plan (kernel.py::sweep_plan): cluster
// size, columns per block w, padded band jpad, j groups.  Enqueued on
// `stream`; returns the cudaError_t of the launch (0 = launched).
int minplus_sweep_f32(const void* rows, const void* carry, void* cost,
                      void* split, int n_slots, int dc1, int d1, int cluster,
                      int w, int jpad, int n_jgroups, int n_lanes,
                      long long rows_ls, long long carry_ls, long long cost_ls,
                      void* stream) {
  return launch<float>(rows, carry, cost, split, n_slots, dc1, d1, cluster, w,
                       jpad, n_jgroups, n_lanes, rows_ls, carry_ls, cost_ls,
                       stream);
}

int minplus_sweep_f64(const void* rows, const void* carry, void* cost,
                      void* split, int n_slots, int dc1, int d1, int cluster,
                      int w, int jpad, int n_jgroups, int n_lanes,
                      long long rows_ls, long long carry_ls, long long cost_ls,
                      void* stream) {
  return launch<double>(rows, carry, cost, split, n_slots, dc1, d1, cluster, w,
                        jpad, n_jgroups, n_lanes, rows_ls, carry_ls, cost_ls,
                        stream);
}

const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
