// Mamba2 SSD chunk scan for Hopper (sm_90a): the chunks of a row run in
// parallel, one block each, and the four chunk products run on the
// tensor cores.
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
// What bounds it on this card: Zamba2-7B's prefill scan (b 4, L 2048,
// 112 heads, P = N = 64) moves ~485 MB and, at this kernel's chunk of 64
// steps, needs ~23 G operations, so once the products run on the tensor
// cores (TF32 taken three times, below) it is bound by bytes, with
// operations a little below.  The design (PERF.md's SSD finding has the
// measurements behind each choice, tools/ssd_variant_probe.py the
// variants they come from):
//
// * The scan is the same function at any chunk length, so the kernel
//   takes its own, Q steps with Q <= 64 (kernel.py::ssd_plan cuts the
//   model's 128 to 64): the causal part of the work shrinks with Q, and
//   a chunk's x, B and C (~53 KB in float32 at Zamba2-7B's widths) let
//   four blocks share an SM.
// * One block of 4 warps per (row, chunk).  The chunks of a row are
//   independent except for the state handed from one to the next, so
//   each block computes its chunk's own state S_c (the state update from
//   a zero state) and decay exp(a_cum_last), and one thread-block cluster
//   of up to 8 blocks (the portable size) runs that many chunks of a row
//   together.  A row of more chunks is walked in segments: block r of the
//   cluster takes chunk seg * C + r.
// * The state before each chunk comes from distributed shared memory.
//   Block r scans one slice of the (P, N) elements (as float4 where N % 4
//   == 0) across the segment's chunks in order, reading each chunk's S_c
//   where its block left it and writing the state before that chunk back
//   in its place: every S_c is read once and every state written once,
//   by the block that owns the slice, with all of a thread's remote loads
//   issued before its chain.  The carry between segments is that slice of
//   the final state, which block r keeps in `fin` (only it reads and
//   writes that slice); an initial state enters as the first segment's.
// * The products run as mma.sync m16n8k8 TF32 with float32 sums, the
//   operands loaded from shared memory into registers in any layout.
//   wgmma would need both TF32 operands K-major in shared memory, so x
//   or B staged again transposed and every B operand split ahead of
//   time; for the two state-sized products that staging was measured to
//   cost more than wgmma saves.  The tensor cores read a TF32 operand as
//   the top 19 bits of a float32 (they truncate), so a float32 operand a
//   is taken as hi = a and lo = a - trunc(a), and each product as
//   a_lo b_hi + a_hi b_lo + a_hi b_hi: about float32's accuracy (2^-20
//   relative per operand), where one TF32 pass keeps ~3 decimal digits.
//   bfloat16 inputs are widened to float32 as they are staged; they are
//   exact in TF32, so a pass that would multiply an input's lo part (0)
//   is skipped: C B^T takes one pass, scores x and the state update two,
//   C state^T three.
// * Warp t owns the chunk's 16-row tile t and walks it as flash attention
//   walks a query tile: per 16-column block of j <= i, the scores C B^T
//   in registers, masked (exp of -inf above the diagonal, never exp
//   first) and scaled, then at once the A operand of scores x: the
//   accumulator's column pair (2k, 2k+1) of a thread is the A fragment's
//   column pair (k, k+4) once the k axis of both operands is permuted
//   alike, so no shuffle is needed.  Every inner loop has a fixed trip
//   count and independent accumulators (the hi and lo passes of the long
//   sums go to separate ones), and a thread keeps to 128 registers, so
//   16 warps share an SM.  Every shared array has a row stride of 4 mod 8
//   floats, which leaves every fragment load free of bank conflicts.
// * The state update, split over the warps in 16 x 32 tiles, writes S_c
//   over C, whose products are done by then; C is staged again over B
//   for C . state^T while the cluster scans.  y_intra is stored to y
//   before the scan and y_inter added to it after: the same thread stores
//   and adds each element.  Float32 inputs with rows of a multiple of 4
//   values are staged by cp.async (zero-filled past the row's end);
//   bfloat16 ones are widened through registers.
//
// A ragged last chunk is zero-padded in shared memory (dt = x = B = C =
// 0), which is what padding L to a chunk multiple does: padded steps
// leave the state unchanged and their y is not written.  Q, P and N are
// padded the same way to the tiles' multiples: 16, 64 (the columns of y
// a pass keeps) and 32.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>
#include <set>
#include <tuple>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxQ = 16 * kWarps;    // a warp per 16-row tile
constexpr int kMinBlocks = 16 / kWarps;  // 16 warps an SM: <= 128 registers
constexpr int kNT = 8;               // 8-column tiles of y and P per pass
constexpr int kMaxCluster = 8;  // the portable cluster size

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v = hi + lo for the TF32 tensor cores, which read the top 19 bits of
// an operand (they truncate): hi is v itself, so it counts as v truncated,
// and lo = v - trunc(v) exactly, itself read truncated: |error| <=
// 2^-20 |v|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v);
  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a bfloat16 input is exact in TF32: its lo parts are 0
template <typename T>
constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;

// d += a b in three passes, small terms first; kExactA / kExactB: that
// operand is a bfloat16 input, exact in TF32, whose lo pass adds zeros
// and is skipped
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (!kExactA) mma(d, al, bh);
  if constexpr (!kExactB) mma(d, ah, bl);
  mma(d, ah, bh);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// dst[i * stride + k] = src[i * step + k] for i < rows, k < width, and 0
// up to rows_p x width_p; by cp.async where `vec` (float rows of a
// multiple of 4 values, 16-byte aligned), else widened through registers.
// A thread walks its elements (i, k) by steps of kThreads, carrying k
// over the row's end: one division a call.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride, int rows_p,
                                      int width_p, const T* src, size_t step,
                                      int rows, int width, bool vec) {
  bool quads = false;
  if constexpr (std::is_same<T, float>::value) quads = vec;
  const int w = quads ? width_p / 4 : width_p;  // units of a row
  const int di = kThreads / w, dk = kThreads - di * w;
  int i = threadIdx.x / w;
  int k = threadIdx.x - i * w;
  for (; i < rows_p; i += di, k += dk) {
    if (k >= w) {
      k -= w;
      ++i;
      if (i >= rows_p) break;
    }
    if constexpr (std::is_same<T, float>::value) {
      if (quads) {
        const bool ok = i < rows && 4 * k < width;
        cp_async16(dst + i * stride + 4 * k, ok ? src + i * step + 4 * k : src,
                   ok);
        continue;
      }
    }
    dst[i * stride + k] =
        i < rows && k < width ? to_float(src[i * step + k]) : 0.0f;
  }
}

// The scan of one segment over a block's slice of the state, for a
// cluster of kC blocks of which n_act hold a chunk: for each element (or
// group of 4, as float4, V = float4), the carry st goes in as the state
// before chunk 0, and each chunk k's S_c, read where its block left it,
// is replaced by the state before it; st leaves as the state after the
// segment.  Every remote load is issued before the chain.
template <int kC, typename V>
__device__ __forceinline__ void scan_slice(cg::cluster_group& cluster,
                                           float* s_c, const float* s_decay,
                                           int n_act, int lo, int hi, int N,
                                           int sN, int seg, float* fin_row,
                                           const float* init_row) {
  constexpr int kW = sizeof(V) / sizeof(float);
  float decay[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k)
    decay[k] = *cluster.map_shared_rank(s_decay, min(k, n_act - 1));
  for (int gi = lo + threadIdx.x; gi < hi; gi += kThreads) {
    const int e = kW * gi;
    const int p = e / N;
    const int off = p * sN + (e - p * N);
    V st;
    if (seg > 0) {
      st = *reinterpret_cast<const V*>(fin_row + e);
    } else if (init_row != nullptr) {
      st = *reinterpret_cast<const V*>(init_row + e);
    } else {
      float* z = reinterpret_cast<float*>(&st);
#pragma unroll
      for (int c = 0; c < kW; ++c) z[c] = 0.0f;
    }
    V sc[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k)
      sc[k] = *reinterpret_cast<const V*>(
          cluster.map_shared_rank(s_c, min(k, n_act - 1)) + off);
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      if (k >= n_act) break;
      *reinterpret_cast<V*>(cluster.map_shared_rank(s_c, k) + off) = st;
      float* a = reinterpret_cast<float*>(&st);
      const float* b = reinterpret_cast<const float*>(&sc[k]);
#pragma unroll
      for (int c = 0; c < kW; ++c) a[c] = a[c] * decay[k] + b[c];
    }
    *reinterpret_cast<V*>(fin_row + e) = st;
  }
}

template <int kC>
__device__ __forceinline__ void scan(cg::cluster_group& cluster, float* s_c,
                                     const float* s_decay, int n_act, int PN,
                                     int N, int sN, int seg, float* fin_row,
                                     const float* init_row, bool vec4) {
  const int rank = static_cast<int>(cluster.block_rank());
  const int units = vec4 ? PN / 4 : PN;
  const int per = (units + kC - 1) / kC;
  const int lo = rank * per, hi = min(units, lo + per);
  if (vec4)
    scan_slice<kC, float4>(cluster, s_c, s_decay, n_act, lo, hi, N, sN, seg,
                           fin_row, init_row);
  else
    scan_slice<kC, float>(cluster, s_c, s_decay, n_act, lo, hi, N, sN, seg,
                          fin_row, init_row);
}

// Store (kAdd: add to) a warp's 16 x 8 kNT accumulator tile at rows
// i0.., columns p0.. of the chunk's y, masking rows >= q and columns >= P;
// the old values are all loaded before the first store.
template <bool kAdd>
__device__ __forceinline__ void put_y(const float (&acc)[kNT][4], float* y,
                                      size_t row_step, int i0, int p0, int q,
                                      int P) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float* rows[2] = {y + (i0 + g) * row_step, y + (i0 + g + 8) * row_step};
  const bool ok[2] = {i0 + g < q, i0 + g + 8 < q};
  float old[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 8 * nt + 2 * t4 + (e & 1);
      old[nt][e] = kAdd && ok[e >> 1] && p < P ? rows[e >> 1][p] : 0.0f;
    }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 8 * nt + 2 * t4 + (e & 1);
      if (ok[e >> 1] && p < P) rows[e >> 1][p] = old[nt][e] + acc[nt][e];
    }
}

// dh += a_hi b_hi, dl += the lo passes (as in mma3): two accumulators,
// so a long sum is two short dependency chains
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma2(float (&dh)[4], float (&dl)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (!kExactA) mma(dl, al, bh);
  if constexpr (!kExactB) mma(dl, ah, bl);
  mma(dh, ah, bh);
}

__device__ __forceinline__ void zero(float (&d)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
}

// x (b, L, H, P), B/C (b, L, G, N) of type T; dt (b, L, H), A (H,),
// init (b, H, P, N) or nullptr; y (b, L, H, P), fin (b, H, P, N) float32.
// Grid: one cluster of `C` blocks per (batch, head) row; block r of a
// cluster takes chunk seg * C + r of each segment.  vec: x, B, C staged
// by cp.async; vec4: the scan moves
// the state 4 elements at a time (N % 4 == 0, fin and init aligned).
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_mma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bg,
               const T* __restrict__ Cg, const float* __restrict__ init,
               float* __restrict__ y, float* __restrict__ fin, int L, int H,
               int P, int G, int N, int Q, int n_chunks, int segments,
               int vec, int vec4) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / csize;  // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const int grp = h / (H / G);
  const float a_h = A[h];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const int Pp = round_up(P, 8 * kNT), Np = round_up(N, 32);
  const int Qp = round_up(Q, 16);
  const int sX = Pp + 4, sN = Np + 4;  // row strides, 4 mod 8
  float* s_x = smem;                   // (Qp, sX) x
  float* s_b = s_x + Qp * sX;          // (Qp, sN) B, then C again
  float* s_c = s_b + Qp * sN;          // (max(Qp, Pp), sN) C, then state
  float* s_dt = s_c + (Qp > Pp ? Qp : Pp) * sN;  // (Qp,)
  float* s_cum = s_dt + Qp;            // (Qp,) a_cum
  float* s_w = s_cum + Qp;             // (Qp,) exp(last - a_cum) dt
  float* s_e = s_w + Qp;               // (Qp,) exp(a_cum)
  float* s_misc = s_e + Qp;            // [0, kWarps) warp sums, then decay
  float* s_decay = s_misc + kWarps;

  const int PN = P * N;
  const size_t pn = static_cast<size_t>(PN);
  float* fin_row = fin + row * pn;
  const float* init_row = init != nullptr ? init + row * pn : nullptr;
  const size_t x_step = static_cast<size_t>(H) * P;
  const size_t bc_step = static_cast<size_t>(G) * N;

  for (int seg = 0; seg < segments; ++seg) {
    const int c = seg * csize + rank;
    const bool active = c < n_chunks;
    const int l0 = c * Q;
    const int q = active ? min(Q, L - l0) : 0;
    const int q_tiles = (q + 15) / 16;
    const bool has_tile = warp < q_tiles;  // warp t owns rows 16 t..
    const int i0 = 16 * warp;
    const int ia = i0 + g, ib = ia + 8;
    float* y_chunk = y + ((static_cast<size_t>(b) * L + l0) * H + h) * P;
    const size_t bc0 = (static_cast<size_t>(b) * L + l0) * G + grp;

    if (active) {
      stage<T>(s_x, sX, Qp, Pp, x + ((static_cast<size_t>(b) * L + l0) * H +
                                     h) * P, x_step, q, P, vec != 0);
      stage<T>(s_b, sN, Qp, Np, Bg + bc0 * N, bc_step, q, N, vec != 0);
      stage<T>(s_c, sN, Qp, Np, Cg + bc0 * N, bc_step, q, N, vec != 0);
      cp_async_commit();
      for (int i = tid; i < Qp; i += kThreads)
        s_dt[i] = i < q ? dt[(static_cast<size_t>(b) * L + l0 + i) * H + h]
                        : 0.0f;
      __syncthreads();
      // in-chunk cumsum of the log decay: a warp scan, then warp totals
      float v = tid < Qp ? s_dt[tid] * a_h : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v = v + up;
      }
      if (lane == 31) s_misc[warp] = v;
      __syncthreads();
      for (int w = 0; w < warp; ++w) v = v + s_misc[w];
      if (tid < Qp) s_cum[tid] = v;
      __syncthreads();
      const float last = s_cum[Qp - 1];
      for (int i = tid; i < Qp; i += kThreads) {
        s_w[i] = expf(last - s_cum[i]) * s_dt[i];
        s_e[i] = expf(s_cum[i]);
      }
      if (tid == 0) *s_decay = expf(last);
      cp_async_wait();
      __syncthreads();

      // y_intra of the warp's row tile, columns pg..: per 16-column block
      // jb of j <= i the scores C B^T, then scores x into acc
      auto intra = [&](float (&acc)[kNT][4], int pg) {
        const float ca = s_cum[ia], cb = s_cum[ib];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) zero(acc[nt]);
        for (int jb = 0; jb <= warp; ++jb) {
          float sh[2][4], sl[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            zero(sh[u]);
            zero(sl[u]);
          }
#pragma unroll 2
          for (int k0 = 0; k0 < Np; k0 += 8) {
            uint32_t ah[4], al[4];
            const float* cr = s_c + ia * sN + k0 + t4;
            split(cr[0], ah[0], al[0]);
            split(cr[8 * sN], ah[1], al[1]);
            split(cr[4], ah[2], al[2]);
            split(cr[8 * sN + 4], ah[3], al[3]);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              uint32_t bh[2], bl[2];
              const float* br = s_b + (16 * jb + 8 * u + g) * sN + k0 + t4;
              split(br[0], bh[0], bl[0]);
              split(br[4], bh[1], bl[1]);
              mma2<kExact<T>, kExact<T>>(sh[u], sl[u], ah, al, bh, bl);
            }
          }
          // scores (C_i . B_j) exp(a_cum_i - a_cum_j) dt_j, masked to
          // j <= i before the exp; then scores x, the k axis permuted: the
          // accumulator's columns (2 t4, 2 t4 + 1) are the A fragment's
          // (t4, t4 + 4)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = 16 * jb + 8 * u + 2 * t4;
            const float c0 = s_cum[j], c1 = s_cum[j + 1];
            const float d0 = s_dt[j], d1 = s_dt[j + 1];
            const float s0 = (sh[u][0] + sl[u][0]) *
                             (__expf(j <= ia ? ca - c0 : -INFINITY) * d0);
            const float s1 = (sh[u][1] + sl[u][1]) *
                             (__expf(j + 1 <= ia ? ca - c1 : -INFINITY) * d1);
            const float s2 = (sh[u][2] + sl[u][2]) *
                             (__expf(j <= ib ? cb - c0 : -INFINITY) * d0);
            const float s3 = (sh[u][3] + sl[u][3]) *
                             (__expf(j + 1 <= ib ? cb - c1 : -INFINITY) * d1);
            uint32_t ah[4], al[4];
            split(s0, ah[0], al[0]);
            split(s2, ah[1], al[1]);
            split(s1, ah[2], al[2]);
            split(s3, ah[3], al[3]);
            const float* xr = s_x + j * sX + pg + g;
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              uint32_t bh[2], bl[2];
              split(xr[8 * nt], bh[0], bl[0]);
              split(xr[8 * nt + sX], bh[1], bl[1]);
              mma3<false, kExact<T>>(acc[nt], ah, al, bh, bl);
            }
          }
        }
      };
      if (has_tile) {
        float acc[kNT][4];
        for (int pg = 0; pg < Pp; pg += 8 * kNT) {
          intra(acc, pg);
          put_y<false>(acc, y_chunk, x_step, i0, pg, q, P);
        }
      }
      __syncthreads();  // C's products are done: S_c goes over it

      // S_c[p][n] = sum_j x_j[p] w_j B_j[n]: (P x Q) (Q x N), the j axis
      // permuted as above, in 16 x 32 output tiles over the warps
      {
        const int ngroups = Np / 32;
        const int jmax = round_up(q, 8);  // later rows are zero
        for (int item = warp; item < (Pp / 16) * ngroups; item += kWarps) {
          const int p0 = 16 * (item / ngroups);
          const int n0 = 32 * (item % ngroups);
          float dh[4][4], dl[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            zero(dh[nt]);
            zero(dl[nt]);
          }
#pragma unroll 2
          for (int j0 = 0; j0 < jmax; j0 += 8) {
            const int ja = j0 + 2 * t4;
            const float wa = s_w[ja], wb = s_w[ja + 1];
            const float* xr = s_x + ja * sX + p0 + g;
            uint32_t ah[4], al[4];
            split(xr[0] * wa, ah[0], al[0]);
            split(xr[8] * wa, ah[1], al[1]);
            split(xr[sX] * wb, ah[2], al[2]);
            split(xr[sX + 8] * wb, ah[3], al[3]);
            const float* br = s_b + ja * sN + n0 + g;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              uint32_t bh[2], bl[2];
              split(br[8 * nt], bh[0], bl[0]);
              split(br[8 * nt + sN], bh[1], bl[1]);
              mma2<false, kExact<T>>(dh[nt], dl[nt], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float* sr = s_c + (p0 + g) * sN + n0 + 8 * nt + 2 * t4;
            sr[0] = dh[nt][0] + dl[nt][0];
            sr[1] = dh[nt][1] + dl[nt][1];
            sr[8 * sN] = dh[nt][2] + dl[nt][2];
            sr[8 * sN + 1] = dh[nt][3] + dl[nt][3];
          }
        }
      }
      __syncthreads();  // x and B are done: C comes back over B
      stage<T>(s_b, sN, Qp, Np, Cg + bc0 * N, bc_step, q, N, vec != 0);
      cp_async_commit();
    }

    // the state before each chunk of the segment: this block's slice of
    // the elements, scanned over the segment's chunks in order
    cluster.sync();
    {
      const int n_act = min(csize, n_chunks - seg * csize);
      const bool v4 = vec4 != 0;
      switch (csize) {
        case 1:
          scan<1>(cluster, s_c, s_decay, n_act, PN, N, sN, seg, fin_row,
                  init_row, v4);
          break;
        case 2:
          scan<2>(cluster, s_c, s_decay, n_act, PN, N, sN, seg, fin_row,
                  init_row, v4);
          break;
        case 4:
          scan<4>(cluster, s_c, s_decay, n_act, PN, N, sN, seg, fin_row,
                  init_row, v4);
          break;
        default:
          scan<kMaxCluster>(cluster, s_c, s_decay, n_act, PN, N, sN, seg,
                            fin_row, init_row, v4);
      }
    }
    cluster.sync();  // every state is in place; no block reads another's

    if (active) {
      cp_async_wait();
      __syncthreads();
      // y_inter: y_i += exp(a_cum_i) C_i . state^T over the same tile and
      // lanes as y_intra, so each thread adds to what it stored
      if (has_tile) {
        const float ea = s_e[ia], eb = s_e[ib];
        for (int pg = 0; pg < Pp; pg += 8 * kNT) {
          float acc[kNT][4];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) zero(acc[nt]);
#pragma unroll 2
          for (int k0 = 0; k0 < Np; k0 += 8) {
            uint32_t ah[4], al[4];
            const float* cr = s_b + ia * sN + k0 + t4;
            split(cr[0] * ea, ah[0], al[0]);
            split(cr[8 * sN] * eb, ah[1], al[1]);
            split(cr[4] * ea, ah[2], al[2]);
            split(cr[8 * sN + 4] * eb, ah[3], al[3]);
            const float* sr = s_c + (pg + g) * sN + k0 + t4;
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              uint32_t bh[2], bl[2];
              split(sr[8 * nt * sN], bh[0], bl[0]);
              split(sr[8 * nt * sN + 4], bh[1], bl[1]);
              mma3<false, false>(acc[nt], ah, al, bh, bl);
            }
          }
          put_y<true>(acc, y_chunk, x_step, i0, pg, q, P);
        }
      }
      __syncthreads();  // the next segment restages every array
    }
  }
}

// Dynamic shared memory of one block, in floats (kernel.py::ssd_smem_bytes)
inline int smem_floats(int P, int N, int Q) {
  const int Pp = round_up(P, 8 * kNT), Np = round_up(N, 32);
  const int Qp = round_up(Q, 16);
  return Qp * (Pp + 4) + Qp * (Np + 4) + (Qp > Pp ? Qp : Pp) * (Np + 4) +
         4 * Qp + 2 * kWarps;
}

template <typename T>
cudaError_t prepare(const cudaLaunchConfig_t& cfg, int cluster) {
  auto kern = ssd_mma_kernel<T>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::set<std::tuple<int, size_t, int>> ready;
  const auto key = std::make_tuple(device, cfg.dynamicSmemBytes, cluster);
  std::lock_guard<std::mutex> lock(mu);
  if (ready.count(key) != 0) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (cfg.dynamicSmemBytes > static_cast<size_t>(optin))
    return cudaErrorInvalidValue;
  // one value for every plan, so no later setting undercuts an earlier one
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  ready.insert(key);
  return cudaSuccess;
}

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int rows, int cluster,
                          int smem, void* stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* init, void* y, void* fin, int rows,
           int L, int H, int P, int G, int N, int Q, int cluster, int smem,
           void* stream) {
  // the plan's invariants (kernel.py::ssd_plan); anything else is refused
  if (rows < 1 || L < 1 || H < 1 || P < 1 || G < 1 || N < 1 || H % G != 0 ||
      Q < 1 || Q > kMaxQ || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 ||
      smem != 4 * smem_floats(P, N, Q) ||
      static_cast<int64_t>(rows) * cluster > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (L + Q - 1) / Q;
  const int segments = (n_chunks + cluster - 1) / cluster;
  const int vec = std::is_same<T, float>::value && P % 4 == 0 &&
                  N % 4 == 0 && aligned16(x) && aligned16(B) &&
                  aligned16(C);
  const int vec4 = N % 4 == 0 && aligned16(fin) &&
                   (init == nullptr || aligned16(init));
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(attr, rows, cluster, smem, stream);
  cudaError_t err = prepare<T>(cfg, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(
      &cfg, ssd_mma_kernel<T>, static_cast<const T*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(init), static_cast<float*>(y),
      static_cast<float*>(fin), L, H, P, G, N, Q, n_chunks, segments, vec,
      vec4);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Contiguous device buffers: x (b, L, H, P) and B, C (b, L, G, N) in the
// function's type; dt (b, L, H), A (H,), init (b, H, P, N) or NULL,
// y (b, L, H, P) and fin (b, H, P, N) in float32.  rows = b * H; cluster
// and smem (bytes) as kernel.py::ssd_plan gives them.  Enqueued on
// `stream`; returns the cudaError_t of the launch (0 = launched).
int ssd_mma_f32(const void* x, const void* dt, const void* A, const void* B,
                const void* C, const void* init, void* y, void* fin, int rows,
                int L, int H, int P, int G, int N, int Q, int cluster,
                int smem, void* stream) {
  return launch<float>(x, dt, A, B, C, init, y, fin, rows, L, H, P, G, N, Q,
                       cluster, smem, stream);
}

int ssd_mma_bf16(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* init, void* y, void* fin,
                 int rows, int L, int H, int P, int G, int N, int Q,
                 int cluster, int smem, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, init, y, fin, rows, L, H, P,
                               G, N, Q, cluster, smem, stream);
}

const char* ssd_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
