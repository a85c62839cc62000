// Flash attention (backward) on Hopper (sm_90a), float32 on the CUDA
// cores, for float32 and bfloat16 inputs: GQA, causal mask, sliding
// window, tanh logit soft-cap, non-causal with Sq != Sk, ragged edges.
//
// Replaces no TPU kernel: the JAX package has no backward kernel.  Its
// training differentiates jnp code with jax.value_and_grad
// (src/repro/train/steps.py:152), and above 256 x 256 scores the
// attention it differentiates is src/repro/models/attention.py::
// _sdpa_chunked, the jnp form of the flash recurrence whose forward the
// port runs as flash_attention_mma.cu / flash_attention_wgmma.cu.  Those
// forward kernels write into a buffer torch.empty_like allocated, which
// has no autograd graph; this kernel is the backward of the
// torch.autograd.Function (kernel.py::FlashAttention) that wraps them.
//
// The function, for query row i of head h (KV head h / (H / KV)) and
// key j, with s the forward's scores (scaled by 1 / sqrt(D), then
// soft-capped s = cap tanh(x / cap) when cap > 0) and masked exactly as
// the forward masks them (j >= Sk, causal i < j, window i - j >= window):
//
//     lse_i   = log sum_j exp(s_ij)               over the visible keys
//     delta_i = sum_d dO_id O_id
//     p_ij    = exp(s_ij - lse_i)                 (0 where masked)
//     dV_j   += sum_i p_ij dO_i                   (over the G query heads)
//     dp_ij   = dO_i . v_j
//     ds_ij   = p_ij (dp_ij - delta_i) (1 - tanh^2(x_ij / cap) if capped)
//     dQ_i    = scale sum_j ds_ij k_j;   dK_j = scale sum_i ds_ij q_i
//
// For float32 inputs delta reads O, the forward kernel's output as the
// autograd function saved it; for bfloat16 inputs the prep recomputes O
// in float32 (the wgmma forward's O is rounded to bfloat16, and ds
// cancels delta against dp: see bwd_prep_own_o_kernel).  Everything else
// is recomputed here in float32 from q, k, v and dO.  A row that sees no
// key (only possible with a window shorter than Sq - Sk) gets lse = +inf
// and zero gradients.
//
// Three kernels, one launch each, on the caller's stream:
//
// - prep: one block per (batch * head, block of BQ query rows) walks the
//   key tiles its rows can see.  float32: it keeps, per row and thread, a
//   running (max, sum) of exp over its columns, combined over the 16
//   threads of a row at the end (lse), and sums dO O (delta).  bfloat16:
//   the forward's online softmax and P V in float32, then lse and
//   rowsum(dO O32).  Both go to float32 scratch (B, H, Sq).  Keeping this
//   pass apart leaves the two measured forward sources untouched; having
//   the forward write lse (and a float32 delta) is a later speed change.
// - dkdv: one block per (batch, KV head, block of BK keys) holds its K
//   and V tiles and its dK, dV accumulators (registers) and walks the G
//   query heads of its group and the query blocks that can see its keys,
//   recomputing S = Q K^T and dP = dO V^T for each; every dK and dV row
//   is written once by one block: no atomics, a deterministic result.
// - dq: one block per (batch * head, block of BQ query rows) holds Q, dO,
//   lse, delta and its dQ accumulator and walks the key tiles its rows
//   can see, recomputing S and dP.
//
// What bounds it on this card: at StarCoder2-3B's training shape (B 2,
// S 2048, 24 heads over 2 KV heads, D 128, causal) the visible pairs
// need 8 products of 2 B H (S^2 / 2) D operations (one in prep, two for
// bfloat16 inputs, four in dkdv, three in dq): ~206 G operations (232 G
// for bfloat16) on ~100 MB, so operations bound
// it.  This first design takes them on the CUDA cores in float32 (67
// TFLOP/s at most; 3.1 ms at that peak, ~0.21 ms at bf16's 989 on the
// tensor cores): 256 threads a block as 16 x 16, each computing a
// (BQ / 16) x (BK / 16) micro-tile of a score tile (rows ty + 16 i,
// columns tx + 16 j) and a (BK / 16) x (D / 16) micro-tile of the dK, dV
// or dQ accumulators from shared tiles.  Shared rows are D + 1 floats
// apart, so the 16 rows a half-warp reads at one column fall on 16
// distinct banks (D + 1 is odd); the other half-warp reads the same
// words (a broadcast).  BQ = BK = 64 up to D = 128 and 32 at D = 256,
// which keeps the dkdv block's tiles (K, V, Q, dO, P, dS) under the 227
// KB a block may use.  wgmma and TMA are a later PR's work.
//
// All kernels build with -fmad=false (kernels/build.py): every multiply
// and add rounds on its own.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

// launch statuses beyond cudaError_t's range
constexpr int kErrHeadDim = 10001;
constexpr int kErrSmem = 10002;
constexpr int kErrAlign = 10003;
constexpr int kErrGrid = 10004;

constexpr int kThreads = 256;  // 16 x 16: tx = threadIdx.x % 16, ty = / 16

template <int D>
struct Tile {
  static constexpr int BQ = D <= 128 ? 64 : 32;  // query rows a tile
  static constexpr int BK = BQ;                  // keys a tile
  static constexpr int LD = D + 1;               // shared row stride
  static constexpr int LS = BK + 1;              // P and dS row stride
  static constexpr int TM = BQ / 16;             // micro-tile rows
  static constexpr int TN = BK / 16;             // micro-tile columns
  static constexpr int TD = D / 16;              // accumulator columns
  // floats of shared memory of each kernel
  static constexpr int kPrep = (BQ + BK) * LD;
  static constexpr int kPrepOwnO = (BQ + 2 * BK) * LD + BQ * LS;
  static constexpr int kDkdv = (2 * BK + 2 * BQ) * LD + 2 * BQ * LS + 2 * BQ;
  static constexpr int kDq = (2 * BQ + 2 * BK) * LD + BQ * LS + 2 * BQ;
  static_assert(D % 16 == 0, "head dim a multiple of 16");
  static_assert(4 * kDkdv <= 227 * 1024 && 4 * kDq <= 227 * 1024 &&
                    4 * kPrepOwnO <= 227 * 1024,
                "a block's tiles must fit 227 KB");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// Rows row0 .. row0 + ROWS - 1 of head h of a (B, S, NH, D) tensor into
// a shared (ROWS, D + 1) float tile; rows past S are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int row0, int S, int NH, int h) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int s = row0 + r;
    float x = 0.0f;
    if (s < S)
      x = to_f(src[((static_cast<int64_t>(b) * S + s) * NH + h) * D + c]);
    dst[r * LD + c] = x;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] Bm[tx + 16 j][d] over shared tiles of
// row stride D + 1.
template <int D, int TM, int TN>
__device__ __forceinline__ void tile_dot(float (&acc)[TM][TN],
                                         const float* A, const float* Bm,
                                         int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[TM], bb[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < TN; ++j) bb[j] = Bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * bb[j];
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Sk,
                                        int causal, int window) {
  return qi < Sq && kj < Sk && (!causal || qi >= kj) &&
         (window <= 0 || qi - kj < window);
}

// The forward's score from a raw dot product x: scaled, then soft-capped;
// t = tanh(x scale / cap) for the cap's derivative (0 without a cap).
__device__ __forceinline__ float score(float x, float scale, float cap,
                                       float* t) {
  float s = x * scale;
  *t = 0.0f;
  if (cap > 0.0f) {
    *t = tanhf(s / cap);
    s = cap * *t;
  }
  return s;
}

// Key tiles [kb_lo, kb_hi) that rows q0 .. q0 + BQ - 1 can see.
template <int BQ, int BK>
__device__ __forceinline__ void key_range(int q0, int Sq, int Sk, int causal,
                                          int window, int* lo, int* hi) {
  *lo = 0;
  *hi = (Sk + BK - 1) / BK;
  if (causal) *hi = min(*hi, (min(q0 + BQ, Sq) - 1) / BK + 1);
  if (window > 0) *lo = max(0, q0 - window + 1) / BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ o, const T* __restrict__ dO,
                    float* __restrict__ lse, float* __restrict__ delta,
                    int Sq, int Sk, int H, int KV, float scale, int causal,
                    int window, float cap) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, TM = Tl::TM, TN = Tl::TN;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * Tl::LD;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / (H / KV);
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // delta: row ty + 16 i, this thread's columns tx + 16 c
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + ty + 16 * i;
    float part = 0.0f;
    if (qi < Sq) {
      const int64_t base = ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D;
      for (int c = tx; c < D; c += 16)
        part += to_f(dO[base + c]) * to_f(o[base + c]);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0 && qi < Sq) delta[static_cast<int64_t>(bh) * Sq + qi] = part;
  }

  load_tile<T, D, BQ>(Qs, q, b, q0, Sq, H, h);
  int kb_lo, kb_hi;
  key_range<BQ, BK>(q0, Sq, Sk, causal, window, &kb_lo, &kb_hi);
  float m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    __syncthreads();  // the previous K tile is read
    load_tile<T, D, BK>(Ks, k, b, kb * BK, Sk, KV, kvh);
    __syncthreads();
    float acc[TM][TN];
    tile_dot<D, TM, TN>(acc, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kj = kb * BK + tx + 16 * j;
        if (!visible(qi, kj, Sq, Sk, causal, window)) continue;
        float t;
        const float s = score(acc[i][j], scale, cap, &t);
        if (s > m[i]) {
          l[i] = l[i] * expf(m[i] - s) + 1.0f;
          m[i] = s;
        } else {
          l[i] += expf(s - m[i]);
        }
      }
    }
  }
  // combine the 16 threads of each row
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mx = m[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = m[i] == -INFINITY ? 0.0f : l[i] * expf(m[i] - mx);
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int qi = q0 + ty + 16 * i;
    if (tx == 0 && qi < Sq)
      lse[static_cast<int64_t>(bh) * Sq + qi] =
          sum > 0.0f ? mx + logf(sum) : INFINITY;
  }
}

// The bfloat16 inputs' prep: O recomputed in float32 (the forward's
// online softmax over the same key tiles, P V on the CUDA cores), then
// lse = m + log l and delta = rowsum(dO O32).  The wgmma forward's O is
// rounded to bfloat16 (8 bits) after P was rounded too, and
// ds = p (dp - delta) cancels delta against dp: with that O, dQ on a
// StarCoder2-3B layer's real activations missed the plain gradient by
// 2.7e-2 of its norm.  Recomputed, delta is the float32 plain version's.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_prep_own_o_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dO,
                          float* __restrict__ lse, float* __restrict__ delta,
                          int Sq, int Sk, int H, int KV, float scale,
                          int causal, int window, float cap) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, LD = Tl::LD, LS = Tl::LS;
  constexpr int TM = Tl::TM, TN = Tl::TN, TD = Tl::TD;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / (H / KV);
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, D, BQ>(Qs, q, b, q0, Sq, H, h);
  int kb_lo, kb_hi;
  key_range<BQ, BK>(q0, Sq, Sk, causal, window, &kb_lo, &kb_hi);
  // m, l: each row's running max and sum, the same in the 16 threads of
  // the row; acc: this thread's columns tx + 16 c of its rows' O
  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.0f;
  }
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tiles are read
    load_tile<T, D, BK>(Ks, k, b, k0, Sk, KV, kvh);
    load_tile<T, D, BK>(Vs, v, b, k0, Sk, KV, kvh);
    __syncthreads();
    float s_acc[TM][TN];
    tile_dot<D, TM, TN>(s_acc, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float t;
        const float sc = score(s_acc[i][j], scale, cap, &t);
        const bool vis = visible(q0 + r, k0 + tx + 16 * j, Sq, Sk, causal,
                                 window);
        s_acc[i][j] = vis ? sc : -INFINITY;
        mx = fmaxf(mx, s_acc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha =
          m_new == -INFINITY ? 1.0f : expf(m[i] - m_new);  // exp(-inf) = 0
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = s_acc[i][j] == -INFINITY ? 0.0f
                                                 : expf(s_acc[i][j] - m_new);
        Ps[r * LS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    // acc[r][d] += sum_kk P[r][kk] V[kk][d]
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float pr[TM], vr[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) pr[i] = Ps[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int c = 0; c < TD; ++c) vr[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[i][c] += pr[i] * vr[c];
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + ty + 16 * i;
    float part = 0.0f;
    if (qi < Sq && l[i] > 0.0f) {
      const int64_t base = ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
      for (int c = 0; c < TD; ++c)
        part += to_f(dO[base + tx + 16 * c]) * (acc[i][c] / l[i]);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0 && qi < Sq) {
      delta[static_cast<int64_t>(bh) * Sq + qi] = part;
      lse[static_cast<int64_t>(bh) * Sq + qi] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

// P and dS of one (query tile, key tile) pair into shared Ps, dSs from
// the shared Q, dO, K, V tiles and the rows' lse and delta.
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* Ls, const float* Dl, float* Ps, float* dSs, int q0, int k0,
    int Sq, int Sk, float scale, int causal, int window, float cap, int ty,
    int tx) {
  using Tl = Tile<D>;
  constexpr int TM = Tl::TM, TN = Tl::TN, LS = Tl::LS;
  float s_acc[TM][TN], dp[TM][TN];
  tile_dot<D, TM, TN>(s_acc, Qs, Ks, ty, tx);
  tile_dot<D, TM, TN>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + 16 * j;
      float p = 0.0f, ds = 0.0f;
      if (visible(q0 + r, k0 + c, Sq, Sk, causal, window)) {
        float t;
        const float s = score(s_acc[i][j], scale, cap, &t);
        p = expf(s - Ls[r]);
        ds = p * (dp[i][j] - Dl[r]);
        if (cap > 0.0f) ds *= 1.0f - t * t;
      }
      if (Ps) Ps[r * LS + c] = p;
      dSs[r * LS + c] = ds;
    }
  }
}

template <int BQ>
__device__ __forceinline__ void load_rows(float* Ls, float* Dl,
                                          const float* lse,
                                          const float* delta, int64_t base,
                                          int q0, int Sq) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int qi = q0 + r;
    Ls[r] = qi < Sq ? lse[base + qi] : INFINITY;
    Dl[r] = qi < Sq ? delta[base + qi] : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                    float scale, int causal, int window, float cap) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, LD = Tl::LD, LS = Tl::LS;
  constexpr int TN = Tl::TN, TD = Tl::TD;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LS;
  float* Ls = dSs + BQ * LS;
  float* Dl = Ls + BQ;
  const int bkv = blockIdx.x;
  const int b = bkv / KV, kvh = bkv - b * KV, G = H / KV;
  const int k0 = blockIdx.y * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, D, BK>(Ks, k, b, k0, Sk, KV, kvh);
  load_tile<T, D, BK>(Vs, v, b, k0, Sk, KV, kvh);

  float dk_acc[TN][TD], dv_acc[TN][TD];
#pragma unroll
  for (int a = 0; a < TN; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;

  const int nqb = (Sq + BQ - 1) / BQ;
  const int qb_lo = causal ? min(nqb, k0 / BQ) : 0;
  const int qb_hi =
      window > 0 ? min(nqb, (k0 + BK - 1 + window - 1) / BQ + 1) : nqb;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t rows = (static_cast<int64_t>(b) * H + h) * Sq;
    for (int qb = qb_lo; qb < qb_hi; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the previous tiles are read
      load_tile<T, D, BQ>(Qs, q, b, q0, Sq, H, h);
      load_tile<T, D, BQ>(dOs, dO, b, q0, Sq, H, h);
      load_rows<BQ>(Ls, Dl, lse, delta, rows, q0, Sq);
      __syncthreads();
      probs_and_dscores<D>(Qs, dOs, Ks, Vs, Ls, Dl, Ps, dSs, q0, k0, Sq, Sk,
                           scale, causal, window, cap, ty, tx);
      __syncthreads();
      // dV[kk][d] += sum_r P[r][kk] dO[r][d];  dK[kk][d] += sum_r dS q
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[TN], dsr[TN], dor[TD], qr[TD];
#pragma unroll
        for (int a = 0; a < TN; ++a) {
          pr[a] = Ps[r * LS + ty + 16 * a];
          dsr[a] = dSs[r * LS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          dor[c] = dOs[r * LD + tx + 16 * c];
          qr[c] = Qs[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < TN; ++a)
#pragma unroll
          for (int c = 0; c < TD; ++c) {
            dv_acc[a][c] += pr[a] * dor[c];
            dk_acc[a][c] += dsr[a] * qr[c];
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < TN; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= Sk) continue;
    const int64_t base = ((static_cast<int64_t>(b) * Sk + kj) * KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      store(dk + base + tx + 16 * c, dk_acc[a][c] * scale);
      store(dv + base + tx + 16 * c, dv_acc[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dO,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  int Sq, int Sk, int H, int KV, float scale, int causal,
                  int window, float cap) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, LD = Tl::LD, LS = Tl::LS;
  constexpr int TM = Tl::TM, TD = Tl::TD;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* Ls = dSs + BQ * LS;
  float* Dl = Ls + BQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / (H / KV);
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, D, BQ>(Qs, q, b, q0, Sq, H, h);
  load_tile<T, D, BQ>(dOs, dO, b, q0, Sq, H, h);
  load_rows<BQ>(Ls, Dl, lse, delta, static_cast<int64_t>(bh) * Sq, q0, Sq);

  float dq_acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TD; ++c) dq_acc[i][c] = 0.0f;

  int kb_lo, kb_hi;
  key_range<BQ, BK>(q0, Sq, Sk, causal, window, &kb_lo, &kb_hi);
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tiles are read
    load_tile<T, D, BK>(Ks, k, b, k0, Sk, KV, kvh);
    load_tile<T, D, BK>(Vs, v, b, k0, Sk, KV, kvh);
    __syncthreads();
    probs_and_dscores<D>(Qs, dOs, Ks, Vs, Ls, Dl, nullptr, dSs, q0, k0, Sq,
                         Sk, scale, causal, window, cap, ty, tx);
    __syncthreads();
    // dQ[r][d] += sum_kk dS[r][kk] K[kk][d]
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float dsr[TM], kr[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsr[i] = dSs[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int c = 0; c < TD; ++c) kr[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TD; ++c) dq_acc[i][c] += dsr[i] * kr[c];
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const int64_t base = ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < TD; ++c)
      store(dq + base + tx + 16 * c, dq_acc[i][c] * scale);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, void* dq, void* dk, void* dv, float* lse,
           float* delta, int B, int Sq, int Sk, int H, int KV, float scale,
           int causal, int window, float cap, int smem, void* stream) {
  using Tl = Tile<D>;
  if (smem != 4 * Tl::kDkdv) return kErrSmem;
  for (const void* p : {q, k, v, o, dO, static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    if (!aligned16(p)) return kErrAlign;
  const int nqb = (Sq + Tl::BQ - 1) / Tl::BQ;
  const int nkb = (Sk + Tl::BK - 1) / Tl::BK;
  if (nqb > 65535 || nkb > 65535 || static_cast<int64_t>(B) * H > 0x7fffffff)
    return kErrGrid;
  constexpr bool kOwnO = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kPrepBytes = 4 * (kOwnO ? Tl::kPrepOwnO : Tl::kPrep);
  static bool opted_in = false;  // one attribute set per instantiation
  if (!opted_in) {
    cudaError_t err =
        kOwnO ? opt_in(bwd_prep_own_o_kernel<T, D>, kPrepBytes)
              : opt_in(bwd_prep_kernel<T, D>, kPrepBytes);
    if (err == cudaSuccess)
      err = opt_in(bwd_dkdv_kernel<T, D>, 4 * Tl::kDkdv);
    if (err == cudaSuccess) err = opt_in(bwd_dq_kernel<T, D>, 4 * Tl::kDq);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot = static_cast<const T*>(dO);
  if constexpr (kOwnO)
    bwd_prep_own_o_kernel<T, D><<<dim3(B * H, nqb), kThreads, kPrepBytes,
                                  st>>>(qt, kt, vt, dot, lse, delta, Sq, Sk,
                                        H, KV, scale, causal, window, cap);
  else
    bwd_prep_kernel<T, D><<<dim3(B * H, nqb), kThreads, kPrepBytes, st>>>(
        qt, kt, ot, dot, lse, delta, Sq, Sk, H, KV, scale, causal, window,
        cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<T, D><<<dim3(B * KV, nkb), kThreads, 4 * Tl::kDkdv, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, KV, scale, causal, window, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<T, D><<<dim3(B * H, nqb), kThreads, 4 * Tl::kDq, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk, H, KV, scale,
      causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dO, void* dq, void* dk, void* dv, void* lse,
             void* delta, int B, int Sq, int Sk, int H, int KV, int D,
             float scale, int causal, int window, float cap, int smem,
             void* stream) {
#define FLASH_BWD_CASE(d)                                                    \
  case d:                                                                    \
    return launch<T, d>(q, k, v, o, dO, dq, dk, dv,                          \
                        static_cast<float*>(lse),                            \
                        static_cast<float*>(delta), B, Sq, Sk, H, KV, scale, \
                        causal, window, cap, smem, stream);
  switch (D) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(112)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default:
      return kErrHeadDim;
  }
#undef FLASH_BWD_CASE
}

}  // namespace

extern "C" {

// Contiguous device buffers of one type (float32 for _f32, bfloat16 for
// _bf16), 16-byte aligned: q, o, dO, dq (B, Sq, H, D); k, v, dk, dv
// (B, Sk, KV, D); lse and delta float32 scratch (B, H, Sq).  H % KV ==
// 0, D one of 16, 64, 112, 128, 256; smem (bytes) as kernel.py::
// bwd_plan gives it for the dkdv kernel (the launch is refused
// otherwise); scale = 1 / sqrt(D); window 0 = none; cap 0 = no soft-cap.
// Three launches on `stream`; returns 0 when all three launched, else a
// cudaError_t or one of the kErr codes (flash_bwd_error_string).
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dO, void* dq,
                            void* dk, void* dv, void* lse, void* delta,
                            int B, int Sq, int Sk, int H, int KV, int D,
                            float scale, int causal, int window, float cap,
                            int smem, void* stream) {
  return dispatch<float>(q, k, v, o, dO, dq, dk, dv, lse, delta, B, Sq, Sk,
                         H, KV, D, scale, causal, window, cap, smem, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dO, void* dq,
                             void* dk, void* dv, void* lse, void* delta,
                             int B, int Sq, int Sk, int H, int KV, int D,
                             float scale, int causal, int window, float cap,
                             int smem, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dO, dq, dk, dv, lse, delta, B,
                                 Sq, Sk, H, KV, D, scale, causal, window, cap,
                                 smem, stream);
}

const char* flash_bwd_error_string(int code) {
  switch (code) {
    case kErrHeadDim:
      return "head dim not built (16, 64, 112, 128, 256)";
    case kErrSmem:
      return "shared memory bytes differ from the kernel's layout";
    case kErrAlign:
      return "q, k, v, o, dO, dq, dk, dv must be 16-byte aligned";
    case kErrGrid:
      return "too many query or key blocks or batch heads for a grid";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
