// Flash attention (backward) in float32 on Hopper's tensor cores (sm_90a):
// GQA, causal mask, sliding window, tanh logit soft-cap, non-causal with
// Sq != Sk, ragged edges; every product as TF32 mma.sync taken in three
// passes, which keeps float32's accuracy; no atomics.  bfloat16 inputs go
// to flash_attention_bwd_wgmma.cu.
//
// Replaces no TPU kernel: the JAX package has no backward kernel.  Its
// training differentiates jnp code with jax.value_and_grad
// (src/repro/train/steps.py:152), and above 256 x 256 scores the
// attention it differentiates is src/repro/models/attention.py::
// _sdpa_chunked, the jnp form of the flash recurrence whose float32
// forward the port runs as flash_attention_mma.cu.  This is the float32
// backward of kernel.py::FlashAttention.  The function, for query row i
// of head h (KV head h / (H / KV)) and key j, with s the forward's scores
// (x = q . k scaled by 1 / sqrt(D), then soft-capped s = cap tanh(x /
// cap) when cap > 0) masked exactly as the forward masks them (j >= Sk,
// causal i < j, window i - j >= window):
//
//     lse_i   = log sum_j exp(s_ij)               over the visible keys
//     delta_i = sum_d dO_id O_id
//     p_ij    = exp(s_ij - lse_i)                 (0 where masked)
//     dV_j   += sum_i p_ij dO_i                   (over the G query heads)
//     dp_ij   = dO_i . v_j
//     ds_ij   = p_ij (dp_ij - delta_i) (1 - tanh^2(x_ij / cap) if capped)
//     dQ_i    = scale sum_j ds_ij k_j;   dK_j = scale sum_i ds_ij q_i
//
// delta reads O, the forward kernel's output as the autograd function
// saved it; everything else is recomputed here from q, k, v and dO.  A
// row that sees no key (only possible with a window shorter than Sq - Sk)
// gets lse = +inf and zero gradients.
//
// Three kernels, one launch each, on the caller's stream, 1-D grids:
//
// - prep: one block per (batch * head, BQ query rows) holds Q and walks
//   the key tiles its rows can see: S = Q K^T, and per thread a running
//   (max, sum) of exp(s) over its own columns, rescaled once a tile to
//   the tile's maxima and combined over the quad at the end (lse); each
//   warp sums dO O over its 16 rows (delta).  Both go to float32 scratch
//   (B H, Sq_pad), Sq_pad = Sq rounded up to BQ; rows past Sq get lse =
//   +inf and delta = 0, so the dkdv launch reads its tiles' rows without
//   a test.
// - dkdv: one block per (key tile of BKV, batch, KV head, head split)
//   holds K and V and walks the (query head, query tile) pairs of its
//   split whose rows can see its keys, Q, dO, lse and delta brought by
//   cp.async into a two-stage ring.  A warp owns 16 keys: S^T = K Q^T and
//   dP^T = V dO^T come out keys-as-rows, so P^T and dS^T are the register
//   A operands of dV += P^T dO and dK += dS^T Q, whose B operands dO and
//   Q are read across their rows.  As the forward reads V for P V, the
//   query axis of P^T and of dO, Q is permuted alike within each 8 rows:
//   the accumulator's column pair (2 t, 2 t + 1) is the A fragment's (t,
//   t + 4), and a thread reads the rows 2 t and 2 t + 1 of dO and Q.
//   GQA: at StarCoder2-3B's training shape (B 2, KV 2, S 2048, D 128) one
//   block per key tile is 64 blocks on 132 SMs, so a group's G query heads
//   are split over n_split blocks (kernel.py::bwd_split), each writing
//   float32 partials of dK and dV to scratch (2, n_split, B, Sk, KV, D);
//   the dq launch's last blocks sum them in split order.  With n_split = 1
//   the block writes dk and dv itself.
//   D = 256: dK and dV of 16 keys would be 256 floats a thread, so the
//   block's 8 warps are 4 key groups of 16 keys times 2 column halves;
//   the two warps of a key group both compute its S^T and dP^T over all
//   of D (1.5x the products at D = 256 only).
// - dq: one block per (batch * head, BQ query rows) holds Q, dO and its
//   rows' lse and delta in registers, and walks the visible key tiles (K,
//   V by cp.async into a two-stage ring): S and dP as in prep, dS as the
//   register A operand of dQ += dS K (K read across its rows, the key
//   axis permuted as above).  Blocks past the query blocks sum the dkdv
//   partials.
//
// The products.  All run as mma.sync m16n8k8 TF32 with float32 sums,
// each float32 operand a split as hi = a (the tensor cores read its top
// 19 bits, a truncation) and lo = a - trunc(a), each product as a_lo b_hi
// + a_hi b_lo + a_hi b_hi (about 2^-20 relative per operand, as in
// flash_attention_mma.cu).  Eight of them: S in prep, S^T, dP^T, dV and
// dK in dkdv, S, dP and dQ in dq; the function has five (the bound counts
// five).  The tensor cores round each sum they write toward zero, so a
// long chain drifts low where its terms are coherent: dK and dV of one
// key sum over G x Sq query rows (24,576 at StarCoder2-3B's shape), dQ
// over Sk keys.  Each output column tile's three passes over one whole
// streamed tile (32 query rows or keys up to D = 128, 16 at D = 256) go
// into a zeroed partial, added to the accumulator on the CUDA cores in
// round to nearest: one add per tile where the forward adds per 8 keys,
// as precise there (tests/test_torch_flash_bwd.py emulates the chains;
// tools/flash_bwd_probe.py times the per-step form).  The S and dP
// chains are D / 8 steps long and stay as they are.
//
// Shared rows are D + 4 floats apart (4 mod 16, D being a multiple of
// 16), so both reads of a tile are free of bank conflicts: along its rows
// (lanes g, t at row g, column t: banks 4 g + t or 20 g + t, all 32
// distinct) and across them (rows 2 t, 2 t + 1 at column g: bank 8 t + g).
// Every fragment is read and split where it is used; the held tiles are
// not kept split (two copies of Q and dO, or K and V, do not leave room
// for a ring beside them).  wgmma is not used: TF32 wgmma wants both
// operands K-major in shared memory, so P^T and dS^T would go through
// shared memory and every B operand would be split there ahead of time;
// for the SSD kernel that staging cost more than wgmma saved.
//
// What bounds it on this card: at StarCoder2-3B's training shape (B 2,
// S 2048, 24 heads over 2 KV heads, D 128, causal) the function's five
// products over the visible pairs are ~129 G operations on ~218 MB; as
// three TF32 passes ~387 G tensor-core operations, 0.78 ms at 495 TFLOP/s,
// above the bytes' 0.07 ms: operations bound it.  The eight products run
// here are ~619 G, 1.25 ms at that peak.  The 495 TFLOP/s are wgmma's:
// mma.sync alone, on register operands, reaches ~320 TFLOP/s in TF32 on
// an H100 (tools/flash_bwd_probe.py, its peak phase), so ~1.9 ms is this
// design's floor, and it runs at about half of that rate (PERF.md).  In
// all three kernels the heaviest causal blocks go first, key (or query)
// tiles wholly masked for the block are not loaded, a warp skips the
// tiles its own rows (keys) cannot see, and only tiles that cut the
// diagonal, the window's edge or Sk test each score.  Every dQ, dK and dV
// element is a sum in one fixed order: the same bits from run to run.
//
// The plan is fixed by D (Rows<D>, Cols<D> here; kernel.py::bwd_plan
// mirrors them and the launcher refuses other shared-memory counts).  All
// kernels build with -fmad=false (kernels/build.py).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// launch statuses beyond cudaError_t's range
constexpr int kErrHeadDim = 10001;
constexpr int kErrSmem = 10002;
constexpr int kErrAlign = 10003;
constexpr int kErrGrid = 10004;
constexpr int kErrSplit = 10005;

// each streamed tile's passes into one zeroed partial (false), or each 8
// rows' (true, the forward's form; tools/flash_bwd_probe.py times it)
constexpr bool kStepPartials = false;

// float4 groups a thread of the dq launch's summing blocks adds up
constexpr int kSumGroups = 8;

// prep and dq: kWarps warps of 16 query rows, K/V tiles of kBK keys in a
// ring of kStages; shared rows of D + 4 floats.  prep: Q, then the K
// ring; dq: Q, dO, then kStages x (K tile, V tile).
template <int D>
struct Rows {
  static constexpr int kWarps = D <= 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kBK = D <= 128 ? 32 : 16;
  static constexpr int kStages = 2;
  static constexpr int kS = D + 4;
  static constexpr int kTile = kBK * kS;
  static constexpr int kSmemPrep = 4 * kS * (kBQ + kStages * kBK);
  static constexpr int kSmemDq = 4 * kS * (2 * kBQ + 2 * kStages * kBK);
  static_assert(D % 16 == 0, "rows of a multiple of 16 floats");
  static_assert(kSmemDq <= 227 * 1024, "tile does not fit shared memory");
};

// dkdv: 8 warps, kGroups key groups of 16 keys times kDSplit column
// halves; K and V of kBKV keys, then kStages x (Q tile, dO tile) of kBQ
// rows, then kStages x (lse, delta) of kBQ floats.
template <int D>
struct Cols {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kGroups = D <= 128 ? 8 : 4;
  static constexpr int kDSplit = kWarps / kGroups;
  static constexpr int kBKV = 16 * kGroups;
  static constexpr int kBQ = D <= 128 ? 32 : 16;
  static constexpr int kStages = 2;
  static constexpr int kS = D + 4;
  static constexpr int kTile = kBQ * kS;
  static constexpr int kSmem =
      4 * (kS * (2 * kBKV + 2 * kStages * kBQ) + 2 * kStages * kBQ);
  static_assert(kSmem <= 227 * 1024, "tile does not fit shared memory");
  static_assert((D / 8) % kDSplit == 0, "column halves of 8-column tiles");
};

// v = hi + lo for the TF32 tensor cores, which read the top 19 bits of
// an operand: hi is v itself, so it counts as v truncated, and
// lo = v - trunc(v) exactly, itself read truncated: |error| <= 2^-20 |v|.
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

// d += a b in three passes, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
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

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// dst[i * (D + 4) + c] = src[i * step + c] for i < valid, 0 for
// valid <= i < rows, c < D; 16 bytes a thread per step
template <int D, int kThreads>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      size_t step, int valid, int rows) {
  constexpr int kQuads = D / 4;
  for (int c = threadIdx.x; c < rows * kQuads; c += kThreads) {
    const int i = c / kQuads;
    const int j = c - i * kQuads;
    const bool ok = i < valid;
    cp_async16(dst + i * (D + 4) + 4 * j, ok ? src + i * step + 4 * j : src,
               ok);
  }
}

// n floats (a multiple of 4) from src to dst, 16 bytes a thread per step
template <int kThreads>
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int n) {
  for (int c = threadIdx.x; c < n / 4; c += kThreads)
    cp_async16(dst + 4 * c, src + 4 * c, true);
}

// acc[nt] += X Y^T (and acc2[nt] += X2 Y2^T when kTwo) over D columns:
// 16 rows of X at xa = X + g (D + 4) + t against rows 8 nt + g of Y at
// yb = Y + g (D + 4) + t, both read along their rows; each step's X
// fragment read and split once for the kNT column tiles
template <int D, int kNT, bool kTwo>
__device__ __forceinline__ void product_rows(float (&acc)[kNT][4],
                                             const float* xa,
                                             const float* yb,
                                             float (&acc2)[kNT][4],
                                             const float* xa2,
                                             const float* yb2) {
  constexpr int kS = D + 4;
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 8) {
#pragma unroll
    for (int p = 0; p < (kTwo ? 2 : 1); ++p) {
      const float* x = (p ? xa2 : xa) + d0;
      const float* y = (p ? yb2 : yb) + d0;
      uint32_t ah[4], al[4];
      split(x[0], ah[0], al[0]);
      split(x[8 * kS], ah[1], al[1]);
      split(x[4], ah[2], al[2]);
      split(x[8 * kS + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bh[2], bl[2];
        split(y[8 * nt * kS], bh[0], bl[0]);
        split(y[8 * nt * kS + 4], bh[1], bl[1]);
        mma3(p ? acc2[nt] : acc[nt], ah, al, bh, bl);
      }
    }
  }
}

// The A fragments of a product whose k axis is an accumulator's columns
// permuted within each 8: column pair (2 t, 2 t + 1) of c[kk] as the A
// fragment's (t, t + 4), split
template <int kKK>
__device__ __forceinline__ void to_a(const float (&c)[kKK][4],
                                     uint32_t (&ah)[kKK][4],
                                     uint32_t (&al)[kKK][4]) {
#pragma unroll
  for (int kk = 0; kk < kKK; ++kk) {
    split(c[kk][0], ah[kk][0], al[kk][0]);
    split(c[kk][2], ah[kk][1], al[kk][1]);
    split(c[kk][1], ah[kk][2], al[kk][2]);
    split(c[kk][3], ah[kk][3], al[kk][3]);
  }
}

// out[dt] += A Z over a tile of kKK x 8 rows of Z, A from to_a, Z read
// across its rows: rows 8 kk + 2 t and 8 kk + 2 t + 1 at column 8 dt + g
// (zb = Z + 2 t (D + 4) + g + the first column); each column tile's
// passes over the whole tile into a zeroed partial, rounded into out once
template <int D, int kKK, int kDT>
__device__ __forceinline__ void product_cols(float (&out)[kDT][4],
                                             const uint32_t (&ah)[kKK][4],
                                             const uint32_t (&al)[kKK][4],
                                             const float* zb) {
  constexpr int kS = D + 4;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk) {
      const float* z = zb + 8 * kk * kS + 8 * dt;
      uint32_t bh[2], bl[2];
      split(z[0], bh[0], bl[0]);
      split(z[kS], bh[1], bl[1]);
      mma3(part, ah[kk], al[kk], bh, bl);
      if (kStepPartials) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          out[dt][e] += part[e];
          part[e] = 0.0f;
        }
      }
    }
    if (!kStepPartials) {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[dt][e] += part[e];
    }
  }
}

// The forward's score from a raw dot product x: scaled, then soft-capped;
// *t = tanh(x scale / cap) for the cap's derivative (0 without a cap).
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

__device__ __forceinline__ bool seen(int qi, int kj, int causal,
                                     int window) {
  return (!causal || qi >= kj) && (window <= 0 || qi - kj < window);
}

// Key tiles [kb_lo, kb_hi) of BK keys that rows q0 .. q_last can see
template <int BK>
__device__ __forceinline__ void key_range(int q0, int q_last, int Sk,
                                          int causal, int window, int* lo,
                                          int* hi) {
  *lo = 0;
  *hi = (Sk + BK - 1) / BK;
  if (causal) *hi = min(*hi, q_last / BK + 1);
  if (window > 0) *lo = max(0, q0 - window + 1) / BK;
}

// dk, dv (E elements each) from the dkdv launch's n_split float32
// partials (part: dK's n_split x E, then dV's), summed in split order, dK
// scaled; groups of 4 elements, kSumGroups a thread
template <int kThreads>
__device__ void sum_partials(const float* __restrict__ part,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int64_t E, int n_split, float scale,
                             int block) {
  const int64_t n4 = E / 4;
#pragma unroll 1
  for (int j = 0; j < kSumGroups; ++j) {
    const int64_t g =
        (static_cast<int64_t>(block) * kSumGroups + j) * kThreads +
        threadIdx.x;
    if (g >= 2 * n4) return;
    const int64_t which = g >= n4 ? 1 : 0;
    const int64_t e = (g - which * n4) * 4;
    const float* src = part + which * n_split * E + e;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int s = 1; s < n_split; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(src + s * E);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    if (!which) {
      acc.x *= scale;
      acc.y *= scale;
      acc.z *= scale;
      acc.w *= scale;
    }
    *reinterpret_cast<float4*>((which ? dv : dk) + e) = acc;
  }
}

// prep: blockIdx.x = (nqb - 1 - query block) * B H + b H + h, the
// heaviest causal blocks first.  lse and delta (B H, Sq_pad).
template <int D>
__global__ void __launch_bounds__(Rows<D>::kThreads, 2)
    bwd_prep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ o,
                    const float* __restrict__ dO, float* __restrict__ lse,
                    float* __restrict__ delta, int B, int Sq, int Sk, int H,
                    int KV, float scale, int causal, int window, float cap) {
  using R = Rows<D>;
  constexpr int kThreads = R::kThreads, BK = R::kBK, kS = R::kS;
  constexpr int kStages = R::kStages, kNT = BK / 8;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                  // (BQ, kS)
  float* s_ring = s_q + R::kBQ * kS;  // kStages K tiles

  const int BH = B * H;
  const int nqb = (Sq + R::kBQ - 1) / R::kBQ;
  const int sq_pad = nqb * R::kBQ;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh - b * H, kvh = h / (H / KV);
  const int q0 = (nqb - 1 - blockIdx.x / BH) * R::kBQ;
  const int q_last = min(q0 + R::kBQ, Sq) - 1;
  int kb_lo, kb_hi;
  key_range<BK>(q0, q_last, Sk, causal, window, &kb_lo, &kb_hi);
  const int n_tiles = max(0, kb_hi - kb_lo);

  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KV) * D;
  const size_t kv0 = (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  stage<D, kThreads>(s_q, q + ((static_cast<size_t>(b) * Sq + q0) * H + h) *
                              D,
                     q_step, min(R::kBQ, Sq - q0), R::kBQ);
  auto load_tile = [&](int t) {
    const int k0 = (kb_lo + t) * BK;
    stage<D, kThreads>(s_ring + (t % kStages) * R::kTile,
                       k + kv0 + static_cast<size_t>(k0) * kv_step, kv_step,
                       min(BK, Sk - k0), BK);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();  // group s; Q is in group 0
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 16 * warp;  // the warp's first row
  const int r_last = min(r0 + 15, Sq - 1);
  const int64_t rows = static_cast<int64_t>(bh) * sq_pad;

  // delta of the warp's 16 rows, summed over the warp in a fixed order
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int qi = r0 + r;
    float part = 0.0f;
    if (qi < Sq) {
      const size_t at = ((static_cast<size_t>(b) * Sq + qi) * H + h) * D;
      for (int c = lane; c < D; c += 32) part += dO[at + c] * o[at + c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) delta[rows + qi] = part;
  }

  // per thread, rows r0 + g and r0 + g + 8 over its own columns
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float* qa = s_q + (16 * warp + g) * kS + t4;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and Q) arrived
    __syncthreads();               // ... for every thread; tile t - 1 done
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const int k0 = (kb_lo + t) * BK;
    if (r0 >= Sq || (causal && k0 > r_last) ||
        (window > 0 && r0 - (k0 + BK - 1) >= window))
      continue;
    const float* s_k = s_ring + (t % kStages) * R::kTile;
    float sc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
    product_rows<D, kNT, false>(sc, qa, s_k + g * kS + t4, sc, nullptr,
                                nullptr);
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && r_last - k0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * nt + 2 * t4 + (e & 1);
        const int qi = r0 + g + ((e & 2) ? 8 : 0);
        float tc;
        float s = score(sc[nt][e], scale, cap, &tc);
        if (masked && (kj >= Sk || !seen(qi, kj, causal, window)))
          s = -INFINITY;
        sc[nt][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    // the running sums rescaled to the new maxima, then the tile's terms
    // (a row with no visible key yet keeps l = 0 and m = -inf)
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      base[r] = mx[r] == -INFINITY ? 0.0f : mx[r];
      l[r] *= expf(m[r] - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        l[e >> 1] += expf(sc[nt][e] - base[e >> 1]);
  }
  cp_async_wait<0>();  // no copy outlives the block

  // combine the quad's columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = m[r] == -INFINITY ? 0.0f : l[r] * expf(m[r] - mx);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qi = r0 + g + 8 * r;
    if (t4 == 0)
      lse[rows + qi] = qi < Sq && sum > 0.0f ? mx + logf(sum) : INFINITY;
  }
}

// dq: blockIdx.x as prep's for blockIdx.x < n_blocks; the blocks from
// n_blocks on sum the dkdv partials (n_split > 1).
template <int D>
__global__ void __launch_bounds__(Rows<D>::kThreads, 1)
    bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dO,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  const float* __restrict__ part, float* __restrict__ dk,
                  float* __restrict__ dv, int B, int Sq, int Sk, int H,
                  int KV, int n_split, int n_blocks, float scale, int causal,
                  int window, float cap) {
  using R = Rows<D>;
  constexpr int kThreads = R::kThreads, BK = R::kBK, kS = R::kS;
  constexpr int kStages = R::kStages, kNT = BK / 8, kDT = D / 8;
  if (static_cast<int>(blockIdx.x) >= n_blocks) {
    sum_partials<kThreads>(part, dk, dv, static_cast<int64_t>(B) * Sk * KV * D,
                           n_split, scale, blockIdx.x - n_blocks);
    return;
  }
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                   // (BQ, kS)
  float* s_do = s_q + R::kBQ * kS;     // (BQ, kS)
  float* s_ring = s_do + R::kBQ * kS;  // kStages x (K, V), each (BK, kS)

  const int BH = B * H;
  const int nqb = (Sq + R::kBQ - 1) / R::kBQ;
  const int sq_pad = nqb * R::kBQ;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh - b * H, kvh = h / (H / KV);
  const int q0 = (nqb - 1 - blockIdx.x / BH) * R::kBQ;
  const int q_last = min(q0 + R::kBQ, Sq) - 1;
  int kb_lo, kb_hi;
  key_range<BK>(q0, q_last, Sk, causal, window, &kb_lo, &kb_hi);
  const int n_tiles = max(0, kb_hi - kb_lo);

  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KV) * D;
  const size_t kv0 = (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const size_t at_q = ((static_cast<size_t>(b) * Sq + q0) * H + h) * D;
  const int q_valid = min(R::kBQ, Sq - q0);
  stage<D, kThreads>(s_q, q + at_q, q_step, q_valid, R::kBQ);
  stage<D, kThreads>(s_do, dO + at_q, q_step, q_valid, R::kBQ);
  auto load_tile = [&](int t) {
    const int k0 = (kb_lo + t) * BK;
    float* s_k = s_ring + (t % kStages) * 2 * R::kTile;
    const size_t at = kv0 + static_cast<size_t>(k0) * kv_step;
    const int valid = min(BK, Sk - k0);
    stage<D, kThreads>(s_k, k + at, kv_step, valid, BK);
    stage<D, kThreads>(s_k + R::kTile, v + at, kv_step, valid, BK);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();  // group s; Q and dO are in group 0
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 16 * warp;
  const int r_last = min(r0 + 15, Sq - 1);
  const int64_t rows = static_cast<int64_t>(bh) * sq_pad;
  // the thread's rows r0 + g and r0 + g + 8 (padded rows: +inf and 0)
  const float lr[2] = {lse[rows + r0 + g], lse[rows + r0 + g + 8]};
  const float dr[2] = {delta[rows + r0 + g], delta[rows + r0 + g + 8]};
  const float* qa = s_q + (16 * warp + g) * kS + t4;
  const float* da = s_do + (16 * warp + g) * kS + t4;

  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const int k0 = (kb_lo + t) * BK;
    if (r0 >= Sq || (causal && k0 > r_last) ||
        (window > 0 && r0 - (k0 + BK - 1) >= window))
      continue;
    const float* s_k = s_ring + (t % kStages) * 2 * R::kTile;
    const float* s_v = s_k + R::kTile;
    float sc[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.0f;
    product_rows<D, kNT, true>(sc, qa, s_k + g * kS + t4, dp, da,
                               s_v + g * kS + t4);
    // dS in place of S
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && r_last - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * nt + 2 * t4 + (e & 1);
        const int qi = r0 + g + ((e & 2) ? 8 : 0);
        float tc;
        const float s = score(sc[nt][e], scale, cap, &tc);
        float p = expf(s - lr[e >> 1]);
        if (masked && (kj >= Sk || !seen(qi, kj, causal, window))) p = 0.0f;
        float ds = p * (dp[nt][e] - dr[e >> 1]);
        if (cap > 0.0f) ds *= 1.0f - tc * tc;
        sc[nt][e] = ds;
      }
    uint32_t ah[kNT][4], al[kNT][4];
    to_a<kNT>(sc, ah, al);
    product_cols<D, kNT, kDT>(acc, ah, al, s_k + 2 * t4 * kS + g);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + g + 8 * r;
    if (qi >= Sq) continue;
    float* out =
        dq + ((static_cast<size_t>(b) * Sq + qi) * H + h) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<float2*>(out + 8 * dt) = make_float2(
          acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
  }
}

// dkdv: blockIdx.x = key tile * (B KV n_split) + (b KV + kvh) n_split +
// split, the first (heaviest causal) key tiles first.
template <int D>
__global__ void __launch_bounds__(Cols<D>::kThreads, 1)
    bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ part, int B,
                    int Sq, int Sk, int H, int KV, int n_split, float scale,
                    int causal, int window, float cap) {
  using C = Cols<D>;
  constexpr int kThreads = C::kThreads, BQ = C::kBQ, BKV = C::kBKV;
  constexpr int kS = C::kS, kStages = C::kStages, kNQ = BQ / 8;
  constexpr int kDT = D / 8 / C::kDSplit;  // 8-column tiles a warp owns
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;                  // (BKV, kS)
  float* s_v = s_k + BKV * kS;        // (BKV, kS)
  float* s_ring = s_v + BKV * kS;     // kStages x (Q, dO), each (BQ, kS)
  float* s_rows = s_ring + kStages * 2 * C::kTile;  // kStages x (lse, delta)

  const int per_tile = B * KV * n_split;
  const int k0 = (blockIdx.x / per_tile) * BKV;
  const int rest = blockIdx.x % per_tile;
  const int bkv = rest / n_split, sp = rest - bkv * n_split;
  const int b = bkv / KV, kvh = bkv - b * KV;
  const int G = H / KV, heads = G / n_split;
  const int h0 = kvh * G + sp * heads;
  const int rows_q = (Sq + Rows<D>::kBQ - 1) / Rows<D>::kBQ;
  const int sq_pad = rows_q * Rows<D>::kBQ;
  // the query tiles whose rows can see a key of this block
  const int nqb = (Sq + BQ - 1) / BQ;
  const int qb_lo = causal ? min(nqb, k0 / BQ) : 0;
  const int qb_hi =
      window > 0 ? min(nqb, (k0 + BKV - 1 + window - 1) / BQ + 1) : nqb;
  const int n_q = max(0, qb_hi - qb_lo);
  const int n_items = heads * n_q;

  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KV) * D;
  const size_t at_k =
      ((static_cast<size_t>(b) * Sk + k0) * KV + kvh) * D;
  const int k_valid = min(BKV, Sk - k0);
  stage<D, kThreads>(s_k, k + at_k, kv_step, k_valid, BKV);
  stage<D, kThreads>(s_v, v + at_k, kv_step, k_valid, BKV);
  auto load_item = [&](int it) {
    const int h = h0 + it / n_q;
    const int q0 = (qb_lo + it % n_q) * BQ;
    const int slot = it % kStages;
    float* s_q = s_ring + slot * 2 * C::kTile;
    const size_t at = ((static_cast<size_t>(b) * Sq + q0) * H + h) * D;
    const int valid = min(BQ, Sq - q0);
    stage<D, kThreads>(s_q, q + at, q_step, valid, BQ);
    stage<D, kThreads>(s_q + C::kTile, dO + at, q_step, valid, BQ);
    const int64_t rows = (static_cast<int64_t>(b) * H + h) * sq_pad + q0;
    float* s_l = s_rows + slot * 2 * BQ;
    stage_row<kThreads>(s_l, lse + rows, BQ);
    stage_row<kThreads>(s_l + BQ, delta + rows, BQ);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_items) load_item(s);
    cp_async_commit();  // group s; K and V are in group 0
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int grp = warp % C::kGroups, half = warp / C::kGroups;
  const int kw = k0 + 16 * grp;  // the warp's first key
  const float* ka = s_k + (16 * grp + g) * kS + t4;
  const float* va = s_v + (16 * grp + g) * kS + t4;
  const int col0 = 8 * kDT * half;  // the warp's first dK, dV column

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.0f;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_items) load_item(it + kStages - 1);
    cp_async_commit();
    const int q0 = (qb_lo + it % n_q) * BQ;
    // the tile's rows see none of the warp's keys
    if ((causal && kw > q0 + BQ - 1) ||
        (window > 0 && q0 - (kw + 15) >= window))
      continue;
    const int slot = it % kStages;
    const float* s_q = s_ring + slot * 2 * C::kTile;
    const float* s_do = s_q + C::kTile;
    const float* s_l = s_rows + slot * 2 * BQ;
    float st[kNQ][4], dpt[kNQ][4];
#pragma unroll
    for (int nt = 0; nt < kNQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.0f;
    product_rows<D, kNQ, true>(st, ka, s_q + g * kS + t4, dpt, va,
                               s_do + g * kS + t4);
    // P^T in place of S^T, dS^T in place of dP^T; keys past Sk are never
    // written and query rows past Sq have lse = +inf
    const bool masked = (causal && kw + 15 > q0) ||
                        (window > 0 && q0 + BQ - 1 - kw >= window);
#pragma unroll
    for (int nt = 0; nt < kNQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nt + 2 * t4 + (e & 1);
        const int kj = kw + g + ((e & 2) ? 8 : 0);
        float tc;
        const float s = score(st[nt][e], scale, cap, &tc);
        float p = expf(s - s_l[c]);
        if (masked && !seen(q0 + c, kj, causal, window)) p = 0.0f;
        float ds = p * (dpt[nt][e] - s_l[BQ + c]);
        if (cap > 0.0f) ds *= 1.0f - tc * tc;
        st[nt][e] = p;
        dpt[nt][e] = ds;
      }
    uint32_t ah[kNQ][4], al[kNQ][4];
    to_a<kNQ>(st, ah, al);
    product_cols<D, kNQ, kDT>(dv_acc, ah, al, s_do + 2 * t4 * kS + g + col0);
    to_a<kNQ>(dpt, ah, al);
    product_cols<D, kNQ, kDT>(dk_acc, ah, al, s_q + 2 * t4 * kS + g + col0);
  }
  cp_async_wait<0>();

  const int64_t E = static_cast<int64_t>(B) * Sk * KV * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kw + g + 8 * r;
    if (kj >= Sk) continue;
    const size_t at =
        ((static_cast<size_t>(b) * Sk + kj) * KV + kvh) * D + col0 + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const float2 kv2 = make_float2(dk_acc[dt][2 * r], dk_acc[dt][2 * r + 1]);
      const float2 vv2 = make_float2(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
      if (n_split == 1) {
        *reinterpret_cast<float2*>(dk + at + 8 * dt) =
            make_float2(kv2.x * scale, kv2.y * scale);
        *reinterpret_cast<float2*>(dv + at + 8 * dt) = vv2;
      } else {
        float* pk = part + sp * E + at + 8 * dt;
        *reinterpret_cast<float2*>(pk) = kv2;
        *reinterpret_cast<float2*>(pk + n_split * E) = vv2;
      }
    }
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

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, void* dq, void* dk, void* dv, float* lse,
           float* delta, float* part, int B, int Sq, int Sk, int H, int KV,
           int n_split, float scale, int causal, int window, float cap,
           int smem_prep, int smem_dq, int smem_kv, void* stream) {
  using R = Rows<D>;
  using C = Cols<D>;
  if (smem_prep != R::kSmemPrep || smem_dq != R::kSmemDq ||
      smem_kv != C::kSmem)
    return kErrSmem;
  if (n_split < 1 || (H / KV) % n_split || (n_split > 1 && part == nullptr))
    return kErrSplit;
  for (const void* p : {q, k, v, o, dO, static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv),
                        static_cast<const void*>(lse),
                        static_cast<const void*>(delta),
                        static_cast<const void*>(part)})
    if (!aligned16(p)) return kErrAlign;
  const int64_t n_rows =
      static_cast<int64_t>((Sq + R::kBQ - 1) / R::kBQ) * B * H;
  const int64_t n_keys = static_cast<int64_t>((Sk + C::kBKV - 1) / C::kBKV) *
                         B * KV * n_split;
  const int64_t E = static_cast<int64_t>(B) * Sk * KV * D;
  const int64_t per_block = static_cast<int64_t>(R::kThreads) * kSumGroups;
  const int64_t n_sum =
      n_split > 1 ? (E / 2 + per_block - 1) / per_block : 0;
  if (n_rows + n_sum > 0x7fffffff || n_keys > 0x7fffffff) return kErrGrid;
  static bool opted_in = false;  // one attribute set per instantiation
  if (!opted_in) {
    cudaError_t err = opt_in(bwd_prep_kernel<D>, R::kSmemPrep);
    if (err == cudaSuccess) err = opt_in(bwd_dq_kernel<D>, R::kSmemDq);
    if (err == cudaSuccess) err = opt_in(bwd_dkdv_kernel<D>, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dO);
  float* dkt = static_cast<float*>(dk);
  float* dvt = static_cast<float*>(dv);
  bwd_prep_kernel<D><<<static_cast<unsigned>(n_rows), R::kThreads,
                       R::kSmemPrep, st>>>(
      qt, kt, static_cast<const float*>(o), dot, lse, delta, B, Sq, Sk, H, KV,
      scale, causal, window, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<D><<<static_cast<unsigned>(n_keys), C::kThreads, C::kSmem,
                       st>>>(qt, kt, vt, dot, lse, delta, dkt, dvt, part, B,
                             Sq, Sk, H, KV, n_split, scale, causal, window,
                             cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<D><<<static_cast<unsigned>(n_rows + n_sum), R::kThreads,
                     R::kSmemDq, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), part, dkt, dvt, B,
      Sq, Sk, H, KV, n_split, static_cast<int>(n_rows), scale, causal, window,
      cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Contiguous float32 device buffers, 16-byte aligned: q, o, dO, dq
// (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D); lse and delta scratch
// (B H, Sq_pad), Sq_pad = Sq rounded up to the prep block's rows; part
// scratch (2, n_split, B, Sk, KV, D) when n_split > 1 (else null).
// H % KV == 0, (H / KV) % n_split == 0, D one of 16, 64, 112, 128, 256;
// smem_prep, smem_dq, smem_kv (bytes) as kernel.py::bwd_plan gives them,
// which must equal Rows<D>::kSmemPrep, Rows<D>::kSmemDq and Cols<D>::kSmem
// (the launch is refused otherwise); scale = 1 / sqrt(D); window 0 =
// none; cap 0 = no soft-cap.  Three launches on `stream`; returns 0 when
// all three launched, else a cudaError_t or one of the kErr codes
// (flash_bwd_error_string).
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dO, void* dq,
                            void* dk, void* dv, void* lse, void* delta,
                            void* part, int B, int Sq, int Sk, int H, int KV,
                            int D, int n_split, float scale, int causal,
                            int window, float cap, int smem_prep,
                            int smem_dq, int smem_kv, void* stream) {
#define FLASH_BWD_CASE(d)                                                    \
  case d:                                                                    \
    return launch<d>(q, k, v, o, dO, dq, dk, dv, static_cast<float*>(lse),   \
                     static_cast<float*>(delta), static_cast<float*>(part),  \
                     B, Sq, Sk, H, KV, n_split, scale, causal, window, cap,  \
                     smem_prep, smem_dq, smem_kv, stream);
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

const char* flash_bwd_error_string(int code) {
  switch (code) {
    case kErrHeadDim:
      return "head dim not built (16, 64, 112, 128, 256)";
    case kErrSmem:
      return "shared memory bytes differ from the kernels' layouts";
    case kErrAlign:
      return "q, k, v, o, dO, dq, dk, dv and the scratch must be 16-byte "
             "aligned";
    case kErrGrid:
      return "too many blocks for a grid";
    case kErrSplit:
      return "n_split must divide H / KV, with partial scratch when > 1";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
