// Flash attention (forward) in float32 on Hopper's tensor cores (sm_90a):
// GQA, causal mask, sliding window, tanh logit soft-cap; both products as
// TF32 mma.sync taken in three passes, which keeps float32's accuracy.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention (body _fa_kernel, pallas_call at :95) for float32
// inputs; bfloat16 inputs go to flash_attention_wgmma.cu.  The function
// is the same:
//
//     s     = (q . k) / sqrt(D),  soft-capped cap tanh(s / cap) if cap > 0
//     s     = -1e30 where kpos >= Sk, or causal and qpos < kpos, or
//             window > 0 and qpos - kpos >= window
//     m_new = max(m, rowmax s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//     l     = l alpha + rowsum p;  acc = acc alpha + p v;  m = m_new
//     out   = acc / max(l, 1e-30)
//
// with query head h reading KV head h / (H / KV), q (B, Sq, H, D) and
// k, v (B, Sk, KV, D) in the model's layout: nothing is transposed or
// padded around the launch.
//
// What bounds it on this card: at Zamba2-7B's prefill (B 4, S 2048, 32
// heads, D 112, causal) the visible (query, key) pairs need ~120 G
// operations on ~470 MB.  Taken as three TF32 passes (below) that is
// ~361 G tensor-core operations, 0.73 ms at 495 TFLOP/s, above the
// 0.14 ms of its bytes: operations bound it.  The design:
//
// - One block of kWarps warps per (batch * head, block of query rows),
//   the heaviest causal query blocks first (blockIdx.y counts down).
//   Each warp owns kM tiles of 16 query rows; S = Q K^T for one key
//   tile, the O accumulator and the row statistics (m, l) stay in its
//   registers.  Every warp reads the whole K and V tile from shared
//   memory as mma fragments and splits them, which is the kernel's
//   largest cost beside the products (PERF.md has the probe's numbers),
//   so up to D = 128 a warp owns two row tiles (kM = 2) and reads and
//   splits each fragment once for both, unless the grid of such blocks
//   would leave the card's SMs idle (short prompts, few heads: then
//   kM = 1 doubles the blocks; kernel.py::mma_plan picks); at D = 256
//   the O accumulator alone is 128 floats a thread and a warp owns one.
// - K and V tiles of BK keys come in by cp.async (zero-filled past Sk)
//   into a ring of kStages stages, the next tiles' loads in flight while
//   this tile's products run; Q comes in once, with the first tile.
//   Every shared row has a stride of D + 4 floats (4 mod 16, D being a
//   multiple of 16), so every fragment load below is free of bank
//   conflicts.
// - Both products run as mma.sync m16n8k8 TF32 with float32 sums.  The
//   tensor cores read a TF32 operand as the top 19 bits of a float32
//   (they truncate), so each float32 operand a is taken as hi = a and
//   lo = a - trunc(a), and each product as a_lo b_hi + a_hi b_lo +
//   a_hi b_hi: about 2^-20 relative per operand, where one pass keeps
//   ~3 decimal digits and misses the float32 tolerance (2e-5) by ~100x
//   (tests/test_torch_flash_attention.py emulates both on the CPU).
//   The tensor cores round each sum they write toward zero, so a row's
//   P V taken straight into O (three passes for every 8 keys: 563
//   truncations over Whisper's 1500 keys) drifted low by up to ~5e-5 of
//   |O| where V is coherent along the keys, past the 2e-5 tolerance on
//   a Whisper-large-v3 encoder layer; each 8 keys' three passes now go
//   into a zeroed partial, added to O on the CUDA cores in round to
//   nearest (tests/test_torch_flash_attention.py emulates both).  The
//   four adds per three mma cost 9-19 % up to D = 128 and 38 % at
//   D = 256 on an H100 (PERF.md).  The scores' own chain is D / 8 steps
//   long and stays as it is.
//   wgmma would need both TF32 operands K-major, so V staged again
//   transposed and the B operands split ahead of time in shared memory;
//   for the SSD kernel that staging cost more than wgmma saved.
// - The online softmax runs on the S accumulator in registers: row max
//   and row sum over the four threads of a quad (__shfl_xor_sync), exp
//   in full precision (expf; __expf's error would take a visible share
//   of the tolerance).  P goes from the S accumulator straight into the
//   A fragment of P V without a shuffle: the accumulator's column pair
//   (2 t, 2 t + 1) of an 8-key tile is the A fragment's (t, t + 4) once
//   the key axis of P and V is permuted alike, so a thread reads V's
//   rows 2 t and 2 t + 1 for its B fragment.
// - Key tiles wholly masked for the whole block (above the diagonal,
//   outside the window) are not loaded; a warp skips the tiles its own
//   rows cannot see, and only tiles that cut the diagonal, the
//   window's edge or Sk test each score (zero-filled key rows score 0,
//   not -1e30, so the kpos < Sk test stays).  A row that has seen a
//   visible key gives a masked score the weight exp(-1e30 - m) = 0, and
//   a row's masked scores before its first visible key are wiped by
//   alpha = 0 then, so skipping leaves every row with a visible key
//   unchanged.
//
// The plan is D's and the row tiles a warp (kWarpsFor and Plan below;
// kernel.py::mma_plan mirrors it and the launcher refuses any other
// shared-memory count);
// tools/flash_f32_probe.py times the other choices at Zamba2-7B's shape:
// 8 warps of 32 rows, 32 keys a tile and two stages (one block an SM,
// ~233 registers a thread) came first.  Where its 256-row blocks leave
// SMs idle (Sq 320 at 32 heads: 64 blocks), 8 warps of 16 rows and 64
// keys a tile took a third off (4 warps of 32 rows did not help); one
// tile stays ahead up to 1.5x as many 256-row blocks as SMs.  Tried and
// set aside: Q and K fragments read as 128-bit words from a
// column-permuted layout (staged by 4-byte cp.async; 18 % slower, 250
// registers), and read by ldmatrix (a quarter of the instructions,
// within 1 % of the time); 12 or 16 warps of one row tile (6-18 %
// slower).  Not tried: the next tile's
// fragments loaded while this one's products run.
// All kernels build with -fmad=false; here that only keeps l alpha +
// rowsum from contracting: expf and tanhf call their fused
// multiply-adds explicitly and the tensor cores sum as they do, so it
// costs the softmax no accuracy (its time was not measured apart).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

// launch statuses beyond cudaError_t's range
constexpr int kErrPlan = 10001;
constexpr int kErrSmem = 10002;
constexpr int kErrAlign = 10003;
constexpr int kErrGrid = 10004;

// Warps a block for head dim D: 8 up to D = 128; 4 at D = 256, where a
// warp owns one row tile and 8 warps would leave room for 16 keys a tile.
constexpr int kWarpsFor(int D) { return D <= 128 ? 8 : 4; }

// Shared memory of one block of kWarps warps of kM 16-row tiles: Q
// (BQ = 16 kM kWarps rows), then kStages x (K tile, V tile) of BK rows
// each, every row D + 4 floats.
template <int D, int kWarps, int kM>
struct Plan {
  static constexpr int kBQ = 16 * kM * kWarps;
  static constexpr int kBK = D <= 64 || (kM == 1 && D <= 128) ? 64 : 32;
  static constexpr int kStages = 2;
  static constexpr int kStride = D + 4;
  static constexpr int kTile = kBK * kStride;  // floats of one K or V tile
  static constexpr int kSmem = 4 * kStride * (kBQ + 2 * kStages * kBK);
  static_assert(D % 16 == 0, "rows of a multiple of 16 floats");
  static_assert(kSmem <= 227 * 1024, "tile does not fit shared memory");
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

template <int D, int kWarps, int kM>
__global__ void __launch_bounds__(32 * kWarps, 1)
flash_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int H, int KV, float scale, int causal, int window,
                 float cap) {
  using P = Plan<D, kWarps, kM>;
  constexpr int kThreads = 32 * kWarps;
  constexpr int BK = P::kBK;
  constexpr int kStages = P::kStages;
  constexpr int kS = P::kStride;
  constexpr int kRows = 16 * kM;  // query rows a warp
  constexpr int kNT = BK / 8;  // 8-key tiles of S
  constexpr int kDT = D / 8;   // 8-column tiles of O
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                   // (BQ, kS)
  float* s_ring = s_q + P::kBQ * kS;   // kStages x (K, V), each (BK, kS)

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * P::kBQ;
  const int q_last = min(q0 + P::kBQ, Sq) - 1;
  // the key tiles that hold a visible key for some row of this block
  int kb_lo = 0;
  int kb_hi = (Sk + BK - 1) / BK;
  if (causal) kb_hi = min(kb_hi, q_last / BK + 1);
  if (window > 0) kb_lo = max(0, q0 - window + 1) / BK;
  const int n_tiles = kb_hi - kb_lo;

  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KV) * D;
  const size_t kv0 = (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  stage<D, kThreads>(s_q, q + ((static_cast<size_t>(b) * Sq + q0) * H + h) *
                              D,
                     q_step, min(P::kBQ, Sq - q0), P::kBQ);
  auto load_tile = [&](int t) {
    const int k0 = (kb_lo + t) * BK;
    float* s_k = s_ring + (t % kStages) * 2 * P::kTile;
    const size_t at = kv0 + static_cast<size_t>(k0) * kv_step;
    const int valid = min(BK, Sk - k0);
    stage<D, kThreads>(s_k, k + at, kv_step, valid, BK);
    stage<D, kThreads>(s_k + P::kTile, v + at, kv_step, valid, BK);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();  // group s; Q is in group 0
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + kRows * warp;  // the warp's first row
  const int r_last = min(r0 + kRows - 1, Sq - 1);
  // row tile mt of the warp: rows r0 + 16 mt + g (register pair 0, 1)
  // and + 8 (pair 2, 3)
  const float* qa = s_q + (kRows * warp + g) * kS + t4;

  float acc[kM][kDT][4];
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      acc[mt][dt][0] = acc[mt][dt][1] = acc[mt][dt][2] = acc[mt][dt][3] =
          0.0f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and Q) arrived
    __syncthreads();               // ... for every thread; tile t - 1 done
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const int k0 = (kb_lo + t) * BK;
    // the warp's rows see no key of this tile
    if (r0 >= Sq || (causal && k0 > r_last) ||
        (window > 0 && r0 - (k0 + BK - 1) >= window))
      continue;
    const float* s_k = s_ring + (t % kStages) * 2 * P::kTile;
    const float* s_v = s_k + P::kTile;

    // S = Q K^T over D / 8 steps of 8 columns, each K fragment read and
    // split once for the warp's kM row tiles
    float sc[kM][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        sc[mt][nt][0] = sc[mt][nt][1] = sc[mt][nt][2] = sc[mt][nt][3] = 0.0f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 8) {
      uint32_t ah[kM][4], al[kM][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        const float* qr = qa + 16 * mt * kS + d0;
        split(qr[0], ah[mt][0], al[mt][0]);
        split(qr[8 * kS], ah[mt][1], al[mt][1]);
        split(qr[4], ah[mt][2], al[mt][2]);
        split(qr[8 * kS + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float* kr = s_k + (8 * nt + g) * kS + d0 + t4;
        uint32_t bh[2], bl[2];
        split(kr[0], bh[0], bl[0]);
        split(kr[4], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < kM; ++mt)
          mma3(sc[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }

    // scores, masked where this tile cuts the diagonal, the window's
    // edge or Sk for the warp's rows; the row maxima over the quad
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && r_last - k0 >= window);
#pragma unroll
    for (int mt = 0; mt < kM; ++mt) {
      const int row0 = r0 + 16 * mt + g;
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[mt][nt][e] * scale;
          if (cap > 0.0f) x = cap * tanhf(x / cap);
          if (masked) {
            const int kpos = k0 + 8 * nt + 2 * t4 + (e & 1);
            const int qpos = row0 + ((e & 2) ? 8 : 0);
            bool keep = kpos < Sk;
            if (causal) keep = keep && qpos >= kpos;
            if (window > 0) keep = keep && qpos - kpos < window;
            if (!keep) x = kNegInf;
          }
          sc[mt][nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = expf(m[mt][r] - mx[r]);
        m[mt][r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = expf(sc[mt][nt][e] - m[mt][e >> 1]);
          sc[mt][nt][e] = pe;
          sum[e >> 1] = sum[e >> 1] + pe;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[r] + sum[r];
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        acc[mt][dt][0] *= alpha[0];
        acc[mt][dt][1] *= alpha[0];
        acc[mt][dt][2] *= alpha[1];
        acc[mt][dt][3] *= alpha[1];
      }
    }

    // O += P V per 8 keys, the key axis permuted: P's accumulator columns
    // (2 t4, 2 t4 + 1) are the A fragment's (t4, t4 + 4), V's rows
    // 2 t4 and 2 t4 + 1 its B fragment's, each V fragment read and split
    // once for the kM row tiles
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      uint32_t ah[kM][4], al[kM][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        split(sc[mt][kk][0], ah[mt][0], al[mt][0]);
        split(sc[mt][kk][2], ah[mt][1], al[mt][1]);
        split(sc[mt][kk][1], ah[mt][2], al[mt][2]);
        split(sc[mt][kk][3], ah[mt][3], al[mt][3]);
      }
      const float* vr = s_v + (8 * kk + 2 * t4) * kS + g;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t bh[2], bl[2];
        split(vr[8 * dt], bh[0], bl[0]);
        split(vr[8 * dt + kS], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
          // the 8 keys' three passes from zero, then one rounded add
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma3(part, ah[mt], al[mt], bh, bl);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][dt][e] += part[e];
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // each thread's sums cover its own columns: add the quad's
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
    const int row0 = r0 + 16 * mt + g;
    float* out0 = o + ((static_cast<size_t>(b) * Sq + row0) * H + h) * D +
                  2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float den = fmaxf(lr, 1e-30f);
      if (row0 + 8 * r >= Sq) continue;
      float* out = out0 + 8 * r * q_step;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<float2*>(out + 8 * dt) =
            make_float2(acc[mt][dt][2 * r] / den, acc[mt][dt][2 * r + 1] / den);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int D, int kWarps, int kM>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, float scale, int causal, int window,
           float cap, int smem, void* stream) {
  using P = Plan<D, kWarps, kM>;
  if (smem != P::kSmem) return kErrSmem;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return kErrAlign;
  const int q_blocks = (Sq + P::kBQ - 1) / P::kBQ;
  if (q_blocks > 65535 || static_cast<int64_t>(B) * H > 0x7fffffff)
    return kErrGrid;
  static bool opted_in = false;  // one attribute per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D, kWarps, kM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(B * H, q_blocks);
  flash_mma_kernel<D, kWarps, kM><<<grid, 32 * kWarps, P::kSmem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV,
      scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Contiguous float32 device buffers, 16-byte aligned: q and o
// (B, Sq, H, D), k and v (B, Sk, KV, D), H % KV == 0, D one of 16, 64,
// 112, 128, 256; tiles (16-row tiles a warp) 1 or 2, 1 at D = 256.
// smem (bytes) as kernel.py::mma_plan gives it, which must equal
// Plan<D, kWarpsFor(D), tiles>::kSmem (the launch is refused
// otherwise); scale = 1 / sqrt(D); window 0 = none; cap 0 = no soft-cap.
// Enqueued on `stream`; returns 0 when launched, else a cudaError_t or
// one of the kErr codes (flash_mma_error_string).
int flash_attention_mma_f32(const void* q, const void* k, const void* v,
                            void* o, int B, int Sq, int Sk, int H, int KV,
                            int D, int tiles, float scale, int causal,
                            int window, float cap, int smem, void* stream) {
#define FLASH_MMA_LAUNCH(d, m)                                               \
  return launch<d, kWarpsFor(d), m>(q, k, v, o, B, Sq, Sk, H, KV, scale,    \
                                    causal, window, cap, smem, stream)
#define FLASH_MMA_CASE(d)                                                    \
  case d:                                                                    \
    if (tiles == 1) FLASH_MMA_LAUNCH(d, 1);                                  \
    if (tiles == 2) FLASH_MMA_LAUNCH(d, 2);                                  \
    return kErrPlan;
  switch (D) {
    FLASH_MMA_CASE(16)
    FLASH_MMA_CASE(64)
    FLASH_MMA_CASE(112)
    FLASH_MMA_CASE(128)
    case 256:
      if (tiles == 1) FLASH_MMA_LAUNCH(256, 1);
      return kErrPlan;
    default:
      return kErrPlan;
  }
#undef FLASH_MMA_CASE
#undef FLASH_MMA_LAUNCH
}

const char* flash_mma_error_string(int code) {
  switch (code) {
    case kErrPlan:
      return "plan not built (D 16, 64, 112, 128, 256; 1 or 2 row tiles "
             "a warp, 1 at D 256)";
    case kErrSmem:
      return "shared memory bytes differ from the kernel's layout";
    case kErrAlign: return "q, k, v, o must be 16-byte aligned";
    case kErrGrid: return "too many query blocks or batch heads for a grid";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
