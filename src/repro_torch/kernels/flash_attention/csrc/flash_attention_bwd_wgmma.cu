// Flash attention (backward) in bfloat16 on Hopper's tensor cores
// (sm_90a): GQA, causal mask, sliding window, tanh logit soft-cap,
// non-causal with Sq != Sk, ragged edges; every product on wgmma with
// float32 accumulation, operands brought by TMA, no atomics.
//
// Replaces no TPU kernel: the JAX package has no backward kernel.  Its
// training differentiates jnp code with jax.value_and_grad
// (src/repro/train/steps.py:152), and above 256 x 256 scores the
// attention it differentiates is src/repro/models/attention.py::
// _sdpa_chunked, the jnp form of the flash recurrence whose bfloat16
// forward the port runs as flash_attention_wgmma.cu.  This is the
// bfloat16 backward of kernel.py::FlashAttention; float32 inputs go to
// the CUDA-core kernels of flash_attention_bwd.cu.  The function, for
// query row i of head h (KV head h / (H / KV)) and key j, with s the
// forward's scores (x = q . k scaled by 1 / sqrt(D), then soft-capped
// s = cap tanh(x / cap) when cap > 0) masked as the forward masks them
// (j >= Sk, causal i < j, window i - j >= window):
//
//     lse_i   = log sum_j exp(s_ij)               over the visible keys
//     p_ij    = exp(s_ij - lse_i)                 (0 where masked)
//     dp_ij   = dO_i . v_j
//     delta_i = sum_j p_ij dp_ij                  (= rowsum(dO o O))
//     ds_ij   = p_ij (dp_ij - delta_i) (1 - tanh^2(x_ij / cap) if capped)
//     dV_j    = sum_i p_ij dO_i                   (over the G query heads)
//     dQ_i    = scale sum_j ds_ij k_j;   dK_j = scale sum_i ds_ij q_i
//
// q, dO (B, Sq, H, D) and k, v (B, Sk, KV, D) are read in the model's
// layout; dq, dk, dv are written in it, in bfloat16.  A row that sees no
// key (only possible with a window shorter than Sq - Sk) gets zero
// gradients.  The softmax runs in base 2 (log2 e folded into the scale).
//
// Three kernels, one launch each, on the caller's stream; every block
// has three warpgroups: two consumers of 64 rows each and a producer
// whose one thread starts every TMA load into a two-stage ring of full
// and empty mbarriers (setmaxnreg: 24 registers for the producer, 240 for
// the consumers), as the forward kernel does.
//
// - prep: one block per (batch * head, 128 query rows), Q and dO held,
//   K and V tiles in the ring.  S = Q K^T and dP = dO V^T on wgmma (the
//   bfloat16 inputs are exact operands), the online max and sum of
//   exp(S) for lse, and delta = sum_j p_ij dP_ij rescaled online as the
//   forward rescales O: rowsum(dO o O) with no O at all and no operand
//   rounded (the forward's bfloat16 O, 8 bits, would make ds = p (dp -
//   delta) cancel to noise).  Both into float32 scratch (B H, Sq_pad),
//   Sq_pad = Sq rounded up to 128 rows; rows past Sq get lse = +inf and
//   delta = 0, so the dkdv launch's tiles read them without a test.
// - dkdv: one block per (key tile of 128, batch, KV head, split, column
//   half) holds K and V of its 128 keys and walks, in the ring, the
//   (query head, query tile) pairs of its split whose rows can see them.
//   S^T = K Q^T and dP^T = V dO^T come out with keys as rows, so P^T and
//   dS^T, rounded to bfloat16 in registers, are the register A operands
//   of dV += P^T dO and dK += dS^T Q, whose B operands (dO and Q as TMA
//   wrote them, D contiguous) are MN-major: wgmma's transpose flag, as
//   the forward reads V.  The tile's lse and delta come with Q and dO by
//   a bulk copy.
//   GQA: one block per (batch, KV head, key tile) is 64 blocks at
//   StarCoder2-3B's training shape (B 2, KV 2, S 2048) on 132 SMs, so a
//   group's G query heads are split over n_split blocks (the plan's
//   bwd_wgmma_split: the fewest that give 1.5 x 132 blocks, 4 there,
//   measured best of 1-12), each writing float32 partials of dK and dV to
//   scratch (2, n_split, B, Sk, KV, D); the dq launch's last blocks sum
//   them in split order and round them to bfloat16.  Float32 scratch was
//   taken over a cluster reducing through DSMEM without timing the
//   cluster: at that shape the partials are 34 MB, written once and read
//   once (~20 us at HBM's rate, against a launch of ~0.75 ms), and need
//   no cluster barriers; with n_split = 1 (G = 1, or grids that fill the
//   card already) the block writes bfloat16 directly.
//   D = 256: dK and dV of 64 keys a thread would be 256 floats, past the
//   register file; the block's column half (blockIdx) splits their D
//   columns over two blocks, each recomputing S^T and dP^T over all of D
//   (1.5x the products at D = 256 only).
// - dq: one block per (batch * head, 128 query rows) holds Q, dO, its
//   rows' lse and delta, and walks the visible key tiles: S and dP as in
//   prep, dS rounded to bfloat16 in registers as the A operand of
//   dQ += dS K (K MN-major).  Blocks past the query blocks reduce the
//   dkdv partials.
//
// In all three the heaviest causal blocks go first (the last query
// blocks of prep and dq, the first key tiles of dkdv), wholly masked
// tiles are never loaded (a dkdv warpgroup whose 64 keys a tile cannot
// see skips its products), and only tiles that cut the diagonal, the
// window's edge or Sk test each score.  Every dQ, dK and dV element is a
// sum in one fixed order: the result is the same bits from run to run.
//
// What bounds it on this card: at StarCoder2-3B's training shape (B 2,
// S 2048, 24 heads over 2 KV heads, D 128, causal) the function's five
// products over the visible pairs are ~129 G operations on ~84 MB, so
// the tensor cores' bf16 rate bounds it: 0.130 ms at 989 TFLOP/s.  This
// design runs nine products (two in prep, four in dkdv, three in dq).  In
// prep and dq a tile's work on S (max, exp) overlaps its dP product; in
// dkdv each warpgroup waits for S^T and dP^T, then for dV and dK (issuing
// dV before dP^T is done measured no faster: tools/flash_bwd_probe.py).
// Nothing overlaps one tile's elementwise work with the next tile's
// products.
//
// The plan is fixed by D (kernel.py::bwd_wgmma_plan, the layouts of
// QLayout<D> and KLayout<D> here): prep and dq take K/V tiles of 64 keys
// (32 at D = 256) in two stages; dkdv takes Q/dO tiles of 64 rows (32 at
// D = 256) in two stages.  All kernels build with -fmad=false
// (kernels/build.py).
#include <cuda.h>  // CUtensorMap and its encoder's types; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;          // query rows of a prep or dq block
constexpr int kBKV = 128;         // keys of a dkdv block
constexpr int kConsumers = 256;   // two consumer warpgroups of 64 rows
constexpr int kThreads = 384;     // and the producer warpgroup
constexpr int kChunkCols = 64;    // bf16 columns in one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 1024;  // 8 swizzled rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// launch statuses beyond cudaError_t's range
constexpr int kErrHeadDim = 10001;
constexpr int kErrSmem = 10002;
constexpr int kErrEntryPoint = 10003;
constexpr int kErrTensorMap = 10004;
constexpr int kErrSplit = 10005;
constexpr int kErrGrid = 10006;

// Shared memory of a prep or dq block, from a 1024-byte aligned base: Q
// and dO (kChunks x 128 rows x 128 B each), then kStages x (K tile, V
// tile), each kChunks x kBK rows x 128 B, then the mbarriers (Q full,
// kStages full, kStages empty).  kSmem adds 1024 bytes for aligning the
// base.
template <int D>
struct QLayout {
  static constexpr int kChunks = (D + kChunkCols - 1) / kChunkCols;
  static constexpr int kBK = D <= 128 ? 64 : 32;
  static constexpr int kStages = 2;
  static constexpr int kRowChunk = kBQ * kRowBytes;
  static constexpr int kKeyChunk = kBK * kRowBytes;
  static constexpr int kRowTile = kChunks * kRowChunk;
  static constexpr int kKeyTile = kChunks * kKeyChunk;
  static constexpr int kStageBytes = 2 * kKeyTile;
  static constexpr int kRingOffset = 2 * kRowTile;
  static constexpr int kBarOffset = kRingOffset + kStages * kStageBytes;
  static constexpr int kSmem =
      kAtomBytes + kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(kSmem <= 227 * 1024, "tile does not fit shared memory");
  static_assert(D % 16 == 0, "head dim a multiple of 16");
};

// Shared memory of a dkdv block: K and V (kChunks x 128 keys x 128 B
// each), then kStages x (Q tile, dO tile), each kChunks x kBQ rows x
// 128 B, then kStages x (lse, delta) of kBQ floats each, then the
// mbarriers (K/V full, kStages full, kStages empty).  kDSplit blocks
// share a key tile's D columns (two at D = 256), kDN columns each.
template <int D>
struct KLayout {
  static constexpr int kChunks = (D + kChunkCols - 1) / kChunkCols;
  static constexpr int kBQ = D <= 128 ? 64 : 32;
  static constexpr int kStages = 2;
  static constexpr int kDSplit = D > 128 ? 2 : 1;
  static constexpr int kDN = D / kDSplit;
  static constexpr int kKeyChunk = kBKV * kRowBytes;
  static constexpr int kRowChunk = kBQ * kRowBytes;
  static constexpr int kKeyTile = kChunks * kKeyChunk;
  static constexpr int kRowTile = kChunks * kRowChunk;
  static constexpr int kStageBytes = 2 * kRowTile;
  static constexpr int kRowsBytes = 2 * kBQ * 4;  // lse and delta
  static constexpr int kRingOffset = 2 * kKeyTile;
  static constexpr int kRowsOffset = kRingOffset + kStages * kStageBytes;
  static constexpr int kBarOffset = kRowsOffset + kStages * kRowsBytes;
  static constexpr int kSmem =
      kAtomBytes + kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(kSmem <= 227 * 1024, "tile does not fit shared memory");
  static_assert(kDN % 64 == 0 || kDSplit == 1, "a column half is chunks");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of the 4-D tensor map at (column, head, row, batch) into
// shared memory, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading byte offset (the next 64-column chunk of an MN-major operand;
// unused for K-major) and the stride byte offset (the next 8 rows)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// waits for all but the last committed group
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keeps the compiler from moving an accumulator across an asynchronous
// wgmma: each register is "rewritten" here
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, float32) (+)= A (64 x 16) B (16 x N), bf16 in.  SS: A and
// B K-major in shared memory (S = Q K^T, S^T = K Q^T and the dP's).
// RS: A in registers, B MN-major in shared memory (dQ += dS K, dV +=
// P^T dO, dK += dS^T Q).  The accumulator of a thread in
// its warpgroup: d[4j + e] is row 16 warp + lane / 4 + 8 (e / 2), column
// 8 j + 2 (lane % 4) + e % 2.
template <int N>
struct WgmmaSS;
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaSS<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaRS<16> {
  __device__ __forceinline__ static void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct WgmmaRS<112> {
  __device__ __forceinline__ static void mma(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct WgmmaRS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct WgmmaRS<256> {
  __device__ __forceinline__ static void mma(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

// `bytes` (a multiple of 16) from global memory at `src` into shared
// memory at `dst`, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// acc (64 x N) = A B^T over D columns, A's 64 rows at `a` and B's N rows
// at `b`, both K-major (D contiguous) in 64-column chunks `a_chunk` and
// `b_chunk` bytes apart: ceil(D / 16) steps of 16 columns
template <int D, int N>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint32_t a,
                                           int a_chunk, uint32_t b,
                                           int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < (D + 15) / 16; ++kk) {
    const uint32_t at = (kk % 4) * 32;  // bytes into the chunk's row
    WgmmaSS<N>::mma(acc,
                    smem_desc(a + (kk / 4) * a_chunk + at, 16, kAtomBytes),
                    smem_desc(b + (kk / 4) * b_chunk + at, 16, kAtomBytes),
                    kk > 0);
  }
}

// acc (64 x N) += A B, A (64 x K) in registers as K / 16 fragments, B's
// K rows at `b` MN-major (N contiguous) in 64-column chunks `b_chunk`
// bytes apart: 16 rows (2048 bytes) a step
template <int N, int K>
__device__ __forceinline__ void rs_product(float (&acc)[N / 2],
                                           const uint32_t (&a)[K / 16][4],
                                           uint32_t b, int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    WgmmaRS<N>::mma(acc, a[kk],
                    smem_desc(b + kk * 16 * kRowBytes, b_chunk, kAtomBytes),
                    1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 pk = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&pk);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int causal, int window) {
  bool keep = kpos < Sk;
  if (causal) keep = keep && qpos >= kpos;
  if (window > 0) keep = keep && qpos - kpos < window;
  return keep;
}

// The forward's score of a raw dot product x in base 2, and t = tanh(x
// scale / cap) for the cap's derivative (0 without a cap)
struct Scorer {
  float scale_log2, cap_log2, inv_cap;
  __device__ Scorer(float scale, float cap)
      : scale_log2(scale * kLog2e),
        cap_log2(cap * kLog2e),
        inv_cap(cap > 0.0f ? scale / cap : 0.0f) {}
  __device__ __forceinline__ float operator()(float x, float& t) const {
    if (inv_cap > 0.0f) {
      t = tanhf(x * inv_cap);
      return cap_log2 * t;
    }
    t = 0.0f;
    return x * scale_log2;
  }
};

// dk, dv (E elements each) from the dkdv launch's n_split float32
// partials (part: dK's n_split x E, then dV's), summed in split order and
// rounded to bfloat16; groups of 4 elements spread over n_blocks blocks
__device__ void sum_partials(const float* __restrict__ part,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int64_t E,
                             int n_split, int block, int n_blocks) {
  const int64_t n4 = E / 4;
  for (int64_t g = static_cast<int64_t>(block) * kThreads + threadIdx.x;
       g < 2 * n4; g += static_cast<int64_t>(n_blocks) * kThreads) {
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
    uint32_t* out = reinterpret_cast<uint32_t*>((which ? dv : dk) + e);
    out[0] = pack_bf16(acc.x, acc.y);
    out[1] = pack_bf16(acc.z, acc.w);
  }
}

// prep (kDq false) and dq (kDq true): one block per (batch * head, 128
// query rows), blockIdx.x = (nqb - 1 - query block) * B H + b H + h, so
// the heaviest causal blocks go first; the dq launch's blocks from
// n_blocks on sum the dkdv partials instead.  lse (base 2) and delta are
// (B H, Sq_pad) float32.
template <int D, bool kDq>
__global__ void __launch_bounds__(kThreads, 1)
bwd_rows_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                float* __restrict__ lse, float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq,
                const float* __restrict__ part,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int B, int Sq, int Sk,
                int H, int KV, int n_split, int n_blocks, float scale,
                int causal, int window, float cap) {
  using L = QLayout<D>;
  constexpr int BK = L::kBK;
  constexpr int kStages = L::kStages;
  if constexpr (kDq) {
    if (static_cast<int>(blockIdx.x) >= n_blocks) {
      sum_partials(part, dk, dv, static_cast<int64_t>(B) * Sk * KV * D,
                   n_split, blockIdx.x - n_blocks, gridDim.x - n_blocks);
      return;
    }
  }
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kAtomBytes - 1) &
                        ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint32_t s_q = base;
  const uint32_t s_do = base + L::kRowTile;
  const uint32_t s_ring = base + L::kRingOffset;
  const uint32_t bar_q = base + L::kBarOffset;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int BH = B * H;
  const int nqb = (Sq + kBQ - 1) / kBQ;
  const int Sq_pad = nqb * kBQ;
  const int bh = blockIdx.x % BH;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x) / BH) * kBQ;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  // the key tiles that hold a visible key for some row of this block
  int kb_lo = 0;
  int kb_hi = (Sk + BK - 1) / BK;
  if (causal) kb_hi = min(kb_hi, q_last / BK + 1);
  if (window > 0) kb_lo = max(0, q0 - window + 1) / BK;
  const int n_tiles = max(0, kb_hi - kb_lo);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * L::kRowTile);
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load(s_q + c * L::kRowChunk, &tm_q, bar_q, c * kChunkCols, h, q0,
                 b);
        tma_load(s_do + c * L::kRowChunk, &tm_do, bar_q, c * kChunkCols, h,
                 q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // the consumers released this stage's last use
          mbar_wait(bar_empty + 8 * s, ((t / kStages) + 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t s_k = s_ring + s * L::kStageBytes;
        const int k0 = (kb_lo + t) * BK;
        mbar_expect_tx(full, L::kStageBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(s_k + c * L::kKeyChunk, &tm_k, full, c * kChunkCols, kvh,
                   k0, b);
          tma_load(s_k + L::kKeyTile + c * L::kKeyChunk, &tm_v, full,
                   c * kChunkCols, kvh, k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const int row1 = row0 + 8;
    const int col_pair = 2 * (lane % 4);
    const Scorer score(scale, cap);
    const uint32_t a_q = s_q + 64 * wg * kRowBytes;
    const uint32_t a_do = s_do + 64 * wg * kRowBytes;
    const int64_t rows = static_cast<int64_t>(bh) * Sq_pad;

    // prep: running max, sum of p and sum of p dP of each row, over this
    // thread's columns; dq: its rows' lse and delta, and dQ
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    float e0 = 0.0f, e1 = 0.0f;
    float lse0 = 0.0f, lse1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;
    float acc_dq[kDq ? D / 2 : 1];
#pragma unroll
    for (int i = 0; i < (kDq ? D / 2 : 1); ++i) acc_dq[i] = 0.0f;
    if constexpr (kDq) {
      lse0 = lse[rows + row0];
      lse1 = lse[rows + row1];
      dl0 = delta[rows + row0];
      dl1 = delta[rows + row1];
    }

    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = (kb_lo + t) * BK;
      const uint32_t s_k = s_ring + s * L::kStageBytes;
      const uint32_t s_v = s_k + L::kKeyTile;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);

      // S = Q K^T, then dP = dO V^T: the work on S overlaps dP's product
      float acc_s[BK / 2], acc_dp[BK / 2];
      wgmma_fence();
      ss_product<D, BK>(acc_s, a_q, L::kRowChunk, s_k, L::kKeyChunk);
      wgmma_commit();
      ss_product<D, BK>(acc_dp, a_do, L::kRowChunk, s_v, L::kKeyChunk);
      wgmma_commit();
      wgmma_wait_one();
      pin(acc_s);
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                          (window > 0 && q_last - k0 >= window);

      if constexpr (!kDq) {
        // scores in base 2, masked where this tile cuts the diagonal,
        // the window's edge or Sk; the running row maxima over the quad
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float th;
          float x = score(acc_s[i], th);
          if (masked) {
            const int kpos = k0 + (i / 4) * 8 + col_pair + (i & 1);
            if (!visible((i & 2) ? row1 : row0, kpos, Sk, causal, window))
              x = kNegInf;
          }
          acc_s[i] = x;
          if (i & 2)
            mx1 = fmaxf(mx1, x);
          else
            mx0 = fmaxf(mx0, x);
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float alpha0 = ex2(m0 - mx0);
        const float alpha1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.0f, sum1 = 0.0f, pd0 = 0.0f, pd1 = 0.0f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          acc_s[i] = ex2(acc_s[i] - ((i & 2) ? m1 : m0));  // p
          if (i & 2)
            sum1 += acc_s[i];
          else
            sum0 += acc_s[i];
        }
        wgmma_wait_all();
        pin(acc_dp);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          if (i & 2)
            pd1 += acc_s[i] * acc_dp[i];
          else
            pd0 += acc_s[i] * acc_dp[i];
        }
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
        e0 = e0 * alpha0 + pd0;
        e1 = e1 * alpha1 + pd1;
      } else {
        // P = 2^(S - lse) while dP's product runs; then dS = P (dP -
        // delta) (1 - t^2), rounded to bf16 into the A operand of dQ +=
        // dS K: the 16 keys of step kk are accumulator blocks 2 kk and
        // 2 kk + 1, and register j holds row (j % 2 ? row1 : row0), block
        // 2 kk + j / 2
        float p[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float th;
          p[i] = ex2(score(acc_s[i], th) - ((i & 2) ? lse1 : lse0));
          if (masked &&
              !visible((i & 2) ? row1 : row0,
                       k0 + (i / 4) * 8 + col_pair + (i & 1), Sk, causal,
                       window))
            p[i] = 0.0f;
        }
        wgmma_wait_all();
        pin(acc_dp);
        uint32_t ds_frag[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 8 * kk + 2 * j;
            const float dlt = (j & 1) ? dl1 : dl0;
            float ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              ds[e] = p[i + e] * (acc_dp[i + e] - dlt);
              if (cap > 0.0f) {
                float th;
                score(acc_s[i + e], th);
                ds[e] *= 1.0f - th * th;
              }
            }
            ds_frag[kk][j] = pack_bf16(ds[0], ds[1]);
          }
        }
        wgmma_fence();
        rs_product<D, BK>(acc_dq, ds_frag, s_k, L::kKeyChunk);
        wgmma_commit();
        wgmma_wait_all();
        pin(acc_dq);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    if constexpr (!kDq) {
      // each thread's sums cover its own columns: add the quad's; a row
      // that saw no key (or lies past Sq) gets lse = +inf, delta = 0
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
      e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
      if ((lane & 3) == 0) {
        const bool seen0 = row0 < Sq && m0 > 0.5f * kNegInf;
        const bool seen1 = row1 < Sq && m1 > 0.5f * kNegInf;
        lse[rows + row0] = seen0 ? m0 + log2f(l0) : INFINITY;
        lse[rows + row1] = seen1 ? m1 + log2f(l1) : INFINITY;
        delta[rows + row0] = seen0 ? e0 / l0 : 0.0f;
        delta[rows + row1] = seen1 ? e1 / l1 : 0.0f;
      }
    } else {
      __nv_bfloat16* out0 = dq +
                            (static_cast<int64_t>(b) * Sq + row0) * H * D +
                            static_cast<int64_t>(h) * D + col_pair;
      __nv_bfloat16* out1 = out0 + static_cast<int64_t>(8) * H * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (row0 < Sq)
          *reinterpret_cast<uint32_t*>(out0 + 8 * j) =
              pack_bf16(acc_dq[4 * j] * scale, acc_dq[4 * j + 1] * scale);
        if (row1 < Sq)
          *reinterpret_cast<uint32_t*>(out1 + 8 * j) = pack_bf16(
              acc_dq[4 * j + 2] * scale, acc_dq[4 * j + 3] * scale);
      }
    }
  }
}

// dK and dV: one block per (key tile of 128, batch, KV head, split,
// column half), blockIdx.x = ((key tile B + b) KV + kvh) n_split kDSplit
// + split kDSplit + half, so the heaviest causal key tiles go first.
// The block's split sums G / n_split query heads of its group; with
// n_split = 1 it writes dk, dv in bfloat16, else its float32 partials
// into part (2, n_split, B, Sk, KV, D).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                int B, int Sq, int Sk, int H, int KV, int n_split,
                float scale, int causal, int window, float cap) {
  using L = KLayout<D>;
  constexpr int BQ = L::kBQ;
  constexpr int kStages = L::kStages;
  constexpr int DN = L::kDN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base =
      (raw + kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint8_t* gbase = smem_raw + (base - raw);  // the same, generic
  const uint32_t s_k = base;
  const uint32_t s_v = base + L::kKeyTile;
  const uint32_t s_ring = base + L::kRingOffset;
  const uint32_t s_rows = base + L::kRowsOffset;
  const uint32_t bar_kv = base + L::kBarOffset;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int G = H / KV;
  const int hps = G / n_split;  // query heads a split
  const int inner = B * KV * n_split * L::kDSplit;
  const int kb = blockIdx.x / inner;
  int r = blockIdx.x - kb * inner;
  const int half = r % L::kDSplit;
  r /= L::kDSplit;
  const int split = r % n_split;
  r /= n_split;
  const int kvh = r % KV;
  const int b = r / KV;
  const int k0 = kb * kBKV;
  const int h0 = kvh * G + split * hps;
  const int Sq_pad = (Sq + kBQ - 1) / kBQ * kBQ;
  // the query tiles that hold a row that can see some key of this block
  const int nqt = (Sq + BQ - 1) / BQ;
  const int qt_lo = causal ? min(nqt, k0 / BQ) : 0;
  const int qt_hi =
      window > 0 ? min(nqt, (k0 + kBKV - 1 + window - 1) / BQ + 1) : nqt;
  const int n_q = max(0, qt_hi - qt_lo);
  const int n_tiles = hps * n_q;  // (head, query tile), heads outermost

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers && n_tiles > 0) {
      mbar_expect_tx(bar_kv, 2 * L::kKeyTile);
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load(s_k + c * L::kKeyChunk, &tm_k, bar_kv, c * kChunkCols, kvh,
                 k0, b);
        tma_load(s_v + c * L::kKeyChunk, &tm_v, bar_kv, c * kChunkCols, kvh,
                 k0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          mbar_wait(bar_empty + 8 * s, ((t / kStages) + 1) & 1);
        const int h = h0 + t / n_q;
        const int q0 = (qt_lo + t % n_q) * BQ;
        const uint32_t full = bar_full + 8 * s;
        const uint32_t s_qt = s_ring + s * L::kStageBytes;
        mbar_expect_tx(full, L::kStageBytes + L::kRowsBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(s_qt + c * L::kRowChunk, &tm_q, full, c * kChunkCols, h,
                   q0, b);
          tma_load(s_qt + L::kRowTile + c * L::kRowChunk, &tm_do, full,
                   c * kChunkCols, h, q0, b);
        }
        const int64_t row = static_cast<int64_t>(b * H + h) * Sq_pad + q0;
        const uint32_t s_lse = s_rows + s * L::kRowsBytes;
        bulk_load(s_lse, lse + row, BQ * 4, full);
        bulk_load(s_lse + BQ * 4, delta + row, BQ * 4, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    // accumulator rows are keys: key0 and key0 + 8
    const int key0 = k0 + 64 * wg + 16 * warp + lane / 4;
    const int key1 = key0 + 8;
    const int col_pair = 2 * (lane % 4);
    const int wk0 = k0 + 64 * wg;  // this warpgroup's keys
    const int wk_last = wk0 + 63;
    const Scorer score(scale, cap);
    const uint32_t a_k = s_k + 64 * wg * kRowBytes;
    const uint32_t a_v = s_v + 64 * wg * kRowBytes;
    // the B operands' first column of this block's half of D
    const uint32_t col_off = half * (DN / kChunkCols) * L::kRowChunk;

    float acc_dk[DN / 2], acc_dv[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

    if (n_tiles > 0) mbar_wait(bar_kv, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int q0 = (qt_lo + t % n_q) * BQ;
      const int q_last = q0 + BQ - 1;
      const uint32_t s_qt = s_ring + s * L::kStageBytes;
      const uint32_t s_dot = s_qt + L::kRowTile;
      const float* lse_s =
          reinterpret_cast<const float*>(gbase + L::kRowsOffset +
                                         s * L::kRowsBytes);
      const float* delta_s = lse_s + BQ;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
      // a tile none of this warpgroup's keys is visible from
      const bool skip = wk0 >= Sk || (causal && q_last < wk0) ||
                        (window > 0 && q0 - wk_last >= window);
      if (!skip) {
        const bool masked = wk_last >= Sk || (causal && q0 < wk_last) ||
                            (window > 0 && q_last - wk0 >= window);
        // S^T = K Q^T, dP^T = V dO^T: keys as rows, queries as columns
        float acc_s[BQ / 2], acc_dp[BQ / 2];
        wgmma_fence();
        ss_product<D, BQ>(acc_s, a_k, L::kKeyChunk, s_qt, L::kRowChunk);
        ss_product<D, BQ>(acc_dp, a_v, L::kKeyChunk, s_dot, L::kRowChunk);
        wgmma_commit();
        wgmma_wait_all();
        pin(acc_s);
        pin(acc_dp);

        // P^T and dS^T rounded to bf16 into the A operands of dV += P^T
        // dO and dK += dS^T Q (the 16 queries of step kk are accumulator
        // blocks 2 kk and 2 kk + 1, as P in the forward)
        uint32_t p_frag[BQ / 16][4], ds_frag[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 8 * kk + 2 * j;
            const int kpos = (j & 1) ? key1 : key0;
            const int c = 16 * kk + 8 * (j >> 1) + col_pair;
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float th;
              p[e] = ex2(score(acc_s[i + e], th) - lse_s[c + e]);
              if (masked && !visible(q0 + c + e, kpos, Sk, causal, window))
                p[e] = 0.0f;
              ds[e] = p[e] * (acc_dp[i + e] - delta_s[c + e]);
              if (cap > 0.0f) ds[e] *= 1.0f - th * th;
            }
            p_frag[kk][j] = pack_bf16(p[0], p[1]);
            ds_frag[kk][j] = pack_bf16(ds[0], ds[1]);
          }
        }
        wgmma_fence();
        rs_product<DN, BQ>(acc_dv, p_frag, s_dot + col_off, L::kRowChunk);
        rs_product<DN, BQ>(acc_dk, ds_frag, s_qt + col_off, L::kRowChunk);
        wgmma_commit();
        wgmma_wait_all();
        pin(acc_dv);
        pin(acc_dk);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    // rows past Sk are not written; n_split > 1: float32 partials
    const int64_t E = static_cast<int64_t>(B) * Sk * KV * D;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int col = half * DN + 8 * j + col_pair;
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int kpos = r2 ? key1 : key0;
        if (kpos >= Sk) continue;
        const int64_t off =
            ((static_cast<int64_t>(b) * Sk + kpos) * KV + kvh) * D + col;
        const float k_lo = acc_dk[4 * j + 2 * r2] * scale;
        const float k_hi = acc_dk[4 * j + 2 * r2 + 1] * scale;
        const float v_lo = acc_dv[4 * j + 2 * r2];
        const float v_hi = acc_dv[4 * j + 2 * r2 + 1];
        if (n_split == 1) {
          *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(k_lo, k_hi);
          *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(v_lo, v_hi);
        } else {
          *reinterpret_cast<float2*>(part + split * E + off) =
              make_float2(k_lo, k_hi);
          *reinterpret_cast<float2*>(part + (n_split + split) * E + off) =
              make_float2(v_lo, v_hi);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (the
// library links no libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (D, heads, S, B) bf16, contiguous; boxes of 64 columns x 1 head x
// `rows` rows x 1 batch, 128-byte swizzle, zeros out of bounds
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int D,
                int heads, int S, int B, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {kChunkCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO,
           void* dq, void* dk, void* dv, float* lse, float* delta,
           float* part, int B, int Sq, int Sk, int H, int KV, int n_split,
           float scale, int causal, int window, float cap, int smem_q,
           int smem_k, void* stream) {
  using QL = QLayout<D>;
  using KL = KLayout<D>;
  if (smem_q != QL::kSmem || smem_k != KL::kSmem) return kErrSmem;
  if (n_split < 1 || (H / KV) % n_split || (n_split > 1 && part == nullptr))
    return kErrSplit;
  const int64_t n_rows = static_cast<int64_t>((Sq + kBQ - 1) / kBQ) * B * H;
  const int64_t n_keys = static_cast<int64_t>((Sk + kBKV - 1) / kBKV) * B *
                         KV * n_split * KL::kDSplit;
  // the dq launch's blocks that sum the partials: 8 groups of 4 a thread
  const int64_t E = static_cast<int64_t>(B) * Sk * KV * D;
  const int64_t n_sum =
      n_split > 1 ? (E / 2 + kThreads * 8 - 1) / (kThreads * 8) : 0;
  if (n_rows + n_sum > 0x7fffffff || n_keys > 0x7fffffff) return kErrGrid;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrEntryPoint;
  // prep and dq: Q, dO in 128-row boxes, K, V in kBK-key boxes; dkdv: K,
  // V in 128-key boxes, Q, dO in kBQ-row boxes
  CUtensorMap rq, rdo, rk, rv, cq, cdo, ck, cv;
  if (!tensor_map(encode, &rq, q, D, H, Sq, B, kBQ) ||
      !tensor_map(encode, &rdo, dO, D, H, Sq, B, kBQ) ||
      !tensor_map(encode, &rk, k, D, KV, Sk, B, QL::kBK) ||
      !tensor_map(encode, &rv, v, D, KV, Sk, B, QL::kBK) ||
      !tensor_map(encode, &cq, q, D, H, Sq, B, KL::kBQ) ||
      !tensor_map(encode, &cdo, dO, D, H, Sq, B, KL::kBQ) ||
      !tensor_map(encode, &ck, k, D, KV, Sk, B, kBKV) ||
      !tensor_map(encode, &cv, v, D, KV, Sk, B, kBKV))
    return kErrTensorMap;
  static bool opted_in = false;  // one attribute set per instantiation
  if (!opted_in) {
    cudaError_t err = opt_in(bwd_rows_kernel<D, false>, QL::kSmem);
    if (err == cudaSuccess) err = opt_in(bwd_rows_kernel<D, true>, QL::kSmem);
    if (err == cudaSuccess) err = opt_in(bwd_dkdv_kernel<D>, KL::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  const dim3 prep_grid(static_cast<unsigned>(n_rows));
  const dim3 dkdv_grid(static_cast<unsigned>(n_keys));
  const dim3 dq_grid(static_cast<unsigned>(n_rows + n_sum));
  bwd_rows_kernel<D, false><<<prep_grid, kThreads, QL::kSmem, st>>>(
      rq, rdo, rk, rv, lse, delta, nullptr, nullptr, nullptr, nullptr, B, Sq,
      Sk, H, KV, n_split, static_cast<int>(n_rows), scale, causal, window,
      cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<D><<<dkdv_grid, kThreads, KL::kSmem, st>>>(
      ck, cv, cq, cdo, lse, delta, dkb, dvb, part, B, Sq, Sk, H, KV, n_split,
      scale, causal, window, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_rows_kernel<D, true><<<dq_grid, kThreads, QL::kSmem, st>>>(
      rq, rdo, rk, rv, lse, delta, dqb, part, dkb, dvb, B, Sq, Sk, H, KV,
      n_split, static_cast<int>(n_rows), scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Contiguous bfloat16 device buffers, 16-byte aligned: q, dO, dq
// (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D); lse and delta float32
// scratch (B H, Sq_pad), Sq_pad = Sq rounded up to 128; part float32
// scratch (2, n_split, B, Sk, KV, D) when n_split > 1 (else unused, may
// be null).  H % KV == 0, (H / KV) % n_split == 0, D one of 16, 64, 112,
// 128, 256; smem_q and smem_k (bytes) as kernel.py::bwd_wgmma_plan gives
// them, which must equal QLayout<D>::kSmem and KLayout<D>::kSmem (the
// launch is refused otherwise); scale = 1 / sqrt(D); window 0 = none;
// cap 0 = no soft-cap.  Three launches on `stream`; returns 0 when all
// three launched, else a cudaError_t or one of the kErr codes
// (flash_bwd_wgmma_error_string).
int flash_attention_bwd_wgmma_bf16(const void* q, const void* k,
                                   const void* v, const void* dO, void* dq,
                                   void* dk, void* dv, void* lse, void* delta,
                                   void* part, int B, int Sq, int Sk, int H,
                                   int KV, int D, int n_split, float scale,
                                   int causal, int window, float cap,
                                   int smem_q, int smem_k, void* stream) {
  switch (D) {
#define FLASH_BWD_WGMMA_CASE(d)                                             \
  case d:                                                                   \
    return launch<d>(q, k, v, dO, dq, dk, dv, static_cast<float*>(lse),     \
                     static_cast<float*>(delta), static_cast<float*>(part), \
                     B, Sq, Sk, H, KV, n_split, scale, causal, window, cap, \
                     smem_q, smem_k, stream);
    FLASH_BWD_WGMMA_CASE(16)
    FLASH_BWD_WGMMA_CASE(64)
    FLASH_BWD_WGMMA_CASE(112)
    FLASH_BWD_WGMMA_CASE(128)
    FLASH_BWD_WGMMA_CASE(256)
#undef FLASH_BWD_WGMMA_CASE
    default:
      return kErrHeadDim;
  }
}

const char* flash_bwd_wgmma_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head dim not built (16, 64, 112, 128, 256)";
    case kErrSmem:
      return "shared memory bytes differ from the kernels' layouts";
    case kErrEntryPoint:
      return "cuTensorMapEncodeTiled not found in libcuda";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrSplit:
      return "n_split must divide H / KV, with partial scratch when > 1";
    case kErrGrid: return "too many blocks for a grid";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
