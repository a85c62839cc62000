// Flash attention (forward) in bfloat16 on Hopper's tensor cores (sm_90a):
// GQA, causal mask, sliding window, tanh logit soft-cap; products on
// wgmma with float32 accumulation, operands brought by TMA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention (body _fa_kernel, pallas_call at :95) for bfloat16
// inputs; float32 inputs go to the TF32 mma.sync kernel of
// flash_attention_mma.cu.  The function is the same:
//
//     s     = (q . k) / sqrt(D),  soft-capped cap tanh(s / cap) if cap > 0
//     s     = -1e30 where kpos >= Sk, or causal and qpos < kpos, or
//             window > 0 and qpos - kpos >= window
//     m_new = max(m, rowmax s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//     l     = l alpha + rowsum p;  acc = acc alpha + p v;  m = m_new
//     out   = acc / max(l, 1e-30), in bfloat16
//
// with query head h reading KV head h / (H / KV), q (B, Sq, H, D) and
// k, v (B, Sk, KV, D) in the model's layout: nothing is transposed or
// padded around the launch.  The softmax runs in base 2 (log2 e folded
// into the scale), and p is rounded to bfloat16 before p v, as the
// tensor cores take it.
//
// What bounds it on this card: at Zamba2-7B's prefill (B 4, S 2048, 32
// heads, D 112, causal) the visible (query, key) pairs need ~120 G
// operations on ~235 MB, so the tensor cores' bf16 rate bounds it:
// 0.122 ms at 989 TFLOP/s.  The design does what keeps the tensor cores
// fed in the simple form of the Hopper kernel:
//
// - One block per (batch * head, 128 query rows), the heaviest causal
//   query blocks first (blockIdx.y counts down), three warpgroups:
//   two consumers of 64 query rows each and a producer whose one thread
//   starts every load.  The producer gives up registers (setmaxnreg 24)
//   so the consumers hold their accumulators in 240.
// - The producer loads Q once, then K and V tiles of BK keys into a ring
//   of two stages, each with a full and an empty mbarrier.  TMA writes
//   every tile as 64-column chunks of 128-byte rows in the 128-byte
//   swizzle that wgmma reads; a row of D = 112 is two chunks, and the
//   columns past D come in as zeros (the tensor map's innermost extent
//   is D), so neither product needs padding in device memory.  Rows
//   past Sq or Sk come in as zeros too.
// - Each consumer runs S = Q K^T as wgmma m64nBKk16 with both operands
//   in shared memory (K-major), the online softmax in registers on the
//   accumulator's layout (row max and row sum over the four threads of
//   a quad), rounds P to bf16 straight into the register A operand of
//   O += P V, and reads V as TMA wrote it (D contiguous, so the B
//   operand is MN-major: wgmma's transpose flag for B).  O stays in
//   registers, rescaled by alpha there; the last step divides by l and
//   stores bf16 pairs, skipping rows past Sq.
// - Key tiles wholly masked (above the diagonal, outside the window) are
//   not loaded.  Only tiles that cut the diagonal, the window's edge or
//   Sk test each score: zero-filled key rows score 0, not -1e30, so the
//   kpos < Sk test stays.
//
// The plan is fixed by D (kernel.py::wgmma_plan, the same layout as
// Layout<D> here): BQ 128; BK 128 up to D = 128 and 64 at D = 256 (whose
// O accumulator alone is 128 floats a thread); two stages.  Not done
// here: ping-pong scheduling of the two consumers and overlap of one
// tile's softmax with the other's product.
#include <cuda.h>  // CUtensorMap and its encoder's types; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;        // query rows per block
constexpr int kConsumers = 256;  // two consumer warpgroups of 64 rows
constexpr int kThreads = 384;    // and the producer warpgroup
constexpr int kChunkCols = 64;   // bf16 columns in one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 1024;  // 8 swizzled rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// launch statuses beyond cudaError_t's range
constexpr int kErrHeadDim = 10001;
constexpr int kErrSmem = 10002;
constexpr int kErrEntryPoint = 10003;
constexpr int kErrTensorMap = 10004;

// Shared memory of one block, from a 1024-byte aligned base: Q
// (kChunks x 128 rows x 128 B), then kStages x (K tile, V tile), each
// kChunks x BK rows x 128 B, then the mbarriers (Q full, kStages full,
// kStages empty).  kSmem adds 1024 bytes for aligning the base.
template <int D>
struct Layout {
  static constexpr int kChunks = (D + kChunkCols - 1) / kChunkCols;
  static constexpr int kBK = D <= 128 ? 128 : 64;
  static constexpr int kStages = 2;
  static constexpr int kQChunk = kBQ * kRowBytes;
  static constexpr int kKChunk = kBK * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kTileBytes = kChunks * kKChunk;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmem =
      kAtomBytes + kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(kSmem <= 227 * 1024, "tile does not fit shared memory");
  static_assert(D % 8 == 0, "wgmma N is a multiple of 8");
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

// keeps the compiler from moving an accumulator across an asynchronous
// wgmma: each register is "rewritten" here
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, float32) (+)= A (64 x 16) B (16 x N), bf16 in.  SS: A and
// B K-major in shared memory (S = Q K^T).  RS: A in registers, B
// MN-major in shared memory (O += P V).  The accumulator of a thread in
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
struct WgmmaSS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                   int KV, float scale, int causal, int window, float cap) {
  using L = Layout<D>;
  constexpr int BK = L::kBK;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kAtomBytes - 1) &
                        ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint32_t s_q = base;
  const uint32_t s_ring = base + L::kQBytes;
  const uint32_t bar_q = base + L::kBarOffset;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  // the key tiles that hold a visible key for some row of this block
  int kb_lo = 0;
  int kb_hi = (Sk + BK - 1) / BK;
  if (causal) kb_hi = min(kb_hi, q_last / BK + 1);
  if (window > 0) kb_lo = max(0, q0 - window + 1) / BK;
  const int n_tiles = kb_hi - kb_lo;

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
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(s_q + c * L::kQChunk, &tm_q, bar_q, c * kChunkCols, h, q0,
                 b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // the consumers released this stage's last use
          mbar_wait(bar_empty + 8 * s, ((t / kStages) + 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t s_k = s_ring + s * L::kStageBytes;
        const int k0 = (kb_lo + t) * BK;
        mbar_expect_tx(full, L::kStageBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(s_k + c * L::kKChunk, &tm_k, full, c * kChunkCols, kvh, k0,
                   b);
          tma_load(s_k + L::kTileBytes + c * L::kKChunk, &tm_v, full,
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
    const float scale_log2 = scale * kLog2e;
    const float cap_log2 = cap * kLog2e;
    const float inv_cap = cap > 0.0f ? scale / cap : 0.0f;

    float acc_o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    const uint32_t s_q_wg = s_q + 64 * wg * kRowBytes;

    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = (kb_lo + t) * BK;
      const uint32_t s_k = s_ring + s * L::kStageBytes;
      const uint32_t s_v = s_k + L::kTileBytes;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);

      // S = Q K^T over ceil(D / 16) steps of 16 columns
      float acc_s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < (D + 15) / 16; ++kk) {
        const uint32_t at = (kk % 4) * 32;  // bytes into the chunk's row
        WgmmaSS<BK>::mma(
            acc_s,
            smem_desc(s_q_wg + (kk / 4) * L::kQChunk + at, 16, kAtomBytes),
            smem_desc(s_k + (kk / 4) * L::kKChunk + at, 16, kAtomBytes),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc_s);

      // scores in base 2, masked where this tile cuts the diagonal, the
      // window's edge or Sk; the running row maxima over the quad
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                          (window > 0 && q_last - k0 >= window);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = cap > 0.0f ? cap_log2 * tanhf(acc_s[i] * inv_cap)
                             : acc_s[i] * scale_log2;
        if (masked) {
          const int kpos = k0 + (i / 4) * 8 + col_pair + (i & 1);
          const int qpos = (i & 2) ? row1 : row0;
          bool keep = kpos < Sk;
          if (causal) keep = keep && qpos >= kpos;
          if (window > 0) keep = keep && qpos - kpos < window;
          if (!keep) x = kNegInf;
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

      // P = 2^(S - m), rounded to bf16 into the A operand of P V: the
      // 16 keys of step kk are accumulator blocks 2 kk and 2 kk + 1, and
      // register j holds row (j % 2 ? row1 : row0), block 2 kk + j / 2
      uint32_t p_frag[BK / 16][4];
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          const float m = (j & 1) ? m1 : m0;
          const float p0 = ex2(acc_s[i] - m);
          const float p1 = ex2(acc_s[i + 1] - m);
          if (j & 1)
            sum1 += p0 + p1;
          else
            sum0 += p0 + p1;
          __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
          p_frag[kk][j] = *reinterpret_cast<uint32_t*>(&pk);
        }
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_o[i] *= (i & 2) ? alpha1 : alpha0;

      // O += P V, V read MN-major: 16 keys (2048 bytes) a step, the next
      // 64 columns one chunk (BK rows) on
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<D>::mma(acc_o, p_frag[kk],
                        smem_desc(s_v + kk * 16 * kRowBytes, L::kKChunk,
                                  kAtomBytes),
                        1);
      wgmma_commit();
      wgmma_wait_all();
      pin(acc_o);
      mbar_arrive(bar_empty + 8 * s);
    }

    // each thread's sums cover its own columns: add the quad's
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f);
    const float d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* out0 = o + (static_cast<size_t>(b) * Sq + row0) * H * D +
                          static_cast<size_t>(h) * D + col_pair;
    __nv_bfloat16* out1 = out0 + static_cast<size_t>(8) * H * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
            __floats2bfloat162_rn(acc_o[4 * j] / d0, acc_o[4 * j + 1] / d0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j) =
            __floats2bfloat162_rn(acc_o[4 * j + 2] / d1,
                                  acc_o[4 * j + 3] / d1);
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, float scale, int causal, int window,
           float cap, int smem, void* stream) {
  using L = Layout<D>;
  if (smem != L::kSmem) return kErrSmem;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrEntryPoint;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(encode, &tm_q, q, D, H, Sq, B, kBQ) ||
      !tensor_map(encode, &tm_k, k, D, KV, Sk, B, L::kBK) ||
      !tensor_map(encode, &tm_v, v, D, KV, Sk, B, L::kBK))
    return kErrTensorMap;
  static bool opted_in = false;  // one attribute per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<D><<<grid, kThreads, L::kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV, scale,
      causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Contiguous bfloat16 device buffers, 16-byte aligned: q and o
// (B, Sq, H, D), k and v (B, Sk, KV, D), H % KV == 0, D one of 16, 64,
// 112, 128, 256.  smem (bytes) as kernel.py::wgmma_plan gives it, which
// must equal Layout<D>::kSmem (the launch is refused otherwise); scale =
// 1 / sqrt(D); window 0 = none; cap 0 = no soft-cap.  Enqueued on
// `stream`; returns 0 when launched, else a cudaError_t or one of the
// kErr codes (flash_wgmma_error_string).
int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Sk, int H, int KV,
                               int D, float scale, int causal, int window,
                               float cap, int smem, void* stream) {
  switch (D) {
#define FLASH_WGMMA_CASE(d)                                                  \
  case d:                                                                    \
    return launch<d>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal, window,   \
                     cap, smem, stream);
    FLASH_WGMMA_CASE(16)
    FLASH_WGMMA_CASE(64)
    FLASH_WGMMA_CASE(112)
    FLASH_WGMMA_CASE(128)
    FLASH_WGMMA_CASE(256)
#undef FLASH_WGMMA_CASE
    default:
      return kErrHeadDim;
  }
}

const char* flash_wgmma_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head dim not built (16, 64, 112, 128, 256)";
    case kErrSmem:
      return "shared memory bytes differ from the kernel's layout";
    case kErrEntryPoint:
      return "cuTensorMapEncodeTiled not found in libcuda";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused a tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
