// Flash attention (forward) in float32 for Hopper (sm_90a) on CUDA
// cores: GQA, causal mask, sliding window, tanh logit soft-cap, online
// softmax in float32.  bfloat16 inputs go to the tensor-core kernel of
// flash_attention_wgmma.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention (body _fa_kernel), the fused form of models/
// attention.py::_sdpa_chunked:
//
//     s     = (q . k) / sqrt(D),  soft-capped cap tanh(s / cap) if cap > 0
//     s     = -1e30 where kpos >= Sk, or causal and qpos < kpos, or
//             window > 0 and qpos - kpos >= window
//     m_new = max(m, rowmax s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//     l     = l alpha + rowsum p;  acc = acc alpha + p v;  m = m_new
//     out   = acc / max(l, 1e-30)
//
// with query head h reading KV head h / (H / KV).  The tensors keep the
// model's layout, q (B, Sq, H, D) and k, v (B, Sk, KV, D), so nothing is
// transposed or padded around the launch.
//
// What bounds it on this card: at Zamba2-7B's prefill (S = 2048,
// D = 112, 32 heads, batch 4, causal) a call is ~60 G multiply-adds on
// ~470 MB, so it is operations (1.8 ms at 67 TFLOP/s, the float32 rate
// without TF32, which the port never uses); with the products on CUDA
// cores out of shared memory (two shared loads per multiply-add) the
// shared-memory port bounds it far below that rate.  The design is the
// TPU grid translated: one block per
// (batch * head, block of BQ query rows) walks the key blocks in order,
// since CUDA blocks cannot carry (m, l, acc) across a grid axis.  The
// query block, the accumulator, one key and one value block, the score
// tile and the row statistics live in shared memory as float32 (key rows
// and score rows padded by one value, so no product has a bank
// conflict); BQ and BK are chosen by D (kernel.py::flash_plan) so the
// tile fits, two blocks per SM where possible.  D is a runtime value.
//
// Key blocks wholly above the diagonal (causal) or wholly outside the
// window are skipped: every score in them is masked, and a row that has
// seen a visible key gives a masked score the weight exp(-1e30 - m) = 0,
// so skipping them leaves every row with a visible key unchanged.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int H, int KV, int D, int BQ, int BK, float scale,
                 int causal, int window, float cap) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int sk = D + 1;   // padded key rows
  const int ss = BK + 1;  // padded score rows

  float* s_q = smem;              // (BQ, D)
  float* s_acc = s_q + BQ * D;    // (BQ, D)
  float* s_k = s_acc + BQ * D;    // (BK, D + 1)
  float* s_v = s_k + BK * sk;     // (BK, D)
  float* s_s = s_v + BK * D;      // (BQ, BK + 1)
  float* s_m = s_s + BQ * ss;     // (BQ,)
  float* s_l = s_m + BQ;          // (BQ,)
  float* s_alpha = s_l + BQ;      // (BQ,)

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    const int qp = q0 + i;
    s_q[idx] = qp < Sq
        ? q[((static_cast<size_t>(b) * Sq + qp) * H + h) * D + d]
        : 0.0f;
    s_acc[idx] = 0.0f;
  }
  for (int i = tid; i < BQ; i += kThreads) {
    s_m[i] = kNegInf;
    s_l[i] = 0.0f;
  }

  // the key blocks that hold a visible key for some row of this block
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kb_lo = 0;
  int kb_hi = (Sk + BK - 1) / BK;
  if (causal) kb_hi = min(kb_hi, q_last / BK + 1);
  if (window > 0) kb_lo = max(0, q0 - window + 1) / BK;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous block is done with s_k, s_v, s_s
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kp = k0 + j;
      const size_t at = ((static_cast<size_t>(b) * Sk + kp) * KV + kvh) * D + d;
      s_k[j * sk + d] = kp < Sk ? k[at] : 0.0f;
      s_v[idx] = kp < Sk ? v[at] : 0.0f;
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * BK; idx += kThreads) {
      const int i = idx / BK;
      const int j = idx - i * BK;
      const int qp = q0 + i;
      const int kp = k0 + j;
      float dot = 0.0f;
      for (int d = 0; d < D; ++d) dot = dot + s_q[i * D + d] * s_k[j * sk + d];
      float s = dot * scale;
      if (cap > 0.0f) s = cap * tanhf(s / cap);
      bool keep = kp < Sk;
      if (causal) keep = keep && qp >= kp;
      if (window > 0) keep = keep && qp - kp < window;
      s_s[i * ss + j] = keep ? s : kNegInf;
    }
    __syncthreads();
    for (int i = tid; i < BQ; i += kThreads) {  // online softmax, per row
      float mx = kNegInf;
      for (int j = 0; j < BK; ++j) mx = fmaxf(mx, s_s[i * ss + j]);
      const float m_prev = s_m[i];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int j = 0; j < BK; ++j) {
        const float p = expf(s_s[i * ss + j] - m_new);
        s_s[i * ss + j] = p;
        sum = sum + p;
      }
      s_l[i] = s_l[i] * alpha + sum;
      s_m[i] = m_new;
      s_alpha[i] = alpha;
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * D; idx += kThreads) {
      const int i = idx / D;
      const int d = idx - i * D;
      float pv = 0.0f;
      for (int j = 0; j < BK; ++j) pv = pv + s_s[i * ss + j] * s_v[j * D + d];
      s_acc[idx] = s_acc[idx] * s_alpha[i] + pv;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    const int qp = q0 + i;
    if (qp < Sq)
      o[((static_cast<size_t>(b) * Sq + qp) * H + h) * D + d] =
          s_acc[idx] / fmaxf(s_l[i], 1e-30f);
  }
}

}  // namespace

extern "C" {

// Contiguous float32 device buffers: q and o (B, Sq, H, D), k and v
// (B, Sk, KV, D), H % KV == 0.  BQ, BK and smem (bytes) as
// kernel.py::flash_plan gives them; scale = 1 / sqrt(D); window 0 = none;
// cap 0 = no soft-cap.  Enqueued on `stream`; returns the cudaError_t of
// the launch (0 = launched).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int KV, int D, int BQ,
                        int BK, float scale, int causal, int window,
                        float cap, int smem, void* stream) {
  if (static_cast<size_t>(smem) > kDefaultSmem) {  // opt in above 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV, D,
      BQ, BK, scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
