"""Time variants of the SSD kernel at Zamba2-7B's prefill shape on one
NVIDIA card: the measurements behind ``ssd_plan``'s kernel chunk and
cluster cap, behind which unit runs which chunk product, and the
breakdown of the kernel's time by phase.

    python3 tools/ssd_variant_probe.py [--only NAME ...]

Each variant is the kernel's source (``csrc/ssd_mma.cu``) with a few
edits, built beside the kernel's own library under ``kernels/_build/``:

- ``shipped``, timed under cluster caps of 1, 2, 4 and 8 blocks, and
  ``cluster16`` (non-portable 16-block clusters): the cap table;
- ``wgmma_state``: the two state-sized products, C·stateᵀ (y_inter) and
  the state update (x·w)ᵀ·B, on ``wgmma`` m64n64k8 TF32 in place of
  ``mma.sync``, three passes each, A split in registers and the B
  operands split ahead of time into K-major core matrices in shared
  memory (Bᵀ staged transposed, the state's hi and lo parts): ~16 KB
  more a block, three blocks an SM where four run.  Written for the
  prefill's widths (P = N = 64) only;
- kernel chunks of 128 steps on 8 warps and of 32 on 2 (the shipped one
  takes 64 on 4);
- the shipped kernel with one phase left out (y_intra, y_inter, the
  state update, the scan between chunks, the staging of x, B and C) or
  with one TF32 pass in place of three.

The variants that leave work out compute wrong values and are timed
only; the others are checked against ``ssd_chunked_plain`` at 1e-3 (a
variant that fails its check is reported and not timed).  Prints the
card's name and power limit, then one line per variant: device ms per
launch (float32, b 4, L 2048, H 112, P = N = 64, model chunk 128) under
each cap it is timed at, the clusters the card keeps resident
(``cudaOccupancyMaxActiveClusters``) and ptxas' register and spill
report.  Exits non-zero without a CUDA device or when a checked variant
disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (adds src/ to the path)
from repro_torch.kernels.build import BUILD_DIR, bind  # noqa: E402
from repro_torch.kernels.build import build_libraries, launch  # noqa: E402
from repro_torch.kernels.ssd import kernel  # noqa: E402
from repro_torch.models.mamba2 import ssd_chunked_plain  # noqa: E402

WARPS = "constexpr int kWarps = 4;"
PHASES = {   # variant -> (text of the shipped source, its replacement)
    "no_intra": ("      if (has_tile) {\n        float acc[kNT][4];",
                 "      if (false) {\n        float acc[kNT][4];"),
    "no_inter": ("      if (has_tile) {\n        const float ea",
                 "      if (false) {\n        const float ea"),
    "no_state": ("const int jmax = round_up(q, 8);", "const int jmax = 0;"),
    "no_scan": ("for (int gi = lo + threadIdx.x; gi < hi;",
                "for (int gi = hi + threadIdx.x; gi < hi;"),
    "one_pass": ("  if constexpr (!kExactA) mma(d, al, bh);\n"
                 "  if constexpr (!kExactB) mma(d, ah, bl);\n", ""),
}

# every variant exports the card's resident clusters for its kernel
OCCUPANCY = r"""
extern "C" int ssd_probe_max_clusters(int P, int N, int Q, int cluster,
                                      int* out) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(attr, 1, cluster, 4 * smem_floats(P, N, Q), nullptr);
  *out = 0;
  cudaError_t err = prepare<float>(cfg, cluster);
  if (err != cudaSuccess && err != cudaErrorLaunchOutOfResources)
    return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, ssd_mma_kernel<float>, &cfg));
}
"""

CLUSTER16 = [
    ("constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 16;"),
    ("        default:\n          scan<kMaxCluster>(",
     "        case 8:\n          scan<8>(cluster, s_c, s_decay, n_act, PN, "
     "N, sN, seg, fin_row,\n                  init_row, v4);\n"
     "          break;\n        default:\n          scan<kMaxCluster>("),
    ("  if (err != cudaSuccess) return err;\n  int clusters = 0;",
     "  if (err != cudaSuccess) return err;\n  err = cudaFuncSetAttribute("
     "kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
     "  if (err != cudaSuccess) return err;\n  int clusters = 0;"),
]

# --- the wgmma variant of the two state-sized products ----------------
WGMMA_HELPERS = r"""
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// no-swizzle (interleaved) descriptor: core matrices of 8 rows x 16
// bytes; lbo steps along K, sbo along the 8-row groups
__device__ __forceinline__ uint64_t kdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void pin32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// keeps A fragments live until the wgmma that reads them has completed
template <int K>
__device__ __forceinline__ void keep(const uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(a[k][i]) : "memory");
}
// d (64 x 64) += a (64 x 8, registers) b (8 x 64, K-major shared memory)
__device__ __forceinline__ void wg64(float (&d)[32], const uint32_t (&a)[4],
                                     uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d += a b in three passes, small terms first
__device__ __forceinline__ void wg64x3(float (&d)[32],
                                       const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint64_t bh,
                                       uint64_t bl) {
  wg64(d, al, bh);
  wg64(d, ah, bl);
  wg64(d, ah, bh);
}

"""

WGMMA_UPDATE = r"""      // B^T as the update's K-major B operand, split: hi over C (its
      // products are done), lo in s_r; core matrices of 8 n by 4 j
      for (int e = tid; e < Np * Qp; e += kThreads) {
        const int nl = e & 7, jl = (e >> 3) & 3, rest = e >> 5;
        const int nh = rest % (Np / 8), jh = rest / (Np / 8);
        const float v = s_b[(4 * jh + jl) * sN + 8 * nh + nl];
        const float hi = __uint_as_float(__float_as_uint(v) & 0xffffe000u);
        const int o = nh * 8 * Qp + jh * 32 + nl * 4 + jl;
        s_c[o] = hi;
        s_r[o] = v - hi;
      }
      fence_async();
      __syncthreads();  // B is done: C comes back over it
      stage<T>(s_b, sN, Qp, Np, Cg + bc0 * N, bc_step, q, N, vec != 0);
      cp_async_commit();
      {
        // S_c (P x N) = (x w)^T (P x Q) B (Q x N): A rows p = 16 warp + g
        // (+ 8), columns j, split in registers
        const int ksteps = round_up(q, 8) / 8;
        uint32_t ah[8][4], al[8][4];
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int j = 8 * ks + t4;
          const float wa = s_w[j], wb = s_w[j + 4];
          const float* xr = s_x + j * sX + 16 * warp + g;
          split(xr[0] * wa, ah[ks][0], al[ks][0]);
          split(xr[8] * wa, ah[ks][1], al[ks][1]);
          split(xr[4 * sX] * wb, ah[ks][2], al[ks][2]);
          split(xr[4 * sX + 8] * wb, ah[ks][3], al[ks][3]);
        }
        float d[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.0f;
        const uint32_t bh0 = smem_u32(s_c), bl0 = smem_u32(s_r);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          if (ks < ksteps) {
            wg64x3(d, ah[ks], al[ks], kdesc(bh0 + 256 * ks, 128, 32 * Qp),
                   kdesc(bl0 + 256 * ks, 128, 32 * Qp));
          }
        }
        wg_commit();
        wg_wait();
        keep(ah);
        keep(al);
        pin32(d);
        __syncthreads();  // every product has read B^T: S_c goes over it
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 16 * warp + g + 8 * (e >> 1);
            const int n = 8 * jt + 2 * t4 + (e & 1);
            s_c[(p >> 3) * 8 * Np + (n >> 2) * 32 + (p & 7) * 4 + (n & 3)] =
                d[4 * jt + e];
          }
      }
    }

"""

WGMMA_INTER = r"""      // the state before the chunk as y_inter's K-major B operand (core
      // matrices of 8 p by 4 n): hi over the value, lo in s_r
      for (int i = tid; i < Pp * Np; i += kThreads) {
        const float v = s_c[i];
        const float hi = __uint_as_float(__float_as_uint(v) & 0xffffe000u);
        s_c[i] = hi;
        s_r[i] = v - hi;
      }
      fence_async();
      __syncthreads();
      {
        // y_inter (Q x P) = (exp(a_cum) C) (Q x N) state^T (N x P)
        const float ea = s_e[ia], eb = s_e[ib];
        uint32_t ah[8][4], al[8][4];
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const float* cr = s_b + ia * sN + 8 * ks + t4;
          split(cr[0] * ea, ah[ks][0], al[ks][0]);
          split(cr[8 * sN] * eb, ah[ks][1], al[ks][1]);
          split(cr[4] * ea, ah[ks][2], al[ks][2]);
          split(cr[8 * sN + 4] * eb, ah[ks][3], al[ks][3]);
        }
        float d[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.0f;
        const uint32_t bh0 = smem_u32(s_c), bl0 = smem_u32(s_r);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          wg64x3(d, ah[ks], al[ks], kdesc(bh0 + 256 * ks, 128, 32 * Np),
                 kdesc(bl0 + 256 * ks, 128, 32 * Np));
        wg_commit();
        wg_wait();
        keep(ah);
        keep(al);
        pin32(d);
        float acc[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = d[4 * nt + e];
        put_y<true>(acc, y_chunk, x_step, i0, 0, q, P);
      }
"""

WGMMA_STATE = [
    ("constexpr int kMinBlocks = 16 / kWarps;",
     "constexpr int kMinBlocks = 3;"),
    ("// x (b, L, H, P), B/C (b, L, G, N) of type T;",
     WGMMA_HELPERS + "// x (b, L, H, P), B/C (b, L, G, N) of type T;"),
    ("  float* s_dt = s_c + (Qp > Pp ? Qp : Pp) * sN;",
     "  float* s_r = s_c + (Qp > Pp ? Qp : Pp) * sN;\n"
     "  float* s_dt = s_r + (Np * Qp > Pp * Np ? Np * Qp : Pp * Np);"),
    ("         4 * Qp + 2 * kWarps;",
     "         4 * Qp + 2 * kWarps +\n"
     "         (Np * Qp > Pp * Np ? Np * Qp : Pp * Np);"),
    ("    const int off = p * sN + (e - p * N);",
     "    const int n = e - p * N;\n"
     "    const int off =\n"
     "        (p >> 3) * 8 * (sN - 4) + (n >> 2) * 32 + (p & 7) * 4 + (n & 3);"),
]


# the same two products on wgmma with no more shared memory than the
# shipped kernel (four blocks an SM, 128 registers): B^T's lo parts go over
# B once every thread holds its elements in registers (C is staged again
# after the update, not during it), the state's lo parts over x, and the A
# fragments are split in registers four k-steps at a time
WGMMA_FIT_UPDATE = r"""      // B^T as the update's K-major B operand (core matrices of 8 n by
      // 4 j), split: hi over C (its products are done), lo over B
      {
        constexpr int kPer = 64 * 64 / kThreads;  // P = N = Q = 64
        float v[kPer];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int e = tid + r * kThreads;
          const int nl = e & 7, jl = (e >> 3) & 3, nh = (e >> 5) & 7;
          v[r] = s_b[(4 * (e >> 8) + jl) * sN + 8 * nh + nl];
        }
        __syncthreads();  // B is read: its lo parts go over it
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int e = tid + r * kThreads;
          const int nl = e & 7, jl = (e >> 3) & 3, nh = (e >> 5) & 7;
          const int o = nh * 8 * Qp + (e >> 8) * 32 + nl * 4 + jl;
          const float hi =
              __uint_as_float(__float_as_uint(v[r]) & 0xffffe000u);
          s_c[o] = hi;
          s_b[o] = v[r] - hi;
        }
      }
      fence_async();
      __syncthreads();
      {
        // S_c (P x N) = (x w)^T (P x Q) B (Q x N): A rows p = 16 warp + g
        // (+ 8), columns j, split in registers
        const int ksteps = round_up(q, 8) / 8;
        const uint32_t bh0 = smem_u32(s_c), bl0 = smem_u32(s_b);
        float d[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.0f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 8 * (4 * half + k) + t4;
            const float wa = s_w[j], wb = s_w[j + 4];
            const float* xr = s_x + j * sX + 16 * warp + g;
            split(xr[0] * wa, ah[k][0], al[k][0]);
            split(xr[8] * wa, ah[k][1], al[k][1]);
            split(xr[4 * sX] * wb, ah[k][2], al[k][2]);
            split(xr[4 * sX + 8] * wb, ah[k][3], al[k][3]);
          }
          wg_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int ks = 4 * half + k;
            if (ks < ksteps)
              wg64x3(d, ah[k], al[k], kdesc(bh0 + 256 * ks, 128, 32 * Qp),
                     kdesc(bl0 + 256 * ks, 128, 32 * Qp));
          }
          wg_commit();
          wg_wait();
          keep(ah);
          keep(al);
        }
        pin32(d);
        __syncthreads();  // every product has read B^T: S_c goes over it
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 16 * warp + g + 8 * (e >> 1);
            const int n = 8 * jt + 2 * t4 + (e & 1);
            s_c[(p >> 3) * 8 * Np + (n >> 2) * 32 + (p & 7) * 4 + (n & 3)] =
                d[4 * jt + e];
          }
      }
      stage<T>(s_b, sN, Qp, Np, Cg + bc0 * N, bc_step, q, N, vec != 0);
      cp_async_commit();
    }

"""

WGMMA_FIT_INTER = r"""      // the state before the chunk as y_inter's K-major B operand (core
      // matrices of 8 p by 4 n): hi over the value, lo over x (done)
      for (int i = tid; i < Pp * Np; i += kThreads) {
        const float v = s_c[i];
        const float hi = __uint_as_float(__float_as_uint(v) & 0xffffe000u);
        s_c[i] = hi;
        s_x[i] = v - hi;
      }
      fence_async();
      __syncthreads();
      {
        // y_inter (Q x P) = (exp(a_cum) C) (Q x N) state^T (N x P)
        const float ea = s_e[ia], eb = s_e[ib];
        const uint32_t bh0 = smem_u32(s_c), bl0 = smem_u32(s_x);
        float d[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.0f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float* cr = s_b + ia * sN + 8 * (4 * half + k) + t4;
            split(cr[0] * ea, ah[k][0], al[k][0]);
            split(cr[8 * sN] * eb, ah[k][1], al[k][1]);
            split(cr[4] * ea, ah[k][2], al[k][2]);
            split(cr[8 * sN + 4] * eb, ah[k][3], al[k][3]);
          }
          wg_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int ks = 4 * half + k;
            wg64x3(d, ah[k], al[k], kdesc(bh0 + 256 * ks, 128, 32 * Np),
                   kdesc(bl0 + 256 * ks, 128, 32 * Np));
          }
          wg_commit();
          wg_wait();
          keep(ah);
          keep(al);
        }
        pin32(d);
        float acc[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = d[4 * nt + e];
        put_y<true>(acc, y_chunk, x_step, i0, 0, q, P);
      }
"""


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise AssertionError(f"the kernel source has {src.count(old)} of "
                             f"{old!r}, not one")
    return src.replace(old, new)


def _between(src: str, start: str, end: str, new: str) -> str:
    """``src`` with the text from ``start`` up to ``end`` replaced."""
    a = src.index(start)
    return src[:a] + new + src[src.index(end, a):]


def _wgmma_state(src: str) -> str:
    for old, new in WGMMA_STATE:
        src = _edit(src, old, new)
    src = _between(src, "      // S_c[p][n] = sum_j x_j[p] w_j B_j[n]",
                   "    // the state before each chunk of the segment",
                   WGMMA_UPDATE)
    src = _between(src, "      // y_inter: y_i += exp(a_cum_i)",
                   "      __syncthreads();  // the next segment restages",
                   WGMMA_INTER)
    return src


def _wgmma_fit(src: str) -> str:
    for old, new in WGMMA_STATE[1:2] + WGMMA_STATE[4:]:
        src = _edit(src, old, new)
    src = _between(src, "      // S_c[p][n] = sum_j x_j[p] w_j B_j[n]",
                   "    // the state before each chunk of the segment",
                   WGMMA_FIT_UPDATE)
    src = _between(src, "      // y_inter: y_i += exp(a_cum_i)",
                   "      __syncthreads();  // the next segment restages",
                   WGMMA_FIT_INTER)
    return src


def _variants(src: str) -> dict:
    """name -> (source, kernel chunk, warps, extra shared floats, caps,
    checked against the plain)."""
    big = 64 * 64    # the wgmma variant's s_r at P = N = Qp = 64
    out = {"shipped": (src, 64, 4, 0, (1, 2, 4, 8), True)}
    c16 = src
    for old, new in CLUSTER16:
        c16 = _edit(c16, old, new)
    out["cluster16"] = (c16, 64, 4, 0, (16,), True)
    out["wgmma_state"] = (_wgmma_state(src), 64, 4, big, (8,), True)
    out["wgmma_state_fit"] = (_wgmma_fit(src), 64, 4, 0, (8,), True)
    out["chunk128_8warps"] = (_edit(src, WARPS, WARPS.replace("4", "8")),
                              128, 8, 0, (8,), True)
    out["chunk32_2warps"] = (_edit(src, WARPS, WARPS.replace("4", "2")),
                             32, 2, 0, (8,), True)
    for name, (old, new) in PHASES.items():
        out[name] = (_edit(src, old, new), 64, 4, 0, (8,), False)
    out["one_pass"] = (_edit(out["one_pass"][0],
                             "  if constexpr (!kExactA) mma(dl, al, bh);\n"
                             "  if constexpr (!kExactB) mma(dl, ah, bl);\n",
                             ""),
                       64, 4, 0, (8,), False)
    staged = src
    for arr in ("s_x, sX,", "s_b, sN, Qp, Np, Bg", "s_c, sN,",
                "s_b, sN, Qp, Np, Cg"):
        staged = _edit(staged, f"      stage<T>({arr}",
                       f"      if (false) stage<T>({arr}")
    out["no_stage"] = (staged, 64, 4, 0, (8,), False)
    return {name: (s + OCCUPANCY, *rest) for name, (s, *rest) in out.items()}


def _smem(P: int, N: int, steps: int, warps: int, extra: int) -> int:
    """kernel.ssd_smem_bytes for a block of ``warps`` warps and ``extra``
    more floats."""
    return kernel.ssd_smem_bytes(P, N, steps) + 4 * (2 * warps - 8 + extra)


def _ptxas(path) -> str:
    """ptxas' registers and spill stores of the float32 kernel."""
    lines = path.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "ssd_mma_kernelIfE" in line and "Compiling" in line:
            rest = " ".join(lines[i + 1:i + 4])
            try:
                regs = rest.split("Used ")[1].split(" registers")[0]
                spill = rest.split(" bytes spill stores")[0].split()[-1]
            except IndexError:
                break
            return f"{regs} registers, {spill} bytes spill stores"
    return "no ptxas report"


def _bf16(lib, smem: int):
    """(device ms, max abs error against the plain version, whether it
    holds 1e-3) of the shipped kernel on bfloat16 x, B, C at the prefill
    shape, cluster 8."""
    b, L, H, P, G, N, Q = chip_smoke.SSD_ZAMBA
    x, dt, A, B, C = chip_smoke._ssd_inputs(b, L, H, P, G, N, torch.bfloat16)
    want_y, want_s = ssd_chunked_plain(x, dt, A, B, C, Q)
    y = torch.empty_like(want_y)
    fin = torch.empty_like(want_s)

    def run():
        launch(lib, "ssd_mma_bf16", kernel._ERROR, x.device, x.data_ptr(),
               dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
               None, y.data_ptr(), fin.data_ptr(), b * H, L, H, P, G, N, 64,
               8, smem)
    run()
    torch.cuda.synchronize()
    err = max(float((y - want_y).abs().max()),
              float((fin - want_s).abs().max()))
    ok = (torch.allclose(y, want_y, atol=1e-3, rtol=1e-3)
          and torch.allclose(fin, want_s, atol=1e-3, rtol=1e-3))
    return chip_smoke._device_ms(run, 10), err, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", help="run only these variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_variant_probe: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card())
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = _variants(kernel.SOURCES["ssd"].read_text())
    if args.only:
        variants = {k: v for k, v in variants.items() if k in args.only}
    folder = BUILD_DIR / "variants"
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, (src, *_) in variants.items():
        path = folder / f"ssd_{name}.cu"
        path.write_text(src)
        paths.append(path)
    libs = build_libraries(paths)
    funcs = {**kernel._FUNCTIONS, "ssd_probe_max_clusters":
             [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]}
    b, L, H, P, G, N, Q = chip_smoke.SSD_ZAMBA
    x, dt, A, B, C = chip_smoke._ssd_inputs(b, L, H, P, G, N, torch.float32)
    want_y, want_s = ssd_chunked_plain(x, dt, A, B, C, Q)
    y = torch.empty_like(want_y)
    fin = torch.empty_like(want_s)
    failed = []
    for (name, (_, steps, warps, extra, caps, checked)), path in zip(
            variants.items(), libs):
        lib = bind(path, funcs, kernel._ERROR)
        smem = _smem(P, N, steps, warps, extra)
        cells = []
        for cap in caps:
            cluster = min(cap, 1 << (-(-L // steps) - 1).bit_length())

            def run():
                launch(lib, "ssd_mma_f32", kernel._ERROR, x.device,
                       x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       B.data_ptr(), C.data_ptr(), None, y.data_ptr(),
                       fin.data_ptr(), b * H, L, H, P, G, N, steps, cluster,
                       smem)
            y.fill_(float("nan"))
            run()
            torch.cuda.synchronize()
            if checked:
                err = max(float((y - want_y).abs().max()),
                          float((fin - want_s).abs().max()))
                ok = (torch.allclose(y, want_y, atol=1e-3, rtol=1e-3)
                      and torch.allclose(fin, want_s, atol=1e-3, rtol=1e-3))
                if not ok:
                    failed.append(name)
                    cells.append(f"C={cluster}: DISAGREES, max abs err "
                                 f"{err!r}")
                    continue
            resident = ctypes.c_int(0)
            rc = lib.ssd_probe_max_clusters(P, N, steps, cluster,
                                            ctypes.byref(resident))
            cells.append(f"C={cluster}:{chip_smoke._device_ms(run, 10)!r} "
                         f"(resident {resident.value if rc == 0 else rc})")
        print(f"ssd variant {name} (chunk {steps}, {warps} warps, "
              f"{smem} B shared, {_ptxas(path)}"
              f"{', checked' if checked else ', timed only'}) float32 ms "
              "per launch: " + " ".join(cells), flush=True)
        if name == "shipped":
            ms, err, ok = _bf16(lib, smem)
            if not ok:
                failed.append("shipped bf16")
            print(f"ssd variant shipped, bfloat16 x, B, C: ms per launch "
                  f"{ms!r} (C=8), max abs err {err!r}", flush=True)
    if failed:
        print(f"ssd_variant_probe: {failed} disagree with the plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
