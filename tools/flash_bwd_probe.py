"""Time the flash-attention backward kernels on one NVIDIA card: each of
their three launches, variants of their plans, and the kernels they
replaced.

    python3 tools/flash_bwd_probe.py [--only NAME ...] [--old-kernel PATH]
                                     [--against PATH ...]

- ``launches``: at each shape of ``SHAPES`` (chip_smoke's timed
  backward shapes), for each dtype (bfloat16 ``flash_attention_bwd_wgmma``,
  float32 ``flash_attention_bwd_cuda``), the device ms of the prep, dkdv
  and dq kernels of one call, from ``torch.profiler``'s kernel sums over
  ``REPS`` calls, beside the whole call's device ms (CUDA events).
- ``variants``: the bfloat16 source (``csrc/flash_attention_bwd_wgmma.cu``)
  with its plan edited (``VARIANTS``: stages of either ring, query rows a
  dkdv tile), built beside the kernel's own library
  under ``kernels/_build/`` and called through ctypes with the shared
  bytes of the edited layouts, at StarCoder2-3B's training shape and at
  Zamba2-7B's; each checked bitwise against the shipped kernel's
  gradients where only the pipeline changed, and at 5e-3 relative norm
  against the plain float32 autograd gradients where the tiles changed
  (a variant that fails is reported and not timed).
- ``split``: every head split each launcher takes (a divisor of the
  group's G) at StarCoder2-3B's training shape, in both dtypes,
  ``bwd_wgmma_split``'s and ``bwd_split``'s picks marked.
- ``accum``: the float32 source (``csrc/flash_attention_bwd_mma.cu``)
  with ``kStepPartials`` set, each 8 rows' passes of dK, dV and dQ into
  their own partial (the forward's form) in place of each streamed
  tile's, held at 1e-5 relative norm to the plain float32 autograd
  gradients beside the shipped kernel and timed in turns with it
  (shipped, per step, per step, shipped) at every shape of ``SHAPES``.
- ``peak``: the rate of TF32 ``mma.sync.m16n8k8`` alone on this card:
  a kernel of ``PEAK_CHAINS`` independent accumulators a warp issuing
  nothing but the products on fixed register operands, at 4, 8 and 16
  warps an SM, in TFLOP/s beside the 495 TFLOP/s of the data sheet (a
  wgmma figure): the ceiling the float32 kernel's products run under.
- ``--old-kernel PATH``: a kernel these replaced, timed in turns with
  the shipped one (old, new, new, old) at StarCoder2-3B's shape: the
  float32 CUDA-core kernel (``git show 15fe58e:src/repro_torch/kernels/``
  ``flash_attention/csrc/flash_attention_bwd.cu > PATH``) against
  ``flash_attention_bwd_cuda``, or the bfloat16 instantiation of an
  earlier one (``git show 186bba8:...`` of the same file) against
  ``flash_attention_bwd_wgmma``; the source's exported function says
  which.
- ``--against PATH ...``: other versions of either backward source
  (the same C interface and layouts, e.g. an earlier commit's), held
  bitwise to the shipped kernel and timed in turns with it (other, new,
  new, other) at every shape of ``SHAPES``.

Prints the card's name and power limit first.  Exits non-zero without a
CUDA device or when a checked variant disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels.build import BUILD_DIR, bind, build_libraries  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# (label, (B, Sq, Sk, H, KV, D), causal, window, cap)
SHAPES = [("StarCoder2-3B", (2, 2048, 2048, 24, 2, 128), True, 0, 0.0),
          ("Zamba2-7B", (4, 2048, 2048, 32, 32, 112), True, 0, 0.0),
          ("Gemma2-9B local", (2, 6144, 6144, 16, 8, 256), True, 4096, 50.0),
          ("Whisper-large-v3 cross", (8, 224, 1500, 20, 20, 64), False, 0,
           0.0)]
REPS = 10
# name -> (stages of the prep/dq ring, stages of the dkdv ring, keys a
# prep/dq tile at D <= 128, query rows a dkdv tile at D <= 128)
VARIANTS = {"shipped": (2, 2, 64, 64),
            "q_stages3": (3, 2, 64, 64),
            "k_stages3": (2, 3, 64, 64),
            "both_stages3": (3, 3, 64, 64),
            "k_bq32": (2, 2, 64, 32)}
CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
SOURCE = CSRC / "flash_attention_bwd_wgmma.cu"
F32_SOURCE = CSRC / "flash_attention_bwd_mma.cu"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def inputs(B, Sq, Sk, H, KV, D, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D),
                           (B, Sq, H, D)))


def f32_inputs(shape, causal, window, cap):
    """float32 q, k, v, dO and the float32 forward kernel's o."""
    q, k, v, do = inputs(*shape, dtype=torch.float32)
    o = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=cap)
    return q, k, v, o, do


def call_f32(lib, q, k, v, o, do, causal, window, cap, n_split):
    """One call of a float32 backward library (the shipped source's C
    interface) with this head split."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    plan = fa.bwd_plan(D)
    sq_pad = -(-Sq // plan.bq) * plan.bq
    lse = torch.empty((B * H, sq_pad), dtype=torch.float32, device="cuda")
    delta = torch.empty_like(lse)
    part = (torch.empty((2, n_split, B, Sk, KV, D), dtype=torch.float32,
                        device="cuda") if n_split > 1 else None)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rc = lib.flash_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), 0 if part is None else part.data_ptr(), B, Sq, Sk,
        H, KV, D, n_split, 1.0 / math.sqrt(D), int(causal), int(window),
        float(cap), plan.smem_prep, plan.smem_dq, plan.smem_kv,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(lib.flash_bwd_error_string(rc).decode())
    return dq, dk, dv


def device_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def rel_norms(got, q, k, v, do, causal, window, cap):
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    o = attention_ref(qf, kf, vf, causal=causal, window=window, softcap=cap)
    want = torch.autograd.grad(o, (qf, kf, vf), do.float())
    return [float((g.float() - w).norm() / w.norm())
            for g, w in zip(got, want)]


# the kernels of each dtype's call by launch: (name in the profile, launch)
KERNELS = {torch.bfloat16: (("bwd_dkdv_kernel", "dkdv"),
                            ("bwd_rows_kernel", None)),
           torch.float32: (("bwd_prep_kernel", "prep"),
                           ("bwd_dkdv_kernel", "dkdv"),
                           ("bwd_dq_kernel", "dq"))}


PEAK_CHAINS, PEAK_STEPS = 8, 4096
PEAK_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void peak_kernel(float* out, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + i + 1);
  for (int i = 0; i < 2; ++i) b[i] = seed * (threadIdx.x + i + 7);
  float d[CHAINS][4] = {};
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  float sum = 0.0f;
  for (int c = 0; c < CHAINS; ++c)
    sum += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}
extern "C" int peak(void* out, int blocks, int threads, void* stream) {
  peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), 3u);
  return static_cast<int>(cudaGetLastError());
}
extern "C" const char* peak_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def peak_phase():
    """TF32 mma.sync m16n8k8 alone: PEAK_CHAINS independent accumulators
    a warp, PEAK_STEPS steps, one block of 4, 8 or 16 warps an SM."""
    vdir = BUILD_DIR / "bwd_variants"
    vdir.mkdir(parents=True, exist_ok=True)
    path = vdir / "mma_tf32_peak.cu"
    path.write_text(PEAK_SOURCE.replace("CHAINS", str(PEAK_CHAINS))
                    .replace("STEPS", str(PEAK_STEPS)))
    lib_path, = build_libraries([path])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = bind(lib_path, {"peak": [P, I, I, P]}, "peak_error")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for warps in (4, 8, 16):
        out = torch.empty(sms * 32 * warps, device="cuda")

        def call():
            rc = lib.peak(out.data_ptr(), sms, 32 * warps,
                          torch.cuda.current_stream().cuda_stream)
            assert rc == 0, lib.peak_error(rc)
        ms = device_ms(call)
        flops = 2.0 * 16 * 8 * 8 * PEAK_CHAINS * PEAK_STEPS * warps * sms
        print(f"peak TF32 mma.sync m16n8k8: {warps} warps an SM, "
              f"{PEAK_CHAINS} chains a warp: {ms!r} ms, "
              f"{flops / ms / 1e9!r} TFLOP/s ({flops / ms / 1e9 / 495!r} of "
              "495)", flush=True)


def per_launch(call, dtype):
    """Each launch's device ms of ``call`` (one backward of ``dtype``),
    from torch.profiler's kernel sums over REPS calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
    parts = {"prep": 0.0, "dkdv": 0.0, "dq": 0.0}
    for e in prof.key_averages():
        for name, part in KERNELS[dtype]:
            if name not in e.key:
                continue
            if part is None:  # bf16's rows kernel: prep or dq
                part = "dq" if re.search(r"Lb1E|, true>", e.key) else "prep"
            parts[part] += e.device_time_total
    return " ".join(f"{k}_ms={v / 1e3 / REPS!r}" for k, v in parts.items())


def launches_phase():
    for label, shape, causal, window, cap in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32:
                q, k, v, o, do = f32_inputs(shape, causal, window, cap)

                def call():
                    return fa.flash_attention_bwd_cuda(
                        q, k, v, o, do, causal=causal, window=window,
                        softcap=cap)
            else:
                q, k, v, do = inputs(*shape)
                o = None

                def call():
                    return fa.flash_attention_bwd_wgmma(
                        q, k, v, do, causal=causal, window=window,
                        softcap=cap)
            total = device_ms(call)
            print(f"launches {label} {shape} causal={causal} window={window} "
                  f"cap={cap} {str(dtype).split('.')[-1]}: call device_ms="
                  f"{total!r}; " + per_launch(call, dtype), flush=True)
            del q, k, v, o, do


def variant_source(stages_q, stages_k, bk, bqd):
    src = SOURCE.read_text()
    edits = [("  static constexpr int kBK = D <= 128 ? 64 : 32;\n"
              "  static constexpr int kStages = 2;\n",
              f"  static constexpr int kBK = D <= 128 ? {bk} : 32;\n"
              f"  static constexpr int kStages = {stages_q};\n"),
             ("  static constexpr int kBQ = D <= 128 ? 64 : 32;\n"
              "  static constexpr int kStages = 2;\n",
              f"  static constexpr int kBQ = D <= 128 ? {bqd} : 32;\n"
              f"  static constexpr int kStages = {stages_k};\n")]
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def smem(D, stages_q, stages_k, bk, bqd):
    chunks = -(-D // 64)
    bk, bqd = (bk, bqd) if D <= 128 else (32, 32)
    q = (1024 + 2 * chunks * 128 * 128 + stages_q * 2 * chunks * bk * 128
         + 8 * (1 + 2 * stages_q))
    k = (1024 + 2 * chunks * 128 * 128
         + stages_k * (2 * chunks * bqd * 128 + 2 * bqd * 4)
         + 8 * (1 + 2 * stages_k))
    return q, k


def call_lib(lib, q, k, v, do, causal, window, cap, n_split, smem_qk):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    sq_pad = -(-Sq // 128) * 128
    lse = torch.empty((B * H, sq_pad), dtype=torch.float32, device="cuda")
    delta = torch.empty_like(lse)
    part = (torch.empty((2, n_split, B, Sk, KV, D), dtype=torch.float32,
                        device="cuda") if n_split > 1 else None)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rc = lib.flash_attention_bwd_wgmma_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), 0 if part is None else part.data_ptr(), B, Sq, Sk,
        H, KV, D, n_split, 1.0 / math.sqrt(D), int(causal), int(window),
        float(cap), *smem_qk, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(lib.flash_bwd_wgmma_error_string(rc).decode())
    return dq, dk, dv


def load_variants(names):
    """Each variant's library (built together, one nvcc each) and the
    spill bytes ptxas reported for it."""
    vdir = BUILD_DIR / "bwd_variants"
    vdir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name in names:
        path = vdir / f"flash_bwd_wgmma_{name}.cu"
        path.write_text(variant_source(*VARIANTS[name]))
        paths.append(path)
    libs = {}
    for name, lib_path in zip(names, build_libraries(paths)):
        log = lib_path.with_suffix(".log").read_text()
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        libs[name] = (bind(lib_path, fa._BWD_WGMMA_FUNCTIONS,
                           fa._BWD_WGMMA_ERROR), spills)
    return libs


def variants_phase(names):
    ok, libs = True, load_variants(names)
    for label, shape, causal, window, cap in SHAPES[:2]:
        q, k, v, do = inputs(*shape)
        B, Sq, Sk, H, KV, D = shape
        n_split = fa.bwd_wgmma_split(B, KV, H // KV, Sk, D)
        ref = fa.flash_attention_bwd_wgmma(q, k, v, do, causal=causal,
                                           window=window, softcap=cap)
        for name in names:
            params = VARIANTS[name]
            lib, spills = libs[name]
            sm = smem(D, *params)
            got = call_lib(lib, q, k, v, do, causal, window, cap, n_split, sm)
            torch.cuda.synchronize()
            if params[2:] == VARIANTS["shipped"][2:]:
                good = all(torch.equal(a, b) for a, b in zip(got, ref))
                check = f"bitwise equal to the shipped kernel: {good}"
            else:
                rel = rel_norms(got, q, k, v, do, causal, window, cap)
                good = max(rel) <= 5e-3
                check = f"rel_norm_err {max(rel)!r} (bound 5e-3)"
            ms = (device_ms(lambda: call_lib(lib, q, k, v, do, causal, window,
                                             cap, n_split, sm))
                  if good else None)
            ok = ok and good
            print(f"variant {name} {label}: stages prep/dq {params[0]}, dkdv "
                  f"{params[1]}, prep/dq keys a tile {params[2]}, dkdv rows a "
                  f"tile {params[3]}; shared bytes {sm}; spill stores "
                  f"{spills}; {check}; device_ms={ms!r}", flush=True)
        del q, k, v, do
    return ok


def split_phase():
    label, shape, causal, window, cap = SHAPES[0]
    q, k, v, do = inputs(*shape)
    B, Sq, Sk, H, KV, D = shape
    G = H // KV
    pick = fa.bwd_wgmma_split(B, KV, G, Sk, D)
    lib = fa.load_bwd_wgmma_library()
    plan = fa.bwd_wgmma_plan(D)
    ref = call_lib(lib, q, k, v, do, causal, window, cap, 1,
                   (plan.smem_q, plan.smem_k))
    for n in (n for n in range(1, G + 1) if G % n == 0):
        got = call_lib(lib, q, k, v, do, causal, window, cap, n,
                       (plan.smem_q, plan.smem_k))
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, ref))
        ms = device_ms(lambda: call_lib(lib, q, k, v, do, causal, window,
                                        cap, n, (plan.smem_q, plan.smem_k)))
        print(f"split {label} n_split={n}{' (the pick)' if n == pick else ''}"
              f": dkdv blocks {-(-Sk // 128) * B * KV * n}; max abs diff to "
              f"n_split=1 {err!r}; device_ms={ms!r}", flush=True)
    del q, k, v, do
    q, k, v, o, do = f32_inputs(shape, causal, window, cap)
    pick = fa.bwd_split(B, KV, G, Sk, D)
    lib = fa.load_bwd_library()
    ref = call_f32(lib, q, k, v, o, do, causal, window, cap, 1)
    for n in (n for n in range(1, G + 1) if G % n == 0):
        got = call_f32(lib, q, k, v, o, do, causal, window, cap, n)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        ms = device_ms(lambda: call_f32(lib, q, k, v, o, do, causal, window,
                                        cap, n))
        print(f"split float32 {label} n_split={n}"
              f"{' (the pick)' if n == pick else ''}: dkdv blocks "
              f"{-(-Sk // fa.bwd_plan(D).bkv) * B * KV * n}; max abs diff to "
              f"n_split=1 {err!r}; device_ms={ms!r}", flush=True)


def accum_phase():
    """The float32 kernel with per-step partials against the shipped
    per-tile ones: both held to the plain gradients, timed in turns."""
    src = F32_SOURCE.read_text()
    old = "constexpr bool kStepPartials = false;"
    assert src.count(old) == 1
    vdir = BUILD_DIR / "bwd_variants"
    vdir.mkdir(parents=True, exist_ok=True)
    path = vdir / "flash_bwd_mma_step_partials.cu"
    path.write_text(src.replace(old, "constexpr bool kStepPartials = true;"))
    lib_path, = build_libraries([path])
    step = bind(lib_path, fa._BWD_FUNCTIONS, fa._BWD_ERROR)
    shipped = fa.load_bwd_library()
    ok = True
    for label, shape, causal, window, cap in SHAPES:
        q, k, v, o, do = f32_inputs(shape, causal, window, cap)
        B, Sq, Sk, H, KV, D = shape
        n = fa.bwd_split(B, KV, H // KV, Sk, D)
        rel = {}
        for name, lib in (("per tile", shipped), ("per step", step)):
            got = call_f32(lib, q, k, v, o, do, causal, window, cap, n)
            torch.cuda.synchronize()
            rel[name] = max(rel_norms(got, q, k, v, do, causal, window, cap))
            del got
        ok = ok and max(rel.values()) <= 1e-5
        times = []
        for name in ("per tile", "per step", "per step", "per tile"):
            lib = shipped if name == "per tile" else step
            times.append((name, device_ms(lambda: call_f32(
                lib, q, k, v, o, do, causal, window, cap, n))))
        print(f"accum float32 {label} {shape}: rel_norm_err per tile "
              f"{rel['per tile']!r}, per step {rel['per step']!r} (bound "
              "1e-5); " + ", ".join(f"{n_} {t!r} ms" for n_, t in times),
              flush=True)
        del q, k, v, o, do
        torch.cuda.empty_cache()
    return ok


def old_phase(path):
    label, shape, causal, window, cap = SHAPES[0]
    B, Sq, Sk, H, KV, D = shape
    lib_path, = build_libraries([Path(path)])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    raw = ctypes.CDLL(str(lib_path))
    f32 = not hasattr(raw, "flash_attention_bwd_bf16")
    fn = "flash_attention_bwd_f32" if f32 else "flash_attention_bwd_bf16"
    lib = bind(lib_path, {fn: [P] * 10 + [I] * 6 + [F, I, I, F, I, P]},
               "flash_bwd_error_string")
    if f32:
        q, k, v, o, do = f32_inputs(shape, causal, window, cap)
        o_ptr = o.data_ptr()
    else:
        q, k, v, do = inputs(*shape)
        o_ptr = 0
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    delta = torch.empty_like(lse)
    out = [torch.empty_like(t) for t in (q, k, v)]
    # the CUDA-core kernel's dkdv tiles (its kernel.py::bwd_plan): K, V, Q,
    # dO of rows D + 1, P and dS of rows 65, lse and delta, 64 x 64
    smem = 4 * (4 * 64 * (D + 1) + 2 * 64 * 65 + 2 * 64)

    def old():
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_ptr, do.data_ptr(),
            *(t.data_ptr() for t in out), lse.data_ptr(), delta.data_ptr(),
            B, Sq, Sk, H, KV, D, 1.0 / math.sqrt(D), int(causal),
            int(window), float(cap), smem,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, lib.flash_bwd_error_string(rc)

    def new():
        if f32:
            fa.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal,
                                        window=window, softcap=cap)
        else:
            fa.flash_attention_bwd_wgmma(q, k, v, do, causal=causal,
                                         window=window, softcap=cap)
    times = [("old", device_ms(old, 3)), ("new", device_ms(new)),
             ("new", device_ms(new)), ("old", device_ms(old, 3))]
    print(f"old kernel against new ({'float32' if f32 else 'bfloat16'}), "
          f"{label} {shape}: " + ", ".join(f"{n} {t!r} ms" for n, t in times),
          flush=True)


def against_phase(path):
    """Another version of either backward source (its exported function
    says which), bitwise against the shipped kernel and timed in turns."""
    lib_path, = build_libraries([Path(path)])
    log = lib_path.with_suffix(".log").read_text()
    regs = sorted(set(map(int, re.findall(r"Used (\d+) registers", log))))
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
    print(f"against {Path(path).name}: registers {regs}, spill stores "
          f"{spills}", flush=True)
    f32 = hasattr(ctypes.CDLL(str(lib_path)), "flash_attention_bwd_f32")
    lib = (bind(lib_path, fa._BWD_FUNCTIONS, fa._BWD_ERROR) if f32 else
           bind(lib_path, fa._BWD_WGMMA_FUNCTIONS, fa._BWD_WGMMA_ERROR))
    same = True
    for label, shape, causal, window, cap in SHAPES:
        B, Sq, Sk, H, KV, D = shape
        if f32:
            q, k, v, o, do = f32_inputs(shape, causal, window, cap)
            n_split = fa.bwd_split(B, KV, H // KV, Sk, D)

            def other():
                return call_f32(lib, q, k, v, o, do, causal, window, cap,
                                n_split)

            def new():
                return fa.flash_attention_bwd_cuda(
                    q, k, v, o, do, causal=causal, window=window,
                    softcap=cap)
        else:
            q, k, v, do = inputs(*shape)
            o = None
            n_split = fa.bwd_wgmma_split(B, KV, H // KV, Sk, D)
            plan = fa.bwd_wgmma_plan(D)

            def other():
                return call_lib(lib, q, k, v, do, causal, window, cap,
                                n_split, (plan.smem_q, plan.smem_k))

            def new():
                return fa.flash_attention_bwd_wgmma(
                    q, k, v, do, causal=causal, window=window, softcap=cap)
        equal = all(torch.equal(a, b) for a, b in zip(other(), new()))
        same = same and equal
        times = [("other", device_ms(other)), ("new", device_ms(new)),
                 ("new", device_ms(new)), ("other", device_ms(other))]
        dtype = torch.float32 if f32 else torch.bfloat16
        print(f"against {Path(path).name}, {label} {shape}: bitwise equal "
              f"{equal}; " + ", ".join(f"{n} {t!r} ms" for n, t in times)
              + f"; other {per_launch(other, dtype)}; new "
              f"{per_launch(new, dtype)}", flush=True)
        del q, k, v, o, do
        torch.cuda.empty_cache()
    return same


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="phases (launches, split, peak, accum, "
                    "variants) or "
                    "variants")
    ap.add_argument("--old-kernel", default=None)
    ap.add_argument("--against", nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    print(card(), flush=True)
    only = set(args.only or ["launches", "split", "peak", "accum",
                             "variants"])
    if "launches" in only:
        launches_phase()
    if "split" in only:
        split_phase()
    if "peak" in only:
        peak_phase()
    ok = accum_phase() if "accum" in only else True
    names = [n for n in VARIANTS if n in only] or (
        list(VARIANTS) if "variants" in only else [])
    if names:
        ok = variants_phase(names) and ok
    if args.old_kernel:
        old_phase(args.old_kernel)
    build_libraries([Path(path) for path in args.against])  # together
    for path in args.against:
        ok = against_phase(path) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
