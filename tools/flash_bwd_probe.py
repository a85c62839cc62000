"""Time the bfloat16 flash-attention backward on one NVIDIA card: each of
its three launches, variants of its plan, and the kernel it replaced.

    python3 tools/flash_bwd_probe.py [--only NAME ...] [--old-kernel PATH]
                                     [--against PATH]

- ``launches``: at each shape of ``SHAPES`` (chip_smoke's timed
  backward shapes), the device ms of the prep, dkdv and dq kernels of
  one ``flash_attention_bwd_wgmma`` call, from ``torch.profiler``'s
  kernel sums over ``REPS`` calls, beside the whole call's device ms
  (CUDA events).
- ``variants``: the source (``csrc/flash_attention_bwd_wgmma.cu``) with
  its plan edited (``VARIANTS``: stages of either ring, query rows a
  dkdv tile), built beside the kernel's own library
  under ``kernels/_build/`` and called through ctypes with the shared
  bytes of the edited layouts, at StarCoder2-3B's training shape and at
  Zamba2-7B's; each checked bitwise against the shipped kernel's
  gradients where only the pipeline changed, and at 5e-3 relative norm
  against the plain float32 autograd gradients where the tiles changed
  (a variant that fails is reported and not timed).
- ``split``: every head split the launcher takes (a divisor of the
  group's G) at StarCoder2-3B's training shape, ``bwd_wgmma_split``'s
  pick marked.
- ``--old-kernel PATH``: the CUDA-core kernel this one replaced (the
  bfloat16 instantiation of ``csrc/flash_attention_bwd.cu`` of an earlier
  commit: ``git show 186bba8:src/repro_torch/kernels/flash_attention/``
  ``csrc/flash_attention_bwd.cu > PATH``) timed in turns with the
  shipped kernel (old, new, new, old) at StarCoder2-3B's shape.
- ``--against PATH``: another version of ``flash_attention_bwd_wgmma.cu``
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
SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc" \
    / "flash_attention_bwd_wgmma.cu"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def inputs(B, Sq, Sk, H, KV, D, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda").bfloat16()
                 for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D),
                           (B, Sq, H, D)))


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


def launches_phase():
    from torch.profiler import ProfilerActivity, profile
    for label, shape, causal, window, cap in SHAPES:
        q, k, v, do = inputs(*shape)

        def call():
            return fa.flash_attention_bwd_wgmma(q, k, v, do, causal=causal,
                                                window=window, softcap=cap)
        total = device_ms(call)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                call()
            torch.cuda.synchronize()
        parts = {"prep": 0.0, "dkdv": 0.0, "dq": 0.0}
        for e in prof.key_averages():
            name = e.key
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            if "bwd_dkdv_kernel" in name:
                parts["dkdv"] += us
            elif "bwd_rows_kernel" in name:
                parts["dq" if re.search(r"Lb1E|, true>", name)
                      else "prep"] += us
        print(f"launches {label} {shape} causal={causal} window={window} "
              f"cap={cap}: call device_ms={total!r}; "
              + " ".join(f"{k}_ms={v / 1e3 / REPS!r}"
                         for k, v in parts.items()), flush=True)
        del q, k, v, do


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


def old_phase(path):
    label, shape, causal, window, cap = SHAPES[0]
    q, k, v, do = inputs(*shape)
    B, Sq, Sk, H, KV, D = shape
    lib_path, = build_libraries([Path(path)])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = bind(lib_path, {"flash_attention_bwd_bf16": [P] * 10 + [I] * 6
                          + [F, I, I, F, I, P]}, "flash_bwd_error_string")
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    delta = torch.empty_like(lse)
    out = [torch.empty_like(t) for t in (q, k, v)]

    def old():
        rc = lib.flash_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), 0, do.data_ptr(),
            *(t.data_ptr() for t in out), lse.data_ptr(), delta.data_ptr(),
            B, Sq, Sk, H, KV, D, 1.0 / math.sqrt(D), int(causal),
            int(window), float(cap), fa.bwd_plan(D).smem_bytes,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, lib.flash_bwd_error_string(rc)

    def new():
        fa.flash_attention_bwd_wgmma(q, k, v, do, causal=causal,
                                     window=window, softcap=cap)
    times = [("old", device_ms(old, 3)), ("new", device_ms(new)),
             ("new", device_ms(new)), ("old", device_ms(old, 3))]
    print(f"old kernel against new, {label} {shape}: "
          + ", ".join(f"{n} {t!r} ms" for n, t in times), flush=True)


def against_phase(path):
    lib_path, = build_libraries([Path(path)])
    lib = bind(lib_path, fa._BWD_WGMMA_FUNCTIONS, fa._BWD_WGMMA_ERROR)
    same = True
    for label, shape, causal, window, cap in SHAPES:
        q, k, v, do = inputs(*shape)
        B, Sq, Sk, H, KV, D = shape
        n_split = fa.bwd_wgmma_split(B, KV, H // KV, Sk, D)
        plan = fa.bwd_wgmma_plan(D)

        def other():
            return call_lib(lib, q, k, v, do, causal, window, cap, n_split,
                            (plan.smem_q, plan.smem_k))

        def new():
            return fa.flash_attention_bwd_wgmma(q, k, v, do, causal=causal,
                                                window=window, softcap=cap)
        equal = all(torch.equal(a, b) for a, b in zip(other(), new()))
        same = same and equal
        times = [("other", device_ms(other)), ("new", device_ms(new)),
                 ("new", device_ms(new)), ("other", device_ms(other))]
        print(f"against {Path(path).name}, {label} {shape}: bitwise equal "
              f"{equal}; " + ", ".join(f"{n} {t!r} ms" for n, t in times),
              flush=True)
        del q, k, v, do
    return same


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="phases (launches, split, variants) or variants")
    ap.add_argument("--old-kernel", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    print(card(), flush=True)
    only = set(args.only or ["launches", "split", "variants"])
    if "launches" in only:
        launches_phase()
    if "split" in only:
        split_phase()
    ok = True
    names = [n for n in VARIANTS if n in only] or (
        list(VARIANTS) if "variants" in only else [])
    if names:
        ok = variants_phase(names)
    if args.old_kernel:
        old_phase(args.old_kernel)
    if args.against:
        ok = against_phase(args.against) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
