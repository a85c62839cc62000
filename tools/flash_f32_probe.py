"""Time variants of the float32 flash-attention kernel on one NVIDIA
card: the measurements behind ``mma_plan``'s warps, row tiles a warp,
keys per tile and stages for D = 112, and what the extra TF32 passes and
the softmax cost.

    python3 tools/flash_f32_probe.py [--only NAME ...]

Each variant is the kernel's source (``csrc/flash_attention_mma.cu``)
with its plan for D = 112 edited (warps a block, keys per tile BK, K/V
stages in the ring) and launched with one or two 16-row tiles a warp,
built for D = 112 only beside the kernel's own library under
``kernels/_build/``:

- ``w8_r32_bk32_s2`` and ``w8_r16_bk64_s2`` are the two plans
  ``mma_plan`` gives at D = 112 (8 warps of 32 query rows and 32 keys a
  tile where those blocks fill the SMs, else 8 warps of 16 rows and 64
  keys a tile; two stages); the others change warps, rows a warp (16:
  one row tile, which reads each K and V fragment for 16 rows only), BK
  or stages;
- ``one_pass``: the two-tile plan with one TF32 pass in place of three;
- ``no_softmax``: the two-tile plan with the scaling, masking, row max,
  exp and rescaling left out (the raw scores go into P V);
- ``no_fragments``: the two-tile plan with the K and V fragments a
  constant, not read from shared memory and split (Q's still are);
- ``products_only``: both of the last two left out: the products, Q's
  fragments, the loads and the barriers;
- ``no_split``: the K and V fragments read, not split (lo = 0).

Every variant is timed at Zamba2-7B's prefill shape (B 4, S 2048, 32
heads, D 112, causal), the checked ones also at the float32 consistency
prefill's (B 1, S 320), and the two shipped plans over the prompt
lengths of ``SWEEP`` (B 1, 32 heads), where the grid of 256-row blocks
goes from under half the SMs to two of them: where ``mma_plan``'s switch
falls.  The variants that leave work out compute wrong values and are
timed only; the others are checked against the model's chunked plain
version at 2e-5 (a variant that fails its check is reported and not
timed).  Prints the card's name and power limit, then one line per
variant and shape: device ms per launch (float32, causal), its shared
memory and ptxas' register and spill report, and at the sweep's shapes
the plan ``mma_plan`` picks; then torch's
``scaled_dot_product_attention`` in float32 at the prefill shape and the
bound.  ``--old-kernel PATH`` also builds the float32 CUDA-core kernel
this one replaced (``csrc/flash_attention.cu`` of an earlier commit:
``git show f49a582:src/repro_torch/kernels/flash_attention/csrc/``
``flash_attention.cu > PATH``) and times it in turns with the shipped
kernel (old, new, new, old) at the prefill shape and at the consistency
prefill's shape, where the float32 path launches it 13 times per
prefill.  Exits non-zero without a CUDA device or when a checked variant
disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (adds src/ to the path)
from repro_torch.kernels.build import BUILD_DIR, bind  # noqa: E402
from repro_torch.kernels.build import build_libraries, launch  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.models.attention import _sdpa_chunked  # noqa: E402

PLAN = ("  static constexpr int kBK = D <= 64 || (kM == 1 && D <= 128) ? 64 "
        ": 32;\n  static constexpr int kStages = 2;\n")
WARPS = "constexpr int kWarpsFor(int D) { return D <= 128 ? 8 : 4; }"
CASES = ("    FLASH_MMA_CASE(16)\n    FLASH_MMA_CASE(64)\n"
         "    FLASH_MMA_CASE(112)\n    FLASH_MMA_CASE(128)\n"
         "    case 256:\n      if (tiles == 1) FLASH_MMA_LAUNCH(256, 1);\n"
         "      return kErrPlan;\n")
ONE_PASS = ("  mma(d, al, bh);\n  mma(d, ah, bl);\n", "")
# the K and V fragments' splits: (the source's, its operand)
FRAGMENTS = [("split(kr[0], bh[0], bl[0]);", "kr[0]"),
             ("split(kr[4], bh[1], bl[1]);", "kr[4]"),
             ("split(vr[8 * dt], bh[0], bl[0]);", "vr[8 * dt]"),
             ("split(vr[8 * dt + kS], bh[1], bl[1]);", "vr[8 * dt + kS]")]
SOFTMAX = ("    // scores, masked where this tile cuts the diagonal",
           "    // O += P V per 8 keys")
# the old kernel's C entry, and its plan at D = 112 (BQ 64, BK 32)
OLD_FUNCTIONS = {"flash_attention_f32": [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_float,
                                         ctypes.c_int, ctypes.c_void_p]}
OLD_BQ, OLD_BK = 64, 32
CONSISTENCY = chip_smoke.FLASH_CONSISTENCY
# the shipped plans at D = 112: two row tiles a warp where their blocks
# fill the SMs, else one
SHIPPED, SHIPPED_ONE = "w8_r32_bk32_s2", "w8_r16_bk64_s2"
# (B, Sq, Sk, H, KV, D) of the sweep: 2, 3, 4, 6 and 8 256-row blocks of
# 32 heads, 64 to 256 blocks against the H100's 132 SMs
SWEEP = [(1, s, s, 32, 32, 112) for s in (320, 640, 1024, 1536, 2048)]
# name -> (warps, query rows a warp, keys per tile, stages, edit, checked)
TWO = (8, 32, 32, 2)
VARIANTS = {
    "w8_r32_bk32_s2": (*TWO, None, True),
    "w8_r32_bk32_s3": (8, 32, 32, 3, None, True),
    "w8_r32_bk16_s2": (8, 32, 16, 2, None, True),
    "w4_r32_bk32_s2": (4, 32, 32, 2, None, True),
    "w4_r32_bk32_s3": (4, 32, 32, 3, None, True),
    "w4_r32_bk64_s2": (4, 32, 64, 2, None, True),
    "w8_r16_bk64_s2": (8, 16, 64, 2, None, True),
    "w8_r16_bk32_s2": (8, 16, 32, 2, None, True),
    "w4_r16_bk32_s2": (4, 16, 32, 2, None, True),
    "w12_r16_bk32_s2": (12, 16, 32, 2, None, True),
    "w16_r16_bk16_s2": (16, 16, 16, 2, None, True),
    "one_pass": (*TWO, "one_pass", False),
    "no_softmax": (*TWO, "no_softmax", False),
    "no_fragments": (*TWO, "no_fragments", False),
    "products_only": (*TWO, "products_only", False),
    "no_split": (*TWO, "no_split", False),
}


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise AssertionError(f"the kernel source has {src.count(old)} of "
                             f"{old!r}, not one")
    return src.replace(old, new)


def _variant(src: str, warps: int, rows: int, bk: int, stages: int,
             edit) -> str:
    """The source built for D = 112 and ``rows`` query rows a warp only,
    its plan set to ``warps`` warps, ``bk`` keys a tile and ``stages``
    stages."""
    src = _edit(src, PLAN, f"  static constexpr int kBK = {bk};\n"
                f"  static constexpr int kStages = {stages};\n")
    src = _edit(src, WARPS,
                f"constexpr int kWarpsFor(int) {{ return {warps}; }}")
    tiles = rows // 16
    src = _edit(src, CASES, f"    case 112:\n      if (tiles == {tiles}) "
                f"FLASH_MMA_LAUNCH(112, {tiles});\n      return kErrPlan;\n")
    if edit == "one_pass":
        src = _edit(src, *ONE_PASS)
    if edit in ("no_softmax", "products_only"):
        a = src.index(SOFTMAX[0])
        src = src[:a] + src[src.index(SOFTMAX[1], a):]
    for old, operand in FRAGMENTS:
        hi, lo = old[len(f"split({operand}, "):-2].split(", ")
        if edit == "no_split":
            src = _edit(src, old, f"{hi} = __float_as_uint({operand}); "
                        f"{lo} = 0u;")
        elif edit in ("no_fragments", "products_only"):
            src = _edit(src, old, old.replace(operand, "0.5f"))
    return src


def _ptxas(path: Path, warps: int, rows: int) -> str:
    """ptxas' registers and spill stores of the D = 112 kernel."""
    lines = path.with_suffix(".log").read_text().splitlines()
    tag = f"flash_mma_kernelILi112ELi{warps}ELi{rows // 16}E"
    for i, line in enumerate(lines):
        if tag in line and "Compiling" in line:
            rest = " ".join(lines[i + 1:i + 4])
            try:
                regs = rest.split("Used ")[1].split(" registers")[0]
                spill = rest.split(" bytes spill stores")[0].split()[-1]
            except IndexError:
                break
            return f"{regs} registers, {spill} bytes spill stores"
    return "no ptxas report"


def _time_variants(shape, variants: dict, libs: list, names=None) -> list:
    """Check and time each variant at ``shape`` (causal): at any shape
    but the prefill's only the checked ones, and of those only ``names``
    where given.  Returns the names that disagree with the chunked plain
    version."""
    B, Sq, Sk, H, KV, D = shape
    q, k, v = chip_smoke._flash_inputs(*shape, torch.float32)
    pos = torch.arange(Sq, device="cuda")
    want = _sdpa_chunked(q.reshape(B, Sq, KV, H // KV, D), k, v, pos, pos,
                         True, 0, 0.0, None, 1024).reshape(B, Sq, H, D)
    out = torch.empty_like(q)
    failed = []
    for (name, (warps, rows, bk, stages, _, checked)), path in zip(
            variants.items(), libs):
        if (not checked and shape != chip_smoke.FLASH_ZAMBA
                or names is not None and name not in names):
            continue
        lib = bind(path, kernel._FUNCTIONS, kernel._ERROR)
        smem = 4 * (D + 4) * (rows * warps + 2 * stages * bk)

        def run():
            launch(lib, "flash_attention_mma_f32", kernel._ERROR, q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Sq, Sk, H, KV, D, rows // 16, D ** -0.5, 1, 0, 0.0,
                   smem)
        out.fill_(float("nan"))
        run()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        if checked and not torch.allclose(out, want, atol=2e-5, rtol=2e-5):
            failed.append(f"{name} at {shape}")
            print(f"flash_f32 variant {name} at {shape}: DISAGREES, max abs "
                  f"err {err!r}", flush=True)
            continue
        ms = chip_smoke._device_ms(run, 10 if Sq > 1024 else 50)
        plan = kernel.mma_plan(D, B * H, Sq, kernel._sms(q.device))
        picked = ("" if names is None else
                  f"; mma_plan picks {plan.tiles} row tile(s) a warp")
        print(f"flash_f32 variant {name} ({warps} warps of {rows} rows, BK "
              f"{bk}, {stages} stages, {smem} B shared, "
              f"{_ptxas(path, warps, rows)}"
              f"{', checked' if checked else ', timed only'}) at (B, Sq, "
              f"Sk, H, KV, D) = {shape}: float32 ms per launch {ms!r}, max "
              f"abs err {err!r}{picked}", flush=True)
    return failed


def _old_against_new(source: Path, folder: Path) -> list:
    """Time the replaced kernel (built from ``source``) and the shipped
    one in turns, old, new, new, old, at the prefill and the consistency
    shapes, each checked at 2e-5 first; returns the names that
    disagree."""
    path = folder / "flash_f32_old.cu"
    path.write_text(source.read_text())
    old_lib = bind(build_libraries([path])[0], OLD_FUNCTIONS,
                   "flash_error_string")
    failed = []
    for shape in (chip_smoke.FLASH_ZAMBA, CONSISTENCY):
        B, Sq, Sk, H, KV, D = shape
        q, k, v = chip_smoke._flash_inputs(*shape, torch.float32)
        out = torch.empty_like(q)
        smem = 4 * (2 * OLD_BQ * D + OLD_BK * (D + 1) + OLD_BK * D
                    + OLD_BQ * (OLD_BK + 1) + 3 * OLD_BQ)

        def old():
            launch(old_lib, "flash_attention_f32", "flash_error_string",
                   q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), B, Sq, Sk, H, KV, D, OLD_BQ, OLD_BK,
                   D ** -0.5, 1, 0, 0.0, smem)

        def new():
            return kernel.flash_attention_cuda(q, k, v, causal=True)
        old()
        got = new()
        torch.cuda.synchronize()
        if not torch.allclose(out, got, atol=2e-5, rtol=2e-5):
            failed.append(f"old/new at {shape}")
        reps = 5 if shape == chip_smoke.FLASH_ZAMBA else 50
        t = [chip_smoke._device_ms(fn, reps) for fn in (old, new, new, old)]
        print(f"flash_f32 old CUDA-core kernel against the shipped plan at "
              f"(B, Sq, Sk, H, KV, D) = {shape}, causal, ms per launch in "
              f"turns old/new/new/old: {t!r}; max abs difference "
              f"{float((out - got).abs().max())!r}", flush=True)
    return failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", help="run only these variants")
    ap.add_argument("--old-kernel", type=Path,
                    help="the replaced CUDA-core source, timed in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32_probe: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card())
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {k: v for k, v in VARIANTS.items()
                if not args.only or k in args.only}
    src = kernel.SOURCES["flash_mma"].read_text()
    folder = BUILD_DIR / "variants"
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, (warps, rows, bk, stages, edit, _) in variants.items():
        path = folder / f"flash_f32_{name}.cu"
        path.write_text(_variant(src, warps, rows, bk, stages, edit))
        paths.append(path)
    libs = build_libraries(paths)
    failed = []
    for shape in (chip_smoke.FLASH_ZAMBA, CONSISTENCY):
        failed += _time_variants(shape, variants, libs)
    for shape in SWEEP:
        failed += _time_variants(shape, variants, libs,
                                 (SHIPPED, SHIPPED_ONE))
    shape = chip_smoke.FLASH_ZAMBA
    q, k, v = chip_smoke._flash_inputs(*shape, torch.float32)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = chip_smoke._device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 5)
    bounds = chip_smoke._flash_bounds(*shape, True, 0, torch.float32)
    print(f"scaled_dot_product_attention float32: ms per call {lib_ms!r}; "
          f"bound {max(bounds[1], bounds[2])!r} ms (TF32 x 3 operations "
          f"{bounds[1]!r} ms, bytes {bounds[2]!r} ms, float32 CUDA-core "
          f"operations {bounds[0]!r} ms)")
    if args.old_kernel is not None:
        failed += _old_against_new(args.old_kernel, folder)
    if failed:
        print(f"flash_f32_probe: {failed} disagree with the plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
