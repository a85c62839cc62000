"""The float32 flash-attention kernel against an earlier source of itself
on one NVIDIA card: accuracy on long rows whose values run coherently
along the keys, and device time in turns, at the port's float32 shapes.

    git show b200021:src/repro_torch/kernels/flash_attention/csrc/\\
flash_attention_mma.cu > /tmp/old_mma.cu
    python3 tools/flash_f32_accum_probe.py --old-kernel /tmp/old_mma.cu

The earlier source is any ``flash_attention_mma.cu`` with the same C
entry (``flash_attention_mma_f32``) and plans; the one at b200021 took
each row's P V straight into O, where the tensor cores round each sum
toward zero, and the shipped one sums each 8 keys' three TF32 passes
from zero and rounds them into O.  Both are built beside the kernels'
own libraries under ``kernels/_build/``.  For each shape: the max abs
error of both against ``attention_ref`` (float32, TF32 off) and whether
each holds ``allclose(atol=2e-5, rtol=2e-5)``, then device ms per
launch, old, new, new, old.  The first shapes take V of mean 2 (``2 +
0.5 N(0, 1)``, as a Whisper encoder layer's values run): Whisper-large-
v3's encoder at one clip and at eight (both row-tile plans), its
cross-attention, and 4096 keys at D 112; then N(0, 1) inputs at
Whisper's and the causal served shapes chip_smoke times.  Prints the
card's name and power limit first.  Exits non-zero without a CUDA device
or when the shipped kernel misses the tolerance.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (adds src/ to the path)
from repro_torch.kernels.build import bind, build_libraries, launch  # noqa: E402,E501
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# (shape (B, Sq, Sk, H, KV, D), causal, V of mean 2)
CASES = [((1, 1500, 1500, 20, 20, 64), False, True),
         ((8, 1500, 1500, 20, 20, 64), False, True),
         ((1, 64, 1500, 20, 20, 64), False, True),
         ((8, 224, 1500, 20, 20, 64), False, True),
         ((1, 4096, 4096, 4, 4, 112), False, True),
         ((1, 1500, 1500, 20, 20, 64), False, False),
         (chip_smoke.FLASH_ZAMBA, True, False),
         (chip_smoke.FLASH_CONSISTENCY, True, False),
         (chip_smoke.FLASH_GEMMA, True, False),
         (chip_smoke.FLASH_OLMOE, True, False)]


def _run(lib, q, k, v, causal):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    plan = kernel.mma_plan(D, B * H, Sq, kernel._sms(q.device))
    out = torch.empty_like(q)
    launch(lib, "flash_attention_mma_f32", kernel._ERROR, q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
           Sk, H, KV, D, plan.tiles, D ** -0.5, int(causal), 0, 0.0,
           plan.smem_bytes)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-kernel", type=Path, required=True,
                    help="an earlier flash_attention_mma.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32_accum_probe: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = bind(build_libraries([args.old_kernel])[0], kernel._FUNCTIONS,
               kernel._ERROR)
    new = kernel.load_library()
    bad = 0
    for shape, causal, coherent in CASES:
        q, k, v = chip_smoke._flash_inputs(*shape, torch.float32)
        if coherent:
            v = 2.0 + 0.5 * v
        want = attention_ref(q, k, v, causal=causal)
        line = []
        for name, lib in (("old", old), ("new", new)):
            got = _run(lib, q, k, v, causal)
            torch.cuda.synchronize()
            ok = torch.allclose(got, want, atol=2e-5, rtol=2e-5)
            line.append(f"{name} max_abs_err="
                        f"{float((got - want).abs().max())!r} within={ok}")
            bad += name == "new" and not ok
        reps = 5 if shape[1] >= 2048 else 20
        ms = [chip_smoke._device_ms(lambda: _run(lib, q, k, v, causal), reps)
              for lib in (old, new, new, old)]
        print(f"f32 {shape} causal={causal} V_mean_2={coherent}: "
              + "; ".join(line) + f"; ms old, new, new, old = {ms}",
              flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
