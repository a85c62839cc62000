"""Where one StarCoder2-3B training step spends its time on one NVIDIA
card: the step traced with ``torch.profiler`` and its device time split
by kernel.

    python3 tools/train_step_profile.py [--steps 3] [--seq 2048] [--batch 2]

Full width and depth (30 layers, d 3072, vocab 49152), parameters from
seed 0, float32 parameters and AdamW moments, bfloat16 compute, remat,
the launcher's ``OptConfig`` and train step
(``train/steps.py::make_train_step``, as chip_smoke's ``train_phase``
runs it through ``launch/train.py::train``), batches from the data
pipeline.  ``--steps`` steps run untraced (the first compiles nothing
but warms the allocator and the kernels' libraries), then one more is
traced, its host wall clock ending in a synchronize.  Prints the card's
name and power limit, then the traced step's wall, device busy time and
idle share; the device ms of the flash forward kernel
(``flash_wgmma_kernel``), the bfloat16 flash backward's three kernels
(``bwd_rows_kernel`` prep and dq, ``bwd_dkdv_kernel``), cuBLAS's GEMMs,
the kernels launched inside ``apply_updates`` (AdamW, in place) and the
rest (elementwise, casts, reductions, the loss), each with its share of
busy; the ten kernels with the most device time; and the peak device
memory.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: E402
from repro_torch.kernels import build_all  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models.model import init_model  # noqa: E402
from repro_torch.train import steps as train_steps  # noqa: E402
from repro_torch.train.optimizer import init_opt  # noqa: E402

# kernel name -> category, first match wins
CATEGORIES = (("flash forward", r"flash_wgmma_kernel"),
              ("flash backward, prep and dq", r"bwd_rows_kernel"),
              ("flash backward, dkdv", r"bwd_dkdv_kernel"),
              ("GEMMs (cuBLAS)", r"gemm|xmma|nvjet|cutlass"))
ADAMW = "train:apply_updates"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def device_ms_inside(prof, name):
    """Device ms of the kernels launched inside the CPU range ``name``."""
    def dev(e):
        return (sum(k.duration for k in e.kernels)
                + sum(dev(c) for c in e.cpu_children))
    return sum(dev(e) for e in prof.events()
               if e.name == name
               and e.device_type == torch.autograd.DeviceType.CPU) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile, record_function
    print(card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all()
    cfg = get_config("starcoder2_3b")
    params = init_model(cfg, seed=0, device="cuda")
    opt_cfg = train_launch.launcher_opt(args.steps + 1)
    opt = init_opt(params, opt_cfg)
    step = train_steps.make_train_step(cfg, opt_cfg, train_steps.TrainHyper(),
                                       device="cuda")
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=args.seq,
                                   global_batch=args.batch))
    apply_updates = train_steps.apply_updates

    def traced_updates(*a, **kw):
        with record_function(ADAMW):
            return apply_updates(*a, **kw)

    train_steps.apply_updates = traced_updates
    try:
        for _ in range(args.steps):
            params, opt, m = step(params, opt, pipe.next_batch())
            float(m["ce"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batch = pipe.next_batch()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            ce = float(m["ce"])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        train_steps.apply_updates = apply_updates
    peak = torch.cuda.max_memory_allocated()
    # device time by kernel name, from the device's own events: a CPU op
    # (an aten op, a runtime call, an autograd node such as
    # FlashAttentionBackward, whose ctypes launches no aten op owns)
    # carries its kernels' time too and would count it twice, and so does
    # the named range's own span on the device's timeline
    kernels = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name != ADAMW):
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy = sum(kernels.values())
    if not busy:
        print("train_step_profile: the trace holds no device event",
              file=sys.stderr)
        return 1
    parts = dict.fromkeys([c for c, _ in CATEGORIES] + ["rest"], 0.0)
    for name, ms in kernels.items():
        cat = next((c for c, pat in CATEGORIES if re.search(pat, name)),
                   "rest")
        parts[cat] += ms
    adamw = device_ms_inside(prof, ADAMW)
    parts["rest"] -= min(adamw, parts["rest"])
    print(f"StarCoder2-3B training step (full width and depth, bf16 compute, "
          f"float32 parameters and moments, remat, batch {args.batch} x "
          f"{args.seq} tokens), traced after {args.steps} steps: ce={ce!r} "
          f"wall_ms={wall!r} device_busy_ms={busy!r} idle_share="
          f"{1 - busy / wall!r}", flush=True)
    for cat, ms in list(parts.items())[:-1] + [("AdamW (apply_updates)",
                                                adamw),
                                               ("rest", parts["rest"])]:
        print(f"  {cat}: device_ms={ms!r} share_of_busy={ms / busy!r}")
    print("  top kernels by device ms:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms!r} ms  {name[:140]}")
    print(f"peak device memory {peak} bytes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
