"""StarCoder2-3B's first training steps on one NVIDIA card under several
settings, to tell the optimizer's dynamics from a fault of the kernels or
of the in-place AdamW.

    python3 tools/train_curve_probe.py [--steps 6] [--out FILE]

Full width and depth (30 layers, d 3072, vocab 49152), batch 2 x 2048
tokens from the data pipeline, parameters from seed 0, float32
parameters and moments, remat; each run prints per step the CE (with
its z-loss, the metric the launcher prints), the CE of one held-out
batch (the stream at seed 1) after the step, the global gradient norm
and the learning rate:

* ``launcher``: bfloat16 compute and the launcher's ``OptConfig`` (lr
  1e-3, warmup 10, total = steps: lr 1e-4 x step), as chip_smoke's
  ``train_phase`` runs it;
* ``fixed batch``: the same, the first batch at every step;
* ``float32``: the same with float32 compute (the TF32 x 3 flash kernel,
  TF32 off in the GEMMs);
* ``lr/4``: bfloat16, the launcher's schedule at lr 2.5e-4;
* ``const1e-4``: bfloat16, lr 1e-4 from the first step on.

Then at reduced depth (2 layers, full width, batch 2 x 512 tokens, the
launcher's schedule, 4 steps) the card against the port's own run on the
host CPU from the same parameters and batches, float32 against float32,
bfloat16 against bfloat16 and against float32: each step's CE and,
after the last step, every parameter's relative norm difference (the
largest named).  Prints the card's name and power
limit first; writes every number to ``--out`` as JSON.  Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (adds src/ to the path)
from repro_torch.ckpt.checkpoint import _paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: E402
from repro_torch.launch.train import launcher_opt  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.model import init_model  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt  # noqa: E402
from repro_torch.train.steps import (TrainHyper, batch_to, loss_fn,  # noqa: E402,E501
                                     make_train_step)


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def run(cfg, opt_cfg, batch, seq, steps, device, params=None, fixed=False,
        held=None):
    """``steps`` train steps; returns (per-step metrics, params).
    ``fixed``: the first batch at every step; ``held``: a batch whose CE
    (``held_ce``, no gradient) is read after each step."""
    if params is None:
        params = init_model(cfg, seed=0, device=device)
    opt = init_opt(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, TrainHyper(), device=device)
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch))
    first = pipe.next_batch()
    rows = []
    for i in range(steps):
        b = first if fixed or i == 0 else pipe.next_batch()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        m = {k: float(v) for k, v in m.items()}
        m["wall_s"] = time.perf_counter() - t0
        if held is not None:
            with torch.no_grad():
                m["held_ce"] = float(loss_fn(params, cfg,
                                             batch_to(held, device),
                                             TrainHyper())[1]["ce"])
        rows.append(m)
    del opt
    return rows, params


def show(label, rows):
    print(f"{label}: " + "; ".join(
        f"step {i + 1} ce={r['ce']!r} "
        + (f"held_ce={r['held_ce']!r} " if "held_ce" in r else "")
        + f"gnorm={r['grad_norm']!r} lr={r['lr']!r}"
        for i, r in enumerate(rows)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default="chiprun_out/train_curve_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_curve_probe: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = get_config("starcoder2_3b")
    n = args.steps
    launcher = launcher_opt(n)
    out = {"card": chip_smoke._card(), "full": {}, "reduced": {}}
    held = DataPipeline(DataConfig(vocab_size=full.vocab_size, seq_len=2048,
                                   global_batch=2, seed=1)).next_batch()
    for label, cfg, opt_cfg, fixed in (
            ("launcher", full, launcher, False),
            ("float32", dataclasses.replace(full, dtype="float32"), launcher,
             False),
            ("fixed batch", full, launcher, True),
            ("lr/4", full, dataclasses.replace(launcher, lr=2.5e-4), False),
            ("const1e-4", full, OptConfig(lr=1e-4, warmup_steps=0,
                                          total_steps=10 ** 9), False)):
        rows, params = run(cfg, opt_cfg, 2, 2048, n, "cuda", fixed=fixed,
                           held=held)
        del params
        torch.cuda.empty_cache()
        show(f"full {label}", rows)
        out["full"][label] = rows

    small = dataclasses.replace(full, n_layers=2)
    opt4 = launcher_opt(4)
    init = init_model(small, seed=0, device="cuda")
    host = tree_map(lambda x: x.detach().cpu().clone(), init, _is_tensor)
    del init
    names = tree_leaves(_paths(host), lambda x: isinstance(x, str))
    cpu = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(small, dtype=dt)
        cpu[dt] = run(cfg, opt4, 2, 512, 4, "cpu",
                      params=tree_map(lambda x: x.clone(), host, _is_tensor))
        show(f"reduced cpu {dt}", cpu[dt][0])
        out["reduced"][f"cpu {dt}"] = cpu[dt][0]
    for dt, against in (("float32", "float32"), ("bfloat16", "bfloat16"),
                        ("bfloat16", "float32")):
        cfg = dataclasses.replace(small, dtype=dt)
        rows, p = run(cfg, opt4, 2, 512, 4, "cuda",
                      params=tree_map(lambda x: x.cuda(), host, _is_tensor))
        cpu_rows, cpu_p = cpu[against]
        rel = [float((a.cpu() - b).norm() / b.norm().clamp(min=1e-30))
               for a, b in zip(tree_leaves(p, _is_tensor),
                               tree_leaves(cpu_p, _is_tensor))]
        worst = int(np.argmax(rel))
        ce_rel = [abs(r["ce"] - c["ce"]) / abs(c["ce"])
                  for r, c in zip(rows, cpu_rows)]
        label = f"card {dt} against cpu {against}"
        show(f"reduced card {dt}", rows)
        print(f"reduced {label}: ce rel per step {ce_rel!r}; parameters "
              f"after 4 steps: max rel norm {rel[worst]!r} "
              f"({names[worst]})", flush=True)
        out["reduced"][label] = {"rows": rows, "ce_rel": ce_rel,
                                 "param_rel": dict(zip(names, rel))}
        del p
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
