"""Training launcher: config -> train step -> steps, optionally planned by
OASiS, on the card (``--device cpu`` for the CPU), as
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
        --steps 4 --seq 2048 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
        --smoke --steps 20 --device cpu [--elastic] [--compress-grads]

Weights are random, from seed 0; the batches come from the seeded
synthetic stream (``data/pipeline.py``); Whisper's frames and pixtral's
patch embeddings are zeros, as in the reference.  Every 10 steps it
prints the CE, the gradient norm and the seconds a step; every 25 it
checkpoints parameters, optimizer state and the data cursor (async).

``--elastic`` (parsed and never read by the reference's launcher) does
what ``examples/elastic_training.py`` does: ``core/types.py::
job_from_arch`` makes a scheduler job of the model (6 N flops a token,
4 N bytes of gradients), the port's OASiS schedules it on a 50-slot
cluster of 10 + 10 servers, ``runtime/elastic.py::schedule_to_plan``
turns the schedule into per-slot worker counts and ``ElasticTrainer``
runs the steps across those slots.  An ``ssm`` or ``hybrid`` model
trains on the CPU only until the SSD kernel has a backward.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ckpt.checkpoint import AsyncCheckpointer
from ..configs import get_config, get_smoke
from ..data.pipeline import DataConfig, DataPipeline
from ..models.layers import param_count
from ..models.model import init_model
from ..train.optimizer import OptConfig, init_opt
from ..train.steps import TrainHyper, make_train_step

DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def launcher_opt(steps: int) -> OptConfig:
    """The launcher's AdamW settings, the reference launcher's: lr 1e-3,
    10 warmup steps, the cosine over ``steps``."""
    return OptConfig(lr=1e-3, warmup_steps=10, total_steps=steps)


def _extras(cfg, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Whisper's (stubbed) frames and pixtral's patch embeddings, zeros
    beside the tokens, as the reference's launcher feeds them."""
    B = batch["tokens"].shape[0]
    if cfg.family == "encdec":
        batch["frames"] = np.zeros((B, cfg.encoder_seq, cfg.d_model),
                                   np.float32)
    if cfg.n_patches:
        batch["patch_embeds"] = np.zeros((B, cfg.n_patches, cfg.d_model),
                                         np.float32)
    return batch


def elastic_plan(cfg, n_params: int, seq: int, batch: int, steps: int,
                 device: torch.device):
    """OASiS's plan for training ``cfg``: (the schedule, its slot plan cut
    to ``steps``, steps a slot)."""
    from ..core.oasis import OASiS
    from ..core.pricing import price_params_from_jobs
    from ..core.types import job_from_arch
    from ..runtime.elastic import schedule_to_plan
    from ..sim.workload import make_cluster
    cluster = make_cluster(T=50, H=10, K=10)
    job = job_from_arch(cfg.name, arrival=0, flops_per_token=6 * n_params,
                        param_bytes=4 * n_params,
                        tokens_per_step=seq * batch, target_steps=steps)
    sched = OASiS(cluster, price_params_from_jobs([job], cluster),
                  device=device)
    s = sched.on_arrival(job)
    if s is None:
        raise RuntimeError(f"OASiS rejected the job of {cfg.name}")
    plan = schedule_to_plan(s)
    per_slot = max(1, steps // max(len(plan), 1))
    return s, plan[:max(1, steps // per_slot)], per_slot


def train(arch: str, *, smoke: bool = False, steps: int = 50, seq: int = 64,
          batch: int = 4, ckpt: str = DEFAULT_CKPT,
          elastic: bool = False, compress_grads: bool = False,
          device: Optional[str] = None) -> Dict:
    """Run the launcher's training; returns {"ce": per-step CE, "steps",
    "seconds", "step_seconds" (each step's wall clock, ending in the read
    of its CE, which waits for the device; the plain loop's only),
    "widths" (the elastic run's dp widths, else [])}."""
    dev = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    cfg.validate()
    opt_cfg = launcher_opt(steps)
    hyper = TrainHyper(grad_compress=compress_grads)
    params = init_model(cfg, seed=0, device=dev)
    opt = init_opt(params, opt_cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch)
    t0 = time.time()
    if elastic:
        from ..runtime.elastic import ElasticTrainer
        s, plan, per_slot = elastic_plan(cfg, param_count(params), seq,
                                         batch, steps, dev)
        print(f"OASiS plan: finish={s.finish} payoff={s.payoff:.2f} "
              f"workers/slot={[p.n_workers for p in plan]}", flush=True)
        step = make_train_step(cfg, opt_cfg, hyper, device=dev)

        def make_step(width: int):
            def run(params, opt, b):
                return step(params, opt, _extras(cfg, b))
            return run

        trainer = ElasticTrainer(cfg, opt_cfg, data_cfg, ckpt, make_step,
                                 steps_per_slot=per_slot)
        out = trainer.run(plan, params, opt)
        ces: List[float] = [m["ce"] for m in trainer.metrics_log]
        print(f"trained {out['steps']} steps; dp widths "
              f"{trainer.mesh_history}", flush=True)
        return {"ce": ces, "steps": out["steps"],
                "seconds": time.time() - t0, "step_seconds": [],
                "widths": trainer.mesh_history}
    step = make_train_step(cfg, opt_cfg, hyper, device=dev)
    pipe = DataPipeline(data_cfg)
    saver = AsyncCheckpointer(ckpt)
    ces, walls = [], []
    for i in range(steps):
        t1 = time.perf_counter()
        params, opt, metrics = step(params, opt,
                                    _extras(cfg, pipe.next_batch()))
        ces.append(float(metrics["ce"]))
        walls.append(time.perf_counter() - t1)
        if (i + 1) % 10 == 0:
            print(f"step {i + 1:4d} ce={ces[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
        if (i + 1) % 25 == 0:
            saver.save_async(i + 1, {"params": params, "opt": opt},
                             extra={"pipeline": pipe.state.to_dict()})
    saver.wait()
    return {"ce": ces, "steps": steps, "seconds": time.time() - t0,
            "step_seconds": walls, "widths": []}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--elastic", action="store_true",
                    help="drive worker counts from an OASiS schedule")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (default: the card)")
    args = ap.parse_args(argv)
    out = train(args.arch, smoke=args.smoke, steps=args.steps, seq=args.seq,
                batch=args.batch, ckpt=args.ckpt, elastic=args.elastic,
                compress_grads=args.compress_grads, device=args.device)
    print(f"done: {out['steps']} steps, ce {out['ce'][0]:.4f} -> "
          f"{out['ce'][-1]:.4f}", flush=True)


if __name__ == "__main__":
    main()
