"""Elastic runtime: an OASiS schedule -> per-slot worker counts ->
training at each slot's data-parallel width, as
``repro/runtime/elastic.py``.

This is the execution side of the paper's idea (a job's number of
concurrent workers adjusted during its run).  At each slot the runtime

  1. reads the slot's worker count W_t from the job's schedule,
  2. takes the data-parallel width ``dp_width(W_t, devices)``,
  3. builds the slot's step for that width (``make_step(width)``),
  4. runs ``steps_per_slot`` steps, the data pipeline's cursor carried
     on (chunk assignment does not depend on the width, so no sample is
     replayed or skipped),
  5. checkpoints parameters, optimizer state and cursor (async).

The reference re-meshes with ``jax.make_mesh((width, 1))`` and moves the
state through the new shardings.  One card has no mesh: the devices are
``torch.cuda.device_count()`` (1 on the CPU), ``make_step`` takes the
width itself and ``mesh_history`` records the widths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from ..ckpt import checkpoint as ckpt
from ..core.types import Schedule
from ..data.pipeline import DataConfig, DataPipeline


@dataclasses.dataclass
class SlotPlan:
    slot: int
    n_workers: int


def schedule_to_plan(schedule: Schedule) -> List[SlotPlan]:
    """One :class:`SlotPlan` per scheduled slot, in slot order: the slot's
    workers summed over the servers."""
    return [SlotPlan(slot=t, n_workers=int(schedule.workers[t].sum()))
            for t in sorted(schedule.workers)]


def dp_width(n_workers: int, n_devices: int) -> int:
    """Largest power-of-two dp width <= min(workers, devices)."""
    w = max(1, min(n_workers, n_devices))
    return 1 << (w.bit_length() - 1)


class ElasticTrainer:
    """Drives a train step across slots at each slot's width.
    ``make_step(width) -> step(params, opt_state, batch) -> (params,
    opt_state, metrics)``."""

    def __init__(self, cfg, opt_cfg, data_cfg: DataConfig, ckpt_dir: str,
                 make_step: Callable, steps_per_slot: int = 50):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.ckpt_dir = ckpt_dir
        self.make_step = make_step
        self.steps_per_slot = steps_per_slot
        self.checkpointer = ckpt.AsyncCheckpointer(ckpt_dir)
        self.metrics_log: List[Dict] = []
        self.mesh_history: List[int] = []

    def run(self, plan: List[SlotPlan], params, opt_state,
            pipeline: Optional[DataPipeline] = None) -> Dict[str, Any]:
        pipeline = pipeline or DataPipeline(self.data_cfg)
        n_devices = torch.cuda.device_count() or 1
        step_no = 0
        for slot in plan:
            width = dp_width(slot.n_workers, n_devices)
            self.mesh_history.append(width)
            fn = self.make_step(width)
            for _ in range(self.steps_per_slot):
                batch = pipeline.next_batch()
                params, opt_state, metrics = fn(params, opt_state, batch)
                self.metrics_log.append(
                    {k: float(v) for k, v in metrics.items()})
                step_no += 1
            self.checkpointer.save_async(
                step_no, {"params": params, "opt": opt_state},
                extra={"pipeline": pipeline.state.to_dict(),
                       "slot": slot.slot})
        self.checkpointer.wait()
        return {"params": params, "opt": opt_state, "steps": step_no,
                "pipeline": pipeline}
