"""Fault-tolerant training driver: checkpoint/restart supervision, as
``repro/runtime/driver.py``, over the port's own checkpoints
(``ckpt/checkpoint.py``, the reference's on-disk format).

``run_with_restarts`` runs a training function under supervision; on a
failure (node loss is simulated by exceptions or injected faults) it
restores the latest checkpoint, the data pipeline's cursor included, and
continues.  A non-finite loss counts as a fault.  The port's train step
writes its state in place, so a run that starts with no checkpoint saves
its start as step 0 first: a fault before the first periodic save then
restarts from that copy, where the reference restarts from the arrays it
was given.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from ..ckpt import checkpoint as ckpt
from ..data.pipeline import DataPipeline, PipelineState


class FaultInjector:
    """Deterministic fault schedule for tests: raises at given steps."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


def run_with_restarts(train_fn: Callable, init_state: Dict,
                      pipeline: DataPipeline, ckpt_dir: str,
                      total_steps: int, save_every: int = 20,
                      max_restarts: int = 5,
                      injector: Optional[FaultInjector] = None) -> Dict:
    """``train_fn(state, batch, step) -> (state, loss: float)``; ``state``
    is a tree of tensors with everything that must survive a restart.
    Returns {"state", "losses", "restarts", "final_step"}."""
    saver = ckpt.AsyncCheckpointer(ckpt_dir)
    state = init_state
    step = 0
    restarts = 0
    # resume if a checkpoint exists (crash-restart entry point)
    last = ckpt.latest_step(ckpt_dir)
    if last is not None:
        state, extra = ckpt.restore(ckpt_dir, last, init_state)
        pipeline.state = PipelineState.from_dict(extra["pipeline"])
        step = last
    else:       # the start, for a cold restart: the steps overwrite state
        saver.save_async(0, state,
                         extra={"pipeline": pipeline.state.to_dict()})
    losses = []
    while step < total_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            batch = pipeline.next_batch()
            state, loss = train_fn(state, batch, step)
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
            losses.append(loss)
            step += 1
            if step % save_every == 0:
                saver.save_async(step, state,
                                 extra={"pipeline": pipeline.state.to_dict()})
        except (RuntimeError, FloatingPointError):
            restarts += 1
            if restarts > max_restarts:
                raise
            saver.wait()
            last = ckpt.latest_step(ckpt_dir)
            state, extra = ckpt.restore(ckpt_dir, last, state)
            pipeline.state = PipelineState.from_dict(extra["pipeline"])
            step = last
    saver.wait()
    return {"state": state, "losses": losses, "restarts": restarts,
            "final_step": step}
