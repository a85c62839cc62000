"""Straggler detection and mitigation, numpy only: the port's own copy of
the reference's ``runtime/straggler.py``.  The scenario library's
``StragglerThroughput`` drives it on the host; nothing here creates a
torch tensor.

The paper's asynchronous PS training tolerates slow workers natively; on
a synchronous mesh a straggler stalls every step.  Mitigations here:

1. **Detection** — per-worker step-time EMA; a worker whose EMA exceeds
   ``threshold`` x the median is flagged.
2. **Slot-boundary down-scale** — flagged workers are excluded from the
   next slot's mesh (the OASiS schedule's worker count is met by the
   remaining capacity or re-planned by the scheduler; prices make the
   replacement decision economically consistent).
3. **Bounded-staleness fallback** — optional gradient-accumulation mode
   where a late microbatch is applied one step behind (the PS-style
   asynchrony knob).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    ema: float = 0.7
    threshold: float = 1.8       # x median EMA
    min_samples: int = 3


class StragglerMonitor:
    def __init__(self, n_workers: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.emas = np.zeros(n_workers)
        self.counts = np.zeros(n_workers, dtype=int)

    def record(self, worker: int, step_seconds: float) -> None:
        a = self.cfg.ema
        if self.counts[worker] == 0:
            self.emas[worker] = step_seconds
        else:
            self.emas[worker] = a * self.emas[worker] + (1 - a) * step_seconds
        self.counts[worker] += 1

    def stragglers(self) -> List[int]:
        ready = self.counts >= self.cfg.min_samples
        if ready.sum() < 2:
            return []
        med = float(np.median(self.emas[ready]))
        if med <= 0:
            return []
        return [int(i) for i in np.nonzero(
            ready & (self.emas > self.cfg.threshold * med))[0]]

    def healthy_workers(self) -> List[int]:
        bad = set(self.stragglers())
        return [i for i in range(len(self.emas)) if i not in bad]


class BoundedStaleness:
    """Apply gradients at most ``staleness`` steps late (PS-style async).
    grads enter as host arrays; ``push`` returns the (possibly stale)
    gradient to apply this step, or None while the pipe fills."""

    def __init__(self, staleness: int = 1):
        assert staleness >= 0
        self.staleness = staleness
        self.queue: List = []

    def push(self, grad):
        self.queue.append(grad)
        if len(self.queue) > self.staleness:
            return self.queue.pop(0)
        return None
