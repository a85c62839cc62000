"""Trace-driven cluster simulation (paper Sec. V-A).

``simulate`` is a thin wrapper over the event-driven engine
(``sim/engine.py::run``).  The port's own copy of the reference's
``sim/simulator.py``; OASiS decides on ``device`` through the decision
core ``core``, the reactive baselines run on the host in numpy.  The
reference's per-slot loop (its ``simulate_reference``) is the oracle the
engine is held to (``tests/test_torch_reactive.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from ..core.pricing import PriceParams
from ..core.types import ClusterSpec, Job
from . import engine
from .engine import SimResult

__all__ = ["SimResult", "simulate"]


def simulate(cluster: ClusterSpec, jobs: Sequence[Job], scheduler: str = "oasis",
             params: Optional[PriceParams] = None, check: bool = True,
             quantum: Optional[int] = None,
             cancellations: Optional[Dict[int, int]] = None,
             throughput: Optional[engine.ThroughputFn] = None,
             device: Optional[Union[str, torch.device]] = None,
             core: str = "whole") -> SimResult:
    """Drive ``scheduler`` through T slots on the event engine.

    Equals the reference's per-slot loop on cancellation-free, unperturbed
    workloads; ``cancellations`` and ``throughput`` are the engine's
    scenario hooks (``sim/engine.py``).

    Example::

        >>> from repro_torch.sim.simulator import simulate
        >>> from repro_torch.sim.workload import make_cluster, make_jobs
        >>> cluster = make_cluster(T=20, H=3, K=3)
        >>> jobs = make_jobs(4, T=20, seed=0, small=True)
        >>> r = simulate(cluster, jobs, scheduler="drf", device="cpu")
        >>> (r.accepted, r.completed)
        (4, 4)
    """
    return engine.run(cluster, jobs, scheduler=scheduler, params=params,
                      check=check, quantum=quantum,
                      cancellations=cancellations, throughput=throughput,
                      device=device, core=core)
