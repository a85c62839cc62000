"""Event-driven episodic simulator for OASiS on PyTorch.

OASiS commits schedules at arrival, so arrival bursts are the only
events: each burst goes through ``OASiS.on_arrivals`` (one decision per
job, in arrival order, on the price state's device), per-slot GPU usage
is read off the allocation tensor, and capacity feasibility is one
whole-state comparison.  This carries over the churn-free,
cancellation-free, unperturbed branch of the reference engine's OASiS
loop (``_drive_oasis_gen``); the other schedulers and the scenario hooks
come in later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.oasis import OASiS
from ..core.pricing import PriceParams, price_params_from_jobs
from ..core.types import ClusterSpec, Job


@dataclasses.dataclass
class SimResult:
    name: str
    total_utility: float
    accepted: int
    completed: int
    n_jobs: int
    completion: Dict[int, int]              # jid -> completion slot
    target_gap: List[float]                 # (t_done - a) - gamma3 per job
    decision_seconds: List[float]
    utilization: float                      # mean worker-pool GPU utilization
    arrivals: Dict[int, int] = dataclasses.field(default_factory=dict)
    schedules: Dict[int, object] = dataclasses.field(default_factory=dict)
    device_uploads: int = 0                 # full price-state uploads


def _with_quantum(job: Job, quantum: Optional[int]) -> Job:
    """Workload quantization (``Job.workload``): ``0`` picks the quantum
    that keeps every workload within 1200 DP units."""
    if quantum is None:
        return job
    q = quantum if quantum > 0 else max(
        1, math.ceil(job.epochs * job.num_chunks / 1200))
    return dataclasses.replace(job, quantum=q)


def _target_gaps(jmap: Dict[int, Job], completion: Dict[int, int]) -> List[float]:
    gaps = []
    for jid, tdone in completion.items():
        u = jmap[jid].utility
        if getattr(u, "gamma2", 0) > 0:
            gaps.append((tdone - jmap[jid].arrival) - u.gamma3)
    return gaps


def _group_events(jobs: Sequence[Job], T: int) -> Dict[int, List[Job]]:
    """Arrival bursts by slot; jobs arriving at/after T are never seen."""
    by_slot: Dict[int, List[Job]] = {}
    for j in jobs:
        if j.arrival >= T:
            continue
        by_slot.setdefault(j.arrival, []).append(j)
    return by_slot


def run(cluster: ClusterSpec, jobs: Sequence[Job], scheduler: str = "oasis",
        params: Optional[PriceParams] = None, check: bool = True,
        quantum: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
        core: str = "whole", cancellations=None, throughput=None,
        fleet=None, policy=None
        ) -> SimResult:
    """Drive OASiS through the trace event by event on ``device`` (None:
    the CUDA card), every decision through the decision core ``core``
    (``"whole"`` or ``"tiled"``, see ``core/schedule_torch.py``).  Same
    contract as the reference ``engine.run`` on
    churn-free, cancellation-free, unperturbed traces; price parameters
    come from the trace when not given.

    Example::

        >>> from repro_torch.sim import engine
        >>> from repro_torch.sim.workload import make_cluster, make_jobs
        >>> cluster = make_cluster(T=20, H=3, K=3)
        >>> jobs = make_jobs(4, T=20, seed=0, small=True)
        >>> r = engine.run(cluster, jobs, device="cpu")
        >>> r.accepted, r.total_utility > 0
        (4, True)
    """
    if scheduler != "oasis":
        raise NotImplementedError(
            f"scheduler={scheduler!r}: the reactive baselines and the learned "
            "scheduler are not ported yet (a later slice of the port)")
    hooks = {"cancellations": cancellations, "throughput": throughput,
             "fleet": fleet, "policy": policy}
    for name, hook in hooks.items():
        if hook is not None:
            raise NotImplementedError(
                f"{name}=: the engine's scenario hooks and external "
                "deciders are not ported yet (a later slice of the port)")
    T = cluster.T
    jmap = {j.jid: j for j in jobs}
    by_slot = _group_events(jobs, T)
    params = params or price_params_from_jobs(jobs, cluster)
    osched = OASiS(cluster, params, device=device, core=core)
    total_gpu = max(float(cluster.worker_caps[:, 0].sum()), 1e-9)

    for t in sorted(by_slot):
        osched.on_arrivals([_with_quantum(job, quantum)
                            for job in by_slot[t]])
        if check:
            ok_w, ok_ps = osched.state.capacity_ok()
            if not (ok_w and ok_ps):
                raise RuntimeError(
                    f"capacity violated at slot {t} (workers ok: {ok_w}, "
                    f"PS ok: {ok_ps})")

    completion = {jid: sched.finish for jid, sched in osched.accepted.items()}
    gpu_slots = osched.state.gpu_slot_usage()
    utilization = float(np.mean(gpu_slots / total_gpu)) if T else 0.0
    return SimResult(name="oasis", total_utility=osched.total_utility,
                     accepted=len(osched.accepted),
                     completed=len(completion),
                     n_jobs=len(jobs), completion=completion,
                     target_gap=_target_gaps(jmap, completion),
                     decision_seconds=osched.decision_seconds,
                     utilization=utilization,
                     arrivals={j.jid: j.arrival for j in jobs
                               if j.arrival < T},
                     schedules=dict(osched.accepted),
                     device_uploads=osched.state.device_uploads)
