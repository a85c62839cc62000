"""Carry the reference package's objects over to the port.

Each function reads the fields of a reference object by name — plain
numbers and numpy arrays — and builds the port's counterpart, so a run
can start on the port from a reference state in the middle of a
trajectory.  Nothing of the reference package is imported.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .core.pricing import PriceParams, PriceState
from .core.types import ClusterSpec, Job, SigmoidUtility
from .sim.fleet import FleetEvent, FleetTrace

_JOB_FIELDS = ("jid", "arrival", "epochs", "num_chunks",
               "minibatches_per_chunk", "tau", "grad_size", "worker_bw",
               "ps_bw", "quantum", "work_scale")


def job(ref) -> Job:
    """A ``Job`` with the reference job's fields; its sigmoid utility is
    rebuilt from ``gamma1..3``."""
    u = ref.utility
    return Job(**{f: getattr(ref, f) for f in _JOB_FIELDS},
               worker_res=np.array(ref.worker_res, dtype=np.float64),
               ps_res=np.array(ref.ps_res, dtype=np.float64),
               utility=SigmoidUtility(float(u.gamma1), float(u.gamma2),
                                      float(u.gamma3)))


def cluster(ref) -> ClusterSpec:
    return ClusterSpec(T=int(ref.T),
                       worker_caps=np.array(ref.worker_caps, np.float64),
                       ps_caps=np.array(ref.ps_caps, np.float64))


def price_params(ref) -> PriceParams:
    return PriceParams(U1=np.array(ref.U1, np.float64),
                       U2=np.array(ref.U2, np.float64),
                       L1=float(ref.L1), L2=float(ref.L2))


def price_state(ref, device: Optional[Union[str, torch.device]] = None
                ) -> PriceState:
    """A ``PriceState`` holding copies of the reference state's ``g``/``v``
    host mirrors, with its window's place on the clock (``origin``,
    ``retired_slots``, ``retired_gpu_slots``)."""
    c = cluster(ref.cluster)
    g, v = np.array(ref.g, np.float64), np.array(ref.v, np.float64)
    state = PriceState(c, price_params(ref.params), device=device,
                       window=g.shape[0])
    state.g, state.v = g, v
    state.origin = int(ref.origin)
    state.retired_slots = int(ref.retired_slots)
    state.retired_gpu_slots = float(ref.retired_gpu_slots)
    return state


def fleet_trace(ref) -> FleetTrace:
    """A ``FleetTrace`` with the reference trace's events."""
    return FleetTrace(tuple(FleetEvent(int(e.slot), str(e.kind), str(e.pool),
                                       int(e.server)) for e in ref.events))
