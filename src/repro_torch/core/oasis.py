"""Alg. 1 — OASiS online admission + scheduling loop, on PyTorch.

Every decision goes through one of the decision cores of
``core/schedule_torch.py`` (``core="whole"``, the default, or
``"tiled"``), which read dual prices from the device-resident
``PriceState`` (``core/pricing.py``); ``commit`` keeps the residency fresh
with in-place slot-window writes.  On the tiled route a burst of arrivals
is decided together (``on_arrivals``), as the reference's ``impl="jax"``
does.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import obs as _obs
from .pricing import PriceParams, PriceState
from .schedule_torch import (CORES, _materialize, best_schedule_fused,
                             decide_burst, route_dtype)
from .types import ClusterSpec, Job, Schedule

# the smallest burst that on_arrivals decides together (the reference's
# batch_threshold)
BURST_MIN = 2


class OASiS:
    """Online scheduler: admit iff the best schedule has positive payoff.

    Example — one Alg. 1 pass over a tiny trace::

        >>> from repro_torch.core.oasis import OASiS
        >>> from repro_torch.core.pricing import price_params_from_jobs
        >>> from repro_torch.sim.workload import make_cluster, make_jobs
        >>> cluster = make_cluster(T=20, H=3, K=3)
        >>> jobs = make_jobs(4, T=20, seed=0, small=True)
        >>> sched = OASiS(cluster, price_params_from_jobs(jobs, cluster),
        ...               device="cpu")
        >>> plans = sched.on_arrivals(jobs)
        >>> [p is not None for p in plans]     # admission decisions
        [True, True, True, True]
        >>> sorted(sched.accepted)
        [0, 1, 2, 3]
    """

    def __init__(self, cluster: ClusterSpec, params: PriceParams,
                 track_duality: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 core: str = "whole", window: Optional[int] = None,
                 precision: str = "auto"):
        if core not in CORES:
            raise ValueError(f"core must be one of {CORES}, not {core!r}")
        route_dtype(precision)
        self.cluster = cluster
        self.core = core
        # the decision route's dtype (schedule_torch.route_dtype): "auto"
        # and "x64" float64, "x32" float32
        self.precision = precision
        # ``window``: the price state's resident slots for the continuous
        # serving mode (``sim/engine.py::run_stream``); decisions then
        # index window-local slots and the caller advances the origin
        self.state = PriceState(cluster, params, device=device,
                                window=window)
        self.accepted: Dict[int, Schedule] = {}
        self.rejected: List[int] = []
        self.total_utility = 0.0
        self.decision_seconds: List[float] = []
        # Lemma-2 instrumentation: per-accepted-job primal/dual increments
        # (P_i - P_{i-1}, D_i - D_{i-1}); Theorem 4 rests on
        # ΔP >= ΔD / alpha.
        self.track_duality = track_duality
        self.primal_deltas: List[float] = []
        self.dual_deltas: List[float] = []

    # -- Alg. 1 "upon arrival of job i" ------------------------------------
    def propose(self, job: Job) -> Optional[Schedule]:
        """Alg. 2 candidate at current prices (no commitment).  ``None``
        means no schedule has positive payoff — Alg. 1 would reject."""
        t0 = time.perf_counter()
        with (_obs.span("decide", jid=job.jid, core=self.core)
              if _obs.ENABLED else _obs.NULL_SPAN):
            sched = best_schedule_fused(job, self.state, core=self.core,
                                        precision=self.precision)
        dt = time.perf_counter() - t0
        self.decision_seconds.append(dt)
        if _obs.ENABLED:
            _obs.inc("decide.decisions")
            _obs.observe("decide.seconds", dt)
        return sched

    def on_arrival(self, job: Job) -> Optional[Schedule]:
        return self._resolve(job, self.propose(job))

    def on_arrivals(self, jobs: List[Job]) -> List[Optional[Schedule]]:
        """A burst of arrivals, committed one job after another in (stable)
        arrival order, with Alg. 1's semantics exactly: the result equals,
        job for job, ``on_arrival`` in that order.

        On the tiled route a burst of ``BURST_MIN`` jobs or more is
        decided together first (``decide_burst``: one launch group per
        shape bucket, at the prices the burst starts at), as the
        reference's ``impl="jax"`` does:

        * a speculative REJECT is final: commits only raise prices and
          shrink headroom, so a non-positive best payoff stays so;
        * a speculative ACCEPT is used as it is only while no job of the
          burst has been admitted; after that the job is re-solved at the
          new prices, through its ``RowCache`` synced against the price
          state's dirty-slot log, which recomputes only the tiles the
          commits touched.

        ``decision_seconds`` carries each job's share of the speculative
        pass, plus its placement or re-solve.

        The whole route decides one job at a time: its backtrack takes
        the exact first-index split, the tiled route's a ``_SPLIT_TOL``
        band, and the two pick different splits on near-ties (7058.48
        against 7082.08 at the 10x instance), so feeding it the tiled
        route's candidates would change its trajectory."""
        order = sorted(range(len(jobs)), key=lambda i: jobs[i].arrival)
        out: List[Optional[Schedule]] = [None] * len(jobs)
        if self.core != "tiled" or len(jobs) < BURST_MIN:
            for i in order:
                out[i] = self.on_arrival(jobs[i])
            return out
        times: List[float] = []
        with (_obs.span("decide_burst", n=len(jobs), core=self.core)
              if _obs.ENABLED else _obs.NULL_SPAN):
            pends = decide_burst([jobs[i] for i in order], self.state,
                                 precision=self.precision, timings=times)
        prices_moved = False
        for pos, i in enumerate(order):
            pend, pends[pos] = pends[pos], None    # free the launch tables
            t0 = time.perf_counter()
            if pend is None:                   # dcap == 0: trivial reject
                sched = None
            elif pend.best_t < 0 or not prices_moved:
                sched = _materialize(pend, self.state)
            else:
                rec = _obs.ENABLED
                with (_obs.span("decide.row_cache_sync", jid=jobs[i].jid)
                      if rec else _obs.NULL_SPAN):
                    pend.cache.sync(self.state)
                with (_obs.span("decide.resolve", jid=jobs[i].jid)
                      if rec else _obs.NULL_SPAN):
                    sched = best_schedule_fused(jobs[i], self.state,
                                                core="tiled",
                                                precision=self.precision,
                                                row_cache=pend.cache)
            self.decision_seconds.append(times[pos]
                                         + time.perf_counter() - t0)
            out[i] = self._resolve(jobs[i], sched)
            prices_moved = prices_moved or out[i] is not None
        if _obs.ENABLED:
            _obs.inc("decide.decisions", len(jobs))
        return out

    def _resolve(self, job: Job, sched: Optional[Schedule]
                 ) -> Optional[Schedule]:
        """Alg. 1 lines 5-11: admit iff positive payoff, commit, bump prices."""
        if sched is None:                       # mu_i <= 0 -> reject
            self.rejected.append(job.jid)
            return None
        if self.track_duality:
            # prices move only inside the committed slot window, so the
            # Lemma-2 increments are computed from those slots alone
            w_slots = np.fromiter(sched.workers.keys(), dtype=np.int64,
                                  count=len(sched.workers))
            z_slots = np.fromiter(sched.ps.keys(), dtype=np.int64,
                                  count=len(sched.ps))
            p0 = self.state.worker_prices_at(w_slots)
            q0 = self.state.ps_prices_at(z_slots)
        self.state.commit(job, sched.workers, sched.ps)
        if self.track_duality:
            p1 = self.state.worker_prices_at(w_slots)
            q1 = self.state.ps_prices_at(z_slots)
            # ΔD = mu_i + Σ (p' - p) c_h + Σ (q' - q) c_k   (Lemma 2)
            d_delta = sched.payoff
            d_delta += float(((p1 - p0) *
                              self.cluster.worker_caps[None]).sum())
            d_delta += float(((q1 - q0) * self.cluster.ps_caps[None]).sum())
            self.primal_deltas.append(sched.utility)
            self.dual_deltas.append(d_delta)
        self.accepted[job.jid] = sched
        self.total_utility += sched.utility
        return sched

    # -- views used by the simulator ---------------------------------------
    def allocation_at(self, t: int) -> Dict[int, tuple]:
        out = {}
        for jid, sched in self.accepted.items():
            if t in sched.workers:
                out[jid] = (sched.workers[t], sched.ps.get(t))
        return out
