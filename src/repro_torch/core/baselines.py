"""Baseline schedulers from the paper's evaluation (Sec. V-A):

FIFO, DRF (dominant-resource fairness), RRH (risk-reward heuristic),
and a Dorm-like utilization-maximizing repacker; and ``Learned``, FIFO's
machinery with per-job counts from an external policy.  All are *reactive*
slot-steppers sharing one interface so the simulator can drive any of
them interchangeably with OASiS.

The port's own copy of the reference's ``core/baselines.py``.  The
reactive baselines run on the host in numpy, as in the reference: a
repack is a few hundred jobs x 5 resources of first-fit scans, so nothing
here creates a torch tensor, and every placement equals the reference's
bit for bit.

Each scheduler's ``step`` is the vectorized batch-round repack of
``core/repack.py``: dense ``(n, R)`` demand arrays, masked whole-round
passes, futile-retry elision.  The reference's own greedy loops
(``step_reference`` there) are the oracle its placements are held to
(``tests/test_torch_repack.py``).

``dirty`` tracks whether the next ``step`` can differ from the last one:
arrivals and repack-relevant completions set it, no-op events (a
completion with an empty wait queue under FIFO/RRH, a rejected RRH
arrival) leave it unset so the sim engine can skip the repack entirely.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from . import repack
from .repack import DensePool, _place_fast
from .types import ClusterSpec, Job


class ReactiveScheduler:
    """Base class: admit-all, allocate per slot.

    Admission is split into ``would_admit`` (the pure decision) and
    ``enroll`` (the state mutation) so an external decider — the rl/
    subsystem's learned policy, or a replay policy asserting env/engine
    equivalence — can substitute its own decision while reusing the
    scheduler's allocation machinery.  ``on_arrival`` composes the two and
    is the unchanged entry point for the simulators.
    """

    name = "base"

    def __init__(self, cluster: ClusterSpec, fixed_workers: int = 8):
        self.cluster = cluster
        self.fixed_workers = fixed_workers
        self.jobs: Dict[int, Job] = {}
        self.unfinished: List[int] = []    # insertion == arrival order
        self.alloc: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.pool = DensePool(cluster.worker_caps.shape[1])
        self.dirty = True
        # Effective capacities every repack packs against.  They default
        # to the cluster's own arrays (the *same objects* — the zero-churn
        # paths stay bit-identical) and are swapped for masked copies by
        # ``set_capacity`` when the fleet-churn engine takes servers down.
        self.worker_caps = cluster.worker_caps
        self.ps_caps = cluster.ps_caps

    # -- events -------------------------------------------------------------
    def would_admit(self, job: Job, t: int) -> bool:
        """The scheduler's own admission decision (no state change)."""
        return True          # admit-all

    def enroll(self, job: Job, t: int) -> None:
        """Admit ``job`` unconditionally (bookkeeping only)."""
        self.jobs[job.jid] = job
        self.unfinished.append(job.jid)
        self.pool.add(job)
        self.dirty = True

    def on_arrival(self, job: Job, t: int) -> bool:
        if not self.would_admit(job, t):
            return False
        self.enroll(job, t)
        return True

    def on_completion(self, jid: int, t: int) -> None:
        if jid in self.unfinished:
            self.unfinished.remove(jid)
        self.alloc.pop(jid, None)
        self.pool.remove(jid)
        # never clear an already-pending dirty (e.g. an arrival in the
        # same event batch that has not been stepped yet)
        self.dirty = self.dirty or self._completion_dirties()

    # -- fleet churn (sim/fleet.py) -----------------------------------------
    def set_capacity(self, worker_caps: np.ndarray,
                     ps_caps: np.ndarray) -> None:
        """Swap in the surviving fleet's effective capacity arrays
        (``FleetState.worker_caps``/``ps_caps``: dead servers masked to
        0-rows).  Every repack thereafter packs against the survivors."""
        self.worker_caps = worker_caps
        self.ps_caps = ps_caps
        self.dirty = True

    def preempt(self, jid: int, t: int) -> None:
        """Evict ``jid``'s allocation (its servers died); the job stays
        enrolled — ``unfinished`` keeps its arrival position, RRH keeps
        its admission ``_meta`` — so the next repack re-queues it through
        the scheduler's own resume order."""
        self.alloc.pop(jid, None)
        self.dirty = True

    def _completion_dirties(self) -> bool:
        """Can this completion change the next ``step`` output?  Freed
        capacity triggers a whole-set repack (DRF/Dorm) as long as
        anything is still live; FIFO/RRH refine this to "something is
        waiting" (running jobs keep their placement)."""
        return bool(self.unfinished)

    def _counts(self, job: Job) -> Tuple[int, int]:
        n = min(self.fixed_workers, job.num_chunks)
        return n, job.ps_for(n)

    def step(self, t: int) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError


class FIFO(ReactiveScheduler):
    """Jobs served strictly in arrival order with fixed worker counts."""

    name = "fifo"

    def _completion_dirties(self) -> bool:
        # running jobs keep their placement; only a waiting job can use
        # the freed capacity
        return any(j not in self.alloc for j in self.unfinished)

    def step(self, t: int) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        free_w = self.worker_caps.astype(float).copy()
        free_s = self.ps_caps.astype(float).copy()
        out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        running = [j for j in self.unfinished if j in self.alloc]
        repack.deduct_running(free_w, [self.alloc[j][0] for j in running],
                              [self.jobs[j].worker_res for j in running])
        repack.deduct_running(free_s, [self.alloc[j][1] for j in running],
                              [self.jobs[j].ps_res for j in running])
        out.update((j, self.alloc[j]) for j in running)
        for jid in self.unfinished:
            if jid in self.alloc:
                continue
            job = self.jobs[jid]
            nw, nps = self._counts(job)
            y = _place_fast(nw, free_w, job.worker_res)
            if y is None:
                break                        # FIFO head-of-line blocking
            z = _place_fast(nps, free_s, job.ps_res)
            if z is None:
                free_w += y[:, None] * job.worker_res[None]
                break
            self.alloc[jid] = (y, z)
            out[jid] = (y, z)
        return out


class DRF(ReactiveScheduler):
    """Dominant-resource max-min fairness via progressive filling."""

    name = "drf"

    def step(self, t: int) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        return repack.drf_repack(self.worker_caps, self.ps_caps,
                                 self.pool, self.unfinished)


class RRH(ReactiveScheduler):
    """Risk-reward heuristic [Irwin et al., HPDC'04 as used in the paper]:
    admit iff estimated utility minus a delay cost clears a threshold;
    running jobs keep fixed counts, paused jobs resume by payoff density."""

    name = "rrh"

    def __init__(self, cluster: ClusterSpec, fixed_workers: int = 8,
                 delay_penalty: float = 0.5, threshold: float = 0.0):
        super().__init__(cluster, fixed_workers)
        self.delay_penalty = delay_penalty
        self.threshold = threshold
        # jid -> (nw, nps, est duration, payoff-density denominator); the
        # static parts of the resume-order key, precomputed at admission
        self._meta: Dict[int, Tuple[int, int, int, float]] = {}

    def would_admit(self, job: Job, t: int) -> bool:
        nw, _ = self._counts(job)
        est_dur = math.ceil(job.total_work_slots / max(nw, 1))
        backlog = len(self.unfinished)
        reward = job.utility(est_dur) - self.delay_penalty * backlog
        return reward > self.threshold

    def enroll(self, job: Job, t: int) -> None:
        nw, nps = self._counts(job)
        est_dur = math.ceil(job.total_work_slots / max(nw, 1))
        self._meta[job.jid] = (nw, nps, est_dur,
                               max(nw * job.worker_res.sum(), 1e-9))
        super().enroll(job, t)

    def on_completion(self, jid: int, t: int) -> None:
        super().on_completion(jid, t)
        self._meta.pop(jid, None)

    def _completion_dirties(self) -> bool:
        # no paused job to resume -> freed capacity changes nothing
        return any(j not in self.alloc for j in self.unfinished)

    def step(self, t: int) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        free_w = self.worker_caps.astype(float).copy()
        free_s = self.ps_caps.astype(float).copy()
        out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        running = [j for j in self.unfinished if j in self.alloc]
        repack.deduct_running(free_w, [self.alloc[j][0] for j in running],
                              [self.jobs[j].worker_res for j in running])
        repack.deduct_running(free_s, [self.alloc[j][1] for j in running],
                              [self.jobs[j].ps_res for j in running])
        out.update((j, self.alloc[j]) for j in running)
        waiting = [j for j in self.unfinished if j not in self.alloc]
        order = repack.rrh_resume_order([self.jobs[j] for j in waiting],
                                        [self._meta[j] for j in waiting], t)
        for i in order:
            jid = waiting[int(i)]
            job = self.jobs[jid]
            nw, nps, _, _ = self._meta[jid]
            y = _place_fast(nw, free_w, job.worker_res)
            if y is None:
                continue
            z = _place_fast(nps, free_s, job.ps_res)
            if z is None:
                free_w += y[:, None] * job.worker_res[None]
                continue
            self.alloc[jid] = (y, z)
            out[jid] = (y, z)
        return out


class Dorm(ReactiveScheduler):
    """Dorm-like repacking: on each event maximize cluster utilization
    subject to round-robin fairness (MILP of [18] approximated greedily)."""

    name = "dorm"

    def step(self, t: int) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        return repack.dorm_repack(self.worker_caps, self.ps_caps,
                                  self.pool, self.unfinished)


class Learned(FIFO):
    """FIFO's machinery with per-job worker/PS counts chosen by an external
    policy at admission (the ``rl`` package's action space).

    A job admitted with counts ``(nw, nps)`` holds exactly that allocation
    from the moment it fits until it completes; waiting jobs start in
    arrival order, head-of-line blocked.  Without counts set it is FIFO
    verbatim (``_counts`` falls back to the fixed-worker rule): a policy
    that replays FIFO's counts reproduces the FIFO run bit for bit.
    """

    name = "learned"

    def __init__(self, cluster: ClusterSpec, fixed_workers: int = 8):
        super().__init__(cluster, fixed_workers=fixed_workers)
        self.counts_for: Dict[int, Tuple[int, int]] = {}

    def set_counts(self, jid: int, nw: int, nps: int) -> None:
        """Pin the worker/PS counts the next ``step`` allocates."""
        self.counts_for[jid] = (int(nw), int(nps))

    def _counts(self, job: Job) -> Tuple[int, int]:
        if job.jid in self.counts_for:
            return self.counts_for[job.jid]
        return super()._counts(job)

    def on_completion(self, jid: int, t: int) -> None:
        super().on_completion(jid, t)
        self.counts_for.pop(jid, None)


BASELINES = {"fifo": FIFO, "drf": DRF, "rrh": RRH, "dorm": Dorm,
             "learned": Learned}
