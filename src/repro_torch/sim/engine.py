"""Event-driven simulator on PyTorch: the episodic driver (``run``) and
the continuous-serving driver (``run_stream``), for OASiS and for the
reactive baselines of the paper's comparison (FIFO, DRF, RRH, Dorm).

OASiS commits schedules at arrival, so arrival bursts, cancellations and
fleet transitions are the only events: each burst goes through
``OASiS.on_arrivals`` (one decision per job, in arrival order, on the
price state's device), per-slot GPU usage is read off the allocation
tensor, and capacity feasibility is one whole-state comparison.

The reactive baselines (``core/baselines.py``) run on the host in numpy,
as in the reference, and create no torch tensor: between two events a
scheduler's ``step(t)`` is constant, so the driver repacks only at event
slots (and only when the scheduler's ``dirty`` flag says the event can
change the plan) and fast-forwards work with one vectorized update:
per-job completion slots are ``ceil(remaining / rate)`` over the live
set, and the clock jumps to the earliest completion or the next event.
The float arithmetic is the reference's op for op, so every reactive
result equals the reference's bit for bit.

The scenario hooks of the reference engine (``_drive_oasis_gen``,
``_drive_reactive``, and their streamed counterparts), for every
scheduler:

* ``cancellations``: ``{jid: slot}``, the job departs at ``slot``; its
  remaining allocation is released and it earns nothing.  A slot at or
  before the job's arrival, or at or after ``T``, is a no-op.
* ``fleet``: a ``sim/fleet.py::FleetTrace``.  At each transition slot
  recovered servers are unblocked first; jobs holding a failed or drained
  server from that slot on are preempted: their work rolls back to the
  last ``ckpt_interval`` boundary of the global clock (a lossy failure)
  or to the drain's start (graceful).  OASiS releases their tails, blocks
  the down servers (``PriceState.block_server``) and re-admits the
  rescaled remainder through ``OASiS.on_arrival`` with its utility curve
  shifted (``_shift_utility``), or drops it; a reactive scheduler keeps
  the victim enrolled and repacks over the survivors
  (``ReactiveScheduler.preempt``, ``set_capacity``).  An empty trace is
  an exact no-op.
* ``throughput``: ``fn(job, n_workers, slot) -> factor in (0, 1]``, a
  per-(job, slot) work-rate perturbation (``sim/scenarios.py``'s
  stragglers).  OASiS keeps its committed schedules and accounts the
  perturbed work over their slots (accepted jobs in commit order, slots
  ascending): a schedule that under-delivers completes nothing, and the
  utility is evaluated at the actual completion against the original
  curve.  A reactive run consumes the factors as it goes: a ``stateless``
  fn with ``rate_matrix`` gives a ``(n_live, horizon chunk)`` block per
  plan span, completions found by row cumsums; a stateful one (straggler
  detection) is called slot by slot, live jobs in plan order.

``run_stream`` serves an open-ended arrival stream; for OASiS over a
rolling ``window``-slot price state (``PriceState.advance``): each job is
decided in window-local coordinates (arrival 0), completions are
absolute, and memory stays bounded by the window
(``SimResult.window_bytes``).

Every driver is a *decision generator*, as in the reference: without a
policy (``run``/``run_stream`` with ``policy=None``) it never yields and
each scheduler decides for itself on the code paths above.
:func:`decisions` and :func:`stream_decisions` (and ``policy=``) yield a
:class:`DecisionPoint` per arrival, and per re-admission of a churn
victim (``preempted=True``), and apply the answer through the same
machinery: OASiS proposes one job at a time (``OASiS.propose``) and the
answer gates the commitment (``OASiS._resolve``); a reactive scheduler
admits through ``enroll`` on the answer, and ``scheduler="learned"``
(``core/baselines.py::Learned``) takes the answer's counts, clamped to
the job's envelope.  A policy that answers with ``DecisionPoint.expert``
replays ``run`` exactly.  This is the ``rl/`` package's substrate.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import (Callable, Dict, Generator, Iterable, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from .. import obs as _obs
from .. import resolve_device
from ..core.baselines import BASELINES, Learned, ReactiveScheduler
from ..core.oasis import OASiS
from ..core.pricing import PriceParams, price_params_from_jobs
from ..core.types import ClusterSpec, Job, Schedule, SigmoidUtility
from .fleet import DOWN_LOSSY, UP, FleetState, FleetTrace

ThroughputFn = Callable[[Job, int, int], float]

# checkpoint cadence for fleet churn, in slots: victims of a lossy failure
# roll back to the last multiple of this on the global clock
CKPT_INTERVAL = 20

# slots of look-ahead in a DecisionPoint's capacity windows
DECISION_WINDOW = 8

# horizon chunk of the stateless-throughput rate matrix, in slots
_RATE_BLOCK = 64


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
    canceled: int = 0                       # jobs departed mid-run
    # fleet churn: preemptions suffered by admitted jobs, and the victims
    # the shrunken fleet could not re-admit (dropped)
    preempted: int = 0
    preempt_dropped: int = 0
    # worker-pool GPU fraction alive at the end (1.0 without churn)
    live_frac: float = 1.0
    arrivals: Dict[int, int] = dataclasses.field(default_factory=dict)
    # streamed runs: host bytes of the price state's rolling window; None
    # for an episodic run
    window_bytes: Optional[int] = None
    # episodic runs: every accepted job's committed schedule
    schedules: Dict[int, object] = dataclasses.field(default_factory=dict)
    device_uploads: int = 0                 # full price-state uploads

    def summary(self) -> Dict[str, object]:
        """Episode digest: accept and completion rates, latency
        percentiles (completion slot minus arrival; None when nothing
        completed), total utility.  The rl env's terminal ``info``."""
        lat = np.array([self.completion[j] - self.arrivals[j]
                        for j in self.completion if j in self.arrivals],
                       dtype=float)
        n = max(self.n_jobs, 1)
        return {
            "scheduler": self.name,
            "n_jobs": self.n_jobs,
            "accepted": self.accepted,
            "completed": self.completed,
            "canceled": self.canceled,
            "preempted": self.preempted,
            "preempt_dropped": self.preempt_dropped,
            "live_frac": float(self.live_frac),
            "accept_rate": self.accepted / n,
            "completion_rate": self.completed / n,
            "total_utility": float(self.total_utility),
            "mean_latency": float(lat.mean()) if lat.size else None,
            "p50_latency": float(np.percentile(lat, 50)) if lat.size else None,
            "p95_latency": float(np.percentile(lat, 95)) if lat.size else None,
            "utilization": float(self.utilization),
        }


@dataclasses.dataclass
class DecisionPoint:
    """One admission decision, yielded by :func:`decisions` and
    :func:`stream_decisions`.

    ``expert`` replays the wrapped scheduler's own decision: ``(n_workers,
    n_ps)``, ``n_workers == 0`` meaning reject.  For OASiS the counts mean
    only admit or reject (the commitment is ``candidate``, Alg. 2's best
    schedule at current prices); for a reactive scheduler they are its
    counts, which only ``scheduler="learned"`` takes literally.

    ``free_frac_workers``/``free_frac_ps``: (DECISION_WINDOW, R) free
    capacity fractions of each pool per slot over ``[t, t + W)`` (slots
    at or after the horizon read 0.0); a reactive scheduler's allocation
    is constant between events, so its snapshot is tiled across the
    window.  ``live_frac`` is the worker pool's GPU fraction alive, and
    ``preempted`` marks the re-admission of a churn victim; both keep
    their defaults without churn.
    """

    job: Job
    t: int
    scheduler: str
    expert: Tuple[int, int]
    candidate: Optional[Schedule]
    utility_so_far: float
    n_running: int
    n_waiting: int
    accepted: int
    rejected: int
    free_frac_workers: np.ndarray
    free_frac_ps: np.ndarray
    live_frac: float = 1.0
    preempted: bool = False


def _as_counts(action) -> Tuple[int, int]:
    """A decider's answer as ``(n_workers, n_ps)``; ``n_ps`` -1 means the
    least feasible PS count.  ``None``, ``False`` and 0 reject."""
    if action is None or action is False:
        return 0, -1
    if isinstance(action, (tuple, list, np.ndarray)):
        a = np.asarray(action).ravel()
        return max(int(a[0]), 0), int(a[1]) if a.size > 1 else -1
    return max(int(action), 0), -1


def _free_window(used_w: np.ndarray, used_s: np.ndarray,
                 cluster: ClusterSpec, t: int,
                 t_max: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(W, R) free capacity fractions of both pools from per-slot pool
    usage (an (R,) snapshot is tiled across the window).  Slots at or
    after ``t_max`` (the horizon; None in a stream) read 0.0."""
    W = DECISION_WINDOW
    cap_w = np.maximum(cluster.worker_caps.sum(axis=0), 1e-9)
    cap_s = np.maximum(cluster.ps_caps.sum(axis=0), 1e-9)
    fw = np.zeros((W, cap_w.shape[0]))
    fs = np.zeros((W, cap_s.shape[0]))
    if used_w.ndim == 1:
        used_w = np.tile(used_w, (W, 1))
        used_s = np.tile(used_s, (W, 1))
    fw[:used_w.shape[0]] = np.clip(1.0 - used_w / cap_w, 0.0, 1.0)
    fs[:used_s.shape[0]] = np.clip(1.0 - used_s / cap_s, 0.0, 1.0)
    if t_max is not None:
        live = max(min(t_max - t, W), 0)
        fw[live:] = 0.0
        fs[live:] = 0.0
    return fw, fs


def _pool_usage(cur_alloc: Dict[int, tuple], jmap: Dict[int, Job],
                cluster: ClusterSpec) -> Tuple[np.ndarray, np.ndarray]:
    """(R,) worker- and PS-pool usage of one allocation snapshot."""
    used_w = np.zeros(cluster.worker_caps.shape[1])
    used_s = np.zeros(cluster.ps_caps.shape[1])
    for jid, (y, z) in cur_alloc.items():
        used_w += float(y.sum()) * jmap[jid].worker_res
        if z is not None:
            used_s += float(z.sum()) * jmap[jid].ps_res
    return used_w, used_s


def _oasis_decision_point(osched: OASiS, cluster: ClusterSpec, job: Job,
                          t: int, cand: Optional[Schedule], t_win: int,
                          n_running: int, accepted: int, rejected: int,
                          t_max: Optional[int], live_frac: float = 1.0,
                          preempted: bool = False) -> DecisionPoint:
    """OASiS's decision on ``job`` at ``t`` with the candidate ``cand``;
    the capacity window is read off the price state's host mirror from
    its slot ``t_win`` (``t`` episodic, 0 in a stream's local
    coordinates)."""
    g_win, v_win = osched.state.alloc_window(t_win, DECISION_WINDOW)
    fw, fs = _free_window(g_win, v_win, cluster, t, t_max=t_max)
    return DecisionPoint(
        job=job, t=t, scheduler="oasis",
        expert=(1, 0) if cand is not None else (0, 0), candidate=cand,
        utility_so_far=osched.total_utility, n_running=n_running,
        n_waiting=0, accepted=accepted, rejected=rejected,
        free_frac_workers=fw, free_frac_ps=fs, live_frac=live_frac,
        preempted=preempted)


def _reactive_decision_point(rsched: ReactiveScheduler, cluster: ClusterSpec,
                             job: Job, t: int, scheduler: str,
                             cur_alloc: Dict[int, tuple],
                             usage: Tuple[np.ndarray, np.ndarray],
                             n_admitted: int, n_rejected: int, n_live: int,
                             utility_so_far: float,
                             t_max: Optional[int],
                             live_frac: float = 1.0) -> DecisionPoint:
    fw, fs = _free_window(*usage, cluster, t, t_max=t_max)
    admit = rsched.would_admit(job, t)
    nw, nps = rsched._counts(job)
    return DecisionPoint(
        job=job, t=t, scheduler=scheduler,
        expert=(nw, nps) if admit else (0, 0), candidate=None,
        utility_so_far=utility_so_far,
        n_running=len(cur_alloc), n_waiting=n_live - len(cur_alloc),
        accepted=n_admitted, rejected=n_rejected,
        free_frac_workers=fw, free_frac_ps=fs, live_frac=live_frac)


def _enroll(rsched: ReactiveScheduler, job: Job, t: int, action) -> bool:
    """Admit ``job`` on a decider's answer: ``scheduler="learned"`` takes
    its counts, clamped to the job's envelope (at most ``num_chunks``
    workers, at least the bandwidth-matched PS count).  False: rejected."""
    nw, nps = _as_counts(action)
    if nw <= 0:
        return False
    if isinstance(rsched, Learned):
        nw = min(nw, job.num_chunks)
        rsched.set_counts(job.jid, nw, max(nps, job.ps_for(nw)))
    rsched.enroll(job, t)
    return True


def _exhaust(gen) -> "SimResult":
    """Run a driver that decides for itself: it never yields."""
    try:
        next(gen)
    except StopIteration as e:
        return e.value
    raise RuntimeError("the engine yielded a decision point without a policy")


def _with_policy(gen, policy) -> "SimResult":
    """Answer each decision point of ``gen`` with ``policy(dp)``.  Where
    the driver records no decision times (the reactive ones in decide
    mode), the policy's times take their place."""
    seconds: List[float] = []
    try:
        dp = next(gen)
        while True:
            t0 = time.perf_counter()
            action = policy(dp)
            seconds.append(time.perf_counter() - t0)
            dp = gen.send(action)
    except StopIteration as e:
        result = e.value
    if not result.decision_seconds:
        result.decision_seconds = seconds
    return result


def _needs_policy(scheduler: str, policy) -> None:
    if scheduler == "learned" and policy is None:
        raise ValueError(
            "scheduler='learned' needs a policy: pass policy=... (see "
            "repro_torch.rl.policy.LearnedDecider) or train one with "
            "repro_torch.rl.train")


def _with_quantum(job: Job, quantum: Optional[int]) -> Job:
    """Workload quantization (``Job.workload``): ``0`` picks the quantum
    that keeps every workload within 1200 DP units."""
    if quantum is None:
        return job
    q = quantum if quantum > 0 else max(
        1, math.ceil(job.epochs * job.num_chunks / 1200))
    return dataclasses.replace(job, quantum=q)


def _shift_utility(u, shift: int):
    """Utility of a victim re-admitted ``shift`` slots after its original
    arrival: durations then count from the re-admission, so ``f(d)``
    becomes ``f(d + shift)``, for the sigmoid the same curve with its
    target pulled ``shift`` slots closer.  Always shifted from the
    original job's utility, so repeated preemptions stay exact."""
    if not shift:
        return u
    if isinstance(u, SigmoidUtility):
        return dataclasses.replace(u, gamma3=u.gamma3 - shift)
    return lambda d, _u=u, _s=shift: _u(d + _s)


def _target_gaps(jmap: Dict[int, Job], completion: Dict[int, int]) -> List[float]:
    gaps = []
    for jid, tdone in completion.items():
        u = jmap[jid].utility
        if getattr(u, "gamma2", 0) > 0:
            gaps.append((tdone - jmap[jid].arrival) - u.gamma3)
    return gaps


def _group_events(jobs: Sequence[Job], cancellations: Optional[Dict[int, int]],
                  T: int) -> Tuple[Dict[int, List[Job]], Dict[int, List[int]]]:
    """Arrival bursts and cancellations by slot.  Jobs arriving at or after
    T are never seen; a cancellation counts only strictly between the
    job's arrival and T."""
    by_slot: Dict[int, List[Job]] = {}
    arrival = {}
    for j in jobs:
        if j.arrival >= T:
            continue
        by_slot.setdefault(j.arrival, []).append(j)
        arrival[j.jid] = j.arrival
    cancel_slot: Dict[int, List[int]] = {}
    for jid, c in (cancellations or {}).items():
        if jid in arrival and arrival[jid] < c < T:
            cancel_slot.setdefault(int(c), []).append(jid)
    return by_slot, cancel_slot


def _check_alloc(jmap: Dict[int, Job], alloc: Dict[int, tuple],
                 wc: np.ndarray, pc: np.ndarray) -> None:
    """Capacity feasibility of one slot's allocation ``{jid: (y, z)}``
    against capacities ``wc``/``pc``: under churn the surviving fleet's,
    whose down servers have 0-rows."""
    if not alloc:
        return
    ids = list(alloc)
    ys = np.stack([alloc[j][0] for j in ids]).astype(float)        # (n, H)
    wres = np.stack([jmap[j].worker_res for j in ids])             # (n, R)
    if not np.all(ys.T @ wres <= wc + 1e-6):
        raise RuntimeError("worker capacity of the live fleet violated")
    zs = [(j, alloc[j][1]) for j in ids if alloc[j][1] is not None]
    if zs:
        zmat = np.stack([z for _, z in zs]).astype(float)
        sres = np.stack([jmap[j].ps_res for j, _ in zs])
        if not np.all(zmat.T @ sres <= pc + 1e-6):
            raise RuntimeError("PS capacity of the live fleet violated")


def _check(osched: OASiS, t: int) -> None:
    ok_w, ok_ps = osched.state.capacity_ok()
    if not (ok_w and ok_ps):
        raise RuntimeError(f"capacity violated at slot {t} (workers ok: "
                           f"{ok_w}, PS ok: {ok_ps})")


def _holds(sched: Schedule, pool: str, srv: int, s0: int) -> bool:
    """Whether ``sched`` places anything on server ``srv`` of ``pool`` at
    a slot ``>= s0`` (its own slot coordinates)."""
    alloc = sched.workers if pool == "worker" else sched.ps
    return any(s >= s0 and a[srv] > 0 for s, a in alloc.items())


def _victim_copy(jcur: Job, orig: Job, sched: Schedule, kind: str, t: int,
                 ck: int, origin: int, arrival: int):
    """A victim preempted at absolute slot ``t``: rolled back to the last
    ``ck`` boundary (lossy) or to ``t`` (graceful).  ``origin``: the
    absolute slot of the schedule's slot 0.  Returns ``(None, done)`` when
    the checkpoint covers all its work (``done``: the completion slot),
    else ``(the rescaled remainder arriving at local slot arrival,
    None)``."""
    cb = (t // ck) * ck if kind == DOWN_LOSSY else t
    delivered = sum(float(y.sum()) for s, y in sched.workers.items()
                    if s + origin < cb)
    rem = jcur.total_work_slots - delivered
    if rem <= 1e-9:
        done = [s + origin for s, y in sched.workers.items()
                if s + origin < cb and y.sum() > 0]
        return None, (max(done) if done else max(cb - 1, 0))
    scale = jcur.work_scale * rem / jcur.total_work_slots
    return dataclasses.replace(
        jcur, arrival=arrival, work_scale=scale,
        utility=_shift_utility(orig.utility, t - int(orig.arrival))), None


def _perturbed_finish(job: Job, sched: Schedule,
                      throughput: ThroughputFn) -> Optional[int]:
    """The slot at which ``sched`` delivers ``job``'s work under the rate
    perturbation ``throughput``, its slots taken in ascending order (the
    factors of a stateful fn depend on the order of calls); None if it
    under-delivers.  Under churn ``job`` is the live copy, which carries
    only the post-checkpoint work, and ``sched`` its final segment."""
    slots = sorted(sched.workers)
    w = np.array([float(sched.workers[t].sum()) for t in slots])
    f = np.array([throughput(job, int(c), t) for t, c in zip(slots, w)])
    cum = np.cumsum(w * f)
    hit = np.flatnonzero(cum >= job.total_work_slots - 1e-9)
    return slots[int(hit[0])] if hit.size else None


def _oasis_counts(osched: OASiS, t: int) -> Tuple[int, int, int]:
    """(running, accepted, rejected) of an episodic OASiS run at ``t``."""
    return (sum(1 for s in osched.accepted.values() if s.finish >= t),
            len(osched.accepted), len(osched.rejected))


def _live_alloc(osched: OASiS, s_of, skip) -> Dict[int, tuple]:
    """``{jid: (y, z)}`` of every accepted schedule, not in ``skip``, that
    deploys at its own slot ``s_of(jid)``."""
    out = {}
    for jid, sched in osched.accepted.items():
        s = s_of(jid)
        if jid not in skip and s in sched.workers:
            out[jid] = (sched.workers[s], sched.ps.get(s))
    return out


def run(cluster: ClusterSpec, jobs: Sequence[Job], scheduler: str = "oasis",
        params: Optional[PriceParams] = None, check: bool = True,
        quantum: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
        core: str = "whole",
        cancellations: Optional[Dict[int, int]] = None,
        throughput: Optional[ThroughputFn] = None,
        fleet: Optional[FleetTrace] = None,
        ckpt_interval: int = CKPT_INTERVAL, policy=None,
        obs: Optional[_obs.Obs] = None,
        precision: str = "auto") -> SimResult:
    """Drive ``scheduler`` (``"oasis"`` or a reactive baseline: ``"fifo"``,
    ``"drf"``, ``"rrh"``, ``"dorm"``) through the trace event by event.
    OASiS decides on ``device`` (None: the CUDA card), every decision
    through the decision core ``core`` (``"whole"`` or ``"tiled"``, see
    ``core/schedule_torch.py``); a reactive baseline runs on the host,
    but the device is resolved first all the same.  The reference
    ``engine.run``'s contract, with its ``cancellations``, ``fleet`` and
    ``throughput`` hooks (module docstring); OASiS's price parameters come
    from the trace when not given.  Under any hook OASiS's utility is
    evaluated at each job's actual completion against its original curve.

    ``policy`` (``scheduler="learned"`` needs one: ValueError without)
    answers each decision point of :func:`decisions`; the run's
    ``decision_seconds`` are then OASiS's own, or the policy's for a
    reactive scheduler.  Without one each scheduler decides for itself
    and no decision point is built.

    ``obs`` installs a flight recorder (``repro_torch.obs.Obs``) for the
    run: its spans and counters land there, and the previous recorder
    (none by default) is restored on return.  ``precision`` is OASiS's
    decision dtype (``schedule_torch.route_dtype``: ``"auto"`` and
    ``"x64"`` float64, ``"x32"`` float32), passed on as ``core`` is.

    Example — the same trace under OASiS and a reactive baseline::

        >>> from repro_torch.sim import engine
        >>> from repro_torch.sim.fleet import churn_trace
        >>> from repro_torch.sim.workload import make_cluster, make_jobs
        >>> cluster = make_cluster(T=20, H=3, K=3)
        >>> jobs = make_jobs(4, T=20, seed=0, small=True)
        >>> r = engine.run(cluster, jobs, device="cpu")
        >>> r.accepted, r.total_utility > 0
        (4, True)
        >>> r = engine.run(cluster, jobs, device="cpu", cancellations={3: 9},
        ...                fleet=churn_trace(cluster, frac=0.5, seed=1))
        >>> r.live_frac <= 1.0, r.completed <= r.accepted
        (True, True)
        >>> r = engine.run(cluster, jobs, scheduler="fifo", device="cpu")
        >>> (r.n_jobs, r.accepted, r.completed)
        (4, 4, 4)
    """
    _needs_policy(scheduler, policy)
    kw = dict(params=params, check=check, quantum=quantum, device=device,
              core=core, cancellations=cancellations, throughput=throughput,
              fleet=fleet, ckpt_interval=ckpt_interval, precision=precision)
    with _obs.activate(obs):
        if policy is not None:
            return _with_policy(decisions(cluster, jobs, scheduler, **kw),
                                policy)
        return _exhaust(_drivers(cluster, jobs, scheduler, decide=False,
                                 **kw))


def decisions(cluster: ClusterSpec, jobs: Sequence[Job],
              scheduler: str = "oasis",
              params: Optional[PriceParams] = None, check: bool = True,
              quantum: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None,
              core: str = "whole",
              cancellations: Optional[Dict[int, int]] = None,
              throughput: Optional[ThroughputFn] = None,
              fleet: Optional[FleetTrace] = None,
              ckpt_interval: int = CKPT_INTERVAL, precision: str = "auto"
              ) -> Generator[DecisionPoint, object, SimResult]:
    """The engine as a stepwise decision process (the rl env's substrate):
    :func:`run`'s arguments, a :class:`DecisionPoint` yielded per arrival
    (and per re-admission of a churn victim), the answer ``send``-ed back:
    ``(n_workers, n_ps)``, a bare worker count, or ``None``/0 to reject.
    The :class:`SimResult` is the generator's return value
    (``StopIteration.value``).  The device is resolved at the call."""
    return _drivers(cluster, jobs, scheduler, params=params, check=check,
                    quantum=quantum, device=device, core=core,
                    cancellations=cancellations, throughput=throughput,
                    fleet=fleet, ckpt_interval=ckpt_interval, decide=True,
                    precision=precision)


def _drivers(cluster, jobs, scheduler, params, check, quantum, device, core,
             cancellations, throughput, fleet, ckpt_interval, decide,
             precision="auto"):
    device = resolve_device(device)
    if scheduler != "oasis":
        return _drive_reactive(cluster, jobs, scheduler, check, quantum,
                               cancellations, throughput, fleet,
                               ckpt_interval, decide)
    return _drive_oasis(cluster, jobs, params, check, quantum, device, core,
                        cancellations, throughput, fleet, ckpt_interval,
                        decide, precision)


def _drive_oasis(cluster: ClusterSpec, jobs: Sequence[Job],
                 params: Optional[PriceParams], check: bool,
                 quantum: Optional[int], device: torch.device, core: str,
                 cancellations: Optional[Dict[int, int]],
                 throughput: Optional[ThroughputFn],
                 fleet: Optional[FleetTrace], ckpt_interval: int,
                 decide: bool, precision: str = "auto"
                 ) -> Generator[DecisionPoint, object, SimResult]:
    T = cluster.T
    jmap = {j.jid: j for j in jobs}
    by_slot, cancel_slot = _group_events(jobs, cancellations, T)
    params = params or price_params_from_jobs(jobs, cluster)
    osched = OASiS(cluster, params, device=device, core=core,
                   precision=precision)
    state = osched.state
    total_gpu = max(float(cluster.worker_caps[:, 0].sum()), 1e-9)
    canceled: set = set()
    # every churn branch is gated on a non-empty trace: the empty trace is
    # an exact no-op
    churn = fleet is not None and bool(fleet)
    fs = FleetState(cluster, fleet) if churn else None
    # the live copy per job: re-admitted victims are rescaled copies
    ljobs = dict(jmap) if churn else jmap
    ck = max(int(ckpt_interval), 1)
    forced_completion: Dict[int, int] = {}
    blocked_gpu = 0.0          # the blocks' GPU-slot filler on down servers
    n_preempted = n_dropped = 0

    slots = set(by_slot) | set(cancel_slot)
    if churn:
        slots |= set(fs.event_slots)
    for t in sorted(slots):
        if churn:
            trans = fs.step(t)
            cs = (_obs.span("churn_step", t=t, transitions=len(trans))
                  if _obs.ENABLED else _obs.NULL_SPAN)
            cs.__enter__()
            # recoveries first: their headroom is visible to this slot's
            # re-admissions and arrivals
            for pool, srv, kind in trans:
                if kind == UP:
                    blocked_gpu -= state.unblock_server(pool, srv, t)
            victims: Dict[int, str] = {}
            for pool, srv, kind in trans:
                if kind == UP:
                    continue
                for jid, sched in osched.accepted.items():
                    if not (jid in victims or jid in canceled
                            or sched.finish < t) and _holds(sched, pool,
                                                            srv, t):
                        victims[jid] = kind
            readmit: List[Job] = []
            for jid, kind in victims.items():
                sched = osched.accepted.pop(jid)
                jcur = ljobs[jid]
                state.release(jcur,
                              {s: y for s, y in sched.workers.items()
                               if s >= t},
                              {s: z for s, z in sched.ps.items() if s >= t})
                osched.total_utility -= sched.utility
                n_preempted += 1
                if _obs.ENABLED:
                    _obs.inc("engine.preemptions")
                job_r, done = _victim_copy(jcur, jmap[jid], sched, kind, t,
                                           ck, 0, t)
                if job_r is None:
                    forced_completion[jid] = done
                else:
                    readmit.append(job_r)
            # block after the victims' tails are released (their content is
            # then exactly the fill) and before re-admission
            for pool, srv, kind in trans:
                if kind != UP:
                    blocked_gpu += state.block_server(pool, srv, t)
            if _obs.ENABLED:
                cs.set(victims=len(victims), readmits=len(readmit))
            cs.__exit__(None, None, None)
            for job_r in readmit:
                ljobs[job_r.jid] = job_r
                if decide:
                    cand = osched.propose(job_r)
                    action = yield _oasis_decision_point(
                        osched, cluster, job_r, t, cand, t,
                        *_oasis_counts(osched, t), t_max=T,
                        live_frac=fs.live_frac, preempted=True)
                    sched = osched._resolve(
                        job_r, cand if _as_counts(action)[0] > 0 else None)
                else:
                    sched = osched.on_arrival(job_r)
                if sched is None:
                    n_dropped += 1
                    if _obs.ENABLED:
                        _obs.inc("engine.preempt_dropped")
        for jid in cancel_slot.get(t, ()):
            sched = osched.accepted.get(jid)
            if sched is None or sched.finish < t or jid in canceled:
                # finished, never admitted, departed, or a dropped victim
                continue
            state.release(ljobs[jid],
                          {s: y for s, y in sched.workers.items() if s >= t},
                          {s: z for s, z in sched.ps.items() if s >= t})
            canceled.add(jid)
        batch = [_with_quantum(job, quantum) for job in by_slot.get(t, ())]
        if churn:
            for job in batch:
                ljobs[job.jid] = job
        if _obs.ENABLED and batch:
            _obs.inc("engine.arrivals", len(batch))
        if decide:
            # one job at a time at current prices, the answer gating the
            # commitment: sequential decisions are the burst path's
            # semantics exactly (``on_arrivals``)
            for job in sorted(batch, key=lambda j: j.arrival):
                cand = osched.propose(job)
                action = yield _oasis_decision_point(
                    osched, cluster, job, t, cand, t,
                    *_oasis_counts(osched, t), t_max=T,
                    live_frac=fs.live_frac if churn else 1.0)
                osched._resolve(job,
                                cand if _as_counts(action)[0] > 0 else None)
        elif batch:
            with (_obs.span("arrival_burst", t=t, n=len(batch))
                  if _obs.ENABLED else _obs.NULL_SPAN):
                osched.on_arrivals(batch)
        if check:
            _check(osched, t)
            if churn:
                _check_alloc(ljobs, _live_alloc(osched, lambda _: t,
                                                canceled),
                             fs.worker_caps, fs.ps_caps)

    completion: Dict[int, int] = {}
    for jid, sched in osched.accepted.items():
        if jid in canceled:
            continue
        if throughput is None:
            completion[jid] = sched.finish
        else:
            done = _perturbed_finish(ljobs[jid], sched, throughput)
            if done is not None:                # else: under-delivered
                completion[jid] = done
    completion.update(forced_completion)
    if not canceled and throughput is None and not churn:
        total_utility = osched.total_utility
    else:
        # at the actual completion slot, against the original job
        total_utility = sum(jmap[jid].utility(tdone - jmap[jid].arrival)
                            for jid, tdone in completion.items())
    gpu_slots = state.gpu_slot_usage()
    if churn and T:
        # the blocks' filler is in the allocation tensor but is no usage
        utilization = float((gpu_slots.sum() - blocked_gpu)
                            / (total_gpu * T))
    else:
        utilization = float(np.mean(gpu_slots / total_gpu)) if T else 0.0
    return SimResult(name="oasis", total_utility=total_utility,
                     accepted=len(osched.accepted) + len(forced_completion),
                     completed=len(completion),
                     n_jobs=len(jobs), completion=completion,
                     target_gap=_target_gaps(jmap, completion),
                     decision_seconds=osched.decision_seconds,
                     utilization=utilization, canceled=len(canceled),
                     preempted=n_preempted, preempt_dropped=n_dropped,
                     live_frac=fs.live_frac if churn else 1.0,
                     arrivals={j.jid: j.arrival for j in jobs
                               if j.arrival < T},
                     schedules=dict(osched.accepted),
                     device_uploads=state.device_uploads)


# ---------------------------------------------------------------------------
# Continuous serving: an open-ended arrival stream over a rolling window
# ---------------------------------------------------------------------------

def stream_price_params(sample: Sequence[Job], cluster: ClusterSpec,
                        window: int, floor_frac: float = 0.05) -> PriceParams:
    """U/L price bounds for a streamed run from a warmup sample, each job
    taken at arrival 0 against a ``T=window`` view of the cluster (the
    window is the serving mode's horizon)."""
    view = dataclasses.replace(cluster, T=int(window))
    sample0 = [dataclasses.replace(j, arrival=0) for j in sample]
    return price_params_from_jobs(sample0, view, floor_frac=floor_frac)


def run_stream(cluster: ClusterSpec, jobs: Iterable[Job],
               scheduler: str = "oasis",
               params: Optional[PriceParams] = None, window: int = 64,
               check: bool = False, quantum: Optional[int] = None,
               warmup_sample: int = 256, fleet: Optional[FleetTrace] = None,
               ckpt_interval: int = CKPT_INTERVAL,
               device: Optional[Union[str, torch.device]] = None,
               core: str = "whole", policy=None,
               obs: Optional[_obs.Obs] = None,
               precision: str = "auto") -> SimResult:
    """Drive ``scheduler`` over an open-ended arrival stream: OASiS on
    ``device`` (None: the CUDA card), through the decision core ``core``;
    a reactive baseline on the host, after the device is resolved, with
    no slot-indexed state (``window_bytes`` 0).

    ``jobs`` is any iterable in nondecreasing arrival order (typically
    ``workload.stream_jobs``), consumed lazily; ``cluster.T`` bounds
    nothing.  For OASiS the price state keeps a ``window``-slot rolling
    horizon, advanced to each event's slot; a job is decided at local
    arrival 0 and its completion is absolute.  ``params`` default to
    :func:`stream_price_params` of the first ``warmup_sample`` jobs (which
    are then replayed).  ``fleet`` slots are absolute; down servers are
    re-blocked after every advance.  ``utilization`` is over the elapsed
    clock, through the last completion.  ``policy`` answers each decision
    point of :func:`stream_decisions`, and ``obs`` records the run (the
    warm-up sample included), and ``precision`` sets OASiS's decision
    dtype, as in :func:`run`.

    Example — a bounded slice of a stream through a 16-slot window::

        >>> import itertools
        >>> from repro_torch.sim import engine
        >>> from repro_torch.sim.workload import make_cluster, stream_jobs
        >>> cluster = make_cluster(T=20, H=3, K=3)
        >>> arrivals = itertools.islice(
        ...     stream_jobs(rate=0.5, seed=1, small=True), 12)
        >>> r = engine.run_stream(cluster, arrivals, window=16,
        ...                       device="cpu")
        >>> (r.n_jobs, r.accepted, r.window_bytes, r.device_uploads)
        (12, 12, 3840, 1)
    """
    _needs_policy(scheduler, policy)
    kw = dict(params=params, window=window, check=check, quantum=quantum,
              warmup_sample=warmup_sample, fleet=fleet,
              ckpt_interval=ckpt_interval, device=device, core=core,
              precision=precision)
    with _obs.activate(obs):
        if policy is not None:
            return _with_policy(
                stream_decisions(cluster, jobs, scheduler, **kw), policy)
        return _exhaust(_stream_drivers(cluster, jobs, scheduler,
                                        decide=False, **kw))


def stream_decisions(cluster: ClusterSpec, jobs: Iterable[Job],
                     scheduler: str = "oasis",
                     params: Optional[PriceParams] = None, window: int = 64,
                     check: bool = False, quantum: Optional[int] = None,
                     warmup_sample: int = 256,
                     fleet: Optional[FleetTrace] = None,
                     ckpt_interval: int = CKPT_INTERVAL,
                     device: Optional[Union[str, torch.device]] = None,
                     core: str = "whole", precision: str = "auto"
                     ) -> Generator[DecisionPoint, object, SimResult]:
    """The streaming counterpart of :func:`decisions`: :func:`run_stream`'s
    arguments, a :class:`DecisionPoint` yielded per arrival (and per
    re-admission of a churn victim), the :class:`SimResult` returned.
    Capacity windows are open-ended (no horizon)."""
    return _stream_drivers(cluster, jobs, scheduler, params=params,
                           window=window, check=check, quantum=quantum,
                           warmup_sample=warmup_sample, fleet=fleet,
                           ckpt_interval=ckpt_interval, device=device,
                           core=core, decide=True, precision=precision)


def _stream_drivers(cluster, jobs, scheduler, params, window, check, quantum,
                    warmup_sample, fleet, ckpt_interval, device, core,
                    decide, precision="auto"):
    device = resolve_device(device)
    if scheduler != "oasis":
        return _drive_reactive_stream(cluster, jobs, scheduler, check,
                                      quantum, fleet, ckpt_interval, decide)
    if params is None:
        it = iter(jobs)
        sample = list(itertools.islice(it, warmup_sample))
        params = stream_price_params(sample, cluster, window)
        jobs = itertools.chain(sample, it)
    return _drive_oasis_stream(cluster, jobs, params, window, check, quantum,
                               fleet, ckpt_interval, device, core, decide,
                               precision)


def _drive_oasis_stream(cluster: ClusterSpec, jobs: Iterable[Job],
                        params: PriceParams, window: int, check: bool,
                        quantum: Optional[int], fleet: Optional[FleetTrace],
                        ckpt_interval: int, device: torch.device, core: str,
                        decide: bool, precision: str = "auto"
                        ) -> Generator[DecisionPoint, object, SimResult]:
    osched = OASiS(cluster, params, device=device, core=core, window=window,
                   precision=precision)
    state = osched.state
    jmap: Dict[int, Job] = {}
    arrivals: Dict[int, int] = {}
    completion: Dict[int, int] = {}
    # absolute finish of running accepted jobs; their entries (and their
    # schedules in osched.accepted, in slots local to their admission) are
    # pruned once the clock passes them
    active: Dict[int, int] = {}
    n_accepted = n_rejected = n_jobs = 0
    t = 0
    churn = fleet is not None and bool(fleet)
    fs = FleetState(cluster, fleet) if churn else None
    fe: List[int] = fs.event_slots if churn else []
    fi = 0
    ljobs: Dict[int, Job] = {}          # live (quantized, rescaled) copies
    admit_origin: Dict[int, int] = {}   # absolute slot of a schedule's 0
    ck = max(int(ckpt_interval), 1)
    blocked_gpu = 0.0
    n_preempted = n_dropped = 0
    it = iter(jobs)
    nxt = next(it, None)
    while True:
        ta = int(nxt.arrival) if nxt is not None else None
        tf = fe[fi] if fi < len(fe) else None
        if ta is None and (tf is None or not active):
            break                       # fleet events can touch nothing
        t = ta if (tf is None or (ta is not None and ta <= tf)) else tf
        batch: List[Job] = []
        while nxt is not None and int(nxt.arrival) == t:
            batch.append(nxt)
            nxt = next(it, None)
        with (_obs.span("stream_advance", t=t) if _obs.ENABLED
              else _obs.NULL_SPAN):
            state.advance(t)
        for jid in [j for j, fin in active.items() if fin < t]:
            del active[jid]
            osched.accepted.pop(jid, None)
            admit_origin.pop(jid, None)
            ljobs.pop(jid, None)
        if churn:
            # the slots the slide opened start at zero: refill every down
            # server (idempotent on the slots already full)
            for pool, srv in fs.down_servers():
                blocked_gpu += state.block_server(pool, srv, 0)
        if churn and tf == t:
            fi += 1
            trans = fs.step(t)
            cs = (_obs.span("churn_step", t=t, transitions=len(trans))
                  if _obs.ENABLED else _obs.NULL_SPAN)
            cs.__enter__()
            for pool, srv, kind in trans:
                if kind == UP:
                    blocked_gpu -= state.unblock_server(pool, srv, 0)
            victims: Dict[int, str] = {}
            for pool, srv, kind in trans:
                if kind == UP:
                    continue
                for jid in active:
                    sched = osched.accepted.get(jid)
                    if not (jid in victims or sched is None) and _holds(
                            sched, pool, srv, t - admit_origin[jid]):
                        victims[jid] = kind
            readmit: List[Tuple[int, Job]] = []
            for jid, kind in victims.items():
                sched = osched.accepted.pop(jid)
                ao = admit_origin[jid]
                shift = t - ao
                jcur = ljobs[jid]
                # the schedule's slots are local to its admission; the
                # window has slid by ``shift`` since
                state.release(jcur,
                              {s - shift: y for s, y in sched.workers.items()
                               if s >= shift},
                              {s - shift: z for s, z in sched.ps.items()
                               if s >= shift})
                osched.total_utility -= sched.utility
                n_preempted += 1
                if _obs.ENABLED:
                    _obs.inc("engine.preemptions")
                del active[jid]
                job_r, done = _victim_copy(jcur, jmap[jid], sched, kind, t,
                                           ck, ao, 0)
                if job_r is None:
                    completion[jid] = done
                    admit_origin.pop(jid, None)
                    ljobs.pop(jid, None)
                else:
                    readmit.append((jid, job_r))
            for pool, srv, kind in trans:
                if kind != UP:
                    blocked_gpu += state.block_server(pool, srv, 0)
            if _obs.ENABLED:
                cs.set(victims=len(victims), readmits=len(readmit))
            cs.__exit__(None, None, None)
            for jid, loc in readmit:
                ljobs[jid] = loc
                if decide:
                    cand = osched.propose(loc)
                    action = yield _oasis_decision_point(
                        osched, cluster, jmap[jid], t, cand, 0, len(active),
                        n_accepted, n_rejected, t_max=None,
                        live_frac=fs.live_frac, preempted=True)
                    sched = osched._resolve(
                        loc, cand if _as_counts(action)[0] > 0 else None)
                else:
                    sched = osched.on_arrival(loc)
                if sched is not None:
                    active[jid] = completion[jid] = t + sched.finish
                    admit_origin[jid] = t
                else:
                    # the shrunken fleet cannot fit it: it departs with no
                    # utility (subtracted above)
                    n_dropped += 1
                    if _obs.ENABLED:
                        _obs.inc("engine.preempt_dropped")
                    n_accepted -= 1
                    n_rejected += 1
                    completion.pop(jid, None)
                    admit_origin.pop(jid, None)
                    ljobs.pop(jid, None)
        # window-local coordinates: the job arrives at local slot 0 (its
        # durations, hence its utility, are translation-invariant)
        local = [dataclasses.replace(_with_quantum(j, quantum), arrival=0)
                 for j in batch]
        for j in batch:
            jmap[j.jid] = j
            arrivals[j.jid] = int(j.arrival)
        n_jobs += len(batch)
        if _obs.ENABLED and batch:
            _obs.inc("engine.arrivals", len(batch))
        scheds = ()
        if batch and not decide:
            with (_obs.span("arrival_burst", t=t, n=len(batch))
                  if _obs.ENABLED else _obs.NULL_SPAN):
                scheds = osched.on_arrivals(local)
        for i, (job, loc) in enumerate(zip(batch, local)):
            if decide:
                cand = osched.propose(loc)
                action = yield _oasis_decision_point(
                    osched, cluster, job, t, cand, 0, len(active),
                    n_accepted, n_rejected, t_max=None,
                    live_frac=fs.live_frac if churn else 1.0)
                sched = osched._resolve(
                    loc, cand if _as_counts(action)[0] > 0 else None)
            else:
                sched = scheds[i]
            if sched is not None:
                n_accepted += 1
                active[job.jid] = completion[job.jid] = t + sched.finish
                if churn:
                    ljobs[job.jid] = loc
                    admit_origin[job.jid] = t
            else:
                n_rejected += 1
        if check:
            _check(osched, t)
            if churn:
                _check_alloc(ljobs, _live_alloc(
                    osched, lambda j: t - admit_origin[j], ()),
                    fs.worker_caps, fs.ps_caps)
    # elapsed clock: through the last committed completion
    t_end = max(max(completion.values(), default=0) + 1, t + 1, 1)
    total_gpu = max(float(cluster.worker_caps[:, 0].sum()), 1e-9)
    gpu_slots = state.retired_gpu_slots + float(state.gpu_slot_usage().sum())
    if churn:
        gpu_slots -= blocked_gpu        # the blocks' filler, no usage
    return SimResult(name="oasis", total_utility=osched.total_utility,
                     accepted=n_accepted, completed=len(completion),
                     n_jobs=n_jobs, completion=completion,
                     target_gap=_target_gaps(jmap, completion),
                     decision_seconds=osched.decision_seconds,
                     utilization=gpu_slots / (total_gpu * t_end),
                     preempted=n_preempted, preempt_dropped=n_dropped,
                     live_frac=fs.live_frac if churn else 1.0,
                     arrivals=arrivals, window_bytes=state.window_bytes,
                     device_uploads=state.device_uploads)


# ---------------------------------------------------------------------------
# Reactive baselines: repack at events, fast-forward in between (host only)
# ---------------------------------------------------------------------------

def _preempt_on(trans, cur_alloc: Dict[int, tuple], remaining, ckpt_rem,
                jmap: Dict[int, Job], rsched: ReactiveScheduler,
                t: int) -> int:
    """Evict the jobs placed on the servers that ``trans`` takes down: a
    lossy failure rolls a victim back to its last checkpoint, a drain
    checkpoints it first.  Victims stay enrolled, so the scheduler's own
    queue or resume order re-places them.  Returns the preemptions."""
    n = 0
    for pool, srv, kind in trans:
        if kind == UP:
            continue
        if pool == "worker":
            vs = [jid for jid, (y, _) in cur_alloc.items() if y[srv] > 0]
        else:
            vs = [jid for jid, (_, z) in cur_alloc.items()
                  if z is not None and z[srv] > 0]
        for jid in vs:
            if kind == DOWN_LOSSY:
                remaining[jid] = ckpt_rem.get(jid,
                                              jmap[jid].total_work_slots)
            else:
                ckpt_rem[jid] = remaining[jid]
            rsched.preempt(jid, t)
            cur_alloc.pop(jid, None)
            n += 1
            if _obs.ENABLED:
                _obs.inc("engine.preemptions")
    return n


def _plan_arrays(cur_alloc: Dict[int, tuple], jmap: Dict[int, Job]):
    """(live ids, worker counts, the plan's GPUs) of one allocation."""
    ids = list(cur_alloc)
    counts = np.array([float(cur_alloc[j][0].sum()) for j in ids])
    plan_gpu = float(counts @ np.array(
        [jmap[j].worker_res[0] for j in ids])) if ids else 0.0
    return ids, counts, plan_gpu


def _ckpt_crossed(ids, consumed, remaining, ckpt_rem, t: int, span: int,
                  ck: int) -> None:
    """Record the checkpoint crossed inside ``[t, t + span)``, if any: work
    is consumed uniformly over the span, so the boundary's share of it is
    ``(cb - t) / span``."""
    cb = ((t + span) // ck) * ck
    if cb > t:
        frac = (cb - t) / span
        for j, used in zip(ids, consumed):
            ckpt_rem[j] = max(remaining[j] - float(used) * frac, 0.0)


def _first_completion(ids, counts, remaining) -> float:
    """Slots until the plan's first completion at the plan's constant
    rates (inf when no live job progresses)."""
    rem = np.array([remaining[j] for j in ids])
    active = counts > 0
    slots_left = np.full(len(ids), np.inf)
    if active.any():
        slots_left[active] = np.maximum(
            np.ceil((rem[active] - 1e-9) / counts[active]), 1.0)
    return float(slots_left.min()) if ids else math.inf


def _consume(ids, consumed, remaining, completion, total_utility: float,
             jmap: Dict[int, Job], rsched: ReactiveScheduler,
             cur_alloc: Dict[int, tuple], ckpt_rem, t_end: int):
    """Take the work ``consumed`` off each live job's remainder; the jobs it
    finishes complete at ``t_end``, earn their utility there and leave
    the scheduler.  Returns (the utility total, the jobs it finished)."""
    done_now = []
    for j, used in zip(ids, consumed):
        remaining[j] -= used
        if remaining[j] <= 1e-9:
            done_now.append(j)
    for jid in done_now:
        completion[jid] = t_end
        total_utility += jmap[jid].utility(t_end - jmap[jid].arrival)
        rsched.on_completion(jid, t_end)
        del remaining[jid]
        cur_alloc.pop(jid, None)
        ckpt_rem.pop(jid, None)
    return total_utility, len(done_now)


def _drive_reactive(cluster: ClusterSpec, jobs: Sequence[Job], scheduler: str,
                    check: bool, quantum: Optional[int],
                    cancellations: Optional[Dict[int, int]],
                    throughput: Optional[ThroughputFn],
                    fleet: Optional[FleetTrace], ckpt_interval: int,
                    decide: bool
                    ) -> Generator[DecisionPoint, object, SimResult]:
    """The reference's ``_drive_reactive``.  In decide mode each arrival is
    a decision point, all of a burst's read off the allocation before its
    admissions, and the repacks' times are not recorded (the policy's
    take their place)."""
    T = cluster.T
    src = {j.jid: _with_quantum(j, quantum) for j in jobs}
    jmap = dict(src)
    by_slot, cancel_slot = _group_events(src.values(), cancellations, T)
    rsched: ReactiveScheduler = BASELINES[scheduler](cluster)
    total_gpu = max(float(cluster.worker_caps[:, 0].sum()), 1e-9)
    admitted: List[int] = []
    remaining: Dict[int, float] = {}
    completion: Dict[int, int] = {}
    canceled: set = set()
    total_utility = 0.0
    util_sum = 0.0
    # fleet churn, every branch gated on a non-empty trace.  ``ckpt_rem``:
    # each admitted job's remaining work at its last checkpoint
    churn = fleet is not None and bool(fleet)
    fs = FleetState(cluster, fleet) if churn else None
    ckpt_rem: Dict[int, float] = {}
    ck = max(int(ckpt_interval), 1)
    n_preempted = 0
    decision_seconds: List[float] = []      # each repack's wall clock
    # on an event the scheduler leaves clean (``dirty`` unset), the last
    # allocation, pruned of departed jobs, is what ``step`` would return
    cur_alloc: Dict[int, tuple] = {}
    ids: List[int] = []
    counts = np.zeros(0)
    plan_gpu = 0.0
    stale = True            # the plan's arrays need a rebuild
    use_matrix = (throughput is not None
                  and getattr(throughput, "stateless", False)
                  and callable(getattr(throughput, "rate_matrix", None)))
    event_set = set(by_slot) | set(cancel_slot)
    if churn:
        event_set |= set(fs.event_slots)
    events = sorted(event_set)
    ei = 0
    n_rejected = 0
    t = events[0] if events else T
    while t < T:
        while ei < len(events) and events[ei] <= t:
            ei += 1
        if churn:
            trans = fs.step(t)
            if trans:
                with (_obs.span("churn_step", t=t, transitions=len(trans))
                      if _obs.ENABLED else _obs.NULL_SPAN):
                    n_preempted += _preempt_on(trans, cur_alloc, remaining,
                                               ckpt_rem, jmap, rsched, t)
                    rsched.set_capacity(fs.worker_caps, fs.ps_caps)
                stale = True
        arrivals_now = by_slot.pop(t, ())
        if _obs.ENABLED and arrivals_now:
            _obs.inc("engine.arrivals", len(arrivals_now))
        if decide and arrivals_now:
            usage = _pool_usage(cur_alloc, jmap, cluster)
        for job in arrivals_now:
            if decide:
                action = yield _reactive_decision_point(
                    rsched, cluster, job, t, scheduler, cur_alloc, usage,
                    len(admitted), n_rejected, len(remaining), total_utility,
                    t_max=T, live_frac=fs.live_frac if churn else 1.0)
                ok = _enroll(rsched, job, t, action)
            else:
                ok = rsched.on_arrival(job, t)
            if ok:
                admitted.append(job.jid)
                remaining[job.jid] = job.total_work_slots
            else:
                n_rejected += 1
        cancels_now = cancel_slot.get(t, ())
        for jid in cancels_now:
            if jid in remaining:                # admitted, still running
                rsched.on_completion(jid, t)    # out of the pool, no utility
                del remaining[jid]
                canceled.add(jid)
                cur_alloc.pop(jid, None)
                ckpt_rem.pop(jid, None)
                stale = True
        if rsched.dirty:
            t0 = time.perf_counter()
            with (_obs.span("repack", t=t, scheduler=scheduler,
                            n_live=len(remaining))
                  if _obs.ENABLED else _obs.NULL_SPAN):
                cur_alloc = dict(rsched.step(t))
            if not decide:
                decision_seconds.append(time.perf_counter() - t0)
            rsched.dirty = False
            stale = True
            if check:       # a pruned reuse stays feasible by construction
                _check_alloc(jmap, cur_alloc,
                             fs.worker_caps if churn else cluster.worker_caps,
                             fs.ps_caps if churn else cluster.ps_caps)
        elif _obs.ENABLED and (arrivals_now or cancels_now
                               or (churn and trans)):
            # an event landed and the scheduler kept its last plan
            _obs.inc("repack.dirty_skips")
        if stale:
            ids, counts, plan_gpu = _plan_arrays(cur_alloc, jmap)
            stale = False
        ff = (_obs.span("ffwd", t=t, n_live=len(ids)) if _obs.ENABLED
              else _obs.NULL_SPAN)
        ff.__enter__()
        next_ev = events[ei] if ei < len(events) else T
        horizon = min(next_ev, T) - t
        if throughput is None:
            span = int(min(_first_completion(ids, counts, remaining),
                           float(horizon)))
            span = max(span, 1)
            consumed = counts * span
        elif use_matrix and ids:
            # factors for every (live job, slot) of a block, completions by
            # row cumsums; only the slots up to the earliest completion are
            # consumed, the rest recomputed after the repack (stateless fn)
            h = min(horizon, _RATE_BLOCK)
            M = np.empty((len(ids), h))
            for i, jid_ in enumerate(ids):
                M[i] = throughput.rate_matrix(jmap[jid_], int(counts[i]), t,
                                              h)
            M *= counts[:, None]
            cum = np.cumsum(M, axis=1)
            rem = np.array([remaining[j] for j in ids])
            hits = cum >= rem[:, None] - 1e-9
            first = np.where(hits.any(axis=1), hits.argmax(axis=1), h)
            k = int(first.min())
            span = k + 1 if k < h else h
            consumed = cum[:, span - 1]
        elif use_matrix:
            span = min(horizon, _RATE_BLOCK)
            consumed = counts                   # no live job: empty
        else:
            # a stateful fn: one slot, live jobs in plan order
            consumed = counts * np.array(
                [throughput(jmap[j], int(c), t) for j, c in zip(ids, counts)]) \
                if ids else counts
            span = 1
        util_sum += (plan_gpu / total_gpu) * span
        t_end = t + span - 1                    # the plan's last slot
        if churn and ids:
            _ckpt_crossed(ids, consumed, remaining, ckpt_rem, t, span, ck)
        total_utility, done = _consume(ids, consumed, remaining, completion,
                                       total_utility, jmap, rsched, cur_alloc,
                                       ckpt_rem, t_end)
        stale = stale or done > 0
        t += span
        if _obs.ENABLED:
            ff.set(slots=span, completed=done)
            ff.__exit__(None, None, None)
            _obs.inc("engine.ffwd_slots", span)
            if done:
                _obs.inc("engine.completions", done)
    return SimResult(name=scheduler, total_utility=total_utility,
                     accepted=len(admitted), completed=len(completion),
                     n_jobs=len(jobs), completion=completion,
                     target_gap=_target_gaps(jmap, completion),
                     decision_seconds=decision_seconds,
                     utilization=util_sum / T if T else 0.0,
                     canceled=len(canceled), preempted=n_preempted,
                     live_frac=fs.live_frac if churn else 1.0,
                     arrivals={j.jid: j.arrival for j in src.values()
                               if j.arrival < T})


def _drive_reactive_stream(cluster: ClusterSpec, jobs: Iterable[Job],
                           scheduler: str, check: bool,
                           quantum: Optional[int],
                           fleet: Optional[FleetTrace], ckpt_interval: int,
                           decide: bool
                           ) -> Generator[DecisionPoint, object, SimResult]:
    """The reference's ``_drive_reactive_stream``: the episodic driver over
    an open-ended stream, the clock unbounded; it ends when the stream
    does and no live job progresses."""
    rsched: ReactiveScheduler = BASELINES[scheduler](cluster)
    total_gpu = max(float(cluster.worker_caps[:, 0].sum()), 1e-9)
    jmap: Dict[int, Job] = {}
    arrivals: Dict[int, int] = {}
    admitted: List[int] = []
    remaining: Dict[int, float] = {}
    completion: Dict[int, int] = {}
    total_utility = 0.0
    util_sum = 0.0
    cur_alloc: Dict[int, tuple] = {}
    ids: List[int] = []
    counts = np.zeros(0)
    plan_gpu = 0.0
    stale = True
    n_jobs = n_rejected = 0
    churn = fleet is not None and bool(fleet)
    fs = FleetState(cluster, fleet) if churn else None
    fe: List[int] = fs.event_slots if churn else []
    fi = 0
    ckpt_rem: Dict[int, float] = {}
    ck = max(int(ckpt_interval), 1)
    n_preempted = 0
    decision_seconds: List[float] = []
    it = iter(jobs)
    nxt = next(it, None)
    t = int(nxt.arrival) if nxt is not None else 0
    while nxt is not None or remaining:
        if churn:
            changed = False
            while fi < len(fe) and fe[fi] <= t:
                with (_obs.span("churn_step", t=fe[fi]) if _obs.ENABLED
                      else _obs.NULL_SPAN):
                    n_preempted += _preempt_on(fs.step(fe[fi]), cur_alloc,
                                               remaining, ckpt_rem, jmap,
                                               rsched, t)
                changed = True
                fi += 1
            if changed:
                rsched.set_capacity(fs.worker_caps, fs.ps_caps)
                stale = True
        burst: List[Job] = []
        while nxt is not None and int(nxt.arrival) <= t:
            burst.append(_with_quantum(nxt, quantum))
            nxt = next(it, None)
        if _obs.ENABLED and burst:
            _obs.inc("engine.arrivals", len(burst))
        if decide and burst:
            usage = _pool_usage(cur_alloc, jmap, cluster)
        for job in burst:
            n_jobs += 1
            jmap[job.jid] = job
            arrivals[job.jid] = int(job.arrival)
            if decide:
                action = yield _reactive_decision_point(
                    rsched, cluster, job, t, scheduler, cur_alloc, usage,
                    len(admitted), n_rejected, len(remaining), total_utility,
                    t_max=None, live_frac=fs.live_frac if churn else 1.0)
                ok = _enroll(rsched, job, t, action)
            else:
                ok = rsched.on_arrival(job, t)
            if ok:
                admitted.append(job.jid)
                remaining[job.jid] = job.total_work_slots
            else:
                n_rejected += 1
        if rsched.dirty:
            t0 = time.perf_counter()
            with (_obs.span("repack", t=t, scheduler=scheduler,
                            n_live=len(remaining))
                  if _obs.ENABLED else _obs.NULL_SPAN):
                cur_alloc = dict(rsched.step(t))
            if not decide:
                decision_seconds.append(time.perf_counter() - t0)
            rsched.dirty = False
            stale = True
            if check:
                _check_alloc(jmap, cur_alloc,
                             fs.worker_caps if churn else cluster.worker_caps,
                             fs.ps_caps if churn else cluster.ps_caps)
        elif _obs.ENABLED and (burst or (churn and changed)):
            _obs.inc("repack.dirty_skips")
        if stale:
            ids, counts, plan_gpu = _plan_arrays(cur_alloc, jmap)
            stale = False
        earliest = _first_completion(ids, counts, remaining)
        horizon = (int(nxt.arrival) - t) if nxt is not None else math.inf
        if churn and fi < len(fe):
            # the next fleet event bounds the plan (and may restore the
            # capacity a waiting queue starves for)
            horizon = min(horizon, fe[fi] - t)
        if not math.isfinite(earliest) and not math.isfinite(horizon):
            # no arrival left and no live job progressing: the plan cannot
            # change again, the waiting jobs never complete
            break
        span = max(int(min(earliest, horizon)), 1)
        consumed = counts * span
        util_sum += (plan_gpu / total_gpu) * span
        t_end = t + span - 1
        if churn and ids:
            _ckpt_crossed(ids, consumed, remaining, ckpt_rem, t, span, ck)
        total_utility, done = _consume(ids, consumed, remaining, completion,
                                       total_utility, jmap, rsched, cur_alloc,
                                       ckpt_rem, t_end)
        stale = stale or done > 0
        t += span
        if _obs.ENABLED:
            _obs.inc("engine.ffwd_slots", span)
            if done:
                _obs.inc("engine.completions", done)
    return SimResult(name=scheduler, total_utility=total_utility,
                     accepted=len(admitted), completed=len(completion),
                     n_jobs=n_jobs, completion=completion,
                     target_gap=_target_gaps(jmap, completion),
                     decision_seconds=decision_seconds,
                     utilization=util_sum / max(t, 1),
                     preempted=n_preempted,
                     live_frac=fs.live_frac if churn else 1.0,
                     arrivals=arrivals, window_bytes=0)
