"""Event-driven simulator for OASiS on PyTorch: the episodic driver
(``run``) and the continuous-serving driver (``run_stream``).

OASiS commits schedules at arrival, so arrival bursts, cancellations and
fleet transitions are the only events: each burst goes through
``OASiS.on_arrivals`` (one decision per job, in arrival order, on the
price state's device), per-slot GPU usage is read off the allocation
tensor, and capacity feasibility is one whole-state comparison.  The
scenario hooks of the reference engine's OASiS loops
(``_drive_oasis_gen``, ``_drive_oasis_stream_gen``):

* ``cancellations``: ``{jid: slot}``, the job departs at ``slot``; its
  remaining allocation is released and it earns nothing.  A slot at or
  before the job's arrival, or at or after ``T``, is a no-op.
* ``fleet``: a ``sim/fleet.py::FleetTrace``.  At each transition slot
  recovered servers are unblocked first; jobs holding a failed or drained
  server from that slot on are preempted: their tails are released, their
  work rolls back to the last ``ckpt_interval`` boundary of the global
  clock (a lossy failure) or to the drain's start (graceful), the down
  servers are blocked (``PriceState.block_server``), and the rescaled
  remainder is re-admitted through ``OASiS.on_arrival`` with its utility
  curve shifted (``_shift_utility``), or dropped.  An empty trace is an
  exact no-op.

``run_stream`` serves an open-ended arrival stream over a rolling
``window``-slot price state (``PriceState.advance``): each job is decided
in window-local coordinates (arrival 0), completions are absolute, and
memory stays bounded by the window (``SimResult.window_bytes``).

The reactive baselines, the learned scheduler, the ``throughput=``
perturbation and external deciders (``policy=``) come in later slices.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..core.oasis import OASiS
from ..core.pricing import PriceParams, price_params_from_jobs
from ..core.types import ClusterSpec, Job, Schedule, SigmoidUtility
from .fleet import DOWN_LOSSY, UP, FleetState, FleetTrace

# checkpoint cadence for fleet churn, in slots: victims of a lossy failure
# roll back to the last multiple of this on the global clock
CKPT_INTERVAL = 20


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


def _unported(scheduler: str, **hooks) -> None:
    if scheduler != "oasis":
        raise NotImplementedError(
            f"scheduler={scheduler!r}: the reactive baselines and the learned "
            "scheduler are not ported yet (a later slice of the port)")
    for name, hook in hooks.items():
        if hook is not None:
            raise NotImplementedError(
                f"{name}=: not ported yet (a later slice of the port)")


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
        cancellations: Optional[Dict[int, int]] = None, throughput=None,
        fleet: Optional[FleetTrace] = None,
        ckpt_interval: int = CKPT_INTERVAL, policy=None) -> SimResult:
    """Drive OASiS through the trace event by event on ``device`` (None:
    the CUDA card), every decision through the decision core ``core``
    (``"whole"`` or ``"tiled"``, see ``core/schedule_torch.py``).  The
    reference ``engine.run``'s contract for OASiS, with its
    ``cancellations`` and ``fleet`` hooks (module docstring); price
    parameters come from the trace when not given.  Under cancellations or
    churn the utility is evaluated at each job's actual completion against
    its original curve.

    Example::

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
    """
    _unported(scheduler, throughput=throughput, policy=policy)
    T = cluster.T
    jmap = {j.jid: j for j in jobs}
    by_slot, cancel_slot = _group_events(jobs, cancellations, T)
    params = params or price_params_from_jobs(jobs, cluster)
    osched = OASiS(cluster, params, device=device, core=core)
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
            for job_r in readmit:
                ljobs[job_r.jid] = job_r
                if osched.on_arrival(job_r) is None:
                    n_dropped += 1
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
        if batch:
            osched.on_arrivals(batch)
        if check:
            _check(osched, t)
            if churn:
                _check_alloc(ljobs, _live_alloc(osched, lambda _: t,
                                                canceled),
                             fs.worker_caps, fs.ps_caps)

    completion = {jid: sched.finish for jid, sched in osched.accepted.items()
                  if jid not in canceled}
    completion.update(forced_completion)
    if not canceled and not churn:
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
               core: str = "whole") -> SimResult:
    """Drive OASiS over an open-ended arrival stream on ``device`` (None:
    the CUDA card), through the decision core ``core``.

    ``jobs`` is any iterable in nondecreasing arrival order (typically
    ``workload.stream_jobs``), consumed lazily; ``cluster.T`` bounds
    nothing.  The price state keeps a ``window``-slot rolling horizon,
    advanced to each event's slot; a job is decided at local arrival 0
    and its completion is absolute.  ``params`` default to
    :func:`stream_price_params` of the first ``warmup_sample`` jobs (which
    are then replayed).  ``fleet`` slots are absolute; down servers are
    re-blocked after every advance.  ``utilization`` is over the elapsed
    clock, through the last completion.

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
    _unported(scheduler)
    device = resolve_device(device)
    if params is None:
        it = iter(jobs)
        sample = list(itertools.islice(it, warmup_sample))
        params = stream_price_params(sample, cluster, window)
        jobs = itertools.chain(sample, it)
    osched = OASiS(cluster, params, device=device, core=core, window=window)
    state = osched.state
    jmap: Dict[int, Job] = {}
    arrivals: Dict[int, int] = {}
    completion: Dict[int, int] = {}
    # absolute finish of running accepted jobs; their entries (and their
    # schedules in osched.accepted, in slots local to their admission) are
    # pruned once the clock passes them
    active: Dict[int, int] = {}
    n_accepted = n_jobs = 0
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
            for jid, loc in readmit:
                ljobs[jid] = loc
                sched = osched.on_arrival(loc)
                if sched is not None:
                    active[jid] = completion[jid] = t + sched.finish
                    admit_origin[jid] = t
                else:
                    # the shrunken fleet cannot fit it: it departs with no
                    # utility (subtracted above)
                    n_dropped += 1
                    n_accepted -= 1
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
        if batch:
            for job, loc, sched in zip(batch, local,
                                       osched.on_arrivals(local)):
                if sched is not None:
                    n_accepted += 1
                    active[job.jid] = completion[job.jid] = t + sched.finish
                    if churn:
                        ljobs[job.jid] = loc
                        admit_origin[job.jid] = t
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
