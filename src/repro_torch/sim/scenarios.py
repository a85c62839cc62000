"""Scenario library: the paper's comparison (Sec. V-A) and beyond.

The port's own copy of the reference's ``sim/scenarios.py``.  Each
scenario builds (cluster, jobs, per-run kwargs) for the event engine and
runs every scheduler it lists on the same seeded trace.  Every runner
takes ``device`` (None: the CUDA card) and ``core`` (the OASiS decision
route, ``"whole"`` or ``"tiled"``) and hands both to each engine run:
OASiS decides there, the reactive baselines run on the host in numpy
(the engine resolves the device first all the same).  Where the
reference picks an OASiS backend (``impl``), the port takes ``core``.

* ``hetero``    — heterogeneous GPU cluster: 8-GPU C4-like, 4-GPU
  mid-range, and 2-GPU high-memory worker classes instead of the paper's
  uniform fleet.
* ``cancel``    — a fraction of admitted jobs departs mid-run; the engine
  releases their allocation (OASiS: dual prices drop) and they earn no
  utility.
* ``straggler`` — per-worker step-time perturbation with persistent slow
  workers; throughput follows the synchronous-training model of
  ``runtime/straggler.py`` (a slot is as fast as its slowest participating
  worker) with and without EMA straggler detection + exclusion.
* ``misest``    — OASiS under mis-estimated U/L price bounds, the Fig. 6
  sweep, on the v2 engine.
* ``scale``     — the fig3-shaped workload at T=500, 100+100 servers,
  2000 jobs; far beyond the v1 per-slot loop's practical ceiling.
* ``serving``   — the continuous-traffic mode: an open-ended diurnal x
  bursty arrival stream (``workload.stream_jobs``) over a paper-scale
  fleet, driven through ``engine.run_stream`` with a rolling price-state
  window; records sustained decisions/sec and the window-bytes memory
  proxy per scheduler.
* ``churn``     — fleet churn: a seeded fraction of each server pool
  fails mid-run (``fleet.churn_trace``); running jobs are preempted with
  checkpoint/restart cost and re-admitted through each scheduler's own
  path.  Reports utility **retention** (churned / churn-free utility,
  higher is better) per scheduler at each churn level.

Example — every scheduler on the mixed fleet at quick size, on the CPU::

    >>> from repro_torch.sim import scenarios
    >>> rows = scenarios.run_scenario("hetero", quick=True, device="cpu")
    >>> [r.scheduler for r in rows]
    ['oasis', 'fifo', 'drf', 'rrh', 'dorm']
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.pricing import price_params_from_jobs
from ..core.types import ClusterSpec, Job
from ..runtime.straggler import StragglerConfig, StragglerMonitor
from . import engine
from .fleet import churn_trace
from .workload import _P2_LIKE, make_cluster, make_jobs, stream_jobs

REACTIVE = ("fifo", "drf", "rrh", "dorm")
ALL_SCHEDULERS = ("oasis",) + REACTIVE

Device = Optional[Union[str, torch.device]]

# worker-server classes for heterogeneous clusters
# resource order: gpu, cpu, mem(GB), storage(GB), bw(Gbps)
_GPU8 = np.array([8.0, 36.0, 60.0, 400.0, 25.0])     # the paper's C4-like
_GPU4 = np.array([4.0, 24.0, 48.0, 300.0, 25.0])     # mid-range
_GPU2_BIGMEM = np.array([2.0, 48.0, 192.0, 600.0, 50.0])


def make_hetero_cluster(T: int = 100, H: int = 50, K: int = 50,
                        mix=(0.4, 0.4, 0.2), seed: int = 0) -> ClusterSpec:
    """A worker fleet mixing the three GPU server classes by ``mix``."""
    rng = np.random.default_rng(seed)
    classes = np.stack([_GPU8, _GPU4, _GPU2_BIGMEM])
    rows = classes[rng.choice(3, size=H, p=np.asarray(mix) / sum(mix))]
    ps = np.tile(_P2_LIKE, (K, 1))
    ps[:, 0] = 0.0
    return ClusterSpec(T=T, worker_caps=rows, ps_caps=ps)


def cancellation_trace(jobs: Sequence[Job], frac: float = 0.25,
                       seed: int = 0) -> Dict[int, int]:
    """Pick ``frac`` of the jobs to depart mid-run, at a slot strictly
    after arrival (the engine requires cancel_slot > arrival) and within
    roughly the job's plausible lifetime."""
    rng = np.random.default_rng(seed)
    chosen = rng.choice(len(jobs), size=max(1, int(frac * len(jobs))),
                        replace=False)
    out = {}
    for idx in chosen:
        job = jobs[idx]
        horizon = max(2, int(2 * job.min_duration))
        out[job.jid] = job.arrival + int(rng.integers(1, horizon + 1))
    return out


class StragglerThroughput:
    """Per-(job, slot) throughput factor from a per-worker step-time model.

    Each job draws a persistent set of slow workers (``slow_frac`` of its
    max pool, ``slowdown``x step time).  In a synchronous slot the job
    progresses at the pace of its slowest participating worker, so the
    undetected factor is ~1/slowdown whenever a slow worker participates.
    With ``detect=True`` a ``runtime.straggler.StragglerMonitor`` sees the
    per-worker step times; flagged workers are excluded from the next
    slot's mesh (the paper-consistent down-scale mitigation), sacrificing
    their work share to restore full-speed steps for the rest.
    """

    def __init__(self, seed: int = 0, slow_frac: float = 0.15,
                 slowdown: float = 3.0, jitter: float = 0.05,
                 detect: bool = True,
                 cfg: Optional[StragglerConfig] = None):
        self.seed = seed
        self.slow_frac = slow_frac
        self.slowdown = slowdown
        self.jitter = jitter
        self.detect = detect
        self.cfg = cfg or StragglerConfig()
        self._slow: Dict[int, np.ndarray] = {}
        self._monitors: Dict[int, StragglerMonitor] = {}
        # without detection the factor is a pure function of (job, slot):
        # the engine may then precompute whole (n_live, horizon) rate
        # blocks via ``rate_matrix`` instead of calling per job per slot
        self.stateless = not detect

    def _job_state(self, job: Job):
        if job.jid not in self._slow:
            rng = np.random.default_rng((self.seed, job.jid))
            self._slow[job.jid] = rng.random(job.num_chunks) < self.slow_frac
            self._monitors[job.jid] = StragglerMonitor(job.num_chunks, self.cfg)
        return self._slow[job.jid], self._monitors[job.jid]

    def __call__(self, job: Job, n_workers: int, slot: int) -> float:
        if n_workers <= 0:
            return 1.0
        slow, monitor = self._job_state(job)
        n = min(n_workers, len(slow))
        rng = np.random.default_rng((self.seed, job.jid, slot))
        times = 1.0 + self.jitter * rng.random(n)
        times[slow[:n]] *= self.slowdown
        include = np.ones(n, dtype=bool)
        if self.detect:
            flagged = [w for w in monitor.stragglers() if w < n]
            include[flagged] = False
        for w in range(n):                      # monitor sees this slot
            monitor.record(w, float(times[w]))
        if not include.any():
            include[:] = True                   # never stall completely
        pace = float(times[include].max())      # synchronous: slowest wins
        return min(1.0, include.sum() / (n * pace))

    def rate_matrix(self, job: Job, n_workers: int, t0: int,
                    h: int) -> np.ndarray:
        """Factors for slots ``[t0, t0 + h)`` at a fixed worker count.

        Only valid when ``stateless`` (detect=False): the draws are seeded
        per (job, slot), so the values equal ``__call__`` slot by slot and
        are independent of block boundaries — the engine may discard and
        recompute any suffix after a replan.  (The monitor bookkeeping
        ``__call__`` performs is skipped; nothing reads it undetected.)
        """
        if not self.stateless:
            raise RuntimeError("rate_matrix requires detect=False")
        if n_workers <= 0:
            return np.ones(h)
        slow, _ = self._job_state(job)
        n = min(n_workers, len(slow))
        sl = slow[:n]
        out = np.empty(h)
        for i in range(h):
            rng = np.random.default_rng((self.seed, job.jid, t0 + i))
            times = 1.0 + self.jitter * rng.random(n)
            times[sl] *= self.slowdown
            pace = float(times.max())
            out[i] = min(1.0, n / (n * pace))
        return out


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    scenario: str
    scheduler: str
    variant: str
    utility: float
    accepted: int
    completed: int
    canceled: int
    utilization: float
    wall_seconds: float
    # latency stats of the run's decisions: OASiS's per-arrival decisions,
    # a reactive baseline's repacks (None when there was none)
    decision_p50: Optional[float] = None
    decision_mean: Optional[float] = None
    decision_p95: Optional[float] = None
    # serving-mode extras: sustained arrival-decision throughput over the
    # whole streamed trace, the price-state's resident window footprint
    # (the peak-RSS proxy — 0 for the reactive baselines, which keep no
    # price tables), and the trace's realized job count
    decisions_per_sec: Optional[float] = None
    window_bytes: Optional[int] = None
    n_jobs: Optional[int] = None
    # churn-scenario extras: utility retention vs. the same scheduler's
    # churn-free run (higher is better; 1.0 = unhurt), the preemption
    # counters from the fleet-churn engine, and the end-of-run surviving
    # worker-GPU fraction (SimResult.live_frac)
    retention: Optional[float] = None
    preempted: Optional[int] = None
    preempt_dropped: Optional[int] = None
    live_frac: Optional[float] = None
    # the run's completion slot by job (a row's whole trajectory, which
    # the card's rows are held to)
    completion: Dict[int, int] = dataclasses.field(default_factory=dict)


def _row(scenario: str, variant: str, r: engine.SimResult,
         wall: float) -> ScenarioResult:
    dec = np.asarray(r.decision_seconds)
    stats = {}
    if dec.size:
        stats = dict(decision_p50=float(np.percentile(dec, 50)),
                     decision_mean=float(dec.mean()),
                     decision_p95=float(np.percentile(dec, 95)))
    return ScenarioResult(scenario=scenario, scheduler=r.name, variant=variant,
                          utility=r.total_utility, accepted=r.accepted,
                          completed=r.completed, canceled=r.canceled,
                          utilization=r.utilization, wall_seconds=wall,
                          completion=dict(r.completion), **stats)


def _timed(scenario: str, variant: str, *args, **kw) -> ScenarioResult:
    t0 = time.perf_counter()
    r = engine.run(*args, **kw)
    return _row(scenario, variant, r, time.perf_counter() - t0)


def run_hetero(seed: int = 0, quick: bool = False, device: Device = None,
               core: str = "whole") -> List[ScenarioResult]:
    T, H, n = (60, 20, 40) if quick else (100, 50, 120)
    cluster = make_hetero_cluster(T=T, H=H, K=H, seed=seed)
    jobs = make_jobs(n, T=T, seed=seed, small=quick)
    return [_timed("hetero", "mixed-fleet", cluster, jobs, scheduler=s,
                   check=False, quantum=0 if s == "oasis" else None,
                   device=device, core=core)
            for s in ALL_SCHEDULERS]


def run_cancel(seed: int = 0, quick: bool = False, frac: float = 0.25,
               device: Device = None,
               core: str = "whole") -> List[ScenarioResult]:
    T, H, n = (60, 16, 40) if quick else (100, 40, 120)
    cluster = make_cluster(T=T, H=H, K=H)
    jobs = make_jobs(n, T=T, seed=seed, small=quick)
    cancels = cancellation_trace(jobs, frac=frac, seed=seed)
    rows = []
    for s in ALL_SCHEDULERS:
        q = 0 if s == "oasis" else None
        rows.append(_timed("cancel", "none", cluster, jobs, scheduler=s,
                           check=False, quantum=q, device=device, core=core))
        rows.append(_timed("cancel", f"frac={frac}", cluster, jobs,
                           scheduler=s, check=False, quantum=q,
                           cancellations=cancels, device=device, core=core))
    return rows


def run_straggler(seed: int = 0, quick: bool = False,
                  slow_frac: float = 0.15, slowdown: float = 3.0,
                  device: Device = None,
                  core: str = "whole") -> List[ScenarioResult]:
    T, H, n = (60, 16, 30) if quick else (100, 40, 100)
    cluster = make_cluster(T=T, H=H, K=H)
    jobs = make_jobs(n, T=T, seed=seed, small=quick)
    rows = []
    for s in ("oasis", "fifo", "drf"):
        q = 0 if s == "oasis" else None
        rows.append(_timed("straggler", "none", cluster, jobs, scheduler=s,
                           check=False, quantum=q, device=device, core=core))
        for detect, label in [(False, "undetected"), (True, "detected")]:
            tp = StragglerThroughput(seed=seed, slow_frac=slow_frac,
                                     slowdown=slowdown, detect=detect)
            rows.append(_timed("straggler", label, cluster, jobs, scheduler=s,
                               check=False, quantum=q, throughput=tp,
                               device=device, core=core))
    return rows


def run_misest(seed: int = 0, quick: bool = False,
               factors=(0.25, 0.5, 1.0, 2.0, 4.0), device: Device = None,
               core: str = "whole") -> List[ScenarioResult]:
    T, H, n = (60, 16, 40) if quick else (100, 20, 60)
    cluster = make_cluster(T=T, H=H, K=H)
    jobs = make_jobs(n, T=T, seed=seed, small=quick)
    exact = price_params_from_jobs(jobs, cluster)
    return [_timed("misest", f"x{f}", cluster, jobs, scheduler="oasis",
                   params=exact.scaled(f), check=False, quantum=0,
                   device=device, core=core)
            for f in factors]


# the tracked 10x-scale instance (and its quick shrink)
SCALE_DIMS = {"T": 500, "H": 100, "K": 100, "n": 2000}
SCALE_DIMS_QUICK = {"T": 150, "H": 30, "K": 30, "n": 300}
# two orders of magnitude past the paper setting
SCALE_DIMS_100X = {"T": 1000, "H": 200, "K": 200, "n": 8000}


def run_scale(seed: int = 0, quick: bool = False,
              schedulers: Sequence[str] = ("fifo", "rrh", "drf", "dorm"),
              T: int = SCALE_DIMS["T"], H: int = SCALE_DIMS["H"],
              K: int = SCALE_DIMS["K"], n: int = SCALE_DIMS["n"],
              device: Device = None, core: str = "whole",
              policy_ckpt: Optional[str] = None) -> List[ScenarioResult]:
    """The fig3-shaped workload an order of magnitude past the paper's
    T=100 / 100-server / 200-job setting.  Reactive baselines by default;
    pass ``schedulers=("oasis", ...)`` to include OASiS (``quantum=0``,
    through ``core``).  ``"learned"`` runs the ``rl`` policy scheduler on
    ``device``: the checkpoint at ``policy_ckpt`` if given, else a
    seed-initialized (untrained) network, which exercises the decision
    path and records its time, not scheduling quality.

    Example — the same workload shape at toy dims (the tracked instances
    use ``SCALE_DIMS`` / ``SCALE_DIMS_100X``)::

        >>> from repro_torch.sim import scenarios
        >>> rows = scenarios.run_scale(T=30, H=4, K=4, n=6,
        ...                            schedulers=("fifo",), device="cpu")
        >>> [(r.scheduler, r.variant, r.accepted) for r in rows]
        [('fifo', 'T=30;n=6', 6)]
    """
    if quick:
        T, H, K, n = (SCALE_DIMS_QUICK[k] for k in ("T", "H", "K", "n"))
    cluster = make_cluster(T=T, H=H, K=K)
    jobs = make_jobs(n, T=T, seed=seed, small=False)
    return [_timed("scale", f"T={T};n={n}", cluster, jobs, scheduler=s,
                   check=True, quantum=0 if s == "oasis" else None,
                   device=device, core=core,
                   **_learned_kwargs(s, cluster, policy_ckpt, device))
            for s in schedulers]


def _learned_kwargs(s: str, cluster: ClusterSpec, policy_ckpt: Optional[str],
                    device: Device) -> dict:
    """``policy=`` of a ``"learned"`` row: the checkpoint's policy, else
    ``default_policy(cluster)``; nothing for the other schedulers."""
    if s != "learned":
        return {}
    from ..rl import policy as rl_policy
    if policy_ckpt:
        params, pcfg, _ = rl_policy.load_policy(policy_ckpt, device=device)
        return {"policy": rl_policy.LearnedDecider(params, pcfg, cluster,
                                                   device=device)}
    return {"policy": rl_policy.default_policy(cluster, device=device)}


# the tracked continuous-serving instance (and its --quick shrink): a
# paper-scale fleet under an open-ended diurnal x bursty stream.  "slots"
# is the arrival-clock length — at 20k slots the full-horizon price state
# would need (20000, H+K, 5) float64 tables (~160 MB); the rolling window
# keeps (window, H+K, 5) resident (~256 KB) regardless of trace length.
SERVING_DIMS = {"H": 50, "K": 50, "window": 64, "slots": 20000, "rate": 0.2}
SERVING_DIMS_QUICK = {"H": 12, "K": 12, "window": 32, "slots": 600,
                      "rate": 0.1}


def run_serving(seed: int = 0, quick: bool = False,
                schedulers: Sequence[str] = ALL_SCHEDULERS,
                slots: Optional[int] = None, window: Optional[int] = None,
                rate: Optional[float] = None, device: Device = None,
                core: str = "whole",
                policy_ckpt: Optional[str] = None) -> List[ScenarioResult]:
    """Continuous serving mode: every scheduler consumes the *same* seeded
    open-ended stream (regenerated per scheduler — ``stream_jobs`` is a
    pure function of the seed) through ``engine.run_stream``.  OASiS runs
    over a rolling ``window``-slot price state whose memory is independent
    of trace length; the reactive baselines are horizon-free already.
    Rows carry sustained decisions/sec and the resident window bytes next
    to the usual quality columns.  ``"learned"`` (not listed by default)
    runs the ``rl`` policy scheduler as in :func:`run_scale`."""
    dims = SERVING_DIMS_QUICK if quick else SERVING_DIMS
    W = int(window if window is not None else dims["window"])
    n_slots = int(slots if slots is not None else dims["slots"])
    lam = float(rate if rate is not None else dims["rate"])
    cluster = make_cluster(T=W, H=dims["H"], K=dims["K"])
    rows = []
    for s in schedulers:
        trace = stream_jobs(rate=lam, seed=seed, max_slots=n_slots,
                            small=quick)
        t0 = time.perf_counter()
        r = engine.run_stream(cluster, trace, scheduler=s, window=W,
                              check=(s == "oasis"),
                              quantum=0 if s == "oasis" else None,
                              device=device, core=core,
                              **_learned_kwargs(s, cluster, policy_ckpt,
                                                device))
        wall = time.perf_counter() - t0
        row = _row("serving", f"W={W};slots={n_slots}", r, wall)
        rows.append(dataclasses.replace(
            row, decisions_per_sec=r.n_jobs / max(wall, 1e-9),
            window_bytes=r.window_bytes, n_jobs=r.n_jobs))
        # price-state memory bounded by the window, never by the trace
        # length (two float64 tables, 5 resources)
        expect = W * (dims["H"] + dims["K"]) * 5 * 8 if s == "oasis" else 0
        if r.window_bytes != expect:
            raise RuntimeError(f"{s}: {r.window_bytes} window bytes, "
                               f"{expect} expected")
    return rows


# the tracked fleet-churn instance (and its --quick shrink).  Full-size
# jobs (small=False) so the fleet actually sustains load — with toy jobs
# everything completes within a slot or two of arrival and failures never
# hit a running allocation.  "levels" are the per-pool failure fractions
# of ``fleet.churn_trace``.
CHURN_DIMS = {"T": 100, "H": 40, "K": 40, "n": 120, "levels": (0.05, 0.20)}
CHURN_DIMS_QUICK = {"T": 60, "H": 10, "K": 10, "n": 60,
                    "levels": (0.05, 0.20)}


def run_churn(seed: int = 0, quick: bool = False,
              schedulers: Sequence[str] = ALL_SCHEDULERS,
              levels: Optional[Sequence[float]] = None,
              device: Device = None,
              core: str = "whole") -> List[ScenarioResult]:
    """Utility retention under k% fleet churn, per scheduler.

    Every scheduler faces the *same* seeded failure trace at each level
    (``fleet.churn_trace``: ``round(frac * pool)`` servers of each pool
    fail once mid-run, then recover).  The ``"none"`` rows are the
    churn-free anchors; the ``frac=...`` rows carry ``retention`` =
    churned / churn-free utility (higher is better) plus the engine's
    preemption counters.  The engine runs with ``check=True`` under
    churn, so a capacity violation on the surviving fleet fails loudly.
    """
    dims = CHURN_DIMS_QUICK if quick else CHURN_DIMS
    T, H, K, n = dims["T"], dims["H"], dims["K"], dims["n"]
    lv = tuple(levels if levels is not None else dims["levels"])
    cluster = make_cluster(T=T, H=H, K=K)
    jobs = make_jobs(n, T=T, seed=seed, small=quick)
    jmap = {j.jid: j for j in jobs}
    traces = {f: churn_trace(cluster, frac=f, seed=seed + 1) for f in lv}

    def _realized(r: engine.SimResult) -> float:
        # utility evaluated at the *actual* completion slot against the
        # original job — the accounting the churn engine path uses.  The
        # reactive drivers already accrue utility this way; for OASiS the
        # churn-free SimResult carries the committed (planned-finish)
        # total instead, which auto-quantum over-provisioning can beat,
        # so retention must re-anchor on the realized value.
        return sum(jmap[jid].utility(t - jmap[jid].arrival)
                   for jid, t in r.completion.items())

    rows = []
    for s in schedulers:
        q = 0 if s == "oasis" else None
        t0 = time.perf_counter()
        rb = engine.run(cluster, jobs, scheduler=s, check=False, quantum=q,
                        device=device, core=core)
        rows.append(_row("churn", "none", rb, time.perf_counter() - t0))
        anchor = _realized(rb)
        for f in lv:
            t0 = time.perf_counter()
            r = engine.run(cluster, jobs, scheduler=s, quantum=q,
                           check=True, fleet=traces[f], device=device,
                           core=core)
            row = _row("churn", f"frac={f}", r, time.perf_counter() - t0)
            ret = r.total_utility / anchor if anchor > 0 else 1.0
            rows.append(dataclasses.replace(
                row, retention=ret, preempted=r.preempted,
                preempt_dropped=r.preempt_dropped,
                live_frac=r.live_frac))
    return rows


SCENARIOS = {
    "hetero": run_hetero,
    "cancel": run_cancel,
    "straggler": run_straggler,
    "misest": run_misest,
    "scale": run_scale,
    "serving": run_serving,
    "churn": run_churn,
}


def run_scenario(name: str, seed: int = 0,
                 quick: bool = False, **kw) -> List[ScenarioResult]:
    """Run scenario ``name`` (a key of :data:`SCENARIOS`); ``kw`` goes to
    its runner (``device``, ``core`` and the scenario's own knobs)."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    return SCENARIOS[name](seed=seed, quick=quick, **kw)
