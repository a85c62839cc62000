"""Cluster-scheduling environment over the port's event engine, as the
reference's ``repro/rl/env.py``.

One episode is one job trace driven through ``sim/engine.py``; one step
is one admission decision (the engine's ``DecisionPoint``).  Everything
between decisions (placements, repacks, fast-forwarded work,
completions) is the engine itself.

* **observation**: a flat float32 vector, the job's features (demand,
  workload, utility shape), the decision point's per-slot free capacity
  window of both pools, and queue and churn scalars (:func:`observe`).
* **action**: ``(workers, ps_slack)``: admit with ``workers`` workers and
  ``ps_for(workers) + ps_slack`` parameter servers, or reject with
  ``workers == 0``; a bare int means slack 0.  Actions are clamped to the
  job's envelope (at most ``num_chunks`` workers, at least the
  bandwidth-matched PS count), so none requests an infeasible
  allocation.
* **reward**: the utility of the jobs completed between this decision
  and the next (the terminal step pays the tail), so the episode's
  undiscounted return is ``SimResult.total_utility``.

``scheduler`` picks the machinery the decisions drive: ``"learned"``
(FIFO's machinery with per-job counts, the action taken literally) or a
named scheduler (``"oasis"``, ``"fifo"``, ``"drf"``, ``"rrh"``,
``"dorm"``: the action gates admission, the scheduler allocates).
``info["expert_action"]`` replays the named scheduler's own decision;
feeding it back (:class:`ReplayPolicy`) reproduces ``engine.run`` bit
for bit.

The environment has ``reset``/``step`` in Gymnasium's form without
depending on it: its base class is a plain object and its spaces are the
reference's gym-less ``(max_workers + 1, ps_slack_levels)`` and
``(OBS_DIM,)``.  The engine runs on ``device`` (an engine keyword; None:
the CUDA card).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.types import R, ClusterSpec, Job
from ..sim import engine
from ..sim.engine import DECISION_WINDOW, DecisionPoint, SimResult
from ..sim.workload import make_cluster, make_jobs

# observation layout: job and context scalars, then two capacity windows;
# the last two scalars are the churn context (live-capacity fraction, a
# re-admitted victim), 1.0 and 0.0 without churn
N_SCALAR_FEATURES = 26
OBS_DIM = N_SCALAR_FEATURES + 2 * DECISION_WINDOW * R
# the best-achievable-utility feature (utility at min_duration, / 100):
# the trainer's warm-start expert reads it back out of the observation
F_BEST_UTILITY = 8

# default action bounds: worker head 0..MAX_WORKERS, PS slack head 0..3
MAX_WORKERS = 32
PS_SLACK_LEVELS = 4


def paper_instance(seed: int, T: int = 100, H: int = 50, K: int = 50,
                   n_jobs: int = 200, small: bool = False
                   ) -> Tuple[ClusterSpec, Sequence[Job]]:
    """The paper-scale instance family (T=100, 100 servers, 200 jobs).
    ``small=True``: the equivalence suites' shrunk jobs; ``small=False``:
    the congested full-size workload the policy trains on."""
    return (make_cluster(T=T, H=H, K=K),
            make_jobs(n_jobs, T=T, seed=seed, small=small))


def observe(dp: DecisionPoint, cluster: ClusterSpec) -> np.ndarray:
    """The flat observation of one decision point, (OBS_DIM,) float32."""
    job = dp.job
    T = max(cluster.T, 1)
    u = job.utility
    g1 = float(getattr(u, "gamma1", 0.0))
    g2 = float(getattr(u, "gamma2", 0.0))
    g3 = float(getattr(u, "gamma3", 0.0))
    mean_w = np.maximum(cluster.worker_caps.mean(axis=0), 1e-9) \
        if cluster.H else np.full(R, 1e-9)
    mean_s = np.maximum(cluster.ps_caps.mean(axis=0), 1e-9) \
        if cluster.K else np.full(R, 1e-9)
    best = float(u(job.min_duration))
    seen = dp.accepted + dp.rejected
    scalars = np.array([
        dp.t / T,
        job.num_chunks / 100.0,
        np.log1p(job.total_work_slots) / 8.0,
        job.min_duration / T,
        min(job.chunk_time, 2.0),
        g1 / 100.0,
        min(g2, 6.0) / 6.0,
        g3 / T,
        best / 100.0,
        float(u(2.0 * job.min_duration)) / 100.0,   # deadline-decay probe
        *(job.worker_res / mean_w),
        *(job.ps_res / mean_s),
        job.ps_for(8) / 8.0,
        dp.n_running / 64.0,
        dp.n_waiting / 64.0,
        dp.accepted / max(seen, 1),
        dp.live_frac,
        float(dp.preempted),
    ])
    if scalars.shape[0] != N_SCALAR_FEATURES:
        raise AssertionError(f"{scalars.shape[0]} scalar features")
    return np.concatenate([scalars,
                           dp.free_frac_workers.ravel(),
                           dp.free_frac_ps.ravel()]).astype(np.float32)


def split_action(action) -> Tuple[int, int]:
    """An env action as ``(workers, ps_slack)``."""
    if action is None:
        return 0, 0
    if np.ndim(action) == 0:
        return int(action), 0
    a = np.asarray(action).ravel()
    return int(a[0]), int(a[1]) if a.size > 1 else 0


def engine_action(dp: DecisionPoint, action) -> Optional[Tuple[int, int]]:
    """An env action as the engine's ``(n_workers, n_ps)``, clamped to the
    job's envelope; ``None`` rejects."""
    w, slack = split_action(action)
    if w <= 0:
        return None
    job = dp.job
    w = min(w, job.num_chunks)
    return w, job.ps_for(w) + max(slack, 0)


def expert_env_action(dp: DecisionPoint) -> np.ndarray:
    """The env action that replays the wrapped scheduler's own decision."""
    nw, _ = dp.expert
    return np.array([nw, 0], dtype=np.int64)


class Env:
    """The base of the environments: Gymnasium's ``reset``/``step`` form,
    without the dependency."""

    metadata: Dict = {"render_modes": []}


class ClusterSchedulingEnv(Env):
    """Per-arrival scheduling decisions over one engine episode.

    ``instance_fn``: ``seed -> (cluster, jobs)``, by default
    :func:`paper_instance` with ``instance_kwargs``; ``reset`` draws a
    fresh trace per episode (``options["instance"]`` or ``seed`` sets the
    seed, else the next one).  ``scheduler``: the machinery (module
    docstring).  ``check``: capacity feasibility checked inside the
    engine.  ``engine_kwargs`` go to ``engine.decisions`` (``device``,
    ``core``, ``quantum``, ``params``, ``cancellations``, ``fleet``, ...).
    """

    def __init__(self, instance_fn: Optional[Callable] = None,
                 scheduler: str = "learned",
                 max_workers: int = MAX_WORKERS,
                 ps_slack_levels: int = PS_SLACK_LEVELS,
                 check: bool = False, seed: int = 0,
                 instance_kwargs: Optional[Dict] = None,
                 **engine_kwargs):
        self.instance_fn = instance_fn or (
            lambda s: paper_instance(s, **(instance_kwargs or {})))
        self.scheduler = scheduler
        self.max_workers = int(max_workers)
        self.ps_slack_levels = int(ps_slack_levels)
        self.check = check
        self.engine_kwargs = engine_kwargs
        self._instance_seed = seed
        self.action_space = (self.max_workers + 1, self.ps_slack_levels)
        self.observation_space = (OBS_DIM,)
        self.cluster: Optional[ClusterSpec] = None
        self.jobs: Sequence[Job] = ()
        self._gen = None
        self._dp: Optional[DecisionPoint] = None
        self._paid = 0.0
        self._done = True
        self.result: Optional[SimResult] = None

    # -- episode control ----------------------------------------------------
    def reset(self, *, seed: Optional[int] = None,
              options: Optional[Dict] = None):
        if options and "instance" in options:
            self._instance_seed = int(options["instance"])
        elif seed is not None:
            self._instance_seed = int(seed)
        self.cluster, self.jobs = self.instance_fn(self._instance_seed)
        self._instance_seed += 1                # next reset: a fresh trace
        self._gen = engine.decisions(
            self.cluster, self.jobs, scheduler=self.scheduler,
            check=self.check, **self.engine_kwargs)
        self._dp = None
        self.result = None
        self._paid = 0.0
        self._done = False
        obs, info = self._advance(None)
        if self._done:
            # an empty trace: the first step ends the episode whatever the
            # action
            info = dict(info, empty_trace=True)
        return obs, info

    def step(self, action):
        if self._gen is None:
            raise RuntimeError("call reset() first")
        if self._done:
            return (np.zeros(OBS_DIM, np.float32), 0.0, True, False,
                    self._terminal_info())
        send = engine_action(self._dp, action)
        obs, info = self._advance(send)
        if self._done:
            reward = float(self.result.total_utility) - self._paid
            self._paid = float(self.result.total_utility)
            return obs, reward, True, False, self._terminal_info()
        reward = self._dp.utility_so_far - self._paid
        self._paid = self._dp.utility_so_far
        return obs, reward, False, False, info

    # -- internals ----------------------------------------------------------
    def _advance(self, send):
        try:
            if self._dp is None:                # a fresh generator (reset)
                self._dp = next(self._gen)
            else:                               # answer the paused decision
                self._dp = self._gen.send(send)
            return observe(self._dp, self.cluster), self._step_info()
        except StopIteration as stop:
            self.result = stop.value
            self._done = True
            self._dp = None
            return np.zeros(OBS_DIM, np.float32), {}

    def _step_info(self) -> Dict:
        dp = self._dp
        return {"jid": dp.job.jid, "t": dp.t, "scheduler": dp.scheduler,
                "expert_action": expert_env_action(dp),
                "n_running": dp.n_running, "n_waiting": dp.n_waiting}

    def _terminal_info(self) -> Dict:
        return {"result": self.result, "summary": self.result.summary()}


@dataclasses.dataclass
class ReplayPolicy:
    """Answers with ``info["expert_action"]``, the wrapped scheduler's own
    decision: the env then replays ``engine.run``."""

    def __call__(self, obs: np.ndarray, info: Dict) -> np.ndarray:
        return info["expert_action"]


def run_episode(env: ClusterSchedulingEnv,
                policy: Callable[[np.ndarray, Dict], object],
                seed: Optional[int] = None) -> SimResult:
    """Drive one whole episode; returns the engine's ``SimResult``.  The
    rewards must sum to its total utility."""
    obs, info = env.reset(seed=seed)
    done = info.get("empty_trace", False)
    total = 0.0
    while not done:
        obs, reward, done, _, info = env.step(policy(obs, info))
        total += reward
    if abs(total - env.result.total_utility) >= 1e-6:
        raise AssertionError(f"rewards sum to {total}, the run's utility is "
                             f"{env.result.total_utility}")
    return env.result
