"""Workload/cluster generator following the paper's simulation settings
(Sec. V-A): EC2-C4-like worker servers, P2/G3-like PS servers, Table-I
job parameter ranges, Google-trace-style bursty arrivals, sigmoid
utilities, and the open-ended serving stream (``stream_jobs``).  The
port's own copy of the reference generator: the numpy rng draws come in
the same order, so a seed gives the same trace.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np

from ..core.types import ClusterSpec, Job, SigmoidUtility

# resource order: gpu, cpu, mem(GB), storage(GB), bw(Gbps)
_C4_LIKE = np.array([8.0, 36.0, 60.0, 400.0, 25.0])      # worker servers
_P2_LIKE = np.array([0.0, 64.0, 488.0, 800.0, 25.0])     # PS servers (no GPU used)
_G3_LIKE = np.array([0.0, 64.0, 488.0, 800.0, 50.0])


def make_cluster(T: int = 100, H: int = 50, K: int = 50,
                 scale: float = 1.0, rng: Optional[np.random.Generator] = None
                 ) -> ClusterSpec:
    rng = rng or np.random.default_rng(0)
    worker_caps = np.tile(_C4_LIKE, (H, 1)) * scale
    ps_rows = [(_P2_LIKE if rng.random() < 0.5 else _G3_LIKE) for _ in range(K)]
    ps_caps = np.stack(ps_rows) * scale
    ps_caps[:, 0] = 0.0
    return ClusterSpec(T=T, worker_caps=worker_caps, ps_caps=ps_caps)


def _burst_profile(T: int, rng: np.random.Generator) -> np.ndarray:
    """Per-slot rate multipliers: a few x4-rate burst windows, wrapping at
    the trace edges (indices mod T)."""
    base = np.ones(T)
    n_bursts = max(1, T // 40)
    width = max(2, T // 20)
    for _ in range(n_bursts):
        c = rng.integers(0, T)
        idx = np.arange(c - width, c + width) % T
        base[idx] *= 4.0
    return base


def _arrivals(n_jobs: int, T: int, rng: np.random.Generator) -> np.ndarray:
    """Bursty arrivals: a nonhomogeneous Poisson process with a few
    high-rate windows and few arrivals near T."""
    base = _burst_profile(T, rng)
    base[-max(1, T // 10):] = 0.05 * base[-max(1, T // 10):]
    probs = base / base.sum()
    return np.sort(rng.choice(T, size=n_jobs, p=probs, replace=True))


def _sample_job(jid: int, arrival: int, rng: np.random.Generator,
                small: bool, time_insensitive: float,
                time_sensitive: float) -> Job:
    """One job from the paper's Table-I parameter ranges."""
    if small:
        E = int(rng.integers(1, 4))
        N = int(rng.integers(1, 5))
        M = int(rng.integers(5, 20))
    else:
        E = int(rng.integers(50, 201))
        N = int(rng.integers(5, 101))
        M = int(rng.integers(10, 101))
    tau = float(rng.uniform(0.001, 0.1))
    e = float(rng.uniform(30, 575)) / 1000.0          # GB
    b = float(rng.uniform(0.1, 5.0))                  # Gbps -> GB/slot units
    B = float(rng.uniform(5.0, 20.0))
    # normalize per-chunk time so the fastest possible duration lands in
    # [2, 16] slots (paper: target completion times in [1, 15])
    ct = M * (tau + 2 * e / b)
    min_dur = E * ct
    target = float(rng.uniform(2.0, 16.0))
    # keep per-chunk time << slot length (binds only for tiny-E jobs)
    target = min(target, 0.9 * E)
    scale = target / min_dur
    tau *= scale
    e *= scale
    w = np.array([float(rng.integers(0, 5)), float(rng.integers(1, 11)),
                  float(rng.uniform(2, 32)), float(rng.uniform(5, 10)), b])
    s = np.array([0.0, float(rng.integers(1, 11)),
                  float(rng.uniform(2, 32)), float(rng.uniform(5, 10)), B])
    u = rng.random()
    gamma1 = float(rng.uniform(1, 100))
    if u < time_insensitive:
        gamma2 = 0.0
    elif u < time_insensitive + time_sensitive:
        gamma2 = float(rng.uniform(0.01, 1.0))
    else:
        gamma2 = float(rng.uniform(4.0, 6.0))
    # gamma3: the target completion time, coupled to the fastest duration
    min_dur_slots = max(1.0, target - 1.0)
    gamma3 = float(np.clip(min_dur_slots * rng.uniform(1.0, 2.5), 1, 40))
    return Job(jid=jid, arrival=arrival, epochs=E, num_chunks=N,
               minibatches_per_chunk=M, tau=tau, grad_size=e, worker_bw=b,
               ps_bw=B, worker_res=w, ps_res=s,
               utility=SigmoidUtility(gamma1, gamma2, gamma3))


def make_jobs(n_jobs: int, T: int = 100, seed: int = 0,
              time_insensitive: float = 0.10, time_sensitive: float = 0.55,
              small: bool = False) -> List[Job]:
    """Paper ranges: E in [50,200], N in [5,100], M in [10,100],
    tau in [0.001,0.1] slots, e in [30,575] MB; ``small=True`` shrinks
    E, N for fast tests."""
    rng = np.random.default_rng(seed)
    arrivals = _arrivals(n_jobs, max(T - 1, 1), rng)
    return [_sample_job(jid, int(arrivals[jid]), rng, small,
                        time_insensitive, time_sensitive)
            for jid in range(n_jobs)]


def stream_jobs(rate: float = 0.2, seed: int = 0,
                max_slots: Optional[int] = None, *,
                diurnal_period: int = 288, diurnal_amp: float = 0.6,
                burst_prob: float = 0.01, burst_mean_len: int = 12,
                burst_tail: float = 1.5, burst_cap: float = 8.0,
                small: bool = False, time_insensitive: float = 0.10,
                time_sensitive: float = 0.55) -> Iterator[Job]:
    """Open-ended arrival stream for the continuous serving mode.

    Per-slot Poisson counts with intensity ``rate * (1 + diurnal_amp *
    sin(2 pi t / diurnal_period)) * burst(t)``, where a burst episode
    starts with probability ``burst_prob`` per slot, lasts a geometric
    ``burst_mean_len`` slots and multiplies the rate by ``min(1 +
    Pareto(burst_tail), burst_cap)``.  Jobs come in nondecreasing arrival
    order with sequential jids, one at a time (the trace is never held);
    ``max_slots`` bounds the arrival clock, ``None`` streams forever.

    Example::

        >>> import itertools
        >>> from repro_torch.sim.workload import stream_jobs
        >>> jobs = list(itertools.islice(stream_jobs(rate=0.5, seed=1), 5))
        >>> [j.jid for j in jobs], all(
        ...     a.arrival <= b.arrival for a, b in zip(jobs, jobs[1:]))
        ([0, 1, 2, 3, 4], True)
    """
    rng = np.random.default_rng(seed)
    jid = 0
    t = 0
    burst_left = 0
    burst_amp = 1.0
    while max_slots is None or t < max_slots:
        if burst_left == 0 and rng.random() < burst_prob:
            burst_left = int(rng.geometric(1.0 / max(burst_mean_len, 1)))
            burst_amp = float(min(1.0 + rng.pareto(burst_tail), burst_cap))
        mult = burst_amp if burst_left > 0 else 1.0
        if burst_left > 0:
            burst_left -= 1
        lam = rate * (1.0 + diurnal_amp
                      * math.sin(2.0 * math.pi * t / diurnal_period)) * mult
        for _ in range(int(rng.poisson(max(lam, 0.0)))):
            yield _sample_job(jid, t, rng, small,
                              time_insensitive, time_sensitive)
            jid += 1
        t += 1
