"""Core data types for the OASiS scheduler (paper Sec. III).

The port's own copy of the reference's ``core/types.py`` (numpy only,
unchanged semantics).  Resources are abstract vectors of length R: GPU,
vCPU, memory (GB), storage (GB), bandwidth (Gbps).  Worker demands are
``w`` (on the H pool), parameter-server demands ``s`` (on the K pool).
All times are measured in scheduling slots.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

RESOURCES = ("gpu", "cpu", "mem", "storage", "bw")
R = len(RESOURCES)
BW = RESOURCES.index("bw")


@dataclasses.dataclass(frozen=True)
class SigmoidUtility:
    """f_i(d) = gamma1 / (1 + exp(gamma2 * (d - gamma3))) (paper Sec. V-A).

    At gamma2 = 0 the utility is the constant gamma1 / 2.
    """

    gamma1: float  # priority in [1, 100]
    gamma2: float  # decay factor (0 | [0.01,1] | [4,6])
    gamma3: float  # target completion duration in slots

    def __call__(self, duration: float) -> float:
        z = self.gamma2 * (duration - self.gamma3)
        # numerically-stable evaluation of gamma1 / (1 + exp(z))
        if z >= 0:
            ez = math.exp(-min(z, 50.0))
            return self.gamma1 * ez / (1.0 + ez)
        return self.gamma1 / (1.0 + math.exp(max(z, -50.0)))


@dataclasses.dataclass(frozen=True)
class Job:
    """One training job (paper Table I)."""

    jid: int
    arrival: int                  # a_i, slot index in [0, T)
    epochs: int                   # E_i
    num_chunks: int               # N_i  (also max concurrent workers)
    minibatches_per_chunk: int    # M_i
    tau: float                    # per-mini-batch train time, in slots
    grad_size: float              # e_i, same units as bandwidth*slot
    worker_bw: float              # b_i
    ps_bw: float                  # B_i
    worker_res: np.ndarray        # w_i^r, shape (R,)
    ps_res: np.ndarray            # s_i^r, shape (R,)
    utility: Callable[[float], float]
    # Workload quantization for the DP (1 = exact paper formulation): a
    # quantum of q groups q chunk-passes into one DP unit.
    quantum: int = 1
    # Fraction of the workload still to run (1.0 multiplies through as
    # an IEEE identity).
    work_scale: float = 1.0

    @property
    def chunk_time(self) -> float:
        """Slots a single worker needs for one chunk-pass: M(tau + 2e/b)."""
        return self.minibatches_per_chunk * (self.tau + 2.0 * self.grad_size / self.worker_bw)

    @property
    def total_work_slots(self) -> float:
        """E_i N_i M_i (tau + 2e/b): total worker-slots of work."""
        return self.work_scale * self.epochs * self.num_chunks * self.chunk_time

    @property
    def workload(self) -> int:
        """DP units: ceil(work_scale * E_i * N_i / quantum) chunk-pass groups."""
        return math.ceil(self.work_scale * self.epochs * self.num_chunks
                         / self.quantum)

    @property
    def min_duration(self) -> int:
        """Fastest possible completion: N_i workers at all times."""
        return max(1, math.ceil(self.work_scale * self.epochs
                                * self.minibatches_per_chunk
                                * (self.tau + 2.0 * self.grad_size / self.worker_bw)))

    def workers_for(self, d: int) -> int:
        """Minimum workers to fulfil d workload units within one slot."""
        if d == 0:
            return 0
        return math.ceil(d * self.quantum * self.chunk_time - 1e-9)

    def ps_for(self, num_workers: int) -> int:
        """Minimum parameter servers for W workers: ceil(W * b/B)."""
        if num_workers == 0:
            return 0
        return math.ceil(num_workers * self.worker_bw / self.ps_bw - 1e-9)

    @property
    def max_chunks_per_slot(self) -> int:
        """Largest d with workers_for(d) <= N_i (constraint (3))."""
        hi = int(self.num_chunks / (self.quantum * self.chunk_time)) + 2
        d = 0
        for cand in range(hi, -1, -1):
            if self.workers_for(cand) <= self.num_chunks:
                d = cand
                break
        return d


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """H worker servers and K parameter-server machines with capacities."""

    T: int
    worker_caps: np.ndarray  # (H, R) = c_h^r
    ps_caps: np.ndarray      # (K, R) = c_k^r

    @property
    def H(self) -> int:
        return self.worker_caps.shape[0]

    @property
    def K(self) -> int:
        return self.ps_caps.shape[0]


@dataclasses.dataclass
class Schedule:
    """A feasible schedule for one job: worker/PS placements per slot."""

    jid: int
    workers: dict  # {t: np.ndarray(H, int)}
    ps: dict       # {t: np.ndarray(K, int)}
    finish: int    # slot index of the last active slot
    cost: float    # dual resource cost of the schedule
    payoff: float  # utility - cost ( = mu_i when positive)
    utility: float


# An NVIDIA H100 SXM's dense bf16 tensor-core rate and its NVLink rate
# each way (NVIDIA's data sheet, 700 W): the port's defaults for
# job_from_arch, where the reference's are a TPU's
H100_BF16_FLOPS = 989e12
H100_NVLINK_BYTES = 450e9


def job_from_arch(name: str, arrival: int, *, flops_per_token: float,
                  param_bytes: float, tokens_per_step: int, target_steps: int,
                  chip_flops: float = H100_BF16_FLOPS,
                  chip_bw: float = H100_NVLINK_BYTES,
                  utility: Optional[Callable[[float], float]] = None,
                  slot_seconds: float = 1200.0) -> Job:
    """A scheduler Job from an architecture's roofline terms, as the
    reference's: tau_i from one worker-chip's compute time per step
    (``flops_per_token * tokens_per_step / chip_flops``), e_i from the
    gradient (= parameter) bytes over ``chip_bw``, both in slots of
    ``slot_seconds``; one chunk = 100 steps, one mini-batch = 1 step.
    The defaults are an NVIDIA H100 SXM's (989 TFLOP/s dense bf16, 450
    GB/s NVLink each way; the reference's, 197e12 and 50e9, are a TPU's).
    ``name`` is carried for the caller's records, unused, as in the
    reference."""
    step_sec = flops_per_token * tokens_per_step / chip_flops
    tau = step_sec / slot_seconds
    m_per_chunk = 100
    n_chunks = max(1, target_steps // m_per_chunk)
    e = param_bytes / chip_bw / slot_seconds    # gradient exchange time unit
    w = np.array([4.0, 8.0, 32.0, 10.0, 5.0])
    s = np.array([0.0, 8.0, 32.0, 10.0, 20.0])
    util = utility or SigmoidUtility(50.0, 0.05, max(2 * n_chunks, 4))
    return Job(jid=-1, arrival=arrival, epochs=1, num_chunks=n_chunks,
               minibatches_per_chunk=m_per_chunk, tau=tau, grad_size=e,
               worker_bw=1.0, ps_bw=4.0, worker_res=w, ps_res=s, utility=util)
