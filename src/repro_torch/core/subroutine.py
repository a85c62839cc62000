"""Host-side tables of the Alg. 2 subroutine that the decision core needs."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .types import Job


def workload_tables(job: Job, dcap: int) -> Tuple[np.ndarray, np.ndarray]:
    """(W, Z): workers and PS targets for d = 0..dcap, vectorized.

    Elementwise identical to ``job.workers_for`` / ``job.ps_for``.
    """
    ds = np.arange(dcap + 1, dtype=np.float64)
    W = np.ceil(ds * job.quantum * job.chunk_time - 1e-9).astype(np.int64)
    W[0] = 0
    Z = np.ceil(W * job.worker_bw / job.ps_bw - 1e-9).astype(np.int64)
    Z[W == 0] = 0
    return W, Z
