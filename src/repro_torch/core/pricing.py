"""Dual price functions (paper eq. (22)-(26)) and the mutable price state.

Prices are maintained per (slot t, server, resource r):

    p_h^r(t) = L1 * (U1^r / L1) ** (g_h^r(t) / c_h^r)        (workers pool)
    q_k^r(t) = L2 * (U2^r / L2) ** (v_k^r(t) / c_k^r)        (PS pool)

``PriceState`` keeps the allocation tensors in two representations:

* a **host mirror** (numpy float64), the source of truth for every read
  through the ``g``/``v`` properties, updated by ``commit``/``release``
  with the same IEEE ops as the reference package;
* a **device residency** (torch tensors on the state's device), made on
  the first ``device_state()`` call by one copying upload (counted in
  ``device_uploads``) and then kept fresh in place: each commit/release
  adds its dense slot-window delta to the resident tensors, so a whole
  run performs one full upload, not one per accepted job.

Reading ``g``/``v`` hands out the mutable host arrays and so drops the
residency (the caller may write).  This is the fixed-horizon part of the
reference state, with its ``version`` counter: the rolling window, server
blocking and the dirty-slot log are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import DEFAULT_DTYPE, resolve_device
from .types import ClusterSpec, Job, R


@dataclasses.dataclass(frozen=True)
class PriceParams:
    U1: np.ndarray  # (R,)
    U2: np.ndarray  # (R,)
    L1: float
    L2: float


def price_params_from_jobs(jobs: Sequence[Job], cluster: ClusterSpec,
                           floor_frac: float = 0.05) -> PriceParams:
    """U1^r, U2^r (23)(24) and L1, L2 (25)(26) from a job population.

    ``floor_frac`` clamps each job's worst-case utility f_i(T - a_i) to at
    least floor_frac * f_i(best) (the paper's literal minimum degenerates
    to ~0 whenever a time-critical sigmoid job exists); 0 gives the
    literal formulas.
    """
    T = cluster.T
    U1 = np.zeros(R)
    U2 = np.zeros(R)
    L1_num = math.inf
    L2_num = math.inf
    eta1_inv = math.inf  # min over i of the eta_1 bound RHS
    eta2_inv = math.inf
    cap_w = float(cluster.worker_caps.sum())
    cap_s = float(cluster.ps_caps.sum())
    for job in jobs:
        f_max = job.utility(job.min_duration)          # best achievable utility
        f_min = job.utility(T - job.arrival)           # worst (finish at T)
        f_min = max(f_min, floor_frac * f_max)
        total_work = math.ceil(job.total_work_slots)
        for r in range(R):
            if job.worker_res[r] > 0:
                U1[r] = max(U1[r], f_max / job.worker_res[r])
            if job.ps_res[r] > 0:
                U2[r] = max(U2[r], f_max / job.ps_res[r])
        wsum = float(job.worker_res.sum())
        ssum = float(job.ps_res.sum())
        # a job with zero demand on a pool places no constraint on it
        if wsum > 0:
            L1_num = min(L1_num, f_min / (total_work * wsum))
            if cap_w > 0:
                eta1_inv = min(eta1_inv, total_work * wsum / (T * cap_w))
        if ssum > 0:
            L2_num = min(L2_num, f_min / (total_work * ssum))
            if cap_s > 0:
                eta2_inv = min(eta2_inv, total_work * ssum / (T * cap_s))
    eta1 = 1.0 / max(eta1_inv, 1e-12) if math.isfinite(eta1_inv) else 1.0
    eta2 = 1.0 / max(eta2_inv, 1e-12) if math.isfinite(eta2_inv) else 1.0
    eta1 = max(eta1, 1.0)  # paper requires 1/eta <= 1
    eta2 = max(eta2, 1.0)
    # no job constrains a pool -> fall back to the other pool's floor
    if not math.isfinite(L1_num):
        L1_num = L2_num if math.isfinite(L2_num) else 4.0
    if not math.isfinite(L2_num):
        L2_num = L1_num
    L1 = L1_num / (4.0 * eta1)
    L2 = L2_num / (4.0 * eta2)
    # keep U >= L so the exponential price is well defined
    U1 = np.maximum(U1, L1 * (1.0 + 1e-9))
    U2 = np.maximum(U2, L2 * (1.0 + 1e-9))
    return PriceParams(U1=U1, U2=U2, L1=L1, L2=L2)


def size_bucket(n: int, floor: int = 32, step: int = 64) -> int:
    """Size bucket: powers of two up to ``step``, then multiples of
    ``step`` (the commit-window widths)."""
    b = floor
    while b < n and b < step:
        b *= 2
    if b >= n:
        return b
    return ((n + step - 1) // step) * step


def _pool_prices(alloc: np.ndarray, caps: np.ndarray, U: np.ndarray,
                 L: float) -> np.ndarray:
    """Exponential dual price table  L * (U/L)^(alloc/caps)  (eq. 22/25),
    priced elementwise, so a slot-window evaluation is bit-identical to
    the same entries of the full table."""
    c = np.maximum(caps, 1e-12)
    ratio = np.maximum(U / L, 1.0 + 1e-9)
    return L * ratio ** (alloc / c)


class PriceState:
    """Allocations g_h^r(t), v_k^r(t) and the derived price tables.

    Host mirror + device residency on ``device`` (module docstring);
    ``device_uploads`` counts full host-to-device state copies.

    Example — prices start at the ``L1`` floor, rise on ``commit`` and
    return exactly on ``release``::

        >>> import numpy as np
        >>> from repro_torch.core.pricing import PriceState, price_params_from_jobs
        >>> from repro_torch.sim.workload import make_cluster, make_jobs
        >>> cluster = make_cluster(T=20, H=3, K=3)
        >>> jobs = make_jobs(4, T=20, seed=0, small=True)
        >>> params = price_params_from_jobs(jobs, cluster)
        >>> state = PriceState(cluster, params, device="cpu")
        >>> bool(np.all(state.worker_prices() == params.L1))
        True
        >>> y = {3: np.array([1, 0, 0])}
        >>> state.commit(jobs[0], y, {})
        >>> bool(np.any(state.worker_prices() > params.L1))
        True
        >>> state.release(jobs[0], y, {})
        >>> bool(np.all(state.worker_prices() == params.L1))
        True
    """

    # full f32-residency resync cadence (see _apply); f64 never resyncs —
    # its in-place adds are bit-identical to the mirror's
    _F32_RESYNC_EVERY = 256

    def __init__(self, cluster: ClusterSpec, params: PriceParams,
                 device: Optional[Union[str, torch.device]] = None):
        self.cluster = cluster
        self.params = params
        self.device = resolve_device(device)
        T, H, K = cluster.T, cluster.H, cluster.K
        self._g_host = np.zeros((T, H, R))  # alloc on worker servers
        self._v_host = np.zeros((T, K, R))  # alloc on PS servers
        # device residency: (g_dev, v_dev) tensors or None; static side
        # tables (caps + price params) cached per dtype
        self._dev = None
        self._dev_dtype: Optional[torch.dtype] = None
        self._dev_static = {}
        self._commits_since_sync = 0
        self.device_uploads = 0
        # bumped on every commit/release (the decision core keys its
        # padded-state cache on it, with the residency it padded)
        self.version = 0

    @property
    def horizon(self) -> int:
        """Number of resident slots (== ``cluster.T``)."""
        return self._g_host.shape[0]

    # -- host views --------------------------------------------------------
    @property
    def g(self) -> np.ndarray:
        """Worker-pool allocation (T, H, R), host numpy.  Hands out the
        mutable mirror, so the device residency is dropped (re-uploaded on
        the next ``device_state``)."""
        self._dev = None
        return self._g_host

    @g.setter
    def g(self, value: np.ndarray) -> None:
        self._g_host = np.asarray(value, dtype=np.float64)
        self._dev = None

    @property
    def v(self) -> np.ndarray:
        self._dev = None
        return self._v_host

    @v.setter
    def v(self, value: np.ndarray) -> None:
        self._v_host = np.asarray(value, dtype=np.float64)
        self._dev = None

    # -- price tables -----------------------------------------------------
    def worker_prices(self) -> np.ndarray:
        """p (T, H, R) with p = L1 * (U1/L1)^(g/c)."""
        return _pool_prices(self._g_host, self.cluster.worker_caps[None],
                            self.params.U1[None, None], self.params.L1)

    def ps_prices(self) -> np.ndarray:
        return _pool_prices(self._v_host, self.cluster.ps_caps[None],
                            self.params.U2[None, None], self.params.L2)

    def worker_prices_at(self, slots: np.ndarray) -> np.ndarray:
        """Price entries for ``slots`` only, (n, H, R) — bit-identical to
        ``worker_prices()[slots]``.  Read-only (keeps the residency)."""
        return _pool_prices(self._g_host[slots], self.cluster.worker_caps[None],
                            self.params.U1[None, None], self.params.L1)

    def ps_prices_at(self, slots: np.ndarray) -> np.ndarray:
        return _pool_prices(self._v_host[slots], self.cluster.ps_caps[None],
                            self.params.U2[None, None], self.params.L2)

    # -- bookkeeping (Alg. 1 lines 7-10) -----------------------------------
    def _window_delta(self, alloc: dict, res: np.ndarray, T: int,
                      sign: float):
        """Dense (win, S, R) slot-window delta for one commit/release over
        [t0, t0+win), ``win`` bucketed; slots of the window absent from
        ``alloc`` carry an exact 0.0 delta."""
        ts = np.fromiter(alloc.keys(), dtype=np.int64, count=len(alloc))
        t0, t1 = int(ts.min()), int(ts.max())
        win = min(size_bucket(t1 - t0 + 1, floor=8, step=64), T)
        t0 = min(t0, T - win)
        counts = np.stack([alloc[int(t)] for t in ts]).astype(np.float64)
        delta = np.zeros((win, counts.shape[1], R))
        delta[ts - t0] = sign * (counts[:, :, None] * res[None, None, :])
        return t0, delta

    def _apply(self, workers: dict, ps: dict, wres: np.ndarray,
               sres: np.ndarray, sign: float) -> None:
        T = self._g_host.shape[0]
        deltas = []
        if workers and self.cluster.H:
            deltas.append((0, self._g_host) + self._window_delta(
                workers, wres, T, sign))
        if ps and self.cluster.K:
            deltas.append((1, self._v_host) + self._window_delta(
                ps, sres, T, sign))
        for _, host, t0, delta in deltas:
            host[t0:t0 + delta.shape[0]] += delta
        if self._dev is not None and deltas:
            if self._dev_dtype != torch.float64 and (
                    sign < 0
                    or self._commits_since_sync >= self._F32_RESYNC_EVERY):
                # float32 residency: in-place adds round per commit, so it
                # drifts from the float64 mirror, and (g + d) - d is not
                # exact, so a release would leave phantom allocation.
                # Resync from the mirror on every release and every
                # _F32_RESYNC_EVERY commits.
                self._dev = None
            else:
                for pool, _, t0, delta in deltas:
                    self._dev[pool][t0:t0 + delta.shape[0]] += torch.tensor(
                        delta, dtype=self._dev_dtype, device=self.device)
                self._commits_since_sync += 1
        self.version += 1

    def commit(self, job: Job, workers: dict, ps: dict) -> None:
        self._apply(workers, ps, job.worker_res, job.ps_res, 1.0)

    def release(self, job: Job, workers: dict, ps: dict) -> None:
        """Inverse of commit (preemption / cancellation)."""
        self._apply(workers, ps, job.worker_res, job.ps_res, -1.0)

    # -- whole-state queries -----------------------------------------------
    def capacity_ok(self, tol: float = 1e-6):
        """(workers_ok, ps_ok): no allocation entry exceeds capacity."""
        ok_w = bool(np.all(self._g_host
                           <= self.cluster.worker_caps[None] + tol))
        ok_p = bool(np.all(self._v_host <= self.cluster.ps_caps[None] + tol))
        return ok_w, ok_p

    def gpu_slot_usage(self) -> np.ndarray:
        """(T,) worker-pool GPU units in use per slot (resource 0)."""
        return self._g_host[:, :, 0].sum(axis=1)

    # -- device residency ---------------------------------------------------
    def _static_arrays(self, dtype: torch.dtype):
        cached = self._dev_static.get(dtype)
        if cached is not None:
            return cached
        wcaps, scaps = self.cluster.worker_caps, self.cluster.ps_caps
        # empty pools are padded with one zero-capacity server so gathers
        # stay in bounds (it can never be used)
        if wcaps.shape[0] == 0:
            wcaps = np.zeros((1, R))
        if scaps.shape[0] == 0:
            scaps = np.zeros((1, R))
        pp = self.params
        sd = tuple(torch.tensor(x, dtype=dtype, device=self.device)
                   for x in (wcaps, scaps, pp.U1, pp.U2, pp.L1, pp.L2))
        self._dev_static[dtype] = sd
        return sd

    def _upload(self, dtype: torch.dtype):
        self._commits_since_sync = 0
        g, v = self._g_host, self._v_host
        if g.shape[1] == 0:
            g = np.zeros((self.horizon, 1, R))
        if v.shape[1] == 0:
            v = np.zeros((self.horizon, 1, R))
        self.device_uploads += 1
        # torch.tensor copies; torch.from_numpy would alias the mirror and
        # the residency would then see (and double-count) host writes
        return [torch.tensor(g, dtype=dtype, device=self.device),
                torch.tensor(v, dtype=dtype, device=self.device)]

    def device_state(self, dtype: torch.dtype = DEFAULT_DTYPE):
        """Engine view ``(g, v, wcaps, scaps, U1, U2, L1, L2)`` on the
        state's device.  The first call uploads the full state (counted in
        ``device_uploads``); afterwards ``commit``/``release`` keep the
        residency fresh in place.  Empty pools are padded with one
        zero-capacity server."""
        if self._dev is None or self._dev_dtype != dtype:
            self._dev_dtype = dtype
            self._dev = self._upload(dtype)
        return tuple(self._dev) + self._static_arrays(dtype)
