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

The residency also holds the decision cores' price tables ``p``/``q`` and
the live-floor price ``pmin`` (``device_prices``).  They are priced on
the host, always, with the reference's expression (``_HostPricer``:
numpy's ``L * r ** (alloc / c)``, the bits of the reference's
``impl="fast"`` tables), and written into the device tables in place for
the slot window a mutation dirtied.  So the card reads the very prices
the CPU run computes: CUDA's ``pow`` differs from the host's in the last
ulp, and the whole route's exact first-index split turns such a
difference into another schedule (another split, other servers, and
under fleet churn other victims).

Reading ``g``/``v`` hands out the mutable host arrays and so drops the
residency (the caller may write).  Every mutation bumps ``version`` and
logs its slot windows (the dirty-slot log, ``dirty_spans_since``,
``patch_spans``), so a job's ``RowCache`` recomputes only the tiles
that moved.

**Rolling horizon (continuous serving).**  ``PriceState(...,
window=W)`` keeps a ``W``-slot window: local slot ``i`` is absolute slot
``origin + i``, and ``advance(now)`` slides it forward, retiring past
slots into ``retired_slots`` / ``retired_gpu_slots`` and opening
exact-zero slots at the tail.  The residency slides on the device with no
upload: surviving slots keep their bits in all five tables, and the tail's
prices are priced on the host on its zero rows.  A slide remaps every
local slot, so it clears the dirty-slot log (every cache rebuilds).

**Server blocking (fleet churn).**  ``block_server`` fills a failed or
drained server's slots to capacity (its headroom drops to exactly 0)
and ``unblock_server`` removes exactly what it finds there; both go
through the delta path of ``commit`` (``_apply_deltas``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import DEFAULT_DTYPE, resolve_device
from .. import obs as _obs
from .types import ClusterSpec, Job, R

# dirty-slot log cap: past it the oldest half is trimmed and the log floor
# rises (the reference's value)
_DIRTY_LOG_MAX = 4096


@dataclasses.dataclass(frozen=True)
class PriceParams:
    U1: np.ndarray  # (R,)
    U2: np.ndarray  # (R,)
    L1: float
    L2: float

    def scaled(self, factor: float) -> "PriceParams":
        """Scale the U/L *ratio* by ``factor`` keeping L fixed (Fig. 6 sweeps)."""
        ratio1 = np.maximum(self.U1 / self.L1, 1.0 + 1e-6) ** factor
        ratio2 = np.maximum(self.U2 / self.L2, 1.0 + 1e-6) ** factor
        return PriceParams(U1=self.L1 * ratio1, U2=self.L2 * ratio2,
                           L1=self.L1, L2=self.L2)

    @property
    def alpha(self) -> float:
        """Competitive-ratio parameter: alpha = max_r(1, ln U1/L1, ln U2/L2)."""
        a = 1.0
        for r in range(len(self.U1)):
            if self.L1 > 0 and self.U1[r] > 0:
                a = max(a, math.log(max(self.U1[r] / self.L1, 1.0)))
            if self.L2 > 0 and self.U2[r] > 0:
                a = max(a, math.log(max(self.U2[r] / self.L2, 1.0)))
        return a


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


class _HostPricer:
    """The decision cores' prices, on the host: ``_pool_prices`` per pool,
    the very bits of the reference's ``impl="fast"`` tables (numpy's
    ``**`` is elementwise, so a slot window prices exactly as the full
    table), and the live floor ``pmin = L1 * r1 ** min_h(g / c)`` (T, R):
    every worker deployed in a slot costs at least ``sum_r wres_r * min_h
    p[t, h, r]``, and with r >= 1 the power is monotone in its exponent.
    Both return numpy float64; an allocation far over capacity prices at
    +inf, silently."""

    def __init__(self, wcaps: np.ndarray, scaps: np.ndarray,
                 params: PriceParams):
        self.caps = (wcaps, scaps)
        self.U = (params.U1, params.U2)
        self.L = (params.L1, params.L2)

    def rows(self, pool: int, alloc: np.ndarray) -> np.ndarray:
        """Price table of ``alloc`` (n, S, R) of pool 0 (workers) or 1
        (PS)."""
        with np.errstate(over="ignore"):
            return _pool_prices(alloc, self.caps[pool][None],
                                self.U[pool][None, None], self.L[pool])

    def floor(self, g: np.ndarray) -> np.ndarray:
        umin = (g / np.maximum(self.caps[0], 1e-12)[None]).min(axis=1)
        ratio = np.maximum(self.U[0] / self.L[0], 1.0 + 1e-9)
        with np.errstate(over="ignore"):
            return self.L[0] * ratio ** umin


class PriceState:
    """Allocations g_h^r(t), v_k^r(t) and the derived price tables.

    Host mirror + device residency on ``device`` (module docstring);
    ``device_uploads`` counts full host-to-device state copies.
    ``window`` bounds the resident slots (``None``: all ``cluster.T``);
    every slot-indexed method takes window-local slots, offsets from
    ``origin``, which ``advance`` moves.

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
                 device: Optional[Union[str, torch.device]] = None,
                 window: Optional[int] = None):
        self.cluster = cluster
        self.params = params
        self.device = resolve_device(device)
        T, H, K = cluster.T, cluster.H, cluster.K
        # resident slots; local slot i is absolute slot origin + i
        self.window = T if window is None else min(int(window), T)
        self._g_host = np.zeros((self.window, H, R))  # alloc on workers
        self._v_host = np.zeros((self.window, K, R))  # alloc on PS servers
        self.origin = 0
        # slots slid out of the window, and their GPU units in use
        self.retired_slots = 0
        self.retired_gpu_slots = 0.0
        # device residency: [g, v, p, q, pmin] tensors or None; static side
        # tables (caps + price params) cached per dtype
        self._dev = None
        self._dev_dtype: Optional[torch.dtype] = None
        self._dev_static = {}
        self._commits_since_sync = 0
        self.device_uploads = 0
        # the decision cores' price expression, on the host (empty pools
        # padded with one zero-capacity server, as the residency is)
        self._pricer = _HostPricer(*self._padded_caps(), params)
        # bumped on every mutation and slide (caches key on it)
        self.version = 0
        # dirty-slot log: (version, t0, t1) per commit/release slot window,
        # so caches can patch only the slots a commit touched.
        # ``_dirty_floor`` is the oldest version the log still covers:
        # ``dirty_spans_since`` answers None (unknowable) for anything
        # older.  Mutable ``g``/``v`` access moves the floor past
        # ``version``: it may change prices outside any logged window.
        self._dirty_log: list = []
        self._dirty_floor = 0

    # -- rolling window ----------------------------------------------------
    @property
    def horizon(self) -> int:
        """Number of resident slots: ``cluster.T``, or the window.  The
        decision cores size their tables from it."""
        return self._g_host.shape[0]

    @property
    def window_bytes(self) -> int:
        """Host-mirror bytes of the slot-indexed state (the residency, once
        made, has the same shape)."""
        return self._g_host.nbytes + self._v_host.nbytes

    def advance(self, now: int) -> None:
        """Slide the window so local slot 0 is absolute slot ``now``.

        The ``now - origin`` oldest slots retire into the scalar aggregates
        and as many exact-zero slots open at the tail.  Surviving slots
        keep their bits in the host mirror and in the float64 residency,
        which slides on the device (``_slide_dev``, no upload); a float32
        residency resyncs from the mirror instead.  No-op when ``now ==
        origin``; the clock never runs backwards."""
        shift = int(now) - self.origin
        if shift == 0:
            return
        if shift < 0:
            raise ValueError(f"advance({now}) before origin {self.origin}")
        if _obs.ENABLED:
            _obs.inc("price.window_advances")
            _obs.inc("price.window_slots_retired", shift)
        W = self.horizon
        k = min(shift, W)
        self.retired_gpu_slots += float(self._g_host[:k, :, 0].sum())
        self.retired_slots += shift
        self.origin = int(now)
        for host in (self._g_host, self._v_host):
            if k < W:
                host[:W - k] = host[k:].copy()
            host[W - k:] = 0.0
        if self._dev is not None:
            if self._dev_dtype != torch.float64:
                self._dev = None
            else:
                self._slide_dev(k)
        self.version += 1
        # every local slot moved: caches from before cannot be patched
        self._dirty_log.clear()
        self._dirty_floor = self.version

    def _slide_dev(self, k: int) -> None:
        """The residency's slide by ``k`` slots: each table's surviving
        slots moved down (through a temporary: an overlapping in-place copy
        is refused), ``g``/``v``'s tail zeroed, and the tail's prices
        priced on the host on those zero rows."""
        W = self.horizon
        lo = max(W - k, 0)
        for buf in self._dev:
            if lo:
                buf[:lo] = buf[k:].clone()
        g, v, p, q, pmin = self._dev
        g[lo:] = 0.0
        v[lo:] = 0.0
        gt, vt = self._host_rows(lo, W)
        p[lo:] = self._to_dev(self._pricer.rows(0, gt))
        q[lo:] = self._to_dev(self._pricer.rows(1, vt))
        pmin[lo:] = self._to_dev(self._pricer.floor(gt))

    # -- host views --------------------------------------------------------
    def _host_write(self) -> None:
        """The caller may write the host mirror: drop the residency
        (re-uploaded on the next ``device_state``) and make every earlier
        version's delta unknowable."""
        self._dev = None
        self._dirty_log.clear()
        self._dirty_floor = self.version + 1

    @property
    def g(self) -> np.ndarray:
        """Worker-pool allocation (T, H, R), host numpy.  Hands out the
        mutable mirror (``_host_write``)."""
        self._host_write()
        return self._g_host

    @g.setter
    def g(self, value: np.ndarray) -> None:
        self._g_host = np.asarray(value, dtype=np.float64)
        self._host_write()

    @property
    def v(self) -> np.ndarray:
        self._host_write()
        return self._v_host

    @v.setter
    def v(self, value: np.ndarray) -> None:
        self._v_host = np.asarray(value, dtype=np.float64)
        self._host_write()

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
        self._apply_deltas(deltas, negative=sign < 0)

    def _apply_deltas(self, deltas, negative: bool) -> None:
        """Every mutation's tail (commit, release, server block and
        unblock): the host add, the residency's in-place update, the
        version bump and the dirty-slot log.  ``deltas``: (pool, host
        array, t0, dense window delta) per pool."""
        for _, host, t0, delta in deltas:
            host[t0:t0 + delta.shape[0]] += delta
        if self._dev is not None and deltas:
            if self._dev_dtype != torch.float64 and (
                    negative
                    or self._commits_since_sync >= self._F32_RESYNC_EVERY):
                # float32 residency: in-place adds round per commit, so it
                # drifts from the float64 mirror, and (g + d) - d is not
                # exact, so a release would leave phantom allocation.
                # Resync from the mirror on every release and every
                # _F32_RESYNC_EVERY commits.
                self._dev = None
            else:
                for pool, host, t0, delta in deltas:
                    win = slice(t0, t0 + delta.shape[0])
                    self._dev[pool][win] += torch.tensor(
                        delta, dtype=self._dev_dtype, device=self.device)
                    # the window's prices, priced on the host
                    self._dev[2 + pool][win] = self._to_dev(
                        self._pricer.rows(pool, host[win]))
                    if pool == 0:
                        self._dev[4][win] = self._to_dev(
                            self._pricer.floor(host[win]))
                self._commits_since_sync += 1
        self.version += 1
        for _, _, t0, delta in deltas:
            self._dirty_log.append((self.version, t0, t0 + delta.shape[0]))
        if len(self._dirty_log) > _DIRTY_LOG_MAX:
            drop = len(self._dirty_log) - _DIRTY_LOG_MAX // 2
            self._dirty_floor = self._dirty_log[drop - 1][0]
            del self._dirty_log[:drop]

    def commit(self, job: Job, workers: dict, ps: dict) -> None:
        rec = _obs.ENABLED
        with (_obs.span("price.commit", jid=job.jid) if rec
              else _obs.NULL_SPAN):
            self._apply(workers, ps, job.worker_res, job.ps_res, 1.0)
        if rec:
            _obs.inc("price.commits")

    def release(self, job: Job, workers: dict, ps: dict) -> None:
        """Inverse of commit (preemption / cancellation)."""
        rec = _obs.ENABLED
        with (_obs.span("price.release", jid=job.jid) if rec
              else _obs.NULL_SPAN):
            self._apply(workers, ps, job.worker_res, job.ps_res, -1.0)
        if rec:
            _obs.inc("price.releases")

    # -- fleet churn: server blocking ---------------------------------------
    def _server_pool(self, pool: str):
        if pool == "worker":
            return 0, self._g_host, self.cluster.worker_caps
        if pool == "ps":
            return 1, self._v_host, self.cluster.ps_caps
        raise ValueError(f"unknown pool {pool!r}")

    def _server_delta(self, pool: str, server: int, t0: int, fill: bool):
        """(pool index, host, window start, dense delta, GPU units) of a
        block (``fill``: to capacity) or an unblock (remove the content)
        of ``server`` over resident slots ``[t0, horizon)``; None when
        there is nothing to do.  The window is bucketed as a commit's, and
        its other entries carry an exact 0.0 delta."""
        pool_i, host, caps = self._server_pool(pool)
        T = host.shape[0]
        t0 = int(min(max(t0, 0), T))
        if t0 >= T or host.shape[1] == 0:
            return None
        amt = (caps[server][None, :] - host[t0:, server, :] if fill
               else -host[t0:, server, :])
        win = min(size_bucket(T - t0, floor=8, step=64), T)
        w0 = T - win
        delta = np.zeros((win, host.shape[1], R))
        delta[t0 - w0:, server, :] = amt
        return pool_i, host, w0, delta, float(amt[:, 0].sum())

    def block_server(self, pool: str, server: int, t0: int = 0) -> float:
        """Fill one server's resident slots ``[t0, horizon)`` to capacity
        (after its victims' tails were released): its headroom drops to
        exactly 0, so no decision can place onto it.  Idempotent per slot
        (a full slot gets an exact-0.0 delta), so the streaming engine
        re-blocks after every ``advance`` for the freshly opened slots.
        Returns the GPU-slot units added."""
        d = self._server_delta(pool, server, t0, fill=True)
        if d is None:
            return 0.0
        self._apply_deltas([d[:4]], negative=False)
        if _obs.ENABLED:
            _obs.inc("price.server_blocks")
        return d[4]

    def unblock_server(self, pool: str, server: int, t0: int = 0) -> float:
        """Inverse of :meth:`block_server`: remove the server's content on
        ``[t0, horizon)`` when it recovers.  Nothing can have committed
        onto a blocked server, so its content is the blocked amount and
        ``x - x`` restores the pre-block zeros exactly, in the mirror and
        the residency alike.  Returns the GPU-slot units released."""
        d = self._server_delta(pool, server, t0, fill=False)
        if d is None:
            return 0.0
        self._apply_deltas([d[:4]], negative=True)
        if _obs.ENABLED:
            _obs.inc("price.server_unblocks")
        return -d[4]

    def dirty_spans_since(self, version: int):
        """Slot spans whose prices may have moved since ``version``: a list
        of ``[t0, t1)`` pairs (possibly overlapping, possibly empty), or
        None when the delta is unknowable (``version`` predates the log
        floor: log trimmed, or mutable ``g``/``v`` access), and the caller
        must invalidate everything."""
        if version < self._dirty_floor:
            return None
        return [(t0, t1) for v, t0, t1 in self._dirty_log if v > version]

    def patch_spans(self, version: int, limit: int = 8):
        """:meth:`dirty_spans_since` when it names at most ``limit`` spans,
        else None: past that, patching span by span costs more than one
        full rebuild."""
        spans = self.dirty_spans_since(version)
        if spans is None or len(spans) > limit:
            return None
        return spans

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

    def alloc_window(self, t0: int, w: int):
        """Per-slot pool totals of the allocation over slots ``[t0, t0 +
        w)``: ``(g_win, v_win)``, each (min(w, T - t0), R), summed over
        servers, from the host mirror.  Read-only: the residency stays
        fresh and no device table is touched."""
        return (self._g_host[t0:t0 + w].sum(axis=1),
                self._v_host[t0:t0 + w].sum(axis=1))

    # -- device residency ---------------------------------------------------
    def _padded_caps(self):
        """Server capacities, each empty pool padded with one
        zero-capacity server so gathers stay in bounds (it can never be
        used)."""
        wcaps, scaps = self.cluster.worker_caps, self.cluster.ps_caps
        if wcaps.shape[0] == 0:
            wcaps = np.zeros((1, R))
        if scaps.shape[0] == 0:
            scaps = np.zeros((1, R))
        return wcaps, scaps

    def _to_dev(self, x: np.ndarray) -> torch.Tensor:
        """A host price table as a new tensor on the device."""
        return torch.tensor(x, device=self.device, dtype=self._dev_dtype)

    def _static_arrays(self, dtype: torch.dtype):
        cached = self._dev_static.get(dtype)
        if cached is not None:
            return cached
        wcaps, scaps = self._padded_caps()
        pp = self.params
        sd = tuple(torch.tensor(x, dtype=dtype, device=self.device)
                   for x in (wcaps, scaps, pp.U1, pp.U2, pp.L1, pp.L2))
        self._dev_static[dtype] = sd
        return sd

    def _host_rows(self, lo: int, hi: int):
        """The mirror's slots ``[lo, hi)``, each empty pool padded with one
        zero-capacity server as the residency is."""
        g, v = self._g_host[lo:hi], self._v_host[lo:hi]
        if g.shape[1] == 0:
            g = np.zeros((hi - lo, 1, R))
        if v.shape[1] == 0:
            v = np.zeros((hi - lo, 1, R))
        return g, v

    def _upload(self, dtype: torch.dtype):
        self._commits_since_sync = 0
        g, v = self._host_rows(0, self.horizon)
        self.device_uploads += 1
        if _obs.ENABLED:
            _obs.inc("price.device_uploads")
        # torch.tensor copies; torch.from_numpy would alias the mirror and
        # the residency would then see (and double-count) host writes.
        # The prices are fresh tensors, priced on the host.
        pr = self._pricer
        return [torch.tensor(g, dtype=dtype, device=self.device),
                torch.tensor(v, dtype=dtype, device=self.device),
                self._to_dev(pr.rows(0, g)), self._to_dev(pr.rows(1, v)),
                self._to_dev(pr.floor(g))]

    def device_state(self, dtype: torch.dtype = DEFAULT_DTYPE):
        """Engine view ``(g, v, wcaps, scaps, U1, U2, L1, L2)`` on the
        state's device.  The first call uploads the full state (counted in
        ``device_uploads``); afterwards ``commit``/``release`` keep the
        residency fresh in place.  Empty pools are padded with one
        zero-capacity server."""
        if self._dev is None or self._dev_dtype != dtype:
            self._dev_dtype = dtype
            self._dev = self._upload(dtype)
        return tuple(self._dev[:2]) + self._static_arrays(dtype)

    def device_prices(self, dtype: torch.dtype = DEFAULT_DTYPE):
        """The resident price tables ``(p (T, H, R), q (T, K, R), pmin (T,
        R))`` on the state's device (empty pools padded as in
        ``device_state``), priced on the host (module docstring) and kept
        fresh in place by ``commit``/``release``."""
        self.device_state(dtype)
        return tuple(self._dev[2:])
