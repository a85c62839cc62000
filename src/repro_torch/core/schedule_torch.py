"""Whole-horizon Alg. 2 decision core on PyTorch.

The counterpart of the reference's ``core/schedule_jax.py::_decide_core``
(the route ``best_schedule_fused`` takes on the TPU), step by step on the
price state's device:

1. dual prices ``p``/``q`` as ``exp(x * log r)`` (``_price_pow``);
2. per-slot sorted unit costs and capacity prefix sums
   (``_prefix_tables``, stable argsort);
3. the greedy COST_t rows for every (t, d) (``_greedy_cost``,
   searchsorted side="left"), with the padded-d sentinel ``W = 2^30`` and
   the pre-arrival identity rows ``[0, inf, ...]``;
4. the banded min-plus DP over all T slots — ONE launch of the CUDA
   kernel on the card (``kernels/minplus``), cost only;
5. the payoff argmax with the ``_PAY_EPS`` tie rule;
6. the split backtrack with the exact first-index argmin;
7. the greedy placement of the chosen per-slot counts (``_greedy_place``).

Steps 5 and 6 are sequential scans over at most T slots and run on the
host over the few values they read (the backtrack stops once the
workload is placed, which is exact: every earlier slot would split 0).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import DEFAULT_DTYPE
from ..kernels.minplus.ops import minplus_sweep
from .pricing import PriceState
from .subroutine import workload_tables
from .types import Job, R, Schedule

# Stand-in for "unbounded" per-server instance capacity (job has no demand
# on some resource): never binds, and prefix sums of it stay exact.
_BIG_CAP = 1.0e9
_PAY_EPS = 1e-12        # payoff tie epsilon — same as the reference path
# padded d entries get this worker count (> any N), so they are infeasible
_W_PAD = 1 << 30


def _price_pow(ratio: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``ratio ** x`` computed as ``exp(x * log(ratio))`` — the reference
    engine's form (its docstring: one shared helper, so decision and
    placement prices agree to the last ulp).  ``ratio`` is clamped to
    ``1 + 1e-9`` upstream, and ``x == 0`` still yields exactly 1."""
    return torch.exp(x * torch.log(ratio))


def _prices(sd):
    """Dual price tables p (T, H, R), q (T, K, R) (eq. 22, 25)."""
    g, v, wcaps, scaps, U1, U2, L1, L2 = sd
    p = L1 * _price_pow(torch.clamp(U1 / L1, min=1.0 + 1e-9)[None, None, :],
                        g / torch.clamp(wcaps, min=1e-12)[None])
    q = L2 * _price_pow(torch.clamp(U2 / L2, min=1.0 + 1e-9)[None, None, :],
                        v / torch.clamp(scaps, min=1e-12)[None])
    return p, q


def _prefix_tables(prices: torch.Tensor, headroom: torch.Tensor,
                   demand: torch.Tensor):
    """Per-slot sorted unit costs + prefix sums (all slots).

    Returns (order, scap, scost, ccap, ccost), each (T, S)."""
    # unit price summed over resources left to right, the reference
    # engine's order (torch.sum may pair the terms differently)
    unit = prices[:, :, 0] * demand[0]                           # (T, S)
    for r in range(1, prices.shape[2]):
        unit = unit + prices[:, :, r] * demand[r]
    safe = torch.where(demand > 0, demand, 1.0)
    per_r = torch.where(demand[None, None, :] > 0,
                        torch.floor(headroom / safe[None, None, :] + 1e-9),
                        _BIG_CAP)
    cap = torch.clamp(per_r.amin(dim=2), 0.0, _BIG_CAP)          # (T, S)
    order = torch.argsort(unit, dim=1, stable=True)
    scost = torch.gather(unit, 1, order)
    scap = torch.gather(cap, 1, order)
    ccap = torch.cumsum(scap, dim=1)
    ccost = torch.cumsum(scap * scost, dim=1)
    return order, scap, scost, ccap, ccost


def _greedy_cost(ccap: torch.Tensor, ccost: torch.Tensor,
                 scost: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Greedy (cheapest-first) deployment cost of ``counts`` (T, M) at
    every slot, from (T, S) prefix tables.  +inf where counts exceed
    capacity."""
    S = ccap.shape[1]
    counts = counts.contiguous()
    # first prefix covering each count (== np.searchsorted side="left")
    idx = torch.searchsorted(ccap, counts, side="left")
    zcol = torch.zeros((ccap.shape[0], 1), dtype=ccap.dtype,
                       device=ccap.device)
    prev_cap = torch.gather(torch.cat([zcol, ccap], 1), 1, idx)
    prev_cost = torch.gather(torch.cat([zcol, ccost], 1), 1, idx)
    marg = torch.gather(scost, 1, torch.clamp(idx, max=S - 1))
    vals = prev_cost + (counts - prev_cap) * marg
    return torch.where(counts == 0, 0.0,
                       torch.where(counts <= ccap[:, -1:], vals,
                                   float("inf")))


def _greedy_place(order: torch.Tensor, scap: torch.Tensor,
                  ccap: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Per-server instance counts for a greedy fill of ``count`` (T,) at
    each slot: cheapest servers first, each up to its capacity.  Returns
    (T, S) int32 in ORIGINAL server order."""
    prev = torch.cat([torch.zeros((ccap.shape[0], 1), dtype=ccap.dtype,
                                  device=ccap.device), ccap[:, :-1]], dim=1)
    take = torch.minimum(torch.clamp(count[:, None] - prev, min=0.0), scap)
    inv = torch.argsort(order, dim=1, stable=True)               # rank of h
    return torch.round(torch.gather(take, 1, inv)).to(torch.int32)


def _decide_core(sd, jd, d1: int):
    """One Alg. 2 decision over the whole horizon.

    sd: state tensors (g (T,H,R), v (T,K,R), wcaps (H,R), scaps (K,R),
        U1 (R,), U2 (R,), L1 (), L2 ()) on one device
    jd: job arrays (resbw (2R+2,) = [wres, sres, wbw, psbw] and WZ (2, M)
        int32 on that device; u (T,) float64 host; meta = (a, nchunks,
        workload) ints)
    d1: DP columns (padded D_total + 1).

    Returns host values (best_t (-1 = reject), total_cost, d_left —
    workload still unassigned after the backtrack, 0 for any sound accept
    —, d_slots (T,), y (T, H) int32, z (T, K) int32); d_slots, y and z are
    None for a reject.
    """
    g, v, wcaps, scaps, U1, U2, L1, L2 = sd
    resbw, WZ, u, meta = jd
    wres, sres = resbw[:R], resbw[R:2 * R]
    wbw, psbw = resbw[2 * R], resbw[2 * R + 1]
    W, Z = WZ[0], WZ[1]
    a, nchunks, d_tot = meta
    T = g.shape[0]
    M = W.shape[0]
    dt = g.dtype
    dev = g.device

    p, q = _prices(sd)
    w_order, w_scap, w_scost, w_ccap, w_ccost = _prefix_tables(
        p, wcaps[None] - g, wres)
    s_order, s_scap, s_scost, s_ccap, s_ccost = _prefix_tables(
        q, scaps[None] - v, sres)

    # COST_t rows for all (t, d)
    Wt = W.to(dt)[None, :].expand(T, M)
    w_costs = _greedy_cost(w_ccap, w_ccost, w_scost, Wt)
    pool = s_ccap[:, -1:]                                        # (T, 1)
    deploy = torch.minimum(torch.minimum(Z, W).to(dt)[None, :], pool)
    feas_n = (W <= nchunks)[None, :]
    feas_ps = deploy * psbw >= Wt * wbw - 1e-9
    z_costs = _greedy_cost(s_ccap, s_ccost, s_scost, deploy)
    rows = torch.where(feas_n & feas_ps, w_costs + z_costs, float("inf"))
    rows[:, 0] = 0.0
    # slots before arrival carry the DP unchanged: row = [0, inf, ...]
    rows[:a, 1:] = float("inf")

    # banded min-plus DP over slots (cost only; splits recovered below)
    cost_tab, _ = minplus_sweep(rows, d1 - 1, want_split=False)

    # payoff argmax with the reference tie rule (> best + eps switches)
    costD = cost_tab[:, d_tot].cpu().numpy()
    u = u.astype(costD.dtype)
    best_payoff, best_t = costD.dtype.type(0.0), -1
    for t in np.flatnonzero(np.isfinite(costD[a:])) + a:
        pt = u[t] - costD[t]
        if pt > best_payoff + _PAY_EPS:
            best_payoff, best_t = pt, int(t)
    if best_t < 0:
        return -1, float(costD[0]), 0, None, None, None

    # backtrack from best_t down to arrival: each slot's split is the
    # first argmin_j rows[t, j] + cost_{t-1}[d_rem - j]; cost_{a-1} is
    # the DP identity [0, inf, ...] (pre-arrival rows are the identity)
    rows_h = rows[a:best_t + 1].cpu().numpy()
    prev_h = cost_tab[max(a - 1, 0):best_t, :d_tot + 1].cpu().numpy()
    init = np.full(d_tot + 1, np.inf, rows_h.dtype)
    init[0] = 0.0
    js = np.arange(M)
    d_slots = np.zeros(T, np.int64)
    d_rem = d_tot
    for t in range(best_t, a - 1, -1):
        if d_rem == 0:
            break
        prev = prev_h[t - 1 - max(a - 1, 0)] if t > 0 else init
        idx = d_rem - js
        vals = np.where(idx >= 0,
                        rows_h[t - a] + prev[np.clip(idx, 0, d_tot)], np.inf)
        d_here = int(np.argmin(vals))
        d_slots[t] = d_here
        d_rem -= d_here

    # greedy placements for the chosen per-slot counts
    d_dev = torch.as_tensor(d_slots, device=dev)
    W_slots = W[d_dev]
    Z_slots = Z[d_dev]
    deploy_slots = torch.minimum(torch.minimum(Z_slots, W_slots).to(dt),
                                 pool[:, 0])
    y = _greedy_place(w_order, w_scap, w_ccap, W_slots.to(dt))
    z = _greedy_place(s_order, s_scap, s_ccap, deploy_slots)
    return (best_t, float(costD[best_t]), d_rem, d_slots, y.cpu().numpy(),
            z.cpu().numpy())


def _pow2_bucket(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _band_bucket(n: int) -> int:
    """Band-width (m_pad) bucket: 64, 128, then multiples of 128.  Padded
    columns carry the infeasible sentinel, so DP values are identical
    across buckets."""
    if n <= 64:
        return 64
    if n <= 128:
        return 128
    return ((n + 127) // 128) * 128


def _shape_bucket(job: Job) -> Optional[Tuple[int, int]]:
    """Padded (m_pad, d1) of a job's DP tables; None for dcap == 0 (such a
    job is rejected without solving).  The d1 floor of 1280 covers the
    auto-quantized workload range, so scale runs see a single d1."""
    dcap = min(job.max_chunks_per_slot, job.workload)
    if dcap == 0:
        return None
    return (_band_bucket(dcap + 1), _pow2_bucket(job.workload + 1, 1280))


def _job_arrays(job: Job, T: int, m_pad: int, dtype: torch.dtype,
                device: torch.device):
    """The decision core's job arrays (see ``_decide_core``)."""
    dcap = min(job.max_chunks_per_slot, job.workload)
    W, Z = workload_tables(job, dcap)
    WZ = np.zeros((2, m_pad), np.int32)
    WZ[0] = _W_PAD
    WZ[0, :dcap + 1] = W
    WZ[1, :dcap + 1] = Z
    a = job.arrival
    u = np.array([job.utility(t - a) if t >= a else 0.0 for t in range(T)])
    resbw = np.concatenate([job.worker_res, job.ps_res,
                            [job.worker_bw, job.ps_bw]])
    return (torch.tensor(resbw, dtype=dtype, device=device),
            torch.tensor(WZ, device=device), u,
            (int(a), int(job.num_chunks), int(job.workload)))


def _schedule_from_outputs(job: Job, state: PriceState, best_t: int,
                           cost: float, d_left: int, d_slots: np.ndarray,
                           y: np.ndarray, z: np.ndarray
                           ) -> Optional[Schedule]:
    """Schedule assembly from the decision core's outputs."""
    if best_t < 0:
        return None
    if d_left != 0:
        raise RuntimeError(
            f"backtrack failed: {d_left} chunk-passes unassigned")
    H, K = state.cluster.H, state.cluster.K
    workers, ps = {}, {}
    for t in range(job.arrival, best_t + 1):
        if d_slots[t] > 0:
            workers[t] = y[t, :H].astype(np.int64)
            ps[t] = z[t, :K].astype(np.int64)
    utility = job.utility(best_t - job.arrival)
    return Schedule(jid=job.jid, workers=workers, ps=ps, finish=int(best_t),
                    cost=float(cost), payoff=utility - float(cost),
                    utility=utility)


def best_schedule_fused(job: Job, state: PriceState) -> Optional[Schedule]:
    """Alg. 2 for one job at the state's current prices, on the state's
    device (one DP-sweep launch on the card); None = reject."""
    key = _shape_bucket(job)
    if key is None:
        return None
    m_pad, d1 = key
    sd = state.device_state(DEFAULT_DTYPE)
    jd = _job_arrays(job, state.horizon, m_pad, DEFAULT_DTYPE, state.device)
    best_t, cost, d_left, d_slots, y, z = _decide_core(sd, jd, d1)
    return _schedule_from_outputs(job, state, best_t, cost, d_left,
                                  d_slots, y, z)
