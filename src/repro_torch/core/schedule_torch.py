"""Alg. 2 decision cores on PyTorch: the whole-horizon route and the
tiled early-exit route.

``best_schedule_fused(job, state, core=...)`` picks one; both run on the
price state's device and decide the same jobs the same way.

``core="whole"`` (the default) is the counterpart of the reference's
``core/schedule_jax.py::_decide_core`` (the route ``best_schedule_fused``
takes on the TPU):

1. dual prices ``p``/``q`` as ``exp(x * log r)`` (``_price_pow``);
2. per-slot sorted unit costs and capacity prefix sums
   (``_prefix_tables``, stable argsort);
3. the greedy COST_t rows for every (t, d) (``_greedy_cost``,
   searchsorted side="left"), with the padded-d sentinel ``W = 2^30`` and
   the pre-arrival identity rows ``[0, inf, ...]``;
4. the banded min-plus DP over all T slots — ONE launch of the CUDA
   sweep kernel on the card (``kernels/minplus``), cost only;
5. the payoff argmax with the ``_PAY_EPS`` tie rule;
6. the split backtrack with the exact first-index argmin;
7. the greedy placement of the chosen per-slot counts (``_greedy_place``).

``core="tiled"`` is the counterpart of ``_decide_tiled_core``, the route
the reference takes everywhere but the TPU (one lane at a time):

1. a padded state per price-state version (``_padded_state``): tile-padded
   allocations, the price tables and the live-floor price ``pmin``;
2. from the job's arrival tile on, per ``TILE``-slot tile: the tile's
   COST rows (``_tile_rows``, batched prefix tables), the monotone
   dispatch (plateau when every row of the tile has at most ``r_max``
   runs and ``m_pad <= MONO_BAND``, else chain), and the tile's live slots
   stepped, cost only, straight into their rows of the cost table, from
   the carry the previous tile left, in ONE launch per tile: a chain tile
   of the sweep kernel (``ops.minplus_chain``), a plateau tile of the
   plateau kernel (``ops.minplus_plateau_tile``); dead slots (before
   arrival, past the horizon) carry the DP unchanged and launch nothing;
3. per tile, one copy of the tile's ``cost[t, d_tot]`` values to the host,
   where the payoff scan (``> best + _PAY_EPS`` in slot order) and the
   exact early exit run: the loop stops once the utility's suffix maximum
   cannot beat the incumbent plus the live cost floor (``pmin`` times the
   job's demand, spread over the cheapest feasible slots);
4. for an accept, the ``_SPLIT_TOL``-banded backtrack (``_backtrack``) and
   the greedy placement of just the deploying slots (``_place_slots``).

The sequential scans (payoff, backtrack) run on the host over the few
values they read; the same IEEE operations give the same bits as the
reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

import weakref

from .. import DEFAULT_DTYPE
from ..kernels.minplus.monotone import PATH_CHAIN, PATH_PLATEAU, run_count
from ..kernels.minplus.ops import (minplus_chain, minplus_plateau_tile,
                                   minplus_sweep)
from ..kernels.minplus.tiled import TILE
from .pricing import PriceState
from .subroutine import workload_tables
from .types import Job, R, Schedule

# Stand-in for "unbounded" per-server instance capacity (job has no demand
# on some resource): never binds, and prefix sums of it stay exact.
_BIG_CAP = 1.0e9
_PAY_EPS = 1e-12        # payoff tie epsilon — same as the reference path
# padded d entries get this worker count (> any N), so they are infeasible
_W_PAD = 1 << 30
# safety margin on the price-floor cost lower bound (the reference's)
_LB_MARGIN = 0.999
# split-tie band of the tiled route's backtrack (the reference's; see
# ``_backtrack``)
_SPLIT_TOL = 1e-12
# band-width ceiling of the monotone dispatch: the reference's default
# ``REPRO_MONOTONE_BAND``
MONO_BAND = 64
# the routes of ``best_schedule_fused``
CORES = ("whole", "tiled")


def _price_pow(ratio: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``ratio ** x`` computed as ``exp(x * log(ratio))`` — the reference
    engine's form (its docstring: one shared helper, so decision and
    placement prices agree to the last ulp).  ``ratio`` is clamped to
    ``1 + 1e-9`` upstream, and ``x == 0`` still yields exactly 1."""
    return torch.exp(x * torch.log(ratio))


def _price_tables(g, v, wcaps, scaps, U1, U2, L1, L2):
    """Dual price tables p (T', H, R), q (T', K, R) (eq. 22, 25), priced
    elementwise, so any slot subset is bit-identical to the same entries
    of the full tables."""
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

    p, q = _price_tables(*sd)
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


# ---------------------------------------------------------------------------
# Tiled early-exit route
# ---------------------------------------------------------------------------

def _pad_tiles(T: int) -> int:
    return ((T + TILE - 1) // TILE) * TILE


def _pad_state(g, v, wcaps, scaps, U1, U2, L1, L2, T_pad: int):
    """Tile-padded allocations plus everything about the state the tiled
    core needs per tile: the price tables ``p``/``q`` and the live-floor
    price ``pmin`` (T_pad, R) — every worker a schedule deploys in slot s
    costs at least ``sum_r wres_r * min_h p[s, h, r]``, and with ratio >= 1,
    ``min_h ratio^(g/c) == ratio^(min_h g/c)``."""
    T = g.shape[0]
    g = torch.cat([g, g.new_zeros((T_pad - T,) + g.shape[1:])])
    v = torch.cat([v, v.new_zeros((T_pad - T,) + v.shape[1:])])
    ratio1 = torch.clamp(U1 / L1, min=1.0 + 1e-9)
    umin = (g / torch.clamp(wcaps, min=1e-12)[None]).amin(dim=1)
    pmin = L1 * _price_pow(ratio1[None, :], umin)
    p, q = _price_tables(g, v, wcaps, scaps, U1, U2, L1, L2)
    return g, v, pmin, p, q


_pad_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _padded_state(state: PriceState, dtype: torch.dtype, T_pad: int):
    """``state.device_state`` extended with ``_pad_state``'s tables,
    computed once per (state version, residency, T_pad, dtype) and reused
    by every decision until the next commit or release (then re-padded in
    full).  Returns ``(g, v, wcaps, scaps, U1, U2, L1, L2, pmin, p, q)``
    on the device and ``pmin`` on the host."""
    sd = state.device_state(dtype)
    hit = _pad_cache.get(state)
    key = (state.version, T_pad, dtype)
    if hit is not None and hit[0] == key and hit[1] is sd[0]:
        return hit[2]
    g, v, pmin, p, q = _pad_state(*sd, T_pad=T_pad)
    out = ((g, v) + tuple(sd[2:]) + (pmin, p, q), pmin.cpu().numpy())
    _pad_cache[state] = (key, sd[0], out)
    return out


def _utility_curve(job: Job, T: int, T_pad: int) -> np.ndarray:
    u = np.zeros(T_pad)
    a = job.arrival
    u[a:T] = [job.utility(t - a) for t in range(a, T)]
    return u


def _cost_lower_bound(W: np.ndarray) -> float:
    """Price-free per-chunk-pass base of the cost lower bound,
    ``min_d W(d)/d``, scaled by ``_LB_MARGIN``: any schedule placing d
    chunk-passes in one slot deploys at least ``d * min_d W(d)/d``
    workers there."""
    if len(W) < 2:
        return 0.0
    per_unit = float(np.min(W[1:] / np.arange(1, len(W), dtype=np.float64)))
    return _LB_MARGIN * per_unit


def _job_arrays_tiled(job: Job, T: int, T_pad: int, m_pad: int,
                      dtype: torch.dtype, device: torch.device):
    """The tiled core's job arrays: ``resbw`` (2R+2,) = [wres, sres, wbw,
    psbw] and ``WZ`` (2, m_pad) int32 on the device (padded d entries get
    the infeasible worker count ``_W_PAD``); on the host ``resbw``, the
    utility curve ``u`` (T_pad,), its suffix maximum ``usmax``, ``meta``
    = (a, nchunks, d_tot, dcap) and ``lb``, the cost-floor base.  Also
    returns the workload tables (W, Z)."""
    dcap = min(job.max_chunks_per_slot, job.workload)
    W, Z = workload_tables(job, dcap)
    WZ = np.zeros((2, m_pad), np.int32)
    WZ[0] = _W_PAD
    WZ[0, :dcap + 1] = W
    WZ[1, :dcap + 1] = Z
    u = _utility_curve(job, T, T_pad)
    usmax = np.maximum.accumulate(u[::-1])[::-1].copy()
    resbw = np.concatenate([job.worker_res, job.ps_res,
                            [job.worker_bw, job.ps_bw]]).astype(np.float64)
    meta = (int(job.arrival), int(job.num_chunks), int(job.workload),
            int(dcap))
    jd = (torch.tensor(resbw, dtype=dtype, device=device),
          torch.tensor(WZ, device=device), resbw, u, usmax, meta,
          _cost_lower_bound(W))
    return jd, (W, Z)


def _prefix_tables_b(prices: torch.Tensor, headroom: torch.Tensor,
                     demand: torch.Tensor):
    """Lane-batched prefix tables for one tile.

    prices/headroom: (TILE, S, R) shared across lanes; demand: (B, R).
    Returns (scost, ccap, ccost), each (B, TILE, S).  The unit price is
    summed over resources left to right and the sort is stable, as in
    ``_prefix_tables``."""
    unit = prices[None, :, :, 0] * demand[:, None, None, 0]
    for r in range(1, prices.shape[2]):
        unit = unit + prices[None, :, :, r] * demand[:, None, None, r]
    safe = torch.where(demand > 0, demand, 1.0)
    per_r = torch.where(demand[:, None, None, :] > 0,
                        torch.floor(headroom[None] / safe[:, None, None, :]
                                    + 1e-9),
                        _BIG_CAP)
    cap = torch.clamp(per_r.amin(dim=3), 0.0, _BIG_CAP)
    order = torch.argsort(unit, dim=2, stable=True)
    scost = torch.gather(unit, 2, order)
    scap = torch.gather(cap, 2, order)
    ccap = torch.cumsum(scap, dim=2)
    ccost = torch.cumsum(scap * scost, dim=2)
    return scost, ccap, ccost


def _greedy_cost_b(ccap: torch.Tensor, ccost: torch.Tensor,
                   scost: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Lane-batched greedy cost: (B, TILE, S) tables, (B, TILE, M)
    counts; +inf where the counts exceed capacity."""
    S = ccap.shape[2]
    idx = torch.searchsorted(ccap, counts.contiguous(), side="left")
    zcol = ccap.new_zeros(ccap.shape[:2] + (1,))
    prev_cap = torch.gather(torch.cat([zcol, ccap], -1), -1, idx)
    prev_cost = torch.gather(torch.cat([zcol, ccost], -1), -1, idx)
    marg = torch.gather(scost, -1, torch.clamp(idx, max=S - 1))
    vals = prev_cost + (counts - prev_cap) * marg
    return torch.where(counts == 0, 0.0,
                       torch.where(counts <= ccap[..., -1:], vals,
                                   float("inf")))


def _tile_rows(psd, jd, t0: int, T: int) -> torch.Tensor:
    """COST_t rows of slots [t0, t0 + TILE) for one lane, (TILE, M): the
    reference's ``rows_for_tile`` on its inline path (tables built from
    slices of the version-cached price tables).  Dead slots (before
    arrival, past the horizon) get the identity row ``[0, inf, ...]``."""
    g, v, wcaps, scaps = psd[:4]
    p_pad, q_pad = psd[9], psd[10]
    resbw, WZ = jd[0][None], jd[1]
    a = jd[5][0]
    wres, sres = resbw[:, :R], resbw[:, R:2 * R]
    wbw, psbw = resbw[:, 2 * R], resbw[:, 2 * R + 1]
    W, Z = WZ[0][None], WZ[1][None]                       # (1, M)
    dt = g.dtype
    t1 = t0 + TILE
    w_scost, w_ccap, w_ccost = _prefix_tables_b(
        p_pad[t0:t1], wcaps[None] - g[t0:t1], wres)
    s_scost, s_ccap, s_ccost = _prefix_tables_b(
        q_pad[t0:t1], scaps[None] - v[t0:t1], sres)
    Wt = W.to(dt)[:, None, :].expand(1, TILE, W.shape[1])
    w_costs = _greedy_cost_b(w_ccap, w_ccost, w_scost, Wt)
    pool = s_ccap[..., -1:]                               # (1, TILE, 1)
    deploy = torch.minimum(torch.minimum(Z, W).to(dt)[:, None, :], pool)
    feas_n = (W <= jd[5][1])[:, None, :]
    feas_ps = deploy * psbw[:, None, None] >= Wt * wbw[:, None, None] - 1e-9
    z_costs = _greedy_cost_b(s_ccap, s_ccost, s_scost, deploy)
    rows = torch.where(feas_n & feas_ps, w_costs + z_costs, float("inf"))[0]
    rows[:, 0] = 0.0
    # pre-arrival and beyond-horizon slots carry the DP unchanged
    lo, hi = min(max(a - t0, 0), TILE), min(max(T - t0, 0), TILE)
    rows[:lo, 1:] = float("inf")
    rows[hi:, 1:] = float("inf")
    return rows


def _live_floor(pmin_h: np.ndarray, jd, T: int) -> float:
    """Early-exit cost floor: the base ``lb`` times the cheapest spread of
    the workload over feasible slots (at most ``dcap`` chunk-passes per
    slot, each slot at its live per-worker price floor).  A valid lower
    bound on every schedule's cost (the reference's ``:480-519``)."""
    resbw_h, meta, lb = jd[2], jd[5], jd[6]
    a, _, d_tot, dcap = meta
    T_pad = pmin_h.shape[0]
    wslot = pmin_h[:, 0] * resbw_h[0]                 # summed left to right
    for r in range(1, R):
        wslot = wslot + pmin_h[:, r] * resbw_h[r]
    ts = np.arange(T_pad)
    wsort = np.sort(np.where((ts >= a) & (ts < T), wslot, np.inf))
    dcap_f = float(max(dcap, 1))
    take = np.clip(float(d_tot) - ts.astype(np.float64) * dcap_f, 0.0,
                   dcap_f)
    floor_sum = float(np.sum(take * np.where(np.isfinite(wsort), wsort,
                                             0.0)))
    return lb * floor_sum if lb > 0 else 0.0


def _decide_tiled_core(psd, jd, *, T: int, d1: int, mono: int):
    """One lane of the reference's ``_decide_tiled_core``: Alg. 2 over
    the horizon in ``TILE``-slot tiles from the arrival tile, with the
    exact early exit (module docstring).

    psd: ``_padded_state`` — device tensors (g, v (T_pad, S, R), wcaps,
        scaps, U1, U2, L1, L2, pmin (T_pad, R), p, q) and pmin on the host
    jd: ``_job_arrays_tiled``
    T: the real horizon; d1: DP columns (padded D_total + 1)
    mono: 0 = chain only, 1 = plateau or chain, chosen once per tile: the
        plateau when every row of the tile is free of NaN/-inf and has at
        most ``r_max = max(16, M // 4)`` runs.

    Returns ``(best_t (-1 = reject), payoff, rows (T_pad, M), cost
    (T_pad, d1), k0, k_end, paths, live)``: the device tables hold the
    visited tiles' rows and the live slots' DP columns; [k0, k_end) is the
    visited tile range, ``paths`` the per-branch tile counts [dnc,
    plateau, chain] and ``live`` the live slots stepped per branch (on
    the card: one plateau-kernel launch per plateau tile, one sweep-kernel
    launch per chain tile)."""
    sdev, pmin_h = psd
    u, usmax, meta = jd[3], jd[4], jd[5]
    a, _, d_tot, _ = meta
    T_pad = u.shape[0]
    n_tiles = T_pad // TILE
    M = jd[1].shape[1]
    g = sdev[0]
    dt, dev = g.dtype, g.device
    r_max = max(16, M // 4)
    lb = _live_floor(pmin_h, jd, T)

    rows_buf = torch.full((T_pad, M), float("inf"), dtype=dt, device=dev)
    rows_buf[:, 0] = 0.0
    cost_buf = torch.empty((T_pad, d1), dtype=dt, device=dev)
    prev = torch.full((d1,), float("inf"), dtype=dt, device=dev)
    prev[0] = 0.0
    best, best_t = 0.0, -1
    paths = [0, 0, 0]
    live = [0, 0, 0]
    k0 = k = a // TILE
    while k < n_tiles and usmax[min(k * TILE, T_pad - 1)] > \
            best + _PAY_EPS + lb:
        t0 = k * TILE
        rows = _tile_rows(sdev, jd, t0, T)
        rows_buf[t0:t0 + TILE] = rows
        branch = PATH_CHAIN
        if mono:
            clean = ((rows == rows) & (rows > float("-inf"))).all()
            if bool(clean & (run_count(rows) <= r_max).all()):
                branch = PATH_PLATEAU
        paths[branch] += 1
        lo, hi = max(a, t0), min(T, t0 + TILE)
        if hi > lo:
            if branch == PATH_PLATEAU:
                minplus_plateau_tile(rows[lo - t0:hi - t0], prev,
                                     cost_buf[lo:hi], r_max)
            else:
                minplus_chain(rows[lo - t0:hi - t0], prev, cost_buf[lo:hi])
            prev = cost_buf[hi - 1]
            live[branch] += hi - lo
            cost_d = cost_buf[lo:hi, d_tot].cpu().numpy()
            for t in range(lo, hi):
                c = cost_d[t - lo]
                pay = u[t] - c if np.isfinite(c) else -np.inf
                if pay > best + _PAY_EPS:
                    best, best_t = pay, t
        k += 1
    return best_t, best, rows_buf, cost_buf, k0, k, paths, live


def _backtrack(rows_h: np.ndarray, cost_h: np.ndarray, a: int, best_t: int,
               d_tot: int) -> Tuple[int, np.ndarray]:
    """Split recovery for an accept, on the host, from the core's tables:
    ``rows_h`` (best_t - a + 1, M) are the rows of slots a..best_t and
    ``cost_h`` (best_t - a, d_tot + 1) the DP columns of slots
    a..best_t-1 (slot a-1's column is the identity ``[0, inf, ...]``).

    Walks t down from ``best_t``, taking as each slot's split the FIRST j
    with ``rows[t, j] + cost_{t-1}[d_rem - j]`` within ``_SPLIT_TOL``
    (relative) of the minimum — the reference's band, which makes the
    split a function of the optimal set rather than of last-ulp noise —
    and stops once the workload is placed (every earlier slot would split
    0).  Returns (d_left, d_slots (best_t + 1,))."""
    M = rows_h.shape[1]
    init = np.full(d_tot + 1, np.inf)
    init[0] = 0.0
    js = np.arange(M)
    d_slots = np.zeros(best_t + 1, np.int64)
    d_rem = d_tot
    for t in range(best_t, a - 1, -1):
        if d_rem == 0:
            break
        prev = cost_h[t - 1 - a] if t > a else init
        idx = d_rem - js
        vals = np.where(idx >= 0,
                        rows_h[t - a] + prev[np.clip(idx, 0, d_tot)], np.inf)
        band = vals <= vals.min() * (1.0 + _SPLIT_TOL)
        d_here = int(np.argmax(band))
        d_slots[t] = d_here
        d_rem -= d_here
    return d_rem, d_slots


def _place_slots(sd, resbw: torch.Tensor, Wc: torch.Tensor,
                 Zc: torch.Tensor, ts: torch.Tensor):
    """Greedy placements (y (n, H'), z (n, K') int32) of the per-slot
    worker and PS-target counts ``Wc``/``Zc`` at the slots ``ts`` — the
    whole route's fills, priced at just those slots (each slot's fill
    reads only its own state column)."""
    g, v, wcaps, scaps, U1, U2, L1, L2 = sd
    g_w, v_w = g[ts], v[ts]
    p, q = _price_tables(g_w, v_w, wcaps, scaps, U1, U2, L1, L2)
    w_order, w_scap, _, w_ccap, _ = _prefix_tables(
        p, wcaps[None] - g_w, resbw[:R])
    s_order, s_scap, _, s_ccap, _ = _prefix_tables(
        q, scaps[None] - v_w, resbw[R:2 * R])
    y = _greedy_place(w_order, w_scap, w_ccap, Wc)
    deploy = torch.minimum(torch.minimum(Zc, Wc), s_ccap[:, -1])
    z = _greedy_place(s_order, s_scap, s_ccap, deploy)
    return y, z


def _materialize(job: Job, state: PriceState, best_t: int, rows_buf,
                 cost_buf, W: np.ndarray, Z: np.ndarray, resbw: torch.Tensor
                 ) -> Optional[Schedule]:
    """The accepted schedule of a tiled decision (None = reject): the
    banded backtrack and the placement of the deploying slots, at the
    price state the decision was made at."""
    if best_t < 0:
        return None
    a, d_tot = job.arrival, job.workload
    rows_h = rows_buf[a:best_t + 1].cpu().numpy()
    cost_h = cost_buf[a:best_t + 1, :d_tot + 1].cpu().numpy()
    cost = float(cost_h[-1, d_tot])
    d_left, d_slots = _backtrack(rows_h, cost_h[:-1], a, best_t, d_tot)
    if d_left != 0:
        raise RuntimeError(
            f"backtrack failed: {d_left} chunk-passes unassigned")
    utility = job.utility(best_t - a)
    ts_active = np.nonzero(d_slots[a:])[0] + a
    workers, ps = {}, {}
    if len(ts_active):
        sd = state.device_state(DEFAULT_DTYPE)
        dt, dev = sd[0].dtype, sd[0].device
        d_act = d_slots[ts_active]
        y, z = _place_slots(
            sd, resbw, torch.tensor(W[d_act], dtype=dt, device=dev),
            torch.tensor(Z[d_act], dtype=dt, device=dev),
            torch.as_tensor(ts_active, device=dev))
        y, z = y.cpu().numpy(), z.cpu().numpy()
        H, K = state.cluster.H, state.cluster.K
        for i, t in enumerate(ts_active):
            workers[int(t)] = y[i, :H].astype(np.int64)
            ps[int(t)] = z[i, :K].astype(np.int64)
    return Schedule(jid=job.jid, workers=workers, ps=ps, finish=int(best_t),
                    cost=cost, payoff=utility - cost, utility=utility)


# tiles per branch, live slots stepped (all, and those of plateau tiles)
# and decisions of the tiled route since the last reset (the reference's
# monotone fallback counters plus the route's own)
_monotone_counters = {"dnc": 0, "plateau": 0, "chain": 0, "slots": 0,
                      "plateau_slots": 0, "decisions": 0}


def monotone_counters_reset() -> None:
    for k in _monotone_counters:
        _monotone_counters[k] = 0


def monotone_counters_snapshot() -> dict:
    """Tiles processed per min-plus branch since the last reset: ``dnc``
    (not ported, always 0), ``plateau``, ``chain``; with ``slots``, the
    live slots the tiled route stepped, ``plateau_slots``, those of
    plateau tiles, and ``decisions``, the tiled decisions that ran the DP.
    On the card each plateau tile is one plateau-kernel launch and each
    chain tile one sweep-kernel launch."""
    return dict(_monotone_counters)


def _decide_tiled(job: Job, state: PriceState, m_pad: int, d1: int
                  ) -> Optional[Schedule]:
    T = state.horizon
    T_pad = _pad_tiles(T)
    psd = _padded_state(state, DEFAULT_DTYPE, T_pad)
    jd, (W, Z) = _job_arrays_tiled(job, T, T_pad, m_pad, DEFAULT_DTYPE,
                                   state.device)
    mono = 1 if m_pad <= MONO_BAND else 0
    best_t, _, rows_buf, cost_buf, _, _, paths, live = _decide_tiled_core(
        psd, jd, T=T, d1=d1, mono=mono)
    for key, n in zip(("dnc", "plateau", "chain"), paths):
        _monotone_counters[key] += n
    _monotone_counters["slots"] += sum(live)
    _monotone_counters["plateau_slots"] += live[PATH_PLATEAU]
    _monotone_counters["decisions"] += 1
    return _materialize(job, state, best_t, rows_buf, cost_buf, W, Z, jd[0])


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


def best_schedule_fused(job: Job, state: PriceState, *,
                        core: str = "whole") -> Optional[Schedule]:
    """Alg. 2 for one job at the state's current prices, on the state's
    device; None = reject.

    ``core="whole"``: the whole-horizon route, one DP-sweep launch on the
    card.  ``core="tiled"``: the tiled early-exit route, one kernel launch
    per tile it visits with live slots: the sweep kernel for a chain tile,
    the plateau kernel for a plateau tile (module docstring)."""
    if core not in CORES:
        raise ValueError(f"core must be one of {CORES}, not {core!r}")
    key = _shape_bucket(job)
    if key is None:
        return None
    m_pad, d1 = key
    if core == "tiled":
        return _decide_tiled(job, state, m_pad, d1)
    sd = state.device_state(DEFAULT_DTYPE)
    jd = _job_arrays(job, state.horizon, m_pad, DEFAULT_DTYPE, state.device)
    best_t, cost, d_left, d_slots, y, z = _decide_core(sd, jd, d1)
    return _schedule_from_outputs(job, state, best_t, cost, d_left,
                                  d_slots, y, z)
