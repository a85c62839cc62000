"""Alg. 2 decision cores on PyTorch: the whole-horizon route and the
tiled early-exit route.

``best_schedule_fused(job, state, core=...)`` picks one; both run on the
price state's device and decide the same jobs the same way.  Both read
the dual prices ``p``/``q`` from the price state's residency
(``PriceState.device_prices``), priced on the host by one expression, so
the card decides on the CPU's very prices; every prefix sum runs left to
right (``_prefix_sums``) on both devices.

``core="whole"`` (the default) is the counterpart of the reference's
``core/schedule_jax.py::_decide_core`` (the route ``best_schedule_fused``
takes on the TPU):

1. per-slot sorted unit costs and capacity prefix sums
   (``_prefix_tables``, stable argsort);
2. the greedy COST_t rows for every (t, d) (``_greedy_cost``,
   searchsorted side="left"), with the padded-d sentinel ``W = 2^30`` and
   the pre-arrival identity rows ``[0, inf, ...]``;
3. the banded min-plus DP over all T slots — ONE launch of the CUDA
   sweep kernel on the card (``kernels/minplus``), cost only;
4. the payoff argmax with the ``_PAY_EPS`` tie rule;
5. the split backtrack with the exact first-index argmin;
6. the greedy placement of the chosen per-slot counts (``_greedy_place``).

``core="tiled"`` is the counterpart of ``_decide_tiled_core``, the route
the reference takes everywhere but the TPU, over a batch of lanes (the
jobs of one shape bucket, ``_decide_jobs``):

1. a padded state per price-state version (``_padded_state``): tile-padded
   allocations, price tables and live-floor price ``pmin``;
2. from the earliest arrival tile on, per ``TILE``-slot tile: the tile's
   COST rows for every lane (``_tile_rows``, from batched prefix tables;
   a tile valid in every lane's ``RowCache`` is served from the cache),
   the monotone dispatch (one lane only and ``m_pad <= MONO_BAND``; its
   gates read on the host in one copy): with ``REPRO_MONOTONE_DNC`` set,
   D&C when every row of the tile is certified convex
   (``monotone.convex_certificate``), else plateau when every row has at
   most ``r_max`` runs, else chain; and the tile's live slots stepped,
   cost only, straight into the cost table, from the carry the previous
   tile left, in ONE launch per tile for all lanes: a chain tile of the
   sweep kernel, one cluster per lane (``ops.minplus_chain``), a plateau
   tile of the plateau kernel (``ops.minplus_plateau_tile``), a D&C tile
   of the D&C kernel (``ops.minplus_dnc_tile``); slots before every
   lane's arrival and past the horizon launch nothing, and a lane's own
   dead slots carry identity rows, which leave its carry unchanged;
3. per tile, one copy of each lane's ``cost[t, d_tot]`` values to the
   host, where the payoff scan (``> best + _PAY_EPS`` in slot order) and
   the exact early exit run: the loop stops once no lane's utility suffix
   maximum can beat its incumbent plus its live cost floor (``pmin``
   times the job's demand, spread over the cheapest feasible slots);
4. for an accepted candidate only (``_materialize``), the
   ``_SPLIT_TOL``-banded backtrack (``_backtrack``) and the greedy
   placement of just the deploying slots (``_place_slots``).

``decide_burst`` decides a burst speculatively at the current prices,
one launch per shape bucket and at most ``REPRO_BURST_LANES`` lanes;
``OASiS.on_arrivals`` commits it and re-solves through each job's
``RowCache`` once prices have moved.

The sequential scans (payoff, backtrack) run on the host over the few
values they read; the same IEEE operations give the same bits as the
reference's.

**Precision.**  ``precision=`` on ``best_schedule_fused``,
``decide_burst`` and ``best_schedule_fused_batch`` (and on ``OASiS`` and
the engine's run functions) picks the route's dtype: ``"auto"`` and ``"x64"``
float64 (the card has float64: the reference's CPU precision), ``"x32"``
float32, the precision of the reference's TPU route.  The state's
residency, the rows, the DP and the host scans (payoff, early exit,
live floor, backtrack band) then all run in that dtype, as the
reference's do in its lane dtype.
"""
from __future__ import annotations

import dataclasses
import os
import time
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import DEFAULT_DTYPE
from .. import obs as _obs
from ..kernels.minplus.monotone import (PATH_CHAIN, PATH_DNC, PATH_PLATEAU,
                                       convex_certificate, run_count)
from ..kernels.minplus.ops import (minplus_chain, minplus_dnc_tile,
                                   minplus_plateau_tile, minplus_sweep)
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
# the route precisions of ``best_schedule_fused`` and ``decide_burst``
PRECISIONS = ("auto", "x32", "x64")


def route_dtype(precision: str) -> torch.dtype:
    """The decision route's dtype for ``precision``: float64 for
    ``"auto"`` and ``"x64"`` (the reference picks float64 wherever its
    backend has it, and the card has it), float32 for ``"x32"`` (the
    reference's TPU route).  Raises ValueError on any other string."""
    if precision in ("auto", "x64"):
        return torch.float64
    if precision == "x32":
        return torch.float32
    raise ValueError(f"precision must be one of {PRECISIONS}, not "
                     f"{precision!r}")


def _np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _mono_dnc() -> bool:
    """``REPRO_MONOTONE_DNC``: whether the monotone dispatch may take the
    convex D&C branch (off unless set, as in the reference).  Re-read per
    launch, so a caller may set it between runs."""
    return os.environ.get("REPRO_MONOTONE_DNC", "") not in ("", "0")


# ---------------------------------------------------------------------------
# Decision-stage profile (REPRO_DECIDE_PROFILE=1)
# ---------------------------------------------------------------------------

_PROFILE_STAGES = ("row_build", "dp_sweep", "backtrack", "placement")
_profile_acc = {k: 0.0 for k in _PROFILE_STAGES}
_profile_acc["decisions"] = 0.0


def _profiling() -> bool:
    """``REPRO_DECIDE_PROFILE``, re-read per launch so a caller (the
    ``cluster_sim --profile`` CLI) may set it after this module is
    imported."""
    return os.environ.get("REPRO_DECIDE_PROFILE", "") not in ("", "0")


def _sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decide_profile_reset() -> None:
    for k in _profile_acc:
        _profile_acc[k] = 0.0


def decide_profile_snapshot() -> dict:
    """The tiled route's decision wall clock per stage since the last
    reset, in seconds, and the lanes decided (``decisions``).

    Stages: ``row_build`` (the COST rows built inside a core run),
    ``dp_sweep`` (the min-plus tiles and the early-exit loop),
    ``backtrack`` (split recovery of an accept) and ``placement`` (its
    greedy fills).  The row/DP split re-runs each core launch with every
    visited tile served from the row cache the first run just refreshed
    (its outputs are discarded): that run is DP only, so ``row_build =
    total - dp_only``.  Each stage's clock starts and ends on a device
    synchronisation.  A diagnostic mode: it roughly doubles a decision's
    latency and launches each visited tile's kernel twice, and leaves
    the decisions unchanged."""
    return dict(_profile_acc)


def _max_lanes() -> int:
    """Lanes per tiled launch, ``REPRO_BURST_LANES``: 1 unless set, the
    reference's default off the TPU.  Read per launch group, so a caller
    may change it between runs."""
    return max(1, int(os.environ.get("REPRO_BURST_LANES", "1")))


def _prefix_sums(scap: torch.Tensor, scost: torch.Tensor):
    """``(ccap, ccost)``: prefix sums of ``scap`` and ``scap * scost``
    along the server axis (the last), added strictly left to right on
    both devices, in one scan.  The CPU's ``cumsum`` is a sequential loop
    along any axis; CUDA's is a tree scan along the innermost axis
    (another rounding) and a sequential loop per column along an outer
    one, so the pair is stacked innermost and the scan runs along the
    servers, an outer axis.  In float32 the CPU's ``cumsum`` accumulates
    in float64 and rounds each sum, CUDA's in float32, so a float32 pair
    is summed in float64 on both devices, as the CPU does.  ``ccap`` is
    contiguous (``searchsorted`` reads it), ``ccost`` a view."""
    both = torch.stack([scap, scap * scost], dim=-1)
    if both.dtype != torch.float64:
        both = torch.cumsum(both.to(torch.float64), dim=-2).to(both.dtype)
    else:
        both = torch.cumsum(both, dim=-2)
    return both[..., 0].contiguous(), both[..., 1]


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
    ccap, ccost = _prefix_sums(scap, scost)
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


def _decide_core(sd, pr, jd, d1: int):
    """One Alg. 2 decision over the whole horizon.

    sd: state tensors (g (T,H,R), v (T,K,R), wcaps (H,R), scaps (K,R),
        U1 (R,), U2 (R,), L1 (), L2 ()) on one device
    pr: the state's price tables (p (T,H,R), q (T,K,R), pmin) there
    jd: job arrays (resbw (2R+2,) = [wres, sres, wbw, psbw] and WZ (2, M)
        int32 on that device; u (T,) float64 host; meta = (a, nchunks,
        workload) ints)
    d1: DP columns (padded D_total + 1).

    Returns host values (best_t (-1 = reject), total_cost, d_left —
    workload still unassigned after the backtrack, 0 for any sound accept
    —, d_slots (T,), y (T, H) int32, z (T, K) int32); d_slots, y and z are
    None for a reject.
    """
    g, v, wcaps, scaps = sd[:4]
    p, q = pr[0], pr[1]
    resbw, WZ, u, meta = jd
    wres, sres = resbw[:R], resbw[R:2 * R]
    wbw, psbw = resbw[2 * R], resbw[2 * R + 1]
    W, Z = WZ[0], WZ[1]
    a, nchunks, d_tot = meta
    T = g.shape[0]
    M = W.shape[0]
    dt = g.dtype
    dev = g.device

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
    eps = costD.dtype.type(_PAY_EPS)
    best_payoff, best_t = costD.dtype.type(0.0), -1
    for t in np.flatnonzero(np.isfinite(costD[a:])) + a:
        pt = u[t] - costD[t]
        if pt > best_payoff + eps:
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
# Tiled early-exit route: the padded state
# ---------------------------------------------------------------------------

def _pad_tiles(T: int) -> int:
    return ((T + TILE - 1) // TILE) * TILE


def _pad_state(sd, pr, T_pad: int):
    """Tile-padded allocations, price tables and live-floor price ``pmin``
    (T_pad, R): the residency's T slots, then slots of no allocation,
    priced exactly ``L`` (``L * exp(0 * log r)``, and ``exp(+0) == 1``
    exactly)."""
    g, v, _, _, _, _, L1, L2 = sd
    p, q, pmin = pr
    n = T_pad - g.shape[0]
    return (torch.cat([g, g.new_zeros((n,) + g.shape[1:])]),
            torch.cat([v, v.new_zeros((n,) + v.shape[1:])]),
            torch.cat([pmin, L1.expand((n,) + pmin.shape[1:])]),
            torch.cat([p, L1.expand((n,) + p.shape[1:])]),
            torch.cat([q, L2.expand((n,) + q.shape[1:])]))


_pad_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _padded_state(state: PriceState, dtype: torch.dtype, T_pad: int):
    """``state.device_state`` extended with ``_pad_state``'s tables,
    computed once per (state version, residency, T_pad, dtype) and reused
    by every decision until the next commit or release, then re-padded in
    full.  The reference patches the padded state over the dirty spans
    (``_pad_patch``) because a re-pad costs it a compiled dispatch; here
    both are a handful of copies of the resident tables, so the port
    re-pads (and counts ``decide.pad_full`` where the reference counts
    ``decide.pad_patch`` or ``decide.pad_full``).  Returns ``((g, v,
    wcaps, scaps, U1, U2, L1, L2, pmin, p, q) on the device, pmin on the
    host)``."""
    sd = state.device_state(dtype)
    hit = _pad_cache.get(state)
    key = (state.version, T_pad, dtype)
    if hit is not None and hit[0] == key and hit[1] is sd[0]:
        if _obs.ENABLED:
            _obs.inc("decide.pad_hit")
        return hit[2]
    if _obs.ENABLED:
        _obs.inc("decide.pad_full")
    g, v, pmin, p, q = _pad_state(sd, state.device_prices(dtype), T_pad)
    out = ((g, v) + tuple(sd[2:]) + (pmin, p, q), pmin.cpu().numpy())
    _pad_cache[state] = (key, sd[0], out)
    return out


# ---------------------------------------------------------------------------
# Tiled route: lane arrays and COST rows
# ---------------------------------------------------------------------------

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


def _job_arrays_tiled(job: Job, T: int, T_pad: int, m_pad: int):
    """One lane's host arrays: ``resbw`` (2R+2,) = [wres, sres, wbw,
    psbw], ``WZ`` (2, m_pad) int32 (padded d entries get the infeasible
    worker count ``_W_PAD``), the utility curve ``u`` (T_pad,), its suffix
    maximum ``usmax``, ``meta`` = (a, nchunks, d_tot, dcap) and ``lb``,
    the cost-floor base.  Also returns the workload tables (W, Z)."""
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
    return (resbw, WZ, u, usmax, meta, _cost_lower_bound(W)), (W, Z)


class _Lanes(NamedTuple):
    """A launch's lanes (B jobs of one shape bucket): on the device the
    demand ``resbw`` (B, 2R+2), the worker counts ``Wf`` (B, M) and PS
    targets ``deploy`` (B, M) = min(Z, W) as floats, ``feas_n`` (B, 1, M)
    (W(d) <= nchunks) and ``dead`` (B, T_pad) (before the lane's arrival
    or past the horizon: identity rows); on the host ``resbw_h``, ``u``,
    ``usmax`` (B, T_pad), ``meta`` (B, 4) and ``lb`` (B,)."""
    resbw: torch.Tensor
    Wf: torch.Tensor
    deploy: torch.Tensor
    feas_n: torch.Tensor
    dead: torch.Tensor
    resbw_h: np.ndarray
    u: np.ndarray
    usmax: np.ndarray
    meta: np.ndarray
    lb: np.ndarray


def _stack_lanes(lanes, T: int, dtype: torch.dtype, device: torch.device
                 ) -> _Lanes:
    """``_job_arrays_tiled`` lanes stacked into one launch's arrays; the
    utility curves and floor bases in the launch's dtype, as the
    reference casts them."""
    resbw, WZ, u, usmax, meta, lb = (np.stack(c) for c in zip(*lanes))
    ndt = _np_dtype(dtype)
    W, Z = WZ[:, 0].astype(np.int64), WZ[:, 1].astype(np.int64)
    ts = np.arange(u.shape[1])
    dead = (ts[None, :] < meta[:, :1]) | (ts >= T)[None, :]

    def dev(x, dt=dtype):
        return torch.tensor(x, dtype=dt, device=device)
    return _Lanes(dev(resbw), dev(W), dev(np.minimum(Z, W)),
                  dev((W <= meta[:, 1:2])[:, None, :], torch.bool),
                  dev(dead, torch.bool), resbw, u.astype(ndt),
                  usmax.astype(ndt), meta, lb.astype(ndt))


def _prefix_tables_b(prices: torch.Tensor, headroom: torch.Tensor,
                     demand: torch.Tensor):
    """Lane-batched prefix tables over n slots.

    prices/headroom: (n, S, R) shared across lanes; demand: (B, R).
    Returns (scost, ccap, ccost), each (B, n, S).  The unit price is
    summed over resources left to right, the sort is stable and the
    prefix sums run left to right, as in ``_prefix_tables``: every slot's
    tables are a function of its own row alone, so any slot range gives
    the same bits for its slots."""
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
    return (scost,) + _prefix_sums(scap, scost)


def _greedy_cost_b(ccap: torch.Tensor, ccost: torch.Tensor,
                   scost: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Lane-batched greedy cost: (B, n, S) tables, (B, n, M) counts; +inf
    where the counts exceed capacity."""
    S = ccap.shape[2]
    idx = torch.searchsorted(ccap.contiguous(), counts.contiguous(),
                             side="left")
    zcol = ccap.new_zeros(ccap.shape[:2] + (1,))
    prev_cap = torch.gather(torch.cat([zcol, ccap], -1), -1, idx)
    prev_cost = torch.gather(torch.cat([zcol, ccost], -1), -1, idx)
    marg = torch.gather(scost, -1, torch.clamp(idx, max=S - 1))
    vals = prev_cost + (counts - prev_cap) * marg
    return torch.where(counts == 0, 0.0,
                       torch.where(counts <= ccap[..., -1:], vals,
                                   float("inf")))


def _tile_rows(psd, jd: _Lanes, t0: int) -> torch.Tensor:
    """COST_t rows of slots [t0, t0 + TILE) for every lane, (B, TILE, M):
    the reference's ``rows_for_tile``, its prefix tables built from slices
    of the version-cached price tables.  The reference can also slice them
    from per-job sorted tables over the whole horizon (its order cache,
    ``use_tabs``), which saves it a dispatch per tile under XLA; a torch
    slice costs no device work, and on the card that cache made the paper
    scale run slower, so the port builds inline only.  A lane's dead slots
    get the identity row ``[0, inf, ...]``."""
    g, v, wcaps, scaps = psd[:4]
    t1 = t0 + TILE
    w_scost, w_ccap, w_ccost = _prefix_tables_b(
        psd[9][t0:t1], wcaps[None] - g[t0:t1], jd.resbw[:, :R])
    s_scost, s_ccap, s_ccost = _prefix_tables_b(
        psd[10][t0:t1], scaps[None] - v[t0:t1], jd.resbw[:, R:2 * R])
    B, M = jd.Wf.shape
    wbw, psbw = jd.resbw[:, 2 * R], jd.resbw[:, 2 * R + 1]
    Wt = jd.Wf[:, None, :].expand(B, TILE, M)
    w_costs = _greedy_cost_b(w_ccap, w_ccost, w_scost, Wt)
    pool = s_ccap[..., -1:]                               # (B, TILE, 1)
    deploy = torch.minimum(jd.deploy[:, None, :], pool)
    feas_ps = deploy * psbw[:, None, None] >= Wt * wbw[:, None, None] - 1e-9
    z_costs = _greedy_cost_b(s_ccap, s_ccost, s_scost, deploy)
    rows = torch.where(jd.feas_n & feas_ps, w_costs + z_costs, float("inf"))
    rows[..., 0] = 0.0
    # pre-arrival and beyond-horizon slots carry the DP unchanged
    rows[..., 1:].masked_fill_(jd.dead[:, t0:t1, None], float("inf"))
    return rows


# ---------------------------------------------------------------------------
# Tiled route: the row cache and the core
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RowCache:
    """One job's COST rows across price-state versions.

    ``rows`` holds the (T_pad, m_pad) COST_t table the core computed at
    ``version``; ``valid`` marks which ``TILE``-slot tiles of it were both
    visited (computed, not the identity placeholder) and are fresh (no
    commit or release moved prices inside them since).  The core
    recomputes exactly the tiles not valid for every lane of a launch;
    :meth:`sync` invalidates against the price state's dirty-slot log."""
    rows: Optional[torch.Tensor]
    valid: np.ndarray
    version: int
    m_pad: int
    d1: int

    @classmethod
    def empty(cls, state: PriceState, job: Job) -> Optional["RowCache"]:
        """A cache with no valid tiles (the first decision fills it);
        None for a dcap-0 job (rejected without solving)."""
        key = _shape_bucket(job)
        if key is None:
            return None
        m_pad, d1 = key
        n_tiles = _pad_tiles(state.horizon) // TILE
        return cls(rows=None, valid=np.zeros(n_tiles, bool),
                   version=state.version, m_pad=m_pad, d1=d1)

    def invalidate_spans(self, spans) -> None:
        """Mark every tile overlapping a dirtied [t0, t1) span stale."""
        for t0, t1 in spans:
            k0 = max(int(t0) // TILE, 0)
            k1 = min((int(t1) - 1) // TILE + 1, len(self.valid))
            self.valid[k0:k1] = False

    def invalidate_all(self) -> None:
        self.valid[:] = False

    def sync(self, state: PriceState) -> "RowCache":
        """Invalidate whatever ``state`` dirtied since ``version`` (all of
        it when the delta is unknowable).  Returns self."""
        if state.version != self.version:
            spans = state.dirty_spans_since(self.version)
            if spans is None:
                self.invalidate_all()
                if _obs.ENABLED:
                    _obs.inc("decide.row_cache_full_invalidations")
            else:
                self.invalidate_spans(spans)
            self.version = state.version
            if _obs.ENABLED:
                _obs.inc("decide.row_cache_syncs")
        return self


def _live_floor(pmin_h: np.ndarray, jd: _Lanes, b: int, T: int):
    """Lane ``b``'s early-exit cost floor: the base ``lb`` times the
    cheapest spread of the workload over feasible slots (at most ``dcap``
    chunk-passes per slot, each slot at its live per-worker price floor).
    A valid lower bound on every schedule's cost (the reference's
    ``:480-519``), in the padded state's dtype, as the reference computes
    it in the lane dtype."""
    dt = pmin_h.dtype.type
    resbw_h, lb = jd.resbw_h[b].astype(dt), dt(jd.lb[b])
    a, _, d_tot, dcap = (int(x) for x in jd.meta[b])
    T_pad = pmin_h.shape[0]
    wslot = pmin_h[:, 0] * resbw_h[0]                 # summed left to right
    for r in range(1, R):
        wslot = wslot + pmin_h[:, r] * resbw_h[r]
    ts = np.arange(T_pad)
    wsort = np.sort(np.where((ts >= a) & (ts < T), wslot, dt(np.inf)))
    dcap_f = dt(max(dcap, 1))
    take = np.clip(dt(d_tot) - ts.astype(dt) * dcap_f, dt(0.0), dcap_f)
    floor_sum = np.sum(take * np.where(np.isfinite(wsort), wsort, dt(0.0)))
    return lb * floor_sum if lb > 0 else dt(0.0)


class _CoreOut(NamedTuple):
    best_t: np.ndarray       # (B,) int, -1 = reject
    payoff: np.ndarray       # (B,)
    rows: torch.Tensor       # (B, T_pad, M): the refreshed row caches
    cost: torch.Tensor       # (B, T_pad, d1): the visited slots' columns
    k0: int                  # visited tiles [k0, k_end)
    k_end: int
    paths: List[int]         # tiles per branch [dnc, plateau, chain]
    live: List[int]          # slots stepped per branch (one launch a tile)
    cached: int              # tiles served from the row caches


def _decide_tiled_core(psd, jd: _Lanes, *, T: int, d1: int, mono: int,
                       rows_init: Optional[torch.Tensor] = None,
                       valid_tiles: Optional[np.ndarray] = None) -> _CoreOut:
    """The reference's ``_decide_tiled_core`` for a batch of lanes:
    Alg. 2 over the horizon in ``TILE``-slot tiles from the earliest
    arrival tile, with the exact early exit (module docstring).

    psd: ``_padded_state`` — device tensors (g, v (T_pad, S, R), wcaps,
        scaps, U1, U2, L1, L2, pmin (T_pad, R), p, q) and pmin on the host
    jd: ``_stack_lanes``
    T: the real horizon; d1: DP columns (padded D_total + 1)
    mono: 0 = chain only, 1 = plateau or chain, 2 = also the convex D&C
        (``REPRO_MONOTONE_DNC``); levels > 0 one lane only.  Chosen once
        per tile, from gates read on the host in one copy: at level 2 the
        D&C when every row of the tile is free of NaN/-inf and certified
        convex, else (levels 1 and 2) the plateau when every row is free
        of NaN/-inf and has at most ``r_max = max(16, M // 4)`` runs, else
        the chain.  Every branch gives the chain's columns bit for bit.
    rows_init/valid_tiles: the lanes' row caches, (B, T_pad, M) rows and
        a (B, n_tiles) validity mask; a tile is served from them when it
        is valid for EVERY lane, else recomputed for all.  The DP steps
        every visited tile from the carry either way."""
    sdev, pmin_h = psd
    B, T_pad = jd.u.shape
    n_tiles = T_pad // TILE
    M = jd.Wf.shape[1]
    g = sdev[0]
    dt, dev = g.dtype, g.device
    a = jd.meta[:, 0]
    a_min = int(a.min())
    if mono and B != 1:
        raise ValueError("the monotone dispatch is single-lane only")
    r_max = max(16, M // 4)
    ndt = _np_dtype(dt)
    eps = ndt(_PAY_EPS)
    lb = np.array([_live_floor(pmin_h, jd, b, T) for b in range(B)], ndt)
    d_idx = torch.as_tensor(jd.meta[:, 2], device=dev)

    if rows_init is not None:
        rows_buf = rows_init.clone()
    else:
        rows_buf = torch.full((B, T_pad, M), float("inf"), dtype=dt,
                              device=dev)
        rows_buf[..., 0] = 0.0
    cost_buf = torch.empty((B, T_pad, d1), dtype=dt, device=dev)
    prev = torch.full((B, d1), float("inf"), dtype=dt, device=dev)
    prev[:, 0] = 0.0
    best = np.zeros(B, ndt)
    best_t = np.full(B, -1)
    paths = [0, 0, 0]
    live = [0, 0, 0]
    cached = 0
    k0 = k = a_min // TILE
    while k < n_tiles and np.any(
            jd.usmax[:, min(k * TILE, T_pad - 1)] > best + eps + lb):
        t0 = k * TILE
        if valid_tiles is not None and valid_tiles[:, k].all():
            rows = rows_buf[:, t0:t0 + TILE]
            cached += 1
        else:
            rows = _tile_rows(sdev, jd, t0)
            rows_buf[:, t0:t0 + TILE] = rows
        branch = PATH_CHAIN
        if mono:
            clean = ((rows == rows) & (rows > float("-inf"))).all()
            if mono >= 2:
                convex, plat = torch.stack([
                    clean & convex_certificate(rows[0]).all(),
                    clean & (run_count(rows[0]) <= r_max).all()]).tolist()
                branch = (PATH_DNC if convex else
                          PATH_PLATEAU if plat else PATH_CHAIN)
            elif bool(clean & (run_count(rows[0]) <= r_max).all()):
                branch = PATH_PLATEAU
        paths[branch] += 1
        lo, hi = max(a_min, t0), min(T, t0 + TILE)
        if hi > lo:
            if branch == PATH_PLATEAU:
                minplus_plateau_tile(rows[0, lo - t0:hi - t0], prev[0],
                                     cost_buf[0, lo:hi], r_max)
            elif branch == PATH_DNC:
                minplus_dnc_tile(rows[0, lo - t0:hi - t0], prev[0],
                                 cost_buf[0, lo:hi])
            else:
                minplus_chain(rows[:, lo - t0:hi - t0], prev,
                              cost_buf[:, lo:hi])
            prev = cost_buf[:, hi - 1]
            live[branch] += hi - lo
            cost_d = torch.gather(
                cost_buf[:, lo:hi], 2,
                d_idx[:, None, None].expand(B, hi - lo, 1)).cpu().numpy()
            for b in range(B):
                for t in range(max(lo, int(a[b])), hi):
                    c = cost_d[b, t - lo, 0]
                    pay = jd.u[b, t] - c if np.isfinite(c) else -np.inf
                    if pay > best[b] + eps:
                        best[b], best_t[b] = pay, t
        k += 1
    return _CoreOut(best_t, best, rows_buf, cost_buf, k0, k, paths, live,
                    cached)


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
    0).  The band is computed in the tables' dtype, as the reference's:
    in float32 ``1 + _SPLIT_TOL`` rounds to 1 and the band is the exact
    minimum.  Returns (d_left, d_slots (best_t + 1,))."""
    M = rows_h.shape[1]
    init = np.full(d_tot + 1, np.inf, cost_h.dtype)
    init[0] = 0.0
    tol = cost_h.dtype.type(1.0 + _SPLIT_TOL)
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
        band = vals <= vals.min() * tol
        d_here = int(np.argmax(band))
        d_slots[t] = d_here
        d_rem -= d_here
    return d_rem, d_slots


def _place_slots(sd, pr, resbw: torch.Tensor, Wc: torch.Tensor,
                 Zc: torch.Tensor, ts: torch.Tensor):
    """Greedy placements (y (n, H'), z (n, K') int32) of the per-slot
    worker and PS-target counts ``Wc``/``Zc`` at the slots ``ts`` — the
    whole route's fills, at the resident prices of just those slots (each
    slot's fill reads only its own state column)."""
    g, v, wcaps, scaps = sd[:4]
    g_w, v_w = g[ts], v[ts]
    w_order, w_scap, _, w_ccap, _ = _prefix_tables(
        pr[0][ts], wcaps[None] - g_w, resbw[:R])
    s_order, s_scap, _, s_ccap, _ = _prefix_tables(
        pr[1][ts], scaps[None] - v_w, resbw[R:2 * R])
    y = _greedy_place(w_order, w_scap, w_ccap, Wc)
    deploy = torch.minimum(torch.minimum(Zc, Wc), s_ccap[:, -1])
    z = _greedy_place(s_order, s_scap, s_ccap, deploy)
    return y, z


@dataclasses.dataclass
class _Pending:
    """A decided but not yet placed candidate of the tiled core: the
    launch's row and cost tables (shared by its lanes) stay on the device
    until ``_materialize`` runs the backtrack and the placement, for an
    accept that survives the commit pass only.  Dropping the burst's
    candidates frees the tables."""
    job: Job
    best_t: int
    payoff: float
    rows_full: torch.Tensor         # (B, T_pad, M)
    cost_full: torch.Tensor         # (B, T_pad, d1)
    lane: int
    W: np.ndarray                   # (dcap+1,) workload tables
    Z: np.ndarray
    cache: RowCache


def _materialize(pend: _Pending, state: PriceState) -> Optional[Schedule]:
    """The accepted schedule of a tiled decision (None = reject): the
    banded backtrack and the placement of the deploying slots, in the
    decision's dtype.  Must run at the price state the decision was made
    at."""
    job, best_t = pend.job, pend.best_t
    if best_t < 0:
        return None
    a, d_tot = job.arrival, job.workload
    profiling = _profiling()
    if profiling:
        _sync(pend.rows_full.device)
        t_bt = time.perf_counter()
    with (_obs.span("decide.backtrack", jid=job.jid) if _obs.ENABLED
          else _obs.NULL_SPAN):
        rows_h = pend.rows_full[pend.lane, a:best_t + 1].cpu().numpy()
        cost_h = pend.cost_full[pend.lane, a:best_t + 1, :d_tot + 1].cpu() \
            .numpy()
        cost = float(cost_h[-1, d_tot])
        d_left, d_slots = _backtrack(rows_h, cost_h[:-1], a, best_t, d_tot)
    if profiling:
        _profile_acc["backtrack"] += time.perf_counter() - t_bt
    if d_left != 0:
        raise RuntimeError(
            f"backtrack failed: {d_left} chunk-passes unassigned")
    utility = job.utility(best_t - a)
    ts_active = np.nonzero(d_slots[a:])[0] + a
    workers, ps = {}, {}
    if len(ts_active):
        if profiling:
            t_pl = time.perf_counter()
        with (_obs.span("decide.placement", jid=job.jid,
                        slots=len(ts_active)) if _obs.ENABLED
              else _obs.NULL_SPAN):
            sd = state.device_state(pend.rows_full.dtype)
            pr = state.device_prices(pend.rows_full.dtype)
            dt, dev = sd[0].dtype, sd[0].device
            d_act = d_slots[ts_active]
            resbw = np.concatenate([job.worker_res, job.ps_res,
                                    [job.worker_bw, job.ps_bw]])
            y, z = _place_slots(
                sd, pr, torch.tensor(resbw, dtype=dt, device=dev),
                torch.tensor(pend.W[d_act], dtype=dt, device=dev),
                torch.tensor(pend.Z[d_act], dtype=dt, device=dev),
                torch.as_tensor(ts_active, device=dev))
            y, z = y.cpu().numpy(), z.cpu().numpy()
        if profiling:
            _profile_acc["placement"] += time.perf_counter() - t_pl
        H, K = state.cluster.H, state.cluster.K
        for i, t in enumerate(ts_active):
            workers[int(t)] = y[i, :H].astype(np.int64)
            ps[int(t)] = z[i, :K].astype(np.int64)
    return Schedule(jid=job.jid, workers=workers, ps=ps, finish=int(best_t),
                    cost=cost, payoff=utility - cost, utility=utility)


# tiles per branch, live slots stepped (all, and those of plateau tiles),
# decisions of the tiled route (lanes decided: speculative ones of
# decide_burst and re-solves through a row cache among them), core runs
# and tiles served from the row caches, since the last reset (the
# reference's monotone fallback counters plus the route's own)
_monotone_counters = {"dnc": 0, "plateau": 0, "chain": 0, "slots": 0,
                      "plateau_slots": 0, "dnc_slots": 0, "decisions": 0,
                      "speculative": 0, "resolves": 0, "launches": 0,
                      "cache_tiles": 0}


def monotone_counters_reset() -> None:
    for k in _monotone_counters:
        _monotone_counters[k] = 0


def monotone_counters_snapshot() -> dict:
    """The tiled route's counts since the last reset: tiles per min-plus
    branch, ``dnc`` (0 unless ``REPRO_MONOTONE_DNC`` is set),
    ``plateau``, ``chain``; ``slots``, the live slots stepped, and
    ``plateau_slots`` and ``dnc_slots``, those of plateau and D&C tiles;
    ``decisions``, the lanes the core decided, of which ``speculative``
    in ``decide_burst`` and ``resolves`` through a row cache;
    ``launches``, the core's runs (one per group of at most
    ``REPRO_BURST_LANES`` lanes), and ``cache_tiles``, the visited tiles
    served from the row caches.  On the card each D&C tile with live
    slots is one D&C-kernel launch, each plateau tile one plateau-kernel
    launch and each chain tile one sweep-kernel launch, whatever the
    lanes."""
    return dict(_monotone_counters)


def _decide_jobs(jobs: Sequence[Tuple[int, Job]], state: PriceState,
                 m_pad: int, d1: int,
                 caches: Optional[Dict[int, RowCache]] = None,
                 dtype: torch.dtype = DEFAULT_DTYPE) -> List[_Pending]:
    """The tiled core over one shape bucket's jobs in ``dtype``, at most
    ``_max_lanes()`` lanes a launch.  ``caches``: {index: RowCache}
    serving the lanes (a cache of another dtype serves nothing).  Returns
    a ``_Pending`` per job, with its refreshed cache.  Nothing here is
    compiled per shape, so the reference's padding lanes
    (``_reject_lane``), its device-cached empty row cache
    (``_empty_cache``) and its record of compiled launch shapes
    (``_launch_keys_seen``), all there for XLA's compilation, have no
    counterpart."""
    T = state.horizon
    T_pad = _pad_tiles(T)
    n_tiles = T_pad // TILE
    psd = _padded_state(state, dtype, T_pad)
    out: List[_Pending] = []
    lanes_max = _max_lanes()
    for c0 in range(0, len(jobs), lanes_max):
        chunk = jobs[c0:c0 + lanes_max]
        B = len(chunk)
        arrays = [_job_arrays_tiled(j, T, T_pad, m_pad) for _, j in chunk]
        jd = _stack_lanes([la for la, _ in arrays], T, dtype, state.device)
        cached = [caches.get(i) if caches else None for i, _ in chunk]
        cached = [c if c is None or c.rows is None or c.rows.dtype == dtype
                  else None for c in cached]
        rows_init = valid = None
        if any(c is not None for c in cached):
            valid = np.zeros((B, n_tiles), bool)
            for bi, c in enumerate(cached):
                if c is not None and c.rows is not None:
                    valid[bi] = c.valid
            # launches without a row cache stay out of these: the hit rate
            # measures what the cache saved a re-solve
            if _obs.ENABLED:
                _obs.inc("decide.cache_tiles_valid", int(valid.sum()))
                _obs.inc("decide.cache_tiles_total", B * n_tiles)
            if valid.any():
                ident = torch.full((T_pad, m_pad), float("inf"), dtype=dtype,
                                   device=state.device)
                ident[:, 0] = 0.0
                rows_init = torch.stack([
                    c.rows if c is not None and c.rows is not None
                    else ident for c in cached])
            else:
                valid = None
        mono = 0
        if B == 1 and m_pad <= MONO_BAND:
            mono = 2 if _mono_dnc() else 1
        profiling = _profiling()
        if profiling:
            _sync(state.device)
            t_launch = time.perf_counter()
        dp_span = (_obs.span("decide.dp_sweep", lanes=B, T_pad=T_pad,
                             m_pad=m_pad) if _obs.ENABLED
                   else _obs.NULL_SPAN)
        with dp_span:
            # the core reads each tile's payoff column back to the host,
            # so the span closes on work the card has finished
            res = _decide_tiled_core(psd, jd, T=T, d1=d1, mono=mono,
                                     rows_init=rows_init, valid_tiles=valid)
            if _obs.ENABLED:
                dp_span.set(tiles_visited=res.k_end - res.k0,
                            n_tiles=n_tiles)
        if profiling:
            _sync(state.device)
            total = time.perf_counter() - t_launch
            # DP-only re-run: every tile served from the rows the first run
            # just refreshed (copied, never written back; its outputs are
            # dropped).  It visits the same tiles from the same carries,
            # so the difference is the row build
            t_dp = time.perf_counter()
            _decide_tiled_core(psd, jd, T=T, d1=d1, mono=mono,
                               rows_init=res.rows,
                               valid_tiles=np.ones((B, n_tiles), bool))
            _sync(state.device)
            dp_only = time.perf_counter() - t_dp
            _profile_acc["dp_sweep"] += dp_only
            _profile_acc["row_build"] += max(total - dp_only, 0.0)
            _profile_acc["decisions"] += B
        if _obs.ENABLED:
            visited = res.k_end - res.k0
            _obs.inc("decide.launches")
            _obs.inc("decide.tiles_visited", visited)
            _obs.inc("decide.tiles_horizon", n_tiles)
            _obs.observe("decide.early_exit_frac",
                         visited / max(n_tiles, 1))
        for key, n in zip(("dnc", "plateau", "chain"), res.paths):
            _monotone_counters[key] += n
        _monotone_counters["slots"] += sum(res.live)
        _monotone_counters["plateau_slots"] += res.live[PATH_PLATEAU]
        _monotone_counters["dnc_slots"] += res.live[PATH_DNC]
        _monotone_counters["decisions"] += B
        _monotone_counters["launches"] += 1
        _monotone_counters["cache_tiles"] += res.cached
        for bi, (i, job) in enumerate(chunk):
            v = np.zeros(n_tiles, bool)
            if cached[bi] is not None:
                v |= cached[bi].valid
            v[res.k0:res.k_end] = True
            cache = RowCache(rows=res.rows[bi], valid=v,
                             version=state.version, m_pad=m_pad, d1=d1)
            out.append(_Pending(
                job=job, best_t=int(res.best_t[bi]),
                payoff=float(res.payoff[bi]), rows_full=res.rows,
                cost_full=res.cost, lane=bi, W=arrays[bi][1][0],
                Z=arrays[bi][1][1], cache=cache))
    return out


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
                        core: str = "whole", precision: str = "auto",
                        row_cache: Optional[RowCache] = None
                        ) -> Optional[Schedule]:
    """Alg. 2 for one job at the state's current prices, on the state's
    device; None = reject.

    ``core="whole"``: the whole-horizon route, one DP-sweep launch on the
    card.  ``core="tiled"``: the tiled early-exit route, one kernel launch
    per tile it visits with live slots: the sweep kernel for a chain tile,
    the plateau kernel for a plateau tile, the D&C kernel for a D&C tile
    (module docstring).  ``precision``: the route's dtype
    (:func:`route_dtype`; ``"x32"`` is float32, the reference's TPU
    precision).  ``row_cache`` (tiled only): the job's cache from an
    earlier decision, ``sync``-ed against the state; the core recomputes
    only its stale tiles and writes the cache back (a re-solve)."""
    if core not in CORES:
        raise ValueError(f"core must be one of {CORES}, not {core!r}")
    dtype = route_dtype(precision)
    if row_cache is not None and core != "tiled":
        raise ValueError("a row cache serves the tiled route only")
    key = _shape_bucket(job)
    if key is None:
        return None
    m_pad, d1 = key
    if core == "tiled":
        caches = {0: row_cache} if row_cache is not None else None
        pend = _decide_jobs([(0, job)], state, m_pad, d1, caches=caches,
                            dtype=dtype)[0]
        if row_cache is not None:
            _monotone_counters["resolves"] += 1
            for f in ("rows", "valid", "version"):
                setattr(row_cache, f, getattr(pend.cache, f))
        return _materialize(pend, state)
    sd = state.device_state(dtype)
    pr = state.device_prices(dtype)
    jd = _job_arrays(job, state.horizon, m_pad, dtype, state.device)
    best_t, cost, d_left, d_slots, y, z = _decide_core(sd, pr, jd, d1)
    return _schedule_from_outputs(job, state, best_t, cost, d_left,
                                  d_slots, y, z)


def decide_burst(jobs: Sequence[Job], state: PriceState, *,
                 precision: str = "auto",
                 timings: Optional[List[float]] = None
                 ) -> List[Optional[_Pending]]:
    """Speculative batched Alg. 2 on the tiled route: the whole burst
    decided at the CURRENT prices in ``precision``'s dtype, one launch
    group per shape bucket (a small job is never padded up to the burst's
    largest table).  Returns a ``_Pending`` per job in input order (None
    for dcap-0 jobs): decision and row cache, with the backtrack and the
    placement deferred to ``_materialize``.  Committing and re-solving
    are the caller's (``OASiS.on_arrivals``).  ``timings``, when given,
    is filled with each job's share of its group's wall time."""
    dtype = route_dtype(precision)
    out: List[Optional[_Pending]] = [None] * len(jobs)
    if timings is not None:
        timings[:] = [0.0] * len(jobs)
    groups: Dict[Tuple[int, int], list] = {}
    for i, j in enumerate(jobs):
        key = _shape_bucket(j)
        if key is not None:
            groups.setdefault(key, []).append((i, j))
    for (m_pad, d1), live in groups.items():
        t0 = time.perf_counter()
        pends = _decide_jobs(live, state, m_pad, d1, dtype=dtype)
        _monotone_counters["speculative"] += len(live)
        for (i, _), pend in zip(live, pends):
            out[i] = pend
        if timings is not None:
            share = (time.perf_counter() - t0) / len(live)
            for i, _ in live:
                timings[i] = share
    return out


def best_schedule_fused_batch(jobs: Sequence[Job], state: PriceState, *,
                              precision: str = "auto",
                              timings: Optional[List[float]] = None
                              ) -> List[Optional[Schedule]]:
    """Speculative batched Alg. 2 with every accepted candidate's
    placement materialized, all at the CURRENT prices: ``decide_burst``,
    then ``_materialize`` per job (the caller must not commit between the
    call and using the results)."""
    return [None if pend is None else _materialize(pend, state)
            for pend in decide_burst(jobs, state, precision=precision,
                                     timings=timings)]
