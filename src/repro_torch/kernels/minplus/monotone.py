"""Structure-aware min-plus slots: the run-compressed (plateau) step,
the convex divide-and-conquer step with its exact certificate, the
dispatcher over them, and the path codes.

The counterpart of the reference's ``kernels/minplus/monotone.py``.
Every branch returns the chain's value (``tiled.minplus_chain_step``) bit
for bit on the rows it accepts:

* **Plateau.**  Real COST_t rows of Alg. 2 are staircases: they compress
  into few runs of bitwise-equal values.  Within a run ``row[j]`` is one
  constant ``c``, so ``min_{j in run} fl(c + prev[d-j]) == fl(c +
  min_{j in run} prev[d-j])`` by monotonicity of rounding, and the window
  minimum comes from a power-of-two doubling table of the padded carry:
  two contiguous slices per run.  Exact for any row free of NaN and -inf.
* **Convex divide and conquer.**  When ``row`` is convex the candidate
  matrix ``A[d][i] = prev[i] + row[d - i]`` is a banded Monge matrix, so
  its leftmost argmin per row is nondecreasing in ``d`` and the row
  minima take O((D + DC) log D) candidates by level-synchronous divide
  and conquer (:func:`monotone_dnc_step`).  It is sound only when the
  real-arithmetic values of the row are convex: :func:`convex_certificate`
  decides ``row[j] + row[j+2] - 2 row[j+1] >= 0`` exactly with TwoSum
  expansions (each an IEEE add or subtract, never contracted into a
  fused multiply-add), and a rounded argmin is bounded by the dual-split
  rule (the rightmost rounded argmin bounds the left child, the leftmost
  the right child), so every scanned range holds an exact argmin and its
  rounded minimum is the chain's.

:func:`monotone_step_with_path` dispatches a slot as the reference does:
certified-convex rows take the D&C, rows of at most ``DC+1 //
_PLATEAU_FRACTION`` runs the plateau step, everything else the chain; a
D&C candidate-buffer spill reports ``PATH_CHAIN``.  The CUDA kernel of the
D&C step (``csrc/minplus_dnc.cu``) keeps no candidate buffer and never
spills.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from .tiled import minplus_chain_step

# dispatcher path codes (the decision core's per-tile counters)
PATH_DNC = 0
PATH_PLATEAU = 1
PATH_CHAIN = 2

# the dispatcher's default run-count gate: a row of at most a third of
# its band in runs takes the plateau step (the reference's value)
_PLATEAU_FRACTION = 3


# ---------------------------------------------------------------------------
# Exact convexity certificate
# ---------------------------------------------------------------------------

def _two_sum(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth's TwoSum: ``(s, e)`` with ``s = fl(a + b)`` and ``s + e = a +
    b`` exactly, in any IEEE precision.  Each line is one eager
    elementwise op, so nothing is reassociated or contracted."""
    s = a + b
    a1 = s - b
    b1 = s - a1
    return s, (a - a1) + (b - b1)


def _nonneg_sum3(x: torch.Tensor, y: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    """Exact ``x + y + z >= 0`` for finite floats, elementwise: the
    expansion [x] grown by y then z (Shewchuk); its components do not
    overlap and the last is the largest, so the sign of the exact sum is
    that of the first nonzero one from the top.  An overflow to inf
    poisons the residuals with NaN, whose comparisons are False: the
    certificate then fails, conservatively."""
    s, e = _two_sum(x, y)
    q1, h0 = _two_sum(z, e)
    q2, h1 = _two_sum(q1, s)
    return torch.where(q2 != 0, q2 > 0,
                       torch.where(h1 != 0, h1 > 0, h0 >= 0))


def convex_certificate(row: torch.Tensor) -> torch.Tensor:
    """True (bool tensor over the leading axes) iff ``row`` (..., DC+1) is
    certifiably convex in exact arithmetic over its values: a finite
    prefix (+inf only as a suffix, no NaN or -inf anywhere) whose exact
    second differences are all nonnegative.  The soundness condition of
    :func:`monotone_dnc_step`; a rounded ``>=`` would admit ulp-level
    concavities that break the argmin's monotonicity.  On any device."""
    f = torch.isfinite(row)
    clean = ((row == row) & (row > float("-inf"))).all(dim=-1)
    suffix_ok = (f[..., :-1] | ~f[..., 1:]).all(dim=-1)
    if row.shape[-1] < 3:
        return clean & suffix_ok
    x, c, y = row[..., :-2], row[..., 1:-1], row[..., 2:]
    tri = _nonneg_sum3(x, y, -2.0 * c)
    # only triples inside the finite prefix constrain convexity (given
    # suffix_ok, a finite y makes x and c finite too)
    tri_ok = torch.where(torch.isfinite(y), tri, True).all(dim=-1)
    return clean & suffix_ok & tri_ok


def _two_sum_np(a, b):
    """Host twin of :func:`_two_sum` (the same exact arithmetic)."""
    s = a + b
    a1 = s - b
    b1 = s - a1
    return s, (a - a1) + (b - b1)


def _nonneg_sum3_np(x, y, z):
    """Host twin of :func:`_nonneg_sum3`."""
    with np.errstate(invalid="ignore"):
        s, e = _two_sum_np(x, y)
        q1, h0 = _two_sum_np(z, e)
        q2, h1 = _two_sum_np(q1, s)
    return np.where(q2 != 0, q2 > 0, np.where(h1 != 0, h1 > 0, h0 >= 0))


def convex_certificate_np(rows: np.ndarray) -> np.ndarray:
    """Host twin of :func:`convex_certificate`, over the leading axes of
    (..., DC+1) rows."""
    rows = np.asarray(rows)
    f = np.isfinite(rows)
    with np.errstate(invalid="ignore"):
        clean = np.all((rows == rows) & (rows > -np.inf), axis=-1)
    suffix_ok = np.all(f[..., 1:] <= f[..., :-1], axis=-1)
    if rows.shape[-1] < 3:
        return clean & suffix_ok
    x, c, y = rows[..., :-2], rows[..., 1:-1], rows[..., 2:]
    tri = _nonneg_sum3_np(x, y, -2.0 * c)
    tri_ok = np.all(np.where(np.isfinite(y), tri, True), axis=-1)
    return clean & suffix_ok & tri_ok


def run_count(row: torch.Tensor) -> torch.Tensor:
    """Number of maximal runs of bitwise-equal consecutive values along
    the last axis (int32)."""
    if row.shape[-1] < 2:
        return torch.ones(row.shape[:-1], dtype=torch.int32,
                          device=row.device)
    neq = row[..., 1:] != row[..., :-1]
    return (1 + neq.sum(dim=-1)).to(torch.int32)


def run_count_np(rows: np.ndarray) -> np.ndarray:
    """Host twin of :func:`run_count`."""
    rows = np.asarray(rows)
    if rows.shape[-1] < 2:
        return np.ones(rows.shape[:-1], np.int32)
    return (1 + np.sum(rows[..., 1:] != rows[..., :-1], axis=-1)).astype(
        np.int32)


def plateau_step(row: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Run-compressed min-plus slot ``new[d] = min_j row[j] + prev[d-j]``
    (cost only): bit-exact for any (DC+1,) ``row`` and (D+1,) ``prev``
    free of NaN and -inf, in their dtype.  The runs are read on the host
    (one device-to-host copy of the run starts)."""
    dc1 = row.shape[0]
    d1 = prev.shape[0]
    inf = float("inf")
    if dc1 > 1:
        cuts = torch.nonzero(row[1:] != row[:-1]).flatten() + 1
        starts = [0] + cuts.tolist()
    else:
        starts = [0]
    ends = [s - 1 for s in starts[1:]] + [dc1 - 1]

    # doubling table over the padded carry: tab[k][i] = min pad[i:i+2^k]
    width = dc1 + d1
    pad = torch.cat([torch.full((dc1,), inf, dtype=prev.dtype,
                                device=prev.device), prev])
    longest = max(e - s + 1 for s, e in zip(starts, ends))
    tabs = [pad]
    for k in range(1, longest.bit_length()):
        half = 1 << (k - 1)
        lvl = tabs[-1]
        tabs.append(torch.cat([torch.minimum(lvl[:width - half], lvl[half:]),
                               lvl.new_full((half,), inf)]))

    new = torch.full((d1,), inf, dtype=prev.dtype, device=prev.device)
    for s, e in zip(starts, ends):
        kw = (e - s + 1).bit_length() - 1
        tab = tabs[kw]
        lo = tab[dc1 - e:dc1 - e + d1]
        hi = tab[dc1 - s - (1 << kw) + 1:dc1 - s - (1 << kw) + 1 + d1]
        new = torch.minimum(new, row[s] + torch.minimum(lo, hi))
    return new


# ---------------------------------------------------------------------------
# Convex divide and conquer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dnc_levels(d1: int):
    """The static recursion over [0, d1): per level, the segments'
    midpoints (each d is a midpoint at exactly one level), each cell's
    segment at that level, and its left-of-mid and right-of-mid masks.
    Also the segments themselves, ``(s, e)`` per midpoint, the CUDA
    kernel's table."""
    segs = [(0, d1)]
    levels = []
    while segs:
        mids = []
        segid = np.zeros(d1, np.int32)
        left = np.zeros(d1, bool)
        right = np.zeros(d1, bool)
        nxt = []
        for si, (s, e) in enumerate(segs):
            mid = (s + e) // 2
            mids.append(mid)
            segid[s:mid] = si
            left[s:mid] = True
            segid[mid + 1:e] = si
            right[mid + 1:e] = True
            if s < mid:
                nxt.append((s, mid))
            if mid + 1 < e:
                nxt.append((mid + 1, e))
        levels.append((np.asarray(mids, np.int32), segid, left, right,
                       np.asarray(segs, np.int32)))
        segs = nxt
    return tuple(levels)


def monotone_dnc_step(row: torch.Tensor, prev: torch.Tensor,
                      scanned: Optional[List[int]] = None
                      ) -> Tuple[torch.Tensor, bool]:
    """Row minima of the banded Monge matrix ``A[d][i] = prev[i] + row[d -
    i]`` by level-synchronous divide and conquer: the reference's
    ``monotone_dnc_step`` op for op, run on the host in numpy (the CUDA
    kernel's oracle and its CPU path; a level is a few dozen vector ops,
    which numpy issues at a fraction of eager PyTorch's cost per op).
    Returns ``(new, overflow)``, ``new`` on ``prev``'s device; ``new``
    equals the chain bit for bit whenever ``row`` passes
    :func:`convex_certificate` and ``overflow`` is False.  ``overflow``
    flags a (tie-driven) spill of the level's candidate buffer of ``d1 +
    segments + 64`` cells, whose candidates past it are left unscanned:
    the caller must take the chain.

    Each level scans, for every midpoint ``d``, the candidates ``i`` in
    ``[max(lo_d, d - m', 0), min(hi_d, d, P)]`` (``m'`` and ``P``: the
    last finite index of row and carry; candidates outside are +inf),
    then tightens the children's bounds by the dual-split rule (module
    docstring).  An all-inf midpoint passes its range on unshrunk: the
    monotonicity holds only for rows with a finite minimum.  ``scanned``,
    when given, receives each level's candidate count (the ranges' total
    width, spilled or not: what the CUDA kernel scans)."""
    r = row.detach().cpu().numpy()
    p = prev.detach().cpu().numpy()
    dc1, d1 = r.shape[0], p.shape[0]
    fin_r = np.flatnonzero(np.isfinite(r))
    fin_p = np.flatnonzero(np.isfinite(p))
    mprime = int(fin_r[-1]) if len(fin_r) else -1
    pmax = int(fin_p[-1]) if len(fin_p) else -1
    lo_b = np.zeros(d1, np.int64)
    hi_b = np.full(d1, d1 - 1, np.int64)
    new = np.full(d1, np.inf, p.dtype)
    overflow = False
    for mids, segid, left, right, _ in _dnc_levels(d1):
        n_seg = len(mids)
        cap = d1 + n_seg + 64
        lo_m = np.maximum(np.maximum(lo_b[mids], mids - mprime), 0)
        hi_m = np.minimum(np.minimum(hi_b[mids], mids), pmax)
        w = np.maximum(hi_m - lo_m + 1, 0)
        off = np.cumsum(w) - w                          # exclusive prefix
        total = int(off[-1] + w[-1])
        overflow = overflow or total > cap
        if scanned is not None:
            scanned.append(total)
        n = min(total, cap)
        seg = np.repeat(np.arange(n_seg), w)[:n]
        i_c = np.arange(n) - off[seg] + lo_m[seg]
        vals = r[mids[seg] - i_c] + p[i_c]
        segmin = np.full(n_seg, np.inf, p.dtype)
        arg_l = lo_m.copy()
        arg_r = hi_m.copy()
        kept = np.flatnonzero((w > 0) & (off < n))      # segments scanned
        if len(kept):
            starts = off[kept]
            segmin[kept] = np.minimum.reduceat(vals, starts)
            ismin = vals == segmin[seg]
            has = kept[np.isfinite(segmin[kept])]
            arg_l[has] = np.minimum.reduceat(np.where(ismin, i_c, d1),
                                             starts)[np.isfinite(
                                                 segmin[kept])]
            arg_r[has] = np.maximum.reduceat(np.where(ismin, i_c, -1),
                                             starts)[np.isfinite(
                                                 segmin[kept])]
        new[mids] = segmin
        hi_b = np.where(left, np.minimum(hi_b, arg_r[segid]), hi_b)
        lo_b = np.where(right, np.maximum(lo_b, arg_l[segid]), lo_b)
    return torch.from_numpy(new).to(prev.device), overflow


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

def _clean(x: torch.Tensor) -> torch.Tensor:
    """No NaN and no -inf anywhere (a bool tensor)."""
    return ((x == x) & (x > float("-inf"))).all()


def monotone_step_with_path(row: torch.Tensor, prev: torch.Tensor, *,
                            plateau_max: Optional[int] = None
                            ) -> Tuple[torch.Tensor, int]:
    """One slot ``new[d] = min_j row[j] + prev[d - j]`` (cost only) with
    the reference's structure-aware dispatch: certified-convex rows take
    :func:`monotone_dnc_step`, rows of at most ``plateau_max`` runs (a
    third of the band by default) :func:`plateau_step`, every other row
    the chain; a fast branch needs row and carry free of NaN and -inf.
    Returns ``(new, path)``, ``path`` the branch taken (a D&C spill
    reports ``PATH_CHAIN``).  The chain's value bit for bit on every
    path; the gates are read on the host in one copy."""
    dc1 = row.shape[0]
    if plateau_max is None:
        plateau_max = max(dc1 // _PLATEAU_FRACTION, 1)
    clean = _clean(row) & _clean(prev)
    convex, plat = torch.stack([
        clean & convex_certificate(row),
        clean & (run_count(row) <= plateau_max)]).tolist()
    if convex:
        new, overflow = monotone_dnc_step(row, prev)
        if not bool(overflow):
            return new, PATH_DNC
    elif plat:
        return plateau_step(row, prev), PATH_PLATEAU
    return minplus_chain_step(row[None], prev[None])[0], PATH_CHAIN


def monotone_step(row: torch.Tensor, prev: torch.Tensor, *,
                  plateau_max: Optional[int] = None) -> torch.Tensor:
    """Value-only form of :func:`monotone_step_with_path`."""
    return monotone_step_with_path(row, prev, plateau_max=plateau_max)[0]


def monotone_sweep(rows: torch.Tensor, d_total: int) -> torch.Tensor:
    """Cost-only T-slot DP sweep through the dispatcher from ``[0, inf,
    ...]``: ``minplus_sweep_cost``'s value bit for bit on any rows."""
    prev = torch.full((d_total + 1,), float("inf"), dtype=rows.dtype,
                      device=rows.device)
    prev[0] = 0.0
    cols = []
    for row in rows:
        prev = monotone_step(row, prev)
        cols.append(prev)
    return torch.stack(cols) if cols else prev.new_empty((0, d_total + 1))


def monotone_path_ref(row: np.ndarray,
                      plateau_max: Optional[int] = None) -> int:
    """Numpy oracle of the dispatch decision (spills aside): the branch
    :func:`monotone_step_with_path` takes for ``row``."""
    row = np.asarray(row)
    dc1 = row.shape[-1]
    if plateau_max is None:
        plateau_max = max(dc1 // _PLATEAU_FRACTION, 1)
    if bool(convex_certificate_np(row)):
        return PATH_DNC
    with np.errstate(invalid="ignore"):
        clean = bool(np.all((row == row) & (row > -np.inf)))
    if clean and int(run_count_np(row)) <= plateau_max:
        return PATH_PLATEAU
    return PATH_CHAIN
