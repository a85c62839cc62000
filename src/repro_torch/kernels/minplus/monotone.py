"""Run-compressed (plateau) min-plus slot: the plain version of the
CUDA plateau kernel, the run-count gate, and the path codes.

The counterpart of the reference's ``kernels/minplus/monotone.py``
(``run_count``, ``run_count_np``, ``plateau_step``, ``PATH_*``).  Real
COST_t rows of Alg. 2 are staircases: they compress into few runs of
bitwise-equal values.  Within a run ``row[j]`` is one constant ``c``, so
``min_{j in run} fl(c + prev[d-j]) == fl(c + min_{j in run} prev[d-j])``
by monotonicity of rounding, and the window minimum comes from a
power-of-two doubling table of the padded carry: two contiguous slices
per run.  Bit-exact against the chain for any row free of NaN and -inf.

The convex divide-and-conquer branch and its exact certificate are off
by default in the reference (``REPRO_MONOTONE_DNC``) and not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

# dispatcher path codes (the decision core's per-tile counters)
PATH_DNC = 0
PATH_PLATEAU = 1
PATH_CHAIN = 2


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
