"""Plain PyTorch version of the whole-horizon min-plus DP sweep.

The CPU path of :func:`repro_torch.kernels.minplus.ops.minplus_sweep` and
the oracle the CUDA kernel is held to, bit for bit: min-plus has no
multiply, so every cost is one IEEE add of the inputs and the first-index
argmin is fixed by the values alone.
"""
from __future__ import annotations

from typing import Tuple

import torch


def minplus_sweep_ref(rows: torch.Tensor, d_total: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """T-slot DP sweep ``cost_t[d] = min_j rows[t, j] + cost_{t-1}[d - j]``
    from the carry ``cost_{-1} = [0, inf, ...]``.

    rows: (T, DC+1), +inf where infeasible, no NaN.  Returns
    ``(cost (T, D+1) in rows' dtype, split (T, D+1) int32)``; the split is
    the first index of the minimum (0 where every candidate is +inf).
    """
    T, dc1 = rows.shape
    d1 = d_total + 1
    inf = torch.tensor(float("inf"), dtype=rows.dtype, device=rows.device)
    cost = torch.empty((T, d1), dtype=rows.dtype, device=rows.device)
    split = torch.empty((T, d1), dtype=torch.int32, device=rows.device)
    # left pad of dc1-1 infs: window d of the padded carry, reversed, is
    # prev[d - j] for j = 0..dc1-1 (inf where d - j < 0)
    pad = inf.expand(dc1 - 1)
    prev = torch.full((d1,), float("inf"), dtype=rows.dtype,
                      device=rows.device)
    prev[0] = 0.0
    for t in range(T):
        win = torch.cat([pad, prev]).unfold(0, dc1, 1).flip(1)   # (d1, dc1)
        best, arg = torch.min(rows[t][None, :] + win, dim=1)
        cost[t] = best
        split[t] = arg.to(torch.int32)
        prev = best
    return cost, split
