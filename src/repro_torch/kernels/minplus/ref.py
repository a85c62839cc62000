"""Plain PyTorch versions of the min-plus slot and the whole-horizon DP
sweep.

The CPU paths of :mod:`repro_torch.kernels.minplus.ops` and the oracles
the CUDA kernels are held to, bit for bit: min-plus has no multiply, so
every cost is one IEEE add of the inputs and the first-index argmin is
fixed by the values alone.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


# candidate cells materialised at once by the slot oracles: bounds their
# memory at wide bands (d1 = 20480, DC+1 = 8960 is 183M cells per slot)
_CHUNK_CELLS = 1 << 22


def window_min(row: torch.Tensor, prev: torch.Tensor, want_arg: bool
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``new[..., d] = min_j row[..., j] + prev[..., d - j]`` (+inf where
    ``d - j < 0``) over leading batch axes, with the first-index argmin
    (int64) when ``want_arg``; evaluated in chunks of output columns.
    Cost only, the row is reversed instead of every window: the minimum
    of the same sums in another order (no candidate is NaN, and none is
    -0 unless both addends are)."""
    dc1 = row.shape[-1]
    d1 = prev.shape[-1]
    lead = prev.shape[:-1]
    pad = torch.full(lead + (dc1 - 1,), float("inf"), dtype=prev.dtype,
                     device=prev.device)
    padded = torch.cat([pad, prev], dim=-1)
    batch = prev.numel() // max(d1, 1)
    step = max(1, _CHUNK_CELLS // (dc1 * max(batch, 1)))
    rrow = row.flip(-1).unsqueeze(-2)
    vals, args = [], []
    for c0 in range(0, d1, step):
        c1 = min(d1, c0 + step)
        win = padded[..., c0:c1 + dc1 - 1].unfold(-1, dc1, 1)
        if not want_arg:
            # window d of the padded carry: prev[d - j] at dc1 - 1 - j
            vals.append(torch.amin(rrow + win, dim=-1))
            continue
        # window d of the padded carry, reversed: prev[d - j] for each j
        best, arg = torch.min(row.unsqueeze(-2) + win.flip(-1), dim=-1)
        vals.append(best)
        args.append(arg)
    new = torch.cat(vals, dim=-1)
    return new, (torch.cat(args, dim=-1) if want_arg else None)


def minplus_ref(row: torch.Tensor, prev: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DP slot ``new[d] = min_j row[j] + prev[d - j]`` with the
    first-index argmin — the function of the reference's
    ``kernels/minplus/ref.py::minplus_ref`` and Pallas ``minplus_pallas``,
    in the inputs' dtype (the reference casts to float32).

    row (DC+1,), prev (D+1,), +inf where infeasible, no NaN.  Returns
    ``(new (D+1,), arg (D+1,) int32)``, arg 0 where every candidate is
    +inf."""
    new, arg = window_min(row, prev, want_arg=True)
    return new, arg.to(torch.int32)


def minplus_sweep_cost(rows: torch.Tensor, d_total: int) -> torch.Tensor:
    """The cost of :func:`minplus_sweep_ref` alone, slot by slot through
    :func:`window_min`'s cost-only path: the same minima, bit for bit,
    without the split."""
    T = rows.shape[0]
    cost = torch.empty((T, d_total + 1), dtype=rows.dtype,
                       device=rows.device)
    prev = torch.full((d_total + 1,), float("inf"), dtype=rows.dtype,
                      device=rows.device)
    prev[0] = 0.0
    for t in range(T):
        prev = cost[t] = window_min(rows[t], prev, want_arg=False)[0]
    return cost


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
