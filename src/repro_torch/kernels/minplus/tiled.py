"""Horizon-tiled min-plus DP building blocks, plain PyTorch.

The counterpart of the reference's ``kernels/minplus/tiled.py``.  The
tiled decision core (``core/schedule_torch.py::_decide_tiled_core``)
walks the horizon in ``TILE``-slot blocks from the job's arrival and
stops once no later slot can beat the incumbent payoff.  These are the
plain versions and oracles of its per-slot step:

* ``minplus_chain_step`` — one DP slot for a lane batch,
  ``new[b, d] = min_j rows[b, j] + prev[b, d - j]``; the function of the
  CUDA slot kernel (``kernel.py::minplus_cuda``) without the argmin;
* ``minplus_tile`` — a ``TILE``-slot chain segment returning every
  intermediate column (the core stores them for the split backtrack);
* ``minplus_sweep_tiled`` — a full cost-only sweep built from tiles
  from a ``start`` slot, equal to the whole-horizon sweep's cost on
  identity prefixes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .ref import window_min

# Tile width shared with the decision core (the reference's value).
TILE = 64


def minplus_chain_step(row: torch.Tensor, prev: torch.Tensor
                       ) -> torch.Tensor:
    """One banded min-plus DP slot for a batch of lanes.

    row: (B, DC+1) slot costs; prev: (B, D+1) carry.  Returns
    ``new[b, d] = min_j row[b, j] + prev[b, d - j]`` (out-of-range
    ``d - j`` contributes +inf); every candidate is one IEEE add, so the
    result is the same bits in any evaluation order."""
    return window_min(row, prev, want_arg=False)[0]


def minplus_tile(rows_tile: torch.Tensor, prev: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tile of the DP sweep for a lane batch.

    rows_tile: (TILE', B, DC+1) slot-major; prev: (B, D+1) carry entering
    the tile.  Returns ``(carry_out, cols (TILE', B, D+1))``, the DP
    column after each slot."""
    cols = []
    for row in rows_tile:
        prev = minplus_chain_step(row, prev)
        cols.append(prev)
    return prev, torch.stack(cols)


def minplus_sweep_tiled(rows: torch.Tensor, d_total: int, *,
                        tile: int = TILE, start: int = 0) -> torch.Tensor:
    """Cost-only sweep over (T, DC+1) rows, ``tile`` slots at a time from
    the tile holding ``start``.

    Slots before ``start`` must be identity rows (``[0, inf, ...]``),
    which leave the carry unchanged; the result rows from the start tile
    on equal the whole-horizon sweep's cost, and earlier rows are +inf
    (never inspected).  A trailing partial tile is padded with identity
    rows, so any horizon works."""
    T, dc1 = rows.shape
    d1 = d_total + 1
    T_pad = -(-T // tile) * tile
    if T_pad > T:
        ident = torch.full((T_pad - T, dc1), float("inf"), dtype=rows.dtype,
                           device=rows.device)
        ident[:, 0] = 0.0
        rows = torch.cat([rows, ident])
    prev = torch.full((1, d1), float("inf"), dtype=rows.dtype,
                      device=rows.device)
    prev[0, 0] = 0.0
    cost = torch.full((T_pad, d1), float("inf"), dtype=rows.dtype,
                      device=rows.device)
    for t0 in range(start // tile * tile, T_pad, tile):
        prev, cols = minplus_tile(rows[t0:t0 + tile, None, :], prev)
        cost[t0:t0 + tile] = cols[:, 0]
    return cost[:T]
