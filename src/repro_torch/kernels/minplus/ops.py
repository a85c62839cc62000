"""Device dispatch for the min-plus DP sweep: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain PyTorch version."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import minplus_sweep_cuda
from .ref import minplus_sweep_ref


def minplus_sweep(rows: torch.Tensor, d_total: int, *,
                  want_split: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(cost (T, D+1), split (T, D+1) int32 or None)`` of the DP sweep
    over ``rows`` (T, DC+1) from the carry ``[0, inf, ...]``."""
    if rows.is_cuda:
        return minplus_sweep_cuda(rows, d_total, want_split=want_split)
    cost, split = minplus_sweep_ref(rows, d_total)
    return cost, split if want_split else None
