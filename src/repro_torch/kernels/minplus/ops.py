"""Device dispatch for the min-plus kernels: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain PyTorch version.  Nothing
falls back: a CUDA tensor the kernel refuses raises."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import (minplus_cuda, minplus_dnc_cuda, minplus_plateau_cuda,
                     minplus_sweep_cuda)
from .monotone import (_clean, convex_certificate, monotone_dnc_step,
                       plateau_step, run_count)
from .ref import minplus_ref, minplus_sweep_cost, minplus_sweep_ref
from .tiled import minplus_tile


def minplus(row: torch.Tensor, prev: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot ``(new (D+1,), arg (D+1,) int32)`` with
    ``new[d] = min_j row[j] + prev[d-j]`` and the first-index argmin."""
    if row.is_cuda:
        return minplus_cuda(row, prev)
    return minplus_ref(row, prev)


def minplus_monotone(row: torch.Tensor, prev: torch.Tensor,
                     r_max: int = 16) -> torch.Tensor:
    """Structure-aware slot, cost only, in the reference's non-Pallas
    dispatch order: a row certified convex (:func:`.monotone.
    convex_certificate`) takes the D&C step, a row of at most ``r_max``
    runs the plateau step, any other row (or a row or carry with NaN or
    -inf) the plain slot; the gates are read on the host in one copy.
    Each branch runs on the card's kernel or, for a CPU tensor, its plain
    version (a spill of the plain D&C step takes the plain slot).
    Bit-identical to :func:`minplus`'s cost on every path."""
    clean = _clean(row) & _clean(prev)
    convex, plat = torch.stack([clean & convex_certificate(row),
                                clean & (run_count(row) <= r_max)]).tolist()
    if convex:
        if row.is_cuda:
            return minplus_dnc_cuda(row[None], prev)[0]
        new, overflow = monotone_dnc_step(row, prev)
        if not overflow:
            return new
    elif plat:
        if row.is_cuda:
            return minplus_plateau_cuda(row[None], prev, r_max=r_max)[0]
        return plateau_step(row, prev)
    if row.is_cuda:
        return minplus_cuda(row, prev, want_arg=False)[0]
    return minplus_ref(row, prev)[0]


def minplus_sweep(rows: torch.Tensor, d_total: int, *,
                  want_split: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(cost (T, D+1), split (T, D+1) int32 or None)`` of the DP sweep
    over ``rows`` (T, DC+1) from the carry ``[0, inf, ...]``."""
    if rows.is_cuda:
        return minplus_sweep_cuda(rows, d_total, want_split=want_split)
    if not want_split:
        return minplus_sweep_cost(rows, d_total), None
    return minplus_sweep_ref(rows, d_total)


def minplus_chain(rows: torch.Tensor, prev: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """Cost-only DP columns of the slots ``rows`` (n, DC+1) from the carry
    ``prev`` (D+1,), written into ``out`` (n, D+1) — or of B lanes at
    once: ``rows`` (B, n, DC+1), ``prev`` (B, D+1), ``out`` (B, n, D+1):
    one launch of the sweep kernel from those carries on the card (one
    cluster per lane), :func:`.tiled.minplus_tile` on the CPU."""
    if rows.is_cuda:
        return minplus_sweep_cuda(rows, prev.shape[-1] - 1, prev=prev,
                                  out=out)[0]
    if rows.ndim == 2:
        return out.copy_(minplus_tile(rows[:, None, :], prev[None])[1][:, 0])
    return out.copy_(minplus_tile(rows.transpose(0, 1), prev)[1]
                     .transpose(0, 1))


def minplus_plateau_tile(rows: torch.Tensor, prev: torch.Tensor,
                         out: torch.Tensor, r_max: int) -> torch.Tensor:
    """Cost-only DP columns of the run-compressed slots ``rows`` (n, DC+1)
    from the carry ``prev`` (D+1,), written into ``out`` (n, D+1): one
    launch of the plateau kernel on the card (fast for rows of at most
    ``r_max`` runs, right for any), :func:`.monotone.plateau_step` chained
    over the rows on the CPU."""
    if rows.is_cuda:
        return minplus_plateau_cuda(rows, prev, r_max=r_max, out=out)
    for i, row in enumerate(rows):
        prev = out[i].copy_(plateau_step(row, prev))
    return out


def minplus_dnc_tile(rows: torch.Tensor, prev: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """Cost-only DP columns of the certified-convex slots ``rows`` (n,
    DC+1) from the carry ``prev`` (D+1,), written into ``out`` (n, D+1):
    one launch of the D&C kernel on the card, :func:`.monotone.
    monotone_dnc_step` chained over the rows on the CPU (a slot whose
    plain step spills takes the chain, as the reference's dispatch
    does)."""
    if rows.is_cuda:
        return minplus_dnc_cuda(rows, prev, out=out)
    for i, row in enumerate(rows):
        new, overflow = monotone_dnc_step(row, prev)
        if overflow:
            new = minplus_tile(row[None, None, :], prev[None])[0][0]
        prev = out[i].copy_(new)
    return out
