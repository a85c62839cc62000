"""CUDA min-plus kernels: build, ctypes bindings, launch plans and the
checked wrappers.

Four kernels, each in its own ``csrc/*.cu`` with its design notes:

* :func:`minplus_sweep_cuda` (``minplus_sweep.cu``) replaces
  ``repro/kernels/minplus/kernel.py::minplus_sweep_pallas``: the
  whole-horizon DP sweep, T slots in one launch of ONE thread-block
  cluster whose blocks each own a slice of the carry and read their
  neighbours' through distributed shared memory.  :func:`sweep_plan`
  picks the cluster size (up to 16 blocks) and the split of the j range
  over thread groups, and refuses a band whose buffers
  cannot fit the 227 KB (232,448 bytes) a block may use.
  From a carry-in (``prev``), cost only, the same launch replaces
  ``minplus_pallas`` as the tiled route runs it: the live slots of one
  chain tile in one launch, under the same plan, for a batch of lanes
  (one cluster per lane, a grid of (C, B)).
* :func:`minplus_cuda` (``minplus_slot.cu``), the one-slot entry behind
  ``ops.minplus``: one slot with the first-index argmin (or cost only),
  the function of ``minplus_pallas``.  Grid of
  ``ceil((D+1) / 256)`` blocks of 256 threads, one output each; the row
  and the block's window of the carry (``2 (DC+1) + 255`` values) are
  staged in shared memory when they fit (:func:`slot_plan`), else read
  from global memory.
* :func:`minplus_plateau_cuda` (``minplus_plateau.cu``) replaces
  ``minplus_plateau_pallas`` as the tiled route runs it: the live slots
  of one plateau tile in one launch of one thread-block cluster from a
  carry-in, cost only, with the sweep's carry handoff and, per slot, a
  doubling table over each block's window of the carry answered per run
  of the row.  :func:`plateau_plan` picks the cluster by
  :func:`sweep_plan`'s rule and keeps the table in shared memory where
  it fits, else in a global scratch tensor.  One row is the one-slot
  entry (``ops.minplus_monotone``).
* :func:`minplus_dnc_cuda` (``minplus_dnc.cu``) is the counterpart of
  the reference's ``monotone.py::monotone_dnc_step`` (a jnp function, no
  Pallas kernel) as the tiled route runs it with ``REPRO_MONOTONE_DNC``
  on: the live slots of one D&C tile, rows certified convex, in one
  launch of one thread block from a carry-in, cost only, level by level
  of the static recursion of :func:`dnc_levels`.  :func:`dnc_plan` keeps
  the carry, the new column and the bounds in shared memory where they
  fit, else in global memory.  One row is the one-slot entry
  (``ops.minplus_monotone``).

The libraries are compiled from the sources at first use
(:mod:`repro_torch.kernels.build`, all ``nvcc`` processes started
together), never at import.  Each wrapper launches on the current stream
without synchronising, raises on a bad device, dtype, shape or
contiguity and on a failed launch, and counts its launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..build import bind, build_libraries, launch
from .monotone import _dnc_levels
from .tiled import TILE

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"sweep": _CSRC / "minplus_sweep.cu",
           "slot": _CSRC / "minplus_slot.cu",
           "plateau": _CSRC / "minplus_plateau.cu",
           "dnc": _CSRC / "minplus_dnc.cu"}

# shared memory one block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024

# the sweep's cluster sizes and threads per block (csrc/minplus_sweep.cu);
# 16 is beyond the portable size, so the kernel checks that the card can
# place it.  A split j range aims at SWEEP_SPLIT_THREADS threads a block,
# and a block keeps at least SWEEP_MIN_COLUMNS columns (PERF.md's table
# of every cluster size and j split timed at the 10x buckets is the
# measurement behind both)
SWEEP_CLUSTERS = (1, 2, 4, 8, 16)
SWEEP_K = 4                    # consecutive columns a thread owns (kernel K)
SWEEP_MAX_THREADS = 512
SWEEP_SPLIT_THREADS = 256
SWEEP_MIN_COLUMNS = 64
SLOT_BLOCK = 256               # outputs per block (csrc/minplus_slot.cu kBlock)

_libs: Dict[str, ctypes.CDLL] = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sweep": ("minplus_sweep", [_P, _P, _P, _P] + [_I] * 8 + [_L] * 3 + [_P],
              "minplus_error_string"),
    "slot": ("minplus_slot", [_P, _P, _P, _P, _I, _I, _I, _P],
             "minplus_slot_error_string"),
    "plateau": ("minplus_plateau", [_P, _P, _P, _P] + [_I] * 11 + [_P],
                "minplus_plateau_error_string"),
    "dnc": ("minplus_dnc", [_P] * 6 + [_I] * 7 + [_P],
            "minplus_dnc_error_string"),
}


def load_libraries() -> Dict[str, ctypes.CDLL]:
    """Build (once per source hash, the ``nvcc`` runs started
    together) and load every min-plus library; returns them by name."""
    if len(_libs) < len(SOURCES):
        names = list(SOURCES)
        paths = build_libraries([SOURCES[n] for n in names])
        for name, path in zip(names, paths):
            stem, argtypes, err = _SIGNATURES[name]
            _libs[name] = bind(path, {f"{stem}_{suffix}": argtypes
                                      for suffix in ("f32", "f64")}, err)
    return _libs


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args):
    stem, _, err = _SIGNATURES[name]
    launch(load_libraries()[name],
           f"{stem}_{'f64' if dtype == torch.float64 else 'f32'}", err,
           device, *args)


def _check(name: str, lanes: bool = False,
           **tensors: torch.Tensor) -> torch.dtype:
    """Device, dtype and layout checks; with ``lanes`` a tensor's leading
    axis is a lane axis, each lane must be row-major and the lanes must
    not overlap (a stride of at least a lane's extent), since each lane's
    cluster writes its own."""
    dtype = None
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors ({arg} is on "
                             f"{t.device})")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{arg} must be float32 or float64, not "
                            f"{t.dtype}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if not (t[0] if lanes and t.shape[0] else t).is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous"
                             + (" in each lane" if lanes else ""))
        if lanes and t.shape[0] > 1 and t.stride(0) < t[0].numel():
            raise ValueError(f"{name}: {arg}'s lanes overlap (stride "
                             f"{t.stride(0)} < {t[0].numel()})")
        dtype = t.dtype
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    return dtype


# ---------------------------------------------------------------------------
# Whole-horizon sweep
# ---------------------------------------------------------------------------

class SweepPlan(NamedTuple):
    cluster: int           # blocks in the sweep's one cluster (C)
    w: int                 # columns per block
    jpad: int              # DC+1 rounded up to SWEEP_K: row buffer, halo
    jgroups: int           # thread groups the j range is split over (S)
    threads: int           # per block: (w / SWEEP_K) * jgroups
    smem_bytes: int        # dynamic shared memory per block


def _sweep_smem(w: int, jpad: int, jgroups: int, size: int) -> int:
    """Shared memory of one block (csrc/minplus_sweep.cu's layout): two
    carry slices and the window of w + jpad values, the row, and with a
    split j range the partial minima and their argmins."""
    part = jgroups * w if jgroups > 1 else 0
    return size * (3 * w + 2 * jpad + part) + 4 * part


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _sweep_plan_at(dc1: int, d1: int, size: int,
                   cluster: int) -> Optional[SweepPlan]:
    k = SWEEP_K
    w = _ceil_to(-(-d1 // cluster), k)
    jpad = _ceil_to(dc1, k)
    groups = w // k
    # split j so that a block has about SWEEP_SPLIT_THREADS threads, each
    # group keeping at least 2 steps of k
    jgroups = max(1, min(SWEEP_SPLIT_THREADS // groups, jpad // (2 * k)))
    smem = _sweep_smem(w, jpad, jgroups, size)
    if groups * jgroups > SWEEP_MAX_THREADS or smem > SMEM_LIMIT:
        return None
    return SweepPlan(cluster, w, jpad, jgroups, groups * jgroups, smem)


def sweep_plan(dc1: int, d1: int, dtype: torch.dtype) -> SweepPlan:
    """The kernel's launch plan for a (DC+1)-wide band over D+1 columns
    (module docstring), for the whole-horizon sweep and the chain tile
    alike: the layout holds one slot's row and the carry, whatever the
    number of slots.  Pure: the CPU tests call it on every shape bucket.
    The cluster is the largest of :data:`SWEEP_CLUSTERS` that leaves every
    block at least :data:`SWEEP_MIN_COLUMNS` columns (so d1 = 64 C takes C
    blocks), or the next larger one where that does not fit (64-slot
    tiles timed at C = 4, 8 and 16 keep the rule: PERF.md,
    ``tools/tile_cluster_probe.py``).  Raises ValueError where no plan
    fits shared memory or the threads of a block."""
    size = dtype.itemsize
    first = min(SWEEP_CLUSTERS[-1], _pow2_floor(d1 // SWEEP_MIN_COLUMNS))
    for c in SWEEP_CLUSTERS:
        plan = _sweep_plan_at(dc1, d1, size, c) if c >= first else None
        if plan is not None:
            return plan
    raise ValueError(
        f"no sweep plan for a band of {dc1} over {d1} columns in {dtype}: "
        f"a block's carry slices, window and row ({dc1} values) must fit "
        f"the {SMEM_LIMIT} bytes of shared memory a block may use, and its "
        f"column groups its {SWEEP_MAX_THREADS} threads, with a cluster of "
        f"at most {SWEEP_CLUSTERS[-1]} blocks")


def minplus_sweep_cuda(rows: torch.Tensor, d_total: int, *,
                       want_split: bool = True,
                       prev: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None,
                       plan: Optional[SweepPlan] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The DP sweep of :func:`..ref.minplus_sweep_ref` as one CUDA launch
    of one thread-block cluster, from the identity carry [0, inf, ...];
    or, given the carry ``prev`` (D+1,), cost only from it: ``cost[i, d]
    = min_j rows[i, j] + cost[i-1, d-j]`` with ``cost[-1] = prev``, the
    value of :func:`.tiled.minplus_tile` bit for bit where ``prev`` holds
    no -0 (a DP column started from the identity never does).  The
    tiled core steps the live slots of a chain tile so, for a batch of
    lanes at once: ``rows`` (B, T, DC+1), ``prev`` (B, D+1) and ``out``
    (B, T, D+1), one cluster per lane, cost only.

    rows: (T, DC+1) float32 or float64, contiguous, on a CUDA device;
    ``prev`` and ``out`` likewise, on the same device (with lanes, each
    lane contiguous and the lanes at any stride: rows of a larger table).
    Returns ``(cost (T, D+1), split (T, D+1) int32 or None)``; ``out``
    (T, D+1), when given, receives the cost (the tiled core passes rows
    of its cost table); the split is skipped when ``want_split`` is False
    or a carry is given.  ``plan`` overrides :func:`sweep_plan` (a test
    may force a plan of its own).  Launches on the current stream without
    synchronising; ``minplus_sweep_cuda.launches`` counts the launches,
    one per call whatever the lanes; T = 0 launches nothing."""
    given = {k: t for k, t in (("prev", prev), ("out", out)) if t is not None}
    lanes = rows.ndim == 3
    if lanes and prev is None:
        raise ValueError("minplus_sweep_cuda: lanes need a carry (prev)")
    if rows.ndim not in (2, 3):
        raise ValueError("rows must be a (T, DC+1) or (B, T, DC+1) tensor")
    _check("minplus_sweep_cuda", lanes=lanes, rows=rows, **given)
    B = rows.shape[0] if lanes else 1
    T, dc1 = rows.shape[-2:]
    d1 = int(d_total) + 1
    if dc1 < 1 or d1 < 1:
        raise ValueError(f"empty band: rows {tuple(rows.shape)}, "
                         f"d_total {d_total}")
    lead = (B,) if lanes else ()
    if prev is not None and prev.shape != lead + (d1,):
        raise ValueError(f"minplus_sweep_cuda: prev {tuple(prev.shape)} "
                         f"must be {lead + (d1,)}")
    if out is None:
        out = torch.empty(lead + (T, d1), dtype=rows.dtype,
                          device=rows.device)
    elif out.shape != lead + (T, d1):
        raise ValueError(f"minplus_sweep_cuda: out {tuple(out.shape)} must "
                         f"be {lead + (T, d1)}")
    split = (torch.empty((T, d1), dtype=torch.int32, device=rows.device)
             if want_split and prev is None else None)
    if T == 0 or B == 0:
        return out, split
    plan = plan or sweep_plan(dc1, d1, rows.dtype)
    strides = ((rows.stride(0), prev.stride(0), out.stride(0)) if lanes
               else (0, 0, 0))
    _launch("sweep", rows.dtype, rows.device, rows.data_ptr(),
            prev.data_ptr() if prev is not None else None, out.data_ptr(),
            split.data_ptr() if split is not None else None,
            T, dc1, d1, plan.cluster, plan.w, plan.jpad, plan.jgroups, B,
            *strides)
    minplus_sweep_cuda.launches += 1
    return out, split


minplus_sweep_cuda.launches = 0


# ---------------------------------------------------------------------------
# One slot with its argmin (the one-slot entry, ops.minplus)
# ---------------------------------------------------------------------------

def slot_plan(dc1: int, dtype: torch.dtype) -> bool:
    """Whether the slot kernel stages the row and its window of the carry
    (``2 (DC+1) + 255`` values) in shared memory."""
    return (2 * dc1 + SLOT_BLOCK - 1) * dtype.itemsize <= SMEM_LIMIT


def _slot_args(name: str, row: torch.Tensor, prev: torch.Tensor,
               out: Optional[torch.Tensor]) -> Tuple[torch.dtype, torch.Tensor]:
    if row.ndim != 1 or prev.ndim != 1 or row.numel() < 1 \
            or prev.numel() < 1:
        raise ValueError(f"{name}: row (DC+1,) and prev (D+1,) must be "
                         f"non-empty vectors, not {tuple(row.shape)} and "
                         f"{tuple(prev.shape)}")
    if out is None:
        out = torch.empty_like(prev)
    elif out.shape != prev.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} must match prev "
                         f"{tuple(prev.shape)}")
    dtype = _check(name, row=row, prev=prev, out=out)
    return dtype, out


def minplus_cuda(row: torch.Tensor, prev: torch.Tensor, *,
                 want_arg: bool = True, staged: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One slot of :func:`..ref.minplus_ref` as one CUDA launch:
    ``new[d] = min_j row[j] + prev[d - j]`` and the first-index argmin
    (skipped when ``want_arg`` is False).

    row (DC+1,), prev (D+1,): float32 or float64, contiguous, one CUDA
    device.  ``staged`` overrides :func:`slot_plan`.
    Returns ``(new, arg int32 or None)``."""
    dtype, out = _slot_args("minplus_cuda", row, prev, None)
    if staged is None:
        staged = slot_plan(row.numel(), dtype)
    arg = (torch.empty(prev.shape, dtype=torch.int32, device=prev.device)
           if want_arg else None)
    _launch("slot", dtype, prev.device, row.data_ptr(), prev.data_ptr(),
            out.data_ptr(), arg.data_ptr() if arg is not None else None,
            row.numel(), prev.numel(), int(staged))
    minplus_cuda.launches += 1
    return out, arg


minplus_cuda.launches = 0


# ---------------------------------------------------------------------------
# A plateau tile: run-compressed slots from a carry-in
# ---------------------------------------------------------------------------

PLATEAU_MAX_THREADS = 512      # csrc/minplus_plateau.cu kMaxThreads
# at least eight warps a block: at the route's shape (80 columns a block)
# 256 threads took ~0.12 us a slot off 128 (tools/plateau_tile_probe.py)
PLATEAU_MIN_THREADS = 256


class PlateauPlan(NamedTuple):
    cluster: int           # blocks in the launch's one cluster (C)
    w: int                 # columns per block
    jpad: int              # DC+1 rounded up to SWEEP_K: row stride, halo
    threads: int           # per block: w rounded up to a warp, 256..512
    kmax: int              # table levels: floor(log2(DC+1)) + 1
    stage: int             # slots whose rows and runs are staged at once
    table_shared: bool     # doubling table in shared memory
    smem_bytes: int        # dynamic shared memory per block
    scratch: int           # global table scratch, in values (0 if shared)


def _plateau_smem(w: int, jpad: int, r_max: int, kmax: int, stage: int,
                  shared: bool, size: int) -> int:
    """Shared memory of one block (csrc/minplus_plateau.cu's layout): two
    carry slices; per staged slot its row, its finite runs' constants, the
    two read offsets of each run (one more for the scan's run starts) and
    two scalars; in shared memory, the table of kmax levels over the
    window of jpad + w values."""
    table = kmax * (jpad + w) if shared else 0
    return (size * (2 * w + stage * (jpad + r_max) + table)
            + 4 * stage * (2 * r_max + 3))


def _plateau_plan_at(dc1: int, d1: int, size: int, r_max: int,
                     cluster: int, shared: bool) -> Optional[PlateauPlan]:
    """The plan at one cluster size and table placement, staging as many
    slots (up to a tile) as shared memory holds; None where not one
    fits."""
    w = _ceil_to(-(-d1 // cluster), SWEEP_K)
    jpad = _ceil_to(dc1, SWEEP_K)
    kmax = dc1.bit_length()
    threads = min(max(_ceil_to(w, 32), PLATEAU_MIN_THREADS),
                  PLATEAU_MAX_THREADS)
    fixed = _plateau_smem(w, jpad, r_max, kmax, 0, shared, size)
    per_slot = _plateau_smem(0, jpad, r_max, 0, 1, False, size)
    stage = min(TILE, (SMEM_LIMIT - fixed) // per_slot)
    if stage < 1:
        return None
    return PlateauPlan(cluster, w, jpad, threads, kmax, stage, shared,
                       fixed + stage * per_slot,
                       0 if shared else cluster * kmax * (jpad + w))


def plateau_plan(dc1: int, d1: int, dtype: torch.dtype, r_max: int, *,
                 table_shared: Optional[bool] = None) -> PlateauPlan:
    """The plateau kernel's launch plan for rows of DC+1 values over D+1
    columns (module docstring), whatever the number of slots: the
    cluster by :func:`sweep_plan`'s rule (the largest size that leaves a
    block at least :data:`SWEEP_MIN_COLUMNS` columns, or the next larger
    one where that does not fit), with the table in shared memory where
    some cluster fits it, else in global scratch; ``table_shared`` forces
    one placement.  Pure: the CPU tests call it on every shape bucket.
    Raises ValueError where even the slices, rows and run list of
    ``r_max`` runs do not fit shared memory."""
    size = dtype.itemsize
    first = min(SWEEP_CLUSTERS[-1], _pow2_floor(d1 // SWEEP_MIN_COLUMNS))
    for shared in ((True, False) if table_shared is None
                   else (table_shared,)):
        for c in SWEEP_CLUSTERS:
            plan = (_plateau_plan_at(dc1, d1, size, r_max, c, shared)
                    if c >= first else None)
            if plan is not None:
                return plan
    raise ValueError(
        f"no plateau plan for a band of {dc1} over {d1} columns in {dtype} "
        f"with r_max={r_max}: a block's carry slices and one slot's row and "
        f"run list must fit the {SMEM_LIMIT} bytes of shared memory a block "
        f"may use")


def minplus_plateau_cuda(rows: torch.Tensor, prev: torch.Tensor, *,
                         r_max: int = 16,
                         out: Optional[torch.Tensor] = None,
                         plan: Optional[PlateauPlan] = None) -> torch.Tensor:
    """Run-compressed DP slots, cost only, as one CUDA launch of one
    thread-block cluster: ``out[i] = plateau_step(rows[i], out[i-1])``
    with ``out[-1] = prev``, the value of :func:`.monotone.plateau_step`
    chained over the rows and of the chain (:func:`minplus_sweep_cuda`
    given ``prev``) bit for bit where ``prev`` holds no -0 (a DP column
    started from the identity never does).  The tiled core steps the live
    slots of a plateau tile so; one row is one slot.

    Fast for rows of at most ``r_max`` runs of equal values (the caller's
    gate, :func:`.monotone.run_count`); a row with more takes the
    kernel's direct loop and is still right.  rows (n, DC+1) float32 or
    float64, contiguous, on a CUDA device; ``prev`` (D+1,) and ``out``
    (n, D+1) likewise, on the same device; ``out`` receives the columns
    when given (the tiled core passes rows of its cost table).  ``plan``
    overrides :func:`plateau_plan`.  Launches on the current stream
    without synchronising; ``minplus_plateau_cuda.launches`` counts the
    launches; n = 0 launches nothing."""
    if rows.ndim != 2 or prev.ndim != 1 or rows.shape[1] < 1 \
            or prev.numel() < 1:
        raise ValueError(f"minplus_plateau_cuda: rows (n, DC+1) and prev "
                         f"(D+1,) must be a matrix and a non-empty vector, "
                         f"not {tuple(rows.shape)} and {tuple(prev.shape)}")
    n, dc1 = rows.shape
    d1 = prev.numel()
    if out is None:
        out = torch.empty((n, d1), dtype=prev.dtype, device=prev.device)
    elif out.shape != (n, d1):
        raise ValueError(f"minplus_plateau_cuda: out {tuple(out.shape)} "
                         f"must be {(n, d1)}")
    if r_max < 1:
        raise ValueError(f"r_max must be >= 1, not {r_max}")
    dtype = _check("minplus_plateau_cuda", rows=rows, prev=prev, out=out)
    if n == 0:
        return out
    plan = plan or plateau_plan(dc1, d1, dtype, r_max)
    scratch = (torch.empty(plan.scratch, dtype=dtype, device=prev.device)
               if plan.scratch else None)
    _launch("plateau", dtype, prev.device, rows.data_ptr(), prev.data_ptr(),
            out.data_ptr(), scratch.data_ptr() if scratch is not None
            else None, n, dc1, d1, int(r_max), plan.cluster, plan.w,
            plan.jpad, plan.threads, plan.kmax, plan.stage,
            int(plan.table_shared))
    minplus_plateau_cuda.launches += 1
    return out


minplus_plateau_cuda.launches = 0


# ---------------------------------------------------------------------------
# A D&C tile: certified-convex slots from a carry-in
# ---------------------------------------------------------------------------

DNC_THREADS = 512              # threads of the launch's one block


class DncPlan(NamedTuple):
    threads: int           # threads of the one block
    shared: bool           # carry, new column and bounds in shared memory
    smem_bytes: int        # dynamic shared memory


def _dnc_smem(dc1: int, d1: int, size: int, threads: int,
              shared: bool) -> int:
    """Shared memory of the block (csrc/minplus_dnc.cu's layout): with
    ``shared`` the carry, the new column, the row and the two bound
    arrays; always the per-warp partials, the two per-slot maxima and the
    levels' offsets (at most 32 levels: d1 < 2^31)."""
    warps = threads // 32
    small = 4 * (2 * warps + 2 + 33)
    if shared:
        return size * (2 * d1 + dc1 + warps) + 4 * 2 * d1 + small
    return size * warps + small


def dnc_plan(dc1: int, d1: int, dtype: torch.dtype) -> DncPlan:
    """The D&C kernel's launch plan for rows of DC+1 values over D+1
    columns, whatever the number of slots: one block of
    :data:`DNC_THREADS` threads, with the carry, the new column, the row
    and the bounds in shared memory where they fit the
    :data:`SMEM_LIMIT` bytes a block may use, else in global memory (the
    output's rows and a scratch of 2 (D+1) ints).  Pure: the CPU tests
    call it."""
    size = dtype.itemsize
    smem = _dnc_smem(dc1, d1, size, DNC_THREADS, True)
    if smem <= SMEM_LIMIT:
        return DncPlan(DNC_THREADS, True, smem)
    return DncPlan(DNC_THREADS, False,
                   _dnc_smem(dc1, d1, size, DNC_THREADS, False))


_dnc_tables: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def dnc_levels(d1: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The D&C recursion over [0, d1) as the kernel reads it, on
    ``device`` (built once per (d1, device)): ``segs`` (d1, 2) int32, the
    (s, e) segment of every midpoint ``(s + e) // 2``, level by level
    (:func:`.monotone._dnc_levels`), and ``level_off`` (levels + 1,)
    int32, where each level starts."""
    key = (int(d1), str(device))
    hit = _dnc_tables.get(key)
    if hit is None:
        levels = _dnc_levels(int(d1))
        segs = np.concatenate([lv[4] for lv in levels]).astype(np.int32)
        off = np.cumsum([0] + [len(lv[0]) for lv in levels]).astype(np.int32)
        hit = (torch.tensor(segs, device=device),
               torch.tensor(off, device=device))
        _dnc_tables[key] = hit
    return hit


def minplus_dnc_cuda(rows: torch.Tensor, prev: torch.Tensor, *,
                     out: Optional[torch.Tensor] = None,
                     plan: Optional[DncPlan] = None) -> torch.Tensor:
    """Convex D&C DP slots, cost only, as one CUDA launch of one thread
    block: ``out[i] = monotone_dnc_step(rows[i], out[i-1])`` with
    ``out[-1] = prev``, which equals the chain (:func:`minplus_sweep_cuda`
    given ``prev``) bit for bit for rows that pass
    :func:`.monotone.convex_certificate` (the caller's gate) where
    ``prev`` holds no -0.  The tiled core steps the live slots of a D&C
    tile so; one row is one slot.  The kernel keeps no candidate buffer,
    so it never spills where the plain step would.

    rows (n, DC+1) float32 or float64, contiguous, on a CUDA device;
    ``prev`` (D+1,) and ``out`` (n, D+1) likewise, on the same device;
    ``out`` receives the columns when given (the tiled core passes rows
    of its cost table).  ``plan`` overrides :func:`dnc_plan`.  Launches
    on the current stream without synchronising;
    ``minplus_dnc_cuda.launches`` counts the launches; n = 0 launches
    nothing."""
    if rows.ndim != 2 or prev.ndim != 1 or rows.shape[1] < 1 \
            or prev.numel() < 1:
        raise ValueError(f"minplus_dnc_cuda: rows (n, DC+1) and prev (D+1,) "
                         f"must be a matrix and a non-empty vector, not "
                         f"{tuple(rows.shape)} and {tuple(prev.shape)}")
    n, dc1 = rows.shape
    d1 = prev.numel()
    if out is None:
        out = torch.empty((n, d1), dtype=prev.dtype, device=prev.device)
    elif out.shape != (n, d1):
        raise ValueError(f"minplus_dnc_cuda: out {tuple(out.shape)} must be "
                         f"{(n, d1)}")
    dtype = _check("minplus_dnc_cuda", rows=rows, prev=prev, out=out)
    if n == 0:
        return out
    plan = plan or dnc_plan(dc1, d1, dtype)
    segs, level_off = dnc_levels(d1, prev.device)
    scratch = (None if plan.shared else
               torch.empty(2 * d1, dtype=torch.int32, device=prev.device))
    _launch("dnc", dtype, prev.device, rows.data_ptr(), prev.data_ptr(),
            out.data_ptr(), scratch.data_ptr() if scratch is not None
            else None, segs.data_ptr(), level_off.data_ptr(),
            level_off.numel() - 1, n, dc1, d1, plan.threads,
            int(plan.shared), plan.smem_bytes)
    minplus_dnc_cuda.launches += 1
    return out


minplus_dnc_cuda.launches = 0
