"""CUDA min-plus DP sweep: build, ctypes binding and the checked wrapper.

Replaces ``repro/kernels/minplus/kernel.py::minplus_sweep_pallas``; the
kernel itself and its design notes are in ``csrc/minplus_sweep.cu``.  The
library is compiled from that source at first use
(:mod:`repro_torch.kernels.build`), never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..build import build_libraries

SOURCE = Path(__file__).resolve().parent / "csrc" / "minplus_sweep.cu"

# shared memory one block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024

_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's library."""
    global _lib
    if _lib is None:
        path, = build_libraries([SOURCE])
        lib = ctypes.CDLL(str(path))
        for fn in (lib.minplus_sweep_f32, lib.minplus_sweep_f64):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.minplus_error_string.argtypes = [ctypes.c_int]
        lib.minplus_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def minplus_sweep_cuda(rows: torch.Tensor, d_total: int, *,
                       want_split: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The DP sweep of :func:`..ref.minplus_sweep_ref` as one CUDA launch.

    rows: (T, DC+1) float32 or float64, contiguous, on a CUDA device.
    Returns ``(cost (T, D+1), split (T, D+1) int32 or None)``; the split
    is skipped when ``want_split`` is False.  Launches on the current
    stream without synchronising; ``minplus_sweep_cuda.launches`` counts
    the launches."""
    if not rows.is_cuda:
        raise ValueError("minplus_sweep_cuda needs a CUDA tensor")
    if rows.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rows must be float32 or float64, not {rows.dtype}")
    if rows.ndim != 2 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (T, DC+1) tensor")
    T, dc1 = rows.shape
    d1 = int(d_total) + 1
    if dc1 < 1 or d1 < 1:
        raise ValueError(f"empty band: rows {tuple(rows.shape)}, "
                         f"d_total {d_total}")
    smem = (2 * d1 + dc1) * rows.element_size()   # two carries, one row
    if smem > SMEM_LIMIT:
        raise ValueError(f"sweep needs {smem} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block may use")
    cost = torch.empty((T, d1), dtype=rows.dtype, device=rows.device)
    split = (torch.empty((T, d1), dtype=torch.int32, device=rows.device)
             if want_split else None)
    if T == 0:
        return cost, split
    lib = load_library()
    fn = (lib.minplus_sweep_f64 if rows.dtype == torch.float64
          else lib.minplus_sweep_f32)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = fn(rows.data_ptr(), cost.data_ptr(),
                split.data_ptr() if split is not None else None,
                T, dc1, d1, stream)
    if rc != 0:
        raise RuntimeError("minplus_sweep launch failed: "
                           + lib.minplus_error_string(rc).decode())
    minplus_sweep_cuda.launches += 1
    return cost, split


minplus_sweep_cuda.launches = 0
