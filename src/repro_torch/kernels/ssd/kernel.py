"""CUDA Mamba2 SSD chunk scan: build, ctypes binding, launch plan and the
checked wrapper.

:func:`ssd_cuda` (``csrc/ssd_scan.cu``) replaces
``repro/kernels/ssd/kernel.py::ssd_pallas``: one block per (batch, head)
row walks the chunks in order with the (P, N) float32 state in shared
memory, starting from an optional initial state and returning the state
after the last chunk.  It reads the model's layout, x (b, L, H, P) and
B, C (b, L, G, N), broadcasting groups to heads itself, and pads a ragged
last chunk in shared memory, so nothing is copied around the launch.

:func:`ssd_plan` places a chunk by size: the state, x, B, C, the
per-step vectors and a (QB, Q) block of the score tile (all float32,
rows padded by one value) must fit in the 227 KB a block may use.  It
takes the largest QB of Q, Q/2, Q/4, ... that fits, and refuses a chunk
where even QB = 1 does not.

The library is compiled from the source at first use
(:mod:`repro_torch.kernels.build`), never at import.  The wrapper
launches on the current stream without synchronising, raises on a bad
device, dtype, shape or contiguity and on a failed launch, and counts its
launches in ``ssd_cuda.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from ..build import bind, build_libraries, launch

SOURCES = {"ssd": Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"}

# shared memory one block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 8 + [_I] * 9 + [_P]
_FUNCTIONS = {"ssd_scan_f32": _ARGS, "ssd_scan_bf16": _ARGS}
_ERROR = "ssd_error_string"
_lib: list = []


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the SSD library."""
    if not _lib:
        path, = build_libraries([SOURCES["ssd"]])
        _lib.append(bind(path, _FUNCTIONS, _ERROR))
    return _lib[0]


class SsdPlan(NamedTuple):
    qb: int                # query rows of the score tile per pass
    smem_bytes: int


def ssd_smem_bytes(P: int, N: int, Q: int, qb: int) -> int:
    """Dynamic shared memory of one block (csrc/ssd_scan.cu's layout)."""
    return 4 * (P * (N + 1) + Q * (P + 1) + 2 * Q * (N + 1) + 4 * Q
                + qb * (Q + 1))


def ssd_plan(P: int, N: int, Q: int, *, qb: Optional[int] = None
             ) -> SsdPlan:
    """The launch plan for head dim P, state N and chunk Q (module
    docstring); ``qb`` forces the score tile's rows.  Pure: the CPU tests
    plan every shape.  Raises ValueError where the chunk does not fit."""
    if qb is not None:
        if not 1 <= qb <= Q:
            raise ValueError(f"qb={qb} must lie in [1, Q={Q}]")
        widths = [qb]
    else:                               # Q, ceil(Q/2), ..., 1
        widths = [Q]
        while widths[-1] > 1:
            widths.append((widths[-1] + 1) // 2)
    for w in widths:
        smem = ssd_smem_bytes(P, N, Q, w)
        if smem <= SMEM_LIMIT:
            return SsdPlan(w, smem)
    raise ValueError(f"SSD chunk P={P} N={N} Q={Q} (qb={qb}) does not fit "
                     f"in {SMEM_LIMIT} bytes of shared memory")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_cuda: {msg}")


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None,
             plan: Optional[SsdPlan] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunk scan as one CUDA launch.

    x (b, L, H, P) and B, C (b, L, G, N): float32 or bfloat16, one dtype;
    dt (b, L, H) and A (H,): float32; init_state (b, H, P, N) float32 or
    None (zeros).  All contiguous on one CUDA device, H % G == 0.  Returns
    ``(y (b, L, H, P) float32, final_state (b, H, P, N) float32)`` — the
    value of ``models.mamba2.ssd_chunked`` without the D skip term.
    ``plan`` overrides :func:`ssd_plan`."""
    tensors = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    if init_state is not None:
        tensors["init_state"] = init_state
    for name, t in tensors.items():
        _require(t.is_cuda, f"needs CUDA tensors ({name} is on {t.device})")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(len({t.device for t in tensors.values()}) == 1,
             "tensors on several devices")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_cuda: x must be float32 or bfloat16, not "
                        f"{x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("ssd_cuda: x, B and C must share one dtype")
    for name in ("dt", "A", "init_state"):
        if name in tensors and tensors[name].dtype != torch.float32:
            raise TypeError(f"ssd_cuda: {name} must be float32")
    _require(x.ndim == 4, f"x must be (b, L, H, P), not {tuple(x.shape)}")
    b, L, H, P = x.shape
    _require(B.ndim == 4 and B.shape[:2] == (b, L) and C.shape == B.shape,
             f"B, C must be (b, L, G, N) matching x, not {tuple(B.shape)} "
             f"and {tuple(C.shape)}")
    G, N = B.shape[2], B.shape[3]
    _require(dt.shape == (b, L, H), f"dt must be {(b, L, H)}")
    _require(A.shape == (H,), f"A must be {(H,)}")
    _require(min(b, L, H, P, G, N) > 0 and H % G == 0,
             f"empty shape or H={H} not a multiple of G={G}")
    _require(chunk >= 1, f"chunk must be >= 1, not {chunk}")
    if init_state is not None:
        _require(init_state.shape == (b, H, P, N),
                 f"init_state must be {(b, H, P, N)}")
    plan = plan or ssd_plan(P, N, chunk)
    y = torch.empty((b, L, H, P), dtype=torch.float32, device=x.device)
    final = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    launch(load_library(), "ssd_scan_bf16" if x.dtype == torch.bfloat16
           else "ssd_scan_f32", _ERROR, x.device, x.data_ptr(),
           dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
           init_state.data_ptr() if init_state is not None else None,
           y.data_ptr(), final.data_ptr(), b * H, L, H, P, G, N, chunk,
           plan.qb, plan.smem_bytes)
    ssd_cuda.launches += 1
    return y, final


ssd_cuda.launches = 0
