"""CUDA Mamba2 SSD chunk scan: build, ctypes binding, launch plan and the
checked wrapper.

:func:`ssd_cuda` (``csrc/ssd_mma.cu``) replaces
``repro/kernels/ssd/kernel.py::ssd_pallas``: one block per (batch, head)
row and chunk, the chunk products on the tensor cores (TF32, split in
three passes for float32 inputs), and the state before each chunk formed
across one thread-block cluster of the row's chunks in distributed shared
memory, starting from an optional initial state and returning the state
after the last chunk.  It reads the model's layout, x (b, L, H, P) and
B, C (b, L, G, N), broadcasting groups to heads itself, and pads a ragged
last chunk in shared memory, so nothing is copied around the launch.

:func:`ssd_plan` sizes the launch.  The scan is the same function at any
chunk length, so the kernel takes its own: the model's chunk Q, cut to
64 steps, which a block of 4 warps holds (one per 16 steps) in ~53 KB of
shared memory at Zamba2-7B's widths, four blocks to an SM.  A cluster
takes the smallest power of two of blocks that holds the row's chunks,
at most 8 (the portable cluster size; ``tools/ssd_variant_probe.py``
times the caps, PERF.md), and the row is walked in as many segments of
that many chunks as it needs.  A chunk whose arrays do not fit in the
227 KB a block may use is refused.

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

SOURCES = {"ssd": Path(__file__).resolve().parent / "csrc" / "ssd_mma.cu"}

# shared memory one block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024
# the kernel's own chunk: one warp of a block per 16 steps
MAX_STEPS = 64
# blocks (chunks) a cluster holds at most: the portable cluster size
MAX_CLUSTER = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 8 + [_I] * 9 + [_P]
_FUNCTIONS = {"ssd_mma_f32": _ARGS, "ssd_mma_bf16": _ARGS}
_ERROR = "ssd_mma_error_string"
_lib: list = []


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the SSD library."""
    if not _lib:
        path, = build_libraries([SOURCES["ssd"]])
        _lib.append(bind(path, _FUNCTIONS, _ERROR))
    return _lib[0]


class SsdPlan(NamedTuple):
    steps: int             # the kernel's chunk
    cluster: int           # blocks (chunks) per cluster
    segments: int          # clusters' worth of chunks a row is walked in
    smem_bytes: int


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def ssd_smem_bytes(P: int, N: int, Q: int) -> int:
    """Dynamic shared memory of one block (csrc/ssd_mma.cu's layout) for a
    kernel chunk of Q steps: x, B and C of the chunk, the state over C's
    rows, four per-step vectors and the block's warp sums and decay.  P is
    padded to the 64 columns of y a pass keeps, N to 32 and Q to 16."""
    Pp, Np, Qp = _up(P, 64), _up(N, 32), _up(Q, 16)
    return 4 * (Qp * (Pp + 4) + Qp * (Np + 4) + max(Qp, Pp) * (Np + 4)
                + 4 * Qp + 8)


def ssd_plan(L: int, P: int, N: int, Q: int) -> SsdPlan:
    """The launch plan for a row of L steps, head dim P, state N and the
    model's chunk Q (module docstring).  Pure: the CPU tests plan every
    shape.  Raises ValueError where a chunk does not fit."""
    if min(L, P, N, Q) < 1:
        raise ValueError(f"empty SSD shape L={L} P={P} N={N} Q={Q}")
    steps = min(Q, MAX_STEPS)
    smem = ssd_smem_bytes(P, N, steps)
    if smem > SMEM_LIMIT:
        raise ValueError(f"SSD chunk P={P} N={N} of {steps} steps needs "
                         f"{smem} bytes of shared memory, over the "
                         f"{SMEM_LIMIT} a block may use")
    chunks = -(-L // steps)
    cluster = min(MAX_CLUSTER, 1 << (chunks - 1).bit_length())
    return SsdPlan(steps, cluster, -(-chunks // cluster), smem)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_cuda: {msg}")


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunk scan as one CUDA launch.

    x (b, L, H, P) and B, C (b, L, G, N): float32 or bfloat16, one dtype;
    dt (b, L, H) and A (H,): float32; init_state (b, H, P, N) float32 or
    None (zeros).  All contiguous on one CUDA device, H % G == 0.  Returns
    ``(y (b, L, H, P) float32, final_state (b, H, P, N) float32)`` — the
    value of ``models.mamba2.ssd_chunked`` without the D skip term."""
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
    plan = ssd_plan(L, P, N, chunk)
    refuse_grad(*tensors.values())
    y = torch.empty((b, L, H, P), dtype=torch.float32, device=x.device)
    final = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    launch(load_library(), "ssd_mma_bf16" if x.dtype == torch.bfloat16
           else "ssd_mma_f32", _ERROR, x.device, x.data_ptr(),
           dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
           init_state.data_ptr() if init_state is not None else None,
           y.data_ptr(), final.data_ptr(), b * H, L, H, P, G, N, plan.steps,
           plan.cluster, plan.smem_bytes)
    ssd_cuda.launches += 1
    return y, final


ssd_cuda.launches = 0


def refuse_grad(*tensors: torch.Tensor) -> None:
    """Raise NotImplementedError when grad mode is on and an input
    requires a gradient: the kernel writes into buffers of its own (no
    autograd graph) and has no backward yet, so its output would silently
    cut the gradients.  The SSD backward kernel, and with it ``ssm`` and
    ``hybrid`` training on the card, is the port's next slice; until then
    such a model trains on the CPU, whose plain chunked scan autograd
    differentiates."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ssd_chunked on a CUDA device with an input that requires a "
            "gradient: the SSD kernel has no backward yet (the SSD backward "
            "kernel is the port's next slice), so ssm/hybrid training on "
            "the card is refused; train on the CPU (device='cpu') or run "
            "the forward without grad")
