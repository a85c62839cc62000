"""CUDA flash attention (forward): build, ctypes binding, launch plan and
the checked wrapper.

:func:`flash_attention_cuda` (``csrc/flash_attention.cu``) replaces
``repro/kernels/flash_attention/kernel.py::flash_attention``: GQA with a
causal mask, a sliding window and a tanh soft-cap, the online softmax in
float32, one block per (batch * head, block of BQ query rows) walking
the key blocks in order.  It reads q (B, Sq, H, D) and k, v
(B, Sk, KV, D) in the model's layout and masks the ragged edges itself.

:func:`flash_plan` picks (BQ, BK) by the head dim D: the query block,
the accumulator, one key and one value block and the score tile (float32,
key and score rows padded by one value) must fit in the 227 KB a block
may use; the first tile of :data:`TILES` that leaves room for two blocks
per SM is taken, else the first that fits one.

The library is compiled from the source at first use
(:mod:`repro_torch.kernels.build`), never at import.  The wrapper
launches on the current stream without synchronising, raises on a bad
device, dtype, shape or contiguity and on a failed launch, and counts its
launches in ``flash_attention_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from ..build import bind, build_libraries, launch

SOURCES = {"flash": Path(__file__).resolve().parent / "csrc"
           / "flash_attention.cu"}

# shared memory one block may use on an H100 (232,448 bytes), and what
# each of two blocks on one SM may use (228 KB per SM, 1 KB per block)
SMEM_LIMIT = 227 * 1024
SMEM_TWO_PER_SM = 113 * 1024
# (BQ, BK) candidates, largest first
TILES = ((64, 64), (64, 32), (32, 32), (32, 16), (16, 16), (8, 8))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 4 + [_I] * 8 + [_F, _I, _I, _F, _I, _P]
_FUNCTIONS = {"flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS}
_ERROR = "flash_error_string"
_lib: list = []


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the flash-attention library."""
    if not _lib:
        path, = build_libraries([SOURCES["flash"]])
        _lib.append(bind(path, _FUNCTIONS, _ERROR))
    return _lib[0]


class FlashPlan(NamedTuple):
    bq: int                # query rows per block
    bk: int                # key rows per step
    smem_bytes: int


def flash_smem_bytes(D: int, bq: int, bk: int) -> int:
    """Dynamic shared memory of one block (csrc/flash_attention.cu's
    layout)."""
    return 4 * (2 * bq * D + bk * (D + 1) + bk * D + bq * (bk + 1) + 3 * bq)


def flash_plan(D: int, *, bq: Optional[int] = None,
               bk: Optional[int] = None) -> FlashPlan:
    """The launch plan for head dim D (module docstring); ``bq`` and
    ``bk`` together force a tile.  Pure: the CPU tests plan every shape.
    Raises ValueError for a D no tile fits."""
    if bq is not None and bk is not None:
        smem = flash_smem_bytes(D, bq, bk)
        if smem > SMEM_LIMIT:
            raise ValueError(f"flash tile {bq}x{bk} at D={D} needs {smem} "
                             "bytes of shared memory")
        return FlashPlan(bq, bk, smem)
    for limit in (SMEM_TWO_PER_SM, SMEM_LIMIT):
        for tq, tk in TILES:
            smem = flash_smem_bytes(D, tq, tk)
            if smem <= limit:
                return FlashPlan(tq, tk, smem)
    raise ValueError(f"head dim D={D} does not fit in shared memory")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         plan: Optional[FlashPlan] = None) -> torch.Tensor:
    """Forward attention as one CUDA launch, the value of
    ``kernels/flash_attention/ref.py::attention_ref``.

    q (B, Sq, H, D) and k, v (B, Sk, KV, D): float32 or bfloat16, one
    dtype, contiguous, on one CUDA device, H % KV == 0.  Returns
    (B, Sq, H, D) in q's dtype.  ``plan`` overrides :func:`flash_plan`."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.is_cuda, f"needs CUDA tensors ({name} is on {t.device})")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.ndim == 4, f"{name} must be 4-D, not {tuple(t.shape)}")
    _require(q.device == k.device == v.device, "tensors on several devices")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda: q, k, v must share one dtype, "
                        f"float32 or bfloat16 (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _require(k.shape == (B, Sk, KV, D) and v.shape == k.shape,
             f"k, v must be (B, Sk, KV, D) matching q, not "
             f"{tuple(k.shape)} and {tuple(v.shape)}")
    _require(min(B, Sq, Sk, H, KV, D) > 0 and H % KV == 0,
             f"empty shape or H={H} not a multiple of KV={KV}")
    _require(window >= 0, f"window must be >= 0, not {window}")
    plan = plan or flash_plan(D)
    out = torch.empty_like(q)
    launch(load_library(), "flash_attention_bf16"
           if q.dtype == torch.bfloat16 else "flash_attention_f32", _ERROR,
           q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), B, Sq, Sk, H, KV, D, plan.bq, plan.bk,
           1.0 / math.sqrt(D), int(causal), int(window), float(softcap),
           plan.smem_bytes)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
