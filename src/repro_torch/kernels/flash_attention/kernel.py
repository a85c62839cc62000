"""CUDA flash attention: builds, ctypes bindings, launch plans and the
checked wrappers of two forward kernels, one per input type, both on
Hopper's tensor cores, and of two backward kernels, one per input type,
with the autograd function over them (at the end of this module).  The
forward kernels replace
``repro/kernels/flash_attention/kernel.py::flash_attention``: GQA with a
causal mask, a sliding window and a tanh soft-cap, the online softmax in
float32, one block per (batch * head, block of query rows) walking the
key tiles in order, the heaviest causal query blocks first.  They read q
(B, Sq, H, D) and k, v (B, Sk, KV, D) in the model's layout and mask the
ragged edges themselves.

:func:`flash_attention_cuda` (``csrc/flash_attention_mma.cu``) takes
float32: both products as TF32 ``mma.sync`` in three passes (each
operand split in a hi and a lo part; each 8 keys' P V passes summed from
zero and rounded into O), which keeps float32's accuracy,
one warp per 32 query rows (16 at D = 256, or on a grid too small for
the SMs), K and V brought by ``cp.async`` into a ring.
:func:`mma_plan` is its plan, a function of the head dim D and of how
many blocks the grid gives the card's SMs.

:func:`flash_attention_wgmma` (``csrc/flash_attention_wgmma.cu``) takes
bfloat16: both products on wgmma (float32 accumulation), K and V brought
by TMA into a two-stage ring, one block per (batch * head, 128 query
rows).  :func:`wgmma_plan` is its plan, a function of D alone.

:func:`flash_attention_bwd_wgmma` (``csrc/flash_attention_bwd_wgmma.cu``)
is the backward for bfloat16: every product on wgmma, operands by TMA,
three launches (log-sum-exp and delta = sum_j p_ij dP_ij, dK and dV per
key block with a group's query heads split over blocks whose float32
partials the third launch sums in a fixed order, dQ per query block), no
atomics; :func:`bwd_wgmma_plan` and :func:`bwd_wgmma_split` are its
plan.  :func:`flash_attention_bwd_cuda` (``csrc/flash_attention_bwd_mma.cu``)
is the backward for float32: every product as TF32 ``mma.sync`` in three
passes, three launches (log-sum-exp and rowsum(dO o), dK and dV per key
block with a group's heads split as the bfloat16 kernel splits them, dQ
per query block), no atomics; :func:`bwd_plan` and :func:`bwd_split` are
its plan.  :class:`FlashAttention` runs a forward kernel and saves q, k, v
(and o for float32) for the backward of the inputs' dtype
(:func:`backward_kernel`).  Neither backward replaces a Pallas kernel:
the reference differentiates its jnp attention with
``jax.value_and_grad``.  The forward wrappers refuse inputs that need a
gradient under grad mode (:func:`refuse_grad`): their outputs have no
autograd graph.

All four sources are built for the head dims of :data:`WGMMA_HEAD_DIMS`.
The libraries are compiled from the sources at first use
(:mod:`repro_torch.kernels.build`), never at import.  Each wrapper
launches on the current stream without synchronising, raises on a bad
device, dtype, shape, head dim or contiguity and on a failed launch, and
counts its launches (``flash_attention_cuda.launches``,
``flash_attention_wgmma.launches``, ``flash_attention_bwd_cuda.launches``,
``flash_attention_bwd_wgmma.launches``: one a call, a backward's three
kernels together).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from ..build import bind, build_libraries, launch

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"flash_mma": _CSRC / "flash_attention_mma.cu",
           "flash_wgmma": _CSRC / "flash_attention_wgmma.cu",
           "flash_bwd": _CSRC / "flash_attention_bwd_mma.cu",
           "flash_bwd_wgmma": _CSRC / "flash_attention_bwd_wgmma.cu"}

# shared memory one block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024
# the head dims both sources are built for: the smoke configs' 16, the
# kernel tests' 64/128/256 and Zamba2-7B's 112
WGMMA_HEAD_DIMS = (16, 64, 112, 128, 256)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FUNCTIONS = {"flash_attention_mma_f32": [_P] * 4 + [_I] * 7
              + [_F, _I, _I, _F, _I, _P]}
_ERROR = "flash_mma_error_string"
_WGMMA_FUNCTIONS = {"flash_attention_wgmma_bf16": [_P] * 4 + [_I] * 6
                    + [_F, _I, _I, _F, _I, _P]}
_WGMMA_ERROR = "flash_wgmma_error_string"
_BWD_FUNCTIONS = {"flash_attention_bwd_f32": [_P] * 11 + [_I] * 7
                  + [_F, _I, _I, _F, _I, _I, _I, _P]}
_BWD_ERROR = "flash_bwd_error_string"
_BWD_WGMMA_FUNCTIONS = {"flash_attention_bwd_wgmma_bf16": [_P] * 10
                        + [_I] * 7 + [_F, _I, _I, _F, _I, _I, _P]}
_BWD_WGMMA_ERROR = "flash_bwd_wgmma_error_string"
_libs: dict = {}


def _load(name: str, functions: dict, error: str) -> ctypes.CDLL:
    if name not in _libs:
        path, = build_libraries([SOURCES[name]])
        _libs[name] = bind(path, functions, error)
    return _libs[name]


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the float32 kernel's
    library."""
    return _load("flash_mma", _FUNCTIONS, _ERROR)


def load_wgmma_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the bfloat16 kernel's
    library."""
    return _load("flash_wgmma", _WGMMA_FUNCTIONS, _WGMMA_ERROR)


def load_bwd_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the float32 backward
    kernels' library."""
    return _load("flash_bwd", _BWD_FUNCTIONS, _BWD_ERROR)


def load_bwd_wgmma_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the bfloat16 backward
    kernels' library."""
    return _load("flash_bwd_wgmma", _BWD_WGMMA_FUNCTIONS, _BWD_WGMMA_ERROR)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel that writes into a buffer of its own (no
    autograd graph) is called with grad mode on and an input that
    requires a gradient: its output would silently cut the gradient.
    The differentiable entry is :class:`FlashAttention` (through
    ``ops.attention_op``), inside whose ``forward`` grad mode is off."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires a gradient and the kernel's output "
            "has no autograd graph; call ops.attention_op (FlashAttention)")


# ---------------------------------------------------------------------------
# float32: TF32 mma.sync in three passes
# ---------------------------------------------------------------------------

# SMs of an H100 SXM: the card the CPU tests plan for
H100_SMS = 132


class MmaPlan(NamedTuple):
    bq: int                # query rows per block
    bk: int                # keys per tile
    warps: int
    tiles: int             # 16-row tiles a warp
    stages: int            # K/V tiles in the ring
    smem_bytes: int


def mma_plan(D: int, batch_heads: int, Sq: int,
             sms: int = H100_SMS) -> MmaPlan:
    """The float32 kernel's plan for head dim D and a grid of
    ``batch_heads`` (B * H) times the query blocks of ``Sq`` rows on a
    card of ``sms`` SMs.  Up to D = 128: 8 warps of two 16-row tiles
    (which share every K and V fragment), 32 keys a tile, when there are
    at least 1.5 ``sms`` of those 256-row blocks; below that (short
    prompts, few heads), 8 warps of one tile and 64 keys a tile, twice
    the blocks, whose finer grain evens out the causal blocks' unequal
    work over the SMs.  ``tools/flash_f32_probe.py`` on an H100 (132
    SMs, 32 heads, D 112): one tile was 35 % faster at 128 blocks and
    6 % at 192, two tiles 6 % faster at 256 and 4 % at 1,024.  At
    D = 256, whose O accumulator alone is 128 floats a thread: 4 warps
    of one tile, 32 keys a tile.  Keys per tile 64 up to D = 64; two
    stages.  Its bytes are the source's
    ``Plan<D, kWarpsFor(D), tiles>``: Q and ``stages`` K and V tiles,
    every row D + 4 floats; the launcher refuses any other count.  Pure:
    the CPU tests plan every D.  Raises ValueError for a D the kernel is
    not built for."""
    if D not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim D={D} is not "
                         f"built (one of {WGMMA_HEAD_DIMS})")
    warps = 8 if D <= 128 else 4
    blocks = batch_heads * -(-Sq // 256)
    tiles = 2 if D <= 128 and 2 * blocks >= 3 * sms else 1
    bk = 64 if D <= 64 or (tiles == 1 and D <= 128) else 32
    bq, stages = 16 * tiles * warps, 2
    smem = 4 * (D + 4) * (bq + 2 * stages * bk)
    return MmaPlan(bq, bk, warps, tiles, stages, smem)


def _sms(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Forward attention in float32 as one tensor-core launch, the value
    of ``kernels/flash_attention/ref.py::attention_ref``.

    q (B, Sq, H, D) and k, v (B, Sk, KV, D): float32, contiguous, 16-byte
    aligned, on one CUDA device, H % KV == 0, D one of
    :data:`WGMMA_HEAD_DIMS`.  Returns (B, Sq, H, D) float32."""
    if not all(t.dtype == torch.float32 for t in (q, k, v)):
        raise TypeError("flash_attention_cuda: q, k, v must be float32 "
                        f"(bfloat16 goes to flash_attention_wgmma; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.ndim == 4, f"{name} must be 4-D, not {tuple(t.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    plan = mma_plan(D, B * H, Sq, _sms(q.device) if q.is_cuda else H100_SMS)
    _require(k.shape == (B, Sk, KV, D) and v.shape == k.shape,
             f"k, v must be (B, Sk, KV, D) matching q, not "
             f"{tuple(k.shape)} and {tuple(v.shape)}")
    _require(min(B, Sq, Sk, H, KV) > 0 and H % KV == 0,
             f"empty shape or H={H} not a multiple of KV={KV}")
    _require(window >= 0, f"window must be >= 0, not {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.is_cuda, f"needs CUDA tensors ({name} is on {t.device})")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{name} must be contiguous and 16-byte aligned")
    _require(q.device == k.device == v.device, "tensors on several devices")
    refuse_grad("flash_attention_cuda", q, k, v)
    out = torch.empty_like(q)
    launch(load_library(), "flash_attention_mma_f32", _ERROR, q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
           Sk, H, KV, D, plan.tiles, 1.0 / math.sqrt(D), int(causal),
           int(window), float(softcap), plan.smem_bytes)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# bfloat16 on the tensor cores
# ---------------------------------------------------------------------------

WGMMA_BQ = 128          # query rows per block: two warpgroups of 64
_ROW_BYTES = 128        # one swizzled row: 64 bf16 columns
_ALIGN = 1024           # the 128-byte swizzle's 8-row atom


class WgmmaPlan(NamedTuple):
    bq: int                # query rows per block
    bk: int                # keys per tile
    stages: int            # K/V tiles in the ring
    smem_bytes: int


def wgmma_plan(D: int) -> WgmmaPlan:
    """The tensor-core kernel's plan for head dim D: keys per tile 128 up
    to D = 128 and 64 above (D = 256, whose O accumulator alone is 128
    floats a thread), two stages.  Its bytes are the source's
    ``Layout<D>``: the alignment slack, Q and ``stages`` K and V tiles as
    64-column chunks of 128-byte rows, and the mbarriers (Q full, one
    full and one empty per stage); the launcher refuses any other count.
    Pure: the CPU tests plan every D.  Raises ValueError for a D the
    kernel is not built for."""
    if D not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_attention_wgmma: head dim D={D} is not "
                         f"built (one of {WGMMA_HEAD_DIMS})")
    bk, stages, chunks = (128 if D <= 128 else 64), 2, -(-D // 64)
    smem = (_ALIGN + chunks * WGMMA_BQ * _ROW_BYTES
            + stages * 2 * chunks * bk * _ROW_BYTES + 8 * (1 + 2 * stages))
    return WgmmaPlan(WGMMA_BQ, bk, stages, smem)


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """Forward attention in bfloat16 as one tensor-core launch, the value
    of ``kernels/flash_attention/ref.py::attention_ref`` with P rounded to
    bfloat16 before P V.

    q (B, Sq, H, D) and k, v (B, Sk, KV, D): bfloat16, contiguous,
    16-byte aligned, on one CUDA device, H % KV == 0, D one of
    :data:`WGMMA_HEAD_DIMS`.  Returns (B, Sq, H, D) bfloat16."""
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        raise TypeError("flash_attention_wgmma: q, k, v must be bfloat16 "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"flash_attention_wgmma: {name} must be 4-D, "
                             f"not {tuple(t.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    plan = wgmma_plan(D)
    if k.shape != (B, Sk, KV, D) or v.shape != k.shape:
        raise ValueError("flash_attention_wgmma: k, v must be (B, Sk, KV, "
                         f"D) matching q, not {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if min(B, Sq, Sk, H, KV) <= 0 or H % KV:
        raise ValueError(f"flash_attention_wgmma: empty shape or H={H} not "
                         f"a multiple of KV={KV}")
    if window < 0:
        raise ValueError(f"flash_attention_wgmma: window must be >= 0, not "
                         f"{window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError("flash_attention_wgmma: needs CUDA tensors "
                             f"({name} is on {t.device})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_wgmma: {name} must be "
                             "contiguous and 16-byte aligned")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention_wgmma: tensors on several devices")
    refuse_grad("flash_attention_wgmma", q, k, v)
    out = torch.empty_like(q)
    launch(load_wgmma_library(), "flash_attention_wgmma_bf16", _WGMMA_ERROR,
           q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), B, Sq, Sk, H, KV, D, 1.0 / math.sqrt(D),
           int(causal), int(window), float(softcap), plan.smem_bytes)
    flash_attention_wgmma.launches += 1
    return out


flash_attention_wgmma.launches = 0


# ---------------------------------------------------------------------------
# the backward: float32 and bfloat16 on the tensor cores, and the
# autograd function
# ---------------------------------------------------------------------------

# the groups of four partial elements each thread of the float32
# backward's summing blocks (the dq launch's last) adds up
_BWD_SUM_GROUPS = 8


class BwdPlan(NamedTuple):
    bq: int                # query rows a prep or dq block (16 a warp)
    bk: int                # keys a K/V tile of the prep and dq launches
    bkv: int               # keys a dkdv block (16 a key group of warps)
    bqd: int               # query rows a Q/dO tile of the dkdv launch
    stages: int            # tiles in each ring
    d_split: int           # dkdv warps sharing a key group's D columns
    smem_prep: int         # bytes of a prep block
    smem_dq: int           # bytes of a dq block
    smem_kv: int           # bytes of a dkdv block


def bwd_plan(D: int) -> BwdPlan:
    """The float32 backward's plan for head dim D.  Prep and dq: 8 warps
    of 16 query rows a block (4 at D = 256, whose Q and dO alone take
    133 KB), K/V tiles of 32 keys (16 at D = 256) in two stages.  dkdv: 8
    warps, 8 key groups of 16 keys (128 keys a block), or at D = 256 4
    key groups times 2 column halves of dK and dV (64 keys; 16 keys' dK
    and dV would be 256 floats a thread); Q/dO tiles of 32 rows (16 at
    D = 256) with their rows' lse and delta in two stages.  Every shared
    row is D + 4 floats.  Its bytes are the source's
    ``Rows<D>::kSmemPrep`` (Q, the K ring), ``Rows<D>::kSmemDq`` (Q, dO,
    the K and V ring) and ``Cols<D>::kSmem`` (K, V, the Q and dO ring,
    the ring's lse and delta); the launcher refuses any other count.
    Pure: the CPU tests plan every D.  Raises ValueError for a D the
    kernel is not built for."""
    if D not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_cuda: head dim D={D} is not "
                         f"built (one of {WGMMA_HEAD_DIMS})")
    small = D <= 128
    bq, bk, groups, bqd, stages = (128 if small else 64, 32 if small else 16,
                                   8 if small else 4, 32 if small else 16, 2)
    row = 4 * (D + 4)
    return BwdPlan(bq, bk, 16 * groups, bqd, stages, 8 // groups,
                   row * (bq + stages * bk), row * (2 * bq + 2 * stages * bk),
                   row * (2 * 16 * groups + 2 * stages * bqd)
                   + 4 * 2 * stages * bqd)


def bwd_split(B: int, KV: int, G: int, Sk: int, D: int,
              sms: int = H100_SMS) -> int:
    """How many dkdv blocks of the float32 backward share a group's G
    query heads: the fewest (a divisor of G) that give the launch at
    least 1.5 blocks for each of ``sms`` SMs, else G, the rule of
    :func:`bwd_wgmma_split` over this kernel's key blocks.  1 writes dK
    and dV straight; more write float32 partials that the dq launch sums
    in split order.  Pure."""
    return _head_split(B * KV * -(-Sk // bwd_plan(D).bkv), G, sms)


def _head_split(blocks: int, G: int, sms: int) -> int:
    """The fewest of a group's G query heads' divisors that give a dkdv
    launch of ``blocks`` blocks a split at least 1.5 blocks for each of
    ``sms`` SMs, else G."""
    return next((n for n in range(1, G + 1)
                 if G % n == 0 and 2 * blocks * n >= 3 * sms), G)


def bwd_grids(B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
              sms: int = H100_SMS) -> Tuple[int, int, int, int]:
    """The float32 backward's split (:func:`bwd_split`) and its three
    launches' blocks, as the source's launcher sizes them: prep (one per
    batch * head and ``bq`` query rows), dkdv (one per ``bkv`` keys,
    batch, KV head and split), dq (prep's, and with a split the blocks
    that sum the partials, eight groups of four elements a thread).
    Pure."""
    plan = bwd_plan(D)
    n_split = bwd_split(B, KV, H // KV, Sk, D, sms)
    rows = -(-Sq // plan.bq) * B * H
    keys = -(-Sk // plan.bkv) * B * KV * n_split
    per_block = 32 * (plan.bq // 16) * _BWD_SUM_GROUPS
    sums = -(-(B * Sk * KV * D // 2) // per_block) if n_split > 1 else 0
    return n_split, rows, keys, rows + sums


def _bwd_checks(name, plan_of, tensors, window):
    """The backward wrappers' shared checks, in order: ranks, the head
    dim (``plan_of(D)`` raises for one not built), shapes, window,
    device, contiguity and alignment; ``tensors`` maps names to the
    inputs, q, k and v among them.  Returns (plan, (B, Sq, Sk, H, KV,
    D))."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")
    for n, t in tensors.items():
        require(t.ndim == 4, f"{n} must be 4-D, not {tuple(t.shape)}")
    q, k, v = tensors["q"], tensors["k"], tensors["v"]
    B, Sq, H, D = q.shape
    plan = plan_of(D)
    Sk, KV = k.shape[1], k.shape[2]
    require(k.shape == (B, Sk, KV, D) and v.shape == k.shape,
            f"k, v must be (B, Sk, KV, D) matching q, not {tuple(k.shape)} "
            f"and {tuple(v.shape)}")
    others = {n: t for n, t in tensors.items() if n not in "qkv"}
    require(all(t.shape == q.shape for t in others.values()),
            f"{', '.join(others)} must be q's shape {tuple(q.shape)}, not "
            + " and ".join(str(tuple(t.shape)) for t in others.values()))
    require(min(B, Sq, Sk, H, KV) > 0 and H % KV == 0,
            f"empty shape or H={H} not a multiple of KV={KV}")
    require(window >= 0, f"window must be >= 0, not {window}")
    for n, t in tensors.items():
        require(t.is_cuda, f"needs CUDA tensors ({n} is on {t.device})")
        require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"{n} must be contiguous and 16-byte aligned")
    require(len({t.device for t in tensors.values()}) == 1,
            "tensors on several devices")
    return plan, (B, Sq, Sk, H, KV, D)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradients of attention (``ref.py::attention_ref``'s function,
    the forward kernels' masks) with respect to q, k and v in float32,
    from the forward's output ``o`` and its incoming gradient ``do``, as
    three launches of ``csrc/flash_attention_bwd_mma.cu`` on the tensor
    cores, every product TF32 ``mma.sync`` in three passes: log-sum-exp
    and rowsum(dO o), then dK and dV, then dQ (and the sum of dK's and
    dV's partials when :func:`bwd_split` splits a group's heads).
    bfloat16 goes to :func:`flash_attention_bwd_wgmma`.

    q, o, do (B, Sq, H, D) and k, v (B, Sk, KV, D): float32, contiguous,
    16-byte aligned, on one CUDA device, H % KV == 0, D one of
    :data:`WGMMA_HEAD_DIMS`.  Returns (dq, dk, dv) in float32 and the
    inputs' shapes; dk and dv summed over each KV head's query heads in a
    fixed order, with no atomics.  Counts one launch a call
    (``flash_attention_bwd_cuda.launches``)."""
    tensors = {"q": q, "k": k, "v": v, "o": o, "do": do}
    dtypes = [getattr(t, "dtype", None) for t in tensors.values()]
    if any(dt != torch.float32 for dt in dtypes):
        raise TypeError("flash_attention_bwd_cuda: q, k, v, o, do must all "
                        "be float32 tensors (bfloat16 goes to "
                        "flash_attention_bwd_wgmma; got "
                        + ", ".join(map(str, dtypes)) + ")")
    plan, (B, Sq, Sk, H, KV, D) = _bwd_checks(
        "flash_attention_bwd_cuda", bwd_plan, tensors, window)
    n_split = bwd_split(B, KV, H // KV, Sk, D, _sms(q.device))
    sq_pad = -(-Sq // plan.bq) * plan.bq
    lse = torch.empty((B * H, sq_pad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    part = (torch.empty((2, n_split, B, Sk, KV, D), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch(load_bwd_library(), "flash_attention_bwd_f32", _BWD_ERROR,
           q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           lse.data_ptr(), delta.data_ptr(),
           0 if part is None else part.data_ptr(), B, Sq, Sk, H, KV, D,
           n_split, 1.0 / math.sqrt(D), int(causal), int(window),
           float(softcap), plan.smem_prep, plan.smem_dq, plan.smem_kv)
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


BWD_WGMMA_BKV = 128     # keys a block of the dkdv launch: two warpgroups


class BwdWgmmaPlan(NamedTuple):
    bq: int                # query rows a prep or dq block (two warpgroups)
    bk: int                # keys a K/V tile of the prep and dq launches
    bkv: int               # keys a dkdv block (two warpgroups)
    bqd: int               # query rows a Q/dO tile of the dkdv launch
    stages: int            # tiles in each ring
    d_split: int           # dkdv blocks over dK's and dV's D columns
    smem_q: int            # bytes of a prep or dq block
    smem_k: int            # bytes of a dkdv block


def bwd_wgmma_plan(D: int) -> BwdWgmmaPlan:
    """The bfloat16 backward's plan for head dim D.  Prep and dq: 128
    query rows a block, K/V tiles of 64 keys (32 at D = 256, where Q and
    dO alone take 128 KB) in two stages.  dkdv: 128 keys a block, Q/dO
    tiles of 64 rows (32 at D = 256) with their rows' lse and delta in two
    stages, and at D = 256 two blocks over dK's and dV's columns (both
    accumulators of 64 keys would be 256 floats a thread).  Its bytes are
    the source's ``QLayout<D>::kSmem`` and ``KLayout<D>::kSmem``: the
    alignment slack, the held tiles and the ring as 64-column chunks of
    128-byte rows, the ring's lse and delta (dkdv), and the mbarriers; the
    launcher refuses any other count.  Pure: the CPU tests plan every D.
    Raises ValueError for a D the kernel is not built for."""
    if D not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_wgmma: head dim D={D} is "
                         f"not built (one of {WGMMA_HEAD_DIMS})")
    chunks, stages = -(-D // 64), 2
    bk = bqd = 64 if D <= 128 else 32
    bars = 8 * (1 + 2 * stages)
    smem_q = (_ALIGN + 2 * chunks * WGMMA_BQ * _ROW_BYTES
              + stages * 2 * chunks * bk * _ROW_BYTES + bars)
    smem_k = (_ALIGN + 2 * chunks * BWD_WGMMA_BKV * _ROW_BYTES
              + stages * (2 * chunks * bqd * _ROW_BYTES + 2 * bqd * 4)
              + bars)
    return BwdWgmmaPlan(WGMMA_BQ, bk, BWD_WGMMA_BKV, bqd, stages,
                        2 if D > 128 else 1, smem_q, smem_k)


def bwd_wgmma_split(B: int, KV: int, G: int, Sk: int, D: int,
                    sms: int = H100_SMS) -> int:
    """How many dkdv blocks share a group's G query heads: the fewest (a
    divisor of G) that give the launch at least 1.5 blocks for each of
    ``sms`` SMs, else G.  1 writes dK and dV straight; more write float32
    partials that the dq launch sums in split order.  At StarCoder2-3B's
    training shape (64 blocks unsplit) ``tools/flash_bwd_probe.py`` timed
    the whole backward at 1.49 ms unsplit, 0.97 / 0.80 / 0.73 / 0.75 /
    0.77 ms split over 2 / 3 / 4 / 6 / 12 (H100): 4 is the pick.  Pure."""
    plan = bwd_wgmma_plan(D)
    return _head_split(B * KV * -(-Sk // plan.bkv) * plan.d_split, G, sms)


# threads of a block of the bfloat16 backward, and the groups of four
# partial elements each of them sums in the dq launch's last blocks
_BWD_WGMMA_THREADS, _BWD_WGMMA_SUM_GROUPS = 384, 8


def bwd_wgmma_grids(B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
                    sms: int = H100_SMS) -> Tuple[int, int, int, int]:
    """The bfloat16 backward's split (:func:`bwd_wgmma_split`) and its
    three launches' blocks, as the source's launcher sizes them: prep
    (one per batch * head and 128 query rows), dkdv (one per 128 keys,
    batch, KV head, split and column half), dq (prep's, and with a split
    the blocks that sum the partials, eight groups of four elements a
    thread).  Pure."""
    plan = bwd_wgmma_plan(D)
    n_split = bwd_wgmma_split(B, KV, H // KV, Sk, D, sms)
    prep = -(-Sq // plan.bq) * B * H
    dkdv = -(-Sk // plan.bkv) * B * KV * n_split * plan.d_split
    per_block = _BWD_WGMMA_THREADS * _BWD_WGMMA_SUM_GROUPS
    sums = -(-(B * Sk * KV * D // 2) // per_block) if n_split > 1 else 0
    return n_split, prep, dkdv, prep + sums


def flash_attention_bwd_wgmma(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The gradients of attention (``ref.py::attention_ref``'s function,
    the forward kernels' masks) with respect to q, k and v in bfloat16,
    from the incoming gradient ``do``, as three launches of
    ``csrc/flash_attention_bwd_wgmma.cu`` on the tensor cores: log-sum-exp
    and delta = sum_j p_ij dP_ij (rowsum(dO o O) without O), then dK and
    dV, then dQ (and the sum of dK's and dV's partials when
    :func:`bwd_wgmma_split` splits a group's heads).  P and dS are
    rounded to bfloat16 as the products' operands; every sum is float32.

    q, do (B, Sq, H, D) and k, v (B, Sk, KV, D): bfloat16, contiguous,
    16-byte aligned, on one CUDA device, H % KV == 0, D one of
    :data:`WGMMA_HEAD_DIMS`.  Returns (dq, dk, dv) in bfloat16 and the
    inputs' shapes; dk and dv summed over each KV head's query heads in a
    fixed order, with no atomics.  Counts one launch a call
    (``flash_attention_bwd_wgmma.launches``)."""
    tensors = {"q": q, "k": k, "v": v, "do": do}
    if not all(t.dtype == torch.bfloat16 for t in tensors.values()):
        raise TypeError("flash_attention_bwd_wgmma: q, k, v, do must all be "
                        "bfloat16 (float32 goes to flash_attention_bwd_cuda;"
                        " got " + ", ".join(str(t.dtype)
                                            for t in tensors.values()) + ")")
    plan, (B, Sq, Sk, H, KV, D) = _bwd_checks(
        "flash_attention_bwd_wgmma", bwd_wgmma_plan, tensors, window)
    n_split = bwd_wgmma_split(B, KV, H // KV, Sk, D, _sms(q.device))
    sq_pad = -(-Sq // plan.bq) * plan.bq
    lse = torch.empty((B * H, sq_pad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    part = (torch.empty((2, n_split, B, Sk, KV, D), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch(load_bwd_wgmma_library(), "flash_attention_bwd_wgmma_bf16",
           _BWD_WGMMA_ERROR, q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           0 if part is None else part.data_ptr(), B, Sq, Sk, H, KV, D,
           n_split, 1.0 / math.sqrt(D), int(causal), int(window),
           float(softcap), plan.smem_q, plan.smem_k)
    flash_attention_bwd_wgmma.launches += 1
    return dq, dk, dv


flash_attention_bwd_wgmma.launches = 0


def forward_kernel(dtype: torch.dtype):
    """The forward kernel a dtype goes to: bfloat16 to the wgmma kernel,
    any other to the TF32 kernel (which refuses all but float32)."""
    return (flash_attention_wgmma if dtype == torch.bfloat16
            else flash_attention_cuda)


def backward_kernel(dtype: torch.dtype):
    """The backward kernel a dtype goes to: bfloat16 to the wgmma kernel
    (``f(q, k, v, do, ...)``), any other to the TF32 kernel
    (``f(q, k, v, o, do, ...)``, which refuses all but float32)."""
    return (flash_attention_bwd_wgmma if dtype == torch.bfloat16
            else flash_attention_bwd_cuda)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient on the card: the forward kernel of the
    inputs' dtype (:func:`forward_kernel`), then the backward kernel of
    that dtype (:func:`backward_kernel`).  Saves q, k, v, and the output
    o for float32 only (the bfloat16 backward takes delta from dP, with
    no O); under ``torch.utils.checkpoint`` the forward runs again in the
    backward pass (one more forward launch)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float):
        o = forward_kernel(q.dtype)(q, k, v, causal=causal, window=window,
                                    softcap=softcap)
        ctx.save_for_backward(q, k, v,
                              o if q.dtype == torch.float32 else None)
        ctx.mask = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        kernel = backward_kernel(q.dtype)
        args = (q, k, v, do.contiguous()) if o is None else (
            q, k, v, o, do.contiguous())
        dq, dk, dv = kernel(*args, causal=causal, window=window,
                            softcap=softcap)
        return dq, dk, dv, None, None, None
