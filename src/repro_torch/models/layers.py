"""Parameter specs, initializers and elementary layers, as
``repro/models/layers.py``.

Parameters are built from *specs*: a nested dict (lists for repeated
sub-blocks) whose leaves are ``P(shape, axes, init, scale)``; the logical
``axes`` are kept so the tree matches the reference's, though one card
shards nothing.  :func:`init_params` materializes a spec tree from an
explicit ``torch.Generator``; its numbers differ from ``jax.random``'s,
so the parity tests carry the reference's parameters across instead
(:mod:`.convert`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | small_a
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def is_spec(x: Any) -> bool:
    return isinstance(x, P)


def tree_map(fn: Callable, tree: Any, is_leaf: Callable = is_spec) -> Any:
    """``fn`` over the leaves of a tree of dicts, lists and tuples (dict
    keys visited in sorted order, a NamedTuple's fields in their order, as
    ``jax.tree_util`` does)."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(tree_map(fn, x, is_leaf) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, is_leaf) for x in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree: Any, is_leaf: Callable = is_spec) -> list:
    out: list = []
    tree_map(out.append, tree, is_leaf)
    return out


def init_params(generator: torch.Generator, specs: Dict,
                dtype: torch.dtype = torch.float32) -> Dict:
    """Materialize ``specs`` on the generator's device, leaves drawn in
    the reference's (sorted-key) order."""
    device = generator.device

    def make(spec: P) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "small_a":   # mamba A_log init: log(uniform[1,16])
            u = torch.empty(spec.shape, dtype=torch.float32, device=device)
            u.uniform_(1.0, 16.0, generator=generator)
            return torch.log(u).to(dtype)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None \
            else 1.0 / math.sqrt(fan_in)
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)

    return tree_map(make, specs)


def shapes_tree(specs: Dict) -> Dict:
    return tree_map(lambda s: s.shape, specs)


def param_count(params: Dict) -> int:
    return sum(int(np.prod(x.shape)) for x in
               tree_leaves(params, lambda x: isinstance(x, torch.Tensor)))


# ---------------------------------------------------------------------------
# elementary ops
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the weight stored as ``1 + w``, in float32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (biased variance), in float32."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def norm_spec(cfg, dim: Optional[int] = None) -> Dict:
    d = dim or cfg.d_model
    if cfg.norm == "layernorm":
        return {"w": P((d,), (None,), "ones"), "b": P((d,), (None,), "zeros")}
    return {"w": P((d,), (None,), "zeros")}   # rmsnorm stored as (1 + w)


def apply_norm(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if "b" in params:
        return layernorm(x, params["w"], params["b"], cfg.norm_eps)
    return rmsnorm(x, params["w"], cfg.norm_eps)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """``jax.nn.gelu`` defaults to the tanh approximation, so "gelu" is
    that one (the exact erf form differs by ~1e-3)."""
    if name == "gelu":
        return _gelu_tanh
    return F.silu


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated pairwise; positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)               # (D/2,)
    ang = positions[..., :, None].float() * freqs[None, :]     # (..., S, D/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Whisper's sinusoidal position table (no parameters), (length, dim)
    float32: built in float64 numpy and rounded once, as the reference
    builds it, so the bits match (kept on the host per shape: decode asks
    for it every step)."""
    return torch.tensor(_sinusoidal_table(length, dim), device=device)


@functools.lru_cache(maxsize=8)
def _sinusoidal_table(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=1)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# vocab padding
# ---------------------------------------------------------------------------

def padded_vocab(vocab_size: int, multiple: int = 256) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple
