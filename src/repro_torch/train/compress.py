"""int8 error-feedback gradient compression, as
``repro/train/compress.py``: each tensor quantized to int8 with one
float32 scale (its max magnitude over 127), the residual kept locally and
added back at the next step (error feedback keeps convergence).

The reference quantizes before the data-parallel reduction XLA emits; on
one card there is no reduction, so :func:`compress_grads` is the same
round trip applied where the reference's train step applies it.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.layers import tree_leaves, tree_map


def _is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 scalar): q = clip(round(x / scale), -127,
    127), scale = max(max |x|, 1e-12) / 127; ``round`` is half to even, as
    ``jnp.round``."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Any) -> Any:
    """The int8 round trip of every leaf (computed in float32, returned in
    the leaf's dtype): the stateless form the train step applies; the
    residual-carrying form is :class:`ErrorFeedback`."""
    def one(g):
        q, s = quantize_int8(g.float())
        return dequantize(q, s).to(g.dtype)
    return tree_map(one, grads, _is_tensor)


class ErrorFeedback:
    """Stateful residual accumulator: g_t' = Q(g_t + r_{t-1});
    r_t = (g_t + r_{t-1}) - g_t'.  The state is a tree like the
    gradients', in float32."""

    @staticmethod
    def init(grads: Any) -> Any:
        return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                        grads, _is_tensor)

    @staticmethod
    def apply(grads: Any, residual: Any) -> Tuple[Any, Any]:
        res = iter(tree_leaves(residual, _is_tensor))
        new_r = []

        def one(g):
            x = g.float() + next(res)
            deq = dequantize(*quantize_int8(x))
            new_r.append(x - deq)
            return deq.to(g.dtype)
        new_g = tree_map(one, grads, _is_tensor)
        it = iter(new_r)
        return new_g, tree_map(lambda _: next(it), residual, _is_tensor)
