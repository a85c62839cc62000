"""AdamW with global-norm clipping, a warmup-cosine schedule and optional
bfloat16 first and second moments, as ``repro/train/optimizer.py``: the
same state (step, mu, nu over the parameter tree), the same arithmetic in
the same order, in float32.

:func:`apply_updates` writes the new parameters, moments and step into
the tensors it was given and returns them, where the reference returns
new arrays: at StarCoder2-3B's 3.03e9 float32 parameters, new copies
beside the old ones would not fit one card.  Each leaf's temporaries are
freed before the next leaf's are made.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple, Union

import torch

from ..models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory


class OptState(NamedTuple):
    step: torch.Tensor              # int32 scalar, steps taken
    mu: Any
    nu: Any


def _is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def init_opt(params: Any, cfg: OptConfig) -> OptState:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, step 0
    on the parameters' device."""
    dt = getattr(torch, cfg.moment_dtype)
    first = tree_leaves(params, _is_tensor)[0]

    def zeros(p):
        return torch.zeros_like(p, dtype=dt)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    mu=tree_map(zeros, params, _is_tensor),
                    nu=tree_map(zeros, params, _is_tensor))


def schedule(cfg: OptConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate after ``step`` steps (float32 scalar): linear
    warmup over ``warmup_steps``, then a cosine down to ``min_lr_ratio``
    of ``lr`` at ``total_steps``."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over the leaves (in tree order) of each leaf's sum
    of squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree, _is_tensor)))


def _update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor, scale: torch.Tensor, lr: torch.Tensor,
            bc1: torch.Tensor, bc2: torch.Tensor, cfg: OptConfig) -> None:
    """One leaf's AdamW step in float32, the reference's ``upd``, written
    into ``p``, ``m`` and ``v``: m = m b1 + g (1 - b1), v = v b2 + g g
    (1 - b2), p -= lr (m^ / (sqrt(v^) + eps) + wd p)."""
    g32 = g.float() * scale
    if m.dtype == torch.float32:
        m32 = m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    else:
        m32 = m.float() * cfg.b1 + g32 * (1 - cfg.b1)
    sq = g32.mul_(g32).mul_(1 - cfg.b2)
    del g32
    if v.dtype == torch.float32:
        v32 = v.mul_(cfg.b2).add_(sq)
    else:
        v32 = v.float() * cfg.b2 + sq
    del sq
    den = (v32 / bc2).sqrt_().add_(cfg.eps)
    step = (m32 / bc1).div_(den)
    del den
    step.add_(cfg.weight_decay * p.float()).mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(p.float() - step)
    if m32 is not m:
        m.copy_(m32)
    if v32 is not v:
        v.copy_(v32)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: OptState, cfg: OptConfig
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """AdamW over the tree: the gradients clipped to a global norm of
    ``cfg.clip_norm``, the step's learning rate from :func:`schedule`,
    bias-corrected moments.  Writes the parameters, the moments and the
    state's step in place and returns (params, state, {"grad_norm",
    "lr"}), both metrics float32 scalars on the device."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step).to(gnorm.device)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    for p, g, m, v in zip(tree_leaves(params, _is_tensor),
                          tree_leaves(grads, _is_tensor),
                          tree_leaves(state.mu, _is_tensor),
                          tree_leaves(state.nu, _is_tensor)):
        _update(p, g, m, v, scale, lr, bc1, bc2, cfg)
    state.step.add_(1)
    return params, state, {"grad_norm": gnorm, "lr": lr}
