"""The train step: loss (cross-entropy + z-loss + MoE aux + MTP),
backward, optional int8 gradient compression, AdamW, as
``repro/train/steps.py``.

``make_train_step(cfg, opt_cfg, hyper, device)`` returns ``step(params,
opt_state, batch) -> (params, opt_state, metrics)``.  Gradients come from
``torch.autograd.grad`` through :func:`repro_torch.models.model.
forward_train` (the flash kernels' autograd function on the card).  One
card has no mesh: the reference's sharding hooks (``constrain``,
``constrain_h``, ``constrain_ssm``, ``constrain_qkv``) and its
``NamedSharding`` in/out specs have no counterpart, and the step is a
plain function rather than a (fn, in_shardings, out_shardings) triple.
The step updates the parameters and optimizer state it is given in place
and returns them (``optimizer.apply_updates``): a
second copy of a full-size model's state would not fit one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.layers import tree_leaves, tree_map
from ..models.model import forward_train
from .compress import compress_grads
from .optimizer import OptConfig, OptState, apply_updates


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    z_loss: float = 1e-4
    mtp_weight: float = 0.3
    grad_compress: bool = False
    grad_accum: int = 1       # microbatches per step (activation memory / k)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                  z_coef: float) -> torch.Tensor:
    """Mean cross-entropy over the tokens whose label is >= 0, plus
    ``z_coef`` lse^2 (the z-loss), with the padded vocabulary's tail
    (columns >= ``vocab``) masked to -1e30.  The label's logit is
    gathered, the value the reference's one-hot contraction takes."""
    vpad = logits.shape[-1]
    if vpad > vocab:
        tail = torch.arange(vpad, device=logits.device) >= vocab
        logits = logits + torch.where(tail, -1e30, 0.0).to(logits.dtype)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None]
                      )[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - ll) * mask
    z = z_coef * torch.square(lse) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll.sum() + z.sum()) / denom


def loss_fn(params: Any, cfg: ModelConfig, batch: Dict, hyper: TrainHyper
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"ce", "loss", and "mtp" for DeepSeek-V3}): CE with the
    z-loss, plus the MoE aux loss, plus ``mtp_weight`` times the MTP
    head's CE on the labels shifted once more (the last position -1)."""
    logits, aux = forward_train(params, cfg, batch)
    loss = cross_entropy(logits, batch["labels"], cfg.vocab_size,
                         hyper.z_loss)
    metrics = {"ce": loss}
    loss = loss + aux["moe_aux"]
    if "mtp_logits" in aux:
        lbl = batch["labels"]
        mtp_labels = torch.cat([lbl[:, 1:], torch.full_like(lbl[:, :1], -1)],
                               dim=1)
        mtp_loss = cross_entropy(aux["mtp_logits"], mtp_labels,
                                 cfg.vocab_size, 0.0)
        loss = loss + hyper.mtp_weight * mtp_loss
        metrics["mtp"] = mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def _is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def value_and_grad(params: Any, cfg: ModelConfig, batch: Dict,
                   hyper: TrainHyper
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """(detached metrics, the loss's gradient for every tensor leaf of
    ``params`` in tree order), the counterpart of
    ``jax.value_and_grad(loss_fn, has_aux=True)``.  The leaves are
    differentiated through detached aliases, so the caller's tensors
    keep ``requires_grad`` as they were; a leaf the loss does not reach
    gets zeros."""
    leaves = tree_leaves(params, _is_tensor)
    alias = [x.detach().requires_grad_() for x in leaves]
    it = iter(alias)
    p = tree_map(lambda _: next(it), params, _is_tensor)
    with torch.enable_grad():
        loss, metrics = loss_fn(p, cfg, batch, hyper)
        grads = torch.autograd.grad(loss, alias, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return {k: v.detach() for k, v in metrics.items()}, grads


def batch_to(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``: integer arrays
    (tokens, labels) as int64, others as given."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    hyper: TrainHyper = TrainHyper(),
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on ``device`` (None: the card).  ``batch`` holds numpy arrays or
    tensors ("tokens", "labels", Whisper's "frames", pixtral's
    "patch_embeds"); metrics are float32 scalars on the device ("ce",
    "loss", "grad_norm", "lr", and "mtp" for DeepSeek-V3).

    With ``hyper.grad_accum = k`` the batch is cut into k microbatches
    along its first axis; each microbatch's gradient, divided by k, is
    added to a float32 sum in order, which is then cast to each
    parameter's dtype, and the metrics are averaged likewise: the
    reference's scan.  ``hyper.grad_compress`` passes the gradients
    through :func:`.compress.compress_grads` before the update."""
    dev = resolve_device(device)
    k_acc = hyper.grad_accum

    def step(params: Any, opt_state: OptState, batch: Dict):
        batch = batch_to(batch, dev)
        if k_acc > 1:
            micro = {k: v.reshape((k_acc, v.shape[0] // k_acc) + v.shape[1:])
                     for k, v in batch.items()}
            leaves = tree_leaves(params, _is_tensor)
            g_acc = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            m_acc: Dict[str, torch.Tensor] = {}
            for j in range(k_acc):
                metrics, grads = value_and_grad(
                    params, cfg, {k: v[j] for k, v in micro.items()}, hyper)
                for a, g in zip(g_acc, grads):
                    a.add_(g.float() / k_acc)
                del grads
                for key, val in metrics.items():
                    m_acc[key] = m_acc.get(
                        key, torch.zeros((), device=dev)) + val / k_acc
            grads = [a.to(p.dtype) for a, p in zip(g_acc, leaves)]
            metrics = m_acc
        else:
            metrics, grads = value_and_grad(params, cfg, batch, hyper)
        if hyper.grad_compress:
            grads = compress_grads(grads)
        params, opt_state, opt_metrics = apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return step
