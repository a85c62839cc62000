"""Mixture-of-Experts with token-choice top-k routing and capacity-bounded
scatter dispatch, as ``repro/models/moe.py`` (OLMoE's softmax router;
DeepSeek-V3's sigmoid router and shared expert).

Each assignment's rank within its expert comes from a stable sort, the
tokens are scattered into a per-expert buffer (E, cap, d), the expert
FFNs run as batched matmuls over the stacked weights, and the results
gather back weighted by the router.  An assignment ranked at or past the
capacity is dropped (Switch-style).  The capacity is
``ceil(T * k / E * capacity_factor)`` for the T = B * S tokens of one
call, so a prefill drops other assignments than one-token decode steps
of the same tokens do, as in the reference.

Everything is PyTorch on tensors of any device, with no host sync: no
``.item()``, ``nonzero`` or boolean-mask indexing.  The stages are
functions of their own (:func:`_dispatch`, :func:`_experts`,
:func:`_combine`) so that a trace can tell the dispatch from the expert
products.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .layers import P, activation


def moe_specs(cfg) -> Dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    specs = {
        "router": P((d, E), ("embed", "experts"), scale=0.02),
        "wg": P((E, d, f), ("experts", "embed", "expert_mlp")),
        "wi": P((E, d, f), ("experts", "embed", "expert_mlp")),
        "wo": P((E, f, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        specs["shared"] = {
            "wg": P((d, fs), ("embed", "mlp")),
            "wi": P((d, fs), ("embed", "mlp")),
            "wo": P((fs, d), ("mlp", "embed")),
        }
    return specs


def _router_probs(cfg, logits: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert ids and combine weights, (T, k) each: the sigmoid
    (DeepSeek-V3) or softmax scores' top k, in descending order as
    ``lax.top_k``, renormalised by ``max(sum, 1e-9)``."""
    if cfg.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(scores, cfg.top_k, dim=-1, sorted=True)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return ids, w


def _rank_in_expert(flat_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """rank[j] = number of i < j with flat_ids[i] == flat_ids[j].

    Stable-sort the assignments by expert, take the position within each
    sorted segment from a running maximum of segment starts, and scatter
    back through the permutation."""
    tk = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    idx = torch.arange(tk, device=flat_ids.device)
    is_start = torch.ones(tk, dtype=torch.bool, device=flat_ids.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return torch.empty_like(idx).index_copy_(0, order, idx - seg_start)


def _rank_in_expert_ref(flat_ids: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """The O(TK * E) one-hot cumsum ranking (test oracle)."""
    onehot = torch.nn.functional.one_hot(flat_ids, n_experts)
    cum = torch.cumsum(onehot, dim=0) - onehot
    return torch.gather(cum, 1, flat_ids[:, None])[:, 0]


def capacity(cfg, T: int) -> int:
    """Slots per expert for a call over ``T`` tokens: the reference's
    formula, evaluated in the same order in Python floats."""
    return max(1, int(math.ceil(T * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def _dispatch(xt: torch.Tensor, ids: torch.Tensor, n_experts: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter each token to its experts' buffers.  Returns (the buffer
    (E * cap, d), each assignment's slot (T * k,), whether it was kept):
    a dropped assignment adds zeros to its expert's slot 0, so it
    contributes nothing."""
    T, d = xt.shape
    k = ids.shape[1]
    flat_ids = ids.reshape(-1)
    rank = _rank_in_expert(flat_ids, n_experts)
    keep = rank < cap
    slot = flat_ids * cap + torch.where(keep, rank, 0)
    tok_idx = torch.arange(T, device=xt.device).repeat_interleave(k)
    buf = torch.zeros((n_experts * cap, d), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, slot, xt[tok_idx] * keep[:, None].to(xt.dtype))
    return buf, slot, keep


def _experts(params: Dict, cfg, xe: torch.Tensor) -> torch.Tensor:
    """The expert FFNs over their buffers: xe (E, cap, d) -> (E, cap, d),
    three batched matmuls over the stacked weights, each cast to the
    compute dtype as in the reference."""
    dt = xe.dtype
    act = activation(cfg.act)
    h = act(torch.bmm(xe, params["wg"].to(dt))) * torch.bmm(
        xe, params["wi"].to(dt))
    return torch.bmm(h, params["wo"].to(dt))


def _combine(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             w: torch.Tensor, T: int) -> torch.Tensor:
    """Gather each assignment's expert output, weight it by its combine
    weight cast to the compute dtype (a dropped one by 0), and sum a
    token's k contributions: the assignments are token-major, so the
    reference's scatter-add over ``repeat(arange(T), k)`` is a sum over a
    (T, k, d) view."""
    d = ye.shape[-1]
    k = w.shape[1]
    dt = ye.dtype
    gathered = ye.reshape(-1, d)[slot] * (
        keep[:, None].to(dt) * w.reshape(-1, 1).to(dt))
    return gathered.view(T, k, d).sum(1)


def moe_block(params: Dict, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss (float32 scalar))."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, d)
    # the router product in the compute dtype, then float32
    logits = (xt @ params["router"].to(dt)).float()
    ids, w = _router_probs(cfg, logits)                    # (T, k)

    # load-balancing auxiliary loss (Switch/OLMoE style), float32
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(T * k, device=x.device)) / (T * k)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    cap = capacity(cfg, T)
    buf, slot, keep = _dispatch(xt, ids, E, cap)
    ye = _experts(params, cfg, buf.view(E, cap, d))
    out = _combine(ye, slot, keep, w, T)

    if cfg.n_shared_experts:
        sh = params["shared"]
        act = activation(cfg.act)
        hs = act(xt @ sh["wg"].to(dt)) * (xt @ sh["wi"].to(dt))
        out = out + hs @ sh["wo"].to(dt)
    return out.reshape(B, S, d), aux
