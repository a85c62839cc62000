"""Layer blocks of the families the port serves, as
``repro/models/blocks.py``: the MLP (gated or not), the dense decoder
layer (granite, starcoder2, pixtral, each half of a gemma2 pair, and the
body of Zamba2's shared block), gemma2's local/global pair, the MoE
decoder layer (OLMoE), the MLA layer with a dense MLP or an MoE
(DeepSeek-V3), the Mamba2 layer, the Zamba2 period, and Whisper's
encoder and decoder layers.

``body(p, cfg, h, ctx, cache)`` returns ``(h, new_cache)``; ``ctx``
carries the positions, ``cache_len`` (decode), ``return_cache``
(prefill), ``h0`` (the initial embedding Zamba2's shared block reads),
for Whisper the encoder states ``enc`` and their ``enc_positions``, and
in training a list ``aux``: an MoE layer appends its load-balancing loss
there (the reference's third return value, ``blocks.Aux``).  Serving
passes no list and drops the loss, which ``moe_block`` computes either
way, so the serving path's launches and numbers are those it had.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .attention import _sdpa, attention, attn_specs
from .layers import P, activation, apply_norm, norm_spec
from .mamba2 import mamba_block, mamba_specs
from .mla import mla_attention, mla_specs
from .moe import moe_block, moe_specs


def mlp_specs(cfg, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = {
        "wi": P((d, f), ("embed", "mlp")),
        "wo": P((f, d), ("mlp", "embed")),
    }
    if cfg.gated_mlp:
        s["wg"] = P((d, f), ("embed", "mlp"))
    return s


def mlp(params: Dict, cfg, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    act = activation(cfg.act)
    if "wg" in params:
        h = act(x @ params["wg"].to(dt)) * (x @ params["wi"].to(dt))
    else:
        h = act(x @ params["wi"].to(dt))
    return h @ params["wo"].to(dt)


def dense_layer_specs(cfg) -> Dict:
    s = {
        "ln_attn": norm_spec(cfg),
        "attn": attn_specs(cfg),
        "ln_mlp": norm_spec(cfg),
        "mlp": mlp_specs(cfg),
    }
    if cfg.post_norms:
        s["ln_attn_post"] = norm_spec(cfg)
        s["ln_mlp_post"] = norm_spec(cfg)
    return s


def dense_layer(p: Dict, cfg, h: torch.Tensor, ctx: Dict,
                cache: Optional[Dict], window: int = 0
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    a_in = apply_norm(p["ln_attn"], h, cfg)
    a_out, new_cache = attention(
        p["attn"], cfg, a_in, ctx["positions"], window=window, cache=cache,
        cache_len=ctx.get("cache_len"),
        return_cache=ctx.get("return_cache", False))
    if cfg.post_norms:
        a_out = apply_norm(p["ln_attn_post"], a_out, cfg)
    h = h + a_out
    m_in = apply_norm(p["ln_mlp"], h, cfg)
    m_out = mlp(p["mlp"], cfg, m_in)
    if cfg.post_norms:
        m_out = apply_norm(p["ln_mlp_post"], m_out, cfg)
    return h + m_out, new_cache


def gemma_pair_specs(cfg) -> Dict:
    return {"local": dense_layer_specs(cfg), "global": dense_layer_specs(cfg)}


def gemma_pair(p: Dict, cfg, h: torch.Tensor, ctx: Dict,
               cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """A local layer (window ``cfg.sliding_window``), then a global one."""
    c_l = cache.get("local") if cache else None
    c_g = cache.get("global") if cache else None
    h, nc_l = dense_layer(p["local"], cfg, h, ctx, c_l,
                          window=cfg.sliding_window)
    h, nc_g = dense_layer(p["global"], cfg, h, ctx, c_g, window=0)
    if nc_l is None and nc_g is None:
        return h, None
    return h, {"local": nc_l, "global": nc_g}


def _keep_aux(ctx: Dict, aux: torch.Tensor) -> None:
    """Append an MoE layer's auxiliary loss to ``ctx["aux"]`` (training);
    without the list (serving) it is dropped."""
    if ctx.get("aux") is not None:
        ctx["aux"].append(aux)


def moe_layer_specs(cfg) -> Dict:
    return {
        "ln_attn": norm_spec(cfg),
        "attn": attn_specs(cfg),
        "ln_mlp": norm_spec(cfg),
        "moe": moe_specs(cfg),
    }


def moe_layer(p: Dict, cfg, h: torch.Tensor, ctx: Dict,
              cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    a_in = apply_norm(p["ln_attn"], h, cfg)
    a_out, new_cache = attention(
        p["attn"], cfg, a_in, ctx["positions"], cache=cache,
        cache_len=ctx.get("cache_len"),
        return_cache=ctx.get("return_cache", False))
    h = h + a_out
    m_out, aux = moe_block(p["moe"], cfg, apply_norm(p["ln_mlp"], h, cfg))
    _keep_aux(ctx, aux)
    return h + m_out, new_cache


def mla_dense_specs(cfg) -> Dict:
    return {
        "ln_attn": norm_spec(cfg),
        "attn": mla_specs(cfg),
        "ln_mlp": norm_spec(cfg),
        "mlp": mlp_specs(cfg),
    }


def mla_moe_specs(cfg) -> Dict:
    return {
        "ln_attn": norm_spec(cfg),
        "attn": mla_specs(cfg),
        "ln_mlp": norm_spec(cfg),
        "moe": moe_specs(cfg),
    }


def mla_layer(p: Dict, cfg, h: torch.Tensor, ctx: Dict,
              cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """DeepSeek-V3's layer: MLA, then a dense MLP (its first
    ``n_dense_layers``) or the MoE."""
    a_in = apply_norm(p["ln_attn"], h, cfg)
    a_out, new_cache = mla_attention(
        p["attn"], cfg, a_in, ctx["positions"], cache=cache,
        cache_len=ctx.get("cache_len"),
        return_cache=ctx.get("return_cache", False))
    h = h + a_out
    m_in = apply_norm(p["ln_mlp"], h, cfg)
    if "moe" in p:
        m_out, aux = moe_block(p["moe"], cfg, m_in)
        _keep_aux(ctx, aux)
    else:
        m_out = mlp(p["mlp"], cfg, m_in)
    return h + m_out, new_cache


def ssm_layer_specs(cfg) -> Dict:
    return {"ln": norm_spec(cfg), "mamba": mamba_specs(cfg)}


def ssm_layer(p: Dict, cfg, h: torch.Tensor, ctx: Dict,
              cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    x = apply_norm(p["ln"], h, cfg)
    out, new_cache = mamba_block(p["mamba"], cfg, x, cache=cache,
                                 want_cache=ctx.get("return_cache", False))
    return h + out, new_cache


def shared_attn_specs(cfg) -> Dict:
    """Zamba2 shared transformer block (weights reused at every period):
    input is concat(current hidden, initial embedding) fused by a linear."""
    d = cfg.d_model
    return {
        "fuse": P((2 * d, d), ("embed", "embed")),
        "layer": dense_layer_specs(cfg),
    }


def zamba_period_specs(cfg) -> Dict:
    return {"ssm": [ssm_layer_specs(cfg) for _ in range(cfg.hybrid_period)]}


def zamba_period(p: Dict, shared: Dict, cfg, h: torch.Tensor, ctx: Dict,
                 cache: Optional[Dict]
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    new_cache: Dict[str, Any] = {"ssm": [], "attn": None}
    for i in range(cfg.hybrid_period):
        c = cache["ssm"][i] if cache else None
        h, nc = ssm_layer(p["ssm"][i], cfg, h, ctx, c)
        new_cache["ssm"].append(nc)
    fused = torch.cat([h, ctx["h0"]], dim=-1) @ shared["fuse"].to(h.dtype)
    a_c = cache["attn"] if cache else None
    out, nc_a = dense_layer(shared["layer"], cfg, fused, ctx, a_c)
    new_cache["attn"] = nc_a
    h = h + (out - fused)          # residual of the shared block only
    if all(c is None for c in new_cache["ssm"]) and nc_a is None:
        new_cache = None
    return h, new_cache


def enc_layer_specs(cfg) -> Dict:
    return {
        "ln_attn": norm_spec(cfg),
        "attn": attn_specs(cfg),
        "ln_mlp": norm_spec(cfg),
        "mlp": mlp_specs(cfg),
    }


def enc_layer(p: Dict, cfg, h: torch.Tensor, ctx: Dict,
              cache: Optional[Dict] = None) -> Tuple[torch.Tensor, None]:
    """Whisper's encoder layer: non-causal self-attention without RoPE,
    then the MLP; no cache."""
    a_in = apply_norm(p["ln_attn"], h, cfg)
    a_out, _ = attention(p["attn"], cfg, a_in, ctx["enc_positions"],
                         causal=False, use_rope=False)
    h = h + a_out
    return h + mlp(p["mlp"], cfg, apply_norm(p["ln_mlp"], h, cfg)), None


def dec_layer_specs(cfg) -> Dict:
    return {
        "ln_self": norm_spec(cfg),
        "self_attn": attn_specs(cfg),
        "ln_cross": norm_spec(cfg),
        "cross_attn": attn_specs(cfg),
        "ln_mlp": norm_spec(cfg),
        "mlp": mlp_specs(cfg),
    }


def _cross_from_cache(p: Dict, cfg, x: torch.Tensor,
                      cross: Dict) -> torch.Tensor:
    """Decode's cross-attention over the precomputed encoder K/V: every
    key visible (``_sdpa`` with an all-true mask), nothing written."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, KV, H // KV, hd)
    kc, vc = cross["k"], cross["v"]
    mask = torch.ones((S, kc.shape[1]), dtype=torch.bool, device=x.device)
    o = _sdpa(q, kc, vc, mask, 0.0)
    return o.reshape(B, S, H * hd).to(dt) @ p["wo"].to(dt)


def dec_layer(p: Dict, cfg, h: torch.Tensor, ctx: Dict,
              cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Whisper's decoder layer: causal self-attention without RoPE, then
    cross-attention over the encoder states (non-causal, no RoPE; in
    decode over ``cache["cross"]``, left as it is), then the MLP."""
    self_c = cache.get("self") if cache else None
    a_in = apply_norm(p["ln_self"], h, cfg)
    a_out, nc_self = attention(
        p["self_attn"], cfg, a_in, ctx["positions"], cache=self_c,
        cache_len=ctx.get("cache_len"), use_rope=False,
        return_cache=ctx.get("return_cache", False))
    h = h + a_out
    c_in = apply_norm(p["ln_cross"], h, cfg)
    if cache is not None and cache.get("cross") is not None:
        c_out = _cross_from_cache(p["cross_attn"], cfg, c_in, cache["cross"])
        nc_cross = cache["cross"]
    else:
        c_out, nc_cross = attention(
            p["cross_attn"], cfg, c_in, ctx["positions"], causal=False,
            use_rope=False, kv_src=ctx["enc"],
            kv_positions=ctx["enc_positions"],
            return_cache=ctx.get("return_cache", False))
    h = h + c_out
    new_cache = None
    if nc_self is not None or nc_cross is not None:
        new_cache = {"self": nc_self, "cross": nc_cross}
    return h + mlp(p["mlp"], cfg, apply_norm(p["ln_mlp"], h, cfg)), new_cache
