"""Model assembly: parameters, prefill and decode for every family of
the reference (``dense``: granite, starcoder2, pixtral's backbone and
gemma2's local/global pairs; ``moe``: OLMoE, and DeepSeek-V3 with MLA and
its multi-token-prediction parameters; ``ssm``: Mamba2; ``hybrid``:
Zamba2; ``encdec``: Whisper, its encoder run once a prefill and its
cross K/V precomputed for decode), as ``repro/models/model.py``.

Layers are organized into *groups* of identical structure, each group's
parameters stacked along a leading layer axis as in the reference, so
the parameter and cache trees are the reference's.  The reference's
``lax.scan`` over a group becomes a Python loop over the layer index.
Prefill returns caches stacked the same way; decode updates the cache it
is given in place and returns it.  Training's forward,
:func:`forward_train` (with DeepSeek-V3's multi-token prediction,
:func:`_mtp_logits`), runs every family under autograd: each stacked
leaf is unbound along its layer axis once, and with ``cfg.remat`` each
layer runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), its activations recomputed in the backward pass.
On the card its chunked attention goes through the flash kernels'
autograd function; the SSD kernel has no backward yet and refuses.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from .. import resolve_device
from . import blocks
from .config import ModelConfig
from .layers import (P, apply_norm, init_params, norm_spec, padded_vocab,
                     sinusoidal_positions, softcap, tree_map)

SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


@dataclasses.dataclass(frozen=True)
class GroupDef:
    name: str
    n: int                                   # layers in the group
    specs: Dict                              # per-layer param specs
    body: Optional[Callable]                 # (p, cfg, h, ctx, cache)


def check_served(cfg: ModelConfig) -> None:
    """Refuse a family outside :data:`SERVED_FAMILIES` (one the reference
    does not know either).  The multi-token-prediction module's
    parameters are built and carried, but no serving path reads them, as
    in the reference's prefill and decode."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"config {cfg.name!r} (family {cfg.family!r}): the port serves "
            f"the {SERVED_FAMILIES} families")


def group_defs(cfg: ModelConfig) -> List[GroupDef]:
    check_served(cfg)
    f = cfg.family
    if f == "dense":
        if cfg.local_global:
            return [GroupDef("pairs", cfg.n_layers // 2,
                             blocks.gemma_pair_specs(cfg), blocks.gemma_pair)]
        return [GroupDef("layers", cfg.n_layers,
                         blocks.dense_layer_specs(cfg), blocks.dense_layer)]
    if f == "moe":
        if cfg.use_mla:
            defs = []
            if cfg.n_dense_layers:
                defs.append(GroupDef("dense", cfg.n_dense_layers,
                                     blocks.mla_dense_specs(cfg),
                                     blocks.mla_layer))
            defs.append(GroupDef("moe", cfg.n_layers - cfg.n_dense_layers,
                                 blocks.mla_moe_specs(cfg), blocks.mla_layer))
            return defs
        return [GroupDef("layers", cfg.n_layers, blocks.moe_layer_specs(cfg),
                         blocks.moe_layer)]
    if f == "ssm":
        return [GroupDef("layers", cfg.n_layers, blocks.ssm_layer_specs(cfg),
                         blocks.ssm_layer)]
    if f == "hybrid":
        per = cfg.hybrid_period
        n_periods = cfg.n_layers // per
        tail = cfg.n_layers - n_periods * per
        defs = [GroupDef("periods", n_periods, blocks.zamba_period_specs(cfg),
                         None)]  # body needs the shared block's params
        if tail:
            defs.append(GroupDef("tail", tail, blocks.ssm_layer_specs(cfg),
                                 blocks.ssm_layer))
        return defs
    return [GroupDef("encoder", cfg.n_encoder_layers,        # encdec
                     blocks.enc_layer_specs(cfg), blocks.enc_layer),
            GroupDef("decoder", cfg.n_layers, blocks.dec_layer_specs(cfg),
                     blocks.dec_layer)]


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _stack_specs(specs: Dict, n: int) -> Dict:
    return tree_map(lambda p: P((n,) + p.shape, ("layers",) + p.axes,
                                p.init, p.scale), specs)


def model_specs(cfg: ModelConfig) -> Dict:
    vp = padded_vocab(cfg.vocab_size)
    specs: Dict[str, Any] = {
        "embed": P((vp, cfg.d_model), ("vocab", "embed"), scale=1.0),
        "final_norm": norm_spec(cfg),
        "groups": {g.name: _stack_specs(g.specs, g.n) for g in group_defs(cfg)},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((cfg.d_model, vp), ("embed", "vocab"))
    if cfg.family == "hybrid":
        specs["shared_block"] = blocks.shared_attn_specs(cfg)
    if cfg.mtp_depth:
        specs["mtp"] = {
            "proj": P((2 * cfg.d_model, cfg.d_model), ("embed", "embed")),
            "norm_h": norm_spec(cfg),
            "norm_e": norm_spec(cfg),
            "layer": blocks.mla_dense_specs(cfg) if cfg.use_mla
            else blocks.dense_layer_specs(cfg),
        }
    return specs


def init_model(cfg: ModelConfig, seed: int = 0,
               device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Random parameters in ``cfg.param_dtype`` from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (None: the card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_params(gen, model_specs(cfg),
                       dtype=getattr(torch, cfg.param_dtype))


# ---------------------------------------------------------------------------
# the layer loop
# ---------------------------------------------------------------------------

def _is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def _stack(trees: List[Any]) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def _write_layer(dst: Any, i: int, src: Any) -> None:
    """Copy layer ``i``'s new cache ``src`` into the stacked ``dst``
    (leaves already written in place are skipped)."""
    if isinstance(dst, dict):
        for k in dst:
            _write_layer(dst[k], i, src[k])
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _write_layer(d, i, s)
    else:
        view = dst[i]
        if src.data_ptr() != view.data_ptr():
            view.copy_(src)


def _scan_group(gdef: GroupDef, params: Dict, cfg: ModelConfig,
                h: torch.Tensor, ctx: Dict, cache: Optional[Dict],
                shared: Optional[Dict]) -> Tuple[torch.Tensor, Any]:
    caches = []
    for i in range(gdef.n):
        p_i = tree_map(lambda x: x[i], params, _is_tensor)
        c_i = None if cache is None else tree_map(lambda x: x[i], cache,
                                                   _is_tensor)
        if gdef.name == "periods":
            h, nc = blocks.zamba_period(p_i, shared, cfg, h, ctx, c_i)
        else:
            h, nc = gdef.body(p_i, cfg, h, ctx, c_i)
        if cache is not None:
            _write_layer(cache, i, nc)
        else:
            caches.append(nc)
    if cache is not None:
        return h, cache
    if all(c is None for c in caches):
        return h, None
    return h, _stack(caches)


def _train_group(gdef: GroupDef, params: Dict, cfg: ModelConfig,
                 h: torch.Tensor, ctx: Dict, shared: Optional[Dict]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training's loop over a group: returns (h, the sum of its layers'
    MoE auxiliary losses, a float32 scalar).  Each stacked leaf is
    unbound along the layer axis once, so autograd stacks the layers'
    gradients in one copy (``x[i]`` per layer would scatter each into a
    zeroed leaf-sized gradient).  With ``cfg.remat`` each layer runs
    under a non-reentrant ``torch.utils.checkpoint``: only its input is
    kept, and its forward runs again in the backward pass."""
    slices = tree_map(lambda x: x.unbind(0), params, _is_tensor)

    def step(hh: torch.Tensor, p: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        lctx = dict(ctx, aux=[])
        if gdef.name == "periods":
            hh, _ = blocks.zamba_period(p, shared, cfg, hh, lctx, None)
        else:
            hh, _ = gdef.body(p, cfg, hh, lctx, None)
        aux = (torch.stack(lctx["aux"]).sum() if lctx["aux"] else
               torch.zeros((), dtype=torch.float32, device=hh.device))
        return hh, aux

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(gdef.n):
        p_i = tree_map(lambda t: t[i], slices,
                       lambda x: isinstance(x, tuple))
        if cfg.remat:
            h, aux = torch.utils.checkpoint.checkpoint(
                step, h, p_i, use_reentrant=False)
        else:
            h, aux = step(h, p_i)
        total = total + aux
    return h, total


def _embed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
           patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings in the compute dtype; gemma's scaled by
    sqrt(d_model), the scale rounded to the compute dtype first (keyed on
    the name, as the reference); pixtral's first ``n_patches`` positions
    replaced by the (stubbed) image patch embeddings."""
    dt = getattr(torch, cfg.dtype)
    h = params["embed"][tokens].to(dt)
    if cfg.name.startswith("gemma"):
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=h.device)
    if cfg.n_patches and patch_embeds is not None:
        h = torch.cat([patch_embeds.to(dt), h[:, cfg.n_patches:]], dim=1)
    return h


def _run_encoder(params: Dict, cfg: ModelConfig, frames: torch.Tensor,
                 ctx: Dict, train: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Whisper's encoder over the (stubbed) frame embeddings (B, Se, d):
    the frames plus the sinusoidal table, then the encoder group (through
    :func:`_train_group` when ``train``).  Returns (the encoder states,
    ``ctx`` with ``enc`` and ``enc_positions``)."""
    dt = getattr(torch, cfg.dtype)
    Se = frames.shape[1]
    ctx = dict(ctx, enc_positions=torch.arange(Se, device=frames.device))
    h = frames.to(dt) + sinusoidal_positions(Se, cfg.d_model,
                                             frames.device).to(dt)
    gdef = next(g for g in group_defs(cfg) if g.name == "encoder")
    if train:
        h, _ = _train_group(gdef, params["groups"]["encoder"], cfg, h, ctx,
                            None)
    else:
        h, _ = _scan_group(gdef, params["groups"]["encoder"], cfg, h, ctx,
                           None, None)
    ctx["enc"] = h
    return h, ctx


def _dec_embed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
               pos_tab: torch.Tensor) -> torch.Tensor:
    """Whisper's decoder input: the token embeddings plus ``pos_tab``
    (the sinusoidal rows of their positions), in the compute dtype, with
    no sqrt(d) scale."""
    dt = getattr(torch, cfg.dtype)
    return params["embed"][tokens].to(dt) + pos_tab.to(dt)


def _logits(params: Dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = apply_norm(params["final_norm"], h, cfg)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["lm_head"].to(h.dtype)
    return softcap(logits.float(), cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward_train(params: Dict, cfg: ModelConfig, batch: Dict
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training's forward over ``batch["tokens"]`` (B, S) (Whisper's
    encoder over ``batch["frames"]`` first; pixtral's
    ``batch["patch_embeds"]`` if given), as the reference's: returns
    (logits (B, S, Vpad) float32, {"moe_aux": the layers' summed MoE
    auxiliary loss (float32 scalar, 0 without experts), and for
    DeepSeek-V3 "mtp_logits" (B, S, Vpad)}).  Differentiable on both
    devices; the reference's sharding hooks (``constrain*``) have no
    counterpart on one card."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    ctx: Dict[str, Any] = {"positions": torch.arange(S, device=tokens.device),
                           "return_cache": False}
    if cfg.family == "encdec":
        _, ctx = _run_encoder(params, cfg, batch["frames"], ctx, train=True)
        h = _dec_embed(params, cfg, tokens, sinusoidal_positions(
            S, cfg.d_model, tokens.device))
    else:
        h = _embed(params, cfg, tokens, batch.get("patch_embeds"))
    ctx["h0"] = h
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    shared = params.get("shared_block")
    for g in group_defs(cfg):
        if g.name == "encoder":
            continue
        h, aux = _train_group(g, params["groups"][g.name], cfg, h, ctx,
                              shared)
        aux_total = aux_total + aux
    aux_out: Dict[str, torch.Tensor] = {"moe_aux": aux_total}
    if cfg.mtp_depth:
        aux_out["mtp_logits"] = _mtp_logits(params, cfg, h, tokens)
    return _logits(params, cfg, h), aux_out


def _mtp_logits(params: Dict, cfg: ModelConfig, h: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction (depth 1): the trunk's hidden
    state at position t (normed) beside the embedding of token t + 1
    (normed, the last position wrapping around as ``jnp.roll``), fused by
    ``proj``, through one more layer (MLA with a dense MLP), then the
    shared head: logits for token t + 2."""
    mtp = params["mtp"]
    dt = h.dtype
    e = params["embed"][torch.roll(tokens, -1, dims=1)].to(dt)
    hin = torch.cat([apply_norm(mtp["norm_h"], h, cfg),
                     apply_norm(mtp["norm_e"], e, cfg)], dim=-1)
    hm = hin @ mtp["proj"].to(dt)
    ctx = {"positions": torch.arange(h.shape[1], device=h.device),
           "return_cache": False}
    layer = blocks.mla_layer if cfg.use_mla else blocks.dense_layer
    hm, _ = layer(mtp["layer"], cfg, hm, ctx, None)
    return _logits(params, cfg, hm)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Stacked per-group decode caches, zeroed (None device: the card);
    a gemma2 pair's local cache is ``min(max_len, sliding_window)`` long
    and rolls in decode; an MLA group's holds the latent ``ckv`` and the
    RoPE key ``kr`` per position; Whisper's decoder holds its ``self``
    K/V of ``max_len`` and its ``cross`` K/V of ``encoder_seq``."""
    dev = resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.head_dim

    def kv(n: int, length: int) -> Dict:
        return {"k": torch.zeros((n, batch, length, KV, hd), dtype=dtype,
                                 device=dev),
                "v": torch.zeros((n, batch, length, KV, hd), dtype=dtype,
                                 device=dev)}

    def ssm(n: int) -> Dict:
        return {"state": torch.zeros((n, batch, cfg.ssm_heads,
                                      cfg.ssm_head_dim, cfg.ssm_state),
                                     dtype=torch.float32, device=dev),
                "conv_x": torch.zeros((n, batch, cfg.ssm_conv - 1,
                                       cfg.d_inner), dtype=dtype, device=dev),
                "conv_bc": torch.zeros((n, batch, cfg.ssm_conv - 1,
                                        2 * cfg.ssm_groups * cfg.ssm_state),
                                       dtype=dtype, device=dev)}

    caches: Dict[str, Any] = {}
    for g in group_defs(cfg):
        if g.name == "encoder":
            continue
        if g.name == "decoder":
            caches[g.name] = {"self": kv(g.n, max_len),
                              "cross": kv(g.n, cfg.encoder_seq)}
        elif g.name == "pairs":
            caches[g.name] = {
                "local": kv(g.n, min(max_len, cfg.sliding_window)),
                "global": kv(g.n, max_len)}
        elif g.name == "periods":
            caches[g.name] = {
                "ssm": [ssm(g.n) for _ in range(cfg.hybrid_period)],
                "attn": kv(g.n, max_len)}
        elif cfg.use_mla:
            caches[g.name] = {
                "ckv": torch.zeros((g.n, batch, max_len, cfg.kv_lora_rank),
                                   dtype=dtype, device=dev),
                "kr": torch.zeros((g.n, batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=dev)}
        elif cfg.family in ("dense", "moe"):
            caches[g.name] = kv(g.n, max_len)
        else:
            caches[g.name] = ssm(g.n)
    return caches


def encdec_prepare(params: Dict, cfg: ModelConfig, frames: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict]:
    """Run Whisper's encoder once over ``frames`` and precompute each
    decoder layer's cross K/V (static during decode): returns (the
    encoder states (B, Se, d), {"k", "v"} stacked (n_layers, B, Se, KV,
    hd))."""
    enc, _ = _run_encoder(params, cfg, frames, {})
    dec_p = params["groups"]["decoder"]["cross_attn"]
    B, Se, _ = enc.shape
    shape = (B, Se, cfg.n_kv_heads, cfg.head_dim)
    dt = enc.dtype
    cross = {w[1]: torch.stack([(enc @ dec_p[w][i].to(dt)).reshape(shape)
                                for i in range(cfg.n_layers)])
             for w in ("wk", "wv")}
    return enc, cross


def prefill(params: Dict, cfg: ModelConfig, batch: Dict, max_len: int
            ) -> Tuple[torch.Tensor, Dict]:
    """Forward over the prompt ``batch["tokens"]`` (B, S), for pixtral
    ``batch["patch_embeds"]`` (B, n_patches, d_model) if given, and for
    Whisper over ``batch["frames"]`` (B, encoder_seq, d_model) first (the
    encoder); returns (last-position logits (B, 1, Vpad) float32, cache)
    with the attention caches of length S, local ones too, and Whisper's
    cross K/V of length ``encoder_seq``, as the reference's (``max_len``
    is unused there too; :mod:`repro_torch.serve.steps` moves the cache
    into a decode cache of ``max_len``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    ctx: Dict[str, Any] = {"positions": positions, "return_cache": True}
    if cfg.family == "encdec":
        _, ctx = _run_encoder(params, cfg, batch["frames"], ctx)
        h = _dec_embed(params, cfg, tokens, sinusoidal_positions(
            S, cfg.d_model, tokens.device))
    else:
        h = _embed(params, cfg, tokens, batch.get("patch_embeds"))
    ctx["h0"] = h
    shared = params.get("shared_block")
    cache_out: Dict[str, Any] = {}
    for g in group_defs(cfg):
        if g.name == "encoder":
            continue
        h, nc = _scan_group(g, params["groups"][g.name], cfg, h, ctx, None,
                            shared)
        cache_out[g.name] = nc
    return _logits(params, cfg, h[:, -1:]), cache_out


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, cache_len: Union[int, torch.Tensor],
                batch_extras: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1); ``cache`` from :func:`init_cache`
    (updated in place and returned; Whisper's ``cross`` K/V read, never
    written); ``cache_len``: the number of valid positions, an int for
    the whole batch or a (B,) integer tensor of each row's own
    (continuous batching, :mod:`repro_torch.serve.batcher`), positions
    then ``cache_len[:, None] + arange(S)``.  ``batch_extras["enc"]``
    (Whisper's encoder states) is carried into the layers' context as in
    the reference; decode reads the cross cache instead.

    Whisper with a (B,) ``cache_len`` raises NotImplementedError: the
    reference fails there too (``pos_tab[positions][None]``,
    ``repro/models/model.py:382``, makes a 4-D hidden state)."""
    B, S = tokens.shape
    ar = torch.arange(S, device=tokens.device)
    if isinstance(cache_len, torch.Tensor):
        if cfg.family == "encdec":
            raise NotImplementedError(
                f"{cfg.name}: a per-row cache_len on the enc-dec family; the "
                "reference's decode fails there too (pos_tab[positions]"
                "[None] at repro/models/model.py:382 gives a 4-D hidden "
                "state)")
        positions = cache_len[:, None] + ar[None, :]
    else:
        cache_len = int(cache_len)
        positions = cache_len + ar
    ctx: Dict[str, Any] = {"positions": positions, "cache_len": cache_len,
                           "return_cache": True}
    if cfg.family == "encdec":
        ctx["enc"] = (batch_extras or {}).get("enc")
        ctx["enc_positions"] = torch.arange(cfg.encoder_seq,
                                            device=tokens.device)
        max_len = cache["decoder"]["self"]["k"].shape[2]
        pos_tab = sinusoidal_positions(max_len, cfg.d_model, tokens.device)
        h = _dec_embed(params, cfg, tokens, pos_tab[positions][None])
    else:
        h = _embed(params, cfg, tokens)
    ctx["h0"] = h
    shared = params.get("shared_block")
    for g in group_defs(cfg):
        if g.name == "encoder":
            continue
        h, cache[g.name] = _scan_group(g, params["groups"][g.name], cfg, h,
                                       ctx, cache[g.name], shared)
    return _logits(params, cfg, h), cache
