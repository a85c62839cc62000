"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437), as
``repro/models/mla.py``.

Queries and KV are low-rank compressed; the KV cache stores only the
normalised latent ``ckv`` (kv_lora_rank) and one shared RoPE key ``kr``
(qk_rope_dim) per position.  Prefill expands K and V from the latent:
all at once up to :data:`FLASH_THRESHOLD` positions (full scores), in
chunks of 2048 keys under an online softmax above it
(:func:`_mla_flash`).  Decode uses the *absorbed* form: ``W^{UK}`` is
folded into the query so attention runs in latent space over the cache,
written in place at ``cache_len`` (one for the batch or each row's).  The attention itself runs in float32,
as in the reference, and in plain PyTorch on every device (the reference
leaves it to XLA: no Pallas kernel).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from .attention import NEG_INF, _decode_mask, _mask, _write_rows
from .layers import P, apply_rope, rmsnorm

# sequences longer than this take the chunked online-softmax branch
# (module-level so that tests reach both branches at small sizes)
FLASH_THRESHOLD = 4096


def mla_specs(cfg) -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": P((d, cfg.q_lora_rank), ("embed", "lora")),
        "q_norm": P((cfg.q_lora_rank,), (None,), "zeros"),
        "wq_b": P((cfg.q_lora_rank, H * (nope + rope)), ("lora", "heads")),
        "wkv_a": P((d, cfg.kv_lora_rank + rope), ("embed", "lora")),
        "kv_norm": P((cfg.kv_lora_rank,), (None,), "zeros"),
        "wkv_b": P((cfg.kv_lora_rank, H * (nope + vd)), ("lora", "heads")),
        "wo": P((H * vd, d), ("heads", "embed")),
    }


def _project_q(params: Dict, cfg, x: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    H, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    dt = x.dtype
    cq = rmsnorm(x @ params["wq_a"].to(dt), params["q_norm"], cfg.norm_eps)
    q = (cq @ params["wq_b"].to(dt)).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latent_kv(params: Dict, cfg, x: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache entries of ``x``'s positions: (ckv normalised, k_rope
    rotated), (B, S, kv_lora_rank) and (B, S, qk_rope_dim)."""
    dt = x.dtype
    kvr = x @ params["wkv_a"].to(dt)
    ckv, k_rope = kvr[..., :cfg.kv_lora_rank], kvr[..., cfg.kv_lora_rank:]
    ckv = rmsnorm(ckv, params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return ckv, k_rope


def mla_attention(params: Dict, cfg, x: torch.Tensor,
                  positions: torch.Tensor, *, cache: Optional[Dict] = None,
                  cache_len: Optional[Union[int, torch.Tensor]] = None,
                  return_cache: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """* prefill: cache=None (``return_cache`` for the latent entries of
               the prompt, ``{"ckv", "kr"}`` of length S);
    * decode:  ``cache`` holds ``ckv`` (B, L, kv_lora_rank) and ``kr``
               (B, L, qk_rope_dim); the new entries are written in place
               at ``cache_len`` (an int for the batch, or a (B,) tensor
               of each row's own, positions then (B, S); no roll), and
               keys at or past ``cache_len + S`` are masked."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lr = cfg.kv_lora_rank
    dt = x.dtype
    scale = 1.0 / math.sqrt(nope + rope)
    q_nope, q_rope = _project_q(params, cfg, x, positions)
    wkv_b = params["wkv_b"].to(dt).reshape(lr, H, nope + vd)
    wk_b, wv_b = wkv_b[..., :nope].float(), wkv_b[..., nope:].float()
    qn, qr = q_nope.float(), q_rope.float()
    neg = torch.full((), NEG_INF, device=x.device)

    if cache is not None:
        # ---- decode: absorbed attention in latent space ----
        ckv_new, kr_new = _latent_kv(params, cfg, x, positions)
        ckv, kr = cache["ckv"], cache["kr"]
        if isinstance(cache_len, torch.Tensor):    # per row (batcher)
            _write_rows(ckv, ckv_new, cache_len)
            _write_rows(kr, kr_new, cache_len)
        else:
            n = int(cache_len)
            ckv[:, n:n + S] = ckv_new.to(ckv.dtype)
            kr[:, n:n + S] = kr_new.to(kr.dtype)
        new_cache = cache
        # fold W^{UK} into q: (B,S,H,nope) x (lr,H,nope) -> (B,S,H,lr)
        q_lat = torch.einsum("bshn,lhn->bshl", qn, wk_b)
        ckv_f = ckv.float()
        s = (torch.einsum("bshl,btl->bhst", q_lat, ckv_f)
             + torch.einsum("bshr,btr->bhst", qr, kr.float())) * scale
        msk = _decode_mask(cache_len, S, ckv.shape[1], x.device)
        s = torch.where(msk[:, None] if msk.ndim == 3 else msk[None, None],
                        s, neg)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhst,btl->bshl", p, ckv_f)
        o = torch.einsum("bshl,lhv->bshv", ctx, wv_b)
    else:
        # ---- prefill: K and V expanded from the latent ----
        ckv, k_rope = _latent_kv(params, cfg, x, positions)
        new_cache = {"ckv": ckv, "kr": k_rope} if return_cache else None
        if S <= FLASH_THRESHOLD:
            ckv_f = ckv.float()
            k_nope = torch.einsum("btl,lhn->bthn", ckv_f, wk_b)
            v = torch.einsum("btl,lhv->bthv", ckv_f, wv_b)
            s = (torch.einsum("bshn,bthn->bhst", qn, k_nope)
                 + torch.einsum("bshr,btr->bhst", qr, k_rope.float())) * scale
            msk = _mask(positions, positions, True, 0, None)
            s = torch.where(msk[None, None], s, neg)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bhst,bthv->bshv", p, v)
        else:
            o = _mla_flash(qn, qr, ckv, k_rope, wk_b, wv_b, positions, scale)
    out = o.reshape(B, S, H * vd).to(dt) @ params["wo"].to(dt)
    return out, new_cache


def _mla_flash(qn: torch.Tensor, qr: torch.Tensor, ckv: torch.Tensor,
               k_rope: torch.Tensor, wk_b: torch.Tensor, wv_b: torch.Tensor,
               positions: torch.Tensor, scale: float,
               chunk: int = 2048) -> torch.Tensor:
    """Online softmax over chunks of ``chunk`` keys, K and V expanded from
    the latent one chunk at a time (the compute-optimal prefill form;
    decode uses the absorbed one).  qn (B,S,H,nope) and qr (B,S,H,rope)
    float32; returns (B,S,H,vd) float32."""
    B, S, H, _ = qn.shape
    vd = wv_b.shape[-1]
    T = ckv.shape[1]
    n = (T + chunk - 1) // chunk
    pad = n * chunk - T
    if pad:
        ckv = torch.nn.functional.pad(ckv, (0, 0, 0, pad))
        k_rope = torch.nn.functional.pad(k_rope, (0, 0, 0, pad))
    kpos = torch.nn.functional.pad(positions, (0, pad),
                                   value=(2 ** 31 - 1) // 2)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=qn.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=qn.device)
    acc = torch.zeros((B, H, S, vd), dtype=torch.float32, device=qn.device)
    neg = torch.full((), NEG_INF, device=qn.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        cj = ckv[:, sl].float()
        k_nope = torch.einsum("bcl,lhn->bchn", cj, wk_b)
        vj = torch.einsum("bcl,lhv->bchv", cj, wv_b)
        s = (torch.einsum("bshn,bchn->bhsc", qn, k_nope)
             + torch.einsum("bshr,bcr->bhsc", qr,
                            k_rope[:, sl].float())) * scale
        msk = positions[:, None] >= kpos[sl][None, :]
        s = torch.where(msk[None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhsc,bchv->bhsv", p, vj)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 2, 1, 3)                   # (B,S,H,vd)
