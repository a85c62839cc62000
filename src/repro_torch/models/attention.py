"""Attention: GQA + RoPE + sliding window + logit soft-cap + qk-norm
(OLMoE), causal or not, self or cross (Whisper), as
``repro/models/attention.py`` (MLA is :mod:`.mla`).

The branch is the reference's: ``naive`` (:func:`_sdpa`, full scores)
when ``Sq * Sk <= 256 * 256`` or ``attn_impl == "naive"``, else the
flash-style recurrence.  There a CUDA tensor goes to the hand-written
flash-attention kernel (``kernels/flash_attention``) and a CPU tensor to
:func:`_sdpa_chunked`, the same online-softmax recurrence in plain
PyTorch.  Decode attends one new token against the KV cache with
:func:`_sdpa`, plain PyTorch on both, as in the reference; its cache
length is one int for the batch or each row's own.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from ..kernels.flash_attention.ops import attention_op
from .layers import P, apply_rope, rmsnorm, softcap

NEG_INF = -1e30


def attn_specs(cfg) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": P((d, H * hd), ("embed", "heads")),
        "wk": P((d, KV * hd), ("embed", "kv")),
        "wv": P((d, KV * hd), ("embed", "kv")),
        "wo": P((H * hd, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        specs["qn"] = P((hd,), (None,), "zeros")
        specs["kn"] = P((hd,), (None,), "zeros")
    return specs


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int,
          kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """(Sq, Sk) boolean validity mask."""
    m = torch.ones((qpos.shape[-1], kpos.shape[-1]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        m &= qpos[:, None] - kpos[None, :] < window
    if kv_len is not None:
        m &= kpos[None, :] < kv_len
    return m


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cap: float) -> torch.Tensor:
    """q: (B,Sq,KV,G,D); k/v: (B,Sk,KV,D); mask: (Sq,Sk) or (B,Sq,Sk).
    Returns (B,Sq,KV,G,D) float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    s = softcap(s, cap)
    m = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    s = torch.where(m, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.float())


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                  window: int, cap: float, kv_len: Optional[torch.Tensor],
                  chunk: int) -> torch.Tensor:
    """Online softmax over KV chunks (the flash-attention recurrence in
    plain PyTorch).  q: (B,Sq,KV,G,D); k/v: (B,Sk,KV,D).  Returns
    (B,Sq,KV,G,D) float32."""
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    if kv_len is None:
        kv_len = Sk              # always mask the chunk padding
    chunk = min(chunk, Sk)
    n = (Sk + chunk - 1) // chunk
    pad = n * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.nn.functional.pad(kpos, (0, pad),
                                       value=(2 ** 31 - 1) // 2)
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    neg = torch.full((), NEG_INF, device=q.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, k[:, sl].float()) * scale
        s = softcap(s, cap)
        msk = _mask(qpos, kpos[sl], causal, window, kv_len)
        s = torch.where(msk[None, None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, v[:, sl].float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4)          # (B,Sq,KV,G,D)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int,
           cap: float) -> torch.Tensor:
    """The chunked branch on the card: one flash-attention launch.  Its
    masks are by index, so a causal or windowed call needs its positions
    to be ``arange(Sq)`` and ``arange(Sk)`` (they are on every prefill);
    a non-causal call with no window has no positional mask and takes any
    positions (Whisper's encoder and cross-attention).  q: (B,Sq,H,D),
    k/v: (B,Sk,KV,D) -> (B,Sq,H,D) in q's dtype."""
    if causal or window > 0:
        for pos, n in ((qpos, q.shape[1]), (kpos, k.shape[1])):
            if pos.ndim != 1 or not torch.equal(
                    pos, torch.arange(n, device=pos.device)):
                raise NotImplementedError(
                    "the flash-attention kernel masks by index: a causal or "
                    "windowed call needs positions arange(S)")
    return attention_op(q, k, v, causal=causal, window=window, softcap=cap)


def _write_rows(c: torch.Tensor, new: torch.Tensor,
                start: torch.Tensor) -> None:
    """Row b of ``new`` (B, S, ...) into ``c`` (B, L, ...) at slots
    ``start[b]`` .. ``start[b] + S - 1``, in place (the reference's per-row
    ``dynamic_update_slice``, which clamps each start to ``L - S``)."""
    B, S = new.shape[:2]
    start = torch.clamp(start, max=c.shape[1] - S)
    rows = torch.arange(B, device=c.device)[:, None]
    c[rows, start[:, None] + torch.arange(S, device=c.device)] = new.to(
        c.dtype)


def _decode_mask(cache_len, S: int, size: int,
                 device: torch.device) -> torch.Tensor:
    """Keys valid in a decode step: (S, size) for an int ``cache_len``
    (the batch's), (B, S, size) for a (B,) tensor (each row's own),
    keys below ``min(cache_len + S, size)``."""
    kpos = torch.arange(size, device=device)
    if isinstance(cache_len, torch.Tensor):
        valid = torch.clamp(cache_len + S, max=size)
        return (kpos[None, None, :] < valid[:, None, None]).expand(
            -1, S, size)
    return (kpos[None, :] < min(int(cache_len) + S, size)).expand(S, size)


def attention(params: Dict, cfg, x: torch.Tensor, positions: torch.Tensor,
              *, window: int = 0, causal: bool = True, use_rope: bool = True,
              kv_src: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              cache: Optional[Dict] = None,
              cache_len: Optional[Union[int, torch.Tensor]] = None,
              return_cache: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Attention with RoPE (``use_rope``), causal or not; ``window`` > 0
    lets a query see only the last ``window`` positions (gemma2's local
    layers).  With qk-norm (``qn``/``kn`` in ``params``) q and k are
    RMS-normalised over the head dim before RoPE, in prefill and decode
    alike.

    * self-attention prefill: cache=None (return_cache to build one)
    * cross-attention:        K/V projected from ``kv_src`` (the encoder
                              states, at ``kv_positions``), never rotated
    * decode:  x is (B,1,D), cache holds K/V, ``cache_len`` is the number
               of valid positions: an int for the whole batch, or a (B,)
               tensor of each row's own (continuous batching), positions
               then (B, S); the new K/V are written into ``cache`` in
               place at ``cache_len % size`` (per row for a tensor), and
               it is returned.  Decode masks no window, as the reference:
               a local layer's cache is ``window`` slots long and rolls,
               so it holds exactly the positions the window sees, and
               once it has rolled its slots are not positions.
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    dt = x.dtype
    src = x if kv_src is None else kv_src
    q = (x @ params["wq"].to(dt)).reshape(B, S, H, hd)
    k = (src @ params["wk"].to(dt)).reshape(B, -1, KV, hd)
    v = (src @ params["wv"].to(dt)).reshape(B, -1, KV, hd)
    if "qn" in params:
        q = rmsnorm(q, params["qn"], cfg.norm_eps)
        k = rmsnorm(k, params["kn"], cfg.norm_eps)
    kpos = kv_positions if kv_positions is not None else positions
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_src is None:
            k = apply_rope(k, kpos, cfg.rope_theta)
    new_cache = None
    if cache is not None and kv_src is None:
        # decode: write the new K/V at cache_len, in place (the reference
        # returns an updated copy; a cache smaller than the stream rolls
        # over: keys are stored post-RoPE, so slot order does not matter)
        kc, vc = cache["k"], cache["v"]
        size = kc.shape[1]
        if isinstance(cache_len, torch.Tensor):
            _write_rows(kc, k, cache_len % size)
            _write_rows(vc, v, cache_len % size)
        else:
            write = min(int(cache_len) % size, size - S)
            kc[:, write:write + S] = k.to(kc.dtype)
            vc[:, write:write + S] = v.to(vc.dtype)
        new_cache = cache
        o = _sdpa(q.reshape(B, S, KV, G, hd), kc, vc,
                  _decode_mask(cache_len, S, size, x.device),
                  cfg.attn_logit_softcap)
    else:
        if return_cache:
            new_cache = {"k": k, "v": v}
        Sk = k.shape[1]
        if cfg.attn_impl == "naive" or S * Sk <= 256 * 256:
            o = _sdpa(q.reshape(B, S, KV, G, hd), k, v,
                      _mask(positions, kpos, causal, window, None),
                      cfg.attn_logit_softcap)
        elif x.is_cuda:
            o = _flash(q, k, v, positions, kpos, causal, window,
                       cfg.attn_logit_softcap)
        else:
            o = _sdpa_chunked(q.reshape(B, S, KV, G, hd), k, v, positions,
                              kpos, causal, window,
                              cfg.attn_logit_softcap, None, cfg.attn_chunk)
    # every path yields (B, S, KV, G, D) or (B, S, H, D)
    o = o.reshape(B, S, H * hd).to(dt)
    return o @ params["wo"].to(dt), new_cache
