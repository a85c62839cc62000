"""Serving steps on one card: prefill the prompt, move its cache into a
decode cache, decode.

The reference's ``serve/steps.py`` builds the same two steps for pjit
(``make_prefill_step``, ``make_decode_step``); on one card they are
``models.prefill`` and ``models.decode_step`` run under
``torch.inference_mode()``.  The one piece of glue is
:func:`prefill_into_cache`: ``models.prefill`` returns attention caches
of the prompt's length S, so its cache is written into
``init_cache(cfg, B, max_len)`` — attention K/V (the dense and MoE
families, Zamba2's shared block) and MLA's latent ``ckv`` and RoPE key
``kr`` (DeepSeek-V3) at positions [0, S), Whisper's cross K/V (length
``encoder_seq``) whole, the SSM state and both conv tails as they are —
and decoding continues at ``cache_len = S``; decode reads the cross K/V
and never rewrites them.  A decode leaf shorter than the prompt (a gemma2 local
cache of ``sliding_window`` slots under a longer prompt) keeps the last
L positions, position p at slot p % L: the state the reference's decode
reaches after feeding the prompt one token at a time.  So the copy is
exact for every family served here.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.model import check_served, decode_step, init_cache, prefill


def _copy_prefix(dst: Any, src: Any, key: Optional[str] = None) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_prefix(dst[k], src[k], k)
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _copy_prefix(d, s, key)
    elif key in ("k", "v", "ckv", "kr"):   # (n, B, S, ...) into (n, B, L, ...)
        S, L = src.shape[2], dst.shape[2]
        if S <= L:
            dst[:, :, :S].copy_(src)
        else:                          # rolled: position p at slot p % L
            dst.copy_(torch.roll(src[:, :, S - L:], S % L, dims=2))
    else:
        dst.copy_(src)


def prefill_into_cache(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                       max_len: int,
                       patch_embeds: Optional[torch.Tensor] = None,
                       frames: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """Prefill ``tokens`` (B, S) (and pixtral's ``patch_embeds``, if
    given; Whisper's ``frames`` (B, encoder_seq, d_model)) and return (last logits (B, 1, V), a decode cache of
    ``max_len`` holding the prompt).  The cache holds K/V and the conv
    tails in the compute dtype (for Zamba2 the reference launcher's
    bfloat16; the reference's decode step returns its conv tails in the
    compute dtype too)."""
    check_served(cfg)      # the copy below is exact for these only
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len={max_len}")
    with torch.inference_mode():
        batch = {"tokens": tokens}
        if patch_embeds is not None:
            batch["patch_embeds"] = patch_embeds
        if frames is not None:
            batch["frames"] = frames
        logits, pcache = prefill(params, cfg, batch, max_len)
        cache = init_cache(cfg, B, max_len, dtype=getattr(torch, cfg.dtype),
                           device=tokens.device)
        _copy_prefix(cache, pcache)
    return logits, cache


def greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, 1, Vpad) -> (B, 1) argmax over the real vocabulary."""
    return torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)


def generate(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, gen: int,
             on_step: Optional[Callable[[str], None]] = None,
             frames: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill (Whisper: over ``frames`` too), then ``gen - 1`` greedy
    decode steps: returns (the ``gen`` generated tokens (B, gen), the
    logits they came from (B, gen, Vpad)).
    ``on_step("prefill")`` and ``on_step("decode")`` are called after each
    step (the launcher's clocks)."""
    S = tokens.shape[1]
    logits, cache = prefill_into_cache(params, cfg, tokens, S + gen,
                                       frames=frames)
    if on_step:
        on_step("prefill")
    tok = greedy(logits, cfg)
    out, outs = [tok], [logits]
    for i in range(gen - 1):
        with torch.inference_mode():
            logits, cache = decode_step(params, cfg, tok, cache, S + i)
        if on_step:
            on_step("decode")
        tok = greedy(logits, cfg)
        out.append(tok)
        outs.append(logits)
    return torch.cat(out, 1), torch.cat(outs, 1)
