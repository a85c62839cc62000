"""Mamba2 — SSD (state-space duality) block (arXiv:2405.21060), as
``repro/models/mamba2.py``.

Prefill uses the chunked SSD algorithm; on the card :func:`ssd_chunked`
is one launch of the hand-written kernel (``kernels/ssd``), on the CPU
its plain chunked version.  Decode is the O(1) recurrence over the
(H, P, N) state, plain PyTorch on both, as it is plain jnp in the
reference.  The projections are split as in the reference (z, x, the
grouped B/C, dt), so the parameter tree is the same.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd.kernel import ssd_cuda
from .layers import P, rmsnorm


def mamba_specs(cfg) -> Dict:
    d, din = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return {
        "z_proj": P((d, din), ("embed", "mlp")),
        "x_proj": P((d, din), ("embed", "mlp")),
        "bc_proj": P((d, 2 * G * N), ("embed", None)),
        "dt_proj": P((d, H), ("embed", "heads")),
        "conv_x_w": P((cfg.ssm_conv, din), (None, "mlp"), scale=0.3),
        "conv_x_b": P((din,), ("mlp",), "zeros"),
        "conv_bc_w": P((cfg.ssm_conv, 2 * G * N), (None, None), scale=0.3),
        "conv_bc_b": P((2 * G * N,), (None,), "zeros"),
        "A_log": P((H,), (None,), "small_a"),
        "D": P((H,), (None,), "ones"),
        "dt_bias": P((H,), (None,), "zeros"),
        "gate_norm": P((din,), ("mlp",), "zeros"),
        "out_proj": P((din, d), ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, kernel size K.  x: (B, L, C); w: (K, C).
    Returns (y, new_tail) where tail is the last K-1 inputs for decode."""
    K = w.shape[0]
    if tail is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    L = x.shape[1]
    y = xp[:, 0:L, :] * w[0][None, None, :]
    for i in range(1, K):
        y = y + xp[:, i:i + L, :] * w[i][None, None, :]
    y = F.silu(y + b[None, None, :])
    return y, xp[:, -(K - 1):, :]


def _conv_step(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               tail: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the depthwise conv.  x: (B, 1, C)."""
    K = w.shape[0]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)              # (B, K, C)
    y = xp[:, -K, :] * w[0][None, :]
    for i in range(1, K):
        y = y + xp[:, -K + i, :] * w[i][None, :]
    y = F.silu(y + b[None, :])
    return y, xp[:, -(K - 1):, :]


def ssd_chunked_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, chunk: int,
                      init_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD of ``repro/models/mamba2.py::ssd_chunked`` in plain
    PyTorch: x (b, L, H, P); dt (b, L, H); A (H,) < 0; B, C (b, L, G, N).
    Returns (y (b, L, H, P) float32, final_state (b, H, P, N) float32)."""
    b, L, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // chunk
    xc = x.reshape(b, nc, chunk, H, Pd).float()
    dtc = dt.reshape(b, nc, chunk, H).float()
    Bc = B.reshape(b, nc, chunk, G, N).float()
    Cc = C.reshape(b, nc, chunk, G, N).float()

    a = dtc * A[None, None, None, :]                      # log-decay per step
    a_cum = torch.cumsum(a, dim=2)                        # (b,nc,Q,H)
    # M[i,j] = exp(a_cum[i]-a_cum[j]) * (C_i . B_j) * dt_j, masked before
    # the exp (the non-causal region has seg > 0 and could overflow)
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]   # (b,nc,Q,Q,H)
    qpos = torch.arange(chunk, device=x.device)
    causal = qpos[:, None] >= qpos[None, :]
    seg = seg.masked_fill(~causal[None, None, :, :, None], float("-inf"))
    decay = torch.exp(seg)
    CB = torch.einsum("bcqgn,bckgn->bcqkg", Cc, Bc)
    CB = CB.repeat_interleave(rep, dim=-1) if G != H else CB  # (b,nc,Q,Q,H)
    M = CB * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xc)

    # chunk states: S_c = sum_j exp(a_cum[last]-a_cum[j]) dt_j B_j x_j^T
    last = a_cum[:, :, -1:, :]                            # (b,nc,1,H)
    w_in = torch.exp(last - a_cum) * dtc                  # (b,nc,Q,H)
    Bh = Bc.repeat_interleave(rep, dim=3) if G != H else Bc
    Ch = Cc.repeat_interleave(rep, dim=3) if G != H else Cc
    S_chunk = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w_in, Bh, xc)
    chunk_decay = torch.exp(last[:, :, 0, :])             # (b,nc,H)

    state = init_state.float() if init_state is not None else torch.zeros(
        (b, H, Pd, N), dtype=torch.float32, device=x.device)
    before = []
    for c in range(nc):                                   # state BEFORE chunk
        before.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    states_before = torch.stack(before, 1)                # (b,nc,H,P,N)

    # inter-chunk contribution: y_j += exp(a_cum[j]) * C_j . state_before
    w_out = torch.exp(a_cum)                              # (b,nc,Q,H)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, states_before,
                           w_out)
    y = (y_intra + y_inter).reshape(b, Lp, H, Pd)[:, :L]
    return y, state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD core.  x: (b, L, H, P); dt: (b, L, H); A: (H,) < 0;
    B, C: (b, L, G, N).  Returns (y (b,L,H,P) float32, final_state
    (b,H,P,N) float32): one launch of the CUDA kernel for a CUDA tensor,
    :func:`ssd_chunked_plain` for a CPU tensor.  The kernel has no
    backward yet: a CUDA call with grad mode on and an input that
    requires a gradient raises NotImplementedError
    (``kernels/ssd/kernel.py::refuse_grad``), never a silent cut."""
    if x.is_cuda:
        return ssd_cuda(x.contiguous(), dt.float().contiguous(),
                        A.float().contiguous(), B.contiguous(),
                        C.contiguous(), chunk=chunk,
                        init_state=None if init_state is None
                        else init_state.float().contiguous())
    return ssd_chunked_plain(x, dt, A, B, C, chunk, init_state)


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  state: (b,H,P,N); x: (b,H,P); dt: (b,H);
    B, C: (b,G,N).  Returns (y (b,H,P), new_state)."""
    H = x.shape[1]
    rep = H // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1).float()
    Ch = C.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(dt * A[None, :])                    # (b,H)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, x.float(), Bh)
    new_state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


def mamba_block(params: Dict, cfg, h: torch.Tensor, *,
                cache: Optional[Dict] = None, want_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full Mamba2 block.
    cache = {"state": (b,H,P,N), "conv_x": (b,K-1,din), "conv_bc": (b,K-1,2GN)}.
    """
    Bsz, L, _ = h.shape
    din = cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    Pd = cfg.ssm_head_dim
    dt_ = h.dtype
    z = h @ params["z_proj"].to(dt_)
    xr = h @ params["x_proj"].to(dt_)
    bc = h @ params["bc_proj"].to(dt_)
    dt_raw = h @ params["dt_proj"].to(dt_)
    A = -torch.exp(params["A_log"].float())

    if cache is not None and L == 1:
        xc, new_cx = _conv_step(xr, params["conv_x_w"], params["conv_x_b"],
                                cache["conv_x"])
        bcc, new_cbc = _conv_step(bc, params["conv_bc_w"],
                                  params["conv_bc_b"], cache["conv_bc"])
        x = xc.reshape(Bsz, H, Pd)
        Bv = bcc[..., :G * N].reshape(Bsz, G, N)
        Cv = bcc[..., G * N:].reshape(Bsz, G, N)
        dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"][None, :])
        yssm, new_state = ssd_decode_step(cache["state"], x, dt, A, Bv, Cv)
        yssm = yssm + x.float() * params["D"][None, :, None]
        yssm = yssm.reshape(Bsz, 1, din).to(dt_)
        new_cache = {"state": new_state, "conv_x": new_cx,
                     "conv_bc": new_cbc}
    else:
        tail_x = cache["conv_x"] if cache is not None else None
        tail_bc = cache["conv_bc"] if cache is not None else None
        xc, new_cx = _causal_conv(xr, params["conv_x_w"], params["conv_x_b"],
                                  tail_x)
        bcc, new_cbc = _causal_conv(bc, params["conv_bc_w"],
                                    params["conv_bc_b"], tail_bc)
        x = xc.reshape(Bsz, L, H, Pd)
        Bv = bcc[..., :G * N].reshape(Bsz, L, G, N)
        Cv = bcc[..., G * N:].reshape(Bsz, L, G, N)
        dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])
        init = cache["state"] if cache is not None else None
        yssm, final_state = ssd_chunked(x, dt, A, Bv, Cv, cfg.ssm_chunk, init)
        yssm = yssm + x.float() * params["D"][None, None, :, None]
        yssm = yssm.reshape(Bsz, L, din).to(dt_)
        if cache is not None or want_cache:
            new_cache = {"state": final_state, "conv_x": new_cx,
                         "conv_bc": new_cbc}
        else:
            new_cache = None
    # gated norm + out projection
    y = rmsnorm(yssm * F.silu(z), params["gate_norm"], cfg.norm_eps)
    return y @ params["out_proj"].to(dt_), new_cache
