"""Plain PyTorch oracle for the SSD kernel: the sequential recurrence
    s_t = exp(dt_t * A) * s_{t-1} + dt_t * B_t x_t^T;   y_t = C_t . s_t
computed step by step (no chunking), as ``repro/kernels/ssd/ref.py``."""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """x: (BH, L, P); dt: (BH, L); A: (BH,); B/C: (BH, L, N) -> y (BH, L, P)
    in x's dtype."""
    BH, L, P = x.shape
    N = B.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = B.float(), C.float(), A.float()
    s = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * Af)
        s = s * decay[:, None, None] + dtf[:, t, None, None] * (
            xf[:, t, :, None] * Bf[:, t, None, :])
        ys.append(torch.einsum("bpn,bn->bp", s, Cf[:, t]))
    return torch.stack(ys, 1).to(x.dtype)
