"""Flash-attention entry, as ``repro/kernels/flash_attention/ops.py::
attention_op``: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the plain oracle.  It is the kernel's one entry on the model
path (``models/attention.py``'s chunked branch on the card).  Nothing
falls back: a CUDA tensor the kernel refuses raises."""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype."""
    if q.is_cuda:
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window, softcap=softcap)
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap)
