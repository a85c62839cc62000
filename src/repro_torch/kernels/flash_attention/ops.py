"""Flash-attention entry, as ``repro/kernels/flash_attention/ops.py::
attention_op``: a CUDA tensor goes to a hand-written tensor-core kernel
chosen by its dtype before any launch (bfloat16 to the wgmma kernel, any
other to the TF32 kernel, which takes float32 and takes each product in
three TF32 passes), a CPU tensor to the plain oracle.  It is the
kernels' one entry on the model path (``models/attention.py``'s chunked
branch on the card).  Nothing falls back: a CUDA tensor a kernel refuses
raises; the plain versions (``ref.py::attention_ref``, the model's
``_sdpa_chunked``) are the CPU path and the oracles."""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda, flash_attention_wgmma
from .ref import attention_ref


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype."""
    if q.is_cuda:
        kernel = flash_attention_wgmma if q.dtype == torch.bfloat16 \
            else flash_attention_cuda
        return kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal, window=window, softcap=softcap)
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap)
