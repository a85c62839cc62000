"""Flash-attention entry, as ``repro/kernels/flash_attention/ops.py::
attention_op``: a CUDA tensor goes to a hand-written tensor-core kernel
chosen by its dtype before any launch (bfloat16 to the wgmma kernel, any
other to the TF32 kernel, which takes float32 and takes each product in
three TF32 passes), a CPU tensor to the plain oracle.  When grad mode is
on and q, k or v requires a gradient, a CUDA call goes through
``kernel.FlashAttention`` instead: the same forward kernel, and the
hand-written backward kernel (``csrc/flash_attention_bwd.cu``) for the
gradients; under ``torch.inference_mode()`` (the serve steps) and
``no_grad`` nothing changes.  It is the
kernels' one entry on the model path (``models/attention.py``'s chunked
branch on the card).  Nothing falls back: a CUDA tensor a kernel refuses
raises; the plain versions (``ref.py::attention_ref``, the model's
``_sdpa_chunked``) are the CPU path and the oracles."""
from __future__ import annotations

import torch

from .kernel import FlashAttention, forward_kernel
from .ref import attention_ref


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype."""
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal, window, softcap)
        return forward_kernel(q.dtype)(q, k, v, causal=causal,
                                       window=window, softcap=softcap)
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap)
