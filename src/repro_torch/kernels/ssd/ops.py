"""SSD in the model's layout, as ``repro/kernels/ssd/ops.py::ssd_op``
with ``use_pallas=False``: the group->head broadcast and the head layout
around the sequential oracle :func:`.ref.ssd_ref`.  It is a plain version
on any device.  The kernel's one entry is ``models/mamba2.py::
ssd_chunked``, which sends a CUDA tensor to :func:`.kernel.ssd_cuda` and
also carries the initial and final state this function leaves out."""
from __future__ import annotations

import torch

from .ref import ssd_ref


def ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """x: (b, L, H, P); dt: (b, L, H); A: (H,); B/C: (b, L, G, N).
    Returns y (b, L, H, P) in x's dtype, without the D skip term."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2)
    Ch = C.repeat_interleave(rep, dim=2)
    y = ssd_ref(x.transpose(1, 2).reshape(b * H, L, P),
                dt.transpose(1, 2).reshape(b * H, L), A.repeat(b),
                Bh.transpose(1, 2).reshape(b * H, L, N),
                Ch.transpose(1, 2).reshape(b * H, L, N))
    return y.reshape(b, H, L, P).transpose(1, 2)
