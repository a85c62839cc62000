"""PyTorch/CUDA port of the OASiS scheduler and of the model stack it
schedules (the JAX package ``repro`` is the reference it is checked
against).

Device policy: every entry point takes ``device=None``, which means the
CUDA card; without one it raises instead of falling back to the CPU.
The CPU runs only when the caller passes ``device="cpu"`` (the tests do).

Dtype policy: the scheduler runs float64 on every device.  The TPU route
of the reference forced float32 only because the TPU has no float64; the
H100 has it, so the port's decisions are held to the float64 reference
trajectories.  The model stack (``models``, ``serve``, ``launch``)
follows each config's ``dtype`` (compute, bfloat16 by default) and
``param_dtype`` (storage, float32), as the reference does.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DTYPE = torch.float64


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the CUDA card (RuntimeError when there is none);
    anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "present; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


__all__ = ["DEFAULT_DTYPE", "resolve_device"]
