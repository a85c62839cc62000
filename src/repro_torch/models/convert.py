"""Carry the reference's parameters across: the JAX package's parameter
tree, as numpy arrays with the same nesting (dicts, and the list of a
Zamba2 period's SSM layers), becomes the port's tree of tensors.  The
trees come across as they are: a LayerNorm's bias, a gemma2 pair's
``local`` and ``global`` layers with their post-norms, an untied
``lm_head`` (pixtral, DeepSeek-V3), qk-norm's ``qn``/``kn``, the MoE
router, the stacked expert weights ``wg``/``wi``/``wo`` (E, d, f) and the
shared expert's, MLA's low-rank projections and norms, DeepSeek-V3's
``mtp`` subtree (carried, read by no serving path) and Whisper's
``encoder`` and ``decoder`` groups (``ln_cross``, ``cross_attn``) are
leaves like any other.  A bfloat16 leaf (``ml_dtypes.bfloat16``, DeepSeek-V3's parameter
dtype) comes across bit for bit.  The optimizer's state (the reference's
``train/optimizer.py::OptState``: step, mu, nu) comes across by
:func:`opt_state_from_numpy`, so one step of each package starts from the
same state."""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..train.optimizer import OptState
from .layers import tree_map


def _tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor of its dtype; numpy has no bfloat16 of its
    own and ``torch.from_numpy`` refuses ml_dtypes', so a bfloat16 array's
    bits are taken as uint16 and viewed as bfloat16."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Any,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Any:
    """Every array leaf as a tensor of the same dtype on ``device``
    (None: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a).to(dev), tree,
                    lambda x: isinstance(x, np.ndarray))


def opt_state_from_numpy(state: Any,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> OptState:
    """The reference's ``OptState(step, mu, nu)`` with numpy leaves (or any
    (step, mu, nu) triple) as the port's: step an int32 scalar, the
    moments' trees through :func:`params_from_numpy` on ``device`` (None:
    the card)."""
    step, mu, nu = state
    dev = resolve_device(device)
    return OptState(torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                 device=dev),
                    params_from_numpy(mu, dev), params_from_numpy(nu, dev))
