"""Carry the reference's parameters across: the JAX package's parameter
tree, as numpy arrays with the same nesting (dicts, and the list of a
Zamba2 period's SSM layers), becomes the port's tree of tensors.  The
dense trees come across as they are: a LayerNorm's bias, a gemma2 pair's
``local`` and ``global`` layers with their post-norms, and an untied
``lm_head`` (pixtral) are leaves like any other."""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from .layers import tree_map


def params_from_numpy(tree: Any,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Any:
    """Every array leaf as a tensor of the same dtype on ``device``
    (None: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree,
                    lambda x: isinstance(x, np.ndarray))
