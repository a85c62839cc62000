"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version."""
from __future__ import annotations

from pathlib import Path
from typing import List


def build_all() -> List[Path]:
    """Compile every kernel source of the port not yet built (the
    min-plus, SSD and flash-attention libraries), all ``nvcc`` processes
    started together; the kernels' modules then load them at first use."""
    from .build import build_libraries
    from .flash_attention import kernel as flash
    from .minplus import kernel as minplus
    from .ssd import kernel as ssd
    return build_libraries([*minplus.SOURCES.values(), *ssd.SOURCES.values(),
                            *flash.SOURCES.values()])
