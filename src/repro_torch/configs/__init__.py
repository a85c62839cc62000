"""Architecture configs the port serves, as ``repro/configs``:
``get_config(name)`` returns the full published config, ``get_smoke(name)``
a reduced same-family variant for CPU tests."""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig, smoke_variant

ARCHS = ["whisper_large_v3", "olmoe_1b_7b", "deepseek_v3_671b",
         "granite_34b", "gemma2_27b", "starcoder2_3b", "gemma2_9b",
         "mamba2_370m", "pixtral_12b", "zamba2_7b"]


def norm_name(name: str) -> str:
    return name.replace("-", "_")


def get_config(name: str) -> ModelConfig:
    if norm_name(name) not in ARCHS:
        raise NotImplementedError(f"{name!r}: the port serves {ARCHS}")
    mod = importlib.import_module(f".{norm_name(name)}", __package__)
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    return smoke_variant(get_config(name))
