"""The model stack of the port: the dense (granite, starcoder2, pixtral,
gemma2), MoE (OLMoE, DeepSeek-V3 with MLA), Mamba2 and Zamba2 families'
layers, parameters, prefill, decode and training's forward
(``repro/models`` is the reference)."""
from .config import ModelConfig, smoke_variant
from .layers import param_count
from .model import (decode_step, forward_train, init_cache, init_model,
                    model_specs, prefill)

__all__ = ["ModelConfig", "decode_step", "forward_train", "init_cache",
           "init_model", "model_specs", "param_count", "prefill",
           "smoke_variant"]
