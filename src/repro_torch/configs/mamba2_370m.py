"""Mamba2-370M (arXiv:2405.21060) — attention-free SSD."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    ssm_groups=1,
)
