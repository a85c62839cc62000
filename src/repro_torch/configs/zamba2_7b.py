"""Zamba2-7B (arXiv:2411.15242) — Mamba2 backbone + shared attention block
every 6 SSM layers (weights reused, concat-skip input)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    ssm_groups=1, hybrid_period=6,
)
