"""Pixtral-12B (hf:mistralai/Pixtral-12B-2409) — mistral-nemo decoder
backbone; vision frontend STUBBED to precomputed patch embeddings."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    n_patches=256, rope_theta=1000000000.0, tie_embeddings=False,
)
