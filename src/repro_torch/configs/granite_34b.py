"""Granite-34B-Code (arXiv:2405.04324) — dense llama-arch, MQA (kv=1)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    act="gelu", tie_embeddings=True, rope_theta=10000.0,
    gated_mlp=False,
)
