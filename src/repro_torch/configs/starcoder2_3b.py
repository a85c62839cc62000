"""StarCoder2-3B (arXiv:2402.19173) — dense GQA kv=2, RoPE."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab_size=49152,
    act="gelu", rope_theta=999999.0, norm="layernorm",
    gated_mlp=False,
)
