"""Gemma2-9B (arXiv:2408.00118) — alternating local/global, softcaps."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    local_global=True, sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0, post_norms=True,
    act="gelu", rope_theta=10000.0,
)
