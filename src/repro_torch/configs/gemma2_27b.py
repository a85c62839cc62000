"""Gemma2-27B (arXiv:2408.00118) — alternating local(4096)/global attention,
attn+final logit softcaps, post-norms."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    local_global=True, sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0, post_norms=True,
    act="gelu", rope_theta=10000.0,
)
