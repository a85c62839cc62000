"""Whisper large-v3 (arXiv:2212.04356) — encoder-decoder audio transformer.
The conv frontend is a stub, as in the reference: the input is
precomputed (B, 1500, d_model) frame embeddings."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_encoder_layers=32, encoder_seq=1500,
    d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    norm="layernorm", act="gelu", tie_embeddings=True,
    gated_mlp=False,
)
