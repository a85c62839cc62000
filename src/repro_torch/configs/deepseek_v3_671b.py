"""DeepSeek-V3 671B (arXiv:2412.19437) — MLA + 1 shared/256 routed top-8 MoE
+ multi-token prediction, parameters in bfloat16."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432,                    # dense FFN in the first 3 layers
    vocab_size=129280,
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    n_dense_layers=3, router_type="sigmoid", capacity_factor=1.0,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    mtp_depth=1, tie_embeddings=False,
    param_dtype="bfloat16",
)
