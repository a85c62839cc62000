"""Model configuration: the port's own copy of ``repro/models/config.py``
(the same fields, defaults and smoke reduction), covering every family
of the reference, all of which the port serves.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000

    # ---- attention flavour ----
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 = global only
    local_global: bool = False     # gemma2 alternating local/global
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    post_norms: bool = False       # gemma2 post-attn/post-mlp norms
    qk_norm: bool = False

    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0        # leading dense FFN layers (deepseek: 3)
    capacity_factor: float = 1.25
    router_type: str = "softmax"   # softmax | sigmoid (deepseek-v3)
    router_aux_coef: float = 0.01

    # ---- MLA (deepseek-v3) ----
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- multi-token prediction (deepseek-v3) ----
    mtp_depth: int = 0

    # ---- SSM (mamba2 SSD) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_groups: int = 1

    # ---- hybrid (zamba2) ----
    hybrid_period: int = 0         # shared attention block every k SSM layers

    # ---- enc-dec (whisper) ----
    n_encoder_layers: int = 0
    encoder_seq: int = 0           # audio frames after the (stubbed) conv frontend

    # ---- VLM (pixtral) ----
    n_patches: int = 0             # stubbed image patch embeddings per sample

    # ---- numerics / execution ----
    gated_mlp: bool = True         # SwiGLU-style; False = fc1/act/fc2
    act: str = "silu"              # silu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    unroll: bool = False           # python-loop layers instead of lax.scan
                                   # (probe compiles: XLA cost analysis
                                   # counts a scan body once; unrolled
                                   # graphs count every layer)
    attn_impl: str = "chunked"     # chunked | naive | pallas
    attn_chunk: int = 1024

    # ------------------------------------------------------------------
    @property
    def qk_head_dim(self) -> int:
        if self.use_mla:
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_moe_layer(self, idx: int) -> bool:
        return self.n_experts > 0 and idx >= self.n_dense_layers

    def validate(self) -> None:
        if self.family in ("dense", "moe", "encdec"):
            assert self.n_heads > 0 and self.head_dim > 0 or self.use_mla
            if not self.use_mla:
                assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        if self.local_global:
            assert self.n_layers % 2 == 0 and self.sliding_window > 0

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64,
        vocab_size=256,
        d_ff=128 if cfg.d_ff else 0,
        rope_theta=cfg.rope_theta,
        name=cfg.name + "-smoke",
    )
    if cfg.use_mla:
        kw.update(n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    elif cfg.n_heads:
        kv = max(1, min(cfg.n_kv_heads, 2))
        kw.update(n_heads=4, n_kv_heads=kv if 4 % kv == 0 else 1, head_dim=16)
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=2, moe_d_ff=64,
                  n_dense_layers=min(cfg.n_dense_layers, 1),
                  n_shared_experts=cfg.n_shared_experts)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.local_global:
        kw.update(sliding_window=32)
    if cfg.hybrid_period:
        kw.update(hybrid_period=2, n_layers=5, n_heads=4, n_kv_heads=2,
                  head_dim=16)
    if cfg.n_encoder_layers:
        kw.update(n_encoder_layers=2, encoder_seq=16)
    if cfg.n_patches:
        kw.update(n_patches=4)
    if cfg.mtp_depth:
        kw.update(mtp_depth=1)
    return cfg.scaled(**kw)
