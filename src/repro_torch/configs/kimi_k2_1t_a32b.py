"""Kimi-K2 1T-A32B [moe] (paper-table spec): 61L d_model=7168 64H
(GQA kv=8) head_dim=112, per-expert d_ff=2048, 384 experts top-8 + 1 shared
expert, first layer dense, vocab=163840.  One MoE layer holds 33.8 GB of
experts in bfloat16, so one card serves it with its depth cut."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=14336,
    vocab_size=163_840, head_dim=112, ffn_act="silu",
    n_experts=384, experts_per_token=8, moe_d_ff=2048,
    n_shared_experts=1, first_dense_layers=1,
    rope_theta=50_000.0, tie_embeddings=False,
    rule_overrides=(("kv_heads", None),),
)

SMOKE_CONFIG = ModelConfig(
    name="kimi-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16, ffn_act="silu",
    n_experts=8, experts_per_token=2, moe_d_ff=96,
    n_shared_experts=1, first_dense_layers=1, tie_embeddings=False,
    moe_capacity_factor=8.0,
)
