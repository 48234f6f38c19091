"""Qwen3-235B-A22B [moe] (hf:Qwen/Qwen3-235B-A22B): 94L d_model=4096
64H (GQA kv=4) per-expert d_ff=1536, 128 experts top-8, vocab=151936,
qk-norm.  A layer holds 4.83 GB of experts in bfloat16, so one card serves
it with its depth cut."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=0,
    vocab_size=151_936, head_dim=128, qk_norm=True, ffn_act="silu",
    n_experts=128, experts_per_token=8, moe_d_ff=1536,
    rope_theta=1_000_000.0, tie_embeddings=False,
    rule_overrides=(("kv_heads", None),),
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=0,
    vocab_size=512, head_dim=16, qk_norm=True, ffn_act="silu",
    n_experts=8, experts_per_token=2, moe_d_ff=96, tie_embeddings=False,
    moe_capacity_factor=8.0,
)
