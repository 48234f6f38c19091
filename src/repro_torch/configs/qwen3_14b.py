"""Qwen3-14B [dense] (hf:Qwen/Qwen3-14B): 40L d_model=5120 40H (GQA kv=8)
d_ff=17408 (SwiGLU) vocab=151936, qk-norm, head_dim=128."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17408,
    vocab_size=151_936, head_dim=128, qk_norm=True, ffn_act="silu",
    rope_theta=1_000_000.0, tie_embeddings=False,
    rule_overrides=(("kv_heads", None), ("heads", ("model",))),
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, head_dim=16, qk_norm=True, ffn_act="silu",
    tie_embeddings=False,
)
