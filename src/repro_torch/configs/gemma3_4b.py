"""Gemma-3-4B [dense] (hf:google/gemma-3-*): 34L d_model=2560 8H (GQA kv=4)
d_ff=10240 (GeGLU) vocab=262144; 5 local (window 1024) : 1 global layer
pattern; global layers use rope_theta=1M for 128k context; qk-norm.
Mostly-local attention: only the global layers (5 of 34) hold full-length
KV in paged slabs; each local layer keeps a per-sequence ring of its window."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab_size=262_144, head_dim=256, qk_norm=True, ffn_act="geglu",
    local_window=1024, local_global_ratio=(5, 1),
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    sub_quadratic=True,
    rule_overrides=(("kv_heads", None), ("heads", None)),  # 8H % 16 != 0
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16, qk_norm=True, ffn_act="geglu",
    local_window=32, local_global_ratio=(5, 1),
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    sub_quadratic=True,
)
