"""RecurrentGemma-2B [hybrid]: Griffin architecture (arXiv:2402.19427) —
RG-LRU recurrent blocks with 1 local-attention block per 2 recurrent
(pattern r,r,a).  26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680
(GeGLU) vocab=256000, local window 2048, lru_width=2560.
Sub-quadratic: runs long_500k."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256_000, head_dim=256, ffn_act="geglu",
    local_window=2048, recurrent_ratio=(2, 1), lru_width=2560,
    rope_theta=10_000.0, sub_quadratic=True,
    rule_overrides=(("kv_heads", None), ("heads", None)),  # 10H % 16 != 0
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
    vocab_size=512, head_dim=32, ffn_act="geglu",
    local_window=32, recurrent_ratio=(2, 1), lru_width=64,
    sub_quadratic=True,
)
