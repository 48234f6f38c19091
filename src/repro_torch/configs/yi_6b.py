"""Yi-6B [dense] (arXiv:2403.04652): llama-architecture GQA.  32L
d_model=4096 32H (GQA kv=4) d_ff=11008 (SwiGLU) vocab=64000."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab_size=64_000, head_dim=128, ffn_act="silu",
    rope_theta=5_000_000.0, tie_embeddings=False,
    rule_overrides=(("kv_heads", None),),
)

SMOKE_CONFIG = ModelConfig(
    name="yi-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, head_dim=16, ffn_act="silu", tie_embeddings=False,
)
