"""Chameleon-34B [vlm]: early-fusion token-based mixed-modal decoder
(arXiv:2405.09818).  48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 (text + VQ image codes).  The image tokenizer frontend is a
stub: the model takes token ids from the fused vocabulary, so the decoder
serves as a plain attention stack.  Chameleon's qk-norm stabilizes the
early-fusion training regime."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=65536, head_dim=128, qk_norm=True, ffn_act="silu",
    rope_theta=10_000.0, tie_embeddings=False,
    rule_overrides=(("kv_heads", None),),   # 8 kv heads < 16-way TP
)

SMOKE_CONFIG = ModelConfig(
    name="chameleon-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, head_dim=16, qk_norm=True, ffn_act="silu",
    tie_embeddings=False,
)
