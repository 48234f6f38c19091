"""Nemotron-4-15B [dense] (arXiv:2402.16819): 32L d_model=6144 48H
(GQA kv=8) d_ff=24576 vocab=256000, squared-ReLU MLP (no gate),
untied embeddings."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab_size=256_000, head_dim=128, ffn_act="relu2",
    rope_theta=10_000.0, tie_embeddings=False,
    rule_overrides=(("kv_heads", None),),
)

SMOKE_CONFIG = ModelConfig(
    name="nemotron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, head_dim=16, ffn_act="relu2", tie_embeddings=False,
)
