"""Whisper-base [audio] (arXiv:2212.04356): encoder-decoder, 6L+6L
d_model=512 8H (MHA) d_ff=2048 vocab=51865, GELU MLP, LayerNorm,
sinusoidal encoder positions + learned decoder positions (448 max).
The conv audio frontend is a stub: input_specs() provides precomputed
frame embeddings on the encoder axis; assigned shapes apply to the
encoder frame axis (decode = one decoder step with seq_len-frame
cross-attention KV)."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=12, n_encoder_layers=6, n_decoder_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=51_865, head_dim=64, ffn_act="gelu", norm="layernorm",
    use_rope=False, max_decoder_len=448, tie_embeddings=True,
    rule_overrides=(("kv_heads", None), ("heads", None), ("ff", None)),
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=4, n_encoder_layers=2, n_decoder_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, head_dim=16, ffn_act="gelu", norm="layernorm",
    use_rope=False, max_decoder_len=64, tie_embeddings=True,
)
