"""Mamba2-370M [ssm] (arXiv:2405.21060): attention-free SSD.  48L
d_model=1024, d_inner=2048 (expand 2), ssm_state=128, head_dim=64
(32 SSD heads), conv width 4, chunk 64, vocab=50280.
It has no attention and no KV blocks: served, the block table is still
walked every step, but no layer reads a frame.  Sub-quadratic: runs
long_500k."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab_size=50_280, ssm_state=128, ssm_head_dim=64, ssm_chunk=64,
    conv_width=4, expand=2, use_rope=False, sub_quadratic=True,
    rule_overrides=(("kv_heads", None), ("heads", None)),
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0,
    vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    conv_width=4, expand=2, use_rope=False, sub_quadratic=True,
)
