"""Moonlight-16B-A3B [moe + mla] (hf:moonshotai/Moonlight-16B-A3B, DeepSeek-V3's
block): 27L d_model=2048, 16 heads of multi-head latent attention (a cached
512-wide latent and a 64-wide RoPE key shared by the heads; per head qk_nope
128, v 128, no query LoRA), layer 0 a dense SwiGLU FFN of 11 264, layers
1-26 64 experts of 1 408 top-6 with 2 shared experts, routed by sigmoid
scores plus a correction bias (noaux_tc) and scaled by 2.446, vocab=163840,
untied.  15.96 B parameters: 31.9 GB in bfloat16, so one card serves it whole.
Its residual stream is held in float32 (Megatron-LM's fp32 residual
connection): in bfloat16 the rounding of each residual add changes 2-14 %
of the tokens' top-6 experts against float32, layer by layer.

Not one of the reference's ten (``ARCH_IDS``): the JAX package has no latent
attention, so nothing compares it field for field."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=11264,
    vocab_size=163_840, head_dim=128, ffn_act="silu",
    n_experts=64, experts_per_token=6, moe_d_ff=1408,
    n_shared_experts=2, first_dense_layers=1,
    rope_theta=50_000.0, tie_embeddings=False,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, moe_router="sigmoid", moe_routed_scale=2.446,
    moe_dropless=True, f32_residual=True,
)

#: the CPU tests' size (the card tests run the published widths at fewer
#: layers: the paged MLA kernel has an instance for those widths alone)
SMOKE_CONFIG = ModelConfig(
    name="moonlight-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, head_dim=16, ffn_act="silu",
    n_experts=8, experts_per_token=3, moe_d_ff=32,
    n_shared_experts=2, first_dense_layers=1, tie_embeddings=False,
    rope_theta=50_000.0,
    kv_lora_rank=64, qk_nope_head_dim=16, qk_rope_head_dim=16,
    v_head_dim=16, moe_router="sigmoid", moe_routed_scale=2.446,
    moe_dropless=True, f32_residual=True,
)
