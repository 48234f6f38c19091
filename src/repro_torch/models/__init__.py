"""Models of the port: layer-group stacks of every family of the reference
(dense, MoE, SSM, hybrid, encoder-decoder)."""
from .common import LayerGroup, ModelConfig, layer_groups
from .transformer import (DecodeState, active_param_count, decode_step,
                          forward_encdec, forward_lm, greedy_sample,
                          init_decode_state, init_params, param_count,
                          params_from_jax, prefill, prefill_encdec)

__all__ = [
    "DecodeState", "LayerGroup", "ModelConfig", "active_param_count",
    "decode_step", "forward_encdec", "forward_lm", "greedy_sample",
    "init_decode_state", "init_params", "layer_groups", "param_count",
    "params_from_jax", "prefill", "prefill_encdec",
]
