"""Models of the port: decoder-only layer-group stacks, dense or MoE."""
from .common import LayerGroup, ModelConfig, layer_groups
from .transformer import (DecodeState, active_param_count, decode_step,
                          forward_lm, greedy_sample, init_decode_state,
                          init_params, param_count, params_from_jax, prefill)

__all__ = [
    "DecodeState", "LayerGroup", "ModelConfig", "active_param_count",
    "decode_step", "forward_lm", "greedy_sample", "init_decode_state",
    "init_params", "layer_groups", "param_count", "params_from_jax", "prefill",
]
