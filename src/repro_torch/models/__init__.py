"""Models of the port: dense decoder-only layer-group stacks."""
from .common import LayerGroup, ModelConfig, layer_groups
from .transformer import (DecodeState, decode_step, forward_lm, greedy_sample,
                          init_decode_state, init_params, params_from_jax,
                          prefill)

__all__ = [
    "DecodeState", "LayerGroup", "ModelConfig", "decode_step", "forward_lm",
    "greedy_sample", "init_decode_state", "init_params", "layer_groups",
    "params_from_jax", "prefill",
]
