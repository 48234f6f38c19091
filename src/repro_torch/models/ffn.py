"""Dense feed-forward blocks: SwiGLU, GeGLU, GELU, squared-ReLU.

The products are plain ``torch.matmul`` (cuBLAS), as the reference leaves
them to its compiler."""
from __future__ import annotations

from typing import Dict

import torch

from .common import ModelConfig, _dense, activation, ffn_has_gate


def init_ffn(cfg: ModelConfig, gen: torch.Generator, dtype, d_ff: int = 0
             ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    p = {
        "w_in": _dense(gen, (d, f), dtype),
        "w_out": _dense(gen, (f, d), dtype),
    }
    if ffn_has_gate(cfg.ffn_act):
        p["w_gate"] = _dense(gen, (d, f), dtype)
    return p


def ffn_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
                ) -> torch.Tensor:
    h = x @ p["w_in"].to(cfg.dtype)
    gate = (x @ p["w_gate"].to(cfg.dtype)) if "w_gate" in p else None
    h = activation(cfg.ffn_act, h, gate)
    return h @ p["w_out"].to(cfg.dtype)
