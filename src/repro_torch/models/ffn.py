"""Dense feed-forward blocks: SwiGLU, GeGLU, GELU, squared-ReLU.

The products are plain ``torch.matmul`` (cuBLAS), as the reference leaves
them to its compiler.  Over the grid's ``model`` axis (``tp``) ``w_in`` and
``w_gate`` are column-parallel ([p, D, F/t]) and ``w_out`` row-parallel
([p, F/t, D]): each local shard computes its slice of the hidden layer, and
the partial products are summed over the axis in ``cfg.dtype``
(``tp.block_in`` / ``tp.block_out``: a reduce-scatter along the sequence
under sequence parallelism)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..distributed.pods import Pods
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


def ffn_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                tp: Optional[Pods] = None) -> torch.Tensor:
    if tp is not None and p["w_in"].dim() == 3:
        xin = tp.block_in(x)
        parts = [ffn_forward(cfg, {k: w[i] for k, w in p.items()}, xin[i])
                 for i in range(tp.local)]
        return tp.block_out(torch.stack(parts))
    h = x @ p["w_in"].to(cfg.dtype)
    gate = (x @ p["w_gate"].to(cfg.dtype)) if "w_gate" in p else None
    h = activation(cfg.ffn_act, h, gate)
    return h @ p["w_out"].to(cfg.dtype)
