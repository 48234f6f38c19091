"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), in
plain PyTorch.

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_r x_t)                    (recurrence gate)
    i_t = sigmoid(W_i x_t)                    (input gate)
    a_t = a ^ (c * r_t),  a = sigmoid(Lambda) (learned, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The sequence form scans the affine recurrence h_t = a_t h_{t-1} + b_t with a
log-depth doubling scan (Hillis-Steele, ceil(log2 S) steps of whole-tensor
operations); decode is the O(1) recurrence.  The block wraps the RG-LRU with
the Griffin recurrent-block structure: linear in, short causal conv, RG-LRU,
gated output.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, _dense
from .ssm import _causal_conv

RG_C = 8.0


def init_rglru(cfg: ModelConfig, gen: torch.Generator, dtype
               ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = gen.device
    # Lambda such that the retention a = exp(-softplus(Lambda)) at a full
    # recurrence gate spans [0.9, 0.999]:  Lambda = ln(expm1(-ln a))
    a = torch.linspace(0.9, 0.999, w, device=dev)
    return {
        "rg_in": _dense(gen, (d, w), dtype),
        "rg_gate": _dense(gen, (d, w), dtype),
        "conv_w": _dense(gen, (cfg.conv_width, w), dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "w_r": _dense(gen, (w, w), dtype, scale=0.5),
        "w_i": _dense(gen, (w, w), dtype, scale=0.5),
        "rg_a": torch.log(torch.expm1(-torch.log(a))).to(dtype),
        "out_proj": _dense(gen, (w, d), dtype),
    }


def _gates(p: Dict[str, torch.Tensor], xb: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence h = a h + b, float32."""
    r = torch.sigmoid(xb @ p["w_r"].to(xb.dtype))
    i = torch.sigmoid(xb @ p["w_i"].to(xb.dtype))
    log_a = (-RG_C * F.softplus(p["rg_a"].float())) * r.float() * 0.125
    a = torch.exp(log_a)
    b = (torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12))
         * (i.float() * xb.float()))
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along ``dim`` from h_{-1} = 0, for every t.

    A doubling (Hillis-Steele) scan: after the step of offset d, (a_t, b_t)
    composes the d-long window ending at t with the one before it, so
    ceil(log2 S) steps cover the sequence.  Each step makes new tensors
    (the right-hand sides read the previous step's values)."""
    S = a.shape[dim]
    d = 1
    while d < S:
        a_prev, b_prev = a.narrow(dim, 0, S - d), b.narrow(dim, 0, S - d)
        a_tail, b_tail = a.narrow(dim, d, S - d), b.narrow(dim, d, S - d)
        b = torch.cat([b.narrow(dim, 0, d), a_tail * b_prev + b_tail], dim=dim)
        a = torch.cat([a.narrow(dim, 0, d), a_tail * a_prev], dim=dim)
        d *= 2
    return b


def rglru_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                  return_state: bool = False):
    """x: [B, S, D] -> [B, S, D].  With ``return_state`` also returns
    ``{"h": [B,w] float32, "conv": [B,W-1,w]}`` after the last token."""
    xin = x @ p["rg_in"].to(cfg.dtype)
    xb = F.silu(_causal_conv(xin, p["conv_w"], p["conv_b"]))
    gate = F.gelu(x @ p["rg_gate"].to(cfg.dtype), approximate="tanh")
    a, b = _gates(p, xb)                                      # [B,S,w] f32
    h = linear_scan(a, b, dim=1)
    y = (h * gate.float()).to(cfg.dtype)
    out = y @ p["out_proj"].to(cfg.dtype)
    if not return_state:
        return out
    W, S = cfg.conv_width, xin.shape[1]
    pre = F.pad(xin, (0, 0, W - 1, 0))
    conv_tail = pre[:, S:S + W - 1]
    return out, {"h": h[:, -1], "conv": conv_tail.to(cfg.dtype)}


def rglru_decode(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 h: torch.Tensor, conv_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) decode.  x: [B,1,D]; h: [B,w] float32; conv_state: [B,W-1,w].
    Returns (out [B,1,D], new h, new conv_state); the inputs are not
    modified."""
    xin = x @ p["rg_in"].to(cfg.dtype)
    new_conv = torch.cat([conv_state.to(x.dtype), xin], dim=1)
    xb = F.silu(_causal_conv(xin, p["conv_w"], p["conv_b"], state=conv_state))
    gate = F.gelu(x @ p["rg_gate"].to(cfg.dtype), approximate="tanh")
    a, b = _gates(p, xb[:, 0])
    h = a * h + b
    y = (h * gate[:, 0].float()).to(cfg.dtype)
    out = (y @ p["out_proj"].to(cfg.dtype))[:, None]
    return out, h, new_conv[:, 1:]
