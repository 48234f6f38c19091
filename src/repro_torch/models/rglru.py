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

Over the grid's ``model`` axis (``tp``; the reference's ``ff`` rule) the
block splits by channel: ``rg_in``, ``rg_gate``, the conv and ``rg_a`` hold
each local shard's w/t channels, ``out_proj`` its rows; ``w_r`` and ``w_i``
``[w, w]`` stay replicated.  The gates of a shard's channels read the whole
conv output ``xb``, so one all-gather gives every shard the whole ``xb``
``[B, S, w]``, which it multiplies by its columns of ``w_r`` / ``w_i``
(through ``tp.copy_in``).  The scan and the state ``h`` [B, w/t] are per
shard, and ``out_proj``'s partial products are summed over the axis in
``cfg.dtype``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.pods import Pods
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


def _gates(p: Dict[str, torch.Tensor], xb: torch.Tensor,
           xb_all: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence h = a h + b, float32, for the channels of
    ``xb``; the gates' products read ``xb_all`` (default ``xb``: every
    channel) through ``w_r`` / ``w_i``'s columns of those channels."""
    xb_all = xb if xb_all is None else xb_all
    r = torch.sigmoid(xb_all @ p["w_r"].to(xb.dtype))
    i = torch.sigmoid(xb_all @ p["w_i"].to(xb.dtype))
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


def _conv_in(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
             state: Optional[torch.Tensor] = None):
    """The linear in (xin, the conv's input), the conv's output after SiLU
    (xb) and the output gate, of the channels ``p`` holds."""
    xin = x @ p["rg_in"].to(cfg.dtype)
    xb = F.silu(_causal_conv(xin, p["conv_w"], p["conv_b"], state=state))
    gate = F.gelu(x @ p["rg_gate"].to(cfg.dtype), approximate="tanh")
    return xin, xb, gate


def _per_shard(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               tp: Pods, states=None):
    """Each local shard's leaves (with its channels' columns of the
    replicated ``w_r`` / ``w_i``), its ``_conv_in``, and the whole ``xb``
    [..., w] it reads."""
    xin, shared = tp.block_in(x), {n: tp.copy_in(p[n]) for n in ("w_r", "w_i")}
    ws = p["rg_in"].shape[-1]
    shards, convs = [], []
    for i, shard in enumerate(tp.local_indices()):
        cols = slice(shard * ws, (shard + 1) * ws)
        sp = {k: w[i] for k, w in p.items() if k not in shared}
        sp.update({n: w[i][:, cols] for n, w in shared.items()})
        shards.append(sp)
        convs.append(_conv_in(cfg, sp, xin[i],
                              None if states is None else states[i]))
    xbs = tp.all_gather(torch.stack([xb for _, xb, _ in convs]))
    whole = [xbs[i].movedim(0, -2).flatten(-2) for i in range(tp.local)]
    return shards, convs, whole


def _conv_tail(cfg: ModelConfig, xin: torch.Tensor) -> torch.Tensor:
    W, S = cfg.conv_width, xin.shape[1]
    return F.pad(xin, (0, 0, W - 1, 0))[:, S:S + W - 1].to(cfg.dtype)


def rglru_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                  return_state: bool = False, tp: Optional[Pods] = None):
    """x: [B, S, D] -> [B, S, D].  With ``return_state`` also returns
    ``{"h": [B,w] float32, "conv": [B,W-1,w]}`` after the last token (over a
    split model axis ``tp`` each local shard's, stacked [p, ...])."""
    if tp is not None and p["rg_in"].dim() == 3:
        shards, convs, whole = _per_shard(cfg, p, x, tp)
        parts, states = [], []
        for sp, (xin, xb, gate), xb_all in zip(shards, convs, whole):
            h = linear_scan(*_gates(sp, xb, xb_all), dim=1)
            parts.append((h * gate.float()).to(cfg.dtype)
                         @ sp["out_proj"].to(cfg.dtype))
            states.append((h[:, -1], _conv_tail(cfg, xin)))
        out = tp.block_out(torch.stack(parts))
        if not return_state:
            return out
        return out, {"h": torch.stack([h for h, _ in states]),
                     "conv": torch.stack([c for _, c in states])}
    xin, xb, gate = _conv_in(cfg, p, x)
    a, b = _gates(p, xb)                                      # [B,S,w] f32
    h = linear_scan(a, b, dim=1)
    y = (h * gate.float()).to(cfg.dtype)
    out = y @ p["out_proj"].to(cfg.dtype)
    if not return_state:
        return out
    return out, {"h": h[:, -1], "conv": _conv_tail(cfg, xin)}


def rglru_decode(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 h: torch.Tensor, conv_state: torch.Tensor,
                 tp: Optional[Pods] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) decode.  x: [B,1,D]; h: [B,w] float32; conv_state: [B,W-1,w]
    (over a split model axis ``tp`` each local shard's, stacked [p, ...]).
    Returns (out [B,1,D], new h, new conv_state); the inputs are not
    modified."""
    if tp is not None and p["rg_in"].dim() == 3:
        shards, convs, whole = _per_shard(cfg, p, x, tp, states=conv_state)
        parts, hs, tails = [], [], []
        for i, (sp, (xin, xb, gate), xb_all) in enumerate(
                zip(shards, convs, whole)):
            a, b = _gates(sp, xb[:, 0], xb_all[:, 0])
            hs.append(a * h[i] + b)
            parts.append(((hs[-1] * gate[:, 0].float()).to(cfg.dtype)
                          @ sp["out_proj"].to(cfg.dtype))[:, None])
            tails.append(torch.cat([conv_state[i].to(x.dtype), xin],
                                   dim=1)[:, 1:])
        return (tp.psum(torch.stack(parts))[0], torch.stack(hs),
                torch.stack(tails))
    xin, xb, gate = _conv_in(cfg, p, x, state=conv_state)
    new_conv = torch.cat([conv_state.to(x.dtype), xin], dim=1)
    a, b = _gates(p, xb[:, 0])
    h = a * h + b
    y = (h * gate[:, 0].float()).to(cfg.dtype)
    out = (y @ p["out_proj"].to(cfg.dtype))[:, None]
    return out, h, new_conv[:, 1:]
