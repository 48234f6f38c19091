"""Mamba-2 SSD (state-space duality) block, chunked, in plain PyTorch.

The minimal-SSD formulation of the Mamba-2 paper (arXiv:2405.21060,
Listing 1), with a loop over chunks for the inter-chunk recurrence:

  within-chunk (quadratic):  Y_diag = (C Bᵀ ∘ L) · (dt x)
  chunk state:               S_c    = Σ decay · B (dt x)
  inter-chunk (linear):      h_c    = exp(ā_c) h_{c-1} + S_c
  cross term:                Y_off  = C · h_{c-1} · decay_in

Decode is the O(1) recurrent form: h = exp(dt A) h + dt B ⊗ x, y = C·h + D x.
Every product is written as a two-operand step, so that no product ever
holds a six-axis intermediate (``[B, nc, Q, Q, H, P]`` would be 17 GB at
batch 16 and 2 048 tokens in float32).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, _dense


def init_ssd(cfg: ModelConfig, gen: torch.Generator, dtype
             ) -> Dict[str, torch.Tensor]:
    d, d_inner = cfg.d_model, cfg.d_inner
    n, h = cfg.ssm_state, cfg.ssm_n_heads
    conv_ch = d_inner + 2 * n
    dev = gen.device
    return {
        "in_proj": _dense(gen, (d, 2 * d_inner + 2 * n + h), dtype),
        "conv_w": _dense(gen, (cfg.conv_width, conv_ch), dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)).to(dtype),
        "dt_bias": torch.zeros((h,), dtype=dtype, device=dev),
        "d_skip": torch.ones((h,), dtype=dtype, device=dev),
        "norm_scale": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "out_proj": _dense(gen, (d_inner, d), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d.  x: [B,S,C]; w: [W,C]; state: the W-1
    inputs before x (zeros when None).  A sum over the taps in order, in
    ``x.dtype``, as the reference writes it (a library convolution would
    accumulate in float32 and round a bf16 result differently)."""
    W, S = w.shape[0], x.shape[1]
    pad = (x.new_zeros((x.shape[0], W - 1, x.shape[2])) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xBC, dt


def _gated_norm_out(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                    y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated RMSNorm of Mamba-2 (float32, eps 1e-6, ``1 + scale``), then
    ``out_proj`` in ``cfg.dtype``.  y: [..., d_inner] float32."""
    y = y * F.silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * (1.0 + p["norm_scale"].float())
    return y.to(cfg.dtype) @ p["out_proj"].to(cfg.dtype)


def ssd_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                return_state: bool = False):
    """Training / prefill forward.  x: [B, S, D] -> [B, S, D].  With
    ``return_state`` also returns ``{"h": [B,H,n,P] float32, "conv":
    [B,W-1,conv_ch]}``, the decode state after the last of the S tokens."""
    B, S, _ = x.shape
    d_inner, n, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    P, Q = cfg.ssm_head_dim, cfg.ssm_chunk
    orig_S = S
    if S % Q:                       # pad the tail chunk; the padded rows'
        x = F.pad(x, (0, 0, 0, Q - S % Q))   # outputs are sliced off
        S = x.shape[1]
    nc = S // Q

    zxbcdt = x @ p["in_proj"].to(cfg.dtype)
    z, xBC_pre, dt = _split_proj(cfg, zxbcdt)
    xBC = F.silu(_causal_conv(xBC_pre, p["conv_w"], p["conv_b"]))
    xs = xBC[..., :d_inner].reshape(B, S, H, P)
    Bm = xBC[..., d_inner:d_inner + n]                        # [B,S,n] (1 group)
    Cm = xBC[..., d_inner + n:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())       # [B,S,H]
    A = -torch.exp(p["a_log"].float())                        # [H]

    # chunked SSD, float32 --------------------------------------------------
    xs_c = xs.reshape(B, nc, Q, H, P).float()
    B_c = Bm.reshape(B, nc, Q, n).float()
    C_c = Cm.reshape(B, nc, Q, n).float()
    dt_c = dt.reshape(B, nc, Q, H)
    a_c = dt_c * A                                            # log decay
    a_cum = torch.cumsum(a_c, dim=2)                          # [B,nc,Q,H]
    xdt = xs_c * dt_c[..., None]                              # [B,nc,Q,H,P]

    # decay within a chunk, L[q,k] = exp(a_cum[q] - a_cum[k]) for q >= k,
    # masked BEFORE exp (exp of an anti-causal pair could overflow)
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]   # [B,nc,Q,Q,H]
    qi = torch.arange(Q, device=x.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    del seg
    scores = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)       # [B,nc,Q,Q]
    L.mul_(scores[..., None])                                 # scores ∘ L
    y = torch.einsum("bcqkh,bckhp->bcqhp", L, xdt)            # y_diag
    del L, scores

    # chunk states: S_c = sum_k exp(a_cum[last] - a_cum[k]) B_k (x dt)_k
    decay_out = torch.exp(a_cum[:, :, -1:, :] - a_cum)        # [B,nc,Q,H]
    states = torch.einsum("bckn,bckhp->bchnp", B_c,
                          xdt * decay_out[..., None])         # [B,nc,H,n,P]
    chunk_decay = torch.exp(a_cum[:, :, -1, :])               # [B,nc,H]

    # the recurrence over chunks; h_prev[:, c] is the state BEFORE chunk c
    h = torch.zeros((B, H, n, P), dtype=torch.float32, device=x.device)
    h_prev = torch.empty_like(states)
    for c in range(nc):
        h_prev[:, c] = h
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    del states

    y_off = torch.einsum("bcqn,bchnp->bcqhp", C_c, h_prev)    # [B,nc,Q,H,P]
    y = y + y_off * torch.exp(a_cum)[..., None]
    del y_off
    y = y.reshape(B, S, H, P) + xs.float() * p["d_skip"].float()[:, None]
    out = _gated_norm_out(cfg, p, y.reshape(B, S, d_inner), z)
    if orig_S != S:
        out = out[:, :orig_S]
    if not return_state:
        return out
    if orig_S != S:
        # the final state with the padded rows folded in is not the state at
        # orig_S: replay the recurrence one step at a time over the real rows
        # of the partial chunk, from the state before it
        c0 = orig_S // Q
        h = h_prev[:, c0]
        da = torch.exp(a_c[:, c0])                            # [B,Q,H]
        for t in range(orig_S - c0 * Q):
            upd = (B_c[:, c0, t][:, None, :, None]
                   * xdt[:, c0, t][:, :, None, :])            # [B,H,n,P]
            h = h * da[:, t][:, :, None, None] + upd
    W = cfg.conv_width
    pre = F.pad(xBC_pre[:, :orig_S], (0, 0, W - 1, 0))
    conv_tail = pre[:, orig_S:orig_S + W - 1]
    return out, {"h": h, "conv": conv_tail.to(cfg.dtype)}


def ssd_decode(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               h: torch.Tensor, conv_state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) decode step.  x: [B,1,D]; h: [B,H,n,P] float32; conv_state:
    [B, W-1, conv_ch].  Returns (out [B,1,D], new h, new conv_state); the
    inputs are not modified."""
    B = x.shape[0]
    d_inner, n, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    P = cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"].to(cfg.dtype)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    new_conv = torch.cat([conv_state.to(x.dtype), xBC], dim=1)
    xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"], state=conv_state))
    xs = xBC[:, 0, :d_inner].reshape(B, H, P).float()
    Bm = xBC[:, 0, d_inner:d_inner + n].float()
    Cm = xBC[:, 0, d_inner + n:].float()
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"].float())   # [B,H]
    A = -torch.exp(p["a_log"].float())
    da = torch.exp(dt1 * A)                                      # [B,H]
    upd = Bm[:, None, :, None] * (dt1[:, :, None] * xs)[:, :, None, :]
    h = h * da[:, :, None, None] + upd                           # [B,H,n,P]
    y = torch.einsum("bn,bhnp->bhp", Cm, h)
    y = y + xs * p["d_skip"].float()[:, None]
    out = _gated_norm_out(cfg, p, y.reshape(B, 1, d_inner), z)
    return out, h, new_conv[:, 1:]
