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

Over the grid's ``model`` axis (``tp``; the reference's ``ff`` rule) the
layer splits by head: ``launch/specs.py:shard_params`` gives each local
shard chunk i of every section of ``in_proj`` (``[z | x | B | C | dt]``) and
of the conv (``[x | B | C]``), its H/t entries of ``a_log``/``dt_bias``/
``d_skip`` and its rows of ``out_proj``; ``norm_scale`` stays replicated.
Each shard projects and convolves its channels, one all-gather gives every
shard the whole B and C ``[B, S, n]`` (one group), the chunk scan runs on
the shard's H/t heads, the gated RMSNorm's sum of squares over d_inner is
summed over the axis before its ``rsqrt``, and ``out_proj``'s partial
products are summed over the axis in ``cfg.dtype``.  The decode state is
per shard: ``h`` [B, H/t, n, P] and the conv tail of its channels.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.pods import Pods
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


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, n: int):
    """``in_proj``'s output [..., 2 d_inner + 2 n + H] (a shard's: its
    chunk of each section) -> z, the conv's input [x | B | C], dt."""
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xBC, dt


def _gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return y * F.silu(z.float())


def _norm_out(cfg: ModelConfig, y: torch.Tensor, var: torch.Tensor,
              scale: torch.Tensor, out_proj: torch.Tensor) -> torch.Tensor:
    y = y * torch.rsqrt(var + 1e-6) * (1.0 + scale.float())
    return y.to(cfg.dtype) @ out_proj.to(cfg.dtype)


def _gated_norm_out(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                    y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated RMSNorm of Mamba-2 (float32, eps 1e-6, ``1 + scale``), then
    ``out_proj`` in ``cfg.dtype``.  y: [..., d_inner] float32."""
    y = _gate(y, z)
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return _norm_out(cfg, y, var, p["norm_scale"], p["out_proj"])


class _Shard(dict):
    """The leaves of one local model shard of an SSD layer (its slices of
    the split leaves, the replicated ones whole) and its widths: ``d`` its
    d_inner channels, ``n`` its B / C channels, ``H`` its heads, ``c0`` its
    first channel of d_inner."""

    def __init__(self, p: Dict[str, torch.Tensor], i: int, shard: int,
                 cfg: ModelConfig, t: int, scale: torch.Tensor):
        super().__init__({k: w[i] for k, w in p.items() if k != "norm_scale"})
        self.d, self.n, self.H = cfg.d_inner // t, cfg.ssm_state // t, \
            cfg.ssm_n_heads // t
        self.c0 = shard * self.d
        self["norm_scale"] = scale[self.c0:self.c0 + self.d]


def _shards(cfg: ModelConfig, p: Dict[str, torch.Tensor], tp: Pods
            ) -> List[_Shard]:
    scale = tp.copy_in(p["norm_scale"])
    return [_Shard(p, i, shard, cfg, tp.n, scale[i])
            for i, shard in enumerate(tp.local_indices())]


def _conv_in(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
             d: int, n: int, state: Optional[torch.Tensor] = None):
    """Projection and conv of one layer (or one shard: ``d``, ``n`` its
    widths): z, the conv's input (for the decode state), the conv's output
    [x | B | C] after SiLU, and dt before its bias."""
    z, xBC_pre, dt = _split_proj(x @ p["in_proj"].to(cfg.dtype), d, n)
    xBC = F.silu(_causal_conv(xBC_pre, p["conv_w"], p["conv_b"], state=state))
    return z, xBC_pre, xBC, dt


def _gather_bc(xBCs: List[torch.Tensor], d: int, n: int, tp: Pods
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each local shard's B and C channels (``n`` each, after its ``d``
    channels of x) gathered over the axis: (B, C) [..., t n] for each local
    shard."""
    bc = tp.all_gather(torch.stack([xBC[..., d:] for xBC in xBCs]))
    out = []
    for i in range(tp.local):
        whole = bc[i]                                     # [t, ..., 2 n/t]
        out.append((whole[..., :n].movedim(0, -2).flatten(-2),
                     whole[..., n:].movedim(0, -2).flatten(-2)))
    return out


def _norm_tp(cfg: ModelConfig, shards: List[_Shard], ys: List[torch.Tensor],
             zs: List[torch.Tensor], tp: Pods) -> torch.Tensor:
    """The gated RMSNorm over the whole d_inner (each shard's sum of
    squares summed over the axis) and ``out_proj``, row-parallel: the local
    shards' partial outputs [p, ...]."""
    gated = [_gate(y, z) for y, z in zip(ys, zs)]
    ss = tp.psum(torch.stack([torch.sum(torch.square(g), dim=-1, keepdim=True)
                              for g in gated]))[0]
    var = tp.copy_in(ss / cfg.d_inner)
    return torch.stack([
        _norm_out(cfg, g, var[i], sp["norm_scale"], sp["out_proj"])
        for i, (g, sp) in enumerate(zip(gated, shards))])


def ssd_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                return_state: bool = False, tp: Optional[Pods] = None):
    """Training / prefill forward.  x: [B, S, D] -> [B, S, D].  With
    ``return_state`` also returns ``{"h": [B,H,n,P] float32, "conv":
    [B,W-1,conv_ch]}``, the decode state after the last of the S tokens
    (over a split model axis ``tp`` each local shard's, stacked [p, ...])."""
    orig_S = x.shape[1]
    Q = cfg.ssm_chunk
    if orig_S % Q:                  # pad the tail chunk; the padded rows'
        x = F.pad(x, (0, 0, 0, Q - orig_S % Q))   # outputs are sliced off
    if tp is not None and p["in_proj"].dim() == 3:
        xin = tp.block_in(x)
        shards = _shards(cfg, p, tp)
        conv = [_conv_in(cfg, sp, xin[i], sp.d, sp.n)
                for i, sp in enumerate(shards)]
        bcs = _gather_bc([c[2] for c in conv], shards[0].d, shards[0].n, tp)
        scans = [_scan(cfg, sp, xBC[..., :sp.d], Bm, Cm, dt, orig_S,
                       return_state)
                 for sp, (_, _, xBC, dt), (Bm, Cm) in zip(shards, conv, bcs)]
        # the padded rows' partials are dropped before the sum
        out = tp.block_out(_norm_tp(cfg, shards, [y for y, _ in scans],
                                    [c[0] for c in conv], tp)[:, :, :orig_S])
        states = [_state(cfg, h, c[1], orig_S)
                  for (_, h), c in zip(scans, conv)] if return_state else None
        state = (None if states is None else
                 {k: torch.stack([s[k] for s in states]) for k in ("h", "conv")})
    else:
        d_inner, n = cfg.d_inner, cfg.ssm_state
        z, xBC_pre, xBC, dt = _conv_in(cfg, p, x, d_inner, n)
        y, h = _scan(cfg, p, xBC[..., :d_inner], xBC[..., d_inner:d_inner + n],
                     xBC[..., d_inner + n:], dt, orig_S, return_state)
        out = _gated_norm_out(cfg, p, y, z)
        state = _state(cfg, h, xBC_pre, orig_S) if return_state else None
        out = out[:, :orig_S]
    return out if state is None else (out, state)


def _state(cfg: ModelConfig, h: torch.Tensor, xBC_pre: torch.Tensor,
           orig_S: int) -> Dict[str, torch.Tensor]:
    """The decode state after the prompt's ``orig_S`` tokens: ``h`` and the
    conv's last W - 1 inputs."""
    W = cfg.conv_width
    pre = F.pad(xBC_pre[:, :orig_S], (0, 0, W - 1, 0))
    return {"h": h, "conv": pre[:, orig_S:orig_S + W - 1].to(cfg.dtype)}


def _scan(cfg: ModelConfig, p: Dict[str, torch.Tensor], xs: torch.Tensor,
          Bm: torch.Tensor, Cm: torch.Tensor, dt: torch.Tensor, orig_S: int,
          return_state: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The chunked SSD over the heads of ``p`` (a layer's, or a shard's)
    on a padded sequence: xs [B,S,H*P], Bm / Cm [B,S,n], dt [B,S,H] before
    its bias.  Returns y [B,S,H*P] float32 (the skip term included) and,
    with ``return_state``, the state h [B,H,n,P] after ``orig_S`` tokens."""
    B, S, _ = xs.shape
    n, P, Q = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
    H = dt.shape[-1]
    nc = S // Q
    xs = xs.reshape(B, S, H, P)
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
    qi = torch.arange(Q, device=xs.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    del seg
    scores = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)       # [B,nc,Q,Q]
    if L.requires_grad or scores.requires_grad:
        L = L * scores[..., None]        # exp saved its output for backward
    else:
        L.mul_(scores[..., None])                             # scores ∘ L
    y = torch.einsum("bcqkh,bckhp->bcqhp", L, xdt)            # y_diag
    del L, scores

    # chunk states: S_c = sum_k exp(a_cum[last] - a_cum[k]) B_k (x dt)_k
    decay_out = torch.exp(a_cum[:, :, -1:, :] - a_cum)        # [B,nc,Q,H]
    states = torch.einsum("bckn,bckhp->bchnp", B_c,
                          xdt * decay_out[..., None])         # [B,nc,H,n,P]
    chunk_decay = torch.exp(a_cum[:, :, -1, :])               # [B,nc,H]

    # the recurrence over chunks; h_prev[:, c] is the state BEFORE chunk c
    h = torch.zeros((B, H, n, P), dtype=torch.float32, device=xs.device)
    h_prev = torch.empty_like(states)
    for c in range(nc):
        h_prev[:, c] = h
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    del states

    y_off = torch.einsum("bcqn,bchnp->bcqhp", C_c, h_prev)    # [B,nc,Q,H,P]
    y = y + y_off * torch.exp(a_cum)[..., None]
    del y_off
    y = y.reshape(B, S, H, P) + xs.float() * p["d_skip"].float()[:, None]
    y = y.reshape(B, S, H * P)
    if not return_state:
        return y, None
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
    return y, h


def _step(cfg: ModelConfig, p: Dict[str, torch.Tensor], xs: torch.Tensor,
          Bm: torch.Tensor, Cm: torch.Tensor, dt: torch.Tensor,
          h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step over the heads of ``p``: xs [B,H*P], Bm / Cm
    [B,n], dt [B,H] before its bias, h [B,H,n,P] -> (y [B,1,H*P] float32,
    the new h)."""
    B, H = dt.shape
    xs = xs.reshape(B, H, cfg.ssm_head_dim).float()
    Bm, Cm = Bm.float(), Cm.float()
    dt1 = F.softplus(dt.float() + p["dt_bias"].float())          # [B,H]
    A = -torch.exp(p["a_log"].float())
    da = torch.exp(dt1 * A)                                      # [B,H]
    upd = Bm[:, None, :, None] * (dt1[:, :, None] * xs)[:, :, None, :]
    h = h * da[:, :, None, None] + upd                           # [B,H,n,P]
    y = torch.einsum("bn,bhnp->bhp", Cm, h)
    y = y + xs * p["d_skip"].float()[:, None]
    return y.reshape(B, 1, -1), h


def ssd_decode(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               h: torch.Tensor, conv_state: torch.Tensor,
               tp: Optional[Pods] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) decode step.  x: [B,1,D]; h: [B,H,n,P] float32; conv_state:
    [B, W-1, conv_ch] (over a split model axis ``tp``: each local shard's,
    stacked [p, ...]).  Returns (out [B,1,D], new h, new conv_state); the
    inputs are not modified."""
    if tp is not None and p["in_proj"].dim() == 3:
        xin = tp.copy_in(x)
        shards = _shards(cfg, p, tp)
        conv = [_conv_in(cfg, sp, xin[i], sp.d, sp.n, state=conv_state[i])
                for i, sp in enumerate(shards)]
        bcs = _gather_bc([c[2] for c in conv], shards[0].d, shards[0].n, tp)
        steps = [_step(cfg, sp, xBC[:, 0, :sp.d], Bm[:, 0], Cm[:, 0],
                       dt[:, 0], h[i])
                 for i, (sp, (_, _, xBC, dt), (Bm, Cm))
                 in enumerate(zip(shards, conv, bcs))]
        out = tp.psum(_norm_tp(cfg, shards, [y for y, _ in steps],
                               [c[0] for c in conv], tp))[0]
        new_conv = torch.stack([torch.cat([conv_state[i].to(x.dtype), c[1]],
                                          dim=1)[:, 1:]
                                for i, c in enumerate(conv)])
        return out, torch.stack([hs for _, hs in steps]), new_conv
    d_inner, n = cfg.d_inner, cfg.ssm_state
    z, xBC_pre, xBC, dt = _conv_in(cfg, p, x, d_inner, n, state=conv_state)
    y, h = _step(cfg, p, xBC[:, 0, :d_inner], xBC[:, 0, d_inner:d_inner + n],
                 xBC[:, 0, d_inner + n:], dt[:, 0], h)
    out = _gated_norm_out(cfg, p, y, z)
    new_conv = torch.cat([conv_state.to(x.dtype), xBC_pre], dim=1)
    return out, h, new_conv[:, 1:]
