"""GQA attention: prefill forward through the flash kernel, paged decode
through the paged-attention kernel, and ring-buffer decode for the
local-window layers (plain PyTorch, as the reference computes it outside any
kernel).

Decode reads KV through the paged block-table substrate — the physical frame
ids given to ``attn_decode_paged`` come from the block-table translation
(``PagedKVManager.physical_tables``), i.e. every decode step performs the
paper's address translation.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import NEG_INF
from ..kernels.paged_attention.ops import paged_attention
from ..kvcache.gather import write_token_plain
from .common import ModelConfig, _dense, rms_norm, rope_tables, rotate


def init_attn(cfg: ModelConfig, gen: torch.Generator, dtype
              ) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": _dense(gen, (d, cfg.n_heads * hd), dtype),
        "wk": _dense(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wv": _dense(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wo": _dense(gen, (cfg.n_heads * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 xq: torch.Tensor, xkv: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    hd = cfg.resolved_head_dim
    q = (xq @ p["wq"].to(cfg.dtype)).reshape(B, Sq, cfg.n_heads, hd)
    k = (xkv @ p["wk"].to(cfg.dtype)).reshape(B, Skv, cfg.n_kv_heads, hd)
    v = (xkv @ p["wv"].to(cfg.dtype)).reshape(B, Skv, cfg.n_kv_heads, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


Rope = Tuple[torch.Tensor, torch.Tensor]      # (cos, sin) of rope_tables


def project_qk_rope_v(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, rope: Rope
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention projections with RoPE on q and k: each [B,S,heads,hd]."""
    q, k, v = _project_qkv(cfg, p, x, x)
    return rotate(q, rope), rotate(k, rope), v


def attend_causal(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: Optional[int]) -> torch.Tensor:
    """The flash kernel, causal, on projected q/k/v [B,S,heads,hd], then
    ``wo``.  The kernel takes [B,heads,S,hd]: it is handed transposed views
    (it reads through strides, no copy is made)."""
    B, S = q.shape[:2]
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True, window=window)
    out = out.to(cfg.dtype).transpose(1, 2).reshape(B, S, -1)
    return out @ p["wo"].to(cfg.dtype)


def attn_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor, *, window: Optional[int],
                 rope_theta: float) -> torch.Tensor:
    """Training / prefill self-attention.  x: [B,S,D]; positions: [B,S] and
    must count 0..S-1 along each row (what ``forward_lm`` and ``prefill``
    pass): the kernel masks by index.  window: sliding-window size for local
    layers (None = full)."""
    rope = rope_tables(positions, cfg.resolved_head_dim, rope_theta)
    q, k, v = project_qk_rope_v(cfg, p, x, rope)
    return attend_causal(cfg, p, q, k, v, window=window)


def attn_decode_paged(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, positions: torch.Tensor,
                      kv: Tuple[torch.Tensor, torch.Tensor],
                      phys_blocks: torch.Tensor, seq_lens: torch.Tensor, *,
                      rope: Rope, window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step (one new token per sequence) with paged KV.

    x: [B, 1, D]; positions: [B]; kv: (k_slabs, v_slabs) for THIS layer,
    each [n_blocks, bt, K, hd] and UPDATED IN PLACE; phys_blocks:
    [B, max_blocks] physical frame ids from the block-table translation
    (-1 = absent); seq_lens: [B] length INCLUDING the new token; rope: the
    step's (cos, sin) tables of ``rope_tables(positions[:, None], ...)``,
    made once by the caller because every layer of a group shares them.
    Returns (attn_out [B,1,D], the same slabs).
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    bt = kv[0].shape[-3]
    q, k_new, v_new = project_qk_rope_v(cfg, p, x, rope)
    # write the new token's KV, then attend through the block table
    k_slabs, v_slabs = write_token_plain(kv[0], kv[1], k_new[:, 0], v_new[:, 0],
                                         phys_blocks, positions, bt)
    out = paged_attention(q[:, 0].contiguous(), k_slabs, v_slabs, phys_blocks,
                          seq_lens, window=window)
    out = out.reshape(B, 1, cfg.n_heads * hd).to(cfg.dtype)
    out = out @ p["wo"].to(cfg.dtype)
    return out, (k_slabs, v_slabs)


def attn_decode_ring(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, positions: torch.Tensor,
                     ring_k: torch.Tensor, ring_v: torch.Tensor, *,
                     rope: Rope, window: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step of a sliding-window layer whose KV is a ring of
    ``window`` slots per sequence: slot i holds the latest position p with
    p % window == i.

    x: [B, 1, D]; positions: [B]; ring_k/ring_v: [B, window, K, hd] for THIS
    layer, UPDATED IN PLACE (the new token goes to slot positions % window);
    rope: the step's tables, as for ``attn_decode_paged``.  Scores, softmax
    and the product with V are float32.  Returns (attn_out [B,1,D], ring_k,
    ring_v)."""
    B = x.shape[0]
    K, G, hd = cfg.n_kv_heads, cfg.q_per_kv, cfg.resolved_head_dim
    q, k_new, v_new = project_qk_rope_v(cfg, p, x, rope)
    pos = positions.long()
    rows = torch.arange(B, device=x.device)
    ring_k[rows, pos % window] = k_new[:, 0].to(ring_k.dtype)
    ring_v[rows, pos % window] = v_new[:, 0].to(ring_v.dtype)
    scores = torch.einsum("bkgd,bskd->bkgs",
                          q[:, 0].reshape(B, K, G, hd).float(),
                          ring_k.float()) * hd ** -0.5
    idx = torch.arange(window, device=x.device)[None, :]
    pos = pos[:, None]
    pos_in_slot = pos - (pos - idx) % window
    valid = ((pos_in_slot >= 0) & (pos_in_slot >= pos - window + 1)
             & (pos_in_slot <= pos))
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, ring_v.float())
    out = out.reshape(B, 1, cfg.n_heads * hd).to(cfg.dtype)
    return out @ p["wo"].to(cfg.dtype), ring_k, ring_v
