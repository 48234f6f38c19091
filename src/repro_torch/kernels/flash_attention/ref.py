"""Plain PyTorch version of blocked causal (optionally windowed) attention."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,S,hd]; k,v: [B,K,S,hd] (GQA).  Returns [B,H,S,hd] f32."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, K, G, S, hd).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale
    qi = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi[:, None] >= qi[None, :]
    if window is not None:
        mask &= (qi[:, None] - qi[None, :]) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return out.reshape(B, H, S, hd)
