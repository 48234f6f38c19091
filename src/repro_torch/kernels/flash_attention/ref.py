"""Plain PyTorch versions of blocked causal (optionally windowed) attention
and of its gradient."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -2.0 ** 30


def visible_mask(S: int, causal: bool, window: Optional[int],
                 device=None) -> torch.Tensor:
    """[S, S] bool: may query row i see key j."""
    qi = torch.arange(S, device=device)
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= qi[:, None] >= qi[None, :]
    if window is not None:
        mask &= (qi[:, None] - qi[None, :]) < window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int], scale: float) -> torch.Tensor:
    """Scaled, masked float32 scores [B,K,G,S,S] (masked entries NEG_INF)."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(B, K, H // K, S, hd).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale
    mask = visible_mask(S, causal, window, q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, return_lse: bool = False
                        ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q: [B,H,S,hd]; k,v: [B,K,S,hd] (GQA).  Returns [B,H,S,hd] f32, and
    with ``return_lse`` also the rows' log-sum-exp [B,H,S] f32 (natural log
    of the scaled scores: the softmax is exp(scale * q.k - lse))."""
    B, H, S, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    s = _scores(q, k, causal, window, scale)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", p, v.float()).reshape(B, H, S, hd)
    if not return_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor,
                            dout: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_ref`` by its explicit formulas (not
    autograd), in float32: D = rowsum(dO * O), P = exp(scale * s - lse),
    dV = P^T dO, dS = P * (dO V^T - D), dQ = scale * dS K,
    dK = scale * dS^T Q, with dK and dV summed over each kv head's G query
    heads.  Returns (dq [B,H,S,hd], dk, dv [B,K,S,hd])."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    s = _scores(q, k, causal, window, scale)
    mask = visible_mask(S, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, K, G, S, 1).float()),
                    torch.zeros_like(s))
    do = dout.reshape(B, K, G, S, hd).float()
    d = (do * out.reshape(B, K, G, S, hd).float()).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, do)
    dp = torch.einsum("bkgqd,bktd->bkgqt", do, v.float())
    ds = p * (dp - d)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds,
                      q.reshape(B, K, G, S, hd).float()) * scale
    return dq.reshape(B, H, S, hd), dk, dv
