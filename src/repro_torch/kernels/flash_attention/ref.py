"""Plain PyTorch versions of blocked causal (optionally windowed) attention
and of its gradient.

``softcap`` = c caps the scaled scores as the reference's ``_gqa_scores``
does, ``s = c * tanh(s / c)``, before the mask; the softmax, its
log-sum-exp and the gradient are of the capped scores (the gradient of the
raw score gains the factor ``1 - tanh(s / c)^2``).  None (or 0) is no cap."""
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


def soft_cap(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """``c * tanh(s / c)`` of scaled scores, in the reference's order, or
    ``s`` itself without a cap."""
    if not softcap:
        return s
    return torch.tanh(s / softcap) * softcap


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int], scale: float,
            softcap: Optional[float] = None) -> torch.Tensor:
    """Scaled, capped, masked float32 scores [B,K,G,S,S] (masked entries
    NEG_INF)."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(B, K, H // K, S, hd).float()
    s = soft_cap(torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale,
                 softcap)
    mask = visible_mask(S, causal, window, q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, return_lse: bool = False,
                        softcap: Optional[float] = None
                        ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q: [B,H,S,hd]; k,v: [B,K,S,hd] (GQA).  Returns [B,H,S,hd] f32, and
    with ``return_lse`` also the rows' log-sum-exp [B,H,S] f32 (natural log
    of the scaled, capped scores s: the softmax is exp(s - lse))."""
    B, H, S, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    s = _scores(q, k, causal, window, scale, softcap)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", p, v.float()).reshape(B, H, S, hd)
    if not return_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor,
                            dout: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            softcap: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_ref`` by its explicit formulas (not
    autograd), in float32: D = rowsum(dO * O), P = exp(s - lse) of the
    scaled (and capped) scores s, dV = P^T dO, dS = P * (dO V^T - D), times
    1 - (s / c)^2 under a cap c, dQ = scale * dS K, dK = scale * dS^T Q,
    with dK and dV summed over each kv head's G query heads.  Returns
    (dq [B,H,S,hd], dk, dv [B,K,S,hd])."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    s = _scores(q, k, causal, window, scale, softcap)
    mask = visible_mask(S, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, K, G, S, 1).float()),
                    torch.zeros_like(s))
    do = dout.reshape(B, K, G, S, hd).float()
    d = (do * out.reshape(B, K, G, S, hd).float()).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, do)
    dp = torch.einsum("bkgqd,bktd->bkgqt", do, v.float())
    ds = p * (dp - d)
    if softcap:
        # d(c tanh(x / c)) / dx = 1 - tanh^2; masked pairs have p = 0
        ds = ds * torch.where(mask, 1 - torch.square(s / softcap), 0.0)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds,
                      q.reshape(B, K, G, S, hd).float()) * scale
    return dq.reshape(B, H, S, hd), dk, dv
