"""Plain PyTorch version of paged decode attention.

Semantics: one query token per sequence attends over its paged KV cache.
``block_tables`` holds PHYSICAL frame ids (outputs of the block-table
translation); -1 marks absent blocks.  Token t of sequence b lives in slab
frame ``block_tables[b, t // bt]`` at slot ``t % bt``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..flash_attention.ref import soft_cap

NEG_INF = -2.0 ** 30


def paged_attention_ref(q: torch.Tensor, k_slabs: torch.Tensor,
                        v_slabs: torch.Tensor, block_tables: torch.Tensor,
                        seq_lens: torch.Tensor, *,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, return_lse: bool = False,
                        kv_heads: Optional[Tuple[int, int]] = None,
                        softcap: Optional[float] = None):
    """q: [B,H,hd]; k/v_slabs: [N,bt,K,hd]; block_tables: [B,MB];
    seq_lens: [B] (valid tokens per sequence).  Returns [B,H,hd] f32; with
    ``return_lse`` also each row's ln sum exp(s) of its scores s over its
    live slots [B,H] f32 (``NEG_INF`` for a row with none).  ``kv_heads``:
    (first, count) to attend over kv heads [first, first + count) of slabs
    that hold more (a model shard's heads of a replicated slab); q's H heads
    then map onto those ``count``.  ``softcap`` = c: s = c * tanh(scale q.k
    / c) (the reference's ``_gqa_scores``), else s = scale q.k."""
    if kv_heads is not None:
        first, count = kv_heads
        k_slabs = k_slabs[:, :, first:first + count]
        v_slabs = v_slabs[:, :, first:first + count]
    B, H, hd = q.shape
    _, bt, K, _ = k_slabs.shape
    MB = block_tables.shape[1]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5

    tables = block_tables.long()
    lens = seq_lens.long()
    frames = tables.clamp_min(0)
    k = k_slabs[frames].reshape(B, MB * bt, K, hd).float()    # [B,T,K,hd]
    v = v_slabs[frames].reshape(B, MB * bt, K, hd).float()
    qg = q.reshape(B, K, G, hd).float()
    scores = soft_cap(torch.einsum("bkgd,btkd->bkgt", qg, k) * scale, softcap)
    t = torch.arange(MB * bt, device=q.device)
    valid = t[None, :] < lens[:, None]
    valid &= (tables >= 0).repeat_interleave(bt, dim=1)
    if window is not None:
        valid &= t[None, :] >= (lens[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    # a masked slot's probability is exactly 0 unless the whole row is
    # masked; zero it there too, so a row with no live block returns 0
    probs = probs * valid[:, None, None, :]
    out = torch.einsum("bkgt,btkd->bkgd", probs, v).reshape(B, H, hd)
    if not return_lse:
        return out
    live = valid.any(dim=1)[:, None, None]
    lse = torch.logsumexp(scores, dim=-1)
    lse = torch.where(live, lse, torch.full_like(lse, NEG_INF))
    return out, lse.reshape(B, H)


def paged_attention_split_ref(q: torch.Tensor, k_slabs: torch.Tensor,
                              v_slabs: torch.Tensor, block_tables: torch.Tensor,
                              seq_lens: torch.Tensor, *, n_splits: int,
                              cols_per_split: int,
                              window: Optional[int] = None) -> torch.Tensor:
    """The kernel's split-KV arithmetic in plain PyTorch, for the tests.

    Split s of a row takes block-table columns [base + s * cols_per_split,
    base + (s + 1) * cols_per_split), base being the window's first column
    (0 without a window).  Each split's (m, l, acc) comes from the plain
    version's math over its live slots (m = NEG_INF, l = 0, acc = 0 when it
    has none); the splits merge by max, rescale, sum, denominator floored at
    1e-30."""
    B, H, hd = q.shape
    _, bt, K, _ = k_slabs.shape
    MB = block_tables.shape[1]
    G = H // K
    scale = hd ** -0.5

    tables = block_tables.long()
    lens = seq_lens.long()
    frames = tables.clamp_min(0)
    k = k_slabs[frames].reshape(B, MB * bt, K, hd).float()
    v = v_slabs[frames].reshape(B, MB * bt, K, hd).float()
    scores = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, K, G, hd).float(),
                          k) * scale
    t = torch.arange(MB * bt, device=q.device)
    valid = t[None, :] < lens[:, None]
    valid &= (tables >= 0).repeat_interleave(bt, dim=1)
    lo = torch.zeros_like(lens)
    if window is not None:
        lo = (lens - window).clamp_min(0)
        valid &= t[None, :] >= lo[:, None]
    rel = (t // bt)[None, :] - (lo // bt)[:, None]          # [B, T]
    owner = torch.div(rel, cols_per_split, rounding_mode="floor")
    owner = torch.where((rel >= 0) & (owner < n_splits), owner, -1)
    splits = torch.arange(n_splits, device=q.device)
    member = valid[:, None, :] & (owner[:, None, :] == splits[None, :, None])
    member = member[:, None, None]                           # [B,1,1,n,T]
    masked = torch.where(member, scores[:, :, :, None, :],
                         torch.full((), NEG_INF, device=q.device))
    m = masked.amax(dim=-1)                                  # [B,K,G,n]
    p = torch.exp(masked - m[..., None]) * member
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnt,btkd->bkgnd", p, v)
    f = torch.exp(m - m.amax(dim=-1, keepdim=True))
    out = (acc * f[..., None]).sum(dim=-2) / (l * f).sum(
        dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, H, hd)


def mla_decode_ref(q: torch.Tensor, slab: torch.Tensor,
                   block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
                   scale: float, dv: int) -> torch.Tensor:
    """Paged latent-attention decode (MLA), plain: q [B,H,dk] (the absorbed
    query and the rope query) attends over each row's live latents, the
    slab [N,bt,1,dk] read through ``block_tables`` [B,MB] (-1 absent) up to
    ``seq_lens`` [B]; V is the latents' first ``dv`` columns.  Returns
    softmax(scale q.latent) . latent[:, :dv] as [B,H,dv] float32; a row
    with no live slot returns zeros."""
    B, H, dk = q.shape
    N, bt = slab.shape[:2]
    MB = block_tables.shape[1]
    tables = block_tables.long()
    lat = slab.reshape(N, bt, dk)[tables.clamp_min(0)].reshape(
        B, MB * bt, dk).float()
    scores = torch.einsum("bhd,btd->bht", q.float(), lat) * scale
    t = torch.arange(MB * bt, device=q.device)
    valid = t[None, :] < seq_lens.long()[:, None]
    valid &= (tables >= 0).repeat_interleave(bt, dim=1)
    scores = torch.where(valid[:, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1) * valid[:, None, :]
    return torch.einsum("bht,btd->bhd", probs, lat[..., :dv])
