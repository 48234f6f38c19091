"""Plain PyTorch version of the fused block-table walk + degree-d prefetch.

Given a block-table replica and a batch of logical block ids, return for
each id: the translated physical frame (-1 on miss / invalid), a present
flag, and the 2^d-entry prefetch window around the entry (the paper's Fig 5
semantics: the window is clipped to the covering table page).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...pagedpt.blocktable import unpack_entry


def pte_gather_ref(entries: torch.Tensor, logical: torch.Tensor,
                   prefetch_degree: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """entries: [T, epb] int32 packed PTEs; logical: [M] ids (-1 = none).

    Returns (frames [M] i32, present [M] bool, window [M, 2^d] raw entries)."""
    T, epb = entries.shape
    W = 1 << prefetch_degree
    lg = logical.long()
    tid = (lg // epb).clamp(0, T - 1)          # floor division, as numpy
    idx = lg % epb                             # non-negative remainder
    raw = entries[tid, idx]
    ok = (lg >= 0) & (lg < T * epb) & (raw >= 0)
    frame, _ = unpack_entry(raw)
    frames = torch.where(ok, frame, torch.full_like(frame, -1))
    start = (idx - W // 2).clamp(0, epb - W)
    cols = start[:, None] + torch.arange(W, device=entries.device)[None, :]
    window = entries[tid[:, None], cols]
    window = torch.where((lg >= 0)[:, None], window,
                         torch.full_like(window, -1))
    return frames, ok, window
