"""Plain PyTorch version of the device page walk: mutation drain, then the
block-table walk with the degree-d prefetch window.

Given a block-table replica, an optional mutation list and a batch of
logical block ids: apply the list to the replica in place (last applied
mutation of a slot wins, entries not applied write nothing), then return for
each id the translated physical frame (-1 on miss / invalid), a present flag,
and the 2^d-entry prefetch window around the entry (the paper's Fig 5
semantics: the window is clipped to the covering table page).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ...pagedpt.blocktable import apply_mutations, unpack_entry


def pte_gather_ref(entries: torch.Tensor, logical: torch.Tensor,
                   prefetch_degree: int,
                   mutations: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """entries: [T, epb] int32 packed PTEs, updated in place by
    ``mutations`` = (table, idx, value [n] int32, applied [n] bool) in program
    order; logical: [M] ids (-1 = none).

    Returns (frames [M] i32, present [M] bool, window [M, 2^d] raw entries)."""
    T, epb = entries.shape
    W = 1 << prefetch_degree
    if W > epb:
        raise ValueError(f"pte_gather: window {W} wider than a table page {epb}")
    if mutations is not None and mutations[0].numel():
        table, idx = mutations[0], mutations[1]
        # a slot outside the table is an error, as in the kernel; checked on
        # the device without waiting for it
        torch._assert_async(((table >= 0) & (table < T)
                             & (idx >= 0) & (idx < epb)).all())
        apply_mutations(entries, *mutations)
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
