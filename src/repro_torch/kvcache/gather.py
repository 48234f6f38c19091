"""KV slab writes and the plain gather (single device).

The slabs are updated IN PLACE: a token write or a prefill scatter stores
into the caller's ``[F, bt, K, hd]`` tensors and returns them.  Rows whose
block is unmapped (-1 tables: inactive/padding rows) store nothing.  No
function here waits for the device: shapes never depend on the data.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _masked_row_store(slabs: Tuple[torch.Tensor, ...], rows: torch.Tensor,
                      vals: Tuple[torch.Tensor, ...], valid: torch.Tensor
                      ) -> None:
    """For each slab ``[F, bt, ...]`` viewed as rows ``[F*bt, -1]`` and its
    values ``[n, ...]``: ``slab_rows[rows[i]] = vals[i]`` for every valid i,
    and nothing else.

    Shapes stay static: an invalid entry repeats the first valid entry's
    store (same row, same value, so the duplicate cannot matter), and when
    no entry is valid every entry stores back what its row already holds."""
    n = rows.shape[0]
    first = valid.to(torch.int8).argmax()
    src = torch.where(valid, torch.arange(n, device=rows.device), first)
    rows = rows.clamp_min(0)[src]
    any_valid = valid.any()
    for slab, val in zip(slabs, vals):
        flat = slab.view(slab.shape[0] * slab.shape[1], -1)
        new = val.reshape(n, -1)[src].to(flat.dtype)
        flat.index_copy_(0, rows, torch.where(any_valid, new, flat[rows]))


def write_token_plain(k_slabs: torch.Tensor, v_slabs: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      phys_blocks: torch.Tensor, positions: torch.Tensor,
                      block_tokens: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one new token per sequence into its frame, in place.

    k_slabs [F, bt, K, hd]; k_new [B, K, hd]; phys_blocks [B, MB] physical
    frames; positions [B] of the new tokens.  This is the write half of the
    reference's ``update_gather_plain``; the gathered ``k_all`` copy has no
    counterpart because the paged-attention kernel reads the slabs through
    the block table."""
    bt = block_tokens
    pos = positions.long()
    blk = (pos // bt).clamp(0, phys_blocks.shape[1] - 1)
    frame = phys_blocks.long().gather(1, blk[:, None])[:, 0]
    _masked_row_store((k_slabs, v_slabs), frame * bt + pos % bt,
                      (k_new, v_new), frame >= 0)
    return k_slabs, v_slabs


def gather_readonly(k_stack: torch.Tensor, v_stack: torch.Tensor,
                    layer_idx: int, phys_blocks: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gathered copy of one layer's blocks from the stacked cache
    ``[L, F, bt, K, hd]`` -> ``[B, MB, bt, K, hd]`` (absent blocks read frame
    0 and are masked by the caller).  Only the plain versions use it."""
    gather = phys_blocks.long().clamp_min(0)
    return k_stack[layer_idx][gather], v_stack[layer_idx][gather]


def scatter_prefill_plain(k_slabs: torch.Tensor, v_slabs: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          phys_blocks: torch.Tensor, positions: torch.Tensor,
                          block_tokens: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter a full prompt's KV into the slabs, in place.  k [B,S,K,hd];
    positions [B,S].  Tokens whose block is unmapped (-1: inactive/padding
    rows) are dropped — never redirected into frame 0."""
    bt = block_tokens
    pos = positions.long()
    blk = (pos // bt).clamp(0, phys_blocks.shape[1] - 1)
    frame = phys_blocks.long().gather(1, blk)
    _masked_row_store((k_slabs, v_slabs), (frame * bt + pos % bt).reshape(-1),
                      (k.flatten(0, 1), v.flatten(0, 1)),
                      (frame >= 0).reshape(-1))
    return k_slabs, v_slabs
