"""KV slab writes and gathers: one pool, pool-partitioned, and the
sequence-parallel (flash-decoding) decode attention.

The slabs are updated IN PLACE: a token write or a prefill scatter stores
into the caller's ``[F, bt, K, hd]`` tensors and returns them.  Rows whose
block is unmapped (-1 tables: inactive/padding rows) store nothing.  No
function here waits for the device: shapes never depend on the data.

Latent attention (MLA) holds one slab a layer, ``[F, bt, 1, dk]`` or
pooled ``[P, F_local, bt, 1, dk]``: ``write_latent`` and ``scatter_latent``
are its token write and prefill scatter.

Pool-partitioned slabs are ``[P, F_local, bt, K, hd]`` (stacked ``[L, P,
...]``) and a block table then holds frame ids LOCAL to a row's pool.  On one
device every pooled function takes the reference's no-mesh form: the pools
are flattened to ``[P * F_local, ...]`` and a row's frames to global ids,
``frame + pool_of(b) * F_local`` with ``pool_of(b) = b // max(B // P, 1)``,
so a pooled decode is the same single paged-attention launch as an unpooled
one.  ``decode_attention_sp`` also runs over a pod axis: each shard takes a
slice of the table's columns and its own pool (``repro_torch.distributed``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..distributed.pods import Pods
from ..kernels.paged_attention.ops import paged_attention


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


def _slot_rows(phys_blocks: torch.Tensor, positions: torch.Tensor,
               block_tokens: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slab row ``frame * bt + position % bt`` of each position [B] or
    [B, S] through the rows' tables [B, MB], and whether its block is
    mapped, both flattened."""
    bt = block_tokens
    pos = positions.long()
    if pos.dim() == 1:
        pos = pos[:, None]
    blk = (pos // bt).clamp(0, phys_blocks.shape[1] - 1)
    frame = phys_blocks.long().gather(1, blk)
    return (frame * bt + pos % bt).reshape(-1), (frame >= 0).reshape(-1)


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
    rows, valid = _slot_rows(phys_blocks, positions, block_tokens)
    _masked_row_store((k_slabs, v_slabs), rows, (k_new, v_new), valid)
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
    rows, valid = _slot_rows(phys_blocks, positions, block_tokens)
    _masked_row_store((k_slabs, v_slabs), rows,
                      (k.flatten(0, 1), v.flatten(0, 1)), valid)
    return k_slabs, v_slabs


def write_latent(slab: torch.Tensor, latent: torch.Tensor,
                 phys_blocks: torch.Tensor, positions: torch.Tensor,
                 block_tokens: int) -> torch.Tensor:
    """``write_token_plain`` for latent attention's one slab: each row's
    new latent [B, dk] into slab [F, bt, 1, dk] through its frame, in
    place."""
    rows, valid = _slot_rows(phys_blocks, positions, block_tokens)
    _masked_row_store((slab,), rows, (latent,), valid)
    return slab


def scatter_latent(slab: torch.Tensor, latent: torch.Tensor,
                   phys_blocks: torch.Tensor, positions: torch.Tensor,
                   block_tokens: int, pools: int = 1) -> torch.Tensor:
    """A prompt's latents [B,S,dk] into slab [F, bt, 1, dk] (``pools`` > 1:
    [P, F_local, bt, 1, dk], frames local to each row's pool), in place;
    tokens of unmapped blocks are dropped, as ``scatter_prefill_plain``
    drops them."""
    flat = slab
    if pools > 1:
        phys_blocks = pooled_tables(phys_blocks, *slab.shape[:2])
        flat = _flat(slab)
    rows, valid = _slot_rows(phys_blocks, positions, block_tokens)
    _masked_row_store((flat,), rows, (latent.flatten(0, 1),), valid)
    return slab


# ------------------------------------------------------------------ pools
def pool_of_rows(B: int, n_pools: int, device=None) -> torch.Tensor:
    """[B] pool of each batch row, as the reference's no-mesh form assigns
    them: ``b // max(B // n_pools, 1)``."""
    pool = torch.arange(B, device=device) // max(B // n_pools, 1)
    if B and (B - 1) // max(B // n_pools, 1) >= n_pools:
        raise ValueError(f"{B} rows do not split over {n_pools} pools")
    return pool


def pooled_tables(phys_blocks: torch.Tensor, n_pools: int, f_local: int
                  ) -> torch.Tensor:
    """Pool-local frame ids [B, MB] -> global ids of the flattened pools
    (row b's pool is ``pool_of_rows``); -1 stays -1."""
    pool = pool_of_rows(phys_blocks.shape[0], n_pools, phys_blocks.device)
    glob = phys_blocks + (pool * f_local).to(phys_blocks.dtype)[:, None]
    return torch.where(phys_blocks >= 0, glob, torch.full_like(glob, -1))


def sp_tables(phys_blocks: torch.Tensor, n_pools: int, f_local: int
              ) -> torch.Tensor:
    """Sequence-parallel layout: column c of a table lives in pool
    ``c // (MB / n_pools)``.  Pool-local ids [B, MB] -> global ids."""
    MB = phys_blocks.shape[1]
    if MB % n_pools:
        raise ValueError(f"{MB} table columns do not split over {n_pools} "
                         "shards")
    shard = torch.arange(MB, device=phys_blocks.device) // (MB // n_pools)
    glob = phys_blocks + (shard * f_local).to(phys_blocks.dtype)[None, :]
    return torch.where(phys_blocks >= 0, glob, torch.full_like(glob, -1))


def _flat(slabs: torch.Tensor) -> torch.Tensor:
    """[P, F_local, ...] -> [P * F_local, ...] (a view)."""
    return slabs.view((slabs.shape[0] * slabs.shape[1],) + slabs.shape[2:])


def scatter_prefill_pooled(k_slabs: torch.Tensor, v_slabs: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           phys_blocks: torch.Tensor, positions: torch.Tensor,
                           block_tokens: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool-partitioned prefill scatter (frames local to each row's pool),
    in place."""
    P, F = k_slabs.shape[:2]
    scatter_prefill_plain(_flat(k_slabs), _flat(v_slabs), k, v,
                          pooled_tables(phys_blocks, P, F), positions,
                          block_tokens)
    return k_slabs, v_slabs


# ------------------------------------------------------ sequence parallel
def decode_attention_sp(q: torch.Tensor, k_slabs: torch.Tensor,
                        v_slabs: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, phys_blocks: torch.Tensor,
                        positions: torch.Tensor, seq_lens: torch.Tensor, *,
                        block_tokens: int, n_kv: int,
                        window: Optional[int] = None,
                        pods: Optional[Pods] = None,
                        softcap: Optional[float] = None,
                        kv_heads: Optional[Tuple[int, int]] = None):
    """Sequence-parallel paged decode attention (flash-decoding).

    The block table's COLUMNS are split over the shards: shard s owns
    columns [s * MBl, (s + 1) * MBl) of every row, MBl = MB / n, and the
    frames they point to live in its pool (frame ids local to it).

    q [B,H,hd]; k/v_new [B,K,hd]; phys_blocks [B,MB]; positions, seq_lens
    [B] (seq_lens including the new token).  Without ``pods``: k/v_slabs
    [n, F_local, bt, K, hd] (the reference's no-mesh form: pools flattened,
    one paged-attention launch).  With ``pods``: k/v_slabs [p, F_local, bt,
    K, hd], this process's pools; each shard writes the new token if its
    block is in its slice, gets its partial (output and log-sum-exp) from
    one paged-attention launch at its shard-local lengths ``seq_len - s *
    MBl * bt`` (a shard wholly past the row has no live slot: output 0, LSE
    ``NEG_INF``), and the partials combine by ``pmax`` / ``psum`` — the only
    traffic between shards.  ``softcap``: the logit cap, applied by each
    shard's launch (the LSE is of the capped scores, so the combine is the
    same).  ``kv_heads`` = (first, count): a model shard's kv heads of
    slabs that hold more; the new token is written into those heads only
    and every launch reads them (K1's head range), q holding the shard's
    query heads.  Returns (out [B,H,hd] f32, k_slabs, v_slabs)."""
    bt = block_tokens
    B, MB = phys_blocks.shape
    heads = (slice(None) if kv_heads is None
             else slice(kv_heads[0], kv_heads[0] + kv_heads[1]))
    if pods is None:
        n, F = k_slabs.shape[:2]
        glob = sp_tables(phys_blocks, n, F)
        kf, vf = _flat(k_slabs), _flat(v_slabs)
        write_token_plain(kf[..., heads, :], vf[..., heads, :], k_new, v_new,
                          glob, positions, bt)
        return (paged_attention(q, kf, vf, glob, seq_lens, window=window,
                                softcap=softcap, kv_heads=kv_heads),
                k_slabs, v_slabs)
    n, p = pods.n, k_slabs.shape[0]
    if MB % n:
        raise ValueError(f"{MB} table columns do not split over {n} shards")
    MBl = MB // n
    shard = pods.index()                                        # [p]
    cols = phys_blocks.view(B, n, MBl)[:, shard].transpose(0, 1)  # [p,B,MBl]
    col0 = shard * MBl
    pos = positions.long()
    blk = pos // bt
    mine = (blk[None] >= col0[:, None]) & (blk[None] < col0[:, None] + MBl)
    local_col = (blk[None] - col0[:, None]).clamp(0, MBl - 1)
    frame = cols.long().gather(2, local_col[..., None])[..., 0]  # [p, B]
    lens = (seq_lens.long()[None] - col0[:, None] * bt).to(torch.int32)
    H, hd = q.shape[1:]
    outs, lses = [], []
    for i in range(p):
        _masked_row_store((k_slabs[i][..., heads, :],
                           v_slabs[i][..., heads, :]),
                          frame[i] * bt + pos % bt, (k_new, v_new),
                          mine[i] & (frame[i] >= 0))
        # the kernel takes operands of their own (16-byte aligned), not
        # slices of a stack
        lses.append(torch.empty((B, H), dtype=torch.float32, device=q.device))
        outs.append(paged_attention(q, k_slabs[i], v_slabs[i], cols[i].clone(),
                                    lens[i].clone(), window=window,
                                    lse=lses[-1], softcap=softcap,
                                    kv_heads=kv_heads))
    return (sp_combine(torch.stack(outs), torch.stack(lses), pods), k_slabs,
            v_slabs)


def sp_combine(out: torch.Tensor, lse: torch.Tensor, pods: Pods
               ) -> torch.Tensor:
    """The shards' partials out [p, B, H, hd] (each normalised over its
    own slots) and their log-sum-exps lse [p, B, H] -> the attention over
    all shards [B, H, hd]: weights exp(lse - max), one ``pmax`` and two
    ``psum``; the denominator is floored at 1e-30, as the reference's."""
    w = torch.exp(lse - pods.pmax(lse))
    num = pods.psum(out * w[..., None])
    den = pods.psum(w)
    return (num / den.clamp_min(1e-30)[..., None])[0]
