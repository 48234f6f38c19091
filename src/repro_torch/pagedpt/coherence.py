"""Cross-pod coherence collectives for the per-pod device block tables.

The counterparts of the reference's ``shard_map`` bodies over its ``pod``
axis, on the port's pod axis (``repro_torch.distributed.pods``): each
function takes this process's replicas ``local_entries [p, T, epb]`` and the
pod-sharded buffers with a leading local-pod dimension ``[p, ...]``;
``sharers`` and ``owner`` ``[T]`` are replicated.  They are the two
coherence styles of the paper:

  * ``eager_sync``        — Mitosis.  Every pod broadcasts its mutation
    buffer to every other pod each step (all-gather over the pods), because
    with full replication any pod may cache any entry.
  * ``numapte_miss_fetch`` — the paper.  Pods fetch only the entries they
    miss, from the owner pod, with degree-d prefetch; sharer bitmasks are
    maintained with a tiny OR-reduce.

The *shootdown filter* (invariant I2) is ``sharer_filter_mask``: a mutation
is applied on a pod only if that pod is in the sharer mask of the touched
table.

Every apply and the owner's window answer run through the page walk,
``kernels.pte_gather`` (K3: its mutation drain, ``applied`` = the filter;
its walk, whose window start ``clamp(idx - W/2, 0, epb - W)`` is the
reference's): the p replicas are stacked as one table ``[p*T, epb]``, table
ids offset by ``local_pod * T``, so a phase is one launch whatever p is.  On
a CUDA tensor that is the kernel; on the CPU its plain version.  The
replicas are updated IN PLACE.

Differences from the reference, kept on purpose (``ROADMAP.md`` queue 3):
a mutation not applied writes nothing (the reference routes it to a dummy
slot), and a mutation naming a slot outside the table is rejected (a device
assert on the card) where the reference's flat index wraps into another
table.  Sharer masks are int64 here (the reference's uint32 has no shifts
in PyTorch); P <= 31.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..distributed.pods import Pods
from ..kernels.pte_gather.ops import pte_gather

MAX_PODS = 31


def _stacked_tables(tables: torch.Tensor, idx: torch.Tensor, T: int, epb: int
                    ) -> torch.Tensor:
    """Table ids [p, ...] of the local pods' stacked replica ``[p*T,
    epb]``; a slot outside its own replica becomes table -1, which the drain
    rejects (rather than letting it land in the next replica)."""
    p = tables.shape[0]
    t, i = tables.long(), idx.long()
    inside = (t >= 0) & (t < T) & (i >= 0) & (i < epb)
    base = torch.arange(p, device=tables.device).view(
        (p,) + (1,) * (t.dim() - 1)) * T
    return torch.where(inside, t + base, torch.full_like(t, -1))


def _mutations(local_entries: torch.Tensor, tables, idx, value, applied
               ) -> Tuple[torch.Tensor, ...]:
    """A drain list over the stacked replica from per-pod lists [p, N]."""
    _, T, epb = local_entries.shape
    flat = lambda x: x.reshape(-1).contiguous()
    return (flat(_stacked_tables(tables, idx, T, epb).to(torch.int32)),
            flat(idx.to(torch.int32)), flat(value.to(torch.int32)),
            flat(applied.to(torch.bool)))


def _walk(local_entries: torch.Tensor, ids: torch.Tensor, degree: int,
          mutations: Optional[Sequence[torch.Tensor]]):
    """One K3 launch on the stacked replica: drain ``mutations``, then walk
    the stacked ids [n]."""
    p, T, epb = local_entries.shape
    if not local_entries.is_contiguous():
        raise ValueError("coherence: the replicas must be contiguous")
    return pte_gather(local_entries.view(p * T, epb),
                      ids.reshape(-1).to(torch.int32).contiguous(), degree,
                      mutations)


def _gathered(pods: Pods, *bufs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Every pod's buffer [p, B] -> [p, n*B], pod-major (the reference's
    ``all_gather(...).reshape(-1)``)."""
    return tuple(pods.all_gather(b).reshape(b.shape[0], -1) for b in bufs)


def eager_sync(local_entries: torch.Tensor, mut_tables: torch.Tensor,
               mut_idx: torch.Tensor, mut_value: torch.Tensor,
               mut_valid: torch.Tensor, pods: Pods) -> torch.Tensor:
    """Mitosis-style coherence: gather every pod's mutation buffer [p, B]
    and apply all of them to every replica, in place.  One all-gather of
    the buffers, one K3 drain.  Returns ``local_entries``."""
    g = _gathered(pods, mut_tables, mut_idx, mut_value, mut_valid)
    _walk(local_entries, torch.empty(0, dtype=torch.int32,
                                     device=local_entries.device), 0,
          _mutations(local_entries, *g))
    return local_entries


def sharer_filter_mask(sharers: torch.Tensor, mut_tables: torch.Tensor,
                       mut_valid: torch.Tensor, pods: Pods) -> torch.Tensor:
    """numaPTE's shootdown filter: keep only mutations whose table lists the
    pod as a sharer.  sharers [T]; mut_tables/mut_valid [p, N] -> bool
    [p, N]."""
    n_tables = sharers.shape[0]
    me = pods.index()
    tid = mut_tables.long().clamp(0, n_tables - 1)
    bit = (sharers.long()[tid] >> me[:, None]) & 1
    return mut_valid.to(torch.bool) & (bit == 1)


def _reduce_or(masks: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the last dimension of int64 masks of up to 32 bits."""
    bits = torch.arange(MAX_PODS + 1, device=masks.device)
    present = ((masks[..., None] >> bits) & 1).amax(dim=-2)
    return (present << bits).sum(-1)


def shootdown_scope(sharers: torch.Tensor, mut_tables: torch.Tensor,
                    mut_valid: torch.Tensor) -> torch.Tensor:
    """Union of the sharer masks of the touched tables: the pods that must
    take part in the invalidation.  mut_tables/mut_valid [..., N] -> int64
    [...]."""
    n_tables = sharers.shape[0]
    tid = mut_tables.long().clamp(0, n_tables - 1)
    masks = torch.where(mut_valid.to(torch.bool), sharers.long()[tid],
                        torch.zeros_like(tid))
    return _reduce_or(masks)


def _filtered(local_entries, sharers, mut_tables, mut_idx, mut_value,
              mut_valid, pods):
    g_tables, g_idx, g_value, g_valid = _gathered(
        pods, mut_tables, mut_idx, mut_value, mut_valid)
    keep = sharer_filter_mask(sharers, g_tables, g_valid, pods)
    return _mutations(local_entries, g_tables, g_idx, g_value, keep)


def numapte_apply_filtered(local_entries: torch.Tensor, sharers: torch.Tensor,
                           mut_tables: torch.Tensor, mut_idx: torch.Tensor,
                           mut_value: torch.Tensor, mut_valid: torch.Tensor,
                           pods: Pods) -> torch.Tensor:
    """numaPTE coherence for updates (the mprotect/munmap analogue): every
    pod's buffer is gathered, and each pod applies only the entries of the
    tables it shares — the device-side shootdown filter.  In place; one
    all-gather, one K3 drain.  Returns ``local_entries``."""
    muts = _filtered(local_entries, sharers, mut_tables, mut_idx, mut_value,
                     mut_valid, pods)
    _walk(local_entries, torch.empty(0, dtype=torch.int32,
                                     device=local_entries.device), 0, muts)
    return local_entries


def numapte_miss_fetch(local_entries: torch.Tensor, sharers: torch.Tensor,
                       owner: torch.Tensor, miss_blocks: torch.Tensor,
                       prefetch_degree: int, pods: Pods, *,
                       drain: Optional[Sequence[torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lazy on-demand fetch of missing block-table entries from owner pods.

    miss_blocks: int32 [p, M] logical block ids each pod missed (-1 = no
    miss).  Returns (the replicas, updated in place; the updated sharer
    masks [T] int64).

      1. all-gather the [M] request buffers;
      2. every pod answers the requests whose table it OWNS, reading a
         2^d-entry window from its replica (the paper's prefetch, Fig 5):
         one K3 walk over the stacked replica, the ids of requests a pod
         does not own set to -1 (their window comes back -1);
      3. all_to_all routes each answer back to the requester, which keeps
         the owner's (the largest) answer;
      4. the requester installs the window (one K3 drain, applied where the
         request is valid and the owner had the entry); a psum of each
         pod's own bit adds it to the sharer mask of every fetched table.

    ``drain``: a drain list for the stacked replica (``_mutations``) that
    the walk's launch applies first (``numapte_prologue``)."""
    p, T, epb = local_entries.shape
    W = 1 << prefetch_degree
    me = pods.index()
    dev = local_entries.device

    reqs = pods.all_gather(miss_blocks).long()                  # [p, n, M]
    tid = (reqs // epb).clamp(0, T - 1)
    base_idx = reqs % epb
    i_am_owner = (owner.long()[tid] == me[:, None, None]) & (reqs >= 0)
    stacked = (torch.arange(p, device=dev)[:, None, None] * T + tid) * epb \
        + base_idx
    ids = torch.where(i_am_owner, stacked, torch.full_like(stacked, -1))
    _, _, window = _walk(local_entries, ids, prefetch_degree, drain)
    window = window.view(p, pods.n, -1, W)                      # [p, n, M, W]

    answers = pods.all_to_all(window)          # [p, n, M, W]: pod q's answer
    merged = answers.amax(dim=1)               # [p, M, W], the owner's

    my = miss_blocks.long()
    my_valid = my >= 0
    my_tid = (my // epb).clamp(0, T - 1)
    my_start = (my % epb - W // 2).clamp(0, epb - W)
    col = my_start[..., None] + torch.arange(W, device=dev)     # [p, M, W]
    applied = my_valid[..., None] & (merged >= 0)
    _walk(local_entries, torch.empty(0, dtype=torch.int32, device=dev), 0,
          _mutations(local_entries, my_tid[..., None].expand_as(col), col,
                     merged, applied))

    # sharer masks: each pod adds its own bit to the tables it fetched
    # (disjoint bits, so the sum is an OR); int32 on the wire, as the
    # reference's uint32 (P <= 31)
    my_bit = (torch.ones_like(me) << me)[:, None].expand_as(my)
    add = torch.zeros((p, T), dtype=torch.int64, device=dev)
    add.scatter_reduce_(1, my_tid, torch.where(my_valid, my_bit,
                                               torch.zeros_like(my_bit)),
                        "amax")
    new_bits = pods.psum(add.to(torch.int32))[0].long()
    return local_entries, sharers.long() | new_bits


def numapte_prologue(local_entries: torch.Tensor, sharers: torch.Tensor,
                     owner: torch.Tensor, mut_tables: torch.Tensor,
                     mut_idx: torch.Tensor, mut_value: torch.Tensor,
                     mut_valid: torch.Tensor, miss_blocks: torch.Tensor,
                     prefetch_degree: int, pods: Pods
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``numapte_apply_filtered`` then ``numapte_miss_fetch`` in two K3
    launches, whatever the number of pods: (the filtered drain + the
    owners' walk), then (the install drain).  Returns (replicas, sharers)."""
    if pods.n > MAX_PODS:
        raise ValueError(f"numaPTE sharer masks hold {MAX_PODS} pods")
    muts = _filtered(local_entries, sharers, mut_tables, mut_idx, mut_value,
                     mut_valid, pods)
    return numapte_miss_fetch(local_entries, sharers, owner, miss_blocks,
                              prefetch_degree, pods, drain=muts)
