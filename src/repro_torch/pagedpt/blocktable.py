"""Block-table constants and tensor operations (single replica, no collectives).

Layout notes:
  * an entry is int32 — a physical KV-slab frame, -1 when not present.  One
    row of 512 entries is one "leaf page-table page": the unit of sharer
    tracking and replication, exactly as in the paper.
  * permissions ride in the entry's high bits so a permission flip is a
    single int32 store, like the paper's single-PTE mprotect.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch

ENTRIES_PER_TABLE = 512
PERM_SHIFT = 28          # bits 28..30 hold perms; bit 31 stays for sign
PERM_MASK = 0x7 << PERM_SHIFT
FRAME_MASK = (1 << PERM_SHIFT) - 1
PERM_R = 1
PERM_W = 2
PERM_RW = 3


class CoherenceMode(enum.Enum):
    LOCAL = "local"      # single pod, no coherence (baseline Linux analogue)
    EAGER = "eager"      # Mitosis: full replicas, broadcast on mutation
    NUMAPTE = "numapte"  # the paper: lazy partial replication + sharer masks


@dataclasses.dataclass(frozen=True)
class BlockTableSpec:
    n_pods: int
    n_tables: int                       # leaf table pages
    entries_per_table: int = ENTRIES_PER_TABLE
    mutation_budget: int = 1024         # max mutations applied per step
    miss_budget: int = 256              # max on-demand fetches per step
    prefetch_degree: int = 3            # 2^d neighbouring entries per miss

    @property
    def total_entries(self) -> int:
        return self.n_tables * self.entries_per_table


def pack_entry(frame: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    return (frame & FRAME_MASK) | (perms.to(torch.int32) << PERM_SHIFT)


def unpack_entry(entry: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absent = entry < 0
    frame = torch.where(absent, torch.full_like(entry, -1), entry & FRAME_MASK)
    perms = torch.where(absent, torch.zeros_like(entry),
                        (entry & PERM_MASK) >> PERM_SHIFT)
    return frame, perms


def lookup_blocks(local_entries: torch.Tensor, logical_blocks: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translate logical block ids -> (physical frame, present mask).

    ``local_entries`` is ONE replica [n_tables, entries_per_table] — the
    hardware page walk of the paper, always local.  ``logical_blocks`` is
    int32 of any shape; -1 entries pass through as misses.
    """
    n_tables, epb = local_entries.shape
    lb = logical_blocks.long()
    safe_tid = (lb // epb).clamp(0, n_tables - 1)
    raw = local_entries[safe_tid, lb % epb]
    ok = (lb >= 0) & (lb < n_tables * epb) & (raw >= 0)
    frame, _ = unpack_entry(raw)
    return torch.where(ok, frame, torch.full_like(frame, -1)), ok


def apply_mutations(entries: torch.Tensor, mut_tables: torch.Tensor,
                    mut_idx: torch.Tensor, mut_value: torch.Tensor,
                    apply_mask: torch.Tensor) -> torch.Tensor:
    """Apply a mutation buffer to one replica [n_tables, epb], IN PLACE.

    Masked-out slots are not written (the numaPTE sharer filter zeroes
    ``apply_mask`` for non-sharer pods, the device analogue of not receiving
    a shootdown).  The buffer is in program order: where it names one slot
    more than once the last mutation wins, on every device.  Shapes are
    static, so nothing here waits for the device.  Returns ``entries``.
    """
    n_tables, epb = entries.shape
    n = mut_tables.shape[0]
    flat = entries.view(-1)
    order = torch.arange(n, device=entries.device)
    pos = mut_tables.long() * epb + mut_idx.long()
    # winner[i]: the last applied mutation that names slot pos[i], or -1
    rank = torch.where(apply_mask, order, torch.full_like(order, -1))
    last = torch.full((n_tables * epb,), -1, dtype=order.dtype,
                      device=entries.device)
    last.scatter_reduce_(0, pos, rank, "amax")
    winner = last[pos]
    # every buffer slot stores to its position, and all stores to one
    # position carry one value (the winner's, or what is there already when
    # no applied mutation names it), so their order cannot matter
    val = torch.where(winner >= 0,
                      mut_value.to(entries.dtype)[winner.clamp_min(0)],
                      flat[pos])
    flat.index_put_((pos,), val)
    return entries


def eager_sync_bytes(spec: BlockTableSpec) -> int:
    """Collective bytes per step for EAGER coherence (per pod): the dirty
    buffer (table, idx, value) is all-gathered to every pod."""
    per_pod = spec.mutation_budget * 3 * 4
    return per_pod * spec.n_pods


def numapte_fetch_bytes(spec: BlockTableSpec) -> int:
    """Collective bytes per step for NUMAPTE: miss requests + responses,
    each response carrying 2^d prefetched entries."""
    req = spec.miss_budget * 2 * 4
    resp = spec.miss_budget * (1 << spec.prefetch_degree) * 4
    return req + resp
