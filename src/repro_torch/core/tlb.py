"""Per-CPU TLB model with FIFO replacement and shootdown support.

Testbed (Section 4.1): 64-entry private L1 TLB + 1024-entry unified L2 TLB
per core.  We model one unified 1088-entry structure per hardware thread;
replacement is FIFO (insertion order), which is close enough to the
pseudo-LRU of real L2 TLBs for the event counts we care about.

ASID/PCID tagging: every entry belongs to exactly one address space, and a
hardware thread may cache translations of several processes at once (the
PCID feature real kernels use to make context switches flush-free).  We
model the tagged TLB as one ``TLB`` instance per (cpu, asid) — the ``asid``
slot is the tag shared by every entry in the instance — so lookups and
invalidations are tag-selective by construction: a shootdown for process P
only ever touches P's partition, and a context switch to another resident
process invalidates nothing.  Cross-ASID capacity contention (tenants
evicting each other's entries) is not modeled; each partition keeps its own
FIFO, which also keeps a tenant's TLB behaviour independent of who shares
its CPUs.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

DEFAULT_TLB_ENTRIES = 1088  # 64 L1 + 1024 L2


class TLB:
    __slots__ = ("capacity", "entries", "asid")

    def __init__(self, capacity: int = DEFAULT_TLB_ENTRIES, asid: int = 0):
        self.capacity = capacity
        self.asid = asid  # the PCID tag shared by every entry below
        # vpn -> (frame, perms); dict preserves insertion order => FIFO evict
        self.entries: Dict[int, Tuple[int, int]] = {}

    def lookup(self, vpn: int) -> Optional[Tuple[int, int]]:
        return self.entries.get(vpn)

    def fill(self, vpn: int, frame: int, perms: int) -> None:
        if vpn in self.entries:
            self.entries[vpn] = (frame, perms)
            return
        if len(self.entries) >= self.capacity:
            # FIFO eviction: drop the oldest insertion.
            self.entries.pop(next(iter(self.entries)))
        self.entries[vpn] = (frame, perms)

    def invalidate(self, vpn: int) -> bool:
        return self.entries.pop(vpn, None) is not None

    def entries_in_range(self, start_vpn: int, end_vpn: int) -> list:
        """The vpns currently cached in [start, end) — the non-destructive
        counterpart of ``invalidate_range`` (same scan-threshold
        heuristic), used by the lazy-invalidation bookkeeping to record
        which translations a deferred shootdown left stale."""
        n = end_vpn - start_vpn
        if n < len(self.entries) // 4:
            entries = self.entries
            return [v for v in range(start_vpn, end_vpn) if v in entries]
        return [v for v in self.entries if start_vpn <= v < end_vpn]

    def invalidate_range(self, start_vpn: int, end_vpn: int) -> int:
        n = end_vpn - start_vpn
        if n < len(self.entries) // 4:
            dropped = 0
            for vpn in range(start_vpn, end_vpn):
                dropped += self.entries.pop(vpn, None) is not None
            return dropped
        keep = {v: e for v, e in self.entries.items()
                if not start_vpn <= v < end_vpn}
        dropped = len(self.entries) - len(keep)
        self.entries = keep
        return dropped

    def flush(self) -> int:
        n = len(self.entries)
        self.entries.clear()
        return n

    def __len__(self) -> int:
        return len(self.entries)

    def vpns(self) -> Iterable[int]:
        return self.entries.keys()
