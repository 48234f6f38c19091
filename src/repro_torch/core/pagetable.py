"""Radix page-table store with per-node replicas and sharer tracking.

This is the paper's central data structure.  The virtual address space is an
array of 4KB pages (VPNs).  A 4-level radix tree with out-degree 512 maps
VPNs to physical frames; the unit of replication and of sharer tracking is a
single *leaf* page-table page (512 PTEs covering a 2MB aligned region), as in
the paper (Section 3.2: "a circular list of sharers is efficiently maintained
at the level of individual page-tables").  We represent the circular sharer
list by an equivalent node bitmask — the list in the paper exists only to
*find* all sharers from any one sharer, which a bitmask gives us directly.

Upper-level directory pages are tracked per node for footprint accounting;
walks are modeled with a page-walk cache that covers the upper levels, so the
leaf access dominates (Section 2.1).
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

PTES_PER_TABLE = 512
LEAF_SHIFT = 9          # vpn >> 9 == leaf table id
PAGE_BYTES = 4096
PT_PAGE_BYTES = 4096
#: radix levels above the leaf (L2/L3/L4 directories), used for footprint.
UPPER_SHIFTS = (18, 27, 36)

PERM_R = 1
PERM_W = 2
PERM_X = 4
PERM_RW = PERM_R | PERM_W


class Policy(enum.Enum):
    LINUX = "linux"        # no replication; first-touch canonical placement
    MITOSIS = "mitosis"    # eager full replication on every node
    NUMAPTE = "numapte"    # lazy, partial, owner-based replication (ours)


def leaf_id(vpn: int) -> int:
    return vpn >> LEAF_SHIFT


def leaf_index(vpn: int) -> int:
    return vpn & (PTES_PER_TABLE - 1)


def leaf_base_vpn(tid: int) -> int:
    return tid << LEAF_SHIFT


def next_table_aligned(vpn: int) -> int:
    """Round ``vpn`` up to the next leaf-table boundary.  This is the mmap
    placement rule (distinct VMAs live in distinct leaf tables); the batch
    engine's and the op-program generators' shadow allocators must use the
    same function so precomputed addresses never drift from the simulator."""
    return -(-vpn // PTES_PER_TABLE) * PTES_PER_TABLE


@dataclasses.dataclass
class PTE:
    """One present page-table entry."""
    frame: int            # physical frame id
    frame_node: int       # NUMA node the data page lives on
    perms: int            # PERM_* bits


class LeafTable:
    """One leaf page-table page plus its per-node replicas.

    `copies[node]` maps entry-index -> PTE for every node holding a replica
    (for LINUX there is exactly one copy; for MITOSIS one per node).  A
    replica may hold a *subset* of the canonical entries under NUMAPTE.
    """

    __slots__ = ("tid", "owner", "sharers", "copies")

    def __init__(self, tid: int, owner: int):
        self.tid = tid
        self.owner = owner                    # canonical/owner node
        self.sharers: int = 1 << owner        # bitmask incl. owner
        self.copies: Dict[int, Dict[int, PTE]] = {owner: {}}

    # -- sharer bookkeeping --------------------------------------------------
    def sharer_nodes(self) -> List[int]:
        out, mask, n = [], self.sharers, 0
        while mask:
            if mask & 1:
                out.append(n)
            mask >>= 1
            n += 1
        return out

    def is_sharer(self, node: int) -> bool:
        return bool(self.sharers >> node & 1)

    def add_sharer(self, node: int) -> None:
        self.sharers |= 1 << node
        if node not in self.copies:
            self.copies[node] = {}

    def drop_sharer(self, node: int) -> None:
        if node == self.owner:
            raise ValueError("cannot drop the owner from the sharer list")
        self.sharers &= ~(1 << node)
        self.copies.pop(node, None)

    # -- entry accessors -----------------------------------------------------
    def lookup(self, node: int, idx: int) -> Optional[PTE]:
        copy = self.copies.get(node)
        if copy is None:
            return None
        return copy.get(idx)

    def present_indices(self, node: int) -> Iterable[int]:
        copy = self.copies.get(node)
        return () if copy is None else tuple(copy.keys())

    def n_copies(self) -> int:
        return len(self.copies)

    def empty(self) -> bool:
        return all(not c for c in self.copies.values())


@dataclasses.dataclass
class VMA:
    """A virtual memory area: [start_vpn, end_vpn), with an owner node.

    Under NUMAPTE the owner is the node whose thread performed the mmap
    (Section 3.2: "the owner of each allocation area is the NUMA socket that
    requested its allocation").
    """
    vma_id: int
    start_vpn: int
    end_vpn: int
    owner: int
    perms: int = PERM_RW

    def __contains__(self, vpn: int) -> bool:
        return self.start_vpn <= vpn < self.end_vpn

    @property
    def n_pages(self) -> int:
        return self.end_vpn - self.start_vpn


def find_vma_sorted(vmas: Sequence["VMA"], starts: Sequence[int],
                    vpn: int) -> Optional["VMA"]:
    """``find_vma`` over a start-sorted VMA list with its parallel starts
    index.  Equivalent to the linear scan for disjoint VMAs — the one
    lookup both batch engines must agree on."""
    i = bisect.bisect_right(starts, vpn) - 1
    if i >= 0:
        vma = vmas[i]
        if vpn < vma.end_vpn:
            return vma
    return None


class PageTableStore:
    """All leaf tables + upper-level directory pages of one address space."""

    def __init__(self, n_nodes: int):
        self.n_nodes = n_nodes
        self.tables: Dict[int, LeafTable] = {}
        # per-node set of installed upper-level directory page ids
        self.upper: List[Set[Tuple[int, int]]] = [set() for _ in range(n_nodes)]
        self.root_nodes: Set[int] = set()

    # -- table lifecycle ------------------------------------------------------
    def get(self, tid: int) -> Optional[LeafTable]:
        return self.tables.get(tid)

    def create(self, tid: int, owner: int) -> LeafTable:
        assert tid not in self.tables
        t = LeafTable(tid, owner)
        self.tables[tid] = t
        self._install_uppers(tid, owner)
        return t

    def install_replica(self, table: LeafTable, node: int) -> None:
        table.add_sharer(node)
        self._install_uppers(table.tid, node)

    def _install_uppers(self, tid: int, node: int) -> None:
        vpn = leaf_base_vpn(tid)
        for shift in UPPER_SHIFTS:
            self.upper[node].add((shift, vpn >> shift))
        self.root_nodes.add(node)

    def drop_table(self, tid: int) -> None:
        self.tables.pop(tid, None)
        # upper-level pages are dropped only when *no* table underneath them
        # remains; that pruning is O(tables) so we only do it on demand in
        # footprint accounting (garbage upper pages are a few KB).

    # -- footprint (Table 4) ---------------------------------------------------
    def footprint_bytes(self) -> int:
        """Total page-table bytes across all nodes (replicas included)."""
        leaf = sum(t.n_copies() for t in self.tables.values()) * PT_PAGE_BYTES
        live_upper = self._live_upper_count() * PT_PAGE_BYTES
        root = len(self.root_nodes) * PT_PAGE_BYTES
        return leaf + live_upper + root

    def footprint_bytes_single_copy(self) -> int:
        """Footprint if every table had exactly one copy (Linux baseline)."""
        n_upper = len(set().union(*self.upper)) if any(self.upper) else 0
        return (len(self.tables) + n_upper + (1 if self.root_nodes else 0)) * PT_PAGE_BYTES

    def _live_upper_count(self) -> int:
        live: Set[Tuple[int, int, int]] = set()
        for node in range(self.n_nodes):
            covered = {(shift, leaf_base_vpn(t.tid) >> shift)
                       for t in self.tables.values() if node in t.copies
                       for shift in UPPER_SHIFTS}
            for key in self.upper[node]:
                if key in covered:
                    live.add((node,) + key)
        return len(live)
