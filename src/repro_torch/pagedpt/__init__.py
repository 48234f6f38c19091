"""Paged block tables with numaPTE coherence (PyTorch).

A paged KV-cache block table is a page table; pods are NUMA nodes;
block-table mutations require cross-pod invalidation (shootdowns).

``CoherenceMode.EAGER``   == Mitosis: every pod holds a full replica, every
mutation is broadcast to every pod.
``CoherenceMode.NUMAPTE`` == the paper: replicas fill lazily on miss from the
owner pod; sharer bitmasks bound both the fetch traffic and the invalidation
scope.
"""
from .blocktable import (BlockTableSpec, CoherenceMode, apply_mutations,
                         eager_sync_bytes, lookup_blocks, numapte_fetch_bytes,
                         pack_entry, unpack_entry)
from .host import HostBlockManager, HostCounters

__all__ = [
    "BlockTableSpec", "CoherenceMode", "HostBlockManager", "HostCounters",
    "apply_mutations", "eager_sync_bytes", "lookup_blocks",
    "numapte_fetch_bytes", "pack_entry", "unpack_entry",
]
