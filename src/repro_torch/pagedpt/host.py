"""Host-side block manager: the serving scheduler's numaPTE protocol.

The scheduler owns the canonical logical->physical block mapping and drives
the per-pod device replicas.  It is the OS of the serving runtime: sequence
allocation is mmap, sequence free is munmap, marking a shared prefix
read-only is mprotect.  Every mutation computes its exact invalidation scope
from the sharer masks (invariant I2), so the counters this class keeps are
the serving-level equivalents of the paper's shootdown counts.  The mutation
buffer it emits is applied to the device-resident table by
``repro_torch.kvcache.PagedKVManager``; the miss buffers feed the cross-pod
coherence collectives.  Pure numpy, the same protocol as the JAX package's
host manager, statement for statement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .blocktable import BlockTableSpec, CoherenceMode, PERM_R, PERM_RW


def _pack(frame: int, perms: int) -> int:
    return (frame & ((1 << 28) - 1)) | (perms << 28)


@dataclasses.dataclass
class HostCounters:
    allocs: int = 0
    frees: int = 0
    mutations: int = 0
    invalidations_sent: int = 0      # pod-invalidation messages issued
    invalidations_filtered: int = 0  # saved by the sharer filter
    fetches: int = 0                 # on-demand replica fills (misses)
    prefetched: int = 0
    translation_local: int = 0
    translation_miss: int = 0
    coherence_bytes: int = 0         # host-protocol bytes moved cross-pod


@dataclasses.dataclass
class _Sequence:
    seq_id: int
    pod: int
    logical_blocks: List[int]
    pool: int = 0                    # the KV pool its frames come from


class HostBlockManager:
    def __init__(self, spec: BlockTableSpec, mode: CoherenceMode,
                 block_tokens: int = 16):
        self.spec = spec
        self.mode = mode
        self.block_tokens = block_tokens
        epb = spec.entries_per_table
        self.canonical = np.full((spec.n_tables, epb), -1, dtype=np.int32)
        # per-pod replica presence (NUMAPTE partial fills; EAGER all-true
        # for allocated tables; LOCAL single pod)
        self.present = np.zeros((spec.n_pods, spec.n_tables, epb), dtype=bool)
        self.sharers = np.zeros(spec.n_tables, dtype=np.uint32)
        self.owner = np.full(spec.n_tables, -1, dtype=np.int32)
        #: the free frames of each KV pool (pool-local ids; one pool unless
        #: the frames are partitioned)
        self.frame_pools: List[List[int]] = [
            list(range(spec.total_entries))[::-1]]
        self.free_tables = list(range(spec.n_tables))[::-1]
        self.seqs: Dict[int, _Sequence] = {}
        self._table_seq_owner: Dict[int, int] = {}
        self._next_free_slot: Dict[int, int] = {}
        self.counters = HostCounters()
        # outbound device buffers (drained once per step)
        self._pending_mut: List[Tuple[int, int, int]] = []
        self._pending_miss: Dict[int, List[int]] = {p: [] for p in range(spec.n_pods)}

    # ------------------------------------------------------------ allocation
    def alloc_sequence(self, seq_id: int, n_blocks: int, pod: int,
                       pool: int = 0) -> List[int]:
        """mmap analogue: give a sequence `n_blocks` logical blocks backed by
        physical frames (of KV pool `pool` when the frames are partitioned).
        The allocating pod owns the covering table pages."""
        if seq_id in self.seqs:
            raise ValueError(f"sequence {seq_id} already exists")
        seq = _Sequence(seq_id, pod, [], pool)
        self.seqs[seq_id] = seq
        self.extend_sequence(seq_id, n_blocks)
        self.counters.allocs += 1
        return seq.logical_blocks

    def extend_sequence(self, seq_id: int, n_blocks: int) -> List[int]:
        seq = self.seqs[seq_id]
        epb = self.spec.entries_per_table
        new: List[int] = []
        for _ in range(n_blocks):
            tid = self._seq_table_with_room(seq)
            slot = self._next_free_slot[tid]
            self._next_free_slot[tid] += 1
            free = self.frame_pools[seq.pool]
            if not free:
                raise MemoryError("out of physical KV frames")
            frame = free.pop()
            logical = tid * epb + slot
            self.canonical[tid, slot] = _pack(frame, PERM_RW)
            # owner invariant I1: the owner pod's replica gets it immediately
            self.present[seq.pod, tid, slot] = True
            if self.mode is CoherenceMode.EAGER:
                self.present[:, tid, slot] = True
                self.counters.coherence_bytes += 4 * (self.spec.n_pods - 1)
            self._pending_mut.append((tid, slot, int(self.canonical[tid, slot])))
            seq.logical_blocks.append(logical)
            new.append(logical)
            self.counters.mutations += 1
        return new

    def _seq_table_with_room(self, seq: _Sequence) -> int:
        epb = self.spec.entries_per_table
        if seq.logical_blocks:
            tid = seq.logical_blocks[-1] // epb
            if (self._table_seq_owner.get(tid) == seq.seq_id
                    and self._next_free_slot[tid] < epb):
                return tid
        if not self.free_tables:
            raise MemoryError("out of block-table pages")
        tid = self.free_tables.pop()
        self.owner[tid] = seq.pod
        self.sharers[tid] = np.uint32(1 << seq.pod)
        if self.mode is CoherenceMode.EAGER:
            self.sharers[tid] = np.uint32((1 << self.spec.n_pods) - 1)
        self._table_seq_owner[tid] = seq.seq_id
        self._next_free_slot[tid] = 0
        return tid

    # ------------------------------------------------------------ mutation
    def free_sequence(self, seq_id: int) -> None:
        """munmap analogue; invalidation scope = sharer masks (I2)."""
        seq = self.seqs.pop(seq_id)
        epb = self.spec.entries_per_table
        touched = sorted({b // epb for b in seq.logical_blocks})
        for logical in seq.logical_blocks:
            tid, slot = divmod(logical, epb)
            frame = int(self.canonical[tid, slot]) & ((1 << 28) - 1)
            self.frame_pools[seq.pool].append(frame)
            self.canonical[tid, slot] = -1
            self.present[:, tid, slot] = False
            self._pending_mut.append((tid, slot, -1))
            self.counters.mutations += 1
        self._invalidate(touched)
        for tid in touched:
            if self._table_seq_owner.get(tid) == seq_id:
                self.free_tables.append(tid)
                self.owner[tid] = -1
                self.sharers[tid] = 0
                del self._table_seq_owner[tid]
                del self._next_free_slot[tid]
        self.counters.frees += 1

    def protect_prefix(self, seq_id: int, n_blocks: int,
                       perms: int = PERM_R) -> None:
        """mprotect analogue: mark the first n blocks of a sequence
        read-only (shared-prefix protection)."""
        seq = self.seqs[seq_id]
        epb = self.spec.entries_per_table
        touched = set()
        for logical in seq.logical_blocks[:n_blocks]:
            tid, slot = divmod(logical, epb)
            frame = int(self.canonical[tid, slot]) & ((1 << 28) - 1)
            self.canonical[tid, slot] = _pack(frame, perms)
            self._pending_mut.append((tid, slot, int(self.canonical[tid, slot])))
            self.counters.mutations += 1
            touched.add(tid)
        self._invalidate(sorted(touched))

    def _invalidate(self, touched_tables: List[int]) -> None:
        """Count invalidation messages: EAGER/LOCAL broadcast to every pod;
        NUMAPTE sends only to pods in the sharer masks."""
        n_pods = self.spec.n_pods
        all_pods = set(range(n_pods))
        scope: set = set()
        for tid in touched_tables:
            mask = int(self.sharers[tid])
            scope |= {p for p in range(n_pods) if mask >> p & 1}
        if self.mode is CoherenceMode.NUMAPTE:
            targets = scope
        else:
            targets = all_pods
        self.counters.invalidations_sent += len(targets)
        self.counters.invalidations_filtered += len(all_pods) - len(targets)
        self.counters.coherence_bytes += 12 * len(targets)

    # ------------------------------------------------------------ translation
    def record_access(self, pod: int, logical_block: int) -> None:
        """A pod translates a logical block (page-walk analogue).  Under
        NUMAPTE a miss enqueues an owner fetch with degree-d prefetch."""
        epb = self.spec.entries_per_table
        tid, slot = divmod(logical_block, epb)
        if self.present[pod, tid, slot]:
            self.counters.translation_local += 1
            return
        if self.canonical[tid, slot] < 0:
            raise KeyError(f"logical block {logical_block} not mapped")
        self.counters.translation_miss += 1
        if self.mode is CoherenceMode.NUMAPTE:
            width = 1 << self.spec.prefetch_degree
            lo = min(max(slot - width // 2, 0), epb - width)
            window = slice(lo, lo + width)
            newly = (~self.present[pod, tid, window]) & (self.canonical[tid, window] >= 0)
            self.present[pod, tid, window] |= newly
            self.counters.fetches += 1
            self.counters.prefetched += max(0, int(newly.sum()) - 1)
            self.counters.coherence_bytes += 8 + 4 * width
            self.sharers[tid] |= np.uint32(1 << pod)
            self._pending_miss[pod].append(logical_block)
        elif self.mode is CoherenceMode.EAGER:
            # eager replicas are installed at mutation time; a miss here
            # means the entry is newer than the last sync — install it
            self.present[:, tid, slot] = True
            self.counters.coherence_bytes += 8
        else:
            # LOCAL: the walk reads the owner's table remotely every time;
            # no replica is installed (the Linux baseline)
            self.counters.coherence_bytes += 8

    # ------------------------------------------------------------ device I/O
    def drain_mutation_buffer(self, budget: Optional[int] = None
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        budget = budget or self.spec.mutation_budget
        take, self._pending_mut = (self._pending_mut[:budget],
                                   self._pending_mut[budget:])
        tables = np.full(budget, 0, dtype=np.int32)
        idx = np.full(budget, 0, dtype=np.int32)
        val = np.full(budget, -1, dtype=np.int32)
        valid = np.zeros(budget, dtype=bool)
        for i, (t, s, v) in enumerate(take):
            tables[i], idx[i], val[i], valid[i] = t, s, v, True
        return tables, idx, val, valid

    def drain_miss_buffer(self, pod: int, budget: Optional[int] = None
                          ) -> np.ndarray:
        budget = budget or self.spec.miss_budget
        take = self._pending_miss[pod][:budget]
        self._pending_miss[pod] = self._pending_miss[pod][budget:]
        out = np.full(budget, -1, dtype=np.int32)
        out[:len(take)] = take
        return out

    # ------------------------------------------------------------ validation
    def check_invariants(self) -> None:
        spec = self.spec
        for tid in range(spec.n_tables):
            own = int(self.owner[tid])
            mask = int(self.sharers[tid])
            if own < 0:
                assert (self.canonical[tid] < 0).all(), f"freed table {tid} has entries"
                continue
            # I1: owner replica holds every valid entry of its tables
            valid = self.canonical[tid] >= 0
            assert self.present[own, tid][valid].all(), f"I1 violated on table {tid}"
            # I2: any pod holding entries is in the sharer mask
            for p in range(spec.n_pods):
                if self.present[p, tid].any():
                    assert mask >> p & 1, f"I2 violated: pod {p} table {tid}"
            # replicas never hold entries the canonical lacks
            for p in range(spec.n_pods):
                assert not (self.present[p, tid] & ~valid).any(), \
                    f"stale replica entries on pod {p} table {tid}"

    def footprint_table_pages(self) -> int:
        """Replicated table pages across pods (Table 4 analogue)."""
        pages = 0
        for tid in range(self.spec.n_tables):
            if self.owner[tid] < 0:
                continue
            pages += bin(int(self.sharers[tid])).count("1")
        return pages
