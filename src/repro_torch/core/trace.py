"""Whole-trace compiled replay: windowed execution of mm-op sequences.

``apply_mm_ops`` (both the scalar reference and the batch engine)
dispatches ops one at a time from the Python interpreter: per op it
settles the initiator's pending IPI dues, recomputes the shootdown
fan-out, round-trips the working time through a dict, and walks the
batch-wide TLB-relevance set — even when hundreds of consecutive ops
come from the *same* thread over *disjoint* ranges, as every mm-heavy
benchmark loop does (fig09/fig10 unmap 25-40 ops per iteration at
``--scale 16``).  At the paper's 280-spinner regime that per-op Python
overhead is what the ROADMAP's "raw speed" item calls out: the
vectorized settlement engine idles behind the dispatcher.

This module compiles a whole op sequence up front and replays it in
*windows*:

* :func:`compile_trace` lowers the op tuples into a dense
  :class:`TraceTable` — per-op kind codes (indexing the same ``_KINDS``
  registry ``mm_batch`` validates against), thread ids, vpn ranges,
  leaf-table id spans, precomputed shootdown fan-out masks (the full
  node mask when the sharer filter is off; a dynamic sentinel when
  sharer masks must be consulted live) and per-op TLB-relevance masks
  (which CPUs' TLBs can possibly hold a translation in the op's range —
  computed once via ``searchsorted`` over every partition, instead of
  re-walking a batch-wide set per op).  Touch payloads lower through
  ``repro_torch.core.batch.group_by_leaf`` — the access engine's own
  (thread, leaf-table) grouping — so mixed access/mm traces share one
  table.
* :func:`partition_windows` splits the table into contiguous
  *conflict-free* windows: ops land in one window only when their VMA
  ranges (at leaf-table granularity), sharer masks (same initiating
  thread, so the same sharer-mask evolution) and frame-reuse
  dependencies (none — under ``elide_flushes`` the unmap kinds free
  frames into the reuse pool, so they stay singletons) are provably
  independent; :func:`ops_conflict` is the public pairwise predicate
  the partition respects.  ``mmap``/``touch``/``migrate`` are window
  barriers (they move the allocator cursor, refill TLBs, or change the
  topology).
* :class:`_TraceEngine` (the ``engine="trace"`` registry entry behind
  ``SimConfig``/``apply_mm_ops``) executes the table window by window,
  still in program order: each multi-op window replays through a fast
  path that settles the initiator's IPI dues **once** (provably
  constant across a single-initiator window), reuses one cached
  fan-out per sharer mask, batches the round accrual, and gates TLB
  invalidations on the per-op relevance masks; under
  ``concurrency="overlap"`` the whole window settles through
  ``shootdown_batch.BatchSettlement.settle_window`` in **one** engine
  call (with an exact per-round replay as the fallback when a round
  cannot be proven clean).  Ops outside a fast window fall back to the
  inherited per-op handlers, so the engine is structurally
  byte-identical to ``engine="batch"`` — the differential proof is
  ``tests/test_trace_differential.py`` and the window-independence
  property suite is ``tests/test_trace_windows.py``.

Why the hoisted due-settlement is exact: within a single-initiator
window of range ops in sequential mode, every round either increments
``node_rounds[my_node]`` and ``self_rounds[me_cpu]`` together (mask
covers the initiator's node) or neither, so the initiator's due count
— their difference — is constant across its own ops; settling it once
at window entry performs the identical float adds.  Other threads'
dues are totals of the same per-node round counts, applied at the same
settle points (their own next op, or batch end), so their charge
sequences are unchanged too.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .mm_batch import _KINDS, _MMEngine
from .pagetable import LEAF_SHIFT, PTES_PER_TABLE
from .shootdown import charge_responders

__all__ = ["TraceTable", "compile_trace", "ops_conflict",
           "partition_windows"]

#: op-kind codes of the dense table — positions in ``mm_batch._KINDS``.
KIND_CODES: Dict[str, int] = {k: i for i, k in enumerate(_KINDS)}
_MMAP = KIND_CODES["mmap"]
_TOUCH = KIND_CODES["touch"]
_MPROTECT = KIND_CODES["mprotect"]
_MUNMAP = KIND_CODES["munmap"]
_MADVISE = KIND_CODES["madvise"]
_MIGRATE = KIND_CODES["migrate"]
#: the shootdown-issuing kinds windows are built from
_RANGE_CODES = frozenset((_MPROTECT, _MUNMAP, _MADVISE))

#: fan-mask sentinel: the op's sharer mask must be consulted live
#: (``tlb_filter`` policies evolve sharer sets as tables are dropped).
DYNAMIC_FAN = -1


@dataclasses.dataclass
class TraceTable:
    """One op sequence, lowered into dense parallel arrays.

    ``start``/``length`` hold the vpn range for the range kinds, the
    page count for ``mmap`` (start -1), the access count for ``touch``
    (start = first vpn of a strictly-increasing stream, else -1) and
    the destination cpu for ``migrate`` (in ``length``).  ``table_lo``
    / ``table_hi`` are the leaf-table id span the op can write
    (``table_hi < table_lo`` for ops that touch no table — including
    zero-length range ops); ``fan_mask`` is the precomputed shootdown
    fan-out node mask (0 = op issues no shootdown, :data:`DYNAMIC_FAN`
    = consult live sharer masks); ``rel`` is the per-op tuple of CPUs
    whose TLB partition can hold a translation in the op's range
    (``None`` when compiled without a simulator).
    """

    ops: list
    kind: np.ndarray
    tid: np.ndarray
    start: np.ndarray
    length: np.ndarray
    perms: np.ndarray
    table_lo: np.ndarray
    table_hi: np.ndarray
    fan_mask: np.ndarray
    rel: Optional[List[Tuple[int, ...]]] = None

    def __len__(self) -> int:
        return len(self.ops)


def compile_trace(ops: Sequence[tuple], sim=None,
                  asid: Optional[int] = None) -> TraceTable:
    """Lower an ``apply_mm_ops`` sequence into a :class:`TraceTable`.

    Structure (kinds, tids, ranges, leaf-table spans) is
    sim-independent; passing ``sim`` additionally precomputes the
    per-op shootdown fan-out masks and TLB-relevance masks against the
    simulator's *current* state (the trace engine compiles at batch
    entry, so "current" is exactly batch-start — mm ops only ever
    remove TLB entries, which keeps the relevance masks conservative
    for the whole replay).
    """
    from .batch import group_by_leaf
    from .pagetable import PERM_RW

    ops = list(ops)
    n = len(ops)
    kind = np.empty(n, dtype=np.int8)
    tid = np.empty(n, dtype=np.int64)
    start = np.full(n, -1, dtype=np.int64)
    length = np.zeros(n, dtype=np.int64)
    perms = np.full(n, -1, dtype=np.int64)
    table_lo = np.zeros(n, dtype=np.int64)
    table_hi = np.full(n, -1, dtype=np.int64)
    for i, op in enumerate(ops):
        k = op[0]
        if k not in KIND_CODES:
            raise ValueError(f"unknown mm op: {op!r}")
        code = KIND_CODES[k]
        kind[i] = code
        tid[i] = op[1]
        if code in _RANGE_CODES:
            s, ln = int(op[2]), int(op[3])
            start[i] = s
            length[i] = ln
            if code == _MPROTECT:
                perms[i] = op[4]
            # the scalar engines' exact touched-table formula: a
            # zero-length op "spans" no table (hi < lo).
            table_lo[i] = s >> LEAF_SHIFT
            table_hi[i] = (s + ln - 1) >> LEAF_SHIFT
        elif code == _MMAP:
            length[i] = op[2]
            perms[i] = op[3] if len(op) > 3 else PERM_RW
        elif code == _TOUCH:
            arr = np.ravel(np.asarray(op[2], dtype=np.int64))
            length[i] = arr.size
            if arr.size and (arr.size == 1 or bool((np.diff(arr) > 0).all())):
                # the access engine's own (thread, leaf-table) grouping
                groups = group_by_leaf(arr)
                start[i] = arr[0]
                table_lo[i] = int(groups[0][0]) >> LEAF_SHIFT
                table_hi[i] = int(groups[-1][-1]) >> LEAF_SHIFT
        else:  # migrate
            length[i] = op[2]

    # --- shootdown fan-out masks (0 = no shootdown; DYNAMIC_FAN = the
    # sharer filter must be consulted live, per op, at replay time)
    fan_mask = np.zeros(n, dtype=np.int64)
    if sim is not None:
        is_range = np.isin(kind, list(_RANGE_CODES))
        if sim.tlb_filter:
            fan_mask[is_range] = DYNAMIC_FAN
        else:
            fan_mask[is_range] = (1 << sim.topo.n_nodes) - 1

    # --- per-op TLB-relevance masks: which CPUs' partitions (of the
    # batch's address space) can possibly hold a translation in each
    # range op's span, via one searchsorted sweep per partition.
    rel: Optional[List[Tuple[int, ...]]] = None
    if sim is not None:
        if asid is None:
            asids = {sim.threads[op[1]].asid for op in ops
                     if op[1] in sim.threads}
            asid = asids.pop() if len(asids) == 1 else 0
        idx = np.flatnonzero((table_hi >= table_lo)
                             & np.isin(kind, list(_RANGE_CODES)))
        rel_sets: List[List[int]] = [[] for _ in range(n)]
        if idx.size:
            lo_v = start[idx]
            hi_v = lo_v + length[idx]
            for cpu, tlb in sim._asid_tlbs.get(asid, {}).items():
                m = len(tlb.entries)
                if not m:
                    continue
                vpns = np.sort(np.fromiter(tlb.entries.keys(),
                                           dtype=np.int64, count=m))
                has = (np.searchsorted(vpns, hi_v, side="left")
                       > np.searchsorted(vpns, lo_v, side="left"))
                for pos in np.flatnonzero(has).tolist():
                    rel_sets[int(idx[pos])].append(cpu)
        rel = [tuple(s) for s in rel_sets]

    return TraceTable(ops=ops, kind=kind, tid=tid, start=start,
                      length=length, perms=perms, table_lo=table_lo,
                      table_hi=table_hi, fan_mask=fan_mask, rel=rel)


def ops_conflict(table: TraceTable, i: int, j: int, *,
                 elide: bool = False) -> bool:
    """May ops ``i`` and ``j`` NOT share a window?

    True when the pair is dependent under the trace model:

    * either op is a window barrier (``mmap`` moves the allocator
      cursor and VMA list, ``touch`` refills TLBs and may segfault,
      ``migrate`` changes the fan-out topology);
    * different initiating threads (their shootdown fan-outs, sharer
      masks and IPI dues interleave);
    * under ``elide_flushes``, either op is an unmap kind (``munmap``
      / ``madvise`` push freed frames into the shared reuse pool and
      record lazy stale entries — frame-reuse edges with *every*
      later op);
    * their leaf-table id spans intersect (VMA-range and sharer-mask
      edges at page-table granularity).
    """
    ki, kj = int(table.kind[i]), int(table.kind[j])
    if ki not in _RANGE_CODES or kj not in _RANGE_CODES:
        return True
    if table.tid[i] != table.tid[j]:
        return True
    if elide and (ki != _MPROTECT or kj != _MPROTECT):
        return True
    return bool(table.table_lo[i] <= table.table_hi[j]
                and table.table_lo[j] <= table.table_hi[i])


def partition_windows(table: TraceTable, *,
                      elide: bool = False) -> List[Tuple[int, int]]:
    """Split the table into contiguous half-open windows ``(lo, hi)``.

    Greedy: each window extends while the next op conflicts with none
    of the ops already in it (:func:`ops_conflict` is the invariant —
    `tests/test_trace_windows.py` checks every emitted window against
    it).  Replay order inside and across windows stays program order;
    the partition only licenses the engine's windowed fast paths.

    Disjointness inside a window is tracked with a sorted interval
    list, so partitioning a W-op window costs O(W log W), not O(W^2).
    """
    n = len(table)
    kind = table.kind
    tid = table.tid
    tlo = table.table_lo
    thi = table.table_hi
    windows: List[Tuple[int, int]] = []
    i = 0
    while i < n:
        ki = int(kind[i])
        if ki not in _RANGE_CODES or (elide and ki != _MPROTECT):
            windows.append((i, i + 1))
            i += 1
            continue
        t0 = tid[i]
        los = [int(tlo[i])]
        his = [int(thi[i])]
        j = i + 1
        while j < n:
            kj = int(kind[j])
            if kj not in _RANGE_CODES or (elide and kj != _MPROTECT) \
                    or tid[j] != t0:
                break
            lo, hi = int(tlo[j]), int(thi[j])
            if hi >= lo:    # empty spans conflict with nothing
                p = bisect.bisect_right(los, lo)
                if p and his[p - 1] >= lo:
                    break   # predecessor interval overlaps
                if p < len(los) and los[p] <= hi:
                    break   # successor interval overlaps
                los.insert(p, lo)
                his.insert(p, hi)
            j += 1
        windows.append((i, j))
        i = j
    return windows


# --------------------------------------------------------------------------
# the windowed executor (engine="trace")
# --------------------------------------------------------------------------
class _TraceEngine(_MMEngine):
    """``_MMEngine`` that replays a compiled trace window by window.

    Multi-op windows take the fast paths below; everything else (and
    every window the dynamic guards reject) dispatches through the
    inherited per-op handlers, so any divergence from ``engine="batch"``
    is a bug by construction, not a semantic fork.  ``windows`` may be
    injected (the metamorphic suite replays arbitrary valid partitions);
    by default it is :func:`partition_windows` of the compiled table.
    """

    def __init__(self, sim, ops: List[tuple], settle: Optional[str] = None,
                 windows: Optional[List[Tuple[int, int]]] = None):
        super().__init__(sim, ops, settle=settle)
        self.table = compile_trace(self.ops, sim=sim, asid=self.proc.asid)
        self.windows = (partition_windows(self.table,
                                          elide=sim.elide_flushes)
                        if windows is None else list(windows))
        #: (sharer mask, initiator cpu) -> full fan-out record
        #: (n_local, n_remote, n_filtered, base_charge, tlist, tarr, larr)
        self._fan_cache: Dict[Tuple[int, int], tuple] = {}
        #: cpus that ran a touch op mid-trace: their TLBs may now hold
        #: entries the compile-time relevance masks don't know about.
        self._touch_cpus: set = set()

    # ------------------------------------------------------- per-op hooks
    def _op_touch(self, tid: int, vpns, wm) -> None:
        try:
            super()._op_touch(tid, vpns, wm)
        finally:
            self._touch_cpus.add(self.sim.threads[tid].cpu)

    def _op_migrate(self, tid: int, new_cpu: int) -> None:
        super()._op_migrate(tid, new_cpu)
        self._fan_cache.clear()

    # ------------------------------------------------------------ run loop
    def run(self) -> list:
        out: list = [None] * len(self.ops)
        try:
            for lo, hi in self.windows:
                if hi - lo > 1 and self._window_eligible(lo, hi):
                    if self.contention is None:
                        self._window_seq(lo, hi)
                    elif self.contention.ipi_free:
                        self._window_hw(lo, hi)
                    else:
                        self._window_overlap(lo, hi)
                else:
                    for i in range(lo, hi):
                        out[i] = self._dispatch_op(self.ops[i])
        finally:
            self._finish()
        return out

    def _window_eligible(self, lo: int, hi: int) -> bool:
        """Dynamic guards the fast paths require (the partitioner already
        guarantees these for its own windows; injected partitions are
        re-checked so an invalid window degrades to per-op dispatch
        instead of corrupting state)."""
        table = self.table
        kinds = table.kind[lo:hi]
        if not bool(np.isin(kinds, list(_RANGE_CODES)).all()):
            return False
        if not bool((table.tid[lo:hi] == table.tid[lo]).all()):
            return False
        if self.sim.elide_flushes:
            # unmap kinds free frames into the reuse pool per op; and a
            # pending lazy set makes mprotect's forced-flush check live.
            if not bool((kinds == _MPROTECT).all()):
                return False
            if self.proc.lazy_pages:
                return False
        if self.contention is not None and self.vec is None \
                and not self.contention.ipi_free:
            return False    # overlap windows need the vectorized engine
            # (hardware-coherence windows never settle through it)
        return bool(table.rel is not None)

    # ------------------------------------------------------------ fan-outs
    def _fan(self, allowed: int, me_cpu: int, my_node: int) -> tuple:
        entry = self._fan_cache.get((allowed, me_cpu))
        if entry is None:
            c = self.sim.cost
            occ = self.occ_count
            n_local = (occ[my_node] - 1) if (allowed >> my_node) & 1 else 0
            n_remote = 0
            for nd, cnt in occ.items():
                if nd != my_node and (allowed >> nd) & 1:
                    n_remote += cnt
            filtered = (self.total_occ - 1) - (n_local + n_remote)
            base = (c.shootdown_cost_ns(n_local, n_remote)
                    + c.tlb_invalidate_self_ns)
            tlist = sorted(cpu
                           for nd, cpus in self.occ_sets.items()
                           if (allowed >> nd) & 1
                           for cpu in cpus if cpu != me_cpu)
            tarr = np.asarray(tlist, dtype=np.int64)
            larr = (tarr // self.hw_per_node) == my_node
            entry = (n_local, n_remote, filtered, base, tlist, tarr, larr)
            self._fan_cache[(allowed, me_cpu)] = entry
        return entry

    def _allowed(self, i: int, touched: List[int]) -> int:
        mask = int(self.table.fan_mask[i])
        if mask != DYNAMIC_FAN:
            return mask
        allowed = 0
        store_get = self.proc.store.tables.get
        for ti in touched:
            tbl = store_get(ti)
            if tbl is not None:
                allowed |= tbl.sharers
        return allowed

    def _invalidate(self, i: int, me_cpu: int, allowed: int,
                    start: int, end: int) -> None:
        """The per-op relevance-gated TLB invalidations: the compile-time
        mask plus any mid-trace touch cpus; every skipped cpu's partition
        provably holds nothing in the range (mm ops only remove entries,
        and only a touch can add them)."""
        rel = self.table.rel[i]
        tc = self._touch_cpus
        if not rel and not tc:
            return
        tlbs = self.sim._asid_tlbs[self.proc.asid]
        node_of = self.node_of
        occupied = self.occupied_all
        for cpu in (rel if not tc else set(rel) | tc):
            if cpu == me_cpu or (cpu in occupied
                                 and (allowed >> node_of(cpu)) & 1):
                tlb = tlbs.get(cpu)
                if tlb is not None:
                    tlb.invalidate_range(start, end)

    # --------------------------------------------- sequential-mode window
    def _window_seq(self, lo: int, hi: int) -> None:
        """Replay a single-initiator window of range ops under classic
        sequential settlement: dues settled once, one cached fan-out per
        sharer mask, the initiator's time carried as a local float
        through the scalar path's exact add sequence, and the round
        accrual applied in one batch at window exit."""
        sim = self.sim
        ctr, c = sim.counters, sim.cost
        ops = self.ops
        table = self.table
        tid = int(table.tid[lo])
        self._settle_ipis(tid)
        t = self._wtime(tid)
        me_cpu = sim.threads[tid].cpu
        my_node = self.node_of(me_cpu)
        syscall = c.syscall_fixed_ns
        teardown = c.pt_teardown_ns
        store = self.proc.store
        store_get = store.tables.get
        oracle = self.proc.oracle
        oracle_get = oracle.get
        pop = oracle.pop
        kinds = table.kind
        mask_rounds: Dict[int, int] = {}
        for i in range(lo, hi):
            op = ops[i]
            kind = int(kinds[i])
            start, n = op[2], op[3]
            end = start + n
            t += syscall
            if kind == _MPROTECT:
                perms = op[4]
                t, touched = self._update_range(tid, t, start, n, perms)
                if n > PTES_PER_TABLE:
                    for vpn in self._present_vpns(touched, start, end):
                        oracle[vpn] = (oracle[vpn][0], perms)
                else:
                    for vpn in range(start, end):
                        e = oracle_get(vpn)
                        if e is not None:
                            oracle[vpn] = (e[0], perms)
                vma = self._vma_at(start)
                if vma is not None and vma.start_vpn == start \
                        and vma.n_pages == n:
                    vma.perms = perms
            else:   # munmap / madvise (eager mode only: window guards)
                if n > PTES_PER_TABLE:
                    t0_ = start >> LEAF_SHIFT
                    t1_ = (end - 1) >> LEAF_SHIFT
                    present = self._present_vpns(range(t0_, t1_ + 1),
                                                 start, end)
                else:
                    present = None
                t, touched = self._update_range(tid, t, start, n, None)
                freed = 0
                if present is None:
                    for vpn in range(start, end):
                        if pop(vpn, None) is not None:
                            freed += 1
                else:
                    for vpn in present:
                        if pop(vpn, None) is not None:
                            freed += 1
                ctr.data_pages_freed += freed
            allowed = self._allowed(i, touched)
            n_local, n_remote, filtered, base = \
                self._fan(allowed, me_cpu, my_node)[:4]
            ctr.ipis_filtered += filtered
            ctr.shootdown_rounds += 1
            ctr.ipis_local += n_local
            ctr.ipis_remote += n_remote
            t += base
            if allowed:
                mask_rounds[allowed] = mask_rounds.get(allowed, 0) + 1
            self._invalidate(i, me_cpu, allowed, start, end)
            if kind == _MUNMAP:
                for ti in touched:
                    tbl = store_get(ti)
                    if tbl is not None and tbl.empty():
                        k = tbl.n_copies()
                        ctr.pt_pages_freed += k
                        t += teardown * k
                        store.drop_table(ti)
                self._carve_vmas(start, end)
        # batched accrual: per-mask round counts land exactly the per-op
        # increments' totals (integers — order-free), with the initiator's
        # own due provably unchanged (see module docstring).
        node_rounds = self.node_rounds
        self_inc = 0
        for allowed, cnt in mask_rounds.items():
            for nd in range(len(node_rounds)):
                if (allowed >> nd) & 1:
                    node_rounds[nd] += cnt
            if (allowed >> my_node) & 1:
                self_inc += cnt
        if self_inc:
            self.self_rounds[me_cpu] = \
                self.self_rounds.get(me_cpu, 0) + self_inc
        self._set_time(tid, t)

    # ----------------------------------------- hardware-coherence window
    def _window_hw(self, lo: int, hi: int) -> None:
        """Replay a single-initiator window under hardware TLB coherence
        ("HATRIC over the trace"): the structure of ``_window_seq`` with
        every round settled IPI-free through the shared
        ``_MMEngine._hw_round`` — no dispatch/ack base, no
        ``ipis_local/remote``, no lazy round accrual (nothing accrues:
        responders are charged per line, eagerly).  The compiled fan-out
        cache still supplies the ``ipis_filtered`` accounting and the
        per-op relevance masks bound which partitions can hold lines."""
        sim = self.sim
        ctr, c = sim.counters, sim.cost
        ops = self.ops
        table = self.table
        model = self.contention
        tid = int(table.tid[lo])
        self._settle_ipis(tid)     # structural parity: a no-op here
        t = self._wtime(tid)
        me_cpu = sim.threads[tid].cpu
        my_node = self.node_of(me_cpu)
        syscall = c.syscall_fixed_ns
        teardown = c.pt_teardown_ns
        store = self.proc.store
        store_get = store.tables.get
        oracle = self.proc.oracle
        oracle_get = oracle.get
        pop = oracle.pop
        kinds = table.kind
        tc = self._touch_cpus
        for i in range(lo, hi):
            op = ops[i]
            kind = int(kinds[i])
            start, n = op[2], op[3]
            end = start + n
            t += syscall
            if kind == _MPROTECT:
                perms = op[4]
                t, touched = self._update_range(tid, t, start, n, perms)
                if n > PTES_PER_TABLE:
                    for vpn in self._present_vpns(touched, start, end):
                        oracle[vpn] = (oracle[vpn][0], perms)
                else:
                    for vpn in range(start, end):
                        e = oracle_get(vpn)
                        if e is not None:
                            oracle[vpn] = (e[0], perms)
                vma = self._vma_at(start)
                if vma is not None and vma.start_vpn == start \
                        and vma.n_pages == n:
                    vma.perms = perms
            else:   # munmap / madvise (eager mode only: window guards)
                if n > PTES_PER_TABLE:
                    t0_ = start >> LEAF_SHIFT
                    t1_ = (end - 1) >> LEAF_SHIFT
                    present = self._present_vpns(range(t0_, t1_ + 1),
                                                 start, end)
                else:
                    present = None
                t, touched = self._update_range(tid, t, start, n, None)
                freed = 0
                if present is None:
                    for vpn in range(start, end):
                        if pop(vpn, None) is not None:
                            freed += 1
                else:
                    for vpn in present:
                        if pop(vpn, None) is not None:
                            freed += 1
                ctr.data_pages_freed += freed
            allowed = self._allowed(i, touched)
            ctr.ipis_filtered += self._fan(allowed, me_cpu, my_node)[2]
            ctr.shootdown_rounds += 1
            rel = table.rel[i]
            t = self._hw_round(t, me_cpu, my_node, allowed, start, end,
                               model, rel=(rel if not tc
                                           else set(rel) | tc))
            if kind == _MUNMAP:
                for ti in touched:
                    tbl = store_get(ti)
                    if tbl is not None and tbl.empty():
                        k = tbl.n_copies()
                        ctr.pt_pages_freed += k
                        t += teardown * k
                        store.drop_table(ti)
                self._carve_vmas(start, end)
        self._set_time(tid, t)

    # ------------------------------------------------ overlap-mode window
    def _window_overlap(self, lo: int, hi: int) -> None:
        """Replay a single-initiator window under overlapping-round
        settlement.  Phase A mutates all protocol state in program order
        while recording the initiator's charge program (every float add,
        plus one marker per shootdown round); phase B settles the whole
        window through ``BatchSettlement.settle_window`` in one call —
        or, when any round cannot be proven clean, replays the recorded
        program round by round (time-independent state was already
        applied, so the replay is exact)."""
        sim = self.sim
        ctr, c = sim.counters, sim.cost
        ops = self.ops
        table = self.table
        tid = int(table.tid[lo])
        self._settle_ipis(tid)     # structural parity: a no-op here
        me_cpu = sim.threads[tid].cpu
        my_node = self.node_of(me_cpu)
        syscall = c.syscall_fixed_ns
        teardown = c.pt_teardown_ns
        store = self.proc.store
        store_get = store.tables.get
        oracle = self.proc.oracle
        oracle_get = oracle.get
        pop = oracle.pop
        kinds = table.kind
        prog: List[Optional[float]] = []   # float add, or None = round
        fans: List[tuple] = []             # one fan record per round
        for i in range(lo, hi):
            op = ops[i]
            kind = int(kinds[i])
            start, n = op[2], op[3]
            end = start + n
            prog.append(syscall)
            if kind == _MPROTECT:
                perms = op[4]
                _, touched = self._update_range(tid, 0.0, start, n, perms,
                                                sink=prog)
                if n > PTES_PER_TABLE:
                    for vpn in self._present_vpns(touched, start, end):
                        oracle[vpn] = (oracle[vpn][0], perms)
                else:
                    for vpn in range(start, end):
                        e = oracle_get(vpn)
                        if e is not None:
                            oracle[vpn] = (e[0], perms)
                vma = self._vma_at(start)
                if vma is not None and vma.start_vpn == start \
                        and vma.n_pages == n:
                    vma.perms = perms
            else:   # munmap / madvise (eager mode only: window guards)
                if n > PTES_PER_TABLE:
                    t0_ = start >> LEAF_SHIFT
                    t1_ = (end - 1) >> LEAF_SHIFT
                    present = self._present_vpns(range(t0_, t1_ + 1),
                                                 start, end)
                else:
                    present = None
                _, touched = self._update_range(tid, 0.0, start, n, None,
                                                sink=prog)
                freed = 0
                if present is None:
                    for vpn in range(start, end):
                        if pop(vpn, None) is not None:
                            freed += 1
                else:
                    for vpn in present:
                        if pop(vpn, None) is not None:
                            freed += 1
                ctr.data_pages_freed += freed
            allowed = self._allowed(i, touched)
            fan = self._fan(allowed, me_cpu, my_node)
            ctr.ipis_filtered += fan[2]
            ctr.shootdown_rounds += 1
            ctr.ipis_local += fan[0]
            ctr.ipis_remote += fan[1]
            prog.append(None)
            fans.append(fan)
            self._invalidate(i, me_cpu, allowed, start, end)
            if kind == _MUNMAP:
                for ti in touched:
                    tbl = store_get(ti)
                    if tbl is not None and tbl.empty():
                        k = tbl.n_copies()
                        ctr.pt_pages_freed += k
                        prog.append(teardown * k)
                        store.drop_table(ti)
                self._carve_vmas(start, end)
        # ---- phase B: optimistic trajectory, then one-call settlement
        t0 = self._wtime(tid)
        vec = self.vec
        first = fans[0]
        same_fan = all(f is first for f in fans)
        if vec is not None and same_fan and first[4]:
            n_local, n_remote, _, base, _, tarr, larr = first
            t = t0
            t_starts = []
            for item in prog:
                if item is None:
                    t_starts.append(t)
                    t += base
                else:
                    t += item
            if vec.settle_window(np.asarray(t_starts), me_cpu, tarr,
                                 larr, n_local, n_remote, c):
                # every round settled clean: zero extra wait / queueing /
                # coalescing / responder delay, so the optimistic
                # trajectory IS the initiator's exact charge sequence.
                self._set_time(tid, t)
                return
        # exact per-round replay (state already applied; only charges and
        # settlement remain, in the recorded program order)
        t = t0
        k = 0
        for item in prog:
            if item is None:
                t = self._settle_round(t, me_cpu, fans[k])
                k += 1
            else:
                t += item
        self._set_time(tid, t)

    def _settle_round(self, t: float, me_cpu: int, fan: tuple) -> float:
        """One recorded round through the model path — the exact
        settlement block of ``_MMEngine._shootdown``."""
        sim = self.sim
        ctr, c = sim.counters, sim.cost
        n_local, n_remote, _, base, tlist, tarr, larr = fan
        model = self.contention
        if model is not None and (n_local or n_remote):
            vec = self.vec
            if vec is not None:
                out = vec.settle_and_charge(t, me_cpu, tarr, larr,
                                            n_local, n_remote, c)
                if out is None:
                    self._abandon_vector()
                    vec = None
                else:
                    extra_wait, queued, contended, n_coal, resp = out
                    ctr.ipi_queue_delay_ns += queued
                    ctr.overlapping_rounds += contended
                    ctr.ipis_coalesced += n_coal
                    ctr.responder_delay_ns += resp
                    t += base
                    if extra_wait:
                        t += extra_wait
            if vec is None:
                s = model.settle(t, me_cpu, tlist, self.node_of, c)
                ctr.ipi_queue_delay_ns += s.queued_ns
                ctr.overlapping_rounds += s.contended
                ctr.ipis_coalesced += len(s.coalesced_cpus)
                ctr.responder_delay_ns += s.responder_delay_ns
                t += base
                if s.extra_wait_ns:
                    t += s.extra_wait_ns
                charge_responders(
                    s, model.handler_ns, tlist, sim._cpu_threads,
                    lambda thr: self._wtime(thr.tid),
                    lambda thr, v: self._set_time(thr.tid, v))
        else:
            t += base
        return t
