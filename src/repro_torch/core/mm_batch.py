"""Batched memory-management engine: mmap/mprotect/munmap over op arrays.

The batch engine vectorizes the *access* path (``repro_torch.core.batch``);
this module does the same for the *memory-management* path — the operations
the paper's headline results are about (munmap/mprotect suffer up to 40x NUMA overhead;
numaPTE's sharer-mask-targeted shootdowns are what deliver the webserver /
memcached wins).  The scalar path (``NumaSim.mprotect`` / ``munmap``) pays,
per op, a full rebuild of the running-CPU set, a Python loop over every
running CPU for the shootdown filter, and a per-target-thread IPI charge —
with the paper's 8x36-thread testbed and 280 spinners that is hundreds of
dict/float operations per 4KB munmap, which forces the mm-heavy benchmarks
(figs 01/09/10/11) to shrink iteration counts far below paper scale.

The engine replays *identical* protocol semantics over a whole op batch:

* **Cached shootdown fan-out** — the running-CPU occupancy histogram
  (node -> #occupied CPUs) is built once per batch (mm ops never move
  threads; a ``migrate`` op rebuilds it).  Per op, the sharer-filtered
  target counts, the initiator's dispatch/ack charge and the
  ``ipis_local/remote/filtered`` counters come from O(nodes) arithmetic
  instead of an O(CPUs) scan.
* **Amortized IPI receive charges** — target threads are not charged 700ns
  per op; instead shootdown rounds accrue into cumulative per-node round
  counts (minus per-initiator-CPU self counts) and each thread's due count
  is settled lazily in O(1): when that thread initiates its next op, and
  once at batch end.  The settled charge is ``due * IPI_RECEIVE_NS`` when
  that is provably bit-equal to ``due`` sequential float adds
  (integer-valued running time and charge, below 2^52 — the same exactness
  guard ``repro_torch.core.batch`` uses), else an exact sequential-add fallback
  loop.
* **TLB-invalidation relevance filter** — a shootdown must invalidate the
  op's range on every target CPU, but almost every TLB (e.g. all spinner
  TLBs) holds nothing in any batched range.  The engine computes, once,
  which TLBs intersect the union of the batch's mm-op ranges (NumPy
  searchsorted over the merged intervals) and only those — plus any CPU
  that performs a ``touch`` op mid-batch, which can refill entries — pay
  per-op ``invalidate_range`` calls.  Skipped TLBs are provably untouched:
  mm ops only ever *remove* entries, so a TLB disjoint from every batched
  range at batch start stays disjoint.
* **Bulk PTE range updates** — per touched leaf table and replica, the
  present-entry update/clear runs over the replica's own keys (or a plain
  ``dict.clear`` for whole-table munmaps) instead of probing every vpn of
  the range, and the per-replica write charge is the same single
  ``cost * wrote`` multiply the scalar path performs.

Counters are integers (order-free); every float the *initiating* thread
accumulates is added in exactly the scalar path's operation order, so
modeled times are byte-identical — differentially tested (together with
TLB content/order, replicas, sharer masks, the oracle and the VMA layout)
in ``tests/test_mm_batch_differential.py``.  A mid-batch ``SegfaultError``
from a ``touch`` op leaves exactly the partial state the scalar loop would
have left (pending IPI dues are settled before the exception propagates).

Assumptions (shared with ``repro_torch.core.batch`` and the scalar operating
regime of every workload in this repo): VMAs are disjoint, and ops in one
batch are applied in sequence — protocol state (page tables, TLBs, VMAs,
the oracle) always evolves in program order, under either concurrency
mode.

``concurrency="overlap"`` (two-sided) additionally
settles concurrently issued shootdowns as *overlapping IPI rounds*: each
round is handed to a ``repro_torch.core.shootdown.ContentionModel`` which
tracks per-CPU interrupt-handler busy horizons and in-flight initiator
windows, stretches the initiator's ack wait by its slowest target's
receive-queue delay, and returns per-target responder results (counters
``ipi_queue_delay_ns`` / ``overlapping_rounds`` / ``responder_delay_ns``
/ ``ipis_coalesced``).  In overlap mode the engine settles responders
*eagerly* per round — the model's ``handler_ns`` (not the module-level
constant), then the per-CPU stretch, as two separate adds in the scalar
path's exact order; coalesced IPIs skip the handler charge — because the
lazy grouped accrual cannot express per-round per-CPU stretches.  The
zero-delay model (``NullContention``) settles every round to exactly
zero extra cost and charges ``handler_ns == IPI_RECEIVE_NS``, so overlap
mode under it is byte-identical to ``concurrency="sequential"`` — the
differential anchor of ``tests/test_shootdown_contention.py``.  The same
model instance drives the scalar and batched engines through the
identical per-round float sequence, so the scalar/batch differential
holds under contention too.

Contended rounds settle through the **vectorized settlement
engine** (``repro_torch.core.shootdown_batch``) by default: the whole target
mask — busy horizons, ack windows, queue delays, responder stretches,
coalescing merges, and the two-sided thread charges — is computed as
array operations per round, with the integer-exactness guard +
sequential-fallback pattern keeping it bit-for-bit identical to the
scalar model loops (``settle="sequential"`` forces those; the
differential suite is ``tests/test_shootdown_batch_differential.py``).
This is what makes the paper's absolute 280-spinner Fig 1 regime (every
Linux round fanning out to ~287 CPUs) practical in CI, and the default
overlap model is now ``CoalescingContention`` (Linux's real flush
batching) with ``QueueContention`` kept selectable.
"""
from __future__ import annotations

import bisect
import dataclasses
import operator
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pagetable import (LEAF_SHIFT, PERM_RW, PTE, PTES_PER_TABLE, VMA,
                        find_vma_sorted, next_table_aligned)
from .shootdown import (CoalescingContention, ContentionModel,
                        RoundSettlement, charge_responders)
from .shootdown_batch import BatchSettlement, resolve_settle

from .config import _UNSET, _warn_deprecated

__all__ = ["CONCURRENCY_MODES", "apply_mm_ops", "mmap_batch",
           "mprotect_batch", "munmap_batch"]

#: shootdown-settlement modes of apply_mm_ops (single source of truth —
#: the benchmark CLI derives its --concurrency choices from this).
CONCURRENCY_MODES = ("sequential", "overlap")

_IDX_MASK = PTES_PER_TABLE - 1
#: beyond this magnitude float addition of integers can round; fall back.
_MAX_EXACT = float(1 << 52)

_KINDS = ("mmap", "touch", "mprotect", "munmap", "madvise", "migrate")
_BY_START = operator.attrgetter("start_vpn")


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
def apply_mm_ops(sim, ops: Sequence[tuple], *, engine=_UNSET,
                 concurrency=_UNSET,
                 contention=_UNSET,
                 settle=_UNSET) -> list:
    """Apply a sequence of memory-management ops, in order.

    Each op is a tuple whose first element names the kind:

    * ``("mmap", tid, n_pages[, perms])`` -> the created :class:`VMA`
    * ``("touch", tid, vpns[, write_mask])`` -> None (runs the batched
      access engine; ``write_mask`` may be a bool or per-access array)
    * ``("mprotect", tid, start_vpn, n_pages, perms)`` -> None
    * ``("munmap", tid, start_vpn, n_pages)`` -> None
    * ``("madvise", tid, start_vpn, n_pages)`` -> None (MADV_DONTNEED:
      zap + free the pages but keep the VMA and leaf tables, see
      ``NumaSim.madvise_dontneed``)
    * ``("migrate", tid, new_cpu)`` -> None

    Returns the per-op results.  ``engine="scalar"`` dispatches every op to
    the scalar ``NumaSim`` methods (the differential reference);
    ``engine="batch"`` runs the vectorized engine, which is byte-identical
    in counters, modeled times, TLB state/order, page-table replicas,
    sharer masks, the oracle, and the VMA layout.

    ``concurrency`` selects the shootdown settlement for the batch:

    * ``"sequential"`` (default) — every IPI round runs alone, exactly the
      pre-existing semantics; any sim-level contention model is suspended
      for the batch's duration so this mode is always the clean reference
      (passing ``contention`` with this mode is an error, not a no-op).
    * ``"overlap"`` — concurrently issued mm ops from different threads
      form overlapping IPI rounds, settled by ``contention`` (or the sim's
      model, or a fresh ``CoalescingContention`` — Linux's real
      flush-batching behavior, the default since the absolute Fig 1
      calibration) — see ``repro_torch.core.shootdown``.  Pass an explicit
      model to carry busy horizons across batches.

    ``settle`` picks the settlement engine for contended rounds (overlap
    mode only; see ``repro_torch.core.shootdown_batch``):

    * ``"auto"`` (default) — the vectorized engine when the model is a
      stock ``QueueContention``/``CoalescingContention``, else the
      scalar model loops.  Bit-identical either way.
    * ``"vector"`` — require the vectorized engine (error if the model
      doesn't support it).
    * ``"sequential"`` — force the scalar model loops (the differential
      reference).

    The engine actually used is reported in ``sim.last_settle_engine``
    (``"mixed"`` if the vectorized engine abandoned mid-batch).
    """
    # knob defaults come from the sim's SimConfig; the explicit kwargs are
    # the deprecated per-call spellings (they still win when passed)
    cfg = sim.config
    if engine is _UNSET:
        engine = cfg.engine
    else:
        _warn_deprecated("apply_mm_ops(engine=...)", "SimConfig(engine=...)")
    if concurrency is _UNSET:
        concurrency = cfg.concurrency
    else:
        _warn_deprecated("apply_mm_ops(concurrency=...)",
                         "SimConfig(concurrency=...)")
    if contention is _UNSET:
        contention = None
    else:
        _warn_deprecated("apply_mm_ops(contention=...)",
                         "SimConfig(contention=...)")
        if contention is not None and concurrency != "overlap":
            raise ValueError("contention model given but concurrency="
                             f"{concurrency!r}; it would be silently "
                             "ignored — pass concurrency=\"overlap\"")
    if settle is _UNSET:
        settle = cfg.settle if concurrency == "overlap" else "auto"
    else:
        _warn_deprecated("apply_mm_ops(settle=...)", "SimConfig(settle=...)")
        if settle != "auto" and concurrency != "overlap":
            raise ValueError(f"settle={settle!r} given but concurrency="
                             f"{concurrency!r}; the settlement engine only "
                             "applies to overlap mode")
    return _apply_resolved(sim, ops, engine, concurrency, contention, settle)


def _apply_resolved(sim, ops, engine: str, concurrency: str,
                    contention: Optional[ContentionModel],
                    settle: str) -> list:
    """apply_mm_ops past knob resolution — the internal entry point the
    workload phases use so routing an already-resolved engine through
    never trips the deprecation shim."""
    ops = list(ops)
    for op in ops:
        if not op or op[0] not in _KINDS:
            raise ValueError(f"unknown mm op: {op!r}")
    # One batch = syscalls of one address space (its threads, its VMAs, its
    # mm_cpumask fan-out).  Different tenants issue separate batches; their
    # rounds still contend through a shared contention model's horizons,
    # and responder charges always land on every thread resident on a
    # target CPU, whichever process it belongs to.
    asids = {sim.threads[op[1]].asid for op in ops if op[1] in sim.threads}
    if len(asids) > 1:
        raise ValueError(
            f"apply_mm_ops: ops span multiple processes (asids {sorted(asids)}); "
            "issue one batch per address space")
    if engine not in ("scalar", "batch", "trace"):
        raise ValueError(f"unknown engine {engine!r}")
    if concurrency not in CONCURRENCY_MODES:
        raise ValueError(f"unknown concurrency {concurrency!r}")
    if concurrency == "overlap":
        model: Optional[ContentionModel] = (
            contention if contention is not None
            else sim.contention if sim.contention is not None
            else CoalescingContention())
        resolved: Optional[str] = resolve_settle(settle, model)
    else:
        model, resolved = None, None
    prev, prev_se = sim.contention, sim.settle_engine
    sim.contention = model
    if resolved is not None:
        sim.settle_engine = resolved
    sim.last_mm_engine = engine
    try:
        if engine == "scalar":
            sim.last_settle_engine = resolved
            return _apply_scalar(sim, ops)
        if engine == "trace":
            from .trace import _TraceEngine
            mm: _MMEngine = _TraceEngine(sim, ops, settle=resolved)
        else:
            mm = _MMEngine(sim, ops, settle=resolved)
        try:
            return mm.run()
        finally:
            sim.last_settle_engine = mm.settle_used
    finally:
        sim.contention = prev
        sim.settle_engine = prev_se


def mmap_batch(sim, tid: int, sizes, *, perms: int = PERM_RW,
               engine=_UNSET) -> List[VMA]:
    """Batched ``sim.mmap(tid, n)`` for every n in ``sizes`` (in order)."""
    return apply_mm_ops(
        sim, [("mmap", tid, int(n), perms) for n in np.ravel(sizes)],
        engine=engine)


def mprotect_batch(sim, tid: int, starts, n_pages, perms, *,
                   engine=_UNSET) -> None:
    """Batched ``sim.mprotect`` over parallel (start, n_pages, perms)
    arrays; scalar ``n_pages``/``perms`` broadcast over all ops."""
    starts = [int(s) for s in np.ravel(starts)]
    lens = _broadcast(n_pages, len(starts))
    prm = _broadcast(perms, len(starts))
    apply_mm_ops(sim, [("mprotect", tid, s, n, p)
                       for s, n, p in zip(starts, lens, prm)], engine=engine)


def munmap_batch(sim, tid: int, starts, n_pages, *,
                 engine=_UNSET) -> None:
    """Batched ``sim.munmap`` over parallel (start, n_pages) arrays."""
    starts = [int(s) for s in np.ravel(starts)]
    lens = _broadcast(n_pages, len(starts))
    apply_mm_ops(sim, [("munmap", tid, s, n)
                       for s, n in zip(starts, lens)], engine=engine)


def _broadcast(x, k: int) -> List[int]:
    arr = np.ravel(x)
    if arr.size == 1:
        return [int(arr[0])] * k
    if arr.size != k:
        raise ValueError(f"length mismatch: {arr.size} != {k}")
    return [int(v) for v in arr]


# --------------------------------------------------------------------------
# scalar reference dispatch
# --------------------------------------------------------------------------
def _apply_scalar(sim, ops: List[tuple]) -> list:
    out: list = []
    for op in ops:
        kind = op[0]
        if kind == "mmap":
            out.append(sim.mmap(op[1], op[2],
                                perms=op[3] if len(op) > 3 else PERM_RW))
        elif kind == "touch":
            tid, vpns = op[1], op[2]
            wm = op[3] if len(op) > 3 else None
            arr = np.ravel(vpns)
            if wm is None:
                for v in arr.tolist():
                    sim.touch(tid, int(v), False)
            else:
                # scalar/0-d masks broadcast; mismatched lengths raise
                # instead of silently truncating the access stream
                masks = np.broadcast_to(np.asarray(wm).ravel()
                                        if np.ndim(wm) else np.asarray(wm),
                                        arr.shape)
                for v, w in zip(arr.tolist(), masks.tolist()):
                    sim.touch(tid, int(v), bool(w))
            out.append(None)
        elif kind == "mprotect":
            sim.mprotect(op[1], op[2], op[3], op[4])
            out.append(None)
        elif kind == "munmap":
            sim.munmap(op[1], op[2], op[3])
            out.append(None)
        elif kind == "madvise":
            sim.madvise_dontneed(op[1], op[2], op[3])
            out.append(None)
        else:  # migrate
            sim.migrate_thread(op[1], op[2])
            out.append(None)
    return out


# --------------------------------------------------------------------------
# batched engine
# --------------------------------------------------------------------------
class _MMEngine:
    """One batch of mm ops over one simulator.

    Working thread times live in ``self.wt`` (written back in ``_finish``);
    all additions into a working time happen in the scalar path's exact
    order, so write-back equals the scalar sequence bit-for-bit.
    """

    def __init__(self, sim, ops: List[tuple], settle: Optional[str] = None):
        self.sim = sim
        self.ops = ops
        # the batch's address space (apply_mm_ops validated uniqueness):
        # VMAs, page tables, oracle, TLB partitions and the mm_cpumask
        # fan-out all come from it; thread-time/IPI charging stays
        # machine-global (co-resident tenants eat this process's IPIs).
        asids = {sim.threads[op[1]].asid for op in ops
                 if op[1] in sim.threads}
        self.proc = sim.processes[asids.pop()] if asids else sim.processes[0]
        self.node_of = sim.topo.node_of_cpu
        self.hw_per_node = sim.topo.hw_threads_per_node
        self.full_mask = (1 << sim.topo.n_nodes) - 1
        # flat handler cost of the *sequential* lazy accrual only: overlap
        # mode charges responders eagerly from the model's handler_ns in
        # _shootdown (a custom-handler model never touches this constant)
        from .sim import IPI_RECEIVE_NS
        self.ipi_ns = float(IPI_RECEIVE_NS)
        self.ipi_int = self.ipi_ns.is_integer()
        # overlapping-round settlement (set by apply_mm_ops for the batch's
        # duration); None = classic sequential semantics.
        self.contention = sim.contention
        #: settlement engine for contended rounds ("vector"/"sequential";
        #: None outside overlap mode).  settle_used reports what actually
        #: ran — it degrades to "mixed" if the vectorized engine abandons
        #: mid-batch, so benchmark rows can record their provenance.
        self.settle_used = settle
        self.vec: Optional[BatchSettlement] = (
            BatchSettlement(sim, self.contention)
            if settle == "vector" else None)
        #: cached sorted shootdown fan-out per (sharer mask, initiator
        #: cpu) — occupancy only changes on migrate, which clears it.
        self._tcache: Dict[Tuple[int, int], tuple] = {}
        self.wt: Dict[int, float] = {}
        # IPI-receive accrual, O(nodes) per round / O(1) per settlement: a
        # thread on cpu C (node N) is targeted by every round whose mask
        # covers N except rounds it initiated itself, so its cumulative due
        # is node_rounds[N] - self_rounds[C].  Reset (after settling)
        # whenever a migrate changes the topology.
        self.node_rounds = [0] * sim.topo.n_nodes
        self.self_rounds: Dict[int, int] = {}   # initiator cpu -> rounds
        self.applied: Dict[int, int] = {}       # tid -> rounds settled
        # The engine keeps the process's vmas sorted by start_vpn for the
        # whole batch.  VMAs are disjoint, so this is an equivalent
        # permutation of the scalar path's insertion-ordered list (find_vma
        # returns the unique containing VMA either way) — and it makes both
        # VMA resolution and munmap carving O(log V) bisects + list splices
        # instead of O(V) rebuilds per op.
        self.proc.vmas.sort(key=_BY_START)
        self._vma_starts: List[int] = [v.start_vpn for v in self.proc.vmas]
        self._rebuild_topology_cache()
        self._relevant = self._initial_relevant(ops)

    # ------------------------------------------------------------- caches
    def _rebuild_topology_cache(self) -> None:
        # occupancy of the *initiating process's* threads: its mm_cpumask,
        # the unfiltered shootdown fan-out (per-process since the Process
        # refactor; with one process this is every thread, as before).
        occ: Dict[int, set] = {}
        for t in self.proc.threads.values():
            occ.setdefault(self.node_of(t.cpu), set()).add(t.cpu)
        self.occ_sets = occ                 # node -> occupied cpus
        self.occ_count = {n: len(s) for n, s in occ.items()}
        self.total_occ = sum(self.occ_count.values())
        self.occupied_all = set().union(*occ.values()) if occ else set()

    def _initial_relevant(self, ops: List[tuple]) -> set:
        """CPUs whose TLB intersects the union of the batch's mm-op ranges.
        Every other TLB is provably untouched by the batch's shootdowns
        (mm ops only remove entries), so its invalidations are skipped."""
        spans = []
        for op in ops:
            if op[0] in ("mprotect", "munmap", "madvise") and op[3] > 0:
                spans.append((op[2], op[2] + op[3]))
        if not spans:
            return set()
        spans.sort()
        merged = [list(spans[0])]
        for s, e in spans[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts = np.asarray([m[0] for m in merged], dtype=np.int64)
        ends = np.asarray([m[1] for m in merged], dtype=np.int64)
        rel = set()
        # only this process's ASID partitions can hold its translations
        for cpu, tlb in self.sim._asid_tlbs.get(self.proc.asid, {}).items():
            n = len(tlb.entries)
            if not n:
                continue
            vpns = np.fromiter(tlb.entries.keys(), dtype=np.int64, count=n)
            idx = np.searchsorted(starts, vpns, side="right") - 1
            ok = idx >= 0
            if ok.any() and bool((vpns[ok] < ends[idx[ok]]).any()):
                rel.add(cpu)
        return rel

    def _vma_at(self, vpn: int) -> Optional[VMA]:
        """find_vma over the live sorted interval index."""
        return find_vma_sorted(self.proc.vmas, self._vma_starts, vpn)

    def _carve_vmas(self, start: int, end: int) -> None:
        """`NumaSim._carve_vmas`, as a splice on the sorted VMA list:
        identical resulting VMA set (same objects / same replace() pieces),
        without rebuilding the whole list per op."""
        vmas = self.proc.vmas
        starts = self._vma_starts
        i = bisect.bisect_right(starts, start) - 1
        if i < 0 or vmas[i].end_vpn <= start:
            i += 1
        j = bisect.bisect_left(starts, end, lo=i)
        if i >= j:
            return
        repl: List[VMA] = []
        first, last = vmas[i], vmas[j - 1]
        if first.start_vpn < start:
            repl.append(dataclasses.replace(first, end_vpn=start))
        if last.end_vpn > end:
            repl.append(dataclasses.replace(last, start_vpn=end))
        vmas[i:j] = repl
        starts[i:j] = [v.start_vpn for v in repl]

    # ------------------------------------------------------ time accounting
    def _wtime(self, tid: int) -> float:
        vec = self.vec
        if vec is not None:
            return float(vec.times[tid])
        w = self.wt.get(tid)
        if w is None:
            w = self.sim.threads[tid].time_ns
            self.wt[tid] = w
        return w

    def _set_time(self, tid: int, v: float) -> None:
        vec = self.vec
        if vec is not None:
            vec.times[tid] = v
        else:
            self.wt[tid] = v

    def _settle_ipis(self, tid: int) -> None:
        """Apply this thread's due IPI-receive charges (scalar order: all
        700s a target accumulates land before its own next op's charges)."""
        thr = self.sim.threads[tid]
        cpu = thr.cpu
        # rounds only ever target the initiating process's mm_cpumask; a
        # thread (of any process) on a cpu outside it is never charged.
        # With one process this guard never fires (every thread's cpu is
        # occupied by construction).
        if cpu not in self.occupied_all:
            return
        due = (self.node_rounds[self.node_of(cpu)]
               - self.self_rounds.get(cpu, 0)
               - self.applied.get(tid, 0))
        if not due:
            return
        self.applied[tid] = self.applied.get(tid, 0) + due
        thr.ipis_received += due
        t = self._wtime(tid)
        ipi = self.ipi_ns
        total = due * ipi
        if self.ipi_int and t.is_integer() and t + total < _MAX_EXACT:
            self._set_time(tid, t + total)
        else:
            for _ in range(due):   # exact sequential fallback
                t += ipi
            self._set_time(tid, t)

    def _settle_all_ipis(self) -> None:
        for tid in self.sim.threads:
            self._settle_ipis(tid)

    def _abandon_vector(self) -> None:
        """Mid-batch fallback to the scalar model loops: flush the array
        state (thread times into the working dict, IPI deltas onto the
        threads, busy/inflight horizons into the model dicts) and mark
        the batch as mixed-engine so rows can't masquerade as
        single-engine artifacts."""
        vec = self.vec
        wt = self.wt
        for tid, thr in self.sim.threads.items():
            wt[tid] = float(vec.times[tid])
            d = int(vec.ipis[tid])
            if d:
                thr.ipis_received += d
        vec.flush()
        self.vec = None
        self.settle_used = "mixed"

    def _sync_threads_out(self) -> None:
        """Hand the live thread times back to the scalar core for an op
        that may charge *arbitrary* threads directly (a forced deferred
        flush lands handler/stretch charges on every stale CPU's
        residents).  Settles all pending IPI dues first — the scalar
        chronological order — then writes every working time (and any
        vector IPI delta) onto the Thread objects.  ``_sync_threads_in``
        resumes the engine from that state."""
        self._settle_all_ipis()
        vec = self.vec
        threads = self.sim.threads
        if vec is not None:
            for tid, thr in threads.items():
                thr.time_ns = float(vec.times[tid])
                d = int(vec.ipis[tid])
                if d:
                    thr.ipis_received += d
            vec.flush()
            self._had_vec = True
            self.vec = None
        else:
            self._had_vec = False
            for tid, w in self.wt.items():
                threads[tid].time_ns = w
        self.wt.clear()

    def _sync_threads_in(self) -> None:
        """Resume engine bookkeeping after ``_sync_threads_out``: working
        times re-seed lazily from the (now current) Thread objects; a
        vectorized settlement re-snapshots them and the model horizons."""
        if self._had_vec:
            self.vec = BatchSettlement(self.sim, self.contention)

    def _finish(self) -> None:
        self._settle_all_ipis()
        threads = self.sim.threads
        vec = self.vec
        if vec is not None:
            for tid, thr in threads.items():
                thr.time_ns = float(vec.times[tid])
                d = int(vec.ipis[tid])
                if d:
                    thr.ipis_received += d
            vec.flush()
            return
        for tid, w in self.wt.items():
            threads[tid].time_ns = w

    # ------------------------------------------------------------- run loop
    def _dispatch_op(self, op: tuple):
        """Run one op through its per-op handler (shared with the trace
        engine's fallback path for ops outside a fast window)."""
        kind = op[0]
        if kind == "mprotect":
            self._op_mprotect(op[1], op[2], op[3], op[4])
            return None
        if kind == "munmap":
            self._op_munmap(op[1], op[2], op[3])
            return None
        if kind == "madvise":
            self._op_madvise(op[1], op[2], op[3])
            return None
        if kind == "touch":
            self._op_touch(op[1], op[2], op[3] if len(op) > 3 else None)
            return None
        if kind == "mmap":
            return self._op_mmap(op[1], op[2],
                                 op[3] if len(op) > 3 else PERM_RW)
        self._op_migrate(op[1], op[2])  # migrate
        return None

    def run(self) -> list:
        out: list = []
        try:
            for op in self.ops:
                out.append(self._dispatch_op(op))
        finally:
            # on a mid-batch SegfaultError this leaves exactly the partial
            # state the scalar loop would have left (dues settled, times
            # written back).
            self._finish()
        return out

    # ------------------------------------------------------------------ ops
    def _op_mmap(self, tid: int, n_pages: int, perms: int) -> VMA:
        sim = self.sim
        proc = self.proc
        self._settle_ipis(tid)
        c = sim.cost
        node = sim.thread_node(tid)
        start = proc.next_vpn
        proc.next_vpn = next_table_aligned(start + n_pages)
        vma = VMA(next(sim._next_vma), start, start + n_pages, node, perms)
        starts = self._vma_starts
        if not starts or start > starts[-1]:
            proc.vmas.append(vma)
            starts.append(start)
        else:  # pre-existing at_vpn area beyond the allocator cursor
            i = bisect.bisect_right(starts, start)
            proc.vmas.insert(i, vma)
            starts.insert(i, start)
        self._set_time(tid, self._wtime(tid) + (c.syscall_fixed_ns
                                                + c.mmap_extra_ns))
        return vma

    def _op_touch(self, tid: int, vpns, wm) -> None:
        sim = self.sim
        thr = sim.threads[tid]
        if sim.elide_flushes \
                and any(p.lazy_pages for p in sim.processes.values()):
            # a touch may force a deferred flush, which charges stale
            # CPUs' resident threads directly — hand ALL times to the
            # scalar core for the op's duration, not just the toucher's.
            self._sync_threads_out()
            try:
                sim.touch_batch(tid, vpns, wm)
            finally:
                self._sync_threads_in()
                self._relevant.add(thr.cpu)
            return
        self._settle_ipis(tid)
        thr.time_ns = self._wtime(tid)
        try:
            sim.touch_batch(tid, vpns, wm)
        finally:
            self._set_time(tid, thr.time_ns)
            # fills may have put batched-range vpns into this TLB
            self._relevant.add(thr.cpu)

    def _op_migrate(self, tid: int, new_cpu: int) -> None:
        # topology-dependent caches go stale: settle everything first.
        self._settle_all_ipis()
        self.node_rounds = [0] * len(self.node_rounds)
        self.self_rounds.clear()
        self.applied.clear()
        self.sim.migrate_thread(tid, new_cpu)
        self._rebuild_topology_cache()
        self._tcache.clear()
        if self.vec is not None:
            self.vec.rebuild_cpu_map()

    def _op_mprotect(self, tid: int, start: int, n: int, perms: int) -> None:
        sim = self.sim
        proc = self.proc
        if sim.elide_flushes and proc.lazy_pages:
            end_ = start + n
            if any(start <= v < end_ for v in proc.lazy_pages):
                # perms change over lazily-invalidated pages: the deferred
                # flush lands first (scalar order: before the syscall
                # charge), charging stale CPUs' threads directly.
                self._sync_threads_out()
                try:
                    sim._force_deferred_flush(tid, proc)
                finally:
                    self._sync_threads_in()
        self._settle_ipis(tid)
        t = self._wtime(tid) + sim.cost.syscall_fixed_ns
        t, touched = self._update_range(tid, t, start, n, perms)
        end = start + n
        oracle = self.proc.oracle
        if n > PTES_PER_TABLE:
            # enumerate present vpns from the canonical/owner copies (the
            # owner copy is complete under every policy: I1) instead of
            # probing the whole range.
            for vpn in self._present_vpns(touched, start, end):
                oracle[vpn] = (oracle[vpn][0], perms)
        else:
            for vpn in range(start, end):
                e = oracle.get(vpn)
                if e is not None:
                    oracle[vpn] = (e[0], perms)
        vma = self._vma_at(start)
        if vma is not None and vma.start_vpn == start and vma.n_pages == n:
            vma.perms = perms
        t = self._shootdown(tid, t, start, end, touched)
        self._set_time(tid, t)

    def _op_munmap(self, tid: int, start: int, n: int) -> None:
        sim = self.sim
        ctr, c = sim.counters, sim.cost
        self._settle_ipis(tid)
        t = self._wtime(tid) + c.syscall_fixed_ns
        end = start + n
        # present set must be captured before the PTEs are cleared
        if n > PTES_PER_TABLE:
            t0 = start >> LEAF_SHIFT
            t1 = (end - 1) >> LEAF_SHIFT
            present = self._present_vpns(range(t0, t1 + 1), start, end)
        else:
            present = None
        t, touched = self._update_range(tid, t, start, n, None)
        pop = self.proc.oracle.pop
        freed = 0
        if sim.elide_flushes:
            # pool-push order must be the scalar loop's ascending-vpn
            # order (present is table/insertion ordered — sort it)
            push = sim._free_frames.append
            for vpn in (range(start, end) if present is None
                        else sorted(present)):
                e = pop(vpn, None)
                if e is not None:
                    freed += 1
                    push(e[0])
            ctr.data_pages_freed += freed
            t = self._elide(tid, t, start, end)
        else:
            if present is None:
                for vpn in range(start, end):
                    if pop(vpn, None) is not None:
                        freed += 1
            else:
                for vpn in present:
                    if pop(vpn, None) is not None:
                        freed += 1
            ctr.data_pages_freed += freed
            t = self._shootdown(tid, t, start, end, touched)
        store = self.proc.store
        for ti in touched:
            table = store.get(ti)
            if table is not None and table.empty():
                k = table.n_copies()
                ctr.pt_pages_freed += k
                t += c.pt_teardown_ns * k
                store.drop_table(ti)
        self._carve_vmas(start, end)
        self._set_time(tid, t)

    def _op_madvise(self, tid: int, start: int, n: int) -> None:
        """Batched ``NumaSim.madvise_dontneed``: munmap minus the VMA
        carve and leaf-table teardown."""
        sim = self.sim
        ctr, c = sim.counters, sim.cost
        self._settle_ipis(tid)
        t = self._wtime(tid) + c.syscall_fixed_ns
        end = start + n
        if n > PTES_PER_TABLE:
            t0 = start >> LEAF_SHIFT
            t1 = (end - 1) >> LEAF_SHIFT
            present = self._present_vpns(range(t0, t1 + 1), start, end)
        else:
            present = None
        t, touched = self._update_range(tid, t, start, n, None)
        pop = self.proc.oracle.pop
        freed = 0
        if sim.elide_flushes:
            push = sim._free_frames.append
            for vpn in (range(start, end) if present is None
                        else sorted(present)):
                e = pop(vpn, None)
                if e is not None:
                    freed += 1
                    push(e[0])
            ctr.data_pages_freed += freed
            t = self._elide(tid, t, start, end)
        else:
            if present is None:
                for vpn in range(start, end):
                    if pop(vpn, None) is not None:
                        freed += 1
            else:
                for vpn in present:
                    if pop(vpn, None) is not None:
                        freed += 1
            ctr.data_pages_freed += freed
            # tables are never dropped by the zap, so the scalar path's
            # recomputed touched-table list equals _update_range's
            t = self._shootdown(tid, t, start, end, touched)
        self._set_time(tid, t)

    def _elide(self, tid: int, t: float, start: int, end: int) -> float:
        """Batched ``NumaSim._elide_shootdown``: no IPI round — the
        initiator's local invlpg charge plus the stale-mark bookkeeping.
        Only relevance-filtered partitions are scanned: a TLB outside
        ``self._relevant`` holds nothing in any batched range (mm ops
        only remove entries; touch ops add their cpu to the set), so its
        scalar scan would have recorded nothing and its invalidate would
        have been a no-op."""
        sim = self.sim
        ctr = sim.counters
        proc = self.proc
        me_cpu = sim.threads[tid].cpu
        t += sim.cost.tlb_invalidate_self_ns
        ptlbs = sim._asid_tlbs[proc.asid]
        rel = self._relevant
        if me_cpu in rel:
            ptlbs[me_cpu].invalidate_range(start, end)
        recorded = 0
        lazy, stale_map = proc.lazy_pages, proc.lazy_stale
        stale_frame_asid = sim._stale_frame_asid
        for cpu in rel:
            if cpu == me_cpu:
                continue
            tlb = ptlbs.get(cpu)
            if tlb is None:
                continue
            held = tlb.entries_in_range(start, end)
            if not held:
                continue
            stale = stale_map.setdefault(cpu, set())
            entries = tlb.entries
            for vpn in held:
                if vpn not in stale:
                    stale.add(vpn)
                    recorded += 1
                frame = entries[vpn][0]
                lazy[vpn] = frame
                stale_frame_asid[frame] = proc.asid
        ctr.flushes_elided += 1
        ctr.deferred_invalidations += recorded
        return t

    # ----------------------------------------------------- range primitives
    def _present_vpns(self, table_ids, start: int, end: int) -> List[int]:
        """All vpns in [start, end) whose PTE is present, via the canonical
        (LINUX) / owner (MITOSIS, NUMAPTE: invariant I1) copies."""
        store_get = self.proc.store.tables.get
        out: List[int] = []
        for ti in table_ids:
            table = store_get(ti)
            if table is None:
                continue
            base = ti << LEAF_SHIFT
            lo = start if start > base else base
            hi = end if end < base + PTES_PER_TABLE else base + PTES_PER_TABLE
            lo_i = lo & _IDX_MASK
            hi_i = lo_i + (hi - lo)
            copy = table.copies.get(table.owner)
            if not copy:
                continue
            if hi_i - lo_i >= PTES_PER_TABLE:
                out.extend(base + i for i in copy)
            else:
                out.extend(base + i for i in copy if lo_i <= i < hi_i)
        return out

    def _update_range(self, tid: int, t: float, start: int, n: int,
                      perms: Optional[int],
                      sink: Optional[List[float]] = None
                      ) -> Tuple[float, List[int]]:
        """Batched `NumaSim._update_range`: apply perms (None = clear) to
        every present PTE in range, canonical copy + per-policy replicas.
        Charges and counters land exactly as the scalar path's per-replica
        ``cost * wrote`` adds.  With ``sink`` the per-replica charge
        addends are appended there (in charge order) instead of added to
        ``t`` — the trace engine's overlap window records them for an
        exact deferred replay."""
        sim = self.sim
        ctr, c = sim.counters, sim.cost
        node = sim.thread_node(tid)
        WL, WR = c.pte_write_local_ns, c.pte_write_remote_ns
        store_get = self.proc.store.tables.get
        end = start + n
        # table-id bounds are the scalar path's exact formula: a
        # zero-length op at an unaligned start still "touches" (and so
        # shoots down against) the leaf table it straddles.
        touched: List[int] = []
        clear = perms is None
        for tbl_id in range(start >> LEAF_SHIFT, ((end - 1) >> LEAF_SHIFT) + 1):
            table = store_get(tbl_id)
            if table is None:
                continue
            touched.append(tbl_id)
            base = tbl_id << LEAF_SHIFT
            lo = start if start > base else base
            hi = end if end < base + PTES_PER_TABLE else base + PTES_PER_TABLE
            lo_i = lo & _IDX_MASK
            span = hi - lo
            hi_i = lo_i + span
            whole = span >= PTES_PER_TABLE
            for copy_node in sim._coherence_targets(table):
                copy = table.copies.get(copy_node)
                if copy is None:
                    continue
                wrote = 0
                if clear:
                    if whole:
                        wrote = len(copy)
                        copy.clear()
                    elif len(copy) < span:
                        for i in [i for i in copy if lo_i <= i < hi_i]:
                            del copy[i]
                            wrote += 1
                    else:
                        for i in range(lo_i, hi_i):
                            if i in copy:
                                del copy[i]
                                wrote += 1
                else:
                    if whole:
                        for i, p in copy.items():
                            copy[i] = PTE(p.frame, p.frame_node, perms)
                        wrote = len(copy)
                    elif len(copy) < span:
                        for i in list(copy):
                            if lo_i <= i < hi_i:
                                p = copy[i]
                                copy[i] = PTE(p.frame, p.frame_node, perms)
                                wrote += 1
                    else:
                        for i in range(lo_i, hi_i):
                            p = copy.get(i)
                            if p is not None:
                                copy[i] = PTE(p.frame, p.frame_node, perms)
                                wrote += 1
                if wrote:
                    if copy_node == node:
                        ctr.replica_writes_local += wrote
                        v = WL * wrote
                    else:
                        ctr.replica_writes_remote += wrote
                        v = WR * wrote
                    if sink is None:
                        t += v
                    else:
                        sink.append(v)
        return t, touched

    def _shootdown(self, tid: int, t: float, start: int, end: int,
                   touched: List[int]) -> float:
        """Batched `NumaSim._shootdown`: O(nodes) target arithmetic from the
        occupancy histogram, grouped IPI-receive accrual, relevance-filtered
        TLB invalidations."""
        sim = self.sim
        ctr = sim.counters
        me_cpu = sim.threads[tid].cpu
        my_node = self.node_of(me_cpu)
        if sim.tlb_filter:
            allowed = 0
            store_get = self.proc.store.tables.get
            for ti in touched:
                table = store_get(ti)
                if table is not None:
                    allowed |= table.sharers
        else:
            allowed = self.full_mask
        occ = self.occ_count
        n_local = (occ[my_node] - 1) if (allowed >> my_node) & 1 else 0
        n_remote = 0
        for nd, cnt in occ.items():
            if nd != my_node and (allowed >> nd) & 1:
                n_remote += cnt
        ctr.ipis_filtered += (self.total_occ - 1) - (n_local + n_remote)
        ctr.shootdown_rounds += 1
        model = self.contention
        if model is not None and model.ipi_free:
            return self._hw_round(t, me_cpu, my_node, allowed, start, end,
                                  model)
        ctr.ipis_local += n_local
        ctr.ipis_remote += n_remote
        c = sim.cost
        base = (c.shootdown_cost_ns(n_local, n_remote)
                + c.tlb_invalidate_self_ns)
        if model is not None and (n_local or n_remote):
            # same round-start time and float order as the scalar path: the
            # round starts at the initiator's working time before the
            # dispatch/ack charge; base and extra land as two separate adds.
            cached = self._tcache.get((allowed, me_cpu))
            if cached is None:
                tlist = sorted(cpu
                               for nd, cpus in self.occ_sets.items()
                               if (allowed >> nd) & 1
                               for cpu in cpus if cpu != me_cpu)
                tarr = np.asarray(tlist, dtype=np.int64)
                larr = (tarr // self.hw_per_node) == my_node
                cached = (tlist, tarr, larr)
                self._tcache[(allowed, me_cpu)] = cached
            tlist, tarr, larr = cached
            vec = self.vec
            if vec is not None:
                out = vec.settle_and_charge(t, me_cpu, tarr, larr,
                                            n_local, n_remote, c)
                if out is None:
                    self._abandon_vector()   # rare: non-finite round start
                    vec = None
                else:
                    # the vectorized engine settled AND charged the
                    # responders (bit-identically); fold the initiator
                    # view into the counters and the ack wait.
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
                # eager two-sided responder settlement: per-round per-CPU
                # charges (handler from the *model*, then the stretch) in
                # the scalar path's exact order — shared with the scalar
                # engine via shootdown.charge_responders, against this
                # engine's working-time dict.  The lazy grouped accrual
                # cannot express per-round stretches, so overlap mode
                # bypasses it entirely (node_rounds stays zero for the
                # whole batch).
                charge_responders(
                    s, model.handler_ns, tlist, sim._cpu_threads,
                    lambda thr: self._wtime(thr.tid),
                    lambda thr, v: self._set_time(thr.tid, v))
        else:
            t += base
        if model is None and allowed:
            node_rounds = self.node_rounds
            for nd in range(len(node_rounds)):
                if (allowed >> nd) & 1:
                    node_rounds[nd] += 1
            if (allowed >> my_node) & 1:
                self.self_rounds[me_cpu] = \
                    self.self_rounds.get(me_cpu, 0) + 1
        rel = self._relevant
        if rel:
            tlbs = sim._asid_tlbs[self.proc.asid]
            node_of = self.node_of
            occupied = self.occupied_all
            for cpu in rel:
                if cpu == me_cpu or (cpu in occupied
                                     and (allowed >> node_of(cpu)) & 1):
                    tlbs[cpu].invalidate_range(start, end)
        return t

    def _hw_round(self, t: float, me_cpu: int, my_node: int, allowed: int,
                  start: int, end: int, model, rel=None) -> float:
        """Hardware-coherence settlement of one batched round: the batched
        mirror of ``NumaSim._hw_shootdown``.  Only relevance-filtered
        partitions are visited (a TLB outside ``self._relevant`` — or
        outside the trace engine's per-op compiled mask passed as ``rel``
        — provably holds no line in the range, and the scalar path skips
        zero-line CPUs too), in sorted-CPU order so the counter and
        thread-time float sequences are identical to the scalar scan.
        Shared by the per-op batch path and the trace-window replay."""
        sim = self.sim
        ctr = sim.counters
        topo = sim.topo
        t += sim.cost.tlb_invalidate_self_ns
        if rel is None:
            rel = self._relevant
        if not rel:
            return t
        tlbs = sim._asid_tlbs[self.proc.asid]
        node_of = self.node_of
        occupied = self.occupied_all
        line_costs: Dict[int, float] = {}
        for cpu in sorted(rel):
            tlb = tlbs.get(cpu)
            if tlb is None:
                continue
            if cpu == me_cpu:
                tlb.invalidate_range(start, end)
                continue
            if cpu in occupied and (allowed >> node_of(cpu)) & 1:
                lines = tlb.invalidate_range(start, end)
                if not lines:
                    continue
                hops = topo.hops(my_node, node_of(cpu))
                cost_cpu = model.line_cost_ns(lines, hops)
                ctr.hw_line_invalidations += lines
                ctr.hw_invalidation_ns += cost_cpu
                line_costs[cpu] = cost_cpu
        if line_costs:
            charge_responders(
                RoundSettlement(target_stretch=line_costs), 0.0,
                sorted(line_costs), sim._cpu_threads,
                lambda thr: self._wtime(thr.tid),
                lambda thr, v: self._set_time(thr.tid, v),
                count_ipis=False, asid=self.proc.asid)
        return t
