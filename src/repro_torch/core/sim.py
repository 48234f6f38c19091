"""numaPTE protocol simulator: the paper's mechanism, exactly.

One `NumaSim` instance models one machine running N processes (address
spaces).  Each ``Process`` owns its VMAs, page-table root/replicas
(``PageTableStore``), translation oracle, thread membership and the implied
``mm_cpumask``; TLB entries are ASID/PCID-tagged (one ``TLB`` partition per
(cpu, asid), see ``repro_torch.core.tlb``), so context switches between processes
sharing a hardware thread flush nothing.  Shootdown fan-out is per-process:
Linux targets the initiating process's whole ``mm_cpumask`` — which is how
one tenant's munmap storm interrupts *whoever* is resident on shared CPUs,
the cross-tenant blast radius the colocation benchmark measures — while
numaPTE's sharer filter contains it.  Every sim starts with a default
process (ASID 0) that all single-process APIs operate on, which keeps the
classic one-process behaviour bit-for-bit identical; ``spawn_process()``
adds tenants.  It implements, switchable per run:

  * ``Policy.LINUX``   — no replication, first-touch page-table placement,
    process-wide TLB shootdowns (baseline Linux v4.17 semantics).
  * ``Policy.MITOSIS`` — eager full replication on every node, coherence
    writes to every replica on every PTE change, process-wide shootdowns.
  * ``Policy.NUMAPTE`` — lazy, partial, on-demand replication with the
    owner invariant (I1), per-table sharer masks, degree-d prefetch, and
    (optionally) sharer-filtered TLB shootdowns (I2).

Every operation updates exact event counters and charges modeled nanoseconds
(see ``costmodel.CostModel``) to the calling thread; IPI receive cost is
charged to the interrupted target threads, which is what the webserver /
memcached throughput benchmarks measure.

Invariants maintained (property-tested in tests/test_core_invariants.py):
  I1: a valid PTE for a page exists somewhere  =>  the VMA owner's (NUMAPTE)
      or canonical (LINUX/MITOSIS) copy holds it.
  I2: CPU c on node n holds vpn in its TLB     =>  n is in the sharer mask of
      leaf_table(vpn) and the local replica holds (or held until the very
      shootdown that is removing it) that PTE.
  I3: translations always agree with a flat oracle map.
  I4: after munmap returns, no TLB in the system holds any unmapped vpn.

Flush elision (``SimConfig(elide_flushes=True)``; "Skip TLB flushes for
reused pages within mmap's", arXiv 2409.10946): ``munmap`` and
``madvise_dontneed`` skip the IPI round and instead record, per process,
which translations other CPUs still cache (``Process.lazy_pages`` /
``lazy_stale``); freed frames enter a machine-wide reuse pool.  The
deferred shootdown is forced — one precise round through the same
contention/settlement machinery — the moment a marked page is touched,
has its protections tightened, or its frame is handed to a *different*
address space.  I4 is relaxed exactly this far: a TLB may hold an
unmapped vpn iff it is a recorded lazy invalidation whose stale frame is
not live in any other process — ``check_invariants`` proves a stale
translation is never serveable across process boundaries.  With the knob
off (default) every path above is byte-identical to the classic engines.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .config import SimConfig, _UNSET, _warn_deprecated
from .costmodel import CostModel
from .pagetable import (PERM_RW, PTE, PTES_PER_TABLE, LeafTable,
                        PageTableStore, Policy, VMA, leaf_base_vpn, leaf_id,
                        leaf_index, next_table_aligned)
from .shootdown import (IPI_RECEIVE_NS, ContentionModel, RoundSettlement,
                        charge_responders)
from .shootdown_batch import (SETTLE_MODES, settle_round, supports_vector)
from .tlb import DEFAULT_TLB_ENTRIES, TLB
from .topology import NumaTopology

__all__ = ["Counters", "IPI_RECEIVE_NS", "NumaSim", "Process",
           "SegfaultError", "Thread"]


@dataclasses.dataclass
class Counters:
    tlb_hits: int = 0
    tlb_misses: int = 0
    walks_local: int = 0
    walks_remote: int = 0
    faults: int = 0
    first_touches: int = 0
    pte_copies: int = 0          # PTEs copied from owner on demand
    pte_prefetched: int = 0      # additional PTEs brought in by prefetch
    replica_writes_local: int = 0
    replica_writes_remote: int = 0
    shootdown_rounds: int = 0
    ipis_local: int = 0
    ipis_remote: int = 0
    ipis_filtered: int = 0       # IPIs numaPTE proved unnecessary (saved)
    overlapping_rounds: int = 0  # rounds whose IPIs queued behind another's
    ipi_queue_delay_ns: float = 0.0  # total receive-queue delay (contention)
    ipis_coalesced: int = 0      # IPIs merged into a pending handler
    responder_delay_ns: float = 0.0  # target-thread stretch beyond handler
    flushes_elided: int = 0      # unmap shootdown rounds skipped lazily
    deferred_invalidations: int = 0  # stale (cpu, vpn) entries recorded
    forced_flushes: int = 0      # deferred flushes forced by reuse/touch
    hw_line_invalidations: int = 0   # stale entries killed by hw coherence
    hw_invalidation_ns: float = 0.0  # total per-line hw invalidation cost
    pt_pages_alloc: int = 0
    pt_pages_freed: int = 0
    data_pages_alloc: int = 0
    data_pages_freed: int = 0
    remote_data_accesses: int = 0
    local_data_accesses: int = 0

    def snapshot(self) -> "Counters":
        return dataclasses.replace(self)

    def diff(self, earlier: "Counters") -> "Counters":
        return Counters(**{f.name: getattr(self, f.name) - getattr(earlier, f.name)
                           for f in dataclasses.fields(Counters)})


@dataclasses.dataclass
class Thread:
    tid: int
    cpu: int
    time_ns: float = 0.0         # modeled time consumed by this thread
    ipis_received: int = 0
    asid: int = 0                # owning process (address-space id)


class Process:
    """One address space on the machine: VMAs, page tables, oracle, threads.

    The default process (ASID 0) exists from construction and is what every
    single-process API (and the ``NumaSim.store``/``vmas``/``_oracle``
    compatibility properties) operates on.  ``cpus()`` is the process's
    ``mm_cpumask``: the set of hardware threads currently running one of its
    threads, i.e. exactly the CPUs a Linux process-wide shootdown targets.
    """

    __slots__ = ("asid", "name", "store", "vmas", "threads", "oracle",
                 "next_vpn", "lazy_pages", "lazy_stale")

    def __init__(self, asid: int, n_nodes: int, name: Optional[str] = None):
        self.asid = asid
        self.name = name if name is not None else f"proc{asid}"
        self.store = PageTableStore(n_nodes)
        self.vmas: List[VMA] = []
        self.threads: Dict[int, Thread] = {}
        self.oracle: Dict[int, Tuple[int, int]] = {}  # vpn -> (frame, perms)
        self.next_vpn = 1 << 20      # start allocations at 4GB
        # lazy-invalidation state (elide_flushes): marked-stale unmapped
        # vpns -> the frame their surviving TLB entries translate to, and
        # per-CPU (possibly superset: natural evictions aren't tracked)
        # sets of which partitions still cache them.  Both empty whenever
        # no flush is pending; always empty with the knob off.
        self.lazy_pages: Dict[int, int] = {}
        self.lazy_stale: Dict[int, set] = {}

    def cpus(self) -> set:
        """The process's mm_cpumask (CPUs with a resident thread)."""
        return {t.cpu for t in self.threads.values()}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Process(asid={self.asid}, name={self.name!r}, "
                f"threads={sorted(self.threads)}, vmas={len(self.vmas)})")


class SegfaultError(Exception):
    pass


class NumaSim:
    def __init__(self,
                 topology: NumaTopology,
                 policy: Policy = Policy.NUMAPTE,
                 *,
                 prefetch_degree: int = 0,
                 tlb_filter: bool = True,
                 cost: Optional[CostModel] = None,
                 tlb_entries: int = DEFAULT_TLB_ENTRIES,
                 interference_nodes: Sequence[int] = (),
                 contention=_UNSET,
                 settle_engine=_UNSET,
                 config: Optional[SimConfig] = None):
        if config is None:
            # legacy kwarg surface folds into a config; contention= /
            # settle_engine= are the deprecated spellings
            if contention is not _UNSET:
                _warn_deprecated("NumaSim(contention=...)",
                                 "SimConfig(contention=...) / make_sim")
            else:
                contention = None
            if settle_engine is not _UNSET:
                _warn_deprecated("NumaSim(settle_engine=...)",
                                 "SimConfig(settle=...) / make_sim")
            else:
                settle_engine = "auto"
            config = SimConfig(policy=policy,
                               prefetch_degree=prefetch_degree,
                               tlb_filter=tlb_filter, cost=cost,
                               tlb_entries=tlb_entries,
                               interference_nodes=tuple(interference_nodes),
                               contention=contention,
                               settle=settle_engine)
        elif contention is not _UNSET or settle_engine is not _UNSET:
            raise ValueError("pass knobs via config=SimConfig(...) or via "
                             "legacy kwargs, not both")
        #: the resolved declarative config this sim was built from
        self.config = config
        policy = config.resolved_policy()
        tlb_filter = config.tlb_filter
        if policy is not Policy.NUMAPTE:
            tlb_filter = False  # the optimization needs sharer info
        self.topo = topology
        #: pluggable overlapping-IPI-round settlement (repro_torch.core.shootdown);
        #: None = classic sequential semantics (every round runs alone).
        self.contention = config.resolved_contention()
        #: how contended rounds settle: "auto" picks the vectorized
        #: engine (repro_torch.core.shootdown_batch) for the stock models,
        #: "vector" requires it, "sequential" forces the scalar model
        #: loops (the differential reference).  Bit-identical either way.
        self.settle_engine = config.settle
        #: which settlement engine the last apply_mm_ops batch used
        #: ("vector" / "sequential" / "mixed"; None = sequential mode).
        self.last_settle_engine: Optional[str] = None
        #: which mm-op execution engine the last apply_mm_ops batch used
        #: ("scalar" / "batch" / "trace"; None before the first batch) —
        #: the per-row provenance field benchmark rows record.
        self.last_mm_engine: Optional[str] = None
        self.policy = policy
        self.prefetch_degree = config.prefetch_degree
        self.tlb_filter = tlb_filter
        self.cost = config.cost or CostModel.paper_default()
        self.tlb_entries = config.tlb_entries
        interference_nodes = config.interference_nodes
        #: ASID-0 per-CPU TLB partitions (the default process's view; the
        #: classic single-process attribute).  asid>0 partitions live in
        #: ``_asid_tlbs``, which aliases this dict at key 0.
        self.tlbs: Dict[int, TLB] = {}
        self._asid_tlbs: Dict[int, Dict[int, TLB]] = {0: self.tlbs}
        #: every thread on the machine, across all processes (tids are
        #: machine-global and dense; per-process membership is
        #: ``Process.threads``).
        self.threads: Dict[int, Thread] = {}
        self.counters = Counters()
        self._next_tid = itertools.count()
        self._next_vma = itertools.count()
        self._next_frame = itertools.count()   # physical frames: machine-wide
        self._next_asid = itertools.count(1)
        self._frame_nodes: Dict[int, int] = {}         # frame -> data node
        #: lazy TLB invalidation on the unmap paths (see module docstring);
        #: off = classic eager shootdowns, byte-identical to before.
        self.elide_flushes = config.elide_flushes
        #: freed physical frames available for reuse (LIFO; populated only
        #: under elide_flushes so the classic frame sequence is untouched)
        self._free_frames: List[int] = []
        #: freed frame -> asid whose TLBs may still cache a stale
        #: translation to it; reusing such a frame in a *different*
        #: address space forces that process's deferred flush first.
        self._stale_frame_asid: Dict[int, int] = {}
        self._cpu_threads: Dict[int, List[Thread]] = {}
        self._interference = frozenset(interference_nodes)
        #: address spaces on this machine; ASID 0 is the default process
        self.processes: Dict[int, Process] = {0: Process(0, topology.n_nodes)}

    # ----------------------------------------------- default-process aliases
    # The classic single-process attributes delegate to the default process
    # (ASID 0) so every pre-Process API, engine binding and test keeps
    # working unchanged; multi-process code goes through ``process_of``.
    @property
    def store(self) -> PageTableStore:
        return self.processes[0].store

    @property
    def vmas(self) -> List[VMA]:
        return self.processes[0].vmas

    @vmas.setter
    def vmas(self, value: List[VMA]) -> None:
        self.processes[0].vmas = value

    @property
    def _oracle(self) -> Dict[int, Tuple[int, int]]:
        return self.processes[0].oracle

    @property
    def _next_vpn(self) -> int:
        return self.processes[0].next_vpn

    @_next_vpn.setter
    def _next_vpn(self, value: int) -> None:
        self.processes[0].next_vpn = value

    # ------------------------------------------------------------------ utils
    def spawn_process(self, name: Optional[str] = None) -> Process:
        """Create a new address space (tenant).  Pass the returned process
        (or its asid) to ``spawn_thread`` to place threads in it."""
        asid = next(self._next_asid)
        proc = Process(asid, self.topo.n_nodes, name=name)
        self.processes[asid] = proc
        return proc

    def process_of(self, tid: int) -> Process:
        return self.processes[self.threads[tid].asid]

    def tlb_partition(self, cpu: int, asid: int = 0) -> TLB:
        """The (cpu, asid) TLB partition, created on first use — the tagged
        entries a context switch to this process finds (PCID: no flush)."""
        parts = self._asid_tlbs.setdefault(asid, {})
        tlb = parts.get(cpu)
        if tlb is None:
            tlb = parts[cpu] = TLB(self.tlb_entries, asid=asid)
        return tlb

    def spawn_thread(self, cpu: int, process=None) -> int:
        self.topo.validate_cpu(cpu)
        if process is None:
            proc = self.processes[0]
        elif isinstance(process, Process):
            proc = process
        else:
            proc = self.processes[process]
        tid = next(self._next_tid)
        thr = Thread(tid=tid, cpu=cpu, asid=proc.asid)
        self.threads[tid] = thr
        proc.threads[tid] = thr
        self.tlb_partition(cpu, proc.asid)
        self._cpu_threads.setdefault(cpu, []).append(thr)
        return tid

    def thread_node(self, tid: int) -> int:
        return self.topo.node_of_cpu(self.threads[tid].cpu)

    def _charge(self, tid: int, ns: float) -> None:
        self.threads[tid].time_ns += ns

    def _interfered(self, a: int, b: int) -> bool:
        """Cross-socket traffic between a,b competes with interference apps."""
        return a != b and (a in self._interference or b in self._interference)

    def find_vma(self, vpn: int, asid: int = 0) -> Optional[VMA]:
        for vma in self.processes[asid].vmas:
            if vpn in vma:
                return vma
        return None

    # ----------------------------------------------------------------- mmap
    def mmap(self, tid: int, n_pages: int, *, perms: int = PERM_RW,
             owner_node: Optional[int] = None, populate: bool = False,
             at_vpn: Optional[int] = None) -> VMA:
        c = self.cost
        proc = self.process_of(tid)
        node = owner_node if owner_node is not None else self.thread_node(tid)
        if at_vpn is None:
            # Distinct VMAs live in distinct leaf tables: mmap'd areas get
            # their own PT pages in practice (per-thread arenas, guard gaps,
            # top-down mmap layout); co-locating unrelated VMAs in one leaf
            # table would charge numaPTE for false table-level sharing.
            start = proc.next_vpn
            proc.next_vpn = next_table_aligned(start + n_pages)
        else:
            start = at_vpn
        vma = VMA(next(self._next_vma), start, start + n_pages, node, perms)
        proc.vmas.append(vma)
        self._charge(tid, c.syscall_fixed_ns + c.mmap_extra_ns)
        if populate:
            for vpn in range(vma.start_vpn, vma.end_vpn):
                self.touch(tid, vpn)
        return vma

    # ---------------------------------------------------------------- access
    def touch(self, tid: int, vpn: int, write: bool = False) -> int:
        """One memory access by thread `tid` to `vpn`. Returns the frame id."""
        thr = self.threads[tid]
        proc = self.processes[thr.asid]
        if self.elide_flushes and proc.lazy_pages \
                and vpn in proc.lazy_pages:
            # a touch of a lazily-invalidated page: pay the deferred
            # shootdown BEFORE the lookup so the stale entry can never
            # be served (the refault below re-establishes the mapping).
            self._force_deferred_flush(tid, proc)
        node = self.topo.node_of_cpu(thr.cpu)
        tlb = self._asid_tlbs[thr.asid][thr.cpu]
        hit = tlb.lookup(vpn)
        ctr, c = self.counters, self.cost
        if hit is not None:
            ctr.tlb_hits += 1
            frame = hit[0]
            self._count_data(node, vpn, tid)
            return frame
        ctr.tlb_misses += 1
        tid_table = leaf_id(vpn)
        table = proc.store.get(tid_table)
        # -- hardware walk against the local (or canonical) copy ------------
        if table is not None:
            walk_node, pte = self._walk(table, node, leaf_index(vpn))
            if pte is not None:
                local = walk_node == node
                ctr.walks_local += local
                ctr.walks_remote += not local
                self._charge(tid, c.walk_cost_ns(
                    local=local,
                    interference=self._interfered(walk_node, node)))
                tlb.fill(vpn, pte.frame, pte.perms)
                self._count_data(node, vpn, tid)
                return pte.frame
            # charge the failed walk too (reached the leaf, found not-present)
            local = walk_node == node if walk_node is not None else True
            self._charge(tid, c.walk_cost_ns(local=local))
        # -- page fault -------------------------------------------------------
        frame = self._page_fault(tid, node, vpn, write)
        pte = self._lookup_for_fill(proc, tid_table, node, vpn)
        assert pte is not None
        tlb.fill(vpn, pte.frame, pte.perms)
        self._count_data(node, vpn, tid)
        return frame

    def access_many(self, tid: int, vpns: Iterable[int],
                    write: bool = False) -> None:
        touch = self.touch
        for vpn in vpns:
            touch(tid, vpn, write)

    def touch_batch(self, tid: int, vpns, write_mask=None, *,
                    return_frames: bool = False):
        """Vectorized equivalent of calling ``touch`` for every vpn in
        order (see ``repro_torch.core.batch``).  Counters and modeled nanoseconds
        are byte-identical to the scalar loop; ``write_mask`` mirrors the
        scalar ``write`` flag (which does not influence classification)."""
        from .batch import touch_batch as _touch_batch
        return _touch_batch(self, tid, vpns, write_mask,
                            return_frames=return_frames)

    # ------------------------------------------------------- batched mm ops
    def apply_mm_ops(self, ops, *, engine=_UNSET,
                     concurrency=_UNSET,
                     contention=_UNSET,
                     settle=_UNSET) -> list:
        """Apply a sequence of ``("mmap"|"touch"|"mprotect"|"munmap"|
        "madvise"|"migrate", tid, ...)`` ops in order (see
        ``repro_torch.core.mm_batch``).
        ``engine="batch"`` runs the vectorized mm engine, byte-identical to
        ``engine="scalar"`` (the per-op reference loop).
        ``concurrency="overlap"`` settles concurrently issued shootdowns as
        overlapping IPI rounds under a ``repro_torch.core.shootdown`` contention
        model (``CoalescingContention`` unless one is given);
        ``"sequential"`` keeps the classic each-round-runs-alone
        semantics.  ``settle`` picks the settlement engine for contended
        rounds (``repro_torch.core.shootdown_batch``): ``"auto"`` vectorizes
        when the model supports it, ``"sequential"`` forces the scalar
        model loops — bit-identical either way.

        Knob defaults come from ``self.config`` (a ``SimConfig``); the
        explicit kwargs are deprecated per-call overrides."""
        from .mm_batch import apply_mm_ops as _apply
        return _apply(self, ops, engine=engine, concurrency=concurrency,
                      contention=contention, settle=settle)

    def mmap_batch(self, tid: int, sizes, *, perms: int = PERM_RW,
                   engine=_UNSET):
        """Batched ``mmap``: one VMA per entry of ``sizes``, in order."""
        from .mm_batch import mmap_batch as _mmap_batch
        return _mmap_batch(self, tid, sizes, perms=perms, engine=engine)

    def mprotect_batch(self, tid: int, starts, n_pages, perms, *,
                       engine=_UNSET) -> None:
        """Batched ``mprotect`` over parallel (start, n_pages, perms)
        arrays; scalars broadcast.  Counters, modeled nanoseconds, TLB and
        page-table state are byte-identical to the scalar loop."""
        from .mm_batch import mprotect_batch as _mprotect_batch
        _mprotect_batch(self, tid, starts, n_pages, perms, engine=engine)

    def munmap_batch(self, tid: int, starts, n_pages, *,
                     engine=_UNSET) -> None:
        """Batched ``munmap`` over parallel (start, n_pages) arrays."""
        from .mm_batch import munmap_batch as _munmap_batch
        _munmap_batch(self, tid, starts, n_pages, engine=engine)

    def _count_data(self, node: int, vpn: int, tid: int) -> None:
        entry = self.process_of(tid).oracle.get(vpn)
        if entry is None:
            return
        # oracle stores (frame, perms); data node tracked separately
        data_node = self._frame_nodes.get(entry[0], node)
        if data_node == node:
            self.counters.local_data_accesses += 1
            self._charge(tid, self.cost.local_mem_ns)
        else:
            self.counters.remote_data_accesses += 1
            self._charge(tid, self.cost.walk_cost_ns(
                local=False, interference=self._interfered(data_node, node)))

    def _walk(self, table: LeafTable, node: int,
              idx: int) -> Tuple[Optional[int], Optional[PTE]]:
        """Return (node_walked, pte) per policy for a hardware walk."""
        if self.policy is Policy.LINUX:
            # single canonical copy; hardware walks it wherever it is
            canon = table.owner
            return canon, table.lookup(canon, idx)
        # MITOSIS / NUMAPTE: hardware only ever walks the local replica
        if node in table.copies:
            return node, table.lookup(node, idx)
        return None, None

    def _lookup_for_fill(self, proc: Process, tid_table: int, node: int,
                         vpn: int) -> Optional[PTE]:
        table = proc.store.get(tid_table)
        if table is None:
            return None
        if self.policy is Policy.LINUX:
            return table.lookup(table.owner, leaf_index(vpn))
        return table.lookup(node, leaf_index(vpn))

    # ------------------------------------------------------------ page fault
    def _page_fault(self, tid: int, node: int, vpn: int, write: bool) -> int:
        ctr, c = self.counters, self.cost
        ctr.faults += 1
        self._charge(tid, c.fault_fixed_ns)
        proc = self.process_of(tid)
        store = proc.store
        vma = self.find_vma(vpn, proc.asid)
        if vma is None:
            raise SegfaultError(f"vpn {vpn} not mapped")
        tbl_id = leaf_id(vpn)
        idx = leaf_index(vpn)
        table = store.get(tbl_id)

        if self.policy is Policy.LINUX:
            if table is None:
                table = store.create(tbl_id, owner=node)  # first touch
                ctr.pt_pages_alloc += 1
                self._charge(tid, c.pt_alloc_ns)
            pte = table.lookup(table.owner, idx)
            if pte is None:
                pte = self._alloc_page(tid, node, vma, table, table.owner, idx)
            return pte.frame

        if self.policy is Policy.MITOSIS:
            if table is None:
                table = store.create(tbl_id, owner=node)
                ctr.pt_pages_alloc += 1
                self._charge(tid, c.pt_alloc_ns)
                # eager: replicate the table page on every node immediately
                for n in range(self.topo.n_nodes):
                    if n not in table.copies:
                        store.install_replica(table, n)
                        ctr.pt_pages_alloc += 1
                        self._charge(tid, c.pt_alloc_ns)
            pte = table.lookup(node, idx)
            if pte is None:
                pte = self._alloc_page(tid, node, vma, table, node, idx)
                # eager coherence: install into every replica
                for n in table.copies:
                    if n == node:
                        continue
                    table.copies[n][idx] = PTE(pte.frame, pte.frame_node, pte.perms)
                    ctr.replica_writes_remote += 1
                    self._charge(tid, c.pte_write_remote_ns)
            return pte.frame

        # ---- NUMAPTE --------------------------------------------------------
        owner = vma.owner
        if table is None:
            table = store.create(tbl_id, owner=owner)
            ctr.pt_pages_alloc += 1
            self._charge(tid, c.pt_alloc_ns)
        if node not in table.copies:
            store.install_replica(table, node)
            ctr.pt_pages_alloc += 1
            self._charge(tid, c.pt_alloc_ns)
        owner_pte = table.lookup(table.owner, idx)
        if owner_pte is None:
            # page never touched anywhere: create it (I1: owner gets it too)
            pte = self._alloc_page(tid, node, vma, table, node, idx)
            if table.owner != node:
                table.copies[table.owner][idx] = PTE(pte.frame, pte.frame_node,
                                                     pte.perms)
                ctr.replica_writes_remote += 1
                self._charge(tid, c.pte_write_remote_ns)
            return pte.frame
        # owner has it: copy on demand, with degree-d prefetch
        if node != table.owner:
            self._charge(tid, c.pte_copy_remote_ns)
        ctr.pte_copies += 1
        local = table.copies[node]
        local[idx] = PTE(owner_pte.frame, owner_pte.frame_node, owner_pte.perms)
        if self.prefetch_degree > 0 and node != table.owner:
            self._prefetch(tid, table, node, vma, vpn)
        return owner_pte.frame

    def _prefetch(self, tid: int, table: LeafTable, node: int, vma: VMA,
                  vpn: int) -> None:
        """Copy 2^d neighbouring PTEs, clipped to the table and VMA bounds
        (Fig 5).  Centered on the requested entry, like a cache-line fill."""
        c = self.cost
        want = 1 << self.prefetch_degree
        base = leaf_base_vpn(table.tid)
        lo = max(vma.start_vpn, base, vpn - want // 2)
        hi = min(vma.end_vpn, base + PTES_PER_TABLE, lo + want)
        lo = max(lo, hi - want)
        owner_copy = table.copies[table.owner]
        local = table.copies[node]
        fetched = 0
        for v in range(lo, hi):
            i = leaf_index(v)
            if v == vpn or i in local:
                continue
            src = owner_copy.get(i)
            if src is not None:
                local[i] = PTE(src.frame, src.frame_node, src.perms)
                fetched += 1
        self.counters.pte_prefetched += fetched
        # streamed from the same (already open) remote PT page
        self._charge(tid, fetched * c.pte_copy_stream_ns)

    def _alloc_page(self, tid: int, toucher_node: int, vma: VMA,
                    table: LeafTable, copy_node: int, idx: int) -> PTE:
        """First touch of a page: allocate the data frame on the toucher's
        node (Linux first-touch data policy) and install the PTE."""
        ctr, c = self.counters, self.cost
        if self.elide_flushes and self._free_frames:
            frame = self._free_frames.pop()
            owner_asid = self._stale_frame_asid.get(frame)
            if owner_asid is not None \
                    and owner_asid != self.threads[tid].asid:
                # the frame is being remapped across address spaces while
                # another process's TLBs may still translate to it: that
                # process's deferred flush must land first (the one case
                # lazy invalidation may never defer past).
                self._force_deferred_flush(tid, self.processes[owner_asid])
        else:
            frame = next(self._next_frame)
        ctr.first_touches += 1
        ctr.data_pages_alloc += 1
        self._charge(tid, c.page_alloc_ns)
        pte = PTE(frame, toucher_node, vma.perms)
        table.copies[copy_node][idx] = pte
        if copy_node == toucher_node:
            ctr.replica_writes_local += 1
            self._charge(tid, c.pte_write_local_ns)
        else:
            ctr.replica_writes_remote += 1
            self._charge(tid, c.pte_write_remote_ns)
        vpn = leaf_base_vpn(table.tid) + idx
        self.process_of(tid).oracle[vpn] = (frame, vma.perms)
        self._frame_nodes[frame] = toucher_node
        return pte

    # ------------------------------------------------------------- mutation
    def mprotect(self, tid: int, start_vpn: int, n_pages: int,
                 perms: int) -> None:
        proc = self.process_of(tid)
        if self.elide_flushes and proc.lazy_pages:
            end = start_vpn + n_pages
            if any(start_vpn <= v < end for v in proc.lazy_pages):
                # tightening (or any perms change over) lazily-invalidated
                # pages: the stale entries carry the old perms, so the
                # deferred flush must land before the syscall proceeds.
                self._force_deferred_flush(tid, proc)
        self._charge(tid, self.cost.syscall_fixed_ns)
        touched_tables = self._update_range(
            tid, start_vpn, n_pages,
            lambda pte: dataclasses.replace(pte, perms=perms))
        oracle = proc.oracle
        for vpn in range(start_vpn, start_vpn + n_pages):
            if vpn in oracle:
                oracle[vpn] = (oracle[vpn][0], perms)
        vma = self.find_vma(start_vpn, proc.asid)
        if vma is not None and vma.start_vpn == start_vpn and vma.n_pages == n_pages:
            vma.perms = perms
        self._shootdown(tid, start_vpn, start_vpn + n_pages, touched_tables)

    def munmap(self, tid: int, start_vpn: int, n_pages: int) -> None:
        ctr, c = self.counters, self.cost
        proc = self.process_of(tid)
        self._charge(tid, c.syscall_fixed_ns)
        end_vpn = start_vpn + n_pages
        touched_tables = self._update_range(tid, start_vpn, n_pages, None)
        elide = self.elide_flushes
        # free data pages (under elision the frames enter the reuse pool)
        for vpn in range(start_vpn, end_vpn):
            entry = proc.oracle.pop(vpn, None)
            if entry is not None:
                ctr.data_pages_freed += 1
                if elide:
                    self._free_frames.append(entry[0])
        if elide:
            self._elide_shootdown(tid, start_vpn, end_vpn)
        else:
            # shootdown BEFORE page-table pages are freed (kernel ordering)
            self._shootdown(tid, start_vpn, end_vpn, touched_tables)
        # tear down empty leaf tables (and their replicas)
        for tbl_id in touched_tables:
            table = proc.store.get(tbl_id)
            if table is not None and table.empty():
                freed = table.n_copies()
                ctr.pt_pages_freed += freed
                self._charge(tid, c.pt_teardown_ns * freed)
                proc.store.drop_table(tbl_id)
        # shrink VMA list
        self._carve_vmas(proc, start_vpn, end_vpn)

    def madvise_dontneed(self, tid: int, start_vpn: int,
                         n_pages: int) -> None:
        """MADV_DONTNEED over [start, start+n): zap the PTEs and free the
        data pages but keep the VMA (the range stays mapped; the next
        touch refaults) and the leaf-table pages (Linux keeps them too —
        only the entries are cleared).  This is how the allocator models
        decommit cached spans without giving up the address range; under
        ``elide_flushes`` the shootdown is elided exactly like munmap's.
        """
        ctr, c = self.counters, self.cost
        proc = self.process_of(tid)
        self._charge(tid, c.syscall_fixed_ns)
        end_vpn = start_vpn + n_pages
        self._update_range(tid, start_vpn, n_pages, None)
        elide = self.elide_flushes
        for vpn in range(start_vpn, end_vpn):
            entry = proc.oracle.pop(vpn, None)
            if entry is not None:
                ctr.data_pages_freed += 1
                if elide:
                    self._free_frames.append(entry[0])
        if elide:
            self._elide_shootdown(tid, start_vpn, end_vpn)
        else:
            # tables stay resident (their sharer masks too), so the
            # touched-table list is recomputed from the same range formula
            t0, t1 = leaf_id(start_vpn), leaf_id(end_vpn - 1)
            touched = [ti for ti in range(t0, t1 + 1)
                       if proc.store.get(ti) is not None]
            self._shootdown(tid, start_vpn, end_vpn, touched)

    # ----------------------------------------------------- flush elision
    def _elide_shootdown(self, tid: int, start_vpn: int,
                         end_vpn: int) -> None:
        """The lazy-invalidation path of munmap / madvise_dontneed: no IPI
        round.  The initiator still drops its own entries (the local
        invlpg Linux always performs, charged as such); every translation
        another CPU of this process still caches in the range is recorded
        as lazily invalid, to be flushed by ``_force_deferred_flush`` when
        something makes the staleness observable."""
        ctr, c = self.counters, self.cost
        me = self.threads[tid]
        proc = self.processes[me.asid]
        self._charge(tid, c.tlb_invalidate_self_ns)
        ptlbs = self._asid_tlbs[me.asid]
        ptlbs[me.cpu].invalidate_range(start_vpn, end_vpn)
        recorded = 0
        lazy, stale_map = proc.lazy_pages, proc.lazy_stale
        for cpu, tlb in ptlbs.items():
            if cpu == me.cpu:
                continue
            held = tlb.entries_in_range(start_vpn, end_vpn)
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
                self._stale_frame_asid[frame] = me.asid
        ctr.flushes_elided += 1
        ctr.deferred_invalidations += recorded

    def _force_deferred_flush(self, tid: int, proc: Process) -> None:
        """Pay ``proc``'s whole pending deferred shootdown now, charged to
        ``tid``: one precise IPI round to exactly the CPUs recorded as
        still caching marked translations, settled/charged through the
        same contention machinery as an ordinary ``_shootdown`` round.
        Batching is the elision win: any number of elided unmaps collapse
        into this single round."""
        ctr, c = self.counters, self.cost
        me = self.threads[tid]
        my_node = self.topo.node_of_cpu(me.cpu)
        stale_map = proc.lazy_stale
        ptlbs = self._asid_tlbs[proc.asid]
        ctr.forced_flushes += 1
        # the forcing CPU's own stale entries die by local invlpg, no IPI
        mine = stale_map.pop(me.cpu, None)
        if mine:
            tlb = ptlbs.get(me.cpu)
            if tlb is not None:
                for vpn in mine:
                    tlb.invalidate(vpn)
        targets = set(stale_map)
        model = self.contention
        if targets and model is not None and model.ipi_free:
            # hardware coherence: the forced flush is still one precise
            # round, but it sends no IPIs — each recorded CPU drops
            # exactly its stale vpns and pays per line actually present.
            ctr.shootdown_rounds += 1
            self._charge(tid, c.tlb_invalidate_self_ns)
            line_costs: Dict[int, float] = {}
            for cpu in sorted(targets):
                tlb = ptlbs.get(cpu)
                lines = 0
                if tlb is not None:
                    for vpn in stale_map[cpu]:
                        lines += tlb.invalidate(vpn)
                if not lines:
                    continue
                hops = self.topo.hops(my_node, self.topo.node_of_cpu(cpu))
                cost_cpu = model.line_cost_ns(lines, hops)
                ctr.hw_line_invalidations += lines
                ctr.hw_invalidation_ns += cost_cpu
                line_costs[cpu] = cost_cpu
            self._hw_charge_lines(me, line_costs)
        elif targets:
            n_local = sum(1 for cpu in targets
                          if self.topo.node_of_cpu(cpu) == my_node)
            n_remote = len(targets) - n_local
            ctr.shootdown_rounds += 1
            ctr.ipis_local += n_local
            ctr.ipis_remote += n_remote
            base = (c.shootdown_cost_ns(n_local, n_remote)
                    + c.tlb_invalidate_self_ns)
            if self.contention is not None:
                s = self._settle_contended(me, targets, c)
                ctr.ipi_queue_delay_ns += s.queued_ns
                ctr.overlapping_rounds += s.contended
                ctr.ipis_coalesced += len(s.coalesced_cpus)
                ctr.responder_delay_ns += s.responder_delay_ns
                self._charge(tid, base)
                if s.extra_wait_ns:
                    self._charge(tid, s.extra_wait_ns)
                for cpu in targets:
                    tlb = ptlbs.get(cpu)
                    if tlb is not None:
                        for vpn in stale_map[cpu]:
                            tlb.invalidate(vpn)
                charge_responders(
                    s, self.contention.handler_ns, targets,
                    self._cpu_threads,
                    lambda thr: thr.time_ns,
                    lambda thr, v: setattr(thr, "time_ns", v))
            else:
                self._charge(tid, base)
                for cpu in targets:
                    tlb = ptlbs.get(cpu)
                    if tlb is not None:
                        for vpn in stale_map[cpu]:
                            tlb.invalidate(vpn)
                    for t in self._cpu_threads.get(cpu, ()):
                        t.time_ns += IPI_RECEIVE_NS
                        t.ipis_received += 1
        elif mine:
            self._charge(tid, c.tlb_invalidate_self_ns)
        pop_frame = self._stale_frame_asid.pop
        for frame in proc.lazy_pages.values():
            pop_frame(frame, None)
        proc.lazy_pages.clear()
        stale_map.clear()

    def _carve_vmas(self, proc: Process, start: int, end: int) -> None:
        out: List[VMA] = []
        for vma in proc.vmas:
            if vma.end_vpn <= start or vma.start_vpn >= end:
                out.append(vma)
                continue
            if vma.start_vpn < start:
                out.append(dataclasses.replace(vma, end_vpn=start))
            if vma.end_vpn > end:
                out.append(dataclasses.replace(vma, start_vpn=end))
        proc.vmas = out

    def _update_range(self, tid: int, start_vpn: int, n_pages: int,
                      fn) -> List[int]:
        """Apply fn (None = clear) to every present PTE in range, in the
        canonical copy and per-policy replicas.  Returns touched table ids."""
        ctr, c = self.counters, self.cost
        store = self.process_of(tid).store
        node = self.thread_node(tid)
        end_vpn = start_vpn + n_pages
        touched: List[int] = []
        t0 = leaf_id(start_vpn)
        t1 = leaf_id(end_vpn - 1)
        for tbl_id in range(t0, t1 + 1):
            table = store.get(tbl_id)
            if table is None:
                continue
            touched.append(tbl_id)
            lo = max(start_vpn, leaf_base_vpn(tbl_id))
            hi = min(end_vpn, leaf_base_vpn(tbl_id) + PTES_PER_TABLE)
            targets = self._coherence_targets(table)
            for copy_node in targets:
                copy = table.copies.get(copy_node)
                if copy is None:
                    continue
                wrote = 0
                for vpn in range(lo, hi):
                    i = leaf_index(vpn)
                    if i in copy:
                        if fn is None:
                            del copy[i]
                        else:
                            copy[i] = fn(copy[i])
                        wrote += 1
                if wrote:
                    if copy_node == node:
                        ctr.replica_writes_local += wrote
                        self._charge(tid, c.pte_write_local_ns * wrote)
                    else:
                        ctr.replica_writes_remote += wrote
                        self._charge(tid, c.pte_write_remote_ns * wrote)
        return touched

    def _coherence_targets(self, table: LeafTable) -> List[int]:
        if self.policy is Policy.LINUX:
            return [table.owner]
        if self.policy is Policy.MITOSIS:
            return list(range(self.topo.n_nodes))
        return table.sharer_nodes()      # NUMAPTE: sharers only

    # ------------------------------------------------------------ shootdowns
    def _shootdown(self, tid: int, start_vpn: int, end_vpn: int,
                   touched_tables: Sequence[int]) -> None:
        """IPI round for a PTE-range change, with numaPTE's sharer filter.

        Fan-out is per-process: the unfiltered (Linux) target set is the
        initiating process's ``mm_cpumask`` — so on shared CPUs the IPIs
        interrupt *every* resident thread, other tenants' included (the
        charging loops below walk ``_cpu_threads``, which is machine-global
        on purpose) — while numaPTE's sharer filter cuts it down to nodes
        that actually cached this process's tables.
        """
        ctr, c = self.counters, self.cost
        me = self.threads[tid]
        proc = self.processes[me.asid]
        my_node = self.topo.node_of_cpu(me.cpu)
        # cores that currently run a thread of this process (mm_cpumask)
        running_cpus = proc.cpus()
        if self.tlb_filter:
            allowed_nodes = 0
            for tbl_id in touched_tables:
                table = proc.store.get(tbl_id)
                if table is not None:
                    allowed_nodes |= table.sharers
            targets = {cpu for cpu in running_cpus
                       if (allowed_nodes >> self.topo.node_of_cpu(cpu)) & 1}
        else:
            targets = set(running_cpus)
        targets.discard(me.cpu)
        filtered = len(running_cpus - {me.cpu}) - len(targets)
        ctr.ipis_filtered += filtered
        model = self.contention
        if model is not None and model.ipi_free:
            # hardware TLB coherence: no IPIs dispatched, no handlers, no
            # ack wait — per-line invalidation messages only.
            ctr.shootdown_rounds += 1
            self._hw_shootdown(me, targets, start_vpn, end_vpn, model)
            return
        n_local = sum(1 for cpu in targets
                      if self.topo.node_of_cpu(cpu) == my_node)
        n_remote = len(targets) - n_local
        ctr.shootdown_rounds += 1
        ctr.ipis_local += n_local
        ctr.ipis_remote += n_remote
        base = c.shootdown_cost_ns(n_local, n_remote) + c.tlb_invalidate_self_ns
        if self.contention is not None and targets:
            # overlapping-round settlement: the round starts now (me.time_ns,
            # before the dispatch/ack charge); the initiator's synchronous
            # wait stretches by the slowest target's receive-queue delay,
            # and responders settle two-sided (handler occupancy from the
            # model + per-CPU stretch: queue delay and mid-shootdown
            # ack-horizon extensions; coalesced IPIs skip the handler).
            s = self._settle_contended(me, targets, c)
            ctr.ipi_queue_delay_ns += s.queued_ns
            ctr.overlapping_rounds += s.contended
            ctr.ipis_coalesced += len(s.coalesced_cpus)
            ctr.responder_delay_ns += s.responder_delay_ns
            self._charge(tid, base)
            if s.extra_wait_ns:
                self._charge(tid, s.extra_wait_ns)
            ptlbs = self._asid_tlbs[me.asid]
            ptlbs[me.cpu].invalidate_range(start_vpn, end_vpn)
            for cpu in targets:
                ptlbs[cpu].invalidate_range(start_vpn, end_vpn)
            charge_responders(
                s, self.contention.handler_ns, targets, self._cpu_threads,
                lambda thr: thr.time_ns,
                lambda thr, v: setattr(thr, "time_ns", v))
            return
        self._charge(tid, base)
        # apply invalidations on targets (and self): tag-selective — only
        # the initiating process's ASID partition drops entries
        ptlbs = self._asid_tlbs[me.asid]
        ptlbs[me.cpu].invalidate_range(start_vpn, end_vpn)
        for cpu in targets:
            ptlbs[cpu].invalidate_range(start_vpn, end_vpn)
            for t in self._cpu_threads.get(cpu, ()):
                t.time_ns += IPI_RECEIVE_NS
                t.ipis_received += 1

    def _hw_shootdown(self, me: Thread, targets, start_vpn: int,
                      end_vpn: int, model) -> None:
        """Settle one round under hardware TLB coherence (``ipi_free``).

        The initiator pays only its own local invalidation — its cost is
        independent of fan-out.  Each target CPU's partition drops its
        stale entries; CPUs that actually held lines are charged the
        per-line cost (scaled by NUMA hop distance), accumulated and
        delivered in sorted-CPU order so every engine produces the
        identical float sequence.  Zero-line CPUs are skipped entirely,
        which is what makes the batch/trace relevance filters (which
        never even visit provably-line-free CPUs) structurally
        equivalent to this full scan.
        """
        ctr, c = self.counters, self.cost
        topo = self.topo
        my_node = topo.node_of_cpu(me.cpu)
        self._charge(me.tid, c.tlb_invalidate_self_ns)
        ptlbs = self._asid_tlbs[me.asid]
        ptlbs[me.cpu].invalidate_range(start_vpn, end_vpn)
        line_costs: Dict[int, float] = {}
        for cpu in sorted(targets):
            lines = ptlbs[cpu].invalidate_range(start_vpn, end_vpn)
            if not lines:
                continue
            hops = topo.hops(my_node, topo.node_of_cpu(cpu))
            cost_cpu = model.line_cost_ns(lines, hops)
            ctr.hw_line_invalidations += lines
            ctr.hw_invalidation_ns += cost_cpu
            line_costs[cpu] = cost_cpu
        self._hw_charge_lines(me, line_costs)

    def _hw_charge_lines(self, me: Thread, line_costs) -> None:
        """Deliver per-target hardware line charges through the shared
        two-sided helper: zero handler, no ``ipis_received``, and only
        threads of the initiating address space stall."""
        if line_costs:
            charge_responders(
                RoundSettlement(target_stretch=line_costs), 0.0,
                sorted(line_costs), self._cpu_threads,
                lambda thr: thr.time_ns,
                lambda thr, v: setattr(thr, "time_ns", v),
                count_ipis=False, asid=me.asid)

    def _settle_contended(self, me: Thread, targets, c):
        """Settle one contended round through the configured engine: the
        vectorized array math (bit-identical; repro_torch.core.shootdown_batch)
        for the stock models, or the model's own scalar loop."""
        model = self.contention
        if self.settle_engine != "sequential":
            if supports_vector(model):
                return settle_round(model, me.time_ns, me.cpu, targets,
                                    self.topo.node_of_cpu, c,
                                    hw_per_node=self.topo.hw_threads_per_node)
            if self.settle_engine == "vector":
                raise ValueError("settle_engine='vector' requires a stock "
                                 "QueueContention/CoalescingContention "
                                 f"model, got {type(model).__name__}")
        return model.settle(me.time_ns, me.cpu, targets,
                            self.topo.node_of_cpu, c)

    # ------------------------------------------------------------ migration
    def migrate_thread(self, tid: int, new_cpu: int) -> None:
        self.topo.validate_cpu(new_cpu)
        thr = self.threads[tid]
        proc = self.processes[thr.asid]
        old_cpu = thr.cpu
        thr.cpu = new_cpu
        self._cpu_threads[old_cpu].remove(thr)
        self._cpu_threads.setdefault(new_cpu, []).append(thr)
        self.tlb_partition(new_cpu, thr.asid)
        # Entries are ASID-tagged, so the context switch itself flushes
        # nothing for the processes staying resident (the PCID win); we
        # conservatively drop *this* process's partition once its last
        # thread leaves the cpu (its tags won't be refreshed there).
        if all(t.cpu != old_cpu for t in proc.threads.values()):
            self._asid_tlbs[thr.asid][old_cpu].flush()

    # ------------------------------------------------------------ reporting
    def total_time_ns(self) -> float:
        return sum(t.time_ns for t in self.threads.values())

    def thread_time_ns(self, tid: int) -> float:
        return self.threads[tid].time_ns

    def pt_footprint_bytes(self) -> int:
        return sum(p.store.footprint_bytes() for p in self.processes.values())

    # ----------------------------------------------------------- validation
    def check_invariants(self) -> None:
        """Raise AssertionError if any paper invariant is violated.

        Every invariant is checked per address space: a (cpu, asid) TLB
        partition is validated against *its own* process's page tables and
        oracle, which is also the cross-process isolation property — a
        partition tagged with ASID a can never satisfy I3/I4 from another
        process's mappings.

        Under ``elide_flushes`` I4 is relaxed exactly as far as the
        mechanism needs and no further: a TLB entry for an unmapped vpn is
        legal iff it is a *recorded* lazy invalidation (the vpn is marked
        in its process's ``lazy_pages`` with the very frame the entry
        translates to, on a CPU listed in ``lazy_stale``) and the stale
        frame is not currently mapped by any *other* process — so a stale
        translation can never be served across process boundaries.
        """
        lazy_any = any(p.lazy_pages for p in self.processes.values())
        live_frames: Dict[int, int] = {}
        if lazy_any:
            for p in self.processes.values():
                for frame, _perms in p.oracle.values():
                    live_frames[frame] = p.asid
            for p in self.processes.values():
                for vpn in p.lazy_pages:
                    assert vpn not in p.oracle, \
                        f"marked vpn {vpn} is mapped (asid {p.asid}): the " \
                        "deferred flush should have been forced on remap"
        for proc in self.processes.values():
            for table in proc.store.tables.values():
                owner_copy = table.copies.get(table.owner, {})
                for node, copy in table.copies.items():
                    assert table.is_sharer(node), \
                        f"node {node} holds copy of T{table.tid} but not a sharer"
                    if self.policy is Policy.NUMAPTE and node != table.owner:
                        for i, pte in copy.items():
                            assert i in owner_copy, \
                                f"I1 violated: T{table.tid}[{i}] on {node} not on owner"
                            o = owner_copy[i]
                            assert (pte.frame, pte.perms) == (o.frame, o.perms), \
                                f"replica divergence at T{table.tid}[{i}]"
        for asid, parts in self._asid_tlbs.items():
            proc = self.processes[asid]
            for cpu, tlb in parts.items():
                assert tlb.asid == asid, \
                    f"partition ({cpu}, {asid}) tagged {tlb.asid}"
                node = self.topo.node_of_cpu(cpu)
                for vpn in tlb.vpns():
                    lazy_frame = proc.lazy_pages.get(vpn) if lazy_any \
                        else None
                    if lazy_frame is not None:
                        # a sanctioned stale entry: recorded, frame-exact,
                        # and its frame is not live in another process
                        frame = tlb.lookup(vpn)[0]
                        assert frame == lazy_frame, \
                            f"stale entry vpn {vpn} on cpu {cpu} " \
                            f"translates to {frame}, recorded {lazy_frame}"
                        assert vpn in proc.lazy_stale.get(cpu, ()), \
                            f"unrecorded stale entry vpn {vpn} on cpu " \
                            f"{cpu} (asid {asid})"
                        owner = live_frames.get(frame)
                        assert owner is None or owner == asid, \
                            f"cross-process stale translation: cpu {cpu} " \
                            f"asid {asid} caches vpn {vpn} -> frame " \
                            f"{frame}, now mapped by asid {owner}"
                        continue
                    table = proc.store.get(leaf_id(vpn))
                    assert table is not None, \
                        f"I4: TLB holds unmapped vpn {vpn} (asid {asid})"
                    if self.policy is not Policy.LINUX:
                        assert table.is_sharer(node), \
                            f"I2 violated: cpu {cpu} caches vpn {vpn}, node {node}" \
                            f" not in sharers of T{table.tid} (asid {asid})"
                    frame, perms = tlb.lookup(vpn)
                    assert vpn in proc.oracle, \
                        f"I4: stale TLB for freed vpn {vpn} (asid {asid})"
                    assert proc.oracle[vpn][0] == frame, \
                        f"I3: wrong frame {vpn} (asid {asid})"
