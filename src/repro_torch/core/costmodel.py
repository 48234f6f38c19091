"""Latency cost model for the NUMA page-table simulator.

The simulator is *exact* in its event counts (TLB misses, page-table walks,
replica updates, IPIs sent, bytes replicated); this module converts those
counts into modeled nanoseconds so benchmark output is comparable to the
paper's wall-clock figures.  Constants are calibrated against the paper's
published ratios on the 8-socket Xeon E7-8890 v3 testbed:

  * Fig 1:  mprotect(4KB) degrades ~40x on Linux v4.17 when all 8 sockets run
    spinning threads; numaPTE+TLB-opt stays ~flat.
  * Fig 1:  Mitosis costs ~25% extra on mprotect with zero spinners
    (7 remote replica updates).
  * Fig 10: munmap(4KB) on Mitosis degrades ~30x at max spinners; numaPTE
    with TLB-opt lands at ~2.6x (local-socket shootdowns + PT teardown).
  * Sec 2.1: page walks cost several hundred cycles (~hundreds of ns); remote
    PT walks are ~4x local DRAM latency on this class of machine.

Every constant below is a knob; `CostModel.paper_default()` is the calibrated
set used by benchmarks/.  Benchmarks always print raw counters next to the
modeled time, so conclusions never rest on the calibration alone.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostModel:
    # -- memory hierarchy ---------------------------------------------------
    tlb_hit_ns: float = 0.0          # folded into the memory access itself
    local_mem_ns: float = 90.0       # local DRAM access (one PT level read)
    remote_mem_ns: float = 360.0     # cross-socket DRAM access (QPI hop)
    interference_mult: float = 2.6   # extra penalty when interconnect is busy
    pwc_hit_levels: int = 3          # page-walk-cache covers upper 3 levels;
                                     # a leaf-hit walk costs 1 memory access

    # -- fault / syscall fixed costs ----------------------------------------
    fault_fixed_ns: float = 550.0    # kernel entry + VMA lookup on a miss
    syscall_fixed_ns: float = 480.0  # mprotect/mmap/munmap entry/exit + locks
    page_alloc_ns: float = 320.0     # buddy/zeroing amortized per 4KB page
    pt_alloc_ns: float = 260.0       # allocate+zero one page-table page
    pt_teardown_ns: float = 30.0     # free one PT page (freelist push; the
                                     # paper's Mitosis munmap overhead at 0
                                     # spinners is only ~23%)
    mmap_extra_ns: float = 900.0     # extra mmap bookkeeping (rbtree, etc.)

    # -- PTE writes / replica coherence --------------------------------------
    pte_write_local_ns: float = 18.0    # store to local PT
    pte_write_remote_ns: float = 23.0   # posted store to a remote replica
    pte_copy_remote_ns: float = 120.0   # read one PTE from a remote owner
    pte_copy_stream_ns: float = 3.0     # each additional prefetched PTE
                                        # (streamed from the same PT page)

    # -- TLB shootdowns ------------------------------------------------------
    # An IPI round is: dispatch to each target core + one synchronous wait
    # for the slowest ack.  Same-socket dispatch uses cluster-mode x2APIC
    # multicast and is much cheaper than cross-socket dispatch.
    ipi_dispatch_local_ns: float = 16.0    # per target core, same socket
    ipi_dispatch_remote_ns: float = 95.0   # per target core, remote socket
    ipi_ack_wait_local_ns: float = 300.0   # flat wait if any local target
    ipi_ack_wait_remote_ns: float = 900.0  # flat wait if any remote target
    tlb_invalidate_self_ns: float = 140.0  # invlpg on the initiating core

    # -- derived helpers -----------------------------------------------------
    def walk_cost_ns(self, *, local: bool, interference: bool = False,
                     levels: int = 1) -> float:
        per = self.local_mem_ns if local else self.remote_mem_ns
        if interference and not local:
            per *= self.interference_mult
        return per * levels

    def shootdown_cost_ns(self, n_local: int, n_remote: int) -> float:
        """Cost charged to the *initiating* core for one IPI round."""
        if n_local == 0 and n_remote == 0:
            return 0.0
        cost = (n_local * self.ipi_dispatch_local_ns
                + n_remote * self.ipi_dispatch_remote_ns)
        if n_remote:
            cost += self.ipi_ack_wait_remote_ns
        elif n_local:
            cost += self.ipi_ack_wait_local_ns
        return cost

    @staticmethod
    def paper_default() -> "CostModel":
        return CostModel()

    @staticmethod
    def zero() -> "CostModel":
        """All-zero cost model: useful for pure counter-based tests."""
        return CostModel(**{f.name: 0 if isinstance(getattr(CostModel(), f.name), (int, float)) else getattr(CostModel(), f.name)
                            for f in dataclasses.fields(CostModel)})
