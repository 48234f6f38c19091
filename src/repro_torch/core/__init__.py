"""numaPTE core: the paper's page-table management mechanism.

Two cooperating implementations live here:

  * an exact protocol simulator (``NumaSim``) reproducing the paper's OS
    mechanism — lazy/partial page-table replication, owner-based coherence,
    sharer-filtered TLB shootdowns, degree-d PTE prefetch — used by every
    paper figure/table benchmark and by the hypothesis invariant tests;
  * the device-resident analogue for pods lives in ``repro_torch.pagedpt``
    (block tables with per-pod replicas and sharer masks) and is consumed by
    the serving runtime and the paged-attention kernel.
"""
from .batch import access_stream, group_by_leaf, touch_batch
from .config import ENGINES, POLICIES, SimConfig, make_sim
from .costmodel import CostModel
from .malloc import MallocModel, gamma_sizes_pages
from .mm_batch import apply_mm_ops, mmap_batch, mprotect_batch, munmap_batch
from .pagetable import (PERM_R, PERM_RW, PERM_W, PERM_X, PTES_PER_TABLE,
                        LeafTable, PageTableStore, Policy, VMA, leaf_id,
                        leaf_index)
from .shootdown import (CONTENTION_MODELS, DEFAULT_OVERLAP_MODEL,
                        IPI_RECEIVE_NS, CoalescingContention,
                        ContentionModel, HardwareCoherence, NullContention,
                        QueueContention, RoundSettlement, make_contention)
from .shootdown_batch import (SETTLE_MODES, BatchSettlement, settle_round,
                              supports_vector)
from .sim import Counters, NumaSim, Process, SegfaultError, Thread
from .tlb import TLB
from .trace import TraceTable, compile_trace, ops_conflict, partition_windows
from .topology import (PAPER_4SOCKET, PAPER_8SOCKET, TPU_2POD, NumaTopology,
                       socket_pair)
from .workloads import (APPS, AppSpec, build_app, run_app, run_exec_phase,
                        run_mprotect_phase, run_teardown_phase)

__all__ = [
    "APPS", "AppSpec", "BatchSettlement", "CONTENTION_MODELS",
    "CoalescingContention", "ContentionModel",
    "CostModel", "Counters", "DEFAULT_OVERLAP_MODEL", "ENGINES",
    "HardwareCoherence",
    "POLICIES", "SimConfig", "make_sim",
    "IPI_RECEIVE_NS", "LeafTable", "MallocModel", "NullContention",
    "QueueContention", "RoundSettlement", "SETTLE_MODES",
    "make_contention", "settle_round", "supports_vector",
    "TraceTable", "access_stream", "compile_trace", "group_by_leaf",
    "ops_conflict", "partition_windows", "touch_batch",
    "apply_mm_ops", "mmap_batch", "mprotect_batch", "munmap_batch",
    "NumaSim", "NumaTopology", "PAPER_4SOCKET", "PAPER_8SOCKET",
    "PERM_R", "PERM_RW", "PERM_W", "PERM_X", "PTES_PER_TABLE",
    "PageTableStore", "Policy", "Process", "SegfaultError", "TLB",
    "TPU_2POD", "Thread",
    "VMA", "build_app", "gamma_sizes_pages", "leaf_id", "leaf_index",
    "run_app", "run_exec_phase", "run_mprotect_phase", "run_teardown_phase",
    "socket_pair",
]
