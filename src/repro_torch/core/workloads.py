"""Workload models for the paper's application benchmarks.

Each application from Table 3 is modeled as (a) a *loading phase* that mmaps
and first-touches its dataset from designated sockets (exercising page-table
UPDATEs), and (b) an *execution phase* issuing a memory-access stream with
the application's cross-socket sharing profile (exercising page-table READs).

The sharing profile is the knob that determines everything the paper
measures: per-region we declare which sockets access it, so the numaPTE
replica footprint (Table 4), the Linux remote-walk fraction and the
Mitosis/numaPTE speedups (Fig 8) all *emerge* from the protocol rather than
being hard-coded.  Profiles are tuned to reproduce Table 4's footprints:

  workload   paper footprint vs Linux   profile (frac of pages x sharers)
  graph500   2.2x                        0.65 private, 0.20 pair, 0.15 all
  btree      2.0x                        0.70 private, 0.20 pair, 0.10 all
  hashjoin   1.4x                        0.90 private, 0.05 pair, 0.05 all
  xsbench    7.8x (converges to Mitosis) 0.04 private, 0.96 all
  canneal    1.45x                       0.85 private, 0.10 pair, 0.05 all

Datasets are scaled by ``pages_per_gb`` (default 256 = 1MB of simulated
pages per GB of the paper's dataset) so the whole suite runs in seconds
while keeping the page/TLB-reach ratio large.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .config import SimConfig, _UNSET, _warn_deprecated
from .pagetable import PERM_R, PERM_RW, PTES_PER_TABLE, Policy
from .sim import NumaSim

PAGES_PER_GB_DEFAULT = 256


def _resolve_engine(sim: NumaSim, engine, fn: str) -> str:
    """Engine for a workload phase: the sim's ``SimConfig.engine`` unless
    the (deprecated) per-call kwarg overrides it."""
    if engine is _UNSET:
        return sim.config.engine
    _warn_deprecated(f"{fn}(engine=...)", "SimConfig(engine=...)")
    return engine


def _apply_engine(sim: NumaSim, ops, engine: str) -> list:
    """apply_mm_ops with an already-resolved engine (no deprecation shim)."""
    from .mm_batch import _apply_resolved
    return _apply_resolved(sim, ops, engine, sim.config.concurrency,
                           None, sim.config.settle)


@dataclasses.dataclass(frozen=True)
class AppSpec:
    name: str
    dataset_gb: float
    frac_private: float
    frac_pair: float
    frac_all: float
    read_frac: float = 1.0
    loader: str = "partitioned"   # 'partitioned' | 'node0'

    def region_fracs(self) -> Dict[str, float]:
        return {"private": self.frac_private, "pair": self.frac_pair,
                "all": self.frac_all}


APPS: Dict[str, AppSpec] = {
    "graph500": AppSpec("graph500", 160, 0.65, 0.20, 0.15, read_frac=0.95),
    "btree":    AppSpec("btree",    110, 0.70, 0.20, 0.10),
    "hashjoin": AppSpec("hashjoin", 145, 0.90, 0.05, 0.05),
    "xsbench":  AppSpec("xsbench",   85, 0.04, 0.00, 0.96),
    "canneal":  AppSpec("canneal",  110, 0.85, 0.10, 0.05, read_frac=0.9),
}


def _round_tables(pages: int) -> int:
    """Round a region size up to whole leaf tables so sharing is
    table-aligned (real allocators cluster related data; mis-aligned regions
    would charge numaPTE for false table sharing)."""
    return max(PTES_PER_TABLE,
               -(-pages // PTES_PER_TABLE) * PTES_PER_TABLE)


@dataclasses.dataclass
class Region:
    start_vpn: int
    n_pages: int
    kind: str          # 'private' | 'pair' | 'all'
    home_node: int     # owning/loading node


@dataclasses.dataclass
class AppLayout:
    spec: AppSpec
    regions: List[Region]
    threads: Dict[int, int]        # node -> tid (one worker per node)
    total_pages: int

    def regions_of(self, kind: str) -> List[Region]:
        return [r for r in self.regions if r.kind == kind]


def build_app(sim: NumaSim, spec: AppSpec, *,
              pages_per_gb: int = PAGES_PER_GB_DEFAULT,
              touch_stride: int = 1,
              engine=_UNSET,
              process=None) -> Tuple[AppLayout, float]:
    """mmap + first-touch the dataset (the paper's loading phase).

    Returns (layout, loading_time_ns) where loading time is the sum of the
    loading threads' modeled time for this phase.  The engine comes from
    ``sim.config.engine``: ``"batch"`` runs the first-touch streams through
    the vectorized engine (byte-identical counters/times); ``"scalar"``
    keeps the per-page reference loop.  ``process`` spawns the app's
    workers in that address space (a tenant); default is the sim's
    ASID-0 process.
    """
    engine = _resolve_engine(sim, engine, "build_app")
    n_nodes = sim.topo.n_nodes
    threads = {node: sim.spawn_thread(node * sim.topo.hw_threads_per_node,
                                      process=process)
               for node in range(n_nodes)}
    total_pages = int(spec.dataset_gb * pages_per_gb)
    t_before = {n: sim.thread_time_ns(t) for n, t in threads.items()}

    regions: List[Region] = []
    per_node_priv = _round_tables(
        int(total_pages * spec.frac_private / n_nodes))
    per_node_pair = _round_tables(int(total_pages * spec.frac_pair / n_nodes)) \
        if spec.frac_pair > 0 else 0
    all_pages = _round_tables(int(total_pages * spec.frac_all)) \
        if spec.frac_all > 0 else 0

    for node in range(n_nodes):
        tid = threads[node]
        if per_node_priv:
            vma = sim.mmap(tid, per_node_priv)
            regions.append(Region(vma.start_vpn, per_node_priv, "private", node))
        if per_node_pair:
            vma = sim.mmap(tid, per_node_pair)
            regions.append(Region(vma.start_vpn, per_node_pair, "pair", node))
    if all_pages:
        loader = threads[0]
        vma = sim.mmap(loader, all_pages)
        regions.append(Region(vma.start_vpn, all_pages, "all", 0))

    # first-touch everything from the home node (populates page tables)
    for region in regions:
        if spec.loader == "partitioned" or region.kind != "all":
            tid = threads[region.home_node]
        else:  # 'node0' loads even shared data
            tid = threads[0]
        if engine != "scalar":   # batch/trace: touches ride the array engine
            sim.touch_batch(tid, np.arange(
                region.start_vpn, region.start_vpn + region.n_pages,
                touch_stride, dtype=np.int64), write_mask=True)
        else:
            for vpn in range(region.start_vpn,
                             region.start_vpn + region.n_pages, touch_stride):
                sim.touch(tid, vpn, write=True)

    loading_ns = sum(sim.thread_time_ns(t) - t_before[n]
                     for n, t in threads.items())
    return AppLayout(spec, regions, threads, total_pages), loading_ns


def _exec_stream_vpns(kinds, kind_draw, offs, node, n_nodes,
                      priv, pair, shared):
    """Vectorized replica of the scalar region-selection logic below: the
    produced vpn sequence is element-for-element identical.  Returns None
    for layouts the closed form does not cover (caller falls back)."""
    vpns = np.empty(offs.size, dtype=np.int64)
    for k_i, kind in enumerate(kinds):
        m = kind_draw == k_i
        if not m.any():
            continue
        o = offs[m]
        if kind == "private":
            r = priv[node]
            vpns[m] = r.start_vpn + (o * r.n_pages).astype(np.int64) % r.n_pages
        elif kind == "pair":
            nxt = (node + 1) % n_nodes
            if node not in pair or nxt not in pair:
                return None
            own, nb = pair[node], pair[nxt]
            # accesses alternate between own and neighbour's pair region
            alt = ((o * 1024).astype(np.int64) & 1).astype(bool)
            start = np.where(alt, nb.start_vpn, own.start_vpn)
            npag = np.where(alt, nb.n_pages, own.n_pages)
            vpns[m] = start + (o * npag).astype(np.int64) % npag
        else:
            n_sh = len(shared)
            s_idx = (o * n_sh).astype(np.int64) % n_sh
            starts = np.array([r.start_vpn for r in shared],
                              dtype=np.int64)[s_idx]
            npag = np.array([r.n_pages for r in shared],
                            dtype=np.int64)[s_idx]
            vpns[m] = starts + (o * npag).astype(np.int64) % npag
    return vpns


def run_exec_phase(sim: NumaSim, layout: AppLayout, *,
                   accesses_per_thread: int = 50_000,
                   seed: int = 0,
                   engine=_UNSET) -> float:
    """Execution phase: every node's worker issues an access stream with the
    app's sharing profile.  Returns summed modeled thread time (ns).

    The stream (rng draws and region selection) is identical under both
    engines (``sim.config.engine``); ``"batch"`` assembles it as one array
    per thread and runs it through ``NumaSim.touch_batch``, which is
    differentially tested to be byte-identical to the scalar loop."""
    engine = _resolve_engine(sim, engine, "run_exec_phase")
    spec = layout.spec
    rng = np.random.default_rng(seed)
    n_nodes = sim.topo.n_nodes
    fracs = spec.region_fracs()
    kinds = [k for k, f in fracs.items() if f > 0]
    probs = np.array([fracs[k] for k in kinds])
    probs = probs / probs.sum()

    priv = {r.home_node: r for r in layout.regions_of("private")}
    pair = {r.home_node: r for r in layout.regions_of("pair")}
    shared = layout.regions_of("all")

    t_before = {n: sim.thread_time_ns(t) for n, t in layout.threads.items()}
    for node, tid in layout.threads.items():
        kind_draw = rng.choice(len(kinds), size=accesses_per_thread, p=probs)
        offs = rng.random(accesses_per_thread)
        writes = rng.random(accesses_per_thread) >= spec.read_frac
        vpns = None
        if engine != "scalar":   # batch/trace: touches ride the array engine
            vpns = _exec_stream_vpns(kinds, kind_draw, offs, node, n_nodes,
                                     priv, pair, shared)
        if vpns is not None:
            sim.touch_batch(tid, vpns, writes)
            continue
        for k_i, off, wr in zip(kind_draw, offs, writes):
            kind = kinds[k_i]
            if kind == "private":
                region = priv[node]
            elif kind == "pair":
                # a pair region is shared between its home node and the next
                region = pair[node] if node in pair else pair[(node - 1) % n_nodes]
                if off > 0.5 and (node + 1) % n_nodes in pair:
                    region = pair[node]
                # accesses alternate between own and neighbour's pair region
                if int(off * 1024) & 1:
                    region = pair[(node + 1) % n_nodes] if (node + 1) % n_nodes in pair else region
            else:
                region = shared[int(off * len(shared)) % len(shared)]
            vpn = region.start_vpn + int(off * region.n_pages) % region.n_pages
            sim.touch(tid, vpn, write=bool(wr))
    return sum(sim.thread_time_ns(t) - t_before[n]
               for n, t in layout.threads.items())


def _regions_by_worker(layout: AppLayout) -> Dict[int, List[Region]]:
    """Each node's worker handles its own private/pair regions; node 0's
    worker handles the shared regions (it loaded them)."""
    per: Dict[int, List[Region]] = {node: [] for node in layout.threads}
    for region in layout.regions:
        per[region.home_node if region.kind != "all" else 0].append(region)
    return per


def run_mprotect_phase(sim: NumaSim, layout: AppLayout, *,
                       engine=_UNSET) -> float:
    """Protection pass over the whole dataset (a GC / COW-checkpoint
    analogue): every worker write-protects the regions it owns, then
    restores them — two full-range mprotects per region, exercising the
    replica-coherence UPDATE path the paper's Figs 1/9 measure.  Returns
    summed modeled thread time (ns).  ``engine="batch"`` runs on
    ``NumaSim.mprotect_batch`` (byte-identical to ``engine="scalar"``)."""
    engine = _resolve_engine(sim, engine, "run_mprotect_phase")
    t_before = {n: sim.thread_time_ns(t) for n, t in layout.threads.items()}
    for node, regions in _regions_by_worker(layout).items():
        tid = layout.threads[node]
        ops = [("mprotect", tid, r.start_vpn, r.n_pages, perms)
               for r in regions
               for perms in (PERM_R, PERM_RW)]
        _apply_engine(sim, ops, engine)
    return sum(sim.thread_time_ns(t) - t_before[n]
               for n, t in layout.threads.items())


def run_teardown_phase(sim: NumaSim, layout: AppLayout, *,
                       engine=_UNSET) -> float:
    """Exit-time teardown: every worker munmaps the regions it owns
    (the paper's munmap / page-table-teardown path, Figs 9/10).  Returns
    summed modeled thread time (ns)."""
    engine = _resolve_engine(sim, engine, "run_teardown_phase")
    t_before = {n: sim.thread_time_ns(t) for n, t in layout.threads.items()}
    for node, regions in _regions_by_worker(layout).items():
        tid = layout.threads[node]
        _apply_engine(sim, [("munmap", tid, r.start_vpn, r.n_pages)
                            for r in regions], engine)
    return sum(sim.thread_time_ns(t) - t_before[n]
               for n, t in layout.threads.items())


def run_app(policy: Policy, spec: AppSpec, topo, *,
            prefetch_degree: int = 9,
            tlb_filter: bool = True,
            pages_per_gb: int = PAGES_PER_GB_DEFAULT,
            accesses_per_thread: int = 50_000,
            touch_stride: int = 1,
            seed: int = 0,
            engine=_UNSET,
            mm_phases: bool = False,
            config: "SimConfig" = None):
    """Build + run one app under one policy.  Returns a result dict.

    Simulator knobs come from ``config`` (a :class:`SimConfig`; its
    ``policy`` field is overridden by the positional ``policy``); when
    omitted, one is built from ``prefetch_degree``/``tlb_filter``.  The
    per-call ``engine=`` kwarg is deprecated — set
    ``SimConfig(engine=...)`` instead.

    ``mm_phases=True`` appends the memory-management phases (a full
    mprotect protection pass, then exit-time munmap teardown) after the
    execution phase, adding ``mprotect_ns`` / ``teardown_ns`` to the
    result; page-table footprints are recorded before teardown."""
    cfg = config if config is not None else \
        SimConfig(prefetch_degree=prefetch_degree, tlb_filter=tlb_filter)
    cfg = cfg.replace(policy=policy)
    if engine is not _UNSET:
        _warn_deprecated("run_app(engine=...)", "SimConfig(engine=...)")
        cfg = cfg.replace(engine=engine)
    sim = NumaSim(topo, config=cfg)
    layout, loading_ns = build_app(sim, spec, pages_per_gb=pages_per_gb,
                                   touch_stride=touch_stride)
    exec_ns = run_exec_phase(sim, layout,
                             accesses_per_thread=accesses_per_thread,
                             seed=seed)
    result = {
        "app": spec.name,
        "policy": sim.policy.value,
        "loading_ns": loading_ns,
        "exec_ns": exec_ns,
    }
    if mm_phases:
        result["mprotect_ns"] = run_mprotect_phase(sim, layout)
    result["pt_bytes"] = sim.pt_footprint_bytes()
    result["pt_bytes_single"] = sim.store.footprint_bytes_single_copy()
    if mm_phases:
        result["teardown_ns"] = run_teardown_phase(sim, layout)
    result["dataset_bytes"] = layout.total_pages * 4096
    result["counters"] = dataclasses.asdict(sim.counters)
    return result
