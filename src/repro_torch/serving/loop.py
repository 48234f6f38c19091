"""Trace-driven closed-loop serving on the NumaSim mm engine.

The missing end-to-end link between the paper's shootdown-contention
mechanism and inference serving: figs 13/14 check the +12% (Webserver) /
+36% (Memcached) runtime claims as modeled-throughput ratios, but an
inference stack experiences shootdowns as *tail latency* — a decode step
is a lockstep barrier over worker threads, so one worker stalled behind
an IPI round (or stretched as a responder) delays every in-flight
request.

Pieces:

* ``poisson_trace`` — open-loop Poisson arrivals with per-request KV
  shapes drawn from a rate-independent stream, so every offered load
  replays identical work and latency curves are comparable across rates;
* ``KVChurnAdapter`` — the reusable churn→``apply_mm_ops`` mapping: a
  request's KV-block lifecycle becomes mm ops in its home worker's
  address space (admit = mmap the table span + touch the prompt blocks +
  mprotect the prefix read-only; decode = touch each newly appended
  block; finish = munmap the span — the shootdown the paper measures);
* ``run_closed_loop`` — the discrete-event request loop: admit arrivals
  into a fixed slot pool, run lockstep decode steps whose mm ops settle
  through one overlap-concurrent ``apply_mm_ops`` batch per step (the
  default ``CoalescingContention`` model), barrier the workers, and
  assemble per-request latency from the modeled thread clocks.

Multi-tenancy: a bystander tenant process keeps one idle thread per
socket co-resident with a serving housekeeping thread, so Linux's
process-wide fan-out interrupts it (the cross-tenant leak the colocation
benchmark measures) while numaPTE's sharer filter mostly spares it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import PAPER_8SOCKET, SimConfig, make_sim
from ..core.pagetable import PERM_R

__all__ = ["KVChurnAdapter", "Request", "SERVING_POLICIES",
           "nominal_capacity_rps", "poisson_trace", "run_closed_loop"]

#: the serving policies the closed loop sweeps: SimConfig overrides on
#: top of the shared overlap + coalescing contention base (an entry may
#: override ``contention`` itself — ``hardware`` settles every shootdown
#: over the IPI-free ``HardwareCoherence`` fabric, the upper bound on
#: what any software scheme can recover)
SERVING_POLICIES: Dict[str, dict] = {
    "linux": dict(policy="linux", tlb_filter=False),
    "mitosis": dict(policy="mitosis", tlb_filter=False),
    "numapte": dict(policy="numapte", tlb_filter=True),
    "numapte+elide": dict(policy="numapte", tlb_filter=True,
                          elide_flushes=True),
    "hardware": dict(policy="numapte", tlb_filter=True,
                     contention="hardware"),
}

#: modeled compute per lockstep decode step (forward pass + sampling);
#: calibrated so the shootdown share of a saturated step reproduces the
#: paper's +12%/+36% runtime band (see benchmarks/serving_closed_loop.py)
STEP_COMPUTE_NS = 18_000.0
#: decode tokens per KV block (one block = one 4KB table page in the sim)
TOKENS_PER_BLOCK = 4


@dataclasses.dataclass(frozen=True)
class Request:
    arrive_ns: float
    prompt_blocks: int
    decode_steps: int

    @property
    def total_blocks(self) -> int:
        return self.prompt_blocks + \
            -(-self.decode_steps // TOKENS_PER_BLOCK)


def poisson_trace(n_requests: int, arrival_rate_rps: float, *,
                  seed: int = 0) -> List[Request]:
    """Open-loop Poisson arrivals.  The KV shapes (prompt/decode lengths)
    come from a second stream keyed only by ``seed``, so sweeping the
    arrival rate replays the same per-request work — latency differences
    across rates are pure queueing + contention."""
    if arrival_rate_rps <= 0:
        raise ValueError("arrival_rate_rps must be positive")
    arrivals = np.random.default_rng(seed)
    shapes = np.random.default_rng(seed + 1)
    gaps_ns = arrivals.exponential(1e9 / arrival_rate_rps, n_requests)
    t = np.cumsum(gaps_ns)
    return [Request(arrive_ns=float(t[i]),
                    prompt_blocks=int(shapes.integers(2, 7)),
                    decode_steps=int(shapes.integers(8, 25)))
            for i in range(n_requests)]


def nominal_capacity_rps(*, n_workers: int = 8, slots_per_worker: int = 4,
                         step_ns: float = STEP_COMPUTE_NS,
                         mean_decode_steps: float = 16.0) -> float:
    """Contention-free request capacity: B slots each busy for the mean
    decode length at one token per ``step_ns``.  Offered loads are swept
    as fractions of this (load factor 1.0 = nominal saturation)."""
    return (n_workers * slots_per_worker) / (mean_decode_steps
                                             * step_ns / 1e9)


class KVChurnAdapter:
    """Map ``PagedKVManager``-shaped block lifecycle events onto mm ops.

    One sequence = one VMA of ``total_blocks`` pages in the serving
    process (the per-sequence block table span).  The adapter only
    *builds* op tuples — the caller batches them through one
    ``apply_mm_ops`` per decode step so concurrent workers' rounds
    overlap and contend."""

    def __init__(self, sim):
        self.sim = sim
        self._vma: Dict[int, Tuple[int, object]] = {}   # seq -> (tid, vma)

    def admit(self, seq_id: int, tid: int, req: Request,
              protect_prefix: bool = True) -> List[tuple]:
        """mmap the table span (scalar: no shootdown), then return the
        prompt-churn ops: write-touch every prompt block and mark the
        shared prefix read-only (the mprotect churn Mitosis pays for)."""
        vma = self.sim.mmap(tid, req.total_blocks)
        self._vma[seq_id] = (tid, vma)
        ops = [("touch", tid,
                [vma.start_vpn + i for i in range(req.prompt_blocks)],
                True)]
        if protect_prefix and req.prompt_blocks > 1:
            ops.append(("mprotect", tid, vma.start_vpn,
                        req.prompt_blocks, PERM_R))
        return ops

    def extend(self, seq_id: int, req: Request, step: int) -> List[tuple]:
        """Decode step ``step`` (0-based): a new KV block is appended
        every TOKENS_PER_BLOCK tokens."""
        if step % TOKENS_PER_BLOCK != 0:
            return []
        tid, vma = self._vma[seq_id]
        vpn = vma.start_vpn + req.prompt_blocks + step // TOKENS_PER_BLOCK
        return [("touch", tid, [vpn], True)]

    def finish(self, seq_id: int, req: Request) -> List[tuple]:
        """Free the whole span — the munmap shootdown of the paper."""
        tid, vma = self._vma.pop(seq_id)
        return [("munmap", tid, vma.start_vpn, req.total_blocks)]


@dataclasses.dataclass
class _Active:
    req: Request
    worker: int          # index into the worker tid list
    step: int = 0        # decode steps completed


def run_closed_loop(policy: str, *, arrival_rate_rps: float,
                    n_requests: int, seed: int = 0,
                    slots_per_worker: int = 4,
                    step_ns: float = STEP_COMPUTE_NS,
                    topology=PAPER_8SOCKET,
                    trace: Optional[List[Request]] = None,
                    engine: str = "trace") -> dict:
    """Run one policy at one offered load; return latency + counter rows.

    One decode worker per socket plus one housekeeping thread per socket
    (both in the serving process — the realistic threadpool that widens
    ``mm_cpumask``), and a bystander tenant process with one idle thread
    per socket co-resident with the housekeeping thread.  Latency is
    modeled: queue wait (arrival → admission) + decode steps + every
    initiator/responder stretch the contention model charges, because
    each step barriers the workers at the slowest modeled clock."""
    if policy not in SERVING_POLICIES:
        raise ValueError(f"unknown serving policy {policy!r}; "
                         f"pick from {sorted(SERVING_POLICIES)}")
    cfg = dict(concurrency="overlap", contention="coalescing",
               engine=engine)
    cfg.update(SERVING_POLICIES[policy])     # may override contention
    sim = make_sim(topology, SimConfig(**cfg))
    step_cpus = sim.topo.hw_threads_per_node
    workers = [sim.spawn_thread(node * step_cpus)
               for node in range(sim.topo.n_nodes)]
    for node in range(sim.topo.n_nodes):          # serving housekeeping
        sim.spawn_thread(node * step_cpus + 1)
    tenant = sim.spawn_process("tenant")
    tenant_tids = [sim.spawn_thread(node * step_cpus + 1, process=tenant)
                   for node in range(sim.topo.n_nodes)]

    adapter = KVChurnAdapter(sim)
    if trace is None:
        trace = poisson_trace(n_requests, arrival_rate_rps, seed=seed)
    pending = list(trace)[::-1]                   # pop() = next arrival
    n_slots = len(workers) * slots_per_worker
    per_worker = [0] * len(workers)
    active: Dict[int, _Active] = {}
    next_seq = 0
    now = 0.0
    latencies: List[float] = []
    steps = 0

    def barrier() -> float:
        """Lockstep: every worker waits for the slowest one."""
        t = max(sim.thread_time_ns(w) for w in workers)
        for w in workers:
            sim.threads[w].time_ns = max(sim.threads[w].time_ns, t)
        return t

    while pending or active:
        if not active and pending and pending[-1].arrive_ns > now:
            # idle: sleep every worker forward to the next arrival
            now = pending[-1].arrive_ns
            for w in workers:
                sim.threads[w].time_ns = max(sim.threads[w].time_ns, now)
        ops: List[tuple] = []
        while pending and len(active) < n_slots \
                and pending[-1].arrive_ns <= now:
            req = pending.pop()
            worker = min(range(len(workers)), key=lambda i: per_worker[i])
            per_worker[worker] += 1
            ops += adapter.admit(next_seq, workers[worker], req)
            active[next_seq] = _Active(req=req, worker=worker)
            next_seq += 1
        finishing: List[int] = []
        for seq_id, st in active.items():
            ops += adapter.extend(seq_id, st.req, st.step)
            if st.step + 1 == st.req.decode_steps:
                finishing.append(seq_id)
        for seq_id in finishing:
            ops += adapter.finish(seq_id, active[seq_id].req)
        if ops:
            sim.apply_mm_ops(ops)
        for w in workers:
            sim.threads[w].time_ns += step_ns
        now = max(now, barrier())
        steps += 1
        for seq_id in finishing:
            st = active.pop(seq_id)
            per_worker[st.worker] -= 1
            latencies.append(now - st.req.arrive_ns)
        for st in active.values():
            st.step += 1
    sim.check_invariants()

    lat = np.asarray(latencies)
    makespan_ns = now
    c = sim.counters
    return {
        "policy": policy,
        "offered_rps": arrival_rate_rps,
        "completed": len(latencies),
        "goodput_rps": len(latencies) / (makespan_ns / 1e9),
        "p50_us": float(np.percentile(lat, 50)) / 1e3,
        "p99_us": float(np.percentile(lat, 99)) / 1e3,
        "mean_us": float(lat.mean()) / 1e3,
        "makespan_ms": makespan_ns / 1e6,
        "steps": steps,
        "ipis": c.ipis_local + c.ipis_remote,
        "ipis_filtered": c.ipis_filtered,
        "shootdown_rounds": c.shootdown_rounds,
        "responder_delay_us": c.responder_delay_ns / 1e3,
        "ipi_queue_delay_us": c.ipi_queue_delay_ns / 1e3,
        "ipis_coalesced": c.ipis_coalesced,
        "flushes_elided": c.flushes_elided,
        "forced_flushes": c.forced_flushes,
        "victim_interrupt_us": sum(sim.thread_time_ns(t)
                                   for t in tenant_tids) / 1e3,
        "hw_line_invalidations": c.hw_line_invalidations,
        "hw_invalidation_us": c.hw_invalidation_ns / 1e3,
        "model": cfg["contention"],
        "settle_engine": getattr(sim, "last_settle_engine", None),
        "mm_engine": getattr(sim, "last_mm_engine", None),
    }
