"""The port's NUMA simulator against the reference's, state for state.

``repro_torch.core`` is a copy of ``repro.core`` that imports nothing of the
JAX package.  The same seeded op programs (the reference's materializer,
``test_mm_batch_differential.materialize``) run through both packages'
``make_sim`` under one configuration, and after every chunk the two sims
must hold the same state: counters, each thread's modeled nanoseconds with
``==``, received IPIs, every TLB partition's entries *and order*, page-table
owners, sharers and copies, the oracle, the VMA layout, the lazy-flush
state and the engines' provenance.  The matrix covers engines x policies x
contention models, the TLB filter, prefetch, concurrency, every settle
mode, flush elision, interference and a second tenant.

A dataclass's and an Enum's ``==`` are False across two packages even when
their fields agree, so the comparator compares ``dataclasses.asdict`` and
plain values; the control test shows it fails on a program that differs by
one op.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core as R
import test_mm_batch_differential as ref
import repro_torch.core as P

ENGINES = ("scalar", "batch", "trace")
POLICIES = ("linux", "mitosis", "numapte")
CONTENTION = tuple(R.CONTENTION_MODELS)
SETTLE = R.SETTLE_MODES


# --------------------------------------------------------------------------
# the comparator
# --------------------------------------------------------------------------
def process_state(proc):
    tables = {ti: (t.owner, t.sharers,
                   {m: {i: (p.frame, p.frame_node, p.perms)
                        for i, p in cp.items()}
                    for m, cp in t.copies.items()})
              for ti, t in proc.store.tables.items()}
    vmas = sorted((v.vma_id, v.start_vpn, v.end_vpn, v.owner, v.perms)
                  for v in proc.vmas)
    return dict(tables=tables, vmas=vmas, oracle=dict(proc.oracle),
                next_vpn=proc.next_vpn, lazy_pages=dict(proc.lazy_pages),
                lazy_stale={c: sorted(s) for c, s in proc.lazy_stale.items()},
                threads=sorted(proc.threads))


def sim_state(sim):
    """Everything the twin comparison holds equal, as plain values."""
    return dict(
        policy=sim.policy.value,
        counters=dataclasses.asdict(sim.counters),
        threads={tid: dataclasses.asdict(t) for tid, t in sim.threads.items()},
        tlbs={asid: {cpu: list(tlb.entries.items())
                     for cpu, tlb in parts.items()}
              for asid, parts in sim._asid_tlbs.items()},
        processes={asid: process_state(p) for asid, p in sim.processes.items()},
        provenance=(sim.last_mm_engine, sim.last_settle_engine))


def assert_twins(a, b, tag=""):
    """``a`` (the reference's sim) and ``b`` (the port's) hold one state."""
    sa, sb = sim_state(a), sim_state(b)
    assert list(sa) == list(sb)
    for key in sa:
        if key == "threads":    # modeled time: exact float equality, on purpose
            for tid in sa[key]:
                assert sa[key][tid] == sb[key][tid], \
                    f"{tag}: thread {tid} {sa[key][tid]!r} != {sb[key][tid]!r}"
        assert sa[key] == sb[key], f"{tag}: {key} diverged"


def op_results(results):
    return [(v.vma_id, v.start_vpn, v.end_vpn) if v is not None else None
            for v in results]


# --------------------------------------------------------------------------
# the twin runner
# --------------------------------------------------------------------------
def build(pkg, *, tenant=False, cost=None, **cfg):
    topo = pkg.NumaTopology(n_nodes=4, cores_per_node=4, threads_per_core=1)
    if cost is not None:
        cost = dataclasses.replace(pkg.CostModel.paper_default(), **cost)
    sim = pkg.make_sim(topo, pkg.SimConfig(tlb_entries=64, cost=cost, **cfg))
    tids = [sim.spawn_thread(n * topo.hw_threads_per_node)
            for n in range(topo.n_nodes)]
    tenants = []
    if tenant:
        proc = sim.spawn_process("tenant")
        tenants = [sim.spawn_thread(1 + n * topo.hw_threads_per_node,
                                    process=proc) for n in range(2)]
    return sim, tids, tenants


def tenant_churn(sim, tid, n_pages):
    vma = sim.apply_mm_ops([("mmap", tid, n_pages)])[0]
    sim.apply_mm_ops([("touch", tid, [vma.start_vpn], True),
                      ("mprotect", tid, vma.start_vpn, n_pages, ref.PERM_R),
                      ("munmap", tid, vma.start_vpn, n_pages)])


def run_twins(seed, *, chunk=None, tenant=False, extra_port_op=None,
              cost=None, tag="", **cfg):
    """One seeded program through both packages in chunked lockstep."""
    rng = np.random.default_rng(90_000 + seed)
    choices = ref._random_choices(rng, int(rng.integers(6, 30)))
    chunk = chunk or int(rng.integers(1, 12))
    (sa, ta, ea), (sb, tb, eb) = (build(pkg, tenant=tenant, cost=cost, **cfg)
                                  for pkg in (R, P))
    assert (ta, ea) == (tb, eb)
    ops = ref.materialize(choices, sa._next_vpn)
    if extra_port_op is not None:
        ops_b = list(ops)
        ops_b.insert(len(ops) // 2, extra_port_op(ops, tb))
    else:
        ops_b = ops
    for i in range(0, max(len(ops), len(ops_b)), chunk):
        ra = sa.apply_mm_ops(ops[i:i + chunk])
        rb = sb.apply_mm_ops(ops_b[i:i + chunk])
        assert op_results(ra) == op_results(rb), f"{tag}: op results @ {i}"
        assert_twins(sa, sb, f"{tag}/chunk{i}")
        if tenant:
            tid, n_pages = ea[(i // chunk) % 2], 1 + int(rng.integers(1, 64))
            tenant_churn(sa, tid, n_pages)
            tenant_churn(sb, tid, n_pages)
            assert_twins(sa, sb, f"{tag}/tenant{i}")
    sb.check_invariants()
    return sa, sb


# --------------------------------------------------------------------------
# the matrix
# --------------------------------------------------------------------------
@pytest.mark.parametrize("contention", CONTENTION)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_torch_core_twin_contention(engine, policy, contention):
    """Overlapping shootdown rounds under every contention model, filter on
    with no prefetch and off with degree-9 prefetch."""
    for seed, (filt, pf) in enumerate(((True, 0), (False, 9))):
        run_twins(seed, engine=engine, policy=policy, contention=contention,
                  concurrency="overlap", tlb_filter=filt, prefetch_degree=pf,
                  tag=f"{engine}/{policy}/{contention}/{seed}")


@pytest.mark.parametrize("prefetch", [0, 9])
@pytest.mark.parametrize("tlb_filter", [True, False])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_torch_core_twin_filter_prefetch(engine, policy, tlb_filter, prefetch):
    run_twins(10 + prefetch + tlb_filter, engine=engine, policy=policy,
              tlb_filter=tlb_filter, prefetch_degree=prefetch,
              tag=f"{engine}/{policy}/filter{tlb_filter}/pf{prefetch}")


@pytest.mark.parametrize("contention", ["queue", "coalescing", "hardware"])
@pytest.mark.parametrize("settle", SETTLE)
@pytest.mark.parametrize("engine", ENGINES)
def test_torch_core_twin_settle(engine, settle, contention):
    """Each settle mode: the vectorised rounds, the scalar model loops, and
    the choice between them."""
    if settle == "vector" and contention == "hardware":
        # refused alike: the vectorised rounds take only the stock models
        errors = []
        for pkg in (R, P):
            with pytest.raises(ValueError) as err:
                sim, tids, _ = build(pkg, engine=engine, settle=settle,
                                     contention=contention,
                                     concurrency="overlap")
                vma = sim.mmap(tids[0], 4)
                sim.apply_mm_ops([("touch", t, [vma.start_vpn]) for t in tids]
                                 + [("munmap", tids[0], vma.start_vpn, 4)])
            errors.append(str(err.value))
        assert errors[0] == errors[1]
        return
    for seed, policy in enumerate(("linux", "numapte")):
        run_twins(20 + seed, engine=engine, policy=policy, settle=settle,
                  contention=contention, concurrency="overlap",
                  tag=f"{engine}/{settle}/{contention}/{policy}")


@pytest.mark.parametrize("concurrency", ["sequential", "overlap"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_torch_core_twin_elide_flushes(engine, policy, concurrency):
    for seed in range(2):
        run_twins(30 + seed, engine=engine, policy=policy,
                  concurrency=concurrency, elide_flushes=True,
                  tag=f"{engine}/{policy}/{concurrency}/elide/{seed}")


@pytest.mark.parametrize("concurrency", ["sequential", "overlap"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_torch_core_twin_interference(engine, policy, concurrency):
    """Interference's non-integral charges force the sequential settlement."""
    run_twins(40, engine=engine, policy=policy, concurrency=concurrency,
              interference_nodes=(1,), prefetch_degree=9,
              tag=f"{engine}/{policy}/{concurrency}/interference")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_torch_core_twin_second_tenant(engine, policy):
    """A second process churns its own address space between the main
    process's chunks: per-ASID TLB partitions and process-wide fan-out."""
    run_twins(50, engine=engine, policy=policy, tenant=True,
              concurrency="overlap", elide_flushes=policy == "numapte",
              tag=f"{engine}/{policy}/tenant")


@pytest.mark.parametrize("engine", ENGINES)
def test_torch_core_twin_fractional_costs(engine):
    """Non-integral costs make thread times non-integer, so the grouped
    settlement takes its exact sequential-add fallback."""
    sa, sb = run_twins(60, engine=engine, policy="numapte",
                       concurrency="overlap",
                       cost=dict(local_mem_ns=90.3, fault_fixed_ns=550.7),
                       tag=f"{engine}/fractional")
    assert any(not t.time_ns.is_integer() for t in sb.threads.values())


def test_torch_core_twin_comparator_catches_one_extra_op():
    """Control: the port's run given one more op than the reference's must
    fail the comparison (a comparator that is vacuous across packages would
    pass it)."""
    def extra(ops, tids):
        touch = next(op for op in ops if op[0] == "touch")
        return ("touch", (touch[1] + 1) % len(tids), touch[2][:1], True)

    with pytest.raises(AssertionError):
        run_twins(70, engine="batch", policy="numapte", chunk=64,
                  extra_port_op=extra, tag="control")
    # and the same program without the extra op passes
    run_twins(70, engine="batch", policy="numapte", chunk=64, tag="control")
