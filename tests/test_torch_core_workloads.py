"""The port's simulator workloads against the reference's: the paper's
application model (``run_app``), the allocator model (``MallocModel``), the
trace compiler's windows, the batch engine through the plain version of the
``fifo_miss`` kernel, and the public API.  Results are compared as plain
values: a dataclass or an Enum is never equal across two packages."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
import test_mm_batch_differential as ref  # noqa: E402
import test_torch_core as twin  # noqa: E402
import test_trace_windows  # noqa: E402
from repro_torch.core import batch as port_batch  # noqa: E402
from repro_torch.kernels import fifo_miss as port_fifo  # noqa: E402

APP_KW = dict(accesses_per_thread=1500, pages_per_gb=8, touch_stride=1,
              mm_phases=True)


def test_torch_core_public_api_is_the_reference_api():
    assert P.__all__ == R.__all__
    assert P.ENGINES == R.ENGINES and P.SETTLE_MODES == R.SETTLE_MODES
    assert list(P.CONTENTION_MODELS) == list(R.CONTENTION_MODELS)
    assert {k: v.value for k, v in P.POLICIES.items()} == \
        {k: v.value for k, v in R.POLICIES.items()}
    for name in ("PAPER_4SOCKET", "PAPER_8SOCKET", "TPU_2POD"):
        assert dataclasses.asdict(getattr(P, name)) == \
            dataclasses.asdict(getattr(R, name))
    assert dataclasses.asdict(P.CostModel.paper_default()) == \
        dataclasses.asdict(R.CostModel.paper_default())
    assert dataclasses.asdict(P.SimConfig()) == {
        k: (v.value if k == "policy" else v)
        for k, v in dataclasses.asdict(R.SimConfig()).items()} | {
        "policy": P.SimConfig().policy}
    assert {n: dataclasses.asdict(a) for n, a in P.APPS.items()} == \
        {n: dataclasses.asdict(a) for n, a in R.APPS.items()}


def run_app_both(app, policy, cfg, **kw):
    out = []
    for pkg in (R, P):
        out.append(pkg.run_app(pkg.Policy(policy), pkg.APPS[app],
                               pkg.PAPER_8SOCKET,
                               config=pkg.SimConfig(**cfg), **kw))
    return out


@pytest.mark.parametrize("policy", ["linux", "mitosis", "numapte"])
@pytest.mark.parametrize("app", sorted(R.APPS))
def test_torch_core_run_app_equals_reference(app, policy):
    """fig08's model at a small scale, with the mprotect and teardown
    phases: the result dicts are equal, counters and times included."""
    want, got = run_app_both(app, policy,
                             dict(prefetch_degree=9, engine="batch"), **APP_KW)
    assert got == want
    assert got["exec_ns"] > 0 and got["counters"]["tlb_misses"] > 0


@pytest.mark.parametrize("engine", ["scalar", "trace"])
def test_torch_core_run_app_other_engines(engine):
    want, got = run_app_both("hashjoin", "numapte",
                             dict(prefetch_degree=9, engine=engine,
                                  concurrency="overlap"), **APP_KW)
    assert got == want


def test_torch_core_batch_engine_through_the_plain_scan(monkeypatch):
    """The engine's pass 1 as the card runs it — densified ids through
    ``fifo_miss_ids`` — here on CPU tensors (the kernel's plain version):
    the run equals the reference's numpy one."""
    calls = []

    def through_ids(arr, initial, capacity):
        fill0, n0, ids = port_fifo.densify(
            np.asarray(arr, np.int64), initial, capacity)
        calls.append(ids.size)
        return port_fifo.fifo_miss_ids(torch.from_numpy(fill0), n0,
                                       torch.from_numpy(ids), capacity).numpy()

    monkeypatch.setattr(port_batch, "fifo_miss", through_ids)
    want, got = run_app_both("xsbench", "numapte",
                             dict(prefetch_degree=9, engine="batch"),
                             accesses_per_thread=3000, pages_per_gb=8)
    assert got == want
    assert len(calls) == R.PAPER_8SOCKET.n_nodes and min(calls) > 0


@pytest.mark.parametrize("flavor", ["glibc", "tcmalloc", "mmap"])
def test_torch_core_malloc_model_equals_reference(flavor):
    def run(pkg):
        topo = pkg.NumaTopology(2, 4, 1)
        sim = pkg.make_sim(topo, pkg.SimConfig(policy="numapte",
                                               prefetch_degree=9,
                                               elide_flushes=True))
        tid = sim.spawn_thread(0)
        mall = pkg.MallocModel(sim, tid, flavor, cache_cap_pages=256)
        rng = np.random.default_rng(3)
        live = []
        for s in pkg.gamma_sizes_pages(rng, 120):
            live.append(mall.alloc(int(s)))
            if len(live) > 8:
                mall.free(live.pop(int(rng.integers(0, len(live)))))
        sim.check_invariants()
        return (dict(mall.stats), dataclasses.asdict(sim.counters),
                sim.thread_time_ns(tid), mall.cached_span_count,
                mall.cached_pages, twin.sim_state(sim))

    assert run(P) == run(R)


def trace_fields(table):
    return {f.name: (getattr(table, f.name).tolist()
                     if isinstance(getattr(table, f.name), np.ndarray)
                     else getattr(table, f.name))
            for f in dataclasses.fields(table)}


@pytest.mark.parametrize("elide", [False, True])
def test_torch_core_compile_trace_and_windows_equal_reference(elide):
    """One mixed program compiled without a sim and against a sim in
    mid-program state: the same tables (fan-out and relevance masks
    included) and the same conflict-free windows."""
    ops = test_trace_windows._synthetic_ops(np.random.default_rng(5), 120)
    tables = [pkg.compile_trace(ops) for pkg in (R, P)]
    assert trace_fields(tables[0]) == trace_fields(tables[1])
    windows = [pkg.partition_windows(t, elide=elide)
               for pkg, t in zip((R, P), tables)]
    assert windows[0] == windows[1] and len(windows[0]) > 1
    assert [P.ops_conflict(tables[1], i, i + 1, elide=elide)
            for i in range(len(ops) - 1)] == \
        [R.ops_conflict(tables[0], i, i + 1, elide=elide)
         for i in range(len(ops) - 1)]

    choices = ref._random_choices(np.random.default_rng(11), 40)
    sims = [twin.build(pkg, engine="trace", policy="numapte",
                       elide_flushes=elide)[0] for pkg in (R, P)]
    program = ref.materialize(choices, sims[0]._next_vpn)
    half = len(program) // 2
    for sim in sims:
        sim.apply_mm_ops(program[:half])
    twin.assert_twins(*sims, "trace prefix")
    tables = [pkg.compile_trace(program[half:], sim)
              for pkg, sim in zip((R, P), sims)]
    assert trace_fields(tables[0]) == trace_fields(tables[1])
    assert R.partition_windows(tables[0], elide=elide) == \
        P.partition_windows(tables[1], elide=elide)


def test_torch_core_access_stream_equals_reference():
    def run(pkg):
        sim, tids, _ = twin.build(pkg, policy="mitosis", prefetch_degree=9)
        vma = sim.mmap(tids[0], 3000)
        rng = np.random.default_rng(13)
        chunks = [(tids[k % 4], vma.start_vpn + rng.integers(0, 3000, 500),
                   rng.random(500) < 0.3) for k in range(8)]
        spent = pkg.access_stream(sim, chunks)
        groups = [g.tolist() for g in pkg.group_by_leaf(
            np.unique(vma.start_vpn + rng.integers(0, 3000, 200)))]
        return spent, groups, twin.sim_state(sim)

    assert run(P) == run(R)
