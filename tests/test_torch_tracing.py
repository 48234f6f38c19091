"""The port's spans (``repro_torch.tracing``) on the served path, at the
smoke config on the CPU: nothing recorded while off; under the profiler the
span tree of a wave's admission, walk and prefill and of its decode steps
(each a ``build_serve_step`` call with the numaPTE prologue over
``LoopPods(4)``); the counts against ``HostCounters``, ``Pods.wire_bytes``
and ``pte_gather.launches``; tokens and state bit-identical with spans on
and off; the records on the profiler's clock; and ``profile_cell``'s idle
arithmetic on planted device operations."""
from __future__ import annotations

import dataclasses
import statistics

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.pte_gather.ops import pte_gather  # noqa: E402
from repro_torch.kvcache import PagedKVManager  # noqa: E402
from repro_torch.kvcache.gather import pool_of_rows  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.profile_cell import device_busy  # noqa: E402
from repro_torch.models import (init_decode_state, init_params,  # noqa: E402
                                prefill)
from repro_torch.pagedpt.blocktable import CoherenceMode  # noqa: E402

PODS, B, S, STEPS = 4, 4, 31, 3
MODE = "numapte"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("yi_6b")
    params = init_params(cfg, torch.Generator().manual_seed(7))
    prompts = torch.randint(0, cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(8),
                            dtype=torch.int32)
    return cfg, params, prompts


@dataclasses.dataclass
class Served:
    tokens: torch.Tensor           # [STEPS, B]
    state: object
    kv: PagedKVManager
    grid: object


@torch.no_grad()
def serve(cfg, params, prompts) -> Served:
    """One wave as ``perfbench/driver.py`` serves it: admission, the walk
    and the prefill, then STEPS decode steps (extend, walk recording on the
    first, the serve step, extra prologue rounds); row 1's prompt crosses a
    block at its second step."""
    bt = cfg.kv_block_tokens
    mb = -(-(S + STEPS) // bt) + 1
    frames = 2 * PODS * B * mb
    kv = PagedKVManager(n_frames=frames, block_tokens=bt, max_blocks_per_seq=mb,
                        n_pods=PODS, mode=CoherenceMode(MODE), n_pools=PODS,
                        replicas=True, device=CPU)
    grid = make_debug_mesh(PODS, device=CPU)
    state = init_decode_state(
        cfg, B, frames, mb, n_pools=PODS,
        kv_split=specs.kv_split(cfg, grid, specs.make_rules(cfg, grid)),
        state_split=specs.state_split(params, grid), device=CPU)
    step = specs.build_serve_step(cfg, coherence=MODE, pods=grid)
    home = pool_of_rows(B, PODS).tolist()
    rows = list(range(B))
    for r in rows:
        kv.start_sequence(r, S, pod=home[r])
    phys = kv.physical_tables(rows)
    _, state = prefill(cfg, params, prompts, state, phys)
    tokens, out = torch.zeros((B,), dtype=torch.int32), []
    for t in range(STEPS):
        for r in rows:
            kv.maybe_extend(r, S + t + 1)
        phys = kv.physical_tables(rows, record=(t % 4 == 0))
        tokens, state, _ = step(params, state, tokens, phys, kv.replicas,
                                *kv.coherence_inputs())
        specs.coherence_rounds(MODE, grid, kv)
        out.append(tokens.clone())
    return Served(torch.stack(out), state, kv, grid)


def _children(recs, i):
    return [k for k, r in enumerate(recs) if r.parent == i]


def _names(recs, idx):
    return [recs[k].name for k in idx]


def test_off_records_nothing(model):
    tracing.take()
    serve(*model)
    assert tracing.records() == []


@pytest.fixture(scope="module")
def profiled(model):
    """One wave under the CPU profiler: (its records, the profile)."""
    tracing.take()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        serve(*model)
    return tracing.take(), prof


def _check_forward(recs, i, cfg, kernel):
    """A ``decode`` or ``prefill`` record: embed, one layer a layer, head;
    each layer attn (holding attn.kernel) then ffn."""
    kids = _children(recs, i)
    assert _names(recs, kids) == ["embed"] + ["layer"] * cfg.n_layers + ["head"]
    layers = kids[1:-1]
    assert [recs[k].counts for k in layers] == [
        {"index": n} for n in range(cfg.n_layers)]
    for k in layers:
        attn, ffn = _children(recs, k)
        assert (recs[attn].name, recs[ffn].name) == ("attn", "ffn")
        assert _names(recs, _children(recs, attn)) == [kernel]
        assert _children(recs, ffn) == []


def test_span_tree_of_a_wave(model, profiled):
    cfg = model[0]
    recs, _ = profiled
    assert all(r.end_ns >= r.start_ns > 0 for r in recs)
    top = [i for i, r in enumerate(recs) if r.parent < 0]
    names = _names(recs, top)
    step = ["kv.extend"] * B + ["kv.walk", "coherence.inputs",
                                "coherence.prologue", "decode", "sample"]
    assert names[:B + 2] == ["kv.admit"] * B + ["kv.walk", "prefill"]
    body = [n for n in names[B + 2:]
            if n not in ("coherence.inputs", "coherence.prologue")]
    assert body == [n for n in step * STEPS if not n.startswith("coherence")]
    assert names.count("decode") == STEPS
    walks = [i for i in top if recs[i].name == "kv.walk"]
    # the prefill's walk and the first decode step's record; the others not
    for n, i in enumerate(walks):
        want = (["kv.record"] if n in (0, 1) else []) + ["kv.stage", "k3"]
        assert _names(recs, _children(recs, i)) == want
    for i in top:
        if recs[i].name in ("decode", "prefill"):
            _check_forward(recs, i, cfg, "attn.kernel")
        elif recs[i].name in ("sample", "kv.admit", "kv.extend",
                              "coherence.inputs", "coherence.prologue"):
            assert _children(recs, i) == []
    for r in recs:
        if r.name in ("attn", "ffn", "attn.kernel", "embed", "head"):
            assert recs[r.parent].name in ("layer", "attn", "decode", "prefill")


def test_counts_are_the_counters_deltas(model):
    tracing.take()
    launches = pte_gather.launches
    with tracing.recording():
        served = serve(*model)
    recs = tracing.take()
    c = served.kv.host.counters

    def total(name, key):
        return sum(r.counts[key] for r in recs if r.name == name)

    # one manager and one grid a wave: their counters start at 0
    assert total("kv.record", "accesses") == (c.translation_local
                                              + c.translation_miss) > 0
    assert total("kv.record", "misses") == c.translation_miss > 0
    assert total("kv.record", "fetches") == c.fetches
    assert total("coherence.prologue", "wire_bytes") == served.grid.wire_bytes > 0
    assert total("coherence.prologue", "k3") == pte_gather.launches - launches
    # every mutation and miss reached the replicas, each in one slot
    assert total("coherence.inputs", "mutations") == c.mutations > B
    assert total("coherence.inputs", "misses") == c.translation_miss
    spec = served.kv.spec
    for r in recs:
        if r.name == "coherence.inputs":
            assert r.counts["mutation_slots"] == PODS * spec.mutation_budget
            assert r.counts["miss_slots"] == PODS * spec.miss_budget


def test_spans_change_no_result(model):
    tracing.take()
    off = serve(*model)
    with tracing.recording():
        on = serve(*model)
    assert tracing.take()
    assert torch.equal(off.tokens, on.tokens)
    for a, b in zip(off.state.caches, on.state.caches):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(off.state.seq_lens, on.state.seq_lens)
    assert torch.equal(off.kv.replicas, on.kv.replicas)
    assert (off.kv.host.canonical == on.kv.host.canonical).all()
    assert off.kv.host.counters == on.kv.host.counters


def test_records_on_the_profilers_clock(profiled):
    """Each record, moved by the median offset between the two clocks, lies
    within its ``repro_torch.*`` range's event, to 50 us: its stamps are
    taken inside the range, so only a clock that drifts, or a record paired
    with another span's event, puts it outside (a descheduled host makes
    the event wider, never the record wider than it)."""
    recs, prof = profiled
    _, ranges = tracing.profiled(prof)
    pairs = []
    for name in {r.name for r in recs}:
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start_ns)
        theirs = sorted(a for a in ranges if a[0] == tracing.PREFIX + name)
        theirs = sorted(theirs, key=lambda a: a[1])
        assert len(mine) == len(theirs), name
        pairs += zip(mine, theirs)
    offset = statistics.median(a[1] - r.start_ns for r, a in pairs)
    for r, (_, s, e) in pairs:
        assert s - 50_000 <= r.start_ns + offset, r.name
        assert r.end_ns + offset <= e + 50_000, r.name


def test_on_says_whether_a_span_records():
    assert not tracing.on() and tracing.span("x") is tracing.span("y")
    with tracing.recording():
        assert tracing.on()
        with tracing.paused():
            assert not tracing.on()
        assert tracing.on()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.on()
    assert not tracing.on()


def test_union_and_gaps():
    ops = [(100, 150), (120, 180), (300, 400), (950, 1050), (-20, 10)]
    busy = tracing.union(ops, 0, 1000)
    assert busy == [(0, 10), (100, 180), (300, 400), (950, 1000)]
    assert tracing.gaps(busy, 0, 1000) == [(10, 100), (180, 300), (400, 950)]
    assert tracing.gaps([], 5, 9) == [(5, 9)]


def test_profile_cell_idle_over_the_steps_window():
    """Two streams overlapping count once; operations outside the profiled
    step's window count only inside it."""
    ops = [(1_000_000, 3_000_000), (2_000_000, 4_000_000),    # overlap
           (6_000_000, 7_000_000), (9_500_000, 12_000_000)]    # clipped
    busy_ms, idle = device_busy(ops, (0, 10_000_000))
    assert busy_ms == pytest.approx(4.5)
    assert idle == pytest.approx(0.55)
