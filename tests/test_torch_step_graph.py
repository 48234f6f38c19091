"""The served decode step as a CUDA graph (``launch/step_graph.py``).

On the CPU: the rule that picks graph or eager, and the eager step's spans
and outputs.  On the card (marker ``card``; run them there with ``python -m
pytest -m card tests/test_torch_step_graph.py``): graphed steps bit-equal
to eager ones for the ten configs at their smoke widths, ``serve()``'s
tokens and launch counts, and a new state or parameter tree capturing anew.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.distributed.pods import DistPods  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402
from repro_torch.launch import specs, step_graph  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import (init_decode_state, init_params,  # noqa: E402
                                prefill)
from repro_torch.models.transformer import (greedy_sample,  # noqa: E402
                                            prefill_encdec)

B, S, STEPS = 4, 24, 9
CUDA = torch.device("cuda")
CPU = torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (python -m pytest -m card "
                    "tests/test_torch_step_graph.py on one)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def dist_grid(tmp_path_factory):
    """A grid whose pod axis is a ``DistPods`` (gloo, a world of one)."""
    import torch.distributed as dist
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield DistPods(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case,device,grid,sp,sample,want", [
    ("the card", CUDA, lambda: make_debug_mesh(4, device="cpu"), False, None,
     True),
    ("no grid", CUDA, lambda: None, False, None, True),
    ("the CPU", CPU, lambda: make_debug_mesh(4, device="cpu"), False, None,
     False),
    ("data 2", CUDA, lambda: make_debug_mesh(1, data=2, device="cpu"), False,
     None, False),
    ("model 2", CUDA, lambda: make_debug_mesh(1, model=2, device="cpu"),
     False, None, False),
    ("sp", CUDA, lambda: make_debug_mesh(4, device="cpu"), True, None, False),
    ("a caller's sampler", CUDA, lambda: make_debug_mesh(4, device="cpu"),
     False, greedy_sample, False),
])
def test_rule_graph_or_eager(case, device, grid, sp, sample, want):
    with torch.no_grad():
        assert step_graph.graphed(device, grid(), sp=sp, sample=sample) == want


def test_rule_eager_with_grad():
    with torch.enable_grad():
        assert not step_graph.graphed(CUDA, None, sp=False, sample=None)


@pytest.mark.parametrize("axis", ["pod", "model"])
def test_rule_eager_over_dist_pods(dist_grid, axis):
    grid = (dist_grid if axis == "pod" else
            make_debug_mesh(1, device="cpu").with_axes(model=dist_grid))
    with torch.no_grad():
        assert not step_graph.graphed(CUDA, grid, sp=False, sample=None)


def test_paused_records_nothing():
    tracing.take()
    with tracing.recording():
        with tracing.span("outer"):
            with tracing.paused():
                with tracing.span("inner"):
                    pass
    assert [r.name for r in tracing.take()] == ["outer"]


def test_step_is_freed_without_the_cycle_collector():
    """A serve step holds its graphs, so it must not refer to itself: the
    cycle collector alone would free it, at any time, even inside another
    step's capture."""
    import gc
    import weakref
    collecting = gc.isenabled()
    gc.disable()
    try:
        step = specs.build_serve_step(get_smoke_config("qwen3_14b"))
        gone = weakref.ref(step)
        del step
        assert gone() is None
    finally:
        if collecting:
            gc.enable()


def _prefilled(arch, device, seed=0):
    """(cfg, params, state, phys, first tokens): ``arch``'s smoke config
    prefilled over B rows (the last one padding, -1 tables) with room for
    STEPS decode steps."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen)
    bt = cfg.kv_block_tokens
    mb = -(-(S + STEPS) // bt) + 1
    enc = 16 if cfg.family == "encdec" else 0
    state = init_decode_state(cfg, B, B * mb, mb, enc_len=enc, device=device)
    phys = torch.arange(B * mb, dtype=torch.int32, device=device).view(B, mb)
    phys[-1] = -1
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device).to(torch.int32)
    with torch.no_grad():
        if enc:
            feats = torch.randn((B, enc, cfg.d_model), generator=gen,
                                device=device).to(cfg.dtype)
            logits, state = prefill_encdec(cfg, params, feats, prompts, state,
                                           phys)
        else:
            logits, state = prefill(cfg, params, prompts, state, phys)
    return cfg, params, state, phys, greedy_sample(logits)


def _copy(state):
    return state._replace(caches=tree_map(torch.clone, state.caches),
                          seq_lens=state.seq_lens.clone())


def _steps(step, params, state, phys, tokens, n=STEPS):
    """n steps: each step's tokens and K1 launches, and the last state."""
    out, launches = [], []
    with torch.no_grad():
        for _ in range(n):
            before = paged_attention.launches
            tokens, state = step(params, state, tokens, phys)
            launches.append(paged_attention.launches - before)
            out.append(tokens)
    return out, launches, state


def test_cpu_step_is_eager_and_unchanged():
    """On the CPU the serve step runs as it ran: its ``decode`` spans count
    ``graph`` = 0, and its tokens, lengths and caches equal decode_on_grid
    plus greedy sampling's."""
    cfg, params, state, phys, tokens = _prefilled("qwen3_14b", CPU)
    grid = make_debug_mesh(1, device="cpu")
    ref_state = _copy(state)
    step = specs.build_serve_step(cfg, pods=grid)
    tracing.take()
    with tracing.recording():
        got, _, state = _steps(step, params, state, phys, tokens, n=3)
    recs = tracing.take()
    decodes = [r for r in recs if r.name == "decode"]
    assert [r.counts for r in decodes] == [{"graph": 0}] * 3
    assert [r.name for r in recs if r.parent < 0] == ["decode", "sample"] * 3
    want, ref_tokens = [], tokens
    with torch.no_grad():
        for _ in range(3):
            logits, ref_state = specs.decode_on_grid(
                cfg, params, ref_state, ref_tokens, phys, grid)
            ref_tokens = greedy_sample(logits)
            want.append(ref_tokens)
    assert torch.equal(step.last["logits"], logits)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(state.seq_lens, ref_state.seq_lens)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.caches),
                                                 tree_leaves(ref_state.caches)))


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_graphed_steps_equal_eager(card, arch):
    """STEPS graphed steps (an eager first call that captures, then replays)
    against STEPS eager ones from one prefilled state: tokens, lengths and
    every cache bit-equal, each step's tokens a tensor of its own that no
    later replay overwrites, and K1's launch counter advancing on a replay
    exactly as on an eager step."""
    cfg, params, state, phys, tokens = _prefilled(arch, card)
    eager = specs.build_serve_step(cfg, sample=greedy_sample)
    graphed = specs.build_serve_step(cfg)
    want, want_k1, want_state = _steps(eager, params, _copy(state), phys,
                                       tokens)
    got, got_k1, got_state = _steps(graphed, params, state, phys, tokens)
    torch.cuda.synchronize()
    assert len({t.data_ptr() for t in got}) == STEPS
    assert [t.tolist() for t in got] == [t.tolist() for t in want]
    assert got_k1 == want_k1
    assert torch.equal(got_state.seq_lens, want_state.seq_lens)
    for a, b in zip(tree_leaves(got_state.caches),
                    tree_leaves(want_state.caches)):
        assert torch.equal(a, b)


@pytest.mark.card
def test_serve_graphed_equals_eager(card):
    """``serve()`` (graphed: the default sampler) against ``serve()`` with
    a traced sampler (eager) on the cells' deployment, a partial last
    wave included: the same tokens, the same K1 launches, finite logits."""
    kw = dict(n_requests=6, prompt_len=S, gen_len=6, batch=B, n_pods=4,
              n_pools=4, replicas=True, mode="numapte", device=card,
              verbose=False)
    before = paged_attention.launches
    graphed = serve("qwen3_14b", **kw)
    mid = paged_attention.launches
    eager = serve("qwen3_14b", trace_logits=1, **kw)
    assert (graphed["token_ids"] == eager["token_ids"]).all()
    assert mid - before == paged_attention.launches - mid > 0
    assert graphed["logits_finite"] and eager["logits_finite"]
    assert graphed["prologue_k3_launches"] == eager["prologue_k3_launches"]


@pytest.mark.card
def test_new_state_or_params_capture_anew(card):
    """One step function, three (params, state) pairs in turn and back to
    the first: each gives the eager answer."""
    eager = specs.build_serve_step(get_smoke_config("qwen3_14b"),
                                   sample=greedy_sample)
    graphed = specs.build_serve_step(get_smoke_config("qwen3_14b"))
    runs = [_prefilled("qwen3_14b", card, seed=s) for s in (0, 1)]
    _, p0, s0, phys, t0 = runs[0]
    _, p1, s1, _, t1 = runs[1]
    pairs = [(p0, s0, t0), (p0, s1, t1), (p1, _copy(s0), t0), (p0, s0, t0)]
    for params, state, tokens in pairs:
        want, _, want_state = _steps(eager, params, _copy(state), phys,
                                     tokens, n=3)
        got, _, got_state = _steps(graphed, params, state, phys, tokens, n=3)
        assert [t.tolist() for t in got] == [t.tolist() for t in want]
        for a, b in zip(tree_leaves(got_state.caches),
                        tree_leaves(want_state.caches)):
            assert torch.equal(a, b)


@pytest.mark.card
def test_replay_is_one_decode_span(card):
    """The first call runs eagerly (a ``decode`` span counting ``graph`` =
    0, with its layers, then ``sample``); a replay is one ``decode`` span
    counting 1, with nothing inside it; the capture records nothing."""
    cfg, params, state, phys, tokens = _prefilled("yi_6b", card)
    graphed = specs.build_serve_step(cfg)
    tracing.take()
    with tracing.recording():
        _steps(graphed, params, state, phys, tokens, n=3)
    recs = tracing.take()
    top = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [recs[i].name for i in top] == ["decode", "sample", "decode",
                                           "decode"]
    assert [recs[i].counts for i in top if recs[i].name == "decode"] == [
        {"graph": 0}, {"graph": 1}, {"graph": 1}]
    assert top[-1] == len(recs) - 1 and top[-2] == len(recs) - 2
    assert recs[top[0] + 1].name == "embed"


@pytest.mark.card
def test_capture_under_the_profiler(card):
    """``serve()`` captures its step in its warm-up, and under a running
    ``torch.profiler`` (as ``perfbench/run.py --trace 1``) the capture works,
    the tokens equal the eager run's, and the trace holds every K1 launch
    that ran, the replays' included."""
    kw = dict(n_requests=4, prompt_len=S, gen_len=4, batch=B, n_pods=1,
              device=card, verbose=False)
    eager = serve("qwen3_14b", trace_logits=1, **kw)
    before = paged_attention.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        graphed = serve("qwen3_14b", **kw)
        torch.cuda.synchronize()
    launched = paged_attention.launches - before
    traced = sum(e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "paged_attention_kernel" in e.key)
    assert (graphed["token_ids"] == eager["token_ids"]).all()
    assert traced == launched > 0
