"""The slice as a whole: the port's serving loop on the CPU (plain
versions of the kernels) against the JAX package's, same arguments, same
prompts (numpy, from the seed) and the reference's own weights converted."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.serve import serve as jax_serve  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import specs as specs_mod  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402

COUNTERS = ("mode", "n_pods", "tokens", "invalidations_sent",
            "invalidations_filtered", "coherence_bytes", "fetches",
            "prefetched", "table_pages")
RUN = dict(n_requests=5, prompt_len=20, gen_len=6, batch=2, seed=0)


@pytest.fixture(scope="module")
def converted():
    """The weights the reference's serve() draws for seed 0, converted."""
    cfg = get_smoke_config("qwen3_14b")
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_smoke_config("qwen3_14b"), jax.random.PRNGKey(RUN["seed"])))
    return params_from_jax(cfg, tree, device="cpu")


@pytest.fixture(scope="module")
def port_runs(converted):
    return {(mode, n_pods): serve("qwen3_14b", mode=mode, n_pods=n_pods,
                                  device="cpu", params=converted,
                                  verbose=False, **RUN)
            for mode in ("local", "eager", "numapte") for n_pods in (1, 4)}


@pytest.mark.parametrize("n_pods", [1, 4])
@pytest.mark.parametrize("mode", ["local", "eager", "numapte"])
def test_torch_serve_counters_equal_reference(port_runs, mode, n_pods):
    want = jax_serve("qwen3_14b", mode=mode, n_pods=n_pods, verbose=False, **RUN)
    got = port_runs[(mode, n_pods)]
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert set(want) <= set(got)                 # the reference's keys all stay
    assert got["tok_per_s"] > 0 and got["logits_finite"]
    assert got["device"] == "cpu" and got["n_layers"] == 2
    # a partial final wave (5 requests, batch 2) still emits every token
    assert got["tokens"] == RUN["n_requests"] * RUN["gen_len"]
    assert got["token_ids"].shape == (RUN["n_requests"], RUN["gen_len"])
    if mode == "numapte":
        assert (got["fetches"] > 0) == (n_pods > 1)


@pytest.mark.parametrize("n_pods", [1, 4])
def test_torch_serve_tokens_equal_across_modes(port_runs, n_pods):
    """Coherence policy is performance-transparent: same tokens."""
    ids = [port_runs[(mode, n_pods)]["token_ids"]
           for mode in ("local", "eager", "numapte")]
    assert np.array_equal(ids[0], ids[1]) and np.array_equal(ids[0], ids[2])
    assert np.array_equal(ids[0], port_runs[("local", 5 - n_pods)]["token_ids"])
    assert ids[0].min() >= 0 and ids[0].max() < 512
    assert len(np.unique(ids[0])) > 4            # not one constant token


def test_torch_serve_tokens_follow_the_model(converted):
    """token_ids are the greedy continuations the model gives: in float32,
    each request's tokens equal the argmax of one full forward over its
    prompt, serve()'s first decode token (0) and its own samples — paged
    prefill + decode against the unpaged forward, through the whole loop."""
    from repro_torch.models import forward_lm
    cfg = get_smoke_config("qwen3_14b")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    r = serve("qwen3_14b", cfg=cfg32, params=converted, device="cpu",
              verbose=False, n_pods=2, **RUN)
    rng = np.random.default_rng(RUN["seed"])
    row = 0
    for wave in range(3):
        prompts = rng.integers(0, cfg.vocab_size, (RUN["batch"], RUN["prompt_len"]))
        for b in range(min(RUN["batch"], RUN["n_requests"] - row)):
            # serve() decodes token 0 first, then its own samples
            seq = list(prompts[b]) + [0] + list(r["token_ids"][row][:-1])
            logits, _ = forward_lm(cfg32, converted, torch.tensor([seq]))
            want = logits[0, RUN["prompt_len"]:].argmax(-1).numpy()
            np.testing.assert_array_equal(r["token_ids"][row], want)
            row += 1
    assert row == RUN["n_requests"]


def test_torch_serve_warms_up_before_timer(monkeypatch):
    """Prefill and decode both run once (all -1 tables) before the first
    ``time.perf_counter()`` read, so building the kernels (and, on the card,
    capturing the step's graph) never lands inside the tok_per_s window.
    The warm-up's decode is the serve step's (``specs.decode_step``)."""
    events = []
    real_prefill, real_step = serve_mod.prefill, specs_mod.decode_step
    real_pc = serve_mod.time.perf_counter

    def spy(name, fn):
        def wrapper(cfg, params, *args, **kw):
            phys = args[-1]
            events.append((name, bool((phys < 0).all())))
            return fn(cfg, params, *args, **kw)
        return wrapper

    def spy_pc():
        events.append(("timer", None))
        return real_pc()

    monkeypatch.setattr(serve_mod, "prefill", spy("prefill", real_prefill))
    monkeypatch.setattr(specs_mod, "decode_step", spy("decode", real_step))
    monkeypatch.setattr(serve_mod.time, "perf_counter", spy_pc)
    serve("qwen3_14b", n_requests=2, prompt_len=8, gen_len=2, batch=2,
          n_pods=1, mode="local", verbose=False, device="cpu")
    first_timer = events.index(("timer", None))
    assert events[:first_timer] == [("prefill", True), ("decode", True)]
    assert ("prefill", False) in events[first_timer:]


def test_torch_serve_reports_phase_times_of_its_own_loop(monkeypatch):
    """``prefill_ms`` / ``decode_step_ms`` are means over the waves of the one
    serving loop: on a clock that advances 1 s a read, a wave's prefill spans
    one tick and its decode steps one tick together, whatever gen_len is."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(serve_mod.time, "perf_counter",
                        lambda: float(next(ticks)))
    r = serve("qwen3_14b", n_requests=3, prompt_len=8, gen_len=4, batch=2,
              n_pods=1, mode="local", verbose=False, device="cpu")
    assert r["prefill_ms"] == 1000.0
    assert r["decode_step_ms"] == 1000.0 / 4
    # t0, then three reads a wave, then the end: 2 waves -> 7 ticks in all
    assert r["tok_per_s"] == r["tokens"] / 7.0


def test_torch_serve_needs_a_gpu_unless_cpu_is_asked_for():
    """No fallback that hides the device: here (no GPU) the default raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("qwen3_14b", n_requests=1, verbose=False)
    from repro_torch.kvcache import PagedKVManager
    from repro_torch.models import init_decode_state
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVManager(n_frames=8, max_blocks_per_seq=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_state(get_smoke_config("yi_6b"), 1, 8, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("qwen3_14b", device="cuda", n_requests=1, verbose=False)


def test_torch_serve_full_width_config_and_depth_cut(monkeypatch):
    """full_width picks the published config and n_layers cuts depth only;
    checked on the config serve() hands to init_params (nothing that size is
    built here)."""
    seen = {}

    def stop(cfg, gen, *, param_dtype=None):
        seen["cfg"], seen["dtype"] = cfg, param_dtype
        raise KeyboardInterrupt

    monkeypatch.setattr(serve_mod, "init_params", stop)
    with pytest.raises(KeyboardInterrupt):
        serve("qwen3_14b", full_width=True, n_layers=3, device="cpu", verbose=False)
    cfg = seen["cfg"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.resolved_head_dim) == (3, 5120, 40, 8, 17408, 151936, 128)
    assert seen["dtype"] == torch.bfloat16
