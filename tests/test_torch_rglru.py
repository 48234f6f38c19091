"""RecurrentGemma (RG-LRU recurrent blocks + local-attention blocks, pattern
r, r, a) in the port against the JAX package.

The module (``rglru_forward``, ``rglru_decode``) runs on the same numpy
inputs on both sides; float32 within 1e-5 of the largest magnitude,
bfloat16 within rel 0.03.  The reference's ``jax.lax.associative_scan`` has
no PyTorch counterpart: the port's doubling scan is held against a
sequential loop.  The model runs the smoke config (3 layers: r, r, a with a
32-token window) on converted weights with the norms perturbed as in
``test_torch_models._setup``; sequences pass the window, so the ring wraps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.launch.serve import serve as jax_serve  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro.models.common import layer_groups as jax_layer_groups  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from test_torch_models import _f32, _setup  # noqa: E402
from test_torch_ssm import DTYPES, _check  # noqa: E402

ARCH = "recurrentgemma_2b"


def _cfgs(dtype: str):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=jd),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=td))


def _module_params(jcfg, seed: int = 0):
    """The reference's ``init_rglru`` leaves as numpy, ``conv_b`` and
    ``rg_a`` moved off their init by seeded noise."""
    p = jax.tree.map(np.asarray, jrg.init_rglru(jcfg, KeyGen(jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(seed + 11)
    return {k: (v + rng.normal(0, 0.3, v.shape).astype(np.float32)
                if v.ndim == 1 else v) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_rglru_forward_and_state_match_jax(dtype, S):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_module_params(jcfg))
    x = np.random.default_rng(1).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    want, wst = jrg.rglru_forward(jcfg, jp, jnp.asarray(x).astype(jcfg.dtype),
                                  return_state=True)
    got, gst = trg.rglru_forward(tcfg, tp, torch.from_numpy(x).to(tcfg.dtype),
                                 return_state=True)
    assert got.dtype == tcfg.dtype and gst["h"].dtype == torch.float32
    _check(got, want, dtype, "rglru_forward")
    _check(gst["h"], wst["h"], dtype, "state h")
    np.testing.assert_array_equal(_f32(gst["conv"]), _f32(wst["conv"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_rglru_decode_matches_jax(dtype):
    """One O(1) step from a random state, then nine more fed back."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_module_params(jcfg, seed=2))
    rng = np.random.default_rng(3)
    w = jcfg.lru_width
    x = rng.standard_normal((3, 10, jcfg.d_model)).astype(np.float32)
    h = rng.standard_normal((3, w)).astype(np.float32)
    conv = rng.standard_normal((3, jcfg.conv_width - 1, w)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jcfg.dtype), torch.from_numpy(x).to(tcfg.dtype)
    jh, jc = jnp.asarray(h), jnp.asarray(conv).astype(jcfg.dtype)
    th, tc = torch.from_numpy(h), torch.from_numpy(conv).to(tcfg.dtype)
    th0 = th.clone()
    for t in range(10):
        wo, jh, jc = jrg.rglru_decode(jcfg, jp, jx[:, t:t + 1], jh, jc)
        go, th_new, tc = trg.rglru_decode(tcfg, tp, tx[:, t:t + 1], th, tc)
        if t == 0:
            assert torch.equal(th, th0)            # inputs are not modified
        th = th_new
        _check(go, wo, dtype, f"step {t}")
    _check(th, jh, dtype, "h")
    _check(tc, jc, dtype, "conv")


def test_torch_linear_scan_matches_a_sequential_loop():
    """The doubling scan against h_t = a_t h_{t-1} + b_t one step at a time,
    float32, at S = 1 000 (ten doubling steps, not a power of two), with
    retentions a in [0.5, 0.999) over 256 channels."""
    rng = np.random.default_rng(4)
    S = 1000
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (2, S, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, S, 256)).astype(np.float32))
    got = trg.linear_scan(a, b, dim=1)
    h = torch.zeros((2, 256))
    want = torch.empty_like(b)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err


def test_torch_linear_scan_matches_jax_associative_scan():
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 0.999, (3, 77, 16)).astype(np.float32)
    b = rng.standard_normal((3, 77, 16)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)),
                                       axis=1)
    got = trg.linear_scan(torch.from_numpy(a), torch.from_numpy(b), dim=1)
    _check(got, want, "f32", "scan")


def test_torch_init_rglru_shapes_and_constants_equal_reference():
    jcfg, cfg = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    want = jax.tree.map(np.asarray, jrg.init_rglru(jcfg, KeyGen(jax.random.PRNGKey(0))))
    got = trg.init_rglru(cfg, torch.Generator(device="cpu").manual_seed(0),
                         torch.float32)
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
    np.testing.assert_allclose(got["rg_a"].numpy(), want["rg_a"], rtol=1e-5)
    assert not got["conv_b"].any()
    for name in ("w_r", "w_i"):                     # scale 0.5 / sqrt(fan_in)
        w = got[name]
        assert abs(float(w.std()) * np.sqrt(w.shape[0]) / 0.5 - 1.0) < 0.1, name


def test_torch_hybrid_groups_state_and_conversion():
    """17 groups at full size, [rglru x2, attn(window 2048) x1] x8 +
    [rglru x2], as the reference's; the decode state holds ``h``/``conv``
    for the recurrent groups and rings for the attention ones, in the
    reference's shapes; the reference's tree converts leaf for leaf."""
    for which in ("get_config", "get_smoke_config"):
        ours = tm.layer_groups(getattr(tconfigs, which)(ARCH))
        theirs = jax_layer_groups(getattr(jconfigs, which)(ARCH))
        assert [dataclasses.astuple(g) for g in ours] == \
            [dataclasses.astuple(g) for g in theirs]
    full = tm.layer_groups(tconfigs.get_config(ARCH))
    assert len(full) == 17
    assert [(g.kind, g.n_layers, g.window) for g in full] == \
        [("rglru", 2, None), ("attn", 1, 2048)] * 8 + [("rglru", 2, None)]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), n_layers=8)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), n_layers=8)
    ours = tm.init_decode_state(cfg, 3, 12, 4, device="cpu")
    theirs = jm.init_decode_state(jcfg, 3, 12, 4)
    assert [sorted(c) for c in ours.caches] == [sorted(c) for c in theirs.caches]
    assert [sorted(c) for c in ours.caches[:2]] == [["conv", "h"],
                                                    ["ring_k", "ring_v"]]
    for c, jc in zip(ours.caches, theirs.caches):
        for name, t in c.items():
            assert tuple(t.shape) == jc[name].shape and not t.any(), name
            assert str(t.dtype).replace("torch.", "") == jc[name].dtype.name
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(1)))
    params = tm.params_from_jax(cfg, tree, device="cpu")
    assert [len(gp) for gp in params["groups"]] == [2, 1, 2, 1, 2]
    for gp, jgp in zip(params["groups"], tree["groups"]):
        for i, layer in enumerate(gp):
            assert sorted(layer) == sorted(jgp)
            for part, leaves in layer.items():
                for name, leaf in leaves.items():
                    np.testing.assert_array_equal(leaf.numpy(), jgp[part][name][i])
    fresh = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    assert sorted(fresh["groups"][0][0]) == ["ffn", "norm1", "norm2", "rglru"]
    assert sorted(fresh["groups"][1][0]) == ["attn", "ffn", "norm1", "norm2"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_hybrid_prefill_and_decode_match_jax(dtype):
    """Prefill 40 tokens (past the 32-token window), then 12 decode steps:
    logits after each, and at the end the rings and the recurrent states,
    with a padding row (all -1 table) in the batch."""
    jcfg, tcfg, jparams, tparams = _setup(ARCH, dtype)
    B, P, STEPS = 3, 40, 12
    bt = jcfg.kv_block_tokens
    MB = (P + STEPS + bt - 1) // bt + 1
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    phys = rng.permutation(B * MB).astype(np.int32).reshape(B, MB)
    phys[-1] = -1
    jstate = jm.init_decode_state(jcfg, B, B * MB, MB)
    tstate = tm.init_decode_state(tcfg, B, B * MB, MB, device="cpu")
    jl, jstate = jm.prefill(jcfg, jparams, jnp.asarray(tokens), jstate,
                            jnp.asarray(phys))
    tl, tstate = tm.prefill(tcfg, tparams, torch.from_numpy(tokens), tstate,
                            torch.from_numpy(phys))
    _check(tl, jl, dtype, "prefill logits")
    for step in range(STEPS):
        jtok = jm.greedy_sample(jl)
        jl, jstate = jm.decode_step(jcfg, jparams, jstate, jtok, jnp.asarray(phys))
        tl, tstate = tm.decode_step(tcfg, tparams, tstate,
                                    torch.from_numpy(np.array(jtok)),
                                    torch.from_numpy(phys))
        _check(tl, jl, dtype, f"decode step {step}")
    for gi, (c, jc) in enumerate(zip(tstate.caches, jstate.caches)):
        for name in c:
            _check(c[name], jc[name], dtype, f"{name}[{gi}]")
    assert _f32(tstate.seq_lens).tolist() == [P + STEPS] * B


def test_torch_hybrid_decode_matches_forward():
    """bf16: prefill 47 tokens (past the window), one decode step, against
    the full forward's last logits (rel < 0.03, tests/test_models.py)."""
    _, tcfg, _, tparams = _setup(ARCH, "bf16")
    S = 48
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, S)).astype(np.int32))
    want = tm.forward_lm(tcfg, tparams, tokens)[0][:, -1].float()
    MB = S // tcfg.kv_block_tokens + 2
    state = tm.init_decode_state(tcfg, 2, 2 * MB, MB, device="cpu")
    phys = torch.arange(2 * MB, dtype=torch.int32).reshape(2, MB)
    _, state = tm.prefill(tcfg, tparams, tokens[:, :S - 1], state, phys)
    got, _ = tm.decode_step(tcfg, tparams, state, tokens[:, S - 1], phys)
    rel = float((want - got.float()).abs().max() / want.abs().max())
    assert rel < 0.03, rel


def test_torch_hybrid_prefill_rewrites_every_state():
    """The state is shared by every wave and the warm-up: a second prefill
    of other prompts leaves exactly what a prefill into fresh zeros does."""
    _, tcfg, _, tparams = _setup(ARCH, "f32")
    rng = np.random.default_rng(4)
    first, second = (torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, S)
                                                   ).astype(np.int32))
                     for S in (40, 20))
    phys = torch.arange(2 * 6, dtype=torch.int32).reshape(2, 6)
    used = tm.init_decode_state(tcfg, 2, 12, 6, device="cpu")
    tm.prefill(tcfg, tparams, first, used, phys)
    fresh = tm.init_decode_state(tcfg, 2, 12, 6, device="cpu")
    tm.prefill(tcfg, tparams, second, used, phys)
    tm.prefill(tcfg, tparams, second, fresh, phys)
    for c, f in zip(used.caches, fresh.caches):
        for name in c:
            assert torch.equal(c[name], f[name]), name


RUN = dict(n_requests=5, prompt_len=40, gen_len=6, batch=2, seed=0, n_pods=4)
COUNTERS = ("mode", "n_pods", "tokens", "invalidations_sent",
            "invalidations_filtered", "coherence_bytes", "fetches",
            "prefetched", "table_pages")


@pytest.fixture(scope="module")
def port_runs():
    """The port's serve() on the reference's weights for seed 0, three modes
    (prompts of 40 tokens pass the 32-token window)."""
    tree = jax.tree.map(np.asarray, jm.init_params(
        jconfigs.get_smoke_config(ARCH), jax.random.PRNGKey(RUN["seed"])))
    params = tm.params_from_jax(tconfigs.get_smoke_config(ARCH), tree, device="cpu")
    return {mode: serve(ARCH, mode=mode, device="cpu", params=params,
                        verbose=False, **RUN)
            for mode in ("local", "eager", "numapte")}


@pytest.mark.parametrize("mode", ["local", "eager", "numapte"])
def test_torch_hybrid_serve_counters_equal_reference(port_runs, mode):
    want = jax_serve(ARCH, mode=mode, verbose=False, **RUN)
    got = port_runs[mode]
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert got["logits_finite"] and got["device"] == "cpu"
    assert got["token_ids"].shape == (RUN["n_requests"], RUN["gen_len"])


def test_torch_hybrid_serve_tokens_equal_across_modes(port_runs):
    ids = [port_runs[m]["token_ids"] for m in ("local", "eager", "numapte")]
    assert np.array_equal(ids[0], ids[1]) and np.array_equal(ids[0], ids[2])
    assert len(np.unique(ids[0])) > 4            # not one constant token
