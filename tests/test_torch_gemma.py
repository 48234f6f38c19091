"""Gemma-3 in the port against the JAX package: local-window layers with
ring caches beside global layers with paged slabs.

The smoke config (6 layers: 5 local with window 32, then 1 global; head_dim
16) runs on converted weights, with the norms perturbed as in
``test_torch_models._setup``.  Sequences are longer than the window, so the
rings wrap.  float32 compares to atol 2e-4, bfloat16 to rel < 0.03 (the
bounds of ``test_torch_models``).
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
from repro.models.attention import attn_decode_ring as jax_decode_ring  # noqa: E402
from repro.models.common import layer_groups as jax_layer_groups  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.attention import attn_decode_ring  # noqa: E402
from repro_torch.models.common import (layer_groups, require_ported,  # noqa: E402
                                       rope_tables)
from test_torch_models import _close, _f32, _setup  # noqa: E402

ARCH = "gemma3_4b"
W = 32                        # the smoke config's window
B, S = 2, 48                  # S > W: the rings wrap


def _phys(rng, rows: int, MB: int, padding_row: bool) -> np.ndarray:
    phys = rng.permutation(rows * MB).astype(np.int32).reshape(rows, MB)
    if padding_row:
        phys[-1] = -1
    return phys


def test_torch_gemma_layer_groups_equal_reference():
    """11 groups at full size (five runs of 5 local + 1 global, then 4
    local), each with the reference's window and theta; the smoke config's
    two groups likewise."""
    for which in ("get_config", "get_smoke_config"):
        ours = layer_groups(getattr(tconfigs, which)(ARCH))
        theirs = jax_layer_groups(getattr(jconfigs, which)(ARCH))
        assert [dataclasses.astuple(g) for g in ours] == \
            [dataclasses.astuple(g) for g in theirs]
    full = require_ported(tconfigs.get_config(ARCH))
    assert [g.n_layers for g in full] == [5, 1] * 5 + [4]
    assert [g.window for g in full] == [1024, None] * 5 + [1024]
    assert [g.rope_theta for g in full] == [1e4, 1e6] * 5 + [1e4]


def test_torch_gemma_decode_state_has_rings_and_slabs():
    """Windowed groups get ``ring_k``/``ring_v`` [L,B,W,K,hd], global groups
    paged slabs, in the reference's shapes; all zeros."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), n_layers=12)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), n_layers=12)
    ours = tm.init_decode_state(cfg, 3, 20, 5, device="cpu")
    theirs = jm.init_decode_state(jcfg, 3, 20, 5)
    assert [sorted(c) for c in ours.caches] == [sorted(c) for c in theirs.caches]
    assert [sorted(c) for c in ours.caches[:2]] == [["ring_k", "ring_v"],
                                                    ["k_slabs", "v_slabs"]]
    for c, jc in zip(ours.caches, theirs.caches):
        for name, t in c.items():
            assert tuple(t.shape) == jc[name].shape, name
            assert t.dtype == cfg.dtype and not t.any(), name


def test_torch_gemma_params_from_jax_carries_every_group():
    """The reference stacks each of its groups [L, ...]; every layer of every
    group arrives in the port's per-layer lists, leaf for leaf (14 layers:
    groups of 5, 1, 5, 1, 2)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), n_layers=14)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), n_layers=14)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(3)))
    params = tm.params_from_jax(cfg, tree, device="cpu")
    assert [len(gp) for gp in params["groups"]] == [5, 1, 5, 1, 2]
    assert "lm_head" not in params                 # tied embeddings
    for gp, jgp in zip(params["groups"], tree["groups"]):
        for i, layer in enumerate(gp):
            for part in ("attn", "ffn", "norm1", "norm2"):
                for name, leaf in layer[part].items():
                    np.testing.assert_array_equal(leaf.numpy(),
                                                  jgp[part][name][i])
    np.testing.assert_array_equal(params["embedding"].numpy(), tree["embedding"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_gemma_forward_lm_matches_jax(dtype):
    jcfg, tcfg, jparams, tparams = _setup(ARCH, dtype)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = jm.forward_lm(jcfg, jparams, jnp.asarray(tokens), remat=False)
    got, aux = tm.forward_lm(tcfg, tparams, torch.from_numpy(tokens))
    assert got.dtype == tcfg.dtype and float(aux) == 0.0
    _close(got, want, dtype, "forward_lm logits")


def _rings(state):
    return {f"{name}[{gi}]": c[name] for gi, c in enumerate(state.caches)
            for name in ("ring_k", "ring_v") if name in c}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_gemma_prefill_and_decode_match_jax(dtype):
    """Prefill 47 tokens (the rings wrap once), then 20 decode steps
    (positions 47-66: the rings wrap again at 64): logits after prefill and
    after every step, the rings and the global layer's slabs, with a
    padding row (all -1 table) at the end of the batch."""
    jcfg, tcfg, jparams, tparams = _setup(ARCH, dtype)
    P, STEPS = S - 1, 20
    bt = jcfg.kv_block_tokens
    MB = (P + STEPS + bt - 1) // bt + 1
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (B + 1, P)).astype(np.int32)
    phys = _phys(rng, B + 1, MB, padding_row=True)
    n_frames = (B + 1) * MB
    jstate = jm.init_decode_state(jcfg, B + 1, n_frames, MB)
    tstate = tm.init_decode_state(tcfg, B + 1, n_frames, MB, device="cpu")
    jlogits, jstate = jm.prefill(jcfg, jparams, jnp.asarray(tokens), jstate,
                                 jnp.asarray(phys))
    tlogits, tstate = tm.prefill(tcfg, tparams, torch.from_numpy(tokens),
                                 tstate, torch.from_numpy(phys))
    _close(tlogits[:B], jlogits[:B], dtype, "prefill logits")

    def compare_caches(when):
        want = _rings(jstate)
        for name, got in _rings(tstate).items():
            _close(got, want[name], dtype, f"{name} {when}")
            if dtype == "f32":      # element for element, to f32 rounding
                np.testing.assert_allclose(_f32(got), _f32(want[name]),
                                           atol=2e-5, err_msg=name)
            # the same slots are filled (zeros where no token has landed)
            assert np.array_equal(_f32(got) == 0, _f32(want[name]) == 0), name
        for name in ("k_slabs", "v_slabs"):
            _close(tstate.caches[1][name], jstate.caches[1][name], dtype,
                   f"{name} {when}")

    compare_caches("after prefill")
    step = jax.jit(lambda p, s, t, pb: jm.decode_step(jcfg, p, s, t, pb))
    jtok, ttok = jm.greedy_sample(jlogits), tm.greedy_sample(tlogits)
    for i in range(STEPS):
        if dtype == "f32":
            np.testing.assert_array_equal(ttok[:B].numpy(), np.asarray(jtok)[:B])
        # both get the same tokens: bf16 logits tie, and the padding row's
        # differ (queue 3: the reference's dead row takes the mean of V)
        ttok = torch.from_numpy(np.array(jtok))
        jlogits, jstate = step(jparams, jstate, jtok, jnp.asarray(phys))
        tlogits, tstate = tm.decode_step(tcfg, tparams, tstate, ttok,
                                         torch.from_numpy(phys))
        _close(tlogits[:B], jlogits[:B], dtype, f"decode step {i} logits")
        assert torch.isfinite(tlogits.float()).all()         # padding row too
        jtok, ttok = jm.greedy_sample(jlogits), tm.greedy_sample(tlogits)
    compare_caches(f"after {STEPS} steps")
    assert _f32(tstate.seq_lens).tolist() == [P + STEPS] * (B + 1)


def test_torch_gemma_decode_matches_forward():
    """test_decode_matches_forward inside the port: prefill S-1 tokens (past
    the window), one decode step, against the full forward's last logits."""
    _, tcfg, _, tparams = _setup(ARCH, "bf16")
    bt = tcfg.kv_block_tokens
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32))
    want = tm.forward_lm(tcfg, tparams, tokens)[0][:, -1].float()
    MB = (S + bt - 1) // bt + 1
    state = tm.init_decode_state(tcfg, B, B * MB, MB, device="cpu")
    phys = torch.arange(B * MB, dtype=torch.int32).reshape(B, MB)
    _, state = tm.prefill(tcfg, tparams, tokens[:, :S - 1], state, phys)
    got, _ = tm.decode_step(tcfg, tparams, state, tokens[:, S - 1], phys)
    rel = float((want - got.float()).abs().max() / want.abs().max())
    assert rel < 0.03, rel


def test_torch_attn_decode_ring_matches_jax():
    """One ring decode alone, float32, at positions before the window is
    full (5), at its last slot (W - 1), just past it (W + 8) and after many
    wraps (100): output, and the rings updated in place (the new token's
    slot written, every other slot untouched)."""
    jcfg, tcfg, jparams, tparams = _setup(ARCH, "f32")
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][0]["attn"])
    tp = tparams["groups"][0][0]["attn"]
    K, hd, D = tcfg.n_kv_heads, tcfg.resolved_head_dim, tcfg.d_model
    rng = np.random.default_rng(4)
    positions = np.array([5, W - 1, W + 8, 100], np.int32)
    n = len(positions)
    x = rng.standard_normal((n, 1, D)).astype(np.float32)
    rk = rng.standard_normal((n, W, K, hd)).astype(np.float32)
    rv = rng.standard_normal((n, W, K, hd)).astype(np.float32)
    want, wk, wv = jax_decode_ring(jcfg, jp, jnp.asarray(x), jnp.asarray(positions),
                                   jnp.asarray(rk), jnp.asarray(rv),
                                   rope_theta=1e4, window=W)
    tk, tv = torch.from_numpy(rk.copy()), torch.from_numpy(rv.copy())
    pos = torch.from_numpy(positions)
    got, gk, gv = attn_decode_ring(
        tcfg, tp, torch.from_numpy(x), pos, tk, tv,
        rope=rope_tables(pos[:, None], hd, 1e4), window=W)
    assert gk is tk and gv is tv                          # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    slots = positions % W
    for g, w, before in ((gk, wk, rk), (gv, wv, rv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-5)
        keep = np.ones((n, W), bool)
        keep[np.arange(n), slots] = False
        np.testing.assert_array_equal(g.numpy()[keep], before[keep])
        assert not np.allclose(g.numpy()[~keep], before[~keep])


def test_torch_gemma_prefill_rebuilds_the_rings(monkeypatch):
    """The port updates caches in place and serve() hands one state to every
    wave, so a prefill must rebuild each ring.  A prompt shorter than the
    window leaves slots unfilled: they must be zeros, as in a fresh state,
    not an earlier wave's keys; and a wave served after another (and after
    the warm-up, which writes the rings) gives the tokens that a fresh
    serve() of its prompts alone gives."""
    _, tcfg, _, tparams = _setup(ARCH, "f32")
    bt = tcfg.kv_block_tokens
    rng = np.random.default_rng(5)
    MB = 4
    phys = torch.arange(B * MB, dtype=torch.int32).reshape(B, MB)
    first = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, 40)))
    second = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, 20)))
    used = tm.init_decode_state(tcfg, B, B * MB, MB, device="cpu")
    _, st = tm.prefill(tcfg, tparams, first, used, phys)
    tm.decode_step(tcfg, tparams, st, first[:, 0], phys)
    fresh = tm.init_decode_state(tcfg, B, B * MB, MB, device="cpu")
    assert any(r.any() for r in _rings(used).values())
    got_logits, got = tm.prefill(tcfg, tparams, second, used, phys)
    want_logits, want = tm.prefill(tcfg, tparams, second, fresh, phys)
    assert torch.equal(got_logits, want_logits)
    for name, ring in _rings(got).items():
        assert torch.equal(ring, _rings(want)[name]), name
        assert not ring[:, :, 20:].any(), name             # unfilled slots

    # through serve(): wave 2 of a two-wave run against a run of wave 2 alone
    run = dict(prompt_len=20, gen_len=6, batch=B, n_pods=2, mode="numapte",
               device="cpu", params=tparams, verbose=False,
               cfg=dataclasses.replace(tcfg, dtype=torch.float32))
    both = serve(ARCH, n_requests=2 * B, **run)["token_ids"]
    real_rng = np.random.default_rng

    def skip_first_wave(seed):
        g = real_rng(seed)
        g.integers(0, tcfg.vocab_size, (B, run["prompt_len"]))
        return g

    monkeypatch.setattr(serve_mod.np.random, "default_rng", skip_first_wave)
    alone = serve(ARCH, n_requests=B, **run)["token_ids"]
    assert bt < run["prompt_len"] < W
    np.testing.assert_array_equal(both[B:], alone)
    assert not np.array_equal(both[:B], alone)


# ------------------------------------------------------------------ serving
RUN = dict(n_requests=5, prompt_len=40, gen_len=6, batch=2, seed=0)
COUNTERS = ("mode", "n_pods", "tokens", "invalidations_sent",
            "invalidations_filtered", "coherence_bytes", "fetches",
            "prefetched", "table_pages")


@pytest.fixture(scope="module")
def port_runs():
    """The port's serve() of Gemma's smoke config on the reference's weights
    for seed 0, converted, in every mode and pod count."""
    tree = jax.tree.map(np.asarray, jm.init_params(
        jconfigs.get_smoke_config(ARCH), jax.random.PRNGKey(RUN["seed"])))
    params = tm.params_from_jax(tconfigs.get_smoke_config(ARCH), tree,
                                device="cpu")
    return {(mode, n_pods): serve(ARCH, mode=mode, n_pods=n_pods,
                                  device="cpu", params=params,
                                  verbose=False, **RUN)
            for mode in ("local", "eager", "numapte") for n_pods in (1, 4)}


@pytest.mark.parametrize("n_pods", [1, 4])
@pytest.mark.parametrize("mode", ["local", "eager", "numapte"])
def test_torch_gemma_serve_counters_equal_reference(port_runs, mode, n_pods):
    want = jax_serve(ARCH, mode=mode, n_pods=n_pods, verbose=False, **RUN)
    got = port_runs[(mode, n_pods)]
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert got["logits_finite"] and got["n_layers"] == 6
    assert got["token_ids"].shape == (RUN["n_requests"], RUN["gen_len"])
    if mode == "numapte":
        assert (got["fetches"] > 0) == (n_pods > 1)


@pytest.mark.parametrize("n_pods", [1, 4])
def test_torch_gemma_serve_tokens_equal_across_modes(port_runs, n_pods):
    ids = [port_runs[(mode, n_pods)]["token_ids"]
           for mode in ("local", "eager", "numapte")]
    assert np.array_equal(ids[0], ids[1]) and np.array_equal(ids[0], ids[2])
    assert np.array_equal(ids[0], port_runs[("local", 5 - n_pods)]["token_ids"])
    assert len(np.unique(ids[0])) > 4            # not one constant token
