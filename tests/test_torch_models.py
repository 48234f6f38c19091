"""Models of the port against the JAX package on converted weights.

Weights come from ``repro.models.init_params`` -> numpy; every norm and
qk-norm scale is overwritten with seeded noise first (they initialise to 0,
which would hide the ``1 + scale`` form).  ``params_from_jax`` turns the
numpy pytree into the port's parameters.  float32 runs compare to atol 2e-4
(sums taken in another order) with equal greedy tokens; bfloat16 runs to
rel < 0.03, the bound of tests/test_models.py (bf16 rounds at other places
in the two frameworks, and the reference's default path rounds the
probabilities to bf16 where the kernels keep float32).

A mixture-of-experts layer routes each token to its top-k experts.  In
bfloat16 the two frameworks' hidden states differ by an ulp or two, and
where two experts' router probabilities lie closer than that, the top-k
flips and the token takes another expert's output.  So the MoE forward test
records the reference's routes, requires the port's own routes to equal them
(float32) or to differ only at such near-ties (bfloat16), and compares the
logits with the port following the reference's routes.
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.models.common import require_ported  # noqa: E402

ARCHS = ["yi_6b", "qwen3_14b", "qwen3_moe_235b_a22b", "kimi_k2_1t_a32b",
         "nemotron_4_15b", "chameleon_34b"]
# the recurrent families (their prefill / decode parity lives in
# test_torch_ssm.py and test_torch_rglru.py) and the encoder-decoder
# (test_torch_whisper.py)
RECURRENT = ["mamba2_370m", "recurrentgemma_2b"]
ALL_ARCHS = ARCHS + ["gemma3_4b"] + RECURRENT + ["whisper_base"]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S, STEPS = 2, 24, 3


def _setup(arch: str, dtype: str):
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=jd)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=td)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)

    def perturb(node, path=""):
        if isinstance(node, dict):
            return {k: perturb(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v, path) for v in node]
        if "norm" in path:
            return rng.normal(0.0, 0.3, node.shape).astype(np.float32)
        return node

    tree = perturb(tree)
    assert np.abs(tree["groups"][0]["norm1"]["scale"]).max() > 0
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = tm.params_from_jax(tcfg, tree, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype: str, what: str):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-4, err_msg=what)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 0.03, (what, rel)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS + RECURRENT + ["whisper_base"])
def test_torch_forward_lm_matches_jax(arch, dtype, monkeypatch):
    """forward_lm logits (forward_encdec's for the encoder-decoder, on
    frame embeddings from the seed) against the reference's."""
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    if jcfg.n_experts:
        _follow_reference_routes(monkeypatch, dtype)
    if jcfg.family == "encdec":
        feats = rng.standard_normal((B, 2 * S, jcfg.d_model)).astype(np.float32)
        want, want_aux = jm.forward_encdec(jcfg, jparams, jnp.asarray(feats),
                                           jnp.asarray(tokens), remat=False)
        got, aux = tm.forward_encdec(tcfg, tparams, torch.from_numpy(feats),
                                     torch.from_numpy(tokens))
    else:
        want, want_aux = jm.forward_lm(jcfg, jparams, jnp.asarray(tokens),
                                       remat=False)
        got, aux = tm.forward_lm(tcfg, tparams, torch.from_numpy(tokens))
    if jcfg.n_experts:
        _check_own_routes(dtype)
    assert got.dtype == tcfg.dtype and aux.dtype == torch.float32
    if jcfg.n_experts:          # the MoE layers' summed load-balance loss
        assert float(aux) > 0.0
        _close(aux, want_aux, dtype, "forward_lm aux")
    else:
        assert float(aux) == 0.0 == float(want_aux)
    _close(got, want, dtype, "forward_lm logits")


_ROUTES = {"reference": [], "port": []}


def _follow_reference_routes(monkeypatch, dtype):
    """Record each MoE call's routes on both sides; the port's MoE then
    takes the reference's expert ids (its gates renormalised from its own
    probabilities), so that a flip at a near-tie does not move the logits."""
    from repro.models import transformer as jt
    from repro_torch.models import moe as tmoe
    ref_seen, port_seen = [], []
    _ROUTES.update(reference=ref_seen, port=port_seen)
    ref_moe, port_route = jt.moe_forward, tmoe.route

    def recording(cfg, p, x):
        xf = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(
            (xf @ p["router"].astype(cfg.dtype)).astype(jnp.float32), axis=-1)
        _, eids = jax.lax.top_k(probs, cfg.experts_per_token)
        jax.debug.callback(lambda e: ref_seen.append(np.array(e)), eids,
                           ordered=True)
        return ref_moe(cfg, p, x)

    def following(cfg, p, xf):
        own = port_route(cfg, p, xf)
        port_seen.append(own)
        eids = torch.from_numpy(ref_seen[len(port_seen) - 1]).long()
        gates = own.probs.gather(1, eids)
        return tmoe.Routes(own.probs, eids, gates / gates.sum(-1, keepdim=True))

    monkeypatch.setattr(jt, "moe_forward", recording)
    monkeypatch.setattr(tmoe, "route", following)


def _check_own_routes(dtype):
    ref_seen, port_seen = _ROUTES["reference"], _ROUTES["port"]
    jax.effects_barrier()
    assert len(ref_seen) == len(port_seen) > 0
    from repro_torch.models.moe import NEAR_TIE, route_flips
    flips = n = 0
    for want, own in zip(ref_seen, port_seen):
        n += want.size
        if dtype == "f32":
            np.testing.assert_array_equal(own.eids.numpy(), want)
            continue
        f, gap = route_flips(own.probs, own.eids, torch.from_numpy(want).long())
        flips += f
        assert gap < NEAR_TIE, f"a route flipped at no near-tie: gap {gap}"
    assert flips <= 0.05 * n, (flips, n)


@pytest.mark.parametrize("kernel", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_prefill_and_decode_match_jax(arch, dtype, kernel):
    """prefill logits and slabs, then three decode steps, against the
    reference's default decode (kernel="ref") and against the path that
    calls its Pallas kernel (kernel="pallas", interpret mode)."""
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype)
    bt = jcfg.kv_block_tokens
    MB = (S + STEPS + bt - 1) // bt + 1
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (B + 1, S)).astype(np.int32)
    # scattered frames, and a padding row (all -1) at the end of the batch
    phys = rng.permutation((B + 1) * MB).astype(np.int32).reshape(B + 1, MB)
    phys[-1] = -1
    n_frames = (B + 1) * MB

    jstate = jm.init_decode_state(jcfg, B + 1, n_frames, MB)
    tstate = tm.init_decode_state(tcfg, B + 1, n_frames, MB, device="cpu")
    jlogits, jstate = jm.prefill(jcfg, jparams, jnp.asarray(tokens), jstate,
                                 jnp.asarray(phys))
    tlogits, tstate = tm.prefill(tcfg, tparams, torch.from_numpy(tokens), tstate,
                                 torch.from_numpy(phys))
    _close(tlogits[:B], jlogits[:B], dtype, "prefill logits")
    for name in ("k_slabs", "v_slabs"):
        _close(tstate.caches[0][name], jstate.caches[0][name], dtype, name)
    assert _f32(tstate.seq_lens).tolist() == [S] * (B + 1)

    jtok = jm.greedy_sample(jlogits)
    ttok = tm.greedy_sample(tlogits)
    for step in range(STEPS):
        if dtype == "f32":
            np.testing.assert_array_equal(ttok[:B].numpy(), np.asarray(jtok)[:B])
        else:                   # bf16 logits tie: feed both the same tokens
            ttok = torch.from_numpy(np.array(jtok))
        jlogits, jstate = jm.decode_step(jcfg, jparams, jstate, jtok,
                                         jnp.asarray(phys), kernel=kernel)
        tlogits, tstate = tm.decode_step(tcfg, tparams, tstate, ttok,
                                         torch.from_numpy(phys))
        _close(tlogits[:B], jlogits[:B], dtype, f"decode step {step} logits")
        assert torch.isfinite(tlogits.float()).all()       # padding row too
        jtok, ttok = jm.greedy_sample(jlogits), tm.greedy_sample(tlogits)
    for name in ("k_slabs", "v_slabs"):
        _close(tstate.caches[0][name], jstate.caches[0][name], dtype, name)
    assert _f32(tstate.seq_lens).tolist() == [S + STEPS] * (B + 1)


@pytest.mark.parametrize("arch", ARCHS + RECURRENT)
def test_torch_decode_matches_forward(arch):
    """test_decode_matches_forward inside the port: prefill S-1 tokens, one
    paged decode step, against the full forward's last logits."""
    _, tcfg, _, tparams = _setup(arch, "bf16")
    Bq, Sq = 2, 48
    bt = tcfg.kv_block_tokens
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (Bq, Sq)).astype(np.int32))
    want = tm.forward_lm(tcfg, tparams, tokens)[0][:, -1].float()
    MB = (Sq + bt - 1) // bt + 1
    state = tm.init_decode_state(tcfg, Bq, Bq * MB, MB, device="cpu")
    phys = torch.arange(Bq * MB, dtype=torch.int32).reshape(Bq, MB)
    _, state = tm.prefill(tcfg, tparams, tokens[:, :Sq - 1], state, phys)
    got, _ = tm.decode_step(tcfg, tparams, state, tokens[:, Sq - 1], phys)
    rel = float((want - got.float()).abs().max() / want.abs().max())
    assert rel < 0.03, rel


def test_torch_init_params_shapes_types_and_statistics():
    cfg = tconfigs.get_smoke_config("qwen3_14b")
    jshapes = jax.eval_shape(lambda k: jm.init_params(
        jconfigs.get_smoke_config("qwen3_14b"), k), jax.random.PRNGKey(0))
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = tm.init_params(cfg, gen)
    again = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    assert torch.equal(params["lm_head"], again["lm_head"])     # seeded
    assert params["embedding"].dtype == torch.float32
    assert tuple(params["embedding"].shape) == jshapes["embedding"].shape
    assert tuple(params["lm_head"].shape) == jshapes["lm_head"].shape
    layers = params["groups"][0]
    assert len(layers) == cfg.n_layers
    for name, leaf in jshapes["groups"][0]["attn"].items():
        assert tuple(layers[0]["attn"][name].shape) == leaf.shape[1:], name
    for name, leaf in jshapes["groups"][0]["ffn"].items():
        assert tuple(layers[1]["ffn"][name].shape) == leaf.shape[1:], name
    assert float(layers[0]["norm1"]["scale"].abs().max()) == 0.0
    w = layers[0]["ffn"]["w_in"]                                # std 1/sqrt(fan_in)
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05
    bf16 = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0),
                          param_dtype=torch.bfloat16)
    assert bf16["embedding"].dtype == torch.bfloat16
    assert torch.equal(bf16["embedding"], params["embedding"].to(torch.bfloat16))


def test_torch_windowed_config_is_ported():
    """Local-window attention (ROADMAP item 10) no longer raises: a
    local : global pattern passes ``require_ported``, and its parameters and
    decode state (a ring per windowed group) are built."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("yi_6b"),
                              local_window=8, local_global_ratio=(1, 1))
    groups = require_ported(cfg)
    assert [(g.window, g.n_layers) for g in groups] == [(8, 1), (None, 1)]
    params = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    assert [len(gp) for gp in params["groups"]] == [1, 1]
    state = tm.init_decode_state(cfg, 3, 8, 4, device="cpu")
    assert tuple(state.caches[0]["ring_k"].shape) == (1, 3, 8, 2, 16)
    assert tuple(state.caches[1]["k_slabs"].shape) == (1, 8, 16, 2, 16)


def test_torch_moe_config_is_ported():
    """The mixture-of-experts FFN (ROADMAP item 11's first entry) no longer
    raises: an MoE config passes ``require_ported``, and ``init_params``
    builds ``moe`` layers (after ``first_dense_layers`` dense ones)."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("yi_6b"), n_experts=4,
                              experts_per_token=2, moe_d_ff=32,
                              first_dense_layers=1)
    groups = require_ported(cfg)
    assert [(g.moe, g.n_layers) for g in groups] == [(False, 1), (True, 1)]
    params = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    dense, moe = params["groups"][0][0], params["groups"][1][0]
    assert "ffn" in dense and "moe" not in dense
    assert "moe" in moe and "ffn" not in moe
    assert tuple(moe["moe"]["we_in"].shape) == (4, 64, 32)
    assert tuple(moe["moe"]["router"].shape) == (64, 4)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_torch_smoke_forward_shapes_and_finiteness(arch):
    """Every arch's smoke config, on the port's own seeded weights: logits
    [B,S,V] (decoder positions for the encoder-decoder), finite, in the
    working dtype; the reference's test_smoke_forward_and_train_step checks
    the same of its forward."""
    cfg = tconfigs.get_smoke_config(arch)
    params = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    gen = torch.Generator(device="cpu").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    if cfg.family == "encdec":
        feats = torch.randn((B, 40, cfg.d_model), generator=gen)
        logits, aux = tm.forward_encdec(cfg, params, feats, tokens)
    else:
        logits, aux = tm.forward_lm(cfg, params, tokens)
    assert tuple(logits.shape) == (B, S, cfg.vocab_size)
    assert logits.dtype == cfg.dtype and torch.isfinite(logits.float()).all()
    assert torch.isfinite(aux) and (float(aux) > 0) == (cfg.n_experts > 0)


@pytest.mark.parametrize("prim", ["rms_norm", "apply_rope", "rope_frequencies",
                                  "silu", "geglu", "gelu", "relu2", "ffn_forward",
                                  "layer_norm"])
def test_torch_primitives_match_jax(prim):
    """The shared primitives one by one, float32, same numpy inputs."""
    from repro.models import common as jc
    from repro.models.ffn import ffn_forward as jax_ffn
    from repro_torch.models import common as tc
    from repro_torch.models.ffn import ffn_forward
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    g = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    if prim == "rms_norm":
        scale = rng.normal(0, 0.3, 16).astype(np.float32)
        got = tc.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
        want = jc.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    elif prim == "apply_rope":
        pos = rng.integers(0, 5000, (2, 6)).astype(np.int32)
        got = tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
        want = jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    elif prim == "layer_norm":
        scale = rng.normal(1.0, 0.3, 16).astype(np.float32)
        bias = rng.normal(0.0, 0.3, 16).astype(np.float32)
        got = tc.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias))
        want = jc.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    elif prim == "rope_frequencies":
        got, want = tc.rope_frequencies(128, 1e6), jc.rope_frequencies(128, 1e6)
    elif prim == "ffn_forward":
        jcfg = dataclasses.replace(jconfigs.get_smoke_config("yi_6b"), dtype=jnp.float32)
        tcfg = dataclasses.replace(tconfigs.get_smoke_config("yi_6b"), dtype=torch.float32)
        p = {k: (rng.standard_normal(s) / 8).astype(np.float32) for k, s in
             [("w_in", (64, 160)), ("w_gate", (64, 160)), ("w_out", (160, 64))]}
        h = rng.standard_normal((2, 5, 64)).astype(np.float32)
        got = ffn_forward(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(h))
        want = jax_ffn(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h))
    else:
        assert tc.ffn_has_gate(prim) == jc.ffn_has_gate(prim)
        got = tc.activation(prim, torch.from_numpy(x), torch.from_numpy(g))
        want = jc.activation(prim, jnp.asarray(x), jnp.asarray(g))
    # apply_rope: float32 sin/cos of angles up to 5000 rad differ in the last bits
    atol = 2e-4 if prim == "apply_rope" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=1e-5)
