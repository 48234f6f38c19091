"""Whisper's encoder-decoder in the port against the JAX package.

The smoke config (2 encoder + 2 decoder layers, layernorm, no RoPE,
sinusoidal encoder positions, learned decoder positions, cross-attention)
runs on converted weights with the norms perturbed as in
``test_torch_models._setup`` (layernorm's scale and bias both).  The audio
frontend is a stub in the reference too: frame embeddings come from a seeded
numpy generator.  float32 within 1e-5 of the largest magnitude, bfloat16
within rel 0.03.
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
from repro.models import common as jc  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from test_torch_models import _setup  # noqa: E402
from test_torch_ssm import _check  # noqa: E402

ARCH = "whisper_base"
B, SE = 2, 32


def _inputs(cfg, Sd: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, SE, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, Sd)).astype(np.int32)
    return feats, tokens


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    scale = rng.normal(1.0, 0.3, 64).astype(np.float32)
    bias = rng.normal(0.0, 0.3, 64).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jc.layer_norm(jnp.asarray(x).astype(jd), jnp.asarray(scale), jnp.asarray(bias))
    got = tc.layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(scale),
                        torch.from_numpy(bias))
    assert got.dtype == td
    _check(got, want, dtype, "layer_norm")
    cfg = tconfigs.get_smoke_config(ARCH)
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    assert torch.equal(tc.apply_norm(cfg, torch.from_numpy(x).to(td), p), got)
    norm = tc.init_norm(cfg, 8, torch.float32, "cpu")
    assert torch.equal(norm["scale"], torch.ones(8)) and not norm["bias"].any()


@pytest.mark.parametrize("length", [32, 100])
def test_torch_sinusoids_match_jax(length):
    got = ttr._sinusoids(length, 64)
    want = jtr._sinusoids(length, 64)
    assert got.dtype == torch.float32
    _check(got, want, "f32", "sinusoids")


def test_torch_whisper_params_and_decode_state_equal_reference():
    """Parameter tree (``dec_pos``, ``dec_embedding``, ``enc_norm``; decoder
    layers with ``cross`` (no qk-norm) and ``norm_cross``) and decode state
    (no state for the encoder, cross K/V of ``enc_len`` frames beside the
    decoder's slabs) in the reference's shapes; conversion leaf for leaf."""
    jcfg, cfg = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    fresh = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    assert sorted(fresh) == sorted(tree) == ["dec_embedding", "dec_pos",
                                             "enc_norm", "final_norm", "groups"]
    for name in ("dec_embedding", "dec_pos"):
        assert tuple(fresh[name].shape) == tree[name].shape
    assert abs(float(fresh["dec_pos"].std()) * np.sqrt(cfg.max_decoder_len) / 0.02
               - 1.0) < 0.1
    for gp, jgp in zip(fresh["groups"], tree["groups"]):
        for layer in gp:
            assert sorted(layer) == sorted(jgp)
            for part, leaves in layer.items():
                assert sorted(leaves) == sorted(jgp[part]), part
    params = tm.params_from_jax(cfg, tree, device="cpu")
    for gp, jgp in zip(params["groups"], tree["groups"]):
        for i, layer in enumerate(gp):
            for part, leaves in layer.items():
                for name, leaf in leaves.items():
                    np.testing.assert_array_equal(leaf.numpy(), jgp[part][name][i])
    ours = tm.init_decode_state(cfg, 3, 10, 4, enc_len=SE, device="cpu")
    theirs = jm.init_decode_state(jcfg, 3, 10, 4, enc_len=SE)
    assert ours.caches[0] == {} and theirs.caches[0] == {}
    assert sorted(ours.caches[1]) == sorted(theirs.caches[1])
    for name, t in ours.caches[1].items():
        assert tuple(t.shape) == theirs.caches[1][name].shape, name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_forward_encdec_matches_jax(dtype):
    jcfg, tcfg, jparams, tparams = _setup(ARCH, dtype)
    feats, tokens = _inputs(jcfg, 12)
    want, _ = jm.forward_encdec(jcfg, jparams, jnp.asarray(feats),
                                jnp.asarray(tokens), remat=False)
    got, aux = tm.forward_encdec(tcfg, tparams, torch.from_numpy(feats),
                                 torch.from_numpy(tokens))
    assert got.dtype == tcfg.dtype and float(aux) == 0.0
    _check(got, want, dtype, "forward_encdec logits")


def _prefill_and_steps(which, cfg, params, feats, tokens, Sd, phys, MB):
    """prefill_encdec on tokens[:, :Sd], then a decode step on each later
    token; the logits of each, and the final state."""
    if which == "jax":
        state = jm.init_decode_state(cfg, B, B * MB, MB, enc_len=SE)
        logits, state = jtr.prefill_encdec(cfg, params, jnp.asarray(feats),
                                           jnp.asarray(tokens[:, :Sd]), state,
                                           jnp.asarray(phys))
        out = [logits]
        for t in range(Sd, tokens.shape[1]):
            logits, state = jm.decode_step(cfg, params, state,
                                           jnp.asarray(tokens[:, t]),
                                           jnp.asarray(phys))
            out.append(logits)
        return out, state
    state = tm.init_decode_state(cfg, B, B * MB, MB, enc_len=SE, device="cpu")
    logits, state = tm.prefill_encdec(cfg, params, torch.from_numpy(feats),
                                      torch.from_numpy(tokens[:, :Sd]), state,
                                      torch.from_numpy(phys))
    out = [logits]
    for t in range(Sd, tokens.shape[1]):
        logits, state = tm.decode_step(cfg, params, state,
                                       torch.from_numpy(tokens[:, t]),
                                       torch.from_numpy(phys))
        out.append(logits)
    return out, state


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_whisper_prefill_and_decode_match_jax(dtype):
    """prefill_encdec of a 9-token decoder prompt, then 8 decode steps on
    given tokens: the logits of each against the reference's own, over
    scattered frames."""
    jcfg, tcfg, jparams, tparams = _setup(ARCH, dtype)
    feats, tokens = _inputs(jcfg, 17, seed=3)
    MB = 17 // jcfg.kv_block_tokens + 2
    phys = np.random.default_rng(4).permutation(B * MB).astype(np.int32).reshape(B, MB)
    want, jstate = _prefill_and_steps("jax", jcfg, jparams, feats, tokens, 9, phys, MB)
    got, tstate = _prefill_and_steps("torch", tcfg, tparams, feats, tokens, 9, phys, MB)
    for i, (g, w) in enumerate(zip(got, want)):
        _check(g, w, dtype, f"logits {i}")
    for name in ("k_slabs", "v_slabs"):
        _check(tstate.caches[1][name], jstate.caches[1][name], dtype, name)
    assert tstate.seq_lens.tolist() == [17] * B


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_whisper_cross_kv_equal_reference(dtype):
    """The cross K/V that prefill_encdec writes for every decoder layer, in
    the cache's dtype."""
    jcfg, tcfg, jparams, tparams = _setup(ARCH, dtype)
    feats, tokens = _inputs(jcfg, 5, seed=5)
    MB = 2
    phys = np.arange(B * MB, dtype=np.int32).reshape(B, MB)
    _, jstate = _prefill_and_steps("jax", jcfg, jparams, feats, tokens, 5, phys, MB)
    _, tstate = _prefill_and_steps("torch", tcfg, tparams, feats, tokens, 5, phys, MB)
    for name in ("cross_k", "cross_v"):
        got = tstate.caches[1][name]
        assert got.dtype == tcfg.dtype and got.any(), name
        _check(got, jstate.caches[1][name], dtype, name)


def test_torch_whisper_decode_matches_forward():
    """test_whisper_decode_matches_forward inside the port (bf16, Se = 32,
    Sd = 20): prefill_encdec on 19 decoder tokens and one decode step
    against forward_encdec's last logits, rel < 0.03."""
    _, tcfg, _, tparams = _setup(ARCH, "bf16")
    Sd = 20
    feats, tokens = _inputs(tcfg, Sd, seed=2)
    feats, tokens = torch.from_numpy(feats), torch.from_numpy(tokens)
    want = tm.forward_encdec(tcfg, tparams, feats, tokens)[0][:, -1].float()
    MB = Sd // tcfg.kv_block_tokens + 2
    state = tm.init_decode_state(tcfg, B, B * MB, MB, enc_len=SE, device="cpu")
    phys = torch.arange(B * MB, dtype=torch.int32).reshape(B, MB)
    _, state = tm.prefill_encdec(tcfg, tparams, feats, tokens[:, :Sd - 1], state, phys)
    got, _ = tm.decode_step(tcfg, tparams, state, tokens[:, Sd - 1], phys)
    rel = float((want - got.float()).abs().max() / want.abs().max())
    assert rel < 0.03, rel


def test_torch_whisper_decoder_only_entry_points_refuse():
    """The reference's serve() and prefill() read ``params["embedding"]``,
    which an encoder-decoder lacks (KeyError); the port's raise a ValueError
    that names the way it is served."""
    cfg = tconfigs.get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="prefill_encdec"):
        serve(ARCH, device="cpu", verbose=False, n_requests=1)
    params = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="forward_encdec"):
        tm.forward_lm(cfg, params, tokens)
    state = tm.init_decode_state(cfg, 1, 2, 2, enc_len=4, device="cpu")
    with pytest.raises(ValueError, match="prefill_encdec"):
        tm.prefill(cfg, params, tokens, state, torch.zeros((1, 2), dtype=torch.int32))
    jcfg = jconfigs.get_smoke_config(ARCH)
    jstate = jm.init_decode_state(jcfg, 1, 2, 2, enc_len=4)
    with pytest.raises(KeyError, match="embedding"):
        jm.prefill(jcfg, jm.init_params(jcfg, jax.random.PRNGKey(0)),
                   jnp.zeros((1, 4), jnp.int32), jstate, jnp.zeros((1, 2), jnp.int32))


def test_torch_whisper_decoder_positions_clip_at_max_decoder_len():
    """decode_step's learned position is clipped to max_decoder_len - 1, as
    the reference's: positions 63 and 64 of the smoke config (64) embed
    alike."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=torch.float32)
    params = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    tok = torch.tensor([[5], [5]])
    emb = ttr._dec_embed(cfg, params, tok, torch.tensor([[63], [64]]))
    assert torch.equal(emb[0], emb[1])
    assert torch.equal(emb[0, 0], params["dec_embedding"][5] + params["dec_pos"][63])
