"""Mamba-2 SSD in the port against the JAX package.

The module (``ssd_forward``, ``ssd_decode``, the causal conv) runs on the
same numpy inputs on both sides, the smoke config's shapes (chunk 8) at
S = 16 and at the ragged S = 13, whose decode state comes from the
reference's single-step replay over the partial chunk.  float32 outputs and
states compare within 1e-5 of their largest magnitude; bfloat16 within rel
0.03.  The model (``mamba2_370m``'s smoke config, converted weights with the
norms perturbed as in ``test_torch_models._setup``) compares likewise, and
its serve counters equal the reference's.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from test_torch_models import _f32, _setup  # noqa: E402

ARCH = "mamba2_370m"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype: str):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=jd),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=td))


def _module_params(jcfg, seed: int = 0):
    """The reference's ``init_ssd`` leaves as numpy, the vectors (biases,
    decay, skip, norm scale) moved off their constant init by seeded noise."""
    p = jax.tree.map(np.asarray, jssm.init_ssd(jcfg, KeyGen(jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(seed + 11)
    return {k: (v + rng.normal(0, 0.3, v.shape).astype(np.float32)
                if v.ndim == 1 else v) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def _check(got, want, dtype: str, what: str):
    """float32: within 1e-5 of the largest |want|; bfloat16: rel < 0.03."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < (1e-5 if dtype == "f32" else 0.03), (what, err)


@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_ssd_forward_and_state_match_jax(dtype, S):
    """Output and the returned decode state ``h``/``conv``; at S = 13 the
    tail is padded and the state replayed over the partial chunk."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_module_params(jcfg))
    x = np.random.default_rng(1).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    want, wst = jssm.ssd_forward(jcfg, jp, jnp.asarray(x).astype(jcfg.dtype),
                                 return_state=True)
    got, gst = tssm.ssd_forward(tcfg, tp, torch.from_numpy(x).to(tcfg.dtype),
                                return_state=True)
    assert got.dtype == tcfg.dtype and gst["h"].dtype == torch.float32
    assert gst["conv"].dtype == tcfg.dtype
    _check(got, want, dtype, "ssd_forward")
    _check(gst["h"], wst["h"], dtype, "state h")
    np.testing.assert_array_equal(_f32(gst["conv"]), _f32(wst["conv"]))
    plain = tssm.ssd_forward(tcfg, tp, torch.from_numpy(x).to(tcfg.dtype))
    assert torch.equal(plain, got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_ssd_decode_matches_jax(dtype):
    """One O(1) step from a random state: output, new ``h`` and conv tail;
    the inputs are left as they were."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_module_params(jcfg, seed=2))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    h = rng.standard_normal((3, jcfg.ssm_n_heads, jcfg.ssm_state,
                             jcfg.ssm_head_dim)).astype(np.float32)
    conv = rng.standard_normal((3, jcfg.conv_width - 1,
                                jcfg.d_inner + 2 * jcfg.ssm_state)).astype(np.float32)
    want = jssm.ssd_decode(jcfg, jp, jnp.asarray(x).astype(jcfg.dtype),
                           jnp.asarray(h), jnp.asarray(conv).astype(jcfg.dtype))
    th, tconv = torch.from_numpy(h), torch.from_numpy(conv).to(tcfg.dtype)
    th0, tconv0 = th.clone(), tconv.clone()
    got = tssm.ssd_decode(tcfg, tp, torch.from_numpy(x).to(tcfg.dtype), th, tconv)
    assert torch.equal(th, th0) and torch.equal(tconv, tconv0)
    for g, w, what in zip(got, want, ("out", "h", "conv")):
        _check(g, w, dtype, what)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_ssd_ten_decode_steps_after_prefill_match_jax(dtype):
    """The module's prefill state (ragged S = 13) carried through 10 decode
    steps on both sides: each step's output and the final state."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_module_params(jcfg, seed=4))
    x = np.random.default_rng(5).standard_normal(
        (2, 23, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jcfg.dtype), torch.from_numpy(x).to(tcfg.dtype)
    _, jst = jssm.ssd_forward(jcfg, jp, jx[:, :13], return_state=True)
    _, tst = tssm.ssd_forward(tcfg, tp, tx[:, :13], return_state=True)
    jh, jc, th, tc = jst["h"], jst["conv"], tst["h"], tst["conv"]
    for t in range(13, 23):
        wo, jh, jc = jssm.ssd_decode(jcfg, jp, jx[:, t:t + 1], jh, jc)
        go, th, tc = tssm.ssd_decode(tcfg, tp, tx[:, t:t + 1], th, tc)
        _check(go, wo, dtype, f"step {t}")
    _check(th, jh, dtype, "h after 10 steps")
    _check(tc, jc, dtype, "conv after 10 steps")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_causal_conv_matches_jax(dtype):
    """The depthwise conv as the reference sums it (taps in order, in the
    input's dtype), with and without a carried state."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    st = rng.standard_normal((2, 3, 40)).astype(np.float32)
    for state in (None, st):
        want = jssm._causal_conv(jnp.asarray(x).astype(jd), jnp.asarray(w), jnp.asarray(b),
                                 None if state is None else jnp.asarray(state))
        got = tssm._causal_conv(torch.from_numpy(x).to(td), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if state is None else torch.from_numpy(state))
        assert got.dtype == td
        _check(got, want, dtype, "conv")


def test_torch_init_ssd_shapes_and_constants_equal_reference():
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = tconfigs.get_smoke_config(ARCH)
    want = jax.tree.map(np.asarray, jssm.init_ssd(jcfg, KeyGen(jax.random.PRNGKey(0))))
    got = tssm.init_ssd(cfg, torch.Generator(device="cpu").manual_seed(0),
                        torch.float32)
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
    for name in ("a_log", "conv_b", "dt_bias", "d_skip", "norm_scale"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-6,
                                   err_msg=name)
    assert cfg.d_inner == jcfg.d_inner and cfg.ssm_n_heads == jcfg.ssm_n_heads


def test_torch_mamba_groups_decode_state_and_conversion():
    """One ``ssd`` group of 48 layers at full size; the decode state holds
    ``h`` [L,B,H,n,P] float32 and ``conv`` [L,B,W-1,conv_ch] as the
    reference's; a layer is ``norm1`` and ``ssd`` only, leaf for leaf."""
    groups = tm.layer_groups(tconfigs.get_config(ARCH))
    assert [(g.kind, g.n_layers) for g in groups] == [("ssd", 48)]
    jcfg, cfg = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    ours = tm.init_decode_state(cfg, 3, 12, 4, device="cpu")
    theirs = jm.init_decode_state(jcfg, 3, 12, 4)
    for c, jc in zip(ours.caches, theirs.caches):
        assert sorted(c) == sorted(jc) == ["conv", "h"]
        for name, t in c.items():
            assert tuple(t.shape) == jc[name].shape and not t.any(), name
            assert str(t.dtype).replace("torch.", "") == jc[name].dtype.name
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(1)))
    params = tm.params_from_jax(cfg, tree, device="cpu")
    assert [len(gp) for gp in params["groups"]] == [cfg.n_layers]
    for i, layer in enumerate(params["groups"][0]):
        assert sorted(layer) == ["norm1", "ssd"]
        for name, leaf in layer["ssd"].items():
            np.testing.assert_array_equal(leaf.numpy(), tree["groups"][0]["ssd"][name][i])
    fresh = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    assert sorted(fresh["groups"][0][0]) == ["norm1", "ssd"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_mamba_prefill_and_decode_match_jax(dtype):
    """The model: prefill a ragged 21-token prompt, then 10 decode steps,
    logits after each and the states (``h``, ``conv``) at the end, with a
    padding row (all -1 table) in the batch: the walk's frames reach no
    layer."""
    jcfg, tcfg, jparams, tparams = _setup(ARCH, dtype)
    B, P, STEPS = 3, 21, 10
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
    for name in ("h", "conv"):
        _check(tstate.caches[0][name], jstate.caches[0][name], dtype, name)
    assert _f32(tstate.seq_lens).tolist() == [P + STEPS] * B


@pytest.mark.parametrize("S", [48, 45])
def test_torch_mamba_decode_matches_forward(S):
    """bf16: prefill S-1 tokens (ragged against the chunk at S = 48: 47),
    one decode step, against the full forward's last logits (rel < 0.03, the
    bound of tests/test_models.py)."""
    _, tcfg, _, tparams = _setup(ARCH, "bf16")
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


def test_torch_ssd_chunk_products_hold_no_six_axis_intermediate():
    """Peak-memory guard at full-width heads and state (H = 32, n = 128,
    P = 64, chunk 64) on [2, 256]: every tensor any operation of
    ``ssd_forward`` makes, counted by a dispatch hook, stays within 4x the
    largest operand of the chunk products (the chunk states
    [B,nc,H,n,P]).  A three-operand einsum expanded in one step would make
    [B,nc,Q,Q,H,P] or [B,nc,Q,H,n,P], 32x and 64x that."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        biggest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Largest.biggest = max(Largest.biggest,
                                          t.numel() * t.element_size())
            return out

    cfg = dataclasses.replace(tconfigs.get_config(ARCH), n_layers=1,
                              dtype=torch.float32)
    assert (cfg.ssm_n_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk) == \
        (32, 128, 64, 64)
    B, S = 2, 256
    p = tssm.init_ssd(cfg, torch.Generator(device="cpu").manual_seed(0),
                      torch.float32)
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(1))
    nc = S // cfg.ssm_chunk
    states_bytes = 4 * B * nc * cfg.ssm_n_heads * cfg.ssm_state * cfg.ssm_head_dim
    with torch.no_grad(), Largest():
        out, st = tssm.ssd_forward(cfg, p, x, return_state=True)
    assert torch.isfinite(out).all() and torch.isfinite(st["h"]).all()
    assert Largest.biggest <= 4 * states_bytes, (Largest.biggest, states_bytes)


RUN = dict(n_requests=5, prompt_len=20, gen_len=6, batch=2, seed=0, n_pods=4)
COUNTERS = ("mode", "n_pods", "tokens", "invalidations_sent",
            "invalidations_filtered", "coherence_bytes", "fetches",
            "prefetched", "table_pages")


@pytest.fixture(scope="module")
def port_runs():
    """The port's serve() on the reference's weights for seed 0, three modes."""
    tree = jax.tree.map(np.asarray, jm.init_params(
        jconfigs.get_smoke_config(ARCH), jax.random.PRNGKey(RUN["seed"])))
    params = tm.params_from_jax(tconfigs.get_smoke_config(ARCH), tree, device="cpu")
    return {mode: serve(ARCH, mode=mode, device="cpu", params=params,
                        verbose=False, **RUN)
            for mode in ("local", "eager", "numapte")}


@pytest.mark.parametrize("mode", ["local", "eager", "numapte"])
def test_torch_mamba_serve_counters_equal_reference(port_runs, mode):
    """No layer reads a frame, yet the block table is walked every step:
    the host protocol's counters equal the reference's."""
    want = jax_serve(ARCH, mode=mode, verbose=False, **RUN)
    got = port_runs[mode]
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert got["logits_finite"] and got["device"] == "cpu"
    assert got["token_ids"].shape == (RUN["n_requests"], RUN["gen_len"])
    if mode == "numapte":
        assert got["fetches"] > 0


def test_torch_mamba_serve_tokens_equal_across_modes(port_runs):
    ids = [port_runs[m]["token_ids"] for m in ("local", "eager", "numapte")]
    assert np.array_equal(ids[0], ids[1]) and np.array_equal(ids[0], ids[2])
    assert len(np.unique(ids[0])) > 4            # not one constant token
