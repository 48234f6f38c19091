"""The port's mixture-of-experts FFN against the JAX package's.

``moe_forward`` alone on the same numpy input and the reference's own
weights: output (float32 to 2e-4, bfloat16 to rel 0.03), aux loss, and the
routes exactly: the reference's dispatch is read from the ``[E, C, D]``
activations it hands to its sharding constraint (each slot holds one row of
the padded input, and the rows are distinct), its gates from the same
top-k.  At the smoke factor 8.0, and at 1.0 and 0.5, where assignments drop.
Then the tie rule, padding rows, the parameter conversion and counts, and the
serving loop of both MoE archs on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import serve as jax_serve  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

MOE_ARCHS = ["qwen3_moe_235b_a22b", "kimi_k2_1t_a32b"]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch: str, dtype: str, **change):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=jd, **change),
            dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=td, **change))


def _weights(jcfg, seed: int = 0):
    """The reference's MoE weights: as jax arrays, and as CPU tensors."""
    jp = jmoe.init_moe(jcfg, KeyGen(jax.random.PRNGKey(seed)))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    return jp, tp


def _reference(jcfg, jp, x: np.ndarray):
    """The reference's (out, aux) and its dispatch: the token of each slot
    ``[E, C]`` (N where empty), read back from the ``xe`` it constrains, and
    its routes (ids, renormalised gates) from its own router and top-k."""
    seen = []

    def capture(a, *axes):
        seen.append(a)
        return a

    xj = jnp.asarray(x).astype(jcfg.dtype)
    saved = jmoe.constrain
    jmoe.constrain = capture
    try:
        out, aux = jmoe.moe_forward(jcfg, jp, xj)
    finally:
        jmoe.constrain = saved
    N, D = x.shape[0] * x.shape[1], x.shape[2]
    xf = xj.reshape(N, D)
    x_pad = np.asarray(jnp.concatenate([xf, jnp.zeros((1, D), xf.dtype)]), np.float32)
    xe = np.asarray(seen[0], np.float32)                 # [E, C, D]
    match = (xe[:, :, None, :] == x_pad[None, None]).all(-1)   # [E, C, N+1]
    assert (match.sum(-1) == 1).all(), "padded rows are not distinct"
    tok = match.argmax(-1)
    logits = (xf @ jp["router"].astype(jcfg.dtype)).astype(jnp.float32)
    gates, eids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                jcfg.experts_per_token)
    gates = gates / jnp.sum(gates, axis=-1, keepdims=True)
    return out, aux, tok, np.asarray(eids), np.asarray(gates)


def _port(tcfg, tp, x: np.ndarray):
    """The port's (out, aux), dispatch and routes on the same input."""
    xt = torch.from_numpy(x).to(tcfg.dtype)
    out, aux = tmoe.moe_forward(tcfg, tp, xt)
    xf = xt.reshape(-1, x.shape[2])
    routes = tmoe.route(tcfg, tp, xf)
    C = tmoe.expert_capacity(xf.shape[0], tcfg.n_experts,
                             tcfg.experts_per_token, tcfg.moe_capacity_factor)
    return out, aux, tmoe.dispatch(routes, tcfg.n_experts, C), routes


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("factor", [8.0, 1.0, 0.5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_torch_moe_forward_matches_jax(arch, dtype, factor):
    jcfg, tcfg = _cfgs(arch, dtype, moe_capacity_factor=factor)
    jp, tp = _weights(jcfg)
    x = np.random.default_rng(4).standard_normal((3, 32, jcfg.d_model)).astype(np.float32)
    want, want_aux, want_tok, want_eids, want_gates = _reference(jcfg, jp, x)
    got, got_aux, disp, routes = _port(tcfg, tp, x)
    # the routes and the dispatch, exactly
    np.testing.assert_array_equal(routes.eids.numpy(), want_eids)
    np.testing.assert_array_equal(disp.tok.numpy(), want_tok)
    N, K = want_eids.shape
    E, C = disp.tok.shape
    kept = disp.slot.numpy() < E * C
    dropped = int((~kept).sum())
    if factor < 8.0:                 # the factors that exist to drop
        assert dropped > 0, (factor, C)
    else:
        assert dropped == 0
    assert kept.sum() == (want_tok < N).sum()
    want_w = np.zeros((E, C), np.float32)
    for e in range(E):
        for c in range(C):
            n = want_tok[e, c]
            if n < N:
                want_w[e, c] = np.asarray(want_gates)[n][list(want_eids[n]).index(e)]
    np.testing.assert_allclose(disp.w.numpy(), want_w, rtol=1e-6, atol=0)
    np.testing.assert_allclose(routes.gates.numpy(), want_gates, rtol=1e-6, atol=0)
    # slot of each assignment: that of the reference's dispatch
    for n in range(N):
        for k in range(K):
            s = disp.slot[n, k].item()
            if s < E * C:
                assert want_tok[s // C, s % C] == n
    assert abs(float(got_aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))
    assert got.dtype == tcfg.dtype
    got, want = _f32(got), _f32(want)
    assert np.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-4)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 0.03, rel


def test_torch_moe_top_k_tie_picks_the_lower_expert():
    """Equal probabilities at the top-k boundary go to the lower expert id,
    as ``jax.lax.top_k`` orders them; the dispatch follows."""
    jcfg, tcfg = _cfgs("qwen3_moe_235b_a22b", "f32")
    jp, tp = _weights(jcfg)
    D, E = jcfg.d_model, jcfg.n_experts
    router = np.zeros((D, E), np.float32)
    router[:E, :E] = np.eye(E)                   # logits = the first E features
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.random.default_rng(6).standard_normal((1, 4, D)).astype(np.float32)
    x[0, :, :E] = [[3, 1, 1, 1, 0, 0, 0, 0],     # a tie for second place
                   [0, 0, 0, 0, 0, 0, 0, 0],     # all tie
                   [0, 0, 0, 2, 0, 0, 2, 0],     # a tie for first place
                   [1, 0, 0, 0, 0, 0, 0, 1]]
    _, _, _, want_eids, _ = _reference(jcfg, jp, x)
    _, _, _, routes = _port(tcfg, tp, x)
    assert routes.eids.tolist() == [[0, 1], [0, 1], [3, 6], [0, 7]]
    np.testing.assert_array_equal(routes.eids.numpy(), want_eids)


def test_torch_moe_route_flips_measures_near_ties():
    """``route_flips`` counts the experts one run took and the other left,
    and the largest probability gap between such a pair, relative to the
    larger: a flip between two experts within ``NEAR_TIE`` is a near-tie,
    one between distant experts is not."""
    probs = torch.tensor([[0.5, 0.2, 0.2 * (1 - 2.0 ** -9), 0.1],
                          [0.4, 0.3, 0.2, 0.1],
                          [0.4, 0.3, 0.2, 0.1]])
    mine = torch.tensor([[0, 1], [0, 1], [1, 0]])
    assert tmoe.route_flips(probs, mine, mine.flip(-1)) == (0, 0.0)
    near = torch.tensor([[0, 2], [0, 1], [1, 0]])     # swaps experts 1 and 2
    flips, gap = tmoe.route_flips(probs, mine, near)
    assert flips == 1 and gap == pytest.approx(2.0 ** -9, rel=1e-4)
    assert gap < tmoe.NEAR_TIE
    far = torch.tensor([[0, 1], [0, 3], [1, 0]])      # 0.3 left for 0.1
    flips, gap = tmoe.route_flips(probs, mine, far)
    assert flips == 1 and gap == pytest.approx(2 / 3, rel=1e-6)
    assert gap > tmoe.NEAR_TIE


def test_torch_moe_padding_rows_never_displace_a_live_row():
    """Rows at the end of the batch (a partial wave's padding) route and take
    capacity too, but the stable sort ranks them after every live row of
    their expert: the live rows keep exactly the assignments, and the
    outputs, that they have without them, and the reference agrees."""
    jcfg, tcfg = _cfgs("qwen3_moe_235b_a22b", "f32", moe_capacity_factor=0.5)
    jp, tp = _weights(jcfg)
    D = jcfg.d_model
    router = np.array(jp["router"])
    router[0, 0] = 4.0                            # feature 0 pulls to expert 0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    rng = np.random.default_rng(8)
    live = rng.standard_normal((1, 16, D)).astype(np.float32)
    live[..., 0] = 3.0
    pad = rng.standard_normal((1, 16, D)).astype(np.float32)
    pad[..., 0] = 3.0
    both = np.concatenate([live, pad])            # the padding row comes last
    out_live, _, disp_live, _ = _port(tcfg, tp, live)
    out_both, _, disp_both, _ = _port(tcfg, tp, both)
    E, C = disp_both.tok.shape
    assert disp_live.tok.shape == (E, C)          # the same capacity
    kept_live = disp_live.slot < E * C
    assert int((~kept_live).sum()) > 0            # live rows do drop
    assert torch.equal(disp_both.slot[:16], disp_live.slot)
    assert not bool((disp_both.slot[16:] < E * C).all())
    np.testing.assert_array_equal(out_both[0].numpy(), out_live[0].numpy())
    want, _, want_tok, _, _ = _reference(jcfg, jp, both)
    np.testing.assert_array_equal(disp_both.tok.numpy(), want_tok)
    np.testing.assert_allclose(out_both.numpy(), _f32(want), atol=2e-4)


def test_torch_expert_capacity_equals_reference():
    for n, e, k, f in [(16, 128, 8, 1.25), (16384, 128, 8, 1.25),
                       (16384, 384, 8, 1.25), (96, 8, 2, 8.0), (3, 8, 2, 0.5),
                       (1000, 7, 3, 1.0)]:
        assert tmoe.expert_capacity(n, e, k, f) == jmoe.expert_capacity(n, e, k, f)
    assert tmoe.CAPACITY_FACTOR == jmoe.CAPACITY_FACTOR
    assert tmoe.expert_capacity(16, 128, 8) == 8              # decode, batch 16
    assert tmoe.expert_capacity(16 * 1024, 128, 8) == 1280    # Qwen3-MoE prefill
    assert tmoe.expert_capacity(16 * 1024, 384, 8) == 432     # Kimi-K2 prefill


def test_torch_kimi_groups_and_shared_expert_survive_conversion():
    """Kimi's ``[dense, moe]`` groups, the stacked ``[L,E,D,F]`` experts and
    the nested ``shared`` FFN come through ``params_from_jax`` leaf for
    leaf."""
    jcfg = jconfigs.get_smoke_config("kimi_k2_1t_a32b")
    tcfg = tconfigs.get_smoke_config("kimi_k2_1t_a32b")
    groups = tm.layer_groups(tcfg)
    assert [(g.moe, g.n_layers) for g in groups] == [(False, 1), (True, 2)]
    tree = jax.tree.map(np.asarray, jtransformer.init_params(jcfg, jax.random.PRNGKey(0)))
    params = tm.params_from_jax(tcfg, tree, device="cpu")
    assert [len(gp) for gp in params["groups"]] == [1, 2]
    assert "ffn" in params["groups"][0][0] and "moe" not in params["groups"][0][0]
    for li, lp in enumerate(params["groups"][1]):
        moe = lp["moe"]
        assert "ffn" not in lp
        assert set(moe) == {"router", "we_in", "we_gate", "we_out", "shared"}
        assert set(moe["shared"]) == {"w_in", "w_gate", "w_out"}
        assert tuple(moe["we_in"].shape) == (8, 64, 96)
        assert tuple(moe["shared"]["w_in"].shape) == (64, 96)
        ref = tree["groups"][1]["moe"]
        for name in ("router", "we_in", "we_gate", "we_out"):
            np.testing.assert_array_equal(moe[name].numpy(), ref[name][li])
        for name in ("w_in", "w_gate", "w_out"):
            np.testing.assert_array_equal(moe["shared"][name].numpy(),
                                          ref["shared"][name][li])
    # the port's own init builds the same structure and shapes
    own = tm.init_params(tcfg, torch.Generator(device="cpu").manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), own) == jax.tree.map(
        lambda t: tuple(t.shape), params)


def test_torch_moe_init_statistics_and_bf16_cast():
    """Expert tensors take the reference's fan-in (E), are drawn slice by
    slice from the seed, and a bf16 init is the float32 init cast."""
    cfg = tconfigs.get_smoke_config("qwen3_moe_235b_a22b")
    p = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    again = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    bf16 = tm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0),
                          param_dtype=torch.bfloat16)
    moe = p["groups"][0][0]["moe"]
    for name, (e, fan_in) in {"we_in": (8, 8), "we_out": (8, 8),
                              "router": (None, 64)}.items():
        w = moe[name]
        scale = 0.1 if name == "router" else 1.0
        assert abs(float(w.std()) * np.sqrt(fan_in) / scale - 1.0) < 0.05, name
        assert torch.equal(w, again["groups"][0][0]["moe"][name])
        assert torch.equal(bf16["groups"][0][0]["moe"][name], w.to(torch.bfloat16))
    assert not torch.equal(moe["we_in"][0], moe["we_in"][1])   # slices differ


@pytest.mark.parametrize("arch", ["qwen3_14b", "yi_6b", "gemma3_4b"] + MOE_ARCHS
                         + ["nemotron_4_15b", "chameleon_34b", "mamba2_370m",
                            "recurrentgemma_2b", "whisper_base"])
def test_torch_param_counts_equal_reference_without_allocation(arch, monkeypatch):
    """At full width, from shapes alone: nothing is drawn."""
    def refuse(*a, **k):
        raise AssertionError("param_count drew a tensor")

    monkeypatch.setattr(torch, "randn", refuse)
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert tm.param_count(cfg) == jtransformer.param_count(jcfg)
    assert tm.active_param_count(cfg) == jtransformer.active_param_count(jcfg)


RUN = dict(n_requests=5, prompt_len=20, gen_len=6, batch=2, seed=0, n_pods=4)
COUNTERS = ("mode", "n_pods", "tokens", "invalidations_sent",
            "invalidations_filtered", "coherence_bytes", "fetches",
            "prefetched", "table_pages")


@pytest.fixture(scope="module")
def moe_runs():
    """Both MoE archs served by the port on the CPU, on the reference's
    weights for seed 0, in the three coherence modes."""
    runs = {}
    for arch in MOE_ARCHS:
        tree = jax.tree.map(np.asarray, jtransformer.init_params(
            jconfigs.get_smoke_config(arch), jax.random.PRNGKey(RUN["seed"])))
        params = tm.params_from_jax(tconfigs.get_smoke_config(arch), tree,
                                    device="cpu")
        for mode in ("local", "eager", "numapte"):
            runs[(arch, mode)] = serve(arch, mode=mode, device="cpu",
                                       params=params, verbose=False, **RUN)
    return runs


@pytest.mark.parametrize("mode", ["local", "eager", "numapte"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_torch_moe_serve_counters_equal_reference(moe_runs, arch, mode):
    want = jax_serve(arch, mode=mode, verbose=False, **RUN)
    got = moe_runs[(arch, mode)]
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert got["logits_finite"] and got["device"] == "cpu"
    assert got["token_ids"].shape == (RUN["n_requests"], RUN["gen_len"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_torch_moe_serve_tokens_equal_across_modes(moe_runs, arch):
    ids = [moe_runs[(arch, mode)]["token_ids"]
           for mode in ("local", "eager", "numapte")]
    assert np.array_equal(ids[0], ids[1]) and np.array_equal(ids[0], ids[2])
    assert len(np.unique(ids[0])) > 4            # not one constant token
