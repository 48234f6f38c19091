"""The in-pod model axis for the families beyond the dense global-attention
ones, on the CPU: Gemma-3 (windowed ring layers beside global ones),
Qwen3-MoE and Kimi-K2 (expert parallelism; Kimi's dense first layer and its
shared expert by ``ff``), Mamba-2 (the SSD split by head, its fused leaves
by section), RecurrentGemma (the RG-LRU split by channel beside windowed
attention on one kv head) and Whisper (the encoder-decoder).

Each arch runs at smoke widths in float32 on weights from
``repro.models.init_params`` through ``params_from_jax`` (norms perturbed as
in ``test_torch_models``), split over ``LoopPods(t)`` by ``shard_params``
under three cases: t = 2 and t = 4 under the smoke config's own rules
(``SINGLE_POD_RULES``: heads and kv heads on the model axis, so rings,
slabs and cross K/V split by kv head where t divides K), and t = 2 under the
published config's ``rule_overrides`` (Gemma-3's and RecurrentGemma's
attention replicated, Whisper wholly replicated).  Each is held against

  * the reference's *unsharded* JAX functions: ``forward_lm`` (Whisper:
    ``forward_encdec``), ``prefill`` (``prefill_encdec``) + 4
    ``decode_step``s (``kernel="ref"``), ``lm_loss`` and its gradients —
    every logit and gradient within relative 1e-4 (of the largest
    magnitude);
  * the port's own ``model = 1`` run — within 1e-5, greedy tokens equal,
    and the MoE layers' routes equal on every shard.

The prompt (37 tokens) passes the smoke windows (32), so the ring decode
wraps, and is not a multiple of Mamba-2's chunk (8), so its prefill state
comes from the replay over the partial chunk.  Then: ``shard_params`` and
``gather_params`` are inverse for every leaf of every family (the SSD's
sections checked by hand), the clip's norm over split leaves equals the
whole tree's, ``DistPods`` on gloo at world 2 equals ``LoopPods(2)`` bit for
bit on a train step of Qwen3-MoE and of Mamba-2 (the differentiable
all-gather), Qwen3-MoE restores from (data 2, model 4) onto (2, 2) within
1e-5 of the uninterrupted run.  The per-arch cases of Qwen3-MoE and
RecurrentGemma run here, with the restore and the shard / gather identity;
those of Gemma-3, Kimi-K2, Mamba-2 and Whisper run in
``test_torch_model_axis_families_b``, through the same functions, so that
two workers share the cases.  The grid's other options (pool-partitioned
KV and sequence-parallel decode over the model axis, the data axis over
caches held a row, the int8 pod leg across processes) are held in
``test_torch_model_axis_options``.
"""
from __future__ import annotations

import dataclasses
import functools
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch._tree import (tree_leaves, tree_leaves_with_path,  # noqa: E402
                               tree_map)
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import gather_vocab, vocab_split  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.adamw import global_norm  # noqa: E402
from test_torch_elastic import _dataset, _grid, _like, _steps  # noqa: E402
from test_torch_model_axis import ROOT, WORKER  # noqa: E402
from test_torch_models import _setup  # noqa: E402
from test_torch_train import _unstacked_pairs  # noqa: E402

ARCHS = ["gemma3_4b", "qwen3_moe_235b_a22b", "kimi_k2_1t_a32b",
         "mamba2_370m", "recurrentgemma_2b", "whisper_base"]
MOE = ["qwen3_moe_235b_a22b", "kimi_k2_1t_a32b"]
#: the archs whose cases run in this file (the rest: ``..._families_b``)
HERE = ["qwen3_moe_235b_a22b", "recurrentgemma_2b"]
B, S, STEPS, SE = 2, 37, 4, 24
REF_REL = 1e-4         # against the reference's unsharded functions
OWN_TOL = 1e-5         # against the port's model = 1 run
#: t and the rules: "rules" the smoke config's own (SINGLE_POD_RULES),
#: "published" the published config's rule_overrides on top
CASES = [(2, "rules"), (2, "published"), (4, "rules")]
#: (kv_split, state_split) each case gives: rings, slabs and cross K/V
#: split where the rules put kv heads on the model axis and t divides K;
#: recurrent states split wherever their layers do
LAYOUT = {
    "gemma3_4b": [(2, 1), (1, 1), (1, 1)],
    "qwen3_moe_235b_a22b": [(2, 1), (1, 1), (1, 1)],
    "kimi_k2_1t_a32b": [(2, 1), (1, 1), (1, 1)],
    "mamba2_370m": [(2, 2), (1, 2), (1, 4)],
    "recurrentgemma_2b": [(1, 2), (1, 2), (1, 4)],
    "whisper_base": [(2, 1), (1, 1), (4, 1)],
}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(jcfg):
    bt = jcfg.kv_block_tokens
    MB = (S + STEPS + bt - 1) // bt + 1
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (B + 1, S)).astype(np.int32)
    phys = rng.permutation((B + 1) * MB).astype(np.int32).reshape(B + 1, MB)
    phys[-1] = -1                           # a padding row
    loss_batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                         (B, S + 1)).astype(np.int32)}
    feats = None
    if jcfg.family == "encdec":
        feats = rng.standard_normal((B + 1, SE, jcfg.d_model)).astype(np.float32)
        loss_batch["enc_feats"] = feats[:B]
    return tokens, phys, MB, loss_batch, feats


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's unsharded forward logits, prefill + decode logits
    (fed its own greedy tokens), loss and unstacked gradients; each
    function under ``jax.jit`` (one compile in place of one a step)."""
    jcfg, _, jparams, _ = _setup(arch, "f32")
    tokens, phys, MB, loss_batch, feats = _inputs(jcfg)
    jit = lambda fn, **kw: jax.jit(functools.partial(fn, jcfg, **kw))
    if jcfg.family == "encdec":
        fwd = jit(jm.forward_encdec, remat=False)(
            jparams, jnp.asarray(feats[:B]), jnp.asarray(tokens[:B]))[0]
        state = jm.init_decode_state(jcfg, B + 1, (B + 1) * MB, MB, enc_len=SE)
        lg, state = jit(jtr.prefill_encdec)(jparams, jnp.asarray(feats),
                                            jnp.asarray(tokens), state,
                                            jnp.asarray(phys))
    else:
        fwd = jit(jm.forward_lm, remat=False)(jparams, jnp.asarray(tokens[:B]))[0]
        state = jm.init_decode_state(jcfg, B + 1, (B + 1) * MB, MB)
        lg, state = jit(jm.prefill)(jparams, jnp.asarray(tokens), state,
                                    jnp.asarray(phys))
    steps, toks = [np.asarray(lg)], []
    decode = jit(jm.decode_step, kernel="ref")
    for _ in range(STEPS):
        tok = jm.greedy_sample(lg)
        toks.append(np.asarray(tok))
        lg, state = decode(jparams, state, tok, jnp.asarray(phys))
        steps.append(np.asarray(lg))
    jb = {k: jnp.asarray(v) for k, v in loss_batch.items()}
    (total, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(jcfg, p, jb, remat=False), has_aux=True))(jparams)
    return {"forward": np.asarray(fwd), "decode": steps, "tokens": toks,
            "loss": float(total), "grads": grads}


def _rules(tcfg, arch, grid, layout):
    if layout == "rules":
        return None                       # the smoke config's own (default)
    published = tconfigs.get_config(arch).rule_overrides
    return specs.make_rules(dataclasses.replace(tcfg, rule_overrides=published),
                            grid)


def _port(arch, t, layout="rules"):
    """The port's forward logits, prefill + decode logits (fed the
    reference's tokens) and greedy tokens, loss and whole gradients, the
    MoE layers' routes (a list a call, one a local shard), on a model axis
    of t (t = 1: no grid at all)."""
    jcfg, tcfg, _, tparams = _setup(arch, "f32")
    tokens, phys, MB, loss_batch, feats = _inputs(jcfg)
    ref = _reference(arch)
    grid = make_debug_mesh(1, model=t, device="cpu")
    tp = grid.model if t > 1 else None
    rules = _rules(tcfg, arch, grid, layout)
    params = specs.shard_params(tparams, grid, tcfg, rules)
    whole = ((lambda lg: gather_vocab(lg, tp))
             if tp is not None and vocab_split(params) else (lambda lg: lg))
    encdec = tcfg.family == "encdec"
    routes, real = [], moe.route

    def recording(*args, **kw):
        picked = real(*args, **kw)
        routes.append(picked.eids)
        return picked

    out = {}
    moe.route = recording
    try:
        with torch.no_grad():
            if encdec:
                fwd = tm.forward_encdec(tcfg, params,
                                        torch.from_numpy(feats[:B]),
                                        torch.from_numpy(tokens[:B]), tp)[0]
            else:
                fwd = tm.forward_lm(tcfg, params,
                                    torch.from_numpy(tokens[:B]), tp)[0]
    finally:
        moe.route = real
    out["forward"], out["routes"] = whole(fwd).numpy(), routes
    split = specs.kv_split(tcfg, grid, rules) if t > 1 else 1
    rec = specs.state_split(params, grid) if t > 1 else 1
    out["layout"] = (split, rec)
    state = tm.init_decode_state(tcfg, B + 1, (B + 1) * MB, MB,
                                 enc_len=SE if encdec else 0, kv_split=split,
                                 state_split=rec, device="cpu")
    tphys = torch.from_numpy(phys)
    with torch.no_grad():
        if encdec:
            lg, state = tm.prefill_encdec(tcfg, params, torch.from_numpy(feats),
                                          torch.from_numpy(tokens), state,
                                          tphys, tp=tp)
        else:
            lg, state = tm.prefill(tcfg, params, torch.from_numpy(tokens),
                                   state, tphys, tp=tp)
        steps, greedy = [whole(lg).numpy()], []
        for tok in ref["tokens"]:
            greedy.append(tm.greedy_sample(
                lg, tp if tp is not None and vocab_split(params) else None
            ).numpy())
            lg, state = tm.decode_step(tcfg, params, state,
                                       torch.from_numpy(np.array(tok)), tphys,
                                       tp=tp)
            steps.append(whole(lg).numpy())
    out.update(decode=steps, greedy=greedy)
    batch = {k: torch.from_numpy(v) for k, v in loss_batch.items()}
    total, _, grads = specs._grads(tcfg, params, batch, tp)
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), params)
    out["loss"] = float(total)
    out["grads"] = specs.gather_params(gtree, grid) if t > 1 else gtree
    return out


@functools.lru_cache(maxsize=None)
def _port_cached(arch, t, layout="rules"):
    return _port(arch, t, layout)


@pytest.mark.parametrize("t,layout", CASES)
@pytest.mark.parametrize("arch", HERE)
def test_torch_families_match_the_reference(arch, t, layout):
    ref, got = _reference(arch), _port_cached(arch, t, layout)
    assert got["layout"] == LAYOUT[arch][CASES.index((t, layout))]
    assert _rel(got["forward"], ref["forward"]) <= REF_REL
    for i, (g, w) in enumerate(zip(got["decode"], ref["decode"])):
        assert _rel(g[:B], w[:B]) <= REF_REL, f"step {i}"
    assert abs(got["loss"] - ref["loss"]) <= REF_REL * abs(ref["loss"])
    _, _, _, tparams = _setup(arch, "f32")
    n = 0
    for name, _, j_leaf in _unstacked_pairs(ref["grads"], tparams):
        node = got["grads"]
        for k in name.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        assert _rel(node.numpy(), np.asarray(j_leaf)) <= REF_REL, name
        n += 1
    assert n == len(tree_leaves(tparams))


@pytest.mark.parametrize("t,layout", CASES)
@pytest.mark.parametrize("arch", HERE)
def test_torch_families_match_model_one(arch, t, layout):
    own, got = _port_cached(arch, 1), _port_cached(arch, t, layout)
    assert np.abs(got["forward"] - own["forward"]).max() <= OWN_TOL
    for i, (g, w) in enumerate(zip(got["decode"], own["decode"])):
        assert np.abs(g[:B] - w[:B]).max() <= OWN_TOL, f"step {i}"
    for g, w in zip(got["greedy"], own["greedy"]):
        np.testing.assert_array_equal(g, w)
    assert abs(got["loss"] - own["loss"]) <= OWN_TOL
    for g, w in zip(tree_leaves(got["grads"]), tree_leaves(own["grads"])):
        assert float((g - w).abs().max()) <= OWN_TOL


@pytest.mark.parametrize("t,layout", CASES)
@pytest.mark.parametrize("arch", [a for a in MOE if a in HERE])
def test_torch_moe_routes_equal_model_one_on_every_shard(arch, t, layout):
    """Every shard routes each MoE call's tokens as model = 1 does (the
    gathered logits are the whole router product)."""
    own, got = _port_cached(arch, 1)["routes"], _port_cached(arch, t, layout)["routes"]
    calls = len(own)
    assert calls == tconfigs.get_smoke_config(arch).n_layers - \
        tconfigs.get_smoke_config(arch).first_dense_layers
    assert len(got) == calls * t
    for c in range(calls):
        for shard in range(t):
            assert torch.equal(got[c * t + shard], own[c]), (c, shard)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_torch_shard_and_gather_are_inverse_for_every_family(arch, t):
    """gather_params(shard_params(tree)) is the tree, leaf for leaf and bit
    for bit; split_leaves marks exactly the split ones; an SSD layer's fused
    leaves hold chunk i of each section on shard i."""
    cfg = tconfigs.get_smoke_config(arch)
    params = tm.init_params(cfg, torch.Generator().manual_seed(1))
    params = tree_map(lambda p: p + torch.rand_like(p), params)
    grid = make_debug_mesh(1, model=t, device="cpu")
    sharded = specs.shard_params(params, grid, cfg)
    back = specs.gather_params(sharded, grid)
    for (p1, a), (p2, b), s in zip(tree_leaves_with_path(back),
                                   tree_leaves_with_path(params),
                                   specs.split_leaves(sharded)):
        assert p1 == p2 and torch.equal(a, b), p1
    flags = specs.split_leaves(sharded)
    assert any(flags) and not any(specs.split_leaves(params))
    if cfg.family != "ssm":
        return
    d, n, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    ssd, whole = sharded["groups"][0][0]["ssd"], params["groups"][0][0]["ssd"]
    for name, widths in (("in_proj", (d, d, n, n, H)), ("conv_w", (d, n, n)),
                         ("conv_b", (d, n, n))):
        sections = whole[name].split(list(widths), dim=-1)
        for i in range(t):
            want = torch.cat([sec.chunk(t, dim=-1)[i] for sec in sections], -1)
            assert torch.equal(ssd[name][i], want), (name, i)
    assert ssd["norm_scale"] is whole["norm_scale"]          # replicated
    assert ssd["a_log"].shape == (t, H // t)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", HERE)
def test_torch_clip_norm_over_split_leaves_equals_model_one(arch, t):
    """AdamW's global norm over a tree split over the model axis (split
    leaves summed over it, replicated ones counted once) equals the whole
    tree's: every split leaf is a partition, with no channel held twice."""
    cfg = tconfigs.get_smoke_config(arch)
    grads = tree_map(lambda p: torch.randn_like(p.float()),
                     tm.init_params(cfg, torch.Generator().manual_seed(2)))
    grid = make_debug_mesh(1, model=t, device="cpu")
    sharded = specs.shard_params(grads, grid, cfg)
    split = specs.split_leaves(sharded)
    assert any(split)
    got = global_norm(tree_leaves(sharded), grid.model, split)
    want = torch.sqrt(sum(torch.sum(torch.square(g)) for g in tree_leaves(grads)))
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b"])
def test_torch_families_on_gloo_equal_loop_pods(tmp_path, arch):
    """A train step over DistPods(gloo, 2) as the model axis: loss,
    gradients and updated weights bit for bit LoopPods(2)'s; the router
    logits' and the SSD's B / C all-gathers differentiate through
    DistPods' autograd Function (a spawned pair with its own 90 s limit)."""
    script = tmp_path / "model_axis_worker.py"
    script.write_text(WORKER)
    out = subprocess.run([sys.executable, str(script), str(tmp_path), arch],
                         capture_output=True, text=True, timeout=90, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("equal"), out.stdout


def test_torch_moe_elastic_remesh_restore(tmp_path):
    """Qwen3-MoE (smoke, float32) 3 steps at (data 2, model 4), a
    checkpoint, 2 more there, and 2 restored onto (data 2, model 2): the
    two trajectories within 1e-5."""
    from repro_torch.checkpoint import CheckpointManager
    _, cfg, _, tparams = _setup("qwen3_moe_235b_a22b", "f32")
    grid_a, grid_b = _grid(2, 4), _grid(2, 2)
    params = specs.shard_params(tparams, grid_a, cfg)
    assert params["groups"][0][0]["moe"]["we_in"].shape[:2] == (4, 2)
    params, opt, first = _steps(cfg, grid_a, params, adamw_init(params), 0, 3)
    ckpt = CheckpointManager(str(tmp_path / "moe"), async_save=False)
    ckpt.save(3, {"params": params, "opt": opt}, grid=grid_a)
    _, _, uninterrupted = _steps(cfg, grid_a, params, opt, 3, 2)
    state = ckpt.restore(3, _like(cfg), device="cpu", grid=grid_b, cfg=cfg)
    assert state["params"]["groups"][0][0]["moe"]["we_in"].shape[:2] == (2, 4)
    _, _, resumed = _steps(cfg, grid_b, state["params"], state["opt"], 3, 2)
    assert all(np.isfinite(first + resumed))
    assert max(abs(a - b) for a, b in zip(uninterrupted, resumed)) <= OWN_TOL
