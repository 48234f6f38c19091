"""Per-layer rematerialisation in training, on the CPU.

``lm_loss(remat=False | "full" | "dots")``, ``forward_lm`` and
``forward_encdec`` wrap each layer of a training forward in
``torch.utils.checkpoint`` (``models/transformer.py:_run_group``), as the
reference wraps each layer in ``jax.checkpoint``.  Held here:

  * loss and every gradient bit-equal across the three, for each of the ten
    smoke configs at model 1; at model 2 on ``LoopPods`` for a dense config,
    an MoE config and Whisper (the recomputation issues the model axis's
    collectives again, so its wire bytes grow); at world 2 on gloo for the
    MoE config (``DistPods``' collectives re-issued in the backward's
    order on both ranks);
  * the port's ``lm_loss(remat="full")`` against the reference's
    ``jax.value_and_grad`` of ``lm_loss(remat=True)`` at the tolerances of
    ``test_torch_train`` (float32: loss rel 1e-5, each gradient leaf within
    1e-4 of its largest magnitude), for a dense, an MoE, an SSD config and
    Whisper;
  * the bytes saved for the backward (what autograd packs under
    ``saved_tensors_hooks``, plus the products ``"dots"`` caches) strictly
    ordered ``"full"`` < ``"dots"`` < ``False``;
  * the recomputation runs K2's forward (and its LSE) again a layer;
  * ``build_train_step(bf16_grads=True)`` against the reference's at bf16
    tolerance.
"""
from __future__ import annotations

import functools
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw_init, cosine_lr  # noqa: E402
from test_torch_model_axis import ROOT  # noqa: E402
from test_torch_models import ALL_ARCHS, _f32, _setup  # noqa: E402
from test_torch_train import _batch, _unstacked_pairs  # noqa: E402

MODES = (False, "full", "dots")
B, S, SE = 2, 24, 16


def _loss_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["enc_feats"] = torch.from_numpy(
            rng.standard_normal((B, SE, cfg.d_model)).astype(np.float32))
    return batch


def _own(arch):
    cfg = tconfigs.get_smoke_config(arch)
    return cfg, tm.init_params(cfg, torch.Generator().manual_seed(0))


def _loss_and_grads(cfg, params, batch, remat, tp=None):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    cparams = tree_map(lambda _: next(it), params)
    total, metrics = tm.lm_loss(cfg, cparams, batch, tp, remat=remat)
    grads = torch.autograd.grad(total, leaves)
    return total.detach(), metrics["aux"].detach(), grads


def _assert_bit_equal(runs):
    (loss0, aux0, g0), others = runs[0], runs[1:]
    for loss, aux, grads in others:
        assert torch.equal(loss, loss0) and torch.equal(aux, aux0)
        assert len(grads) == len(g0)
        for a, b in zip(grads, g0):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_torch_remat_bit_equal_at_model_one(arch):
    """Loss, aux and every gradient bit-equal with and without remat, in the
    smoke config's own dtypes (bf16 activations)."""
    cfg, params = _own(arch)
    batch = _loss_batch(cfg)
    _assert_bit_equal([_loss_and_grads(cfg, params, batch, m) for m in MODES])


@pytest.mark.parametrize("arch", ["yi_6b", "qwen3_moe_235b_a22b", "whisper_base"])
def test_torch_remat_bit_equal_at_model_two(arch):
    """Over LoopPods(2) as the model axis (``data_gradients``): bit-equal
    losses and gradients; the recomputation issues the model axis's
    collectives again, so its wire bytes grow under remat and stay equal
    between the two policies (``"dots"`` recomputes every collective)."""
    cfg, whole = _own(arch)
    grid = make_debug_mesh(1, model=2, device="cpu")
    params = specs.shard_params(whole, grid, cfg)
    assert any(specs.split_leaves(params))
    batch = _loss_batch(cfg, seed=1)
    runs, wire = [], {}
    for m in MODES:
        grid.model.reset_counters()
        grads, metrics = specs.data_gradients(cfg, params, batch, grid, remat=m)
        runs.append((metrics["loss"], metrics["aux"], grads))
        wire[m] = grid.model.wire_bytes
    _assert_bit_equal(runs)
    assert wire["full"] > wire[False] > 0 and wire["dots"] == wire["full"]


REMAT_WORKER = r'''
import sys, numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_params

T = 2


def worker(rank, port, arch):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=T, rank=rank)
    grid = make_production_mesh(model=T, device="cpu")
    cfg = get_smoke_config(arch)
    params = specs.shard_params(init_params(
        cfg, torch.Generator().manual_seed(0)), grid, cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))
    runs = [specs.data_gradients(cfg, params, {"tokens": tokens}, grid,
                                 remat=m) for m in (False, "full", "dots")]
    (g0, m0) = runs[0]
    for grads, metrics in runs[1:]:
        assert torch.equal(metrics["loss"], m0["loss"])
        assert torch.equal(metrics["aux"], m0["aux"])
        assert all(torch.equal(a, b) for a, b in zip(grads, g0))
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]; s.close()
    mp.spawn(worker, args=(port, sys.argv[1]), nprocs=T)
    print("equal")
'''


def test_torch_remat_on_gloo_bit_equal(tmp_path):
    """Qwen3-MoE over DistPods(gloo, 2) as the model axis: each rank's
    loss, aux and gradient shards bit-equal across the three (the router's
    all-gather, ``copy_in`` and ``psum`` recomputed in the backward on both
    ranks in one order; a spawned pair with its own 90 s limit)."""
    script = tmp_path / "remat_worker.py"
    script.write_text(REMAT_WORKER)
    out = subprocess.run([sys.executable, str(script), "qwen3_moe_235b_a22b"],
                         capture_output=True, text=True, timeout=90, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("equal"), out.stdout


REF_ARCHS = ["yi_6b", "qwen3_moe_235b_a22b", "mamba2_370m", "whisper_base"]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's ``lm_loss(remat=True)``, its value and gradients
    (float32), built once per arch."""
    jcfg, _, jparams, _ = _setup(arch, "f32")
    jb = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(jcfg, p, jb, remat=True), has_aux=True))(jparams)
    return float(total), float(metrics["loss"]), grads


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_torch_remat_matches_reference(arch):
    jcfg, tcfg, _, tparams = _setup(arch, "f32")
    jtotal, jloss, jgrads = _reference(arch)
    for p in tree_leaves(tparams):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    total, metrics = tm.lm_loss(tcfg, tparams, batch, remat="full")
    total.backward()
    assert abs(float(total.detach()) - jtotal) <= 1e-5 * abs(jtotal)
    assert abs(float(metrics["loss"].detach()) - jloss) <= 1e-5 * abs(jloss)
    n = 0
    for name, t, j in _unstacked_pairs(jgrads, tparams):
        got, want = _f32(t.grad), _f32(j)
        assert got.shape == want.shape and np.isfinite(got).all(), name
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
        n += 1
    assert n == len(tree_leaves(tparams))


def _saved_bytes(cfg, params, batch, remat, monkeypatch) -> int:
    """Bytes of the distinct storages kept for the backward by one
    ``lm_loss`` forward: what autograd packs under ``saved_tensors_hooks``
    (the parameters excepted) and the products that ``"dots"`` caches
    (the outputs its policy marks MUST_SAVE)."""
    own = {p.untyped_storage().data_ptr() for p in tree_leaves(params)}
    seen = {}

    def keep(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            seen[st.data_ptr()] = st.nbytes()

    policy = transformer._dots_policy

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == transformer.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            keep(ctx.op_output)
        return out

    monkeypatch.setattr(transformer, "_dots_policy", counting)

    def pack(t):
        keep(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total, _ = tm.lm_loss(cfg, params, batch, remat=remat)
    total.backward()
    return sum(seen.values())


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_torch_remat_saved_bytes_ordered(arch, monkeypatch):
    cfg, params = _own(arch)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = _loss_batch(cfg, seed=2)
    got = {m: _saved_bytes(cfg, params, batch, m, monkeypatch) for m in MODES}
    assert 0 < got["full"] < got["dots"] < got[False], got


def test_torch_remat_recomputes_k2_forward_with_its_lse(monkeypatch):
    """The recomputation runs the flash forward again (with its LSE, which
    the backward reads) once an attention layer; without remat once."""
    cfg, params = _own("yi_6b")
    batch = _loss_batch(cfg)
    calls = []
    forward = flash_ops._forward

    def counted(q, k, v, causal, window, with_lse, **kw):
        calls.append(with_lse)
        return forward(q, k, v, causal, window, with_lse, **kw)

    monkeypatch.setattr(flash_ops, "_forward", counted)
    for m, per_layer in ((False, 1), ("full", 2), ("dots", 2)):
        calls.clear()
        _loss_and_grads(cfg, params, batch, m)
        assert calls == [True] * (per_layer * cfg.n_layers), (m, calls)


def test_torch_remat_never_wraps_a_prefill(monkeypatch):
    """A prefill (cache given) and a forward that autograd does not record
    never go through ``checkpoint``; ``remat`` takes the reference's four
    values only."""
    cfg, params = _own("yi_6b")
    for p in tree_leaves(params):
        p.requires_grad_(True)

    def refuse(*a, **k):
        raise AssertionError("checkpoint called")

    monkeypatch.setattr(transformer, "checkpoint", refuse)
    tokens = _loss_batch(cfg)["tokens"][:, :S]
    bt = cfg.kv_block_tokens
    mb = -(-S // bt)
    state = tm.init_decode_state(cfg, B, B * mb, mb, device="cpu")
    phys = torch.arange(B * mb, dtype=torch.int32).view(B, mb)
    tm.prefill(cfg, params, tokens, state, phys)
    with torch.no_grad():
        tm.forward_lm(cfg, params, tokens, remat="full")
    with pytest.raises(AssertionError, match="checkpoint called"):
        tm.forward_lm(cfg, params, tokens, remat=True)
    with pytest.raises(ValueError, match="remat"):
        tm.forward_lm(cfg, params, tokens, remat="everything")
    with pytest.raises(ValueError, match="remat"):
        specs.build_train_step(cfg, remat="everything")


@pytest.mark.parametrize("arch", ["yi_6b", "qwen3_moe_235b_a22b"])
def test_torch_bf16_grads_matches_reference(arch):
    """One ``build_train_step(bf16_grads=True)`` step against the
    reference's (float32 master weights): loss and gradient norm within
    bf16's rel 0.03; each gradient leaf is bf16-valued and cast back to
    float32, within 0.03 of its largest magnitude of the reference's bf16
    gradient; the matrices (and the stacked vectors) were differentiated in
    bf16, the top-level final norm in float32, as the reference's rank rule
    says; a first Adam step moves each parameter within lr (1 + decay |p|)
    of the reference's."""
    jcfg, tcfg, jparams, tparams = _setup(arch, "f32")
    tokens = np.asarray(_batch(jcfg)["tokens"])
    jb = {"tokens": jnp.asarray(tokens)}
    jp, _, jmet = jspecs.build_train_step(jcfg, bf16_grads=True)(
        jparams, joptim.adamw_init(jparams), jb)
    low = jax.tree.map(lambda p: p.astype(jnp.bfloat16) if p.ndim >= 2 else p,
                       jparams)
    jgrads = jax.grad(lambda p: jm.lm_loss(jcfg, p, jb)[0])(low)

    batch = {"tokens": torch.from_numpy(tokens)}
    _, metrics, grads = specs._grads(tcfg, tparams, batch, bf16_grads=True)
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), tparams)
    for name, g, j in _unstacked_pairs(jgrads, gtree):
        assert g.dtype == torch.float32, name
        if name != "final_norm/scale":
            assert torch.equal(g, g.to(torch.bfloat16).float()), name
        want = _f32(j)
        assert np.abs(_f32(g) - want).max() <= 0.03 * np.abs(want).max(), name
    norm, vector = tparams["final_norm"]["scale"], tparams["groups"][0][0]["norm1"]["scale"]
    assert specs._compute_copy(("final_norm", "scale"), norm, True).dtype == torch.float32
    assert specs._compute_copy(("groups", "0", "0", "norm1", "scale"), vector,
                               True).dtype == torch.bfloat16
    p, _, m = specs.build_train_step(tcfg, bf16_grads=True)(
        tparams, adamw_init(tparams), batch)
    for key in ("loss", "grad_norm"):
        want = float(jmet[key])
        assert abs(float(m[key]) - want) <= 0.03 * abs(want), key
    lr = float(cosine_lr(torch.tensor(1)))
    want = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    for got, w in zip(tree_leaves(p), tree_leaves(want)):
        assert got.dtype == torch.float32
        assert (got - w).abs().max() <= 2 * lr * (1 + 0.1 * w.abs().max()) * 1.01
