"""The training math of the port against the JAX package, on the CPU.

``lm_loss`` and its gradients against ``jax.value_and_grad`` of the
reference's ``lm_loss`` for every smoke config, on weights converted by
``params_from_jax`` (norms perturbed as in ``test_torch_models._setup``):
float32 losses agree within rel 1e-5 and each gradient leaf, unstacked,
within 1e-4 of its largest magnitude; bfloat16 losses within rel 0.03, the
reference's own decode tolerance (the port keeps attention's P in float32,
ROADMAP queue 3).  One AdamW step fed the same numpy gradients gives the
reference's parameters, moments and gradient norm within rel 1e-6, with the
reference's weight-decay rule on its stacked tree; ``cosine_lr`` equals the
reference's.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch._tree import tree_leaves, tree_leaves_with_path  # noqa: E402
from test_torch_models import ALL_ARCHS, _f32, _setup  # noqa: E402

B, S = 2, 24


def _batch(jcfg, seed=3, mask=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)}
    if jcfg.family == "encdec":
        batch["enc_feats"] = rng.standard_normal((B, 16, jcfg.d_model)).astype(np.float32)
    if mask:
        batch["mask"] = (rng.random((B, S + 1)) < 0.7).astype(np.float32)
    return batch


def _jax_loss_and_grads(jcfg, jparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, metrics), grads = jax.value_and_grad(
        lambda p: jm.lm_loss(jcfg, p, jb, remat=False), has_aux=True)(jparams)
    return total, metrics, grads


def _port_loss_and_grads(tcfg, tparams, batch):
    for p in tree_leaves(tparams):
        p.requires_grad_(True)
    total, metrics = tm.lm_loss(tcfg, tparams,
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    return total, metrics


def _unstacked_pairs(jtree, ttree, path=""):
    """(name, port leaf, reference leaf) over the reference's tree, each
    group's stacked leaves split into the port's per-layer leaves."""
    for key, jnode in jtree.items():
        if key == "groups":
            for g, jg in enumerate(jnode):
                for li, tl in enumerate(ttree["groups"][g]):
                    yield from _unstacked_pairs(jax.tree.map(lambda a: a[li], jg),
                                                tl, f"{path}groups/{g}/{li}/")
        elif isinstance(jnode, dict):
            yield from _unstacked_pairs(jnode, ttree[key], f"{path}{key}/")
        else:
            yield f"{path}{key}", ttree[key], jnode


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_torch_lm_loss_and_grads_match_jax(arch, dtype):
    """Backward through the port's lm_loss works for every family (the
    Mamba-2 SSD included); float32 loss and every gradient leaf match."""
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype)
    batch = _batch(jcfg)
    jtotal, jmetrics, jgrads = _jax_loss_and_grads(jcfg, jparams, batch)
    total, metrics = _port_loss_and_grads(tcfg, tparams, batch)
    assert total.dtype == torch.float32 and total.dim() == 0
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == B * S
    tol = 1e-5 if dtype == "f32" else 0.03
    for name in ("loss", "aux"):
        want = float(jmetrics[name])
        got = float(metrics[name].detach())
        assert abs(got - want) <= tol * max(abs(want), 1e-6), name
    assert abs(float(total.detach()) - float(jtotal)) <= tol * abs(float(jtotal))
    n = 0
    for name, t, j in _unstacked_pairs(jgrads, tparams):
        assert t.grad is not None, name
        got, want = _f32(t.grad), _f32(j)
        assert got.shape == want.shape and np.isfinite(got).all(), name
        if dtype == "f32":
            err = np.abs(got - want).max()
            assert err <= 1e-4 * np.abs(want).max(), (name, err)
        n += 1
    assert n == len(tree_leaves(tparams))


def test_torch_lm_loss_with_mask_matches_jax():
    """The optional mask: position 0 is dropped with the inputs, the loss
    is the masked mean."""
    jcfg, tcfg, jparams, tparams = _setup("yi_6b", "f32")
    batch = _batch(jcfg, seed=4, mask=True)
    _, jmetrics, jgrads = _jax_loss_and_grads(jcfg, jparams, batch)
    _, metrics = _port_loss_and_grads(tcfg, tparams, batch)
    want = float(jmetrics["loss"])
    assert abs(float(metrics["loss"].detach()) - want) <= 1e-5 * abs(want)
    for name, t, j in _unstacked_pairs(jgrads, tparams):
        got, want = _f32(t.grad), _f32(j)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


def _rel_close(got, want, what, rel=1e-6):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (what, np.abs(got - want).max())


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_370m"])
def test_torch_adamw_step_matches_jax(arch, grad_scale):
    """Two updates with the same numpy gradients on converted float32
    parameters: the first at the schedule's rate (step 1), the second at an
    explicit lr large enough to move every parameter; gradients small
    (no clipping) and large (clipped to norm 1)."""
    jcfg, tcfg, jparams, tparams = _setup(arch, "f32")
    rng = np.random.default_rng(5)
    jgrads = jax.tree.map(lambda a: jnp.asarray(
        grad_scale * rng.standard_normal(a.shape).astype(np.float32)), jparams)
    grads = {n: torch.from_numpy(np.array(_f32(j)))
             for n, _, j in _unstacked_pairs(jgrads, tparams)}
    ordered = [grads["/".join(p)] for p, _ in tree_leaves_with_path(tparams)]

    jstate = jopt.adamw_init(jparams)
    tstate = topt.adamw_init(tparams)
    for lr in (None, 0.05):
        jlr = None if lr is None else jnp.float32(lr)
        tlr = None if lr is None else torch.tensor(lr, dtype=torch.float32)
        jparams, jstate, jnorm = jopt.adamw_update(jparams, jgrads, jstate, lr=jlr)
        tparams, tstate, tnorm = topt.adamw_update(tparams, ordered, tstate, lr=tlr)
        assert int(tstate.step) == int(jstate.step)
        _rel_close(tnorm, jnorm, "grad norm")
        for name, t, j in _unstacked_pairs(jparams, tparams):
            _rel_close(t, j, f"param {name}")
        for tree, jtree, what in ((tstate.mu, jstate.mu, "mu"),
                                  (tstate.nu, jstate.nu, "nu")):
            for name, t, j in _unstacked_pairs(jtree, tree):
                assert t.dtype == torch.float32
                _rel_close(t, j, f"{what} {name}")


@pytest.mark.parametrize("step", [0, 50, 100, 5_000, 10_000, 20_000])
def test_torch_cosine_lr_equals_reference(step):
    want = float(jopt.cosine_lr(jnp.asarray(step, jnp.int32)))
    assert float(topt.cosine_lr(torch.tensor(step, dtype=torch.int32))) == want


def test_torch_weight_decay_follows_the_reference_stacked_rank():
    """With zero gradients only the decay moves a parameter.  The reference
    decays every leaf of rank >= 2 of its tree, where a layer's vectors are
    stacked into [L, D]: a per-layer norm scale is decayed there, the
    top-level final_norm is not.  The port, whose layers are apart, decays
    the same leaves."""
    jcfg, tcfg, jparams, tparams = _setup("yi_6b", "f32")
    jgrads = jax.tree.map(jnp.zeros_like, jparams)
    tgrads = [torch.zeros_like(p) for p in tree_leaves(tparams)]
    before = {n: _f32(t).copy() for n, t, _ in _unstacked_pairs(jparams, tparams)}
    jnew, _, _ = jopt.adamw_update(jparams, jgrads, jopt.adamw_init(jparams),
                                   lr=jnp.float32(0.1))
    tnew, _, _ = topt.adamw_update(tparams, tgrads, topt.adamw_init(tparams),
                                   lr=torch.tensor(0.1))
    moved = {}
    for name, t, j in _unstacked_pairs(jnew, tnew):
        ref_moved = not np.array_equal(_f32(j), before[name])
        assert (not np.array_equal(_f32(t), before[name])) == ref_moved, name
        moved[name] = ref_moved
    assert moved["groups/0/0/norm1/scale"] and moved["groups/0/1/attn/wq"]
    assert moved["embedding"] and moved["lm_head"]
    assert not moved["final_norm/scale"]
    assert topt.adamw.decays(("groups", "0", "0", "norm1", "scale"),
                             torch.zeros(4))
    assert not topt.adamw.decays(("final_norm", "scale"), torch.zeros(4))


def test_torch_adamw_init_layout():
    _, tcfg, _, tparams = _setup("gemma3_4b", "bf16")
    state = topt.adamw_init(tparams)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for p, m, v in zip(tree_leaves(tparams), tree_leaves(state.mu),
                       tree_leaves(state.nu)):
        assert m.shape == v.shape == p.shape
        assert m.dtype == v.dtype == torch.float32 and not m.any() and not v.any()


def test_torch_lm_loss_is_exported_like_the_reference():
    assert tm.lm_loss is tm.transformer.lm_loss
    assert "lm_loss" in tm.__all__ and "lm_loss" in jm.__all__
