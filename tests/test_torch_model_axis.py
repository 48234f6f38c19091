"""The in-pod model axis (tensor parallelism) of the port, on the CPU.

The four dense global-attention archs (Qwen3-14B, Yi-6B, Nemotron-4-15B,
Chameleon-34B: smoke widths, float32, weights from ``repro.models.init_params``
through ``params_from_jax``, norms perturbed as in ``test_torch_models``)
are split over ``LoopPods(t)`` for t in {2, 4} by ``shard_params`` and held
against

  * the reference's *unsharded* JAX functions: ``forward_lm``, ``prefill`` +
    4 ``decode_step``s (``kernel="ref"``), ``lm_loss`` and its gradients —
    every logit and gradient within relative 1e-4 (of the largest
    magnitude);
  * the port's own ``model = 1`` run of the same functions — within 1e-5,
    greedy tokens equal.

The smoke configs (4 heads on 2 kv heads) keep SINGLE_POD_RULES' default of
``kv_heads`` on the model axis: at t = 2 the paged slabs are split (one
[N, bt, 1, hd] slab a shard), at t = 4 they are replicated (each shard's
one query head reads its kv head of the slab through K1's head range), and
at t = 2 the configs' own rule (``kv_heads`` unsharded) is run too.  Then
``DistPods`` on gloo at world 2 as the model axis gives one train step's
loss, gradients and updated weights bit for bit equal to ``LoopPods(2)``'s
(a spawned pair with its own 90 s limit).
"""
from __future__ import annotations

import functools
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.distributed.sharding import ShardingRules  # noqa: E402
from repro_torch.kernels.paged_attention import (paged_attention,  # noqa: E402
                                                 paged_attention_ref)
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.transformer import gather_vocab  # noqa: E402
from test_torch_models import _setup  # noqa: E402
from test_torch_train import _unstacked_pairs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
DENSE = ["qwen3_14b", "yi_6b", "nemotron_4_15b", "chameleon_34b"]
B, S, STEPS = 2, 24, 4
REF_REL = 1e-4         # against the reference's unsharded functions
OWN_TOL = 1e-5         # against the port's model = 1 run
#: t and the KV layout: "rules" keeps SINGLE_POD_RULES' kv_heads on model
#: (split at t = 2, replicated at t = 4), "replicated" the configs' own
#: kv_heads -> None
CASES = [(2, "rules"), (2, "replicated"), (4, "rules")]


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
    loss_batch = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return tokens, phys, MB, loss_batch


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's unsharded forward logits, prefill + decode logits
    (fed its own greedy tokens), loss and unstacked gradients."""
    jcfg, tcfg, jparams, _ = _setup(arch, "f32")
    tokens, phys, MB, loss_batch = _inputs(jcfg)
    fwd = np.asarray(jm.forward_lm(jcfg, jparams, jnp.asarray(tokens[:B]),
                                   remat=False)[0])
    state = jm.init_decode_state(jcfg, B + 1, (B + 1) * MB, MB)
    lg, state = jm.prefill(jcfg, jparams, jnp.asarray(tokens), state,
                           jnp.asarray(phys))
    steps, toks = [np.asarray(lg)], []
    for _ in range(STEPS):
        tok = jm.greedy_sample(lg)
        toks.append(np.asarray(tok))
        lg, state = jm.decode_step(jcfg, jparams, state, tok,
                                   jnp.asarray(phys), kernel="ref")
        steps.append(np.asarray(lg))
    (total, _), grads = jax.value_and_grad(
        lambda p: jm.lm_loss(jcfg, p, {"tokens": jnp.asarray(loss_batch)},
                             remat=False), has_aux=True)(jparams)
    return {"forward": fwd, "decode": steps, "tokens": toks,
            "loss": float(total), "grads": grads}


def _rules(layout):
    if layout == "rules":
        return None                       # the smoke config's own (default)
    return ShardingRules(rules=(("heads", "model"), ("kv_heads", None),
                                ("ff", "model"), ("vocab", "model")))


def _port(arch, t, layout="rules"):
    """The port's forward logits, prefill + decode logits (fed the
    reference's tokens) and greedy tokens, loss and whole gradients, on a
    model axis of t (t = 1: no grid at all)."""
    jcfg, tcfg, _, tparams = _setup(arch, "f32")
    tokens, phys, MB, loss_batch = _inputs(jcfg)
    ref = _reference(arch)
    grid = make_debug_mesh(1, model=t, device="cpu")
    tp = grid.model if t > 1 else None
    rules = _rules(layout)
    params = specs.shard_params(tparams, grid, tcfg, rules)
    whole = (lambda lg: gather_vocab(lg, tp)) if tp is not None else (lambda lg: lg)
    out = {"forward": whole(tm.forward_lm(
        tcfg, params, torch.from_numpy(tokens[:B]), tp)[0]).detach().numpy()}
    split = specs.kv_split(tcfg, grid, rules) if t > 1 else 1
    state = tm.init_decode_state(tcfg, B + 1, (B + 1) * MB, MB,
                                 kv_split=split, device="cpu")
    out["kv_layout"] = "split" if split > 1 else "replicated"
    tphys = torch.from_numpy(phys)
    with torch.no_grad():
        lg, state = tm.prefill(tcfg, params, torch.from_numpy(tokens), state,
                               tphys, tp=tp)
        steps, greedy = [whole(lg).numpy()], []
        for tok in ref["tokens"]:
            greedy.append(tm.greedy_sample(lg, tp).numpy())
            lg, state = tm.decode_step(tcfg, params, state,
                                       torch.from_numpy(np.array(tok)), tphys,
                                       tp=tp)
            steps.append(whole(lg).numpy())
    out.update(decode=steps, greedy=greedy)
    total, _, grads = specs._grads(tcfg, params,
                                   {"tokens": torch.from_numpy(loss_batch)}, tp)
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), params)
    out["loss"] = float(total)
    out["grads"] = specs.gather_params(gtree, grid) if t > 1 else gtree
    return out


@functools.lru_cache(maxsize=None)
def _port_cached(arch, t, layout="rules"):
    return _port(arch, t, layout)


@pytest.mark.parametrize("t,layout", CASES)
@pytest.mark.parametrize("arch", DENSE)
def test_torch_model_axis_matches_the_reference(arch, t, layout):
    ref, got = _reference(arch), _port_cached(arch, t, layout)
    assert got["kv_layout"] == ("split" if (t, layout) == (2, "rules")
                                else "replicated")
    assert _rel(got["forward"], ref["forward"]) <= REF_REL
    for i, (g, w) in enumerate(zip(got["decode"], ref["decode"])):
        assert _rel(g[:B], w[:B]) <= REF_REL, f"step {i}"
    assert abs(got["loss"] - ref["loss"]) <= REF_REL * abs(ref["loss"])
    _, tcfg, _, tparams = _setup(arch, "f32")
    n = 0
    for name, t_leaf, j_leaf in _unstacked_pairs(ref["grads"], tparams):
        path = tuple(name.split("/"))
        node = got["grads"]
        for k in path:
            node = node[int(k)] if isinstance(node, list) else node[k]
        assert _rel(node.numpy(), np.asarray(j_leaf)) <= REF_REL, name
        n += 1
    assert n == len(tree_leaves(tparams))


@pytest.mark.parametrize("t,layout", CASES)
@pytest.mark.parametrize("arch", DENSE)
def test_torch_model_axis_matches_model_one(arch, t, layout):
    own, got = _port_cached(arch, 1), _port_cached(arch, t, layout)
    assert np.abs(got["forward"] - own["forward"]).max() <= OWN_TOL
    for i, (g, w) in enumerate(zip(got["decode"], own["decode"])):
        assert np.abs(g[:B] - w[:B]).max() <= OWN_TOL, f"step {i}"
    for g, w in zip(got["greedy"], own["greedy"]):
        np.testing.assert_array_equal(g, w)
    assert abs(got["loss"] - own["loss"]) <= OWN_TOL
    for g, w in zip(tree_leaves(got["grads"]), tree_leaves(own["grads"])):
        assert float((g - w).abs().max()) <= OWN_TOL


@pytest.mark.parametrize("t", [2, 4])
def test_torch_greedy_sample_over_shards_takes_the_lowest_tied_index(t):
    """Ties across and within shards resolve to the lowest global index,
    as argmax does on the whole row."""
    grid = make_debug_mesh(1, model=t, device="cpu")
    V = 8 * t
    logits = torch.zeros((5, V))
    logits[0, [3, V - 1]] = 2.0                 # tie across shards
    logits[1, [9, 10]] = 1.0                    # tie inside a shard
    logits[2] = -1.0                            # every entry tied
    logits[3, V - 1] = 3.0
    logits[4] = torch.linspace(0.0, 1.0, V)
    shards = logits.view(5, t, 8).permute(1, 0, 2)
    got = tm.greedy_sample(shards, grid.model)
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1).int().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_paged_attention_reads_a_kv_head_range(dtype):
    """K1's plain version over kv heads [first, first + count) of a slab
    equals it over the sliced slab copy, the slab untouched."""
    rng = np.random.default_rng(11)
    N, bt, K, hd, Bq, MB = 12, 4, 4, 16, 3, 3
    ks = torch.from_numpy(rng.standard_normal((N, bt, K, hd))).to(dtype)
    vs = torch.from_numpy(rng.standard_normal((N, bt, K, hd))).to(dtype)
    tables = torch.from_numpy(rng.permutation(N)[:Bq * MB].reshape(Bq, MB)
                              .astype(np.int32))
    lens = torch.tensor([5, 12, 9], dtype=torch.int32)
    for first, count, H in ((0, 2, 4), (2, 2, 6), (3, 1, 2)):
        q = torch.from_numpy(rng.standard_normal((Bq, H, hd))).to(dtype)
        got = paged_attention(q, ks, vs, tables, lens, kv_heads=(first, count))
        want = paged_attention_ref(
            q, ks[:, :, first:first + count].contiguous(),
            vs[:, :, first:first + count].contiguous(), tables, lens)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="kv heads"):
        paged_attention(q, ks, vs, tables, lens, kv_heads=(3, 2))


WORKER = r'''
import sys, dataclasses, numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import init_params
from repro_torch.optim import adamw_init

T = 2


def run(grid, arch):
    """One train step over the grid's model axis: the loss, the gradients
    (this process's shards) and the updated weights."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = specs.shard_params(init_params(
        cfg, torch.Generator().manual_seed(0)), grid, cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))
    grads, m = specs.data_gradients(cfg, params, {"tokens": tokens}, grid)
    stepped, _, m2 = specs.build_train_step(cfg, pods=grid)(
        params, adamw_init(params), {"tokens": tokens})
    out = {"loss": m["loss"][None], "step_loss": m2["loss"][None],
           "grad_norm": m2["grad_norm"][None]}
    for i, (g, w) in enumerate(zip(grads, tree_leaves(stepped))):
        out[f"grad{i}"], out[f"weight{i}"] = g, w
    return out


def worker(rank, port, out_dir, arch):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=T, rank=rank)
    got = run(make_production_mesh(model=T, device="cpu"), arch)
    np.savez(f"{out_dir}/rank{rank}.npz",
             **{k: v.detach().numpy() for k, v in got.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]; s.close()
    out_dir, arch = sys.argv[1], sys.argv[2]
    mp.spawn(worker, args=(port, out_dir, arch), nprocs=T)
    want = {k: v.detach().numpy() for k, v in run(
        make_debug_mesh(1, model=T, device="cpu"), arch).items()}
    split = 0
    for r in range(T):
        got = dict(np.load(f"{out_dir}/rank{r}.npz"))
        for k, w in want.items():
            g = got[k]
            if g.shape != w.shape:          # a split leaf: this rank's shard
                w, split = w[r:r + 1], split + 1
            assert np.array_equal(g, w), (k, r, np.abs(g - w).max())
    assert split > 0
    print("equal", len(want), split)
'''


@pytest.mark.parametrize("arch", ["qwen3_14b", "yi_6b"])
def test_torch_dist_model_axis_on_gloo_equals_loop_pods(tmp_path, arch):
    """Qwen3's qk-norm scales and its replicated-norm gradients go through
    DistPods' copy_in; both archs split every matrix at t = 2."""
    script = tmp_path / "model_axis_worker.py"
    script.write_text(WORKER)
    out = subprocess.run([sys.executable, str(script), str(tmp_path), arch],
                         capture_output=True, text=True, timeout=90, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("equal"), out.stdout


def test_torch_grid_defaults_to_the_card():
    """A grid asked for without a device lies on the GPU, and raises where
    there is none; only device="cpu" builds it on the CPU."""
    if torch.cuda.is_available():
        assert make_debug_mesh(1, model=2).model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="none is available"):
            make_debug_mesh(1, model=2)
    grid = make_debug_mesh(2, data=2, model=4, device="cpu")
    assert (grid.n, grid.data.n, grid.model.n) == (2, 2, 4)
    assert grid.pod is grid and grid.model.device == torch.device("cpu")
    assert make_debug_mesh(3, device="cpu").model.n == 1
