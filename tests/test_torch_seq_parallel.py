"""Megatron sequence parallelism over the model axis, on the CPU.

``PerfOptions(seq_parallel=True)`` puts ``act_seq`` on ``model`` in the
rules (``specs.make_rules``, as the reference's option does), and under
those rules the models keep the residual stream as each model shard's
S / t rows between blocks: a block's input is an all-gather along the
sequence and its row-parallel output a reduce-scatter, in place of
``copy_in`` and the block's psum (``models/transformer.py``,
``distributed/pods.py``).  Held here, at smoke widths in float32 on
weights from the reference's ``init_params`` (``test_torch_models._setup``):

  * ``make_rules`` with the option equals the reference's, for every arch
    on one pod and on two;

  * for one config of each family (Yi-6B, Qwen3-MoE, Mamba-2,
    RecurrentGemma, Gemma-3, Whisper) at model 2 and 4 on ``LoopPods``:
    ``lm_loss`` and every gradient (remat "full") bit for bit those without
    it, and so are the forward logits and a prefill's logits and caches;
  * at model 2, the same logits, loss and gradients against the
    reference's ``forward_lm`` and ``lm_loss`` within 1e-4 (the model-axis
    tests' bound), for Qwen3-MoE and Mamba-2 here, and for the other four
    families with the logit soft-cap on in ``test_torch_softcap.py``;
  * a train step over ``DistPods`` on gloo at world 2 (a spawned pair with
    its own 90 s limit) against ``LoopPods(2)``: the loss and the gradients
    of every leaf but the norms' bit for bit, and those within 1e-5 (on
    separate ranks a norm's scale sums two partial gradients, where one
    process sums all its rows at once);
  * the model axis's counted wire bytes equal ``analysis.model_wire`` for
    the sequence-parallel cells of every arch, three steps, at model 2, and
    at model 4 for Qwen3-MoE, Mamba-2 and Whisper;
  * a stack whose length t does not divide runs unsplit and the cell says
    so (``seq_split``), and a decode step (one row) with the option is the
    step without it.
"""
from __future__ import annotations

import dataclasses
import functools
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.distributed.sharding import use_rules  # noqa: E402
from repro_torch.launch import analysis, specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.transformer import gather_vocab, vocab_split  # noqa: E402
from test_torch_model_axis import ROOT  # noqa: E402
from test_torch_models import _setup  # noqa: E402
from test_torch_train import _unstacked_pairs  # noqa: E402

ARCHS = ["yi_6b", "qwen3_moe_235b_a22b", "mamba2_370m", "recurrentgemma_2b",
         "gemma3_4b", "whisper_base"]
B, S, SE = 2, 40, 24
REF_REL = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(tcfg):
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    feats = (rng.standard_normal((B, SE, tcfg.d_model)).astype(np.float32)
             if tcfg.family == "encdec" else None)
    return tokens, feats


def sp_rules(tcfg, grid, sp: bool):
    """The rules a step of ``grid`` runs under, with or without sequence
    parallelism."""
    return use_rules(specs.make_rules(tcfg, grid,
                                      specs.PerfOptions(seq_parallel=sp)))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_torch_seq_parallel_rules_equal_the_references(arch, multi_pod):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = types.SimpleNamespace(axis_names=names)
    grid = make_debug_mesh(2 if multi_pod else 1, model=2, device="cpu")
    for sp in (False, True):
        got = specs.make_rules(tcfg, grid, specs.PerfOptions(seq_parallel=sp))
        want = jspecs.make_rules(jcfg, mesh, jspecs.PerfOptions(seq_parallel=sp))
        assert got.rules == want.rules
        assert (got.lookup("act_seq") == "model") == sp


def _forward(tcfg, params, tokens, feats, tp):
    if feats is not None:
        return tm.forward_encdec(tcfg, params, torch.from_numpy(feats),
                                 torch.from_numpy(tokens), tp)[0]
    return tm.forward_lm(tcfg, params, torch.from_numpy(tokens), tp)[0]


@functools.lru_cache(maxsize=None)
def _run(arch, t, sp):
    """The port at model t with or without sequence parallelism: forward
    logits (whole), loss, gradients (whole tree), a prefill's logits (whole)
    and caches, and the model axis's counters of the train step."""
    _, tcfg, _, _ = _setup(arch, "f32")
    grid = make_debug_mesh(1, model=t, device="cpu")
    with sp_rules(tcfg, grid, sp):
        return _run_under_rules(arch, grid)


def _run_under_rules(arch, grid):
    jcfg, tcfg, _, tparams = _setup(arch, "f32")
    tokens, feats = _inputs(tcfg)
    tp = grid.model
    params = specs.shard_params(tparams, grid, tcfg)
    whole = ((lambda lg: gather_vocab(lg, tp)) if vocab_split(params)
             else (lambda lg: lg))
    with torch.no_grad():
        fwd = whole(_forward(tcfg, params, tokens[:, :-1], feats, tp))
    batch = {"tokens": torch.from_numpy(tokens)}
    if feats is not None:
        batch["enc_feats"] = torch.from_numpy(feats)
    tp.reset_counters()
    total, _, grads = specs._grads(tcfg, params, batch, tp)
    calls = dict(tp.calls)
    it = iter(grads)
    gtree = specs.gather_params(tree_map(lambda _: next(it), params), grid)
    bt = tcfg.kv_block_tokens
    MB = S // bt + 2
    state = tm.init_decode_state(tcfg, B, B * MB, MB,
                                 enc_len=SE if feats is not None else 0,
                                 kv_split=specs.kv_split(tcfg, grid),
                                 state_split=specs.state_split(params, grid),
                                 device="cpu")
    phys = torch.arange(B * MB, dtype=torch.int32).reshape(B, MB)
    with torch.no_grad():
        if feats is not None:
            lg, state = tm.prefill_encdec(tcfg, params, torch.from_numpy(feats),
                                          torch.from_numpy(tokens[:, :S]),
                                          state, phys, tp=tp)
        else:
            lg, state = tm.prefill(tcfg, params, torch.from_numpy(tokens[:, :S]),
                                   state, phys, tp=tp)
    return {"forward": fwd, "loss": total, "grads": gtree,
            "prefill": whole(lg), "caches": state.caches, "calls": calls}


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_seq_parallel_is_bit_equal(arch, t):
    sp, base = _run(arch, t, True), _run(arch, t, False)
    assert sp["calls"].get("reduce_scatter", 0) > 0
    assert "reduce_scatter" not in base["calls"]
    assert torch.equal(sp["forward"], base["forward"])
    assert torch.equal(sp["loss"], base["loss"])
    for g, w in zip(tree_leaves(sp["grads"]), tree_leaves(base["grads"])):
        assert torch.equal(g, w)
    assert torch.equal(sp["prefill"], base["prefill"])
    for c1, c2 in zip(sp["caches"], base["caches"]):
        for name in c1:
            assert torch.equal(c1[name], c2[name]), name


@functools.lru_cache(maxsize=None)
def _reference(arch):
    jcfg, tcfg, jparams, _ = _setup(arch, "f32")
    tokens, feats = _inputs(tcfg)
    batch = {"tokens": jnp.asarray(tokens)}
    if feats is not None:
        fwd = jax.jit(functools.partial(jm.forward_encdec, jcfg, remat=False))(
            jparams, jnp.asarray(feats), jnp.asarray(tokens[:, :-1]))[0]
        batch["enc_feats"] = jnp.asarray(feats)
    else:
        fwd = jax.jit(functools.partial(jm.forward_lm, jcfg, remat=False))(
            jparams, jnp.asarray(tokens[:, :-1]))[0]
    (total, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(jcfg, p, batch, remat=False), has_aux=True))(jparams)
    return np.asarray(fwd), float(total), grads


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "mamba2_370m"])
def test_torch_seq_parallel_matches_the_reference(arch):
    fwd, loss, grads = _reference(arch)
    got = _run(arch, 2, True)
    assert _rel(got["forward"].numpy(), fwd) <= REF_REL
    assert abs(float(got["loss"]) - loss) <= REF_REL * abs(loss)
    _, _, _, tparams = _setup(arch, "f32")
    for name, _, j_leaf in _unstacked_pairs(grads, tparams):
        node = got["grads"]
        for k in name.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        assert _rel(node.numpy(), np.asarray(j_leaf)) <= REF_REL, name


WORKER = r'''
import sys, dataclasses, numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch._tree import tree_leaves_with_path
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import init_params

T = 2


def run(grid, arch):
    """One sequence-parallel gradient over the grid's model axis: the loss
    and this process's gradients, named by their leaves."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = specs.shard_params(init_params(
        cfg, torch.Generator().manual_seed(0)), grid, cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))
    with use_rules(specs.make_rules(cfg, grid,
                                    specs.PerfOptions(seq_parallel=True))):
        grads, m = specs.data_gradients(cfg, params, {"tokens": tokens}, grid)
    out = {"loss": m["loss"][None]}
    for (path, _), g in zip(tree_leaves_with_path(params), grads):
        out["/".join(path)] = g
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
    norms = worst = 0
    for r in range(T):
        got = dict(np.load(f"{out_dir}/rank{r}.npz"))
        for k, w in want.items():
            g = got[k]
            if g.shape != w.shape:          # a split leaf: this rank's shard
                w = w[r:r + 1]
            if "norm" in k and not np.array_equal(g, w):
                rel = np.abs(g - w).max() / np.abs(w).max()
                assert rel <= 1e-5, (k, r, rel)
                norms, worst = norms + 1, max(worst, rel)
                continue
            assert np.array_equal(g, w), (k, r, np.abs(g - w).max())
    print("equal", len(want), norms, worst)
'''


def test_torch_seq_parallel_on_gloo_equals_loop_pods(tmp_path):
    """Yi-6B's sequence-parallel gradient over ``DistPods`` (gloo, world 2):
    the reduce-scatter on the wire, the all-gathers' backward, the norms'
    gradient sums; against ``LoopPods(2)``."""
    script = tmp_path / "seq_parallel_worker.py"
    script.write_text(WORKER)
    out = subprocess.run([sys.executable, str(script), str(tmp_path), "yi_6b"],
                         capture_output=True, text=True, timeout=90, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("equal"), out.stdout


def _smoke_cell(arch, step, t, seq_len=24, **opts):
    grid = make_debug_mesh(1, model=t, device="cpu")
    shape = tconfigs.ShapeSpec(f"{step}_smoke", seq_len, 4, step)
    return grid, specs.build_cell(arch, shape, grid, device="cpu",
                                  cfg=tconfigs.get_smoke_config(arch),
                                  opts=specs.PerfOptions(**opts))


@pytest.mark.parametrize("arch,t", [(arch, 2) for arch in tconfigs.ARCH_IDS]
                         + [(arch, 4) for arch in ("qwen3_moe_235b_a22b",
                                                   "mamba2_370m", "whisper_base")])
def test_torch_seq_parallel_wire_equals_the_count(arch, t):
    """The sequence-parallel cells of a train, a prefill and a decode
    step: the model axis's counters equal ``model_wire``."""
    for step in ("train", "prefill", "decode"):
        grid, cell = _smoke_cell(arch, step, t, seq_parallel=True)
        assert cell.seq_split["decoder"] == (step != "decode")
        grid.model.reset_counters()
        cell.step_fn(*cell.args)
        assert grid.model.wire_bytes == analysis.model_wire(cell), step
        if step != "decode":
            assert grid.model.calls.get("reduce_scatter", 0) > 0


def test_torch_seq_parallel_skips_a_stack_t_does_not_divide():
    """25 rows at t = 2 run unsplit, recorded so, with the counts of the
    cell without the option; Whisper's 24 frames split at t = 4 where its
    decoder's 10 rows do not; Whisper's 1 500 frames (30 s of audio) stay
    unsplit at t = 16 beside its 448 decoder rows; a decode step with the
    option is the step without it."""
    grid, cell = _smoke_cell("yi_6b", "train", 2, seq_len=25,
                             seq_parallel=True)
    assert cell.seq_split == {"decoder": False}
    grid.model.reset_counters()
    cell.step_fn(*cell.args)
    assert "reduce_scatter" not in grid.model.calls
    assert grid.model.wire_bytes == analysis.model_wire(cell)
    cfg = dataclasses.replace(tconfigs.get_smoke_config("whisper_base"),
                              max_decoder_len=10)
    grid = make_debug_mesh(1, model=4, device="cpu")
    cell = specs.build_cell("whisper_base",
                            tconfigs.ShapeSpec("train_smoke", 24, 4, "train"),
                            grid, device="cpu", cfg=cfg,
                            opts=specs.PerfOptions(seq_parallel=True))
    assert cell.seq_split == {"decoder": False, "encoder": True}
    grid.model.reset_counters()
    cell.step_fn(*cell.args)
    assert grid.model.wire_bytes == analysis.model_wire(cell)
    meta = make_debug_mesh(1, data=16, model=16, device="meta")
    c = specs.build_cell("whisper_base",
                         tconfigs.ShapeSpec("train_30s", 1500, 16, "train"),
                         meta, opts=specs.PerfOptions(seq_parallel=True))
    assert c.seq_split == {"decoder": True, "encoder": False}
    tokens = {}
    for sp in (False, True):
        grid, cell = _smoke_cell("qwen3_14b", "decode", 2, seq_parallel=sp)
        grid.model.reset_counters()
        tokens[sp] = cell.step_fn(*cell.args)[0]
        assert cell.seq_split == {"decoder": False}
        tokens[sp, "wire"] = grid.model.wire_bytes
    assert torch.equal(tokens[True], tokens[False])
    assert tokens[True, "wire"] == tokens[False, "wire"]
