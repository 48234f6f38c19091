"""Elastic re-mesh restore of the port: the counterpart of
``tests/test_elastic.py``, on the CPU with Yi-6B's smoke config in float32.

A run trains 6 steps on a (data 2, model 4) grid, checkpoints (the leaves
split over the model axis gathered whole), and either continues 4 steps on
the same grid or restores onto (data 2, model 2) and runs those 4 steps
there.  The two loss trajectories agree within 1e-5 (the float32 bound
here), and both within the reference's 2e-2 of the reference's own
unsharded trajectory from the same weights and batches
(``repro.launch.specs.build_train_step`` without a mesh).  A checkpoint
taken at model = 4 holds the leaf names, shapes and dtypes of one taken at
model = 1, and the bytes of the gathered live shards.  The trainer runs on a
grid too (crash replay exact).  The other families' restore (Qwen3-MoE) is
in ``tests/test_torch_model_axis_families.py``.
"""
from __future__ import annotations

import functools
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.common import SHAPES_ONLY  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import (FailureInjector, Trainer,  # noqa: E402
                                 TrainerConfig)
from test_torch_models import _setup  # noqa: E402

ARCH = "yi_6b"
OWN_TOL = 1e-5         # the same run over two grids, float32
REF_TOL = 2e-2         # the reference's own elastic bound


def _dataset(cfg):
    return SyntheticLMDataset(cfg.vocab_size, seq_len=32, global_batch=8)


def _steps(cfg, grid, params, opt, start, n):
    ds, step = _dataset(cfg), specs.build_train_step(cfg, pods=grid)
    losses = []
    for i in range(start, start + n):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return params, opt, losses


def _grid(data, model):
    return make_debug_mesh(1, data=data, model=model, device="cpu")


def _like(cfg):
    whole = init_params(cfg, SHAPES_ONLY)
    return {"params": whole, "opt": adamw_init(whole)}


@functools.lru_cache(maxsize=None)
def _elastic(tmp: str):
    """(first 6 losses, the uninterrupted last 4, the restored last 4, the
    live tree at step 6 gathered)."""
    _, cfg, _, tparams = _setup(ARCH, "f32")
    grid_a, grid_b = _grid(2, 4), _grid(2, 2)
    params = specs.shard_params(tparams, grid_a, cfg)
    params, opt, first = _steps(cfg, grid_a, params, adamw_init(params), 0, 6)
    ckpt = CheckpointManager(f"{tmp}/model4", async_save=False)
    ckpt.save(6, {"params": params, "opt": opt}, grid=grid_a)
    live = tree_map(torch.clone, specs.gather_params(       # a snapshot
        {"params": params, "opt": opt}, grid_a))
    _, _, uninterrupted = _steps(cfg, grid_a, params, opt, 6, 4)
    state = ckpt.restore(6, _like(cfg), device="cpu", grid=grid_b, cfg=cfg)
    assert state["params"]["lm_head"].shape == (2, 64, 256)
    _, _, resumed = _steps(cfg, grid_b, state["params"], state["opt"], 6, 4)
    return first, uninterrupted, resumed, live


@functools.lru_cache(maxsize=None)
def _reference_losses():
    jcfg, _, jparams, _ = _setup(ARCH, "f32")
    step, ds = jspecs.build_train_step(jcfg), _dataset(jcfg)
    opt, losses = joptim.adamw_init(jparams), []
    for i in range(10):
        batch = {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}
        jparams, opt, m = step(jparams, opt, batch)
        losses.append(float(m["loss"]))
    return losses


def test_torch_elastic_remesh_restore(tmp_path_factory):
    first, uninterrupted, resumed, _ = _elastic(
        str(tmp_path_factory.getbasetemp() / "elastic"))
    drift = max(abs(a - b) for a, b in zip(uninterrupted, resumed))
    assert drift <= OWN_TOL, (uninterrupted, resumed)
    assert uninterrupted[-1] < first[0]
    ref = _reference_losses()
    for got in (first + uninterrupted, first + resumed):
        assert max(abs(a - b) for a, b in zip(got, ref)) < REF_TOL, (got, ref)


def test_torch_checkpoint_at_model_4_has_the_unsharded_leaves(tmp_path_factory,
                                                              tmp_path):
    base = tmp_path_factory.getbasetemp() / "elastic"
    _, _, _, live = _elastic(str(base))
    # the same 6 steps with no model axis (data 2): its checkpoint's leaves
    _, cfg, _, tparams = _setup(ARCH, "f32")
    grid_1 = _grid(2, 1)
    params, opt, _ = _steps(cfg, grid_1, tparams, adamw_init(tparams), 0, 6)
    CheckpointManager(str(tmp_path / "model1"), async_save=False).save(
        6, {"params": params, "opt": opt}, grid=grid_1)
    # the live shards gathered, written without a grid
    CheckpointManager(str(tmp_path / "gathered"), async_save=False).save(
        6, live)
    read = lambda d: json.loads((pathlib.Path(d) / "step_6" /
                                 "manifest.json").read_text())["leaves"]
    m4, m1 = read(base / "model4"), read(tmp_path / "model1")
    strip = lambda m: [(e["name"], e["shape"], e["dtype"]) for e in m]
    assert strip(m4) == strip(m1) == strip(read(tmp_path / "gathered"))
    for e in m4:
        a = np.load(base / "model4" / "step_6" / f"leaf_{e['i']}.npy")
        b = np.load(tmp_path / "gathered" / "step_6" / f"leaf_{e['i']}.npy")
        c = np.load(tmp_path / "model1" / "step_6" / f"leaf_{e['i']}.npy")
        assert a.tobytes() == b.tobytes(), e["name"]
        assert np.abs(a.astype(np.float64) - c).max() <= OWN_TOL, e["name"]


def test_torch_trainer_on_a_grid_replays_a_crash_and_resumes_elsewhere(tmp_path):
    """The Trainer over (data 2, model 2): a crash at step 3 replays from
    the step-2 checkpoint to the clean run's losses; then a trainer over
    (data 1, model 4) resumes from that run's last checkpoint."""
    cfg = tconfigs.get_smoke_config(ARCH)
    ds = _dataset(cfg)
    run = lambda d, steps, sched, grid: Trainer(
        cfg, TrainerConfig(total_steps=steps, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path / d), log_every=100),
        ds, injector=FailureInjector(sched), device="cpu", grid=grid).run()
    clean = run("clean", 5, {}, _grid(2, 2))
    crashed = run("crash", 5, {3: "crash"}, _grid(2, 2))
    assert crashed["restarts"] == 1
    assert [h["loss"] for h in crashed["history"][-2:]] == \
        [h["loss"] for h in clean["history"][-2:]]
    more = run("clean", 7, {}, _grid(1, 4))
    assert [h["step"] for h in more["history"]] == [5, 6]
    assert more["params"]["embedding"].shape == (4, 128, 64)
