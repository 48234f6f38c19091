"""The port's training runtime against the JAX package's, on the CPU: the
synthetic data pipeline (byte for byte), atomic checkpoints, the
fault-tolerant trainer (crash -> restore replays the exact trajectory,
straggler flagging, the reference Trainer's loss trajectory from the same
initial weights) and the ``launch.train`` entry point.  The cases of
``tests/test_runtime.py`` re-expressed for the port, plus parity."""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro import runtime as jruntime  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore_pytree, save_pytree)
from repro_torch.data import SyntheticLMDataset, make_batch_iterator  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import (FailureInjector, StragglerMonitor,  # noqa: E402
                                 Trainer, TrainerConfig)
from repro_torch.runtime import trainer as trainer_mod  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("step,shard,n_shards", [
    (0, 0, 1), (5, 0, 1), (5, 1, 2), (7, 3, 4), (123, 0, 8), (123, 7, 8)])
def test_torch_batch_at_is_byte_identical_to_reference(step, shard, n_shards):
    for vocab, seq in ((1000, 16), (64_000, 129), (512, 9)):
        ours = SyntheticLMDataset(vocab, seq_len=seq, global_batch=8, seed=3)
        theirs = JaxDataset(vocab, seq_len=seq, global_batch=8, seed=3)
        a = ours.batch_at(step, shard, n_shards)["tokens"]
        b = theirs.batch_at(step, shard, n_shards)["tokens"]
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()


def test_torch_data_pipeline_elastic_repartition():
    ds = SyntheticLMDataset(1000, seq_len=16, global_batch=8)
    whole = ds.batch_at(5)["tokens"]
    halves = [ds.batch_at(5, shard=s, n_shards=2)["tokens"] for s in (0, 1)]
    assert np.array_equal(np.concatenate(halves), whole)
    quarters = [ds.batch_at(5, shard=s, n_shards=4)["tokens"] for s in range(4)]
    assert np.array_equal(np.concatenate(quarters), whole)
    with pytest.raises(ValueError):
        ds.batch_at(5, n_shards=3)
    it = make_batch_iterator(ds, start_step=5)
    assert np.array_equal(next(it)["tokens"], whole)
    assert np.array_equal(next(it)["tokens"], ds.batch_at(6)["tokens"])


# ---------------------------------------------------------- checkpoints
def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)},
            "groups": [[{"w": torch.full((2, 2), 3.0)}]]}


def test_torch_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(3, tree)
    mgr.save(7, tree)
    mgr.save(11, tree)
    assert mgr.latest() == 11
    # keep=2 garbage-collects the oldest
    assert latest_step(str(tmp_path)) == 11
    assert not (tmp_path / "step_3").exists() and (tmp_path / "step_7").exists()
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.int32)},
            "groups": [[{"w": torch.zeros(2, 2)}]]}
    out = mgr.restore(11, like)
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32
    assert torch.equal(out["groups"][0][0]["w"], tree["groups"][0][0]["w"])
    names = [e["name"] for e in json.loads(
        (tmp_path / "step_11" / "manifest.json").read_text())["leaves"]]
    assert names == ["a", "b/c", "groups/0/0/w"]
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(str(tmp_path), 11, dict(like, a=torch.zeros(4, 3)))


def test_torch_checkpoint_partial_write_invisible(tmp_path):
    save_pytree(str(tmp_path), 1, {"x": torch.ones(3)})
    # fake a crashed partial write
    bad = tmp_path / "step_9.tmp-dead"
    bad.mkdir()
    (bad / "leaf_0.npy").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == 1
    save_pytree(str(tmp_path), 2, {"x": torch.ones(3)})   # removes the stale one
    assert not bad.exists() and latest_step(str(tmp_path)) == 2


def test_torch_checkpoint_async_error_is_raised_at_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the directory should be")
    mgr = CheckpointManager(str(blocker), keep=2, async_save=True)
    mgr.save(1, {"x": torch.ones(3)})          # the writer fails in its thread
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                  # raised once, then clear
    good = CheckpointManager(str(tmp_path / "ok"), keep=2, async_save=True)
    good.save(4, {"x": torch.ones(3)})
    assert good.latest() == 4


def test_torch_checkpoint_bf16_leaf_is_bit_exact(tmp_path):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32)).to(torch.bfloat16)
    x[0, 0] = float("inf")
    x[0, 1] = -0.0
    tree = {"w": x, "opt": adamw_init({"w": x})}
    save_pytree(str(tmp_path), 5, tree)
    entries = json.loads((tmp_path / "step_5" / "manifest.json").read_text())["leaves"]
    assert entries[0] == {"i": 0, "name": "w", "shape": [7, 5], "dtype": "bfloat16"}
    assert [e["name"] for e in entries] == ["w", "opt/step", "opt/mu/w", "opt/nu/w"]
    assert np.load(tmp_path / "step_5" / "leaf_0.npy").dtype == np.uint16
    out = restore_pytree(str(tmp_path), 5, {"w": torch.zeros(7, 5), "opt": tree["opt"]})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), x.view(torch.int16))
    assert type(out["opt"]).__name__ == "AdamWState"


# -------------------------------------------------------------- trainer
def _run(cfg, ds, schedule, d, device="cpu", total=12):
    t = Trainer(cfg, TrainerConfig(total_steps=total, checkpoint_every=4,
                                   checkpoint_dir=str(d), log_every=100), ds,
                injector=FailureInjector(schedule), device=device)
    return t.run()


def test_torch_trainer_crash_restore_is_deterministic(tmp_path):
    cfg = tconfigs.get_smoke_config("yi_6b")
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=32, global_batch=4)
    clean = _run(cfg, ds, {}, tmp_path / "clean")
    faulty = _run(cfg, ds, {6: "crash"}, tmp_path / "faulty")
    assert faulty["restarts"] == 1
    # the replay from step 4 reproduces the exact loss trajectory (on the
    # CPU bit for bit; the reference's test allows rel 1e-5)
    clean_by_step = {h["step"]: h["loss"] for h in clean["history"]}
    assert [h["step"] for h in faulty["history"]] == [0, 1, 2, 3, 4, 5, 4, 5, 6,
                                                      7, 8, 9, 10, 11]
    for h in faulty["history"]:
        assert h["loss"] == clean_by_step[h["step"]]
    for x, y in zip(tree_leaves(clean["params"]), tree_leaves(faulty["params"])):
        assert torch.equal(x, y)
    assert latest_step(str(tmp_path / "faulty")) == 12
    assert int(faulty["opt"].step) == 12


def test_torch_trainer_resumes_from_the_latest_checkpoint(tmp_path):
    cfg = tconfigs.get_smoke_config("yi_6b")
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=16, global_batch=2)
    first = _run(cfg, ds, {}, tmp_path, total=4)
    second = _run(cfg, ds, {}, tmp_path, total=6)
    assert [h["step"] for h in second["history"]] == [4, 5]
    whole = _run(cfg, ds, {}, tmp_path / "whole", total=6)
    assert [h["loss"] for h in first["history"] + second["history"]] == \
        [h["loss"] for h in whole["history"]]


def test_torch_straggler_monitor_flags_outliers():
    m = StragglerMonitor(factor=2.0, warmup=1)
    times = [1.0, 0.1, 0.11, 0.09, 0.5, 0.1]
    flags = [m.observe(i, t) for i, t in enumerate(times)]
    assert flags == [False, False, False, False, True, False]
    ref = jruntime.StragglerMonitor(factor=2.0, warmup=1)
    assert [ref.observe(i, t) for i, t in enumerate(times)] == flags


def test_torch_trainer_flags_an_injected_straggler(tmp_path):
    cfg = tconfigs.get_smoke_config("yi_6b")
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=16, global_batch=2)
    out = _run(cfg, ds, {7: "slow"}, tmp_path, total=10)
    assert 7 in out["stragglers"]
    assert out["restarts"] == 0


def test_torch_trainer_follows_the_reference_trajectory(tmp_path, monkeypatch):
    """12 steps in float32 of both trainers, each with a crash at step 6,
    from the same initial weights (the reference's ``init_params``
    converted): per-step losses agree within rel 1e-6 (sums in another
    order; the largest drift seen over the 14 steps run is 1.4e-7)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("yi_6b"),
                               dtype=jax.numpy.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("yi_6b"),
                               dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))

    def converted(cfg, gen, **kw):
        return tm.params_from_jax(cfg, tree, device=gen.device)

    monkeypatch.setattr(trainer_mod, "init_params", converted)
    ours = _run(tcfg, SyntheticLMDataset(tcfg.vocab_size, seq_len=32, global_batch=4),
                {6: "crash"}, tmp_path / "port")
    theirs = jruntime.Trainer(
        jcfg, jruntime.TrainerConfig(total_steps=12, checkpoint_every=4,
                                     checkpoint_dir=str(tmp_path / "ref"),
                                     log_every=100),
        JaxDataset(jcfg.vocab_size, seq_len=32, global_batch=4),
        injector=jruntime.FailureInjector({6: "crash"})).run()
    assert [h["step"] for h in ours["history"]] == [h["step"] for h in theirs["history"]]
    for a, b in zip(ours["history"], theirs["history"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-6), (a, b)
    assert ours["history"][-1]["loss"] < ours["history"][0]["loss"]


def test_torch_launch_train_runs_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "8", "--inject-crash", "5", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("done: 9 steps") and "restarts=1" in last, out.stdout
    assert latest_step(str(tmp_path / "ckpt")) == 8
