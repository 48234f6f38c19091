"""Atomic checkpointing of the port's trees, the reference's on-disk
protocol (``src/repro/checkpoint/store.py``).

Layout:  <dir>/step_<N>.tmp-<nonce>/   (written)
         <dir>/step_<N>/               (atomic rename on completion)
             manifest.json             step, leaf index, names, shapes/dtypes, extra
             leaf_<i>.npy              one file per tree leaf

Crash-safety: a checkpoint is visible iff the rename committed; partial
writes are left as .tmp-* and removed by the next save.  Leaves are named by
their tree paths (``params/groups/0/1/attn/wq``).  numpy has no bfloat16: a
bf16 leaf is stored as its uint16 bits with ``"dtype": "bfloat16"`` in the
manifest and restored bit for bit.  ``restore`` puts each leaf on the
device of the matching leaf of ``like`` (or on ``device``); a sharded
restore is not ported (ROADMAP queue 1 item 13).  The async mode hands the
host copies to a writer thread, so the train loop blocks only on the
previous save; a writer's error is raised by the next ``wait()``.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .._device import DeviceLike
from .._tree import tree_leaves_with_path, tree_map, tree_map_with_path

PyTree = Any


def _host(leaf) -> Any:
    """A host copy of a leaf: a CPU tensor for a tensor, else numpy."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _to_numpy(leaf):
    """(array, dtype name of the manifest)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_pytree(directory: str, step: int, tree: PyTree,
                extra: Optional[Dict] = None) -> pathlib.Path:
    base = pathlib.Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    for stale in base.glob("step_*.tmp-*"):
        shutil.rmtree(stale, ignore_errors=True)
    tmp = base / f"step_{step}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir()
    manifest = {"step": step, "leaves": [], "extra": extra or {},
                "time": time.time()}
    for i, (path, leaf) in enumerate(tree_leaves_with_path(tree)):
        arr, dtype = _to_numpy(leaf)
        np.save(tmp / f"leaf_{i}.npy", arr)
        manifest["leaves"].append(
            {"i": i, "name": "/".join(path), "shape": list(arr.shape),
             "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = base / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)        # atomic commit
    return final


def latest_step(directory: str) -> Optional[int]:
    base = pathlib.Path(directory)
    if not base.exists():
        return None
    steps = []
    for p in base.glob("step_*"):
        if ".tmp-" in p.name:
            continue
        if (p / "manifest.json").exists():
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_pytree(directory: str, step: int, like: PyTree,
                   device: DeviceLike = None) -> PyTree:
    """Restore into the structure of ``like``: each leaf with its stored
    dtype, on ``device`` if given, else on the device of ``like``'s leaf."""
    path = pathlib.Path(directory) / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def load(leaf_path, ref):
        name = "/".join(leaf_path)
        entry = by_name.get(name)
        if entry is None:
            raise KeyError(f"checkpoint {path} missing leaf {name}")
        arr = np.load(path / f"leaf_{entry['i']}.npy")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(ref.shape)}")
        target = device if device is not None else (
            ref.device if torch.is_tensor(ref) else "cpu")
        return _from_numpy(arr, entry["dtype"]).to(target)

    return tree_map_with_path(load, like)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async writes."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None
             ) -> None:
        self.wait()
        host_tree = tree_map(_host, tree)

        def _write():
            try:
                save_pytree(str(self.directory), step, host_tree, extra)
                self._gc()
            except BaseException as e:     # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self.wait()

    def _gc(self) -> None:
        steps: List[int] = sorted(
            int(p.name.split("_")[1]) for p in self.directory.glob("step_*")
            if ".tmp-" not in p.name and (p / "manifest.json").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(str(self.directory))

    def restore(self, step: int, like: PyTree,
                device: DeviceLike = None) -> PyTree:
        self.wait()
        return restore_pytree(str(self.directory), step, like, device)
