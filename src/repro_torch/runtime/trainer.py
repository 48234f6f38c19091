"""Fault-tolerant training runtime, the reference's control flow
(``src/repro/runtime/trainer.py``) on one device.

  * **checkpoint/restart** — atomic checkpoints every K steps; on an
    injected crash the trainer restores the last committed checkpoint and
    replays (the data pipeline is counter-deterministic and the step has no
    float atomics, so the replay is exact).
  * **straggler mitigation** — per-step wall times feed an EMA monitor;
    steps slower than ``factor`` x EMA are flagged.
  * The elastic re-mesh of the reference (``shrink``) needs the multi-device
    layer (ROADMAP queue 1 item 13): the injector accepts the kind and the
    trainer ignores it, as the reference's loop does.

A step is ``lm_loss`` -> ``.backward()`` -> ``adamw_update``; its time
``dt`` ends with ``float(loss)``, which waits for the device.  Parameters
are drawn from ``torch.Generator(device).manual_seed(seed)`` on the card
unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from .._tree import tree_leaves
from ..checkpoint import CheckpointManager
from ..data import SyntheticLMDataset
from ..models import init_params, lm_loss
from ..models.common import ModelConfig
from ..optim import adamw_init, adamw_update

PyTree = Any


class FailureInjector:
    """Deterministic fault schedule: {step: kind} with kinds
    'crash' (lose un-checkpointed state), 'slow' (straggler),
    'shrink' (lose a node -> elastic re-mesh)."""

    def __init__(self, schedule: Optional[Dict[int, str]] = None):
        self.schedule = dict(schedule or {})
        self.fired: List[tuple] = []

    def check(self, step: int) -> Optional[str]:
        kind = self.schedule.pop(step, None)
        if kind:
            self.fired.append((step, kind))
        return kind


class StragglerMonitor:
    def __init__(self, factor: float = 2.5, ema: float = 0.9,
                 warmup: int = 2):
        self.factor = factor
        self.ema_coef = ema
        self.warmup = warmup      # ignore the first steps (kernel builds)
        self.seen = 0
        self.ema: Optional[float] = None
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.seen <= self.warmup:
            return False
        is_straggler = (self.ema is not None
                        and dt > self.factor * self.ema)
        if is_straggler:
            self.flagged.append(step)
            # do NOT fold the outlier into the EMA (it would mask a
            # persistently slow host) — just record it
            return True
        self.ema = dt if self.ema is None else \
            self.ema_coef * self.ema + (1 - self.ema_coef) * dt
        return False


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 50
    checkpoint_every: int = 10
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 2
    log_every: int = 10
    seed: int = 0


def train_step(cfg: ModelConfig, params: PyTree, opt_state, batch
               ) -> Tuple[PyTree, Any, Dict[str, torch.Tensor]]:
    """One step: ``lm_loss`` -> ``.backward()`` -> ``adamw_update`` (in
    place).  ``params`` must require grad.  Returns (params, the new
    optimizer state, the metrics of ``lm_loss`` plus ``grad_norm``, all
    detached)."""
    leaves = tree_leaves(params)
    total, metrics = lm_loss(cfg, params, batch)
    total.backward()
    params, opt_state, gnorm = adamw_update(params, [p.grad for p in leaves],
                                            opt_state)
    for p in leaves:
        p.grad = None
    metrics = {k: v.detach() for k, v in metrics.items()}
    return params, opt_state, dict(metrics, grad_norm=gnorm)


def trainable(params: PyTree) -> PyTree:
    """``params`` with every leaf requiring grad (in place)."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 dataset: SyntheticLMDataset,
                 injector: Optional[FailureInjector] = None,
                 step_fn: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.injector = injector or FailureInjector()
        self.monitor = StragglerMonitor()
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep,
                                      async_save=False)
        self.history: List[Dict] = []
        self.restarts = 0
        self.remeshes = 0
        self._step_fn = step_fn or self._default_step()

    def _default_step(self) -> Callable:
        return functools.partial(train_step, self.cfg)

    def _fresh(self):
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = trainable(init_params(self.cfg, gen))
        return params, adamw_init(params)

    def _restore(self, step: int, params, opt):
        state = self.ckpt.restore(step, {"params": params, "opt": opt},
                                  device=self.device)
        return trainable(state["params"]), state["opt"]

    # ------------------------------------------------------------------ run
    def run(self) -> Dict[str, Any]:
        params, opt = self._fresh()
        step = 0
        latest = self.ckpt.latest()
        if latest is not None:
            params, opt = self._restore(latest, params, opt)
            step = latest

        while step < self.tcfg.total_steps:
            fault = self.injector.check(step)
            if fault == "crash":
                # lose in-memory state; restore from last commit
                self.restarts += 1
                latest = self.ckpt.latest()
                if latest is None:
                    params, opt = self._fresh()
                    step = 0
                else:
                    params, opt = self._restore(latest, params, opt)
                    step = latest
                continue

            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.dataset.batch_at(step).items()}
            params, opt, metrics = self._step_fn(params, opt, batch)
            loss = float(metrics["loss"])      # waits for the device
            dt = time.perf_counter() - t0
            if fault == "slow":
                dt *= 5.0       # injected straggler
            self.monitor.observe(step, dt)
            self.history.append({"step": step, "loss": loss, "dt": dt})
            if step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)")
            step += 1
            if step % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step, {"params": params, "opt": opt},
                               extra={"loss": loss})
        self.ckpt.save(self.tcfg.total_steps,
                       {"params": params, "opt": opt})
        return {"params": params, "opt": opt, "history": self.history,
                "restarts": self.restarts,
                "stragglers": self.monitor.flagged}
