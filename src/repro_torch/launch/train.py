"""Training entry point: the fault-tolerant runtime end to end (checkpoints,
an injected crash and its restore, straggler flagging) on the smoke config,
or at published widths with ``--full-width`` (``--layers`` cuts the depth,
never a width).  Runs on the GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --steps 60 \
        --inject-crash 25 --ckpt-dir build/ckpt_demo
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 8 \
        --inject-crash 5 --ckpt-dir build/ckpt_cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b \
        --full-width --layers 8 --batch 8 --seq 1024 --steps 6 --ckpt-every 100
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data import SyntheticLMDataset
from ..runtime import FailureInjector, Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi_6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--inject-crash", type=int, default=None,
                    help="simulate a crash at this step")
    ap.add_argument("--inject-slow", type=int, default=None)
    ap.add_argument("--full-width", "--full-config", dest="full_width",
                    action="store_true",
                    help="the published config instead of the smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (widths stay as published)")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args()

    cfg = (get_config(args.arch) if args.full_width
           else get_smoke_config(args.arch))
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dataset = SyntheticLMDataset(vocab_size=cfg.vocab_size,
                                 seq_len=args.seq, global_batch=args.batch)
    schedule = {}
    if args.inject_crash is not None:
        schedule[args.inject_crash] = "crash"
    if args.inject_slow is not None:
        schedule[args.inject_slow] = "slow"
    trainer = Trainer(
        cfg,
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=args.ckpt_every,
                      checkpoint_dir=args.ckpt_dir),
        dataset,
        injector=FailureInjector(schedule), device=args.device)
    out = trainer.run()
    losses = [h["loss"] for h in out["history"]]
    print(f"done: {len(losses)} steps, loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}, restarts={out['restarts']}, "
          f"stragglers={out['stragglers']}")


if __name__ == "__main__":
    main()
