#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py [--phases kernels,serve,...] [--layers N]

Without ``--phases`` it runs kernels, serve, parity, coherence, train, cap,
cells, multipod, model_axis and numa_sim; the others are kernels_bwd,
kernels_cap, kernels_mla, serve_mla and model_axis_options (README.md lists
the usual commands).  Each phase prints one JSON object on a line of its own;
any failure raises and the script exits non-zero.  The phases live in
``chipcheck/``, whose modules' docstrings say what each checks.  Where a
served step's time goes: ``perfbench/run.py --trace 1``; a train step's:
``python -m repro_torch.launch.profile_cell --arch yi_6b --shape train_4k
--rows 2``.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import argparse
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.kernels import _build  # noqa: E402

from chipcheck import (cells, kernels, kernels_bwd, kernels_cap,  # noqa: E402
                       kernels_mla, model_axis, model_axis_options, multipod,
                       numa_sim, serve, train)
from chipcheck.common import check, emit  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="kernels,serve,parity,coherence,train,cap,cells,"
                            "multipod,model_axis,numa_sim")
    ap.add_argument("--layers", type=int, default=serve.SERVE_DEPTH["qwen3_14b"],
                    help="depth of the Qwen3-14B serve (widths are never cut; "
                         "every other arch runs at SERVE_DEPTH)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    depth = dict(serve.SERVE_DEPTH, qwen3_14b=args.layers)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "device", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "libraries": [p.name for p in built]})

    rows = []
    if "kernels" in phases:
        rows = kernels.phase_kernels()
    elif "kernels_bwd" in phases:         # K2's backward row alone
        rows = [kernels_bwd.phase_kernels_bwd()]
    elif "kernels_cap" in phases:         # the soft-cap rows alone
        rows = kernels_cap.phase_kernels_cap()
    elif "kernels_mla" in phases:         # K4's row alone
        rows = [kernels_mla.phase_kernels_mla()]
    runs, walls = {}, {"kernels": time.perf_counter() - t0}

    def timed_phase(name, fn):
        t_start = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t_start
        return out

    if "serve" in phases:
        runs = timed_phase("serve", lambda: dict(
            {arch: serve.phase_serve(arch, n) for arch, n in depth.items()},
            whisper_base=serve.phase_whisper()))
    elif "serve_mla" in phases:           # Moonlight's serve alone
        runs = timed_phase("serve_mla", lambda: {
            "moonlight_16b_a3b": serve.phase_serve("moonlight_16b_a3b")})
    if "parity" in phases:
        timed_phase("parity", lambda: [serve.phase_parity(arch)
                                       for arch in serve.PARITY])
    if "coherence" in phases:
        timed_phase("coherence", serve.phase_coherence)
    if "train" in phases:
        runs.update(timed_phase("train", train.phase_train))
    if "cap" in phases:
        runs.update(timed_phase("cap", train.phase_cap))
    if "cells" in phases:
        runs.update(timed_phase("cells", cells.phase_cells))
    if "multipod" in phases:
        runs.update(timed_phase("multipod", multipod.phase_multipod))
    if "model_axis" in phases:                # parts A-E, then F
        runs.update(timed_phase("model_axis", lambda: dict(
            model_axis.phase_model_axis(), **model_axis_options.model_axis_options())))
    elif "model_axis_options" in phases:      # part F alone
        runs.update(timed_phase("model_axis_options",
                                model_axis_options.model_axis_options))
    if "numa_sim" in phases:
        fifo_row, *runs["numa_sim"] = timed_phase("numa_sim", numa_sim.phase_numa_sim)
        rows.append(fifo_row)
    # every kernel that the path's layer groups need ran, and no other
    for path, (by_name, want) in runs.items():
        for name, n in by_name.items():
            check((n > 0) == (want[name] > 0),
                  f"{name} ran {n} times on the {path} path, which needs "
                  f"{want[name]}")
    if runs:
        counts = {path: by_name for path, (by_name, _) in runs.items()}
        for row in rows:
            row["launches_by_arch"] = {a: c[row["name"]]
                                       for a, c in counts.items()}
            row["launches"] = sum(row["launches_by_arch"].values())
    emit({"phase": "walls", "wall_s": walls,
          "total_s": time.perf_counter() - t0})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
