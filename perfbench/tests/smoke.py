"""Helpers of the tests: the smoke configurations and mixes of ``data/``,
served on the CPU through the harness as a chip run serves a cell."""
import json
import time
from pathlib import Path

import torch

from perfbench.harness import run_cell

HERE = Path(__file__).resolve().parent
DATA = HERE / "data"
BENCH = json.loads((HERE.parents[1] / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 11
CELLS = {"relu2.backlog": ("smoke_relu2", "tiny_backlog"),
         "silu.poisson": ("smoke_silu", "tiny_poisson")}


def bench(extra=()):
    """The repository's metrics over the smoke cells (and ``extra`` ones)."""
    cells = [{"name": n, "config": c, "traffic": t, "chips": 1,
              "why": "test"} for n, (c, t) in CELLS.items()]
    return dict(BENCH, workloads=cells + list(extra))


def run(workload, *, seed=SEED, seconds=1.0, trace=False, data=DATA,
        extra=()):
    return run_cell(bench(extra), workload, seed, seconds, trace,
                    torch.device("cpu"), time.perf_counter(), data=data)
