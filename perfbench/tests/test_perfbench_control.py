"""The control: the reference in fp8, put in the program's place, has to
come out not correct by the limit that sound runs of the program meet.
Kept at the smoke sizes (the cells' own readings are in PERF.md)."""
import time

import pytest
import torch

from perfbench.harness import run_cell
from perfbench.tests import smoke

LONG = [{"name": f"{a}.long", "config": f"smoke_{a}", "traffic": "tiny_long",
         "chips": 1, "why": "test"} for a in ("relu2", "silu")]


@pytest.mark.parametrize("seed", [2 ** 31, 2 ** 31 + 1, 2 ** 31 + 3])
@pytest.mark.parametrize("workload", ["relu2.long", "silu.long"])
def test_control_fails_the_limit_sound_runs_meet(workload, seed):
    r = run_cell(smoke.bench(LONG), workload, seed, 2.0, False,
                 torch.device("cpu"), time.perf_counter(), data=smoke.DATA,
                 control=True)
    limit = r["checks"]["logit_gap"]["limit"]
    assert r["correct"] and r["checks"]["logit_gap"]["value"] <= limit
    assert r["control_gap"] > limit
