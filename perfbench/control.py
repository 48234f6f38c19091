"""The readings a cell's limits are set from: the program's ``logit_gap``
and the control's (the reference in fp8 in the program's place, read on the
same prompts and served tokens), seed after seed in one process.

    python3 perfbench/control.py --workload yi6b.rag_poisson \
        --seeds 11,12,13 --seconds 8

Each seed is a whole run of the cell as ``run.py`` makes it (set-up, the
traffic at the cell's load for ``--seconds``, the comparison), plus the
control.  One JSON line a seed on standard output.  The benchmark's own
runs never run the control.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench.harness import run_cell
    if not torch.cuda.is_available():
        raise SystemExit("control: no CUDA device")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = run_cell(bench, args.workload, seed, args.seconds, False, device,
                     t0, control=True)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "logit_gap": r["checks"]["logit_gap"]["value"],
                          "control_gap": r["control_gap"],
                          "compared_tokens": r["compared_tokens"],
                          "readings": r["readings"],
                          "checks": r["checks"], "metrics": r["metrics"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
