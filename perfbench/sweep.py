"""The knee of an open-loop cell: the cell's mix at each of a few fixed
rates, one run each, in one process.

    python3 perfbench/sweep.py --workload yi6b.rag_poisson \
        --rates 3,4,5,6 --seconds 30 --seed 7

For each rate it prints the offered tokens a second beside ``tok_per_s``,
and ``ttft_p90_ms``: above the knee the served rate falls short of the
offered one and time to first token grows with the window.  The mix's file
is not changed: each rate runs from a copy under ``build/perfbench/``.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="requests/s, comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench.harness import cell_of, run_cell
    if not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA device")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_of(bench, args.workload)
    here = ROOT / "perfbench"
    mix = json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())
    data = ROOT / "build" / "perfbench" / "sweep"
    shutil.rmtree(data, ignore_errors=True)
    shutil.copytree(here / "configs", data / "configs")
    (data / "traffic").mkdir(parents=True)
    for rate in (float(r) for r in args.rates.split(",")):
        (data / "traffic" / f"{cell['traffic']}.json").write_text(
            json.dumps(dict(mix, rate_per_s=rate)))
        t0 = time.perf_counter()
        r = run_cell(bench, args.workload, args.seed, args.seconds, False,
                     torch.device("cuda", 0), t0, data=data)
        print(json.dumps({"rate_per_s": rate,
                          "offered_tok_per_s": rate * mix["gen_len"],
                          "attempted": r["attempted"], "correct": r["correct"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "wall_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
