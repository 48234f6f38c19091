"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload nemotron15b.decode_backlog \
        --seed 12345 --seconds 45 --trace 0

Run from the root of a checkout on a machine with the cells' GPUs.  Set-up
builds the program's kernels into the checkout's ``build/`` (later runs
load them from there), makes the weights on the device from the seed,
allocates the KV slabs and the block table's replicas, and warms up one
prefill and one decode step at the cell's shapes; then the traffic runs for
``--seconds``.  The last line on standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; ``checks`` last: each compared number and
its limit), and the last lines on standard error name the same checks.

It exits with another code than 0 and prints no result where there is no
GPU, fewer than the cell asks for, or where the process has loaded JAX,
Flax or the JAX package ``repro`` (top-level module names compared whole).
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "perfbench"


def _fail(msg: str, code: int = 1) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.imports import forbidden_modules
    if forbidden_modules():
        _fail(f"loaded at start: {forbidden_modules()}")
    # every cache the program or PyTorch may write, at a fixed path inside
    # the checkout (the kernels' own build directory is build/repro_torch)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(BUILD / sub)

    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    from perfbench.harness import cell_of, run_cell
    cell = cell_of(bench, args.workload)
    if not torch.cuda.is_available():
        _fail("no CUDA device", 2)
    if torch.cuda.device_count() < cell["chips"]:
        _fail(f"{cell['chips']} GPUs wanted, "
              f"{torch.cuda.device_count()} present", 2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, T_PROCESS)
    bad = forbidden_modules()
    if bad:
        _fail(f"loaded by the end of the window: {bad}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
