#!/usr/bin/env python3
"""Time the fifo_miss kernel (pass 1 of the simulator's batch engine) of one
checkout's port on the GPU.

    python3 tools/fifo_compare.py                     # this checkout's port
    python3 tools/fifo_compare.py --src OTHER/src     # another checkout's port

``--src`` points at the ``src`` directory of another checkout (for example
an unpacked ``git archive`` of an earlier commit), whose ``repro_torch`` is
imported instead of this one's; its kernel builds into that checkout's own
``build/``.  To compare two versions, run both in one process list on one
card, in the order A, B, B, A.

Two streams: the largest ``fifo_miss`` call of fig08's 15 runs at
``--scale 16`` (``chipcheck/numa_sim.py:NUMA_APP``; recorded once on the
numpy backend and kept in ``--streams``, so later runs reuse it), and
``chipcheck/numa_sim.py:fifo_long_stream`` (2^24 accesses over 2^20 vpns).
For each it reports:

  ms               device time of the kernel, by ``chipcheck/common.py:time_ms``
  backend_wall_ms  one whole ``fifo_miss(..., backend="cuda")`` call as the
                   batch engine of that checkout makes it (with its ids,
                   ``dense``, where the checkout takes them), median
  numpy_wall_ms    the numpy loop on the same stream, median
  flags_equal      the kernel's flags against the numpy loop's

Each result is one JSON line on standard output, also appended to ``--out``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def median_wall_ms(fn, reps: int) -> float:
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(walls))


def engine_stream(sim, path: str):
    """fig08's largest engine call: (arr, TLB entries, capacity)."""
    if os.path.exists(path):
        with np.load(path) as z:
            return z["arr"], z["init"].tolist(), int(z["cap"])
    recorded = []
    with sim.engine_calls(recorded, keep=True):
        sim.numa_sim_apps("numpy")
    arr, init, cap = max(recorded,
                         key=lambda c: np.unique(c[0]).size + len(c[1]))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, arr=arr, init=np.asarray(init, np.int64), cap=cap)
    return arr, init, cap


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--streams", default=os.path.join(ROOT, "build",
                                                      "fifo_engine_call.npz"))
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "fifo_compare.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fifo_compare.py needs a CUDA device")
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import repro_torch
    from repro_torch.kernels.fifo_miss import ops
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        sys.exit(f"repro_torch was not imported from {src}")
    # chipcheck supplies the timer, the streams and the fig08 runs; the
    # repro_torch it imports is the one already loaded from --src
    sys.path.insert(1, ROOT)
    from chipcheck import numa_sim
    from chipcheck.common import DEV, time_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    takes_dense = "dense" in inspect.signature(ops.fifo_miss).parameters
    streams = {"engine_call": engine_stream(numa_sim, args.streams),
               "long_stream": numa_sim.fifo_long_stream()}
    for name, (arr, init, cap) in streams.items():
        arr = np.asarray(arr, np.int64)
        fill0, n0, ids = ops.densify(arr, init, cap)
        f = torch.from_numpy(fill0).to(DEV)
        i = torch.from_numpy(ids).to(DEV)
        kw = ({"dense": np.unique(arr, return_inverse=True)}
              if takes_dense else {})
        reps = 10 if name == "engine_call" else 3
        loop = ops.fifo_miss(arr, init, cap, backend="numpy")
        got = ops.fifo_miss_ids(f, n0, i, cap).cpu().numpy()
        result = {
            "src": src, "card": smi, "stream": name, "n": int(arr.size),
            "distinct_ids": int(fill0.size), "capacity": cap,
            "flags_equal": bool(np.array_equal(got, loop)),
            "ms": time_ms(lambda: ops.fifo_miss_ids(f, n0, i, cap),
                             iters=reps),
            "backend_wall_ms": median_wall_ms(
                lambda: ops.fifo_miss(arr, init, cap, backend="cuda", **kw),
                reps),
            "backend_takes_dense": takes_dense,
            "numpy_wall_ms": median_wall_ms(
                lambda: ops.fifo_miss(arr, init, cap, backend="numpy"),
                min(reps, 3)),
        }
        line = json.dumps(result)
        print(line, flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
        if not result["flags_equal"]:
            sys.exit(f"fifo_miss of {src} disagrees with the numpy loop")


if __name__ == "__main__":
    main()
