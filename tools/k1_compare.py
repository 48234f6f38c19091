#!/usr/bin/env python3
"""Time the paged-attention kernel (K1) of one checkout's port on the GPU.

    python3 tools/k1_compare.py                        # this checkout's port
    python3 tools/k1_compare.py --src OTHER/src        # another checkout's port
    python3 tools/k1_compare.py --splits 1,2,4,16      # also force split counts

``--src`` points at the ``src`` directory of another checkout (for example
an unpacked ``git archive`` of an earlier commit), whose ``repro_torch`` is
imported instead of this one's; its kernels build into that checkout's own
``build/``.  To compare two versions, run both in one process list on one
card, in the order A, B, B, A.

For three bf16 shapes at Qwen3-14B widths (the serving path's: batch 16,
1 057 tokens; one sequence of 32 768 tokens; the same with a 4 096-token
window) it reports, through the public wrapper ``paged_attention``:

  ms           device time of one call, by ``chipcheck/common.py:time_ms``
  max_abs_err  against the plain version (held to ``chipcheck``'s bound)
  host_us      host time of one wrapper call, back to back, mean of 200
  bound_ms     ``chipcheck/common.py:paged_bound`` for these inputs

``--splits`` (a port whose wrapper plans split-KV only) repeats ``ms`` and
``max_abs_err`` with the plan's split count replaced by each one given.
Each result is one JSON line on standard output, also appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(fn, calls: int = 200, reps: int = 5) -> float:
    """Median over ``reps`` of the host time of one of ``calls`` back-to-back
    calls (the launch queue holds them all, so the host never waits)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return float(np.median(times))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--splits", default="",
                    help="comma list of split counts to force, besides the plan")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "k1_compare.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1_compare.py needs a CUDA device")
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import repro_torch
    from repro_torch.kernels.paged_attention import ops
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        sys.exit(f"repro_torch was not imported from {src}")
    # chipcheck supplies the timer, the inputs and the bound; the
    # repro_torch it imports is the one already loaded from --src
    sys.path.insert(1, ROOT)
    from chipcheck import common

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def emit(row):
        row = {"src": os.path.relpath(src, ROOT), "card": smi, **row}
        line = json.dumps(row)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    bf16 = torch.bfloat16
    cases = {
        "serve": common.paged_case(16, 40, 8, 128, 16, 69, 4416, None, bf16,
                               lens=np.full(16, 1057)),
        "long": common.paged_case(1, 40, 8, 128, 16, 2048, 2048, None, bf16,
                              lens=[32768]),
        "long_window": common.paged_case(1, 40, 8, 128, 16, 2048, 2048, 4096, bf16,
                                     lens=[32768]),
    }
    fn, ref = ops.paged_attention, ops.paged_attention_ref
    tol = common.TOL["paged_attention"]

    def measure(a, kw):
        err = common.max_err(fn(*a, **kw), ref(*a, **kw))
        common.check(err <= tol, f"paged_attention |err| {err} > {tol}")
        return {"ms": common.time_ms(lambda: fn(*a, **kw)), "max_abs_err": err}

    for name, (a, kw) in cases.items():
        t_bytes, t_ops = common.paged_bound(a, kw)
        emit({"case": name, "shape": [list(t.shape) for t in a],
              "window": kw["window"], **measure(a, kw),
              "host_us": host_us(lambda: fn(*a, **kw)),
              "bound_ms": 1e3 * max(t_bytes, t_ops)})

    splits = [int(n) for n in args.splits.split(",") if n]
    if not splits:
        return
    if not hasattr(ops, "_split_plan"):
        sys.exit("--splits needs a port whose wrapper plans split-KV")
    planned = ops._plan
    for name, (a, kw) in cases.items():
        q, ks, tables = a[0], a[1], a[3]
        B, H, hd = q.shape
        _, bt, K, _ = ks.shape
        MB = tables.shape[1]
        n_gc, n_plan, _ = planned(q.device.index, ops._DTYPES[q.dtype], B, H, K,
                                  hd, MB, bt, kw["window"])
        span = ops._window_span(MB, bt, kw["window"])
        forced = set()
        for n in sorted(set(splits) | {n_plan}):
            cps = -(-span // n)
            plan = (n_gc, -(-span // cps), cps)
            if cps > ops.MAX_COLS or plan[1] > ops.MAX_SPLITS or plan in forced:
                continue
            forced.add(plan)
            ops._plan = lambda *_, plan=plan: plan
            try:
                row = measure(a, kw)
            finally:
                ops._plan = planned
            emit({"case": name, "n_splits": plan[1], "cols_per_split": plan[2],
                  "blocks": B * K * n_gc * plan[1], "planned": plan[1] == n_plan,
                  **row})


if __name__ == "__main__":
    main()
