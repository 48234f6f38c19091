#!/usr/bin/env python3
"""Time the page walk (``PagedKVManager.physical_tables``) of one checkout's
port on the GPU, on the host's clock, and count its device operations.

    python3 tools/walk_compare.py                   # this checkout's port
    python3 tools/walk_compare.py --src OTHER/src   # another checkout's port

``--src`` points at the ``src`` directory of another checkout (for example
an unpacked ``git archive`` of an earlier commit), whose ``repro_torch`` is
imported instead of this one's; its kernels build into that checkout's own
``build/``.  To compare two versions, run both in one process list on one
card, in the order A, B, B, A.

At the serving shape (``chipcheck/walk.py:WALK_SHAPE``: Qwen3-14B served
at batch 16, prompt 1024 + 64 generated, 4 pods, numaPTE) it runs
``--waves`` waves of the serving path's walks with no model in between
(``chipcheck/walk.py:walk_wave``), once with ``record`` true and once false,
and reports for each kind of walk (``first``: a wave's first walk; ``extend``: a
decode step with extensions pending; ``steady``: one with none; ``check``:
the sync of ``check_device_table`` after the frees):

  host_us     host time of one call (nothing synchronises around it), the
              mean and the median over the calls of that kind
  mutations   pending host mutations before the call, the mean
  device_ops  kernels and copies of one call of that kind, by name
              (``torch.profiler``; ``record`` false)

and the device time of the walk's device side
(``chipcheck/common.py:time_ms``) for the serving path's inputs
(``chipcheck/walk.py:serving_walk_cases``): the ids alone, a wave's first
walk and a wave switch.  A port whose ``pte_gather`` takes no mutation list
(before the fused kernel) applies the list with ``apply_mutations``, one
call per drain of ``mutation_budget`` entries, and then walks.

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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--waves", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "walk_compare.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("walk_compare.py needs a CUDA device")
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        sys.exit(f"repro_torch was not imported from {src}")
    # chipcheck supplies the shape and the walks; the repro_torch it
    # imports is the one already loaded from --src
    sys.path.insert(1, ROOT)
    from chipcheck import walk
    from chipcheck.common import DEV, time_ms

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

    from repro_torch.kernels.pte_gather import pte_gather
    from repro_torch.pagedpt.blocktable import BlockTableSpec, apply_mutations
    fused = "mutations" in inspect.signature(pte_gather).parameters
    budget = BlockTableSpec(n_pods=1, n_tables=1).mutation_budget

    def device_side(entries, logical, degree, mutations):
        if fused or mutations is None:
            return pte_gather(entries, logical, degree, mutations) if fused \
                else pte_gather(entries, logical, degree)
        for i in range(0, mutations[0].numel(), budget):
            apply_mutations(entries, *(m[i:i + budget] for m in mutations))
        return pte_gather(entries, logical, degree)

    serving = walk.serving_walk_cases()
    (entries, logical, degree, _), _ = serving["first_walk"]
    cases = {"ids_only": (entries.clone(), logical, degree, None),
             "first_walk": serving["first_walk"][0],
             "wave_switch": serving["wave_switch"][0]}
    for name, a in cases.items():
        # the list applied again leaves the table as it is: every timed call
        # repeats the same work
        emit({"case": name, "fused": fused, "ids": int(a[1].numel()),
              "mutations": 0 if a[3] is None else int(a[3][0].numel()),
              "device_ms": time_ms(lambda: device_side(*a))})

    ops = walk.walk_device_ops()
    for record in (True, False):
        kv = walk.PagedKVManager(**walk.WALK_SHAPE, device=DEV)
        times, pending = {}, {}

        def call(kind, fn):
            pending.setdefault(kind, []).append(len(kv.host._pending_mut))
            t0 = time.perf_counter()
            fn()
            times.setdefault(kind, []).append(1e6 * (time.perf_counter() - t0))

        # one wave first, untimed: builds and loads the kernel
        walk.walk_wave(kv, list(range(16)), record, lambda kind, fn: fn())
        torch.cuda.synchronize()
        for w in range(1, args.waves + 1):
            walk.walk_wave(kv, list(range(16 * w, 16 * w + 16)), record, call)
        torch.cuda.synchronize()
        for kind, us in times.items():
            emit({"record": record, "kind": kind, "calls": len(us),
                  "host_us_mean": float(np.mean(us)),
                  "host_us_median": float(np.median(us)),
                  "mutations": float(np.mean(pending[kind])),
                  "device_ops": ops[kind],
                  "device_ops_total": sum(ops[kind].values())})


if __name__ == "__main__":
    main()
