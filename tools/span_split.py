#!/usr/bin/env python3
"""One traced run of a benchmark cell, as ``perfbench/run.py`` makes it,
and what the port's own spans say about its profiled slice.

    python3 tools/span_split.py --workload nemotron15b.decode_backlog \\
        --seed 2147483661 --seconds 51 [--out build/span_split.jsonl]

Run from the root of a checkout on a machine with the cell's GPU.  It
prints ``perfbench/run.py``'s own lines (``--trace 1``), then one JSON line:

  idle_by_span   the slice's idle device seconds and gaps by the innermost
                 port span open at each gap's start (``perfbench/portspans.py``)
  counts         the sums of the spans' counts over the slice beside the
                 deltas of the counters they count, read when the profiler
                 started and stopped: ``kv.record``'s accesses, misses and
                 fetches (``HostCounters``), ``coherence.prologue``'s
                 wire bytes (the grid's ``wire_bytes``) and K3 launches (with
                 one a ``k3`` span: ``pte_gather.launches``)
  spans          the count of each span in the slice

``--out`` also appends the line to a file.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import driver, harness, portspans, run
    from perfbench import tracing as bench_tracing
    from repro_torch import tracing
    from repro_torch.kernels.pte_gather.ops import pte_gather

    drivers, runs, marks = [], [], []
    init, read, start, stop = (driver.Driver.__init__, harness.read_metrics,
                               bench_tracing.Profiler.start,
                               bench_tracing.Profiler.stop)

    def counters():
        d = drivers[-1]
        c = d.kv.host.counters
        return {"accesses": c.translation_local + c.translation_miss,
                "misses": c.translation_miss, "fetches": c.fetches,
                "wire_bytes": d.grid.wire_bytes,
                "k3_launches": pte_gather.launches}

    def keep_driver(self, *a, **k):
        init(self, *a, **k)
        drivers.append(self)

    def keep_run(specs, r, *a, **k):
        runs.append(r)
        return read(specs, r, *a, **k)

    def start_marked(self):
        marks[:] = [counters()]
        start(self)

    def stop_marked(self):
        out = stop(self)
        marks.append(counters())
        return out

    driver.Driver.__init__ = keep_driver
    harness.read_metrics = keep_run
    bench_tracing.Profiler.start = start_marked
    bench_tracing.Profiler.stop = stop_marked
    run.main(["--workload", args.workload, "--seed", str(args.seed),
              "--seconds", str(args.seconds), "--trace", "1"])

    spans = portspans.read(runs[-1])
    if spans is None:
        raise SystemExit("span_split: the port's spans read nothing")
    recs = [r for r in tracing.records() if r.end_ns]

    def total(name, key):
        return sum(r.counts.get(key, 0) for r in recs if r.name == name)

    before, after = marks[-2], marks[-1]
    delta = {k: after[k] - before[k] for k in before}
    sums = {"accesses": total("kv.record", "accesses"),
            "misses": total("kv.record", "misses"),
            "fetches": total("kv.record", "fetches"),
            "wire_bytes": total("coherence.prologue", "wire_bytes"),
            "k3_launches": total("coherence.prologue", "k3")
            + sum(r.name == "k3" for r in recs)}
    names = {}
    for n in spans.names:
        names[n] = names.get(n, 0) + 1
    line = {"workload": args.workload, "seed": args.seed,
            "idle_by_span": {k: [v[0], v[1]] for k, v in sorted(
                spans.idle_by_span().items(), key=lambda kv: -kv[1][0])},
            "window_s": spans.window_ns * 1e-9,
            "counts": {k: [sums[k], delta[k]] for k in sums},
            "spans": names}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
