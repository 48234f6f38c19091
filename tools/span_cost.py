#!/usr/bin/env python3
"""What the port's spans (``repro_torch/tracing.py``) cost, on one card.

    python3 tools/span_cost.py [--workload yi6b.rag_poisson] [--steps 40]
        [--rounds 3] [--seed 2147483659] [--out build/span_cost.jsonl]

Run from the root of a checkout on a machine with a GPU.  It prints one JSON
line (``--out`` also appends it to a file):

  per_span_ns   one ``with tracing.span(...)`` on this host: off (with and
                without a count), inside ``tracing.recording()``, and under
                a ``torch.profiler`` tracing the CPU and the card; beside an
                empty loop's turn
  spans_a_step  the spans one decode step of the cell opens (those of a
                wave's steps, after its prefill, under ``recording()``)
  profiled_ms   the host milliseconds of a decode step (its walk to its
                tokens on the host, ``perfbench/driver.py``'s ``Step``) in
                waves served under the profiler, with the spans on and with
                ``tracing.span`` made a no-op: ``--rounds`` rounds of two
                waves of ``--steps`` steps, the order alternating, the mean
                of each wave

The waves are the cell's (its configuration, deployment and batch, its
prompt length, the weights from ``--seed``), served through perfbench's
driver; each is prefilled before its steps.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def per_span_ns(tracing, torch) -> dict:
    def timed(n, body):
        t = time.perf_counter_ns()
        body(n)
        return (time.perf_counter_ns() - t) / n

    def spans(n):
        for _ in range(n):
            with tracing.span("x"):
                pass

    def counted(n):
        for i in range(n):
            with tracing.span("layer", index=i):
                pass

    def empty(n):
        for _ in range(n):
            pass

    out = {"loop": timed(1_000_000, empty), "off": timed(1_000_000, spans),
           "off_counted": timed(1_000_000, counted)}
    with tracing.recording():
        out["recording"] = timed(100_000, spans)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        out["profiled"] = timed(20_000, spans)
    tracing.take()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="yi6b.rag_poisson")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench import harness, traffic
    from perfbench.driver import Driver
    from repro_torch import tracing
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("span_cost: no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.cell_of(bench, args.workload)
    conf = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    mix = dict(traffic.load(cell["traffic"]), gen_len=args.steps)
    model = conf["model"]
    _build.build_all(harness.KERNELS)
    ref = harness.load_module(harness.HERE / "reference", conf["reference"])
    params = ref.port_params(model, ref.make_weights(model, args.seed, device))
    drv = Driver(harness.program_config(conf), params, mix, conf["deployment"],
                 device)
    drv.warm_up()
    source = traffic.requests(dict(mix, arrivals="backlog"),
                              model["vocab_size"], args.seed, 0.0)

    def wave(profiled: bool) -> float:
        reqs = [next(source) for _ in range(mix["batch"])]
        first = len(drv.steps)
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profiled
            else contextlib.nullcontext())
        with ctx:
            drv.run_wave(reqs)
        steps = drv.steps[first:]
        return 1e3 * sum(s.t1 - s.t0 for s in steps) / len(steps)

    line = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
            "per_span_ns": per_span_ns(tracing, torch)}
    tracing.take()
    with tracing.recording():
        wave(False)
    recs = tracing.take()
    (prefilled,) = [r.end_ns for r in recs if r.name == "prefill"]
    line["spans_a_step"] = sum(r.start_ns > prefilled
                               for r in recs) / args.steps
    on, none = [], []
    real = tracing.span
    noop = contextlib.nullcontext()
    for k in range(2 * args.rounds):
        spans_on = (k % 4) in (0, 3)
        tracing.span = real if spans_on else (lambda name, **c: noop)
        try:
            (on if spans_on else none).append(wave(True))
        finally:
            tracing.span = real
        tracing.take()
    line["profiled_ms"] = {"spans_on": on, "spans_none": none}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
