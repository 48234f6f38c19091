#!/usr/bin/env python3
"""Time the served decode step of this checkout's port against another
checkout's, in one process on one card, step by step in turns.

    python3 tools/step_ab.py --src OTHER/src [--workload yi6b.rag_poisson]
        [--prompt 1024] [--steps 200] [--seed 2147483659] [--out FILE]

The host-bound step moves ±10-15 % between processes, which hides a change
of a few percent when two versions run one after the other.  Here both run
in one process: ``OTHER/src/repro_torch`` is copied under this checkout's
``build/step_ab/`` as the package ``repro_torch_other`` (the port's imports
are relative) and imported beside ``repro_torch``.  Each side gets the
cell's configuration and deployment (``perfbench/configs``), its own KV
manager, grid, decode state and serve step, the same weights (one set,
``perfbench/reference``, from ``--seed``) and the same prompts, and one
prefill; then the two sides take decode steps in turns, the order swapped
every round, each step timed on the host clock from its walk to its tokens
on the host as ``perfbench/driver.py`` times it (extend, walk recording
every 4th step, the serve step with the coherence prologue, extra rounds,
the tokens' copy).  It prints one JSON line (``--out`` also appends it to a
file): each side's median, mean and 95th percentile step ms, the median of
the rounds' differences (this minus other) and the share of rounds in which
this side was faster; and the card.  Both ports need
``launch/specs.py:coherence_rounds``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import shutil
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OTHER = "repro_torch_other"


def side(pkg: str, conf: dict, params: dict, prompts, batch: int, steps: int,
         device):
    """The served pieces of one package, prefilled: a ``step()`` that takes
    one decode step and returns its host ms."""
    import torch
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    common, kvcache, gather = (mod("models.common"), mod("kvcache"),
                               mod("kvcache.gather"))
    specs, mesh, models = mod("launch.specs"), mod("launch.mesh"), mod("models")
    blocktable = mod("pagedpt.blocktable")
    m = conf["model"]
    fields = {f.name for f in dataclasses.fields(common.ModelConfig)}
    kw = {k: v for k, v in m.items() if k in fields}
    kw["dtype"] = kw["param_dtype"] = getattr(torch, m["dtype"])
    cfg = common.ModelConfig(name=conf["name"], **kw)
    dep = conf["deployment"]
    S, bt = prompts.shape[1], cfg.kv_block_tokens
    max_blocks = -(-(S + steps) // bt) + 1
    frames = -(-batch * max_blocks // dep["pools"]) * dep["pools"]
    kv = kvcache.PagedKVManager(
        n_frames=frames, block_tokens=bt, max_blocks_per_seq=max_blocks,
        n_pods=dep["pods"], mode=blocktable.CoherenceMode(dep["mode"]),
        n_pools=dep["pools"], replicas=True, device=device)
    grid = mesh.make_debug_mesh(dep["pods"], device=device)
    state = models.init_decode_state(
        cfg, batch, frames, max_blocks, n_pools=dep["pools"], device=device,
        kv_split=specs.kv_split(cfg, grid, specs.make_rules(cfg, grid)),
        state_split=specs.state_split(params, grid))
    serve = specs.build_serve_step(cfg, coherence=dep["mode"], pods=grid)
    home = gather.pool_of_rows(batch, dep["pools"]).tolist()
    rows = list(range(batch))
    with torch.no_grad():
        for r in rows:
            kv.start_sequence(r, S, pod=home[r])
        _, st = models.prefill(cfg, params, prompts, state,
                               kv.physical_tables(rows))
    torch.cuda.synchronize()
    held = {"state": st, "tokens": torch.zeros((batch,), dtype=torch.int32,
                                               device=device), "t": 0}

    @torch.no_grad()
    def step() -> float:
        t, start = held["t"], time.perf_counter()
        for r in rows:
            kv.maybe_extend(r, S + t + 1)
        phys = kv.physical_tables(rows, record=(t % 4 == 0))
        tokens, held["state"], _ = serve(params, held["state"], held["tokens"],
                                         phys, kv.replicas,
                                         *kv.coherence_inputs())
        specs.coherence_rounds(dep["mode"], grid, kv)
        tokens.cpu()
        held["tokens"], held["t"] = tokens, t + 1
        return 1e3 * (time.perf_counter() - start)
    return step


def summary(ms):
    ms = sorted(ms)
    return {"median": statistics.median(ms), "mean": statistics.fmean(ms),
            "p95": ms[int(0.95 * (len(ms) - 1))]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--workload", default="yi6b.rag_poisson")
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    copy = ROOT / "build" / "step_ab" / "src"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(Path(args.src) / "repro_torch", copy / OTHER,
                    ignore=shutil.ignore_patterns("__pycache__"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(copy)]
    import torch
    from perfbench import harness, traffic

    if not torch.cuda.is_available():
        raise SystemExit("step_ab: no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.cell_of(bench, args.workload)
    conf = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    mix = traffic.load(cell["traffic"])
    ref = harness.load_module(harness.HERE / "reference", conf["reference"])
    params = ref.port_params(conf["model"], ref.make_weights(
        conf["model"], args.seed, device))
    batch = mix["batch"]
    prompts = torch.stack([torch.from_numpy(traffic.prompt(
        dict(mix, prompt_len=args.prompt), conf["model"]["vocab_size"],
        args.seed, r)) for r in range(batch)]).to(device=device,
                                                  dtype=torch.int32)
    steps = {name: side(name, conf, params, prompts, batch, args.steps + 2,
                        device) for name in ("repro_torch", OTHER)}
    for fn in steps.values():                 # first launches, out of count
        fn()
        fn()
    times = {name: [] for name in steps}
    for k in range(args.steps):
        order = list(steps) if k % 2 == 0 else list(steps)[::-1]
        for name in order:
            times[name].append(steps[name]())
    diff = [a - b for a, b in zip(times["repro_torch"], times[OTHER])]
    line = {"workload": args.workload, "prompt": args.prompt,
            "steps": args.steps, "card": torch.cuda.get_device_name(0),
            "this": summary(times["repro_torch"]),
            "other": summary(times[OTHER]),
            "this_minus_other_median": statistics.median(diff),
            "this_faster_share": sum(d < 0 for d in diff) / len(diff)}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
