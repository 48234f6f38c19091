"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides ``correct``.

Everything that belongs to one configuration, one traffic mix or one metric
is found by its name in ``BENCHMARK.json``: ``configs/<name>.json`` (the
sizes as run, the deployment, the reference's name and the limits of the
compared numbers), ``traffic/<name>.json`` (read by ``traffic.py``),
``metrics/<name>.py`` (a ``read(run)`` that returns the metric's value, or
None where it finds nothing to read) and ``reference/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, roofline, traffic
from .tracing import Profiler, Spans, TraceSlice

HERE = Path(__file__).resolve().parent
#: the program's kernels a served dense model launches
KERNELS = ("paged_attention", "flash_attention", "pte_gather")


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    model: Dict                    # the configuration's sizes, as run
    mix: Dict                      # the traffic mix
    seconds: float
    origin: float                  # the schedule's origin (host clock)
    w0: float                      # the window, [w0, w1)
    w1: float
    setup_s: float
    requests: List[traffic.Request]
    steps: List                    # driver.Step, every decode step
    prefills: List                 # driver.Prefill, every wave's prefill
    spans: Spans
    max_blocks: int
    trace: Optional[TraceSlice] = None

    def in_window(self, records) -> List:
        """Records (with ``t1``) that ended inside the window."""
        return [r for r in records if self.w0 <= r.t1 < self.w1]

    def share_in_window(self, record) -> float:
        """The share of a record's [t0, t1] that lies inside the window."""
        inside = min(record.t1, self.w1) - max(record.t0, self.w0)
        return max(0.0, inside) / max(record.t1 - record.t0, 1e-12)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def cell_of(bench: Dict, workload: str) -> Dict:
    cells = [w for w in bench["workloads"] if w["name"] == workload]
    if len(cells) != 1:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    return cells[0]


def metrics_of(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports: ``per_layer`` in a traced run,
    ``end_to_end`` otherwise, each unless its ``workloads`` leave it out."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_module(directory: Path, name: str):
    """``<directory>/<name>.py`` as a module (a name may hold '.' or '-')."""
    path = directory / f"{name}.py"
    key = "perfbench._found." + directory.name + "." + name.replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def program_config(conf: Dict):
    """The program's ``ModelConfig`` holding the sizes the file states."""
    from repro_torch.models.common import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in conf["model"].items() if k in fields}
    kw["dtype"] = getattr(torch, conf["model"]["dtype"])
    kw["param_dtype"] = kw["dtype"]
    return ModelConfig(name=conf["name"], **kw)


def read_metrics(specs: List[Dict], run: Run, directory: Path = HERE / "metrics"
                 ) -> Dict[str, Dict]:
    out = {}
    for m in specs:
        value = load_module(directory, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def compare(conf: Dict, weights: Dict, run: Run, seed: int,
            control: bool = False) -> Dict:
    """``logit_gap`` of a sample of the served requests against the
    reference, and the number of tokens compared; with ``control`` also the
    control's gap on the same prompts and tokens (the reference in fp8)."""
    ref = load_module(HERE / "reference", conf["reference"])
    served = [r for r in run.requests if r.tokens]
    picked = check.sample(served, run.mix["check_requests"], seed,
                          run.mix["batch"])
    device = weights["embedding"].device
    seqs, pos = check.served_sequences(picked, device)
    exact = ref.logits(conf["model"], weights, seqs, pos)
    gaps = check.served_gaps(exact, picked)
    out = {"logit_gap": float(gaps.max()) if gaps.size else None,
           "compared_tokens": int(gaps.size)}
    if control:
        low = check.control_gaps(
            exact, ref.logits(conf["model"], weights, seqs, pos, fp8=True))
        out["control_gap"] = float(low.max())
        out["readings"] = {name: {"max": float(g.max()),
                                  "p99": float(np.quantile(g, 0.99)),
                                  "flips": int((g > 0).sum())}
                           for name, g in (("program", gaps), ("control", low))}
    return out


def log(**fields) -> None:
    """One line of the run's own readings on standard error."""
    print("perfbench " + json.dumps(fields), file=sys.stderr, flush=True)


def run_cell(bench: Dict, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_process: float,
             data: Path = HERE, control: bool = False) -> Dict:
    """One run; returns the result's fields (the caller prints them).
    ``data`` holds the ``configs`` and ``traffic`` directories.  With
    ``control`` (``control.py``; never in the benchmark's own runs) the
    result also holds the control's reading, ``control_gap``."""
    from repro_torch.kernels import _build
    from .driver import Driver

    cell = cell_of(bench, workload)
    conf = load_json(data / "configs" / f"{cell['config']}.json")
    mix = traffic.load(cell["traffic"], data / "traffic")
    model = conf["model"]
    cfg = program_config(conf)
    marks = [("start", time.perf_counter())]
    if device.type == "cuda":
        _build.build_all(KERNELS)
    marks.append(("build", time.perf_counter()))
    ref = load_module(HERE / "reference", conf["reference"])
    weights = ref.make_weights(model, seed, device)
    params = ref.port_params(model, weights)
    _sync(device)
    marks.append(("weights", time.perf_counter()))
    spans = Spans()
    drv = Driver(cfg, params, mix, conf["deployment"], device, spans)
    _sync(device)
    marks.append(("state", time.perf_counter()))
    drv.warm_up()
    if trace:                   # the profiler's own first start, out of the window
        Profiler(Spans()).start_stop()
    marks.append(("warm_up", time.perf_counter()))
    log(setup={b[0]: round(b[1] - a[1], 4) for a, b in zip(marks, marks[1:])},
        imports=round(marks[0][1] - t_process, 4))
    backlog = mix["arrivals"] == "backlog"
    out = drv.serve(traffic.requests(mix, model["vocab_size"], seed, seconds),
                    lead_in=traffic.lead_in(mix), seconds=seconds,
                    backlog=backlog, trace=trace)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    run = Run(model, mix, seconds, out["origin"], out["w0"], out["w1"],
              out["w0"] - t_process, out["requests"], drv.steps, drv.prefills,
              spans, drv.max_blocks, out["trace"])
    metrics = read_metrics(metrics_of(bench, workload, trace), run)
    table = dict(drv.checks)
    k3 = drv.k3_prologue
    # a backlog's requests are those admitted before the close; an open
    # loop's those due inside the window, each of which must get a token
    attempted = ([r for r in run.requests if r.admitted is not None
                  and r.admitted < run.w1] if backlog else
                 [r for r in run.requests
                  if run.w0 <= run.origin + r.due < run.w1])
    failed = [r for r in attempted if not r.tokens]
    # the program's state goes before the reference runs: the weights stay
    del drv, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    compared = compare(conf, weights, run, seed, control)
    step_ms = [1e3 * (s.t1 - s.t0) for s in run.in_window(run.steps)] or [0.0]
    log(reference_s=round(time.perf_counter() - t_ref, 3),
        steps=len(run.steps), waves=len(run.prefills),
        window_steps=len(step_ms),
        step_ms_p50_p95=[round(float(np.percentile(step_ms, q)), 3)
                         for q in (50, 95)],
        prefill_ms=[round(1e3 * (p.t1 - p.t0), 1) for p in run.prefills],
        k3_prologue_launches=k3, memory_peak_bytes=int(peak))
    limits = conf["limits"]
    checks = {"logit_gap": {"value": compared["logit_gap"],
                            "limit": limits["logit_gap"]}}
    for name in ("replica_stale", "frame_conflicts", "replica_mismatch"):
        checks[name] = {"value": table.get(name), "limit": limits[name]}
    correct = (not failed and compared["compared_tokens"] > 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(attempted),
              "failed": len(failed), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_by_host()}
    result["card"] = roofline.power_limit() if device.type == "cuda" else None
    result["compared_tokens"] = compared["compared_tokens"]
    if control:
        result["control_gap"] = compared["control_gap"]
        result["readings"] = compared["readings"]
    result["checks"] = checks
    return result
