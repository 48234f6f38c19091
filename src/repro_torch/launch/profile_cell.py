"""One device's share of a dry-run cell, run on the card and read under
``torch.profiler``, beside the analytic bound of the same work.

    PYTHONPATH=src python -m repro_torch.launch.profile_cell --arch yi_6b \\
        --shape decode_32k [--rows 8] [--layers 32] [--remat full] [--steps 3]

The reference's profiler reads the compiled HLO of a cell; the port runs
the cell instead.  On the production grid (data = 16, model = 16) a device
serves one data shard's rows; one card holds the whole model (its model
axis is 1), so the cell keeps those rows and cuts only what the card's
80 GB force, each cut named: a train step's depth (the most layers whose
analytic peak, ``analysis.peak_bytes``, fits ``budget`` of the card) and,
when asked, fewer rows.  It reports the step's median ms (CUDA events),
the peak of allocated memory beside the analytic peak, the device's busy
ms and idle share in one profiled step, its largest kernels, and the
roofline of the cut work on one card (``analysis.roofline``).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Tuple

import torch

from .. import tracing
from .._device import DeviceLike, resolve_device
from ..configs import ARCH_IDS, SHAPES, get_config
from . import analysis
from .mesh import make_debug_mesh
from .specs import CellSpec, PerfOptions, build_cell

#: the production grid's data axis: a device serves 1/16 of a cell's rows
DATA = 16
#: the share of the card's memory a cut must fit by its analytic peak (room
#: for the analytic peak's error, so that the cut never runs out of memory)
BUDGET = 0.8
#: the span around the profiled step, its window on the profiler's clock
STEP = "cell.step"


def _cell(arch: str, shape, rows: int, n_layers: Optional[int],
          opts: PerfOptions, device) -> CellSpec:
    """The cell of one card (a grid of one device); ``shape``: a name of
    ``SHAPES`` or a ``ShapeSpec``."""
    grid = make_debug_mesh(1, device=device)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    return build_cell(arch, shape, grid, opts=opts, device=device, rows=rows,
                      n_layers=n_layers)


def fit_layers(arch: str, shape, rows: int, opts: PerfOptions,
               budget: float = BUDGET * analysis.HBM_BYTES) -> int:
    """The most layers (at most the config's) whose one-card cell has an
    analytic peak within ``budget`` bytes, by bisection over meta cells;
    0 when not even one layer fits."""
    lo, hi = 0, get_config(arch).n_layers
    while lo < hi:
        mid = (lo + hi + 1) // 2
        cell = _cell(arch, shape, rows, mid, opts, "meta")
        if analysis.peak_bytes(cell) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def card_cell(arch: str, shape_name: str, *, rows: Optional[int] = None,
              n_layers: Optional[int] = None,
              opts: Optional[PerfOptions] = None,
              device: DeviceLike = None) -> CellSpec:
    """The cell of one device on the card (module doc), its cuts named in
    ``cuts``."""
    opts = opts or PerfOptions()
    shape = SHAPES[shape_name]
    device = resolve_device(device)
    share = max(1, shape.global_batch // DATA)
    rows = rows or share
    why = {"model": "model axis 1 where the grid has 16: one card holds the "
                    "whole model"}
    why["rows"] = (f"{rows} of {shape.global_batch}: one data shard's rows"
                   f" (data = {DATA})" if rows == share else
                   f"{rows} of {shape.global_batch}: {rows} of one data "
                   f"shard's {share} rows")
    full = get_config(arch).n_layers
    if n_layers is None and shape.step == "train":
        n_layers = fit_layers(arch, shape_name, rows, opts)
        if n_layers < full:
            why["n_layers"] = (f"{n_layers} of {full}: the most whose analytic "
                               f"peak fits {BUDGET:.0%} of the card")
    elif n_layers is not None and n_layers < full:
        why["n_layers"] = f"{n_layers} of {full}: asked for"
    cell = _cell(arch, shape_name, rows, n_layers, opts, device)
    cell.cuts = dict(why)
    return cell


def profile(cell: CellSpec, *, steps: int = 3, top: int = 8) -> Dict:
    """Run ``cell`` on its card: one warm-up step, ``steps`` timed steps
    (CUDA events; the peak of allocated memory over them), one step under
    the profiler (``device_busy``: the device's busy ms and idle share over
    that step's own window; kernel launches, the largest kernels); with the
    cut work's analytic bound and peak."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def step():
        return cell.step_fn(*cell.args)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with tracing.span(STEP):
            step()
            torch.cuda.synchronize()
    ops, ranges = tracing.profiled(prof)
    (window,) = [(s, e) for n, s, e in ranges if n == tracing.PREFIX + STEP]
    busy, idle = device_busy(ops, window)
    kernels = {e.key: (e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0}
    step_ms = sorted(times)[len(times) // 2]
    roof = analysis.roofline(cell)
    return {"arch": cell.arch, "shape": cell.shape.name, "rows": cell.rows,
            "layers": cell.cfg.n_layers, "remat": cell.opts.remat
            if cell.shape.step == "train" else None, "cuts": cell.cuts,
            "step_ms": step_ms, "step_ms_all": times,
            "peak_gb": peak / 1e9,
            "analytic_peak_gb": analysis.peak_bytes(cell) / 1e9,
            "arguments_gb": analysis.device_bytes(cell) / 1e9,
            "device_busy_ms": busy, "device_idle_share": idle,
            "launches": sum(n for _, n in kernels.values()),
            "top_kernels": [{"kernel": k[:80], "ms": ms, "launches": n}
                            for k, (ms, n) in sorted(
                                kernels.items(), key=lambda kv: -kv[1][0])[:top]],
            "bound_ms": roof.bound_s * 1e3, "bound_by": roof.dominant,
            "compute_ms": roof.compute_s * 1e3,
            "memory_ms": roof.memory_s * 1e3,
            "flops": roof.flops, "bytes": roof.bytes,
            "share_of_bound": roof.bound_s * 1e3 / step_ms}


def device_busy(ops, window) -> Tuple[float, float]:
    """(busy ms, idle share) of the device over ``window`` (start, end ns):
    the union of the operations' (start, end) intervals clipped to it, so
    that operations overlapping on different streams count once."""
    start, end = window
    busy = sum(e - s for s, e in tracing.union(ops, start, end))
    return busy * 1e-6, 1.0 - busy / (end - start)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--bf16-grads", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    opts = PerfOptions(remat=args.remat, bf16_grads=args.bf16_grads)
    cell = card_cell(args.arch, args.shape, rows=args.rows,
                     n_layers=args.layers, opts=opts)
    print(json.dumps(profile(cell, steps=args.steps, top=args.top)))


if __name__ == "__main__":
    main()
