"""Phase ``cells``: the dry run (``repro_torch.launch.dryrun``): all 33
cells on one pod of 16 x 16 and on two, built on the meta device, each
cell's per-device bytes equal to the count from the config's widths, its
roofline line printed; then Yi-6B's decode_32k (8 rows at 32 768 tokens,
all 32 layers), prefill_32k (2 rows) and train_4k (2 rows, remat "full",
depth cut to fit) as one device runs them (``launch/profile_cell.py``):
step ms, peak GB within 15 % of the analytic peak, busy ms and idle share,
the largest kernels, beside the analytic bound; and the 66 cells again with
Megatron sequence parallelism (``seq_parallel``), then the roofline table
(``dryrun --table``) of train_4k and prefill_32k with it off and on.
"""
import pathlib
import tempfile
import time

from repro_torch import configs as tconfigs
from repro_torch.launch import analysis, dryrun, profile_cell, specs
from .common import check, COUNTED, counts_now, DEV, emit, release, reset_counters


# (b): Yi-6B's cells as one device of the 16 x 16 grid runs them (one data
# shard's rows, the whole model on one card), each with its timed steps
CELL_RUNS = (("decode_32k", dict(), 3), ("prefill_32k", dict(), 2),
             ("train_4k", dict(rows=2), 2))
#: a run's peak of allocated memory against ``analysis.peak_bytes``
PEAK_MARGIN = 0.15


def cell_launches(cell, runs: int) -> dict:
    """What ``runs`` steps of a Yi-6B cell launch: K1 once a layer a decode
    step, K2 once a layer a prefill (no LSE), and a train step with remat
    "full" K2's forward twice a layer (the LSE each time) and its backward
    once."""
    L = cell.cfg.n_layers
    want = {name: 0 for name in COUNTED}
    step = cell.shape.step
    if step == "decode":
        want["paged_attention"] = L * runs
    elif step == "prefill":
        want["flash_attention"] = L * runs
    else:
        want["flash_attention"] = 2 * L * runs
        want["flash_attention_bwd"] = L * runs
    return want


def cells_sp() -> dict:
    """Every cell with ``seq_parallel`` on one pod and on two, on the meta
    device (bytes a device equal to the count); then the roofline table of
    train_4k and prefill_32k with SP off and on (``dryrun --table``), its
    cell files in a directory of their own."""
    t0 = time.perf_counter()
    sp = specs.PerfOptions(seq_parallel=True)
    summary = {"cells": 0, "split": 0, "dominant": {}}
    for multi in (False, True):
        grid = dryrun.production_grid(multi)
        for arch, shape in tconfigs.all_cells():
            cell = specs.build_cell(arch, tconfigs.SHAPES[shape], grid, opts=sp)
            got, want = analysis.per_device_bytes(cell), analysis.device_bytes(cell)
            check(abs(got - want) <= 1e-9 * want,
                  f"{arch} x {shape} sp: {got} bytes a device, the count {want}")
            roof = analysis.roofline(cell)
            summary["cells"] += 1
            summary["split"] += any(cell.seq_split.values())
            summary["dominant"][roof.dominant] = summary["dominant"].get(
                roof.dominant, 0) + 1
    check(summary["cells"] == 66, f"{summary['cells']} sp cells, not 2 x 33")
    summary["build_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        for opts in (specs.PerfOptions(), sp):
            for arch in tconfigs.ARCH_IDS:
                for shape in ("train_4k", "prefill_32k"):
                    if shape in tconfigs.shape_cells(arch):
                        dryrun.run_cell(arch, shape, opts=opts, out_dir=out,
                                        verbose=False)
        rows = dryrun.table(out)
        dryrun.print_table(rows)
    summary["table_rows"] = len(rows)
    return summary


def phase_cells() -> dict:
    """(a) the 66 meta cells, (b) Yi-6B's three cells on the card (the
    module's docstring); the kernels' launches follow the path."""
    t0 = time.perf_counter()
    summary = {"cells": 0, "fit": 0, "dominant": {}}
    for multi in (False, True):
        grid = dryrun.production_grid(multi)
        for arch, shape in tconfigs.all_cells():
            cell = specs.build_cell(arch, tconfigs.SHAPES[shape], grid)
            got, want = analysis.per_device_bytes(cell), analysis.device_bytes(cell)
            check(abs(got - want) <= 1e-9 * want,
                  f"{arch} x {shape}: {got} bytes a device, the count {want}")
            roof = analysis.roofline(cell)
            print(analysis.summary(roof), flush=True)
            summary["cells"] += 1
            summary["fit"] += roof.fits
            summary["dominant"][roof.dominant] = summary["dominant"].get(
                roof.dominant, 0) + 1
    check(summary["cells"] == 66, f"{summary['cells']} cells, not 2 x 33")
    summary["build_s"] = time.perf_counter() - t0
    emit({"phase": "cells_meta", **summary})
    emit({"phase": "cells_meta_sp", **cells_sp()})
    counts = {name: 0 for name in COUNTED}
    wants = dict(counts)
    for shape, kw, steps in CELL_RUNS:
        release()
        cell = profile_cell.card_cell("yi_6b", shape, device=DEV, **kw)
        reset_counters()
        out = profile_cell.profile(cell, steps=steps)
        runs = steps + 2                     # a warm-up and a profiled step
        got, want = counts_now(), cell_launches(cell, runs)
        check(got == want, f"{shape}: launches {got}, the path implies {want}")
        for name in COUNTED:
            counts[name] += got[name]
            wants[name] += want[name]
        off = abs(out["peak_gb"] - out["analytic_peak_gb"]) / out["analytic_peak_gb"]
        check(off <= PEAK_MARGIN,
              f"{shape}: peak {out['peak_gb']:.2f} GB, the analytic peak "
              f"{out['analytic_peak_gb']:.2f} GB (margin {PEAK_MARGIN})")
        emit({"phase": "cells_card", **out, "launches": got,
              "peak_off": off, "peak_margin": PEAK_MARGIN})
        del cell
    release()
    return {"cells_yi_6b": (counts, wants)}
