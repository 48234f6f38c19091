"""The H100 dry run: every (arch x shape) cell on the production grid, built
on the ``meta`` device and accounted analytically (``launch/analysis.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 33 single-pod cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --seq-parallel
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table [--shape train_4k]

The grid is ``make_debug_mesh(pods, data=16, model=16, device="meta")``: one
pod of 256 GPUs, or two.  Each cell prints the reference's one-line
summary and writes ``experiments/dryrun_h100/<arch>__<shape>__<mesh>.json``
(the cell's roofline terms, its per-device bytes, what each axis moves).  A
cell whose arguments exceed a device's 80 GB is reported as not fitting;
that is a result, not a failure.  Nothing is allocated, nothing runs on a
device, and nothing is written over the JAX package's ``BENCH_roofline.json``.

``--table`` reads every cell file of the directory and prints the
reference's roofline table (``benchmarks/roofline.py``'s columns: arch,
shape, mesh with its option tag, compute / memory / collective ms, the
dominant term, the roofline fraction, the useful-FLOP ratio, argument GB a
device), one row a cell, and writes it beside them as ``roofline.csv``;
with ``--all`` or ``--arch`` the cells are built first.  Nothing is written
under ``benchmarks/``.
"""
from __future__ import annotations

import argparse
import csv
import json
import pathlib
import time
import traceback
from typing import List, Optional

from ..configs import ARCH_IDS, SHAPES, shape_cells
from . import analysis
from .mesh import make_debug_mesh
from .specs import PerfOptions, build_cell, require_options

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_h100")


def production_grid(multi_pod: bool = False):
    """(pod=2,) data=16 x model=16 on the meta device."""
    return make_debug_mesh(2 if multi_pod else 1, data=16, model=16,
                           device="meta")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, save: bool = True,
             opts: Optional[PerfOptions] = None,
             out_dir: Optional[pathlib.Path] = None) -> dict:
    """Build one cell on the meta device, count it, print and save its
    roofline; returns what is saved."""
    opts = opts or PerfOptions()
    t0 = time.perf_counter()
    cell = build_cell(arch, SHAPES[shape_name], production_grid(multi_pod),
                      opts=opts)
    t_build = time.perf_counter() - t0
    roof = analysis.roofline(cell)
    out = {"arch": arch, "shape": shape_name, "mesh": roof.mesh,
           "chips": roof.chips, "build_s": t_build,
           "device_bytes": analysis.device_bytes(cell),
           "step_flops_per_device": analysis.step_flops(cell),
           "roofline": roof.to_dict()}
    if verbose:
        print(analysis.summary(roof))
        print(f"    collectives: { {k: f'{v:.3e}' for k, v in roof.collectives.items()} }")
    if save:
        directory = out_dir or ART_DIR
        directory.mkdir(parents=True, exist_ok=True)
        path = directory / f"{arch}__{shape_name}__{roof.mesh}.json"
        path.write_text(json.dumps(out, indent=1))
    return out


TABLE_COLUMNS = ("arch", "shape", "mesh", "compute_ms", "memory_ms",
                 "collective_ms", "dominant", "roofline_frac", "useful_flops",
                 "arg_gb_per_dev")


def table(directory: Optional[pathlib.Path] = None,
          shapes: Optional[List[str]] = None) -> List[dict]:
    """The roofline table of the cell files in ``directory`` (default
    ``ART_DIR``; only ``shapes`` when given), in file-name order; writes
    ``roofline.csv`` there."""
    directory = directory or ART_DIR
    rows = []
    for path in sorted(directory.glob("*.json")):
        d = json.loads(path.read_text())
        if shapes and d["shape"] not in shapes:
            continue
        r = d["roofline"]
        rows.append({"arch": d["arch"], "shape": d["shape"], "mesh": d["mesh"],
                     "compute_ms": round(r["compute_s"] * 1e3, 2),
                     "memory_ms": round(r["memory_s"] * 1e3, 2),
                     "collective_ms": round(r["collective_s"] * 1e3, 2),
                     "dominant": r["dominant"],
                     "roofline_frac": round(r["roofline_fraction"], 4),
                     "useful_flops": round(r["useful_flops_ratio"], 3),
                     "arg_gb_per_dev": round(r["per_device_bytes"] / 1e9, 3)})
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "roofline.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=TABLE_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    return rows


def print_table(rows: List[dict]) -> None:
    widths = {c: max([len(c)] + [len(str(r[c])) for r in rows])
              for c in TABLE_COLUMNS}
    print("  ".join(c.ljust(widths[c]) for c in TABLE_COLUMNS))
    for r in rows:
        print("  ".join(str(r[c]).ljust(widths[c]) for c in TABLE_COLUMNS))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--decode-kernel", default="ref",
                    choices=["ref", "fused_ref"])
    ap.add_argument("--bf16-grads", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--coherence", default="none",
                    choices=["none", "eager", "numapte"])
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help=f"directory of the cells' files (default {ART_DIR})")
    ap.add_argument("--table", action="store_true",
                    help="print the roofline table of the directory's cells "
                         "(after building any asked for) and write roofline.csv")
    args = ap.parse_args(argv)
    opts = PerfOptions(decode_kernel=args.decode_kernel,
                       bf16_grads=args.bf16_grads,
                       seq_parallel=args.seq_parallel,
                       coherence=args.coherence, remat=args.remat,
                       compress_pod_grads=args.compress_pod_grads)
    require_options(opts)

    if args.table and not (args.all or args.arch):
        print_table(table(args.out, [args.shape] if args.shape else None))
        return
    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS for shape in shape_cells(arch)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures, too_big = [], []
    for arch, shape in cells:
        try:
            out = run_cell(arch, shape, multi_pod=args.multi_pod, opts=opts,
                           out_dir=args.out)
        except Exception as e:  # noqa: BLE001 — report and continue
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
            continue
        if not out["roofline"]["fits"]:
            too_big.append((arch, shape, out["roofline"]["per_device_bytes"]))
    for arch, shape, b in too_big:
        print(f"  does not fit one 80 GB device: {arch} x {shape} "
              f"({b / 1e9:.2f} GB of arguments a device)")
    if failures:
        print(f"\nFAILED {len(failures)}/{len(cells)} cells:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells)} cells built and counted "
          f"({len(too_big)} do not fit one device)")
    if args.table:
        print_table(table(args.out))


if __name__ == "__main__":
    main()
