"""Block-table coherence traffic per serving mode, on the port's serving path.

The twin of the JAX package's ``benchmarks/serving_coherence.py``: the same
request churn driven through ``repro_torch.launch.serve`` under LOCAL / EAGER
(Mitosis) / NUMAPTE block-table coherence, reporting exact invalidation
messages, filtered fraction, fetch/prefetch counts and host coherence bytes,
then the per-step collective bytes each mode adds to a serve step (the
``pagedpt.blocktable`` budget model).  Runs on the GPU unless
``device="cpu"`` is given; ``full_width`` serves the published config,
``n_layers`` cuts its depth (the counters depend on neither).

    PYTHONPATH=src python -m repro_torch.benchmarks.serving_coherence --quick
    PYTHONPATH=src python -m repro_torch.benchmarks.serving_coherence \\
        --full-width --layers 4
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from .._device import DeviceLike
from ..launch.serve import serve
from ..pagedpt.blocktable import (BlockTableSpec, eager_sync_bytes,
                                  numapte_fetch_bytes)

N_PODS = 4


def main(quick: bool = False, *, device: DeviceLike = None,
         full_width: bool = False, n_layers: Optional[int] = None
         ) -> List[dict]:
    rows = []
    for mode in ("local", "eager", "numapte"):
        r = serve("qwen3_14b", n_requests=8 if quick else 24,
                  prompt_len=32, gen_len=8 if quick else 16, batch=4,
                  n_pods=N_PODS, mode=mode, verbose=False, device=device,
                  full_width=full_width, n_layers=n_layers)
        r.pop("token_ids")
        rows.append({k: (round(v, 1) if isinstance(v, float) else v)
                     for k, v in r.items()})
    # the budget-model row runs the same pod count as the serve rows above
    # (and carries it), so the eager/numapte ratio is comparable to them
    spec = BlockTableSpec(n_pods=N_PODS, n_tables=512)
    rows.append({"mode": "per-step-collective-bytes", "n_pods": N_PODS,
                 "eager": eager_sync_bytes(spec),
                 "numapte": numapte_fetch_bytes(spec),
                 "ratio": round(eager_sync_bytes(spec)
                                / numapte_fetch_bytes(spec), 1)})
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    ap.add_argument("--full-width", action="store_true",
                    help="the published config instead of the smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (widths stay as published)")
    args = ap.parse_args()
    for row in main(args.quick, device=args.device,
                    full_width=args.full_width, n_layers=args.layers):
        print(",".join(["serving_coherence"]
                       + [f"{k}={v}" for k, v in row.items()]))
