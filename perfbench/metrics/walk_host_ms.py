"""walk_host_ms (host protocol + page walk): host milliseconds a decode step
spends in ``maybe_extend`` and ``physical_tables`` (the driver's "walk"
span), the mean over the window's steps."""
import numpy as np


def read(run):
    spans = run.spans.of("walk", run.w0, run.w1)
    return 1e3 * float(np.mean(spans)) if spans else None
