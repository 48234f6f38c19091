"""decode_step_ms (decode step): host-clock milliseconds from a step's walk
to its tokens on the host, the mean over the window's steps."""
import numpy as np


def read(run):
    steps = run.in_window(run.steps)
    return 1e3 * float(np.mean([s.t1 - s.t0 for s in steps])) if steps else None
