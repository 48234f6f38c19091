"""prefill_ms (prefill): host-clock milliseconds of a wave's page walk and
prefill, synchronised, the mean over the prefills that ended inside the
window."""
import numpy as np


def read(run):
    p = run.in_window(run.prefills)
    return 1e3 * float(np.mean([x.t1 - x.t0 for x in p])) if p else None
