"""moe_prefill_ms (experts): device milliseconds of a prefill's MoE layer,
the mean over the profiled slice's prefill ``moe`` spans (one a MoE layer):
the device's busy time inside each span's window, on the slice's clock: the
routing, the experts over their expert-sorted segments and the shared
experts.  The program drains the stream before such a span opens and
before it closes while it records, so what runs inside the window is what
the span launched.  None where the program records no ``moe`` span under
a prefill, or the slice holds no device operation."""
import bisect

import numpy as np

from perfbench import portspans


def busy_ns(busy, start: int, end: int) -> int:
    """Nanoseconds of ``busy`` (sorted disjoint intervals) inside
    [start, end)."""
    i = max(0, bisect.bisect_right(busy, (start,)) - 1)
    total = 0
    while i < len(busy) and busy[i][0] < end:
        total += max(0, min(busy[i][1], end) - max(busy[i][0], start))
        i += 1
    return total


def read(run):
    s = portspans.read(run)
    if s is None:
        return None
    busy = run.trace.busy_intervals()
    if not busy:
        return None
    ms = [1e-6 * busy_ns(busy, s.starts[i], s.ends[i]) for i in s.where("moe")
          if s.names[s.root(i)] == "prefill"]
    return float(np.mean(ms)) if ms else None
