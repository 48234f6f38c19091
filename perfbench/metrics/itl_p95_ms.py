"""itl_p95_ms: the 95th percentile of the gaps between consecutive
delivered tokens of each request, over every gap that ends inside the
window."""
from perfbench.window import percentile, token_gaps


def read(run):
    gaps = token_gaps(run.requests, run.w0, run.w1)
    return 1e3 * percentile(gaps, 95) if gaps else None
