"""prefill_mfu (prefill): model FLOPs of the window's prefills (live rows)
over their synchronised time at the published bf16 peak, in %."""
from perfbench import roofline


def read(run):
    p = run.in_window(run.prefills)
    secs = sum(x.t1 - x.t0 for x in p)
    if not p or secs <= 0:
        return None
    flops = sum(roofline.prefill_flops(run.model, x.prompt_len, x.live) for x in p)
    return 100.0 * flops / (secs * roofline.PEAK_FLOPS[run.model["dtype"]])
