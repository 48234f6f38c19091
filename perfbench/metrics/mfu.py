"""mfu (the whole serving step): model FLOPs of the window's prefills and
decode steps (live rows only; one that straddles an edge of the window
counted by its share inside), from the configuration's widths, over the
window's seconds at the published bf16 peak, in %."""
from perfbench import roofline


def read(run):
    m = run.model
    flops = sum(run.share_in_window(p) * roofline.prefill_flops(m, p.prompt_len, p.live)
                for p in run.prefills)
    flops += sum(run.share_in_window(s) * roofline.decode_flops(m, s.lens)
                 for s in run.steps)
    if flops == 0:
        return None
    return 100.0 * flops / (run.seconds * roofline.PEAK_FLOPS[m["dtype"]])
