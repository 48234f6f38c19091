"""k2_roofline (kernels: flash attention): the sum of each K2 launch's least
time (``roofline.flash_bound``: the causal visible pairs' FLOPs at 989
TFLOP/s, or q, k, v and the output once at 3.35 TB/s) over K2's device
time in the profiled slice, in %.  The slice's one prefill launches K2
once a layer over every row of the batch; a count that differs reads
nothing."""
from perfbench import roofline

KERNEL = "flash_attention"
BACKWARD = "bwd"


def read(run):
    t = run.trace
    if t is None or t.prefill is None:
        return None
    m = run.model
    n, secs = t.kernel_seconds(KERNEL, exclude=BACKWARD)
    if n != m["n_layers"] or secs <= 0:
        return None
    rows, S = t.prefill
    bound = m["n_layers"] * roofline.flash_bound(
        rows, m["n_heads"], m["n_kv_heads"], S, m["head_dim"], m["dtype"])
    return 100.0 * bound / secs
