"""k1_roofline (kernels: paged attention): the sum of each K1 launch's
least time (``roofline.paged_bound``: q, the live slots' K and V, the
output, tables and lengths, each once, at 3.35 TB/s) over K1's device time
in the profiled slice, in %.  The slice's decode steps launch K1 once a
layer; a count that differs reads nothing."""
from perfbench import roofline

KERNEL = "paged_attention_kernel"


def read(run):
    t = run.trace
    if t is None or not t.step_lens:
        return None
    m = run.model
    n, secs = t.kernel_seconds(KERNEL)
    if n != len(t.step_lens) * m["n_layers"] or secs <= 0:
        return None
    B = run.mix["batch"]
    bound = sum(m["n_layers"] * roofline.paged_bound(
        B, m["n_heads"], m["n_kv_heads"], m["head_dim"], run.max_blocks,
        sum(lens), m["dtype"]) for lens in t.step_lens)
    return 100.0 * bound / secs
