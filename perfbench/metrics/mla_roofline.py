"""mla_roofline (kernels: paged latent attention): the sum of each K4 launch's
least time (``mla_bound``: each live slot's 576-wide latent once, q, the
float32 output, tables and lengths at 3.35 TB/s, against 2 x 16 x 1 088
operations a live slot) over K4's device time in the profiled slice, in %.
The slice's decode steps launch K4 once a layer; a count that differs
reads nothing (a program without K4 launches none)."""
from perfbench.mla_bound import mla_bound

KERNEL = "mla_decode_kernel"


def read(run):
    t = run.trace
    m = run.model
    if t is None or not t.step_lens or not m.get("kv_lora_rank"):
        return None
    n, secs = t.kernel_seconds(KERNEL)
    if n != len(t.step_lens) * m["n_layers"] or secs <= 0:
        return None
    bound = sum(m["n_layers"] * mla_bound(
        run.mix["batch"], m["n_heads"], m["kv_lora_rank"],
        m["qk_rope_head_dim"], run.max_blocks, sum(lens), m["dtype"])
        for lens in t.step_lens)
    return 100.0 * bound / secs
